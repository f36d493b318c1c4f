// Row-wise linear quantize and dequantize for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels repro/kernels/quantize.py:_rowwise_quant_kernel
// and _rowwise_dequant_kernel (Pallas, reached through rowwise_quantize /
// rowwise_dequantize and ops.quantize_rowwise / ops.dequantize_rowwise):
//
//   quantize:   per row of x [rows, cols] fp32
//                 lo    = min(row), scale = (max(row) - lo) * fl32(1 / nlevels)
//                 scale = 1 where scale <= 0
//                 q     = rint((x - lo) / scale)       -> codes u8
//                 deq   = fma(q, scale, lo)
//   dequantize: out = fma(codes, scale, lo)
//
// The arithmetic is the reference's as XLA compiles it (the division by the
// constant level count becomes a multiply by its fp32 reciprocal, and
// lo + q * scale one fused multiply-add), spelled with __fmul_rn, __fsub_rn,
// __fdiv_rn (true IEEE division: no --use_fast_math), rintf (round half to
// even) and __fmaf_rn, so the kernels are bitwise equal to the plain PyTorch
// versions in kernels/quantize.py and to the reference.
//
// What bounds them on this card: bytes. quantize reads x once for min / max
// and once to encode, and writes deq (fp32) and codes (u8): 13 bytes per
// entry at the bound (each input read once), 3.35 TB/s. dequantize reads a
// u8 code and writes an fp32 value: 5 bytes per entry.
//
// Design: the compressed sync quantizes rows of two very different shapes:
// tens of thousands of rows of 192 to 1536 entries (row-wise), and one row
// per worker of up to 28,311,552 entries (global). One block per row would
// leave a global row on one SM, so every row is cut into chunks of kChunk
// entries and the grid runs over (row, chunk) tiles: pass 1 takes each
// tile's min and max, pass 2 (one warp per row) combines a row's tiles and
// forms lo and scale, pass 3 encodes each tile. Min and max are exact and
// order-free, so any split gives the same bits. Loads are coalesced fp32
// (thread t reads entries t, t + 256, ...); vector loads are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 4096;  // entries per (row, chunk) tile; kernels/quantize.py: CHUNK
constexpr int kWarps = kThreads / 32;

// NaN-propagating min / max, as jnp.min / jnp.max and torch.amin / amax
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = min_nan(lo, __shfl_down_sync(0xffffffffu, lo, off));
    hi = max_nan(hi, __shfl_down_sync(0xffffffffu, hi, off));
  }
}

// pass 1: min and max of each (row, chunk) tile
__global__ void tile_minmax_kernel(const float* __restrict__ x, float* __restrict__ tile_lo,
                                   float* __restrict__ tile_hi, long long cols,
                                   long long chunks) {
  const long long tile = blockIdx.x;
  const long long row = tile / chunks;
  const long long begin = (tile % chunks) * kChunk;
  const long long end = begin + kChunk < cols ? begin + kChunk : cols;
  const float* p = x + row * cols;
  float lo = __int_as_float(0x7f800000), hi = -lo;  // +inf, -inf
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    const float v = p[i];
    lo = min_nan(lo, v);
    hi = max_nan(hi, v);
  }
  warp_minmax(lo, hi);
  __shared__ float s_lo[kWarps], s_hi[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kWarps ? s_lo[lane] : s_lo[0];
    hi = lane < kWarps ? s_hi[lane] : s_hi[0];
    warp_minmax(lo, hi);
    if (lane == 0) {
      tile_lo[tile] = lo;
      tile_hi[tile] = hi;
    }
  }
}

// pass 2: one warp per row combines its tiles into lo and scale
__global__ void row_stats_kernel(const float* __restrict__ tile_lo,
                                 const float* __restrict__ tile_hi, float* __restrict__ lo_out,
                                 float* __restrict__ scale_out, long long rows, long long chunks,
                                 float inv_levels) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (long long c = lane; c < chunks; c += 32) {
    lo = min_nan(lo, tile_lo[row * chunks + c]);
    hi = max_nan(hi, tile_hi[row * chunks + c]);
  }
  warp_minmax(lo, hi);
  if (lane == 0) {
    float scale = __fmul_rn(__fsub_rn(hi, lo), inv_levels);
    if (scale <= 0.0f) scale = 1.0f;
    lo_out[row] = lo;
    scale_out[row] = scale;
  }
}

// pass 3: codes and dequantized values of each tile
__global__ void encode_kernel(const float* __restrict__ x, const float* __restrict__ lo_in,
                              const float* __restrict__ scale_in, float* __restrict__ deq,
                              uint8_t* __restrict__ codes, long long cols, long long chunks) {
  const long long tile = blockIdx.x;
  const long long row = tile / chunks;
  const long long begin = (tile % chunks) * kChunk;
  const long long end = begin + kChunk < cols ? begin + kChunk : cols;
  const float lo = lo_in[row], scale = scale_in[row];
  const long long base = row * cols;
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    const float q = rintf(__fdiv_rn(__fsub_rn(x[base + i], lo), scale));
    codes[base + i] = (uint8_t)(unsigned int)q;
    deq[base + i] = __fmaf_rn(q, scale, lo);
  }
}

__global__ void decode_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ lo_in,
                              const float* __restrict__ scale_in, float* __restrict__ out,
                              long long cols, long long chunks) {
  const long long tile = blockIdx.x;
  const long long row = tile / chunks;
  const long long begin = (tile % chunks) * kChunk;
  const long long end = begin + kChunk < cols ? begin + kChunk : cols;
  const float lo = lo_in[row], scale = scale_in[row];
  const long long base = row * cols;
  for (long long i = begin + threadIdx.x; i < end; i += kThreads)
    out[base + i] = __fmaf_rn((float)codes[base + i], scale, lo);
}

bool tiles_of(long long rows, long long cols, long long* chunks, long long* tiles) {
  if (rows <= 0 || cols <= 0) return false;
  *chunks = (cols + kChunk - 1) / kChunk;
  *tiles = rows * *chunks;
  return *tiles <= 0x7fffffffLL;
}

}  // namespace

// x [rows, cols] fp32 -> deq [rows, cols] fp32, codes [rows, cols] u8, lo and
// scale [rows] fp32. partial: 2 * rows * ceil(cols / 4096) fp32 of scratch.
// nlevels = 2^bits - 1. Returns cudaGetLastError() after the launches.
extern "C" int quantize(const void* x, void* deq, void* codes, void* lo, void* scale,
                        void* partial, long long rows, long long cols, int nlevels,
                        void* stream) {
  long long chunks, tiles;
  if (nlevels < 1 || nlevels > 255 || !tiles_of(rows, cols, &chunks, &tiles))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* tile_lo = static_cast<float*>(partial);
  float* tile_hi = tile_lo + tiles;
  const float inv_levels = 1.0f / (float)nlevels;  // the fp32 reciprocal, correctly rounded
  tile_minmax_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(static_cast<const float*>(x), tile_lo,
                                                           tile_hi, cols, chunks);
  row_stats_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      tile_lo, tile_hi, static_cast<float*>(lo), static_cast<float*>(scale), rows, chunks,
      inv_levels);
  encode_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(lo),
      static_cast<const float*>(scale), static_cast<float*>(deq), static_cast<uint8_t*>(codes),
      cols, chunks);
  return (int)cudaGetLastError();
}

// codes [rows, cols] u8, lo and scale [rows] fp32 -> out [rows, cols] fp32.
extern "C" int dequantize(const void* codes, const void* lo, const void* scale, void* out,
                          long long rows, long long cols, void* stream) {
  long long chunks, tiles;
  if (!tiles_of(rows, cols, &chunks, &tiles)) return (int)cudaErrorInvalidValue;
  decode_kernel<<<(unsigned)tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(lo),
      static_cast<const float*>(scale), static_cast<float*>(out), cols, chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* quantize_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
