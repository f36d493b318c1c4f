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
//                 deq   = fma(q, scale, lo)            (unless deq is null)
//   dequantize: out = fma(codes, scale, lo)
//
// The arithmetic is the reference's as XLA compiles it (the division by the
// constant level count becomes a multiply by its fp32 reciprocal, and
// lo + q * scale one fused multiply-add), spelled with __fmul_rn, __fsub_rn,
// __fdiv_rn (true IEEE division: no --use_fast_math), rintf (round half to
// even) and __fmaf_rn, so the kernels are bitwise equal to the plain PyTorch
// versions in kernels/quantize.py and to the reference. Min and max are exact
// and do not depend on the order they are taken in, so any split of a row
// gives the same lo and scale.
//
// What bounds them on this card: bytes, at 3.35 TB/s. quantize reads x (4 B
// an entry) and writes the codes (1 B) and, where the caller asks for them,
// the dequantized values (4 B). Read once, that is 9 B an entry for the full
// function and 5 B for the codes alone (the wire path's encode, which passes
// deq = null); read twice, 13 B and 9 B. dequantize reads a u8 code and
// writes an fp32 value: 5 B an entry.
//
// Design of quantize. The compressed sync quantizes rows of two very
// different shapes: tens of thousands of rows of 192 to 1536 entries
// (row-wise), and one row per worker of up to 28,311,552 entries (global).
// The host picks the launch from (rows, cols) alone, so it reads no data,
// allocates nothing (the wrapper passes the scratch) and fixes the grid from
// the shapes: the launch can be captured in a CUDA graph.
//   * A row of up to kWarpRowMax entries is held in one warp's registers,
//     up to kBlockRowMax in one block's: it is read once (9 B or 5 B an
//     entry), its min and max taken by shuffles (and, across a block's
//     warps, shared memory), and encoded from the registers.
//   * A longer row is read twice (13 B or 9 B): the global Q1 call reads
//     226 MB, more than the card holds on chip (50 MB of L2, ~30 MB of
//     shared memory, ~33 MB of registers). Pass 1 gives each row `parts`
//     blocks, about kLongBlocks in all (a few an SM), which sweep the row
//     together from its start, stripe by stripe, each block a 16 KB step of
//     every stripe (a contiguous chunk a block read 0.315 ms against 0.266
//     for the global Q1 call on an H100 80GB HBM3 at 700 W,
//     tools/quantize_probe.py); each block writes its min and max. Pass 2 runs
//     one block a 16 KB step, the last step first, so that the first
//     blocks read what pass 1 read last, which L2 still holds (the same
//     steps in order, or one block a part in stripes, read 0.260 and 0.267
//     ms against 0.257); each block folds its row's partials itself (no
//     third launch, no atomics). Its reads are streaming loads, which do not
//     push the rest of L2 out.
// Loads are 16-byte float4, codes stored four to a 32-bit word and deq as
// float4, where cols % 4 == 0 and x, deq and codes are aligned; otherwise
// the same kernels load and store entry by entry.
//
// Build variants: the threads a block, the float4 groups a thread keeps in
// flight over a long row and the blocks pass 1 aims at are -D defines
// (QZ_THREADS, QZ_UNROLL, QZ_LONG_BLOCKS), whose defaults below are the
// design above; the autotune candidates of kernels/quantize.py are built this
// way. They move the cuts between the regimes and the split of a long row,
// never the arithmetic: min and max are exact in any order and the encode is
// elementwise, so every variant's output is bitwise the default's.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef QZ_THREADS
#define QZ_THREADS 256
#endif
#ifndef QZ_UNROLL
#define QZ_UNROLL 4
#endif
#ifndef QZ_LONG_BLOCKS
#define QZ_LONG_BLOCKS 528
#endif

namespace {

constexpr int kThreads = QZ_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 16;                             // float4 groups a thread holds
constexpr int kWarpRowMax = 32 * kMaxGroups * 4;           // 2048 entries held by a warp
constexpr int kBlockRowMax = kThreads * kMaxGroups * 4;    // 16384 entries held by a block
constexpr int kUnroll = QZ_UNROLL;                         // float4 groups in flight a thread
constexpr int kLongBlocks = QZ_LONG_BLOCKS;                // default: 4 blocks on each of 132 SMs
constexpr int kLongMinGroups = kUnroll * kThreads;         // a block's step over a long row
constexpr long long kChunk = 4096;                         // entries a dequantize tile
static_assert(kThreads % 32 == 0 && kThreads <= 1024 && kUnroll >= 1 && kLongBlocks >= 1,
              "whole warps, one block's threads, a positive unroll and split");

// NaN-propagating min / max, as jnp.min / jnp.max and torch.amin / amax
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ void fold(float& lo, float& hi, float4 v) {
  lo = min_nan(lo, min_nan(min_nan(v.x, v.y), min_nan(v.z, v.w)));
  hi = max_nan(hi, max_nan(max_nan(v.x, v.y), max_nan(v.z, v.w)));
}

// min and max over the block's first W warps, in every thread of them
template <int W>
__device__ __forceinline__ void group_minmax(float& lo, float& hi) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (W > 1) {
    __shared__ float s_lo[W], s_hi[W];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
      s_lo[warp] = lo;
      s_hi[warp] = hi;
    }
    __syncthreads();
    lo = s_lo[0];
    hi = s_hi[0];
#pragma unroll
    for (int w = 1; w < W; ++w) {
      lo = min_nan(lo, s_lo[w]);
      hi = max_nan(hi, s_hi[w]);
    }
  }
}

// entries 4g .. 4g + 3 of a row; past the row's end (the scalar path only)
// entry 4g repeats, which leaves its min and max as they are
template <bool VEC, bool STREAM>
__device__ __forceinline__ float4 load_group(const float* __restrict__ row, long long g,
                                             long long cols) {
  if (VEC) {
    const float4* p = reinterpret_cast<const float4*>(row) + g;
    return STREAM ? __ldcs(p) : *p;
  }
  const long long i = 4 * g;
  float4 v;
  v.x = row[i];
  v.y = i + 1 < cols ? row[i + 1] : v.x;
  v.z = i + 2 < cols ? row[i + 2] : v.x;
  v.w = i + 3 < cols ? row[i + 3] : v.x;
  return v;
}

__device__ __forceinline__ float scale_of(float lo, float hi, float inv_levels) {
  const float scale = __fmul_rn(__fsub_rn(hi, lo), inv_levels);
  return scale <= 0.0f ? 1.0f : scale;
}

__device__ __forceinline__ float quant(float v, float lo, float scale) {
  return rintf(__fdiv_rn(__fsub_rn(v, lo), scale));
}

__device__ __forceinline__ uint32_t code_of(float q) { return (uint8_t)(unsigned int)q; }

// codes (and deq, unless null) of entries 4g .. 4g + 3 of a row
template <bool VEC>
__device__ __forceinline__ void encode_group(float4 v, float lo, float scale, long long g,
                                             long long cols, uint8_t* __restrict__ codes,
                                             float* __restrict__ deq) {
  const float q[4] = {quant(v.x, lo, scale), quant(v.y, lo, scale), quant(v.z, lo, scale),
                      quant(v.w, lo, scale)};
  if (VEC) {
    reinterpret_cast<uint32_t*>(codes)[g] =
        code_of(q[0]) | code_of(q[1]) << 8 | code_of(q[2]) << 16 | code_of(q[3]) << 24;
    if (deq)
      reinterpret_cast<float4*>(deq)[g] =
          make_float4(__fmaf_rn(q[0], scale, lo), __fmaf_rn(q[1], scale, lo),
                      __fmaf_rn(q[2], scale, lo), __fmaf_rn(q[3], scale, lo));
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = 4 * g + k;
    if (i < cols) {
      codes[i] = (uint8_t)code_of(q[k]);
      if (deq) deq[i] = __fmaf_rn(q[k], scale, lo);
    }
  }
}

// rows held on chip: W warps a row (kThreads / (32 W) rows a block), J
// float4 groups a thread; the row is read once
template <int W, int J, bool VEC>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const float* __restrict__ x, float* __restrict__ deq,
                         uint8_t* __restrict__ codes, float* __restrict__ lo_out,
                         float* __restrict__ scale_out, long long rows, long long cols,
                         float inv_levels) {
  static_assert(W == 1 || W == kWarps, "a row takes one warp or the whole block");
  constexpr int kRowThreads = 32 * W;
  const int t = threadIdx.x % kRowThreads;
  const long long row = (long long)blockIdx.x * (kThreads / kRowThreads) + threadIdx.x / kRowThreads;
  if (row >= rows) return;  // whole warps (W == 1); never for W > 1, whose grid is rows
  const long long n4 = (cols + 3) / 4, base = row * cols;
  float4 v[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const long long g = (long long)j * kRowThreads + t;
    if (g < n4) v[j] = load_group<VEC, true>(x + base, g, cols);
  }
  float lo = __int_as_float(0x7f800000), hi = -lo;  // +inf, -inf
#pragma unroll
  for (int j = 0; j < J; ++j)
    if ((long long)j * kRowThreads + t < n4) fold(lo, hi, v[j]);
  group_minmax<W>(lo, hi);
  const float scale = scale_of(lo, hi, inv_levels);
  if (t == 0) {
    lo_out[row] = lo;
    scale_out[row] = scale;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const long long g = (long long)j * kRowThreads + t;
    if (g < n4) encode_group<VEC>(v[j], lo, scale, g, cols, codes + base, deq ? deq + base : nullptr);
  }
}

// Long rows are cut into steps of kLongMinGroups float4 groups (16 KB).
// Pass 1: the `parts` blocks of a row sweep it together, one stripe of parts
// steps at a time; block `part` takes step `part` of every stripe. Pass 2:
// one block a step, the last step of the last row first.

// long rows, pass 1: the min and max of each (row, part)
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    quantize_minmax_kernel(const float* __restrict__ x, float* __restrict__ part_lo,
                           float* __restrict__ part_hi, long long cols, long long parts) {
  const long long seg = blockIdx.x, row = seg / parts;
  const long long end = (cols + 3) / 4, stripe = parts * kLongMinGroups;
  const float* p = x + row * cols;
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (long long g0 = (seg % parts) * kLongMinGroups + threadIdx.x; g0 < end; g0 += stripe) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g0 + u * kThreads < end) v[u] = load_group<VEC, false>(p, g0 + u * kThreads, cols);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g0 + u * kThreads < end) fold(lo, hi, v[u]);
  }
  group_minmax<kWarps>(lo, hi);
  if (threadIdx.x == 0) {
    part_lo[seg] = lo;
    part_hi[seg] = hi;
  }
}

// long rows, pass 2: every block folds its row's partials, then encodes its
// step
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    quantize_encode_kernel(const float* __restrict__ x, const float* __restrict__ part_lo,
                           const float* __restrict__ part_hi, float* __restrict__ deq,
                           uint8_t* __restrict__ codes, float* __restrict__ lo_out,
                           float* __restrict__ scale_out, long long cols, long long parts,
                           float inv_levels) {
  const long long end = (cols + 3) / 4, steps = (end + kLongMinGroups - 1) / kLongMinGroups;
  const long long seg = gridDim.x - 1 - blockIdx.x, row = seg / steps, step = seg % steps;
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (long long i = threadIdx.x; i < parts; i += kThreads) {
    lo = min_nan(lo, part_lo[row * parts + i]);
    hi = max_nan(hi, part_hi[row * parts + i]);
  }
  group_minmax<kWarps>(lo, hi);
  const float scale = scale_of(lo, hi, inv_levels);
  if (step == 0 && threadIdx.x == 0) {
    lo_out[row] = lo;
    scale_out[row] = scale;
  }
  const long long base = row * cols, g0 = step * kLongMinGroups + threadIdx.x;
  float4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (g0 + u * kThreads < end) v[u] = load_group<VEC, true>(x + base, g0 + u * kThreads, cols);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (g0 + u * kThreads < end)
      encode_group<VEC>(v[u], lo, scale, g0 + u * kThreads, cols, codes + base,
                        deq ? deq + base : nullptr);
}

struct RowsArgs {
  const float* x;
  float* deq;
  uint8_t* codes;
  float* lo;
  float* scale;
  long long rows, cols;
  float inv_levels;
};

// the rows kernel with the fewest groups a thread that hold `need`
template <int W, bool VEC>
void launch_rows(int need, unsigned grid, cudaStream_t st, const RowsArgs& a) {
#define ROWS_CASE(J)                                                                            \
  if (need <= J) {                                                                              \
    quantize_rows_kernel<W, J, VEC><<<grid, kThreads, 0, st>>>(a.x, a.deq, a.codes, a.lo,       \
                                                               a.scale, a.rows, a.cols,         \
                                                               a.inv_levels);                   \
    return;                                                                                     \
  }
  ROWS_CASE(1) ROWS_CASE(2) ROWS_CASE(3) ROWS_CASE(4) ROWS_CASE(6) ROWS_CASE(8) ROWS_CASE(12)
  ROWS_CASE(16)
#undef ROWS_CASE
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

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

}  // namespace

// How quantize cuts a [rows, cols] call: 0 a warp a row, 1 a block a row
// (both read once), 2 long rows read twice, pass 1 by *parts blocks a row,
// with 2 * rows * parts fp32 of scratch, pass 2 by one block a step
// (kernels/quantize.py: quantize_plan mirrors it, and chip_smoke.py's phase
// 8a holds the two equal). -1 for an empty or too large shape.
extern "C" int quantize_plan(long long rows, long long cols, long long* parts) {
  *parts = 1;
  if (rows <= 0 || cols <= 0) return -1;
  if (cols <= kWarpRowMax) return (rows + kWarps - 1) / kWarps <= 0x7fffffffLL ? 0 : -1;
  if (cols <= kBlockRowMax) return rows <= 0x7fffffffLL ? 1 : -1;
  const long long by_card = (kLongBlocks + rows - 1) / rows;
  const long long by_row = (cols + 3) / 4 / kLongMinGroups;  // >= 4: cols > kBlockRowMax
  *parts = by_card < by_row ? by_card : by_row;
  const long long steps = rows * (((cols + 3) / 4 + kLongMinGroups - 1) / kLongMinGroups);
  return steps <= 0x7fffffffLL ? 2 : -1;  // steps >= rows * parts: both grids fit
}

// x [rows, cols] fp32 -> deq [rows, cols] fp32 (skipped where deq is null),
// codes [rows, cols] u8, lo and scale [rows] fp32. partial: the scratch
// quantize_plan asks for (null where it asks for none). nlevels =
// 2^bits - 1. Returns cudaGetLastError() after the launches.
extern "C" int quantize(const void* x, void* deq, void* codes, void* lo, void* scale,
                        void* partial, long long rows, long long cols, int nlevels,
                        void* stream) {
  long long parts;
  const int plan = quantize_plan(rows, cols, &parts);
  if (nlevels < 1 || nlevels > 255 || plan < 0 || (plan == 2 && !partial))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = cols % 4 == 0 && aligned(x, 16) && aligned(codes, 4) && (!deq || aligned(deq, 16));
  const RowsArgs a{static_cast<const float*>(x), static_cast<float*>(deq),
                   static_cast<uint8_t*>(codes), static_cast<float*>(lo),
                   static_cast<float*>(scale), rows, cols,
                   1.0f / (float)nlevels};  // the fp32 reciprocal, correctly rounded
  const long long n4 = (cols + 3) / 4;
  if (plan == 0) {
    const int need = (int)((n4 + 31) / 32);
    const unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
    vec ? launch_rows<1, true>(need, grid, st, a) : launch_rows<1, false>(need, grid, st, a);
  } else if (plan == 1) {
    const int need = (int)((n4 + kThreads - 1) / kThreads);
    vec ? launch_rows<kWarps, true>(need, (unsigned)rows, st, a)
        : launch_rows<kWarps, false>(need, (unsigned)rows, st, a);
  } else {
    float* part_lo = static_cast<float*>(partial);
    float* part_hi = part_lo + rows * parts;
    const unsigned grid = (unsigned)(rows * parts);
    const unsigned steps = (unsigned)(rows * ((n4 + kLongMinGroups - 1) / kLongMinGroups));
    if (vec) {
      quantize_minmax_kernel<true><<<grid, kThreads, 0, st>>>(a.x, part_lo, part_hi, cols, parts);
      quantize_encode_kernel<true><<<steps, kThreads, 0, st>>>(
          a.x, part_lo, part_hi, a.deq, a.codes, a.lo, a.scale, cols, parts, a.inv_levels);
    } else {
      quantize_minmax_kernel<false><<<grid, kThreads, 0, st>>>(a.x, part_lo, part_hi, cols, parts);
      quantize_encode_kernel<false><<<steps, kThreads, 0, st>>>(
          a.x, part_lo, part_hi, a.deq, a.codes, a.lo, a.scale, cols, parts, a.inv_levels);
    }
  }
  return (int)cudaGetLastError();
}

// codes [rows, cols] u8, lo and scale [rows] fp32 -> out [rows, cols] fp32.
extern "C" int dequantize(const void* codes, const void* lo, const void* scale, void* out,
                          long long rows, long long cols, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const long long chunks = (cols + kChunk - 1) / kChunk, tiles = rows * chunks;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  decode_kernel<<<(unsigned)tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(lo),
      static_cast<const float*>(scale), static_cast<float*>(out), cols, chunks);
  return (int)cudaGetLastError();
}

// the sizes kernels/quantize.py's plan assumes: the longest row a warp and a
// block hold, the blocks a long call aims at, the least groups a part
extern "C" int quantize_tiles(int* warp_row_max, int* block_row_max, int* long_blocks,
                              int* long_min_groups) {
  *warp_row_max = kWarpRowMax;
  *block_row_max = kBlockRowMax;
  *long_blocks = kLongBlocks;
  *long_min_groups = kLongMinGroups;
  return 0;
}

extern "C" const char* quantize_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
