// GQA flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py:_dq_kernel and
// _dkv_kernel (Pallas, reached through _bwd / _flash_fn's custom VJP).
//
// Layout as the forward: q, do [BKV, S, G, hd]; k, v [BKV, S, hd]; lse and
// dl = rowsum(do * o) [BKV, S, G] fp32. dq like q, dk and dv like k. fp32
// or bf16 in, fp32 arithmetic.
//
// What bounds it on this card: at the training shape (BKV = 24, S = 1024,
// G = 3, hd = 64, bf16, causal) the two sweeps read ~40 MB and write ~12 MB
// (about 15 us at 3.35 TB/s) against five products over 524,800 causal pairs
// per head, ~24 GFLOP (about 24 us on the bf16 tensor cores). This first
// version runs its products on the fp32 CUDA cores (67 TFLOP/s), so those
// bound it; wgmma and TMA come in a later change.
//
// Design. The TPU kernels carry their accumulators in scratch across a
// sequential grid. Here blocks run in parallel and in no order, so each
// block owns its accumulators and loops over its own range, and the two
// sweeps stay separate (no atomics: both are deterministic run to run).
//   * dq: one block per (row of BKV, tile of DQ_BQ positions) x G heads; it
//     walks the kv tiles of flash_attention.visited_kv_range at its tile
//     sizes, staging each K/V tile in shared memory once for all G heads.
//   * dkv: one block per (row of BKV, tile of DKV_BKV kv positions); it
//     walks the q positions that can see the tile, from the causal diagonal
//     to the sliding window's far edge (the inverse of visited_kv_range),
//     staging q and do for all G heads of each position, so dk and dv sum
//     over the G query heads of their kv head.
// Registers: a thread would need q, do and dq (dq sweep) or k, v, dk and dv
// (dkv sweep) as 64-float rows; 256 floats do not fit under the 255-register
// limit. So two neighbouring threads share a row, each holding 32 of its 64
// dims (dims 4i + 2h and 4i + 2h + 1 of half h, read as float2), and the two
// dot products of each (row, key) pair are summed across the pair with one
// shuffle each. Masked pairs are never computed (explicit masking: they add
// exactly zero), and ragged tile edges are masked, so any S works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HD = 64;
constexpr int HALF = HD / 2;
constexpr int DQ_BQ = 16;     // q positions per dq block (times G heads, times 2 threads)
constexpr int DQ_BKV = 64;    // kv positions per staged K/V tile (dq sweep)
constexpr int DKV_BKV = 32;   // kv positions per dkv block (times 2 threads)
constexpr int DKV_ROWS = 64;  // q rows (positions x G heads) per staged q/do tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the two lanes of a thread pair (for __shfl_xor_sync)
__device__ __forceinline__ unsigned pair_mask() { return 3u << ((threadIdx.x & 31) & ~1); }

template <typename T>
__device__ __forceinline__ void load_half(const T* __restrict__ row, int h, float* dst) {
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) {
    dst[2 * i] = to_f(row[4 * i + 2 * h]);
    dst[2 * i + 1] = to_f(row[4 * i + 2 * h + 1]);
  }
}

template <typename T>
__device__ __forceinline__ void store_half(T* __restrict__ row, int h, const float* src,
                                           float mult) {
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) {
    row[4 * i + 2 * h] = from_f<T>(mult * src[2 * i]);
    row[4 * i + 2 * h + 1] = from_f<T>(mult * src[2 * i + 1]);
  }
}

// partial dot of a register half-row with the matching half of a shared row
__device__ __forceinline__ float dot_half(const float* r, const float* srow, int h) {
  const float2* s2 = reinterpret_cast<const float2*>(srow);
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) {
    const float2 x = s2[2 * i + h];
    d = fmaf(r[2 * i], x.x, d);
    d = fmaf(r[2 * i + 1], x.y, d);
  }
  return d;
}

__device__ __forceinline__ void axpy_half(float a, const float* srow, int h, float* acc) {
  const float2* s2 = reinterpret_cast<const float2*>(srow);
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) {
    const float2 x = s2[2 * i + h];
    acc[2 * i] = fmaf(a, x.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(a, x.y, acc[2 * i + 1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(2 * DQ_BQ * 8) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dl,
    T* __restrict__ dq, int S, int G, int nq, int causal, int window, float scale) {
  __shared__ __align__(16) float Ks[DQ_BKV][HD];
  __shared__ __align__(16) float Vs[DQ_BKV][HD];

  const int b = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // longest causal rows first
  const int tid = threadIdx.x;
  const int r = tid >> 1, h = tid & 1;
  const int pos = qi * DQ_BQ + r / G;
  const bool row_ok = pos < S;
  const long long row = ((long long)b * S + (row_ok ? pos : 0)) * G + r % G;
  const unsigned pm = pair_mask();

  float qr[HALF], dor[HALF], acc[HALF];
  load_half(q + row * HD, h, qr);
  load_half(dout + row * HD, h, dor);
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.f;
  const float lse_r = lse[row], dl_r = dl[row];

  // visited kv tiles [lo, hi): visited_kv_range at tile sizes (DQ_BQ, DQ_BKV)
  const int nkv = (S + DQ_BKV - 1) / DQ_BKV;
  const int q_first = qi * DQ_BQ;
  int hi = nkv;
  if (causal) hi = min(nkv, (q_first + DQ_BQ - 1) / DQ_BKV + 1);
  int lo = 0;
  if (window)
    while (lo < hi - 1 && q_first - (lo * DQ_BKV + DQ_BKV - 1) >= window) ++lo;

  const T* kb = k + (long long)b * S * HD;
  const T* vb = v + (long long)b * S * HD;
  for (int kj = lo; kj < hi; ++kj) {
    const int kv0 = kj * DQ_BKV;
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < DQ_BKV * HD; i += blockDim.x) {
      const int j = i / HD, d = i % HD;
      const bool ok = kv0 + j < S;
      const long long off = (long long)(kv0 + j) * HD + d;
      Ks[j][d] = ok ? to_f(kb[off]) : 0.f;
      Vs[j][d] = ok ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();
    if (!row_ok) continue;
    // the keys of this tile the row sees: [j_lo, j_hi)
    int j_hi = min(DQ_BKV, S - kv0);
    if (causal) j_hi = min(j_hi, pos - kv0 + 1);
    const int j_lo = window ? max(0, pos - window + 1 - kv0) : 0;
    for (int j = j_lo; j < j_hi; ++j) {
      float s = dot_half(qr, Ks[j], h);
      float dp = dot_half(dor, Vs[j], h);
      s += __shfl_xor_sync(pm, s, 1);
      dp += __shfl_xor_sync(pm, dp, 1);
      const float p = expf(s * scale - lse_r);
      axpy_half(p * (dp - dl_r), Ks[j], h, acc);
    }
  }
  if (row_ok) store_half(dq + row * HD, h, acc, scale);
}

template <typename T>
__global__ void __launch_bounds__(2 * DKV_BKV) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dl,
    T* __restrict__ dk, T* __restrict__ dv, int S, int G, int nkv, int causal, int window,
    float scale) {
  __shared__ __align__(16) float Qs[DKV_ROWS][HD];
  __shared__ __align__(16) float Ds[DKV_ROWS][HD];
  __shared__ float Ls[DKV_ROWS], Dls[DKV_ROWS];

  const int b = blockIdx.x / nkv;
  const int kv0 = (int)(blockIdx.x % nkv) * DKV_BKV;
  const int tid = threadIdx.x;
  const int col = kv0 + (tid >> 1), h = tid & 1;
  const bool col_ok = col < S;
  const long long krow = (long long)b * S + (col_ok ? col : 0);
  const unsigned pm = pair_mask();

  float kr[HALF], vr[HALF], dka[HALF], dva[HALF];
  load_half(k + krow * HD, h, kr);
  load_half(v + krow * HD, h, vr);
#pragma unroll
  for (int i = 0; i < HALF; ++i) dka[i] = dva[i] = 0.f;

  // q positions that see any key of this tile: from the causal diagonal to
  // the window's far edge
  const int p_lo = causal ? kv0 : 0;
  const int p_hi = window ? min(S, kv0 + DKV_BKV - 1 + window) : S;
  const int bq = DKV_ROWS / G;  // positions per staged q tile
  for (int p0 = p_lo; p0 < p_hi; p0 += bq) {
    const int nrows = min(bq, p_hi - p0) * G;
    const long long base = ((long long)b * S + p0) * G;  // first (position, head) row
    __syncthreads();
    for (int i = tid; i < nrows * HD; i += blockDim.x) {
      Qs[i / HD][i % HD] = to_f(q[base * HD + i]);
      Ds[i / HD][i % HD] = to_f(dout[base * HD + i]);
    }
    for (int i = tid; i < nrows; i += blockDim.x) {
      Ls[i] = lse[base + i];
      Dls[i] = dl[base + i];
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int rr = 0; rr < nrows; ++rr) {
      const int pos = p0 + rr / G;
      if ((causal && col > pos) || (window && pos - col >= window)) continue;
      float s = dot_half(kr, Qs[rr], h);
      float dp = dot_half(vr, Ds[rr], h);
      s += __shfl_xor_sync(pm, s, 1);
      dp += __shfl_xor_sync(pm, dp, 1);
      const float p = expf(s * scale - Ls[rr]);
      axpy_half(p, Ds[rr], h, dva);
      axpy_half(p * (dp - Dls[rr]), Qs[rr], h, dka);
    }
  }
  if (col_ok) {
    store_half(dk + krow * HD, h, dka, scale);
    store_half(dv + krow * HD, h, dva, 1.f);
  }
}

int check(int G, int hd, int dtype) {
  if (hd != HD || G < 1 || G > 8 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after its launch.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* dl, void* dq, int bkv, int S, int G, int hd,
                        int causal, int window, float scale, int dtype, void* stream) {
  if (int rc = check(G, hd, dtype)) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq = (S + DQ_BQ - 1) / DQ_BQ;
  const dim3 grid(bkv * nq), block(2 * DQ_BQ * G);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dl);
  if (dtype == 0)
    flash_dq_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, d, static_cast<float*>(dq), S, G, nq, causal, window,
        scale);
  else
    flash_dq_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), l, d,
        static_cast<__nv_bfloat16*>(dq), S, G, nq, causal, window, scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* dl, void* dk, void* dv, int bkv, int S, int G,
                         int hd, int causal, int window, float scale, int dtype, void* stream) {
  if (int rc = check(G, hd, dtype)) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nkv = (S + DKV_BKV - 1) / DKV_BKV;
  const dim3 grid(bkv * nkv), block(2 * DKV_BKV);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dl);
  if (dtype == 0)
    flash_dkv_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, d, static_cast<float*>(dk), static_cast<float*>(dv),
        S, G, nkv, causal, window, scale);
  else
    flash_dkv_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), l, d,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, G, nkv, causal,
        window, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* flash_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
