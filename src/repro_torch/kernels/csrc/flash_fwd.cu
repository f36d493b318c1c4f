// GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_fwd_kernel
// (Pallas, reached through _fwd / _flash_fn / gqa_flash_attention).
//
// Layout: q [BKV, S, G, hd], k/v [BKV, S, hd] (BKV = batch x kv heads, G query
// heads share one kv head); o like q; lse [BKV, S, G] fp32. fp32 or bf16 in,
// fp32 scores, online softmax and accumulator.
//
// What bounds it on this card: at the serving prefill shape (BKV = 48, S = 512,
// G = 3, hd = 64, bf16) the least time is about even between the bytes (q, k,
// v, o and lse, ~25 MB at 3.35 TB/s) and the causal products (~4.8 GFLOP at
// 989 TFLOP/s on the tensor cores); the flops grow with S^2, so longer
// prompts are compute-bound. This first version runs its products on the fp32
// CUDA cores (67 TFLOP/s), so those bound it, well above the card's bound;
// wgmma and TMA come in a later change.
//
// Design: one thread block per (row of BKV, tile of BQ positions); each thread
// owns one (position, query head) row and keeps q and acc in registers. A loop
// inside the block walks the kv tiles in the range that
// flash_attention.visited_kv_range gives at this kernel's tile sizes, so tiles
// above the causal diagonal or left of the sliding window are never loaded
// (no schedule array). Each K/V tile is staged once in shared memory and read
// by all G heads of the block (broadcast reads). The online softmax updates
// once per CH keys; masked entries get p = 0 explicitly, never exp(NEG_INF -
// NEG_INF) = 1. Any S works: ragged tile edges are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;   // q positions per block (times G heads = threads)
constexpr int BKV = 64;  // kv positions per shared-memory tile
constexpr int CH = 16;   // keys per online-softmax update
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(256) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int G, int nq, int causal,
    int window, float scale) {
  __shared__ __align__(16) float Ks[BKV][HD];
  __shared__ __align__(16) float Vs[BKV][HD];

  const int b = blockIdx.x / nq;
  const int qi = nq - 1 - (int)(blockIdx.x % nq);  // longest causal rows first
  const int tid = threadIdx.x;
  const int pos = qi * BQ + tid / G;
  const int g = tid % G;
  const bool row_ok = pos < S;
  const long long row = ((long long)b * S + pos) * G + g;

  float qr[HD], acc[HD];
#pragma unroll
  for (int h = 0; h < HD; ++h) {
    qr[h] = row_ok ? to_f(q[row * HD + h]) : 0.f;
    acc[h] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  // visited kv tiles [lo, hi): visited_kv_range at tile sizes (BQ, BKV)
  const int nkv = (S + BKV - 1) / BKV;
  const int q_first = qi * BQ;
  int hi = nkv;
  if (causal) hi = min(nkv, (q_first + BQ - 1) / BKV + 1);
  int lo = 0;
  if (window)
    while (lo < hi - 1 && q_first - (lo * BKV + BKV - 1) >= window) ++lo;

  const T* kb = k + (long long)b * S * HD;
  const T* vb = v + (long long)b * S * HD;
  for (int kj = lo; kj < hi; ++kj) {
    const int kv0 = kj * BKV;
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < BKV * HD; i += blockDim.x) {
      const int j = i / HD, h = i % HD;
      const bool ok = kv0 + j < S;
      const long long off = (long long)(kv0 + j) * HD + h;
      Ks[j][h] = ok ? to_f(kb[off]) : 0.f;
      Vs[j][h] = ok ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();
    if (!row_ok) continue;
#pragma unroll 1
    for (int j0 = 0; j0 < BKV; j0 += CH) {
      const int c0 = kv0 + j0;
      // a chunk masked for the whole row would leave (m, l, acc) exactly as
      // they are (corr = 1, p = 0), so skipping it is exact
      if (c0 >= S || (causal && c0 > pos) || (window && pos - (c0 + CH - 1) >= window)) continue;
      float s[CH];
      unsigned valid = 0u;
      float cmax = NEG_INF;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int col = c0 + c;
        const bool ok = col < S && (!causal || col <= pos) && (!window || pos - col < window);
        const float4* kr = reinterpret_cast<const float4*>(Ks[j0 + c]);
        float d = 0.f;
#pragma unroll
        for (int h4 = 0; h4 < HD / 4; ++h4) {
          const float4 kk = kr[h4];
          d = fmaf(qr[4 * h4], kk.x, d);
          d = fmaf(qr[4 * h4 + 1], kk.y, d);
          d = fmaf(qr[4 * h4 + 2], kk.z, d);
          d = fmaf(qr[4 * h4 + 3], kk.w, d);
        }
        s[c] = ok ? d * scale : NEG_INF;
        valid |= ok ? (1u << c) : 0u;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int h = 0; h < HD; ++h) acc[h] *= corr;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float p = ((valid >> c) & 1u) ? expf(s[c] - m_new) : 0.f;
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(Vs[j0 + c]);
#pragma unroll
        for (int h4 = 0; h4 < HD / 4; ++h4) {
          const float4 vv = vr[h4];
          acc[4 * h4] = fmaf(p, vv.x, acc[4 * h4]);
          acc[4 * h4 + 1] = fmaf(p, vv.y, acc[4 * h4 + 1]);
          acc[4 * h4 + 2] = fmaf(p, vv.z, acc[4 * h4 + 2]);
          acc[4 * h4 + 3] = fmaf(p, vv.w, acc[4 * h4 + 3]);
        }
      }
      m = m_new;
    }
  }
  if (!row_ok) return;
  l = fmaxf(l, 1e-30f);
#pragma unroll
  for (int h = 0; h < HD; ++h) o[row * HD + h] = from_f<T>(acc[h] / l);
  lse[row] = m + logf(l);
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o, void* lse, int bkv, int S,
            int G, int causal, int window, float scale, cudaStream_t st) {
  const int nq = (S + BQ - 1) / BQ;
  flash_fwd_kernel<T, HD><<<bkv * nq, BQ * G, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), S, G, nq, causal, window, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bkv, int S, int G, int hd, int causal, int window, float scale,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || BQ * G > 256) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64) launch<float, 64>(q, k, v, o, lse, bkv, S, G, causal, window, scale, st);
  else if (dtype == 1 && hd == 64) launch<__nv_bfloat16, 64>(q, k, v, o, lse, bkv, S, G, causal, window, scale, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* flash_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int flash_fwd_tiles(int* bq, int* bkv) {
  *bq = BQ;
  *bkv = BKV;
  return 0;
}
