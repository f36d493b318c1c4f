// One-token GQA decode attention over the paged KV pool, for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_paged_kernel
// (Pallas, reached through _paged_decode_pallas / paged_decode_attention).
//
// Inputs: q [B, KV, G, hd]; the k/v pool of one layer in its stored layout
// [n_pages, page_size, KV, hd], addressed through the strides it is given (the
// pool is never transposed or copied); page_table [B, max_pages] int32 (0 =
// the reserved null page); lengths [B] int32 including the current token.
// Output [B, KV, G, hd] in q's dtype.
//
// What bounds it on this card: every K/V element it reads is used for G
// multiply-adds per head, about one flop per byte, so device memory (3.35
// TB/s) is the bound, and the least bytes are the K/V rows of the positions
// each slot attends to.
//
// Design: one thread block per (slot, kv head) with its G query rows. The block
// reads lengths[b] and its page-table row itself and walks only the positions
// [lo, length) - lo = length - window with a sliding window - in chunks of
// CHUNK positions, so only the pages that hold them are read and table entries
// past the allocation are never touched (the TPU grid visits every table entry
// and masks; the result is the same). Each chunk's K/V rows for this head are
// staged in shared memory (rows padded to hd + 1 floats: conflict-free column
// reads), scored against the G query rows, and folded into an fp32 online
// softmax with explicit masking (p = 0 outside [lo, length)). One warp per
// query head does the max / sum reductions with shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 64;  // positions staged per iteration (two per lane)
constexpr int MAX_G = 16;
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ lengths, T* __restrict__ out,
    int KV, int G, int ps, int max_pages, int n_pages, long long page_stride,
    long long pos_stride, long long head_stride, int window, float scale) {
  static_assert(CHUNK == 64, "the softmax step gives each lane two positions");
  __shared__ float Ks[CHUNK][HD + 1];
  __shared__ float Vs[CHUNK][HD + 1];
  __shared__ float Ps[MAX_G][CHUNK];
  __shared__ float Qs[MAX_G][HD];
  __shared__ float Acc[MAX_G][HD];
  __shared__ float Mrow[MAX_G], Lrow[MAX_G], Corr[MAX_G];

  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  const T* qb = q + ((long long)b * KV + kvh) * G * HD;
  for (int i = tid; i < G * HD; i += THREADS) {
    Qs[i / HD][i % HD] = to_f(qb[i]);
    Acc[i / HD][i % HD] = 0.f;
  }
  if (tid < G) {
    Mrow[tid] = NEG_INF;
    Lrow[tid] = 0.f;
  }

  // positions attended: [lo, hi); positions past the table's pages do not exist
  const int len = lengths[b];
  const int hi = min(len, max_pages * ps);
  const int lo = window ? max(0, len - window) : 0;
  const int* trow = table + (long long)b * max_pages;
  const T* kh = kp + kvh * head_stride;
  const T* vh = vp + kvh * head_stride;

  for (int c0 = lo; c0 < hi; c0 += CHUNK) {
    __syncthreads();  // previous chunk consumed, init visible
    for (int i = tid; i < CHUNK * HD; i += THREADS) {
      const int j = i / HD, h = i % HD;
      const int p = c0 + j;
      float kx = 0.f, vx = 0.f;
      if (p < hi) {
        const int page = trow[p / ps];
        if (page >= 0 && page < n_pages) {
          const long long off = page * page_stride + (p % ps) * pos_stride + h;
          kx = to_f(kh[off]);
          vx = to_f(vh[off]);
        }
      }
      Ks[j][h] = kx;
      Vs[j][h] = vx;
    }
    __syncthreads();
    for (int i = tid; i < G * CHUNK; i += THREADS) {
      const int g = i / CHUNK, j = i % CHUNK;
      float d = 0.f;
#pragma unroll
      for (int h = 0; h < HD; ++h) d = fmaf(Qs[g][h], Ks[j][h], d);
      Ps[g][j] = (c0 + j < hi) ? d * scale : NEG_INF;
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s0 = Ps[g][lane], s1 = Ps[g][lane + 32];
      float cmax = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off; off >>= 1) cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
      const float m_old = Mrow[g];
      const float m_new = fmaxf(m_old, cmax);
      const float p0 = (c0 + lane < hi) ? expf(s0 - m_new) : 0.f;
      const float p1 = (c0 + lane + 32 < hi) ? expf(s1 - m_new) : 0.f;
      Ps[g][lane] = p0;
      Ps[g][lane + 32] = p1;
      float lsum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Corr[g] = corr;
        Lrow[g] = Lrow[g] * corr + lsum;
        Mrow[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += THREADS) {
      const int g = i / HD, h = i % HD;
      float a = Acc[g][h] * Corr[g];
#pragma unroll 8
      for (int j = 0; j < CHUNK; ++j) a = fmaf(Ps[g][j], Vs[j][h], a);
      Acc[g][h] = a;
    }
  }
  __syncthreads();
  T* ob = out + ((long long)b * KV + kvh) * G * HD;
  for (int i = tid; i < G * HD; i += THREADS)
    ob[i] = from_f<T>(Acc[i / HD][i % HD] / fmaxf(Lrow[i / HD], 1e-30f));
}

template <typename T, int HD>
void launch(const void* q, const void* kp, const void* vp, const void* table, const void* lengths,
            void* out, int B, int KV, int G, int ps, int max_pages, int n_pages,
            long long page_stride, long long pos_stride, long long head_stride, int window,
            float scale, cudaStream_t st) {
  paged_decode_kernel<T, HD><<<B * KV, THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(table), static_cast<const int*>(lengths), static_cast<T*>(out),
      KV, G, ps, max_pages, n_pages, page_stride, pos_stride, head_stride, window, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp, const void* table,
                            const void* lengths, void* out, int B, int KV, int G, int hd, int ps,
                            int max_pages, int n_pages, long long page_stride,
                            long long pos_stride, long long head_stride, int window, float scale,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAX_G || B * KV == 0) return (int)cudaErrorInvalidValue;
#define PAGED_ARGS q, kp, vp, table, lengths, out, B, KV, G, ps, max_pages, n_pages, page_stride, \
                   pos_stride, head_stride, window, scale, st
  if (dtype == 0 && hd == 64) launch<float, 64>(PAGED_ARGS);
  else if (dtype == 1 && hd == 64) launch<__nv_bfloat16, 64>(PAGED_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef PAGED_ARGS
  return (int)cudaGetLastError();
}

extern "C" const char* paged_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
