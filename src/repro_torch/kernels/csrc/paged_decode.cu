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
// each slot attends to: ~6.7 MB at the serving shape (16 slots of ~550
// positions, 3 kv heads), 2 us. A decode step has few slots, so the work of
// one (slot, kv head) must be spread over many blocks for the card to have
// enough loads in flight; one block each (48 for 132 SMs, walking ~576
// positions one after the other) leaves it idle.
//
// Design: split-K over positions, two passes in one entry point.
// 1. paged_decode_split_kernel, grid (n_split, KV, B) with n_split =
//    ceil(max_pages * page_size / SPLIT), a number the host knows from the
//    table's shape (lengths stay on the card; nothing is read back, so the
//    launch can be captured in a graph). Block (s, kv head, slot) reads
//    lengths[b] and the table entries of positions [s SPLIT, (s + 1) SPLIT)
//    cut to the attended [lo, length) - lo = length - window with a sliding
//    window - so only the pages that hold them are read. Each K and V row of
//    the head (hd elements, 128 or 256 contiguous bytes in bf16) is read as
//    16-byte vectors, all of a block's loads issued before the first is
//    used, and staged in fp32 in shared memory (rows padded to hd + 1
//    floats: conflict-free column reads). The block scores its positions
//    against the G query rows and folds them into an fp32 (m, l, acc[G,
//    hd]) with explicit masking (p = 0 outside [lo, length)); one warp per
//    query head does the max / sum reductions with shuffles. It writes the
//    partial (unnormalised acc, m, l) to scratch the wrapper allocates. An
//    empty split (past the length, wholly below the window, or the idle
//    slot's) writes m = NEG_INF, l = 0, acc = 0.
//    SPLIT is 64 positions at hd 64 and 32 at hd 112 and 128: the same bytes
//    of K and V a split at hd 64 and 128, and the fp32 staging of 64 x 129
//    floats each for K and V would pass the 48 KB of static shared memory at
//    hd 128. At hd 112 (kimi-k2) 4096 / hd = 36 positions would be neither
//    whole lanes of the softmax step nor whole pages, so it takes 32 (64 x
//    113 floats each would pass the 48 KB too). A bf16 split of 32 rows of
//    14 vectors is 448 vectors, not a multiple of the 128 threads: the last
//    of each thread's loads is guarded (a tail that does not exist at hd 64
//    and 128, where the guard folds away).
// 2. paged_decode_combine_kernel, one block per (slot, kv head), merges the
//    n_split partials of each query row in split order: M = max m_s, weights
//    exp(m_s - M), l = sum w_s l_s, out = sum w_s acc_s / max(l, 1e-30). No
//    atomics, so the output is bitwise repeatable. NEG_INF is the finite
//    -2e38, so an empty split weighs exp(-2e38 - M) = 0 when some split is
//    not empty; when every split is, M = NEG_INF, every weight is 1, l = 0
//    and the output is 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
// positions a split block folds at head dim HD (SPLIT / 32 per lane in the
// softmax step; a multiple of the serving page size 16)
template <int HD>
__host__ __device__ constexpr int split_of() { return HD == 112 ? 32 : 4096 / HD; }
constexpr int COMBINE_THREADS = 256;
constexpr int MAX_G = 16;
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the 16 bytes of a vector as fp32: 4 floats or 8 bf16
__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    out[2 * i] = __low2float(p);
    out[2 * i + 1] = __high2float(p);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) paged_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ table, const int* __restrict__ lengths, float* __restrict__ acc_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int KV, int G, int ps, int max_pages,
    int n_pages, long long page_stride, long long pos_stride, long long head_stride, int window,
    float scale) {
  constexpr int SPLIT = split_of<HD>();
  constexpr int PL = SPLIT / 32;  // positions a lane takes in the softmax step
  static_assert(SPLIT % 32 == 0, "whole positions per lane");
  constexpr int VE = 16 / sizeof(T);         // elements of a 16-byte vector
  constexpr int ROW_VECS = HD / VE;          // vectors of one K or V row
  constexpr int VECS = SPLIT * ROW_VECS;     // of one operand's split
  constexpr int ITERS = (VECS + THREADS - 1) / THREADS;
  constexpr bool TAIL = VECS % THREADS != 0;  // hd 112 in bf16: 448 vectors
  static_assert(HD % VE == 0, "whole vectors a row");
  __shared__ float Ks[SPLIT][HD + 1];
  __shared__ float Vs[SPLIT][HD + 1];
  __shared__ float Qs[MAX_G][HD];
  __shared__ float Ps[MAX_G][SPLIT];

  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long part = ((long long)b * KV + kvh) * gridDim.x + s;
  float* acc_out = acc_part + part * G * HD;

  // positions attended: [lo, hi); positions past the table's pages do not exist
  const int len = lengths[b];
  const int hi = min(len, max_pages * ps);
  const int lo = window ? max(0, len - window) : 0;
  const int s0 = s * SPLIT;
  const int p0 = max(lo, s0), p1 = min(hi, s0 + SPLIT);
  if (p0 >= p1) {  // an empty split contributes exactly nothing
    for (int i = tid; i < G * HD; i += THREADS) acc_out[i] = 0.f;
    if (tid < G) {
      m_part[part * G + tid] = NEG_INF;
      l_part[part * G + tid] = 0.f;
    }
    return;
  }

  // every K/V load of the split in flight before the first is used
  const int* trow = table + (long long)b * max_pages;
  const T* kh = kp + kvh * head_stride;
  const T* vh = vp + kvh * head_stride;
  uint4 kr[ITERS], vr[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int e = tid + it * THREADS;
    const int p = s0 + e / ROW_VECS, h = (e % ROW_VECS) * VE;
    kr[it] = vr[it] = make_uint4(0u, 0u, 0u, 0u);
    if ((!TAIL || e < VECS) && p >= p0 && p < p1) {
      const int page = trow[p / ps];
      if (page >= 0 && page < n_pages) {
        const long long off = page * page_stride + (p % ps) * pos_stride + h;
        kr[it] = *reinterpret_cast<const uint4*>(kh + off);
        vr[it] = *reinterpret_cast<const uint4*>(vh + off);
      }
    }
  }
  const T* qb = q + ((long long)b * KV + kvh) * G * HD;
  for (int i = tid; i < G * HD; i += THREADS) Qs[i / HD][i % HD] = to_f(qb[i]);
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int e = tid + it * THREADS;
    if (TAIL && e >= VECS) continue;
    const int j = e / ROW_VECS, h = (e % ROW_VECS) * VE;
    float kx[VE], vx[VE];
    unpack(kr[it], kx, T());
    unpack(vr[it], vx, T());
#pragma unroll
    for (int x = 0; x < VE; ++x) {
      Ks[j][h + x] = kx[x];
      Vs[j][h + x] = vx[x];
    }
  }
  __syncthreads();

  for (int i = tid; i < G * SPLIT; i += THREADS) {
    const int g = i / SPLIT, j = i % SPLIT;
    float d = 0.f;
#pragma unroll
    for (int h = 0; h < HD; ++h) d = fmaf(Qs[g][h], Ks[j][h], d);
    const int p = s0 + j;
    Ps[g][j] = (p >= p0 && p < p1) ? d * scale : NEG_INF;
  }
  __syncthreads();
  for (int g = warp; g < G; g += THREADS / 32) {
    float x[PL];
#pragma unroll
    for (int e = 0; e < PL; ++e) x[e] = Ps[g][lane + 32 * e];
    float m = x[0];
#pragma unroll
    for (int e = 1; e < PL; ++e) m = fmaxf(m, x[e]);
#pragma unroll
    for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
#pragma unroll
    for (int e = 0; e < PL; ++e) {
      const int qp = s0 + lane + 32 * e;
      const float ex = (qp >= p0 && qp < p1) ? expf(x[e] - m) : 0.f;
      Ps[g][lane + 32 * e] = ex;
      l += ex;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      m_part[part * G + g] = m;
      l_part[part * G + g] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, h = i % HD;
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < SPLIT; ++j) a = fmaf(Ps[g][j], Vs[j][h], a);
    acc_out[i] = a;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(COMBINE_THREADS) paged_decode_combine_kernel(
    const float* __restrict__ acc_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, T* __restrict__ out, int G, int n_split) {
  const long long bk = blockIdx.x;  // (slot, kv head)
  for (int i = threadIdx.x; i < G * HD; i += COMBINE_THREADS) {
    const int g = i / HD;
    const float* m = m_part + bk * n_split * G + g;  // split s at m[s * G]
    const float* l = l_part + bk * n_split * G + g;
    const float* a = acc_part + bk * n_split * G * HD + i;  // split s at a[s * G * HD]
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, m[s * G]);
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(m[s * G] - M);
      lsum = fmaf(w, l[s * G], lsum);
      o = fmaf(w, a[(long long)s * G * HD], o);
    }
    out[bk * G * HD + i] = from_f<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD>
void launch(const void* q, const void* kp, const void* vp, const void* table, const void* lengths,
            void* out, float* acc, float* m, float* l, int B, int KV, int G, int ps,
            int max_pages, int n_pages, long long page_stride, long long pos_stride,
            long long head_stride, int window, float scale, cudaStream_t st) {
  constexpr int SPLIT = split_of<HD>();
  const int n_split = (max_pages * ps + SPLIT - 1) / SPLIT;
  paged_decode_split_kernel<T, HD><<<dim3(n_split, KV, B), THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(table), static_cast<const int*>(lengths), acc, m, l, KV, G, ps,
      max_pages, n_pages, page_stride, pos_stride, head_stride, window, scale);
  paged_decode_combine_kernel<T, HD><<<B * KV, COMBINE_THREADS, 0, st>>>(
      acc, m, l, static_cast<T*>(out), G, n_split);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd 64, 112 or 128. acc [B, KV, n_split,
// G, hd], m and l [B, KV, n_split, G] fp32 are the caller's scratch, n_split
// = ceil(max_pages * ps / SPLIT) with SPLIT = 64 at hd 64 and 32 at hd 112
// and 128.
// Both passes launch on `stream`; returns cudaGetLastError() after the
// second.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp, const void* table,
                            const void* lengths, void* out, void* acc, void* m, void* l, int B,
                            int KV, int G, int hd, int ps, int max_pages, int n_pages,
                            long long page_stride, long long pos_stride, long long head_stride,
                            int window, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAX_G || B < 1 || KV < 1 || B > 65535 || KV > 65535 || ps < 1 ||
      max_pages < 1)
    return (int)cudaErrorInvalidValue;
#define PAGED_ARGS q, kp, vp, table, lengths, out, static_cast<float*>(acc), \
                   static_cast<float*>(m), static_cast<float*>(l), B, KV, G, ps, max_pages, \
                   n_pages, page_stride, pos_stride, head_stride, window, scale, st
  if (dtype == 0 && hd == 64) launch<float, 64>(PAGED_ARGS);
  else if (dtype == 1 && hd == 64) launch<__nv_bfloat16, 64>(PAGED_ARGS);
  else if (dtype == 0 && hd == 128) launch<float, 128>(PAGED_ARGS);
  else if (dtype == 1 && hd == 128) launch<__nv_bfloat16, 128>(PAGED_ARGS);
  else if (dtype == 0 && hd == 112) launch<float, 112>(PAGED_ARGS);
  else if (dtype == 1 && hd == 112) launch<__nv_bfloat16, 112>(PAGED_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef PAGED_ARGS
  return (int)cudaGetLastError();
}

// the tile sizes the wrapper and its Python mirror (flash_attention.
// paged_split_range) assume: positions a split at hd 64, threads a split
// block, positions a split at hd 128 and at hd 112
extern "C" int paged_decode_tiles(int* split, int* threads, int* split128, int* split112) {
  *split = split_of<64>();
  *threads = THREADS;
  *split128 = split_of<128>();
  *split112 = split_of<112>();
  return 0;
}

extern "C" const char* paged_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
