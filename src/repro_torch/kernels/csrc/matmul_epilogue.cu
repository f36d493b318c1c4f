// Batched matmul with a fused axpy epilogue for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/matmul.py:_matmul_epilogue_kernel
// (Pallas, reached through matmul_epilogue / ops.matmul, three calls per
// quintic Newton-Schulz iteration: A = X X^T, B = c A A + b A, X' = B X + a X).
//
//   C[z] = alpha * (A[z] @ B[z]) + beta * D[z]       (z over the batch)
//
// A [batch, M, K], B [batch, K, N] and D [batch, M, N] are read through
// element strides, so a transposed operand (X^T in A = X X^T, or a stack
// the caller transposed because m > n) is a view, never a copy. C is
// contiguous [batch, M, N]. Full fp32: fp32 or bf16 in, fp32 FMA on the CUDA
// cores, no TF32 (the reference's fp32 Newton-Schulz mode, ops._ns_stack).
// Every entry is one fmaf chain over k = 0 .. K-1 in order; the epilogue
// rounds as the plain version does: alpha * acc, beta * d, then their sum.
// With use_d = 0 (beta = 0 or no D) D is never read.
//
// What bounds it on this card: the fp32 products. One X X^T on the stacked
// w_in leaf ([30, 576, 1536]) is 30.6 GFLOP against 146 MB of operands, so at
// the H100's 67 TFLOP/s fp32 (non-tensor) rate the least time is ~0.46 ms,
// far above the 0.04 ms the bytes need. TF32 tensor cores would be other
// arithmetic; fp32 wgmma does not exist. So the design is about keeping the
// FMA pipes fed: few instructions other than FFMA, loads hidden under math.
//
// Design: one launch covers the whole [L, m, n] stack (the reference vmaps
// over it): grid z is the batch. A block of 256 threads computes a 96 x 96
// tile of C (96 divides 192, 576 and 1536, the leaves' widths), each thread
// a 6 x 6 register tile (rows 4 ty .. 4 ty + 3 and 64 + 2 ty, + 1; the same
// for columns), so a k step costs 36 FFMA against two 16-byte and two
// 8-byte shared loads, broadcast within a warp of 4 x 8 threads. K advances
// in steps of 16 through two shared-memory buffers, both operands stored
// k-major (a k row holds 96 m or n values): while one buffer is multiplied,
// the next K tile is fetched with 16-byte loads along each operand's
// contiguous axis. An fp32 operand whose contiguous axis is the one shared
// memory wants (A m-fast, B n-fast) is copied by cp.async straight into the
// other buffer; the other layouts (A k-fast, B k-fast, and any bf16 operand)
// are prefetched into registers and stored transposed after the multiply.
// The four layouts are template arguments, so no element branches on them.
// Operands whose strides or base do not allow 16-byte (bf16: 8-byte) loads
// take the same schedule with scalar loads. The C tile is staged in shared
// memory for the epilogue, so D is read and C written along their
// contiguous axes. Ragged edges are masked (zero fill), so any shape works.
//
// Symmetric calls (symmetric = 1: the caller promises M == N, A @ B
// symmetric and D symmetric, as for X X^T and c A A + b A with A = X X^T):
// the grid covers only the tiles (i, j) with i <= j of the upper triangle,
// numbered row by row from a linear block index (matmul.sym_tile mirrors
// the map); each block writes its tile and, through the staged tile, its
// transpose into tile (j, i); a diagonal tile writes once. An entry's mirror
// is the same products in the same k order (fmaf(a, b, c) == fmaf(b, a, c)),
// so the output equals the full computation bit for bit, with ~42% fewer
// tiles at the 576-wide leaves (45 of 81 at tiles of 64, 21 of 36 at 96).
//
// Build variants: the block tile, the K step, the thread grid and its
// register tiles, and the blocks an SM the registers are budgeted for are
// -D defines (MM_TILE, MM_BK, MM_TY, MM_TX, MM_MG, MM_MT, MM_NG, MM_NT,
// MM_MIN_BLOCKS), whose defaults below are the design above; the autotune
// candidates of kernels/matmul.py are built this way. They change the
// schedule only: every entry stays one fmaf chain over k in order, so every
// variant's output is bitwise the default's. A variant whose shared memory
// passes the 48 KB a static allocation may take asks for it dynamically and
// opts in to it in matmul_epilogue_init, which the loader calls once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MM_TILE
#define MM_TILE 96
#endif
#ifndef MM_BK
#define MM_BK 16
#endif
#ifndef MM_TY
#define MM_TY 16
#endif
#ifndef MM_TX
#define MM_TX 16
#endif
#ifndef MM_MG
#define MM_MG 1
#endif
#ifndef MM_MT
#define MM_MT 1
#endif
#ifndef MM_NG
#define MM_NG 1
#endif
#ifndef MM_NT
#define MM_NT 1
#endif
#ifndef MM_MIN_BLOCKS
#define MM_MIN_BLOCKS 2
#endif
// shared memory a block, in floats: the two staging buffers of A and B, or
// the staged C tile, whichever is larger; past 48 KB it is allocated dynamically
#define MM_STAGE_FLOATS (2 * 2 * MM_BK * (MM_TILE + 4))
#define MM_C_FLOATS (MM_TILE * (MM_TILE + 1))
#if 4 * (MM_STAGE_FLOATS > MM_C_FLOATS ? MM_STAGE_FLOATS : MM_C_FLOATS) > 48 * 1024
#define MM_DYNAMIC_SMEM 1
#else
#define MM_DYNAMIC_SMEM 0
#endif

namespace {

// block tile (square, so the triangle map holds), depth of a K step
constexpr int TILE = MM_TILE, BK = MM_BK;
// thread grid TY x TX (warps of 4 x 8 threads); a thread's rows are MG
// groups of 4 (group g: rows 4 TY g + 4 ty .. + 3) then, with MT = 1, the
// pair 4 TY MG + 2 ty, + 1; its columns likewise with NG, NT and tx
constexpr int TY = MM_TY, TX = MM_TX, MG = MM_MG, MT = MM_MT, NG = MM_NG, NT = MM_NT;
constexpr int THREADS = TY * TX;
constexpr int TM = 4 * MG + 2 * MT, TN = 4 * NG + 2 * NT;
static_assert(TY * TM == TILE && TX * TN == TILE, "thread tiles must cover the block tile");
static_assert(TY % 4 == 0 && TX % 8 == 0, "warps of 4 x 8 threads");
constexpr int LD = TILE + 4;   // k-major staging rows of 100 floats: 16-byte aligned
constexpr int LDC = TILE + 1;  // the staged C tile: its column walks are conflict-free
constexpr int CHUNKS = TILE * BK / 4;                          // 4-element chunks a tile
constexpr int CHUNK_ITERS = (CHUNKS + THREADS - 1) / THREADS;  // per thread
constexpr int STAGE_FLOATS = 2 * 2 * BK * LD;                  // A and B, two buffers
constexpr int SMEM_FLOATS = STAGE_FLOATS > TILE * LDC ? STAGE_FLOATS : TILE * LDC;
static_assert(MT <= 1 && NT <= 1 && BK % 4 == 0 && TILE % 4 == 0, "fragment and chunk layouts");
static_assert(SMEM_FLOATS == (MM_STAGE_FLOATS > MM_C_FLOATS ? MM_STAGE_FLOATS : MM_C_FLOATS),
              "the preprocessor's shared-memory size");
// bytes of dynamic shared memory a launch asks for (0: the static array)
constexpr size_t DYNAMIC_SMEM_BYTES = MM_DYNAMIC_SMEM ? SMEM_FLOATS * sizeof(float) : 0;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 4 consecutive elements as one 16-byte (fp32) or 8-byte (bf16) load
__device__ __forceinline__ void load4(const float* p, float (&r)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&r)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  r[0] = __low2float(lo); r[1] = __high2float(lo); r[2] = __low2float(hi); r[3] = __high2float(hi);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the first `bytes` are read, the rest zero-filled
__device__ __forceinline__ void cp_async_16(float* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The chunk c of an operand tile [TILE (t: the m or n index) x BK (k)] that
// thread tid owns: 4 elements along the operand's contiguous axis, k for a
// k-fast operand, else t. Returns false past the tile's chunks.
template <bool KFAST>
__device__ __forceinline__ bool chunk_at(int tid, int c, int& t, int& k) {
  const int e = tid + c * THREADS;
  if constexpr (KFAST) { t = e / (BK / 4); k = (e % (BK / 4)) * 4; }
  else { k = e / (TILE / 4); t = (e % (TILE / 4)) * 4; }
  return CHUNKS % THREADS == 0 || e < CHUNKS;
}

// Global -> registers: the thread's chunks of the operand tile at (t0, k0);
// g points at the operand's batch entry, st / sk are its strides along t / k,
// tlim / klim its extents. Elements past an edge are 0. VEC: one vector load
// per chunk that lies inside the operand (its alignment checked by the host).
template <typename T, bool KFAST, bool VEC>
__device__ __forceinline__ void fetch(float (&r)[CHUNK_ITERS][4], const T* __restrict__ g,
                                      long long st, long long sk, int t0, int k0, int tlim,
                                      int klim, int tid) {
#pragma unroll
  for (int c = 0; c < CHUNK_ITERS; ++c) {
    int t, k;
    if (!chunk_at<KFAST>(tid, c, t, k)) break;
    const int gt = t0 + t, gk = k0 + k;
    const bool line = KFAST ? gt < tlim : gk < klim;  // the chunk's row exists
    const int f = KFAST ? gk : gt, flim = KFAST ? klim : tlim;
    const long long step = KFAST ? sk : st;
    if (VEC && line && f + 3 < flim) {
      load4(g + gt * st + gk * sk, r[c]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[c][j] = line && f + j < flim ? to_f(g[gt * st + gk * sk + j * step]) : 0.f;
    }
  }
}

// registers -> the k-major staging buffer s[BK][LD]
template <bool KFAST>
__device__ __forceinline__ void stash(float* s, const float (&r)[CHUNK_ITERS][4], int tid) {
#pragma unroll
  for (int c = 0; c < CHUNK_ITERS; ++c) {
    int t, k;
    if (!chunk_at<KFAST>(tid, c, t, k)) break;
    if constexpr (KFAST) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[(k + j) * LD + t] = r[c][j];
    } else {
      *reinterpret_cast<float4*>(&s[k * LD + t]) = make_float4(r[c][0], r[c][1], r[c][2], r[c][3]);
    }
  }
}

// fp32, t-fast, vector-aligned operand: cp.async straight into s[BK][LD]
__device__ __forceinline__ void fetch_async(float* s, const float* __restrict__ g, long long sk,
                                            int t0, int k0, int tlim, int klim, int tid) {
#pragma unroll
  for (int c = 0; c < CHUNK_ITERS; ++c) {
    int t, k;
    if (!chunk_at<false>(tid, c, t, k)) break;
    const int gt = t0 + t, gk = k0 + k;
    const int n = gk < klim ? min(max(tlim - gt, 0), 4) : 0;
    cp_async_16(&s[k * LD + t], n ? g + gt + gk * sk : g, 4 * n);
  }
}

// the thread's TM (or TN) values of one k row of a staging buffer
template <int G, int TAIL, int TT>
__device__ __forceinline__ void fragment(const float* row, int t, float* v) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(&row[4 * TT * g + 4 * t]);
    v[4 * g] = x.x; v[4 * g + 1] = x.y; v[4 * g + 2] = x.z; v[4 * g + 3] = x.w;
  }
  if constexpr (TAIL) {
    const float2 x = *reinterpret_cast<const float2*>(&row[4 * TT * G + 2 * t]);
    v[4 * G] = x.x; v[4 * G + 1] = x.y;
  }
}

// the tile-local index of a thread's i-th row (or column)
template <int G, int TT>
__device__ __forceinline__ int frag_index(int i, int t) {
  return i < 4 * G ? 4 * TT * (i / 4) + 4 * t + i % 4 : 4 * TT * G + 2 * t + (i - 4 * G);
}

template <typename T, bool A_KFAST, bool B_NFAST, bool VEC>
__global__ void __launch_bounds__(THREADS, MM_MIN_BLOCKS) matmul_epilogue_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ D, T* __restrict__ C,
    int M, int N, int K, long long sAb, long long sAm, long long sAk, long long sBb,
    long long sBk, long long sBn, long long sDb, long long sDm, long long sDn, float alpha,
    float beta, int use_d, int symmetric) {
  constexpr bool ASYNC_A = VEC && !A_KFAST && sizeof(T) == 4;
  constexpr bool ASYNC_B = VEC && B_NFAST && sizeof(T) == 4;
#if MM_DYNAMIC_SMEM
  extern __shared__ __align__(16) float smem[];  // SMEM_FLOATS
#else
  __shared__ __align__(16) float smem[SMEM_FLOATS];
#endif
  float* As = smem;                // [2][BK][LD]
  float* Bs = smem + 2 * BK * LD;  // [2][BK][LD]

  int bi, bj;  // the tile's block row (m) and block column (n)
  if (symmetric) {
    const int nt = (M + TILE - 1) / TILE;
    int t = blockIdx.x, i = 0;
    while (t >= nt - i) { t -= nt - i; ++i; }
    bi = i;
    bj = i + t;
  } else {
    bi = blockIdx.y;
    bj = blockIdx.x;
  }
  const int m0 = bi * TILE, n0 = bj * TILE;
  const int z = blockIdx.z;
  A += z * sAb;
  B += z * sBb;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / (TX / 8)) * 4 + lane / 8, tx = (warp % (TX / 8)) * 8 + lane % 8;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // A's tile is indexed (t = m, k), B's (t = n, k). Step kt fetches K tile kt
  // into buffer kt & 1 while it multiplies tile kt - 1 from the other buffer,
  // which the sync that ended step kt - 1 made whole; that sync also freed
  // buffer kt & 1 (read by step kt - 1's multiply of tile kt - 2).
  float ra[CHUNK_ITERS][4], rb[CHUNK_ITERS][4];
  const int nk = (K + BK - 1) / BK;
  for (int kt = 0; kt <= nk; ++kt) {
    float* as_next = As + (kt & 1) * BK * LD;
    float* bs_next = Bs + (kt & 1) * BK * LD;
    if (kt < nk) {
      const int k0 = kt * BK;
      if constexpr (ASYNC_A)
        fetch_async(as_next, reinterpret_cast<const float*>(A), sAk, m0, k0, M, K, tid);
      else
        fetch<T, A_KFAST, VEC>(ra, A, sAm, sAk, m0, k0, M, K, tid);
      if constexpr (ASYNC_B)
        fetch_async(bs_next, reinterpret_cast<const float*>(B), sBk, n0, k0, N, K, tid);
      else
        fetch<T, !B_NFAST, VEC>(rb, B, sBn, sBk, n0, k0, N, K, tid);
      if constexpr (ASYNC_A || ASYNC_B) cp_async_commit();
    }
    if (kt > 0) {
      const float* as = As + ((kt - 1) & 1) * BK * LD;
      const float* bs = Bs + ((kt - 1) & 1) * BK * LD;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
        fragment<MG, MT, TY>(as + kk * LD, ty, a);
        fragment<NG, NT, TX>(bs + kk * LD, tx, b);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (kt < nk) {
      if constexpr (!ASYNC_A) stash<A_KFAST>(as_next, ra, tid);
      if constexpr (!ASYNC_B) stash<!B_NFAST>(bs_next, rb, tid);
      if constexpr (ASYNC_A || ASYNC_B) cp_async_wait_all();
    }
    __syncthreads();
  }

  // epilogue through the staged tile Cs[TILE][LDC] (the staging buffers are free)
  float* Cs = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      Cs[frag_index<MG, TY>(i, ty) * LDC + frag_index<NG, TX>(j, tx)] = __fmul_rn(alpha, acc[i][j]);
  __syncthreads();
  const int mlim = min(TILE, M - m0), nlim = min(TILE, N - n0);
  if (use_d) {  // + beta * d, walking D along its contiguous axis
    const T* Dz = D + z * sDb;
    const bool d_nfast = sDn == 1 || sDm != 1;
    for (int e = tid; e < TILE * TILE; e += THREADS) {
      const int m = d_nfast ? e / TILE : e % TILE, n = d_nfast ? e % TILE : e / TILE;
      if (m < mlim && n < nlim) {
        float& o = Cs[m * LDC + n];
        o = __fadd_rn(o, __fmul_rn(beta, to_f(Dz[(m0 + m) * sDm + (n0 + n) * sDn])));
      }
    }
    __syncthreads();
  }
  T* Cz = C + (long long)z * M * N;
  for (int e = tid; e < TILE * TILE; e += THREADS) {  // C's rows, n fastest
    const int m = e / TILE, n = e % TILE;
    if (m < mlim && n < nlim) Cz[(long long)(m0 + m) * N + n0 + n] = from_f<T>(Cs[m * LDC + n]);
  }
  if (symmetric && bi != bj) {  // the transpose into tile (j, i), m fastest
    for (int e = tid; e < TILE * TILE; e += THREADS) {
      const int n = e / TILE, m = e % TILE;
      if (m < mlim && n < nlim) Cz[(long long)(n0 + n) * N + m0 + m] = from_f<T>(Cs[m * LDC + n]);
    }
  }
}

template <typename T, bool A_KFAST, bool B_NFAST, bool VEC>
void launch(dim3 grid, cudaStream_t st, const void* a, const void* b, const void* d, void* c,
            int M, int N, int K, long long sAb, long long sAm, long long sAk, long long sBb,
            long long sBk, long long sBn, long long sDb, long long sDm, long long sDn,
            float alpha, float beta, int use_d, int symmetric) {
  matmul_epilogue_kernel<T, A_KFAST, B_NFAST, VEC><<<grid, THREADS, DYNAMIC_SMEM_BYTES, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(d),
      static_cast<T*>(c), M, N, K, sAb, sAm, sAk, sBb, sBk, sBn, sDb, sDm, sDn, alpha, beta,
      use_d, symmetric);
}

template <typename T>
void dispatch(bool a_kfast, bool b_nfast, bool vec, dim3 grid, cudaStream_t st, const void* a,
              const void* b, const void* d, void* c, int M, int N, int K, long long sAb,
              long long sAm, long long sAk, long long sBb, long long sBk, long long sBn,
              long long sDb, long long sDm, long long sDn, float alpha, float beta, int use_d,
              int symmetric) {
#define MM_ARGS grid, st, a, b, d, c, M, N, K, sAb, sAm, sAk, sBb, sBk, sBn, sDb, sDm, sDn, \
                alpha, beta, use_d, symmetric
  if (vec) {
    if (a_kfast && b_nfast) launch<T, true, true, true>(MM_ARGS);
    else if (a_kfast) launch<T, true, false, true>(MM_ARGS);
    else if (b_nfast) launch<T, false, true, true>(MM_ARGS);
    else launch<T, false, false, true>(MM_ARGS);
  } else {
    if (a_kfast && b_nfast) launch<T, true, true, false>(MM_ARGS);
    else if (a_kfast) launch<T, true, false, false>(MM_ARGS);
    else if (b_nfast) launch<T, false, true, false>(MM_ARGS);
    else launch<T, false, false, false>(MM_ARGS);
  }
#undef MM_ARGS
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// the dynamic shared-memory opt-in of every instantiation (on the current device)
template <typename T>
cudaError_t opt_in() {
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int bytes = (int)DYNAMIC_SMEM_BYTES;
  const void* fns[] = {(const void*)matmul_epilogue_kernel<T, true, true, true>,
                       (const void*)matmul_epilogue_kernel<T, true, false, true>,
                       (const void*)matmul_epilogue_kernel<T, false, true, true>,
                       (const void*)matmul_epilogue_kernel<T, false, false, true>,
                       (const void*)matmul_epilogue_kernel<T, true, true, false>,
                       (const void*)matmul_epilogue_kernel<T, true, false, false>,
                       (const void*)matmul_epilogue_kernel<T, false, true, false>,
                       (const void*)matmul_epilogue_kernel<T, false, false, false>};
  for (const void* fn : fns) {
    const cudaError_t e = cudaFuncSetAttribute(fn, attr, bytes);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// One-time set-up before the first launch: a variant with dynamic shared
// memory opts every kernel in to it; the others need nothing.
extern "C" int matmul_epilogue_init() {
  if (!MM_DYNAMIC_SMEM) return 0;
  const cudaError_t e = opt_in<float>();
  return (int)(e != cudaSuccess ? e : opt_in<__nv_bfloat16>());
}

// strides are in elements; dtype: 0 = float32, 1 = bfloat16 (A, B, D and C
// share it). symmetric = 1 computes the upper triangle of tiles and mirrors
// it (M == N required; the caller promises A @ B and D symmetric). Returns
// cudaGetLastError() after the launch.
extern "C" int matmul_epilogue(const void* a, const void* b, const void* d, void* c, int batch,
                               int M, int N, int K, long long sAb, long long sAm, long long sAk,
                               long long sBb, long long sBk, long long sBn, long long sDb,
                               long long sDm, long long sDn, float alpha, float beta, int use_d,
                               int symmetric, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || N < 1 || K < 1 || (symmetric && M != N))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // A is m-fast only when its m stride is 1 (and k's is not); B k-fast likewise
  const bool a_kfast = !(sAm == 1 && sAk != 1), b_nfast = !(sBk == 1 && sBn != 1);
  // 4-element loads along each operand's contiguous axis: that stride is 1,
  // the others and the base keep every chunk on a 4-element boundary
  const int vb = dtype == 0 ? 16 : 8;
  const bool vec = (a_kfast ? sAk == 1 && sAm % 4 == 0 : sAk % 4 == 0) && sAb % 4 == 0 &&
                   (b_nfast ? sBn == 1 && sBk % 4 == 0 : sBn % 4 == 0) && sBb % 4 == 0 &&
                   aligned(a, vb) && aligned(b, vb);
  const int nt = (M + TILE - 1) / TILE;
  const dim3 grid = symmetric ? dim3(nt * (nt + 1) / 2, 1, batch)
                              : dim3((N + TILE - 1) / TILE, nt, batch);
  if (dtype == 0)
    dispatch<float>(a_kfast, b_nfast, vec, grid, st, a, b, d, c, M, N, K, sAb, sAm, sAk, sBb,
                    sBk, sBn, sDb, sDm, sDn, alpha, beta, use_d, symmetric);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(a_kfast, b_nfast, vec, grid, st, a, b, d, c, M, N, K, sAb, sAm, sAk,
                            sBb, sBk, sBn, sDb, sDm, sDn, alpha, beta, use_d, symmetric);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// the tile sizes the Python mirror (matmul.sym_tile) and the wrapper assume:
// block tile rows, block tile columns, K step, threads a block
extern "C" int matmul_epilogue_tiles(int* tile_m, int* tile_n, int* bk, int* threads) {
  *tile_m = TILE;
  *tile_n = TILE;
  *bk = BK;
  *threads = THREADS;
  return 0;
}

extern "C" const char* matmul_epilogue_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
