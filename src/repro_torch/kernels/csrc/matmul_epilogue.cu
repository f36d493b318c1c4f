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
// With use_d = 0 (beta = 0 or no D) D is never read.
//
// What bounds it on this card: the fp32 products. One X X^T on the stacked
// w_in leaf ([30, 576, 1536]) is 30.6 GFLOP against 146 MB of operands, so at
// the H100's 67 TFLOP/s fp32 (non-tensor) rate the least time is ~0.46 ms,
// far above the 0.04 ms the bytes need. TF32 tensor cores would be other
// arithmetic; fp32 wgmma does not exist.
//
// Design: one launch covers the whole [L, m, n] stack (the reference vmaps
// over it): grid z is the batch. Each block computes a BM x BN tile of C
// with 64 threads, each holding a TM x TN register tile; K advances in BK
// steps through shared memory (A stored k-major so a thread reads its TM
// rows as float4). Tile loads walk the operand's contiguous dimension
// first, whichever it is. Ragged edges are masked (zero fill), so any
// shape works without padding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 8, TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 64
constexpr int PAD = 4;                          // keeps float4 rows 16-byte aligned

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) matmul_epilogue_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ D, T* __restrict__ C,
    int M, int N, int K, long long sAb, long long sAm, long long sAk, long long sBb,
    long long sBk, long long sBn, long long sDb, long long sDm, long long sDn, float alpha,
    float beta, int use_d) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int z = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  A += z * sAb;
  B += z * sBb;
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  const bool a_kfast = sAk == 1;  // rows of A contiguous: walk k first
  const bool b_nfast = sBn == 1;  // rows of B contiguous: walk n first

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int i = a_kfast ? e / BK : e % BM;
      const int kk = a_kfast ? e % BK : e / BM;
      const int gi = m0 + i, gk = k0 + kk;
      As[kk][i] = (gi < M && gk < K) ? to_f(A[gi * sAm + gk * sAk]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int j = b_nfast ? e % BN : e / BK;
      const int kk = b_nfast ? e / BN : e % BK;
      const int gj = n0 + j, gk = k0 + kk;
      Bs[kk][j] = (gj < N && gk < K) ? to_f(B[gk * sBk + gj * sBn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&As[kk][ty * TM + i]);
        a[i] = x.x; a[i + 1] = x.y; a[i + 2] = x.z; a[i + 3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + j]);
        b[j] = x.x; b[j + 1] = x.y; b[j + 2] = x.z; b[j + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const T* Dz = use_d ? D + z * sDb : nullptr;
  T* Cz = C + (long long)z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = m0 + ty * TM + i;
    if (gi >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = n0 + tx * TN + j;
      if (gj >= N) break;
      float o = alpha * acc[i][j];
      if (use_d) o = o + beta * to_f(Dz[gi * sDm + gj * sDn]);
      Cz[(long long)gi * N + gj] = from_f<T>(o);
    }
  }
}

}  // namespace

// strides are in elements; dtype: 0 = float32, 1 = bfloat16 (A, B, D and C
// share it). Returns cudaGetLastError() after the launch.
extern "C" int matmul_epilogue(const void* a, const void* b, const void* d, void* c, int batch,
                               int M, int N, int K, long long sAb, long long sAm, long long sAk,
                               long long sBb, long long sBk, long long sBn, long long sDb,
                               long long sDm, long long sDn, float alpha, float beta, int use_d,
                               int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch), block(THREADS);
  if (dtype == 0)
    matmul_epilogue_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(d),
        static_cast<float*>(c), M, N, K, sAb, sAm, sAk, sBb, sBk, sBn, sDb, sDm, sDn, alpha, beta,
        use_d);
  else if (dtype == 1)
    matmul_epilogue_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(d), static_cast<__nv_bfloat16*>(c), M, N, K, sAb, sAm,
        sAk, sBb, sBk, sBn, sDb, sDm, sDn, alpha, beta, use_d);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* matmul_epilogue_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
