// Fused outer Nesterov update (paper Eq. 3) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/outer_update.py:_nesterov_kernel
// (Pallas, reached through fused_nesterov_update / ops.nesterov_update):
//
//   u'     = mu * u + eta * psi
//   theta' = theta - mu * u' - eta * psi
//
// over flat arrays: theta (fp32 or bf16) and psi, u (fp32) in; theta' in
// theta's dtype and u' (fp32) out, in one elementwise pass.
//
// What bounds it on this card: bytes. Five fp32 streams (three read, two
// written) over the 134,515,008 parameters of smollm-135m are 2.69 GB, 0.80
// ms at 3.35 TB/s; the 7 flops per element are nothing beside that.
//
// Design: a grid-stride loop with 16-byte (float4) loads and stores when
// every pointer is 16-byte aligned (the wrapper checks), scalar otherwise
// and for the tail. The arithmetic is spelled with __fmul_rn / __fadd_rn /
// __fsub_rn in the order of the plain PyTorch version (each product and sum
// rounded on its own, no FMA contraction), so the kernel is bitwise equal to
// it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// returns theta', writes u'
__device__ __forceinline__ float nesterov_elem(float theta, float psi, float u, float lr,
                                               float mu, float* u_new) {
  const float lp = __fmul_rn(lr, psi);
  const float un = __fadd_rn(__fmul_rn(mu, u), lp);
  *u_new = un;
  return __fsub_rn(__fsub_rn(theta, __fmul_rn(mu, un)), lp);
}

__global__ void nesterov_vec4_kernel(const float4* __restrict__ theta,
                                     const float4* __restrict__ psi,
                                     const float4* __restrict__ u, float4* __restrict__ theta_out,
                                     float4* __restrict__ u_out, long long n4, float lr,
                                     float mu) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float4 t = theta[i], p = psi[i], uu = u[i];
    float4 t2, u2;
    t2.x = nesterov_elem(t.x, p.x, uu.x, lr, mu, &u2.x);
    t2.y = nesterov_elem(t.y, p.y, uu.y, lr, mu, &u2.y);
    t2.z = nesterov_elem(t.z, p.z, uu.z, lr, mu, &u2.z);
    t2.w = nesterov_elem(t.w, p.w, uu.w, lr, mu, &u2.w);
    theta_out[i] = t2;
    u_out[i] = u2;
  }
}

template <typename T>
__global__ void nesterov_scalar_kernel(const T* __restrict__ theta, const float* __restrict__ psi,
                                       const float* __restrict__ u, T* __restrict__ theta_out,
                                       float* __restrict__ u_out, long long start, long long n,
                                       float lr, float mu) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float un;
    theta_out[i] = from_f<T>(nesterov_elem(to_f(theta[i]), psi[i], u[i], lr, mu, &un));
    u_out[i] = un;
  }
}

int grid_for(long long work, int threads) {
  const long long blocks = (work + threads - 1) / threads;
  return (int)(blocks < 132LL * 32 ? (blocks > 0 ? blocks : 1) : 132LL * 32);
}

}  // namespace

// dtype of theta: 0 = float32, 1 = bfloat16; vec4 = 1 when every pointer is
// 16-byte aligned (fp32 only). Returns cudaGetLastError() after the launches.
extern "C" int nesterov(const void* theta, const void* psi, const void* u, void* theta_out,
                        void* u_out, long long n, float lr, float momentum, int dtype, int vec4,
                        void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  long long done = 0;
  if (dtype == 0 && vec4) {
    const long long n4 = n / 4;
    if (n4 > 0)
      nesterov_vec4_kernel<<<grid_for(n4, threads), threads, 0, st>>>(
          static_cast<const float4*>(theta), static_cast<const float4*>(psi),
          static_cast<const float4*>(u), static_cast<float4*>(theta_out),
          static_cast<float4*>(u_out), n4, lr, momentum);
    done = n4 * 4;
  }
  if (done < n) {
    const float* p = static_cast<const float*>(psi);
    const float* uu = static_cast<const float*>(u);
    float* u2 = static_cast<float*>(u_out);
    if (dtype == 0)
      nesterov_scalar_kernel<float><<<grid_for(n - done, threads), threads, 0, st>>>(
          static_cast<const float*>(theta), p, uu, static_cast<float*>(theta_out), u2, done, n, lr,
          momentum);
    else if (dtype == 1)
      nesterov_scalar_kernel<__nv_bfloat16><<<grid_for(n - done, threads), threads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(theta), p, uu,
          static_cast<__nv_bfloat16*>(theta_out), u2, done, n, lr, momentum);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* outer_update_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
