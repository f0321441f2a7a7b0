// RMSNorm of the AR decoder's cached path (prefill and decode step) for
// Hopper (sm_90a):
//     out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * g,
// x and g float32 or bf16 (the same type), the sum and the products in
// float32, the output rounded once to x's type.
//
// Replaces no Pallas kernel: the JAX package computes the norm in XLA
// (`RMSNorm`, amphion_tpu/modules/llama.py:119-132). It exists so that a row's
// result does not depend on how many rows the call holds. PyTorch's
// `x.float().pow(2).mean(-1)` picks its reduction layout from the number of
// rows, and on an NVIDIA H100 row 0's mean changed its last bits between a
// decode step of 1 and one of 4 or 8 rows; a decode that batches requests
// (the window batcher, the continuous engine's rungs) then gives a request
// other tokens in other company. Here each row is one block of 256 threads
// whatever the row count: thread t sums x[k]^2 for k = t, t + 256, ... in
// order, the warps' sums meet by a fixed butterfly and then in warp order.
//
// What bounds it: the bytes, each row read twice and written once (2.5 KB
// a bf16 row of the Vevo AR), far below the card's rate; at the decode's 1-8
// rows a call is its launch and one round trip to memory, a few
// microseconds, the cost of any one of the five PyTorch kernels it replaces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ out, int D,
                float eps) {
  __shared__ float warp_sum[THREADS / 32];
  __shared__ float rinv;
  const T* xr = x + (size_t)blockIdx.x * D;
  T* o = out + (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int k = threadIdx.x; k < D; k += THREADS) {
    const float v = to_f(xr[k]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += warp_sum[w];
    rinv = 1.f / sqrtf(t / (float)D + eps);
  }
  __syncthreads();
  const float r = rinv;
  for (int k = threadIdx.x; k < D; k += THREADS) put(o + k, to_f(xr[k]) * r * to_f(g[k]));
}

}  // namespace

// x (rows, D) and out (rows, D) contiguous, g (D,), all float32 (bf16 = 0)
// or all bf16. Returns cudaGetLastError(), or cudaErrorInvalidValue for what
// the kernel does not take.
extern "C" int rms_norm(const void* x, const void* g, void* out, int rows, int D, float eps,
                        int bf16, void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    rms_norm_kernel<__nv_bfloat16><<<rows, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (__nv_bfloat16*)out, D, eps);
  else
    rms_norm_kernel<float><<<rows, THREADS, 0, st>>>((const float*)x, (const float*)g,
                                                      (float*)out, D, eps);
  return (int)cudaGetLastError();
}
