// Snake activation forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas kernels `_snake_fwd_kernel` / `_snake_bwd_kernel`
// behind `snake_pallas` (amphion_tpu/ops/pallas_kernels.py:40-117):
//   forward   y  = x + sin^2(a x) / (a + 1e-9)
//   backward  dx = g (1 + sin(2 a x))
//             da = sum over (B, T) of g (x sin(2 a x) / (a + 1e-9)
//                                        - sin^2(a x) / (a + 1e-9)^2)
// on x (B, T, C) with channels last, a (C,) float32, x and g in float32 or
// bf16, arithmetic in float32. The JAX package sums da with a jnp reduction
// outside its kernel; here it is fused into the backward.
//
// What bounds it on the H100: memory. The forward moves 8 bytes per element
// (f32 in and out) for a handful of operations and one sine, the backward
// 12; both are far below the card's ratio of operations to bytes.
//
// What the design does about it:
//  * the forward is one elementwise pass, a thread per element, so
//    neighbouring threads read neighbouring addresses;
//  * the backward block is 32 channels x 8 row lanes over a run of
//    ROWS_PER_BLOCK rows: each thread writes dx for its elements and keeps
//    its channel's da sum in a register, the 8 lanes are summed in shared
//    memory in a fixed order, and the block writes one partial row
//    (blocks, C). A second pass sums each channel's partials in block order.
//    No atomics: da is bit-equal from launch to launch.
//  * sinf as the compiler gives it without fast math: a * x reaches the
//    range where __sinf's error grows, and the plain versions use torch.sin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 8;             // row lanes of a backward block
constexpr int CH = 32;               // channels of a backward block
constexpr int ROWS_PER_BLOCK = 256;  // rows a backward block sums

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void snake_fwd_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                                 T* __restrict__ out, size_t n, int C) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const float a = alpha[i % C];
    const float v = load(x, i);
    const float s = sinf(a * v);
    store(out, i, v + s * s / (a + 1e-9f));
  }
}

template <typename T>
__global__ void __launch_bounds__(LANES * CH)
snake_bwd_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ partial, int rows, int C) {
  __shared__ float red[LANES][CH];
  const int c = blockIdx.y * CH + threadIdx.x;
  const int r0 = blockIdx.x * ROWS_PER_BLOCK;
  const int r1 = min(rows, r0 + ROWS_PER_BLOCK);
  float acc = 0.f;
  if (c < C) {
    const float a = alpha[c];
    const float ae = a + 1e-9f;
    const float ae2 = ae * ae;
    for (int r = r0 + threadIdx.y; r < r1; r += LANES) {
      const size_t i = (size_t)r * C + c;
      const float v = load(x, i);
      const float gv = load(g, i);
      const float s2 = sinf(2.f * a * v);
      store(dx, i, gv * (1.f + s2));
      const float s = sinf(a * v);
      acc += gv * (v * s2 / ae - s * s / ae2);
    }
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float sum = red[0][threadIdx.x];
#pragma unroll
    for (int l = 1; l < LANES; ++l) sum += red[l][threadIdx.x];
    partial[(size_t)blockIdx.x * C + c] = sum;
  }
}

__global__ void snake_dalpha_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dalpha, int nblocks, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sum = 0.f;
  for (int b = 0; b < nblocks; ++b) sum += partial[(size_t)b * C + c];
  dalpha[c] = sum;
}

}  // namespace

extern "C" int snake_fwd(const void* x, const void* alpha, void* out, int rows, int C,
                         int is_bf16, void* stream) {
  const size_t n = (size_t)rows * C;
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 65536 ? want : 65536);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    snake_fwd_kernel<<<blocks, threads, 0, s>>>((const __nv_bfloat16*)x, (const float*)alpha,
                                                (__nv_bfloat16*)out, n, C);
  else
    snake_fwd_kernel<<<blocks, threads, 0, s>>>((const float*)x, (const float*)alpha,
                                                (float*)out, n, C);
  return (int)cudaGetLastError();
}

// partial: (ceil(rows / ROWS_PER_BLOCK), C) float32 scratch; dalpha: (C,) float32.
extern "C" int snake_bwd(const void* x, const void* alpha, const void* g, void* dx,
                         void* partial, void* dalpha, int rows, int C, int is_bf16,
                         void* stream) {
  const int nblocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  dim3 grid(nblocks, (C + CH - 1) / CH);
  dim3 block(CH, LANES);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    snake_bwd_kernel<<<grid, block, 0, s>>>((const __nv_bfloat16*)x, (const float*)alpha,
                                            (const __nv_bfloat16*)g, (__nv_bfloat16*)dx,
                                            (float*)partial, rows, C);
  else
    snake_bwd_kernel<<<grid, block, 0, s>>>((const float*)x, (const float*)alpha,
                                            (const float*)g, (float*)dx, (float*)partial,
                                            rows, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  snake_dalpha_kernel<<<(C + 127) / 128, 128, 0, s>>>((const float*)partial, (float*)dalpha,
                                                      nblocks, C);
  return (int)cudaGetLastError();
}

extern "C" int snake_rows_per_block() { return ROWS_PER_BLOCK; }
