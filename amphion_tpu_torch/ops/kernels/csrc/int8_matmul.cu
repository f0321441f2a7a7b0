// Weight-only int8 matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_int8_matmul_kernel` / `int8_matmul_pallas`
// (amphion_tpu/ops/pallas_kernels.py:459-526):
//     out (M, N) = (bf16(x) (M, K) @ w_q^T) * scale,
// w_q (N, K) int8 row-major (the transpose of the JAX kernel_q), scale (N,)
// float32 applied once after the full float32 K sum, as the TPU kernel does
// at its last K step. x is float32 or bf16 and is rounded to bf16 here; the
// output is float32 or bf16.
//
// What bounds it on the H100, and the two paths:
//  * GEMV, M <= 8 (one decode step of a batch of requests): every weight byte
//    is used M times, far below the 295 operations per byte where the tensor
//    cores would matter, so it is bound by the weight bytes over 3.35 TB/s
//    (22 MB per Vevo AR layer in int8). The products still run on the tensor
//    cores: the weights are the A operand (16 output columns per m16n8k16
//    product) and x the B operand (its M <= 8 rows are the n8 side), so the
//    work per weight byte, an int8 -> bf16 conversion by byte permutation and
//    a share of one product, does not grow with M. The kernel is the shared
//    GEMV of quant_common.cuh with this file's format (`Int8`): 64-wide
//    chunks, two per warp in flight, a cluster of up to 4 blocks splitting K
//    where N is narrow (o, down), the column scale applied once to the
//    cluster's sum. On an NVIDIA H100 80GB HBM3 at 700 W, one Vevo AR decode
//    step (96 projections at M = 4) takes about 0.48 ms against the first
//    version's 0.59 ms and a byte bound of 0.161 ms (tools/quant_ab.py;
//    PERF.md has each projection's time).
//  * GEMM, larger M (prefill, the flow-matching estimator at M = B * L): at
//    thousands of rows it is bound by the tensor cores' bf16 rate. A block of
//    8 warps owns a 128 x 128 tile; each 32-wide K step stages bf16(x) and the
//    weight tile converted int8 -> bf16 in shared memory, and mma.sync
//    m16n8k16 accumulates in float32 (quant_common.cuh); the next step's
//    loads go to registers while the current step computes. Still simple: no
//    cp.async, no TMA, no wgmma, which is where a faster version goes next.

#include "quant_common.cuh"

namespace {

using namespace quant;

__device__ __forceinline__ float i8(uint32_t w, int j) {
  return (float)(int8_t)((w >> (8 * j)) & 0xFF);
}

// Four int8 (one 32-bit word) → bf16 pairs {byte 0, byte 1}, {byte 2, byte 3},
// exactly: each byte, offset to unsigned, becomes the low mantissa bits of
// the float 2^23 + u, from which 2^23 + 128 is subtracted; the difference,
// an integer of at most 7 bits, is its float's upper half, so two are
// paired by one byte permutation (no float -> bf16 conversion).
__device__ __forceinline__ uint32_t hi_halves(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float off = 8388736.f;  // 2^23 + 128
  lo = hi_halves(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - off,
                 __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - off);
  hi = hi_halves(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - off,
                 __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - off);
}

// The GEMV's int8 format. Lane (g, t) converts 16 consecutive bytes of weight
// rows g and g + 8 at k = 16t of each 64-wide chunk, and takes the same 16
// columns of x row g (two slots, in order); the chunk's four k16 products
// take bytes 4s .. 4s+3 (step s), a permutation of k that the A (weights)
// and B (x) fragments share, so the sum is the same.
struct Int8 {
  static constexpr int CH = 64, NI = 2;
  static constexpr bool GROUPED = false;
  static constexpr bool PROLOGUE = false;  // takes an RMSNorm gain

  __device__ static uint4 pack_x(const float (&v)[8]) {
    return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                      pack_bf16(v[6], v[7]));
  }
  __device__ static uint4 pair_bf16(const uint4& r) { return r; }  // 8 bf16 x, in order

  __device__ static void chunk(float (&acc)[4], const uint4& wa, const uint4& wb,
                               const uint4 (&xv)[NI], float, float) {
    const uint32_t ra[4] = {wa.x, wa.y, wa.z, wa.w}, rb[4] = {wb.x, wb.y, wb.z, wb.w};
    const uint32_t xb[8] = {xv[0].x, xv[0].y, xv[0].z, xv[0].w,
                            xv[1].x, xv[1].y, xv[1].z, xv[1].w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t a[4];
      i8x4_to_bf16(ra[s], a[0], a[2]);
      i8x4_to_bf16(rb[s], a[1], a[3]);
      mma_bf16(acc, a, xb[2 * s], xb[2 * s + 1]);
    }
  }
};

constexpr int BN8 = 128;

template <typename TX, typename TO>
__global__ void __launch_bounds__(GEMM_THREADS)
int8_gemm(const TX* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ scale, TO* __restrict__ out, int M, int N,
          int K) {
  constexpr int WN = BN8 / 2;
  __shared__ __align__(16) __nv_bfloat16 As[BM * AP];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN8 * AP];
  const int m0 = (int)blockIdx.y * BM, n0 = (int)blockIdx.x * BN8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  float acc[2][WN / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // weight staging: thread -> row r, 16 consecutive k at c
  const int r = threadIdx.x >> 1, c = (threadIdx.x & 1) * 16;
  float av[16];
  uint4 wv = make_uint4(0u, 0u, 0u, 0u);
  auto load_w = [&](int k0) {
    wv = n0 + r < N ? *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * K + k0 + c)
                    : make_uint4(0u, 0u, 0u, 0u);
  };
  load_a(av, x, M, K, m0, 0);
  load_w(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // every warp is done with the previous step's tiles
    store_a(As, av, k0, nullptr, nullptr);
    const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
    uint32_t packed[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      packed[j] = pack_bf16(i8(ww[j >> 1], (2 * j) & 3), i8(ww[j >> 1], (2 * j + 1) & 3));
    uint4* dst = reinterpret_cast<uint4*>(Bs + r * AP + c);
    dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    __syncthreads();
    if (k0 + BK < K) {  // the next step's loads fly during these products
      load_a(av, x, M, K, m0, k0 + BK);
      load_w(k0 + BK);
    }
    mma_tile<WN>(acc, As, Bs, wm, wn);
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int col = n0 + wn * WN + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (row >= M) continue;
        if (col < N) store_out(out, (size_t)row * N + col, acc[i][j][2 * h] * scale[col]);
        if (col + 1 < N)
          store_out(out, (size_t)row * N + col + 1, acc[i][j][2 * h + 1] * scale[col + 1]);
      }
    }
  }
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const int8_t* w, const float* scale, void* out, int M,
                   int N, int K, cudaStream_t st) {
  if (M <= GEMV_MAX_M)
    return gemv_launch<Int8, TX, TO>((const TX*)x, (const uint8_t*)w, scale, nullptr,
                                     (TO*)out, M, N, K, 0.f, st);
  dim3 grid((N + BN8 - 1) / BN8, (M + BM - 1) / BM);
  int8_gemm<TX, TO><<<grid, GEMM_THREADS, 0, st>>>((const TX*)x, w, scale, (TO*)out, M, N,
                                                    K);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) f32 (x_bf16 = 0) or bf16; w (N, K) int8; scale (N,) f32; out
// (M, N) f32 (out_bf16 = 0) or bf16; all contiguous; K % 64 == 0.
// Returns cudaGetLastError().
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* out,
                           int M, int N, int K, int x_bf16, int out_bf16,
                           void* stream) {
  if (K % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* wq = (const int8_t*)w;
  const float* s = (const float*)scale;
  cudaError_t err;
  if (x_bf16 && out_bf16) err = launch<__nv_bfloat16, __nv_bfloat16>(x, wq, s, out, M, N, K, st);
  else if (x_bf16) err = launch<__nv_bfloat16, float>(x, wq, s, out, M, N, K, st);
  else if (out_bf16) err = launch<float, __nv_bfloat16>(x, wq, s, out, M, N, K, st);
  else err = launch<float, float>(x, wq, s, out, M, N, K, st);
  const cudaError_t last = cudaGetLastError();  // also clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}
