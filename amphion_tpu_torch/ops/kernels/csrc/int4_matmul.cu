// Weight-only int4 matmul with an optional RMSNorm prologue, for Hopper (sm_90a).
//
// Replaces the Pallas kernels `_int4_matmul_kernel` and
// `_int4_matmul_rms_kernel` / `int4_matmul_pallas`
// (amphion_tpu/ops/pallas_kernels.py:560-694):
//     out[m, n] = sum_g (sum_{k in g} bf16(x[m, k]) * w[n, k]) * scale[g, n]
// The weight is packed along K, two values per byte: w_p (N, K/2) uint8, byte
// j of row n holds k = 2j (low nibble) and k = 2j + 1 (high nibble), 4-bit
// two's complement. scale (K/group, N) float32 multiplies each group's float32
// partial sum (never the weight), and the groups add in float32. With a
// normalisation scale g (K,), x is first replaced by
// bf16(x * (1 / sqrt(mean(x^2) + eps)) * g), the block's RMSNorm, computed
// from the whole row of x inside the block (no K-tiled fallback).
//
// What bounds it on the H100, and the two paths:
//  * GEMV, M <= 8 (decode steps): bound by the weight bytes over 3.35 TB/s,
//    half of int8's. As in int8_matmul.cu the products run on the tensor
//    cores with the weights as the A operand and x as the n8-wide B operand,
//    so the work per weight does not grow with M. The kernel is the shared
//    GEMV of quant_common.cuh with this file's format (`Int4`): each
//    128-value chunk is one group, whose products land in a fresh float32
//    fragment that is scaled once, as the TPU kernel scales each group's
//    dot; nibbles become bf16 two at a time (one LOP3 into the mantissa of
//    the bf16 128 + u, one bf16x2 fma), x is paired to match by byte
//    permutation, and each group's scales are loaded with its weights. Two
//    chunks per warp are in flight, a cluster splits K where N is narrow and
//    K deep (down), and the RMSNorm prologue's sums of squares run while the
//    first chunks' loads fly. On an NVIDIA H100 80GB HBM3 at 700 W, one Vevo
//    AR decode step (96 projections at M = 4) takes about 0.46 ms against
//    the first version's 0.60 ms, torch._weight_int4pack_mm's 0.51 ms and a
//    byte bound of 0.0861 ms (tools/quant_ab.py; PERF.md has each
//    projection's time).
//  * GEMM, larger M (prefill, the flow-matching estimator): bound by the
//    tensor cores. A block of 8 warps owns a 128 x 64 tile; each 32-wide K
//    step (always inside one group) stages bf16(x) and the weight tile
//    unpacked to bf16 in shared memory and runs mma.sync m16n8k16 into a
//    per-group float32 accumulator, which is scaled and added to the output
//    accumulator at each group boundary; the next step's loads go to
//    registers while the current step computes (quant_common.cuh).

#include "quant_common.cuh"

namespace {

using namespace quant;

constexpr int GROUP = 128;  // the kernel's quantization group (int4_group of the Llama widths)

__device__ __forceinline__ float nib(uint32_t w, int j) {
  return (float)(((int)(w << (28 - 4 * j))) >> 28);  // sign-extend nibble j
}

// Nibbles e and e + 4 of a word in offset binary (u = v + 8) → the bf16 pair
// {v_e, v_e+4}, exactly: each nibble becomes the low mantissa bits of the
// bf16 128 + u (one LOP3 for both halves), from which 136 is subtracted
// (one bf16x2 fma by 1).
__device__ __forceinline__ uint32_t nib2_to_bf16(uint32_t u, int e) {
  const uint32_t b = ((u >> (4 * e)) & 0x000F000Fu) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r) : "r"(b), "r"(0x3F803F80u), "r"(0xC308C308u));  // b * 1 - 136
  return r;
}

template <typename TX>
__device__ void block_rinv(float* rinv, const TX* x, int rows, int m0, int M, int K,
                           float eps) {
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const float v = m0 + r < M ? row_rinv(x + (size_t)(m0 + r) * K, K, eps) : 0.f;
    if ((threadIdx.x & 31) == 0) rinv[r] = v;
  }
  __syncthreads();
}

// The GEMV's int4 format. Lane (g, t) converts 16 packed bytes (32 values)
// of weight rows g and g + 8 at k = 32t of each 128-wide chunk, which is one
// quantization group. Word j of them holds k = 32t + 8j + e in nibble e; its
// pairs {e, e + 4} are the A fragments of products 2j (e = 0, 1) and 2j + 1
// (e = 2, 3), and x slot j holds x at the same k in the same pairing, so the
// A and B fragments share one permutation of k. The chunk's eight products
// go to a fresh float32 fragment, scaled by the group's scale and added.
struct Int4 {
  static constexpr int CH = GROUP, NI = 4;
  static constexpr bool GROUPED = true;
  static constexpr bool PROLOGUE = true;  // takes an RMSNorm gain

  __device__ static uint4 pack_x(const float (&v)[8]) {
    return make_uint4(pack_bf16(v[0], v[4]), pack_bf16(v[1], v[5]), pack_bf16(v[2], v[6]),
                      pack_bf16(v[3], v[7]));
  }
  // 8 bf16 x (pairs {0, 1} .. {6, 7}) -> the pairs {0, 4} .. {3, 7}
  __device__ static uint4 pair_bf16(const uint4& r) {
    return make_uint4(__byte_perm(r.x, r.z, 0x5410), __byte_perm(r.x, r.z, 0x7632),
                      __byte_perm(r.y, r.w, 0x5410), __byte_perm(r.y, r.w, 0x7632));
  }

  __device__ static void chunk(float (&acc)[4], const uint4& wa, const uint4& wb,
                               const uint4 (&xv)[NI], float sa, float sb) {
    const uint32_t ra[4] = {wa.x, wa.y, wa.z, wa.w}, rb[4] = {wb.x, wb.y, wb.z, wb.w};
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t ua = ra[j] ^ 0x88888888u, ub = rb[j] ^ 0x88888888u;
      const uint32_t a0[4] = {nib2_to_bf16(ua, 0), nib2_to_bf16(ub, 0), nib2_to_bf16(ua, 1),
                              nib2_to_bf16(ub, 1)};
      mma_bf16(part, a0, xv[j].x, xv[j].y);
      const uint32_t a1[4] = {nib2_to_bf16(ua, 2), nib2_to_bf16(ub, 2), nib2_to_bf16(ua, 3),
                              nib2_to_bf16(ub, 3)};
      mma_bf16(part, a1, xv[j].z, xv[j].w);
    }
    acc[0] = fmaf(part[0], sa, acc[0]);
    acc[1] = fmaf(part[1], sa, acc[1]);
    acc[2] = fmaf(part[2], sb, acc[2]);
    acc[3] = fmaf(part[3], sb, acc[3]);
  }
};

constexpr int BN4 = 64;

template <typename TX, typename TO>
__global__ void __launch_bounds__(GEMM_THREADS)
int4_gemm(const TX* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scale, const float* __restrict__ g,
          TO* __restrict__ out, int M, int N, int K, int group, float eps) {
  constexpr int WN = BN4 / 2;
  __shared__ __align__(16) __nv_bfloat16 As[BM * AP];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN4 * AP];
  __shared__ float rinv[BM];
  const int m0 = (int)blockIdx.y * BM, n0 = (int)blockIdx.x * BN4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int gq = lane >> 2, t = lane & 3;
  const int kh = K / 2;
  if (g != nullptr) block_rinv(rinv, x, BM, m0, M, K, eps);
  float acc[2][WN / 8][4], gacc[2][WN / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = gacc[i][j][e] = 0.f;

  // weight staging: thread -> row r, 8 consecutive k (4 bytes) at c
  const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 8;
  float av[16];
  uint32_t ww = 0u;
  auto load_w = [&](int k0) {
    ww = n0 + r < N ? *reinterpret_cast<const uint32_t*>(w + (size_t)(n0 + r) * kh + (k0 + c) / 2)
                    : 0u;
  };
  load_a(av, x, M, K, m0, 0);
  load_w(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // every warp is done with the previous step's tiles
    store_a(As, av, k0, rinv, g);
    *reinterpret_cast<uint4*>(Bs + r * AP + c) =
        make_uint4(pack_bf16(nib(ww, 0), nib(ww, 1)), pack_bf16(nib(ww, 2), nib(ww, 3)),
                   pack_bf16(nib(ww, 4), nib(ww, 5)), pack_bf16(nib(ww, 6), nib(ww, 7)));
    __syncthreads();
    if (k0 + BK < K) {  // the next step's loads fly during these products
      load_a(av, x, M, K, m0, k0 + BK);
      load_w(k0 + BK);
    }
    mma_tile<WN>(gacc, As, Bs, wm, wn);
    if ((k0 + BK) % group == 0) {  // group boundary: scale its partial sums
      const float* sg = scale + (size_t)(k0 / group) * N;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = n0 + wn * WN + j * 8 + 2 * t;
        const float s0 = col < N ? sg[col] : 0.f, s1 = col + 1 < N ? sg[col + 1] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][j][0] = fmaf(gacc[i][j][0], s0, acc[i][j][0]);
          acc[i][j][1] = fmaf(gacc[i][j][1], s1, acc[i][j][1]);
          acc[i][j][2] = fmaf(gacc[i][j][2], s0, acc[i][j][2]);
          acc[i][j][3] = fmaf(gacc[i][j][3], s1, acc[i][j][3]);
          gacc[i][j][0] = gacc[i][j][1] = gacc[i][j][2] = gacc[i][j][3] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int col = n0 + wn * WN + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + gq + 8 * h;
        if (row >= M) continue;
        if (col < N) store_out(out, (size_t)row * N + col, acc[i][j][2 * h]);
        if (col + 1 < N) store_out(out, (size_t)row * N + col + 1, acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const uint8_t* w, const float* scale, const float* g,
                   void* out, int M, int N, int K, int group, float eps, cudaStream_t st) {
  if (M <= GEMV_MAX_M)
    return gemv_launch<Int4, TX, TO>((const TX*)x, w, scale, g, (TO*)out, M, N, K, eps, st);
  dim3 grid((N + BN4 - 1) / BN4, (M + BM - 1) / BM);
  int4_gemm<TX, TO><<<grid, GEMM_THREADS, 0, st>>>((const TX*)x, w, scale, g, (TO*)out, M, N,
                                                    K, group, eps);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) f32 (x_bf16 = 0) or bf16; w (N, K/2) packed int4; scale
// (K/group, N) f32; g (K,) f32 or null (no RMS prologue); out (M, N) f32
// (out_bf16 = 0) or bf16; all contiguous; group == 128, K % 128 == 0.
// Returns cudaGetLastError().
extern "C" int int4_matmul(const void* x, const void* w, const void* scale,
                           const void* g, void* out, int M, int N, int K, int group,
                           int x_bf16, int out_bf16, float eps, void* stream) {
  if (group != GROUP || K % GROUP) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* wp = (const uint8_t*)w;
  const float* s = (const float*)scale;
  const float* gs = (const float*)g;
  cudaError_t err;
  if (x_bf16 && out_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, wp, s, gs, out, M, N, K, group, eps, st);
  else if (x_bf16)
    err = launch<__nv_bfloat16, float>(x, wp, s, gs, out, M, N, K, group, eps, st);
  else if (out_bf16)
    err = launch<float, __nv_bfloat16>(x, wp, s, gs, out, M, N, K, group, eps, st);
  else
    err = launch<float, float>(x, wp, s, gs, out, M, N, K, group, eps, st);
  const cudaError_t last = cudaGetLastError();  // also clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}
