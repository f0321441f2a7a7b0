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
//    so the work per weight does not grow with M; nibbles become bf16 by a
//    bit-pattern trick. Each 128-value chunk is one group: its products land
//    in a fresh float32 fragment that is scaled once, as the TPU kernel
//    scales each group's dot. A block of 8 warps owns 16 columns and splits
//    K between its warps. (The first versions multiplied on the CUDA cores:
//    14-29 us a call at M = 4 on the H100, growing with M.)
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

constexpr int GEMV_WARPS = 8;  // warps of a block, splitting K between them
constexpr int GROUP = 128;     // the kernel's quantization group (int4_group of the Llama widths)

__device__ __forceinline__ float nib(uint32_t w, int j) {
  return (float)(((int)(w << (28 - 4 * j))) >> 28);  // sign-extend nibble j
}

// Nibbles j, j+1 of a word → a bf16 pair, exactly: each nibble, offset to
// unsigned, becomes the low mantissa bits of the float 2^23 + u, from which
// 2^23 + 8 is subtracted.
__device__ __forceinline__ uint32_t nib2_to_bf16(uint32_t u, int j) {
  const float off = 8388616.f;  // 2^23 + 8
  return pack_bf16(__uint_as_float(((u >> (4 * j)) & 0xFu) | 0x4B000000u) - off,
                   __uint_as_float(((u >> (4 * j + 4)) & 0xFu) | 0x4B000000u) - off);
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

// One block per 16 output columns, as the int8 GEMV: lane (g, t) reads 16
// packed bytes (32 values) of weight rows n0 + g and n0 + g + 8 at k =
// c*128 + 32t of each 128-wide chunk c, which is one quantization group,
// and the same 32 columns of x row g; the chunk's eight k16 products take
// values 4s .. 4s+3 (step s), a permutation of k shared by the A and B
// fragments. Each chunk's products go to a fresh float32 fragment that is
// scaled by its group's scale and added to the output sums; the warps split
// the chunks and add their sums in shared memory.
template <typename TX, typename TO>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
int4_gemv(const TX* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scale, const float* __restrict__ g,
          TO* __restrict__ out, int M, int N, int K, float eps) {
  __shared__ float red[GEMV_WARPS][32][4];
  __shared__ float rinv[GEMV_MAX_M];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int n0 = (int)blockIdx.x * 16;
  const int na = n0 + gr, nb = n0 + gr + 8;
  const int kh = K / 2;
  if (g != nullptr) block_rinv(rinv, x, M, 0, M, K, eps);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = warp; c < K / GROUP; c += GEMV_WARPS) {
    const int k = c * GROUP + 32 * t;
    const uint4 wa = na < N ? *reinterpret_cast<const uint4*>(w + (size_t)na * kh + k / 2)
                            : make_uint4(0u, 0u, 0u, 0u);
    const uint4 wb = nb < N ? *reinterpret_cast<const uint4*>(w + (size_t)nb * kh + k / 2)
                            : make_uint4(0u, 0u, 0u, 0u);
    uint32_t xp[16];
    load_x_pairs<16>(xp, x, M, K, gr, k, rinv, g);
    const uint32_t ra[4] = {wa.x ^ 0x88888888u, wa.y ^ 0x88888888u, wa.z ^ 0x88888888u,
                            wa.w ^ 0x88888888u};
    const uint32_t rb[4] = {wb.x ^ 0x88888888u, wb.y ^ 0x88888888u, wb.z ^ 0x88888888u,
                            wb.w ^ 0x88888888u};
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int j = (s & 1) * 4;
      const uint32_t a[4] = {nib2_to_bf16(ra[s >> 1], j), nib2_to_bf16(rb[s >> 1], j),
                             nib2_to_bf16(ra[s >> 1], j + 2), nib2_to_bf16(rb[s >> 1], j + 2)};
      mma_bf16(part, a, xp[2 * s], xp[2 * s + 1]);
    }
    const float* sg = scale + (size_t)c * N;
    const float sa = na < N ? sg[na] : 0.f, sb = nb < N ? sg[nb] : 0.f;
    acc[0] = fmaf(part[0], sa, acc[0]);
    acc[1] = fmaf(part[1], sa, acc[1]);
    acc[2] = fmaf(part[2], sb, acc[2]);
    acc[3] = fmaf(part[3], sb, acc[3]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) red[warp][lane][e] = acc[e];
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < GEMV_WARPS; ++i) v += red[i][lane][e];
    const int n = e < 2 ? na : nb, m = 2 * t + (e & 1);
    if (n < N && m < M) store_out(out, (size_t)m * N + n, v);
  }
}

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
void launch(const void* x, const uint8_t* w, const float* scale, const float* g,
            void* out, int M, int N, int K, int group, float eps, cudaStream_t st) {
  if (M <= GEMV_MAX_M) {
    int4_gemv<TX, TO><<<(N + 15) / 16, GEMV_WARPS * 32, 0, st>>>(
        (const TX*)x, w, scale, g, (TO*)out, M, N, K, eps);
  } else {
    dim3 grid((N + BN4 - 1) / BN4, (M + BM - 1) / BM);
    int4_gemm<TX, TO><<<grid, GEMM_THREADS, 0, st>>>((const TX*)x, w, scale, g,
                                                      (TO*)out, M, N, K, group, eps);
  }
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
  if (x_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, wp, s, gs, out, M, N, K, group, eps, st);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, wp, s, gs, out, M, N, K, group, eps, st);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(x, wp, s, gs, out, M, N, K, group, eps, st);
  else
    launch<float, float>(x, wp, s, gs, out, M, N, K, group, eps, st);
  return (int)cudaGetLastError();
}
