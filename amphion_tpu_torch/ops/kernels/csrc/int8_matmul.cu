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
//    thousands of rows it is bound by the tensor cores' bf16 rate. The
//    kernel is the shared GEMM of quant_common.cuh (`qmm_wgmma`) with this
//    file's format: TMA-fed stages of 64 k onto mbarriers from a producer
//    warpgroup, wgmma m64n128k16 with the converted weights as the register
//    A operand (`Int8::frags`: one byte permutation per row and k16 step
//    puts the lane's bytes in natural k order) and x as the shared-memory B
//    operand, a persistent block of 128 columns x 128 rows per SM, the
//    column scale applied once in the epilogue; float32 x is rounded into a
//    bf16 scratch first. On an NVIDIA H100 80GB HBM3 at 700 W the
//    flow-matching qkv, (5120, 1024) -> 3072, takes about 0.080 ms against
//    the first version's 0.24 ms and a bound of 0.033 ms
//    (tools/quant_ab.py; PERF.md has each projection's time).

#include "quant_common.cuh"

namespace {

using namespace quant;

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

  // The GEMM: a stage is 64 k, one byte each of a weight row.
  static constexpr int KS = 64;

  // A fragments of k16 steps S0 ... S0 + NS - 1 of a stage for weight rows
  // ra, rb of the 64B-swizzled tile at wt: lane (g, t) of step s needs bytes
  // 2t, 2t + 1, 2t + 8, 2t + 9 of chunk s of each row. It reads the chunk's
  // words t / 2 and 2 + t / 2 (the quad's lanes read two words each, shared
  // in pairs), gathers its four bytes with one byte permutation and converts
  // them to the bf16 pairs {2t, 2t + 1} (a0, a1) and {2t + 8, 2t + 9} (a2,
  // a3).
  template <int S0, int NS>
  __device__ static void frags(uint32_t (&a)[NS][4], uint32_t wt, int ra, int rb, int t) {
    const uint32_t pa = wt + sw64(ra, 0) + 4 * (t >> 1), pb = wt + sw64(rb, 0) + 4 * (t >> 1);
    const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const uint32_t ca = pa ^ ((S0 + i) << 4), cb = pb ^ ((S0 + i) << 4);  // chunk, swizzled
      i8x4_to_bf16(__byte_perm(lds32(ca), lds32(ca + 8), sel), a[i][0], a[i][2]);
      i8x4_to_bf16(__byte_perm(lds32(cb), lds32(cb + 8), sel), a[i][1], a[i][3]);
    }
  }
};

template <typename TX, typename TO>
cudaError_t launch(const void* x, const int8_t* w, const float* scale, void* out, int M,
                   int N, int K, __nv_bfloat16* xs, cudaStream_t st) {
  if (M <= GEMV_MAX_M)
    return gemv_launch<Int8, TX, TO>((const TX*)x, (const uint8_t*)w, scale, nullptr,
                                     (TO*)out, M, N, K, 0.f, st);
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  if constexpr (sizeof(TX) == 4) {  // float32 x: rounded to bf16 into the scratch first
    if (xs == nullptr) return cudaErrorInvalidValue;
    const cudaError_t err = prep_launch<Int8, TX>((const TX*)x, nullptr, xs, M, K, 0.f, st);
    if (err != cudaSuccess) return err;
    xb = xs;
  }
  return gemm_launch<Int8, TO>(xb, (const uint8_t*)w, scale, (TO*)out, M, N, K, st);
}

}  // namespace

// x (M, K) f32 (x_bf16 = 0) or bf16; w (N, K) int8; scale (N,) f32; out
// (M, N) f32 (out_bf16 = 0) or bf16; xs (M, K) bf16 scratch for bf16(x),
// needed when M > 8 and x is f32, else null; all contiguous, x and w
// 16-byte aligned; K % 64 == 0. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the kernels do not take.
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, void* out,
                           int M, int N, int K, int x_bf16, int out_bf16, void* xs,
                           void* stream) {
  if (K % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* wq = (const int8_t*)w;
  const float* s = (const float*)scale;
  __nv_bfloat16* xb = (__nv_bfloat16*)xs;
  cudaError_t err;
  if (x_bf16 && out_bf16) err = launch<__nv_bfloat16, __nv_bfloat16>(x, wq, s, out, M, N, K, xb, st);
  else if (x_bf16) err = launch<__nv_bfloat16, float>(x, wq, s, out, M, N, K, xb, st);
  else if (out_bf16) err = launch<float, __nv_bfloat16>(x, wq, s, out, M, N, K, xb, st);
  else err = launch<float, float>(x, wq, s, out, M, N, K, xb, st);
  const cudaError_t last = cudaGetLastError();  // also clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}
