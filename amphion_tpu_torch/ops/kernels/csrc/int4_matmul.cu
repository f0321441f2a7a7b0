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
//    tensor cores. The kernel is the shared GEMM of quant_common.cuh
//    (`qmm_wgmma`) with this file's format: each TMA-fed stage is one
//    128-wide group, whose eight wgmma m64n128k16 products (the weights
//    converted into register A fragments in natural k order,
//    `Int4::frags`, two halves of four k16 steps) land in a fresh float32
//    partial that is scaled by the group's column scales and added, as the
//    TPU kernel scales each group's dot. With the prologue, or float32 x, x
//    is first written to a bf16 scratch, normalised over its whole row. On
//    an NVIDIA H100 80GB HBM3 at 700 W the flow-matching qkv takes about
//    0.081 ms against the first version's 0.33 ms,
//    torch._weight_int4pack_mm's 1.17 ms and a bound of 0.033 ms
//    (tools/quant_ab.py; PERF.md has each projection's time).

#include "quant_common.cuh"

namespace {

using namespace quant;

constexpr int GROUP = 128;  // the kernel's quantization group (int4_group of the Llama widths)

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

  // The GEMM: a stage is one 128-wide group, 64 bytes of a weight row.
  static constexpr int KS = GROUP;

  // Two's-complement nibbles e and e + 4 of u -> the bf16 pair {v_e, v_e+4},
  // exactly: (nibble ^ 8) becomes the low mantissa bits of the bf16 128 +
  // (v + 8) by one LOP3 (the XOR rides on the OR's constant), from which
  // 136 is subtracted (one bf16x2 fma by 1).
  __device__ static uint32_t nib2s_to_bf16(uint32_t u, int e) {
    const uint32_t b = ((u >> (4 * e)) & 0x000F000Fu) ^ 0x43084308u;
    uint32_t r;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(r) : "r"(b), "r"(0x3F803F80u), "r"(0xC308C308u));  // b * 1 - 136
    return r;
  }

  // A fragments of k16 steps S0 ... S0 + NS - 1 (S0 and NS even) of a
  // stage for weight rows ra, rb of the 64B-swizzled tile at wt: step s
  // covers bytes 8s ... 8s + 7 of a row (chunk s / 2, words 2 (s % 2) and
  // 2 (s % 2) + 1), and lane (g, t) needs byte t of each word (k = 16s + 2t,
  // 2t + 1 and 16s + 2t + 8, 2t + 9). Each lane reads its rows' whole chunk
  // (the quad's four lanes read the same 16 bytes), puts its two bytes side
  // by side with one byte permutation, v = {b0, b1}, and spreads them as
  // v | v << 12, so that nibbles 0 and 4 hold b0's pair and nibbles 2 and 6
  // b1's.
  template <int S0, int NS>
  __device__ static void frags(uint32_t (&a)[NS][4], uint32_t wt, int ra, int rb, int t) {
    const uint32_t pa = wt + sw64(ra, 0), pb = wt + sw64(rb, 0);
    const uint32_t sel = (uint32_t)t | ((uint32_t)(4 + t) << 4);
#pragma unroll
    for (int c = 0; c < NS / 2; ++c) {
      const uint32_t off = (uint32_t)(S0 / 2 + c) << 4;
      const uint4 qa = lds128(pa ^ off), qb = lds128(pb ^ off);
      const uint32_t wa[4] = {qa.x, qa.y, qa.z, qa.w}, wb[4] = {qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t va = __byte_perm(wa[2 * h], wa[2 * h + 1], sel) & 0xFFFFu;
        const uint32_t vb = __byte_perm(wb[2 * h], wb[2 * h + 1], sel) & 0xFFFFu;
        const uint32_t ua = va | (va << 12), ub = vb | (vb << 12);
        uint32_t (&f)[4] = a[2 * c + h];
        f[0] = nib2s_to_bf16(ua, 0);
        f[1] = nib2s_to_bf16(ub, 0);
        f[2] = nib2s_to_bf16(ua, 2);
        f[3] = nib2s_to_bf16(ub, 2);
      }
    }
  }
};

template <typename TX, typename TO>
cudaError_t launch(const void* x, const uint8_t* w, const float* scale, const float* g,
                   void* out, int M, int N, int K, float eps, __nv_bfloat16* xs,
                   cudaStream_t st) {
  if (M <= GEMV_MAX_M)
    return gemv_launch<Int4, TX, TO>((const TX*)x, w, scale, g, (TO*)out, M, N, K, eps, st);
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  if (g != nullptr || sizeof(TX) == 4) {  // normalised or rounded into the scratch first
    if (xs == nullptr) return cudaErrorInvalidValue;
    const cudaError_t err = prep_launch<Int4, TX>((const TX*)x, g, xs, M, K, eps, st);
    if (err != cudaSuccess) return err;
    xb = xs;
  }
  return gemm_launch<Int4, TO>(xb, w, scale, (TO*)out, M, N, K, st);
}

}  // namespace

// x (M, K) f32 (x_bf16 = 0) or bf16; w (N, K/2) packed int4; scale
// (K/group, N) f32; g (K,) f32 or null (no RMS prologue); out (M, N) f32
// (out_bf16 = 0) or bf16; xs (M, K) bf16 scratch for the GEMM's x, needed
// when M > 8 and x is f32 or g is given, else null; all contiguous, x, w and
// g 16-byte aligned; group == 128, K % 128 == 0. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what the kernels do not
// take.
extern "C" int int4_matmul(const void* x, const void* w, const void* scale,
                           const void* g, void* out, int M, int N, int K, int group,
                           int x_bf16, int out_bf16, float eps, void* xs, void* stream) {
  if (group != GROUP || K % GROUP) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* wp = (const uint8_t*)w;
  const float* s = (const float*)scale;
  const float* gs = (const float*)g;
  __nv_bfloat16* xb = (__nv_bfloat16*)xs;
  cudaError_t err;
  if (x_bf16 && out_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, wp, s, gs, out, M, N, K, eps, xb, st);
  else if (x_bf16)
    err = launch<__nv_bfloat16, float>(x, wp, s, gs, out, M, N, K, eps, xb, st);
  else if (out_bf16)
    err = launch<float, __nv_bfloat16>(x, wp, s, gs, out, M, N, K, eps, xb, st);
  else
    err = launch<float, float>(x, wp, s, gs, out, M, N, K, eps, xb, st);
  const cudaError_t last = cudaGetLastError();  // also clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}
