// bf16 matrix-vector product for Hopper (sm_90a): the Vevo AR's lm_head in
// the quantized decode,
//     out (M, N) bf16 = x (M, K) bf16 @ w^T,   w (N, K) bf16 row-major,
// products summed in float32, rounded once to bf16.
//
// Replaces no Pallas kernel: the JAX package leaves the unquantized lm_head
// to XLA (`ARTransformer.lm_head`, amphion_tpu/models/vc/ar_transformer.py:
// 175, 325, 331), and the port's first version left it to cuBLAS through
// `nn.Linear`. It exists so that a row's logits do not depend on how many
// rows the call holds: on an NVIDIA H100 cuBLAS changed row 0's bits between
// a decode step of 1 row and one of 2, 4 or 8 (`chip_smoke.py`, the row
// invariance check), so a request's sampled tokens depended on its company.
//
// It is the shared GEMV of quant_common.cuh (`gemv_kernel`) with this file's
// format, bf16 weights as they are: a block of 8 warps owns 16 output
// columns, the weights are the A operand of m16n8k16 products and x's rows
// the n8 side, so row r of x is column r of every product and row r of the
// output does not depend on M or on the other rows; no scale (a unit one).
// M > 8 runs in launches of 8 rows, each row-invariant the same way.
//
// What bounds it: the weight bytes, each used M <= 8 times: 21.1 MB for the
// Vevo AR's 8244 x 1280 head, 6.3 us at 3.35 TB/s.

#include "quant_common.cuh"

namespace {

using namespace quant;

// Lane (g, t) loads 16 bytes, 8 bf16 at k = 8t of each 32-wide chunk, of
// weight rows g and g + 8, and the same 8 values of x row g. Step s of the
// chunk's two k16 products takes words 2s and 2s + 1 of each (k 8t + 4s ...
// 8t + 4s + 3) as the A pairs {2t, 2t+1} and {2t+8, 2t+9}, and x's words 2s
// and 2s + 1 as the B pairs: a permutation of k that both operands share.
struct Bf16 {
  static constexpr int CH = 32, NI = 1;
  static constexpr bool GROUPED = false;
  static constexpr bool PROLOGUE = false;

  __device__ static uint4 pack_x(const float (&v)[8]) {
    return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                      pack_bf16(v[6], v[7]));
  }
  __device__ static uint4 pair_bf16(const uint4& r) { return r; }

  __device__ static void chunk(float (&acc)[4], const uint4& wa, const uint4& wb,
                               const uint4 (&xv)[NI], float, float) {
    const uint32_t ra[4] = {wa.x, wa.y, wa.z, wa.w}, rb[4] = {wb.x, wb.y, wb.z, wb.w};
    const uint32_t xb[4] = {xv[0].x, xv[0].y, xv[0].z, xv[0].w};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint32_t a[4] = {ra[2 * s], rb[2 * s], ra[2 * s + 1], rb[2 * s + 1]};
      mma_bf16(acc, a, xb[2 * s], xb[2 * s + 1]);
    }
  }
};

}  // namespace

// x (M, K) bf16, w (N, K) bf16, out (M, N) bf16, all contiguous and
// 16-byte aligned; K % 32 == 0. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int bf16_gemv(const void* x, const void* w, void* out, int M, int N, int K,
                         void* stream) {
  if (K % 32 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  __nv_bfloat16* ob = (__nv_bfloat16*)out;
  cudaError_t err = cudaSuccess;
  for (int m0 = 0; m0 < M && err == cudaSuccess; m0 += GEMV_MAX_M) {
    const int m = M - m0 < GEMV_MAX_M ? M - m0 : GEMV_MAX_M;
    err = gemv_launch<Bf16, __nv_bfloat16, __nv_bfloat16>(
        xb + (size_t)m0 * K, (const uint8_t*)w, nullptr, nullptr, ob + (size_t)m0 * N, m, N, K,
        0.f, st);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
