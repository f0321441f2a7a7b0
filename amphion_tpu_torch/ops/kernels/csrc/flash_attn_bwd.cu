// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the Pallas kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` behind `flash_attention_bwd_pallas`
// (amphion_tpu/ops/pallas_kernels.py:890-1113): the FlashAttention-2
// backward. P is recomputed from (Q, K, LSE) tile by tile, so the (Lq, Lk)
// score matrix never reaches device memory:
//   dV = sum_q P^T dO,  dS = P * (dO V^T - Delta),
//   dQ = scale * sum_k dS K,  dK = scale * sum_q dS^T Q,
// with Delta = rowsum(dO * O) computed by the caller (as JAX computes it
// outside its kernels, l.1016). Two kernels, as in JAX (in float32 both
// run in one launch):
//  * dQ: one block per (batch*head, 64 query rows), looping over key tiles;
//  * dK/dV: one block per (batch*kv-head, 64 key rows), looping over query
//    tiles and over the H/KVH query heads of its group, so the GQA sum
//    happens in registers: no repeat of K/V and no second pass.
// No atomics: every output element is written once by one thread, with
// its sums in a fixed order, so a gradient is the same bit for bit from
// run to run.
//
// Semantics kept from the forward (flash_attn_fwd.cu): a key counts when
// it lies inside Lk, its mask value is > 0 and, when causal, col <= row
// from the top-left corner; a key that does not count has p = 0. A query
// row with no key that counts (its LSE is about -1e30) gets a zero dQ and
// adds nothing to dK/dV.
//
// What bounds it on the H100: per (query, key) pair the backward does five
// D-long products (S, dP, dV, dQ, dK), 10 D operations (half of the pairs
// when causal), against q, k, v, o, dO, dq, dk, dv and the LSE read or
// written once. At the Vevo training shapes (FM (8, 256, 16, 64), AR
// (8, 516, 20, 64) causal) that is 5.4 and 12.4 GFLOP against 67 and 169
// MB, so the operations bound it: in float32 (the trainers' type) 0.080 /
// 0.185 ms at the 67 TFLOP/s FMA rate, or 0.033 / 0.075 ms as three TF32
// products at the 495 TFLOP/s TF32 rate; in bf16 a fifteenth of the former.
//  * float32: every product on the tensor cores in split TF32
//    (flash_common.cuh: x = big + small, three TF32 products per product,
//    float32 accuracy), mma.sync m16n8k8, 4 warps of 16 rows. The rows a
//    block owns (Q and dO for dQ, K and V for dK/dV) stay in shared memory
//    and are split as their A fragments are loaded; the other side streams
//    in tiles of 32 rows through two cp.async stages, and each warp splits
//    its B fragments in registers. Every product runs over eight
//    accumulators before the next (flash_common.cuh), the softmax uses the
//    SFU's 2^x, and the dQ and dK/dV blocks share one launch; 70 KB of
//    shared memory and at most 170 registers a thread let three blocks
//    share an SM. (Splitting each streamed tile once per block, into high
//    and low arrays, ran slower: the extra barrier and loads cost more than
//    the conversions they saved.)
//    S and dP go from their accumulators into the A fragments of dS K,
//    P^T dO and dS^T Q without shuffles (keys or queries permuted inside
//    each k-step, flash_common.cuh); rows of D + 4 floats keep every
//    fragment load free of bank conflicts. The dQ kernel skips the key
//    tiles past the last key that counts; a dK/dV block whose keys all
//    fail the mask writes zeros at once.
//  * bf16: mma.sync m16n8k16 with float32 accumulation, 4 warps of 16
//    rows; the operand tiles sit in shared memory (rows padded by 16 bytes)
//    and ldmatrix reads the fragments; P and dS go from the accumulators
//    straight into A fragments, as P does in the forward. No measured path
//    runs it (the trainers are float32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using fa::cp_async16;
using fa::NEG;
using fa::smem_addr;

constexpr int THREADS = 128;

// ------------------------------------------------------------- float32 path

constexpr int FR = 64;  // rows a block owns: 4 warps x 16
constexpr int FT = 32;  // rows of a streamed tile

template <int D>
size_t f32_smem_bytes(int nwords) {  // 2 row tiles, 2 x 2 streamed stages, bits or LSE/Delta
  return (size_t)(2 * FR + 4 * FT) * fa::f32_pitch<D>() * 4 + (size_t)nwords * 4 + 4 * FT * 4;
}

// dQ for 64 query rows (tile bx) of one (b, h) = by; key tiles of 32.
template <int D>
__device__ __forceinline__ void
bwd_dq_f32(int bx, int by, const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ mask,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dq, int Lq,
           int Lk, int H, int KVH, int causal, float scale) {
  constexpr int P = fa::f32_pitch<D>();
  constexpr int TILE = FT * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [FR][P] Q
  float* Gs = Qs + FR * P;                         // [FR][P] dO
  float* Ks = Gs + FR * P;                         // [2][TILE]
  float* Vs = Ks + 2 * TILE;                       // [2][TILE]
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + 2 * TILE);

  const int b = by / H, h = by % H;
  const int kvh = h / (H / KVH);
  const int q0 = bx * FR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int r0 = q0 + row0 + g, r1 = r0 + 8;
  const size_t qstride = (size_t)H * D, kstride = (size_t)KVH * D;
  const float* qb = q + (size_t)b * Lq * qstride + (size_t)h * D;
  const float* gb = dout + (size_t)b * Lq * qstride + (size_t)h * D;
  const float* kb = k + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const float* vb = v + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const int nwords = (Lk + 31) / 32;

  fa::load_rows_f32<D>(Qs, qb, qstride, q0, FR, Lq);
  fa::load_rows_f32<D>(Gs, gb, qstride, q0, FR, Lq);
  fa::cp_async_commit();
  fa::key_bits(bits, nwords, mask == nullptr ? nullptr : mask + (size_t)b * Lk, Lk);
  fa::cp_async_wait<0>();
  __syncthreads();
  int n_tiles = (fa::last_key(bits, nwords) + FT) / FT;
  if (causal) n_tiles = min(n_tiles, (q0 + FR + FT - 1) / FT);

  const size_t sb = ((size_t)b * H + h) * Lq;
  const float sl2 = scale * fa::LOG2E;  // p = 2^(s scale log2 e - LSE log2 e)
  const float l0 = r0 < Lq ? lse[sb + r0] * fa::LOG2E : 0.f;
  const float l1 = r1 < Lq ? lse[sb + r1] * fa::LOG2E : 0.f;
  const float d0 = r0 < Lq ? delta[sb + r0] : 0.f, d1 = r1 < Lq ? delta[sb + r1] : 0.f;

  auto load_tile = [&](int j, int buf) {
    fa::load_rows_f32<D>(Ks + buf * TILE, kb, kstride, j * FT, FT, Lk);
    fa::load_rows_f32<D>(Vs + buf * TILE, vb, kstride, j * FT, FT, Lk);
    fa::cp_async_commit();
  };

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  if (n_tiles > 0) load_tile(0, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FT, buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(j + 1, buf ^ 1);
      fa::cp_async_wait<1>();
    } else {
      fa::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + buf * TILE;
    const float* Vt = Vs + buf * TILE;

    // S = Q K^T and dP = dO V^T, 16 rows x 32 keys per warp
    float s[FT / 8][4], dp[FT / 8][4];
#pragma unroll
    for (int jn = 0; jn < FT / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] = dp[jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const fa::FragA qa = fa::load_a<D>(Qs, row0, kk, g, t);
      const fa::FragA ga = fa::load_a<D>(Gs, row0, kk, g, t);
      const int o = g * P + kk * 8 + t;
      fa::mma_3xtf32_2x4(s, qa, Kt + o, dp, ga, Vt + o, 8 * P, 4);
    }
    // P from the LSE, dS = P (dP - Delta), kept in s
    const uint32_t word = bits[j];
    const bool full = word == 0xffffffffu && (!causal || k0 + FT - 1 <= q0 + row0);
#pragma unroll
    for (int jn = 0; jn < FT / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = jn * 8 + 2 * t + e, col = k0 + cl;
        const bool ok = full || ((word >> cl) & 1u);
        const float p0 = (ok && (full || !causal || col <= r0)) ? fa::ex2(fmaf(s[jn][e], sl2, -l0)) : 0.f;
        const float p1 = (ok && (full || !causal || col <= r1)) ? fa::ex2(fmaf(s[jn][2 + e], sl2, -l1)) : 0.f;
        s[jn][e] = p0 * (dp[jn][e] - d0);
        s[jn][2 + e] = p1 * (dp[jn][2 + e] - d1);
      }
    }
    // dQ += dS K: k-step kk takes keys 8 kk + 2t and 8 kk + 2t + 1
#pragma unroll
    for (int kk = 0; kk < FT / 8; ++kk) {
      const fa::FragA da = fa::acc_to_a(s[kk]);
      const float* kp = Kt + (kk * 8 + 2 * t) * P + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 8)
        fa::mma_3xtf32_2x4(acc + nd, da, kp + nd * 8, acc + nd + 4, da, kp + nd * 8 + 32, 8, P);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float* ob = dq + (size_t)b * Lq * qstride + (size_t)h * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<float2*>(ob + r0 * qstride + c) =
          make_float2(acc[nd][0] * scale, acc[nd][1] * scale);
    if (r1 < Lq)
      *reinterpret_cast<float2*>(ob + r1 * qstride + c) =
          make_float2(acc[nd][2] * scale, acc[nd][3] * scale);
  }
}

// dK and dV for 64 key rows (tile bx) of one (b, kv-head) = by: query tiles
// of 32 of every query head of the group. Each warp owns 16 key rows;
// S^T = K Q^T.
template <int D>
__device__ __forceinline__ void
bwd_dkv_f32(int bx, int by, const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ mask,
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk,
            float* __restrict__ dv, int Lq, int Lk, int H, int KVH, int causal,
            float scale) {
  constexpr int P = fa::f32_pitch<D>();
  constexpr int TILE = FT * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [FR][P] K
  float* Vs = Ks + FR * P;                         // [FR][P] V
  float* Qt = Vs + FR * P;                         // [2][TILE]
  float* Gt = Qt + 2 * TILE;                       // [2][TILE]
  float* Ls = Gt + 2 * TILE;                       // [2][FT]
  float* Ds = Ls + 2 * FT;                         // [2][FT]

  const int b = by / KVH, kvh = by % KVH;
  const int rep = H / KVH;
  const int k0 = bx * FR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int r0 = k0 + row0 + g, r1 = r0 + 8;  // this lane's two key rows
  const size_t qstride = (size_t)H * D, kstride = (size_t)KVH * D;
  const float* kb = k + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const float* vb = v + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const bool ok0 = r0 < Lk && (mask == nullptr || mask[(size_t)b * Lk + r0] > 0.f);
  const bool ok1 = r1 < Lk && (mask == nullptr || mask[(size_t)b * Lk + r1] > 0.f);
  const size_t base = (size_t)b * Lk * kstride + (size_t)kvh * D;
  const float sl2 = scale * fa::LOG2E;

  // a block whose keys all fail the mask has dK = dV = 0 (p = 0 throughout)
  if (!__syncthreads_or(ok0 || ok1)) {
    for (int c = threadIdx.x; c < FR * D; c += THREADS) {
      const int r = k0 + c / D;
      if (r < Lk) dk[base + r * kstride + c % D] = dv[base + r * kstride + c % D] = 0.f;
    }
    return;
  }

  fa::load_rows_f32<D>(Ks, kb, kstride, k0, FR, Lk);
  fa::load_rows_f32<D>(Vs, vb, kstride, k0, FR, Lk);
  fa::cp_async_commit();
  fa::cp_async_wait<0>();
  __syncthreads();

  const int first = causal ? k0 / FT : 0;  // query rows below k0 see no key here
  const int per_head = max((Lq + FT - 1) / FT - first, 0);
  const int n_tiles = rep * per_head;

  auto load_tile = [&](int it, int buf) {  // query tile it % per_head of head it / per_head
    const int h = kvh * rep + it / per_head, i0 = (first + it % per_head) * FT;
    const float* qb = q + (size_t)b * Lq * qstride + (size_t)h * D;
    const float* gb = dout + (size_t)b * Lq * qstride + (size_t)h * D;
    fa::load_rows_f32<D>(Qt + buf * TILE, qb, qstride, i0, FT, Lq);
    fa::load_rows_f32<D>(Gt + buf * TILE, gb, qstride, i0, FT, Lq);
    const size_t sb = ((size_t)b * H + h) * Lq;
    for (int c = threadIdx.x; c < FT; c += THREADS) {
      const bool in = i0 + c < Lq;
      fa::cp_async4(Ls + buf * FT + c, lse + (in ? sb + i0 + c : 0), in ? 4 : 0);
      fa::cp_async4(Ds + buf * FT + c, delta + (in ? sb + i0 + c : 0), in ? 4 : 0);
    }
    fa::cp_async_commit();
  };

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  if (n_tiles > 0) load_tile(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = (first + it % per_head) * FT, buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(it + 1, buf ^ 1);
      fa::cp_async_wait<1>();
    } else {
      fa::cp_async_wait<0>();
    }
    __syncthreads();  // this stage is visible
    const float* Qc = Qt + buf * TILE;
    const float* Gc = Gt + buf * TILE;
    const float* Lc = Ls + buf * FT;
    const float* Dc = Ds + buf * FT;

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries per warp
    float s[FT / 8][4], dp[FT / 8][4];
#pragma unroll
    for (int jn = 0; jn < FT / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] = dp[jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const fa::FragA ka = fa::load_a<D>(Ks, row0, kk, g, t);
      const fa::FragA va = fa::load_a<D>(Vs, row0, kk, g, t);
      const int o = g * P + kk * 8 + t;
      fa::mma_3xtf32_2x4(s, ka, Qc + o, dp, va, Gc + o, 8 * P, 4);
    }
    // P^T into s, dS^T into dp
#pragma unroll
    for (int jn = 0; jn < FT / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = jn * 8 + 2 * t + e, col = i0 + cl;
        const bool in = col < Lq;
        const float lc = Lc[cl] * fa::LOG2E;
        const float p0 = (ok0 && in && (!causal || r0 <= col)) ? fa::ex2(fmaf(s[jn][e], sl2, -lc)) : 0.f;
        const float p1 = (ok1 && in && (!causal || r1 <= col)) ? fa::ex2(fmaf(s[jn][2 + e], sl2, -lc)) : 0.f;
        s[jn][e] = p0;
        s[jn][2 + e] = p1;
        dp[jn][e] = p0 * (dp[jn][e] - Dc[cl]);
        dp[jn][2 + e] = p1 * (dp[jn][2 + e] - Dc[cl]);
      }
    }
    // dV += P^T dO and dK += dS^T Q: k-step kk takes queries 8 kk + 2t and
    // 8 kk + 2t + 1
#pragma unroll
    for (int kk = 0; kk < FT / 8; ++kk) {
      const fa::FragA pa = fa::acc_to_a(s[kk]);
      const fa::FragA da = fa::acc_to_a(dp[kk]);
      const int o = (kk * 8 + 2 * t) * P + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 4)
        fa::mma_3xtf32_2x4(dva + nd, pa, Gc + o + nd * 8, dka + nd, da, Qc + o + nd * 8, 8, P);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (r0 < Lk) {
      *reinterpret_cast<float2*>(dk + base + r0 * kstride + c) =
          make_float2(dka[nd][0] * scale, dka[nd][1] * scale);
      *reinterpret_cast<float2*>(dv + base + r0 * kstride + c) = make_float2(dva[nd][0], dva[nd][1]);
    }
    if (r1 < Lk) {
      *reinterpret_cast<float2*>(dk + base + r1 * kstride + c) =
          make_float2(dka[nd][2] * scale, dka[nd][3] * scale);
      *reinterpret_cast<float2*>(dv + base + r1 * kstride + c) = make_float2(dva[nd][2], dva[nd][3]);
    }
  }
}

// Both float32 kernels in one launch, so their blocks share the card's
// waves: blocks [0, n_dkv) are dK/dV blocks (the longer ones, first), the
// rest dQ blocks; n_dkv = ceil(Lk / 64) B KVH.
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 3 : 1)
bwd_dq_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ mask,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq,
               float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk, int H,
               int KVH, int causal, float scale, int n_dkv) {
  const int nk = (Lk + FR - 1) / FR, nq = (Lq + FR - 1) / FR;
  const int i = (int)blockIdx.x;
  if (i < n_dkv)
    bwd_dkv_f32<D>(i % nk, i / nk, q, k, v, mask, dout, lse, delta, dk, dv, Lq, Lk, H, KVH,
                   causal, scale);
  else
    bwd_dq_f32<D>((i - n_dkv) % nq, (i - n_dkv) / nq, q, k, v, mask, dout, lse, delta, dq,
                  Lq, Lk, H, KVH, causal, scale);
}

// ---------------------------------------------------------------- bf16 path

constexpr int BR = 64;  // rows of a block: 4 warps x 16
constexpr int BT = 32;  // rows of a streamed tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8. Plain, lane l receives row l / 4, columns 2(l % 4) and 2(l % 4)+1 of
// each matrix; with .trans the transpose.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// rows [r0, r0 + n) of one head of a (B, L, heads, D) tensor -> a shared tile
// of pitch D + 8, zeros past L
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int r0, int n, int L) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < n * CH; c += THREADS) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool in = r0 + r < L;
    cp_async16(dst + r * (D + 8) + cc, src + (in ? (size_t)(r0 + r) * stride + cc : 0),
               in ? 16 : 0);
  }
}

// Fragment addressing of this lane (see ldsm_x4):
//  B of an (n, k) row-major tile, two n8 tiles: row (lane & 7) + ((lane >> 4) << 3),
//    column ((lane >> 3) & 1) * 8;
//  B of a (k, n) row-major tile (.trans), two n8 tiles, and A of a (m, k)
//    row-major tile (plain): row lane & 15, column (lane >> 4) * 8.

// dQ for 64 query rows of one (b, h); key tiles of 32.
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
            const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Lq,
            int Lk, int H, int KVH, int causal, float scale) {
  constexpr int KP = D + 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[BT * KP];
  __shared__ __align__(16) __nv_bfloat16 Vs[BT * KP];
  __shared__ __align__(16) __nv_bfloat16 Qs[BR * KP];
  __shared__ float Ms[BT];

  const int b = (int)blockIdx.y / H, h = (int)blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int q0 = (int)blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const size_t qstride = (size_t)H * D, kstride = (size_t)KVH * D;
  const __nv_bfloat16* qb = q + (size_t)b * Lq * qstride + (size_t)h * D;
  const __nv_bfloat16* gb = dout + (size_t)b * Lq * qstride + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;
  const int arow = lane & 15, acol = (lane >> 4) * 8;

  // Q and dO of this warp's 16 rows as A fragments, staged through Qs
  uint32_t qf[D / 16][4], gf[D / 16][4];
  load_rows<D>(Qs, qb, qstride, q0, BR, Lq);
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + arow) * KP + kk * 16 + acol);
  __syncthreads();
  load_rows<D>(Qs, gb, qstride, q0, BR, Lq);
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(gf[kk], Qs + (warp * 16 + arow) * KP + kk * 16 + acol);

  const size_t sb = ((size_t)b * H + h) * Lq;
  const float l0 = r0 < Lq ? lse[sb + r0] : 0.f, l1 = r1 < Lq ? lse[sb + r1] : 0.f;
  const float d0 = r0 < Lq ? delta[sb + r0] : 0.f, d1 = r1 < Lq ? delta[sb + r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  int n_tiles = (Lk + BT - 1) / BT;
  if (causal) n_tiles = min(n_tiles, (q0 + BR + BT - 1) / BT);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BT;
    __syncthreads();
    load_rows<D>(Ks, kb, kstride, k0, BT, Lk);
    load_rows<D>(Vs, vb, kstride, k0, BT, Lk);
    for (int c = threadIdx.x; c < BT; c += THREADS) {
      const int key = k0 + c;
      Ms[c] = (key < Lk && (mask == nullptr || mask[(size_t)b * Lk + key] > 0.f))
                  ? 1.f : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 16 rows x 32 keys per warp
    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int jn = 0; jn < BT / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] = dp[jn][e] = 0.f;
#pragma unroll
    for (int jn = 0; jn < BT / 8; jn += 2) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, Ks + (jn * 8 + brow) * KP + kk * 16 + bcol);
        ldsm_x4(vf, Vs + (jn * 8 + brow) * KP + kk * 16 + bcol);
        mma_bf16(s[jn], qf[kk], kf[0], kf[1]);
        mma_bf16(s[jn + 1], qf[kk], kf[2], kf[3]);
        mma_bf16(dp[jn], gf[kk], vf[0], vf[1]);
        mma_bf16(dp[jn + 1], gf[kk], vf[2], vf[3]);
      }
    }
    // P from the LSE, dS = P (dP - Delta), kept in s
#pragma unroll
    for (int jn = 0; jn < BT / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = jn * 8 + 2 * t + e, col = k0 + cl;
        const bool ok = Ms[cl] > 0.f;
        const float p0 = (ok && (!causal || col <= r0)) ? __expf(s[jn][e] * scale - l0) : 0.f;
        const float p1 = (ok && (!causal || col <= r1)) ? __expf(s[jn][2 + e] * scale - l1) : 0.f;
        s[jn][e] = p0 * (dp[jn][e] - d0);
        s[jn][2 + e] = p1 * (dp[jn][2 + e] - d1);
      }
    }
    // dQ += dS K: two dS n8 tiles form the A fragment of one k16 step
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t kt[4];
        ldsm_x4_trans(kt, Ks + (kk * 16 + arow) * KP + nd * 8 + acol);
        mma_bf16(acc[nd], pa, kt[0], kt[1]);
        mma_bf16(acc[nd + 1], pa, kt[2], kt[3]);
      }
    }
  }

  __nv_bfloat16* ob = dq + (size_t)b * Lq * qstride + (size_t)h * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r0 * qstride + c) =
          pack_bf16(acc[nd][0] * scale, acc[nd][1] * scale);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r1 * qstride + c) =
          pack_bf16(acc[nd][2] * scale, acc[nd][3] * scale);
  }
}

template <int D>
constexpr int dkv_bf16_smem_bytes() {  // K, V (64 rows), Q, dO (32 rows), LSE, Delta
  return (2 * BR + 2 * BT) * (D + 8) * 2 + 2 * BT * 4;
}

// dK and dV for 64 key rows of one (b, kv-head); query tiles of 32 of every
// query head of the group. Each warp owns 16 key rows; S^T = K Q^T.
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
             const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int H, int KVH,
             int causal, float scale) {
  constexpr int KP = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BR][KP]
  __nv_bfloat16* Vs = Ks + BR * KP;                                 // [BR][KP]
  __nv_bfloat16* Qs = Vs + BR * KP;                                 // [BT][KP]
  __nv_bfloat16* Gs = Qs + BT * KP;                                 // [BT][KP]
  float* Ls = reinterpret_cast<float*>(Gs + BT * KP);               // [BT]
  float* Ds = Ls + BT;                                              // [BT]

  const int b = (int)blockIdx.y / KVH, kvh = (int)blockIdx.y % KVH;
  const int rep = H / KVH;
  const int k0 = (int)blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;  // this lane's two key rows
  const size_t qstride = (size_t)H * D, kstride = (size_t)KVH * D;
  const __nv_bfloat16* kb = k + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const bool ok0 = r0 < Lk && (mask == nullptr || mask[(size_t)b * Lk + r0] > 0.f);
  const bool ok1 = r1 < Lk && (mask == nullptr || mask[(size_t)b * Lk + r1] > 0.f);
  const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;
  const int arow = lane & 15, acol = (lane >> 4) * 8;

  load_rows<D>(Ks, kb, kstride, k0, BR, Lk);
  load_rows<D>(Vs, vb, kstride, k0, BR, Lk);
  cp_async_wait_all();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  const int first = causal ? k0 / BT : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const __nv_bfloat16* qb = q + (size_t)b * Lq * qstride + (size_t)h * D;
    const __nv_bfloat16* gb = dout + (size_t)b * Lq * qstride + (size_t)h * D;
    const size_t sb = ((size_t)b * H + h) * Lq;
    for (int i0 = first * BT; i0 < Lq; i0 += BT) {
      __syncthreads();
      load_rows<D>(Qs, qb, qstride, i0, BT, Lq);
      load_rows<D>(Gs, gb, qstride, i0, BT, Lq);
      for (int c = threadIdx.x; c < BT; c += THREADS) {
        Ls[c] = i0 + c < Lq ? lse[sb + i0 + c] : 0.f;
        Ds[c] = i0 + c < Lq ? delta[sb + i0 + c] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries per warp
      float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
      for (int jn = 0; jn < BT / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jn][e] = dp[jn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, Ks + (warp * 16 + arow) * KP + kk * 16 + acol);
        ldsm_x4(va, Vs + (warp * 16 + arow) * KP + kk * 16 + acol);
#pragma unroll
        for (int jn = 0; jn < BT / 8; jn += 2) {
          uint32_t qf[4], gf[4];
          ldsm_x4(qf, Qs + (jn * 8 + brow) * KP + kk * 16 + bcol);
          ldsm_x4(gf, Gs + (jn * 8 + brow) * KP + kk * 16 + bcol);
          mma_bf16(s[jn], ka, qf[0], qf[1]);
          mma_bf16(s[jn + 1], ka, qf[2], qf[3]);
          mma_bf16(dp[jn], va, gf[0], gf[1]);
          mma_bf16(dp[jn + 1], va, gf[2], gf[3]);
        }
      }
      // P^T into s, dS^T into dp
#pragma unroll
      for (int jn = 0; jn < BT / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = jn * 8 + 2 * t + e, col = i0 + cl;
          const bool in = col < Lq;
          const float p0 = (ok0 && in && (!causal || r0 <= col))
                               ? __expf(s[jn][e] * scale - Ls[cl]) : 0.f;
          const float p1 = (ok1 && in && (!causal || r1 <= col))
                               ? __expf(s[jn][2 + e] * scale - Ls[cl]) : 0.f;
          s[jn][e] = p0;
          s[jn][2 + e] = p1;
          dp[jn][e] = p0 * (dp[jn][e] - Ds[cl]);
          dp[jn][2 + e] = p1 * (dp[jn][2 + e] - Ds[cl]);
        }
      }
      // dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int nd = 0; nd < D / 8; nd += 2) {
          uint32_t gt[4], qt[4];
          ldsm_x4_trans(gt, Gs + (kk * 16 + arow) * KP + nd * 8 + acol);
          ldsm_x4_trans(qt, Qs + (kk * 16 + arow) * KP + nd * 8 + acol);
          mma_bf16(dva[nd], pa, gt[0], gt[1]);
          mma_bf16(dva[nd + 1], pa, gt[2], gt[3]);
          mma_bf16(dka[nd], da, qt[0], qt[1]);
          mma_bf16(dka[nd + 1], da, qt[2], qt[3]);
        }
      }
    }
  }

  const size_t base = (size_t)b * Lk * kstride + (size_t)kvh * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (r0 < Lk) {
      *reinterpret_cast<uint32_t*>(dk + base + r0 * kstride + c) =
          pack_bf16(dka[nd][0] * scale, dka[nd][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + r0 * kstride + c) =
          pack_bf16(dva[nd][0], dva[nd][1]);
    }
    if (r1 < Lk) {
      *reinterpret_cast<uint32_t*>(dk + base + r1 * kstride + c) =
          pack_bf16(dka[nd][2] * scale, dka[nd][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + r1 * kstride + c) =
          pack_bf16(dva[nd][2], dva[nd][3]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           const void* dout, const float* lse, const float* delta, void* dq,
           void* dk, void* dv, int B, int Lq, int Lk, int H, int KVH, int causal,
           int is_bf16, float scale, cudaStream_t st) {
  if (is_bf16) {
    using T = __nv_bfloat16;
    dim3 gq((Lq + BR - 1) / BR, B * H), gk((Lk + BR - 1) / BR, B * KVH);
    bwd_dq_bf16<D><<<gq, THREADS, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, mask, (const T*)dout, lse, delta,
        (T*)dq, Lq, Lk, H, KVH, causal, scale);
    constexpr int smem = dkv_bf16_smem_bytes<D>();
    fa::allow_max_smem<bwd_dkv_bf16<D>>();
    bwd_dkv_bf16<D><<<gk, THREADS, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, mask, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, Lq, Lk, H, KVH, causal, scale);
  } else {
    const size_t smem = f32_smem_bytes<D>((Lk + 31) / 32);
    if (smem > fa::MAX_SMEM) return (int)cudaErrorInvalidValue;
    const int n_dkv = ((Lk + FR - 1) / FR) * B * KVH;
    const int blocks = n_dkv + ((Lq + FR - 1) / FR) * B * H;
    fa::allow_max_smem<bwd_dq_dkv_f32<D>>();
    bwd_dq_dkv_f32<D><<<blocks, THREADS, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, mask, (const float*)dout,
        lse, delta, (float*)dq, (float*)dk, (float*)dv, Lq, Lk, H, KVH, causal, scale, n_dkv);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq (B, Lq, H, D); k, v, dk, dv (B, Lk, KVH, D), all contiguous,
// bf16 when is_bf16 else f32; mask (B, Lk) f32 or null (1 = attend); lse and
// delta (B, H, Lq) f32. D is 64 or 128 and KVH divides H. Launches the dQ
// and dK/dV kernels on `stream` (bf16: one after the other; float32: one
// launch of both); returns cudaGetLastError(), or cudaErrorInvalidValue for
// a shape it does not take.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* mask, const void* dout, const void* lse,
                              const void* delta, void* dq, void* dk, void* dv,
                              int B, int Lq, int Lk, int H, int KVH, int D,
                              int causal, int is_bf16, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* m = (const float*)mask;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (D == 64)
    return launch<64>(q, k, v, m, dout, l, dl, dq, dk, dv, B, Lq, Lk, H, KVH, causal,
                      is_bf16, scale, st);
  if (D == 128)
    return launch<128>(q, k, v, m, dout, l, dl, dq, dk, dv, B, Lq, Lk, H, KVH, causal,
                       is_bf16, scale, st);
  return (int)cudaErrorInvalidValue;
}
