// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_attention_kernel` /
// `flash_attention_pallas` (amphion_tpu/ops/pallas_kernels.py:702-866):
// online-softmax attention with GQA, an optional key mask (B, Lk), causal
// tile skipping and an optional log-sum-exp output, without writing the
// (Lq, Lk) score matrix to device memory.
//
// Semantics kept from the Pallas kernel: masked scores are -1e30 and their
// probabilities are forced to 0 (pallas_kernels.py:745-747); the output is
// acc / max(l, 1e-30), so a row whose keys are all masked stays finite (0);
// causal masking is col <= row from the top-left corner; the running max,
// sum and accumulator are float32 whatever the input type.
//
// What bounds it on the H100: attention does 4 D operations per attended
// (query, key) pair against q, k, v and o read or written once, far above
// the memory line at every shape the paths use. So the tensor cores bound
// it: at the timbre serving shape (4, 1536, 16, 64) bf16 with its key mask,
// 38.6 GFLOP over 989 TFLOP/s is 0.039 ms; in float32 at the training
// shapes (FM (8, 256, 16, 64), AR (8, 516, 20, 64) causal) 2.1 and 4.9
// GFLOP, 0.032 / 0.074 ms at the 67 TFLOP/s FMA rate, or 0.013 / 0.030 ms
// as three TF32 products at the 495 TFLOP/s TF32 rate.
//
// Both designs skip the key tiles past the last key that counts (one ballot
// over the block's key-mask row into shared bits at the start), so a ragged
// key mask costs only the keys it keeps, and read the per-tile mask from
// those bits: an all-ones tile skips the masking altogether.
//  * bf16 (serving): wgmma with TMA. A block of two consumer warpgroups
//    owns 128 query rows (64 each); a producer warp loads Q and a ring of
//    three K/V stages of 64 keys by TMA (cp.async.bulk.tensor over 4-D
//    maps {D, heads, L, B} with a {64, 1, 64, 1} box, 128-byte swizzled;
//    the L tail is zero-filled and never reaches the next batch's rows;
//    D = 128 takes two boxes per tile). Each stage has a "full" mbarrier
//    (the TMA's bytes landed) and an "empty" one (every consumer warp is
//    past it), so the warpgroups never meet at a block barrier and drift
//    out of phase: one's softmax overlaps the other's products (a block
//    barrier every tile took twice the time). S = Q K^T runs on wgmma
//    m64n64k16 with both operands in shared memory (K-major); O += P V on
//    wgmma m64n64k16 with P in registers, converted from the S accumulator
//    to bf16 A fragments, and V read through the B-transpose bit. The
//    softmax works in log2 units on the SFU's 2^x.
//  * float32 (training): the products on the tensor cores in split TF32
//    (flash_common.cuh: three TF32 products per product, float32 accuracy),
//    mma.sync m16n8k8. A block of 4 warps owns 64 query rows (16 a warp),
//    Q in shared memory, split as its A fragments are loaded; K/V tiles of
//    32 keys stream through two cp.async stages and each warp splits its B
//    fragments in registers. P goes from the S accumulator into the A
//    fragments of P V without shuffles (keys permuted inside each k-step,
//    flash_common.cuh). What bounds it now is instruction issue (the
//    splits), not the tensor cores.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using fa::ex2;
using fa::NEG;
using fa::smem_addr;
using hop::desc_sw128;
using hop::fence_regs;
using hop::mbar_arrive;
using hop::mbar_expect_tx;
using hop::mbar_init;
using hop::mbar_wait;
using hop::wgmma_commit;
using hop::wgmma_fence;
using hop::wgmma_rs;
using hop::wgmma_ss;
using hop::wgmma_wait_all;

// ------------------------------------------------------------- float32 path

constexpr int FQ = 64;   // query rows per block: 4 warps x 16
constexpr int FK = 32;   // keys per tile (one word of key bits)
constexpr int FTHREADS = 128;

template <int D>
size_t f32_smem_bytes(int nwords) {  // Q, two stages of K and V, key bits
  return (size_t)(FQ + 4 * FK) * fa::f32_pitch<D>() * 4 + (size_t)nwords * 4;
}

template <int D>
__global__ void __launch_bounds__(FTHREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              float* __restrict__ o, float* __restrict__ lse, int Lq, int Lk,
              int H, int KVH, int causal, float scale) {
  constexpr int P = fa::f32_pitch<D>();
  constexpr int TILE = FK * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [FQ][P]
  float* Ks = Qs + FQ * P;                         // [2][TILE]
  float* Vs = Ks + 2 * TILE;                       // [2][TILE]
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + 2 * TILE);

  const int b = (int)blockIdx.y / H, h = (int)blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int q0 = (int)blockIdx.x * FQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;                       // this warp's first row in the tile
  const int r0 = q0 + row0 + g, r1 = r0 + 8;        // this lane's two rows
  const size_t qstride = (size_t)H * D, kstride = (size_t)KVH * D;
  const float* qb = q + (size_t)b * Lq * qstride + (size_t)h * D;
  const float* kb = k + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const float* vb = v + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const int nwords = (Lk + 31) / 32;

  fa::load_rows_f32<D>(Qs, qb, qstride, q0, FQ, Lq);
  fa::cp_async_commit();
  fa::key_bits(bits, nwords, mask == nullptr ? nullptr : mask + (size_t)b * Lk, Lk);
  fa::cp_async_wait<0>();
  __syncthreads();
  int n_tiles = (fa::last_key(bits, nwords) + FK) / FK;
  if (causal) n_tiles = min(n_tiles, (q0 + FQ + FK - 1) / FK);

  auto load_tile = [&](int j, int buf) {
    fa::load_rows_f32<D>(Ks + buf * TILE, kb, kstride, j * FK, FK, Lk);
    fa::load_rows_f32<D>(Vs + buf * TILE, vb, kstride, j * FK, FK, Lk);
    fa::cp_async_commit();
  };

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // running max (raw scores) and sum
  const float sl2 = scale * fa::LOG2E;            // scores in log2 units

  if (n_tiles > 0) load_tile(0, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FK, buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(j + 1, buf ^ 1);
      fa::cp_async_wait<1>();
    } else {
      fa::cp_async_wait<0>();
    }
    __syncthreads();  // this stage is visible
    const float* Kt = Ks + buf * TILE;
    const float* Vt = Vs + buf * TILE;

    // S = Q K^T, 16 rows x 32 keys per warp
    float s[FK / 8][4];
#pragma unroll
    for (int jn = 0; jn < FK / 8; ++jn) s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const fa::FragA a = fa::load_a<D>(Qs, row0, kk, g, t);
      fa::mma_3xtf32_x4(s, a, Kt + g * P + kk * 8 + t, 8 * P, 4);
    }

    // mask and running max on the raw scores, then p = 2^((s - max) scale
    // log2 e), 0 where masked
    const uint32_t word = bits[j];
    const bool full = word == 0xffffffffu && (!causal || k0 + FK - 1 <= q0 + row0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int jn = 0; jn < FK / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = jn * 8 + 2 * t + e, col = k0 + cl;
        if (!full) {
          const bool ok = (word >> cl) & 1u;
          if (!(ok && (!causal || col <= r0))) s[jn][e] = NEG;
          if (!(ok && (!causal || col <= r1))) s[jn][2 + e] = NEG;
        }
        mx0 = fmaxf(mx0, s[jn][e]);
        mx1 = fmaxf(mx1, s[jn][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float a0 = ex2((m0 - mx0) * sl2), a1 = ex2((m1 - mx1) * sl2);
    const float b0 = mx0 * sl2, b1 = mx1 * sl2;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int jn = 0; jn < FK / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = s[jn][e] == NEG ? 0.f : ex2(fmaf(s[jn][e], sl2, -b0));
        const float p1 = s[jn][2 + e] == NEG ? 0.f : ex2(fmaf(s[jn][2 + e], sl2, -b1));
        s[jn][e] = p0;
        s[jn][2 + e] = p1;
        l0 += p0;
        l1 += p1;
      }
    }
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= a0; acc[nd][1] *= a0;
      acc[nd][2] *= a1; acc[nd][3] *= a1;
    }

    // O += P V: k-step kk takes keys 8 kk + 2t (k index t) and 8 kk + 2t + 1
    // (k index t + 4), so the S accumulator is the A fragment as it stands
#pragma unroll
    for (int kk = 0; kk < FK / 8; ++kk) {
      const fa::FragA pa = fa::acc_to_a(s[kk]);
      const float* vp = Vt + (kk * 8 + 2 * t) * P + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 8)
        fa::mma_3xtf32_2x4(acc + nd, pa, vp + nd * 8, acc + nd + 4, pa, vp + nd * 8 + 32, 8, P);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float* ob = o + (size_t)b * Lq * qstride + (size_t)h * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<float2*>(ob + r0 * qstride + c) = make_float2(acc[nd][0] / d0, acc[nd][1] / d0);
    if (r1 < Lq)
      *reinterpret_cast<float2*>(ob + r1 * qstride + c) = make_float2(acc[nd][2] / d1, acc[nd][3] / d1);
  }
  if (lse != nullptr && t == 0) {  // natural-log LSE; -1e30 for a row with no key
    float* lb = lse + ((size_t)b * H + h) * Lq;
    if (r0 < Lq) lb[r0] = (m0 == NEG ? NEG : m0 * scale) + logf(d0);
    if (r1 < Lq) lb[r1] = (m1 == NEG ? NEG : m1 * scale) + logf(d1);
  }
}

// ---------------------------------------------------------------- bf16 path

constexpr int BQ = 128;      // query rows per block: 2 warpgroups x 64
constexpr int BK = 64;       // keys per tile (two words of key bits)
constexpr int STAGES = 3;    // K/V ring
constexpr int THREADS = 288;  // two consumer warpgroups and one producer warp
constexpr int BOX = 64 * 64 * 2;  // bytes of one TMA box: 64 rows x 64 bf16, 128B-swizzled

template <int D>
struct Bf16Layout {  // byte offsets from a 1024-aligned base
  static constexpr int NB = D / 64;                  // boxes per row tile
  static constexpr int Q = 0;                        // [2 warpgroups][NB] boxes
  static constexpr int K = Q + 2 * NB * BOX;          // [STAGES][NB]
  static constexpr int V = K + STAGES * NB * BOX;     // [STAGES][NB]
  static constexpr int BAR = V + STAGES * NB * BOX;   // Q barrier, full and empty per stage
  static constexpr int BITS = BAR + 8 * (1 + 2 * STAGES);
  static size_t bytes(int nwords) { return 1024 + BITS + (size_t)nwords * 4; }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const float* __restrict__ mask,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Lq, int Lk,
               int H, int KVH, int causal, float scale) {
  using L = Bf16Layout<D>;
  constexpr int NB = L::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_addr(base);
  const uint32_t qbar = sbase + L::BAR;             // Q landed
  const uint32_t full = qbar + 8;                   // [STAGES]: K/V tile landed
  const uint32_t empty = full + 8 * STAGES;         // [STAGES]: both warpgroups are past it
  uint32_t* bits = reinterpret_cast<uint32_t*>(base + L::BITS);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = (int)blockIdx.y / H, h = (int)blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int q0 = (int)blockIdx.x * BQ;
  const int nwords = 2 * ((Lk + BK - 1) / BK);

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  fa::key_bits(bits, nwords, mask == nullptr ? nullptr : mask + (size_t)b * Lk, Lk);
  __syncthreads();
  int n_tiles = (fa::last_key(bits, nwords) + BK) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ + BK - 1) / BK);

  if (wg == 2) {  // the producer warp: Q, then K/V tiles into the ring
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * NB * BOX);
      for (int w = 0; w < 2; ++w)
        for (int nb = 0; nb < NB; ++nb)
          hop::tma_load_4d(sbase + L::Q + (w * NB + nb) * BOX, &tq, nb * 64, h, q0 + w * 64, b, qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty + 8 * s, (j / STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * NB * BOX);
        for (int nb = 0; nb < NB; ++nb) {
          hop::tma_load_4d(sbase + L::K + (s * NB + nb) * BOX, &tk, nb * 64, kvh, j * BK, b, full + 8 * s);
          hop::tma_load_4d(sbase + L::V + (s * NB + nb) * BOX, &tv, nb * 64, kvh, j * BK, b, full + 8 * s);
        }
      }
    }
    return;
  }

  // the consumer warpgroups: 64 query rows each
  const int wrow = q0 + wg * 64 + warp * 16;  // this warp's first query row
  const int r0 = wrow + g, r1 = r0 + 8;        // this lane's two rows
  const float sl2 = scale * fa::LOG2E;  // scores in log2 units
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // running max (raw scores) and sum
  const uint32_t qs = sbase + L::Q + wg * NB * BOX;
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES, k0 = j * BK;
    mbar_wait(full + 8 * s, (j / STAGES) & 1);
    const uint32_t ks = sbase + L::K + s * NB * BOX, vs = sbase + L::V + s * NB * BOX;

    // S = Q K^T: 64 rows x 64 keys per warpgroup, D / 16 k16 steps
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
      wgmma_ss(sc, desc_sw128(qs + off, 16), desc_sw128(ks + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // mask and running max on the raw scores; accumulator chunk i (keys
    // 8i..8i+7) holds (r0, 8i + 2t + e) in sc[4i + e], (r1, ...) in sc[4i + 2 + e]
    const uint32_t w0 = bits[2 * j], w1 = bits[2 * j + 1];
    const bool all = (w0 & w1) == 0xffffffffu && (!causal || k0 + BK - 1 <= wrow);
    float mx0 = m0, mx1 = m1;
    if (!all) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 8 * i + 2 * t + e, col = k0 + cl;
          const bool ok = ((i < 4 ? w0 : w1) >> (cl & 31)) & 1u;
          if (!(ok && (!causal || col <= r0))) sc[4 * i + e] = NEG;
          if (!(ok && (!causal || col <= r1))) sc[4 * i + 2 + e] = NEG;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // p = 2^((s - max) scale log2 e), 0 where masked
    const float a0 = ex2((m0 - mx0) * sl2), a1 = ex2((m1 - mx1) * sl2);
    const float b0 = mx0 * sl2, b1 = mx1 * sl2;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x0 = sc[4 * i + e];
        float& x1 = sc[4 * i + 2 + e];
        x0 = x0 == NEG ? 0.f : ex2(fmaf(x0, sl2, -b0));
        x1 = x1 == NEG ? 0.f : ex2(fmaf(x1, sl2, -b1));
        l0 += x0;
        l1 += x1;
      }
    }
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[nb][4 * i] *= a0; acc[nb][4 * i + 1] *= a0;
        acc[nb][4 * i + 2] *= a1; acc[nb][4 * i + 3] *= a1;
      }
    }

    // O += P V: chunks 2kk and 2kk + 1 of S are the bf16 A fragment of
    // k16 step kk (keys 16 kk ... 16 kk + 15, rows 16 kk ... of the V box)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_rs(acc[nb], pa[kk], desc_sw128(vs + nb * BOX + kk * 2048, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with stage s
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const size_t qstride = (size_t)H * D;
  __nv_bfloat16* ob = o + (size_t)b * Lq * qstride + (size_t)h * D;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = nb * 64 + 8 * i + 2 * t;
      if (r0 < Lq)
        *reinterpret_cast<uint32_t*>(ob + r0 * qstride + c) =
            pack_bf16(acc[nb][4 * i] / d0, acc[nb][4 * i + 1] / d0);
      if (r1 < Lq)
        *reinterpret_cast<uint32_t*>(ob + r1 * qstride + c) =
            pack_bf16(acc[nb][4 * i + 2] / d1, acc[nb][4 * i + 3] / d1);
    }
  }
  if (lse != nullptr && t == 0) {  // natural-log LSE; -1e30 for a row with no key
    float* lb = lse + ((size_t)b * H + h) * Lq;
    if (r0 < Lq) lb[r0] = (m0 == NEG ? NEG : m0 * scale) + logf(d0);
    if (r1 < Lq) lb[r1] = (m1 == NEG ? NEG : m1 * scale) + logf(d1);
  }
}

// ------------------------------------------------------------------- host

// A (B, L, heads, D) bf16 tensor as a 4-D map {D, heads, L, B}; box
// {64, 1, 64, 1}, 128-byte swizzle, zeros outside.
bool make_map(CUtensorMap* map, const void* ptr, int B, int L, int heads, int D) {
  hop::EncodeTiled enc = hop::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)L * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1}, estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* mask, void* o,
           float* lse, int B, int Lq, int Lk, int H, int KVH, int causal, int is_bf16,
           float scale, cudaStream_t st) {
  if (is_bf16) {
    const size_t smem = Bf16Layout<D>::bytes(2 * ((Lk + BK - 1) / BK));
    if (smem > fa::MAX_SMEM) return (int)cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    if (!make_map(&tq, q, B, Lq, H, D) || !make_map(&tk, k, B, Lk, KVH, D) ||
        !make_map(&tv, v, B, Lk, KVH, D))
      return (int)cudaErrorInvalidValue;
    fa::allow_max_smem<flash_fwd_bf16<D>>();
    dim3 grid((Lq + BQ - 1) / BQ, B * H);
    flash_fwd_bf16<D><<<grid, THREADS, smem, st>>>(tq, tk, tv, mask, (__nv_bfloat16*)o, lse,
                                                   Lq, Lk, H, KVH, causal, scale);
  } else {
    const size_t smem = f32_smem_bytes<D>((Lk + FK - 1) / FK);
    if (smem > fa::MAX_SMEM) return (int)cudaErrorInvalidValue;
    fa::allow_max_smem<flash_fwd_f32<D>>();
    dim3 grid((Lq + FQ - 1) / FQ, B * H);
    flash_fwd_f32<D><<<grid, FTHREADS, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, mask, (float*)o, lse, Lq, Lk, H,
        KVH, causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, o (B, Lq, H, D); k, v (B, Lk, KVH, D), all contiguous and 16-byte
// aligned, bf16 when is_bf16 else f32; mask (B, Lk) f32 or null (1 = attend);
// lse (B, H, Lq) f32 or null. D is 64 or 128 and KVH divides H. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it does not take
// (a tensor map the driver refuses, Lk too long for the key bits).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* mask, void* o, void* lse, int B,
                              int Lq, int Lk, int H, int KVH, int D, int causal,
                              int is_bf16, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* m = (const float*)mask;
  if (D == 64)
    return launch<64>(q, k, v, m, o, (float*)lse, B, Lq, Lk, H, KVH, causal, is_bf16, scale, st);
  if (D == 128)
    return launch<128>(q, k, v, m, o, (float*)lse, B, Lq, Lk, H, KVH, causal, is_bf16, scale, st);
  return (int)cudaErrorInvalidValue;
}
