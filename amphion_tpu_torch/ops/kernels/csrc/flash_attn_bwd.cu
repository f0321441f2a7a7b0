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
// outside its kernels, l.1016). Two kernels, as in JAX:
//  * dQ: one block per (batch*head, query tile), looping over key tiles;
//  * dK/dV: one block per (batch*kv-head, key tile), looping over query
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
// D-long dot products or updates, 10*D operations (half of the pairs when
// causal), against q, k, v, o, dO, dq, dk, dv and the LSE read or written
// once. At the Vevo training shapes (FM (8, 256, 16, 64), AR (8, 516, 20,
// 64) causal) that is 5.4 and 13.7 GFLOP against 67 and 169 MB, so the
// operations bound it: in float32 (the trainers' type) at 67 TFLOP/s about
// 0.08 and 0.20 ms, in bf16 on the tensor cores a fifteenth of that.
//  * float32: plain FMAs (no TF32, as the forward's f32 branch), four
//    threads per query row (dQ) or key row (dK/dV) splitting D; the other
//    side's tile streams through shared memory and every thread of a row
//    group reads the same element (a broadcast).
//  * bf16: mma.sync m16n8k16 with float32 accumulation, 4 warps of 16
//    rows; the operand tiles sit in shared memory (rows padded by 16 bytes)
//    and ldmatrix reads the fragments; P and dS go from the accumulators
//    straight into A fragments, as P does in the forward.
// Still simple: one shared-memory stage, no TMA, no wgmma, no fusion of the
// two kernels; that is where a faster version goes next.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

// ------------------------------------------------------------- float32 path

constexpr int FR = 32;  // rows of a block (4 threads each)
constexpr int FT = 32;  // rows of a streamed tile

// dQ for 32 query rows of one (b, h); key tiles of 32 through shared memory.
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ mask,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dq, int Lq,
           int Lk, int H, int KVH, int causal, float scale) {
  constexpr int DT = D / 4;  // dims per thread: d = 4 * i + t
  __shared__ __align__(16) float Ks[FT * D];
  __shared__ __align__(16) float Vs[FT * D];
  __shared__ float Ms[FT];

  const int b = (int)blockIdx.y / H, h = (int)blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int t = threadIdx.x & 3;
  const int q0 = (int)blockIdx.x * FR;
  const int row = q0 + (int)(threadIdx.x >> 2);
  const size_t qstride = (size_t)H * D, kstride = (size_t)KVH * D;
  const float* qb = q + (size_t)b * Lq * qstride + (size_t)h * D;
  const float* gb = dout + (size_t)b * Lq * qstride + (size_t)h * D;
  const float* kb = k + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const float* vb = v + (size_t)b * Lk * kstride + (size_t)kvh * D;

  float qv[DT], gv[DT], acc[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    qv[i] = row < Lq ? qb[row * qstride + 4 * i + t] : 0.f;
    gv[i] = row < Lq ? gb[row * qstride + 4 * i + t] : 0.f;
    acc[i] = 0.f;
  }
  const size_t srow = ((size_t)b * H + h) * Lq + row;
  const float lrow = row < Lq ? lse[srow] : 0.f;
  const float drow = row < Lq ? delta[srow] : 0.f;

  int n_tiles = (Lk + FT - 1) / FT;
  if (causal) n_tiles = min(n_tiles, (q0 + FR + FT - 1) / FT);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FT;
    __syncthreads();
    for (int c = threadIdx.x; c < FT * D / 4; c += THREADS) {
      const int r = c / (D / 4), cc = (c % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < Lk) {
        kv = *reinterpret_cast<const float4*>(kb + (size_t)(k0 + r) * kstride + cc);
        vv = *reinterpret_cast<const float4*>(vb + (size_t)(k0 + r) * kstride + cc);
      }
      *reinterpret_cast<float4*>(&Ks[r * D + cc]) = kv;
      *reinterpret_cast<float4*>(&Vs[r * D + cc]) = vv;
    }
    for (int c = threadIdx.x; c < FT; c += THREADS) {
      const int key = k0 + c;
      Ms[c] = (key < Lk && (mask == nullptr || mask[(size_t)b * Lk + key] > 0.f))
                  ? 1.f : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < FT; ++jj) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        s = fmaf(qv[i], Ks[jj * D + 4 * i + t], s);
        dp = fmaf(gv[i], Vs[jj * D + 4 * i + t], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const bool ok = Ms[jj] > 0.f && (!causal || k0 + jj <= row);
      const float p = ok ? expf(s * scale - lrow) : 0.f;
      const float ds = p * (dp - drow);
#pragma unroll
      for (int i = 0; i < DT; ++i) acc[i] = fmaf(ds, Ks[jj * D + 4 * i + t], acc[i]);
    }
  }
  if (row < Lq) {
    float* ob = dq + (size_t)b * Lq * qstride + (size_t)h * D + row * qstride;
#pragma unroll
    for (int i = 0; i < DT; ++i) ob[4 * i + t] = acc[i] * scale;
  }
}

// dK and dV for 32 key rows of one (b, kv-head): query tiles of 32 of every
// query head of the group through shared memory.
template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ mask,
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk,
            float* __restrict__ dv, int Lq, int Lk, int H, int KVH, int causal,
            float scale) {
  constexpr int DT = D / 4;
  __shared__ __align__(16) float Qs[FT * D];
  __shared__ __align__(16) float Gs[FT * D];
  __shared__ float Ls[FT], Ds[FT];

  const int b = (int)blockIdx.y / KVH, kvh = (int)blockIdx.y % KVH;
  const int rep = H / KVH;
  const int t = threadIdx.x & 3;
  const int k0 = (int)blockIdx.x * FR;
  const int key = k0 + (int)(threadIdx.x >> 2);
  const size_t qstride = (size_t)H * D, kstride = (size_t)KVH * D;
  const float* kb = k + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const float* vb = v + (size_t)b * Lk * kstride + (size_t)kvh * D;
  const bool key_ok = key < Lk && (mask == nullptr || mask[(size_t)b * Lk + key] > 0.f);

  float kv[DT], vv[DT], dka[DT], dva[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    kv[i] = key < Lk ? kb[key * kstride + 4 * i + t] : 0.f;
    vv[i] = key < Lk ? vb[key * kstride + 4 * i + t] : 0.f;
    dka[i] = dva[i] = 0.f;
  }

  const int first = causal ? k0 / FT : 0;  // query rows below k0 see no key here
  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const float* qb = q + (size_t)b * Lq * qstride + (size_t)h * D;
    const float* gb = dout + (size_t)b * Lq * qstride + (size_t)h * D;
    const size_t sb = ((size_t)b * H + h) * Lq;
    for (int i0 = first * FT; i0 < Lq; i0 += FT) {
      __syncthreads();
      for (int c = threadIdx.x; c < FT * D / 4; c += THREADS) {
        const int rr = c / (D / 4), cc = (c % (D / 4)) * 4;
        float4 qq = make_float4(0.f, 0.f, 0.f, 0.f), gg = qq;
        if (i0 + rr < Lq) {
          qq = *reinterpret_cast<const float4*>(qb + (size_t)(i0 + rr) * qstride + cc);
          gg = *reinterpret_cast<const float4*>(gb + (size_t)(i0 + rr) * qstride + cc);
        }
        *reinterpret_cast<float4*>(&Qs[rr * D + cc]) = qq;
        *reinterpret_cast<float4*>(&Gs[rr * D + cc]) = gg;
      }
      for (int c = threadIdx.x; c < FT; c += THREADS) {
        Ls[c] = i0 + c < Lq ? lse[sb + i0 + c] : 0.f;
        Ds[c] = i0 + c < Lq ? delta[sb + i0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int ii = 0; ii < FT; ++ii) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          s = fmaf(kv[i], Qs[ii * D + 4 * i + t], s);
          dp = fmaf(vv[i], Gs[ii * D + 4 * i + t], dp);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 2);
        const int row = i0 + ii;
        const bool ok = key_ok && row < Lq && (!causal || key <= row);
        const float p = ok ? expf(s * scale - Ls[ii]) : 0.f;
        const float ds = p * (dp - Ds[ii]);
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          dva[i] = fmaf(p, Gs[ii * D + 4 * i + t], dva[i]);
          dka[i] = fmaf(ds, Qs[ii * D + 4 * i + t], dka[i]);
        }
      }
    }
  }
  if (key < Lk) {
    const size_t off = (size_t)b * Lk * kstride + (size_t)kvh * D + key * kstride;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      dk[off + 4 * i + t] = dka[i] * scale;
      dv[off + 4 * i + t] = dva[i];
    }
  }
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
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
void launch(const void* q, const void* k, const void* v, const float* mask,
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
    cudaFuncSetAttribute(bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    bwd_dkv_bf16<D><<<gk, THREADS, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, mask, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, Lq, Lk, H, KVH, causal, scale);
  } else {
    dim3 gq((Lq + FR - 1) / FR, B * H), gk((Lk + FR - 1) / FR, B * KVH);
    bwd_dq_f32<D><<<gq, THREADS, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, mask, (const float*)dout,
        lse, delta, (float*)dq, Lq, Lk, H, KVH, causal, scale);
    bwd_dkv_f32<D><<<gk, THREADS, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, mask, (const float*)dout,
        lse, delta, (float*)dk, (float*)dv, Lq, Lk, H, KVH, causal, scale);
  }
}

}  // namespace

// q, dout, dq (B, Lq, H, D); k, v, dk, dv (B, Lk, KVH, D), all contiguous,
// bf16 when is_bf16 else f32; mask (B, Lk) f32 or null (1 = attend); lse and
// delta (B, H, Lq) f32. D is 64 or 128 and KVH divides H. Launches the dQ
// kernel, then the dK/dV kernel, on `stream`; returns cudaGetLastError().
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
    launch<64>(q, k, v, m, dout, l, dl, dq, dk, dv, B, Lq, Lk, H, KVH, causal, is_bf16,
               scale, st);
  else if (D == 128)
    launch<128>(q, k, v, m, dout, l, dl, dq, dk, dv, B, Lq, Lk, H, KVH, causal, is_bf16,
                scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
