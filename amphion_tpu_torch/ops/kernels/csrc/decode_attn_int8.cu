// Single-query attention over the head-major int8 KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_attn_int8_kernel` /
// `decode_attention_int8` (amphion_tpu/ops/pallas_kernels.py:1150-1223).
// Per (b, h): scores s_j = (q . k_int[j]) * ks[j] * (1/sqrt(D)), the scale
// applied after the dot; s_j = -inf for positions j >= valid_len[b]; a
// float32 softmax; out = sum_j p_j * vs[j] * v_int[j].
// q (B, H, D) f32; ck, cv (B, H, S, D) int8; ks, vs (B, H, S) f32.
//
// What bounds it on the H100: one decode step reads the valid part of the
// cache once, 2 * len * D int8 bytes per (b, h) plus the scales, and does
// about 4 * len * D operations on them: about two per byte, so bytes bound
// it. At the decode's B = 1, H = 20, D = 64, len ~ 900 that is 2.4 MB, under
// a microsecond at the card's rate: what costs is latency (a launch, a DRAM
// round trip, the merge of the row's pieces), so the design spends one
// launch and one round trip:
//  * one launch: a thread-block cluster of RANKS blocks per (b, h) row. The
//    blocks split [0, valid_len[b]) on the device into equal shares of whole
//    groups of 4 positions, so the split follows the live length at every
//    step while the grid stays fixed (a CUDA graph can replay it); a block
//    whose share is empty still reports (m = -inf, l = 0);
//  * every byte of a block's share is requested before any compute: lane
//    (position p, part) loads 16 bytes of K row p and of V row p and both
//    scales, NR positions a lane, all issued at once (a chunk; a longer
//    share loops over chunks with a running max);
//  * scores: D / 16 lanes per position, each a 16-wide slice of the dot
//    with the int8 -> float conversion by byte permutation into 2^23 + u
//    (exact), the slices added by shuffles; each warp keeps its running max
//    m, sum l of exp(s - m) and its lanes' slices of sum exp(s - m) vs v;
//  * merge in a fixed order: the warps' (m, l, acc) in warp order in
//    shared memory, then each block's into rank 0's shared memory by
//    st.async onto an mbarrier there, added in rank order: no atomics, no
//    scratch, no second launch, and a relaunch gives the same bits.
// Chosen by timing the alternatives (tools/kernel_ab.py, one decode step's
// 24 caches at valid_len 888 on the H100): 4 ranks of 256 threads 4.86 us
// a call, 8 of 128 5.16, 2 of 512 6.26; each block's share staged in
// shared memory by cp.async.bulk instead of register loads 5.21 (4 ranks)
// and 5.01 (8 ranks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using hop::cluster_addr;
using hop::cluster_arrive_relaxed;
using hop::cluster_rank;
using hop::cluster_wait;
using hop::mbar_expect_tx;
using hop::mbar_init;
using hop::mbar_wait;
using hop::st_async;
using hop::st_async4;

constexpr int RANKS = 4;    // blocks of a row's cluster
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 4;    // a share is whole groups of this many positions (D = 64: 256 bytes,
                            // so each block's rows start on a 128-byte line)
constexpr int NR = 5;       // positions a lane has in flight (a chunk)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The four int8 values of w as exact floats: each byte, offset by 128,
// becomes the low byte of the float 2^23 + u, less 2^23 + 128.
__device__ __forceinline__ void int8x4(uint32_t w, float (&v)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  v[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  v[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  v[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  v[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

template <int D>
__global__ void __cluster_dims__(RANKS, 1, 1) __launch_bounds__(THREADS)
decode_attn(const float* __restrict__ q, const int8_t* __restrict__ ck,
            const int8_t* __restrict__ cv, const float* __restrict__ ks,
            const float* __restrict__ vs, const int* __restrict__ valid_len,
            float* __restrict__ o, int H, int S, float scale) {
  constexpr int LPP = D / 16;          // lanes per position, 16 dims each
  constexpr int PPW = 32 / LPP;        // positions per warp and round
  constexpr int PPB = WARPS * PPW;     // positions per block and round
  constexpr int CHUNK = NR * PPB;      // positions per block in flight
  __shared__ __align__(8) uint64_t bar;
  __shared__ __align__(16) float wacc[WARPS][D];
  __shared__ float wml[WARPS][2];
  __shared__ __align__(16) float parts[RANKS][D];  // rank 0: the blocks' V sums
  __shared__ float pml[RANKS][2];                  // and their (m, l)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = cluster_rank();
  const int bh = blockIdx.y, b = bh / H;
  const int pw = lane / LPP, part = lane % LPP;
  const uint32_t sbar = smem_addr(&bar);
  if (tid == 0) {
    mbar_init(sbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (rank == 0) mbar_expect_tx(sbar, (RANKS - 1) * (D + 2) * 4);
  }
  // once this phase completes, every block's barrier is ready to be sent to
  cluster_arrive_relaxed();

  // this block's share of [0, len): equal, in whole groups of GROUP
  const int len = max(0, min(valid_len[b], S));
  const int per = (len + GROUP * RANKS - 1) / (GROUP * RANKS) * GROUP;
  const int lo = min(rank * per, len), hi = min(lo + per, len);

  const int8_t* kb = ck + (size_t)bh * S * D + part * 16;
  const int8_t* vb = cv + (size_t)bh * S * D + part * 16;
  const float* ksb = ks + (size_t)bh * S;
  const float* vsb = vs + (size_t)bh * S;
  float qv[16];
  {
    const float4* qp = reinterpret_cast<const float4*>(q + (size_t)bh * D + part * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = qp[i];
      qv[4 * i] = t.x; qv[4 * i + 1] = t.y; qv[4 * i + 2] = t.z; qv[4 * i + 3] = t.w;
    }
  }

  float m = -INFINITY, l = 0.f, acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int base = lo; base < hi; base += CHUNK) {
    // the chunk's bytes, all requested at once
    uint4 kr[NR], vr[NR];
    float ksr[NR], vsr[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int j = base + r * PPB + warp * PPW + pw;
      if (j < hi) {
        kr[r] = *reinterpret_cast<const uint4*>(kb + (size_t)j * D);
        vr[r] = *reinterpret_cast<const uint4*>(vb + (size_t)j * D);
        ksr[r] = ksb[j];
        vsr[r] = vsb[j];
      } else {
        kr[r] = vr[r] = make_uint4(0u, 0u, 0u, 0u);
        ksr[r] = vsr[r] = 0.f;
      }
    }
    // scores: the lane's 16-wide slice, then the position's slices added
    float s[NR], cm = -INFINITY;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const uint32_t w4[4] = {kr[r].x, kr[r].y, kr[r].z, kr[r].w};
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v[4];
        int8x4(w4[c], v);
#pragma unroll
        for (int e = 0; e < 4; ++e) a = fmaf(qv[4 * c + e], v[e], a);
      }
#pragma unroll
      for (int off = 1; off < LPP; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      const int j = base + r * PPB + warp * PPW + pw;
      s[r] = j < hi ? a * ksr[r] * scale : -INFINITY;
      cm = fmaxf(cm, s[r]);
    }
#pragma unroll
    for (int off = LPP; off < 32; off <<= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, off));
    const float mn = fmaxf(m, cm);
    if (mn == -INFINITY) continue;  // nothing of this chunk is the warp's
    const float rescale = __expf(m - mn);
    m = mn;
    l *= rescale;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= rescale;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float p = s[r] == -INFINITY ? 0.f : __expf(s[r] - m);
      l += p;
      const float w = p * vsr[r];
      const uint32_t w4[4] = {vr[r].x, vr[r].y, vr[r].z, vr[r].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v[4];
        int8x4(w4[c], v);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * c + e] = fmaf(w, v[e], acc[4 * c + e]);
      }
    }
  }
  // the warp's positions added: lanes of one part hold one slice of D, and
  // every lane of a position the same p
#pragma unroll
  for (int off = LPP; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (lane < LPP) {
#pragma unroll
    for (int i = 0; i < 16; i += 4)
      *reinterpret_cast<float4*>(&wacc[warp][16 * lane + i]) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    if (lane == 0) {
      wml[warp][0] = m;
      wml[warp][1] = l;
    }
  }
  __syncthreads();

  // the block's (m, l, acc): its warps merged in warp order; rank 0 keeps
  // its own, the others send theirs into rank 0's shared memory
  float bm = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) bm = fmaxf(bm, wml[w][0]);
  cluster_wait();  // rank 0's barrier is ready
  if (tid < D / 4) {
    float num[4] = {0.f, 0.f, 0.f, 0.f}, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (wml[w][0] == -INFINITY) continue;
      const float a = __expf(wml[w][0] - bm);
      den = fmaf(a, wml[w][1], den);
      const float4 v = *reinterpret_cast<const float4*>(&wacc[w][4 * tid]);
      num[0] = fmaf(a, v.x, num[0]);
      num[1] = fmaf(a, v.y, num[1]);
      num[2] = fmaf(a, v.z, num[2]);
      num[3] = fmaf(a, v.w, num[3]);
    }
    if (rank == 0) {
      *reinterpret_cast<float4*>(&parts[0][4 * tid]) = make_float4(num[0], num[1], num[2], num[3]);
      if (tid == 0) {
        pml[0][0] = bm;
        pml[0][1] = den;
      }
    } else {
      const uint32_t rbar = cluster_addr(sbar, 0);
      st_async4(cluster_addr(smem_addr(&parts[rank][4 * tid]), 0), num, rbar);
      if (tid == 0) {
        st_async(cluster_addr(smem_addr(&pml[rank][0]), 0), bm, rbar);
        st_async(cluster_addr(smem_addr(&pml[rank][1]), 0), den, rbar);
      }
    }
  }
  if (rank != 0) return;
  if (tid < D) mbar_wait(sbar, 0);
  __syncthreads();  // rank 0's own piece, written by other threads
  if (tid >= D) return;
  float gm = -INFINITY;
#pragma unroll
  for (int r = 0; r < RANKS; ++r) gm = fmaxf(gm, pml[r][0]);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int r = 0; r < RANKS; ++r) {
    if (pml[r][0] == -INFINITY) continue;
    const float a = __expf(pml[r][0] - gm);
    den = fmaf(a, pml[r][1], den);
    num = fmaf(a, parts[r][tid], num);
  }
  o[(size_t)bh * D + tid] = num / den;
}

}  // namespace

// q (B, H, D) f32; ck, cv (B, H, S, D) int8; ks, vs (B, H, S) f32;
// valid_len (B,) int32; o (B, H, D) f32; all contiguous, ck and cv 16-byte
// aligned; D is 64 or 128. Grid: RANKS blocks (one cluster) per (b, h).
// Returns cudaGetLastError().
extern "C" int decode_attn_int8(const void* q, const void* ck, const void* cv,
                                const void* ks, const void* vs, const void* valid_len,
                                void* o, int B, int H, int S, int D, float scale,
                                void* stream) {
  const dim3 grid(RANKS, B * H);
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    decode_attn<64><<<grid, THREADS, 0, st>>>(
        (const float*)q, (const int8_t*)ck, (const int8_t*)cv, (const float*)ks,
        (const float*)vs, (const int*)valid_len, (float*)o, H, S, scale);
  else if (D == 128)
    decode_attn<128><<<grid, THREADS, 0, st>>>(
        (const float*)q, (const int8_t*)ck, (const int8_t*)cv, (const float*)ks,
        (const float*)vs, (const int*)valid_len, (float*)o, H, S, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
