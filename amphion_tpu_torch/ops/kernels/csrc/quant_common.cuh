// Shared pieces of the weight-only quantized matmuls (int8_matmul.cu,
// int4_matmul.cu): bf16 tensor-core products through mma.sync, the GEMM's
// tile geometry, and the whole GEMV (M <= 8) kernel, which the two files
// instantiate with their weight formats.
//
// The GEMM: a block of 8 warps owns a BM x BN output tile (BM = 128 rows of
// x, BN output columns) and walks K in steps of BK = 32. Each step stages
// bf16(x) (BM x BK) and the weight tile converted to bf16 (BN x BK, the
// weight's own (N, K) row-major layout) in shared memory with rows padded by
// 16 bytes, so ldmatrix reads the A and B fragments without bank conflicts;
// the next step's x and weight bytes are loaded into registers while the
// current step's products run.
// Warps are laid out 4 (rows) x 2 (columns); each computes 32 rows x BN/2
// columns with m16n8k16 products and float32 accumulators.
//
// The GEMV (one decode step of up to 8 rows; `gemv_kernel` below) is bound
// by the weight bytes, each used M <= 8 times. What it does about that, as
// chosen by timing the alternatives on the H100 (tools/quant_ab.py):
//  * a block of 8 warps owns 16 output columns, one m16 tile: the weights
//    are the A operand of m16n8k16 products and x's <= 8 rows the n8 side,
//    so the work per weight byte does not grow with M; the warps take the
//    block's chunks of K (64 bytes of each of the 16 weight rows) in turn;
//  * each warp keeps two chunks in flight: it issues the loads of its next
//    chunk (lane (g, t)'s 16 bytes of weight rows g and g + 8, its 16 or 32
//    values of x row g, int4's two group scales) before it converts and
//    multiplies the current one, so the conversions run while bytes stream
//    and no load waits at the end (the int8 column scales are read into
//    shared memory at the start);
//  * where the column tiles alone leave SMs idle (N = 1280: 80 tiles), a
//    thread-block cluster of up to 4 blocks splits K; each block's float32
//    sum reaches rank 0's shared memory by st.async, completing on an
//    mbarrier there, and rank 0 adds them in rank order: no atomics, no
//    workspace, no second launch, no cluster barrier on the way out;
//  * the RMSNorm prologue's sums of squares run while the first chunks'
//    loads fly; the cluster's blocks add their partial sums the same way;
//  * the int -> bf16 conversions are exact and cheap: int8 through the
//    float 2^23 + u and one byte permutation per pair, int4 two nibbles per
//    LOP3 into the bf16 128 + u and one bf16x2 fma.
// A relaunch gives the same bits. The cluster size and the K split depend
// on N and K only, and row r of x is column r of every n8 operand, so row r
// of the output does not depend on M or on the other rows.
// Two designs measured slower at K = 1280 and were dropped: each block's
// whole weight slice staged in shared memory by cp.async.bulk (the
// conversions then start only when the slice has landed, and did not
// overlap the stream), and x staged in shared memory once per block (the
// block waits at a barrier for x, whose loads queue behind the weights';
// each warp reads only its own chunks' x, so x is read once per block
// either way).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace quant {

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int AP = BK + 8;  // pitch (bf16 elements) of a staged row
constexpr int GEMM_THREADS = 256;
constexpr int GEMV_MAX_M = 8;  // rows of x up to which the GEMV path runs

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float load_x(const float* x, size_t i) { return x[i]; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}

// 1 / sqrt(mean(x_row^2) + eps) over K, by one warp; every lane gets it.
template <typename TX>
__device__ __forceinline__ float row_rinv(const TX* xr, int K, float eps) {
  float s = 0.f;
  for (int k = threadIdx.x & 31; k < K; k += 32) {
    const float v = load_x(xr, k);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return 1.f / sqrtf(s / (float)K + eps);
}

// acc[i][j] (+)= A(32 rows of this warp) x B(this warp's WN columns) over one
// BK step. As is (BM, AP), Bs is (BN, AP), both bf16 row-major.
template <int WN>
__device__ __forceinline__ void mma_tile(float (&acc)[2][WN / 8][4],
                                         const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs, int wm, int wn) {
  const int lane = threadIdx.x & 31;
  const int arow = lane & 15, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldmatrix_x4(af[i], As + (wm * 32 + i * 16 + arow) * AP + kk * 16 + acol);
#pragma unroll
    for (int j = 0; j < WN / 8; j += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, Bs + (wn * WN + j * 8 + brow) * AP + kk * 16 + bcol);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
        mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

// Eight consecutive x values (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// GEMM A tile, software-pipelined: each thread owns row threadIdx.x / 2 of
// the BM x BK tile and 16 consecutive k; the next step's values are loaded
// into registers (load_a) while the current step computes, then rounded to
// bf16, normalised first when g is set, and stored (store_a).
template <typename TX>
__device__ __forceinline__ void load_a(float (&v)[16], const TX* x, int M, int K, int m0,
                                       int k0) {
  const int r = threadIdx.x >> 1, c = (threadIdx.x & 1) * 16;
  if (m0 + r < M) {
    const TX* p = x + (size_t)(m0 + r) * K + k0 + c;
    load8(p, *reinterpret_cast<float(*)[8]>(&v[0]));
    load8(p + 8, *reinterpret_cast<float(*)[8]>(&v[8]));
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = 0.f;
  }
}

__device__ __forceinline__ void store_a(__nv_bfloat16* As, const float (&v)[16], int k0,
                                        const float* rinv, const float* g) {
  const int r = threadIdx.x >> 1, c = (threadIdx.x & 1) * 16;
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float a = v[2 * i], b = v[2 * i + 1];
    if (g != nullptr) {
      a = a * rinv[r] * g[k0 + c + 2 * i];
      b = b * rinv[r] * g[k0 + c + 2 * i + 1];
    }
    p[i] = pack_bf16(a, b);
  }
  uint4* dst = reinterpret_cast<uint4*>(As + r * AP + c);
  dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
  dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
}

__device__ __forceinline__ void store_out(float* o, size_t i, float v) { o[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* o, size_t i, float v) {
  o[i] = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// GEMV, M <= GEMV_MAX_M (design in the header comment). A weight format F
// gives:
//   CH         k values per chunk (64 int8, 128 int4: CHUNK_BYTES of a row);
//   NI         16-byte x pieces a lane takes per chunk, 8 values of its row
//              each, from k = chunk + t * CH / 4 on;
//   GROUPED    whether each chunk has its own scale per column (int4's
//              128-groups) instead of one per column after the K sum (int8);
//   PROLOGUE   whether it takes an RMSNorm gain (int4);
//   pack_x     8 x values -> bf16 pairs, paired as the format's A
//              fragments pair the k values;
//   pair_bf16  the same from 8 bf16 values as they are;
//   chunk      a chunk's products into the lane's float32 accumulator.

constexpr int GEMV_WARPS = 8;
constexpr int GEMV_THREADS = GEMV_WARPS * 32;
constexpr int GEMV_COLS = 16;              // output columns of a block (one m16 tile)
constexpr int CHUNK_BYTES = 64;            // bytes of one weight row in a chunk
constexpr int MAX_CLUSTER = 4;             // blocks of a cluster, splitting K
constexpr int SPLIT_CHUNKS = 8;            // chunks per block when a cluster splits K

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the barrier's phase of this parity to complete; a wait of
// billions of cycles can only be a fault, so trap instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - start > (1ll << 33)) __trap();
  }
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of this block's shared variable at `addr` in block `rank` of
// the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// Stores into another block's shared memory that complete their bytes on
// that block's barrier (both addresses from cluster_addr).
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               :: "r"(addr), "f"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async4(uint32_t addr, const float (&v)[4], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(addr), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar) : "memory");
}

// 8 values of x as floats (a 16-byte piece of bf16, or two of float32).
__device__ __forceinline__ void unpack8(const uint4* r, float (&v)[8], const __nv_bfloat16*) {
  const uint32_t u[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(u[j] << 16);
    v[2 * j + 1] = __uint_as_float(u[j] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void unpack8(const uint4* r, float (&v)[8], const float*) {
  v[0] = __uint_as_float(r[0].x); v[1] = __uint_as_float(r[0].y);
  v[2] = __uint_as_float(r[0].z); v[3] = __uint_as_float(r[0].w);
  v[4] = __uint_as_float(r[1].x); v[5] = __uint_as_float(r[1].y);
  v[6] = __uint_as_float(r[1].z); v[7] = __uint_as_float(r[1].w);
}

// One chunk of one warp in flight: the lane's 16 bytes of weight rows g and
// g + 8, its x (F::NI pieces of 8 values of row g, raw), and, GROUPED, the
// two columns' scales of the chunk's group.
template <class F, typename TX>
struct Stage {
  static constexpr int XP = F::NI * (int)sizeof(TX) / 2;  // 16-byte pieces of x
  uint4 wa, wb, xr[XP];
  float sa, sb;
};

// x: (M, K) f32 or bf16; w: (N, K * CHUNK_BYTES / CH) bytes; scale: (N,)
// or, GROUPED, (K / CH, N); g: (K,) RMSNorm gain or null (16-byte
// aligned); out: (M, N). Grid: ceil(N / 16) column tiles x the cluster's
// blocks, which split the K / CH chunks evenly; a cluster of one block is
// launched as a plain grid and meets no cluster barrier. Warp w takes the
// block's chunks w, w + 8, ...: the loads of its next chunk (weights, x,
// scales) are issued before the current one is converted and multiplied,
// and its first chunk's loads before the RMSNorm prologue's sums.
template <class F, typename TX, typename TO>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ g,
            TO* __restrict__ out, int M, int N, int K, float eps) {
  if constexpr (!F::PROLOGUE) g = nullptr;
  __shared__ __align__(8) uint64_t bars[2];  // the cluster's sums, its sums of squares
  __shared__ __align__(16) float red[GEMV_WARPS][32][4];
  __shared__ __align__(16) float parts[MAX_CLUSTER][32][4];
  __shared__ float ssq[MAX_CLUSTER][GEMV_MAX_M];
  __shared__ float colscale[GEMV_COLS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int cs = cluster_blocks(), rank = cluster_rank();
  const int n0 = (int)(blockIdx.x / cs) * GEMV_COLS;
  const int rows = min(GEMV_COLS, N - n0);
  const int nch = K / F::CH;
  const int c_begin = rank * nch / cs, c_end = (rank + 1) * nch / cs;
  const size_t row_bytes = (size_t)nch * CHUNK_BYTES;
  const bool va = gq < rows, vb = gq + 8 < rows, vx = gq < M;
  const uint8_t* wra = w + (size_t)(n0 + gq) * row_bytes + 16 * t;  // rows gq, gq + 8
  const uint8_t* wrb = wra + 8 * row_bytes;
  const int xk = t * (F::CH / 4);  // the lane's first k in a chunk
  const TX* xrow = x + (size_t)(vx ? gq : 0) * K + xk;
  const uint32_t rbar = smem_addr(&bars[0]), sbar = smem_addr(&bars[1]);

  if (cs > 1) {
    if (tid == 0) {
      mbar_init(rbar, 1);
      mbar_init(sbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (rank == 0) mbar_expect_tx(rbar, (cs - 1) * 32 * 16);  // what the others send
      if (g != nullptr) mbar_expect_tx(sbar, (cs - 1) * M * 4);
    }
    // once this phase completes, every block has started and may be sent to
    cluster_arrive_relaxed();
  }

  using S = Stage<F, TX>;
  auto load = [&](S& st, int c) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    st.wa = va ? *reinterpret_cast<const uint4*>(wra + (size_t)c * CHUNK_BYTES) : z;
    st.wb = vb ? *reinterpret_cast<const uint4*>(wrb + (size_t)c * CHUNK_BYTES) : z;
    const uint4* xp = reinterpret_cast<const uint4*>(xrow + (size_t)c * F::CH);
#pragma unroll
    for (int i = 0; i < S::XP; ++i) st.xr[i] = vx ? xp[i] : z;
    if constexpr (F::GROUPED) {
      st.sa = va ? scale[(size_t)c * N + n0 + gq] : 0.f;
      st.sb = vb ? scale[(size_t)c * N + n0 + gq + 8] : 0.f;
    } else {
      st.sa = st.sb = 0.f;
    }
  };

  S cur, nxt;
  int c = c_begin + warp;
  if (c < c_end) load(cur, c);
  if (!F::GROUPED && tid < GEMV_COLS) colscale[tid] = tid < rows ? scale[n0 + tid] : 0.f;

  float rinv = 0.f;  // of x row gq, with the prologue
  if (g != nullptr) {
    // RMSNorm prologue: each row's sum of squares over the block's K range,
    // added across the cluster, while the first chunks' loads fly
    float s = 0.f;
    if (warp < M) {
      const TX* xr = x + (size_t)warp * K;
#pragma unroll 4
      for (int k = c_begin * F::CH + 8 * lane; k < c_end * F::CH; k += 256) {
        float v[8];
        load8(xr + k, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(v[e], v[e], s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) ssq[rank][warp] = s;
    }
    if (cs > 1) {
      cluster_wait();
      if (warp < M && lane < cs && lane != rank)
        st_async(cluster_addr(smem_addr(&ssq[rank][warp]), lane), s, cluster_addr(sbar, lane));
      if (tid < M) mbar_wait(sbar, 0);
    }
    __syncthreads();
    if (vx) {
      float tot = 0.f;
      for (int r = 0; r < cs; ++r) tot += ssq[r][gq];
      rinv = 1.f / sqrtf(tot / (float)K + eps);
    }
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (; c < c_end; c += GEMV_WARPS) {
    if (c + GEMV_WARPS < c_end) load(nxt, c + GEMV_WARPS);
    uint4 xv[F::NI];
#pragma unroll
    for (int i = 0; i < F::NI; ++i) {
      if (sizeof(TX) == 2 && g == nullptr) {  // bf16 x as it is, paired as F pairs k
        xv[i] = F::pair_bf16(cur.xr[i]);
      } else {  // rounded to bf16, normalised first with the prologue
        float v[8];
        unpack8(&cur.xr[i * (int)sizeof(TX) / 2], v, x);
        if (g != nullptr) {
          float gv[8];
          load8(g + (size_t)c * F::CH + xk + 8 * i, gv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = v[e] * rinv * gv[e];
        }
        xv[i] = F::pack_x(v);
      }
    }
    F::chunk(acc, cur.wa, cur.wb, xv, cur.sa, cur.sb);
    cur = nxt;
  }

  // the warps' sums in warp order; then rank 0 adds the other blocks' sums,
  // sent into its shared memory, in rank order
#pragma unroll
  for (int e = 0; e < 4; ++e) red[warp][lane][e] = acc[e];
  if (cs > 1 && g == nullptr) cluster_wait();  // long since complete (the prologue waited)
  __syncthreads();
  if (warp != 0) return;
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = red[0][lane][e];
#pragma unroll
    for (int i = 1; i < GEMV_WARPS; ++i) v[e] += red[i][lane][e];
  }
  if (rank != 0) {
    st_async4(cluster_addr(smem_addr(&parts[rank][lane][0]), 0), v, cluster_addr(rbar, 0));
    return;
  }
  if (cs > 1) mbar_wait(rbar, 0);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    for (int r = 1; r < cs; ++r) v[e] += parts[r][lane][e];
    const int nl = gq + (e < 2 ? 0 : 8), m = 2 * t + (e & 1);
    if (nl < rows && m < M) {
      if constexpr (!F::GROUPED) v[e] *= colscale[nl];
      store_out(out, (size_t)m * N + n0 + nl, v[e]);
    }
  }
}

// Blocks per cluster: one when the column tiles alone cover the SMs or a
// block would get at most 2 * SPLIT_CHUNKS chunks, else one per
// SPLIT_CHUNKS chunks, at most MAX_CLUSTER, and no more than lets every
// cluster be resident at once (a second wave costs more than the split
// gains: int4 down took 5.2 us in clusters of 2, 6.0 in clusters of 3 that
// did not all fit). Measured: o keeps its 10 int4 chunks in one block, and
// splits its 20 int8 chunks over 3. `fits[c]` is how many clusters of c
// blocks the card holds at once.
inline int gemv_cluster(int col_tiles, int nch, int sms, const int* fits) {
  if (col_tiles >= sms || nch <= 2 * SPLIT_CHUNKS) return 1;
  int cs = (nch + SPLIT_CHUNKS - 1) / SPLIT_CHUNKS;
  cs = cs < MAX_CLUSTER ? cs : MAX_CLUSTER;
  while (cs > 1 && fits[cs] < col_tiles) --cs;
  return cs;
}

template <class F, typename TX, typename TO>
cudaError_t gemv_launch(const TX* x, const uint8_t* w, const float* scale, const float* g,
                        TO* out, int M, int N, int K, float eps, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(GEMV_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  // The SMs, and how many clusters of each size of the format's bf16 kernel
  // they hold at once (one instance for every x and output type, so that
  // the split, and with it the order of the sums, depends on N and K alone).
  struct Card { int sms, fits[MAX_CLUSTER + 1]; };
  static const Card card = [&cfg, &cluster] {
    Card c = {132, {0}};
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    cfg.numAttrs = 1;
    for (int k = 2; k <= MAX_CLUSTER; ++k) {
      cluster[0].val.clusterDim.x = k;
      cfg.gridDim = dim3(k);
      if (cudaOccupancyMaxActiveClusters(
              &c.fits[k], (const void*)gemv_kernel<F, __nv_bfloat16, __nv_bfloat16>, &cfg) !=
          cudaSuccess)
        c.fits[k] = 0;
    }
    cudaGetLastError();  // a size the card refuses is only not used
    return c;
  }();
  const int tiles = (N + GEMV_COLS - 1) / GEMV_COLS, nch = K / F::CH;
  const int cs = gemv_cluster(tiles, nch, card.sms, card.fits);
  cfg.gridDim = dim3(tiles * cs);
  cluster[0].val.clusterDim.x = cs;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, gemv_kernel<F, TX, TO>, x, w, scale, g, out, M, N, K, eps);
}

}  // namespace quant
