// Shared pieces of the weight-only quantized matmuls (int8_matmul.cu,
// int4_matmul.cu): the whole GEMV (M <= 8) and GEMM (M > 8) kernels, which
// the two files instantiate with their weight formats, and their bf16
// pre-pass.
//
// The GEMM (`qmm_wgmma`, M > 8: the AR prefill, the flow-matching
// estimator) is bound by the tensor cores' bf16 rate at the path's
// thousands of rows. Its design, as measured on the H100 against the
// alternatives (tools/quant_ab.py):
//  * wgmma m64n128k16 with the weights as the register A operand and x as
//    the shared-memory B operand: the accumulator is the transposed tile
//    (rows = output columns), and no bf16 weight tile is written back to
//    shared memory. Each lane converts its two weight rows' bytes straight
//    from the staged int8 / packed int4 tile with the GEMV's exact
//    conversions, in natural k order (the hardware reads B, x, that way):
//    the format's `frags` gathers the lane's bytes with one byte
//    permutation per row and k16 step;
//  * TMA (cp.async.bulk.tensor) fills a ring of stages on full/empty
//    mbarriers from a producer warpgroup (40 registers; the two consumer
//    warpgroups take 232 by setmaxnreg): per stage an x box of 128 rows x 64
//    bf16 (128B swizzle, read by wgmma descriptors) per 64 k and a weight
//    tile of 128 rows x 64 bytes (64B swizzle, so the eight rows a warp
//    reads at once fall in distinct banks); TMA's zero fill covers the
//    ragged M, N and K edges;
//  * a block owns 128 output columns (64 per consumer warpgroup) x 128 x
//    rows; the block is persistent, one per SM, walking the tiles row tile
//    by row tile, and its ring runs on across tiles, so the producer loads
//    the next tile while the consumers store this one (int4 1.1x faster);
//  * a stage's A fragments are built in two halves, each into its own
//    buffer, so that every conversion runs while products reading the other
//    buffer do;
//  * int8: a stage is 64 k; its products queue behind the previous
//    stage's on the one accumulator; the column scale multiplies the whole
//    K sum in the epilogue;
//  * int4: a stage is one 128-wide group; its eight products go to a fresh
//    float32 partial (scale-d 0 on the first), which, once complete, is
//    scaled by the group's column scales and added to the output
//    accumulator. With whole-stage fragment buffers the two accumulators
//    and 64 fragment registers spilled, and ran 2.2x slower;
//  * x is read as bf16: float32 x, or x with int4's RMSNorm prologue, is
//    first written to a bf16 scratch (the wrapper's) by `qmm_prep`, a warp
//    per row, the prologue's sum of squares over the whole row;
//  * no split K and no atomics: a relaunch gives the same bits, and each
//    output's K order is fixed by its tile, so row r does not depend on M.
// Measured and dropped: 256 x rows a block (two m64n128 products per k16
// step; spilled), 256 output columns a block (two 64-row slabs per
// warpgroup, a third less x traffic per product: within 2.5 % where it had
// enough tiles, 15 % slower at the prefill qkv), a cheaper int8 conversion
// (two LOP3 and one bf16x2 fma per pair: no faster). With the fragments
// replaced by constants, no loads and no conversions, the GEMM still took
// 0.065 of its 0.083 ms at the flow-matching qkv: the pipeline and the
// products, not the conversions, hold it at about 40 % of the bf16 peak.
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

#include "hopper_common.cuh"

namespace quant {

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

using hop::mbar_expect_tx;
using hop::mbar_init;
using hop::mbar_wait;

using hop::cluster_addr;
using hop::cluster_arrive_relaxed;
using hop::cluster_blocks;
using hop::cluster_rank;
using hop::cluster_wait;
using hop::st_async;
using hop::st_async4;

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

// ---------------------------------------------------------------------------
// GEMM, M > GEMV_MAX_M (design in the header comment). A weight format F
// gives:
//   KS         k values per stage (64 int8, 128 int4: 64 bytes of a weight
//              row either way, so the weight tile is 128 rows x 64 bytes);
//   GROUPED    whether each stage is a quantization group with its own
//              scale per column (int4), the scale then applied to the
//              stage's fresh float32 partial, instead of one scale per
//              column after the K sum (int8);
//   frags      the A fragments of the stage's KS / 16 k16 steps for weight
//              rows ra and rb of the tile, from the 64B-swizzled tile, in
//              natural k order.

constexpr int GEMM_BM = 128;                  // x rows per block
constexpr int GEMM_BN = 128;                  // weight rows (output columns) per block
constexpr int GEMM_THREADS = 384;             // two consumer warpgroups of 64 weight rows, a producer
constexpr int W_ROW = 64;                     // bytes of a weight row in a stage
constexpr int X_BOX = GEMM_BM * 128;          // bytes of an x box: 128 rows x 64 bf16
constexpr int RING_BYTES = 200 * 1024;        // the ring's share of shared memory
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Byte offset of 16-byte chunk c of row r of a 64B-swizzled tile of 64-byte
// rows (TMA's CU_TENSOR_MAP_SWIZZLE_64B on a 512-byte-aligned base): the
// chunk index is XORed with bits 7-8 of the address, (r / 2) % 4.
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return (uint32_t)(r * W_ROW + ((c ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

template <class F>
struct GemmGeom {
  static constexpr int XB = F::KS / 64;                  // x boxes per stage
  static constexpr int STAGE = XB * X_BOX + GEMM_BN * W_ROW;  // x boxes, then the weight tile
  static constexpr int ST = RING_BYTES / STAGE < 8 ? RING_BYTES / STAGE : 8;  // ring stages
  static constexpr int BAR = ST * STAGE;                 // full[ST], empty[ST]
  static constexpr size_t SMEM = 1024 + BAR + 16 * ST;   // with the 1024-byte alignment slack
};

// x: (M, K) bf16 through the map tx (box {64, 128}, 128B swizzle); w: the
// (N, K * 64 / KS) weight bytes through tw (box {64, 128}, 64B swizzle);
// scale: (N,) or, GROUPED, (K / KS, N); out: (M, N). Persistent: block b
// takes the output tiles b, b + gridDim.x, ... of the ceil(M / 128) x
// ceil(N / 128) tiles, row tile by row tile (so the blocks at work share
// their x rows in the L2), and its ring runs on across them: the producer
// loads the next tile's stages while the consumers store this one's.
// Warpgroup w (0 or 1) owns weight rows 64 w ... 64 w + 63 of a tile;
// warpgroup 2's first thread is the producer. TMA zero-fills the rows past
// M and N and the k past K.
template <class F, typename TO>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
qmm_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
          const float* __restrict__ scale, TO* __restrict__ out, int M, int N, int K) {
  using G = GemmGeom<F>;
  constexpr int NK = F::KS / 16;  // k16 steps per stage, built in two halves
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sraw = smem_addr(smem_raw);
  const uint32_t sbase = sraw + ((1024u - (sraw & 1023u)) & 1023u);
  const uint32_t full = sbase + G::BAR, empty = full + 8 * G::ST;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles_n = (N + GEMM_BN - 1) / GEMM_BN;
  const int tiles = tiles_n * ((M + GEMM_BM - 1) / GEMM_BM);
  const int nst = (K + F::KS - 1) / F::KS;

  if (tid == 0) {
    for (int s = 0; s < G::ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: x and weight tiles into the ring
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 256) {
      int it = 0;  // stages loaded so far, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * GEMM_BM, n0 = tile % tiles_n * GEMM_BN;
        for (int j = 0; j < nst; ++j, ++it) {
          const int s = it % G::ST;
          if (it >= G::ST) mbar_wait(empty + 8 * s, (it / G::ST - 1) & 1);
          const uint32_t st = sbase + s * G::STAGE, bar = full + 8 * s;
          mbar_expect_tx(bar, G::STAGE);
#pragma unroll
          for (int b = 0; b < G::XB; ++b)
            hop::tma_load_2d(st + b * X_BOX, &tx, j * F::KS + 64 * b, m0, bar);
          hop::tma_load_2d(st + G::XB * X_BOX, &tw, j * W_ROW, n0, bar);
        }
      }
    }
    return;
  }

  hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
  const int ra = 64 * wg + 16 * warp + (lane >> 2), rb = ra + 8;  // this lane's weight rows
  auto release = [&](int it) {  // this warp is done with the stage loaded it-th
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + 8 * (it % G::ST));
  };
  float acc[64];
  [[maybe_unused]] float part[F::GROUPED ? 64 : 1];  // a group's fresh partial
  float sa = 0.f, sb = 0.f;  // the scales of rows ra, rb: per column, or the pending group's
  // A stage's fragments are built in two halves of NK / 2 k16 steps, each
  // into its own buffer, so that every conversion runs while products that
  // read the other buffer do: the first half's while the previous stage's
  // second half runs, the second half's while this stage's first half runs.
  uint32_t lo[NK / 2][4], hi[NK / 2][4];
  auto mma = [&](uint32_t st, uint32_t (&a)[NK / 2][4], int k0) {
    if constexpr (!F::GROUPED) hop::fence_regs(acc);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      const int k = k0 + kk;  // x box k / 4, +32 bytes a k16 step inside its rows
      const uint64_t xd = hop::desc_sw128(st + (k / 4) * X_BOX + (k % 4) * 32, 16);
      if constexpr (F::GROUPED)
        hop::wgmma_rs_n128(part, a[kk], xd, k > 0);
      else
        hop::wgmma_rs_n128(acc, a[kk], xd, 1);
    }
    hop::wgmma_commit();
  };
  auto fuse = [&]() {  // the complete group's partial, scaled, into acc
    if constexpr (F::GROUPED) {
      hop::fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = fmaf(part[i], (i & 2) ? sb : sa, acc[i]);
    }
  };
  int it = 0;  // stages consumed so far, over all of this block's tiles

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * GEMM_BM, n0 = tile % tiles_n * GEMM_BN;
    const bool va = n0 + ra < N, vb = n0 + rb < N;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int j = 0; j < nst; ++j, ++it) {
      const uint32_t st = sbase + (it % G::ST) * G::STAGE, wt = st + G::XB * X_BOX;
      float na = 0.f, nb = 0.f;
      if constexpr (F::GROUPED) {  // this group's scales, loaded while the tiles land
        na = va ? scale[(size_t)j * N + n0 + ra] : 0.f;
        nb = vb ? scale[(size_t)j * N + n0 + rb] : 0.f;
      }
      mbar_wait(full + 8 * (it % G::ST), (it / G::ST) & 1);
      if (j > 0) hop::wgmma_wait<1>();  // the previous stage's first half, which read lo
      F::template frags<0, NK / 2>(lo, wt, ra, rb, t);
      if constexpr (F::GROUPED) {  // a fresh partial: the previous group must be complete
        if (j > 0) {
          hop::wgmma_wait<0>();
          release(it - 1);
          fuse();
        }
        sa = na;
        sb = nb;
        hop::fence_regs(part);
        mma(st, lo, 0);
      } else {  // the same accumulator: the products queue behind the previous stage's
        mma(st, lo, 0);
        if (j > 0) {
          hop::wgmma_wait<1>();  // the previous stage's second half, which read hi
          release(it - 1);
        }
      }
      F::template frags<NK / 2, NK / 2>(hi, wt, ra, rb, t);
      mma(st, hi, NK / 2);
    }
    hop::wgmma_wait<0>();
    release(it - 1);
    if constexpr (F::GROUPED) {
      fuse();
    } else {
      hop::fence_regs(acc);
      sa = va ? scale[n0 + ra] : 0.f;
      sb = vb ? scale[n0 + rb] : 0.f;
    }

    // accumulator element 4i + e: weight row (e < 2 ? ra : rb), x row
    // 8 i + 2 t + (e & 1)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 8 * i + 2 * t + (e & 1);
        if ((e < 2 ? va : vb) && m < M) {
          const float v = acc[4 * i + e];
          store_out(out, (size_t)m * N + n0 + (e < 2 ? ra : rb),
                    F::GROUPED ? v : v * (e < 2 ? sa : sb));
        }
      }
    }
  }
}

// x (M, K) float32 or bf16 -> bf16, normalised first when g is given:
// bf16(x * (1 / sqrt(mean(x^2) + eps)) * g), the RMSNorm prologue, with the
// row's sum of squares over the whole row. One warp per row; K % 8 == 0,
// x, g and xb 16-byte aligned. (F only names the kernel after its format.)
template <class F, typename TX>
__global__ void __launch_bounds__(256)
qmm_prep(const TX* __restrict__ x, const float* __restrict__ g, __nv_bfloat16* __restrict__ xb,
         int M, int K, float eps) {
  const int row = (int)blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const TX* xr = x + (size_t)row * K;
  float rinv = 0.f;
  if (g != nullptr) {
    float s = 0.f;
    for (int k = 8 * lane; k < K; k += 256) {
      float v[8];
      load8(xr + k, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) s = fmaf(v[e], v[e], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    rinv = 1.f / sqrtf(s / (float)K + eps);
  }
  for (int k = 8 * lane; k < K; k += 256) {
    float v[8];
    load8(xr + k, v);
    if (g != nullptr) {
      float gv[8];
      load8(g + k, gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = v[e] * rinv * gv[e];
    }
    *reinterpret_cast<uint4*>(xb + (size_t)row * K + k) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                   pack_bf16(v[6], v[7]));
  }
}

// bf16(x), or the prologue's normalised x, into xb (the wrapper's scratch).
template <class F, typename TX>
cudaError_t prep_launch(const TX* x, const float* g, __nv_bfloat16* xb, int M, int K, float eps,
                        cudaStream_t st) {
  qmm_prep<F, TX><<<(M + 7) / 8, 256, 0, st>>>(x, g, xb, M, K, eps);
  return cudaGetLastError();
}

// The GEMM on bf16 x (M, K): tensor maps for x and the weight bytes, then
// one launch. Returns cudaErrorInvalidValue for what TMA cannot address (a
// base that is not 16-byte aligned, a map the driver refuses).
// The GEMM on bf16 x (M, K): tensor maps for x and the weight bytes, then
// one persistent launch of at most one block per SM. Returns
// cudaErrorInvalidValue for what TMA cannot address (a base that is not
// 16-byte aligned, a map the driver refuses).
template <class F, typename TO>
cudaError_t gemm_launch(const __nv_bfloat16* x, const uint8_t* w, const float* scale, TO* out,
                        int M, int N, int K, cudaStream_t st) {
  using G = GemmGeom<F>;
  if (((uintptr_t)x | (uintptr_t)w) & 15) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  const uint64_t wrow = (uint64_t)K * W_ROW / F::KS;  // weight bytes of a row
  if (!hop::make_map_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, 64, GEMM_BM,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hop::make_map_2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, wrow, W_ROW, GEMM_BN,
                        CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_wgmma<F, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (attr != cudaSuccess) return attr;
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int tiles = ((N + GEMM_BN - 1) / GEMM_BN) * ((M + GEMM_BM - 1) / GEMM_BM);
  qmm_wgmma<F, TO><<<tiles < sms ? tiles : sms, GEMM_THREADS, G::SMEM, st>>>(tx, tw, scale, out,
                                                                          M, N, K);
  return cudaGetLastError();
}

}  // namespace quant
