// Pieces shared by the flash-attention kernels (flash_attn_fwd.cu and
// flash_attn_bwd.cu): asynchronous copies, the key-validity bits and the
// split-TF32 ("3xTF32") tensor-core product that keeps float32 accuracy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr float NEG = -1e30f;  // the score of a masked key (p is forced to 0)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ------------------------------------------------------------ key validity

// bits[w] bit i says whether key 32 w + i counts: it lies inside Lk and its
// mask value (mask_row[key], null = all ones) is > 0. Every warp of the block
// takes words in turn; one coalesced load and a ballot per word. The caller
// synchronises the block before reading the words.
__device__ __forceinline__ void key_bits(uint32_t* bits, int nwords,
                                         const float* __restrict__ mask_row, int Lk) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int w = threadIdx.x >> 5; w < nwords; w += nwarps) {
    const int key = w * 32 + lane;
    const bool ok = key < Lk && (mask_row == nullptr || mask_row[key] > 0.f);
    const uint32_t word = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) bits[w] = word;
  }
}

// The last key that counts, or -1: keys past it add nothing, so their tiles
// are skipped (a ragged key mask costs only the keys it keeps).
__device__ __forceinline__ int last_key(const uint32_t* bits, int nwords) {
  for (int w = nwords - 1; w >= 0; --w)
    if (bits[w] != 0u) return w * 32 + 31 - __clz(bits[w]);
  return -1;
}

// ------------------------------------------------------ split TF32 products

// x = big + small with both TF32 (10 explicit mantissa bits), rounded to
// nearest: big carries the top 11 bits of x's mantissa, small the next 11.
// The rounding is cvt.rna.tf32.f32's (to nearest, ties away from zero) for
// every finite x, done with two integer operations: half a TF32 unit added
// to the magnitude bits, the 13 bits below TF32 cleared.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// An m16n8k8 A fragment split once and used for several products: lane
// (g, t) = (lane / 4, lane % 4) holds (row g, col t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4).
struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.big[0], f.small[0]);
  split_tf32(a1, f.big[1], f.small[1]);
  split_tf32(a2, f.big[2], f.small[2]);
  split_tf32(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[u] += a * b_u for four m16n8k8 accumulators c[0..3] sharing one A
// fragment, in about float32 accuracy: three TF32 products on split
// operands, the two small cross terms first and the big one last, as
// CUTLASS's OpMultiplyAddFastF32 orders them. c[u]'s B fragment, b0 =
// (k t, n g) and b1 = (k t + 4, n g), is read at b[u * sn] and
// b[u * sn + sk] and split here. Each product runs over all four
// accumulators before the next, so none waits on the one issued before it.
__device__ __forceinline__ void mma_3xtf32_x4(float (*c)[4], const FragA& a, const float* b,
                                              int sn, int sk) {
  uint32_t bb[4][2], bs[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    split_tf32(b[u * sn], bb[u][0], bs[u][0]);
    split_tf32(b[u * sn + sk], bb[u][1], bs[u][1]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) mma_tf32(c[u], a.small, bb[u][0], bb[u][1]);
#pragma unroll
  for (int u = 0; u < 4; ++u) mma_tf32(c[u], a.big, bs[u][0], bs[u][1]);
#pragma unroll
  for (int u = 0; u < 4; ++u) mma_tf32(c[u], a.big, bb[u][0], bb[u][1]);
}

// Two groups of four accumulators at once, each with its own A fragment
// and B tile (same strides): eight independent products between two that
// depend on each other.
__device__ __forceinline__ void mma_3xtf32_2x4(float (*c0)[4], const FragA& a0, const float* b0,
                                               float (*c1)[4], const FragA& a1, const float* b1,
                                               int sn, int sk) {
  uint32_t bb[8][2], bs[8][2];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    split_tf32(b0[u * sn], bb[u][0], bs[u][0]);
    split_tf32(b0[u * sn + sk], bb[u][1], bs[u][1]);
    split_tf32(b1[u * sn], bb[4 + u][0], bs[4 + u][0]);
    split_tf32(b1[u * sn + sk], bb[4 + u][1], bs[4 + u][1]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    mma_tf32(c0[u], a0.small, bb[u][0], bb[u][1]);
    mma_tf32(c1[u], a1.small, bb[4 + u][0], bb[4 + u][1]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    mma_tf32(c0[u], a0.big, bs[u][0], bs[u][1]);
    mma_tf32(c1[u], a1.big, bs[4 + u][0], bs[4 + u][1]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    mma_tf32(c0[u], a0.big, bb[u][0], bb[u][1]);
    mma_tf32(c1[u], a1.big, bb[4 + u][0], bb[4 + u][1]);
  }
}

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp), for probabilities computed
// in log2 units as 2^(s scale log2(e) - m log2(e)).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// float32 tiles in shared memory have rows of D + 4 floats: the 32-bit
// fragment loads are then free of bank conflicts, whether a lane reads
// (row g, col t) (an A tile, or a B tile with n along rows) or
// (row 2 t, col g) (a B tile with k along rows, keys permuted as below).
template <int D>
__host__ __device__ constexpr int f32_pitch() { return D + 4; }

// rows [r0, r0 + n) of one head of a (B, L, heads, D) float32 tensor into a
// shared tile of pitch D + 4 by cp.async, zeros past L
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, size_t stride,
                                              int r0, int n, int L) {
  constexpr int CH = D / 4, P = f32_pitch<D>();
  for (int c = threadIdx.x; c < n * CH; c += blockDim.x) {
    const int r = c / CH, cc = (c % CH) * 4;
    const bool in = r0 + r < L;
    cp_async16(dst + r * P + cc, src + (in ? (size_t)(r0 + r) * stride + cc : 0), in ? 16 : 0);
  }
}

// The A fragment of rows [row0, row0 + 16), k-step kk, of a float32 tile,
// split as it is loaded.
template <int D>
__device__ __forceinline__ FragA load_a(const float* x, int row0, int kk, int g, int t) {
  constexpr int P = f32_pitch<D>();
  const int o = (row0 + g) * P + kk * 8 + t;
  return split_a(x[o], x[o + 8 * P], x[o + 4], x[o + 8 * P + 4]);
}

// From an accumulator to the next product's A operand without shuffles. An
// m16n8 accumulator c holds (row g, col 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1); an m16n8k8 A fragment wants (g, t), (g+8, t), (g, t+4),
// (g+8, t+4). The product sums over its k index, so k-step kk may take its
// eight keys in any order the B fragment shares: k index t stands for key
// 8 kk + 2t and k index t + 4 for key 8 kk + 2t + 1. Then the A fragment
// is (c0, c2, c1, c3) and the B fragment (k t, n) / (k t + 4, n) reads
// rows 8 kk + 2t and 8 kk + 2t + 1 of the (key, n) tile.
__device__ __forceinline__ FragA acc_to_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// ------------------------------------------------------------------- host

constexpr int MAX_SMEM = 232448;  // what a block may use on the H100

// Let `Kernel` take up to MAX_SMEM of dynamic shared memory: once per
// kernel, so no attribute call falls inside a CUDA-graph capture.
template <auto Kernel>
void allow_max_smem() {
  static bool done = false;
  if (!done) {
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    done = true;
  }
}

}  // namespace fa
