// Shared pieces of the weight-only quantized matmuls (int8_matmul.cu,
// int4_matmul.cu): bf16 tensor-core products through mma.sync, fragment
// loads through ldmatrix, and the GEMM's tile geometry.
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

// GEMV: x row `row` (zero when row >= M) at k .. k+8*NP as NP bf16 pairs, the
// order of the mma fragments; with g set, normalised first (x * rinv * g).
template <int NP, typename TX>
__device__ __forceinline__ void load_x_pairs(uint32_t (&p)[NP], const TX* x, int M, int K,
                                             int row, int k, const float* rinv,
                                             const float* g) {
  if (row >= M) {
#pragma unroll
    for (int i = 0; i < NP; ++i) p[i] = 0u;
    return;
  }
  const TX* xr = x + (size_t)row * K + k;
#pragma unroll
  for (int q = 0; q < NP / 4; ++q) {
    float v[8];
    load8(xr + 8 * q, v);
    if (g != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = v[i] * rinv[row] * g[k + 8 * q + i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) p[4 * q + i] = pack_bf16(v[2 * i], v[2 * i + 1]);
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

}  // namespace quant
