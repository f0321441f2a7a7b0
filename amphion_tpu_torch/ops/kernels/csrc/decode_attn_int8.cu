// Single-query attention over the head-major int8 KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_attn_int8_kernel` /
// `decode_attention_int8` (amphion_tpu/ops/pallas_kernels.py:1150-1223).
// Per (b, h): scores s_j = (q . k_int[j]) * ks[j] * (1/sqrt(D)), the scale
// applied after the dot; s_j = -inf for positions j >= valid_len[b]; a
// float32 softmax; out = sum_j p_j * vs[j] * v_int[j].
// q (B, H, D) f32; ck, cv (B, H, S, D) int8; ks, vs (B, H, S) f32.
//
// What bounds it on the H100: one decode step reads the whole cache once,
// 2 * S * D int8 bytes per (b, h) plus the scales, and does about 4 * S * D
// operations on them: about two per byte, so it is bound by memory. The TPU
// kernel ran one program per (b, h); at B = 1, H = 20 that is 20 blocks for
// 132 SMs. This kernel splits each row over blocks of SPLIT = 256 positions
// (flash-decoding): the first pass has a block per (split, b, h), each
// computing its scores into shared memory, their max m, sum l of exp(s - m)
// and the unnormalised sum of exp(s - m) * vs * v; the second pass merges the
// splits of a row by rescaling each with exp(m_i - max m). Splits wholly past
// valid_len only write m = -inf, l = 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SPLIT = 256;
constexpr int THREADS = 128;

template <int D>
__global__ void __launch_bounds__(THREADS)
decode_split(const float* __restrict__ q, const int8_t* __restrict__ ck,
             const int8_t* __restrict__ cv, const float* __restrict__ ks,
             const float* __restrict__ vs, const int* __restrict__ valid_len,
             float* __restrict__ part, int H, int S, int n_split, float scale) {
  constexpr int DV = D / 4;             // threads across D in the V sum (4 dims each)
  constexpr int PG = THREADS / DV;      // position groups in the V sum
  __shared__ __align__(16) float qs[D];
  __shared__ float ps[SPLIT];
  __shared__ float red[THREADS / 32];
  __shared__ __align__(16) float vacc[PG][D];

  const int bh = blockIdx.y, split = blockIdx.x;
  const int b = bh / H;
  const int len = min(valid_len[b], S);
  const int s0 = split * SPLIT, s1 = min(s0 + SPLIT, len);
  float* out = part + ((size_t)bh * n_split + split) * (D + 2);
  if (s0 >= s1) {  // nothing of this split is attended
    for (int d = threadIdx.x; d < D + 2; d += THREADS)
      out[d] = d == 0 ? -INFINITY : 0.f;
    return;
  }
  for (int d = threadIdx.x; d < D; d += THREADS) qs[d] = q[(size_t)bh * D + d];
  __syncthreads();

  const int8_t* kb = ck + (size_t)bh * S * D;
  const int8_t* vb = cv + (size_t)bh * S * D;
  const float* ksb = ks + (size_t)bh * S;
  const float* vsb = vs + (size_t)bh * S;

  // scores: one thread per position, its key row read 16 bytes at a time
  float mx = -INFINITY;
  for (int j = s0 + threadIdx.x; j < s0 + SPLIT; j += THREADS) {
    float s = -INFINITY;
    if (j < s1) {
      const int4* kr = reinterpret_cast<const int4*>(kb + (size_t)j * D);
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int4 kv = kr[c];
        const int w4[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          a = fmaf(qs[c * 16 + e], (float)(int8_t)((w4[e >> 2] >> (8 * (e & 3))) & 0xFF), a);
      }
      s = a * ksb[j] * scale;
    }
    ps[j - s0] = s;
    mx = fmaxf(mx, s);
  }
  // block max
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();
  // probabilities (unnormalised) and their sum
  float l = 0.f;
  for (int j = threadIdx.x; j < SPLIT; j += THREADS) {
    const float p = s0 + j < s1 ? __expf(ps[j] - mx) : 0.f;
    ps[j] = p;
    l += p;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = l;
  __syncthreads();

  // weighted V sum: thread -> 4 dims (dv) x positions of group pg
  const int dv = threadIdx.x % DV, pg = threadIdx.x / DV;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int j = s0 + pg; j < s1; j += PG) {
    const float w = ps[j - s0] * vsb[j];
    const int v4 = *reinterpret_cast<const int*>(vb + (size_t)j * D + 4 * dv);
    a0 = fmaf(w, (float)(int8_t)(v4 & 0xFF), a0);
    a1 = fmaf(w, (float)(int8_t)((v4 >> 8) & 0xFF), a1);
    a2 = fmaf(w, (float)(int8_t)((v4 >> 16) & 0xFF), a2);
    a3 = fmaf(w, (float)(int8_t)((v4 >> 24) & 0xFF), a3);
  }
  *reinterpret_cast<float4*>(&vacc[pg][4 * dv]) = make_float4(a0, a1, a2, a3);
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float v = 0.f;
#pragma unroll
    for (int g = 0; g < PG; ++g) v += vacc[g][d];
    out[2 + d] = v;
  }
  if (threadIdx.x == 0) {
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) lt += red[w];
    out[0] = mx;
    out[1] = lt;
  }
}

// out[bh, d] = sum_i exp(m_i - M) acc_i[d] / sum_i exp(m_i - M) l_i
template <int D>
__global__ void decode_merge(const float* __restrict__ part, float* __restrict__ o,
                             int n_split) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const float* p = part + (size_t)bh * n_split * (D + 2);
  float m = -INFINITY;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, p[i * (D + 2)]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float mi = p[i * (D + 2)];
    if (mi == -INFINITY) continue;
    const float a = __expf(mi - m);
    den = fmaf(a, p[i * (D + 2) + 1], den);
    num = fmaf(a, p[i * (D + 2) + 2 + d], num);
  }
  o[(size_t)bh * D + d] = num / den;
}

template <int D>
void launch(const float* q, const int8_t* ck, const int8_t* cv, const float* ks,
            const float* vs, const int* lens, float* part, float* o, int B, int H,
            int S, int n_split, float scale, cudaStream_t st) {
  dim3 grid(n_split, B * H);
  decode_split<D><<<grid, THREADS, 0, st>>>(q, ck, cv, ks, vs, lens, part, H, S,
                                            n_split, scale);
  decode_merge<D><<<B * H, D, 0, st>>>(part, o, n_split);
}

}  // namespace

// q (B, H, D) f32; ck, cv (B, H, S, D) int8; ks, vs (B, H, S) f32;
// valid_len (B,) int32; part (B*H, n_split, D+2) f32 scratch with n_split =
// ceil(S / 256); o (B, H, D) f32; all contiguous; D is 64 or 128.
// Returns cudaGetLastError().
extern "C" int decode_attn_int8(const void* q, const void* ck, const void* cv,
                                const void* ks, const void* vs, const void* valid_len,
                                void* part, void* o, int B, int H, int S, int D,
                                int n_split, float scale, void* stream) {
  if (n_split * SPLIT < S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    launch<64>((const float*)q, (const int8_t*)ck, (const int8_t*)cv, (const float*)ks,
               (const float*)vs, (const int*)valid_len, (float*)part, (float*)o, B, H, S,
               n_split, scale, st);
  else if (D == 128)
    launch<128>((const float*)q, (const int8_t*)ck, (const int8_t*)cv, (const float*)ks,
                (const float*)vs, (const int*)valid_len, (float*)part, (float*)o, B, H, S,
                n_split, scale, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
