// Snake activation forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas kernels `_snake_fwd_kernel` / `_snake_bwd_kernel`
// behind `snake_pallas` (amphion_tpu/ops/pallas_kernels.py:40-117):
//   forward   y  = x + sin^2(a x) / (a + 1e-9)
//   backward  dx = g (1 + sin(2 a x))
//             da = sum over (B, T) of g (x sin(2 a x) / (a + 1e-9)
//                                        - sin^2(a x) / (a + 1e-9)^2)
// on x (B, T, C) with channels last, a (C,) float32, x and g in float32 or
// bf16, arithmetic in float32. The JAX package sums da with a jnp reduction
// outside its kernel; here it is fused into the backward's one launch.
//
// What bounds it on the H100: memory, if the instructions per element stay
// few. The forward moves 8 bytes per element (f32 in and out), the backward
// 12; at the vocoder's training shapes (about 2.9 M elements) that leaves
// some 70 instructions an element at the byte bound, which a 64-bit
// remainder for each element's channel, sinf with its branch to the long
// reduction and an IEEE division per element would exceed.
//
// What the design does about it:
//  * a thread owns a fixed group of V = 4 channels (16-byte float32 or
//    8-byte bf16 accesses; V = 1 where C % 4 != 0 or a pointer is not
//    16-byte aligned) and walks rows, with alpha, be = alpha + 1e-9, RN(1/be)
//    and the fast-division flag in registers: no index arithmetic per
//    element. A block is GB groups times L row lanes, so a warp reads
//    contiguous bytes; a thread issues the next chunk's loads before it
//    computes the current one, so that loads overlap the sines;
//  * the forward is `act` of `snake_common.cuh` (kernel 2's activation with
//    be = alpha + 1e-9): a branch-free sine and division, the chunk run
//    again with sinf and the IEEE division where either would not give
//    their bits. y equals the plain version's float32 result to the bit;
//  * the backward's dx takes sin of 2 a x as the plain version forms it,
//    RN(2a * x), by the same branch-free sine (again with sinf where
//    |2 a x| >= SIN_FAST), and equals the plain version's float32 result to
//    the bit; da's term uses the per-channel reciprocals (held to a
//    tolerance, not to bits);
//  * da in the same launch: a backward block takes at most 32 channels (one
//    wave of 1024-thread blocks, one per SM); its row lanes' sums meet by
//    warp shuffles and one pass through shared memory, each block writes
//    its partial row, and the last block to finish (a ticket counter, reset
//    by that block for the next launch or graph replay) adds the partials,
//    a warp per channel. Every sum runs in a fixed order and there are no
//    float atomics: da is bit-equal from launch to launch.

#include "snake_common.cuh"

namespace {

constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 1024;
constexpr int FWD_ROWS = 1;  // rows of a chunk: a thread's loads in flight, per input
constexpr int BWD_ROWS = 1;

// V consecutive channels of one row in one access.
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xFFFF0000u);
    v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xFFFF0000u);
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
                                              bf16_bits(v[2]) | bf16_bits(v[3]) << 16);
  else
    *p = __float2bfloat16_rn(v[0]);
}

// Rows r0, r0 + stride, ... (N of them) of V channels at p; zeros past the
// last row.
template <int N, int V, typename T>
__device__ __forceinline__ void load_rows(const T* p, int r0, int stride, int rows, int C,
                                          float (&v)[N][V]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = r0 + i * stride;
    if (r < rows) {
      load_v<V>(p + (size_t)r * C, v[i]);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) v[i][c] = 0.f;
    }
  }
}

// The block's layout: thread t takes group t % GB of the block's GB groups
// and row lane t / GB of L (threads past L * GB idle).
struct Layout {
  int lane, c0;
  bool active;
};
template <int V>
__device__ __forceinline__ Layout layout(int GB, int L, int C) {
  Layout l;
  l.lane = threadIdx.x / GB;
  l.c0 = (blockIdx.y * GB + threadIdx.x % GB) * V;
  l.active = l.lane < L && l.c0 < C;
  return l;
}

template <typename T, int V>
__global__ void __launch_bounds__(FWD_THREADS)
snake_fwd_kernel(const T* __restrict__ x, const float* __restrict__ alpha, T* __restrict__ out,
                 int rows, int C, int GB, int L) {
  const Layout l = layout<V>(GB, L, C);
  if (!l.active) return;
  Act k[V];
  bool slow = false;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    k[c] = make_act(alpha[l.c0 + c], alpha[l.c0 + c]);
    slow |= !k[c].fast;
  }
  // each chunk's loads are issued before the previous chunk is computed
  const int stride = gridDim.x * L, step = FWD_ROWS * stride;
  float next[FWD_ROWS][V];
  load_rows(x + l.c0, blockIdx.x * L + l.lane, stride, rows, C, next);
  for (int r0 = blockIdx.x * L + l.lane; r0 < rows; r0 += step) {
    float v[FWD_ROWS][V], y[FWD_ROWS][V];
#pragma unroll
    for (int i = 0; i < FWD_ROWS; ++i)
#pragma unroll
      for (int c = 0; c < V; ++c) v[i][c] = next[i][c];
    load_rows(x + l.c0, r0 + step, stride, rows, C, next);
    bool redo = slow;
#pragma unroll
    for (int i = 0; i < FWD_ROWS; ++i)
#pragma unroll
      for (int c = 0; c < V; ++c) y[i][c] = act<false>(v[i][c], k[c], redo);
    if (redo) {  // rare: again, as the plain version rounds
      bool unused = false;
#pragma unroll
      for (int i = 0; i < FWD_ROWS; ++i)
#pragma unroll
        for (int c = 0; c < V; ++c) y[i][c] = act<true>(v[i][c], k[c], unused);
    }
#pragma unroll
    for (int i = 0; i < FWD_ROWS; ++i) {
      const int r = r0 + i * stride;
      if (r < rows) store_v<V>(out + (size_t)r * C + l.c0, y[i]);
    }
  }
}

// The sum of v over the lanes of a warp at distances from, 2 from, ... < 32
// (from a power of two): a butterfly, so every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v, int from) {
  for (int o = from; o < 32; o <<= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// The backward of one chunk of rows: stores dx and adds da's summands to
// acc. EXACT: sinf (the caller found |2 a x| >= SIN_FAST in the chunk), else
// sin_reduced.
template <bool EXACT, typename T, int V>
__device__ __forceinline__ void bwd_rows(const float (&xv)[BWD_ROWS][V],
                                         const float (&gv)[BWD_ROWS][V], const float (&a)[V],
                                         const float (&r)[V], T* dx, int r0, int stride,
                                         int rows, int C, float (&acc)[V]) {
#pragma unroll
  for (int i = 0; i < BWD_ROWS; ++i) {
    float d[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const float x1 = __fmul_rn(a[c], xv[i][c]);
      const float x2 = __fmul_rn(__fadd_rn(a[c], a[c]), xv[i][c]);  // RN(2a * x)
      const float s = EXACT ? sinf(x1) : sin_reduced(x1);
      const float s2 = EXACT ? sinf(x2) : sin_reduced(x2);
      d[c] = __fmul_rn(gv[i][c], __fadd_rn(1.f, s2));
      acc[c] += gv[i][c] * (xv[i][c] * s2 * r[c] - s * s * (r[c] * r[c]));
    }
    if (r0 + i * stride < rows) store_v<V>(dx + (size_t)(r0 + i * stride) * C, d);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(BWD_THREADS, 1)
snake_bwd_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                 const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ partial,
                 float* __restrict__ dalpha, unsigned* __restrict__ ticket, int rows, int C,
                 int GB, int L) {
  __shared__ float red[BWD_THREADS];  // [warp][channel slot of the block]
  __shared__ bool last;
  const Layout l = layout<V>(GB, L, C);
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.f;
  if (l.active) {
    float a[V], r[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      a[c] = alpha[l.c0 + c];
      r[c] = __frcp_rn(a[c] + 1e-9f);
    }
    const int stride = gridDim.x * L, step = BWD_ROWS * stride;
    float nx[BWD_ROWS][V], ng[BWD_ROWS][V];  // the next chunk, loaded a chunk ahead
    load_rows(x + l.c0, blockIdx.x * L + l.lane, stride, rows, C, nx);
    load_rows(g + l.c0, blockIdx.x * L + l.lane, stride, rows, C, ng);
    for (int r0 = blockIdx.x * L + l.lane; r0 < rows; r0 += step) {
      float xv[BWD_ROWS][V], gv[BWD_ROWS][V];
#pragma unroll
      for (int i = 0; i < BWD_ROWS; ++i)
#pragma unroll
        for (int c = 0; c < V; ++c) xv[i][c] = nx[i][c], gv[i][c] = ng[i][c];
      load_rows(x + l.c0, r0 + step, stride, rows, C, nx);
      load_rows(g + l.c0, r0 + step, stride, rows, C, ng);
      bool exact = false;  // rare: a sine the short reduction would get wrong
#pragma unroll
      for (int i = 0; i < BWD_ROWS; ++i)
#pragma unroll
        for (int c = 0; c < V; ++c)
          exact |= !(fabsf(__fmul_rn(__fadd_rn(a[c], a[c]), xv[i][c])) < SIN_FAST);
      if (exact)
        bwd_rows<true, T, V>(xv, gv, a, r, dx + l.c0, r0, stride, rows, C, acc);
      else
        bwd_rows<false, T, V>(xv, gv, a, r, dx + l.c0, r0, stride, rows, C, acc);
    }
  }
  // the block's row lanes summed per channel slot (GB * V <= 32 slots): in
  // the warp, lanes GB apart share a slot; then warp w adds slot w over the
  // block's warps. Then the block's partial row.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const float v = warp_sum(acc[c], GB);
    if (lane < GB) red[warp * 32 + lane * V + c] = v;
  }
  __syncthreads();
  const int cb = blockIdx.y * GB * V;
  for (int slot = warp; slot < GB * V; slot += BWD_THREADS / 32) {
    const float v = warp_sum(lane < BWD_THREADS / 32 ? red[lane * 32 + slot] : 0.f, 1);
    if (lane == 0 && cb + slot < C) partial[(size_t)blockIdx.x * C + cb + slot] = v;
  }

  // the last block to finish adds the partials: a group of TP lanes (a
  // power of two, TP x C <= the block's threads where C allows) takes a
  // channel; lane q of the group adds blocks q, q + TP, ... in order, all
  // its loads issued first, then the group's sum by shuffles
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int tp = 32;
  while (tp > 1 && tp * C > BWD_THREADS) tp >>= 1;
  const int q = lane & (tp - 1);
  for (int c = threadIdx.x / tp; c - threadIdx.x / tp < C; c += BWD_THREADS / tp) {
    float v = 0.f;
    if (c < C) {
#pragma unroll 8
      for (int b = q; b < (int)gridDim.x; b += tp) v += __ldcg(partial + (size_t)b * C + c);
    }
    for (int o = 1; o < tp; o <<= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    if (q == 0 && c < C) dalpha[c] = v;
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch
}

// The block layout for C channels in groups of V: GB groups a block (a
// power of two, at most max_groups), L row lanes, gy blocks across the
// channels. The backward takes at most 32 channels a block, so that the
// lanes that share a channel meet by warp shuffles and the partials number
// (blocks in x) x C, not more.
struct Grid {
  int GB, L, gy;
};
Grid grid_of(int C, int V, int threads, int max_groups) {
  const int groups = (C + V - 1) / V;
  int gb = 1;
  while (gb < groups) gb <<= 1;
  Grid g;
  g.GB = gb < max_groups ? gb : max_groups;
  g.L = threads / g.GB;
  g.gy = (groups + g.GB - 1) / g.GB;
  return g;
}

template <typename K>
int resident_blocks(K kernel, int threads) {
  int dev = 0, sms = 132, blocks = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  return sms * (blocks > 0 ? blocks : 1);
}

// The backward's blocks at most (one wave), from one instance for both
// types so that the partials, and so da's bits, depend on the shape alone.
int bwd_blocks() {
  static const int n = resident_blocks(snake_bwd_kernel<float, 4>, BWD_THREADS);
  return n;
}

bool aligned16(const void* p) { return (size_t)p % 16 == 0; }

int blocks_x(int rows, int L, int per_thread, int cap) {
  const long long want = ((long long)rows + (long long)L * per_thread - 1) / ((long long)L * per_thread);
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

template <typename T, int V>
int fwd_launch(const void* x, const void* alpha, void* out, int rows, int C, cudaStream_t s) {
  static const int resident = resident_blocks(snake_fwd_kernel<T, V>, FWD_THREADS);
  const Grid g = grid_of(C, V, FWD_THREADS, FWD_THREADS);
  const int cap = resident / g.gy > 0 ? resident / g.gy : 1;
  const dim3 grid(blocks_x(rows, g.L, FWD_ROWS, cap), g.gy);
  snake_fwd_kernel<T, V><<<grid, FWD_THREADS, 0, s>>>((const T*)x, (const float*)alpha, (T*)out,
                                                      rows, C, g.GB, g.L);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int bwd_launch(const void* x, const void* alpha, const void* g, void* dx, void* partial,
               void* dalpha, void* ticket, int rows, int C, cudaStream_t s) {
  const Grid gr = grid_of(C, V, BWD_THREADS, 32 / V);
  const int cap = bwd_blocks() / gr.gy > 0 ? bwd_blocks() / gr.gy : 1;
  const dim3 grid(blocks_x(rows, gr.L, BWD_ROWS, cap), gr.gy);
  snake_bwd_kernel<T, V><<<grid, BWD_THREADS, 0, s>>>(
      (const T*)x, (const float*)alpha, (const T*)g, (T*)dx, (float*)partial, (float*)dalpha,
      (unsigned*)ticket, rows, C, gr.GB, gr.L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int snake_fwd(const void* x, const void* alpha, void* out, int rows, int C,
                         int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool v4 = C % 4 == 0 && aligned16(x) && aligned16(out);
  if (is_bf16)
    return v4 ? fwd_launch<__nv_bfloat16, 4>(x, alpha, out, rows, C, s)
              : fwd_launch<__nv_bfloat16, 1>(x, alpha, out, rows, C, s);
  return v4 ? fwd_launch<float, 4>(x, alpha, out, rows, C, s)
            : fwd_launch<float, 1>(x, alpha, out, rows, C, s);
}

// partial: (snake_bwd_partials(), C) float32 scratch; dalpha: (C,) float32;
// ticket: one uint32, zero before the first launch (each launch leaves it
// zero); launches that share a ticket must not overlap.
extern "C" int snake_bwd(const void* x, const void* alpha, const void* g, void* dx,
                         void* partial, void* dalpha, void* ticket, int rows, int C,
                         int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool v4 = C % 4 == 0 && aligned16(x) && aligned16(g) && aligned16(dx);
  if (is_bf16)
    return v4 ? bwd_launch<__nv_bfloat16, 4>(x, alpha, g, dx, partial, dalpha, ticket, rows, C, s)
              : bwd_launch<__nv_bfloat16, 1>(x, alpha, g, dx, partial, dalpha, ticket, rows, C, s);
  return v4 ? bwd_launch<float, 4>(x, alpha, g, dx, partial, dalpha, ticket, rows, C, s)
            : bwd_launch<float, 1>(x, alpha, g, dx, partial, dalpha, ticket, rows, C, s);
}

// The partial rows the backward writes at most.
extern "C" int snake_bwd_partials() { return bwd_blocks(); }
