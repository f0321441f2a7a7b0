// Fused log-mel spectrogram for Hopper (sm_90a): a real FFT in shared memory.
//
// Replaces the Pallas kernel `_mel_kernel_factory` / `mel_spectrogram_pallas`
// (amphion_tpu/ops/pallas_kernels.py:352-442): reflect pad, framing, Hann
// window, DFT, magnitude sqrt(re^2 + im^2 + 1e-6), mel projection,
// log(max(., clip)).
//
// What bounds it on the H100: neither bytes nor operations. A frame reads
// hop new samples (480 bytes at hop 120) and writes n_mel floats, and its
// FFT, magnitudes and mel sums are about 19 000 operations; at the main
// path's lengths (about 840 frames a call) that is a fraction of a
// microsecond of either. What is left is latency: the launch, one round
// trip to device memory for the samples, and the FFT's barriers. A direct
// windowed DFT would spend 2 * 513 * 479 float32 FMAs a frame, about 50
// times the FFT's operations, and be bound by the FMA rate instead.
//
// What the design does about it:
//  * one block per (batch row, tile of FRAMES frames) loads the tile's
//    samples into shared memory once, the reflect pad done by index
//    arithmetic, beside the window's nonzero taps and the twiddle table;
//    frames are overlapping windows over that buffer. 4 frames and 512
//    threads a block were the fastest of 2, 4 and 8 frames with 128 to 1024
//    threads at a timbre batch's lengths (about 840 frames, B = 1: 210
//    blocks for 132 SMs; tools/kernel_ab.py);
//  * a real FFT of n = n_fft points as a complex FFT of M = n / 2 points,
//    z[m] = x[2m] + i x[2m+1], then one split pass that yields the F = M + 1
//    bins. The complex FFT runs as Stockham passes (radix 8, the last one
//    radix 4 or 2 where log2 M is not a multiple of 3), each reading one
//    buffer and writing the other, so no bit-reversal pass is needed and a
//    pass costs one barrier; the first pass reads the windowed samples
//    directly. One float2 of padding every 32 keeps the passes' strided
//    writes from piling onto a few banks;
//  * twiddles come from a table the wrapper computed in float64 and rounded
//    to float32 (W_n^e = exp(-2 pi i e / n), e < n), not from __sinf;
//  * the split pass takes bins k and M - k from the same pair Z[k],
//    Z[M - k] and writes both magnitudes to shared memory (row stride F,
//    odd, so the mel sums read without bank conflicts);
//  * the mel projection sums only each band's nonzero bins: the wrapper
//    passes each band's first bin, its count and its offset into the
//    compacted weights (about 1 000 nonzeros of the 80 x 513 filterbank),
//    then log(max(., clip)); neighbouring threads write neighbouring frames.
// Plain float32 arithmetic throughout: no TF32, no tensor cores. n_fft is a
// power of two from 256 to 2048 (M = 128 ... 1024); the wrapper checks it.

#include <cuda_runtime.h>

namespace {

constexpr int FRAMES = 4;  // frames per block
constexpr int THREADS = 512;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 times_minus_i(float2 a) { return make_float2(a.y, -a.x); }

// In place, a[k] <- sum_r a[r] exp(-2 pi i r k / R), natural order.
template <int R>
__device__ __forceinline__ void dft(float2 (&a)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&a)[2]) {
  const float2 t = a[0];
  a[0] = cadd(t, a[1]);
  a[1] = csub(t, a[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&a)[4]) {
  const float2 d0 = cadd(a[0], a[2]), d1 = cadd(a[1], a[3]);
  const float2 e0 = csub(a[0], a[2]), e1 = times_minus_i(csub(a[1], a[3]));
  a[0] = cadd(d0, d1);
  a[2] = csub(d0, d1);
  a[1] = cadd(e0, e1);
  a[3] = csub(e0, e1);
}

// Radix 2 by decimation in frequency, then two 4-point DFTs.
template <>
__device__ __forceinline__ void dft<8>(float2 (&a)[8]) {
  constexpr float h = 0.70710678118654752f;
  float2 b[4], c[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    b[n] = cadd(a[n], a[n + 4]);
    c[n] = csub(a[n], a[n + 4]);
  }
  c[1] = make_float2((c[1].x + c[1].y) * h, (c[1].y - c[1].x) * h);   // * W8
  c[2] = times_minus_i(c[2]);                                          // * W8^2
  c[3] = make_float2((c[3].y - c[3].x) * h, -(c[3].x + c[3].y) * h);  // * W8^3
  dft<4>(b);
  dft<4>(c);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[2 * k] = b[k];
    a[2 * k + 1] = c[k];
  }
}

// Index of complex point e of a frame's buffer: a float2 of padding every 32.
__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

template <int M>
__host__ __device__ constexpr int frame_stride() { return M + M / 32; }

// The radix of the Stockham pass that follows sub-transforms of size NS.
template <int M, int NS>
__host__ __device__ constexpr int radix() { return M / NS >= 8 ? 8 : M / NS; }

// One Stockham pass: R-point DFTs join R sub-transforms of size NS into
// transforms of size NS * R, for every frame of the tile.
template <int M, int R, int NS>
__device__ __forceinline__ void stockham_pass(const float2* src, float2* dst,
                                              const float2* tw) {
  constexpr int B = M / R;                 // DFTs per frame
  constexpr int STEP = 2 * M / (NS * R);   // W_{NS R}^{rk} = W_n^{rk STEP}
  for (int u = threadIdx.x; u < FRAMES * B; u += THREADS) {
    const int f = u / B, j = u % B, k = j & (NS - 1);
    const float2* s = src + f * frame_stride<M>();
    float2* d = dst + f * frame_stride<M>();
    float2 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = s[pad(j + r * B)];
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) a[r] = cmul(a[r], tw[r * k * STEP]);
    }
    dft<R>(a);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) d[pad(base + r * NS)] = a[r];
  }
}

// The passes after the first; returns the buffer that holds the result.
template <int M, int NS>
__device__ __forceinline__ float2* passes(float2* src, float2* dst, const float2* tw) {
  if constexpr (NS >= M) {
    return src;
  } else {
    constexpr int R = radix<M, NS>();
    stockham_pass<M, R, NS>(src, dst, tw);
    __syncthreads();
    return passes<M, NS * R>(dst, src, tw);
  }
}

template <int M>
__global__ void __launch_bounds__(THREADS)
mel_kernel(const float* __restrict__ y, const float* __restrict__ win,
           const float2* __restrict__ tw, const int* __restrict__ bands,
           const float* __restrict__ weights, float* __restrict__ out, int T, int N,
           int hop, int pad_len, int tap0, int ntaps, int n_mel, float clip) {
  constexpr int FS = frame_stride<M>();
  constexpr int F = M + 1;
  constexpr int R1 = radix<M, 1>();
  extern __shared__ float2 smem2[];
  float2* tw_s = smem2;                      // [2M]
  float2* buf_a = tw_s + 2 * M;              // [FRAMES][FS]
  float2* buf_b = buf_a + FRAMES * FS;       // [FRAMES][FS]
  float* win_s = reinterpret_cast<float*>(buf_b + FRAMES * FS);  // [ntaps]
  float* samples = win_s + ntaps;            // [(FRAMES - 1) hop + ntaps]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FRAMES;
  const int nf = min(FRAMES, N - f0);
  const int span = (FRAMES - 1) * hop + ntaps;  // samples one tile reads
  const int used = (nf - 1) * hop + ntaps;       // samples valid frames read

  // the tile's samples (reflect pad by index arithmetic), window, twiddles
  const float* yb = y + (size_t)b * T;
  const long start = (long)f0 * hop + tap0 - pad_len;
  for (int s = threadIdx.x; s < span; s += THREADS) {
    float v = 0.f;
    if (s < used) {
      long p = start + s;
      if (p < 0) p = -p;
      if (p >= T) p = 2 * (long)(T - 1) - p;
      v = yb[p];
    }
    samples[s] = v;
  }
  for (int i = threadIdx.x; i < ntaps; i += THREADS) win_s[i] = win[i];
  for (int i = threadIdx.x; i < 2 * M; i += THREADS) tw_s[i] = tw[i];
  __syncthreads();

  // first pass (NS = 1, no twiddles) straight from the windowed samples:
  // z[m] = x[2m] + i x[2m+1], x[t] = win[t] * sample, zero off the window
  {
    constexpr int B = M / R1;
    for (int u = threadIdx.x; u < FRAMES * B; u += THREADS) {
      const int f = u / B, j = u % B;
      const float* sf = samples + f * hop;
      float2 a[R1];
#pragma unroll
      for (int r = 0; r < R1; ++r) {
        const int t = 2 * (j + r * B) - tap0;  // tap offset into the window
        a[r].x = (unsigned)t < (unsigned)ntaps ? win_s[t] * sf[t] : 0.f;
        a[r].y = (unsigned)(t + 1) < (unsigned)ntaps ? win_s[t + 1] * sf[t + 1] : 0.f;
      }
      dft<R1>(a);
      float2* d = buf_a + f * FS;
#pragma unroll
      for (int r = 0; r < R1; ++r) d[pad(j * R1 + r)] = a[r];
    }
  }
  __syncthreads();
  float2* z = passes<M, R1>(buf_a, buf_b, tw_s);
  float* mag = reinterpret_cast<float*>(z == buf_a ? buf_b : buf_a);  // [FRAMES][F]

  // split: X[k] = Xe + W^k Xo and X[M - k] = conj(Xe - W^k Xo), with
  // Xe = (Z[k] + conj Z[M-k]) / 2 and Xo = -i (Z[k] - conj Z[M-k]) / 2
  constexpr int H = M / 2 + 1;
  for (int u = threadIdx.x; u < FRAMES * H; u += THREADS) {
    const int f = u / H, k = u - f * H;
    const float2* zf = z + f * FS;
    const float2 zk = zf[pad(k)], zm = zf[pad((M - k) & (M - 1))];
    const float2 xe = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    const float2 xo = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
    const float2 p = cmul(tw_s[k], xo);
    float* mg = mag + f * F;
    const float ar = xe.x + p.x, ai = xe.y + p.y;
    mg[k] = sqrtf(ar * ar + ai * ai + 1e-6f);
    if (k != M / 2) {
      const float br = xe.x - p.x, bi = xe.y - p.y;
      mg[M - k] = sqrtf(br * br + bi * bi + 1e-6f);
    }
  }
  __syncthreads();

  // mel projection over each band's nonzero bins, then log
  for (int u = threadIdx.x; u < FRAMES * n_mel; u += THREADS) {
    const int f = u % FRAMES, m = u / FRAMES;
    if (f >= nf) continue;
    const int first = __ldg(bands + 3 * m), count = __ldg(bands + 3 * m + 1);
    const float* w = weights + __ldg(bands + 3 * m + 2);
    const float* mg = mag + f * F + first;
    float acc = 0.f;
    for (int i = 0; i < count; ++i) acc = fmaf(__ldg(w + i), mg[i], acc);
    out[((size_t)b * n_mel + m) * N + f0 + f] = logf(fmaxf(acc, clip));
  }
}

template <int M>
int launch(const float* y, const float* win, const float2* tw, const int* bands,
           const float* weights, float* out, int B, int T, int N, int hop, int pad_len,
           int tap0, int ntaps, int n_mel, float clip, cudaStream_t stream) {
  const size_t smem = sizeof(float2) * (2 * M + 2 * FRAMES * frame_stride<M>())
                      + sizeof(float) * (ntaps + (FRAMES - 1) * hop + ntaps);
  // once per instance, so that no attribute call falls inside a CUDA-graph
  // capture: up to the 227 KB a block may use on the H100
  static const cudaError_t attr = cudaFuncSetAttribute(
      mel_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + FRAMES - 1) / FRAMES, B);
  mel_kernel<M><<<grid, THREADS, smem, stream>>>(y, win, tw, bands, weights, out, T, N, hop,
                                                 pad_len, tap0, ntaps, n_mel, clip);
  return (int)cudaGetLastError();
}

}  // namespace

// y (B, T) f32; win (ntaps,) f32: the padded Hann window's taps [tap0,
// tap0 + ntaps) (zero elsewhere); tw (n_fft,) float2: W_n^e; bands (n_mel, 3)
// int32: each band's first bin, bin count and offset into weights (its
// nonzero filterbank weights, in bin order); out (B, n_mel, N) f32. Frame i
// covers padded samples [i*hop, i*hop + n_fft) of y reflect-padded by `pad`
// on both sides. n_fft a power of two in [256, 2048]. Returns a CUDA error
// code (cudaErrorInvalidValue for another n_fft).
extern "C" int mel_fwd(const void* y, const void* win, const void* tw, const void* bands,
                       const void* weights, void* out, int B, int T, int N, int n_fft,
                       int hop, int pad, int tap0, int ntaps, int n_mel, float clip,
                       void* stream) {
  const auto go = [&](auto launcher) {
    return launcher((const float*)y, (const float*)win, (const float2*)tw, (const int*)bands,
                    (const float*)weights, (float*)out, B, T, N, hop, pad, tap0, ntaps, n_mel,
                    clip, (cudaStream_t)stream);
  };
  switch (n_fft) {
    case 256: return go(launch<128>);
    case 512: return go(launch<256>);
    case 1024: return go(launch<512>);
    case 2048: return go(launch<1024>);
    default: return (int)cudaErrorInvalidValue;
  }
}
