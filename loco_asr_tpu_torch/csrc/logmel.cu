// Log-mel front end (kernel B7): waveform -> log10 slaney-mel frames.
//
// Replaces: loco_asr_tpu/ops/pallas/logmel.py::_logmel_kernel (public
// fused_log_mel).  Each frame of hop `hop` is cut from the row reflect-padded
// by frame_length/2 on both sides (numpy's rule: a pad longer than the row
// reflects again, period 2(T-1)), multiplied by the periodic Hann window,
// zero-filled to fft_length, and turned into |rfft| (fft_length/2 + 1 bins),
// slaney mel sums and log10(max(mel, floor)).  Output [rows, frames, n_mel].
//
// What bounds it on an H100: the bytes, barely.  At the main path's
// [8, 160000] (5,008 frames) the function reads 5.12 MB of waveform and
// writes 1.60 MB of log-mel, ~2.0 us at 3.35 TB/s.  Its least work is
// ~23.6 kFLOP a frame: the window, a 512-point complex FFT at the
// split-radix count, the real post-pass and magnitudes of the 481 bins the
// bank reads, and 942 mel weights; ~0.12 GFLOP, ~1.8 us at 67 TFLOP/s.  The
// TPU kernel's DFT as two [frames, 1024] x [1024, 513] matmuls would need
// 10.9 GFLOP here, so an FFT takes their place.  What holds a frame back
// is latency: ~24 kFLOP of dependent steps behind its loads.  A block of
// 256 threads a frame, nine radix-2 stages each behind a block barrier,
// twiddles from global memory and a modulo for every sample spent 0.10 ms
// on it.
//
// Design (m = fft_length / 2 <= 512): one warp a frame, 8 warps a block,
// a persistent grid (the SMs times the blocks that fit on one) whose warps
// walk the frames.
// - The 1024 real samples are packed as 512 complex points z[n] = x[2n] +
//   i x[2n+1], 16 to a lane, and go through a Stockham autosort FFT of
//   radix-8 passes (8 * 8 * 8; 32 to 256 points end in a radix-4 or
//   radix-2 pass): a pass reads its R inputs n = i + r m/R of each
//   butterfly i, multiplies input r by W_{Rp}^{r (i mod p)}, takes the
//   R-point DFT in registers and writes output s to (i - i mod p) R +
//   i mod p + s p (p: the product of the earlier radices).
// - The first pass reads its inputs straight from the waveform.  A frame
//   that lies inside its row (base >= 0, base + frame_length <= T, one test
//   for the whole warp) and fills the FFT is read with 8-byte loads where
//   the row is 8-byte aligned; only the edge frames take the reflect index.
// - The passes exchange through the warp's own 4 KB of shared memory,
//   XOR-swizzled (bits 6..4 of n into bits 2..0, bit 6 into bit 3) so that
//   the 512-point passes' reads and scattered writes are free of bank
//   conflicts; only __syncwarp orders them.  The swizzle is linear over
//   GF(2), so each exchange costs a lane one XOR with a constant.
// - The real post-pass X[k] = E[k] + W_N^k O[k] gives bins k and M - k from
//   the same two points (X[M-k] = conj(E[k] - W_N^k O[k])), and writes the
//   magnitudes of the bins the bank reads to the warp's slice.  Each lane
//   then sums the mel bins it owns (lane, lane + 32, ...) over the sparse
//   (first bin, count) table, takes log10(max(., floor)), and the frame's
//   n_mel values go out as one coalesced row.
// - Accuracy against a float64 log-mel: log10f's 2-ulp error was the
//   largest part of this kernel's error, so the log takes the exponent
//   apart (log10_split; both kernels).  The magnitudes use sqrt.approx: on
//   the H100 IEEE sqrtf left the largest error of every tested case
//   unchanged and cost ~9 % of the device time (PERF.md).
// - Twiddles of every pass and of the post-pass (a [2m] table the wrapper
//   builds in float64), the window (zero past frame_length) and the sparse
//   bank are staged once a block.
// m = 1024 and 2048 (fft_length 2048, 4096) keep the block-per-frame
// radix-2 kernel described above (logmel_block_kernel): 32 or 64 points a
// lane would not fit in registers, and the main path never takes them.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "tf32_mma.cuh"   // allow_smem_once

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 3;        // blocks an SM the registers must allow
constexpr int BLOCK_THREADS = 256;   // the block-per-frame kernel (m > 512)

// numpy's reflect padding: source index of position i (any integer) of a
// row of n samples reflected about its ends, again and again
__device__ __forceinline__ int reflect(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// R-point DFT in place, outputs in natural order (decimation in frequency)
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&v)[2]) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  const float2 a0 = cadd(v[0], v[2]), a2 = csub(v[0], v[2]);
  const float2 a1 = cadd(v[1], v[3]), a3 = mul_neg_i(csub(v[1], v[3]));
  v[0] = cadd(a0, a1);
  v[2] = csub(a0, a1);
  v[1] = cadd(a2, a3);
  v[3] = csub(a2, a3);
}

template <>
__device__ __forceinline__ void dft<8>(float2 (&v)[8]) {
  constexpr float H = 0.70710678118654752f;
  float2 a[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = cadd(v[i], v[i + 4]);
    a[i + 4] = csub(v[i], v[i + 4]);
  }
  // a5 W8, a6 W8^2 = -i, a7 W8^3
  a[5] = make_float2(H * (a[5].x + a[5].y), H * (a[5].y - a[5].x));
  a[6] = mul_neg_i(a[6]);
  a[7] = make_float2(H * (a[7].y - a[7].x), -H * (a[7].x + a[7].y));
  const float2 b0 = cadd(a[0], a[2]), b2 = csub(a[0], a[2]);
  const float2 b1 = cadd(a[1], a[3]), b3 = mul_neg_i(csub(a[1], a[3]));
  const float2 b4 = cadd(a[4], a[6]), b6 = csub(a[4], a[6]);
  const float2 b5 = cadd(a[5], a[7]), b7 = mul_neg_i(csub(a[5], a[7]));
  v[0] = cadd(b0, b1);
  v[4] = csub(b0, b1);
  v[2] = cadd(b2, b3);
  v[6] = csub(b2, b3);
  v[1] = cadd(b4, b5);
  v[5] = csub(b4, b5);
  v[3] = cadd(b6, b7);
  v[7] = csub(b6, b7);
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log10 of a positive float, nearer than log10f's 2 ulps: s = m 2^e with
// m in [sqrt(1/2), sqrt(2)), log10 s = e log10(2) + log10 m; |log10 m| <
// 0.151, so log10f's error there is < 3e-8, and e log10(2) (a hi + lo
// pair) joins it in one rounding
__device__ __forceinline__ float log10_split(float s) {
  int e;
  float m = frexpf(s, &e);
  if (m < 0.70710678f) { m *= 2.f; --e; }
  const float fe = (float)e;
  return fmaf(fe, 0.30103001f, fmaf(fe, -1.4320989e-08f, log10f(m)));
}

// the warp's slice: point n at n with bits 6..4 XORed into bits 2..0 and
// bit 6 into bit 3 (a permutation within each 16 points).  The map is
// linear over GF(2): swz(a ^ b) = swz(a) ^ swz(b), so an index made of a
// lane's bits and a compile-time part on other bits costs one XOR.
__host__ __device__ constexpr int swz(int n) { return n ^ (((n >> 4) & 7) | ((n >> 3) & 8)); }

// where a Stockham pass with p = 2^LOGP, radix 2^LOGR writes output 0 of
// butterfly i: (i - i mod p) R + i mod p, linear over GF(2) in i's bits
template <int LOGP, int LOGR>
__host__ __device__ constexpr int out_pos(int i) {
  return ((i >> LOGP) << (LOGP + LOGR)) | (i & ((1 << LOGP) - 1));
}

// one frame's samples as complex points z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1]
struct Frame {
  const float* x;       // the row
  int base, T, L;       // first sample (may be < 0), row length, frame_length
  bool interior;        // base >= 0 and base + L <= T
  bool fast;            // interior, 8-byte aligned and L = fft_length
  __device__ __forceinline__ float2 point(int n, float2 w) const {
    const int n0 = 2 * n;
    if (interior)
      return make_float2(n0 < L ? __ldg(x + base + n0) * w.x : 0.f,
                         n0 + 1 < L ? __ldg(x + base + n0 + 1) * w.y : 0.f);
    return make_float2(n0 < L ? __ldg(x + reflect(base + n0, T)) * w.x : 0.f,
                       n0 + 1 < L ? __ldg(x + reflect(base + n0 + 1, T)) * w.y : 0.f);
  }
};

// one Stockham pass of radix R = 2^LOGR over M points, p = 2^LOGP the
// earlier radices' product; the first pass reads the frame, the others
// the warp's slice
template <int LOG2M, int LOGR, int LOGP>
__device__ __forceinline__ void fft_pass(float2* buf, const float2* tw, const float2* win,
                                         const Frame& fr, int lane) {
  constexpr int M = 1 << LOG2M, R = 1 << LOGR, P = 1 << LOGP;
  constexpr int NB = M / R;                       // butterflies
  constexpr int BPL = (NB + 31) / 32;             // a lane's butterflies
  const bool active = NB % 32 == 0 || lane < NB;
  float2 v[BPL][R];
  if (LOGP == 0) {
    if (fr.fast) {
      const float2* x2 = reinterpret_cast<const float2*>(fr.x + fr.base);
#pragma unroll
      for (int bb = 0; bb < BPL; ++bb)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int n = lane + 32 * bb + r * NB;
          if (active) {
            const float2 s = __ldg(x2 + n), w = win[n];
            v[bb][r] = make_float2(s.x * w.x, s.y * w.y);
          }
        }
    } else {
#pragma unroll
      for (int bb = 0; bb < BPL; ++bb)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int n = lane + 32 * bb + r * NB;
          if (active) v[bb][r] = fr.point(n, win[n]);
        }
    }
  } else {
    const int rl = swz(lane);
#pragma unroll
    for (int bb = 0; bb < BPL; ++bb)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (active) v[bb][r] = buf[rl ^ swz(32 * bb + r * NB)];
    __syncwarp();
  }
  const int wl = swz(out_pos<LOGP, LOGR>(lane));
#pragma unroll
  for (int bb = 0; bb < BPL; ++bb) {
    if (active) {
      if (P > 1) {
        const int k = (lane + 32 * bb) & (P - 1);
#pragma unroll
        for (int r = 1; r < R; ++r) v[bb][r] = cmul(v[bb][r], tw[P - 1 + (r - 1) * P + k]);
      }
      dft<R>(v[bb]);
#pragma unroll
      for (int s = 0; s < R; ++s)
        buf[wl ^ swz(out_pos<LOGP, LOGR>(32 * bb) | (s << LOGP))] = v[bb][s];
    }
  }
  __syncwarp();
}

// the passes from p = 2^LOGP on: radix 8 while 8 divides what is left,
// then 4 or 2
template <int LOG2M, int LOGP>
__device__ __forceinline__ void fft_rest(float2* buf, const float2* tw, const float2* win,
                                         const Frame& fr, int lane) {
  constexpr int LEFT = LOG2M - LOGP;
  if constexpr (LEFT > 0) {
    constexpr int LOGR = LEFT >= 3 ? 3 : LEFT;
    fft_pass<LOG2M, LOGR, LOGP>(buf, tw, win, fr, lane);
    fft_rest<LOG2M, LOGP + LOGR>(buf, tw, win, fr, lane);
  }
}

// shared memory of the warp kernel: WARPS slices of M points, the [2M]
// twiddles, the window as M pairs, the bank's (first bin, count) pairs,
// WARPS slices of M + 2 magnitudes and the bank's [n_mel, mel_stride]
// weights
size_t warp_smem_bytes(int log2_m, int n_mel, int mel_stride) {
  const size_t m = (size_t)1 << log2_m;
  return (WARPS * m + 2 * m + m + n_mel) * sizeof(float2) +
         (WARPS * (m + 2) + (size_t)n_mel * mel_stride) * sizeof(float);
}

template <int LOG2M>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
logmel_warp_kernel(const float* __restrict__ wav, const float* __restrict__ window,
                   const float2* __restrict__ twiddle, const int2* __restrict__ mel_range,
                   const float* __restrict__ mel_w, float* __restrict__ out, int T,
                   int n_frames, int total, int frame_length, int hop, int pad, int n_mel,
                   int mel_stride, int bin_lo, int bin_hi, float mel_floor) {
  constexpr int M = 1 << LOG2M;
  extern __shared__ float2 smem[];
  float2* tw = smem + WARPS * M;                       // [2M]
  float2* win = tw + 2 * M;                            // [M]
  int2* rng = reinterpret_cast<int2*>(win + M);        // [n_mel]
  float* mags = reinterpret_cast<float*>(rng + n_mel); // [WARPS][M + 2]
  float* mw = mags + WARPS * (M + 2);                  // [n_mel * mel_stride]
  for (int i = threadIdx.x; i < 2 * M; i += THREADS) tw[i] = twiddle[i];
  for (int i = threadIdx.x; i < M; i += THREADS)
    win[i] = reinterpret_cast<const float2*>(window)[i];
  for (int i = threadIdx.x; i < n_mel; i += THREADS) rng[i] = mel_range[i];
  for (int i = threadIdx.x; i < n_mel * mel_stride; i += THREADS) mw[i] = mel_w[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2* buf = smem + warp * M;
  float* mag = mags + warp * (M + 2);
  const float2* post = tw + M - 1;                     // W_N^k, k = 0..M
  for (int g = blockIdx.x * WARPS + warp; g < total; g += gridDim.x * WARPS) {
    const int row = g / n_frames;
    Frame fr;
    fr.x = wav + (size_t)row * T;
    fr.base = (g - row * n_frames) * hop - pad;
    fr.T = T;
    fr.L = frame_length;
    fr.interior = fr.base >= 0 && fr.base + frame_length <= T;
    fr.fast = fr.interior && frame_length == 2 * M &&
              ((reinterpret_cast<size_t>(fr.x) + 4 * (size_t)max(fr.base, 0)) & 7) == 0;
    fft_rest<LOG2M, 0>(buf, tw, win, fr, lane);

    // real-input post-pass: E[k] = (Z[k] + conj Z[M-k]) / 2 (even samples),
    // O[k] = (Z[k] - conj Z[M-k]) / 2i (odd samples), X[k] = E + W_N^k O;
    // bin M - k comes from the same two points, X[M-k] = conj(E - W_N^k O)
    const int sl = swz(lane);
#pragma unroll
    for (int j = 0; j < M / 64 + 1; ++j) {
      const int k = lane + 32 * j;
      if (k <= M / 2) {
        const float2 a = buf[sl ^ swz(32 * j)];
        const float2 c = buf[swz((M - k) & (M - 1))];
        const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
        const float orr = 0.5f * (a.y + c.y), oi = 0.5f * (c.x - a.x);
        const float2 w = post[k];
        const float tr = w.x * orr - w.y * oi, ti = w.x * oi + w.y * orr;
        if (k >= bin_lo && k < bin_hi)
          mag[k] = sqrt_approx((er + tr) * (er + tr) + (ei + ti) * (ei + ti));
        if (k != M - k && M - k >= bin_lo && M - k < bin_hi)
          mag[M - k] = sqrt_approx((er - tr) * (er - tr) + (ei - ti) * (ei - ti));
      }
    }
    __syncwarp();

    float* o = out + (size_t)g * n_mel;
    for (int m = lane; m < n_mel; m += 32) {
      const int2 r = rng[m];
      const float* w = mw + m * mel_stride;
      float s = 0.f;
      for (int j = 0; j < r.y; ++j) s = fmaf(mag[r.x + j], w[j], s);
      o[m] = log10_split(fmaxf(s, mel_floor));
    }
  }
}

// m = 1024, 2048: one block a frame, the 2^log2_m complex
// points in bit-reversed shared slots, radix-2 DIT stages behind block
// barriers; twiddle = the post-pass table W_N^k, k = 0..m
__global__ void __launch_bounds__(BLOCK_THREADS)
logmel_block_kernel(const float* __restrict__ wav, const float* __restrict__ window,
                    const float2* __restrict__ twiddle, const int2* __restrict__ mel_range,
                    const float* __restrict__ mel_w, float* __restrict__ out, int T,
                    int n_frames, int frame_length, int hop, int pad, int log2_m, int n_mel,
                    int mel_stride, float mel_floor) {
  extern __shared__ float2 smem[];
  const int M = 1 << log2_m;
  float2* z = smem;                                   // [M]
  float* mag = reinterpret_cast<float*>(smem + M);    // [M + 1]
  float* melv = mag + M + 1;                          // [n_mel]

  const int g = blockIdx.x;
  const int row = g / n_frames;
  const int f = g - row * n_frames;
  const float* x = wav + (size_t)row * T;
  const int base = f * hop - pad;

  for (int k = threadIdx.x; k < M; k += blockDim.x) {
    const int n0 = 2 * k, n1 = n0 + 1;
    const float re = n0 < frame_length ? x[reflect(base + n0, T)] * window[n0] : 0.f;
    const float im = n1 < frame_length ? x[reflect(base + n1, T)] * window[n1] : 0.f;
    z[__brev(k) >> (32 - log2_m)] = make_float2(re, im);
  }
  __syncthreads();
  for (int h = 1; h < M; h <<= 1) {
    const int step = M / h;
    for (int b = threadIdx.x; b < M / 2; b += blockDim.x) {
      const int pos = b & (h - 1);
      const int i0 = ((b - pos) << 1) + pos;
      const int i1 = i0 + h;
      const float2 u = z[i0], v = cmul(z[i1], twiddle[pos * step]);
      z[i0] = cadd(u, v);
      z[i1] = csub(u, v);
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k <= M; k += blockDim.x) {
    const float2 a = z[k & (M - 1)];
    const float2 c = z[(M - k) & (M - 1)];
    const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
    const float orr = 0.5f * (a.y + c.y), oi = 0.5f * (c.x - a.x);
    const float2 w = twiddle[k];
    const float xr = er + w.x * orr - w.y * oi;
    const float xi = ei + w.x * oi + w.y * orr;
    mag[k] = sqrtf(xr * xr + xi * xi);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < n_mel; m += blockDim.x >> 5) {
    const int2 r = mel_range[m];
    const float* w = mel_w + (size_t)m * mel_stride;
    float s = 0.f;
    for (int j = lane; j < r.y; j += 32) s += mag[r.x + j] * w[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) melv[m] = log10_split(fmaxf(s, mel_floor));
  }
  __syncthreads();
  float* o = out + (size_t)g * n_mel;
  for (int m = threadIdx.x; m < n_mel; m += blockDim.x) o[m] = melv[m];
}

template <int LOG2M>
struct WarpKernel {
  static std::atomic<unsigned long long> done;
};
template <int LOG2M>
std::atomic<unsigned long long> WarpKernel<LOG2M>::done{0};

using WarpFn = void (*)(const float*, const float*, const float2*, const int2*, const float*,
                        float*, int, int, int, int, int, int, int, int, int, int, float);

// the warp kernel for 32 <= m <= 512, with its shared-memory limit raised
// to the device's most on first use; nullptr for other m
WarpFn warp_kernel(int log2_m, cudaError_t* e) {
  *e = cudaSuccess;
  switch (log2_m) {
#define LOCO_CASE(L)                                                             \
  case L:                                                                        \
    *e = allow_smem_once(logmel_warp_kernel<L>, 0, WarpKernel<L>::done);         \
    return logmel_warp_kernel<L>;
    LOCO_CASE(5) LOCO_CASE(6) LOCO_CASE(7) LOCO_CASE(8) LOCO_CASE(9)
#undef LOCO_CASE
    default:
      return nullptr;
  }
}

}  // namespace

// Shared memory of one block of the kernel for 2^log2_m complex points.
extern "C" size_t loco_logmel_smem_bytes(int log2_m, int n_mel, int mel_stride) {
  const size_t m = (size_t)1 << log2_m;
  if (log2_m > 9) return m * sizeof(float2) + (m + 1 + n_mel) * sizeof(float);
  return warp_smem_bytes(log2_m, n_mel, mel_stride);
}

// Blocks of the warp kernel that fit on one SM of the current device (the
// persistent grid is this times the SM count); 0 where m > 512 (one block a
// frame), negative on a CUDA error.
extern "C" int loco_logmel_blocks_per_sm(int log2_m, int n_mel, int mel_stride) {
  cudaError_t e;
  const WarpFn fn = warp_kernel(log2_m, &e);
  if (e != cudaSuccess) return -(int)e;
  if (fn == nullptr) return 0;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, fn, THREADS, warp_smem_bytes(log2_m, n_mel, mel_stride));
  return e == cudaSuccess ? n : -(int)e;
}

// wav [rows, T] f32; window [2^(log2_m + 1)] (zero past frame_length);
// twiddle [2M] float2, M = 2^log2_m = fft_length / 2: the passes' tables
// then W_N^k for k = 0..M at M - 1; mel_range [n_mel] int2 (first bin,
// count); mel_w [n_mel, mel_stride]; the bank reads bins [bin_lo, bin_hi);
// grid: blocks of the persistent warp kernel (ignored where M > 512);
// out [rows, n_frames, n_mel].
extern "C" int loco_logmel(const void* wav, const void* window, const void* twiddle,
                           const void* mel_range, const void* mel_w, void* out, int rows,
                           int T, int n_frames, int frame_length, int hop, int pad,
                           int log2_m, int n_mel, int mel_stride, int bin_lo, int bin_hi,
                           int grid, float mel_floor, void* stream) {
  const long long total = (long long)rows * n_frames;
  if (total == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int M = 1 << log2_m;
  cudaError_t e;
  const WarpFn fn = warp_kernel(log2_m, &e);
  if (e != cudaSuccess) return (int)e;
  if (fn != nullptr) {
    if (grid < 1) return (int)cudaErrorInvalidValue;
    fn<<<grid, THREADS, warp_smem_bytes(log2_m, n_mel, mel_stride), st>>>(
        (const float*)wav, (const float*)window, (const float2*)twiddle,
        (const int2*)mel_range, (const float*)mel_w, (float*)out, T, n_frames, (int)total,
        frame_length, hop, pad, n_mel, mel_stride, bin_lo, bin_hi, mel_floor);
  } else {
    logmel_block_kernel<<<(unsigned)total, BLOCK_THREADS,
                          loco_logmel_smem_bytes(log2_m, n_mel, mel_stride), st>>>(
        (const float*)wav, (const float*)window, (const float2*)twiddle + (M - 1),
        (const int2*)mel_range, (const float*)mel_w, (float*)out, T, n_frames, frame_length,
        hop, pad, log2_m, n_mel, mel_stride, mel_floor);
  }
  return (int)cudaGetLastError();
}
