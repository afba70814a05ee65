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
// split-radix count (~15.4k, no multiply by a twiddle of +-1 or +-i), the
// real post-pass and magnitudes of the 481 bins the bank reads, and 942 mel
// weights (each bin lies in at most two triangles); ~0.12 GFLOP, ~1.8 us at
// 67 TFLOP/s.  The TPU kernel's DFT as two [frames, 1024] x [1024, 513]
// matmuls (the MXU made that cheaper than XLA's TPU FFT) would need ~2.1
// MFLOP a frame, 10.9 GFLOP here: a 0.163 ms floor on the CUDA cores in
// f32, ~90x the FFT's.  So the DFT matmuls go, and an FFT in shared memory
// takes their place.
//
// Design: one block of 256 threads per frame.  The block reads its frame
// straight from the waveform, with the reflect index computed here, so the
// [frames, 1024] frame tensor (4x the waveform) is never written.  The
// 1024 real samples are packed as 512 complex points z[k] = x[2k] + i
// x[2k+1] into bit-reversed slots of shared memory (4 KB), a radix-2
// decimation-in-time FFT runs in place (9 stages, one butterfly a thread a
// stage), and the real-input post-pass X[k] = E[k] + W^k O[k], k = 0..512,
// gives the magnitudes (2 KB).  One warp per mel bin then sums the bin's
// triangle over its contiguous range of FFT bins (a sparse, padded
// [n_mel, max_len] weight table) and the block writes its n_mel outputs in
// one coalesced row.  Window, twiddles exp(-2 pi i k / fft_length) and the
// sparse bank are small float32 tensors the wrapper builds in float64 and
// caches per device.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

// numpy's reflect padding: source index of position i (any integer) of a
// row of n samples reflected about its ends, again and again
__device__ __forceinline__ int reflect(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

__global__ void __launch_bounds__(THREADS)
logmel_kernel(const float* __restrict__ wav, const float* __restrict__ window,
              const float2* __restrict__ twiddle,
              const int* __restrict__ mel_range,
              const float* __restrict__ mel_w, float* __restrict__ out,
              int T, int n_frames, int frame_length, int hop, int pad,
              int log2_m, int n_mel, int mel_stride, float mel_floor) {
  extern __shared__ float2 smem[];
  const int M = 1 << log2_m;                          // complex points
  float2* z = smem;                                   // [M]
  float* mag = reinterpret_cast<float*>(smem + M);    // [M + 1]
  float* melv = mag + M + 1;                          // [n_mel]

  const int g = blockIdx.x;
  const int row = g / n_frames;
  const int f = g - row * n_frames;
  const float* x = wav + (size_t)row * T;
  const int base = f * hop - pad;

  // windowed sample pairs -> bit-reversed complex slots
  for (int k = threadIdx.x; k < M; k += blockDim.x) {
    const int n0 = 2 * k, n1 = n0 + 1;
    const float re = n0 < frame_length ? x[reflect(base + n0, T)] * window[n0] : 0.f;
    const float im = n1 < frame_length ? x[reflect(base + n1, T)] * window[n1] : 0.f;
    z[__brev(k) >> (32 - log2_m)] = make_float2(re, im);
  }
  __syncthreads();

  // radix-2 DIT: stage with half-width h pairs i0 = 2h*group + pos and
  // i0 + h under W_M^(pos M / 2h) = W_N^(pos M / h), N = 2M
  for (int h = 1; h < M; h <<= 1) {
    const int step = M / h;
    for (int b = threadIdx.x; b < M / 2; b += blockDim.x) {
      const int pos = b & (h - 1);
      const int i0 = ((b - pos) << 1) + pos;
      const int i1 = i0 + h;
      const float2 w = twiddle[pos * step];
      const float2 u = z[i0], v0 = z[i1];
      const float2 v = make_float2(v0.x * w.x - v0.y * w.y, v0.x * w.y + v0.y * w.x);
      z[i0] = make_float2(u.x + v.x, u.y + v.y);
      z[i1] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }

  // real-input post-pass: E[k] = (Z[k] + conj Z[M-k]) / 2 (even samples),
  // O[k] = (Z[k] - conj Z[M-k]) / 2i (odd samples), X[k] = E + W_N^k O
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

  // one warp per mel bin over its triangle's range of FFT bins
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int m = warp; m < n_mel; m += n_warps) {
    const int lo = mel_range[2 * m], len = mel_range[2 * m + 1];
    const float* w = mel_w + (size_t)m * mel_stride;
    float s = 0.f;
    for (int j = lane; j < len; j += 32) s += mag[lo + j] * w[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) melv[m] = log10f(fmaxf(s, mel_floor));
  }
  __syncthreads();
  float* o = out + (size_t)g * n_mel;
  for (int m = threadIdx.x; m < n_mel; m += blockDim.x) o[m] = melv[m];
}

}  // namespace

// wav [rows, T] f32; window [frame_length]; twiddle [M + 1] float2 with
// M = 2^log2_m = fft_length / 2; mel_range [n_mel, 2] int32 (first bin,
// count); mel_w [n_mel, mel_stride]; out [rows, n_frames, n_mel].
extern "C" int loco_logmel(const void* wav, const void* window,
                           const void* twiddle, const void* mel_range,
                           const void* mel_w, void* out, int rows, int T,
                           int n_frames, int frame_length, int hop, int pad,
                           int log2_m, int n_mel, int mel_stride,
                           float mel_floor, void* stream) {
  const long long blocks = (long long)rows * n_frames;
  if (blocks == 0) return 0;
  const int M = 1 << log2_m;
  const size_t smem = M * sizeof(float2) + (M + 1 + n_mel) * sizeof(float);
  logmel_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)wav, (const float*)window, (const float2*)twiddle,
      (const int*)mel_range, (const float*)mel_w, (float*)out, T, n_frames,
      frame_length, hop, pad, log2_m, n_mel, mel_stride, mel_floor);
  return (int)cudaGetLastError();
}
