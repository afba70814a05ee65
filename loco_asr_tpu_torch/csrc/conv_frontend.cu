// Fused first speech front-end layer: conv1 + instance norm + GELU
// (kernel B2).
//
// Replaces: loco_asr_tpu/ops/pallas/conv_frontend.py::_kernel (public
// conv1_instance_norm_gelu), the SpeechT5 / wav2vec2 feature encoder's
// layer 0: conv k=10 stride 5, 1 -> C channels, no bias; instance norm per
// (row, channel) over ALL frames of the padded row, E[y^2] - mean^2,
// eps 1e-5; affine; erf-GELU.  Output [B, C, F] (NCH), F = (T-10)//5 + 1.
//
// What bounds it on an H100: the output write.  At B=16 x 5 s the output
// is 16*512*15999 floats = 524 MB (~0.16 ms at 3.35 TB/s), against ~10
// FLOP of conv per output element and 0.5 MB of waveform input.  Writing
// at that rate leaves room for ~35-40 instructions an output element, so
// the output kernel has to stay under that and the statistics must not
// hold the card idle in front of it.
//
// Design: one C entry, two kernels.
// (1) Statistics, spread over the card.  Each row's frames are cut into
//     chunks; the wrapper picks the chunk so that the grid fills the
//     card's two blocks an SM in one wave at any batch (16 chunks a row at
//     [16, 80000], 58 at [4, 64000]).
//     - A block stages its chunk of the waveform in shared memory with
//       coalesced loads, reduces the chunk's 10 tap sums, then the 55
//       distinct products of the 10x10 gram of its centred taps (t less the
//       chunk's tap means), and writes the 65 values to a [B, chunks, 65]
//       scratch.  The 55 per-thread partials are summed over each warp as
//       a transpose (31 shuffles a group of 32 values, not 5 a value).
//     - The row's last block to finish (an atomic ticket after
//       __threadfence; counters zeroed by a memset in this entry) combines
//       the chunks in a fixed order (Chan et al.'s parallel variance, about
//       chunk 0's means, so that one pass over the chunks serves) and folds
//       the row's tap means m and covariance G into each channel's affine:
//         mean_c = m . w_c,  var_c = w_c^T G w_c,
//         gain_c = scale_c / sqrt(var_c + eps),  off_c = bias_c - mean_c gain_c.
//       The variance is a sum of squares, never E[y^2] - mean^2, so neither
//       a DC offset nor a long zero tail cancels it away.
//     - A ticket, not a cluster: a cluster holds at most 16 blocks, so one
//       cluster a row gives 64 blocks at B=4, half the card.
// (2) Output, launched with programmatic dependent launch: each block
//     stages its waveform slice (128 frames) and raw weights (128
//     channels), and only then waits for the statistics
//     (griddepcontrol.wait), so its prologue runs under their tail (on
//     the H100 this saved 0-8 us a call by CUDA events in all but one of
//     eight A/B pairs; PERF.md).  It
//     folds gain into the weights (w_i gain, off in one float4 triple a
//     channel).  Each thread keeps the 10 taps of 4 frames (32 apart) in
//     registers and walks the 16 channels of its warp (a compile-time
//     loop): per channel three broadcast 16-byte loads, then per output 10
//     FMA, the GELU and a 4-byte store, so a warp writes 32 consecutive
//     frames of one channel row.  F is odd at the main shapes, so rows are
//     not 16-byte aligned and the stores stay scalar; streaming stores
//     (st.global.cs) and blocks that walk several frame tiles were slower
//     on the H100.  The store's bounds test is made once a tile, and only
//     a row's last tile tests each frame.
// The GELU is the TPU kernel's own erf (Abramowitz-Stegun 7.1.26, |err| <=
// 1.5e-7) rearranged as max(z, 0) - |z|/2 P(t) exp(-z^2/2): one
// approximate reciprocal, one ex2 and a five-term polynomial, 13
// instructions an output.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int STAT_THREADS = 256;
constexpr int MAX_CHUNK = 2048;     // frames of a statistics block (41 KB of waveform)
constexpr int NF = 4;               // frames a thread, 32 apart
constexpr int FT = 32 * NF;         // frames an output block
constexpr int NC = 16;              // channels a warp
constexpr int OUT_WARPS = 8;
constexpr int OUT_THREADS = 32 * OUT_WARPS;
constexpr int CT = OUT_WARPS * NC;  // channels an output block

// One halving step of the warp's transposed sum of a[B .. B + 2H): a lane
// keeps the half of the values its partner (lane ^ H) gives away and adds
// the partner's copy of it; the choice of half is made by masks, so that
// no index depends on the lane (which would put a in local memory).
template <int B, int H, int N>
__device__ __forceinline__ void transpose_step(float (&a)[N], int lane) {
  const unsigned up = lane & H ? ~0u : 0u;
#pragma unroll
  for (int i = B; i < B + H; ++i) {
    const unsigned lo = __float_as_uint(a[i]), hi = __float_as_uint(a[i + H]);
    const float send = __uint_as_float((lo & up) | (hi & ~up));
    const float keep = __uint_as_float((hi & up) | (lo & ~up));
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Sums a[B .. B + 32) over the warp: afterwards lane l holds in a[B] the
// warp's total of a[B + l].  Five halving steps, 16 + 8 + 4 + 2 + 1
// shuffles, in place of 32 x 5 for 32 separate reductions.
template <int B, int N>
__device__ __forceinline__ float warp_transpose_sum(float (&a)[N], int lane) {
  transpose_step<B, 16>(a, lane);
  transpose_step<B, 8>(a, lane);
  transpose_step<B, 4>(a, lane);
  transpose_step<B, 2>(a, lane);
  transpose_step<B, 1>(a, lane);
  return a[B];
}

template <int K>
__global__ void __launch_bounds__(STAT_THREADS, 2)
conv_stats_kernel(const float* __restrict__ wav, const float* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ partial,
                  float* __restrict__ gain_off, int* __restrict__ count,
                  int T, int C, int F, int chunk, float eps) {
  constexpr int S = K / 2;
  constexpr int NG = K * (K + 1) / 2;
  constexpr int NS = K + NG;
  constexpr int WARPS = STAT_THREADS / 32;
  extern __shared__ float sx[];                 // [chunk * S + K - S]
  __shared__ float red[WARPS][NS];
  __shared__ float tot[NS];
  __shared__ int last;

  // the output kernel may start its prologue once every block has begun
  asm volatile("griddepcontrol.launch_dependents;");
  const int chunks = gridDim.x, q = blockIdx.x, b = blockIdx.y;
  const int f0 = q * chunk;
  const int nf = min(chunk, F - f0);
  // the row's last block folds every channel: bring the weights into L2
  if (32 * threadIdx.x < C * K)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(w + 32 * threadIdx.x));
  const float* x = wav + (size_t)b * T + (size_t)f0 * S;
  for (int i = threadIdx.x; i < nf * S + K - S; i += STAT_THREADS) sx[i] = x[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // pass 1: the chunk's tap sums, then its tap means
  float acc[K];
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] = 0.f;
  for (int f = threadIdx.x; f < nf; f += STAT_THREADS) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc[i] += sx[f * S + i];   // lanes 5 apart: no conflict
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float v = acc[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) v += red[wi][threadIdx.x];
    tot[threadIdx.x] = v;
  }
  __syncthreads();
  float mu[K];
  const float rnf = 1.f / (float)nf;
#pragma unroll
  for (int i = 0; i < K; ++i) mu[i] = tot[i] * rnf;

  // pass 2: the gram of the centred taps, its NG entries summed over the
  // warp 32 at a time (lane l then holds entry l of the group)
  static_assert(NG <= 64, "the gram's entries fill two groups of 32");
  float gram[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) gram[i] = 0.f;
  for (int f = threadIdx.x; f < nf; f += STAT_THREADS) {
    float t[K];
#pragma unroll
    for (int i = 0; i < K; ++i) t[i] = sx[f * S + i] - mu[i];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = i; j < K; ++j) gram[i * K - i * (i - 1) / 2 + j - i] += t[i] * t[j];
  }
  const float g0 = warp_transpose_sum<0>(gram, lane);
  const float g1 = warp_transpose_sum<32>(gram, lane);
  red[warp][K + lane] = g0;
  if (32 + lane < NG) red[warp][K + 32 + lane] = g1;
  __syncthreads();
  if (threadIdx.x < NS) {
    float v = tot[threadIdx.x];
    if (threadIdx.x >= K) {
      v = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) v += red[wi][threadIdx.x];
    }
    partial[((size_t)b * chunks + q) * NS + threadIdx.x] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count + b, 1) == chunks - 1;
  __syncthreads();
  if (!last) return;

  // the row's last block: the chunks combined (Chan et al.'s parallel
  // variance about a pivot, chunk 0's tap means m_0, so that one pass over
  // the chunks serves): mean = sum_q s_q / F, covariance = (sum_q [C_q +
  // n_q (m_q - m_0)(m_q - m_0)^T]) / F - (mean - m_0)(mean - m_0)^T, m_q =
  // s_q / n_q.  Warp w takes chunks w, w + 8, ..., lane l entries l, l + 32,
  // l + 64; then a fixed tree over the warps.
  __threadfence();
  const float* pr = partial + (size_t)b * chunks * NS;
  const float rn0 = 1.f / (float)min(chunk, F);
  int pi[3], pj[3];
  float m0i[3], m0j[3], part[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {   // the pair (i, j), j >= i, of gram entry e
    const int e = lane + 32 * k;
    int i = 0, r = e - K;
    if (e >= K && e < NS) {
      while (r >= K - i) r -= K - i++;
      m0i[k] = __ldcg(pr + i) * rn0;
      m0j[k] = __ldcg(pr + i + r) * rn0;
    }
    pi[k] = i;
    pj[k] = i + r;
    part[k] = 0.f;
  }
#pragma unroll 2
  for (int c = warp; c < chunks; c += WARPS) {
    const float* pc = pr + (size_t)c * NS;
    const float n = (float)min(chunk, F - c * chunk), rn = 1.f / n;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int e = lane + 32 * k;
      if (e < K) {
        part[k] += __ldcg(pc + e);
      } else if (e < NS) {
        const float di = __ldcg(pc + pi[k]) * rn - m0i[k];
        const float dj = __ldcg(pc + pj[k]) * rn - m0j[k];
        part[k] += fmaf(n * di, dj, __ldcg(pc + e));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (lane + 32 * k < NS) red[warp][lane + 32 * k] = part[k];
  __syncthreads();
  float v = 0.f;
  if (threadIdx.x < NS) {
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) v += red[wi][threadIdx.x];
  }
  const float rf = 1.f / (float)F;
  if (threadIdx.x < K) tot[threadIdx.x] = v * rf;
  __syncthreads();
  // entry e = lane + 32 k with k = warp; selecting by value, not by a
  // computed index, keeps pi, pj, m0i, m0j in registers
  if (threadIdx.x >= K && threadIdx.x < NS) {
    const int k = warp;
    const float di = tot[k == 0 ? pi[0] : k == 1 ? pi[1] : pi[2]] -
                     (k == 0 ? m0i[0] : k == 1 ? m0i[1] : m0i[2]);
    const float dj = tot[k == 0 ? pj[0] : k == 1 ? pj[1] : pj[2]] -
                     (k == 0 ? m0j[0] : k == 1 ? m0j[1] : m0j[2]);
    v = v * rf - di * dj;
  }
  __syncthreads();
  if (threadIdx.x >= K && threadIdx.x < NS) tot[threadIdx.x] = v;
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += STAT_THREADS) {
    float wc[K];
#pragma unroll
    for (int i = 0; i < K; ++i) wc[i] = w[c * K + i];
    float mean = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) mean = fmaf(tot[i], wc[i], mean);
    float var = 0.f;
    int p = K;
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = i; j < K; ++j) {
        const float g = tot[p++];
        var = fmaf(i == j ? g : 2.f * g, wc[i] * wc[j], var);
      }
    const float gain = rsqrtf(var + eps) * scale[c];
    gain_off[((size_t)b * 2) * C + c] = gain;
    gain_off[((size_t)b * 2 + 1) * C + c] = bias[c] - mean * gain;
  }
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 0.5 z (1 + erf(z / sqrt 2)) with Abramowitz-Stegun 7.1.26 for erf:
// erf(u) = 1 - P(t) exp(-u^2), t = 1 / (1 + 0.3275911 u), u >= 0, so the
// GELU is max(z, 0) - |z| t (P(t) / 2t) exp(-z^2 / 2) for either sign of
// z; the 1/2 sits in the polynomial's coefficients.  13 instructions.
__device__ __forceinline__ float gelu_as(float z) {
  const float a = fabsf(z);
  const float t = rcp_approx(fmaf(0.3275911f * 0.70710678118654752f, a, 1.f));
  float p = fmaf(t, 0.5f * 1.061405429f, 0.5f * -1.453152027f);
  p = fmaf(t, p, 0.5f * 1.421413741f);
  p = fmaf(t, p, 0.5f * -0.284496736f);
  p = fmaf(t, p, 0.5f * 0.254829592f);
  const float e = ex2_approx(z * z * -0.72134752044448170f);    // exp(-z^2 / 2)
  return fmaf(-(a * t) * p, e, fmaxf(z, 0.f));
}

template <int K>
__global__ void __launch_bounds__(OUT_THREADS)
conv_out_kernel(const float* __restrict__ wav, const float* __restrict__ w,
                const float* __restrict__ gain_off, float* __restrict__ out,
                int T, int C, int F) {
  constexpr int S = K / 2;
  static_assert(K <= 11, "a channel's weights and offset fill three float4");
  __shared__ float sx[FT * S + K - S];
  __shared__ __align__(16) float sw[CT * 12];   // w_i gain (K), off, unused

  const int b = blockIdx.z;
  const int f0 = blockIdx.x * FT, c0 = blockIdx.y * CT;
  const float* x = wav + (size_t)b * T;
  for (int i = threadIdx.x; i < FT * S + K - S; i += OUT_THREADS) {
    const int idx = f0 * S + i;
    sx[i] = idx < T ? x[idx] : 0.f;
  }
  for (int i = threadIdx.x; i < CT * K; i += OUT_THREADS) {
    const int c = i / K, r = i - c * K;
    sw[c * 12 + r] = c0 + c < C ? w[(size_t)(c0 + c) * K + r] : 0.f;
  }
  // the statistics' gains and offsets are complete and visible past here
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncthreads();
  if (threadIdx.x < CT) {
    const int c = threadIdx.x;
    const bool in = c0 + c < C;
    const float g = in ? gain_off[((size_t)b * 2) * C + c0 + c] : 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) sw[c * 12 + i] *= g;
    sw[c * 12 + K] = in ? gain_off[((size_t)b * 2 + 1) * C + c0 + c] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float t[NF][K];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int i = 0; i < K; ++i) t[j][i] = sx[(lane + 32 * j) * S + i];
  const int cw = warp * NC;
  float* o = out + ((size_t)b * C + c0 + cw) * F + f0 + lane;
  const float4* sw4 = reinterpret_cast<const float4*>(sw);
  const bool full = f0 + FT <= F;    // no frame of the tile past the row's end
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    if (c0 + cw + cc >= C) break;
    const float4 wa = sw4[(cw + cc) * 3], wb = sw4[(cw + cc) * 3 + 1],
                 wc = sw4[(cw + cc) * 3 + 2];
    const float wk[12] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w,
                          wc.x, wc.y, wc.z, wc.w};
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      float z = wk[K];
#pragma unroll
      for (int i = 0; i < K; ++i) z = fmaf(t[j][i], wk[i], z);
      if (full || f0 + lane + 32 * j < F) o[(size_t)cc * F + 32 * j] = gelu_as(z);
    }
  }
}

}  // namespace

// wav [B,T], w [C,1,K], scale/bias [C] (float32, contiguous); scratch of
// B*chunks*65 + B*2*C floats then B int32 counters, chunks = ceil(F /
// chunk); out [B,C,F].  K must be 10 (stride 5).
extern "C" int loco_conv_frontend(const void* wav, const void* w,
                                  const void* scale, const void* bias,
                                  void* scratch, void* out, int B, int T,
                                  int C, int K, int S, int F, int chunk,
                                  float eps, void* stream) {
  if (K != 10 || S != 5 || chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int chunks = (F + chunk - 1) / chunk;
  float* partial = (float*)scratch;
  float* gain_off = partial + (size_t)B * chunks * 65;
  int* count = (int*)(gain_off + (size_t)B * 2 * C);
  cudaError_t e = cudaMemsetAsync(count, 0, (size_t)B * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = ((size_t)chunk * S + K - S) * sizeof(float);
  conv_stats_kernel<10><<<dim3(chunks, B), STAT_THREADS, smem, st>>>(
      (const float*)wav, (const float*)w, (const float*)scale, (const float*)bias, partial,
      gain_off, count, T, C, F, chunk, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((F + FT - 1) / FT, (C + CT - 1) / CT, B);
  cfg.blockDim = dim3(OUT_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, conv_out_kernel<10>, (const float*)wav, (const float*)w,
                         (const float*)gain_off, (float*)out, T, C, F);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks of B2's statistics kernel (phase 0, at `chunk` frames) or output
// kernel (phase 1) that fit on one SM of the current device; negative on a
// CUDA error.
extern "C" int loco_conv_frontend_blocks_per_sm(int phase, int chunk) {
  int n = 0;
  const size_t smem = ((size_t)chunk * 5 + 5) * sizeof(float);
  const cudaError_t e =
      phase == 0
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_stats_kernel<10>,
                                                          STAT_THREADS, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_out_kernel<10>,
                                                          OUT_THREADS, 0);
  return e == cudaSuccess ? n : -(int)e;
}
