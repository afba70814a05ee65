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
//
// Two forms of the output kernel (the C entry's `form`; a pairing of form
// and operand type with no kernel returns cudaErrorNotSupported):
// - form 0, "ffma": (2) above, the float32 kernel.
// - form 1, "mma_sync": the bf16 kernel, conv_out_mma_kernel below.  In
//   bf16 the output is half as large (262 MB at [16, 80000], 0.079 ms), and
//   form 0's ~27 instructions an output (10 FMA, the GELU, a conversion, a
//   scalar 2-byte store) took longer to issue than the write.  So:
//   - The conv runs on the tensor cores: one mma.sync.m16n8k16 bf16 with
//     f32 accumulation per 16 channels x 8 frames, the 10 taps padded to
//     16 with zero weights (raw bf16, exact; products of bf16 values are
//     exact in f32, so only the order of the sums differs from the plain
//     version).  Gain and offset follow as one f32 FMA, not folded into
//     bf16 weights, which would round them.
//   - The tap operand is a Hankel matrix (B[k][n] = x[5n + k]), which no
//     wgmma shared-memory descriptor expresses, so its fragments come from
//     the block's staged waveform.  A lane's pair (x[5n + 2t], x[5n + 2t +
//     1]) is 4-byte aligned only for even n, so the slice is staged twice,
//     the second copy one sample on: 2 x 1.4 KB and one 4-byte load a
//     pair, where a [frames][16] tap tile would take 16 bytes a frame and
//     eight stores to build.  The second copy starts 16 words (mod 32) past
//     the first; the loads of a fragment meet 2-way bank conflicts at most.
//   - Stores: F is odd at the main shapes, so a channel row's start takes
//     every alignment mod 8 elements in turn, but rows c and c + 8 share it
//     (8F = 0 mod 8).  Warp r takes the channels r, r + 8, ..., r + 120 of
//     the block's 128, so its 16 rows share one alignment, and it places
//     its frames where that row class's 16-byte chunks fall: lane t's
//     columns of four 8-frame products are frames 8t .. 8t + 7 of a chunk,
//     rounded with packed cvt.rn.bf16x2.f32 into one 16-byte value.  A
//     tile owns the chunks that start in its 128 frames shifted back by
//     the class's alignment, so no chunk is computed twice and only the
//     two at a row's ends are partial, written an element at a time.
//   - Each warp stages its 16 rows x 128 frames in shared memory (4 KB,
//     chunk k of an odd row at k ^ 4, so that a quarter warp's 16-byte
//     stores of rows g and g + 1 fall in opposite halves of the banks) and
//     then writes each row's 256 bytes with one 16-byte store a lane, two
//     rows an instruction.  Written straight from the fragments instead
//     (64 bytes of each of 8 rows an instruction, a row's pieces a group's
//     work apart) the kernel was slower than form 0 (PERF.md;
//     scripts/b2_variants.py's "direct").  TMA stores cannot do this: the
//     channel stride, F x 2 bytes, is not a multiple of 16.
//   - A block takes one tile, 128 channels x 128 frames: with ranges of
//     tiles a block, weights and gains loaded once a range, the barriers
//     around each tile's staging held its warps in lock step and the
//     kernel was slower.  Its samples are staged with two 2-byte loads a
//     word and a shuffle inside the row.  Stores are streaming
//     (st.global.cs), and the launch bound holds a thread to 40 registers,
//     six blocks an SM.  One bounds test a tile: only a row's first and
//     last tiles, and a channel tile past C, test each chunk.
//   - The PDL overlap stays: the tile's waveform and the weights are
//     staged before griddepcontrol.wait.
//   What is left is ~16 instructions an output, the GELU's 13 with its two
//   MUFU operations first: about 0.07 ms of issue at [16, 80000], near the
//   write's 0.079 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

// element loads and the output store of the two forms: float, and bf16
// (read and widened exactly; the output rounded to nearest even)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <int K, typename E>
__global__ void __launch_bounds__(STAT_THREADS, 2)
conv_stats_kernel(const E* __restrict__ wav, const E* __restrict__ w,
                  const E* __restrict__ scale,
                  const E* __restrict__ bias, float* __restrict__ partial,
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
  const E* x = wav + (size_t)b * T + (size_t)f0 * S;
  for (int i = threadIdx.x; i < nf * S + K - S; i += STAT_THREADS) sx[i] = to_f32(x[i]);
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
    for (int i = 0; i < K; ++i) wc[i] = to_f32(w[c * K + i]);
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
    const float gain = rsqrtf(var + eps) * to_f32(scale[c]);
    gain_off[((size_t)b * 2) * C + c] = gain;
    gain_off[((size_t)b * 2 + 1) * C + c] = to_f32(bias[c]) - mean * gain;
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

template <int K, typename E>
__global__ void __launch_bounds__(OUT_THREADS)
conv_out_kernel(const E* __restrict__ wav, const E* __restrict__ w,
                const float* __restrict__ gain_off, E* __restrict__ out,
                int T, int C, int F) {
  constexpr int S = K / 2;
  static_assert(K <= 11, "a channel's weights and offset fill three float4");
  __shared__ float sx[FT * S + K - S];
  __shared__ __align__(16) float sw[CT * 12];   // w_i gain (K), off, unused

  const int b = blockIdx.z;
  const int f0 = blockIdx.x * FT, c0 = blockIdx.y * CT;
  const E* x = wav + (size_t)b * T;
  for (int i = threadIdx.x; i < FT * S + K - S; i += OUT_THREADS) {
    const int idx = f0 * S + i;
    sx[i] = idx < T ? to_f32(x[idx]) : 0.f;
  }
  for (int i = threadIdx.x; i < CT * K; i += OUT_THREADS) {
    const int c = i / K, r = i - c * K;
    sw[c * 12 + r] = c0 + c < C ? to_f32(w[(size_t)(c0 + c) * K + r]) : 0.f;
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
  E* o = out + ((size_t)b * C + c0 + cw) * F + f0 + lane;
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
      if (full || f0 + lane + 32 * j < F) o[(size_t)cc * F + 32 * j] = from_f32<E>(gelu_as(z));
    }
  }
}

// The bf16 form's output kernel (form 1; the design is in the header).
constexpr int MT_FRAMES = 128;                 // frames an output tile
constexpr int MT_GROUPS = MT_FRAMES / 32;      // 32-frame groups a warp walks
constexpr int MT_CHUNKS = MT_FRAMES / 8;       // 16-byte chunks of a row of the tile
constexpr int MT_ROWS = 32 / MT_CHUNKS;        // rows a warp's 16-byte store covers
// words of one staged copy of the tile's samples: frames f0 - 8 .. f0 +
// MT_FRAMES - 2, 16 taps each
constexpr int MT_WORDS = MT_FRAMES * 5 / 2 + 23;
constexpr int MT_COPY1 = MT_WORDS + ((48 - MT_WORDS % 32) % 32);   // = 16 mod 32
// the output tile staged a warp at a time: 16 rows of MT_CHUNKS chunks
constexpr int MT_STAGE_BYTES = OUT_WARPS * 16 * MT_CHUNKS * 16;
// blocks an SM: 40 registers a thread, 6 x (32 + 2.8) KB of shared memory
constexpr int MT_BLOCKS_PER_SM = 6;
static_assert(MT_FRAMES % 32 == 0 && MT_COPY1 % 32 == 16, "tile geometry");
static_assert(MT_CHUNKS >= 8 && MT_CHUNKS <= 32 && 32 % MT_CHUNKS == 0, "store geometry");
static_assert(MT_STAGE_BYTES <= 48 * 1024, "the stage needs no opt-in to shared memory");
// (lo, hi) rounded to bf16 by one packed conversion, lo in the low half
__device__ __forceinline__ unsigned cvt_pair(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the bits of sample i of a row, 0 outside [0, T)
__device__ __forceinline__ unsigned sample_bits(const unsigned short* x, long long i, int T) {
  return i >= 0 && i < T ? (unsigned)__ldg(x + i) : 0u;
}

// w[c][k], w[c][k + 1] of the [C, 10] bf16 weights as one register (0
// past C); two 2-byte loads, as the tensor may start at an odd element
__device__ __forceinline__ unsigned weight_pair(const unsigned short* w, int c, int k, bool in) {
  return in ? (unsigned)__ldg(w + c * 10 + k) | (unsigned)__ldg(w + c * 10 + k + 1) << 16 : 0u;
}

// d = a.b, one m16n8k16 bf16 product with f32 accumulation from zero
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// One 32-frame group of a warp's 16 rows: four products over the frames
// whose columns give lane t frames 8t .. 8t + 7 (sb: this lane's tap pairs
// of the group's first product), then gain, offset, GELU and the packed
// rounding: va holds row g's 8 frames, vb row g + 8's.
__device__ __forceinline__ void mma_group(const unsigned* sb, const unsigned (&a)[4], float ga,
                                          float oa, float gb, float ob, uint4& va, uint4& vb) {
  unsigned lo[4], hi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // frames 8t + 2j, 8t + 2j + 1 of the chunk
    float d[4];
    mma_bf16_zero(d, a, sb[5 * j], sb[5 * j + 4]);
    lo[j] = cvt_pair(gelu_as(fmaf(d[0], ga, oa)), gelu_as(fmaf(d[1], ga, oa)));
    hi[j] = cvt_pair(gelu_as(fmaf(d[2], gb, ob)), gelu_as(fmaf(d[3], gb, ob)));
  }
  va = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  vb = make_uint4(hi[0], hi[1], hi[2], hi[3]);
}

// A chunk of 8 frames from frame f at out[i] of a row of F frames: one
// 16-byte store when it lies inside the row, else its frames in [0, F)
// one at a time.
__device__ __forceinline__ void store_chunk(unsigned short* out, long long i, int f, int F,
                                            const uint4& v) {
  if (f >= 0 && f + 8 <= F) {
    *reinterpret_cast<uint4*>(out + i) = v;
    return;
  }
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (f + k >= 0 && f + k < F) out[i + k] = (unsigned short)(w[k / 2] >> (16 * (k & 1)));
}

// A tile's samples into sx: word i holds samples (2i, 2i + 1) of s0 on,
// word MT_COPY1 + i samples (2i + 1, 2i + 2), 0 outside [0, T).  Inside
// the row two 2-byte loads a word and the next lane's first sample; at a
// row's ends one bounds test a sample.
__device__ __forceinline__ void stage_samples(unsigned* sx, const unsigned short* x,
                                              long long s0, int T) {
  if (s0 >= 0 && s0 + 2 * MT_WORDS + 1 < T) {
#pragma unroll
    for (int i0 = 0; i0 < MT_WORDS; i0 += OUT_THREADS) {   // the same trips in every lane
      const int i = i0 + threadIdx.x;
      const unsigned short* xs = x + s0 + 2 * i;
      unsigned x0 = 0, x1 = 0;
      if (i <= MT_WORDS) x0 = __ldg(xs), x1 = __ldg(xs + 1);
      unsigned x2 = __shfl_down_sync(0xffffffffu, x0, 1);
      if ((threadIdx.x & 31) == 31 && i < MT_WORDS) x2 = __ldg(xs + 2);
      if (i < MT_WORDS) sx[i] = x0 | x1 << 16, sx[MT_COPY1 + i] = x1 | x2 << 16;
    }
  } else {
    for (int i = threadIdx.x; i < MT_WORDS; i += OUT_THREADS) {
      const long long s = s0 + 2 * i;
      const unsigned x0 = sample_bits(x, s, T), x1 = sample_bits(x, s + 1, T);
      const unsigned x2 = sample_bits(x, s + 2, T);
      sx[i] = x0 | x1 << 16;
      sx[MT_COPY1 + i] = x1 | x2 << 16;
    }
  }
}

__global__ void __launch_bounds__(OUT_THREADS, MT_BLOCKS_PER_SM)
conv_out_mma_kernel(const __nv_bfloat16* __restrict__ wav, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ gain_off, __nv_bfloat16* __restrict__ out_,
                    int T, int C, int F) {
  __shared__ unsigned sx[MT_COPY1 + MT_WORDS];   // word i: samples 2i, 2i + 1; then 2i + 1, 2i + 2
  extern __shared__ uint4 stage[];               // [OUT_WARPS][16 rows][MT_CHUNKS], swizzled

  const int b = blockIdx.z;
  const int f0 = blockIdx.x * MT_FRAMES, c0 = blockIdx.y * CT;
  const unsigned short* x = reinterpret_cast<const unsigned short*>(wav) + (size_t)b * T;
  const long long s0 = 5LL * (f0 - 8);   // the sample of tap 0 of frame f0 - 8
  stage_samples(sx, x, s0, T);
  // warp r: channels c0 + r + 8i; lane (g, t): rows g and g + 8 of the A
  // fragment, channels ca and cb, taps 2t, 2t + 1 and (t = 0) 8, 9
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int ca = c0 + r + 8 * g, cb = ca + 64;
  const bool ina = ca < C, inb = cb < C;
  const unsigned short* wb = reinterpret_cast<const unsigned short*>(w);
  const unsigned a[4] = {weight_pair(wb, ca, 2 * t, ina), weight_pair(wb, cb, 2 * t, inb),
                         weight_pair(wb, ca, 8, ina && t == 0),
                         weight_pair(wb, cb, 8, inb && t == 0)};
  // the statistics' gains and offsets are complete and visible past here
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float* gain = gain_off + (size_t)b * 2 * C;
  const float ga = ina ? gain[ca] : 0.f, oa = ina ? gain[C + ca] : 0.f;
  const float gb = inb ? gain[cb] : 0.f, ob = inb ? gain[C + cb] : 0.f;
  __syncthreads();

  // the rows' 16-byte chunks start at frames = dl mod 8; this warp's first
  // one at o (o < 0 in a row's first tile)
  const int e = (int)(((unsigned)b * (unsigned)C + (unsigned)(c0 + r)) * ((unsigned)F & 7u) & 7u);
  const int dl = (8 - e) & 7;
  const int o = f0 - 8 + dl;
  // this lane's B column in product j of group q: frame o + 32q + 8(g >> 1)
  // + 2j + (g & 1), its tap pair from the copy where it is 4-byte aligned
  const int sl = 5 * (dl + 8 * (g >> 1) + (g & 1));
  const unsigned* sb = (sl & 1 ? sx + MT_COPY1 + (sl - 1) / 2 : sx + sl / 2) + t;
  // the warp's 16 rows: row h of the stage is channel c0 + r + 8(h & 7) +
  // 64(h >> 3); chunk k of an odd row sits at k ^ 4, so that the two rows
  // of a quarter warp's 16-byte stores fall in opposite halves of the banks
  uint4* st = stage + r * 16 * MT_CHUNKS;
  const int sw = (g & 1) << 2;
#pragma unroll
  for (int q = 0; q < MT_GROUPS; ++q) {
    uint4 va, vb;
    mma_group(sb + 80 * q, a, ga, oa, gb, ob, va, vb);
    st[g * MT_CHUNKS + ((4 * q + t) ^ sw)] = va;
    st[(g + 8) * MT_CHUNKS + ((4 * q + t) ^ sw)] = vb;
  }
  __syncwarp();
  // each row's MT_FRAMES frames in one store instruction of MT_CHUNKS lanes
  const int k = lane % MT_CHUNKS, hs = lane / MT_CHUNKS;
  unsigned short* out = reinterpret_cast<unsigned short*>(out_);
  const long long row0 = (long long)b * C + c0 + r;
  const int f = o + 8 * k;
  if (blockIdx.x > 0 && f0 + MT_FRAMES - 1 <= F && c0 + CT <= C) {   // every chunk whole
#pragma unroll
    for (int i = 0; i < 16 / MT_ROWS; ++i) {
      const int h = i * MT_ROWS + hs;
      const uint4 v = st[h * MT_CHUNKS + (k ^ ((h & 1) << 2))];
      __stcs(reinterpret_cast<uint4*>(out + (row0 + 8 * (h & 7) + 64 * (h >> 3)) * F + f), v);
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < 16 / MT_ROWS; ++i) {
      const int h = i * MT_ROWS + hs;
      const int c = c0 + r + 8 * (h & 7) + 64 * (h >> 3);
      const uint4 v = st[h * MT_CHUNKS + (k ^ ((h & 1) << 2))];
      if (c < C) store_chunk(out, (row0 + 8 * (h & 7) + 64 * (h >> 3)) * F + f, f, F, v);
    }
  }
}

template <typename E>
int launch(const void* wav, const void* w, const void* scale, const void* bias,
           void* scratch, void* out, int B, int T, int C, int K, int S, int F, int chunk,
           float eps, cudaStream_t st) {
  const int chunks = (F + chunk - 1) / chunk;
  float* partial = (float*)scratch;
  float* gain_off = partial + (size_t)B * chunks * 65;
  int* count = (int*)(gain_off + (size_t)B * 2 * C);
  cudaError_t e = cudaMemsetAsync(count, 0, (size_t)B * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = ((size_t)chunk * S + K - S) * sizeof(float);
  conv_stats_kernel<10, E><<<dim3(chunks, B), STAT_THREADS, smem, st>>>(
      (const E*)wav, (const E*)w, (const E*)scale, (const E*)bias, partial, gain_off, count,
      T, C, F, chunk, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  // float: form 0's output kernel; bf16: form 1's, whose tiles own the
  // chunks that start in their frames, shifted back by up to 8
  cfg.gridDim = std::is_same<E, float>::value
                    ? dim3((F + FT - 1) / FT, (C + CT - 1) / CT, B)
                    : dim3((F + 7) / MT_FRAMES + 1, (C + CT - 1) / CT, B);
  cfg.blockDim = dim3(OUT_THREADS);
  cfg.dynamicSmemBytes = std::is_same<E, float>::value ? 0 : MT_STAGE_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (std::is_same<E, float>::value)
    e = cudaLaunchKernelEx(&cfg, conv_out_kernel<10, float>, (const float*)wav, (const float*)w,
                           (const float*)gain_off, (float*)out, T, C, F);
  else
    e = cudaLaunchKernelEx(&cfg, conv_out_mma_kernel, (const E*)wav, (const E*)w,
                           (const float*)gain_off, (E*)out, T, C, F);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// wav [B,T], w [C,1,K], scale/bias [C] (float32, or bfloat16 when
// bf16_io is nonzero; contiguous); scratch of B*chunks*65 + B*2*C floats
// then B int32 counters, chunks = ceil(F / chunk); out [B,C,F] of wav's
// type (the statistics, the norm and the GELU are f32 either way), 16-byte
// aligned for form 1.  K must be 10 (stride 5).  form 0 ("ffma") takes
// float32, form 1 ("mma_sync") bfloat16; any other pairing returns
// cudaErrorNotSupported.
extern "C" int loco_conv_frontend(const void* wav, const void* w,
                                  const void* scale, const void* bias,
                                  void* scratch, void* out, int B, int T,
                                  int C, int K, int S, int F, int chunk,
                                  float eps, int form, int bf16_io, void* stream) {
  if (K != 10 || S != 5 || chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (form == 0 && !bf16_io)
    return launch<float>(wav, w, scale, bias, scratch, out, B, T, C, K, S, F, chunk, eps, st);
  if (form == 1 && bf16_io) {
    if ((size_t)out % 16) return (int)cudaErrorMisalignedAddress;
    return launch<__nv_bfloat16>(wav, w, scale, bias, scratch, out, B, T, C, K, S, F, chunk,
                                 eps, st);
  }
  return (int)cudaErrorNotSupported;
}

// Blocks of B2's statistics kernel (phase 0, at `chunk` frames), form 0's
// output kernel (phase 1) or form 1's (phase 2) that fit on one SM of the
// current device; negative on a CUDA error.
extern "C" int loco_conv_frontend_blocks_per_sm(int phase, int chunk) {
  int n = 0;
  const size_t smem = ((size_t)chunk * 5 + 5) * sizeof(float);
  const cudaError_t e =
      phase == 0
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_stats_kernel<10, float>,
                                                          STAT_THREADS, smem)
      : phase == 1
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_out_kernel<10, float>,
                                                          OUT_THREADS, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_out_mma_kernel, OUT_THREADS,
                                                          MT_STAGE_BYTES);
  return e == cudaSuccess ? n : -(int)e;
}
