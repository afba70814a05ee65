// Relative-position + key-padding flash attention, forward (kernel B1).
//
// Replaces: loco_asr_tpu/ops/pallas/flash_attention.py::_flash_rel_kernel
// (launched by _flash_rel_forward), the SpeechT5 encoder self-attention:
//   s[i,j] = scale*q_i.k_j + scale*q_i.pe[clip(i-j, -L, L-1) + L]
//   keys j >= valid_len[b] and, when causal, j > i masked with -1e30 after
//   the band term is added; keys j >= Tk get -inf, so a row with
//   valid_len 0 averages v over exactly Tk keys, as the plain version
//   does; online softmax -> out and the row logsumexp lse [B,H,Tq] (natural
//   log, the row sum clamped at 1e-30).
// The mask-only variant (MASK_ONLY, the zero table that flash_attention
// makes when it has no rel_pe) skips the table and the band.  q, k, v and
// out are read through (batch, head, time) element strides with a
// contiguous head dim, as in csrc/flash_causal.cu, so the transposed views
// of split_heads and the qkv column views of a GPT-2 layer are read in
// place.  The head dim D is a template parameter, instantiated for the
// set B5 builds, {8, 16, 32, 64, 128}, as the TPU kernel reads d from the
// shape: the SpeechT5 base encoder runs D = 64, the tiny ASR model of the
// LoCo experiment D = 8.  D / 8 k-steps make q.k^T and q.pe^T, D / 8
// column blocks p.v.
//
// What bounds it on an H100: arithmetic.  At the encoder's shape
// ([16, 12, 249, 64], L = 160) the products q.k^T, q.pe^T and p.v are
// ~10 GFLOP against ~24 MB of operands.  As in csrc/flash_causal.cu every
// product runs on the tensor cores as three TF32 mma.sync passes at f32
// accuracy (tf32_mma.cuh).
//
// Design (flash-attention-2 layout, helpers shared with B5/B6): a block of
// WARPS warps per (b*h, 16*WARPS query rows); each warp owns 16 rows, keeps
// its q fragments split (big, small) in registers, and runs the softmax on
// its accumulator fragments in base 2 (scale * log2 e folded into one
// multiply; the band term is stored pre-multiplied by it).  p stays in
// registers: p.v reads each 8-key step in the order (2t, 2t + 1) that the
// score fragment holds (csrc/flash_causal.cu's note).
//  - The band.  The TPU kernel's reversed table and log-step roll exist
//    because Mosaic has no gather.  Here the block first builds
//    tab = scale*log2e * q_tile.pe^T in shared memory, with the same mma on
//    pe tiles streamed in by cp.async, and each score reads
//    tab[clip(i - j, -L, L-1) + L][row].  The table is stored one band
//    column per row of stride TS = 16*WARPS + 4 floats (TS = 4 mod 32): the
//    score fragment's reads at (g, 2t + e) are at column c0 + g - 2t - e,
//    row r0 + g, so the word address is g*(TS + 1) - 2t*TS + const =
//    5g - 8t + const mod 32, and 5g covers 0..7 mod 8 while 8t fills the
//    rest: the 32 lanes hit 32 banks for each e.  The build's stores at
//    (column 2t + e, row g) are at 8t + g + 4e mod 32, also conflict-free.
//    Once i - j >= L - 1 (or <= -L) for every pair of a warp's rows and a
//    key tile, the column is 2L - 1 (or 0) for the whole tile: the warp
//    adds two registers per row and reads no table.  Where no pair of the
//    warp's tile is clipped, every read is at a constant offset from one
//    address; only tiles that cross a clip edge clamp per element.
//  - The pipeline.  pe tiles, then K/V tiles, go through the same
//    shared-memory stages by 16-byte cp.async; rows of D + 4 floats make
//    the K and V fragment reads conflict-free (csrc/flash_causal.cu).
//  - Key tiles past the row's valid length and, when causal, above the
//    diagonal are not loaded (they would add exactly zero), unless
//    valid_len is 0, where every key counts; pe tiles whose columns no row
//    of the block reaches are not loaded either.
// Block shapes (ShapeOf), each 4 warps of 64 rows, two blocks an SM up to
// D = 64 (one at D = 128, whose q fragments alone take 128 registers):
//  - with the band, 32-key K/V tiles in one stage: at L = 160 the table
//    takes 87 KB and the stage 17 KB, so copy and products overlap across
//    the two blocks of an SM, not within one;
//  - mask-only, B5's 64-key tiles in two stages (70 KB, no table).
// PERF.md §6 records why: B5's double-buffered shape with the table (153
// KB, one block an SM) and one 8-warp block of 128 rows with 32-key tiles
// were slower with the band; the 64-key stages win without it.  wgmma and
// TMA are later work.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

template <int D>
__host__ __device__ constexpr int ld() { return D + 4; }   // shared row stride of K, V, pe
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_NAT = -1e30f;       // the mask of the plain version
constexpr float NEG = -1e30f * LOG2E;   // the same in base 2

struct Strides {               // element strides of (batch, head, time)
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

template <int WARPS_, int BK_, int STAGES_>
struct Shape {
  static constexpr int WARPS = WARPS_, BK = BK_, STAGES = STAGES_;
  static constexpr int BQ = 16 * WARPS;        // query rows per block
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int TS = BQ + 4;            // table stride, = 4 mod 32
};
template <bool MASK_ONLY>
using ShapeOf = std::conditional_t<MASK_ONLY, Shape<4, 64, 2>, Shape<4, 32, 1>>;
// blocks an SM that the launch bound asks for, as in csrc/flash_causal.cu
template <int D>
constexpr int min_blocks() { return D <= 64 ? 2 : 1; }

template <bool MASK_ONLY, int D>
__host__ size_t smem_bytes(int two_l) {
  using S = ShapeOf<MASK_ONLY>;
  return (size_t)(S::STAGES * 2 * S::BK * ld<D>() + (MASK_ONLY ? 0 : two_l * S::TS)) *
         sizeof(float);
}

// rows [row0, row0 + BK) of a strided [n, D] matrix -> smem [BK][D + 4],
// asynchronously; rows >= n are zero
template <class S, int D>
__device__ __forceinline__ void load_tile_async(float* dst, const float* __restrict__ src,
                                                long long row_stride, int row0, int n) {
  constexpr int C4 = D / 4, LD = ld<D>();
#pragma unroll
  for (int i = threadIdx.x; i < S::BK * C4; i += S::THREADS) {
    const int r = i / C4, c4 = i % C4;
    const bool valid = row0 + r < n;
    const float* s = valid ? src + (row0 + r) * row_stride + c4 * 4 : src;
    cp_async16(dst + r * LD + c4 * 4, s, valid);
  }
}

template <bool MASK_ONLY, int D>
__global__ void __launch_bounds__(ShapeOf<MASK_ONLY>::THREADS, min_blocks<D>())
flash_rel_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ pe,
                     const int* __restrict__ valid_len, float* __restrict__ out,
                     float* __restrict__ lse, Strides st, int H, int Tq, int Tk,
                     int two_l, int causal, float scale) {
  using S = ShapeOf<MASK_ONLY>;
  constexpr int BQ = S::BQ, BK = S::BK, TS = S::TS;
  constexpr int KD = D / 8;      // k-steps of q.k^T and q.pe^T, column blocks of p.v
  constexpr int LD = ld<D>();
  constexpr int NB = BK / 8;     // key blocks of a tile
  constexpr int STAGE = 2 * BK * LD;
  // [STAGES][K, V][BK][LD], then the table [2L][TS]
  extern __shared__ __align__(16) float smem[];
  float* tab = smem + S::STAGES * STAGE;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;                       // row in the block
  const int r0 = q0 + rl, r1 = r0 + 8;                // this thread's rows
  const int L = two_l / 2;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const int vl = max(0, min(valid_len[b], Tk));

  int nk = (Tk + BK - 1) / BK;
  if (vl > 0) {                  // later tiles would add exactly zero
    nk = min(nk, (vl + BK - 1) / BK);
    if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  }
  // pe tiles first: those holding the table columns the block's rows reach,
  // clip(i - j) + L for i in [q0, q0 + BQ) and j up to the last key that a
  // row of the block may see
  int pe0 = 0, npe = 0;
  if (!MASK_ONLY) {
    const int j_last = vl == 0 ? Tk - 1 : causal ? min(vl - 1, q0 + BQ - 1) : vl - 1;
    pe0 = (min(max(q0 - j_last, -L), L - 1) + L) / BK;
    npe = (min(q0 + BQ - 1, L - 1) + L) / BK - pe0 + 1;
  }
  const int n_items = npe + nk;

  auto load_item = [&](int idx) {   // item idx -> its stage, asynchronously
    float* dst = smem + (S::STAGES == 2 ? (idx & 1) : 0) * STAGE;
    if (idx < npe) {
      load_tile_async<S, D>(dst, pe, D, (pe0 + idx) * BK, two_l);
    } else {
      const int k0 = (idx - npe) * BK;
      load_tile_async<S, D>(dst, kb, st.kt, k0, Tk);
      load_tile_async<S, D>(dst + BK * LD, vb, st.vt, k0, Tk);
    }
    cp_async_commit();
  };
  if (S::STAGES == 2) load_item(0);

  // q's A fragments, split once
  unsigned qbig[KD][4], qsmall[KD][4];
  {
    const float* q_r0 = qb + r0 * st.qt;
    const float* q_r1 = qb + r1 * st.qt;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = 8 * kk + t;
      const float x[4] = {r0 < Tq ? q_r0[c] : 0.f, r1 < Tq ? q_r1[c] : 0.f,
                          r0 < Tq ? q_r0[c + 4] : 0.f, r1 < Tq ? q_r1[c + 4] : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(x[e], qbig[kk][e], qsmall[kk][e]);
    }
  }

  float o[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG, NEG};       // running max (base 2) of rows r0, r1
  float l[2] = {0.f, 0.f};       // this thread's share of the row sums
  float band_lo[2] = {0.f, 0.f}, band_hi[2] = {0.f, 0.f};   // table columns 0, 2L-1
  const float c2 = scale * LOG2E;

  for (int idx = 0; idx < n_items; ++idx) {
    if (S::STAGES == 2) {        // the next item's copy overlaps this one's products
      if (idx + 1 < n_items) {
        load_item(idx + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_item(idx);
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sK = smem + (S::STAGES == 2 ? (idx & 1) : 0) * STAGE;
    const float* sV = sK + BK * LD;

    // s = q.B^T with B the stage's first tile (pe rows or keys): block n
    // holds columns 8n + {2t, 2t + 1} of rows r0, r1
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float* kr = sK + (8 * n + g) * LD + 8 * kk + t;
        unsigned bbig[2], bsmall[2];
        split_tf32(kr[0], bbig[0], bsmall[0]);
        split_tf32(kr[4], bbig[1], bsmall[1]);
        mma_3xtf32(s[n], qbig[kk], qsmall[kk], bbig, bsmall);
      }
    }

    if (!MASK_ONLY && idx < npe) {   // table columns m0 + 8n + 2t + (e & 1)
      const int m0 = (pe0 + idx) * BK;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = m0 + 8 * n + 2 * t + (e & 1);
          if (col < two_l) tab[col * TS + rl + 8 * (e >> 1)] = s[n][e] * c2;
        }
      __syncthreads();   // the table is complete after the last pe tile
      continue;
    }

    const int k0 = (idx - npe) * BK;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= c2;
    if (!MASK_ONLY) {
      if (idx == npe) {          // columns 0 and 2L - 1, where they were built
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          band_lo[r] = pe0 == 0 ? tab[rl + 8 * r] : 0.f;
          band_hi[r] = (pe0 + npe) * BK >= two_l ? tab[(two_l - 1) * TS + rl + 8 * r] : 0.f;
        }
      }
      // i - j over this warp's rows and the tile's keys
      const int d_min = q0 + 16 * warp - (k0 + BK - 1);
      const int d_max = q0 + 16 * warp + 15 - k0;
      if (d_min >= L - 1 || d_max <= -L) {   // one column per row
        const bool hi = d_min >= L - 1;
        const float c[2] = {hi ? band_hi[0] : band_lo[0], hi ? band_hi[1] : band_lo[1]};
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += c[e >> 1];
      } else if (d_min >= -L && d_max <= L - 1) {   // no clip: column d + L
        // (g, 2t + e) of block n at column r0 + 8h - k0 - 8n - 2t - e + L,
        // row rl + 8h (h = e >> 1): constant offsets from one base
        const float* base = tab + (r0 - k0 - 2 * t + L) * TS + rl;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] += base[(8 * (e >> 1) - 8 * n - (e & 1)) * TS + 8 * (e >> 1)];
      } else {
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = (e < 2 ? r0 : r1) - (k0 + 8 * n + 2 * t + (e & 1));
            const int col = min(max(d, -L), L - 1) + L;
            s[n][e] += tab[col * TS + rl + 8 * (e >> 1)];
          }
      }
    }
    if ((causal && k0 + BK - 1 > q0) || k0 + BK > vl) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 8 * n + 2 * t + (e & 1);
          const int i = e < 2 ? r0 : r1;
          if (j >= vl || (causal && j > i)) s[n][e] = NEG;
          if (j >= Tk) s[n][e] = -INFINITY;
        }
    }

    // online softmax in base 2
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // o += p.v over key block kk, keys read in the order (2t, 2t + 1)
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      unsigned abig[4], asmall[4];
      split_tf32(s[kk][0], abig[0], asmall[0]);
      split_tf32(s[kk][2], abig[1], asmall[1]);
      split_tf32(s[kk][1], abig[2], asmall[2]);
      split_tf32(s[kk][3], abig[3], asmall[3]);
      const float* vr = sV + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        unsigned bbig[2], bsmall[2];
        split_tf32(vr[8 * n], bbig[0], bsmall[0]);
        split_tf32(vr[LD + 8 * n], bbig[1], bsmall[1]);
        mma_3xtf32(o[n], abig, asmall, bbig, bsmall);
      }
    }
    __syncthreads();   // this stage is refilled
  }

  const int rows[2] = {r0, r1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    if (rows[r] >= Tq) continue;
    float* orow = out + b * st.ob + h * st.oh + rows[r] * st.ot + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
    // a row that saw only masked keys has the plain version's lse,
    // -1e30 + log(sum), which -1e30 * log2 e * ln 2 would miss by ulps of 1e30
    if (t == 0)
      lse[(long long)bh * Tq + rows[r]] =
          m[r] == NEG ? NEG_NAT + logf(denom) : (m[r] + log2f(denom)) * LN2;
  }
}

// raises the kernel's dynamic shared-memory limit once per device
template <bool MASK_ONLY, int D>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  return allow_smem_once(flash_rel_fwd_kernel<MASK_ONLY, D>, 0, done);
}

template <bool MASK_ONLY, int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* pe,
                   const int* valid_len, float* out, float* lse, const Strides& st,
                   int B, int H, int Tq, int Tk, int two_l, int causal, float scale,
                   cudaStream_t stream) {
  using S = ShapeOf<MASK_ONLY>;
  const cudaError_t e = allow_smem<MASK_ONLY, D>();
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Tq + S::BQ - 1) / S::BQ);
  flash_rel_fwd_kernel<MASK_ONLY, D><<<grid, S::THREADS, smem_bytes<MASK_ONLY, D>(two_l),
                                       stream>>>(q, k, v, pe, valid_len, out, lse, st, H,
                                                 Tq, Tk, two_l, causal, scale);
  return cudaGetLastError();
}

template <bool MASK_ONLY, int D>
int blocks_per_sm(int two_l) {
  int blocks = -1;
  cudaError_t e = allow_smem<MASK_ONLY, D>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_rel_fwd_kernel<MASK_ONLY, D>, ShapeOf<MASK_ONLY>::THREADS,
        smem_bytes<MASK_ONLY, D>(two_l));
  return e == cudaSuccess ? blocks : -1;
}

// f(std::bool_constant<mask_only>, std::integral_constant<int, d>) for the
// instantiated forms, else ``fallback`` (a head dim the kernel does not take)
template <class R, class F>
R with_form(int mask_only, int d, R fallback, F&& f) {
  auto dims = [&](auto mo) -> R {
    switch (d) {
      case 8: return f(mo, std::integral_constant<int, 8>{});
      case 16: return f(mo, std::integral_constant<int, 16>{});
      case 32: return f(mo, std::integral_constant<int, 32>{});
      case 64: return f(mo, std::integral_constant<int, 64>{});
      case 128: return f(mo, std::integral_constant<int, 128>{});
      default: return fallback;
    }
  };
  return mask_only ? dims(std::true_type{}) : dims(std::false_type{});
}

}  // namespace

// Dynamic shared memory of a launch (0 for a head dim not instantiated).
extern "C" size_t loco_flash_rel_smem_bytes(int two_l, int mask_only, int d) {
  return with_form(mask_only, d, (size_t)0, [&](auto mo, auto dd) {
    return smem_bytes<decltype(mo)::value, decltype(dd)::value>(two_l);
  });
}

// Blocks of the kernel that fit on one SM of the current device at this
// table size (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
extern "C" int loco_flash_rel_blocks_per_sm(int two_l, int mask_only, int d) {
  return with_form(mask_only, d, -1, [&](auto mo, auto dd) {
    return blocks_per_sm<decltype(mo)::value, decltype(dd)::value>(two_l);
  });
}

// q [.., Tq, D], k/v [.., Tk, D], out [.., Tq, D] (float32, head dim
// contiguous, 16-byte aligned rows), addressed through strides[12] =
// (batch, head, time) element strides of q, k, v, out in that order;
// pe [two_l, D] contiguous (not read when mask_only), valid_len [B] int32,
// lse [B,H,Tq] contiguous.  D in {8, 16, 32, 64, 128}.
extern "C" int loco_flash_rel_fwd(const void* q, const void* k, const void* v,
                                  const void* pe, const void* valid_len, void* out,
                                  void* lse, const long long* strides, int B, int H,
                                  int Tq, int Tk, int D, int two_l, int causal,
                                  int mask_only, float scale, void* stream) {
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  return (int)with_form(mask_only, D, cudaErrorInvalidValue, [&](auto mo, auto dd) {
    return launch<decltype(mo)::value, decltype(dd)::value>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)pe,
        (const int*)valid_len, (float*)out, (float*)lse, st, B, H, Tq, Tk, two_l, causal,
        scale, (cudaStream_t)stream);
  });
}
