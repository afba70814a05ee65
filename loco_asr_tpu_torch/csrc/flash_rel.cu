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
// were slower with the band; the 64-key stages win without it.
//
// The bf16 form (the element type T is a template parameter; the f32
// instantiation is the kernel described above, unchanged) is the JAX
// kernel's bf16 path: q, k, v, pe and out in bf16, q.k^T, q.pe^T and p.v
// as one m16n8k16 bf16 mma.sync each with f32 accumulation (bf16_mma.cuh),
// p rounded to bf16 before p.v; the band table (f32 in shared memory, as
// the TPU kernel's y_scr), the masks and their constants, the softmax and
// lse stay f32.  K, V and pe tiles are bf16 rows of D + 8.
//
// Two forms, picked by the caller (flash_causal.py's kernel_form, the C
// entry's form argument): form 0, the mma.sync kernel above, runs every f32
// launch and bf16 at D = 8, 16 and 32; form 1, the wgmma kernel below, runs
// bf16 at D = 64 and 128 (a launch in the other pairing returns
// cudaErrorNotSupported).  Both compute the bf16 path above.
//
// Form 1, for Hopper (hopper.cuh's mbarriers, TMA, wgmma and band window).
// What bounds it: bytes (at [16, 12, 249, 64], L = 160: 24.7 MB in 0.0074
// ms; the products, q.k^T, the band and p.v, ~5 GFLOP in 0.0051 at 989
// TFLOP/s), but neither is near: a tile's products take a few hundred
// cycles of an SM's tensor cores, its softmax and the band's round trip
// through shared memory over a thousand, in a chain a warpgroup waits
// through (PERF.md, scripts/trace_flash_rel_wgmma.py).
//  - A block of 384 threads per (b*h, 64 query rows), B3 form 1's layout
//    (csrc/flash_rel_bwd.cu): two consumer warpgroups share the block's Q
//    and take its 64-key tiles in turn, each with its own running max, row
//    sums and output (so each runs its own chain and neither waits for the
//    other), merged through shared memory at the end; a producer
//    warpgroup's thread issues every TMA copy (Q once; per key tile K, V
//    and the band's window, 128-byte-swizzled, into a ring of stages with
//    an mbarrier each way, each stage serving one warpgroup).  The 128 query
//    rows of B5's form 1 would need two windows a stage, which does not fit
//    the shared memory at D = 128.
//  - A tile: the band's window (hopper.cuh: an ss wgmma m64n128 over the
//    pe rows the tile's pairs reach, c2-scaled through shared memory to the
//    lanes that hold s; none for a tile wholly past a clip edge, whose rows
//    take the edge columns computed once a block), s = q.k^T (ss), the
//    online softmax in base 2 in f32 (ex2.approx) with the band's path and
//    the masks decided once a tile and a warp, o += bf16(p).v (rs: p the
//    register A operand as the accumulators of s stand, V read MN-major).
//    At D = 64 the band's product and s = q.k^T run as one chain of
//    products; at D = 128 in turn (the band's 64 accumulator registers, s's
//    32 and o's 64 would not fit the 168 of the launch share together).
//  - Key tiles past valid_len or wholly above the diagonal are not loaded
//    (unless valid_len is 0: every key counts); rows past Tq and keys past
//    Tk are TMA's zero fill, the keys masked to -inf.
//  - Shared memory the same at every L: 209,992 bytes at D = 64 (4
//    stages), 218,152 at D = 128 (2 stages), with the band; registers 168
//    a thread (the launch share), one block an SM.
// D < 64 stays on mma.sync, as in csrc/flash_causal.cu.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

// shared row stride of K, V and pe: D + 4 floats or D + 8 bf16 (as in
// csrc/flash_causal.cu)
template <typename T, int D>
__host__ __device__ constexpr int ld() { return std::is_same<T, float>::value ? D + 4 : D + 8; }
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

// the stages in T, then the f32 table
template <typename T, bool MASK_ONLY, int D>
__host__ size_t smem_bytes(int two_l) {
  using S = ShapeOf<MASK_ONLY>;
  return (size_t)S::STAGES * 2 * S::BK * ld<T, D>() * sizeof(T) +
         (size_t)(MASK_ONLY ? 0 : two_l * S::TS) * sizeof(float);
}

// rows [row0, row0 + BK) of a strided [n, D] matrix -> smem [BK][ld],
// asynchronously; rows >= n are zero
template <class S, typename T, int D>
__device__ __forceinline__ void load_tile_async(T* dst, const T* __restrict__ src,
                                                long long row_stride, int row0, int n) {
  constexpr int C = D * (int)sizeof(T) / 16, E = 16 / (int)sizeof(T), LD = ld<T, D>();
#pragma unroll
  for (int i = threadIdx.x; i < S::BK * C; i += S::THREADS) {
    const int r = i / C, c = i % C;
    const bool valid = row0 + r < n;
    const T* s = valid ? src + (row0 + r) * row_stride + c * E : src;
    cp_async16(dst + r * LD + c * E, s, valid);
  }
}

// T = float: three-pass TF32 products.  T = bf16: one bf16 pass for q.k^T,
// q.pe^T and p.v, p rounded to bf16 before p.v, out rounded to bf16; the
// table, the softmax and lse stay f32.
template <typename T, bool MASK_ONLY, int D>
__global__ void __launch_bounds__(ShapeOf<MASK_ONLY>::THREADS, min_blocks<D>())
flash_rel_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ pe,
                     const int* __restrict__ valid_len, T* __restrict__ out,
                     float* __restrict__ lse, Strides st, int H, int Tq, int Tk,
                     int two_l, int causal, float scale) {
  using S = ShapeOf<MASK_ONLY>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int BQ = S::BQ, BK = S::BK, TS = S::TS;
  constexpr int KD = D / 8;      // k-steps of q.k^T and q.pe^T (TF32), column blocks of p.v
  constexpr int LD = ld<T, D>();
  constexpr int NB = BK / 8;     // key blocks of a tile
  constexpr int STAGE = 2 * BK * LD;
  // [STAGES][K, V][BK][LD] of T, then the f32 table [2L][TS]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  float* tab = reinterpret_cast<float*>(smem_raw + S::STAGES * STAGE * sizeof(T));

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;                       // row in the block
  const int r0 = q0 + rl, r1 = r0 + 8;                // this thread's rows
  const int L = two_l / 2;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
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
    T* dst = smem + (S::STAGES == 2 ? (idx & 1) : 0) * STAGE;
    if (idx < npe) {
      load_tile_async<S, T, D>(dst, pe, D, (pe0 + idx) * BK, two_l);
    } else {
      const int k0 = (idx - npe) * BK;
      load_tile_async<S, T, D>(dst, kb, st.kt, k0, Tk);
      load_tile_async<S, T, D>(dst + BK * LD, vb, st.vt, k0, Tk);
    }
    cp_async_commit();
  };
  if (S::STAGES == 2) load_item(0);

  // q's A fragments: split once (TF32), packed pairs (bf16)
  unsigned qbig[F32 ? KD : 1][4], qsmall[F32 ? KD : 1][4];
  Bf16Rows<D> qa;
  if constexpr (!F32) {
    qa.load(qb + r0 * st.qt, qb + r1 * st.qt, r0 < Tq, r1 < Tq, t);
  } else {
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
    const T* sK = smem + (S::STAGES == 2 ? (idx & 1) : 0) * STAGE;
    const T* sV = sK + BK * LD;

    // s = q.B^T with B the stage's first tile (pe rows or keys): block n
    // holds columns 8n + {2t, 2t + 1} of rows r0, r1
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (F32) {
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
    } else {
      qa.template mma_bt<NB, LD>(s, sK, g, t);
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

    if constexpr (F32) {
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
    } else {
      mma_p_b_bf16<NB, D, LD>(o, s, sV, g, t);   // o += bf16(p).v
    }
    __syncthreads();   // this stage is refilled
  }

  const int rows[2] = {r0, r1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    if (rows[r] >= Tq) continue;
    T* orow = out + b * st.ob + h * st.oh + rows[r] * st.ot + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      if constexpr (F32)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
      else
        *reinterpret_cast<unsigned*>(orow + 8 * n) =
            round_pair(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
    }
    // a row that saw only masked keys has the plain version's lse,
    // -1e30 + log(sum), which -1e30 * log2 e * ln 2 would miss by ulps of 1e30
    if (t == 0)
      lse[(long long)bh * Tq + rows[r]] =
          m[r] == NEG ? NEG_NAT + logf(denom) : (m[r] + log2f(denom)) * LN2;
  }
}

// ---- the bf16 wgmma form (form 1) at D = 64 and 128 -----------------------

namespace wg {

constexpr int BQ = 64;            // query rows a block
constexpr int BK = 64;            // keys a tile
constexpr int HALF = 64 * 128;    // bytes of one 64-column half of a 64-row tile
constexpr int W = 2;              // consumer warpgroups
constexpr int THREADS = 128 * (W + 1);
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;   // 128 x 40 + 256 x 232 = 384 x 168

// stages of the ring: a multiple of W, so that each stage serves one
// warpgroup (item idx, stage idx % S, warpgroup idx % 2: a stage shared by
// both could be waited for two phases ahead, which its parity does not
// tell apart)
template <int D>
__host__ __device__ constexpr int stages() { return D == 64 ? 4 : 2; }

// Q of the block's rows; by key tile K, V and the band's window; each
// consumer warpgroup's f32 window [BQ][BAND_LD]
template <bool MASK_ONLY, int D>
struct Smem {
  static constexpr int H2 = D / 64, S = stages<D>();
  static_assert(S % W == 0, "a stage serves one warpgroup");
  bf16 q[H2][BQ][64];
  bf16 k[S][H2][BK][64];
  bf16 v[S][H2][BK][64];
  bf16 pe[MASK_ONLY ? 1 : S][H2][MASK_ONLY ? 8 : BAND_ROWS][64];
  float band[MASK_ONLY ? 1 : W][MASK_ONLY ? 1 : BQ][MASK_ONLY ? 2 : BAND_LD];
  uint64_t q_full, full[S], empty[S];
};

template <bool MASK_ONLY, int D>
__host__ __device__ constexpr size_t smem_bytes() {   // + room to align to 1024
  return sizeof(Smem<MASK_ONLY, D>) + 1024;
}

// key tiles of the block at query row q0: every one below Tk when
// valid_len is 0 (every key counts), else those below valid_len and,
// causal, none wholly above the block's last row
__host__ __device__ inline int key_tiles(int q0, int vl, int Tk, int causal) {
  int n = (Tk + BK - 1) / BK;
  if (vl > 0) {
    n = imin(n, (vl + BK - 1) / BK);
    if (causal) n = imin(n, (q0 + BQ - 1) / BK + 1);
  }
  return n;
}

// The key tiles [0, nk) of a block of 64 query rows from q0 in three runs:
// [0, a) wholly past the high clip edge, [a, b) with a band window, [b, nk)
// wholly past the low one (band_clipped).  The kernel walks the runs in
// loops of their own, so that no wgmma issues under a branch that the
// compiler cannot prove uniform: ptxas serializes the products there
// ("wgmma ... serialized ... in divergent path"), which cost one loop with
// a branch 5-10 % at D = 64 and 128 (PERF.md §6).
struct BandRuns {
  int a, b;
};

__host__ __device__ inline BandRuns band_runs(int q0, int L, int nk) {
  // high: q0 - (k0 + 63) >= L - 1, k0 = 64 idx;  low: q0 + 63 - k0 <= -L
  const int hi_last = q0 - 62 - L;   // the largest k0 clipped high, if >= 0
  const int a = hi_last >= 0 ? hi_last / 64 + 1 : 0;
  const int b = (q0 + 63 + L + 63) / 64;   // the first idx clipped low
  return {imin(a, nk), imax(imin(b, nk), imin(a, nk))};
}

// the first idx >= x of warpgroup w, whose items are w, w + 2, ...
__host__ __device__ inline int first_item(int x, int w) { return x + ((x ^ w) & 1); }

}  // namespace wg

// B1, form 1: out and lse as form 0 computes them.  A block of 384 threads
// per (b*h, 64 query rows): two consumer warpgroups take its key tiles in
// turn (item idx to warpgroup idx % 2), each with its own (m, l, o),
// merged at the end, each warpgroup's rows by half; warpgroup 2 produces.
template <bool MASK_ONLY, int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_rel_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mpe,
                           const bf16* __restrict__ pe, const int* __restrict__ valid_len,
                           bf16* __restrict__ out, long long ob, long long oh, long long ot,
                           float* __restrict__ lse, int H, int Tq, int Tk, int two_l,
                           int causal, float scale) {
  using Sm = wg::Smem<MASK_ONLY, D>;
  constexpr int S = Sm::S, BQ = wg::BQ, BK = wg::BK, HALF = wg::HALF, LD = BAND_LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int L = two_l / 2;
  const int vl = max(0, min(valid_len[b], Tk));
  const int nk = wg::key_tiles(q0, vl, Tk, causal);
  const int w = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], 128);   // the consuming warpgroup's threads release
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (w == wg::W) {   // the producer: one thread issues every copy
    setmaxnreg_dec<wg::PRODUCER_REGS>();
    if (threadIdx.x != 128 * wg::W) return;
    prefetch_tensormap(&mq);
    prefetch_tensormap(&mk);
    prefetch_tensormap(&mv);
    if (!MASK_ONLY) prefetch_tensormap(&mpe);
    mbar_expect_tx(&sm.q_full, sizeof(sm.q));
    for (int hf = 0; hf < Sm::H2; ++hf)
      tma_load_4d(&sm.q[hf][0][0], &mq, &sm.q_full, 64 * hf, q0, h, b);
    for (int idx = 0; idx < nk; ++idx) {
      const int st = idx % S, k0 = idx * BK;
      if (idx >= S) mbar_wait(&sm.empty[st], ((idx / S) & 1) ^ 1);   // item idx - S is done
      const bool window = !MASK_ONLY && !band_clipped(q0, k0, L);
      mbar_expect_tx(&sm.full[st], sizeof(sm.k[st]) + sizeof(sm.v[st]) +
                                       (window ? sizeof(sm.pe[0]) : 0));
      for (int hf = 0; hf < Sm::H2; ++hf) {
        tma_load_4d(&sm.k[st][hf][0][0], &mk, &sm.full[st], 64 * hf, k0, h, b);
        tma_load_4d(&sm.v[st][hf][0][0], &mv, &sm.full[st], 64 * hf, k0, h, b);
        if (!MASK_ONLY && window) {
          const int m_lo = band_first(q0, k0, L);
          for (int part = 0; part < BAND_ROWS / 64; ++part)
            tma_load_4d(&sm.pe[st][hf][64 * part][0], &mpe, &sm.full[st], 64 * hf,
                        m_lo + 64 * part, 0, 0);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<wg::CONSUMER_REGS>();
  const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rl = 16 * wi + g;            // rows rl and rl + 8 of the block's 64
  const int r0 = q0 + rl, r1 = r0 + 8;
  const float c2 = scale * LOG2E;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG};   // running max (base 2) of rows r0, r1
  float l[2] = {0.f, 0.f};   // this thread's share of their sums
  float lo[2] = {0.f, 0.f}, hi[2] = {0.f, 0.f};   // the edge columns, c2-scaled
  float* band = &sm.band[MASK_ONLY ? 0 : w][0][0];
  if constexpr (!MASK_ONLY) {
    BandEdges<D> edges;
    edges.load(pe, two_l, t);   // under the wait for Q
    mbar_wait(&sm.q_full, 0);
    edges.dot(lo, hi, &sm.q[0][0][0], HALF, c2, rl, t);
  } else {
    mbar_wait(&sm.q_full, 0);
  }

  // a tile: its window (with the band), then s = q.k^T, the scores, the
  // online softmax and o += p.v
  auto tile = [&](auto with_window, int idx) {
    constexpr bool WINDOW = decltype(with_window)::value;
    const int st = idx % S, k0 = idx * BK;
    mbar_wait(&sm.full[st], (idx / S) & 1);
    const int m_lo = MASK_ONLY ? 0 : band_first(q0, k0, L);
    float s[BK / 2];
    // the window, then s = q.k^T: one chain at D = 64, in turn at D = 128
    // (the registers of the band's accumulators and s's would not fit
    // beside o's)
    auto qk = [&] {
      wgmma_ss_kmajor<D, BK>(s, &sm.q[0][0][0], HALF, &sm.k[st][0][0][0], HALF);
      wgmma_commit();
    };
    wgmma_fence();
    if constexpr (WINDOW) {
      float sb[BAND_ROWS / 2];
      band_product<D>(sb, &sm.q[0][0][0], HALF, &sm.pe[st][0][0][0]);
      wgmma_commit();
      if constexpr (D == 64) {
        qk();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(sb);
      band_store<LD>(band, sb, c2, rl, t);
      __syncwarp();   // the warp's window rows are written
      if constexpr (D != 64) {
        wgmma_fence();
        qk();
      }
    } else {
      qk();
    }
    wgmma_wait<0>();
    fence_regs(s);

    // i - j over this warp's rows and the tile's keys: the band's path and
    // the masks are decided once a tile, so that each element loop is one
    // basic block whose 32 elements the compiler interleaves
    const int d_min = q0 + 16 * wi - (k0 + BK - 1);
    const int d_max = q0 + 16 * wi + 15 - k0;
    const bool all_valid = k0 + BK <= vl && !(causal && k0 + BK - 1 > q0 + 16 * wi);
    auto scores = [&](auto path, auto check) {
      // path 0: no pair of the warp clipped (a constant offset from one
      // address a row); 1: every pair in one clip column; 2: the general
      // rule; 3: no band.  check: the masks are tested
      constexpr int PATH = decltype(path)::value;
      constexpr bool CHECK = decltype(check)::value;
      const bool high = d_min >= L - 1;   // path 1's column: 2L - 1, else 0
      const float* base = band + rl * LD + (r0 - k0 - 2 * t + L - m_lo);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int i = r ? r1 : r0;
          const int j = k0 + 8 * n + 2 * t + (e & 1);
          float x = s[4 * n + e] * c2;
          if constexpr (PATH == 0) {   // column i - j + L - m_lo of row rl + 8r
            x += base[8 * r * LD + 8 * r - 8 * n - (e & 1)];
          } else if constexpr (PATH == 1) {
            x += high ? hi[r] : lo[r];
          } else if constexpr (PATH == 2) {
            x += band[(rl + 8 * r) * LD + clip(i - j, L) + L - m_lo];
          }
          if constexpr (CHECK) {
            if (j >= vl || (causal && j > i)) x = NEG;
            if (j >= Tk) x = -INFINITY;
          }
          s[4 * n + e] = x;
        }
    };
    // a tile without a window is wholly past a clip edge: path 1 in every warp
    auto by_path = [&](auto check) {
      if constexpr (MASK_ONLY) {
        scores(std::integral_constant<int, 3>{}, check);
      } else if constexpr (!WINDOW) {
        scores(std::integral_constant<int, 1>{}, check);
      } else {
        if (d_min >= L - 1 || d_max <= -L) scores(std::integral_constant<int, 1>{}, check);
        else if (d_min >= -L && d_max <= L - 1) scores(std::integral_constant<int, 0>{}, check);
        else scores(std::integral_constant<int, 2>{}, check);
      }
    };
    if (all_valid) by_path(std::false_type{});
    else by_path(std::true_type{});

    // online softmax in base 2
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = ex2(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t p16[BK / 16][4];
    pack_bf16_a(p16, s);   // p rounded to bf16 (the JAX kernel's astype)
    wgmma_fence();
    wgmma_rs_mnmajor<D, BK / 16>(o, p16, &sm.v[st][0][0][0], HALF);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p16);
    mbar_arrive(&sm.empty[st]);
  };
  // the key tiles in three runs (wg::BandRuns): a window only in the
  // middle one, each run a loop of its own
  const wg::BandRuns runs = MASK_ONLY ? wg::BandRuns{0, 0} : wg::band_runs(q0, L, nk);
  for (int idx = w; idx < runs.a; idx += wg::W) tile(std::false_type{}, idx);
  for (int idx = wg::first_item(runs.a, w); idx < runs.b; idx += wg::W)
    tile(std::true_type{}, idx);
  for (int idx = wg::first_item(runs.b, w); idx < nk; idx += wg::W) tile(std::false_type{}, idx);

  // the two warpgroups' (m, l, o) merged through K's ring (free once both
  // are done): rows 0-31 by warpgroup 0's first two warps, rows 32-63 by
  // warpgroup 1's last two (warps on all four of the SM's schedulers), each
  // from the other warpgroup's partial sums of its rows
  constexpr int LDP = D + 8;
  float* part = reinterpret_cast<float*>(&sm.k[0][0][0][0]);
  float* part_m = part + BQ * LDP;
  float* part_l = part_m + BQ;
  static_assert((BQ * LDP + 2 * BQ) * sizeof(float) <= sizeof(sm.k) + sizeof(sm.v),
                "the merge's partial sums");
  float lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lsum[r] = quad_sum(l[r]);
  const bool merges = (w == 0) == (wi < 2);
  named_barrier(1, 256);   // every item is done: the ring is free
  if (!merges) {
    store_acc<D>(part, LDP, o, 1.f, rl, BQ, t);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) part_m[rl + 8 * r] = m[r], part_l[rl + 8 * r] = lsum[r];
    }
  }
  named_barrier(1, 256);
  if (!merges) return;
  // o = (a0 o0 + a1 o1) / denom, each row's factors folded once
  float a0[2], a1[2], denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = part_m[rl + 8 * r], top = fmaxf(m[r], m1);
    a0[r] = ex2(m[r] - top);
    a1[r] = ex2(m1 - top);
    m[r] = top;
    denom[r] = fmaxf(lsum[r] * a0[r] + part_l[rl + 8 * r] * a1[r], 1e-30f);
    const float inv = 1.f / denom[r];
    a0[r] *= inv;
    a1[r] *= inv;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(part + (rl + 8 * r) * LDP + 8 * j + 2 * t);
      o[4 * j + 2 * r] = o[4 * j + 2 * r] * a0[r] + x.x * a1[r];
      o[4 * j + 2 * r + 1] = o[4 * j + 2 * r + 1] * a0[r] + x.y * a1[r];
    }
  const int rows[2] = {r0, r1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Tq) continue;
    bf16* orow = out + b * ob + h * oh + rows[r] * ot + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<unsigned*>(orow + 8 * j) = round_pair(o[4 * j + 2 * r],
                                                              o[4 * j + 2 * r + 1]);
    // a row that saw only masked keys has the plain version's lse (form 0's
    // rule)
    if (t == 0)
      lse[(long long)bh * Tq + rows[r]] =
          m[r] == NEG ? NEG_NAT + logf(denom[r]) : (m[r] + log2f(denom[r])) * LN2;
  }
}

// raises the kernel's dynamic shared-memory limit once per device
template <typename T, bool MASK_ONLY, int D>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  return allow_smem_once(flash_rel_fwd_kernel<T, MASK_ONLY, D>, 0, done);
}

template <typename T, bool MASK_ONLY, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pe,
                   const int* valid_len, void* out, float* lse, const Strides& st,
                   int B, int H, int Tq, int Tk, int two_l, int causal, float scale,
                   cudaStream_t stream) {
  using S = ShapeOf<MASK_ONLY>;
  const cudaError_t e = allow_smem<T, MASK_ONLY, D>();
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Tq + S::BQ - 1) / S::BQ);
  flash_rel_fwd_kernel<T, MASK_ONLY, D>
      <<<grid, S::THREADS, smem_bytes<T, MASK_ONLY, D>(two_l), stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)pe, valid_len, (T*)out, lse, st,
          H, Tq, Tk, two_l, causal, scale);
  return cudaGetLastError();
}

// The wgmma form's launch as computed on the host: the grid's second dim
// (query tiles) and the tensor maps of q, k, v and pe (hopper.cuh's
// bhtd_map and table_map; every box 64 columns x 64 rows).  The test's
// mirror (tests/test_torch_flash_rel_wgmma.py) follows it;
// loco_flash_rel_fwd_wgmma_plan returns it.
struct FwdPlan {
  int q_tiles;
  uint64_t dims[4][4], strides[4][3];
};

FwdPlan fwd_plan(const Strides& st, int B, int H, int Tq, int Tk, int D, int two_l) {
  FwdPlan p;
  p.q_tiles = (Tq + wg::BQ - 1) / wg::BQ;
  bhtd_map(p.dims[0], p.strides[0], D, Tq, H, B, st.qt, st.qh, st.qb);
  bhtd_map(p.dims[1], p.strides[1], D, Tk, H, B, st.kt, st.kh, st.kb);
  bhtd_map(p.dims[2], p.strides[2], D, Tk, H, B, st.vt, st.vh, st.vb);
  table_map(p.dims[3], p.strides[3], D, two_l);
  return p;
}

template <bool MASK_ONLY, int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* pe,
                         const int* valid_len, void* out, float* lse, const Strides& st, int B,
                         int H, int Tq, int Tk, int two_l, int causal, float scale,
                         cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  static std::atomic<int> regs_ok{-1};
  cudaError_t e = allow_smem_once(flash_rel_fwd_wgmma_kernel<MASK_ONLY, D>,
                                  (int)wg::smem_bytes<MASK_ONLY, D>(), done);
  if (e == cudaSuccess)
    e = check_handover_regs(flash_rel_fwd_wgmma_kernel<MASK_ONLY, D>, wg::THREADS, 128,
                            wg::PRODUCER_REGS, wg::CONSUMER_REGS, regs_ok);
  if (e != cudaSuccess) return e;
  const FwdPlan p = fwd_plan(st, B, H, Tq, Tk, D, two_l);
  const void* ptrs[4] = {q, k, v, pe};
  CUtensorMap maps[4] = {};
  for (int i = 0; i < (MASK_ONLY ? 3 : 4); ++i) {
    e = encode_bf16_map(&maps[i], ptrs[i], p.dims[i], p.strides[i], 64);
    if (e != cudaSuccess) return e;
  }
  flash_rel_fwd_wgmma_kernel<MASK_ONLY, D>
      <<<dim3(B * H, p.q_tiles), wg::THREADS, wg::smem_bytes<MASK_ONLY, D>(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const bf16*)pe, valid_len, (bf16*)out, st.ob, st.oh,
      st.ot, lse, H, Tq, Tk, two_l, causal, scale);
  return cudaGetLastError();
}

// the launch's form: form 1 (wgmma) for bf16 at D = 64 and 128, form 0
// (mma.sync) for every other instantiation (flash_causal.py's kernel_form)
template <typename T, int D>
constexpr int form_of() { return !std::is_same<T, float>::value && D >= 64 ? 1 : 0; }

template <typename T, bool MASK_ONLY, int D>
size_t form_smem_bytes(int two_l) {
  if constexpr (form_of<T, D>() == 1)
    return wg::smem_bytes<MASK_ONLY, D>();
  else
    return smem_bytes<T, MASK_ONLY, D>(two_l);
}

template <typename T, bool MASK_ONLY, int D>
int blocks_per_sm(int two_l) {
  int blocks = -1;
  cudaError_t e;
  if constexpr (form_of<T, D>() == 1) {
    e = cudaFuncSetAttribute(flash_rel_fwd_wgmma_kernel<MASK_ONLY, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wg::smem_bytes<MASK_ONLY, D>());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_rel_fwd_wgmma_kernel<MASK_ONLY, D>, wg::THREADS,
          wg::smem_bytes<MASK_ONLY, D>());
  } else {
    e = allow_smem<T, MASK_ONLY, D>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_rel_fwd_kernel<T, MASK_ONLY, D>, ShapeOf<MASK_ONLY>::THREADS,
          smem_bytes<T, MASK_ONLY, D>(two_l));
  }
  return e == cudaSuccess ? blocks : -1;
}

// f(type tag T*, std::bool_constant<mask_only>, std::integral_constant<int, d>)
// for the instantiated forms, else ``fallback`` (a head dim the kernel does
// not take)
template <class R, class F>
R with_form(int bf16_operands, int mask_only, int d, R fallback, F&& f) {
  auto dims = [&](auto tag, auto mo) -> R {
    switch (d) {
      case 8: return f(tag, mo, std::integral_constant<int, 8>{});
      case 16: return f(tag, mo, std::integral_constant<int, 16>{});
      case 32: return f(tag, mo, std::integral_constant<int, 32>{});
      case 64: return f(tag, mo, std::integral_constant<int, 64>{});
      case 128: return f(tag, mo, std::integral_constant<int, 128>{});
      default: return fallback;
    }
  };
  auto masks = [&](auto tag) -> R {
    return mask_only ? dims(tag, std::true_type{}) : dims(tag, std::false_type{});
  };
  return bf16_operands ? masks((bf16*)nullptr) : masks((float*)nullptr);
}

#define FORM std::remove_pointer_t<decltype(tag)>, decltype(mo)::value, decltype(dd)::value
#define FORM_TD std::remove_pointer_t<decltype(tag)>, decltype(dd)::value
#define FORM_MD decltype(mo)::value, decltype(dd)::value

}  // namespace

// Dynamic shared memory of a launch in the form these operands take (0 for
// a head dim not instantiated); form 1's is the same at every L.
extern "C" size_t loco_flash_rel_smem_bytes(int two_l, int mask_only, int d, int bf16_operands) {
  return with_form(bf16_operands, mask_only, d, (size_t)0,
                   [&](auto tag, auto mo, auto dd) { return form_smem_bytes<FORM>(two_l); });
}

// Blocks of the kernel, in the form these operands take, that fit on one
// SM of the current device at this table size
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
extern "C" int loco_flash_rel_blocks_per_sm(int two_l, int mask_only, int d, int bf16_operands) {
  return with_form(bf16_operands, mask_only, d, -1,
                   [&](auto tag, auto mo, auto dd) { return blocks_per_sm<FORM>(two_l); });
}

// q [.., Tq, D], k/v [.., Tk, D], out [.., Tq, D] (float32, or bfloat16
// when bf16_operands is nonzero; head dim contiguous, 16-byte aligned
// rows), addressed through strides[12] = (batch, head, time) element
// strides of q, k, v, out in that order; pe [two_l, D] contiguous, of q's
// type (not read when mask_only), valid_len [B] int32, lse [B,H,Tq] float32
// contiguous.  form 0: the mma.sync kernel, float32 at D in {8, 16, 32, 64,
// 128} and bfloat16 at {8, 16, 32}; form 1: the wgmma/TMA kernel, bfloat16
// at D in {64, 128} (q, k, v strides in bytes multiples of 16).  Another
// pairing returns cudaErrorNotSupported.
extern "C" int loco_flash_rel_fwd(const void* q, const void* k, const void* v,
                                  const void* pe, const void* valid_len, void* out,
                                  void* lse, const long long* strides, int B, int H,
                                  int Tq, int Tk, int D, int two_l, int causal,
                                  int mask_only, float scale, int form, int bf16_operands,
                                  void* stream) {
  if (form != 0 && form != 1) return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  return (int)with_form(bf16_operands, mask_only, D, cudaErrorInvalidValue,
                        [&](auto tag, auto mo, auto dd) {
                          if (form != form_of<FORM_TD>()) return cudaErrorNotSupported;
                          if constexpr (form_of<FORM_TD>() == 1)
                            return launch_wgmma<FORM_MD>(q, k, v, pe, (const int*)valid_len,
                                                         out, (float*)lse, st, B, H, Tq, Tk,
                                                         two_l, causal, scale,
                                                         (cudaStream_t)stream);
                          else
                            return launch<FORM>(q, k, v, pe, (const int*)valid_len, out,
                                                (float*)lse, st, B, H, Tq, Tk, two_l, causal,
                                                scale, (cudaStream_t)stream);
                        });
}

// The wgmma form's plan (FwdPlan and the tiles its blocks take) for these
// arguments and the host's valid_len[B], into out[35]: blocks, key tiles
// over all blocks, the band windows they load (tiles not wholly past a
// clip edge; 0 when mask_only); for q, k, v and pe in turn dims[4] and
// byte strides[3]; then the dynamic shared memory, threads and stages
// (D in {64, 128}).
extern "C" void loco_flash_rel_fwd_wgmma_plan(const long long* strides, int B, int H, int Tq,
                                              int Tk, int D, int two_l, int causal,
                                              int mask_only, const int* valid_len,
                                              long long* out) {
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const FwdPlan p = fwd_plan(st, B, H, Tq, Tk, D, two_l);
  const int L = two_l / 2;
  long long tiles = 0, windows = 0;
  for (int b = 0; b < B; ++b) {
    const int vl = imax(0, imin(valid_len[b], Tk));
    for (int y = 0; y < p.q_tiles; ++y) {
      const int nk = wg::key_tiles(y * wg::BQ, vl, Tk, causal);
      tiles += nk;
      for (int i = 0; i < nk && !mask_only; ++i)
        windows += !band_clipped(y * wg::BQ, i * wg::BK, L);
    }
  }
  out[0] = (long long)B * H * p.q_tiles;
  out[1] = tiles * H;
  out[2] = windows * H;
  for (int i = 0; i < 4; ++i) {
    long long* o = out + 3 + 7 * i;
    for (int j = 0; j < 4; ++j) o[j] = (long long)p.dims[i][j];
    for (int j = 0; j < 3; ++j) o[4 + j] = (long long)p.strides[i][j];
  }
  const bool d64 = D == 64;
  out[31] = mask_only ? (d64 ? wg::smem_bytes<true, 64>() : wg::smem_bytes<true, 128>())
                      : (d64 ? wg::smem_bytes<false, 64>() : wg::smem_bytes<false, 128>());
  out[32] = wg::THREADS;
  out[33] = d64 ? wg::stages<64>() : wg::stages<128>();
  out[34] = wg::W;
}
