// Relative-position + key-padding flash attention, backward (kernels B3, B4).
//
// Replaces: loco_asr_tpu/ops/pallas/flash_attention.py::_rel_bwd_dq_kernel
// (B3) and ::_rel_bwd_dkv_kernel (B4), launched by
// _flash_rel_backward_pallas: the gradient of kernel B1 (csrc/flash_rel.cu).
// From the forward's lse and delta = rowsum(g * out) they recompute
//   s[i,j] = scale*q_i.k_j + scale*q_i.pe[clip(i-j, -L, L-1) + L]
//   p = exp(s - lse) (exactly 0 where key j >= valid_len[b] or, causal,
//   j > i; so a row with valid_len 0 gets zero gradients)
//   ds = p * (g_i.v_j - delta_i)
// and produce
//   B3: dq_content = scale * ds.k   and the band gradient
//       dqpe[i, m] = sum_{j: clip(i-j)+L == m} ds[i, j]   ([B,H,Tq,2L])
//   B4: dv = p^T.g,  dk = scale * ds^T.q
// The caller adds dq += scale * dqpe.pe and dpe = scale * sum dqpe^T.q with
// torch.matmul, as _flash_rel_backward_pallas does outside its Pallas calls.
// The mask-only variant (MASK_ONLY, what flash_attention runs without
// rel_pe) has no table, no band and no dqpe.  q, k, v, g and the outputs
// dq, dk, dv are addressed through (batch, head, time) element strides with
// a contiguous head dim, so split_heads' transposed views are read in place
// and the gradients land in [B, T, H, D] buffers; pe, lse, delta and dqpe
// are contiguous.  The head dim D is a template parameter, instantiated for
// the set B1 takes, {8, 16, 32, 64, 128}, as the TPU kernels read d from
// the shape: the SpeechT5 base encoder trains at D = 64, the LoCo
// experiment's ASR model and train_asr --tiny at D = 8.  D / 8 k-steps make
// q.k^T, g.v^T and q.pe^T, D / 8 column blocks dq, dk and dv.
//
// What bounds them on an H100: arithmetic.  At the encoder's training shape
// ([8, 12, 500, 64], L = 160) B3 does three and B4 four Tq x Tk x 64
// products per head, ~10 and ~13 GFLOP, against ~120 MB (dqpe included)
// and ~75 MB of operands and outputs.  As in B1
// every product runs on the tensor cores as three TF32 mma.sync passes at
// f32 accuracy (tf32_mma.cuh).
//
// Design (flash-attention-2's backward, split in two kernels as the TPU's;
// helpers shared with B1 and B5/B6):
// * B3: a block of 4 warps per (b*h, 64 query rows); each warp owns 16 rows,
//   holds its q fragments split once and its g fragments raw, split at
//   each use (kept so with RawRows::keep_raw: the compiler would hoist the
//   split and fill all 255 registers, which measured slower), and loops
//   over 32-key tiles: s = q.k^T and dp = g.v^T by
//   three-pass mma, p = exp2(s*c + band - lse*log2 e) with masked entries
//   exactly 0, ds = p*(dp - delta), then dq += ds.k with ds kept in
//   registers as the A operand by reading each 8-key step in the order
//   (2t, 2t + 1), as B1 does for p.v.  The band is B1's: the block first
//   builds tab = scale*log2e * q.pe^T over the pe tiles its rows reach, one
//   band column per row at a stride TS = 4 mod 32 (conflict-free, see
//   csrc/flash_rel.cu).  Its gradient: for a fixed row, j -> clip(i-j)+L is
//   one-to-one on interior columns, so each interior cell is read exactly
//   once, by the lane that then overwrites it with ds (no barrier, no more
//   shared memory); the two clip columns are re-read and their ds summed in
//   registers (quad_sum at the end).  At the end each warp writes its rows'
//   2L columns coalesced: the cell of a processed pair from the table, 0
//   where no pair reached it (keys past valid_len, above the diagonal, pe
//   tiles not loaded), so dqpe needs no memset.  Copies are 16-byte
//   cp.async into rows of D + 4 floats: pe tiles, then K tiles, are
//   double-buffered, V single-buffered and refilled as soon as dp has read
//   it, so each copy overlaps the item before; 26 KB beside the 87 KB table
//   keep two blocks an SM at L = 160 and D = 64.
// * B4: the transposed form: a block of 4 warps per (b*h, 64 keys), each
//   warp 16 keys with its k fragments split once in registers and its v
//   fragments read from shared memory at each use (registers go to the dk
//   and dv accumulators), looping over 32-query tiles double-buffered by
//   cp.async (q, g, lse, delta): s^T = k.q^T and dp^T = v.g^T with the
//   q/g tile as B operand, the band term from band[c][i] = scale*log2e *
//   pe[m_lo + c].q_i, built per query tile by the same mma over the <= 95
//   pe rows the tile pair reaches (i - j spans 95 values, clipped; loaded
//   into one buffer once the previous band is built); p^T, ds^T =
//   p^T (dp^T - delta_i) with lse_i and delta_i per column; dv += p^T.g and
//   dk += ds^T.q with p^T and ds^T reused from registers as A operands.
//   Each tile's dv and dk go through a zeroed partial sum added in f32: the
//   mma truncates as it accumulates, and a sum carried through the ~190
//   mma of a 500-query loop drifts by ~1e-5 of its size.  The band's
//   stride BLD = 8 mod 32 makes its float2 stores conflict-free and its
//   reads 2-way (no linear layout is conflict-free for both).  Budget: near
//   the diagonal the band costs about half again the four main products of
//   a tile pair (fewer where it clips to a few rows); the bound counts
//   q.pe^T once.
// * Skipping: B3 stops at the key tile holding valid_len and, causal, at
//   the diagonal; B4 starts at the diagonal query tile, and a key tile at or
//   past valid_len writes zeros and returns.  Rows >= Tq and keys >= Tk are
//   masked, so Tq != Tk and ragged T need no padding.
// * Head dims.  Every row stride keeps the fragment reads conflict-free at
//   each D: D + 4 floats (word 4g + t mod 32 for D >= 32, 12g or 20g + t
//   below) and D + 8 bf16 (D + 16 at D = 8, where D + 8 would give 8g + t,
//   two-way).  At D = 128 the accumulators alone take 64 registers a
//   warp row pair (dq; dk and dv 128), so the A operands that D <= 64 keeps
//   in registers are staged in shared memory and read (and split) at each
//   use: B3's q and g in the f32 form, B4's k and v in both forms; B4 adds
//   its partial sums 64 columns at a time; one block an SM.
// Shapes, registers and blocks an SM are in PERF.md §6; wgmma and TMA are
// later work.
//
// The bf16 forms (the element type T is a template parameter; the f32
// instantiations are the kernels described above) are the JAX
// kernels' bf16 path: q, k, v, g and pe in bf16, every product one
// m16n8k16 bf16 mma.sync with f32 accumulation (bf16_mma.cuh; one m16n8k8
// step over the head dim at D = 8), ds rounded
// to bf16 before ds.k (B3) and p and ds before p^T.g and ds^T.q (B4), as
// the JAX kernels' astype does; lse, delta, p, ds, the band table, dqpe and
// the dq, dk, dv sums stay f32, and the outputs leave the kernels in f32
// (the wrapper casts them, as _flash_rel_backward_pallas does).  B4's bf16
// form keeps both k's and v's fragments in registers up to D = 64 (packed
// pairs take a quarter of a split f32 fragment's registers), so it stages
// no v there.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// shared row stride of the q, g, k, v and pe tiles (see "Head dims" above)
template <typename T, int D>
__host__ __device__ constexpr int ldt() {
  return std::is_same<T, float>::value ? D + 4 : (D == 8 ? 24 : D + 8);
}
// B3's f32 form reads q and g from shared memory at D = 128, B4 k and v
template <typename T, int D>
__host__ __device__ constexpr bool dq_staged() { return std::is_same<T, float>::value && D >= 128; }
template <int D>
__host__ __device__ constexpr bool dkv_staged() { return D >= 128; }
template <int D>
constexpr int min_blocks() { return D <= 64 ? 2 : 1; }

enum Operand { IQ, IK, IV, IG, IDQ, IDK, IDV, N_OPERANDS };
struct Strides {               // element strides of (batch, head, time)
  long long b[N_OPERANDS], h[N_OPERANDS], t[N_OPERANDS];
};

// 16 rows x D of an A operand in registers, split (big, small) once
template <int D>
struct SplitRows {
  unsigned big[D / 8][4], small[D / 8][4];
  __device__ __forceinline__ void set(int kk, int e, float x) {
    split_tf32(x, big[kk][e], small[kk][e]);
  }
  __device__ __forceinline__ void get(int kk, unsigned (&b)[4], unsigned (&s)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = big[kk][e], s[e] = small[kk][e];
  }
};

// the same kept raw and split at each use (half the registers); the
// compiler hoists that split out of a loop unless keep_raw() runs in it
template <int D>
struct RawRows {
  float x[D / 8][4];
  __device__ __forceinline__ void set(int kk, int e, float v) { x[kk][e] = v; }
  __device__ __forceinline__ void get(int kk, unsigned (&b)[4], unsigned (&s)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[kk][e], b[e], s[e]);
  }
  __device__ __forceinline__ void keep_raw() {   // emits no instruction
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[kk][e]));
  }
};

// 16 rows x D of an A operand read from a shared [*, D + 4] tile and split
// at each use; p points at the lane's (row g, column t)
template <int D>
struct SmemRows {
  static constexpr int LD = D + 4;
  const float* p;
  __device__ __forceinline__ void get(int kk, unsigned (&b)[4], unsigned (&s)[4]) const {
    split_tf32(p[8 * kk], b[0], s[0]);
    split_tf32(p[8 * LD + 8 * kk], b[1], s[1]);
    split_tf32(p[8 * kk + 4], b[2], s[2]);
    split_tf32(p[8 * LD + 8 * kk + 4], b[3], s[3]);
  }
};

// rows r0, r1 = r0 + 8 (zero at or past n) of a strided [n, D] matrix as
// this lane's A fragments: (r, 8kk + t) and (r, 8kk + t + 4)
template <int D, class Rows>
__device__ __forceinline__ void load_rows(Rows& f, const float* __restrict__ base,
                                          long long ts, int r0, int r1, int n, int t) {
  const float* p0 = base + r0 * ts;
  const float* p1 = base + r1 * ts;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = 8 * kk + t;
    f.set(kk, 0, r0 < n ? p0[c] : 0.f);
    f.set(kk, 1, r1 < n ? p1[c] : 0.f);
    f.set(kk, 2, r0 < n ? p0[c + 4] : 0.f);
    f.set(kk, 3, r1 < n ? p1[c + 4] : 0.f);
  }
}

// c[n] += a . B^T: a the warp's 16 rows, B the rows 8n + g of a shared
// [*, D + 4] tile; block n of c holds columns 8n + {2t, 2t + 1}
template <int NB, int D, class Rows>
__device__ __forceinline__ void mma_rows_bt(float (&c)[NB][4], const Rows& a,
                                            const float* sB, int g, int t) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    unsigned abig[4], asmall[4];
    a.get(kk, abig, asmall);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float* br = sB + (8 * n + g) * LD + 8 * kk + t;
      unsigned bbig[2], bsmall[2];
      split_tf32(br[0], bbig[0], bsmall[0]);
      split_tf32(br[4], bbig[1], bsmall[1]);
      mma_3xtf32(c[n], abig, asmall, bbig, bsmall);
    }
  }
}

// acc += P . B: P [16, 8 NB] in the C layout of mma_rows_bt (registers), B
// the first 8 NB rows of a shared [*, D + 4] tile; acc holds the NN column
// blocks of 8 from column 8 n0 on; each 8-column step of P is read in the
// order (2t, 2t + 1), B's rows likewise, so P needs no shuffle
template <int NB, int D, int NN = D / 8>
__device__ __forceinline__ void mma_p_b(float (&acc)[NN][4], const float (&p)[NB][4],
                                        const float* sB, int g, int t, int n0 = 0) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    unsigned abig[4], asmall[4];
    split_tf32(p[kk][0], abig[0], asmall[0]);
    split_tf32(p[kk][2], abig[1], asmall[1]);
    split_tf32(p[kk][1], abig[2], asmall[2]);
    split_tf32(p[kk][3], abig[3], asmall[3]);
    const float* br = sB + (8 * kk + 2 * t) * LD + g + 8 * n0;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      unsigned bbig[2], bsmall[2];
      split_tf32(br[8 * n], bbig[0], bsmall[0]);
      split_tf32(br[LD + 8 * n], bbig[1], bsmall[1]);
      mma_3xtf32(acc[n], abig, asmall, bbig, bsmall);
    }
  }
}

// rows [row0, row0 + rows) of a strided [n, D] matrix -> smem [rows][ldt],
// asynchronously; rows >= n are zero
template <int THREADS, typename T, int D>
__device__ __forceinline__ void load_tile_async(T* dst, const T* __restrict__ src,
                                                long long row_stride, int row0, int rows,
                                                int n) {
  constexpr int C = D * (int)sizeof(T) / 16, E = 16 / (int)sizeof(T);   // 16-byte pieces
  for (int i = threadIdx.x; i < rows * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const bool valid = row0 + r < n;
    const T* s = valid ? src + (row0 + r) * row_stride + c * E : src;
    cp_async16(dst + r * ldt<T, D>() + c * E, s, valid);
  }
}

// src[i0, i0 + count) -> dst, asynchronously; entries >= n are zero
template <int THREADS>
__device__ __forceinline__ void load_vec_async(float* dst, const float* __restrict__ src,
                                               int i0, int count, int n) {
  for (int i = threadIdx.x; i < count; i += THREADS) {
    const bool valid = i0 + i < n;
    cp_async4(dst + i, valid ? src + i0 + i : src, valid);
  }
}

// (rows r0, r1) x D of C-layout accumulators, times mul, to a strided row
// block; rows >= n are not stored
template <int D>
__device__ __forceinline__ void store_rows(float* base, long long ts,
                                           const float (&acc)[D / 8][4], float mul, int r0,
                                           int r1, int n, int t) {
  const int rows[2] = {r0, r1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= n) continue;
    float* o = base + rows[r] * ts + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(o + 8 * c) =
          make_float2(acc[c][2 * r] * mul, acc[c][2 * r + 1] * mul);
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

__device__ __forceinline__ int clip(int d, int L) { return min(max(d, -L), L - 1); }

// 2^x on the SFU (~2 ulp; a subnormal result is flushed to 0, where exp2f
// spends instructions on keeping it)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- B3 ----------------------------------------------------------------

template <int WARPS_, int BK_>
struct DqShape {
  static constexpr int WARPS = WARPS_, BK = BK_;
  static constexpr int BQ = 16 * WARPS;        // query rows per block
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int TS = BQ + 4;            // table stride, = 4 mod 32
};
using DqS = DqShape<4, 32>;

// two K / pe buffers, V, [q and g], [the f32 table]
template <typename T, bool MASK_ONLY, int D>
__host__ size_t dq_smem_bytes(int two_l) {
  return (size_t)(3 * DqS::BK + (dq_staged<T, D>() ? 2 * DqS::BQ : 0)) * ldt<T, D>() *
             sizeof(T) +
         (size_t)(MASK_ONLY ? 0 : two_l * DqS::TS) * sizeof(float);
}

// T = float: three-pass TF32 products.  T = bf16: one bf16 pass, ds
// rounded to bf16 before ds.k (the JAX kernel's ds.astype(k.dtype)); p,
// ds, the table, dqpe and dq stay f32.
template <typename T, bool MASK_ONLY, int D>
__global__ void __launch_bounds__(DqS::THREADS, min_blocks<D>())
flash_rel_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ pe,
                        const int* __restrict__ valid_len, const float* __restrict__ lse,
                        const float* __restrict__ delta, const T* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ dqpe, Strides st,
                        int H, int Tq, int Tk, int two_l, int causal, float scale) {
  using S = DqS;
  constexpr bool F32 = std::is_same<T, float>::value, STAGED = dq_staged<T, D>();
  constexpr int BQ = S::BQ, BK = S::BK, TS = S::TS, LDT = ldt<T, D>();
  constexpr int NB = BK / 8;     // key blocks of a tile
  // [2][BK][LDT] pe or K tiles, V [BK][LDT], (STAGED) q and g [BQ][LDT]
  // (of T), then the f32 table [2L][TS]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* sV = smem + 2 * BK * LDT;
  T* sQ = sV + BK * LDT;
  T* sG = sQ + BQ * LDT;
  float* tab = reinterpret_cast<float*>(STAGED ? sG + BQ * LDT : sQ);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;                       // row in the block
  const int r0 = q0 + rl, r1 = r0 + 8;                // this thread's rows
  const int L = two_l / 2;
  const T* kb = k + b * st.b[IK] + h * st.h[IK];
  const T* vb = v + b * st.b[IV] + h * st.h[IV];
  const int vl = max(0, min(valid_len[b], Tk));

  int nk = (vl + BK - 1) / BK;   // later tiles are masked; none when vl is 0
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  // pe tiles holding the table columns the block's rows reach (B1's rule)
  int pe0 = 0, npe = 0;
  if (!MASK_ONLY && nk > 0) {
    const int j_last = causal ? min(vl - 1, q0 + BQ - 1) : vl - 1;
    pe0 = (clip(q0 - j_last, L) + L) / BK;
    npe = (min(q0 + BQ - 1, L - 1) + L) / BK - pe0 + 1;
  }
  const int n_items = npe + nk;

  // items: npe pe tiles, then nk key tiles.  An item's first tile (pe
  // rows or keys) goes to buffer idx & 1 while the item before it runs;
  // V goes to its one buffer once the item before has read it
  auto load_first = [&](int idx) {
    T* dst = smem + (idx & 1) * BK * LDT;
    if (idx < npe)
      load_tile_async<S::THREADS, T, D>(dst, pe, D, (pe0 + idx) * BK, BK, two_l);
    else
      load_tile_async<S::THREADS, T, D>(dst, kb, st.t[IK], (idx - npe) * BK, BK, Tk);
  };
  auto load_v = [&](int idx) {
    load_tile_async<S::THREADS, T, D>(sV, vb, st.t[IV], (idx - npe) * BK, BK, Tk);
  };
  const T* qrows = q + b * st.b[IQ] + h * st.h[IQ];
  const T* grows = dout + b * st.b[IG] + h * st.h[IG];
  if (n_items > 0) {
    load_first(0);
    if (npe == 0) load_v(0);
    if constexpr (STAGED) {
      load_tile_async<S::THREADS, T, D>(sQ, qrows, st.t[IQ], q0, BQ, Tq);
      load_tile_async<S::THREADS, T, D>(sG, grows, st.t[IG], q0, BQ, Tq);
    }
    cp_async_commit();
  }

  SplitRows<D> qf;
  RawRows<D> gf;         // split at each use: registers left to schedule with
  Bf16Rows<D> qa, ga;    // the bf16 form's packed pairs
  // STAGED: the warp's rows in shared memory
  const SmemRows<D> qs{reinterpret_cast<const float*>(sQ) + rl * LDT + t};
  const SmemRows<D> gs{reinterpret_cast<const float*>(sG) + rl * LDT + t};
  if constexpr (!F32) {
    qa.load(qrows + r0 * st.t[IQ], qrows + r1 * st.t[IQ], r0 < Tq, r1 < Tq, t);
    ga.load(grows + r0 * st.t[IG], grows + r1 * st.t[IG], r0 < Tq, r1 < Tq, t);
  } else if constexpr (!STAGED) {
    load_rows<D>(qf, qrows, st.t[IQ], r0, r1, Tq, t);
    load_rows<D>(gf, grows, st.t[IG], r0, r1, Tq, t);
  }
  float lse2[2], dlt[2];
  {
    const int rows[2] = {r0, r1};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < Tq;
      lse2[r] = in ? lse[(long long)bh * Tq + rows[r]] * LOG2E : 0.f;
      dlt[r] = in ? delta[(long long)bh * Tq + rows[r]] : 0.f;
    }
  }

  float acc[D / 8][4];
  zero_acc(acc);
  float lo[2] = {0.f, 0.f}, hi[2] = {0.f, 0.f};             // ds of the clip columns
  float band_lo[2] = {0.f, 0.f}, band_hi[2] = {0.f, 0.f};   // table columns 0, 2L-1
  const float c2 = scale * LOG2E;

  for (int idx = 0; idx < n_items; ++idx) {
    if (idx + 1 < n_items) {     // the next item's copy overlaps this one's products
      load_first(idx + 1);
      if (idx + 1 == npe) load_v(idx + 1);   // V is idle during the pe items
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sK = smem + (idx & 1) * BK * LDT;
    if constexpr (F32 && !STAGED) gf.keep_raw();

    // s = q.B^T with B the item's first tile (pe rows or keys)
    float s[NB][4];
    zero_acc(s);
    if constexpr (!F32)
      qa.template mma_bt<NB, LDT>(s, sK, g, t);
    else if constexpr (STAGED)
      mma_rows_bt<NB, D>(s, qs, sK, g, t);
    else
      mma_rows_bt<NB, D>(s, qf, sK, g, t);

    if (!MASK_ONLY && idx < npe) {   // table columns m0 + 8n + 2t + (e & 1)
      const int m0 = (pe0 + idx) * BK;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = m0 + 8 * n + 2 * t + (e & 1);
          if (col < two_l) tab[col * TS + rl + 8 * (e >> 1)] = s[n][e] * c2;
        }
      __syncthreads();   // the buffer is refilled
      continue;
    }

    const int k0 = (idx - npe) * BK;
    float dp[NB][4];
    zero_acc(dp);
    if constexpr (!F32)
      ga.template mma_bt<NB, LDT>(dp, sV, g, t);
    else if constexpr (STAGED)
      mma_rows_bt<NB, D>(dp, gs, sV, g, t);
    else
      mma_rows_bt<NB, D>(dp, gf, sV, g, t);
    if (idx + 1 < n_items) {     // V is read: the next tile's copy overlaps the rest
      __syncthreads();
      load_v(idx + 1);
      cp_async_commit();
    }

    // i - j over this warp's rows and the tile's keys
    const int d_min = q0 + 16 * warp - (k0 + BK - 1);
    const int d_max = q0 + 16 * warp + 15 - k0;
    const bool one_side = d_min >= L - 1 || d_max <= -L;   // one clip column a row
    const bool interior = d_min > -L && d_max < L - 1;      // no clip, no clip column
    const bool all_valid = k0 + BK <= vl && !(causal && k0 + BK - 1 > q0 + 16 * warp);
    if (!MASK_ONLY && idx == npe) {   // columns 0 and 2L - 1, where they were built
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        band_lo[r] = pe0 == 0 ? tab[rl + 8 * r] : 0.f;
        band_hi[r] = (pe0 + npe) * BK >= two_l ? tab[(two_l - 1) * TS + rl + 8 * r] : 0.f;
      }
    }
    // p, then ds in place of s; the band's interior cells take ds in place
    // of q.pe, each read once, by this lane
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int i = r ? r1 : r0;
        const int j = k0 + 8 * n + 2 * t + (e & 1);
        float x = s[n][e] * c2;
        const int d = i - j;
        float* cell = nullptr;
        if (!MASK_ONLY) {
          if (one_side) {
            x += d_min >= L - 1 ? band_hi[r] : band_lo[r];
          } else if (interior) {   // column d + L, row rl + 8r: constant offsets
            cell = tab + (r0 - k0 - 2 * t + L) * TS + rl + (8 * r - 8 * n - (e & 1)) * TS + 8 * r;
            x += *cell;
          } else {
            const int col = clip(d, L) + L;
            x += tab[col * TS + rl + 8 * r];
            if (col == d + L && col != 0 && col != two_l - 1) cell = tab + col * TS + rl + 8 * r;
          }
        }
        const bool masked = !all_valid && (j >= vl || (causal && j > i));
        const float p = masked ? 0.f : fast_exp2(x - lse2[r]);
        const float ds = p * (dp[n][e] - dlt[r]);
        s[n][e] = ds;
        if (!MASK_ONLY) {
          if (cell != nullptr) *cell = ds;
          else if (d <= -L) lo[r] += ds;
          else hi[r] += ds;
        }
      }

    if constexpr (F32)
      mma_p_b<NB, D>(acc, s, sK, g, t);   // dq += ds.k
    else
      mma_p_b_bf16<NB, D, LDT>(acc, s, sK, g, t);   // dq += bf16(ds).k
    __syncthreads();   // this buffer is refilled
  }

  store_rows<D>(dq + b * st.b[IDQ] + h * st.h[IDQ], st.t[IDQ], acc, scale, r0, r1, Tq, t);
  if (MASK_ONLY) return;

  float lo_sum[2], hi_sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lo_sum[r] = quad_sum(lo[r]), hi_sum[r] = quad_sum(hi[r]);
  __syncwarp();   // the warp's table cells are written
  // the warp's 16 rows, 4 at a time, 8 consecutive columns a row: the cells
  // of processed pairs (j < nk * BK) from the table, the rest 0
  const int jproc = nk * BK;
  const int sub = lane >> 3, mi = lane & 7;
  for (int rr = sub; rr < 16; rr += 4) {
    const int i = q0 + 16 * warp + rr;
    if (i >= Tq) break;
    float* row = dqpe + ((long long)bh * Tq + i) * two_l;
    const int m_min = max(1, i + L - jproc + 1), m_max = min(two_l - 2, i + L);
    for (int m = mi; m < two_l; m += 8)
      if (m > 0 && m < two_l - 1)   // the clip columns follow
        row[m] = m >= m_min && m <= m_max ? tab[m * TS + 16 * warp + rr] : 0.f;
  }
  if (t == 0) {
    const int rows[2] = {r0, r1};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= Tq) continue;
      float* row = dqpe + ((long long)bh * Tq + rows[r]) * two_l;
      row[0] = lo_sum[r];
      row[two_l - 1] = hi_sum[r];
    }
  }
}

// ---- B4 ----------------------------------------------------------------

template <int WARPS_, int BQ_>
struct DkvShape {
  static constexpr int WARPS = WARPS_, BQ = BQ_;   // BQ: query rows a tile
  static constexpr int BK = 16 * WARPS;            // keys per block
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NPE = (BQ + BK - 1 + 15) / 16 * 16;   // pe rows a tile pair
  static constexpr int BLD = BQ + 8;                // band stride, = 8 mod 32
};
using DkvS = DkvShape<4, 32>;

// bytes of B4's shared memory: v (the f32 form's, and the bf16 form's at
// D = 128; below it the bf16 form holds v's fragments in registers), k (at
// D = 128), two stages of (q, g of T, lse, delta), then pe rows of T and
// the f32 band
template <typename T, bool MASK_ONLY, int D>
struct DkvSmem {
  using S = DkvS;
  static constexpr int LDT = ldt<T, D>();
  static constexpr size_t ROWS = S::BK * LDT * sizeof(T);
  static constexpr size_t V = std::is_same<T, float>::value || dkv_staged<D>() ? ROWS : 0;
  static constexpr size_t K = dkv_staged<D>() ? ROWS : 0;
  static constexpr size_t STAGE = 2 * S::BQ * LDT * sizeof(T) + 2 * S::BQ * sizeof(float);
  static constexpr size_t PE = MASK_ONLY ? 0 : S::NPE * LDT * sizeof(T);
  static constexpr size_t BAND = MASK_ONLY ? 0 : S::NPE * S::BLD * sizeof(float);
  static constexpr size_t BYTES = V + K + 2 * STAGE + PE + BAND;
};

template <typename T, bool MASK_ONLY, int D>
__host__ size_t dkv_smem_bytes() { return DkvSmem<T, MASK_ONLY, D>::BYTES; }

// T = float: three-pass TF32 products.  T = bf16: one bf16 pass, p and ds
// rounded to bf16 before p^T.g and ds^T.q (the JAX kernel's astype); the
// band, p, ds and the dk, dv sums stay f32.
template <typename T, bool MASK_ONLY, int D>
__global__ void __launch_bounds__(DkvS::THREADS, min_blocks<D>())
flash_rel_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ pe,
                         const int* __restrict__ valid_len, const float* __restrict__ lse,
                         const float* __restrict__ delta, const T* __restrict__ dout,
                         float* __restrict__ dk, float* __restrict__ dv, Strides st,
                         int H, int Tq, int Tk, int two_l, int causal, float scale) {
  using S = DkvS;
  using M = DkvSmem<T, MASK_ONLY, D>;
  constexpr bool F32 = std::is_same<T, float>::value, STAGED = dkv_staged<D>();
  constexpr int BQ = S::BQ, BK = S::BK, BLD = S::BLD, LDT = M::LDT;
  constexpr int NQ = BQ / 8;     // query blocks of a tile
  constexpr int KD = D / 8;      // column blocks of dk and dv
  constexpr int CH = STAGED ? 2 : 1, NN = KD / CH;   // partial sums of NN blocks
  // v, k [BK][LDT], [2][q, g, lse, delta], then pe rows [NPE][LDT], band
  // [NPE][BLD]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sV = reinterpret_cast<T*>(smem_raw);
  T* sKr = reinterpret_cast<T*>(smem_raw + M::V);
  unsigned char* stages = smem_raw + M::V + M::K;
  T* sPE = reinterpret_cast<T*>(stages + 2 * M::STAGE);
  float* band = reinterpret_cast<float*>(stages + 2 * M::STAGE + M::PE);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = k0 + 16 * warp + g, j1 = j0 + 8;     // this thread's keys
  const int L = two_l / 2;
  const int vl = max(0, min(valid_len[b], Tk));
  float* dkb = dk + b * st.b[IDK] + h * st.h[IDK];
  float* dvb = dv + b * st.b[IDV] + h * st.h[IDV];

  float dka[KD][4], dva[KD][4];
  zero_acc(dka);
  zero_acc(dva);
  if (k0 >= vl) {                // every key of the block is masked
    store_rows<D>(dkb, st.t[IDK], dka, 1.f, j0, j1, Tk, t);
    store_rows<D>(dvb, st.t[IDV], dva, 1.f, j0, j1, Tk, t);
    return;
  }

  const T* qb = q + b * st.b[IQ] + h * st.h[IQ];
  const T* gb = dout + b * st.b[IG] + h * st.h[IG];
  const int qt0 = causal ? k0 / BQ : 0;   // earlier query tiles are above the diagonal
  const int n_items = (Tq + BQ - 1) / BQ - qt0;
  auto m_lo_of = [&](int q0) { return clip(q0 - (k0 + BK - 1), L) + L; };
  auto n_band_of = [&](int q0) {   // pe rows of the tile pair, rounded up to 16
    return (clip(q0 + BQ - 1 - k0, L) + L - m_lo_of(q0) + 16) / 16 * 16;
  };
  auto load_tile = [&](int idx) {   // query tile idx -> stage idx & 1
    T* dst = reinterpret_cast<T*>(stages + (idx & 1) * M::STAGE);
    float* dst_f = reinterpret_cast<float*>(dst + 2 * BQ * LDT);
    const int q0 = (qt0 + idx) * BQ;
    load_tile_async<S::THREADS, T, D>(dst, qb, st.t[IQ], q0, BQ, Tq);
    load_tile_async<S::THREADS, T, D>(dst + BQ * LDT, gb, st.t[IG], q0, BQ, Tq);
    load_vec_async<S::THREADS>(dst_f, lse + (long long)bh * Tq, q0, BQ, Tq);
    load_vec_async<S::THREADS>(dst_f + BQ, delta + (long long)bh * Tq, q0, BQ, Tq);
  };
  auto load_pe = [&](int idx) {     // the pe rows query tile idx pairs with
    const int q0 = (qt0 + idx) * BQ;
    load_tile_async<S::THREADS, T, D>(sPE, pe, D, m_lo_of(q0), n_band_of(q0), two_l);
  };
  // v's rows (the f32 form; either form at D = 128, with k's), the first
  // query tile and its pe rows: one group
  const T* vrows = v + b * st.b[IV] + h * st.h[IV];
  const T* krows = k + b * st.b[IK] + h * st.h[IK];
  if constexpr (F32 || STAGED) load_tile_async<S::THREADS, T, D>(sV, vrows, st.t[IV], k0, BK, Tk);
  if constexpr (STAGED) load_tile_async<S::THREADS, T, D>(sKr, krows, st.t[IK], k0, BK, Tk);
  if (n_items > 0) {
    load_tile(0);
    if (!MASK_ONLY) load_pe(0);
  }
  cp_async_commit();

  SplitRows<D> kf;               // k's fragments split once; v's read at each use
  Bf16Rows<D> ka, va;            // the bf16 form's: both in registers
  if constexpr (!STAGED) {
    if constexpr (F32) {
      load_rows<D>(kf, krows, st.t[IK], j0, j1, Tk, t);
    } else {
      ka.load(krows + j0 * st.t[IK], krows + j1 * st.t[IK], j0 < Tk, j1 < Tk, t);
      va.load(vrows + j0 * st.t[IV], vrows + j1 * st.t[IV], j0 < Tk, j1 < Tk, t);
    }
  }
  const SmemRows<D> vf{reinterpret_cast<const float*>(sV) + (16 * warp + g) * LDT + t};
  const SmemRows<D> ks{reinterpret_cast<const float*>(sKr) + (16 * warp + g) * LDT + t};
  const float c2 = scale * LOG2E;

  for (int idx = 0; idx < n_items; ++idx) {
    if (idx + 1 < n_items) {     // the next tile's copy overlaps this one's products
      load_tile(idx + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sQ = reinterpret_cast<const T*>(stages + (idx & 1) * M::STAGE);
    const T* sG = sQ + BQ * LDT;
    const float* sL = reinterpret_cast<const float*>(sG + BQ * LDT);
    const float* sD = sL + BQ;
    const int q0 = (qt0 + idx) * BQ;

    int m_lo = 0;
    if (!MASK_ONLY) {
      // band[c][i] = c2 * pe[m_lo + c] . q_i: pe rows as A, the q tile as B
      m_lo = m_lo_of(q0);
      const int jobs = n_band_of(q0) / 16 * NQ;
      for (int job = warp; job < jobs; job += S::WARPS) {
        const int mt = job / NQ, nb = job % NQ;
        float c[1][4] = {{0.f, 0.f, 0.f, 0.f}};
        if constexpr (F32) {
          const SmemRows<D> pf{reinterpret_cast<const float*>(sPE) + (16 * mt + g) * LDT + t};
          mma_rows_bt<1, D>(c, pf, sQ + 8 * nb * LDT, g, t);
        } else {
          Bf16Rows<D> pf;
          pf.template load_smem<LDT>(sPE + (16 * mt + g) * LDT, t);
          pf.template mma_bt<1, LDT>(c, sQ + 8 * nb * LDT, g, t);
        }
        float* o = band + (16 * mt + g) * BLD + 8 * nb + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(c[0][0] * c2, c[0][1] * c2);
        *reinterpret_cast<float2*>(o + 8 * BLD) = make_float2(c[0][2] * c2, c[0][3] * c2);
      }
      __syncthreads();           // the band is complete and the pe rows are free
      if (idx + 1 < n_items) {
        load_pe(idx + 1);
        cp_async_commit();
      }
    }

    // s^T = k.q^T and dp^T = v.g^T: rows are keys, block n holds queries
    // 8n + {2t, 2t + 1}
    float s[NQ][4], dp[NQ][4];
    zero_acc(s);
    zero_acc(dp);
    if constexpr (F32) {
      if constexpr (STAGED)
        mma_rows_bt<NQ, D>(s, ks, sQ, g, t);
      else
        mma_rows_bt<NQ, D>(s, kf, sQ, g, t);
      mma_rows_bt<NQ, D>(dp, vf, sG, g, t);
    } else if constexpr (STAGED) {   // k's and v's fragments from shared memory
      Bf16Rows<D> a;
      a.template load_smem<LDT>(sKr + (16 * warp + g) * LDT, t);
      a.template mma_bt<NQ, LDT>(s, sQ, g, t);
      a.template load_smem<LDT>(sV + (16 * warp + g) * LDT, t);
      a.template mma_bt<NQ, LDT>(dp, sG, g, t);
    } else {
      ka.template mma_bt<NQ, LDT>(s, sQ, g, t);
      va.template mma_bt<NQ, LDT>(dp, sG, g, t);
    }
    const bool all_valid = q0 + BQ <= Tq && k0 + BK <= vl && !(causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e < 2 ? j0 : j1;
        const int il = 8 * n + 2 * t + (e & 1);
        const int i = q0 + il;
        float x = s[n][e] * c2;
        if (!MASK_ONLY) x += band[(clip(i - j, L) + L - m_lo) * BLD + il];
        const bool masked = !all_valid && (i >= Tq || j >= vl || (causal && j > i));
        const float p = masked ? 0.f : fast_exp2(x - sL[il] * LOG2E);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sD[il]);
      }
    // dv += p^T.g and dk += ds^T.q, each through a zeroed partial sum added
    // in f32 (NN column blocks at a time): the mma's own accumulation
    // truncates, so a running sum carried through every query tile's mma
    // drifts
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      float part[NN][4];
      zero_acc(part);
      if constexpr (F32)
        mma_p_b<NQ, D, NN>(part, s, sG, g, t, c * NN);
      else
        mma_p_b_bf16<NQ, D, LDT, NN>(part, s, sG, g, t, c * NN);   // bf16(p)^T.g
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dva[c * NN + n][e] += part[n][e];
      zero_acc(part);
      if constexpr (F32)
        mma_p_b<NQ, D, NN>(part, dp, sQ, g, t, c * NN);
      else
        mma_p_b_bf16<NQ, D, LDT, NN>(part, dp, sQ, g, t, c * NN);  // bf16(ds)^T.q
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[c * NN + n][e] += part[n][e];
    }
    __syncthreads();   // this stage and the band are refilled
  }

  store_rows<D>(dkb, st.t[IDK], dka, scale, j0, j1, Tk, t);
  store_rows<D>(dvb, st.t[IDV], dva, 1.f, j0, j1, Tk, t);
}

// ---- launch --------------------------------------------------------------

template <typename T, bool MASK_ONLY, int D>
cudaError_t allow_smem_dq() {
  static std::atomic<unsigned long long> done{0};
  return allow_smem_once(flash_rel_bwd_dq_kernel<T, MASK_ONLY, D>, 0, done);
}

template <typename T, bool MASK_ONLY, int D>
cudaError_t allow_smem_dkv() {
  static std::atomic<unsigned long long> done{0};
  return allow_smem_once(flash_rel_bwd_dkv_kernel<T, MASK_ONLY, D>, 0, done);
}

template <typename T, bool MASK_ONLY, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pe,
                   const int* valid_len, const float* lse, const float* delta,
                   const void* dout, float* dq, float* dqpe, float* dk, float* dv,
                   const Strides& st, int B, int H, int Tq, int Tk, int two_l, int causal,
                   float scale, cudaStream_t stream) {
  using SQ = DqS;
  cudaError_t e = allow_smem_dq<T, MASK_ONLY, D>();
  if (e != cudaSuccess) return e;
  e = allow_smem_dkv<T, MASK_ONLY, D>();
  if (e != cudaSuccess) return e;
  const T *qt = (const T*)q, *kt = (const T*)k, *vt = (const T*)v, *pt = (const T*)pe,
          *gt = (const T*)dout;
  flash_rel_bwd_dq_kernel<T, MASK_ONLY, D>
      <<<dim3(B * H, (Tq + SQ::BQ - 1) / SQ::BQ), SQ::THREADS,
         dq_smem_bytes<T, MASK_ONLY, D>(two_l), stream>>>(qt, kt, vt, pt, valid_len, lse,
                                                          delta, gt, dq, dqpe, st, H, Tq, Tk,
                                                          two_l, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_rel_bwd_dkv_kernel<T, MASK_ONLY, D>
      <<<dim3(B * H, (Tk + DkvS::BK - 1) / DkvS::BK), DkvS::THREADS,
         dkv_smem_bytes<T, MASK_ONLY, D>(), stream>>>(qt, kt, vt, pt, valid_len, lse, delta,
                                                      gt, dk, dv, st, H, Tq, Tk, two_l,
                                                      causal, scale);
  return cudaGetLastError();
}

template <typename T, bool MASK_ONLY, int D>
int blocks_per_sm(int two_l, int kernel) {
  int blocks = -1;
  cudaError_t e;
  if (kernel == 0) {
    e = allow_smem_dq<T, MASK_ONLY, D>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_rel_bwd_dq_kernel<T, MASK_ONLY, D>, DqS::THREADS,
          dq_smem_bytes<T, MASK_ONLY, D>(two_l));
  } else {
    e = allow_smem_dkv<T, MASK_ONLY, D>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_rel_bwd_dkv_kernel<T, MASK_ONLY, D>, DkvS::THREADS,
          dkv_smem_bytes<T, MASK_ONLY, D>());
  }
  return e == cudaSuccess ? blocks : -1;
}

// f(type tag T*, std::bool_constant<mask_only>, std::integral_constant<int, d>)
// for the instantiated forms, else ``fallback`` (a head dim the kernels do
// not take); csrc/flash_rel.cu's dispatch
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

}  // namespace

// Dynamic shared memory of a launch of B3 (kernel 0) or B4 (kernel 1), 0
// for a head dim not instantiated.
extern "C" size_t loco_flash_rel_bwd_smem_bytes(int two_l, int mask_only, int kernel, int d,
                                                int bf16_operands) {
  return with_form(bf16_operands, mask_only, d, (size_t)0, [&](auto tag, auto mo, auto dd) {
    return kernel == 0 ? dq_smem_bytes<FORM>(two_l) : dkv_smem_bytes<FORM>();
  });
}

// Blocks of B3 (kernel 0) or B4 (kernel 1) that fit on one SM of the
// current device at this table size (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -1.
extern "C" int loco_flash_rel_bwd_blocks_per_sm(int two_l, int mask_only, int kernel, int d,
                                                int bf16_operands) {
  return with_form(bf16_operands, mask_only, d, -1, [&](auto tag, auto mo, auto dd) {
    return blocks_per_sm<FORM>(two_l, kernel);
  });
}

// q/g [.., Tq, D], k/v [.., Tk, D] (float32, or bfloat16 when
// bf16_operands is nonzero) and the float32 outputs dq [.., Tq, D],
// dk/dv [.., Tk, D] (head dim contiguous, 16-byte aligned rows),
// addressed through strides[21] = (batch, head, time) element strides of
// q, k, v, g, dq, dk, dv in that order; pe [two_l, D] contiguous, of q's
// type (not read when mask_only), valid_len [B] int32, lse/delta [B,H,Tq]
// float32 contiguous -> dq_content, dk, dv and, unless mask_only, dqpe
// [B,H,Tq,two_l] float32 contiguous (every cell written).  D in {8, 16,
// 32, 64, 128}.  Launches B3 then B4 on ``stream``.
extern "C" int loco_flash_rel_bwd(const void* q, const void* k, const void* v,
                                  const void* pe, const void* valid_len, const void* lse,
                                  const void* delta, const void* g, void* dq, void* dqpe,
                                  void* dk, void* dv, const long long* strides, int B,
                                  int H, int Tq, int Tk, int D, int two_l, int causal,
                                  int mask_only, float scale, int bf16_operands,
                                  void* stream) {
  Strides st;
  for (int o = 0; o < N_OPERANDS; ++o)
    st.b[o] = strides[3 * o], st.h[o] = strides[3 * o + 1], st.t[o] = strides[3 * o + 2];
  return (int)with_form(bf16_operands, mask_only, D, cudaErrorInvalidValue,
                        [&](auto tag, auto mo, auto dd) {
                          return launch<FORM>(q, k, v, pe, (const int*)valid_len,
                                              (const float*)lse, (const float*)delta, g,
                                              (float*)dq, (float*)dqpe, (float*)dk,
                                              (float*)dv, st, B, H, Tq, Tk, two_l, causal,
                                              scale, (cudaStream_t)stream);
                        });
}
