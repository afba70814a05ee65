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
// a contiguous head dim of 64, so split_heads' transposed views are read in
// place and the gradients land in [B, T, H, 64] buffers; pe, lse, delta and
// dqpe are contiguous.
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
//   keep two blocks an SM at L = 160.
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
// Shapes, registers and blocks an SM are in PERF.md §6; wgmma and TMA are
// later work.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

constexpr int D = 64;          // head dim
constexpr int KD = D / 8;      // k-steps over the head dim, column blocks of dq/dk/dv
constexpr int LD = D + 4;      // shared row stride of q, g, k, v and pe tiles
constexpr float LOG2E = 1.4426950408889634f;

enum Operand { IQ, IK, IV, IG, IDQ, IDK, IDV, N_OPERANDS };
struct Strides {               // element strides of (batch, head, time)
  long long b[N_OPERANDS], h[N_OPERANDS], t[N_OPERANDS];
};

// 16 rows x 64 of an A operand in registers, split (big, small) once
struct SplitRows {
  unsigned big[KD][4], small[KD][4];
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
struct RawRows {
  float x[KD][4];
  __device__ __forceinline__ void set(int kk, int e, float v) { x[kk][e] = v; }
  __device__ __forceinline__ void get(int kk, unsigned (&b)[4], unsigned (&s)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[kk][e], b[e], s[e]);
  }
  __device__ __forceinline__ void keep_raw() {   // emits no instruction
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[kk][e]));
  }
};

// rows r0, r1 = r0 + 8 (zero at or past n) of a strided [n, 64] matrix as
// this lane's A fragments: (r, 8kk + t) and (r, 8kk + t + 4)
template <class Rows>
__device__ __forceinline__ void load_rows(Rows& f, const float* __restrict__ base,
                                          long long ts, int r0, int r1, int n, int t) {
  const float* p0 = base + r0 * ts;
  const float* p1 = base + r1 * ts;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = 8 * kk + t;
    f.set(kk, 0, r0 < n ? p0[c] : 0.f);
    f.set(kk, 1, r1 < n ? p1[c] : 0.f);
    f.set(kk, 2, r0 < n ? p0[c + 4] : 0.f);
    f.set(kk, 3, r1 < n ? p1[c + 4] : 0.f);
  }
}

// c[n] += a . B^T: a the warp's 16 rows (registers), B the rows 8n + g of a
// shared [*, LD] tile; block n of c holds columns 8n + {2t, 2t + 1}
template <int NB, class Rows>
__device__ __forceinline__ void mma_rows_bt(float (&c)[NB][4], const Rows& a,
                                            const float* sB, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
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
// the first 8 NB rows of a shared [*, LD] tile; each 8-column step of P is
// read in the order (2t, 2t + 1), B's rows likewise, so P needs no shuffle
template <int NB>
__device__ __forceinline__ void mma_p_b(float (&acc)[KD][4], const float (&p)[NB][4],
                                        const float* sB, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    unsigned abig[4], asmall[4];
    split_tf32(p[kk][0], abig[0], asmall[0]);
    split_tf32(p[kk][2], abig[1], asmall[1]);
    split_tf32(p[kk][1], abig[2], asmall[2]);
    split_tf32(p[kk][3], abig[3], asmall[3]);
    const float* br = sB + (8 * kk + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      unsigned bbig[2], bsmall[2];
      split_tf32(br[8 * n], bbig[0], bsmall[0]);
      split_tf32(br[LD + 8 * n], bbig[1], bsmall[1]);
      mma_3xtf32(acc[n], abig, asmall, bbig, bsmall);
    }
  }
}

// rows [row0, row0 + rows) of a strided [n, 64] matrix -> smem [rows][LD],
// asynchronously; rows >= n are zero
template <int THREADS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* __restrict__ src,
                                                long long row_stride, int row0, int rows,
                                                int n) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < rows * C4; i += THREADS) {
    const int r = i / C4, c4 = i % C4;
    const bool valid = row0 + r < n;
    const float* s = valid ? src + (row0 + r) * row_stride + c4 * 4 : src;
    cp_async16(dst + r * LD + c4 * 4, s, valid);
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

// (rows r0, r1) x 64 of C-layout accumulators, times mul, to a strided row
// block; rows >= n are not stored
__device__ __forceinline__ void store_rows(float* base, long long ts, const float (&acc)[KD][4],
                                           float mul, int r0, int r1, int n, int t) {
  const int rows[2] = {r0, r1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= n) continue;
    float* o = base + rows[r] * ts + 2 * t;
#pragma unroll
    for (int c = 0; c < KD; ++c)
      *reinterpret_cast<float2*>(o + 8 * c) =
          make_float2(acc[c][2 * r] * mul, acc[c][2 * r + 1] * mul);
  }
}

__device__ __forceinline__ void zero_acc(float (&a)[KD][4]) {
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

__device__ __forceinline__ void add_acc(float (&acc)[KD][4], const float (&part)[KD][4]) {
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
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

template <bool MASK_ONLY>
__host__ size_t dq_smem_bytes(int two_l) {   // two K / pe buffers, V, [the table]
  return (size_t)(3 * DqS::BK * LD + (MASK_ONLY ? 0 : two_l * DqS::TS)) * sizeof(float);
}

template <bool MASK_ONLY>
__global__ void __launch_bounds__(DqS::THREADS, 2)
flash_rel_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ pe,
                        const int* __restrict__ valid_len, const float* __restrict__ lse,
                        const float* __restrict__ delta, const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ dqpe, Strides st,
                        int H, int Tq, int Tk, int two_l, int causal, float scale) {
  using S = DqS;
  constexpr int BQ = S::BQ, BK = S::BK, TS = S::TS;
  constexpr int NB = BK / 8;     // key blocks of a tile
  // [2][BK][LD] pe or K tiles, V [BK][LD], then the table [2L][TS]
  extern __shared__ __align__(16) float smem[];
  float* sV = smem + 2 * BK * LD;
  float* tab = sV + BK * LD;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;                       // row in the block
  const int r0 = q0 + rl, r1 = r0 + 8;                // this thread's rows
  const int L = two_l / 2;
  const float* kb = k + b * st.b[IK] + h * st.h[IK];
  const float* vb = v + b * st.b[IV] + h * st.h[IV];
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
    float* dst = smem + (idx & 1) * BK * LD;
    if (idx < npe)
      load_tile_async<S::THREADS>(dst, pe, D, (pe0 + idx) * BK, BK, two_l);
    else
      load_tile_async<S::THREADS>(dst, kb, st.t[IK], (idx - npe) * BK, BK, Tk);
  };
  auto load_v = [&](int idx) {
    load_tile_async<S::THREADS>(sV, vb, st.t[IV], (idx - npe) * BK, BK, Tk);
  };
  if (n_items > 0) {
    load_first(0);
    if (npe == 0) load_v(0);
    cp_async_commit();
  }

  SplitRows qf;
  RawRows gf;   // split at each use: registers left to schedule with
  load_rows(qf, q + b * st.b[IQ] + h * st.h[IQ], st.t[IQ], r0, r1, Tq, t);
  load_rows(gf, dout + b * st.b[IG] + h * st.h[IG], st.t[IG], r0, r1, Tq, t);
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

  float acc[KD][4];
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
    const float* sK = smem + (idx & 1) * BK * LD;
    gf.keep_raw();

    // s = q.B^T with B the item's first tile (pe rows or keys)
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma_rows_bt<NB>(s, qf, sK, g, t);

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
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
    mma_rows_bt<NB>(dp, gf, sV, g, t);
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

    mma_p_b<NB>(acc, s, sK, g, t);   // dq += ds.k
    __syncthreads();   // this buffer is refilled
  }

  store_rows(dq + b * st.b[IDQ] + h * st.h[IDQ], st.t[IDQ], acc, scale, r0, r1, Tq, t);
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

// 16 rows x 64 of an A operand read from a shared [*, LD] tile and split
// at each use; p points at the lane's (row g, column t)
struct SmemRows {
  const float* p;
  __device__ __forceinline__ void get(int kk, unsigned (&b)[4], unsigned (&s)[4]) const {
    split_tf32(p[8 * kk], b[0], s[0]);
    split_tf32(p[8 * LD + 8 * kk], b[1], s[1]);
    split_tf32(p[8 * kk + 4], b[2], s[2]);
    split_tf32(p[8 * LD + 8 * kk + 4], b[3], s[3]);
  }
};

template <int WARPS_, int BQ_>
struct DkvShape {
  static constexpr int WARPS = WARPS_, BQ = BQ_;   // BQ: query rows a tile
  static constexpr int BK = 16 * WARPS;            // keys per block
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NPE = (BQ + BK - 1 + 15) / 16 * 16;   // pe rows a tile pair
  static constexpr int BLD = BQ + 8;                // band stride, = 8 mod 32
  static constexpr int STAGE = 2 * BQ * LD + 2 * BQ;   // q, g, lse, delta
};
using DkvS = DkvShape<4, 32>;

template <bool MASK_ONLY>
__host__ size_t dkv_smem_bytes() {   // v, two stages, [pe rows, band]
  using S = DkvS;
  return (size_t)(S::BK * LD + 2 * S::STAGE + (MASK_ONLY ? 0 : S::NPE * (LD + S::BLD))) *
         sizeof(float);
}

template <bool MASK_ONLY>
__global__ void __launch_bounds__(DkvS::THREADS, 2)
flash_rel_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ pe,
                         const int* __restrict__ valid_len, const float* __restrict__ lse,
                         const float* __restrict__ delta, const float* __restrict__ dout,
                         float* __restrict__ dk, float* __restrict__ dv, Strides st,
                         int H, int Tq, int Tk, int two_l, int causal, float scale) {
  using S = DkvS;
  constexpr int BQ = S::BQ, BK = S::BK, BLD = S::BLD, STAGE = S::STAGE;
  constexpr int NQ = BQ / 8;     // query blocks of a tile
  // v [BK][LD], [2][q, g, lse, delta], then pe rows [NPE][LD], band [NPE][BLD]
  extern __shared__ __align__(16) float smem[];
  float* sV = smem;
  float* stages = sV + BK * LD;
  float* sPE = stages + 2 * STAGE;
  float* band = sPE + S::NPE * LD;

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
    store_rows(dkb, st.t[IDK], dka, 1.f, j0, j1, Tk, t);
    store_rows(dvb, st.t[IDV], dva, 1.f, j0, j1, Tk, t);
    return;
  }

  const float* qb = q + b * st.b[IQ] + h * st.h[IQ];
  const float* gb = dout + b * st.b[IG] + h * st.h[IG];
  const int qt0 = causal ? k0 / BQ : 0;   // earlier query tiles are above the diagonal
  const int n_items = (Tq + BQ - 1) / BQ - qt0;
  auto m_lo_of = [&](int q0) { return clip(q0 - (k0 + BK - 1), L) + L; };
  auto n_band_of = [&](int q0) {   // pe rows of the tile pair, rounded up to 16
    return (clip(q0 + BQ - 1 - k0, L) + L - m_lo_of(q0) + 16) / 16 * 16;
  };
  auto load_tile = [&](int idx) {   // query tile idx -> stage idx & 1
    float* dst = stages + (idx & 1) * STAGE;
    const int q0 = (qt0 + idx) * BQ;
    load_tile_async<S::THREADS>(dst, qb, st.t[IQ], q0, BQ, Tq);
    load_tile_async<S::THREADS>(dst + BQ * LD, gb, st.t[IG], q0, BQ, Tq);
    load_vec_async<S::THREADS>(dst + 2 * BQ * LD, lse + (long long)bh * Tq, q0, BQ, Tq);
    load_vec_async<S::THREADS>(dst + 2 * BQ * LD + BQ, delta + (long long)bh * Tq, q0, BQ,
                               Tq);
  };
  auto load_pe = [&](int idx) {     // the pe rows query tile idx pairs with
    const int q0 = (qt0 + idx) * BQ;
    load_tile_async<S::THREADS>(sPE, pe, D, m_lo_of(q0), n_band_of(q0), two_l);
  };
  // v's rows, the first query tile and its pe rows: one group
  load_tile_async<S::THREADS>(sV, v + b * st.b[IV] + h * st.h[IV], st.t[IV], k0, BK, Tk);
  if (n_items > 0) {
    load_tile(0);
    if (!MASK_ONLY) load_pe(0);
  }
  cp_async_commit();

  SplitRows kf;                  // k's fragments split once; v's read at each use
  load_rows(kf, k + b * st.b[IK] + h * st.h[IK], st.t[IK], j0, j1, Tk, t);
  const SmemRows vf{sV + (16 * warp + g) * LD + t};
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
    const float* sQ = stages + (idx & 1) * STAGE;
    const float* sG = sQ + BQ * LD;
    const float* sL = sG + BQ * LD;
    const float* sD = sL + BQ;
    const int q0 = (qt0 + idx) * BQ;

    int m_lo = 0;
    if (!MASK_ONLY) {
      // band[c][i] = c2 * pe[m_lo + c] . q_i: pe rows as A, the q tile as B
      m_lo = m_lo_of(q0);
      const int jobs = n_band_of(q0) / 16 * NQ;
      for (int job = warp; job < jobs; job += S::WARPS) {
        const int mt = job / NQ, nb = job % NQ;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        const SmemRows pf{sPE + (16 * mt + g) * LD + t};
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const float* br = sQ + (8 * nb + g) * LD + 8 * kk + t;
          unsigned abig[4], asmall[4], bbig[2], bsmall[2];
          pf.get(kk, abig, asmall);
          split_tf32(br[0], bbig[0], bsmall[0]);
          split_tf32(br[4], bbig[1], bsmall[1]);
          mma_3xtf32(c, abig, asmall, bbig, bsmall);
        }
        float* o = band + (16 * mt + g) * BLD + 8 * nb + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(c[0] * c2, c[1] * c2);
        *reinterpret_cast<float2*>(o + 8 * BLD) = make_float2(c[2] * c2, c[3] * c2);
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
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_rows_bt<NQ>(s, kf, sQ, g, t);
    mma_rows_bt<NQ>(dp, vf, sG, g, t);
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
    // in f32: the mma's own accumulation truncates, so a running sum
    // carried through every query tile's mma drifts
    float part[KD][4];
    zero_acc(part);
    mma_p_b<NQ>(part, s, sG, g, t);
    add_acc(dva, part);
    zero_acc(part);
    mma_p_b<NQ>(part, dp, sQ, g, t);
    add_acc(dka, part);
    __syncthreads();   // this stage and the band are refilled
  }

  store_rows(dkb, st.t[IDK], dka, scale, j0, j1, Tk, t);
  store_rows(dvb, st.t[IDV], dva, 1.f, j0, j1, Tk, t);
}

// ---- launch --------------------------------------------------------------

template <bool MASK_ONLY>
cudaError_t allow_smem_dq() {
  static std::atomic<unsigned long long> done{0};
  return allow_smem_once(flash_rel_bwd_dq_kernel<MASK_ONLY>, 0, done);
}

template <bool MASK_ONLY>
cudaError_t allow_smem_dkv() {
  static std::atomic<unsigned long long> done{0};
  return allow_smem_once(flash_rel_bwd_dkv_kernel<MASK_ONLY>, 0, done);
}

template <bool MASK_ONLY>
cudaError_t launch(const float* q, const float* k, const float* v, const float* pe,
                   const int* valid_len, const float* lse, const float* delta,
                   const float* dout, float* dq, float* dqpe, float* dk, float* dv,
                   const Strides& st, int B, int H, int Tq, int Tk, int two_l, int causal,
                   float scale, cudaStream_t stream) {
  using SQ = DqS;
  cudaError_t e = allow_smem_dq<MASK_ONLY>();
  if (e != cudaSuccess) return e;
  e = allow_smem_dkv<MASK_ONLY>();
  if (e != cudaSuccess) return e;
  flash_rel_bwd_dq_kernel<MASK_ONLY>
      <<<dim3(B * H, (Tq + SQ::BQ - 1) / SQ::BQ), SQ::THREADS,
         dq_smem_bytes<MASK_ONLY>(two_l), stream>>>(q, k, v, pe, valid_len, lse, delta,
                                                    dout, dq, dqpe, st, H, Tq, Tk, two_l,
                                                    causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_rel_bwd_dkv_kernel<MASK_ONLY>
      <<<dim3(B * H, (Tk + DkvS::BK - 1) / DkvS::BK), DkvS::THREADS,
         dkv_smem_bytes<MASK_ONLY>(), stream>>>(q, k, v, pe, valid_len, lse, delta, dout,
                                                dk, dv, st, H, Tq, Tk, two_l, causal,
                                                scale);
  return cudaGetLastError();
}

template <bool MASK_ONLY>
int blocks_per_sm(int two_l, int kernel) {
  int blocks = -1;
  cudaError_t e;
  if (kernel == 0) {
    e = allow_smem_dq<MASK_ONLY>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_rel_bwd_dq_kernel<MASK_ONLY>, DqS::THREADS,
          dq_smem_bytes<MASK_ONLY>(two_l));
  } else {
    e = allow_smem_dkv<MASK_ONLY>();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, flash_rel_bwd_dkv_kernel<MASK_ONLY>, DkvS::THREADS,
          dkv_smem_bytes<MASK_ONLY>());
  }
  return e == cudaSuccess ? blocks : -1;
}

}  // namespace

// Dynamic shared memory of a launch of B3 (kernel 0) or B4 (kernel 1).
extern "C" size_t loco_flash_rel_bwd_smem_bytes(int two_l, int mask_only, int kernel) {
  if (kernel == 0) return mask_only ? dq_smem_bytes<true>(two_l) : dq_smem_bytes<false>(two_l);
  return mask_only ? dkv_smem_bytes<true>() : dkv_smem_bytes<false>();
}

// Blocks of B3 (kernel 0) or B4 (kernel 1) that fit on one SM of the
// current device at this table size (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -1.
extern "C" int loco_flash_rel_bwd_blocks_per_sm(int two_l, int mask_only, int kernel) {
  return mask_only ? blocks_per_sm<true>(two_l, kernel) : blocks_per_sm<false>(two_l, kernel);
}

// q/g [.., Tq, 64], k/v [.., Tk, 64] and the outputs dq [.., Tq, 64],
// dk/dv [.., Tk, 64] (float32, head dim contiguous, 16-byte aligned rows),
// addressed through strides[21] = (batch, head, time) element strides of
// q, k, v, g, dq, dk, dv in that order; pe [two_l, 64] contiguous (not read
// when mask_only), valid_len [B] int32, lse/delta [B,H,Tq] contiguous ->
// dq_content, dk, dv and, unless mask_only, dqpe [B,H,Tq,two_l] contiguous
// (every cell written).  Launches B3 then B4 on ``stream``.
extern "C" int loco_flash_rel_bwd(const void* q, const void* k, const void* v,
                                  const void* pe, const void* valid_len, const void* lse,
                                  const void* delta, const void* g, void* dq, void* dqpe,
                                  void* dk, void* dv, const long long* strides, int B,
                                  int H, int Tq, int Tk, int two_l, int causal,
                                  int mask_only, float scale, void* stream) {
  Strides st;
  for (int o = 0; o < N_OPERANDS; ++o)
    st.b[o] = strides[3 * o], st.h[o] = strides[3 * o + 1], st.t[o] = strides[3 * o + 2];
  const auto go = mask_only ? &launch<true> : &launch<false>;
  return (int)go((const float*)q, (const float*)k, (const float*)v, (const float*)pe,
                 (const int*)valid_len, (const float*)lse, (const float*)delta,
                 (const float*)g, (float*)dq, (float*)dqpe, (float*)dk, (float*)dv, st, B,
                 H, Tq, Tk, two_l, causal, scale, (cudaStream_t)stream);
}
