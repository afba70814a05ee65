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
// Shapes, registers and blocks an SM are in PERF.md §6.
//
// Two forms, picked by the caller (flash_causal.py's kernel_form, the C
// entry's form argument): form 0, the mma.sync kernels above, runs every
// f32 launch and bf16 at D = 8, 16 and 32; form 1, the wgmma kernels
// below, runs bf16 at D = 64 and 128 (a launch in the other pairing
// returns cudaErrorNotSupported).  Both compute the JAX kernels' bf16
// path: q, k, v, g and pe in bf16, every product on bf16 operands with f32
// accumulation (form 0: one m16n8k16 mma.sync a product, bf16_mma.cuh, one
// m16n8k8 step over the head dim at D = 8), ds rounded to bf16 before ds.k
// (B3) and p and ds before p^T.g and ds^T.q (B4), as the JAX kernels'
// astype does; lse, delta, p, ds, the band table, dqpe and the dq, dk, dv
// sums stay f32, and the outputs leave the kernels in f32 (the wrapper
// casts them, as _flash_rel_backward_pallas does).  Form 0's bf16 B4 keeps
// both k's and v's fragments in registers up to D = 64 (packed pairs take
// a quarter of a split f32 fragment's registers), so it stages no v there.
//
// Form 1, for Hopper (hopper.cuh's mbarriers, TMA and wgmma).  What bounds
// it: bytes (dqpe alone is 61 MB of B3's ~100 MB at the encoder's shape),
// but neither bound is near: a tile's products take a few hundred cycles
// of an SM's tensor cores, its elementwise work and shared-memory round
// trips (B4's band) over a thousand, in a chain a warpgroup waits through.
//  - B3: a block of 384 threads per (b*h, 64 query rows).  A producer
//    warpgroup's thread issues every TMA copy (Q and dO once; by 64-key
//    tile K, V and the tile's band window, hopper.cuh's 128 pe rows from
//    the first its pairs reach, into a ring of 128-byte-swizzled stages,
//    an mbarrier each way a stage); the two consumer warpgroups share Q and
//    dO and take the key tiles in turn, each with its own f32 window, so
//    each runs its own chain and they need not wait for each other.  A
//    tile: the window's product (ss, m64n128; none for a tile wholly past a
//    clip edge, whose rows take the edge columns computed once a block),
//    c2-scaled into shared memory, then s = q.k^T and dp = g.v^T (ss, all
//    operands K-major), p and ds in registers with the window's interior
//    cells overwritten in place (form 0's rule; the band's path and the
//    masks are decided once a tile, so the 32 elements of a thread are one
//    basic block), dq += bf16(ds).k (rs: ds as the register A operand, K
//    read MN-major from the same stage), and the tile's dqpe cells written
//    from the window while that product runs.  At the end warpgroup 1's dq
//    passes through shared memory to warpgroup 0, the clip columns' sums
//    likewise, and the cells no processed pair reached get 0: every cell is
//    written.  Registers 168 a thread (the launch share; ptxas budgets the
//    consumers to it); shared memory the same at every L: 218,184 bytes at
//    D = 64, 231,464 at D = 128 (its window at the tight stride).
//  - B4: a block per (b*h, 64 keys), K and V loaded once; at D = 64 two
//    consumer warpgroups take the 64-query tiles in turn (each its own dk,
//    dv, summed through shared memory at the end), at D = 128 one (dk and
//    dv take 128 accumulator registers a thread, of 255 at 256 threads).
//    A ring stage holds a tile's Q, dO, the 128 pe rows its band reaches
//    and its lse and delta (staged by the producer's second warp).  A
//    tile: band = q.pe^T (ss, m64n128) c2-scaled through shared memory to
//    the lanes that hold s^T, then s^T = k.q^T and dp^T = v.g^T (ss), p^T
//    and ds^T in registers, dv += bf16(p^T).g and dk += bf16(ds^T).q (rs,
//    dO and Q read MN-major from the tiles the ss products read K-major).
//    The band's accumulators and s^T's, dp^T's are live in turn: together
//    beside dk and dv they spill at 168 registers.
//  - dq, dk and dv accumulate in place in the wgmma accumulators (form 0's
//    f32 partial sums guard its mma.sync chain; here the bf16 rounding of p
//    and ds dominates the error: PERF.md, phase 16's float64 check).
//  - Each ring's stage count is a multiple of its consumer warpgroups, so a
//    stage serves one warpgroup: a stage shared by two could be waited for
//    two phases ahead, which an mbarrier's parity does not tell apart.
//  - Rows past Tq and keys past Tk are TMA's zero fill (masked, or of zero
//    gradient), so ragged T needs no padding.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "hopper.cuh"
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
        const float p = masked ? 0.f : ex2(x - lse2[r]);
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
        const float p = masked ? 0.f : ex2(x - sL[il] * LOG2E);
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

// ---- the bf16 wgmma form (form 1) at D = 64 and 128 -----------------------

namespace wg {

constexpr int BQ = 64;            // B3: query rows a block; B4: queries a tile
constexpr int BK = 64;            // B3: keys a tile; B4: keys a block
constexpr int HALF = 64 * 128;    // bytes of one 64-column half of a 64-row tile
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BLD = BAND_ROWS + 4;   // B4's band stride: its lookups conflict-free
constexpr int DQ_W = 2;           // B3's consumer warpgroups

// B3's stages: a multiple of its consumer warpgroups, so that each stage
// serves one warpgroup (item idx, stage idx % S, warpgroup idx % 2); a
// stage shared by both could be waited for two phases ahead, which its
// parity does not tell apart.  Two at D = 128, where a stage (K, V and the
// band's window) takes 64 KB.
template <int D>
__host__ __device__ constexpr int dq_stages() { return D == 64 ? 4 : 2; }
template <int D>
__host__ __device__ constexpr int dkv_w() { return D == 64 ? 2 : 1; }   // B4's consumers
template <int D>
__host__ __device__ constexpr int dkv_stages() { return D == 64 ? 4 : 2; }
template <int D>
__host__ __device__ constexpr int dkv_threads() { return 128 * (dkv_w<D>() + 1); }

// B3: Q and dO of the block's rows, a ring of (K, V, the band's window)
// by key tile, each consumer warpgroup's f32 window [BQ][LD] (hopper.cuh;
// at D = 128 the tight stride, for room): the same at every L
template <bool MASK_ONLY, int D>
struct DqSmem {
  static constexpr int H2 = D / 64, S = dq_stages<D>(), LD = D == 64 ? BAND_LD : BAND_LD_TIGHT;
  static_assert(S % DQ_W == 0, "a stage serves one warpgroup");
  bf16 q[H2][BQ][64];
  bf16 g[H2][BQ][64];
  bf16 k[S][H2][BK][64];
  bf16 v[S][H2][BK][64];
  bf16 pe[MASK_ONLY ? 1 : S][H2][MASK_ONLY ? 8 : BAND_ROWS][64];
  float band[MASK_ONLY ? 1 : DQ_W][MASK_ONLY ? 1 : BQ][MASK_ONLY ? 2 : LD];
  uint64_t qg_full, full[S], empty[S];
};

// B4: K and V of the block's keys, rings of (Q, dO, pe rows, lse, delta)
// by query tile, each consumer warpgroup's band [BQ][BLD] f32
template <bool MASK_ONLY, int D>
struct DkvSmem {
  static constexpr int H2 = D / 64, S = dkv_stages<D>(), W = dkv_w<D>();
  static_assert(S % W == 0, "a stage serves one warpgroup (B3's rule)");
  bf16 k[H2][BK][64];
  bf16 v[H2][BK][64];
  bf16 q[S][H2][BQ][64];
  bf16 g[S][H2][BQ][64];
  bf16 pe[MASK_ONLY ? 1 : S][H2][MASK_ONLY ? 8 : BAND_ROWS][64];
  float lse[S][BQ], delta[S][BQ];
  float band[MASK_ONLY ? 1 : W][MASK_ONLY ? 1 : BQ][MASK_ONLY ? 4 : BLD];
  uint64_t kv_full, full[S], empty[S];
};

// B3's key tiles at query row q0: those below valid_len and, causal, none
// wholly above the block's last row (none when valid_len is 0)
__host__ __device__ inline int dq_key_tiles(int q0, int vl, int causal) {
  const int nk = (vl + BK - 1) / BK;
  return causal ? imin(nk, (q0 + BQ - 1) / BK + 1) : nk;
}

// B4's block at key k0: its first query tile (the diagonal's under causal)
// and its query tiles (none when every key is at or past valid_len)
struct DkvTiles {
  int qt0, n;
};

__host__ __device__ inline DkvTiles dkv_tiles(int k0, int vl, int Tq, int causal) {
  const int qt0 = causal ? k0 / BQ : 0;
  return {qt0, k0 >= vl ? 0 : imax(0, (Tq + BQ - 1) / BQ - qt0)};
}

}  // namespace wg

// B3, form 1: dq and dqpe as form 0 computes them.  A block of 384
// threads per (b*h, 64 query rows): two consumer warpgroups take the
// block's key tiles in turn (item idx to warpgroup idx % 2) and share Q and
// dO; warpgroup 2 is the producer.
template <bool MASK_ONLY, int D>
__global__ void __launch_bounds__(384, 1)
flash_rel_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              const __grid_constant__ CUtensorMap mg,
                              const __grid_constant__ CUtensorMap mpe,
                              const bf16* __restrict__ pe, const int* __restrict__ valid_len,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, long long dq_b, long long dq_h,
                              long long dq_t, float* __restrict__ dqpe, int H, int Tq, int Tk,
                              int two_l, int causal, float scale) {
  using Sm = wg::DqSmem<MASK_ONLY, D>;
  constexpr int S = Sm::S, BQ = wg::BQ, BK = wg::BK, NB = BK / 8, LD = Sm::LD;
  constexpr int HALF = wg::HALF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int L = two_l / 2;
  const int vl = max(0, min(valid_len[b], Tk));
  const int nk = wg::dq_key_tiles(q0, vl, causal);
  const int w = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qg_full, 1);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], 128);   // the consuming warpgroup's threads release
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (w == 2) {   // the producer: one thread issues every copy
    setmaxnreg_dec<wg::PRODUCER_REGS>();
    if (threadIdx.x != 256 || nk == 0) return;
    prefetch_tensormap(&mq);
    prefetch_tensormap(&mk);
    prefetch_tensormap(&mv);
    prefetch_tensormap(&mg);
    if (!MASK_ONLY) prefetch_tensormap(&mpe);
    mbar_expect_tx(&sm.qg_full, sizeof(sm.q) + sizeof(sm.g));
    for (int hf = 0; hf < Sm::H2; ++hf) {
      tma_load_4d(&sm.q[hf][0][0], &mq, &sm.qg_full, 64 * hf, q0, h, b);
      tma_load_4d(&sm.g[hf][0][0], &mg, &sm.qg_full, 64 * hf, q0, h, b);
    }
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
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lse2[r] = row < Tq ? lse[(long long)bh * Tq + row] * LOG2E : 0.f;
    dlt[r] = row < Tq ? delta[(long long)bh * Tq + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float lo[2] = {0.f, 0.f}, hi[2] = {0.f, 0.f};             // ds of the clip columns
  float band_lo[2] = {0.f, 0.f}, band_hi[2] = {0.f, 0.f};   // the edge columns, c2-scaled
  float* band = &sm.band[MASK_ONLY ? 0 : w][0][0];
  if (nk > 0) {
    if constexpr (!MASK_ONLY) {
      BandEdges<D> edges;
      edges.load(pe, two_l, t);   // under the wait for Q and dO
      mbar_wait(&sm.qg_full, 0);
      edges.dot(band_lo, band_hi, &sm.q[0][0][0], HALF, c2, rl, t);
    } else {
      mbar_wait(&sm.qg_full, 0);
    }
  }

  // the key tiles: the band's window (hopper.cuh), s = q.k^T, dp = g.v^T,
  // p and ds in registers, the window's interior cells overwritten with ds
  // in place (form 0's rule), dq += bf16(ds).k with K read MN-major from
  // the same tile.  One loop body (B1 walks three runs of tiles instead):
  // the window's product is waited for at once, so a branch around it
  // costs nothing, and three inlined bodies spilled 52 / 184 bytes at
  // D = 64 / 128 and ran 7 / 16 % slower (PERF.md §6)
  for (int idx = w; idx < nk; idx += wg::DQ_W) {
    const int st = idx % S, k0 = idx * BK;
    const bool window = !MASK_ONLY && !band_clipped(q0, k0, L);
    mbar_wait(&sm.full[st], (idx / S) & 1);
    const int m_lo = MASK_ONLY ? 0 : band_first(q0, k0, L);
    if (window) {   // in turn with s and dp: their 64 registers and the band's would not fit
      float sb[BAND_ROWS / 2];
      wgmma_fence();
      band_product<D>(sb, &sm.q[0][0][0], HALF, &sm.pe[st][0][0][0]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sb);
      band_store<LD>(band, sb, c2, rl, t);
      __syncwarp();   // the warp's window rows are written
    }
    float s[BK / 2], dp[BK / 2];
    wgmma_fence();
    wgmma_ss_kmajor<D, BK>(s, &sm.q[0][0][0], HALF, &sm.k[st][0][0][0], HALF);
    wgmma_ss_kmajor<D, BK>(dp, &sm.g[0][0][0], HALF, &sm.v[st][0][0][0], HALF);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // i - j over this warp's rows and the tile's keys; the band's path and
    // the masks are decided once a tile, so that each element loop is one
    // basic block whose 32 elements the compiler interleaves
    const int d_min = q0 + 16 * wi - (k0 + BK - 1);
    const int d_max = q0 + 16 * wi + 15 - k0;
    const bool all_valid = k0 + BK <= vl && !(causal && k0 + BK - 1 > q0 + 16 * wi);
    auto ds_tile = [&](auto path, auto check) {
      // path 0: interior (no clip: each cell read, then overwritten, by its
      // lane); 1: one side (every pair in one clip column); 2: the general
      // rule.  check: the masks are tested
      constexpr int PATH = decltype(path)::value;
      constexpr bool CHECK = decltype(check)::value;
      const bool high = d_min >= L - 1;   // path 1's column: 2L - 1, else 0
      float* base = band + rl * LD + (r0 - k0 - 2 * t + L - m_lo);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int i = r ? r1 : r0;
          const int j = k0 + 8 * n + 2 * t + (e & 1);
          float x = s[4 * n + e] * c2;
          const int d = i - j;
          float* cell = nullptr;
          bool own = false;   // the pair's cell is interior: it takes ds
          if constexpr (!MASK_ONLY && PATH == 0) {   // column d + L - m_lo, row rl + 8r
            cell = base + 8 * r * LD + 8 * r - 8 * n - (e & 1);
            x += *cell;
          } else if constexpr (!MASK_ONLY && PATH == 1) {
            x += high ? band_hi[r] : band_lo[r];
          } else if constexpr (!MASK_ONLY) {
            const int col = clip(d, L) + L;
            cell = band + (rl + 8 * r) * LD + col - m_lo;
            x += *cell;
            own = col == d + L && col != 0 && col != two_l - 1;
          }
          const bool masked = CHECK && (j >= vl || (causal && j > i));
          const float p = masked ? 0.f : ex2(x - lse2[r]);
          const float ds = p * (dp[4 * n + e] - dlt[r]);
          s[4 * n + e] = ds;
          if constexpr (!MASK_ONLY && PATH == 0) {
            *cell = ds;
          } else if constexpr (!MASK_ONLY && PATH == 1) {
            hi[r] += high ? ds : 0.f;   // selects: an array picked at run time
            lo[r] += high ? 0.f : ds;   // would go to local memory
          } else if constexpr (!MASK_ONLY) {
            if (own) *cell = ds;
            lo[r] += !own && d <= -L ? ds : 0.f;
            hi[r] += !own && d > -L ? ds : 0.f;
          }
        }
    };
    auto by_path = [&](auto check) {
      if constexpr (MASK_ONLY) {
        ds_tile(std::integral_constant<int, 0>{}, check);
      } else {
        if (d_min > -L && d_max < L - 1) ds_tile(std::integral_constant<int, 0>{}, check);
        else if (d_min >= L - 1 || d_max <= -L) ds_tile(std::integral_constant<int, 1>{}, check);
        else ds_tile(std::integral_constant<int, 2>{}, check);
      }
    };
    if (all_valid) by_path(std::false_type{});
    else by_path(std::true_type{});
    uint32_t ds16[BK / 16][4];
    pack_bf16_a(ds16, s);   // ds rounded to bf16 (the JAX kernel's astype)
    wgmma_fence();
    wgmma_rs_mnmajor<D, BK / 16>(acc, ds16, &sm.k[st][0][0][0], HALF);
    wgmma_commit();
    if (!MASK_ONLY && window) {
      // the tile's dqpe cells, final now, while dq's product runs: row i's
      // columns i - k0 - 63 + L .. i - k0 + L (not the clip columns), 4 rows
      // at a time, 8 consecutive columns a row; a warp writes its own rows
      __syncwarp();   // the warp's cells are written
      const int sub = lane >> 3, mi = lane & 7;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int rr = 16 * wi + sub + 4 * k, i = q0 + rr;
        float* row = dqpe + ((long long)bh * Tq + i) * two_l;
        const int m0 = i - k0 - (BK - 1) + L;
#pragma unroll
        for (int c = mi; c < BK; c += 8) {
          const int m = m0 + c;
          if (i < Tq && m > 0 && m < two_l - 1) row[m] = band[rr * LD + m - m_lo];
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ds16);
    mbar_arrive(&sm.empty[st]);
  }

  float lo_sum[2], hi_sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lo_sum[r] = quad_sum(lo[r]), hi_sum[r] = quad_sum(hi[r]);
  named_barrier(1, 256);   // every item is done: the ring is free
  // warpgroup 1's dq, then both warpgroups' clip-column sums, through the ring
  constexpr int LDP = D + 8;   // f32 row stride of warpgroup 1's dq
  float* part = reinterpret_cast<float*>(&sm.k[0][0][0][0]);
  float* clip_sums = part + BQ * LDP;   // [warpgroup][lo, hi][BQ]
  static_assert((BQ * LDP + 2 * wg::DQ_W * BQ) * sizeof(float) <= sizeof(sm.k) + sizeof(sm.v),
                "dq's partial sums and the clip columns'");
  if (w == 1) store_acc<D>(part, LDP, acc, 1.f, rl, BQ, t);
  if (!MASK_ONLY && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      clip_sums[(2 * w) * BQ + rl + 8 * r] = lo_sum[r];
      clip_sums[(2 * w + 1) * BQ + rl + 8 * r] = hi_sum[r];
    }
  }
  named_barrier(1, 256);
  if (w == 0) {
    add_acc<D>(acc, part, LDP, rl, t);
    store_acc<D>(dq + b * dq_b + h * dq_h + q0 * dq_t, dq_t, acc, scale, rl, Tq - q0, t);
  }
  if (MASK_ONLY) return;

  // the rest of dqpe: 0 in each row's interior columns that no processed
  // pair (j < nk * BK) reaches, 4 rows at a time a warp, 8 columns a row;
  // the clip columns from both warpgroups' sums.  So every cell is written
  const int jproc = nk * BK;
  const int w8 = threadIdx.x / 32, sub = lane >> 3, mi = lane & 7;
  for (int rr = 8 * w8 + sub; rr < 8 * w8 + 8; rr += 4) {
    const int i = q0 + rr;
    if (i >= Tq) break;
    float* row = dqpe + ((long long)bh * Tq + i) * two_l;
    const int m_min = max(1, i + L - jproc + 1), m_max = min(two_l - 2, i + L);
    for (int m = 1 + mi; m < min(m_min, two_l - 1); m += 8) row[m] = 0.f;
    for (int m = max(m_max + 1, 1) + mi; m < two_l - 1; m += 8) row[m] = 0.f;
  }
  if (threadIdx.x < BQ && q0 + (int)threadIdx.x < Tq) {
    const int rr = threadIdx.x;
    float* row = dqpe + ((long long)bh * Tq + q0 + rr) * two_l;
    row[0] = clip_sums[rr] + clip_sums[2 * BQ + rr];
    row[two_l - 1] = clip_sums[BQ + rr] + clip_sums[3 * BQ + rr];
  }
}

// B4, form 1: dk and dv as form 0 computes them.  A block per (b*h, 64
// keys): at D = 64 two consumer warpgroups take its query tiles in turn
// (tile idx to warpgroup idx % 2), each with its own dk and dv, summed at
// the end; at D = 128 one (dk and dv alone take 128 registers a thread).
// The last warpgroup produces: one thread issues the copies, its second
// warp stages each tile's lse and delta.
template <bool MASK_ONLY, int D>
__global__ void __launch_bounds__(wg::dkv_threads<D>(), 1)
flash_rel_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const __grid_constant__ CUtensorMap mg,
                               const __grid_constant__ CUtensorMap mpe,
                               const int* __restrict__ valid_len, const float* __restrict__ lse,
                               const float* __restrict__ delta, float* __restrict__ dk,
                               long long dk_b, long long dk_h, long long dk_t,
                               float* __restrict__ dv, long long dv_b, long long dv_h,
                               long long dv_t, int H, int Tq, int Tk, int two_l, int causal,
                               float scale) {
  using Sm = wg::DkvSmem<MASK_ONLY, D>;
  constexpr int S = Sm::S, W = Sm::W, BQ = wg::BQ, BK = wg::BK, BLD = wg::BLD, NQ = BQ / 8;
  constexpr int HALF = wg::HALF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;
  const int L = two_l / 2;
  const int vl = max(0, min(valid_len[b], Tk));
  const wg::DkvTiles tl = wg::dkv_tiles(k0, vl, Tq, causal);
  const int w = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      mbar_init(&sm.full[i], 1 + 32);   // the copies' thread, the lse warp's lanes
      mbar_init(&sm.empty[i], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (w == W) {   // the producer warpgroup
    if constexpr (W == 2) setmaxnreg_dec<wg::PRODUCER_REGS>();
    const int pw = threadIdx.x / 32 - 4 * W, lane = threadIdx.x % 32;
    if (tl.n == 0 || pw > 1 || (pw == 0 && lane != 0)) return;
    if (pw == 0) {
      prefetch_tensormap(&mq);
      prefetch_tensormap(&mk);
      prefetch_tensormap(&mv);
      prefetch_tensormap(&mg);
      if (!MASK_ONLY) prefetch_tensormap(&mpe);
      mbar_expect_tx(&sm.kv_full, sizeof(sm.k) + sizeof(sm.v));
      for (int hf = 0; hf < Sm::H2; ++hf) {
        tma_load_4d(&sm.k[hf][0][0], &mk, &sm.kv_full, 64 * hf, k0, h, b);
        tma_load_4d(&sm.v[hf][0][0], &mv, &sm.kv_full, 64 * hf, k0, h, b);
      }
    }
    for (int idx = 0; idx < tl.n; ++idx) {
      const int st = idx % S, q0 = (tl.qt0 + idx) * BQ;
      if (idx >= S) mbar_wait(&sm.empty[st], ((idx / S) & 1) ^ 1);
      if (pw == 0) {
        mbar_expect_tx(&sm.full[st], sizeof(sm.q[st]) + sizeof(sm.g[st]) +
                                         (MASK_ONLY ? 0 : sizeof(sm.pe[st])));
        for (int hf = 0; hf < Sm::H2; ++hf) {
          tma_load_4d(&sm.q[st][hf][0][0], &mq, &sm.full[st], 64 * hf, q0, h, b);
          tma_load_4d(&sm.g[st][hf][0][0], &mg, &sm.full[st], 64 * hf, q0, h, b);
          if (!MASK_ONLY) {
            const int m_lo = band_first(q0, k0, L);
            for (int part = 0; part < BAND_ROWS / 64; ++part)
              tma_load_4d(&sm.pe[st][hf][64 * part][0], &mpe, &sm.full[st], 64 * hf,
                          m_lo + 64 * part, 0, 0);
          }
        }
      } else {   // the tile's lse and delta (rows >= Tq: 0, masked)
#pragma unroll
        for (int c = 0; c < BQ / 32; ++c) {
          const int i = q0 + lane + 32 * c;
          sm.lse[st][lane + 32 * c] = i < Tq ? lse[(long long)bh * Tq + i] : 0.f;
          sm.delta[st][lane + 32 * c] = i < Tq ? delta[(long long)bh * Tq + i] : 0.f;
        }
        mbar_arrive(&sm.full[st]);
      }
    }
    return;
  }

  if constexpr (W == 2) setmaxnreg_inc<wg::CONSUMER_REGS>();
  const int tid = threadIdx.x % 128, wi = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int kr = 16 * wi + g;          // keys kr and kr + 8 of the block's 64
  const int j0 = k0 + kr, j1 = j0 + 8;
  const float c2 = scale * LOG2E;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float* band = &sm.band[MASK_ONLY ? 0 : w][0][0];
  if (tl.n > 0) mbar_wait(&sm.kv_full, 0);

  for (int idx = w; idx < tl.n; idx += W) {
    const int st = idx % S, q0 = (tl.qt0 + idx) * BQ;
    mbar_wait(&sm.full[st], (idx / S) & 1);
    // band[i][c] = c2 * q_i . pe[m_lo + c] over the tile's queries, through
    // shared memory to the lanes that hold s^T; then s^T = k.q^T and
    // dp^T = v.g^T (rows are keys, columns the tile's queries).  The band's
    // 64 accumulator registers a thread and s^T's and dp^T's 64 are live in
    // turn: together, beside dk and dv, they would not fit the 168 a
    // consumer thread has
    const int m_lo = MASK_ONLY ? 0 : band_first(q0, k0, L);
    if constexpr (!MASK_ONLY) {
      float sb[BAND_ROWS / 2];
      wgmma_fence();
      band_product<D>(sb, &sm.q[st][0][0][0], HALF, &sm.pe[st][0][0][0]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sb);
      named_barrier(2 + w, 128);   // the last tile's band is read
#pragma unroll
      for (int j = 0; j < BAND_ROWS / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(band + (16 * wi + g + 8 * r) * BLD + 8 * j + 2 * t) =
              make_float2(sb[4 * j + 2 * r] * c2, sb[4 * j + 2 * r + 1] * c2);
      named_barrier(2 + w, 128);   // this tile's band is complete
    }
    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
    wgmma_ss_kmajor<D, BQ>(s, &sm.k[0][0][0], HALF, &sm.q[st][0][0][0], HALF);
    wgmma_ss_kmajor<D, BQ>(dp, &sm.v[0][0][0], HALF, &sm.g[st][0][0][0], HALF);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // the masks are decided once a tile, so each element loop is one basic
    // block (B3's rule)
    const bool all_valid = q0 + BQ <= Tq && k0 + BK <= vl && !(causal && k0 + BK - 1 > q0);
    const float* sl = sm.lse[st];
    const float* sd = sm.delta[st];
    auto p_ds_tile = [&](auto check) {   // check: the masks are tested
      constexpr bool CHECK = decltype(check)::value;
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? j0 : j1;
          const int il = 8 * n + 2 * t + (e & 1);
          const int i = q0 + il;
          float x = s[4 * n + e] * c2;
          if constexpr (!MASK_ONLY) x += band[il * BLD + clip(i - j, L) + L - m_lo];
          const bool masked = CHECK && (i >= Tq || j >= vl || (causal && j > i));
          const float p = masked ? 0.f : ex2(x - sl[il] * LOG2E);
          s[4 * n + e] = p;
          dp[4 * n + e] = p * (dp[4 * n + e] - sd[il]);
        }
    };
    if (all_valid)
      p_ds_tile(std::false_type{});
    else
      p_ds_tile(std::true_type{});
    // dv += bf16(p^T).g and dk += bf16(ds^T).q: the tile's dO and Q read
    // MN-major from the tiles the products above read K-major
    uint32_t p16[BQ / 16][4], ds16[BQ / 16][4];
    pack_bf16_a(p16, s);
    pack_bf16_a(ds16, dp);
    wgmma_fence();
    wgmma_rs_mnmajor<D, BQ / 16>(dva, p16, &sm.g[st][0][0][0], HALF);
    wgmma_rs_mnmajor<D, BQ / 16>(dka, ds16, &sm.q[st][0][0][0], HALF);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(p16);
    fence_regs(ds16);
    mbar_arrive(&sm.empty[st]);
  }

  float* dkb = dk + b * dk_b + h * dk_h + k0 * dk_t;
  float* dvb = dv + b * dv_b + h * dv_h + k0 * dv_t;
  if constexpr (W == 2) {   // warpgroup 1's sums through Q's ring
    constexpr int LDP = D + 8;
    float* part = reinterpret_cast<float*>(&sm.q[0][0][0][0]);
    static_assert(2 * BK * LDP * sizeof(float) <= sizeof(sm.q) + sizeof(sm.g), "dk/dv's sums");
    named_barrier(1, 256);   // every tile is done: the rings are free
    if (w == 1) {
      store_acc<D>(part, LDP, dka, 1.f, kr, BK, t);
      store_acc<D>(part + BK * LDP, LDP, dva, 1.f, kr, BK, t);
    }
    named_barrier(1, 256);
    if (w == 1) return;
    add_acc<D>(dka, part, LDP, kr, t);
    add_acc<D>(dva, part + BK * LDP, LDP, kr, t);
  }
  store_acc<D>(dkb, dk_t, dka, scale, kr, Tk - k0, t);
  store_acc<D>(dvb, dv_t, dva, 1.f, kr, Tk - k0, t);
}

// The wgmma form's launch as computed on the host: the grids' second
// dims (B3's query tiles, B4's key blocks) and the tensor maps of q, k, v,
// g and pe: dims (D, T, H, B) innermost first (pe: (D, 2L, 1, 1)), byte
// strides of the outer three; every box is 64 columns x 64 rows.
// tests/test_torch_flash_rel_bwd_wgmma.py's wgmma_backward_plan mirrors it;
// loco_flash_rel_bwd_wgmma_plan returns it.
struct BwdPlan {
  int dq_tiles, dkv_blocks;
  uint64_t dims[5][4], strides[5][3];
};

BwdPlan bwd_plan(const Strides& st, int B, int H, int Tq, int Tk, int D, int two_l) {
  BwdPlan p;
  p.dq_tiles = (Tq + wg::BQ - 1) / wg::BQ;
  p.dkv_blocks = (Tk + wg::BK - 1) / wg::BK;
  const int ops[4] = {IQ, IK, IV, IG};
  const int T[4] = {Tq, Tk, Tk, Tq};
  for (int i = 0; i < 4; ++i)
    bhtd_map(p.dims[i], p.strides[i], D, T[i], H, B, st.t[ops[i]], st.h[ops[i]], st.b[ops[i]]);
  table_map(p.dims[4], p.strides[4], D, two_l);
  return p;
}

template <bool MASK_ONLY, int D>
constexpr size_t dq_wgmma_smem_bytes() {   // + room to align to 1024
  return 1024 + sizeof(wg::DqSmem<MASK_ONLY, D>);
}

template <bool MASK_ONLY, int D>
constexpr size_t dkv_wgmma_smem_bytes() {
  return 1024 + sizeof(wg::DkvSmem<MASK_ONLY, D>);
}

template <bool MASK_ONLY, int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* pe,
                         const int* valid_len, const float* lse, const float* delta,
                         const void* dout, float* dq, float* dqpe, float* dk, float* dv,
                         const Strides& st, int B, int H, int Tq, int Tk, int two_l, int causal,
                         float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> dq_done{0}, dkv_done{0};
  static std::atomic<int> dq_regs{-1}, dkv_regs{-1};
  constexpr int DKV_THREADS = wg::dkv_threads<D>();
  cudaError_t e = allow_smem_once(flash_rel_bwd_dq_wgmma_kernel<MASK_ONLY, D>,
                                  (int)dq_wgmma_smem_bytes<MASK_ONLY, D>(), dq_done);
  if (e == cudaSuccess)
    e = check_handover_regs(flash_rel_bwd_dq_wgmma_kernel<MASK_ONLY, D>, 384, 128,
                            wg::PRODUCER_REGS, wg::CONSUMER_REGS, dq_regs);
  if (e == cudaSuccess)
    e = allow_smem_once(flash_rel_bwd_dkv_wgmma_kernel<MASK_ONLY, D>,
                        (int)dkv_wgmma_smem_bytes<MASK_ONLY, D>(), dkv_done);
  if (e == cudaSuccess && DKV_THREADS == 384)
    e = check_handover_regs(flash_rel_bwd_dkv_wgmma_kernel<MASK_ONLY, D>, 384, 128,
                            wg::PRODUCER_REGS, wg::CONSUMER_REGS, dkv_regs);
  if (e != cudaSuccess) return e;
  const BwdPlan p = bwd_plan(st, B, H, Tq, Tk, D, two_l);
  const void* ptrs[5] = {q, k, v, dout, pe};
  CUtensorMap maps[5] = {};
  for (int i = 0; i < (MASK_ONLY ? 4 : 5); ++i) {
    e = encode_bf16_map(&maps[i], ptrs[i], p.dims[i], p.strides[i], 64);
    if (e != cudaSuccess) return e;
  }
  flash_rel_bwd_dq_wgmma_kernel<MASK_ONLY, D>
      <<<dim3(B * H, p.dq_tiles), 384, dq_wgmma_smem_bytes<MASK_ONLY, D>(), stream>>>(
          maps[0], maps[1], maps[2], maps[3], maps[4], (const bf16*)pe, valid_len, lse, delta,
          dq, st.b[IDQ], st.h[IDQ], st.t[IDQ], dqpe, H, Tq, Tk, two_l, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_rel_bwd_dkv_wgmma_kernel<MASK_ONLY, D>
      <<<dim3(B * H, p.dkv_blocks), DKV_THREADS, dkv_wgmma_smem_bytes<MASK_ONLY, D>(),
         stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], valid_len, lse, delta, dk,
                   st.b[IDK], st.h[IDK], st.t[IDK], dv, st.b[IDV], st.h[IDV], st.t[IDV], H, Tq,
                   Tk, two_l, causal, scale);
  return cudaGetLastError();
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

// the launch's form: form 1 (wgmma) for bf16 at D = 64 and 128, form 0
// (mma.sync) for every other instantiation (flash_causal.py's kernel_form)
template <typename T, int D>
constexpr int form_of() { return !std::is_same<T, float>::value && D >= 64 ? 1 : 0; }

template <typename T, bool MASK_ONLY, int D>
size_t smem_bytes(int two_l, int kernel) {
  if constexpr (form_of<T, D>() == 1)
    return kernel == 0 ? dq_wgmma_smem_bytes<MASK_ONLY, D>()
                       : dkv_wgmma_smem_bytes<MASK_ONLY, D>();
  else
    return kernel == 0 ? dq_smem_bytes<T, MASK_ONLY, D>(two_l) : dkv_smem_bytes<T, MASK_ONLY, D>();
}

template <typename Kernel>
int occupancy(Kernel kernel, cudaError_t e, int threads, size_t smem) {
  int blocks = -1;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return e == cudaSuccess ? blocks : -1;
}

template <typename T, bool MASK_ONLY, int D>
int blocks_per_sm(int two_l, int kernel) {
  const size_t smem = smem_bytes<T, MASK_ONLY, D>(two_l, kernel);
  if constexpr (form_of<T, D>() == 1) {
    if (kernel == 0)
      return occupancy(flash_rel_bwd_dq_wgmma_kernel<MASK_ONLY, D>,
                       cudaFuncSetAttribute(flash_rel_bwd_dq_wgmma_kernel<MASK_ONLY, D>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)smem),
                       384, smem);
    return occupancy(flash_rel_bwd_dkv_wgmma_kernel<MASK_ONLY, D>,
                     cudaFuncSetAttribute(flash_rel_bwd_dkv_wgmma_kernel<MASK_ONLY, D>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem),
                     wg::dkv_threads<D>(), smem);
  } else {
    if (kernel == 0)
      return occupancy(flash_rel_bwd_dq_kernel<T, MASK_ONLY, D>, allow_smem_dq<T, MASK_ONLY, D>(),
                       DqS::THREADS, smem);
    return occupancy(flash_rel_bwd_dkv_kernel<T, MASK_ONLY, D>, allow_smem_dkv<T, MASK_ONLY, D>(),
                     DkvS::THREADS, smem);
  }
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
#define FORM_TD std::remove_pointer_t<decltype(tag)>, decltype(dd)::value
#define FORM_MD decltype(mo)::value, decltype(dd)::value

}  // namespace

// Dynamic shared memory of a launch of B3 (kernel 0) or B4 (kernel 1) in
// the form these operands take, 0 for a head dim not instantiated.
extern "C" size_t loco_flash_rel_bwd_smem_bytes(int two_l, int mask_only, int kernel, int d,
                                                int bf16_operands) {
  return with_form(bf16_operands, mask_only, d, (size_t)0, [&](auto tag, auto mo, auto dd) {
    return smem_bytes<FORM>(two_l, kernel);
  });
}

// Blocks of B3 (kernel 0) or B4 (kernel 1), in the form these operands
// take, that fit on one SM of the current device at this table size
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
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
// [B,H,Tq,two_l] float32 contiguous (every cell written).  form 0: the
// mma.sync kernels, float32 at D in {8, 16, 32, 64, 128} and bfloat16 at
// {8, 16, 32}; form 1: the wgmma/TMA kernels, bfloat16 at D in {64, 128}
// (q, k, v, g strides in bytes multiples of 16).  Another pairing returns
// cudaErrorNotSupported.  Launches B3 then B4 on ``stream``.
extern "C" int loco_flash_rel_bwd(const void* q, const void* k, const void* v,
                                  const void* pe, const void* valid_len, const void* lse,
                                  const void* delta, const void* g, void* dq, void* dqpe,
                                  void* dk, void* dv, const long long* strides, int B,
                                  int H, int Tq, int Tk, int D, int two_l, int causal,
                                  int mask_only, float scale, int form, int bf16_operands,
                                  void* stream) {
  if (form != 0 && form != 1) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int o = 0; o < N_OPERANDS; ++o)
    st.b[o] = strides[3 * o], st.h[o] = strides[3 * o + 1], st.t[o] = strides[3 * o + 2];
  return (int)with_form(bf16_operands, mask_only, D, cudaErrorInvalidValue,
                        [&](auto tag, auto mo, auto dd) {
                          if (form != form_of<FORM_TD>()) return cudaErrorNotSupported;
                          if constexpr (form_of<FORM_TD>() == 1)
                            return launch_wgmma<FORM_MD>(
                                q, k, v, pe, (const int*)valid_len, (const float*)lse,
                                (const float*)delta, g, (float*)dq, (float*)dqpe, (float*)dk,
                                (float*)dv, st, B, H, Tq, Tk, two_l, causal, scale,
                                (cudaStream_t)stream);
                          else
                            return launch<FORM>(q, k, v, pe, (const int*)valid_len,
                                                (const float*)lse, (const float*)delta, g,
                                                (float*)dq, (float*)dqpe, (float*)dk,
                                                (float*)dv, st, B, H, Tq, Tk, two_l, causal,
                                                scale, (cudaStream_t)stream);
                        });
}

// The wgmma form's plan (BwdPlan and the tiles its blocks take) for these
// arguments and the host's valid_len[B], into out[47]: B3's blocks, key
// tiles over all blocks and the band windows they load (tiles not wholly
// past a clip edge; 0 when mask_only); B4's blocks, query tiles and pe rows
// reached over all tile pairs (band_rows; 0 when mask_only); for q, k, v,
// g and pe in turn dims[4] and byte strides[3]; then B3's and B4's dynamic
// shared memory, threads and stages (D in {64, 128}).
extern "C" void loco_flash_rel_bwd_wgmma_plan(const long long* strides, int B, int H, int Tq,
                                              int Tk, int D, int two_l, int causal,
                                              int mask_only, const int* valid_len,
                                              long long* out) {
  Strides st;
  for (int o = 0; o < N_OPERANDS; ++o)
    st.b[o] = strides[3 * o], st.h[o] = strides[3 * o + 1], st.t[o] = strides[3 * o + 2];
  const BwdPlan p = bwd_plan(st, B, H, Tq, Tk, D, two_l);
  const int L = two_l / 2;
  long long tiles[4] = {0, 0, 0, 0};
  for (int b = 0; b < B; ++b) {
    const int vl = imax(0, imin(valid_len[b], Tk));
    for (int y = 0; y < p.dq_tiles; ++y) {
      const int nk = wg::dq_key_tiles(y * wg::BQ, vl, causal);
      tiles[0] += nk;
      for (int i = 0; i < nk && !mask_only; ++i)
        tiles[1] += !band_clipped(y * wg::BQ, i * wg::BK, L);
    }
    for (int y = 0; y < p.dkv_blocks; ++y) {
      const wg::DkvTiles t = wg::dkv_tiles(y * wg::BK, vl, Tq, causal);
      tiles[2] += t.n;
      for (int i = 0; i < t.n && !mask_only; ++i)
        tiles[3] += band_rows((t.qt0 + i) * wg::BQ, y * wg::BK, L);
    }
  }
  out[0] = (long long)B * H * p.dq_tiles;
  out[1] = tiles[0] * H;
  out[2] = tiles[1] * H;
  out[3] = (long long)B * H * p.dkv_blocks;
  out[4] = tiles[2] * H;
  out[5] = tiles[3] * H;
  for (int i = 0; i < 5; ++i) {
    long long* o = out + 6 + 7 * i;
    for (int j = 0; j < 4; ++j) o[j] = (long long)p.dims[i][j];
    for (int j = 0; j < 3; ++j) o[4 + j] = (long long)p.strides[i][j];
  }
  const bool d64 = D == 64;
  out[41] = mask_only ? (d64 ? dq_wgmma_smem_bytes<true, 64>() : dq_wgmma_smem_bytes<true, 128>())
                      : (d64 ? dq_wgmma_smem_bytes<false, 64>()
                             : dq_wgmma_smem_bytes<false, 128>());
  out[42] = mask_only ? (d64 ? dkv_wgmma_smem_bytes<true, 64>() : dkv_wgmma_smem_bytes<true, 128>())
                      : (d64 ? dkv_wgmma_smem_bytes<false, 64>()
                             : dkv_wgmma_smem_bytes<false, 128>());
  out[43] = 384;
  out[44] = d64 ? wg::dkv_threads<64>() : wg::dkv_threads<128>();
  out[45] = d64 ? wg::dq_stages<64>() : wg::dq_stages<128>();
  out[46] = d64 ? wg::dkv_stages<64>() : wg::dkv_stages<128>();
}
