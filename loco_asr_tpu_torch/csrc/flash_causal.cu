// Causal / non-causal flash attention, forward (kernels B5 and B6 as one).
//
// Replaces: loco_asr_tpu/ops/pallas/flash_attention.py::_flash_kernel
// (B5, launched by _flash_forward on [B,H,T,D]) and ::_flash_pair_kernel
// (B6, launched by _flash_forward_nhd on [B,T,H,64], two heads per block):
//   s[i,j] = scale * q_i . k_j, keys j > i masked with -1e30 when causal
//   (top-left aligned: row i sees keys 0..i even when Tq != Tk),
//   online softmax in f32 -> out (q's layout) and the row logsumexp
//   lse [B,H,Tq], the row sum clamped at 1e-30.
// The two TPU kernels differ only in how Mosaic may block the operands
// (B6's head pair exists because 128 lanes is the smallest last-dim block).
// Here the kernel takes explicit (batch, head, time) element strides for
// q, k, v and out, so one kernel reads [B,H,T,D], [B,T,H,D] and the
// column slices of a fused qkv projection in place; the head dim is
// contiguous.
//
// What bounds it on an H100: arithmetic.  At the GPT-2 scoring shape
// ([8, 1024] tokens, 12 heads of 64, causal) q.k^T and p.v are 12.9 GFLOP
// against 25 MB of q, k, v, out and lse, ~500 FLOP per byte.  The port's
// contract is f32 accuracy, which the CUDA cores give at 67 TFLOP/s.  This
// kernel runs the products on the tensor cores instead, each as three TF32
// products (x = big + small, a.b = small.big + big.small +
// big.big in f32), which keeps f32 accuracy at 3x the TF32 work: 495/3 =
// 165 TFLOP/s of f32-accurate products.  The split runs on the CUDA cores
// for every fragment value read (3 instructions each); the q fragments are
// split once a block, k and v ones once a warp as they are read.  The JAX
// reference does the same on the TPU (precision="float32": multi-pass bf16
// on the MXU), and PyTorch's f32 memory-efficient attention does the same
// on this card.
//
// Design (flash-attention-2 layout): one block of 4 warps per (b*h, 64-query
// tile); each warp owns 16 query rows, so the row max and sum are shuffles
// within a quad of lanes and no warp waits on another's softmax.
//  - q: each warp loads its rows' m16n8k8 A fragments from device memory
//    once and keeps them split (big, small) in registers.
//  - k, v: 64-key tiles, double-buffered in shared memory by 16-byte
//    cp.async, the next tile's copy in flight while the current one is
//    multiplied.  Rows are D + 4 floats: 16-byte aligned, and the fragment
//    reads of K (row g, col t) and V (rows 2t and 2t + 1, col g) fall in
//    32 distinct banks for every D in {8, 16, 32, 64, 128} (the stride is
//    4, 12 or 20 words mod 32: 4g + t, 12g + t and 20g + t mod 32, and
//    8t + g, 24t + g, 8t + g plus 4, 12 or 20 for the odd row, cover 0..31).
//  - p stays in registers: the C fragment of a score block holds keys
//    {2t, 2t + 1} of rows {g, g + 8}, the A fragment of p.v wants columns
//    {t, t + 4}.  The sum over keys does not depend on their order, so
//    p.v reads its 8 keys permuted (column t is key 2t, column t + 4 is
//    key 2t + 1) and takes V's B fragment from the same rows: (c0, c2,
//    c1, c3) is the A fragment as it stands.
//  - softmax on the accumulator fragments in base 2 (scale * log2 e in one
//    multiply, exp2f); the causal mask only on tiles that cross the
//    diagonal, the Tk mask only on the ragged last tile; lse back in
//    natural log.
// With causal, key tiles wholly above the diagonal are never loaded.  Block
// (x, y) is (b*h, the y-th longest query tile): blocks are dispatched x
// fastest, so every head's longest tile starts first.  Keys past Tk get
// -inf and rows past Tq are not stored.  The head dim is a template
// parameter (8, 16, 32, 64, 128).  At D = 128 the q fragments alone take
// 128 of the 255 registers a thread may hold; no main path runs it.  TF32
// wgmma takes both operands K-major, so p.v would need V transposed in
// shared memory, while mma.sync reads any layout: the f32 form stays here.
//
// Two forms, picked by the caller (flash_causal.py's kernel_form): form 0,
// the kernel above, runs every f32 call and bf16 at D = 8, 16 and 32 (T a
// template parameter: bf16 operands, one m16n8k16 mma.sync a product,
// bf16_mma.cuh); form 1 runs bf16 at D = 64 and 128.  Both compute the JAX
// kernels' bf16 path: products on bf16 operands with f32 accumulation, p
// rounded to bf16 before p.v (p.astype(v.dtype)), the softmax, the row
// sums and lse in f32, the same masks, out in bf16.
//
// Form 1, for Hopper (hopper.cuh).  What bounds it: the bytes, just above
// the tensor cores, at both main shapes (causal [8, 1024, 12, 64]: 50 MB
// in 0.015 ms, 12.9 GFLOP in 0.013; [8, 25, 1024, 64]: 105 MB in 0.032,
// 26.9 GFLOP in 0.027), but neither is near: a 128 x 128 tile takes 1,024
// cycles of an SM's tensor cores for both products and as many of its
// exp2 unit (16 results a cycle), and what the card shows (PERF.md) is a
// warpgroup's softmax and its products in turn, the two warpgroups in
// step, plus a block's start (Q's load) and end per 4-5 tiles unhidden.
//  - A block per (b*h, 128 query rows): two consumer warpgroups of 64 rows
//    and a producer warpgroup of which one thread issues every TMA copy;
//    setmaxnreg moves registers from the producer (40) to the consumers
//    (232).  168 a thread at launch (384 threads, one block an SM).
//  - TMA: Q once, K and V through rings of 4 stages with an mbarrier each
//    way per stage, boxes of 64 columns (128 bytes, the 128-byte swizzle),
//    tensor maps over the strided (D, T, H, B) view, so qkv column slices
//    are read in place; reads past T fill zeros (those keys get -inf).
//    K's stage is released when q.k^T is done, V's when p.v is.
//  - Key tiles of 128 at D = 64: shared memory 16 KB of Q + 4 x 32 KB of
//    K/V (148,616 bytes with the barriers and the 1024-byte alignment);
//    the consumer's S (64 registers), P (32) and O (32) fit 232.  64 at
//    D = 128: 32 KB + 4 x 32 KB (165,000 bytes); a 128-key S beside its O
//    (64) and P would not, and ptxas serializes the products (measured
//    1.23x slower, PERF.md).
//  - S = Q.K^T: wgmma m64nBKk16 with Q and K K-major in shared memory, the
//    k-steps 32 bytes apart inside a swizzle span.  O += P.V: P from
//    registers (the accumulators of S rounded to bf16 pairs are the A
//    fragments as they stand), V MN-major through the transpose bit.
//    q.k^T of tile i is issued before p.v of tile i - 1, whose products
//    run under tile i's softmax.
//  - Softmax in base 2 with ex2.approx; the masks only on tiles that cross
//    the diagonal or Tk; unmasked tiles fold the scale into one FFMA.
//  - out through shared memory (the warpgroup's Q rows, swizzled) in
//    16-byte stores, rows >= Tq never written; lse in f32.
// D < 64 stays on mma.sync: a k-step of wgmma is 16 deep, so D = 8 has
// none, and D = 16 and 32 rows would need the 32- and 64-byte swizzles and
// descriptors of their own, for calls (the LoCo tiny model at 8, the orbax
// LM at 16) small enough to be bound by their launch.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;   // query rows per block
constexpr int BK = 64;           // key rows per tile
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// the -1e30 causal mask in base 2; also the running max before any key, as
// in the plain version a row that saw only masked keys weighs them equally
constexpr float NEG = -1e30f * LOG2E;

struct Strides {               // element strides of (batch, head, time)
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

Strides strides_of(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

// shared row stride of K and V: 16-byte aligned rows, fragment reads in
// distinct banks (D + 4 floats, see above; D + 8 bf16)
template <typename T, int D>
__host__ __device__ constexpr int ld() { return std::is_same<T, float>::value ? D + 4 : D + 8; }

template <typename T, int D>
__host__ constexpr size_t smem_bytes() {   // two stages of (K, V) tiles
  return (size_t)2 * 2 * BK * ld<T, D>() * sizeof(T);
}

// rows [row0, row0 + BK) of a strided [n, D] matrix -> smem [BK][ld],
// asynchronously; rows >= n are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile_async(T* dst, const T* __restrict__ src,
                                                long long row_stride, int row0, int n) {
  constexpr int C = D * (int)sizeof(T) / 16, E = 16 / (int)sizeof(T);   // 16-byte pieces
#pragma unroll
  for (int i = threadIdx.x; i < BK * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const bool valid = row0 + r < n;
    const T* s = valid ? src + (row0 + r) * row_stride + c * E : src;
    cp_async16(dst + r * ld<T, D>() + c * E, s, valid);
  }
}

// Blocks an SM that the launch bound asks for: two up to D = 64, where
// shared memory holds two.  Stating the minimum changes ptxas's schedule at
// D = 64 (210 registers against 177 without it, no spill either way) and
// makes the kernel faster (PERF.md).  At D = 128 the two stages take 132 KB,
// so one block fits and the bound asks for one.
template <int D>
constexpr int min_blocks() { return D <= 64 ? 2 : 1; }

// T = float: three-pass TF32 products, f32-accurate.  T = bf16: one bf16
// pass, p rounded to bf16 before p.v (the JAX kernel's p.astype(v.dtype)),
// out rounded to bf16; the softmax and the accumulators are f32 either way.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
flash_causal_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ lse, Strides st, int H, int Tq,
                        int Tk, int causal, float scale) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int LD = ld<T, D>();
  constexpr int KD = D / 8;     // k-steps of q.k^T (TF32), column blocks of p.v
  constexpr int NB = BK / 8;    // key blocks of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];   // [2 stages][K, V][BK][LD]
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;     // this thread's rows
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;

  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);   // tiles above: all masked
  load_tile_async<T, D>(smem, kb, st.kt, 0, Tk);
  load_tile_async<T, D>(smem + BK * LD, vb, st.vt, 0, Tk);
  cp_async_commit();

  // q's A fragments: split once (TF32), packed pairs (bf16)
  unsigned qbig[F32 ? KD : 1][4], qsmall[F32 ? KD : 1][4];
  Bf16Rows<D> qa;
  if constexpr (F32) {
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
  } else {
    qa.load(qb + r0 * st.qt, qb + r1 * st.qt, r0 < Tq, r1 < Tq, t);
  }

  float o[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG, NEG};         // running max (base 2) of rows r0, r1
  float l[2] = {0.f, 0.f};             // this thread's share of the row sums
  const float c2 = scale * LOG2E;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < nk) {   // the next tile's copy overlaps this tile's products
      T* nxt = smem + ((kt + 1) & 1) * 2 * BK * LD;
      load_tile_async<T, D>(nxt, kb, st.kt, k0 + BK, Tk);
      load_tile_async<T, D>(nxt + BK * LD, vb, st.vt, k0 + BK, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sK = smem + (kt & 1) * 2 * BK * LD;
    const T* sV = sK + BK * LD;

    // s = q.k^T: block n holds keys k0 + 8n + {2t, 2t + 1} of rows r0, r1
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

    // scale, mask, online softmax in base 2
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= c2;
    if ((causal && k0 + BK - 1 > q0) || k0 + BK > Tk) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 8 * n + 2 * t + (e & 1);
          const int i = e < 2 ? r0 : r1;
          if (causal && j > i) s[n][e] = NEG;
          if (j >= Tk) s[n][e] = -INFINITY;
        }
    }
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
    __syncthreads();   // this stage is refilled two tiles on
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
    if (t == 0) lse[(long long)bh * Tq + rows[r]] = (m[r] + log2f(denom)) * LN2;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const Strides& st, int B, int H, int Tq, int Tk,
                   int causal, float scale, cudaStream_t stream) {
  // the dynamic shared-memory limit is raised once per form and device
  static std::atomic<unsigned long long> done{0};
  const cudaError_t e =
      allow_smem_once(flash_causal_fwd_kernel<T, D>, (int)smem_bytes<T, D>(), done);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_causal_fwd_kernel<T, D><<<grid, THREADS, smem_bytes<T, D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, st, H, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out,
                     float* lse, const Strides& st, int B, int H, int Tq, int Tk,
                     int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, out, lse, st, B, H, Tq, Tk, causal, scale, s);
    case 16: return launch<T, 16>(q, k, v, out, lse, st, B, H, Tq, Tk, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, st, B, H, Tq, Tk, causal, scale, s);
    case 64:
    case 128:
      if constexpr (std::is_same<T, float>::value)   // bf16 there is form 1's
        return D == 64 ? launch<T, 64>(q, k, v, out, lse, st, B, H, Tq, Tk, causal, scale, s)
                       : launch<T, 128>(q, k, v, out, lse, st, B, H, Tq, Tk, causal, scale, s);
      else
        return cudaErrorNotSupported;
    default: return cudaErrorInvalidValue;
  }
}

// ---- the bf16 wgmma form, D = 64 and 128 (the note at the top) -----------

namespace wg {

constexpr int BQ = 128;        // query rows a block: two consumer warpgroups of 64
constexpr int THREADS = 384;   // warpgroups 0 and 1 consume, 2 produces (one thread issues)
constexpr int STAGES = 4;      // of the K and V rings
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;   // 128 x 40 + 256 x 232 = 384 x 168, the launch's share

// key rows a tile: 128 at D = 64; 64 at D = 128, where the registers of a
// 128-key S beside O and P would serialize the warpgroup's products
template <int D>
__host__ __device__ constexpr int key_block() { return D == 64 ? 128 : 64; }

template <int D, int BK>
struct Smem {
  static constexpr int HALVES = D / 64, S = STAGES;   // 64-column halves of 128 bytes
  bf16 q[HALVES][BQ][64];                            // Q, then each warpgroup's out rows
  bf16 k[S][HALVES][BK][64];
  bf16 v[S][HALVES][BK][64];
  uint64_t q_full, k_full[S], v_full[S], k_empty[S], v_empty[S];
};

template <int D>
constexpr size_t smem_bytes() {   // + room to align to 1024
  return sizeof(Smem<D, key_block<D>()>) + 1024;
}

// key tiles the query tile at q0 reads: every one below Tk and, under
// causal, none wholly above its last row below Tq (the test's
// wgmma_key_tiles mirrors it: tests/test_torch_flash_causal_wgmma.py)
__host__ __device__ inline int key_tiles(int q0, int Tq, int Tk, int causal, int bk) {
  const int last = (q0 + BQ < Tq ? q0 + BQ : Tq) - 1;
  const int n = (Tk + bk - 1) / bk, diag = last / bk + 1;
  return causal && diag < n ? diag : n;
}

// one tile's scores -> p = 2^(c2 s - m) in place, with the running max m
// (base 2, scaled) and this thread's row sums l updated and alpha the old
// rows' rescale.  MASK: scale, then mask (the tiles that cross the diagonal
// or Tk), then the max; else the max of the raw scores (c2 > 0 keeps their
// order) and one FFMA a score for c2 s - m.
template <bool MASK, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c2, int causal, int k0,
                                             int row0, int Tk, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
  if constexpr (MASK) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
        float& x = s[4 * j + e];
        x *= c2;
        if (causal && key > row) x = NEG;
        if (key >= Tk) x = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
  } else {   // four partial maxima a row: short dependency chains
    float part[2][4];
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
        part[r][j & 3] = j < 4 ? x : fmaxf(part[r][j & 3], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r] = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float top = fmaxf(m[r], MASK ? quad_max(mx[r]) : quad_max(mx[r]) * c2);
    alpha[r] = ex2(m[r] - top);
    m[r] = top;
    l[r] *= alpha[r];
    neg_m[r] = -top;
  }
  float sum[2][4] = {};   // four partial sums a row, as the maxima
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = ex2(MASK ? s[i] + neg_m[(i >> 1) & 1] : fmaf(s[i], c2, neg_m[(i >> 1) & 1]));
    sum[(i >> 1) & 1][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] += (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]);
}

// the softmax of tile k0, masked only where it must be (and along the
// masked path when c2 <= 0, whose max is not the raw scores'); done before
// the caller's next wgmma wait (the fences keep the compiler from sinking
// it past the wait, which would serialize it behind p.v)
template <int N>
__device__ __forceinline__ void softmax_step(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c2, int causal, int k0,
                                             int first, int row0, int Tk, int t) {
  constexpr int BK = 2 * N;
  if ((causal && k0 + BK - 1 > first) || k0 + BK > Tk || !(c2 > 0.f))
    softmax_tile<true>(s, m, l, alpha, c2, causal, k0, row0, Tk, t);
  else
    softmax_tile<false>(s, m, l, alpha, c2, causal, k0, row0, Tk, t);
  fence_regs(s);
  fence_regs(m);
  fence_regs(l);
  fence_regs(alpha);
}

}  // namespace wg

template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_causal_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              bf16* __restrict__ out, long long ob, long long oh, long long ot,
                              float* __restrict__ lse,
                              int H, int Tq, int Tk, int causal, float scale) {
  constexpr int BK = wg::key_block<D>(), HALVES = D / 64, S = wg::STAGES;
  using Sm = wg::Smem<D, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  // block x: (the x / BH-th longest query tile, b * H + h), longest first
  const int nq = (Tq + wg::BQ - 1) / wg::BQ, bhs = gridDim.x / nq;
  const int bh = blockIdx.x % bhs, b = bh / H, h = bh % H;
  const int q0 = (nq - 1 - (int)blockIdx.x / bhs) * wg::BQ;
  const int nk = wg::key_tiles(q0, Tq, Tk, causal, BK);
  const int w = threadIdx.x / 128;

  if (threadIdx.x == 256) {   // the thread that will issue the copies
    prefetch_tensormap(&mq);
    prefetch_tensormap(&mk);
    prefetch_tensormap(&mv);
  }
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      mbar_init(&sm.k_full[i], 1);
      mbar_init(&sm.v_full[i], 1);
      mbar_init(&sm.k_empty[i], 256);   // every consumer thread releases
      mbar_init(&sm.v_empty[i], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (w == 2) {   // the producer: one thread issues every copy
    setmaxnreg_dec<wg::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(&sm.q_full, sizeof(sm.q));
      for (int qw = 0; qw < 2; ++qw)
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load_4d(&sm.q[hf][64 * qw][0], &mq, &sm.q_full, 64 * hf, q0 + 64 * qw, h, b);
      // K of tile i waits for q.k^T of tile i - S, V for p.v of tile i - S
      for (int i = 0; i < nk; ++i) {
        const int st = i % S, parity = ((i / S) & 1) ^ 1;
        if (i >= S) mbar_wait(&sm.k_empty[st], parity);
        mbar_expect_tx(&sm.k_full[st], sizeof(sm.k[st]));
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load_4d(&sm.k[st][hf][0][0], &mk, &sm.k_full[st], 64 * hf, i * BK, h, b);
        if (i >= S) mbar_wait(&sm.v_empty[st], parity);
        mbar_expect_tx(&sm.v_full[st], sizeof(sm.v[st]));
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load_4d(&sm.v[st][hf][0][0], &mv, &sm.v_full[st], 64 * hf, i * BK, h, b);
      }
    }
  } else {   // a consumer warpgroup: 64 query rows
    setmaxnreg_inc<wg::CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int rr = 16 * (tid / 32) + g;                  // rows rr, rr + 8 of the warpgroup's 64
    const int first = q0 + 64 * w, row0 = first + rr;    // row0 + 8 is the second
    const float c2 = scale * LOG2E;
    float o[D / 2], s[BK / 2], alpha[2];
    uint32_t p[BK / 16][4];
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // S = Q.K^T of this warpgroup's rows, both K-major; O += P.V with V
    // read as stored ([key][D], MN-major: the instruction transposes it)
    auto qk = [&](float (&acc)[BK / 2], int st) {
      wgmma_ss_kmajor<D, BK>(acc, &sm.q[0][64 * w][0], wg::BQ * 128, &sm.k[st][0][0][0],
                             BK * 128);
    };
    auto pv = [&](float (&acc)[D / 2], const uint32_t (&a)[BK / 16][4], int st) {
      wgmma_rs_mnmajor<D, BK / 16>(acc, a, &sm.v[st][0][0][0], BK * 128);
    };

    mbar_wait(&sm.q_full, 0);
    mbar_wait(&sm.k_full[0], 0);
    wgmma_fence();
    qk(s, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&sm.k_empty[0]);
    wg::softmax_step(s, m, l, alpha, c2, causal, 0, first, row0, Tk, t);
    pack_bf16_a(p, s);
    // tile i's q.k^T runs while p.v of tile i - 1 is issued behind it;
    // the softmax of tile i overlaps that p.v
    for (int i = 1; i < nk; ++i) {
      const int st = i % S, pst = (i - 1) % S;
      mbar_wait(&sm.k_full[st], (i / S) & 1);
      wgmma_fence();
      qk(s, st);
      wgmma_commit();
      mbar_wait(&sm.v_full[pst], ((i - 1) / S) & 1);
      pv(o, p, pst);
      wgmma_commit();
      wgmma_wait<1>();   // q.k^T done: K's stage is free
      fence_regs(s);
      mbar_arrive(&sm.k_empty[st]);
      wg::softmax_step(s, m, l, alpha, c2, causal, i * BK, first, row0, Tk, t);
      wgmma_wait<0>();   // p.v done: V's stage is free, o and p may change
      fence_regs(o);
      fence_regs(p);
      mbar_arrive(&sm.v_empty[pst]);
#pragma unroll
      for (int n = 0; n < D / 2; ++n) o[n] *= alpha[(n >> 1) & 1];
      pack_bf16_a(p, s);
    }
    const int lst = (nk - 1) % S;
    mbar_wait(&sm.v_full[lst], ((nk - 1) / S) & 1);
    wgmma_fence();
    pv(o, p, lst);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    // out: this warpgroup's rows of sm.q (its Q is read no more), in the
    // swizzled layout, then to device memory in 16-byte pieces
    float denom[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      denom[r] = fmaxf(quad_sum(l[r]), 1e-30f);
      inv[r] = 1.f / denom[r];
    }
    unsigned char* rows = reinterpret_cast<unsigned char*>(&sm.q[0][64 * w][0]) + rr * 128;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* at = rows + (j / 8) * wg::BQ * 128 + (((j % 8) ^ g) * 16) + 4 * t;
      *reinterpret_cast<uint32_t*>(at) = round_pair(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(at + 8 * 128) =
          round_pair(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
    }
    named_barrier(1 + w, 128);
    // eight threads to a 128-byte half row; rows >= Tq are not written
    const unsigned char* tile = reinterpret_cast<const unsigned char*>(&sm.q[0][64 * w][0]);
    bf16* dst = out + b * ob + h * oh;
#pragma unroll
    for (int c = tid; c < 64 * D / 8; c += 128) {
      const int row = c / (D / 8), piece = c % (D / 8), hf = piece / 8;
      const uint4 x = *reinterpret_cast<const uint4*>(
          tile + hf * wg::BQ * 128 + row * 128 + (((piece % 8) ^ (row & 7)) * 16));
      if (first + row < Tq)
        *reinterpret_cast<uint4*>(dst + (first + row) * ot + 8 * piece) = x;
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < Tq)
          lse[(long long)bh * Tq + row0 + 8 * r] = (m[r] + log2f(denom[r])) * LN2;
    }
  }
}

// The wgmma form's launch as computed on the host: the blocks, the key
// tiles of one (b, h) over all its query tiles, and the tensor maps of q,
// k and v: dims (D, T, H, B), byte strides of T, H and B, box rows.
// tests/test_torch_flash_causal_wgmma.py's wgmma_plan mirrors it;
// loco_flash_causal_wgmma_plan returns it.
struct WgPlan {
  int grid, tiles;
  uint64_t dims[3][4], strides[3][3];
  unsigned box_rows[3];
};

WgPlan wg_plan(const Strides& st, int B, int H, int Tq, int Tk, int D, int causal) {
  const int bk = D == 64 ? wg::key_block<64>() : wg::key_block<128>();
  WgPlan p;
  const int nq = (Tq + wg::BQ - 1) / wg::BQ;
  p.grid = B * H * nq;
  p.tiles = 0;
  for (int y = 0; y < nq; ++y) p.tiles += wg::key_tiles(y * wg::BQ, Tq, Tk, causal, bk);
  const long long el[3][3] = {{st.qt, st.qh, st.qb}, {st.kt, st.kh, st.kb},
                              {st.vt, st.vh, st.vb}};
  const int T[3] = {Tq, Tk, Tk};
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[4] = {(uint64_t)D, (uint64_t)T[i], (uint64_t)H, (uint64_t)B};
    // in bytes; an axis of size 1 is never stepped and takes the packed stride
    uint64_t* s = p.strides[i];
    s[0] = dims[1] == 1 ? 2ull * D : 2ull * el[i][0];
    s[1] = dims[2] == 1 ? s[0] * dims[1] : 2ull * el[i][1];
    s[2] = dims[3] == 1 ? s[1] * dims[2] : 2ull * el[i][2];
    for (int j = 0; j < 4; ++j) p.dims[i][j] = dims[j];
    p.box_rows[i] = i == 1 || i == 2 ? bk : 64;   // a key tile; a warpgroup's query rows
  }
  return p;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         const Strides& st, int B, int H, int Tq, int Tk, int causal,
                         float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  static std::atomic<int> regs_ok{-1};
  cudaError_t e = allow_smem_once(flash_causal_fwd_wgmma_kernel<D>,
                                  (int)wg::smem_bytes<D>(), done);
  if (e == cudaSuccess)
    e = check_handover_regs(flash_causal_fwd_wgmma_kernel<D>, wg::THREADS, 128,
                            wg::PRODUCER_REGS, wg::CONSUMER_REGS, regs_ok);
  if (e != cudaSuccess) return e;
  const WgPlan p = wg_plan(st, B, H, Tq, Tk, D, causal);
  const void* ptrs[3] = {q, k, v};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    e = encode_bf16_map(&maps[i], ptrs[i], p.dims[i], p.strides[i], p.box_rows[i]);
    if (e != cudaSuccess) return e;
  }
  flash_causal_fwd_wgmma_kernel<D><<<p.grid, wg::THREADS, wg::smem_bytes<D>(), stream>>>(
      maps[0], maps[1], maps[2], (bf16*)out, st.ob, st.oh, st.ot, lse, H, Tq, Tk, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q [.., Tq, D], k/v [.., Tk, D], out [.., Tq, D] (float32, or bfloat16
// when bf16 is nonzero; head dim contiguous, 16-byte aligned rows),
// addressed through strides[12] = (batch, head, time) element strides of
// q, k, v, out in that order; lse [B,H,Tq] float32 contiguous.  form 0:
// the mma.sync kernel, float32 at D in {8, 16, 32, 64, 128} and bfloat16
// at {8, 16, 32}; form 1: the wgmma/TMA kernel, bfloat16 at D in {64, 128}
// (strides in bytes multiples of 16).  Another pairing returns
// cudaErrorNotSupported.
extern "C" int loco_flash_causal_fwd(const void* q, const void* k, const void* v,
                                     void* out, void* lse,
                                     const long long* strides, int B, int H,
                                     int Tq, int Tk, int D, int causal,
                                     float scale, int form, int bf16_operands, void* stream) {
  const Strides st = strides_of(strides);
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 1) {
    if (!bf16_operands || (D != 64 && D != 128)) return (int)cudaErrorNotSupported;
    return (int)(D == 64 ? launch_wgmma<64>(q, k, v, out, (float*)lse, st, B, H, Tq, Tk, causal,
                                            scale, s)
                         : launch_wgmma<128>(q, k, v, out, (float*)lse, st, B, H, Tq, Tk,
                                             causal, scale, s));
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      bf16_operands
          ? launch_d<bf16>(D, q, k, v, out, (float*)lse, st, B, H, Tq, Tk, causal, scale, s)
          : launch_d<float>(D, q, k, v, out, (float*)lse, st, B, H, Tq, Tk, causal, scale, s);
  return (int)e;
}

// The wgmma form's launch plan (WgPlan) for these arguments, into out[30]:
// blocks, key tiles of one (b, h), the key tile's rows; then for q, k, v in
// turn dims[4], byte strides[3], box rows; then a block's dynamic shared
// memory, threads and K/V stages (D in {64, 128}).
extern "C" void loco_flash_causal_wgmma_plan(const long long* strides, int B, int H, int Tq,
                                             int Tk, int D, int causal, long long* out) {
  const WgPlan p = wg_plan(strides_of(strides), B, H, Tq, Tk, D, causal);
  out[0] = p.grid;
  out[1] = p.tiles;
  out[2] = D == 64 ? wg::key_block<64>() : wg::key_block<128>();
  for (int i = 0; i < 3; ++i) {
    long long* o = out + 3 + 8 * i;
    for (int j = 0; j < 4; ++j) o[j] = (long long)p.dims[i][j];
    for (int j = 0; j < 3; ++j) o[4 + j] = (long long)p.strides[i][j];
    o[7] = p.box_rows[i];
  }
  out[27] = D == 64 ? wg::smem_bytes<64>() : wg::smem_bytes<128>();
  out[28] = wg::THREADS;
  out[29] = wg::STAGES;
}
