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
// 128 of the 255 registers a thread may hold; no main path runs it.  wgmma
// and TMA are later work: TF32 wgmma takes both operands K-major, so p.v
// would need V transposed in shared memory, while mma.sync reads any layout.
//
// The bf16 form (the element type T is a template parameter; the f32
// instantiation is the kernel described above, unchanged) is the JAX
// kernels' bf16 path: q, k, v and out in bf16, products on bf16 operands
// with f32 accumulation, p rounded to bf16 before p.v (p.astype(v.dtype)),
// the softmax, the row sums and lse in f32.  Each product is one
// m16n8k16 bf16 mma.sync (bf16_mma.cuh) at 989 TFLOP/s peak, where the f32
// form spends three TF32 passes at 495: the same [8, 1024, 12, 64] call
// needs a sixth of the f32 form's tensor-core time and half its bytes.
// Its fragments need no split: q's A fragments are loaded as packed pairs,
// K's B fragments are pairs of one row (rows of D + 8 bf16, conflict-free),
// V's pairs of two rows are packed from two 2-byte reads, and the C
// fragments of two adjacent score blocks are the A fragment of a 16-key
// p.v step as they stand.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "bf16_mma.cuh"
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

// shared row stride of K and V: 16-byte aligned rows, fragment reads in
// distinct banks (D + 4 floats, see above; D + 8 bf16, 4g + t mod 32 words
// for the pairs of K's rows and 8t + g / 2 for V's columns at D = 64)
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
    case 64: return launch<T, 64>(q, k, v, out, lse, st, B, H, Tq, Tk, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, st, B, H, Tq, Tk, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [.., Tq, D], k/v [.., Tk, D], out [.., Tq, D] (float32, or bfloat16
// when bf16 is nonzero; head dim contiguous, 16-byte aligned rows),
// addressed through strides[12] = (batch, head, time) element strides of
// q, k, v, out in that order; lse [B,H,Tq] float32 contiguous.  D in
// {8, 16, 32, 64, 128}.
extern "C" int loco_flash_causal_fwd(const void* q, const void* k, const void* v,
                                     void* out, void* lse,
                                     const long long* strides, int B, int H,
                                     int Tq, int Tk, int D, int causal,
                                     float scale, int bf16_operands, void* stream) {
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      bf16_operands
          ? launch_d<bf16>(D, q, k, v, out, (float*)lse, st, B, H, Tq, Tk, causal, scale, s)
          : launch_d<float>(D, q, k, v, out, (float*)lse, st, B, H, Tq, Tk, causal, scale, s);
  return (int)e;
}
