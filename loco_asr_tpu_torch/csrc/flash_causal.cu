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
// What bounds it on an H100: arithmetic.  The port runs float32 with TF32
// off, so q.k^T and p.v run on the CUDA cores (67 TFLOP/s); at the GPT-2
// scoring shape ([8, 1024] tokens, 12 heads of 64, causal) it is 12.9
// GFLOP against 25 MB of q, k, v, out and lse, so ~500 FLOP per byte.
//
// Design: one block of 256 threads per (b*h, 64-query tile), walking
// 64-key tiles with an online softmax.  Each thread owns a 4x4 register
// micro-tile of the scores (rows ty+16a, columns tx+16b) and D/16 output
// columns of its 4 rows; row reductions are shuffles within 16 lanes and
// shared rows are padded to an odd stride so both products read shared
// memory without bank conflicts.  With causal, key tiles wholly above the
// diagonal are never loaded, so the work done is the bound's count plus
// the diagonal tiles' upper halves; blocks take the query tiles in
// reverse order so the longest ones start first.  Keys past Tk (the ragged last tile) get
// -inf and rows past Tq are not stored.  The head dim is a template
// parameter (8, 16, 32, 64, 128).  Simple first; wgmma/TMA and bf16
// operands are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key rows per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int LDP = BK + 1;    // padded stride of the probability tile
constexpr float NEG_INF = -1e30f;

struct Strides {               // element strides of (batch, head, time)
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

template <int D>
__host__ __device__ constexpr int ld() { return D + 1; }

template <int D>
__host__ constexpr size_t smem_bytes() {
  return (size_t)(BQ * ld<D>() + 2 * BK * ld<D>() + BQ * LDP) * sizeof(float);
}

// rows [row0, row0 + 64) of a strided [n, D] matrix -> smem [64][D+1];
// rows >= n are zero
template <int D>
__device__ inline void load_tile(float* dst, const float* __restrict__ src,
                                 long long row_stride, int row0, int n) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < BK * C4; i += THREADS) {
    const int r = i / C4, c4 = i % C4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      val = reinterpret_cast<const float4*>(src + (row0 + r) * row_stride)[c4];
    float* d = dst + r * ld<D>() + c4 * 4;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

// reductions over the 16 lanes (tx) that share a row
__device__ inline float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_causal_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, Strides st, int H, int Tq,
                        int Tk, int causal, float scale) {
  constexpr int LD = ld<D>();
  constexpr int DC = (D + 15) / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                   // [BQ][LD]
  float* sK = sQ + BQ * LD;           // [BK][LD]
  float* sV = sK + BK * LD;           // [BK][LD]
  float* sP = sV + BK * LD;           // [BQ][LDP] probabilities

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest blocks first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;

  load_tile<D>(sQ, qb, st.qt, q0, Tq);

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = NEG_INF;
    l_i[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);   // tiles above: all masked

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                  // sQ loaded / sK, sV, sP consumed
    load_tile<D>(sK, kb, st.kt, k0, Tk);
    load_tile<D>(sV, vb, st.vt, k0, Tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sQ[(ty + 16 * a) * LD + d];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) bv[bb] = sK[(tx + 16 * bb) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) s[a][bb] = fmaf(av[a], bv[bb], s[a][bb]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const int i = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = k0 + tx + 16 * bb;
        float val = s[a][bb] * scale;
        if (causal && j > i) val = NEG_INF;
        if (j >= Tk) val = -INFINITY;
        s[a][bb] = val;
        mx = fmaxf(mx, val);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m_i[a], mx);
      const float alpha = expf(m_i[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const float p = expf(s[a][bb] - m_new);
        sP[r * LDP + tx + 16 * bb] = p;
        sum += p;
      }
      sum = row_sum(sum);
      l_i[a] = alpha * l_i[a] + sum;
      m_i[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

    if (D % 16 == 0 || tx < D) {
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        float pv[4], vv[DC];
#pragma unroll
        for (int a = 0; a < 4; ++a) pv[a] = sP[(ty + 16 * a) * LDP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) vv[c] = sV[j * LD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= Tq) continue;
    const float denom = fmaxf(l_i[a], 1e-30f);
    if (D % 16 == 0 || tx < D) {
      float* o = out + b * st.ob + h * st.oh + i * st.ot;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[tx + 16 * c] = acc[a][c] / denom;
    }
    if (tx == 0) lse[(long long)bh * Tq + i] = m_i[a] + logf(denom);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* lse, const Strides& st, int B, int H, int Tq, int Tk,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_causal_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_causal_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, lse, st, H, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q [.., Tq, D], k/v [.., Tk, D], out [.., Tq, D] (float32, head dim
// contiguous, 16-byte aligned rows), addressed through strides[12] =
// (batch, head, time) element strides of q, k, v, out in that order;
// lse [B,H,Tq] contiguous.  D in {8, 16, 32, 64, 128}.
extern "C" int loco_flash_causal_fwd(const void* q, const void* k, const void* v,
                                     void* out, void* lse,
                                     const long long* strides, int B, int H,
                                     int Tq, int Tk, int D, int causal,
                                     float scale, void* stream) {
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float *of = (float*)out, *lf = (float*)lse;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (D) {
    case 8: e = launch<8>(qf, kf, vf, of, lf, st, B, H, Tq, Tk, causal, scale, s); break;
    case 16: e = launch<16>(qf, kf, vf, of, lf, st, B, H, Tq, Tk, causal, scale, s); break;
    case 32: e = launch<32>(qf, kf, vf, of, lf, st, B, H, Tq, Tk, causal, scale, s); break;
    case 64: e = launch<64>(qf, kf, vf, of, lf, st, B, H, Tq, Tk, causal, scale, s); break;
    case 128: e = launch<128>(qf, kf, vf, of, lf, st, B, H, Tq, Tk, causal, scale, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}
