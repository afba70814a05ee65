// Relative-position + key-padding flash attention, forward (kernel B1).
//
// Replaces: loco_asr_tpu/ops/pallas/flash_attention.py::_flash_rel_kernel
// (launched by _flash_rel_forward), the SpeechT5 encoder self-attention:
//   s[i,j] = scale*q_i.k_j + scale*q_i.pe[clip(i-j, -L, L-1) + L]
//   keys j >= valid_len[b] masked (-1e30), optional causal mask (-1e30),
//   online softmax -> out [B,H,Tq,64] and the row logsumexp lse [B,H,Tq].
// With a zero 2-row pe it is the mask-only kernel.
//
// What bounds it on an H100: arithmetic.  The port runs float32 with TF32
// off, so the products run on the CUDA cores (67 TFLOP/s), and at the
// encoder's shapes (T ~ 250, head dim 64) every byte of q, k, v is reused
// ~T times from shared memory.  Per (b, h) the work is q.k^T and p.v
// (2*Tq*Tk*64 FLOP each) plus q.pe^T (2*Tq*2L*64 FLOP).
//
// Design: one block of 256 threads per (b*h, 64-query tile).  The TPU
// kernel's reversed-PE table, per-row log-step roll and iota-masked clip
// columns exist only because Mosaic has no gather; here the block computes
// qpe = scale * q_tile . pe^T once ([64, 2L] f32 in shared memory, staged
// through the key buffer 64 pe rows at a time) and indexes the band
// directly: rel(i, j) = qpe[i][clip(i-j, -L, L-1) + L].  It then walks
// 64-key tiles with an online softmax; each thread owns a 4x4 register
// micro-tile (rows ty+16a, columns tx+16b), row reductions are shuffles
// within 16 lanes, and shared rows are padded to 65 floats so the
// micro-tile reads are free of bank conflicts.  Tiles past the row's valid
// length and, when causal, above the diagonal are skipped: they would add
// exactly zero.  Keys past Tk (the ragged last tile) get -inf, so a row
// with valid_len 0 averages over exactly Tk keys, as the plain version
// does.  Simple first; wgmma/TMA is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;          // head dim
constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key rows per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int LD = D + 1;      // padded shared row stride
constexpr float NEG_INF = -1e30f;

__host__ __device__ inline int qpe_stride(int two_l) {
  // rows ty and ty+1 of one warp read 16 consecutive band columns each;
  // a stride of 15 mod 32 puts the two reads on disjoint banks
  return ((two_l + 31) / 32) * 32 + 15;
}

__host__ inline size_t smem_bytes(int two_l) {
  return (size_t)(4 * BQ * LD + BQ * qpe_stride(two_l)) * sizeof(float);
}

// rows [row0, row0 + 64) of a row-major [n, 64] matrix -> smem [64][LD];
// rows >= n are zero
__device__ inline void load_tile(float* dst, const float* __restrict__ src,
                                 int row0, int n) {
  for (int i = threadIdx.x; i < BQ * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      val = reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D)[c4];
    float* d = dst + r * LD + c4 * 4;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

// s[a][b] = sum_d A[ty+16a][d] * Bm[tx+16b][d]
__device__ inline void tile_dot(const float* A, const float* Bm, float s[4][4],
                                int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * LD + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = Bm[(tx + 16 * b) * LD + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
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

__global__ void __launch_bounds__(THREADS)
flash_rel_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ pe,
                     const int* __restrict__ valid_len, float* __restrict__ out,
                     float* __restrict__ lse, int H, int Tq, int Tk, int two_l,
                     int causal, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                 // [BQ][LD]
  float* sK = sQ + BQ * LD;         // [BK][LD]; also stages pe rows
  float* sV = sK + BK * LD;         // [BK][LD]
  float* sP = sV + BK * LD;         // [BQ][LD] probabilities
  float* sQPE = sP + BQ * LD;       // [BQ][qs] scaled q.pe^T
  const int qs = qpe_stride(two_l);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int L = two_l / 2;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const int vl = max(0, min(valid_len[b], Tk));

  load_tile(sQ, qb, q0, Tq);
  for (int m0 = 0; m0 < two_l; m0 += BK) {
    __syncthreads();                // sQ loaded / previous chunk consumed
    load_tile(sK, pe, m0, two_l);
    __syncthreads();
    float s[4][4];
    tile_dot(sQ, sK, s, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int m = m0 + tx + 16 * bb;
        if (m < two_l) sQPE[(ty + 16 * a) * qs + m] = s[a][bb] * scale;
      }
  }

  float m_i[4], l_i[4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = NEG_INF;
    l_i[a] = 0.f;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.f;
  }

  int nk = (Tk + BK - 1) / BK;
  if (vl > 0) {                     // later tiles would add exactly zero
    nk = min(nk, (vl + BK - 1) / BK);
    if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                // sK/sV/sP free, sQPE complete
    load_tile(sK, kb, k0, Tk);
    load_tile(sV, vb, k0, Tk);
    __syncthreads();

    float s[4][4];
    tile_dot(sQ, sK, s, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const int i = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = k0 + tx + 16 * bb;
        const int m = min(max(i - j, -L), L - 1) + L;
        float val = fmaf(s[a][bb], scale, sQPE[r * qs + m]);
        if (j >= vl || (causal && j > i)) val = NEG_INF;
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
        sP[r * LD + tx + 16 * bb] = p;
        sum += p;
      }
      sum = row_sum(sum);
      l_i[a] = alpha * l_i[a] + sum;
      m_i[a] = m_new;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) acc[a][bb] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = sP[(ty + 16 * a) * LD + j];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) vv[bb] = sV[j * LD + tx + 16 * bb];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(pv[a], vv[bb], acc[a][bb]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= Tq) continue;
    const float denom = fmaxf(l_i[a], 1e-30f);
    float* o = out + ((size_t)bh * Tq + i) * D;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) o[tx + 16 * bb] = acc[a][bb] / denom;
    if (tx == 0) lse[(size_t)bh * Tq + i] = m_i[a] + logf(denom);
  }
}

}  // namespace

extern "C" size_t loco_flash_rel_smem_bytes(int two_l) { return smem_bytes(two_l); }

// q [B,H,Tq,64], k/v [B,H,Tk,64], pe [two_l,64] (all float32, contiguous,
// 16-byte aligned), valid_len [B] int32 -> out [B,H,Tq,64], lse [B,H,Tq].
extern "C" int loco_flash_rel_fwd(const void* q, const void* k, const void* v,
                                  const void* pe, const void* valid_len,
                                  void* out, void* lse, int B, int H, int Tq,
                                  int Tk, int two_l, int causal, float scale,
                                  void* stream) {
  const size_t smem = smem_bytes(two_l);
  cudaError_t e = cudaFuncSetAttribute(
      flash_rel_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_rel_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)pe,
      (const int*)valid_len, (float*)out, (float*)lse, H, Tq, Tk, two_l,
      causal, scale);
  return (int)cudaGetLastError();
}
