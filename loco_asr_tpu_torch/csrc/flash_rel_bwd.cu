// Relative-position + key-padding flash attention, backward (kernels B3, B4).
//
// Replaces: loco_asr_tpu/ops/pallas/flash_attention.py::_rel_bwd_dq_kernel
// (B3) and ::_rel_bwd_dkv_kernel (B4), launched by
// _flash_rel_backward_pallas: the gradient of kernel B1 (csrc/flash_rel.cu).
// From the forward's lse and delta = rowsum(g * out) they recompute
//   s[i,j] = scale*q_i.k_j + scale*q_i.pe[clip(i-j, -L, L-1) + L]
//   p = exp(s - lse) (0 where key j >= valid_len[b] or, causal, j > i)
//   ds = p * (g_i.v_j - delta_i)
// and produce
//   B3: dq_content = scale * ds.k   and the band gradient
//       dqpe[i, m] = sum_{j: clip(i-j)+L == m} ds[i, j]   ([B,H,Tq,2L])
//   B4: dv = p^T.g,  dk = scale * ds^T.q
// The caller adds dq += scale * dqpe.pe and dpe = scale * sum dqpe^T.q with
// torch.matmul, as _flash_rel_backward_pallas does outside its Pallas calls.
//
// What bounds them on an H100: arithmetic.  float32 with TF32 off runs the
// products on the CUDA cores (67 TFLOP/s); every q/k/v/g byte is reused
// ~T times from shared memory.  Per (b, h): B3 does q.pe^T (2*Tq*2L*64) and
// three Tq*Tk*64 products, B4 a q-tile x pe-band product per tile pair and
// four Tq*Tk*64 products.
//
// Design.  The TPU kernels' raw-ds accumulator, block_k == Wp constraint
// and log-step roll shear exist only because Mosaic has no gather or
// scatter.  Here:
// * B3: one block of 256 threads per (b*h, 64-query tile), looping over
//   64-key tiles, each thread a 4x4 register micro-tile as in B1.  For a
//   fixed row i, j -> i - j is one-to-one inside the band, so every
//   interior band cell (0 < m < 2L-1) receives exactly one ds value over
//   the whole loop: the thread that owns (i, j) stores it straight into
//   the zero-initialised dqpe in device memory (16 lanes of a row write 16
//   consecutive floats).  The two clip columns (m = 0, m = 2L-1) are row
//   sums kept in registers, reduced over the 16 lanes of a row at the end.
//   The full scaled q.pe^T row block is built once in shared memory, as in
//   B1.  The ds tile reuses the V buffer once dp has been formed.
// * B4: one block per (b*h, 64-key tile), looping over 64-query tiles.  A
//   tile pair touches at most 127 consecutive pe rows (i - j spans
//   [q0-k0-63, q0-k0+63], clipped), so the block forms only that band,
//   q_tile . pe[m_lo..m_hi]^T, in shared memory (pe rows staged through the
//   P buffer).  p and ds of the tile go to shared memory and the block
//   accumulates dv and dk with the transposed micro-tile (key rows x head
//   dims) in registers.
// * Causal: B3 stops at the diagonal tile, B4 starts at it; both stop at
//   the key tile holding valid_len (later tiles are all masked).  Rows >= Tq
//   are not stored and keys >= Tk are masked, so no padding copies are
//   needed and Tq != Tk works.
// Simple first: CUDA-core FMAs, no wgmma or TMA yet.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"   // allow_smem_once

namespace {

constexpr int D = 64;          // head dim
constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // key rows per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int LD = D + 1;      // padded shared row stride
constexpr int BAND = BQ + BK - 1;   // pe rows one tile pair can touch

__host__ __device__ inline int band_stride(int width) {
  // rows ty and ty+1 of one warp read 16 consecutive band columns each;
  // a stride of 15 mod 32 puts the two reads on disjoint banks
  return ((width + 31) / 32) * 32 + 15;
}

__host__ inline size_t dq_smem_bytes(int two_l) {
  return (size_t)(4 * BQ * LD + BQ * band_stride(two_l)) * sizeof(float);
}

__host__ inline size_t dkv_smem_bytes() {
  return (size_t)(6 * BQ * LD + BQ * band_stride(BAND)) * sizeof(float);
}

// rows [row0, row0 + 64) of a row-major [*, 64] matrix -> smem [64][LD];
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

// sum over the 16 lanes (tx) that share a row
__device__ inline float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline int band_index(int i, int j, int L) {
  return min(max(i - j, -L), L - 1) + L;
}

// B3: dq_content [B,H,Tq,64] and dqpe [B,H,Tq,2L] (dqpe zero on entry)
__global__ void __launch_bounds__(THREADS)
flash_rel_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ pe,
                        const int* __restrict__ valid_len,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ g, float* __restrict__ dq,
                        float* __restrict__ dqpe, int H, int Tq, int Tk,
                        int two_l, int causal, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                 // [BQ][LD]
  float* sG = sQ + BQ * LD;         // [BQ][LD]
  float* sK = sG + BQ * LD;         // [BK][LD]; also stages pe rows
  float* sV = sK + BK * LD;         // [BK][LD]; then the tile's ds
  float* sQPE = sV + BK * LD;       // [BQ][qs] scaled q.pe^T
  const int qs = band_stride(two_l);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int L = two_l / 2;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  float* dqpe_b = dqpe + (size_t)bh * Tq * two_l;
  const int vl = max(0, min(valid_len[b], Tk));

  load_tile(sQ, q + (size_t)bh * Tq * D, q0, Tq);
  load_tile(sG, g + (size_t)bh * Tq * D, q0, Tq);
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

  float lse_r[4], delta_r[4], lo[4], hi[4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    lse_r[a] = i < Tq ? lse[(size_t)bh * Tq + i] : 0.f;
    delta_r[a] = i < Tq ? delta[(size_t)bh * Tq + i] : 0.f;
    lo[a] = hi[a] = 0.f;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.f;
  }

  int nk = (vl + BK - 1) / BK;      // tiles past valid_len are all masked
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                // sK/sV free, sQPE complete
    load_tile(sK, kb, k0, Tk);
    load_tile(sV, vb, k0, Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot(sQ, sK, s, ty, tx);
    tile_dot(sG, sV, dp, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const int i = q0 + r;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = k0 + tx + 16 * bb;
        const int m = band_index(i, j, L);
        float ds = 0.f;
        if (i < Tq && j < vl && !(causal && j > i)) {
          const float p = expf(fmaf(s[a][bb], scale, sQPE[r * qs + m]) - lse_r[a]);
          ds = p * (dp[a][bb] - delta_r[a]);
        }
        s[a][bb] = ds;
        if (m == 0) lo[a] += ds;
        else if (m == two_l - 1) hi[a] += ds;
        else if (i < Tq) dqpe_b[(size_t)i * two_l + m] = ds;   // sole writer
      }
    }
    __syncthreads();                // every read of sV is done
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) sV[(ty + 16 * a) * LD + tx + 16 * bb] = s[a][bb];
    __syncthreads();

#pragma unroll 8
    for (int jj = 0; jj < BK; ++jj) {
      float dv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = sV[(ty + 16 * a) * LD + jj];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) kv[bb] = sK[jj * LD + tx + 16 * bb];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(dv[a], kv[bb], acc[a][bb]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float lo_sum = row_sum(lo[a]);
    const float hi_sum = row_sum(hi[a]);
    const int i = q0 + ty + 16 * a;
    if (i >= Tq) continue;
    float* o = dq + ((size_t)bh * Tq + i) * D;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) o[tx + 16 * bb] = acc[a][bb] * scale;
    if (tx == 0) {
      dqpe_b[(size_t)i * two_l] = lo_sum;
      dqpe_b[(size_t)i * two_l + two_l - 1] = hi_sum;
    }
  }
}

// B4: dk, dv [B,H,Tk,64]
__global__ void __launch_bounds__(THREADS)
flash_rel_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ pe,
                         const int* __restrict__ valid_len,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ g, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Tq, int Tk,
                         int two_l, int causal, float scale) {
  extern __shared__ float smem[];
  float* sK = smem;                 // [BK][LD]
  float* sV = sK + BK * LD;         // [BK][LD]
  float* sQ = sV + BK * LD;         // [BQ][LD]
  float* sG = sQ + BQ * LD;         // [BQ][LD]
  float* sP = sG + BQ * LD;         // [BQ][LD] p; also stages pe rows
  float* sDS = sP + BQ * LD;        // [BQ][LD] ds
  float* sBand = sDS + BQ * LD;     // [BQ][bs] scaled q.pe[m_lo..m_hi]^T
  const int bs = band_stride(BAND);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int L = two_l / 2;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* gb = g + (size_t)bh * Tq * D;
  const int vl = max(0, min(valid_len[b], Tk));

  // micro-tile of the accumulators: key rows ty+16a, head dims tx+16bb
  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) dk_acc[a][bb] = dv_acc[a][bb] = 0.f;

  if (k0 < vl) {                    // else every key of the tile is masked
    load_tile(sK, k + (size_t)bh * Tk * D, k0, Tk);
    load_tile(sV, v + (size_t)bh * Tk * D, k0, Tk);
    const int nq = (Tq + BQ - 1) / BQ;
    for (int qt = causal ? k0 / BQ : 0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();              // previous tile's accumulation is done
      load_tile(sQ, qb, q0, Tq);
      load_tile(sG, gb, q0, Tq);
      const int m_lo = band_index(q0, k0 + BK - 1, L);
      const int m_hi = band_index(q0 + BQ - 1, k0, L);
      const int nb = m_hi - m_lo + 1;
      for (int c0 = 0; c0 < nb; c0 += BQ) {
        __syncthreads();            // sQ loaded / previous chunk consumed
        load_tile(sP, pe, m_lo + c0, m_hi + 1);
        __syncthreads();
        float s[4][4];
        tile_dot(sQ, sP, s, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int c = c0 + tx + 16 * bb;
            if (c < nb) sBand[(ty + 16 * a) * bs + c] = s[a][bb] * scale;
          }
      }
      __syncthreads();              // sBand complete, sP free

      float lse_r[4], delta_r[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = q0 + ty + 16 * a;
        lse_r[a] = i < Tq ? lse[(size_t)bh * Tq + i] : 0.f;
        delta_r[a] = i < Tq ? delta[(size_t)bh * Tq + i] : 0.f;
      }
      float s[4][4], dp[4][4];
      tile_dot(sQ, sK, s, ty, tx);
      tile_dot(sG, sV, dp, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        const int i = q0 + r;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int c = tx + 16 * bb;
          const int j = k0 + c;
          float p = 0.f, ds = 0.f;
          if (i < Tq && j < vl && !(causal && j > i)) {
            const float rel = sBand[r * bs + band_index(i, j, L) - m_lo];
            p = expf(fmaf(s[a][bb], scale, rel) - lse_r[a]);
            ds = p * (dp[a][bb] - delta_r[a]);
          }
          sP[r * LD + c] = p;
          sDS[r * LD + c] = ds;
        }
      }
      __syncthreads();

#pragma unroll 8
      for (int rr = 0; rr < BQ; ++rr) {
        float pv[4], dsv[4], gv[4], qv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = sP[rr * LD + ty + 16 * a];
          dsv[a] = sDS[rr * LD + ty + 16 * a];
        }
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          gv[bb] = sG[rr * LD + tx + 16 * bb];
          qv[bb] = sQ[rr * LD + tx + 16 * bb];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            dv_acc[a][bb] = fmaf(pv[a], gv[bb], dv_acc[a][bb]);
            dk_acc[a][bb] = fmaf(dsv[a], qv[bb], dk_acc[a][bb]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= Tk) continue;
    float* dko = dk + ((size_t)bh * Tk + j) * D;
    float* dvo = dv + ((size_t)bh * Tk + j) * D;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      dko[tx + 16 * bb] = dk_acc[a][bb] * scale;
      dvo[tx + 16 * bb] = dv_acc[a][bb];
    }
  }
}

}  // namespace

extern "C" size_t loco_flash_rel_bwd_smem_bytes(int two_l) {
  const size_t a = dq_smem_bytes(two_l), b = dkv_smem_bytes();
  return a > b ? a : b;
}

// q [B,H,Tq,64], k/v [B,H,Tk,64], pe [two_l,64], valid_len [B] int32,
// lse/delta [B,H,Tq], g [B,H,Tq,64] (all float32 but valid_len, contiguous,
// 16-byte aligned) -> dq_content [B,H,Tq,64], dqpe [B,H,Tq,two_l] (zero on
// entry), dk/dv [B,H,Tk,64].  Launches B3 then B4 on ``stream``.
extern "C" int loco_flash_rel_bwd(const void* q, const void* k, const void* v,
                                  const void* pe, const void* valid_len,
                                  const void* lse, const void* delta,
                                  const void* g, void* dq, void* dqpe, void* dk,
                                  void* dv, int B, int H, int Tq, int Tk,
                                  int two_l, int causal, float scale,
                                  void* stream) {
  const size_t smem_dq = dq_smem_bytes(two_l), smem_dkv = dkv_smem_bytes();
  // each kernel's dynamic shared-memory limit is raised to the device's
  // opt-in maximum once per device
  static std::atomic<unsigned long long> done_dq{0}, done_dkv{0};
  cudaError_t e = allow_smem_once(flash_rel_bwd_dq_kernel, 0, done_dq);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem_once(flash_rel_bwd_dkv_kernel, 0, done_dkv);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  flash_rel_bwd_dq_kernel<<<dim3((Tq + BQ - 1) / BQ, B * H), THREADS, smem_dq, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)pe,
      (const int*)valid_len, (const float*)lse, (const float*)delta,
      (const float*)g, (float*)dq, (float*)dqpe, H, Tq, Tk, two_l, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_rel_bwd_dkv_kernel<<<dim3((Tk + BK - 1) / BK, B * H), THREADS, smem_dkv, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)pe,
      (const int*)valid_len, (const float*)lse, (const float*)delta,
      (const float*)g, (float*)dk, (float*)dv, H, Tq, Tk, two_l, causal, scale);
  return (int)cudaGetLastError();
}
