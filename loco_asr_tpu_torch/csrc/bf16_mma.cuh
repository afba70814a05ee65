// Helpers of the bf16 forms of the mma.sync flash kernels: B1
// (csrc/flash_rel.cu), B3/B4 (csrc/flash_rel_bwd.cu) and B5/B6's form 0
// at head dims 8-32 (csrc/flash_causal.cu; bf16 at 64 and 128 runs its
// wgmma form, hopper.cuh), beside the three-pass TF32 helpers of
// tf32_mma.cuh: one-pass bf16 products on mma.sync with f32 accumulation,
// operands loaded as packed pairs.  Included, never compiled on its own.
//
// The JAX kernels run their products on operands of the input dtype with
// preferred_element_type=f32; a product of two bf16 values is exact in f32,
// so one bf16 mma.sync with f32 accumulation computes what they compute, up
// to the order of the sums.  A value that enters a product after f32
// arithmetic (p, ds) is rounded to bf16 first, to nearest even, as JAX's
// astype does.
//
// m16n8k16 fragments (PTX ISA, "Matrix fragments for mma.m16n8k16",
// .bf16), g = lane / 4, t = lane % 4, each register a pair of columns
// (lower index in the low half):
//   A (16 x 16, row): a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..)
//   B (16 x 8, col):  b0 (2t.., g), b1 (2t + 8.., g)
//   C (16 x 8):       as m16n8k8: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// so the C fragments of two adjacent 8-column blocks are, as they stand,
// the A fragment of a 16-deep product over those columns (flash-attention-2's
// p.v without a shuffle).  m16n8k8 (head dim 8) takes a0, a1 and b0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

// two bf16 at p (4-byte aligned) as one register
__device__ __forceinline__ unsigned ld_pair(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// bf16 at lo and hi as one register, lo in the low half
__device__ __forceinline__ unsigned pack_pair(const bf16* lo, const bf16* hi) {
  return (unsigned)*reinterpret_cast<const unsigned short*>(lo) |
         ((unsigned)*reinterpret_cast<const unsigned short*>(hi) << 16);
}

// (lo, hi) rounded to bf16, to nearest even, as one register
__device__ __forceinline__ unsigned round_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// c += a.b, one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b, one m16n8k8 bf16 product (a0, a1, b0 of the k16 layout)
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], const unsigned (&a)[4],
                                            const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

// 16 rows x D of an A operand in registers, as packed pairs; D / 16
// k-steps of 16 (one of 8 at D = 8)
template <int D>
struct Bf16Rows {
  static constexpr int KS = D < 16 ? 1 : D / 16;
  unsigned a[KS][4];

  // rows at p0 and p1 (zero where !in0 / !in1), this lane's columns
  __device__ __forceinline__ void load(const bf16* p0, const bf16* p1, bool in0, bool in1,
                                       int t) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = 16 * kk + 2 * t;
      a[kk][0] = in0 ? ld_pair(p0 + c) : 0u;
      a[kk][1] = in1 ? ld_pair(p1 + c) : 0u;
      a[kk][2] = D >= 16 && in0 ? ld_pair(p0 + c + 8) : 0u;
      a[kk][3] = D >= 16 && in1 ? ld_pair(p1 + c + 8) : 0u;
    }
  }

  // the same rows from a shared [*, LD] tile; p at the lane's row g
  template <int LD>
  __device__ __forceinline__ void load_smem(const bf16* p, int t) {
    load(p, p + 8 * LD, true, true, t);
  }

  // c[n] += a . B^T, B the rows 8n + g of a shared [*, LD] tile (columns
  // are the head dim); block n of c holds columns 8n + {2t, 2t + 1}
  template <int NB, int LD>
  __device__ __forceinline__ void mma_bt(float (&c)[NB][4], const bf16* sB, int g,
                                         int t) const {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const bf16* br = sB + (8 * n + g) * LD + 16 * kk + 2 * t;
        unsigned b[2];
        b[0] = ld_pair(br);
        if (D >= 16) {
          b[1] = ld_pair(br + 8);
          mma_bf16(c[n], a[kk], b);
        } else {
          b[1] = 0u;
          mma_bf16_k8(c[n], a[kk], b);
        }
      }
    }
  }
};

// acc += P . B: P [16, 8 NB] in registers in the C layout of mma_bt (NB
// even), rounded to bf16 here; B the first 8 NB rows of a shared [*, LD]
// tile, read as pairs of rows; acc holds NN column blocks of 8 from column
// 8 n0 on (all D columns by default)
template <int NB, int D, int LD, int NN = D / 8>
__device__ __forceinline__ void mma_p_b_bf16(float (&acc)[NN][4], const float (&p)[NB][4],
                                             const bf16* sB, int g, int t, int n0 = 0) {
  static_assert(NB % 2 == 0, "P is taken 16 columns at a time");
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    const unsigned a[4] = {round_pair(p[2 * kk][0], p[2 * kk][1]),
                           round_pair(p[2 * kk][2], p[2 * kk][3]),
                           round_pair(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           round_pair(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const bf16* br = sB + (16 * kk + 2 * t) * LD + g + 8 * n0;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const unsigned b[2] = {pack_pair(br + 8 * n, br + LD + 8 * n),
                             pack_pair(br + 8 * LD + 8 * n, br + 9 * LD + 8 * n)};
      mma_bf16(acc[n], a, b);
    }
  }
}

}  // namespace
