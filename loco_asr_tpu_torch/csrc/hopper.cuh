// Hopper helpers of the bf16 wgmma forms of the causal flash forward
// (csrc/flash_causal.cu) and of the rel-pos flash forward and backward
// (csrc/flash_rel.cu, csrc/flash_rel_bwd.cu): mbarriers, TMA tensor copies,
// warpgroup matrix products (wgmma) and their shared-memory descriptors,
// register handover between warpgroups (setmaxnreg), the band window of a
// rel-pos tile, and the host-side tensor-map encoder.  Included, never
// compiled on its own; sm_90a only (wgmma, setmaxnreg).
//
// Layout convention: every operand tile in shared memory is a stack of
// [rows][64] bf16 "halves" (one 128-byte row each), written by TMA with
// the 128-byte swizzle: within each 1024-byte group of 8 rows, the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8).  Tiles start 1024-byte
// aligned, so the descriptors' base offset is 0.  A K-major operand
// (Q, K: the reduction dim contiguous) advances 32 bytes a k16 step inside
// the swizzle span; an MN-major one (V, transposed by the instruction)
// advances 16 rows (2048 bytes) a step.  (PTX ISA, "Matrix Descriptor
// Format" and "Shared Memory Matrix Layout"; the same fields as CUTLASS's
// GmmaDescriptor.)

#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only: no driver call is linked)
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bf16_mma.cuh"   // bf16, round_pair
#include "tf32_mma.cuh"   // quad_sum

namespace {

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
// the rel-pos table's column of i - j is clip(i - j, L) + L
__host__ __device__ constexpr int clip(int d, int L) { return imin(imax(d, -L), L - 1); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// barrier inits visible to the async proxy (TMA) and the other threads
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Cycles after which a wait traps (~35 s at the H100's 1.98 GHz boost): a
// barrier that never completes -- a deadlock -- ends the launch with an
// error instead of hanging the process.  No legitimate wait comes near it.
constexpr long long WAIT_TRAP_CYCLES = 1ll << 36;

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > WAIT_TRAP_CYCLES) __trap();
}

// ---- TMA ----------------------------------------------------------------

// the map's descriptor fetched ahead of its first copy
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// box of the 4-D map at (c0, c1, c2, c3) -> dst, completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// barrier `id` (1-15) over `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- warpgroup register handover ---------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// 2^x, flushing subnormal results to zero (one MUFU.EX2; exp2f adds the
// subnormal handling)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma --------------------------------------------------------------

// descriptor of a 128-byte-swizzled tile at p (1024-byte aligned rows
// groups): leading and stride byte offsets as the PTX ISA defines them
// (K-major: lbo unused, sbo = 1024, the next 8 rows; MN-major: lbo = the
// next 64-column half, sbo = 1024, the next 8 rows of the reduction dim)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving register accesses across a wgmma issue or
// wait (the registers' values change asynchronously in between)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Accumulator fragment of m64nNk16 (f32): warp w of the warpgroup holds
// rows 16w..16w+15; with g = lane / 4, t = lane % 4, d[4j + e] is row
// 16w + g + 8 (e / 2), column 8j + 2t + e % 2.  The A fragment in
// registers (bf16) is mma.sync's m16n8k16 A fragment over the same rows,
// so the accumulators of columns 16kk..16kk+15, rounded to bf16 pairs,
// are A's k-step kk as they stand (d[8kk..8kk+7] -> a0..a3).

// d (+)= A.B, m64n64k16, A and B K-major in shared memory (descriptors)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A.B, m64n128k16, A and B K-major in shared memory (descriptors)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A.B, m64n64k16, A in registers (the k16 A fragment), B MN-major in
// shared memory (descriptor, transposed)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d += A.B, m64n128k16, A in registers (the k16 A fragment), B MN-major in
// shared memory (descriptor, transposed)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// an accumulator fragment [8 KS] rounded to bf16 pairs: the A fragments of
// KS k-steps of 16 over its columns, as they stand (the layout above)
template <int KS>
__device__ __forceinline__ void pack_bf16_a(uint32_t (&a)[KS][4], const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = round_pair(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// d = A.B^T over a reduction dim of D (D / 16 k-steps, 32 bytes apart
// inside a 64-column half), A (64 rows) and B (N rows) K-major tiles of
// [D / 64][rows][64] bf16 at a and b, whose halves are a_half and b_half
// bytes apart
template <int D, int N>
__device__ __forceinline__ void wgmma_ss_kmajor(float (&d)[N / 2], const void* a, int a_half,
                                                const void* b, int b_half) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  const char* pa = static_cast<const char*>(a);
  const char* pb = static_cast<const char*>(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = gmma_desc(pa + (kk / 4) * a_half + 32 * (kk % 4), 16, 1024);
    const uint64_t db = gmma_desc(pb + (kk / 4) * b_half + 32 * (kk % 4), 16, 1024);
    if constexpr (N == 64)
      wgmma_m64n64k16_ss(d, da, db, kk > 0);
    else
      wgmma_m64n128k16_ss(d, da, db, kk > 0);
  }
}

// d += A.B over KS k-steps of 16: A in registers (k16 A fragments), B an
// MN-major tile of [D / 64][rows][64] bf16 at b (rows: the reduction dim,
// read from row 0 on; halves b_half bytes apart), transposed by the
// instruction
template <int D, int KS>
__device__ __forceinline__ void wgmma_rs_mnmajor(float (&d)[D / 2], const uint32_t (&a)[KS][4],
                                                 const void* b, int b_half) {
  static_assert(D == 64 || D == 128, "D is 64 or 128");
  const char* pb = static_cast<const char*>(b);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t desc = gmma_desc(pb + 2048 * kk, b_half, 1024);
    if constexpr (D == 64)
      wgmma_m64n64k16_rs(d, a[kk], desc, 1);
    else
      wgmma_m64n128k16_rs(d, a[kk], desc, 1);
  }
}

// ---- the band window of a rel-pos tile (B1 and B3 form 1; B4's transposed)
//
// The band term of a tile of 64 query rows from q0 and 64 keys from k0 is
// c2 * q_i . pe[clip(i - j, L) + L]: i - j spans 127 values, so the pairs
// reach at most 127 consecutive pe rows.  The window is the 128 rows from
// the first one they reach (band_first, clipped, so a TMA copy never starts
// before row 0; rows past 2L - 1 are TMA's zero fill and never read).  Its
// product with the tile's Q is one ss wgmma (m64n128, band_product), whose
// accumulators go, scaled by c2 = scale * log2 e, to a row-major f32 window
// [64][LD] in shared memory (band_store): a warp writes rows
// 16 w .. 16 w + 15 of it, the rows its own s fragment holds, so a
// __syncwarp orders a warp's stores before its reads.  The pair (i, j)
// reads column clip(i - j, L) + L - band_first.  A tile whose every pair is
// past one clip edge (band_clipped) needs no window: each of its rows reads
// one of the two edge columns c2 * q_i . pe[0] and c2 * q_i . pe[2L - 1]
// (BandEdges, computed once a block).  So a block's shared memory is the
// same at every L.

constexpr int BAND_ROWS = 128;   // pe rows of a window: >= 64 + 64 - 1
// f32 row strides of a window in shared memory: BAND_LD (= 8 mod 32) makes
// band_store's float2 stores conflict-free (a quarter warp's 8 rows at
// banks 8g + 2t); BAND_LD_TIGHT where shared memory is short (2-4 way)
constexpr int BAND_LD = 136, BAND_LD_TIGHT = 130;

__host__ __device__ inline int band_first(int q0, int k0, int L) {
  return clip(q0 - (k0 + 63), L) + L;
}

// pe rows the tile's pairs reach (from band_first), <= 127
__host__ __device__ inline int band_rows(int q0, int k0, int L) {
  return clip(q0 + 63 - k0, L) + L - band_first(q0, k0, L) + 1;
}

// every pair of the tile past one clip edge: i - j >= L - 1 or <= -L
__host__ __device__ inline bool band_clipped(int q0, int k0, int L) {
  return q0 - (k0 + 63) >= L - 1 || q0 + 63 - k0 <= -L;
}

// acc = Q.PE^T over a tile's 64 rows and its window's 128 pe rows (both
// K-major; q's halves q_half bytes apart, pe's 2 * 64 * 128), issued after
// the caller's wgmma_fence, committed by the caller
template <int D>
__device__ __forceinline__ void band_product(float (&acc)[64], const void* q, int q_half,
                                             const void* pe) {
  wgmma_ss_kmajor<D, BAND_ROWS>(acc, q, q_half, pe, 2 * 64 * 128);
}

// the window's rows rl and rl + 8 from band_product's accumulators (the
// fragment layout above: d[4j + e] is row rl + 8 (e / 2), column
// 8j + 2t + e % 2), times c2, at row stride LD
template <int LD>
__device__ __forceinline__ void band_store(float* band, const float (&acc)[64], float c2, int rl,
                                           int t) {
#pragma unroll
  for (int j = 0; j < BAND_ROWS / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(band + (rl + 8 * r) * LD + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * r] * c2, acc[4 * j + 2 * r + 1] * c2);
}

// The edge columns of rows rl and rl + 8 of a tile: c2 * q . pe[0] (lo) and
// c2 * q . pe[two_l - 1] (hi) in f32.  The 4 lanes of a quad take a quarter
// of the head dim each: load() reads their chunks of the two pe rows from
// device memory (issued before the wait for Q, so the wait hides it), dot()
// multiplies them with q read from its 128-byte-swizzled tile in shared
// memory (halves q_half bytes apart).
template <int D>
struct BandEdges {
  static constexpr int N = D / 32;   // 16-byte chunks a lane: t and t + 4 of each half
  uint4 lo[N], hi[N];

  __device__ __forceinline__ void load(const bf16* __restrict__ pe, int two_l, int t) {
    const bf16* last = pe + (long long)(two_l - 1) * D;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int col = 64 * (i / 2) + 8 * (t + 4 * (i % 2));
      lo[i] = *reinterpret_cast<const uint4*>(pe + col);
      hi[i] = *reinterpret_cast<const uint4*>(last + col);
    }
  }

  __device__ __forceinline__ void dot(float (&lo_c)[2], float (&hi_c)[2], const void* q,
                                      int q_half, float c2, int rl, int t) const {
    const char* tile = static_cast<const char*>(q);
    auto fma8 = [](float acc, const uint4& a, const uint4& b) {
      const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc = fmaf(__uint_as_float(x[k] << 16), __uint_as_float(y[k] << 16), acc);
        acc = fmaf(__uint_as_float(x[k] & 0xffff0000u), __uint_as_float(y[k] & 0xffff0000u),
                   acc);
      }
      return acc;
    };
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int c = t + 4 * (i % 2);   // 16-byte chunk of the half row
        const uint4 x = *reinterpret_cast<const uint4*>(tile + (i / 2) * q_half + row * 128 +
                                                        ((c ^ (row & 7)) * 16));
        a = fma8(a, x, lo[i]);
        b = fma8(b, x, hi[i]);
      }
      lo_c[r] = quad_sum(a) * c2;
      hi_c[r] = quad_sum(b) * c2;
    }
  }
};

// rows (r0, r0 + 8) of a warp's accumulator fragment [D / 2] (hopper.cuh's
// layout), times mul, to a row-major block at base (row stride ld); rows
// >= n are not stored
template <int D>
__device__ __forceinline__ void store_acc(float* base, long long ld, const float (&acc)[D / 2],
                                          float mul, int r0, int n, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r0 + 8 * r >= n) continue;
    float* o = base + (r0 + 8 * r) * ld + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// acc += the same fragment's cells of a row-major block at base
template <int D>
__device__ __forceinline__ void add_acc(float (&acc)[D / 2], const float* base, int ld, int r0,
                                        int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(base + (r0 + 8 * r) * ld + 8 * j + 2 * t);
      acc[4 * j + 2 * r] += x.x;
      acc[4 * j + 2 * r + 1] += x.y;
    }
}

// ---- host: register handover -------------------------------------------

// A kernel whose warpgroups hand registers over with setmaxnreg: producer
// threads drop to producer_regs, consumer threads rise to consumer_regs.
// Warpgroups whose launch share is too small for that would wait forever
// in setmaxnreg.inc: refuse to launch them (cudaErrorInvalidConfiguration).
// ``ok`` caches the answer (-1: not yet known).
template <typename Kernel>
cudaError_t check_handover_regs(Kernel kernel, int threads, int producer_threads,
                                int producer_regs, int consumer_regs, std::atomic<int>& ok) {
  int state = ok.load(std::memory_order_acquire);
  if (state < 0) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return e;
    state = a.numRegs * threads >=
            producer_threads * producer_regs + (threads - producer_threads) * consumer_regs;
    ok.store(state, std::memory_order_release);
  }
  return state ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// ---- host: tensor maps --------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the CUDA runtime has loaded (no
// link against libcuda); null where the driver has none
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess) ? (EncodeTiledFn)p
                                                                      : (EncodeTiledFn) nullptr;
  }();
  return fn;
}

// The 4-D map of a bf16 [B, H, T, D] operand read through (batch, head,
// time) element strides: dims (D, T, H, B) innermost first and the byte
// strides of T, H and B; an axis of size 1 is never stepped and takes the
// packed stride.
inline void bhtd_map(uint64_t (&dims)[4], uint64_t (&strides)[3], int D, int T, int H, int B,
                     long long st, long long sh, long long sb) {
  dims[0] = D, dims[1] = T, dims[2] = H, dims[3] = B;
  strides[0] = T == 1 ? 2ull * D : 2ull * st;
  strides[1] = H == 1 ? strides[0] * T : 2ull * sh;
  strides[2] = B == 1 ? strides[1] * H : 2ull * sb;
}

// the map of a contiguous [two_l, D] bf16 rel-pos table: dims (D, 2L, 1, 1)
inline void table_map(uint64_t (&dims)[4], uint64_t (&strides)[3], int D, int two_l) {
  dims[0] = D, dims[1] = two_l, dims[2] = dims[3] = 1;
  strides[0] = 2ull * D;
  strides[1] = strides[2] = 2ull * D * two_l;
}

// A 4-D bf16 view (innermost first) with byte strides of dims 1-3, read
// and written in boxes of {64, box_rows, 1, 1} with the 128-byte swizzle;
// reads past an extent fill zeros, writes past it are dropped.
inline cudaError_t encode_bf16_map(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                                   const uint64_t (&strides)[3], unsigned box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t s[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t box[4] = {64, box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), d, s,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
