// Tensor-core building blocks shared by the port's bf16 kernels (K1 in
// flash_attention.cu, K2 in fused_ce.cu, K4 in block_sparse_attention.cu)
// and the cp.async copies of K3 (decode_attention.cu) on Hopper (sm_90a):
//
// - bf16 mma.sync.aligned.m16n8k16 with fp32 accumulators. One warp
//   multiplies a 16 x 16 A fragment (4 registers of two bf16 each) by a
//   16 x 8 B fragment (2 registers) into a 16 x 8 fp32 C fragment (4
//   floats). Lane l holds, with g = l / 4 and t = l % 4:
//     A: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//        a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same cols);
//     B: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//     C: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
//   The C fragments of two neighbouring n8 tiles are, once rounded to
//   bf16 pairs, the A fragment of one k16 step: a product's result
//   feeds the next product from registers (P V, dS K, P^T dO, dS^T Q).
// - ldmatrix (x4) from shared memory, plain or .trans: a tile stored
//   with the reduction index contiguous feeds A or B as it is; a tile
//   stored with it strided feeds them through .trans. So one staged copy
//   of a matrix serves a product and its transpose, and nothing is
//   transposed in device memory.
// - tiles in shared memory are rows of a multiple of 64 bf16 (128 bytes)
//   with the 16-byte chunks of each row XOR-swizzled by the row index
//   (chunk ^ (row % 8)): the 8 rows one ldmatrix matrix reads, and the
//   chunks cp.async writes, fall on distinct banks.
// - cp.async.cg 16-byte copies from device memory with a source size (0
//   zero-fills the chunk), committed and waited for in groups, so tile
//   loads run ahead of the products in a ring of stages; 4-byte
//   cp.async.ca copies stage per-row scalars beside them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (r, c) in a swizzled tile of `cols` columns (a
// multiple of 64); c is a multiple of 8 for a chunk's first element.
__device__ __forceinline__ int swz(int r, int c, int cols) {
  return r * cols + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
// 4 bytes (src_bytes 0 zero-fills them): per-row scalars such as segment
// ids or a log-sum-exp, staged beside the tiles without stalling.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: one m16n8k16 bf16 product, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Max and sum over the four lanes of a quad (lanes 4g..4g+3), which
// together hold one row of a C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two fp32 values as a bf16 pair (lo in the low half: the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values as a bf16 pair hi and the bf16 pair lo of what hi
// leaves over: hi + lo carries them to about 2^-16 relative, so a
// product taken once with hi and once with lo has an fp32 operand's
// accuracy from bf16 tensor-core steps.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 r = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - r.x, b - r.y);
}

// The A fragment of k16 step kk from the C fragments of n8 tiles 2kk and
// 2kk+1 (rows g, g+8; columns 16kk + 2t.. and 16kk + 8 + 2t..), each
// value split as split_bf16 does: A fragments hi and lo.
__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// Fragment loads from swizzled tiles. `base` is the tile, `cols` its row
// length; m0 (n0) and k0 the fragment's first output row (column) and
// first depth index.
//
// A from a tile stored [m][k] (k contiguous): rows m0..+15, depth k0..+15.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base,
                                       int cols, int m0, int k0, int lane) {
  ldsm_x4(a, base + swz(m0 + (lane & 15), k0 + (lane >> 4) * 8, cols));
}
// A from a tile stored [k][m] (m contiguous), through .trans.
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* base,
                                         int cols, int m0, int k0, int lane) {
  ldsm_x4_t(a, base + swz(k0 + (lane & 7) + ((lane >> 4) & 1) * 8,
                          m0 + ((lane >> 3) & 1) * 8, cols));
}
// B of two n8 tiles (n0.., n0+8..) from a tile stored [n][k] (k
// contiguous): b[0], b[1] for the first tile, b[2], b[3] for the second.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* base,
                                       int cols, int n0, int k0, int lane) {
  ldsm_x4(b, base + swz(n0 + (lane & 7) + ((lane >> 4) << 3),
                        k0 + ((lane >> 3) & 1) * 8, cols));
}
// The same from a tile stored [k][n] (n contiguous), through .trans.
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4], const bf16* base,
                                         int cols, int n0, int k0, int lane) {
  ldsm_x4_t(b, base + swz(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                          n0 + (lane >> 4) * 8, cols));
}

// Rows [0, ROWS) x columns [0, COLS) of a tile of a row-major bf16 matrix
// (element (r, c) at g[r * ld + c]; rows >= nrows and columns >= ncols
// read as zero) into a swizzled shared tile, by THREADS threads. With
// `vec` (g 16-byte aligned and ld a multiple of 8) whole chunks go by
// cp.async; a chunk that straddles ncols, and every chunk without `vec`,
// is staged element by element; chunks past the edge are zero-filled.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int64_t ld,
                                          int nrows, int ncols, bool vec) {
  constexpr int kPerRow = COLS / 8;
  constexpr int kChunks = ROWS * kPerRow;
  constexpr int kStep = THREADS / kPerRow;   // rows between a thread's chunks
  static_assert(COLS % 64 == 0 && kChunks % THREADS == 0 &&
                    THREADS % kPerRow == 0 && kStep % 8 == 0,
                "tile shape");
  const int r0 = threadIdx.x / kPerRow, c = (threadIdx.x % kPerRow) * 8;
  if (vec && nrows >= ROWS && ncols >= COLS) {
    // the whole tile lies inside: one 16-byte copy per chunk, and the
    // swizzle of a thread's chunks repeats every kStep rows
    const bf16* src = g + (int64_t)r0 * ld + c;
    bf16* dst = s + swz(r0, c, COLS);
    const int64_t step = (int64_t)kStep * ld;
#pragma unroll
    for (int it = 0; it < kChunks / THREADS; ++it)
      cp_async16(dst + it * kStep * COLS, src + it * step, 16);
    return;
  }
#pragma unroll
  for (int it = 0; it < kChunks / THREADS; ++it) {
    const int r = r0 + it * kStep;
    bf16* dst = s + swz(r, c, COLS);
    if (r < nrows && c + 8 <= ncols && vec) {
      cp_async16(dst, g + (int64_t)r * ld + c, 16);
    } else if (r < nrows && c < ncols) {
      const bf16* src = g + (int64_t)r * ld + c;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c + e < ncols)
          w[e >> 1] |= (uint32_t)__bfloat16_as_ushort(src[e]) << (16 * (e & 1));
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Two neighbouring fp32 values (columns c, c+1 of a row) as bf16 at p,
// which is 4-byte aligned.
__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The same where p may not be 4-byte aligned or column c + 1 may lie
// outside: `pair` says both columns lie inside and p is aligned,
// `second` that column c + 1 lies inside.
__device__ __forceinline__ void store_pair(bf16* p, float a, float b,
                                           bool pair, bool second) {
  if (pair) {
    store_bf16x2(p, a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (second) p[1] = __float2bfloat16(b);
  }
}

}  // namespace mma
