// Tile helpers shared by the port's attention kernels (K1 in
// flash_attention.cu, K4 in block_sparse_attention.cu): 256-thread
// blocks over 64 x 64 tiles staged in shared memory as fp32 (rows padded
// by 4 floats so 128-bit shared reads hit distinct banks). Thread
// (ty, tx) = (tid / 16, tid % 16) holds a 4 x 4 tile of scores (rows
// ty*4+i, columns tx+16j) and a 4 x D/16 tile of an output (rows
// ty*4+i, columns g*64 + tx*4 + {0..3}); the products are fp32 FMAs on
// the CUDA cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;              // query rows per tile
constexpr int kBK = 64;              // key rows per tile
constexpr int kPadP = kBK + 4;       // pitch of a [kBQ][kBK] score tile
constexpr float kMasked = -1e30f;    // the TPU kernels' _NEG_INF

// 16 bytes of T from global memory into fp32 shared memory.
__device__ __forceinline__ void load16(const float* g, float* s) {
  *reinterpret_cast<float4*>(s) = *reinterpret_cast<const float4*>(g);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* g, float* s) {
  const uint4 raw = *reinterpret_cast<const uint4*>(g);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(s)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(s)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// Rows [0, nrows) of a [ROWS, D] tile whose rows lie `ld` elements apart
// in global memory, into shared memory of pitch D + 4 floats; rows past
// nrows are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* s, const T* g, int64_t ld,
                                          int nrows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float* dst = s + r * (D + 4) + c;
    if (r < nrows) {
      load16(g + r * ld + c, dst);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
    }
  }
}

// 4 contiguous fp32 values to T in global memory.
__device__ __forceinline__ void store4(float* g, float4 x) {
  *reinterpret_cast<float4*>(g) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* g, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(g) = raw;
}

// Max / sum over the 16 lanes that share a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[i][c] (+)= A[ty*4+i][0..kBK) . B[0..kBK)[cols of thread], with A
// a [kBQ][kPadP] shared tile and B a [kBK][D+4] shared tile; the
// thread's columns are g*64 + tx*4 + {0..3}.
template <int D>
__device__ __forceinline__ void tile_times_rows(float (*acc)[D / 16],
                                                const float* A,
                                                const float* Bm, int ty,
                                                int tx) {
  constexpr int G = D / 64;
  constexpr int P = D + 4;
#pragma unroll 2
  for (int k = 0; k < kBK; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * kPadP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(
            Bm + (k + kk) * P + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                        : kk == 2 ? a[i].z : a[i].w;
          acc[i][g * 4 + 0] += w * b.x;
          acc[i][g * 4 + 1] += w * b.y;
          acc[i][g * 4 + 2] += w * b.z;
          acc[i][g * 4 + 3] += w * b.w;
        }
      }
    }
  }
}

// acc[i][c] += sum_r A[r][ty*4+i] * B[r][cols of thread]: the
// transposed product dV += P^T dO and dK += dS^T Q, over kBQ rows r.
template <int D>
__device__ __forceinline__ void tile_t_times_rows(float (*acc)[D / 16],
                                                  const float* A,
                                                  const float* Bm, int ty,
                                                  int tx) {
  constexpr int G = D / 64;
  constexpr int P = D + 4;
#pragma unroll 4
  for (int r = 0; r < kBQ; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(A + r * kPadP + ty * 4);
    const float w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 b = *reinterpret_cast<const float4*>(
          Bm + r * P + g * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][g * 4 + 0] += w[i] * b.x;
        acc[i][g * 4 + 1] += w[i] * b.y;
        acc[i][g * 4 + 2] += w[i] * b.z;
        acc[i][g * 4 + 3] += w[i] * b.w;
      }
    }
  }
}

// s[i][j] = X[ty*4+i] . Y[tx+16j] over D, both [64][D+4] shared tiles.
template <int D>
__device__ __forceinline__ void dots(float (*s)[4], const float* X,
                                     const float* Y, int ty, int tx) {
  constexpr int P = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(X + (ty * 4 + i) * P + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Y + (tx + 16 * j) * P + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                   a[i].w * b[j].w;
  }
}

}  // namespace
