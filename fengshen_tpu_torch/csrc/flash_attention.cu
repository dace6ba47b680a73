// Flash attention for Hopper (sm_90a): kernel K1 of the port, forward
// and both backward kernels.
//
// Replaces the Pallas TPU kernels of fengshen_tpu/ops/pallas/flash_attention.py:
//   - fstpu_flash_fwd      <- _fwd_kernel (:58), called at :139 in _fwd_impl
//   - fstpu_flash_bwd_dkv  <- _bwd_dkv_kernel (:177), called at :329
//   - fstpu_flash_bwd_dq   <- _bwd_dq_kernel (:234), called at :370
// and computes the same functions: exact attention with an online
// softmax that writes `out` and the per-row log-sum-exp `lse`; causal
// masking with queries right-aligned to keys (q_offset = Sk - Sq);
// segment ids (a query attends only to keys of its own segment); GQA
// (query head h reads KV head h / (H / KVH)). Scores are fp32 with scale
// 1/sqrt(D). The backward takes delta = rowsum(dO * O), computed by the
// caller as the TPU code does (:312-316), and gives
//   dV = P^T dO,  dS = P * (dO V^T - delta) * scale,  dK = dS^T Q,
//   dQ = dS K,    with P = exp(scale * Q K^T - lse).
//
// Layouts (no transposes around the kernels): q, out, dout, dq
// [B, Sq, H, D]; k, v, dk, dv [B, Sk, KVH, D]; lse and delta
// [B, H, Sq] fp32; segment ids int32 [B, Sq] and [B, Sk], or null.
//
// Masked positions carry exactly zero weight. A row with no valid key
// at all (possible only when segment ids or Sq > Sk leave a query
// nothing to attend to) gets what the plain version gives such a row:
// the uniform average of all Sk values, lse = -1e30, zero dQ, and
// dV_j += dO_i / Sk for every key j. Pads of a right-padded batch are
// segment 0 and attend to pads, so a causal row always has its diagonal.
//
// What bounds it on an H100: at the training shape (S=1024, D=128,
// causal, right-padded), bytes, narrowly: the valid pairs need 200-270
// bf16 flops per byte moved, under the ~295 at which the tensor
// cores would be the limit (chip_smoke.py computes both). This first
// kernel multiplies on the CUDA cores in fp32, so in practice its own
// FMA rate bounds it, far above either (PERF.md).
//
// Design (simple and right first; see PERF.md for its time against the
// bound and against SDPA):
// - one 256-thread block per (b, h, 64-row q tile) for the forward and
//   dQ, per (b, kv head, 64-row k tile) for dK/dV; a loop inside the
//   block takes the place of the TPU kernels' sequential grid axis, and
//   the dK/dV block loops over the group's query heads too, so it sums
//   GQA in-block with no atomics;
// - causal tiles past the diagonal are skipped (the forward and dQ stop
//   at the diagonal; dK/dV starts at it); the tile index is the slowest
//   grid axis, ordered so the longest blocks start first;
// - tiles are staged in shared memory as fp32 (16-byte global loads,
//   rows padded by 4 floats so the 128-bit shared reads hit distinct
//   banks); each thread keeps a 4 x 4 tile of scores and a 4 x D/16
//   tile of the output (or of dK/dV, dQ) in registers, and the products
//   are fp32 FMAs on the CUDA cores.
// Later work: bf16 mma.sync/wgmma fragments and cp.async/TMA pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;              // query rows per tile
constexpr int kBK = 64;              // key rows per tile
constexpr int kPadP = kBK + 4;       // pitch of a [kBQ][kBK] score tile
constexpr float kMasked = -1e30f;    // the TPU kernels' _NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;    // backward: forward's lse
  const float* delta;     // backward: rowsum(dO * O)
  const int32_t* seg_q;   // [B, Sq] or null
  const int32_t* seg_k;   // [B, Sk] or null
  void* out;              // fwd: out; dkv: dk; dq: dq
  void* out2;             // dkv: dv
  float* lse_out;         // fwd: lse
  int B, Sq, Sk, H, KVH;
  int causal;
  float scale;
};

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

// Is key `kj` (global index) valid for query row `qi` (global index)?
__device__ __forceinline__ bool allowed(const Params& p, int qi, int kj,
                                        int sq, int sk) {
  if (qi >= p.Sq || kj >= p.Sk) return false;
  if (p.causal && kj > qi + (p.Sk - p.Sq)) return false;
  return sq == sk;
}

// Last key index + 1 that any row of the q tile at q0 may attend to.
__device__ __forceinline__ int key_end(const Params& p, int q0) {
  if (!p.causal) return p.Sk;
  const int last_q = min(q0 + kBQ, p.Sq) - 1 + (p.Sk - p.Sq);
  return max(0, min(p.Sk, last_q + 1));
}

// ---------------------------------------------------------------------------
// forward: one block per (h, b, q tile)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(Params p) {
  constexpr int P = D + 4;
  constexpr int C = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBQ * P;
  float* Vs = Ks + kBK * P;
  float* Ps = Vs + kBK * P;
  int* segq_s = reinterpret_cast<int*>(Ps + kBQ * kPadP);
  int* segk_s = segq_s + kBQ;

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - blockIdx.z) * kBQ;   // longest tiles first
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int64_t ldq = (int64_t)p.H * D, ldk = (int64_t)p.KVH * D;

  load_tile<T, D, kBQ>(Qs, q + ((int64_t)b * p.Sq + q0) * ldq + h * D, ldq,
                       min(kBQ, p.Sq - q0));
  if (tid < kBQ)
    segq_s[tid] = (p.seg_q && q0 + tid < p.Sq)
                      ? p.seg_q[(int64_t)b * p.Sq + q0 + tid] : 0;

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int kend = key_end(p, q0);
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();
    const int nk = min(kBK, p.Sk - k0);
    load_tile<T, D, kBK>(Ks, k + ((int64_t)b * p.Sk + k0) * ldk + kvh * D,
                         ldk, nk);
    load_tile<T, D, kBK>(Vs, v + ((int64_t)b * p.Sk + k0) * ldk + kvh * D,
                         ldk, nk);
    if (tid < kBK)
      segk_s[tid] = (p.seg_k && tid < nk)
                        ? p.seg_k[(int64_t)b * p.Sk + k0 + tid] : 0;
    __syncthreads();

    float s[4][4];
    dots<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      bool ok[4];
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ok[j] = allowed(p, q0 + r, k0 + c, segq_s[r], segk_s[c]);
        s[i][j] = ok[j] ? s[i][j] * p.scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = __expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = ok[j] ? __expf(s[i][j] - m_new) : 0.f;
        Ps[r * kPadP + tx + 16 * j] = pr;
        sum += pr;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    tile_times_rows<D>(acc, Ps, Vs, ty, tx);
  }

  // rows with no valid key: the uniform average of all Sk values
  bool dead = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dead |= (l[i] == 0.f && q0 + ty * 4 + i < p.Sq);
  if (__syncthreads_or(dead)) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (l[i] == 0.f)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
    for (int k0 = 0; k0 < p.Sk; k0 += kBK) {
      __syncthreads();
      load_tile<T, D, kBK>(Vs, v + ((int64_t)b * p.Sk + k0) * ldk + kvh * D,
                           ldk, min(kBK, p.Sk - k0));
      __syncthreads();
      for (int kk = 0; kk < kBK; ++kk)
#pragma unroll
        for (int g = 0; g < D / 64; ++g) {
          const float4 x = *reinterpret_cast<const float4*>(
              Vs + kk * P + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (l[i] == 0.f) {
              acc[i][g * 4 + 0] += x.x;
              acc[i][g * 4 + 1] += x.y;
              acc[i][g * 4 + 2] += x.z;
              acc[i][g * 4 + 3] += x.w;
            }
        }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.Sq) continue;
    const bool live = l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 1.f / (float)p.Sk;
    T* row = out + ((int64_t)b * p.Sq + qi) * ldq + h * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      store4(row + g * 64 + tx * 4,
             make_float4(acc[i][g * 4] * inv, acc[i][g * 4 + 1] * inv,
                         acc[i][g * 4 + 2] * inv, acc[i][g * 4 + 3] * inv));
    if (tx == 0)
      p.lse_out[((int64_t)b * p.H + h) * p.Sq + qi] =
          live ? m[i] + __logf(l[i]) : kMasked;
  }
}

// ---------------------------------------------------------------------------
// backward dQ: one block per (h, b, q tile), streaming k tiles
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(Params p) {
  constexpr int P = D + 4;
  constexpr int C = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + kBQ * P;
  float* Ks = dOs + kBQ * P;
  float* Vs = Ks + kBK * P;
  float* dSs = Vs + kBK * P;
  float* lse_s = dSs + kBQ * kPadP;
  float* delta_s = lse_s + kBQ;
  int* segq_s = reinterpret_cast<int*>(delta_s + kBQ);
  int* segk_s = segq_s + kBQ;

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - blockIdx.z) * kBQ;
  const int kvh = h / (p.H / p.KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int64_t ldq = (int64_t)p.H * D, ldk = (int64_t)p.KVH * D;
  const int nq = min(kBQ, p.Sq - q0);

  load_tile<T, D, kBQ>(Qs, q + ((int64_t)b * p.Sq + q0) * ldq + h * D, ldq,
                       nq);
  load_tile<T, D, kBQ>(dOs, dout + ((int64_t)b * p.Sq + q0) * ldq + h * D,
                       ldq, nq);
  if (tid < kBQ) {
    const int64_t row = ((int64_t)b * p.H + h) * p.Sq + q0 + tid;
    lse_s[tid] = tid < nq ? p.lse_in[row] : 0.f;
    delta_s[tid] = tid < nq ? p.delta[row] : 0.f;
    segq_s[tid] = (p.seg_q && tid < nq)
                      ? p.seg_q[(int64_t)b * p.Sq + q0 + tid] : 0;
  }

  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  const int kend = key_end(p, q0);
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();
    const int nk = min(kBK, p.Sk - k0);
    load_tile<T, D, kBK>(Ks, k + ((int64_t)b * p.Sk + k0) * ldk + kvh * D,
                         ldk, nk);
    load_tile<T, D, kBK>(Vs, v + ((int64_t)b * p.Sk + k0) * ldk + kvh * D,
                         ldk, nk);
    if (tid < kBK)
      segk_s[tid] = (p.seg_k && tid < nk)
                        ? p.seg_k[(int64_t)b * p.Sk + k0 + tid] : 0;
    __syncthreads();

    float s[4][4], dp[4][4];
    dots<D>(s, Qs, Ks, ty, tx);
    dots<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (allowed(p, q0 + r, k0 + c, segq_s[r], segk_s[c])) {
          const float pr = __expf(s[i][j] * p.scale - lse_s[r]);
          ds = pr * (dp[i][j] - delta_s[r]) * p.scale;
        }
        dSs[r * kPadP + c] = ds;
      }
    }
    __syncthreads();
    tile_times_rows<D>(acc, dSs, Ks, ty, tx);
  }

  T* dq = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.Sq) continue;
    T* row = dq + ((int64_t)b * p.Sq + qi) * ldq + h * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      store4(row + g * 64 + tx * 4,
             make_float4(acc[i][g * 4], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                         acc[i][g * 4 + 3]));
  }
}

// ---------------------------------------------------------------------------
// backward dK/dV: one block per (kv head, b, k tile), streaming the
// group's query heads and their q tiles; GQA sums in-block
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(Params p) {
  constexpr int P = D + 4;
  constexpr int C = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kBK * P;
  float* Qs = Vs + kBK * P;
  float* dOs = Qs + kBQ * P;
  float* Ps = dOs + kBQ * P;
  float* dSs = Ps + kBQ * kPadP;
  float* lse_s = dSs + kBQ * kPadP;
  float* delta_s = lse_s + kBQ;
  int* segq_s = reinterpret_cast<int*>(delta_s + kBQ);
  int* segk_s = segq_s + kBQ;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;          // early tiles see most queries
  const int rep = p.H / p.KVH;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int64_t ldq = (int64_t)p.H * D, ldk = (int64_t)p.KVH * D;
  const int nk = min(kBK, p.Sk - k0);
  const float uniform = 1.f / (float)p.Sk;

  load_tile<T, D, kBK>(Ks, k + ((int64_t)b * p.Sk + k0) * ldk + kvh * D, ldk,
                       nk);
  load_tile<T, D, kBK>(Vs, v + ((int64_t)b * p.Sk + k0) * ldk + kvh * D, ldk,
                       nk);
  if (tid < kBK)
    segk_s[tid] = (p.seg_k && tid < nk)
                      ? p.seg_k[(int64_t)b * p.Sk + k0 + tid] : 0;

  float dk[4][C], dv[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int h = kvh * rep; h < (kvh + 1) * rep; ++h) {
    for (int q0 = 0; q0 < p.Sq; q0 += kBQ) {
      const int nq = min(kBQ, p.Sq - q0);
      __syncthreads();
      bool dead = false;
      if (tid < kBQ) {
        const int64_t row = ((int64_t)b * p.H + h) * p.Sq + q0 + tid;
        lse_s[tid] = tid < nq ? p.lse_in[row] : 0.f;
        delta_s[tid] = tid < nq ? p.delta[row] : 0.f;
        segq_s[tid] = (p.seg_q && tid < nq)
                          ? p.seg_q[(int64_t)b * p.Sq + q0 + tid] : 0;
        dead = tid < nq && lse_s[tid] <= 0.5f * kMasked;
      }
      // a causal q tile that ends before this k tile has no valid pair;
      // it still matters if it holds a row with no valid key at all
      const bool reach = !p.causal || key_end(p, q0) > k0;
      if (!__syncthreads_or(dead || (reach && tid == 0))) continue;
      load_tile<T, D, kBQ>(Qs, q + ((int64_t)b * p.Sq + q0) * ldq + h * D,
                           ldq, nq);
      load_tile<T, D, kBQ>(dOs,
                           dout + ((int64_t)b * p.Sq + q0) * ldq + h * D,
                           ldq, nq);
      __syncthreads();

      // rows r = q tile rows (ty*4+i), columns c = keys (tx+16j)
      float s[4][4], dp[4][4];
      dots<D>(s, Qs, Ks, ty, tx);
      dots<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const bool row_dead = r < nq && lse_s[r] <= 0.5f * kMasked;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float pr = 0.f, ds = 0.f;
          if (allowed(p, q0 + r, k0 + c, segq_s[r], segk_s[c])) {
            pr = __expf(s[i][j] * p.scale - lse_s[r]);
            ds = pr * (dp[i][j] - delta_s[r]) * p.scale;
          } else if (row_dead && c < nk) {
            pr = uniform;
          }
          Ps[r * kPadP + c] = pr;
          dSs[r * kPadP + c] = ds;
        }
      }
      __syncthreads();
      tile_t_times_rows<D>(dv, Ps, dOs, ty, tx);
      tile_t_times_rows<D>(dk, dSs, Qs, ty, tx);
    }
  }

  T* dk_out = static_cast<T*>(p.out);
  T* dv_out = static_cast<T*>(p.out2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= p.Sk) continue;
    const int64_t off = ((int64_t)b * p.Sk + kj) * ldk + kvh * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      store4(dk_out + off + g * 64 + tx * 4,
             make_float4(dk[i][g * 4], dk[i][g * 4 + 1], dk[i][g * 4 + 2],
                         dk[i][g * 4 + 3]));
      store4(dv_out + off + g * 64 + tx * 4,
             make_float4(dv[i][g * 4], dv[i][g * 4 + 1], dv[i][g * 4 + 2],
                         dv[i][g * 4 + 3]));
    }
  }
}

// Shared-memory bytes of each kernel (fp32 tiles of pitch D + 4).
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((kBQ + 2 * kBK) * (D + 4) + kBQ * kPadP) +
         sizeof(int) * (kBQ + kBK);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * kBQ + 2 * kBK) * (D + 4) + kBQ * kPadP +
                          2 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * kBQ + 2 * kBK) * (D + 4) + 2 * kBQ * kPadP +
                          2 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const Params& p,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(int which, const Params& p, cudaStream_t stream) {
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int n_kt = (p.Sk + kBK - 1) / kBK;
  if (which == 0)
    return launch(flash_fwd_kernel<T, D>, fwd_smem<D>(),
                  dim3(p.H, p.B, n_qt), p, stream);
  if (which == 1)
    return launch(flash_bwd_dkv_kernel<T, D>, dkv_smem<D>(),
                  dim3(p.KVH, p.B, n_kt), p, stream);
  return launch(flash_bwd_dq_kernel<T, D>, dq_smem<D>(),
                dim3(p.H, p.B, n_qt), p, stream);
}

int dispatch(int which, const Params& p, int D, int dtype, void* stream) {
  if (p.B == 0 || p.Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return run<__nv_bfloat16, 128>(which, p, st);
  if (dtype == 1 && D == 64) return run<__nv_bfloat16, 64>(which, p, st);
  if (dtype == 0 && D == 128) return run<float, 128>(which, p, st);
  if (dtype == 0 && D == 64) return run<float, 64>(which, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (q, k, v, dout and every output but lse share
// it). Each returns a cudaError_t: 0 when the launch was accepted. The
// Python wrapper has already checked shapes, dtypes, contiguity and
// alignment.
int fstpu_flash_fwd(const void* q, const void* k, const void* v,
                    const void* seg_q, const void* seg_k, void* out,
                    void* lse, int B, int Sq, int Sk, int H, int KVH, int D,
                    int causal, int dtype, void* stream) {
  Params p{q, k, v, nullptr, nullptr, nullptr,
           static_cast<const int32_t*>(seg_q),
           static_cast<const int32_t*>(seg_k), out, nullptr,
           static_cast<float*>(lse), B, Sq, Sk, H, KVH, causal,
           1.f / sqrtf((float)D)};
  return dispatch(0, p, D, dtype, stream);
}

int fstpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* seg_q, const void* seg_k, void* dk,
                        void* dv, int B, int Sq, int Sk, int H, int KVH,
                        int D, int causal, int dtype, void* stream) {
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta),
           static_cast<const int32_t*>(seg_q),
           static_cast<const int32_t*>(seg_k), dk, dv, nullptr, B, Sq, Sk,
           H, KVH, causal, 1.f / sqrtf((float)D)};
  return dispatch(1, p, D, dtype, stream);
}

int fstpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* seg_q, const void* seg_k, void* dq, int B,
                       int Sq, int Sk, int H, int KVH, int D, int causal,
                       int dtype, void* stream) {
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta),
           static_cast<const int32_t*>(seg_q),
           static_cast<const int32_t*>(seg_k), dq, nullptr, nullptr, B, Sq,
           Sk, H, KVH, causal, 1.f / sqrtf((float)D)};
  return dispatch(2, p, D, dtype, stream);
}

}  // extern "C"
