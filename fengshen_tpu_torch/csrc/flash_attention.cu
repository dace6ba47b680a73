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
// bf16 flops per byte moved, under the ~295 at which the tensor cores
// would be the limit (chip_smoke.py computes both); in practice the
// tensor cores' rate and the softmax between the products bound it. At
// the long-context shape (S = 32768) the products dominate: operations.
//
// Design for bf16 inputs: FlashAttention-2 on the tensor cores (bf16
// mma.sync.m16n8k16 with fp32 accumulators, operands through ldmatrix
// from XOR-swizzled shared tiles filled by cp.async; mma_tiles.cuh). See
// PERF.md for its times against the bound and SDPA.
// - forward: one 128-thread block per (h, b, 64-row q tile); each of 4
//   warps owns 16 query rows and keeps Q as mma A fragments in registers
//   for the whole key walk. K and V tiles of 64 keys stream through 2
//   cp.async stages (the next tile loads under this one's products).
//   S = Q K^T in fp32 fragments; scale, causal and segment masks and the
//   online softmax act on the fragments (row max and sum across the 4
//   lanes that share a row by shuffles); P becomes bf16 A fragments of
//   P V in registers, straight from the score fragments; O stays fp32 in
//   registers until the epilogue writes out (bf16) and lse.
// - dQ: one 128-thread block per (h, b, 64-row q tile), Q and dO staged
//   once, K and V tiles streamed through 2 stages up to the diagonal:
//   S = Q K^T, dP = dO V^T, dS = P (dP - delta) scale on the fragments,
//   dQ += dS K with dS as A fragments and K through ldmatrix.trans.
// - dK/dV: one 128-thread block per (kv head, b, 64-row k tile), K and V
//   staged once; it walks the group's query heads and their q tiles
//   (from the diagonal on when causal, plus any earlier tile that holds a
//   row with no valid key, found once by a scan of lse into bits), Q and
//   dO through 2 stages. Each warp owns 16 keys: S^T = K Q^T and dP^T =
//   V dO^T for all 64 queries of the tile, P^T and dS^T on the
//   fragments, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as A
//   fragments from registers and dO and Q through ldmatrix.trans. GQA
//   sums in-block, with no atomics.
// - precision: P and dS enter their products as two bf16 terms (hi, and
//   lo = what hi leaves over), so each of those products costs two
//   tensor-core steps but carries the operand to ~2^-16: a single bf16
//   rounding (2^-9) of P and dS left out, dq, dk and dv 1.0-1.3x the
//   element limit that holds them to the fp32 plain version. Out, dq, dk
//   and dv round to bf16 at the end; every sum is fp32.
// - causal tiles past the diagonal are skipped (the forward and dQ stop
//   at the diagonal; dK/dV starts at it); the tile index is the slowest
//   grid axis, ordered so the longest blocks start first; ragged tiles
//   are zero-filled (rows past the end of Q, K, V or dO) and write
//   nothing.
// fp32 inputs keep the first design, unchanged: one 256-thread block per
// 64-row tile, tiles staged in shared memory as fp32 (attention_tiles.cuh,
// shared with K4), each thread a 4 x 4 tile of scores and a 4 x D/16
// tile of the output in registers, fp32 FMAs on the CUDA cores.
// - per-row scalars (segment ids, lse, delta) are staged by 4-byte
//   cp.async beside the tiles, so no warp waits on them.
// Later work: wgmma with TMA and warp specialisation, a wider q tile, and
// persistent blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (FlashAttention-2 with mma.sync)
// ---------------------------------------------------------------------------

namespace tc {

using mma::bf16;

constexpr int kT = 64;          // query rows and key rows per tile
static_assert(kT == kBQ, "key_end() walks q tiles of kBQ rows");
constexpr int kFwdThreads = 128;   // 4 warps x 16 query rows
constexpr int kDqThreads = 128;    // 4 warps x 16 query rows
constexpr int kDkvThreads = 128;   // 4 warps x 16 key rows
constexpr uint32_t kOneOne = 0x3f803f80u;   // two bf16 1.0

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [r0, r0 + 64) of one head of a [B, S, heads, D] tensor (row r at
// base + r * ld) into a swizzled [64][D] tile; rows >= n read as zero.
template <int D, int THREADS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* base,
                                          int64_t ld, int r0, int n) {
  mma::load_tile<kT, D, THREADS>(s, base + (int64_t)r0 * ld, ld, n - r0, D,
                                 true);
}

__device__ __forceinline__ int seg_at(const int32_t* seg, int b, int S,
                                      int i) {
  return (seg != nullptr && i < S) ? seg[(int64_t)b * S + i] : 0;
}

// Segment id of row i (0 past the end or without ids) into shared memory
// by cp.async, so the loading thread does not wait for it.
__device__ __forceinline__ void stage_seg(int* dst, const int32_t* seg,
                                          int b, int S, int i) {
  if (seg == nullptr) {
    *dst = 0;
  } else {
    const int32_t* row = seg + (int64_t)b * S;
    mma::cp_async4(dst, i < S ? row + i : row, i < S ? 4 : 0);
  }
}

// forward: one block per (h, b, 64-row q tile); each warp owns 16 query
// rows, with Q as mma A fragments in registers for the whole key walk.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2) flash_fwd_tc(Params p) {
  constexpr int NT = D / 8;    // n8 tiles of an output row
  constexpr int KD = D / 16;   // k16 steps over head_dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kT * D;          // 2 stages
  bf16* sV = sK + 2 * kT * D;      // 2 stages
  int* sSeg = reinterpret_cast<int*>(sV + 2 * kT * D);   // 2 x kT

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (p.Sq + kT - 1) / kT;
  const int q0 = (n_qt - 1 - blockIdx.z) * kT;   // longest tiles first
  const int kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int64_t ldq = (int64_t)p.H * D, ldk = (int64_t)p.KVH * D;
  const bf16* qb = static_cast<const bf16*>(p.q) + (int64_t)b * p.Sq * ldq +
                   h * D;
  const bf16* kb = static_cast<const bf16*>(p.k) + (int64_t)b * p.Sk * ldk +
                   kvh * D;
  const bf16* vb = static_cast<const bf16*>(p.v) + (int64_t)b * p.Sk * ldk +
                   kvh * D;
  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};
  const int segq[2] = {seg_at(p.seg_q, b, p.Sq, row[0]),
                       seg_at(p.seg_q, b, p.Sq, row[1])};

  const int kend = key_end(p, q0);
  const int n_kt = (kend + kT - 1) / kT;
  load_rows<D, kFwdThreads>(sQ, qb, ldq, q0, p.Sq);
  if (n_kt > 0) {
    load_rows<D, kFwdThreads>(sK, kb, ldk, 0, p.Sk);
    load_rows<D, kFwdThreads>(sV, vb, ldk, 0, p.Sk);
    if (threadIdx.x < kT)
      stage_seg(sSeg + threadIdx.x, p.seg_k, b, p.Sk, threadIdx.x);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    mma::load_a(qf[kk], sQ, D, warp * 16, kk * 16, lane);

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1, k0 = kt * kT;
    if (kt > 0) {
      mma::cp_async_wait<0>();
      __syncthreads();
    }
    if (kt + 1 < n_kt) {   // the next tile streams in under this one
      bf16* nk = sK + (buf ^ 1) * kT * D;
      bf16* nv = sV + (buf ^ 1) * kT * D;
      load_rows<D, kFwdThreads>(nk, kb, ldk, k0 + kT, p.Sk);
      load_rows<D, kFwdThreads>(nv, vb, ldk, k0 + kT, p.Sk);
      if (threadIdx.x < kT)
        stage_seg(sSeg + (buf ^ 1) * kT + threadIdx.x, p.seg_k, b, p.Sk,
                  k0 + kT + threadIdx.x);
    }
    mma::cp_async_commit();
    const bf16* ck = sK + buf * kT * D;
    const bf16* cv = sV + buf * kT * D;
    const int* cseg = sSeg + buf * kT;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        uint32_t bk[4];
        mma::load_b(bk, ck, D, pr * 16, kk * 16, lane);
        mma::mma16816(s[2 * pr], qf[kk], bk[0], bk[1]);
        mma::mma16816(s[2 * pr + 1], qf[kk], bk[2], bk[3]);
      }

    // scale, mask, online softmax on the fragments
    uint32_t ok = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cl = j * 8 + 2 * t4 + (c & 1);
        const bool a = allowed(p, row[c >> 1], k0 + cl, segq[c >> 1],
                               cseg[cl]);
        ok |= (uint32_t)a << (j * 4 + c);
        s[j][c] = a ? s[j][c] * p.scale : kMasked;
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][hf * 2], s[j][hf * 2 + 1]));
      const float m_new = fmaxf(m[hf], quad_max(mx));
      const float corr = __expf(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = hf * 2 + e;
          const float pr = (ok >> (j * 4 + c)) & 1u
                               ? __expf(s[j][c] - m_new) : 0.f;
          s[j][c] = pr;
          sum += pr;
        }
      l[hf] = l[hf] * corr + sum;   // this thread's columns; quad-summed
      m[hf] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][hf * 2] *= corr;
        o[n][hf * 2 + 1] *= corr;
      }
    }
    // O += P V, P as A fragments straight from the score fragments, in
    // two bf16 terms (hi + lo) so that P keeps fp32 accuracy
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      mma::c_to_a_split(ph, pl, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        mma::load_b_t(bv, cv, D, np * 16, kk * 16, lane);
        mma::mma16816(o[2 * np], ph, bv[0], bv[1]);
        mma::mma16816(o[2 * np + 1], ph, bv[2], bv[3]);
        mma::mma16816(o[2 * np], pl, bv[0], bv[1]);
        mma::mma16816(o[2 * np + 1], pl, bv[2], bv[3]);
      }
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  // rows with no valid key: the uniform average of all Sk values
  const bool dead0 = l[0] == 0.f && row[0] < p.Sq;
  const bool dead1 = l[1] == 0.f && row[1] < p.Sq;
  mma::cp_async_wait<0>();
  if (__syncthreads_or(dead0 || dead1)) {
    const uint32_t a0 = dead0 ? kOneOne : 0u, a1 = dead1 ? kOneOne : 0u;
    const uint32_t pa[4] = {a0, a1, a0, a1};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (dead0) o[n][0] = o[n][1] = 0.f;
      if (dead1) o[n][2] = o[n][3] = 0.f;
    }
    for (int k0 = 0; k0 < p.Sk; k0 += kT) {
      __syncthreads();
      load_rows<D, kFwdThreads>(sV, vb, ldk, k0, p.Sk);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bv[4];
          mma::load_b_t(bv, sV, D, np * 16, kk * 16, lane);
          mma::mma16816(o[2 * np], pa, bv[0], bv[1]);
          mma::mma16816(o[2 * np + 1], pa, bv[2], bv[3]);
        }
    }
  }

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qi = row[hf];
    if (qi >= p.Sq) continue;
    const bool live = l[hf] > 0.f;
    const float inv = live ? 1.f / l[hf] : 1.f / (float)p.Sk;
    bf16* dst = out + ((int64_t)b * p.Sq + qi) * ldq + h * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma::store_bf16x2(dst + n * 8, o[n][hf * 2] * inv,
                     o[n][hf * 2 + 1] * inv);
    if (t4 == 0)
      p.lse_out[((int64_t)b * p.H + h) * p.Sq + qi] =
          live ? m[hf] + __logf(l[hf]) : kMasked;
  }
}

// backward dQ: one block per (h, b, 64-row q tile), streaming the key
// tiles up to the diagonal; each warp owns 16 query rows.
template <int D>
__global__ void __launch_bounds__(kDqThreads, 2) flash_bwd_dq_tc(Params p) {
  constexpr int NT = D / 8;
  constexpr int KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kT * D;
  bf16* sK = sdO + kT * D;         // 2 stages
  bf16* sV = sK + 2 * kT * D;      // 2 stages
  int* sSeg = reinterpret_cast<int*>(sV + 2 * kT * D);   // 2 x kT

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (p.Sq + kT - 1) / kT;
  const int q0 = (n_qt - 1 - blockIdx.z) * kT;
  const int kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int64_t ldq = (int64_t)p.H * D, ldk = (int64_t)p.KVH * D;
  const int64_t qoff = (int64_t)b * p.Sq * ldq + h * D;
  const bf16* qb = static_cast<const bf16*>(p.q) + qoff;
  const bf16* ob = static_cast<const bf16*>(p.dout) + qoff;
  const bf16* kb = static_cast<const bf16*>(p.k) + (int64_t)b * p.Sk * ldk +
                   kvh * D;
  const bf16* vb = static_cast<const bf16*>(p.v) + (int64_t)b * p.Sk * ldk +
                   kvh * D;
  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};
  int segq[2];
  float lse[2], delta[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    segq[hf] = seg_at(p.seg_q, b, p.Sq, row[hf]);
    const int64_t at = ((int64_t)b * p.H + h) * p.Sq + row[hf];
    lse[hf] = row[hf] < p.Sq ? p.lse_in[at] : 0.f;
    delta[hf] = row[hf] < p.Sq ? p.delta[at] : 0.f;
  }

  const int kend = key_end(p, q0);
  const int n_kt = (kend + kT - 1) / kT;
  load_rows<D, kDqThreads>(sQ, qb, ldq, q0, p.Sq);
  load_rows<D, kDqThreads>(sdO, ob, ldq, q0, p.Sq);
  if (n_kt > 0) {
    load_rows<D, kDqThreads>(sK, kb, ldk, 0, p.Sk);
    load_rows<D, kDqThreads>(sV, vb, ldk, 0, p.Sk);
    if (threadIdx.x < kT)
      stage_seg(sSeg + threadIdx.x, p.seg_k, b, p.Sk, threadIdx.x);
  }
  mma::cp_async_commit();

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[n][c] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1, k0 = kt * kT;
    mma::cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < n_kt) {
      load_rows<D, kDqThreads>(sK + (buf ^ 1) * kT * D, kb, ldk, k0 + kT,
                               p.Sk);
      load_rows<D, kDqThreads>(sV + (buf ^ 1) * kT * D, vb, ldk, k0 + kT,
                               p.Sk);
      if (threadIdx.x < kT)
        stage_seg(sSeg + (buf ^ 1) * kT + threadIdx.x, p.seg_k, b, p.Sk,
                  k0 + kT + threadIdx.x);
    }
    mma::cp_async_commit();
    const bf16* ck = sK + buf * kT * D;
    const bf16* cv = sV + buf * kT * D;
    const int* cseg = sSeg + buf * kT;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      mma::load_a(qa, sQ, D, warp * 16, kk * 16, lane);
      mma::load_a(oa, sdO, D, warp * 16, kk * 16, lane);
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        uint32_t bk[4], bv[4];
        mma::load_b(bk, ck, D, pr * 16, kk * 16, lane);
        mma::load_b(bv, cv, D, pr * 16, kk * 16, lane);
        mma::mma16816(s[2 * pr], qa, bk[0], bk[1]);
        mma::mma16816(s[2 * pr + 1], qa, bk[2], bk[3]);
        mma::mma16816(dp[2 * pr], oa, bv[0], bv[1]);
        mma::mma16816(dp[2 * pr + 1], oa, bv[2], bv[3]);
      }
    }
    // dS = P (dP - delta) scale on the valid pairs
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1, cl = j * 8 + 2 * t4 + (c & 1);
        float ds = 0.f;
        if (allowed(p, row[hf], k0 + cl, segq[hf], cseg[cl])) {
          const float pr = __expf(s[j][c] * p.scale - lse[hf]);
          ds = pr * (dp[j][c] - delta[hf]) * p.scale;
        }
        s[j][c] = ds;
      }
    // dQ += dS K, dS as A fragments in two bf16 terms (hi + lo)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t dh[4], dl[4];
      mma::c_to_a_split(dh, dl, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        mma::load_b_t(bk, ck, D, np * 16, kk * 16, lane);
        mma::mma16816(dq[2 * np], dh, bk[0], bk[1]);
        mma::mma16816(dq[2 * np + 1], dh, bk[2], bk[3]);
        mma::mma16816(dq[2 * np], dl, bk[0], bk[1]);
        mma::mma16816(dq[2 * np + 1], dl, bk[2], bk[3]);
      }
    }
  }
  mma::cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qi = row[hf];
    if (qi >= p.Sq) continue;
    bf16* dst = out + ((int64_t)b * p.Sq + qi) * ldq + h * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma::store_bf16x2(dst + n * 8, dq[n][hf * 2], dq[n][hf * 2 + 1]);
  }
}

// backward dK/dV: one 128-thread block per (kv head, b, 64-row key
// tile), walking the group's query heads and their q tiles (from the
// diagonal on when causal, plus any earlier tile that holds a row with
// no valid key), so GQA sums in-block with no atomics. K and V are
// staged once; Q and dO stream through 2 stages. Each warp owns 16 keys
// and every query of the tile: dP^T = V dO^T and S^T = K Q^T on the
// tensor cores, P^T and dS^T on their fragments, then dV += P^T dO and
// dK += dS^T Q with P^T and dS^T as A fragments straight from the
// registers (in two bf16 terms, hi + lo) and dO and Q through
// ldmatrix.trans. One barrier per q tile.
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 2)
    flash_bwd_dkv_tc(Params p) {
  constexpr int KD = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kT * D;
  bf16* sQ = sV + kT * D;          // 2 stages
  bf16* sdO = sQ + 2 * kT * D;     // 2 stages
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kT * D);   // 2 x kT
  float* sDelta = sLse + 2 * kT;                              // 2 x kT
  int* sSegq = reinterpret_cast<int*>(sDelta + 2 * kT);       // 2 x kT
  unsigned* sDead = reinterpret_cast<unsigned*>(sSegq + 2 * kT);

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kT;          // early tiles see most queries
  const int rep = p.H / p.KVH;
  const int n_qt = (p.Sq + kT - 1) / kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int64_t ldq = (int64_t)p.H * D, ldk = (int64_t)p.KVH * D;
  const bf16* kb = static_cast<const bf16*>(p.k) + (int64_t)b * p.Sk * ldk +
                   kvh * D;
  const bf16* vb = static_cast<const bf16*>(p.v) + (int64_t)b * p.Sk * ldk +
                   kvh * D;
  const float uniform = 1.f / (float)p.Sk;
  const int key[2] = {k0 + warp * 16 + (lane >> 2),
                      k0 + warp * 16 + (lane >> 2) + 8};
  const int segk[2] = {seg_at(p.seg_k, b, p.Sk, key[0]),
                       seg_at(p.seg_k, b, p.Sk, key[1])};

  // the first q tile with a valid pair for this key tile (causal)
  int t_first = 0;
  if (p.causal)
    while (t_first < n_qt && key_end(p, t_first * kT) <= k0) ++t_first;
  // Earlier q tiles matter only where a row has no valid key at all
  // (possible with segment ids or Sq > Sk): find them once, every warp
  // testing 4 (head, q tile) items at a time, as bits in shared memory.
  const int h0 = kvh * rep, n_items = rep * n_qt;
  const int n_scan = (p.causal && (p.seg_q != nullptr || p.Sq > p.Sk))
                         ? rep * t_first : 0;
  for (int i = threadIdx.x; i < (n_items + 31) / 32; i += kDkvThreads)
    sDead[i] = 0u;
  load_rows<D, kDkvThreads>(sK, kb, ldk, k0, p.Sk);
  load_rows<D, kDkvThreads>(sV, vb, ldk, k0, p.Sk);
  __syncthreads();
  for (int base = warp * 4; base < n_scan; base += 4 * (kDkvThreads / 32)) {
    bool dead[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int item = base + u, hl = item / max(t_first, 1);
      const int t = item - hl * t_first;
      const float* lr =
          p.lse_in + ((int64_t)b * p.H + h0 + hl) * p.Sq + t * kT;
      const int i0 = t * kT + lane;
      dead[u] = item < n_scan &&
                ((i0 < p.Sq && lr[lane] <= 0.5f * kMasked) ||
                 (i0 + 32 < p.Sq && lr[lane + 32] <= 0.5f * kMasked));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int item = base + u, hl = item / max(t_first, 1);
      const int bit = hl * n_qt + item - hl * t_first;
      if (__any_sync(0xffffffffu, dead[u]) && lane == 0)
        atomicOr(sDead + (bit >> 5), 1u << (bit & 31));
    }
  }
  __syncthreads();
  // items are (h, t) in order, h = h0 + idx / n_qt; the next visited
  // item at or after idx
  auto next_item = [&](int idx) -> int {
    while (idx < n_items && idx % n_qt < t_first &&
           !((sDead[idx >> 5] >> (idx & 31)) & 1u))
      ++idx;
    return idx;
  };
  auto issue = [&](int idx, int buf) {
    const int h = h0 + idx / n_qt, q0 = (idx % n_qt) * kT;
    const int64_t qoff = (int64_t)b * p.Sq * ldq + h * D;
    load_rows<D, kDkvThreads>(sQ + buf * kT * D,
                              static_cast<const bf16*>(p.q) + qoff, ldq, q0,
                              p.Sq);
    load_rows<D, kDkvThreads>(sdO + buf * kT * D,
                              static_cast<const bf16*>(p.dout) + qoff, ldq,
                              q0, p.Sq);
    if (threadIdx.x < kT) {
      const int qi = q0 + threadIdx.x;
      const int64_t row = ((int64_t)b * p.H + h) * p.Sq;
      const int n = qi < p.Sq ? 4 : 0;   // past the end: zero-filled
      mma::cp_async4(sLse + buf * kT + threadIdx.x,
                     p.lse_in + row + (n ? qi : 0), n);
      mma::cp_async4(sDelta + buf * kT + threadIdx.x,
                     p.delta + row + (n ? qi : 0), n);
      stage_seg(sSegq + buf * kT + threadIdx.x, p.seg_q, b, p.Sq, qi);
    }
  };

  int cur = next_item(0);
  if (cur < n_items) issue(cur, 0);
  mma::cp_async_commit();
  int nxt = cur < n_items ? next_item(cur + 1) : n_items;

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  for (int buf = 0; cur < n_items; buf ^= 1) {
    mma::cp_async_wait<0>();
    __syncthreads();
    if (nxt < n_items) issue(nxt, buf ^ 1);
    mma::cp_async_commit();
    const int q0 = (cur % n_qt) * kT;
    const bf16* cq = sQ + buf * kT * D;
    const bf16* co = sdO + buf * kT * D;
    const float* clse = sLse + buf * kT;
    const float* cdelta = sDelta + buf * kT;
    const int* csegq = sSegq + buf * kT;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 queries
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      mma::load_a(ka, sK, D, warp * 16, kk * 16, lane);
      mma::load_a(va, sV, D, warp * 16, kk * 16, lane);
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        uint32_t bq[4], bo[4];
        mma::load_b(bq, cq, D, pr * 16, kk * 16, lane);
        mma::load_b(bo, co, D, pr * 16, kk * 16, lane);
        mma::mma16816(s[2 * pr], ka, bq[0], bq[1]);
        mma::mma16816(s[2 * pr + 1], ka, bq[2], bq[3]);
        mma::mma16816(dp[2 * pr], va, bo[0], bo[1]);
        mma::mma16816(dp[2 * pr + 1], va, bo[2], bo[3]);
      }
    }
    // P^T into s, dS^T into dp (rows: keys, columns: queries)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1, ql = j * 8 + 2 * t4 + (c & 1);
        const float L = clse[ql];
        float pr = 0.f, ds = 0.f;
        if (allowed(p, q0 + ql, key[hf], csegq[ql], segk[hf])) {
          pr = __expf(s[j][c] * p.scale - L);
          ds = pr * (dp[j][c] - cdelta[ql]) * p.scale;
        } else if (L <= 0.5f * kMasked && q0 + ql < p.Sq &&
                   key[hf] < p.Sk) {
          pr = uniform;   // a row with no valid key: dV += dO / Sk
        }
        s[j][c] = pr;
        dp[j][c] = ds;
      }
    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      mma::c_to_a_split(ph, pl, s[2 * kk], s[2 * kk + 1]);
      mma::c_to_a_split(dh, dl, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bo[4], bq[4];
        mma::load_b_t(bo, co, D, np * 16, kk * 16, lane);
        mma::load_b_t(bq, cq, D, np * 16, kk * 16, lane);
        mma::mma16816(dv[2 * np], ph, bo[0], bo[1]);
        mma::mma16816(dv[2 * np + 1], ph, bo[2], bo[3]);
        mma::mma16816(dv[2 * np], pl, bo[0], bo[1]);
        mma::mma16816(dv[2 * np + 1], pl, bo[2], bo[3]);
        mma::mma16816(dk[2 * np], dh, bq[0], bq[1]);
        mma::mma16816(dk[2 * np + 1], dh, bq[2], bq[3]);
        mma::mma16816(dk[2 * np], dl, bq[0], bq[1]);
        mma::mma16816(dk[2 * np + 1], dl, bq[2], bq[3]);
      }
    }
    cur = nxt;
    nxt = cur < n_items ? next_item(cur + 1) : n_items;
  }
  mma::cp_async_wait<0>();

  bf16* dk_out = static_cast<bf16*>(p.out);
  bf16* dv_out = static_cast<bf16*>(p.out2);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (key[hf] >= p.Sk) continue;
    const int64_t off = ((int64_t)b * p.Sk + key[hf]) * ldk + kvh * D +
                        2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mma::store_bf16x2(dk_out + off + n * 8, dk[n][hf * 2], dk[n][hf * 2 + 1]);
      mma::store_bf16x2(dv_out + off + n * 8, dv[n][hf * 2], dv[n][hf * 2 + 1]);
    }
  }
}

template <int D>
constexpr int fwd_smem() {
  return 5 * kT * D * (int)sizeof(bf16) + 2 * kT * (int)sizeof(int);
}
template <int D>
constexpr int dq_smem() {
  return 6 * kT * D * (int)sizeof(bf16) + 2 * kT * (int)sizeof(int);
}
// + one bit per (head of the group, q tile), see flash_bwd_dkv_tc
template <int D>
constexpr int dkv_smem() {
  return 6 * kT * D * (int)sizeof(bf16) + 6 * kT * (int)sizeof(float);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int smem, dim3 grid,
                   const Params& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run(int which, const Params& p, cudaStream_t stream) {
  const int n_qt = (p.Sq + kT - 1) / kT;
  const int n_kt = (p.Sk + kT - 1) / kT;
  if (which == 0)
    return launch(flash_fwd_tc<D>, kFwdThreads, fwd_smem<D>(),
                  dim3(p.H, p.B, n_qt), p, stream);
  if (which == 1)
    return launch(flash_bwd_dkv_tc<D>, kDkvThreads,
                  dkv_smem<D>() + 4 * ((p.H / p.KVH * n_qt + 31) / 32),
                  dim3(p.KVH, p.B, n_kt), p, stream);
  return launch(flash_bwd_dq_tc<D>, kDqThreads, dq_smem<D>(),
                dim3(p.H, p.B, n_qt), p, stream);
}

}  // namespace tc

int dispatch(int which, const Params& p, int D, int dtype, void* stream) {
  if (p.B == 0 || p.Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return tc::run<128>(which, p, st);
  if (dtype == 1 && D == 64) return tc::run<64>(which, p, st);
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
