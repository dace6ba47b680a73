// Block-sparse attention for Hopper (sm_90a): kernel K4 of the port,
// forward and both backward kernels.
//
// Replaces the Pallas TPU kernels of
// fengshen_tpu/ops/pallas/block_sparse_attention.py:
//   - fstpu_bs_fwd      <- _bs_fwd_kernel (:30), called at :187 in _bs_fwd_impl
//   - fstpu_bs_bwd_dkv  <- _bs_bwd_dkv_kernel (:70), called at :253
//   - fstpu_bs_bwd_dq   <- _bs_bwd_dq_kernel (:111), called at :285
// and computes the same functions: attention over the present blocks of
// a static [nQ, nK] block layout (blocks of `blk` tokens), nothing else.
// Within a present block every pair counts (Sq and Sk are multiples of
// the block, so there is no ragged edge). The forward scales the scores
// by 1/sqrt(D) (see the two designs below for where), keeps the online
// max and sum in fp32 and writes out = acc / max(sum, 1e-30) and lse = max +
// log(max(sum, 1e-30)): a query block with no present key block writes
// zeros and lse = -1e30. The backward takes delta = rowsum(dO * out)
// from the caller and scales the product after it (:91-93, :130-132):
//   P = exp(scale * Q K^T - lse),  dS = P * (dO V^T - delta) * scale,
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K.
//
// Layouts (no transposes around the kernels): q, k, v, out, dout, dq,
// dk, dv [B, S, H, D]; lse and delta [B, H, Sq] fp32. The layout comes
// as compact lists of present blocks: the forward and dQ take each query
// block's key blocks (CSR: ptr [nQ + 1], idx [nnz]), dK/dV each key
// block's query blocks (the transpose), so no kernel visits an absent
// block and absent blocks cost nothing.
//
// What bounds it on an H100: operations. At Ziya's attention width
// (S = 8192, H = 40, D = 128, a 9 % BigBird layout) the present blocks
// need ~370 bf16 flops per byte moved, above the ~295 at which the
// tensor cores become the limit (chip_smoke.py computes both).
//
// Two designs, one C entry per kernel picking by dtype (the seam counts
// them as the variants "tensor_core" and "fp32_fma"):
//
// bf16 inputs (namespace tc): K1's tensor-core design
// (flash_attention.cu tc::flash_fwd_tc, flash_bwd_dq_tc,
// flash_bwd_dkv_tc) over the layout's block lists. bf16
// mma.sync.m16n8k16 with fp32 accumulators, fed by ldmatrix(.trans) from
// XOR-swizzled 64-row tiles that a two-stage cp.async ring fills
// (mma_tiles.cuh). 128-thread blocks; each warp owns 16 rows:
//   - forward and dQ: one block per (b * H + h, 64-row query tile); Q
//     (forward) stays in registers as A fragments while the block walks
//     the present key blocks of its query block, each block of `blk`
//     tokens as blk / 64 key tiles. Online softmax in fp32; P (forward)
//     and dS (dQ) enter P V and dS K as two bf16 terms, hi + lo, so they
//     keep fp32 accuracy (a single bf16 rounding of P put K1's outputs
//     at 1.0-1.3x their element limit). The scale is applied to the fp32
//     scores, as K1's tensor-core kernels do, not to q before the
//     product as the TPU kernel does (:45): the same function, without
//     rounding q * scale to bf16. lse and delta are staged with 4-byte
//     cp.async beside the tiles.
//   - dK/dV: one block per (b * H + h, 64-row key tile), walking the
//     present query blocks of its key block; four warps each own 16
//     keys and keep P^T and dS^T in registers as A fragments, so each
//     q tile costs one barrier, and each dK/dV row is summed inside one
//     block, with no atomics. Each q tile is taken in two halves of 32
//     queries, so only 16 x 32 score fragments live beside the dK and dV
//     sums and the registers hold them without spilling.
// fp32 inputs keep the first kernels: the fp32 tiles of K1
// (attention_tiles.cuh) on the CUDA cores, 256-thread blocks, the
// forward scaling q in fp32 before the product as the TPU kernel does.
//
// Heavy rows first: BigBird's global query blocks reach every key block
// while the others reach ~5, and its global key columns are reached by
// every query block. The host orders the layout's query blocks (and, for
// dK/dV, its key blocks) by present blocks, most first (`order`, built
// once beside the block lists), and grid row y takes tile y % (blk / 64)
// of block order[y / (blk / 64)]: the long tiles start first instead of
// setting the kernel's time by starting last. Either design walks the
// grid this way. Offsets are 64-bit (B * S * H * D may pass 2^31).

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
  const float* lse_in;    // backward: the forward's lse
  const float* delta;     // backward: rowsum(dO * out)
  void* out;              // fwd: out; dkv: dk; dq: dq
  void* out2;             // dkv: dv
  float* lse_out;         // fwd: lse
  const int32_t* ptr;     // fwd, dq: per query block; dkv: per key block
  const int32_t* idx;     // the present blocks of each, ascending
  const int32_t* order;   // the blocks of ptr, most present blocks first
  int B, Sq, Sk, H;
  int blk;                // tokens per layout block, a multiple of 64
  float scale;
};

// Offset of row `s` of head `bh` (= b * H + h) in a [B, S, H, D] tensor.
template <int D>
__device__ __forceinline__ int64_t row_off(const Params& p, int bh, int S,
                                           int s) {
  const int b = bh / p.H, h = bh % p.H;
  return ((int64_t)b * S + s) * p.H * D + (int64_t)h * D;
}

// First row of the tile that grid row y walks: tile y % (blk / tile) of
// block order[y / (blk / tile)], heaviest blocks first.
__device__ __forceinline__ int tile_start(const Params& p, int y, int tile) {
  const int per = p.blk / tile;
  return p.order[y / per] * p.blk + (y % per) * tile;
}

// ---------------------------------------------------------------------------
// forward: one block per (b * H + h, 64-row query tile)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) bs_fwd_kernel(Params p) {
  constexpr int P = D + 4;
  constexpr int C = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBQ * P;
  float* Vs = Ks + kBK * P;
  float* Ps = Vs + kBK * P;

  const int bh = blockIdx.x;
  const int q0 = tile_start(p, blockIdx.y, kBQ);
  const int qb = q0 / p.blk;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int64_t ld = (int64_t)p.H * D;

  load_tile<T, D, kBQ>(Qs, q + row_off<D>(p, bh, p.Sq, q0), ld, kBQ);
  __syncthreads();
  // q * scale in fp32 before the product, as the TPU forward does
  for (int i = tid; i < kBQ * P; i += kThreads) Qs[i] *= p.scale;

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  for (int e = p.ptr[qb]; e < p.ptr[qb + 1]; ++e) {
    const int kb = p.idx[e];
    for (int k0 = kb * p.blk; k0 < (kb + 1) * p.blk; k0 += kBK) {
      __syncthreads();
      load_tile<T, D, kBK>(Ks, k + row_off<D>(p, bh, p.Sk, k0), ld, kBK);
      load_tile<T, D, kBK>(Vs, v + row_off<D>(p, bh, p.Sk, k0), ld, kBK);
      __syncthreads();

      float s[4][4];
      dots<D>(s, Qs, Ks, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float mx = kMasked;
#pragma unroll
        for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
        const float m_new = fmaxf(m[i], row_max(mx));
        const float corr = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pr = expf(s[i][j] - m_new);
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
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    const float denom = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / denom;
    T* row = out + row_off<D>(p, bh, p.Sq, qi);
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      store4(row + g * 64 + tx * 4,
             make_float4(acc[i][g * 4] * inv, acc[i][g * 4 + 1] * inv,
                         acc[i][g * 4 + 2] * inv, acc[i][g * 4 + 3] * inv));
    if (tx == 0) p.lse_out[(int64_t)bh * p.Sq + qi] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// backward dQ: one block per (b * H + h, 64-row query tile)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) bs_bwd_dq_kernel(Params p) {
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

  const int bh = blockIdx.x;
  const int q0 = tile_start(p, blockIdx.y, kBQ);
  const int qb = q0 / p.blk;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int64_t ld = (int64_t)p.H * D;

  load_tile<T, D, kBQ>(Qs, q + row_off<D>(p, bh, p.Sq, q0), ld, kBQ);
  load_tile<T, D, kBQ>(dOs, dout + row_off<D>(p, bh, p.Sq, q0), ld, kBQ);
  if (tid < kBQ) {
    lse_s[tid] = p.lse_in[(int64_t)bh * p.Sq + q0 + tid];
    delta_s[tid] = p.delta[(int64_t)bh * p.Sq + q0 + tid];
  }

  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  for (int e = p.ptr[qb]; e < p.ptr[qb + 1]; ++e) {
    const int kb = p.idx[e];
    for (int k0 = kb * p.blk; k0 < (kb + 1) * p.blk; k0 += kBK) {
      __syncthreads();
      load_tile<T, D, kBK>(Ks, k + row_off<D>(p, bh, p.Sk, k0), ld, kBK);
      load_tile<T, D, kBK>(Vs, v + row_off<D>(p, bh, p.Sk, k0), ld, kBK);
      __syncthreads();

      float s[4][4], dp[4][4];
      dots<D>(s, Qs, Ks, ty, tx);
      dots<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pr = expf(s[i][j] * p.scale - lse_s[r]);
          dSs[r * kPadP + tx + 16 * j] =
              pr * (dp[i][j] - delta_s[r]) * p.scale;
        }
      }
      __syncthreads();
      tile_times_rows<D>(acc, dSs, Ks, ty, tx);
    }
  }

  T* dq = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dq + row_off<D>(p, bh, p.Sq, q0 + ty * 4 + i);
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      store4(row + g * 64 + tx * 4,
             make_float4(acc[i][g * 4], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                         acc[i][g * 4 + 3]));
  }
}

// ---------------------------------------------------------------------------
// backward dK/dV: one block per (b * H + h, 64-row key tile), walking the
// present query blocks of its key block
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) bs_bwd_dkv_kernel(Params p) {
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

  const int bh = blockIdx.x;
  const int k0 = tile_start(p, blockIdx.y, kBK);
  const int kb = k0 / p.blk;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int64_t ld = (int64_t)p.H * D;

  load_tile<T, D, kBK>(Ks, k + row_off<D>(p, bh, p.Sk, k0), ld, kBK);
  load_tile<T, D, kBK>(Vs, v + row_off<D>(p, bh, p.Sk, k0), ld, kBK);

  float dk[4][C], dv[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int e = p.ptr[kb]; e < p.ptr[kb + 1]; ++e) {
    const int qb = p.idx[e];
    for (int q0 = qb * p.blk; q0 < (qb + 1) * p.blk; q0 += kBQ) {
      __syncthreads();
      load_tile<T, D, kBQ>(Qs, q + row_off<D>(p, bh, p.Sq, q0), ld, kBQ);
      load_tile<T, D, kBQ>(dOs, dout + row_off<D>(p, bh, p.Sq, q0), ld,
                           kBQ);
      if (tid < kBQ) {
        lse_s[tid] = p.lse_in[(int64_t)bh * p.Sq + q0 + tid];
        delta_s[tid] = p.delta[(int64_t)bh * p.Sq + q0 + tid];
      }
      __syncthreads();

      // rows r = query rows (ty*4+i), columns c = keys (tx+16j)
      float s[4][4], dp[4][4];
      dots<D>(s, Qs, Ks, ty, tx);
      dots<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float pr = expf(s[i][j] * p.scale - lse_s[r]);
          Ps[r * kPadP + c] = pr;
          dSs[r * kPadP + c] = pr * (dp[i][j] - delta_s[r]) * p.scale;
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
    const int64_t off = row_off<D>(p, bh, p.Sk, k0 + ty * 4 + i);
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
  return sizeof(float) * ((kBQ + 2 * kBK) * (D + 4) + kBQ * kPadP);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) *
         ((2 * kBQ + 2 * kBK) * (D + 4) + kBQ * kPadP + 2 * kBQ);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         ((2 * kBQ + 2 * kBK) * (D + 4) + 2 * kBQ * kPadP + 2 * kBQ);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, dim3 grid,
                   const Params& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(int which, const Params& p, cudaStream_t stream) {
  const unsigned bh = (unsigned)p.B * p.H;
  if (which == 0)
    return launch(bs_fwd_kernel<T, D>, kThreads, fwd_smem<D>(),
                  dim3(bh, p.Sq / kBQ), p, stream);
  if (which == 1)
    return launch(bs_bwd_dkv_kernel<T, D>, kThreads, dkv_smem<D>(),
                  dim3(bh, p.Sk / kBK), p, stream);
  return launch(bs_bwd_dq_kernel<T, D>, kThreads, dq_smem<D>(),
                dim3(bh, p.Sq / kBQ), p, stream);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

namespace tc {

using mma::bf16;

constexpr int kT = 64;             // rows per query and key tile
constexpr int kTcThreads = 128;    // 4 warps x 16 rows

// Rows [r0, r0 + 64) of one head of a [B, S, H, D] tensor (row r at
// base + r * ld) into a swizzled [64][D] tile; the tile lies inside.
template <int D>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* base,
                                          int64_t ld, int r0) {
  mma::load_tile<kT, D, kTcThreads>(s, base + (int64_t)r0 * ld, ld, kT, D,
                                    true);
}

// First row of the t-th 64-row tile of the list ptr/idx entry e0 on: tile
// t % (blk / 64) of block idx[e0 + t / (blk / 64)].
__device__ __forceinline__ int list_tile(const Params& p, int e0, int t) {
  const int per = p.blk / kT;
  return __ldg(p.idx + e0 + t / per) * p.blk + (t % per) * kT;
}

// forward: one block per (b * H + h, 64-row query tile); each warp owns
// 16 query rows, with Q as mma A fragments in registers for the walk.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2) bs_fwd_tc(Params p) {
  constexpr int NT = D / 8;    // n8 tiles of an output row
  constexpr int KD = D / 16;   // k16 steps over head_dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kT * D;          // 2 stages
  bf16* sV = sK + 2 * kT * D;      // 2 stages

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = tile_start(p, blockIdx.y, kT);
  const int qblk = q0 / p.blk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int64_t ld = (int64_t)p.H * D;
  const bf16* qb = static_cast<const bf16*>(p.q) + (int64_t)b * p.Sq * ld +
                   h * D;
  const bf16* kb = static_cast<const bf16*>(p.k) + (int64_t)b * p.Sk * ld +
                   h * D;
  const bf16* vb = static_cast<const bf16*>(p.v) + (int64_t)b * p.Sk * ld +
                   h * D;
  const int e0 = p.ptr[qblk];
  const int n_kt = (p.ptr[qblk + 1] - e0) * (p.blk / kT);

  load_rows<D>(sQ, qb, ld, q0);
  if (n_kt > 0) {
    const int k0 = list_tile(p, e0, 0);
    load_rows<D>(sK, kb, ld, k0);
    load_rows<D>(sV, vb, ld, k0);
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
    const int buf = kt & 1;
    if (kt > 0) {
      mma::cp_async_wait<0>();
      __syncthreads();
    }
    if (kt + 1 < n_kt) {   // the next tile streams in under this one
      const int k0 = list_tile(p, e0, kt + 1);
      load_rows<D>(sK + (buf ^ 1) * kT * D, kb, ld, k0);
      load_rows<D>(sV + (buf ^ 1) * kT * D, vb, ld, k0);
    }
    mma::cp_async_commit();
    const bf16* ck = sK + buf * kT * D;
    const bf16* cv = sV + buf * kT * D;

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

    // scale and the online softmax on the fragments
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][hf * 2] *= p.scale;
        s[j][hf * 2 + 1] *= p.scale;
        mx = fmaxf(mx, fmaxf(s[j][hf * 2], s[j][hf * 2 + 1]));
      }
      const float m_new = fmaxf(m[hf], mma::quad_max(mx));
      const float corr = __expf(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = __expf(s[j][hf * 2 + e] - m_new);
          s[j][hf * 2 + e] = pr;
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
    // two bf16 terms (hi + lo)
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
  mma::cp_async_wait<0>();

  // a query block with no present key block: o = 0, l = 0, m = -1e30
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qi = q0 + warp * 16 + (lane >> 2) + hf * 8;
    const float denom = fmaxf(mma::quad_sum(l[hf]), 1e-30f);
    const float inv = 1.f / denom;
    bf16* dst = out + ((int64_t)b * p.Sq + qi) * ld + h * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma::store_bf16x2(dst + n * 8, o[n][hf * 2] * inv,
                        o[n][hf * 2 + 1] * inv);
    if (t4 == 0) p.lse_out[(int64_t)bh * p.Sq + qi] = m[hf] + __logf(denom);
  }
}

// backward dQ: one block per (b * H + h, 64-row query tile), the same
// walk as the forward; each warp owns 16 query rows.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2) bs_bwd_dq_tc(Params p) {
  constexpr int NT = D / 8;
  constexpr int KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kT * D;
  bf16* sK = sdO + kT * D;         // 2 stages
  bf16* sV = sK + 2 * kT * D;      // 2 stages
  float* sLse = reinterpret_cast<float*>(sV + 2 * kT * D);   // kT
  float* sDelta = sLse + kT;                                  // kT

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = tile_start(p, blockIdx.y, kT);
  const int qblk = q0 / p.blk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int64_t ld = (int64_t)p.H * D;
  const int64_t qoff = (int64_t)b * p.Sq * ld + h * D;
  const bf16* qb = static_cast<const bf16*>(p.q) + qoff;
  const bf16* ob = static_cast<const bf16*>(p.dout) + qoff;
  const bf16* kb = static_cast<const bf16*>(p.k) + (int64_t)b * p.Sk * ld +
                   h * D;
  const bf16* vb = static_cast<const bf16*>(p.v) + (int64_t)b * p.Sk * ld +
                   h * D;
  const int e0 = p.ptr[qblk];
  const int n_kt = (p.ptr[qblk + 1] - e0) * (p.blk / kT);
  const int r_loc[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};

  load_rows<D>(sQ, qb, ld, q0);
  load_rows<D>(sdO, ob, ld, q0);
  if (threadIdx.x < kT) {
    const int64_t at = (int64_t)bh * p.Sq + q0 + threadIdx.x;
    mma::cp_async4(sLse + threadIdx.x, p.lse_in + at, 4);
    mma::cp_async4(sDelta + threadIdx.x, p.delta + at, 4);
  }
  if (n_kt > 0) {
    const int k0 = list_tile(p, e0, 0);
    load_rows<D>(sK, kb, ld, k0);
    load_rows<D>(sV, vb, ld, k0);
  }
  mma::cp_async_commit();

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[n][c] = 0.f;
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    mma::cp_async_wait<0>();
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        lse[hf] = sLse[r_loc[hf]];
        delta[hf] = sDelta[r_loc[hf]];
      }
    }
    if (kt + 1 < n_kt) {
      const int k0 = list_tile(p, e0, kt + 1);
      load_rows<D>(sK + (buf ^ 1) * kT * D, kb, ld, k0);
      load_rows<D>(sV + (buf ^ 1) * kT * D, vb, ld, k0);
    }
    mma::cp_async_commit();
    const bf16* ck = sK + buf * kT * D;
    const bf16* cv = sV + buf * kT * D;

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
    // dS = P (dP - delta) scale, P = exp(scale S - lse)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1;
        const float pr = __expf(s[j][c] * p.scale - lse[hf]);
        s[j][c] = pr * (dp[j][c] - delta[hf]) * p.scale;
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
    bf16* dst = out + ((int64_t)b * p.Sq + q0 + r_loc[hf]) * ld + h * D +
                2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma::store_bf16x2(dst + n * 8, dq[n][hf * 2], dq[n][hf * 2 + 1]);
  }
}

// The q tile of rows [q0, q0 + 64) of head bh (= b * H + h) for dK/dV: Q
// and dO into swizzled tiles, lse and delta rows by 4-byte cp.async.
template <int D>
__device__ __forceinline__ void stage_q_tile(const Params& p, int bh, int q0,
                                             bf16* sQ, bf16* sdO,
                                             float* sLse, float* sDelta) {
  const int b = bh / p.H, h = bh % p.H;
  const int64_t ld = (int64_t)p.H * D;
  const int64_t qoff = (int64_t)b * p.Sq * ld + h * D;
  load_rows<D>(sQ, static_cast<const bf16*>(p.q) + qoff, ld, q0);
  load_rows<D>(sdO, static_cast<const bf16*>(p.dout) + qoff, ld, q0);
  if (threadIdx.x < kT) {
    const int64_t at = (int64_t)bh * p.Sq + q0 + threadIdx.x;
    mma::cp_async4(sLse + threadIdx.x, p.lse_in + at, 4);
    mma::cp_async4(sDelta + threadIdx.x, p.delta + at, 4);
  }
}

// backward dK/dV: one block per (b * H + h, 64-row key tile), walking
// the present query blocks of its key block. K and V are staged once;
// Q, dO, lse and delta stream through 2 stages. Each warp owns 16 keys
// and every query of the tile: S^T = K Q^T and dP^T = V dO^T on the
// tensor cores, P^T and dS^T on their fragments, then dV += P^T dO and
// dK += dS^T Q with P^T and dS^T as A fragments straight from the
// registers (hi + lo) and dO and Q through ldmatrix.trans, 32 queries at
// a time. One barrier per q tile; a key tile no query block reaches
// writes zeros.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2) bs_bwd_dkv_tc(Params p) {
  constexpr int KD = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kT * D;
  bf16* sQ = sV + kT * D;          // 2 stages
  bf16* sdO = sQ + 2 * kT * D;     // 2 stages
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kT * D);   // 2 x kT
  float* sDelta = sLse + 2 * kT;                              // 2 x kT

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = tile_start(p, blockIdx.y, kT);
  const int kblk = k0 / p.blk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int64_t ld = (int64_t)p.H * D;
  const int e0 = p.ptr[kblk];
  const int n_qt = (p.ptr[kblk + 1] - e0) * (p.blk / kT);
  {
    const int64_t koff = (int64_t)b * p.Sk * ld + h * D;
    load_rows<D>(sK, static_cast<const bf16*>(p.k) + koff, ld, k0);
    load_rows<D>(sV, static_cast<const bf16*>(p.v) + koff, ld, k0);
  }
  if (n_qt > 0)
    stage_q_tile<D>(p, bh, list_tile(p, e0, 0), sQ, sdO, sLse, sDelta);
  mma::cp_async_commit();

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  for (int it = 0; it < n_qt; ++it) {
    const int buf = it & 1;
    mma::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_qt)
      stage_q_tile<D>(p, bh, list_tile(p, e0, it + 1),
                      sQ + (buf ^ 1) * kT * D, sdO + (buf ^ 1) * kT * D,
                      sLse + (buf ^ 1) * kT, sDelta + (buf ^ 1) * kT);
    mma::cp_async_commit();
    const bf16* cq = sQ + buf * kT * D;
    const bf16* co = sdO + buf * kT * D;
    const float* clse = sLse + buf * kT;
    const float* cdelta = sDelta + buf * kT;

    // Two halves of 32 queries each, one after the other, so that only
    // 16 x 32 score fragments are live beside the dK and dV sums.
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int h0 = half * 32;
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 32 queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < KD; ++kk) {   // not unrolled: fewer live loads
        uint32_t ka[4], va[4];
        mma::load_a(ka, sK, D, warp * 16, kk * 16, lane);
        mma::load_a(va, sV, D, warp * 16, kk * 16, lane);
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          uint32_t bq[4], bo[4];
          mma::load_b(bq, cq, D, h0 + pr * 16, kk * 16, lane);
          mma::load_b(bo, co, D, h0 + pr * 16, kk * 16, lane);
          mma::mma16816(s[2 * pr], ka, bq[0], bq[1]);
          mma::mma16816(s[2 * pr + 1], ka, bq[2], bq[3]);
          mma::mma16816(dp[2 * pr], va, bo[0], bo[1]);
          mma::mma16816(dp[2 * pr + 1], va, bo[2], bo[3]);
        }
      }
      // P^T into s, dS^T into dp (rows: keys, columns: queries)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ql = h0 + j * 8 + 2 * t4 + (c & 1);
          const float pr = __expf(s[j][c] * p.scale - clse[ql]);
          s[j][c] = pr;
          dp[j][c] = pr * (dp[j][c] - cdelta[ql]) * p.scale;
        }
      // dV += P^T dO and dK += dS^T Q over the half's 32 queries
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        mma::c_to_a_split(ph, pl, s[2 * kk], s[2 * kk + 1]);
        mma::c_to_a_split(dh, dl, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bo[4], bq[4];
          mma::load_b_t(bo, co, D, np * 16, h0 + kk * 16, lane);
          mma::load_b_t(bq, cq, D, np * 16, h0 + kk * 16, lane);
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
    }
  }
  mma::cp_async_wait<0>();

  bf16* dk_out = static_cast<bf16*>(p.out);
  bf16* dv_out = static_cast<bf16*>(p.out2);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + warp * 16 + (lane >> 2) + hf * 8;
    const int64_t off = ((int64_t)b * p.Sk + key) * ld + h * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mma::store_bf16x2(dk_out + off + n * 8, dk[n][hf * 2],
                        dk[n][hf * 2 + 1]);
      mma::store_bf16x2(dv_out + off + n * 8, dv[n][hf * 2],
                        dv[n][hf * 2 + 1]);
    }
  }
}

// Dynamic shared memory of each kernel: bf16 tiles of 64 x D, plus fp32
// lse and delta rows.
template <int D>
constexpr size_t fwd_smem() {
  return 5 * kT * D * sizeof(bf16);
}
template <int D>
constexpr size_t dq_smem() {
  return 6 * kT * D * sizeof(bf16) + 2 * kT * sizeof(float);
}
template <int D>
constexpr size_t dkv_smem() {
  return 6 * kT * D * sizeof(bf16) + 4 * kT * sizeof(float);
}

template <int D>
cudaError_t run(int which, const Params& p, cudaStream_t stream) {
  const unsigned bh = (unsigned)p.B * p.H;
  if (which == 0)
    return launch(bs_fwd_tc<D>, kTcThreads, fwd_smem<D>(),
                  dim3(bh, p.Sq / kT), p, stream);
  if (which == 1)
    return launch(bs_bwd_dkv_tc<D>, kTcThreads, dkv_smem<D>(),
                  dim3(bh, p.Sk / kT), p, stream);
  return launch(bs_bwd_dq_tc<D>, kTcThreads, dq_smem<D>(),
                dim3(bh, p.Sq / kT), p, stream);
}

}  // namespace tc

int dispatch(int which, const Params& p, int D, int dtype, void* stream) {
  if (p.B == 0 || p.H == 0) return 0;
  if (p.blk < kBQ || p.blk % kBQ || p.Sq % p.blk || p.Sk % p.blk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return tc::run<128>(which, p, st);
  if (dtype == 1 && D == 64) return tc::run<64>(which, p, st);
  if (dtype == 0 && D == 128) return run<float, 128>(which, p, st);
  if (dtype == 0 && D == 64) return run<float, 64>(which, p, st);
  return (int)cudaErrorInvalidValue;
}

int entry(int which, const void* q, const void* k, const void* v,
          const void* dout, const void* lse_in, const void* delta, void* out,
          void* out2, void* lse_out, const void* ptr, const void* idx,
          const void* order, int B, int Sq, int Sk, int H, int D, int blk,
          int dtype, void* stream) {
  Params p{q, k, v, dout, static_cast<const float*>(lse_in),
           static_cast<const float*>(delta), out, out2,
           static_cast<float*>(lse_out), static_cast<const int32_t*>(ptr),
           static_cast<const int32_t*>(idx),
           static_cast<const int32_t*>(order), B, Sq, Sk, H, blk,
           1.f / sqrtf((float)D)};
  return dispatch(which, p, D, dtype, stream);
}

}  // namespace

extern "C" {

// One signature for the three kernels; each ignores the pointers it does
// not use (null). dtype: 0 = fp32, 1 = bf16 (q, k, v, dout and every
// output but lse share it). ptr / idx / order: the forward and dQ take
// the CSR of the layout's rows and its rows heaviest first, dK/dV the
// same of its columns. Each returns a
// cudaError_t: 0 when the launch was accepted. The Python wrapper has
// already checked shapes, dtypes, contiguity and the layout's shape.
int fstpu_bs_fwd(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse_in, const void* delta,
                 void* out, void* out2, void* lse_out, const void* ptr,
                 const void* idx, const void* order, int B, int Sq, int Sk,
                 int H, int D, int blk, int dtype, void* stream) {
  return entry(0, q, k, v, dout, lse_in, delta, out, out2, lse_out, ptr, idx,
               order, B, Sq, Sk, H, D, blk, dtype, stream);
}

int fstpu_bs_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse_in, const void* delta,
                     void* out, void* out2, void* lse_out, const void* ptr,
                     const void* idx, const void* order, int B, int Sq,
                     int Sk, int H, int D, int blk, int dtype,
                     void* stream) {
  return entry(1, q, k, v, dout, lse_in, delta, out, out2, lse_out, ptr, idx,
               order, B, Sq, Sk, H, D, blk, dtype, stream);
}

int fstpu_bs_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse_in, const void* delta,
                    void* out, void* out2, void* lse_out, const void* ptr,
                    const void* idx, const void* order, int B, int Sq, int Sk,
                    int H, int D, int blk, int dtype, void* stream) {
  return entry(2, q, k, v, dout, lse_in, delta, out, out2, lse_out, ptr, idx,
               order, B, Sq, Sk, H, D, blk, dtype, stream);
}

}  // extern "C"
