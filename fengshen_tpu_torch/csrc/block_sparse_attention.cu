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
// the block, so there is no ragged edge). The forward scales q in fp32
// before the product, as the TPU kernel does (:45), keeps the online max
// and sum in fp32 and writes out = acc / max(sum, 1e-30) and lse = max +
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
// tensor cores become the limit (chip_smoke.py computes both). This
// first kernel multiplies on the CUDA cores in fp32, so its own FMA rate
// bounds it, far above either (PERF.md).
//
// Design (simple and right first): the tiles of K1 (attention_tiles.cuh)
// inside the blocks of the layout. One 256-thread block per (b * H + h,
// 64-row query tile) for the forward and dQ: it walks the present key
// blocks of its query block in 64-key tiles, holding the online-softmax
// state (forward) or the dQ sum (backward) in registers; one per (b * H
// + h, 64-row key tile) for dK/dV: it walks the present query blocks of
// its key block, so each dK/dV row is summed in one block, with no
// atomics, and a key block no query block reaches writes zeros. A block
// of 128 tokens is two tiles; any multiple of 64 works. Offsets are
// 64-bit (B * S * H * D may pass 2^31).
// Later work: bf16 mma.sync/wgmma fragments and cp.async/TMA pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"

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
  const int q0 = blockIdx.y * kBQ;
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
  const int q0 = blockIdx.y * kBQ;
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
  const int k0 = blockIdx.y * kBK;
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
  const unsigned bh = (unsigned)p.B * p.H;
  if (which == 0)
    return launch(bs_fwd_kernel<T, D>, fwd_smem<D>(), dim3(bh, p.Sq / kBQ),
                  p, stream);
  if (which == 1)
    return launch(bs_bwd_dkv_kernel<T, D>, dkv_smem<D>(),
                  dim3(bh, p.Sk / kBK), p, stream);
  return launch(bs_bwd_dq_kernel<T, D>, dq_smem<D>(), dim3(bh, p.Sq / kBQ),
                p, stream);
}

int dispatch(int which, const Params& p, int D, int dtype, void* stream) {
  if (p.B == 0 || p.H == 0) return 0;
  if (p.blk < kBQ || p.blk % kBQ || p.Sq % p.blk || p.Sk % p.blk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return run<__nv_bfloat16, 128>(which, p, st);
  if (dtype == 1 && D == 64) return run<__nv_bfloat16, 64>(which, p, st);
  if (dtype == 0 && D == 128) return run<float, 128>(which, p, st);
  if (dtype == 0 && D == 64) return run<float, 64>(which, p, st);
  return (int)cudaErrorInvalidValue;
}

int entry(int which, const void* q, const void* k, const void* v,
          const void* dout, const void* lse_in, const void* delta, void* out,
          void* out2, void* lse_out, const void* ptr, const void* idx, int B,
          int Sq, int Sk, int H, int D, int blk, int dtype, void* stream) {
  Params p{q, k, v, dout, static_cast<const float*>(lse_in),
           static_cast<const float*>(delta), out, out2,
           static_cast<float*>(lse_out), static_cast<const int32_t*>(ptr),
           static_cast<const int32_t*>(idx), B, Sq, Sk, H, blk,
           1.f / sqrtf((float)D)};
  return dispatch(which, p, D, dtype, stream);
}

}  // namespace

extern "C" {

// One signature for the three kernels; each ignores the pointers it does
// not use (null). dtype: 0 = fp32, 1 = bf16 (q, k, v, dout and every
// output but lse share it). ptr / idx: the forward and dQ take the CSR
// of the layout's rows, dK/dV that of its columns. Each returns a
// cudaError_t: 0 when the launch was accepted. The Python wrapper has
// already checked shapes, dtypes, contiguity and the layout's shape.
int fstpu_bs_fwd(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse_in, const void* delta,
                 void* out, void* out2, void* lse_out, const void* ptr,
                 const void* idx, int B, int Sq, int Sk, int H, int D,
                 int blk, int dtype, void* stream) {
  return entry(0, q, k, v, dout, lse_in, delta, out, out2, lse_out, ptr, idx,
               B, Sq, Sk, H, D, blk, dtype, stream);
}

int fstpu_bs_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse_in, const void* delta,
                     void* out, void* out2, void* lse_out, const void* ptr,
                     const void* idx, int B, int Sq, int Sk, int H, int D,
                     int blk, int dtype, void* stream) {
  return entry(1, q, k, v, dout, lse_in, delta, out, out2, lse_out, ptr, idx,
               B, Sq, Sk, H, D, blk, dtype, stream);
}

int fstpu_bs_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse_in, const void* delta,
                    void* out, void* out2, void* lse_out, const void* ptr,
                    const void* idx, int B, int Sq, int Sk, int H, int D,
                    int blk, int dtype, void* stream) {
  return entry(2, q, k, v, dout, lse_in, delta, out, out2, lse_out, ptr, idx,
               B, Sq, Sk, H, D, blk, dtype, stream);
}

}  // extern "C"
