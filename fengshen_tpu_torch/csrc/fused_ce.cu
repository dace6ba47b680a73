// Fused LM-head cross-entropy for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces the Pallas TPU kernels of fengshen_tpu/ops/pallas/fused_ce.py:
//   - fstpu_ce_fwd     <- _ce_fwd_kernel (:79), called at :228 in
//                         _token_stats_impl
//   - fstpu_ce_bwd_dx  <- _ce_bwd_dx_kernel (:130), called at :282
//   - fstpu_ce_bwd_dk  <- _ce_bwd_dk_kernel (:161), called at :307
// and computes the same functions of x [T, H], the head K [H, V] (both
// bf16 or both fp32) and labels [T] int32, with fp32 scores s = x K from
// fp32 products (the scores are never rounded to the inputs' dtype):
//   forward: per token lse = logsumexp_v s, gold = s[label] (0 when the
//            label is outside [0, V), as `cols == lab` never matches),
//            amax = the first index of the largest score;
//   dx:      dx = d K^T,  d = c_lse * exp(s - lse) + c_gold * onehot(label),
//            cast to x's dtype;
//   dK:      dK = x^T d, cast to K's dtype.
// The [T, V] scores never exist whole: at T = 32767, V = 32000 they
// would take 3.9 GiB in fp32.
//
// What bounds it on an H100: operations. One pass over the scores is
// 2 T V H flops (8.6 TFLOP at T = 32767, H = 4096, V = 32000), against
// ~0.5 GB of inputs, ~16,000 flops per byte: far above the ~295 at
// which the bf16 tensor cores, not memory, would be the limit.
//
// Design (simple and right first; PERF.md has its time against the
// bound, the plain version and torch's materialised-logits CE):
// - one product core for all three kernels: a 256-thread block computes
//   a 128 x 128 tile of a product as fp32 FMAs on the CUDA cores, 16
//   deep at a time through shared memory (operands converted to fp32 as
//   they are staged), each thread an 8 x 8 block of the tile in
//   registers; operands are read through (row, column) strides, so one
//   core serves x K, d K^T and x^T d with no transposed copies;
// - forward: one block per 128-token tile loops over all vocab tiles
//   and keeps each token's online max / sum-exp / gold / running argmax
//   in registers (the TPU kernel's scratch across its sequential vocab
//   axis); the 16 threads that share a token combine at the end;
// - backward: the Pallas dK kernel keeps an [H, block_v] fp32
//   accumulator (4 MiB at H = 4096) in VMEM, which no SM's 228 KB of
//   shared memory holds, and tiling H instead would recompute each score
//   tile H / 128 times. Here the caller walks the tokens in chunks: for
//   each chunk fstpu_ce_bwd_dx recomputes d once into an fp32 workspace
//   [chunk, V] (125 MiB at 1024 tokens) and computes the chunk's dx =
//   d K^T; fstpu_ce_bwd_dk then adds the chunk's x^T d into an fp32
//   [H, V] sum, and the last chunk writes dK in K's dtype;
// - every offset is 64-bit (T V passes 2^31 elements here), and ragged
//   edges (T, V, H that no tile divides) read zeros and write nothing.
// Later work: bf16 wgmma/mma.sync fragments, TMA pipelining, and no d
// workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;            // rows and columns of a block tile
constexpr int kDepth = 16;            // reduction depth staged per step
constexpr int kPitch = kTile + 4;     // shared pitch (keeps float4 rows)
constexpr float kMasked = -1e30f;     // the TPU kernels' _NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One operand of a product: element (r, c) lies at ptr[r * sr + c * sc];
// rows >= nr and columns >= nc read as zero.
template <typename T>
struct Operand {
  const T* ptr;
  int64_t sr, sc;
  int nr, nc;
  __device__ __forceinline__ float at(int r, int c) const {
    return (r < nr && c < nc) ? to_f(ptr[(int64_t)r * sr + (int64_t)c * sc])
                              : 0.f;
  }
};

// The thread's rows (columns) of a tile: ty*4 + {0..3} and 64 + ty*4 +
// {0..3}, so its float4 reads of a staged row are 16 bytes apart from
// its neighbours'.
__device__ __forceinline__ int lane_row(int q, int i) {
  return (i < 4 ? 0 : 64) + q * 4 + (i & 3);
}

// acc[i][j] = sum_k A(m0 + row i, k) * B(k, n0 + col j) over k < kdim.
// A is staged as As[k][m], B as Bs[k][n]. A_KFAST / B_NFAST say which
// index is contiguous in global memory, so neighbouring threads load
// neighbouring addresses.
template <typename TA, typename TB, bool A_KFAST, bool B_NFAST>
__device__ __forceinline__ void tile_product(float (&acc)[8][8],
                                             const Operand<TA>& a,
                                             const Operand<TB>& b, int m0,
                                             int n0, int kdim, float* As,
                                             float* Bs) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kdim; k0 += kDepth) {
    __syncthreads();
    for (int e = tid; e < kTile * kDepth; e += kThreads) {
      const int kk = A_KFAST ? e % kDepth : e / kTile;
      const int mm = A_KFAST ? e / kDepth : e % kTile;
      As[kk * kPitch + mm] = a.at(m0 + mm, k0 + kk);
    }
    for (int e = tid; e < kTile * kDepth; e += kThreads) {
      const int kk = B_NFAST ? e / kTile : e % kDepth;
      const int nn = B_NFAST ? e % kTile : e / kDepth;
      Bs[kk * kPitch + nn] = b.at(k0 + kk, n0 + nn);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float* arow = As + kk * kPitch;
      const float* brow = Bs + kk * kPitch;
      const float4 a0 = *reinterpret_cast<const float4*>(arow + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(arow + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(brow + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(brow + 64 + tx * 4);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward: one block per 128-token tile, looping over the vocab tiles
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* x, const T* w, const int32_t* labels, float* lse,
                  float* gold, int32_t* amax, int n_tok, int H, int V) {
  __shared__ __align__(16) float As[kDepth * kPitch];
  __shared__ __align__(16) float Bs[kDepth * kPitch];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = blockIdx.x * kTile;
  const Operand<T> a{x, H, 1, n_tok, H};     // (token, h)
  const Operand<T> b{w, V, 1, H, V};         // (h, vocab)

  int lab[8];
  float m[8], l[8], g[8], best[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = t0 + lane_row(ty, i);
    lab[i] = r < n_tok ? labels[r] : -1;
    m[i] = kMasked;
    l[i] = 0.f;
    g[i] = 0.f;
    best[i] = -__int_as_float(0x7f800000);   // -inf
    arg[i] = 0x7fffffff;
  }

  float acc[8][8];
  for (int v0 = 0; v0 < V; v0 += kTile) {
    tile_product<T, T, true, true>(acc, a, b, t0, v0, H, As, Bs);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = v0 + lane_row(tx, j);   // increasing in j
        if (c < V) {
          const float s = acc[i][j];
          mx = fmaxf(mx, s);
          if (c == lab[i]) g[i] += s;
          if (s > best[i]) {                  // first max within the thread
            best[i] = s;
            arg[i] = c;
          }
        }
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (v0 + lane_row(tx, j) < V) sum += expf(acc[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }

  // the 16 lanes that share a token (tx = lane % 16) combine their stats
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float ol = __shfl_xor_sync(0xffffffffu, l[i], o);
      const float og = __shfl_xor_sync(0xffffffffu, g[i], o);
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[i], o);
      const float mm = fmaxf(m[i], om);
      l[i] = l[i] * expf(m[i] - mm) + ol * expf(om - mm);
      m[i] = mm;
      g[i] += og;
      if (ob > best[i] || (ob == best[i] && oa < arg[i])) {
        best[i] = ob;
        arg[i] = oa;
      }
    }
    const int r = t0 + lane_row(ty, i);
    if (tx == 0 && r < n_tok) {
      lse[r] = m[i] + logf(fmaxf(l[i], 1e-30f));
      gold[r] = g[i];
      amax[r] = arg[i];
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// d[t, v] = c_lse[t] * exp(s[t, v] - lse[t]) + c_gold[t] * (v == label[t])
// for one chunk of n_tok tokens; one block per (vocab tile, token tile).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_d_kernel(const T* x, const T* w, const int32_t* labels,
                const float* lse, const float* c_lse, const float* c_gold,
                float* d, int n_tok, int H, int V) {
  __shared__ __align__(16) float As[kDepth * kPitch];
  __shared__ __align__(16) float Bs[kDepth * kPitch];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int v0 = blockIdx.x * kTile, t0 = blockIdx.y * kTile;
  const Operand<T> a{x, H, 1, n_tok, H};
  const Operand<T> b{w, V, 1, H, V};
  float acc[8][8];
  tile_product<T, T, true, true>(acc, a, b, t0, v0, H, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = t0 + lane_row(ty, i);
    if (r >= n_tok) continue;
    const float L = lse[r], cl = c_lse[r], cg = c_gold[r];
    const int lab = labels[r];
    float* row = d + (int64_t)r * V;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = v0 + lane_row(tx, j);
      if (c < V) row[c] = cl * expf(acc[i][j] - L) + (c == lab ? cg : 0.f);
    }
  }
}

// dx[t, h] = sum_v d[t, v] K[h, v], in x's dtype; one block per
// (h tile, token tile).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_dx_kernel(const float* d, const T* w, T* dx, int n_tok, int H, int V) {
  __shared__ __align__(16) float As[kDepth * kPitch];
  __shared__ __align__(16) float Bs[kDepth * kPitch];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h0 = blockIdx.x * kTile, t0 = blockIdx.y * kTile;
  const Operand<float> a{d, V, 1, n_tok, V};   // (token, vocab)
  const Operand<T> b{w, 1, V, V, H};           // (vocab, h) = K^T
  float acc[8][8];
  tile_product<float, T, true, false>(acc, a, b, t0, h0, V, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = t0 + lane_row(ty, i);
    if (r >= n_tok) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = h0 + lane_row(tx, j);
      if (c < H) store(dx + (int64_t)r * H + c, acc[i][j]);
    }
  }
}

// dK[h, v] (+)= sum_t x[t, h] d[t, v] over one chunk of tokens. Chunks
// before the last store the fp32 sum in `sum` (adding to it unless
// `first`); the last (`dk` not null) writes sum + its own part as K's
// dtype. One block per (vocab tile, h tile).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_dk_kernel(const T* x, const float* d, float* sum, T* dk, int first,
                 int n_tok, int H, int V) {
  __shared__ __align__(16) float As[kDepth * kPitch];
  __shared__ __align__(16) float Bs[kDepth * kPitch];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int v0 = blockIdx.x * kTile, h0 = blockIdx.y * kTile;
  const Operand<T> a{x, 1, H, H, n_tok};       // (h, token) = x^T
  const Operand<float> b{d, V, 1, n_tok, V};   // (token, vocab)
  float acc[8][8];
  tile_product<T, float, false, true>(acc, a, b, h0, v0, n_tok, As, Bs);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = h0 + lane_row(ty, i);
    if (r >= H) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = v0 + lane_row(tx, j);
      if (c >= V) continue;
      const int64_t at = (int64_t)r * V + c;
      const float total = first ? acc[i][j] : sum[at] + acc[i][j];
      if (dk != nullptr) {
        store(dk + at, total);
      } else {
        sum[at] = total;
      }
    }
  }
}

inline unsigned tiles(int n) { return (unsigned)((n + kTile - 1) / kTile); }

template <typename T>
int fwd(const void* x, const void* w, const int32_t* labels, float* lse,
        float* gold, int32_t* amax, int n_tok, int H, int V,
        cudaStream_t st) {
  ce_fwd_kernel<T><<<tiles(n_tok), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), labels, lse, gold,
      amax, n_tok, H, V);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dx(const void* x, const void* w, const int32_t* labels,
           const float* lse, const float* c_lse, const float* c_gold,
           float* d, void* dx, int n_tok, int H, int V, cudaStream_t st) {
  ce_d_kernel<T><<<dim3(tiles(V), tiles(n_tok)), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), labels, lse, c_lse,
      c_gold, d, n_tok, H, V);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ce_dx_kernel<T><<<dim3(tiles(H), tiles(n_tok)), kThreads, 0, st>>>(
      d, static_cast<const T*>(w), static_cast<T*>(dx), n_tok, H, V);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dk(const void* x, const float* d, float* sum, void* dk, int first,
           int n_tok, int H, int V, cudaStream_t st) {
  ce_dk_kernel<T><<<dim3(tiles(V), tiles(H)), kThreads, 0, st>>>(
      static_cast<const T*>(x), d, sum, static_cast<T*>(dk), first, n_tok, H,
      V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (x, K, dx and dK share it). Each returns a
// cudaError_t: 0 when every launch was accepted. The Python wrapper has
// already checked shapes, dtypes, contiguity and devices.

// lse, gold [T] fp32 and amax [T] int32 for x [T, H], K [H, V].
int fstpu_ce_fwd(const void* x, const void* w, const void* labels, void* lse,
                 void* gold, void* amax, int n_tok, int H, int V, int dtype,
                 void* stream) {
  if (n_tok == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  float* l = static_cast<float*>(lse);
  float* g = static_cast<float*>(gold);
  int32_t* a = static_cast<int32_t*>(amax);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, w, lab, l, g, a, n_tok, H, V, st);
  if (dtype == 0) return fwd<float>(x, w, lab, l, g, a, n_tok, H, V, st);
  return (int)cudaErrorInvalidValue;
}

// For one chunk of n_tok tokens (x, labels, lse, c_lse, c_gold and dx
// point at its first token): d [n_tok, V] fp32 (the workspace), then
// dx [n_tok, H].
int fstpu_ce_bwd_dx(const void* x, const void* w, const void* labels,
                    const void* lse, const void* c_lse, const void* c_gold,
                    void* d, void* dx, int n_tok, int H, int V, int dtype,
                    void* stream) {
  if (n_tok == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* cl = static_cast<const float*>(c_lse);
  const float* cg = static_cast<const float*>(c_gold);
  float* dd = static_cast<float*>(d);
  if (dtype == 1)
    return bwd_dx<__nv_bfloat16>(x, w, lab, l, cl, cg, dd, dx, n_tok, H, V,
                                 st);
  if (dtype == 0)
    return bwd_dx<float>(x, w, lab, l, cl, cg, dd, dx, n_tok, H, V, st);
  return (int)cudaErrorInvalidValue;
}

// The chunk's x^T d added to the fp32 sum [H, V] (`first`: the sum
// starts here); with dk not null, the total is written to dk [H, V]
// instead, in K's dtype.
int fstpu_ce_bwd_dk(const void* x, const void* d, void* sum, void* dk,
                    int first, int n_tok, int H, int V, int dtype,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dd = static_cast<const float*>(d);
  float* s = static_cast<float*>(sum);
  if (dtype == 1)
    return bwd_dk<__nv_bfloat16>(x, dd, s, dk, first, n_tok, H, V, st);
  if (dtype == 0) return bwd_dk<float>(x, dd, s, dk, first, n_tok, H, V, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
