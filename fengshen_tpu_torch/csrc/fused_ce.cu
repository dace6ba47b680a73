// Fused LM-head cross-entropy for Hopper (sm_90a): kernel K2 of the port.
//
// Replaces the Pallas TPU kernels of fengshen_tpu/ops/pallas/fused_ce.py:
//   - fstpu_ce_fwd     <- _ce_fwd_kernel (:79), called at :228 in
//                         _token_stats_impl
//   - fstpu_ce_bwd_dx  <- _ce_bwd_dx_kernel (:130), called at :282
//   - fstpu_ce_bwd_dk  <- _ce_bwd_dk_kernel (:161), called at :307
// and computes the same functions of x [T, H], the head K [H, V] (both
// bf16 or both fp32) and labels [T] int32, with fp32 scores s = x K from
// fp32 sums of exact products (the scores are never rounded to the
// inputs' dtype):
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
// which the bf16 tensor cores, not memory, are the limit.
//
// Design for bf16 inputs (the tensor cores; PERF.md has its times
// against the bound, the plain version and torch's materialised-logits
// CE):
// - one product core, gemm_walk, for all three kernels: a 256-thread
//   block (8 warps as 2 x 4, each a 64 x 64 piece: 32 independent
//   m16n8 accumulators per thread) computes 128 x 256 output tiles with
//   bf16 mma.sync.m16n8k16 into fp32 accumulators in registers, 64 deep
//   per step (a wide tile, so that each byte brought from L2 feeds 85
//   flops). Operands reach shared memory through a ring of 3 cp.async
//   stages (16-byte copies; the loads of step k+2 run under the products
//   of step k), in XOR-swizzled tiles that ldmatrix reads without bank
//   conflicts; ldmatrix.trans serves the transposed operands, so one core
//   computes x K, d K^T and x^T d with no transposed copy in device
//   memory (mma_tiles.cuh). 144 KB of dynamic shared memory per block,
//   one block per SM. Rows whose byte offset is not a multiple of 16 are
//   staged element by element; ragged tiles read zeros and write nothing;
// - forward: one block per 128-token tile walks every vocab tile as one
//   continuous stream of (vocab tile, depth step) stages, so the ring
//   never drains between tiles. Each thread keeps the online max,
//   sum-exp, gold logit and first-index argmax of its 8 rows (the rows of
//   its C fragments) over its columns, in registers; at the end the 4
//   lanes that share a row combine by warp shuffles, then the 4 warps
//   that share it through shared memory;
// - backward: the Pallas dK kernel keeps an [H, block_v] fp32
//   accumulator (4 MiB at H = 4096) in VMEM, which no SM's 228 KB of
//   shared memory holds, and tiling H instead would recompute each score
//   tile H / 128 times. Here the caller walks the tokens in chunks: for
//   each chunk fstpu_ce_bwd_dx recomputes d's softmax part c_lse *
//   exp(s - lse) once (in fp32, from fp32 scores) and stores it rounded
//   to bf16 in a workspace [chunk, V] (62.5 MiB at 1024 tokens), the
//   operand the tensor cores take, as FlashAttention rounds dS; then
//   dx = d_soft K^T + c_gold K[:, label]. fstpu_ce_bwd_dk adds the
//   chunk's x^T d_soft + c_gold x (scattered to the label's column) into
//   an fp32 [H, V] sum, by bulk reduce-adds that the memory system
//   performs, and the last chunk writes dK in K's dtype. d's one-hot
//   part dominates dx and dK and several tokens share a label, so
//   rounding it to bf16 cost up to 2^-8 of each term in sums that cancel
//   (dK read 2.2x its element limit); it is applied in fp32 in the two
//   epilogues instead;
// - the d and dK kernels order their blocks so the tiles that share a
//   tile of the head (d) or of d (dK) run side by side: each is read
//   from device memory once per chunk;
// - every offset is 64-bit (T V passes 2^31 elements here).
// fp32 inputs keep the first design, unchanged: the same walk with fp32
// FMAs on the CUDA cores, 128 x 128 tiles 16 deep through shared memory
// (an 8 x 8 block per thread) and an fp32 d workspace, so the fp32
// checks keep their arithmetic.
// Later work: wgmma with TMA and warp specialisation (the products run
// at ~320 TFLOP/s here), and no d workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;            // rows and columns of a block tile
constexpr int kDepth = 16;            // reduction depth staged per step
constexpr int kPitch = kTile + 4;     // shared pitch (keeps float4 rows)
constexpr float kMasked = -1e30f;     // the TPU kernels' _NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core product core and its three kernels
// ---------------------------------------------------------------------------

namespace tc {

using mma::bf16;

constexpr int kBM = 128, kBN = 256;   // output tile (rows, columns)
constexpr int kBK = 64;               // reduction depth per stage
constexpr int kStages = 3;            // cp.async ring
constexpr int kWN = 4;                // warps along the columns
constexpr int kThreadsTC = 256;       // 8 warps as 2 (rows) x 4 (columns)
constexpr int kMI = 4, kNJ = 8;       // a warp's m16 and n8 tiles: 64 x 64
constexpr int kStageElems = kBM * kBK + kBN * kBK;
constexpr int kSmemBytes = kStages * kStageElems * (int)sizeof(bf16);

typedef float Acc[kMI][kNJ][4];

// A row-major bf16 matrix in device memory: element (r, c) at
// ptr[r * ld + c], rows < nr and columns < nc; `vec` when whole 16-byte
// chunks may be copied (ptr 16-byte aligned, ld a multiple of 8).
struct Mat {
  const bf16* ptr;
  int64_t ld;
  int nr, nc;
  bool vec;
};

__device__ __forceinline__ Mat mat(const bf16* p, int64_t ld, int nr,
                                   int nc) {
  return Mat{p, ld, nr, nc,
             ((reinterpret_cast<uintptr_t>(p) & 15) == 0) && (ld % 8 == 0)};
}

// One stage: the A tile (output rows m0.., depth k0..) and the B tile
// (depth k0.., output columns n0..). A_T: A lies in memory as [K][M]
// (else [M][K]); B_T: B lies as [K][N] (else [N][K]). Each tile keeps
// the memory's contiguous index as its row.
template <bool A_T, bool B_T>
__device__ __forceinline__ void load_stage(bf16* s, const Mat& a,
                                           const Mat& b, int m0, int n0,
                                           int k0) {
  bf16* sa = s;
  bf16* sb = s + kBM * kBK;
  if (!A_T)
    mma::load_tile<kBM, kBK, kThreadsTC>(sa, a.ptr + m0 * a.ld + k0, a.ld,
                                         a.nr - m0, a.nc - k0, a.vec);
  else
    mma::load_tile<kBK, kBM, kThreadsTC>(sa, a.ptr + k0 * a.ld + m0, a.ld,
                                         a.nr - k0, a.nc - m0, a.vec);
  if (!B_T)
    mma::load_tile<kBN, kBK, kThreadsTC>(sb, b.ptr + n0 * b.ld + k0, b.ld,
                                         b.nr - n0, b.nc - k0, b.vec);
  else
    mma::load_tile<kBK, kBN, kThreadsTC>(sb, b.ptr + k0 * b.ld + n0, b.ld,
                                         b.nr - k0, b.nc - n0, b.vec);
}

// acc += the stage's A x B for the warp's 64 x 64 piece: 4 x 8 m16n8
// tiles, 4 k16 steps.
template <bool A_T, bool B_T>
__device__ __forceinline__ void mma_stage(Acc& acc, const bf16* s, int wm,
                                          int wn, int lane) {
  const bf16* sa = s;
  const bf16* sb = s + kBM * kBK;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t af[kMI][4], bfr[kNJ / 2][4];
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      if (!A_T)
        mma::load_a(af[i], sa, kBK, wm * 64 + i * 16, kk, lane);
      else
        mma::load_a_t(af[i], sa, kBM, wm * 64 + i * 16, kk, lane);
    }
#pragma unroll
    for (int p = 0; p < kNJ / 2; ++p) {
      if (!B_T)
        mma::load_b(bfr[p], sb, kBK, wn * 64 + p * 16, kk, lane);
      else
        mma::load_b_t(bfr[p], sb, kBN, wn * 64 + p * 16, kk, lane);
    }
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
        mma::mma16816(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                      bfr[j >> 1][(j & 1) * 2 + 1]);
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
}

// The product core: for output column tiles nt = n_first ..
// n_first + n_tiles - 1 (columns nt * kBN ..), acc = A[m0.., :K] x
// B[:K, nt * kBN ..], then epi(nt, acc). The (tile, depth step) stages
// form one stream through the ring, so it never drains between tiles.
// pro() runs once the first stages are in flight (cp.async copies it
// issues join the next group). The last tile's epi runs once every stage
// has been consumed, so it may use the ring's shared memory (after a
// __syncthreads of its own when threads exchange data there). Thread
// (warp w, lane l) holds acc[i][j][c] = output (row, column)
// (m0 + frag_row(i, c / 2), nt * kBN + frag_col(j) + c % 2).
template <bool A_T, bool B_T, typename Pro, typename Epi>
__device__ __forceinline__ void gemm_walk(const Mat& a, const Mat& b, int m0,
                                          int n_first, int n_tiles, int K,
                                          bf16* smem, Pro&& pro, Epi&& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWN, wn = warp % kWN;
  const int nk = (K + kBK - 1) / kBK;
  const int total = n_tiles * nk;
  Acc acc;
  zero(acc);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < total)
      load_stage<A_T, B_T>(smem + st * kStageElems, a, b, m0,
                           (n_first + st / nk) * kBN, (st % nk) * kBK);
    mma::cp_async_commit();
  }
  pro();
  for (int step = 0; step < total; ++step) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = step + kStages - 1;
    if (nxt < total)
      load_stage<A_T, B_T>(smem + (nxt % kStages) * kStageElems, a, b, m0,
                           (n_first + nxt / nk) * kBN, (nxt % nk) * kBK);
    mma::cp_async_commit();
    mma_stage<A_T, B_T>(acc, smem + (step % kStages) * kStageElems, wm, wn,
                        lane);
    if (step % nk == nk - 1 && step + 1 < total) {
      epi(n_first + step / nk, acc);
      zero(acc);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();
  if (total > 0) epi(n_first + n_tiles - 1, acc);
}

// The thread's output row of acc[i][.][hf * 2 + .] and column of
// acc[.][j][. + e], relative to the tile.
__device__ __forceinline__ int frag_row(int i, int hf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp / kWN) * 64 + i * 16 + (lane >> 2) + hf * 8;
}
__device__ __forceinline__ int frag_col(int j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp % kWN) * 64 + j * 8 + (lane & 3) * 2;
}

__device__ __forceinline__ void no_prologue() {}


// forward: one block per 128-token tile, walking every vocab tile
__global__ void __launch_bounds__(kThreadsTC, 1)
    ce_fwd_tc(const bf16* x, const bf16* w, const int32_t* labels,
              float* lse, float* gold, int32_t* amax, int n_tok, int H,
              int V) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int t0 = blockIdx.x * kBM;
  // rows r = 0..7 of the thread: frag_row(r / 2, r % 2)
  int lab[8], arg[8];
  float m[8], l[8], g[8], best[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = t0 + frag_row(r >> 1, r & 1);
    lab[r] = row < n_tok ? labels[row] : -1;
    m[r] = kMasked;
    l[r] = 0.f;
    g[r] = 0.f;
    best[r] = -__int_as_float(0x7f800000);   // -inf
    arg[r] = 0x7fffffff;
  }
  gemm_walk<false, true>(
      mat(x, H, n_tok, H), mat(w, V, H, V), t0, 0, (V + kBN - 1) / kBN, H,
      smem, no_prologue, [&](int nt, Acc& acc) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = r >> 1, hf = r & 1;
          float mx = kMasked;
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = nt * kBN + frag_col(j) + e;   // increasing
              if (c < V) {
                const float sc = acc[i][j][hf * 2 + e];
                mx = fmaxf(mx, sc);
                if (c == lab[r]) g[r] += sc;
                if (sc > best[r]) {                      // first max
                  best[r] = sc;
                  arg[r] = c;
                }
              }
            }
          const float m_new = fmaxf(m[r], mx);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (nt * kBN + frag_col(j) + e < V)
                sum += __expf(acc[i][j][hf * 2 + e] - m_new);
          l[r] = l[r] * __expf(m[r] - m_new) + sum;
          m[r] = m_new;
        }
      });

  // the 4 lanes of a quad share rows: combine by shuffles
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float ol = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float og = __shfl_xor_sync(0xffffffffu, g[r], o);
      const float ob = __shfl_xor_sync(0xffffffffu, best[r], o);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[r], o);
      const float mm = fmaxf(m[r], om);
      l[r] = l[r] * expf(m[r] - mm) + ol * expf(om - mm);
      m[r] = mm;
      g[r] += og;
      if (ob > best[r] || (ob == best[r] && oa < arg[r])) {
        best[r] = ob;
        arg[r] = oa;
      }
    }
  }
  // the kWN column warps share rows: combine through shared memory (free
  // once gemm_walk has returned)
  float* sm_m = reinterpret_cast<float*>(smem_raw);
  float* sm_l = sm_m + kWN * kBM;
  float* sm_g = sm_l + kWN * kBM;
  float* sm_b = sm_g + kWN * kBM;
  int* sm_a = reinterpret_cast<int*>(sm_b + kWN * kBM);
  const int wn = (threadIdx.x >> 5) % kWN;
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int at = wn * kBM + frag_row(r >> 1, r & 1);
      sm_m[at] = m[r];
      sm_l[at] = l[r];
      sm_g[at] = g[r];
      sm_b[at] = best[r];
      sm_a[at] = arg[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < kBM) {
    const int row = threadIdx.x;
    float M = sm_m[row], L = sm_l[row], G = sm_g[row], B = sm_b[row];
    int A = sm_a[row];
#pragma unroll
    for (int q = 1; q < kWN; ++q) {
      const int at = q * kBM + row;
      const float om = sm_m[at], ol = sm_l[at];
      const float mm = fmaxf(M, om);
      L = L * expf(M - mm) + ol * expf(om - mm);
      M = mm;
      G += sm_g[at];
      if (sm_b[at] > B || (sm_b[at] == B && sm_a[at] < A)) {
        B = sm_b[at];
        A = sm_a[at];
      }
    }
    if (t0 + row < n_tok) {
      lse[t0 + row] = M + logf(fmaxf(L, 1e-30f));
      gold[t0 + row] = G;
      amax[t0 + row] = A;
    }
  }
}

// The softmax part of d, d_soft[t, v] = c_lse[t] exp(s[t, v] - lse[t]),
// computed in fp32 and stored as bf16, for one chunk of n_tok tokens;
// one block per (token tile, vocab tile), the token tiles of a vocab
// tile side by side, so each tile of the head is read from device memory
// once per chunk. d's one-hot part,
// c_gold[t] (v == label[t]), is never rounded: the dx and dK kernels add
// it exactly in fp32.
__global__ void __launch_bounds__(kThreadsTC, 1)
    ce_d_tc(const bf16* x, const bf16* w, const float* lse,
            const float* c_lse, bf16* d, int n_tok, int H, int V) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t0 = blockIdx.x * kBM;
  gemm_walk<false, true>(
      mat(x, H, n_tok, H), mat(w, V, H, V), t0, blockIdx.y, 1, H,
      reinterpret_cast<bf16*>(smem_raw), no_prologue, [&](int nt, Acc& acc) {
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = t0 + frag_row(i, hf);
            if (row >= n_tok) continue;
            const float L = lse[row], cl = c_lse[row];
            bf16* drow = d + (int64_t)row * V;
#pragma unroll
            for (int j = 0; j < kNJ; ++j) {
              const int c = nt * kBN + frag_col(j);
              if (c >= V) continue;
              mma::store_pair(drow + c, cl * __expf(acc[i][j][hf * 2] - L),
                              cl * __expf(acc[i][j][hf * 2 + 1] - L),
                              (V & 1) == 0, c + 1 < V);
            }
          }
      });
}

// dx[t, h] = sum_v d_soft[t, v] K[h, v] + c_gold[t] K[h, label[t]], in
// bf16; one block per (h tile, token tile).
__global__ void __launch_bounds__(kThreadsTC, 1)
    ce_dx_tc(const bf16* d, const bf16* w, const int32_t* labels,
             const float* c_gold, bf16* dx, int n_tok, int H, int V) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t0 = blockIdx.y * kBM;
  gemm_walk<false, false>(
      mat(d, V, n_tok, V), mat(w, V, H, V), t0, blockIdx.x, 1, V,
      reinterpret_cast<bf16*>(smem_raw), no_prologue, [&](int nt, Acc& acc) {
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = t0 + frag_row(i, hf);
            if (row >= n_tok) continue;
            const int lab = labels[row];
            const bool hit = lab >= 0 && lab < V;
            const float cg = c_gold[row];
#pragma unroll
            for (int j = 0; j < kNJ; ++j) {
              const int c = nt * kBN + frag_col(j);
              if (c >= H) continue;
              float v0 = acc[i][j][hf * 2], v1 = acc[i][j][hf * 2 + 1];
              if (hit) {
                v0 += cg * __bfloat162float(w[(int64_t)c * V + lab]);
                if (c + 1 < H)
                  v1 += cg * __bfloat162float(w[(int64_t)(c + 1) * V + lab]);
              }
              mma::store_pair(dx + (int64_t)row * H + c, v0, v1,
                              (H & 1) == 0, c + 1 < H);
            }
          }
      });
}

// dK[h, v] (+)= sum_t x[t, h] (d_soft[t, v] + c_gold[t] (v == label[t]))
// over one chunk of tokens, into the fp32 sum (starting it when
// `first`); the last chunk (`dk` not null) writes sum + its own part as
// bf16. One block per (h tile, vocab tile), the h tiles of a vocab tile
// side by side, so each column tile of d is read from device memory once
// (the chunk's x stays in L2). While the first stages load, the block
// lists the chunk's tokens labelled inside its 256 columns, in token
// order, with their c_gold, and stages their 128 values of x beside the
// ring. After the product each warp works alone: it stages its 64 x 64
// piece in the ring's (now free) shared memory as fp32, adds c_gold x to
// the listed columns it holds, and sends each row of the piece to the
// fp32 sum as one bulk copy (the first chunk) or one bulk fp32
// reduce-add (cp.reduce.async.bulk), which the memory system performs
// while the SM moves on. The last chunk, and a piece whose rows are not
// whole 16-byte multiples inside V, read the sum and write dK
// themselves. More than kMaxHits listed tokens (not met with uniform
// labels: 8 expected per tile at 1024 tokens and V = 32000) take a
// slower path that reads the labels again.
constexpr int kMaxHits = 128;
constexpr int kPiecePitch = 64 + 4;  // a warp's staged 64 x 64 piece
constexpr int kHitBytes =
    kMaxHits * (kBM * (int)sizeof(bf16) + 2 * (int)sizeof(int) +
                (int)sizeof(float));
constexpr int kDkSmemBytes = kSmemBytes + kHitBytes + 16 * (int)sizeof(int);
static_assert(kThreadsTC / 32 * 64 * kPiecePitch * (int)sizeof(float) <=
                  kSmemBytes, "pieces fit in the ring");

__global__ void __launch_bounds__(kThreadsTC, 1)
    ce_dk_tc(const bf16* x, const bf16* d, const int32_t* labels,
             const float* c_gold, float* sum, bf16* dk, int first,
             int n_tok, int H, int V) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* hitX = reinterpret_cast<bf16*>(smem_raw + kSmemBytes);  // [hit][kBM]
  int* hitTok = reinterpret_cast<int*>(hitX + kMaxHits * kBM);
  int* hitCol = hitTok + kMaxHits;
  float* hitCg = reinterpret_cast<float*>(hitCol + kMaxHits);
  int* warpCnt = reinterpret_cast<int*>(hitCg + kMaxHits);   // [8] + total
  const int h0 = blockIdx.x * kBM, v0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int v_end = min(v0 + kBN, V);
  const bool x_vec = (H % 8) == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // list the labelled tokens (in token order) and stage their x
  auto list_hits = [&]() {
    int count = 0;
    for (int base = 0; base < n_tok; base += 4 * kThreadsTC) {
      int lab[4];
      float cg[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {   // every load in flight at once
        const int t = base + k * kThreadsTC + threadIdx.x;
        lab[k] = t < n_tok ? labels[t] : -1;
        cg[k] = t < n_tok ? c_gold[t] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = lab[k] >= v0 && lab[k] < v_end;
        const unsigned m = __ballot_sync(0xffffffffu, in);
        if (lane == 0) warpCnt[warp] = __popc(m);
        __syncthreads();
        int before = 0, all = 0;
#pragma unroll
        for (int w = 0; w < kThreadsTC / 32; ++w) {
          before += w < warp ? warpCnt[w] : 0;
          all += warpCnt[w];
        }
        const int pos = count + before + __popc(m & ((1u << lane) - 1u));
        if (in && pos < kMaxHits) {
          hitTok[pos] = base + k * kThreadsTC + threadIdx.x;
          hitCol[pos] = lab[k] - v0;
          hitCg[pos] = cg[k];
        }
        count += all;
        __syncthreads();
      }
    }
    if (threadIdx.x == 0) warpCnt[kThreadsTC / 32] = count;
    const int listed = min(count, kMaxHits);
    for (int e = threadIdx.x; e < listed * (kBM / 8); e += kThreadsTC) {
      const int i = e / (kBM / 8), r = (e % (kBM / 8)) * 8;
      const bf16* src = x + (int64_t)hitTok[i] * H + h0 + r;
      bf16* dst = hitX + i * kBM + r;
      if (x_vec && h0 + r + 8 <= H) {
        mma::cp_async16(dst, src, 16);
      } else {
        for (int q = 0; q < 8; ++q)
          dst[q] = h0 + r + q < H ? src[q] : __float2bfloat16(0.f);
      }
    }
  };
  float* piece =
      reinterpret_cast<float*>(smem_raw) + warp * 64 * kPiecePitch;
  const int pr0 = h0 + (warp / kWN) * 64;       // the piece's first row
  const int pc0 = v0 + (warp % kWN) * 64;       // and first column
  gemm_walk<true, true>(
      mat(x, H, n_tok, H), mat(d, V, n_tok, V), h0, blockIdx.y, 1, n_tok,
      reinterpret_cast<bf16*>(smem_raw), list_hits, [&](int, Acc& acc) {
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int j = 0; j < kNJ; ++j)
              *reinterpret_cast<float2*>(
                  piece + (frag_row(i, hf) - (warp / kWN) * 64) *
                              kPiecePitch +
                  frag_col(j) - (warp % kWN) * 64) =
                  make_float2(acc[i][j][hf * 2], acc[i][j][hf * 2 + 1]);
      });
  __syncwarp();
  // the one-hot part of the piece's columns, in token order
  const int count = warpCnt[kThreadsTC / 32];
  const int xr0 = (warp / kWN) * 64;
  for (int i = 0; i < min(count, kMaxHits); ++i) {
    const int col = hitCol[i] - (warp % kWN) * 64;
    if (col < 0 || col >= 64) continue;
    for (int r = lane; r < 64 && pr0 + r < H; r += 32)
      piece[r * kPiecePitch + col] +=
          hitCg[i] * __bfloat162float(hitX[i * kBM + xr0 + r]);
    __syncwarp();
  }
  if (count > kMaxHits) {   // the tokens past the list, in token order
    int seen = 0;
    for (int base = 0; base < n_tok; base += 32) {
      const int t = base + lane;
      const int lab = t < n_tok ? labels[t] : -1;
      unsigned hit =
          __ballot_sync(0xffffffffu, lab >= v0 && lab < v_end);
      while (hit) {
        const int src = __ffs(hit) - 1;
        hit &= hit - 1;
        if (seen++ < kMaxHits) continue;
        const int col = __shfl_sync(0xffffffffu, lab, src) - pc0;
        if (col < 0 || col >= 64) continue;
        const float cg = c_gold[base + src];
        const bf16* xr = x + (int64_t)(base + src) * H + pr0;
        for (int r = lane; r < 64 && pr0 + r < H; r += 32)
          piece[r * kPiecePitch + col] += cg * __bfloat162float(xr[r]);
        __syncwarp();
      }
    }
  }
  if (dk == nullptr && (V & 3) == 0 && pc0 + 64 <= V) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    for (int r = lane; r < 64 && pr0 + r < H; r += 32) {
      float* g = sum + (int64_t)(pr0 + r) * V + pc0;
      const uint32_t src = mma::smem_addr(piece + r * kPiecePitch);
      if (first)
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
            ::"l"(g), "r"(src), "n"(64 * 4) : "memory");
      else
        asm volatile(
            "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
            "[%0], [%1], %2;\n" ::"l"(g), "r"(src), "n"(64 * 4)
            : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // shared memory must outlive the copies' reads of it; the sum's
    // writes complete before the next kernel on the stream
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    return;
  }
  __syncwarp();
#pragma unroll 8   // eight rows of the sum in flight per lane
  for (int e = lane; e < 64 * 16; e += 32) {
    const int r = e / 16, c = (e % 16) * 4;
    const int row = pr0 + r, col = pc0 + c;
    if (row >= H || col >= V) continue;
    const float* src = piece + r * kPiecePitch + c;
    const int64_t at = (int64_t)row * V + col;
    if ((V & 3) == 0 && col + 4 <= V) {
      float4 v = *reinterpret_cast<const float4*>(src);
      if (!first) {
        const float4 old = *reinterpret_cast<const float4*>(sum + at);
        v.x += old.x;
        v.y += old.y;
        v.z += old.z;
        v.w += old.w;
      }
      if (dk != nullptr) {
        mma::store_bf16x2(dk + at, v.x, v.y);
        mma::store_bf16x2(dk + at + 2, v.z, v.w);
      } else {
        *reinterpret_cast<float4*>(sum + at) = v;
      }
    } else {
      for (int q = 0; q < 4 && col + q < V; ++q) {
        const float v = src[q] + (first ? 0.f : sum[at + q]);
        if (dk != nullptr)
          dk[at + q] = __float2bfloat16(v);
        else
          sum[at + q] = v;
      }
    }
  }
}

inline unsigned tiles(int n, int t) { return (unsigned)((n + t - 1) / t); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

int fwd(const void* x, const void* w, const int32_t* labels, float* lse,
        float* gold, int32_t* amax, int n_tok, int H, int V,
        cudaStream_t st) {
  cudaError_t e = allow_smem(ce_fwd_tc);
  if (e != cudaSuccess) return (int)e;
  ce_fwd_tc<<<tiles(n_tok, kBM), kThreadsTC, kSmemBytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), labels, lse,
      gold, amax, n_tok, H, V);
  return (int)cudaGetLastError();
}

int bwd_dx(const void* x, const void* w, const int32_t* labels,
           const float* lse, const float* c_lse, const float* c_gold,
           void* d, void* dx, int n_tok, int H, int V, cudaStream_t st) {
  cudaError_t e = allow_smem(ce_d_tc);
  if (e == cudaSuccess) e = allow_smem(ce_dx_tc);
  if (e != cudaSuccess) return (int)e;
  ce_d_tc<<<dim3(tiles(n_tok, kBM), tiles(V, kBN)), kThreadsTC, kSmemBytes,
            st>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                  lse, c_lse, static_cast<bf16*>(d), n_tok, H, V);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ce_dx_tc<<<dim3(tiles(H, kBN), tiles(n_tok, kBM)), kThreadsTC, kSmemBytes,
             st>>>(static_cast<const bf16*>(d),
                   static_cast<const bf16*>(w), labels, c_gold,
                   static_cast<bf16*>(dx), n_tok, H, V);
  return (int)cudaGetLastError();
}

int bwd_dk(const void* x, const void* d, const int32_t* labels,
           const float* c_gold, float* sum, void* dk, int first, int n_tok,
           int H, int V, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      ce_dk_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkSmemBytes);
  if (e != cudaSuccess) return (int)e;
  ce_dk_tc<<<dim3(tiles(H, kBM), tiles(V, kBN)), kThreadsTC, kDkSmemBytes,
             st>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(d),
                   labels, c_gold, sum, static_cast<bf16*>(dk), first,
                   n_tok, H, V);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
  if (dtype == 1) return tc::fwd(x, w, lab, l, g, a, n_tok, H, V, st);
  if (dtype == 0) return fwd<float>(x, w, lab, l, g, a, n_tok, H, V, st);
  return (int)cudaErrorInvalidValue;
}

// For one chunk of n_tok tokens (x, labels, lse, c_lse, c_gold and dx
// point at its first token): d [n_tok, V] in x's dtype (the workspace;
// bf16 holds only d's softmax part, see ce_d_tc), then dx [n_tok, H].
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
  if (dtype == 1)
    return tc::bwd_dx(x, w, lab, l, cl, cg, d, dx, n_tok, H, V, st);
  if (dtype == 0)
    return bwd_dx<float>(x, w, lab, l, cl, cg, static_cast<float*>(d), dx,
                         n_tok, H, V, st);
  return (int)cudaErrorInvalidValue;
}

// The chunk's x^T d added to the fp32 sum [H, V] (`first`: the sum
// starts here); with dk not null, the total is written to dk [H, V]
// instead, in K's dtype. labels and c_gold [n_tok] are the chunk's: the
// bf16 kernels add d's one-hot part from them (their d holds only the
// softmax part); the fp32 kernel's d holds all of d.
int fstpu_ce_bwd_dk(const void* x, const void* d, const void* labels,
                    const void* c_gold, void* sum, void* dk, int first,
                    int n_tok, int H, int V, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(sum);
  if (dtype == 1)
    return tc::bwd_dk(x, d, static_cast<const int32_t*>(labels),
                      static_cast<const float*>(c_gold), s, dk, first, n_tok,
                      H, V, st);
  if (dtype == 0)
    return bwd_dk<float>(x, static_cast<const float*>(d), s, dk, first,
                         n_tok, H, V, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
