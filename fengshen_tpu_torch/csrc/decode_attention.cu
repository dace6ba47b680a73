// Paged decode attention for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces the Pallas TPU kernel `pallas_decode_attention` /
// `_decode_kernel` (fengshen_tpu/ops/pallas/decode_attention.py:204 and
// :153) and computes the same function: attention of a short query
// window (S <= 8: a decode tick or a speculative verify window) over
// each lane's KV, read from either a contiguous slot pool
// [B, L, KVH, D] or a paged pool [num_blocks, block_size, KVH, D]
// through block_table [B, max_blocks] (no gather copy). Scores and the
// online softmax are fp32 with scale 1/sqrt(D); masked scores are -1e30,
// so a row with no valid position gives the uniform average of the
// lane's values (what the plain version's -1e9 bias gives), never NaN.
// GQA maps query head h to KV head h / (H / KVH).
//
// The int8 branch (the TPU kernel's `quantized` path, :176-181): the
// pool holds int8 K/V with one fp32 absmax scale per (token, KV head)
// ([B, L, KVH] or [num_blocks, block_size, KVH]). The raw int8 rows and
// their scales are staged in shared memory, and each element is
// dequantized as it is read from there: int8 -> fp32 x scale -> rounded
// to the compute dtype (fp32 or bf16) -> fp32, which is dequantize_kv's
// rounding. The pool stays int8 in device memory: no dequantized copy is
// made, and a staged int8 token takes half the shared memory of a bf16
// one.
//
// What bounds it on an H100: bytes. Each tick reads every valid K/V
// token of every lane once (2 * tokens * KVH * D * sizeof(T), or for an
// int8 pool 2 * tokens * KVH * (D + 4): values and scales) and does ~4
// flops per element read (2 per byte in bf16, 4 in int8), far below the
// ~295 flops/byte at which the tensor cores would become the limit. So
// the design is about keeping enough bytes in flight on every SM:
//
// - split-K over the lane (flash-decoding): the grid is (lane x KV head,
//   split), each split a run of 64-token tiles of the lane. The host
//   plans the split count from the lane length and the number of (lane,
//   KV head) pairs (ops/kernels/decode_attention.py `split_plan`), so
//   that long lanes do not set the pace alone. Each split keeps an
//   online softmax and writes a partial (m, l, acc[R, D]) in fp32 to a
//   workspace; the last split block of each pair to finish, found
//   through a per-pair counter (__threadfence before the atomicAdd),
//   combines the partials in split order,
//     out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i,
//   so a call's output is bitwise reproducible, and resets the counter
//   to 0 for the next call. One launch per call, no host sync: K3 stays
//   one kernel per layer of a tick and capturable in a CUDA graph;
// - a two-stage cp.async ring of K and V tiles, each tile's valid bytes
//   staged beside them, so the next tile streams in while the block
//   computes; a deeper ring costs blocks per SM (two stages of bf16 let
//   three blocks share an SM), and per-block latency (barriers, the
//   prologue, the combine) needs them more: three and four stages ran
//   slower for every pool dtype. The split's block-table entries are
//   read once when the block starts, so no tile's copies wait on a
//   table lookup;
// - every warp busy at R = 1 (the MHA decode tick): groups of 8 (or 4)
//   lanes split a score's D-long dot product, each warp takes 16 tokens
//   of the tile, and shuffles sum the partial dots; the P V update gives
//   each thread one column of D (and for D = 64 every other row), with
//   the accumulator in registers;
// - a tile whose positions are all masked for every row is skipped
//   without reading K/V (the TPU kernel reads every block), unless some
//   row of the lane has no valid position at all: that row's uniform
//   average needs every value of the lane (but no key: such a tile's V
//   is copied and its K is not). Each split block reads the
//   whole lane's valid bytes (S x L bytes, from L2) to decide, so every
//   split decides alike. A split that skips all its tiles writes
//   m = -1e30, l = 0, acc = 0 (never -inf, which would give NaN in the
//   combine).
//
// Any paged block size that is a multiple of 8, S <= 8 and at most 64
// query rows per KV head (R = H / KVH * S). A thread's accumulator rows
// are a template bucket (1 or 8) in registers, so nothing is indexed at
// run time in registers; beyond 8 rows per thread (GQA with long verify
// windows) the accumulator lives in shared memory between tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;             // tokens per tile
constexpr int kTokPerWarp = kTile / kWarps;   // 16
static_assert(kTokPerWarp == 16, "a warp's lanes 0-15 and 16-31 pair up");
constexpr int kMaxS = 8;              // longest query window
constexpr int kMaxRows = 64;          // query rows per KV head
constexpr int kMaxSplitTiles = 64;    // tiles one split walks at most
constexpr int kStages = 2;            // ring depth, see the header
// block-table entries one split spans: its tokens over the smallest
// block size (8), plus the partial blocks at either end
constexpr int kMaxEntries = kMaxSplitTiles * kTile / 8 + 8;
constexpr float kMasked = -1e30f;     // the TPU kernel's _NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;   // int8 pools: [rows, KVH] fp32, else null
  const float* v_scale;
  const uint8_t* valid;   // [B, S, lane_len] bool
  const int32_t* table;   // [B, max_blocks], or null for a slot pool
  void* out;              // [B, S, H, D]
  float* ws;              // splits > 1: partials, see the epilogue
  int* counters;          // splits > 1: [B * KVH], 0 between calls
  int B, S, H, KVH;
  int lane_len;           // positions per lane (virtual for paged)
  int block_size;         // paged block size
  int max_blocks;
  int num_blocks;
  int splits;             // split blocks per (lane, KV head)
  int split_tiles;        // tiles per split (the last may have fewer)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element j (a compile-time index) of 16 bytes of pool elements, as
// fp32, by bit operations: no local copy whose address is taken.
__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}
template <typename PE>
__device__ __forceinline__ float element(const uint4& w, int j);
template <>
__device__ __forceinline__ float element<float>(const uint4& w, int j) {
  return __uint_as_float(word(w, j));
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16>(const uint4& w,
                                                         int j) {
  const uint32_t x = word(w, j >> 1);
  return __uint_as_float((j & 1) ? (x & 0xffff0000u) : (x << 16));
}
template <>
__device__ __forceinline__ float element<int8_t>(const uint4& w, int j) {
  return (float)((int)(word(w, j >> 2) << (24 - 8 * (j & 3))) >> 24);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// How the pool is stored: in the query's dtype, or int8 rounded through
// fp32 or bf16 after dequantization.
enum PoolMode { kSameAsQ = 0, kInt8Fp32 = 1, kInt8Bf16 = 2 };

// Compile-time facts of one (q dtype, head_dim, pool mode).
template <typename T, int D, int MODE>
struct Cfg {
  static constexpr bool kInt8 = MODE != kSameAsQ;
  static constexpr int kElt = kInt8 ? 1 : (int)sizeof(T);   // pool bytes
  static constexpr int kRowBytes = D * kElt;                 // one head row
  static constexpr int kChunks = kRowBytes / 16;             // 16-byte chunks
  static constexpr int kLpt = kChunks < 8 ? kChunks : 8;     // lanes/token
  static constexpr int kChunksPerLane = kChunks / kLpt;
  static constexpr int kEltPerChunk = 16 / kElt;
  static constexpr int kTokPerPass = 32 / kLpt;
  static constexpr int kPasses = kTokPerWarp / kTokPerPass;
  // one ring stage: K tile, V tile, valid bytes, and int8 scales
  static constexpr size_t kKOff = 0;
  static constexpr size_t kVOff = (size_t)kTile * kRowBytes;
  static constexpr size_t kValidOff = 2 * (size_t)kTile * kRowBytes;
  static constexpr size_t kScaleOff = kValidOff + kMaxS * kTile;
  static constexpr size_t kStageBytes =
      kScaleOff + (kInt8 ? 2 * kTile * sizeof(float) : 0);
  static_assert(kChunks % kLpt == 0 && kTokPerWarp % kTokPerPass == 0,
                "lane split");
  static_assert(kStageBytes % 16 == 0, "stage alignment");
};

// Shared-memory carve-up, used identically by host and device: the ring,
// then the query rows (fp32), the accumulator when it does not fit in
// registers (fp32 [R][D]), the tile's scores / probabilities, the running
// max, sum and correction per row, the split's tile list and per-tile
// flags, its block-table entries, and a few flags.
template <typename T, int D, int MODE>
struct Smem {
  using C = Cfg<T, D, MODE>;
  __host__ __device__ static size_t q_off() {
    return kStages * C::kStageBytes;
  }
  __host__ __device__ static size_t acc_off(int R) {
    return q_off() + align16((size_t)R * D * 4);
  }
  __host__ __device__ static size_t p_off(int R) {
    return acc_off(R) + align16((size_t)R * D * 4);
  }
  __host__ __device__ static size_t stat_off(int R) {
    return p_off(R) + align16((size_t)R * kTile * 4);
  }
  __host__ __device__ static size_t list_off(int R) {
    return stat_off(R) + align16((size_t)3 * R * 4);
  }
  __host__ __device__ static size_t ent_off(int R) {
    return list_off(R) + align16((size_t)2 * kMaxSplitTiles * 4);
  }
  __host__ __device__ static size_t flag_off(int R) {
    return ent_off(R) + align16((size_t)kMaxEntries * 4);
  }
  __host__ __device__ static size_t bytes(int R) { return flag_off(R) + 16; }
};

// Copy the tile of positions [t0, t0 + 64) of lane b, KV head kvh, into
// one ring stage at `base`: K and V rows (zero past the lane end; K only
// `with_k`, see the caller), the valid bytes of every query row, int8
// scales. Each warp copies its own
// 16 tokens; lane l looks up the row of token l % 16 (one table lookup
// per lane and tile: ent_s holds the split's block-table entries from
// block first_blk on) and shuffles hand it to the lanes that copy that
// token's chunks. Pool rows stay below 2^31.
template <typename T, int D, int MODE>
__device__ __forceinline__ void stage_tile(const Params& p,
                                           unsigned char* base, int t0,
                                           int b, int kvh,
                                           const uint8_t* valid,
                                           const int* ent_s, int first_blk,
                                           bool valid_vec4, bool with_k) {
  using C = Cfg<T, D, MODE>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = p.lane_len, bs = p.block_size;
  const int n = min(kTile, L - t0);
  const int t_mine = warp * kTokPerWarp + (lane & (kTokPerWarp - 1));
  int row_mine = 0;
  if (t_mine < n) {
    const int pos = t0 + t_mine;
    row_mine = p.table == nullptr
                   ? b * L + pos
                   : ent_s[pos / bs - first_blk] * bs + pos % bs;
  }
  const char* kp = static_cast<const char*>(p.k);
  const char* vp = static_cast<const char*>(p.v);
  constexpr int kCopies = kTokPerWarp * C::kChunks / 32;   // per lane
#pragma unroll
  for (int jj = 0; jj < kCopies; ++jj) {
    const int c = lane + 32 * jj;
    const int tw = c / C::kChunks, ch = c % C::kChunks;
    const int t = warp * kTokPerWarp + tw;
    const int row = __shfl_sync(0xffffffffu, row_mine, tw);
    unsigned char* kd = base + C::kKOff + t * C::kRowBytes + ch * 16;
    unsigned char* vd = base + C::kVOff + t * C::kRowBytes + ch * 16;
    const int64_t off =
        ((int64_t)row * p.KVH + kvh) * C::kRowBytes + ch * 16;
    if (with_k) mma::cp_async16(kd, t < n ? kp + off : kp, t < n ? 16 : 0);
    mma::cp_async16(vd, t < n ? vp + off : vp, t < n ? 16 : 0);
  }
  uint8_t* vs = base + C::kValidOff;
  for (int c = tid; c < p.S * (kTile / 4); c += kThreads) {
    const int s = c / (kTile / 4), w = (c % (kTile / 4)) * 4;
    const uint8_t* src = valid + (int64_t)s * L + t0 + w;
    if (valid_vec4) {
      mma::cp_async4(vs + s * kTile + w, w < n ? src : valid, w < n ? 4 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vs[s * kTile + w + e] = w + e < n ? src[e] : 0;
    }
  }
  if constexpr (C::kInt8) {
    // lanes 0-15 stage the K scale of their token, lanes 16-31 the V's
    float* sc = reinterpret_cast<float*>(base + C::kScaleOff) +
                (lane < kTokPerWarp ? 0 : kTile) + t_mine;
    const float* src = lane < kTokPerWarp ? p.k_scale : p.v_scale;
    if (t_mine < n)
      mma::cp_async4(sc, src + (int64_t)row_mine * p.KVH + kvh, 4);
    else
      mma::cp_async4(sc, src, 0);
  }
}

// Element offset of query row r (= g * S + s) of KV head kvh, column d,
// in the [B, S, H, D] output.
__device__ __forceinline__ int64_t out_offset(const Params& p, int b,
                                              int kvh, int r, int d,
                                              int D) {
  const int G = p.H / p.KVH, g = r / p.S, s = r % p.S;
  return (((int64_t)b * p.S + s) * p.H + kvh * G + g) * D + d;
}

// One kernel per (q dtype, head_dim, pool mode) and rows-per-thread
// bucket RPT: a thread owns column tid % D of the output and rows
// tid / D, + kThreads / D, ...; with at most RPT of them its accumulator
// stays in registers for the whole split, otherwise it lives in shared
// memory and each tile updates it RPT rows at a time. The minimum of one
// block per SM in the launch bounds lets ptxas use the registers it
// needs instead of spilling to reach a higher occupancy.
template <typename T, int D, int MODE, int RPT>
__global__ void __launch_bounds__(kThreads, 1)
    decode_split_kernel(Params p) {
  using C = Cfg<T, D, MODE>;
  using SM = Smem<T, D, MODE>;
  using PE = typename std::conditional<C::kInt8, int8_t, T>::type;
  constexpr int kRowStride = kThreads / D;   // rows between a thread's rows
  constexpr int kSlice = C::kChunksPerLane * C::kEltPerChunk;  // per lane

  const int pair = blockIdx.x;               // b * KVH + kvh
  const int split = blockIdx.y;
  const int b = pair / p.KVH;
  const int kvh = pair % p.KVH;
  const int G = p.H / p.KVH;
  const int S = p.S;
  const int R = G * S;  // query rows of this KV head: r = g * S + s
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int L = p.lane_len;
  const float scale = 1.f / sqrtf((float)D);
  const float neg_inf = -__int_as_float(0x7f800000);

  const int lane_tiles = (L + kTile - 1) / kTile;
  const int tile_begin = split * p.split_tiles;
  const int tile_end = min(tile_begin + p.split_tiles, lane_tiles);
  const int n_split = max(tile_end - tile_begin, 0);

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + SM::q_off());
  float* acc_s = reinterpret_cast<float*>(smem + SM::acc_off(R));
  float* p_s = reinterpret_cast<float*>(smem + SM::p_off(R));
  float* m_s = reinterpret_cast<float*>(smem + SM::stat_off(R));
  float* l_s = m_s + R;
  float* c_s = l_s + R;
  int* list_s = reinterpret_cast<int*>(smem + SM::list_off(R));
  int* any_s = list_s + kMaxSplitTiles;      // per tile of the split
  int* ent_s = reinterpret_cast<int*>(smem + SM::ent_off(R));
  int* flag_s = reinterpret_cast<int*>(smem + SM::flag_off(R));

  const T* q = static_cast<const T*>(p.q);
  const uint8_t* valid = p.valid + (int64_t)b * S * L;

  // Prologue: the split's block-table entries and the whole lane's valid
  // bytes are read together (one round trip), the tile copies start, and
  // the query rows are staged while the first tiles are in flight.
  const int tok_begin = tile_begin * kTile;
  const int tok_end = min(tile_end * kTile, L);
  const int bs = p.block_size;
  const int first_blk = p.table != nullptr ? tok_begin / bs : 0;
  if (p.table != nullptr && n_split > 0) {
    const int n_ent = (tok_end - 1) / bs - first_blk + 1;
    const int32_t* trow = p.table + (int64_t)b * p.max_blocks + first_blk;
    for (int i = tid; i < n_ent; i += kThreads)
      ent_s[i] = min(max(trow[i], 0), p.num_blocks - 1);  // never outside
  }
  // Does every query row have a valid position (only then may fully
  // masked tiles be skipped), and which of this split's tiles hold one
  // for any row? 16 bytes per thread and step; the 4 lanes that read a
  // tile's 64 bytes agree by shuffles and one of them writes its flag.
  const bool valid_vec16 =
      (L % 16 == 0) && ((reinterpret_cast<uintptr_t>(p.valid) & 15) == 0);
  unsigned row_bits = 0u;
  for (int base = 0; base < L; base += kThreads * 16) {
    const int pos = base + tid * 16;
    unsigned hit_rows = 0u;
    if (pos < L) {
      for (int s = 0; s < S; ++s) {
        const uint8_t* vrow = valid + (int64_t)s * L + pos;
        bool hit;
        if (valid_vec16) {
          const uint4 w = *reinterpret_cast<const uint4*>(vrow);
          hit = (w.x | w.y | w.z | w.w) != 0u;
        } else {
          hit = false;
          for (int e = 0; e < 16 && pos + e < L; ++e) hit |= vrow[e] != 0;
        }
        hit_rows |= (unsigned)hit << s;
      }
    }
    row_bits |= hit_rows;
    unsigned tile_hit = hit_rows != 0u;
    tile_hit |= __shfl_xor_sync(0xffffffffu, tile_hit, 1);
    tile_hit |= __shfl_xor_sync(0xffffffffu, tile_hit, 2);
    const int t = pos / kTile - tile_begin;
    if ((lane & 3) == 0 && pos < L && t >= 0 && t < n_split)
      any_s[t] = (int)tile_hit;
  }
  int skip_ok = 1;
  for (int s = 0; s < S; ++s)
    if (!__syncthreads_or((row_bits >> s) & 1u)) skip_ok = 0;
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < n_split; ++i)
      if (!skip_ok || any_s[i]) list_s[n++] = tile_begin + i;
    flag_s[0] = n;
  }
  __syncthreads();
  const int n_list = flag_s[0];

  const bool valid_vec4 =
      (L % 4 == 0) && ((reinterpret_cast<uintptr_t>(p.valid) & 3) == 0);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_list)
      stage_tile<T, D, MODE>(p, smem + (size_t)j * C::kStageBytes,
                             list_s[j] * kTile, b, kvh, valid, ent_s,
                             first_blk, valid_vec4,
                             any_s[list_s[j] - tile_begin] != 0);
    mma::cp_async_commit();
  }

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int g = r / S, s = r % S;
    const int h = kvh * G + g;
    q_s[i] = to_float(q[(((int64_t)b * S + s) * p.H + h) * D + d]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kMasked;
    l_s[r] = 0.f;
  }

  const int d_col = tid % D;
  const int r_first = tid / D;
  const bool acc_in_regs = r_first + RPT * kRowStride >= R;
  float acc[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) acc[k] = 0.f;

  const int grp = lane / C::kLpt, sub = lane % C::kLpt;
  for (int i = 0; i < n_list; ++i) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int j = i + kStages - 1;
      if (j < n_list)
        stage_tile<T, D, MODE>(
            p, smem + (size_t)(j % kStages) * C::kStageBytes,
            list_s[j] * kTile, b, kvh, valid, ent_s, first_blk, valid_vec4,
            any_s[list_s[j] - tile_begin] != 0);
      mma::cp_async_commit();
    }
    const unsigned char* base = smem + (size_t)(i % kStages) *
                                           C::kStageBytes;
    const PE* v_t = reinterpret_cast<const PE*>(base + C::kVOff);
    const uint8_t* valid_t = base + C::kValidOff;
    const float* ksc = reinterpret_cast<const float*>(base + C::kScaleOff);
    const float* vsc = ksc + kTile;
    const int t0 = list_s[i] * kTile;
    const int n = min(kTile, L - t0);

    // A tile with no valid position for any row (walked only because
    // some row of the lane has none at all) scores -1e30 everywhere
    // whatever K holds: its K was not copied, and no dot is taken.
    if (!any_s[list_s[i] - tile_begin]) {
      for (int e = tid; e < R * kTile; e += kThreads)
        p_s[e] = e % kTile < n ? kMasked : neg_inf;
    } else {
      // Scores: each warp takes 16 tokens, kLpt lanes share one token's
      // dot product (lane `sub` holds chunks sub, sub + kLpt, ...: a
      // quarter warp's 16-byte reads fall on distinct banks). The lane's
      // slices of its kPasses tokens stay in registers across the rows.
      float kf[C::kPasses][kSlice];
#pragma unroll
      for (int pass = 0; pass < C::kPasses; ++pass) {
        const int t = warp * kTokPerWarp + pass * C::kTokPerPass + grp;
#pragma unroll
        for (int cc = 0; cc < C::kChunksPerLane; ++cc) {
          const int ch = sub + cc * C::kLpt;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              base + C::kKOff + t * C::kRowBytes + ch * 16);
#pragma unroll
          for (int j = 0; j < C::kEltPerChunk; ++j) {
            float x = element<PE>(raw, j);
            if constexpr (C::kInt8) {
              x *= ksc[t];
              if constexpr (MODE == kInt8Bf16)
                x = __bfloat162float(__float2bfloat16(x));
            }
            kf[pass][cc * C::kEltPerChunk + j] = x;
          }
        }
      }
      for (int r = 0; r < R; ++r) {
        float qv[kSlice];
#pragma unroll
        for (int cc = 0; cc < C::kChunksPerLane; ++cc) {
          const float4* src = reinterpret_cast<const float4*>(
              q_s + r * D + (sub + cc * C::kLpt) * C::kEltPerChunk);
#pragma unroll
          for (int j = 0; j < C::kEltPerChunk / 4; ++j) {
            const float4 x = src[j];
            qv[cc * C::kEltPerChunk + 4 * j] = x.x;
            qv[cc * C::kEltPerChunk + 4 * j + 1] = x.y;
            qv[cc * C::kEltPerChunk + 4 * j + 2] = x.z;
            qv[cc * C::kEltPerChunk + 4 * j + 3] = x.w;
          }
        }
        float dot[C::kPasses];
#pragma unroll
        for (int pass = 0; pass < C::kPasses; ++pass) {
          dot[pass] = 0.f;
#pragma unroll
          for (int e = 0; e < kSlice; ++e) dot[pass] += qv[e] * kf[pass][e];
        }
#pragma unroll
        for (int o = C::kLpt / 2; o > 0; o >>= 1)
#pragma unroll
          for (int pass = 0; pass < C::kPasses; ++pass)
            dot[pass] += __shfl_xor_sync(0xffffffffu, dot[pass], o);
        if (sub == 0) {
#pragma unroll
          for (int pass = 0; pass < C::kPasses; ++pass) {
            const int t = warp * kTokPerWarp + pass * C::kTokPerPass + grp;
            float sc = neg_inf;   // past the lane end: weight exactly 0
            if (t < n)
              sc = valid_t[(r % S) * kTile + t] ? dot[pass] * scale : kMasked;
            p_s[r * kTile + t] = sc;
          }
        }
      }
    }
    __syncthreads();

    // the online-softmax update: one warp per row, two tokens per lane
    for (int r = warp; r < R; r += kWarps) {
      const float s0 = p_s[r * kTile + lane];
      const float s1 = p_s[r * kTile + lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float corr = expf(m_old - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      p_s[r * kTile + lane] = p0;
      p_s[r * kTile + lane + 32] = p1;
      const float tile_sum = warp_sum(p0 + p1);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + tile_sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc[r, d] = acc[r, d] * corr[r] + sum_t p[r, t] * v[t, d], RPT of
    // the thread's rows at a time
    for (int r0 = r_first; r0 < R; r0 += RPT * kRowStride) {
      float a[RPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = r0 + k * kRowStride;
        a[k] = 0.f;
        if (r < R) a[k] = (acc_in_regs ? acc[k] : acc_s[r * D + d_col]) *
                          c_s[r];
      }
      for (int t = 0; t < n; t += 4) {
        float vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if constexpr (C::kInt8) {
            float x = (float)v_t[(t + u) * D + d_col] * vsc[t + u];
            if constexpr (MODE == kInt8Bf16)
              x = __bfloat162float(__float2bfloat16(x));
            vv[u] = x;
          } else {
            vv[u] = to_float(v_t[(t + u) * D + d_col]);
          }
        }
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const int r = r0 + k * kRowStride;
          if (r < R) {
            const float4 pr =
                *reinterpret_cast<const float4*>(p_s + r * kTile + t);
            a[k] += pr.x * vv[0] + pr.y * vv[1] + pr.z * vv[2] +
                    pr.w * vv[3];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = r0 + k * kRowStride;
        if (acc_in_regs)
          acc[k] = a[k];
        else if (r < R)
          acc_s[r * D + d_col] = a[k];
      }
    }
  }
  mma::cp_async_wait<0>();
  if (acc_in_regs) {
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = r_first + k * kRowStride;
      if (r < R) acc_s[r * D + d_col] = acc[k];
    }
  }

  // From here each thread reads and writes only its own (row, column)
  // entries of acc_s.
  T* out = static_cast<T*>(p.out);
  // (__fdividef: the sum is at least 1e-30, inside the fast division's
  // range, and it has no slow-path subroutine call)
  if (p.splits == 1) {
    for (int r = r_first; r < R; r += kRowStride)
      out[out_offset(p, b, kvh, r, d_col, D)] = from_float<T>(
          __fdividef(acc_s[r * D + d_col], fmaxf(l_s[r], 1e-30f)));
    return;
  }

  // Partials: (m, l) at ws[((pair * splits + split) * R + r) * 2], then
  // after all of them acc at [(pair * splits + split) * R + r][D].
  const int64_t slots = (int64_t)gridDim.x * p.splits;
  const int64_t slot = (int64_t)pair * p.splits + split;
  float* ws_ml = p.ws;
  float* ws_acc = p.ws + slots * R * 2;
  if (tid < R) {
    ws_ml[(slot * R + tid) * 2] = m_s[tid];
    ws_ml[(slot * R + tid) * 2 + 1] = l_s[tid];
  }
  for (int r = r_first; r < R; r += kRowStride)
    ws_acc[(slot * R + r) * D + d_col] = acc_s[r * D + d_col];
  __threadfence();
  __syncthreads();
  if (tid == 0)
    flag_s[1] = atomicAdd(p.counters + pair, 1) == p.splits - 1;
  __syncthreads();
  if (!flag_s[1]) return;
  __threadfence();

  // the last split block of this pair: combine in split order
  const int64_t first = (int64_t)pair * p.splits;
  for (int r = r_first; r < R; r += kRowStride) {
    float M = kMasked;
    for (int i = 0; i < p.splits; ++i)
      M = fmaxf(M, __ldcg(ws_ml + ((first + i) * R + r) * 2));
    float lsum = 0.f, a = 0.f;
    for (int i = 0; i < p.splits; ++i) {
      const float w = expf(__ldcg(ws_ml + ((first + i) * R + r) * 2) - M);
      lsum += w * __ldcg(ws_ml + ((first + i) * R + r) * 2 + 1);
      a += w * __ldcg(ws_acc + ((first + i) * R + r) * D + d_col);
    }
    out[out_offset(p, b, kvh, r, d_col, D)] =
        from_float<T>(__fdividef(a, fmaxf(lsum, 1e-30f)));
  }
  if (tid == 0) p.counters[pair] = 0;
}

// Launch one rows-per-thread bucket. The dynamic shared-memory limit is
// raised once per template instance and device (to what the largest R
// needs), not on every launch.
template <typename T, int D, int MODE, int RPT>
cudaError_t launch_rpt(const Params& p, cudaStream_t stream) {
  using SM = Smem<T, D, MODE>;
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(decode_split_kernel<T, D, MODE, RPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SM::bytes(kMaxRows));
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const int R = (p.H / p.KVH) * p.S;
  decode_split_kernel<T, D, MODE, RPT>
      <<<dim3(p.B * p.KVH, p.splits), kThreads, SM::bytes(R), stream>>>(p);
  return cudaGetLastError();
}

// The MHA decode tick (one row per thread) gets its own instance.
template <typename T, int D, int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int R = (p.H / p.KVH) * p.S;
  if (R <= kThreads / D) return launch_rpt<T, D, MODE, 1>(p, stream);
  return launch_rpt<T, D, MODE, 8>(p, stream);
}

template <typename T, int D>
cudaError_t launch_mode(const Params& p, int mode, cudaStream_t stream) {
  if (mode == kSameAsQ) return launch<T, D, kSameAsQ>(p, stream);
  if (mode == kInt8Fp32) return launch<T, D, kInt8Fp32>(p, stream);
  if (mode == kInt8Bf16) return launch<T, D, kInt8Bf16>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (q and the output share it). mode: a
// PoolMode; 0 = the pools in q's dtype, 1 or 2 = int8 pools with fp32
// scales k_scale / v_scale, dequantized through fp32 or bf16. splits /
// split_tiles: the host's split plan; with splits > 1, ws holds
// B * KVH * splits * R * (D + 2) floats and counters B * KVH ints that
// are 0 (the kernel leaves them 0). Returns a cudaError_t: 0 when the
// launch was accepted. The Python wrapper has already checked shapes,
// dtypes, contiguity and alignment.
int fstpu_decode_attention(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* valid, const void* table, void* out,
                           void* ws, void* counters, int B, int S, int H,
                           int KVH, int D, int lane_len, int block_size,
                           int max_blocks, int num_blocks, int splits,
                           int split_tiles, int dtype, int mode,
                           void* stream) {
  if (B == 0) return 0;
  const int R = H / KVH * S;
  if (S < 1 || S > kMaxS || R > kMaxRows || splits < 1 || split_tiles < 1 ||
      split_tiles > kMaxSplitTiles ||
      (long long)splits * split_tiles * kTile < lane_len ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const uint8_t*>(valid),
           static_cast<const int32_t*>(table), out,
           static_cast<float*>(ws), static_cast<int*>(counters), B, S, H,
           KVH, lane_len, block_size, max_blocks, num_blocks, splits,
           split_tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return launch_mode<__nv_bfloat16, 128>(p, mode, st);
  if (dtype == 1 && D == 64) return launch_mode<__nv_bfloat16, 64>(p, mode, st);
  if (dtype == 0 && D == 128) return launch_mode<float, 128>(p, mode, st);
  if (dtype == 0 && D == 64) return launch_mode<float, 64>(p, mode, st);
  return (int)cudaErrorInvalidValue;
}

const char* fstpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
