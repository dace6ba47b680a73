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
// ([B, L, KVH] or [num_blocks, block_size, KVH]). Each element is
// dequantized as it is staged, int8 -> fp32 x scale -> rounded to the
// compute dtype (fp32 or bf16) -> fp32, which is dequantize_kv's
// rounding, and the rest of the kernel is the bf16 path unchanged. The
// pool stays int8 in device memory: no dequantized copy is made.
//
// What bounds it on an H100: bytes. Each tick reads every valid K/V
// token of every lane once (2 * tokens * KVH * D * sizeof(T), or for an
// int8 pool 2 * tokens * KVH * (D + 4): values and scales) and does ~4
// flops per element read, far below the ~295 flops/byte at which the
// tensor cores would become the limit.
//
// Design (simple first, see PERF.md for its time against the bound):
// - one thread block per (lane, KV head); the block holds all
//   H/KVH * S query rows of that KV head in shared memory, so each K/V
//   element is read from device memory once per tick, not once per
//   query head (the GQA saving the TPU kernel got from its index map);
// - a loop over the lane in 32-token tiles takes the place of the TPU
//   kernel's sequential grid axis; each token's physical row comes from
//   the block table inside the loop, so paged and slot pools share one
//   path and any block size that is a multiple of 8 works;
// - tiles with no valid position for any row are skipped without
//   reading K/V (the TPU kernel reads every block), unless some row of
//   the block has no valid position at all: that row's uniform average
//   needs every value of the lane;
// - K/V tiles are staged in shared memory with 16-byte loads; one warp
//   scores a row (one token per lane, warp shuffles for max and sum);
//   the running max, sum and the fp32 accumulator live in shared memory
//   across the loop.
// Later work: cp.async/TMA double buffering, split-K over long lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // tokens per tile: one per warp lane
constexpr float kMasked = -1e30f;    // the TPU kernel's _NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;   // int8 pools: [rows, KVH] fp32, else null
  const float* v_scale;
  const uint8_t* valid;   // [B, S, lane_len] bool
  const int32_t* table;   // [B, max_blocks], or null for a slot pool
  void* out;              // [B, S, H, D]
  int B, S, H, KVH;
  int lane_len;           // positions per lane (virtual for paged)
  int block_size;         // paged block size
  int max_blocks;
  int num_blocks;
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

// Physical token row of logical position `pos` in lane `b`.
__device__ __forceinline__ int64_t token_row(const Params& p, int b,
                                             int pos) {
  if (p.table == nullptr) return (int64_t)b * p.lane_len + pos;
  int blk = p.table[(int64_t)b * p.max_blocks + pos / p.block_size];
  blk = min(max(blk, 0), p.num_blocks - 1);  // never read outside the pool
  return (int64_t)blk * p.block_size + pos % p.block_size;
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// How the pool is stored: in the query's dtype, or int8 rounded through
// fp32 or bf16 after dequantization. Shared memory holds the query's
// dtype in the first case and fp32 otherwise.
enum PoolMode { kSameAsQ = 0, kInt8Fp32 = 1, kInt8Bf16 = 2 };

template <typename T, int MODE>
struct Tile {
  using type = T;
};
template <typename T>
struct Tile<T, kInt8Fp32> {
  using type = float;
};
template <typename T>
struct Tile<T, kInt8Bf16> {
  using type = float;
};

// Stage the tile's K and V rows [t0, t0 + n) into shared memory; rows
// past the lane end are zero.
template <typename T, int D, int MODE, int PITCH_K>
__device__ __forceinline__ void stage_tile(const Params& p, int b, int kvh,
                                           int t0, int n,
                                           typename Tile<T, MODE>::type* k_s,
                                           typename Tile<T, MODE>::type* v_s) {
  if constexpr (MODE == kSameAsQ) {
    // 16-byte copies of the pool's own elements
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kVecPerRow = D / kVec;
    const T* kp = static_cast<const T*>(p.k);
    const T* vp = static_cast<const T*>(p.v);
    for (int i = threadIdx.x; i < kTile * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow, c = i % kVecPerRow;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (t < n) {
        const int64_t off = (token_row(p, b, t0 + t) * p.KVH + kvh) * D;
        kv = reinterpret_cast<const uint4*>(kp + off)[c];
        vv = reinterpret_cast<const uint4*>(vp + off)[c];
      }
      reinterpret_cast<uint4*>(k_s + t * PITCH_K)[c] = kv;
      reinterpret_cast<uint4*>(v_s + t * D)[c] = vv;
    }
  } else {
    // 16 int8 values per thread and step, dequantized in registers:
    // fp32(int8) * scale, rounded to the compute dtype, kept as fp32
    constexpr int kVecPerRow = D / 16;
    const int8_t* kp = static_cast<const int8_t*>(p.k);
    const int8_t* vp = static_cast<const int8_t*>(p.v);
    for (int i = threadIdx.x; i < kTile * kVecPerRow; i += kThreads) {
      const int t = i / kVecPerRow, c = i % kVecPerRow;
      float kf[16], vf[16];
      if (t < n) {
        const int64_t head = token_row(p, b, t0 + t) * p.KVH + kvh;
        const uint4 kraw = reinterpret_cast<const uint4*>(kp + head * D)[c];
        const uint4 vraw = reinterpret_cast<const uint4*>(vp + head * D)[c];
        const int8_t* ke = reinterpret_cast<const int8_t*>(&kraw);
        const int8_t* ve = reinterpret_cast<const int8_t*>(&vraw);
        const float ks = p.k_scale[head], vs = p.v_scale[head];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          kf[j] = (float)ke[j] * ks;
          vf[j] = (float)ve[j] * vs;
          if constexpr (MODE == kInt8Bf16) {
            kf[j] = __bfloat162float(__float2bfloat16(kf[j]));
            vf[j] = __bfloat162float(__float2bfloat16(vf[j]));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) kf[j] = vf[j] = 0.f;
      }
      float4* kd = reinterpret_cast<float4*>(k_s + t * PITCH_K + c * 16);
      float4* vd = reinterpret_cast<float4*>(v_s + t * D + c * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kd[j] = make_float4(kf[4 * j], kf[4 * j + 1], kf[4 * j + 2],
                            kf[4 * j + 3]);
        vd[j] = make_float4(vf[4 * j], vf[4 * j + 1], vf[4 * j + 2],
                            vf[4 * j + 3]);
      }
    }
  }
}

// Shared-memory carve-up, used identically by host and device.
template <typename T, int D>
struct Smem {
  static constexpr int kVec = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int kPitchK = D + kVec;         // padded K row
  __host__ __device__ static size_t q_off() { return 0; }
  __host__ __device__ static size_t acc_off(int R) {
    return align16((size_t)R * D * 4);
  }
  __host__ __device__ static size_t p_off(int R) {
    return acc_off(R) + align16((size_t)R * D * 4);
  }
  __host__ __device__ static size_t stat_off(int R) {
    return p_off(R) + align16((size_t)R * kTile * 4);
  }
  __host__ __device__ static size_t k_off(int R) {
    return stat_off(R) + align16((size_t)3 * R * 4);
  }
  __host__ __device__ static size_t v_off(int R) {
    return k_off(R) + align16((size_t)kTile * kPitchK * sizeof(T));
  }
  __host__ __device__ static size_t bytes(int R) {
    return v_off(R) + align16((size_t)kTile * D * sizeof(T));
  }
};

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(Params p) {
  using TS = typename Tile<T, MODE>::type;  // staged K/V element
  using S_ = Smem<TS, D>;
  constexpr int kVec = S_::kVec;
  constexpr int kPitchK = S_::kPitchK;

  const int b = blockIdx.x / p.KVH;
  const int kvh = blockIdx.x % p.KVH;
  const int G = p.H / p.KVH;
  const int S = p.S;
  const int R = G * S;  // query rows of this KV head: r = g * S + s
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int L = p.lane_len;
  const float scale = 1.f / sqrtf((float)D);
  const float neg_inf = -__int_as_float(0x7f800000);

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + S_::q_off());
  float* acc_s = reinterpret_cast<float*>(smem + S_::acc_off(R));
  float* p_s = reinterpret_cast<float*>(smem + S_::p_off(R));
  float* m_s = reinterpret_cast<float*>(smem + S_::stat_off(R));
  float* l_s = m_s + R;
  float* c_s = l_s + R;
  TS* k_s = reinterpret_cast<TS*>(smem + S_::k_off(R));
  TS* v_s = reinterpret_cast<TS*>(smem + S_::v_off(R));

  const T* q = static_cast<const T*>(p.q);
  const uint8_t* valid = p.valid + (int64_t)b * S * L;

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

  // Does every query row have at least one valid position? Only then
  // may fully masked tiles be skipped (see the header).
  int skip_ok = 1;
  for (int s = 0; s < S; ++s) {
    int any = 0;
    for (int pos = tid; pos < L; pos += kThreads) any |= valid[s * L + pos];
    if (!__syncthreads_or(any)) skip_ok = 0;
  }

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int n = min(kTile, L - t0);
    if (skip_ok) {
      int any = 0;
      for (int i = tid; i < S * kTile; i += kThreads) {
        const int s = i / kTile, t = i % kTile;
        if (t < n) any |= valid[s * L + t0 + t];
      }
      if (!__syncthreads_or(any)) continue;
    }

    stage_tile<T, D, MODE, kPitchK>(p, b, kvh, t0, n, k_s, v_s);
    __syncthreads();

    // Scores and the online-softmax update: one warp per row, one token
    // per lane.
    for (int r = warp; r < R; r += kWarps) {
      const int s = r % S;
      float score = neg_inf;  // past the lane end: weight exactly 0
      if (lane < n) {
        const float* qrow = q_s + r * D;
        const TS* krow = k_s + lane * kPitchK;
        float dot = 0.f;
#pragma unroll 4
        for (int d0 = 0; d0 < D; d0 += kVec) {
          uint4 raw = *reinterpret_cast<const uint4*>(krow + d0);
          const TS* e = reinterpret_cast<const TS*>(&raw);
#pragma unroll
          for (int j = 0; j < kVec; ++j) dot += qrow[d0 + j] * to_float(e[j]);
        }
        score = valid[s * L + t0 + lane] ? dot * scale : kMasked;
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(score));
      const float corr = expf(m_old - m_new);
      const float prob = expf(score - m_new);
      const float tile_sum = warp_sum(prob);
      p_s[r * kTile + lane] = prob;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + tile_sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc[r, d] = acc[r, d] * corr[r] + sum_t p[r, t] * v[t, d]
    constexpr int kRowGroups = kThreads / D;
    const int d = tid % D;
    for (int r = tid / D; r < R; r += kRowGroups) {
      const float* prow = p_s + r * kTile;
      float a = acc_s[r * D + d] * c_s[r];
      for (int t = 0; t < n; ++t) a += prow[t] * to_float(v_s[t * D + d]);
      acc_s[r * D + d] = a;
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(p.out);
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int g = r / S, s = r % S;
    const int h = kvh * G + g;
    out[(((int64_t)b * S + s) * p.H + h) * D + d] =
        from_float<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D, int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int R = (p.H / p.KVH) * p.S;
  const size_t smem = Smem<typename Tile<T, MODE>::type, D>::bytes(R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, D, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_attention_kernel<T, D, MODE>
      <<<p.B * p.KVH, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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
// scales k_scale / v_scale, dequantized through fp32 or bf16. Returns a
// cudaError_t: 0 when the launch was accepted. The Python wrapper has
// already checked shapes, dtypes, contiguity and alignment.
int fstpu_decode_attention(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           const void* valid, const void* table, void* out,
                           int B, int S, int H, int KVH, int D,
                           int lane_len, int block_size, int max_blocks,
                           int num_blocks, int dtype, int mode,
                           void* stream) {
  if (B == 0) return 0;
  Params p{q, k, v, static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const uint8_t*>(valid),
           static_cast<const int32_t*>(table), out, B, S, H, KVH,
           lane_len, block_size, max_blocks, num_blocks};
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
