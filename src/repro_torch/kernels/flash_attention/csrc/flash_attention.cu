// Causal / sliding-window / GQA attention with an online softmax
// (flash attention, forward) on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention/kernel.py (reached through
// `flash_attention_hm`).  Same contract, in the model's layout:
//
//   q  [B, T, H, D]   float32 or bfloat16
//   k  [B, S, K, D]   the same type; H = K * group, query head h reads
//   v  [B, S, K, D]   kv head h / group
//   o  [B, T, H, D]   the same type
//
// o = softmax(q k^T / sqrt(D) masked) v per (b, h), where key s is kept
// for query t when s < S, and, with `causal`, s <= t, and, with a
// `window` w > 0, t - s < w.  As in the TPU kernel: scores, the running
// maximum m, the running sum l and the accumulator are float32; masked
// scores are -1e30 (not -inf); p stays float32 in the product with V; the
// output is acc / max(l, 1e-30), so a row with no live key gives 0.
//
// What bounds it: operations.  At the serving path's shape (T = S =
// 3072, D = 256, window 2048, 10 heads) the live (query, key) pairs need
// 4 D of multiply-adds each, about 4.3e10 operations on 3 MB of K and V.
// This first kernel uses no tensor cores: it is held to the card's
// float32 rate, 67 TFLOP/s, not the 989 TFLOP/s of bf16 wgmma, which is
// the work of its redesign.
//
// Design.  One block of 8 warps owns 64 query rows of one (b, h); each
// warp owns 8 rows.  The block walks only the kv tiles of 32 keys that
// the causal and window masks leave live for its rows (the TPU kernel
// skipped dead tiles with pl.when), loading each tile into shared memory
// as float32: K transposed ([D][33], padded so both its stores and its
// reads are free of bank conflicts) and V ([32][D]).  The query tile
// stays in shared memory for the whole walk.  In a tile, lane j of a warp
// computes key j's score for the warp's 8 rows, so the row maximum and
// sum are warp shuffles, and then each lane accumulates 8 rows x D/32
// output columns in registers, taking each p from the lane that owns its
// key by a shuffle.  The ragged tail (s >= S, t >= T) is masked inside the
// kernel: keys beyond S load as zeros and are masked, rows beyond T are
// not written.  Blocks are independent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kBQ = kWarps * kRows;       // query rows per block
constexpr int kBK = 32;                   // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

size_t shared_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * d +
                          static_cast<size_t>(d) * (kBK + 1) +
                          static_cast<size_t>(kBK) * d);
}

// DC: output columns per lane, ceil(D / 32) rounded up to a power of two.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int seq_q,
                 int seq_k, int n_heads, int n_kv, int d, int group,
                 int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [kBQ][d]
  float* kt = qs + kBQ * d;                // [d][kBK + 1]
  float* vs = kt + d * (kBK + 1);          // [kBK][d]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kh = h / group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRows;       // this warp's first row

  const int64_t q_step = static_cast<int64_t>(n_heads) * d;   // t -> t + 1
  const int64_t k_step = static_cast<int64_t>(n_kv) * d;
  const T* qb = q + (static_cast<int64_t>(bi) * seq_q * n_heads + h) * d;
  const T* kb = k + (static_cast<int64_t>(bi) * seq_k * n_kv + kh) * d;
  const T* vb = v + (static_cast<int64_t>(bi) * seq_k * n_kv + kh) * d;
  T* ob = o + (static_cast<int64_t>(bi) * seq_q * n_heads + h) * d;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d;
    const int t = q0 + r;
    qs[i] = t < seq_q ? to_f32(qb[t * q_step + (i - r * d)]) : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.0f;
  }

  // the kv tiles live for some row of this block
  const int q_last = min(q0 + kBQ, seq_q) - 1;
  const int k_end = causal ? min(seq_k, q_last + 1) : seq_k;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();                       // the previous tile is consumed
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int key = i / d;
      const int e = i - key * d;
      const int s = k0 + key;
      float kv = 0.0f, vv = 0.0f;
      if (s < seq_k) {
        kv = to_f32(kb[s * k_step + e]);
        vv = to_f32(vb[s * k_step + e]);
      }
      kt[e * (kBK + 1) + key] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    // scores: lane `lane` holds key k0 + lane for the warp's rows
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.0f;
    for (int e = 0; e < d; e += 4) {
      const float k0v = kt[(e + 0) * (kBK + 1) + lane];
      const float k1v = kt[(e + 1) * (kBK + 1) + lane];
      const float k2v = kt[(e + 2) * (kBK + 1) + lane];
      const float k3v = kt[(e + 3) * (kBK + 1) + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (r0 + r) * d + e);
        float s = sc[r];
        s = fmaf(qv.x, k0v, s);
        s = fmaf(qv.y, k1v, s);
        s = fmaf(qv.z, k2v, s);
        s = fmaf(qv.w, k3v, s);
        sc[r] = s;
      }
    }

    // masks and the online softmax, one row per register
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + r0 + r;
      bool live = kpos < seq_k;
      if (causal) live = live && kpos <= qpos;
      if (window > 0) live = live && qpos - kpos < window;
      const float s = live ? sc[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      sc[r] = p;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }

    // acc += p v, p of key j taken from lane j
    for (int j = 0; j < kBK; ++j) {
      float pj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pj[r] = __shfl_sync(kFull, sc[r], j);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = lane + 32 * c;
        const float vv = col < d ? vs[j * d + col] : 0.0f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + r0 + r;
    if (t >= seq_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(ob + t * q_step + col, acc[r][c] / denom);
    }
  }
}

template <typename T, int DC>
int launch_dc(const void* q, const void* k, const void* v, void* o, int B,
              int seq_q, int seq_k, int n_heads, int n_kv, int d, int causal,
              int window, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DC>;
  const size_t smem = shared_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((seq_q + kBQ - 1) / kBQ, n_heads, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq_q, seq_k, n_heads,
      n_kv, d, n_heads / n_kv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int seq_q, int seq_k, int n_heads, int n_kv, int d, int causal,
           int window, float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch_dc<T, 1>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                           causal, window, scale, stream);
  if (d <= 64)
    return launch_dc<T, 2>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                           causal, window, scale, stream);
  if (d <= 128)
    return launch_dc<T, 4>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                           causal, window, scale, stream);
  return launch_dc<T, 8>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                         causal, window, scale, stream);
}

}  // namespace

// Launches the kernel on `stream`, which must belong to the calling
// thread's current device; returns the cudaError_t of the launch (0 on
// success).  `bf16` nonzero means q, k, v and o are bfloat16, else
// float32.  B >= 1, seq_q >= 1, seq_k >= 1, n_heads a multiple of n_kv,
// 4 <= d <= 256 with d a multiple of 4, window >= 0 (0: no window); every
// tensor contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B,
                                      int seq_q, int seq_k, int n_heads,
                                      int n_kv, int d, int causal,
                                      int window, float scale, int bf16,
                                      void* stream) {
  if (d < 4 || d > kMaxD || d % 4 != 0 || n_kv < 1 || n_heads % n_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, seq_q, seq_k, n_heads,
                                      n_kv, d, causal, window, scale, st)
              : launch<float>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                              causal, window, scale, st);
}
