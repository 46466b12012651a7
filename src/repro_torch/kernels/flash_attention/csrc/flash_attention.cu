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
// scores are -1e30 (not -inf); the output is acc / max(l, 1e-30), so a
// row with no live key gives 0.  The bfloat16 instance rounds p, relative
// to its running maximum, to bf16 before the product with V (wgmma's A
// operand is bf16), as the JAX package's model does (`p.astype(vc.dtype)`);
// l sums the unrounded p.  The float32 instance and the plain version
// (ref.py) keep p in float32, the TPU kernel's numerics; the bf16
// tolerance holds the difference.
//
// What bounds it: operations.  At the serving path's shape (T = S =
// 3072, D = 256, window 2048, 10 heads on one kv head) the live (query,
// key) pairs need 4 D operations each, about 4.3e10 in all, on 3 MB of K
// and V: 0.043 ms at the 989 TFLOP/s of bf16 tensor cores, against 0.005
// ms to read the inputs.  Two instances:
//
// * bfloat16 (the serving path): tensor cores.  A block of three
//   warpgroups owns 128 query rows of one (b, h).  Warpgroup 0 is the
//   producer: it loads the block's Q once and the live K / V tiles of 64
//   keys into a ring of two stages in shared memory, with `mbarrier`s
//   marking a stage full (for the consumers) and empty (for the
//   producer).  Warpgroups 1 and 2 are the consumers, 64 query rows each,
//   and share every K / V tile: S = Q K^T is `wgmma` (m64n64k16, Q and K
//   from shared memory, float32 in registers), the mask and the online
//   softmax run on S in registers, p is rounded to bf16 into wgmma's A
//   fragment, and O += P V is `wgmma` with P from registers and V from
//   shared memory (trans-b), O in float32 registers (64 x D per
//   warpgroup).  One warpgroup's softmax overlaps the other's products.
//   Tiles are stored in the layout wgmma's descriptors read, 8-row atoms
//   with the 128-byte swizzle (64- and 32-byte for head widths 32 and
//   16), so neither operand is shuffled by hand.  Head dims below the
//   instance's width (16, 32, 64, 128, 256) are zero-padded in shared
//   memory: zero columns add nothing to Q K^T, and padded output columns
//   are not stored.  At D = 256 a tile stage is 64 KB (K and V), Q 64 KB:
//   192 KB with two stages, one block an SM; the O accumulator is 128
//   registers a thread and S 32, so the producer gives up registers
//   (`setmaxnreg` 40) for the consumers (232).
//   A consumer skips the products of a tile dead for all its 64 rows and
//   the mask of a tile live for all of them.  Blocks run the last query
//   tiles of every head first (under the causal mask they hold the most
//   kv tiles), so the long blocks do not trail at the end.  The
//   warpgroup index is broadcast from lane 0: ptxas must see the wgmma
//   path as uniform, or it serializes the products.
//   Loads: TMA (`cp.async.bulk.tensor`, 4-D tensor maps over [B, seq,
//   heads, D] passed as __grid_constant__, out-of-range rows and columns
//   filled with zeros by the hardware) when every row stride is a
//   multiple of 16 bytes (D a multiple of 8), the box is no wider than
//   the head (D >= 64 or D equal to the width) and the tensors are
//   16-byte aligned; otherwise (D = 4, 12, 20, 40, ...; rows of 8-byte
//   multiples) `cp.async` of 8-byte pieces with zero-fill from the whole
//   producer warpgroup, swizzled by hand into the same layout.  The
//   launcher picks the width and the route from D and the addresses.
// * float32 (tests): a SIMT kernel.  Tensor cores
//   cannot hold its 2e-5 tolerance without three TF32 products a product
//   (3xTF32), so it stays on the 67 TFLOP/s float32 rate: one block of 8
//   warps per 64 query rows, kv tiles of 32 keys in shared memory, scores
//   and p V as scalar FMAs, row statistics by warp shuffles.
//
// Both walk only the kv tiles the causal and window masks leave live for
// some row of the block (the TPU kernel skipped dead tiles with pl.when),
// mask keys past S and rows past T inside the kernel, and keep blocks
// independent.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxD = 256;

// ------------------------------------------------------------ float32 SIMT

constexpr int kWarps = 8;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kBQ = kWarps * kRows;       // query rows per block
constexpr int kBK = 32;                   // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;

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
template <int DC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int seq_q, int seq_k, int n_heads, int n_kv, int d,
                 int group, int causal, int window, float scale) {
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
  const float* qb = q + (static_cast<int64_t>(bi) * seq_q * n_heads + h) * d;
  const float* kb = k + (static_cast<int64_t>(bi) * seq_k * n_kv + kh) * d;
  const float* vb = v + (static_cast<int64_t>(bi) * seq_k * n_kv + kh) * d;
  float* ob = o + (static_cast<int64_t>(bi) * seq_q * n_heads + h) * d;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d;
    const int t = q0 + r;
    qs[i] = t < seq_q ? qb[t * q_step + (i - r * d)] : 0.0f;
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
        kv = kb[s * k_step + e];
        vv = vb[s * k_step + e];
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
      if (col < d) ob[t * q_step + col] = acc[r][c] / denom;
    }
  }
}

template <int DC>
int launch_f32_dc(const void* q, const void* k, const void* v, void* o,
                  int B, int seq_q, int seq_k, int n_heads, int n_kv, int d,
                  int causal, int window, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<DC>;
  const size_t smem = shared_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((seq_q + kBQ - 1) / kBQ, n_heads, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), seq_q, seq_k,
      n_heads, n_kv, d, n_heads / n_kv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int seq_q, int seq_k, int n_heads, int n_kv, int d,
               int causal, int window, float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch_f32_dc<1>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                            causal, window, scale, stream);
  if (d <= 64)
    return launch_f32_dc<2>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                            causal, window, scale, stream);
  if (d <= 128)
    return launch_f32_dc<4>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                            causal, window, scale, stream);
  return launch_f32_dc<8>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                          causal, window, scale, stream);
}

// ------------------------------------------------------- bfloat16 wgmma

constexpr int kTcRows = 128;              // query rows per block
constexpr int kTcKeys = 64;               // keys per kv tile
constexpr int kTcStages = 2;              // kv tiles in flight
constexpr int kTcThreads = 384;           // producer + 2 consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

struct TcArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int seq_q, seq_k, n_heads, n_kv, d, group, causal, window, use_tma;
  float scale_log2;                       // 1 / sqrt(D) * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// 8 bytes from global to shared, zero-filled when `ok` is false
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 8 : 0) : "memory");
}

// Tile layout for head width W: rows of SW = min(2W, 128) bytes, one
// region of `rows` x SW bytes per 64 columns, and inside each 8-row x
// SW-byte atom the 16-byte chunk c of row r stored at c ^ (r / (128 / SW)
// mod SW / 16): the 128-, 64- and 32-byte swizzles of TMA and wgmma
// (byte-address bits [7, 10) xored into bits [4, 7)).
template <int W>
struct Layout {
  static constexpr int SW = W * 2 < 128 ? W * 2 : 128;
  static constexpr uint64_t kType = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  __device__ static uint32_t offset(int row, int col, int rows) {
    const uint32_t b = col * 2;
    const uint32_t o = (b / SW) * rows * SW + row * SW + b % SW;
    return o ^ (((o >> 7) & (SW / 16 - 1)) << 4);
  }
};

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle type in bits 62-63
template <int W>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (Layout<W>::kType << 62);
}

// Queues the copies of rows [row0, row0 + rows) of one head (`base`, rows
// `stride` elements apart, `n_rows` of them real) into a tile, by the 128
// threads of the producer warpgroup; cp_async_finish waits for them and
// makes them visible to wgmma.
template <int W>
__device__ void copy_tile(uint32_t tile, const __nv_bfloat16* base,
                          int64_t stride, int row0, int rows, int n_rows,
                          int d, int tid) {
  constexpr int kPieces = W / 4;             // 8-byte pieces a row
  for (int i = tid; i < rows * kPieces; i += 128) {
    const int r = i / kPieces;
    const int col = (i - r * kPieces) * 4;
    const bool ok = row0 + r < n_rows && col < d;
    const __nv_bfloat16* src = ok ? base + (row0 + r) * stride + col : base;
    cp_async8(tile + Layout<W>::offset(r, col, rows), src, ok);
  }
}

__device__ __forceinline__ void cp_async_finish() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int W>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const TcArgs a) {
  using L = Layout<W>;
  constexpr int SW = L::SW;
  constexpr uint32_t kQBytes = kTcRows * W * 2;
  constexpr uint32_t kKBytes = kTcKeys * W * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t k_tile = q_tile + kQBytes;                 // [stage]
  const uint32_t v_tile = k_tile + kTcStages * kKBytes;     // [stage]
  const uint32_t bars = v_tile + kTcStages * kKBytes;
  const uint32_t q_bar = bars;
  const uint32_t full_bar = bars + 8;                       // [stage]
  const uint32_t empty_bar = full_bar + 8 * kTcStages;      // [stage]

  // blockIdx.x runs over (query tile, head), the last query tiles of every
  // head first: under the causal mask they have the most kv tiles
  const int n_qt = (a.seq_q + kTcRows - 1) / kTcRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / a.n_heads) * kTcRows;
  const int h = blockIdx.x % a.n_heads;
  const int bi = blockIdx.y;
  const int kh = h / a.group;

  // the kv tiles live for some row of the block
  const int q_last = min(q0 + kTcRows, a.seq_q) - 1;
  const int k_end = a.causal ? min(a.seq_k, q_last + 1) : a.seq_k;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_first = k_begin / kTcKeys;
  const int n_tiles = max(0, (k_end + kTcKeys - 1) / kTcKeys - t_first);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 8);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, taken from lane 0 so the compiler sees it is uniform
  // (wgmma in a path it must treat as divergent gets serialized)
  const int wg_idx = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg_idx == 0) {
    // ---------------------------------------------------------- producer
    if constexpr (W == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int tid = threadIdx.x;
    const int64_t q_stride = static_cast<int64_t>(a.n_heads) * a.d;
    const int64_t k_stride = static_cast<int64_t>(a.n_kv) * a.d;
    const __nv_bfloat16* qb =
        a.q + (static_cast<int64_t>(bi) * a.seq_q * a.n_heads + h) * a.d;
    const __nv_bfloat16* kb =
        a.k + (static_cast<int64_t>(bi) * a.seq_k * a.n_kv + kh) * a.d;
    const __nv_bfloat16* vb =
        a.v + (static_cast<int64_t>(bi) * a.seq_k * a.n_kv + kh) * a.d;
    if (a.use_tma) {
      if (tid == 0) {
        mbar_expect_tx(q_bar, kQBytes);
        for (int c = 0; c < W; c += SW / 2)
          tma_load(q_tile + (c * 2 / SW) * kTcRows * SW, &tm_q, q_bar, c, h,
                   q0, bi);
        for (int i = 0; i < n_tiles; ++i) {
          const int s = i % kTcStages;
          const int k0 = (t_first + i) * kTcKeys;
          mbar_wait(empty_bar + 8 * s, ((i / kTcStages) & 1) ^ 1);
          mbar_expect_tx(full_bar + 8 * s, 2 * kKBytes);
          for (int c = 0; c < W; c += SW / 2) {
            const uint32_t off = (c * 2 / SW) * kTcKeys * SW;
            tma_load(k_tile + s * kKBytes + off, &tm_k, full_bar + 8 * s, c,
                     kh, k0, bi);
            tma_load(v_tile + s * kKBytes + off, &tm_v, full_bar + 8 * s, c,
                     kh, k0, bi);
          }
        }
      }
    } else {
      copy_tile<W>(q_tile, qb, q_stride, q0, kTcRows, a.seq_q, a.d, tid);
      cp_async_finish();
      if (tid == 0) mbar_arrive(q_bar);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kTcStages;
        const int k0 = (t_first + i) * kTcKeys;
        mbar_wait(empty_bar + 8 * s, ((i / kTcStages) & 1) ^ 1);
        copy_tile<W>(k_tile + s * kKBytes, kb, k_stride, k0, kTcKeys,
                     a.seq_k, a.d, tid);
        copy_tile<W>(v_tile + s * kKBytes, vb, k_stride, k0, kTcKeys,
                     a.seq_k, a.d, tid);
        cp_async_finish();
        if (tid == 0) mbar_arrive(full_bar + 8 * s);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (W == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = wg_idx - 1;                      // 0 or 1
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int r_lo = q0 + wg * 64;                  // this warpgroup's rows
    const int r_hi = min(r_lo + 63, a.seq_q - 1);
    const int row0 = r_lo + warp * 16 + lane / 4;   // and row0 + 8
    const int col_l = 2 * (lane & 3);

    float o[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    // Q (rows r_lo..) as wgmma's A operand, K-major; one descriptor per
    // 16 columns: region c / 64, 32 bytes a step inside the swizzle atom
    const uint32_t q_rows = q_tile + wg * 64 * SW;
    mbar_wait(q_bar, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kTcStages;
      const int k0 = (t_first + i) * kTcKeys;
      mbar_wait(full_bar + 8 * s, (i / kTcStages) & 1);
      const bool live = r_lo <= r_hi && k0 < a.seq_k &&
                        !(a.causal && k0 > r_hi) &&
                        !(a.window > 0 && r_lo - (k0 + kTcKeys - 1) >= a.window);
      if (live) {
        // S = Q K^T, 64 x 64 float32
        float sc[32];
        const uint32_t kt = k_tile + s * kKBytes;
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          const uint32_t reg = (kk * 32) / SW;        // 64-column region
          const uint32_t in = (kk * 32) % SW;         // bytes inside the row
          wg::ss_n64(sc,
                     desc<W>(q_rows + reg * kTcRows * SW + in, 16, 8 * SW),
                     desc<W>(kt + reg * kTcKeys * SW + in, 16, 8 * SW),
                     kk > 0);
        }
        wg::commit();
        wg::wait_all();
        wg::fence_regs(sc);

        // masks (none inside a tile live for every row of the warpgroup)
        // and the online softmax, in log2 units
        const bool all_live = k0 + kTcKeys <= a.seq_k &&
                              (!a.causal || k0 + kTcKeys - 1 <= r_lo) &&
                              (a.window == 0 || r_lo + 63 - k0 < a.window);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          if (all_live) {
            sc[j] *= a.scale_log2;
          } else {
            const int key = k0 + 8 * (j / 4) + col_l + (j & 1);
            const int row = row0 + ((j & 2) ? 8 : 0);
            bool ok = key < a.seq_k;
            if (a.causal) ok = ok && key <= row;
            if (a.window > 0) ok = ok && row - key < a.window;
            sc[j] = ok ? sc[j] * a.scale_log2 : kNegInf;
          }
          mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
          alpha[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
        uint32_t pa[4][4];
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          const int r = (j >> 1) & 1;
          const float p0 = exp2f(sc[j] - m[r]);
          const float p1 = exp2f(sc[j + 1] - m[r]);
          l[r] += p0 + p1;
          // key group j / 4 = 2 kk + hi; A fragment register 2 hi + r
          pa[j / 8][((j / 4) & 1) * 2 + r] = pack_bf16(p0, p1);
        }
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
          o[4 * n + 0] *= alpha[0];
          o[4 * n + 1] *= alpha[0];
          o[4 * n + 2] *= alpha[1];
          o[4 * n + 3] *= alpha[1];
        }

        // O += P V: V [64 keys][W] N-major; 16 keys a step
        const uint32_t vt = v_tile + s * kKBytes;
        wg::fence_regs(o);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < kTcKeys / 16; ++kk)
          wg::rs<W>(o, pa[kk], desc<W>(vt + kk * 16 * SW, kTcKeys * SW,
                                       8 * SW));
        wg::commit();
        wg::wait_all();
        wg::fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);
    }

    // l over the four lanes of a row, then o / max(l, 1e-30)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      l[r] = 1.0f / fmaxf(l[r], 1e-30f);
    }
    const int64_t o_stride = static_cast<int64_t>(a.n_heads) * a.d;
    __nv_bfloat16* ob =
        a.o + (static_cast<int64_t>(bi) * a.seq_q * a.n_heads + h) * a.d;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= a.seq_q) continue;
#pragma unroll
      for (int n = 0; n < W / 8; ++n) {
        const int col = 8 * n + col_l;
        if (col < a.d)
          *reinterpret_cast<__nv_bfloat162*>(ob + row * o_stride + col) =
              __floats2bfloat162_rn(o[4 * n + 2 * r] * l[r],
                                    o[4 * n + 2 * r + 1] * l[r]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 [batch, seq, heads, d] tensor: boxes
// of (sw / 2 columns, 1 head, rows, 1 batch), swizzled as wgmma reads
// them, out-of-range elements filled with zeros.
bool encode(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
            int d, int rows, int sw) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(heads) * d * 2,
                                 static_cast<cuuint64_t>(seq) * heads * d * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(sw / 2), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int W>
int launch_tc_w(const void* q, const void* k, const void* v, void* o, int B,
                int seq_q, int seq_k, int n_heads, int n_kv, int d,
                int causal, int window, float scale, int use_tma,
                cudaStream_t stream) {
  constexpr int SW = Layout<W>::SW;
  CUtensorMap tq = {}, tk = {}, tv = {};
  if (use_tma && !(encode(&tq, q, B, seq_q, n_heads, d, kTcRows, SW) &&
                   encode(&tk, k, B, seq_k, n_kv, d, kTcKeys, SW) &&
                   encode(&tv, v, B, seq_k, n_kv, d, kTcKeys, SW)))
    return static_cast<int>(cudaErrorInvalidValue);
  const TcArgs args = {static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(k),
                       static_cast<const __nv_bfloat16*>(v),
                       static_cast<__nv_bfloat16*>(o),
                       seq_q, seq_k, n_heads, n_kv, d, n_heads / n_kv,
                       causal, window, use_tma, scale * kLog2e};
  const size_t smem = 1024 + static_cast<size_t>(kTcRows) * W * 2 +
                      2 * kTcStages * static_cast<size_t>(kTcKeys) * W * 2 +
                      8 * (1 + 2 * kTcStages);
  auto kern = flash_tc_kernel<W>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_blocks =
      static_cast<int64_t>((seq_q + kTcRows - 1) / kTcRows) * n_heads;
  if (n_blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_blocks), B);
  kern<<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, args);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The tensor-core instance for head dim d: the least width of 16, 32, 64,
// 128, 256 at or above it.  Tiles come by TMA when every row stride is a
// multiple of 16 bytes (d a multiple of 8), the box (min(W, 64) columns)
// is no wider than the head (d >= 64 or d == W) and q, k, v are 16-byte
// aligned; otherwise by cp.async.
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int seq_q, int seq_k, int n_heads, int n_kv, int d, int causal,
              int window, float scale, cudaStream_t st) {
  const int width = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
                    : d <= 128 ? 128 : 256;
  const int use_tma = d % 8 == 0 && (d >= 64 || d == width) &&
                      aligned16(q) && aligned16(k) && aligned16(v);
  switch (width) {
    case 16:
      return launch_tc_w<16>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                             causal, window, scale, use_tma, st);
    case 32:
      return launch_tc_w<32>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                             causal, window, scale, use_tma, st);
    case 64:
      return launch_tc_w<64>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                             causal, window, scale, use_tma, st);
    case 128:
      return launch_tc_w<128>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                              causal, window, scale, use_tma, st);
  }
  return launch_tc_w<256>(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d,
                          causal, window, scale, use_tma, st);
}

}  // namespace

// Launches the kernel on `stream`, which must belong to the calling
// thread's current device; returns the cudaError_t of the launch (0 on
// success).  `bf16` nonzero means q, k, v and o are bfloat16 (the tensor-
// core kernel, see launch_tc for its width and load route), else float32.
// B >= 1, seq_q >= 1, seq_k >= 1, n_heads a multiple of n_kv, 4 <= d <=
// 256 with d a multiple of 4, window >= 0 (0: no window); every tensor
// contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B,
                                      int seq_q, int seq_k, int n_heads,
                                      int n_kv, int d, int causal,
                                      int window, float scale, int bf16,
                                      void* stream) {
  if (d < 4 || d > kMaxD || d % 4 != 0 || n_kv < 1 || n_heads % n_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch_f32(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d, causal,
                      window, scale, st);
  return launch_tc(q, k, v, o, B, seq_q, seq_k, n_heads, n_kv, d, causal,
                   window, scale, st);
}
