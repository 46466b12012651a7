// The RG-LRU diagonal linear recurrence h_t = a_t * h_{t-1} + b_t on
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/rg_lru_scan/kernel.py (reached through `lru_scan`).
// Same contract:
//
//   a, b    [B, T, W] float32   per-step decay and input
//   h0      [B, W]    float32   the carried state
//   h       [B, T, W] float32   every step's state
//   h_last  [B, W]    float32   the state after step T-1
//
// Each step is one multiply and one add, each rounded (no fused
// multiply-add), in time order, as the plain PyTorch version computes
// them, so the two agree bit for bit.  No chunked or associative scan:
// that would reassociate the sums.
//
// What bounds it: memory, and on this card the memory's latency.  Every
// element of a and b is read once and h written once, 12 bytes for 2
// operations: at prefill ([1, 3072, 2560], 94 MB) 0.028 ms at 3.35 TB/s.
// The recurrence is sequential in T, so the parallelism is B * W
// channels, 2,560 at prefill: one thread a channel in blocks of 128
// leaves most of the card idle, and a thread that loads a few steps ahead
// waits a memory round trip (about a microsecond) every few steps.
//
// Design.  Two kernels, chosen by the launcher from T, W and the
// addresses:
// * The ring (prefill: T > kSteps, W a multiple of 4 so rows are 16-byte
//   multiples, a and b 16-byte aligned).  One warp of 32 neighbouring
//   channels per block, so prefill spreads over 80 SMs (B * ceil(W / 32)
//   blocks).  Each block streams a and b through a ring in shared memory
//   of kStages stages of kSteps steps x 32 channels: one lane asks TMA for
//   a 2-D box of a and one of b per stage, completion on an `mbarrier`,
//   channels past W and steps past T read as zeros.  kStages - 1 stages
//   (80 KB) stay in flight while the warp consumes one, which covers the
//   round trip by Little's law (about 30 KB an SM at ~1 us for ~2.5 TB/s
//   over 80 SMs), and the warp issues no copy instructions.  It walks a
//   stage step by step out of shared memory, carrying h in a register and
//   storing each step's h as one coalesced 128-byte row.
// * The direct loop (decode, T = 1, where the kernel is bound by its
//   launch; short scans; widths or addresses TMA cannot take): one thread
//   a channel loads kUnroll steps of a and b ahead of the dependent chain,
//   straight from device memory.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time, so no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                // ring: channels per block
constexpr int kSteps = 64;                // ring: steps per stage
constexpr int kStages = 6;                // ring: stages
constexpr int kTile = kSteps * kLanes;    // floats of a (or b) a stage
constexpr int kThreads = 128;             // direct loop: channels per block
constexpr int kUnroll = 8;                // direct loop: steps loaded ahead

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity) : "memory");
}

// Stage s holds a [kSteps][kLanes] then b [kSteps][kLanes].
__global__ void __launch_bounds__(kLanes)
lru_ring_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const float* __restrict__ h0, float* __restrict__ h,
                float* __restrict__ h_last, int T, int W) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * kLanes;
  const int w = w0 + lane;
  const int64_t row = blockIdx.y;
  const int n_chunks = (T + kSteps - 1) / kSteps;

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(&full[s])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // lane 0 asks for the boxes of chunk c, if there is one
  auto issue = [&](int c) {
    if (lane != 0 || c >= n_chunks) return;
    float* sa = ring + (c % kStages) * 2 * kTile;
    const uint32_t bar = smem_u32(&full[c % kStages]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(bar), "r"(2 * kTile * 4) : "memory");
    const CUtensorMap* maps[2] = {&map_a, &map_b};
    for (int i = 0; i < 2; ++i)
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
              smem_u32(sa + i * kTile)),
          "l"(reinterpret_cast<uint64_t>(maps[i])), "r"(bar), "r"(w0),
          "r"(c * kSteps), "r"(static_cast<int>(row))
          : "memory");
  };

  for (int c = 0; c < kStages - 1; ++c) issue(c);
  float hv = w < W ? h0[row * W + w] : 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + kStages - 1);                // into the stage freed last time
    mbar_wait(smem_u32(&full[c % kStages]), (c / kStages) & 1);
    const float* sa = ring + (c % kStages) * 2 * kTile;
    const float* sb = sa + kTile;
    const int t0 = c * kSteps;
    const int nt = min(kSteps, T - t0);
    float* hp = h + (row * T + t0) * W + w;
    if (w < W) {
#pragma unroll 8
      for (int u = 0; u < nt; ++u) {
        hv = __fadd_rn(__fmul_rn(hv, sa[u * kLanes + lane]),
                       sb[u * kLanes + lane]);
        hp[static_cast<int64_t>(u) * W] = hv;
      }
    }
    __syncwarp();                          // the stage is free for reuse
  }
  if (w < W) h_last[row * W + w] = hv;
}

__global__ void __launch_bounds__(kThreads)
lru_direct_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int T, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int64_t row = static_cast<int64_t>(blockIdx.y);
  const int64_t base = row * T * W + w;
  float hv = h0[row * W + w];
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(t + u) * W;
      av[u] = a[i];
      bv[u] = b[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = __fadd_rn(__fmul_rn(hv, av[u]), bv[u]);
      h[base + static_cast<int64_t>(t + u) * W] = hv;
    }
  }
  for (; t < T; ++t) {
    const int64_t i = base + static_cast<int64_t>(t) * W;
    hv = __fadd_rn(__fmul_rn(hv, a[i]), b[i]);
    h[i] = hv;
  }
  h_last[row * W + w] = hv;
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
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a contiguous float32 [B, T, W] tensor, boxes of 32
// channels x kSteps steps x 1 row, out-of-range elements read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int B, int T, int W) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 4,
                                 static_cast<cuuint64_t>(T) * W * 4};
  const cuuint32_t box[3] = {kLanes, kSteps, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Launches the kernel on `stream`, which must belong to the calling
// thread's current device; returns the cudaError_t of the launch (0 on
// success).  B >= 1, T >= 1, 1 <= W; every tensor contiguous.  The ring,
// filled by TMA, takes T > kSteps with W a multiple of 4 and a, b 16-byte
// aligned; the direct loop takes the rest.
extern "C" int rg_lru_scan_launch(const void* a, const void* b,
                                  const void* h0, void* h, void* h_last,
                                  int B, int T, int W, void* stream) {
  const float* f0 = static_cast<const float*>(h0);
  float* fh = static_cast<float*>(h);
  float* fl = static_cast<float*>(h_last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= kSteps || W % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0) {
    const dim3 grid((W + kThreads - 1) / kThreads, B);
    lru_direct_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), f0, fh,
        fl, T, W);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap map_a, map_b;
  if (!encode(&map_a, a, B, T, W) || !encode(&map_b, b, B, T, W))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kStages * 2 * kTile * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      lru_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kLanes - 1) / kLanes, B);
  lru_ring_kernel<<<grid, kLanes, smem, st>>>(map_a, map_b, f0, fh, fl, T,
                                              W);
  return static_cast<int>(cudaGetLastError());
}
