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
// multiply-add), as the plain PyTorch version computes them, so the two
// agree bit for bit.
//
// What bounds it: memory.  Every element of a and b is read once and h
// written once, 12 bytes for 2 operations.  The recurrence is sequential
// in T, so the parallelism is B * W: one thread owns one (b, channel) and
// walks the time axis, carrying h in a register (the TPU kernel carried
// it in VMEM scratch along an in-order grid).  Neighbouring threads own
// neighbouring channels, so each step's loads and stores coalesce; a and
// b do not depend on h, so kUnroll steps of them are loaded before the
// dependent chain runs.  At prefill, B = 1 and W = 2560 give 2,560
// threads, far too few to fill the card's 132 SMs: the kernel is
// latency-bound there (a chunked two-pass scan would cure it).  At decode
// (T = 1) it is bound by its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
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

}  // namespace

// Launches the kernel on `stream`, which must belong to the calling
// thread's current device; returns the cudaError_t of the launch (0 on
// success).  B >= 1, T >= 1, 1 <= W; every tensor contiguous.
extern "C" int rg_lru_scan_launch(const void* a, const void* b,
                                  const void* h0, void* h, void* h_last,
                                  int B, int T, int W, void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  lru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), T, W);
  return static_cast<int>(cudaGetLastError());
}
