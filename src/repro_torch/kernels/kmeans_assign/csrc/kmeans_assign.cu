// Nearest-centroid ids and squared distances for the k-means assign stage
// of the Angle chain (paper §5.3), on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/kmeans_assign/kernel.py (reached through
// `kmeans_assign_call`).  Same contract:
//
//   x    [n, d]  float32 or bfloat16 points
//   c    [k, d]  float32 centroids (the wrapper widens bfloat16 ones)
//   ids  [n] int32   argmin_j d2(x, c_j), ties to the lowest j
//   d2   [n] float32 min_j d2(x, c_j)
//
// with d2(x, c) = |x|^2 - 2 x.c + |c|^2 computed in float32, the TPU
// kernel's expansion (not sum (x - c)^2, which rounds differently).
//
// What bounds it: memory.  At the Angle chain's shape (d = 8, k = 10) a
// point is 32 bytes in and 8 bytes out for about 2 k d = 160 float32
// operations, some 4 operations a byte, far below the card's ~20 float32
// operations a byte of memory traffic.  No tensor cores: at this depth they
// would not help.
//
// Design.  The TPU kernel pins the centroid table in VMEM while point
// tiles stream through.  Here each block loads the table and |c|^2 into
// shared memory once and walks `bn` points, one point per thread at a
// time: the thread holds its point in registers (up to kRegDims
// dimensions; wider points are re-read from L1 for each centroid),
// accumulates |x|^2 and each x.c with float32 FMAs, and keeps a running
// minimum and its index with a strict compare, so the lowest index wins a
// tie.  Blocks are independent; nothing is carried from one to the next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegDims = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// DREG > 0: the point is held in DREG registers (d <= DREG);
// DREG == 0: any d, the point re-read for each centroid.
template <typename T, int DREG>
__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const T* __restrict__ x, const float* __restrict__ c,
                     int32_t* __restrict__ ids_out,
                     float* __restrict__ d2_out,
                     int n, int d, int kc, int bn) {
  extern __shared__ float smem[];
  float* sc = smem;              // [kc * d] centroids
  float* scc = smem + kc * d;    // [kc] |c|^2

  const int tid = threadIdx.x;
  for (int i = tid; i < kc * d; i += kThreads) sc[i] = c[i];
  __syncthreads();
  for (int j = tid; j < kc; j += kThreads) {
    float cc = 0.0f;
    for (int e = 0; e < d; ++e) cc = fmaf(sc[j * d + e], sc[j * d + e], cc);
    scc[j] = cc;
  }
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * bn;
  const int64_t row_end = min(static_cast<int64_t>(n), row0 + bn);
  for (int64_t r = row0 + tid; r < row_end; r += kThreads) {
    const T* xp = x + r * d;
    float xr[DREG > 0 ? DREG : 1];
    float xx = 0.0f;
    if constexpr (DREG > 0) {
#pragma unroll
      for (int e = 0; e < DREG; ++e) {
        xr[e] = e < d ? to_f32(xp[e]) : 0.0f;
        xx = fmaf(xr[e], xr[e], xx);
      }
    } else {
      for (int e = 0; e < d; ++e) {
        const float v = to_f32(xp[e]);
        xx = fmaf(v, v, xx);
      }
    }
    float best = 0.0f;
    int arg = 0;
    for (int j = 0; j < kc; ++j) {
      const float* cj = sc + j * d;
      float xc = 0.0f;
      if constexpr (DREG > 0) {
#pragma unroll
        for (int e = 0; e < DREG; ++e) {
          if (e < d) xc = fmaf(xr[e], cj[e], xc);
        }
      } else {
        for (int e = 0; e < d; ++e) xc = fmaf(to_f32(xp[e]), cj[e], xc);
      }
      const float dist = (xx - 2.0f * xc) + scc[j];
      if (j == 0 || dist < best) {
        best = dist;
        arg = j;
      }
    }
    ids_out[r] = arg;
    d2_out[r] = best;
  }
}

template <typename T>
int launch(const void* x, const void* c, void* ids, void* d2, int n, int d,
           int kc, int bn, cudaStream_t stream) {
  void (*kern)(const T*, const float*, int32_t*, float*, int, int, int,
               int) = d <= kRegDims ? kmeans_assign_kernel<T, kRegDims>
                                    : kmeans_assign_kernel<T, 0>;
  const size_t smem = sizeof(float) * static_cast<size_t>(kc) * (d + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nb = static_cast<int>((static_cast<int64_t>(n) + bn - 1) / bn);
  kern<<<nb, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<int32_t*>(ids), static_cast<float*>(d2), n, d, kc, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`, which must belong to the calling
// thread's current device; returns the cudaError_t of the launch (0 on
// success).  `x_bf16` nonzero means x is bfloat16, else float32.
// n >= 1, d >= 1, kc >= 1, bn >= 1.
extern "C" int kmeans_assign_launch(const void* x, const void* c, void* ids,
                                    void* d2, int n, int d, int kc, int bn,
                                    int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, c, ids, d2, n, d, kc, bn, st)
                : launch<float>(x, c, ids, d2, n, d, kc, bn, st);
}
