// The k-means assign stage of the Angle chain (paper §5.3) on NVIDIA Hopper
// (sm_90a): nearest-centroid ids and distances, and the per-centroid
// partials (sums and counts) of one pass over the points.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/kmeans_assign/kernel.py (reached through
// `kmeans_assign_call`), and the one-hot partials that
// src/repro/kernels/kmeans_assign/ops.py (`kmeans_assign_partials`) builds
// around it, which XLA fuses on a TPU.  Two entries share one inner loop,
// `nearest`, so the partials kernel assigns every point exactly as the ids
// kernel does:
//
//   kmeans_assign_launch     x [n, d] float32 or bfloat16, c [k, d] float32
//                            -> ids [n] int32 (argmin_j d2, ties to the
//                               lowest j), d2 [n] float32 (the minimum)
//   kmeans_partials_launch   x, c and an optional bool valid [n]
//                            -> out [k, d + 1] float32: per centroid the sum
//                               of its valid points ++ their count
//
// with d2(x, c) = |x|^2 - 2 x.c + |c|^2 in float32, the TPU kernel's
// expansion (not sum (x - c)^2, which rounds differently).  |x|^2 and each
// x.c are fmaf chains over e = 0..d-1 and 2 x.c is exact, so every route
// below computes the same bits.
//
// What bounds it: memory.  At the Angle chain's shape (d = 8, k = 10) a
// point is 32 bytes for about 2 d (k + 1) = 176 float32 operations, some 5
// operations a byte, far below the card's 20 a byte of device memory.  No
// tensor cores: at k = 10, d = 8 a product tile would be mostly padding.
//
// Design.
// - Persistent grids: a few blocks an SM (as many as fit, never more than
//   the points need) walk the points grid-stride, so each block loads the
//   centroid table and |c|^2 into shared memory once; the points are read
//   by broadcast from there.
// - A point is held in registers.  At d = 8 and 16 (and d = 8 / 16 of
//   bfloat16) it comes in as 16-byte vector loads, neighbouring threads on
//   neighbouring points; other d <= 32 are loaded element by element; wider
//   points are re-read for each centroid (L1).  Vector loads stream the
//   points (evict-first): those routes read each once.  A partials thread
//   issues the loads of 2-4 points before it assigns them together, each
//   centroid read once for all of them.
// - The partials are deterministic: no float atomics.  Small tables (k (d +
//   1) x 256 floats fit in shared memory, d <= 32; the Angle chain's 90
//   cells are 92 KB, two blocks an SM) give each thread its own accumulator
//   column in shared memory (float4 sums at d = 8 / 16), adding its points
//   in a fixed order; at the end a warp per cell sums the block's 256
//   columns by a fixed shuffle tree into the block's row of `part [nb, k (d
//   + 1)]`.  Wider tables use one warp a block: each 32-point tile is
//   assigned, then lane l adds column e = l (mod 32) of the tile's points,
//   in order, into the block's row (in shared memory when it fits beside
//   the table, else straight in `part`).  A second, small kernel sums the
//   rows of `part` in a fixed order into `out`.
// - The ids kernel writes ids and d2 for every point; the partials kernel
//   writes only its k (d + 1) cells per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // ids kernel
constexpr int kPrivThreads = 256;   // partials, a column per thread
constexpr int kWarp = 32;           // partials of wide tables: a warp a block
constexpr int kReduceThreads = 256;  // the sum of the blocks' rows
constexpr int kRegDims = 32;        // widest point held in registers
constexpr int kMaxShared = 232448;  // bytes a block may opt in to (H100)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Width routes: DW > 0, exactly DW dimensions, loaded as 16-byte vectors
// (the launcher checks the alignment); DW == 0, d <= kRegDims held in
// registers, loaded one by one; DW == -1, any d, re-read for each centroid.
template <int DW>
struct Regs {
  static_assert(DW >= -1 && (DW <= 0 || DW % 4 == 0),
                "exact widths are whole float4s");
  static constexpr int n = DW > 0 ? DW : (DW == 0 ? kRegDims : 1);
};

template <typename T, int DW>
__device__ __forceinline__ void load_point(const T* __restrict__ xp, int d,
                                           float (&xr)[Regs<DW>::n]) {
  if constexpr (DW > 0) {
    constexpr int per = 16 / static_cast<int>(sizeof(T));
    static_assert(DW % per == 0, "vector route needs whole 16-byte loads");
    const uint4* v = reinterpret_cast<const uint4*>(xp);
#pragma unroll
    for (int q = 0; q < DW / per; ++q) {
      const uint4 w = __ldcs(v + q);  // streamed: read once, evict first
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(T) == 4) {
          xr[q * 4 + i] = __uint_as_float(u[i]);
        } else {  // two bfloat16, the lower address in the low half
          xr[q * 8 + 2 * i] = __uint_as_float(u[i] << 16);
          xr[q * 8 + 2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
        }
      }
    }
  } else if constexpr (DW == 0) {
#pragma unroll
    for (int e = 0; e < kRegDims; ++e) xr[e] = e < d ? to_f32(xp[e]) : 0.0f;
  }
}

// The nearest centroid of each of U points and its d2: the inner loop
// both entries share.  `sc` [kc, d] and `scc` [kc] are the block's shared
// copies; each centroid is read once for the U points.  Every point's sums
// are the same fmaf chains, in the same order, whatever U is.
template <typename T, int DW, int U>
__device__ __forceinline__ void nearest(const float (&xr)[U][Regs<DW>::n],
                                        const T* __restrict__ xp, int d,
                                        const float* sc, const float* scc,
                                        int kc, int (&arg)[U],
                                        float (&best)[U]) {
  constexpr int R = Regs<DW>::n;
  static_assert(DW != -1 || U == 1, "the re-read route takes one point");
  float xx[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    xx[u] = 0.0f;
    best[u] = 0.0f;
    arg[u] = 0;
    if constexpr (DW >= 0) {
#pragma unroll
      for (int e = 0; e < R; ++e) {
        if (DW > 0 || e < d) xx[u] = fmaf(xr[u][e], xr[u][e], xx[u]);
      }
    } else {
      for (int e = 0; e < d; ++e) {
        const float v = to_f32(xp[e]);
        xx[u] = fmaf(v, v, xx[u]);
      }
    }
  }
  for (int j = 0; j < kc; ++j) {
    float xc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) xc[u] = 0.0f;
    if constexpr (DW > 0) {
      const float4* c4 = reinterpret_cast<const float4*>(sc + j * DW);
#pragma unroll
      for (int q = 0; q < DW / 4; ++q) {
        const float4 cv = c4[q];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          xc[u] = fmaf(xr[u][4 * q], cv.x, xc[u]);
          xc[u] = fmaf(xr[u][4 * q + 1], cv.y, xc[u]);
          xc[u] = fmaf(xr[u][4 * q + 2], cv.z, xc[u]);
          xc[u] = fmaf(xr[u][4 * q + 3], cv.w, xc[u]);
        }
      }
    } else if constexpr (DW == 0) {
      const float* cj = sc + j * d;
#pragma unroll
      for (int e = 0; e < R; ++e) {
        if (e < d) {
          const float cv = cj[e];
#pragma unroll
          for (int u = 0; u < U; ++u) xc[u] = fmaf(xr[u][e], cv, xc[u]);
        }
      }
    } else {
      const float* cj = sc + j * d;
      for (int e = 0; e < d; ++e) xc[0] = fmaf(to_f32(xp[e]), cj[e], xc[0]);
    }
    const float cc = scc[j];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float dist = (xx[u] - 2.0f * xc[u]) + cc;
      if (j == 0 || dist < best[u]) {
        best[u] = dist;
        arg[u] = j;
      }
    }
  }
}

// The centroid table and |c|^2 into shared memory; ends in a barrier.
__device__ __forceinline__ void load_table(const float* __restrict__ c,
                                           int kc, int d, float* sc,
                                           float* scc) {
  for (int i = threadIdx.x; i < kc * d; i += blockDim.x) sc[i] = c[i];
  __syncthreads();
  for (int j = threadIdx.x; j < kc; j += blockDim.x) {
    float cc = 0.0f;
    for (int e = 0; e < d; ++e) cc = fmaf(sc[j * d + e], sc[j * d + e], cc);
    scc[j] = cc;
  }
  __syncthreads();
}

// Points a partials thread keeps in flight, their loads all issued before
// they are assigned together: 4 at d <= 8, else 2, one on the re-read
// route.  (The ids kernel, with four times the threads an SM, takes one:
// more was slower.)
template <int DW>
struct Unroll {
  static constexpr int n = DW == -1 ? 1 : (DW > 0 && DW <= 8 ? 4 : 2);
};

template <typename T, int DW>
__global__ void __launch_bounds__(kThreads)
assign_ids_kernel(const T* __restrict__ x, const float* __restrict__ c,
                  int32_t* __restrict__ ids_out, float* __restrict__ d2_out,
                  int n, int d, int kc) {
  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);  // [kc * d] centroids
  float* scc = sc + kc * d;                      // [kc] |c|^2
  load_table(c, kc, d, sc, scc);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    const T* xp = x + r * d;
    float xr[1][Regs<DW>::n];
    load_point<T, DW>(xp, d, xr[0]);
    int arg[1];
    float best[1];
    nearest<T, DW, 1>(xr, xp, d, sc, scc, kc, arg, best);
    ids_out[r] = arg[0];
    d2_out[r] = best[0];
  }
}

// Partials of a small table: a private accumulator column per thread in
// shared memory, thread-interleaved so that consecutive threads touch
// consecutive banks.  At DW = 8 / 16 the sums are float4s,
// sums[(id * DW / 4 + q) * kPrivThreads + tid], and the counts a region of
// their own, counts[id * kPrivThreads + tid]; otherwise every cell
// (id, e), e = d the count, is acc[(id * (d + 1) + e) * kPrivThreads + tid].
template <int DW>
__device__ __forceinline__ int acc_index(int cell, int t, int kc) {
  if constexpr (DW > 0) {
    const int j = cell / (DW + 1), e = cell % (DW + 1);
    return e < DW ? ((j * (DW / 4) + e / 4) * kPrivThreads + t) * 4 + e % 4
                  : kc * DW * kPrivThreads + j * kPrivThreads + t;
  } else {
    return cell * kPrivThreads + t;
  }
}

template <typename T, int DW>
__global__ void __launch_bounds__(kPrivThreads)
partials_private_kernel(const T* __restrict__ x, const float* __restrict__ c,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ part, int n, int d, int kc) {
  extern __shared__ float4 smem4[];
  constexpr int R = Regs<DW>::n;
  constexpr int U = Unroll<DW>::n;
  const int dd = DW > 0 ? DW : d;
  const int cells = kc * (dd + 1);
  float* acc = reinterpret_cast<float*>(smem4);  // [cells * kPrivThreads]
  float* sc = acc + cells * kPrivThreads;        // 16-byte aligned
  float* scc = sc + kc * dd;
  const int tid = threadIdx.x;
  for (int i = tid; i < cells * kPrivThreads; i += kPrivThreads) acc[i] = 0.0f;
  load_table(c, kc, dd, sc, scc);

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kPrivThreads;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * kPrivThreads + tid;
       r0 < n; r0 += U * stride) {
    float xr[U][R];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t r = r0 + u * stride;
      ok[u] = r < n;
      if (ok[u]) {
        load_point<T, DW>(x + r * dd, dd, xr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < R; ++e) xr[u][e] = 0.0f;
      }
    }
    if (valid != nullptr) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        ok[u] = ok[u] && valid[r0 + u * stride] != 0;
    }
    int ids[U];
    float best[U];
    nearest<T, DW, U>(xr, nullptr, dd, sc, scc, kc, ids, best);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const int id = ids[u];
      if constexpr (DW > 0) {
        float4* s4 = reinterpret_cast<float4*>(acc) +
                     id * (DW / 4) * kPrivThreads + tid;
#pragma unroll
        for (int q = 0; q < DW / 4; ++q) {
          float4 v = s4[q * kPrivThreads];
          v.x += xr[u][4 * q];
          v.y += xr[u][4 * q + 1];
          v.z += xr[u][4 * q + 2];
          v.w += xr[u][4 * q + 3];
          s4[q * kPrivThreads] = v;
        }
        acc[kc * DW * kPrivThreads + id * kPrivThreads + tid] += 1.0f;
      } else {
        float* a = acc + id * (dd + 1) * kPrivThreads + tid;
#pragma unroll
        for (int e = 0; e < R; ++e) {
          if (e < dd) a[e * kPrivThreads] += xr[u][e];
        }
        a[dd * kPrivThreads] += 1.0f;
      }
    }
  }
  __syncthreads();

  // a warp a cell: lane l sums columns l, l + 32, ... in order, then a
  // fixed butterfly over the lanes
  const int lane = tid % kWarp;
  for (int cell = tid / kWarp; cell < cells; cell += kPrivThreads / kWarp) {
    float s = 0.0f;
#pragma unroll
    for (int t = lane; t < kPrivThreads; t += kWarp)
      s += acc[acc_index<DW>(cell, t, kc)];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) part[static_cast<int64_t>(blockIdx.x) * cells + cell] = s;
  }
}

// Partials of a wide table: one warp a block.  Each lane assigns one point
// of a 32-point tile; then lane l adds column e = l (mod 32) of each of the
// tile's points, in order, into the block's row, so every cell has one
// writer.  SACC: the row lives in shared memory beside the table and is
// copied out at the end; else it is the block's row of `part`.
template <typename T, int DW, bool SACC>
__global__ void __launch_bounds__(kWarp)
partials_wide_kernel(const T* __restrict__ x, const float* __restrict__ c,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ part, int n, int d, int kc) {
  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);
  float* scc = sc + kc * d;
  const int cells = kc * (d + 1);
  const int lane = threadIdx.x;
  float* row = part + static_cast<int64_t>(blockIdx.x) * cells;
  float* acc = SACC ? scc + kc : row;
  for (int i = lane; i < cells; i += kWarp) acc[i] = 0.0f;
  load_table(c, kc, d, sc, scc);  // its barriers order the zeroing

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarp;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * kWarp; r0 < n;
       r0 += stride) {
    const int64_t r = r0 + lane;
    int id = -1;
    if (r < n && (valid == nullptr || valid[r] != 0)) {
      const T* xp = x + r * d;
      float xr[1][Regs<DW>::n];
      load_point<T, DW>(xp, d, xr[0]);
      int arg[1];
      float best[1];
      nearest<T, DW, 1>(xr, xp, d, sc, scc, kc, arg, best);
      id = arg[0];
    }
    for (int p = 0; p < kWarp; ++p) {
      const int idp = __shfl_sync(0xffffffffu, id, p);
      if (idp < 0) continue;
      const T* xp = x + (r0 + p) * d;
      float* a = acc + idp * (d + 1);
      for (int e = lane; e <= d; e += kWarp)
        a[e] += e < d ? to_f32(xp[e]) : 1.0f;
    }
  }
  if constexpr (SACC) {
    __syncwarp();
    for (int i = lane; i < cells; i += kWarp) row[i] = acc[i];
  }
}

// out[cell] = the sum of part[b, cell] over b = 0..nb-1: a warp a cell,
// lane l summing rows l, l + 32, ... in order, then a fixed butterfly.
__global__ void __launch_bounds__(kReduceThreads)
partials_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                       int nb, int cells) {
  const int cell = blockIdx.x * (kReduceThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (cell >= cells) return;  // whole warps leave together
  float s = 0.0f;
  for (int b = lane; b < nb; b += kWarp)
    s += part[static_cast<int64_t>(b) * cells + cell];
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[cell] = s;
}

template <typename K>
int set_shared(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Blocks of a persistent grid: as many as are resident on the card at
// once, and no more than `want`.
template <typename K>
int grid_for(K kern, int threads, size_t smem, int64_t want, int* nb) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t cap = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *nb = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
  return 0;
}

bool vector_ok(const void* x, int d, int elem) {
  return (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (d * elem) % 16 == 0;
}

template <typename T>
int launch_ids(const void* x, const void* c, void* ids, void* d2, int n,
               int d, int kc, int bn, cudaStream_t stream) {
  using Kern = void (*)(const T*, const float*, int32_t*, float*, int, int,
                        int);
  Kern kern = d > kRegDims ? assign_ids_kernel<T, -1>
                           : assign_ids_kernel<T, 0>;
  if (vector_ok(x, d, sizeof(T)) && d == 8) kern = assign_ids_kernel<T, 8>;
  if (vector_ok(x, d, sizeof(T)) && d == 16) kern = assign_ids_kernel<T, 16>;
  const size_t smem = sizeof(float) * static_cast<size_t>(kc) * (d + 1);
  int err = set_shared(kern, smem);
  int nb = 0;
  if (!err)
    err = grid_for(kern, kThreads, smem,
                   (static_cast<int64_t>(n) + bn - 1) / bn, &nb);
  if (err) return err;
  kern<<<nb, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<int32_t*>(ids), static_cast<float*>(d2), n, d, kc);
  return static_cast<int>(cudaGetLastError());
}

// The partials route: its kernel, block size and shared memory.
template <typename T>
struct PartialsRoute {
  using Kern = void (*)(const T*, const float*, const uint8_t*, float*, int,
                        int, int);
  Kern kern;
  int threads;
  size_t smem;
};

template <typename T>
PartialsRoute<T> partials_route(const void* x, int d, int kc) {
  const size_t table = sizeof(float) * static_cast<size_t>(kc) * (d + 1);
  const size_t cells = static_cast<size_t>(kc) * (d + 1);
  const size_t priv = table + sizeof(float) * cells * kPrivThreads;
  if (d <= kRegDims && priv <= static_cast<size_t>(kMaxShared)) {
    typename PartialsRoute<T>::Kern kern = partials_private_kernel<T, 0>;
    if (vector_ok(x, d, sizeof(T)) && d == 8)
      kern = partials_private_kernel<T, 8>;
    if (vector_ok(x, d, sizeof(T)) && d == 16)
      kern = partials_private_kernel<T, 16>;
    return {kern, kPrivThreads, priv};
  }
  const size_t shared_row = table + sizeof(float) * cells;
  if (shared_row <= static_cast<size_t>(kMaxShared)) {
    return {d > kRegDims ? partials_wide_kernel<T, -1, true>
                         : partials_wide_kernel<T, 0, true>,
            kWarp, shared_row};
  }
  return {d > kRegDims ? partials_wide_kernel<T, -1, false>
                       : partials_wide_kernel<T, 0, false>,
          kWarp, table};
}

template <typename T>
int plan_partials(const void* x, int n, int d, int kc, int* nb) {
  const PartialsRoute<T> route = partials_route<T>(x, d, kc);
  const int err = set_shared(route.kern, route.smem);
  if (err) return err;
  return grid_for(route.kern, route.threads, route.smem,
                  (static_cast<int64_t>(n) + route.threads - 1) /
                      route.threads,
                  nb);
}

template <typename T>
int launch_partials(const void* x, const void* c, const void* valid,
                    void* part, void* out, int n, int d, int kc, int nb,
                    cudaStream_t stream) {
  const PartialsRoute<T> route = partials_route<T>(x, d, kc);
  const int err = set_shared(route.kern, route.smem);
  if (err) return err;
  route.kern<<<nb, route.threads, route.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<const uint8_t*>(valid), static_cast<float*>(part), n, d,
      kc);
  cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  const int cells = kc * (d + 1);
  constexpr int per_block = kReduceThreads / kWarp;
  partials_reduce_kernel<<<(cells + per_block - 1) / per_block,
                           kReduceThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), nb, cells);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry returns a cudaError_t (0 on success) and launches on
// `stream`, which must belong to the calling thread's current device.
// `x_bf16` nonzero means x is bfloat16, else float32.  n >= 1, d >= 1,
// kc >= 1, and the table fits: 4 kc (d + 1) <= 232448 bytes.

// ids and d2 of every point; grid-stride over at most ceil(n / bn) blocks.
extern "C" int kmeans_assign_launch(const void* x, const void* c, void* ids,
                                    void* d2, int n, int d, int kc, int bn,
                                    int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_ids<__nv_bfloat16>(x, c, ids, d2, n, d, kc, bn, st)
                : launch_ids<float>(x, c, ids, d2, n, d, kc, bn, st);
}

// The number of blocks `kmeans_partials_launch` runs for these inputs:
// the rows of the scratch `part [nb, kc (d + 1)]` it needs.
extern "C" int kmeans_partials_blocks(const void* x, int n, int d, int kc,
                                      int x_bf16, int* nb) {
  return x_bf16 ? plan_partials<__nv_bfloat16>(x, n, d, kc, nb)
                : plan_partials<float>(x, n, d, kc, nb);
}

// out [kc, d + 1] float32 = per centroid the sum of its points ++ their
// count, over the points whose `valid` byte is nonzero (all of them when
// `valid` is null).  Two launches: the pass over the points, which writes
// one row of `part` per block, and the sum of those rows in block order.
extern "C" int kmeans_partials_launch(const void* x, const void* c,
                                      const void* valid, void* part,
                                      void* out, int n, int d, int kc,
                                      int nb, int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_partials<__nv_bfloat16>(x, c, valid, part, out, n,
                                                 d, kc, nb, st)
                : launch_partials<float>(x, c, valid, part, out, n, d, kc,
                                         nb, st);
}
