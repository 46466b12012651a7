// Bucket ids and one bucket histogram for the ids-visible partition pass
// of the Sphere shuffle (`partition_batch` / `shuffle_batch`), on NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/bucket_partition/kernel.py (reached through
// `bucket_partition_call`).  Same contract:
//
//   keys   [n, k]        int64, each word in [0, 2^32), compared as uint32
//   bounds [n_bounds, k] int64 boundary rows (any order)
//   ids    [n] int32     = #{j : bounds[j] < key}, NOT clamped
//   hist   [n_buckets] int32, the count of rows with each id below
//          n_buckets; a row whose id is n_buckets or more is counted in no
//          bin, as the TPU kernel's one-hot against iota(n_buckets) does
//
// The compare is compare.cuh's, shared with bucket_dest.cu.
//
// What bounds it: memory.  Per row it reads k key words and writes one
// 4-byte id; the compare is a few integer operations per boundary word.
// The words need 4 bytes each but arrive as int64 (the carriage both
// bucket kernels share), so it reads twice that.
//
// Design.  The TPU kernel accumulates its histogram across a grid that
// runs in order; Hopper's blocks run in any order.  Here each block of
// 256 threads walks `bn` rows with the boundary table in shared memory,
// counts its rows per bucket in shared memory (one atomic per warp and
// bucket: a warp match groups equal ids, its leader adds the group's
// size), and adds its counts into the global histogram with integer
// atomics, which give the same counts in any order.  The histogram is
// zeroed on the stream before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compare.cuh"

namespace {

constexpr int kThreads = 256;

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
bucket_partition_kernel(const int64_t* __restrict__ keys,
                        const int64_t* __restrict__ bounds,
                        int32_t* __restrict__ ids_out,
                        int32_t* __restrict__ hist,
                        int n, int k, int n_bounds, int n_buckets, int bn) {
  extern __shared__ uint32_t smem[];
  uint32_t* sb = smem;                                       // [n_bounds * k]
  int* counts = reinterpret_cast<int*>(smem + n_bounds * k);  // [n_buckets]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  bucket_compare::load_bounds(sb, bounds, n_bounds * k, tid, kThreads);
  for (int i = tid; i < n_buckets; i += kThreads) counts[i] = 0;
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * bn;
  const int64_t row_end = min(static_cast<int64_t>(n), row0 + bn);
  // every thread runs the same number of chunks, so the full-warp match
  // is reached by all of them
  for (int64_t base = row0; base < row_end; base += kThreads) {
    const int64_t r = base + tid;
    int id = -1;  // no row here: past the end of the block
    if (r < row_end) {
      uint32_t kw[KMAX];
      bucket_compare::load_key<KMAX>(keys + r * k, k, kw);
      id = bucket_compare::count_below<KMAX>(sb, n_bounds, k, kw);
      ids_out[r] = id;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    if (id >= 0 && id < n_buckets && lane == __ffs(peers) - 1) {
      atomicAdd(&counts[id], __popc(peers));
    }
  }
  __syncthreads();
  for (int i = tid; i < n_buckets; i += kThreads) {
    if (counts[i] != 0) atomicAdd(&hist[i], counts[i]);
  }
}

}  // namespace

// Zeroes `hist` and launches the kernel on `stream`, which must belong to
// the calling thread's current device; returns the cudaError_t of the
// launch (0 on success).  n >= 1, bn >= 1.
extern "C" int bucket_partition_launch(const void* keys, const void* bounds,
                                       void* ids, void* hist, int n, int k,
                                       int n_bounds, int n_buckets, int bn,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      hist, 0, sizeof(int32_t) * static_cast<size_t>(n_buckets), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = static_cast<int>((static_cast<int64_t>(n) + bn - 1) / bn);
  const size_t smem = sizeof(uint32_t)
      * (static_cast<size_t>(n_bounds) * k + static_cast<size_t>(n_buckets));
  void (*kern)(const int64_t*, const int64_t*, int32_t*, int32_t*,
               int, int, int, int, int) =
      k <= 4 ? bucket_partition_kernel<4> : bucket_partition_kernel<16>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<nb, kThreads, smem, st>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(bounds),
      static_cast<int32_t*>(ids), static_cast<int32_t*>(hist),
      n, k, n_bounds, n_buckets, bn);
  return static_cast<int>(cudaGetLastError());
}
