// Bucket ids, intra-block stable ranks and per-block histograms for the
// stable counting scatter of the Sphere shuffle, on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_scatter_kernel` of
// src/repro/kernels/bucket_partition/kernel.py (reached through
// `bucket_dest_call` / `bucket_scatter_call`).  Same contract, stacked over
// a leading slot axis so one launch serves a whole shuffle round:
//
//   keys   [s, n, k]  int64, each word in [0, 2^32), compared as uint32
//   bounds [n_bounds, k] int64 boundary rows (any order: the count below
//          does not rely on sorted bounds)
//   valid  either n_valid [s] int32 (rows < n_valid[slot] are real) or
//          mask [s, n] int32 (nonzero = real)
//   ids    [s, n] int32  = min(#{j : bounds[j] < key}, n_out - 1), or the
//          trash bucket n_out for rows that are not real
//   rank   [s, n] int32  = rows before this one in the same block of bn
//          rows with the same id
//   bhist  [s, nb, n_out + 1] int32, this block's count per bucket
//
// The epilogue that turns (ids, rank, bhist) into destinations stays in
// plain torch, as the JAX package leaves it to XLA.
//
// What bounds it: memory.  Per real row the kernel reads k key words and
// per row it writes 8 bytes of ids and rank; the compare is a few integer
// operations per boundary word.  The words need 4 bytes each (12 for
// 10-byte TeraSort keys) but arrive as int64, so the kernel reads twice
// that; rows that are not real read no key at all.  The words come from
// plain torch outside the kernel, as in the JAX package; reading the ~10
// key bytes straight from the 100-byte rows (one 32-byte sector a row)
// would move less, and is left with the row move for a fused version.
// The design is simple on purpose: a grid of (row blocks, slots), the
// boundary table in shared memory, a linear scan over it per row, and the
// stable rank from a walk over the block's rows in chunks of the thread
// count — a warp match gives the rank among equal ids inside a warp, a
// count per (warp, bucket) in shared memory gives the rank across the
// warps of a chunk, and a running count per bucket carries it from chunk
// to chunk.  Blocks are independent: the TPU kernel relied on its grid
// running in order, this one does not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
bucket_dest_kernel(const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ bounds,
                   const int32_t* __restrict__ n_valid,
                   const int32_t* __restrict__ mask,
                   int32_t* __restrict__ ids_out,
                   int32_t* __restrict__ rank_out,
                   int32_t* __restrict__ bhist,
                   int n, int k, int n_bounds, int n_out, int bn) {
  extern __shared__ uint32_t smem[];
  const int n_cols = n_out + 1;
  uint32_t* sb = smem;                                      // [n_bounds * k]
  int* run = reinterpret_cast<int*>(smem + n_bounds * k);   // [n_cols]
  int* wcnt = run + n_cols;                                 // [kWarps * n_cols]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = blockIdx.y;

  for (int i = tid; i < n_bounds * k; i += kThreads) {
    sb[i] = static_cast<uint32_t>(bounds[i]);
  }
  for (int i = tid; i < n_cols * (kWarps + 1); i += kThreads) {
    run[i] = 0;  // run and wcnt are contiguous
  }
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * bn;
  const int64_t row_end = min(static_cast<int64_t>(n), row0 + bn);
  const int64_t slot_base = static_cast<int64_t>(slot) * n;
  const int limit = n_valid != nullptr ? n_valid[slot] : 0;
  const unsigned lower_lanes = (1u << lane) - 1u;

  // every thread runs the same number of chunks, so the barriers and the
  // full-warp match below are reached by all of them
  for (int64_t base = row0; base < row_end; base += kThreads) {
    const int64_t r = base + tid;
    int id = -1;  // no row here: past the end of the block
    if (r < row_end) {
      const bool real = mask != nullptr ? mask[slot_base + r] != 0
                                        : r < limit;
      id = n_out;  // the trash bucket, unless the row is real
      if (real) {
        const int64_t* kp = keys + (slot_base + r) * k;
        uint32_t kw[KMAX];
#pragma unroll
        for (int w = 0; w < KMAX; ++w) {
          kw[w] = w < k ? static_cast<uint32_t>(kp[w]) : 0u;
        }
        int below = 0;
        for (int j = 0; j < n_bounds; ++j) {
          const uint32_t* b = sb + j * k;
          // strict lexicographic bounds[j] < key: walking the words from
          // last to first, the first differing word overwrites the verdict
          int lt = 0;
#pragma unroll
          for (int w = KMAX - 1; w >= 0; --w) {
            if (w < k && b[w] != kw[w]) lt = b[w] < kw[w];
          }
          below += lt;
        }
        id = min(below, n_out - 1);
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    const bool leader = lane == __ffs(peers) - 1;
    if (id >= 0 && leader) wcnt[warp * n_cols + id] = __popc(peers);
    __syncthreads();
    if (id >= 0) {
      int rank = run[id] + __popc(peers & lower_lanes);
      for (int w = 0; w < warp; ++w) rank += wcnt[w * n_cols + id];
      ids_out[slot_base + r] = id;
      rank_out[slot_base + r] = rank;
    }
    __syncthreads();
    if (id >= 0 && leader) {
      atomicAdd(&run[id], __popc(peers));
      wcnt[warp * n_cols + id] = 0;
    }
    __syncthreads();
  }

  int32_t* hrow = bhist + (static_cast<int64_t>(slot) * gridDim.x
                           + blockIdx.x) * n_cols;
  for (int i = tid; i < n_cols; i += kThreads) hrow[i] = run[i];
}

}  // namespace

// Launches the kernel on `stream`, which must belong to the calling
// thread's current device (the caller sets it; this function leaves it as
// it found it); returns the cudaError_t of the launch (0 on success).
// Exactly one of n_valid and mask is non-null.
extern "C" int bucket_dest_launch(const void* keys, const void* bounds,
                                  const void* n_valid, const void* mask,
                                  void* ids, void* rank, void* bhist,
                                  int s, int n, int k, int n_bounds,
                                  int n_out, int bn, void* stream) {
  cudaError_t err = cudaSuccess;
  const int nb = (n + bn - 1) / bn;
  const size_t smem = sizeof(uint32_t)
      * (static_cast<size_t>(n_bounds) * k
         + static_cast<size_t>(n_out + 1) * (kWarps + 1));
  void (*kern)(const int64_t*, const int64_t*, const int32_t*,
               const int32_t*, int32_t*, int32_t*, int32_t*,
               int, int, int, int, int) =
      k <= 4 ? bucket_dest_kernel<4> : bucket_dest_kernel<16>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(nb, s), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(bounds),
      static_cast<const int32_t*>(n_valid), static_cast<const int32_t*>(mask),
      static_cast<int32_t*>(ids), static_cast<int32_t*>(rank),
      static_cast<int32_t*>(bhist), n, k, n_bounds, n_out, bn);
  return static_cast<int>(cudaGetLastError());
}
