// Bucket ids and one bucket histogram for the ids-visible partition pass
// of the Sphere shuffle (`partition_batch` / `shuffle_batch`), on NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/bucket_partition/kernel.py (reached through
// `bucket_partition_call`), together with the key extraction that XLA
// fuses in front of it inside the JAX package's jit
// (src/repro/core/shuffle.py `_extract_keys`).  Two entries share one
// kernel body and differ only in where a row's key words come from:
//
//   bucket_partition_launch       keys [n, k] int64 words in [0, 2^32)
//                                 (the TPU kernel's own contract)
//   bucket_partition_rows_launch  data [n, width] uint8 records and a
//                                 static key spec; the words are built in
//                                 registers, as records.py builds them:
//       range: n_key_words big-endian words over the first kb bytes
//              (zero-padded), then an optional constant length word;
//       hash:  one word, FNV-1a 32-bit over the first kb bytes.
//
//   bounds [n_bounds, k] int64 boundary rows (any order)
//   ids    [n] int32     = #{j : bounds[j] < key}, NOT clamped
//   hist   [n_buckets] int32, the count of rows with each id below
//          n_buckets; a row whose id is n_buckets or more is counted in no
//          bin, as the TPU kernel's one-hot against iota(n_buckets) does
//
// The compare is compare.cuh's, shared with bucket_dest.cu.
//
// What bounds it: memory, and at 100-byte records the granularity of the
// memory's accesses.  The rows entry needs a record's kb key bytes and
// writes a 4-byte id: 14 bytes a TeraSort row, the bound.  But device
// memory moves whole 64-byte atoms, and the 10 key bytes of a 100-byte
// record lie in one or two of them (1.125 on average; one or two 32-byte
// sectors, 1.25, on the L2's side), so the card must move about 76 bytes
// a row: the atom floor, 0.227 ms at 10M TeraSort rows and 3.35 TB/s.
// In the probe calls the rows entry's time followed the atoms its keys
// touch (an 8-byte hash key, 1.0625 atoms a row, took 0.947 of a 10-byte
// range key's time, as 72 against 76 bytes a row predicts), and not the
// L2 fetch granularity hint (32, 64 or 128 bytes gave the same time).  The words entry reads k int64 words a
// row (twice the 32-bit words), and the partition path no longer takes
// it: the words it needs were built from the records by a chain of plain
// torch ops in front of it.
//
// Design.  TMA cannot tile 100-byte rows (its global strides are
// multiples of 16 bytes), so each thread loads its rows' key bytes
// itself: 4-byte loads when the data pointer and the width are 4-aligned
// (a row then holds whole words), byte loads otherwise.  A persistent
// grid, sized from the card's occupancy, walks the rows kThreads at a
// time, one row a thread; a hash key's words are loaded four at a time
// before they are hashed.  The
// boundary table sits in shared memory; each block counts its rows per
// bucket in shared memory (one atomic per warp and bucket: a warp match
// groups equal ids, its leader adds the group's size) and adds its counts
// into the global histogram once, with integer atomics, which give the
// same counts in any order.  The histogram is zeroed on the stream before
// the launch.  The TPU kernel accumulated its histogram across a grid
// that ran in order; Hopper's blocks run in any order, which the atomics
// absorb.
//
// Launch shape, chosen in probe calls on one H100 80GB HBM3 at 700 W
// (scripts/probe_bucket_rows.py patches the thread count and the load
// width into copies of this source and times them): 1024 threads a
// block, one row a thread, 4-byte loads where aligned.  At the path's
// shape 1024 threads were the fastest in every run of the probe, by
// 0.2-1.3% over 128-512 threads on the rows entry and 0.6-1.6% on the
// words entry; byte loads were 6% slower on the range key.  Keeping 2, 4
// or 8 rows a thread in flight was tried and was no faster.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compare.cuh"

namespace {

constexpr int kThreads = 1024;  // threads a block

// Key words of int64 rows [n, k].
struct WordRows {
  const int64_t* keys;
  int k;

  template <int KMAX>
  __device__ __forceinline__ void operator()(int64_t r,
                                             uint32_t (&kw)[KMAX]) const {
    bucket_compare::load_key<KMAX>(keys + r * k, k, kw);
  }
};

// Key words of uint8 records [n, width], built as the key spec says.
template <bool kVec, bool kHash>
struct RecordRows {
  const uint8_t* data;
  int64_t width;
  int kb;       // key bytes read from a record
  int nbw;      // words holding them, ceil(kb / 4)
  int nkw;      // range: key words before the length word, >= nbw
  uint32_t len; // range: the length word, at index nkw when k > nkw

  template <int KMAX>
  __device__ __forceinline__ void operator()(int64_t r,
                                             uint32_t (&kw)[KMAX]) const {
    using namespace bucket_compare;
    const uint8_t* row = data + r * width;
    if (kHash) {
      uint32_t h = kFnvOffset;
      // four words at a time: their loads are in flight together
      for (int w0 = 0; w0 < nbw; w0 += 4) {
        uint32_t x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = w0 + i < nbw ? raw_word<kVec>(row, w0 + i, kb) : 0u;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) h = fnv_word(h, x[i], w0 + i, kb);
      }
#pragma unroll
      for (int w = 0; w < KMAX; ++w) kw[w] = w == 0 ? h : 0u;
    } else {
#pragma unroll
      for (int w = 0; w < KMAX; ++w) {
        kw[w] = w < nbw ? be_word(raw_word<kVec>(row, w, kb), w, kb)
                        : (w < nkw ? 0u : len);
      }
    }
  }
};

template <int KMAX, typename Rows>
__global__ void __launch_bounds__(kThreads)
bucket_partition_kernel(Rows rows, int k, const int64_t* __restrict__ bounds,
                        int32_t* __restrict__ ids_out,
                        int32_t* __restrict__ hist, int n, int n_bounds,
                        int n_buckets) {
  extern __shared__ uint32_t smem[];
  uint32_t* sb = smem;                                       // [n_bounds * k]
  int* counts = reinterpret_cast<int*>(smem + n_bounds * k);  // [n_buckets]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  bucket_compare::load_bounds(sb, bounds, n_bounds * k, tid, kThreads);
  for (int i = tid; i < n_buckets; i += kThreads) counts[i] = 0;
  __syncthreads();

  // every thread of a block runs the same rounds, so the full-warp match
  // is reached by all of them
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n;
       base += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t r = base + tid;
    int id = -1;  // no row here: past the end
    if (r < n) {
      uint32_t kw[KMAX];
      rows(r, kw);
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

// Zeroes `hist`, sizes a persistent grid (as many blocks as are resident
// on the card at once, no more than ceil(n / kThreads), and no more than
// `max_blocks` when it is positive) and launches `kern` on `st`.
template <int KMAX, typename Rows>
int launch(Rows rows, int k, const void* bounds, void* ids, void* hist, int n,
           int n_bounds, int n_buckets, int max_blocks, cudaStream_t st) {
  auto kern = bucket_partition_kernel<KMAX, Rows>;
  cudaError_t err = cudaMemsetAsync(
      hist, 0, sizeof(int32_t) * static_cast<size_t>(n_buckets), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t)
      * (static_cast<size_t>(n_bounds) * k + static_cast<size_t>(n_buckets));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rounds = (static_cast<int64_t>(n) + kThreads - 1) / kThreads;
  int64_t nb = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (rounds < nb) nb = rounds;
  if (max_blocks > 0 && max_blocks < nb) nb = max_blocks;
  kern<<<static_cast<int>(nb), kThreads, smem, st>>>(
      rows, k, static_cast<const int64_t*>(bounds),
      static_cast<int32_t*>(ids), static_cast<int32_t*>(hist), n, n_bounds,
      n_buckets);
  return static_cast<int>(cudaGetLastError());
}

// launch() with the word count of the key rows rounded up to 4 or 16.
template <typename Rows>
int launch_k(Rows rows, int k, const void* bounds, void* ids, void* hist,
             int n, int n_bounds, int n_buckets, int max_blocks,
             cudaStream_t st) {
  return k <= 4 ? launch<4>(rows, k, bounds, ids, hist, n, n_bounds,
                            n_buckets, max_blocks, st)
                : launch<16>(rows, k, bounds, ids, hist, n, n_bounds,
                             n_buckets, max_blocks, st);
}

template <bool kVec>
int launch_spec(const uint8_t* data, int width, int hash, int kb, int nkw,
                int k, uint32_t len, const void* bounds, void* ids,
                void* hist, int n, int n_bounds, int n_buckets,
                int max_blocks, cudaStream_t st) {
  const int nbw = (kb + 3) / 4;
  if (hash) {
    RecordRows<kVec, true> rows{data, width, kb, nbw, 1, 0u};
    return launch<1>(rows, 1, bounds, ids, hist, n, n_bounds, n_buckets,
                     max_blocks, st);
  }
  RecordRows<kVec, false> rows{data, width, kb, nbw, nkw, len};
  return launch_k(rows, k, bounds, ids, hist, n, n_bounds, n_buckets,
                  max_blocks, st);
}

}  // namespace

// The words entry: ids and histogram of keys [n, k] int64.  Zeroes `hist`
// and launches on `stream`, which must belong to the calling thread's
// current device; at most `max_blocks` blocks when it is positive.
// Returns the cudaError_t of the launch (0 on success).  n >= 1,
// 1 <= k <= 16.
extern "C" int bucket_partition_launch(const void* keys, const void* bounds,
                                       void* ids, void* hist, int n, int k,
                                       int n_bounds, int n_buckets,
                                       int max_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WordRows rows{static_cast<const int64_t*>(keys), k};
  return launch_k(rows, k, bounds, ids, hist, n, n_bounds, n_buckets,
                  max_blocks, st);
}

// The rows entry: ids and histogram of records data [n, width] uint8 under
// a key spec.  hash != 0: FNV-1a over the first kb bytes (k = 1); else
// range: nkw big-endian words over the first kb bytes, zero-padded
// (nkw >= ceil(kb / 4), nkw >= 1), and when k = nkw + 1 a last word
// `len_word`.  kb <= width.  As the words entry otherwise; k <= 16.
extern "C" int bucket_partition_rows_launch(
    const void* data, int width, int hash, int kb, int nkw, int k,
    int len_word, const void* bounds, void* ids, void* hist, int n,
    int n_bounds, int n_buckets, int max_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  const uint32_t len = static_cast<uint32_t>(len_word);
  if (reinterpret_cast<uintptr_t>(data) % 4 == 0 && width % 4 == 0) {
    return launch_spec<true>(d, width, hash, kb, nkw, k, len, bounds, ids,
                             hist, n, n_bounds, n_buckets, max_blocks, st);
  }
  return launch_spec<false>(d, width, hash, kb, nkw, k, len, bounds, ids,
                            hist, n, n_bounds, n_buckets, max_blocks, st);
}
