// The comparison contract of the bucket kernels, shared by bucket_dest.cu
// and bucket_partition.cu so the two cannot drift apart.
//
// Keys and boundaries are rows of k big-endian 32-bit words, carried as
// int64 holding values in [0, 2^32), compared lexicographically as uint32.
// A row's bucket is the strict count #{j : bounds[j] < key}; the count
// does not rely on the boundary rows being sorted.
#pragma once

#include <stdint.h>

namespace bucket_compare {

// Copies the [n_bounds, k] int64 boundary rows into shared memory as
// uint32 words, with all `n_threads` threads of the block taking part.
// The caller synchronises before reading them.
__device__ __forceinline__ void load_bounds(uint32_t* sb,
                                            const int64_t* __restrict__ bounds,
                                            int n_words, int tid,
                                            int n_threads) {
  for (int i = tid; i < n_words; i += n_threads) {
    sb[i] = static_cast<uint32_t>(bounds[i]);
  }
}

// The k words of one key row, zero beyond k.
template <int KMAX>
__device__ __forceinline__ void load_key(const int64_t* __restrict__ kp,
                                         int k, uint32_t (&kw)[KMAX]) {
#pragma unroll
  for (int w = 0; w < KMAX; ++w) {
    kw[w] = w < k ? static_cast<uint32_t>(kp[w]) : 0u;
  }
}

// #{j : sb[j] < kw}, lexicographic over k words.
template <int KMAX>
__device__ __forceinline__ int count_below(const uint32_t* sb, int n_bounds,
                                           int k, const uint32_t (&kw)[KMAX]) {
  int below = 0;
  for (int j = 0; j < n_bounds; ++j) {
    const uint32_t* b = sb + j * k;
    // walking the words from last to first, the first differing word
    // overwrites the verdict
    int lt = 0;
#pragma unroll
    for (int w = KMAX - 1; w >= 0; --w) {
      if (w < k && b[w] != kw[w]) lt = b[w] < kw[w];
    }
    below += lt;
  }
  return below;
}

}  // namespace bucket_compare
