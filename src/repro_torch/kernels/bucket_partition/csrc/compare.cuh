// The comparison contract of the bucket kernels, shared by bucket_dest.cu
// and bucket_partition.cu so the two cannot drift apart.
//
// Keys and boundaries are rows of k big-endian 32-bit words, compared
// lexicographically as uint32.  Boundaries, and the keys of the words
// entries, are carried as int64 holding values in [0, 2^32); the rows
// entry builds each key's words in registers from the record bytes.
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

// ---- key words straight from the record bytes (bucket_partition.cu's
// rows entry; the host side's twins are records.py `key_rows_of` and
// `hash_keys_of`).  A record is `row`, the first byte of a uint8 row; `kb`
// of its bytes form the key.

// Bytes [4w, 4w + 4) of a row as a little-endian word, bytes at or past
// `kb` zero.  kVec: one 4-byte load (the row is 4-aligned and holds the
// whole word); else byte loads that stop at `kb`.
template <bool kVec>
__device__ __forceinline__ uint32_t raw_word(const uint8_t* __restrict__ row,
                                             int w, int kb) {
  if (kVec) return __ldg(reinterpret_cast<const uint32_t*>(row) + w);
  uint32_t x = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (4 * w + b < kb) {
      x |= static_cast<uint32_t>(__ldg(row + 4 * w + b)) << (8 * b);
    }
  }
  return x;
}

// The big-endian key word w of a raw word, bytes at or past `kb` zeroed.
__device__ __forceinline__ uint32_t be_word(uint32_t raw, int w, int kb) {
  const int v = kb - 4 * w;  // key bytes in this word, at least 1
  const uint32_t be = __byte_perm(raw, 0, 0x0123);
  return v >= 4 ? be : be & ~(0xffffffffu >> (8 * v));
}

constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr uint32_t kFnvPrime = 0x01000193u;

// FNV-1a over the key bytes of raw word w (the uint32 product wraps).
__device__ __forceinline__ uint32_t fnv_word(uint32_t h, uint32_t raw, int w,
                                             int kb) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (4 * w + b < kb) h = (h ^ ((raw >> (8 * b)) & 0xffu)) * kFnvPrime;
  }
  return h;
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
