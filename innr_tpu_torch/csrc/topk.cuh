// Streaming top-k selection on int64 composites, shared by the kNN scans
// (knn.cu, packed_knn.cu) and the nearest-centroid pass (assign.cu).
//
// A candidate is one int64 composite
//     (uint32)key << 32 | (0xFFFFFFFF - row)
// of an int32 key (larger is better) and its corpus row. One signed max
// over composites gives "key descending, row ascending": ties go to the
// lowest row, the first-occurrence rule of the JAX package's update_topk
// (innr_tpu/kernels/knn.py:152-166), and an exclusion bound (resume after a
// previous pass) is a single compare. LLONG_MIN is the empty slot: it
// decodes to (INT_MIN, -1) and never beats a real row.

#pragma once

#include <cuda_runtime.h>
#include <climits>

namespace {

// The int32 total-order key of a score (larger is better). A NaN is made
// the canonical quiet NaN 0x7FC00000 first: GPU arithmetic returns
// canonical NaNs, CPUs propagate payloads and signs, and the plain PyTorch
// versions canonicalise the same way.
__device__ __forceinline__ int total_key(float s) {
  int bits = (s != s) ? 0x7FC00000 : __float_as_int(s);
  return bits ^ (bits < 0 ? 0x7FFFFFFF : 0);
}

__device__ __forceinline__ long long composite(int key, long long row) {
  unsigned long long hi = static_cast<unsigned long long>(static_cast<unsigned>(key)) << 32;
  unsigned long long lo = 0xFFFFFFFFull - static_cast<unsigned long long>(row);
  return static_cast<long long>(hi | lo);
}

// Insert c into buf[0..k), sorted descending, dropping buf[k-1]. The caller
// guarantees c > buf[k-1]. All 32 lanes call with the same c.
__device__ void warp_insert(long long* buf, int k, long long c, int lane) {
  int pos = 0;
  for (int i = lane; i < k; i += 32) pos += buf[i] > c;
  for (int o = 16; o > 0; o >>= 1) pos += __shfl_xor_sync(0xFFFFFFFFu, pos, o);
  // Shift buf[pos..k-2] up by one, highest chunk first, so that no entry is
  // overwritten before it has been read.
  for (int base = ((k - 1) / 32) * 32; base >= 0; base -= 32) {
    int i = base + lane;
    long long v = i < k ? buf[i] : 0;
    __syncwarp();
    if (i >= pos && i + 1 < k) buf[i + 1] = v;
    __syncwarp();
  }
  if (lane == 0) buf[pos] = c;
  __syncwarp();
}

// Offer one candidate per lane to a warp-owned top-k buffer: one compare
// rejects a candidate that cannot beat the k-th best.
__device__ void warp_offer(long long* buf, int k, long long c, int lane) {
  unsigned todo = __ballot_sync(0xFFFFFFFFu, c > buf[k - 1]);
  while (todo) {
    int src = __ffs(todo) - 1;
    todo &= todo - 1;
    long long cand = __shfl_sync(0xFFFFFFFFu, c, src);
    if (cand > buf[k - 1]) warp_insert(buf, k, cand, lane);
  }
}

// Offer one candidate per lane to a warp-owned top-k buffer in one merge:
// the candidates that beat the k-th best are sorted across the warp
// (bitonic, descending); each goes to its rank in the merged order (its
// lane plus the buffer entries above it, a binary search) and each buffer
// entry to its index plus the candidates above it (a search over the
// lanes), highest chunk first so that every entry is read before its slot
// is written; whatever lands at k or later drops out. Composites are
// unique, so the ranks are distinct. A lone candidate takes warp_insert.
// All 32 lanes call, each buffer with its own candidates.
__device__ void warp_merge(long long* buf, int k, long long c, int lane) {
  c = c > buf[k - 1] ? c : LLONG_MIN;
  const unsigned live = __ballot_sync(0xFFFFFFFFu, c != LLONG_MIN);
  if (live == 0u) return;
  if ((live & (live - 1u)) == 0u) {
    warp_insert(buf, k, __shfl_sync(0xFFFFFFFFu, c, __ffs(live) - 1), lane);
    return;
  }
  for (int size = 2; size <= 32; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const long long o = __shfl_xor_sync(0xFFFFFFFFu, c, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      c = keep_max ? max(c, o) : min(c, o);
    }
  // Lane i now holds the i-th best candidate (LLONG_MIN past the live ones).
  int rank = k;
  if (c != LLONG_MIN) {
    int lo = 0, hi = k;  // buffer entries above c: the first index not above it
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (buf[mid] > c) lo = mid + 1;
      else hi = mid;
    }
    rank = lane + lo;
  }
  for (int base = ((k - 1) / 32) * 32; base >= 0; base -= 32) {
    const int j = base + lane;
    const long long v = j < k ? buf[j] : LLONG_MIN;
    int above = 0;  // candidates above v (lanes sorted descending)
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(0xFFFFFFFFu, c, above + step - 1) > v) above += step;
    if (__shfl_sync(0xFFFFFFFFu, c, above) > v) ++above;
    __syncwarp();
    if (j < k && j + above < k) buf[j + above] = v;
    __syncwarp();
  }
  if (rank < k) buf[rank] = c;
  __syncwarp();
}

}  // namespace
