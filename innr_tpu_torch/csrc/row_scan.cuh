// The parts of a row-per-thread top-k scan, shared by the slot scans
// (slot_knn.cu) and sparse_scan (sparse_knn.cu):
// the CTA's shared-memory top-k buffers, the offer of a tile's keys to
// them, the fold of a query's buffers into one, the write of the slab's
// partial top k for knn_merge (knn.cu), and the load of a tile's query
// words from shared memory.
//
// A CTA of 256 threads walks its slab of corpus rows in tiles of ROWS (256
// by default: one row per thread; a multiple of 256 when each thread takes
// several neighbouring rows), for a tile of QT queries (1 to 32, a power of
// two; template parameters). Each thread writes its rows' QT int32 keys
// (larger is better) to shared memory; then each warp owns max(QT, 8) / 8
// top-k buffers of
// int64 composites (topk.cuh) and offers the tile's rows to them: with
// QT < 8, the G = 8 / QT warps of one query each keep a buffer over their
// own share of the rows and are folded into one at the end. Composites are
// unique, so the two-level selection (slab buffers, then knn_merge) equals
// one sequential stream: key descending, row ascending.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

#include "topk.cuh"  // composite, warp_offer

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanRowTile = kScanThreads;  // one corpus row per thread per tile
constexpr int kScanMaxQueryTile = 16;  // sparse_scan's tiles; the slot table's reach 32

template <int QT>
__host__ __device__ constexpr int buffers_per_query() {
  return QT >= kScanWarps ? 1 : kScanWarps / QT;
}

// Exclusion bounds held: 16, or QT for a wider tile.
template <int QT>
__host__ __device__ constexpr int bounds_held() {
  return QT > kScanMaxQueryTile ? QT : kScanMaxQueryTile;
}

// Shared bytes of the top-k part: [QT * G][k] int64 buffers, [max(16, QT)]
// int64 exclusion bounds, [QT][ROWS] int32 keys. The scan's own data follows
// it (16-byte aligned: every term is a multiple of 16).
template <int QT, int ROWS = kScanRowTile>
__host__ __device__ constexpr size_t topk_smem_bytes(int k) {
  return sizeof(long long) * (static_cast<size_t>(QT * buffers_per_query<QT>()) * k +
                              bounds_held<QT>()) +
         sizeof(int) * static_cast<size_t>(QT) * ROWS;
}

// QT consecutive 32-bit query words from shared memory; 16-byte loads when
// QT is a multiple of 4 (the caller aligns the rows of its query block to
// 16 bytes).
template <int QT>
__device__ __forceinline__ void load_query_words(const unsigned* q, unsigned (&out)[QT]) {
  if constexpr (QT % 4 == 0) {
#pragma unroll
    for (int v = 0; v < QT / 4; ++v) {
      const uint4 t = reinterpret_cast<const uint4*>(q)[v];
      out[4 * v] = t.x;
      out[4 * v + 1] = t.y;
      out[4 * v + 2] = t.z;
      out[4 * v + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < QT; ++j) out[j] = q[j];
  }
}

template <int QT, int ROWS = kScanRowTile>
struct TileTopK {
  static constexpr int kChunks = ROWS / 32;
  long long* best;   // [QT * G][k]
  long long* bound;  // [max(16, QT)]
  int* keys;         // [QT][ROWS]

  // Lay the buffers out at smem, empty them and load the exclusion bounds
  // (null excl: no bound). Returns the first byte after them. The caller
  // synchronises before the first offer.
  __device__ unsigned char* init(unsigned char* smem, int k, const long long* excl, int q0,
                                 int n_q) {
    constexpr int kBufs = QT * buffers_per_query<QT>();
    best = reinterpret_cast<long long*>(smem);
    bound = best + kBufs * k;
    keys = reinterpret_cast<int*>(bound + bounds_held<QT>());
    for (int i = threadIdx.x; i < kBufs * k; i += kScanThreads) best[i] = LLONG_MIN;
    if (threadIdx.x < QT)
      bound[threadIdx.x] =
          (excl != nullptr && q0 + threadIdx.x < n_q) ? excl[q0 + threadIdx.x] : LLONG_MAX;
    return reinterpret_cast<unsigned char*>(keys + QT * ROWS);
  }

  // Offer the tile of rows [t0, t0 + ROWS) ∩ [.., row_end), whose keys are
  // in `keys`, to the buffers. Called by every thread after the keys are
  // written and synchronised; ends synchronised.
  __device__ void offer(int k, long long t0, long long row_end, int q0, int n_q) {
    constexpr int G = buffers_per_query<QT>();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // Buffer bf holds query bf / G over the chunks of 32 rows c = g, g + G, ...
    for (int bf = warp; bf < QT * G; bf += kScanWarps) {
      const int j = bf / G, g = bf % G;
      if (q0 + j >= n_q) continue;  // uniform across the warp
      for (int c = g; c < kChunks; c += G) {
        const int r = c * 32 + lane;
        long long cand = LLONG_MIN;
        if (t0 + r < row_end) {
          cand = composite(keys[j * ROWS + r], t0 + r);
          if (cand >= bound[j]) cand = LLONG_MIN;
        }
        warp_offer(best + bf * k, k, cand, lane);
      }
    }
    __syncthreads();
  }

  // Fold each query's G buffers into its first and write the slab's top k
  // per query to partial[(slab, q, k)].
  __device__ void write(int k, int q0, int n_q, long long* partial) {
    constexpr int G = buffers_per_query<QT>();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if constexpr (G > 1) {
      const int j = warp / G;
      if (warp % G == 0 && q0 + j < n_q) {
        for (int bf = warp + 1; bf < warp + G; ++bf)
          for (int base = 0; base < k; base += 32) {
            const int i = base + lane;
            warp_offer(best + warp * k, k, i < k ? best[bf * k + i] : LLONG_MIN, lane);
          }
      }
      __syncthreads();
    }
    for (int f = threadIdx.x; f < QT * k; f += kScanThreads) {
      const int j = f / k, q = q0 + j;
      if (q < n_q)
        partial[(static_cast<size_t>(blockIdx.x) * n_q + q) * k + f % k] = best[j * G * k + f % k];
    }
  }
};

}  // namespace
