// Packed-word kNN scans for Hopper (sm_90a), plain C interface.
//
// Replaces four TPU kernels of innr_tpu/kernels/packed_knn.py:
//   _binary_kernel     (fused_binary_knn)         one query, Hamming
//   _binary_kernel_mq  (fused_binary_knn_batch)   a query batch, Hamming
//   _ternary_kernel    (fused_ternary_knn)        one query, ternary dot
//   _ternary_kernel_mq (fused_ternary_knn_batch)  a query batch, ternary dot
// The query count is a runtime parameter, so the single-query forms are the
// Q = 1 case of packed_scan.
//
// Inputs are word-major: the corpus is (W, N) uint32 planes (one plane for
// binary, pos and neg planes for ternary), the JAX package's cached
// transpose; queries are (Q, W) planes. Per corpus row and query:
//   binary   count = sum_w popc(row_w ^ q_w)                key = -count
//   ternary  dot   = sum_w popc((p & qp) | (n & qn))
//                        - popc((p & qn) | (n & qp))       key = dot
// Keys go into the int64 composites of topk.cuh, so selection is "key
// descending, row ascending": the k smallest counts or the k largest dots,
// ties to the lowest row, as the TPU kernels' update_topk selects.
//
// Design. packed_scan: grid (corpus slabs x query tiles of QT = 1, 2, 4, 8
// or 16 queries, a template parameter fitted to Q so that one query pays
// for one popcount per word, not for a tile's). A CTA of 256 threads walks
// its slab in tiles of 256 rows, one row per thread. The thread reads its
// row's words (word w of neighbouring rows is contiguous in the (W, N)
// layout, so a warp's loads are coalesced) and popcounts each against the
// tile's queries, which sit in shared memory (every lane reads the same
// address: a broadcast). The QT keys of each row go through the CTA top-k
// steps of row_scan.cuh, which slot_scan and sparse_scan share: each warp
// owns max(QT, 8) / 8 top-k buffers and offers the tile's rows to them
// (topk.cuh: a one-compare reject against the k-th best, a warp-parallel
// sorted insert for the rare improving row). With QT < 8, the G = 8 / QT
// warps of one query each keep a buffer over their own share of the rows,
// so no warp idles, and fold them into one at the end. The slab's top k
// per query goes to partial[(slab, q, k)], and knn_merge (knn.cu) selects
// the final top k from all slabs. Composites are unique, so the two-level
// selection equals one sequential stream exactly.
//
// What bounds it on the H100: population count issues at 16 per clock per
// SM on compute capability 9.0, a quarter of the rate of the bitwise ops
// (CUDA C++ Programming Guide, arithmetic-instruction throughput). Each
// corpus word feeds QT popcounts (binary) or 2 QT (ternary), so a batch of
// 16 is popcount-bound: 30M x 24 words x 16 queries = 11.5 G popcounts, or
// about 3.1 ms at 132 SMs and 1.755 GHz, against about 1 ms to read the
// 2.88 GB. A single query is bound by the corpus read. Left for later work:
// Hamming on the b1 tensor-core MMA (mma.sync .b1 .and.popc, with
// Hamming = popc(a) + popc(b) - 2 popc(a & b)), several rows per thread for
// wider loads, and batched inserts for large k.

#include <cuda_runtime.h>

#include "packed.cuh"    // kBinary, kTernary, word_score
#include "row_scan.cuh"  // TileTopK, load_query_words, kScan*

namespace {

template <int kKind, int QT>
__global__ void __launch_bounds__(kScanThreads, 2) packed_scan(
    const unsigned* __restrict__ qp, const unsigned* __restrict__ qn,
    const unsigned* __restrict__ pos_t, const unsigned* __restrict__ neg_t,
    const long long* __restrict__ excl, long long* __restrict__ partial,
    int n_q, long long n, int w, int k, long long slab_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.y * QT;
  TileTopK<QT> top;
  unsigned* q_s = reinterpret_cast<unsigned*>(top.init(smem, k, excl, q0, n_q));  // [planes][w][QT]
  const int tid = threadIdx.x;
  const long long row_begin = static_cast<long long>(blockIdx.x) * slab_rows;
  const long long row_end = min(n, row_begin + slab_rows);

  for (int i = tid; i < w * QT; i += kScanThreads) {
    const int wd = i / QT, q = q0 + i % QT;
    const bool ok = q < n_q;
    q_s[i] = ok ? qp[static_cast<size_t>(q) * w + wd] : 0u;
    if constexpr (kKind == kTernary) q_s[w * QT + i] = ok ? qn[static_cast<size_t>(q) * w + wd] : 0u;
  }
  __syncthreads();

  for (long long t0 = row_begin; t0 < row_end; t0 += kScanRowTile) {
    const long long row = t0 + tid;
    int acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0;
    if (row < row_end) {
#pragma unroll 4
      for (int wd = 0; wd < w; ++wd) {
        const size_t at = static_cast<size_t>(wd) * n + row;
        const unsigned p = pos_t[at];
        const unsigned m = kKind == kTernary ? neg_t[at] : 0u;
        unsigned a[QT], b[QT] = {};
        load_query_words<QT>(q_s + wd * QT, a);
        if constexpr (kKind == kTernary) load_query_words<QT>(q_s + (w + wd) * QT, b);
#pragma unroll
        for (int j = 0; j < QT; ++j) acc[j] += word_score<kKind>(p, m, a[j], b[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < QT; ++j)
      top.keys[j * kScanRowTile + tid] = kKind == kBinary ? -acc[j] : acc[j];
    __syncthreads();
    top.offer(k, t0, row_end, q0, n_q);
  }
  top.write(k, q0, n_q, partial);
}

template <int kKind, int QT>
cudaError_t launch_scan_as(const unsigned* qp, const unsigned* qn, const unsigned* pos_t,
                           const unsigned* neg_t, const long long* excl, long long* partial,
                           int n_q, long long n, int w, int k, int slab_rows,
                           cudaStream_t stream) {
  constexpr int kPlanes = kKind == kTernary ? 2 : 1;
  const size_t smem =
      topk_smem_bytes<QT>(k) + sizeof(unsigned) * static_cast<size_t>(kPlanes) * w * QT;
  cudaError_t err = cudaFuncSetAttribute(packed_scan<kKind, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_slabs = (n + slab_rows - 1) / slab_rows;
  const dim3 grid(static_cast<unsigned>(n_slabs), (n_q + QT - 1) / QT);
  packed_scan<kKind, QT><<<grid, kScanThreads, smem, stream>>>(qp, qn, pos_t, neg_t, excl,
                                                               partial, n_q, n, w, k, slab_rows);
  return cudaGetLastError();
}

template <int kKind>
cudaError_t launch_scan(int query_tile, const unsigned* qp, const unsigned* qn,
                        const unsigned* pos_t, const unsigned* neg_t, const long long* excl,
                        long long* partial, int n_q, long long n, int w, int k, int slab_rows,
                        cudaStream_t s) {
  switch (query_tile) {
    case 1: return launch_scan_as<kKind, 1>(qp, qn, pos_t, neg_t, excl, partial, n_q, n, w, k, slab_rows, s);
    case 2: return launch_scan_as<kKind, 2>(qp, qn, pos_t, neg_t, excl, partial, n_q, n, w, k, slab_rows, s);
    case 4: return launch_scan_as<kKind, 4>(qp, qn, pos_t, neg_t, excl, partial, n_q, n, w, k, slab_rows, s);
    case 8: return launch_scan_as<kKind, 8>(qp, qn, pos_t, neg_t, excl, partial, n_q, n, w, k, slab_rows, s);
    case 16: return launch_scan_as<kKind, 16>(qp, qn, pos_t, neg_t, excl, partial, n_q, n, w, k, slab_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kind: 0 binary (qn, neg_t unused, may be null), 1 ternary. qp, qn: (n_q, w)
// uint32; pos_t, neg_t: (w, n) uint32; excl: null or (n_q,) int64 bounds.
// query_tile: 1, 2, 4, 8 or 16. partial: (ceil(n / slab_rows), n_q, k)
// int64, for innr_knn_merge.
// Returns the cudaError_t of the launch (0 on success).
int innr_packed_scan(int kind, const void* qp, const void* qn, const void* pos_t,
                     const void* neg_t, const void* excl, void* partial, int n_q, long long n,
                     int w, int k, int query_tile, int slab_rows, void* stream) {
  if (n_q <= 0 || n <= 0 || w <= 0 || k <= 0 || slab_rows <= 0 || slab_rows % kScanRowTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kTernary && (qn == nullptr || neg_t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto a = static_cast<const unsigned*>(qp);
  auto b = static_cast<const unsigned*>(qn);
  auto p = static_cast<const unsigned*>(pos_t);
  auto m = static_cast<const unsigned*>(neg_t);
  auto e = static_cast<const long long*>(excl);
  auto out = static_cast<long long*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case kBinary:
      err = launch_scan<kBinary>(query_tile, a, b, p, m, e, out, n_q, n, w, k, slab_rows, s);
      break;
    case kTernary:
      err = launch_scan<kTernary>(query_tile, a, b, p, m, e, out, n_q, n, w, k, slab_rows, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
