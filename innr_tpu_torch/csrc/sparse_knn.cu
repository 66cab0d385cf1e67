// Sparse-dot kNN scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel innr_tpu/kernels/sparse_knn.py:_sparse_kernel
// (launched by fused_sparse_knn). The query count is a runtime parameter:
// one launch serves a padded batch of Q queries (sparse_knn_batch), and
// sparse_knn is the Q = 1 case.
//
// Inputs: sorted queries of Lq (index, value) pairs, (Q, Lq) uint32 and
// float32 (indices ascending as unsigned, padded with the sentinel
// 0xFFFFFFFF and 0.0); an entry-major corpus, (L, N) uint32 indices and
// float32 values (the JAX package's cached SparseCorpus transposes). Per
// document and query, score = sum of val * qv over the document's entries
// whose index is in the query, where a duplicate query index matches its
// first occurrence (a lower-bound search): the contract of the JAX
// package's join (innr_tpu/ops/sparse.py:_join_scores). An entry that
// matches nothing contributes nothing, so a NaN or inf value counts only
// when its entry matches; the sum starts at +0.0, so a document with no
// match, or only -0.0 products, scores +0.0. Products and sums are rounded
// one at a time (__fmul_rn, __fadd_rn: no fused multiply-add), as the
// plain version computes them; only the order of the sum differs. The score
// keys through total_key (NaN canonicalised) into topk.cuh's composites:
// the k largest under IEEE total order, ties to the lowest document.
//
// Design. The TPU kernel swept the whole query with compare-selects for
// every corpus entry, because a TPU core has no per-lane gather. Here the
// queries sit in shared memory and each corpus entry finds its index by a
// binary search (lower bound) over its query's sorted indices: log2(Lq)
// shared loads instead of Lq compares, and no match tracker, so one path is
// exact for every corpus (the JAX package's finite-only fast sweep selects
// nothing here). sparse_scan<QT>: grid (document slabs x query tiles of QT
// = 1, 2, 4, 8 or 16). A CTA of 256 threads walks its slab in tiles of 256
// documents, one document per thread; entry l of neighbouring documents is
// contiguous in the (L, N) layout, so a warp's loads are coalesced. The
// per-document keys go through the shared top-k steps of row_scan.cuh, and
// knn_merge (knn.cu) selects the final top k from all slabs.
//
// What bounds it on the H100: 10M documents x 32 entries are 2.56 GB of
// indices and values, about 0.76 ms at 3.35 TB/s, whatever the batch: one
// shared lookup per entry could serve a whole batch (a table of the batch's
// ids), and the matched products, under 5.1 G FMAs at Q = 16, take under
// 0.16 ms. This design pays more: a 64-entry query costs each entry 7
// dependent shared loads and a compare, 2.6 G for the corpus, about 0.31 ms
// at 32 loads per clock per SM on 132 SMs at 1.98 GHz, below the read; but
// a batch of 16 repeats the searches 16 times (4.9 ms of shared loads), so
// at Q = 16 the design's searches, not the function, set its floor.
// Measured (PERF.md): a third of the bound at Q = 1, about a twenty-fifth
// at Q = 16; putting 8 entries' loads in flight ahead of their searches
// gained 7% at Q = 1 and lost half at Q = 16, so latency is not what holds
// it. Left for later work: compare-select sweeps for short queries, one
// search of the union of the batch's indices, wider loads.

#include <cuda_runtime.h>

#include "row_scan.cuh"  // TileTopK, kScan*
#include "topk.cuh"      // total_key

namespace {

template <int QT>
__global__ void __launch_bounds__(kScanThreads, 2) sparse_scan(
    const unsigned* __restrict__ q_idx, const float* __restrict__ q_val,
    const unsigned* __restrict__ idx_t, const float* __restrict__ val_t,
    const long long* __restrict__ excl, long long* __restrict__ partial, int n_q, long long n,
    int l, int lq, int k, long long slab_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.y * QT;
  TileTopK<QT> top;
  unsigned* qi_s = reinterpret_cast<unsigned*>(top.init(smem, k, excl, q0, n_q));  // [QT][lq]
  float* qv_s = reinterpret_cast<float*>(qi_s + QT * lq);                           // [QT][lq]
  const int tid = threadIdx.x;
  const long long row_begin = static_cast<long long>(blockIdx.x) * slab_rows;
  const long long row_end = min(n, row_begin + slab_rows);

  for (int i = tid; i < QT * lq; i += kScanThreads) {
    const int j = q0 + i / lq;
    const bool ok = j < n_q;
    qi_s[i] = ok ? q_idx[static_cast<size_t>(j) * lq + i % lq] : 0xFFFFFFFFu;
    qv_s[i] = ok ? q_val[static_cast<size_t>(j) * lq + i % lq] : 0.0f;
  }
  __syncthreads();

  for (long long t0 = row_begin; t0 < row_end; t0 += kScanRowTile) {
    const long long row = t0 + tid;
    float acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0.0f;
    if (row < row_end) {
      for (int e = 0; e < l; ++e) {
        const size_t at = static_cast<size_t>(e) * n + row;
        const unsigned x = idx_t[at];
        const float v = val_t[at];
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          const unsigned* qi = qi_s + j * lq;
          int lo = 0, len = lq;  // lower bound of x in qi[0..lq)
          while (len > 0) {
            const int half = len >> 1;
            if (qi[lo + half] < x) {
              lo += half + 1;
              len -= half + 1;
            } else {
              len = half;
            }
          }
          if (lo < lq && qi[lo] == x) acc[j] = __fadd_rn(acc[j], __fmul_rn(v, qv_s[j * lq + lo]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QT; ++j) top.keys[j * kScanRowTile + tid] = total_key(acc[j]);
    __syncthreads();
    top.offer(k, t0, row_end, q0, n_q);
  }
  top.write(k, q0, n_q, partial);
}

template <int QT>
cudaError_t launch_as(const unsigned* qi, const float* qv, const unsigned* idx_t,
                      const float* val_t, const long long* excl, long long* partial, int n_q,
                      long long n, int l, int lq, int k, int slab_rows, cudaStream_t stream) {
  const size_t smem =
      topk_smem_bytes<QT>(k) + (sizeof(unsigned) + sizeof(float)) * static_cast<size_t>(QT) * lq;
  cudaError_t err = cudaFuncSetAttribute(sparse_scan<QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_slabs = (n + slab_rows - 1) / slab_rows;
  const dim3 grid(static_cast<unsigned>(n_slabs), (n_q + QT - 1) / QT);
  sparse_scan<QT><<<grid, kScanThreads, smem, stream>>>(qi, qv, idx_t, val_t, excl, partial, n_q,
                                                        n, l, lq, k, slab_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q_idx, q_val: (n_q, lq) uint32 / float32, each row sorted ascending;
// idx_t, val_t: (l, n) uint32 / float32; excl: null or (n_q,) int64 bounds.
// query_tile: 1, 2, 4, 8 or 16. partial: (ceil(n / slab_rows), n_q, k)
// int64, for innr_knn_merge. Returns the cudaError_t of the launch (0 on
// success).
int innr_sparse_scan(const void* q_idx, const void* q_val, const void* idx_t, const void* val_t,
                     const void* excl, void* partial, int n_q, long long n, int l, int lq, int k,
                     int query_tile, int slab_rows, void* stream) {
  if (n_q <= 0 || n <= 0 || l < 0 || lq < 0 || k <= 0 || slab_rows <= 0 ||
      slab_rows % kScanRowTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto qi = static_cast<const unsigned*>(q_idx);
  auto qv = static_cast<const float*>(q_val);
  auto it = static_cast<const unsigned*>(idx_t);
  auto vt = static_cast<const float*>(val_t);
  auto e = static_cast<const long long*>(excl);
  auto out = static_cast<long long*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  switch (query_tile) {
    case 1: return launch_as<1>(qi, qv, it, vt, e, out, n_q, n, l, lq, k, slab_rows, st);
    case 2: return launch_as<2>(qi, qv, it, vt, e, out, n_q, n, l, lq, k, slab_rows, st);
    case 4: return launch_as<4>(qi, qv, it, vt, e, out, n_q, n, l, lq, k, slab_rows, st);
    case 8: return launch_as<8>(qi, qv, it, vt, e, out, n_q, n, l, lq, k, slab_rows, st);
    case 16: return launch_as<16>(qi, qv, it, vt, e, out, n_q, n, l, lq, k, slab_rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
