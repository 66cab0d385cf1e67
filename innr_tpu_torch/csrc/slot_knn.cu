// Slot-sketch (MinHash) kNN scan for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of innr_tpu/kernels/slot_knn.py:
//   _slot_kernel     (fused_slot_knn)        one sketch
//   _slot_kernel_mq  (fused_slot_knn_batch)  a batch of sketches
// The query count is a runtime parameter, so the single-sketch form is the
// Q = 1 case of slot_scan.
//
// Inputs are slot-major: the corpus is (S, N) uint32 or uint16 slots (the
// JAX package's cached SketchCorpus.slots_t), the queries (Q, S) of the
// same type. Per corpus row and query, count = #{s : row_s != q_s}, the
// differing-slot count; key = -count goes into the int64 composites of
// topk.cuh, so selection is the k smallest counts, ties to the lowest row,
// as the TPU kernels' update_topk selects.
//
// Design: packed_scan (packed_knn.cu) with a compare and an add in place of
// the popcount. slot_scan<T, QT>: grid (corpus slabs x query tiles of QT =
// 1, 2, 4, 8 or 16, fitted to Q so that one query pays for one compare per
// slot). A CTA of 256 threads walks its slab in tiles of 256 rows, one row
// per thread; slot s of neighbouring rows is contiguous in the (S, N)
// layout, so a warp's loads are coalesced. The tile's queries sit in shared
// memory, widened to 32 bits (a uint16 slot compares equal exactly when
// its zero-extension does), and every lane reads the same address (a
// broadcast). The per-row keys go through the shared top-k steps of
// row_scan.cuh, and knn_merge (knn.cu) selects the final top k from all
// slabs.
//
// What bounds it on the H100: 10M x 128 uint32 slots are 5.12 GB, about
// 1.53 ms at 3.35 TB/s (uint16: 0.76 ms). Each slot feeds a compare and an
// add per query: at Q = 16 that is 41 G integer operations, about 2.4 ms at
// 64 INT32 operations per clock per SM (compute capability 9.0) on 132 SMs
// at 1.98 GHz, so a batch is bound by integer issue and a single sketch by
// the read. Left for later work: two uint16 slots per 32-bit compare
// (__vcmpne2), several rows per thread for wider loads, batched inserts for
// large k.

#include <cuda_runtime.h>

#include "row_scan.cuh"  // TileTopK, load_query_words, kScan*

namespace {

template <typename T, int QT>
__global__ void __launch_bounds__(kScanThreads, 2) slot_scan(
    const T* __restrict__ q, const T* __restrict__ slots_t, const long long* __restrict__ excl,
    long long* __restrict__ partial, int n_q, long long n, int s, int k, long long slab_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.y * QT;
  TileTopK<QT> top;
  unsigned* q_s = reinterpret_cast<unsigned*>(top.init(smem, k, excl, q0, n_q));  // [s][QT]
  const int tid = threadIdx.x;
  const long long row_begin = static_cast<long long>(blockIdx.x) * slab_rows;
  const long long row_end = min(n, row_begin + slab_rows);

  for (int i = tid; i < s * QT; i += kScanThreads) {
    const int sl = i / QT, j = q0 + i % QT;
    q_s[i] = j < n_q ? static_cast<unsigned>(q[static_cast<size_t>(j) * s + sl]) : 0u;
  }
  __syncthreads();

  for (long long t0 = row_begin; t0 < row_end; t0 += kScanRowTile) {
    const long long row = t0 + tid;
    int acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0;
    if (row < row_end) {
#pragma unroll 4
      for (int sl = 0; sl < s; ++sl) {
        const unsigned v = slots_t[static_cast<size_t>(sl) * n + row];
        unsigned a[QT];
        load_query_words<QT>(q_s + sl * QT, a);
#pragma unroll
        for (int j = 0; j < QT; ++j) acc[j] += v != a[j];
      }
    }
#pragma unroll
    for (int j = 0; j < QT; ++j) top.keys[j * kScanRowTile + tid] = -acc[j];
    __syncthreads();
    top.offer(k, t0, row_end, q0, n_q);
  }
  top.write(k, q0, n_q, partial);
}

template <typename T, int QT>
cudaError_t launch_as(const void* q, const void* slots_t, const long long* excl,
                      long long* partial, int n_q, long long n, int s, int k, int slab_rows,
                      cudaStream_t stream) {
  const size_t smem = topk_smem_bytes<QT>(k) + sizeof(unsigned) * static_cast<size_t>(s) * QT;
  cudaError_t err = cudaFuncSetAttribute(slot_scan<T, QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_slabs = (n + slab_rows - 1) / slab_rows;
  const dim3 grid(static_cast<unsigned>(n_slabs), (n_q + QT - 1) / QT);
  slot_scan<T, QT><<<grid, kScanThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(slots_t), excl, partial, n_q, n, s, k,
      slab_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int query_tile, const void* q, const void* slots_t, const long long* excl,
                   long long* partial, int n_q, long long n, int s, int k, int slab_rows,
                   cudaStream_t st) {
  switch (query_tile) {
    case 1: return launch_as<T, 1>(q, slots_t, excl, partial, n_q, n, s, k, slab_rows, st);
    case 2: return launch_as<T, 2>(q, slots_t, excl, partial, n_q, n, s, k, slab_rows, st);
    case 4: return launch_as<T, 4>(q, slots_t, excl, partial, n_q, n, s, k, slab_rows, st);
    case 8: return launch_as<T, 8>(q, slots_t, excl, partial, n_q, n, s, k, slab_rows, st);
    case 16: return launch_as<T, 16>(q, slots_t, excl, partial, n_q, n, s, k, slab_rows, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bits: 16 or 32, the slot width. q: (n_q, s) slots; slots_t: (s, n)
// slots; excl: null or (n_q,) int64 bounds. query_tile: 1, 2, 4, 8 or 16.
// partial: (ceil(n / slab_rows), n_q, k) int64, for innr_knn_merge.
// Returns the cudaError_t of the launch (0 on success).
int innr_slot_scan(int bits, const void* q, const void* slots_t, const void* excl, void* partial,
                   int n_q, long long n, int s, int k, int query_tile, int slab_rows,
                   void* stream) {
  if (n_q <= 0 || n <= 0 || s < 0 || k <= 0 || slab_rows <= 0 || slab_rows % kScanRowTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto e = static_cast<const long long*>(excl);
  auto out = static_cast<long long*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bits) {
    case 16:
      err = launch<unsigned short>(query_tile, q, slots_t, e, out, n_q, n, s, k, slab_rows, st);
      break;
    case 32:
      err = launch<unsigned>(query_tile, q, slots_t, e, out, n_q, n, s, k, slab_rows, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
