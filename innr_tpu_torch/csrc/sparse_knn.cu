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
// every corpus entry, because a TPU core has no per-lane gather. Here one
// lookup per corpus entry serves the whole query tile. sparse_scan<QT>:
// grid (document slabs x query tiles of QT = 1, 2, 4, 8 or 16). A CTA
// builds its tile's table in shared memory: the union of its queries' ids
// (the sentinel left out) in an open-addressing hash (linear probing, a
// multiplicative hash, at most half full), and for each id a mask of the
// queries that hold it and each one's value at its first occurrence (in a
// sorted row the first of its run: the lower bound, the join's contract);
// each slot an 8-byte (id, mask << 16 | union index). It walks its slab in
// tiles of 256 documents, one document per thread; entry l of neighbouring
// documents is contiguous in the (L, N) layout, so a warp's loads are
// coalesced. Each entry's id is looked up once (one 8-byte shared load, a
// second on a collision; the sentinel is never looked up, so it matches
// nothing), four entries' loads and lookups in flight together; on a hit,
// each query whose mask bit is set adds fl(v * qv) to its sum, the four
// entries in order. So a NaN or inf value counts only for the queries that
// hold its id, a document with no match keeps +0.0, and each score is the
// sum the binary-search kernel formed, bit for bit. The
// per-document keys go through the shared top-k steps of row_scan.cuh, and
// knn_merge (knn.cu) selects the final top k from all slabs. A table too
// large for shared memory halves the query tile (the wrapper).
//
// A query whose table does not fit in shared memory even alone (thousands
// of entries: 8193 at k = 256) keeps the same lookup with the table in
// global memory, where L2 (50 MB) holds it: sparse_table<QT> builds each
// query tile's table once, one CTA a tile, by the same four steps, into a
// scratch area the wrapper sizes; then sparse_scan<QT, true> reads it
// instead of building its own. Its slots hold (id, union index + 1) and the
// masks stay an array (no 16-bit limit on the union). Each document's sums
// take the same products in the same order, so the result is the shared
// path's bit for bit; only where the table lives changes.
//
// What bounds it on the H100: 10M documents x 32 entries are 2.56 GB of
// indices and values, about 0.76 ms at 3.35 TB/s, whatever the batch; the
// lookups are one shared access per entry or two, and the matched
// products, under 5.1 G at Q = 16, take under 0.16 ms. PERF.md gives the
// measured times and what held the previous design (scripts/
// sparse_probe.py: variant builds with its search, its offer or all but
// its loads compiled out).

#include <cuda_runtime.h>

#include "row_scan.cuh"  // TileTopK, kScan*
#include "topk.cuh"      // total_key

namespace {

constexpr unsigned kSentinel = 0xFFFFFFFFu;
constexpr int kGroup = 4;  // corpus entries whose lookups are in flight together

__device__ __forceinline__ unsigned slot_of(unsigned x, int hbits) {
  return (x * 2654435761u) >> (32 - hbits);
}

// The table entry of id x, whose first probe at slot h read e: (mask of
// the queries holding it) << 16 | its union index, or 0 (no query holds
// it, or x is the sentinel). Later probes only after a collision.
__device__ __forceinline__ unsigned lookup(const uint2* __restrict__ hash_s, unsigned x,
                                           unsigned h, uint2 e, int hbits) {
  if (x == kSentinel) return 0;
  while (e.x != x) {
    if (e.x == kSentinel) return 0;
    h = (h + 1) & ((1u << hbits) - 1);
    e = hash_s[h];
  }
  return e.y;
}

// Floats between the values of consecutive union ids: QT + 1 (odd) for a
// tile of several queries, so that the lanes of a warp, each at its own
// id, read query j's values from distinct banks.
template <int QT>
__host__ __device__ constexpr int vstride() {
  return QT == 1 ? 1 : QT + 1;
}

// Whether entry p of a sorted query row is the first of its id (the one
// the join's lower bound finds), and not the sentinel.
__device__ __forceinline__ bool first_of_id(const unsigned* __restrict__ row, int p, unsigned x) {
  return x != kSentinel && (p == 0 || row[p - 1] != x);
}

// The slot of id x, which the hash holds.
__device__ __forceinline__ unsigned slot_holding(const uint2* hash_s, unsigned x, int hbits) {
  unsigned h = slot_of(x, hbits);
  while (hash_s[h].x != x) h = (h + 1) & ((1u << hbits) - 1);
  return h;
}

// A query tile's table at t: the hash [2^hbits] uint2, the values
// [u_max][vstride<QT>], the masks [u_max], the union count [1].
template <int QT>
struct Table {
  uint2* hash;
  float* val;
  unsigned* mask;
  int* count;
  __host__ __device__ static size_t bytes(int lq, int hbits) {
    const size_t u_max = lq > 0 ? static_cast<size_t>(QT) * lq : 1;
    return (8 * (size_t{1} << hbits) + 4 * u_max * (vstride<QT>() + 1) + 4 + 15) & ~size_t{15};
  }
  __device__ static Table at(unsigned char* t, int lq, int hbits) {
    const size_t u_max = max(1, QT * lq);
    Table tab;
    tab.hash = reinterpret_cast<uint2*>(t);
    tab.val = reinterpret_cast<float*>(tab.hash + (size_t{1} << hbits));
    tab.mask = reinterpret_cast<unsigned*>(tab.val + u_max * vstride<QT>());
    tab.count = reinterpret_cast<int*>(tab.mask + u_max);
    return tab;
  }
};

// The table of queries [q0, q0 + QT), built by the whole CTA in four steps:
// the union of its queries' ids into the hash; a union index per id; each
// query's mask bit and value at its first occurrence; each slot's (id,
// mask << 16 | index) (packed: shared memory) or (id, index + 1) (global).
template <int QT>
__device__ void build_table(const Table<QT>& tab, const unsigned* __restrict__ q_idx,
                            const float* __restrict__ q_val, int q0, int n_q, int lq, int hbits,
                            bool packed) {
  const int tid = threadIdx.x, hsize = 1 << hbits;
  uint2* hash_s = tab.hash;
  for (int i = tid; i < hsize; i += kScanThreads) hash_s[i] = make_uint2(kSentinel, 0u);
  if (tid == 0) *tab.count = 0;
  __syncthreads();
  for (int f = tid; f < QT * lq; f += kScanThreads) {
    const int j = f / lq, p = f % lq;
    if (q0 + j >= n_q) continue;
    const unsigned* row = q_idx + static_cast<size_t>(q0 + j) * lq;
    const unsigned x = row[p];
    if (!first_of_id(row, p, x)) continue;
    for (unsigned h = slot_of(x, hbits);; h = (h + 1) & (hsize - 1)) {
      const unsigned prev = atomicCAS(&hash_s[h].x, kSentinel, x);
      if (prev == kSentinel || prev == x) break;
    }
  }
  __syncthreads();
  for (int h = tid; h < hsize; h += kScanThreads)
    if (hash_s[h].x != kSentinel) {
      const int u = atomicAdd(tab.count, 1);
      hash_s[h].y = u;
      tab.mask[u] = 0;
    }
  __syncthreads();
  for (int f = tid; f < QT * lq; f += kScanThreads) {
    const int j = f / lq, p = f % lq;
    if (q0 + j >= n_q) continue;
    const unsigned* row = q_idx + static_cast<size_t>(q0 + j) * lq;
    const unsigned x = row[p];
    if (!first_of_id(row, p, x)) continue;
    const unsigned u = hash_s[slot_holding(hash_s, x, hbits)].y;
    atomicOr(tab.mask + u, 1u << j);
    tab.val[static_cast<size_t>(u) * vstride<QT>() + j] = q_val[static_cast<size_t>(q0 + j) * lq + p];
  }
  __syncthreads();
  for (int h = tid; h < hsize; h += kScanThreads)
    if (hash_s[h].x != kSentinel) hash_s[h].y = packed ? hash_s[h].y | tab.mask[hash_s[h].y] << 16
                                                       : hash_s[h].y + 1;
  __syncthreads();
}

// Query tile blockIdx.x's table into global memory, tile_bytes apart.
template <int QT>
__global__ void __launch_bounds__(kScanThreads) sparse_table(
    const unsigned* __restrict__ q_idx, const float* __restrict__ q_val, unsigned char* table,
    size_t tile_bytes, int n_q, int lq, int hbits) {
  const Table<QT> tab = Table<QT>::at(table + blockIdx.x * tile_bytes, lq, hbits);
  build_table<QT>(tab, q_idx, q_val, blockIdx.x * QT, n_q, lq, hbits, false);
}

// kGlobal: the tile's table is sparse_table's, in global memory; else the
// CTA builds it in shared memory.
template <int QT, bool kGlobal>
__global__ void __launch_bounds__(kScanThreads, 2) sparse_scan(
    const unsigned* __restrict__ q_idx, const float* __restrict__ q_val,
    const unsigned* __restrict__ idx_t, const float* __restrict__ val_t,
    const long long* __restrict__ excl, unsigned char* table, size_t tile_bytes,
    long long* __restrict__ partial, int n_q, long long n, int l, int lq, int hbits, int k,
    long long slab_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.y * QT;
  TileTopK<QT> top;
  unsigned char* after_top = top.init(smem, k, excl, q0, n_q);
  const Table<QT> tab = Table<QT>::at(kGlobal ? table + blockIdx.y * tile_bytes : after_top, lq,
                                      hbits);
  if constexpr (!kGlobal) build_table<QT>(tab, q_idx, q_val, q0, n_q, lq, hbits, true);
  else __syncthreads();  // top.init's stores
  const uint2* hash_s = tab.hash;
  const float* val_s = tab.val;
  const unsigned* mask_s = tab.mask;
  const int tid = threadIdx.x;
  const long long row_begin = static_cast<long long>(blockIdx.x) * slab_rows;
  const long long row_end = min(n, row_begin + slab_rows);

  for (long long t0 = row_begin; t0 < row_end; t0 += kScanRowTile) {
    const long long row = t0 + tid;
    float acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0.0f;
    if (row < row_end) {
      for (int e0 = 0; e0 < l; e0 += kGroup) {
        // kGroup entries' loads and lookups in flight together, then their
        // products added in entry order.
        unsigned hit[kGroup];
        float v[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const size_t at = static_cast<size_t>(e0 + g) * n + row;
          const bool in = e0 + g < l;
          hit[g] = in ? idx_t[at] : kSentinel;
          v[g] = in ? val_t[at] : 0.0f;
        }
        // Every entry's first probe issued before any is used.
        unsigned h[kGroup];
        uint2 e[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          h[g] = slot_of(hit[g], hbits);
          e[g] = hash_s[h[g]];
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) hit[g] = lookup(hash_s, hit[g], h[g], e[g], hbits);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          unsigned m;
          const float* qv;
          if constexpr (kGlobal) {  // (id, index + 1); 0: no query holds it
            const size_t u = hit[g] == 0u ? 0 : hit[g] - 1u;
            m = hit[g] == 0u ? 0u : (QT == 1 ? 1u : mask_s[u]);
            qv = val_s + u * vstride<QT>();
          } else {
            m = hit[g] >> 16;
            qv = val_s + (hit[g] & 0xFFFFu) * vstride<QT>();
          }
          if (m != 0) {
#pragma unroll
            for (int j = 0; j < QT; ++j)
              if ((m >> j) & 1u) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[g], qv[j]));
          }
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

template <int QT, bool kGlobal>
cudaError_t launch_scan(const unsigned* q_idx, const float* q_val, const unsigned* idx_t,
                        const float* val_t, const long long* excl, unsigned char* table,
                        long long* partial, int n_q, long long n, int l, int lq, int hbits, int k,
                        int slab_rows, cudaStream_t stream) {
  const size_t tile_bytes = Table<QT>::bytes(lq, hbits);
  const size_t smem = topk_smem_bytes<QT>(k) + (kGlobal ? 0 : tile_bytes);
  cudaError_t err = cudaFuncSetAttribute(sparse_scan<QT, kGlobal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned n_tiles = (n_q + QT - 1) / QT;
  if (kGlobal) {
    sparse_table<QT><<<n_tiles, kScanThreads, 0, stream>>>(q_idx, q_val, table, tile_bytes, n_q,
                                                           lq, hbits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long n_slabs = (n + slab_rows - 1) / slab_rows;
  const dim3 grid(static_cast<unsigned>(n_slabs), n_tiles);
  sparse_scan<QT, kGlobal><<<grid, kScanThreads, smem, stream>>>(
      q_idx, q_val, idx_t, val_t, excl, table, tile_bytes, partial, n_q, n, l, lq, hbits, k,
      slab_rows);
  return cudaGetLastError();
}

template <int QT>
cudaError_t launch_as(const unsigned* q_idx, const float* q_val, const unsigned* idx_t,
                      const float* val_t, const long long* excl, void* table,
                      long long table_bytes, long long* partial, int n_q, long long n, int l,
                      int lq, int hbits, int k, int slab_rows, cudaStream_t stream) {
  if (table == nullptr)
    return launch_scan<QT, false>(q_idx, q_val, idx_t, val_t, excl, nullptr, partial, n_q, n, l,
                                  lq, hbits, k, slab_rows, stream);
  const long long need = static_cast<long long>(Table<QT>::bytes(lq, hbits)) *
                         ((n_q + QT - 1) / QT);
  if (table_bytes < need) return cudaErrorInvalidValue;
  return launch_scan<QT, true>(q_idx, q_val, idx_t, val_t, excl,
                               static_cast<unsigned char*>(table), partial, n_q, n, l, lq, hbits,
                               k, slab_rows, stream);
}

}  // namespace

extern "C" {

// q_idx, q_val: (n_q, lq) uint32 / float32, each row sorted ascending as
// unsigned (sentinel padding last); idx_t, val_t: (l, n) uint32 / float32;
// excl: null or (n_q,) int64 bounds. query_tile: 1, 2, 4, 8 or 16; the
// hash holds 2^hash_bits slots (at least twice query_tile * lq). table:
// null (each CTA builds its tile's table in shared memory: hash_bits <= 24,
// query_tile * lq <= 65536), or table_bytes of global scratch for one
// table per query tile (innr_sparse_table_bytes each; hash_bits <= 30).
// partial: (ceil(n / slab_rows), n_q, k) int64, for innr_knn_merge.
// Returns the cudaError_t of the launch (0 on success).
int innr_sparse_scan(const void* q_idx, const void* q_val, const void* idx_t, const void* val_t,
                     const void* excl, void* table, long long table_bytes, void* partial, int n_q,
                     long long n, int l, int lq, int hash_bits, int k, int query_tile,
                     int slab_rows, void* stream) {
  const long long u_max = static_cast<long long>(query_tile) * lq;
  const bool global = table != nullptr;
  if (n_q <= 0 || n <= 0 || l < 0 || lq < 0 || (!global && u_max > 65536) || hash_bits < 4 ||
      hash_bits > (global ? 30 : 24) || (1LL << hash_bits) < 2 * u_max || k <= 0 ||
      slab_rows <= 0 || slab_rows % kScanRowTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto qi = static_cast<const unsigned*>(q_idx);
  auto qv = static_cast<const float*>(q_val);
  auto it = static_cast<const unsigned*>(idx_t);
  auto vt = static_cast<const float*>(val_t);
  auto e = static_cast<const long long*>(excl);
  auto out = static_cast<long long*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
#define INNR_SPARSE_LAUNCH(QT) \
  launch_as<QT>(qi, qv, it, vt, e, table, table_bytes, out, n_q, n, l, lq, hash_bits, k, \
                slab_rows, st)
  switch (query_tile) {
    case 1: return INNR_SPARSE_LAUNCH(1);
    case 2: return INNR_SPARSE_LAUNCH(2);
    case 4: return INNR_SPARSE_LAUNCH(4);
    case 8: return INNR_SPARSE_LAUNCH(8);
    case 16: return INNR_SPARSE_LAUNCH(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef INNR_SPARSE_LAUNCH
}

// Bytes of one query tile's table in global memory (innr_sparse_scan's
// table holds ceil(n_q / query_tile) of them), or 0 for a bad tile.
long long innr_sparse_table_bytes(int query_tile, int lq, int hash_bits) {
  switch (query_tile) {
    case 1: return static_cast<long long>(Table<1>::bytes(lq, hash_bits));
    case 2: return static_cast<long long>(Table<2>::bytes(lq, hash_bits));
    case 4: return static_cast<long long>(Table<4>::bytes(lq, hash_bits));
    case 8: return static_cast<long long>(Table<8>::bytes(lq, hash_bits));
    case 16: return static_cast<long long>(Table<16>::bytes(lq, hash_bits));
    default: return 0;
  }
}

}  // extern "C"
