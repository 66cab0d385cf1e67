// Fused score + streaming top-k kNN for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel innr_tpu/kernels/knn.py:_knn_kernel (launched by
// _fused_knn_raw, driven for large k by _fused_knn_multi). For Q f32 queries
// (Q, D) against a row-major corpus (N, D) of f32, bf16 or u8 it returns,
// per query, the best k candidates as int64 composites
//     (uint32)key << 32 | (0xFFFFFFFF - row)
// where key is the int32 total-order key of the row's score (larger is
// better; L2 keys are bit-inverted so that a smaller distance is better).
// One signed max over composites gives "key descending, row ascending", so
// ties go to the lowest row, and an exclusion bound (resume after a previous
// pass) is a single compare. LLONG_MIN is the empty slot: it decodes to
// (INT_MIN, -1) and never beats a real row.
//
// Scores by mode (score = 0 dot, 1 l2, 2 cosine; a non-null mask adds the
// predicate forms l2m / dotm / cosinem):
//   dot     q . r
//   l2      aux[r] - 2 q . r      (aux = squared row norms; ||q||^2 is added
//                                  by the caller, a per-query shift)
//   cosine  (q . r) * aux[r]      (aux = guarded inverse row norms; the
//                                  caller passes unit queries)
//   mask[r] > 0 fails  ->  key INT_MIN (the row sorts after every passing row)
// A NaN score is made the canonical quiet NaN 0x7FC00000 before keying: GPU
// arithmetic returns canonical NaNs, CPUs propagate payloads and signs, and
// the plain PyTorch version does the same canonicalisation, so both rank
// NaNs identically (greatest for dot/cosine, last for L2).
//
// Arithmetic: the dot accumulates fp32 FMAs in dimension order from +0.0,
// with no TF32. bf16 corpora: queries are rounded to bf16 first, so every
// product of two bf16 values is exact in fp32 and only the sums round, as on
// the TPU. u8 corpora: codes widen to fp32 and multiply the full fp32 query.
// The TPU instead splits the query into a hi/lo bf16 pair
// (innr_tpu/kernels/knn.py:236-261); the two differ by about 2^-18 relative
// per product. With integer-valued inputs every score is exact in both and
// the kernel agrees with the plain version bit for bit.
//
// Design. knn_scan: grid (corpus slabs x query tiles of 32). A CTA walks
// its slab in tiles of 128 rows; for each tile it stages 32-dimension
// chunks of the rows (transposed) and of its queries in shared memory, and
// each thread accumulates a 4-row x 4-query register tile. The next
// chunk's global loads go into registers before the current chunk's FMAs,
// so they are in flight while it computes; they are 16-byte vector loads
// when D is a multiple of 4 (f32), 8 (bf16) or 16 (u8). Warp w owns
// queries 4w..4w+3 for all 128 rows of the tile, so it keys and selects its
// candidates straight from registers into its queries' sorted top-k
// buffers in shared memory (a one-compare reject against the k-th best,
// then a warp-parallel sorted insert for the rare improving candidate).
// The slab's top k per query goes to partial[(slab, q, k)]. knn_merge: one
// CTA per query selects the final top k from all slabs' partials the same
// way. Keys are unique composites, so the two-level selection equals one
// sequential stream exactly.
//
// The pruned scan (innr_knn_scan_tiles) replaces the TPU kernels
// innr_tpu/kernels/pruned_knn.py:_pruned_kernel (static grid) and
// _pruned_outer_kernel (dynamic pipeline): the same knn_scan over a survivor
// tile list (its kTiles instantiation). The live tiles order[0..*n_live)
// are cut into chunks of 1024 rows, and the chunks are dealt in turn to one
// wave of resident CTAs (the caller sizes the grid); each CTA runs the body
// above over all its chunks as one load pipeline into one top-k buffer and
// writes one partial list, and knn_merge merges them as for K1. n_live
// stays on the device, so a plan made on the device never waits for the
// host. Composites are unique, so the result equals the full scan's
// whenever the plan keeps every tile that holds a top-k row. A CTA does
// what K1 does per row, on about the surviving fraction of K1's rows, so
// the pruned scan should take about that fraction of the full scan's time.
// (One CTA and list per tile slot, the TPU grid's shape, measured 12% over
// K1 reading every tile, and chunks dealt to K1's slab grid with a fresh
// pipeline per chunk 25%: PERF.md.)
//
// What bounds it on the H100: each corpus byte is read once per query tile
// of 32 and feeds 8 (f32), 16 (bf16) or 32 (u8) fp32 FMAs there, so at
// Q = 32 the FP32 SIMT pipe, not HBM, is the limit: 41 G FMAs for 10M x 128
// take about as long as reading its 5.12 GB. Measured on an H100 80GB HBM3
// at 700 W (PERF.md), the scan runs at 0.1-0.3 of a same-bytes read, bound
// by FMA and shared-memory issue in the 4 x 4 register tile; at large k the
// per-slab sorted inserts dominate. Left on the table for later work: bf16
// and u8 on tensor cores (wgmma, with the u8 hi/lo query split), a larger
// register tile for f32, TMA / cp.async staging with more stages, batched
// inserts for large k, a query-tile width fitted to Q (a Q of 1 still does
// 32 queries' FMAs, and Q > 32 reads the corpus once per 32 queries), and a
// merge that skips slabs by their sorted partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "topk.cuh"  // total_key, composite, warp_insert, warp_offer
#include "vec.cuh"   // widen, Vec16, vector_loads

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 128;                // rows per tile
constexpr int kQueryTile = 32;               // queries per CTA
constexpr int kDimChunk = 32;                // dimensions staged at a time
constexpr int kRowsPerThread = kRowTile / 32;
constexpr int kQueriesPerThread = kQueryTile / kWarps;
constexpr int kRowStride = kRowTile + 1;     // padded: conflict-free transpose

static_assert(kQueriesPerThread == 4, "the float4 query read assumes 4");

// Queries join a bf16 corpus rounded to bf16 (products are then exact).
template <typename T>
__device__ __forceinline__ float query_value(float q) { return q; }
template <>
__device__ __forceinline__ float query_value<__nv_bfloat16>(float q) {
  return __bfloat162float(__float2bfloat16_rn(q));
}

// One (row tile, dimension chunk) of rows and queries, staged in registers
// so that its global loads are in flight while the previous chunk computes.
// kVector: 16-byte loads (needs D % elements-per-16-bytes == 0 and a 16-byte
// aligned corpus); otherwise one element per load.
template <typename T, bool kVector>
struct Stage {
  static constexpr int kVec = kVector ? Vec16<T>::kElems : 1;
  static constexpr int kVecsPerRow = kDimChunk / kVec;
  static constexpr int kLoads = kRowTile * kVecsPerRow / kThreads;
  static constexpr int kQueryLoads = kQueryTile * kDimChunk / kThreads;
  using Raw = typename std::conditional<kVector, uint4, float>::type;

  Raw rows[kLoads];
  float queries[kQueryLoads];

  __device__ __forceinline__ void load(const T* __restrict__ src, const float* __restrict__ qs,
                                       long long t0, long long row_end, int d0, int d, int q0,
                                       int n_q, int tid) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int f = tid + l * kThreads, r = f / kVecsPerRow, v = f % kVecsPerRow;
      const long long row = t0 + r;
      const int col = d0 + v * kVec;
      const bool ok = row < row_end && col < d;
      const size_t at = static_cast<size_t>(row) * d + col;
      if constexpr (kVector) {
        rows[l] = ok ? *reinterpret_cast<const uint4*>(src + at) : make_uint4(0u, 0u, 0u, 0u);
      } else {
        rows[l] = ok ? widen(src[at]) : 0.0f;
      }
    }
#pragma unroll
    for (int l = 0; l < kQueryLoads; ++l) {
      const int f = tid + l * kThreads, qq = f / kDimChunk, c = f % kDimChunk;
      const int col = d0 + c;
      queries[l] = (q0 + qq < n_q && col < d)
                       ? query_value<T>(qs[static_cast<size_t>(q0 + qq) * d + col])
                       : 0.0f;
    }
  }

  // rows_s[c][r] (padded stride: conflict-free), q_s[c][q].
  __device__ __forceinline__ void store(float* rows_s, float* q_s, int tid) const {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int f = tid + l * kThreads, r = f / kVecsPerRow, v = f % kVecsPerRow;
      if constexpr (kVector) {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          rows_s[(v * kVec + j) * kRowStride + r] = Vec16<T>::get(rows[l], j);
      } else {
        rows_s[v * kRowStride + r] = rows[l];
      }
    }
#pragma unroll
    for (int l = 0; l < kQueryLoads; ++l) {
      const int f = tid + l * kThreads;
      q_s[(f % kDimChunk) * kQueryTile + f / kDimChunk] = queries[l];
    }
  }
};

// CTA x scans the slab of rows [x * slab_rows, (x + 1) * slab_rows). With
// kTiles (the pruned scan) the work is instead the chunks of chunk_rows rows
// of the live tiles order[0..*n_live) of slab_rows rows each, dealt to the
// CTAs in turn (item i to CTA i % gridDim.x); a CTA keeps one top-k buffer
// over all its items and writes one partial list, empty when it had none.
// kTiles is a template parameter so that K1's instantiation carries none of
// the tile list's state.
template <typename T, bool kVector, bool kTiles>
__global__ void __launch_bounds__(kThreads, 2) knn_scan(
    const float* __restrict__ qs, const T* __restrict__ rows,
    const float* __restrict__ aux, const float* __restrict__ mask,
    const long long* __restrict__ excl, const int* __restrict__ order,
    const int* __restrict__ n_live, long long* __restrict__ partial,
    int n_q, long long n, int d, int k, int score, long long slab_rows,
    long long chunk_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* best = reinterpret_cast<long long*>(smem);             // [32][k]
  float* rows_s = reinterpret_cast<float*>(best + kQueryTile * k);  // [32][129]
  float* q_s = rows_s + kDimChunk * kRowStride;                     // [32][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * kQueryTile;
  const int wq0 = q0 + warp * kQueriesPerThread;  // this warp's first query
  const int n_chunks = (d + kDimChunk - 1) / kDimChunk;
  for (int i = tid; i < kQueryTile * k; i += kThreads) best[i] = LLONG_MIN;
  long long bound[kQueriesPerThread];
#pragma unroll
  for (int j = 0; j < kQueriesPerThread; ++j)
    bound[j] = (excl != nullptr && wq0 + j < n_q) ? excl[wq0 + j] : LLONG_MAX;

  float acc[kRowsPerThread][kQueriesPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kQueriesPerThread; ++j) acc[i][j] = 0.0f;

  // One pipeline over all of the CTA's rows: the next chunk's loads, in
  // the same row tile, the next one or (kTiles) the next item, are in flight
  // while the current chunk computes. Without kTiles the rows are one slab.
  Stage<T, kVector> stage;
  long long t0 = static_cast<long long>(blockIdx.x) * slab_rows;
  long long row_end = min(n, t0 + slab_rows);
  long long item = blockIdx.x, per_tile = 1, items = 0;
  // This CTA's next non-empty item after `item` and its rows [t0, end), or
  // an empty range when none is left.
  auto next_item = [&](long long& t0, long long& end) {
    t0 = end = 0;
    for (item += gridDim.x; item < items; item += gridDim.x) {
      const long long tile_begin = order[item / per_tile] * slab_rows;
      t0 = tile_begin + item % per_tile * chunk_rows;
      end = min(n, min(tile_begin + slab_rows, t0 + chunk_rows));
      if (t0 < end) break;
    }
  };
  if constexpr (kTiles) {
    per_tile = (slab_rows + chunk_rows - 1) / chunk_rows;
    items = static_cast<long long>(*n_live) * per_tile;
    item -= gridDim.x;
    next_item(t0, row_end);
  }
  int ch = 0;
  if (t0 < row_end) stage.load(rows, qs, t0, row_end, 0, d, q0, n_q, tid);
  while (t0 < row_end) {
    stage.store(rows_s, q_s, tid);
    __syncthreads();
    int next_ch = ch + 1;
    long long next_t0 = t0, next_end = row_end;
    if (next_ch == n_chunks) {
      next_ch = 0;
      next_t0 += kRowTile;
      if constexpr (kTiles) {
        if (next_t0 >= row_end) next_item(next_t0, next_end);
      }
    }
    if (next_t0 < next_end)
      stage.load(rows, qs, next_t0, next_end, next_ch * kDimChunk, d, q0, n_q, tid);

    const int c_end = min(kDimChunk, d - ch * kDimChunk);
    for (int c = 0; c < c_end; ++c) {
      const float4 qv =
          *reinterpret_cast<const float4*>(&q_s[c * kQueryTile + warp * kQueriesPerThread]);
      const float qa[kQueriesPerThread] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float rv = rows_s[c * kRowStride + lane + 32 * i];
#pragma unroll
        for (int j = 0; j < kQueriesPerThread; ++j) acc[i][j] = fmaf(rv, qa[j], acc[i][j]);
      }
    }
    __syncthreads();

    if (next_ch == 0) {  // the tile's last chunk: key and select its rows
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const long long row = t0 + lane + 32 * i;
        const bool valid = row < row_end;
        const float a = (valid && aux != nullptr) ? aux[row] : 0.0f;
        const bool pass = !(valid && mask != nullptr) || mask[row] > 0.0f;
#pragma unroll
        for (int j = 0; j < kQueriesPerThread; ++j) {
          float s = acc[i][j];
          acc[i][j] = 0.0f;
          if (wq0 + j >= n_q) continue;  // uniform across the warp
          if (score == 1) s = __fsub_rn(a, __fmul_rn(2.0f, s));
          else if (score == 2) s = __fmul_rn(s, a);
          int key = total_key(s);
          if (score == 1) key = ~key;
          if (!pass) key = INT_MIN;
          long long c = composite(key, row);
          if (!valid || c >= bound[j]) c = LLONG_MIN;
          warp_offer(best + (warp * kQueriesPerThread + j) * k, k, c, lane);
        }
      }
    }
    t0 = next_t0;
    row_end = next_end;
    ch = next_ch;
  }
  __syncthreads();
  for (int f = tid; f < kQueryTile * k; f += kThreads) {
    const int q = q0 + f / k;
    if (q < n_q)
      partial[(static_cast<size_t>(blockIdx.x) * n_q + q) * k + f % k] = best[f];
  }
}

// One CTA per query: the top k of n_slabs sorted partial lists of length k.
__global__ void __launch_bounds__(kThreads) knn_merge(
    const long long* __restrict__ partial, long long* __restrict__ out,
    int n_q, int n_slabs, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* bufs = reinterpret_cast<long long*>(smem);  // [8][k]
  const int q = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long* mine = bufs + warp * k;
  for (int i = lane; i < k; i += 32) mine[i] = LLONG_MIN;
  __syncwarp();
  const long long total = static_cast<long long>(n_slabs) * k;
  for (long long base = warp * 32; base < total; base += kThreads) {
    const long long f = base + lane;
    long long c = LLONG_MIN;
    if (f < total) c = partial[(static_cast<size_t>(f / k) * n_q + q) * k + f % k];
    warp_offer(mine, k, c, lane);
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kWarps; ++w)
    for (int base = 0; base < k; base += 32) {
      const int i = base + lane;
      warp_offer(mine, k, i < k ? bufs[w * k + i] : LLONG_MIN, lane);
    }
  for (int i = lane; i < k; i += 32) out[static_cast<size_t>(q) * k + i] = mine[i];
}

// The rows a launch scans and how they are cut: n_ctas slabs of slab_rows
// rows, or (order != null) the chunks of chunk_rows rows of the tiles
// order[0..*n_live) of slab_rows rows each, over n_ctas CTAs.
struct Slabs {
  const int* order;
  const int* n_live;
  long long slab_rows;
  long long chunk_rows;
  long long n_ctas;
};

template <typename T, bool kVector, bool kTiles>
cudaError_t launch_scan_as(const float* qs, const T* rows, const float* aux, const float* mask,
                           const long long* excl, long long* partial, int n_q, long long n,
                           int d, int k, int score, Slabs slabs, cudaStream_t stream) {
  const size_t smem = sizeof(long long) * kQueryTile * k +
                      sizeof(float) * kDimChunk * (kRowStride + kQueryTile);
  cudaError_t err = cudaFuncSetAttribute(knn_scan<T, kVector, kTiles>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(slabs.n_ctas), (n_q + kQueryTile - 1) / kQueryTile);
  knn_scan<T, kVector, kTiles><<<grid, kThreads, smem, stream>>>(
      qs, rows, aux, mask, excl, slabs.order, slabs.n_live, partial, n_q, n, d, k, score,
      slabs.slab_rows, slabs.chunk_rows);
  return cudaGetLastError();
}

template <typename T, bool kTiles>
cudaError_t launch_scan_tiled(const float* qs, const T* rows, const float* aux,
                              const float* mask, const long long* excl, long long* partial,
                              int n_q, long long n, int d, int k, int score, Slabs slabs,
                              cudaStream_t stream) {
  return vector_loads(rows, d)
             ? launch_scan_as<T, true, kTiles>(qs, rows, aux, mask, excl, partial, n_q, n, d, k,
                                               score, slabs, stream)
             : launch_scan_as<T, false, kTiles>(qs, rows, aux, mask, excl, partial, n_q, n, d,
                                                k, score, slabs, stream);
}

template <typename T>
cudaError_t launch_scan(const float* qs, const void* rows_v, const float* aux, const float* mask,
                        const long long* excl, long long* partial, int n_q, long long n, int d,
                        int k, int score, Slabs slabs, cudaStream_t stream) {
  const T* rows = static_cast<const T*>(rows_v);
  return slabs.order != nullptr
             ? launch_scan_tiled<T, true>(qs, rows, aux, mask, excl, partial, n_q, n, d, k,
                                          score, slabs, stream)
             : launch_scan_tiled<T, false>(qs, rows, aux, mask, excl, partial, n_q, n, d, k,
                                           score, slabs, stream);
}

int scan(const void* qs, const void* rows, int dtype, const void* aux, const void* mask,
         const void* excl, void* partial, int n_q, long long n, int d, int k, int score,
         Slabs slabs, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qs);
  auto a = static_cast<const float*>(aux);
  auto m = static_cast<const float*>(mask);
  auto e = static_cast<const long long*>(excl);
  auto p = static_cast<long long*>(partial);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_scan<float>(q, rows, a, m, e, p, n_q, n, d, k, score, slabs, s);
      break;
    case 1:
      err = launch_scan<__nv_bfloat16>(q, rows, a, m, e, p, n_q, n, d, k, score, slabs, s);
      break;
    case 2:
      err = launch_scan<uint8_t>(q, rows, a, m, e, p, n_q, n, d, k, score, slabs, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 u8. score: 0 dot, 1 l2, 2 cosine. aux, mask and
// excl may be null. partial: (ceil(n / slab_rows), n_q, k) int64.
// Returns the cudaError_t of the launch (0 on success).
int innr_knn_scan(const void* qs, const void* rows, int dtype, const void* aux,
                  const void* mask, const void* excl, void* partial, int n_q, long long n,
                  int d, int k, int score, int slab_rows, void* stream) {
  if (n_q <= 0 || n <= 0 || d <= 0 || k <= 0 || slab_rows <= 0 || slab_rows % kRowTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Slabs slabs{nullptr, nullptr, slab_rows, slab_rows, (n + slab_rows - 1) / slab_rows};
  return scan(qs, rows, dtype, aux, mask, excl, partial, n_q, n, d, k, score, slabs, stream);
}

// The pruned scan: the same scan over the tiles order[0..*n_live) of
// tile_rows rows each (any tile_rows >= 1), cut into chunks of chunk_rows
// rows and dealt to n_ctas CTAs; n_live is read on the device. order:
// (n_tiles,) int32 tile ids, the live ones ascending; n_live: one int32 on
// the device; excl may be null; partial: (n_ctas, n_q, k) int64, every list
// written (empty for a CTA without work), for innr_knn_merge.
int innr_knn_scan_tiles(const void* qs, const void* rows, int dtype, const void* aux,
                        const void* mask, const void* excl, const void* order,
                        const void* n_live, void* partial, int n_q, long long n, int d, int k,
                        int score, long long tile_rows, long long chunk_rows, int n_ctas,
                        void* stream) {
  if (n_q <= 0 || n <= 0 || d <= 0 || k <= 0 || tile_rows <= 0 || chunk_rows <= 0 ||
      n_ctas <= 0 || order == nullptr || n_live == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Slabs slabs{static_cast<const int*>(order), static_cast<const int*>(n_live), tile_rows,
                    chunk_rows, n_ctas};
  return scan(qs, rows, dtype, aux, mask, excl, partial, n_q, n, d, k, score, slabs, stream);
}

// partial: (n_slabs, n_q, k) int64 from either scan; out: (n_q, k) int64.
int innr_knn_merge(const void* partial, void* out, int n_q, int n_slabs, int k, void* stream) {
  if (n_q <= 0 || n_slabs <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(long long) * kWarps * k;
  cudaError_t err = cudaFuncSetAttribute(
      knn_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_merge<<<n_q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(partial), static_cast<long long*>(out), n_q, n_slabs, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
