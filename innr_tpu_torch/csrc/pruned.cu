// Tile-skipping threshold scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels innr_tpu/kernels/pruned_knn.py:
// _threshold_kernel_1q (static grid, _threshold_raw) and
// _threshold_outer_kernel (dynamic pipeline, _threshold_raw_dynamic). For
// one f32 query q (D,) against a row-major (N, D) f32 or bf16 corpus and a
// survivor plan (the tiles order[0..*n_live) of tile_rows rows each) it
// scores every row r of a live tile as
//     s(r) = norms2[r] - 2 (q . r)          (the L2^2 without ||q||^2)
// The dot accumulates fp32 FMAs from +0.0, no TF32: a warp takes 4 rows at
// a time, its lanes on consecutive 16-byte vectors of each row (where D %
// elements-per-16-bytes == 0 and the corpus is 16-byte aligned; one
// element per load otherwise), and each row's lane sums are reduced by
// shuffles, so both kernels below give the same bits for a row. bf16 rows
// are widened and the query is NOT rounded: the TPU kernel's dot takes the
// f32 query against the widened rows, unlike the kNN scan's bf16 rule
// (knn.cu). n_live is read on the device. Two kernels:
//
// threshold_dense: K15's own contract, out (N,) = s(r) on live rows and
// +inf on the rest, in one launch. The TPU kernel writes every tile of its
// output block; here every CTA marks the live tiles in a shared-memory
// bitmap, writes +inf (streaming stores) over its share of the rows of dead
// tiles, then scores its share of the live rows: the live rows, laid end to
// end in plan order, are cut into one equal span a CTA, so a handful of
// live tiles spreads over every SM with no second, partly filled round.
//
// threshold_compact: what batch_l2_squared_pruning needs, (row, d) for the
// rows with d = s(r) + qq not above the threshold and not NaN, rows
// ascending, where qq = ||q||^2 is a device scalar. The live rows go in
// chunks of 256, one row a thread, handed out by a ticket counter in plan
// order; a chunk's kept rows are ranked by warp ballots, and its place in
// the output comes from a chained scan over the chunks (each publishes its
// count, then looks back over its predecessors' counts to the first
// inclusive prefix: the decoupled look-back of a single-pass prefix scan).
// So the pairs land in row order (the plan's live tiles ascending) in one
// pass, dead tiles are never read, and nothing of size N is written.
//
// What bounds both on the H100: one read of the surviving rows and their
// norms (D FMAs per row, far below the FP32 rate); the dense form adds the
// (N,) write.
//
// threshold_plan: the survivor plan that batch_l2_squared_pruning scans,
// its elementwise steps, partition and padding in one launch where the
// plain version (prune.plan_threshold_survivors) makes about 25.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <mutex>
#include <type_traits>

#include "vec.cuh"  // widen, Vec16, vector_loads

#ifndef INNR_THRESHOLD_FILL
#define INNR_THRESHOLD_FILL 1  // 0: the dense kernel leaves dead rows unwritten (probe)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kChunkRows = kThreads;  // rows of one compact-kernel chunk
constexpr unsigned long long kAggregate = 1ull << 62;  // a chunk's own count
constexpr unsigned long long kInclusive = 2ull << 62;  // count through this chunk
constexpr unsigned long long kValue = (1ull << 62) - 1;

// The dots q . r of 4 rows r..r+3 (rows at or past row_end read 0), every
// lane getting the sums.
template <typename T, bool kVector>
__device__ __forceinline__ void warp_dots(const float* q_s, const T* __restrict__ rows,
                                          long long r, long long row_end, int d,
                                          float (&s)[kRowsPerWarp]) {
  constexpr int kVec = kVector ? Vec16<T>::kElems : 1;
  using Raw = typename std::conditional<kVector, uint4, float>::type;
  const int lane = threadIdx.x & 31;
  const int per_row = d / kVec;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) s[j] = 0.0f;
  for (int v = lane; v < per_row; v += 32) {
    Raw raw[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const bool ok = r + j < row_end;
      const size_t at = static_cast<size_t>(r + j) * d + static_cast<size_t>(v) * kVec;
      if constexpr (kVector) {
        raw[j] = ok ? *reinterpret_cast<const uint4*>(rows + at) : make_uint4(0u, 0u, 0u, 0u);
      } else {
        raw[j] = ok ? widen(rows[at]) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      if constexpr (kVector) {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          s[j] = fmaf(Vec16<T>::get(raw[j], e), q_s[v * kVec + e], s[j]);
      } else {
        s[j] = fmaf(raw[j], q_s[v], s[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j)
    for (int o = 16; o > 0; o >>= 1) s[j] += __shfl_xor_sync(0xFFFFFFFFu, s[j], o);
}

__device__ __forceinline__ float score(float norm2, float s) {
  return __fsub_rn(norm2, __fmul_rn(2.0f, s));
}

__device__ __forceinline__ void load_query(float* q_s, const float* __restrict__ q, int d) {
  for (int i = threadIdx.x; i < d; i += kThreads) q_s[i] = q[i];
}

// out[r] = s(r) for the rows [row0, row_end), the warps 4 rows apart.
template <typename T, bool kVector>
__device__ void span_dists(const float* q_s, const T* __restrict__ rows,
                           const float* __restrict__ norms2, float* __restrict__ out,
                           long long row0, long long row_end, int d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long r = row0 + warp * kRowsPerWarp; r < row_end; r += kWarps * kRowsPerWarp) {
    float s[kRowsPerWarp];
    warp_dots<T, kVector>(q_s, rows, r, row_end, d, s);
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
      if (lane == j && r + j < row_end) out[r + j] = score(norms2[r + j], s[j]);
  }
}

// CTA b of G: +inf over the dead tiles' rows of [n b / G, n (b + 1) / G),
// then s(r) over its span of the live rows laid end to end.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads) threshold_dense(
    const float* __restrict__ q, const T* __restrict__ rows, const float* __restrict__ norms2,
    const int* __restrict__ order, const int* __restrict__ n_live, float* __restrict__ out,
    long long n, int d, long long tile_rows, int n_tiles) {
  extern __shared__ float q_s[];  // [d], then the live-tile bitmap
  unsigned* live = reinterpret_cast<unsigned*>(q_s + d);
  const int words = (n_tiles + 31) / 32;
  const int n_alive = min(max(*n_live, 0), n_tiles);
  load_query(q_s, q, d);
  for (int i = threadIdx.x; i < words; i += kThreads) live[i] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < n_alive; i += kThreads) {
    const int t = order[i];
    atomicOr(&live[t >> 5], 1u << (t & 31));
  }
  __syncthreads();
  const long long b = blockIdx.x, g = gridDim.x;
#if INNR_THRESHOLD_FILL
  {
    const long long lo = n * b / g, hi = n * (b + 1) / g;
    for (long long t = lo / tile_rows; t * tile_rows < hi; ++t) {
      if (live[t >> 5] >> (t & 31) & 1u) continue;
      const long long end = min(hi, (t + 1) * tile_rows);
      for (long long r = max(lo, t * tile_rows) + threadIdx.x; r < end; r += kThreads)
        __stcs(out + r, __int_as_float(0x7F800000));
    }
  }
#endif
  const long long total = static_cast<long long>(n_alive) * tile_rows;
  long long j = total * b / g;
  const long long hi = total * (b + 1) / g;
  while (j < hi) {
    const long long slot = j / tile_rows, off = j - slot * tile_rows;
    const long long take = min(hi - j, tile_rows - off);
    const long long row0 = static_cast<long long>(order[slot]) * tile_rows + off;
    span_dists<T, kVector>(q_s, rows, norms2, out, row0, min(n, row0 + take), d);
    j += take;
  }
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The kept rows of chunk `item` come after this many kept rows of the
// chunks before it: publish this chunk's count, sum the predecessors'
// counts back to the first inclusive prefix, publish the inclusive count.
// One thread; each status word holds its flag and its count, so a relaxed
// load sees both at once and no other data crosses CTAs. A predecessor
// holds its ticket while it runs, so the wait ends; should a status never
// come (a fault), the wait gives up after a second or so and sets
// scratch[2] bit 1, which the wrapper raises on, rather than hang the card.
__device__ long long chain_prefix(unsigned long long* status, unsigned long long* flags,
                                  long long item, long long count) {
  if (item == 0) {
    store_status(status, kInclusive | static_cast<unsigned long long>(count));
    return 0;
  }
  store_status(status + item, kAggregate | static_cast<unsigned long long>(count));
  long long prefix = 0;
  for (long long j = item - 1;; --j) {
    unsigned long long w;
    for (int spins = 0; ((w = load_status(status + j)) & ~kValue) == 0; ++spins) {
      if (spins == (1 << 21)) {
        atomicOr(flags, 2ull);
        w = kInclusive;
        break;
      }
      __nanosleep(64);
    }
    prefix += static_cast<long long>(w & kValue);
    if (w & kInclusive) break;
  }
  store_status(status + item, kInclusive | static_cast<unsigned long long>(prefix + count));
  return prefix;
}

// The rank of this thread's set `flag` among the block's, in thread order,
// and (in `total`) how many are set: a ballot a warp, then a scan of the
// warps' counts. Two barriers; warp_base holds one int a warp and one more.
template <int kBlockThreads>
__device__ __forceinline__ int block_rank(bool flag, int* warp_base, int& total) {
  constexpr int kBlockWarps = kBlockThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, flag);
  if (lane == 0) warp_base[warp + 1] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    warp_base[0] = 0;
    for (int w = 0; w < kBlockWarps; ++w) warp_base[w + 1] += warp_base[w];
  }
  __syncthreads();
  total = warp_base[kBlockWarps];
  return warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
}

// Chunks of kChunkRows live rows, in plan order, by ticket; kept_row[k] and
// kept_dist[k] are the row and d of the k-th kept row. scratch[0]: the
// ticket counter; [1]: M, the kept rows in all; [2]: bit 0 when the live
// tiles are not ascending (rows would come out of order), bit 1 when a
// look-back gave up; [3 + i]: chunk i's status. The launcher zeroes the
// scratch first.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads) threshold_compact(
    const float* __restrict__ q, const T* __restrict__ rows, const float* __restrict__ norms2,
    const int* __restrict__ order, const int* __restrict__ n_live, const float* __restrict__ qq,
    float threshold, long long* __restrict__ kept_row, float* __restrict__ kept_dist,
    unsigned long long* scratch, long long n, int d,
    long long tile_rows, int n_tiles) {
  extern __shared__ float q_s[];  // [d]
  __shared__ float d_s[kChunkRows];
  __shared__ int warp_base[kWarps + 1];
  __shared__ long long item_s, prefix_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  static_assert(kChunkRows == kThreads, "one row of a chunk a thread");
  load_query(q_s, q, d);
  const float qq_v = *qq;
  const long long per_tile = (tile_rows + kChunkRows - 1) / kChunkRows;
  const long long items = static_cast<long long>(min(max(*n_live, 0), n_tiles)) * per_tile;
  unsigned long long* status = scratch + 3;
  for (;;) {
    if (threadIdx.x == 0) item_s = static_cast<long long>(atomicAdd(scratch, 1ull));
    __syncthreads();  // item_s and q_s visible; d_s and prefix_s free again
    const long long item = item_s;
    if (item >= items) break;
    const long long slot = item / per_tile;
    const long long tile_begin = static_cast<long long>(order[slot]) * tile_rows;
    if (threadIdx.x == 0 && slot > 0 && item % per_tile == 0 && order[slot] <= order[slot - 1])
      atomicOr(scratch + 2, 1ull);  // the live tiles are not ascending: the wrapper raises
    const long long row0 = tile_begin + item % per_tile * kChunkRows;
    const long long row_end = min(n, min(tile_begin + tile_rows, row0 + kChunkRows));
    for (long long r = row0 + warp * kRowsPerWarp; r < row_end; r += kWarps * kRowsPerWarp) {
      float s[kRowsPerWarp];
      warp_dots<T, kVector>(q_s, rows, r, row_end, d, s);
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j)
        if (lane == j && r + j < row_end)
          d_s[r + j - row0] = __fadd_rn(score(norms2[r + j], s[j]), qq_v);
    }
    __syncthreads();
    const float dist = d_s[threadIdx.x];
    const bool keep = row0 + threadIdx.x < row_end && !(dist > threshold) && !isnan(dist);
    int count;
    const int rank = block_rank<kThreads>(keep, warp_base, count);
    if (threadIdx.x == 0) {
      const long long prefix = chain_prefix(status, scratch + 2, item, count);
      if (item == items - 1) scratch[1] = static_cast<unsigned long long>(prefix + count);
      prefix_s = prefix;
    }
    __syncthreads();
    if (keep) {
      const long long at = prefix_s + rank;
      // Within the capacity n unless tiles repeat, which scratch[2] reports.
      if (at < n) {
        kept_row[at] = row0 + threadIdx.x;
        kept_dist[at] = dist;
      }
    }
  }
}

// The threshold plan (prune.plan_threshold_survivors) after its product
// qd = qs @ cent.T (Q, T), qq = ||q||^2 (Q,) and cc = ||c||^2 (T,), which
// the caller makes with the plan's own torch calls: every elementwise step
// of the plan rounded as torch rounds it, one op at a time (no
// contraction), then the stable partition (live tiles ascending) and the
// padded tail (the last live tile, or tile 0 when none lives), in one CTA.
// A tile lives when some query's lower bound max(0, ||q - c|| - r)^2 is
// not above threshold + slack (NaN: lives).
constexpr int kPlanThreads = 1024;

__global__ void __launch_bounds__(kPlanThreads) threshold_plan(
    const float* __restrict__ qd, const float* __restrict__ qq, const float* __restrict__ cc,
    const float* __restrict__ rad, int n_q, int n_tiles, float threshold, float eps,
    int* __restrict__ order, int* __restrict__ n_surv, bool* __restrict__ alive) {
  __shared__ int warp_base[kPlanThreads / 32 + 1];
  int base = 0;  // live tiles before this chunk (the same in every thread)
  for (int t0 = 0; t0 < n_tiles; t0 += kPlanThreads) {
    const int t = t0 + threadIdx.x;
    bool live = false;
    if (t < n_tiles) {
      const float c = cc[t], r = rad[t];
      for (int q = 0; q < n_q; ++q) {
        const float d = qd[static_cast<size_t>(q) * n_tiles + t];
        const float a = __fadd_rn(qq[q], c);                       // qq + cc
        float g = __fsub_rn(a, __fmul_rn(2.0f, d));                // - 2 qd
        g = isnan(g) ? g : fmaxf(g, 0.0f);                         // clamp_min(0)
        float lower = __fsub_rn(__fsqrt_rn(g), r);                 // ||q - c|| - r
        lower = isnan(lower) ? lower : fmaxf(lower, 0.0f);
        const float slack = __fmul_rn(eps, __fadd_rn(a, __fmul_rn(2.0f, fabsf(d))));
        live |= !(__fmul_rn(lower, lower) > __fadd_rn(slack, threshold));
      }
      alive[t] = live;
    }
    int count;
    const int rank = block_rank<kPlanThreads>(live, warp_base, count);
    if (live) order[base + rank] = t;
    base += count;
    __syncthreads();  // warp_base free again; this chunk's order entries visible
  }
  const int last = base > 0 ? order[base - 1] : 0;
  for (int i = base + threadIdx.x; i < n_tiles; i += kPlanThreads) order[i] = last;
  if (threadIdx.x == 0) *n_surv = base;
}

// Resident CTAs of a kernel on this card: cached per device and shared
// memory size, so a call queries the CUDA runtime only on its first.
template <auto Kernel>
int resident_ctas(size_t smem) {
  static std::mutex lock;
  static int cached_dev = -1, cached_ctas = 0;
  static size_t cached_smem = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> hold(lock);
  if (dev == cached_dev && smem == cached_smem) return cached_ctas;
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, smem) !=
          cudaSuccess)
    return 0;
  cached_dev = dev;
  cached_smem = smem;
  cached_ctas = sms * per_sm;
  return cached_ctas;
}

struct Plan {
  const int* order;
  const int* n_live;
  long long tile_rows;
  int n_tiles;
  int n_ctas;  // <= 0: one wave of resident CTAs
};

template <typename T, bool kVector>
cudaError_t dense_as(const float* q, const T* rows, const float* norms2, float* out, long long n,
                     int d, Plan p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * d + sizeof(unsigned) * ((p.n_tiles + 31) / 32);
  const int wave = resident_ctas<threshold_dense<T, kVector>>(smem);
  if (wave <= 0) return cudaErrorInvalidConfiguration;
  threshold_dense<T, kVector><<<p.n_ctas > 0 ? p.n_ctas : wave, kThreads, smem, stream>>>(
      q, rows, norms2, p.order, p.n_live, out, n, d, p.tile_rows, p.n_tiles);
  return cudaGetLastError();
}

template <typename T, bool kVector>
cudaError_t compact_as(const float* q, const T* rows, const float* norms2, const float* qq,
                       float threshold, long long* kept_row, float* kept_dist,
                       unsigned long long* scratch, long long n,
                       int d, Plan p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * d;
  const long long chunks = static_cast<long long>(p.n_tiles) *
                           ((p.tile_rows + kChunkRows - 1) / kChunkRows);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (3 + chunks),
                                    stream);
  if (err != cudaSuccess) return err;
  const int wave = resident_ctas<threshold_compact<T, kVector>>(smem);
  if (wave <= 0) return cudaErrorInvalidConfiguration;
  const long long ctas = min(static_cast<long long>(p.n_ctas > 0 ? p.n_ctas : wave), chunks);
  threshold_compact<T, kVector><<<static_cast<int>(ctas), kThreads, smem, stream>>>(
      q, rows, norms2, p.order, p.n_live, qq, threshold, kept_row, kept_dist, scratch, n, d,
      p.tile_rows,
      p.n_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dense(const float* q, const void* rows_v, const float* norms2, float* out,
                  long long n, int d, Plan p, cudaStream_t stream) {
  const T* rows = static_cast<const T*>(rows_v);
  return vector_loads(rows, d) ? dense_as<T, true>(q, rows, norms2, out, n, d, p, stream)
                               : dense_as<T, false>(q, rows, norms2, out, n, d, p, stream);
}

template <typename T>
cudaError_t compact(const float* q, const void* rows_v, const float* norms2, const float* qq,
                    float threshold, long long* kept_row, float* kept_dist,
                    unsigned long long* scratch, long long n,
                    int d, Plan p, cudaStream_t stream) {
  const T* rows = static_cast<const T*>(rows_v);
  return vector_loads(rows, d)
             ? compact_as<T, true>(q, rows, norms2, qq, threshold, kept_row, kept_dist, scratch,
                                   n, d, p, stream)
             : compact_as<T, false>(q, rows, norms2, qq, threshold, kept_row, kept_dist, scratch,
                                    n, d, p,
                                    stream);
}

bool valid(long long n, int d, long long tile_rows, int n_tiles, const void* order,
           const void* n_live) {
  return n > 0 && d > 0 && tile_rows > 0 && n_tiles > 0 &&
         static_cast<long long>(n_tiles) * tile_rows >= n && order != nullptr &&
         n_live != nullptr;
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16. q: (d,) f32; rows: (n, d); norms2: (n,) f32;
// order: (n_tiles,) int32 tile ids; n_live: one int32 on the device; out:
// (n,) f32, every row written (s(r) on the tiles order[0..*n_live), +inf
// elsewhere). n_ctas <= 0: one wave of resident CTAs. Returns the
// cudaError_t of the launch (0 on success).
int innr_threshold_scan(const void* q, const void* rows, int dtype, const void* norms2,
                        const void* order, const void* n_live, void* out, long long n, int d,
                        long long tile_rows, int n_tiles, int n_ctas, void* stream) {
  if (!valid(n, d, tile_rows, n_tiles, order, n_live))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{static_cast<const int*>(order), static_cast<const int*>(n_live), tile_rows,
               n_tiles, n_ctas};
  auto qf = static_cast<const float*>(q);
  auto nr = static_cast<const float*>(norms2);
  auto res = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dense<float>(qf, rows, nr, res, n, d, p, s));
    case 1:
      return static_cast<int>(dense<__nv_bfloat16>(qf, rows, nr, res, n, d, p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Header words of the compact kernel's buffer for this plan shape: the
// ticket counter, M, the flags and one status a chunk. The kept rows (n
// int64) and their distances (n f32) follow.
long long innr_threshold_header_words(long long tile_rows, int n_tiles) {
  return 3 + static_cast<long long>(n_tiles) * ((tile_rows + kChunkRows - 1) / kChunkRows);
}

// The same scores plus qq (one f32 on the device), kept where not above
// `threshold` and not NaN. buf: innr_threshold_header_words + n + n / 2
// (rounded up) 64-bit words, its header zeroed here on the stream. After
// the launch buf[1] is M, buf[2] bit 0 is set when order[0..*n_live) is
// not ascending (the rows are then out of order) and bit 1 when a
// look-back gave up waiting (a fault); the M kept rows, ascending, start
// at word `header`, their distances at word `header + n`.
int innr_threshold_compact(const void* q, const void* rows, int dtype, const void* norms2,
                           const void* order, const void* n_live, const void* qq,
                           float threshold, void* buf, long long n, int d, long long tile_rows,
                           int n_tiles, int n_ctas, void* stream) {
  if (!valid(n, d, tile_rows, n_tiles, order, n_live) || qq == nullptr || buf == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{static_cast<const int*>(order), static_cast<const int*>(n_live), tile_rows,
               n_tiles, n_ctas};
  auto qf = static_cast<const float*>(q);
  auto nr = static_cast<const float*>(norms2);
  auto qqf = static_cast<const float*>(qq);
  auto sc = static_cast<unsigned long long*>(buf);
  auto kr = reinterpret_cast<long long*>(sc + innr_threshold_header_words(tile_rows, n_tiles));
  auto kd = reinterpret_cast<float*>(kr + n);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          compact<float>(qf, rows, nr, qqf, threshold, kr, kd, sc, n, d, p, s));
    case 1:
      return static_cast<int>(
          compact<__nv_bfloat16>(qf, rows, nr, qqf, threshold, kr, kd, sc, n, d, p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// After innr_threshold_compact on `stream`: M and the flags (buf[1], buf[2])
// into m_flags on the host, one 16-byte copy that waits for the stream.
int innr_threshold_count(const void* buf, long long* m_flags, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(m_flags, static_cast<const long long*>(buf) + 1,
                                    2 * sizeof(long long), cudaMemcpyDeviceToHost, s);
  return static_cast<int>(err == cudaSuccess ? cudaStreamSynchronize(s) : err);
}

// Then the M kept rows (int64) and distances (f32) into host memory.
int innr_threshold_copy(const void* buf, long long header, long long n, long long m, void* row,
                        void* dist, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const long long* kr = static_cast<const long long*>(buf) + header;
  cudaError_t err = cudaMemcpyAsync(row, kr, m * sizeof(long long), cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(dist, reinterpret_cast<const float*>(kr + n), m * sizeof(float),
                          cudaMemcpyDeviceToHost, s);
  return static_cast<int>(err == cudaSuccess ? cudaStreamSynchronize(s) : err);
}

// The threshold plan: qd (n_q, n_tiles), qq (n_q,), cc (n_tiles,), rad
// (n_tiles,) f32 on the device -> order (n_tiles,) int32, n_surv (one
// int32), alive (n_tiles,) bool. threshold and eps as float32. No query
// (n_q = 0): every tile dead, as the plain version's all() over none.
int innr_threshold_plan(const void* qd, const void* qq, const void* cc, const void* rad, int n_q,
                        int n_tiles, float threshold, float eps, void* order, void* n_surv,
                        void* alive, void* stream) {
  if (n_q < 0 || n_tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  threshold_plan<<<1, kPlanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qd), static_cast<const float*>(qq),
      static_cast<const float*>(cc), static_cast<const float*>(rad), n_q, n_tiles, threshold,
      eps, static_cast<int*>(order), static_cast<int*>(n_surv), static_cast<bool*>(alive));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
