// Slot-sketch (MinHash) kNN scans for Hopper (sm_90a), plain C interface.
//
// Replace two TPU kernels of innr_tpu/kernels/slot_knn.py:
//   _slot_kernel     (fused_slot_knn)        one sketch
//   _slot_kernel_mq  (fused_slot_knn_batch)  a batch of sketches
// The query count is a runtime parameter, so the single-sketch form is the
// Q = 1 case of either scan.
//
// Inputs are slot-major: the corpus is (S, N) uint32 or uint16 slots (the
// JAX package's cached SketchCorpus.slots_t), the queries (Q, S) of the
// same type. Per corpus row and query, count = #{s : row_s != q_s}, the
// differing-slot count; key = -count goes into the int64 composites of
// topk.cuh, so selection is the k smallest counts, ties to the lowest row,
// as the TPU kernels' update_topk selects. Counts are exact integers, so
// both scans give the same result as the plain version, bit for bit.
//
// Two scans; the wrapper (kernels/slot_knn.py:plan) picks one by the query
// tile, at the crossover scripts/slot_probe.py measured (compare up to 4).
//
// slot_compare<T, QT> (tiles of 1, 2 or 4 queries; the single sketch): a
// compare and an add per (row, slot, query). Each thread takes 16 / sizeof(T)
// neighbouring rows (8 uint16 or 4 uint32) and reads slot s of them as one
// 16-byte vector; the warp's 32 vectors are 512 contiguous bytes, and four
// slots' vectors are in flight per thread (64 bytes), so the read is not
// held back by bytes in flight. Where N is not a multiple of the vector,
// slot rows start off 16-byte boundaries: uint32 vectors are then four word
// loads, and uint16 ones are shifted out of two aligned vectors (the second
// the neighbour's, from L1), not built from eight 2-byte loads
// (scripts/torch_kernel_ab.py times both at N = 10,000,001 and 10,000,003).
// uint16 slots compare two rows per 32-bit word: the query's value sits in
// both halves, and a half of the XOR that is not zero is a differing slot.
//
// slot_table<T, QT> (tiles of 8, 16 or 32): one shared-memory lookup per
// (row, slot) serves the whole tile, whatever QT is. Within one slot a
// corpus value can equal only the query values that are the same value, so
// each CTA builds its tile's table in shared memory, per slot:
//   - a filter of 32 words (1024 bits): the value's multiplicative hash p
//     picks word p >> 27 and sets two bits of it (a blocked Bloom filter);
//     the 32 words of a slot lie in the 32 banks, so a warp's 32 lookups at
//     one slot never conflict;
//   - an open-addressing table of QT + QT / 2 + 1 entries (at most two
//     thirds full; linear probing from a second multiplicative hash), each
//     (value, mask of the tile's queries holding that value at this slot);
//     mask 0 is empty.
// One thread builds each slot's part. The scan is one row per thread; the
// warp's loads of one slot are coalesced, and the thread works through its
// row's slots in groups of 64 bytes (32 uint16 or 16 uint32), all of a
// group's loads in flight together. Each (row, slot) tests the filter; only
// where it passed does it probe the table (an 8-byte load, more on a
// collision), and on a hit it adds 1 to the equal count of each query in
// the mask. Key = equal - S = -count. At full-width MinHash slots a miss
// passes the filter about (l + l^2) / 256 of the time, l = QT / 32 (0.3% at
// QT = 16), so the probes are rare; a corpus of near-duplicates (slots from
// few values) passes and hits on every slot and pays a probe and the old
// compare's 2 QT operations there (chip_smoke.py times that case).
//
// Both scans walk their slabs in row tiles, offer the keys through
// row_scan.cuh's TileTopK and leave the slab's partial top k for knn_merge
// (knn.cu).
//
// What bounds it on the H100: the read. 10M x 128 uint32 slots are 5.12 GB,
// about 1.53 ms at 3.35 TB/s (uint16: 0.76 ms); the queries and the result
// are small. The compare scan at Q = 1 reads at the rate of a plain read.
// The table scan's own work at Q = 16 is 1.28 G filter lookups (one
// shared load each, 0.15 ms at 8.4 T/s, without bank conflicts) and about
// a dozen integer instructions each: for uint32 the loads and the filter
// run at the read and the rare probes (a divergent loop) cost the rest; for
// uint16, whose read is half as long, the filter's instructions cost as
// much again. scripts/slot_probe.py times the loads, the filter and the
// whole scan apart; chip_smoke.py prints the counts beside the bound, and
// PERF.md gives the measured times.
//
// INNR_SLOT_PROBE (scripts/slot_probe.py builds these variants; 0 in the
// package): 1 keeps the loads only (each slot folded into one count), 2 the
// loads and the filter (its passes counted, the table never probed).
// INNR_SLOT_TABLE_BYTES (64 in the package): the bytes of slot_table's
// groups, which the probe varies. INNR_SLOT_FILTER (1 in the package): 0
// looks every (row, slot) up in its table directly, without the filter.

#include <cuda_runtime.h>

#include <cstdint>

#include "row_scan.cuh"  // TileTopK, load_query_words, kScan*

#ifndef INNR_SLOT_PROBE
#define INNR_SLOT_PROBE 0
#endif
#ifndef INNR_SLOT_TABLE_BYTES
#define INNR_SLOT_TABLE_BYTES 64
#endif
#ifndef INNR_SLOT_FILTER
#define INNR_SLOT_FILTER 1
#endif

namespace {

constexpr int kProbe = INNR_SLOT_PROBE;
constexpr bool kFilter = INNR_SLOT_FILTER != 0;
constexpr int kModeCompare = 0;
constexpr int kModeTable = 1;
constexpr int kVecSlots = 4;       // slot_compare: 16-byte vectors in flight per thread
constexpr int kFilterWords = 32;   // slot_table: filter words per slot, one per bank
constexpr unsigned kFilterMul = 2654435761u;  // Knuth's multiplicative hash
constexpr unsigned kTableMul = 0x85EBCA6Bu;   // a second odd multiplier

// Rows per thread of slot_compare: one 16-byte vector of a slot.
template <typename T>
__host__ __device__ constexpr int compare_rows() {
  return 16 / static_cast<int>(sizeof(T));
}

// Slots in one group of slot_table (INNR_SLOT_TABLE_BYTES of them).
template <typename T>
__host__ __device__ constexpr int table_group() {
  return INNR_SLOT_TABLE_BYTES / static_cast<int>(sizeof(T));
}

// Table entries per slot: QT + QT / 2 + 1, so at most two thirds full and
// never without an empty entry (QT = 32 then fits two CTAs an SM).
template <int QT>
__host__ __device__ constexpr int table_entries() {
  return QT + QT / 2 + 1;
}

template <typename T, int QT>
__host__ __device__ constexpr size_t compare_smem(int s, int k) {
  return topk_smem_bytes<QT, kScanThreads * compare_rows<T>()>(k) +
         sizeof(unsigned) * static_cast<size_t>(s) * QT;
}

template <int QT>
__host__ __device__ constexpr size_t table_smem(int s, int k) {
  return topk_smem_bytes<QT>(k) +
         static_cast<size_t>(s) * (sizeof(unsigned) * kFilterWords +
                                   sizeof(uint2) * table_entries<QT>());
}

// ---- slot_compare ----------------------------------------------------------

// The 16-byte vector of slot values at p (rows r0 .. r0 + R): one load when
// kVec (every slot's row starts on a 16-byte boundary). Else a slot's row
// starts `off` bytes past one, the same for every thread of the grid (rows
// per thread and slabs are whole vectors): uint32 slots take four word
// loads; uint16 slots read the aligned vector that holds p[0] and, where
// their rows reach past it, the next one (the neighbour's, from L1), and
// shift the pair right by off bytes. Rows past `avail` are left undefined;
// their counts are never offered. kVec is a template parameter so that the
// loads of a group's slots stay in one block and are all in flight before
// the first shift.
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_vector(const T* p, long long avail) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (sizeof(T) == 4) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = i < avail ? __ldg(p + i) : 0u;
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const unsigned off = static_cast<unsigned>(a) & 15u;
    const uint4* b = reinterpret_cast<const uint4*>(a - off);
    const uint4 lo = __ldg(b);
    const uint4 hi = off != 0u && 2 * avail > 16 - off ? __ldg(b + 1) : make_uint4(0u, 0u, 0u, 0u);
    const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    // A barrel shift right by off bytes: one word, two words, then 16 bits.
    unsigned u[7], s[5];
#pragma unroll
    for (int j = 0; j < 7; ++j) u[j] = off & 4u ? w[j + 1] : w[j];
#pragma unroll
    for (int i = 0; i < 5; ++i) s[i] = off & 8u ? u[i + 2] : u[i];
    const unsigned r = (off & 2u) * 8u;
    return make_uint4(__funnelshift_r(s[0], s[1], r), __funnelshift_r(s[1], s[2], r),
                      __funnelshift_r(s[2], s[3], r), __funnelshift_r(s[3], s[4], r));
  }
}

// Add the vector's differing slots to the rows' counts, for each query of
// the tile (query words from shared memory; a uint16 query in both halves).
template <typename T, int QT>
__device__ __forceinline__ void compare_vector(uint4 x, const unsigned* q_words,
                                               int (&acc)[compare_rows<T>()][QT]) {
  unsigned a[QT];
  load_query_words<QT>(q_words, a);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
  if constexpr (kProbe == 1) {
    acc[0][0] += static_cast<int>(w[0] ^ w[1] ^ w[2] ^ w[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      if constexpr (sizeof(T) == 4) {
        acc[i][j] += w[i] != a[j];
      } else {
        const unsigned d = w[i] ^ a[j];
        acc[2 * i][j] += (d & 0xFFFFu) != 0u;
        acc[2 * i + 1][j] += d > 0xFFFFu;
      }
    }
}

template <typename T, int QT, bool kVec>
__global__ void __launch_bounds__(kScanThreads, 2) slot_compare(
    const T* __restrict__ q, const T* __restrict__ slots_t, const long long* __restrict__ excl,
    long long* __restrict__ partial, int n_q, long long n, int s, int k, long long slab_rows) {
  constexpr int R = compare_rows<T>();
  constexpr int kRows = kScanThreads * R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.y * QT;
  TileTopK<QT, kRows> top;
  unsigned* q_s = reinterpret_cast<unsigned*>(top.init(smem, k, excl, q0, n_q));  // [s][QT]
  const int tid = threadIdx.x;
  const long long row_begin = static_cast<long long>(blockIdx.x) * slab_rows;
  const long long row_end = min(n, row_begin + slab_rows);

  for (int i = tid; i < s * QT; i += kScanThreads) {
    const int sl = i / QT, j = q0 + i % QT;
    const unsigned v = j < n_q ? static_cast<unsigned>(q[static_cast<size_t>(j) * s + sl]) : 0u;
    q_s[i] = sizeof(T) == 2 ? v | v << 16 : v;
  }
  __syncthreads();

  for (long long t0 = row_begin; t0 < row_end; t0 += kRows) {
    const long long r0 = t0 + static_cast<long long>(tid) * R;
    int acc[R][QT];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < QT; ++j) acc[r][j] = 0;
    if (r0 < row_end) {
      const T* col = slots_t + r0;
      const long long avail = row_end - r0;
      int sl = 0;
      for (; sl + kVecSlots <= s; sl += kVecSlots) {
        uint4 x[kVecSlots];
#pragma unroll
        for (int u = 0; u < kVecSlots; ++u)
          x[u] = load_vector<T, kVec>(col + static_cast<size_t>(sl + u) * n, avail);
#pragma unroll
        for (int u = 0; u < kVecSlots; ++u) compare_vector<T, QT>(x[u], q_s + (sl + u) * QT, acc);
      }
      for (; sl < s; ++sl)
        compare_vector<T, QT>(load_vector<T, kVec>(col + static_cast<size_t>(sl) * n, avail),
                              q_s + sl * QT, acc);
    }
    // The thread's R rows are contiguous in each query's keys: 16-byte stores.
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int v = 0; v < R / 4; ++v)
        reinterpret_cast<int4*>(top.keys + j * kRows + tid * R)[v] =
            make_int4(-acc[4 * v][j], -acc[4 * v + 1][j], -acc[4 * v + 2][j], -acc[4 * v + 3][j]);
    __syncthreads();
    top.offer(k, t0, row_end, q0, n_q);
  }
  top.write(k, q0, n_q, partial);
}

// ---- slot_table ------------------------------------------------------------

// The two filter bits of hash p within its word p >> 27 (the build's).
__device__ __forceinline__ unsigned filter_bits(unsigned p) {
  return (1u << ((p >> 22) & 31u)) | (1u << ((p >> 17) & 31u));
}

// 1 if filter word w holds both bits of hash p, else 0: two rotations,
// whose amounts the funnel shifter takes mod 32.
__device__ __forceinline__ unsigned filter_passes(unsigned w, unsigned p) {
  return __funnelshift_r(w, w, p >> 22) & __funnelshift_r(w, w, p >> 17) & 1u;
}

// Value v's first entry in a slot's table: its hash scaled to the entries.
template <int QT>
__host__ __device__ __forceinline__ unsigned table_home(unsigned v) {
  return static_cast<unsigned>((static_cast<unsigned long long>(v * kTableMul) *
                                table_entries<QT>()) >> 32);
}

// The mask of the tile's queries holding value v in one slot's table, or 0.
template <int QT>
__device__ __forceinline__ unsigned table_mask(const uint2* __restrict__ t, unsigned v) {
  constexpr unsigned E = table_entries<QT>();
  for (unsigned h = table_home<QT>(v);; h = h + 1 == E ? 0u : h + 1) {
    const uint2 e = t[h];
    if (e.y == 0u) return 0u;
    if (e.x == v) return e.y;
  }
}

// Adds 1 to the equal count of each query in mask m.
template <int QT>
__device__ __forceinline__ void add_mask(unsigned m, int (&acc)[QT]) {
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j] += (m >> j) & 1u;
}

// The equal counts of slots [sl, sl + cnt) of one row (cnt = G unless
// kTail): G loads in flight, G filter lookups, then a table probe for each
// slot whose filter passed. Few passes (full-width slots: 0.3% of them at
// QT = 16) are visited by a loop over the set bits of their mask, the
// value selected in registers (an index would put v in local memory), so
// the probe and the adds run only where a lane needs them; where most
// slots pass (a corpus of near-duplicates) every slot is visited in turn.
template <typename T, int QT, bool kTail>
__device__ __forceinline__ void table_slots(const T* __restrict__ col, long long n, int sl,
                                            int cnt, const unsigned* __restrict__ filt,
                                            const uint2* __restrict__ tab, int (&acc)[QT]) {
  constexpr int G = table_group<T>();
  constexpr int E = table_entries<QT>();
  unsigned v[G];
#pragma unroll
  for (int u = 0; u < G; ++u)
    v[u] = (!kTail || u < cnt) ? static_cast<unsigned>(col[static_cast<size_t>(sl + u) * n]) : 0u;
  if constexpr (kProbe == 1) {
#pragma unroll
    for (int u = 0; u < G; ++u) acc[0] += static_cast<int>(v[u]);
    return;
  }
  unsigned need = 0u;
  if constexpr (kFilter) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const bool in = !kTail || u < cnt;
      const unsigned p = v[u] * kFilterMul;
      const unsigned w = filt[(in ? sl + u : sl) * kFilterWords + (p >> 27)];
      need |= (in ? filter_passes(w, p) : 0u) << u;
    }
  } else {
    // Every slot straight into its table; v[u] becomes the mask found.
#pragma unroll
    for (int u = 0; u < G; ++u) {
      v[u] = (!kTail || u < cnt) ? table_mask<QT>(tab + static_cast<size_t>(sl + u) * E, v[u]) : 0u;
      need |= static_cast<unsigned>(v[u] != 0u) << u;
    }
  }
  if constexpr (kProbe == 2) {
    acc[0] += __popc(need);
    return;
  }
  if (need == 0u) return;
  if (__popc(need) > G / 4) {
#pragma unroll
    for (int u = 0; u < G; ++u)
      if ((need >> u) & 1u)
        add_mask<QT>(kFilter ? table_mask<QT>(tab + static_cast<size_t>(sl + u) * E, v[u]) : v[u],
                     acc);
    return;
  }
  do {
    const int u = __ffs(need) - 1;
    need &= need - 1u;
    unsigned x = v[0];
#pragma unroll
    for (int i = 1; i < G; ++i) x = i == u ? v[i] : x;
    const unsigned m = kFilter ? table_mask<QT>(tab + static_cast<size_t>(sl + u) * E, x) : x;
    if (m != 0u) add_mask<QT>(m, acc);
  } while (need != 0u);
}

template <typename T, int QT>
__global__ void __launch_bounds__(kScanThreads, 2) slot_table(
    const T* __restrict__ q, const T* __restrict__ slots_t, const long long* __restrict__ excl,
    long long* __restrict__ partial, int n_q, long long n, int s, int k, long long slab_rows) {
  constexpr int G = table_group<T>();
  constexpr int E = table_entries<QT>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int q0 = blockIdx.y * QT;
  TileTopK<QT> top;
  unsigned* filt = reinterpret_cast<unsigned*>(top.init(smem, k, excl, q0, n_q));  // [s][32]
  uint2* tab = reinterpret_cast<uint2*>(filt + static_cast<size_t>(s) * kFilterWords);  // [s][E]
  const int tid = threadIdx.x;
  const long long row_begin = static_cast<long long>(blockIdx.x) * slab_rows;
  const long long row_end = min(n, row_begin + slab_rows);

  // One thread builds each slot's filter and table from the tile's values.
  for (int sl = tid; sl < s; sl += kScanThreads) {
    unsigned* f = filt + sl * kFilterWords;
    uint2* t = tab + static_cast<size_t>(sl) * E;
    for (int w = 0; w < kFilterWords; ++w) f[w] = 0u;
    for (int e = 0; e < E; ++e) t[e] = make_uint2(0u, 0u);
    for (int j = 0; j < QT && q0 + j < n_q; ++j) {
      const unsigned v = static_cast<unsigned>(q[static_cast<size_t>(q0 + j) * s + sl]);
      const unsigned p = v * kFilterMul;
      f[p >> 27] |= filter_bits(p);
      unsigned h = table_home<QT>(v);
      while (t[h].y != 0u && t[h].x != v) h = h + 1 == static_cast<unsigned>(E) ? 0u : h + 1;
      t[h].x = v;
      t[h].y |= 1u << j;
    }
  }
  __syncthreads();

  for (long long t0 = row_begin; t0 < row_end; t0 += kScanRowTile) {
    const long long row = t0 + tid;
    int acc[QT];  // equal counts
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0;
    if (row < row_end) {
      const T* col = slots_t + row;
      int sl = 0;
      for (; sl + G <= s; sl += G) table_slots<T, QT, false>(col, n, sl, G, filt, tab, acc);
      if (sl < s) table_slots<T, QT, true>(col, n, sl, s - sl, filt, tab, acc);
    }
#pragma unroll
    for (int j = 0; j < QT; ++j) top.keys[j * kScanRowTile + tid] = acc[j] - s;  // -count
    __syncthreads();
    top.offer(k, t0, row_end, q0, n_q);
  }
  top.write(k, q0, n_q, partial);
}

// ---- launch ----------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct Args {
  const void* q;
  const void* slots_t;
  const long long* excl;
  long long* partial;
  int n_q;
  long long n;
  int s, k, slab_rows;
  cudaStream_t stream;
};

template <typename T, int QT, bool kVec>
cudaError_t launch_compare(const Args& a) {
  const size_t smem = compare_smem<T, QT>(a.s, a.k);
  cudaError_t err = allow_smem(slot_compare<T, QT, kVec>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.n + a.slab_rows - 1) / a.slab_rows),
                  (a.n_q + QT - 1) / QT);
  slot_compare<T, QT, kVec><<<grid, kScanThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.slots_t), a.excl, a.partial, a.n_q,
      a.n, a.s, a.k, a.slab_rows);
  return cudaGetLastError();
}

// Every slot's row on a 16-byte boundary: one load a vector.
template <typename T, int QT>
cudaError_t launch_compare(const Args& a) {
  const bool vec = reinterpret_cast<uintptr_t>(a.slots_t) % 16 == 0 &&
                   a.n % compare_rows<T>() == 0;
  return vec ? launch_compare<T, QT, true>(a) : launch_compare<T, QT, false>(a);
}

template <typename T, int QT>
cudaError_t launch_table(const Args& a) {
  const size_t smem = table_smem<QT>(a.s, a.k);
  cudaError_t err = allow_smem(slot_table<T, QT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.n + a.slab_rows - 1) / a.slab_rows),
                  (a.n_q + QT - 1) / QT);
  slot_table<T, QT><<<grid, kScanThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.slots_t), a.excl, a.partial, a.n_q,
      a.n, a.s, a.k, a.slab_rows);
  return cudaGetLastError();
}

template <typename T>
int row_tile(int mode) {
  return mode == kModeCompare ? kScanThreads * compare_rows<T>() : kScanRowTile;
}

template <typename T>
cudaError_t launch(int mode, int tile, const Args& a) {
  if (a.slab_rows % row_tile<T>(mode) != 0) return cudaErrorInvalidValue;
  if (mode == kModeCompare) {
    switch (tile) {
      case 1: return launch_compare<T, 1>(a);
      case 2: return launch_compare<T, 2>(a);
      case 4: return launch_compare<T, 4>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (mode == kModeTable) {
    switch (tile) {
      case 1: return launch_table<T, 1>(a);
      case 2: return launch_table<T, 2>(a);
      case 4: return launch_table<T, 4>(a);
      case 8: return launch_table<T, 8>(a);
      case 16: return launch_table<T, 16>(a);
      case 32: return launch_table<T, 32>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
long long smem_bytes(int mode, int tile, int s, int k) {
  if (mode == kModeCompare) {
    switch (tile) {
      case 1: return static_cast<long long>(compare_smem<T, 1>(s, k));
      case 2: return static_cast<long long>(compare_smem<T, 2>(s, k));
      case 4: return static_cast<long long>(compare_smem<T, 4>(s, k));
      default: return 0;
    }
  }
  if (mode == kModeTable) {
    switch (tile) {
      case 1: return static_cast<long long>(table_smem<1>(s, k));
      case 2: return static_cast<long long>(table_smem<2>(s, k));
      case 4: return static_cast<long long>(table_smem<4>(s, k));
      case 8: return static_cast<long long>(table_smem<8>(s, k));
      case 16: return static_cast<long long>(table_smem<16>(s, k));
      case 32: return static_cast<long long>(table_smem<32>(s, k));
      default: return 0;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// bits: 16 or 32, the slot width. mode: 0 slot_compare (query_tile 1, 2 or
// 4), 1 slot_table (query_tile 1, 2, 4, 8, 16 or 32). q: (n_q, s) slots;
// slots_t: (s, n) slots; excl: null or (n_q,) int64 bounds. slab_rows: a
// multiple of the mode's row tile (slot_compare 256 x 16 / (bits / 8),
// slot_table 256). partial: (ceil(n / slab_rows), n_q, k) int64, for
// innr_knn_merge. Returns the cudaError_t of the launch (0 on success).
int innr_slot_scan(int bits, int mode, const void* q, const void* slots_t, const void* excl,
                   void* partial, int n_q, long long n, int s, int k, int query_tile,
                   int slab_rows, void* stream) {
  if (n_q <= 0 || n <= 0 || s < 0 || k <= 0 || slab_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, slots_t, static_cast<const long long*>(excl), static_cast<long long*>(partial),
               n_q, n, s, k, slab_rows, static_cast<cudaStream_t>(stream)};
  switch (bits) {
    case 16: return static_cast<int>(launch<unsigned short>(mode, query_tile, a));
    case 32: return static_cast<int>(launch<unsigned>(mode, query_tile, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one CTA of a mode's scan, or 0 for a bad
// combination.
long long innr_slot_smem_bytes(int bits, int mode, int query_tile, int s, int k) {
  switch (bits) {
    case 16: return smem_bytes<unsigned short>(mode, query_tile, s, k);
    case 32: return smem_bytes<unsigned>(mode, query_tile, s, k);
    default: return 0;
  }
}

}  // extern "C"
