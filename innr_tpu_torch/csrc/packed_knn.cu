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
// Arithmetic. The products run on the b1 tensor cores:
// mma.sync.m16n8k256.b1.and.popc sums popc(a & b) over 256 bits exactly, in
// int32. With m = sum popc(x & q):
//   binary   popc(x ^ q) = popc(x) + popc(q) - 2 m, so key = 2 m - popc(x) - popc(q);
//   ternary  popc((p & a) | (n & b)) = popc(p & a) + popc(n & b) - popc(p & n & a & b)
//            for any planes, and the opposite-sign term has the same overlap
//            p & n & a & b, so dot = [popc(p & qp) + popc(n & qn)]
//                                  - [popc(p & qn) + popc(n & qp)],
//            two sums over K = 2W (A = [p | n]; B = [qp | qn] and [qn | qp]).
// Both are exact on any words, overlapping ternary planes included, so the
// keys equal the plain version's and no re-score is needed. A W that is not
// a multiple of 8 pads each plane's last k-step with zero words, which AND
// to 0.
//
// Design (packed_scan). Grid (corpus slabs x query tiles of NQ = 8, 16, 32
// or 64 queries, a template parameter; kernels/packed_knn.py:tiling picks
// the smallest that holds min(Q, 64), narrowed while NQ x k exceeds 4096
// or the shared memory does not fit), one wave of resident CTAs of 4 warps.
// 1. The CTA walks its slab in tiles of 128 rows, 32 per warp, and each
//    plane in items of 3 k-steps (24 words); the int32 accumulators carry
//    across items. The rows never touch shared memory: thread (g, t) of a
//    warp (g = lane / 4, t = lane % 4) loads words 8 s + t and 8 s + 4 + t
//    of its 4 consecutive rows 4 g .. 4 g + 3 as one 16-byte vector each
//    (N % 4 == 0 and aligned planes; else word by word) straight from the
//    (W, N) plane: a warp's load is 4 words x 128 contiguous bytes. Rows
//    4 g + 2 h and 4 g + 2 h + 1 are A rows g and g + 8 of MMA h (h = 0,
//    1), so the accumulators of thread (g, t) hold its own 4 rows against
//    queries 8 nb + 2 t and + 1 of each n-block nb. The next item's words
//    are in flight in a second register set while this one multiplies.
// 2. The queries sit in shared memory as B fragments (one 8-byte load per
//    k-step and n-block), every k-step when they fit, else staged per item.
//    popc(q) is summed once per CTA; popc(x) is one more MMA per k-step
//    against an all-ones B, so no __popc runs per word.
// 3. Gate. The keys are exact, so a (row, query) pair enters the CTA's
//    top k only if its key reaches the query's threshold: the CTA's own
//    k-th key + 1 (its rows come in ascending order, so a tie with its own
//    k-th loses on the row), or the best k-th key any CTA has published
//    (>=: another slab's tie can win on a lower row); and only if it lies
//    before the exclusion bound (the multi-pass resume). One compare per
//    pair against the threshold decides whether the warp looks closer; an
//    admitted pair's composite goes to its query's pool in shared memory
//    (one slot claim per column and register). Once enough pairs are
//    pending (128, or NQ k / 8 at large k: a round costs about k a query),
//    a pool holds 128, or the slab ends, warp w sorts the pools of its
//    queries (c % 4 == w; bitonic) and merges each into its sorted buffer
//    (merge path: a binary search per lane, then seg = ceil(k / 32)
//    outputs), then re-reads the thresholds, publishing its k-th keys by
//    atomicMax into a per-query array (kth, biased to unsigned so that the
//    launch zeroes it with one memset). Composites are unique, so the
//    selection is a set function and equals the plain version's bit for
//    bit. Ties are only a cost: a corpus of duplicated rows admits, per CTA
//    and query, the duplicates that tie the best published k-th key of
//    another slab, and none that tie its own.
// 4. packed_merge, one CTA per query: every CTA's k-th key is at most the
//    final k-th key, so a histogram of the partial entries' keys at or
//    above kth[q] (2048 bins) gives the final k-th key itself; each warp
//    pools the entries that reach it, sorts and merges them into its
//    buffer, and the 8 buffers are merged pairwise. It writes the
//    composites, or (one pass) the int32 keys and rows.
//
// What bounds it on the H100: the corpus read (2.88 GB at 30M x 768 bits:
// 0.860 ms at 3.35 TB/s). At Q = 16 the products are 369 T bit products
// (binary, plus 23 T for popc(x)) or 737 T (ternary: both planes against
// both query planes), 0.05 / 0.09 ms at the 7.81e15 per second that
// scripts/packed_probe.py measured for wgmma b1 on an H100 80GB HBM3 at 700
// W (mma.sync b1, which this kernel issues: 5.11e15). The gate costs a few
// integer instructions per (row, query) pair. PERF.md gives the measured
// times and the probe's split. Left for later: the merge in the scan's last
// CTA, wgmma for the products at Q = 64, a narrower epilogue at Q = 32.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "packed.cuh"  // kBinary, kTernary
#include "topk.cuh"    // composite

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 128;  // rows per CTA tile: 32 per warp, 4 per thread
constexpr int kChunkSteps = 3;  // k-steps of 256 bits (8 words) per item
constexpr int kPool = 2 * kTileRows;  // a query's pool of admitted pairs
constexpr int kRound = kTileRows;     // a pool this full triggers a merge round
constexpr unsigned kFullPool = 0x80000000u;  // a tile count's flag: some pool reached kRound
constexpr int kNoBound = 1 << 30;     // above every key (|key| <= 32 W < 2^30)
constexpr size_t kSmemMax = 232448;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kSign = 0x80000000u;

// An int32 key as an unsigned of the same order (0: INT_MIN), so that the
// shared k-th keys start from a memset to 0 and rise by atomicMax.
__device__ __forceinline__ unsigned biased(int key) { return static_cast<unsigned>(key) ^ kSign; }

// Byte offsets of a CTA's shared memory: the top-k buffers, each query's
// pool of admitted composites, each warp's merge output, the exclusion
// bounds, the queries' B fragments, per query the gate's (lo, hi),
// popc(q) and the pool's count, and counters.
// kernels/packed_knn.py:smem_bytes computes the same total.
struct Layout {
  int nq, planes, steps, cpp;  // query tile, planes, k-steps per plane, chunks per plane
  bool q_res;                  // every k-step of the queries resident
  size_t best, pool, merged, bound, qf, gate, pq, cnt, red, total;
};

inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

Layout make_layout(int planes, int nq, int w, int k, bool q_res) {
  Layout L{};
  L.nq = nq;
  L.planes = planes;
  L.steps = (w + 7) / 8;
  L.cpp = (L.steps + kChunkSteps - 1) / kChunkSteps;
  L.q_res = q_res;
  size_t at = 0;
  L.best = at;
  at = align16(at + sizeof(long long) * nq * k);
  L.pool = at;  // [nq][kPool]
  at = align16(at + sizeof(long long) * nq * kPool);
  L.merged = at;  // [kWarps][k]
  at = align16(at + sizeof(long long) * kWarps * k);
  L.bound = at;
  at = align16(at + sizeof(long long) * nq);
  L.qf = at;  // [planes][steps or kChunkSteps][nq / 8][32] uint2
  at = align16(at + 32 * static_cast<size_t>(planes) * (q_res ? L.steps : kChunkSteps) * nq);
  L.gate = at;
  at = align16(at + sizeof(int2) * nq);
  L.pq = at;
  at = align16(at + sizeof(int) * nq);
  L.cnt = at;
  at = align16(at + sizeof(int) * nq);
  L.red = at;
  at += 16;
  L.total = at;
  return L;
}

struct Args {
  const unsigned* q0;  // query planes (n_q, w): binary words, or pos
  const unsigned* q1;  // ternary neg
  const unsigned* x0;  // corpus planes (w, n)
  const unsigned* x1;
  const long long* excl;
  unsigned* kth;  // per query: the best k-th key any CTA's buffer has held, ^ 0x80000000
  long long* partial;
  int n_q;
  long long n;
  int w, k;
  long long slab_rows;
  bool vec;  // 16-byte row loads (n % 4 == 0, aligned planes)
};

__device__ __forceinline__ unsigned lane_word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// d += popc(A & B) over 256 bits: A 16 x 256 (rows g, g + 8: a0 / a1 bits
// 32 t.., a2 / a3 bits 128 + 32 t..), B 256 x 8 (column g: b.x, b.y alike).
__device__ __forceinline__ void mma_b1(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, uint2 b) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

// Word wd of the 4 rows r.. of a plane (zeros past w and past end).
__device__ __forceinline__ uint4 load_rows(const unsigned* __restrict__ plane, const Args& p,
                                           int wd, long long r, long long end) {
  if (wd >= p.w || r >= end) return make_uint4(0u, 0u, 0u, 0u);
  const unsigned* src = plane + static_cast<size_t>(wd) * p.n + r;
  if (p.vec) return __ldg(reinterpret_cast<const uint4*>(src));  // end % 4 == 0
  return make_uint4(src[0], r + 1 < end ? src[1] : 0u, r + 2 < end ? src[2] : 0u,
                    r + 3 < end ? src[3] : 0u);
}

// A position in a CTA's work: rows [t0, t0 + 128), chunk ch of the planes'
// k-steps (plane ch / cpp, steps kChunkSteps (ch % cpp) ..).
struct Cursor {
  long long t0;
  int ch;
};

// This thread's words of the item at c: v[i][0] word 8 s + t, v[i][1] word
// 8 s + 4 + t of step s = s0 + i, for rows r .. r + 3.
__device__ __forceinline__ void load_item(uint4 (&v)[kChunkSteps][2], const Args& p,
                                          const Layout& L, const Cursor& c, long long end,
                                          int row_off, int t) {
  const int plane = c.ch / L.cpp, s0 = (c.ch % L.cpp) * kChunkSteps;
  const unsigned* src = plane == 0 ? p.x0 : p.x1;
  const long long r = c.t0 + row_off;
#pragma unroll
  for (int i = 0; i < kChunkSteps; ++i) {
    const int wd = 8 * (s0 + i) + t;
    v[i][0] = load_rows(src, p, wd, r, end);
    v[i][1] = load_rows(src, p, wd + 4, r, end);
  }
}

// The queries' B fragments of steps [s_begin, s_begin + n_steps) of every
// plane: qf[((plane n_steps + s) NB + nb) 32 + lane] = (word 8 s + t, word
// 8 s + 4 + t) of query q0 + 8 nb + g (zeros past n_q and w).
__device__ void stage_queries(uint2* qf, const Args& p, int q0, int nq, int planes,
                              int s_begin, int n_steps) {
  const int nb_count = nq / 8;
  for (int f = threadIdx.x; f < planes * n_steps * nb_count * 32; f += kThreads) {
    const int lane = f & 31, nb = (f >> 5) % nb_count, rest = (f >> 5) / nb_count;
    const int s = rest % n_steps, plane = rest / n_steps;
    const int q = q0 + 8 * nb + (lane >> 2), wd = 8 * (s_begin + s) + (lane & 3);
    const unsigned* src = (plane == 0 ? p.q0 : p.q1) + static_cast<size_t>(q) * p.w;
    const bool live = q < p.n_q;
    qf[f] = make_uint2(live && wd < p.w ? src[wd] : 0u, live && wd + 4 < p.w ? src[wd + 4] : 0u);
  }
}

// cand[0..m) sorted descending in place by one warp (bitonic, padded with
// LLONG_MIN to a power of two: cand holds that many slots).
__device__ void warp_sort_desc(long long* cand, int m, int lane) {
  int size = 1;
  while (size < m) size <<= 1;
  for (int i = m + lane; i < size; i += 32) cand[i] = LLONG_MIN;
  for (int span = 2; span <= size; span <<= 1)
    for (int stride = span >> 1; stride > 0; stride >>= 1) {
      __syncwarp();
      for (int i = lane; i < size / 2; i += 32) {
        const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1)), hi = lo + stride;
        const long long a = cand[lo], b = cand[hi];
        if ((a < b) == ((lo & span) == 0)) {
          cand[lo] = b;
          cand[hi] = a;
        }
      }
    }
  __syncwarp();
}

// buf[0..k) := the top k of buf[0..k) and cand[0..m), both sorted
// descending with no composite in both, by one warp: lane l finds where
// output l seg (seg = ceil(k / 32)) lies on the merge path of the two
// lists (a binary search) and merges seg outputs from there into out[0..k),
// which is copied back.
__device__ void warp_merge_desc(long long* buf, int k, const long long* cand, int m,
                                long long* out, int lane) {
  const int seg = (k + 31) / 32, d = lane * seg;
  if (d < k) {
    int lo = max(0, d - m), hi = min(d, k);  // buf's share of the first d outputs
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (buf[mid] > cand[d - mid - 1]) lo = mid + 1;
      else hi = mid;
    }
    int ia = lo, ib = d - lo;
    for (int o = d; o < min(k, d + seg); ++o) {
      if (ib >= m || (ia < k && buf[ia] > cand[ib])) out[o] = buf[ia++];
      else out[o] = cand[ib++];
    }
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32) buf[i] = out[i];
  __syncwarp();
}

// The CTAs per SM that the registers are sized for: the accumulators grow
// with the query tile, twice as fast for ternary (two sums).
template <int kKind, int NQ>
constexpr int min_blocks() {
  return NQ * (kKind + 1) <= 32 ? 4 : NQ * (kKind + 1) <= 64 ? 3 : 2;
}

template <int kKind, int NQ>
__global__ void __launch_bounds__(kThreads, min_blocks<kKind, NQ>()) packed_scan(Args p, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NB = NQ / 8;
  constexpr int kOpp = kKind == kTernary ? NB : 1;
  long long* best = reinterpret_cast<long long*>(smem + L.best);      // [NQ][k]
  long long* pool = reinterpret_cast<long long*>(smem + L.pool);      // [NQ][256] admitted
  long long* merged = reinterpret_cast<long long*>(smem + L.merged);  // [4][k]
  long long* bound = reinterpret_cast<long long*>(smem + L.bound);    // [NQ]
  uint2* qf = reinterpret_cast<uint2*>(smem + L.qf);
  int2* gate = reinterpret_cast<int2*>(smem + L.gate);  // [NQ] (lo, hi) on 2 m - popc(x) or the dot
  int* pq = reinterpret_cast<int*>(smem + L.pq);        // [NQ] popc(q) (binary)
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);      // [NQ] pool sizes
  unsigned* red = reinterpret_cast<unsigned*>(smem + L.red);  // 3 tile counts

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int row_off = 32 * warp + 4 * g;  // this thread's rows in a tile
  const int q0 = blockIdx.y * NQ, k = p.k;
  for (int i = tid; i < NQ * k; i += kThreads) best[i] = LLONG_MIN;
  if (tid < NQ) {
    const int q = q0 + tid;
    const bool live = q < p.n_q;
    int pc = 0;
    if (kKind == kBinary && live)
      for (int wd = 0; wd < p.w; ++wd) pc += __popc(p.q0[static_cast<size_t>(q) * p.w + wd]);
    pq[tid] = pc;
    bound[tid] = (live && p.excl != nullptr) ? p.excl[q] : LLONG_MAX;
    const int hi = (live && p.excl != nullptr) ? static_cast<int>(p.excl[q] >> 32) : kNoBound;
    gate[tid] = live ? make_int2(INT_MIN + pc, hi + pc) : make_int2(INT_MAX, INT_MIN);
    cnt[tid] = 0;
  }
  if (tid < 4) red[tid] = 0u;
  if (L.q_res) stage_queries(qf, p, q0, NQ, L.planes, 0, L.steps);
  __syncthreads();

  const long long row_begin = static_cast<long long>(blockIdx.x) * p.slab_rows;
  const long long end = min(p.n, row_begin + p.slab_rows);
  const int n_ch = L.planes * L.cpp;
  const int q_stride = L.q_res ? L.steps : kChunkSteps;  // k-steps per plane in qf
  const uint2 ones = make_uint2(kFull, kFull);  // binary: popc(x) as one more column
  Cursor next{row_begin, 0};
  uint4 nxt[kChunkSteps][2], cur[kChunkSteps][2];
  if (next.t0 < end) load_item(nxt, p, L, next, end, row_off, t);

  int acc[NB][2][4], opp[kOpp][2][4], px[2][4];
  int pending = 0;  // admitted pairs in the pools, not yet merged
  const int round_pairs = max(kRound, NQ * k / 8);
  for (int tile = 0; next.t0 < end;) {
    const Cursor it = next;
#pragma unroll
    for (int i = 0; i < kChunkSteps; ++i) {
      cur[i][0] = nxt[i][0];
      cur[i][1] = nxt[i][1];
    }
    if (++next.ch == n_ch) {
      next.ch = 0;
      next.t0 += kTileRows;
    }
    if (next.t0 < end) load_item(nxt, p, L, next, end, row_off, t);
    const int plane = it.ch / L.cpp, s0 = (it.ch % L.cpp) * kChunkSteps;
    if (!L.q_res) {  // this item's k-steps of the queries
      __syncthreads();
      stage_queries(qf, p, q0, NQ, L.planes, s0, kChunkSteps);
      __syncthreads();
    }
    if (it.ch == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) acc[nb][h][e] = 0;
#pragma unroll
          for (int nb = 0; nb < kOpp; ++nb) opp[nb][h][e] = 0;
          px[h][e] = 0;
        }
    }
    // Ternary: the same-sign sum takes the query plane of the corpus
    // plane's sign, the opposite-sign sum the other one.
    const int qs0 = L.q_res ? s0 : 0;
    const uint2* b_same = qf + (static_cast<size_t>(plane * q_stride + qs0) * NB) * 32 + lane;
    const uint2* b_opp = qf + (static_cast<size_t>((1 - plane) * q_stride + qs0) * NB) * 32 + lane;
    const int ns = min(kChunkSteps, L.steps - s0);
#pragma unroll
    for (int i = 0; i < kChunkSteps; ++i) {
      if (i >= ns) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned a0 = lane_word(cur[i][0], 2 * h), a1 = lane_word(cur[i][0], 2 * h + 1);
        const unsigned a2 = lane_word(cur[i][1], 2 * h), a3 = lane_word(cur[i][1], 2 * h + 1);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          mma_b1(acc[nb][h], a0, a1, a2, a3, b_same[(i * NB + nb) * 32]);
          if constexpr (kKind == kTernary)
            mma_b1(opp[nb][h], a0, a1, a2, a3, b_opp[(i * NB + nb) * 32]);
        }
        if constexpr (kKind == kBinary) mma_b1(px[h], a0, a1, a2, a3, ones);
      }
    }
    if (it.ch != n_ch - 1) continue;

    // The tile's last chunk. Register (nb, h, e) holds row r0 + 2 h + e / 2
    // against query column 8 nb + 2 t + e % 2; it becomes 2 m - popc(x)
    // (binary: px[h][e] holds popc(x) of that row) or the dot. The gate
    // first asks only whether any pair reaches its query's lo.
    const long long r0 = it.t0 + row_off;
    bool any = false;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int4 gv = reinterpret_cast<const int4*>(gate)[nb * 4 + t];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int v;
          if constexpr (kKind == kBinary) v = 2 * acc[nb][h][e] - px[h][e];
          else v = acc[nb][h][e] - opp[nb][h][e];
          acc[nb][h][e] = v;
          any |= v >= ((e & 1) ? gv.z : gv.x);
        }
    }
    // Admitted pairs (in the slab, within (lo, hi), before the exclusion
    // bound) go to their query's pool: the lanes of one column are those
    // with the same t, and the lowest admitting one claims their slots.
    // The tile's admitted pairs are counted in red[1 + tile % 3], with
    // kFullPool set once a pool holds kRound; the count two tiles ahead is
    // cleared here (all its reads are two barriers back).
    unsigned* n_tile = red + 1 + tile % 3;
    if (tid == 0) red[1 + (tile + 1) % 3] = 0u;
    if (__any_sync(kFull, any)) {
      const unsigned column = 0x11111111u << t;
      unsigned n_warp = 0;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int4 gv = reinterpret_cast<const int4*>(gate)[nb * 4 + t];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * nb + 2 * t + (e & 1), v = acc[nb][h][e];
            const long long row = r0 + 2 * h + (e >> 1);
            bool admit = row < end && v >= ((e & 1) ? gv.z : gv.x) && v <= ((e & 1) ? gv.w : gv.y);
            long long comp = LLONG_MIN;
            if (admit) {  // binary: key -count; ternary: pq = 0
              comp = composite(v - pq[c], row);
              admit = comp < bound[c];
            }
            const unsigned am = __ballot_sync(kFull, admit);
            if (am == 0u) continue;
            n_warp += __popc(am);
            const unsigned mine = am & column;
            const int leader = mine != 0u ? __ffs(mine) - 1 : lane;
            int slot = 0;
            if (admit && lane == leader) {
              slot = atomicAdd(cnt + c, __popc(mine));
              if (slot + __popc(mine) >= kRound) atomicOr(n_tile, kFullPool);
            }
            slot = __shfl_sync(kFull, slot, leader) + __popc(mine & ((1u << lane) - 1u));
            if (admit) pool[c * kPool + slot] = comp;
          }
      }
      if (lane == 0 && n_warp != 0u) atomicAdd(n_tile, n_warp);
    }
    __syncthreads();
    ++tile;
    const unsigned counted = *n_tile;
    const int total = pending + static_cast<int>(counted & ~kFullPool);
    // Merge once round_pairs are pending or a pool holds kRound (so every
    // pool stays below kPool: under kRound, plus a tile's kTileRows), and at
    // the end of the slab: the thresholds lag meanwhile, which only admits
    // more pairs. A round costs about k per query, so at large k rounds
    // wait for more pairs.
    if (total < round_pairs && !(counted & kFullPool) && next.t0 < end) {
      pending = total;
      continue;
    }
    pending = 0;
    // Warp w merges the pools of its queries (c % 4 == w) into their
    // buffers and sets their thresholds: the CTA's own k-th key + 1, or the
    // best k-th key any CTA has published (k rows anywhere that beat a row
    // keep it out of the final top k); it publishes its own.
    for (int c = warp; c < NQ; c += kWarps) {
      const int m = cnt[c];
      if (m > 0) {
        warp_sort_desc(pool + c * kPool, m, lane);
        warp_merge_desc(best + c * k, k, pool + c * kPool, m, merged + warp * k, lane);
      }
      if (lane == 0 && q0 + c < p.n_q) {
        cnt[c] = 0;
        const int own = static_cast<int>(best[c * k + k - 1] >> 32);
        const int published = static_cast<int>(atomicMax(p.kth + q0 + c, biased(own)) ^ kSign);
        gate[c].x = max(own + 1, published) + pq[c];
      }
    }
    __syncthreads();
  }
  for (int f = tid; f < NQ * k; f += kThreads) {
    const int q = q0 + f / k;
    if (q < p.n_q) p.partial[(static_cast<size_t>(blockIdx.x) * p.n_q + q) * k + f % k] = best[f];
  }
}

// One CTA of 8 warps per query: the top k of the n_slabs partial lists of
// length k. Every CTA's k-th key is at most the final k-th key, so only
// entries whose key reaches kth[q] can be selected.
// 1. A histogram of those entries' keys, kBins bins from kth[q] up (the
//    last one open above), gives the final k-th key itself, K: the union of
//    the lists holds the global top k. (If the open bin alone holds k,
//    K is its lower edge, a lower bound.)
// 2. Warp w reads entries w 256 .., eight 32-entry chunks at a time, keeps
//    those with key >= K that beat its buffer's k-th (as it stood before
//    the chunks) in a pool, and sorts and merges the pool into its buffer
//    whenever it holds more than kPool - 32; then the 8 buffers are merged
//    pairwise.
// The result goes out as composites (out) or as int32 keys and rows.
constexpr int kBins = 2048;

// Entry f of query q's n_slabs x k partial entries (f < 2^31).
__device__ __forceinline__ long long partial_entry(const long long* __restrict__ partial, int f,
                                                   int n_q, int q, int k) {
  const int slab = f / k;
  return partial[(static_cast<size_t>(slab) * n_q + q) * k + (f - slab * k)];
}

__global__ void __launch_bounds__(256) packed_merge(const long long* __restrict__ partial,
                                                    const unsigned* __restrict__ kth,
                                                    long long* __restrict__ out,
                                                    int* __restrict__ keys,
                                                    int* __restrict__ rows, int n_q,
                                                    int n_slabs, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* hist = reinterpret_cast<int*>(smem);  // [kBins]
  int* cut_s = hist + kBins;
  const int stride = 2 * k + kPool;  // per warp: buffer, merge output, pool
  long long* buf = reinterpret_cast<long long*>(smem + sizeof(int) * (kBins + 4)) + stride * warp;
  long long* tmp = buf + k;
  long long* pool = tmp + k;
  for (int i = tid; i < kBins; i += 256) hist[i] = 0;
  for (int i = lane; i < k; i += 32) buf[i] = LLONG_MIN;
  __syncthreads();
  const long long floor_key = static_cast<int>(kth[q] ^ kSign);
  const int total = n_slabs * k;
  for (int base = tid; base < total; base += 256 * 8) {
    long long v[8];  // eight loads in flight a thread
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int f = base + 256 * u;
      v[u] = f < total ? partial_entry(partial, f, n_q, q, k) : LLONG_MIN;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long key = static_cast<int>(v[u] >> 32);
      if (v[u] != LLONG_MIN && key >= floor_key)
        atomicAdd(hist + min(key - floor_key, kBins - 1LL), 1);
    }
  }
  __syncthreads();
  if (warp == 0) {  // the bin where the count from the top reaches k
    constexpr int kPer = kBins / 32;
    int own = 0;
    for (int i = 0; i < kPer; ++i) own += hist[lane * kPer + i];
    int above = own;  // this lane's bins and every higher lane's
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_down_sync(kFull, above, o);
      if (lane + o < 32) above += v;
    }
    const int higher = above - own;
    if (above >= k && higher < k) {
      int bin = lane * kPer + kPer - 1, run = higher;
      while (bin > lane * kPer && run + hist[bin] < k) run += hist[bin--];
      *cut_s = static_cast<int>(floor_key + bin);
    }
    const int counted = __shfl_sync(kFull, above, 0);
    if (lane == 0 && counted < k) *cut_s = static_cast<int>(floor_key);
  }
  __syncthreads();
  const int cut = *cut_s;
  int m = 0;  // pooled entries
  for (int base = 256 * warp; base < total; base += 256 * 8) {
    long long v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int f = base + 32 * u + lane;
      v[u] = f < total ? partial_entry(partial, f, n_q, q, k) : LLONG_MIN;
    }
    const long long kth_c = buf[k - 1];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool keep = v[u] > kth_c && static_cast<int>(v[u] >> 32) >= cut;
      const unsigned am = __ballot_sync(kFull, keep);
      if (keep) pool[m + __popc(am & ((1u << lane) - 1u))] = v[u];
      m += __popc(am);
      if (m > kPool - 32) {
        warp_sort_desc(pool, m, lane);
        warp_merge_desc(buf, k, pool, min(m, k), tmp, lane);
        m = 0;
      }
    }
  }
  if (m > 0) {
    warp_sort_desc(pool, m, lane);
    warp_merge_desc(buf, k, pool, min(m, k), tmp, lane);
  }
  for (int width = 1; width < 8; width <<= 1) {
    __syncthreads();
    if (warp % (2 * width) == 0) warp_merge_desc(buf, k, buf + stride * width, k, tmp, lane);
  }
  if (warp != 0) return;
  for (int i = lane; i < k; i += 32) {
    const size_t at = static_cast<size_t>(q) * k + i;
    const long long c = buf[i];
    if (out != nullptr) out[at] = c;
    if (keys != nullptr) {
      keys[at] = static_cast<int>(c >> 32);
      rows[at] = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(c & 0xFFFFFFFFLL));
    }
  }
}

template <int kKind, int NQ>
cudaError_t launch_as(const Args& p, const Layout& L, long long n_slabs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(packed_scan<kKind, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_slabs), (p.n_q + NQ - 1) / NQ);
  packed_scan<kKind, NQ><<<grid, kThreads, L.total, stream>>>(p, L);
  return cudaGetLastError();
}

template <int kKind>
cudaError_t launch(const Args& p, const Layout& L, long long n_slabs, cudaStream_t s) {
  switch (L.nq) {
    case 8: return launch_as<kKind, 8>(p, L, n_slabs, s);
    case 16: return launch_as<kKind, 16>(p, L, n_slabs, s);
    case 32: return launch_as<kKind, 32>(p, L, n_slabs, s);
    case 64: return launch_as<kKind, 64>(p, L, n_slabs, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int kKind, int NQ>
cudaError_t resident_as(const Layout& L, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(packed_scan<kKind, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, packed_scan<kKind, NQ>, kThreads,
                                                       L.total);
}

template <int kKind>
cudaError_t resident(const Layout& L, int* blocks) {
  switch (L.nq) {
    case 8: return resident_as<kKind, 8>(L, blocks);
    case 16: return resident_as<kKind, 16>(L, blocks);
    case 32: return resident_as<kKind, 32>(L, blocks);
    case 64: return resident_as<kKind, 64>(L, blocks);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_shape(int kind, int query_tile, int w, int k) {
  return (kind == kBinary || kind == kTernary) && w > 0 && w < (1 << 24) && k > 0 &&
         (query_tile == 8 || query_tile == 16 || query_tile == 32 || query_tile == 64);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// One pass: the scan, then (out or keys != null) the merge. kind: 0 binary
// (qn, neg_t unused, may be null), 1 ternary. qp, qn: (n_q, w) uint32;
// pos_t, neg_t: (w, n) uint32; excl: null or (n_q,) int64 bounds; kth:
// (n_q,) uint32 scratch, zeroed here, the launch's shared k-th keys.
// query_tile: 8, 16, 32 or 64; q_res: 1 if every k-step of the queries is
// resident (the layout innr_packed_grid reports must fit). partial:
// (ceil(n / slab_rows), n_q, k) int64; out: null or (n_q, k) int64, the
// top k composites; keys, rows: null or (n_q, k) int32 each, the same as
// keys and row indices.
// Returns the first cudaError_t of the launches (0 on success).
int innr_packed_scan(int kind, const void* qp, const void* qn, const void* pos_t,
                     const void* neg_t, const void* excl, void* kth, void* partial, void* out,
                     void* keys, void* rows, int n_q, long long n, int w, int k, int query_tile,
                     int q_res, int slab_rows, void* stream) {
  if (n_q <= 0 || n <= 0 || slab_rows <= 0 || slab_rows % kTileRows != 0 || kth == nullptr ||
      !valid_shape(kind, query_tile, w, k) || (keys == nullptr) != (rows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kTernary && (qn == nullptr || neg_t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(kind == kTernary ? 2 : 1, query_tile, w, k, q_res != 0);
  if (L.total > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const unsigned*>(qp), static_cast<const unsigned*>(qn),
         static_cast<const unsigned*>(pos_t), static_cast<const unsigned*>(neg_t),
         static_cast<const long long*>(excl), static_cast<unsigned*>(kth),
         static_cast<long long*>(partial), n_q, n, w, k, slab_rows, false};
  p.vec = n % 4 == 0 && aligned16(pos_t) && (kind == kBinary || aligned16(neg_t));
  const long long n_slabs = (n + slab_rows - 1) / slab_rows;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(kth, 0, sizeof(unsigned) * n_q, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = kind == kBinary ? launch<kBinary>(p, L, n_slabs, s) : launch<kTernary>(p, L, n_slabs, s);
  if (err != cudaSuccess || (out == nullptr && keys == nullptr)) return static_cast<int>(err);
  if (n_slabs * k > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * (kBins + 4) + sizeof(long long) * 8 * (2 * k + kPool);
  err = cudaFuncSetAttribute(packed_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_merge<<<n_q, 256, smem, s>>>(static_cast<const long long*>(partial),
                                      static_cast<const unsigned*>(kth),
                                      static_cast<long long*>(out), static_cast<int*>(keys),
                                      static_cast<int*>(rows), n_q, static_cast<int>(n_slabs), k);
  return static_cast<int>(cudaGetLastError());
}

// The scan's shape: info[0] its shared-memory bytes, info[1] the CTAs
// resident per SM (0 if the layout does not fit).
int innr_packed_grid(int kind, int query_tile, int w, int k, int q_res, void* info) {
  if (!valid_shape(kind, query_tile, w, k)) return static_cast<int>(cudaErrorInvalidValue);
  int* out = static_cast<int*>(info);
  const Layout L = make_layout(kind == kTernary ? 2 : 1, query_tile, w, k, q_res != 0);
  out[0] = static_cast<int>(L.total);
  out[1] = 0;
  if (L.total > kSmemMax) return 0;
  const cudaError_t err = kind == kBinary ? resident<kBinary>(L, out + 1)
                                          : resident<kTernary>(L, out + 1);
  return static_cast<int>(err);
}

}  // extern "C"
