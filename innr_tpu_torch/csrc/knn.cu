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
// (INT_MIN, -1) and never beats a real row. With a row-id map ids (N,)
// int32 the composite carries ids[row] in place of row, so ties go to the
// lowest id and the exclusion bound is an id bound too; every read of a
// row (its products, its re-score, aux and mask) stays at its position.
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
// Arithmetic of every score that is kept: the dot accumulates fp32 FMAs in
// dimension order from +0.0, then __fsub_rn(aux, __fmul_rn(2, dot)) (l2) or
// __fmul_rn(dot, aux) (cosine). bf16 corpora: queries are rounded to bf16
// first, so every product of two bf16 values is exact in fp32 and only the
// sums round, as on the TPU. u8 corpora: codes widen to fp32 and multiply
// the full fp32 query. The TPU instead sums the codes' products with a hi/lo
// bf16 split of the query (innr_tpu/kernels/knn.py:236-261), which drops up
// to 2^-16 of each product. With integer-valued inputs every score is exact
// in both and the kernel agrees with the plain version bit for bit.
//
// Design, every corpus dtype (knn_scan_tc): tensor-core scores, a proven
// gate, an exact re-score.
// 1. Grid (corpus slabs x query tiles), one wave of resident CTAs. A CTA is
//    one warpgroup; its query tile is NQ = 8, 16, 32 or 64 queries (the
//    smallest that holds min(Q, 64), narrowed when its top-k buffers do not
//    fit), so a Q of 1 computes 8 columns and a batch of up to 64 reads the
//    corpus once. The queries sit in shared memory in mma.cuh's K-major
//    layout (f32 as is with its TF32 low part, bf16 rounded to bf16, u8's
//    as bf16 q_hi and q_lo), all of D when they fit, else staged chunk by
//    chunk, with their dimensions permuted as the rows' (below).
// 2. The CTA walks its slab in tiles of 64 rows (wgmma m) and chunks of 128
//    dimensions (u8: 256); the accumulators carry across chunks. The rows
//    never touch shared memory: each thread loads its two rows' share of a
//    chunk from global memory straight into registers, 16-byte vectors in
//    the layout of wgmma's A fragment (a permutation of the dimensions,
//    matched by the queries'), and the next item's loads are in flight while
//    this one multiplies, keys and re-scores (two register sets; one wave of
//    CTAs, one to three per SM, 16 KB or more in flight per SM). The raw f32
//    bits go to TF32 wgmma (m64nNk8) three times per step, as 3xTF32
//    (x_hi q_hi + x_hi q_lo + x_lo q_hi: the low parts exact remainders, q_lo
//    staged beside q, x_lo made in registers), so each product keeps about
//    3 2^-20 of error, not TF32's 2^-9; bf16 runs bf16 wgmma (m64nNk16),
//    whose products are exact; u8 widens each code in registers to bf16
//    (exact: a byte permute into the f32 2^23 + c, minus 2^23, the top half)
//    and runs bf16 wgmma twice per step, against q_hi and q_lo: the TPU's
//    split, exact products that drop at most 2^-16 of each. Each row's
//    squared norm is summed from the same registers (u8: by dp4a, in
//    integers); the mode's aux is the caller's and is not trusted as a norm.
// 3. Gate. kernels/knn.py:knn_margin bounds |s~ - s| per (row, query) by
//    T = kappa ||q|| ||x|| f + m_abs f + m_aux |aux| (f = |aux| for cosine,
//    else 1; kappa ||q|| arrives per query, +inf for a query that is not
//    finite or not below 2^50; a row whose squared norm is not below 2^100
//    gets ||x|| = +inf): truncated or split operands, tensor-core
//    accumulation, the FMA chain, the mode's transform and the compare's
//    roundings, times 2.
//    A pair is admitted when s~ + T (l2: s~ - T) could still reach the
//    query's k-th best exact score in the CTA's buffer, compared with >=
//    (an equal score wins on a lower row); a NaN anywhere admits. A row
//    that fails the mask is admitted only while the buffer has room for
//    INT_MIN keys. Admitted (row, query) pairs go to a list in shared
//    memory (a warp vote, then one warp-aggregated slot claim per register
//    any lane admits from). On the CTA's first tile (k <= 64, no exclusion
//    bound) the threshold starts at each query's k-th best s~ - T (l2:
//    s~ + T) over the tile's passing rows, not open: k rows reach it, so
//    the first tile admits about k rows per query, not 64.
// 4. Re-score, once 32 pairs per warp that owns a live query are pending (128
//    from four queries on) or the CTA's work ends (the thresholds lag
//    meanwhile, which only admits more): warp w, which owns queries w, w + 4,
//    ..., gathers the pending pairs of its queries into its queue and
//    re-scores them 32 at a time, one per lane, with the exact arithmetic
//    above from global memory (the row was just read: L2; a batch's query
//    loads touch at most NQ / 4 queries), keys them, applies the mask and the
//    exclusion bound and merges the composites into their sorted buffers
//    (topk.cuh: warp_merge, one merge per query and batch). Then the warp sets
//    each of its queries' thresholds from a key that k rows anywhere reach,
//    which keeps every row below it out of the final top k: the buffer's k-th
//    key; or, from a per-query row in global memory where every CTA publishes
//    its buffer's key at rank r = ceil(2 k / CTAs), the row's m-th best key,
//    m = ceil(k / r) (m CTAs with r rows each): a bound drawn from all the
//    slabs, not one, so the CTAs stop re-scoring rows that only beat their own
//    slab's k-th; or the best such key any CTA has kept (a per-query int,
//    atomicMax), which each tile also reads between rounds. Composites are
//    unique, so the selection is a set function: a pair left out could never
//    have entered the merged top k, and the result is the top k of the exact
//    scores of every row, bit for bit. Each launch adds its re-scored pairs to
//    a device counter.
// The slab's top k per query goes to partial[(slab, q, k)]. knn_merge: one
// CTA per query selects the final top k from all slabs' partials the same
// way.
//
// The pruned scan (innr_knn_scan_tiles) replaces the TPU kernels
// innr_tpu/kernels/pruned_knn.py:_pruned_kernel (static grid) and
// _pruned_outer_kernel (dynamic pipeline): the same scan over a survivor
// tile list (the kTiles instantiations). The live tiles order[0..*n_live)
// are cut into chunks of chunk_rows rows, and the chunks are dealt in turn
// to one wave of resident CTAs (the caller sizes the grid); each CTA runs
// the body above over all its chunks as one load pipeline into one top-k
// buffer and writes one partial list, and knn_merge merges them as for K1.
// n_live stays on the device, so a plan made on the device never waits for
// the host. Composites are unique, so the result equals the full scan's
// whenever the plan keeps every tile that holds a top-k row.
//
// The wide scan (kWide = kWideVecs, f32 corpora at many queries) replaces
// the same TPU kernel (_knn_kernel) as a second schedule of the same full
// scan: the same products, gate, margin, re-score, thresholds and partials,
// so the same composites bit for bit. The planner (kernels/knn.py:
// scan_path) takes it from Q >= 256 wherever innr_knn_grid gives it a
// layout: f32, D <= 96 with D % 4 == 0, two 64-query warpgroups fitting at
// this k (k <= 12 at D = 96). At Q = 10,000 the tile scan above is 157
// CTAs of 64 queries over the whole corpus (one wave, 59% of the card's
// CTA slots, 25 SMs with two), and each CTA's tile waits on its own loads,
// products, gate and barrier in turn; the wide scan instead:
// 1. is persistent: resident CTAs x SMs (132: one a CTA, 384 threads),
//    walking items (query tile pair, slab) slab-major, blockIdx.x + i
//    gridDim.x, so CTAs at work together share a slab's rows through L2;
//    the planner cuts the corpus into grid x ceil(8 / pairs) slabs, every
//    CTA the same count of items, at least 8 (kernels/knn.py:
//    _wide_slab_rows). Each item writes partial[(slab, q, k)] and
//    publishes into its slab's entry of the shared-key table.
// 2. reads the rows through a ring of kStages = 3 tiles of 64 rows in
//    shared memory, one cp.async.bulk a tile (a row tile of a row-major
//    corpus is contiguous), filled by one thread of a producer warpgroup
//    that gives up its registers (setmaxnreg: 40, the consumers 232); the
//    consumers load their A fragments from the ring (odd rows read each
//    pair of vectors in the other order: a 96-float row stride puts rows g
//    and g + 1 on the same banks) and issue no global load but the gate's
//    aux and mask and the re-score's.
// 3. has two consumer warpgroups, each with its own 64-query tile, buffers,
//    list, thresholds and re-score queue, on every ring tile: the tile is
//    read once from L2 or HBM and twice from shared memory, and one
//    warpgroup's gate runs under the other's products.
// 4. multiplies D rounded up to 16 (12 k-steps at D = 96, 36 wgmma a tile,
//    not the tile scan's 16 and 48): 6 vectors a row and thread, one chunk
//    of 96 dimensions.
// 5. fits or falls back. Shared memory at D = 96, k = 10: two warpgroups of
//    77,824 bytes (buffers 5,120; queries' two parts 49,152; list 21,120;
//    queues 1,280; per-query words 1,040), the ring 73,728, barriers 48:
//    229,424 of 232,448. Where that does not fit (D = 96 at k >= 13; a
//    larger k at a smaller D), or D > 96, the planner keeps the tile scan.
//    Narrower warpgroups (32 or 16 queries, as D up to 128 or k up to 256
//    would need; at D = 128 with 8 vectors a row and thread, 64 queries
//    need 286,720 bytes) were built and measured: slower than the tile
//    scan wherever its grid fills the card, faster only where it does not
//    (the crossover below), so they were taken out.
// Two changes made it pay, both in the body the schedules share: every
// register's admission without a branch (the compiler had made one per
// register, each a serial chain: 5,300 of a warpgroup tile's 8,300 cycles),
// and the gate's aux, mask and per-query words read ahead of the products.
// Crossover (scripts/knn_wide_probe.py: 10M x D unit f32 rows, L2, ms a
// call, tile / wide, the mean of two turns each; H100 80GB HBM3, 700 W).
// 64-query warpgroups, D = 96, k = 10: Q = 128: 4.78 / 4.94; 256: 8.58 /
// 7.95; 512: 16.38 / 14.05; 1,024: 33.87 / 27.85; 2,048: 66.31 / 55.01;
// 10,000: 494.0 / 252.6. D = 32 and 64, k = 10, and D = 96, k = 12, at Q =
// 128 / 256 / 1,024 / 10,000: wide over tile 1.03 / 0.93 / 0.83 / 0.52,
// 1.03 / 0.93 / 0.80 / 0.52, 1.12 / 0.99 / 0.81 / 0.52. So from Q = 256.
// 32- and 16-query warpgroups (D = 96 at k = 100 and 256, D = 100 and 128
// at k = 10, 100 and 256), wide over tile at Q = 256 / 1,024 / 2,048 /
// 10,000: 1.40 / 0.98 / 0.96 / 0.60 (D 96, k 100), 1.42 / 1.32 / 1.31 /
// 0.85 (D 100, k 10), 1.34 / 1.19 / 1.21 / 0.86 (D 128, k 10), and at the
// other five 1.47-1.65 at Q = 256, 0.67-1.11 at 10,000; at D = 128, k =
// 10, Q = 4,096 / 8,448 / 12,000 / 16,896 / 20,000: 1.31 / 1.37 / 1.08 /
// 1.38 / 0.95; at D = 96, k = 100, Q = 4,096 / 8,448 / 16,896 / 20,000:
// 0.91 / 1.00 / 1.03 / 0.82. They win only where the tile scan's grid
// leaves SMs idle (157 query tiles at Q = 10,000 on 264 CTA slots; 313 at
// 20,000), so no query count is their crossover. The tile scan before the
// branch-free gate read 3.96, 7.18, 13.25, 51.12 and 803.6 ms at D = 96,
// k = 10, Q = 64, 128, 256, 1,024 and 10,000.
//
// What bounds it on the H100: reading the corpus. At Q = 32 the 3xTF32
// products of 10M x 128 are 246 GFLOP, 0.50 ms at TF32's 495 TFLOP/s (bf16
// 20M x 128: 164 GFLOP, 0.17 ms at 989; u8 1M x 768, two bf16 products a
// pair and dimension: 98 GFLOP, 0.10 ms), against 1.53 ms for its 5.12 GB
// at 3.35 TB/s (u8: 0.23 ms for 768 MB); u8's widening costs about 2.5
// instructions a code (0.07 ms over 1M x 768 at the SMs' issue rate). The
// gate costs a few instructions per pair; the re-scores, each D FMAs in a
// chain that reads its row and query from L2, are what the thresholds let
// through (PERF.md gives the measured times, re-scored pairs and the
// phases' shares from scripts/knn_probe.py). With one warpgroup per CTA
// the products, gate and re-score of a tile run in lockstep; the next
// item's loads overlap them, and the other CTAs on the SM overlap each
// other. u8's queries take 4 bytes a dimension in shared memory (both
// parts), 98 KB at Q = 32 and D = 768, so two CTAs fit an SM there, and
// the loads alone (16 KB a CTA in flight) read at about 0.7 of the HBM
// rate. Left for later: more bytes in flight per SM (a 384-dimension u8
// item and an L2 prefetch of the next tile did not help), a merge that
// skips slabs by their sorted partials.
//
// What bounds the wide scan: its 3xTF32 operations. Deep-100M's 10,000
// queries over 100M x 96 rows are 2 Q N D = 192 TFLOP, 388 ms at TF32's
// 495 TFLOP/s; the scan does three products over D rounded to 16, 36
// m64n64k8 on each of 2.45e8 blocks of 64 rows x 64 queries, 1.1 s at the
// 32 cycles an m64n64k8 takes when nothing else runs (1.98 GHz;
// scripts/knn_wide_probe.py and PERF.md give the measured times). A
// warpgroup's tile takes about 4,900 cycles (clock64 by phase, PERF.md):
// the A fragments from the ring, their low parts, the products and their
// wait, about 2,200 (both warpgroups' products share the tensor cores); the
// gate, about 1,600; its reads ahead and the wait for the ring, about 600.
// Turns that make the warpgroups alternate their products (an ordered pair
// of barriers) measured no faster, and were left out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"   // K-major tiles, wgmma, cp.async
#include "topk.cuh"  // total_key, composite, warp_offer, warp_merge
#include "vec.cuh"   // widen, Vec16, vector_loads

namespace {

constexpr int kThreads = 256;  // knn_merge, fill_int
constexpr int kWarps = kThreads / 32;

// Queries join a bf16 corpus rounded to bf16 (products are then exact).
template <typename T>
__device__ __forceinline__ float query_value(float q) { return q; }
template <>
__device__ __forceinline__ float query_value<__nv_bfloat16>(float q) {
  return __bfloat162float(__float2bfloat16_rn(q));
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// ---------------------------------------------------------------------------
// The tensor-core scan
// ---------------------------------------------------------------------------

constexpr int kTcThreads = kWgThreads;  // one warpgroup
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcRows = 64;             // rows per tile: wgmma m
constexpr int kTcQueryMax = 64;         // the widest query tile: wgmma n
constexpr int kQueue = 64;              // a warp's re-score queue: two batches of 32
constexpr int kPubPerLane = 16;         // published keys a lane reads (up to 512 CTAs)
constexpr size_t kSmemMax = 232448;     // dynamic shared memory a block may use

// A chunk of Tc<T>::kChunk dimensions of a row is loaded as kVecs 16-byte
// vectors per thread: thread t of a quad (t = lane % 4) takes vectors 4 j +
// t (j = 0, 1, ...), so a quad reads 64 contiguous bytes at a time. f32 and
// bf16: k-step s takes words 2 (s % 2) and 2 (s % 2) + 1 of vector j = s / 2
// as its A fragment (a0 / a2: the first row, a1 / a3: the second); u8: word
// s % 4 of vector s / 4, widened to two bf16x2 words. So the tensor core's k
// positions are a permutation of the dimensions (perm_dim), and the queries
// are staged in the same permutation. Tc<T>::Q is the queries' staged type.
template <typename T> struct Tc;
// The low part of an f32 operand: x minus its TF32 truncation, exact.
__device__ __forceinline__ uint32_t tf32_low(uint32_t w) {
  return __float_as_uint(__fsub_rn(__uint_as_float(w), __uint_as_float(w & 0xFFFFE000u)));
}

// Words 2 (st % 2) and + 1 of vector st / 2 of both rows: the A fragment of
// k-step st where a step takes half a vector (f32, bf16).
template <int V>
__device__ __forceinline__ void half_vector(const uint4 (&v)[2][V], int st, uint32_t (&a)[4]) {
  const int j = st >> 1, w = 2 * (st & 1);
  a[0] = word(v[0][j], w);
  a[1] = word(v[1][j], w);
  a[2] = word(v[0][j], w + 1);
  a[3] = word(v[1][j], w + 1);
}

// Both rows' squared norms += their elements' squares, an fmaf chain.
template <typename T, int V>
__device__ __forceinline__ void fma_norms(float (&n2)[2], const uint4 (&v)[2][V]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int e = 0; e < Vec16<T>::kElems; ++e) {
        const float x = Vec16<T>::get(v[h][j], e);
        n2[h] = fmaf(x, x, n2[h]);
      }
}

// f32: three TF32 products per k-step, x_hi q_hi + x_hi q_lo + x_lo q_hi
// (3xTF32; the tensor core truncates the raw f32 bits of x and q to x_hi
// and q_hi, and x_lo, q_lo are the exact remainders, themselves truncated),
// which leaves about 3 2^-20 of each product, not TF32's 2^-9.
template <> struct Tc<float> {
  using Q = float;
  static constexpr int kChunk = 128;  // dimensions per item
  static constexpr int kSteps = 16;   // m64nNk8
  static constexpr int kVecs = 8;
  static constexpr int kSplit = 2;    // query parts staged: q_hi, q_lo
  static constexpr int kMinBlocks = 2;
  template <int A, int V>
  __device__ __forceinline__ static void mma(float (&acc)[A], const uint4 (&v)[2][V], int st,
                                             uint64_t b_hi, uint64_t b_lo) {
    uint32_t a[4];
    half_vector(v, st, a);
    wgmma_tf32_rs(acc, a[0], a[1], a[2], a[3], b_hi);
    wgmma_tf32_rs(acc, a[0], a[1], a[2], a[3], b_lo);
    wgmma_tf32_rs(acc, tf32_low(a[0]), tf32_low(a[1]), tf32_low(a[2]), tf32_low(a[3]), b_hi);
  }
  template <int V>
  __device__ __forceinline__ static void add_norms(float (&n2)[2],
                                                   const uint4 (&v)[2][V]) {
    fma_norms<float>(n2, v);
  }
  // The query's part `part` (0: as is, 1: its low part) as staged.
  __device__ static float stored(float q, int part) {
    return part == 0 ? q : __uint_as_float(tf32_low(__float_as_uint(q)));
  }
  __device__ static float zero() { return 0.0f; }
  // The 32-bit word of a row from element col (zero past d or off the item).
  __device__ static unsigned word_of(const float* src, int col, int d, bool in) {
    return in && col < d ? __float_as_uint(src[col]) : 0u;
  }
  // Chunk-local dimension of k position kk: step s = kk / 8, position q =
  // kk % 8 holds element q / 4 of the step's pair in quad thread q % 4.
  __device__ static int perm_dim(int kk) {
    const int s = kk >> 3, q = kk & 7;
    return 16 * (s >> 1) + 4 * (q & 3) + 2 * (s & 1) + (q >> 2);
  }
};
// bf16: the products of bf16 rows and bf16-rounded queries are exact.
template <> struct Tc<__nv_bfloat16> {
  using Q = __nv_bfloat16;
  static constexpr int kChunk = 128;
  static constexpr int kSteps = 8;  // m64nNk16
  static constexpr int kVecs = 4;
  static constexpr int kSplit = 1;
  static constexpr int kMinBlocks = 3;
  template <int A, int V>
  __device__ __forceinline__ static void mma(float (&acc)[A], const uint4 (&v)[2][V], int st,
                                             uint64_t b, uint64_t) {
    uint32_t a[4];
    half_vector(v, st, a);
    wgmma_bf16_rs(acc, a[0], a[1], a[2], a[3], b);
  }
  template <int V>
  __device__ __forceinline__ static void add_norms(float (&n2)[2],
                                                   const uint4 (&v)[2][V]) {
    fma_norms<__nv_bfloat16>(n2, v);
  }
  __device__ static __nv_bfloat16 stored(float q, int) { return __float2bfloat16_rn(q); }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.0f); }
  __device__ static unsigned word_of(const __nv_bfloat16* src, int col, int d, bool in) {
    const unsigned lo = in && col < d ? __bfloat16_as_ushort(src[col]) : 0u;
    const unsigned hi = in && col + 1 < d ? __bfloat16_as_ushort(src[col + 1]) : 0u;
    return lo | hi << 16;
  }
  // Step s = kk / 16, position q = kk % 16: quad thread (q % 8) / 2,
  // element q % 2 + 2 (q / 8) of the step's four.
  __device__ static int perm_dim(int kk) {
    const int s = kk >> 4, q = kk & 15;
    return 32 * (s >> 1) + 8 * ((q & 7) >> 1) + 4 * (s & 1) + (q & 1) + 2 * (q >> 3);
  }
};

// Codes 2 h and 2 h + 1 of a word of four, as one bf16x2 word of an A
// fragment (the first in the low half): each code c widened to f32
// (vec.cuh: code_f32), whose top 16 bits are the bf16 c (c has at most 8
// significant bits).
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w, int h) {
  return __byte_perm(__float_as_uint(code_f32(w, 2 * h)), __float_as_uint(code_f32(w, 2 * h + 1)),
                     0x7632u);
}

// u8: codes 0..255 are exact in bf16, and the query is split as on the TPU
// into q_hi = bf16(q) and q_lo = bf16(q - q_hi) (0 where q is not finite):
// two bf16 products per k-step, each exact, which leave at most 2^-16 of
// each product. A chunk is 256 dimensions, so each thread loads 4 vectors
// of 16 codes per row and item (as bf16's 4 of 8 elements): the bytes in
// flight per CTA are bf16's.
template <> struct Tc<uint8_t> {
  using Q = __nv_bfloat16;
  static constexpr int kChunk = 256;
  static constexpr int kSteps = 16;  // m64nNk16
  static constexpr int kVecs = 4;
  static constexpr int kSplit = 2;   // q_hi, q_lo
  static constexpr int kMinBlocks = 3;
  template <int A, int V>
  __device__ __forceinline__ static void mma(float (&acc)[A], const uint4 (&v)[2][V], int st,
                                             uint64_t b_hi, uint64_t b_lo) {
    const uint32_t x0 = word(v[0][st >> 2], st & 3), x1 = word(v[1][st >> 2], st & 3);
    const uint32_t a0 = codes_bf16x2(x0, 0), a1 = codes_bf16x2(x1, 0);
    const uint32_t a2 = codes_bf16x2(x0, 1), a3 = codes_bf16x2(x1, 1);
    wgmma_bf16_rs(acc, a0, a1, a2, a3, b_hi);
    wgmma_bf16_rs(acc, a0, a1, a2, a3, b_lo);
  }
  // Each row's squares in integers: a chunk's 64 codes a thread give at
  // most 64 x 255^2 < 2^24, exact in f32.
  template <int V>
  __device__ __forceinline__ static void add_norms(float (&n2)[2],
                                                   const uint4 (&v)[2][V]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned s = 0u;
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int w = 0; w < 4; ++w) s = __dp4a(word(v[h][j], w), word(v[h][j], w), s);
      n2[h] += static_cast<float>(s);
    }
  }
  __device__ static __nv_bfloat16 stored(float q, int part) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(q);
    if (part == 0) return hi;
    return __float2bfloat16_rn(isfinite(q) ? __fsub_rn(q, __bfloat162float(hi)) : 0.0f);
  }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.0f); }
  // Four codes from col (zeros past d or off the item).
  __device__ static unsigned word_of(const uint8_t* src, int col, int d, bool in) {
    unsigned w = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (in && col + b < d) w |= static_cast<unsigned>(src[col + b]) << (8 * b);
    return w;
  }
  // Step s = kk / 16 (word s % 4 of vector s / 4), position q = kk % 16:
  // quad thread (q % 8) / 2, code q % 2 + 2 (q / 8) of the word.
  __device__ static int perm_dim(int kk) {
    const int s = kk >> 4, q = kk & 15;
    return 64 * (s >> 2) + 16 * ((q & 7) >> 1) + 4 * (s & 3) + (q & 1) + 2 * (q >> 3);
  }
};

// Byte offsets of a warpgroup's shared memory: the top-k buffers, the
// queries (all of D, or one chunk), a tile's admitted pairs, per-query
// words. The wide scan holds two such regions, wg bytes apart, then its ring
// of kStages row tiles (stage bytes each) and the ring's barriers.
struct TcLayout {
  int nq, dpad, n_dch;  // query tile, D padded to whole chunks, chunks
  bool q_res;           // all of D of the queries resident
  size_t best, q, q_part, list, queue, bound, thr, kq, red, total;
  size_t wg, ring, stage, bars;
};

inline size_t align128(size_t x) { return (x + 127) & ~static_cast<size_t>(127); }

template <typename T>
TcLayout tc_layout(int nq, int d, int k, bool q_res, int chunk = Tc<T>::kChunk) {
  TcLayout L{};
  L.nq = nq;
  L.n_dch = (d + chunk - 1) / chunk;
  L.dpad = L.n_dch * chunk;
  L.q_res = q_res;
  size_t at = 0;
  L.best = at;
  at = align128(at + sizeof(long long) * nq * k);
  L.q = at;  // Tc<T>::kSplit parts, each nq x (dpad or chunk)
  L.q_part = align128(sizeof(typename Tc<T>::Q) * nq * (q_res ? L.dpad : chunk));
  at += Tc<T>::kSplit * L.q_part;
  L.list = at;  // pending admitted pairs: under 128, plus a tile's 64 x nq
  at = align128(at + (sizeof(int) + 1) * (kTcRows * nq + kTcThreads));
  L.queue = at;  // each warp's queue of pairs to re-score: 64 rows, 64 queries
  at += (sizeof(int) + 1) * kQueue * kTcWarps;
  L.bound = at;
  at += 8 * kTcQueryMax;
  L.thr = at;
  at += 4 * kTcQueryMax;
  L.kq = at;
  at += 4 * kTcQueryMax;
  L.red = at;
  at += 16;
  L.total = at;
  return L;
}

// The query tile: the smallest of 8, 16, 32, 64 that holds min(Q, 64),
// halved while its buffers do not fit; queries resident when they fit,
// else staged chunk by chunk.
template <typename T>
TcLayout tc_plan(int n_q, int d, int k) {
  int nq = 8;
  while (nq < kTcQueryMax && nq < n_q) nq *= 2;
  for (;; nq /= 2) {
    TcLayout L = tc_layout<T>(nq, d, k, true);
    if (L.total <= kSmemMax) return L;
    L = tc_layout<T>(nq, d, k, false);
    if (L.total <= kSmemMax || nq == 8) return L;
  }
}

// The wide scan (f32 corpora, many queries; see the note at the top): two
// consumer warpgroups and a producer warpgroup a CTA (one of its threads
// issues the copies; the warpgroup gives its registers to the consumers:
// 2 x 128 x 232 + 128 x 40 of the SM's 65,536), a ring of kStages row
// tiles, D up to kWideMaxD in one chunk of 16 kWideVecs dimensions (no
// k-step past D rounded up to 16), each warpgroup's query tile 64: the only
// shape where it measured faster than the tile scan (the note at the top).
constexpr int kWideWgs = 2;
constexpr int kWideThreads = (kWideWgs + 1) * kWgThreads;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kStages = 3;
constexpr int kWideVecs = 6;
constexpr int kWideMaxD = 16 * kWideVecs;

template <typename T>
TcLayout wide_layout(int nq, int d, int k) {
  TcLayout L = tc_layout<T>(nq, d, k, true, kWideMaxD);
  L.wg = align128(L.total);
  L.ring = kWideWgs * L.wg;
  L.stage = align128(sizeof(T) * kTcRows * d);
  L.bars = L.ring + kStages * L.stage;  // full, then empty, kStages each
  L.total = L.bars + 2 * sizeof(unsigned long long) * kStages;
  return L;
}

// nq 0 where two 64-query warpgroups and the ring do not fit at this k.
template <typename T>
TcLayout wide_plan(int d, int k) {
  const TcLayout L = wide_layout<T>(kTcQueryMax, d, k);
  return L.total <= kSmemMax ? L : TcLayout{};
}

struct TcArgs {
  const float* qs;
  const void* rows;
  const float* aux;
  const float* mask;
  const long long* excl;
  const int* ids;      // the row-id map of the composites, or null (the row)
  const float* qmeta;  // per query: kappa ||q|| (+inf: always re-scored)
  float m_abs, m_aux;  // the margin's absolute and |aux| terms
  unsigned long long* rescored;
  int* kth;  // per query a shared key k rows reach, then the published table
  const int* order;
  const int* n_live;
  long long* partial;
  int n_q;
  long long n;
  int d, k, score;
  long long slab_rows, chunk_rows;
  bool vec;  // 16-byte loads of rows and queries (D and both bases aligned)
};

// A position in a CTA's work: rows [t0, t0 + 64) of the item [.., end),
// dimension chunk ch.
struct Cursor {
  long long t0, end, item;
  int ch;
};

// This CTA's next non-empty item of the tile list after c.item, or an
// empty range when none is left.
__device__ __forceinline__ void next_item(Cursor& c, const TcArgs& p, long long per_tile,
                                          long long items) {
  c.t0 = c.end = 0;
  for (c.item += gridDim.x; c.item < items; c.item += gridDim.x) {
    const long long tile_begin = static_cast<long long>(p.order[c.item / per_tile]) * p.slab_rows;
    c.t0 = tile_begin + c.item % per_tile * p.chunk_rows;
    c.end = min(p.n, min(tile_begin + p.slab_rows, c.t0 + p.chunk_rows));
    if (c.t0 < c.end) break;
  }
}

template <bool kTiles>
__device__ __forceinline__ void advance(Cursor& c, const TcArgs& p, int n_dch, long long per_tile,
                                        long long items) {
  if (++c.ch < n_dch) return;
  c.ch = 0;
  c.t0 += kTcRows;
  if constexpr (kTiles) {
    if (c.t0 >= c.end) next_item(c, p, per_tile, items);
  }
}

// This thread's quarter of chunk c.ch of its rows g and g + 8 of the tile
// at c into v (zeros past the item's end and d).
template <typename T, int V>
__device__ __forceinline__ void load_rows(uint4 (&v)[2][V], const TcArgs& p, const Cursor& c,
                                          int g, int quad) {
  constexpr int kE = 16 / sizeof(T);
  const T* rows = static_cast<const T*>(p.rows);
  const int k0 = c.ch * Tc<T>::kChunk + kE * quad;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = c.t0 + g + 8 * h;
    const bool in = row < c.end;
    const T* src = rows + static_cast<size_t>(in ? row : 0) * p.d;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int col = k0 + 4 * kE * j;
      if (p.vec) {
        v[h][j] = (in && col < p.d) ? *reinterpret_cast<const uint4*>(src + col)
                                    : make_uint4(0u, 0u, 0u, 0u);
      } else {
        unsigned w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = Tc<T>::word_of(src, col + i * (kE / 4), p.d, in);
        v[h][j] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// This thread's rows g and g + 8 of a ring tile of f32 rows (rows_in of
// them valid, D a multiple of 4) as load_rows gives them for one chunk of
// 16 V dimensions: vectors 4 j + quad, zeros past d and past the valid rows.
// A quarter warp's 16-byte reads cover rows g and g + 1; where the row stride
// is a multiple of 128 bytes both fall on the same banks, so odd rows read
// each pair of vectors in the other order.
template <int V>
__device__ __forceinline__ void ring_rows(uint4 (&v)[2][V], const float* tile, int rows_in, int d,
                                          int g, int quad) {
  const bool swap = (g & 1) && d % 32 == 0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    const bool in = r < rows_in;
    const float* src = tile + static_cast<size_t>(in ? r : 0) * d;
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      const int c0 = 16 * (swap ? j + 1 : j) + 4 * quad, c1 = 16 * (swap ? j : j + 1) + 4 * quad;
      const uint4 x0 = in && c0 < d ? *reinterpret_cast<const uint4*>(src + c0) : zero;
      const uint4 x1 = in && c1 < d ? *reinterpret_cast<const uint4*>(src + c1) : zero;
      v[h][j] = swap ? x1 : x0;
      v[h][j + 1] = swap ? x0 : x1;
    }
  }
}

// The 3xTF32 products of a ring tile's 2 V k-steps into acc, one commit
// group (b0, b1: the staged queries' two parts). The A fragments' low parts
// x_lo are all made before the first wgmma (Tc<float>::mma makes each
// step's between the steps), so that no register an issued wgmma reads is
// written before its group completes: the compiler would otherwise fence,
// and in the wide scan serialise, each wgmma.
template <int NQ, int V>
__device__ __forceinline__ void wide_products(float (&acc)[NQ / 2], const uint4 (&v)[2][V],
                                              uint32_t b0, uint32_t b1) {
  uint32_t lo[2][V][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[h][j][e] = tf32_low(word(v[h][j], e));
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) fence_operand(acc[i]);
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < 2 * V; ++st) {
    const int j = st >> 1, e = 2 * (st & 1);
    const uint64_t d_hi = kmajor_desc(b0 + st * 2 * NQ * 16, NQ);
    const uint64_t d_lo = kmajor_desc(b1 + st * 2 * NQ * 16, NQ);
    const uint32_t a0 = word(v[0][j], e), a1 = word(v[1][j], e);
    const uint32_t a2 = word(v[0][j], e + 1), a3 = word(v[1][j], e + 1);
    wgmma_tf32_rs(acc, a0, a1, a2, a3, d_hi);
    wgmma_tf32_rs(acc, a0, a1, a2, a3, d_lo);
    wgmma_tf32_rs(acc, lo[0][j][e], lo[1][j][e], lo[0][j][e + 1], lo[1][j][e + 1], d_hi);
  }
  wgmma_commit();
}

// Queries [q0, q0 + nq) x the chunks [ch0, ch0 + n_ch) of kChunkW
// dimensions into dst (K-major, nq rows, k positions permuted as perm_dim),
// as the tensor cores read them (bf16: rounded; f32, u8: both parts); zeros
// past n_q and d. The 128 threads of a warpgroup, tid 0..127, share the work.
template <typename T, int kChunkW = Tc<T>::kChunk>
__device__ void stage_queries(typename Tc<T>::Q* dst, size_t part_elems,
                              const float* __restrict__ qs, int q0, int n_q, int d, int nq,
                              int ch0, int n_ch, int tid) {
  constexpr int kE = 16 / sizeof(typename Tc<T>::Q);
  const int width = n_ch * kChunkW;
  for (int f = tid; f < nq * width; f += kTcThreads) {
    const int r = f / width, kk = f % width;
    const int col = (ch0 + kk / kChunkW) * kChunkW + Tc<T>::perm_dim(kk % kChunkW);
    const bool ok = q0 + r < n_q && col < d;
    const float v = ok ? qs[static_cast<size_t>(q0 + r) * d + col] : 0.0f;
#pragma unroll
    for (int part = 0; part < Tc<T>::kSplit; ++part)
      dst[part * part_elems + kmajor_offset<kE>(r, kk, nq)] =
          ok ? Tc<T>::stored(v, part) : Tc<T>::zero();
  }
}

// The exact dot of row `row` and query q from global memory: fmaf in
// dimension order from +0.0 on the widened values and the f32 query (bf16
// corpora: the query rounded to bf16).
template <typename T>
__device__ __forceinline__ float exact_dot(const TcArgs& p, long long row, int q) {
  constexpr int kE = 16 / sizeof(T);
  const T* x = static_cast<const T*>(p.rows) + static_cast<size_t>(row) * p.d;
  const float* y = p.qs + static_cast<size_t>(q) * p.d;
  float acc = 0.0f;
  if (p.vec) {
#pragma unroll 8
    for (int k = 0; k < p.d; k += kE) {
      const uint4 xv = *reinterpret_cast<const uint4*>(x + k);
#pragma unroll
      for (int i = 0; i < kE; i += 4) {
        const float4 yv = *reinterpret_cast<const float4*>(y + k + i);
        acc = fmaf(Vec16<T>::get(xv, i), query_value<T>(yv.x), acc);
        acc = fmaf(Vec16<T>::get(xv, i + 1), query_value<T>(yv.y), acc);
        acc = fmaf(Vec16<T>::get(xv, i + 2), query_value<T>(yv.z), acc);
        acc = fmaf(Vec16<T>::get(xv, i + 3), query_value<T>(yv.w), acc);
      }
    }
  } else {
    for (int k = 0; k < p.d; ++k) acc = fmaf(widen(x[k]), query_value<T>(y[k]), acc);
  }
  return acc;
}

// The exact score a k-th key stands for (the admission threshold), or +inf
// (l2) / -inf while it is INT_MIN (empty or failing rows): then every row
// is admitted.
__device__ __forceinline__ float threshold(int key, int score) {
  if (key == INT_MIN) return score == 1 ? inf_f() : -inf_f();
  const int tk = score == 1 ? ~key : key;
  return __int_as_float(tk ^ (tk < 0 ? 0x7FFFFFFF : 0));
}

// One warpgroup's shared memory (a TcLayout region from base) and its
// thread: tid 0..127 in the warpgroup, warp 0..3, its rows g and g + 8 of a
// tile. bar: 0 where the warpgroup is the whole CTA, else the id of the named
// barrier of its 128 threads.
template <typename T, int NQ>
struct Wg {
  using Q = typename Tc<T>::Q;
  static constexpr int kCap = kTcRows * NQ + kTcThreads;
  long long* best;   // [NQ][k]
  Q* q_s;            // [dpad or chunk][NQ], K-major
  int* list_row;     // [kCap] rows, then [kCap] queries (list_c)
  unsigned char* list_c;
  long long* bound;  // [NQ]
  float* thr;        // [NQ]
  float* kq;         // [NQ]
  unsigned* red;     // re-scores; 3 tile counts
  int* queue_row;    // this warp's re-score queue: rows, then queries (queue_c)
  unsigned char* queue_c;
  int tid, lane, warp, quad, g, bar;

  __device__ __forceinline__ Wg(unsigned char* base, const TcLayout& L, int t, int barrier)
      : best(reinterpret_cast<long long*>(base + L.best)),
        q_s(reinterpret_cast<Q*>(base + L.q)),
        list_row(reinterpret_cast<int*>(base + L.list)),
        list_c(reinterpret_cast<unsigned char*>(list_row + kCap)),
        bound(reinterpret_cast<long long*>(base + L.bound)),
        thr(reinterpret_cast<float*>(base + L.thr)),
        kq(reinterpret_cast<float*>(base + L.kq)),
        red(reinterpret_cast<unsigned*>(base + L.red)),
        queue_row(reinterpret_cast<int*>(base + L.queue) + (t >> 5) * kQueue),
        queue_c(reinterpret_cast<unsigned char*>(base + L.queue + sizeof(int) * kQueue * kTcWarps) +
                (t >> 5) * kQueue),
        tid(t), lane(t & 31), warp(t >> 5), quad(t & 3), g(16 * (t >> 5) + ((t & 31) >> 2)),
        bar(barrier) {}

  __device__ __forceinline__ void sync() const {
    if (bar == 0) __syncthreads();
    else named_barrier(bar, kWgThreads);
  }
};

// The warpgroup's queries [q0, q0 + NQ) before its work on a slab: empty
// buffers, the tile counts cleared, each live query's margin term and
// exclusion bound, and its threshold from its shared key (open until some
// CTA has kept one).
template <typename T, int NQ>
__device__ __forceinline__ void begin_queries(const Wg<T, NQ>& w, const TcArgs& p, int q0) {
  for (int i = w.tid; i < NQ * p.k; i += kTcThreads) w.best[i] = LLONG_MIN;
  if (w.tid < NQ) {
    const int q = q0 + w.tid;
    const bool live = q < p.n_q;
    w.thr[w.tid] = threshold(live ? __ldcg(p.kth + q) : INT_MIN, p.score);
    w.kq[w.tid] = live ? p.qmeta[q] : 0.0f;
    w.bound[w.tid] = (live && p.excl != nullptr) ? p.excl[q] : LLONG_MAX;
  }
  if (w.tid == 0) w.red[0] = w.red[1] = w.red[2] = w.red[3] = 0u;
}

// The gate's inputs of this thread's rows g and g + 8 of the tile at t0:
// within the work's end, the mode's aux, the predicate.
struct RowIn {
  bool ok[2], pass[2];
  float a[2];
};

__device__ __forceinline__ RowIn row_inputs(const TcArgs& p, long long t0, long long end, int g) {
  RowIn r;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = t0 + g + 8 * h;
    r.ok[h] = row < end;
    r.a[h] = (r.ok[h] && p.aux != nullptr) ? p.aux[row] : 0.0f;
    r.pass[h] = !(r.ok[h] && p.mask != nullptr) || p.mask[row] > 0.0f;
  }
  return r;
}

// A per-query word (kq, thr) of each query column this thread's
// accumulators hold: register i's column acc_col(i, tid) = 8 (i / 4) + 2
// quad + i % 2 is entry 2 (i / 4) + i % 2.
template <int NQ>
__device__ __forceinline__ void column_words(float (&out)[NQ / 4], const float* src, int quad) {
#pragma unroll
  for (int j = 0; j < NQ / 4; ++j) out[j] = src[8 * (j >> 1) + 2 * quad + (j & 1)];
}

// The gate over a tile's accumulators (rows [t0, t0 + 64), the work's end
// `end`; tile: the tile's index in the work, 0 for its first; rin, kq and
// thr: row_inputs and the column_words of w.kq and w.thr, which the first
// tile's bound may update): appends the admitted pairs to the list after the
// `pending` ones and returns the list's length.
template <typename T, int NQ>
__device__ __forceinline__ int gate(const Wg<T, NQ>& w, const TcArgs& p, const float (&acc)[NQ / 2],
                                    const float (&n2)[2], long long t0, int tile, int pending,
                                    int q0, const RowIn& rin, const float (&kq)[NQ / 4],
                                    float (&thr)[NQ / 4]) {
  constexpr int kAcc = NQ / 2;
  const int tid = w.tid, lane = w.lane, warp = w.warp, g = w.g, k = p.k, score = p.score;
  // Admitted pairs are counted in red[1 + tile % 3]; the count two tiles
  // ahead is cleared here (all its reads are two barriers back).
  unsigned* n_tile = w.red + 1 + tile % 3;
  if (tid == 0) w.red[1 + (tile + 1) % 3] = 0u;
  const bool(&ok)[2] = rin.ok;
  const bool(&pass)[2] = rin.pass;
  const float(&a)[2] = rin.a;
  float kx[2], cx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float r2 = n2[h] + __shfl_xor_sync(0xFFFFFFFFu, n2[h], 1);
    r2 += __shfl_xor_sync(0xFFFFFFFFu, r2, 2);
    // ||x|| plus the slack of squares that underflow; +inf (NaN, inf,
    // not below 2^50) admits every pair of the row.
    const float xn = r2 < 0x1p100f ? sqrtf(r2) + 0x1p-59f : inf_f();
    const float rowf = score == 2 ? fabsf(a[h]) : 1.0f;
    kx[h] = xn * rowf;
    cx[h] = fmaf(p.m_aux, fabsf(a[h]), p.m_abs * rowf);
  }
  // Register i's tensor-core score in the mode's terms and its margin.
  auto gate_terms = [&](int i, float& sv, float& tb) {
    const int h = (i >> 1) & 1;
    sv = acc[i];
    if (score == 1) sv = fmaf(-2.0f, sv, a[h]);
    else if (score == 2) sv = sv * a[h];
    tb = fmaf(kq[2 * (i >> 2) + (i & 1)], kx[h], cx[h]);
  };
  // The first tile of the work (k <= 64, no exclusion bound): each query's
  // k-th best of the bounds s~ - T (l2: s~ + T) of the tile's passing rows
  // is a threshold: k rows reach it, so no row whose s~ + T (l2: s~ - T)
  // falls short of it can enter the top k, and the buffers start near their
  // k-th, not open (those k rows are admitted). Each warp selects for its
  // queries from a [NQ][64] table in the list's space (empty here).
  if (tile == 0 && k <= kTcRows && p.excl == nullptr) {
    float* lb = reinterpret_cast<float*>(w.list_row);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int h = (i >> 1) & 1, c = acc_col(i, tid);
      float v = -inf_f();  // no bound: the row is outside, fails or is NaN
      if (ok[h] && pass[h] && q0 + c < p.n_q) {
        float sv, tb;
        gate_terms(i, sv, tb);
        const float b = score == 1 ? -(sv + tb) : sv - tb;
        if (b == b) v = b;
      }
      lb[c * kTcRows + g + 8 * h] = v;
    }
    w.sync();
    for (int c = warp; c < NQ; c += kTcWarps) {
      const float v0 = lb[c * kTcRows + lane], v1 = lb[c * kTcRows + 32 + lane];
      int ge0 = 0, ge1 = 0;  // how many of the 64 are >= v0, >= v1
      for (int j = 0; j < 32; ++j) {
        const float w0 = __shfl_sync(0xFFFFFFFFu, v0, j), w1 = __shfl_sync(0xFFFFFFFFu, v1, j);
        ge0 += (w0 >= v0) + (w1 >= v0);
        ge1 += (w0 >= v1) + (w1 >= v1);
      }
      float b = fmaxf(ge0 >= k ? v0 : -inf_f(), ge1 >= k ? v1 : -inf_f());
      for (int o = 16; o > 0; o >>= 1) b = fmaxf(b, __shfl_xor_sync(0xFFFFFFFFu, b, o));
      if (lane == 0 && b > -inf_f())
        w.thr[c] = score == 1 ? fminf(w.thr[c], -b) : fmaxf(w.thr[c], b);
    }
    w.sync();
    column_words<NQ>(thr, w.thr, w.quad);
  }
  // The admission of every register, without a branch: in terms where
  // larger is better for every mode (l2 negated: s' = -s~ = fmaf(2, acc, -a)
  // and t' = -t, exact, so !(s~ - T > t) reads !(s' + T < t')), a passing
  // row's pair is admitted when !(s' + T < t') (a NaN admits), a failing
  // row's while the threshold is open (an INT_MIN key can still enter), and
  // no pair of a row past the work's end or of a query past Q. Register i
  // holds column entry j = 2 (i / 4) + i % 2 and row h = (i / 2) % 2, so
  // entry j's registers are bits 5 << (4 (j / 2) + j % 2) and row h's the
  // nibble pattern 0x3 << 2 h.
  const float mul[2] = {score == 1 ? 2.0f : score == 2 ? a[0] : 1.0f,
                        score == 1 ? 2.0f : score == 2 ? a[1] : 1.0f};
  const float add[2] = {score == 1 ? -a[0] : 0.0f, score == 1 ? -a[1] : 0.0f};
  const unsigned rows_ok = (ok[0] ? 0x33333333u : 0u) | (ok[1] ? 0xCCCCCCCCu : 0u);
  const unsigned rows_pass = (pass[0] ? 0x33333333u : 0u) | (pass[1] ? 0xCCCCCCCCu : 0u);
  const int cols = p.n_q - q0 - 2 * w.quad;  // entry j is a live query below this
  float tp[NQ / 4];
  unsigned live = 0u, opened = 0u, beats = 0u;
#pragma unroll
  for (int j = 0; j < NQ / 4; ++j) {
    tp[j] = score == 1 ? -thr[j] : thr[j];
    const unsigned bits = 5u << (4 * (j >> 1) + (j & 1));
    live |= 8 * (j >> 1) + (j & 1) < cols ? bits : 0u;
    opened |= tp[j] == -inf_f() ? bits : 0u;
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int h = (i >> 1) & 1, j = 2 * (i >> 2) + (i & 1);
    const float u = fmaf(acc[i], mul[h], add[h]) + fmaf(kq[j], kx[h], cx[h]);
    beats |= static_cast<unsigned>(!(u < tp[j])) << i;
  }
  // Admitted pairs go to the list after the pending ones: one vote of
  // the warp, then (rarely) one warp-aggregated slot claim per register.
  const unsigned admitted = rows_ok & live & ((rows_pass & beats) | (~rows_pass & opened));
  // The registers any lane admits from, in turn (warp-uniform).
  for (unsigned regs = __reduce_or_sync(0xFFFFFFFFu, admitted); regs != 0u; regs &= regs - 1u) {
    const int i = __ffs(regs) - 1;
    const bool admit = (admitted >> i) & 1u;
    const unsigned am = __ballot_sync(0xFFFFFFFFu, admit);
    const int leader = __ffs(am) - 1;
    unsigned slot = 0;
    if (lane == leader) slot = atomicAdd(n_tile, __popc(am));
    slot = pending + __shfl_sync(0xFFFFFFFFu, slot, leader) + __popc(am & ((1u << lane) - 1u));
    if (admit) {
      w.list_row[slot] = static_cast<int>(t0 + g + 8 * ((i >> 1) & 1));
      w.list_c[slot] = static_cast<unsigned char>(acc_col(i, tid));
    }
  }
  w.sync();
  return pending + static_cast<int>(*n_tile);
}

// Between re-score rounds, the best k-th key any CTA had published at the
// tile's start tightens the threshold; a gate may read it before or after
// the store, and either value is safe.
template <typename T, int NQ>
__device__ __forceinline__ void tighten(const Wg<T, NQ>& w, int published, int score) {
  if (w.tid < NQ && published != INT_MIN) {
    const float t = threshold(published, score);
    w.thr[w.tid] = score == 1 ? fminf(w.thr[w.tid], t) : fmaxf(w.thr[w.tid], t);
  }
}

// Each warp re-scores the `total` listed pairs of its queries (c % 4 ==
// warp) and offers them to their buffers, 32 at a time: its share of the
// list is gathered into its queue, so a batch's query loads touch at most
// NQ / 4 queries and no lane idles until the list runs out.
template <typename T, int NQ>
__device__ __forceinline__ void rescore(const Wg<T, NQ>& w, const TcArgs& p, int total, int q0,
                                        unsigned& count) {
  const int lane = w.lane, k = p.k, score = p.score;
  for (int j0 = 0, have = 0; j0 < total || have > 0;) {
    if (j0 < total) {
      const int j = j0 + lane;
      const int c = j < total ? w.list_c[j] : -1;
      const bool mine = c >= 0 && c % kTcWarps == w.warp;
      const unsigned mm = __ballot_sync(0xFFFFFFFFu, mine);
      if (mine) {
        const int at = have + __popc(mm & ((1u << lane) - 1u));
        w.queue_row[at] = w.list_row[j];
        w.queue_c[at] = static_cast<unsigned char>(c);
      }
      have += __popc(mm);
      j0 += 32;
      __syncwarp();
      if (have < 32 && j0 < total) continue;
    }
    const int n_b = min(have, 32);
    int c = -1;
    long long cand = LLONG_MIN;
    if (lane < n_b) {
      c = w.queue_c[lane];
      const long long row = w.queue_row[lane];
      int key = INT_MIN;
      if (p.mask == nullptr || p.mask[row] > 0.0f) {
        float sc = exact_dot<T>(p, row, q0 + c);
        ++count;
        const float av = p.aux != nullptr ? p.aux[row] : 0.0f;
        if (score == 1) sc = __fsub_rn(av, __fmul_rn(2.0f, sc));
        else if (score == 2) sc = __fmul_rn(sc, av);
        key = total_key(sc);
        if (score == 1) key = ~key;
      }
      cand = composite(key, p.ids != nullptr ? static_cast<long long>(p.ids[row]) : row);
      if (cand >= w.bound[c]) cand = LLONG_MIN;
    }
    // The rest of the queue moves to its front.
    const int rest = have - n_b;
    const int r_row = lane < rest ? w.queue_row[32 + lane] : 0;
    const unsigned char r_c = lane < rest ? w.queue_c[32 + lane] : 0;
    __syncwarp();
    if (lane < rest) {
      w.queue_row[lane] = r_row;
      w.queue_c[lane] = r_c;
    }
    have = rest;
    __syncwarp();
    // One merge per query present in the batch.
    for (unsigned todo = __ballot_sync(0xFFFFFFFFu, c >= 0); todo != 0u;) {
      const int c0 = __shfl_sync(0xFFFFFFFFu, c, __ffs(todo) - 1);
      const bool in = c == c0;
      todo &= ~__ballot_sync(0xFFFFFFFFu, in);
      warp_merge(w.best + c0 * k, k, in ? cand : LLONG_MIN, lane);
    }
  }
}

// The gate's thresholds after a re-score round, by the warp that owns each
// query: a key that k rows anywhere reach keeps every row below it out of
// the final top k, so the merged result is unchanged. This buffer's key at
// rank r goes to entry `slab` of the query's row of the published table (r
// rows of this slab reach it; n_slabs entries); the row's m-th best key (m =
// ceil(k / r): m slabs with r rows each, k rows in all) or this buffer's
// k-th key, whichever is better, goes to the query's shared key (atomicMax),
// and the best of those sets the threshold.
template <typename T, int NQ>
__device__ __forceinline__ void publish(const Wg<T, NQ>& w, const TcArgs& p, int q0, int slab,
                                        int n_slabs) {
  const int lane = w.lane, k = p.k;
  const int r = min(k, max(1, (2 * k + n_slabs - 1) / n_slabs)), m = (k + r - 1) / r;
  for (int c = w.warp; c < NQ && q0 + c < p.n_q; c += kTcWarps) {
    int* pub = p.kth + p.n_q + static_cast<size_t>(q0 + c) * n_slabs;
    if (lane == 0) pub[slab] = static_cast<int>(w.best[c * k + r - 1] >> 32);
    __syncwarp();
    int key = static_cast<int>(w.best[c * k + k - 1] >> 32);
    if (n_slabs <= 32 * kPubPerLane) {
      unsigned v[kPubPerLane];  // the row, biased so that unsigned order is key order
#pragma unroll
      for (int i = 0; i < kPubPerLane; ++i) {
        const int j = lane + 32 * i;
        const unsigned key_j = j < n_slabs ? static_cast<unsigned>(__ldcg(pub + j)) : 0x80000000u;
        v[i] = key_j ^ 0x80000000u;
      }
      unsigned t = 0u;  // the largest t with m keys >= t, bit by bit
      for (int bit = 31; bit >= 0; --bit) {
        const unsigned cand = t | (1u << bit);
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < kPubPerLane; ++i) cnt += v[i] >= cand;
        if (static_cast<int>(__reduce_add_sync(0xFFFFFFFFu, cnt)) >= m) t = cand;
      }
      key = max(key, static_cast<int>(t ^ 0x80000000u));
    }
    if (lane == 0) w.thr[c] = threshold(max(key, atomicMax(p.kth + q0 + c, key)), p.score);
  }
}

// The slab's top k per query to partial[(slab, q, k)].
template <typename T, int NQ>
__device__ __forceinline__ void write_partial(const Wg<T, NQ>& w, const TcArgs& p, int q0,
                                              long long slab) {
  for (int f = w.tid; f < NQ * p.k; f += kTcThreads) {
    const int q = q0 + f / p.k;
    if (q < p.n_q) p.partial[(static_cast<size_t>(slab) * p.n_q + q) * p.k + f % p.k] = w.best[f];
  }
}

// The warpgroup's re-scored pairs to the launch's counter.
template <typename T, int NQ>
__device__ __forceinline__ void add_rescored(const Wg<T, NQ>& w, const TcArgs& p, unsigned count) {
  const unsigned sum = __reduce_add_sync(0xFFFFFFFFu, count);
  if (w.lane == 0 && sum != 0u) atomicAdd(w.red, sum);
  w.sync();
  if (w.tid == 0 && w.red[0] != 0u && p.rescored != nullptr)
    atomicAdd(p.rescored, static_cast<unsigned long long>(w.red[0]));
}

// The tile scan: a CTA is one warpgroup, its work one slab (or, kTiles,
// its chunks of the tile list), its rows loaded straight into registers.
template <typename T, int NQ, bool kTiles>
__device__ __forceinline__ void tile_scan(const TcArgs& p, const TcLayout& L, unsigned char* smem) {
  using Q = typename Tc<T>::Q;
  constexpr int kAcc = NQ / 2, kSteps = Tc<T>::kSteps, kVecs = Tc<T>::kVecs;
  const Wg<T, NQ> w(smem, L, threadIdx.x, 0);
  const int tid = w.tid, q0 = blockIdx.y * NQ;
  begin_queries(w, p, q0);
  const size_t part = L.q_part / sizeof(Q);  // elements of one query part
  if (L.q_res) stage_queries<T>(w.q_s, part, p.qs, q0, p.n_q, p.d, NQ, 0, L.n_dch, tid);
  fence_async_shared();
  __syncthreads();

  long long per_tile = 1, items = 0;
  Cursor next{static_cast<long long>(blockIdx.x) * p.slab_rows, 0, blockIdx.x, 0};
  next.end = min(p.n, next.t0 + p.slab_rows);
  if constexpr (kTiles) {
    per_tile = (p.slab_rows + p.chunk_rows - 1) / p.chunk_rows;
    items = static_cast<long long>(*p.n_live) * per_tile;
    next.item -= gridDim.x;
    next_item(next, p, per_tile, items);
  }
  // Registers carry the pipeline: the next item's rows load while this
  // one multiplies, keys and re-scores.
  uint4 nxt[2][kVecs], cur[2][kVecs];
  if (next.t0 < next.end) load_rows<T, kVecs>(nxt, p, next, w.g, w.quad);

  float acc[kAcc], n2[2] = {0.0f, 0.0f};
  unsigned count = 0;
  int pending = 0;          // admitted pairs in the list, not yet re-scored
  int published = INT_MIN;  // (tid < NQ) query tid's best published k-th key
  for (int tile = 0; next.t0 < next.end;) {
    const Cursor it = next;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kVecs; ++j) cur[h][j] = nxt[h][j];
    advance<kTiles>(next, p, L.n_dch, per_tile, items);
    if (next.t0 < next.end) load_rows<T, kVecs>(nxt, p, next, w.g, w.quad);
    if (!L.q_res) {  // this chunk of the queries
      __syncthreads();
      stage_queries<T>(w.q_s, part, p.qs, q0, p.n_q, p.d, NQ, it.ch, 1, tid);
      fence_async_shared();
      __syncthreads();
    }
    if (it.ch == 0) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;
      n2[0] = n2[1] = 0.0f;
      if (tid < NQ && q0 + tid < p.n_q) published = __ldcg(p.kth + q0 + tid);
    }
    const uint32_t b0 =
        smem_u32(w.q_s + (L.q_res ? static_cast<size_t>(it.ch) * Tc<T>::kChunk * NQ : 0));
    const uint32_t b1 = b0 + static_cast<uint32_t>(L.q_part);  // f32, u8: the low parts
#pragma unroll
    for (int j = 0; j < kAcc; ++j) fence_operand(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      Tc<T>::mma(acc, cur, st, kmajor_desc(b0 + st * 2 * NQ * 16, NQ),
                 kmajor_desc(b1 + st * 2 * NQ * 16, NQ));
    wgmma_commit();
    // The rows' squared norms (this thread's quarter), under the products.
    Tc<T>::add_norms(n2, cur);
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) fence_operand(acc[j]);
    if (it.ch != L.n_dch - 1) continue;

    const RowIn rin = row_inputs(p, it.t0, it.end, w.g);
    float kq[NQ / 4], thr[NQ / 4];
    column_words<NQ>(kq, w.kq, w.quad);
    column_words<NQ>(thr, w.thr, w.quad);
    const int total = gate(w, p, acc, n2, it.t0, tile, pending, q0, rin, kq, thr);
    ++tile;
    // Re-score once a batch of 32 is pending per warp that owns a live
    // query (128 from 4 queries on), and at the end of the work: the
    // gate's thresholds lag meanwhile, which only admits more pairs.
    if (total < 32 * min(kTcWarps, p.n_q - q0) && next.t0 < next.end) {
      pending = total;
      tighten(w, published, p.score);
      continue;
    }
    pending = 0;
    rescore(w, p, total, q0, count);
    __syncthreads();
    if (total > 0) publish(w, p, q0, blockIdx.x, gridDim.x);
    __syncthreads();
  }
  write_partial(w, p, q0, blockIdx.x);
  add_rescored(w, p, count);
}

// The wide scan's producer: one thread fills the ring with the row tiles
// of this CTA's items by bulk copies, each stage once both consumer
// warpgroups have released it.
__device__ __forceinline__ void wide_produce(const TcArgs& p, const TcLayout& L, unsigned char* smem,
                                             int pairs, long long items) {
  const uint32_t full = smem_u32(smem + L.bars), empty = full + 8 * kStages;
  const uint32_t ring = smem_u32(smem + L.ring);
  const float* rows = static_cast<const float*>(p.rows);
  int s = 0;
  unsigned parity = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long t_begin = item / pairs * p.slab_rows;
    const long long t_end = min(p.n, t_begin + p.slab_rows);
    for (long long t0 = t_begin; t0 < t_end; t0 += kTcRows) {
      mbar_wait(empty + 8 * s, parity ^ 1u);
      const unsigned bytes = static_cast<unsigned>(
          min(static_cast<long long>(kTcRows), t_end - t0) * p.d * sizeof(float));
      mbar_arrive_tx(full + 8 * s, bytes);
      bulk_load(ring + s * static_cast<uint32_t>(L.stage), rows + static_cast<size_t>(t0) * p.d,
                bytes, full + 8 * s);
      if (++s == kStages) {
        s = 0;
        parity ^= 1u;
      }
    }
  }
}

// A wide scan consumer: warpgroup wgi of the CTA owns query tile wgi of each
// item's pair and runs the tile scan's body on every ring tile without its
// loads: A fragments from the ring, the products, gate, re-score and
// thresholds of its own queries, its partial per slab.
template <typename T, int NQ, int V>
__device__ __forceinline__ void wide_consume(const TcArgs& p, const TcLayout& L, unsigned char* smem,
                                             int wgi, int n_slabs, int pairs, long long items) {
  using Q = typename Tc<T>::Q;
  constexpr int kAcc = NQ / 2;
  const uint32_t full = smem_u32(smem + L.bars), empty = full + 8 * kStages;
  const float* ring = reinterpret_cast<const float*>(smem + L.ring);
  const size_t stage_floats = L.stage / sizeof(float);
  const Wg<T, NQ> w(smem + wgi * L.wg, L, threadIdx.x % kWgThreads, 1 + wgi);
  const size_t part = L.q_part / sizeof(Q);
  int s = 0;
  unsigned parity = 0, count = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int slab = static_cast<int>(item / pairs);
    const int q0 = (static_cast<int>(item % pairs) * kWideWgs + wgi) * NQ;
    const long long t_begin = static_cast<long long>(slab) * p.slab_rows;
    const long long t_end = min(p.n, t_begin + p.slab_rows);
    w.sync();  // the last item's buffers and queries are read
    begin_queries(w, p, q0);
    stage_queries<T, 16 * V>(w.q_s, part, p.qs, q0, p.n_q, p.d, NQ, 0, 1, w.tid);
    fence_async_shared();
    w.sync();
    const uint32_t b0 = smem_u32(w.q_s), b1 = b0 + static_cast<uint32_t>(L.q_part);
    float kq[NQ / 4], thr[NQ / 4];
    column_words<NQ>(kq, w.kq, w.quad);
    int pending = 0, published = INT_MIN;
    int tile = 0;
    for (long long t0 = t_begin; t0 < t_end; t0 += kTcRows, ++tile) {
      // The gate's global and shared reads go out ahead of the products.
      if (w.tid < NQ && q0 + w.tid < p.n_q) published = __ldcg(p.kth + q0 + w.tid);
      const RowIn rin = row_inputs(p, t0, t_end, w.g);
      column_words<NQ>(thr, w.thr, w.quad);
      uint4 v[2][V];
      mbar_wait(full + 8 * s, parity);
      ring_rows<V>(v, ring + s * stage_floats, static_cast<int>(min(t_end - t0, 64LL)), p.d, w.g,
                   w.quad);
      float acc[kAcc], n2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;
      wide_products<NQ, V>(acc, v, b0, b1);
      Tc<T>::add_norms(n2, v);
      // Every value read from the stage has been used (the low parts, the
      // norms): the producer may refill it.
      mbar_arrive(empty + 8 * s);
      if (++s == kStages) {
        s = 0;
        parity ^= 1u;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < kAcc; ++j) fence_operand(acc[j]);

      const int total = gate(w, p, acc, n2, t0, tile, pending, q0, rin, kq, thr);
      if (total < 32 * min(kTcWarps, p.n_q - q0) && t0 + kTcRows < t_end) {
        pending = total;
        tighten(w, published, p.score);
        continue;
      }
      pending = 0;
      rescore(w, p, total, q0, count);
      w.sync();
      if (total > 0) publish(w, p, q0, slab, n_slabs);
      w.sync();
    }
    write_partial(w, p, q0, slab);
  }
  add_rescored(w, p, count);
}

// The wide scan (f32): a persistent CTA walks the items (query tile pair,
// slab), slab-major, blockIdx.x + i gridDim.x: its producer warpgroup fills
// the ring, its two consumer warpgroups, one query tile each, meet only at
// the ring (a stage is released once both have its rows in registers).
template <typename T, int NQ, int V>
__device__ __forceinline__ void wide_scan(const TcArgs& p, const TcLayout& L, unsigned char* smem) {
  if (threadIdx.x == 0) {
    const uint32_t full = smem_u32(smem + L.bars), empty = full + 8 * kStages;
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWideWgs * kWgThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_slabs = static_cast<int>((p.n + p.slab_rows - 1) / p.slab_rows);
  const int pairs = (p.n_q + kWideWgs * NQ - 1) / (kWideWgs * NQ);
  const long long items = static_cast<long long>(n_slabs) * pairs;
  // The role, warp-uniform as the compiler sees it: warpgroups 0 and 1
  // consume, warpgroup 2 produces.
  const int role = __shfl_sync(0xFFFFFFFFu, static_cast<int>(threadIdx.x) / kWgThreads, 0);
  if (role == kWideWgs) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % kWgThreads == 0) wide_produce(p, L, smem, pairs, items);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    wide_consume<T, NQ, V>(p, L, smem, role, n_slabs, pairs, items);
  }
}

// kWide = 0: the tile scan, one warpgroup a CTA; kWide = kWideVecs: the
// wide scan, f32 only, kWideThreads a CTA and one CTA an SM.
template <typename T, int NQ, bool kTiles, int kWide>
__global__ void __launch_bounds__(kWide != 0 ? kWideThreads : kTcThreads,
                                  kWide != 0 ? 1 : Tc<T>::kMinBlocks)
    knn_scan_tc(TcArgs p, TcLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (kWide != 0) wide_scan<T, NQ, kWide>(p, L, smem);
  else tile_scan<T, NQ, kTiles>(p, L, smem);
}

// ---------------------------------------------------------------------------
// The merge
// ---------------------------------------------------------------------------

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

// The launch's shared keys to INT_MIN.
__global__ void fill_int(int* __restrict__ out, long long n, int v) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = v;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

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

template <typename T, int NQ, bool kTiles, int kWide>
cudaError_t allow_smem(const TcLayout& L) {
  return cudaFuncSetAttribute(knn_scan_tc<T, NQ, kTiles, kWide>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(L.total));
}

// CTAs of an instance resident on one SM at its layout.
template <typename T, int NQ, bool kTiles, int kWide>
cudaError_t resident(const TcLayout& L, int* blocks) {
  const cudaError_t err = allow_smem<T, NQ, kTiles, kWide>(L);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, knn_scan_tc<T, NQ, kTiles, kWide>, kWide != 0 ? kWideThreads : kTcThreads, L.total);
}

template <typename T, int NQ, bool kTiles>
cudaError_t launch_tc_as(const TcArgs& p, const TcLayout& L, long long n_ctas,
                         cudaStream_t stream) {
  const cudaError_t err = allow_smem<T, NQ, kTiles, 0>(L);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_ctas), (p.n_q + NQ - 1) / NQ);
  knn_scan_tc<T, NQ, kTiles, 0><<<grid, kTcThreads, L.total, stream>>>(p, L);
  return cudaGetLastError();
}

template <typename T, bool kTiles>
cudaError_t launch_tc(const TcArgs& p, long long n_ctas, cudaStream_t stream) {
  const TcLayout L = tc_plan<T>(p.n_q, p.d, p.k);
  switch (L.nq) {
    case 8: return launch_tc_as<T, 8, kTiles>(p, L, n_ctas, stream);
    case 16: return launch_tc_as<T, 16, kTiles>(p, L, n_ctas, stream);
    case 32: return launch_tc_as<T, 32, kTiles>(p, L, n_ctas, stream);
    case 64: return launch_tc_as<T, 64, kTiles>(p, L, n_ctas, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The wide scan's persistent grid: n_ctas CTAs (the caller's: every
// resident CTA of the card), or one a work item where there are fewer.
template <int NQ, int V>
cudaError_t launch_wide_as(const TcArgs& p, const TcLayout& L, long long n_ctas,
                           cudaStream_t stream) {
  const cudaError_t err = allow_smem<float, NQ, false, V>(L);
  if (err != cudaSuccess) return err;
  const long long n_slabs = (p.n + p.slab_rows - 1) / p.slab_rows;
  const long long items = n_slabs * ((p.n_q + kWideWgs * NQ - 1) / (kWideWgs * NQ));
  const unsigned grid = static_cast<unsigned>(min(items, n_ctas));
  knn_scan_tc<float, NQ, false, V><<<grid, kWideThreads, L.total, stream>>>(p, L);
  return cudaGetLastError();
}

cudaError_t launch_wide(const TcArgs& p, long long n_ctas, cudaStream_t stream) {
  const TcLayout L = wide_plan<float>(p.d, p.k);
  return L.nq == kTcQueryMax ? launch_wide_as<kTcQueryMax, kWideVecs>(p, L, n_ctas, stream)
                             : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t grid_tc(int n_q, int d, int k, int* info) {
  const TcLayout L = tc_plan<T>(n_q, d, k);
  info[0] = L.nq;
  switch (L.nq) {
    case 8: return resident<T, 8, false, 0>(L, info + 1);
    case 16: return resident<T, 16, false, 0>(L, info + 1);
    case 32: return resident<T, 32, false, 0>(L, info + 1);
    case 64: return resident<T, 64, false, 0>(L, info + 1);
    default: return cudaErrorInvalidValue;
  }
}

// The wide scan takes f32 rows of D <= kWideMaxD, D % 4 == 0, both bases
// 16-byte aligned (the ring's bulk copies), the full scan only, and k where
// its layout fits (wide_plan).
bool wide_fits(int dtype, int d) { return dtype == 0 && d <= kWideMaxD && d % 4 == 0; }

// info[0] 0 (and info[1] 0) where the wide scan does not apply: another
// dtype, D above kWideMaxD or not a multiple of 4, or a k whose layout does
// not fit.
cudaError_t grid_wide(int dtype, int d, int k, int* info) {
  const TcLayout L = wide_fits(dtype, d) ? wide_plan<float>(d, k) : TcLayout{};
  info[0] = kWideWgs * L.nq;
  info[1] = 0;
  return L.nq == 0 ? cudaSuccess : resident<float, kTcQueryMax, false, kWideVecs>(L, info + 1);
}

// The scan of a corpus of T: 16-byte loads where D and both bases allow.
template <typename T>
cudaError_t launch_dtype(TcArgs p, const Slabs& slabs, long long wide_ctas, cudaStream_t stream) {
  p.vec = vector_loads(static_cast<const T*>(p.rows), p.d) && vector_loads(p.qs, p.d);
  if (wide_ctas > 0) {
    if constexpr (std::is_same_v<T, float>) {
      return p.vec ? launch_wide(p, wide_ctas, stream) : cudaErrorInvalidValue;
    }
    return cudaErrorInvalidValue;
  }
  return slabs.order != nullptr ? launch_tc<T, true>(p, slabs.n_ctas, stream)
                                : launch_tc<T, false>(p, slabs.n_ctas, stream);
}

int scan(const void* qs, const void* rows, int dtype, const void* aux, const void* mask,
         const void* excl, const void* ids, const void* qmeta, float m_abs, float m_aux, void* rescored,
         void* kth, void* partial, int n_q, long long n, int d, int k, int score, Slabs slabs,
         long long wide_ctas, void* stream) {
  if (qmeta == nullptr || kth == nullptr || wide_ctas < 0 ||
      (wide_ctas > 0 && (!wide_fits(dtype, d) || slabs.order != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const long long n_keys = static_cast<long long>(n_q) * (1 + slabs.n_ctas);
  fill_int<<<static_cast<unsigned>((n_keys + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<int*>(kth), n_keys, INT_MIN);
  if (rescored != nullptr) {
    const cudaError_t err = cudaMemsetAsync(rescored, 0, sizeof(unsigned long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const TcArgs p{static_cast<const float*>(qs), rows, static_cast<const float*>(aux),
                 static_cast<const float*>(mask), static_cast<const long long*>(excl),
                 static_cast<const int*>(ids), static_cast<const float*>(qmeta), m_abs, m_aux,
                 static_cast<unsigned long long*>(rescored), static_cast<int*>(kth), slabs.order,
                 slabs.n_live,
                 static_cast<long long*>(partial), n_q, n, d, k, score, slabs.slab_rows,
                 slabs.chunk_rows, false};
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dtype<float>(p, slabs, wide_ctas, s); break;
    case 1: err = launch_dtype<__nv_bfloat16>(p, slabs, wide_ctas, s); break;
    case 2: err = launch_dtype<uint8_t>(p, slabs, wide_ctas, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 u8. score: 0 dot, 1 l2, 2 cosine. aux, mask,
// excl and ids may be null; ids: (n,) int32, the id each row's composite
// carries (ties to the lowest id; excl bounds (key, id)), else the row. qmeta: (n_q,) f32, per query
// kappa ||q|| of kernels/knn.py:knn_margin (+inf: every pair re-scored), and m_abs, m_aux
// its absolute and |aux| terms; kth: space for (n_q * (1 + n_slabs),) int32
// (n_slabs = ceil(n / slab_rows)), which the launch sets to INT_MIN: its
// shared keys and then each query's row of the keys its slabs publish; both
// required for every dtype. rescored: one uint64 the launch zeroes and adds
// its re-scored pairs to, or null. slab_rows: a multiple of 64 (the row
// tile). partial: (n_slabs, n_q, k) int64. wide_ctas: 0 for the tile scan
// (a grid of n_slabs x query tiles), else the wide scan on a persistent grid
// of that many CTAs (fewer where there are fewer items (query tile pair,
// slab)); f32 rows only, D <= 128 and D % 4 == 0, both bases 16-byte
// aligned, else cudaErrorInvalidValue.
// Returns the cudaError_t of the launch (0 on success).
int innr_knn_scan(const void* qs, const void* rows, int dtype, const void* aux,
                  const void* mask, const void* excl, const void* ids, const void* qmeta, float m_abs,
                  float m_aux, void* rescored, void* kth, void* partial, int n_q, long long n,
                  int d, int k, int score, int slab_rows, int wide_ctas, void* stream) {
  if (n_q <= 0 || n <= 0 || d <= 0 || k <= 0 || slab_rows <= 0 || slab_rows % kTcRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Slabs slabs{nullptr, nullptr, slab_rows, slab_rows, (n + slab_rows - 1) / slab_rows};
  return scan(qs, rows, dtype, aux, mask, excl, ids, qmeta, m_abs, m_aux, rescored, kth,
              partial, n_q, n, d, k, score, slabs, wide_ctas, stream);
}

// The pruned scan: the same scan over the tiles order[0..*n_live) of
// tile_rows rows each (any tile_rows >= 1), cut into chunks of chunk_rows
// rows and dealt to n_ctas CTAs; n_live is read on the device. order:
// (n_tiles,) int32 tile ids, the live ones ascending; n_live: one int32 on
// the device; excl and ids may be null (as for innr_knn_scan); partial: (n_ctas, n_q, k) int64, every list
// written (empty for a CTA without work), for innr_knn_merge.
int innr_knn_scan_tiles(const void* qs, const void* rows, int dtype, const void* aux,
                        const void* mask, const void* excl, const void* ids, const void* qmeta, float m_abs,
                        float m_aux, void* rescored, void* kth, const void* order,
                        const void* n_live,
                        void* partial, int n_q, long long n, int d, int k, int score,
                        long long tile_rows, long long chunk_rows, int n_ctas, void* stream) {
  if (n_q <= 0 || n <= 0 || d <= 0 || k <= 0 || tile_rows <= 0 || chunk_rows <= 0 ||
      n_ctas <= 0 || order == nullptr || n_live == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Slabs slabs{static_cast<const int*>(order), static_cast<const int*>(n_live), tile_rows,
                    chunk_rows, n_ctas};
  return scan(qs, rows, dtype, aux, mask, excl, ids, qmeta, m_abs, m_aux, rescored, kth,
              partial, n_q, n, d, k, score, slabs, 0, stream);
}

// The scan's grid at this shape: info[0] the queries per CTA, info[1] the
// CTAs resident per SM (the occupancy of the instance a launch takes); wide:
// 0 the tile scan's, 1 the wide scan's (its queries per CTA: both
// warpgroups'; 0 and 0 where the wide scan does not apply to this dtype, D
// and k, which is how the planner learns where it may take it).
int innr_knn_grid(int dtype, int n_q, int d, int k, int wide, void* info) {
  if (n_q <= 0 || d <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int* out = static_cast<int*>(info);
  cudaError_t err;
  if (wide != 0) return static_cast<int>(grid_wide(dtype, d, k, out));
  switch (dtype) {
    case 0: err = grid_tc<float>(n_q, d, k, out); break;
    case 1: err = grid_tc<__nv_bfloat16>(n_q, d, k, out); break;
    case 2: err = grid_tc<uint8_t>(n_q, d, k, out); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
