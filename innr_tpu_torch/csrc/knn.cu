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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

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

// Byte offsets of a CTA's shared memory: the top-k buffers, the queries
// (all of D, or one chunk), a tile's admitted pairs, per-query words.
struct TcLayout {
  int nq, dpad, n_dch;  // query tile, D padded to whole chunks, chunks
  bool q_res;           // all of D of the queries resident
  size_t best, q, q_part, list, queue, bound, thr, kq, red, total;
};

inline size_t align128(size_t x) { return (x + 127) & ~static_cast<size_t>(127); }

template <typename T>
TcLayout tc_layout(int nq, int d, int k, bool q_res) {
  constexpr int chunk = Tc<T>::kChunk;
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

// Queries [q0, q0 + nq) x the chunks [ch0, ch0 + n_ch) into dst (K-major,
// nq rows, k positions permuted as perm_dim), as the tensor cores read
// them (bf16: rounded; f32, u8: both parts); zeros past n_q and d.
template <typename T>
__device__ void stage_queries(typename Tc<T>::Q* dst, size_t part_elems,
                              const float* __restrict__ qs, int q0, int n_q, int d, int nq,
                              int ch0, int n_ch) {
  constexpr int kE = 16 / sizeof(typename Tc<T>::Q), chunk = Tc<T>::kChunk;
  const int width = n_ch * chunk;
  for (int f = threadIdx.x; f < nq * width; f += kTcThreads) {
    const int r = f / width, kk = f % width;
    const int col = (ch0 + kk / chunk) * chunk + Tc<T>::perm_dim(kk % chunk);
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

template <typename T, int NQ, bool kTiles>
__global__ void __launch_bounds__(kTcThreads, Tc<T>::kMinBlocks) knn_scan_tc(TcArgs p,
                                                                             TcLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Q = typename Tc<T>::Q;
  constexpr int kAcc = NQ / 2, kSteps = Tc<T>::kSteps, kVecs = Tc<T>::kVecs;
  long long* best = reinterpret_cast<long long*>(smem + L.best);  // [NQ][k]
  Q* q_s = reinterpret_cast<Q*>(smem + L.q);                      // [dpad or chunk][NQ], K-major
  constexpr int kCap = kTcRows * NQ + kTcThreads;
  int* list_row = reinterpret_cast<int*>(smem + L.list);  // [kCap] rows, [kCap] queries
  unsigned char* list_c = reinterpret_cast<unsigned char*>(list_row + kCap);
  long long* bound = reinterpret_cast<long long*>(smem + L.bound);  // [NQ]
  float* thr = reinterpret_cast<float*>(smem + L.thr);              // [NQ]
  float* kq = reinterpret_cast<float*>(smem + L.kq);                // [NQ]
  unsigned* red = reinterpret_cast<unsigned*>(smem + L.red);  // re-scores; 3 tile counts

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, quad = lane & 3;
  const int g = 16 * warp + (lane >> 2);  // this thread's rows g and g + 8 of a tile
  int* queue_row = reinterpret_cast<int*>(smem + L.queue) + warp * kQueue;  // this warp's
  unsigned char* queue_c =
      reinterpret_cast<unsigned char*>(smem + L.queue + sizeof(int) * kQueue * kTcWarps) +
      warp * kQueue;
  const int q0 = blockIdx.y * NQ, k = p.k, score = p.score;
  const float open = score == 1 ? inf_f() : -inf_f();
  for (int i = tid; i < NQ * k; i += kTcThreads) best[i] = LLONG_MIN;
  if (tid < NQ) {
    const int q = q0 + tid;
    const bool live = q < p.n_q;
    thr[tid] = open;
    kq[tid] = live ? p.qmeta[q] : 0.0f;
    bound[tid] = (live && p.excl != nullptr) ? p.excl[q] : LLONG_MAX;
  }
  if (tid == 0) red[0] = red[1] = red[2] = red[3] = 0u;
  const size_t part = L.q_part / sizeof(Q);  // elements of one query part
  if (L.q_res) stage_queries<T>(q_s, part, p.qs, q0, p.n_q, p.d, NQ, 0, L.n_dch);
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
  if (next.t0 < next.end) load_rows<T, kVecs>(nxt, p, next, g, quad);

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
    if (next.t0 < next.end) load_rows<T, kVecs>(nxt, p, next, g, quad);
    if (!L.q_res) {  // this chunk of the queries
      __syncthreads();
      stage_queries<T>(q_s, part, p.qs, q0, p.n_q, p.d, NQ, it.ch, 1);
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
        smem_u32(q_s + (L.q_res ? static_cast<size_t>(it.ch) * Tc<T>::kChunk * NQ : 0));
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

    // The tile's last chunk: the gate appends its admitted pairs to the
    // list after the pending ones, counted in red[1 + tile % 3]; the count
    // two tiles ahead is cleared here (all its reads are two barriers back).
    unsigned* n_tile = red + 1 + tile % 3;
    if (tid == 0) red[1 + (tile + 1) % 3] = 0u;
    bool ok[2], pass[2];
    float a[2], kx[2], cx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float r2 = n2[h] + __shfl_xor_sync(0xFFFFFFFFu, n2[h], 1);
      r2 += __shfl_xor_sync(0xFFFFFFFFu, r2, 2);
      const long long row = it.t0 + g + 8 * h;
      ok[h] = row < it.end;
      a[h] = (ok[h] && p.aux != nullptr) ? p.aux[row] : 0.0f;
      pass[h] = !(ok[h] && p.mask != nullptr) || p.mask[row] > 0.0f;
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
      tb = fmaf(kq[acc_col(i, tid)], kx[h], cx[h]);
    };
    // The CTA's first tile (k <= 64, no exclusion bound): each query's k-th
    // best of the bounds s~ - T (l2: s~ + T) of the tile's passing rows is a
    // threshold: k rows reach it, so no row whose s~ + T (l2: s~ - T) falls
    // short of it can enter the top k, and the buffers start near their
    // k-th, not open (those k rows are admitted). Each warp selects for its
    // queries from a [NQ][64] table in the list's space (empty here).
    if (tile == 0 && k <= kTcRows && p.excl == nullptr) {
      float* lb = reinterpret_cast<float*>(list_row);
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
      __syncthreads();
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
        if (lane == 0 && b > -inf_f()) thr[c] = score == 1 ? -b : b;
      }
      __syncthreads();
    }
    // Admitted pairs go to the list after the pending ones: one vote of
    // the warp, then (rarely) one warp-aggregated slot claim per register.
    unsigned admitted = 0;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int h = (i >> 1) & 1, c = acc_col(i, tid);
      if (!ok[h] || q0 + c >= p.n_q) continue;
      bool admit;
      if (!pass[h]) {
        admit = thr[c] == open;  // an INT_MIN key can still enter
      } else {
        float sv, tb;
        gate_terms(i, sv, tb);
        admit = score == 1 ? !(sv - tb > thr[c]) : !(sv + tb < thr[c]);
      }
      admitted |= static_cast<unsigned>(admit) << i;
    }
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
        list_row[slot] = static_cast<int>(it.t0 + g + 8 * ((i >> 1) & 1));
        list_c[slot] = static_cast<unsigned char>(acc_col(i, tid));
      }
    }
    __syncthreads();
    ++tile;
    const int total = pending + static_cast<int>(*n_tile);
    // Re-score once a batch of 32 is pending per warp that owns a live
    // query (128 from 4 queries on), and at the end of the work: the
    // gate's thresholds lag meanwhile, which only admits more pairs.
    if (total < 32 * min(kTcWarps, p.n_q - q0) && next.t0 < next.end) {
      pending = total;
      // Meanwhile the best k-th key any CTA has published (read at this
      // tile's start) tightens the threshold; a gate may read it before
      // or after the store, and either value is safe.
      if (tid < NQ && published != INT_MIN) {
        const float t = threshold(published, score);
        thr[tid] = score == 1 ? fminf(thr[tid], t) : fmaxf(thr[tid], t);
      }
      continue;
    }
    pending = 0;
    // Each warp re-scores the pending pairs of its queries (c % 4 == warp)
    // and offers them to their buffers, 32 at a time: its share of the
    // list is gathered into its queue, so a batch's query loads touch at
    // most NQ / 4 queries and no lane idles until the list runs out.
    for (int j0 = 0, have = 0; j0 < total || have > 0;) {
      if (j0 < total) {
        const int j = j0 + lane;
        const int c = j < total ? list_c[j] : -1;
        const bool mine = c >= 0 && c % kTcWarps == warp;
        const unsigned mm = __ballot_sync(0xFFFFFFFFu, mine);
        if (mine) {
          const int at = have + __popc(mm & ((1u << lane) - 1u));
          queue_row[at] = list_row[j];
          queue_c[at] = static_cast<unsigned char>(c);
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
        c = queue_c[lane];
        const long long row = queue_row[lane];
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
        if (cand >= bound[c]) cand = LLONG_MIN;
      }
      // The rest of the queue moves to its front.
      const int rest = have - n_b;
      const int r_row = lane < rest ? queue_row[32 + lane] : 0;
      const unsigned char r_c = lane < rest ? queue_c[32 + lane] : 0;
      __syncwarp();
      if (lane < rest) {
        queue_row[lane] = r_row;
        queue_c[lane] = r_c;
      }
      have = rest;
      __syncwarp();
      // One merge per query present in the batch.
      for (unsigned todo = __ballot_sync(0xFFFFFFFFu, c >= 0); todo != 0u;) {
        const int c0 = __shfl_sync(0xFFFFFFFFu, c, __ffs(todo) - 1);
        const bool in = c == c0;
        todo &= ~__ballot_sync(0xFFFFFFFFu, in);
        warp_merge(best + c0 * k, k, in ? cand : LLONG_MIN, lane);
      }
    }
    __syncthreads();
    // The gate's thresholds, by the warp that owns each query: a key that k
    // rows anywhere reach keeps every row below it out of the final top k,
    // so the merged result is unchanged. This buffer's key at rank r goes
    // to the query's row of the published table (r rows of this CTA reach
    // it); the row's m-th best key (m = ceil(k / r): m CTAs with r rows
    // each, k rows in all) or this buffer's k-th key, whichever is better,
    // goes to the query's shared key (atomicMax), and the best of those
    // sets the threshold.
    if (total > 0) {
      const int n_ctas = gridDim.x;
      const int r = min(k, max(1, (2 * k + n_ctas - 1) / n_ctas)), m = (k + r - 1) / r;
      for (int c = warp; c < NQ && q0 + c < p.n_q; c += kTcWarps) {
        int* pub = p.kth + p.n_q + static_cast<size_t>(q0 + c) * n_ctas;
        if (lane == 0) pub[blockIdx.x] = static_cast<int>(best[c * k + r - 1] >> 32);
        __syncwarp();
        int key = static_cast<int>(best[c * k + k - 1] >> 32);
        if (n_ctas <= 32 * kPubPerLane) {
          unsigned v[kPubPerLane];  // the row, biased so that unsigned order is key order
#pragma unroll
          for (int i = 0; i < kPubPerLane; ++i) {
            const int j = lane + 32 * i;
            const unsigned key_j = j < n_ctas ? static_cast<unsigned>(__ldcg(pub + j)) : 0x80000000u;
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
        if (lane == 0) thr[c] = threshold(max(key, atomicMax(p.kth + q0 + c, key)), score);
      }
    }
    __syncthreads();
  }
  for (int f = tid; f < NQ * k; f += kTcThreads) {
    const int q = q0 + f / k;
    if (q < p.n_q) p.partial[(static_cast<size_t>(blockIdx.x) * p.n_q + q) * k + f % k] = best[f];
  }
  const unsigned sum = __reduce_add_sync(0xFFFFFFFFu, count);
  if (lane == 0 && sum != 0u) atomicAdd(red, sum);
  __syncthreads();
  if (tid == 0 && red[0] != 0u && p.rescored != nullptr)
    atomicAdd(p.rescored, static_cast<unsigned long long>(red[0]));
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

template <typename T, int NQ, bool kTiles>
cudaError_t launch_tc_as(const TcArgs& p, const TcLayout& L, long long n_ctas,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(knn_scan_tc<T, NQ, kTiles>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_ctas), (p.n_q + NQ - 1) / NQ);
  knn_scan_tc<T, NQ, kTiles><<<grid, kTcThreads, L.total, stream>>>(p, L);
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

// CTAs of the tensor-core scan resident on one SM at this shape.
template <typename T, int NQ>
cudaError_t resident_tc(const TcLayout& L, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(knn_scan_tc<T, NQ, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, knn_scan_tc<T, NQ, false>,
                                                       kTcThreads, L.total);
}

template <typename T>
cudaError_t grid_tc(int n_q, int d, int k, int* info) {
  const TcLayout L = tc_plan<T>(n_q, d, k);
  info[0] = L.nq;
  switch (L.nq) {
    case 8: return resident_tc<T, 8>(L, info + 1);
    case 16: return resident_tc<T, 16>(L, info + 1);
    case 32: return resident_tc<T, 32>(L, info + 1);
    case 64: return resident_tc<T, 64>(L, info + 1);
    default: return cudaErrorInvalidValue;
  }
}

// The scan of a corpus of T: 16-byte loads where D and both bases allow.
template <typename T>
cudaError_t launch_dtype(TcArgs p, const Slabs& slabs, cudaStream_t stream) {
  p.vec = vector_loads(static_cast<const T*>(p.rows), p.d) && vector_loads(p.qs, p.d);
  return slabs.order != nullptr ? launch_tc<T, true>(p, slabs.n_ctas, stream)
                                : launch_tc<T, false>(p, slabs.n_ctas, stream);
}

int scan(const void* qs, const void* rows, int dtype, const void* aux, const void* mask,
         const void* excl, const void* ids, const void* qmeta, float m_abs, float m_aux, void* rescored,
         void* kth, void* partial, int n_q, long long n, int d, int k, int score, Slabs slabs,
         void* stream) {
  if (qmeta == nullptr || kth == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
    case 0: err = launch_dtype<float>(p, slabs, s); break;
    case 1: err = launch_dtype<__nv_bfloat16>(p, slabs, s); break;
    case 2: err = launch_dtype<uint8_t>(p, slabs, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 u8. score: 0 dot, 1 l2, 2 cosine. aux, mask,
// excl and ids may be null; ids: (n,) int32, the id each row's composite
// carries (ties to the lowest id; excl bounds (key, id)), else the row. qmeta: (n_q,) f32, per query kappa ||q|| of
// kernels/knn.py:knn_margin (+inf: every pair re-scored), and m_abs, m_aux
// its absolute and |aux| terms; kth: space for (n_q * (1 + n_ctas),) int32
// (n_ctas: the grid's CTAs per query tile, ceil(n / slab_rows) here), which
// the launch sets to INT_MIN: its shared keys and then each query's row of
// the keys its CTAs publish; both required for every dtype. rescored: one
// uint64 the launch zeroes and adds its re-scored pairs to, or null.
// slab_rows: a multiple of 64 (the row tile). partial: (ceil(n /
// slab_rows), n_q, k) int64.
// Returns the cudaError_t of the launch (0 on success).
int innr_knn_scan(const void* qs, const void* rows, int dtype, const void* aux,
                  const void* mask, const void* excl, const void* ids, const void* qmeta, float m_abs,
                  float m_aux, void* rescored, void* kth, void* partial, int n_q, long long n,
                  int d, int k, int score, int slab_rows, void* stream) {
  if (n_q <= 0 || n <= 0 || d <= 0 || k <= 0 || slab_rows <= 0 || slab_rows % kTcRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Slabs slabs{nullptr, nullptr, slab_rows, slab_rows, (n + slab_rows - 1) / slab_rows};
  return scan(qs, rows, dtype, aux, mask, excl, ids, qmeta, m_abs, m_aux, rescored, kth,
              partial, n_q, n, d, k, score, slabs, stream);
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
              partial, n_q, n, d, k, score, slabs, stream);
}

// The scan's grid at this shape: info[0] the queries per CTA, info[1] the
// CTAs resident per SM (the occupancy of the instance a launch takes).
int innr_knn_grid(int dtype, int n_q, int d, int k, void* info) {
  if (n_q <= 0 || d <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int* out = static_cast<int*>(info);
  cudaError_t err;
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
