// MaxSim scan over f32 documents on Hopper's tensor cores (sm_90a), plain
// C interface.
//
// Replaces the TPU kernels innr_tpu/kernels/maxsim_kernel.py:_maxsim_kernel
// (launched by fused_maxsim_scores, one query) and _maxsim_kernel_mq
// (fused_maxsim_scores_batch, a batch): the query count is a runtime
// parameter, so both are maxsim_scores here, for float32 documents (bf16
// documents: maxsim_bf16.cu).
//
// Function. Queries (B, Tq, D) float32, documents (N, Td, D) float32, an optional
// (N, Td) byte mask (nonzero = valid token). For document n and query b:
//   score[b, n] = sum over i < Tq of clamp(max over valid j of q[b, i] . d[n, j])
// where clamp turns -inf into 0 (a fully masked document, or a best that is
// -inf for any other reason) and NaN and +inf propagate: the max is NaN-sticky,
// as jnp.max is. Masked tokens never win. Each query is summed on its own, so
// a NaN or inf in one query's bests stays in that query's score (the TPU
// kernel's group-indicator matmul spreads it to every query of the batch:
// ROADMAP R7). A dot is FP32 FMAs over the dimensions in order from +0.0,
// zero padding to a multiple of 4 included; each query's Tq bests are
// summed in token order from +0.0 (__fadd_rn); a NaN score is written as
// the canonical 0x7FC00000. Every score is that arithmetic's bit for bit,
// though only the tokens the gate admits are computed so.
//
// Design: approximate dots on the tensor cores, a proven gate, an exact
// re-score of each query token's best.
// 1. A CTA of two warpgroups holds one tile of whole queries (mt tokens, at
//    most 256: 128 KB of f32 at D = 128) in shared memory in mma.cuh's
//    K-major layout, zero rows and dimensions padding it to tiles of 64 and
//    D to a multiple of 8. At B = 16, Tq = 32 the batch is two tiles, so the
//    corpus is read twice per batch (grid.y = 2, half the SMs each); at
//    Q = 1 once. A query longer than 256 tokens is one tile scored in passes
//    of row tiles; when the tile does not fit (a long query or a wide D),
//    the query is staged per pass and per block of 128 dimensions under
//    each chunk instead (`kb` > 0), which only costs time.
// 2. The CTA walks its documents grid-stride, each in segments of at most
//    1024 token positions (the whole document at ColBERT widths). Warp 0
//    compacts a segment's valid tokens into a list two segments ahead
//    (maxsim_tokens.cuh); an item is up to ts of a segment's valid tokens
//    (ts a multiple of the 64-token chunk where that fits beside the query
//    tile: 64 at B = 16 and at Q = 1), so a document of 80 valid tokens is
//    two items. The CTA stages an item's rows, and only those, by cp.async
//    into one of two buffers one item ahead of the one it scores (16-byte
//    copies; element loads when D % 4 != 0); three buffers, or items that
//    are not whole chunks, measured slower. Each staged token's norm is
//    summed from the buffer, four lanes a token. A tile of one row tile per
//    warpgroup runs two CTAs per SM where both fit (Q = 1), and its two
//    warpgroups then take alternate chunks.
// 3. Each warpgroup runs TF32 wgmma m64n64k8 of its query tiles against 64
//    staged tokens at a time: approximate dots s~ from the f32 bits (the
//    tensor core drops the low 13 mantissa bits). 1xTF32, not 3xTF32:
//    MaxSim needs only each token's best, and the gate below keeps about
//    one to two candidates per (query token, document) on the ColBERT cell
//    with TF32's margin, so the exact re-score costs a few of each token's
//    D-long dots; 3xTF32 would triple the tensor-core work and need the low
//    parts staged beside both operands (PERF.md gives the measured pairs).
// 4. Gate. kernels/maxsim_kernel.py:maxsim_margin bounds |s~ - s| by
//    T = kq ||x|| + m_abs, kq = kappa (||q|| + slack) per query token (from
//    the wrapper, +inf for a token that is not finite or whose norm is not
//    below 2^50), ||x|| from the staged row (+inf when its square is not
//    below 2^100; the safety factor covers the f32 rounding of the sum).
//    Each query token keeps L = max (s~ - T) over the document's tokens seen
//    so far (in registers across chunks, in shared memory across segments),
//    and re-scores every token with s~ + T >= L (a NaN anywhere admits).
//    L only grows toward its final value, so this is a superset of the
//    tokens within the margin of the final L, and the exact best always
//    passes (its s~ + T >= s* >= s_j >= s~_j - T_j for every j). A token
//    whose exact dot is NaN or +-inf has a norm that is not finite or not
//    below 2^50 (with both norms below 2^50 no FMA overflows), so T = +inf
//    admits it: the NaN-sticky max and the infinities stay exact.
// 5. Re-score, per chunk: each thread marks its accumulators that pass in
//    a bit mask, and a warp spreads its candidates over its lanes (an
//    exclusive scan of the lanes' counts; each lane finds the owner of its
//    candidate by a binary search of the scan with shuffles). Each
//    candidate runs the old fmaf chain over the staged row and the query
//    row (shared memory, or global when the tile is staged per block) and
//    folds the total-order key of the result into its query token's best
//    with an atomicMax in shared memory (NaN, canonical, is the largest
//    key: the NaN-sticky max). The exact max over a superset of
//    candidates that holds the best is the best; sums from +0.0 are never
//    -0.0, so no signed-zero tie can show. After a document's last item one
//    thread per query sums its Tq bests as before. Each launch adds its
//    re-scored (query token, document token) pairs to a device counter.
//
// What bounds it on the H100 (ColBERTv2 widths, 16.0M valid tokens of 180 x
// 200K): 2 B Tq D TF32 operations per valid token (4.2 ms at B = 16 and
// 495 TFLOP/s) against the valid tokens' 8.2 GB (2.5 ms per read, two reads
// at B = 16). This design does not come near either: one CTA of 8 warps
// per SM runs each item's staging wait, norms, wgmma, gate and re-score
// rounds in series between CTA barriers, with nothing to hide their
// latency (PERF.md: clock counts per phase put the re-scores at 0.4 of an
// item at B = 16, the wgmma at 0.2). The last chunk of an item is padded to
// 64 tokens and a query tile of 32 tokens to 64 rows. Later: warp-
// specialised producer and consumer warpgroups (staging by TMA), the next
// chunk's wgmma issued under this chunk's re-scores, query tiles held as
// the A operand in registers to free shared memory for deeper staging.

#include <cuda_runtime.h>
#include <cstdint>

#include "maxsim_tokens.cuh"  // Item, compact (the valid-token lists)
#include "mma.cuh"            // K-major tiles, wgmma, cp.async
#include "topk.cuh"           // total_key

namespace {

constexpr int kThreads = 2 * kWgThreads;
constexpr int kChunk = 64;  // document tokens per wgmma (n)
constexpr int kStages = 2;  // items staged: the one scored and the next

__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key ^ (key < 0 ? 0x7FFFFFFF : 0));
}

// The listed token rows of one document into buf (K-major, ts rows);
// dimensions past d keep the zeros written at the start.
template <bool kAsync>
__device__ void stage_doc(float* buf, const float* __restrict__ drow, const int* ids, int cnt,
                          int d, int ts) {
  if (kAsync) {
    const int nq = d / 4;
    for (int f = threadIdx.x; f < cnt * nq; f += kThreads) {
      const int p = f / nq, q = f % nq;
      cp_async16(buf + kmajor_offset<4>(p, 4 * q, ts), drow + static_cast<size_t>(ids[p]) * d + 4 * q);
    }
  } else {
    for (int f = threadIdx.x; f < cnt * d; f += kThreads) {
      const int p = f / d, k = f % d;
      buf[kmajor_offset<4>(p, k, ts)] = drow[static_cast<size_t>(ids[p]) * d + k];
    }
  }
}

// Query rows [r0, r0 + rows) x dimensions [k0, k0 + kw) of the tile into
// dst (K-major, `rows` rows); zeros past the tile's n_tok tokens and past d.
__device__ void stage_query(float* dst, const float* __restrict__ q, int n_tok, int d, int r0,
                            int rows, int k0, int kw) {
  for (int i = threadIdx.x; i < rows * kw; i += kThreads) {
    const int r = i / kw, k = i % kw;
    const int row = r0 + r, dim = k0 + k;
    dst[kmajor_offset<4>(r, k, rows)] =
        (row < n_tok && dim < d) ? q[static_cast<size_t>(row) * d + dim] : 0.0f;
  }
}

// The exact dot the FMA kernel computed: fmaf over dimensions 0 .. d4 - 1 in
// order from +0.0, zeros past d. The token's row is column `col` of the
// staged buffer; the query row is row `row` of the resident tile, or (qg
// non-null) row qg of global memory.
__device__ __forceinline__ float exact_dot(const float* db, int col, int ts, const float* qs,
                                           int row, int mt, const float* __restrict__ qg, int d,
                                           int d4) {
  float s = 0.0f;
#pragma unroll 8
  for (int k = 0; k < d4; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(db + kmajor_offset<4>(col, k, ts));
    float4 v;
    if (qg == nullptr) {
      v = *reinterpret_cast<const float4*>(qs + kmajor_offset<4>(row, k, mt));
    } else {
      v.x = k < d ? qg[k] : 0.0f;
      v.y = k + 1 < d ? qg[k + 1] : 0.0f;
      v.z = k + 2 < d ? qg[k + 2] : 0.0f;
      v.w = k + 3 < d ? qg[k + 3] : 0.0f;
    }
    s = fmaf(v.x, x.x, s);
    s = fmaf(v.y, x.y, s);
    s = fmaf(v.z, x.z, s);
    s = fmaf(v.w, x.w, s);
  }
  return s;
}

// Where an item of ts valid tokens stands: segment sigma (the CTA's
// sigma-th segment of P token positions, over its documents in turn), and
// its part (the valid tokens [part ts, part ts + ts) of the segment's list).
struct Cursor {
  long long sigma;
  int part;
};

// The item after c, given the segment's valid-token count.
__device__ __forceinline__ Cursor advance(Cursor c, int cnt, int ts) {
  return (c.part + 1) * ts < cnt ? Cursor{c.sigma, c.part + 1} : Cursor{c.sigma + 1, 0};
}

template <int TPW, int kCtas, bool kAsync>
__global__ void __launch_bounds__(kThreads, kCtas) maxsim_scores(
    const float* __restrict__ q, const float* __restrict__ docs,
    const unsigned char* __restrict__ mask, const float* __restrict__ qterm, float m_abs,
    unsigned long long* __restrict__ rescored, float* __restrict__ out, int n_b, int tq, int td,
    int d, long long n, int qpt, int mt, int ts, int seg, int kb) {
  constexpr int kLists = kStages + 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int dp = (d + 7) & ~7, d4 = (d + 3) & ~3;
  const bool resident = kb == 0;
  const int prow = 2 * TPW * 64;  // rows of a pass
  // The stage buffers first: a chunk's rows past ts read into what
  // follows, and the epilogue masks those columns.
  float* dbuf = reinterpret_cast<float*>(smem_raw);                  // [kStages][dp][ts]
  float* qs = dbuf + kStages * static_cast<size_t>(ts) * dp;         // [dp][mt] or [kb][prow]
  float* xn = qs + (resident ? static_cast<size_t>(mt) * dp : static_cast<size_t>(prow) * kb);
  float* lo_s = xn + ts;                                             // [2][mt] L per token
  int* best_s = reinterpret_cast<int*>(lo_s + 2 * mt);               // [mt] keys
  int* ids = best_s + mt;                                            // [kLists][seg]
  int* cnt_s = ids + kLists * seg;                                   // [kLists]

  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads, lane = tid & 31;
  const int b0 = blockIdx.y * qpt;
  const int nb_tile = min(qpt, n_b - b0);
  const int n_tok = nb_tile * tq, n_tiles = mt / 64;
  const int n_seg = (td + seg - 1) / seg;
  // When one warpgroup's row tiles hold the whole (resident) tile, the two
  // warpgroups take alternate chunks of the same rows instead, each with
  // its own L (a lower bound of the best all the same).
  const bool split = resident && n_tiles <= TPW;
  const int wt = split ? 0 : wg * TPW;  // this warpgroup's first tile of a pass
  const int c_first = split ? wg * kChunk : 0, c_step = split ? 2 * kChunk : kChunk;
  float* lo_w = lo_s + (split ? wg * mt : 0);
  const float neg_inf = -__int_as_float(0x7f800000);
  const float* qt = q + static_cast<size_t>(b0) * tq * d;
  const float* kq = qterm + static_cast<size_t>(b0) * tq;
  unsigned long long pairs = 0;

  for (int i = tid; i < kStages * ts * dp; i += kThreads) dbuf[i] = 0.0f;
  if (resident) stage_query(qs, qt, n_tok, d, 0, mt, 0, dp);
  // Segment lists kStages segments ahead: segment sigma's valid tokens in
  // ids[sigma % kLists], their count in cnt_s[sigma % kLists].
  for (int a = 0; a < kStages; ++a) {
    const Item it = item(a, n_seg, seg, td);
    if (tid < 32 && it.doc < n)
      list_item(it, ids + a * seg, cnt_s + a, mask_load(mask_row(mask, it.doc, td), it.hi, it.lo),
                mask, td);
  }
  __syncthreads();
  // Items kStages - 1 ahead: item j's rows in dbuf[j % kStages].
  Cursor st{0, 0};
  auto stage_next = [&](long long j) {
    const Item it = item(st.sigma, n_seg, seg, td);
    if (it.doc < n) {
      const int slot = static_cast<int>(st.sigma % kLists), cnt = cnt_s[slot];
      stage_doc<kAsync>(dbuf + static_cast<size_t>(j % kStages) * ts * dp,
                        docs + static_cast<size_t>(it.doc) * td * d, ids + slot * seg + st.part * ts,
                        min(ts, cnt - st.part * ts), d, ts);
      st = advance(st, cnt, ts);
    }
    cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) stage_next(j);

  const uint32_t q0 = smem_u32(qs);
  Cursor cur{0, 0};
  for (long long j = 0;; ++j) {
    const Item it = item(cur.sigma, n_seg, seg, td);
    if (it.doc >= n) break;
    const int slot = static_cast<int>(cur.sigma % kLists), seg_cnt = cnt_s[slot];
    const bool first = it.lo == 0 && cur.part == 0, last_part = (cur.part + 1) * ts >= seg_cnt;
    const Item ahead = item(cur.sigma + kStages, n_seg, seg, td);
    stage_next(j + kStages - 1);
    MaskBytes pre{};
    if (last_part && tid < 32 && ahead.doc < n)
      pre = mask_load(mask_row(mask, ahead.doc, td), ahead.hi, ahead.lo);
    if (first)
      for (int i = tid; i < mt; i += kThreads) best_s[i] = total_key(neg_inf);
    cp_async_wait<kStages - 1>();  // this item's rows are in
    fence_async_shared();
    __syncthreads();

    const int cnt = min(ts, seg_cnt - cur.part * ts);
    const float* db = dbuf + static_cast<size_t>(j % kStages) * ts * dp;
    // Each staged token's norm, four lanes a token (every fourth 16-byte
    // chunk each, then added in the quad), +inf when its square is not
    // below 2^100 (or not finite): the gate then admits every pair of its
    // chunk.
    for (int p0 = 0; p0 < cnt; p0 += kThreads / 4) {  // uniform across the CTA
      const int p = p0 + tid / 4;
      float s2 = 0.0f;
      if (p < cnt)
        for (int k = 4 * (tid & 3); k < dp; k += 16) {
          const float4 x = *reinterpret_cast<const float4*>(db + kmajor_offset<4>(p, k, ts));
          s2 = fmaf(x.x, x.x, s2);
          s2 = fmaf(x.y, x.y, s2);
          s2 = fmaf(x.z, x.z, s2);
          s2 = fmaf(x.w, x.w, s2);
        }
      s2 += __shfl_xor_sync(0xFFFFFFFFu, s2, 1);
      s2 += __shfl_xor_sync(0xFFFFFFFFu, s2, 2);
      if (p < cnt && (tid & 3) == 0) xn[p] = s2 < 0x1p100f ? sqrtf(s2) + 0x1p-59f : -neg_inf;
    }
    __syncthreads();

    const uint32_t d0 = smem_u32(db);
    for (int p0 = 0; p0 < n_tiles; p0 += 2 * TPW) {  // one pass unless mt > 256
      float lim[TPW][2], kqv[TPW][2];
      int rowv[TPW][2];
#pragma unroll
      for (int a = 0; a < TPW; ++a)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (p0 + wt + a) * 64 + acc_row(2 * h, t);
          rowv[a][h] = row;
          const bool live = row < n_tok && p0 + wt + a < n_tiles;
          kqv[a][h] = live ? kq[row] : 0.0f;
          lim[a][h] = (first || !live) ? neg_inf : lo_w[row];
        }
      for (int c0 = c_first; c0 < cnt; c0 += c_step) {
        float acc[TPW][32];
#pragma unroll
        for (int a = 0; a < TPW; ++a)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[a][i] = 0.0f;
        for (int k0 = 0; k0 < dp; k0 += (resident ? dp : kb)) {
          const int kw = resident ? dp : min(kb, dp - k0);
          if (!resident) {
            __syncthreads();  // both warpgroups are done with the last block
            stage_query(qs, qt, n_tok, d, p0 * 64, prow, k0, kw);
            fence_async_shared();
            __syncthreads();
          }
#pragma unroll
          for (int a = 0; a < TPW; ++a)
#pragma unroll
            for (int i = 0; i < 32; ++i) fence_operand(acc[a][i]);
          wgmma_fence();
#pragma unroll
          for (int a = 0; a < TPW; ++a) {
            const int tile = p0 + wt + a;
            if (tile < n_tiles) {  // uniform across the warpgroup
              for (int s = 0; s < kw / 8; ++s) {
                const uint64_t adesc =
                    resident ? kmajor_desc(q0 + (tile * 64 + (k0 / 4 + 2 * s) * mt) * 16, mt)
                             : kmajor_desc(q0 + ((wt + a) * 64 + 2 * s * prow) * 16, prow);
                wgmma_tf32_m64n64k8(acc[a], adesc,
                                    kmajor_desc(d0 + (c0 + (k0 / 4 + 2 * s) * ts) * 16, ts));
              }
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int a = 0; a < TPW; ++a)
#pragma unroll
            for (int i = 0; i < 32; ++i) fence_operand(acc[a][i]);
        }
        // The chunk's largest token norm: the quad's 4 lanes hold its 64
        // columns. T = kq X + m_abs bounds every pair of a row in the chunk.
        float xc = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + acc_col(i + e, t);
            if (col < cnt) xc = fmaxf(xc, xn[col]);
          }
        }
        xc = fmaxf(xc, __shfl_xor_sync(0xFFFFFFFFu, xc, 1));
        xc = fmaxf(xc, __shfl_xor_sync(0xFFFFFFFFu, xc, 2));
        // The gate: L = max (s~ - T) per query token, merged in the quad;
        // then a bit per accumulator that could still be its token's best.
        unsigned cand[TPW];
        int mine = 0;
#pragma unroll
        for (int a = 0; a < TPW; ++a) {
          cand[a] = 0;
          if (p0 + wt + a >= n_tiles) continue;  // uniform across the warpgroup
          float top[2] = {neg_inf, neg_inf};
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (c0 + acc_col(i, t) < cnt) top[(i >> 1) & 1] = fmaxf(top[(i >> 1) & 1], acc[a][i]);
          float tm[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            top[h] = fmaxf(top[h], __shfl_xor_sync(0xFFFFFFFFu, top[h], 1));
            top[h] = fmaxf(top[h], __shfl_xor_sync(0xFFFFFFFFu, top[h], 2));
            tm[h] = __fmaf_rn(kqv[a][h], xc, m_abs);
            lim[a][h] = fmaxf(lim[a][h], top[h] - tm[h]);
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int h = (i >> 1) & 1;
            if (c0 + acc_col(i, t) < cnt && rowv[a][h] < n_tok && !(acc[a][i] + tm[h] < lim[a][h]))
              cand[a] |= 1u << i;
          }
          mine += __popc(cand[a]);
        }
        // Re-score the warp's candidates spread over its lanes: an exclusive
        // scan of the lanes' counts, then candidate g to lane g % 32, which
        // finds its owner by a binary search of the scan.
        int incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
          if (lane >= o) incl += up;
        }
        const int excl = incl - mine, total = __shfl_sync(0xFFFFFFFFu, incl, 31);
        for (int g0 = 0; g0 < total; g0 += 32) {  // uniform across the warp
          const int g = g0 + lane;
          int own = 0;
#pragma unroll
          for (int step = 16; step > 0; step >>= 1) {
            const int v = __shfl_sync(0xFFFFFFFFu, excl, own + step);
            if (v <= g) own += step;
          }
          unsigned m[TPW];
#pragma unroll
          for (int a = 0; a < TPW; ++a) m[a] = __shfl_sync(0xFFFFFFFFu, cand[a], own);
          const int first_g = __shfl_sync(0xFFFFFFFFu, excl, own);
          if (g < total) {
            int r = g - first_g, a = 0;
            unsigned mm = m[0];
#pragma unroll
            for (int b = 1; b < TPW; ++b)
              if (r >= __popc(mm)) {
                r -= __popc(mm);
                mm = m[b];
                a = b;
              }
            const int i = __fns(mm, 0, r + 1), ot = (t & ~31) | own;
            const int row = (p0 + wt + a) * 64 + acc_row(i, ot);
            const int col = c0 + acc_col(i, ot);
            const float s = exact_dot(db, col, ts, qs, row, mt,
                                      resident ? nullptr : qt + static_cast<size_t>(row) * d, d,
                                      d4);
            atomicMax(best_s + row, total_key(s));
            ++pairs;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < TPW; ++a)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (rowv[a][h] < n_tok && p0 + wt + a < n_tiles && (t & 3) == 0)
            lo_w[rowv[a][h]] = lim[a][h];
    }
    if (last_part && it.hi == td) {  // the document's last item: its scores
      __syncthreads();
      for (int b = tid; b < nb_tile; b += kThreads) {
        float s = 0.0f;
#pragma unroll 8
        for (int i = 0; i < tq; ++i) {
          const float v = key_value(best_s[b * tq + i]);
          s = __fadd_rn(s, v == neg_inf ? 0.0f : v);
        }
        out[static_cast<size_t>(b0 + b) * n + it.doc] = (s != s) ? __int_as_float(0x7FC00000) : s;
      }
    }
    // Segment sigma + kStages's list, into the slot of a segment whose rows
    // are all staged; its mask bytes were loaded above.
    if (last_part && tid < 32 && ahead.doc < n) {
      const int to = static_cast<int>((cur.sigma + kStages) % kLists);
      list_item(ahead, ids + to * seg, cnt_s + to, pre, mask, td);
    }
    __syncthreads();  // the bests, this buffer and the lists are reused
    cur = advance(cur, seg_cnt, ts);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pairs += __shfl_xor_sync(0xFFFFFFFFu, pairs, o);
  if (lane == 0 && pairs != 0) atomicAdd(rescored, pairs);
}

template <int TPW, int kCtas, bool kAsync>
cudaError_t launch_as(const float* q, const float* docs, const unsigned char* mask,
                      const float* qterm, float m_abs, unsigned long long* rescored, float* out,
                      int n_b, int tq, int td, int d, long long n, int qpt, int mt, int ts, int seg,
                      int kb, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(maxsim_scores<TPW, kCtas, kAsync>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  // kCtas CTAs per SM: the query tiles share the SMs, each tile's CTAs
  // walk all documents.
  const unsigned grid_y = static_cast<unsigned>((n_b + qpt - 1) / qpt);
  const long long slots = static_cast<long long>(sms) * kCtas;
  const long long per_tile = slots / grid_y > 0 ? slots / grid_y : 1;
  const unsigned grid_x = static_cast<unsigned>(n < per_tile ? n : per_tile);
  maxsim_scores<TPW, kCtas, kAsync><<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(
      q, docs, mask, qterm, m_abs, rescored, out, n_b, tq, td, d, n, qpt, mt, ts, seg, kb);
  return cudaGetLastError();
}

template <bool kAsync>
cudaError_t launch_shape(int tpw, int ctas, const float* q, const float* docs,
                         const unsigned char* mask, const float* qterm, float m_abs,
                         unsigned long long* rescored, float* out, int n_b, int tq, int td, int d,
                         long long n, int qpt, int mt, int ts, int seg, int kb, size_t smem,
                         cudaStream_t s) {
#define INNR_MAXSIM_LAUNCH(T, C)                                                                  \
  launch_as<T, C, kAsync>(q, docs, mask, qterm, m_abs, rescored, out, n_b, tq, td, d, n, qpt, mt, \
                          ts, seg, kb, smem, s)
  if (tpw == 1 && ctas == 1) return INNR_MAXSIM_LAUNCH(1, 1);
  if (tpw == 2 && ctas == 1) return INNR_MAXSIM_LAUNCH(2, 1);
  if (tpw == 1 && ctas == 2) return INNR_MAXSIM_LAUNCH(1, 2);
#undef INNR_MAXSIM_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q: (n_b, tq, d) float32; docs: (n, td, d) float32; mask: null or (n, td)
// bytes; qterm: (n_b * tq,) float32 gate terms kappa (||q|| + slack) per
// query token (+inf: always re-score); m_abs: the margin's absolute term;
// rescored: one uint64 the launch adds its re-scored pairs to; out: (n_b,
// n) float32. qpt whole queries per tile of mt tokens (a multiple of 64),
// scored in passes of 2 tiles_per_wg row tiles of 64 (tiles_per_wg: 1 or
// 2); documents in segments of seg_positions token positions, whose valid
// tokens are scored in items of at most item_tokens (a multiple of 8),
// staged one item ahead, ctas_per_sm (1, or 2 with tiles_per_wg 1) CTAs
// resident per SM; dim_block 0: the tile resident in
// shared memory, else the tile staged per pass in blocks of dim_block
// dimensions (a multiple of 8).
// Returns the cudaError_t of the launch (0 on success).
int innr_maxsim_scores(const void* q, const void* docs, const void* mask, const void* qterm,
                       float m_abs, void* rescored, void* out, int n_b, int tq, int td, int d,
                       long long n, int qpt, int mt, int tiles_per_wg, int item_tokens,
                       int seg_positions, int ctas_per_sm, int dim_block, void* stream) {
  const int ts = item_tokens, seg = seg_positions, kb = dim_block;
  if (n_b <= 0 || tq <= 0 || td <= 0 || d <= 0 || n <= 0 || qpt <= 0 || mt <= 0 ||
      mt % 64 != 0 || static_cast<long long>(qpt) * tq > mt || ts <= 0 || ts % 8 != 0 ||
      seg <= 0 || kb < 0 || kb % 8 != 0 || (n_b + qpt - 1) / qpt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t dp = (d + 7) & ~7;
  const size_t q_floats = kb == 0 ? static_cast<size_t>(mt) * dp
                                  : static_cast<size_t>(2 * tiles_per_wg * 64) * kb;
  const size_t smem = 4 * (static_cast<size_t>(kStages) * ts * dp + q_floats + ts + 2 * mt) +
                      4 * (mt + static_cast<size_t>(kStages + 1) * (seg + 1));
  auto qf = static_cast<const float*>(q);
  auto dc = static_cast<const float*>(docs);
  auto m = static_cast<const unsigned char*>(mask);
  auto qt = static_cast<const float*>(qterm);
  auto rs = static_cast<unsigned long long*>(rescored);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool async = d % 4 == 0 && reinterpret_cast<uintptr_t>(docs) % 16 == 0;
  if (async)
    return static_cast<int>(launch_shape<true>(tiles_per_wg, ctas_per_sm, qf, dc, m, qt,
                                               m_abs, rs, o, n_b, tq, td, d, n, qpt, mt, ts, seg,
                                               kb, smem, st));
  return static_cast<int>(launch_shape<false>(tiles_per_wg, ctas_per_sm, qf, dc, m, qt,
                                              m_abs, rs, o, n_b, tq, td, d, n, qpt, mt, ts, seg,
                                              kb, smem, st));
}

}  // extern "C"
