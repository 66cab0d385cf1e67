// MaxSim scan over bf16 documents on Hopper's tensor cores (sm_90a), plain
// C interface.
//
// Replaces, for bf16 documents, the TPU kernels
// innr_tpu/kernels/maxsim_kernel.py:_maxsim_kernel (fused_maxsim_scores) and
// _maxsim_kernel_mq (fused_maxsim_scores_batch); maxsim.cu keeps the f32
// documents. The function is maxsim.cu's: for document n and query b,
//   score[b, n] = sum over i < Tq of clamp(max over valid j of q[b, i] . d[n, j])
// with the NaN-sticky max, -inf clamped to 0, masked tokens never winning,
// each query summed on its own in token order from +0.0 (ROADMAP R7), and a
// NaN score written as the canonical 0x7FC00000. The query arrives rounded
// to bf16 (the wrapper rounds it), and a product of two bf16 values is
// exact in f32, so wgmma with bf16 operands and f32 accumulation computes
// the JAX package's bf16 function (bf16 operands, f32 accumulation).
//
// Design. A CTA of two warpgroups holds one tile of whole queries (mt
// tokens; up to 512 by the wrapper's choice, 128 KB at D = 128) in shared
// memory as bf16, K-major (mma.cuh), zero rows and dimensions padding it to
// tiles of 64 and D to a multiple of 16: at B = 16, Tq = 32 the whole batch,
// so the corpus is read once per batch. A query longer than 512 tokens is
// one tile scored in passes of 8 row tiles. The CTA walks its documents
// grid-stride, each in segments of ts tokens (the whole document when it
// fits beside the query tile; the wrapper picks ts). Warp 0 compacts a
// segment's valid tokens (from its mask) into a list two segments ahead,
// and the CTA stages those token rows, and only those, into one of two
// segment buffers by cp.async (16-byte copies; element loads when D % 8 !=
// 0), one segment ahead of the one it scores. Each warpgroup runs wgmma
// m64n64k16 of its query tiles against 64 document tokens at a time; a
// chunk's columns past the valid count are masked in the epilogue, which
// keeps a NaN-sticky max per query token in registers. At the end of a pass
// the quads meet by shuffles and the maxes go to shared memory (merged into
// the earlier segments' there); after a document's last segment one thread
// per query sums its Tq maxes in order.
//
// What bounds it on the H100 (ColBERTv2 widths, about 80 valid tokens of
// 180): 2 B Tq D bf16 tensor-core operations per valid token (2.1 ms at
// B = 16 and 989 TFLOP/s) against 4.1 GB of valid bf16 tokens (1.2 ms).
// The last chunk of a segment is padded to 64 tokens (about 1.6 x the
// operations at 80 valid tokens), and the per-chunk epilogue and barriers
// are not overlapped with the tensor cores. Later: chunk widths fitted to
// the document, warp-specialised staging with TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "maxsim_tokens.cuh"  // Item, compact (the valid-token lists)
#include "mma.cuh"            // K-major tiles, wgmma, cp.async

namespace {

constexpr int kThreads = 2 * kWgThreads;
constexpr int kChunk = 64;  // document tokens per wgmma (n)

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b || b > a) ? b : a);
}

// The listed token rows of one document into buf (K-major, ts rows);
// dimensions past d keep the zeros written at the start.
template <bool kAsync>
__device__ void stage_doc(__nv_bfloat16* buf, const __nv_bfloat16* __restrict__ drow,
                          const int* ids, int cnt, int d, int ts) {
  if (kAsync) {
    const int nq = d / 8;
    for (int f = threadIdx.x; f < cnt * nq; f += kThreads) {
      const int p = f / nq, q = f % nq;
      cp_async16(buf + kmajor_offset<8>(p, 8 * q, ts),
                 drow + static_cast<size_t>(ids[p]) * d + 8 * q);
    }
  } else {
    for (int f = threadIdx.x; f < cnt * d; f += kThreads) {
      const int p = f / d, k = f % d;
      buf[kmajor_offset<8>(p, k, ts)] = drow[static_cast<size_t>(ids[p]) * d + k];
    }
  }
}

template <int TPW, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1) maxsim_scores_bf16(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ docs,
    const unsigned char* __restrict__ mask, float* __restrict__ out, int n_b, int tq, int td,
    int d, long long n, int qpt, int mt, int ts) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int dp = (d + 15) & ~15;
  // Two segment buffers first: a chunk's rows past ts read into what
  // follows, and the epilogue masks those columns.
  __nv_bfloat16* dbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][dp][ts]
  __nv_bfloat16* qs = dbuf + 2 * static_cast<size_t>(ts) * dp;       // [dp][mt]
  int* ids = reinterpret_cast<int*>(qs + static_cast<size_t>(mt) * dp);  // [2][ts]
  int* cnt_s = ids + 2 * ts;                                             // [3]
  float* sbest = reinterpret_cast<float*>(cnt_s + 3);                    // [mt]

  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int b0 = blockIdx.y * qpt;
  const int nb_tile = min(qpt, n_b - b0);
  const int n_tok = nb_tile * tq, n_tiles = mt / 64;
  const int n_seg = (td + ts - 1) / ts;
  const float neg_inf = -__int_as_float(0x7f800000);

  for (int i = tid; i < 2 * ts * dp; i += kThreads) dbuf[i] = __float2bfloat16_rn(0.0f);
  for (int i = tid; i < mt * dp; i += kThreads) {
    const int r = i / dp, k = i % dp;
    const float v = (r < n_tok && k < d) ? q[(static_cast<size_t>(b0) * tq + r) * d + k] : 0.0f;
    qs[kmajor_offset<8>(r, k, mt)] = __float2bfloat16_rn(v);
  }
  // Token lists two items ahead: item j's list in ids[j % 2] and its count
  // in cnt_s[j % 3]; its rows in dbuf[j % 2], one item ahead.
  for (int a = 0; a < 2; ++a) {
    const Item it = item(a, n_seg, ts, td);
    if (tid < 32 && it.doc < n)
      list_item(it, ids + a * ts, cnt_s + a, mask_load(mask_row(mask, it.doc, td), it.hi, it.lo),
                mask, td);
  }
  __syncthreads();
  const Item first = item(0, n_seg, ts, td);
  if (first.doc < n)
    stage_doc<kAsync>(dbuf, docs + static_cast<size_t>(first.doc) * td * d, ids, cnt_s[0], d, ts);
  cp_async_commit();

  const uint32_t q0 = smem_u32(qs);
  for (long long j = 0;; ++j) {
    const Item it = item(j, n_seg, ts, td);
    if (it.doc >= n) break;
    const Item next = item(j + 1, n_seg, ts, td), after = item(j + 2, n_seg, ts, td);
    const int cur = static_cast<int>(j & 1);
    if (next.doc < n)
      stage_doc<kAsync>(dbuf + (cur ^ 1) * ts * dp, docs + static_cast<size_t>(next.doc) * td * d,
                        ids + (cur ^ 1) * ts, cnt_s[(j + 1) % 3], d, ts);
    cp_async_commit();
    MaskBytes pre{};
    if (tid < 32 && after.doc < n)
      pre = mask_load(mask_row(mask, after.doc, td), after.hi, after.lo);
    cp_async_wait<1>();  // this item's rows are in
    fence_async_shared();
    __syncthreads();

    const int cnt = cnt_s[j % 3];
    const uint32_t d0 = smem_u32(dbuf + cur * ts * dp);
    for (int p0 = 0; p0 < n_tiles; p0 += 2 * TPW) {  // one pass unless mt > 512
      float best[TPW][2];
#pragma unroll
      for (int a = 0; a < TPW; ++a) best[a][0] = best[a][1] = neg_inf;
      for (int c0 = 0; c0 < cnt; c0 += kChunk) {
        float acc[TPW][32];
#pragma unroll
        for (int a = 0; a < TPW; ++a)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            acc[a][i] = 0.0f;
            fence_operand(acc[a][i]);
          }
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < TPW; ++a) {
          const int tile = p0 + wg * TPW + a;
          if (tile < n_tiles) {  // uniform across the warpgroup
            for (int s = 0; s < dp / 16; ++s)
              wgmma_bf16_m64n64k16(acc[a], kmajor_desc(q0 + (tile * 64 + s * 2 * mt) * 16, mt),
                                   kmajor_desc(d0 + (c0 + s * 2 * ts) * 16, ts));
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < TPW; ++a)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            fence_operand(acc[a][i]);
            if (c0 + acc_col(i, t) < cnt)
              best[a][(i >> 1) & 1] = nan_max(best[a][(i >> 1) & 1], acc[a][i]);
          }
      }
#pragma unroll
      for (int a = 0; a < TPW; ++a) {
        const int tile = p0 + wg * TPW + a;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = best[a][h];
          v = nan_max(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
          v = nan_max(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
          // Each token's max has one writer, the same in every segment.
          float* sb = sbest + tile * 64 + acc_row(2 * h, t);
          if (tile < n_tiles && (t & 3) == 0) *sb = it.lo == 0 ? v : nan_max(*sb, v);
        }
      }
    }
    if (it.hi == td) {  // the document's last segment: its scores
      __syncthreads();
      for (int b = tid; b < nb_tile; b += kThreads) {
        float s = 0.0f;
        for (int i = 0; i < tq; ++i) {
          const float v = sbest[b * tq + i];
          s = __fadd_rn(s, v == neg_inf ? 0.0f : v);
        }
        out[static_cast<size_t>(b0 + b) * n + it.doc] = (s != s) ? __int_as_float(0x7FC00000) : s;
      }
    }
    // Item j + 2's list, into the slots item j's staging and count no
    // longer need; its mask bytes were loaded above.
    if (tid < 32 && after.doc < n)
      list_item(after, ids + cur * ts, cnt_s + (j + 2) % 3, pre, mask, td);
    __syncthreads();  // sbest, this buffer and the lists are reused
  }
  cp_async_wait<0>();
}

template <int TPW, bool kAsync>
cudaError_t launch_as(const float* q, const __nv_bfloat16* docs, const unsigned char* mask,
                      float* out, int n_b, int tq, int td, int d, long long n, int qpt, int mt,
                      int ts, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(maxsim_scores_bf16<TPW, kAsync>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const unsigned grid_x = static_cast<unsigned>(n < sms ? n : sms);
  const unsigned grid_y = static_cast<unsigned>((n_b + qpt - 1) / qpt);
  maxsim_scores_bf16<TPW, kAsync><<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(
      q, docs, mask, out, n_b, tq, td, d, n, qpt, mt, ts);
  return cudaGetLastError();
}

template <bool kAsync>
cudaError_t launch_tpw(int tpw, const float* q, const __nv_bfloat16* docs,
                       const unsigned char* mask, float* out, int n_b, int tq, int td, int d,
                       long long n, int qpt, int mt, int ts, size_t smem, cudaStream_t s) {
  switch (tpw) {
    case 1: return launch_as<1, kAsync>(q, docs, mask, out, n_b, tq, td, d, n, qpt, mt, ts, smem, s);
    case 2: return launch_as<2, kAsync>(q, docs, mask, out, n_b, tq, td, d, n, qpt, mt, ts, smem, s);
    case 4: return launch_as<4, kAsync>(q, docs, mask, out, n_b, tq, td, d, n, qpt, mt, ts, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (n_b, tq, d) float32, bf16-rounded; docs: (n, td, d) bfloat16; mask:
// null or (n, td) bytes; out: (n_b, n) float32. qpt whole queries per tile
// of mt tokens (a multiple of 64), scored in passes of 2 tiles_per_wg row
// tiles of 64 (tiles_per_wg: 1, 2 or 4); documents in segments of
// seg_tokens tokens (a multiple of 8).
// Returns the cudaError_t of the launch (0 on success).
int innr_maxsim_scores_bf16(const void* q, const void* docs, const void* mask, void* out,
                            int n_b, int tq, int td, int d, long long n, int qpt, int mt,
                            int tiles_per_wg, int seg_tokens, void* stream) {
  const int ts = seg_tokens;
  if (n_b <= 0 || tq <= 0 || td <= 0 || d <= 0 || n <= 0 || qpt <= 0 || mt <= 0 ||
      mt % 64 != 0 || static_cast<long long>(qpt) * tq > mt || ts <= 0 || ts % 8 != 0 ||
      (n_b + qpt - 1) / qpt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t dp = (d + 15) & ~15;
  const size_t smem = 2 * (2 * static_cast<size_t>(ts) * dp + static_cast<size_t>(mt) * dp) +
                      4 * (2 * static_cast<size_t>(ts) + 3 + mt);
  auto qf = static_cast<const float*>(q);
  auto dc = static_cast<const __nv_bfloat16*>(docs);
  auto m = static_cast<const unsigned char*>(mask);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool async = d % 8 == 0 && reinterpret_cast<uintptr_t>(docs) % 16 == 0;
  if (async)
    return static_cast<int>(
        launch_tpw<true>(tiles_per_wg, qf, dc, m, o, n_b, tq, td, d, n, qpt, mt, ts, smem, st));
  return static_cast<int>(
      launch_tpw<false>(tiles_per_wg, qf, dc, m, o, n_b, tq, td, d, n, qpt, mt, ts, smem, st));
}

}  // extern "C"
