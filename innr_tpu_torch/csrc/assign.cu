// Nearest-centroid assignment for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel innr_tpu/kernels/assign.py:_nearest_kernel
// (launched by nearest_centroid), the full-corpus pass of k-means behind
// cluster_reorder and the IVFIndex build. For (N, D) rows of f32, bf16 or
// u8 (widened to f32) and (KC, D) f32 centroids it writes, per row, the
// int32 index of
//     argmin_c  fl(||c||^2 - 2 dot_fma(x, c))
// which is the TPU kernel's argmax_c x . c - ||c||^2 / 2 bit for bit: the
// factor of 2 is exact, so the two scores differ by a factor of -2 and
// rank alike. dot_fma is fp32 FMAs in dimension order from +0.0. Ties go
// to the lowest centroid: each score is keyed as K1's L2 keys are
// (topk.cuh: total_key, bit-inverted) and joined with the centroid index in
// an int64 composite, and the row's best is the largest composite. A NaN
// score ranks below every number, so a row whose every score is NaN gets
// centroid 0, as on the TPU. (A row holding +-inf scores NaN only on some
// centroids; the TPU kernel then drops whole centroid tiles, this kernel
// only the NaN scores: ROADMAP R6.) ||c||^2 comes from the caller (norms2
// of the centroids, the same tensor the plain version uses).
//
// Design: score on the tensor cores, re-score a shortlist exactly.
// 1. A CTA holds a tile of 128 rows in shared memory (two warpgroups, 64
//    rows each; all of D when D <= 128, else 128 dimensions at a time) and
//    streams the centroids in chunks of 64 through a double-buffered
//    cp.async ring (mma.cuh's K-major layout, D padded to a multiple of 8
//    with zeros; chunk i + 1 and its per-centroid terms are copied under
//    chunk i's products, epilogue and re-scoring). One CTA per SM (131 KB,
//    255 registers): at two per SM (99 KB, one buffer) the 128-register cap
//    made the compiler spill, and that layout lost at KC = 256. wgmma
//    m64n64k8 in TF32 gives each (row, centroid) an
//    approximate dot a~, f32 accumulation. Operands are stored as f32 and
//    truncated by the hardware (TF32 keeps the top 10 mantissa bits): no
//    cvt.rna while staging. bf16 and u8 rows are exact in TF32; f32 rows
//    and the centroids round.
// 2. s~ = ||c||^2 - 2 a~ and T = kx ||c|| + tc bound |s - s~| for the exact
//    score s, with kx = kappa ||x|| and tc = tau ||c||^2 + an absolute term
//    (kernels/assign.py:shortlist_margin derives kappa and tau from
//    truncated operands, TC accumulation, the exact FMA chain and every
//    rounding of s~ and T, times a safety factor of 2; the wrapper passes
//    kappa and each centroid's (||c||^2, ||c||, tc, 0)). The exact winner c* always
//    has s~(c*) - T(c*) <= min_c [s~(c) + T(c)]. Each row keeps that
//    minimum as it falls, chunk by chunk, and admits every centroid with
//    s~ - T at or below it: a superset of the final shortlist, in one pass.
// 3. The admitted centroids of a row become a 64-bit word in shared
//    memory (the quad's bits ORed by shuffles) and are re-scored exactly in
//    the chunk's epilogue, two threads per row, with the old arithmetic
//    (fmaf in dimension order from +0.0, then __fsub_rn(cn, __fmul_rn(2,
//    acc))) on the resident row and centroid (from global memory when
//    D > 128), into a running best composite per thread. The result is the
//    SIMT kernel's bit for bit.
// 4. A row with a non-finite value (or a norm above 2^50) gets kx = +inf
//    and a centroid that is not finite (or above 2^50) tc = +inf: every
//    such pair is admitted and re-scored, so NaN rows keep centroid 0 and
//    +-inf rows today's answer. Each CTA writes its shortlist size (the
//    sum and the largest row) to its own two words: no shared counter.
//
// What bounds it on the H100: 2 N KC D TF32 operations (10M x 256 x 128:
// 1.3 ms at 495 TFLOP/s; x 16,896: 87 ms) against a corpus read of 5.1 GB
// (1.5 ms); the centroids are read from L2 once per 128-row tile. With one
// CTA per SM nothing overlaps the row staging, and the two warpgroups run
// products, epilogue and re-scoring in lockstep: at KC = 16,896 the kernel
// takes about 6x its TF32 bound (PERF.md, section 5). Left for later: a
// persistent CTA that prefetches its next row tile, the next chunk's
// products issued before this chunk's epilogue, TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "mma.cuh"   // K-major tiles, wgmma, cp.async
#include "topk.cuh"  // total_key, composite
#include "vec.cuh"   // widen

namespace {

constexpr int kThreads = 2 * kWgThreads;     // two warpgroups
constexpr int kRowTile = 128;                // rows per CTA: 64 per warpgroup
constexpr int kCentTile = 64;                // centroids per chunk: wgmma n
constexpr int kDimBlock = 128;               // dimensions staged at a time
constexpr int kAcc = kCentTile / 2;          // accumulators per thread

static_assert(kAcc == 32, "wgmma_tf32_m64n64k8 holds 32 accumulators");
static_assert(kCentTile == 64 && kThreads == 2 * kRowTile,
              "a 64-bit shortlist word per row, two re-scoring threads per row");

constexpr size_t kSmemBytes =
    sizeof(float) * (kRowTile * kDimBlock + 2 * kCentTile * kDimBlock + 2 * 4 * kCentTile +
                     kRowTile) +
    sizeof(unsigned long long) * kRowTile;

// Four elements of a row from dimension k, widened; zeros past d.
__device__ __forceinline__ float4 vec4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 vec4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xFFFF0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xFFFF0000u));
}
__device__ __forceinline__ float4 vec4(const uint8_t* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float4(static_cast<float>(w & 0xFFu), static_cast<float>((w >> 8) & 0xFFu),
                     static_cast<float>((w >> 16) & 0xFFu), static_cast<float>(w >> 24));
}
__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

template <typename T>
__device__ __forceinline__ float4 load4(const T* __restrict__ row, int k, int d, bool vec) {
  if (vec && k + 4 <= d) return vec4(row + k);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = k + i < d ? widen(row[k + i]) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Rows [row0, row0 + 128) x dimensions [k0, k0 + kp) into rows_s (K-major,
// zeros past n and d). Lanes 8j..8j+7 store 8 consecutive rows of one
// 16-byte chunk (128 contiguous bytes) and read 64 contiguous bytes of each
// row; a thread issues kBatch loads before their stores.
template <typename T>
__device__ void stage_rows(float* rows_s, const T* __restrict__ rows, long long row0,
                           long long n, int d, int k0, int kp, bool vec) {
  constexpr int kUnits = kRowTile * kDimBlock / 4 / kThreads;  // float4 per thread
  constexpr int kBatch = 8;
  const int nq = kp / 4, groups = 16 * ((nq + 3) / 4);
#pragma unroll
  for (int u0 = 0; u0 < kUnits; u0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int f = threadIdx.x + (u0 + u) * kThreads, l = f & 31, g = f >> 5;
      const int r = 8 * (g % 16) + (l & 7), q = 4 * (g / 16) + (l >> 3);
      const long long row = row0 + r;
      v[u] = (g < groups && q < nq && row < n)
                 ? load4(rows + static_cast<size_t>(row) * d, k0 + 4 * q, d, vec)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int f = threadIdx.x + (u0 + u) * kThreads, l = f & 31, g = f >> 5;
      const int r = 8 * (g % 16) + (l & 7), q = 4 * (g / 16) + (l >> 3);
      if (g < groups && q < nq)
        *reinterpret_cast<float4*>(rows_s + kmajor_offset<4>(r, 4 * q, kRowTile)) = v[u];
    }
  }
}

// Centroids [c0, c0 + 64) x dimensions [k0, k0 + kp) into dst by cp.async
// where a 16-byte chunk lies inside the centroid (async: D % 4 == 0 and an
// aligned base), zeros past kc and d; their (||c||^2, ||c||, tc, 0) into
// meta by cp.async too.
__device__ void stage_cent(float* dst, float4* meta, const float* __restrict__ cent,
                           const float4* __restrict__ cmeta, int c0, int kc, int d, int k0,
                           int kp, bool async) {
  const int nq = kp / 4;
  for (int f = threadIdx.x; f < kCentTile * nq; f += kThreads) {
    const int c = f / nq, q = f % nq, ci = c0 + c, k = k0 + 4 * q;
    float* p = dst + kmajor_offset<4>(c, 4 * q, kCentTile);
    const float* src = cent + static_cast<size_t>(ci) * d + k;
    if (async && ci < kc && k + 4 <= d) {
      cp_async16(p, src);
    } else {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = (ci < kc && k + i < d) ? src[i] : 0.0f;
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if (threadIdx.x < kCentTile) {
    const int ci = c0 + threadIdx.x;
    // Past kc: tc = +inf never lowers a threshold (and is never admitted).
    if (ci < kc)
      cp_async16(meta + threadIdx.x, cmeta + ci);
    else
      meta[threadIdx.x] = make_float4(0.0f, 0.0f, inf(), 0.0f);
  }
}

// acc += this warpgroup's 64 rows x the chunk's 64 centroids over kp dims.
__device__ __forceinline__ void mma_block(float (&acc)[kAcc], const float* a, const float* b,
                                          int kp) {
  const uint32_t a0 = smem_u32(a), b0 = smem_u32(b);
#pragma unroll
  for (int j = 0; j < kAcc; ++j) fence_operand(acc[j]);
  wgmma_fence();
  for (int s = 0; s < kp / 8; ++s)
    wgmma_tf32_m64n64k8(acc, kmajor_desc(a0 + s * 2 * kRowTile * 16, kRowTile),
                        kmajor_desc(b0 + s * 2 * kCentTile * 16, kCentTile));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < kAcc; ++j) fence_operand(acc[j]);
}

// The exact score of a row against a centroid: the SIMT kernel's dot,
// fmaf in dimension order from +0.0, then ||c||^2 - 2 dot. Row r and
// centroid col come from the resident tiles (all of D in shared memory),
// else from global memory.
template <typename T>
__device__ __forceinline__ float exact_score(const float* rows_s, const float* cent_s,
                                             const T* __restrict__ row,
                                             const float* __restrict__ c, float cn, int r,
                                             int col, int d, bool resident) {
  float a = 0.0f;
  if (resident) {
    int k = 0;
#pragma unroll 4
    for (; k + 4 <= d; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(rows_s + kmajor_offset<4>(r, k, kRowTile));
      const float4 y =
          *reinterpret_cast<const float4*>(cent_s + kmajor_offset<4>(col, k, kCentTile));
      a = fmaf(x.x, y.x, a);
      a = fmaf(x.y, y.y, a);
      a = fmaf(x.z, y.z, a);
      a = fmaf(x.w, y.w, a);
    }
    for (; k < d; ++k)
      a = fmaf(rows_s[kmajor_offset<4>(r, k, kRowTile)], cent_s[kmajor_offset<4>(col, k, kCentTile)],
               a);
  } else {
    for (int k = 0; k < d; ++k) a = fmaf(widen(row[k]), c[k], a);
  }
  return __fsub_rn(cn, __fmul_rn(2.0f, a));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) nearest_centroid(
    const T* __restrict__ rows, const float* __restrict__ cent,
    const float4* __restrict__ cmeta, float kappa, int* __restrict__ out,
    unsigned* __restrict__ stats, long long n, int d, int kc, bool vec_rows, bool async_cent) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* rows_s = reinterpret_cast<float*>(smem_raw);  // [D block][128 rows], K-major
  float* cent_s = rows_s + kRowTile * kDimBlock;        // [2][D block][64], K-major
  float4* meta_s = reinterpret_cast<float4*>(cent_s + 2 * kCentTile * kDimBlock);  // [2][64]
  float* rn2_s = reinterpret_cast<float*>(meta_s + 2 * kCentTile);             // [128]
  unsigned long long* admit_s =
      reinterpret_cast<unsigned long long*>(rn2_s + kRowTile);  // [128] shortlist bits

  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowTile;
  const int n_blocks = (d + kDimBlock - 1) / kDimBlock;
  const bool resident = n_blocks == 1;
  const int n_chunks = (kc + kCentTile - 1) / kCentTile;

  // Epilogue rows: this thread's two rows of its warpgroup's accumulators.
  int rl[2];
  bool rv[2];
  float kx[2] = {0.0f, 0.0f}, thr[2] = {inf(), inf()};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rl[h] = 64 * wg + acc_row(2 * h, t);
    rv[h] = row0 + rl[h] < n;
  }
  // Re-scoring rows: row tid / 2, each thread half of its chunk's bits.
  const int rr = tid >> 1, half = tid & 1;
  const bool rr_ok = row0 + rr < n;
  const T* rrow = rows + static_cast<size_t>(rr_ok ? row0 + rr : 0) * d;
  long long best = LLONG_MIN;
  unsigned count = 0;
  float norm2 = 0.0f;  // half of row rr's squared norm

  for (int i = 0; i < n_chunks; ++i) {
    const int c0 = i * kCentTile;
    const float4* meta = meta_s + (i & 1) * kCentTile;
    float acc[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;
    for (int b = 0; b < n_blocks; ++b) {
      const int k0 = b * kDimBlock, kp = (min(kDimBlock, d - k0) + 7) & ~7;
      if (!resident) {
        if (b > 0) __syncthreads();  // both warpgroups are done with the previous block
        stage_rows(rows_s, rows, row0, n, d, k0, kp, vec_rows);
        stage_cent(cent_s, meta_s + (i & 1) * kCentTile, cent, cmeta, c0, kc, d, k0, kp,
                   async_cent);
        cp_async_commit();
      } else if (i == 0) {
        stage_rows(rows_s, rows, row0, n, d, 0, kp, vec_rows);
        stage_cent(cent_s, meta_s, cent, cmeta, 0, kc, d, 0, kp, async_cent);
        cp_async_commit();
      }
      cp_async_wait<0>();  // this chunk's centroids are in
      fence_async_shared();
      __syncthreads();  // ... and everyone is done with the previous chunk
      if (resident && i + 1 < n_chunks) {
        // The next chunk into the other buffer: its copies run under this
        // chunk's products, epilogue and re-scoring.
        const int nb = (i + 1) & 1;
        stage_cent(cent_s + nb * kCentTile * kDimBlock, meta_s + nb * kCentTile, cent, cmeta,
                   c0 + kCentTile, kc, d, 0, kp, async_cent);
        cp_async_commit();
      }
      if (i == 0) {
        for (int q = half; q < kp / 4; q += 2) {
          const float4 x =
              *reinterpret_cast<const float4*>(rows_s + kmajor_offset<4>(rr, 4 * q, kRowTile));
          norm2 = fmaf(x.w, x.w, fmaf(x.z, x.z, fmaf(x.y, x.y, fmaf(x.x, x.x, norm2))));
        }
      }
      mma_block(acc, rows_s + kmajor_offset<4>(64 * wg, 0, kRowTile),
                cent_s + (resident ? (i & 1) * kCentTile * kDimBlock : 0), kp);
    }
    if (i == 0) {
      norm2 += __shfl_xor_sync(0xFFFFFFFFu, norm2, 1);
      if (half == 0) rn2_s[rr] = norm2;
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float rn2 = rn2_s[rl[h]];
        kx[h] = rn2 < 0x1p100f ? kappa * sqrtf(rn2) : inf();  // NaN, inf: re-score all
      }
    }

    // s~ - T into acc; the running bound min_c [s~ + T] of each row, over
    // its quad.
    float m[2] = {inf(), inf()};
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int h = (j >> 1) & 1;
      const float4 mt = meta[acc_col(j, t)];
      const float s = fmaf(-2.0f, acc[j], mt.x);
      const float tb = fmaf(kx[h], mt.y, mt.z);
      m[h] = fminf(m[h], s + tb);
      acc[j] = s - tb;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fminf(m[h], __shfl_xor_sync(0xFFFFFFFFu, m[h], 1));
      m[h] = fminf(m[h], __shfl_xor_sync(0xFFFFFFFFu, m[h], 2));
      thr[h] = fminf(thr[h], m[h]);
    }
    // Admit every centroid whose s~ - T is not above it (NaN admits); the
    // row's 64 bits meet over the quad. Column j of a thread lies in word
    // j / 16.
    unsigned bits[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int col = acc_col(j, t), h = (j >> 1) & 1;
      if (rv[h] && c0 + col < kc && !(acc[j] > thr[h])) bits[h][j >> 4] |= 1u << (col & 31);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        bits[h][w] |= __shfl_xor_sync(0xFFFFFFFFu, bits[h][w], 1);
        bits[h][w] |= __shfl_xor_sync(0xFFFFFFFFu, bits[h][w], 2);
      }
      if ((t & 3) == 0)
        admit_s[rl[h]] = (static_cast<unsigned long long>(bits[h][1]) << 32) | bits[h][0];
    }
    __syncthreads();

    // Exact re-scoring of the shortlist: row rr, this thread's 32 columns.
    unsigned mine = static_cast<unsigned>(admit_s[rr] >> (32 * half));
    count += __popc(mine);
    while (mine) {
      const int col = 32 * half + __ffs(mine) - 1, ci = c0 + col;
      mine &= mine - 1;
      const float s = exact_score(rows_s, cent_s + (i & 1) * kCentTile * kDimBlock, rrow,
                                  cent + static_cast<size_t>(ci) * d, meta[col].x, rr, col, d,
                                  resident);
      best = max(best, composite(~total_key(s), ci));
    }
  }

  best = max(best, static_cast<long long>(__shfl_xor_sync(0xFFFFFFFFu, best, 1)));
  const unsigned row_count = count + __shfl_xor_sync(0xFFFFFFFFu, count, 1);
  if (half == 0 && rr_ok)
    out[row0 + rr] = static_cast<int>(0xFFFFFFFFll - (best & 0xFFFFFFFFll));
  // This CTA's shortlist total and largest row, met in rn2_s (free now).
  const unsigned sum = __reduce_add_sync(0xFFFFFFFFu, count);
  const unsigned top = __reduce_max_sync(0xFFFFFFFFu, row_count);
  unsigned* red = reinterpret_cast<unsigned*>(rn2_s);
  __syncthreads();
  if ((tid & 31) == 0) {
    red[2 * (tid >> 5)] = sum;
    red[2 * (tid >> 5) + 1] = top;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned total = 0, most = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      total += red[2 * w];
      most = max(most, red[2 * w + 1]);
    }
    stats[2 * blockIdx.x] = total;
    stats[2 * blockIdx.x + 1] = most;
  }
}

template <typename T>
cudaError_t launch(const void* rows, const float* cent, const float4* cmeta, float kappa,
                   int* out, unsigned* stats, long long n, int d, int kc, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(nearest_centroid<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const bool vec_rows =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % (4 * sizeof(T)) == 0;
  const bool async_cent = d % 4 == 0 && reinterpret_cast<uintptr_t>(cent) % 16 == 0;
  const long long blocks = (n + kRowTile - 1) / kRowTile;
  nearest_centroid<T><<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(rows), cent, cmeta, kappa, out, stats, n, d, kc, vec_rows,
      async_cent);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 u8. rows: (n, d); cent: (kc, d) f32; cmeta: (kc,
// 4) f32, per centroid (||c||^2, ||c||, tc, 0): its squared norm, its norm
// and its absolute margin (+inf: always re-scored), 16-byte aligned; kappa:
// the margin per unit of ||x|| ||c|| (kernels/assign.py:shortlist_margin);
// out: (n,) int32; stats: 2 uint32 per 128-row tile, ceil(n / 128) x 2,
// which the launch fills with the tile's shortlist total and its largest
// per row.
// Returns the cudaError_t of the launch (0 on success).
int innr_nearest_centroid(const void* rows, int dtype, const void* cent, const void* cmeta,
                          float kappa, void* out, void* stats, long long n, int d, int kc,
                          void* stream) {
  if (n <= 0 || d <= 0 || kc <= 0 || reinterpret_cast<uintptr_t>(cmeta) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto c = static_cast<const float*>(cent);
  auto m = static_cast<const float4*>(cmeta);
  auto o = static_cast<int*>(out);
  auto st = static_cast<unsigned*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(rows, c, m, kappa, o, st, n, d, kc, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(rows, c, m, kappa, o, st, n, d, kc, s));
    case 2: return static_cast<int>(launch<uint8_t>(rows, c, m, kappa, o, st, n, d, kc, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
