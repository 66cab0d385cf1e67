// Nearest-centroid assignment for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel innr_tpu/kernels/assign.py:_nearest_kernel
// (launched by nearest_centroid), the full-corpus pass of k-means behind
// cluster_reorder and the IVFIndex build. For (N, D) rows of f32, bf16 or
// u8 (widened to f32) and (KC, D) f32 centroids it writes, per row, the
// int32 index of
//     argmin_c  ||c||^2 - 2 x . c
// which is the TPU kernel's argmax_c x . c - ||c||^2 / 2 bit for bit: the
// factor of 2 is exact, so the two scores differ by a factor of -2 and
// rank alike. Ties go to the lowest centroid: each score is keyed as K1's
// L2 keys are (topk.cuh: total_key, bit-inverted) and joined with the
// centroid index in an int64 composite, and the row's best is the largest
// composite. A NaN score ranks below every number, so a row whose every
// score is NaN gets centroid 0, as on the TPU. (A row holding +-inf scores
// NaN only on some centroids; the TPU kernel then drops whole centroid
// tiles, this kernel only the NaN scores: ROADMAP R6.) ||c||^2 comes from
// the caller (norms2 of the centroids, the same tensor the plain version
// uses). The dot accumulates fp32 FMAs in dimension order from +0.0.
//
// Design. K1's l2 scan turned around: every row is a query and the
// centroids are the corpus, with k = 1. A CTA holds a tile of 128 rows in
// shared memory (transposed, all of D when D <= 128: read once; otherwise
// 128 dimensions at a time, re-read for every centroid chunk) and streams
// the centroids through shared memory in chunks of 32 centroids x 32
// dimensions. Each thread keeps a 4-row x 4-centroid register tile of dots
// (K1's), and after each chunk folds its 4 centroids into a running best
// composite per row in registers; the 8 warps' bests per row meet in shared
// memory at the end. KC has no limit and no size gate.
//
// What bounds it on the H100: N KC D FMAs (10M x 16,896 x 128: 2.2e13,
// about 0.65 s at the FP32 SIMT peak of 67 TFLOP/s) against a corpus read
// of 5 GB and a centroid stream from L2. The register tile and the shared-
// memory reads per FMA are K1's, so expect K1's FMA rate, a few times below
// peak. Left for later: a tensor-core (wgmma) design and a larger register
// tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "topk.cuh"  // total_key, composite
#include "vec.cuh"   // widen

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 128;                    // rows per CTA: lane + 32 i
constexpr int kCentTile = 32;                    // centroids per chunk
constexpr int kDimChunk = 32;                    // centroid dimensions staged at a time
constexpr int kDimBlock = 128;                   // row dimensions held at a time
constexpr int kRowsPerThread = kRowTile / 32;
constexpr int kCentsPerThread = kCentTile / kWarps;
constexpr int kRowStride = kRowTile + 1;         // padded: conflict-free transpose

static_assert(kCentsPerThread == 4, "the float4 centroid read assumes 4");
static_assert(kDimBlock % kDimChunk == 0, "a row block holds whole chunks");
static_assert(kWarps * kRowTile * 8 <= kDimBlock * kRowStride * 4, "the reduction fits");

// rows_s[c][r] = rows[row0 + r][b0 + c] for the block [b0, b_end).
template <typename T>
__device__ void load_rows(float* rows_s, const T* __restrict__ rows, long long row0, long long n,
                          int d, int b0, int b_end) {
  const int width = b_end - b0;
  for (int f = threadIdx.x; f < kRowTile * width; f += kThreads) {
    const int r = f / width, c = f % width;
    const long long row = row0 + r;
    rows_s[c * kRowStride + r] =
        row < n ? widen(rows[static_cast<size_t>(row) * d + b0 + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) nearest_centroid(
    const T* __restrict__ rows, const float* __restrict__ cent,
    const float* __restrict__ cnorm2, int* __restrict__ out, long long n, int d, int kc) {
  extern __shared__ __align__(16) float smem[];
  float* rows_s = smem;                              // [kDimBlock][129]
  float* cent_s = rows_s + kDimBlock * kRowStride;   // [32 dims][32 centroids]
  long long* red = reinterpret_cast<long long*>(smem);  // [8][128], after the loop

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowTile;
  const int n_blocks = (d + kDimBlock - 1) / kDimBlock;
  const bool resident = n_blocks == 1;
  if (resident) load_rows(rows_s, rows, row0, n, d, 0, d);

  long long best[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) best[i] = LLONG_MIN;

  for (int c0 = 0; c0 < kc; c0 += kCentTile) {
    float acc[kRowsPerThread][kCentsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kCentsPerThread; ++j) acc[i][j] = 0.0f;

    for (int b = 0; b < n_blocks; ++b) {
      const int b0 = b * kDimBlock, b_end = min(d, b0 + kDimBlock);
      if (!resident) {
        __syncthreads();  // every warp is done with the previous block
        load_rows(rows_s, rows, row0, n, d, b0, b_end);
      }
      for (int d0 = b0; d0 < b_end; d0 += kDimChunk) {
        __syncthreads();  // the rows are in; every warp is done with cent_s
        for (int f = tid; f < kCentTile * kDimChunk; f += kThreads) {
          const int cc = f / kDimChunk, c = f % kDimChunk;
          const int ci = c0 + cc, col = d0 + c;
          cent_s[c * kCentTile + cc] =
              (ci < kc && col < b_end) ? cent[static_cast<size_t>(ci) * d + col] : 0.0f;
        }
        __syncthreads();
        const int c_end = min(kDimChunk, b_end - d0);
        const float* rows_c = rows_s + (d0 - b0) * kRowStride;
        for (int c = 0; c < c_end; ++c) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&cent_s[c * kCentTile + warp * kCentsPerThread]);
          const float ca[kCentsPerThread] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const float rv = rows_c[c * kRowStride + lane + 32 * i];
#pragma unroll
            for (int j = 0; j < kCentsPerThread; ++j) acc[i][j] = fmaf(rv, ca[j], acc[i][j]);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kCentsPerThread; ++j) {
      const int ci = c0 + warp * kCentsPerThread + j;
      if (ci >= kc) continue;  // uniform across the warp
      const float cn = cnorm2[ci];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float s = __fsub_rn(cn, __fmul_rn(2.0f, acc[i][j]));
        best[i] = max(best[i], composite(~total_key(s), ci));
      }
    }
  }

  __syncthreads();  // every warp is done with rows_s, which red reuses
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) red[warp * kRowTile + lane + 32 * i] = best[i];
  __syncthreads();
  if (tid < kRowTile && row0 + tid < n) {
    long long m = red[tid];
    for (int w = 1; w < kWarps; ++w) m = max(m, red[w * kRowTile + tid]);
    out[row0 + tid] = static_cast<int>(0xFFFFFFFFll - (m & 0xFFFFFFFFll));
  }
}

template <typename T>
cudaError_t launch(const void* rows, const float* cent, const float* cnorm2, int* out,
                   long long n, int d, int kc, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kDimBlock * kRowStride + kDimChunk * kCentTile);
  cudaError_t err = cudaFuncSetAttribute(
      nearest_centroid<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kRowTile - 1) / kRowTile;
  nearest_centroid<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(rows), cent, cnorm2, out, n, d, kc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16, 2 u8. rows: (n, d); cent: (kc, d) f32; cnorm2:
// (kc,) f32 squared centroid norms; out: (n,) int32.
// Returns the cudaError_t of the launch (0 on success).
int innr_nearest_centroid(const void* rows, int dtype, const void* cent, const void* cnorm2,
                          void* out, long long n, int d, int kc, void* stream) {
  if (n <= 0 || d <= 0 || kc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto c = static_cast<const float*>(cent);
  auto cn = static_cast<const float*>(cnorm2);
  auto o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(rows, c, cn, o, n, d, kc, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(rows, c, cn, o, n, d, kc, s));
    case 2: return static_cast<int>(launch<uint8_t>(rows, c, cn, o, n, d, kc, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
