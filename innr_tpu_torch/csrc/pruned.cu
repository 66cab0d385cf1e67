// Tile-skipping threshold scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels innr_tpu/kernels/pruned_knn.py:
// _threshold_kernel_1q (static grid, _threshold_raw) and
// _threshold_outer_kernel (dynamic pipeline, _threshold_raw_dynamic). For
// one f32 query q (D,) against a row-major (N, D) f32 or bf16 corpus it
// writes, for every row of the survivor tiles order[0..*n_live) of
// tile_rows rows each,
//     out[r] = norms2[r] - 2 (q . r)          (the L2^2 without ||q||^2)
// and touches no other row: the caller's output starts at +inf, so rows of
// dead tiles read +inf, as on the TPU. The dot accumulates fp32 FMAs from
// +0.0, no TF32. bf16 rows are widened and the query is NOT rounded: the
// TPU kernel's dot takes the f32 query against the widened rows, unlike the
// kNN scan's bf16 rule (knn.cu). n_live is read on the device.
//
// Design. The live tiles are cut into chunks of chunk_rows consecutive rows,
// and the chunks are dealt in turn to a fixed grid (a few CTAs per SM), so
// that a handful of live tiles still spreads over every SM and dead tiles
// cost nothing. In a chunk each warp takes 4 rows at a time, its lanes on
// consecutive 16-byte vectors of each row (where D % elements-per-16-bytes
// == 0 and the corpus is 16-byte aligned; one element per load otherwise),
// so a warp's loads are coalesced and 4 rows' loads are in flight before
// any sum; each row's lane sums are reduced by shuffles. The query sits in
// shared memory.
//
// What bounds it on the H100: one read of the surviving rows (D FMAs per
// row, far below the FP32 rate), so the time should track a same-bytes
// read of the survivors. Rows of bf16 are half the bytes. (One CTA per tile
// slot, the TPU grid's shape, leaves a few live tiles to a few CTAs, each
// walking its tile alone: latency-bound, measured at 0.27 of a read of the
// survivors; PERF.md.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "vec.cuh"  // widen, Vec16, vector_loads

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;

// out[r] for the rows of one chunk [row0, row_end), the warps 4 rows apart.
template <typename T, bool kVector>
__device__ void chunk_dists(const float* q_s, const T* __restrict__ rows,
                            const float* __restrict__ norms2, float* __restrict__ out,
                            long long row0, long long row_end, int d) {
  constexpr int kVec = kVector ? Vec16<T>::kElems : 1;
  using Raw = typename std::conditional<kVector, uint4, float>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_row = d / kVec;
  for (long long r = row0 + warp * kRowsPerWarp; r < row_end; r += kWarps * kRowsPerWarp) {
    float s[kRowsPerWarp];
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
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
      if (lane == j && r + j < row_end) out[r + j] = __fsub_rn(norms2[r + j], __fmul_rn(2.0f, s[j]));
  }
}

// Chunk i of the live tiles order[0..*n_live) goes to CTA i % gridDim.x.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads) threshold_scan(
    const float* __restrict__ q, const T* __restrict__ rows, const float* __restrict__ norms2,
    const int* __restrict__ order, const int* __restrict__ n_live, float* __restrict__ out,
    long long n, int d, long long tile_rows, long long chunk_rows) {
  extern __shared__ float q_s[];  // [d]
  for (int i = threadIdx.x; i < d; i += kThreads) q_s[i] = q[i];
  __syncthreads();
  const long long per_tile = (tile_rows + chunk_rows - 1) / chunk_rows;
  const long long items = static_cast<long long>(*n_live) * per_tile;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long tile_begin = order[item / per_tile] * tile_rows;
    const long long row0 = tile_begin + item % per_tile * chunk_rows;
    chunk_dists<T, kVector>(q_s, rows, norms2, out, row0,
                            min(n, min(tile_begin + tile_rows, row0 + chunk_rows)), d);
  }
}

// The work of one launch: the tiles, their chunks and the grid.
struct Tiles {
  const int* order;
  const int* n_live;
  long long tile_rows;
  long long chunk_rows;
  int n_ctas;
};

template <typename T, bool kVector>
cudaError_t launch_as(const float* q, const T* rows, const float* norms2, float* out, long long n,
                      int d, Tiles t, cudaStream_t stream) {
  const size_t smem = sizeof(float) * d;
  cudaError_t err = cudaFuncSetAttribute(threshold_scan<T, kVector>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  threshold_scan<T, kVector><<<t.n_ctas, kThreads, smem, stream>>>(
      q, rows, norms2, t.order, t.n_live, out, n, d, t.tile_rows, t.chunk_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const float* q, const void* rows_v, const float* norms2, float* out,
                   long long n, int d, Tiles t, cudaStream_t stream) {
  const T* rows = static_cast<const T*>(rows_v);
  return vector_loads(rows, d) ? launch_as<T, true>(q, rows, norms2, out, n, d, t, stream)
                               : launch_as<T, false>(q, rows, norms2, out, n, d, t, stream);
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16. q: (d,) f32; rows: (n, d); norms2: (n,) f32;
// order: (n_tiles,) int32 tile ids; n_live: one int32 on the device; out:
// (n,) f32, written only on rows of the tiles order[0..*n_live); the live
// tiles go in chunks of chunk_rows rows to n_ctas CTAs.
// Returns the cudaError_t of the launch (0 on success).
int innr_threshold_scan(const void* q, const void* rows, int dtype, const void* norms2,
                        const void* order, const void* n_live, void* out, long long n, int d,
                        long long tile_rows, long long chunk_rows, int n_ctas, void* stream) {
  if (n <= 0 || d <= 0 || tile_rows <= 0 || chunk_rows <= 0 || n_ctas <= 0 ||
      order == nullptr || n_live == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto qf = static_cast<const float*>(q);
  auto nr = static_cast<const float*>(norms2);
  auto res = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const Tiles t{static_cast<const int*>(order), static_cast<const int*>(n_live), tile_rows,
                chunk_rows, n_ctas};
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float>(qf, rows, nr, res, n, d, t, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(qf, rows, nr, res, n, d, t, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
