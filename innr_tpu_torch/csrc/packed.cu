// Per-row packed-word scores for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of innr_tpu/kernels/hamming.py:
//   _hamming_kernel (batch_hamming_words)      (N,) XOR-popcount counts
//   _ternary_kernel (batch_ternary_dot_words)  (N,) ternary dots
// of one query against a row-major (N, W) uint32 corpus (one plane for
// binary, pos and neg planes for ternary), with no top-k: out[r] is the
// int32 score of row r (packed.cuh, word_score).
//
// Design. packed_rows: a CTA of 256 threads takes R consecutive rows (256,
// fewer for very long rows), which are one contiguous run of R * W words in
// each plane. Its threads walk that run with consecutive threads on
// consecutive V-word vectors (V = 4, 16-byte loads, where W % 4 == 0 and
// the planes are 16-byte aligned; V = 1 otherwise), so every warp-wide load
// is fully coalesced. Each vector's score goes to shared memory, and then
// one thread per row sums its row's W / V scores. The query words sit in
// shared memory, read by many lanes at a time.
//
// What bounds it on the H100: one read of the corpus (4 W bytes per row and
// plane) and one popcount per word and plane (two for ternary), 16 per
// clock per SM: at 30M x 24 words that is 0.72 G popcounts, far below the
// time of reading the 2.88 GB, so the kernel is bound by the read.
// (A first version gave each thread one whole row: a warp's loads then
// stride by the row length, and with both ternary planes the lines did not
// stay in L1 between a thread's loads: 3.3 ms for 15M x 24 x 2 planes,
// against 1.0 ms for a same-bytes read; PERF.md.)

#include <cuda_runtime.h>
#include <cstdint>

#include "packed.cuh"  // kBinary, kTernary, word_score

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = kThreads;      // rows per CTA
constexpr int kPartBudget = 12 * 1024;  // vector scores per CTA (48 KB)

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int kKind, int V>
__global__ void __launch_bounds__(kThreads) packed_rows(
    const unsigned* __restrict__ qp, const unsigned* __restrict__ qn,
    const unsigned* __restrict__ pos, const unsigned* __restrict__ neg,
    int* __restrict__ out, long long n, int w, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* q_s = reinterpret_cast<unsigned*>(smem);                           // [planes][w]
  int* part_s = reinterpret_cast<int*>(q_s + (kKind == kTernary ? 2 : 1) * w);  // [rows][w / V]
  for (int i = threadIdx.x; i < w; i += kThreads) {
    q_s[i] = qp[i];
    if constexpr (kKind == kTernary) q_s[w + i] = qn[i];
  }
  const int per_row = w / V;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const int rows = static_cast<int>(min(static_cast<long long>(rows_per_cta), n - row0));
  const size_t base = static_cast<size_t>(row0) * per_row;  // in vectors of V words
  __syncthreads();

  for (int f = threadIdx.x; f < rows * per_row; f += kThreads) {
    const int c = (f % per_row) * V;  // the vector's first word within its row
    int s = 0;
    if constexpr (V == 4) {
      const uint4 p = reinterpret_cast<const uint4*>(pos)[base + f];
      const uint4 m = kKind == kTernary ? reinterpret_cast<const uint4*>(neg)[base + f]
                                        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s += word_score<kKind>(word(p, i), word(m, i), q_s[c + i],
                               kKind == kTernary ? q_s[w + c + i] : 0u);
    } else {
      s = word_score<kKind>(pos[base + f], kKind == kTernary ? neg[base + f] : 0u, q_s[c],
                            kKind == kTernary ? q_s[w + c] : 0u);
    }
    part_s[f] = s;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    int acc = 0;
    for (int v = 0; v < per_row; ++v) acc += part_s[r * per_row + v];
    out[row0 + r] = acc;
  }
}

template <int kKind, int V>
cudaError_t launch_rows_as(const unsigned* qp, const unsigned* qn, const unsigned* pos,
                           const unsigned* neg, int* out, long long n, int w,
                           cudaStream_t stream) {
  const int per_row = w / V;
  const int rows_per_cta = per_row >= kPartBudget ? 1 : min(kMaxRows, kPartBudget / per_row);
  const size_t smem = sizeof(unsigned) * (kKind == kTernary ? 2 : 1) * static_cast<size_t>(w) +
                      sizeof(int) * static_cast<size_t>(rows_per_cta) * per_row;
  cudaError_t err = cudaFuncSetAttribute(packed_rows<kKind, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n + rows_per_cta - 1) / rows_per_cta;
  packed_rows<kKind, V><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      qp, qn, pos, neg, out, n, w, rows_per_cta);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kKind>
cudaError_t launch_rows(const unsigned* qp, const unsigned* qn, const unsigned* pos,
                        const unsigned* neg, int* out, long long n, int w, cudaStream_t s) {
  const bool vector = w % 4 == 0 && aligned16(pos) && (kKind == kBinary || aligned16(neg));
  return vector ? launch_rows_as<kKind, 4>(qp, qn, pos, neg, out, n, w, s)
                : launch_rows_as<kKind, 1>(qp, qn, pos, neg, out, n, w, s);
}

}  // namespace

extern "C" {

// kind: 0 binary (qn, neg unused, may be null), 1 ternary. qp, qn: (w,)
// uint32; pos, neg: (n, w) uint32 row-major; out: (n,) int32.
// Returns the cudaError_t of the launch (0 on success).
int innr_packed_rows(int kind, const void* qp, const void* qn, const void* pos,
                     const void* neg, void* out, long long n, int w, void* stream) {
  if (n <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kTernary && (qn == nullptr || neg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto a = static_cast<const unsigned*>(qp);
  auto b = static_cast<const unsigned*>(qn);
  auto p = static_cast<const unsigned*>(pos);
  auto m = static_cast<const unsigned*>(neg);
  auto o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kBinary: return static_cast<int>(launch_rows<kBinary>(a, b, p, m, o, n, w, s));
    case kTernary: return static_cast<int>(launch_rows<kTernary>(a, b, p, m, o, n, w, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
