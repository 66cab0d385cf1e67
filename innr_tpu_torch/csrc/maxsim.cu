// MaxSim scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels innr_tpu/kernels/maxsim_kernel.py:_maxsim_kernel
// (launched by fused_maxsim_scores, one query) and _maxsim_kernel_mq
// (fused_maxsim_scores_batch, a batch): the query count is a runtime
// parameter, so both are maxsim_scores<R> here, for float32 documents
// (bf16 documents run on the tensor cores: maxsim_bf16.cu).
//
// Function. Queries (B, Tq, D) float32, documents (N, Td, D) float32, an optional
// (N, Td) byte mask (nonzero = valid token). For document n and query b:
//   score[b, n] = sum over i < Tq of clamp(max over valid j of q[b, i] . d[n, j])
// where clamp turns -inf into 0 (a fully masked document, or a best that is
// -inf for any other reason) and NaN and +inf propagate: the max is NaN-sticky,
// as jnp.max is (fmaxf would drop a NaN). Masked tokens never win. Each query
// is summed on its own, so a NaN or inf in one query's bests stays in that
// query's score (the TPU kernel's group-indicator matmul, a workaround for
// its compiler, spreads it to every query of the batch: ROADMAP R7). Dots are
// FP32 FMAs. A NaN score is written as the canonical 0x7FC00000.
//
// Design. A CTA of up to 8 warps holds one tile of query tokens in shared
// memory, transposed to [D][TT] (TT = 32 R tokens; zero rows pad D to a
// multiple of 4 and the tile to TT): whole queries, qpt of them, or one
// query's tokens when Tq > 128. Lane l scores tokens l + 32 r, r < R,
// reading its query values without bank conflicts. Each warp takes one
// document at a time (grid-stride over documents, grid.y over query tiles):
// it ballots the mask over 32 tokens at a time and stages only valid token
// rows, 8 at a time, into its own shared buffer (a short last group repeats
// its first token, which a max does not notice), reads them back as float4
// broadcasts, and keeps an R x 8 block of FMA accumulators and a running
// NaN-sticky max per token in registers. At the document's end each lane
// sums one query's Tq bests in order from +0.0 and writes (B, N) float32.
// The pair tensor (N, Td, B Tq) is never formed, the corpus is not padded
// or copied, masked rows are never read, and any Tq, Td and D run (D and
// the tile fit in shared memory; the wrapper checks).
//
// What bounds it on the H100 (ColBERTv2 widths: D 128, Tq 32, about 80 valid
// of 180 tokens): the valid tokens are about 8.2 GB at 200K documents, 2.4 ms
// at 3.35 TB/s; the FMAs are 2 B Tq D per valid token, 2 ms at Q = 1 and
// 31 ms at B = 16 on the 67 TFLOP/s FP32 pipes. Per 4 dimensions a warp
// issues 4 R query loads and 8 float4 broadcasts for 32 R FMAs, so at R = 4
// the FMA pipes, not shared memory, set the pace. A batch of B queries reads
// the corpus ceil(B / qpt) times (4 times at B = 16, Tq = 32). Later work:
// a larger query tile (fewer corpus reads at B > qpt), TMA
// staging, and the top-k fused into the scan.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kGroup = 8;  // doc tokens staged and scored per step

// A NaN in either argument wins; otherwise the larger.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b || b > a) ? b : a);
}

// The warp's ballot of valid tokens w .. w + 31 of one document.
__device__ __forceinline__ unsigned valid_bits(const unsigned char* mrow, int td, int w,
                                               int lane) {
  const int t = w + lane;
  const bool ok = t < td && (mrow == nullptr || mrow[t] != 0);
  return __ballot_sync(0xffffffffu, ok);
}

template <int R>
__global__ void __launch_bounds__(32 * kMaxWarps, 2) maxsim_scores(
    const float* __restrict__ q, const float* __restrict__ docs,
    const unsigned char* __restrict__ mask, float* __restrict__ out, int n_b, int tq, int td,
    int d, long long n, int qpt, int tile_tokens) {
  extern __shared__ __align__(16) float smem[];
  const int d4 = (d + 3) & ~3;
  const int tt = tile_tokens;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int b0 = blockIdx.y * qpt;
  const int nb_tile = min(qpt, n_b - b0);
  const int n_tok = nb_tile * tq;

  float* qs = smem;  // [d4][tt]
  for (int i = threadIdx.x; i < d4 * tt; i += blockDim.x) {
    const int dd = i / tt, t = i - dd * tt;
    qs[i] = (dd < d && t < n_tok) ? q[(static_cast<size_t>(b0) * tq + t) * d + dd] : 0.0f;
  }
  __syncthreads();
  float* dbuf = smem + static_cast<size_t>(d4) * tt + warp * (kGroup * d4 + tt);  // [kGroup][d4]
  float* sbest = dbuf + kGroup * d4;                                                // [tt]
  const float neg_inf = -__int_as_float(0x7f800000);

  for (long long doc = static_cast<long long>(blockIdx.x) * n_warps + warp; doc < n;
       doc += static_cast<long long>(gridDim.x) * n_warps) {
    const float* drow = docs + static_cast<size_t>(doc) * td * d;
    const unsigned char* mrow = mask ? mask + static_cast<size_t>(doc) * td : nullptr;
    for (int g = 0; g < tt; g += 32 * R) {
      float best[R];
#pragma unroll
      for (int r = 0; r < R; ++r) best[r] = neg_inf;
      int w = 0;
      unsigned bits = valid_bits(mrow, td, 0, lane);
      while (true) {
        int id[kGroup];
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          while (bits == 0 && w + 32 < td) {
            w += 32;
            bits = valid_bits(mrow, td, w, lane);
          }
          if (bits != 0) {
            id[j] = w + __ffs(bits) - 1;
            bits &= bits - 1;
            ++cnt;
          } else {
            id[j] = j == 0 ? 0 : id[0];
          }
        }
        if (cnt == 0) break;
        __syncwarp();  // the previous group's reads are done
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const float* row = drow + static_cast<size_t>(id[j]) * d;
          for (int dd = lane; dd < d4; dd += 32)
            dbuf[j * d4 + dd] = dd < d ? row[dd] : 0.0f;
        }
        __syncwarp();
        float acc[R][kGroup];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < kGroup; ++j) acc[r][j] = 0.0f;
        const float* qcol = qs + g + lane;
        for (int dd = 0; dd < d4; dd += 4) {
          float qv[4][R];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int r = 0; r < R; ++r) qv[i][r] = qcol[(dd + i) * tt + r * 32];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(dbuf + j * d4 + dd);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r][j] = fmaf(qv[0][r], v.x, acc[r][j]);
              acc[r][j] = fmaf(qv[1][r], v.y, acc[r][j]);
              acc[r][j] = fmaf(qv[2][r], v.z, acc[r][j]);
              acc[r][j] = fmaf(qv[3][r], v.w, acc[r][j]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < kGroup; ++j) best[r] = nan_max(best[r], acc[r][j]);
        if (cnt < kGroup) break;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) sbest[g + r * 32 + lane] = best[r];
    }
    __syncwarp();
    for (int j = lane; j < nb_tile; j += 32) {
      float s = 0.0f;
      for (int i = 0; i < tq; ++i) {
        const float v = sbest[j * tq + i];
        s = __fadd_rn(s, v == neg_inf ? 0.0f : v);
      }
      out[static_cast<size_t>(b0 + j) * n + doc] = (s != s) ? __int_as_float(0x7FC00000) : s;
    }
    __syncwarp();  // sbest and dbuf are reused for the next document
  }
}

template <int R>
cudaError_t launch_as(const float* q, const float* docs, const unsigned char* mask, float* out,
                      int n_b, int tq, int td, int d, long long n, int qpt, int tile_tokens,
                      int warps, cudaStream_t stream) {
  const int d4 = (d + 3) & ~3;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(d4) * tile_tokens +
                       static_cast<size_t>(warps) * (kGroup * d4 + tile_tokens));
  cudaError_t err = cudaFuncSetAttribute(maxsim_scores<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // Enough CTAs for several waves of resident ones; each walks its
  // documents grid-stride, so its query tile is loaded once.
  const long long per_cta = warps;
  const long long want = (n + per_cta - 1) / per_cta;
  const unsigned grid_x = static_cast<unsigned>(want < 132 * 8 ? want : 132 * 8);
  const unsigned grid_y = static_cast<unsigned>((n_b + qpt - 1) / qpt);
  maxsim_scores<R><<<dim3(grid_x, grid_y), 32 * warps, smem, stream>>>(
      q, docs, mask, out, n_b, tq, td, d, n, qpt, tile_tokens);
  return cudaGetLastError();
}

cudaError_t launch_r(int r, const float* q, const float* docs, const unsigned char* mask,
                     float* out, int n_b, int tq, int td, int d, long long n, int qpt,
                     int tile_tokens, int warps, cudaStream_t stream) {
  switch (r) {
    case 1: return launch_as<1>(q, docs, mask, out, n_b, tq, td, d, n, qpt, tile_tokens, warps, stream);
    case 2: return launch_as<2>(q, docs, mask, out, n_b, tq, td, d, n, qpt, tile_tokens, warps, stream);
    case 4: return launch_as<4>(q, docs, mask, out, n_b, tq, td, d, n, qpt, tile_tokens, warps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (n_b, tq, d) float32; docs: (n, td, d) float32; mask: null or (n, td) bytes;
// out: (n_b, n) float32. tokens_per_lane: 1, 2 or 4; tile_tokens: a multiple
// of 32 * tokens_per_lane that holds qpt whole queries; warps: 1 to 8.
// Returns the cudaError_t of the launch (0 on success).
int innr_maxsim_scores(const void* q, const void* docs, const void* mask, void* out,
                       int n_b, int tq, int td, int d, long long n, int tokens_per_lane,
                       int qpt, int tile_tokens, int warps, void* stream) {
  const int r = tokens_per_lane;
  if (n_b <= 0 || tq <= 0 || td <= 0 || d <= 0 || n <= 0 || qpt <= 0 || warps < 1 ||
      warps > kMaxWarps || r <= 0 || tile_tokens <= 0 || tile_tokens % (32 * r) != 0 ||
      static_cast<long long>(qpt) * tq > tile_tokens || (n_b + qpt - 1) / qpt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto qf = static_cast<const float*>(q);
  auto m = static_cast<const unsigned char*>(mask);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_r(r, qf, static_cast<const float*>(docs), m, o, n_b, tq, td, d,
                                   n, qpt, tile_tokens, warps, st));
}

}  // extern "C"
