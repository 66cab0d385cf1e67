// The valid-token lists of the MaxSim kernels (maxsim.cu: f32 documents,
// maxsim_bf16.cu: bf16): a CTA walks its documents grid-stride, each cut
// into segments of ts token positions (work items), and warp 0 compacts the
// positions of an item's valid tokens (its mask bytes nonzero; every token
// without a mask) into a list, in order, for the CTA to stage.

#pragma once

#include <cuda_runtime.h>

namespace {

// The valid tokens of one document segment, tokens [lo, hi), in order,
// found by warp 0 in passes of 256 tokens, lane l holding 8 consecutive
// ones: mask_load issues a pass's 8 byte loads per lane and returns at once,
// compact uses them (a warp prefix sum of the lanes' counts places each
// lane's tokens), so the loads' latency passes under the work issued in
// between.
struct MaskBytes {
  unsigned char v[8];
};

__device__ __forceinline__ MaskBytes mask_load(const unsigned char* __restrict__ mrow, int hi,
                                               int w) {
  const int t0 = w + 8 * (threadIdx.x & 31);
  MaskBytes m;
#pragma unroll
  for (int s = 0; s < 8; ++s) m.v[s] = t0 + s < hi ? (mrow ? mrow[t0 + s] : 1) : 0;
  return m;
}

// Writes the valid tokens into ids and their count into *cnt; `first` holds
// the first pass's bytes from mask_load(mrow, hi, lo).
__device__ void compact(int* ids, int* cnt, MaskBytes first, const unsigned char* __restrict__ mrow,
                        int lo, int hi) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int w = lo; w < hi; w += 256) {
    const MaskBytes m = w == lo ? first : mask_load(mrow, hi, w);
    unsigned bits = 0;
#pragma unroll
    for (int s = 0; s < 8; ++s) bits |= (m.v[s] != 0 ? 1u : 0u) << s;
    const int mine = __popc(bits);
    int upto = mine;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, upto, o);
      if (lane >= o) upto += up;
    }
    int pos = base + upto - mine;
    while (bits) {
      ids[pos++] = w + 8 * lane + __ffs(bits) - 1;
      bits &= bits - 1;
    }
    base += __shfl_sync(0xFFFFFFFFu, upto, 31);
  }
  if (lane == 0) *cnt = base;
}

__device__ __forceinline__ const unsigned char* mask_row(const unsigned char* mask, long long doc,
                                                         int td) {
  return mask ? mask + static_cast<size_t>(doc) * td : nullptr;
}

// Work item k of this CTA: segment k % n_seg, tokens [lo, hi), of
// document blockIdx.x + (k / n_seg) gridDim.x (past n: none).
struct Item {
  long long doc;
  int lo, hi;
};

__device__ __forceinline__ Item item(long long k, int n_seg, int ts, int td) {
  const int lo = static_cast<int>(k % n_seg) * ts;
  return {blockIdx.x + (k / n_seg) * gridDim.x, lo, min(td, lo + ts)};
}

// Warp 0: the token list of item `it` into ids, its count into *cnt.
__device__ __forceinline__ void list_item(const Item& it, int* ids, int* cnt, MaskBytes first,
                                          const unsigned char* mask, int td) {
  compact(ids, cnt, first, mask_row(mask, it.doc, td), it.lo, it.hi);
}

}  // namespace
