// Packed-word scoring of the per-row scan (packed.cu); the kind constants
// are shared with the kNN scan (packed_knn.cu).
//
// Binary vectors are uint32 words, bit i % 32 of word i / 32. Ternary
// vectors are two such planes: pos (value +1) and neg (value -1), never both.

#pragma once

namespace {

constexpr int kBinary = 0;
constexpr int kTernary = 1;

// Score of one corpus word against one query word: the Hamming count
// popc(p ^ a) for binary (n and b unused); for ternary with corpus planes
// (p, n) and query planes (a, b), same-sign minus opposite-sign positions.
template <int kKind>
__device__ __forceinline__ int word_score(unsigned p, unsigned n, unsigned a, unsigned b) {
  if constexpr (kKind == kBinary) {
    return __popc(p ^ a);
  } else {
    return __popc((p & a) | (n & b)) - __popc((p & b) | (n & a));
  }
}

}  // namespace
