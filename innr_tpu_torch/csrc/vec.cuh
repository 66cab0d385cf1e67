// Corpus element loads, shared by the dense scans (knn.cu, assign.cu,
// pruned.cu): f32, bf16 and u8 values widened to f32, one at a time or as
// the elements of a 16-byte vector (4 f32, 8 bf16 or 16 u8, little-endian).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// Code b (0..3) of a word of four u8 codes, as f32: a byte permute makes
// the f32 2^23 + c, and 2^23 comes off exactly (FP32 and integer pipes, not
// the slower integer-to-float conversion).
__device__ __forceinline__ float code_f32(unsigned w, int b) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + b)) - 0x1p23f;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(uint8_t x) { return code_f32(x, 0); }

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Element j of a 16-byte vector, widened to f32.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int kElems = 4;
  __device__ static float get(const uint4& v, int j) { return __uint_as_float(word(v, j)); }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static float get(const uint4& v, int j) {
    return __uint_as_float((word(v, j >> 1) >> (16 * (j & 1))) << 16);
  }
};
template <> struct Vec16<uint8_t> {
  static constexpr int kElems = 16;
  __device__ static float get(const uint4& v, int j) { return code_f32(word(v, j >> 2), j & 3); }
};

// 16-byte loads need D % kElems == 0 and a 16-byte aligned corpus.
template <typename T>
bool vector_loads(const T* rows, int d) {
  return d % Vec16<T>::kElems == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
}

}  // namespace
