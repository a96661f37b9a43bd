// Device helpers that fx_fused.cu and fx_xstage.cu share: the complex
// arithmetic both routes of the single pass form their parts with, and the
// sample sums' types.  The two routes agree bit for bit only while they
// compute these alike, so there is one copy.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a * conj(b)
__device__ __forceinline__ float2 cmulconj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// The sum type of each sample type: double for complex64 samples, exact
// 64-bit integers for int8 ones.
template <typename T> struct SumOf;
template <> struct SumOf<float2> {
  using type = double;
  using pair = double2;
};
template <> struct SumOf<char2> {
  using type = long long;
  using pair = longlong2;
};

}  // namespace
