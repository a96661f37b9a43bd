// Device helpers the port's kernels share: the complex arithmetic both
// routes of the single pass form their parts with (fx_fused.cu,
// fx_xstage.cu), the sample sums' types and the block means formed from
// them, and the 16-byte cp.async copies (fx_xstage.cu, probes.cu).  The two routes agree bit for bit only while they
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

// A block's mean of one channel from its groups' sums, by one warp: the
// lanes load 32 groups' sums at a time (0 past the last group) and every
// lane adds the 32 in group order from the shuffles, all issued ahead of
// the adds; formed in double (exact integers for 8-bit samples) and
// rounded once, as fx_fused.parts_reduce_reference forms it (a 0 added
// changes no sum).  Every lane of the warp calls it.
template <typename T>
__device__ float2 warp_block_mean(
    const typename SumOf<T>::pair* __restrict__ sums, int n_groups, int nch,
    long long n, double step) {
  using A = typename SumOf<T>::type;
  const int lane = threadIdx.x & 31;
  A r = 0, i = 0;
  for (int g0 = 0; g0 < n_groups; g0 += 32) {
    A vr = 0, vi = 0;
    if (g0 + lane < n_groups) {
      const typename SumOf<T>::pair v =
          sums[static_cast<size_t>(g0 + lane) * nch];
      vr = v.x;
      vi = v.y;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      r += __shfl_sync(0xffffffffu, vr, j);
      i += __shfl_sync(0xffffffffu, vi, j);
    }
  }
  const double nd = static_cast<double>(n);
  return make_float2(static_cast<float>(static_cast<double>(r) / nd * step),
                     static_cast<float>(static_cast<double>(i) / nd * step));
}

// 16 bytes from device memory to shared memory, not through registers.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `younger` of this thread's copy groups are pending
// (at most 7).
__device__ __forceinline__ void cp_async_wait_pending(int younger) {
  switch (younger) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

}  // namespace
