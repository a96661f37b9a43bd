// Device helpers the port's kernels share: the complex arithmetic both
// routes of the single pass form their parts with (fx_fused.cu,
// fx_xstage.cu, fx_finish.cu), the sample sums' types and the block means
// formed from them, and the 16-byte cp.async copies (fx_xstage.cu,
// probes.cu).  The two routes agree bit for bit only while they compute
// these alike, so there is one copy.  Then the programmatic dependent
// launch the step's second and third kernels take, and the host launchers
// of those kernels that fx_step.cu chains (each defined in its own
// source).
#pragma once

#include <cuda_runtime.h>

#include <utility>

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

// Programmatic dependent launch (sm_90).  A kernel launched as a dependent
// of the one before it on its stream (launch_kernel, `dependent`) may be
// scheduled while that one is still running: it runs what needs none of
// that kernel's results, then waits here until that kernel has completed
// and its writes are visible.  Launched without the attribute, the wait
// returns at once.
__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Let the kernel launched after this one as a dependent be scheduled once
// every CTA of this grid has passed here (or exited); it still waits for
// this grid's completion before it reads what this grid writes.
__device__ __forceinline__ void release_dependent() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launch `kernel` on `st`; with `dependent`, as a programmatic dependent of
// the work before it on the stream (cudaLaunchAttributeProgrammatic-
// StreamSerialization).  A launch the runtime refuses returns its error;
// nothing is launched in its place.
template <typename... Params, typename... Args>
cudaError_t launch_kernel(void (*kernel)(Params...), dim3 grid, dim3 block,
                          size_t smem, cudaStream_t st, bool dependent,
                          Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The host launchers of a single-pass step's kernels.  fx_step.cu's entry
// chains them on one stream; the standalone entries of each source call the
// same launcher with `dependent` false.  Each returns the first CUDA error
// of its launches (0: none).
namespace fxt {

// fx_fused.cu: at deep taps (fir not NULL) the FIR launch, then the shared
// route's frame kernel (PartsOut; both launched as always) and then the
// parts reduce, which with `dependent` launches as a programmatic
// dependent of the frame kernel.  The arguments of fxt_fx_parts (int8:
// fxt_fx_parts_i8, with `step`).
int parts_step(bool int8, const void* x, const void* hist, const void* w,
               void* fir, const void* tw, const void* pairs, const void* da,
               void* sums, void* partial, void* parts, void* mu,
               void* new_hist, int nch, int K, int S, int nbins, int ntaps,
               int nbl, int n_groups, int frames_per_group, double step,
               bool dependent, cudaStream_t st);

// fx_fused.cu: at deep taps the FIR launch, then the wide route's frame
// kernel (WideOut), the arguments of fxt_fx_wide_frames (int8:
// fxt_fx_wide_frames_i8, with `step`).
int wide_frames(bool int8, const void* x, const void* hist, const void* w,
                void* fir, const void* tw, void* sums, void* spec, int nch,
                int K, int S, int nbins, int ntaps, int n_groups,
                int frames_per_group, double step, cudaStream_t st);

// fx_xstage.cu: the X kernel, the arguments of fxt_xstage (int8:
// fxt_xstage_i8, with `step`).
int xstage(bool int8, const void* spec, const void* pairs, const void* rowmap,
           const void* da, void* parts, const void* x, const void* sums,
           void* mu, void* new_hist, int nch, int K, int S, int nbins,
           int nbl, int halo, int n_groups, int tile, int slots, int rows,
           int frames, int stages, int threads, double step, bool dependent,
           cudaStream_t st);

// fx_finish.cu: the epilogue, the arguments of fxt_fx_finish.
int finish(const void* xp, const void* t, const void* gj, const void* mu,
           const void* mu_prev, const void* pairs, const void* abar,
           const void* cs, const void* cab, const void* cbb,
           const void* delays, const void* freqs, void* vis,
           long long xp_stride, long long t_stride, long long gj_stride,
           int K, int nbl, int nch, int nbins, int packed, int continuum,
           int n_frames, int chunk, double bandwidth, bool dependent,
           cudaStream_t st);

}  // namespace fxt
