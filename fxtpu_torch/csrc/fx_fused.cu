// The fused FX step for one block: DC removal, PFB FIR with carried tap
// history, an nbins-point FFT in shared memory, and the frame-summed cross
// power of every baseline.  Built by fxtpu_torch/cuda_build.py, called
// through fxtpu_torch/ops/fx_fused.py (fx_fused_raw).
//
// Replaces: fxtpu/ops/pfb_pallas.py _fx_kernel in f32 direct-tap mode
// (launched by _fx_call, wrapped by fx_pallas_parts / fx_pallas_raw_multi /
// fx_pallas_raw), for any list of baseline pairs, autos included.
//
// Contract (fx_pallas_raw): given x complex64 [nch, S, nbins], the
// DC-corrected history complex64 [nch, ntaps-1, nbins], the window f32
// [ntaps, nbins] and pairs int32 [nbl, 2], return
//   xp[l, b]      = sum over frames of spec_p[b] * conj(spec_q[b]),
//                   natural bin order, no rotation, no normalisation;
//   new_hist      = the block's last ntaps-1 rows minus the block mean,
// where spec is the FFT of the FIR over [history; x - mean].
//
// What bounds it on the H100: per block the kernel reads the input twice
// (mean pre-pass, then the frames; 2 x 4 MiB at the flagship 2-channel,
// 2^18-sample block) and does ~5 n log2 n flops per frame and channel, far
// below both roofs at these sizes, so launch latency and the serial
// shared-memory FFT stages (one __syncthreads per radix-2 stage) bound it.
// The design keeps what the TPU kernel keeps out of device memory: the
// spectra live only in shared memory (nch x nbins x 8 B, 64 KiB at the
// flagship shape, so the dynamic shared-memory limit is raised), and only
// the [n_groups, nbl, nbins] partial cross power reaches device memory.
// Every sum runs in a fixed order (a two-stage mean reduction in double,
// a fixed-order sum of the partials), so a run is bit-for-bit repeatable;
// there are no atomics.  The mean pre-pass costs the second read of the
// input; the post-hoc DC algebra of the TPU kernel (_dc_constants /
// _dc_correct) removes it and is a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmulconj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// (a) Stage 1 of the channel means: grid (parts, nch).  Block `part`
// sums one contiguous chunk of channel c's S*nbins samples in double and
// tree-reduces it in shared memory, in a fixed order.
__global__ void __launch_bounds__(kThreads)
mean_partial_kernel(const float2* __restrict__ x, double2* __restrict__ sums,
                    long long n_per_chan) {
  __shared__ double red_re[kThreads];
  __shared__ double red_im[kThreads];
  const int c = blockIdx.y;
  const int parts = gridDim.x;
  const long long chunk = (n_per_chan + parts - 1) / parts;
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(lo + chunk, n_per_chan);
  const float2* xc = x + c * n_per_chan;
  double sr = 0.0, si = 0.0;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float2 v = xc[i];
    sr += v.x;
    si += v.y;
  }
  red_re[threadIdx.x] = sr;
  red_im[threadIdx.x] = si;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red_re[threadIdx.x] += red_re[threadIdx.x + s];
      red_im[threadIdx.x] += red_im[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sums[c * parts + blockIdx.x] = make_double2(red_re[0], red_im[0]);
  }
}

// Stage 2 of the channel means, in the same fixed order wherever it runs.
__device__ float2 channel_mean(const double2* __restrict__ sums, int c,
                               int parts, long long n_per_chan) {
  double r = 0.0, i = 0.0;
  for (int k = 0; k < parts; ++k) {
    const double2 v = sums[c * parts + k];
    r += v.x;
    i += v.y;
  }
  return make_float2(static_cast<float>(r / n_per_chan),
                     static_cast<float>(i / n_per_chan));
}

// (b) One CTA per group of frames.  Dynamic shared memory:
//   spec  [nch][nbins]  float2 — the frame's spectra of every channel
//   work  [nbins]       float2 — the FFT's ping-pong buffer
//   mean  [nch]         float2
// For each frame and channel: FIR over ntaps rows of [history; x - mean]
// into the FFT's first buffer, a radix-2 Stockham FFT (log2 nbins stages,
// ping-ponging between work and spec[c] and ending in spec[c]), then the
// cross power of every pair, summed over the group's frames into its own
// slice of `partial` (each element owned by one thread: no atomics).
__global__ void __launch_bounds__(kThreads)
fx_frames_kernel(const float2* __restrict__ x, const float2* __restrict__ hist,
                 const float* __restrict__ w, const float2* __restrict__ tw,
                 const int* __restrict__ pairs,
                 const double2* __restrict__ sums,
                 float2* __restrict__ partial, int nch, int S, int nbins,
                 int log2n, int ntaps, int nbl, int frames_per_group,
                 int parts) {
  extern __shared__ float2 smem[];
  float2* spec = smem;
  float2* work = smem + static_cast<size_t>(nch) * nbins;
  float2* mean_s = work + nbins;
  const int tid = threadIdx.x;
  const int halo = ntaps - 1;
  const int half = nbins >> 1;
  const long long n_per_chan = static_cast<long long>(S) * nbins;

  for (int c = tid; c < nch; c += kThreads) {
    mean_s[c] = channel_mean(sums, c, parts, n_per_chan);
  }
  __syncthreads();

  const int f0 = blockIdx.x * frames_per_group;
  const int f1 = min(f0 + frames_per_group, S);
  float2* out = partial + static_cast<size_t>(blockIdx.x) * nbl * nbins;

  for (int f = f0; f < f1; ++f) {
    for (int c = 0; c < nch; ++c) {
      float2* own = spec + static_cast<size_t>(c) * nbins;
      // an odd stage count starts in `work` so the result ends in `own`
      float2* a = (log2n & 1) ? work : own;
      float2* b = (log2n & 1) ? own : work;
      const float2 mu = mean_s[c];
      for (int bin = tid; bin < nbins; bin += kThreads) {
        float2 acc = make_float2(0.f, 0.f);
        for (int t = 0; t < ntaps; ++t) {
          const int e = f + t;  // row of [history; x]
          float2 v;
          if (e < halo) {
            v = hist[(static_cast<size_t>(c) * halo + e) * nbins + bin];
          } else {
            v = csub(x[(static_cast<size_t>(c) * S + (e - halo)) * nbins + bin],
                     mu);
          }
          const float wt = w[t * nbins + bin];
          acc.x += wt * v.x;
          acc.y += wt * v.y;
        }
        a[bin] = acc;
      }
      __syncthreads();
      for (int s = 0, ns = 1; s < log2n; ++s, ns <<= 1) {
        const int tshift = log2n - 1 - s;  // twiddle stride nbins / (2 ns)
        for (int j = tid; j < half; j += kThreads) {
          const int k = j & (ns - 1);
          const float2 v0 = a[j];
          const float2 v1 = cmul(a[j + half], tw[k << tshift]);
          const int d = ((j - k) << 1) + k;
          b[d] = cadd(v0, v1);
          b[d + ns] = csub(v0, v1);
        }
        __syncthreads();
        float2* tmp = a;
        a = b;
        b = tmp;
      }
    }
    for (int idx = tid; idx < nbl * nbins; idx += kThreads) {
      const int l = idx >> log2n;
      const int bin = idx & (nbins - 1);
      const int p = pairs[2 * l];
      const int q = pairs[2 * l + 1];
      const float2 v = cmulconj(spec[static_cast<size_t>(p) * nbins + bin],
                                spec[static_cast<size_t>(q) * nbins + bin]);
      out[idx] = (f == f0) ? v : cadd(out[idx], v);
    }
    __syncthreads();  // the next frame overwrites spec
  }
}

// (c) The partials summed over groups in a fixed order, and the new
// history: rows S .. S+halo-1 of [history; x - mean].
__global__ void __launch_bounds__(kThreads)
fx_reduce_kernel(const float2* __restrict__ partial, float2* __restrict__ xp,
                 const float2* __restrict__ x, const float2* __restrict__ hist,
                 float2* __restrict__ new_hist,
                 const double2* __restrict__ sums, int n_groups, int nbl,
                 int nch, int S, int nbins, int halo, int parts) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_xp = static_cast<long long>(nbl) * nbins;
  if (idx < n_xp) {
    float2 acc = partial[idx];
    for (int g = 1; g < n_groups; ++g) {
      acc = cadd(acc, partial[g * n_xp + idx]);
    }
    xp[idx] = acc;
  }
  if (idx < static_cast<long long>(nch) * halo * nbins) {
    const int bin = static_cast<int>(idx % nbins);
    const int r = static_cast<int>((idx / nbins) % halo);
    const int c = static_cast<int>(idx / (static_cast<long long>(nbins) * halo));
    const int e = S + r;
    if (e < halo) {
      new_hist[idx] = hist[(static_cast<size_t>(c) * halo + e) * nbins + bin];
    } else {
      const float2 mu =
          channel_mean(sums, c, parts, static_cast<long long>(S) * nbins);
      new_hist[idx] =
          csub(x[(static_cast<size_t>(c) * S + (e - halo)) * nbins + bin], mu);
    }
  }
}

}  // namespace

// Launch the three kernels on `stream`.  The caller (fx_fused.py) has
// checked shapes, types, contiguity and that nbins is a power of two in
// [256, 8192] with ntaps >= 2.  Scratch: sums [nch, parts] double2,
// partial [n_groups, nbl, nbins] float2.  Returns cudaGetLastError().
extern "C" int fxt_fx_fused(const void* x, const void* hist, const void* w,
                            const void* tw, const void* pairs, void* sums,
                            void* partial, void* xp, void* new_hist, int nch,
                            int S, int nbins, int ntaps, int nbl, int n_groups,
                            int frames_per_group, int parts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int log2n = 0;
  while ((1 << log2n) < nbins) ++log2n;
  const int halo = ntaps - 1;
  const size_t smem = (static_cast<size_t>(nch + 1) * nbins + nch) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      fx_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const auto* xf = static_cast<const float2*>(x);
  const auto* hf = static_cast<const float2*>(hist);
  auto* sd = static_cast<double2*>(sums);
  mean_partial_kernel<<<dim3(parts, nch), kThreads, 0, st>>>(
      xf, sd, static_cast<long long>(S) * nbins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  fx_frames_kernel<<<n_groups, kThreads, smem, st>>>(
      xf, hf, static_cast<const float*>(w), static_cast<const float2*>(tw),
      static_cast<const int*>(pairs), sd, static_cast<float2*>(partial), nch,
      S, nbins, log2n, ntaps, nbl, frames_per_group, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n_out = static_cast<long long>(nbl) * nbins;
  const long long n_hist = static_cast<long long>(nch) * halo * nbins;
  const long long n = n_out > n_hist ? n_out : n_hist;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  fx_reduce_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float2*>(partial), static_cast<float2*>(xp), xf, hf,
      static_cast<float2*>(new_hist), sd, n_groups, nbl, nch, S, nbins, halo,
      parts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
