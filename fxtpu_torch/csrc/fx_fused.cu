// The fused FX step for one block: DC removal, PFB FIR with carried tap
// history, an nbins-point FFT in shared memory, and the frame-summed cross
// power of every baseline.  Built by fxtpu_torch/cuda_build.py, called
// through fxtpu_torch/ops/fx_fused.py (fx_fused_raw, fx_fused_raw_i8).
//
// Replaces: fxtpu/ops/pfb_pallas.py _fx_kernel (launched by _fx_call,
// wrapped by fx_pallas_parts / fx_pallas_raw_multi / fx_pallas_raw), for
// any list of baseline pairs, autos included, in two of its modes:
//   * f32 direct-tap mode      -> fxt_fx_fused     (complex64 samples);
//   * int8-native mode         -> fxt_fx_fused_i8  (8-bit samples).
// The two share the frame kernel (FIR, Stockham FFT, X loop), templated on
// a sample loader, and differ only in how a row sample is read and which
// mean it loses.
//
// Contract of fxt_fx_fused (fx_pallas_raw): given x complex64
// [nch, S, nbins], the DC-corrected history complex64 [nch, ntaps-1,
// nbins], the window f32 [ntaps, nbins] and pairs int32 [nbl, 2], return
//   xp[l, b]      = sum over frames of spec_p[b] * conj(spec_q[b]),
//                   natural bin order, no rotation, no normalisation;
//   new_hist      = the block's last ntaps-1 rows minus the block mean,
// where spec is the FFT of the FIR over [history; x - mean].
//
// Contract of fxt_fx_fused_i8 (fx_pallas_raw, int8-native): x int8
// [nch, S, nbins, 2] (I/Q interleaved, the ring's bytes), the previous
// block's raw tail int8 [nch, ntaps-1, nbins, 2] and its mean mu_prev
// complex64 [nch] in real units, window, pairs and quant_step; return xp
// as above over [tail*step - mu_prev; x*step - mu] and mu, this block's
// mean in real units.  The new history (x's last ntaps-1 rows and mu) is a
// slice the caller takes: this kernel writes no history.  fxtpu folds the
// step into the window and corrects both means after the kernel
// (_dc_correct(mu_prev=...)); here each sample is dequantized and loses
// its own block's mean before the FIR, the same function in exact
// arithmetic, with every subtraction in real units.
//
// What bounds it on the H100: per block the kernel reads the input twice
// (mean pre-pass, then the frames; 2 x 4 MiB at the flagship 2-channel,
// 2^18-sample block in complex64, 2 x 1 MiB in int8) and does ~5 n log2 n
// flops per frame and channel, far below both roofs at these sizes, so
// launch latency and the serial shared-memory FFT stages (one
// __syncthreads per radix-2 stage) bound it.  The design keeps what the
// TPU kernel keeps out of device memory: the spectra live only in shared
// memory (nch x nbins x 8 B, 64 KiB at the flagship shape, so the dynamic
// shared-memory limit is raised), and only the [n_groups, nbl, nbins]
// partial cross power reaches device memory.  Every sum runs in a fixed
// order (a two-stage mean reduction, in double for complex64 samples and
// in exact 64-bit integers for int8 ones, and a fixed-order sum of the
// partials), so a run is bit-for-bit repeatable; there are no atomics.
// The mean pre-pass costs the second read of the input; the post-hoc DC
// algebra of the TPU kernel (_dc_constants / _dc_correct) removes it and
// is a later change.  The TPU's 4-bins-per-int32 packing of int8 planes
// answered its element-bound DMA; loads here are byte-addressed, so the
// int8 kernel reads the interleaved (I, Q) bytes as they arrived.

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

// (a) Stage 1 of the channel means: grid (parts, nch).  Block `part`
// sums one contiguous chunk of channel c's S*nbins samples and
// tree-reduces it in shared memory, in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mean_partial_kernel(const T* __restrict__ x,
                    typename SumOf<T>::pair* __restrict__ sums,
                    long long n_per_chan) {
  using A = typename SumOf<T>::type;
  __shared__ A red_re[kThreads];
  __shared__ A red_im[kThreads];
  const int c = blockIdx.y;
  const int parts = gridDim.x;
  const long long chunk = (n_per_chan + parts - 1) / parts;
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(lo + chunk, n_per_chan);
  const T* xc = x + c * n_per_chan;
  A sr = 0, si = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const T v = xc[i];
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
    sums[c * parts + blockIdx.x] =
        typename SumOf<T>::pair{red_re[0], red_im[0]};
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

// The int8 mean in real units: an exact integer sum, formed in double and
// rounded once (fx_fused.block_mean_i8 forms it the same way).
__device__ float2 channel_mean_i8(const longlong2* __restrict__ sums, int c,
                                  int parts, long long n_per_chan,
                                  double step) {
  long long r = 0, i = 0;
  for (int k = 0; k < parts; ++k) {
    const longlong2 v = sums[c * parts + k];
    r += v.x;
    i += v.y;
  }
  const double n = static_cast<double>(n_per_chan);
  return make_float2(static_cast<float>(static_cast<double>(r) / n * step),
                     static_cast<float>(static_cast<double>(i) / n * step));
}

// Sample loaders of the frame kernel.  at(c, e, bin, mu) is row e of
// [history; x] at one bin, DC-corrected: complex64 history rows arrive
// corrected and block rows lose the block mean mu; int8 rows are
// dequantized (I and Q times the step) and lose mu_prev (tail rows) or mu
// (block rows), rounded as the plain version rounds them.
struct F32Rows {
  const float2* x;
  const float2* hist;
  const double2* sums;
  int S, halo, nbins;

  __device__ float2 mean(int c, int parts) const {
    return channel_mean(sums, c, parts, static_cast<long long>(S) * nbins);
  }
  __device__ float2 at(int c, int e, int bin, float2 mu) const {
    if (e < halo) {
      return hist[(static_cast<size_t>(c) * halo + e) * nbins + bin];
    }
    return csub(x[(static_cast<size_t>(c) * S + (e - halo)) * nbins + bin],
                mu);
  }
};

struct I8Rows {
  const char2* x;
  const char2* tail;
  const float2* mu_prev;
  const longlong2* sums;
  int S, halo, nbins;
  float step;
  double step_d;

  __device__ float2 mean(int c, int parts) const {
    return channel_mean_i8(sums, c, parts,
                           static_cast<long long>(S) * nbins, step_d);
  }
  __device__ float2 at(int c, int e, int bin, float2 mu) const {
    char2 q;
    float2 m;
    if (e < halo) {
      q = tail[(static_cast<size_t>(c) * halo + e) * nbins + bin];
      m = mu_prev[c];
    } else {
      q = x[(static_cast<size_t>(c) * S + (e - halo)) * nbins + bin];
      m = mu;
    }
    // no fused multiply-add: the same two roundings as q*step - m in torch
    return make_float2(
        __fsub_rn(__fmul_rn(static_cast<float>(q.x), step), m.x),
        __fsub_rn(__fmul_rn(static_cast<float>(q.y), step), m.y));
  }
};

// (b) One CTA per group of frames.  Dynamic shared memory:
//   spec  [nch][nbins]  float2 — the frame's spectra of every channel
//   work  [nbins]       float2 — the FFT's ping-pong buffer
//   mean  [nch]         float2
// For each frame and channel: FIR over ntaps rows of [history; x] (read
// through `rows`) into the FFT's first buffer, a radix-2 Stockham FFT
// (log2 nbins stages, ping-ponging between work and spec[c] and ending in
// spec[c]), then the cross power of every pair, summed over the group's
// frames into its own slice of `partial` (each element owned by one
// thread: no atomics).
template <class Rows>
__global__ void __launch_bounds__(kThreads)
fx_frames_kernel(Rows rows, const float* __restrict__ w,
                 const float2* __restrict__ tw,
                 const int* __restrict__ pairs,
                 float2* __restrict__ partial, int nch, int S, int nbins,
                 int log2n, int ntaps, int nbl, int frames_per_group,
                 int parts) {
  extern __shared__ float2 smem[];
  float2* spec = smem;
  float2* work = smem + static_cast<size_t>(nch) * nbins;
  float2* mean_s = work + nbins;
  const int tid = threadIdx.x;
  const int half = nbins >> 1;

  for (int c = tid; c < nch; c += kThreads) {
    mean_s[c] = rows.mean(c, parts);
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
          const float2 v = rows.at(c, f + t, bin, mu);  // row of [hist; x]
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

// The partials of element idx summed over groups in a fixed order.
__device__ __forceinline__ void sum_partials(const float2* __restrict__ partial,
                                             float2* __restrict__ xp,
                                             long long idx, int n_groups,
                                             long long n_xp) {
  float2 acc = partial[idx];
  for (int g = 1; g < n_groups; ++g) {
    acc = cadd(acc, partial[g * n_xp + idx]);
  }
  xp[idx] = acc;
}

// (c) f32: the partials summed, and the new history: rows S .. S+halo-1
// of [history; x - mean].
__global__ void __launch_bounds__(kThreads)
fx_reduce_kernel(const float2* __restrict__ partial, float2* __restrict__ xp,
                 F32Rows rows, float2* __restrict__ new_hist, int n_groups,
                 int nbl, int nch, int parts) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_xp = static_cast<long long>(nbl) * rows.nbins;
  if (idx < n_xp) sum_partials(partial, xp, idx, n_groups, n_xp);
  const int halo = rows.halo, nbins = rows.nbins;
  if (idx < static_cast<long long>(nch) * halo * nbins) {
    const int bin = static_cast<int>(idx % nbins);
    const int r = static_cast<int>((idx / nbins) % halo);
    const int c = static_cast<int>(idx / (static_cast<long long>(nbins) * halo));
    const int e = rows.S + r;
    const float2 mu = e < halo ? make_float2(0.f, 0.f) : rows.mean(c, parts);
    new_hist[idx] = rows.at(c, e, bin, mu);
  }
}

// (c) int8: the partials summed, and this block's mean in real units.
__global__ void __launch_bounds__(kThreads)
fx_reduce_i8_kernel(const float2* __restrict__ partial,
                    float2* __restrict__ xp, I8Rows rows,
                    float2* __restrict__ mu, int n_groups, int nbl, int nch,
                    int parts) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_xp = static_cast<long long>(nbl) * rows.nbins;
  if (idx < n_xp) sum_partials(partial, xp, idx, n_groups, n_xp);
  if (idx < nch) mu[idx] = rows.mean(static_cast<int>(idx), parts);
}

int log2_of(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// Mean pre-pass and frame kernel of either mode, on `st`.
template <typename T, class Rows>
cudaError_t launch_means_and_frames(const T* x, typename SumOf<T>::pair* sums,
                                    const Rows& rows, const void* w,
                                    const void* tw, const void* pairs,
                                    void* partial, int nch, int S, int nbins,
                                    int ntaps, int nbl, int n_groups,
                                    int frames_per_group, int parts,
                                    cudaStream_t st) {
  const size_t smem =
      (static_cast<size_t>(nch + 1) * nbins + nch) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&fx_frames_kernel<Rows>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mean_partial_kernel<T><<<dim3(parts, nch), kThreads, 0, st>>>(
      x, sums, static_cast<long long>(S) * nbins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fx_frames_kernel<Rows><<<n_groups, kThreads, smem, st>>>(
      rows, static_cast<const float*>(w), static_cast<const float2*>(tw),
      static_cast<const int*>(pairs), static_cast<float2*>(partial), nch, S,
      nbins, log2_of(nbins), ntaps, nbl, frames_per_group, parts);
  return cudaGetLastError();
}

int reduce_blocks(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Launch the three kernels of the complex64 mode on `stream`.  The caller
// (fx_fused.py) has checked shapes, types, contiguity and that nbins is a
// power of two in [256, 8192] with ntaps >= 2.  Scratch: sums [nch, parts]
// double2, partial [n_groups, nbl, nbins] float2.  Returns
// cudaGetLastError().
extern "C" int fxt_fx_fused(const void* x, const void* hist, const void* w,
                            const void* tw, const void* pairs, void* sums,
                            void* partial, void* xp, void* new_hist, int nch,
                            int S, int nbins, int ntaps, int nbl, int n_groups,
                            int frames_per_group, int parts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int halo = ntaps - 1;
  auto* sd = static_cast<double2*>(sums);
  const F32Rows rows{static_cast<const float2*>(x),
                     static_cast<const float2*>(hist), sd, S, halo, nbins};
  cudaError_t err = launch_means_and_frames(
      static_cast<const float2*>(x), sd, rows, w, tw, pairs, partial, nch, S,
      nbins, ntaps, nbl, n_groups, frames_per_group, parts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_out = static_cast<long long>(nbl) * nbins;
  const long long n_hist = static_cast<long long>(nch) * halo * nbins;
  fx_reduce_kernel<<<reduce_blocks(n_out > n_hist ? n_out : n_hist), kThreads,
                     0, st>>>(static_cast<const float2*>(partial),
                              static_cast<float2*>(xp), rows,
                              static_cast<float2*>(new_hist), n_groups, nbl,
                              nch, parts);
  return static_cast<int>(cudaGetLastError());
}

// Launch the three kernels of the int8 mode on `stream`.  The caller
// (fx_fused.py) has checked what it checks for fxt_fx_fused, plus S >=
// ntaps-1 and that x and tail start on an (I, Q) pair.  Scratch: sums
// [nch, parts] longlong2, partial [n_groups, nbl, nbins] float2.  Writes
// xp [nbl, nbins] and mu [nch] (complex64).  Returns cudaGetLastError().
extern "C" int fxt_fx_fused_i8(const void* x, const void* tail,
                               const void* mu_prev, const void* w,
                               const void* tw, const void* pairs, void* sums,
                               void* partial, void* xp, void* mu, int nch,
                               int S, int nbins, int ntaps, int nbl,
                               int n_groups, int frames_per_group, int parts,
                               double step, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* sl = static_cast<longlong2*>(sums);
  const I8Rows rows{static_cast<const char2*>(x),
                    static_cast<const char2*>(tail),
                    static_cast<const float2*>(mu_prev),
                    sl,
                    S,
                    ntaps - 1,
                    nbins,
                    static_cast<float>(step),
                    step};
  cudaError_t err = launch_means_and_frames(
      static_cast<const char2*>(x), sl, rows, w, tw, pairs, partial, nch, S,
      nbins, ntaps, nbl, n_groups, frames_per_group, parts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_out = static_cast<long long>(nbl) * nbins;
  fx_reduce_i8_kernel<<<reduce_blocks(n_out > nch ? n_out : nch), kThreads, 0,
                        st>>>(static_cast<const float2*>(partial),
                              static_cast<float2*>(xp), rows,
                              static_cast<float2*>(mu), n_groups, nbl, nch,
                              parts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
