// The epilogue of the single-pass FX step: from the raw parts of K blocks
// (fxt_fx_parts in fx_fused.cu) to the visibilities, in one launch.  Built
// by fxtpu_torch/cuda_build.py, called through
// fxtpu_torch/ops/fx_epilogue.py (fx_finish; fx_fused_step runs it after the
// parts).
//
// Replaces: what fxtpu jits into one executable with _fx_kernel, the
// post-hoc DC correction fxtpu/ops/pfb_pallas.py _dc_correct (both history
// contracts) and fxtpu/fx.py _finish_fused (the FSTC rotation, 1/n_frames,
// the fftshift and the continuum reduction), which in plain torch are some
// forty small launches (dc_posthoc.dc_correct + fx_epilogue.finish, this
// kernel's plain version).
//
// Contract, per block k, pair l = (p, q) and bin b (natural order):
//   G_c  = conj(Abar) T_c + GJ_c,  H_c = conj(Abar) T_c - G_c,
//   c    = xp - conj(mu_q) G_p - mu_p conj(G_q) + mu_p conj(mu_q) cs
//          - conj(mv_q) H_p - mv_p conj(H_q) + mu_p conj(mv_q) cab
//          + mv_p conj(mu_q) conj(cab) + mv_p conj(mv_q) cbb,
// with mv = the mean the rows before block k still carry: mu[k-1] for
// k >= 1 (a launch's later blocks read the earlier ones' rows raw), and
// for block 0 the carried mu_prev (int8's raw tail) or zero (a NULL
// pointer: the DC-corrected complex64 history);
//   vis  = c * exp(+2 pi j phase) / n_frames, phase = f_b (d_p - d_q) for
//          plain delays [K, nch] against the RF frequencies f, or f_b (d_p
//          - d_q) + (frac_p - frac_q) for packed delays [K, nch, 2] against
//          the baseband offsets (xengine.pack_delays);
// written fftshifted to vis [K, nbl, nbins], or (continuum) averaged over
// the bins and divided by the bandwidth into vis [K, nbl].
//
// Every product and sum of the phase is rounded on its own (no fused
// multiply-add), in the plain version's order, so both feed the same
// float32 phase to their sine and cosine, and those are sincosf's full
// range reduction (phases reach 1e4 rad at 1.4 GHz and microsecond delays):
// no fast-math flag, no __sincosf.  The work is a few operations per
// output element; the launch is there to be one launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

struct FinishArgs {
  const float2* xp;    // [K, nbl, nbins], block stride xp_stride
  const float2* t;     // [K, nch, nbins], block stride t_stride
  const float2* gj;    // [K, nch, nbins], block stride gj_stride
  const float2* mu;    // [K, nch]
  const float2* mu_prev;   // [nch] or NULL (zero)
  const int* pairs;    // [nbl, 2]
  const float2* abar;  // [nbins]
  const float* cs;     // [nbins]
  const float2* cab;   // [nbins]
  const float* cbb;    // [nbins]
  const float* delays;  // [K, nch] or [K, nch, 2]
  const float* freqs;  // [nbins]
  long long xp_stride, t_stride, gj_stride;
  int K, nbl, nch, nbins, packed;
  float n_frames, bandwidth;
};

// The finished value of block k, pair (p, q) at natural bin b.
__device__ float2 finished(const FinishArgs& a, int k, int l, int p, int q,
                           int b,
                           float2 mu_p, float2 mu_q, float2 mv_p,
                           float2 mv_q, float dd, float dfrac) {
  const float2 abar_c = cconj(__ldg(a.abar + b));
  const float2* t = a.t + k * a.t_stride + b;
  const float2* gj = a.gj + k * a.gj_stride + b;
  const size_t po = static_cast<size_t>(p) * a.nbins;
  const size_t qo = static_cast<size_t>(q) * a.nbins;
  const float2 ta_p = cmul(__ldg(t + po), abar_c);
  const float2 ta_q = cmul(__ldg(t + qo), abar_c);
  const float2 g_p = cadd(ta_p, __ldg(gj + po));
  const float2 g_q = cadd(ta_q, __ldg(gj + qo));
  float2 c = a.xp[k * a.xp_stride + static_cast<size_t>(l) * a.nbins + b];
  c = csub(c, cmul(g_p, cconj(mu_q)));
  c = csub(c, cconj(cmul(g_q, cconj(mu_p))));
  c = cadd(c, cscale(cmul(mu_p, cconj(mu_q)), __ldg(a.cs + b)));
  const float2 h_p = csub(ta_p, g_p);
  const float2 h_q = csub(ta_q, g_q);
  const float2 cab = __ldg(a.cab + b);
  c = csub(c, cmul(h_p, cconj(mv_q)));
  c = csub(c, cconj(cmul(h_q, cconj(mv_p))));
  c = cadd(c, cmul(cmul(mu_p, cconj(mv_q)), cab));
  c = cadd(c, cmul(cmul(mv_p, cconj(mu_q)), cconj(cab)));
  c = cadd(c, cscale(cmul(mv_p, cconj(mv_q)), __ldg(a.cbb + b)));
  const float f = __ldg(a.freqs + b);
  const float phase =
      a.packed ? __fmul_rn(kTwoPi, __fadd_rn(__fmul_rn(f, dd), dfrac))
               : __fmul_rn(__fmul_rn(kTwoPi, f), dd);
  float sn, cs;
  sincosf(phase, &sn, &cs);
  const float2 v = cmul(c, make_float2(cs, sn));
  return make_float2(v.x / a.n_frames, v.y / a.n_frames);
}

// grid (chunks of bins, K * nbl); with `continuum` one chunk: the CTA
// walks all bins, each thread summing its own in bin order, then a tree
// over the threads in a fixed order.
__global__ void __launch_bounds__(kThreads)
fx_finish_kernel(FinishArgs a, float2* __restrict__ vis, int continuum) {
  __shared__ float2 red[kThreads];
  const int k = blockIdx.y / a.nbl;
  const int l = blockIdx.y % a.nbl;
  const int p = __ldg(a.pairs + 2 * l);
  const int q = __ldg(a.pairs + 2 * l + 1);
  const float2 zero = make_float2(0.f, 0.f);
  const float2* mu = a.mu + static_cast<size_t>(k) * a.nch;
  const float2 mu_p = mu[p], mu_q = mu[q];
  float2 mv_p = zero, mv_q = zero;
  if (k > 0) {
    mv_p = mu[p - a.nch];
    mv_q = mu[q - a.nch];
  } else if (a.mu_prev != nullptr) {
    mv_p = a.mu_prev[p];
    mv_q = a.mu_prev[q];
  }
  const int w = a.packed ? 2 : 1;
  const float* d = a.delays + static_cast<size_t>(k) * a.nch * w;
  const float dd = __fsub_rn(d[p * w], d[q * w]);
  const float dfrac = a.packed ? __fsub_rn(d[p * w + 1], d[q * w + 1]) : 0.f;
  const int half = a.nbins >> 1;
  if (!continuum) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b < a.nbins) {
      vis[static_cast<size_t>(blockIdx.y) * a.nbins + ((b + half) % a.nbins)] =
          finished(a, k, l, p, q, b, mu_p, mu_q, mv_p, mv_q, dd, dfrac);
    }
    return;
  }
  float2 acc = zero;
  for (int b = threadIdx.x; b < a.nbins; b += kThreads) {
    acc = cadd(acc, finished(a, k, l, p, q, b, mu_p, mu_q, mv_p, mv_q, dd,
                             dfrac));
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[threadIdx.x] = cadd(red[threadIdx.x], red[threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    vis[blockIdx.y] = make_float2(red[0].x / a.nbins / a.bandwidth,
                                  red[0].y / a.nbins / a.bandwidth);
  }
}

}  // namespace

// Launch the epilogue on `stream`.  The caller (fx_epilogue.py) has checked
// types, shapes, devices and that every [.., nbins] row is contiguous; xp,
// t and gj may be slices of one tensor (their block strides are in
// elements).  mu_prev may be NULL.  Writes vis [K, nbl, nbins] complex64,
// or with `continuum` [K, nbl].  Returns cudaGetLastError().
extern "C" int fxt_fx_finish(const void* xp, const void* t, const void* gj,
                             const void* mu, const void* mu_prev,
                             const void* pairs, const void* abar,
                             const void* cs, const void* cab, const void* cbb,
                             const void* delays, const void* freqs, void* vis,
                             long long xp_stride, long long t_stride,
                             long long gj_stride, int K, int nbl, int nch,
                             int nbins, int packed, int continuum,
                             int n_frames, double bandwidth, void* stream) {
  if (K < 1 || nbl < 1 || static_cast<long long>(K) * nbl > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FinishArgs a{static_cast<const float2*>(xp),
                     static_cast<const float2*>(t),
                     static_cast<const float2*>(gj),
                     static_cast<const float2*>(mu),
                     static_cast<const float2*>(mu_prev),
                     static_cast<const int*>(pairs),
                     static_cast<const float2*>(abar),
                     static_cast<const float*>(cs),
                     static_cast<const float2*>(cab),
                     static_cast<const float*>(cbb),
                     static_cast<const float*>(delays),
                     static_cast<const float*>(freqs),
                     xp_stride,
                     t_stride,
                     gj_stride,
                     K,
                     nbl,
                     nch,
                     nbins,
                     packed,
                     static_cast<float>(n_frames),
                     static_cast<float>(bandwidth)};
  const int chunks = continuum ? 1 : (nbins + kThreads - 1) / kThreads;
  fx_finish_kernel<<<dim3(chunks, K * nbl), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<float2*>(vis), continuum);
  return static_cast<int>(cudaGetLastError());
}
