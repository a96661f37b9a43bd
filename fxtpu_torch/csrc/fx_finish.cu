// The epilogue of the single-pass FX step: from the raw parts of K blocks
// (fxt_fx_parts in fx_fused.cu, or the X kernel of fx_xstage.cu) to the
// visibilities, in one launch.  Built by fxtpu_torch/cuda_build.py, called
// through fxtpu_torch/ops/fx_epilogue.py: fx_finish alone (fxt_fx_finish),
// and fx_fused_step, whose one C call (fxt_fx_step in fx_step.cu) launches
// it as the third kernel of the step.
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
// no fast-math flag, no __sincosf.
//
// What bounds it on the H100: latency, not bytes.  A flagship step's
// epilogue moves some 300 KB (0.09 us at 3.35 TB/s), but each thread's
// work was a chain of dependent loads and a sine: pairs -> p, q -> mu[p],
// mu[q]; delays -> phase -> sincosf; only then the parts and the window's
// tables.  Design: in a step (fxt_fx_step) the kernel is launched as a
// programmatic dependent of the reduce or X kernel, so it may be resident
// while that kernel runs.  Everything that does not depend on this step's
// parts comes before griddepcontrol.wait (wait_for_predecessor): the pair,
// the delays, the carried mu_prev, which the step before wrote, and, one
// bin a thread, the frequency, the phase and its sine and cosine and the
// window's tables at the bin.  After the wait, one round of independent
// loads (mu of the block and of the block before, xp, T and GJ of both
// channels), then the products in the order and rounding they always had.
// CONTINUUM keeps one CTA a (block, baseline) row, each thread summing its
// bins in bin order and then a fixed tree: its loop takes 4 bins' loads
// and sines at a time (unrolled), their sums still in bin order.  The
// outputs are bit-equal to those of the kernel before this design, which
// did all of it after loading the parts (scripts/torch_ab_trees.py --cases
// step_*; a rotation staged in shared memory before the wait, or the loop
// not unrolled, changed the compiler's contractions there).

#include <cuda_runtime.h>

#include "fx_common.cuh"   // cadd, csub, wait_for_predecessor, launch_kernel

namespace {

constexpr int kThreads = 256;
constexpr float kTwoPi = 6.283185307179586f;

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

// exp(+j phase) of bin b for the pair's delay difference dd (and carrier
// fraction difference dfrac of packed delays), as (cos, sin).
__device__ __forceinline__ float2 rotation(const FinishArgs& a, int b,
                                           float dd, float dfrac) {
  const float f = __ldg(a.freqs + b);
  const float phase =
      a.packed ? __fmul_rn(kTwoPi, __fadd_rn(__fmul_rn(f, dd), dfrac))
               : __fmul_rn(__fmul_rn(kTwoPi, f), dd);
  float sn, cs;
  sincosf(phase, &sn, &cs);
  return make_float2(cs, sn);
}

// The window's tables at bin b.
struct BinTables {
  float2 abar;
  float cs;
  float2 cab;
  float cbb;
};

__device__ __forceinline__ BinTables bin_tables(const FinishArgs& a, int b) {
  return {__ldg(a.abar + b), __ldg(a.cs + b), __ldg(a.cab + b),
          __ldg(a.cbb + b)};
}

// Block k's parts at pair l = (p, q), bin b: xp, T_p, T_q, GJ_p, GJ_q.
// Written by the kernel before this one in a step: plain loads, issued
// together after the wait.
struct BinParts {
  float2 xp, t_p, t_q, gj_p, gj_q;
};

__device__ __forceinline__ BinParts bin_parts(const FinishArgs& a, int k,
                                              int l, int p, int q, int b) {
  const float2* t = a.t + k * a.t_stride + b;
  const float2* gj = a.gj + k * a.gj_stride + b;
  const size_t po = static_cast<size_t>(p) * a.nbins;
  const size_t qo = static_cast<size_t>(q) * a.nbins;
  return {a.xp[k * a.xp_stride + static_cast<size_t>(l) * a.nbins + b],
          t[po], t[qo], gj[po], gj[qo]};
}

// The finished value of one bin: the correction of the raw parts v for
// the means mu and mv (the contract above), the rotation rot and
// 1/n_frames, every product and sum in this order.
__device__ __forceinline__ float2 finished(const BinTables& w,
                                           const BinParts& v, float2 rot,
                                           float2 mu_p, float2 mu_q,
                                           float2 mv_p, float2 mv_q,
                                           float n_frames) {
  const float2 abar_c = cconj(w.abar);
  const float2 ta_p = cmul(v.t_p, abar_c);
  const float2 ta_q = cmul(v.t_q, abar_c);
  const float2 g_p = cadd(ta_p, v.gj_p);
  const float2 g_q = cadd(ta_q, v.gj_q);
  float2 c = v.xp;
  c = csub(c, cmul(g_p, cconj(mu_q)));
  c = csub(c, cconj(cmul(g_q, cconj(mu_p))));
  c = cadd(c, cscale(cmul(mu_p, cconj(mu_q)), w.cs));
  const float2 h_p = csub(ta_p, g_p);
  const float2 h_q = csub(ta_q, g_q);
  c = csub(c, cmul(h_p, cconj(mv_q)));
  c = csub(c, cconj(cmul(h_q, cconj(mv_p))));
  c = cadd(c, cmul(cmul(mu_p, cconj(mv_q)), w.cab));
  c = cadd(c, cmul(cmul(mv_p, cconj(mu_q)), cconj(w.cab)));
  c = cadd(c, cscale(cmul(mv_p, cconj(mv_q)), w.cbb));
  const float2 r = cmul(c, rot);
  return make_float2(r.x / n_frames, r.y / n_frames);
}

// grid (chunks of bins, K * nbl), one bin a thread; with `continuum` one
// chunk: the CTA walks all bins, each thread summing its own in bin order,
// then a tree over the threads in a fixed order.
__global__ void __launch_bounds__(kThreads)
fx_finish_kernel(FinishArgs a, float2* __restrict__ vis, int continuum) {
  __shared__ float2 red[kThreads];
  const int k = blockIdx.y / a.nbl;
  const int l = blockIdx.y % a.nbl;
  const int p = __ldg(a.pairs + 2 * l);
  const int q = __ldg(a.pairs + 2 * l + 1);
  const float2 zero = make_float2(0.f, 0.f);
  float2 mv_p = zero, mv_q = zero;
  if (k == 0 && a.mu_prev != nullptr) {   // written by the step before
    mv_p = a.mu_prev[p];
    mv_q = a.mu_prev[q];
  }
  const int w = a.packed ? 2 : 1;
  const float* d = a.delays + static_cast<size_t>(k) * a.nch * w;
  const float dd = __fsub_rn(d[p * w], d[q * w]);
  const float dfrac = a.packed ? __fsub_rn(d[p * w + 1], d[q * w + 1]) : 0.f;
  const float2* mu = a.mu + static_cast<size_t>(k) * a.nch;
  const int half = a.nbins >> 1;
  if (!continuum) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    const bool in = b < a.nbins;
    float2 r = zero;
    BinTables tab{};
    if (in) {
      r = rotation(a, b, dd, dfrac);
      tab = bin_tables(a, b);
    }
    wait_for_predecessor();
    if (!in) return;
    const float2 mu_p = mu[p], mu_q = mu[q];
    if (k > 0) {
      mv_p = mu[p - a.nch];
      mv_q = mu[q - a.nch];
    }
    const BinParts v = bin_parts(a, k, l, p, q, b);
    vis[static_cast<size_t>(blockIdx.y) * a.nbins + ((b + half) % a.nbins)] =
        finished(tab, v, r, mu_p, mu_q, mv_p, mv_q, a.n_frames);
    return;
  }
  wait_for_predecessor();
  const float2 mu_p = mu[p], mu_q = mu[q];
  if (k > 0) {
    mv_p = mu[p - a.nch];
    mv_q = mu[q - a.nch];
  }
  float2 acc = zero;
#pragma unroll 4
  for (int b = threadIdx.x; b < a.nbins; b += kThreads) {
    acc = cadd(acc, finished(bin_tables(a, b), bin_parts(a, k, l, p, q, b),
                             rotation(a, b, dd, dfrac), mu_p, mu_q, mv_p,
                             mv_q, a.n_frames));
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

namespace fxt {

int finish(const void* xp, const void* t, const void* gj, const void* mu,
           const void* mu_prev, const void* pairs, const void* abar,
           const void* cs, const void* cab, const void* cbb,
           const void* delays, const void* freqs, void* vis,
           long long xp_stride, long long t_stride, long long gj_stride,
           int K, int nbl, int nch, int nbins, int packed, int continuum,
           int n_frames, double bandwidth, bool dependent, cudaStream_t st) {
  if (K < 1 || nbl < 1 || nbins < 1
      || static_cast<long long>(K) * nbl > 65535) {
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
  return static_cast<int>(launch_kernel(&fx_finish_kernel,
                                        dim3(chunks, K * nbl),
                                        dim3(kThreads), 0, st, dependent, a,
                                        static_cast<float2*>(vis),
                                        continuum));
}

}  // namespace fxt

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
  return fxt::finish(xp, t, gj, mu, mu_prev, pairs, abar, cs, cab, cbb,
                     delays, freqs, vis, xp_stride, t_stride, gj_stride, K,
                     nbl, nch, nbins, packed, continuum, n_frames, bandwidth,
                     false, static_cast<cudaStream_t>(stream));
}
