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
//
// Many pairs (MeerKAT's 8,256 a block) make another bound: bytes (xp read,
// vis written, 8 bytes each a pair and bin), which the one-bin-a-thread
// instance reached a quarter of, since each thread walked the whole
// dependent chain for one value and formed again what depends on the pair
// alone (the means' products, the delay difference) or on the channel
// alone (G and H, nbl / nch times each).  The pair-tiled instance
// (fx_finish_kernel_tiled, picked by shape in fx_epilogue.finish_plan)
// forms G and H once per (block, channel, bin) into shared memory and
// sweeps many pairs at one tile of bins, the pair's values once for two
// bins, the loads of several pairs made before their arithmetic.  Both
// instances form G and H, the correction and the phase alike
// (channel_gh, corrected, rotation_at).
//
// Past 433 channels (LEDA's 512: 131,328 pairs) the pair-tiled CTA's G and
// H of every channel at 32 bins pass a CTA's 227 KiB.  Its narrow instance,
// fx_finish_kernel_narrow, is the same sweep at 16 bins a tile (280 bytes
// a channel: up to 830 channels), 512 threads a CTA, a quarter-warp a
// pair; the launcher takes it by shape.  The one-bin-a-thread grid holds
// its K nbl rows on its second axis, 65,535 of them: past that (CONTINUUM
// from 362 channels with autos) the launch is refused.

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

// exp(+j phase) at the frequency f for the pair's delay difference dd
// (and carrier fraction difference dfrac of packed delays), as (cos, sin).
__device__ __forceinline__ float2 rotation_at(float f, float dd, float dfrac,
                                              int packed) {
  const float phase =
      packed ? __fmul_rn(kTwoPi, __fadd_rn(__fmul_rn(f, dd), dfrac))
             : __fmul_rn(__fmul_rn(kTwoPi, f), dd);
  float sn, cs;
  sincosf(phase, &sn, &cs);
  return make_float2(cs, sn);
}

// The same at bin b.
__device__ __forceinline__ float2 rotation(const FinishArgs& a, int b,
                                           float dd, float dfrac) {
  return rotation_at(__ldg(a.freqs + b), dd, dfrac, a.packed);
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

// G and H of one channel at one bin: ta = T conj(Abar), G = ta + GJ,
// H = ta - G.
struct ChannelGH {
  float2 g, h;
};

__device__ __forceinline__ ChannelGH channel_gh(float2 t, float2 gj,
                                                float2 abar) {
  const float2 ta = cmul(t, cconj(abar));
  const float2 g = cadd(ta, gj);
  return {g, csub(ta, g)};
}

// A pair's means, mu of block k and mv of the rows before it, and their
// four products: uniform over the pair's bins.
struct PairMeans {
  float2 mu_p, mu_q, mv_p, mv_q, uu, uv, vu, vv;
};

__device__ __forceinline__ PairMeans pair_means(float2 mu_p, float2 mu_q,
                                                float2 mv_p, float2 mv_q) {
  return {mu_p, mu_q, mv_p, mv_q, cmul(mu_p, cconj(mu_q)),
          cmul(mu_p, cconj(mv_q)), cmul(mv_p, cconj(mu_q)),
          cmul(mv_p, cconj(mv_q))};
}

// The correction of one bin's raw cross power xp for the means m (the
// contract above) from both channels' G and H and the window's tables at
// the bin, every product and sum in this order.
__device__ __forceinline__ float2 corrected(float2 xp, ChannelGH p,
                                            ChannelGH q, const PairMeans& m,
                                            float cs, float2 cab, float cbb) {
  float2 c = xp;
  c = csub(c, cmul(p.g, cconj(m.mu_q)));
  c = csub(c, cconj(cmul(q.g, cconj(m.mu_p))));
  c = cadd(c, cscale(m.uu, cs));
  c = csub(c, cmul(p.h, cconj(m.mv_q)));
  c = csub(c, cconj(cmul(q.h, cconj(m.mv_p))));
  c = cadd(c, cmul(m.uv, cab));
  c = cadd(c, cmul(m.vu, cconj(cab)));
  c = cadd(c, cscale(m.vv, cbb));
  return c;
}

// The finished value: c times the rotation rot, over n_frames.  Where
// `inv` is not 0 it is 1 / n_frames exactly (n_frames a power of two), and
// the product by it is the quotient, bit for bit, without a division.
__device__ __forceinline__ float2 rotated(float2 c, float2 rot,
                                          float n_frames, float inv) {
  const float2 r = cmul(c, rot);
  if (inv != 0.f) return make_float2(r.x * inv, r.y * inv);
  return make_float2(r.x / n_frames, r.y / n_frames);
}

// The same from the raw parts v of one bin and the pair's means (the
// one-bin-a-thread instance): G, H and the products formed here.
__device__ __forceinline__ float2 finished(const BinTables& w,
                                           const BinParts& v, float2 rot,
                                           float2 mu_p, float2 mu_q,
                                           float2 mv_p, float2 mv_q,
                                           float n_frames) {
  return rotated(corrected(v.xp, channel_gh(v.t_p, v.gj_p, w.abar),
                           channel_gh(v.t_q, v.gj_q, w.abar),
                           pair_means(mu_p, mu_q, mv_p, mv_q), w.cs, w.cab,
                           w.cbb),
                 rot, n_frames, 0.f);
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

// The pair-tiled instance (SPECTRUM only): grid (tiles of kTileBins bins,
// K, chunks of `chunk` pairs).  A CTA owns one tile of one block and sweeps
// its chunk of pairs there, kRows pairs at a time: a half-warp a pair, two
// bins a lane (lane and lane + kHalf of the tile), so each of the pair's
// uniform values (p, q, the delay difference, the four mean products) is
// formed once for two bins, and the tables at a lane's bins, loaded once,
// stay in registers over the whole sweep.  G and H depend only on (block,
// channel, bin): the CTA forms them once for every channel at its tile into
// shared memory (channel_gh, as the other instance forms them), with the
// block's means.  A half-warp loads kAhead pairs' cross power before their
// arithmetic.  Shared memory: nch (2 kTileBins + 3) float2.  The narrow
// instance: kNarrowBins a tile, kNarrowThreads threads, kHalf = kNarrowBins
// / 2 lanes a pair (a quarter-warp).
constexpr int kTileBins = 32;
constexpr int kTiledThreads = 256;
constexpr int kNarrowBins = 16;
constexpr int kNarrowThreads = 512;
constexpr int kAhead = 4;
// Shared memory a CTA may take (fx_fused.MAX_SHARED_BYTES).
constexpr size_t kMaxShared = 232448;

// The shared memory the pair-tiled sweep takes at `bins` a tile.
constexpr size_t tiled_bytes(int nch, int bins) {
  return static_cast<size_t>(nch) * (2 * bins + 3) * sizeof(float2);
}

template <int kBins, int kCtaThreads>
__device__ __forceinline__ void finish_tiled(FinishArgs a,
                                             float2* __restrict__ vis,
                                             int chunk) {
  constexpr int kHalf = kBins / 2;
  constexpr int kRows = kCtaThreads / kHalf;
  extern __shared__ float2 smem[];
  float2* g_s = smem;                   // [nch, kBins]
  float2* h_s = g_s + a.nch * kBins;    // [nch, kBins]
  float2* mu_s = h_s + a.nch * kBins;   // [nch]: mu of block k
  float2* mv_s = mu_s + a.nch;          // [nch]: the mean before it
  float2* d_s = mv_s + a.nch;           // [nch]: (delay, fraction)
  const float2 zero = make_float2(0.f, 0.f);
  const int k = blockIdx.y;
  const int tile = blockIdx.x * kBins;
  const int lane = threadIdx.x % kHalf;
  const int row = threadIdx.x / kHalf;
  const int half = a.nbins >> 1;
  const int nf = static_cast<int>(a.n_frames);
  const float inv = (nf & (nf - 1)) == 0 ? 1.f / a.n_frames : 0.f;
  // Before the wait, what no kernel of the step writes: the tables and
  // frequencies at this lane's two bins, where each lands fftshifted, the
  // window's Abar at the bin this thread stages, the block's delays.
  int bin[2], out[2];
  bool in[2];
  float f[2], cs[2], cbb[2];
  float2 cab[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    bin[j] = lane + j * kHalf;
    in[j] = tile + bin[j] < a.nbins;
    const int b = in[j] ? tile + bin[j] : 0;
    f[j] = __ldg(a.freqs + b);
    cs[j] = __ldg(a.cs + b);
    cab[j] = __ldg(a.cab + b);
    cbb[j] = __ldg(a.cbb + b);
    out[j] = b + half < a.nbins ? b + half : b + half - a.nbins;
  }
  const int sbin = threadIdx.x % kBins;
  const bool s_in = tile + sbin < a.nbins;
  const float2 abar = s_in ? __ldg(a.abar + tile + sbin) : zero;
  const int w = a.packed ? 2 : 1;
  const float* d = a.delays + static_cast<size_t>(k) * a.nch * w;
  for (int c = threadIdx.x; c < a.nch; c += kCtaThreads) {
    d_s[c] = make_float2(d[c * w], a.packed ? d[c * w + 1] : 0.f);
  }
  wait_for_predecessor();
  const float2* t = a.t + k * a.t_stride + tile + sbin;
  const float2* gj = a.gj + k * a.gj_stride + tile + sbin;
  for (int c = threadIdx.x / kBins; c < a.nch;
       c += kCtaThreads / kBins) {
    ChannelGH v{zero, zero};
    if (s_in) {
      const size_t o = static_cast<size_t>(c) * a.nbins;
      v = channel_gh(t[o], gj[o], abar);
    }
    g_s[c * kBins + sbin] = v.g;
    h_s[c * kBins + sbin] = v.h;
  }
  const float2* mu = a.mu + static_cast<size_t>(k) * a.nch;
  for (int c = threadIdx.x; c < a.nch; c += kCtaThreads) {
    mu_s[c] = mu[c];
    mv_s[c] = k > 0 ? mu[c - a.nch]
                    : (a.mu_prev != nullptr ? a.mu_prev[c] : zero);
  }
  __syncthreads();
  const int last = min(a.nbl, (blockIdx.z + 1) * chunk);
  const float2* xp = a.xp + k * a.xp_stride + tile;
  float2* vk = vis + static_cast<size_t>(k) * a.nbl * a.nbins;
  for (int l0 = blockIdx.z * chunk + row; l0 < last; l0 += kRows * kAhead) {
    int2 pq[kAhead];
    float2 x[kAhead][2];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int l = l0 + u * kRows;
      pq[u] = make_int2(0, 0);
      x[u][0] = x[u][1] = zero;
      if (l < last) {
        pq[u] = make_int2(__ldg(a.pairs + 2 * l), __ldg(a.pairs + 2 * l + 1));
        const float2* r = xp + static_cast<size_t>(l) * a.nbins;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (in[j]) x[u][j] = r[bin[j]];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int l = l0 + u * kRows;
      if (l >= last) break;
      const int p = pq[u].x, q = pq[u].y;
      const float2 dp = d_s[p], dq = d_s[q];
      const float dd = __fsub_rn(dp.x, dq.x);
      const float dfrac = a.packed ? __fsub_rn(dp.y, dq.y) : 0.f;
      const PairMeans m = pair_means(mu_s[p], mu_s[q], mv_s[p], mv_s[q]);
      float2* o = vk + static_cast<size_t>(l) * a.nbins;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!in[j]) continue;
        const ChannelGH vp{g_s[p * kBins + bin[j]],
                           h_s[p * kBins + bin[j]]};
        const ChannelGH vq{g_s[q * kBins + bin[j]],
                           h_s[q * kBins + bin[j]]};
        o[out[j]] = rotated(
            corrected(x[u][j], vp, vq, m, cs[j], cab[j], cbb[j]),
            rotation_at(f[j], dd, dfrac, a.packed), a.n_frames, inv);
      }
    }
  }
}

__global__ void __launch_bounds__(kTiledThreads, 3)
fx_finish_kernel_tiled(FinishArgs a, float2* __restrict__ vis, int chunk) {
  finish_tiled<kTileBins, kTiledThreads>(a, vis, chunk);
}

__global__ void __launch_bounds__(kNarrowThreads, 1)
fx_finish_kernel_narrow(FinishArgs a, float2* __restrict__ vis, int chunk) {
  finish_tiled<kNarrowBins, kNarrowThreads>(a, vis, chunk);
}

// A pair-tiled instance on `st` over chunks of `chunk` pairs: the 32-bin
// one where every channel's G and H fit a CTA there, else the narrow one.
cudaError_t launch_tiled(const FinishArgs& a, float2* vis, int chunk,
                         bool dependent, cudaStream_t st) {
  const bool narrow = tiled_bytes(a.nch, kTileBins) > kMaxShared;
  const int bins = narrow ? kNarrowBins : kTileBins;
  const size_t smem = tiled_bytes(a.nch, bins);
  const int chunks = (a.nbl + chunk - 1) / chunk;
  if (smem > kMaxShared || a.K > 65535 || chunks > 65535) {
    return cudaErrorInvalidValue;
  }
  auto* kernel = narrow ? &fx_finish_kernel_narrow : &fx_finish_kernel_tiled;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return launch_kernel(kernel, dim3((a.nbins + bins - 1) / bins, a.K, chunks),
                       dim3(narrow ? kNarrowThreads : kTiledThreads), smem,
                       st, dependent, a, vis, chunk);
}

}  // namespace

namespace fxt {

int finish(const void* xp, const void* t, const void* gj, const void* mu,
           const void* mu_prev, const void* pairs, const void* abar,
           const void* cs, const void* cab, const void* cbb,
           const void* delays, const void* freqs, void* vis,
           long long xp_stride, long long t_stride, long long gj_stride,
           int K, int nbl, int nch, int nbins, int packed, int continuum,
           int n_frames, int chunk, double bandwidth, bool dependent,
           cudaStream_t st) {
  if (K < 1 || nbl < 1 || nbins < 1 || n_frames < 1 || chunk < 0
      || (chunk && continuum)
      || static_cast<long long>(K) * nbl > (chunk ? 0x7fffffff : 65535)) {
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
  if (chunk > 0) {
    return static_cast<int>(launch_tiled(a, static_cast<float2*>(vis), chunk,
                                         dependent, st));
  }
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
// elements).  mu_prev may be NULL.  `chunk` picks the instance
// (fx_epilogue.finish_plan): 0 the one-bin-a-thread one (K nbl at most
// 65,535), else the pair-tiled one with
// `chunk` pairs a CTA (SPECTRUM only; 16 bins a tile where 32 bins' G and H
// of every channel do not fit a CTA).  Writes vis [K,
// nbl, nbins] complex64, or with `continuum` [K, nbl].  Returns
// cudaGetLastError().
extern "C" int fxt_fx_finish(const void* xp, const void* t, const void* gj,
                             const void* mu, const void* mu_prev,
                             const void* pairs, const void* abar,
                             const void* cs, const void* cab, const void* cbb,
                             const void* delays, const void* freqs, void* vis,
                             long long xp_stride, long long t_stride,
                             long long gj_stride, int K, int nbl, int nch,
                             int nbins, int packed, int continuum,
                             int n_frames, int chunk, double bandwidth,
                             void* stream) {
  return fxt::finish(xp, t, gj, mu, mu_prev, pairs, abar, cs, cab, cbb,
                     delays, freqs, vis, xp_stride, t_stride, gj_stride, K,
                     nbl, nch, nbins, packed, continuum, n_frames, chunk,
                     bandwidth, false, static_cast<cudaStream_t>(stream));
}
