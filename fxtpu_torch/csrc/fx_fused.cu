// The fused FX step for K blocks: DC removal, PFB FIR with carried tap
// history, an nbins-point FFT in shared memory, and the frame-summed cross
// power of every baseline; and the F-stage spectrometer, which writes the
// spectra out in place of the cross power.  Built by
// fxtpu_torch/cuda_build.py, called through fxtpu_torch/ops/fx_fused.py
// (fx_fused_raw, fx_fused_raw_i8 at K = 1; fx_fused_raw_multi,
// fx_fused_raw_i8_multi at any K; fx_fused_ablate, the same step with the
// frame kernel truncated after a stage, for timing) and
// fxtpu_torch/ops/spectrometer.py (spectrometer_fused).
//
// Replaces: fxtpu/ops/pfb_pallas.py _fx_kernel (launched by _fx_call,
// wrapped by fx_pallas_parts / fx_pallas_raw_multi / fx_pallas_raw), for
// any list of baseline pairs, autos included, in four of its modes:
//   * f32 direct-tap mode      -> fxt_fx_fused     rank 0 (complex64);
//   * f32 SVD-FIR mode         -> fxt_fx_fused     rank r > 0;
//   * int8-native mode         -> fxt_fx_fused_i8  rank 0 (8-bit samples);
//   * int8-native SVD-FIR mode -> fxt_fx_fused_i8  rank r > 0;
// each for K >= 1 blocks per launch (fx_pallas_raw_multi's grid
// (k_blocks, tiles) over the merged rows [nch, K*S, lanes]);
// and pfb_pallas.py _kernel (launched by _pfb_fft_call, wrapped by
// spectrometer_pallas) -> fxt_spectrometer; and scripts/fused_ablate.py's
// kernel (its STAGE truncation; _fx_kernel's FXTPU_FUSED_ABLATE)
// -> fxt_fx_ablate, fxt_fx_ablate_i8 (the kStage tags below).
// All share one frame kernel (FIR, Stockham FFT, output), templated on a
// sample loader (how a row sample is read and which mean it loses), a FIR
// policy (the direct tap loop over the window, or the rank-r factorisation
// w = u v) and an output policy (the X loop, or the spectra written out).
//
// Contract of fxt_fx_fused (fx_pallas_raw): given x complex64
// [nch, S, nbins], the DC-corrected history complex64 [nch, ntaps-1,
// nbins], the window f32 [ntaps, nbins] and pairs int32 [nbl, 2], return
//   xp[l, b]      = sum over frames of spec_p[b] * conj(spec_q[b]),
//                   natural bin order, no rotation, no normalisation;
//   new_hist      = the block's last ntaps-1 rows minus the block mean,
// where spec is the FFT of the FIR over [history; x - mean].  With rank
// r > 0 the FIR is sum_k v[k, b] * (sum_t u[t, k] * row[f+t, b]) for
// u f32 [ntaps, r] and v f32 [r, nbins] (u v ~= w, fx_fused.svd_tensors).
//
// Contract of fxt_fx_fused_i8 (fx_pallas_raw, int8-native): x int8
// [nch, S, nbins, 2] (I/Q interleaved, the ring's bytes), the previous
// block's raw tail int8 [nch, ntaps-1, nbins, 2] and its mean mu_prev
// complex64 [nch] in real units, window (or u, v), pairs and quant_step;
// return xp as above over [tail*step - mu_prev; x*step - mu] and mu, this
// block's mean in real units.  The new history (x's last ntaps-1 rows and
// mu) is a slice the caller takes: this kernel writes no history.  fxtpu
// folds the step into the window (or into v) and corrects both means after
// the kernel (_dc_correct(mu_prev=...)); here each sample is dequantized
// and loses its own block's mean before the FIR, the same function in
// exact arithmetic, with every subtraction in real units.
//
// K blocks per launch (fx_pallas_raw_multi(merged=True)): x is the merged
// layout [nch, K, S, nbins] (int8: [nch, K, S, nbins, 2]), the same memory
// as [nch, K*S, nbins]; xp is [K, nbl, nbins] and the int8 mu [K, nch].
// Merged row e of [history; x] is history for e < ntaps-1 (the corrected
// tail, or the raw tail losing mu_prev); any other row belongs to block
// j = (e - ntaps + 1) / S and loses block j's own mean, so block k's
// first frames read block k-1's rows corrected by block k-1's mean:
// exactly what K chained one-block launches compute, bit for bit (each
// block's mean, frame groups and sums are formed as a one-block launch
// forms them).  The new complex64 history is the last halo rows of
// [history; x] (the last block's, minus its mean); fxtpu gets the same
// function by correcting after the kernel (_dc_correct(mu_prev=...)).
//
// Contract of fxt_spectrometer (spectrometer_pallas): x complex64
// [nch, nsamp], the DC-corrected history [nch, ntaps-1, nbins] (ntaps >= 1)
// and the window; return spec [nch, S, nbins] with S = nsamp / nbins, the
// FFT of the FIR over [history; x - mean], where the mean covers all nsamp
// samples (the tail beyond S*nbins too), and new_hist, the last ntaps-1
// rows of [history; x - mean].
//
// What bounds it on the H100: the card's bound for a flagship block (2
// channels, 2^18 samples, 4096 bins, 4 taps: 4.2 MB in once, 33 KB out) is
// its bytes over 3.35 TB/s in complex64, 1.4 us, and in int8 (1.1 MB) its
// 43 MFLOP over the 67 TFLOP/s float32 peak, 0.64 us.  The frame kernel
// takes 38 to 40 us for one block and 15 us a block at K = 8: the bound is
// 2 to 9% of that.  The stage ablation (fxt_fx_ablate; `python -m
// fxtpu_torch.probes ablate`, numbers in PERF.md) says where it goes: about
// two thirds in the log2 n radix-2 Stockham stages (one __syncthreads each,
// every stage a full pass over shared memory: 12 passes where a radix-16
// register FFT would make 3), about a third in bringing the tap rows in
// (each frame reads its ntaps rows again, through registers, one float2 or
// char2 a thread: the copy probe measures that load width at a third, for
// char2 an eighth, of what 16-byte cp.async or bulk copies reach), a
// twentieth in the FIR's arithmetic, and nothing measurable in the X stage.
// Per block the input is read twice (the mean pre-pass, 3 us of device
// time, then the frames).  At deep taps (32 taps x 8192 bins, the wideband
// shape) the frames read 32x the block from L2 and loads and FIR are most
// of the kernel; the SVD form does not change those reads and multiplies
// the FIR's flops by r (r FMAs per tap and sample), a trade that paid on
// the TPU, where it moved the tap loop onto the matrix unit, and does not
// here: on an H100 (700 W) the SVD mode takes 2.2x to 2.6x the direct
// loop's time at the wideband shape (PERF.md; the mode is kept because
// fxtpu routes deep taps to it).  At few taps a frame's load time is its
// loads' latency, so the direct loop starts four bins' loads per tap
// together.  The design keeps what the TPU kernel keeps out of device
// memory: the spectra live only in shared memory (nch x nbins x 8 B, 64 KiB
// at the flagship shape, so the dynamic shared-memory limit is raised), and
// only the [n_groups, nbl, nbins] partial cross power reaches device
// memory.  Every sum runs in a fixed order (a two-stage mean reduction, in
// double for complex64 samples and in exact 64-bit integers for int8 ones,
// and a fixed-order sum of the partials), so a run is bit-for-bit
// repeatable; there are no atomics.  The mean pre-pass costs the second
// read of the input; the post-hoc DC algebra of the TPU kernel
// (_dc_constants / _dc_correct) removes it and is a later change.  The
// TPU's 4-bins-per-int32 packing of int8 planes answered its element-bound
// DMA; loads here are byte-addressed, so the int8 kernel reads the
// interleaved (I, Q) bytes as they arrived.  The TPU's banded bf16 matmul
// for the SVD conv, its hi/lo splits and its 1-pass tail ranks are
// matrix-unit workarounds: here every rank runs in f32 on the CUDA cores, u
// in shared memory, r accumulators per bin.  A launch of K blocks runs K
// times the CTAs of one block: where one block's frames leave most SMs idle
// (the deep-tap CLI block's 32 frames fill 32 of 132) they fill the card,
// and the host pays one set of launches per K blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Largest SVD rank the FIR policy keeps in registers (fx_fused.MAX_SVD_RANK).
constexpr int kMaxRank = 16;

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

// (a) Stage 1 of the means: grid (parts, nch, K).  Block (part, c, k)
// sums one contiguous chunk of block k's n samples of channel c (channel
// c starts `stride` samples after channel c-1, block k n samples after
// block k-1) and tree-reduces it in shared memory, in a fixed order, into
// sums[k, c, part].
template <typename T>
__global__ void __launch_bounds__(kThreads)
mean_partial_kernel(const T* __restrict__ x,
                    typename SumOf<T>::pair* __restrict__ sums, long long n,
                    long long stride) {
  using A = typename SumOf<T>::type;
  __shared__ A red_re[kThreads];
  __shared__ A red_im[kThreads];
  const int c = blockIdx.y;
  const int k = blockIdx.z;
  const int parts = gridDim.x;
  const long long chunk = (n + parts - 1) / parts;
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(lo + chunk, n);
  const T* xc = x + c * stride + k * n;
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
    sums[(static_cast<long long>(k) * gridDim.y + c) * parts + blockIdx.x] =
        typename SumOf<T>::pair{red_re[0], red_im[0]};
  }
}

// Stage 2 of the means: the `parts` sums of one block and channel, in the
// same fixed order wherever it runs.
__device__ float2 channel_mean(const double2* __restrict__ sums, int parts,
                               long long n) {
  double r = 0.0, i = 0.0;
  for (int k = 0; k < parts; ++k) {
    const double2 v = sums[k];
    r += v.x;
    i += v.y;
  }
  return make_float2(static_cast<float>(r / n), static_cast<float>(i / n));
}

// The int8 mean in real units: an exact integer sum, formed in double and
// rounded once (fx_fused.block_mean_i8 forms it the same way).
__device__ float2 channel_mean_i8(const longlong2* __restrict__ sums,
                                  int parts, long long n, double step) {
  long long r = 0, i = 0;
  for (int k = 0; k < parts; ++k) {
    const longlong2 v = sums[k];
    r += v.x;
    i += v.y;
  }
  const double nd = static_cast<double>(n);
  return make_float2(static_cast<float>(static_cast<double>(r) / nd * step),
                     static_cast<float>(static_cast<double>(i) / nd * step));
}

// The means a frame's rows lose, for one channel: rows e >= e_own are the
// CTA's own block's and lose `own`; a row of an earlier block j loses
// tab[(j - jlo) * nch] (the CTA's staged means, offset to the channel);
// history rows (e < halo) lose none (complex64: corrected already) or
// mu_prev (int8).  With one block e_own = halo and tab is never read.
struct RowMeans {
  float2 own;
  long long e_own;
  const float2* tab;
  int jlo, nch;
};

// Every input the frame kernel reads (samples, history, window, factors,
// pairs) is read-only for the whole launch and is loaded through the
// read-only cache (__ldg): a pointer inside a struct argument does not get
// that path on its own, as a const __restrict__ argument does, and the
// plain loads cost the int8 frame kernel a fifth to a third of its time
// on an H100 (PERF.md).
//
// Sample loaders of the frame kernel.  row(c, e, bin, mu) is merged row e
// of [history; x] at one bin, DC-corrected: complex64 history rows arrive
// corrected and block rows lose mu; int8 rows are dequantized (I and Q
// times the step) and lose mu_prev (tail rows) or mu (block rows), rounded
// as the plain version rounds them.  sample_ptr / history_ptr address a
// row's sample and block_value / history_value correct it, for a caller
// that walks the rows itself (for_each_tap).  Channel c of x starts
// `stride` samples after channel c-1 and block j of it n samples after
// block j-1 (stride = K n); block row r of block j is merged row halo + j
// S + r.  A
// block's mean covers its n samples (S * nbins for the FX step, every
// sample for the spectrometer, which takes one block); mean(j, c) reads
// sums[j, c, :].
struct F32Rows {
  using T = float2;
  const float2* x;
  const float2* hist;
  const double2* sums;
  long long n, stride;
  int S, halo, nbins, nch;

  __device__ float2 mean(int j, int c, int parts) const {
    return channel_mean(
        sums + (static_cast<long long>(j) * nch + c) * parts, parts, n);
  }
  __device__ const float2* sample_ptr(int c, long long e, int bin) const {
    return x + c * stride + (e - halo) * nbins + bin;
  }
  __device__ const float2* history_ptr(int c, long long e, int bin) const {
    return hist + (static_cast<long long>(c) * halo + e) * nbins + bin;
  }
  // the history arrives DC-corrected: it loses no mean
  __device__ float2 history_mean(int) const { return make_float2(0.f, 0.f); }
  __device__ float2 history_value(float2 v, float2) const { return v; }
  __device__ float2 block_value(float2 v, float2 mu) const {
    return csub(v, mu);
  }
  __device__ static float2 raw(float2 v) { return v; }
  __device__ float2 row(int c, long long e, int bin, float2 mu) const {
    return e < halo ? __ldg(history_ptr(c, e, bin))
                    : block_value(__ldg(sample_ptr(c, e, bin)), mu);
  }
};

struct I8Rows {
  using T = char2;
  const char2* x;
  const char2* tail;
  const float2* mu_prev;
  const longlong2* sums;
  long long n, stride;
  int S, halo, nbins, nch;
  float step;
  double step_d;

  __device__ float2 mean(int j, int c, int parts) const {
    return channel_mean_i8(
        sums + (static_cast<long long>(j) * nch + c) * parts, parts, n,
        step_d);
  }
  // no fused multiply-add: the same two roundings as q*step - m in torch
  __device__ float2 deq(char2 q, float2 m) const {
    return make_float2(
        __fsub_rn(__fmul_rn(static_cast<float>(q.x), step), m.x),
        __fsub_rn(__fmul_rn(static_cast<float>(q.y), step), m.y));
  }
  __device__ const char2* sample_ptr(int c, long long e, int bin) const {
    return x + c * stride + (e - halo) * nbins + bin;
  }
  __device__ const char2* history_ptr(int c, long long e, int bin) const {
    return tail + (static_cast<long long>(c) * halo + e) * nbins + bin;
  }
  // the raw tail loses the previous block's mean
  __device__ float2 history_mean(int c) const { return __ldg(mu_prev + c); }
  __device__ float2 history_value(char2 q, float2 m) const {
    return deq(q, m);
  }
  __device__ float2 block_value(char2 q, float2 mu) const {
    return deq(q, mu);
  }
  __device__ static float2 raw(char2 q) {
    return make_float2(static_cast<float>(q.x), static_cast<float>(q.y));
  }
  __device__ float2 row(int c, long long e, int bin, float2 mu) const {
    return e < halo ? deq(__ldg(history_ptr(c, e, bin)), history_mean(c))
                    : deq(__ldg(sample_ptr(c, e, bin)), mu);
  }
};

// The frame's rows e0 .. e0+ntaps-1 of [history; x] at NB bins (bin,
// bin + kThreads, ...; the first nb of them are real), each DC-corrected,
// handed to f(t, v[NB]) in tap order: the history rows (e < halo), then
// rows of earlier blocks (each losing its own block's mean, from m.tab),
// then the CTA's own block's rows (losing m.own).  Each run is a loop of
// its own over pointers that step one row (nbins samples) per tap, so a
// frame inside its own block, the common case, reads its taps with no
// branch and no 64-bit multiply per tap; block rows are contiguous across
// blocks in the merged layout.  The NB bins' loads of a tap are issued
// together: at few taps the frame's latency is its loads'.
template <int NB, class Rows, class F>
__device__ __forceinline__ void for_each_tap(const Rows& rows, int c,
                                             long long e0, int bin, int nb,
                                             const RowMeans& m, int ntaps,
                                             F&& f) {
  using T = typename Rows::T;
  const long long halo = rows.halo;
  const long long n = ntaps;
  const int t1 = static_cast<int>(min(max(halo - e0, 0LL), n));
  const int t2 = static_cast<int>(
      min(max(m.e_own - e0, static_cast<long long>(t1)), n));
  const int step = rows.nbins;
  float2 v[NB];
  int t = 0;
  if (t1 > 0) {
    const T* p = rows.history_ptr(c, e0, bin);
    const float2 mh = rows.history_mean(c);
    for (; t < t1; ++t, p += step) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < nb) v[j] = rows.history_value(__ldg(p + j * kThreads), mh);
      }
      f(t, v);
    }
  }
  if (t < ntaps) {
    const T* p = rows.sample_ptr(c, e0 + t, bin);
    for (; t < t2; ++t, p += step) {
      const long long blk = (e0 + t - halo) / rows.S;
      const float2 mu = m.tab[(blk - m.jlo) * m.nch];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < nb) v[j] = rows.block_value(__ldg(p + j * kThreads), mu);
      }
      f(t, v);
    }
    for (; t < ntaps; ++t, p += step) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < nb) v[j] = rows.block_value(__ldg(p + j * kThreads), m.own);
      }
      f(t, v);
    }
  }
}

// Stages of the frame kernel, for the stage ablation (fxt_fx_ablate; the
// counterpart of scripts/fused_ablate.py's STAGE and of the TPU kernel's
// FXTPU_FUSED_ABLATE): the kernel truncated after a stage, with the output
// policy still run over whatever the channels' slots then hold, so that
// every truncated result is a defined function of the input (held against
// fx_fused.fx_fused_ablate_reference) and no load can be optimised away.
//   kStageFull     the production kernel: what the FX entry points launch;
//   kStageLoad     every tap row read as the FIR reads it (for_each_tap,
//                  DC-corrected, the int8 rows dequantized) and summed
//                  with unit weights: no window, no multiply.  The sum is
//                  the cheapest use that keeps every load alive
//                  (TPU: dma; int8 with the dequantisation);
//   kStageLoadRaw  the same over the samples as they arrived: no mean
//                  lost, int8 only converted (TPU: dmapure / dma0);
//   kStageFir      stop after the FIR (TPU: fir);
//   kStageFftHalf  stop after floor(log2 n / 2) Stockham stages (TPU: fft1);
//   kStageFft      every stage and no X stage: each thread folds one bin
//                  of every channel's spectrum into its element of the
//                  partial (TPU: fft2 / nox).
enum : int {
  kStageFull = 0,
  kStageLoad,
  kStageLoadRaw,
  kStageFir,
  kStageFftHalf,
  kStageFft,
  kStageCount
};

// A loader that hands for_each_tap its rows as they arrived: same
// addresses, same loads, no correction.
template <class Rows>
struct RawRows : Rows {
  using T = typename Rows::T;
  __device__ float2 history_value(T v, float2) const { return Rows::raw(v); }
  __device__ float2 block_value(T v, float2) const { return Rows::raw(v); }
};

// The load stages' stand-in for the FIR: out[bin] = the sum in tap order of
// the frame's ntaps rows at this thread's bins, NB bins at a time as the
// FIR policy reads them.
template <int NB, class Rows>
__device__ void tap_sum(const Rows& rows, int c, long long e0,
                        const RowMeans& m, int ntaps, int nbins,
                        float2* out) {
  for (int b0 = threadIdx.x; b0 < nbins; b0 += NB * kThreads) {
    const int nb = min(NB, (nbins - b0 + kThreads - 1) / kThreads);
    float2 acc[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[j] = make_float2(0.f, 0.f);
    for_each_tap<NB>(rows, c, e0, b0, nb, m, ntaps,
                     [&](int, const float2* v) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < nb) acc[j] = cadd(acc[j], v[j]);
      }
    });
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nb) out[b0 + j * kThreads] = acc[j];
    }
  }
}

// How many Stockham stages a stage of the ablation runs.
template <int Stage>
__device__ __forceinline__ int fft_stages(int log2n) {
  if constexpr (Stage == kStageFull || Stage == kStageFft) {
    return log2n;
  } else if constexpr (Stage == kStageFftHalf) {
    return log2n >> 1;
  } else {
    return 0;
  }
}

// FIR policies: fir(rows, tab, c, e0, m, ntaps, nbins, out) writes the FIR
// output of the frame over merged rows e0 .. e0+ntaps-1 of [history; x],
// each losing the mean m gives it, to out[bin] for this thread's bins.
// DirectFir is the tap loop over the window w [ntaps, nbins], kBins bins
// at a time (each bin's sum still runs in tap order).
struct DirectFir {
  static constexpr int kBins = 4;
  const float* w;

  size_t table_bytes(int) const { return 0; }
  __device__ void stage(float*, int) const {}
  template <class Rows>
  __device__ void operator()(const Rows& rows, const float*, int c,
                             long long e0, const RowMeans& m, int ntaps,
                             int nbins, float2* out) const {
    for (int b0 = threadIdx.x; b0 < nbins; b0 += kBins * kThreads) {
      const int nb = min(kBins, (nbins - b0 + kThreads - 1) / kThreads);
      float2 acc[kBins];
#pragma unroll
      for (int j = 0; j < kBins; ++j) acc[j] = make_float2(0.f, 0.f);
      for_each_tap<kBins>(rows, c, e0, b0, nb, m, ntaps,
                          [&](int t, const float2* v) {
        const float* wt = w + t * nbins + b0;
#pragma unroll
        for (int j = 0; j < kBins; ++j) {
          if (j < nb) {
            const float wj = __ldg(wt + j * kThreads);
            acc[j].x += wj * v[j].x;
            acc[j].y += wj * v[j].y;
          }
        }
      });
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        if (j < nb) out[b0 + j * kThreads] = acc[j];
      }
    }
  }
};

// SvdFir is the rank-r factorisation: per rank k the scalar-tap
// convolution c_k = sum_t u[t, k] row[f+t] (u staged in shared memory as
// `tab`, one broadcast read per tap and rank), summed in tap order into r
// register accumulators, then fir = sum_k v[k, bin] c_k in rank order; one
// bin at a time (its r accumulators fill the registers).
struct SvdFir {
  static constexpr int kBins = 1;
  const float* u;   // [ntaps, rank]
  const float* v;   // [rank, nbins]
  int rank;

  size_t table_bytes(int ntaps) const {
    return static_cast<size_t>(ntaps) * rank * sizeof(float);
  }
  __device__ void stage(float* tab, int ntaps) const {
    for (int i = threadIdx.x; i < ntaps * rank; i += kThreads) tab[i] = u[i];
  }
  template <class Rows>
  __device__ void operator()(const Rows& rows, const float* tab, int c,
                             long long e0, const RowMeans& m, int ntaps,
                             int nbins, float2* out) const {
    for (int bin = threadIdx.x; bin < nbins; bin += kThreads) {
      float2 ck[kMaxRank];
#pragma unroll
      for (int k = 0; k < kMaxRank; ++k) ck[k] = make_float2(0.f, 0.f);
      for_each_tap<1>(rows, c, e0, bin, 1, m, ntaps,
                      [&](int t, const float2* x) {
        const float* ut = tab + t * rank;
#pragma unroll
        for (int k = 0; k < kMaxRank; ++k) {
          if (k < rank) {
            ck[k].x += ut[k] * x[0].x;
            ck[k].y += ut[k] * x[0].y;
          }
        }
      });
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kMaxRank; ++k) {
        if (k < rank) {
          const float vk = __ldg(v + k * nbins + bin);
          acc.x += vk * ck[k].x;
          acc.y += vk * ck[k].y;
        }
      }
      out[bin] = acc;
    }
  }
};

// Output policies.  CrossOut keeps every channel's spectrum of the frame
// in shared memory and, once all are done, adds the cross power of every
// pair to the CTA's own slice of `partial` (each element owned by one
// thread: no atomics).  SpecOut keeps one spectrum and writes each to
// spec[c, f, :] as it is done.
struct CrossOut {
  const int* pairs;
  float2* partial;   // [K, n_groups, nbl, nbins]
  int nbl;

  __host__ __device__ static int slots(int nch) { return nch; }
  __device__ float2* slot(float2* spec, int c, int nbins) const {
    return spec + static_cast<size_t>(c) * nbins;
  }
  __device__ void channel_done(const float2*, int, int, int) const {}
  __device__ void frame_done(const float2* spec, int f, int f0, int nbins,
                             int log2n) const {
    const size_t cta =
        static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    float2* out = partial + cta * nbl * nbins;
    for (int idx = threadIdx.x; idx < nbl * nbins; idx += kThreads) {
      const int l = idx >> log2n;
      const int bin = idx & (nbins - 1);
      const int p = __ldg(pairs + 2 * l);
      const int q = __ldg(pairs + 2 * l + 1);
      const float2 v = cmulconj(spec[static_cast<size_t>(p) * nbins + bin],
                                spec[static_cast<size_t>(q) * nbins + bin]);
      out[idx] = (f == f0) ? v : cadd(out[idx], v);
    }
  }
  // kStageFft's output: bin threadIdx.x of every channel's spectrum summed
  // into element threadIdx.x of the CTA's partial, and nothing else.
  __device__ void touch(const float2* spec, int nch, int f, int f0,
                        int nbins) const {
    const size_t cta =
        static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    float2* out = partial + cta * nbl * nbins;
    float2 v = spec[threadIdx.x];
    for (int c = 1; c < nch; ++c) {
      v = cadd(v, spec[static_cast<size_t>(c) * nbins + threadIdx.x]);
    }
    out[threadIdx.x] = (f == f0) ? v : cadd(out[threadIdx.x], v);
  }
};

struct SpecOut {
  float2* spec_out;   // [nch, S, nbins]
  int S;

  __host__ __device__ static int slots(int) { return 1; }
  __device__ float2* slot(float2* spec, int, int) const { return spec; }
  __device__ void channel_done(const float2* own, int c, int f,
                               int nbins) const {
    float2* out = spec_out + (static_cast<size_t>(c) * S + f) * nbins;
    for (int bin = threadIdx.x; bin < nbins; bin += kThreads) {
      out[bin] = own[bin];
    }
    __syncthreads();  // the next channel's FIR or FFT overwrites `own`
  }
  __device__ void frame_done(const float2*, int, int, int, int) const {}
};

// (b) One CTA per group of frames of one block: grid (n_groups, K),
// block k = blockIdx.y.  Dynamic shared memory:
//   spec  [slots][nbins] float2 — the frame's spectra (CrossOut: every
//                                 channel's; SpecOut: one)
//   work  [nbins]        float2 — the FFT's ping-pong buffer
//   mean  [mean_blocks][nch] float2 — the means of blocks jlo .. k, the
//                                 blocks the CTA's rows lie in
//   tab   [ntaps * r]    float  — SvdFir's u (none for DirectFir)
// For each frame and channel: the FIR over ntaps rows of [history; x]
// (read through `rows`) into the FFT's first buffer, a radix-2 Stockham
// FFT (log2 nbins stages, ping-ponging between work and the channel's slot
// and ending in the slot), then the output policy.  Stage truncates the
// frame for the ablation (kStageFull: nothing is truncated; every branch on
// Stage is an `if constexpr`, so that instantiation is the production
// code); a truncated frame runs fewer Stockham stages and starts in the
// buffer from which they end in the slot.
template <class Rows, class Fir, class Out, int Stage = kStageFull>
__global__ void __launch_bounds__(kThreads)
fx_frames_kernel(Rows rows, Fir fir, Out out, const float2* __restrict__ tw,
                 int nch, int S, int nbins, int log2n, int ntaps,
                 int frames_per_group, int parts, int mean_blocks) {
  extern __shared__ float2 smem[];
  float2* spec = smem;
  float2* work = smem + static_cast<size_t>(Out::slots(nch)) * nbins;
  float2* mean_s = work + nbins;
  float* tab = reinterpret_cast<float*>(mean_s + mean_blocks * nch);
  const int tid = threadIdx.x;
  const int half = nbins >> 1;
  const int kb = blockIdx.y;  // this CTA's block
  const int halo = ntaps - 1;
  // the first block any of this block's frames reads a row of
  const long long g_min = static_cast<long long>(kb) * S - halo;
  const int jlo = g_min <= 0 ? 0 : static_cast<int>(g_min / S);

  fir.stage(tab, ntaps);
  for (int i = tid; i < (kb - jlo + 1) * nch; i += kThreads) {
    mean_s[i] = rows.mean(jlo + i / nch, i % nch, parts);
  }
  __syncthreads();

  const int f0 = blockIdx.x * frames_per_group;
  const int f1 = min(f0 + frames_per_group, S);
  const long long e_own = static_cast<long long>(kb) * S + halo;

  for (int f = f0; f < f1; ++f) {
    const long long e0 = static_cast<long long>(kb) * S + f;
    for (int c = 0; c < nch; ++c) {
      float2* own = out.slot(spec, c, nbins);
      // an odd stage count starts in `work` so the result ends in `own`
      const int nstages = fft_stages<Stage>(log2n);
      float2* a = (nstages & 1) ? work : own;
      float2* b = (nstages & 1) ? own : work;
      const RowMeans m{mean_s[(kb - jlo) * nch + c], e_own, mean_s + c, jlo,
                       nch};
      if constexpr (Stage == kStageLoad) {
        tap_sum<Fir::kBins>(rows, c, e0, m, ntaps, nbins, a);
      } else if constexpr (Stage == kStageLoadRaw) {
        tap_sum<Fir::kBins>(RawRows<Rows>{rows}, c, e0, m, ntaps, nbins, a);
      } else {
        fir(rows, tab, c, e0, m, ntaps, nbins, a);
      }
      __syncthreads();
      for (int s = 0, ns = 1; s < nstages; ++s, ns <<= 1) {
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
      out.channel_done(own, c, f, nbins);
    }
    if constexpr (Stage == kStageFft) {
      out.touch(spec, nch, f, f0, nbins);
    } else {
      out.frame_done(spec, f, f0, nbins, log2n);
    }
    __syncthreads();  // the next frame overwrites spec
  }
}

// The partials of element idx of xp [K, nbl, nbins] summed over block k's
// groups in a fixed order (partial [K, n_groups, nbl, nbins]).
__device__ __forceinline__ void sum_partials(const float2* __restrict__ partial,
                                             float2* __restrict__ xp,
                                             long long idx, int n_groups,
                                             long long n_xp) {
  const long long k = idx / n_xp;
  const float2* p = partial + k * n_groups * n_xp + (idx - k * n_xp);
  float2 acc = p[0];
  for (int g = 1; g < n_groups; ++g) {
    acc = cadd(acc, p[g * n_xp]);
  }
  xp[idx] = acc;
}

// (c) f32: the partials summed (nbl > 0), and the new history: the last
// halo rows K S .. K S + halo - 1 of [history; x], each losing its
// block's mean.
__global__ void __launch_bounds__(kThreads)
fx_reduce_kernel(const float2* __restrict__ partial, float2* __restrict__ xp,
                 F32Rows rows, float2* __restrict__ new_hist, int K,
                 int n_groups, int nbl, int nch, int parts) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_xp = static_cast<long long>(nbl) * rows.nbins;
  if (idx < K * n_xp) sum_partials(partial, xp, idx, n_groups, n_xp);
  const int halo = rows.halo, nbins = rows.nbins;
  if (idx < static_cast<long long>(nch) * halo * nbins) {
    const int bin = static_cast<int>(idx % nbins);
    const int r = static_cast<int>((idx / nbins) % halo);
    const int c = static_cast<int>(idx / (static_cast<long long>(nbins) * halo));
    const long long e = static_cast<long long>(K) * rows.S + r;
    const float2 mu =
        e < halo ? make_float2(0.f, 0.f)
                 : rows.mean(static_cast<int>((e - halo) / rows.S), c, parts);
    new_hist[idx] = rows.row(c, e, bin, mu);
  }
}

// (c) int8: the partials summed, and each block's mean in real units,
// mu [K, nch].
__global__ void __launch_bounds__(kThreads)
fx_reduce_i8_kernel(const float2* __restrict__ partial,
                    float2* __restrict__ xp, I8Rows rows,
                    float2* __restrict__ mu, int K, int n_groups, int nbl,
                    int nch, int parts) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_xp = static_cast<long long>(nbl) * rows.nbins;
  if (idx < K * n_xp) sum_partials(partial, xp, idx, n_groups, n_xp);
  if (idx < static_cast<long long>(K) * nch) {
    const int i = static_cast<int>(idx);
    mu[idx] = rows.mean(i / nch, i % nch, parts);
  }
}

int log2_of(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// Mean pre-pass and frame kernel of any mode over K blocks, on `st`.  A
// CTA stages the means of every block its rows lie in: at most
// ceil(halo / S) + 1 of them, and never more than K.
template <int Stage = kStageFull, typename T, class Rows, class Fir,
          class Out>
cudaError_t launch_means_and_frames(const T* x, typename SumOf<T>::pair* sums,
                                    const Rows& rows, const Fir& fir,
                                    const Out& out, const void* tw, int nch,
                                    int K, int S, int nbins, int ntaps,
                                    int n_groups, int frames_per_group,
                                    int parts, cudaStream_t st) {
  if (K < 1 || K > 65535 || S < 1) return cudaErrorInvalidValue;
  const int halo = ntaps - 1;
  const int mean_blocks = min(K, (halo + S - 1) / S + 1);
  const size_t smem =
      (static_cast<size_t>(Out::slots(nch) + 1) * nbins +
       static_cast<size_t>(nch) * mean_blocks) *
          sizeof(float2) +
      fir.table_bytes(ntaps);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(
          &fx_frames_kernel<Rows, Fir, Out, Stage>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mean_partial_kernel<T><<<dim3(parts, nch, K), kThreads, 0, st>>>(
      x, sums, rows.n, rows.stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fx_frames_kernel<Rows, Fir, Out, Stage>
      <<<dim3(n_groups, K), kThreads, smem, st>>>(
          rows, fir, out, static_cast<const float2*>(tw), nch, S, nbins,
          log2_of(nbins), ntaps, frames_per_group, parts, mean_blocks);
  return cudaGetLastError();
}

// The FIR mode of the FX entry points: rank 0 the direct tap loop over w,
// rank 1 .. kMaxRank the factorisation u v.
template <int Stage = kStageFull, typename T, class Rows>
cudaError_t launch_fx(const T* x, typename SumOf<T>::pair* sums,
                      const Rows& rows, const void* w, const void* u,
                      const void* v, int rank, const CrossOut& out,
                      const void* tw, int nch, int K, int S, int nbins,
                      int ntaps, int n_groups, int frames_per_group,
                      int parts, cudaStream_t st) {
  if (rank < 0 || rank > kMaxRank) return cudaErrorInvalidValue;
  if (rank > 0) {
    const SvdFir fir{static_cast<const float*>(u),
                     static_cast<const float*>(v), rank};
    return launch_means_and_frames<Stage>(x, sums, rows, fir, out, tw, nch,
                                          K, S, nbins, ntaps, n_groups,
                                          frames_per_group, parts, st);
  }
  const DirectFir fir{static_cast<const float*>(w)};
  return launch_means_and_frames<Stage>(x, sums, rows, fir, out, tw, nch, K,
                                        S, nbins, ntaps, n_groups,
                                        frames_per_group, parts, st);
}

// launch_fx at a stage chosen at run time (the ablation's entry points).
template <typename T, class Rows>
cudaError_t launch_fx_stage(int stage, const T* x,
                            typename SumOf<T>::pair* sums, const Rows& rows,
                            const void* w, const void* u, const void* v,
                            int rank, const CrossOut& out, const void* tw,
                            int nch, int K, int S, int nbins, int ntaps,
                            int n_groups, int frames_per_group, int parts,
                            cudaStream_t st) {
#define FXT_STAGE_CASE(STAGE)                                               \
  case STAGE:                                                               \
    return launch_fx<STAGE>(x, sums, rows, w, u, v, rank, out, tw, nch, K,  \
                            S, nbins, ntaps, n_groups, frames_per_group,    \
                            parts, st)
  switch (stage) {
    FXT_STAGE_CASE(kStageFull);
    FXT_STAGE_CASE(kStageLoad);
    FXT_STAGE_CASE(kStageLoadRaw);
    FXT_STAGE_CASE(kStageFir);
    FXT_STAGE_CASE(kStageFftHalf);
    FXT_STAGE_CASE(kStageFft);
    default:
      return cudaErrorInvalidValue;
  }
#undef FXT_STAGE_CASE
}

int reduce_blocks(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

// The three kernels of the complex64 mode over K blocks on `st`, the
// frame kernel at `stage` (fxt_fx_fused: kStageFull).
int fx_c64(int stage, const void* x, const void* hist, const void* w,
           const void* u, const void* v, const void* tw, const void* pairs,
           void* sums, void* partial, void* xp, void* new_hist, int nch,
           int K, int S, int nbins, int ntaps, int rank, int nbl,
           int n_groups, int frames_per_group, int parts, cudaStream_t st) {
  const int halo = ntaps - 1;
  const long long n = static_cast<long long>(S) * nbins;
  auto* sd = static_cast<double2*>(sums);
  const F32Rows rows{static_cast<const float2*>(x),
                     static_cast<const float2*>(hist),
                     sd,
                     n,
                     K * n,
                     S,
                     halo,
                     nbins,
                     nch};
  const CrossOut out{static_cast<const int*>(pairs),
                     static_cast<float2*>(partial), nbl};
  cudaError_t err = launch_fx_stage(
      stage, static_cast<const float2*>(x), sd, rows, w, u, v, rank, out, tw,
      nch, K, S, nbins, ntaps, n_groups, frames_per_group, parts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_out = static_cast<long long>(K) * nbl * nbins;
  const long long n_hist = static_cast<long long>(nch) * halo * nbins;
  fx_reduce_kernel<<<reduce_blocks(n_out > n_hist ? n_out : n_hist), kThreads,
                     0, st>>>(static_cast<const float2*>(partial),
                              static_cast<float2*>(xp), rows,
                              static_cast<float2*>(new_hist), K, n_groups,
                              nbl, nch, parts);
  return static_cast<int>(cudaGetLastError());
}

// The three kernels of the int8 mode over K blocks on `st`, the frame
// kernel at `stage` (fxt_fx_fused_i8: kStageFull).
int fx_i8(int stage, const void* x, const void* tail, const void* mu_prev,
          const void* w, const void* u, const void* v, const void* tw,
          const void* pairs, void* sums, void* partial, void* xp, void* mu,
          int nch, int K, int S, int nbins, int ntaps, int rank, int nbl,
          int n_groups, int frames_per_group, int parts, double step,
          cudaStream_t st) {
  const long long n = static_cast<long long>(S) * nbins;
  auto* sl = static_cast<longlong2*>(sums);
  const I8Rows rows{static_cast<const char2*>(x),
                    static_cast<const char2*>(tail),
                    static_cast<const float2*>(mu_prev),
                    sl,
                    n,
                    K * n,
                    S,
                    ntaps - 1,
                    nbins,
                    nch,
                    static_cast<float>(step),
                    step};
  const CrossOut out{static_cast<const int*>(pairs),
                     static_cast<float2*>(partial), nbl};
  cudaError_t err = launch_fx_stage(
      stage, static_cast<const char2*>(x), sl, rows, w, u, v, rank, out, tw,
      nch, K, S, nbins, ntaps, n_groups, frames_per_group, parts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_out = static_cast<long long>(K) * nbl * nbins;
  const long long n_mu = static_cast<long long>(K) * nch;
  fx_reduce_i8_kernel<<<reduce_blocks(n_out > n_mu ? n_out : n_mu), kThreads,
                        0, st>>>(static_cast<const float2*>(partial),
                                 static_cast<float2*>(xp), rows,
                                 static_cast<float2*>(mu), K, n_groups, nbl,
                                 nch, parts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the three kernels of the complex64 mode over K blocks on
// `stream`.  The caller (fx_fused.py) has checked shapes, types,
// contiguity and that nbins is a power of two in [256, 8192] with ntaps >=
// 2 and rank in [0, 16] (0: the direct loop over w; else u [ntaps, rank]
// and v [rank, nbins]).  x is [nch, K, S, nbins]; each block has n_groups
// groups of frames_per_group frames.  Scratch: sums [K, nch, parts]
// double2, partial [K, n_groups, nbl, nbins] float2.  Writes xp [K, nbl,
// nbins] and new_hist [nch, ntaps-1, nbins].  Returns cudaGetLastError().
extern "C" int fxt_fx_fused(const void* x, const void* hist, const void* w,
                            const void* u, const void* v, const void* tw,
                            const void* pairs, void* sums, void* partial,
                            void* xp, void* new_hist, int nch, int K, int S,
                            int nbins, int ntaps, int rank, int nbl,
                            int n_groups, int frames_per_group, int parts,
                            void* stream) {
  return fx_c64(kStageFull, x, hist, w, u, v, tw, pairs, sums, partial, xp,
                new_hist, nch, K, S, nbins, ntaps, rank, nbl, n_groups,
                frames_per_group, parts, static_cast<cudaStream_t>(stream));
}

// Launch the three kernels of the int8 mode over K blocks on `stream`.
// The caller (fx_fused.py) has checked what it checks for fxt_fx_fused,
// plus S >= ntaps-1 and that x and tail start on an (I, Q) pair.  x is
// [nch, K, S, nbins, 2].  Scratch: sums [K, nch, parts] longlong2, partial
// [K, n_groups, nbl, nbins] float2.  Writes xp [K, nbl, nbins] and mu [K,
// nch] (complex64).  Returns cudaGetLastError().
extern "C" int fxt_fx_fused_i8(const void* x, const void* tail,
                               const void* mu_prev, const void* w,
                               const void* u, const void* v, const void* tw,
                               const void* pairs, void* sums, void* partial,
                               void* xp, void* mu, int nch, int K, int S,
                               int nbins, int ntaps, int rank, int nbl,
                               int n_groups, int frames_per_group, int parts,
                               double step, void* stream) {
  return fx_i8(kStageFull, x, tail, mu_prev, w, u, v, tw, pairs, sums,
               partial, xp, mu, nch, K, S, nbins, ntaps, rank, nbl, n_groups,
               frames_per_group, parts, step,
               static_cast<cudaStream_t>(stream));
}

// The stage ablation (fx_fused.fx_fused_ablate): fxt_fx_fused with the
// frame kernel truncated at `stage` (the kStage values, 0 .. 5; 0 is the
// production kernel, the instantiation fxt_fx_fused launches).  The mean
// pre-pass and the reduce run as they do there, so two stages' times
// differ by the frame kernel alone; the history written is fxt_fx_fused's.
// At kStageFft only xp[k, 0, 0:256] is defined.
extern "C" int fxt_fx_ablate(const void* x, const void* hist, const void* w,
                             const void* u, const void* v, const void* tw,
                             const void* pairs, void* sums, void* partial,
                             void* xp, void* new_hist, int nch, int K, int S,
                             int nbins, int ntaps, int rank, int nbl,
                             int n_groups, int frames_per_group, int parts,
                             int stage, void* stream) {
  return fx_c64(stage, x, hist, w, u, v, tw, pairs, sums, partial, xp,
                new_hist, nch, K, S, nbins, ntaps, rank, nbl, n_groups,
                frames_per_group, parts, static_cast<cudaStream_t>(stream));
}

// The stage ablation of the int8 mode: fxt_fx_fused_i8 at `stage`.
extern "C" int fxt_fx_ablate_i8(const void* x, const void* tail,
                                const void* mu_prev, const void* w,
                                const void* u, const void* v, const void* tw,
                                const void* pairs, void* sums, void* partial,
                                void* xp, void* mu, int nch, int K, int S,
                                int nbins, int ntaps, int rank, int nbl,
                                int n_groups, int frames_per_group, int parts,
                                double step, int stage, void* stream) {
  return fx_i8(stage, x, tail, mu_prev, w, u, v, tw, pairs, sums, partial,
               xp, mu, nch, K, S, nbins, ntaps, rank, nbl, n_groups,
               frames_per_group, parts, step,
               static_cast<cudaStream_t>(stream));
}

// Launch the spectrometer on `stream`: the mean pre-pass over all nsamp
// samples of each channel, the frame kernel with the spectra written to
// spec [nch, S, nbins], and (ntaps > 1) the new history.  The caller
// (spectrometer.py) has checked shapes, types, contiguity, that nbins is a
// power of two in [256, 8192], ntaps >= 1 and S >= 1.  Scratch: sums
// [nch, parts] double2.  Returns cudaGetLastError().
extern "C" int fxt_spectrometer(const void* x, const void* hist,
                                const void* w, const void* tw, void* sums,
                                void* spec, void* new_hist, long long nsamp,
                                int nch, int S, int nbins, int ntaps,
                                int n_groups, int frames_per_group, int parts,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int halo = ntaps - 1;
  auto* sd = static_cast<double2*>(sums);
  const F32Rows rows{static_cast<const float2*>(x),
                     static_cast<const float2*>(hist),
                     sd,
                     nsamp,
                     nsamp,
                     S,
                     halo,
                     nbins,
                     nch};
  const DirectFir fir{static_cast<const float*>(w)};
  const SpecOut out{static_cast<float2*>(spec), S};
  cudaError_t err = launch_means_and_frames(
      static_cast<const float2*>(x), sd, rows, fir, out, tw, nch, 1, S,
      nbins, ntaps, n_groups, frames_per_group, parts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_hist = static_cast<long long>(nch) * halo * nbins;
  if (n_hist > 0) {
    fx_reduce_kernel<<<reduce_blocks(n_hist), kThreads, 0, st>>>(
        nullptr, nullptr, rows, static_cast<float2*>(new_hist), 1, 1, 0, nch,
        parts);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fxt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
