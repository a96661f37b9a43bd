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
//   * f32 direct-tap mode      -> fxt_fx_fused     w the window (complex64);
//   * f32 SVD-FIR mode         -> fxt_fx_fused     w the folded factors;
//   * int8-native mode         -> fxt_fx_fused_i8  w the window (8-bit);
//   * int8-native SVD-FIR mode -> fxt_fx_fused_i8  w the folded factors;
// each for K >= 1 blocks per launch (fx_pallas_raw_multi's grid
// (k_blocks, tiles) over the merged rows [nch, K*S, lanes]);
// and the same kernel's single-pass DC accumulators (tout_ref, uout_ref,
// sout_ref and, in f32 mode, the corrected tail hout_ref: what
// fx_pallas_parts returns) -> fxt_fx_parts, fxt_fx_parts_i8 (the PartsOut
// output policy below: no mean pre-pass, the input read once), and for
// channel counts whose spectra of a frame do not fit in one CTA's shared
// memory (up to _fx_kernel's 64) -> fxt_fx_wide_frames, fxt_fx_wide_frames_i8
// (the WideOut policy writes the spectra to device memory) and then the X
// kernel of fx_xstage.cu (fxt_xstage, fxt_xstage_i8), which forms the
// parts from them;
// and pfb_pallas.py _kernel (launched by _pfb_fft_call, wrapped by
// spectrometer_pallas) -> fxt_spectrometer; and scripts/fused_ablate.py's
// kernel (its STAGE truncation; _fx_kernel's FXTPU_FUSED_ABLATE)
// -> fxt_fx_ablate, fxt_fx_ablate_i8 (the kStage tags below).
// All share one frame kernel (FIR, radix-16 FFT, output), templated on a
// sample loader (how a row sample is read and which mean it loses), a FIR
// policy (the direct tap loop over the FIR's table, or at deep taps the
// rows of a FIR launch of its own, fir_rows_kernel) and an output policy
// (the X loop, or the spectra written out).
//
// Contract of fxt_fx_fused (fx_pallas_raw): given x complex64
// [nch, S, nbins], the DC-corrected history complex64 [nch, ntaps-1,
// nbins], the window f32 [ntaps, nbins] and pairs int32 [nbl, 2], return
//   xp[l, b]      = sum over frames of spec_p[b] * conj(spec_q[b]),
//                   natural bin order, no rotation, no normalisation;
//   new_hist      = the block's last ntaps-1 rows minus the block mean,
// where spec is the FFT of the FIR over [history; x - mean].  In the SVD
// mode fxtpu's FIR is sum_k v[k, b] * (sum_t u[t, k] * row[f+t, b]) for
// the window's rank-r factors u [ntaps, r] and v [r, nbins]
// (fx_fused.svd_tensors); here the caller folds them into one table w = u v
// (formed in float64, rounded once: fx_fused.fir_table), the same function
// summed in another association, and the kernel runs the direct loop over
// it.
//
// Contract of fxt_fx_fused_i8 (fx_pallas_raw, int8-native): x int8
// [nch, S, nbins, 2] (I/Q interleaved, the ring's bytes), the previous
// block's raw tail int8 [nch, ntaps-1, nbins, 2] and its mean mu_prev
// complex64 [nch] in real units, the FIR's table w, pairs and quant_step;
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
// Contract of fxt_fx_parts / fxt_fx_parts_i8 (fx_pallas_parts): the FIR and
// the FFT run over the rows as they arrived (complex64: [history; x] with
// the history the DC-corrected tail the stream carries; int8: [tail; x]
// times the step, no mean lost anywhere) and each block k leaves
//   xp_raw[k, l, b] = sum over frames of spec_p[b] * conj(spec_q[b]);
//   T[k, c, b]      = sum over frames of spec_c[b];
//   GJ[k, c, b]     = sum over frames j < ntaps-1 of spec_c[j, b] *
//                     conj(dA[j, b]), dA the window's table [ntaps-1, nbins]
//                     (dc_posthoc.dc_constants);
//   mu[k, c]        = the mean of block k's samples, in real units;
// together `parts` [K, nbl + 2 nch, nbins]; and the new history: complex64
// the last block's last ntaps-1 rows minus its mean, int8 those rows as
// they arrived.  From these the caller removes the means after the fact
// (dc_posthoc.dc_correct; fxt_fx_finish in fx_finish.cu).  Blocks k >= 1
// of a launch read block k-1's rows raw (the TPU kernel's sequential grid
// corrects them in VMEM first; CTAs that run every block's frame groups at
// once cannot), so the caller corrects them with the raw-tail algebra, mu_prev
// [k] = mu[k-1], in both ingests: the same function.  S >= ntaps-1.
// fxt_fx_wide_frames / fxt_fx_wide_frames_i8 followed by fxt_xstage /
// fxt_xstage_i8 have the same contract; that frame kernel keeps one
// spectrum in shared memory, whatever nch is, and writes each to a scratch
// [K, nch, S, nbins] (complex64, 64 MiB a block at 8 channels of 2^20
// samples) that the X kernel reads once.
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
// 43 MFLOP over the 67 TFLOP/s float32 peak, 0.64 us.  A radix-2 form of
// this kernel took 38 to 40 us there: two thirds of it in 12 Stockham
// stages (each a full pass over shared memory and a barrier), a third in
// bringing the tap rows in, and its grid, one CTA running every channel of
// its frames in turn, left half the card idle (64 CTAs on 132 SMs; 32 for
// the 8-channel deep block).  The design answers each (numbers in
// PERF.md; `python scripts/torch_ab_trees.py --parent DIR` runs two
// trees' kernels in one process):
//   * the FFT is radix 16 in registers (fft_pass below): 3 passes over
//     shared memory at 512 to 8192 bins (2 at 256), in place, so each
//     channel's slot is its only buffer (no ping-pong buffer), twiddles
//     from a float64-formed table staged in shared memory once a CTA, the
//     R-point DFTs with constant twiddles;
//   * a frame group's channels are split over CTAs: the policies that form
//     products across channels (CrossOut, PartsOut) run a group on a
//     cluster of two CTAs that share their spectra through distributed
//     shared memory, so the spectra still never reach device memory (what
//     the TPU kernel keeps on chip), and the flagship block fills 128 CTAs;
//     the one-slot policies (SpecOut, WideOut) run one channel a CTA
//     (the 8-channel deep block: 256 CTAs), and above 8192 bins the wide
//     route's frames split each frame's two FFT halves over a cluster of
//     two CTAs (fx_wide_halves_kernel);
//   * the FIR keeps more loads in flight: 8 bins and their window values a
//     tap in the direct loop; at deep taps the FIR is a launch of its own
//     that reads each row once (fir_rows_kernel).
// Every launch keeps two CTAs of 256 threads an SM (128 registers).  What
// is left at the flagship is the tap rows' load latency (a CTA of 8 warps
// per SM at one block a launch), the FFT's passes, and PartsOut's partial
// rows written to device memory.  On the two-pass entries the input is
// read twice per block (the mean pre-pass, 3 us of device time, then the
// frames); the single-pass entries sum each frame's newest tap row as the
// FIR reads it.  At deep taps (32 taps x 8192 bins) an in-kernel tap loop
// reads 32x the block from L2, and the rank-r SVD form multiplied the
// FIR's flops by r, a trade that paid on the TPU, where it moved the tap
// loop onto the matrix unit, and does not here: the factors are folded
// back into one table and a FIR launch reads each row once (RowsFir,
// fir_rows_kernel; the mode is kept because fxtpu routes deep taps to
// it).  Every sum runs in a fixed order
// (a two-stage mean reduction, in double for complex64 samples and in
// exact 64-bit integers for int8 ones, and a fixed-order sum of the
// partials), so a run is bit-for-bit repeatable; there are no atomics.  The
// mean pre-pass costs the second read of the input; the post-hoc DC algebra
// of the TPU kernel (_dc_constants / _dc_correct) removes it: the
// single-pass entries (PartsOut) are what the engine's step launches, the
// two-pass entries stay for callers that want the corrected cross power
// from one call.  The TPU's 4-bins-per-int32 packing of int8 planes
// answered its element-bound DMA; loads here are byte-addressed, so the
// int8 kernel reads the interleaved (I, Q) bytes as they arrived.  The
// TPU's banded bf16 matmul for the SVD conv, its hi/lo splits and its
// 1-pass tail ranks are matrix-unit workarounds: here the folded table
// runs in f32 on the CUDA cores.  A
// launch of K blocks runs K times the CTAs of one block, and the host pays
// one set of launches per K blocks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fx_common.cuh"   // cadd, csub, cmulconj, SumOf
#include "fx_fft.cuh"      // cmul, fft_run, fft_pass_count

namespace cg = cooperative_groups;

// The frame kernel's dynamic shared memory (its layout is under (b)).
extern __shared__ float2 fx_smem[];

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads == kFftThreads, "a frame's FFT runs on the whole CTA");

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
  static constexpr bool kRaw = false;
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
  static constexpr bool kRaw = false;
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

// Loaders of the single-pass entries: the rows as they arrived, in real
// units, no mean lost (the history too: the complex64 one arrives
// corrected, the int8 tail's mean is removed after the fact).  No means are
// staged for them (kRaw).  sum_term turns a loaded value back into what the
// sample sums add: the float itself in double, or the 8-bit sample as an
// exact integer (q * step * (1 / step) rounds to q: the error is below
// 127 * 2^-22).
struct F32Raw : F32Rows {
  static constexpr bool kRaw = true;
  __device__ float2 history_value(float2 v, float2) const { return v; }
  __device__ float2 block_value(float2 v, float2) const { return v; }
  __device__ float inv_step() const { return 1.f; }
  __device__ static double sum_term(float v, float) { return v; }
};

struct I8Raw : I8Rows {
  static constexpr bool kRaw = true;
  __device__ float2 scaled(char2 q) const {
    return make_float2(__fmul_rn(static_cast<float>(q.x), step),
                       __fmul_rn(static_cast<float>(q.y), step));
  }
  __device__ float2 history_mean(int) const { return make_float2(0.f, 0.f); }
  __device__ float2 history_value(char2 q, float2) const { return scaled(q); }
  __device__ float2 block_value(char2 q, float2) const { return scaled(q); }
  __device__ float inv_step() const {
    return static_cast<float>(1.0 / step_d);
  }
  __device__ static long long sum_term(float v, float inv) {
    return __float2ll_rn(v * inv);
  }
};

// What a FIR policy hands each frame's newest tap row to (tap ntaps-1:
// block row f is the newest row of frame f and of no other, so a block's
// frames meet each of its samples once).  NoSum drops it; RowSum adds it
// to two per-thread sums, in double for complex64 samples and in exact
// 64-bit integers for 8-bit ones, and flush() folds the warp's sums, in
// lane order, into the warp's slot of channel c (only lane 0 of the warp
// ever touches that slot).
struct NoSum {
  static constexpr bool kActive = false;
  template <class Rows>
  __device__ explicit NoSum(const Rows&) {}
  template <int NB>
  __device__ void add(const float2*, int) {}
};

template <class Rows>
struct RowSum {
  static constexpr bool kActive = true;
  using A = typename SumOf<typename Rows::T>::type;
  using Pair = typename SumOf<typename Rows::T>::pair;
  A re, im;
  float inv;

  __device__ explicit RowSum(const Rows& rows)
      : re(0), im(0), inv(rows.inv_step()) {}
  template <int NB>
  __device__ void add(const float2* v, int nb) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nb) {
        re += Rows::sum_term(v[j].x, inv);
        im += Rows::sum_term(v[j].y, inv);
      }
    }
  }
  __device__ void flush(Pair* wsum, int c) {
    for (int o = 16; o > 0; o >>= 1) {
      re += __shfl_down_sync(0xffffffffu, re, o);
      im += __shfl_down_sync(0xffffffffu, im, o);
    }
    if ((threadIdx.x & 31) == 0) {
      Pair& w = wsum[c * kWarps + (threadIdx.x >> 5)];
      w.x += re;
      w.y += im;
    }
  }
};

// Taps [t, end) of a run of rows that share one correction, U rows at a
// time: the U rows' loads at the NB bins are issued together (U x NB
// independent loads in flight a thread), then each row is corrected
// (conv, which holds its loader by value: a reference would put the
// kernel's parameter in local memory) and handed to f(t, v[NB]) in tap
// order; the last end - t mod U rows one at a time.  p points at row t and
// steps `step` samples a row.
template <int NB, int U, class T, class Conv, class F>
__device__ __forceinline__ void tap_run(int& t, int end, const T*& p,
                                        int step, int nb, Conv conv,
                                        F&& f) {
  for (; U > 1 && t + U <= end; t += U, p += U * step) {
    T raw[U][NB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < nb) raw[u][j] = __ldg(p + u * step + j * kThreads);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float2 v[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < nb) v[j] = conv(raw[u][j]);
      }
      f(t + u, v);
    }
  }
  for (; t < end; ++t, p += step) {
    float2 v[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nb) v[j] = conv(__ldg(p + j * kThreads));
    }
    f(t, v);
  }
}

// The frame's rows e0 .. e0+ntaps-1 of [history; x] at NB bins (bin,
// bin + kThreads, ...; the first nb of them are real), each DC-corrected,
// handed to f(t, v[NB]) in tap order: the history rows (e < halo), then
// rows of earlier blocks (each losing its own block's mean, from m.tab),
// then the CTA's own block's rows (losing m.own).  Each run is a loop of
// its own over pointers that step one row (nbins samples) per tap, so a
// frame inside its own block, the common case, reads its taps with no
// branch and no 64-bit multiply per tap; block rows are contiguous across
// blocks in the merged layout.  The history and own-block runs load U rows
// at a time (tap_run), so that a thread keeps U x NB loads in flight
// (DirectFir: 8 bins, one row, and their 8 window loads): the frame's time
// at few bins a thread is its loads' latency.
template <int NB, int U, class Rows, class F>
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
  int t = 0;
  if (t1 > 0) {
    const T* p = rows.history_ptr(c, e0, bin);
    const float2 mh = rows.history_mean(c);
    tap_run<NB, U>(t, t1, p, step, nb,
                   [=](T q) { return rows.history_value(q, mh); }, f);
  }
  if (t < ntaps) {
    const T* p = rows.sample_ptr(c, e0 + t, bin);
    for (; t < t2; ++t, p += step) {
      const long long blk = (e0 + t - halo) / rows.S;
      const float2 mu = m.tab[(blk - m.jlo) * m.nch];
      float2 v[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < nb) v[j] = rows.block_value(__ldg(p + j * kThreads), mu);
      }
      f(t, v);
    }
    const float2 own = m.own;
    tap_run<NB, U>(t, ntaps, p, step, nb,
                   [=](T q) { return rows.block_value(q, own); }, f);
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
//   kStageFftHalf  stop after the first floor(passes / 2) radix passes of
//                  the FFT (one of its 2 or 3; TPU: fft1, the first of its
//                  two DFT stages); the slot then holds what
//                  fx_fused.fft_passes(y, 1) returns;
//   kStageFft      every pass and no X stage: each thread folds one bin
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
// the frame's ntaps rows at this thread's bins, NB bins and U rows at a
// time as the FIR policy reads them.
template <int NB, int U, class Rows>
__device__ void tap_sum(const Rows& rows, int c, long long e0,
                        const RowMeans& m, int ntaps, int nbins,
                        float2* out) {
  for (int b0 = threadIdx.x; b0 < nbins; b0 += NB * kThreads) {
    const int nb = min(NB, (nbins - b0 + kThreads - 1) / kThreads);
    float2 acc[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[j] = make_float2(0.f, 0.f);
    for_each_tap<NB, U>(rows, c, e0, b0, nb, m, ntaps,
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

// ---------------------------------------------------------------------------
// The FFT: radix 16 in registers at the powers of two in [256, 8192]
// (fx_fft.cuh, shared with the overlap probe).

// fft_run over the slot that starts `off` float2 into the frame kernel's
// dynamic shared memory, with the twiddle table staged at `tw_off` there.
// Not inlined: one body per size for every kernel instantiation (the
// production kernels and the ablation's run the same code, and the build
// compiles it once), each with registers of its own.
template <int kLog>
__device__ __noinline__ void fft_sized(int off, int tw_off, int npasses) {
  fft_run<kLog>(fx_smem + off, fx_smem + tw_off, npasses);
}

// Every other bin count the TPU kernel takes (_kernel_factor: n = 128 m,
// 2 <= m <= 128; fx_fused.kernel_bins) runs fft_mixed, one body for all of
// them with the size at run time: n = 2^a q, q odd.  Up to kFftMaxSub
// points it is one Stockham sequence: register passes while 16 divides
// 2^a and for the rest of 2^a (2, 4 or 8; fft_pass_reg, the pass above
// with the twiddle read for any even n), then one pass for each odd prime
// factor p of q: the largest, the last pass, as pre-twiddled p-point DFTs
// by their roots' real symmetry in register tiles (fft_pass_prime_last),
// any smaller one as a direct DFT (fft_pass_direct: each thread forms up to
// 32 outputs, each a sum of p loads times exp(-2 pi i m / n) from the
// table, holds them across the barrier and stores them as a Stockham pass
// does).  Above kFftMaxSub points
// a pass would hold n / 256 > 32 points a thread across its barrier, more
// registers than two CTAs an SM leave: the FIR writes the frame's even
// samples to the slot's first half and its odd ones to the second
// (fft_slot), each half runs the sequence of n / 2 points (the table read
// at stride 2), and one radix-2 pass, in place with each thread's own two
// points, combines them into the natural order.  The n / 2-entry table
// exp(-2 pi i m / n) and its negation give every twiddle of every pass,
// the p-point DFTs' roots exp(-2 pi i j / p) = exp(-2 pi i j (n / p) / n)
// among them.

// The largest FFT that runs as one Stockham sequence over its slot
// (fx_fused.FFT_MAX_SUB); above it, two halves and a radix-2 pass.
constexpr int kFftMaxSub = 8192;
// Outputs a thread of a direct-DFT pass holds across its barrier.
constexpr int kDirectPer = kFftMaxSub / kThreads;

// log2 n where the FFT of n points runs fft_sized (a power of two in [256,
// kFftMaxSub]), else -1: fft_mixed, and the frame's bins split by division.
int fft_log2(int n) {
  if (n < 256 || n > kFftMaxSub || (n & (n - 1)) != 0) return -1;
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// Where the FIR stores bin b of a frame of n bins for the FFT: in place up
// to kFftMaxSub, above it the even samples in the first half and the odd
// ones in the second (fft_mixed).
__device__ __forceinline__ int fft_slot(int b, int n) {
  return n > kFftMaxSub ? (b & 1) * (n >> 1) + (b >> 1) : b;
}

// (idx / n, idx % n) over a frame's n bins: by shifts at a power of two
// (lg = log2 n), by division at any other n (kMixed).
template <bool kMixed>
__device__ __forceinline__ int2 split_bins(int idx, int n, int lg) {
  if constexpr (kMixed) {
    const int q = idx / n;
    return make_int2(q, idx - q * n);
  } else {
    return make_int2(idx >> lg, idx & (n - 1));
  }
}

// exp(-2 pi i m / n) for 0 <= m < n, n even, from the table of its first
// half.
__device__ __forceinline__ float2 twiddle_any(const float2* tw, int m,
                                              int half) {
  if (m < half) return tw[m];
  const float2 t = tw[m - half];
  return make_float2(-t.x, -t.y);
}

// A register pass of radix R (2, 4, 8 or 16) of a Stockham sequence of N
// points at slot offset `off` of the frame kernel's shared memory (fft_pass,
// its loads and stores through the swizzle where swz_in / swz_out say) for
// N <= kFftMaxSub, the twiddle exp(-2 pi i e / N) read at e ts of the table
// of n = N ts points at `tw_off` (half = n / 2).  The mixed FFT's passes
// take offsets into fx_smem, not pointers: a pointer handed to a function
// that is not inlined is a generic address, and every load through it a
// generic load (as fft_sized's offsets avoid).  The
// power-of-two passes come first, so Ns is a power of two; a thread holds
// kFftMaxSub / kThreads points across the barrier at every radix.  The
// radix-2/4/8 rest of the power of two ran as a direct DFT before
// (fft_pass_direct), each output a chain of R table loads: at 16,384 bins
// (two halves of 16^3 x 2) the frame kernel took 77.3 us of a 2 x 2^18
// block (PERF.md).
template <int R>
__device__ __noinline__ void fft_pass_reg(int off, int tw_off, int N, int ns,
                                          int ts, int half, bool swz_in,
                                          bool swz_out) {
  float2* buf = fx_smem + off;
  const float2* tw = fx_smem + tw_off;
  constexpr int kPer = kFftMaxSub / (R * kThreads);
  const int nb = N / R;
  const int d = N / (ns * R) * ts;
  float2 v[kPer][R];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int j = threadIdx.x + p * kThreads;
    if (j < nb) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = j + r * nb;
        v[p][r] = buf[swz_in ? swz<true>(i) : i];
      }
      if (ns > 1) {
        const int step = (j & (ns - 1)) * d;
#pragma unroll
        for (int r = 1; r < R; ++r) {
          v[p][r] = cmul(v[p][r], twiddle_any(tw, r * step, half));
        }
      }
      dif_stages<R, R / 2>(v[p]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int j = threadIdx.x + p * kThreads;
    if (j < nb) {
      const int k = j & (ns - 1);
      const int base = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = base + r * ns;
        buf[swz_out ? swz<true>(i) : i] = v[p][bitrev(r, ilog2(R))];
      }
    }
  }
  __syncthreads();
}

// A pass of any radix R with stride Ns over the N points at buf, each
// output a direct R-point DFT with its input twiddles folded in: output r
// of butterfly j (o = r N / R + j, thread-owned) is
//   sum_s buf[j + s N / R] exp(-2 pi i s (k + r Ns) N / (Ns R) / N),
// k = j mod Ns, each exponent kept below n by one subtraction, summed in
// two chains (even and odd s) to halve the adds' latency; every output is
// held across the barrier and stored at (j - k) R + k + r Ns.  A thread's
// outputs step kThreads apart, so (r, j) steps without a division.
__device__ __noinline__ void fft_pass_direct(int off, int tw_off, int N,
                                             int R, int ns, int ts,
                                             int half) {
  float2* buf = fx_smem + off;
  const float2* tw = fx_smem + tw_off;
  const int nb = N / R;
  const int n = N * ts;
  const int d = N / (ns * R) * ts;
  const bool ns_pow2 = (ns & (ns - 1)) == 0;
  const int r0 = static_cast<int>(threadIdx.x) / nb;
  const int j0 = static_cast<int>(threadIdx.x) - r0 * nb;
  float2 y[kDirectPer];
  int r = r0, j = j0;
#pragma unroll
  for (int i = 0; i < kDirectPer; ++i) {
    if (r >= R) break;   // the thread's outputs are done
    const int k = ns_pow2 ? (j & (ns - 1)) : j % ns;
    const int inc = (k + r * ns) * d;
    float2 a0 = buf[j];
    float2 a1 = make_float2(0.f, 0.f);
    int m = 0;
    int s = 1;
    for (; s + 1 < R; s += 2) {
      m += inc;
      if (m >= n) m -= n;
      a1 = cadd(a1, cmul(buf[j + s * nb], twiddle_any(tw, m, half)));
      m += inc;
      if (m >= n) m -= n;
      a0 = cadd(a0, cmul(buf[j + (s + 1) * nb], twiddle_any(tw, m, half)));
    }
    if (s < R) {
      m += inc;
      if (m >= n) m -= n;
      a1 = cadd(a1, cmul(buf[j + s * nb], twiddle_any(tw, m, half)));
    }
    y[i] = cadd(a0, a1);
    for (j += kThreads; j >= nb; j -= nb) ++r;
  }
  __syncthreads();
  r = r0;
  j = j0;
#pragma unroll
  for (int i = 0; i < kDirectPer; ++i) {
    if (r >= R) break;
    const int k = ns_pow2 ? (j & (ns - 1)) : j % ns;
    buf[(j - k) * R + k + r * ns] = y[i];
    for (j += kThreads; j >= nb; j -= nb) ++r;
  }
  __syncthreads();
}

// Replaces, with the passes around it: the FFT of _fx_kernel and _kernel
// (fxtpu/ops/pfb_pallas.py) at the bin counts of _kernel_factor (:75-81)
// that are not powers of two, which the TPU kernel runs as DFT matmuls.
// What bounds it on the H100: latency; its operations (at 16,256 bins 2 x
// 64 x 63^2 x 4 real multiply-adds a frame, 2 us for a 2 x 2^18 block at
// the card's float32 rate) and shared-memory loads are far below the time
// it takes.
//
// The last pass of a Stockham sequence of N points at buf when its radix
// is an odd prime p (the largest prime factor of N): Ns = nb = N / p, so
// butterfly j reads the column j + s nb (s < p) and writes its outputs to
// the same column, j + r nb.  Two steps:
//   * the input twiddles exp(-2 pi i s j / N) in place (each point once);
//   * a pure p-point DFT of every column, by the real symmetry of its
//     roots: with u_s = x_s + x_{p-s}, v_s = x_s - x_{p-s} (1 <= s <= H =
//     (p - 1) / 2) and theta = 2 pi r s / p,
//       y_r     = x_0 + A_r - i B_r,   y_{p-r} = x_0 + A_r + i B_r,
//       A_r = sum_s cos(theta) u_s,     B_r = sum_s sin(theta) v_s,
//       y_0 = x_0 + sum_s u_s,
//     H^2 real-by-complex products per column pair where the direct form
//     (fft_pass_direct) made p^2 complex ones.  A thread forms a tile of
//     kPrimeRows r's by kPrimeCols columns: each x it loads serves its
//     kPrimeRows r's, each root its kPrimeCols columns, and its 2
//     kPrimeRows kPrimeCols accumulators are independent chains.  The root
//     of r s mod p (kept by one add and one compare per step) comes from the
//     FFT's own float64-formed table, exp(-2 pi i m nb ts / n), folded into
//     m <= H by cos(2 pi (p - m) / p) = cos(2 pi m / p) (its sine negated),
//     so no recurrence rounds it.  The r-group is uniform over a warp where
//     it can be (the column groups of a round run along the warp), so the
//     root's load is one broadcast.  The tiles of a round cover whole
//     columns: every read of a round comes before the barrier and every
//     write after it, so a thread holds one tile's outputs, not N / kThreads.
// At 16,256 bins (127 x 128; the halves' last pass is 127 over 64 columns)
// the direct form was 96% of the frame kernel, 706 of 742 us: 2 x 8128 x
// 127 complex products a frame, each output one chain of table loads.
// This form took that frame kernel to 162 us (H100, 700 W; PERF.md), of
// which the two halves' DFTs were 85 us (timed by skipping them) and their
// pre-twiddles 7.5: at one CTA of 8 warps an SM (195 KB of shared memory)
// and 32 CTAs for a 2 x 2^18 block, the loop's loads and roots are not
// hidden; each half on a CTA of its own (fx_wide_halves_kernel) took it to
// 88.  Measured and dropped, at 16,256 / 3072 / 384 bins (frame kernel us
// against this form's 159 / 31.5 / 57.7, one CTA a frame-channel): 4
// columns a tile 144 / 39.2 / 75.0 (fewer threads at work where p is
// small); the s loop unrolled by 4 156 / 30.7 / 57.6; roots by recurrence
// re-anchored every 8 steps 153 / 29.8 / 56.6.
// Rader's algorithm (a 126-point cyclic convolution by FFTs of 2 x 3^2 x 7
// points) was not taken: its passes would add more noinline bodies to every
// kMixed kernel, whose build cost each bin count pays, for a pass that the
// symmetric tiles already bring near the other passes' cost.
constexpr int kPrimeRows = 4;   // r's of a tile
constexpr int kPrimeCols = 2;   // columns of a tile

__device__ __noinline__ void fft_pass_prime_last(int off, int tw_off, int N,
                                                 int p, int ts) {
  float2* buf = fx_smem + off;
  const float2* tw = fx_smem + tw_off;
  const int nb = N / p;
  for (int i = threadIdx.x; i < (p - 1) * nb; i += kThreads) {
    const int s = 1 + i / nb;
    const int j = i - (s - 1) * nb;
    float2* e = buf + j + s * nb;
    *e = cmul(*e, twiddle_any(tw, s * j * ts, (N * ts) >> 1));
  }
  __syncthreads();
  const int hp = (p - 1) >> 1;
  const int n_rg = (hp + kPrimeRows - 1) / kPrimeRows;   // <= 16 (p < 128)
  const int n_cg = (nb + kPrimeCols - 1) / kPrimeCols;
  const int per_round = kThreads / n_rg;                 // column groups
  const int rg = static_cast<int>(threadIdx.x) / per_round;
  const int cl = static_cast<int>(threadIdx.x) - rg * per_round;
  const int root = nb * ts;   // the table's stride between roots of p
  for (int g0 = 0; g0 < n_cg; g0 += per_round) {
    const int cg = g0 + cl;
    const bool active = rg < n_rg && cg < n_cg;
    float2 x0[kPrimeCols], y0[kPrimeCols];
    float2 a[kPrimeRows][kPrimeCols], b[kPrimeRows][kPrimeCols];
    if (active) {
#pragma unroll
      for (int c = 0; c < kPrimeCols; ++c) {
        const int j = cg + c * n_cg;
        x0[c] = j < nb ? buf[j] : make_float2(0.f, 0.f);
        y0[c] = x0[c];
#pragma unroll
        for (int r = 0; r < kPrimeRows; ++r) {
          a[r][c] = make_float2(0.f, 0.f);
          b[r][c] = make_float2(0.f, 0.f);
        }
      }
      int m[kPrimeRows];
#pragma unroll
      for (int r = 0; r < kPrimeRows; ++r) m[r] = 0;
      for (int s = 1; s <= hp; ++s) {
        float2 u[kPrimeCols], v[kPrimeCols];
#pragma unroll
        for (int c = 0; c < kPrimeCols; ++c) {
          const int j = cg + c * n_cg;
          const float2 xa = j < nb ? buf[j + s * nb] : make_float2(0.f, 0.f);
          const float2 xb =
              j < nb ? buf[j + (p - s) * nb] : make_float2(0.f, 0.f);
          u[c] = cadd(xa, xb);
          v[c] = csub(xa, xb);
          y0[c] = cadd(y0[c], u[c]);
        }
#pragma unroll
        for (int r = 0; r < kPrimeRows; ++r) {
          const int rr = rg * kPrimeRows + r + 1;
          if (rr <= hp) {
            m[r] += rr;
            if (m[r] >= p) m[r] -= p;
            const bool hi = m[r] > hp;
            const float2 t = tw[(hi ? p - m[r] : m[r]) * root];
            const float cs = t.x;
            const float sn = hi ? t.y : -t.y;
#pragma unroll
            for (int c = 0; c < kPrimeCols; ++c) {
              a[r][c].x += cs * u[c].x;
              a[r][c].y += cs * u[c].y;
              b[r][c].x += sn * v[c].x;
              b[r][c].y += sn * v[c].y;
            }
          }
        }
      }
    }
    __syncthreads();   // every read of the round's columns is done
    if (active) {
#pragma unroll
      for (int c = 0; c < kPrimeCols; ++c) {
        const int j = cg + c * n_cg;
        if (j >= nb) continue;
        if (rg == 0) buf[j] = y0[c];
#pragma unroll
        for (int r = 0; r < kPrimeRows; ++r) {
          const int rr = rg * kPrimeRows + r + 1;
          if (rr <= hp) {
            const float2 e = cadd(x0[c], a[r][c]);
            buf[j + rr * nb] = make_float2(e.x + b[r][c].y, e.y - b[r][c].x);
            buf[j + (p - rr) * nb] =
                make_float2(e.x - b[r][c].y, e.y + b[r][c].x);
          }
        }
      }
    }
    __syncthreads();   // the round's writes before the next round's reads
  }
}

// The Stockham sequence of N = 2^a q points (64 <= 2^a, N <= kFftMaxSub,
// q odd) at buf, natural order after it (fx_fused.fft_radices): radix 16
// while 16 divides 2^a (where pass 1 is one of these, pass 0 stores
// swizzled and pass 1 loads so), then the rest of 2^a (2, 4 or 8) as a
// register pass, then each odd prime factor of q, smallest first: the last
// (the largest) by fft_pass_prime_last, any before it as a direct DFT
// (primes of 3 to 11, whose direct sums are short).
__device__ __forceinline__ void fft_stockham(int off, int tw_off, int N,
                                             int ts, int half) {
  int p2 = N & -N;
  const bool swz = p2 % 256 == 0;   // pass 1 is a radix-16 pass
  int ns = 1;
  for (; p2 % 16 == 0; p2 /= 16, ns *= 16) {
    fft_pass_reg<16>(off, tw_off, N, ns, ts, half, swz && ns == 16,
                     swz && ns == 1);
  }
  if (p2 == 8) {
    fft_pass_reg<8>(off, tw_off, N, ns, ts, half, false, false);
  } else if (p2 == 4) {
    fft_pass_reg<4>(off, tw_off, N, ns, ts, half, false, false);
  } else if (p2 == 2) {
    fft_pass_reg<2>(off, tw_off, N, ns, ts, half, false, false);
  }
  ns *= p2;
  int q = N / ns;
  for (int f = 3; q > 1; f += 2) {
    while (q % f == 0) {
      if (q == f) {
        fft_pass_prime_last(off, tw_off, N, f, ts);
      } else {
        fft_pass_direct(off, tw_off, N, f, ns, ts, half);
      }
      ns *= f;
      q /= f;
    }
  }
}

// The FFT of every bin count fft_sized does not take (header above), over
// the slot `off` float2 into the frame kernel's dynamic shared memory, the
// twiddle table at `tw_off`: only the kernels of those bin counts
// (fx_frames_kernel's kMixed) call it, so the radix-16 sizes' kernels
// compile as they did without it.  Not inlined, nor are its passes: one
// body each (inlined into one, the passes spilled some 10 KB a thread and
// ptxas took minutes).
__device__ __noinline__ void fft_mixed(int off, int tw_off, int n) {
  float2* buf = fx_smem + off;
  const float2* tw = fx_smem + tw_off;
  const int half = n >> 1;
  if (n <= kFftMaxSub) {
    fft_stockham(off, tw_off, n, 1, half);
    return;
  }
  fft_stockham(off, tw_off, half, 2, half);         // the even samples'
  fft_stockham(off + half, tw_off, half, 2, half);  // the odd samples'
  for (int k = threadIdx.x; k < half; k += kThreads) {
    const float2 a = buf[k];
    const float2 b = cmul(buf[k + half], tw[k]);
    buf[k] = cadd(a, b);
    buf[k + half] = csub(a, b);
  }
  __syncthreads();
}


// The first `npasses` passes of the FFT of 2^log2n points (8 to 13).
__device__ __forceinline__ void fft_inplace(int off, int tw_off, int log2n,
                                            int npasses) {
  if (npasses <= 0) return;
  switch (log2n) {
    case 8:
      fft_sized<8>(off, tw_off, npasses);
      break;
    case 9:
      fft_sized<9>(off, tw_off, npasses);
      break;
    case 10:
      fft_sized<10>(off, tw_off, npasses);
      break;
    case 11:
      fft_sized<11>(off, tw_off, npasses);
      break;
    case 12:
      fft_sized<12>(off, tw_off, npasses);
      break;
    default:
      fft_sized<13>(off, tw_off, npasses);
      break;
  }
}

// How many FFT passes a stage of the ablation runs.
template <int Stage>
__device__ __forceinline__ int fft_passes(int log2n) {
  if constexpr (Stage == kStageFull || Stage == kStageFft) {
    return fft_pass_count(log2n);
  } else if constexpr (Stage == kStageFftHalf) {
    return fft_pass_count(log2n) / 2;
  } else {
    return 0;
  }
}

// FIR policies: fir.run<kSlot>(rows, tab, c, e0, m, ntaps, nbins, out,
// sum) writes the FIR output of the frame over merged rows e0 ..
// e0+ntaps-1 of [history; x], each losing the mean m gives it, to
// out[bin] for this thread's bins (kSlot: to out[fft_slot(bin)], the
// mixed-radix FFT's order), and hands the newest row's values to `sum`
// (NoSum: nothing is compiled).
// DirectFir is the tap loop over the window w [ntaps, nbins], kBins bins
// at a time (each bin's sum still runs in tap order): 8, so a tap's 8
// sample loads and 8 window loads are in flight together (16 bins, or
// 2 or 4 rows a round trip, took more registers and were slower, and rows
// staged through shared memory by cp.async were no faster; PERF.md).
struct DirectFir {
  static constexpr int kBins = 8;
  static constexpr int kTaps = 1;
  const float* w;

  size_t table_bytes(int) const { return 0; }
  __device__ void stage(float*, int) const {}
  template <bool kSlot, class Rows, class Sum>
  __device__ void run(const Rows& rows, const float*, int c, long long e0,
                      const RowMeans& m, int ntaps, int nbins, float2* out,
                      Sum& sum) const {
    for (int b0 = threadIdx.x; b0 < nbins; b0 += kBins * kThreads) {
      const int nb = min(kBins, (nbins - b0 + kThreads - 1) / kThreads);
      float2 acc[kBins];
#pragma unroll
      for (int j = 0; j < kBins; ++j) acc[j] = make_float2(0.f, 0.f);
      for_each_tap<kBins, kTaps>(rows, c, e0, b0, nb, m, ntaps,
                          [&](int t, const float2* v) {
        const float* wt = w + t * nbins + b0;
        if constexpr (Sum::kActive) {
          if (t == ntaps - 1) sum.template add<kBins>(v, nb);
        }
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
        if (j < nb) {
          const int bin = b0 + j * kThreads;
          out[kSlot ? fft_slot(bin, nbins) : bin] = acc[j];
        }
      }
    }
  }
};

// RowsFir is the FIR at deep taps (fx_fused.deep_fir): a launch of its own
// before the frame kernel (fir_rows_kernel below) has written every frame's
// FIR output to fir [nch, K S, nbins] (frame g of the merged rows is row g),
// and the frame kernel reads one row a frame, kBins bins a thread as
// DirectFir walks them; a single-pass policy (Sum active) also reads the
// frame's newest tap row and hands it to `sum` exactly as the tap loop did,
// so the sample sums, and the means the reduce forms from them, keep their
// bits.
struct RowsFir {
  static constexpr int kBins = DirectFir::kBins;
  static constexpr int kTaps = 1;   // tap_sum's rows a round trip (ablation)
  const float2* fir;
  long long frames;   // K S: the rows of each channel

  size_t table_bytes(int) const { return 0; }
  __device__ void stage(float*, int) const {}
  template <bool kSlot, class Rows, class Sum>
  __device__ void run(const Rows& rows, const float*, int c, long long e0,
                      const RowMeans& m, int ntaps, int nbins, float2* out,
                      Sum& sum) const {
    const float2* src = fir + (c * frames + e0) * nbins;
    for (int b0 = threadIdx.x; b0 < nbins; b0 += kBins * kThreads) {
      const int nb = min(kBins, (nbins - b0 + kThreads - 1) / kThreads);
      float2 y[kBins];
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        if (j < nb) y[j] = __ldg(src + b0 + j * kThreads);
      }
      if constexpr (Sum::kActive) {
        // the newest tap row, e0 + ntaps - 1, always a block row
        const auto* p = rows.sample_ptr(c, e0 + ntaps - 1, b0);
        float2 v[kBins];
#pragma unroll
        for (int j = 0; j < kBins; ++j) {
          if (j < nb) v[j] = rows.block_value(__ldg(p + j * kThreads), m.own);
        }
        sum.template add<kBins>(v, nb);
      }
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        if (j < nb) {
          const int bin = b0 + j * kThreads;
          out[kSlot ? fft_slot(bin, nbins) : bin] = y[j];
        }
      }
    }
  }
};

// (b0) The FIR at deep taps, a launch of its own: fir[c, g, bin] = sum over
// t in tap order of w[t, bin] row[g + t, bin], for every frame g < K S of
// the merged rows [history; x] (each row DC-corrected as the loader says,
// as for_each_tap corrects it: the same values in the same order, so the
// direct mode's output is the in-kernel loop's).  w is the window, or in
// the SVD mode its rank-r factors folded into one table (u v formed in
// float64 and rounded once, fx_fused.fir_table): the same function as the
// U-then-V sum, in another association, with a sixth of its operations.
//
// Replaces: the FIR of _fx_kernel (fxtpu/ops/pfb_pallas.py), at deep taps
// its banded SVD form (:810-869), whose point is that each window of rows
// is "read exactly once".  The in-kernel tap loop read every frame's ntaps
// rows again, though consecutive frames share ntaps - 1 of them: at the
// wideband shape (2 x 2^21 samples, 8192 bins, 32 taps) 32 times the block
// from L2, 388.6 us of frame kernel in the direct mode and 559.95 in the
// rank-6 form (6 x 32 + 6 multiply-adds an output), against a 12.5 us
// bound (PERF.md).
//
// What bounds it on the H100: its bytes, each sample read once and each
// output written once (33.5 MB each way at the wideband shape: 20 us at
// 3.35 TB/s); its operations (4 ntaps flops an output, 8 us there) are
// below that.  Design: a thread owns one bin and kFirFrames consecutive
// frames; it walks the kFirFrames + ntaps - 1 rows those frames read once,
// down its bin's column, in a ring of kFirFrames registers, and adds each
// row to the kFirFrames accumulators it belongs to, a tap weight a row
// (static ring indices: the tap loop unrolled by kFirFrames).  Rows come
// kFirLoads at a time with their weights, so a thread keeps that many loads
// in flight; a CTA is kFirThreads consecutive bins (coalesced rows), the
// grid (nbins / kFirThreads, frame chunks, nch) fills every SM at the
// deep CLI block (256 CTAs) and the wideband one (2048).  Rows beyond the
// last frame's are read at the last row's address and feed only frames past
// the end, which are not written.  The two-pass loaders' block means are
// staged in shared memory (the blocks one chunk's rows lie in).
// Measured on an H100 at 700 W (PERF.md): 52.8 us at the wideband block
// (int8 55.9), 49.0 us for the deep CLI block's 8 blocks, against the 20 us
// bound; the frame kernel behind it 87 us where the tap loop took 388.6
// (direct) and 559.95 (rank 6).  What is left is the bookkeeping around
// each row's 32 multiply-adds.  Forms measured against this one in one
// process and dropped (wideband c64 / int8 FIR us): each row's address
// and block formed anew, a 64-bit division a row, 93.8 / 108.7 (the
// cursors and the one-block fast path took it to 52.8 / 55.9); the next
// kFirLoads rows prefetched into a second staging array (150-168
// registers) 106.9 / 142.9 against 93.3 / 105.9; 16 rows a round trip
// 94.4 / 136.7; 8 frames a thread 66.0 / 86.2 against 77.2 / 83.1 (more
// CTAs, 2.4x the rows read); 256 threads a CTA, no change.
constexpr int kFirThreads = 128;
constexpr int kFirFrames = 16;
constexpr int kFirLoads = 8;
constexpr int kFirMaxMeans = 256;

// One thread's kFirFrames FIR outputs at bin: the rows its frames read,
// in order, from fetch() (the raw sample) and correct(raw) (its value),
// each fetched and corrected once.  Tap t: row t + kFirFrames - 1 of the
// chunk into ring slot (t - 1) mod kFirFrames (its row t - 1 was last read
// at tap t - 1), then frame f adds w[t] times slot (t + f) mod kFirFrames,
// its row f + t, in tap order; kFirLoads rows' loads (and their weights')
// are issued before their adds.
template <class Fetch, class Correct>
__device__ __forceinline__ void fir_taps(float2 (&acc)[kFirFrames],
                                         const float* __restrict__ w, int bin,
                                         int nbins, int ntaps, Fetch fetch,
                                         Correct correct) {
  using T = decltype(fetch());
  float2 ring[kFirFrames];
#pragma unroll
  for (int f = 0; f < kFirFrames; ++f) acc[f] = make_float2(0.f, 0.f);
#pragma unroll
  for (int f = 0; f + 1 < kFirFrames; ++f) ring[f] = correct(fetch());
  for (int t0 = 0; t0 < ntaps; t0 += kFirFrames) {
#pragma unroll
    for (int d0 = 0; d0 < kFirFrames; d0 += kFirLoads) {
      T raw[kFirLoads];
      float wt[kFirLoads];
#pragma unroll
      for (int u = 0; u < kFirLoads; ++u) {
        const int t = t0 + d0 + u;
        if (t < ntaps) {
          raw[u] = fetch();
          wt[u] = __ldg(w + static_cast<long long>(t) * nbins + bin);
        }
      }
#pragma unroll
      for (int u = 0; u < kFirLoads; ++u) {
        const int d = d0 + u;
        if (t0 + d < ntaps) {
          ring[(d + kFirFrames - 1) % kFirFrames] = correct(raw[u]);
#pragma unroll
          for (int f = 0; f < kFirFrames; ++f) {
            const float2 x = ring[(d + f) % kFirFrames];
            acc[f].x += wt[u] * x.x;
            acc[f].y += wt[u] * x.y;
          }
        }
      }
    }
  }
}

template <class Rows>
__global__ void __launch_bounds__(kFirThreads)
fir_rows_kernel(Rows rows, const float* __restrict__ w,
                float2* __restrict__ fir, int ntaps, long long frames,
                int parts) {
  using T = typename Rows::T;
  __shared__ float2 means[Rows::kRaw ? 1 : kFirMaxMeans];
  const int nbins = rows.nbins;
  const int halo = rows.halo;
  const int bin = blockIdx.x * kFirThreads + threadIdx.x;
  const int c = blockIdx.z;
  const long long g0 = static_cast<long long>(blockIdx.y) * kFirFrames;
  const long long e_last = frames + halo - 1;   // the last merged row
  // the blocks this chunk's rows lie in (two-pass loaders only)
  const long long j_lo = g0 < halo ? 0 : (g0 - halo) / rows.S;
  if constexpr (!Rows::kRaw) {
    const long long e_hi = min(g0 + kFirFrames + ntaps - 2, e_last);
    const int n_means =
        e_hi < halo ? 0
                    : static_cast<int>((e_hi - halo) / rows.S - j_lo + 1);
    for (int i = threadIdx.x; i < n_means; i += kFirThreads) {
      means[i] = rows.mean(static_cast<int>(j_lo + i), c, parts);
    }
    __syncthreads();
  }
  const float2 mh = rows.history_mean(c);
  const T* const x_row0 = rows.sample_ptr(c, halo, bin);
  const long long e_end = g0 + kFirFrames + ntaps - 2;   // the chunk's last
  // The common chunk lies in one block's rows and before the last row: its
  // rows are read by stepping a pointer and all lose one mean.  The first
  // chunk (history rows), the last one (rows past the end) and a two-pass
  // chunk across blocks step cursors that say where each row comes from
  // and which mean it loses.
  const bool fast =
      g0 >= halo && e_end <= e_last &&
      (Rows::kRaw || (g0 - halo) / rows.S == (e_end - halo) / rows.S);
  float2 acc[kFirFrames];
  if (fast) {
    float2 mu = make_float2(0.f, 0.f);
    if constexpr (!Rows::kRaw) mu = means[0];
    const T* pf = x_row0 + (g0 - halo) * nbins;
    fir_taps(acc, w, bin, nbins, ntaps,
             [&]() {
               const T q = __ldg(pf);
               pf += nbins;
               return q;
             },
             [&](T q) { return rows.block_value(q, mu); });
  } else {
    // the fetch cursor: past the last row it stays there (the rows it then
    // reads feed only frames past the end, which are not written)
    long long ef = g0;
    const T* pf = g0 < halo ? rows.history_ptr(c, g0, bin)
                            : x_row0 + (g0 - halo) * nbins;
    // the correction cursor: row ec, its block jr and its rows from ec on
    long long ec = g0;
    int jr = 0, left = rows.S;
    if (g0 >= halo) {
      jr = static_cast<int>((g0 - halo) / rows.S);
      left = rows.S - static_cast<int>((g0 - halo) -
                                       static_cast<long long>(jr) * rows.S);
    }
    fir_taps(acc, w, bin, nbins, ntaps,
             [&]() {
               const T q = __ldg(pf);
               if (ef < e_last) {
                 ++ef;
                 pf = ef == halo ? x_row0 : pf + nbins;
               }
               return q;
             },
             [&](T q) {
               float2 v;
               if (ec < halo) {
                 v = rows.history_value(q, mh);
               } else {
                 float2 mu = make_float2(0.f, 0.f);
                 if constexpr (!Rows::kRaw) mu = means[jr - j_lo];
                 v = rows.block_value(q, mu);
               }
               if (ec < e_last) {
                 if (ec >= halo && --left == 0) {
                   ++jr;
                   left = rows.S;
                 }
                 ++ec;
               }
               return v;
             });
  }
  float2* o = fir + (c * frames + g0) * nbins + bin;
#pragma unroll
  for (int f = 0; f < kFirFrames; ++f) {
    if (g0 + f < frames) o[static_cast<long long>(f) * nbins] = acc[f];
  }
}

// The FIR launch before a deep-tap frame kernel on `st`: rows of nch
// channels over K blocks of S frames, w [ntaps, nbins], fir [nch, K S,
// nbins].  A two-pass loader's means must be formed before it (the mean
// pre-pass).  Refuses a shape whose chunk spans more blocks than it stages
// means for (fx_fused.deep_fir keeps to it).
template <class Rows>
cudaError_t launch_fir_rows(const Rows& rows, const void* w, void* fir,
                            int nch, int K, int S, int nbins, int ntaps,
                            int parts, cudaStream_t st) {
  const long long frames = static_cast<long long>(K) * S;
  if (nbins % kFirThreads != 0 || ntaps < 1 ||
      (kFirFrames + ntaps - 2) / S + 2 > kFirMaxMeans) {
    return cudaErrorInvalidValue;
  }
  const long long chunks = (frames + kFirFrames - 1) / kFirFrames;
  if (chunks > 65535 || nch > 65535) return cudaErrorInvalidValue;
  fir_rows_kernel<Rows><<<dim3(nbins / kFirThreads,
                               static_cast<unsigned>(chunks), nch),
                          kFirThreads, 0, st>>>(
      rows, static_cast<const float*>(w), static_cast<float2*>(fir), ntaps,
      frames, parts);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Which CTAs run a frame group, and which channels and bins each owns.
//
// The output policies that form products across channels (CrossOut,
// PartsOut) run a frame group on a cluster of csize = min(2, nch) CTAs:
// grid (n_groups * csize, 1, K).  CTA r of the cluster runs the FIR and the
// FFT of channels r, r + csize, ... into its own slots (slot c / csize of
// CTA c mod csize holds channel c's spectrum); after a cluster barrier it
// forms the cross power of every pair over bins [r, r + 1) * nbins / csize,
// reading the partner's spectra through distributed shared memory, and T,
// GJ and the sample sums of its own channels; a second cluster barrier
// comes before any CTA overwrites or leaves a slot its partner reads.  The
// spectra never leave the cluster's shared memory.  The one-slot policies
// (SpecOut, WideOut), which keep no state across channels, run one channel
// a CTA: grid (n_groups, nch, K), no partner.  fx_fused.frame_ctas is the
// same split in Python.
struct Cta {
  int k;          // the CTA's block
  int group;      // its frame group within the block
  int rank;       // its rank in the cluster
  int csize;      // the cluster's CTAs (1 or 2)
  int c0, cstep;  // its channels: c0, c0 + cstep, ... < nch
  long long part; // its group's slice of the partials: k * n_groups + group
};

struct ClusterCtas {
  static constexpr bool kCluster = true;
  __host__ __device__ static int cluster_size(int nch) {
    return nch >= 2 ? 2 : 1;
  }
  __host__ __device__ static int slots(int nch, int csize) {
    return (nch + csize - 1) / csize;
  }
  __device__ static Cta cta(int) {
    cg::cluster_group cl = cg::this_cluster();
    const int csize = static_cast<int>(cl.num_blocks());
    const int rank = static_cast<int>(cl.block_rank());
    const int group = static_cast<int>(blockIdx.x) / csize;
    return Cta{static_cast<int>(blockIdx.z), group, rank, csize, rank, csize,
               static_cast<long long>(blockIdx.z) * (gridDim.x / csize) +
                   group};
  }
};

struct ChannelCtas {
  static constexpr bool kCluster = false;
  __host__ __device__ static int cluster_size(int) { return 1; }
  __host__ __device__ static int slots(int, int) { return 1; }
  __device__ static Cta cta(int nch) {
    return Cta{static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.x), 0,
               1, static_cast<int>(blockIdx.y), nch,
               static_cast<long long>(blockIdx.z) * gridDim.x + blockIdx.x};
  }
};

// Channel c's spectrum in a cluster: in this CTA's slots (own) or the
// partner's (other), slot c / csize.
__device__ __forceinline__ const float2* channel_spec(const float2* own,
                                                      const float2* other,
                                                      const Cta& cta, int c,
                                                      int nbins) {
  const int shift = cta.csize - 1;   // csize is 1 or 2
  const float2* base = (c & shift) == cta.rank ? own : other;
  return base + static_cast<size_t>(c >> shift) * nbins;
}

// The partner CTA's slots, mapped into this CTA's view of distributed
// shared memory (a cluster of one has no partner: its own).
__device__ __forceinline__ const float2* partner_spec(float2* spec,
                                                      const Cta& cta) {
  if (cta.csize == 1) return spec;
  return cg::this_cluster().map_shared_rank(spec, cta.rank ^ 1);
}

// The cross power of every pair over this CTA's bins of the frame, added
// to rows 0 .. nbl-1 of out [rows, nbins] (written at the group's first
// frame): each element is owned by one thread, no atomics.  CTA r of the
// cluster takes bins [r, r + 1) * nbins / csize: by shifts at a power of
// two (log2n, fft_log2), by division at any other bin count (kMixed; nbins
// is even).
template <bool kMixed>
__device__ __forceinline__ void cross_power(const float2* spec,
                                            const float2* other,
                                            const Cta& cta,
                                            const int* __restrict__ pairs,
                                            float2* out, int nbl, int nbins,
                                            int log2n, bool first) {
  const int part = nbins >> (cta.csize - 1);   // csize is 1 or 2
  const int hbits = log2n - (cta.csize - 1);   // unused where kMixed
  const int bin0 = cta.rank * part;
  const int n_pairs = kMixed ? nbl * part : nbl << hbits;
  for (int idx = threadIdx.x; idx < n_pairs; idx += kThreads) {
    const int2 lb = split_bins<kMixed>(idx, part, hbits);
    const int l = lb.x;
    const int bin = bin0 + lb.y;
    const int p = __ldg(pairs + 2 * l);
    const int q = __ldg(pairs + 2 * l + 1);
    const float2 v = cmulconj(channel_spec(spec, other, cta, p, nbins)[bin],
                              channel_spec(spec, other, cta, q, nbins)[bin]);
    const size_t o = static_cast<size_t>(l) * nbins + bin;
    out[o] = first ? v : cadd(out[o], v);
  }
}

// Output policies.  CrossOut keeps every channel's spectrum of the frame
// in the cluster's shared memory and, once all are done, adds the cross
// power of every pair to its group's slice of `partial`.  SpecOut keeps one
// spectrum and writes each to spec[c, f, :] as it is done.  PartsOut
// (further down) is CrossOut over raw rows plus the DC accumulators.
struct CrossOut {
  using Ctas = ClusterCtas;
  static constexpr bool kParts = false;
  template <class Rows>
  using Sum = NoSum;
  const int* pairs;
  float2* partial;   // [K, n_groups, nbl, nbins]
  int nbl;

  __device__ void channel_done(const float2*, const Cta&, int, int,
                               int) const {}
  template <bool kMixed>
  __device__ void frame_done(float2* spec, const Cta& cta, int nch, int f,
                             int f0, int nbins, int log2n) const {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();   // every channel's spectrum of frame f is done
    cross_power<kMixed>(spec, partner_spec(spec, cta), cta, pairs,
                        partial + cta.part * nbl * nbins, nbl, nbins, log2n,
                        f == f0);
    cl.sync();   // the partner has read them: they may be overwritten
  }
  // kStageFft's output: bin threadIdx.x of every channel's spectrum summed
  // (in channel order) by the cluster's first CTA into element threadIdx.x
  // of the group's partial, and nothing else.
  __device__ void touch(float2* spec, const Cta& cta, int nch, int f,
                        int f0, int nbins) const {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (cta.rank == 0) {
      const float2* other = partner_spec(spec, cta);
      float2* out = partial + cta.part * nbl * nbins;
      float2 v = channel_spec(spec, other, cta, 0, nbins)[threadIdx.x];
      for (int c = 1; c < nch; ++c) {
        v = cadd(v, channel_spec(spec, other, cta, c, nbins)[threadIdx.x]);
      }
      out[threadIdx.x] = (f == f0) ? v : cadd(out[threadIdx.x], v);
    }
    cl.sync();
  }
};

struct SpecOut {
  using Ctas = ChannelCtas;
  static constexpr bool kParts = false;
  template <class Rows>
  using Sum = NoSum;
  float2* spec_out;   // [nch, S, nbins]
  int S;

  __device__ void channel_done(const float2* own, const Cta&, int c, int f,
                               int nbins) const {
    float2* out = spec_out + (static_cast<size_t>(c) * S + f) * nbins;
    for (int bin = threadIdx.x; bin < nbins; bin += kThreads) {
      out[bin] = own[bin];
    }
  }
  template <bool kMixed>
  __device__ void frame_done(float2*, const Cta&, int, int, int, int,
                             int) const {
    __syncthreads();  // the next frame's FIR overwrites the slot
  }
};

// PartsOut, the single-pass policy (the TPU kernel's tout_ref, uout_ref and
// sout_ref): over spectra of the raw rows, the group's slice of `partial`
// [K, n_groups, nbl + 2 nch, nbins] takes the cross power of every pair
// (rows 0 .. nbl-1, as CrossOut), T_c = the sum of the group's frames'
// spectra of channel c (rows nbl + c) and, in a group that holds frames j <
// halo of its block, GJ_c = the sum over those of spec_c[j] conj(dA[j])
// (rows nbl + nch + c; groups that start at or after frame halo leave
// theirs unwritten and the reduce never reads them); each CTA of the
// cluster writes T and GJ of its own channels.  A block's first halo frames
// may share a group with later ones (frames in groups) and at deep taps
// nearly every frame is one; each is tested by its own index.  The sample
// sums of the group's frames' newest rows leave as sums[k, group, c].  T is
// read, added to and written per frame, like the cross power; it is linear
// in the FIR output, so one more FFT over the summed FIR outputs would do,
// at the price of more rows of shared memory.
template <typename T>
struct PartsOut {
  using Ctas = ClusterCtas;
  static constexpr bool kParts = true;
  template <class Rows>
  using Sum = RowSum<Rows>;
  using Pair = typename SumOf<T>::pair;
  const int* pairs;
  float2* partial;   // [K, n_groups, nbl + 2 nch, nbins]
  const float2* da;  // [halo, nbins]
  Pair* sums;        // [K, n_groups, nch]
  int nbl, nch, halo;

  __device__ void channel_done(const float2*, const Cta&, int, int,
                               int) const {}
  __device__ void zero_sums(Pair* wsum) const {
    for (int i = threadIdx.x; i < nch * kWarps; i += kThreads) {
      wsum[i] = Pair{0, 0};
    }
  }
  template <bool kMixed>
  __device__ void frame_done(float2* spec, const Cta& cta, int, int f,
                             int f0, int nbins, int log2n) const {
    cg::cluster_group cl = cg::this_cluster();
    float2* out = partial + cta.part * (nbl + 2 * nch) * nbins;
    const bool first = f == f0;
    cl.sync();   // every channel's spectrum of frame f is done
    cross_power<kMixed>(spec, partner_spec(spec, cta), cta, pairs, out, nbl,
                        nbins, log2n, first);
    // T and GJ of the CTA's own channels, from its own slots
    const int nlocal = (nch - cta.c0 + cta.cstep - 1) / cta.cstep;
    const int n_own = kMixed ? nlocal * nbins : nlocal << log2n;
    float2* tsum = out + static_cast<size_t>(nbl) * nbins;
    for (int idx = threadIdx.x; idx < n_own; idx += kThreads) {
      const int2 cb = split_bins<kMixed>(idx, nbins, log2n);
      const int c = cta.c0 + cb.x * cta.cstep;
      const size_t o = static_cast<size_t>(c) * nbins + cb.y;
      tsum[o] = first ? spec[idx] : cadd(tsum[o], spec[idx]);
    }
    if (f < halo) {   // then f0 < halo too: the group's first frame wrote gj
      float2* gj = tsum + static_cast<size_t>(nch) * nbins;
      const float2* dj = da + static_cast<size_t>(f) * nbins;
      for (int idx = threadIdx.x; idx < n_own; idx += kThreads) {
        const int2 cb = split_bins<kMixed>(idx, nbins, log2n);
        const int c = cta.c0 + cb.x * cta.cstep;
        const int bin = cb.y;
        const size_t o = static_cast<size_t>(c) * nbins + bin;
        const float2 v = cmulconj(spec[idx], __ldg(dj + bin));
        gj[o] = first ? v : cadd(gj[o], v);
      }
    }
    cl.sync();   // the partner has read this CTA's spectra
  }
  // the warps' sample sums of each of the CTA's channels, in warp order
  __device__ void cta_done(const Pair* wsum, const Cta& cta) const {
    for (int c = cta.c0 + threadIdx.x * cta.cstep; c < nch;
         c += kThreads * cta.cstep) {
      Pair acc = wsum[c * kWarps];
      for (int w = 1; w < kWarps; ++w) {
        acc.x += wsum[c * kWarps + w].x;
        acc.y += wsum[c * kWarps + w].y;
      }
      sums[cta.part * nch + c] = acc;
    }
  }
};

// WideOut, the single pass where a frame's spectra of all channels do not
// fit in shared memory together (the wide route, fxt_fx_wide_frames): one
// slot, as SpecOut, one channel a CTA, each spectrum written to the device
// scratch spec [K, nch, S, nbins] as it is done, and PartsOut's sample
// sums (sums[k, group, c], each written by its channel's CTA); the cross
// power, T and GJ are formed from the scratch by the X kernel
// (fx_xstage.cu).  Not a PartsOut in the shared route's sense: only
// PartsOut's sample-sum members are used.  Above kFftMaxSub bins in the
// direct FIR mode its frames run fx_wide_halves_kernel (b2) instead.
template <typename T>
struct WideOut : PartsOut<T> {
  using Ctas = ChannelCtas;
  float2* spec_out;   // [K, nch, S, nbins]
  int S;

  __device__ void channel_done(const float2* own, const Cta& cta, int c,
                               int f, int nbins) const {
    float2* out = spec_out +
                  ((static_cast<size_t>(cta.k) * this->nch + c) * S + f) *
                      nbins;
    for (int bin = threadIdx.x; bin < nbins; bin += kThreads) {
      out[bin] = own[bin];
    }
  }
  template <bool kMixed>
  __device__ void frame_done(float2*, const Cta&, int, int, int, int,
                             int) const {
    __syncthreads();  // the next frame's FIR overwrites the slot
  }
};

// (b2) The wide route's frames above kFftMaxSub bins in the direct FIR mode
// (fxt_fx_wide_frames at 12,288 to 16,384 bins): a frame group of one
// channel on a cluster of two CTAs, CTA r holding half r of the frame,
// its samples of parity r (fft_slot's halves), each half's n / 2-point
// sequence of fft_stockham on its own SM.  Per frame: the FIR of bins [r,
// r + 1) n / 2 in natural order into the CTA's slot (the tap loop of
// DirectFir, the newest row to the sample sums), a cluster barrier, the
// slot gathered to its parity (point i is bin 2 i + r, read from either
// CTA's slot through distributed shared memory and held across a second
// barrier), the half's FFT, a barrier, then the radix-2 combine of bins
// [r, r + 1) n / 4 and the same + n / 2, written to the scratch spec, and
// a barrier before the next frame's FIR overwrites a slot the partner
// reads.  The spectra are the one-CTA kernel's (the same FIR, passes and
// combine; only where each runs moves); the sample sums are added per CTA
// and then CTA 0's warps before CTA 1's.  Dynamic shared memory: the slot
// [n / 2] float2, the twiddle table [n / 2] and the warps' sums.
// Replaces: _fx_kernel's frames (fxtpu/ops/pfb_pallas.py) at the bin counts
// above 8192 that _kernel_factor (:75-81) takes, on the wide route.  What
// bounds it on the H100: latency, not bytes (a 2 x 2^18 block's 4.2 MB in
// and 4.2 MB of spectra out are 2.5 us): at 12,288 to 16,384 bins a frame
// kernel's CTA holds a whole spectrum and the table (195 KB at 16,256), so
// one CTA an SM ran one frame-channel, and the block's 32 of them left 100
// of 132 SMs idle; this runs 64 CTAs, each with half the frame's work
// (16,256 bins: 162 -> 88 us of frames; PERF.md).
constexpr int kHalfHold = kFftMaxSub / kThreads;   // gathered points a thread

template <class Rows>
__global__ void __launch_bounds__(kThreads, 1)
fx_wide_halves_kernel(Rows rows, const float* __restrict__ w,
                      WideOut<typename Rows::T> out,
                      const float2* __restrict__ tw, int nch, int S,
                      int nbins, int ntaps, int frames_per_group) {
  using Pair = typename SumOf<typename Rows::T>::pair;
  constexpr int kBins = DirectFir::kBins;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int group = static_cast<int>(blockIdx.x) >> 1;
  const int c = blockIdx.y;
  const int kb = blockIdx.z;
  const int tid = threadIdx.x;
  const int half = nbins >> 1;
  const int quarter = nbins >> 2;
  float2* slot = fx_smem;
  float2* tw_s = fx_smem + half;
  Pair* wsum = reinterpret_cast<Pair*>(tw_s + half);   // [kWarps]
  const float2* other = cl.map_shared_rank(slot, rank ^ 1);
  for (int i = tid; i < half; i += kThreads) tw_s[i] = __ldg(tw + i);
  if (tid < kWarps) wsum[tid] = Pair{0, 0};
  __syncthreads();
  const int halo = ntaps - 1;
  const RowMeans m{make_float2(0.f, 0.f), halo, nullptr, 0, nch};
  const int f0 = group * frames_per_group;
  const int f1 = min(f0 + frames_per_group, S);
  const int lo = rank * half;
  for (int f = f0; f < f1; ++f) {
    const long long e0 = static_cast<long long>(kb) * S + f;
    RowSum<Rows> sum(rows);
    for (int b0 = lo + tid; b0 < lo + half; b0 += kBins * kThreads) {
      const int nb = min(kBins, (lo + half - b0 + kThreads - 1) / kThreads);
      float2 acc[kBins];
#pragma unroll
      for (int j = 0; j < kBins; ++j) acc[j] = make_float2(0.f, 0.f);
      for_each_tap<kBins, 1>(rows, c, e0, b0, nb, m, ntaps,
                             [&](int t, const float2* v) {
        const float* wt = w + t * nbins + b0;
        if (t == ntaps - 1) sum.template add<kBins>(v, nb);
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
        if (j < nb) slot[b0 + j * kThreads - lo] = acc[j];
      }
    }
    sum.flush(wsum, 0);
    cl.sync();   // both CTAs' FIR outputs, natural order
    float2 v[kHalfHold];
#pragma unroll
    for (int p = 0; p < kHalfHold; ++p) {
      const int i = tid + p * kThreads;
      if (i < half) {
        const int b = 2 * i + rank;
        v[p] = ((b >= half) == (rank == 1) ? slot : other)[b >= half ? b - half
                                                                      : b];
      }
    }
    cl.sync();   // every read of the natural order is done
#pragma unroll
    for (int p = 0; p < kHalfHold; ++p) {
      const int i = tid + p * kThreads;
      if (i < half) slot[i] = v[p];
    }
    __syncthreads();
    fft_stockham(0, half, half, 2, half);
    cl.sync();   // both halves' DFTs are done
    const float2* even = rank == 0 ? slot : other;
    const float2* odd = rank == 0 ? other : slot;
    float2* spec = out.spec_out +
                   ((static_cast<size_t>(kb) * nch + c) * S + f) * nbins;
    for (int k = rank * quarter + tid; k < (rank + 1) * quarter;
         k += kThreads) {
      const float2 a = even[k];
      const float2 b = cmul(odd[k], tw_s[k]);
      spec[k] = cadd(a, b);
      spec[k + half] = csub(a, b);
    }
    cl.sync();   // the partner has read this CTA's slot
  }
  // the sample sums of the group's frames: CTA 0's warps, then CTA 1's
  if (rank == 0 && tid == 0) {
    const Pair* ow = cl.map_shared_rank(wsum, 1);
    Pair acc = wsum[0];
    for (int i = 1; i < 2 * kWarps; ++i) {
      const Pair p = i < kWarps ? wsum[i] : ow[i - kWarps];
      acc.x += p.x;
      acc.y += p.y;
    }
    out.sums[(static_cast<long long>(kb) * gridDim.x / 2 + group) * nch + c] =
        acc;
  }
  cl.sync();   // CTA 1 stays until CTA 0 has read its sums
}

// (b) The frame kernel: a frame group of one block on one CTA or a cluster
// of two (see Cta above), block k = blockIdx.z.  Dynamic shared memory:
//   spec  [slots][nbins] float2 — the CTA's spectra of the frame (a
//                                 cluster policy's own channels; one for
//                                 SpecOut and WideOut); each slot is its
//                                 FFT's only buffer
//   tw    [nbins / 2]    float2 — the FFT's twiddle table, staged once
//   mean  [chan_slots][nch] float2 — the means of blocks jlo .. k, the
//                                 blocks the CTA's rows lie in (chan_slots
//                                 of them); PartsOut stages no means and
//                                 keeps its warps' sample sums there
//   tab   [table_bytes]         — a FIR policy's table (none for the two
//                                 here)
// For each frame and each of the CTA's channels: the FIR over ntaps rows of
// [history; x] (read through `rows`) into the channel's slot, the FFT in
// place there, then the output policy.  The FFT is radix 16 at a power of
// two in [256, 8192] (log2n = log2 nbins); every other bin count runs the
// kMixed instance (log2n -1): fft_mixed, the FIR's output stored at
// fft_slot's places, and a frame's bins split by division.  Stage
// truncates the frame
// for the ablation (kStageFull: nothing is truncated; every branch on Stage
// is an `if constexpr`, so that instantiation is the production code).
template <class Rows, class Fir, class Out, int Stage = kStageFull,
          bool kMixed = false>
__global__ void __launch_bounds__(kThreads, 2)
fx_frames_kernel(Rows rows, Fir fir, Out out, const float2* __restrict__ tw,
                 int nch, int S, int nbins, int log2n, int ntaps,
                 int frames_per_group, int parts, int chan_slots) {
  const Cta cta = Out::Ctas::cta(nch);
  float2* spec = fx_smem;
  const int tw_off = Out::Ctas::slots(nch, cta.csize) * nbins;
  float2* tw_s = fx_smem + tw_off;
  float2* mean_s = tw_s + (nbins >> 1);
  float* tab = reinterpret_cast<float*>(mean_s + chan_slots * nch);
  using Sum = typename Out::template Sum<Rows>;
  const int tid = threadIdx.x;
  const int kb = cta.k;  // this CTA's block
  const int halo = ntaps - 1;
  // the first block any of this block's frames reads a row of
  const long long g_min = static_cast<long long>(kb) * S - halo;
  const int jlo = g_min <= 0 ? 0 : static_cast<int>(g_min / S);

  fir.stage(tab, ntaps);
  for (int i = tid; i < (nbins >> 1); i += kThreads) tw_s[i] = __ldg(tw + i);
  if constexpr (Out::kParts) {
    static_assert(Rows::kRaw, "PartsOut runs over raw rows");
    out.zero_sums(reinterpret_cast<typename Out::Pair*>(mean_s));
  } else {
    for (int i = tid; i < (kb - jlo + 1) * nch; i += kThreads) {
      mean_s[i] = rows.mean(jlo + i / nch, i % nch, parts);
    }
  }
  __syncthreads();

  const int f0 = cta.group * frames_per_group;
  const int f1 = min(f0 + frames_per_group, S);
  const long long e_own = static_cast<long long>(kb) * S + halo;
  const int npasses = fft_passes<Stage>(log2n);

  for (int f = f0; f < f1; ++f) {
    const long long e0 = static_cast<long long>(kb) * S + f;
    for (int c = cta.c0, li = 0; c < nch; c += cta.cstep, ++li) {
      float2* own = spec + static_cast<size_t>(li) * nbins;
      // raw rows lose no mean: every block row runs as the CTA's own
      const RowMeans m =
          Out::kParts
              ? RowMeans{make_float2(0.f, 0.f), halo, nullptr, 0, nch}
              : RowMeans{mean_s[(kb - jlo) * nch + c], e_own, mean_s + c,
                         jlo, nch};
      Sum sum(rows);
      if constexpr (Stage == kStageLoad) {
        tap_sum<Fir::kBins, Fir::kTaps>(rows, c, e0, m, ntaps, nbins, own);
      } else if constexpr (Stage == kStageLoadRaw) {
        tap_sum<Fir::kBins, Fir::kTaps>(RawRows<Rows>{rows}, c, e0, m, ntaps,
                                        nbins, own);
      } else {
        fir.template run<kMixed>(rows, tab, c, e0, m, ntaps, nbins, own,
                                 sum);
      }
      if constexpr (Out::kParts) {
        sum.flush(reinterpret_cast<typename Out::Pair*>(mean_s), c);
      }
      __syncthreads();
      if constexpr (Stage != kStageLoad && Stage != kStageLoadRaw &&
                    Stage != kStageFir) {
        if constexpr (kMixed) {
          fft_mixed(li * nbins, tw_off, nbins);
        } else {
          fft_inplace(li * nbins, tw_off, log2n, npasses);
        }
      }
      out.channel_done(own, cta, c, f, nbins);
    }
    if constexpr (Stage == kStageFft) {
      out.touch(spec, cta, nch, f, f0, nbins);
    } else {
      out.template frame_done<kMixed>(spec, cta, nch, f, f0, nbins, log2n);
    }
  }
  if constexpr (Out::kParts) {
    out.cta_done(reinterpret_cast<const typename Out::Pair*>(mean_s), cta);
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

// (c) single pass: the partials of every row of parts [K, nbl + 2 nch,
// nbins] summed over the block's groups in a fixed order (the GJ rows over
// the first n_gj groups, the ones that hold frames j < halo); mu [K, nch]
// from the groups' sample sums (complex64: the double sum over n, rounded
// once; int8: the exact integer sum over n times the step, formed in
// double and rounded once, as fx_fused.block_mean_i8 forms it); and the
// new history from the last block's last halo rows: complex64 minus that
// block's mean (hout_ref's contract), int8 as they arrived (new_hist is
// then char2 [nch, halo, nbins]).  fxt_fx_parts launches it after its
// frame kernel, fxt_parts_reduce alone.
//
// Replaces the TPU kernel's grid-carried sums: _fx_kernel's tout_ref and
// uout_ref accumulate across its sequential grid (pfb_pallas.py:993-1076);
// here the frame groups' CTAs run at once and leave one partial each.
//
// What bounds it on the H100: its bytes, each read or written once (a
// flagship block: xp and T of 64 groups, GJ of 3, the history rows in and
// out, the parts out: 7.05 MB, 2.1 us at 3.35 TB/s; the pipeline block's
// 256 groups 25.9 MB, 7.7 us).  Every element is one chain of float32 adds
// in group order, g = 0 first (the bits K one-block launches and the plain
// version parts_reduce_reference give), so the latency of each partial's
// load is the problem, not the adds.  Design: a thread owns one element
// and keeps two batches of kReduceBatch groups' loads in flight (the next
// batch issued before the adds of this one); CTAs of kReduceThreads
// threads, so a flagship block's 12,288 elements of full rows are 192 CTAs
// on 132 SMs; the GJ rows (n_gj groups) take a range of CTAs of their own,
// so no warp mixes 64-group and 3-group chains; mu takes one CTA range and
// the history another, with no partial to sum (grid (full + gj + mu +
// history CTAs, K); the history CTAs of blocks k < K-1 return at once),
// each mean formed by one warp from 32 groups' sums a load
// (warp_block_mean).
constexpr int kReduceThreads = 64;
constexpr int kReduceWarps = kReduceThreads / 32;
constexpr int kReduceBatch = 32;
constexpr int kHistPerThread = 8;

// p[0] + p[stride] + ... + p[(ng - 1) stride], added in that order, with
// the loads of the next kReduceBatch groups issued before the adds of
// these.
__device__ __forceinline__ float2 sum_groups(const float2* __restrict__ p,
                                             long long stride, int ng) {
  float2 cur[kReduceBatch];
#pragma unroll
  for (int j = 0; j < kReduceBatch; ++j) {
    cur[j] = j < ng ? __ldg(p + j * stride) : make_float2(0.f, 0.f);
  }
  float2 acc = cur[0];
  for (int g0 = 0; g0 < ng; g0 += kReduceBatch) {
    float2 nxt[kReduceBatch];
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j) {
      const int g = g0 + kReduceBatch + j;
      nxt[j] = g < ng ? __ldg(p + g * stride) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j) {
      const int g = g0 + j;
      if (g > 0 && g < ng) acc = cadd(acc, cur[j]);
    }
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j) cur[j] = nxt[j];
  }
  return acc;
}

// The CTAs of each range of the reduce's grid (one block's share).
struct ReduceGrid {
  int full, gj, mu, hist;
  __host__ __device__ ReduceGrid(int nbl, int nch, int nbins, int halo)
      : full(ceil_div(static_cast<long long>(nbl + nch) * nbins,
                      kReduceThreads)),
        gj(ceil_div(static_cast<long long>(nch) * nbins, kReduceThreads)),
        mu(ceil_div(nch, kReduceWarps)),
        hist(ceil_div(static_cast<long long>(nch) * halo * nbins,
                      kReduceThreads * kHistPerThread)) {}
  __host__ __device__ static int ceil_div(long long n, int d) {
    return static_cast<int>((n + d - 1) / d);
  }
};

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
fx_parts_reduce_kernel(const float2* __restrict__ partial,
                       const typename SumOf<T>::pair* __restrict__ sums,
                       const T* __restrict__ x, float2* __restrict__ parts,
                       float2* __restrict__ mu, T* __restrict__ new_hist,
                       int K, int S, int n_groups, int n_gj, int nbl, int nch,
                       int nbins, int halo, double step) {
  extern __shared__ float2 mu_last[];   // [nch]: the last block's means
  constexpr bool kC64 = sizeof(T) == sizeof(float2);
  const ReduceGrid grid(nbl, nch, nbins, halo);
  const int k = blockIdx.y;
  const long long n_full = static_cast<long long>(nbl + nch) * nbins;
  const long long n_block = n_full + static_cast<long long>(nch) * nbins;
  const long long n = static_cast<long long>(S) * nbins;
  int cta = blockIdx.x;
  // launched by a step as a dependent of the frame kernel: the partials and
  // sums are read only once it has completed; the epilogue may then be
  // scheduled behind this grid
  wait_for_predecessor();
  release_dependent();
  if (cta < grid.full + grid.gj) {
    // one element of block k's parts: xp and T over every group, GJ over
    // the first n_gj
    const bool full = cta < grid.full;
    const long long e =
        (full ? 0 : n_full)
        + static_cast<long long>(full ? cta : cta - grid.full)
              * kReduceThreads
        + threadIdx.x;
    if (e >= (full ? n_full : n_block)) return;
    parts[k * n_block + e] = sum_groups(
        partial + static_cast<long long>(k) * n_groups * n_block + e,
        n_block, full ? n_groups : n_gj);
    return;
  }
  cta -= grid.full + grid.gj;
  const int warp = threadIdx.x >> 5;
  if (cta < grid.mu) {
    // a warp a channel (warp_block_mean: 32 groups' sums a load)
    const int c = cta * kReduceWarps + warp;
    if (c < nch) {
      const float2 m = warp_block_mean<T>(
          sums + static_cast<size_t>(k) * n_groups * nch + c, n_groups, nch,
          n, step);
      if ((threadIdx.x & 31) == 0) mu[static_cast<size_t>(k) * nch + c] = m;
    }
    return;
  }
  cta -= grid.mu;
  if (k != K - 1) return;
  const long long n_hist = static_cast<long long>(nch) * halo * nbins;
  const long long stride =
      static_cast<long long>(grid.hist) * kReduceThreads;
  T v[kHistPerThread];
  long long idx[kHistPerThread];
#pragma unroll
  for (int j = 0; j < kHistPerThread; ++j) {
    idx[j] = static_cast<long long>(cta) * kReduceThreads + threadIdx.x
             + j * stride;
    if (idx[j] < n_hist) {
      const int bin = static_cast<int>(idx[j] % nbins);
      const int r = static_cast<int>((idx[j] / nbins) % halo);
      const int c =
          static_cast<int>(idx[j] / (static_cast<long long>(nbins) * halo));
      v[j] = x[(static_cast<long long>(c) * K + k) * n
               + static_cast<long long>(S - halo + r) * nbins + bin];
    }
  }
  // the rows' loads are in flight while the warps form the means
  if constexpr (kC64) {
    for (int c = warp; c < nch; c += kReduceWarps) {
      const float2 m = warp_block_mean<T>(
          sums + static_cast<size_t>(k) * n_groups * nch + c, n_groups, nch,
          n, step);
      if ((threadIdx.x & 31) == 0) mu_last[c] = m;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kHistPerThread; ++j) {
    if (idx[j] < n_hist) {
      if constexpr (kC64) {
        const int c = static_cast<int>(
            idx[j] / (static_cast<long long>(nbins) * halo));
        new_hist[idx[j]] = csub(v[j], mu_last[c]);
      } else {
        new_hist[idx[j]] = v[j];
      }
    }
  }
}

// The reduce of a single-pass step on `st` (fxt_fx_parts after its frame
// kernel, fxt_parts_reduce alone): partial [K, n_groups, nbl + 2 nch,
// nbins] float2, sums [K, n_groups, nch], x the step's samples [nch, K, S,
// nbins] -> parts [K, nbl + 2 nch, nbins], mu [K, nch], new_hist [nch,
// halo, nbins]; with `dependent` a programmatic dependent of the frame
// kernel (fx_step.cu's entries).  Returns the launch's error.
template <typename T>
cudaError_t launch_parts_reduce(const float2* partial,
                                const typename SumOf<T>::pair* sums,
                                const T* x, float2* parts, float2* mu,
                                T* new_hist, int K, int S, int n_groups,
                                int n_gj, int nbl, int nch, int nbins,
                                int halo, double step, bool dependent,
                                cudaStream_t st) {
  if (K < 1 || K > 65535 || S < 1 || nch < 1 || nbl < 0 || nbins < 1
      || n_groups < 1 || n_gj < 1 || n_gj > n_groups || halo < 1
      || halo > S) {
    return cudaErrorInvalidValue;
  }
  const ReduceGrid g(nbl, nch, nbins, halo);
  return launch_kernel(&fx_parts_reduce_kernel<T>,
                       dim3(g.full + g.gj + g.mu + g.hist, K),
                       dim3(kReduceThreads), nch * sizeof(float2), st,
                       dependent, partial, sums, x, parts, mu, new_hist, K,
                       S, n_groups, n_gj, nbl, nch, nbins, halo, step);
}

int reduce_blocks(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

// The frame kernel of any mode over K blocks, on `st`, with chan_slots
// float2 per channel of shared memory after the spectra; `pre` puts
// whatever must run before it on the stream (the two-pass entries' mean
// pre-pass).  A cluster policy launches clusters of Out::Ctas::cluster_size
// CTAs (cudaLaunchKernelEx); a refused launch returns its error, and
// nothing else is launched in its place.
template <int Stage = kStageFull, class Rows, class Fir, class Out,
          class Pre>
cudaError_t launch_frames(const Rows& rows, const Fir& fir, const Out& out,
                          const void* tw, int nch, int K, int S, int nbins,
                          int ntaps, int n_groups, int frames_per_group,
                          int parts, int chan_slots, cudaStream_t st,
                          Pre&& pre) {
  if (K < 1 || K > 65535 || S < 1) return cudaErrorInvalidValue;
  using Ctas = typename Out::Ctas;
  const int csize = Ctas::cluster_size(nch);
  const size_t smem =
      (static_cast<size_t>(Ctas::slots(nch, csize)) * nbins + (nbins >> 1) +
       static_cast<size_t>(nch) * chan_slots) *
          sizeof(float2) +
      fir.table_bytes(ntaps);
  // the radix-16 sizes' kernel, or its kMixed instance at every other bin
  // count (where the ablation runs its fir, fft and full stages only)
  const int log2n = fft_log2(nbins);
  auto* kernel = &fx_frames_kernel<Rows, Fir, Out, Stage>;
  if (log2n < 0) {
    if constexpr (Stage == kStageFull || Stage == kStageFir ||
                  Stage == kStageFft) {
      kernel = &fx_frames_kernel<Rows, Fir, Out, Stage, true>;
    } else {
      return cudaErrorInvalidValue;
    }
  }
  // A refused call's error is returned, and taken off the runtime's
  // last-error slot as well, so that the next launch's check in this
  // process does not report it again.
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  err = pre();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = Ctas::kCluster ? dim3(n_groups * csize, 1, K)
                               : dim3(n_groups, nch, K);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, rows, fir, out,
                           static_cast<const float2*>(tw), nch, S, nbins,
                           log2n, ntaps, frames_per_group, parts,
                           chan_slots);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

// Mean pre-pass and frame kernel of a two-pass mode.  A CTA stages the
// means of every block its rows lie in: at most ceil(halo / S) + 1 of
// them, and never more than K.
template <int Stage = kStageFull, typename T, class Rows, class Fir,
          class Out, class Pre>
cudaError_t launch_means_and_frames(const T* x, typename SumOf<T>::pair* sums,
                                    const Rows& rows, const Fir& fir,
                                    const Out& out, const void* tw, int nch,
                                    int K, int S, int nbins, int ntaps,
                                    int n_groups, int frames_per_group,
                                    int parts, cudaStream_t st, Pre&& pre) {
  if (K < 1 || S < 1) return cudaErrorInvalidValue;
  const int halo = ntaps - 1;
  const int mean_blocks = min(K, (halo + S - 1) / S + 1);
  return launch_frames<Stage>(
      rows, fir, out, tw, nch, K, S, nbins, ntaps, n_groups,
      frames_per_group, parts, mean_blocks, st, [&]() {
        mean_partial_kernel<T><<<dim3(parts, nch, K), kThreads, 0, st>>>(
            x, sums, rows.n, rows.stride);
        const cudaError_t err = cudaGetLastError();
        return err != cudaSuccess ? err : pre();
      });
}

// The frame kernel's FIR on `st`: with `fir` NULL the tap loop over w in
// the frame kernel (DirectFir); else, at deep taps, fir_rows_kernel into
// fir [nch, K S, nbins] first and RowsFir in the frame kernel.  w is the
// FIR's table [ntaps, nbins]: the window, or the SVD mode's folded factors.
// launch(fir_policy, pre) launches the frame kernel, running pre() (which
// launches what must precede the frame kernel) just before it.
template <class Rows, class Launch>
cudaError_t with_fir(const Rows& rows, const void* w, void* fir, int nch,
                     int K, int S, int nbins, int ntaps, int parts,
                     cudaStream_t st, Launch&& launch) {
  if (fir == nullptr) {
    return launch(DirectFir{static_cast<const float*>(w)},
                  []() { return cudaSuccess; });
  }
  return launch(
      RowsFir{static_cast<const float2*>(fir),
              static_cast<long long>(K) * S},
      [&]() {
        return launch_fir_rows(rows, w, fir, nch, K, S, nbins, ntaps, parts,
                               st);
      });
}

// The single-pass step over K blocks on `st`: the frame kernel over raw
// rows with PartsOut (no mean pre-pass; the FIR as with_fir says), then the
// reduce, with `dependent` as a programmatic dependent of the frame
// kernel.  The warps' sample sums take kWarps pairs per channel of shared
// memory, 2 kWarps float2 slots.
template <typename T, class Rows>
int fx_parts(const Rows& rows, const void* w, void* fir, const void* tw,
             const void* pairs, const void* da, void* sums, void* partial,
             void* parts, void* mu, void* new_hist, int nch, int K, int S,
             int nbins, int ntaps, int nbl, int n_groups,
             int frames_per_group, double step, bool dependent,
             cudaStream_t st) {
  using Pair = typename SumOf<T>::pair;
  static_assert(sizeof(Pair) == 2 * sizeof(float2), "two slots per pair");
  const int halo = ntaps - 1;
  if (halo < 1 || S < halo) return static_cast<int>(cudaErrorInvalidValue);
  const PartsOut<T> out{static_cast<const int*>(pairs),
                        static_cast<float2*>(partial),
                        static_cast<const float2*>(da),
                        static_cast<Pair*>(sums),
                        nbl,
                        nch,
                        halo};
  const cudaError_t err = with_fir(
      rows, w, fir, nch, K, S, nbins, ntaps, 0, st,
      [&](const auto& f, auto&& pre) {
        return launch_frames(rows, f, out, tw, nch, K, S, nbins, ntaps,
                             n_groups, frames_per_group, 0, 2 * kWarps, st,
                             pre);
      });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_gj = min(n_groups,
                       (halo + frames_per_group - 1) / frames_per_group);
  return static_cast<int>(launch_parts_reduce<T>(
      static_cast<const float2*>(partial), static_cast<const Pair*>(sums),
      rows.x, static_cast<float2*>(parts), static_cast<float2*>(mu),
      static_cast<T*>(new_hist), K, S, n_groups, n_gj, nbl, nch, nbins, halo,
      step, dependent, st));
}

// The frame kernel of the single pass's wide route over K blocks on `st`:
// raw rows with WideOut (the FIR as with_fir says), the spectra to `spec`
// and the sample sums to `sums`.  The X kernel (fx_xstage.cu, fxt_xstage)
// forms parts, mu and the new history from them in a launch of its own.
template <typename T, class Rows>
int fx_wide_frames(const Rows& rows, const void* w, void* fir,
                   const void* tw, void* sums, void* spec, int nch, int K,
                   int S, int nbins, int ntaps, int n_groups,
                   int frames_per_group, cudaStream_t st) {
  using Pair = typename SumOf<T>::pair;
  const int halo = ntaps - 1;
  if (halo < 1 || S < halo) return static_cast<int>(cudaErrorInvalidValue);
  const WideOut<T> out{{nullptr, nullptr, nullptr, static_cast<Pair*>(sums),
                        0, nch, halo},
                       static_cast<float2*>(spec),
                       S};
  if (nbins > kFftMaxSub && fir == nullptr) {
    // a frame's halves on a cluster of two CTAs (fx_wide_halves_kernel)
    if (K < 1 || K > 65535 || S < 1 || (nbins & 3) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* kernel = &fx_wide_halves_kernel<Rows>;
    const size_t smem = static_cast<size_t>(nbins) * sizeof(float2) +
                        kWarps * sizeof(Pair);
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_groups * 2, nch, K);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, rows, static_cast<const float*>(w),
                             out, static_cast<const float2*>(tw), nch, S,
                             nbins, ntaps, frames_per_group);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(with_fir(
      rows, w, fir, nch, K, S, nbins, ntaps, 0, st,
      [&](const auto& f, auto&& pre) {
        return launch_frames(rows, f, out, tw, nch, K, S, nbins, ntaps,
                             n_groups, frames_per_group, 0, 2 * kWarps, st,
                             pre);
      }));
}

// The mean pre-pass, the FIR as with_fir says and the frame kernel of the
// two-pass FX entry points.
template <int Stage = kStageFull, typename T, class Rows>
cudaError_t launch_fx(const T* x, typename SumOf<T>::pair* sums,
                      const Rows& rows, const void* w, void* fir,
                      const CrossOut& out, const void* tw, int nch, int K,
                      int S, int nbins, int ntaps, int n_groups,
                      int frames_per_group, int parts, cudaStream_t st) {
  return with_fir(rows, w, fir, nch, K, S, nbins, ntaps, parts, st,
                  [&](const auto& f, auto&& pre) {
    return launch_means_and_frames<Stage>(x, sums, rows, f, out, tw, nch, K,
                                          S, nbins, ntaps, n_groups,
                                          frames_per_group, parts, st, pre);
  });
}

// launch_fx at a stage chosen at run time (kAblate: the ablation's entry
// points, which instantiate every stage) or at kStageFull.
template <bool kAblate, typename T, class Rows>
cudaError_t launch_fx_stage(int stage, const T* x,
                            typename SumOf<T>::pair* sums, const Rows& rows,
                            const void* w, void* fir, const CrossOut& out,
                            const void* tw, int nch, int K, int S, int nbins,
                            int ntaps, int n_groups, int frames_per_group,
                            int parts, cudaStream_t st) {
#define FXT_STAGE_CASE(STAGE)                                               \
  case STAGE:                                                               \
    return launch_fx<STAGE>(x, sums, rows, w, fir, out, tw, nch, K, S,      \
                            nbins, ntaps, n_groups, frames_per_group, parts, \
                            st)
  if constexpr (kAblate) {
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
  } else {
    switch (stage) {
      FXT_STAGE_CASE(kStageFull);
      default:
        return cudaErrorInvalidValue;
    }
  }
#undef FXT_STAGE_CASE
}

// The kernels of the complex64 mode over K blocks on `st`, the frame
// kernel at `stage` (fxt_fx_fused: kStageFull).
template <bool kAblate>
int fx_c64(int stage, const void* x, const void* hist, const void* w,
           void* fir, const void* tw, const void* pairs, void* sums,
           void* partial, void* xp, void* new_hist, int nch, int K, int S,
           int nbins, int ntaps, int nbl, int n_groups, int frames_per_group,
           int parts, cudaStream_t st) {
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
  cudaError_t err = launch_fx_stage<kAblate>(
      stage, static_cast<const float2*>(x), sd, rows, w, fir, out, tw, nch,
      K, S, nbins, ntaps, n_groups, frames_per_group, parts, st);
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

// The kernels of the int8 mode over K blocks on `st`, the frame kernel at
// `stage` (fxt_fx_fused_i8: kStageFull).
template <bool kAblate>
int fx_i8(int stage, const void* x, const void* tail, const void* mu_prev,
          const void* w, void* fir, const void* tw, const void* pairs,
          void* sums, void* partial, void* xp, void* mu, int nch, int K,
          int S, int nbins, int ntaps, int nbl, int n_groups,
          int frames_per_group, int parts, double step, cudaStream_t st) {
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
  cudaError_t err = launch_fx_stage<kAblate>(
      stage, static_cast<const char2*>(x), sl, rows, w, fir, out, tw, nch, K,
      S, nbins, ntaps, n_groups, frames_per_group, parts, st);
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

// This source is compiled five times, so that nvcc builds its kernels in
// parallel (every frame kernel compiles its FFT's functions anew, so a unit
// of many frame kernels is slow to build): alone, for the two-pass entry
// points, the reduce alone and the spectrometer below; included by
// fx_parts.cu (FXT_UNIT_PARTS: the single pass's shared route, fxt_fx_parts
// and fxt_fx_parts_i8), by fx_wide.cu (FXT_UNIT_WIDE: its wide route's
// frames, fxt_fx_wide_frames and fxt_fx_wide_frames_i8), and by
// fx_ablate_c64.cu and fx_ablate_i8.cu, each of which builds one ablation
// entry point (its six stages' frame kernels).
#if defined(FXT_ABLATE_C64) || defined(FXT_ABLATE_I8) || \
    defined(FXT_UNIT_PARTS) || defined(FXT_UNIT_WIDE)
#define FXT_NOT_MAIN_UNIT
#endif

#ifdef FXT_UNIT_PARTS
namespace fxt {

int parts_step(bool int8, const void* x, const void* hist, const void* w,
               void* fir, const void* tw, const void* pairs, const void* da,
               void* sums, void* partial, void* parts, void* mu,
               void* new_hist, int nch, int K, int S, int nbins, int ntaps,
               int nbl, int n_groups, int frames_per_group, double step,
               bool dependent, cudaStream_t st) {
  const long long n = static_cast<long long>(S) * nbins;
  if (int8) {
    const I8Raw rows{{static_cast<const char2*>(x),
                      static_cast<const char2*>(hist), nullptr, nullptr, n,
                      K * n, S, ntaps - 1, nbins, nch,
                      static_cast<float>(step), step}};
    return fx_parts<char2>(rows, w, fir, tw, pairs, da, sums, partial,
                           parts, mu, new_hist, nch, K, S, nbins, ntaps, nbl,
                           n_groups, frames_per_group, step, dependent, st);
  }
  const F32Raw rows{{static_cast<const float2*>(x),
                     static_cast<const float2*>(hist), nullptr, n, K * n, S,
                     ntaps - 1, nbins, nch}};
  return fx_parts<float2>(rows, w, fir, tw, pairs, da, sums, partial, parts,
                          mu, new_hist, nch, K, S, nbins, ntaps, nbl,
                          n_groups, frames_per_group, 1.0, dependent, st);
}

}  // namespace fxt
#endif  // FXT_UNIT_PARTS

#ifdef FXT_UNIT_WIDE
namespace fxt {

int wide_frames(bool int8, const void* x, const void* hist, const void* w,
                void* fir, const void* tw, void* sums, void* spec, int nch,
                int K, int S, int nbins, int ntaps, int n_groups,
                int frames_per_group, double step, cudaStream_t st) {
  const long long n = static_cast<long long>(S) * nbins;
  if (int8) {
    const I8Raw rows{{static_cast<const char2*>(x),
                      static_cast<const char2*>(hist), nullptr, nullptr, n,
                      K * n, S, ntaps - 1, nbins, nch,
                      static_cast<float>(step), step}};
    return fx_wide_frames<char2>(rows, w, fir, tw, sums, spec, nch, K, S,
                                 nbins, ntaps, n_groups, frames_per_group,
                                 st);
  }
  const F32Raw rows{{static_cast<const float2*>(x),
                     static_cast<const float2*>(hist), nullptr, n, K * n, S,
                     ntaps - 1, nbins, nch}};
  return fx_wide_frames<float2>(rows, w, fir, tw, sums, spec, nch, K, S,
                                nbins, ntaps, n_groups, frames_per_group, st);
}

}  // namespace fxt
#endif  // FXT_UNIT_WIDE

#ifndef FXT_NOT_MAIN_UNIT
// Launch the kernels of the complex64 mode over K blocks on `stream`.  The
// caller (fx_fused.py) has checked shapes, types, contiguity and that
// nbins is a multiple of 128 in [256, 16384] (fx_fused.kernel_bins) with
// ntaps >= 2.  w is the FIR's table [ntaps, nbins] float32: the window, or
// the SVD mode's folded factors (fx_fused.fir_table).  fir is NULL (the tap
// loop in the frame kernel) or, at deep taps (fx_fused.deep_fir), a scratch
// [nch, K S, nbins] float2 that fir_rows_kernel fills first.  x is [nch, K,
// S, nbins]; each block has n_groups groups of frames_per_group frames.
// Scratch: sums [K, nch, parts] double2, partial [K, n_groups, nbl, nbins]
// float2.  Writes xp [K, nbl, nbins] and new_hist [nch, ntaps-1, nbins].
// Returns cudaGetLastError().
extern "C" int fxt_fx_fused(const void* x, const void* hist, const void* w,
                            void* fir, const void* tw, const void* pairs,
                            void* sums, void* partial, void* xp,
                            void* new_hist, int nch, int K, int S, int nbins,
                            int ntaps, int nbl, int n_groups,
                            int frames_per_group, int parts, void* stream) {
  return fx_c64<false>(kStageFull, x, hist, w, fir, tw, pairs, sums, partial,
                       xp, new_hist, nch, K, S, nbins, ntaps, nbl, n_groups,
                       frames_per_group, parts,
                       static_cast<cudaStream_t>(stream));
}

// Launch the kernels of the int8 mode over K blocks on `stream`.  The
// caller (fx_fused.py) has checked what it checks for fxt_fx_fused, plus
// S >= ntaps-1 and that x and tail start on an (I, Q) pair.  x is [nch, K,
// S, nbins, 2]; w and fir as for fxt_fx_fused.  Scratch: sums [K, nch,
// parts] longlong2, partial [K, n_groups, nbl, nbins] float2.  Writes xp
// [K, nbl, nbins] and mu [K, nch] (complex64).  Returns
// cudaGetLastError().
extern "C" int fxt_fx_fused_i8(const void* x, const void* tail,
                               const void* mu_prev, const void* w, void* fir,
                               const void* tw, const void* pairs, void* sums,
                               void* partial, void* xp, void* mu, int nch,
                               int K, int S, int nbins, int ntaps, int nbl,
                               int n_groups, int frames_per_group, int parts,
                               double step, void* stream) {
  return fx_i8<false>(kStageFull, x, tail, mu_prev, w, fir, tw, pairs, sums,
                      partial, xp, mu, nch, K, S, nbins, ntaps, nbl, n_groups,
                      frames_per_group, parts, step,
                      static_cast<cudaStream_t>(stream));
}

// The single-pass step of the complex64 mode over K blocks on `stream`
// (fx_fused.fx_fused_parts): frames and reduce (at deep taps the FIR launch
// first).  Checked by the caller as for fxt_fx_fused, plus S >= ntaps-1; w
// and fir as there.  da is the window's table dA [ntaps-1, nbins]
// complex64.  Scratch: sums [K, n_groups, nch] double2, partial [K,
// n_groups, nbl + 2 nch, nbins] float2.  Writes parts [K, nbl + 2 nch,
// nbins] (xp_raw, T, GJ), mu [K, nch] and new_hist [nch, ntaps-1, nbins].
// Returns cudaGetLastError().
extern "C" int fxt_fx_parts(const void* x, const void* hist, const void* w,
                            void* fir, const void* tw, const void* pairs,
                            const void* da, void* sums, void* partial,
                            void* parts, void* mu, void* new_hist, int nch,
                            int K, int S, int nbins, int ntaps, int nbl,
                            int n_groups, int frames_per_group,
                            void* stream) {
  return fxt::parts_step(false, x, hist, w, fir, tw, pairs, da, sums,
                         partial, parts, mu, new_hist, nch, K, S, nbins,
                         ntaps, nbl, n_groups, frames_per_group, 1.0, false,
                         static_cast<cudaStream_t>(stream));
}

// The single-pass step of the int8 mode (fx_fused.fx_fused_parts_i8): x
// int8 [nch, K, S, nbins, 2], tail the stream's raw tail.  Scratch: sums
// [K, n_groups, nch] longlong2.  Writes parts and mu as fxt_fx_parts (real
// units) and new_tail int8 [nch, ntaps-1, nbins, 2], the last block's last
// rows as they arrived.  Returns cudaGetLastError().
extern "C" int fxt_fx_parts_i8(const void* x, const void* tail, const void* w,
                               void* fir, const void* tw, const void* pairs,
                               const void* da, void* sums, void* partial,
                               void* parts, void* mu, void* new_tail, int nch,
                               int K, int S, int nbins, int ntaps, int nbl,
                               int n_groups, int frames_per_group,
                               double step, void* stream) {
  return fxt::parts_step(true, x, tail, w, fir, tw, pairs, da, sums,
                         partial, parts, mu, new_tail, nch, K, S, nbins,
                         ntaps, nbl, n_groups, frames_per_group, step, false,
                         static_cast<cudaStream_t>(stream));
}

// The deep-tap FIR alone on `stream` (fx_fused.fir_rows): fir_rows_kernel
// over the single pass's raw rows, x [nch, K, S, nbins] complex64 behind
// the corrected tail hist [nch, ntaps-1, nbins], w [ntaps, nbins] float32
// -> fir [nch, K S, nbins] complex64, frame g's FIR output in row g.  The
// caller has checked shapes, types and contiguity.  Returns
// cudaGetLastError().
extern "C" int fxt_fir_rows(const void* x, const void* hist, const void* w,
                            void* fir, int nch, int K, int S, int nbins,
                            int ntaps, void* stream) {
  const long long n = static_cast<long long>(S) * nbins;
  const F32Raw rows{{static_cast<const float2*>(x),
                     static_cast<const float2*>(hist), nullptr, n, K * n, S,
                     ntaps - 1, nbins, nch}};
  return static_cast<int>(launch_fir_rows(rows, w, fir, nch, K, S, nbins,
                                          ntaps, 0,
                                          static_cast<cudaStream_t>(stream)));
}

// fxt_fir_rows over 8-bit samples: x int8 [nch, K, S, nbins, 2] behind the
// raw tail [nch, ntaps-1, nbins, 2], each sample times `step`.
extern "C" int fxt_fir_rows_i8(const void* x, const void* tail,
                               const void* w, void* fir, int nch, int K,
                               int S, int nbins, int ntaps, double step,
                               void* stream) {
  const long long n = static_cast<long long>(S) * nbins;
  const I8Raw rows{{static_cast<const char2*>(x),
                    static_cast<const char2*>(tail), nullptr, nullptr, n,
                    K * n, S, ntaps - 1, nbins, nch, static_cast<float>(step),
                    step}};
  return static_cast<int>(launch_fir_rows(rows, w, fir, nch, K, S, nbins,
                                          ntaps, 0,
                                          static_cast<cudaStream_t>(stream)));
}

// The single pass's reduce alone on `stream` (fx_fused.parts_reduce): the
// second kernel of fxt_fx_parts over partials a caller holds.  partial
// float2 [K, n_groups, nbl + 2 nch, nbins], sums double2 [K, n_groups,
// nch], x complex64 [nch, K, S, nbins] -> parts [K, nbl + 2 nch, nbins]
// (xp and T over every group in group order, GJ over the first n_gj), mu
// [K, nch] and new_hist [nch, halo, nbins], the last block's last halo
// rows minus its mean.  The caller has checked shapes, types and
// contiguity.  Returns cudaGetLastError().
extern "C" int fxt_parts_reduce(const void* partial, const void* sums,
                                const void* x, void* parts, void* mu,
                                void* new_hist, int nch, int K, int S,
                                int nbins, int nbl, int halo, int n_groups,
                                int n_gj, void* stream) {
  return static_cast<int>(launch_parts_reduce<float2>(
      static_cast<const float2*>(partial),
      static_cast<const double2*>(sums), static_cast<const float2*>(x),
      static_cast<float2*>(parts), static_cast<float2*>(mu),
      static_cast<float2*>(new_hist), K, S, n_groups, n_gj, nbl, nch, nbins,
      halo, 1.0, false, static_cast<cudaStream_t>(stream)));
}

// fxt_parts_reduce after fxt_fx_parts_i8's frame kernel: sums longlong2,
// x int8 [nch, K, S, nbins, 2], mu in real units (times `step`) and the new
// tail int8 [nch, halo, nbins, 2], the last rows as they arrived.
extern "C" int fxt_parts_reduce_i8(const void* partial, const void* sums,
                                   const void* x, void* parts, void* mu,
                                   void* new_tail, int nch, int K, int S,
                                   int nbins, int nbl, int halo, int n_groups,
                                   int n_gj, double step, void* stream) {
  return static_cast<int>(launch_parts_reduce<char2>(
      static_cast<const float2*>(partial),
      static_cast<const longlong2*>(sums), static_cast<const char2*>(x),
      static_cast<float2*>(parts), static_cast<float2*>(mu),
      static_cast<char2*>(new_tail), K, S, n_groups, n_gj, nbl, nch, nbins,
      halo, step, false, static_cast<cudaStream_t>(stream)));
}

// The frame kernel of the single pass's wide route (fx_fused.fx_fused_parts
// with the X stage over device memory): fxt_fx_parts's x, hist, w, fir, tw,
// sums and shapes; it writes every frame's spectrum of every channel to
// spec [K, nch, S, nbins] float2, with no bound on nch from shared memory
// (the caller takes nch <= 64).  fxt_xstage then forms the parts, mu and
// the new history.  Returns cudaGetLastError().
extern "C" int fxt_fx_wide_frames(const void* x, const void* hist,
                                  const void* w, void* fir, const void* tw,
                                  void* sums, void* spec, int nch, int K,
                                  int S, int nbins, int ntaps, int n_groups,
                                  int frames_per_group, void* stream) {
  return fxt::wide_frames(false, x, hist, w, fir, tw, sums, spec, nch, K, S,
                          nbins, ntaps, n_groups, frames_per_group, 1.0,
                          static_cast<cudaStream_t>(stream));
}

// The int8 wide route's frame kernel: fxt_fx_parts_i8's x, tail, step and
// the rest as for fxt_fx_wide_frames; fxt_xstage_i8 follows it.
extern "C" int fxt_fx_wide_frames_i8(const void* x, const void* tail,
                                     const void* w, void* fir, const void* tw,
                                     void* sums, void* spec, int nch, int K,
                                     int S, int nbins, int ntaps,
                                     int n_groups, int frames_per_group,
                                     double step, void* stream) {
  return fxt::wide_frames(true, x, tail, w, fir, tw, sums, spec, nch, K, S,
                          nbins, ntaps, n_groups, frames_per_group, step,
                          static_cast<cudaStream_t>(stream));
}

#endif  // the production entry points

#ifdef FXT_ABLATE_C64
// The stage ablation (fx_fused.fx_fused_ablate): fxt_fx_fused with the
// frame kernel truncated at `stage` (the kStage values, 0 .. 5; 0 is the
// production kernel, the instantiation fxt_fx_fused launches).  The mean
// pre-pass, the deep-tap FIR launch (fir not NULL) and the reduce run as
// they do there, so two stages' times differ by the frame kernel alone; the
// history written is fxt_fx_fused's.  At kStageFft only xp[k, 0, 0:256] is
// defined.
extern "C" int fxt_fx_ablate(const void* x, const void* hist, const void* w,
                             void* fir, const void* tw, const void* pairs,
                             void* sums, void* partial, void* xp,
                             void* new_hist, int nch, int K, int S, int nbins,
                             int ntaps, int nbl, int n_groups,
                             int frames_per_group, int parts, int stage,
                             void* stream) {
  return fx_c64<true>(stage, x, hist, w, fir, tw, pairs, sums, partial, xp,
                      new_hist, nch, K, S, nbins, ntaps, nbl, n_groups,
                      frames_per_group, parts,
                      static_cast<cudaStream_t>(stream));
}

#endif  // FXT_ABLATE_C64

#ifdef FXT_ABLATE_I8
// The stage ablation of the int8 mode: fxt_fx_fused_i8 at `stage`.
extern "C" int fxt_fx_ablate_i8(const void* x, const void* tail,
                                const void* mu_prev, const void* w, void* fir,
                                const void* tw, const void* pairs, void* sums,
                                void* partial, void* xp, void* mu, int nch,
                                int K, int S, int nbins, int ntaps, int nbl,
                                int n_groups, int frames_per_group, int parts,
                                double step, int stage, void* stream) {
  return fx_i8<true>(stage, x, tail, mu_prev, w, fir, tw, pairs, sums,
                     partial, xp, mu, nch, K, S, nbins, ntaps, nbl, n_groups,
                     frames_per_group, parts, step,
                     static_cast<cudaStream_t>(stream));
}

#endif  // FXT_ABLATE_I8

#ifndef FXT_NOT_MAIN_UNIT
// Launch the spectrometer on `stream`: the mean pre-pass over all nsamp
// samples of each channel, the frame kernel with the spectra written to
// spec [nch, S, nbins], and (ntaps > 1) the new history.  The caller
// (spectrometer.py) has checked shapes, types, contiguity, that nbins is a
// multiple of 128 in [256, 16384], ntaps >= 1 and S >= 1.  Scratch: sums
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
      nbins, ntaps, n_groups, frames_per_group, parts, st,
      []() { return cudaSuccess; });
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
#endif  // the production entry points
