// One single-pass FX step in one C call: the three kernels of a step (four
// at deep taps) enqueued back to back on the caller's stream.  Built by
// fxtpu_torch/cuda_build.py, called through fxtpu_torch/ops/fx_epilogue.py
// (fx_fused_step on CUDA tensors; its ctypes mirror of FxtStepArgs is
// cuda_build.StepArgs).
//
// Replaces: the one executable fxtpu jits per step, _fx_kernel's single
// pass (fxtpu/ops/pfb_pallas.py fx_pallas_parts), _dc_correct (:1501) and
// fxtpu/fx.py _finish_fused (:99), which its host dispatches once a step.
//
//   shared route:  frame kernel (PartsOut)  -> parts reduce -> epilogue
//   wide route:    frame kernel (WideOut)   -> X kernel     -> epilogue
//   at deep taps (fx_fused.deep_fir) the FIR launch (fir_rows_kernel)
//   before the frame kernel, which reads its rows
//
// What bounds a step's short kernels on the H100 is latency: launched by
// separate calls from Python, the second and third kernels arrived after
// the one before had drained (a flagship step: 0.27 ms by events for 28 us
// of device time).  Here the frame kernel launches as always, so it waits
// in full for the block's copy and for the step before, whose history and
// means it reads.  The second and third kernels launch as programmatic
// dependents of the kernel before them (launch_kernel's `dependent`,
// fx_common.cuh): each may be scheduled while its predecessor runs, does
// what needs none of its results, and waits at griddepcontrol.wait before
// its first read of them.  Every launch's error is checked as it is made;
// the first one is returned and nothing is launched after it.

#include <cuda_runtime.h>

#include "fx_common.cuh"   // fxt::parts_step, wide_frames, xstage, finish

// A step's arguments, in the order of cuda_build.StepArgs' fields.
// Pointers are device addresses; NULL where a field is unused.
struct FxtStepArgs {
  const void* x;          // samples [nch, K, S, nbins] c64, or int8 [.., 2]
  const void* hist;       // complex64 corrected tail, or the int8 raw tail
  const void* w;          // the FIR's table [ntaps, nbins] float32: the
                          // window, or the SVD mode's folded factors
  void* fir;              // deep taps: the FIR's rows [nch, K S, nbins]
                          // complex64 (fx_fused.deep_fir), else NULL
  const void* tw;         // twiddles [nbins / 2] complex64
  const void* pairs;      // [nbl, 2] int32
  const void* da;         // dA [ntaps - 1, nbins] complex64
  void* sums;             // [K, n_groups, nch] double2 / longlong2
  void* scratch;          // shared: partials [K, n_groups, nbl + 2 nch,
                          // nbins]; wide: spectra [K, nch, S, nbins]
  void* parts;            // [K, nbl + 2 nch, nbins]: xp_raw, T, GJ
  void* mu;               // [K, nch] complex64
  void* new_hist;         // the next step's history
  const void* mu_prev;    // [nch] complex64 (int8's raw tail), or NULL
  const void* abar;       // the window's tables [nbins] (dc_constants)
  const void* cs;
  const void* cab;
  const void* cbb;
  const void* delays;     // [K, nch] or packed [K, nch, 2] float32
  const void* freqs;      // [nbins] float32
  void* vis;              // [K, nbl, nbins] or (continuum) [K, nbl]
  double step;            // quantisation step of 8-bit samples (1: complex64)
  double bandwidth;
  int nch;
  int K;
  int S;
  int nbins;
  int ntaps;
  int nbl;
  int n_groups;
  int frames_per_group;
  int wide;               // 0: the shared route; 1: the wide route
  int packed;
  int continuum;
  int tile;               // the X kernel's plan (wide route only)
  int slots;
  int rows;
  int frames;
  int stages;
  int threads;
  const void* rowmap;     // the X kernel's row map [np, np] int32
                          // (fx_xstage.row_map), NULL but on the tiled
                          // instance
  int finish_chunk;       // the epilogue's plan (fx_epilogue.finish_plan):
                          // pairs a CTA of its pair-tiled instance, 0 for
                          // the one-bin-a-thread one; last, so a build
                          // without it reads the fields before it alike
};

namespace {

int fx_step(const FxtStepArgs& a, bool int8, cudaStream_t st) {
  const int halo = a.ntaps - 1;
  int rc;
  if (a.wide) {
    rc = fxt::wide_frames(int8, a.x, a.hist, a.w, a.fir, a.tw, a.sums,
                          a.scratch, a.nch, a.K, a.S, a.nbins, a.ntaps,
                          a.n_groups, a.frames_per_group, a.step, st);
    if (rc != 0) return rc;
    rc = fxt::xstage(int8, a.scratch, a.pairs, a.rowmap, a.da, a.parts, a.x,
                     a.sums, a.mu, a.new_hist, a.nch, a.K, a.S, a.nbins,
                     a.nbl, halo, a.n_groups, a.tile, a.slots, a.rows,
                     a.frames, a.stages, a.threads, a.step, true, st);
  } else {
    rc = fxt::parts_step(int8, a.x, a.hist, a.w, a.fir, a.tw, a.pairs,
                         a.da, a.sums, a.scratch, a.parts, a.mu, a.new_hist,
                         a.nch, a.K, a.S, a.nbins, a.ntaps, a.nbl,
                         a.n_groups, a.frames_per_group, a.step, true, st);
  }
  if (rc != 0) return rc;
  const long long rows = static_cast<long long>(a.nbl) + 2 * a.nch;
  const float2* parts = static_cast<const float2*>(a.parts);
  return fxt::finish(parts, parts + static_cast<long long>(a.nbl) * a.nbins,
                     parts + (static_cast<long long>(a.nbl) + a.nch) * a.nbins,
                     a.mu, a.mu_prev, a.pairs, a.abar, a.cs, a.cab, a.cbb,
                     a.delays, a.freqs, a.vis, rows * a.nbins,
                     rows * a.nbins, rows * a.nbins, a.K, a.nbl, a.nch,
                     a.nbins, a.packed, a.continuum, a.S, a.finish_chunk,
                     a.bandwidth, true, st);
}

}  // namespace

// The single-pass step over K complex64 blocks on `stream`
// (fx_epilogue.fx_fused_step): the frame kernel, the reduce or (wide) the X
// kernel, then the epilogue, the last two as programmatic dependents.  The
// caller has checked shapes, types, devices and contiguity as for
// fxt_fx_parts (shared) or fxt_fx_wide_frames and fxt_xstage (wide), and
// fxt_fx_finish; mu_prev is NULL.  Writes parts, mu, new_hist (the
// corrected tail) and vis.  Returns the first launch's error (0: none).
extern "C" int fxt_fx_step(const FxtStepArgs* args, void* stream) {
  return fx_step(*args, false, static_cast<cudaStream_t>(stream));
}

// The same over K 8-bit blocks: x int8 [nch, K, S, nbins, 2], hist the raw
// tail, mu_prev the mean it carries, sums longlong2, mu in real units
// (times `step`); new_hist is the next raw tail.
extern "C" int fxt_fx_step_i8(const FxtStepArgs* args, void* stream) {
  return fx_step(*args, true, static_cast<cudaStream_t>(stream));
}
