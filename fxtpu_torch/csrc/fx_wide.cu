// The single pass's wide route's frame kernels, fxt::wide_frames
// (fxt_fx_wide_frames, fxt_fx_wide_frames_i8 and fxt_fx_step), built from
// fx_fused.cu in a unit of its own (its four frame kernels compile beside
// the others, not after them).  Built by fxtpu_torch/cuda_build.py with
// every source in this directory.
#define FXT_UNIT_WIDE
#include "fx_fused.cu"
