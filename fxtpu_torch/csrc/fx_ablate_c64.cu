// The stage ablation's complex64 entry point, fxt_fx_ablate, built from
// fx_fused.cu in a unit of its own (its six stages' frame kernels compile
// beside the production ones, not after them).  Built by
// fxtpu_torch/cuda_build.py with every source in this directory.
#define FXT_ABLATE_C64
#include "fx_fused.cu"
