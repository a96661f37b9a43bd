// The stage ablation's int8 entry point, fxt_fx_ablate_i8, built from
// fx_fused.cu in a unit of its own (its six stages' frame kernels compile
// beside the production ones, not after them).  Built by
// fxtpu_torch/cuda_build.py with every source in this directory.
#define FXT_ABLATE_I8
#include "fx_fused.cu"
