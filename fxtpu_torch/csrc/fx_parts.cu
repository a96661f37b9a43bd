// The single pass's shared route, fxt::parts_step (fxt_fx_parts,
// fxt_fx_parts_i8 and fxt_fx_step), built from fx_fused.cu in a unit of
// its own (its four frame kernels compile beside the others, not after
// them).  Built by fxtpu_torch/cuda_build.py with every source in this
// directory.
#define FXT_UNIT_PARTS
#include "fx_fused.cu"
