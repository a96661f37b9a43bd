// Host data-plane loops of int8 ingest: quantize and deinterleave.  The
// port's own copy of the loops of fxtpu's native/dataplane.cpp that the
// port binds (fxtpu_torch/runtime/native.py): fx_quant_c64_i8 and
// fx_split_i8, with the same rounding and clip.  fxtpu's 4-bins-per-int32
// packing loops are not copied: the port sends int8 samples to the card
// as they are, since GPU loads are byte-addressed.
//
// numpy does the quantize as a multi-pass strided ufunc chain; these
// single-pass loops auto-vectorize.  They are single-threaded by design:
// the pipeline runs one feeder thread per channel, so parallelism comes
// from the caller and these loops stay allocation- and lock-free.

#include <cmath>
#include <cstdint>

namespace {

inline int8_t quant1(float x, float inv) {
    float v = std::nearbyintf(x * inv);   // half to even, as np.rint
    if (v != v) return 0;  // NaN: a defined result (float->int8 of NaN
                           // is undefined behaviour)
    if (v > 127.f) v = 127.f;
    if (v < -127.f) v = -127.f;
    return static_cast<int8_t>(v);
}

}  // namespace

extern "C" {

// complex64 block (interleaved re,im float pairs) -> int8 [n, 2]
// quantized round(x/step) clipped to [-127, 127] — the
// QuantizedSource._quantize contract (fxtpu_torch/sources/base.py).
void fx_quant_c64_i8(const float* src, int8_t* dst, int64_t n,
                     float inv_step) {
    for (int64_t i = 0; i < 2 * n; ++i) {
        dst[i] = quant1(src[i], inv_step);
    }
}

// int8 [n, 2] interleaved -> separate re / im planes.
void fx_split_i8(const int8_t* src, int8_t* re, int8_t* im, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        re[i] = src[2 * i];
        im[i] = src[2 * i + 1];
    }
}

}  // extern "C"
