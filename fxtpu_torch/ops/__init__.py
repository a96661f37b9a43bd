"""fxtpu_torch.ops — the DSP of the FX step in PyTorch (complex64,
``torch.fft``) and the hand-written CUDA kernels of the fused step."""

from fxtpu_torch.ops.window import firwin, get_window, pfb_window
from fxtpu_torch.ops.pfb import (dc_remove, dequantize, frame_rows, pfb_fir,
                                 spectrometer, spectrometer_rows, svd_fir,
                                 zero_history)
from fxtpu_torch.ops.svd_fir import (SVD_FIR_MIN_TAPS, SVD_TOL,
                                     deep_svd_applies, svd_fir_factors)
from fxtpu_torch.ops.xengine import (baseline_pairs, continuum_reduce,
                                     fstc_rotate, pack_delays, rf_freqs,
                                     xcorr_baselines)
from fxtpu_torch.ops.delay import estimate_delay
from fxtpu_torch.ops.fx_fused import (fx_fused_raw, fx_fused_raw_i8,
                                      fx_fused_raw_i8_multi,
                                      fx_fused_raw_i8_multi_reference,
                                      fx_fused_raw_i8_reference,
                                      fx_fused_raw_multi,
                                      fx_fused_raw_multi_reference,
                                      fx_fused_raw_reference, pairs_tensor,
                                      supported, supported_i8, svd_tensors)
from fxtpu_torch.ops.spectrometer import (spectrometer_fused,
                                          spectrometer_fused_reference,
                                          supported_spectrometer)

__all__ = [
    "get_window", "firwin", "pfb_window",
    "dc_remove", "dequantize", "frame_rows", "pfb_fir", "svd_fir",
    "spectrometer", "spectrometer_rows", "zero_history",
    "SVD_FIR_MIN_TAPS", "SVD_TOL", "deep_svd_applies", "svd_fir_factors",
    "baseline_pairs", "continuum_reduce", "fstc_rotate", "pack_delays",
    "rf_freqs", "xcorr_baselines",
    "estimate_delay",
    "fx_fused_raw", "fx_fused_raw_reference", "fx_fused_raw_i8",
    "fx_fused_raw_i8_reference", "fx_fused_raw_multi",
    "fx_fused_raw_multi_reference", "fx_fused_raw_i8_multi",
    "fx_fused_raw_i8_multi_reference", "pairs_tensor", "supported",
    "supported_i8",
    "svd_tensors", "spectrometer_fused", "spectrometer_fused_reference",
    "supported_spectrometer",
]
