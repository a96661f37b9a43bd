"""fxtpu_torch.ops — the DSP of the FX step in PyTorch (complex64,
``torch.fft``) and the hand-written CUDA kernel of the fused step."""

from fxtpu_torch.ops.window import firwin, get_window, pfb_window
from fxtpu_torch.ops.pfb import (dc_remove, frame_rows, pfb_fir, spectrometer,
                                 spectrometer_rows, zero_history)
from fxtpu_torch.ops.xengine import (baseline_pairs, continuum_reduce,
                                     fstc_rotate, pack_delays, rf_freqs,
                                     xcorr_baselines)
from fxtpu_torch.ops.delay import estimate_delay
from fxtpu_torch.ops.fx_fused import (fx_fused_raw, fx_fused_raw_reference,
                                      pairs_tensor, supported)

__all__ = [
    "get_window", "firwin", "pfb_window",
    "dc_remove", "frame_rows", "pfb_fir", "spectrometer", "spectrometer_rows",
    "zero_history",
    "baseline_pairs", "continuum_reduce", "fstc_rotate", "pack_delays",
    "rf_freqs", "xcorr_baselines",
    "estimate_delay",
    "fx_fused_raw", "fx_fused_raw_reference", "pairs_tensor", "supported",
]
