"""fxtpu_torch.sources — pluggable IQ signal sources (the reference's L1
layer); a copy of ``fxtpu.sources`` without its JAX package import.  The
int8 wrapper ``QuantizedSource`` arrives with int8 ingest (ROADMAP.md A.7)."""

from fxtpu_torch.sources.base import LimitedSource, Source
from fxtpu_torch.sources.synthetic import (
    NoiseSource,
    SinusoidSource,
    FaultInjectingSource,
    complex_noise,
    complex_sinusoid,
    fractional_delay,
)
from fxtpu_torch.sources.replay import (RTL_U8_EXTS, ReplaySource,
                                        RtlU8ReplaySource, save_recording)


def make_source(cfg, delays=None):
    """Build a source from a :class:`~fxtpu_torch.config.CorrelatorConfig`."""
    common = dict(nchan=cfg.nchan, sample_rate=cfg.bandwidth,
                  center_freq=cfg.frequency, gain=cfg.gain)
    if cfg.source == "synthetic":
        if delays is None:
            delays = [0.0] + [cfg.synthetic_delay] * (cfg.nchan - 1)
        return NoiseSource(delays=delays, snr=cfg.synthetic_snr,
                           seed=cfg.seed, **common)
    if cfg.source == "replay":
        if not cfg.replay_file:
            raise ValueError("replay source requires replay_file")
        paths = (cfg.replay_file.split(",") if "," in cfg.replay_file
                 else cfg.replay_file)
        first = paths[0] if isinstance(paths, list) else paths
        if first.lower().endswith(RTL_U8_EXTS):
            # native rtl_sdr capture (raw interleaved u8 I,Q), dequantized
            # host-side for the complex64 ingest the port runs
            return RtlU8ReplaySource(paths, as_complex=True,
                                     quant_step=cfg.quant_step, **common)
        return ReplaySource(paths, **common)
    if cfg.source == "rtlsdr":
        from fxtpu_torch.sources.rtlsdr import RtlSdrSource
        return RtlSdrSource(**common)
    raise ValueError(f"unknown source kind: {cfg.source}")


__all__ = [
    "Source", "NoiseSource", "SinusoidSource", "FaultInjectingSource",
    "LimitedSource", "ReplaySource", "RtlU8ReplaySource", "save_recording",
    "make_source", "complex_noise", "complex_sinusoid", "fractional_delay",
]
