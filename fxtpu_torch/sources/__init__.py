"""fxtpu_torch.sources — pluggable IQ signal sources (the reference's L1
layer); a copy of ``fxtpu.sources`` without its JAX package import."""

from fxtpu_torch.sources.base import LimitedSource, QuantizedSource, Source
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
        return _maybe_quantize(
            NoiseSource(delays=delays, snr=cfg.synthetic_snr,
                        seed=cfg.seed, **common), cfg)
    if cfg.source == "replay":
        if not cfg.replay_file:
            raise ValueError("replay source requires replay_file")
        paths = (cfg.replay_file.split(",") if "," in cfg.replay_file
                 else cfg.replay_file)
        first = paths[0] if isinstance(paths, list) else paths
        if first.lower().endswith(RTL_U8_EXTS):
            # native rtl_sdr capture (raw interleaved u8 I,Q): already
            # 8-bit, so int8 runs take its blocks as they are and
            # complex64 runs dequantize them on the host
            return RtlU8ReplaySource(
                paths, as_complex=cfg.ingest_dtype != "int8",
                quant_step=cfg.quant_step, **common)
        return _maybe_quantize(ReplaySource(paths, **common), cfg)
    if cfg.source == "rtlsdr":
        from fxtpu_torch.sources.rtlsdr import RtlSdrSource
        return _maybe_quantize(RtlSdrSource(**common), cfg)
    raise ValueError(f"unknown source kind: {cfg.source}")


def _maybe_quantize(src, cfg):
    """``src`` behind a :class:`QuantizedSource` under int8 ingest."""
    if cfg.ingest_dtype == "int8":
        return QuantizedSource(src, cfg.quant_step)
    return src


__all__ = [
    "Source", "NoiseSource", "SinusoidSource", "FaultInjectingSource",
    "LimitedSource", "QuantizedSource", "ReplaySource", "RtlU8ReplaySource",
    "save_recording", "make_source", "complex_noise", "complex_sinusoid",
    "fractional_delay",
]
