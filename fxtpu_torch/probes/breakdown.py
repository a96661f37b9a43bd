"""Numerics and timing of the production FX step at the flagship shape.

Counterpart of ``scripts/tpu_breakdown.py``: both routes of ``FxEngine``
(the plain torch route and the fused route, which on the card launches the
CUDA kernel) against a float64 numpy oracle at 2 channels x 2^21 samples
x 4096 bins x 4 taps, under a delay of ~600 carrier cycles so that the
packed-phase path is exercised, with the bins around DC reported apart (a
DC correction cancels there; the port subtracts the mean before the FIR,
so its DC bins should be no worse than the rest), then ``multi_step`` over
K blocks: ms per block and GS/s.  The oracle is this module's own.

    python -m fxtpu_torch.probes breakdown [--num_samp 2097152 --k 8]

prints one JSON line per route.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fxtpu_torch.config import CorrelatorConfig
from fxtpu_torch.fx import FxEngine
from fxtpu_torch.ops.xengine import pack_delays
from fxtpu_torch.probes.common import (add_device_argument, card_line, emit,
                                       event_ms, resolve_device)

__all__ = ["DELAY", "oracle", "main"]

DELAY = 4.2e-7   # ~600 carrier cycles at 1420.4 MHz


def oracle(blk: np.ndarray, delays, cfg: CorrelatorConfig,
           window2d: np.ndarray) -> np.ndarray:
    """The visibility of one block from a zero history in float64 numpy:
    DC removal, the FIR over ``[zeros; rows]``, the FFT, the delay
    rotation, the frame mean of ``spec_0 conj(spec_1)``, fftshifted."""
    nch, ns = blk.shape
    nbins, ntaps = cfg.nbins, cfg.ntaps
    iq = blk.astype(np.complex128)
    iq -= iq.mean(axis=-1, keepdims=True)
    s = ns // nbins
    rows = iq[:, : s * nbins].reshape(nch, s, nbins)
    w = np.asarray(window2d, np.float64)
    xp = np.concatenate([np.zeros((nch, ntaps - 1, nbins)), rows], axis=1)
    fir = sum(w[t] * xp[:, t:t + s] for t in range(ntaps))
    spec = np.fft.fft(fir, axis=-1)
    f = np.fft.fftfreq(nbins, 1 / cfg.bandwidth) + cfg.frequency
    rot = np.exp(2j * np.pi * np.outer(np.asarray(delays, np.float64), f))
    spec = spec * rot[:, None, :]
    return np.fft.fftshift((spec[0] * np.conj(spec[1])).mean(axis=0))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m fxtpu_torch.probes breakdown", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(ap)
    ap.add_argument("--num_samp", type=int, default=2**21)
    ap.add_argument("--nbins", type=int, default=4096)
    ap.add_argument("--ntaps", type=int, default=4)
    ap.add_argument("--k", type=int, default=8, help="blocks per multi_step")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_line(device)
    nch = 2
    cfg = CorrelatorConfig(nchan=nch, num_samp=args.num_samp,
                           nbins=args.nbins, ntaps=args.ntaps,
                           clamp_num_samp=False, device=str(device))
    rng = np.random.default_rng(args.seed)
    blk = (rng.normal(size=(nch, args.num_samp)).astype(np.float32)
           + 1j * rng.normal(size=(nch, args.num_samp)).astype(np.float32))
    delays = np.array([0.0, DELAY])
    packed = torch.as_tensor(pack_delays(delays, cfg.frequency),
                             device=device)
    records = []
    want = None
    for fused in (False, True):
        eng = FxEngine(cfg, fused=fused)
        if want is None:
            want = oracle(blk, delays, cfg, eng.window2d)
            scale = np.abs(want).max()
        vis, _ = eng.step(eng.prepare_block(blk), packed,
                          eng.fresh_history())
        err = np.abs(vis[0].cpu().numpy() - want)
        dc = args.nbins // 2
        around_dc = np.zeros(args.nbins, bool)
        around_dc[dc - 2:dc + 3] = True
        rec = dict(probe="breakdown", route="fused" if fused else "plain",
                   kernel_active=eng.kernel_active, fir_mode=eng.fir_mode,
                   num_samp=args.num_samp, nbins=args.nbins,
                   ntaps=args.ntaps, k=args.k,
                   max_rel_err=float(err.max() / scale),
                   max_rel_err_excl_dc=float(err[~around_dc].max() / scale),
                   max_rel_err_dc=float(err[around_dc].max() / scale),
                   ms_per_block=None, gs_per_s=None, card=card)
        iqk = eng.prepare_batch([blk] * args.k)
        dk = torch.as_tensor(
            pack_delays(np.stack([delays] * args.k), cfg.frequency),
            device=device)
        hist = eng.fresh_history()
        visk, _ = eng.multi_step(iqk, dk, hist)
        rec["multi_step_block0_is_step"] = bool(torch.equal(visk[0], vis))
        if device.type == "cuda":
            ms = event_ms(lambda: eng.multi_step(iqk, dk, hist),
                          n=args.iters, warm=2) / args.k
            rec.update(ms_per_block=ms,
                       gs_per_s=nch * args.num_samp / ms / 1e6)
        emit(records, **rec)
        del iqk, visk
    return records
