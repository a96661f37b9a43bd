"""The epilogue's two instances alone on the card, over the same parts.

For each channel count (every pair, autos too): the one-bin-a-thread
instance (``fx_epilogue.BIN_PLAN``; where K nbl passes its 65,535 rows,
``fx_epilogue.MAX_FINISH_ROWS``, its line says so and times the other
alone) and the pair-tiled one (``fx_epilogue.tiled_plan``
at ``fx_epilogue.finish_tile``'s tile: 16 bins past 433 channels), each
launched through the epilogue's entry
(``fxt_fx_finish``, ``fx_epilogue.finish_launch``) on K blocks of raw
parts of ``nbins`` bins laid out as a step's (xp, T and GJ rows of one
tensor), in SPECTRUM with packed delays within 8 samples at MeerKAT's
856 MS/s and a carried mean; per block the median milliseconds by CUDA
events over ``--rounds`` launches, the kernel's device microseconds (a
CUDA-only ``torch.profiler`` trace), the bytes' least time at 3.35 TB/s
(xp read and vis written once, T and GJ read once) and its share, and
each instance's largest error against the plain version
(``fx_finish_reference``) as a share of each row's scale, and the two
instances' against each other.  One JSON line a count, the card's name
and power limit first.  The plan ``finish_plan`` takes the pair-tiled
instance from ``FINISH_TILED_PAIRS`` pairs on.

    python scripts/finish_ab.py --nch 2,8,16,36,64,128 [--k 3]
        [--nbins 4096] [--s 64] [--rounds 10]
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fxtpu_torch.ops import fx_epilogue as fe  # noqa: E402
from fxtpu_torch.ops.dc_posthoc import dc_constants  # noqa: E402
from fxtpu_torch.ops.fx_fused import pairs_tensor  # noqa: E402
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs, pack_delays  # noqa: E402
from fxtpu_torch.probes.common import (card_line, device_events,  # noqa: E402
                                       emit, event_ms)

#: The H100's (SXM) device memory rate, bytes a second.
HBM_BYTES_PER_S = 3.35e12
#: MeerKAT's L-band sampling rate and centre (fxbench/configs/meerkat_l4k).
BANDWIDTH, FREQUENCY = 856e6, 1284e6


def parts_inputs(nch, k, s, nbins, device, seed):
    """A step's raw parts ``[K, nbl + 2 nch, nbins]`` (xp, T, GJ) of every
    pair with autos, block means ``[K, nch]``, the carried mean, packed
    delays and the window's constants."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pairs_np = baseline_pairs(nch, True)
    nbl = len(pairs_np)
    parts = torch.view_as_complex(torch.randn(
        (k, nbl + 2 * nch, nbins, 2), generator=gen, device=device)) * s
    mu = torch.view_as_complex(0.1 * torch.randn(
        (k, nch, 2), generator=gen, device=device))
    mu_prev = torch.view_as_complex(0.1 * torch.randn(
        (nch, 2), generator=gen, device=device))
    rng = np.random.default_rng(seed)
    delays = torch.as_tensor(pack_delays(
        rng.uniform(-8, 8, (k, nch)) / BANDWIDTH, FREQUENCY),
        dtype=torch.float32, device=device)
    w2d = pfb_window(4, nbins, "hamming").reshape(4, nbins)
    return dict(
        xp=parts[:, :nbl], T=parts[:, nbl:nbl + nch], GJ=parts[:, nbl + nch:],
        mu=mu, pairs=pairs_tensor(pairs_np, nch, device),
        consts=dc_constants(w2d, nbins, s, device), delays=delays,
        tables=fe.FinishTables(pairs_np, nbins, BANDWIDTH, FREQUENCY,
                               device),
        n_frames=s, bandwidth=BANDWIDTH, continuum=False, mu_prev=mu_prev)


def row_error(got, want):
    """Largest difference over each row's largest magnitude."""
    scale = want.abs().amax(dim=-1).clamp_min(1e-30)
    return ((got - want).abs().amax(dim=-1) / scale).max().item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nch", default="2,8,16,36,64,128")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--s", type=int, default=64)
    ap.add_argument("--nbins", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=25)
    args = ap.parse_args(argv)
    device = torch.device("cuda", torch.cuda.current_device())
    records = []
    emit(records, card=card_line(device))
    k, s, nbins = args.k, args.s, args.nbins
    for nch in (int(n) for n in args.nch.split(",")):
        a = parts_inputs(nch, k, s, nbins, device, args.seed + nch)
        nbl = a["pairs"].shape[0]
        want = fe.fx_finish_reference(**a)
        least_ms = ((2 * nbl + 2 * nch) * nbins * 8 / HBM_BYTES_PER_S
                    * 1e3)
        out = dict(nch=nch, k=k, s=s, nbins=nbins, pairs=nbl,
                   least_ms=least_ms,
                   plan=fe.finish_plan(nch, nbl, nbins, k).chunk)
        got = {}
        plans = [("tiled", fe.tiled_plan(nbl, nbins, k, fe.finish_tile(nch)))]
        if k * nbl <= fe.MAX_FINISH_ROWS:
            plans.insert(0, ("bin", fe.BIN_PLAN))
        else:
            out["bin"] = f"refused: {k * nbl} rows"
        for name, plan in plans:
            def run(plan=plan):
                return fe.finish_launch(plan, **a)
            got[name] = run()
            ms = event_ms(run, args.rounds, warm=2) / k
            events = device_events(run, args.rounds)
            us = statistics.median(e["dur"] for e in events) / k
            out.update({f"{name}_chunk": plan.chunk, f"{name}_ms": ms,
                        f"{name}_device_us": us,
                        f"{name}_share": least_ms / ms,
                        f"{name}_err": row_error(got[name], want)})
        if "bin" in got:
            out["between"] = row_error(got["tiled"], got["bin"])
        emit(records, **out)
        del a, want, got
        torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
