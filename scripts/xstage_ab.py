"""The X kernel's two instances alone on the card, over the same spectra.

For each channel count: the register-tiled instance's plan
(``fx_xstage.tiled_plan``; past ``XSTAGE_TILED_MAX_NCH`` channels the
band instance's, ``fx_xstage.band_plan``) and, where its rows fit one
CTA, the row instance's (``fx_xstage.row_plan``), each launched through
the X entry
(``fxt_xstage``) on K blocks of ``S`` frames of ``nbins`` bins with every
pair and autos; per block the median milliseconds by CUDA events over
``--rounds`` launches and the kernel's device microseconds (a CUDA-only
``torch.profiler`` trace), the plain version's milliseconds
(``fx_xstage_reference``, the pairs in tiles of at most 2 GiB of
gathered spectra), each instance's largest error against the plain
version over the first 64 bins as a share of each row's scale, and the
float32 operations' least time at 67 TFLOP/s.  One JSON line a count,
the card's name and power limit first.  The plan ``xstage_plan`` takes
is the tiled one from ``XSTAGE_TILED_NCH`` channels on.

    python scripts/xstage_ab.py --nch 24,36,48,64,128 [--k 3] [--s 64]
        [--nbins 4096] [--rounds 10]
"""

from __future__ import annotations

import argparse
import importlib
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fxtpu_torch.cuda_build import check, load_kernels  # noqa: E402
from fxtpu_torch.ops.fx_fused import pairs_tensor  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs  # noqa: E402
from fxtpu_torch.probes.common import (card_line, device_events,  # noqa: E402
                                       emit, event_ms)

xs = importlib.import_module("fxtpu_torch.ops.fx_xstage")

#: float32's rate on the H100 (SXM), operations a second.
F32_FLOPS = 67e12
#: The most bytes of gathered spectra one tile of the plain version takes.
PLAIN_TILE_BYTES = 2 << 30


def plain(spec, pairs, da):
    """``fx_xstage_reference`` with the pairs in tiles (its gather of every
    pair at once would take 17 GB a block at 128 channels)."""
    k, nch, s, nbins = spec.shape
    per = max(1, PLAIN_TILE_BYTES // (k * s * nbins * 8))
    parts = [xs.fx_xstage_reference(spec, pairs[i:i + per], da)[:, :len(
        pairs[i:i + per])] for i in range(0, len(pairs), per)]
    tail = xs.fx_xstage_reference(spec, pairs[:1], da)[:, 1:]
    return torch.cat(parts + [tail], dim=1)


def launch(lib, plan, spec, pairs, rmap, da, parts):
    k, nch, s, nbins = spec.shape
    rc = lib.fxt_xstage(spec.data_ptr(), pairs.data_ptr(),
                        None if rmap is None else rmap.data_ptr(),
                        da.data_ptr(), parts.data_ptr(), None, None, None,
                        None, nch, k, s, nbins, pairs.shape[0], da.shape[0],
                        0, *plan.args(),
                        torch.cuda.current_stream().cuda_stream)
    check(lib, rc, "fxt_xstage")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nch", default="24,36,48,64,128")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--s", type=int, default=64)
    ap.add_argument("--nbins", type=int, default=4096)
    ap.add_argument("--halo", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=23)
    args = ap.parse_args(argv)
    device = torch.device("cuda", torch.cuda.current_device())
    lib = load_kernels()
    records = []
    emit(records, card=card_line(device))
    k, s, nbins = args.k, args.s, args.nbins
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for nch in (int(n) for n in args.nch.split(",")):
        pairs = pairs_tensor(baseline_pairs(nch, True), nch, device)
        nbl = pairs.shape[0]
        spec = torch.view_as_complex(torch.randn(
            (k, nch, s, nbins, 2), generator=gen, device=device))
        da = torch.view_as_complex(torch.randn(
            (args.halo, nbins, 2), generator=gen, device=device))
        parts = torch.empty((k, nbl + 2 * nch, nbins), dtype=torch.complex64,
                            device=device)
        want = plain(spec[..., :64].contiguous(), pairs,
                     da[:, :64].contiguous())
        scale = want.abs().amax(dim=-1).clamp_min(1e-30)
        plain_ms = event_ms(lambda: plain(spec, pairs, da), 2) / k
        out = dict(nch=nch, k=k, s=s, nbins=nbins, pairs=nbl,
                   least_ms=8 * nbl * s * nbins / F32_FLOPS * 1e3,
                   plain_ms=plain_ms,
                   plan=xs.xstage_plan(nch, nbl, s, nbins, k).args())
        rmap = xs.row_map(pairs, nch)
        plans = ({"bands": (xs.band_plan(nch, s, nbins, k), rmap)}
                 if nch > xs.XSTAGE_TILED_MAX_NCH
                 else {"tiled": (xs.tiled_plan(nch, s, nbins, k), rmap)})
        if nbl + 2 * nch <= xs.XSTAGE_ROW_CAPACITY:
            plans["row"] = (xs.row_plan(nch, nbl, s, nbins, k), None)
        for name, (plan, rmap) in plans.items():
            def run(plan=plan, rmap=rmap):
                launch(lib, plan, spec, pairs, rmap, da, parts)
            ms = event_ms(run, args.rounds, warm=2) / k
            events = device_events(run, args.rounds)
            us = statistics.median(e["dur"] for e in events) / k
            err = ((parts[..., :64] - want).abs().amax(dim=-1) / scale).max()
            out.update({f"{name}_plan": plan.args(),
                        f"{name}_split": plan.split,
                        f"{name}_reads": plan.reads,
                        f"{name}_ms": ms, f"{name}_device_us": us,
                        f"{name}_err": err.item(),
                        f"{name}_share": out["least_ms"] / ms})
        emit(records, **out)
        del spec, parts, want
    return records


if __name__ == "__main__":
    main()
