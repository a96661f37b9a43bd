"""Scaling bench: the sharded FX step over 1..N shards of one device.

Counterpart of ``scripts/scaling_bench.py``.  ``measure`` runs the
mesh-sharded step (:mod:`fxtpu_torch.parallel.sharded`: the halo, the
frame-sharded single pass and its reduce, or on the plain route the
corner turn) at a fixed number of samples a shard (weak scaling: more
shards correlate more bandwidth-time) and reports the aggregate samples/s
and the efficiency against the smallest mesh's rate a shard.
``measure_multi`` times K blocks as K single sharded steps against one
K-block call (the block-parallel dispatch on the fused route).

The shards are shards of one device (``make_correlator_mesh`` takes the
same device several times): on one card a sweep measures the host's and
the launches' cost of sharding, not multi-card scaling, and the bench
says so on stderr.  Each row also carries the steps it ran and the
engine's kernel launch counts over them (empty on the plain route).

Usage:  python -m fxtpu_torch.scaling_bench [--devices 1 2 4] [--freq 2]
        [--block_pow 21] [--nbins 4096] [--iters 10] [--multi K]
        [--fused auto|true|false] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from fxtpu_torch.config import CorrelatorConfig
from fxtpu_torch.fx import FxEngine
from fxtpu_torch.parallel import make_correlator_mesh

__all__ = ["WARMUP", "measure", "measure_multi", "main"]

#: Steps run after the first and before the timed ones.
WARMUP = 3


def _sync(device: str):
    if device == "cuda":
        torch.cuda.synchronize()


def _engine(n_dev: int, mesh_freq: int, num_samp: int, nbins: int,
            device: str, fused="auto") -> FxEngine:
    """A two-channel SPECTRUM engine over a ``(n_dev / f, f)`` mesh of
    ``n_dev`` shards of ``device``."""
    shards = [torch.device(device, 0) if device == "cuda"
              else torch.device("cpu")] * n_dev
    mesh = make_correlator_mesh(n_dev // mesh_freq, mesh_freq, shards)
    cfg = CorrelatorConfig(mode="SPECTRUM", nchan=2, num_samp=num_samp,
                           nbins=nbins, clamp_num_samp=False, device=device)
    return FxEngine(cfg, mesh=mesh, fused=fused)


def _blocks(k: int, num_samp: int) -> list:
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(2, num_samp)).astype(np.float32)
             + 1j * rng.normal(size=(2, num_samp)).astype(np.float32)
             ).astype(np.complex64) for _ in range(k)]


def _launches(eng: FxEngine, before: dict) -> dict:
    """The engine's launch counts since ``before``."""
    return {k: v - before.get(k, 0) for k, v in eng.launch_counts().items()}


def measure(n_dev: int, mesh_freq: int, block_pow: int, nbins: int,
            iters: int, device: str = "cuda", warmup: int = WARMUP) -> dict:
    """Weak scaling: ``2**block_pow`` samples a shard on ``n_dev`` shards
    (``mesh_freq`` of them along ``freq`` where it divides ``n_dev``).
    Returns the timed steps' ``samples_per_s`` (both channels), the
    ``steps`` run and their ``launches``."""
    num_samp = (2 ** block_pow) * n_dev
    f = mesh_freq if n_dev % mesh_freq == 0 and n_dev >= mesh_freq else 1
    eng = _engine(n_dev, f, num_samp, nbins, device)
    iq = eng.prepare_block(_blocks(1, num_samp)[0])
    delays = torch.zeros(2, device=eng.mesh.home)
    hist = eng.fresh_history()
    before = eng.launch_counts()
    vis, hist = eng.step(iq, delays, hist)
    for _ in range(warmup):
        vis, hist = eng.step(iq, delays, hist)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        vis, hist = eng.step(iq, delays, hist)
    _sync(device)
    dt = time.perf_counter() - t0
    return {"samples_per_s": 2 * num_samp * iters / dt,
            "steps": 1 + warmup + iters, "launches": _launches(eng, before)}


def measure_multi(n_dev: int, block_pow: int, nbins: int, iters: int,
                  k: int, fused="auto", device: str = "cuda") -> dict:
    """K blocks as K sharded steps against one sharded K-block call on an
    ``(n_dev, 1)`` mesh, ``2**block_pow`` samples a block: the same math
    both ways (tests/test_torch_sharded.py), so this times the dispatch.
    Each leg runs once untimed, then ``iters`` times."""
    num_samp = 2 ** block_pow
    eng = _engine(n_dev, 1, num_samp, nbins, device, fused)
    k = eng.dispatch_batch_for(k)
    blocks = _blocks(k, num_samp)
    iq1 = [eng.prepare_block(b) for b in blocks]
    iqk = eng.prepare_batch(blocks)
    home = eng.mesh.home
    d1 = torch.zeros(2, device=home)
    dk = torch.zeros((k, 2), device=home)

    def run_single():
        h = eng.fresh_history()
        for b in iq1:
            v, h = eng.step(b, d1, h)
        return v

    def run_multi():
        return eng.multi_step(iqk, dk, eng.fresh_history())[0]

    out = {"devices": n_dev, "k": k,
           "path": "block-DP" if getattr(eng.multi_step, "merged_input",
                                         False) else "scan"}
    for name, fn in (("single", run_single), ("multi", run_multi)):
        before = eng.launch_counts()
        fn()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(device)
        dt = time.perf_counter() - t0
        out[f"{name}_samples_per_s"] = round(2 * num_samp * k * iters / dt, 1)
        out[f"{name}_launches"] = _launches(eng, before)
    out["multi_speedup"] = round(
        out["multi_samples_per_s"] / out["single_samples_per_s"], 3)
    return out


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Samples/s of the sharded FX step over 1..N shards of "
                    "one device (weak scaling), or K single steps against "
                    "one K-block call (--multi).")
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4],
                   help="shard counts to sweep")
    p.add_argument("--freq", type=int, default=2,
                   help="mesh_freq for the meshes it divides")
    p.add_argument("--block_pow", type=int, default=21,
                   help="log2 of the samples a shard (a block with --multi)")
    p.add_argument("--nbins", type=int, default=4096)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--multi", type=int, default=0, metavar="K",
                   help="instead of the sweep, K single steps against one "
                        "K-block call on each mesh of 2 shards or more")
    p.add_argument("--fused", default="auto",
                   help="fused knob for --multi (auto|true|false)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device the shards are on; cuda raises "
                        "without a card")
    return p


def main(argv=None) -> dict:
    """Run the sweep (or ``--multi``), print one JSON line a row and the
    metric line; returns the metric line's object."""
    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda."
                           "is_available() is False; ask for 'cpu'")
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    print(f"# NOTE: {max(args.devices)} shard(s) of one {name} device: the "
          "host's and the launches' cost of sharding, not multi-card "
          "scaling", file=sys.stderr)

    if args.multi:
        fused = {"auto": "auto", "true": True, "false": False}[
            str(args.fused).lower()]
        rows = []
        for c in args.devices:
            if c < 2:
                continue
            rows.append(measure_multi(c, args.block_pow, args.nbins,
                                      args.iters, args.multi, fused,
                                      args.device))
            print(json.dumps(rows[-1]), flush=True)
        result = {"metric": "sharded_multi_dispatch_amortization",
                  "platform": args.device, "device_name": name, "rows": rows}
        print(json.dumps(result), flush=True)
        return result

    base = base_c = None
    rows = []
    for c in args.devices:
        got = measure(c, args.freq, args.block_pow, args.nbins, args.iters,
                      args.device)
        rate = got["samples_per_s"]
        if base is None:
            base, base_c = rate, c   # the smallest mesh's rate
        rows.append({"devices": c, "samples_per_s": round(rate, 1),
                     "per_device": round(rate / c, 1),
                     "efficiency_vs_linear": round(rate / (base * c / base_c),
                                                   4),
                     "steps": got["steps"], "launches": got["launches"]})
        print(json.dumps(rows[-1]), flush=True)
    result = {"metric": "sharded_scaling_sweep", "platform": args.device,
              "device_name": name, "rows": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
