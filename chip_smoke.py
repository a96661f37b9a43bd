#!/usr/bin/env python3
"""Drive the fxtpu_torch port once on a CUDA card and check it.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, with no ``ok`` line):

1. print the card (``nvidia-smi`` name and power limit) and the torch,
   CUDA and nvcc versions, then build the CUDA kernels from
   ``fxtpu_torch/csrc``;
2. hold the fused FX kernel against its plain torch version on the card,
   over 3 chained blocks at two shapes (nbins=256 with 3 channels and all
   pairs with autos; the flagship 2 channels x 2^18 samples x 4096 bins x
   4 taps): ``max|xp_k - xp_ref| <= 2e-5 max|xp_ref|`` and the history
   within 1e-6, the fused-against-unfused tolerance of
   ``tests/test_planes.py``;
3. the main path: ``fxtpu_torch.cli.main`` for 3 s at the CLI defaults
   (2 channels, 2^18-sample blocks, 4096 bins, 4 taps, SPECTRUM) on the
   card, asserting that the kernel ran once per correlated block, that the
   calibration recovered the injected 2 us delay within 0.5 sample, that
   the calibrated in-band phase is flat (std < 0.3 rad) and that the CSV
   loads with the reference recipe;
4. times at the flagship shape (CUDA events, median of 2 x 60 calls after
   warm-up, plain and kernel in turns): the kernel against its plain
   version, and the engine step on either route.

It prints one JSON line of kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

FLAGSHIP = dict(nch=2, nsamp=2**18, nbins=4096, ntaps=4, autos=False)
SMALL = dict(nch=3, nsamp=32 * 256, nbins=256, ntaps=4, autos=True)
REL_TOL = 2e-5       # xp, relative to max|xp_ref| (tests/test_planes.py)
HIST_TOL = 1e-6      # history, absolute


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def nvcc_version() -> str:
    from fxtpu_torch.cuda_build import nvcc_path
    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def make_case(case, rng, device):
    """Window, pairs and 3 chained blocks of numpy-seeded data with a
    per-channel DC offset (so the mean removal is exercised)."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor, pfb_window
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    s = case["nsamp"] // nbins
    w = torch.as_tensor(pfb_window(ntaps, nbins).reshape(ntaps, nbins)
                        .astype(np.float32), device=device)
    pairs = pairs_tensor(baseline_pairs(nch, case["autos"]), nch, device)
    blocks = []
    for _ in range(3):
        x = (rng.normal(size=(nch, s, nbins))
             + 1j * rng.normal(size=(nch, s, nbins))
             + (0.3 - 0.2j) * np.arange(1, nch + 1)[:, None, None])
        blocks.append(torch.as_tensor(x.astype(np.complex64), device=device))
    hist = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64,
                       device=device)
    return w, pairs, blocks, hist


def compare_kernel(case, device):
    """Phase 2 at one shape: returns (max abs err, max rel err) of xp."""
    import torch

    from fxtpu_torch.ops.fx_fused import fx_fused_raw, fx_fused_raw_reference
    w, pairs, blocks, h0 = make_case(case, np.random.default_rng(1234),
                                     device)
    hk = hr = h0
    abs_err = rel_err = 0.0
    for k, x in enumerate(blocks):
        xk, hk = fx_fused_raw(x, hk, w, pairs)
        xr, hr = fx_fused_raw_reference(x, hr, w, pairs)
        torch.cuda.synchronize()
        if not (torch.isfinite(torch.view_as_real(xk)).all()
                and torch.isfinite(torch.view_as_real(hk)).all()):
            raise AssertionError(f"non-finite kernel output at {case}")
        err = (xk - xr).abs().max().item()
        scale = xr.abs().max().item()
        herr = (hk - hr).abs().max().item()
        print(f"  block {k}: max|xp_k - xp_ref| = {err:.6g} "
              f"({err / scale:.3g} of max|xp_ref| = {scale:.6g}), "
              f"history err {herr:.3g}", flush=True)
        if err > REL_TOL * scale or herr > HIST_TOL:
            raise AssertionError(
                f"kernel disagrees with its plain version at {case}: "
                f"xp {err / scale:.3g} > {REL_TOL} or history {herr:.3g} "
                f"> {HIST_TOL}")
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / scale)
    return abs_err, rel_err


def run_main_path(tmpdir):
    """Phase 3: the CLI on the card, with the launch count of the run."""
    from fxtpu_torch.cli import main as cli_main
    from fxtpu_torch.ops.fx_fused import fx_fused_raw
    from fxtpu_torch.products import load_products
    out = os.path.join(tmpdir, "vis.csv")
    true_delay = 2e-6
    fx_fused_raw.launches = 0
    cor = cli_main(["--time", "3", "--mode", "spectrum", "--true_delay",
                    str(true_delay), "--no_keyboard", "--omit_plot",
                    "--output", out, "--device", "cuda"])
    launches = fx_fused_raw.launches
    cfg = cor.config
    print(f"  blocks processed {cor.blocks_processed}, kernel launches "
          f"{launches}, kernel_active {cor.engine.kernel_active}",
          flush=True)
    if not cor.engine.kernel_active:
        raise AssertionError("the CLI run did not take the kernel route")
    if not (launches == cor.blocks_processed >= 3):
        raise AssertionError(
            f"launches {launches} != blocks_processed "
            f"{cor.blocks_processed} (or fewer than 3 blocks)")
    err_samples = abs(cor.calibrated_delays[1] - true_delay) * cfg.bandwidth
    print(f"  calibration error {err_samples:.4f} samples", flush=True)
    if not err_samples < 0.5:
        raise AssertionError(f"calibration error {err_samples} >= 0.5")
    # the reference recipe for product files: complex rows after the header
    data = np.loadtxt(out, dtype=np.complex128, delimiter=",", skiprows=2)
    data = np.atleast_2d(data)
    md, _ = load_products(out)
    if data.shape != (cor.blocks_processed, cfg.nbins):
        raise AssertionError(f"CSV shape {data.shape}, expected "
                             f"{(cor.blocks_processed, cfg.nbins)}")
    if not np.isfinite(data).all() or md["mode"] != "SPECTRUM":
        raise AssertionError("CSV holds non-finite values or wrong mode")
    inner = slice(cfg.nbins // 4, 3 * cfg.nbins // 4)
    ph_std = float(np.std(np.unwrap(np.angle(data.mean(axis=0)[inner]))))
    print(f"  in-band phase std {ph_std:.4f} rad", flush=True)
    if not ph_std < 0.3:
        raise AssertionError(f"in-band phase std {ph_std} >= 0.3 rad")
    return launches, cor


def cuda_times(fns, n=60, warm=5):
    """Median ms per call of each fn, timed with CUDA events in turns
    (a, b, b, a) so drift hits both alike."""
    import torch
    samples = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for key in order:
        fn = fns[key]
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(n):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        samples[key] += [s.elapsed_time(e) for s, e in evs]
    return {k: statistics.median(v) for k, v in samples.items()}


def time_flagship(device):
    """Phase 4: kernel vs plain version, engine step on either route."""
    import torch

    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.ops.fx_fused import fx_fused_raw, fx_fused_raw_reference
    from fxtpu_torch.ops.xengine import pack_delays
    w, pairs, blocks, hist = make_case(FLAGSHIP, np.random.default_rng(7),
                                       device)
    x = blocks[0]
    kt = cuda_times({
        "plain": lambda: fx_fused_raw_reference(x, hist, w, pairs),
        "kernel": lambda: fx_fused_raw(x, hist, w, pairs),
    })
    cfg = CorrelatorConfig(device="cuda")
    eng_k = FxEngine(cfg, fused=True)
    eng_p = FxEngine(cfg, fused=False)
    iq_np = (np.random.default_rng(8).normal(size=(2, cfg.num_samp, 2))
             @ np.array([1.0, 1j])).astype(np.complex64)
    iq_k, iq_p = eng_k.prepare_block(iq_np), eng_p.prepare_block(iq_np)
    d = torch.as_tensor(pack_delays([0.0, 2e-6], cfg.frequency),
                        device=device)
    hk, hp = eng_k.fresh_history(), eng_p.fresh_history()
    vk, _ = eng_k.step(iq_k, d, hk)
    vp, _ = eng_p.step(iq_p, d, hp)
    verr = ((vk - vp).abs().max() / vp.abs().max()).item()
    print(f"  engine step, kernel route against plain route: {verr:.3g} of "
          f"max|vis|", flush=True)
    if not verr <= REL_TOL:
        raise AssertionError(f"engine routes disagree: {verr} > {REL_TOL}")
    st = cuda_times({
        "plain": lambda: eng_p.step(iq_p, d, hp),
        "kernel": lambda: eng_k.step(iq_k, d, hk),
    })
    return kt, st, cfg


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    import fxtpu_torch  # noqa: F401  (fails when run outside the repo)
    from fxtpu_torch.cuda_build import library_path, load_kernels

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{nvcc_version()}, python {sys.version.split()[0]}", flush=True)
    device = torch.device("cuda", 0)

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    load_kernels()
    from fxtpu_torch import cuda_build
    print(f"  {library_path().name} ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "bytes stack" in line or "Compiling" in line:
            print(f"  {line.strip()}", flush=True)

    print("phase 2: kernel against plain version", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    for case in (SMALL, FLAGSHIP):
        print(f"  shape {case}", flush=True)
        abs_err, rel_err = compare_kernel(case, device)

    print("phase 3: main path (python -m fxtpu_torch)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        launches, cor = run_main_path(tmp)

    print("phase 4: times at the flagship shape", flush=True)
    kt, st, cfg = time_flagship(device)
    samples = cfg.nchan * cfg.num_samp
    print(f"  [{card}] fx_fused kernel {kt['kernel']:.4f} ms, plain torch "
          f"{kt['plain']:.4f} ms", flush=True)
    print(f"  [{card}] engine step: kernel route {st['kernel']:.4f} ms "
          f"({samples / st['kernel'] / 1e6:.4f} GS/s), plain route "
          f"{st['plain']:.4f} ms ({samples / st['plain'] / 1e6:.4f} GS/s)",
          flush=True)
    print(f"  main-path run: {cor.metrics.report()}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fx_fused",
        "route": "cuda",
        "source": "fxtpu_torch/csrc/fx_fused.cu",
        "replaces": "fxtpu/ops/pfb_pallas.py:468",
        "launches": launches,
        "max_abs_err": abs_err,
        "max_rel_err": rel_err,
        "ms": kt["kernel"],
        "plain_ms": kt["plain"],
        "step_ms": st["kernel"],
        "plain_step_ms": st["plain"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
