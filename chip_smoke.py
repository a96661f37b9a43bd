#!/usr/bin/env python3
"""Drive the fxtpu_torch port once on a CUDA card and check it.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, with no ``ok`` line):

1. print the card (``nvidia-smi`` name and power limit), the torch, CUDA
   and nvcc versions and whether ``native/libfxring.so`` (the host ring
   buffer and quantizer) is present, then build the CUDA kernels from
   ``fxtpu_torch/csrc``;
2. hold each kernel against its plain torch version on the card, over 3
   chained blocks from a fresh history at two shapes (nbins=256 with 3
   channels and all pairs with autos; the flagship 2 channels x 2^18
   samples x 4096 bins x 4 taps): ``max|xp_k - xp_ref| <= 2e-5
   max|xp_ref|``, the fused-against-unfused tolerance of
   ``tests/test_planes.py``; for ``fx_fused`` the history within 1e-6,
   for ``fx_fused_i8`` (8-bit samples) the raw tail exact and ``mu_prev``
   within 1e-6 max|mu|;
3. the main path, ``fxtpu_torch.cli.main`` for 3 s at the CLI defaults
   (2 channels, 2^18-sample blocks, 4096 bins, 4 taps, SPECTRUM) on the
   card, once with complex64 ingest and once with ``--ingest int8``
   (int8 rings, 1 MiB per block to the card), each with every launch
   count set to 0 just before and read just after: the run's kernel ran
   once per correlated block and the other kernel not at all, the
   calibration recovered the injected 2 us delay within 0.5 sample, the
   calibrated in-band phase is flat (std < 0.3 rad, 0.35 under int8) and
   the CSV loads with the reference recipe;
4. times at the flagship shape (CUDA events, median of 2 x 60 calls after
   warm-up, plain and kernel in turns): each kernel against its plain
   version, the engine step on either route for both ingests, and the
   host-to-device copy of one block (host clock to a synchronize).

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
MU_TOL = 1e-6        # int8 mu_prev, relative to max|mu_ref|
STEP = 1.0 / 32      # quant_step of 8-bit samples, the CLI default


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


def make_case_i8(case, rng, device):
    """Window, pairs and 3 chained blocks of 8-bit samples [nch, S, nbins,
    2] (noise of ~30 quant units plus a DC offset of a few quant units
    per channel), and the fresh raw-tail history."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor, pfb_window
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    s = case["nsamp"] // nbins
    w = torch.as_tensor(pfb_window(ntaps, nbins).reshape(ntaps, nbins)
                        .astype(np.float32), device=device)
    pairs = pairs_tensor(baseline_pairs(nch, case["autos"]), nch, device)
    dc = np.array([3.0, -2.0]) * np.arange(1, nch + 1)[:, None, None, None]
    blocks = [torch.as_tensor(
        np.clip(np.rint(30 * rng.normal(size=(nch, s, nbins, 2)) + dc),
                -127, 127).astype(np.int8), device=device)
        for _ in range(3)]
    hist = {"tail": torch.zeros((nch, ntaps - 1, nbins, 2),
                                dtype=torch.int8, device=device),
            "mu_prev": torch.zeros((nch,), dtype=torch.complex64,
                                   device=device)}
    return w, pairs, blocks, hist


def compare_kernel_i8(case, device):
    """Phase 2 for the int8 kernel at one shape: (max abs err, max rel
    err) of xp."""
    import torch

    from fxtpu_torch.ops.fx_fused import (fx_fused_raw_i8,
                                          fx_fused_raw_i8_reference)
    w, pairs, blocks, h0 = make_case_i8(case, np.random.default_rng(4321),
                                        device)
    hk = hr = h0
    abs_err = rel_err = 0.0
    for k, x in enumerate(blocks):
        xk, hk = fx_fused_raw_i8(x, hk, w, pairs, STEP)
        xr, hr = fx_fused_raw_i8_reference(x, hr, w, pairs, STEP)
        torch.cuda.synchronize()
        if not (torch.isfinite(torch.view_as_real(xk)).all()
                and torch.isfinite(torch.view_as_real(hk["mu_prev"])).all()):
            raise AssertionError(f"non-finite int8 kernel output at {case}")
        err = (xk - xr).abs().max().item()
        scale = xr.abs().max().item()
        tail_ok = torch.equal(hk["tail"], hr["tail"])
        mu_err = (hk["mu_prev"] - hr["mu_prev"]).abs().max().item()
        mu_scale = hr["mu_prev"].abs().max().item()
        print(f"  block {k}: max|xp_k - xp_ref| = {err:.6g} "
              f"({err / scale:.3g} of max|xp_ref| = {scale:.6g}), tail "
              f"exact {tail_ok}, mu err {mu_err:.3g} of max|mu| "
              f"{mu_scale:.6g}", flush=True)
        if err > REL_TOL * scale or not tail_ok or mu_err > MU_TOL * mu_scale:
            raise AssertionError(
                f"int8 kernel disagrees with its plain version at {case}: "
                f"xp {err / scale:.3g} > {REL_TOL}, tail exact {tail_ok} or "
                f"mu {mu_err:.3g} > {MU_TOL} * {mu_scale:.3g}")
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / scale)
    return abs_err, rel_err


def run_main_path(tmpdir, ingest):
    """Phase 3: the CLI on the card at one ingest dtype, with the launch
    counts of the run: its kernel once per block, the other not at all."""
    from fxtpu_torch.cli import main as cli_main
    from fxtpu_torch.ops.fx_fused import fx_fused_raw, fx_fused_raw_i8
    from fxtpu_torch.products import load_products
    out = os.path.join(tmpdir, f"vis_{ingest}.csv")
    true_delay = 2e-6
    int8 = ingest == "int8"
    fx_fused_raw.launches = fx_fused_raw_i8.launches = 0
    cor = cli_main(["--time", "3", "--mode", "spectrum", "--true_delay",
                    str(true_delay), "--ingest", ingest, "--no_keyboard",
                    "--omit_plot", "--output", out, "--device", "cuda"])
    counts = {"fx_fused": fx_fused_raw.launches,
              "fx_fused_i8": fx_fused_raw_i8.launches}
    launches = counts["fx_fused_i8" if int8 else "fx_fused"]
    other = counts["fx_fused" if int8 else "fx_fused_i8"]
    cfg = cor.config
    print(f"  blocks processed {cor.blocks_processed}, launches {counts}, "
          f"kernel_active {cor.engine.kernel_active}, int8_native "
          f"{cor.engine.int8_native}, rings {cor.bufs[0].dtype} "
          f"{cor.bufs[0].block_shape}", flush=True)
    if not cor.engine.kernel_active or cor.engine.int8_native != int8:
        raise AssertionError("the CLI run did not take the kernel route")
    if int8 and not (cor.bufs[0].dtype == np.int8
                     and cor.bufs[0].block_shape == (cfg.num_samp, 2)):
        raise AssertionError("the int8 run's rings are not int8")
    if not (launches == cor.blocks_processed >= 3) or other != 0:
        raise AssertionError(
            f"launches {counts} do not match blocks_processed "
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
    ph_max = 0.35 if int8 else 0.3
    print(f"  in-band phase std {ph_std:.4f} rad", flush=True)
    if not ph_std < ph_max:
        raise AssertionError(f"in-band phase std {ph_std} >= {ph_max} rad")
    rates = cor.metrics.rates(since="steady", until="end")
    print(f"  [{ingest}] steady state: {rates['blocks_per_s']:.4f} "
          f"blocks/s, {rates['samples_per_s'] / 1e6:.4f} Msamp/s over "
          f"{rates['elapsed_s']:.3f} s; {cor.metrics.report()}", flush=True)
    return launches


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
    """Phase 4: each kernel vs its plain version, the engine step on
    either route for both ingests, and one block's copy to the card."""
    import torch

    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.ops.fx_fused import (fx_fused_raw, fx_fused_raw_i8,
                                          fx_fused_raw_i8_reference,
                                          fx_fused_raw_reference)
    from fxtpu_torch.ops.xengine import pack_delays
    from fxtpu_torch.runtime.native import quantize_c64
    w, pairs, blocks, hist = make_case(FLAGSHIP, np.random.default_rng(7),
                                       device)
    x = blocks[0]
    _, _, blocks8, hist8 = make_case_i8(FLAGSHIP, np.random.default_rng(9),
                                        device)
    x8 = blocks8[0]
    kt = cuda_times({
        "plain": lambda: fx_fused_raw_reference(x, hist, w, pairs),
        "kernel": lambda: fx_fused_raw(x, hist, w, pairs),
        "plain_i8": lambda: fx_fused_raw_i8_reference(x8, hist8, w, pairs,
                                                      STEP),
        "kernel_i8": lambda: fx_fused_raw_i8(x8, hist8, w, pairs, STEP),
    })
    rng = np.random.default_rng(8)
    iq_np = (rng.normal(size=(2, 2**18, 2)) @ np.array([1.0, 1j])
             ).astype(np.complex64)
    d = torch.as_tensor(pack_delays([0.0, 2e-6], 1.4204e9), device=device)
    steps, copies = {}, {}
    for ingest in ("complex64", "int8"):
        cfg = CorrelatorConfig(device="cuda", ingest_dtype=ingest,
                               quant_step=STEP)
        sfx = "_i8" if ingest == "int8" else ""
        block = iq_np if ingest == "complex64" else quantize_c64(iq_np, STEP)
        vis = {}
        for route, fused in (("kernel", True), ("plain", False)):
            eng = FxEngine(cfg, fused=fused)
            iq, h = eng.prepare_block(block), eng.fresh_history()
            vis[route], _ = eng.step(iq, d, h)
            steps[route + sfx] = (lambda e=eng, i=iq, hh=h: e.step(i, d, hh))
            if fused:   # the main path's copy: framed on the host, then sent
                copies[ingest] = (lambda e=eng, b=block: e.prepare_block(b))
        verr = ((vis["kernel"] - vis["plain"]).abs().max()
                / vis["plain"].abs().max()).item()
        print(f"  [{ingest}] engine step, kernel route against plain route: "
              f"{verr:.3g} of max|vis|", flush=True)
        if not verr <= REL_TOL:
            raise AssertionError(f"{ingest} engine routes disagree: {verr} > "
                                 f"{REL_TOL}")
    st = cuda_times(steps)
    return kt, st, host_times(copies)


def host_times(fns, n=30, warm=3):
    """Median ms per call of each fn by the host clock, each call ended
    by a synchronize, in turns (a, b, b, a)."""
    import torch
    samples = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for key in order:
        for _ in range(warm):
            fns[key]()
        torch.cuda.synchronize()
        for _ in range(n):
            t0 = time.perf_counter()
            fns[key]()
            torch.cuda.synchronize()
            samples[key].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in samples.items()}


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

    native_lib = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "native", "libfxring.so")
    print(f"native/libfxring.so present: {os.path.exists(native_lib)}",
          flush=True)

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    load_kernels()
    from fxtpu_torch import cuda_build
    print(f"  {library_path().name} ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "bytes stack" in line or "Compiling" in line:
            print(f"  {line.strip()}", flush=True)

    print("phase 2: kernels against their plain versions", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    errs = {"fx_fused": (0.0, 0.0), "fx_fused_i8": (0.0, 0.0)}
    for name, compare in (("fx_fused", compare_kernel),
                          ("fx_fused_i8", compare_kernel_i8)):
        for case in (SMALL, FLAGSHIP):
            print(f"  {name} shape {case}", flush=True)
            errs[name] = tuple(map(max, errs[name], compare(case, device)))

    print("phase 3: main path (python -m fxtpu_torch)", flush=True)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, ingest in (("fx_fused", "complex64"),
                             ("fx_fused_i8", "int8")):
            print(f"  --ingest {ingest}", flush=True)
            launches[name] = run_main_path(tmp, ingest)

    print("phase 4: times at the flagship shape", flush=True)
    kt, st, h2d = time_flagship(device)
    samples = FLAGSHIP["nch"] * FLAGSHIP["nsamp"]
    for name, sfx in (("fx_fused", ""), ("fx_fused_i8", "_i8")):
        print(f"  [{card}] {name} kernel {kt['kernel' + sfx]:.4f} ms, plain "
              f"torch {kt['plain' + sfx]:.4f} ms", flush=True)
        print(f"  [{card}] {name} engine step: kernel route "
              f"{st['kernel' + sfx]:.4f} ms "
              f"({samples / st['kernel' + sfx] / 1e6:.4f} GS/s), plain "
              f"route {st['plain' + sfx]:.4f} ms "
              f"({samples / st['plain' + sfx] / 1e6:.4f} GS/s)", flush=True)
    for ingest, ms in h2d.items():
        print(f"  [{card}] one block to the card ({ingest}): {ms:.4f} ms",
              flush=True)

    kernels = []
    for name, sfx, ingest in (("fx_fused", "", "complex64"),
                              ("fx_fused_i8", "_i8", "int8")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "fxtpu_torch/csrc/fx_fused.cu",
            "replaces": ("fxtpu/ops/pfb_pallas.py:785" if sfx
                         else "fxtpu/ops/pfb_pallas.py:468"),
            "launches": launches[name],
            "max_abs_err": errs[name][0],
            "max_rel_err": errs[name][1],
            "ms": kt["kernel" + sfx],
            "plain_ms": kt["plain" + sfx],
            "step_ms": st["kernel" + sfx],
            "plain_step_ms": st["plain" + sfx],
            "h2d_ms": h2d[ingest],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
