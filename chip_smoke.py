#!/usr/bin/env python3
"""Drive the fxtpu_torch port once on a CUDA card and check it.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Shapes: the flagship (the CLI defaults: 2 channels, 2^18-sample blocks,
4096 bins, 4 taps) and the wideband configuration of ``bench.py``
(``wideband`` / ``wideband_int8``: 2 channels, 2^21-sample blocks, 8192
bins, 32 taps, where the fused step's FIR runs through the window's
rank-6 factors, the SVD-FIR mode).

Phases (any failure raises and exits non-zero, with no ``ok`` line):

1. print the card (``nvidia-smi`` name and power limit), the torch, CUDA
   and nvcc versions and whether ``native/libfxring.so`` (the host ring
   buffer and quantizer) is present, then build the CUDA kernels from
   ``fxtpu_torch/csrc``;
2. hold each kernel entry against its plain torch version on the card,
   over 3 chained blocks from a fresh history: the fused FX step in the
   direct-loop mode (``fx_fused``, ``fx_fused_i8``) at nbins=256 with 3
   channels and autos, at the flagship and at the wideband shape; in the
   SVD-FIR mode (``fx_fused_svd``, ``fx_fused_i8_svd``) at nbins=256 x 32
   taps x 3 channels with autos and at the wideband shape: ``max|xp_k -
   xp_ref| <= 2e-5 max|xp_ref|``, the fused-against-unfused tolerance of
   ``tests/test_planes.py``, for complex64 the history within 1e-6, for
   8-bit samples the raw tail exact and ``mu_prev`` within 1e-6 max|mu|;
   the spectrometer (``spectrometer``) at nbins=256 with 4 taps (a ragged
   tail) and 1 tap and at the flagship: spectra within 5e-6 max|spec|
   (``tests/test_planes.py:301``), history within 1e-6;
3. the main path, ``fxtpu_torch.cli.main`` for 3 s on the card, at the
   CLI defaults and at ``--resolution 8192 --ntaps 32`` (the deep-tap
   path), each with complex64 ingest and with ``--ingest int8`` (int8
   rings), each with every launch count set to 0 just before and read
   just after: the run's kernel entry ran once per correlated block and
   no other at all, the engine's ``fir_mode`` is the run's (``direct``,
   ``svd``), the calibration recovered the injected 2 us delay within 0.5
   sample, the calibrated in-band phase is flat (std < 0.3 rad, 0.35
   under int8) and the CSV loads with the reference recipe; then the
   F-stage entry ``spectrometer_fused``, which no main path calls, over 3
   chained flagship blocks, counted the same way;
4. times (CUDA events, median of 2 x n calls after warm-up, in turns): at
   the flagship each direct-loop kernel against its plain version, the
   engine step on either route for both ingests, the host-to-device copy
   of one block (host clock to a synchronize) and the spectrometer
   against its plain version; at the wideband shape the SVD-FIR kernel,
   the direct-loop kernel and both plain versions for each ingest, the
   engine step on either route (the kernel route in the SVD mode) and one
   block's copy.

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
# bench.py's wideband configuration at its full width
WIDEBAND = dict(nch=2, nsamp=2**21, nbins=8192, ntaps=32, autos=False)
SMALL_DEEP = dict(nch=3, nsamp=64 * 256, nbins=256, ntaps=32, autos=True)
SPEC_CASES = (dict(nch=3, nsamp=32 * 256 + 100, nbins=256, ntaps=4),
              dict(nch=3, nsamp=32 * 256, nbins=256, ntaps=1),
              dict(nch=2, nsamp=2**18, nbins=4096, ntaps=4))
REL_TOL = 2e-5       # xp, relative to max|xp_ref| (tests/test_planes.py)
DEEP_TOL = 3e-5      # deep-tap routes against each other (test_planes:485)
SPEC_TOL = 5e-6      # spectra, relative to max|spec_ref| (test_planes:301)
HIST_TOL = 1e-6      # history, absolute
MU_TOL = 1e-6        # int8 mu_prev, relative to max|mu_ref|
STEP = 1.0 / 32      # quant_step of 8-bit samples, the CLI default
SOURCE = "fxtpu_torch/csrc/fx_fused.cu"
# entry -> the TPU kernel (or mode of it) it replaces
REPLACES = {
    "fx_fused": "fxtpu/ops/pfb_pallas.py:468",
    "fx_fused_i8": "fxtpu/ops/pfb_pallas.py:785",
    "fx_fused_svd": "fxtpu/ops/pfb_pallas.py:810",
    "fx_fused_i8_svd": "fxtpu/ops/pfb_pallas.py:831",
    "spectrometer": "fxtpu/ops/pfb_pallas.py:133",
}


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


def reset_counts():
    from fxtpu_torch.ops.fx_fused import fx_fused_raw, fx_fused_raw_i8
    from fxtpu_torch.ops.spectrometer import spectrometer_fused
    for fn in (fx_fused_raw, fx_fused_raw_i8):
        fn.launches = fn.svd_launches = 0
    spectrometer_fused.launches = 0


def read_counts() -> dict:
    from fxtpu_torch.ops.fx_fused import fx_fused_raw, fx_fused_raw_i8
    from fxtpu_torch.ops.spectrometer import spectrometer_fused
    return {"fx_fused": fx_fused_raw.launches,
            "fx_fused_svd": fx_fused_raw.svd_launches,
            "fx_fused_i8": fx_fused_raw_i8.launches,
            "fx_fused_i8_svd": fx_fused_raw_i8.svd_launches,
            "spectrometer": spectrometer_fused.launches}


def window_and_fir(case, fir, device):
    """The window as the kernels take it, and the FIR mode's factors
    (None for the direct loop)."""
    import torch

    from fxtpu_torch.ops import pfb_window, svd_tensors
    ntaps, nbins = case["ntaps"], case["nbins"]
    w = pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)
    svd = svd_tensors(w, device) if fir == "svd" else None
    if fir == "svd" and svd is None:
        raise AssertionError(f"the {ntaps}-tap window does not factorise")
    return torch.as_tensor(w, device=device), svd


def make_case(case, rng, device, fir="direct"):
    """Window, FIR factors, pairs and 3 chained blocks of numpy-seeded
    data with a per-channel DC offset (so the mean removal is
    exercised)."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    s = case["nsamp"] // nbins
    w, svd = window_and_fir(case, fir, device)
    pairs = pairs_tensor(baseline_pairs(nch, case["autos"]), nch, device)
    blocks = []
    for _ in range(3):
        x = (rng.normal(size=(nch, s, nbins))
             + 1j * rng.normal(size=(nch, s, nbins))
             + (0.3 - 0.2j) * np.arange(1, nch + 1)[:, None, None])
        blocks.append(torch.as_tensor(x.astype(np.complex64), device=device))
    hist = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64,
                       device=device)
    return w, svd, pairs, blocks, hist


def compare_kernel(case, device, fir):
    """Phase 2 at one shape: returns (max abs err, max rel err) of xp."""
    import torch

    from fxtpu_torch.ops.fx_fused import fx_fused_raw, fx_fused_raw_reference
    w, svd, pairs, blocks, h0 = make_case(case, np.random.default_rng(1234),
                                          device, fir)
    hk = hr = h0
    abs_err = rel_err = 0.0
    for k, x in enumerate(blocks):
        xk, hk = fx_fused_raw(x, hk, w, pairs, svd)
        xr, hr = fx_fused_raw_reference(x, hr, w, pairs, svd)
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
                f"kernel disagrees with its plain version at {case} ({fir}): "
                f"xp {err / scale:.3g} > {REL_TOL} or history {herr:.3g} "
                f"> {HIST_TOL}")
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / scale)
    return abs_err, rel_err


def make_case_i8(case, rng, device, fir="direct"):
    """Window, FIR factors, pairs and 3 chained blocks of 8-bit samples
    [nch, S, nbins, 2] (noise of ~30 quant units plus a DC offset of a
    few quant units per channel), and the fresh raw-tail history."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    s = case["nsamp"] // nbins
    w, svd = window_and_fir(case, fir, device)
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
    return w, svd, pairs, blocks, hist


def compare_kernel_i8(case, device, fir):
    """Phase 2 for the int8 kernel at one shape: (max abs err, max rel
    err) of xp."""
    import torch

    from fxtpu_torch.ops.fx_fused import (fx_fused_raw_i8,
                                          fx_fused_raw_i8_reference)
    w, svd, pairs, blocks, h0 = make_case_i8(
        case, np.random.default_rng(4321), device, fir)
    hk = hr = h0
    abs_err = rel_err = 0.0
    for k, x in enumerate(blocks):
        xk, hk = fx_fused_raw_i8(x, hk, w, pairs, STEP, svd)
        xr, hr = fx_fused_raw_i8_reference(x, hr, w, pairs, STEP, svd)
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
                f"int8 kernel disagrees with its plain version at {case} "
                f"({fir}): xp {err / scale:.3g} > {REL_TOL}, tail exact "
                f"{tail_ok} or mu {mu_err:.3g} > {MU_TOL} * {mu_scale:.3g}")
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / scale)
    return abs_err, rel_err


def make_spec_case(case, rng, device):
    """Window and 3 blocks [nch, nsamp] (nsamp need not be a multiple of
    nbins) with a DC offset per channel, and the fresh history."""
    import torch
    nch, nsamp = case["nch"], case["nsamp"]
    w, _ = window_and_fir(case, "direct", device)
    blocks = [torch.as_tensor(
        (rng.normal(size=(nch, nsamp)) + 1j * rng.normal(size=(nch, nsamp))
         + (0.3 - 0.2j) * np.arange(1, nch + 1)[:, None]
         ).astype(np.complex64), device=device) for _ in range(3)]
    hist = torch.zeros((nch, case["ntaps"] - 1, case["nbins"]),
                       dtype=torch.complex64, device=device)
    return w, blocks, hist


def compare_spectrometer(case, device):
    """Phase 2 for the spectrometer: (max abs err, max rel err) of the
    spectra over 3 chained blocks."""
    import torch

    from fxtpu_torch.ops.spectrometer import (spectrometer_fused,
                                              spectrometer_fused_reference)
    w, blocks, h0 = make_spec_case(case, np.random.default_rng(5678), device)
    nbins = case["nbins"]
    hk = hr = h0
    abs_err = rel_err = 0.0
    for k, x in enumerate(blocks):
        sk, hk = spectrometer_fused(x, w, nbins, hk)
        sr, hr = spectrometer_fused_reference(x, w, nbins, hr)
        torch.cuda.synchronize()
        if not torch.isfinite(torch.view_as_real(sk)).all():
            raise AssertionError(f"non-finite spectra at {case}")
        if sk.shape != sr.shape or hk.shape != hr.shape:
            raise AssertionError(f"shapes {tuple(sk.shape)}, "
                                 f"{tuple(hk.shape)} at {case}")
        err = (sk - sr).abs().max().item()
        scale = sr.abs().max().item()
        herr = (hk - hr).abs().max().item() if hk.numel() else 0.0
        print(f"  block {k}: max|spec_k - spec_ref| = {err:.6g} "
              f"({err / scale:.3g} of max|spec_ref| = {scale:.6g}), "
              f"history err {herr:.3g}", flush=True)
        if err > SPEC_TOL * scale or herr > HIST_TOL:
            raise AssertionError(
                f"spectrometer disagrees with its plain version at {case}: "
                f"{err / scale:.3g} > {SPEC_TOL} or history {herr:.3g} > "
                f"{HIST_TOL}")
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / scale)
    return abs_err, rel_err


def run_main_path(tmpdir, ingest, deep):
    """Phase 3: the CLI on the card at one ingest dtype and depth, with
    the launch counts of the run: its kernel entry once per block, every
    other entry not at all.  Returns (entry name, its launches)."""
    from fxtpu_torch.cli import main as cli_main
    from fxtpu_torch.products import load_products
    int8 = ingest == "int8"
    name = ("fx_fused_i8" if int8 else "fx_fused") + ("_svd" if deep else "")
    out = os.path.join(tmpdir, f"vis_{name}.csv")
    true_delay = 2e-6
    shape = ["--resolution", "8192", "--ntaps", "32"] if deep else []
    reset_counts()
    cor = cli_main(["--time", "3", "--mode", "spectrum", "--true_delay",
                    str(true_delay), "--ingest", ingest, "--no_keyboard",
                    "--omit_plot", "--output", out, "--device", "cuda",
                    *shape])
    counts = read_counts()
    cfg = cor.config
    eng = cor.engine
    print(f"  blocks processed {cor.blocks_processed}, launches {counts}, "
          f"kernel_active {eng.kernel_active}, int8_native "
          f"{eng.int8_native}, fir_mode {eng.fir_mode}, rings "
          f"{cor.bufs[0].dtype} {cor.bufs[0].block_shape}, nbins "
          f"{cfg.nbins}, ntaps {cfg.ntaps}", flush=True)
    if not eng.kernel_active or eng.int8_native != int8:
        raise AssertionError("the CLI run did not take the kernel route")
    if eng.fir_mode != ("svd" if deep else "direct"):
        raise AssertionError(f"fir_mode {eng.fir_mode} in the {name} run")
    if int8 and not (cor.bufs[0].dtype == np.int8
                     and cor.bufs[0].block_shape == (cfg.num_samp, 2)):
        raise AssertionError("the int8 run's rings are not int8")
    others = {k: v for k, v in counts.items() if k != name}
    if not (counts[name] == cor.blocks_processed >= 3) or any(
            others.values()):
        raise AssertionError(
            f"launches {counts} do not match blocks_processed "
            f"{cor.blocks_processed} of {name} (or fewer than 3 blocks)")
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
    print(f"  [{name}] steady state: {rates['blocks_per_s']:.4f} "
          f"blocks/s, {rates['samples_per_s'] / 1e6:.4f} Msamp/s over "
          f"{rates['elapsed_s']:.3f} s; {cor.metrics.report()}", flush=True)
    return name, counts[name]


def run_spectrometer_path(device):
    """Phase 3, the F-stage entry: ``spectrometer_fused`` over 3 chained
    flagship blocks, as a user calls it, counted like the main path."""
    import torch

    from fxtpu_torch.ops.spectrometer import (spectrometer_fused,
                                              spectrometer_fused_reference)
    case = SPEC_CASES[-1]
    w, blocks, h = make_spec_case(case, np.random.default_rng(91), device)
    reset_counts()
    specs = []
    for x in blocks:
        spec, h = spectrometer_fused(x, w, case["nbins"], h)
        specs.append(spec)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"  spectrometer_fused, 3 flagship blocks: launches {counts}",
          flush=True)
    if counts["spectrometer"] != 3 or sum(counts.values()) != 3:
        raise AssertionError(f"spectrometer launches {counts}, expected 3")
    want, _ = spectrometer_fused_reference(blocks[0], w, case["nbins"],
                                           torch.zeros_like(h))
    err = ((specs[0] - want).abs().max() / want.abs().max()).item()
    if specs[0].shape != (case["nch"], case["nsamp"] // case["nbins"],
                          case["nbins"]) or not err <= SPEC_TOL:
        raise AssertionError(f"spectrometer path: shape "
                             f"{tuple(specs[0].shape)}, err {err}")
    return counts["spectrometer"]


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


def engine_steps(shape_kw, block_c64, d, tol, fir_mode, tag):
    """The engine step on either route for both ingests at one shape:
    (step callables, copy callables), after checking that the two routes
    agree within ``tol`` and that the kernel route runs ``fir_mode``."""
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.runtime.native import quantize_c64
    steps, copies = {}, {}
    for ingest in ("complex64", "int8"):
        cfg = CorrelatorConfig(device="cuda", ingest_dtype=ingest,
                               quant_step=STEP, **shape_kw)
        sfx = "_i8" if ingest == "int8" else ""
        block = (block_c64 if ingest == "complex64"
                 else quantize_c64(block_c64, STEP))
        vis = {}
        for route, fused in (("kernel", True), ("plain", False)):
            eng = FxEngine(cfg, fused=fused)
            if fused and eng.fir_mode != fir_mode:
                raise AssertionError(f"{tag} engine fir_mode {eng.fir_mode}")
            iq, h = eng.prepare_block(block), eng.fresh_history()
            vis[route], _ = eng.step(iq, d, h)
            steps[route + sfx] = (lambda e=eng, i=iq, hh=h: e.step(i, d, hh))
            if fused:   # the main path's copy: framed on the host, then sent
                copies[ingest] = (lambda e=eng, b=block: e.prepare_block(b))
        verr = ((vis["kernel"] - vis["plain"]).abs().max()
                / vis["plain"].abs().max()).item()
        print(f"  [{tag} {ingest}] engine step, kernel route ({fir_mode}) "
              f"against plain route: {verr:.3g} of max|vis|", flush=True)
        if not verr <= tol:
            raise AssertionError(f"{tag} {ingest} engine routes disagree: "
                                 f"{verr} > {tol}")
    return steps, copies


def time_flagship(device):
    """Phase 4 at the flagship: each direct-loop kernel and the
    spectrometer vs its plain version, the engine step on either route
    for both ingests, and one block's copy to the card."""
    import torch

    from fxtpu_torch.ops.fx_fused import (fx_fused_raw, fx_fused_raw_i8,
                                          fx_fused_raw_i8_reference,
                                          fx_fused_raw_reference)
    from fxtpu_torch.ops.spectrometer import (spectrometer_fused,
                                              spectrometer_fused_reference)
    from fxtpu_torch.ops.xengine import pack_delays
    w, _, pairs, blocks, hist = make_case(FLAGSHIP, np.random.default_rng(7),
                                          device)
    x = blocks[0]
    _, _, _, blocks8, hist8 = make_case_i8(FLAGSHIP,
                                           np.random.default_rng(9), device)
    x8 = blocks8[0]
    sc = SPEC_CASES[-1]
    ws, sblocks, shist = make_spec_case(sc, np.random.default_rng(10),
                                        device)
    xs, nb = sblocks[0], sc["nbins"]
    kt = cuda_times({
        "plain": lambda: fx_fused_raw_reference(x, hist, w, pairs),
        "kernel": lambda: fx_fused_raw(x, hist, w, pairs),
        "plain_i8": lambda: fx_fused_raw_i8_reference(x8, hist8, w, pairs,
                                                      STEP),
        "kernel_i8": lambda: fx_fused_raw_i8(x8, hist8, w, pairs, STEP),
        "plain_spec": lambda: spectrometer_fused_reference(xs, ws, nb, shist),
        "kernel_spec": lambda: spectrometer_fused(xs, ws, nb, shist),
    })
    rng = np.random.default_rng(8)
    iq_np = (rng.normal(size=(2, 2**18, 2)) @ np.array([1.0, 1j])
             ).astype(np.complex64)
    d = torch.as_tensor(pack_delays([0.0, 2e-6], 1.4204e9), device=device)
    steps, copies = engine_steps({}, iq_np, d, REL_TOL, "direct", "flagship")
    return kt, cuda_times(steps), host_times(copies)


def time_wideband(device):
    """Phase 4 at the wideband shape: per ingest the SVD-FIR kernel, the
    direct-loop kernel and both plain versions; the engine step on either
    route (the kernel route in the SVD mode) and one block's copy."""
    import torch

    from fxtpu_torch.ops.fx_fused import (fx_fused_raw, fx_fused_raw_i8,
                                          fx_fused_raw_i8_reference,
                                          fx_fused_raw_reference)
    from fxtpu_torch.ops.xengine import pack_delays
    w, svd, pairs, blocks, hist = make_case(
        WIDEBAND, np.random.default_rng(11), device, "svd")
    x = blocks[0]
    _, _, _, blocks8, hist8 = make_case_i8(
        WIDEBAND, np.random.default_rng(12), device, "svd")
    x8 = blocks8[0]
    kt = cuda_times({
        "plain_svd": lambda: fx_fused_raw_reference(x, hist, w, pairs, svd),
        "svd": lambda: fx_fused_raw(x, hist, w, pairs, svd),
        "direct": lambda: fx_fused_raw(x, hist, w, pairs),
        "plain_direct": lambda: fx_fused_raw_reference(x, hist, w, pairs),
        "plain_svd_i8": lambda: fx_fused_raw_i8_reference(
            x8, hist8, w, pairs, STEP, svd),
        "svd_i8": lambda: fx_fused_raw_i8(x8, hist8, w, pairs, STEP, svd),
        "direct_i8": lambda: fx_fused_raw_i8(x8, hist8, w, pairs, STEP),
        "plain_direct_i8": lambda: fx_fused_raw_i8_reference(
            x8, hist8, w, pairs, STEP),
    }, n=20)
    del blocks, blocks8
    rng = np.random.default_rng(13)
    iq_np = (rng.normal(size=(2, WIDEBAND["nsamp"], 2)) @ np.array([1.0, 1j])
             ).astype(np.complex64)
    d = torch.as_tensor(pack_delays([0.0, 2e-6], 1.4204e9), device=device)
    shape = dict(nbins=WIDEBAND["nbins"], ntaps=WIDEBAND["ntaps"],
                 num_samp=WIDEBAND["nsamp"], clamp_num_samp=False)
    steps, copies = engine_steps(shape, iq_np, d, DEEP_TOL, "svd", "wideband")
    return kt, cuda_times(steps, n=20), host_times(copies, n=10)


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

    t_start = time.perf_counter()
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
    errs = {name: (0.0, 0.0) for name in REPLACES}
    for name, compare, fir, cases in (
            ("fx_fused", compare_kernel, "direct",
             (SMALL, FLAGSHIP, WIDEBAND)),
            ("fx_fused_i8", compare_kernel_i8, "direct",
             (SMALL, FLAGSHIP, WIDEBAND)),
            ("fx_fused_svd", compare_kernel, "svd", (SMALL_DEEP, WIDEBAND)),
            ("fx_fused_i8_svd", compare_kernel_i8, "svd",
             (SMALL_DEEP, WIDEBAND))):
        for case in cases:
            print(f"  {name} shape {case}", flush=True)
            errs[name] = tuple(map(max, errs[name],
                                   compare(case, device, fir)))
    for case in SPEC_CASES:
        print(f"  spectrometer shape {case}", flush=True)
        errs["spectrometer"] = tuple(map(max, errs["spectrometer"],
                                         compare_spectrometer(case, device)))

    print("phase 3: main path (python -m fxtpu_torch)", flush=True)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for deep in (False, True):
            for ingest in ("complex64", "int8"):
                print(f"  --ingest {ingest}"
                      + (" --resolution 8192 --ntaps 32" if deep else ""),
                      flush=True)
                name, n = run_main_path(tmp, ingest, deep)
                launches[name] = n
    launches["spectrometer"] = run_spectrometer_path(device)

    print("phase 4: times at the flagship and wideband shapes", flush=True)
    kt, st, h2d = time_flagship(device)
    wkt, wst, wh2d = time_wideband(device)
    samples = FLAGSHIP["nch"] * FLAGSHIP["nsamp"]
    wsamples = WIDEBAND["nch"] * WIDEBAND["nsamp"]
    for name, sfx in (("fx_fused", ""), ("fx_fused_i8", "_i8")):
        print(f"  [{card}] flagship {name} kernel {kt['kernel' + sfx]:.4f} "
              f"ms, plain torch {kt['plain' + sfx]:.4f} ms", flush=True)
        print(f"  [{card}] flagship {name} engine step: kernel route "
              f"{st['kernel' + sfx]:.4f} ms "
              f"({samples / st['kernel' + sfx] / 1e6:.4f} GS/s), plain "
              f"route {st['plain' + sfx]:.4f} ms "
              f"({samples / st['plain' + sfx] / 1e6:.4f} GS/s)", flush=True)
        print(f"  [{card}] wideband {name}: SVD kernel "
              f"{wkt['svd' + sfx]:.4f} ms, direct-loop kernel "
              f"{wkt['direct' + sfx]:.4f} ms, plain SVD "
              f"{wkt['plain_svd' + sfx]:.4f} ms, plain direct "
              f"{wkt['plain_direct' + sfx]:.4f} ms", flush=True)
        print(f"  [{card}] wideband {name} engine step: kernel route (SVD) "
              f"{wst['kernel' + sfx]:.4f} ms "
              f"({wsamples / wst['kernel' + sfx] / 1e6:.4f} GS/s), plain "
              f"route {wst['plain' + sfx]:.4f} ms "
              f"({wsamples / wst['plain' + sfx] / 1e6:.4f} GS/s)", flush=True)
    print(f"  [{card}] flagship spectrometer kernel "
          f"{kt['kernel_spec']:.4f} ms, plain torch {kt['plain_spec']:.4f} ms",
          flush=True)
    for ingest in h2d:
        print(f"  [{card}] one block to the card ({ingest}): flagship "
              f"{h2d[ingest]:.4f} ms, wideband {wh2d[ingest]:.4f} ms",
              flush=True)

    kernels = []
    for name, sfx, ingest in (("fx_fused", "", "complex64"),
                              ("fx_fused_i8", "_i8", "int8")):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": kt["kernel" + sfx], "plain_ms": kt["plain" + sfx],
            "step_ms": st["kernel" + sfx],
            "plain_step_ms": st["plain" + sfx], "h2d_ms": h2d[ingest],
            "wideband_ms": wkt["direct" + sfx],
            "wideband_plain_ms": wkt["plain_direct" + sfx],
        })
    for name, sfx, ingest in (("fx_fused_svd", "", "complex64"),
                              ("fx_fused_i8_svd", "_i8", "int8")):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": wkt["svd" + sfx], "plain_ms": wkt["plain_svd" + sfx],
            "direct_ms": wkt["direct" + sfx],
            "step_ms": wst["kernel" + sfx],
            "plain_step_ms": wst["plain" + sfx], "h2d_ms": wh2d[ingest],
        })
    kernels.append({
        "name": "spectrometer", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["spectrometer"],
        "launches": launches["spectrometer"],
        "max_abs_err": errs["spectrometer"][0],
        "max_rel_err": errs["spectrometer"][1],
        "ms": kt["kernel_spec"], "plain_ms": kt["plain_spec"],
    })
    print(f"  whole run {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
