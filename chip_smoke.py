#!/usr/bin/env python3
"""Drive the fxtpu_torch port once on a CUDA card and check it.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Shapes: the flagship (the CLI defaults: 2 channels, 2^18-sample blocks,
4096 bins, 4 taps), the wideband configuration of ``bench.py``
(``wideband`` / ``wideband_int8``: 2 channels, 2^21-sample blocks, 8192
bins, 32 taps, where the fused step's FIR runs through the window's
rank-6 factors, the SVD-FIR mode), the CLI's deep-tap block (2 x 2^18
samples at 8192 bins and 32 taps) and ``bench.py``'s ``bench_pipeline``
(2 channels, 2^21-sample blocks, 4096 bins, 8 blocks per dispatch).

Phases (any failure raises and exits non-zero, with no ``ok`` line):

1. print the card (``nvidia-smi`` name and power limit), the torch, CUDA
   and nvcc versions and whether ``native/libfxring.so`` (the host ring
   buffer and quantizer) is present, then build the CUDA kernels from
   ``fxtpu_torch/csrc``;
2. hold each kernel entry against its plain torch version on the card,
   over 3 chained blocks from a fresh history: the fused FX step in the
   direct-loop mode (``fx_fused``, ``fx_fused_i8``) at nbins=256 with 3
   channels and autos, at the flagship, at the flagship width with 4
   channels and autos (10 pairs) and at the wideband shape; in the
   SVD-FIR mode (``fx_fused_svd``, ``fx_fused_i8_svd``) at nbins=256 x 32
   taps x 3 channels with autos and at the wideband shape: ``max|xp_k -
   xp_ref| <= 2e-5 max|xp_ref|``, the fused-against-unfused tolerance of
   ``tests/test_planes.py``, for complex64 the history within 1e-6, for
   8-bit samples the raw tail exact and ``mu_prev`` within 1e-6 max|mu|;
   the spectrometer (``spectrometer``) at nbins=256 with 4 taps (a ragged
   tail) and 1 tap and at the flagship: spectra within 5e-6 max|spec|
   (``tests/test_planes.py:301``), history within 1e-6; the K-block
   entries (``fx_fused_multi``, ``fx_fused_i8_multi``) over 2 chained
   launches in both FIR modes, K = 3 at nbins=256 (4 and 32 taps), K = 8
   at the flagship, at ``bench_pipeline``'s block (frames summed in groups
   of 2) and at the CLI's deep-tap block (SVD), and K = 2 at the wideband
   shape: within 2e-5 max|xp_ref| of their plain versions (3e-5 in the SVD
   mode) with the history bounds above, and bit for bit the K one-block
   launches; every stage of the ablation (``fx_ablate``:
   ``ops.fx_fused.fx_fused_ablate``, both ingests, both FIR modes) at
   nbins=256, at the flagship, at the CLI's deep-tap block and at the
   wideband shape, and every leg of the copy, overlap and retile probes
   (``copy_probe``, ``overlap_probe``, ``retile_probe``) at a small shape
   and at the shape it is timed at, each against its plain version (the
   stages within 2e-5 max|xp_ref|, 3e-5 at deep taps; the copy checksums
   exactly; overlap within 2e-5, retile within 1e-5 of max|plain|);
3. the main path, ``fxtpu_torch.cli.main`` for 2 s on the card, at the
   CLI defaults and at ``--resolution 8192 --ntaps 32`` (the deep-tap
   path), each with complex64 ingest and with ``--ingest int8`` (int8
   rings), then at the defaults with ``--blocks_per_dispatch 8`` (the
   staged path) in both ingests, each with every launch count set to 0
   just before and read just after: the run's kernel entry ran once per
   correlated block (at K = 8: K-block launches x 8 + one-block launches
   = blocks) and no other at all, the engine's ``fir_mode`` is the run's
   (``direct``, ``svd``), the calibration recovered the injected 2 us
   delay within 0.5 sample, the calibrated in-band phase is flat (std <
   0.3 rad, 0.35 under int8) and the CSV loads with the reference recipe;
   then ``bench_pipeline``'s configuration through the Correlator
   (looping replay, CONTINUUM, ``buffer_chunks`` 32) for 4 s at K = 8 and
   at K = 1 in each ingest, counted the same way, under a CUDA-only
   ``torch.profiler`` trace for the device's busy share; then the F-stage
   entry ``spectrometer_fused``, which no main path calls, over 3 chained
   flagship blocks; then the measurement path, ``fxtpu_torch.probes.main``
   for ``ablate`` (flagship and ``bench_pipeline`` blocks at K = 1 and 8 in
   both ingests, the deep-tap block and the wideband shape in both FIR
   modes), ``copy_rate``, ``overlap`` (both copy mechanisms), ``retile``,
   ``breakdown`` (2 x 2^18 and 2 x 2^21 samples) and ``all``, each run
   counted the same way: its own kernel launched, no other;
4. times (CUDA events, median of 2 x n calls after warm-up, in turns): at
   the flagship each direct-loop kernel against its plain version (also
   with 4 channels and autos, 10 pairs), the engine step on either route
   for both ingests, the host-to-device copy of one block (host clock to a synchronize) and the spectrometer
   against its plain version; at the wideband shape the SVD-FIR kernel,
   the direct-loop kernel and both plain versions for each ingest, the
   engine step on either route (the kernel route in the SVD mode) and one
   block's copy; per block, one K = 8 launch against 8 one-block launches
   and the plain version at the flagship and at the CLI's deep-tap block
   (SVD), ``multi_step`` against ``step`` at the flagship, and 8 blocks'
   copy through a pinned buffer on a side stream against 8 pageable
   copies; the device launches of one engine step (flagship, and wideband
   in the SVD mode), of one K = 8 ``multi_step`` and of each wrapper alone
   (a CUDA-only profiler trace); the stage table, the
   frame kernel's device time per block after each stage from the
   ``ablate`` runs, with ``torch.fft.fft`` over ``[nch, S, nbins]`` timed
   beside the FFT stages (``library_ms``; the port never calls it on this
   path).

Every kernel's ``bound_ms`` is computed here from the run's shapes: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its operations over 67 TFLOP/s (float32 outside the tensor
cores), the H100's published rates; ``bound_by`` says which.  ``library_ms``
is the time of one PyTorch call that computes the same function, timed
here and used nowhere in the port: ``torch.sum`` over the tiles' words
beside the copy probe's leg of contiguous tiles; no single call computes
what any other kernel here computes, so theirs is null.

It prints one JSON line of the stage table, one of kernel results (for
the K-block entries every time per block, at K = 8), then, as the last
line, ``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

FLAGSHIP = dict(nch=2, nsamp=2**18, nbins=4096, ntaps=4, autos=False)
SMALL = dict(nch=3, nsamp=32 * 256, nbins=256, ntaps=4, autos=True)
# bench.py's wideband configuration at its full width
WIDEBAND = dict(nch=2, nsamp=2**21, nbins=8192, ntaps=32, autos=False)
SMALL_DEEP = dict(nch=3, nsamp=64 * 256, nbins=256, ntaps=32, autos=True)
# the CLI's block at --resolution 8192 --ntaps 32 (the reference's clamp)
DEEP_CLI = dict(nch=2, nsamp=2**18, nbins=8192, ntaps=32, autos=False)
MULTI_K = 8          # blocks per dispatch of the CLI runs and the pipeline
# bench_pipeline's block: 512 frames in 256 groups of 2 (frames_per_group > 1)
PIPELINE_BLOCK = dict(nch=2, nsamp=2**21, nbins=4096, ntaps=4, autos=False)
# the X stage over many pairs: four channels with autos at the flagship
# width, 10 baselines of spectra that all stay in shared memory
MANY_PAIRS = dict(nch=4, nsamp=2**18, nbins=4096, ntaps=4, autos=True)
# (shape, K, FIR mode) of the K-block entries' checks in phase 2: every
# shape and K the main path and phase 4 launch them at, and smaller ones
MULTI_CASES = ((SMALL, 3, "direct"), (FLAGSHIP, MULTI_K, "direct"),
               (PIPELINE_BLOCK, MULTI_K, "direct"), (WIDEBAND, 2, "direct"),
               (SMALL_DEEP, 3, "svd"), (DEEP_CLI, MULTI_K, "svd"),
               (WIDEBAND, 2, "svd"))
# bench.py's bench_pipeline at its defaults, run for PIPELINE_S seconds
PIPELINE = dict(mode="CONTINUUM", nchan=2, num_samp=2**21, nbins=4096,
                buffer_chunks=4 * MULTI_K)
PIPELINE_S = 2.5
CLI_S = 2            # seconds of each CLI run
HBM_BYTES_PER_S = 3.35e12    # the H100's published device-memory rate
FP32_FLOPS = 67e12           # and float32 rate outside the tensor cores
PROBES_SOURCE = "fxtpu_torch/csrc/probes.cu"
SPEC_CASES = (dict(nch=3, nsamp=32 * 256 + 100, nbins=256, ntaps=4),
              dict(nch=3, nsamp=32 * 256, nbins=256, ntaps=1),
              dict(nch=2, nsamp=2**18, nbins=4096, ntaps=4))
REL_TOL = 2e-5       # xp, relative to max|xp_ref| (tests/test_planes.py)
DEEP_TOL = 3e-5      # deep-tap routes against each other (test_planes:485)
SPEC_TOL = 5e-6      # spectra, relative to max|spec_ref| (test_planes:301)
HIST_TOL = 1e-6      # history, absolute
MU_TOL = 1e-6        # int8 mu_prev, relative to max|mu_ref|
STEP = 1.0 / 32      # quant_step of 8-bit samples, the CLI default
TRUE_DELAY = 2e-6    # the delay the CLI runs inject (--true_delay)
SOURCE = "fxtpu_torch/csrc/fx_fused.cu"
# entry -> the TPU kernel (or mode of it) it replaces
REPLACES = {
    "fx_fused": "fxtpu/ops/pfb_pallas.py:468",
    "fx_fused_i8": "fxtpu/ops/pfb_pallas.py:785",
    "fx_fused_svd": "fxtpu/ops/pfb_pallas.py:810",
    "fx_fused_i8_svd": "fxtpu/ops/pfb_pallas.py:831",
    "spectrometer": "fxtpu/ops/pfb_pallas.py:133",
    "fx_fused_multi": "fxtpu/ops/pfb_pallas.py:1669",
    "fx_fused_i8_multi": "fxtpu/ops/pfb_pallas.py:1669",
    "fx_ablate": "scripts/fused_ablate.py:58",
    "copy_probe": "scripts/dma_width_probe.py:44",
    "overlap_probe": "scripts/dma_overlap_probe.py:154",
    "retile_probe": "scripts/retile_probe.py:51",
}
PROBE_KERNELS = ("fx_ablate", "copy_probe", "overlap_probe", "retile_probe")


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


def probe_wrappers() -> dict:
    """The measurement path's kernel wrappers by their entry's name."""
    from fxtpu_torch.ops.fx_fused import fx_fused_ablate
    from fxtpu_torch.probes.copy_rate import copy_probe
    from fxtpu_torch.probes.overlap import overlap_probe
    from fxtpu_torch.probes.retile import retile_probe
    return {"fx_ablate": fx_fused_ablate, "copy_probe": copy_probe,
            "overlap_probe": overlap_probe, "retile_probe": retile_probe}


def reset_counts():
    from fxtpu_torch.ops import fx_fused
    from fxtpu_torch.ops.spectrometer import spectrometer_fused
    for fn in (fx_fused.fx_fused_raw, fx_fused.fx_fused_raw_i8,
               fx_fused.fx_fused_raw_multi, fx_fused.fx_fused_raw_i8_multi):
        fn.launches = fn.svd_launches = 0
    spectrometer_fused.launches = 0
    for fn in probe_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    from fxtpu_torch.ops import fx_fused
    from fxtpu_torch.ops.spectrometer import spectrometer_fused
    counts = {}
    for name, fn in (("fx_fused", fx_fused.fx_fused_raw),
                     ("fx_fused_i8", fx_fused.fx_fused_raw_i8),
                     ("fx_fused_multi", fx_fused.fx_fused_raw_multi),
                     ("fx_fused_i8_multi", fx_fused.fx_fused_raw_i8_multi)):
        counts[name] = fn.launches
        counts[name + "_svd"] = fn.svd_launches
    counts["spectrometer"] = spectrometer_fused.launches
    for name, fn in probe_wrappers().items():
        counts[name] = fn.launches
    return counts


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


def merged_batch(case, k, rng, device, int8):
    """K blocks of numpy-seeded samples in the merged layout ``[nch, K,
    S, nbins]`` complex64 (int8: ``[nch, K, S, nbins, 2]``), with a DC
    offset that differs per channel and block (so each block's own mean
    matters)."""
    import torch
    nch, nbins = case["nch"], case["nbins"]
    s = case["nsamp"] // nbins
    grade = np.arange(1, nch + 1)[:, None] * np.arange(1, k + 1)[None, :]
    if int8:
        dc = np.array([3.0, -2.0]) * grade[..., None]
        x = np.clip(np.rint(30 * rng.normal(size=(nch, k, s, nbins, 2))
                            + dc[:, :, None, None]), -127, 127)
        return torch.as_tensor(x.astype(np.int8), device=device)
    x = (rng.normal(size=(nch, k, s, nbins))
         + 1j * rng.normal(size=(nch, k, s, nbins))
         + (0.3 - 0.2j) * grade[..., None, None])
    return torch.as_tensor(x.astype(np.complex64), device=device)


def fresh_history(case, device, int8):
    import torch
    nch, ntaps, nbins = case["nch"], case["ntaps"], case["nbins"]
    if int8:
        return {"tail": torch.zeros((nch, ntaps - 1, nbins, 2),
                                    dtype=torch.int8, device=device),
                "mu_prev": torch.zeros((nch,), dtype=torch.complex64,
                                       device=device)}
    return torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64,
                       device=device)


def multi_entries(int8):
    """(K-block wrapper, its plain version, the one-block wrapper)."""
    from fxtpu_torch.ops import fx_fused as ff
    if int8:
        return (ff.fx_fused_raw_i8_multi, ff.fx_fused_raw_i8_multi_reference,
                ff.fx_fused_raw_i8)
    return (ff.fx_fused_raw_multi, ff.fx_fused_raw_multi_reference,
            ff.fx_fused_raw)


def same_history(a, b):
    import torch
    if isinstance(a, dict):
        return all(torch.equal(a[key], b[key]) for key in a)
    return torch.equal(a, b)


def compare_multi(case, k, device, fir, int8):
    """Phase 2 for a K-block entry: two chained K-block launches against
    the plain version (xp within 2e-5 max|xp_ref|, 3e-5 in the SVD mode;
    history as for the one-block entries) and against K chained one-block
    launches, bit for bit.  Returns (max abs err, max rel err) of xp."""
    import torch

    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    multi, ref, single = multi_entries(int8)
    w, svd = window_and_fir(case, fir, device)
    pairs = pairs_tensor(baseline_pairs(case["nch"], case["autos"]),
                         case["nch"], device)
    arg = (STEP,) if int8 else ()
    tol = DEEP_TOL if fir == "svd" else REL_TOL
    rng = np.random.default_rng(2468)
    hk = hr = hs = fresh_history(case, device, int8)
    abs_err = rel_err = 0.0
    for call in range(2):
        x = merged_batch(case, k, rng, device, int8)
        xk, hk = multi(x, hk, w, pairs, *arg, svd)
        xr, hr = ref(x, hr, w, pairs, *arg, svd)
        xs = []
        for j in range(k):
            xj, hs = single(x[:, j].contiguous(), hs, w, pairs, *arg, svd)
            xs.append(xj)
        torch.cuda.synchronize()
        if not torch.isfinite(torch.view_as_real(xk)).all():
            raise AssertionError(f"non-finite K-block output at {case}")
        err = (xk - xr).abs().max().item()
        scale = xr.abs().max().item()
        if int8:
            mu_err = (hk["mu_prev"] - hr["mu_prev"]).abs().max().item()
            hist_ok = (torch.equal(hk["tail"], hr["tail"]) and mu_err
                       <= MU_TOL * hr["mu_prev"].abs().max().item())
            hdesc = f"tail exact, mu err {mu_err:.3g}" if hist_ok else "bad"
        else:
            herr = (hk - hr).abs().max().item()
            hist_ok = herr <= HIST_TOL
            hdesc = f"history err {herr:.3g}"
        bitwise = (xk.shape == (k, len(pairs), case["nbins"])
                   and torch.equal(xk, torch.stack(xs))
                   and same_history(hk, hs))
        print(f"  call {call} (K={k}): max|xp_k - xp_ref| = {err:.6g} "
              f"({err / scale:.3g} of max|xp_ref| = {scale:.6g}), {hdesc}, "
              f"= {k} one-block launches bit for bit: {bitwise}",
              flush=True)
        if err > tol * scale or not hist_ok or not bitwise:
            raise AssertionError(
                f"K-block entry disagrees at {case}, K={k} ({fir}, int8 "
                f"{int8}): xp {err / scale:.3g} > {tol}, history ok "
                f"{hist_ok}, bit for bit {bitwise}")
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


def run_cli(tmpdir, name, ingest, extra=()):
    """``fxtpu_torch.cli.main`` for CLI_S s on the card with every launch
    count set to 0 just before and read just after -> (Correlator, CSV
    path, counts)."""
    from fxtpu_torch.cli import main as cli_main
    out = os.path.join(tmpdir, f"vis_{name}.csv")
    reset_counts()
    cor = cli_main(["--time", str(CLI_S), "--mode", "spectrum",
                    "--true_delay",
                    str(TRUE_DELAY), "--ingest", ingest, "--no_keyboard",
                    "--omit_plot", "--output", out, "--device", "cuda",
                    *extra])
    counts = read_counts()
    eng = cor.engine
    print(f"  blocks processed {cor.blocks_processed}, launches {counts}, "
          f"kernel_active {eng.kernel_active}, int8_native "
          f"{eng.int8_native}, fir_mode {eng.fir_mode}, staged "
          f"{cor.stager is not None}, rings {cor.bufs[0].dtype} "
          f"{cor.bufs[0].block_shape}, nbins {cor.config.nbins}, ntaps "
          f"{cor.config.ntaps}", flush=True)
    if not eng.kernel_active or eng.int8_native != (ingest == "int8"):
        raise AssertionError("the CLI run did not take the kernel route")
    if ingest == "int8" and not (
            cor.bufs[0].dtype == np.int8
            and cor.bufs[0].block_shape == (cor.config.num_samp, 2)):
        raise AssertionError("the int8 run's rings are not int8")
    return cor, out, counts


def check_products(cor, out, name):
    """The CLI run's science: the calibration recovered the injected
    delay, the CSV loads with the reference recipe, one finite row per
    block, and the calibrated in-band phase is flat."""
    from fxtpu_torch.products import load_products
    cfg = cor.config
    int8 = cfg.ingest_dtype == "int8"
    err_samples = abs(cor.calibrated_delays[1] - TRUE_DELAY) * cfg.bandwidth
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


def run_main_path(tmpdir, ingest, deep):
    """Phase 3: the CLI on the card at one ingest dtype and depth, with
    the launch counts of the run: its kernel entry once per block, every
    other entry not at all.  Returns (entry name, its launches)."""
    name = ("fx_fused_i8" if ingest == "int8" else "fx_fused") + (
        "_svd" if deep else "")
    shape = ["--resolution", "8192", "--ntaps", "32"] if deep else []
    cor, out, counts = run_cli(tmpdir, name, ingest, shape)
    if cor.engine.fir_mode != ("svd" if deep else "direct"):
        raise AssertionError(f"fir_mode {cor.engine.fir_mode} in the {name} "
                             "run")
    others = {k: v for k, v in counts.items() if k != name}
    if not (counts[name] == cor.blocks_processed >= 3) or any(
            others.values()):
        raise AssertionError(
            f"launches {counts} do not match blocks_processed "
            f"{cor.blocks_processed} of {name} (or fewer than 3 blocks)")
    check_products(cor, out, name)
    return name, counts[name]


def run_staged_main_path(tmpdir, ingest):
    """Phase 3, the staged path: the CLI at ``--blocks_per_dispatch 8``:
    the K-block entry once per staged batch, the one-block entry once per
    tail block, every other entry not at all, and K-block launches x 8 +
    one-block launches = blocks.  Returns (K-block entry, its launches)."""
    single = "fx_fused_i8" if ingest == "int8" else "fx_fused"
    name = single + "_multi"
    cor, out, counts = run_cli(tmpdir, name, ingest, [
        "--blocks_per_dispatch", str(MULTI_K)])
    if cor.stager is None or cor.engine.fir_mode != "direct":
        raise AssertionError("the staged run did not start its stager")
    others = {k: v for k, v in counts.items() if k not in (name, single)}
    if not (counts[name] >= 1 and counts[name] * MULTI_K + counts[single]
            == cor.blocks_processed) or any(others.values()):
        raise AssertionError(
            f"launches {counts} do not account for blocks_processed "
            f"{cor.blocks_processed} at K = {MULTI_K} (or no K-block launch)")
    check_products(cor, out, name)
    return name, counts[name]


def device_busy(prof, path):
    """(busy ms, kernel ms, copy ms, first-to-last span ms) of the device
    in a ``torch.profiler`` trace: the union of its kernels', copies' and
    memsets' spans, and the sums of each."""
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, kern, copy = [], 0.0, 0.0
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((e["ts"], e["ts"] + e["dur"]))
            if e["cat"] == "kernel":
                kern += e["dur"]
            elif e["cat"] == "gpu_memcpy":
                copy += e["dur"]
    if not spans:
        raise AssertionError("the profiler saw no device work")
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    first = lo
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    last = max(b for _, b in spans)
    return busy / 1e3, kern / 1e3, copy / 1e3, (last - first) / 1e3


def run_pipeline(tmpdir, rec, ingest, k):
    """Phase 3: ``bench_pipeline``'s configuration through the Correlator
    at K blocks per dispatch for PIPELINE_S seconds (looping replay),
    counted like the CLI runs, under a CUDA-only profiler trace.  Returns
    a dict of its rates and device times."""
    import torch

    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.correlator import Correlator
    from fxtpu_torch.products import load_products
    single = "fx_fused_i8" if ingest == "int8" else "fx_fused"
    out = os.path.join(tmpdir, f"pipe_{ingest}_{k}.csv")
    cfg = CorrelatorConfig(
        **PIPELINE, run_time=PIPELINE_S, clamp_num_samp=False,
        loglevel="WARNING", source="replay", replay_file=rec,
        blocks_per_dispatch=k, ingest_dtype=ingest, device="cuda",
        output_file=out)
    cor = Correlator(config=cfg)
    getattr(cor.source, "inner", cor.source).loop = True
    reset_counts()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cor.run_state_machine()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    n = cor.blocks_processed
    multi = counts[single + "_multi"]
    others = {c: v for c, v in counts.items()
              if c not in (single, single + "_multi")}
    if (n < 2 * k or multi * k + counts[single] != n or any(others.values())
            or (k > 1) != (multi > 0) or (cor.stager is None) != (k == 1)):
        raise AssertionError(f"pipeline {ingest} K={k}: launches {counts} "
                             f"against {n} blocks")
    md, data = load_products(out)
    if (data.shape[0] != n or not np.isfinite(data).all()
            or md["mode"] != "CONTINUUM"):
        raise AssertionError(f"pipeline CSV {data.shape} for {n} blocks")
    busy, kern, copy, span = device_busy(
        prof, os.path.join(tmpdir, f"trace_{ingest}_{k}.json"))
    r = cor.metrics.rates(since="steady", until="end")
    res = {"k": k, "blocks": n, "blocks_per_s": r["blocks_per_s"],
           "msamp_per_s": r["samples_per_s"] / 1e6,
           "steady_s": r["elapsed_s"], "wall_s": wall,
           "device_busy_ms": busy, "busy_share": busy / (wall * 1e3),
           "kernel_ms_per_block": kern / n, "copy_ms_per_block": copy / n,
           "device_span_ms": span, "launches": counts}
    print(f"  pipeline {ingest} K={k}: {n} blocks, "
          f"{res['blocks_per_s']:.4f} blocks/s, "
          f"{res['msamp_per_s']:.4f} Msamp/s steady over "
          f"{r['elapsed_s']:.3f} s; device busy {busy:.3f} ms of "
          f"{wall:.3f} s ({100 * res['busy_share']:.4f}%), kernels "
          f"{res['kernel_ms_per_block']:.4f} ms/block, copies "
          f"{res['copy_ms_per_block']:.4f} ms/block; "
          f"{cor.metrics.report()}", flush=True)
    return res


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


def compare_ablate(case, k, device):
    """Phase 2 for the stage ablation at one shape: every stage in both
    ingests and, at deep taps, both FIR modes, against its plain version.
    Returns (max abs err, max rel err) over all of them."""
    import torch

    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.probes import ablate
    deep = case["ntaps"] >= 16
    tol = DEEP_TOL if deep else REL_TOL
    abs_err = rel_err = 0.0
    for ingest in ("complex64", "int8"):
        for fir in (("direct", "svd") if deep else ("direct",)):
            x, h, w, pairs, step, svd = ablate.make_inputs(
                device, nch=case["nch"], k=k, num_samp=case["nsamp"],
                nbins=case["nbins"], ntaps=case["ntaps"], ingest=ingest,
                fir_mode=fir, seed=3)
            errs = {}
            for stage in ff.STAGES:
                got = ff.fx_fused_ablate(x, h, w, pairs, stage, step, svd)
                want = ff.fx_fused_ablate_reference(x, h, w, pairs, stage,
                                                    step, svd)
                torch.cuda.synchronize()
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                errs[stage] = err / scale
                if got.shape != want.shape or not err <= tol * scale:
                    raise AssertionError(
                        f"ablation stage {stage} ({ingest}, {fir}) disagrees "
                        f"with its plain version at {case}: {err / scale:.3g} "
                        f"> {tol}")
                abs_err = max(abs_err, err)
                rel_err = max(rel_err, err / scale)
            print(f"  {ingest} {fir} K={k}: "
                  + ", ".join(f"{st} {e:.2g}" for st, e in errs.items()),
                  flush=True)
            del x
    return abs_err, rel_err


def compare_probes(device):
    """Phase 2 for the three probe kernels: every leg at a small shape and
    at the shape the probes time it at, against its plain version.
    Returns {entry: (max abs err, max rel err)}."""
    import torch

    from fxtpu_torch.probes import copy_rate, overlap, retile
    from fxtpu_torch.probes.common import sm_count
    errs = {}
    # copy probe: checksums are exact
    legs = 0
    for nbytes in (2**22, copy_rate.COLD_BYTES):
        src = copy_rate._source(nbytes, device, seed=5)
        plans = [copy_rate.width_plan(wd, nbytes)
                 for wd in copy_rate.WIDTHS]
        plans += [plan for _, _, _, plan in copy_rate.shape_plans(
            nbytes, FLAGSHIP["nbins"])]
        for plan in plans:
            want = copy_rate.copy_probe_reference(src, plan, 2)
            for mech in copy_rate.MECHS:
                got = copy_rate.copy_probe(src, plan, mech, reps=2)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"copy probe ({mech}) checksums differ from the "
                        f"plain version at {plan}")
                legs += 1
        del src
    print(f"  copy_probe: {legs} legs, every tile checksum exact",
          flush=True)
    errs["copy_probe"] = (0.0, 0.0)
    # overlap probe: the probe's own shapes and a small one
    sms = sm_count(device)
    worst = 0.0
    for n, cb, frames in ((1024, 256, 3), (4096, 512, 32)):
        gen = torch.Generator(device=device).manual_seed(6)
        src = torch.view_as_complex(torch.randn(
            (2 * sms * frames + 3, n, 2), device=device, generator=gen))
        for structure, (nbuf, per_sm) in overlap.STRUCTURES.items():
            nbuf = min(nbuf, n // cb)
            for mech in overlap.MECHS:
                for copy, body in ((True, "touch"), (False, "fma"),
                                   (False, "fx"), (True, "fma"),
                                   (True, "fx")):
                    worst = max(worst, overlap.check_leg(
                        src, tol=REL_TOL, cb=cb, ntaps=4,
                        frames=frames * 2 // per_sm, reps=1, nbuf=nbuf,
                        copy=copy, body=body, grid=per_sm * sms, mech=mech))
        del src
    print(f"  overlap_probe: every leg within {worst:.3g} of max|plain|",
          flush=True)
    errs["overlap_probe"] = (worst, worst)
    x, xt, m = retile.make_inputs(device)
    worst = max(retile.check_form(x, xt, m, form, nt, reps)
                for form in retile.FORMS
                for nt, reps in ((2, 1), (retile.NT, 32)))
    print(f"  retile_probe: every leg within {worst:.3g} of max|plain|",
          flush=True)
    errs["retile_probe"] = (worst, worst)
    return errs


def run_probe(argv, expect):
    """Phase 3, the measurement path: ``fxtpu_torch.probes.main(argv)``
    with every launch count set to 0 just before and read just after.
    ``expect`` names the entries that must have launched; every other
    entry must not have.  Returns (records, counts)."""
    import contextlib
    import io

    from fxtpu_torch import probes
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        records = probes.main([*argv, "--device", "cuda"])
    counts = read_counts()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    if len(lines) != len(records) or [json.loads(ln) for ln in lines] != (
            json.loads(json.dumps(records))):
        raise AssertionError(f"probes {argv}: the printed lines are not the "
                             "records")
    launched = {k: v for k, v in counts.items() if v}
    print(f"  probes {' '.join(argv)}: {len(records)} lines, launches "
          f"{launched}", flush=True)
    if set(launched) != set(expect):
        raise AssertionError(f"probes {argv}: launches {launched}, expected "
                             f"exactly {sorted(expect)}")
    for rec in records:
        bad = [k for k, v in rec.items() if isinstance(v, float)
               and not np.isfinite(v)]
        if bad or rec.get("finite") is False or rec.get(
                "checksum_ok") is False:
            raise AssertionError(f"probes {argv}: bad record {rec}")
    return records, counts


def fx_bound(case, k, int8, rank, spectra=False):
    """The least time the card could take for one FX call (or, with
    ``spectra``, one spectrometer call) over k blocks of ``case``: the
    larger of its bytes (samples, history, window or factors and pairs in
    once, the cross power or the spectra and the history out once) over
    the device-memory rate and its operations (per sample and tap 4 for the
    FIR, the direct form's count in either FIR mode: the rank-r factors are
    one way to compute the same output, not work the function needs; 5 n
    log2 n per FFT; 8 per pair, frame and bin for the X stage; 2 per sample
    for the mean) over the float32 rate.  Returns (ms, "bytes" or
    "operations")."""
    nch, nbins, ntaps = case["nch"], case["nbins"], case["ntaps"]
    s = case["nsamp"] // nbins
    nbl = (nch * (nch - 1) // 2 + (nch if case.get("autos") else 0))
    samples = k * nch * s * nbins
    halo = nch * (ntaps - 1) * nbins
    table = (ntaps + nbins) * rank * 4 if rank else ntaps * nbins * 4
    if int8:
        nbytes = 2 * samples + 2 * halo + 8 * nch + k * nch * 8
    else:
        nbytes = 8 * samples + 2 * 8 * halo
    nbytes += table + (0 if spectra else 8 * nbl + 8 * k * nbl * nbins)
    flops = samples * (2 + 4 * ntaps + 5 * np.log2(nbins))
    if spectra:
        nbytes += 8 * samples
    else:
        flops += 8 * k * nbl * s * nbins
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def svd_form_ms(case, k, rank):
    """A note beside an SVD entry's bound: the time of the operations the
    rank-r form of the FIR itself spends (4 per sample, tap and rank, and 4
    per sample and rank to recombine) at the float32 rate."""
    samples = k * case["nch"] * case["nsamp"]
    return (samples * (4 * case["ntaps"] * rank + 4 * rank)
            / FP32_FLOPS * 1e3)


def count_device_launches(fn):
    """Kernels, copies and memsets the device runs for one call of ``fn``:
    the device events of 3 traced calls (``probes.common.device_events``,
    which holds every launching call of the host to its device record and
    the calls to the same number of launches each), over 3."""
    import torch

    from fxtpu_torch.probes.common import device_events
    fn()
    torch.cuda.synchronize()
    return len(device_events(fn, 3)) // 3


def stage_table(ablate_runs, device):
    """Phase 4: one row per ``ablate`` run of phase 3 with the frame
    kernel's device time per block after each stage (us, the profiler's),
    the pre-pass and the reduce, the event time per block of the whole
    call, and ``torch.fft.fft`` over one block's ``[nch, S, nbins]``
    complex64 timed beside them (``library_ms``, per block)."""
    import torch
    rows, fft_ms = [], {}
    for tag, records in ablate_runs:
        stages = [r for r in records if "stage" in r]
        diff = [r for r in records if "stage" not in r][0]
        first = stages[0]
        shape = (first["nch"], first["num_samp"] // first["nbins"],
                 first["nbins"])
        if shape not in fft_ms:
            z = torch.view_as_complex(torch.randn((*shape, 2), device=device))
            fft_ms[shape] = cuda_times(
                {"fft": lambda z=z: torch.fft.fft(z)}, n=20)["fft"]
            del z
        full = {r["stage"]: r for r in stages}["full"]
        rows.append({
            "shape": tag, "k": first["k"], "ingest": first["ingest"],
            "fir_mode": first["fir_mode"],
            "frames_us": {r["stage"]: r["device_us"]["frames"]
                          for r in stages},
            "event_ms": {r["stage"]: r["ms_per_block"] for r in stages},
            "prepass_us": full["device_us"]["prepass"],
            "reduce_us": full["device_us"]["reduce"],
            "frames_differences_us":
                diff["frame_kernel_differences_us_per_block"],
            "library_ms": fft_ms[shape]})
    return rows


def probe_kernel_entries(table, probe_records, launches, errs, mkt, device):
    """The ``kernels`` line's entries of the measurement path's four
    kernels: each one's time at the shape its probe times it at, its plain
    version's time on the same input, and its bound from that input."""
    import torch

    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.probes import ablate, copy_rate, overlap, retile
    out = []

    def entry(name, source, **fields):
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": REPLACES[name], "launches": launches[name],
                    "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
                    "library_ms": None, **fields})

    # fx_ablate: stage "fft" (all but the X stage) per block, flagship, K = 8
    x, h, w, pairs, step, svd = ablate.make_inputs(
        device, nch=2, k=MULTI_K, num_samp=FLAGSHIP["nsamp"],
        nbins=FLAGSHIP["nbins"], ntaps=FLAGSHIP["ntaps"],
        ingest="complex64", fir_mode="direct", seed=1)
    t = cuda_times({
        "kernel": lambda: ff.fx_fused_ablate(x, h, w, pairs, "fft"),
        "plain": lambda: ff.fx_fused_ablate_reference(x, h, w, pairs, "fft"),
    }, n=10, warm=2)
    # per block of the K = 8 launch: the samples in, the one touch of the
    # partial out, and an eighth of the history and the window, which the
    # launch reads once
    nb, s = FLAGSHIP["nbins"], FLAGSHIP["nsamp"] // FLAGSHIP["nbins"]
    samples = 2 * s * nb
    nbytes = (8 * samples + 8 * ff.FFT_STAGE_BINS
              + (8 * 2 * 3 * nb + 4 * 4 * nb) / MULTI_K)
    flops = samples * (2 + 4 * 4 + 5 * np.log2(nb))
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    row = next(r for r in table if (r["shape"], r["k"], r["ingest"]) == (
        "flagship", MULTI_K, "complex64"))
    entry("fx_ablate", SOURCE, ms=t["kernel"] / MULTI_K,
          plain_ms=t["plain"] / MULTI_K, bound_ms=max(tb, tf),
          bound_by="bytes" if tb >= tf else "operations", stage="fft",
          k=MULTI_K, frames_us=row["frames_us"],
          full_plain_ms=mkt["flagship"]["plain"])
    del x

    # copy_probe: the cold walk by bulk copies of 32 KB runs, one repeat
    rec = next(r for r in probe_records["copy_rate"] if (
        r["sweep"], r["walk"], r["mech"], r["width"]) == (
        "width", "cold", "bulk", 32768))
    src = copy_rate._source(rec["bytes_per_rep"], device, seed=0)
    plan = copy_rate.width_plan(32768, rec["bytes_per_rep"])
    # at this width a tile is 64 contiguous KB, so one torch.sum over the
    # words as [ntiles, 16384] forms the same checksums (modulo 2^32)
    words = src.view(torch.int32).view(plan.ntiles, -1)
    if not torch.equal(words.sum(dim=1) & 0xffffffff,
                       copy_rate.copy_probe_reference(src, plan, 1)):
        raise AssertionError("torch.sum over the tiles' words is not the "
                             "copy probe's checksum")
    t = cuda_times({
        "plain": lambda: copy_rate.copy_probe_reference(src, plan, 1),
        "library": lambda: words.sum(dim=1)}, n=5, warm=1)
    plain = t["plain"]
    entry("copy_probe", PROBES_SOURCE, ms=rec["ms_per_rep"], plain_ms=plain,
          library_ms=t["library"], library="torch.sum over [ntiles, words]",
          bound_ms=(rec["bytes_per_rep"] + 4 * plan.ntiles)
          / HBM_BYTES_PER_S * 1e3, bound_by="bytes", gbps=rec["gbps"],
          leg="width sweep, cold, bulk, 32 KB runs")
    del src, words

    # overlap_probe: the pipelined fx leg, one repeat
    rec = next(r for r in probe_records["overlap_bulk"] if (
        r.get("leg"), r.get("body")) == ("pipelined", "fx"))
    n, ntaps, grid, frames = (rec["n"], rec["ntaps"], rec["grid"],
                              rec["frames_per_cta"])
    gen = torch.Generator(device=device).manual_seed(0)
    src = torch.view_as_complex(torch.randn(
        (grid * frames + ntaps - 1, n, 2), device=device, generator=gen))
    plain = cuda_times({"plain": lambda: overlap.overlap_probe_reference(
        src, cb=rec["cb"], ntaps=ntaps, frames=frames, reps=1, nbuf=2,
        copy=True, body="fx", grid=grid)}, n=5, warm=1)["plain"]
    # one repeat (the slope): every row in once; the checksums are written
    # once a launch, not once a repeat
    nbytes = src.numel() * 8
    flops = grid * frames * n * (4 * ntaps + 5 * np.log2(n))
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    entry("overlap_probe", PROBES_SOURCE, ms=rec["ms_per_rep"],
          plain_ms=plain, bound_ms=max(tb, tf),
          bound_by="bytes" if tb >= tf else "operations",
          leg="pipelined, fx body, bulk copies")
    del src

    # retile_probe: the gather leg, one repeat of 32 tiles of 16 frames
    rec = next(r for r in probe_records["retile"] if r["form"] == "gather")
    x, xt, m = retile.make_inputs(device)
    plain = cuda_times({"plain": lambda: retile.retile_reference(
        x, m, rec["nt"], 1)}, n=10, warm=2)["plain"]
    slots = rec["nt"] * rec["tile"]
    nbytes = x.numel() * 4 + m.numel() * 4      # one repeat, as above
    flops = slots * 2 * retile.N1 * retile.NBINS
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    entry("retile_probe", PROBES_SOURCE,
          ms=rec["ps_per_sample"] * rec["samples_per_rep"] * 1e-9,
          plain_ms=plain, bound_ms=max(tb, tf),
          bound_by="bytes" if tb >= tf else "operations", leg="gather")
    return out


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
    for both ingests, one block's copy to the card, and the device
    launches of one call of each wrapper."""
    import torch

    from fxtpu_torch.ops.fx_fused import (fx_fused_raw, fx_fused_raw_i8,
                                          fx_fused_raw_i8_reference,
                                          fx_fused_raw_reference)
    from fxtpu_torch.ops.spectrometer import (spectrometer_fused,
                                              spectrometer_fused_reference)
    from fxtpu_torch.ops.xengine import pack_delays
    from fxtpu_torch.probes.ablate import device_times
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
    wm, _, pm, mblocks, mhist = make_case(MANY_PAIRS,
                                          np.random.default_rng(21), device)
    xm = mblocks[0]
    _, _, _, mblocks8, mhist8 = make_case_i8(
        MANY_PAIRS, np.random.default_rng(22), device)
    xm8 = mblocks8[0]
    kt = cuda_times({
        "plain": lambda: fx_fused_raw_reference(x, hist, w, pairs),
        "kernel": lambda: fx_fused_raw(x, hist, w, pairs),
        "plain_i8": lambda: fx_fused_raw_i8_reference(x8, hist8, w, pairs,
                                                      STEP),
        "kernel_i8": lambda: fx_fused_raw_i8(x8, hist8, w, pairs, STEP),
        "plain_spec": lambda: spectrometer_fused_reference(xs, ws, nb, shist),
        "kernel_spec": lambda: spectrometer_fused(xs, ws, nb, shist),
        "plain_many": lambda: fx_fused_raw_reference(xm, mhist, wm, pm),
        "kernel_many": lambda: fx_fused_raw(xm, mhist, wm, pm),
        "plain_many_i8": lambda: fx_fused_raw_i8_reference(xm8, mhist8, wm,
                                                           pm, STEP),
        "kernel_many_i8": lambda: fx_fused_raw_i8(xm8, mhist8, wm, pm, STEP),
    })
    # the many-pairs kernels' device time: pre-pass + frame kernel + reduce
    for key, fn in (("device_us_many",
                     lambda: fx_fused_raw(xm, mhist, wm, pm)),
                    ("device_us_many_i8",
                     lambda: fx_fused_raw_i8(xm8, mhist8, wm, pm, STEP))):
        kt[key] = sum(device_times(fn).values())
    rng = np.random.default_rng(8)
    iq_np = (rng.normal(size=(2, 2**18, 2)) @ np.array([1.0, 1j])
             ).astype(np.complex64)
    d = torch.as_tensor(pack_delays([0.0, 2e-6], 1.4204e9), device=device)
    steps, copies = engine_steps({}, iq_np, d, REL_TOL, "direct", "flagship")
    counts = {
        "fx_fused_raw": count_device_launches(
            lambda: fx_fused_raw(x, hist, w, pairs)),
        "fx_fused_raw_i8": count_device_launches(
            lambda: fx_fused_raw_i8(x8, hist8, w, pairs, STEP)),
        "spectrometer_fused": count_device_launches(
            lambda: spectrometer_fused(xs, ws, nb, shist)),
    }
    return kt, cuda_times(steps), host_times(copies), counts


def time_wideband(device):
    """Phase 4 at the wideband shape: per ingest the SVD-FIR kernel, the
    direct-loop kernel and both plain versions; the engine step on either
    route (the kernel route in the SVD mode), one block's copy, and the
    device launches of one step on the kernel route."""
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
    counts = {"wideband_step": count_device_launches(steps["kernel"]),
              "wideband_step_i8": count_device_launches(steps["kernel_i8"])}
    return kt, cuda_times(steps, n=20), host_times(copies, n=10), counts


def time_multi_kernels(device):
    """Phase 4, per block: one K = 8 launch of each K-block entry against
    8 chained one-block launches and the plain version, at the flagship
    (direct loop) and at the CLI's deep-tap block (SVD)."""
    from fxtpu_torch.ops import baseline_pairs, pairs_tensor
    out = {}
    for tag, case, fir in (("flagship", FLAGSHIP, "direct"),
                           ("deep", DEEP_CLI, "svd")):
        for int8 in (False, True):
            multi, ref, single = multi_entries(int8)
            w, svd = window_and_fir(case, fir, device)
            pairs = pairs_tensor(baseline_pairs(case["nch"]), case["nch"],
                                 device)
            arg = (STEP,) if int8 else ()
            x = merged_batch(case, MULTI_K, np.random.default_rng(17),
                             device, int8)
            xs = [x[:, j].contiguous() for j in range(MULTI_K)]
            h = fresh_history(case, device, int8)

            def singles(xs=xs, h=h, w=w, pairs=pairs, arg=arg, svd=svd,
                        single=single):
                for xj in xs:
                    _, h = single(xj, h, w, pairs, *arg, svd)

            t = cuda_times({
                "multi": lambda: multi(x, h, w, pairs, *arg, svd),
                "singles": singles,
                "plain": lambda: ref(x, h, w, pairs, *arg, svd),
            }, n=20 if tag == "flagship" else 6, warm=2)
            key = tag + ("_i8" if int8 else "")
            out[key] = {k: v / MULTI_K for k, v in t.items()}
            del x, xs
    return out


def time_multi_step(device):
    """Phase 4 at the flagship, per block: the engine's ``multi_step``
    over K = 8 blocks against ``step`` (checking that block 0 of the one
    is the other bit for bit), and 8 blocks' copy through a pinned buffer
    on a side stream (``prepare_batch``, the stager's copy) against 8
    pageable ``prepare_block`` copies, by the host clock; and the device
    launches (kernels, copies, memsets) of one call of each step."""
    import torch

    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.ops.xengine import pack_delays
    from fxtpu_torch.runtime.native import quantize_c64
    rng = np.random.default_rng(19)
    c64 = [(rng.normal(size=(2, FLAGSHIP["nsamp"], 2)) @ np.array([1.0, 1j])
            ).astype(np.complex64) for _ in range(MULTI_K)]
    steps, copies = {}, {}
    side = torch.cuda.Stream(device)
    for ingest in ("complex64", "int8"):
        sfx = "_i8" if ingest == "int8" else ""
        eng = FxEngine(CorrelatorConfig(device="cuda", ingest_dtype=ingest,
                                        quant_step=STEP), fused=True)
        blocks = c64 if ingest == "complex64" else [
            quantize_c64(b, STEP) for b in c64]
        freq = eng.cfg.frequency
        d1 = torch.as_tensor(pack_delays([0.0, TRUE_DELAY], freq),
                             device=device)
        dk = torch.as_tensor(pack_delays(
            np.tile([0.0, TRUE_DELAY], (MULTI_K, 1)), freq), device=device)
        h = eng.fresh_history()
        iq_k, iq_1 = eng.prepare_batch(blocks), eng.prepare_block(blocks[0])
        vk, _ = eng.multi_step(iq_k, dk, h)
        v1, _ = eng.step(iq_1, d1, h)
        if not torch.equal(vk[0], v1):
            raise AssertionError(f"multi_step block 0 is not step ({ingest})")
        steps["multi_step" + sfx] = (
            lambda e=eng, i=iq_k, hh=h, d=dk: e.multi_step(i, d, hh))
        steps["step" + sfx] = (
            lambda e=eng, i=iq_1, hh=h, d=d1: e.step(i, d, hh))
        host = eng.batch_host_buffer(MULTI_K)

        def pinned(e=eng, b=blocks, host=host):
            with torch.cuda.stream(side):
                e.prepare_batch(b, host)
            side.synchronize()

        copies["pinned" + sfx] = pinned
        copies["pageable" + sfx] = (
            lambda e=eng, b=blocks: [e.prepare_block(x) for x in b])
    st = cuda_times(steps, n=30)
    ct = host_times(copies, n=10)
    st = {k: v / MULTI_K if k.startswith("multi") else v
          for k, v in st.items()}
    counts = {k: count_device_launches(fn) for k, fn in steps.items()}
    return st, {k: v / MULTI_K for k, v in ct.items()}, counts


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
    print(f"  {library_path().name} ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {cuda_build.build_seconds:.1f} s, one process per source)",
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
             (SMALL, FLAGSHIP, MANY_PAIRS, WIDEBAND)),
            ("fx_fused_i8", compare_kernel_i8, "direct",
             (SMALL, FLAGSHIP, MANY_PAIRS, WIDEBAND)),
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
    for name, int8 in (("fx_fused_multi", False),
                       ("fx_fused_i8_multi", True)):
        for case, k, fir in MULTI_CASES:
            print(f"  {name} ({fir}) K={k} shape {case}", flush=True)
            errs[name] = tuple(map(max, errs[name],
                                   compare_multi(case, k, device, fir, int8)))
    for case, k in ((SMALL, 3), (FLAGSHIP, 2), (SMALL_DEEP, 3),
                    (DEEP_CLI, 2), (WIDEBAND, 1)):
        print(f"  fx_ablate K={k} shape {case}", flush=True)
        errs["fx_ablate"] = tuple(map(max, errs["fx_ablate"],
                                      compare_ablate(case, k, device)))
    errs.update(compare_probes(device))

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
        for ingest in ("complex64", "int8"):
            print(f"  --ingest {ingest} --blocks_per_dispatch {MULTI_K}",
                  flush=True)
            name, n = run_staged_main_path(tmp, ingest)
            launches[name] = n
        from fxtpu_torch.sources import NoiseSource, save_recording
        rec = save_recording(NoiseSource(nchan=PIPELINE["nchan"], seed=1),
                             os.path.join(tmp, "rec.npy"),
                             PIPELINE["num_samp"], 4)
        pipe = {}
        for ingest in ("complex64", "int8"):
            for k in (MULTI_K, 1):
                pipe[f"{ingest}_k{k}"] = run_pipeline(tmp, rec, ingest, k)
    launches["spectrometer"] = run_spectrometer_path(device)
    print("phase 3: the measurement path (python -m fxtpu_torch.probes)",
          flush=True)
    launches.update({name: 0 for name in PROBE_KERNELS})
    ablate_runs, probe_records = [], {}

    def probe(tag, argv, expect):
        records, counts = run_probe(argv, expect)
        for name in PROBE_KERNELS:
            launches[name] += counts[name]
        probe_records[tag] = records
        return records

    for tag, case, ks, firs, iters in (
            ("flagship", FLAGSHIP, (1, MULTI_K), ("auto",), 20),
            ("pipeline", PIPELINE_BLOCK, (1, MULTI_K), ("auto",), 10),
            ("deep", DEEP_CLI, (1, MULTI_K), ("direct", "svd"), 6),
            ("wideband", WIDEBAND, (1, MULTI_K), ("direct", "svd"), 3)):
        for k in ks:
            for ingest in ("complex64", "int8"):
                for fir in firs:
                    argv = ["ablate", "--num_samp", str(case["nsamp"]),
                            "--nbins", str(case["nbins"]), "--ntaps",
                            str(case["ntaps"]), "--k", str(k), "--ingest",
                            ingest, "--fir_mode", fir, "--iters", str(iters)]
                    ablate_runs.append((tag, probe(
                        f"ablate_{tag}_{k}_{ingest}_{fir}", argv,
                        ["fx_ablate"])))
    probe("copy_rate", ["copy_rate"], ["copy_probe"])
    for mech in ("bulk", "cp_async"):
        probe(f"overlap_{mech}", ["overlap", "--mech", mech],
              ["overlap_probe"])
    probe("retile", ["retile"], ["retile_probe"])
    for nsamp in (FLAGSHIP["nsamp"], PIPELINE_BLOCK["nsamp"]):
        recs = probe(f"breakdown_{nsamp}", [
            "breakdown", "--num_samp", str(nsamp), "--k", str(MULTI_K)],
            ["fx_fused", "fx_fused_multi"])
        for rec in recs:
            print(f"    breakdown {nsamp} {rec['route']}: against the float64 "
                  f"oracle {rec['max_rel_err']:.3g} of max|vis| (DC bins "
                  f"{rec['max_rel_err_dc']:.3g}), multi_step "
                  f"{rec['ms_per_block']:.4f} ms/block, "
                  f"{rec['gs_per_s']:.4f} GS/s", flush=True)
            if not rec["max_rel_err"] <= 3.1e-5 or not rec[
                    "multi_step_block0_is_step"]:
                raise AssertionError(f"breakdown: {rec}")
    probe("all", ["all"], [*PROBE_KERNELS, "fx_fused", "fx_fused_multi"])

    print("phase 4: times at the flagship and wideband shapes "
          f"({threading.active_count()} threads alive)", flush=True)
    kt, st, h2d, call_launches = time_flagship(device)
    wkt, wst, wh2d, wide_launches = time_wideband(device)
    mkt = time_multi_kernels(device)
    mst, mct, step_launches = time_multi_step(device)
    step_launches.update(call_launches)
    step_launches.update(wide_launches)
    table = stage_table(ablate_runs, device)
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
        print(f"  [{card}] many pairs {name} ({MANY_PAIRS['nch']} channels "
              f"with autos, flagship width): kernel "
              f"{kt['kernel_many' + sfx]:.4f} ms "
              f"({kt['device_us_many' + sfx]:.2f} us of device time), plain "
              f"torch {kt['plain_many' + sfx]:.4f} ms", flush=True)
    print(f"  [{card}] flagship spectrometer kernel "
          f"{kt['kernel_spec']:.4f} ms, plain torch {kt['plain_spec']:.4f} ms",
          flush=True)
    for ingest in h2d:
        print(f"  [{card}] one block to the card ({ingest}): flagship "
              f"{h2d[ingest]:.4f} ms, wideband {wh2d[ingest]:.4f} ms",
              flush=True)
    for tag in mkt:
        t = mkt[tag]
        print(f"  [{card}] {tag} per block: one K={MULTI_K} launch "
              f"{t['multi']:.4f} ms, {MULTI_K} one-block launches "
              f"{t['singles']:.4f} ms, plain {t['plain']:.4f} ms", flush=True)
    for sfx, ingest in (("", "complex64"), ("_i8", "int8")):
        print(f"  [{card}] flagship {ingest} per block: multi_step "
              f"{mst['multi_step' + sfx]:.4f} ms against step "
              f"{mst['step' + sfx]:.4f} ms; copy of {MULTI_K} blocks, pinned "
              f"on a side stream {mct['pinned' + sfx]:.4f} ms against "
              f"pageable {mct['pageable' + sfx]:.4f} ms", flush=True)
    for key, r in pipe.items():
        print(f"  [{card}] pipeline {key}: {r['blocks_per_s']:.4f} blocks/s, "
              f"{r['msamp_per_s']:.4f} Msamp/s, device busy "
              f"{100 * r['busy_share']:.4f}%", flush=True)
    print(f"  [{card}] device launches per call: {step_launches} (a step "
          "at the flagship: mean pre-pass, frame kernel, reduce and the "
          f"finish; multi_step: the same for {MULTI_K} blocks; the wrappers "
          "alone; a wideband step in the SVD mode)", flush=True)
    print(f"  [{card}] stage table: the frame kernel's device time per "
          "block after each stage, us (pre-pass, reduce; torch.fft.fft "
          "over one block beside them)", flush=True)
    for row in table:
        fr = row["frames_us"]
        print(f"    {row['shape']} K={row['k']} {row['ingest']} "
              f"{row['fir_mode']}: "
              + ", ".join(f"{st} {fr[st]:.2f}" for st in fr)
              + f" (pre-pass {row['prepass_us']:.2f}, reduce "
              f"{row['reduce_us']:.2f}; torch.fft.fft "
              f"{1e3 * row['library_ms']:.2f})", flush=True)
    for rec in probe_records["copy_rate"]:
        if rec["sweep"] == "width" or rec["mode"] in ("chan", "prod"):
            print(f"    copy {rec['sweep']} {rec['walk']} "
                  f"{rec.get('mode', '')} {rec.get('ingest', '')} "
                  f"{rec['mech']} {rec['width']} B: {rec['gbps']:.1f} GB/s",
                  flush=True)
    for mech in ("bulk", "cp_async"):
        for rec in probe_records[f"overlap_{mech}"]:
            if "summary" in rec:
                print(f"    overlap {mech} {rec['structure']} "
                      f"{rec['summary']}: copy {rec['copy_ms']:.4f} + comp "
                      f"{rec['comp_ms']:.4f} = {rec['sum_ms']:.4f}, max "
                      f"{rec['max_ms']:.4f}, measured "
                      f"{rec['measured_ms']:.4f} ms", flush=True)
    for rec in probe_records["retile"]:
        print(f"    retile {rec['form']}: {rec['ps_per_sample']:.4f} ps per "
              f"sample ({rec['us_per_tile']:.4f} us per tile)", flush=True)

    def bound(case, k, int8, rank=0, spectra=False):
        ms, by = fx_bound(case, k, int8, rank, spectra)
        return {"bound_ms": ms, "bound_by": by, "library_ms": None}

    # the rank of the 32-tap window's factors at each deep shape
    ranks = {tag: next(r["rank"] for r in recs if "stage" in r)
             for tag, recs in probe_records.items()
             if tag.endswith("_svd")}
    wide_rank = ranks["ablate_wideband_1_complex64_svd"]
    deep_rank = ranks[f"ablate_deep_{MULTI_K}_complex64_svd"]
    kernels = []
    for name, sfx, ingest in (("fx_fused", "", "complex64"),
                              ("fx_fused_i8", "_i8", "int8")):
        many_bound = fx_bound(MANY_PAIRS, 1, ingest == "int8", 0)
        kernels.append({
            **bound(FLAGSHIP, 1, ingest == "int8"),
            "wideband_bound_ms": fx_bound(WIDEBAND, 1, ingest == "int8",
                                          0)[0],
            "step_device_launches": step_launches["step" + sfx],
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": kt["kernel" + sfx], "plain_ms": kt["plain" + sfx],
            "step_ms": st["kernel" + sfx],
            "plain_step_ms": st["plain" + sfx], "h2d_ms": h2d[ingest],
            "wideband_ms": wkt["direct" + sfx],
            "wideband_plain_ms": wkt["plain_direct" + sfx],
            "many_pairs_ms": kt["kernel_many" + sfx],
            "many_pairs_device_us": kt["device_us_many" + sfx],
            "many_pairs_plain_ms": kt["plain_many" + sfx],
            "many_pairs_bound_ms": many_bound[0],
            "many_pairs_bound_by": many_bound[1],
        })
    for name, sfx, ingest in (("fx_fused_svd", "", "complex64"),
                              ("fx_fused_i8_svd", "_i8", "int8")):
        kernels.append({
            **bound(WIDEBAND, 1, ingest == "int8", wide_rank),
            "svd_form_operations_ms": svd_form_ms(WIDEBAND, 1, wide_rank),
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": wkt["svd" + sfx], "plain_ms": wkt["plain_svd" + sfx],
            "direct_ms": wkt["direct" + sfx],
            "step_device_launches": step_launches["wideband_step" + sfx],
            "step_ms": wst["kernel" + sfx],
            "plain_step_ms": wst["plain" + sfx], "h2d_ms": wh2d[ingest],
        })
    for name, sfx, ingest in (("fx_fused_multi", "", "complex64"),
                              ("fx_fused_i8_multi", "_i8", "int8")):
        fl, dp = mkt["flagship" + sfx], mkt["deep" + sfx]
        per_block = {key: v / MULTI_K if key == "bound_ms" else v
                     for key, v in bound(FLAGSHIP, MULTI_K,
                                         ingest == "int8").items()}
        kernels.append({
            **per_block,
            "deep_svd_bound_ms": fx_bound(DEEP_CLI, MULTI_K, ingest == "int8",
                                          deep_rank)[0] / MULTI_K,
            "deep_svd_form_operations_ms": svd_form_ms(DEEP_CLI, 1,
                                                       deep_rank),
            "step_device_launches": step_launches["multi_step" + sfx],
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "k": MULTI_K, "ms": fl["multi"], "plain_ms": fl["plain"],
            "one_block_launches_ms": fl["singles"],
            "deep_svd_ms": dp["multi"], "deep_svd_plain_ms": dp["plain"],
            "deep_svd_one_block_launches_ms": dp["singles"],
            "step_ms": mst["multi_step" + sfx],
            "one_block_step_ms": mst["step" + sfx],
            "pinned_copy_ms": mct["pinned" + sfx],
            "pageable_copy_ms": mct["pageable" + sfx],
            "pipeline": {f"k{k}": {key: v for key, v in
                                   pipe[f"{ingest}_k{k}"].items()
                                   if key != "launches"}
                         for k in (1, MULTI_K)},
        })
    kernels.append({
        **bound(SPEC_CASES[-1], 1, False, spectra=True),
        "name": "spectrometer", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["spectrometer"],
        "launches": launches["spectrometer"],
        "max_abs_err": errs["spectrometer"][0],
        "max_rel_err": errs["spectrometer"][1],
        "ms": kt["kernel_spec"], "plain_ms": kt["plain_spec"],
        "device_launches": step_launches["spectrometer_fused"],
    })
    kernels += probe_kernel_entries(table, probe_records, launches, errs,
                                    mkt, device)
    for entry in kernels:
        missing = {"name", "route", "source", "replaces", "launches",
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms"} - set(entry)
        if missing or not entry["launches"] >= 1:
            raise AssertionError(f"kernel entry {entry.get('name')}: missing "
                                 f"{missing} or never launched")
    print(f"  whole run {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"stage_table": table, "card": card}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
