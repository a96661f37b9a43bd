"""Two trees' kernels of fxtpu_torch in one process, parent / change /
change / parent: how much faster, and still right?

A one-block call at the flagship is bounded by the host's enqueue, which
drifts from process to process, so two trees are compared in one process,
on one card, in turns.  This builds the CUDA sources of another checkout
of this repository (``--parent DIR``, e.g. a ``git archive`` of the parent
commit unpacked under ``build/``) and of this tree (or ``--change DIR``),
each into a library of its own, and launches the entries both export on
the same input and output buffers:

  * ``fxt_fx_parts`` / ``fxt_fx_parts_i8`` (the single pass the engine's
    step launches: frame kernel and parts reduce) at the flagship (K = 1
    and 8) and at ``bench_pipeline``'s block;
  * ``fxt_fx_wide_frames`` / ``fxt_fx_wide_frames_i8`` (the wide route's
    frame kernel alone) at bench.py's ``nchan8`` block and at the CLI's
    8-channel deep block (``--nchan 8 --resolution 8192 --ntaps 32``, SVD
    rank 6);
  * the bin counts that are not powers of two in [256, 8192], each at the
    CLI's 2 x 2^18-sample block: the single pass at 384, 3072 and 6144 x 32
    taps (SVD; ``r384``, ``r3072``, ``r6144d``), its wide route's frames
    at 12,288, 16,256 and 16,384 (``r12288``, ``r16256``, ``r16384``);
  * the two-pass ``fxt_fx_fused`` / ``fxt_fx_fused_i8`` at bench.py's
    ``wideband`` shape (2 x 2^21 samples, 8192 bins, 32 taps; ``wideband``
    the SVD mode, ``wideband_direct`` the tap loop) and at the CLI's deep
    block at K = 8 (``deep``, SVD), and the single pass there (``deep_parts``);
    at deep taps a tree with the FIR launch (``fxt_fir_rows``) runs it
    before its frame kernel, a tree without one takes the factors ``u``,
    ``v`` and the rank (its entries' signatures are declared apart);
  * ``fxt_spectrometer`` (complex64 only) at the flagship's shape;
  * ``fxt_xstage`` / ``fxt_xstage_i8`` (the wide route's X kernel with the
    reduce's share folded in, over spectra formed in plain torch) at the
    nchan8 block, at the CLI's ``--nchan 8`` block and, forced onto the
    wide route, at ``bench_pipeline``'s (``nchan8_x``, ``cli8_x``,
    ``pipeline_x``); the entry takes as many plan integers as its
    library's ``fxt_xstage_plan_ints()`` says (none where the library
    has no such symbol: the X kernel before its launch plan), and the
    row map after the pairs where ``fxt_xstage_pointers()`` says 9 (a
    library without it takes none and is given a row instance's plan,
    ``fx_xstage.row_plan``, as before the register-tiled instance);
  * a whole single-pass step (``step_*``: the flagship at K = 1 and 8,
    ``bench_pipeline``'s block in CONTINUUM, the ``--nchan 8`` CLI block
    and the nchan8 block on the wide route): in a tree with the step entry
    (``fxt_fx_step`` / ``_i8``) its one call, in a tree without it the
    calls the parent's ``fx_fused_step`` made (``fxt_fx_parts`` then
    ``fxt_fx_finish``; on the wide route ``fxt_fx_wide_frames``,
    ``fxt_xstage``, ``fxt_fx_finish``), on the same buffers; the
    visibilities, mu and the new history compared bit for bit, and the
    epilogue's exposed time (its end less its predecessor's end) and the
    step's span on the device;

each in both ingests; and the two probes a tree's kernels are measured
with (``overlap``, ``retile``): every leg of ``fxt_overlap_probe`` at the
probe's defaults (4096 bins, 4 taps, chunks of 512, each structure with
the shared memory the tree's own ``probes/overlap.py`` asks for) under
both copy mechanisms, and every form of ``fxt_retile_probe`` (each tree's
own grid), each tree's ms a repeat by the slope between two repeat counts
inside one launch, and its checksum against the plain version; and
reports

  * ``nvcc -Xptxas -v``'s registers, shared memory and spills of each
    tree's production frame kernels (the radix-16 instances and the
    ``kMixed`` ones apart), of the FFT's bodies, of the FIR launch and of
    the overlap and retile probes' kernels;
  * each tree's largest difference from the plain version on the same
    input (parts: of max|xp|; spectra: of max|spectrum|), the largest
    difference between the two trees' outputs (of the parent's largest
    magnitude) and whether their mu and new history are equal bit for bit;
  * each kernel's device time by name (``fx_frames_kernel``,
    ``fx_parts_reduce_kernel``, ``fx_xstage_kernel``; ``torch.profiler``,
    the median of ten launches a round) and the call's event time,
    ``--rounds`` rounds in the order A B B A.

    python scripts/torch_ab_trees.py --parent build/parent [--cases
        flagship,nchan8,overlap,retile]

prints one JSON line per comparison.
"""

import argparse
import ctypes
import hashlib
import importlib.util
import re
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fxtpu_torch import cuda_build  # noqa: E402
from fxtpu_torch.ops import fx_epilogue as fe  # noqa: E402
from fxtpu_torch.ops import fx_fused as ff  # noqa: E402
from fxtpu_torch.ops.dc_posthoc import dc_constants  # noqa: E402
from fxtpu_torch.ops.fx_xstage import (fx_xstage_reference,  # noqa: E402
                                       row_map, row_plan, xstage_plan)
from fxtpu_torch.ops.xengine import baseline_pairs, pack_delays  # noqa: E402
from fxtpu_torch.probes import ablate  # noqa: E402
from fxtpu_torch.probes import overlap, retile  # noqa: E402
from fxtpu_torch.probes.common import (card_line, device_events,  # noqa: E402
                                       emit, event_ms, resolve_device,
                                       slope_ms, sm_count, step_exposed_us)

SHARED = ("fxt_fx_parts", "fxt_fx_parts_i8", "fxt_fx_wide_frames",
          "fxt_fx_wide_frames_i8", "fxt_fx_fused", "fxt_fx_fused_i8",
          "fxt_spectrometer", "fxt_xstage", "fxt_xstage_i8", "fxt_fx_finish",
          "fxt_error_string")
#: The entries whose FIR arguments changed with the deep-tap FIR launch: a
#: tree without ``fxt_fir_rows`` takes the window, the factors u and v and
#: the rank (its signatures here), one with it the FIR's table and the
#: launch's scratch (``cuda_build.declare``).
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
#: ``fxt_fx_finish`` of a tree without the step entry, which the A/B calls
#: there: no ``chunk`` (the one-bin-a-thread instance alone).
FINISH_SIGNATURE = [_P] * 13 + [ctypes.c_longlong] * 3 + [_I] * 7 + [_D, _P]
FACTOR_SIGNATURES = {
    "fxt_fx_parts": [_P] * 13 + [_I] * 9 + [_P],
    "fxt_fx_parts_i8": [_P] * 13 + [_I] * 9 + [_D, _P],
    "fxt_fx_wide_frames": [_P] * 8 + [_I] * 8 + [_P],
    "fxt_fx_wide_frames_i8": [_P] * 8 + [_I] * 8 + [_D, _P],
    "fxt_fx_fused": [_P] * 11 + [_I] * 10 + [_P],
    "fxt_fx_fused_i8": [_P] * 12 + [_I] * 10 + [_D, _P],
}


class FactorStepArgs(ctypes.Structure):
    """``FxtStepArgs`` of a tree without the FIR launch: the window, the
    factors u and v and the rank where the FIR's table and scratch are
    now."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "x", "hist", "w", "u", "v", "tw", "pairs", "da", "sums", "scratch",
        "parts", "mu", "new_hist", "mu_prev", "abar", "cs", "cab", "cbb",
        "delays", "freqs", "vis")]
        + [("step", ctypes.c_double), ("bandwidth", ctypes.c_double)]
        + [(name, ctypes.c_int) for name in (
            "nch", "K", "S", "nbins", "ntaps", "rank", "nbl", "n_groups",
            "frames_per_group", "wide", "packed", "continuum", "tile",
            "slots", "rows", "frames", "stages", "threads")])


def fir_args(lib, window2d, svd, fir):
    """The FIR's pointers of an entry in ``lib``'s form: the table and the
    scratch, or (a tree without the FIR launch) the window, u and v."""
    if lib.fir_launch:
        return (ff.fir_table(window2d, svd).data_ptr(),
                None if fir is None else fir.data_ptr())
    return (window2d.data_ptr(), *((None, None) if svd is None else (
        svd[0].data_ptr(), svd[1].data_ptr())))


def factor_step_args(args, plan) -> FactorStepArgs:
    """``args`` (``cuda_build.StepArgs``) in the form of a tree without the
    FIR launch: the window and the factors where the FIR's table and
    scratch are, and the rank."""
    out = FactorStepArgs()
    for name, _ in FactorStepArgs._fields_:
        if hasattr(args, name):
            setattr(out, name, getattr(args, name))
    out.w = plan.window2d.data_ptr()
    out.u, out.v = ((None, None) if plan.svd is None else
                    (plan.svd[0].data_ptr(), plan.svd[1].data_ptr()))
    out.rank = plan.rank
    return out


def rank_arg(lib, svd):
    """The rank argument a tree without the FIR launch takes after ntaps
    (none in one with it)."""
    if lib.fir_launch:
        return ()
    return (0 if svd is None else svd[0].shape[1],)
#: The step entry, in the trees that have it.
STEP_ENTRIES = ("fxt_fx_step", "fxt_fx_step_i8")
#: The kernels whose device time is reported, by the name the profiler
#: gives them.
KERNELS = ("fx_frames_kernel", "fx_parts_reduce_kernel", "fx_xstage_kernel",
           "fx_finish_kernel", "fir_rows_kernel", "fx_reduce",
           "fx_wide_halves_kernel")
#: name -> (entry, nch, samples a channel, nbins, ntaps, K, FIR mode, autos)
CASES = {
    "flagship": ("parts", 2, 2**18, 4096, 4, 1, "direct", False),
    "flagship_k8": ("parts", 2, 2**18, 4096, 4, 8, "direct", False),
    "pipeline": ("parts", 2, 2**21, 4096, 4, 1, "direct", False),
    "nchan8": ("wide", 8, 2**20, 4096, 4, 1, "direct", True),
    "deep8": ("wide", 8, 2**18, 8192, 32, 1, "svd", False),
    "spectrometer": ("spec", 2, 2**18, 4096, 4, 1, "direct", False),
    "nchan8_x": ("xstage", 8, 2**20, 4096, 4, 1, "direct", True),
    "cli8_x": ("xstage", 8, 2**18, 4096, 4, 1, "direct", False),
    "pipeline_x": ("xstage", 2, 2**21, 4096, 4, 1, "direct", False),
    "nch64_x": ("xstage", 64, 2**18, 4096, 4, 1, "direct", True),
    "array8_x": ("xstage", 8, 2**18, 4096, 4, 32, "direct", True),
    "step_flagship": ("step", 2, 2**18, 4096, 4, 1, "direct", False),
    "step_flagship_k8": ("step", 2, 2**18, 4096, 4, 8, "direct", False),
    "step_pipeline": ("step", 2, 2**21, 4096, 4, 1, "direct", False),
    "step_cli8": ("step", 8, 2**18, 4096, 4, 1, "direct", False),
    "step_nchan8": ("step", 8, 2**20, 4096, 4, 1, "direct", True),
    "step_array8": ("step", 8, 2**18, 4096, 4, 32, "direct", True),
    "r384": ("parts", 2, 2**18, 384, 4, 1, "direct", False),
    "r3072": ("parts", 2, 2**18, 3072, 4, 1, "direct", False),
    "r6144d": ("parts", 2, 2**18, 6144, 32, 1, "svd", False),
    "r12288": ("wide", 2, 2**18, 12288, 4, 1, "direct", False),
    "r16256": ("wide", 2, 2**18, 16256, 4, 1, "direct", False),
    "r16384": ("wide", 2, 2**18, 16384, 4, 1, "direct", False),
    "wideband": ("fused", 2, 2**21, 8192, 32, 1, "svd", False),
    "wideband_direct": ("fused", 2, 2**21, 8192, 32, 1, "direct", False),
    "deep": ("fused", 2, 2**18, 8192, 32, 8, "svd", False),
    "deep_parts": ("parts", 2, 2**18, 8192, 32, 8, "svd", False),
}
#: The step cases whose epilogue reduces to the continuum (CONTINUUM).
CONTINUUM = ("step_pipeline",)
#: The probe cases: ``fxt_overlap_probe`` and ``fxt_retile_probe``.
PROBE_CASES = ("overlap", "retile")
PROBE_ENTRIES = ("fxt_overlap_probe", "fxt_retile_probe")
#: The overlap probe's defaults (``python -m fxtpu_torch.probes overlap``)
#: and the repeat counts of each slope.
OVERLAP_SHAPE = dict(n=4096, cb=512, ntaps=4, frames=32)
OVERLAP_REPS = (2, 8)
RETILE_REPS = (64, 1024)
OVERLAP_LEGS = (("copy", True, "touch"), ("comp_fma", False, "fma"),
                ("comp_fx", False, "fx"), ("body_fma", True, "fma"),
                ("body_fx", True, "fx"))


def production_kernels(log: str) -> dict:
    """``{kernel: "registers, shared memory, spills"}`` of the frame
    kernels in nvcc's ``-Xptxas -v`` output whose stage is the production
    one (stage 0), of every instance of the parts reduce and the X kernel
    (``fx_xstage_kernel<float2,8>``: complex64 samples, 8 rows a thread)
    and of the epilogue, and the stack and spills of the FFT's bodies
    (``fft_sized<log2 n>``, called by every frame kernel)."""
    out = {}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S*fx_frames_kernel\S*)'",
                      line)
        if not m:
            continue
        stage = re.search(r"ELi(\d+)E(?:Lb[01]E)?EEv", m.group(1))
        if stage and stage.group(1) != "0":
            continue
        policy = "_".join(re.findall(
            r"(F32Rows|I8Rows|F32Raw|I8Raw|DirectFir|SvdFir|RowsFir|CrossOut|"
            r"SpecOut|PartsOut|WideOut)", m.group(1)))
        if re.search(r"Lb1EEEv", m.group(1)):
            policy += "_kMixed"
        info = " ".join(s.strip() for s in lines[i + 1:i + 4]
                        if "registers" in s or "spill" in s)
        out[policy] = re.sub(r"ptxas info\s*:\s*", "", info)
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*(fx_xstage_kernel|"
                      r"fx_parts_reduce_kernel)I\d+([A-Za-z]\w*?)(?:Li(\d+)E)?EE?v",
                      line)
        if not m:
            continue
        name = f"{m.group(1)}<{m.group(2)}" + (
            f",{m.group(3)}>" if m.group(3) else ">")
        info = " ".join(s.strip() for s in lines[i + 1:i + 4]
                        if "registers" in s or "spill" in s)
        out[name] = re.sub(r"ptxas info\s*:\s*", "", info)
    for i, line in enumerate(lines):
        if re.search(r"Compiling entry function '\S*fx_finish_kernel", line):
            out["fx_finish_kernel"] = re.sub(
                r"ptxas info\s*:\s*", "", " ".join(
                    s.strip() for s in lines[i + 1:i + 4]
                    if "registers" in s or "spill" in s))
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for (\S*(fft_sized|fft_pass_reg|"
                      r"fft_pass_direct|fft_pass16|fft_pass_prime_last|"
                      r"fft_mixed)\S*)", line)
        if m and i + 1 < len(lines):
            size = re.search(r"ILi(\d+)E", m.group(1))
            key = m.group(2) + (f"<{size.group(1)}>" if size else "")
            out.setdefault(key, set()).add(lines[i + 1].strip())
        m = re.search(r"Compiling entry function '\S*fir_rows_kernel\S*?"
                      r"(F32Rows|I8Rows|F32Raw|I8Raw)", line)
        if m:
            out[f"fir_rows_kernel<{m.group(1)}>"] = re.sub(
                r"ptxas info\s*:\s*", "", " ".join(
                    s.strip() for s in lines[i + 1:i + 4]
                    if "registers" in s or "spill" in s))
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*(overlap_probe_kernel|"
                      r"retile_mma_kernel|retile_stockham_kernel)"
                      r"((?:ILi\d+E)?(?:Li\d+E)*)", line)
        if m:
            args = ",".join(re.findall(r"Li(\d+)E", m.group(2)))
            out[f"{m.group(1)}<{args}>"] = re.sub(
                r"ptxas info\s*:\s*", "", " ".join(
                    s.strip() for s in lines[i + 1:i + 4]
                    if "registers" in s or "spill" in s))
    return {k: sorted(v) if isinstance(v, set) else v
            for k, v in out.items()}


def build_tree(root: Path, name: str, like=None):
    """Build the CUDA sources of the checkout at ``root`` into
    ``build/fxtpu_torch/ab/lib<name>_<hash>.so`` of this tree (once per
    content: a second call with the same sources loads the first's) ->
    (library, nvcc's output).  ``like`` is a declared library whose
    signatures of the shared entries the new one takes."""
    sources = sorted((root / "fxtpu_torch" / "csrc").glob("*.cu"))
    if not sources:
        raise FileNotFoundError(f"no CUDA sources under {root}")
    h = hashlib.sha256()
    for src in sources + sorted((root / "fxtpu_torch" / "csrc").glob("*.cuh")):
        h.update(src.name.encode() + src.read_bytes())
    path = cuda_build.BUILD_DIR / "ab" / f"lib{name}_{h.hexdigest()[:12]}.so"
    log_path = path.with_suffix(".log")
    if path.exists() and log_path.exists():
        log = log_path.read_text()
    else:
        log = cuda_build.build_library(path, sources)
        log_path.write_text(log)
    lib = ctypes.CDLL(str(path))
    ints = getattr(lib, "fxt_xstage_plan_ints", None)
    lib.plan_ints = ints() if ints is not None else 0
    pointers = getattr(lib, "fxt_xstage_pointers", None)
    lib.row_map = pointers is not None and pointers() == 9
    lib.has_step = getattr(lib, STEP_ENTRIES[0], None) is not None
    lib.fir_launch = getattr(lib, "fxt_fir_rows", None) is not None
    if like is None:
        return cuda_build.declare(lib), log
    for entry in SHARED + PROBE_ENTRIES + (STEP_ENTRIES if lib.has_step
                                           else ()):
        getattr(lib, entry).restype = getattr(like, entry).restype
        getattr(lib, entry).argtypes = getattr(like, entry).argtypes
    if not lib.has_step:    # its epilogue predates the plan's chunk
        lib.fxt_fx_finish.argtypes = FINISH_SIGNATURE
    if like.fir_launch and not lib.fir_launch:
        for entry, argtypes in FACTOR_SIGNATURES.items():
            getattr(lib, entry).argtypes = argtypes
        for entry in STEP_ENTRIES if lib.has_step else ():
            getattr(lib, entry).argtypes = [
                ctypes.POINTER(FactorStepArgs), _P]
    # the X kernel's entries: the pointers (the row map after the pairs
    # where the library takes one), 7 integers, then the plan's integers,
    # as many as this library takes
    head = 9 if like.row_map else 8
    for entry in ("fxt_xstage", "fxt_xstage_i8"):
        fn = getattr(lib, entry)
        ptrs = [_P] * (9 if lib.row_map else 8)
        fn.argtypes = (ptrs + [_I] * (7 + lib.plan_ints)
                       + fn.argtypes[head + 7 + like.plan_ints:])
    return lib, log


class Case:
    """One shape's inputs, output buffers and plain result, on the card."""

    def __init__(self, name, ingest, device):
        (self.entry, nch, num_samp, nbins, ntaps, k, fir,
         autos) = CASES[name]
        if self.entry == "spec":
            ingest = "complex64"
        self.x, self.hist, self.w, _, self.step, self.svd = (
            ablate.make_inputs(device, nch=nch, k=k, num_samp=num_samp,
                               nbins=nbins, ntaps=ntaps, ingest=ingest,
                               fir_mode=fir, seed=k + nch))
        if ingest == "int8":
            self.mu_prev = self.hist["mu_prev"]
            self.hist = self.hist["tail"]
        self.pairs = ff.pairs_tensor(
            baseline_pairs(nch, include_autos=autos), nch, device)
        self.int8 = ingest == "int8"
        self.rank = 0 if self.svd is None else self.svd[0].shape[1]
        self.nch, self.k, self.nbins, self.ntaps = nch, k, nbins, ntaps
        self.s_rows = num_samp // nbins
        self.consts = dc_constants(self.w.cpu().numpy(), nbins, self.s_rows,
                                   device, self.svd)
        nbl = self.pairs.shape[0]
        c64 = dict(dtype=torch.complex64, device=device)
        if self.entry in ("parts", "wide", "xstage"):
            # the single pass's plan and buffers, on the entry's route
            plan = ff.plan_parts(
                self.x, self.hist, self.w, self.pairs, self.svd, self.consts,
                self.step if self.int8 else None,
                "shared" if self.entry == "parts" else "global")
            self.n_groups, self.per = plan.n_groups, plan.per
            bufs = ff.parts_buffers(plan)
            (self.sums, self.scratch, self.parts, self.mu,
             self.new_hist) = (bufs[name] for name in (
                 "sums", "scratch", "parts", "mu", "new_hist"))
            self.fir = bufs.get("fir")
        else:
            # the two-pass entry (partials of the cross power, xp, the mean
            # pre-pass's sums) and the spectrometer's (below)
            self.fir = ff._fir_scratch(nch, k, self.s_rows, nbins, ntaps,
                                       device)
            self.n_groups, self.per = ff._groups(self.s_rows, nbl, nbins)
            self.scratch = torch.empty((k, self.n_groups, nbl, nbins), **c64)
            self.parts = torch.empty(
                (k, nbl if self.entry == "fused" else nbl + 2 * nch, nbins),
                **c64)
            self.mu = torch.empty((k, nch), **c64)
            self.new_hist = torch.empty_like(self.hist)
            self.sums = torch.empty(
                (k, ff.MEAN_PARTS, nch, 2),
                dtype=torch.int64 if self.int8 else torch.float64,
                device=device)
        if self.entry == "xstage":
            self.scratch = self._spectra().transpose(0, 1).contiguous()
            # the groups' sample sums, as the wide route's frame kernel
            # leaves them for the X kernel
            xs = self.x.long() if self.int8 else torch.view_as_real(
                self.x).double()
            self.sums = torch.stack(
                [xs[:, :, g * self.per:(g + 1) * self.per].sum(dim=(2, 3))
                 for g in range(self.n_groups)], dim=2).permute(
                     1, 2, 0, 3).contiguous()
        self.tw = ff._twiddles(nbins, device)
        if self.entry == "spec":
            # one block [nch, nsamp], its DC-corrected history, spectra out
            self.x = self.x.reshape(nch, num_samp)
            self.n_groups, self.per = ff._groups(self.s_rows, 1, nbins)
            self.scratch = torch.empty((nch, self.s_rows, nbins), **c64)
            self.sums = torch.empty((nch, ff.MEAN_PARTS, 2),
                                    dtype=torch.float64, device=device)
        self.plain = self._plain()

    def _plain(self):
        """The plain version: parts (xp, T, GJ) or the spectra."""
        svd, hist = self.svd, self.hist
        x = self.x
        if self.entry == "spec":
            from fxtpu_torch.ops.spectrometer import (
                spectrometer_fused_reference)
            return spectrometer_fused_reference(x, self.w, self.nbins,
                                                hist)[0]
        if self.entry == "parts":
            if self.int8:
                xp, t, gj, _, _ = ff.fx_fused_parts_i8_reference(
                    x, hist, self.w, self.pairs, self.step, svd, self.consts)
            else:
                xp, t, gj, _, _ = ff.fx_fused_parts_reference(
                    x, hist, self.w, self.pairs, svd, self.consts)
            return torch.cat([xp, t, gj], dim=1)
        if self.entry == "xstage":
            return fx_xstage_reference(self.scratch, self.pairs,
                                       self.consts[1])
        if self.entry == "fused":
            if self.int8:
                return ff.fx_fused_raw_i8_multi_reference(
                    x, {"tail": hist, "mu_prev": self.mu_prev}, self.w,
                    self.pairs, self.step, svd)[0]
            return ff.fx_fused_raw_multi_reference(x, hist, self.w,
                                                   self.pairs, svd)[0]
        return self._spectra().transpose(0, 1)

    def _spectra(self):
        """The spectra ``[nch, K, S, nbins]`` of the case's rows, in
        plain torch."""
        svd, hist, x = self.svd, self.hist, self.x
        if self.int8:
            from fxtpu_torch.ops.pfb import dequantize
            rows = dequantize(x, self.step).reshape(self.nch, -1, self.nbins)
            hist = dequantize(hist, self.step)
        else:
            rows = x.reshape(self.nch, -1, self.nbins)
        return ff._raw_spectra(rows, hist, x.shape[:4], self.w, svd)

    def launch(self, lib):
        """One call of the tree's entry into this case's buffers."""
        fir = fir_args(lib, self.w, self.svd, self.fir)
        rank = rank_arg(lib, self.svd)
        extra = (self.step,) if self.int8 else ()
        stream = torch.cuda.current_stream().cuda_stream
        if self.entry == "parts":
            fn = lib.fxt_fx_parts_i8 if self.int8 else lib.fxt_fx_parts
            rc = fn(self.x.data_ptr(), self.hist.data_ptr(), *fir,
                    self.tw.data_ptr(), self.pairs.data_ptr(),
                    self.consts[1].data_ptr(), self.sums.data_ptr(),
                    self.scratch.data_ptr(), self.parts.data_ptr(),
                    self.mu.data_ptr(), self.new_hist.data_ptr(), self.nch,
                    self.k, self.s_rows, self.nbins, self.ntaps, *rank,
                    self.pairs.shape[0], self.n_groups, self.per, *extra,
                    stream)
        elif self.entry == "fused":
            head = ((self.x.data_ptr(), self.hist.data_ptr(),
                     self.mu_prev.data_ptr()) if self.int8
                    else (self.x.data_ptr(), self.hist.data_ptr()))
            out = self.mu if self.int8 else self.new_hist
            fn = lib.fxt_fx_fused_i8 if self.int8 else lib.fxt_fx_fused
            rc = fn(*head, *fir, self.tw.data_ptr(), self.pairs.data_ptr(),
                    self.sums.data_ptr(), self.scratch.data_ptr(),
                    self.parts.data_ptr(), out.data_ptr(), self.nch, self.k,
                    self.s_rows, self.nbins, self.ntaps, *rank,
                    self.pairs.shape[0], self.n_groups, self.per,
                    ff.MEAN_PARTS, *extra, stream)
        elif self.entry == "xstage":
            fn = lib.fxt_xstage_i8 if self.int8 else lib.fxt_xstage
            nbl = self.pairs.shape[0]
            planner = xstage_plan if lib.row_map else row_plan
            plan = planner(self.nch, nbl, self.s_rows, self.nbins,
                           self.k).args() if lib.plan_ints else ()
            if len(plan) != lib.plan_ints:
                raise RuntimeError(f"the library's X entry takes "
                                   f"{lib.plan_ints} plan integers, this "
                                   f"tree plans {len(plan)}")
            rmap = ((row_map(self.pairs, self.nch).data_ptr(),)
                    if lib.row_map else ())
            rc = fn(self.scratch.data_ptr(), self.pairs.data_ptr(), *rmap,
                    self.consts[1].data_ptr(), self.parts.data_ptr(),
                    self.x.data_ptr(), self.sums.data_ptr(),
                    self.mu.data_ptr(), self.new_hist.data_ptr(), self.nch,
                    self.k, self.s_rows, self.nbins, nbl, self.ntaps - 1,
                    self.n_groups, *plan, *extra, stream)
        elif self.entry == "spec":
            rc = lib.fxt_spectrometer(
                self.x.data_ptr(), self.hist.data_ptr(), self.w.data_ptr(),
                self.tw.data_ptr(), self.sums.data_ptr(),
                self.scratch.data_ptr(), self.new_hist.data_ptr(),
                self.x.shape[1], self.nch, self.s_rows, self.nbins,
                self.ntaps, self.n_groups, self.per, ff.MEAN_PARTS, stream)
        else:
            fn = (lib.fxt_fx_wide_frames_i8 if self.int8
                  else lib.fxt_fx_wide_frames)
            rc = fn(self.x.data_ptr(), self.hist.data_ptr(), *fir,
                    self.tw.data_ptr(), self.sums.data_ptr(),
                    self.scratch.data_ptr(), self.nch, self.k, self.s_rows,
                    self.nbins, self.ntaps, *rank, self.n_groups, self.per,
                    *extra, stream)
        cuda_build.check(lib, rc, "A/B launch")

    def output(self):
        """The last call's output: the parts (the two-pass entry: xp), or
        the spectra."""
        return self.parts if self.entry in ("parts", "xstage", "fused") else (
            self.scratch)

    def fold(self):
        """The last call's mu and new history (the two-pass entry: the new
        history, or the 8-bit mu; None for the entries that form
        neither)."""
        if self.entry == "fused":
            return ((self.mu.clone(),) if self.int8
                    else (self.new_hist.clone(),))
        return ((self.mu.clone(), self.new_hist.clone())
                if self.entry in ("parts", "xstage") else None)

    def error(self):
        """Largest difference of the last call's output from the plain
        version, over the plain version's largest magnitude (parts: that
        of the cross power)."""
        if self.entry in ("parts", "xstage", "fused"):
            nbl = self.pairs.shape[0]
            got, want = self.parts, self.plain
            scale = want[:, :nbl].abs().max().item()
        else:
            got, want = self.scratch, self.plain
            scale = want.abs().max().item()
        return (got - want).abs().max().item() / scale


class StepCase:
    """One shape's whole single-pass step: the inputs, the buffers both
    trees' calls write (``fx_epilogue.step_buffers``), and the plain
    visibilities (the plain single pass and the plain epilogue)."""

    def __init__(self, name, ingest, device):
        (self.entry, nch, num_samp, nbins, ntaps, k, fir,
         autos) = CASES[name]
        x, hist, w, _, step, svd = ablate.make_inputs(
            device, nch=nch, k=k, num_samp=num_samp, nbins=nbins,
            ntaps=ntaps, ingest=ingest, fir_mode=fir, seed=k + nch)
        self.int8 = ingest == "int8"
        pairs_np = baseline_pairs(nch, include_autos=autos)
        pairs = ff.pairs_tensor(pairs_np, nch, device)
        s_rows = num_samp // nbins
        consts = dc_constants(w.cpu().numpy(), nbins, s_rows, device, svd)
        tables = fe.FinishTables(pairs_np, nbins, 2.4e6, 1.4204e9, device)
        d = (np.tile(np.arange(nch) * 2e-6, (k, 1))
             + 1e-7 * np.arange(k)[:, None])
        delays = torch.as_tensor(pack_delays(d, 1.4204e9), device=device)
        self.plan = p = fe.check_step(
            x, hist, w, pairs, consts, delays, tables, 2.4e6,
            name in CONTINUUM, step if self.int8 else None, svd)
        self.bufs = fe.step_buffers(p)
        self.args = fe.step_args(p, self.bufs)
        self.factor_args = factor_step_args(self.args, p)
        self.nch, self.k, self.nbins, self.ntaps = nch, k, nbins, ntaps
        self.rank = p.rank
        wide = p.route == "global"
        if self.int8:
            ref = (ff.fx_fused_parts_i8_wide_reference if wide
                   else ff.fx_fused_parts_i8_reference)(
                x, p.hist, w, pairs, step, svd, consts)
        else:
            ref = (ff.fx_fused_parts_wide_reference if wide
                   else ff.fx_fused_parts_reference)(
                x, p.hist, w, pairs, svd, consts)
        self.plain = fe.fx_finish_reference(
            *ref[:4], pairs, consts, delays, tables, s_rows, 2.4e6,
            p.continuum, p.mu_prev)

    def launch(self, lib):
        """One step from ``lib``: its step entry, or in a tree without
        one the calls the parent's ``fx_fused_step`` made."""
        stream = torch.cuda.current_stream().cuda_stream
        if lib.has_step:
            fn = lib.fxt_fx_step_i8 if self.int8 else lib.fxt_fx_step
            args = self.args if lib.fir_launch else self.factor_args
            cuda_build.check(lib, fn(ctypes.byref(args), stream),
                             "A/B step")
            return
        p, b = self.plan, self.bufs
        extra = (p.quant_step,) if self.int8 else ()
        rank = rank_arg(lib, p.svd)
        head = (p.x.data_ptr(), p.hist.data_ptr(),
                *fir_args(lib, p.window2d, p.svd, b.get("fir")),
                p.tw.data_ptr())
        da = p.consts[1].data_ptr()
        if p.route == "global":
            fn = (lib.fxt_fx_wide_frames_i8 if self.int8
                  else lib.fxt_fx_wide_frames)
            rc = fn(*head, b["sums"].data_ptr(), b["scratch"].data_ptr(),
                    p.nch, p.k, p.s_rows, p.nbins, p.ntaps, *rank,
                    p.n_groups, p.per, *extra, stream)
            cuda_build.check(lib, rc, "A/B wide frames")
            plan = p.xplan.args() if lib.plan_ints else ()
            fn = lib.fxt_xstage_i8 if self.int8 else lib.fxt_xstage
            rmap = ((None if p.rowmap is None else p.rowmap.data_ptr(),)
                    if lib.row_map else ())
            rc = fn(b["scratch"].data_ptr(), p.pairs.data_ptr(), *rmap, da,
                    b["parts"].data_ptr(), p.x.data_ptr(),
                    b["sums"].data_ptr(), b["mu"].data_ptr(),
                    b["new_hist"].data_ptr(), p.nch, p.k, p.s_rows, p.nbins,
                    p.nbl, p.ntaps - 1, p.n_groups, *plan, *extra, stream)
        else:
            fn = lib.fxt_fx_parts_i8 if self.int8 else lib.fxt_fx_parts
            rc = fn(*head, p.pairs.data_ptr(), da, b["sums"].data_ptr(),
                    b["scratch"].data_ptr(), b["parts"].data_ptr(),
                    b["mu"].data_ptr(), b["new_hist"].data_ptr(), p.nch,
                    p.k, p.s_rows, p.nbins, p.ntaps, *rank, p.nbl,
                    p.n_groups, p.per, *extra, stream)
        cuda_build.check(lib, rc, "A/B parts")
        abar, _, cs, cab, cbb = p.consts
        parts = b["parts"].data_ptr()
        rows = (p.nbl + 2 * p.nch) * p.nbins
        rc = lib.fxt_fx_finish(
            parts, parts + 8 * p.nbl * p.nbins,
            parts + 8 * (p.nbl + p.nch) * p.nbins, b["mu"].data_ptr(),
            None if p.mu_prev is None else p.mu_prev.data_ptr(),
            p.pairs.data_ptr(), abar.data_ptr(), cs.data_ptr(),
            cab.data_ptr(), cbb.data_ptr(), p.delays.data_ptr(),
            p.freqs.data_ptr(), b["vis"].data_ptr(), rows, rows, rows, p.k,
            p.nbl, p.nch, p.nbins, int(p.packed), int(p.continuum),
            p.s_rows, p.bandwidth, stream)
        cuda_build.check(lib, rc, "A/B finish")

    def output(self):
        return self.bufs["vis"]

    def fold(self):
        return self.bufs["mu"].clone(), self.bufs["new_hist"].clone()

    def error(self):
        """Largest difference of the visibilities from the plain step's,
        over their largest magnitude."""
        return ((self.bufs["vis"] - self.plain).abs().max().item()
                / self.plain.abs().max().item())


def tree_module(root: Path, name: str):
    """A probe module (``overlap``, ``retile``) of the checkout at ``root``,
    loaded as it stands beside this tree's: its own shared-memory plan and
    grid, with this tree's imports."""
    path = root / "fxtpu_torch" / "probes" / f"{name}.py"
    key = f"_ab_{name}_{hashlib.sha256(str(root).encode()).hexdigest()[:8]}"
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod      # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def overlap_smem(mod, n, cb, ntaps, nbuf, per_sm):
    """The shared memory a tree's overlap probe asks for in a structure,
    and its layout's record (the parent's probe has one layout, chunked)."""
    if hasattr(mod, "plan"):
        lay = mod.plan(n, cb, ntaps, nbuf, per_sm)
        need, info = lay.shared_bytes, dict(rows_read_once=lay.rows_once,
                                            teams=lay.teams)
    else:
        need, info = (mod.shared_bytes(n, cb, ntaps, nbuf),
                      dict(rows_read_once=False, teams=1))
    return (need if per_sm > 1 else max(need, mod.ONE_CTA_BYTES)), info


def probe_cases(name, libs, roots, rounds, device, card, records):
    """The A/B of one probe (:data:`PROBE_CASES`): each leg's ms a repeat in
    each tree, A B B A over ``rounds`` rounds, and each tree's checksum
    against the plain version."""
    sms = sm_count(device)
    mods = {tree: tree_module(root, name) for tree, root in roots.items()}
    stream = torch.cuda.current_stream(device).cuda_stream

    def compare(legs):
        for key, launch, plain, info in legs:
            err = {}
            for tree in libs:
                got = launch(tree, OVERLAP_REPS[0] if name == "overlap"
                             else RETILE_REPS[0])
                torch.cuda.synchronize()
                err[tree] = ((got - plain).abs().max().item()
                             / plain.abs().max().item())
            per = {tree: [] for tree in libs}
            lo, hi = OVERLAP_REPS if name == "overlap" else RETILE_REPS
            for _ in range(rounds):
                for tree in ("parent", "change", "change", "parent"):
                    per[tree].append(slope_ms(
                        lambda r, t=tree: launch(t, r), lo, hi)[2])
            med = {tree: statistics.median(v) for tree, v in per.items()}
            emit(records, probe="ab_trees", case=name, **key,
                 max_err_vs_plain=err, reps=[lo, hi],
                 **{f"{tree}_ms_per_rep": {"median": med[tree],
                                           "min": min(v), "max": max(v)}
                    for tree, v in per.items()},
                 speedup=med["parent"] / med["change"], **info, card=card)

    if name == "overlap":
        n, cb, ntaps = (OVERLAP_SHAPE[k] for k in ("n", "cb", "ntaps"))
        gen = torch.Generator(device=device).manual_seed(0)
        src = torch.view_as_complex(torch.randn(
            (2 * sms * OVERLAP_SHAPE["frames"] + ntaps - 1, n, 2),
            device=device, generator=gen))
        tw = ff._twiddles(n, device)
        for mech in overlap.MECHS:
            legs = []
            for structure, (nbuf, per_sm) in overlap.STRUCTURES.items():
                grid = per_sm * sms
                frames = OVERLAP_SHAPE["frames"] * 2 // per_sm
                smem = {tree: overlap_smem(mods[tree], n, cb, ntaps, nbuf,
                                           per_sm) for tree in libs}
                for leg, copy, body in OVERLAP_LEGS:
                    out = torch.empty((grid, n), dtype=torch.complex64,
                                      device=device)

                    def launch(tree, reps, grid=grid, frames=frames,
                               nbuf=nbuf, copy=copy, body=body, out=out,
                               smem=smem, mech=mech):
                        mod = mods[tree]
                        rc = libs[tree].fxt_overlap_probe(
                            src.data_ptr(), out.data_ptr(), tw.data_ptr(), n,
                            n.bit_length() - 1, cb, ntaps, frames, reps, nbuf,
                            int(copy), mod.FMA_PASSES, mod.BODIES.index(body),
                            mod.MECHS[mech], grid, smem[tree][0], stream)
                        if rc:
                            raise RuntimeError(f"{tree} overlap probe: {rc}")
                        return out
                    plain = overlap.overlap_probe_reference(
                        src, cb=cb, ntaps=ntaps, frames=frames,
                        reps=OVERLAP_REPS[0], nbuf=nbuf, copy=copy,
                        body=body, grid=grid)
                    info = {f"{tree}_layout": smem[tree][1] for tree in libs}
                    change_lay = smem["change"][1]
                    # each tree's schedule, as reckoned (the parent's
                    # chunks re-read every frame's rows; the change's
                    # reckoning is held to its kernel's own count by the
                    # probe and by chip_smoke.py)
                    info["schedule_bytes_per_rep"] = {
                        "parent": overlap.copy_bytes(grid, frames, ntaps, n)
                        * copy,
                        "change": overlap.device_bytes(
                            grid, frames, ntaps, n,
                            change_lay["rows_read_once"]) * copy}
                    legs.append((dict(mech=mech, structure=structure, leg=leg,
                                      body=body, copy=copy, grid=grid,
                                      frames_per_cta=frames), launch, plain,
                                 info))
            compare(legs)
        return
    x, xt, m = retile.make_inputs(device)
    tw = ff._twiddles(retile.STOCKHAM_POINTS, device)
    slots_of = retile.NT * retile.TILE
    legs = []
    for form in retile.FORMS:
        grids = {}
        for tree in libs:
            mod = mods[tree]
            grids[tree] = (mod.launch_grid(form, slots_of * RETILE_REPS[0],
                                           x.shape[0], sms)
                           if hasattr(mod, "launch_grid")
                           else min(8 * sms, slots_of * RETILE_REPS[0]))
        outs = {tree: torch.empty((g, retile.N1, retile.N2),
                                  dtype=torch.float32, device=device)
                for tree, g in grids.items()}

        def launch(tree, reps, form=form, outs=outs, grids=grids):
            rc = libs[tree].fxt_retile_probe(
                x.data_ptr(), xt.data_ptr(), m.data_ptr(), tw.data_ptr(),
                outs[tree].data_ptr(), x.shape[0], slots_of, reps,
                retile.FORMS.index(form), grids[tree], stream)
            if rc:
                raise RuntimeError(f"{tree} retile probe: {rc}")
            return outs[tree].sum(dim=0)
        plain = (retile.stockham_reference(x, retile.NT, RETILE_REPS[0])
                 if form == "stockham" else
                 retile.retile_reference(x, m, retile.NT, RETILE_REPS[0]))
        legs.append((dict(form=form), launch, plain, {"grid": grids}))
    compare(legs)


def kernel_us(fn, n=10):
    """Median device microseconds of each kernel of :data:`KERNELS` that
    a call of fn launches, over n calls: ``{name: us}``."""
    events = device_events(fn, n)
    out = {}
    if len(events) == 3 * n and "fx_finish_kernel" in events[-1]["name"]:
        out["exposed"], out["span"] = step_exposed_us(events)
    for name in KERNELS:
        durs = [e["dur"] for e in events if e["cat"] == "kernel"
                and name in e["name"]]
        if durs and len(durs) != n:
            raise RuntimeError(f"{len(durs)} {name} records of {n} calls")
        if durs:
            out[name] = statistics.median(durs)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout of this repository")
    ap.add_argument("--change", default=str(ROOT),
                    help="root of the checkout under test (this one)")
    ap.add_argument("--cases", default=",".join((*CASES, *PROBE_CASES)),
                    help="comma-separated subset of "
                         f"{(*CASES, *PROBE_CASES)}")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    card = card_line(device)
    records = []
    change, change_log = build_tree(Path(args.change), "change")
    parent, parent_log = build_tree(Path(args.parent), "parent", like=change)
    libs = {"parent": parent, "change": change}
    emit(records, probe="ab_trees", change=args.change, parent=args.parent,
         ptxas={"parent": production_kernels(parent_log),
                "change": production_kernels(change_log)},
         card=card)
    roots = {"parent": Path(args.parent), "change": Path(args.change)}
    for name in args.cases.split(","):
        if name in PROBE_CASES:
            probe_cases(name, libs, roots, args.rounds, device, card, records)
            continue
        for ingest in (("complex64",) if CASES[name][0] == "spec"
                       else ("complex64", "int8")):
            case = (StepCase if CASES[name][0] == "step" else Case)(
                name, ingest, device)
            err, outs, folds = {}, {}, {}
            for tree, lib in libs.items():
                case.launch(lib)
                torch.cuda.synchronize()
                err[tree] = case.error()
                outs[tree] = case.output().clone()
                folds[tree] = case.fold()
            scale = outs["parent"].abs().max().item()
            times = {tree: {"event_ms": []} for tree in libs}
            for _ in range(args.rounds):
                for tree in ("parent", "change", "change", "parent"):
                    def fn(lib=libs[tree]):
                        case.launch(lib)
                    for kname, us in kernel_us(fn).items():
                        times[tree].setdefault(kname + "_us", []).append(us)
                    times[tree]["event_ms"].append(event_ms(fn, n=20))
            emit(records, probe="ab_trees", case=name, ingest=ingest,
                 entry=case.entry, nch=case.nch, k=case.k, nbins=case.nbins,
                 ntaps=case.ntaps, rank=case.rank,
                 max_err_vs_plain=err,
                 max_diff_between_trees=(
                     (outs["parent"] - outs["change"]).abs().max().item()
                     / scale),
                 steps={tree: lib.has_step for tree, lib in libs.items()},
                 mu_and_history_equal=(None if folds["parent"] is None
                                       else all(torch.equal(a, b) for a, b
                                                in zip(folds["parent"],
                                                       folds["change"]))),
                 **{f"{tree}_{key}": {"median": statistics.median(v),
                                      "min": min(v), "max": max(v)}
                    for tree, t in times.items() for key, v in t.items()},
                 speedup={key[:-3]: (statistics.median(times["parent"][key])
                                     / statistics.median(
                                         times["change"][key]))
                          for key in times["change"]
                          if key.endswith("_us") and key in times["parent"]},
                 card=card)
            del case
            torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
