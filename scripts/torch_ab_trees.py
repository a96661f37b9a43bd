"""Two trees' frame kernels of fxtpu_torch in one process, parent / change
/ change / parent: is the production kernel still the same kernel?

A one-block call at the flagship is bounded by the host's enqueue, which
drifts from process to process, so two trees are compared in one process,
on one card, in turns.  This builds the CUDA sources of another checkout
of this repository (``--parent DIR``, e.g. a ``git archive`` of the parent
commit unpacked under ``build/``) and this tree's, each into a library of
its own, and launches the entry both share (``fxt_fx_fused`` /
``fxt_fx_fused_i8``) on the same buffers through this tree's launcher:

  * ``nvcc -Xptxas -v``'s registers, shared memory and spills of each
    tree's production frame kernels;
  * the two libraries' outputs bit for bit (K = 1 and K = 8);
  * the frame kernel's device time (``torch.profiler``) and the call's
    event time, ``--rounds`` rounds in the order A B B A.

    python scripts/torch_ab_trees.py --parent build/parent

prints one JSON line per comparison.
"""

import argparse
import ctypes
import re
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fxtpu_torch import cuda_build  # noqa: E402
from fxtpu_torch.ops import fx_fused as ff  # noqa: E402
from fxtpu_torch.probes import ablate  # noqa: E402
from fxtpu_torch.probes.common import (card_line, emit, event_ms,  # noqa: E402
                                       resolve_device)

SHARED = ("fxt_fx_fused", "fxt_fx_fused_i8", "fxt_error_string")


def production_kernels(log: str) -> dict:
    """``{kernel: "registers, shared memory, spills"}`` of the frame
    kernels in nvcc's ``-Xptxas -v`` output whose stage is the production
    one: an older tree's (no stage parameter) or stage 0 of this one's."""
    out = {}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S*fx_frames_kernel\S*)'",
                      line)
        if not m:
            continue
        stage = re.search(r"ELi(\d+)EEEv", m.group(1))
        if stage and stage.group(1) != "0":
            continue
        policy = "_".join(re.findall(
            r"(F32Rows|I8Rows|F32Raw|I8Raw|DirectFir|SvdFir|CrossOut|SpecOut|"
            r"PartsOut)", m.group(1)))
        info = " ".join(s.strip() for s in lines[i + 1:i + 4]
                        if "registers" in s or "spill" in s)
        out[policy] = re.sub(r"ptxas info\s*:\s*", "", info)
    return out


def build_tree(root: Path, name: str, like=None):
    """Build the CUDA sources of the checkout at ``root`` into
    ``build/fxtpu_torch/ab/lib<name>.so`` of this tree, anew, and load
    them -> (library, nvcc's output).  ``like`` is a declared library whose
    signatures of the shared entries the new one takes (an older tree
    lacks the newer entries)."""
    sources = sorted((root / "fxtpu_torch" / "csrc").glob("*.cu"))
    if not sources:
        raise FileNotFoundError(f"no CUDA sources under {root}")
    path = cuda_build.BUILD_DIR / "ab" / f"lib{name}.so"
    path.unlink(missing_ok=True)
    log = cuda_build.build_library(path, sources)
    lib = ctypes.CDLL(str(path))
    if like is None:
        return cuda_build.declare(lib), log
    for entry in SHARED:
        getattr(lib, entry).restype = getattr(like, entry).restype
        getattr(lib, entry).argtypes = getattr(like, entry).argtypes
    return lib, log


def launch(lib, x, hist, w, pairs, step):
    """One launch of the shared FX entry of ``lib`` over x's K blocks (the
    direct tap loop) -> xp [K, nbl, nbins]."""
    if x.dtype == torch.int8:
        return ff._launch_i8(x, hist, w, pairs, step, None, 0, "A/B launch",
                             True, lib=lib)[0]
    return ff._launch(x, hist, w, pairs, None, 0, "A/B launch", True,
                      lib=lib)[0]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout of this repository")
    ap.add_argument("--num_samp", type=int, default=2**18)
    ap.add_argument("--nbins", type=int, default=4096)
    ap.add_argument("--ntaps", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    card = card_line(device)
    records = []
    change, change_log = build_tree(ROOT, "change")
    parent, parent_log = build_tree(Path(args.parent), "parent", like=change)
    libs = {"parent": parent, "change": change}
    regs = {"parent": production_kernels(parent_log),
            "change": production_kernels(change_log)}
    # the kernels both trees have (a newer tree has more instantiations)
    both = sorted(set(regs["parent"]) & set(regs["change"]))
    emit(records, probe="ab_trees", ptxas=regs, compared=both,
         same=bool(both) and all(regs["parent"][k] == regs["change"][k]
                                 for k in both),
         card=card)
    for ingest in ("complex64", "int8"):
        for k in (1, 8):
            x, hist, w, pairs, step, _ = ablate.make_inputs(
                device, nch=2, k=k, num_samp=args.num_samp,
                nbins=args.nbins, ntaps=args.ntaps, ingest=ingest,
                fir_mode="direct", seed=k)
            outs = {name: launch(lib, x, hist, w, pairs, step)
                    for name, lib in libs.items()}
            torch.cuda.synchronize()
            times = {name: {"frames_us": [], "event_ms": []}
                     for name in libs}
            for _ in range(args.rounds):
                for name in ("parent", "change", "change", "parent"):
                    def fn(lib=libs[name]):
                        return launch(lib, x, hist, w, pairs, step)
                    times[name]["frames_us"].append(
                        ablate.device_times(fn)["frames"])
                    times[name]["event_ms"].append(event_ms(fn, n=20))
            emit(records, probe="ab_trees", ingest=ingest, k=k,
                 num_samp=args.num_samp, nbins=args.nbins, ntaps=args.ntaps,
                 bit_equal=bool(torch.equal(outs["parent"], outs["change"])),
                 **{f"{name}_{key}": {"median": statistics.median(v),
                                      "min": min(v), "max": max(v)}
                    for name, t in times.items() for key, v in t.items()},
                 card=card)
    return records


if __name__ == "__main__":
    main()
