"""Multi-process execution: the worker entry point and a local launcher.

Counterpart of ``fxtpu.parallel.multihost`` on ``torch.distributed``:
every process runs the same program over one mesh
(:mod:`fxtpu_torch.parallel.mesh`), owns a contiguous run of its shards,
feeds only the sample span they own (``ingest.local_sample_span``) and
exchanges halos and sums with the others
(:mod:`~fxtpu_torch.parallel.collectives`).

  * :func:`launch` spawns N local workers, ``python -m
    fxtpu_torch.parallel.multihost --role ... --process_id i``, which join
    over TCP; it waits for all of them within a timeout and kills every
    worker when one fails or the time is up.
  * The worker itself (:func:`main`), also what a deployment runs on each
    host with ``--coordinator host0:port``.

Roles:

  * ``step``: one sharded FX step on a block made from a seed; every
    process prints its launch counts of that step as one JSON line, and
    process 0 saves the visibility and the new history (``--out``, .npz);
  * ``correlate``: a Correlator run over a replay recording, each process
    feeding its own span; process 0 writes the CSV product.

``--device cuda`` (the default) puts every process's shards on the
card(s) it sees, and raises where there is none; ``--device cpu`` runs on
the CPU.  ``--backend`` is
``gloo`` (the CPU, or several processes on one card; CUDA tensors are
staged through pinned host memory) or ``nccl`` (one card a process).
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
from typing import List, Optional

__all__ = ["launch", "step_block", "main"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_device(device: str):
    """Raise unless ``device`` is ``"cpu"`` or ``"cuda"`` with a card."""
    import torch
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda."
                           "is_available() is False; ask for 'cpu'")


def launch(num_processes: int, role: str, role_args: List[str],
           local_devices: int = 4, timeout: float = 600.0,
           coordinator: Optional[str] = None, *, backend: str = "gloo",
           device: str = "cuda"):
    """Spawn ``num_processes`` local workers and wait for all of them,
    ``timeout`` seconds at most in all.  Returns the list of
    ``subprocess.CompletedProcess``; raises with the failing workers'
    output on a nonzero exit, and kills every worker when one fails or
    the time is up.  ``device`` is ``"cuda"`` unless the caller asks for
    ``"cpu"``; ``"cuda"`` raises here, before any worker starts, where
    no card is present."""
    _check_device(device)
    coordinator = coordinator or f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(num_processes):
        cmd = [sys.executable, "-m", "fxtpu_torch.parallel.multihost",
               "--role", role,
               "--process_id", str(pid),
               "--num_processes", str(num_processes),
               "--coordinator", coordinator,
               "--local_devices", str(local_devices),
               "--backend", backend,
               "--device", device,
               "--timeout", str(timeout)] + list(role_args)
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    results, failed = [], []
    try:
        for pid, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"multi-process worker {pid} timed out "
                                   f"after {timeout} s") from None
            results.append(subprocess.CompletedProcess(p.args, p.returncode,
                                                       out, None))
            if p.returncode != 0:
                failed.append((pid, out))
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        msgs = "\n\n".join(f"--- worker {pid} (rc != 0) ---\n{out[-4000:]}"
                           for pid, out in failed)
        raise RuntimeError(f"multi-process workers failed:\n{msgs}")
    return results


# ---------------------------------------------------------------------------
# Worker roles
# ---------------------------------------------------------------------------

def _build_mesh(args):
    from fxtpu_torch.parallel.mesh import all_shards, make_correlator_mesh
    shards = all_shards(args.local_devices, args.device)
    return make_correlator_mesh(len(shards) // args.mesh_freq,
                                args.mesh_freq, shards)


def step_block(num_samp: int):
    """The ``step`` role's block: two channels from a seed."""
    import numpy as np
    rng = np.random.default_rng(20260817)
    return (rng.normal(size=(2, num_samp)).astype(np.float32)
            + 1j * rng.normal(size=(2, num_samp)).astype(np.float32)
            ).astype(np.complex64)


def _role_step(args):
    """One sharded FX step over the block of :func:`step_block`, each
    process placing only its span; process 0 saves the visibility and the
    new history to ``--out`` (.npz)."""
    import numpy as np
    import torch

    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.parallel.ingest import local_sample_span

    mesh = _build_mesh(args)
    cfg = CorrelatorConfig(mode="SPECTRUM", nchan=2, ntaps=4,
                           nbins=args.nbins, num_samp=args.num_samp,
                           clamp_num_samp=False, fused=bool(args.fused),
                           device=args.device)
    eng = FxEngine(cfg, mesh=mesh)
    start, stop = local_sample_span(mesh, args.num_samp, args.nbins)
    iq = eng.prepare_block(step_block(args.num_samp)[:, start:stop])
    delays = torch.tensor([0.0, 1.25e-6], device=eng.device)
    before = eng.launch_counts()
    vis, hist = eng.step(iq, delays, eng.fresh_history())
    launches = {k: v - before[k] for k, v in eng.launch_counts().items()}
    vis, hist = vis.cpu().numpy(), hist.cpu().numpy()
    if not np.all(np.isfinite(vis)):
        raise RuntimeError("non-finite visibility")
    if mesh.process_index == 0 and args.out:
        np.savez(args.out, vis=vis, hist=hist,
                 volume=np.array([mesh.volume[k] for k in sorted(mesh.volume)]),
                 staged_bytes=mesh.staged_bytes)
    print(json.dumps({"process": mesh.process_index,
                      "kernel_active": eng.kernel_active,
                      "local_shards": len(mesh.local),
                      "launches": launches}), flush=True)
    print(f"[step worker {mesh.process_index}] OK mesh={mesh.shape} "
          f"vis={vis.shape} fused={eng.fused_active} "
          f"staged_bytes={mesh.staged_bytes} launches={launches}", flush=True)


def _role_correlate(args):
    """A Correlator run over a replay recording; process 0 writes the CSV
    product.  Every process feeds only its local sample span."""
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.correlator import Correlator

    mesh = _build_mesh(args)
    cfg = CorrelatorConfig(
        mode=args.mode, nchan=2, nbins=args.nbins, num_samp=args.num_samp,
        clamp_num_samp=False, source="replay", replay_file=args.recording,
        run_time=30, loglevel="WARNING", output_file=args.out,
        calibrate_on_start=True, startup_duration=0.2,
        fused=bool(args.fused), device=args.device)
    cor = Correlator(config=cfg, mesh=mesh)
    cor.run_state_machine()
    print(f"[correlate worker {mesh.process_index}] OK "
          f"blocks={cor.blocks_processed} "
          f"delays_us={1e6 * cor.calibrated_delays}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--role", required=True, choices=["step", "correlate"])
    p.add_argument("--process_id", type=int, required=True)
    p.add_argument("--num_processes", type=int, required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--local_devices", type=int, default=4)
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--mesh_freq", type=int, default=2)
    p.add_argument("--nbins", type=int, default=256)
    p.add_argument("--num_samp", type=int, default=256 * 64)
    p.add_argument("--mode", default="SPECTRUM")
    p.add_argument("--fused", action="store_true")
    p.add_argument("--recording", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from fxtpu_torch.parallel.mesh import init_distributed
    _check_device(args.device)
    if args.device == "cpu":
        torch.set_num_threads(2)
    # the rendezvous and every collective give up after --timeout seconds
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     backend=args.backend, timeout=args.timeout)
    try:
        if args.role == "step":
            _role_step(args)
        else:
            _role_correlate(args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
