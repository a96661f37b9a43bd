"""Command-line entry point: ``python -m fxtpu_torch [flags]``.

The same flags as ``fxtpu.cli`` (a superset of the reference CLI,
``effex/effex.py:703-772``), plus ``--device {cuda,cpu}``
(default cuda), which takes the place of the JAX backend switch
``--platform``.  Without a CUDA device the run raises unless
``--device cpu`` was asked for.  ``--ingest int8`` keeps samples 8-bit
from the source to the card.  ``--blocks_per_dispatch K`` correlates K
blocks per device call, staged by a background thread (pinned host
buffers, the copy on its own CUDA stream).  ``--snapshot_every N``
writes the streaming state every N blocks to ``<output>.state.npz``, in
``fxtpu``'s snapshot format, and ``--resume_from FILE`` continues from
such a snapshot, this package's or ``fxtpu``'s (replay and synthetic
sources).  ``--mesh_time T --mesh_freq F`` shards the step over a T x F
mesh of ``--local_devices`` shards a process on the device
(``fxtpu_torch.parallel``); ``--num_processes N --process_id i
--coordinator host:port`` runs process i of N (the same command once per
process; ``--backend`` gloo or nccl), each feeding the sample span its
shards own, process 0 writing the products; without a mesh flag their
mesh is every shard, ``freq`` 2 where their count is even.
"""

from __future__ import annotations

import argparse

from fxtpu_torch.config import CorrelatorConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="FX correlator in PyTorch with CUDA kernels for Hopper.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    # --- reference-parity flags (effex.py:706-770) -----------------------
    parser.add_argument("--time", "-T", default=1.0, type=float,
                        dest="run_time",
                        help="(sec) Total amount of time to run correlator.")
    parser.add_argument("--bandwidth", "-B", default=2.4e6, type=float,
                        help="(Hz) Receiver bandwidth == sample rate. "
                             "Applied to all channels.")
    parser.add_argument("--frequency", "-F", default=1.4204e9, type=float,
                        dest="fc",
                        help="(Hz) Center tuning frequency. Applied to all "
                             "channels.")
    parser.add_argument("--num_samp", "-N", default=2**18, type=int,
                        help="(int) Number of samples per block.")
    parser.add_argument("--resolution", "-R", default=2**12, type=int,
                        dest="nfft",
                        help="(int) Number of FFT bins.")
    parser.add_argument("--gain", "-G", default=49.6, type=float,
                        help="(dB) Tuner gain.")
    parser.add_argument("--mode", "-M", default="spectrum", type=str,
                        choices=["continuum", "spectrum", "test"],
                        help="continuum: visibility amplitude over time; "
                             "spectrum: complex visibility spectra; "
                             "test: artificial delay sweep (fringe check).")
    parser.add_argument("--omit_plot", "-P", action="store_true",
                        help="Skip the matplotlib post-processing step.")
    parser.add_argument("--loglevel", "-L", default="INFO", type=str,
                        choices=["INFO", "WARNING", "DEBUG", "ERROR",
                                 "CRITICAL"],
                        help="Python logging module loglevel.")
    # --- fxtpu extensions --------------------------------------------------
    parser.add_argument("--source", default="synthetic",
                        choices=["synthetic", "replay", "rtlsdr"],
                        help="IQ signal source.")
    parser.add_argument("--nchan", default=2, type=int,
                        help="Number of input channels (N-element array).")
    parser.add_argument("--ntaps", default=4, type=int,
                        help="PFB taps per branch.")
    parser.add_argument("--replay_file", default=None, type=str,
                        help="Recorded IQ file(s) for --source replay: "
                             ".npy/.c64 complex recordings, or NATIVE "
                             "rtl_sdr captures (raw interleaved u8 I,Q; "
                             ".iq/.u8/.iq8/.rtl, comma-separated one "
                             "file per channel — replayed 8-bit "
                             "end-to-end under --ingest int8).")
    parser.add_argument("--seed", default=77777, type=int,
                        help="Synthetic-source RNG seed.")
    parser.add_argument("--true_delay", default=0.0, type=float,
                        help="(sec) injected inter-channel delay for the "
                             "synthetic source (ground truth for cal).")
    parser.add_argument("--snr", default=10.0, type=float,
                        help="Synthetic common-signal to noise power ratio.")
    parser.add_argument("--output", default=None, type=str,
                        help="Output CSV path (default: timestamped).")
    parser.add_argument("--mesh_time", default=1, type=int,
                        help="Time-block shards (data-parallel analog).")
    parser.add_argument("--mesh_freq", default=1, type=int,
                        help="Frequency-bin shards (tensor-parallel analog).")
    parser.add_argument("--save_plot", default=None, type=str,
                        help="Save figures to this path instead of showing.")
    parser.add_argument("--no_keyboard", action="store_true",
                        help="Disable the interactive 'c'-to-recalibrate key.")
    parser.add_argument("--blocks_per_dispatch", default=1, type=int,
                        help="Blocks correlated per device call (one "
                             "K-block kernel launch on the fused route, "
                             "staged by a background thread; amortizes "
                             "launches and copies for sustained "
                             "streaming).")
    parser.add_argument("--integration_blocks", default=1, type=int,
                        help="Blocks averaged per output row.")
    parser.add_argument("--snapshot_every", default=0, type=int,
                        help="Blocks between resumable state snapshots "
                             "(0: none), written to <output>.state.npz.")
    parser.add_argument("--resume_from", default=None, type=str,
                        help="Resume from a state snapshot (.npz) of this "
                             "package or of fxtpu (replay and synthetic "
                             "sources).")
    parser.add_argument("--profile_dir", default=None, type=str,
                        help="Write a torch.profiler trace of the run here "
                             "(trace.json, Chrome trace format).")
    parser.add_argument("--ingest", default="complex64",
                        choices=["complex64", "int8"],
                        help="IQ ingest dtype: int8 streams 8-bit quantized "
                             "samples through rings + H2D (4x fewer bytes; "
                             "radio ADCs are 8-bit), dequantized on-device.")
    # --- multi-host (run the same command on every host) -------------------
    parser.add_argument("--num_processes", default=1, type=int,
                        help="Multi-host: total controller processes. Run "
                             "this CLI once per host with a distinct "
                             "--process_id; each feeds only the sample span "
                             "its devices own, process 0 writes products.")
    parser.add_argument("--process_id", default=0, type=int,
                        help="Multi-host: this process's id [0, N).")
    parser.add_argument("--coordinator", default="127.0.0.1:9731", type=str,
                        help="Multi-host: coordinator address host:port.")
    parser.add_argument("--local_devices", default=4, type=int,
                        help="Mesh shards per process (on --device; "
                             "several may share one card or the CPU).")
    parser.add_argument("--backend", default="gloo",
                        choices=["gloo", "nccl"],
                        help="torch.distributed backend of a multi-process "
                             "run: nccl where every process owns its own "
                             "card, gloo otherwise.")
    # --- the port's device (takes the place of fxtpu's --platform) -------
    parser.add_argument("--device", default="cuda",
                        choices=["cuda", "cpu"],
                        help="Torch device of the FX step. cuda raises when "
                             "no CUDA device is present; cpu runs the plain "
                             "torch path.")
    return parser


def _run(cfg: CorrelatorConfig, args):
    """Build the mesh the flags ask for (None for one device) and run the
    Correlator to its end."""
    mesh = None
    if args.num_processes > 1 or cfg.mesh_time * cfg.mesh_freq > 1:
        from fxtpu_torch.parallel.mesh import all_shards, make_correlator_mesh
        shards = all_shards(args.local_devices, args.device)
        if cfg.mesh_time * cfg.mesh_freq > 1:
            mesh = make_correlator_mesh(cfg.mesh_time, cfg.mesh_freq, shards)
        else:
            # the default multi-process mesh: every shard, freq=2 when even
            f = 2 if len(shards) % 2 == 0 else 1
            mesh = make_correlator_mesh(len(shards) // f, f, shards)

    from fxtpu_torch.correlator import Correlator
    cor = Correlator(config=cfg, mesh=mesh)
    cor.run_state_machine()
    return cor


def main(argv=None):
    args = build_parser().parse_args(argv)

    cfg = CorrelatorConfig(
        run_time=args.run_time,
        bandwidth=args.bandwidth,
        frequency=args.fc,
        num_samp=args.num_samp,
        nbins=args.nfft,
        gain=args.gain,
        mode=args.mode,
        loglevel=args.loglevel,
        nchan=args.nchan,
        ntaps=args.ntaps,
        source=args.source,
        replay_file=args.replay_file,
        seed=args.seed,
        synthetic_delay=args.true_delay,
        synthetic_snr=args.snr,
        output_file=args.output,
        omit_plot=args.omit_plot,
        mesh_time=args.mesh_time,
        mesh_freq=args.mesh_freq,
        keyboard_control=not args.no_keyboard,
        blocks_per_dispatch=args.blocks_per_dispatch,
        integration_blocks=args.integration_blocks,
        snapshot_every=args.snapshot_every,
        resume_from=args.resume_from,
        profile_dir=args.profile_dir,
        ingest_dtype=args.ingest,
        device=args.device,
    )

    if args.num_processes > 1:
        # join the other processes before building the mesh; every
        # process runs this same command with its own --process_id
        from fxtpu_torch.parallel.mesh import init_distributed
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, backend=args.backend)
    try:
        cor = _run(cfg, args)
    finally:
        if args.num_processes > 1:
            import torch.distributed as dist
            dist.destroy_process_group()

    if not cor._is_primary:
        return cor  # only process 0 holds products to post-process

    # Reload our own CSV and post-process (effex.py:784-807).
    if cor.writer is not None:
        cor.writer.join(timeout=5.0)
    sweep_step = cor.test_delay_sweep_step if args.mode == "test" else 0

    from fxtpu_torch.post_process import post_process
    from fxtpu_torch.products import load_products
    _, output = load_products(cor.output_file)
    post_process(output,
                 args.bandwidth,
                 args.fc,
                 args.nfft,
                 args.mode,
                 args.omit_plot,
                 test_delay_sweep_step=sweep_step,
                 save=args.save_plot,
                 show=args.save_plot is None and not args.omit_plot)
    return cor


if __name__ == "__main__":
    main()
