"""fxtpu_torch.probes — the measurement path: where the fused step's time
goes on the card, and what a copy, an overlap and a layout cost there.

The counterparts of ``fxtpu``'s measurement programs, each with a CUDA
kernel written by hand in ``fxtpu_torch/csrc/`` beside its plain version:

  ablate      ``scripts/fused_ablate.py``: the fused step truncated stage
              by stage (``fxt_fx_ablate``, ``csrc/fx_fused.cu``);
  copy_rate   ``scripts/dma_width_probe.py`` and ``dma_shape_probe.py``:
              copy rate against run length and indexing shape
              (``fxt_copy_probe``, ``csrc/probes.cu``);
  overlap     ``scripts/dma_overlap_probe.py``: does a copy hide behind
              the body (``fxt_overlap_probe``);
  retile      ``scripts/retile_probe.py``: the cost of a layout
              (``fxt_retile_probe``);
  breakdown   ``scripts/tpu_breakdown.py``: both routes of ``FxEngine``
              against a float64 oracle, then ``multi_step``'s rate.

``python -m fxtpu_torch.probes <name> [options]`` runs one, ``all`` each in
turn with its defaults.  Every probe takes ``--device`` (``cuda`` by
default, which raises without a card; ``cpu`` runs the plain versions and
prints checksums and byte counts but no times) and prints one JSON object
per line.
"""

from __future__ import annotations

import importlib
import sys

__all__ = ["PROBES", "main"]

PROBES = ("ablate", "copy_rate", "overlap", "retile", "breakdown")


def main(argv=None) -> list:
    """Run ``argv[0]`` (a probe's name, or ``all``) with the remaining
    arguments -> the records it printed."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in (*PROBES, "all"):
        raise SystemExit(
            f"usage: python -m fxtpu_torch.probes {{{','.join(PROBES)},all}} "
            "[options]")
    names = PROBES if argv[0] == "all" else (argv[0],)
    records = []
    for name in names:
        mod = importlib.import_module(f"fxtpu_torch.probes.{name}")
        records += mod.main(argv[1:])
    return records
