"""What a cell is, found by name from ``BENCHMARK.json``: its
configuration file, its traffic mix, the driver the mix names, its limits,
and the readers of its per-layer metrics.  Every piece is a file of its
own, so a later cell, mix, driver or metric is a new file and an entry.

  configs/<config>.json   the deployment: ``correlator`` holds the
                          CorrelatorConfig fields as run
  mixes/<traffic>.json    ``driver`` (a module in ``drivers/``), its
                          parameters, and ``correlator`` fields it sets
  checks/<workload>.json  the limit of each number compared
  metrics/<metric>.py     ``read(record) -> float | None``"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

__all__ = ["HERE", "ROOT", "Cell", "load_benchmark", "find_cell",
           "metric_reader", "Outcome", "Record"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """One workload of the benchmark, resolved."""
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict          # the configuration file
    mix: dict             # the traffic mix file
    limits: dict          # name -> limit of each number compared
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT     # the checkout the files were read from

    @property
    def driver(self):
        """``fxbench/drivers/<driver>.py`` under the cell's checkout."""
        return _load(self.root / "fxbench" / "drivers"
                     / f"{self.mix['driver']}.py",
                     "fxbench.drivers." + self.mix["driver"])

    def correlator_fields(self) -> dict:
        """The CorrelatorConfig fields of the configuration, with those the
        mix sets."""
        return {**self.config["correlator"], **self.mix.get("correlator", {})}


@dataclasses.dataclass
class Record:
    """What a traced run hands the per-layer readers."""
    spans: Dict[str, list]      # name -> [(start, end)] inside the window
    counters: dict              # the driver's counts and totals
    trace: Optional[dict]       # devtrace.summarise's, or None


@dataclasses.dataclass
class Outcome:
    """One run of a driver."""
    end_to_end: dict            # name -> value
    window_start: float         # host clock; set-up ends here
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict                # name -> reading of the program
    record: Optional[Record] = None
    control: Optional[dict] = None   # name -> reading of the control


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(path: Optional[Path] = None) -> dict:
    return _read_json(path or ROOT / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``bench``, its files under ``root`` (a
    checkout); raises KeyError for an unknown one."""
    here = root / "fxbench"
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, workload) and m["moves"] in moved]
    checks = _read_json(here / "checks" / f"{workload}.json")
    return Cell(name=workload, config_name=cell["config"],
                traffic=cell["traffic"], chips=int(cell["chips"]),
                config=_read_json(root / conf["file"]),
                mix=_read_json(here / "mixes" / f"{cell['traffic']}.json"),
                limits=checks["limits"], end_to_end=e2e, per_layer=layer,
                root=root)


def metric_reader(name: str, root: Path = ROOT
                  ) -> Callable[[Record], Optional[float]]:
    """``read`` of ``fxbench/metrics/<name>.py`` under ``root``."""
    return _load(root / "fxbench" / "metrics" / f"{name}.py",
                 "fxbench.metrics." + name.replace(".", "_")).read


def _load(path: Path, module: str):
    """The module in file ``path``, named ``module``: the one already
    imported from that file, or else loaded once a file, so that a
    driver's classes and functions stay the same objects."""
    known = sys.modules.get(module)
    if known is not None and getattr(known, "__file__", None) == str(path):
        return known
    key = (module, str(path))
    if key not in _LOADED:
        spec = importlib.util.spec_from_file_location(module, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
        sys.modules.setdefault(module, mod)
    return _LOADED[key]


_LOADED: Dict[tuple, object] = {}
