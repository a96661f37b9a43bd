"""Run one cell of the benchmark once and print its result.

    python -m fxbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``fxtpu_torch``.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number that decided ``correct``
beside its limit, which also close standard error.  Exits non-zero and
prints no result without a CUDA card (or fewer than the cell asks for),
and when JAX or the JAX package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: Top-level module names that may not be loaded (compared whole:
#: ``fxtpu_torch`` is the program, ``fxtpu`` the JAX package).
FORBIDDEN = ("jax", "jaxlib", "flax", "fxtpu")


def forbidden_modules() -> list:
    """The forbidden top-level names present in ``sys.modules``."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def card_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({type(exc).__name__})"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else \
        f"not read (rc {res.returncode})"


def result_line(cell, outcome, trace: bool, device: dict, setup_s: float
                ) -> dict:
    """The JSON result of one run, ``checks`` last."""
    from fxbench.cells import metric_reader
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(outcome.record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = (setup_s if m["name"] == "setup_s"
                     else outcome.end_to_end[m["name"]])
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {name: {"value": float(v), "limit": float(cell.limits[name])}
              for name, v in outcome.checks.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and set(checks) == set(
                      cell.limits)
    line = {"correct": bool(correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": device}
    if trace and outcome.record is not None and outcome.record.trace:
        t = outcome.record.trace
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from fxbench.cells import find_cell, load_benchmark
    cell = find_cell(load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"fxbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 3
    print(f"fxbench: torch and CUDA up {time.perf_counter() - T_START:.3f} s "
          "after start", file=sys.stderr)
    outcome = cell.driver.run(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = result_line(cell, outcome, bool(args.trace), device,
                       outcome.window_start - T_START)
    if args.trace:
        print(f"fxbench: card {card_power_limit()}", file=sys.stderr)
        t = outcome.record.trace if outcome.record is not None else None
        if t:
            print(f"fxbench: trace: {t['launches']} launches, "
                  f"{t['lost_records']} without their device record",
                  file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"fxbench: the run loaded {bad}, which no run may load",
              file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"fxbench check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
