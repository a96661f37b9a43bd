"""The readings that the limits of ``fxbench/checks/`` are set from: for
each seed a run of the cell with a short window at its own load, then each
number compared, once for the program's outputs and once for the control's
(the reference in bfloat16 put in the program's place, judged the same
way), on the same inputs.  All seeds run in one process.

    python -m fxbench.control --workload <name> --seeds 1,2,3 --seconds 5

One JSON line a seed, then one with the largest program reading (the
lower) and the smallest control reading (the upper) of each number.  The
benchmark's own runs never run the control."""

from __future__ import annotations

import argparse
import json
import sys


def readings(cell, seeds, seconds: float, device: str) -> list:
    """``[{"seed", "program", "control"}]`` for ``seeds``."""
    out = []
    for seed in seeds:
        res = cell.driver.run(cell, seed=seed, seconds=seconds, trace=False,
                              device=device, control=True)
        out.append({"seed": seed, "program": res.checks,
                    "control": res.control})
    return out


def bounds(rows: list) -> dict:
    """The lower (largest program) and upper (smallest control) reading
    of each number; the upper is None for a count the control does not
    judge (the live cell's ``failed_blocks``, limit 0)."""
    names = rows[0]["program"]
    return {n: {"lower": max(r["program"][n] for r in rows),
                "upper": (min(r["control"][n] for r in rows)
                          if n in rows[0]["control"] else None)}
            for n in names}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from fxbench.cells import find_cell, load_benchmark
    cell = find_cell(load_benchmark(), args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(cell, [seed], args.seconds, args.device)[0]
        print(json.dumps({"workload": args.workload, **row}), flush=True)
        rows.append(row)
    print(json.dumps({"workload": args.workload, "readings": bounds(rows),
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
