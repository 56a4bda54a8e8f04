"""The readings a cell's limits are set from: the program's checked numbers
over many seeds, and the control's over a few, in one process on the card.

    python3 portbench/readings.py --workload <cell> --seeds 12 [--first N] [--seconds 6] [--control-seeds 3]

The program's readings are whole runs of the cell (set-up, a window of
``--seconds`` at the cell's own load, the checks). The control is the
reference, or the program's own path, one precision below the cell's, as the
cell's workload names it and its traffic module's ``control`` runs it (for
``embed.virchow2_bf16`` the program's int8 path; for a cell served at int8,
the reference with W4A4 block linears).

Prints one JSON line per reading and a summary: the largest program reading
and the smallest control reading of each number. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def program_reading(cell: str, seed: int, seconds: float, overrides: dict | None = None) -> dict:
    from portbench import harness

    ctx = harness.Context(name=cell, workload=copy.deepcopy(harness.workload(cell)),
                          config=harness.config(harness.workload(cell)["config"]), seed=seed, seconds=seconds,
                          trace=False)
    ctx.workload["traffic"].update(overrides or {})
    result = harness.traffic_module(ctx.workload["traffic"]["kind"]).run(ctx)
    return {c["name"]: c["value"] for c in result["checks"]}


def control_reading(cell: str, seed: int, seconds: float) -> dict:
    from portbench import harness

    ctx = harness.Context(name=cell, workload=harness.workload(cell),
                          config=harness.config(harness.workload(cell)["config"]), seed=seed, seconds=seconds,
                          trace=False)
    return harness.traffic_module(ctx.workload["traffic"]["kind"]).control(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=2300000000)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    program: dict[str, list] = {}
    control: dict[str, list] = {}
    for i in range(args.seeds):
        r = program_reading(args.workload, args.first + i, args.seconds)
        print(json.dumps({"side": "program", "seed": args.first + i, **r}), flush=True)
        for k, v in r.items():
            program.setdefault(k, []).append(v)
    for i in range(args.control_seeds):
        r = control_reading(args.workload, args.first + 1000 + i, args.seconds)
        print(json.dumps({"side": "control", "seed": args.first + 1000 + i, **r}), flush=True)
        for k, v in r.items():
            control.setdefault(k, []).append(v)
    print(json.dumps({"lower": {k: max(v) for k, v in program.items()},
                      "upper": {k: min(v) for k, v in control.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
