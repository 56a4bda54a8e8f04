"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``portbench/workloads/<cell>.json``; it names its configuration
(``portbench/configs/<config>.json``) and its traffic, whose generator is
``portbench/traffic/<kind>.py``. The generator sets the program up, measures for
``--seconds`` seconds, then checks what the timed path produced against the
plain reference in ``portbench/reference/``. With ``--trace 0`` the result
line carries the cell's end-to-end metrics of ``BENCHMARK.json``; with
``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<metric>.py`` from the run's counters and its profiled
slice. Every number compared is printed beside its limit, last on standard
error and last in the result line.

Exits non-zero, printing no result, when there is no CUDA card or fewer than
the cell needs, when the program cannot be imported, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _environment(trace: bool) -> None:
    """Fixed cache directories inside the checkout; the program's stage
    counters in traced runs only."""
    cache = BENCH / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"  # a library that could load JAX by itself does not
    os.environ.pop("ATLASPATCH_TORCH_TRACE", None)
    if trace:
        os.environ["ATLASPATCH_PROFILE"] = "1"
    else:
        os.environ.pop("ATLASPATCH_PROFILE", None)


def _metrics(spec: dict, cell: str, trace: bool, values: dict, layer: dict, harness) -> dict:
    out = {}
    if not trace:
        for m in spec["end_to_end"]:
            if cell in m.get("workloads", [cell]):
                out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        return out
    for m in spec["per_layer"]:
        if cell not in m.get("workloads", [cell]):
            continue
        value = harness.metric_module(m["name"]).read(layer)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment(bool(args.trace))
    sys.path.insert(0, str(ROOT))

    from portbench import harness

    spec = harness.manifest()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    ctx = harness.Context(name=args.workload, workload=harness.workload(args.workload),
                          config=harness.config(cell["config"]), seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), t_process=T_PROCESS)
    ctx.log(f"seed {args.seed}, {args.seconds} s, trace {args.trace}; {harness.power_limit()}")
    result = harness.traffic_module(ctx.workload["traffic"]["kind"]).run(ctx)

    found = harness.forbidden_loaded()
    if found:
        print(f"loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3

    checks = result["checks"]
    line = {
        "correct": all(c["ok"] for c in checks),
        "attempted": result["attempted"],
        "failed": result["failed"],
        "metrics": _metrics(spec, args.workload, ctx.trace, result["e2e"], result.get("layer", {}), harness),
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": cell["chips"],
            "memory_peak_bytes": result["memory_peak_bytes"],
        },
    }
    if ctx.trace:
        summary = result["layer"]["slice"]
        line["device"]["busy_s"] = summary["busy_s"]
        line["device"]["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}) {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
