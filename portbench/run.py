#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell's files are found by name
(``portbench/spec.py``); its driver makes the weights and the traffic from
the seed, warms the cell's shapes, measures for ``--seconds``, then checks
what the timed path produced against the plain reference.  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics.  The last line on standard output is
one JSON object; the last lines on standard error are the numbers compared,
each beside its limit.  ``--control 1`` (not part of a measured run) also
reads the reference in float8 at the same positions, the control that the
limits are set against.

Needs a CUDA card: without one, or with fewer than the cell asks for, it
exits with 2 and prints no result.  The program's kernels build into
``build/kernels`` inside the checkout, once.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the ``perf_counter`` clock."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = _process_start()
ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

BANNED = ("jax", "jaxlib", "flax", "repro", "ml_dtypes")


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def build_result(cell, res, trace: bool, device_kind: str):
    """The result object (keys in the order printed) and the compared lines."""
    from portbench import spec
    obs, checks = res["obs"], res["checks"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    limits = cell.cell.get("limits", {})
    compared = {k: {"value": float(checks[k]), "limit": float(v)} for k, v in limits.items()}
    for k, v in checks.items():
        if k not in compared and k != "compared" and not k.startswith(("control_", "fault_")) \
                and isinstance(v, float):
            compared[k] = {"value": v, "limit": None}      # read, not compared
        for pre in ("control_", "fault_half_batch_"):
            if k.startswith(pre):
                base = k[len(pre):]
                compared[k] = {"value": float(v),
                               "limit": float(limits[base]) if base in limits else None}
    correct = (bool(limits) and checks.get("compared", 0) > 0
               and all(checks[k] <= v for k, v in limits.items()))
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": int(res["peak"] or 0)}
    out = {"correct": bool(correct), "attempted": len(obs.requests),
           "failed": sum(1 for r in obs.requests if r.failed),
           "metrics": metrics, "device": device}
    if trace and obs.trace is not None:
        device["busy_s"] = obs.trace.busy_s()
        device["window_s"] = obs.trace.span_s
        out["breakdown"] = obs.trace.breakdown()
    out["checks"] = compared
    out["checks"]["compared"] = {"value": checks.get("compared", 0), "limit": None}
    return out


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import spec

    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = spec.driver(cell).run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                T_START, control=bool(args.control))
    out = build_result(cell, res, bool(args.trace), torch.cuda.get_device_name(0))
    found = banned_modules()
    if found:
        print(f"portbench: loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    notes = res.get("notes", {})
    if notes:
        print("portbench: " + json.dumps(notes), file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"compare {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
