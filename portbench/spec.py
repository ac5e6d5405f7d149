"""Finding a cell's files by name: ``BENCHMARK.json`` at the root of the
checkout, and under ``portbench/`` one file a configuration, traffic mix,
cell, traffic kind, driver, metric and architecture."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# what an architecture's module gives (``reference/<module>.py``)
INTERFACE = ("make_weights", "forward_logits", "train_loss", "prefill_ops", "decode_ops",
             "attention_bound_s", "train_step_ops", "tiny")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from its file, by path: metric files carry dots in their
    names, which ``import`` cannot spell."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]        # configs/<config>.json
    traffic: Dict[str, Any]       # traffic/<traffic>.json
    cell: Dict[str, Any]          # cells/<name>.json
    reference: Any                # reference/<config's "reference">.py
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)


def _applies(metric: Dict[str, Any], cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def find_cell(name: str, bench: Dict[str, Any] | None = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    cell = load_json(HERE / "cells" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    reported = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(entry["chips"]), config, traffic, cell, reference(config),
                e2e, layer)


def reference(config: Dict[str, Any]):
    """``reference/<module>.py``, the architecture a configuration names
    under ``"reference"``: its weights, its plain reference and its counts
    of operations and bytes (``INTERFACE``)."""
    mod = importlib.import_module(f"portbench.reference.{config['reference']}")
    missing = [n for n in INTERFACE if not callable(getattr(mod, n, None))]
    if missing:
        raise AttributeError(f"{mod.__name__} lacks {', '.join(missing)}")
    return mod


def traffic_kind(traffic: Dict[str, Any]):
    """``traffic/<kind>.py``, the generator of a traffic file's kind."""
    return importlib.import_module(f"portbench.traffic.{traffic['kind']}")


def driver(cell: Cell):
    """``drivers/<driver>.py``, the driver a cell file names."""
    return importlib.import_module(f"portbench.drivers.{cell.cell['driver']}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))
