"""Reduced-width copies of the benchmark's cells for the CPU tests."""

import collections
import json
import types

import torch

from portbench import spec
from portbench.weights import map_leaves

# limits at the tiny widths, where bf16 against float32 reads larger than at
# the published ones (the cells' own limits are set from full-size runs); a
# reduced cell compares the numbers its cell compares
TINY_LIMITS = {"served_gap": 0.5, "logit_err_p50": 0.5, "logit_err_over_half": 0.1,
               "loss_gap": 0.01, "grad_gap": 0.02, "update_gap": 0.05}


def bench():
    return json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def reduced_cell(name: str, reference: str = "") -> spec.Cell:
    """The cell's files at tiny widths (its architecture's ``tiny``): the
    same driver, traffic kind and control flow, small enough for a CPU.
    ``reference`` names another architecture module for its config."""
    cell = spec.find_cell(name, bench())
    if reference:
        cell.config["reference"] = reference
        cell.reference = spec.reference(cell.config)
    cell.config["arch"] = cell.reference.tiny(cell.config["arch"])
    if "serve" in cell.config:
        cell.config["serve"].update(cache_cap=80, slots=2)
    cell.cell["limits"] = {k: TINY_LIMITS[k] for k in cell.cell["limits"]}
    t = cell.traffic
    if t["kind"] == "doc_stream":
        t.update(len_min=16, len_max=64, pool=16, warm_requests=8 * t.get("clients", 1),
                 check_tokens=600)
    else:
        t.update(batch=2, seq=32)
    return cell


def zeros(tree):
    """A tree of tensors like ``tree``, all zeros."""
    return map_leaves(torch.zeros_like, tree)


def probe(base, name: str = "portbench.reference.probe"):
    """A module that gives ``base``'s functions of ``spec.INTERFACE`` and
    counts each call by name in its ``calls``."""
    mod = types.ModuleType(name)
    mod.calls = collections.Counter()

    def recorded(fn_name, fn):
        def call(*args, **kwargs):
            mod.calls[fn_name] += 1
            return fn(*args, **kwargs)
        return call
    for fn_name in spec.INTERFACE:
        setattr(mod, fn_name, recorded(fn_name, getattr(base, fn_name)))
    return mod


def one_replica_state_unchanged(srv):
    """The prefill on the first of the server's replicas alone hands back a
    session state it never filled: the sessions prefilled there, and every
    later hit on them, read zeros."""
    run, prefill = srv._run_request, srv.prefill_fn
    bad, on = sorted(srv.replicas)[0], [False]

    def run_one(replica, routed):
        on[0] = replica.name == bad
        run(replica, routed)

    def fn(params, batch):
        logits, caches = prefill(params, batch)
        return logits, zeros(caches) if on[0] else caches
    srv._run_request, srv.prefill_fn = run_one, fn
