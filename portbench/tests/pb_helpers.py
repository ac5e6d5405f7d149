"""Reduced-width copies of the benchmark's cells for the CPU tests."""

import json

import torch

from portbench import spec

# limits at the tiny widths, where bf16 against float32 reads larger than at
# the published ones (the cells' own limits are set from full-size runs); a
# reduced cell compares the numbers its cell compares
TINY_LIMITS = {"served_gap": 0.5, "logit_err_p50": 0.5, "logit_err_over_half": 0.1,
               "loss_gap": 0.01, "grad_gap": 0.02, "update_gap": 0.05}
TINY_ARCH = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=256,
                 head_dim=16)


def bench():
    return json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def reduced_cell(name: str) -> spec.Cell:
    """The cell's files at tiny widths: the same driver, traffic kind and
    control flow, small enough for a CPU."""
    cell = spec.find_cell(name, bench())
    a = cell.config["arch"]
    kv = 2 if a["num_kv_heads"] < a["num_heads"] else 4
    a.update(TINY_ARCH, num_kv_heads=kv)
    if a.get("num_experts"):
        a.update(num_experts=8, moe_top_k=2)
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
    if isinstance(tree, dict):
        return {k: zeros(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zeros(v) for v in tree)
    return torch.zeros_like(tree)


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
