"""Each cell's control flow through the harness at reduced widths on the
CPU: the driver, the readers and the result line, with ``correct`` true on
the program as it is and false with its timed path broken underneath."""

import sys
import time

import pytest
import torch

from portbench import spec
from portbench.run import build_result
from pb_helpers import bench, one_replica_state_unchanged, probe, reduced_cell, zeros

CELLS = [w["name"] for w in bench()["workloads"]]
SERVE = [c for c in CELLS if spec.find_cell(c).cell["driver"] == "serve"]
TRAIN = [c for c in CELLS if spec.find_cell(c).cell["driver"] == "train"]
DEVICE = {m["name"] for m in bench()["per_layer"] + bench()["end_to_end"]
          if m["source"] == "device_trace" or "mfu" in m["name"] or "roofline" in m["name"]}
SEED = 2**31 + 99


def rehearse(name, trace=False, tamper=None, seconds=1.5, reference=""):
    torch.manual_seed(0)
    cell = reduced_cell(name, reference)
    res = spec.driver(cell).run(cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                                tamper=tamper)
    return build_result(cell, res, trace, "cpu"), res


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearsal(name, trace):
    out, _ = rehearse(name, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert not DEVICE & set(out["metrics"]), "a CPU run reported a device metric"
    assert list(out)[-1] == "checks"
    cell = spec.find_cell(name)
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert wanted - DEVICE <= set(out["metrics"]) <= wanted


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_reaches_its_architecture_only_through_its_module(name, trace, monkeypatch):
    """The cell's config names a probe, which gives its architecture's
    functions and counts the calls; the architecture's own module raises
    if any file reaches it by name.  The run is as correct as the cell's."""
    base = spec.find_cell(name).reference
    pr = probe(base)
    monkeypatch.setitem(sys.modules, pr.__name__, pr)

    def by_name(fn_name):
        def fail(*args, **kwargs):
            raise AssertionError(f"{base.__name__}.{fn_name} reached by name")
        return fail
    for fn_name in spec.INTERFACE:
        monkeypatch.setattr(base, fn_name, by_name(fn_name))
    out, res = rehearse(name, trace, reference=pr.__name__.rsplit(".", 1)[1])
    assert out["correct"], out["checks"]
    assert res["obs"].reference is pr
    check = "forward_logits" if spec.find_cell(name).cell["driver"] == "serve" else "train_loss"
    assert {"tiny", "make_weights", check} <= set(pr.calls), pr.calls


def _altered_token(srv):
    decode = srv.decode_fn

    def fn(params, batch):
        out, caches = decode(params, batch)
        out = out.clone()
        V = srv.cfg.vocab_size
        out[0, (int(out[0, :V].argmax()) + V // 2) % V] = out.max() + 1.0
        return out, caches
    srv.decode_fn = fn


def _state_unchanged(srv):
    """The prefill hands back a session state it never filled: the
    session's cache stays as it was made, zeros."""
    prefill = srv.prefill_fn

    def fn(params, batch):
        logits, caches = prefill(params, batch)
        return logits, zeros(caches)
    srv.prefill_fn = fn


def _half_left_out(srv):
    prefill = srv.prefill_fn

    def fn(params, batch):
        toks = batch["tokens"]
        return prefill(params, dict(batch, tokens=toks[:, : toks.shape[1] // 2]))
    srv.prefill_fn = fn


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged, _half_left_out,
                                   one_replica_state_unchanged])
@pytest.mark.parametrize("name", SERVE)
def test_serving_faults_are_caught(name, fault):
    out, _ = rehearse(name, tamper=fault)
    assert not out["correct"], out["checks"]


def _train_state_unchanged(trainer):
    step = trainer.step_fn

    def fn(params, opt_state, batch):
        _, _, metrics = step(params, opt_state, batch)
        return params, opt_state, metrics
    trainer.step_fn = fn


def _train_half_batch(trainer):
    step = trainer.step_fn

    def fn(params, opt_state, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step(params, opt_state, half)
    trainer.step_fn = fn


@pytest.mark.parametrize("fault", [_train_state_unchanged, _train_half_batch])
@pytest.mark.parametrize("name", TRAIN)
def test_training_faults_are_caught(name, fault):
    out, _ = rehearse(name, tamper=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("clients,new_tokens", [(1, 3), (3, 2)])
def test_serving_longer_answers_and_more_clients(clients, new_tokens):
    """A mix with several answer tokens a request (each fed back as the next
    decode input) and several clients a round, as later cells may declare:
    still correct, every token counted."""
    cell = reduced_cell(SERVE[0])
    cell.traffic.update(new_tokens=new_tokens, clients=clients, max_asks=3)
    res = spec.driver(cell).run(cell, SEED, 1.5, False, "cpu", time.perf_counter())
    out = build_result(cell, res, False, "cpu")
    assert out["correct"] and out["failed"] == 0, out["checks"]
    reqs = res["obs"].requests
    assert all(r.tokens == new_tokens for r in reqs) and len(reqs) % clients == 0
