"""The port's named spans (``repro_torch.obs.spans``): the gate that keeps
them free with the profiler off, the serving and training phases as they
nest in a profiler trace, the shared clock of the profiler's regions and
the ``TraceBuffer``'s spans, and the server's and trainer's hooks (weights
passed in, a call a decoded token).  All on the CPU at reduced widths."""

import contextlib
import json
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import cache_init, init_params, make_decode_step
from repro_torch.obs import Observability
from repro_torch.obs import spans as spans_mod
from repro_torch.obs.spans import NULL_SPAN, span
from repro_torch.obs.trace import TraceBuffer
from repro_torch.runtime.serve_loop import DiffusionServer
from repro_torch.runtime.train_loop import TrainConfig, Trainer
from repro_torch.tree import tree_leaves

CFG = get_arch("internlm2-1.8b").reduced()
SERVE_KW = dict(dispatcher_impl="vectorized", batch_drain=True, cache_cap=48,
                max_replicas=2, min_replicas=2, seed=0, device="cpu")
NEW_TOKENS = 2


def regions(prof, tmp_path):
    """name -> [(tid, start_s, end_s)] of the trace's ``record_function``
    regions, on the wall clock (``ts`` plus ``baseTimeNanoseconds``)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    out = defaultdict(list)
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation":
            a = e["ts"] + base_us
            out[e["name"]].append((e["tid"], a / 1e6, (a + e["dur"]) / 1e6))
    return {k: sorted(v, key=lambda r: r[1]) for k, v in out.items()}


def inside(inner, outer):
    return inner[0] == outer[0] and outer[1] <= inner[1] and inner[2] <= outer[2]


def serve_stream(srv, rounds=2, sessions=3, name="s"):
    """Each round asks every session once (misses first, then hits), one
    drain epoch a round; returns the submitted requests."""
    rng = np.random.default_rng(len(name))
    prompts = {f"{name}{i}": rng.integers(0, CFG.vocab_size, size=(12 + 4 * i,))
               for i in range(sessions)}
    reqs = []
    for _ in range(rounds):
        reqs += [srv.submit(sid, p, max_new_tokens=NEW_TOKENS) for sid, p in prompts.items()]
        srv.step()
    return reqs


# ------------------------------------------------------------------ the gate
def test_span_is_the_shared_null_context_with_the_profiler_off():
    assert torch._C._len_torch_dispatch_stack() == 0
    assert isinstance(NULL_SPAN, contextlib.nullcontext)
    for name in ("serve.route", "model.decode", "attn_scores"):
        assert span(name) is NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("serve.route"), torch.profiler.record_function)
    assert span("serve.route") is NULL_SPAN


def test_no_region_is_opened_with_the_profiler_off(monkeypatch):
    """A decode step opens ``model.decode`` and ``attn_scores`` only under
    the profiler: off, ``record_function`` is never made."""
    made = []
    real = spans_mod.record_function
    monkeypatch.setattr(spans_mod, "record_function",
                        lambda name: made.append(name) or real(name))
    params = init_params(CFG, device="cpu", seed=0)
    batch = {"token": torch.tensor([3]), "pos": 5,
             "caches": cache_init(CFG, 1, 16, device="cpu")}
    decode = make_decode_step(CFG)
    decode(params, batch)
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        decode(params, batch)
    assert made[0] == "model.decode" and "attn_scores" in made


class _Enters(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._opname.startswith("_record_function_enter"):
            self.names.append(args[0])
        return func(*args, **(kwargs or {}))


def test_span_opens_its_region_under_a_dispatch_mode():
    """The cost model's counter reads regions as dispatched ops."""
    mode = _Enters()
    with mode:
        with span("attn_scores"):
            torch.ones(2) + 1
    assert mode.names == ["attn_scores"]


def test_span_records_in_the_trace_ring_without_a_region():
    ring = TraceBuffer()
    with span("serve.decode", ring, 7, "compute", "dispatch", "r0", (9,)):
        pass
    (s,) = ring.spans()
    assert (s["request_id"], s["name"], s["phase"], s["parent"], s["replica"],
            s["detail"]) == (7, "decode", "compute", "dispatch", "r0", [9])
    assert s["start_s"] <= s["end_s"]
    with span("serve.payload", ring, 7, "payload", "dispatch", "r0", ring="kv:a.b"):
        pass
    assert ring.spans()[-1]["name"] == "kv:a.b"


# -------------------------------------------------------------- the phases
def test_serving_phases_nest_in_the_profiler_trace(tmp_path, monkeypatch):
    srv = DiffusionServer(CFG, **SERVE_KW)
    serve_stream(srv, rounds=1, name="warm")
    st0 = dict(vars(srv.stats))
    waits = []
    wait = srv._wait_for_model
    monkeypatch.setattr(srv, "_wait_for_model", lambda: waits.append(1) or wait())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reqs = serve_stream(srv)
    r = regions(prof, tmp_path)
    st = {k: getattr(srv.stats, k) - st0[k] for k in ("served", "prefills", "decode_steps")}
    assert st["served"] == len(reqs) == 6 and st["prefills"] > 0
    assert "serve.payload" not in r                 # the modeled plane moves no bytes
    assert len(r["serve.score"]) == 4                # a rescore and a flush an epoch
    assert len(waits) == 4                           # the model's work done before each
    assert len(r["serve.route"]) >= len(reqs)        # each enqueue, and the completions
    assert len(r["serve.prefill"]) == len(r["serve.cache"]) == st["prefills"]
    for c in r["serve.cache"]:
        assert sum(inside(c, p) for p in r["serve.prefill"]) == 1
    assert len(r["serve.decode"]) == st["served"]
    assert len(r["model.decode"]) == st["decode_steps"] == NEW_TOKENS * len(reqs)
    for d in r["serve.decode"]:
        assert sum(inside(m, d) for m in r["model.decode"]) == NEW_TOKENS
    assert all(any(inside(a, m) for m in r["model.decode"] + r["serve.prefill"])
               for a in r["attn_scores"])


def test_training_phases_in_the_profiler_trace(tmp_path):
    tr = Trainer(CFG, ShapeConfig("t", "train", 32, 2),
                 TrainConfig(total_steps=2, log_every=100, checkpoint_every=100,
                             checkpoint_dir=str(tmp_path / "ckpt"), num_hosts=2),
                 device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run(start_fresh=True)
    r = regions(prof, tmp_path)
    assert len(r["train.grad"]) == len(r["train.optimizer"]) == 2
    for grad, opt in zip(r["train.grad"], r["train.optimizer"]):
        assert grad[2] <= opt[1]
        assert any(inside(a, grad) for a in r["attn_scores"])


def test_trace_ring_and_profiler_regions_share_one_clock(tmp_path):
    """The ring's ``prefill``/``decode`` spans lie within 1 ms of the
    ``serve.prefill``/``serve.decode`` regions of the same calls."""
    obs = Observability()
    srv = DiffusionServer(CFG, obs=obs, **SERVE_KW)
    serve_stream(srv, rounds=1, name="warm")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve_stream(srv)
    r = regions(prof, tmp_path)
    ring = defaultdict(list)
    for s in obs.trace.spans():
        if s["phase"] == "compute":
            ring[s["name"]].append((s["start_s"], s["end_s"]))
    for name in ("prefill", "decode"):
        regs = r["serve." + name]
        mine = ring[name][-len(regs):]
        assert len(regs) > 0 and len(mine) == len(regs)
        for (_, a, b), (c, d) in zip(regs, mine):
            assert abs(a - c) < 1e-3 and abs(b - d) < 1e-3, (name, a - c, b - d)


def test_swap_in_payload_span_in_the_ring_and_the_profiler_trace(tmp_path):
    """Under ``payload="real"`` each swap-in's KV bytes come back in
    ``serve.payload``; the ring holds the same span under the object's
    name and the "payload" phase, on the same clock."""
    obs = Observability()
    srv = DiffusionServer(CFG, obs=obs, device="cpu", payload="real", max_replicas=1,
                          min_replicas=1, cache_cap=48, max_sessions=2,
                          host_cache_sessions=4, seed=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve_stream(srv)
    r = regions(prof, tmp_path)
    ring = [s for s in obs.trace.spans() if s["phase"] == "payload"]
    assert srv.stats.swap_ins >= 1
    assert len(r["serve.payload"]) == len(ring) == srv.stats.swap_ins
    for (_, a, b), s in zip(r["serve.payload"], ring):
        assert s["name"].startswith("kv:") and s["parent"] == "dispatch"
        assert abs(a - s["start_s"]) < 1e-3 and abs(b - s["end_s"]) < 1e-3


# ---------------------------------------------------------------- the hooks
def test_server_takes_params_and_calls_on_token():
    """Weights passed in serve as the server's own draw of them does, and
    ``on_token`` hands out each decode step's request, input position and
    logits: the ones the server's ``decode_fn`` returned."""
    seen = {0: [], 1: []}
    made = []
    own = DiffusionServer(CFG, **dict(SERVE_KW, seed=5),
                          on_token=lambda *a: seen[0].append(a))
    given = DiffusionServer(CFG, **SERVE_KW, params=init_params(CFG, device="cpu", seed=5),
                            on_token=lambda *a: seen[1].append(a))
    decode = given.decode_fn

    def recorded(params, batch):
        out, caches = decode(params, batch)
        made.append((int(batch["pos"]), out))
        return out, caches
    given.decode_fn = recorded
    reqs = [serve_stream(s) for s in (own, given)]
    assert [q.request_id for q in reqs[1]] == [q.request_id for q in reqs[0]]
    assert len(seen[1]) == len(made) == NEW_TOKENS * len(reqs[1])
    for (rid, pos, lg), (rid0, pos0, lg0), (mpos, mlg) in zip(seen[1], seen[0], made):
        assert (rid, pos) == (rid0, pos0) == (rid, mpos)
        assert lg is mlg and torch.equal(lg, lg0)
    per_req = defaultdict(list)
    for rid, pos, _ in seen[1]:
        per_req[rid].append(pos)
    assert sorted(per_req) == sorted(q.request_id for q in reqs[1])
    assert all(p == list(range(p[0], p[0] + NEW_TOKENS)) for p in per_req.values())


def test_trainer_init_state_takes_params(tmp_path):
    shape = ShapeConfig("t", "train", 32, 2)

    def trainer(seed):
        return Trainer(CFG, shape, TrainConfig(seed=seed, num_hosts=2,
                                               checkpoint_dir=str(tmp_path)), device="cpu")
    own, given = trainer(5), trainer(0)
    p0, o0 = own.init_state()
    p1, o1 = given.init_state(params=init_params(CFG, device="cpu", seed=5))
    batch = own._batch_for(own.pipeline.next_batch()[0])
    (q0, _, m0), (q1, _, m1) = (t.step_fn(p, o, batch)
                                for t, p, o in ((own, p0, o0), (given, p1, o1)))
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(tree_leaves(q0), tree_leaves(q1)):
        assert torch.equal(a, b)
