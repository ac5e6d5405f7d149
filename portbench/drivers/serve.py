"""Serving driver: the port's ``DiffusionServer`` under a closed loop of
clients, timed on the host clock, traced on request, and judged against
the plain reference.

Set-up makes the weights from the seed (the cell's architecture's
``make_weights``), hands them to the server in place of its own draw
(``DiffusionServer(params=)``), builds the kernels into the checkout's
``build/kernels``, and serves the stream's first
``warm_requests`` requests, which fill the session caches and run the
cell's shapes once.  The window then serves the stream on from there for
``seconds``: each client holds one request; a round submits one a client,
runs ``step()`` (one drain epoch: routing, the dispatch-score kernels, the
prefills and decode steps) and closes with ``torch.cuda.synchronize()``,
whose host clock is each request's finish.  With ``trace`` the last part of
the window runs under ``torch.profiler``.

Every decode step's position and a copy of its logits are kept as the
server's ``decode_fn`` receives and returns them (no synchronize).  After a
round, each request takes, in the order the server finished them
(``Request.finish_time_s``), the calls at the positions that follow its
session's sequence; so nothing of the server's inner loop is read.  After
the window, with the server freed, a sample of the served requests drawn
from the seed, the longest among them, has its session's whole token
sequence run once through the architecture's reference
(``forward_logits``), which covers every token served in that session,
and these numbers are read: the widest gap by which a
served token's reference logit lies below the reference's best
(``served_gap``); of the widest difference of a position's logits from
the reference's, over the reference's spread there, the median over the
served positions (``logit_err_p50``) and the share of them where it is
over one half (``logit_err_over_half``).  The median is steady where a
routing decision near a tie, which bf16 and float32 take differently,
moves a few positions far; the share fails a fault that reaches a tenth
of the positions, such as one replica's caches.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import spec as specmod
from ..trace import PROFILE_S, Trace

FAR = 0.5                       # a position's logit error over this is far off


@dataclass
class Lineage:
    """One session's token sequence on one replica, from its prefill on:
    the prefilled prompt, then one token a decode step."""
    prompt: np.ndarray
    decoded: List[int] = field(default_factory=list)

    @property
    def prefill(self) -> int:
        return len(self.prompt)

    def tokens(self, n: int) -> np.ndarray:
        return np.concatenate([self.prompt, np.asarray(self.decoded, np.int64)])[:n]


@dataclass
class Served:
    index: int
    submit: float
    finish: float = 0.0
    new_tokens: int = 1
    tokens: int = 0                      # decode steps it got
    hit: bool = False
    prefill_len: int = 0                 # 0 on a hit
    positions: List[int] = field(default_factory=list)
    lineage: Optional[Lineage] = None
    in_profile: bool = False
    failed: bool = False
    calls: List[Any] = field(default_factory=list)    # (position, logits)


@dataclass
class ServeObs:
    """What the metric readers read (``metrics/*.py``): ``reference`` is the
    architecture's module, which counts the operations of ``arch``."""
    arch: Dict[str, Any]
    reference: Any
    on_card: bool
    setup_s: float
    window_s: float
    requests: List[Served]
    counters: Dict[str, int]
    trace: Optional[Trace] = None
    profile_start: Optional[float] = None      # host clock, window-relative
    window_start: float = 0.0


def arch_config(config: Dict[str, Any]):
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(name=config["name"], source=config["source"], **config["arch"])


def build_server(config: Dict[str, Any], weights, seed: int, device):
    """The port's server over the benchmark's weights, in place of its own
    draw of params."""
    from repro_torch.runtime.serve_loop import DiffusionServer
    s = config["serve"]
    return DiffusionServer(
        arch_config(config), policy=s["policy"], max_replicas=s["replicas"],
        min_replicas=s["replicas"], cache_cap=s["cache_cap"],
        max_sessions=s["slots"], host_cache_sessions=s["host_cache_sessions"],
        eviction=s["eviction"], dispatcher_impl=s["dispatcher"],
        batch_drain=s["batch_drain"], seed=seed, device=str(device), params=weights)


def _counters(srv) -> Dict[str, int]:
    st = srv.stats
    return {"served": st.served, "prefix_hits": st.prefix_hits, "prefills": st.prefills,
            "decode_steps": st.decode_steps}


def run(cell: specmod.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False,
        tamper: Optional[Callable[[Any], None]] = None) -> Dict[str, Any]:
    """One run; returns the observation, the comparison and device facts.
    ``tamper(server)`` breaks the timed path for the harness's own tests."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    arch = cfg["arch"]
    vocab = arch["vocab_size"]
    if on_card:
        from repro_torch.kernels import _build
        _build.BUILD_DIR = specmod.ROOT / "build" / "kernels"
        _build.build()
    weights = cell.reference.make_weights(arch, seed, device)
    clock = {"weights": time.perf_counter()}
    srv = build_server(cfg, weights, seed, device)
    clock["server"] = time.perf_counter()
    if tamper is not None:
        tamper(srv)
    stream = specmod.traffic_kind(traffic).make(traffic, seed, vocab)

    made: List[Any] = []            # (position, logits) of each decode step
    decode_fn = srv.decode_fn

    def decode(params, batch):
        out, caches = decode_fn(params, batch)
        made.append((int(batch["pos"]), out.detach().clone()))
        return out, caches

    srv.decode_fn = decode
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    lineages: Dict[tuple, Lineage] = {}
    clients = int(traffic.get("clients", 1))

    def round_(records: List[Served], keep: bool):
        asks, reqs, served = [], [], []
        for _ in range(clients):
            ask = stream.next()
            s = Served(ask.index, time.perf_counter(), new_tokens=ask.new_tokens)
            reqs.append(srv.submit(ask.session, ask.prompt, ask.new_tokens))
            asks.append(ask)
            served.append(s)
        made.clear()
        srv.step()
        sync()
        now = time.perf_counter()
        # in the order the server finished them, each request takes the
        # decode steps at the positions that follow its session's sequence
        order = sorted(range(clients), key=lambda i: (reqs[i].finish_time_s is None,
                                                      reqs[i].finish_time_s or 0.0, i))
        at = 0
        for i in order:
            ask, req, s = asks[i], reqs[i], served[i]
            s.finish = now
            records.append(s)
            if req.finish_time_s is None:
                s.failed = True
                continue
            s.hit = bool(req.prefix_hit)
            key = (req.replica, ask.session)
            lin = lineages.get(key) if s.hit else None
            if lin is None:
                lin = Lineage(ask.prompt)
                lineages[key] = lin
                s.prefill_len = len(ask.prompt)
            start = lin.prefill + len(lin.decoded)
            calls = []
            while (at < len(made) and len(calls) < ask.new_tokens
                   and made[at][0] == start + len(calls)):
                calls.append(made[at])
                at += 1
            s.tokens = len(calls)
            s.failed = s.tokens < ask.new_tokens
            s.positions = [p for p, _ in calls]
            s.lineage = lin
            s.calls = calls if keep else []
            # the decode inputs: the ask's last token, then each served
            # token but the last (read back after the window)
            lin.decoded.append(int(ask.prompt[-1]) % vocab)
            if len(calls) > 1:
                lin.decoded.extend(int(torch.argmax(c[1][0]).item()) for c in calls[:-1])
        if at < len(made):          # decode steps that no request accounts for
            for s in served:
                s.failed = True
        made.clear()

    warm: List[Served] = []
    for _ in range(int(traffic["warm_requests"]) // clients):
        round_(warm, keep=False)
    base = _counters(srv)
    clock["warm"] = time.perf_counter()

    records: List[Served] = []
    gc.collect()
    gc.freeze()             # set-up's objects out of the collector's way
    prof = None
    prof_s = min(PROFILE_S, seconds / 2)
    t0 = time.perf_counter()
    deadline, prof_at = t0 + seconds, t0 + seconds - prof_s
    profile_start = None
    while time.perf_counter() < deadline:
        if trace and on_card and prof is None and time.perf_counter() >= prof_at:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            profile_start = time.perf_counter()
        n = len(records)
        round_(records, keep=True)
        for s in records[n:]:
            s.in_profile = prof is not None
    t_end = records[-1].finish if records else time.perf_counter()
    gc.unfreeze()
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
    counters = {k: v - base[k] for k, v in _counters(srv).items()}
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    if prof is not None:
        tr = Trace.from_profiler(prof, t_end - profile_start)
        del prof
    obs = ServeObs(arch, cell.reference, on_card, t0 - t_start, t_end - t0, records,
                   counters, tr, None if profile_start is None else profile_start - t0, t0)

    # the program's state goes before the reference runs
    srv.decode_fn = None
    del srv, decode_fn, lineages
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = compare(cell, weights, records, seed, control, device)
    notes = {"until_weights_s": clock["weights"] - t_start,
             "server_s": clock["server"] - clock["weights"],
             "warm_s": clock["warm"] - clock["server"],
             "reference_s": time.perf_counter() - t_ref}
    return {"obs": obs, "checks": checks, "peak": peak, "notes": notes}


def _sample(records: List[Served], seed: int, budget: int) -> List[Lineage]:
    """The sessions to check: that of the request with the longest sequence,
    then those of the served requests in an order drawn from the seed, each
    session once, while their tokens fit ``budget``.  One run of the
    reference over a session covers every token served in it, so a session
    asked often is drawn as often as its requests are."""
    reqs = [s for s in records if s.lineage is not None and s.positions]
    if not reqs:
        return []
    need: Dict[int, int] = {}
    for s in reqs:
        k = id(s.lineage)
        need[k] = max(need.get(k, 0), 1 + max(s.positions))
    first = max(reqs, key=lambda s: need[id(s.lineage)]).lineage
    rng = np.random.default_rng([int(seed), 3])
    chosen, total, seen = [first], need[id(first)], {id(first)}
    for i in rng.permutation(len(reqs)):
        lin = reqs[i].lineage
        k = id(lin)
        if k in seen or total + need[k] > budget:
            continue
        seen.add(k)
        chosen.append(lin)
        total += need[k]
    return chosen


def compare(cell, weights, records: List[Served], seed: int, control: bool, device):
    arch = cell.config["arch"]
    V = arch["vocab_size"]
    out: Dict[str, Any] = {"served_gap": 0.0, "logit_err_p50": 0.0,
                           "logit_err_over_half": 0.0, "compared": 0}
    errs: Dict[str, List[torch.Tensor]] = {"": [], "control_": []}
    if control:
        out["control_served_gap"] = 0.0
    chosen = _sample(records, seed, int(cell.traffic.get("check_tokens", 1 << 30)))
    for lin in chosen:
        mine = [s for s in records if s.lineage is lin]
        pos = sorted({p for s in mine for p in s.positions})
        prog = {p: lg for s in mine for p, lg in s.calls}
        n = pos[-1] + 1
        toks = torch.as_tensor(lin.tokens(n), device=device)
        segs = [lin.prefill] + [1] * (n - lin.prefill)
        r = cell.reference.forward_logits(weights, arch, toks, pos, segments=segs)
        p = torch.stack([prog[q][0, :V].to(torch.float32) for q in pos])
        for name, x in [("", p)] + ([("control_", cell.reference.forward_logits(
                weights, arch, toks, pos, segments=segs, precision="fp8"))]
                if control else []):
            gap = (r.max(-1).values - r.gather(1, x.argmax(-1, keepdim=True))[:, 0])
            errs[name].append((x - r).abs().max(-1).values / r.std(-1))
            out[name + "served_gap"] = max(out[name + "served_gap"], float(gap.max()))
        out["compared"] += len(pos)
    for name, e in errs.items():
        if e:
            e = torch.cat(e)
            out[name + "logit_err_p50"] = float(torch.quantile(e, 0.5))
            out[name + "logit_err_over_half"] = float((e > FAR).float().mean())
    out["sessions"] = len(chosen)
    return out
