"""The port's cost model (``launch/op_analysis.py``, ``launch/dryrun.py``,
``launch/perf.py``) on its own units and against the reference's
``hlo_analysis``, ``dryrun`` and ``perf``.

Units (this process, plain CPU tensors): matmul flops by
``torch.utils.flop_counter``'s formulas, a loop counted once an iteration,
views free, an elementwise op's bytes its operands plus its output, the
peak of live storage with and without donation, a backward op under its
forward node's region.  Marked loops (``repro_torch.trips.scan``): counted
by their trip count (the reference's ``4 * 2 * 128**3``), forward and
backward as the loop run step by step, ``wkv_chunked``'s two nested loops
with the chunk recompute too; outside a trace every step runs and the
values, the models' train steps and prefills included, are bit for bit
those of the loops written out.

Process-group checks run in processes of their own
(``tests/_torch_cost_jobs.py``; the reference in ``tests/_cost_reference.py``,
whose imports set ``XLA_FLAGS``), all started together: per-device counts on
a fake (2, 2) mesh; reduced rwkv6 and recurrentgemma x train_4k and x
prefill_32k traced with trip counts against every step run (matmul flops
and collective bytes equal, the rest within 1%, the peak within 5%, totals
and regions); the region costs of reduced train and prefill cells
(a train step's region holds more than twice its forward's);
``model_flops`` and the kernel models equal to the reference's for all 33
cells on both meshes; every reduced cell through ``run_cell``; per-device
matmul flops of the ``attn_scores`` region against the reference's HLO
region count where the query heads do not divide over 'model' (reduced
internlm2, (1, 8) mesh, prefill and train); per-device
matmul flops against the reference's HLO count for every one of the 33
reduced cells, one case a cell, within 1%; one full-size cell on 256 fake
ranks; the two command lines.  A checkpointed chunk's recompute runs only
what its backward reads, as XLA's rematerialization does: a toy chunk of
two products, attention's chunked online softmax and the WKV6 chunks.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch import trips
from repro_torch.launch import op_analysis as oa

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
JOB_TIMEOUT = 900          # ~60 s alone; the jobs run side by side
CELL_PROCS = 3
REF_PROCS = 2
TRIP_ARCHS = ("rwkv6-3b", "recurrentgemma-9b")
TRIP_SHAPES = ("train_4k", "prefill_32k")
HLO_TOL = {"prefill": (0.99, 1.01), "decode": (0.99, 1.01), "train": (0.99, 1.01)}


# ------------------------------------------------------------------ units
def test_matmul_flops_by_formula():
    x, w = torch.randn(8, 16), torch.randn(16, 4)
    a, b = torch.randn(3, 8, 16), torch.randn(3, 16, 4)
    assert oa.analyze_step(torch.mm, x, w).dot_flops == 2 * 8 * 16 * 4
    assert oa.analyze_step(torch.bmm, a, b).dot_flops == 3 * 2 * 8 * 16 * 4
    s = oa.analyze_step(lambda p, q: torch.einsum("bij,bjk->bik", p, q), a, b)
    assert s.dot_flops == 3 * 2 * 8 * 16 * 4
    assert s.flops >= s.dot_flops


def test_loop_counts_every_iteration():
    def four(x, w):
        for _ in range(4):
            x = x @ w
        return x

    x = torch.randn(32, 32)
    assert oa.analyze_step(four, x, x).dot_flops == 4 * 2 * 32 ** 3


def test_marked_loop_counts_by_trip_count():
    def four(x, w):
        def body(_, c):
            c = c @ w
            return c, c
        return trips.scan(4, body, x)[0]

    x = torch.zeros(128, 128)
    w = torch.zeros(128, 128)
    tr = oa.trace_step(four, x, w)
    assert tr.total.dot_flops == 4 * 2 * 128 ** 3          # the reference's count
    full = oa.trace_step(four, x, w, trip_counts=False)
    assert full.total.dot_flops == tr.total.dot_flops


def _toy(marked):
    """h_t = tanh(h_{t-1} @ w + x_t) over x's steps, stacked; the grads of
    the sum of squares under ``enable_grad``."""
    def fn(x, w, h0):
        def step(_, h, x_t):
            h = torch.tanh(h @ w + x_t)
            return h, h

        with torch.enable_grad():
            if marked:
                _, ys = trips.scan(x.shape[1], step, h0, (x,))
            else:
                h, out = h0, []
                for x_t in x.unbind(1):
                    h, y = step(0, h, x_t)
                    out.append(y)
                ys = torch.stack(out, 1)
            return torch.autograd.grad((ys * ys).sum(), (x, w))
    return fn


def _same_costs(a, b, rel=0.0):
    for k in ("flops", "dot_flops", "bytes", "transcendentals"):
        va, vb = getattr(a, k), getattr(b, k)
        assert abs(va - vb) <= rel * abs(vb), (k, va, vb)


def test_marked_loop_counts_as_the_loop_run_step_by_step():
    from torch.profiler import record_function

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 16, generator=g, requires_grad=True)
    w = torch.randn(16, 16, generator=g, requires_grad=True)
    h0 = torch.zeros(2, 16)

    def in_region(fn):
        def run(*a):
            with record_function("rglru_rec"):
                return fn(*a)
        return run

    plain = oa.trace_step(_toy(False), x, w, h0, regions=["rglru_rec"])
    for marked in (_toy(True), in_region(_toy(True))):
        tr = oa.trace_step(marked, x, w, h0, regions=["rglru_rec"])
        _same_costs(tr.total, plain.total)
        # forward and dw 8 steps each, dh 7 (h0 needs no grad)
        assert tr.total.dot_flops == 23 * 2 * 2 * 16 * 16
    assert tr.regions["rglru_rec"].dot_flops == plain.total.dot_flops
    # run every step: the counts of the loop written out
    _same_costs(oa.trace_step(_toy(True), x, w, h0, trip_counts=False).total, plain.total)
    assert trips._hook is None


def _wkv_inputs(T, seed=0):
    g = torch.Generator().manual_seed(seed)
    B, H, N = 2, 2, 8
    r, k, v = (torch.randn(B, T, H, N, generator=g, requires_grad=True) for _ in range(3))
    w = torch.rand(B, T, H, N, generator=g).requires_grad_(True)
    u = torch.randn(H, N, generator=g, requires_grad=True)
    return r, k, v, w, u, torch.zeros(B, H, N, N)


@pytest.mark.parametrize("final_state", [True, False])
def test_wkv_chunked_nests_trip_counts_with_the_recompute(final_state):
    """8 chunks of 4 steps, each chunk recomputed in backward: the chunk
    loop's counted chunk holds the step loop's counted step."""
    from repro_torch.models.rwkv import wkv_chunked

    def step(*a):
        with torch.enable_grad():
            out, S = wkv_chunked(*a, chunk=4)
            loss = (out * out).sum() + (S.sum() if final_state else 0)
            return torch.autograd.grad(loss, a[:5])

    args = _wkv_inputs(32)
    tr = oa.trace_step(step, *args, regions=["wkv_scan"])
    full = oa.trace_step(step, *args, regions=["wkv_scan"], trip_counts=False)
    assert tr.total.dot_flops == full.total.dot_flops
    # with the final state unused the last step's decay has no grad: the
    # split's backward fills its slice with zeros, the unbind's a scalar
    _same_costs(tr.total, full.total, rel=0 if final_state else 1e-3)
    _same_costs(tr.regions["wkv_scan"], full.regions["wkv_scan"],
                rel=0 if final_state else 1e-3)
    peak, want = tr.memory["peak_device_bytes"], full.memory["peak_device_bytes"]
    assert abs(peak - want) <= 0.05 * want, (peak, want)
    assert tr.ops < full.ops / 2


def test_recompute_runs_only_what_backward_reads():
    """A checkpointed chunk ``tanh(x @ w1) @ w2``, forward and backward:
    backward reads x, w1, the tanh and w2, never the last product, so the
    recompute stops before it (torch's early stop; XLA drops it from the
    reference's rematerialized chunk): 2 products forward, 1 recomputed,
    4 in backward."""
    from torch.utils.checkpoint import checkpoint

    g = torch.Generator().manual_seed(0)
    x, w1, w2 = (torch.randn(16, 16, generator=g, requires_grad=True) for _ in range(3))

    def step(x, w1, w2):
        with torch.enable_grad():
            y = checkpoint(lambda x, w1, w2: torch.tanh(x @ w1) @ w2, x, w1, w2,
                           use_reentrant=False)
            return torch.autograd.grad((y * y).sum(), (x, w1, w2))

    assert oa.analyze_step(step, x, w1, w2).dot_flops == 7 * 2 * 16 ** 3


def test_attention_chunk_recompute_skips_the_output_product():
    """``attention_core``'s chunked online softmax under grad: each chunk's
    two products forward, its scores again in the recompute (not its P.V,
    which backward never reads), four products in backward."""
    from repro_torch.models.layers import attention_core

    g = torch.Generator().manual_seed(1)
    B, S, H, Dh, chunk = 1, 64, 2, 8, 16
    q, k, v = (torch.randn(B, S, H, Dh, generator=g, requires_grad=True) for _ in range(3))
    pos = torch.arange(S)

    def step(q, k, v):
        with torch.enable_grad():
            o = attention_core(q, k, v, pos, pos, chunk=chunk)
            return torch.autograd.grad(o.float().square().sum(), (q, k, v))

    one = 2 * B * H * S * chunk * Dh             # one product of one chunk
    assert oa.analyze_step(step, q, k, v).dot_flops == (2 + 1 + 4) * (S // chunk) * one


def test_wkv_chunk_recompute_skips_the_reads():
    """``wkv_chunked`` under grad: each step's read of its state once
    forward and once in backward (the grad of r; the state's is an outer
    product, a broadcast multiply); the chunk's recompute skips the reads,
    whose output backward does not read.  The grads are those of the
    reads run in the recompute too."""
    from repro_torch.models import rwkv

    args = _wkv_inputs(32)
    B, T, H, N = args[0].shape

    def step(*a):
        with torch.enable_grad():
            out, S = rwkv.wkv_chunked(*a, chunk=4)
            return torch.autograd.grad((out * out).sum() + S.sum(), a[:5])

    tr = oa.trace_step(step, *args, regions=["wkv_scan"])
    assert tr.regions["wkv_scan"].dot_flops == 2 * T * 2 * B * H * N * N
    assert not getattr(rwkv._recomputing, "on", False)
    with torch.enable_grad():
        out, S = _wkv_chunked_plain(*args, chunk=4)
        want = torch.autograd.grad((out * out).sum() + S.sum(), args[:5])
    _equal(step(*args), want)


def _wkv_scan_plain(r, k, v, w, u, s0):
    S = s0.float()
    u4 = u[None, :, :, None]
    outs = []
    for r_t, k_t, v_t, w_t in zip(*(a.float().unbind(1) for a in (r, k, v, w))):
        kv = k_t[..., :, None] * v_t[..., None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, S + u4 * kv))
        S = w_t[..., :, None] * S + kv
    return torch.stack(outs, 1), S


def _wkv_chunked_plain(r, k, v, w, u, s0, chunk=128, ctx=None):
    from torch.utils.checkpoint import checkpoint

    T = r.shape[1]
    chunk = min(chunk, T)
    S, outs = s0.float(), []
    for start in range(0, T, chunk):
        xs = tuple(a[:, start:start + chunk] for a in (r, k, v, w))
        if torch.is_grad_enabled():
            out, S = checkpoint(_wkv_scan_plain, *xs, u, S, use_reentrant=False)
        else:
            out, S = _wkv_scan_plain(*xs, u, S)
        outs.append(out)
    return torch.cat(outs, 1), S


def _rglru_scan_plain(xi, r, i_gate, lam, h0):
    log_a = (-8.0 * F.softplus(lam))[None, None, :] * r.float()
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * (i_gate.float() * xi.float())
    h, ys = h0.float(), []
    for a_t, g_t in zip(a.unbind(1), gated.unbind(1)):
        h = a_t * h + g_t
        ys.append(h)
    return torch.stack(ys, 1), h


def _rglru_ref_plain(a, b, h0=None):
    h = torch.zeros(a.shape[0], a.shape[2]) if h0 is None else h0.float()
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        ys.append(h)
    return torch.stack(ys, 1), h


def _wkv6_ref_plain(r, k, v, w, u, s0=None):
    B, T, H, N = r.shape
    S = torch.zeros((B, H, N, N)) if s0 is None else s0.float()
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(outs, 1), S


def _equal(a, b):
    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_marked_loops_run_every_step_outside_a_trace():
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref
    from repro_torch.models.rglru import rglru_scan
    from repro_torch.models.rwkv import wkv_chunked, wkv_scan

    args = _wkv_inputs(24, seed=3)
    for marked, plain, kw in ((wkv_scan, _wkv_scan_plain, {}),
                              (wkv_chunked, _wkv_chunked_plain, {"chunk": 8})):
        with torch.no_grad():
            _equal(marked(*args, **kw), plain(*args, **kw))
        with torch.enable_grad():
            got = torch.autograd.grad(sum(t.sum() for t in marked(*args, **kw)), args[:5])
            want = torch.autograd.grad(sum(t.sum() for t in plain(*args, **kw)), args[:5])
        _equal(got, want)
    _equal(wkv6_ref(*args), _wkv6_ref_plain(*args))
    g = torch.Generator().manual_seed(4)
    xi, rg, ig = (torch.randn(2, 24, 16, generator=g, requires_grad=True) for _ in range(3))
    lam, h0 = torch.randn(16, generator=g, requires_grad=True), torch.randn(2, 16, generator=g)

    def gate(scan):
        return scan(xi, torch.sigmoid(rg), torch.sigmoid(ig), lam, h0)

    _equal(gate(rglru_scan), gate(_rglru_scan_plain))
    with torch.enable_grad():
        got, want = (torch.autograd.grad(gate(scan)[0].square().sum(), (xi, rg, ig, lam))
                     for scan in (rglru_scan, _rglru_scan_plain))
    _equal(got, want)
    a, b = torch.rand(2, 24, 16, generator=g), torch.randn(2, 24, 16, generator=g)
    _equal(rglru_ref(a, b, h0), _rglru_ref_plain(a, b, h0))
    assert trips._hook is None


@pytest.mark.parametrize("arch", TRIP_ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_models_bit_equal_to_the_loops_written_out(arch, kind, monkeypatch):
    """A reduced train step (loss, grads, AdamW) and prefill on the CPU with
    the marked loops, then with the loops written out in their place."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.rglru_scan import ref as rg_ref
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.models import (init_opt_state, init_params, make_prefill_step,
                                    make_train_step, rglru, rwkv, synth_inputs)

    cfg = get_arch(arch).reduced()
    shape = ShapeConfig(kind, kind, 32, 2)

    def run():
        params = init_params(cfg, device="cpu", seed=0)
        batch = synth_inputs(cfg, shape, device="cpu")
        if kind == "train":
            return make_train_step(cfg, shape)(params, init_opt_state(params, cfg), batch)
        with torch.no_grad():
            return make_prefill_step(cfg, shape)(params, batch)

    marked = run()
    monkeypatch.setattr(rwkv, "wkv_scan", _wkv_scan_plain)
    monkeypatch.setattr(rwkv, "wkv_chunked", _wkv_chunked_plain)
    monkeypatch.setattr(rglru, "rglru_scan", _rglru_scan_plain)
    monkeypatch.setattr(wkv_ops, "wkv6_ref", _wkv6_ref_plain)
    monkeypatch.setattr(rg_ref, "rglru_ref", _rglru_ref_plain)
    _equal(marked, run())


def test_views_move_no_bytes():
    x = torch.randn(8, 16)

    def views(x):
        return (x.view(16, 8), x.reshape(4, 32), x.t(), x.transpose(0, 1),
                x[None].expand(3, 8, 16), x[2:], x.detach(), x.unsqueeze(0),
                x.as_strided((4, 4), (16, 1)))

    s = oa.analyze_step(views, x)
    assert (s.bytes, s.flops, s.dot_flops) == (0, 0, 0)


def test_elementwise_bytes_are_operands_plus_output():
    x, y = torch.randn(8, 16), torch.randn(8, 16)
    s = oa.analyze_step(torch.add, x, y)
    assert s.bytes == 3 * 8 * 16 * 4
    assert s.flops == 8 * 16 and s.dot_flops == 0
    e = oa.analyze_step(torch.exp, x)
    assert e.transcendentals == 8 * 16 and e.bytes == 2 * 8 * 16 * 4
    # a cast reads f32 and writes bf16; a copy onto itself moves nothing
    assert oa.analyze_step(lambda t: t.to(torch.bfloat16), x).bytes == 8 * 16 * 6
    assert oa.analyze_step(lambda t: t.copy_(t), x).bytes == 0


def test_peak_memory_and_donation():
    n = 1024

    def step(x):
        t = x * 2                       # n floats, dropped
        del t
        return x + 1                    # n floats, the output

    x = torch.zeros(n)
    mem = oa.trace_step(step, x).memory
    assert mem["argument_bytes"] == 4 * n and mem["output_bytes"] == 4 * n
    assert mem["peak_device_bytes"] == 8 * n and mem["alias_bytes"] == 0
    # donated: the output takes the argument's storage (XLA's aliasing)
    don = oa.trace_step(step, x, donate=(0,)).memory
    assert don["alias_bytes"] == 4 * n and don["peak_device_bytes"] == 8 * n
    assert don["eager_peak_bytes"] == 8 * n
    keep = oa.trace_step(lambda x: [x * 2, x * 3], x, donate=(0,)).memory
    assert keep["eager_peak_bytes"] == 12 * n and keep["peak_device_bytes"] == 8 * n
    assert (keep["argument_bytes"] + keep["output_bytes"] + keep["temp_bytes"]
            - keep["alias_bytes"]) == keep["peak_device_bytes"]


def test_backward_ops_go_to_their_forward_region():
    from torch.profiler import record_function

    x = torch.randn(16, 32, requires_grad=True)
    w = torch.randn(32, 8, requires_grad=True)

    def step(x, w):
        with torch.enable_grad():
            with record_function("attn_scores"):
                y = x @ w
            loss = (y * y).sum()
            return torch.autograd.grad(loss, (x, w))

    r = oa.region_costs(step, (x, w), ["attn_scores"])
    one = 2 * 16 * 32 * 8
    assert r["attn_scores"].dot_flops == 3 * one       # forward + dx + dw
    assert r["other"].dot_flops == 0 and r["other"].flops > 0
    top = oa.traffic_breakdown(step, (x, w), top=3)
    assert len(top) == 3 and all(b > 0 and n >= 1 for _, b, n in top)


# ------------------------------------------------------------ process jobs
def _job_args():
    jobs = {"mesh": ["mesh"], "regions": ["regions"], "cli": ["cli"]}
    for arch in TRIP_ARCHS:
        jobs[f"trips|{arch}"] = ["trips", arch]
    for i in range(CELL_PROCS):
        jobs[f"cells{i}"] = ["cells", str(i), str(CELL_PROCS)]
    return jobs


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cost")
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = {}
    for name, argv in _job_args().items():
        cmd = [sys.executable, str(TESTS / "_torch_cost_jobs.py"), argv[0],
               str(tmp / f"{name}.json"), *argv[1:]]
        procs[name] = subprocess.Popen(cmd, stdout=open(tmp / f"{name}.log", "w"),
                                       stderr=subprocess.STDOUT, env=env)
    for i in range(REF_PROCS):
        procs[f"reference{i}"] = subprocess.Popen(
            [sys.executable, str(TESTS / "_cost_reference.py"),
             str(tmp / f"reference{i}.json"), str(i), str(REF_PROCS)],
            stdout=open(tmp / f"reference{i}.log", "w"), stderr=subprocess.STDOUT,
            env={**env, "JAX_PLATFORMS": "cpu"})
    out = {}
    try:
        for name, p in procs.items():
            p.wait(timeout=JOB_TIMEOUT)
            log = (tmp / f"{name}.log").read_text()[-3000:]
            out[name] = (json.loads((tmp / f"{name}.json").read_text())
                         if p.returncode == 0 else f"rc {p.returncode}\n{log}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    parts = [out.pop(f"reference{i}") for i in range(REF_PROCS)]
    out["reference"] = next((p for p in parts if not isinstance(p, dict)), None) or {
        **parts[0], "hlo_dot_flops": {k: v for p in parts for k, v in p["hlo_dot_flops"].items()}}
    return out


def _job(jobs, name):
    res = jobs[name]
    assert isinstance(res, dict), res
    return res


def _cells(jobs):
    out = {}
    for i in range(CELL_PROCS):
        out.update(_job(jobs, f"cells{i}"))
    return out


def test_import_leaves_environment_and_process_group(jobs):
    m = _job(jobs, "mesh")
    assert m["import_env_same"]
    assert m["import_initialized"] == [False, False]
    assert not m["jax_imported"]


def test_sharded_matmuls_count_per_device(jobs):
    m = _job(jobs, "mesh")
    glob = 2 * 64 * 32 * 48
    local = glob / 4
    # the same DTensor matmul twice, first in a fresh process: twice one
    # local count (the shape inference on the cache miss is not counted)
    assert m["twice"]["dot_flops"] == 2 * local
    assert m["both_sharded"]["dot_flops"] == local
    assert m["replicated"]["dot_flops"] == glob
    for s in ("twice", "both_sharded", "replicated"):
        assert not m[s]["collective_count"], s


def test_contracting_dim_sharding_issues_a_reduction(jobs):
    m = _job(jobs, "mesh")
    c = m["contracting"]
    assert m["contracting"]["dot_flops"] == 2 * 64 * 16 * 48
    kinds = set(c["collective_count"])
    assert kinds and kinds <= {"all-reduce", "reduce-scatter"}, kinds
    assert c["collective_bytes"][kinds.pop()] == m["contracting_partial_bytes"]
    assert m["contracting_axes"] == {"model": m["contracting_partial_bytes"]}


def test_shard_to_shard_counts_one_all_to_all(jobs):
    s = _job(jobs, "mesh")["shard_to_shard"]
    assert s["collective_count"] == {"all-to-all": 1}
    assert s["collective_bytes"] == {
        "all-to-all": _job(jobs, "mesh")["shard_to_shard_local_bytes"]}
    assert set(s["collective_axis_bytes"]) == {"model"}


def test_label_pick_backward_stays_local(jobs):
    m = _job(jobs, "mesh")
    local = m["pick_global_bytes"] // 2        # the batch is split over 'data'
    # DTensor's own gather backward builds the global logits' zeros on a
    # rank; the local pick builds its own rows' only
    assert m["pick_temp_gather"] >= m["pick_global_bytes"]
    assert (m["pick_temp_gather"] - m["pick_temp_gather_last"]
            >= m["pick_global_bytes"] - local)


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_attention_flops_with_heads_that_do_not_divide_tp(jobs, shape):
    """Reduced internlm2's 4 query heads on a (1, 8) mesh: each rank runs
    attention on its own S / 8 query rows, as the reference lays it out, so
    the ``attn_scores`` region's per-device matmul flops match the
    reference's HLO region count (a rank that gathered the whole query
    would count 8 times as many)."""
    got = _job(jobs, "mesh")[f"tp8|{shape}"]
    want = _job(jobs, "reference")["tp8_attn_dot_flops"][f"internlm2-1.8b|{shape}"]
    lo, hi = HLO_TOL[shape.split("_")[0]]
    assert want > 0 and lo <= got / want <= hi, (got, want, got / want)


def test_decode_attention_with_heads_that_do_not_divide_tp(jobs):
    """Reduced internlm2 x decode_32k on a (1, 8) mesh, 4 heads over 8:
    each rank attends its own cap / 8 cache slots, so the ``attn_scores``
    region holds an eighth of one device's matmul flops (a rank that
    gathered the caches would hold all of them), and the step's total
    lies within 0.9-1.0 of the reference's HLO count (106,496 against
    114,688)."""
    m = _job(jobs, "mesh")
    one, got = m["decode|1x1|attn"], m["decode|1x8|attn"]
    assert one > 0 and got * 8 == one, (got, one)
    want = _job(jobs, "reference")["tp8_decode_dot_flops"]
    assert 0.9 <= m["decode|1x8|total"] / want <= 1.0, (m["decode|1x8|total"], want)


@pytest.mark.parametrize("arch,region", [
    ("internlm2-1.8b", "attn_scores"), ("rwkv6-3b", "wkv_scan"),
    ("recurrentgemma-9b", "rglru_rec")])
def test_regions_hold_their_costs_backward_included(jobs, arch, region):
    r = _job(jobs, "regions")
    train, fwd, prefill = (r[f"{arch}|{k}"][region]
                           for k in ("train_4k", "forward", "prefill_32k"))
    assert r[f"{arch}|train_4k"]["other"]["flops"] > 0
    assert prefill["flops"] > 0 and fwd["flops"] > 0
    # the step's backward ops (and a checkpointed chunk's recompute) land in
    # the region of the forward that made them
    assert train["flops"] > 2 * fwd["flops"], (train, fwd)
    if region != "rglru_rec":
        # the serve route marks the same products; the RG-LRU's serve region
        # is the gated kernel, gates included, and has no matmul
        assert train["dot_flops"] > prefill["dot_flops"] > 0


@pytest.mark.parametrize("arch", TRIP_ARCHS)
@pytest.mark.parametrize("shape", TRIP_SHAPES)
def test_trip_counts_match_every_step_on_a_fake_mesh(jobs, arch, shape):
    """Reduced cells on a fake (2, 2) mesh: the loops over time counted by
    their trip counts against every step run.  Matmul flops and collective
    bytes by kind and axis equal; flops, transcendentals and bytes within
    1% (the last step's decay, whose grad is unused, gets a zero slice
    where the unbind broadcast a scalar); the peak within 5%; the same
    for each region; far fewer ops run."""
    res = _job(jobs, f"trips|{arch}")
    tr, full = res[f"{shape}|trips"], res[f"{shape}|every step"]
    for got, want in [(tr["total"], full["total"])] + [
            (tr["regions"][r], full["regions"][r]) for r in full["regions"]]:
        assert got["dot_flops"] == want["dot_flops"]
        for k in ("collective_bytes", "collective_axis_bytes", "collective_count"):
            assert got[k] == want[k], k
        for k in ("flops", "transcendentals", "bytes"):
            assert abs(got[k] - want[k]) <= 0.01 * want[k], (k, got[k], want[k])
    peak, want = (x["memory"]["peak_device_bytes"] for x in (tr, full))
    assert abs(peak - want) <= 0.05 * want, (peak, want)
    region = "wkv_scan" if arch == "rwkv6-3b" else "rglru_rec"
    assert tr["regions"][region]["flops"] > 0
    assert tr["ops"] < full["ops"]


def test_model_flops_and_kernel_models_equal_the_reference(jobs):
    from repro_torch.configs import SHAPES, all_archs, cells
    from repro_torch.launch.dryrun import model_flops
    from repro_torch.launch.perf import (
        flash_kernel_model,
        rglru_kernel_model,
        wkv_kernel_model,
    )

    ref = _job(jobs, "reference")["models"]
    seen = 0
    for name, cfg in all_archs().items():
        for s in cells(cfg):
            shape = SHAPES[s.name]
            for n_dev, mesh_shape in ((256, (16, 16)), (512, (2, 16, 16))):
                want = ref[f"{name}|{s.name}|{n_dev}"]
                assert model_flops(cfg, shape) == want["model_flops"]
                assert flash_kernel_model(cfg, shape, n_dev, mesh_shape) == want["flash"]
                assert wkv_kernel_model(cfg, shape, n_dev) == want["wkv"]
                assert rglru_kernel_model(cfg, shape, n_dev) == want["rglru"]
                seen += 1
    assert seen == len(ref) == 66


def test_every_reduced_cell_runs_on_a_fake_2x2_mesh(jobs):
    cells = _cells(jobs)
    assert len(cells) == 33
    bad = {k: v.get("error") for k, v in cells.items() if not v["ok"]}
    assert not bad, bad
    for k, v in cells.items():
        assert v["devices"] == 4 and v["mesh"] == "2x2", k
        assert v["hlo_analysis"]["dot_flops"] > 0, k
        assert v["memory"]["peak_device_bytes"] > 0, k
        assert v["dominant_term"] in v["roofline_terms_s"], k


def _reduced_cells():
    from repro_torch.configs import all_archs, cells

    return [f"{a}|{s.name}" for a, c in all_archs().items() for s in cells(c)]


@pytest.mark.parametrize("key", _reduced_cells())
def test_dot_flops_against_the_reference_hlo(jobs, key):
    """Each reduced cell's per-device matmul flops on a fake (2, 2) mesh
    against the reference's compiled step's on 4 host devices: 33 cells,
    13 of them decode, all within 1%."""
    from repro_torch.configs import SHAPES

    ref = _job(jobs, "reference")["hlo_dot_flops"]
    assert sorted(ref) == sorted(_reduced_cells())
    assert len(ref) == 33 and sum(SHAPES[k.split("|")[1]].kind == "decode" for k in ref) == 13
    lo, hi = HLO_TOL[SHAPES[key.split("|")[1]].kind]
    ratio = _cells(jobs)[key]["hlo_analysis"]["dot_flops"] / ref[key]
    assert lo <= ratio <= hi, (key, ratio)


def test_full_size_cell_on_256_fake_ranks(jobs):
    r = _job(jobs, "cli")["first"]
    assert r["ok"] and r["devices"] == 256 and r["mesh"] == "16x16"
    assert 0 < r["memory"]["peak_device_bytes"] < 80e9
    assert r["hlo_analysis"]["total_collective_bytes"] > 0
    assert r["model_flops_per_device"] == r["model_flops_global"] / 256


def test_command_lines(jobs):
    c = _job(jobs, "cli")
    assert set(c["first"]) >= {
        "arch", "shape", "mesh", "devices", "ok", "trace_s", "memory", "hlo_analysis",
        "model_flops_global", "model_flops_per_device", "useful_flops_ratio",
        "roofline_terms_s", "dominant_term", "step_time_bound_s", "params",
        "active_params"}
    assert set(c["first"]["memory"]) >= {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "peak_device_bytes", "peak_device_gib"}
    assert set(c["first"]["roofline_terms_s"]) == {"compute_s", "memory_s", "collective_s"}
    assert c["skipped"]
    assert c["raised"] and c["failed"]["ok"] is False and "no-such-arch" in c["failed"]["error"]
    assert set(c["perf"]) >= {
        "baseline_terms", "kernelized_terms", "region_bytes", "region_flops",
        "model_flops_per_device", "roofline_fraction_baseline",
        "roofline_fraction_kernelized", "breakdown", "collectives", "peak_gib"}
    assert c["perf"]["kernelized_terms"]["memory_s"] < c["perf"]["baseline_terms"]["memory_s"]
