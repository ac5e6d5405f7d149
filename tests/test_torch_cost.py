"""The port's cost model (``launch/op_analysis.py``, ``launch/dryrun.py``,
``launch/perf.py``) on its own units and against the reference's
``hlo_analysis``, ``dryrun`` and ``perf``.

Units (this process, plain CPU tensors): matmul flops by
``torch.utils.flop_counter``'s formulas, a loop counted once an iteration,
views free, an elementwise op's bytes its operands plus its output, the
peak of live storage with and without donation, a backward op under its
forward node's region.

Process-group checks run in processes of their own
(``tests/_torch_cost_jobs.py``; the reference in ``tests/_cost_reference.py``,
whose imports set ``XLA_FLAGS``), all started together: per-device counts on
a fake (2, 2) mesh; the region costs of reduced train and prefill cells
(a train step's region holds more than twice its forward's);
``model_flops`` and the kernel models equal to the reference's for all 33
cells on both meshes; every reduced cell through ``run_cell``; per-device
matmul flops against the reference's HLO count for eight reduced cells
(prefill and decode within 1%, train within 0.8-1.25: torch's
``checkpoint`` runs a checkpointed function whole again in backward, where
JAX recomputes only what backward reads, PERF.md §6); one full-size cell
on 256 fake ranks; the two command lines.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import op_analysis as oa

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
JOB_TIMEOUT = 900          # ~60 s alone; the jobs run side by side
CELL_PROCS = 3
HLO_TOL = {"prefill": (0.99, 1.01), "decode": (0.99, 1.01), "train": (0.8, 1.25)}


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
    procs["reference"] = subprocess.Popen(
        [sys.executable, str(TESTS / "_cost_reference.py"), str(tmp / "reference.json")],
        stdout=open(tmp / "reference.log", "w"), stderr=subprocess.STDOUT,
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


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-3b"])
def test_train_step_with_heads_that_do_not_divide_tp(jobs, arch):
    assert _job(jobs, "mesh")[f"tp8|{arch}"] is True


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


def test_dot_flops_against_the_reference_hlo(jobs):
    cells, ref = _cells(jobs), _job(jobs, "reference")["hlo_dot_flops"]
    assert len(ref) == 8
    for key, want in ref.items():
        kind = key.split("|")[1].split("_")[0]
        lo, hi = HLO_TOL[kind]
        ratio = cells[key]["hlo_analysis"]["dot_flops"] / want
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
