"""The cost model's checks that need a process group, each job in a process
of its own (a fake group is the default group of the process that starts
it), for ``test_torch_cost.py``.  No JAX.

    python tests/_torch_cost_jobs.py <job> <out.json> [<job's arguments>]

Jobs:
``mesh``: importing the three modules changes neither the environment nor
``torch.distributed``; then, on a fake (2, 2) mesh, the same DTensor matmul
twice in this fresh process (the sharding propagator's shape-inference op
on its cache miss must not count), a matmul sharded on both operands, a
replicated one, one sharded on the contracting dim (a reduction
collective) and a Shard(0) -> Shard(1) move (one all-to-all); the loss's
label pick on batch-sharded logits, backward included; the matmul flops
of the ``attn_scores`` region of reduced internlm2 x ``TP8_SHAPES`` on a
(1, 8) mesh, whose 4 heads do not divide over its 'model' axis, and of
its ``decode_32k`` step there (the region's and the whole step's) and on
one device (the region's).
``cells <i> <n>``: ``run_cell`` on every n-th reduced cell from the i-th,
on a fake (2, 2) mesh.
``regions``: the region costs of reduced internlm2, rwkv6 and
recurrentgemma on a fake (2, 2) mesh: the train step, prefill, and the
train route's forward alone (the loss under ``no_grad``).
``trips <arch>``: the arch's reduced train_4k and prefill_32k cells on a
fake (2, 2) mesh, traced with trip counts and with every step run: totals,
regions and memory of both.
``depth <arch> <shape> <layers,...>``: a full-size cell cut to each depth
on both production meshes (16 x 16 and 2 x 16 x 16 fake ranks), traced
with trip counts, the first depth also with every step run: totals, ops,
trace seconds and memory.  Not a test's job: the dry run's peaks by depth
(rwkv6-3b prefill_32k 1,2,4 takes ~16 min, the every-step traces
nearly all of it).
``cli``: ``python -m repro_torch.launch.dryrun``'s ``main`` at full size
(internlm2-1.8b x decode_32k on 16 x 16 fake ranks), again (the file
exists), and on an unknown arch; then ``repro_torch.launch.perf``'s.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

REGION_ARCHS = ("internlm2-1.8b", "rwkv6-3b", "recurrentgemma-9b")
TP8_ARCH, TP8_SHAPES = "internlm2-1.8b", ("prefill_32k", "train_4k")
FULL_CELL = ("internlm2-1.8b", "decode_32k")


def reduced_cells():
    from repro_torch.configs import all_archs, cells

    return [(a, s.name) for a, c in all_archs().items() for s in cells(c)]


def _summary(s):
    return {"flops": s.flops, "dot_flops": s.dot_flops, "bytes": s.bytes,
            "transcendentals": s.transcendentals,
            "collective_bytes": dict(s.collective_bytes),
            "collective_count": dict(s.collective_count),
            "collective_axis_bytes": dict(s.collective_axis_bytes)}


def job_mesh():
    env0 = dict(os.environ)
    import torch
    import torch.distributed as dist

    before = dist.is_initialized()
    import repro_torch.launch.dryrun  # noqa: F401
    import repro_torch.launch.op_analysis as oa
    import repro_torch.launch.perf  # noqa: F401
    out = {"import_env_same": dict(os.environ) == env0,
           "import_initialized": [before, dist.is_initialized()],
           "jax_imported": "jax" in sys.modules}

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        axes = oa.group_axes(mesh)
        with FakeTensorMode():
            def place(shape, placements):
                return distribute_tensor(torch.empty(shape), mesh, placements)

            x = place((64, 32), [Shard(0), Replicate()])
            w = place((32, 48), [Replicate(), Shard(1)])
            xr = place((64, 32), [Replicate(), Replicate()])
            wr = place((32, 48), [Replicate(), Replicate()])
            xk = place((64, 32), [Replicate(), Shard(1)])
            wk = place((32, 48), [Replicate(), Shard(0)])
            xs = place((64, 48), [Replicate(), Shard(0)])

        def twice(a, b):
            return a @ b, a @ b

        # first in this process: both calls of one signature, cache miss first
        out["twice"] = _summary(oa.analyze_step(twice, x, w))
        out["both_sharded"] = _summary(oa.analyze_step(lambda a, b: a @ b, x, w))
        out["replicated"] = _summary(oa.analyze_step(lambda a, b: a @ b, xr, wr))
        out["contracting"] = _summary(oa.analyze_step(
            lambda a, b: (a @ b).redistribute(mesh, [Replicate(), Replicate()]),
            xk, wk))
        out["contracting_partial_bytes"] = 64 * 48 * 4
        out["shard_to_shard"] = _summary(oa.trace_step(
            lambda a: a.redistribute(mesh, [Replicate(), Shard(1)]), xs,
            axes=axes).total)
        out["shard_to_shard_local_bytes"] = 32 * 48 * 4
        out["contracting_axes"] = _summary(oa.trace_step(
            lambda a, b: (a @ b).redistribute(mesh, [Replicate(), Replicate()]),
            xk, wk, axes=axes).total)["collective_axis_bytes"]

        # the loss's label pick, forward and backward, on batch-sharded logits
        from repro_torch.models.sharding import gather_last

        with FakeTensorMode():
            logits = place((8, 16, 32), [Shard(0), Replicate()])
            labels = distribute_tensor(torch.zeros((8, 16), dtype=torch.int64), mesh,
                                       [Shard(0), Replicate()])

        def picked(pick):
            def step(lg, lb):
                lg = lg.detach().requires_grad_(True)
                with torch.enable_grad():
                    return torch.autograd.grad(pick(lg, lb).sum(), lg)
            return step

        plain = lambda lg, lb: torch.gather(lg, -1, lb[..., None])[..., 0]  # noqa: E731
        for name, pick in (("gather_last", gather_last), ("gather", plain)):
            mem = oa.trace_step(picked(pick), logits, labels).memory
            out[f"pick_temp_{name}"] = mem["eager_peak_bytes"] - mem["argument_bytes"]
        out["pick_global_bytes"] = 8 * 16 * 32 * 4
    finally:
        dist.destroy_process_group()
    # heads that do not divide over 'model': 4 heads at tp = 8, whose
    # attention each rank runs on its own S / 8 query rows
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.perf import REGIONS

    for shape in TP8_SHAPES:
        tr = trace_cell(TP8_ARCH, shape, False, reduced=True, mesh_shape=(1, 8),
                        regions=REGIONS)[-1]
        out[f"tp8|{shape}"] = tr.regions["attn_scores"].dot_flops
    # a decode step there: each rank's own cache slots
    for mesh_shape in ((1, 8), (1, 1)):
        tr = trace_cell(TP8_ARCH, "decode_32k", False, reduced=True,
                        mesh_shape=mesh_shape, regions=REGIONS)[-1]
        tag = "x".join(map(str, mesh_shape))
        out[f"decode|{tag}|attn"] = tr.regions["attn_scores"].dot_flops
        out[f"decode|{tag}|total"] = tr.total.dot_flops
    return out


def job_cells(i, n):
    from repro_torch.launch.dryrun import run_cell

    out = {}
    for arch, shape in reduced_cells()[i::n]:
        try:
            r = run_cell(arch, shape, False, verbose=False, reduced=True,
                         mesh_shape=(2, 2))
        except Exception as e:  # noqa: BLE001 - the test reports it
            r = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        out[f"{arch}|{shape}"] = r
    return out


def job_regions():
    import dataclasses

    import torch
    from repro_torch.launch.dryrun import build_cell, fake_world, trace_cell
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.launch.op_analysis import trace_step
    from repro_torch.launch.perf import REGIONS
    from repro_torch.models import make_loss_fn

    def regions(tr):
        return {r: {"flops": c.flops, "dot_flops": c.dot_flops, "bytes": c.bytes}
                for r, c in tr.regions.items()}

    out = {}
    for arch in REGION_ARCHS:
        for shape in ("train_4k", "prefill_32k"):
            tr = trace_cell(arch, shape, False, reduced=True, mesh_shape=(2, 2),
                            regions=REGIONS)[-1]
            out[f"{arch}|{shape}"] = regions(tr)
        # the train route's forward alone: the loss under no_grad
        with fake_world(4):
            cfg, shape, mesh, _, args, _ = build_cell(arch, "train_4k", False,
                                                      reduced=True, mesh_shape=(2, 2))
            loss = make_loss_fn(cfg, shape, ctx=dataclasses.replace(make_ctx(mesh),
                                                                   flash=False))
            with torch.no_grad():
                tr = trace_step(loss, args[0], args[2], regions=REGIONS)
        out[f"{arch}|forward"] = regions(tr)
    return out


def job_trips(arch):
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.perf import REGIONS

    out = {}
    for shape in ("train_4k", "prefill_32k"):
        for counted in (True, False):
            tr = trace_cell(arch, shape, False, reduced=True, mesh_shape=(2, 2),
                            regions=REGIONS, trip_counts=counted)[-1]
            out[f"{shape}|{'trips' if counted else 'every step'}"] = {
                "total": _summary(tr.total), "ops": tr.ops, "memory": tr.memory,
                "regions": {r: _summary(c) for r, c in tr.regions.items()}}
    return out


def job_depth(arch, shape, layers):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    out = []
    for n in layers:
        dryrun.get_arch = lambda name, n=n: dataclasses.replace(get_arch(name), num_layers=n)
        for multi_pod in (False, True):
            for counted in (True, False) if n == layers[0] else (True,):
                tr = dryrun.trace_cell(arch, shape, multi_pod, trip_counts=counted,
                                       max_ops=None)[-1]
                out.append({"layers": n, "mesh": dryrun.mesh_label(multi_pod),
                            "trips": counted, "ops": tr.ops, "trace_s": tr.seconds,
                            "total": _summary(tr.total), "memory": tr.memory})
                print(json.dumps({k: out[-1][k] for k in
                                  ("layers", "mesh", "trips", "ops", "trace_s")}
                                 | {"peak": tr.memory["peak_device_bytes"]}), flush=True)
    dryrun.get_arch = get_arch
    return out


def job_cli():
    from repro_torch.launch import dryrun, perf

    d = Path(tempfile.mkdtemp(prefix="dryrun_cli_"))
    arch, shape = FULL_CELL
    dryrun.main(["--arch", arch, "--shape", shape, "--out", str(d)])
    path = d / (f"{arch}_{shape}_sp".replace(".", "_") + ".json")
    first = json.loads(path.read_text())
    mtime = path.stat().st_mtime_ns
    dryrun.main(["--arch", arch, "--shape", shape, "--out", str(d)])
    skipped = path.stat().st_mtime_ns == mtime
    try:
        dryrun.main(["--arch", "no-such-arch", "--shape", shape, "--out", str(d)])
        raised = False
    except SystemExit:
        raised = True
    failed = json.loads((d / f"no-such-arch_{shape}_sp.json").read_text())
    perf.main(["--arch", arch, "--shape", shape, "--out", str(d / "perf.json")])
    return {"first": first, "skipped": skipped, "raised": raised, "failed": failed,
            "perf": json.loads((d / "perf.json").read_text())}


def main():
    job, dest = sys.argv[1], sys.argv[2]
    if job == "cells":
        out = job_cells(int(sys.argv[3]), int(sys.argv[4]))
    elif job == "trips":
        out = job_trips(sys.argv[3])
    elif job == "depth":
        out = job_depth(sys.argv[3], sys.argv[4], [int(n) for n in sys.argv[5].split(",")])
    else:
        out = {"mesh": job_mesh, "regions": job_regions, "cli": job_cli}[job]()
    Path(dest).write_text(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
