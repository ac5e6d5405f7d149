"""One rank of the port's multi-rank checks for ``test_torch_sharding.py``
and ``test_torch_compression.py``: gloo on the CPU, a file store.

    python tests/_torch_sharded_jobs.py <rank> <world> <store> <inputs.npz> <outdir> <jobs>

Every rank runs every job in the same order (the collectives must meet);
rank 0 writes ``<outdir>/result.npz`` and ``<outdir>/flags.json``.  Jobs
``sharding``: ``moe_ffn_sharded`` on a (2, 2) mesh; the sharded loss and
grads of three reduced archs in f32 and their bf16 losses; two ``Trainer``
steps sharded and on one device, with their checkpoints restored across
mesh shapes; the kernels' DTensor guard; the mesh builders' refusals.
Jobs ``psum``: ``compressed_psum`` over a ("pod",) mesh of every rank.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


ARCHS = ("internlm2-1.8b", "olmoe-1b-7b", "rwkv6-3b")
SRC = Path(__file__).resolve().parents[1] / "src"
RUN_TIMEOUT = 420       # ~70 s alone; 137 s beside five busy test workers


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _fill(like, inputs, prefix):
    from repro_torch.tree import tree_flatten_with_paths

    paths, _, unflatten = tree_flatten_with_paths(like)
    return unflatten([torch.from_numpy(inputs[f"{prefix}/{p}"]) for p in paths])


def _placed(ctx, tree):
    from repro_torch.models.sharding import tree_shardings
    from repro_torch.tree import tree_map

    return tree_map(lambda x, s: s.place(x), tree, tree_shardings(ctx, tree))


def _value_and_grads(loss_fn, params, batch, ctx):
    from repro_torch.models.sharding import full
    from repro_torch.tree import tree_flatten_with_paths, tree_unflatten

    paths, leaves, _ = tree_flatten_with_paths(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad(), ctx.scope():
        loss, ex = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return (float(full(loss)), float(full(ex["aux"])),
            {p: _np(full(g)) for p, g in zip(paths, grads)})


def moe_job(ctx, inputs, out):
    from repro_torch.models.moe import moe_ffn, moe_ffn_sharded
    from repro_torch.models.sharding import P, distribute, full

    p = {"router": torch.from_numpy(inputs["moe/router"]),
         "experts": {k: torch.from_numpy(inputs[f"moe/{k}"]) for k in ("w1", "w3", "w2")}}
    x = torch.from_numpy(inputs["moe/x"])
    E, K = int(inputs["moe/E"]), int(inputs["moe/K"])
    B, S, D = x.shape
    pd = _placed(ctx, p)
    xd = distribute(ctx, x, P("data", "model", None))
    for name in ("nodrop", "drop"):
        cf = float(inputs[f"moe/cf_{name}"])
        with ctx.scope():
            y, aux = moe_ffn_sharded(pd, xd, n_experts=E, top_k=K,
                                     capacity_factor=cf, ctx=ctx)
        out[f"moe/{name}/out"] = _np(full(y))
        out[f"moe/{name}/aux"] = _np(full(aux))
    dense, aux_d = moe_ffn(p, x.reshape(B * S, D), n_experts=E, top_k=K,
                           capacity_factor=float(inputs["moe/cf_nodrop"]), train=True)
    out["moe/dense/out"] = _np(dense.reshape(B, S, D))
    out["moe/dense/aux"] = _np(aux_d)
    # 3 tokens a row: the model axis cannot split them, so lm's _ffn_apply
    # takes moe_ffn on DTensors, the whole dispatch on every rank
    from repro_torch.configs import get_arch
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_arch("olmoe-1b-7b").reduced(), num_experts=E,
                              moe_top_k=K, capacity_factor=1.0, d_model=D, d_ff=64)
    x3 = x[:, :3]
    with torch.enable_grad(), ctx.scope():
        xd3 = distribute(ctx, x3, P("data", None, None)).requires_grad_(True)
        y3, aux3 = lm._ffn_apply({"moe": pd}, cfg, xd3, True, ctx)
        (g3,) = torch.autograd.grad((y3 * y3).sum() + aux3, xd3)
    x3p = x3.clone().requires_grad_(True)
    with torch.enable_grad():
        r3, raux3 = moe_ffn(p, x3p.reshape(-1, D), n_experts=E, top_k=K,
                            capacity_factor=1.0, train=True)
        (rg3,) = torch.autograd.grad((r3 * r3).sum() + raux3, x3p)
    out["moe/replicated/err"] = np.float32(max(
        float((full(y3) - r3.reshape(x3.shape)).abs().max()),
        float((full(g3) - rg3).abs().max()), abs(float(full(aux3)) - float(raux3))))


def loss_jobs(ctx, inputs, out, rank):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import init_params, make_loss_fn
    from repro_torch.models.sharding import ShardCtx, full

    tokens = torch.from_numpy(inputs["tokens"]).long()
    shape = ShapeConfig("t", "train", tokens.shape[1], tokens.shape[0])
    batch = {"tokens": tokens}
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        like = init_params(cfg, device="cpu", seed=0)
        params = _fill(like, inputs, f"params/{arch}")
        loss, aux, grads = _value_and_grads(make_loss_fn(cfg, shape, ctx=ctx),
                                            _placed(ctx, params), batch, ctx)
        out[f"loss/{arch}"] = np.float32(loss)
        out[f"aux/{arch}"] = np.float32(aux)
        for path, g in grads.items():
            out[f"grads/{arch}/{path}"] = g
        if rank == 0 and arch != "olmoe-1b-7b":     # its sharded MoE is other math
            _, _, grads1 = _value_and_grads(make_loss_fn(cfg, shape), params, batch,
                                            ShardCtx())
            for path, g in grads1.items():
                out[f"grads1/{arch}/{path}"] = g
        # bf16: the port's own params, sharded against one device
        with torch.no_grad():
            sharded, _ = make_loss_fn(cfg, shape, ctx=ctx)(_placed(ctx, like), batch)
            single, _ = make_loss_fn(cfg, shape)(like, batch)
        out[f"bf16/sharded/{arch}"] = np.float32(float(full(sharded)))
        out[f"bf16/single/{arch}"] = np.float32(float(single))


class _f32_params:
    """Within: the trainer draws its params as usual, then casts them to
    f32 (the f32-params train step)."""

    def __enter__(self):
        import repro_torch.runtime.train_loop as tl
        from repro_torch.tree import tree_map

        self.tl, self.init = tl, tl.init_params
        tl.init_params = lambda *a, **k: tree_map(lambda p: p.float(),
                                                   self.init(*a, **k))

    def __exit__(self, *exc):
        self.tl.init_params = self.init


def _trainer(ctx, ckpt_dir):
    """Reduced internlm2, two steps, a checkpoint at step 2."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    return Trainer(get_arch("internlm2-1.8b").reduced(), ShapeConfig("t", "train", 32, 4),
                   TrainConfig(total_steps=2, log_every=10, checkpoint_every=2,
                               checkpoint_dir=ckpt_dir, num_hosts=2,
                               opt=AdamWConfig(lr=1e-3)),
                   device="cpu", ctx=ctx)


def _same_bits(a_tree, b_tree) -> bool:
    from repro_torch.models.sharding import full
    from repro_torch.tree import tree_leaves

    def raw(x):
        return full(x).detach().reshape(-1).view(torch.uint8)

    a, b = tree_leaves(a_tree), tree_leaves(b_tree)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and tuple(x.shape) == tuple(y.shape)
        and torch.equal(raw(x), raw(y)) for x, y in zip(a, b))


def trainer_and_checkpoint_jobs(ctx, world, base, rank, out, flags):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch.mesh import make_ctx, make_host_mesh
    from repro_torch.models.sharding import ShardCtx, map_specs
    from repro_torch.tree import tree_flatten_with_paths

    sharded_dir = os.path.join(base, "ckpt_22")
    single_dir = os.path.join(base, "ckpt_1")
    with _f32_params():
        tr = _trainer(ctx, sharded_dir)
        out["trainer/sharded/losses"] = np.asarray(tr.run(start_fresh=True).losses,
                                                   np.float32)
        one = _trainer(ShardCtx(), single_dir)
        plain = dict(zip(("params", "opt"), one.init_state()))
        if rank == 0:
            out["trainer/single/losses"] = np.asarray(one.run(start_fresh=True).losses,
                                                      np.float32)
    dist.barrier()
    specs = tr._specs(plain["params"], plain["opt"])
    saved = restore_checkpoint(sharded_dir, 2, plain)             # one device
    for p, x in zip(*tree_flatten_with_paths(saved["params"])[:2]):
        out[f"trainer/sharded/params/{p}"] = _np(x)
    if rank == 0:
        single = restore_checkpoint(single_dir, 2, plain)
        for p, x in zip(*tree_flatten_with_paths(single["params"])[:2]):
            out[f"trainer/single/params/{p}"] = _np(x)
    else:
        single = restore_checkpoint(single_dir, 2, plain)

    # the (2, 2) save restores bit-exact on (4, 1), as DTensors
    ctx41 = make_ctx(make_host_mesh(world, model_axis=1))
    on41 = restore_checkpoint(sharded_dir, 2, plain,
                              shardings=map_specs(ctx41.named, specs))
    flags["restore_22_on_41_exact"] = _same_bits(on41, saved)
    wq = on41["params"]["groups"]["b0"]["attn"]["wq"]
    flags["restore_22_on_41_wq"] = [list(wq.device_mesh.shape), str(wq.placements),
                                    list(wq.to_local().shape), list(wq.shape)]
    # the single-device save restores bit-exact under (2, 2)
    on22 = restore_checkpoint(single_dir, 2, plain,
                              shardings=map_specs(ctx.named, specs))
    flags["restore_1_on_22_exact"] = _same_bits(on22, single)
    # a trainer under the (4, 1) mesh resumes from the (2, 2) save
    with _f32_params():
        p41, o41, step = _trainer(ctx41, sharded_dir).restore_or_init()
    flags["resume_41_step"] = step
    flags["resume_41_exact"] = _same_bits({"opt": o41, "params": p41}, saved)
    flags["ckpt_dir_22"] = sharded_dir


def microbatch_job(ctx, rank, out):
    """One train step of reduced internlm2 (f32 params) at two
    microbatches, sharded and on one device."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import init_opt_state, init_params, make_train_step
    from repro_torch.models.sharding import ShardCtx, P, distribute, full
    from repro_torch.tree import tree_flatten_with_paths, tree_map

    cfg = get_arch("internlm2-1.8b").reduced()
    shape = ShapeConfig("t", "train", 32, 4)
    params = tree_map(lambda p: p.float(), init_params(cfg, device="cpu", seed=1))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (4, 32)))
    for name, c in (("sharded", ctx), ("single", ShardCtx())):
        if name == "single" and rank != 0:
            continue
        p_in, o_in, batch = params, init_opt_state(params), {"tokens": tokens}
        if c.mesh is not None:
            p_in = _placed(c, params)
            o_in = {k: (distribute(c, v, P()) if k == "step" else _placed(c, v))
                    for k, v in o_in.items()}
            batch = {"tokens": distribute(c, tokens, P("data", None))}
        step = make_train_step(cfg, shape, microbatches=2, total_steps=4, ctx=c)
        new, _, metrics = step(p_in, o_in, batch)
        out[f"mb2/{name}/loss"] = np.float32(float(full(metrics["loss"])))
        for path, x in zip(*tree_flatten_with_paths(new)[:2]):
            out[f"mb2/{name}/params/{path}"] = _np(full(x))


def psum_job(world, rank, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime.compression import compressed_psum

    pod = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    rng = np.random.default_rng(100 + rank)
    g = {"w": torch.from_numpy((rng.standard_normal((3, 5)) * (rank + 1)).astype(np.float32)),
         "b": [torch.from_numpy(rng.standard_normal(7).astype(np.float32))]}
    red = compressed_psum(g, pod, axis="pod")
    out["psum4/w"] = red["w"].numpy()
    out["psum4/b"] = red["b"][0].numpy()


def guard_job(ctx, flags):
    from repro_torch.kernels import _build
    from repro_torch.models.sharding import distribute, P

    d = distribute(ctx, torch.zeros(4, 4), P("data", "model"))
    try:
        _build.refuse_dtensor("moe_gmm", torch.zeros(2), d)
        flags["guard_raises"] = False
    except TypeError as e:
        flags["guard_raises"] = "DTensor" in str(e)
    _build.refuse_dtensor("moe_gmm", torch.zeros(2), None)        # plain: passes
    flags["guard_passes_plain"] = True


def mesh_jobs(flags):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    try:
        make_production_mesh()
        flags["production_refused"] = ""
    except RuntimeError as e:
        flags["production_refused"] = str(e)
    m = make_host_mesh(model_axis=2)
    flags["host_mesh"] = [list(m.mesh_dim_names), list(m.shape)]


def _wait(procs, deadline):
    import pytest

    for name, p in procs:
        left = max(1.0, deadline - time.monotonic())
        try:
            p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            pytest.fail(f"{name} did not finish in {RUN_TIMEOUT} s")


def run_ranks(tmp, jobs, world=4, inputs="none", extra=()):
    """Start ``world`` gloo ranks of ``_torch_sharded_jobs.py`` (and the
    ``extra`` processes) in ``tmp``; wait for all; fail on any error."""
    import pytest

    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    store = tmp / "store"
    procs = list(extra)
    for r in range(world):
        procs.append((f"rank {r}", subprocess.Popen(
            [sys.executable, __file__, str(r), str(world),
             str(store), str(inputs), str(tmp), jobs],
            stdout=open(tmp / f"rank{r}.log", "w"), stderr=subprocess.STDOUT, env=env)))
    _wait(procs, time.monotonic() + RUN_TIMEOUT)
    for name, p in procs:
        if p.returncode != 0:
            log = tmp / (name.replace("rank ", "rank") + ".log")
            text = log.read_text()[-3000:] if log.exists() else ""
            pytest.fail(f"{name} exited {p.returncode}\n{text}")


def main(rank: int, world: int, store: str, src: str, outdir: str, jobs: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    out, flags = {}, {}
    if jobs == "psum":
        psum_job(world, rank, out)
    else:
        from repro_torch.launch.mesh import make_ctx, make_host_mesh

        ctx = make_ctx(make_host_mesh(world, model_axis=2))
        inputs = dict(np.load(src))
        moe_job(ctx, inputs, out)
        loss_jobs(ctx, inputs, out, rank)
        trainer_and_checkpoint_jobs(ctx, world, os.path.join(outdir, "work"), rank,
                                    out, flags)
        microbatch_job(ctx, rank, out)
        guard_job(ctx, flags)
        mesh_jobs(flags)
    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(outdir, "result.npz"), **out)
        with open(os.path.join(outdir, "flags.json"), "w") as f:
            json.dump(flags, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    tempfile.tempdir = sys.argv[5]
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
         sys.argv[6])
