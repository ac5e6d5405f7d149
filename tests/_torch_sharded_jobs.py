"""One rank of the port's multi-rank checks for ``test_torch_sharding.py``
and ``test_torch_compression.py``: gloo on the CPU, a file store.

    python tests/_torch_sharded_jobs.py <rank> <world> <store> <inputs.npz> <outdir> <jobs>

Every rank runs every job in the same order (the collectives must meet);
rank 0 writes ``<outdir>/result.npz`` and ``<outdir>/flags.json``.  Jobs
``sharding``: ``moe_ffn_sharded`` on a (2, 2) mesh; the sharded loss and
grads of four reduced archs in f32 and their bf16 losses (whisper-medium's
on seeded audio frames); two ``Trainer``
steps sharded and on one device, with their checkpoints restored across
mesh shapes; the kernels' DTensor guard; the mesh builders' refusals.
Then ``prefill``: the f32 prefill logits of ``PREFILL_ARCHS`` on the
loss inputs' 4 x 64 tokens, the batch split over 'data', under the mesh
and on one device.  Then ``serve``: prefill and decode of reduced internlm2, olmoe,
recurrentgemma and rwkv6 under the mesh and on one device (f32 params;
bf16 params with MoE routing replayed from one device),
the sharded ``DiffusionServer`` on the stream of ``test_torch_payload.py``
(bf16 modeled and real payload, f32 params) and on one device (f32), and
the flash-attention kernel's GQA head mapping at tp = 2.  Then ``split``:
``SPLIT_ARCH``, whose query heads do not divide over 'tp', trained,
prefilled, decoded and served under the mesh, each rank's attention calls
recorded.
Jobs ``psum``: ``compressed_psum`` over a ("pod",) mesh of every rank.
Jobs ``bf16_readings``: the readings behind the bf16 logits bounds
(``bf16_readings``; ``<inputs.npz>`` unused, pass ``none``).

The inputs come from ``make_inputs`` (the port's own init and seeded numpy
draws), so the jobs run without JAX; ``port_checks`` holds their results
to the port on one device (what a machine without the reference can
check)."""

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


ARCHS = ("internlm2-1.8b", "olmoe-1b-7b", "rwkv6-3b", "whisper-medium")
# sharded prefill of the loss inputs' batch (split over 'data'), f32 params
PREFILL_ARCHS = ("rwkv6-3b",)
# reduced gemma3-1b with 3 query heads, which do not divide over the (2, 2)
# mesh's 'tp': attention takes the reference's sequence split (its sliding
# window comes along)
SPLIT_ARCH = "gemma3-1b-h3"
SRC = Path(__file__).resolve().parents[1] / "src"
# a guard against a hung rank, not a budget: the ``sharding`` jobs and the
# reference take ~150 s alone on 8 CPU cores and ~445 s beside five busy
# test workers (pytest -n 6)
RUN_TIMEOUT = 900


def _np(t):
    return t.detach().to(torch.float32).numpy()


def reduced_cfg(get_arch, name):
    """The reduced config of ``name`` from either package's ``get_arch``."""
    if name == SPLIT_ARCH:
        return dataclasses.replace(get_arch("gemma3-1b").reduced(), num_heads=3)
    return get_arch(name).reduced()


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
    aux = ex.get("aux")                 # the encoder-decoder's loss has none
    return (float(full(loss)), 0.0 if aux is None else float(full(aux)),
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
    # takes moe_ffn on DTensors: in training the whole dispatch on every
    # rank, in serving each rank's block of the capacity buffer
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
    # serving on the same tokens: each rank's block of the capacity buffer
    with torch.no_grad(), ctx.scope():
        s3, saux3 = lm._ffn_apply({"moe": pd}, cfg,
                                  distribute(ctx, x3, P("data", None, None)), False, ctx)
    q3, qaux3 = moe_ffn(p, x3.reshape(-1, D), n_experts=E, top_k=K, capacity_factor=1.0)
    out["moe/replicated/err"] = np.float32(max(
        float((full(y3) - r3.reshape(x3.shape)).abs().max()),
        float((full(g3) - rg3).abs().max()), abs(float(full(aux3)) - float(raux3)),
        float((full(s3) - q3.reshape(x3.shape)).abs().max()),
        abs(float(full(saux3)) - float(qaux3))))


def loss_jobs(ctx, inputs, out, rank):
    for arch in ARCHS:
        loss_case(ctx, inputs, out, arch)
        if rank == 0:
            loss_single(inputs, out, arch)


def _loss_inputs(inputs, arch):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import init_params

    tokens = torch.from_numpy(inputs["tokens"]).long()
    shape = ShapeConfig("t", "train", tokens.shape[1], tokens.shape[0])
    cfg = reduced_cfg(get_arch, arch)
    like = init_params(cfg, device="cpu", seed=0)
    batch = {"tokens": tokens}
    if cfg.encoder_layers:
        batch["audio_embeds"] = torch.from_numpy(inputs["audio"])
    return cfg, shape, batch, like, _fill(like, inputs, f"params/{arch}")


def prefill_jobs(ctx, inputs, out, rank):
    """The f32 prefill logits of ``PREFILL_ARCHS`` on the loss inputs'
    tokens under the mesh (the batch split over 'data'), and on rank 0 on
    one device."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import make_prefill_step
    from repro_torch.models.sharding import P, ShardCtx, distribute, full

    for arch in PREFILL_ARCHS:
        cfg, _, batch, _, params = _loss_inputs(inputs, arch)
        tokens = batch["tokens"]
        shape = ShapeConfig("p", "prefill", tokens.shape[1], tokens.shape[0])
        with torch.no_grad():
            logits, _ = make_prefill_step(cfg, shape, ctx=ctx)(
                _placed(ctx, params), {"tokens": distribute(ctx, tokens, P("data", None))})
            out[f"prefill/{arch}/mesh"] = _np(full(logits))
            if rank == 0:
                logits, _ = make_prefill_step(cfg, shape, ctx=ShardCtx())(
                    params, {"tokens": tokens})
                out[f"prefill/{arch}/single"] = _np(logits)


def loss_case(ctx, inputs, out, arch):
    """The sharded loss and grads on f32 params, and the sharded bf16 loss
    on the port's own params."""
    from repro_torch.models import make_loss_fn
    from repro_torch.models.sharding import full

    cfg, shape, batch, like, params = _loss_inputs(inputs, arch)
    loss, aux, grads = _value_and_grads(make_loss_fn(cfg, shape, ctx=ctx),
                                        _placed(ctx, params), batch, ctx)
    out[f"loss/{arch}"] = np.float32(loss)
    out[f"aux/{arch}"] = np.float32(aux)
    for path, g in grads.items():
        out[f"grads/{arch}/{path}"] = g
    with torch.no_grad():
        sharded, _ = make_loss_fn(cfg, shape, ctx=ctx)(_placed(ctx, like), batch)
    out[f"bf16/sharded/{arch}"] = np.float32(float(full(sharded)))


def loss_single(inputs, out, arch):
    """``loss_case``'s one-device counterparts: the f32 grads (not olmoe's:
    its sharded MoE is other math) and the bf16 loss."""
    from repro_torch.models import make_loss_fn
    from repro_torch.models.sharding import ShardCtx

    cfg, shape, batch, like, params = _loss_inputs(inputs, arch)
    if arch != "olmoe-1b-7b":
        _, _, grads1 = _value_and_grads(make_loss_fn(cfg, shape), params, batch,
                                        ShardCtx())
        for path, g in grads1.items():
            out[f"grads1/{arch}/{path}"] = g
    with torch.no_grad():
        single, _ = make_loss_fn(cfg, shape)(like, batch)
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


SERVE_ARCHS = ("internlm2-1.8b", "olmoe-1b-7b", "recurrentgemma-9b", "rwkv6-3b")
SERVE_KW = dict(policy="good-cache-compute", max_replicas=1, min_replicas=1,
                cache_cap=48, max_sessions=2, host_cache_sessions=4, seed=0)
SERVE_PROMPT, SERVE_STEPS = 16, 4
SERVE_COUNTERS = ("served", "prefix_hits", "swap_ins", "prefills", "decode_steps")


def serve_prompts(vocab):
    """The stream of ``test_torch_payload.py``: 3 sessions of 12 tokens."""
    rng = np.random.default_rng(0)
    return {f"s{i}": rng.integers(0, vocab, size=(12,)) for i in range(3)}


def serve_tokens(vocab, seed=5):
    """A prompt and the teacher-forced decode tokens of the logits check."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (1, SERVE_PROMPT)),
            rng.integers(0, vocab, (SERVE_STEPS,)))


def _logits_run(cfg, params, ctx, f32=True, seed=5, decoding=None):
    """Prefill of the seeded prompt, then SERVE_STEPS teacher-forced decode
    steps on the server's cache capacity; every step's whole logits.
    ``f32``: f32 caches for f32 params (the reference's decode writes K/V in
    its params' dtype); else the caches ``cache_init`` makes, as the server
    does.  ``decoding``: a context the decode steps run in."""
    import contextlib

    from repro_torch.tree import tree_map

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import cache_init, make_decode_step, make_prefill_step
    from repro_torch.models.sharding import P, distribute, full
    from repro_torch.runtime.serve_loop import _merge_prefill_caches

    cap = SERVE_KW["cache_cap"]
    prompt, forced = serve_tokens(cfg.vocab_size, seed)
    prompt = distribute(ctx, torch.from_numpy(prompt), P(None, None))
    logits, pre = make_prefill_step(cfg, ShapeConfig("serve", "prefill", cap, 1),
                                    ctx=ctx)(params, {"tokens": prompt})
    caches = cache_init(cfg, 1, cap, device="cpu", ctx=ctx)
    if f32:
        caches = tree_map(lambda c: c.float(), caches)
    caches = _merge_prefill_caches(caches, pre, cfg)
    out = [_np(full(logits))]
    decode = make_decode_step(cfg, ctx=ctx)
    for i, t in enumerate(forced):
        token = distribute(ctx, torch.tensor([int(t)]), P(None))
        with decoding or contextlib.nullcontext():
            logits, caches = decode(params, {"token": token, "pos": SERVE_PROMPT + i,
                                             "caches": caches})
        out.append(_np(full(logits)))
    return np.stack(out)


class _ExpertBlocks:
    """Within: the shapes of x and w that each K4 call of the MoE FFN got,
    and every redistribute of an expert weight (an [E, ., .] DTensor) that
    gathers its experts over 'model'."""

    def __init__(self, n_experts):
        from torch.distributed.tensor import DTensor

        from repro_torch.models import moe

        self.moe, self.E = moe, n_experts
        self.orig = moe.moe_gmm, DTensor.redistribute
        self.calls, self.model_gathers = [], []

    def __enter__(self):
        from torch.distributed.tensor import DTensor, Shard

        gmm, redistribute = self.orig

        def gmm_rec(x, w, *a, **kw):
            self.calls.append([list(x.shape), list(w.shape)])
            return gmm(x, w, *a, **kw)

        def redistribute_rec(t, device_mesh=None, placements=None, **kw):
            if t.ndim == 3 and t.shape[0] == self.E and placements is not None:
                m = list(t.device_mesh.mesh_dim_names).index("model")
                if t.placements[m] == Shard(0) and placements[m] != Shard(0):
                    self.model_gathers.append(list(t.shape))
            return redistribute(t, device_mesh, placements, **kw)

        self.moe.moe_gmm, DTensor.redistribute = gmm_rec, redistribute_rec
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor import DTensor

        self.moe.moe_gmm, DTensor.redistribute = self.orig


def expert_block_problems(flags, arch="olmoe-1b-7b"):
    """What is wrong with the K4 calls of ``arch``'s sharded decode steps
    (``serve_jobs``, f32, one token a step): each rank's three GEMMs a
    layer must run on its own [E / tp, C / dp] block of the capacity
    buffer, with its own E / tp experts, and no expert weight may be
    gathered over 'model'."""
    from repro_torch.configs import get_arch
    from repro_torch.models.moe import capacity

    cfg = get_arch(arch).reduced()
    tp = dp = 2                             # the (2, 2) mesh
    E, D, F = cfg.num_experts // tp, cfg.d_model, cfg.d_ff
    C = capacity(1, cfg.moe_top_k, cfg.num_experts, cfg.capacity_factor) // dp
    want = [[[E, C, D], [E, D, F]], [[E, C, D], [E, D, F]], [[E, C, F], [E, F, D]]]
    bad = []
    for r in flags[f"serve/{arch}/blocks"]:
        if r["calls"] != want * (cfg.num_layers * SERVE_STEPS) or r["model_gathers"]:
            bad.append(f"rank {r['rank']}: {r['calls'][:3]} ... "
                       f"({len(r['calls'])} calls), gathers {r['model_gathers']}")
    return bad


# bf16 prefill/decode logits under the mesh against one device, max abs
# error over max abs per step.  Each bound sits above the largest reading
# over init seeds 0-7 (job ``bf16_readings``: internlm2 2.51e-2, olmoe
# 5.53e-2 with routing replayed, recurrentgemma 5.25e-2, rwkv6 2.05e-1,
# whose bf16 logits on one device lie up to 1.64e-1 from its f32 ones) and
# below a planted fault (a decode K/V write one slot late on the mesh:
# >= 1.17e-1; recurrent state not written back on the mesh: >= 1.08).
BF16_LOGITS_TOL = {"internlm2-1.8b": 4e-2, "olmoe-1b-7b": 8e-2,
                   "recurrentgemma-9b": 8e-2, "rwkv6-3b": 3e-1}
BF16_TIE = 1e-2         # largest own-choice flip over seeds 0-7: 5.1e-3


class _RoutingReplay:
    """Top-k routing is discontinuous: where the k-th and (k+1)-th router
    probabilities tie to within bf16 noise, the mesh's summation order can
    swap two experts and change a layer's output wholesale.  The one-device
    pass records each router call's experts; the mesh pass routes to them
    with its own probabilities and keeps, in ``flips``, the one-device
    margin of every token whose own choice differed."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.orig = moe, moe._router
        self.recorded, self.flips, self.i = [], [], None

    def __call__(self, p, x2d, top_k):
        probs, gate_vals, gate_idx = self.orig(p, x2d, top_k)
        if x2d.shape[0] == 0:                 # an empty batch shard
            return probs, gate_vals, gate_idx
        if self.i is None:
            top = torch.topk(probs, top_k + 1, dim=-1).values
            self.recorded.append((gate_idx, top[:, -2] - top[:, -1]))
            return probs, gate_vals, gate_idx
        idx, margin = self.recorded[self.i]
        self.i += 1
        own = (gate_idx.sort(-1).values != idx.sort(-1).values).any(-1)
        self.flips += [float(margin[t]) for t in torch.nonzero(own)]
        vals = torch.gather(probs, 1, idx)
        return probs, vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9), idx

    def __enter__(self):
        self.moe._router = self
        return self

    def __exit__(self, *exc):
        self.moe._router = self.orig


def _bf16_logits(cfg, params, ctx, seed=5):
    """``_logits_run`` on bf16 params and caches on one device, then under
    ``ctx`` routed as one device routed; (mesh, one device, flips)."""
    from repro_torch.models.sharding import ShardCtx

    with _RoutingReplay() as replay:
        single = _logits_run(cfg, params, ShardCtx(), f32=False, seed=seed)
        replay.i = 0
        mesh = _logits_run(cfg, _placed(ctx, params), ctx, f32=False, seed=seed)
    return mesh, single, replay.flips


def bf16_readings(ctx, rank, outdir, seeds=range(8)):
    """The readings behind ``BF16_LOGITS_TOL`` and ``BF16_TIE``: for init
    seed s (prompt seed 5 + s), every step's max abs error over max abs
    of the bf16 logits under the mesh against one device, the one-device
    margins of the routing flips, and (rank 0) how far one device's bf16
    logits lie from its f32 ones; rank 0 writes
    ``<outdir>/bf16_readings.json`` and prints one line a run."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.models.sharding import ShardCtx
    from repro_torch.tree import tree_map

    def errs(t, o, V):
        return [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(t[..., :V], o[..., :V])]

    got = {}
    for arch in SERVE_ARCHS:
        cfg = get_arch(arch).reduced()
        V = cfg.vocab_size
        for s in seeds:
            params = init_params(cfg, device="cpu", seed=s)
            mesh, single, flips = _bf16_logits(cfg, params, ctx, seed=5 + s)
            got[f"{arch}/{s}"] = {"step_errs": errs(mesh, single, V),
                                  "flip_margins": flips}
            if rank == 0:
                f32 = _logits_run(cfg, tree_map(lambda p: p.float(), params),
                                  ShardCtx(), seed=5 + s)
                got[f"{arch}/{s}"]["one_device_bf16_vs_f32"] = errs(single, f32, V)
                print(arch, s, " ".join(f"{e:.3g}" for e in got[f"{arch}/{s}"]["step_errs"]),
                      "| one device bf16 vs f32 max",
                      f"{max(got[f'{arch}/{s}']['one_device_bf16_vs_f32']):.3g}",
                      "| flips", flips, flush=True)
    if rank == 0:
        with open(os.path.join(outdir, "bf16_readings.json"), "w") as f:
            json.dump(got, f)


def _serve_stream(cfg, ctx, payload, f32=False):
    """The payload test's stream through ``DiffusionServer`` (``f32``: its
    params cast to f32 and placed again); returns (log, counters, greedy
    tokens, server)."""
    from repro_torch.models.sharding import full
    from repro_torch.runtime.serve_loop import DiffusionServer
    from repro_torch.tree import tree_map

    srv = DiffusionServer(cfg, device="cpu", ctx=ctx, payload=payload, **SERVE_KW)
    if f32:
        srv.params = tree_map(lambda p: p.float(), srv.params)
    tokens, greedy = [], srv._greedy

    def recorded(logits):
        tok = greedy(logits)
        tokens.append(full(tok).tolist())
        return tok

    srv._greedy = recorded
    srv.router.assignment_log = []
    for _ in range(2):
        for sid, p in serve_prompts(cfg.vocab_size).items():
            srv.submit(sid, p, max_new_tokens=2)
        srv.step()
    return (list(srv.router.assignment_log),
            {c: getattr(srv.stats, c) for c in SERVE_COUNTERS}, tokens, srv)


def serve_jobs(ctx, rank, out, flags, params_of):
    """``params_of(arch, cfg)``: the arch's bf16 params, the same tree on
    every rank."""
    from repro_torch.configs import get_arch
    from repro_torch.models.sharding import ShardCtx, is_dtensor
    from repro_torch.tree import tree_leaves, tree_map

    for arch in SERVE_ARCHS:
        cfg = get_arch(arch).reduced()
        bf16 = params_of(arch, cfg)
        f32 = tree_map(lambda p: p.float(), bf16)
        blocks = _ExpertBlocks(cfg.num_experts)
        out[f"serve/{arch}/f32/mesh"] = _logits_run(cfg, _placed(ctx, f32), ctx,
                                                    decoding=blocks)
        if cfg.num_experts:
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, {"rank": rank, "calls": blocks.calls,
                                           "model_gathers": blocks.model_gathers})
            flags[f"serve/{arch}/blocks"] = every
        if rank == 0:
            out[f"serve/{arch}/f32/single"] = _logits_run(cfg, f32, ShardCtx())
        (out[f"serve/{arch}/bf16/mesh"], out[f"serve/{arch}/bf16/single"],
         flags[f"serve/{arch}/bf16/flips"]) = _bf16_logits(cfg, bf16, ctx)
        runs = {}
        # bf16: the server's own params; f32: the same cast up, whose greedy
        # tokens are held to one device's (in bf16 the random reduced
        # weights leave near ties that the mesh's summation order breaks
        # otherwise: olmoe's routing, and rwkv6's logits, as far from the f32
        # run on one device as from the mesh)
        for name, c, payload, f32 in (
                ("modeled", ctx, "modeled", False), ("real", ctx, "real", False),
                ("f32", ctx, "modeled", True), ("f32_single", ShardCtx(), "modeled", True)):
            if name == "f32_single" and rank != 0:
                continue
            log, counters, tokens, srv = _serve_stream(cfg, c, payload, f32)
            runs[name] = {"log": log, "counters": counters, "tokens": tokens}
            if name == "real":
                backend = srv.router.stores[next(iter(srv.router.stores))].tiers.payload
                leaves = [l for obj in list(backend._leaves)
                          for l in tree_leaves(backend.value(obj))]
                runs[name]["dtensor_leaves"] = bool(leaves) and all(
                    is_dtensor(l) for l in leaves)
                runs[name]["swap_in_bytes_per_s"] = srv.swap_in_bandwidth()
                runs[name]["params_dtensor"] = all(is_dtensor(p) for p in
                                                   tree_leaves(srv.params))
            del srv
        flags[f"serve/{arch}"] = runs


def gqa_job(ctx, rank, out, flags):
    """The flash-attention kernel at tp = 2 on 4 query heads over 2 KV
    heads (GQA) and over 1 (MQA), batch 2 on 'dp', against one device;
    and the same local call without the per-rank KV slice."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.layers import _flash, _kv_span
    from repro_torch.models.sharding import P, distribute, full

    rng = np.random.default_rng(11)
    for name, hkv in (("gqa", 2), ("mqa", 1)):
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((2, 16, 4, 16), (2, 16, hkv, 16), (2, 16, hkv, 16)))
        one = flash_attention(q, k, v, causal=True)
        qd = distribute(ctx, q, P("data", None, "model", None))
        kd, vd = (distribute(ctx, x, P("data", None, None, None)) for x in (k, v))
        got = full(_flash(qd, kd, vd, causal=True, window=0, ctx=ctx))
        out[f"gqa/{name}/err"] = np.float32((got - one).abs().max())
        naive = full(ctx.local_call(
            lambda a, b, c: flash_attention(a.contiguous(), b, c, causal=True),
            (qd, kd, vd), (("dp", None, "tp", None),) + (("dp", None, None, None),) * 2,
            [(("dp", None, "tp", None), tuple(q.shape))]))
        out[f"gqa/{name}/naive_err"] = np.float32((naive - one).abs().max())
    flags["gqa/kv_span"] = _kv_span(ctx.mesh.get_local_rank("model") * 2, 2, 2)


class _AttentionRows:
    """Within: every attention call of the port's layers (the kernel's
    entry ``flash_attention``, the plain ``_attention`` and a decode step's
    split-KV part ``_partial_attention``) records the query rows and the
    keys it got and the position of its first row."""

    def __init__(self):
        from repro_torch.models import layers

        self.layers, self.calls = layers, []
        self.orig = layers.flash_attention, layers._attention, layers._partial_attention

    def __enter__(self):
        flash, plain, part = self.orig

        def flash_rec(q, k, v, *, q_offset=None, **kw):
            first = k.shape[1] - q.shape[1] if q_offset is None else q_offset
            self.calls.append(("kernel", q.shape[1], k.shape[1], int(first)))
            if q_offset is not None:
                kw["q_offset"] = q_offset
            return flash(q, k, v, **kw)

        def plain_rec(q, k, v, qpos, kpos, *a):
            self.calls.append(("plain", q.shape[1], k.shape[1], int(qpos[0])))
            return plain(q, k, v, qpos, kpos, *a)

        def part_rec(q, k, v, qpos, kpos, *a):
            self.calls.append(("slots", q.shape[1], k.shape[1], int(qpos[0])))
            return part(q, k, v, qpos, kpos, *a)

        (self.layers.flash_attention, self.layers._attention,
         self.layers._partial_attention) = flash_rec, plain_rec, part_rec
        return self

    def __exit__(self, *exc):
        (self.layers.flash_attention, self.layers._attention,
         self.layers._partial_attention) = self.orig


def split_heads_job(ctx, inputs, rank, out, flags):
    """``SPLIT_ARCH`` under the mesh: ``loss_case``, prefill and decode
    logits on f32 params, the server's stream (bf16, modeled payload), each
    beside one device on rank 0; every rank's attention calls under the
    mesh recorded and gathered to rank 0 as (route, query rows, keys,
    position of the first row), in call order."""
    from repro_torch.configs import get_arch
    from repro_torch.models.sharding import ShardCtx
    from repro_torch.tree import tree_map

    cfg = reduced_cfg(get_arch, SPLIT_ARCH)
    f32 = tree_map(lambda x: x.float(), _fill(_own_params(SPLIT_ARCH, cfg), inputs,
                                              f"params/{SPLIT_ARCH}"))
    rec = {}
    with _AttentionRows() as calls:
        loss_case(ctx, inputs, out, SPLIT_ARCH)
        rec["train"], calls.calls = calls.calls, []
        out[f"serve/{SPLIT_ARCH}/f32/mesh"] = _logits_run(cfg, _placed(ctx, f32), ctx)
        rec["serve"] = calls.calls
    log, counters, _, _ = _serve_stream(cfg, ctx, "modeled")
    runs = {"modeled": {"log": log, "counters": counters}}
    if rank == 0:
        loss_single(inputs, out, SPLIT_ARCH)
        out[f"serve/{SPLIT_ARCH}/f32/single"] = _logits_run(cfg, f32, ShardCtx())
        log, counters, _, _ = _serve_stream(cfg, ShardCtx(), "modeled")
        runs["single"] = {"log": log, "counters": counters}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {"rank": rank, "tp_rank": ctx.mesh.get_local_rank("model"),
                                   "calls": rec})
    flags[f"split/{SPLIT_ARCH}"] = {"ranks": every, "train_seq": inputs["tokens"].shape[1],
                                    **runs}


def split_rows_problems(flags):
    """What is wrong with the attention calls ``split_heads_job`` recorded:
    in training and prefill each rank must run its own S / tp query rows
    (by 'model' coordinate) against all S keys, from their own first
    position, on the plain route and on the kernel's; a decode step runs
    its one query against the rank's own cap / tp cache slots of each
    layer (a ring of the window for a sliding-window layer)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import group_counts, group_pattern

    tp = 2                                  # the (2, 2) mesh's 'model' axis
    cfg = reduced_cfg(get_arch, SPLIT_ARCH)
    layers = cfg.num_layers
    n_groups, rem = group_counts(cfg)
    pat = group_pattern(cfg)
    cap = SERVE_KW["cache_cap"]
    widths = [cap if k == "A" else min(cfg.window_size, cap)
              for k in pat * n_groups + pat[:rem]]
    decode_want = [["slots", 1, w // tp, SERVE_PROMPT + i]
                   for i in range(SERVE_STEPS) for w in widths]
    split, bad = flags[f"split/{SPLIT_ARCH}"], []
    train_seq = split["train_seq"]
    for r in split["ranks"]:
        t, calls = r["tp_rank"], r["calls"]
        n = train_seq // tp
        if len(calls["train"]) < layers or any(
                c != ["plain", n, train_seq, t * n] for c in calls["train"]):
            bad.append(f"rank {r['rank']} train: {calls['train']}")
        prefill, decode = calls["serve"][:layers], calls["serve"][layers:]
        n = SERVE_PROMPT // tp
        if any(c != ["kernel", n, SERVE_PROMPT, t * n] for c in prefill):
            bad.append(f"rank {r['rank']} prefill: {prefill}")
        if len(widths) != layers or [list(c) for c in decode] != decode_want:
            bad.append(f"rank {r['rank']} decode: {decode}")
    return bad


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


def _own_params(arch, cfg):
    from repro_torch.models import init_params

    return init_params(cfg, device="cpu", seed=0)


def make_inputs(path):
    """The jobs' inputs: tokens, each arch's params from the port's init
    (seed 0, as f32 arrays) and a seeded ``moe_ffn_sharded`` case."""
    from repro_torch.configs import get_arch
    from repro_torch.tree import tree_flatten_with_paths

    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, 256, (4, 64)).astype(np.int32),
           # whisper's audio frames [B, S, d_model], a generator of their own
           "audio": np.random.default_rng(1).standard_normal((4, 64, 64)).astype(np.float32)}
    for arch in sorted(set(ARCHS) | set(SERVE_ARCHS) | {SPLIT_ARCH}):
        params = _own_params(arch, reduced_cfg(get_arch, arch))
        paths, leaves, _ = tree_flatten_with_paths(params)
        for p, x in zip(paths, leaves):
            out[f"params/{arch}/{p}"] = x.float().numpy()
    D, F, E, K, B, S = 32, 64, 8, 2, 4, 16
    out.update({
        "moe/router": (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32),
        "moe/w1": (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
        "moe/w3": (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
        "moe/w2": (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32),
        "moe/x": rng.standard_normal((B, S, D)).astype(np.float32),
        "moe/E": np.int32(E), "moe/K": np.int32(K),
        "moe/cf_nodrop": np.float32(8.0), "moe/cf_drop": np.float32(1.0),
    })
    np.savez(path, **out)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def port_checks(out, flags):
    """{check: passed} for the results of the ``sharding`` jobs held to the
    port on one device, with the bounds of ``test_torch_sharding.py``."""
    c = {}
    c["moe_ffn_sharded = dense (1e-5)"] = np.abs(
        out["moe/nodrop/out"] - out["moe/dense/out"]).max() < 1e-5
    c["moe_ffn_sharded drops"] = np.abs(
        out["moe/drop/out"] - out["moe/nodrop/out"]).max() > 1e-3
    c["moe on replicated operands (1e-6)"] = float(out["moe/replicated/err"]) < 1e-6
    for arch in ARCHS + (SPLIT_ARCH,):
        tol = 0.05 if arch == "olmoe-1b-7b" else 2e-3
        c[f"{arch} bf16 loss sharded = one device ({tol})"] = abs(
            float(out[f"bf16/sharded/{arch}"]) - float(out[f"bf16/single/{arch}"])) < tol
        one = [k for k in out if k.startswith(f"grads1/{arch}/")]
        if one:
            worst = max(rel_l2(out["grads" + k[len("grads1"):]], out[k]) for k in one)
            c[f"{arch} f32 grads sharded = one device (1e-4 L2)"] = worst < 1e-4
    for arch in PREFILL_ARCHS:
        c[f"{arch} f32 prefill logits, batch over 'data' = one device (1e-4)"] = (
            _logits_close(out[f"prefill/{arch}/mesh"], out[f"prefill/{arch}/single"], arch))
    c["trainer losses (1e-5)"] = len(out["trainer/sharded/losses"]) == 2 and np.abs(
        out["trainer/sharded/losses"] - out["trainer/single/losses"]).max() < 1e-5
    keys = [k for k in out if k.startswith("trainer/single/params/")]
    c["trainer params (1e-5 L2)"] = bool(keys) and max(
        rel_l2(out[k.replace("/single/", "/sharded/")], out[k]) for k in keys) < 1e-5
    c["microbatch loss (1e-5)"] = abs(
        float(out["mb2/sharded/loss"]) - float(out["mb2/single/loss"])) < 1e-5
    keys = [k for k in out if k.startswith("mb2/single/params/")]
    c["microbatch params (1e-5 L2)"] = bool(keys) and max(
        rel_l2(out[k.replace("/single/", "/sharded/")], out[k]) for k in keys) < 1e-5
    for f in ("restore_22_on_41_exact", "restore_1_on_22_exact", "resume_41_exact",
              "guard_raises", "guard_passes_plain"):
        c[f] = flags.get(f) is True
    c["resume at step 2"] = flags.get("resume_41_step") == 2
    for arch in SERVE_ARCHS:
        runs = flags[f"serve/{arch}"]
        single = runs["f32_single"]
        c[f"{arch} server: modeled = real (log, counters, tokens)"] = (
            runs["modeled"]["log"] == runs["real"]["log"]
            and runs["modeled"]["counters"] == runs["real"]["counters"]
            and runs["modeled"]["tokens"] == runs["real"]["tokens"]
            and runs["modeled"]["counters"]["swap_ins"] >= 1)
        c[f"{arch} server f32: tokens, log, counters = one device"] = (
            runs["f32"]["tokens"] == single["tokens"] and len(single["tokens"]) == 12
            and runs["f32"]["log"] == single["log"]
            and runs["f32"]["counters"] == single["counters"])
        c[f"{arch} server on DTensors"] = (runs["real"]["params_dtensor"] is True
                                           and runs["real"]["dtensor_leaves"] is True)
        t, o = out[f"serve/{arch}/f32/mesh"], out[f"serve/{arch}/f32/single"]
        c[f"{arch} f32 prefill/decode logits = one device (1e-4)"] = _logits_close(
            t, o, arch)
        tol = BF16_LOGITS_TOL[arch]
        c[f"{arch} bf16 prefill/decode logits = one device ({tol})"] = (
            _logits_close(out[f"serve/{arch}/bf16/mesh"], out[f"serve/{arch}/bf16/single"],
                          arch, tol)
            and all(m < BF16_TIE for m in flags[f"serve/{arch}/bf16/flips"]))
    c["olmoe-1b-7b decode: K4 on each rank's block, experts in place"] = (
        not expert_block_problems(flags))
    c["K3 GQA heads at tp = 2"] = (float(out["gqa/gqa/err"]) < 1e-6
                                   and float(out["gqa/gqa/naive_err"]) > 1e-2)
    c["K3 MQA heads at tp = 2"] = float(out["gqa/mqa/err"]) < 1e-6
    split = flags[f"split/{SPLIT_ARCH}"]
    c[f"{SPLIT_ARCH}: each rank attends its own query rows, or cache slots"] = (
        not split_rows_problems(flags))
    c[f"{SPLIT_ARCH} f32 prefill/decode logits = one device (1e-4)"] = _logits_close(
        out[f"serve/{SPLIT_ARCH}/f32/mesh"], out[f"serve/{SPLIT_ARCH}/f32/single"], SPLIT_ARCH)
    c[f"{SPLIT_ARCH} server: log, counters = one device"] = (
        split["modeled"]["log"] == split["single"]["log"]
        and split["modeled"]["counters"] == split["single"]["counters"])
    return c


def _logits_close(t, o, arch, tol=1e-4):
    from repro_torch.configs import get_arch

    V = reduced_cfg(get_arch, arch).vocab_size
    return all(np.abs(a - b).max() / np.abs(b).max() < tol
               for a, b in zip(t[..., :V], o[..., :V]))


def main(rank: int, world: int, store: str, src: str, outdir: str, jobs: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    out, flags = {}, {}
    times = {}
    if jobs == "psum":
        psum_job(world, rank, out)
    elif jobs == "bf16_readings":
        from repro_torch.launch.mesh import make_ctx, make_host_mesh

        bf16_readings(make_ctx(make_host_mesh(world, model_axis=2)), rank, outdir)
    else:
        from repro_torch.launch.mesh import make_ctx, make_host_mesh

        ctx = make_ctx(make_host_mesh(world, model_axis=2))
        work = os.path.join(outdir, "work")

        def timed(name, fn, *a):
            t0 = time.perf_counter()
            fn(*a)
            times[name] = time.perf_counter() - t0

        inputs = dict(np.load(src))

        def bridged(arch, cfg):
            from repro_torch.tree import tree_map

            like = _own_params(arch, cfg)
            return tree_map(lambda x, l: x.to(l.dtype),
                            _fill(like, inputs, f"params/{arch}"), like)

        timed("moe", moe_job, ctx, inputs, out)
        timed("loss", loss_jobs, ctx, inputs, out, rank)
        timed("prefill", prefill_jobs, ctx, inputs, out, rank)
        timed("trainer", trainer_and_checkpoint_jobs, ctx, world, work, rank, out, flags)
        timed("microbatch", microbatch_job, ctx, rank, out)
        guard_job(ctx, flags)
        mesh_jobs(flags)
        timed("serve", serve_jobs, ctx, rank, out, flags, bridged)
        timed("gqa", gqa_job, ctx, rank, out, flags)
        timed("split", split_heads_job, ctx, inputs, rank, out, flags)
        flags["seconds"] = times
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
