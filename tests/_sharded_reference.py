"""The JAX reference's sharded results for ``test_torch_sharding.py`` and
``test_torch_compression.py``, computed in a process of its own (the
forced host device count must not leak into other tests).

    python tests/_sharded_reference.py <inputs.npz> <out.npz>

XLA may otherwise skip the rounding of a bf16 intermediate (the
embedding's bf16 cast, whose cotangent is rounded to bf16 op by op).
The ``serve`` case runs the reference's ``DiffusionServer(ctx=)`` on the
stream of ``_torch_sharded_jobs.serve_prompts`` on the bridged bf16
weights, and its jitted prefill and decode steps under the mesh on the
same weights in f32.  ``_torch_sharded_jobs.SPLIT_ARCH`` (query heads that
do not divide over 'model') joins the loss and the serve cases.  The mesh is built with ``jax.sharding.Mesh`` (``Auto`` axes): under jax
0.9, ``jax.make_mesh`` gives ``Explicit`` axes, on which the reference's
``with_sharding_constraint`` calls refuse to run.  Inputs and outputs are
flat npz files keyed ``<case>/<path>``.
"""

import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models import init_params, make_loss_fn, make_prefill_step  # noqa: E402
from repro.models.moe import moe_ffn_sharded  # noqa: E402
from repro.models.sharding import ShardCtx, tree_shardings  # noqa: E402

from _torch_sharded_jobs import ARCHS, PREFILL_ARCHS  # noqa: E402


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


class _loop_scans:
    """Within: a ``lax.scan`` whose carry starts in bf16 (the layer stack's
    residual) runs as a Python loop, as every scan does under
    ``jax.disable_jit()``, so f32 params may turn that carry into f32 (the
    compiled scan refuses a carry that changes dtype) while the step stays
    one jitted program; the other scans (f32 carries) stay compiled."""

    def __enter__(self):
        self.scan = scan = jax.lax.scan

        def pick(f, init, *a, **k):
            bf16 = any(x.dtype == jnp.bfloat16 for x in jax.tree_util.tree_leaves(init))
            return (_python_scan if bf16 else scan)(f, init, *a, **k)

        jax.lax.scan = pick

    def __exit__(self, *exc):
        jax.lax.scan = self.scan


def _python_scan(f, init, xs=None, length=None, reverse=False, **_):
    n = length if length is not None else jax.tree_util.tree_leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in (reversed(range(n)) if reverse else range(n)):
        carry, y = f(carry, None if xs is None else
                     jax.tree_util.tree_map(lambda a: a[i], xs))
        ys.append(y)
    if reverse:
        ys.reverse()
    if jax.tree_util.tree_leaves(ys[0]) == []:
        return carry, ys[0]
    return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)


def _fill(like, inputs, prefix):
    """``like``'s tree with each leaf read from ``inputs[prefix/path]``."""
    return jax.tree_util.tree_map_with_path(
        lambda kp, _: jnp.asarray(inputs[f"{prefix}/{_path(kp)}"]), like)


def main(src: str, dst: str) -> None:
    inputs = dict(np.load(src))
    out = {}
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    ctx = ShardCtx(mesh=mesh, dp_axes=("data",), tp_axis="model")

    # sharded loss and grads, f32 params
    tokens = jnp.asarray(inputs["tokens"], jnp.int32)
    shape = ShapeConfig("t", "train", tokens.shape[1], tokens.shape[0])
    from _torch_sharded_jobs import SPLIT_ARCH, reduced_cfg

    for arch in ARCHS + (SPLIT_ARCH,):
        cfg = reduced_cfg(get_arch, arch)
        like = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
        params = _fill(like, inputs, f"params/{arch}")
        loss_fn = make_loss_fn(cfg, shape, ctx)
        batch = {"tokens": tokens}
        if cfg.encoder_layers:
            batch["audio_embeds"] = jnp.asarray(inputs["audio"])
        vg = jax.jit(jax.value_and_grad(lambda p, b=batch: loss_fn(p, b), has_aux=True))
        with _loop_scans():
            (loss, ex), grads = vg(jax.device_put(params, tree_shardings(ctx, params)))
        out[f"loss/{arch}"] = np.asarray(loss)
        out[f"aux/{arch}"] = np.asarray(ex.get("aux", 0.0))
        for kp, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[f"grads/{arch}/{_path(kp)}"] = np.asarray(g, np.float32)

    # f32 prefill of the same tokens, the batch split over 'data'
    pshape = ShapeConfig("p", "prefill", tokens.shape[1], tokens.shape[0])
    for arch in PREFILL_ARCHS:
        cfg = reduced_cfg(get_arch, arch)
        like = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
        params = _fill(like, inputs, f"params/{arch}")
        with _loop_scans():
            logits, _ = jax.jit(make_prefill_step(cfg, pshape, ctx))(
                jax.device_put(params, tree_shardings(ctx, params)), {"tokens": tokens})
        out[f"prefill/{arch}/ref"] = np.asarray(logits, np.float32)

    # moe_ffn_sharded, without and with capacity drops
    p = {"router": jnp.asarray(inputs["moe/router"]),
         "experts": {k: jnp.asarray(inputs[f"moe/{k}"]) for k in ("w1", "w3", "w2")}}
    x = jnp.asarray(inputs["moe/x"])
    E, K = int(inputs["moe/E"]), int(inputs["moe/K"])
    for name in ("nodrop", "drop"):
        cf = float(inputs[f"moe/cf_{name}"])
        y, aux = jax.jit(lambda pp, xx: moe_ffn_sharded(
            pp, xx, n_experts=E, top_k=K, capacity_factor=cf, ctx=ctx))(p, x)
        out[f"moe/{name}/out"] = np.asarray(y)
        out[f"moe/{name}/aux"] = np.asarray(aux)

    serve_case(inputs, out, ctx)
    np.savez(dst, **out)


def serve_case(inputs, out, ctx):
    import json

    from _torch_sharded_jobs import (SERVE_ARCHS, SERVE_COUNTERS, SERVE_KW,
                                     SERVE_PROMPT, SPLIT_ARCH, reduced_cfg,
                                     serve_prompts, serve_tokens)
    from repro.models import cache_init
    from repro.runtime.serve_loop import DiffusionServer, _merge_prefill_caches

    for arch in SERVE_ARCHS + (SPLIT_ARCH,):
        cfg = reduced_cfg(get_arch, arch)
        like = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
        f32 = _fill(like, inputs, f"params/{arch}")
        bf16 = jax.tree_util.tree_map(lambda x, l: x.astype(l.dtype), f32, like)
        srv = DiffusionServer(cfg, ctx=ctx, **SERVE_KW)
        srv.params = bf16                   # the port's weights, bit for bit
        prompt, forced = serve_tokens(cfg.vocab_size)
        params = jax.device_put(f32, tree_shardings(ctx, f32))
        with _loop_scans():
            logits, pre = srv.prefill_fn(params, {"tokens": jnp.asarray(prompt,
                                                                        jnp.int32)})
            caches = jax.tree_util.tree_map(
                lambda c: c.astype(jnp.float32), cache_init(cfg, 1, SERVE_KW["cache_cap"]))
            caches = _merge_prefill_caches(caches, pre, cfg)
            steps = [np.asarray(logits, np.float32)]
            for i, t in enumerate(forced):
                logits, caches = srv.decode_fn(params, {
                    "token": jnp.asarray([t], jnp.int32),
                    "pos": jnp.asarray(SERVE_PROMPT + i, jnp.int32),
                    "caches": caches})
                steps.append(np.asarray(logits, np.float32))
        out[f"serve/{arch}/f32/ref"] = np.stack(steps)
        srv.router.assignment_log = []
        for _ in range(2):
            for sid, p in serve_prompts(cfg.vocab_size).items():
                srv.submit(sid, p, max_new_tokens=2)
            srv.step()
        out[f"serve/{arch}/stream"] = np.asarray(json.dumps({
            "log": list(srv.router.assignment_log),
            "counters": {c: getattr(srv.stats, c) for c in SERVE_COUNTERS}}))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
