"""The port's AdamW (``repro_torch.optim``) against the reference's on
identical grads.

Params and five steps of grads are made with numpy from a seed and rounded
to the param dtype on each side (both round to nearest even); both sides
take the cosine schedule of their own package at each step.  Tolerances:
f32 moments, scales, grad norms and schedule values within 1e-6 relative
to the largest reference value (the same f32 arithmetic in the same order;
XLA and torch may still round a transcendental or a reduction order in the
last bit); f32 params the same; bf16 params within one bf16 ulp of the
reference's value (a last-bit difference in f32 may round the other way);
8-bit moment codes equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jopt
from repro_torch import optim as topt
from repro_torch.tree import tree_leaves, tree_map

SHAPES = {"a": (8, 16), "b": {"c": (4, 3, 5), "d": (33,)}, "e": [(16, 7), (2, 64)]}
STEPS, TOTAL, WARMUP = 5, 8, 2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _build(shapes, rng, scale):
    if isinstance(shapes, dict):
        return {k: _build(shapes[k], rng, scale) for k in sorted(shapes)}
    if isinstance(shapes, list):
        return [_build(s, rng, scale) for s in shapes]
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _to_jax(tree, dt):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dt), tree)


def _to_torch(tree, dt):
    return tree_map(lambda a: torch.from_numpy(a).to(dt), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32)) if jnp.issubdtype(x.dtype, jnp.floating) \
        else np.asarray(x)


def rel_err(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def assert_within_bf16_ulp(t, j):
    t, j = _np(t), _np(j)
    ulp = np.spacing(np.abs(j).astype(np.float32)) * 65536.0     # f32 -> bf16 ulp
    assert (np.abs(t - j) <= ulp).all(), np.abs(t - j).max()


def _run(variant, dname):
    jdt, tdt = DTYPES[dname]
    rng = np.random.default_rng(0)
    p0 = _build(SHAPES, rng, 0.5)
    grads = [_build(SHAPES, rng, 0.1 * (i + 1)) for i in range(STEPS)]
    cfg_j, cfg_t = jopt.AdamWConfig(lr=1e-2), topt.AdamWConfig(lr=1e-2)
    init_j, upd_j = ((jopt.adamw8bit_init, jopt.adamw8bit_update) if variant == "8bit"
                     else (jopt.adamw_init, jopt.adamw_update))
    init_t, upd_t = ((topt.adamw8bit_init, topt.adamw8bit_update) if variant == "8bit"
                     else (topt.adamw_init, topt.adamw_update))
    pj, pt = _to_jax(p0, jdt), _to_torch(p0, tdt)
    sj, st = init_j(pj), init_t(pt)
    history = []
    for g in grads:
        lj = jopt.cosine_schedule(sj["step"] + 1, warmup=WARMUP, total=TOTAL)
        lt = topt.cosine_schedule(st["step"] + 1, warmup=WARMUP, total=TOTAL)
        pj, sj, mj = upd_j(_to_jax(g, jdt), sj, pj, cfg_j, lj)
        pt, st, mt = upd_t(_to_torch(g, tdt), st, pt, cfg_t, lt)
        history.append((pj, sj, mj, pt, st, mt, lj, lt))
    return history


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("variant", ["f32", "8bit"])
def test_update_matches_reference_for_five_steps(variant, dname):
    for pj, sj, mj, pt, st, mt, lj, lt in _run(variant, dname):
        assert int(st["step"]) == int(sj["step"])
        assert st["step"].dtype == torch.int32 and st["step"].ndim == 0
        assert rel_err(lt, lj) < 1e-6
        assert rel_err(mt["grad_norm"], mj["grad_norm"]) < 1e-6
        for t, j in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
            assert t.dtype == DTYPES[dname][1]
            if dname == "bf16":
                assert_within_bf16_ulp(t, j)
            else:
                assert rel_err(t, j) < 1e-6
        if variant == "8bit":
            for k, dt in (("m", torch.int8), ("v", torch.uint8)):
                for t, j in zip(tree_leaves(st[k]), jax.tree_util.tree_leaves(sj[k])):
                    assert t.dtype == dt
                    assert np.array_equal(_np(t), _np(j)), k
            keys = ("ms", "vs")
        else:
            keys = ("m", "v")
        for k in keys:
            for t, j in zip(tree_leaves(st[k]), jax.tree_util.tree_leaves(sj[k])):
                assert t.dtype == torch.float32 and tuple(t.shape) == tuple(j.shape)
                assert rel_err(t, j) < 1e-6, k


def test_update_leaves_its_arguments_unchanged():
    rng = np.random.default_rng(1)
    p = _to_torch(_build(SHAPES, rng, 0.5), torch.bfloat16)
    g = _to_torch(_build(SHAPES, rng, 0.1), torch.bfloat16)
    for init, upd in ((topt.adamw_init, topt.adamw_update),
                      (topt.adamw8bit_init, topt.adamw8bit_update)):
        s = init(p)
        before = [x.clone() for x in tree_leaves((p, g, s))]
        new_p, new_s, _ = upd(g, s, p, topt.AdamWConfig(lr=1e-2))
        assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves((p, g, s))))
        assert int(new_s["step"]) == 1 and int(s["step"]) == 0
        assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(new_p),
                                                         tree_leaves(p)))


@pytest.mark.parametrize("warmup,total", [(1, 10), (100, 10_000), (3, 3), (0, 5)])
def test_cosine_schedule_matches_reference(warmup, total):
    steps = [0, 1, 2, warmup, warmup + 1, total // 2, total - 1, total, total + 7]
    for s in steps:
        t = topt.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                 warmup=warmup, total=total)
        j = jopt.cosine_schedule(jnp.asarray(s, jnp.int32), warmup=warmup, total=total)
        assert t.dtype == torch.float32
        assert abs(float(t) - float(j)) <= 1e-6 * max(1.0, abs(float(j))), s


def test_global_norm_matches_reference_over_mixed_dtypes():
    rng = np.random.default_rng(2)
    tree = _build(SHAPES, rng, 3.0)
    tj = {"x": _to_jax(tree, jnp.bfloat16), "y": _to_jax(tree, jnp.float32)}
    tt = {"x": _to_torch(tree, torch.bfloat16), "y": _to_torch(tree, torch.float32)}
    t, j = topt.global_norm(tt), jopt.global_norm(tj)
    assert t.dtype == torch.float32 and t.ndim == 0
    assert rel_err(t, j) < 1e-6


def test_quantizers_round_half_to_even_like_the_reference():
    # m / s lands exactly on .5 for these rows: both sides round to even
    m = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
    v = np.array([[255.0, 0.5, 1.5, 2.5, 3.5, 0.0]], np.float32)
    for (qt, st), (qj, sj) in ((topt.adamw._q_m(torch.from_numpy(m)), jopt._q_m(jnp.asarray(m))),
                               (topt.adamw._q_v(torch.from_numpy(v)), jopt._q_v(jnp.asarray(v)))):
        assert np.array_equal(_np(qt), _np(qj))
        assert np.array_equal(_np(st), _np(sj))
    assert _np(topt.adamw._q_m(torch.from_numpy(m))[0]).tolist() == [[127, 0, 2, 2, 0, -2]]


def test_update_frees_its_results_without_the_cycle_collector():
    """No reference cycle holds a step's trees: once the caller drops them,
    they are freed at once (a cycle would keep a full-width step's 19 GB of
    new params and moments alive until the collector happened to run)."""
    import gc
    import weakref
    rng = np.random.default_rng(3)
    p = _to_torch(_build(SHAPES, rng, 0.5), torch.bfloat16)
    g = _to_torch(_build(SHAPES, rng, 0.1), torch.bfloat16)
    enabled = gc.isenabled()
    gc.disable()
    try:
        for init, upd in ((topt.adamw_init, topt.adamw_update),
                          (topt.adamw8bit_init, topt.adamw8bit_update)):
            out = upd(g, init(p), p, topt.AdamWConfig())
            refs = [weakref.ref(t) for t in tree_leaves(out)]
            del out
            assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()
