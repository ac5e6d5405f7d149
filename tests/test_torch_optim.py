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

``adamw_update`` on a tree of CPU tensors (DTensors on CPU ranks included)
takes the plain version (``kernels/adamw/ref.py``); on plain CUDA tensors it
takes the fused kernels (``csrc/adamw.cu``), and on CUDA DTensors their
update on each rank's local shards.  The card's cases
(marked ``cuda``; ``python -m pytest -m cuda tests/test_torch_optim.py`` on
the card, where JAX is absent and only they run) hold the kernels to the
plain version on the card: given the same clip factor, p, m and v equal bit
for bit over five steps; the fused grad norm within 1e-5 relative of
``global_norm`` (f64 partial sums against torch's f32 reductions); a CUDA
DTensor tree's update equal to the plain tree's.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as jopt
except ImportError:                   # the card's machine: only the cuda cases run
    jax = jnp = jopt = None

from repro_torch import optim as topt
from repro_torch.kernels.adamw import ops as kops
from repro_torch.kernels.adamw import ref as kref
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

SHAPES = {"a": (8, 16), "b": {"c": (4, 3, 5), "d": (33,)}, "e": [(16, 7), (2, 64)]}
STEPS, TOTAL, WARMUP = 5, 8, 2
DTYPES = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}


@pytest.fixture
def needs_jax():
    """The JAX reference (absent on the card's machine)."""
    pytest.importorskip("jax")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the AdamW kernels are CUDA C++ and run only there")
    return torch.device("cuda")


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
    jdt, tdt = getattr(jnp, DTYPES[dname][0]), DTYPES[dname][1]
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
def test_update_matches_reference_for_five_steps(needs_jax, variant, dname):
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
def test_cosine_schedule_matches_reference(needs_jax, warmup, total):
    steps = [0, 1, 2, warmup, warmup + 1, total // 2, total - 1, total, total + 7]
    for s in steps:
        t = topt.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                 warmup=warmup, total=total)
        j = jopt.cosine_schedule(jnp.asarray(s, jnp.int32), warmup=warmup, total=total)
        assert t.dtype == torch.float32
        assert abs(float(t) - float(j)) <= 1e-6 * max(1.0, abs(float(j))), s


def test_global_norm_matches_reference_over_mixed_dtypes(needs_jax):
    rng = np.random.default_rng(2)
    tree = _build(SHAPES, rng, 3.0)
    tj = {"x": _to_jax(tree, jnp.bfloat16), "y": _to_jax(tree, jnp.float32)}
    tt = {"x": _to_torch(tree, torch.bfloat16), "y": _to_torch(tree, torch.float32)}
    t, j = topt.global_norm(tt), jopt.global_norm(tj)
    assert t.dtype == torch.float32 and t.ndim == 0
    assert rel_err(t, j) < 1e-6


def test_quantizers_round_half_to_even_like_the_reference(needs_jax):
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


# ----------------------------------------------------------- the fused path
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _tree_on(device, pdt, gdt, shapes=SHAPES, seed=4):
    """(params, grads) on ``device``: params in ``pdt``, grads in ``gdt``."""
    rng = np.random.default_rng(seed)
    p = _to_torch(_build(shapes, rng, 0.5), pdt)
    g = _to_torch(_build(shapes, rng, 0.1), gdt)
    return tree_map(lambda x: x.to(device), p), tree_map(lambda x: x.to(device), g)


def test_cpu_tree_takes_the_plain_version_and_launches_nothing(monkeypatch):
    """CPU tensors never reach the kernels' library: the update is the plain
    version's, bit for bit, and ``launches`` stays where it was."""
    def no_library():
        raise AssertionError("a CPU tree reached the kernels")

    monkeypatch.setattr(kops, "_lib", no_library)
    before = kops.adamw_fused.launches
    for pdt, gdt in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                     (torch.float32, torch.float32)):
        p, g = _tree_on("cpu", pdt, gdt)
        s = topt.adamw_init(p)
        cfg = topt.AdamWConfig(lr=1e-2)
        new_p, new_s, met = topt.adamw_update(g, s, p, cfg, 0.5)
        step, b1c, b2c, lr = tadamw._schedule(s, cfg, 0.5)
        want = kref.adamw_ref(tree_leaves(g), tree_leaves(s["m"]), tree_leaves(s["v"]),
                              tree_leaves(p), b1c, b2c, lr, grad_clip=cfg.grad_clip, **HYPER)
        got = (tree_leaves(new_p), tree_leaves(new_s["m"]), tree_leaves(new_s["v"]))
        for gs, ws in zip(got, want[:3]):
            assert all(torch.equal(a, b) for a, b in zip(gs, ws))
        assert torch.equal(met["grad_norm"], want[3])
        assert int(new_s["step"]) == int(step) == 1
    assert kops.adamw_fused.launches == before


@pytest.mark.parametrize("kind", ["cpu", "dtensor", "meta"])
def test_update_path_follows_tensor_type_and_device(monkeypatch, kind):
    """The path is chosen from the tensors alone: a CPU tree goes to the
    plain version, a tree on any other device to ``adamw_fused`` (which
    raises where there is no card), a tree of DTensors on CPU ranks to the
    plain version, whose results equal the plain tree's."""
    calls = []
    for name in ("adamw_fused", "adamw_ref"):
        fn = getattr(tadamw, name)
        monkeypatch.setattr(tadamw, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    p, g = _tree_on("cpu", torch.bfloat16, torch.bfloat16)
    cfg = topt.AdamWConfig(lr=1e-2)
    want_p, want_s, want_m = topt.adamw_update(g, topt.adamw_init(p), p, cfg)
    assert calls == ["adamw_ref"]
    calls.clear()
    if kind == "cpu":
        return
    if kind == "meta":
        p, g = (tree_map(lambda x: x.to("meta"), t) for t in (p, g))
        with pytest.raises(ValueError, match="CUDA"):
            topt.adamw_update(g, topt.adamw_init(p), p, cfg)
        assert calls == ["adamw_fused"]
        return
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_ctx, make_host_mesh
    from repro_torch.models.sharding import P, distribute
    started = init_process_group("cpu")
    try:
        ctx = make_ctx(make_host_mesh())
        d = lambda t: tree_map(lambda x: distribute(ctx, x, P(*[None] * x.ndim)), t)
        pd, gd = d(p), d(g)
        got_p, got_s, got_m = topt.adamw_update(gd, d(topt.adamw_init(p)), pd, cfg)
        assert calls == ["adamw_ref"]
        for a, b in zip(tree_leaves((got_p, got_s["m"], got_s["v"], got_m["grad_norm"])),
                        tree_leaves((want_p, want_s["m"], want_s["v"], want_m["grad_norm"]))):
            assert torch.equal(a.full_tensor(), b)
    finally:
        if started:
            dist.destroy_process_group()


def _dtensor_tree(ctx, p, g):
    """(params, grads, state) of ``p`` and ``g`` as DTensors on ``ctx``'s
    mesh: leaf "a" split over 'data', the rest replicated; grad "d" a
    partial sum over 'data', as backward may leave one."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.models.sharding import P, distribute
    spec = lambda path, x: P("data", *[None] * (x.ndim - 1)) if path == "a" \
        else P(*[None] * x.ndim)
    d = lambda t: {k: (d(v) if isinstance(v, dict) else
                       [distribute(ctx, x, spec(k, x)) for x in v] if isinstance(v, list)
                       else distribute(ctx, v, spec(k, v))) for k, v in t.items()}
    pd, gd, sd = d(p), d(g), topt.adamw_init(p)
    sd = {"m": d(sd["m"]), "v": d(sd["v"]), "step": sd["step"]}
    gd["b"]["d"] = DTensor.from_local(g["b"]["d"], ctx.mesh, [Partial(), Replicate()],
                                      run_check=False)
    return pd, gd, sd


def test_dtensor_shards_take_the_update_with_the_trees_norm(monkeypatch):
    """``_on_shards`` (the path of CUDA DTensors) on CPU ranks, the kernels
    stood in for by the plain version on the same local shards given the
    norm passed in: the whole tree's norm goes in, each leaf in its param's
    layout (the partial grad summed first), and the results come back as
    DTensors of the params' layouts, equal to the plain tree's update."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_ctx, make_host_mesh
    seen = []

    def stand_in(g, m, v, p, b1c, b2c, lr, *, grad_clip, gnorm, **hyper):
        seen.append((gnorm, [type(x) for x in g + m + v + p]))
        out = kref.adamw_apply_ref(g, m, v, p, kref.clip_factor(gnorm, grad_clip), b1c, b2c,
                                   lr, **hyper)
        return (*out, gnorm)

    monkeypatch.setattr(tadamw, "adamw_fused", stand_in)
    p, g = _tree_on("cpu", torch.bfloat16, torch.float32)
    cfg = topt.AdamWConfig(lr=1e-2)
    want_p, want_s, want_m = topt.adamw_update(g, topt.adamw_init(p), p, cfg)
    started = init_process_group("cpu")
    try:
        pd, gd, sd = _dtensor_tree(make_ctx(make_host_mesh()), p, g)
        step, b1c, b2c, lr = tadamw._schedule(sd, cfg, 1.0)
        leaves = [tree_leaves(t) for t in (gd, sd["m"], sd["v"], pd)]
        new_p, new_m, new_v, gnorm = tadamw._on_shards(
            *leaves, b1c, b2c, lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
            weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)
        assert len(seen) == 1 and all(t is torch.Tensor for t in seen[0][1])
        assert torch.equal(seen[0][0], want_m["grad_norm"])
        assert torch.equal(gnorm.full_tensor(), want_m["grad_norm"])
        for got, want, like in ((new_p, want_p, leaves[3]), (new_m, want_s["m"], leaves[3]),
                                (new_v, want_s["v"], leaves[3])):
            for a, b, x in zip(got, tree_leaves(want), like):
                assert a.placements == x.placements and a.shape == x.shape
                assert torch.equal(a.full_tensor(), b)
    finally:
        if started:
            dist.destroy_process_group()


def _many_leaves(n, seed=5):
    """``n`` leaves of 1 to 300 elements (most not a multiple of 8)."""
    rng = np.random.default_rng(seed)
    return [(int(k),) for k in rng.integers(1, 300, size=n)]


# leaves: odd lengths; one over several 32,768-element chunks with a ragged end
CARD_SHAPES = {"a": (8, 16), "b": {"c": (4, 3, 5), "d": (33,)}, "e": [(16, 7), (2, 64)],
               "f": (3, 40_001), "g": (1,)}
CARD_TREES = {"shapes": CARD_SHAPES, "many": _many_leaves(50)}
DT = {"bf16": torch.bfloat16, "f32": torch.float32}


def _unaligned(x):
    """``x`` as a contiguous view 4 bytes past an aligned allocation (the
    kernels take such a leaf element by element)."""
    base = torch.empty(x.numel() * x.element_size() + 4, dtype=torch.uint8, device=x.device)
    view = base[4:].view(x.dtype).view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(CARD_TREES))
@pytest.mark.parametrize("gname", sorted(DT))
@pytest.mark.parametrize("pname", sorted(DT))
def test_kernel_update_equals_plain_bit_for_bit_on_card(cuda_device, pname, gname, tree):
    """Five steps from the same state: given the same clip factor, the
    kernels' p, m and v equal the plain version's on the card bit for bit,
    for bf16 and f32 params and grads, leaves of odd lengths, a leaf not
    16-byte aligned, and (``many``) more leaves than one table; the learning
    rate a tensor and a number.  Even steps take both passes (the plain
    version given the clip of the fused norm), odd ones the update alone
    given the plain version's norm, as a sharded tree's local shards do."""
    shapes = CARD_TREES[tree]
    p, _ = _tree_on(cuda_device, DT[pname], DT[gname], shapes)
    p = tree_leaves(p)
    p[1] = _unaligned(p[1])
    m = [torch.zeros(x.shape, dtype=torch.float32, device=cuda_device) for x in p]
    v = [x.clone() for x in m]
    kp, km, kv = p, m, v
    state = {"step": torch.zeros((), dtype=torch.int32, device=cuda_device)}
    cfg = topt.AdamWConfig(lr=1e-2)
    for i in range(STEPS):
        _, g = _tree_on(cuda_device, DT[pname], DT[gname], shapes, seed=10 + i)
        g = tree_leaves(g)
        scale = (topt.cosine_schedule(state["step"] + 1, warmup=WARMUP, total=TOTAL)
                 if i % 2 == 0 else 0.7)
        step, b1c, b2c, lr = tadamw._schedule(state, cfg, scale)
        given = None if i % 2 == 0 else kref.global_norm_ref(g)
        *got, gnorm = kops.adamw_fused(g, km, kv, kp, b1c, b2c, lr, grad_clip=cfg.grad_clip,
                                       gnorm=given, **HYPER)
        assert given is None or gnorm is given
        clip = kref.clip_factor(gnorm, cfg.grad_clip)
        want = kref.adamw_apply_ref(g, m, v, p, clip, b1c, b2c, lr, **HYPER)
        torch.cuda.synchronize()
        for k, (gs, ws) in enumerate(zip(got, want)):
            for j, (a, b) in enumerate(zip(gs, ws)):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert torch.equal(a, b), (i, "pmv"[k], j)
        p, m, v = want
        kp, km, kv = got
        state["step"] = step


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(CARD_TREES))
@pytest.mark.parametrize("gname", sorted(DT))
def test_fused_grad_norm_matches_global_norm_on_card(cuda_device, gname, tree):
    """The fused norm is within 1e-5 relative of ``global_norm`` and gives
    the same bits on a second run; the update uses the plain formula's clip
    factor of that norm, clipping (1e-3) or not (1e3); one launch a table of
    leaves for each pass."""
    p, g = _tree_on(cuda_device, torch.bfloat16, DT[gname], CARD_TREES[tree])
    p, g = tree_leaves(p), tree_leaves(g)
    m = [torch.zeros(x.shape, dtype=torch.float32, device=cuda_device) for x in p]
    one = torch.ones((), device=cuda_device)
    b1c, b2c = one * 0.1, one * 0.05
    before = kops.adamw_fused.launches
    for grad_clip in (1e3, 1e-3):
        *got, gnorm = kops.adamw_fused(g, m, m, p, b1c, b2c, 1e-2, grad_clip=grad_clip, **HYPER)
        *_, again = kops.adamw_fused(g, m, m, p, b1c, b2c, 1e-2, grad_clip=grad_clip, **HYPER)
        want = topt.global_norm(g)
        clip = kref.clip_factor(gnorm, grad_clip)
        plain = kref.adamw_apply_ref(g, m, m, p, clip, b1c, b2c, 1e-2, **HYPER)
        torch.cuda.synchronize()
        assert gnorm.dtype == torch.float32 and gnorm.ndim == 0
        assert abs(float(gnorm) - float(want)) <= 1e-5 * float(want)
        assert torch.equal(gnorm, again)
        assert (float(clip) == 1.0) == (grad_clip == 1e3)
        assert all(torch.equal(a, b) for gs, ws in zip(got, plain) for a, b in zip(gs, ws))
    tables = -(-len(g) // 48)
    assert kops.adamw_fused.launches == before + 8 * tables


@pytest.mark.cuda
def test_fused_update_leaves_its_arguments_unchanged_on_card(cuda_device):
    p, g = _tree_on(cuda_device, torch.bfloat16, torch.float32, CARD_SHAPES)
    s = topt.adamw_init(p)
    s["m"] = tree_map(lambda x: torch.full_like(x, 1e-3), s["m"])
    before = [x.clone() for x in tree_leaves((p, g, s))]
    new_p, new_s, _ = topt.adamw_update(g, s, p, topt.AdamWConfig(lr=1e-2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves((p, g, s))))
    assert int(new_s["step"]) == 1 and int(s["step"]) == 0
    assert all(not torch.equal(a, b) for a, b in zip(tree_leaves(new_p), tree_leaves(p)))


@pytest.mark.cuda
def test_cell_tree_takes_two_launches_a_step_on_card(cuda_device):
    """internlm2-1.8b's tree (12 leaves; its reduced widths) through
    ``adamw_update``: two launches a step, finite norms, every param moved,
    and each step's result the plain version's given the kernel's clip."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    params = init_params(get_arch("internlm2-1.8b").reduced(), device=cuda_device)
    assert len(tree_leaves(params)) == 12
    state = topt.adamw_init(params)
    cfg = topt.AdamWConfig(lr=1e-2)            # moves the norm scales' 1.0 in bf16
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6)
    for _ in range(3):
        grads = tree_map(lambda x: (1e-2 * torch.randn(x.shape, generator=gen,
                                                       device=cuda_device)).to(x.dtype),
                         params)
        before = kops.adamw_fused.launches
        new_p, new_s, met = topt.adamw_update(grads, state, params, cfg)
        assert kops.adamw_fused.launches == before + 2
        _, b1c, b2c, lr = tadamw._schedule(state, cfg, 1.0)
        clip = kref.clip_factor(met["grad_norm"], cfg.grad_clip)
        want = kref.adamw_apply_ref(*(tree_leaves(t) for t in (grads, state["m"], state["v"],
                                                              params)),
                                    clip, b1c, b2c, lr, **HYPER)
        got = [tree_leaves(t) for t in (new_p, new_s["m"], new_s["v"])]
        assert all(torch.equal(a, b) for gs, ws in zip(got, want) for a, b in zip(gs, ws))
        assert bool(torch.isfinite(met["grad_norm"]))
        assert all(not torch.equal(a, b) for a, b in zip(tree_leaves(new_p),
                                                         tree_leaves(params)))
        params, state = new_p, new_s


@pytest.mark.cuda
def test_cuda_dtensor_tree_update_equals_the_plain_trees_on_card(cuda_device):
    """A tree of DTensors on the card (world size 1 over NCCL; a leaf split
    over 'data', a partial grad) takes the update kernel on its local
    shards, one launch a step (DTensor takes the norm): with nothing clipped
    p, m and v equal the plain CUDA tree's bit for bit over three steps;
    clipped, they equal the plain version's given the clip of the DTensor
    norm; the norm within 1e-6 relative of ``global_norm``'s."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_ctx, make_host_mesh
    started = init_process_group(cuda_device)
    try:
        ctx = make_ctx(make_host_mesh())
        for grad_clip in (1e3, 1e-3):
            cfg = topt.AdamWConfig(lr=1e-2, grad_clip=grad_clip)
            p, _ = _tree_on(cuda_device, torch.bfloat16, torch.bfloat16, CARD_SHAPES)
            s = topt.adamw_init(p)
            pd, _, sd = _dtensor_tree(ctx, p, p)
            for i in range(3):
                _, g = _tree_on(cuda_device, torch.bfloat16, torch.float32, CARD_SHAPES,
                                seed=20 + i)
                _, gd, _ = _dtensor_tree(ctx, p, g)
                before = kops.adamw_fused.launches
                new_pd, new_sd, met_d = topt.adamw_update(gd, sd, pd, cfg)
                assert kops.adamw_fused.launches == before + 1
                gnorm = met_d["grad_norm"].full_tensor()
                want_norm = topt.global_norm(g)
                assert abs(float(gnorm) - float(want_norm)) <= 1e-6 * float(want_norm)
                if grad_clip == 1e3:
                    new_p, new_s, _ = topt.adamw_update(g, s, p, cfg)
                    want = [tree_leaves(t) for t in (new_p, new_s["m"], new_s["v"])]
                else:
                    _, b1c, b2c, lr = tadamw._schedule(s, cfg, 1.0)
                    want = kref.adamw_apply_ref(
                        *(tree_leaves(t) for t in (g, s["m"], s["v"], p)),
                        kref.clip_factor(gnorm, grad_clip), b1c, b2c, lr, **HYPER)
                    new_p = tree_unflatten(p, want[0])
                    new_s = {"m": tree_unflatten(p, want[1]),
                             "v": tree_unflatten(p, want[2]), "step": s["step"] + 1}
                got = [tree_leaves(t) for t in (new_pd, new_sd["m"], new_sd["v"])]
                for k, (gs, ws) in enumerate(zip(got, want)):
                    for j, (a, b, x) in enumerate(zip(gs, ws, tree_leaves(pd))):
                        assert a.placements == x.placements, (i, "pmv"[k], j)
                        assert torch.equal(a.full_tensor(), b), (grad_clip, i, "pmv"[k], j)
                p, s, pd, sd = new_p, new_s, new_pd, new_sd
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.cuda
def test_fused_wrapper_refuses_what_the_kernels_do_not_take_on_card(cuda_device):
    """A non-contiguous leaf, a float16 one, a leaf on another device, a
    param that requires grad, a moment of another shape: each raises before
    any launch."""
    p, g = _tree_on(cuda_device, torch.bfloat16, torch.bfloat16)
    s = topt.adamw_init(p)
    cfg = topt.AdamWConfig()
    cases = {
        "contiguous": (ValueError, lambda: {**p, "a": p["a"].t().contiguous().t()}, None),
        "float16": (TypeError, lambda: {**p, "a": p["a"].half()}, None),
        "device": (ValueError, lambda: p, lambda: {**g, "a": g["a"].cpu()}),
        "no backward": (RuntimeError,
                        lambda: {**p, "a": p["a"].detach().clone().requires_grad_(True)}, None),
    }
    before = kops.adamw_fused.launches
    for match, (exc, params, grads) in cases.items():
        pp = params()
        gg = grads() if grads is not None else g
        ss = topt.adamw_init(pp) if pp is not p else s
        with pytest.raises(exc, match=match):
            topt.adamw_update(gg, ss, pp, cfg)
    with pytest.raises(ValueError, match="differ"):
        kops.adamw_fused(tree_leaves(g), tree_leaves(s["m"])[::-1], tree_leaves(s["v"]),
                         tree_leaves(p), torch.ones((), device=cuda_device),
                         torch.ones((), device=cuda_device), 1e-3, grad_clip=1.0, **HYPER)
    with pytest.raises(ValueError, match="contiguous"):
        kops.adamw_fused([g["a"].t()], [s["m"]["a"].t()], [s["v"]["a"].t()], [p["a"].t()],
                         torch.ones((), device=cuda_device), torch.ones((), device=cuda_device),
                         1e-3, grad_clip=1.0, **HYPER)
    with pytest.raises(ValueError, match="CUDA"):
        kops.adamw_fused(*[[x.cpu() for x in tree_leaves(t)] for t in (g, s["m"], s["v"], p)],
                         torch.ones(()), torch.ones(()), 1e-3, grad_clip=1.0, **HYPER)
    assert kops.adamw_fused.launches == before
