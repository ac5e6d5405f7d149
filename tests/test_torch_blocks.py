"""The port's MoE, RG-LRU and RWKV6 blocks against the reference's jnp
functions on shared weights.

Inputs and weights are made with numpy from a seed and rounded to the
working type on each side (both round to nearest even).  Tolerances are
relative to the largest reference value: 2e-5 in float32 (summation order),
2e-2 in bfloat16 (where the two frameworks round intermediates).  Carried
states are compared beside the outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models import rwkv as jrw
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import rwkv as trw

DTYPES = ["f32", "bf16"]
TOL = {"f32": 2e-5, "bf16": 2e-2}


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def both(a, dtype):
    """(jax array, torch tensor) of one float32 numpy array in ``dtype``
    ("f32" or "bf16")."""
    bf = dtype == "bf16"
    return (jnp.asarray(a).astype(jnp.bfloat16 if bf else jnp.float32),
            torch.from_numpy(np.asarray(a, np.float32)).to(
                torch.bfloat16 if bf else torch.float32))


def tree_both(tree, dtype, f32_keys=()):
    """``both`` over a nested weight dict; leaves named in ``f32_keys`` stay
    float32 whatever ``dtype``, as the reference keeps them."""
    j, t = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            j[k], t[k] = tree_both(v, dtype, f32_keys)
        else:
            j[k], t[k] = both(v, "f32" if k in f32_keys else dtype)
    return j, t


def check(out_t, out_j, dtype, what=""):
    assert tuple(out_t.shape) == tuple(out_j.shape), what
    assert rel_err(_np(out_t), _np(out_j)) < TOL[dtype], what


# ------------------------------------------------------------------ MoE
def moe_weights(rng, D, Fd, E):
    return {
        "router": rng.standard_normal((D, E)).astype(np.float32) / np.sqrt(D),
        "experts": {
            "w1": rng.standard_normal((E, D, Fd)).astype(np.float32) / np.sqrt(D),
            "w3": rng.standard_normal((E, D, Fd)).astype(np.float32) / np.sqrt(D),
            "w2": rng.standard_normal((E, Fd, D)).astype(np.float32) / np.sqrt(Fd),
        },
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,E,K,factor", [
    (12, 4, 2, 1.25),       # reduced olmoe
    (40, 8, 2, 0.25),       # capacity drops: C = 8 slots for 10 per expert
    (1, 8, 8, 1.25),        # one decode token, every expert chosen
])
def test_moe_ffn(T, E, K, factor, dtype):
    rng = np.random.default_rng(0)
    D, Fd = 32, 48
    pj, pt = tree_both(moe_weights(rng, D, Fd, E), dtype, f32_keys=("router",))
    xj, xt = both(rng.standard_normal((T, D)).astype(np.float32), dtype)
    kw = dict(n_experts=E, top_k=K, capacity_factor=factor)
    out_j, aux_j = jmoe.moe_ffn(pj, xj, **kw)
    out_t, aux_t = tmoe.moe_ffn(pt, xt, **kw)
    check(out_t, out_j, dtype)
    assert abs(float(aux_t) - float(aux_j)) < 1e-5 * max(1.0, abs(float(aux_j)))


def test_moe_rank_positions_drop_past_capacity():
    """The stable rank of each assignment within its expert equals the
    reference's, and at capacity factor 0.25 some ranks pass the capacity
    (the (40, 8, 2, 0.25) case of ``test_moe_ffn`` holds the output of such
    drops to the reference)."""
    T, E, K = 40, 8, 2
    rng = np.random.default_rng(3)
    flat = rng.integers(0, E, T * K)
    pos_j = np.asarray(jmoe._rank_positions(jnp.asarray(flat), E))
    pos_t = tmoe._rank_positions(torch.from_numpy(flat)).numpy()
    assert np.array_equal(pos_t, pos_j)
    C = tmoe.capacity(T, K, E, 0.25)
    assert C == jmoe.capacity(T, K, E, 0.25) and (pos_t >= C).any()


@pytest.mark.parametrize("T,E,K,factor", [
    (12, 4, 2, 1.25), (40, 8, 2, 0.25), (1, 64, 8, 1.25), (16, 64, 8, 1.25)])
def test_moe_ffn_passes_fill_counts_to_every_gemm(monkeypatch, T, E, K, factor):
    """All three grouped GEMMs of an FFN get the same counts, int32 [E],
    equal to min(assignments per expert, C)."""
    rng = np.random.default_rng(1)
    D, Fd = 16, 24
    _, pt = tree_both(moe_weights(rng, D, Fd, E), "f32", f32_keys=("router",))
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    seen, real = [], tmoe.moe_gmm

    def spy(x, w, out_dtype=None, counts=None):
        seen.append(counts)
        return real(x, w, out_dtype, counts)

    monkeypatch.setattr(tmoe, "moe_gmm", spy)
    tmoe.moe_ffn(pt, x, n_experts=E, top_k=K, capacity_factor=factor)
    _, _, idx = tmoe._router(pt, x, K)
    C = tmoe.capacity(T, K, E, factor)
    want = np.minimum(np.bincount(idx.reshape(-1).numpy(), minlength=E), C)
    assert len(seen) == 3
    for counts in seen:
        assert counts.dtype == torch.int32 and counts.shape == (E,)
        assert np.array_equal(counts.numpy(), want)


@pytest.mark.parametrize("T,E,K,factor,seed", [
    (40, 8, 2, 0.25, 3), (64, 8, 4, 0.5, 4), (12, 4, 2, 1.25, 5), (1, 64, 8, 1.25, 6),
    (300, 16, 2, 0.25, 7)])
def test_moe_gather_reads_only_rows_below_fill(T, E, K, factor, seed):
    """Every row the gather reads lies below its expert's fill count: a
    dropped assignment is clipped to slot C-1 only in an expert whose fill is
    C, so the rows the kernel leaves at zero are never read back."""
    flat = torch.from_numpy(np.random.default_rng(seed).integers(0, E, T * K))
    C = tmoe.capacity(T, K, E, factor)
    pos = tmoe._rank_positions(flat)
    fill = torch.clamp(tmoe._expert_counts(flat, E), max=C)
    slot = torch.clamp(pos, 0, C - 1)
    assert bool((slot < fill[flat]).all())
    dropped = pos >= C
    assert bool((fill[flat[dropped]] == C).all())
    if factor < 1:
        assert bool(dropped.any())          # the drop case is exercised


# --------------------------------------------------------------- RG-LRU
def rglru_weights(rng, D, W, cw=4):
    return {
        "w_in": rng.standard_normal((D, W)).astype(np.float32) / np.sqrt(D),
        "w_gate_branch": rng.standard_normal((D, W)).astype(np.float32) / np.sqrt(D),
        "conv": rng.standard_normal((cw, W)).astype(np.float32) / 2,
        "w_a": rng.standard_normal((W, W)).astype(np.float32) / np.sqrt(W),
        "w_x": rng.standard_normal((W, W)).astype(np.float32) / np.sqrt(W),
        "lam": (0.65 + 0.1 * rng.standard_normal(W)).astype(np.float32),
        "out_proj": rng.standard_normal((W, D)).astype(np.float32) / np.sqrt(W),
    }


def rglru_state(rng, B, W, cw=4):
    return {"h": rng.standard_normal((B, W)).astype(np.float32),
            "conv": rng.standard_normal((B, cw - 1, W)).astype(np.float32)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [1, 2, 7])
def test_causal_conv1d_with_carry(T, dtype):
    rng = np.random.default_rng(1)
    B, W = 2, 24
    xj, xt = both(rng.standard_normal((B, T, W)).astype(np.float32), dtype)
    kj, kt = both(rng.standard_normal((4, W)).astype(np.float32), dtype)
    pj, pt = both(rng.standard_normal((B, 3, W)).astype(np.float32), dtype)
    oj, cj = jrg.causal_conv1d(xj, kj, pj)
    ot, ct = trg.causal_conv1d(xt, kt, pt)
    check(ot, oj, dtype)
    check(ct, cj, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [1, 9])
def test_rglru_block_apply_with_state(T, dtype):
    rng = np.random.default_rng(2)
    B, D, W = 2, 32, 24
    pj, pt = tree_both(rglru_weights(rng, D, W), dtype, f32_keys=("lam",))
    st = rglru_state(rng, B, W)
    sj = {"h": jnp.asarray(st["h"]), "conv": both(st["conv"], dtype)[0]}
    s_t = {"h": torch.from_numpy(st["h"]), "conv": both(st["conv"], dtype)[1]}
    xj, xt = both(rng.standard_normal((B, T, D)).astype(np.float32), dtype)
    out_j, new_j = jrg.rglru_block_apply(pj, xj, sj)
    out_t, new_t = trg.rglru_block_apply(pt, xt, s_t)
    check(out_t, out_j, dtype, "out")
    check(new_t["h"], new_j["h"], dtype, "h")
    check(new_t["conv"], new_j["conv"], dtype, "conv")
    assert new_t["h"].dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_block_apply_long_prompt(dtype):
    """A prompt of 65 steps, four times the serving prefill, whose last group
    of the 8 steps a kernel thread loads together is ragged (the CPU path is
    the plain scan)."""
    rng = np.random.default_rng(3)
    B, D, W, T = 1, 16, 32, 65
    pj, pt = tree_both(rglru_weights(rng, D, W), dtype, f32_keys=("lam",))
    st = rglru_state(rng, B, W)
    sj = {"h": jnp.asarray(st["h"]), "conv": both(st["conv"], dtype)[0]}
    s_t = {"h": torch.from_numpy(st["h"]), "conv": both(st["conv"], dtype)[1]}
    xj, xt = both(rng.standard_normal((B, T, D)).astype(np.float32), dtype)
    out_j, new_j = jrg.rglru_block_apply(pj, xj, sj)
    out_t, new_t = trg.rglru_block_apply(pt, xt, s_t)
    check(out_t, out_j, dtype, "out")
    check(new_t["h"], new_j["h"], dtype, "h")


@pytest.mark.parametrize("T", [1, 9])
def test_rglru_block_gates_as_separate_tensor_ops_bit_for_bit(T):
    """On the CPU the block's fused gate entry computes exactly the chain of
    separate tensor operations (two sigmoids, softplus, exp, clamp, sqrt,
    products) that it replaced: the results are equal bit for bit."""
    rng = np.random.default_rng(4)
    B, D, W = 2, 32, 24
    _, p = tree_both(rglru_weights(rng, D, W), "bf16", f32_keys=("lam",))
    st = rglru_state(rng, B, W)
    state = {"h": torch.from_numpy(st["h"]), "conv": both(st["conv"], "bf16")[1]}
    x = both(rng.standard_normal((B, T, D)).astype(np.float32), "bf16")[1]
    xi, _ = trg.causal_conv1d(x @ p["w_in"], p["conv"], state["conv"])
    r = torch.sigmoid((xi @ p["w_a"]).to(torch.float32))
    i_gate = torch.sigmoid((xi @ p["w_x"]).to(torch.float32))
    a = torch.exp((-8.0 * torch.nn.functional.softplus(p["lam"]))[None, None, :] * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * (i_gate * xi.to(torch.float32))
    h, ys = state["h"], []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    y = torch.stack(ys, 1)
    gate = torch.nn.functional.gelu((x @ p["w_gate_branch"]).to(torch.float32),
                                    approximate="tanh")
    out, new = trg.rglru_block_apply(p, x, state)
    assert torch.equal(new["h"], h)
    assert torch.equal(out, (y * gate).to(x.dtype) @ p["out_proj"])


# ---------------------------------------------------------------- RWKV6
def timemix_weights(rng, D):
    L, LD = trw.LORA_MIX, trw.LORA_DECAY
    return {
        "mu": rng.uniform(0.2, 0.8, (5, D)).astype(np.float32),
        "mix_a": rng.standard_normal((D, 5 * L)).astype(np.float32) / np.sqrt(D),
        "mix_b": rng.standard_normal((5, L, D)).astype(np.float32) / np.sqrt(L),
        "wr": rng.standard_normal((D, D)).astype(np.float32) / np.sqrt(D),
        "wk": rng.standard_normal((D, D)).astype(np.float32) / np.sqrt(D),
        "wv": rng.standard_normal((D, D)).astype(np.float32) / np.sqrt(D),
        "wg": rng.standard_normal((D, D)).astype(np.float32) / np.sqrt(D),
        "wo": rng.standard_normal((D, D)).astype(np.float32) / np.sqrt(D),
        "w0": np.full((D,), -2.0, np.float32),
        "decay_a": rng.standard_normal((D, LD)).astype(np.float32) / np.sqrt(D),
        "decay_b": rng.standard_normal((LD, D)).astype(np.float32) / np.sqrt(LD),
        "u": rng.uniform(0.0, 1.0, D).astype(np.float32),
        "ln_out": {"scale": rng.uniform(0.5, 1.5, D).astype(np.float32)},
    }


TM_F32 = ("w0", "decay_b", "u")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [1, 8])
def test_timemix_apply_with_state(T, dtype):
    rng = np.random.default_rng(4)
    B, D, N = 2, 64, 16
    pj, pt = tree_both(timemix_weights(rng, D), dtype, f32_keys=TM_F32)
    xj, xt = both(rng.standard_normal((B, T, D)).astype(np.float32), dtype)
    shj, sht = both(rng.standard_normal((B, D)).astype(np.float32), dtype)
    s0 = 0.3 * rng.standard_normal((B, D // N, N, N)).astype(np.float32)
    out_j, shift_j, sT_j = jrw.timemix_apply(pj, xj, shj, jnp.asarray(s0), N)
    out_t, shift_t, sT_t = trw.timemix_apply(pt, xt, sht, torch.from_numpy(s0), N)
    check(out_t, out_j, dtype, "out")
    check(shift_t, shift_j, dtype, "shift")
    check(sT_t, sT_j, dtype, "state")
    if T == 1:
        o1, sh1, s1 = trw.timemix_step(pt, xt[:, 0], sht, torch.from_numpy(s0), N)
        assert torch.equal(o1, out_t[:, 0]) and torch.equal(s1, sT_t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_channelmix_apply(dtype):
    rng = np.random.default_rng(5)
    B, T, D, Fd = 2, 6, 32, 48
    w = {"mu_k": rng.uniform(0.2, 0.8, D).astype(np.float32),
         "mu_r": rng.uniform(0.2, 0.8, D).astype(np.float32),
         "wk": rng.standard_normal((D, Fd)).astype(np.float32) / np.sqrt(D),
         "wv": rng.standard_normal((Fd, D)).astype(np.float32) / np.sqrt(Fd),
         "wr": rng.standard_normal((D, D)).astype(np.float32) / np.sqrt(D)}
    pj, pt = tree_both(w, dtype)
    xj, xt = both(rng.standard_normal((B, T, D)).astype(np.float32), dtype)
    shj, sht = both(rng.standard_normal((B, D)).astype(np.float32), dtype)
    out_j, sh_j = jrw.channelmix_apply(pj, xj, shj)
    out_t, sh_t = trw.channelmix_apply(pt, xt, sht)
    check(out_t, out_j, dtype)
    check(sh_t, sh_j, dtype)


def wkv_inputs(B, T, H, N, seed=6):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(0.5 * rng.standard_normal((B, T, H, N)) - 2.0)).astype(np.float32)
    u = 0.3 * rng.standard_normal((H, N)).astype(np.float32)
    s0 = 0.2 * rng.standard_normal((B, H, N, N)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("T,chunk", [(64, 16), (48, 48)])
def test_wkv_chunked_matches_scan_and_reference(T, chunk):
    arrs = wkv_inputs(2, T, 2, 16)
    tt = [torch.from_numpy(a) for a in arrs]
    out_s, s_s = trw.wkv_scan(*tt)
    out_c, s_c = trw.wkv_chunked(*tt, chunk=chunk)
    assert rel_err(out_c.numpy(), out_s.numpy()) < 2e-5
    assert rel_err(s_c.numpy(), s_s.numpy()) < 2e-5
    out_j, s_j = jrw.wkv_scan(*(jnp.asarray(a) for a in arrs))
    assert rel_err(out_s.numpy(), out_j) < 2e-5
    assert rel_err(s_s.numpy(), s_j) < 2e-5


# ------------------------------------------------------- the train route
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [1, 16, 256])
def test_rglru_scan_value_and_grads_match_reference(T, dtype):
    """The train route's scan (a Python loop over time) against the
    reference's ``lax.scan`` under ``jax.grad``: y, hT and the grads of xi,
    r, i_gate, lam and h0."""
    import jax
    rng = np.random.default_rng(T)
    B, W = 2, 24
    xi = rng.standard_normal((B, T, W)).astype(np.float32)
    r = 1 / (1 + np.exp(-rng.standard_normal((B, T, W)))).astype(np.float32)
    ig = 1 / (1 + np.exp(-rng.standard_normal((B, T, W)))).astype(np.float32)
    lam = (0.65 + 0.1 * rng.standard_normal(W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    cy = rng.standard_normal((B, T, W)).astype(np.float32)
    ch = rng.standard_normal((B, W)).astype(np.float32)
    js = [both(a, dtype)[0] for a in (xi, r, ig)] + [jnp.asarray(lam), jnp.asarray(h0)]
    ts = [both(a, dtype)[1].requires_grad_(True) for a in (xi, r, ig)] + [
        torch.from_numpy(a).requires_grad_(True) for a in (lam, h0)]

    def jloss(*a):
        y, hT = jrg.rglru_scan(*a)
        return jnp.sum(y * cy) + jnp.sum(hT * ch), (y, hT)

    (_, (y_j, h_j)), g_j = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                              has_aux=True)(*js)
    y_t, h_t = trg.rglru_scan(*ts)
    loss = (y_t * torch.from_numpy(cy)).sum() + (h_t * torch.from_numpy(ch)).sum()
    g_t = torch.autograd.grad(loss, ts)
    assert y_t.dtype == h_t.dtype == torch.float32
    check(y_t.detach(), y_j, dtype, "y")
    check(h_t.detach(), h_j, dtype, "hT")
    for name, t, j in zip(("xi", "r", "i_gate", "lam", "h0"), g_t, g_j):
        assert t.dtype == ts[("xi", "r", "i_gate", "lam", "h0").index(name)].dtype, name
        check(t, j, dtype, name)


def test_wkv_chunked_grads_match_reference():
    """Under grad mode each 128-step chunk runs checkpointed (two forward
    scans, two recomputed in backward); out, sT and the grads of r, k, v,
    w, u and s0 match ``jax.grad`` of the reference's ``wkv_chunked``
    within 1e-4 (f32).  ``u`` reaches every chunk, so its grad must be
    there and nonzero."""
    import jax
    T, chunk = 256, 128
    arrs = wkv_inputs(1, T, 2, 16, seed=9)
    rng = np.random.default_rng(10)
    co = rng.standard_normal(arrs[0].shape).astype(np.float32)
    cs = rng.standard_normal(arrs[5].shape).astype(np.float32)

    def jloss(*a):
        out, sT = jrw.wkv_chunked(*a, chunk=chunk)
        return jnp.sum(out * co) + jnp.sum(sT * cs), (out, sT)

    (_, (out_j, s_j)), g_j = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(*(jnp.asarray(a) for a in arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    calls, real = [], trw.wkv_scan

    def counting(*a):
        calls.append(a[0].shape[1])
        return real(*a)

    trw.wkv_scan = counting
    try:
        out_t, s_t = trw.wkv_chunked(*ts, chunk=chunk)
        loss = (out_t * torch.from_numpy(co)).sum() + (s_t * torch.from_numpy(cs)).sum()
        g_t = torch.autograd.grad(loss, ts, allow_unused=True)
    finally:
        trw.wkv_scan = real
    assert calls == [chunk] * 4
    assert rel_err(out_t.detach().numpy(), out_j) < 1e-4
    assert rel_err(s_t.detach().numpy(), s_j) < 1e-4
    for name, t, j in zip("r k v w u s0".split(), g_t, g_j):
        assert t is not None, name
        assert float(t.abs().max()) > 0, name
        assert rel_err(t.numpy(), j) < 1e-4, name


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_ffn_train_value_and_grads_match_reference(dtype):
    """``moe_ffn(train=True)``, the reference's einsum experts, at capacity
    factor 0.25 (C = 8 slots for 10 assignments an expert: drops): the
    output, the aux loss and the grads of x, the router and the three
    expert weights against ``jax.grad`` of the reference's ``moe_ffn``."""
    import jax
    T, E, K, factor = 40, 8, 2, 0.25
    rng = np.random.default_rng(11)
    D, Fd = 32, 48
    pj, pt = tree_both(moe_weights(rng, D, Fd, E), dtype, f32_keys=("router",))
    x = rng.standard_normal((T, D)).astype(np.float32)
    xj, xt = both(x, dtype)
    cot = rng.standard_normal((T, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, capacity_factor=factor)
    C = tmoe.capacity(T, K, E, factor)
    _, _, idx = tmoe._router(pt, xt, K)
    assert (np.bincount(idx.reshape(-1).numpy(), minlength=E) > C).any()

    def jloss(p, x_):
        out, aux = jmoe.moe_ffn(p, x_, **kw)
        return jnp.sum(out.astype(jnp.float32) * cot) + aux, (out, aux)

    (_, (out_j, aux_j)), (gp_j, gx_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(pj, xj)
    leaves = [pt["router"]] + [pt["experts"][k] for k in ("w1", "w3", "w2")] + [xt]
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    p = {"router": leaves[0], "experts": dict(zip(("w1", "w3", "w2"), leaves[1:4]))}
    out_t, aux_t = tmoe.moe_ffn(p, leaves[4], train=True, **kw)
    loss = (out_t.float() * torch.from_numpy(cot)).sum() + aux_t
    g_t = torch.autograd.grad(loss, leaves)
    check(out_t.detach(), out_j, dtype, "out")
    assert abs(float(aux_t.detach()) - float(aux_j)) < 1e-5 * max(1.0, abs(float(aux_j)))
    want = [gp_j["router"]] + [gp_j["experts"][k] for k in ("w1", "w3", "w2")] + [gx_j]
    for name, t, j in zip(("router", "w1", "w3", "w2", "x"), g_t, want):
        assert t.dtype == leaves[("router", "w1", "w3", "w2", "x").index(name)].dtype
        check(t, j, dtype, name)


@pytest.mark.parametrize("B", [1, 2])
def test_rwkv_prefill_shift_states_are_copies(monkeypatch, B):
    """A prefill's token-shift states (time mix and channel mix, every
    layer) share no storage with any layer's input, which a view would pin
    until the caches are stacked (at B = 1 the slice is contiguous, so
    ``.contiguous()`` would copy nothing); they equal the last position,
    and the prefill's logits and caches are those of the views, bit for
    bit."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import init_params, make_prefill_step
    from repro_torch.tree import tree_leaves

    cfg = get_arch("rwkv6-3b").reduced()
    params = init_params(cfg, device="cpu", seed=0)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 24)))
    seen = []

    def recorded(fn, as_view):
        def run(p, x, *a, **k):
            out = fn(p, x, *a, **k)
            seen.append((x, out[1]))
            if as_view:
                out = (out[0], x[:, -1, :]) + tuple(out[2:])
            return out
        return run

    runs = []
    for as_view in (False, True):
        seen.clear()
        with monkeypatch.context() as m:
            m.setattr(trw, "timemix_apply", recorded(trw.timemix_apply, as_view))
            m.setattr(trw, "channelmix_apply", recorded(trw.channelmix_apply, as_view))
            with torch.no_grad():
                runs.append(make_prefill_step(cfg, ShapeConfig("p", "prefill", 24, B))(
                    params, {"tokens": tokens}))
        if not as_view:
            assert len(seen) == 2 * cfg.num_layers
            inputs = {x.untyped_storage().data_ptr() for x, _ in seen}
            for x, shift in seen:
                assert torch.equal(shift, x[:, -1, :])
                assert shift.untyped_storage().data_ptr() not in inputs
    (logits, caches), (logits_v, caches_v) = runs
    assert torch.equal(logits, logits_v)
    a, b = tree_leaves(caches), tree_leaves(caches_v)
    assert len(a) == len(b) == 3          # S, shift_tm, shift_cm: layers stacked
    assert all(torch.equal(x, y) for x, y in zip(a, b))
