"""Port layers against the reference's jnp layers on shared weights.

Inputs and weights are made with numpy from a seed and rounded to the
working type on each side (both round to nearest even).  Tolerances are
relative to the largest reference value: 2e-5 in float32 (summation order),
2e-2 in bfloat16 (where the two frameworks round intermediates).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jl
from repro_torch.configs import get_arch
from repro_torch.models import layers as tl

DTYPES = ["f32", "bf16"]
TOL = {"f32": 2e-5, "bf16": 2e-2}


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def both(a, dtype):
    """(jax array, torch tensor) of one float32 numpy array in ``dtype``."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return jnp.asarray(a).astype(jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def tree_both(tree, dtype):
    j, t = {}, {}
    for k, v in tree.items():
        j[k], t[k] = both(v, dtype)
    return j, t


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def check(out_t, out_j, dtype):
    assert tuple(out_t.shape) == tuple(out_j.shape)
    assert rel_err(_np(out_t), _np(out_j)) < TOL[dtype]


def attn_weights(rng, cfg):
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": rng.standard_normal((d, cfg.num_heads * hd)).astype(np.float32) / 8,
        "wk": rng.standard_normal((d, cfg.num_kv_heads * hd)).astype(np.float32) / 8,
        "wv": rng.standard_normal((d, cfg.num_kv_heads * hd)).astype(np.float32) / 8,
        "wo": rng.standard_normal((cfg.num_heads * hd, d)).astype(np.float32) / 8,
    }


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal((2, 5, 64)).astype(np.float32) * 3, dtype)
    sj, st = both(rng.standard_normal(64).astype(np.float32), dtype)
    check(tl.rmsnorm({"scale": st}, xt, 1e-5), jl.rmsnorm({"scale": sj}, xj, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype):
    rng = np.random.default_rng(1)
    xj, xt = both(rng.standard_normal((2, 5, 4, 16)).astype(np.float32), dtype)
    pos = np.arange(5) + 3
    check(tl.rope(xt, torch.from_numpy(pos), 10_000.0),
          jl.rope(xj, jnp.asarray(pos), 10_000.0), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Skv,window,chunk,ring", [
    (8, 8, 0, 1024, False),        # direct path, prefill-shaped
    (8, 8, 4, 1024, False),        # direct path, sliding window
    (1, 16, 0, 1024, True),        # decode against a ring with empty slots
    (64, 64, 0, 16, False),        # chunked online softmax (Skv > chunk)
    (64, 64, 24, 16, False),       # chunked with a window
])
def test_attention_core(dtype, Sq, Skv, window, chunk, ring):
    rng = np.random.default_rng(2)
    qj, qt = both(rng.standard_normal((1, Sq, 4, 16)).astype(np.float32), dtype)
    kj, kt = both(rng.standard_normal((1, Skv, 2, 16)).astype(np.float32), dtype)
    vj, vt = both(rng.standard_normal((1, Skv, 2, 16)).astype(np.float32), dtype)
    if ring:
        pos = 11
        qpos = np.array([pos])
        kpos = pos - np.mod(pos - np.arange(Skv), Skv)   # some slots negative
    else:
        qpos = kpos = np.arange(Sq)
    ref = jl.attention_core(qj, kj, vj, jnp.asarray(qpos), jnp.asarray(kpos),
                            causal=True, window=window, chunk=chunk)
    out = tl.attention_core(qt, kt, vt, torch.from_numpy(qpos), torch.from_numpy(kpos),
                            causal=True, window=window, chunk=chunk)
    check(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 4])
def test_attention_block_prefill_and_decode(dtype, window):
    cfg_j = jax_get_arch("internlm2-1.8b").reduced()
    cfg_t = get_arch("internlm2-1.8b").reduced()
    rng = np.random.default_rng(3)
    pj, pt = tree_both(attn_weights(rng, cfg_t), dtype)
    xj, xt = both(rng.standard_normal((2, 12, cfg_t.d_model)).astype(np.float32), dtype)
    pos = np.arange(12)
    # prefill: the port runs the flash-attention wrapper (plain version on CPU)
    out_j, (k_j, v_j) = jl.attention_block(pj, xj, cfg=cfg_j, positions=jnp.asarray(pos),
                                           window=window)
    out_t, (k_t, v_t) = tl.attention_block(pt, xt, cfg=cfg_t,
                                           positions=torch.from_numpy(pos), window=window)
    check(out_t, out_j, dtype)
    check(k_t, k_j, dtype)
    check(v_t, v_j, dtype)
    # decode: one query against the prefill K/V as an override
    x1j, x1t = xj[:, -1:], xt[:, -1:]
    p1 = np.array([11])
    dj, _ = jl.attention_block(pj, x1j, cfg=cfg_j, positions=jnp.asarray(p1),
                               window=window, kv_override=(k_j, v_j, jnp.asarray(pos)))
    dt, _ = tl.attention_block(pt, x1t, cfg=cfg_t, positions=torch.from_numpy(p1),
                               window=window, kv_override=(k_t, v_t, torch.from_numpy(pos)))
    check(dt, dj, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype):
    rng = np.random.default_rng(4)
    w = {"w_gate": rng.standard_normal((64, 128)).astype(np.float32) / 8,
         "w_up": rng.standard_normal((64, 128)).astype(np.float32) / 8,
         "w_down": rng.standard_normal((128, 64)).astype(np.float32) / 11}
    pj, pt = tree_both(w, dtype)
    xj, xt = both(rng.standard_normal((2, 3, 64)).astype(np.float32), dtype)
    check(tl.mlp(pt, xt), jl.mlp(pj, xj), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_logits_head_masks_padded_vocab(dtype):
    rng = np.random.default_rng(5)
    pj, pt = tree_both({"lm_head": rng.standard_normal((64, 512)).astype(np.float32) / 8},
                       dtype)
    xj, xt = both(rng.standard_normal((2, 64)).astype(np.float32), dtype)
    out_t, out_j = tl.logits_head(pt, xt, 300), jl.logits_head(pj, xj, 300)
    assert out_t.dtype == torch.float32
    assert np.array_equal(out_t[:, 300:].numpy(), np.asarray(out_j)[:, 300:])
    check(out_t[:, :300], out_j[:, :300], dtype)


def test_embed_lookup_and_dense_init():
    g = torch.Generator().manual_seed(0)
    w = tl.dense_init(g, (8, 64), in_axis=1, lead=(3,))
    assert w.shape == (3, 8, 64) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 64 ** -0.5) < 0.03
    toks = torch.tensor([[1, 7, 1]])
    assert torch.equal(tl.embed_lookup({"embed": w[0]}, toks)[0, 0], w[0, 1])
