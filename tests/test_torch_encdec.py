"""The port's encoder-decoder against the reference's ``models/encdec.py``
on reduced whisper (2 + 2 layers, 4/2 heads of 16), bf16 weights drawn by
the reference and bridged across.

40 frames of seeded audio embeddings and an 8-token prompt (the reference's
text length, 40 // 8 rounded up to 8); the decode caches have capacity 48,
so the cross caches hold 8 zero rows past the encoder's 40, which decode
attends to, as the reference's ``cache_init`` leaves them.  Logits within
2e-2 of the largest reference logit, caches and encoder output within the
same tolerance, equal greedy tokens (``test_torch_lm.py``'s bounds).
``encdec_loss`` and its grads are held to the reference evaluated op by op
(``jax.disable_jit()``).  With bf16 params: each grad leaf within 3e-2 in
L2 and each element within 5e-2 of the leaf's largest reference grad
(``test_torch_train.py``'s bounds), the loss within 1e-3 relative (the
two frameworks' bf16 roundings put it 3.2e-4 apart; the jitted reference
is 7.4e-4 from its own op-by-op value).  With
f32 params every product runs in f32 on both sides and only summation
order is left: loss within 2e-6, grads within 2e-5.

The flash-attention route is shown with a counting stub in place of the
kernel wrapper: a prefill calls it three times a layer pair (the encoder's
attention, the decoder's causal self-attention, its cross-attention over
the encoder output), a decode step and a training loss never.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig
from repro.models import cache_init as jax_cache_init
from repro.models import encdec as jed
from repro.models import init_params as jax_init_params
from repro.models import layers as jl
from repro.models import make_decode_step as jax_decode_step
from repro.models import make_loss_fn as jax_make_loss_fn
from repro.models import make_prefill_step as jax_prefill_step
from repro.runtime.serve_loop import _merge_prefill_caches as jax_merge
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import (
    cache_init,
    encdec,
    make_decode_step,
    make_loss_fn,
    make_prefill_step,
)
from repro_torch.models import layers as tl
from repro_torch.runtime.serve_loop import _merge_prefill_caches
from repro_torch.tree import tree_leaves, tree_unflatten

ARCH = "whisper-medium"
CAP, FRAMES = 48, 40


def rel_err(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_trees_close(t_tree, j_tree, tol=2e-2):
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(j_tree)[0]]
    t, j = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(t) == len(j)
    for path, a, b in zip(paths, t, j):
        assert tuple(a.shape) == tuple(b.shape), path
        assert rel_err(a, b) < tol, path


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    params_j = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                        device="cpu")
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((1, FRAMES, cfg_t.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg_t.vocab_size, (1, jed.text_len(FRAMES)))
    batch_j = {"audio_embeds": jnp.asarray(audio).astype(jnp.bfloat16),
               "tokens": jnp.asarray(tokens, jnp.int32)}
    batch_t = {"audio_embeds": torch.from_numpy(audio).to(torch.bfloat16),
               "tokens": torch.from_numpy(tokens)}
    shape = ShapeConfig("t", "prefill", CAP, 1)
    lj, cj = jax.jit(jax_prefill_step(cfg_j, shape))(params_j, batch_j)
    lt, ct = make_prefill_step(cfg_t, shape)(params_t, batch_t)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j, params_t=params_t,
                batch_j=batch_j, batch_t=batch_t, tokens=tokens, shape=shape,
                prefill=(lj, cj, lt, ct))


def test_text_len_is_the_references():
    for s in (0, 8, 63, 64, 1024, 1500, 32768):
        assert encdec.text_len(s) == jed.text_len(s)
    assert encdec.TEXT_RATIO == jed.TEXT_RATIO


def test_encode_matches_reference(model):
    ej = jax.jit(lambda p, a: jed.encode(p, a, model["cfg_j"]))(
        model["params_j"], model["batch_j"]["audio_embeds"])
    et = encdec.encode(model["params_t"], model["batch_t"]["audio_embeds"],
                       model["cfg_t"])
    assert tuple(et.shape) == tuple(ej.shape) and et.dtype == torch.bfloat16
    assert rel_err(et, ej) < 2e-2


def test_prefill_logits_and_caches(model):
    lj, cj, lt, ct = model["prefill"]
    V = model["cfg_t"].vocab_size
    assert tuple(lt.shape) == tuple(lj.shape)
    assert rel_err(lt[:, :V], lj[:, :V]) < 2e-2
    assert np.array_equal(_np(lt).argmax(-1), _np(lj).argmax(-1))
    assert sorted(ct) == ["ck", "cv", "k", "v"]
    L, St = model["cfg_t"].decoder_layers, model["tokens"].shape[1]
    assert tuple(ct["k"].shape)[:3] == (L, 1, St)
    assert tuple(ct["ck"].shape)[:3] == (L, 1, FRAMES)
    assert_trees_close(ct, cj)


def test_teacher_forced_decode(model):
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    _, cj, _, ct = model["prefill"]
    caches_j = jax_merge(jax_cache_init(cfg_j, 1, CAP), cj, cfg_j)
    caches_t = _merge_prefill_caches(cache_init(cfg_t, 1, CAP, device="cpu"), ct, cfg_t)
    assert tuple(caches_t["ck"].shape)[2] == CAP          # enc_len = cap
    assert not caches_t["ck"][:, :, FRAMES:].any()
    assert_trees_close(caches_t, caches_j)
    dec_j = jax.jit(jax_decode_step(cfg_j))
    dec_t = make_decode_step(cfg_t)
    V = cfg_t.vocab_size
    pos = model["tokens"].shape[1]
    forced = np.random.default_rng(1).integers(0, V, 8)
    for step, tok in enumerate(forced):
        lj, caches_j = dec_j(model["params_j"],
                             {"token": jnp.asarray([tok], jnp.int32),
                              "pos": jnp.asarray(pos + step, jnp.int32),
                              "caches": caches_j})
        buf = caches_t["k"]
        lt, caches_t = dec_t(model["params_t"], {"token": torch.tensor([int(tok)]),
                                                 "pos": pos + step, "caches": caches_t})
        assert caches_t["k"] is buf                          # written in place
        assert rel_err(lt[:, :V], lj[:, :V]) < 2e-2, step
        assert np.array_equal(_np(lt).argmax(-1), _np(lj).argmax(-1)), step
    assert_trees_close(caches_t, caches_j)


# (loss bound, grad L2 bound, grad element bound); f32 params run every
# matmul in f32, which leaves only summation order between the two sides
LOSS_TOL = {"bf16": (1e-3, 3e-2, 5e-2), "f32": (2e-6, 2e-5, 2e-5)}


@pytest.mark.parametrize("dname", list(LOSS_TOL))
def test_encdec_loss_value_and_grads_match_reference(model, dname):
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    loss_tol, l2_tol, el_tol = LOSS_TOL[dname]
    params_j = model["params_j"]
    if dname == "f32":
        params_j = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params_j)
    params_t = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                        device="cpu")
    shape = ShapeConfig("t", "train", FRAMES, 2)
    rng = np.random.default_rng(2)
    audio = rng.standard_normal((2, FRAMES, cfg_t.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg_t.vocab_size, (2, jed.text_len(FRAMES)))
    loss_j = jax_make_loss_fn(cfg_j, shape)
    with jax.disable_jit():
        (lj, exj), gj = jax.value_and_grad(
            lambda p: loss_j(p, {"audio_embeds": jnp.asarray(audio).astype(jnp.bfloat16),
                                 "tokens": jnp.asarray(tokens, jnp.int32)}),
            has_aux=True)(params_j)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params_t)]
    lt, ext = make_loss_fn(cfg_t, shape)(
        tree_unflatten(params_t, leaves),
        {"audio_embeds": torch.from_numpy(audio).to(torch.bfloat16),
         "tokens": torch.from_numpy(tokens)})
    gt = torch.autograd.grad(lt, leaves)
    assert rel_err(lt, lj) < loss_tol
    assert rel_err(ext["loss"], exj["loss"]) < loss_tol
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(gj)[0]]
    gj_leaves = jax.tree_util.tree_leaves(gj)
    assert len(gt) == len(gj_leaves)
    for path, t, j in zip(paths, gt, gj_leaves):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), path
        t, j = _np(t), _np(j)
        assert np.linalg.norm(t - j) <= l2_tol * np.linalg.norm(j), path
        assert rel_err(t, j) < el_tol, path


@pytest.mark.parametrize("causal", [True, False])
def test_attention_block_without_rope(causal):
    """``use_rope=False`` (the whisper encoder and decoder) against the
    reference, self-attention and over a longer ``kv_override``."""
    cfg_j, cfg_t = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    rng = np.random.default_rng(3)
    d, hd = cfg_t.d_model, cfg_t.head_dim
    w = {"wq": (d, cfg_t.num_heads * hd), "wk": (d, cfg_t.num_kv_heads * hd),
         "wv": (d, cfg_t.num_kv_heads * hd), "wo": (cfg_t.num_heads * hd, d)}
    w = {k: (rng.standard_normal(s) / 8).astype(np.float32) for k, s in w.items()}
    pj = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in w.items()}
    pt = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in w.items()}
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    pos = np.arange(12) + 5          # RoPE would move q and k: these positions show it
    out_j, (kj, vj) = jl.attention_block(pj, xj, cfg=cfg_j, positions=jnp.asarray(pos),
                                         causal=causal, use_rope=False)
    out_t, (kt, vt) = tl.attention_block(pt, xt, cfg=cfg_t, positions=torch.from_numpy(pos),
                                         causal=causal, use_rope=False)
    for a, b in ((out_t, out_j), (kt, kj), (vt, vj)):
        assert rel_err(a, b) < 2e-2
    roped, _ = tl.attention_block(pt, xt, cfg=cfg_t, positions=torch.from_numpy(pos),
                                  causal=causal)
    assert rel_err(roped, out_j) > 2e-2
    # a query block over 20 encoder positions (cross-attention)
    kv = rng.standard_normal((2, 20, cfg_t.num_kv_heads, hd)).astype(np.float32)
    kvj = jnp.asarray(kv).astype(jnp.bfloat16)
    kvt = torch.from_numpy(kv).to(torch.bfloat16)
    cj, _ = jl.attention_block(pj, xj, cfg=cfg_j, positions=jnp.asarray(pos),
                               causal=False, use_rope=False,
                               kv_override=(kvj, kvj * 0.5, jnp.arange(20)))
    ct, _ = tl.attention_block(pt, xt, cfg=cfg_t, positions=torch.from_numpy(pos),
                               causal=False, use_rope=False, full_kv=True,
                               kv_override=(kvt, kvt * 0.5, torch.arange(20)))
    assert rel_err(ct, cj) < 2e-2


@pytest.fixture
def counted(monkeypatch):
    """The flash-attention wrapper behind a call counter (the plain version
    still runs on the CPU)."""
    real = tl.flash_attention
    calls = []

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tl, "flash_attention", counting)
    return calls


def test_kernel_route_takes_unmasked_full_cross_attention(counted):
    cfg = get_arch(ARCH).reduced()
    rng = np.random.default_rng(4)
    d, hd, H, Hkv = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    p = {k: torch.from_numpy((rng.standard_normal(s) / 8).astype(np.float32)).to(torch.bfloat16)
         for k, s in (("wq", (d, H * hd)), ("wk", (d, Hkv * hd)),
                      ("wv", (d, Hkv * hd)), ("wo", (H * hd, d)))}
    x = torch.from_numpy(rng.standard_normal((1, 6, d)).astype(np.float32)).to(torch.bfloat16)
    kv = torch.zeros((1, 20, Hkv, hd), dtype=torch.bfloat16)
    cross = (kv, kv, torch.arange(20))

    def run(x, **kw):
        pos = torch.arange(x.shape[1])
        return tl.attention_block(p, x, cfg=cfg, positions=pos, use_rope=False, **kw)

    run(x, causal=False, kv_override=cross, full_kv=True)
    assert counted == [((1, 6, H, hd), (1, 20, Hkv, hd), {"causal": False, "window": 0})]
    run(x[:, :1], causal=False, kv_override=cross, full_kv=True)     # decode: S = 1
    run(x, causal=False, kv_override=cross)                          # keys not said valid
    run(x, causal=True, kv_override=cross, full_kv=True)             # masked
    run(x, causal=False, window=4, kv_override=cross, full_kv=True)
    run(x, causal=False, kv_override=cross, full_kv=True, use_kernel=False)   # training
    assert len(counted) == 1


def test_prefill_launches_three_attentions_a_layer_pair(model, counted):
    cfg = model["cfg_t"]
    make_prefill_step(cfg, model["shape"])(model["params_t"], model["batch_t"])
    assert len(counted) == 3 * cfg.decoder_layers == 6
    St, H, Hkv, hd = model["tokens"].shape[1], cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert counted[:cfg.encoder_layers] == [
        ((1, FRAMES, H, hd), (1, FRAMES, Hkv, hd), {"causal": False, "window": 0})] * 2
    assert counted[cfg.encoder_layers:] == [
        ((1, St, H, hd), (1, St, Hkv, hd), {"causal": True, "window": 0}),
        ((1, St, H, hd), (1, FRAMES, Hkv, hd), {"causal": False, "window": 0})] * 2
    _, _, _, ct = model["prefill"]
    caches = _merge_prefill_caches(cache_init(cfg, 1, CAP, device="cpu"), ct, cfg)
    make_decode_step(cfg)(model["params_t"], {"token": torch.tensor([1]), "pos": St,
                                              "caches": caches})
    loss, _ = make_loss_fn(cfg, model["shape"])(model["params_t"], model["batch_t"])
    assert torch.isfinite(loss)
    assert len(counted) == 6
