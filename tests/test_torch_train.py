"""The port's training math against the reference's: the loss functions
and ``lm_loss`` with its grads (``test_torch_train_loop.py`` holds the
train step, the trainer and the launcher).

``softmax_xent`` and ``chunked_lm_loss`` (with S % 256 != 0, the trainer's
S - 1 labels) run on the same numpy inputs on both sides; values and grads
wrt ``h`` and ``lm_head`` within 2e-5 relative in float32 (summation order)
and 2e-2 in bfloat16.

``lm_loss`` runs on bridged reduced weights (llava also with 8 patch
embeddings before the text), the
reference evaluated op by op (``jax.disable_jit()``; see
``test_torch_lm.py`` for why the jitted bf16 reference is no yardstick).
The loss agrees within 1e-4 relative.  Grads are bf16 cotangents that the
two frameworks round at different places: each leaf within 3e-2 in L2
relative to the reference's, and each element within 5e-2 of the leaf's
largest reference grad (measured over the five families: at most 1.8e-2
and 3.1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig
from repro.models import init_params as jax_init_params
from repro.models import layers as jl
from repro.models import make_loss_fn as jax_make_loss_fn
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import _build
from repro_torch.models import init_opt_state, make_loss_fn, make_prefill_step, make_train_step
from repro_torch.models import layers as tl
from repro_torch.tree import tree_leaves, tree_unflatten

TOL = {"f32": 2e-5, "bf16": 2e-2}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_err(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def both(a, dname):
    jdt, tdt = DT[dname]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def test_softmax_xent_value_and_grad():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7))
    vj, gj = jax.value_and_grad(jl.softmax_xent)(jnp.asarray(logits),
                                                 jnp.asarray(labels, jnp.int32), 50)
    lt = torch.from_numpy(logits).requires_grad_(True)
    vt = tl.softmax_xent(lt, torch.from_numpy(labels), 50)
    (gt,) = torch.autograd.grad(vt, lt)
    assert rel_err(vt, vj) < 2e-6
    assert rel_err(gt, gj) < 2e-6


@pytest.mark.parametrize("dname", list(DT))
@pytest.mark.parametrize("S", [100, 256, 300, 600])
def test_chunked_lm_loss_value_and_grads(S, dname):
    B, D, Vp, V = 2, 32, 320, 300             # padded vocab: the head masks 20 columns
    rng = np.random.default_rng(S)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (rng.standard_normal((D, Vp)) / np.sqrt(D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S))
    hj, ht = both(h, dname)
    wj, wt = both(head, dname)

    def jloss(h_, w_):
        return jl.chunked_lm_loss({"lm_head": w_}, h_, jnp.asarray(labels, jnp.int32), V)

    vj, (ghj, gwj) = jax.value_and_grad(jloss, argnums=(0, 1))(hj, wj)
    ht.requires_grad_(True)
    wt.requires_grad_(True)
    vt = tl.chunked_lm_loss({"lm_head": wt}, ht, torch.from_numpy(labels), V)
    ght, gwt = torch.autograd.grad(vt, (ht, wt))
    assert vt.dtype == torch.float32 and vt.ndim == 0
    assert rel_err(vt, vj) < TOL[dname]
    assert ght.dtype == DT[dname][1] and gwt.dtype == DT[dname][1]
    assert rel_err(ght, ghj) < TOL[dname]
    assert rel_err(gwt, gwj) < TOL[dname]
    with torch.no_grad():                      # the plain path, no recompute
        assert float(tl.chunked_lm_loss({"lm_head": wt}, ht, torch.from_numpy(labels), V)) \
            == float(vt)


def test_chunked_attention_recomputes_to_the_same_grads():
    """Under grad mode each chunk of the online softmax is recomputed in
    backward; its grads are the direct path's within 2e-5 (f32 summation
    order)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 256, 4, 16), (2, 256, 2, 16), (2, 256, 2, 16)))
    pos = torch.arange(256)
    grads = []
    for chunk in (64, 1024):                      # chunked, then direct
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = tl.attention_core(*xs, pos, pos, causal=True, window=100, chunk=chunk)
        grads.append([out] + list(torch.autograd.grad(out.square().sum(), xs)))
    for a, b in zip(*grads):
        assert rel_err(a, b) < 2e-5


# olmoe's MoE aux term enters the loss
MODELS = ["internlm2-1.8b", "gemma3-1b", "olmoe-1b-7b", "recurrentgemma-9b", "rwkv6-3b"]


def _bridged(name):
    cfg_j, cfg_t = jax_get_arch(name).reduced(), get_arch(name).reduced()
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    pt = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def _loss_and_grads_match(name, batch_np):
    """``make_loss_fn`` on ``batch_np`` (numpy; float arrays go in as bf16)
    against the reference's value and grads, evaluated op by op."""
    cfg_j, cfg_t, pj, pt = _bridged(name)
    S = batch_np["tokens"].shape[1]
    shape = ShapeConfig("t", "train", S, batch_np["tokens"].shape[0])
    bj = {k: jnp.asarray(v, jnp.int32) if k == "tokens" else
          jnp.asarray(v, jnp.float32).astype(jnp.bfloat16) for k, v in batch_np.items()}
    bt = {k: torch.from_numpy(v) if k == "tokens" else
          torch.from_numpy(v).to(torch.bfloat16) for k, v in batch_np.items()}
    loss_j = jax_make_loss_fn(cfg_j, shape)
    with jax.disable_jit():
        (lj, exj), gj = jax.value_and_grad(lambda p: loss_j(p, bj), has_aux=True)(pj)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(pt)]
    lt, ext = make_loss_fn(cfg_t, shape)(tree_unflatten(pt, leaves), bt)
    gt = torch.autograd.grad(lt, leaves)
    assert rel_err(lt, lj) < 1e-4
    assert rel_err(ext["loss"], exj["loss"]) < 1e-4
    if cfg_t.num_experts:
        assert float(exj["aux"]) > 0
    assert abs(float(ext["aux"].detach()) - float(exj["aux"])) \
        <= 1e-4 * max(1.0, float(exj["aux"]))
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(gj)[0]]
    gj_leaves = jax.tree_util.tree_leaves(gj)
    assert len(gt) == len(gj_leaves)
    for path, t, j in zip(paths, gt, gj_leaves):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), path
        t, j = _np(t), _np(j)
        assert np.linalg.norm(t - j) <= 3e-2 * np.linalg.norm(j), path
        assert rel_err(t, j) < 5e-2, path
    return gt, paths


@pytest.mark.parametrize("name", MODELS, ids=[m.split("-")[0] for m in MODELS])
def test_lm_loss_value_and_grads_match_reference(name):
    V = get_arch(name).reduced().vocab_size
    tokens = np.random.default_rng(0).integers(0, V, (2, 24))
    _loss_and_grads_match(name, {"tokens": tokens})


def test_lm_loss_with_patch_embeds_matches_reference():
    """llava reduced: 8 patch embeddings before 24 tokens, the loss over the
    text alone; ``patch_proj`` gets its grad through the patches."""
    cfg = get_arch("llava-next-34b").reduced()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)),
             "patch_embeds": rng.standard_normal((2, cfg.num_patches, cfg.d_model))
             .astype(np.float32)}
    gt, paths = _loss_and_grads_match("llava-next-34b", batch)
    assert float(gt[paths.index("['patch_proj']")].float().abs().max()) > 0


def test_train_mode_never_calls_flash_attention(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("flash_attention called")

    monkeypatch.setattr(tl, "flash_attention", refuse)
    _, cfg, _, params = _bridged("gemma3-1b")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20)))
    shape = ShapeConfig("t", "train", 20, 2)
    loss, _ = make_loss_fn(cfg, shape)(params, {"tokens": tokens})
    assert torch.isfinite(loss)
    step = make_train_step(cfg, shape, microbatches=1)
    _, _, metrics = step(params, init_opt_state(params, cfg), {"tokens": tokens})
    assert np.isfinite(float(metrics["loss"]))
    with pytest.raises(AssertionError, match="flash_attention called"):
        make_prefill_step(cfg, shape)(params, {"tokens": tokens})  # the patch bites


KERNEL_FAMILIES = ["olmoe-1b-7b", "recurrentgemma-9b", "rwkv6-3b"]


@pytest.mark.parametrize("name", KERNEL_FAMILIES, ids=[m.split("-")[0] for m in KERNEL_FAMILIES])
def test_train_mode_never_calls_the_block_kernels(monkeypatch, name):
    """Training takes the reference's route through the MoE, RG-LRU and
    RWKV6 blocks: with every entry of K4, K5 and K6 patched to raise (in the
    kernel modules and where the blocks bound them), the loss and a train
    step run; a prefill of the same model raises, so the patch bites."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.models import moe as tmoe
    from repro_torch.models import rglru as trg
    from repro_torch.models import rwkv as trw

    def refuse(*a, **k):
        raise AssertionError("kernel called")

    for mod, attr in ((gmm_ops, "moe_gmm"), (tmoe, "moe_gmm"), (rg_ops, "rglru_scan"),
                      (rg_ops, "rglru_gated_scan"), (trg, "rglru_gated_scan"),
                      (wkv_ops, "wkv6"), (trw, "wkv6")):
        monkeypatch.setattr(mod, attr, refuse)
    _, cfg, _, params = _bridged(name)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    shape = ShapeConfig("t", "train", 16, 2)
    loss, _ = make_loss_fn(cfg, shape)(params, {"tokens": tokens})
    assert torch.isfinite(loss)
    step = make_train_step(cfg, shape, microbatches=1)
    _, _, metrics = step(params, init_opt_state(params, cfg), {"tokens": tokens})
    assert np.isfinite(float(metrics["loss"]))
    with pytest.raises(AssertionError, match="kernel called"):
        make_prefill_step(cfg, shape)(params, {"tokens": tokens})


def test_refuse_grad_raises_only_under_grad_mode_with_grad_inputs():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward.*train route"):
        _build.refuse_grad("k", x, None)
    with torch.no_grad():
        _build.refuse_grad("k", x)
    _build.refuse_grad("k", torch.ones(3), None, 3)
