"""The port's decoder against the reference's ``lm_prefill`` / ``lm_decode``
on the same (bridged) bf16 weights.

internlm2 reduced is all 'A' blocks over a stacked ``groups`` axis; gemma3
reduced is ``L x5 + A`` with a 16-token window, and its 24-token prompt
wraps the 'L' ring.  olmoe reduced puts a 4-expert top-2 MoE FFN in every
'A' block; recurrentgemma reduced is ``R, R, L`` plus a remainder 'R', with
a 24-token prompt that wraps its 16-token window; rwkv6 reduced is four 'W'
blocks.  The 8 decode steps catch a recurrent state that is not carried
from step to step.  Logits within 2e-2 of the largest reference logit (bf16
weights and activations, rounded at different places by the two
frameworks), caches and states within the same tolerance, equal greedy
tokens.

The three families added with the MoE, RG-LRU and RWKV6 blocks are held
against the reference evaluated op by op (``jax.disable_jit()``): under
``jit`` XLA fuses elementwise chains on the CPU and drops bf16 roundings
inside them, and the jitted reference then differs from its own op-by-op
evaluation by up to 6.5e-2 on reduced rwkv6 and 3.0e-2 on reduced olmoe.
Op by op, the port is exact on rwkv6 and within 1.6e-2 on the other two.

llava reduced (four 'A' layers and the vision stub) runs prefill with 8
projected patch embeddings before a 12-token prompt, and text-only, then
8 decode steps from the end of what the caches hold (20 and 12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig
from repro.models import cache_init as jax_cache_init
from repro.models import init_params as jax_init_params
from repro.models import make_decode_step as jax_decode_step
from repro.models import make_prefill_step as jax_prefill_step
from repro.runtime.serve_loop import _merge_prefill_caches as jax_merge
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import cache_init, make_decode_step, make_prefill_step
from repro_torch.runtime.serve_loop import _merge_prefill_caches

CAP = 48


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def assert_caches_close(t_tree, j_tree):
    t, j = dict(_leaves(t_tree)), dict(_leaves(j_tree))
    assert t.keys() == j.keys()
    for k in t:
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        assert rel_err(_np(t[k]), _np(j[k])) < 2e-2, k


# (arch, prompt length, reference evaluated op by op)
MODELS = [("internlm2-1.8b", 12, False), ("gemma3-1b", 24, False),
          ("olmoe-1b-7b", 12, True), ("recurrentgemma-9b", 24, True),
          ("rwkv6-3b", 12, True)]


@pytest.fixture(scope="module", params=MODELS, ids=[m[0].split("-")[0] for m in MODELS])
def model(request):
    name, prompt_len, eager = request.param
    cfg_j, cfg_t = jax_get_arch(name).reduced(), get_arch(name).reduced()
    params_j = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                        device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_t.vocab_size, (1, prompt_len))
    shape = ShapeConfig("t", "prefill", CAP, 1)
    with jax.disable_jit(eager):
        lj, cj = jax.jit(jax_prefill_step(cfg_j, shape))(
            params_j, {"tokens": jnp.asarray(tokens, jnp.int32)})
    lt, ct = make_prefill_step(cfg_t, shape)(params_t, {"tokens": torch.from_numpy(tokens)})
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j, params_t=params_t,
                tokens=tokens, eager=eager, prefill=(lj, cj, lt, ct))


def _check_prefill(model):
    lj, cj, lt, ct = model["prefill"]
    V = model["cfg_t"].vocab_size
    assert tuple(lt.shape) == tuple(lj.shape)
    assert rel_err(_np(lt)[:, :V], _np(lj)[:, :V]) < 2e-2
    assert np.array_equal(_np(lt).argmax(-1), _np(lj).argmax(-1))
    assert_caches_close(ct, cj)


def _check_decode(model, pos):
    """8 teacher-forced steps from ``pos`` on both sides' merged caches."""
    cfg_j, cfg_t = model["cfg_j"], model["cfg_t"]
    lj, cj, lt, ct = model["prefill"]
    caches_j = jax_merge(jax_cache_init(cfg_j, 1, CAP), cj, cfg_j)
    caches_t = _merge_prefill_caches(cache_init(cfg_t, 1, CAP, device="cpu"), ct, cfg_t)
    assert_caches_close(caches_t, caches_j)
    dec_j = jax.jit(jax_decode_step(cfg_j))
    dec_t = make_decode_step(cfg_t)
    V = cfg_t.vocab_size
    forced = np.random.default_rng(1).integers(0, V, 8)
    for step, tok in enumerate(forced):
        with jax.disable_jit(model["eager"]):
            lj, caches_j = dec_j(model["params_j"],
                                 {"token": jnp.asarray([tok], jnp.int32),
                                  "pos": jnp.asarray(pos + step, jnp.int32),
                                  "caches": caches_j})
        lt, caches_t = dec_t(model["params_t"], {"token": torch.tensor([int(tok)]),
                                                 "pos": pos + step, "caches": caches_t})
        assert rel_err(_np(lt)[:, :V], _np(lj)[:, :V]) < 2e-2, step
        assert np.array_equal(_np(lt).argmax(-1), _np(lj).argmax(-1)), step
    assert_caches_close(caches_t, caches_j)


def test_prefill_logits_and_caches(model):
    _check_prefill(model)


def test_teacher_forced_decode(model):
    _check_decode(model, model["tokens"].shape[1])


# llava reduced: 4 'A' layers and the vision stub (8 patch positions)
@pytest.fixture(scope="module", params=[True, False], ids=["patches", "text-only"])
def vision(request):
    name = "llava-next-34b"
    cfg_j, cfg_t = jax_get_arch(name).reduced(), get_arch(name).reduced()
    params_j = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j),
                                        device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_t.vocab_size, (1, 12))
    batch_j, batch_t = {"tokens": jnp.asarray(tokens, jnp.int32)}, \
        {"tokens": torch.from_numpy(tokens)}
    if request.param:
        patches = rng.standard_normal((1, cfg_t.num_patches, cfg_t.d_model))
        batch_j["patch_embeds"] = jnp.asarray(patches, jnp.float32).astype(jnp.bfloat16)
        batch_t["patch_embeds"] = torch.from_numpy(patches).to(torch.bfloat16)
    shape = ShapeConfig("t", "prefill", CAP, 1)
    lj, cj = jax.jit(jax_prefill_step(cfg_j, shape))(params_j, batch_j)
    lt, ct = make_prefill_step(cfg_t, shape)(params_t, batch_t)
    # the caches hold the patch positions before the text
    pos = tokens.shape[1] + (cfg_t.num_patches if request.param else 0)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j, params_t=params_t,
                tokens=tokens, eager=False, prefill=(lj, cj, lt, ct), pos=pos)


def test_vision_prefill_logits_and_caches(vision):
    assert tuple(vision["params_t"]["patch_proj"].shape) == (vision["cfg_t"].d_model,) * 2
    assert vision["prefill"][3]["groups"]["b0"]["k"].shape[2] == vision["pos"]
    _check_prefill(vision)


def test_vision_teacher_forced_decode(vision):
    _check_decode(vision, vision["pos"])
