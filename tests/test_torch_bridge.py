"""Params and caches cross from the JAX reference into the port bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import init_params, make_prefill_step
from repro.configs.base import ShapeConfig
from repro_torch import bridge

BF16 = np.dtype(jnp.bfloat16)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_bit_exact(a_tree, b_tree):
    a, b = dict(_leaves(a_tree)), dict(_leaves(b_tree))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        bits = np.uint16 if a[k].dtype == BF16 else a[k].dtype
        assert np.array_equal(a[k].view(bits), b[k].view(bits)), k


def test_params_round_trip_bf16_bit_exact():
    cfg = get_arch("internlm2-1.8b").reduced()
    ref = jax.tree_util.tree_map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    port = bridge.params_from_numpy(ref, device="cpu")
    wq = port["groups"]["b0"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert tuple(wq.shape) == ref["groups"]["b0"]["attn"]["wq"].shape  # groups axis kept
    assert isinstance(port["rem"], list)
    _assert_bit_exact(ref, bridge.params_to_numpy(port, bf16_dtype=BF16))
    # without a bf16 dtype the inverse hands back the raw 16-bit patterns
    raw = bridge.params_to_numpy(port)["embed"]
    assert raw.dtype == np.uint16
    assert np.array_equal(raw, ref["embed"].view(np.uint16))


def test_caches_round_trip_bit_exact():
    cfg = get_arch("gemma3-1b").reduced()
    params = init_params(cfg, jax.random.PRNGKey(1))
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 20)),
                         jnp.int32)
    _, caches = make_prefill_step(cfg, ShapeConfig("t", "prefill", 64, 1))(
        params, {"tokens": tokens})
    ref = jax.tree_util.tree_map(np.asarray, caches)
    port = bridge.caches_from_numpy(ref, device="cpu")
    assert port["groups"]["b0"]["k"].dtype == torch.bfloat16
    _assert_bit_exact(ref, bridge.caches_to_numpy(port, bf16_dtype=BF16))


def test_float32_leaves_round_trip():
    ref = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": [np.int32(7)]}
    port = bridge.params_from_numpy(ref, device="cpu")
    assert port["a"].dtype == torch.float32
    back = bridge.params_to_numpy(port)
    assert np.array_equal(back["a"], ref["a"])
    assert back["b"][0].shape == () and int(back["b"][0]) == 7


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-9b", "rwkv6-3b"])
def test_moe_and_recurrent_trees_round_trip(arch):
    """The MoE (f32 router beside bf16 experts), RG-LRU (f32 ``lam``) and
    RWKV6 (f32 decay and bonus) params, and the f32 recurrent states beside
    bf16 shifts and conv carries, cross bit-exact with their dtypes kept."""
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, jax.random.PRNGKey(2))
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 12)),
                         jnp.int32)
    _, caches = make_prefill_step(cfg, ShapeConfig("t", "prefill", 64, 1))(
        params, {"tokens": tokens})
    for ref in (params, caches):
        ref = jax.tree_util.tree_map(np.asarray, ref)
        port = bridge.params_from_numpy(ref, device="cpu")
        for path, leaf in _leaves(port):
            want = dict(_leaves(ref))[path].dtype
            assert (leaf.dtype == torch.bfloat16) == (want == BF16), path
        _assert_bit_exact(ref, bridge.params_to_numpy(port, bf16_dtype=BF16))


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_encoder_decoder_and_vision_trees_round_trip(arch):
    """The stacked ``enc``/``dec`` layer axes, the two position tables and
    the four decoder caches of whisper, and llava's ``patch_proj``, cross
    bit-exact with the generic walk."""
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 8)), jnp.int32)}
    key = "audio_embeds" if cfg.encoder_layers else "patch_embeds"
    frames = 32 if cfg.encoder_layers else cfg.num_patches
    batch[key] = jnp.asarray(rng.standard_normal((1, frames, cfg.d_model)),
                             jnp.float32).astype(jnp.bfloat16)
    _, caches = make_prefill_step(cfg, ShapeConfig("t", "prefill", 64, 1))(params, batch)
    if cfg.encoder_layers:
        assert tuple(params["enc"]["attn"]["wq"].shape)[0] == cfg.encoder_layers
        assert sorted(caches) == ["ck", "cv", "k", "v"]
    else:
        assert tuple(params["patch_proj"].shape) == (cfg.d_model, cfg.d_model)
    for ref in (params, caches):
        ref = jax.tree_util.tree_map(np.asarray, ref)
        port = bridge.params_from_numpy(ref, device="cpu")
        assert [p for p, _ in _leaves(port)] == [p for p, _ in _leaves(ref)]
        _assert_bit_exact(ref, bridge.params_to_numpy(port, bf16_dtype=BF16))
