"""Params and caches cross from the JAX reference into the port bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
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
