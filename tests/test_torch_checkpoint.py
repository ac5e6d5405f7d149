"""The port's checkpointer: the reference's ``tests/test_checkpoint.py`` on
torch tensor trees, and checkpoints crossing between ``repro`` and
``repro_torch`` in both directions, bit for bit.

The reference's ``test_elastic_restore_into_model`` runs here with the
port's ``init_opt_state``, and a trainer's ``{"params", "opt"}`` state
after a train step (``opt.step`` included) crosses between the packages in
both directions.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models import init_opt_state as jax_init_opt_state
from repro.models import init_params as jax_init_params
from repro.models import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_checkpoint,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.checkpointer import from_raw_bytes, to_raw_bytes
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import init_opt_state, init_params, make_train_step


def tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"w": torch.ones((5,), dtype=torch.bfloat16),
              "s": torch.zeros((), dtype=torch.int32)},
        "c": [torch.full((2, 2), 3.0), torch.tensor(7, dtype=torch.int8)],
    }


def leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in leaves(v)]
    return [t]


def raw(x) -> bytes:
    """The bytes of a leaf of either package (bf16 through its bit pattern)."""
    if isinstance(x, torch.Tensor):
        return to_raw_bytes(x).tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def assert_bits_equal(x, y):
    lx, ly = leaves(x), leaves(y)
    assert len(lx) == len(ly)
    for a, b in zip(lx, ly):
        assert tuple(a.shape) == tuple(b.shape)
        assert raw(a) == raw(b)


def zeros_like(t):
    if isinstance(t, dict):
        return {k: zeros_like(v) for k, v in t.items()}
    if isinstance(t, list):
        return [zeros_like(v) for v in t]
    return torch.zeros_like(t)


def test_roundtrip(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 3, t)
    assert list_checkpoints(str(tmp_path)) == [3]
    restored = restore_checkpoint(str(tmp_path), 3, zeros_like(t))
    assert_bits_equal(t, restored)
    # dtypes preserved (incl. bfloat16 through the raw-byte path)
    assert restored["b"]["w"].dtype == torch.bfloat16
    assert restored["c"][1].dtype == torch.int8 and restored["c"][1].shape == ()


def test_uncommitted_checkpoints_invisible(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 1, t)
    os.remove(tmp_path / "step_00000001" / "_COMMITTED")
    assert list_checkpoints(str(tmp_path)) == []
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), 1, t)


def test_corruption_detected(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 1, t)
    f = tmp_path / "step_00000001" / "arrays_0.npz"
    data = f.read_bytes()
    f.write_bytes(data[:-3] + b"XXX")
    with pytest.raises(IOError):
        restore_checkpoint(str(tmp_path), 1, t)


def test_async_checkpointer_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    t = tree()
    for s in (1, 2, 3, 4):
        ck.save(s, t)
    ck.wait()
    steps = list_checkpoints(str(tmp_path))
    assert steps[-1] == 4 and len(steps) <= 3
    assert latest_checkpoint(str(tmp_path)) == 4


def test_restore_casts_dtype(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.full((4,), 1.5)})
    restored = restore_checkpoint(str(tmp_path), 1,
                                  {"w": torch.zeros((4,), dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].float(), torch.full((4,), 1.5))


def test_restore_missing_leaf_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones((4,))})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), 1, {"w2": torch.ones((4,))})


def test_resharding_restore_is_not_ported(tmp_path):
    """Resharding restore is ported (``tests/test_torch_sharding.py`` holds
    it across mesh shapes); a None sharding leaves its leaf as a plain
    tensor on the target leaf's device, as the reference's does."""
    save_checkpoint(str(tmp_path), 1, {"w": torch.arange(4.0)})
    got = restore_checkpoint(str(tmp_path), 1, {"w": torch.ones((4,))},
                             shardings={"w": None})
    assert type(got["w"]) is torch.Tensor and torch.equal(got["w"], torch.arange(4.0))


def test_async_save_is_a_snapshot(tmp_path):
    """The tree changes in place right after ``save`` returns (as the next
    optimizer step would): the checkpoint still holds the old values."""
    t = tree()
    want = {"a": t["a"].clone(), "w": t["b"]["w"].clone()}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, t)
    t["a"].add_(100.0)
    t["b"]["w"].mul_(3.0)
    t["c"][0].zero_()
    ck.wait()
    restored = restore_checkpoint(str(tmp_path), 1, zeros_like(t))
    assert torch.equal(restored["a"], want["a"])
    assert torch.equal(restored["b"]["w"], want["w"])
    assert torch.equal(restored["c"][0], torch.full((2, 2), 3.0))


def test_inflight_tmp_directory_not_listed(tmp_path):
    save_checkpoint(str(tmp_path), 2, tree())
    tmp = tmp_path / "step_00000005.tmp"
    tmp.mkdir()
    (tmp / "_COMMITTED").write_text("0")
    (tmp_path / "step_x").mkdir()
    assert list_checkpoints(str(tmp_path)) == [2]
    assert latest_checkpoint(str(tmp_path)) == 2


def test_async_writer_error_raises_on_wait(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    (tmp_path / "step_00000001.tmp").write_text("a file where a directory goes")
    ck.save(1, tree())
    with pytest.raises(OSError):
        ck.wait()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int32", "int8",
                                   "uint8", "float16", "int64", "bool"])
def test_raw_bytes_codec_round_trips(dtype):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 5)) * 50)
    x = x.to(getattr(torch, dtype))
    got = from_raw_bytes(to_raw_bytes(x), dtype, (3, 5))
    assert got.dtype == x.dtype and raw(got) == raw(x)


# ---------------------------------------------- across the two packages

def _numpy_tree():
    rng = np.random.default_rng(0)
    return {
        "emb": rng.standard_normal((6, 4)).astype(np.float32),
        "layers": [{"w": rng.standard_normal((4, 4)).astype(np.float32),
                    "b": rng.standard_normal((4,)).astype(np.float32)}
                   for _ in range(2)],
        "step": np.asarray(11, np.int32),
        "ids": rng.integers(-1000, 1000, size=(7,)).astype(np.int32),
    }


def _jax_tree(bf16_keys=("emb", "w")):
    """jnp tree: the ``emb`` and every ``w`` leaf in bf16, the rest f32/int32."""
    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return jnp.asarray(node, jnp.bfloat16 if key in bf16_keys else None)
    return conv(_numpy_tree())


def _torch_of(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jtree = _jax_tree()
    jax_save(str(tmp_path), 4, jtree)
    want = _torch_of(jtree)
    restored = restore_checkpoint(str(tmp_path), 4, zeros_like(want))
    assert restored["emb"].dtype == torch.bfloat16
    assert restored["ids"].dtype == torch.int32
    assert_bits_equal(restored, want)


def test_port_checkpoint_restores_into_jax(tmp_path):
    jtree = _jax_tree()
    save_checkpoint(str(tmp_path), 5, _torch_of(jtree))
    restored = jax_restore(str(tmp_path), 5,
                           jax.tree_util.tree_map(jnp.zeros_like, jtree))
    assert restored["layers"][1]["w"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_manifests_agree_across_the_packages(tmp_path):
    jtree = _jax_tree()
    jax_save(str(tmp_path / "jax"), 1, jtree)
    save_checkpoint(str(tmp_path / "torch"), 1, _torch_of(jtree))
    docs = [json.load(open(tmp_path / side / "step_00000001" / "manifest.json"))
            for side in ("jax", "torch")]
    assert docs[0]["leaves"] == docs[1]["leaves"]
    assert [e["path"] for e in docs[1]["leaves"]] == [
        "emb", "ids", "layers/0/b", "layers/0/w", "layers/1/b", "layers/1/w",
        "step"]
    assert docs[0]["files"].keys() == docs[1]["files"].keys()


def test_reduced_model_params_cross_from_jax(tmp_path):
    """A reduced internlm2's params saved by the reference land in the port's
    own param tree bit for bit (same paths, bf16 through its bits)."""
    jparams = jax_init_params(jax_get_arch("internlm2-1.8b").reduced(),
                              jax.random.PRNGKey(0))
    jax_save(str(tmp_path), 7, jparams)
    target = init_params(get_arch("internlm2-1.8b").reduced(), device="cpu", seed=1)
    restored = restore_checkpoint(str(tmp_path), 7, target)
    assert_bits_equal(restored, _torch_of(jparams))
    assert len(leaves(restored)) == len(jax.tree_util.tree_leaves(jparams)) > 5
    assert {t.dtype for t in leaves(restored)} == {t.dtype for t in leaves(target)}


def test_elastic_restore_into_model(tmp_path):
    """Save a reduced model's state, restore into a fresh instance."""
    cfg = get_arch("internlm2-1.8b").reduced()
    params = init_params(cfg, device="cpu", seed=0)
    opt = init_opt_state(params, cfg)
    save_checkpoint(str(tmp_path), 7, {"params": params, "opt": opt})
    fresh = {"params": init_params(cfg, device="cpu", seed=1),
             "opt": init_opt_state(init_params(cfg, device="cpu", seed=1), cfg)}
    restored = restore_checkpoint(str(tmp_path), 7, fresh)
    assert_bits_equal(restored["params"], params)
    assert_bits_equal(restored["opt"], opt)
    assert restored["opt"]["step"].dtype == torch.int32


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))


def test_train_state_crosses_from_the_port_to_jax(tmp_path):
    cfg = get_arch("internlm2-1.8b").reduced()
    params = init_params(cfg, device="cpu", seed=0)
    step = make_train_step(cfg, ShapeConfig("t", "train", 32, 2), total_steps=4)
    params, opt, _ = step(params, init_opt_state(params, cfg),
                          {"tokens": torch.from_numpy(_tokens(cfg))})
    assert int(opt["step"]) == 1
    state = {"params": params, "opt": opt}
    save_checkpoint(str(tmp_path), 1, state)
    jcfg = jax_get_arch("internlm2-1.8b").reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    restored = jax_restore(str(tmp_path), 1, {"params": jparams,
                                              "opt": jax_init_opt_state(jparams, jcfg)})
    assert int(restored["opt"]["step"]) == 1
    assert restored["opt"]["step"].dtype == jnp.int32
    got = jax.tree_util.tree_leaves(restored)
    assert len(got) == len(leaves(state))
    for a, b in zip(got, leaves(state)):
        assert a.dtype.name == str(b.dtype).removeprefix("torch.")
        assert raw(a) == raw(b)


def test_train_state_crosses_from_jax_to_the_port(tmp_path):
    jcfg = jax_get_arch("internlm2-1.8b").reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_train_step(jcfg, JaxShapeConfig("t", "train", 32, 2),
                                        total_steps=4))
    jparams, jopt, _ = jstep(jparams, jax_init_opt_state(jparams, jcfg),
                             {"tokens": jnp.asarray(_tokens(jcfg), jnp.int32)})
    jax_save(str(tmp_path), 1, {"params": jparams, "opt": jopt})
    cfg = get_arch("internlm2-1.8b").reduced()
    target = init_params(cfg, device="cpu", seed=1)
    restored = restore_checkpoint(str(tmp_path), 1, {
        "params": target, "opt": init_opt_state(target, cfg)})
    assert int(restored["opt"]["step"]) == 1
    assert restored["opt"]["step"].dtype == torch.int32
    want = _torch_of({"params": jparams, "opt": jopt})
    assert_bits_equal(restored, want)
    assert {t.dtype for t in leaves(restored["opt"]["m"])} == {torch.float32}
