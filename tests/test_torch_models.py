"""Per-architecture smokes of the port over all ten archs (reduced configs on
the CPU), the port of ``tests/test_models.py``, and the dry run's inputs
against the reference's.

Smokes: the loss is finite and near ln(vocab) at init, a train step at two
microbatches changes the params, prefill then decode keep the logits'
shape and the cache tree, ``input_specs`` covers all 33 cells, and the
reference's structural checks (the long_500k skips, gemma3's 5:1 pattern,
the ring cache's positions).

Parity: ``param_specs`` equals the reference's ``param_specs``
(``jax.eval_shape``) leaf for leaf, in path, shape and dtype, for every
arch at full size, and ``input_specs`` equals the reference's for every
cell; both are built without allocating (qwen3-moe-235b-a22b's 235 B
params among them).
"""

import resource

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import input_specs as jax_input_specs
from repro.models import param_specs as jax_param_specs
from repro_torch.configs import ALL_ARCHS, cells, get_arch
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.models import (
    Spec,
    encdec,
    init_opt_state,
    init_params,
    input_specs,
    lm,
    make_decode_step,
    make_loss_fn,
    make_prefill_step,
    make_step,
    make_train_step,
    param_specs,
    synth_inputs,
)
from repro_torch.tree import tree_flatten_with_paths, tree_leaves

TRAIN = ShapeConfig("smoke_train", "train", 64, 2)
PREFILL = ShapeConfig("smoke_prefill", "prefill", 64, 2)
DECODE = ShapeConfig("smoke_decode", "decode", 64, 2)


@pytest.fixture(scope="module")
def reduced_params():
    out = {}
    for name in ALL_ARCHS:
        cfg = get_arch(name).reduced()
        out[name] = (cfg, init_params(cfg, device="cpu", seed=0))
    return out


def _inputs(cfg, shape):
    return synth_inputs(cfg, shape, device="cpu")


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_forward_loss_finite(name, reduced_params):
    cfg, params = reduced_params[name]
    with torch.no_grad():
        loss, metrics = make_loss_fn(cfg, TRAIN)(params, _inputs(cfg, TRAIN))
    assert np.isfinite(float(loss))
    assert 3.0 < float(metrics["loss"]) < 12.0  # ~ln(vocab) at init


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_train_step_updates_params(name, reduced_params):
    cfg, params = reduced_params[name]
    step = make_train_step(cfg, TRAIN, microbatches=2)
    opt = init_opt_state(params, cfg)
    new_params, new_opt, metrics = step(params, opt, _inputs(cfg, TRAIN))
    assert np.isfinite(float(metrics["loss"]))
    assert int(new_opt["step"]) == 1
    changed = [float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(params), tree_leaves(new_params))]
    assert max(changed) > 0


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_prefill_then_decode(name, reduced_params):
    cfg, params = reduced_params[name]
    with torch.no_grad():
        logits, caches = make_prefill_step(cfg, PREFILL)(params, _inputs(cfg, PREFILL))
        assert logits.shape == (2, cfg.padded_vocab)
        assert torch.isfinite(logits[:, :cfg.vocab_size]).all()
        batch = _inputs(cfg, DECODE)
        before = [(p, tuple(x.shape), x.dtype)
                  for p, x in zip(*tree_flatten_with_paths(batch["caches"])[:2])]
        dl, new_caches = make_decode_step(cfg)(params, batch)
    assert dl.shape == (2, cfg.padded_vocab)
    assert torch.isfinite(dl[:, :cfg.vocab_size]).all()
    # the cache tree is kept: same paths, shapes and dtypes
    after = [(p, tuple(x.shape), x.dtype)
             for p, x in zip(*tree_flatten_with_paths(new_caches)[:2])]
    assert after == before


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_input_specs_cover_all_cells(name):
    cfg = get_arch(name)
    for shape in cells(cfg):
        leaves = tree_leaves(input_specs(cfg, shape))
        assert leaves, (name, shape.name)
        for leaf in leaves:
            assert isinstance(leaf, Spec)
            assert all(d > 0 for d in leaf.shape)


def test_cells_skip_long500k_for_full_attention():
    assert all(s.name != "long_500k" for s in cells(get_arch("llama3-8b")))
    assert any(s.name == "long_500k" for s in cells(get_arch("rwkv6-3b")))
    assert any(s.name == "long_500k" for s in cells(get_arch("recurrentgemma-9b")))
    assert any(s.name == "long_500k" for s in cells(get_arch("gemma3-1b")))
    total = sum(len(cells(get_arch(n))) for n in ALL_ARCHS)
    assert total == 33  # 40 cells - 7 documented long_500k skips


def test_gemma3_pattern_five_to_one():
    cfg = get_arch("gemma3-1b")
    pat = cfg.pattern()
    assert len(pat) == 26
    assert pat[:6] == ("L", "L", "L", "L", "L", "A")


def test_decode_positions_mask_ring_cache():
    """'L' ring cache slots beyond the current position are masked out."""
    kpos = lm._ring_positions(5, 8)
    assert kpos.shape == (8,)
    assert int(kpos.max()) == 5
    assert (kpos <= 5).all()
    kpos2 = lm._ring_positions(20, 8)
    assert sorted(kpos2.tolist()) == list(range(13, 21))


def test_make_step_dispatches_on_the_shape_kind():
    cfg = get_arch("internlm2-1.8b").reduced()
    assert make_step(cfg, PREFILL).func is lm.lm_prefill
    assert make_step(cfg, DECODE).func is lm.lm_decode
    whisper = get_arch("whisper-medium").reduced()
    assert make_step(whisper, PREFILL).func is encdec.encdec_prefill
    assert make_step(whisper, DECODE).func is encdec.encdec_decode
    assert make_step(cfg, TRAIN).__name__ == "train_step"


def test_synth_inputs_match_their_specs():
    for name in ("internlm2-1.8b", "whisper-medium", "llava-next-34b", "rwkv6-3b"):
        cfg = get_arch(name).reduced()
        for shape in (TRAIN, PREFILL, DECODE):
            specs = tree_flatten_with_paths(input_specs(cfg, shape))
            made = tree_flatten_with_paths(synth_inputs(cfg, shape, device="cpu"))
            assert made[0] == specs[0]
            for spec, x in zip(specs[1], made[1]):
                assert (tuple(x.shape), x.dtype) == (spec.shape, spec.dtype)
            batch = dict(zip(made[0], made[1]))
            ids = batch.get("tokens", batch.get("token"))
            assert 0 <= int(ids.min()) and int(ids.max()) < cfg.vocab_size
            if shape.kind == "decode":
                assert int(batch["pos"]) == 7


# -------------------------------------------------- parity with the reference
def _port_leaves(tree):
    paths, leaves, _ = tree_flatten_with_paths(tree)
    return [(p, tuple(s.shape), str(s.dtype).replace("torch.", ""))
            for p, s in zip(paths, leaves)]


def _ref_leaves(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp),
             tuple(s.shape), str(np.dtype(s.dtype)))
            for kp, s in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_param_specs_equal_reference(name):
    """Full size, leaf for leaf: path, shape and dtype."""
    port = _port_leaves(param_specs(get_arch(name)))
    assert port and port == _ref_leaves(jax_param_specs(jax_get_arch(name)))


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_input_specs_equal_reference(name):
    for shape in cells(get_arch(name)):
        port = _port_leaves(input_specs(get_arch(name), shape))
        assert port == _ref_leaves(jax_input_specs(jax_get_arch(name), shape)), shape.name


def test_param_specs_allocate_nothing():
    """qwen3-moe-235b-a22b's tree (470 GB in bf16) builds in a few MB."""
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    specs = param_specs(get_arch("qwen3-moe-235b-a22b"))
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(specs))
    assert n > 235e9
    assert grown_kb < 1 << 20                   # under 1 GiB
    decode = input_specs(get_arch("llama3-8b"), SHAPES["decode_32k"])
    assert decode["caches"]["groups"]["b0"]["k"].shape == (32, 128, 32768, 8, 128)
