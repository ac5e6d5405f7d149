"""The port's gradient compression against the reference's.

``topk_compress`` (sent values and residuals, ties included),
``int8_quantize`` (codes and scales, rounding half to even, f32 and bf16
leaves) and ``quantize_tree`` equal the reference's bit for bit on the same
numpy inputs; the reference's own three compression tests
(``test_pipeline_runtime.py``) hold on the port.  ``compressed_psum`` at
world size 1 (gloo, in process) equals the reference's on a one-device
("pod",) mesh; at 4 ranks with different grads on each
(``_torch_sharded_jobs.py psum``) it equals the reference formula in
numpy, exactly in f32: the MAX of the scales, the int32 sum of the codes,
times the scale over n.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.runtime import compression as jc
from repro_torch.runtime import compression as tc
from repro_torch.runtime import (
    compressed_psum,
    init_error_state,
    int8_dequantize,
    int8_quantize,
    topk_compress,
)

from _torch_sharded_jobs import run_ranks


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _grads(seed):
    rng = np.random.default_rng(seed)
    ties = np.repeat(rng.standard_normal(4), 8).astype(np.float32)   # equal magnitudes
    return {"w": rng.standard_normal((16, 24)).astype(np.float32),
            "b": [rng.standard_normal(37).astype(np.float32), ties],
            "s": rng.standard_normal(()).astype(np.float32)}


@pytest.mark.parametrize("k_ratio", [0.01, 0.1, 0.5])
def test_topk_compress_matches_reference(k_ratio):
    g = _grads(0)
    e = jax.tree_util.tree_map(lambda a: 0.1 * a, _grads(1))
    sj, ej = jc.topk_compress(jax.tree_util.tree_map(_j, g),
                              jax.tree_util.tree_map(_j, e), k_ratio)
    from repro_torch.tree import tree_leaves, tree_map
    st, et = topk_compress(tree_map(_t, g), tree_map(_t, e), k_ratio)
    for a, b in zip(tree_leaves(st) + tree_leaves(et),
                    jax.tree_util.tree_leaves(sj) + jax.tree_util.tree_leaves(ej)):
        assert np.array_equal(_bits(a.numpy()), _bits(np.asarray(b)))


def test_topk_compress_bf16_leaf_matches_reference():
    g = np.random.default_rng(2).standard_normal((8, 32)).astype(np.float32)
    sj, ej = jc.topk_compress({"h": _j(g, jnp.bfloat16)}, {"h": jnp.zeros((8, 32))}, 0.2)
    st, et = topk_compress({"h": _t(g, torch.bfloat16)}, {"h": torch.zeros(8, 32)}, 0.2)
    assert st["h"].dtype == torch.bfloat16
    assert np.array_equal(st["h"].float().numpy(), np.asarray(sj["h"].astype(jnp.float32)))
    assert np.array_equal(et["h"].numpy(), np.asarray(ej["h"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_quantize_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(300).astype(np.float32) * 3
    # exact halves of the step: rounding half to even must pick the same codes
    x[:8] = (np.arange(8) + 0.5) * (np.abs(x).max() / 127.0)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    qj, sj = jc.int8_quantize(_j(x, jd))
    qt, st = int8_quantize(_t(x, td))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(_bits(st.numpy()), _bits(np.asarray(sj)))
    assert np.array_equal(int8_dequantize(qt, st).numpy(),
                          np.asarray(jc.int8_dequantize(qj, sj)))


def test_quantize_tree_matches_reference():
    g = _grads(4)
    qj = jc.quantize_tree(jax.tree_util.tree_map(_j, g))
    from repro_torch.tree import tree_map
    qt = tc.quantize_tree(tree_map(_t, g))
    pairs = [(qt["w"], qj["w"]), (qt["b"][0], qj["b"][0]), (qt["b"][1], qj["b"][1]),
             (qt["s"], qj["s"])]
    for (q, s), (q2, s2) in pairs:
        assert np.array_equal(q.numpy(), np.asarray(q2))
        assert np.array_equal(_bits(s.numpy()), _bits(np.asarray(s2)))


def test_init_error_state_is_f32_zeros():
    e = init_error_state({"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.ones(2)]})
    assert e["a"].dtype == torch.float32 and not e["a"].any() and e["b"][0].shape == (2,)


# the reference's own three, on the port
def test_int8_quant_bounded_error():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(256,)).astype(np.float32))
    q, s = int8_quantize(x)
    err = torch.abs(int8_dequantize(q, s) - x).max()
    assert float(err) <= float(s) + 1e-6


def test_topk_error_feedback_conserves_mass():
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(64, 64))
                               .astype(np.float32))}
    e = init_error_state(g)
    sent, e2 = topk_compress(g, e, k_ratio=0.1)
    np.testing.assert_allclose(sent["w"].numpy() + e2["w"].numpy(), g["w"].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float((sent["w"] == 0).float().mean()) > 0.85


def test_topk_error_reenters():
    g = {"w": torch.ones(10)}
    e = init_error_state(g)
    _, e1 = topk_compress(g, e, k_ratio=0.1)
    sent2, _ = topk_compress(g, e1, k_ratio=0.1)
    assert float(torch.abs(sent2["w"]).max()) >= 1.0


# ------------------------------------------------------------ compressed_psum
def test_compressed_psum_world_one_matches_reference():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import init_process_group

    rng = np.random.default_rng(5)
    w = rng.standard_normal((12, 7)).astype(np.float32)
    h = rng.standard_normal(40).astype(np.float32)
    pod = Mesh(np.array(jax.devices()[:1]), ("pod",))
    ref = jc.compressed_psum({"w": _j(w), "h": _j(h, jnp.bfloat16)}, pod, axis="pod")
    started = init_process_group("cpu")
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
        out = compressed_psum({"w": _t(w), "h": _t(h, torch.bfloat16)}, mesh, axis="pod")
    finally:
        if started:
            dist.destroy_process_group()
    assert out["h"].dtype == torch.bfloat16
    assert np.array_equal(_bits(out["w"].numpy()), _bits(np.asarray(ref["w"])))
    assert np.array_equal(out["h"].float().numpy(),
                          np.asarray(ref["h"].astype(jnp.float32)))
    # one rank: the mean is the dequantized quantization of its grad
    q, s = jc.int8_quantize(_j(w))
    assert np.array_equal(out["w"].numpy(), np.asarray(jc.int8_dequantize(q, s)))


def _psum_formula(per_rank):
    """The reference's compressed mean in numpy, f32 throughout."""
    n = len(per_rank)
    peak = max(np.float32(max(np.abs(g).max(), np.float32(1e-12))) for g in per_rank)
    scale = np.float32(peak / np.float32(127.0))
    total = sum(np.clip(np.round(g / scale), -127, 127).astype(np.int32) for g in per_rank)
    return (total.astype(np.float32) * scale / np.float32(n)).astype(np.float32)


def test_compressed_psum_four_ranks_matches_formula(tmp_path):
    run_ranks(tmp_path, "psum")
    got = dict(np.load(tmp_path / "result.npz"))
    ws, bs = [], []
    for r in range(4):          # each rank's grads, as the jobs draw them
        rng = np.random.default_rng(100 + r)
        ws.append((rng.standard_normal((3, 5)) * (r + 1)).astype(np.float32))
        bs.append(rng.standard_normal(7).astype(np.float32))
    for key, per_rank in (("w", ws), ("b", bs)):
        want = _psum_formula(per_rank)
        assert np.array_equal(_bits(got[f"psum4/{key}"]), _bits(want)), key
        mean = np.mean(per_rank, axis=0)
        scale = max(np.abs(g).max() for g in per_rank) / 127.0
        assert np.abs(got[f"psum4/{key}"] - mean).max() <= scale / 2 + 1e-6
