"""The port's kernel oracles against the JAX reference, the wrappers' CPU
path, and (on a CUDA card only) each kernel against its plain version.

Shapes and tolerances are those of ``tests/test_kernels.py``: 2e-5 relative
in float32 and 2e-2 in bfloat16 for attention (bf16 rounding of the inputs
and of the output dominates); exact (max |delta| == 0.0) for the dispatch
scores, whose 0/1 and dyadic operands make every fp32 partial sum exact.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.dispatch_score.ops import (
    dispatch_score_update,
    dispatch_score_update_ref,
    dispatch_scores,
    dispatch_scores_ref,
)
from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention

ATTN_SHAPES = [
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),      # GQA rep=2
    (1, 256, 256, 4, 1, 128, True, 0),     # MQA
    (2, 128, 256, 4, 4, 64, True, 0),      # kv longer than q (aligned ends)
    (1, 256, 256, 2, 2, 64, False, 0),     # bidirectional (encoder)
    (1, 256, 256, 2, 2, 64, True, 64),     # sliding window
    (1, 512, 512, 2, 1, 128, True, 128),
]


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _np(x):
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def attn_inputs(B, Sq, Skv, H, Hkv, D, seed=0):
    """float32 numpy q, k, v; bf16 cases round them on each side (both round
    to nearest even, so JAX and torch see the same bf16 values)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def _torch(arrs, dtype, device="cpu"):
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return [torch.from_numpy(a).to(device=device, dtype=dt) for a in arrs]


@pytest.fixture(scope="module")
def jref():
    """The JAX reference's kernels module (absent where JAX is not installed,
    as on the machine with the card: there only the card tests run)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.kernels as kernels
    return kernels, jnp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ and run only there")
    return torch.device("cuda")


# ------------------------------------------------------------ flash attention
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,window", ATTN_SHAPES)
def test_attention_ref_matches_jax_ref(jref, B, Sq, Skv, H, Hkv, D, causal, window,
                                      dtype):
    kernels, jnp = jref
    arrs = attn_inputs(B, Sq, Skv, H, Hkv, D)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    ref = kernels.attention_ref(*(jnp.asarray(a).astype(jdt) for a in arrs),
                                causal=causal, window=window)
    out = attention_ref(*_torch(arrs, dtype), causal=causal, window=window)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    assert rel_err(_np(out), _np(ref)) < tol


@pytest.mark.parametrize("shape,window,blocks", [
    ((1, 128, 128, 2, 2, 64), 0, 64),
    ((1, 128, 128, 4, 2, 32), 32, 32),
])
def test_attention_ref_matches_pallas_interpret(jref, shape, window, blocks):
    kernels, jnp = jref
    q, k, v = attn_inputs(*shape, seed=1)
    pallas = kernels.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=True, window=window, block_q=blocks,
                                     block_k=blocks, interpret=True)
    out = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), window=window)
    assert rel_err(out.numpy(), pallas) < 2e-5


def test_flash_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in attn_inputs(1, 16, 16, 4, 2, 16))
    before = flash_attention.launches
    for window in (0, 4):
        assert torch.equal(flash_attention(q, k, v, window=window),
                           attention_ref(q, k, v, window=window))
    assert flash_attention.launches == before     # plain versions never count


def test_flash_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 4, 3, 16)
    k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError):
        flash_attention(q, k, k)                  # H not a multiple of Hkv
    with pytest.raises(ValueError):
        flash_attention(q[0], k[0], k[0])


# ----------------------------------------------------------- dispatch scoring
def score_inputs(W, O, E, density):
    rng = np.random.default_rng(42)
    demand = (rng.random((W, O)) < density).astype(np.float32)
    presence = (rng.random((E, O)) < 0.3).astype(np.float32)
    presence *= rng.choice([1.0, 0.5, 0.25], size=(E, O)).astype(np.float32)
    return demand, presence


def update_inputs(W, K, E):
    rng = np.random.default_rng(7)
    scores = (rng.integers(0, 8, (W, E))
              * rng.choice([1.0, 0.5, 0.25], size=(W, E))).astype(np.float32)
    mult = rng.integers(0, 3, (W, K)).astype(np.float32)
    delta = np.zeros((K, E), dtype=np.float32)
    delta[np.arange(K), rng.integers(0, E, K)] = rng.choice(
        [1.0, 0.5, 0.25, -0.5, -1.0], size=K)
    return scores, mult, delta


@pytest.mark.parametrize("W,O,E,density", [
    (16, 64, 4, 0.2), (256, 512, 64, 0.05), (300, 1200, 96, 0.02)])
def test_dispatch_scores_ref_matches_jax_exactly(jref, W, O, E, density):
    kernels, jnp = jref
    demand, presence = score_inputs(W, O, E, density)
    exact = demand.astype(np.float64) @ presence.astype(np.float64).T
    port = dispatch_scores_ref(torch.from_numpy(demand), torch.from_numpy(presence))
    jref_out = kernels.dispatch_scores_ref(jnp.asarray(demand), jnp.asarray(presence))
    pallas = kernels.dispatch_scores(jnp.asarray(demand), jnp.asarray(presence),
                                     interpret=True)
    wrapped = dispatch_scores(torch.from_numpy(demand), torch.from_numpy(presence))
    for other in (jref_out, pallas, exact):
        assert np.abs(port.numpy().astype(np.float64)
                      - np.asarray(other, np.float64)).max() == 0.0
    assert torch.equal(wrapped, port)


@pytest.mark.parametrize("W,K,E", [(16, 3, 4), (256, 128, 64), (300, 200, 96)])
def test_dispatch_score_update_ref_matches_jax_exactly(jref, W, K, E):
    kernels, jnp = jref
    scores, mult, delta = update_inputs(W, K, E)
    exact = scores.astype(np.float64) + mult.astype(np.float64) @ delta
    args = [torch.from_numpy(a) for a in (scores, mult, delta)]
    port = dispatch_score_update_ref(*args)
    jargs = [jnp.asarray(a) for a in (scores, mult, delta)]
    jref_out = kernels.dispatch_score_update_ref(*jargs)
    pallas = kernels.dispatch_score_update(*jargs, interpret=True)
    for other in (jref_out, pallas, exact):
        assert np.abs(port.numpy().astype(np.float64)
                      - np.asarray(other, np.float64)).max() == 0.0
    assert torch.equal(dispatch_score_update(*args), port)


def test_dispatch_score_update_empty_epoch_is_identity():
    scores = torch.arange(12.0).reshape(3, 4)
    before = dispatch_score_update.launches
    out = dispatch_score_update(scores, torch.zeros((3, 0)), torch.zeros((0, 4)))
    assert torch.equal(out, scores)
    assert dispatch_score_update.launches == before


# --------------------------------------------------------- on the card only
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,window", ATTN_SHAPES + [
    (1, 16, 16, 16, 8, 128, True, 0),      # the serving prefill
    (1, 70, 70, 2, 2, 16, True, 16),       # ragged tiles, window
])
def test_flash_kernel_matches_plain_on_card(cuda_device, B, Sq, Skv, H, Hkv, D,
                                            causal, window, dtype):
    q, k, v = _torch(attn_inputs(B, Sq, Skv, H, Hkv, D), dtype, cuda_device)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    assert rel_err(_np(out), _np(ref)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("W,O,E", [(16, 64, 4), (300, 1200, 96), (64, 256, 4)])
def test_dispatch_kernels_exact_on_card(cuda_device, W, O, E):
    demand, presence = score_inputs(W, O, E, 0.1)
    out = dispatch_scores(torch.from_numpy(demand).to(cuda_device),
                          torch.from_numpy(presence).to(cuda_device))
    exact = demand.astype(np.float64) @ presence.astype(np.float64).T
    assert np.abs(out.cpu().numpy() - exact).max() == 0.0
    scores, mult, delta = update_inputs(W, 7, E)
    out = dispatch_score_update(*(torch.from_numpy(a).to(cuda_device)
                                  for a in (scores, mult, delta)))
    exact = scores.astype(np.float64) + mult.astype(np.float64) @ delta
    assert np.abs(out.cpu().numpy() - exact).max() == 0.0
