"""The port's kernel oracles against the JAX reference, the wrappers' CPU
path, and (on a CUDA card only) each kernel against its plain version.

Shapes and tolerances are those of ``tests/test_kernels.py``: 2e-5 relative
in float32 and 2e-2 in bfloat16 for attention (bf16 rounding of the inputs
and of the output dominates); exact (max |delta| == 0.0) for the dispatch
scores, whose 0/1 and dyadic operands make every fp32 partial sum exact;
1e-5 in float32 and 3e-2 in bfloat16 for the grouped expert GEMM; 1e-5 for
the RG-LRU scan; 1e-4 for WKV6, and 1e-3 (and finite) under strong decay.
The two scans are also checked with a non-zero carried-in state and on
their final state, which the port's kernels return and the TPU kernels do
not (those start from zero: the Pallas comparisons use a zero state).
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
from repro_torch.kernels.moe_gmm.ops import gmm_ref, moe_gmm
from repro_torch.kernels.rglru_scan.ops import (
    rglru_gated_ref,
    rglru_gated_scan,
    rglru_ref,
    rglru_scan,
)
from repro_torch.kernels.rwkv6_scan.ops import wkv6, wkv6_ref

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


# (B, S, H, Hkv, D, window, [(first row, rows)]): one sequence shard of a
# prefill at a time; GQA at 1, 2 and 8 query heads a KV head, causal and
# windowed, the direct and the chunked reference paths
OFFSET_CASES = [
    (2, 64, 2, 2, 16, 0, [(0, 16), (16, 16), (48, 16), (5, 11)]),
    (1, 128, 4, 2, 32, 24, [(0, 32), (64, 32), (96, 32), (70, 3)]),
    (2, 256, 8, 1, 16, 0, [(0, 64), (192, 64), (100, 1)]),
    (1, 256, 8, 1, 64, 48, [(128, 32), (224, 32)]),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,window,blocks", OFFSET_CASES)
def test_attention_ref_with_offset_matches_reference_attention_core(
        jref, B, S, H, Hkv, D, window, blocks, dtype):
    """Rows ``a .. a + n`` of the query at ``q_offset = a`` against the
    reference model's ``attention_core`` with ``qpos = arange(a, a + n)``
    over keys at ``arange(S)`` (chunked at 64 keys past 128)."""
    _, jnp = jref
    from repro.models.layers import attention_core

    q, k, v = attn_inputs(B, S, S, H, Hkv, D, seed=2)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tq, tk, tv = _torch((q, k, v), dtype)
    kpos = jnp.arange(S)
    for a, n in blocks:
        ref = attention_core(jnp.asarray(q[:, a:a + n]).astype(jdt),
                             jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt),
                             jnp.arange(a, a + n), kpos, causal=True, window=window,
                             chunk=64 if S > 128 else 1024)
        out = attention_ref(tq[:, a:a + n], tk, tv, causal=True, window=window,
                            q_offset=a)
        tol = 2e-2 if dtype == "bf16" else 2e-5
        assert rel_err(_np(out), _np(ref)) < tol, (a, n)


@pytest.mark.parametrize("B,S,H,Hkv,D,window,blocks", OFFSET_CASES)
def test_attention_ref_with_offset_is_the_whole_sequence_rows(B, S, H, Hkv, D, window,
                                                              blocks):
    """In f32 a shard's rows at their offset are, bit for bit, the same rows
    of the whole sequence's attention.  A single row's scores come from a
    matrix-vector product, whose summation order differs: within 1e-6."""
    q, k, v = _torch(attn_inputs(B, S, S, H, Hkv, D, seed=3), "f32")
    whole = attention_ref(q, k, v, causal=True, window=window)
    for a, n in blocks:
        part = flash_attention(q[:, a:a + n], k, v, causal=True, window=window,
                               q_offset=a)
        if n > 1:
            assert torch.equal(part, whole[:, a:a + n]), (a, n)
        else:
            assert rel_err(part.numpy(), whole[:, a:a + n].numpy()) < 1e-6, (a, n)


def test_flash_wrapper_refuses_bad_offsets():
    q, k, v = (torch.from_numpy(a) for a in attn_inputs(1, 8, 16, 2, 2, 16))
    with pytest.raises(ValueError, match=">= 0"):
        flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="q_offset \\+ Sq <= Skv"):
        flash_attention(q, k, v, q_offset=9)                 # causal
    with pytest.raises(ValueError, match="q_offset \\+ Sq <= Skv"):
        flash_attention(q, k, v, causal=False, window=4, q_offset=9)
    # unmasked, the offset cannot matter; the default is the aligned end
    assert torch.equal(flash_attention(q, k, v, causal=False, q_offset=9),
                       flash_attention(q, k, v, causal=False))
    assert torch.equal(flash_attention(q, k, v, q_offset=8), flash_attention(q, k, v))


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


# ------------------------------------------------------------ moe gmm (K4)
GMM_SHAPES = [(2, 128, 256, 128), (4, 256, 512, 256), (8, 128, 128, 512)]
GMM_TOL = {"f32": 1e-5, "bf16": 3e-2}


def gmm_inputs(E, C, D, F, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, D)).astype(np.float32),
            rng.standard_normal((E, D, F)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("E,C,D,F", GMM_SHAPES)
def test_gmm_ref_matches_jax_ref(jref, E, C, D, F, dtype):
    kernels, jnp = jref
    arrs = gmm_inputs(E, C, D, F)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    ref = kernels.gmm_ref(*(jnp.asarray(a).astype(jdt) for a in arrs))
    x, w = _torch(arrs, dtype)
    out = gmm_ref(x, w)
    assert out.dtype == x.dtype
    assert rel_err(_np(out), _np(ref)) < GMM_TOL[dtype]
    # the fp32 output the MoE FFN asks for is the unrounded sum
    exact = np.einsum("ecd,edf->ecf", *(_np(t).astype(np.float64) for t in (x, w)))
    assert rel_err(_np(gmm_ref(x, w, torch.float32)), exact) < 1e-5


def test_gmm_ref_matches_pallas_interpret(jref):
    kernels, jnp = jref
    x, w = gmm_inputs(2, 128, 256, 128, seed=3)
    pallas = kernels.moe_gmm(jnp.asarray(x), jnp.asarray(w), block_c=128,
                             block_f=128, block_d=128, interpret=True)
    out = gmm_ref(torch.from_numpy(x), torch.from_numpy(w))
    assert rel_err(out.numpy(), pallas) < 1e-5


def gmm_counts(E, C, kind, seed=5):
    """int32 [E] fill counts: every expert empty, every expert full, or
    ragged (0, C and values between, drawn from a seed)."""
    if kind == "empty":
        return np.zeros(E, np.int32)
    if kind == "full":
        return np.full(E, C, np.int32)
    c = np.random.default_rng(seed).integers(0, C + 1, E).astype(np.int32)
    c[0], c[-1] = 0, C
    return c


def dead_rows(E, C, counts):
    return np.arange(C)[None, :] >= counts[:, None]        # [E, C]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["empty", "full", "ragged"])
@pytest.mark.parametrize("E,C,D,F", [(8, 16, 64, 48), (4, 13, 32, 24)])
def test_gmm_ref_with_counts_matches_jax_ref(jref, E, C, D, F, kind, dtype):
    """With counts, the plain version equals the JAX gmm_ref on inputs whose
    rows at and past each count are zero."""
    kernels, jnp = jref
    x, w = gmm_inputs(E, C, D, F)
    counts = gmm_counts(E, C, kind)
    x[dead_rows(E, C, counts)] = 0.0
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    ref = kernels.gmm_ref(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt))
    xt, wt = _torch((x, w), dtype)
    out = gmm_ref(xt, wt, counts=torch.from_numpy(counts))
    assert out.dtype == xt.dtype
    assert rel_err(_np(out), _np(ref)) < GMM_TOL[dtype]
    assert not _np(out)[dead_rows(E, C, counts)].any()


@pytest.mark.parametrize("e_lo,n_e,c_lo,n_c", [
    (0, 4, 0, 6), (4, 4, 6, 6), (2, 3, 10, 2), (4, 4, 12, 0)])
def test_gmm_ref_on_a_block_with_shifted_counts_is_that_block(jref, e_lo, n_e, c_lo, n_c):
    """A rank's block of the capacity buffer (experts [e_lo, e_lo + n_e),
    slots [c_lo, c_lo + n_c)) with each expert's fill less the block's
    first slot, ``clamp(fill - c_lo, 0, n_c)``, as the MoE FFN's decode
    step under a mesh passes it: that block of the whole product with the
    whole fills (zero past each fill), within f32 rounding; and of the JAX
    reference on the block with its dead rows zeroed.  An empty block
    gives an empty result."""
    kernels, jnp = jref
    E, C, D, F = 8, 12, 32, 24
    x, w = gmm_inputs(E, C, D, F, seed=7)
    fill = gmm_counts(E, C, "ragged", seed=8)
    whole = gmm_ref(torch.from_numpy(x), torch.from_numpy(w), torch.float32,
                    torch.from_numpy(fill))
    xb = np.ascontiguousarray(x[e_lo:e_lo + n_e, c_lo:c_lo + n_c])
    counts = np.clip(fill[e_lo:e_lo + n_e] - c_lo, 0, n_c).astype(np.int32)
    block = gmm_ref(torch.from_numpy(xb), torch.from_numpy(w[e_lo:e_lo + n_e]),
                    torch.float32, torch.from_numpy(counts))
    want = whole[e_lo:e_lo + n_e, c_lo:c_lo + n_c]
    assert block.shape == want.shape == (n_e, n_c, F)
    if n_c == 0:
        return
    assert rel_err(block.numpy(), want.numpy()) < 1e-6
    xb[dead_rows(n_e, n_c, counts)] = 0.0
    ref = kernels.gmm_ref(jnp.asarray(xb), jnp.asarray(w[e_lo:e_lo + n_e]))
    assert rel_err(block.numpy(), np.asarray(ref)) < GMM_TOL["f32"]


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_gmm_ref_counts_mask_nan_in_dead_rows(out_dtype):
    """NaN planted in x's dead rows, and in the weights of experts with no
    live row, gives exact zeros there and the unmasked product elsewhere."""
    E, C, D, F = 6, 8, 32, 40
    x, w = gmm_inputs(E, C, D, F, seed=4)
    counts = gmm_counts(E, C, "ragged", seed=6)
    dead = dead_rows(E, C, counts)
    clean = x.copy()
    clean[dead] = 0.0
    x[dead] = np.nan
    w[counts == 0] = np.nan
    for dtype in ("f32", "bf16"):
        xt, wt = _torch((x, w), dtype)
        ct = torch.from_numpy(counts)
        out = _np(gmm_ref(xt, wt, out_dtype, ct))
        assert np.isfinite(out).all()
        assert (out[dead] == 0.0).all()
        wc = w.copy()
        wc[counts == 0] = 0.0
        want = _np(gmm_ref(*_torch((clean, wc), dtype), out_dtype))
        assert np.array_equal(out[~dead], want[~dead])


# ---------------------------------------------------------- rglru scan (K5)
RGLRU_SHAPES = [(1, 128, 256), (2, 256, 512), (3, 512, 128)]


def rglru_inputs(B, T, W, seed=3):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, W))))
    return (a.astype(np.float32), rng.standard_normal((B, T, W)).astype(np.float32),
            rng.standard_normal((B, W)).astype(np.float32))


@pytest.mark.parametrize("B,T,W", RGLRU_SHAPES)
def test_rglru_ref_matches_jax_ref_with_state(jref, B, T, W):
    kernels, jnp = jref
    a, b, h0 = rglru_inputs(B, T, W)
    for init in (None, h0):
        y_j, h_j = kernels.rglru_ref(jnp.asarray(a), jnp.asarray(b),
                                     None if init is None else jnp.asarray(init))
        y, h = rglru_ref(torch.from_numpy(a), torch.from_numpy(b),
                         None if init is None else torch.from_numpy(init))
        assert rel_err(y.numpy(), y_j) < 1e-5
        assert rel_err(h.numpy(), h_j) < 1e-5


def test_rglru_ref_matches_pallas_interpret(jref):
    kernels, jnp = jref
    a, b, _ = rglru_inputs(1, 128, 256, seed=4)
    pallas = kernels.rglru_scan(jnp.asarray(a), jnp.asarray(b), block_w=128,
                                chunk=64, interpret=True)
    y, _ = rglru_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert rel_err(y.numpy(), pallas) < 1e-5


def gated_inputs(B, T, W, seed=6):
    """xi, r_logit, i_logit ~ N(0, 1) and lam ~ 0.65 + 0.5 N(0, 1) (a spread
    of decays around the model's initial value), float32 numpy."""
    rng = np.random.default_rng(seed)
    xi, r_logit, i_logit = (rng.standard_normal((B, T, W)).astype(np.float32)
                            for _ in range(3))
    lam = (0.65 + 0.5 * rng.standard_normal(W)).astype(np.float32)
    return xi, r_logit, i_logit, lam, rng.standard_normal((B, W)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,W", [(2, 9, 24), (1, 130, 64), (1, 2048, 16)])
def test_rglru_gated_ref_matches_jax(jref, B, T, W, with_h0, dtype):
    """The gated plain version against the reference's gate chain:
    ``jax.nn.sigmoid`` of the logits into ``repro.models.rglru.rglru_scan``
    (which takes a state, so "no state" is zeros there)."""
    import jax
    from repro.models import rglru as jrg
    _, jnp = jref
    xi, r_logit, i_logit, lam, h0 = gated_inputs(B, T, W)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    xj, rj, ij = (jnp.asarray(t).astype(jdt) for t in (xi, r_logit, i_logit))
    y_j, h_j = jrg.rglru_scan(xj, jax.nn.sigmoid(rj.astype(jnp.float32)),
                              jax.nn.sigmoid(ij.astype(jnp.float32)), jnp.asarray(lam),
                              jnp.asarray(h0 if with_h0 else np.zeros_like(h0)))
    xt, rt, it = _torch((xi, r_logit, i_logit), dtype)
    y, h = rglru_gated_ref(xt, rt, it, torch.from_numpy(lam),
                           torch.from_numpy(h0) if with_h0 else None)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert rel_err(y.numpy(), y_j) < tol
    assert rel_err(h.numpy(), h_j) < tol


@pytest.mark.parametrize("T,chunk", [(65, 65), (2048, 256)])
def test_rglru_ref_long_prompts_match_pallas_interpret(jref, T, chunk):
    """Past the serving prefill: a prompt whose last group of the 8 steps a
    kernel thread loads together is ragged, and a 2,048-step prompt
    (recurrentgemma's attention window), from a zero state."""
    kernels, jnp = jref
    a, b, _ = rglru_inputs(1, T, 256, seed=9)
    pallas = kernels.rglru_scan(jnp.asarray(a), jnp.asarray(b), block_w=128,
                                chunk=chunk, interpret=True)
    y, _ = rglru_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert rel_err(y.numpy(), pallas) < 1e-5


@pytest.mark.parametrize("a_value", [1e-5, 1.0 - 1e-5])
def test_rglru_ref_at_extreme_decays(jref, a_value):
    """a near 0 (the state forgets at once) and near 1 (it sums every
    input), against the reference's scan, with a carried-in state."""
    kernels, jnp = jref
    _, b, h0 = rglru_inputs(2, 65, 32, seed=11)
    a = np.full_like(b, a_value)
    y, h = rglru_ref(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0))
    y_j, h_j = kernels.rglru_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    assert np.isfinite(y.numpy()).all()
    assert rel_err(y.numpy(), y_j) < 1e-5
    assert rel_err(h.numpy(), h_j) < 1e-5


# ----------------------------------------------------------------- wkv6 (K6)
WKV_SHAPES = [(1, 128, 2, 64), (2, 256, 2, 64), (1, 256, 4, 64)]


def wkv_inputs(B, T, H, N, seed=4, decay=None):
    """The decay follows RWKV6's w = exp(-exp(x)), x ~ N(-2, 0.5), as the
    reference's kernel test draws it, or is the constant ``decay``."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N)) for _ in range(3))
    w = (np.exp(-np.exp(0.5 * rng.standard_normal((B, T, H, N)) - 2.0))
         if decay is None else np.full((B, T, H, N), decay))
    u = 0.3 * np.ones((H, N))
    s0 = 0.5 * rng.standard_normal((B, H, N, N))
    return [x.astype(np.float32) for x in (r, k, v, w, u, s0)]


@pytest.mark.parametrize("B,T,H,N", WKV_SHAPES)
def test_wkv6_ref_matches_jax_ref_with_state(jref, B, T, H, N):
    kernels, jnp = jref
    *arrs, s0 = wkv_inputs(B, T, H, N)
    for init in (None, s0):
        o_j, s_j = kernels.wkv6_ref(*(jnp.asarray(a) for a in arrs),
                                    None if init is None else jnp.asarray(init))
        o, s = wkv6_ref(*(torch.from_numpy(a) for a in arrs),
                        None if init is None else torch.from_numpy(init))
        assert rel_err(o.numpy(), o_j) < 1e-4
        assert rel_err(s.numpy(), s_j) < 1e-4


@pytest.mark.parametrize("T", [1, 16])
@pytest.mark.parametrize("lo,hi", [(0, 2), (2, 4), (1, 2)])
def test_wkv6_ref_on_a_head_slice_is_that_slice_of_the_whole(jref, T, lo, hi):
    """A rank's heads under a mesh (heads over 'tp'): the plain version on
    heads [lo, hi) of r, k, v, w, u and the state equals, bit for bit in
    f32, heads [lo, hi) of its output and final state on all heads; and the
    JAX reference on the slice."""
    kernels, jnp = jref
    *arrs, s0 = wkv_inputs(2, T, 4, 16, seed=9)
    o, s = wkv6_ref(*(torch.from_numpy(a) for a in arrs), torch.from_numpy(s0))
    cut = [a[:, :, lo:hi] for a in arrs[:4]] + [arrs[4][lo:hi]]
    o_s, s_s = wkv6_ref(*(torch.from_numpy(np.ascontiguousarray(a)) for a in cut),
                        torch.from_numpy(np.ascontiguousarray(s0[:, lo:hi])))
    assert torch.equal(o_s, o[:, :, lo:hi]) and torch.equal(s_s, s[:, lo:hi])
    o_j, s_j = kernels.wkv6_ref(*(jnp.asarray(a) for a in cut), jnp.asarray(s0[:, lo:hi]))
    assert rel_err(o_s.numpy(), o_j) < 1e-4 and rel_err(s_s.numpy(), s_j) < 1e-4


def test_wkv6_ref_strong_decay_matches_jax_ref(jref):
    kernels, jnp = jref
    *arrs, s0 = wkv_inputs(1, 128, 1, 64, seed=5, decay=0.01)
    o_j, s_j = kernels.wkv6_ref(*(jnp.asarray(a) for a in arrs), jnp.asarray(s0))
    o, s = wkv6_ref(*(torch.from_numpy(a) for a in arrs), torch.from_numpy(s0))
    assert np.isfinite(o.numpy()).all() and np.isfinite(s.numpy()).all()
    assert rel_err(o.numpy(), o_j) < 1e-3
    assert rel_err(s.numpy(), s_j) < 1e-3


def test_wkv6_ref_matches_pallas_interpret(jref):
    kernels, jnp = jref
    r, k, v, w, u, _ = wkv_inputs(1, 128, 2, 64, seed=6)
    pallas = kernels.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=32,
                          interpret=True)
    out, _ = wkv6_ref(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    assert rel_err(out.numpy(), pallas) < 1e-4


SUB = 16  # steps a sub-chunk, as the Pallas kernel's


def wkv6_subchunk_ref(r, k, v, w, u, s0=None):
    """The Pallas kernel's 16-step sub-chunk form in plain PyTorch: the same
    function as ``wkv6_ref``, evaluated SUB steps at a time with the local
    cumulative log decay L and every decay factor the exponent of a
    difference that is <= 0 (pairwise for the intra-chunk matrix A), so no
    factor exceeds 1 and strong decay cannot overflow (the Pallas form's
    e^{-L} can).  No port code runs this form (``csrc/wkv6.cu`` runs the
    per-step recurrence); the tests below hold its algebra, the one a chunked
    tensor-core WKV6 kernel would compute.  Per sub-chunk:

        A_ts  = sum_i r_t[i] k_s[i] exp(L_{t-1}[i] - L_s[i])  (s < t)
        A_tt  = sum_i r_t[i] u[i] k_t[i]
        out_t = sum_{s<=t} A_ts v_s + (r_t o exp(L_{t-1})) S
        S'    = exp(L_last) o S + (k o exp(L_last - L))^T v
    """
    B, T, H, N = r.shape
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    r, k, v, w = (x.float().transpose(1, 2) for x in (r, k, v, w))    # [B,H,T,N]
    u = u.float()
    outs = []
    for t0 in range(0, T, SUB):
        rc, kc, vc, wc = (x[:, :, t0:t0 + SUB] for x in (r, k, v, w))
        tc = rc.shape[2]
        L = torch.cumsum(torch.log(torch.clamp(wc, min=1e-38)), dim=2)
        Lprev = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], dim=2)
        d = Lprev[:, :, :, None, :] - L[:, :, None, :, :]           # [B,H,t,s,N]
        lower = torch.tril(torch.ones((tc, tc), dtype=torch.bool, device=r.device), -1)
        dec = torch.where(lower[:, :, None], torch.exp(torch.clamp(d, max=0.0)), 0.0)
        A = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, dec)
        A = A + torch.diag_embed(torch.einsum("bhti,hi,bhti->bht", rc, u, kc))
        out = A @ vc + torch.einsum("bhti,bhij->bhtj", rc * torch.exp(Lprev), S)
        last = L[:, :, -1]                                            # [B,H,N]
        kd = kc * torch.exp(torch.clamp(last[:, :, None] - L, max=0.0))
        S = torch.exp(last)[..., None] * S + torch.einsum("bhsi,bhsj->bhij", kd, vc)
        outs.append(out)
    out = (torch.cat(outs, 2).transpose(1, 2) if outs
           else torch.zeros((B, 0, H, N), dtype=torch.float32, device=r.device))
    return out, S


@pytest.mark.parametrize("T", [1, 15, 16, 17, 48, 130])
def test_wkv6_subchunk_ref_matches_exact_scan(jref, T):
    kernels, jnp = jref
    *arrs, s0 = wkv_inputs(2, T, 2, 32, seed=T)
    o, s = wkv6_subchunk_ref(*(torch.from_numpy(a) for a in arrs), torch.from_numpy(s0))
    o_p, s_p = wkv6_ref(*(torch.from_numpy(a) for a in arrs), torch.from_numpy(s0))
    o_j, s_j = kernels.wkv6_ref(*(jnp.asarray(a) for a in arrs), jnp.asarray(s0))
    for want_o, want_s in ((o_p.numpy(), s_p.numpy()), (o_j, s_j)):
        assert rel_err(o.numpy(), want_o) < 1e-4
        assert rel_err(s.numpy(), want_s) < 1e-4


@pytest.mark.parametrize("decay", [0.01, 1e-3, 1e-5])
def test_wkv6_subchunk_ref_strong_decay_is_finite(jref, decay):
    """Constant decays at and past where the Pallas form's e^{-L} overflows
    fp32 (w < ~0.004 over 16 steps): every factor of the mirror is <= 1."""
    kernels, jnp = jref
    *arrs, s0 = wkv_inputs(1, 128, 2, 64, seed=5, decay=decay)
    o, s = wkv6_subchunk_ref(*(torch.from_numpy(a) for a in arrs), torch.from_numpy(s0))
    assert np.isfinite(o.numpy()).all() and np.isfinite(s.numpy()).all()
    o_p, s_p = wkv6_ref(*(torch.from_numpy(a) for a in arrs), torch.from_numpy(s0))
    o_j, s_j = kernels.wkv6_ref(*(jnp.asarray(a) for a in arrs), jnp.asarray(s0))
    for want_o, want_s in ((o_p.numpy(), s_p.numpy()), (o_j, s_j)):
        assert rel_err(o.numpy(), want_o) < 1e-3
        assert rel_err(s.numpy(), want_s) < 1e-3


@pytest.mark.parametrize("decay,tol", [(None, 1e-4), (0.01, 1e-3)])
def test_wkv6_subchunk_ref_matches_pallas_interpret(jref, decay, tol):
    """Where the Pallas form is finite (the reference's decay mix, w = 0.01),
    the mirror agrees with it (both start from a zero state)."""
    kernels, jnp = jref
    r, k, v, w, u, _ = wkv_inputs(1, 64, 2, 64, seed=8, decay=decay)
    pallas = kernels.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=32,
                          interpret=True)
    assert np.isfinite(np.asarray(pallas)).all()
    out, _ = wkv6_subchunk_ref(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    assert rel_err(out.numpy(), pallas) < tol


@pytest.mark.parametrize("N", [16, 64])
def test_wkv6_subchunk_ref_from_zero_state(N):
    """Every head size the kernel takes, starting from no state, over a
    ragged last sub-chunk (T = 33)."""
    *arrs, _ = (torch.from_numpy(a) for a in wkv_inputs(1, 33, 3, N, seed=N))
    o, s = wkv6_subchunk_ref(*arrs)
    o_p, s_p = wkv6_ref(*arrs)
    assert rel_err(o.numpy(), o_p.numpy()) < 1e-4
    assert rel_err(s.numpy(), s_p.numpy()) < 1e-4


def test_recurrence_wrappers_on_cpu_are_the_plain_versions():
    x, w = (torch.from_numpy(a) for a in gmm_inputs(2, 8, 16, 24))
    a, b, h0 = (torch.from_numpy(t) for t in rglru_inputs(2, 5, 12))
    *arrs, s0 = (torch.from_numpy(t) for t in wkv_inputs(1, 6, 2, 16))
    xi, r_logit, i_logit, lam, _ = (torch.from_numpy(t) for t in gated_inputs(2, 5, 12))
    gates = [t.to(torch.bfloat16) for t in (xi, r_logit, i_logit)]
    counts = (moe_gmm.launches, rglru_scan.launches, wkv6.launches)
    for dt in (None, torch.float32, torch.bfloat16):
        assert torch.equal(moe_gmm(x, w, dt), gmm_ref(x, w, dt))
        fill = torch.tensor([5, 0], dtype=torch.int32)
        assert torch.equal(moe_gmm(x, w, dt, fill), gmm_ref(x, w, dt, fill))
    for got, want in ((rglru_scan(a, b, h0), rglru_ref(a, b, h0)),
                      (rglru_gated_scan(*gates, lam, h0), rglru_gated_ref(*gates, lam, h0)),
                      (rglru_gated_scan(xi, r_logit, i_logit, lam),
                       rglru_gated_ref(xi, r_logit, i_logit, lam)),
                      (wkv6(*arrs, s0), wkv6_ref(*arrs, s0))):
        assert all(torch.equal(g, r) for g, r in zip(got, want))
    assert (moe_gmm.launches, rglru_scan.launches, wkv6.launches) == counts


def test_recurrence_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        moe_gmm(torch.zeros(2, 3, 4), torch.zeros(2, 5, 6))
    x, w = torch.zeros(2, 3, 4), torch.zeros(2, 4, 6)
    for counts in (torch.zeros(3, dtype=torch.int32), torch.zeros(2)):
        with pytest.raises(ValueError):
            moe_gmm(x, w, counts=counts)      # counts must be int32 [E]
    with pytest.raises(ValueError):
        rglru_scan(torch.zeros(1, 3, 4), torch.zeros(1, 3, 4), torch.zeros(1, 5))
    g = torch.zeros(1, 3, 4)
    for args in ((g, g, torch.zeros(1, 3, 5), torch.zeros(4)),      # logits differ
                 (g, g, g, torch.zeros(5)),                          # lam is not [W]
                 (g, g, g, torch.zeros(4), torch.zeros(1, 5)),       # h0 is not [B, W]
                 (g[0], g[0], g[0], torch.zeros(4))):                # not [B, T, W]
        with pytest.raises(ValueError):
            rglru_gated_scan(*args)
    z = torch.zeros(1, 3, 2, 16)
    with pytest.raises(ValueError):
        wkv6(z, z, z, z, torch.zeros(2, 8))


# --------------------------------------------------------- on the card only
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,window", ATTN_SHAPES + [
    (1, 16, 16, 16, 8, 128, True, 0),      # the serving prefill
    (1, 70, 70, 2, 2, 16, True, 16),       # ragged tiles, window
    (1, 2048, 2048, 16, 8, 128, True, 0),  # a 2,048-token internlm2 prompt
    (1, 512, 512, 16, 1, 256, True, 2048),   # recurrentgemma local attention
    (1, 2048, 2048, 16, 1, 256, True, 2048),
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
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,dtype", [
    (1, 1024, 1024, 16, 16, 64, False, "bf16"),    # the whisper encoder
    (1, 1500, 1500, 16, 16, 64, False, "bf16"),    # ragged tiles on both axes
    (1, 128, 1024, 16, 16, 64, False, "bf16"),     # cross-attention, Sq < Skv
    (1, 187, 1500, 16, 16, 64, False, "bf16"),     # ragged cross-attention
    (1, 4608, 4608, 56, 8, 128, True, "bf16"),     # llava: 7 query heads a KV head
    (2, 100, 300, 4, 4, 64, False, "f32"),
])
def test_flash_kernel_unmasked_and_wide_gqa_on_card(cuda_device, B, Sq, Skv, H, Hkv, D,
                                                    causal, dtype):
    """The encoder-decoder's and llava's shapes: no mask with Sq != Skv (the
    aligned-ends offset must not enter), ragged tiles, H / Hkv = 7."""
    q, k, v = _torch(attn_inputs(B, Sq, Skv, H, Hkv, D), dtype, cuda_device)
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=causal)
    assert rel_err(_np(out), _np(ref)) < (2e-2 if dtype == "bf16" else 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,window,blocks", OFFSET_CASES + [
    (1, 4608, 56, 8, 128, 0, [(r, 288) for r in range(0, 4608, 288)]),   # llava over 16
    (1, 2048, 16, 1, 256, 2048, [(r, 128) for r in range(0, 2048, 128)]),
])
def test_flash_kernel_with_offset_matches_plain_on_card(cuda_device, B, S, H, Hkv, D,
                                                        window, blocks, dtype):
    """Each sequence shard at its own offset against the plain version, and
    against the same rows of the kernel over the whole sequence."""
    q, k, v = _torch(attn_inputs(B, S, S, H, Hkv, D), dtype, cuda_device)
    whole = flash_attention(q, k, v, causal=True, window=window)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    for a, n in blocks:
        qa = q[:, a:a + n].contiguous()
        before = flash_attention.launches
        out = flash_attention(qa, k, v, causal=True, window=window, q_offset=a)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref = attention_ref(qa, k, v, causal=True, window=window, q_offset=a)
        assert rel_err(_np(out), _np(ref)) < tol, (a, n)
        assert rel_err(_np(out), _np(whole[:, a:a + n])) < tol, (a, n)


@pytest.mark.cuda
@pytest.mark.parametrize("W,O,E", [(16, 64, 4), (300, 1200, 96), (64, 256, 4),
                                   (8, 256, 16),     # the serving window
                                   (1, 256, 16),     # one queued item
                                   (8, 1, 16), (8, 3, 16), (8, 255, 16),
                                   (8, 1201, 16)])   # ragged O: the scalar path
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


@pytest.mark.cuda
@pytest.mark.parametrize("W,K,E", [(256, 2, 16),                # the serving shape
                                   (256, 2, 5), (256, 2, 17),    # ragged E
                                   (256, 1, 16), (256, 33, 16), (256, 128, 16),
                                   (256, 64, 64), (1, 2, 16), (1, 3, 5)])
def test_dispatch_score_update_exact_on_card(cuda_device, W, K, E):
    scores, mult, delta = update_inputs(W, K, E)
    exact = scores.astype(np.float64) + mult.astype(np.float64) @ delta
    before = dispatch_score_update.launches
    out = dispatch_score_update(*(torch.from_numpy(a).to(cuda_device)
                                  for a in (scores, mult, delta)))
    assert dispatch_score_update.launches == before + 1
    assert np.abs(out.cpu().numpy().astype(np.float64) - exact).max() == 0.0


@pytest.mark.cuda
def test_dispatch_score_update_unaligned_view_on_card(cuda_device):
    """Scores whose storage starts off 16 bytes take the scalar path."""
    scores, mult, delta = update_inputs(64, 4, 16)
    buf = torch.zeros(scores.size + 1, device=cuda_device)
    buf[1:] = torch.from_numpy(scores).reshape(-1).to(cuda_device)
    s = buf[1:].view(scores.shape)
    assert s.data_ptr() % 16 != 0
    out = dispatch_score_update(s, *(torch.from_numpy(a).to(cuda_device)
                                     for a in (mult, delta)))
    exact = scores.astype(np.float64) + mult.astype(np.float64) @ delta
    assert np.abs(out.cpu().numpy().astype(np.float64) - exact).max() == 0.0


@pytest.mark.cuda
def test_dispatch_scores_unaligned_view_on_card(cuda_device):
    """Operands whose storage starts off 16 bytes take the scalar loads."""
    demand, presence = score_inputs(8, 256, 16, 0.2)
    d = torch.zeros(8 * 256 + 1, device=cuda_device)
    d[1:] = torch.from_numpy(demand.reshape(-1)).to(cuda_device)
    d = d[1:].view(8, 256)
    assert d.is_contiguous() and d.data_ptr() % 16 != 0
    out = dispatch_scores(d, torch.from_numpy(presence).to(cuda_device))
    exact = demand.astype(np.float64) @ presence.astype(np.float64).T
    assert np.abs(out.cpu().numpy() - exact).max() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
def test_flash_kernel_head_dim_256_on_card(cuda_device, D):
    """recurrentgemma's local attention: MQA with head dim 256, window 2048."""
    for S in (16, 512):
        q, k, v = _torch(attn_inputs(1, S, S, 16, 1, D), "bf16", cuda_device)
        out = flash_attention(q, k, v, causal=True, window=2048)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=True, window=2048)
        assert rel_err(_np(out), _np(ref)) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("E,C,D,F", GMM_SHAPES + [(64, 8, 256, 128), (4, 13, 96, 72)])
def test_gmm_kernel_matches_plain_on_card(cuda_device, E, C, D, F, dtype):
    x, w = _torch(gmm_inputs(E, C, D, F), dtype, cuda_device)
    for out_dtype in (None, torch.float32):
        before = moe_gmm.launches
        out = moe_gmm(x, w, out_dtype)
        torch.cuda.synchronize()
        assert moe_gmm.launches == before + 1
        assert out.dtype == (out_dtype or x.dtype)
        assert rel_err(_np(out), _np(gmm_ref(x, w, out_dtype))) < GMM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["decode", "ragged", "full"])
@pytest.mark.parametrize("C", [8, 13, 320])
def test_gmm_kernel_with_counts_at_olmoe_shapes_on_card(cuda_device, C, kind, dtype):
    """olmoe's gate/up and down shapes (E = 64, D x F = 2048 x 1024 and back)
    with fill counts: one decode token on 8 experts, ragged, or full."""
    E, D, F = 64, 2048, 1024
    if kind == "decode":
        counts = np.zeros(E, np.int32)
        counts[np.random.default_rng(C).choice(E, 8, replace=False)] = 1
    else:
        counts = gmm_counts(E, C, kind)
    ct = torch.from_numpy(counts).to(cuda_device)
    for d_in, d_out in ((D, F), (F, D)):
        x, w = _torch(gmm_inputs(E, C, d_in, d_out), dtype, cuda_device)
        for out_dtype in (None, torch.float32):
            before = moe_gmm.launches
            out = moe_gmm(x, w, out_dtype, ct)
            torch.cuda.synchronize()
            assert moe_gmm.launches == before + 1
            ref = gmm_ref(x, w, out_dtype, ct)
            assert rel_err(_np(out), _np(ref)) < GMM_TOL[dtype]
            assert not _np(out)[dead_rows(E, C, counts)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [8, 320])
def test_gmm_kernel_never_reads_dead_experts_on_card(cuda_device, C, dtype):
    """Poisoned weights: w[e] is NaN for every expert whose count is 0, and
    x is NaN in every dead row.  The kernel's output must be finite, zero on
    dead rows and equal to the plain version on live rows."""
    E, D, F = 64, 2048, 1024
    counts = gmm_counts(E, C, "ragged", seed=C)
    counts[np.random.default_rng(1).choice(E, 24, replace=False)] = 0
    x, w = gmm_inputs(E, C, D, F)
    dead = dead_rows(E, C, counts)
    x[dead] = np.nan
    w[counts == 0] = np.nan
    xt, wt = _torch((x, w), dtype, cuda_device)
    ct = torch.from_numpy(counts).to(cuda_device)
    out = moe_gmm(xt, wt, None, ct)
    torch.cuda.synchronize()
    got, want = _np(out), _np(gmm_ref(xt, wt, None, ct))
    assert np.isfinite(got).all()
    assert (got[dead] == 0.0).all()
    assert rel_err(got[~dead], want[~dead]) < GMM_TOL[dtype]


# recurrentgemma-9b's width: decode, the serving prefill, a 2,048-token
# prompt (its attention window), a ragged last group of 8 steps; a ragged
# shape
RGLRU_CARD_SHAPES = [(1, 1, 4096), (1, 16, 4096), (1, 2048, 4096), (1, 65, 4096),
                     (2, 17, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,W", RGLRU_SHAPES + RGLRU_CARD_SHAPES)
def test_rglru_kernel_matches_plain_on_card(cuda_device, B, T, W):
    a, b, h0 = (torch.from_numpy(t).to(cuda_device) for t in rglru_inputs(B, T, W))
    for init in (None, h0):
        before = rglru_scan.launches
        y, h = rglru_scan(a, b, init)
        torch.cuda.synchronize()
        assert rglru_scan.launches == before + 1
        y_r, h_r = rglru_ref(a, b, init)
        assert rel_err(_np(y), _np(y_r)) < 1e-5
        assert rel_err(_np(h), _np(h_r)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,W", RGLRU_CARD_SHAPES)
def test_rglru_gated_kernel_matches_plain_on_card(cuda_device, B, T, W, dtype):
    xi, r_logit, i_logit, lam, h0 = (torch.from_numpy(t).to(cuda_device)
                                     for t in gated_inputs(B, T, W))
    gates = _torch([t.cpu().numpy() for t in (xi, r_logit, i_logit)], dtype, cuda_device)
    for init in (None, h0):
        before = rglru_scan.launches
        y, h = rglru_gated_scan(*gates, lam, init)
        torch.cuda.synchronize()
        assert rglru_scan.launches == before + 1
        y_r, h_r = rglru_gated_ref(*gates, lam, init)
        assert rel_err(_np(y), _np(y_r)) < 1e-5
        assert rel_err(_np(h), _np(h_r)) < 1e-5


@pytest.mark.cuda
def test_rglru_gated_decode_step_launches_one_kernel_on_card(cuda_device):
    """At a decode step the model passes bf16 logits and a view of the
    session's cache as h0: the wrapper launches the kernel and nothing else
    (no copy, no cast)."""
    W = 4096
    xi, r_logit, i_logit, lam, _ = (torch.from_numpy(t).to(cuda_device)
                                    for t in gated_inputs(1, 1, W))
    gates = [t.to(torch.bfloat16) for t in (xi, r_logit, i_logit)]
    cache_h = torch.zeros((3, 1, W), device=cuda_device)      # [layers, B, W]
    rglru_gated_scan(*gates, lam, cache_h[1])                   # build and load
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        rglru_gated_scan(*gates, lam, cache_h[1])
        torch.cuda.synchronize()
    launched = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [e.name for e in launched if "rglru" not in e.name] == []
    assert len(launched) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,N", WKV_SHAPES + [(1, 1, 40, 64), (2, 7, 3, 16),
                                                  (1, 5, 2, 32),
                                                  # rwkv6-3b's heads, short and
                                                  # windowed (T >= 16) paths
                                                  (1, 15, 40, 64), (1, 17, 40, 64),
                                                  (1, 64, 40, 64), (1, 2048, 40, 64)])
def test_wkv6_kernel_matches_plain_on_card(cuda_device, B, T, H, N):
    *arrs, s0 = (torch.from_numpy(t).to(cuda_device) for t in wkv_inputs(B, T, H, N))
    for init in (None, s0):
        out, s = wkv6(*arrs, init)
        torch.cuda.synchronize()
        o_r, s_r = wkv6_ref(*arrs, init)
        assert rel_err(_np(out), _np(o_r)) < 1e-4
        assert rel_err(_np(s), _np(s_r)) < 1e-4
    r, k, v, w, u = arrs          # bf16 r, k, v as the model passes them
    bf = [t.to(torch.bfloat16) for t in (r, k, v)]
    out, s = wkv6(*bf, w, u, s0)
    o_r, s_r = wkv6_ref(*bf, w, u, s0)
    assert rel_err(_np(out), _np(o_r)) < 1e-4 and rel_err(_np(s), _np(s_r)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [0.01, 1e-3, 1e-5])
def test_wkv6_kernel_strong_decay_on_card(cuda_device, decay):
    """Past w ~ 0.004 the Pallas form's e^{-L} would overflow; the kernel
    applies each step's decay as it comes, so it has no such limit."""
    *arrs, s0 = (torch.from_numpy(t).to(cuda_device)
                 for t in wkv_inputs(1, 128, 1, 64, seed=5, decay=decay))
    out, s = wkv6(*arrs, s0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(s).all())
    o_r, s_r = wkv6_ref(*arrs, s0)
    assert rel_err(_np(out), _np(o_r)) < 1e-3 and rel_err(_np(s), _np(s_r)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16])
def test_wkv6_kernel_unaligned_operands_on_card(cuda_device, T):
    """Views whose storage starts off 16 bytes are copied before the
    kernel's 16-byte loads; the result is the plain version's."""
    *arrs, s0 = (torch.from_numpy(t).to(cuda_device) for t in wkv_inputs(1, T, 2, 64))

    def shifted(x):
        buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(x.shape)

    r, k, v, w, u = (shifted(x) for x in arrs)
    assert r.data_ptr() % 16 != 0
    out, s = wkv6(r, k, v, w, u, shifted(s0))
    o_r, s_r = wkv6_ref(*arrs, s0)
    assert rel_err(_np(out), _np(o_r)) < 1e-4 and rel_err(_np(s), _np(s_r)) < 1e-4


# ------------------------------------------------------------- grad guard
def _guard_case(name, device):
    """(wrapper, float inputs) of one entry point at a small shape; every
    float input will require grad."""
    g = torch.Generator().manual_seed(11)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(device)

    if name == "flash_attention":
        return (lambda q, k, v: flash_attention(q, k, v, causal=True),
                [rnd(1, 16, 4, 64), rnd(1, 16, 2, 64), rnd(1, 16, 2, 64)])
    if name == "moe_gmm":
        return moe_gmm, [rnd(2, 8, 32), rnd(2, 32, 16)]
    if name == "rglru_scan":
        return rglru_scan, [torch.sigmoid(rnd(1, 5, 32)), rnd(1, 5, 32), rnd(1, 32)]
    if name == "rglru_gated_scan":
        return rglru_gated_scan, [rnd(1, 5, 32), rnd(1, 5, 32), rnd(1, 5, 32),
                                  rnd(32), rnd(1, 32)]
    if name == "wkv6":
        w = torch.sigmoid(rnd(1, 5, 2, 16))
        return wkv6, [rnd(1, 5, 2, 16), rnd(1, 5, 2, 16), rnd(1, 5, 2, 16), w,
                      rnd(2, 16), rnd(1, 2, 16, 16)]
    if name == "dispatch_scores":
        return dispatch_scores, [rnd(8, 32), rnd(4, 32)]
    return dispatch_score_update, [rnd(8, 4), rnd(8, 3), rnd(3, 4)]


ENTRY_POINTS = ["flash_attention", "moe_gmm", "rglru_scan", "rglru_gated_scan",
                "wkv6", "dispatch_scores", "dispatch_score_update"]
_COUNTERS = {"flash_attention": flash_attention, "moe_gmm": moe_gmm,
             "rglru_scan": rglru_scan, "rglru_gated_scan": rglru_scan,
             "wkv6": wkv6, "dispatch_scores": dispatch_scores,
             "dispatch_score_update": dispatch_score_update}


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_cpu_entry_points_stay_differentiable(name):
    """On CPU tensors the wrappers run their plain versions, which autograd
    differentiates: every input that requires grad gets a finite grad."""
    fn, xs = _guard_case(name, "cpu")
    xs = [x.requires_grad_(True) for x in xs]
    out = _first(fn(*xs))
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.float().square().sum(), xs, allow_unused=True)
    assert any(gr is not None for gr in grads)
    assert all(gr is None or bool(torch.isfinite(gr).all()) for gr in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_cuda_entry_points_refuse_grad(cuda_device, name):
    """A kernel has no backward: on CUDA inputs that require grad each entry
    point raises before it launches; under ``torch.no_grad()`` it launches
    and matches its plain version on the CPU."""
    fn, xs = _guard_case(name, cuda_device)
    counter = _COUNTERS[name]
    before = counter.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*[x.clone().requires_grad_(True) for x in xs])
    assert counter.launches == before
    with torch.no_grad():
        got = _first(fn(*[x.clone().requires_grad_(True) for x in xs]))
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = _first(fn(*[x.cpu() for x in xs]))
    assert rel_err(_np(got), _np(want)) < 1e-4


@pytest.mark.cuda
def test_kernel_entries_refuse_dtensors_on_card(cuda_device):
    """Each kernel entry point given DTensor operands on the card raises
    before it launches (a kernel would read the local shard alone); world
    size 1 over NCCL."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_ctx, make_host_mesh
    from repro_torch.models.sharding import P, distribute

    started = init_process_group(cuda_device)
    try:
        ctx = make_ctx(make_host_mesh())

        def d(*shape, dtype=torch.float32):
            x = torch.rand(shape, device=cuda_device).to(dtype)
            return distribute(ctx, x, P(*[None] * len(shape)))

        bf = torch.bfloat16
        calls = {
            dispatch_scores: lambda: dispatch_scores(d(8, 16), d(4, 16)),
            dispatch_score_update: lambda: dispatch_score_update(d(8, 4), d(8, 2), d(2, 4)),
            flash_attention: lambda: flash_attention(d(1, 16, 2, 16, dtype=bf),
                                                     d(1, 16, 2, 16, dtype=bf),
                                                     d(1, 16, 2, 16, dtype=bf)),
            moe_gmm: lambda: moe_gmm(d(2, 8, 16, dtype=bf), d(2, 16, 8, dtype=bf)),
            rglru_scan: lambda: rglru_scan(d(1, 4, 8), d(1, 4, 8)),
            rglru_gated_scan: lambda: rglru_gated_scan(d(1, 4, 8), d(1, 4, 8),
                                                       d(1, 4, 8), d(8)),
            wkv6: lambda: wkv6(d(1, 4, 2, 16), d(1, 4, 2, 16), d(1, 4, 2, 16),
                               d(1, 4, 2, 16), d(2, 16)),
        }
        for fn, call in calls.items():
            before = fn.launches
            with pytest.raises(TypeError, match="DTensor"):
                call()
            assert fn.launches == before
    finally:
        if started:
            dist.destroy_process_group()
