"""DeepSeek-V2-Lite on the port at tiny widths on the CPU, held to the plain
float32 reference ``tests/_deepseek_v2_reference.py`` (no JAX: the JAX
package has no latent attention): prefill and decode through the latent
cache, the absorbed decode against the expanded form, the YaRN constants,
dropless and un-renormalised routing with the shared experts and the dense
layer 0, the server end to end, and olmoe's MoE left as it was."""

from dataclasses import asdict, replace

import pytest
import torch
import torch.nn.functional as F

import _deepseek_v2_reference as R
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.deepseek_v2_lite import CONFIG
from repro_torch.models import (cache_init, init_params, make_decode_step,
                                make_prefill_step)
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import moe as M
from repro_torch.runtime.serve_loop import DiffusionServer, _merge_prefill_caches
from repro_torch.tree import tree_map

# the reduced config with 8 experts, top-3, so that top-k picks among many
TINY = replace(CONFIG.reduced(), num_experts=8, moe_top_k=3)
# far off: a position whose logit error is over half the reference's spread
FAR = 0.5


def _arch(cfg):
    return {k: v for k, v in asdict(cfg).items()
            if k not in ("name", "source", "layer_pattern")}


def _err(got, want):
    """Widest logit difference over the reference's spread, per row."""
    return (got - want).abs().max(-1).values / want.std(-1)


def _prefill_then_decode(cfg, W, toks, S, cap):
    prefill = make_prefill_step(cfg, ShapeConfig("t", "prefill", cap, 1))
    decode = make_decode_step(cfg)
    last, pre = prefill(W, {"tokens": toks[None, :S]})
    caches = _merge_prefill_caches(cache_init(cfg, 1, cap, device="cpu"), pre, cfg)
    steps = []
    for p in range(S, toks.shape[0]):
        lg, caches = decode(W, {"token": toks[p:p + 1], "pos": p, "caches": caches})
        steps.append(lg[0, :cfg.vocab_size].float())
    return last[0, :cfg.vocab_size].float(), torch.stack(steps), caches


def test_tree_and_latent_cache_shapes():
    W = init_params(TINY, device="cpu", seed=0)
    lead, stack = W["lead"][0], W["groups"]["b0"]
    assert lead["ffn"]["w_gate"].shape == (64, TINY.dense_d_ff) and "moe" not in lead
    assert stack["moe"]["shared"]["w_up"].shape == (3, 64, TINY.shared_d_ff)
    assert stack["attn"]["wkv_a"].shape == (3, 64, 32 + 8)
    assert stack["attn"]["wkv_b"].shape == (3, 32, 4 * (16 + 16))
    c = cache_init(TINY, 1, 40, device="cpu")
    assert c["lead"][0]["kv"].shape == (1, 40, 1, 40)
    assert c["groups"]["b0"]["kv"].shape == (3, 1, 40, 1, 40) and c["rem"] == []
    # published sizes: 15.71 B parameters, a 576-wide latent, 31,104 B a token
    assert round(CONFIG.param_count() / 1e9, 2) == 15.71
    assert CONFIG.num_layers * L.mla_latent_width(CONFIG) * 2 == 31104


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_decode_through_the_latent_cache_match_reference_in_f32(seed, monkeypatch):
    """Prefill's last logits and 8 teacher-forced decode steps through the
    latent cache against the reference's full forward, the port run in
    float32 (its activations and caches, which are bf16 when served): only
    the order of summation differs, so 1e-4 of the logits, and every
    routing pick is the reference's."""
    monkeypatch.setattr(LM, "BF16", torch.float32)
    W = tree_map(lambda t: t.float(), init_params(TINY, device="cpu", seed=seed))
    S, steps = 24, 8
    toks = torch.randint(0, TINY.vocab_size, (S + steps,),
                         generator=torch.Generator().manual_seed(3 + seed))
    last, dec, caches = _prefill_then_decode(TINY, W, toks, S, 40)
    assert caches["groups"]["b0"]["kv"].dtype == torch.float32
    want = R.forward(W, _arch(TINY), toks)
    assert float(_err(last[None], want[S - 1:S])) < 1e-4
    assert float(_err(dec, want[S:]).max()) < 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_decode_in_bf16_stay_near_reference(seed):
    """The same at the served precision, bf16 weights, activations and
    caches: at 4 layers of width 64 a position's logits stay within a fifth
    of the reference's spread (readings 0.04-0.14); a routing pick near a
    tie, which bf16 and float32 take differently, moves a position far (as
    in the benchmark's ``logit_err_over_half``), so the median is held to
    0.2 and at most one step in 8 may be over one half."""
    W = init_params(TINY, device="cpu", seed=seed)
    S, steps = 24, 8
    toks = torch.randint(0, TINY.vocab_size, (S + steps,),
                         generator=torch.Generator().manual_seed(3 + seed))
    last, dec, _ = _prefill_then_decode(TINY, W, toks, S, 40)
    want = R.forward(W, _arch(TINY), toks)
    assert float(_err(last[None], want[S - 1:S])) < 0.2
    e = _err(dec, want[S:])
    assert float(e.median()) < 0.2, e
    assert int((e > FAR).sum()) <= 1, e


def test_absorbed_decode_equals_expanded_in_f32():
    """The algebra of the absorbed step: W_UK folded into the query and
    W_UV into the output give the expanded attention over keys and values
    made from the same latents (f32 throughout: only summation order
    differs)."""
    cfg = TINY
    W = tree_map(lambda t: t.float(), init_params(cfg, device="cpu", seed=5))
    a = tree_map(lambda t: t[0], W["groups"]["b0"]["attn"])
    g = torch.Generator().manual_seed(6)
    cap, pos = 16, 11
    H, dn, dr, dv, r = 4, 16, 8, 16, 32
    cache = torch.randn((1, cap, 1, r + dr), generator=g)
    x = torch.randn((1, 1, 64), generator=g)
    positions = torch.tensor([pos])
    got = L.mla_decode(a, x, cache, cfg=cfg, positions=positions, pos=pos)
    lat = cache[0, :pos + 1, 0]                          # written at slot pos
    kv = (lat[:, :r] @ a["wkv_b"]).view(pos + 1, H, dn + dv)
    k = torch.cat([kv[..., :dn], lat[:, None, r:].expand(pos + 1, H, dr)], -1)
    q = (x[0] @ a["wq"]).view(1, H, dn + dr)
    q = torch.cat([q[..., :dn], L.mla_rope(q[None, ..., dn:], positions, cfg)[0]], -1)
    p = torch.softmax(torch.einsum("qhd,khd->hqk", q, k) * L.mla_softmax_scale(cfg), -1)
    want = torch.einsum("hqk,khd->qhd", p, kv[..., dn:]).reshape(1, H * dv) @ a["wo"]
    assert torch.allclose(got[0], want, rtol=1e-5, atol=1e-5), (got[0] - want).abs().max()


def test_yarn_frequencies_and_mscale():
    inv = L.yarn_inv_freq(CONFIG)
    base = 1.0 / 10_000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    assert torch.equal(inv[:11], base[:11])                        # pairs i <= 10
    assert torch.allclose(inv[23:], base[23:] / 40, rtol=1e-6)     # pairs i >= 23
    mid = inv[11:23]
    assert bool(((mid < base[11:23]) & (mid > base[11:23] / 40)).all())
    assert torch.equal(inv, R.yarn_inv_freq(64, 1e4, 40, 4096, 32, 1))
    assert round(L.yarn_mscale(40, 0.707), 5) == 1.26080
    assert round(L.mla_softmax_scale(CONFIG), 6) == 0.114721
    # cos and sin are scaled by mscale(0.707) / mscale(0.707) = 1: a rotation
    x = torch.randn(5, 2, 64)
    y = L.mla_rope(x, torch.arange(5) * 997, CONFIG)
    assert torch.allclose(y.norm(dim=-1), x.norm(dim=-1), rtol=1e-5)


def _plain_moe(x, p, K, renorm):
    """Every assignment computed, per token: f32 SwiGLU experts, gates as
    ``renorm`` says, plus the shared SwiGLU when the tree has one."""
    probs = torch.softmax(x.float() @ p["router"].float(), -1)
    gate, pick = torch.topk(probs, K, -1)
    if renorm:
        gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros(x.shape, dtype=torch.float32)
    w = p["experts"]
    for t in range(x.shape[0]):
        for j in range(K):
            e = int(pick[t, j])
            h = F.silu(x[t].float() @ w["w1"][e].float()) * (x[t].float() @ w["w3"][e].float())
            out[t] += gate[t, j] * (h.to(x.dtype).float() @ w["w2"][e].float())
    if "shared" in p:
        out += L.mlp(p["shared"], x).float()
    return out, gate


def _close(got, want):
    """f32 sums taken in another order: within 1e-5 of the largest value."""
    return float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _moe_params(E=8, D=64, Fd=32, shared=0, seed=0):
    """Seeded MoE weights in f32, and the generator for the inputs."""
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t.float(), M.moe_init(g, D, Fd, E, shared_d_ff=shared)), g


def test_dropless_routing_keeps_every_assignment():
    """32 tokens sent to experts 0 and 1: the old capacity (16 rows an
    expert) drops 16 assignments of each, the dropless path none."""
    E, K, T, D = 8, 2, 32, 64
    p, g = _moe_params(E, D, seed=1)
    u = torch.zeros(D)
    u[0] = 1.0
    x = torch.randn((T, D), generator=g) + 3 * u         # x . u = 3 +- 1
    p["router"] = torch.zeros((D, E))
    p["router"][:, 0], p["router"][:, 1] = 50 * u, 40 * u
    _, _, assigned, _, pos = M._route(p, x, E, K)
    C = M.capacity(T, K, E, 1.25)
    fill, keep, _ = M._slots(assigned, pos, C)
    assert C == 16 and int(fill[:2].min()) == 16 and int((~keep).sum()) == 32
    C = M.dropless_capacity(assigned, T)
    fill, keep, _ = M._slots(assigned, pos, C)
    assert C == 32 and bool(keep.all()) and fill[:2].tolist() == [32, 32]
    got, _ = M.moe_ffn(p, x, n_experts=E, top_k=K, capacity_factor=1.25,
                       renorm=False, dropless=True)
    want, _ = _plain_moe(x, p, K, renorm=False)
    assert _close(got, want)
    dropped, _ = M.moe_ffn(p, x, n_experts=E, top_k=K, capacity_factor=1.25,
                           renorm=False)
    assert not _close(dropped, want)
    # a decode step routes one token: its capacity is 8 rows, read from nothing
    assert M.dropless_capacity(None, 1) == 8


def test_dropless_prefill_in_token_groups_equals_one_group(monkeypatch):
    """A prefill longer than ``DROPLESS_GROUP`` tokens runs group by group:
    the same output as one dispatch of every token (nothing is dropped, so
    no token's result depends on the others' routing)."""
    E, K, T, D = 8, 3, 40, 64
    p, g = _moe_params(E, D, shared=48, seed=3)
    x = torch.randn((T, D), generator=g)
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.25, renorm=False, dropless=True)
    whole, _ = M.moe_ffn(p, x, **kw)
    monkeypatch.setattr(M, "DROPLESS_GROUP", 16)
    grouped, _ = M.moe_ffn(p, x, **kw)
    assert _close(grouped, whole)
    assert _close(grouped, _plain_moe(x, p, K, renorm=False)[0])


def test_fullest_count_read_in_its_own_span_and_recorded():
    """A dropless prefill reads its fullest count in ``moe.fill``, outside
    ``moe.route``, and records (host clock, count, tokens); a decode step
    reads nothing."""
    import time

    E, K, T, D = 8, 3, 12, 64
    p, g = _moe_params(E, D, seed=4)
    x = torch.randn((T, D), generator=g)
    kw = dict(n_experts=E, top_k=K, capacity_factor=1.25, renorm=False, dropless=True)
    M.FILL_READS.clear()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        M.moe_ffn(p, x, **kw)
        M.moe_ffn(p, x[:1], **kw)
    _, _, assigned, _, _ = M._route(p, x, E, K)
    ((at, n, tokens),) = M.FILL_READS
    assert t0 <= at <= time.perf_counter() and (n, tokens) == (int(assigned.max()), T)
    M.FILL_READS.clear()
    names = [e.name for e in prof.events()]
    assert names.count("moe.fill") == 1 and names.count("moe.route") == 2
    route = [e for e in prof.events() if e.name == "moe.route"][0]
    fill = [e for e in prof.events() if e.name == "moe.fill"][0]
    assert fill.time_range.start >= route.time_range.end


def test_gates_are_not_renormalised_and_shared_experts_add():
    E, K, T, D = 8, 3, 12, 64
    p, g = _moe_params(E, D, shared=48, seed=2)
    x = torch.randn((T, D), generator=g)
    gate = M._route(p, x, E, K, renorm=False)[0]
    assert float(gate.sum(-1).max()) < 0.99          # not forced to 1
    got, _ = M.moe_ffn(p, x, n_experts=E, top_k=K, capacity_factor=1.25,
                       renorm=False, dropless=True)
    want, _ = _plain_moe(x, p, K, renorm=False)
    assert _close(got, want)


def test_server_serves_misses_and_hits_from_the_latent_cache():
    srv = DiffusionServer(TINY, device="cpu", cache_cap=64, max_sessions=2,
                          max_replicas=1, min_replicas=1, dispatcher_impl="vectorized",
                          batch_drain=True, seed=4)
    prompt = torch.randint(0, TINY.vocab_size, (20,)).numpy()
    for new in (2, 3):
        srv.submit("s0", prompt, new)
        srv.step()
    st = srv.stats
    assert (st.served, st.prefills, st.prefix_hits, st.decode_steps) == (2, 1, 1, 5)
    (rep,) = srv.replicas.values()
    assert rep.sessions["s0"]["caches"]["groups"]["b0"]["kv"].shape == (3, 1, 64, 1, 40)


def test_mla_does_not_train():
    W = init_params(TINY, device="cpu", seed=0)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError):
        LM.lm_loss(W, {"tokens": toks}, TINY)


def _parent_moe_ffn(p, x2d, *, n_experts, top_k, capacity_factor, train=False, ctx=None,
                    renorm=True, dropless=False):
    """The port's MoE FFN as it was before the DeepSeek variant (serving,
    one device): renormalised top-k, capacity with drops, which olmoe's
    config asks for."""
    assert renorm and not dropless
    T, D = x2d.shape
    E, K = n_experts, top_k
    C = M.capacity(T, K, E, capacity_factor)
    logits = x2d.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat_e = gate_idx.reshape(T * K)
    assigned = M._expert_counts(flat_e, E)
    aux = M._aux_loss(probs, assigned, T * K)
    pos = M._rank_positions(flat_e)
    fill, keep, slot = torch.clamp(assigned, max=C), pos < C, torch.clamp(pos, 0, C - 1)
    row = flat_e * C + slot
    buf = torch.zeros((E * C, D), dtype=x2d.dtype)
    zero = torch.zeros((), dtype=x2d.dtype)
    for k in range(K):
        buf.index_add_(0, row[k::K], torch.where(keep[k::K, None], x2d, zero))
    y = M._expert_mlp(p["experts"], buf.view(E, C, D), fill, train).view(E * C, D)
    out = torch.zeros((T, D), dtype=torch.float32)
    for k in range(K):
        w = (gate_vals[:, k] * keep[k::K]).to(torch.float32)
        out = out + y[row[k::K]].to(torch.float32) * w[:, None]
    return out.to(x2d.dtype), aux


def test_olmoe_logits_unchanged(monkeypatch):
    """Reduced olmoe's prefill and decode logits, bit for bit, against the
    MoE FFN as it stood before the DeepSeek variant."""
    cfg = get_arch("olmoe-1b-7b").reduced()
    W = init_params(cfg, device="cpu", seed=7)
    toks = torch.randint(0, cfg.vocab_size, (28,), generator=torch.Generator().manual_seed(8))
    now = _prefill_then_decode(cfg, W, toks, 24, 32)
    monkeypatch.setattr(LM, "moe_ffn", _parent_moe_ffn)
    before = _prefill_then_decode(cfg, W, toks, 24, 32)
    assert torch.equal(now[0], before[0]) and torch.equal(now[1], before[1])
