"""DeepSeek-V2's architecture module (``reference/deepseek_v2.py``) on the
CPU at tiny widths: its forward against the tests' own plain reference
(``tests/_deepseek_v2_reference.py``), its float8 control outside the
cell's limits, its counts of operations checked by hand at one small
shape, and the three MoE readers on a synthetic on-card observation."""

import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import spec
from portbench.arith import HBM_BW, PEAK_FLOPS
from portbench.reference import deepseek_v2 as ds
from pb_helpers import reduced_cell
from test_pb_spans import Events

sys.path.insert(0, str(spec.ROOT / "tests"))
import _deepseek_v2_reference as plain  # noqa: E402

from portbench.trace import Trace  # noqa: E402

CELL = "deepseek-v2-lite.doc-reuse"


def _tiny():
    cell = reduced_cell(CELL)
    return cell, cell.config["arch"]


def test_the_cell_names_this_module_and_publishes_no_cut():
    cell = spec.find_cell(CELL)
    assert cell.reference is ds and cell.config["reduced"] == []
    a = cell.config["arch"]
    assert (a["num_layers"], a["kv_lora_rank"], a["qk_rope_head_dim"]) == (27, 512, 64)
    assert cell.config["kv_lora_rank"] == 512 and cell.config["n_routed_experts"] == 64


@pytest.mark.parametrize("seed", [21, 22])
def test_forward_matches_the_tests_plain_reference(seed):
    """Two float32 forwards of the same equations written apart: the
    module's in query blocks with float64 rope angles, the tests' whole;
    only rounding differs (1e-4 of the logits' spread)."""
    cell, arch = _tiny()
    W = ds.make_weights(arch, seed, "cpu")
    toks = torch.randint(0, arch["vocab_size"], (40,),
                         generator=torch.Generator().manual_seed(seed))
    pos = list(range(30, 40))
    got = ds.forward_logits(W, arch, toks, pos, segments=[30] + [1] * 10, q_block=16)
    want = plain.forward(W, arch, toks)[pos]
    err = (got - want).abs().max(-1).values / want.std(-1)
    assert float(err.max()) < 1e-4, err


def test_fp8_control_is_outside_the_cells_limits():
    """The reference in float8, against itself in float32, where the serve
    driver reads it: its median error over the spread passes the cell's
    ``logit_err_p50`` limit."""
    cell, arch = _tiny()
    limits = spec.find_cell(CELL).cell["limits"]
    W = ds.make_weights(arch, 23, "cpu")
    toks = torch.randint(0, arch["vocab_size"], (64,), generator=torch.Generator().manual_seed(5))
    pos = list(range(32, 64))
    f32 = ds.forward_logits(W, arch, toks, pos)
    fp8 = ds.forward_logits(W, arch, toks, pos, precision="fp8")
    err = (fp8 - f32).abs().max(-1).values / f32.std(-1)
    assert float(err.median()) > limits["logit_err_p50"], err


def test_train_loss_runs_and_its_control_differs():
    cell, arch = _tiny()
    W = ds.make_weights(arch, 24, "cpu")
    toks = torch.randint(0, arch["vocab_size"], (2, 12), generator=torch.Generator().manual_seed(6))
    f32 = ds.train_loss(W, arch, toks)
    assert torch.isfinite(f32) and float(f32) > 0
    assert float((ds.train_loss(W, arch, toks, precision="fp8") - f32).abs()) > 0


def test_counts_by_hand_at_a_small_shape():
    """Two layers (one dense) of width 8, 2 heads of qk 4 + 2 rope, v 4, a
    latent of 6, 4 experts of 3, top-2, shared 5, vocabulary 512."""
    a = dict(num_layers=2, d_model=8, num_heads=2, head_dim=6, kv_lora_rank=6,
             qk_nope_head_dim=4, qk_rope_head_dim=2, v_head_dim=4, d_ff=3,
             num_experts=4, moe_top_k=2, shared_d_ff=5, first_dense_layers=1,
             dense_d_ff=7, vocab_size=512)
    # a layer's attention: W_q 8*12, W_kv_a 8*8, W_kv_b 6*16, W_o 8*8
    attn = 96 + 64 + 96 + 64
    dense = 3 * 8 * 7
    moe = 2 * 3 * 8 * 3 + 8 * 4 + 3 * 8 * 5
    params = 2 * attn + dense + moe
    assert ds.matmul_params(a) == params == 1104
    head = 2 * 8 * 512
    # a pair: q.k at 2 * 6 and p.v at 2 * 4, two heads
    assert ds.prefill_pair_ops(a) == 2 * 2 * (6 + 4) == 40
    assert ds.prefill_ops(a, 3) == 2 * params * 3 + head + 2 * 40 * 6
    # a cached position: q_lat.c_kv (6) + q_pe.k_pe (2), then p.c_kv (6)
    assert ds.decode_key_ops(a) == 2 * 2 * (6 + 2 + 6) == 56
    assert ds.decode_ops(a, 4) == 2 * params + head + 2 * 56 * 5
    assert ds.train_step_ops(a, 2, 3) == 6 * params * 6 + 6 * 8 * 512 * 2 * 2 + 3 * 2 * 40 * 12
    pre = 2 * max(40 * 6 / PEAK_FLOPS, 2 * 3 * 2 * (12 + 8) / HBM_BW)
    assert ds.attention_bound_s(a, "prefill", 3) == pytest.approx(pre)
    dec = 2 * max(56 * 5 / PEAK_FLOPS, 2 * (8 * 5 + 2 * 14) / HBM_BW)
    assert ds.attention_bound_s(a, "decode", 5) == pytest.approx(dec)
    # one MoE layer; a decode token reaches 2 of 4 experts, 10 tokens all 4
    one = max(2 * 2 * 3 * 8 * 3 / PEAK_FLOPS, 2 * (2 * 72 + 2 * 2 * 8) / HBM_BW)
    assert ds.expert_bound_s(a, "decode", 1) == pytest.approx(one)
    many = max(2 * 20 * 3 * 8 * 3 / PEAK_FLOPS, 2 * (4 * 72 + 2 * 20 * 8) / HBM_BW)
    assert ds.expert_bound_s(a, "prefill", 10) == pytest.approx(many)


def test_published_counts():
    """At the published widths: 2.24 B matmul parameters a token, 110.6
    TFLOP in a 16,384-token prefill (37.1 of it attention), 0.81 ms of
    expert weights a decode step."""
    arch = spec.find_cell(CELL).config["arch"]
    assert round(ds.matmul_params(arch) / 1e9, 2) == 2.24
    assert round(ds.prefill_ops(arch, 16384) / 1e12, 1) == 110.6
    assert round(27 * ds.prefill_pair_ops(arch) * 16384 * 16385 / 2 / 1e12, 1) == 37.1
    assert round(ds.expert_bound_s(arch, "decode", 1) * 1e3, 2) == 0.81


def _moe_trace():
    ev = Events()
    ev.span("moe.route", 100, 30)                     # 30 + 20 us of host
    ev.span("moe.experts", 140, 50)                   # 400 + 600 us of device
    ev.launch(150, 400)
    ev.launch(160, 600)
    ev.span("moe.route", 300, 20)
    ev.launch(310, 5000)                              # inside moe.route: not experts'
    ev.launch(400, 7000)                              # outside any span
    return Trace(ev.events, 1.0)


def _obs(trace, reference=ds, on_card=True):
    arch = spec.find_cell(CELL).config["arch"]
    reqs = [SimpleNamespace(in_profile=True, failed=False, prefill_len=4096, positions=[4096]),
            SimpleNamespace(in_profile=True, failed=False, prefill_len=0, positions=[5000]),
            SimpleNamespace(in_profile=True, failed=True, prefill_len=9, positions=[9]),
            SimpleNamespace(in_profile=False, failed=False, prefill_len=8, positions=[8])]
    return SimpleNamespace(on_card=on_card, trace=trace, requests=reqs, arch=arch,
                           reference=reference)


def test_moe_readers_on_a_synthetic_trace():
    roof = spec.metric_reader("moe_roofline.serve")
    route = spec.metric_reader("moe_route_ms.serve")
    obs = _obs(_moe_trace())
    need = (ds.expert_bound_s(obs.arch, "prefill", 4096)
            + 2 * ds.expert_bound_s(obs.arch, "decode", 1))
    assert roof.read(obs) == pytest.approx(100 * need / 1000e-6)
    assert route.read(obs) == pytest.approx((30 + 20) / 1e3 / 2)
    # nothing off the card, without a trace, without the spans, or for an
    # architecture whose module counts no experts
    for o in (_obs(_moe_trace(), on_card=False), _obs(None), _obs(Trace([], 1.0)),
              _obs(_moe_trace(), reference=SimpleNamespace())):
        assert roof.read(o) is None
    for o in (_obs(_moe_trace(), on_card=False), _obs(None), _obs(Trace([], 1.0))):
        assert route.read(o) is None


def test_fullest_share_reader_takes_the_windows_reads(monkeypatch):
    """The program's records inside the window (the set-up's and a later
    one's left out): the mean of count over tokens; nothing from a window
    without a read, or from a program that keeps no such record."""
    from collections import deque

    from repro_torch.models import moe
    share = spec.metric_reader("moe_fullest_share.serve")
    obs = SimpleNamespace(window_start=10.0, window_s=30.0)
    monkeypatch.setattr(moe, "FILL_READS", deque(
        [(9.5, 2048, 2048), (10.0, 1024, 2048), (39.0, 256, 2048), (40.5, 8, 8)]))
    assert share.read(obs) == pytest.approx(100 * (0.5 + 0.125) / 2)
    assert share.read(SimpleNamespace(window_start=41.0, window_s=5.0)) is None
    monkeypatch.delattr(moe, "FILL_READS")
    assert share.read(obs) is None
