"""The decoder's counts of operations and bytes against values worked out
by hand, and the metric readers on observations made up for the purpose,
which reach the counts through the observation's architecture module."""

import types

import pytest

from portbench import arith, spec
from portbench.reference import decoder
from portbench.trace import Trace
from pb_helpers import probe

INTERNLM2 = spec.load_json(spec.HERE / "configs" / "internlm2-1.8b.json")["arch"]
OLMOE = spec.load_json(spec.HERE / "configs" / "olmoe-1b-7b.json")["arch"]


def test_matmul_params_a_layer():
    # 2048*2048*2 (q, o) + 2048*1024*2 (k, v) + 3*2048*8192
    assert decoder.layer_matmul_params(INTERNLM2) == 12_582_912 + 50_331_648
    # 2048*2048*4 + 8 experts * 3*2048*1024 + the 2048 x 64 router
    assert decoder.layer_matmul_params(OLMOE) == 16_777_216 + 50_331_648 + 131_072


def test_forward_ops():
    # 2*24*62,914,560 + 2*2048*92,672 (the padded head) + 24 * 8192 (one key)
    assert decoder.decode_ops(INTERNLM2, 0) == 3_399_680_000
    # 2*16*67,239,936*2 + 2*2048*50,688 + 16 * 8192 * 3 pairs
    assert decoder.prefill_ops(OLMOE, 2) == 4_511_367_168


def test_attention_bounds():
    # causal 16k prefill: 8192 * 16384 * 16385 / 2 operations a layer at 989 TFLOP/s
    assert decoder.attention_bound_s(INTERNLM2, "prefill", 16384) == pytest.approx(
        0.026683407158099092, rel=1e-12)
    # olmoe decode over 4000 keys: 2 * 128 * (32 + 32 * 4000) bytes a layer at 3.35 TB/s
    assert decoder.attention_bound_s(OLMOE, "decode", 4000) == pytest.approx(
        0.00015654300656716417, rel=1e-12)


def test_train_step_ops():
    # 6 * 24 * 62,914,560 * 2048 + 6 * 2048 * 92,672 * 8 * 255 + 3 * 24 * 8192 * 8 * 256 * 257 / 2
    assert decoder.train_step_ops(INTERNLM2, 8, 256) == 21_032_538_734_592


def _obs(**kw):
    base = dict(arch=INTERNLM2, reference=probe(decoder), on_card=True, setup_s=1.0, window_s=2.0,
                counters={"served": 4, "prefix_hits": 1}, trace=None, profile_start=None,
                window_start=0.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _req(**kw):
    base = dict(submit=0.0, finish=0.5, tokens=1, failed=False, in_profile=False,
                prefill_len=0, positions=[100])
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_serve_readers():
    reqs = [_req(prefill_len=4096, positions=[4096]), _req(finish=1.0),
            _req(finish=2.0, in_profile=True), _req(failed=True, tokens=0, positions=[])]
    ev = [{"name": "attn_scores", "cat": "user_annotation", "ts": 0.0, "dur": 10.0, "tid": 1},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 5.0, "dur": 1.0,
           "tid": 1, "args": {"correlation": 7}},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 20.0, "dur": 1.0,
           "tid": 1, "args": {"correlation": 8}},
          {"name": "k3", "cat": "kernel", "ts": 30.0, "dur": 250000.0, "args": {"correlation": 7}},
          {"name": "gemm", "cat": "kernel", "ts": 250100.0, "dur": 250000.0,
           "args": {"correlation": 8}}]
    obs = _obs(requests=reqs, trace=Trace(ev, 1.0), profile_start=1.5)
    read = lambda name: spec.metric_reader(name).read(obs)
    assert read("output_tokens_per_s") == 3 / 2.0
    assert read("prefix_hit_rate") == 25.0
    assert read("device_idle_share.serve") == pytest.approx(50.0)
    need = decoder.attention_bound_s(INTERNLM2, "decode", 101)
    assert read("attention_roofline.serve") == pytest.approx(100 * need / 0.25)
    ops = (decoder.prefill_ops(INTERNLM2, 4096) + decoder.decode_ops(INTERNLM2, 4096)
           + decoder.decode_ops(INTERNLM2, 100))
    assert read("mfu.serve") == pytest.approx(100 * ops / (1.0 * arith.PEAK_FLOPS))
    assert read("response_p95_ms") == pytest.approx(1e3 * (1.0 + 0.9 * 1.0))
    assert {"attention_bound_s", "prefill_ops", "decode_ops"} <= set(obs.reference.calls)


def test_train_reader():
    steps = [types.SimpleNamespace(finish=f, failed=False, in_profile=p)
             for f, p in ((0.5, False), (1.0, False), (2.0, True))]
    obs = _obs(requests=steps, profile_start=1.5, batch=8, seq=256)
    ops = 2 * decoder.train_step_ops(INTERNLM2, 8, 256)
    assert spec.metric_reader("mfu.train").read(obs) == pytest.approx(
        100 * ops / (1.0 * arith.PEAK_FLOPS))
    assert obs.reference.calls["train_step_ops"] == 1


def test_device_readers_are_silent_off_the_card():
    obs = _obs(requests=[_req()], on_card=False, profile_start=0.5)
    for name in ("attention_roofline.serve", "mfu.serve", "device_idle_share.serve",
                 "mfu.train"):
        assert spec.metric_reader(name).read(obs) is None
