"""The port's serving loop against the reference's, its score mirror, and
its launcher under the CI smoke assertions (all on the CPU).

Routing is the copied ``CacheAffinityRouter``, so on the seeded streams of
``tests/test_pipeline_runtime.py`` both servers must make the same
assignments and count the same prefix hits, swap-ins, prefills and decode
steps.  No chaos or SLOs here: those read the wall clock.
"""

import json

import numpy as np
import pytest

from repro.configs import get_arch as jax_get_arch
from repro.runtime.serve_loop import DiffusionServer as JaxServer
from repro_torch.configs import get_arch
from repro_torch.launch import serve as port_serve
from repro_torch.runtime.serve_loop import DiffusionServer

COUNTERS = ("served", "prefix_hits", "swap_ins", "prefills", "decode_steps")

STREAMS = {
    # test_server_prefix_affinity_beats_first_available, both policies
    "affinity-gcc": dict(kw=dict(policy="good-cache-compute", max_replicas=3,
                                 cache_cap=48, seed=1), scale=3, sessions=6),
    "affinity-fa": dict(kw=dict(policy="first-available", max_replicas=3,
                                cache_cap=48, seed=1), scale=3, sessions=6),
    # test_server_batch_drain_serves_bursts_with_affinity
    "batch-drain": dict(kw=dict(policy="good-cache-compute", max_replicas=3,
                                cache_cap=48, seed=1, batch_drain=True,
                                dispatcher_impl="vectorized"), scale=3, sessions=6),
    # test_server_host_dram_tier_swaps_in_without_prefill
    "host-dram": dict(kw=dict(policy="good-cache-compute", max_replicas=1,
                              min_replicas=1, cache_cap=48, max_sessions=2,
                              host_cache_sessions=4, seed=1), scale=None, sessions=3,
                      rounds=2),
}


def drive(srv, spec, vocab):
    srv.router.assignment_log = []
    if spec["scale"]:
        srv.scale_to(spec["scale"])
    rng = np.random.default_rng(0)
    prompts = {f"s{i}": rng.integers(0, vocab, size=(12,))
               for i in range(spec["sessions"])}
    for _ in range(spec.get("rounds", 4)):
        for sid, p in prompts.items():
            srv.submit(sid, p, max_new_tokens=2)
        srv.step()
    return srv.router.assignment_log, {c: getattr(srv.stats, c) for c in COUNTERS}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_server_matches_reference(stream):
    spec = STREAMS[stream]
    ref_log, ref_stats = drive(JaxServer(jax_get_arch("internlm2-1.8b").reduced(),
                                         **spec["kw"]), spec, 256)
    log, stats = drive(DiffusionServer(get_arch("internlm2-1.8b").reduced(),
                                       device="cpu", **spec["kw"]), spec, 256)
    assert log == ref_log and len(log) > 0
    assert stats == ref_stats


@pytest.mark.parametrize("backend", ["numpy", "cuda"])
def test_score_mirror_stays_exact_over_a_served_stream(backend):
    """backend="cuda" on a CPU device runs the update kernel's plain version."""
    srv = DiffusionServer(get_arch("internlm2-1.8b").reduced(), device="cpu",
                          dispatcher_impl="vectorized", batch_drain=True,
                          cache_cap=48, seed=0)
    disp = srv.router.dispatcher
    mirror = disp.attach_device_mirror(backend=backend, device="cpu")
    rng = np.random.default_rng(0)
    prompts = {f"s{i}": rng.integers(0, 256, size=(16,)) for i in range(8)}
    sids = list(prompts)
    for i in range(32):
        sid = sids[int(rng.integers(0, len(sids)))]
        srv.submit(sid, prompts[sid], max_new_tokens=2)
        if (i + 1) % 8 == 0:
            srv.step()
            mirror.flush()
            assert mirror.verify() == 0.0
    assert srv.stats.served == 32
    assert mirror.stats.rank_k_applied > 0          # the rank-K path ran
    assert disp.check_consistency()


def _bursts(srv, n=32, burst=8):
    """The launcher's stream: repeated sessions within a burst make presence
    deltas reach demanded rows, so the mirror's rank-K path runs."""
    srv.router.assignment_log = []
    rng = np.random.default_rng(0)
    prompts = {f"s{i}": rng.integers(0, 256, size=(16,)) for i in range(8)}
    sids = list(prompts)
    for i in range(n):
        sid = sids[int(rng.integers(0, len(sids)))]
        srv.submit(sid, prompts[sid], max_new_tokens=2)
        if (i + 1) % burst == 0:
            srv.step()
    return srv.router.assignment_log, {c: getattr(srv.stats, c) for c in COUNTERS}


def test_device_scores_keep_reference_decisions():
    """The vectorized server's per-epoch rescore and mirror flush (the
    update kernel's plain version on the CPU) change no decision."""
    kw = dict(dispatcher_impl="vectorized", batch_drain=True, cache_cap=48, seed=0)
    ref_log, ref_stats = _bursts(JaxServer(jax_get_arch("internlm2-1.8b").reduced(),
                                           **kw))
    srv = DiffusionServer(get_arch("internlm2-1.8b").reduced(), device="cpu", **kw)
    log, stats = _bursts(srv)
    assert log == ref_log and len(log) > 0 and stats == ref_stats
    sc = srv.score_stats
    assert sc.epochs == 4 and sc.max_rows == 8 and sc.rank_k_keys > 0
    assert srv.score_mirror.verify() == 0.0


def test_device_scores_raise_on_a_difference():
    srv = DiffusionServer(get_arch("internlm2-1.8b").reduced(), device="cpu",
                          dispatcher_impl="vectorized", batch_drain=True,
                          cache_cap=48)
    srv.submit("s0", np.arange(12), max_new_tokens=2)
    srv.router.dispatcher._Sw += 0.5            # host scores drift from presence
    with pytest.raises(RuntimeError, match="rescore"):
        srv.step()
    srv.router.dispatcher._Sw -= 0.5
    srv.step()
    srv.score_mirror._dev += 1.0                # the device copy drifts
    with pytest.raises(RuntimeError, match="mirror"):
        srv._flush_scores()


def test_payload_real_is_not_ported():
    with pytest.raises(NotImplementedError, match="A5"):
        DiffusionServer(get_arch("internlm2-1.8b").reduced(), device="cpu",
                        payload="real", host_cache_sessions=2)


def _run_launcher(capsys, *args):
    port_serve.main(["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
                     *args])
    return capsys.readouterr().out.splitlines()


def _kv(line, skip=1):
    return dict(p.split("=") for p in line.split()[skip:] if "=" in p)


def test_launcher_obs_smoke(capsys, tmp_path):
    out = tmp_path / "obs"
    _run_launcher(capsys, "--requests", "48", "--sessions", "8", "--batch-drain",
                  "--dispatcher", "vectorized", "--metrics-dir", str(out),
                  "--trace-sample", "4", "--slo", "p99_ms=250:hit_rate=0.05")
    doc = json.load(open(out / "metrics.json"))
    m = doc["metrics"]
    assert doc["schema_version"] >= 1
    assert m["perf.performance_index"] > 0, m
    assert m["perf.speedup"] > 0, m
    assert doc["perf_intervals"], "no per-interval utilization rows"
    assert m["analyze.requests"] > 0
    assert any(k.startswith("slo.") for k in m)
    assert json.load(open(out / "trace_chrome.json"))["traceEvents"]
    assert (out / "crit_path.md").stat().st_size > 0


def test_launcher_chaos_smoke(capsys):
    lines = _run_launcher(capsys, "--requests", "48", "--sessions", "8",
                          "--replicas", "3", "--min-replicas", "3", "--chaos", "7")
    assert any(l.startswith("served=") for l in lines)
    kv = _kv(next(l for l in lines if l.startswith("chaos:")))
    assert int(kv["lost_requests"]) == 0
    assert int(kv["crashed"]) + int(kv["corruptions_recovered"]) > 0


def test_launcher_overload_smoke(capsys):
    lines = _run_launcher(capsys, "--requests", "48", "--sessions", "12",
                          "--replicas", "3", "--chaos", "7", "--tenants", "4",
                          "--slo-per-tenant", "p99_ms=200:hit_rate=0.5")
    adm = _kv(next(l for l in lines if l.startswith("admission:")))
    assert int(adm["spikes"]) > 0 and int(adm["admits"]) > 0
    assert int(_kv(next(l for l in lines if l.startswith("chaos:")))["lost_requests"]) == 0
    tenants = [l for l in lines if l.startswith("tenant t")]
    assert len(tenants) == 4
    for l in tenants:
        t = _kv(l, skip=2)
        assert int(t["offered"]) == int(t["served"]) + int(t["shed"]) + int(t["rejected"])
