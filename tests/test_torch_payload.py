"""The port's physical payload plane (``RealPayload`` on torch tensors) and
the serving loop's ``payload="real"`` mode, on the CPU.

Ports the reference's ``TestRealPayloadRoundTrip`` (``tests/test_payload.py``)
and ``TestCorruptionRecovery`` (``tests/test_chaos.py``) with the hbm home on
``device="cpu"``, and adds what torch's mutable tensors make necessary: every
home is a snapshot (a tensor changed in place after ``put`` leaves the
stored bytes alone).  The served stream of the reference's real-payload test
must give the reference's counters, and modeled and real payloads the same
decisions and the same greedy tokens within the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.checkpoint.checkpointer import to_raw_bytes as jax_to_raw_bytes
from repro.configs import get_arch as jax_get_arch
from repro.runtime.serve_loop import DiffusionServer as JaxServer
from repro_torch.checkpoint.checkpointer import to_raw_bytes
from repro_torch.configs import get_arch
from repro_torch.diffusion import RealPayload
from repro_torch.diffusion.payload import _leaf_nbytes, _SpilledLeaf
from repro_torch.diffusion.tiers import TierSpec
from repro_torch.runtime.chaos import flip_spill_byte
from repro_torch.runtime.router import CacheAffinityRouter
from repro_torch.runtime.serve_loop import DiffusionServer

COUNTERS = ("served", "prefix_hits", "swap_ins", "prefills", "decode_steps")


def bits(t: torch.Tensor) -> np.ndarray:
    return to_raw_bytes(t).copy()


def bf16_page(seed: int, shape=(4, 64, 8)) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


# ------------------------------------------------------------ real homes

class TestRealPayloadRoundTrip:
    def test_kv_page_roundtrip_all_homes(self, tmp_path):
        """HBM -> DRAM -> disk -> HBM, bit-equal at the end (bf16 KV page,
        chunked spill with per-chunk sha256 verified on the way back)."""
        page = {"k": bf16_page(0), "v": bf16_page(1)}
        want = {k: bits(v) for k, v in page.items()}
        p = RealPayload("t", spill_dir=str(tmp_path), chunk_bytes=1024,
                        device="cpu")
        p.put("kv:page", page, "hbm")
        for tier in ("dram", "disk", "hbm"):
            p.moved("kv:page", tier)
            if tier == "disk":      # 4 KiB a leaf: four chunks each
                spilled = p._leaves["kv:page"]
                assert all(isinstance(s, _SpilledLeaf) and len(s.chunks) == 4
                           for s in spilled)
        got = p.get("kv:page")
        for k in page:
            assert got[k].dtype == torch.bfloat16
            assert np.array_equal(bits(got[k]), want[k])
        edges = [(r["src"], r["dst"]) for r in p.measured.rows()]
        assert set(edges) == {("hbm", "dram"), ("dram", "disk"),
                              ("disk", "hbm")}
        assert all(r["bytes"] == 2 * 4 * 64 * 8 * 2 for r in p.measured.rows())
        assert p.measured.check_roofline(factor=10.0) == []
        # spill chunks were freed when the page left the disk home
        assert list(tmp_path.glob("*.kv")) == []

    def test_spill_corruption_detected(self, tmp_path):
        p = RealPayload("t", spill_dir=str(tmp_path), chunk_bytes=512,
                        device="cpu")
        p.put("kv:x", torch.arange(1024, dtype=torch.float32), "dram")
        p.moved("kv:x", "disk")
        chunk = sorted(tmp_path.glob("*.kv"))[0]
        raw = bytearray(chunk.read_bytes())
        raw[0] ^= 0xFF
        chunk.write_bytes(bytes(raw))
        with pytest.raises(IOError, match="corrupt"):
            p.get("kv:x")

    @pytest.mark.parametrize("tier", ["hbm", "dram", "disk"])
    def test_every_home_is_a_snapshot(self, tmp_path, tier):
        """decode updates its caches in place: neither that nor a write into
        what ``value`` handed out may reach the stored bytes."""
        k = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        v = bf16_page(2, (8, 8))
        want = (bits(k), bits(v))
        p = RealPayload("t", spill_dir=str(tmp_path), chunk_bytes=128,
                        device="cpu")
        p.put("kv:s", {"k": k, "rem": [v]}, tier)
        k.add_(1.0)
        v.mul_(2.0)
        out = p.value("kv:s")
        out["k"].zero_()
        out["rem"][0].zero_()
        p.get("kv:s")["k"].fill_(7.0)
        for got in (p.get("kv:s"), p.value("kv:s")):
            assert np.array_equal(bits(got["k"]), want[0])
            assert np.array_equal(bits(got["rem"][0]), want[1])
        p.moved("kv:s", "dram" if tier != "dram" else "hbm")
        k.add_(1.0)
        got = p.get("kv:s")
        assert np.array_equal(bits(got["k"]), want[0])

    def test_leaf_nbytes_counts_bf16_and_f32_tensors(self):
        leaves = [torch.zeros(3, 5, dtype=torch.bfloat16),
                  torch.zeros(7, dtype=torch.float32),
                  torch.zeros((), dtype=torch.int32),
                  np.zeros((2, 3), np.float32)]
        assert _leaf_nbytes(leaves) == 3 * 5 * 2 + 7 * 4 + 4 + 2 * 3 * 4
        p = RealPayload("t", device="cpu")
        p.put("kv:n", {"a": leaves[0], "b": leaves[1]}, "hbm")
        assert p.nbytes("kv:n") == 3 * 5 * 2 + 7 * 4

    def test_raw_bytes_of_bf16_match_the_reference(self):
        x = np.random.default_rng(3).standard_normal((5, 33)).astype(np.float32)
        ref = jax_to_raw_bytes(np.asarray(jnp.asarray(x, jnp.bfloat16)))
        got = to_raw_bytes(torch.from_numpy(x).to(torch.bfloat16))
        assert got.dtype == np.uint8 and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()


# ------------------------------------------------------- payload corruption

def make_router(replicas=2, **kw):
    r = CacheAffinityRouter(policy="good-cache-compute", **kw)
    for _ in range(replicas):
        r.add_replica(now=0.0)
    return r


class TestCorruptionRecovery:
    def test_recover_mode_drops_poisoned_copy_and_notifies(self, tmp_path):
        fired = []
        p = RealPayload("t", spill_dir=str(tmp_path), chunk_bytes=512,
                        device="cpu", corrupt_mode="recover")
        p.on_corruption = fired.append
        p.put("kv:x", torch.arange(1024, dtype=torch.float32), "dram")
        p.moved("kv:x", "disk")
        assert flip_spill_byte(p, "kv:x")
        assert p.get("kv:x") is None             # degrades, does not raise
        assert p.corruptions_recovered == 1
        assert fired == ["kv:x"]
        assert not p.has("kv:x")                 # poisoned copy dropped
        assert list(tmp_path.glob("*.kv")) == []  # spill chunks freed

    def test_raise_mode_still_raises(self, tmp_path):
        p = RealPayload("t", spill_dir=str(tmp_path), chunk_bytes=512,
                        device="cpu")
        p.put("kv:x", torch.arange(64, dtype=torch.float32), "dram")
        p.moved("kv:x", "disk")
        assert flip_spill_byte(p, "kv:x")
        with pytest.raises(IOError, match="corrupt"):
            p.get("kv:x")

    def test_router_requeues_refetch_on_next_tick(self):
        r = make_router(replicas=2,
                        tier_specs=[TierSpec("hbm", 100.0)],
                        object_size_fn=lambda o: 1.0)
        name = sorted(r.replicas())[0]
        r.stores[name].admit("kv:x", 1.0)
        r._note_corruption(name, "kv:x")
        assert r.faults.payload_corruptions_recovered == 1
        r.tick(5.0)                              # deferred recovery drains
        assert r.faults.refetches_issued == 1
        assert r.engine.stats.started >= 1

    def test_server_backends_recover_into_the_router(self, tmp_path):
        """The real server's per-replica backends: on its device, spilling
        under ``spill_dir``, in recover mode, wired to the router."""
        srv = DiffusionServer(get_arch("internlm2-1.8b").reduced(), device="cpu",
                              max_replicas=1, cache_cap=48, max_sessions=2,
                              host_cache_sessions=4, payload="real",
                              spill_dir=str(tmp_path))
        (store,) = srv.router.stores.values()
        backend = store.tiers.payload
        assert isinstance(backend, RealPayload)
        assert backend.device == torch.device("cpu")
        assert backend.corrupt_mode == "recover"
        backend.put("kv:x", torch.arange(256, dtype=torch.float32), "dram")
        backend.moved("kv:x", "disk")
        assert flip_spill_byte(backend, "kv:x")
        assert backend.value("kv:x") is None
        assert srv.router.faults.payload_corruptions_recovered == 1


# ------------------------------------------------------------ the server

def _serve(srv, prompts, rounds=2, new_tokens=2):
    """The stream of the reference's real-payload serving test; greedy
    tokens of every decode call are recorded."""
    tokens = []
    decode = srv.decode_fn

    def recorded(params, batch):
        logits, caches = decode(params, batch)
        tokens.append(logits.argmax(-1).tolist())
        return logits, caches

    srv.decode_fn = recorded
    srv.router.assignment_log = []
    for _ in range(rounds):
        for sid, p in prompts.items():
            srv.submit(sid, p, max_new_tokens=new_tokens)
        srv.step()
    return srv.router.assignment_log, {c: getattr(srv.stats, c) for c in COUNTERS}, tokens


KW = dict(policy="good-cache-compute", max_replicas=1, min_replicas=1,
          cache_cap=48, max_sessions=2, host_cache_sessions=4, seed=1)


def _prompts(vocab, n=3):
    rng = np.random.default_rng(0)
    return {f"s{i}": rng.integers(0, vocab, size=(12,)) for i in range(n)}


def test_real_server_matches_the_reference_real_server():
    jcfg = jax_get_arch("internlm2-1.8b").reduced()
    ref = JaxServer(jcfg, payload="real", **KW)
    ref_log, ref_stats, _ = _serve(ref, _prompts(jcfg.vocab_size))
    srv = DiffusionServer(get_arch("internlm2-1.8b").reduced(), device="cpu",
                          payload="real", **KW)
    log, stats, _ = _serve(srv, _prompts(jcfg.vocab_size))
    assert stats["swap_ins"] >= 1
    for c in ("swap_ins", "prefix_hits", "prefills"):
        assert stats[c] == ref_stats[c], c
    assert log == ref_log
    assert srv.swap_in_bandwidth() > 0.0
    assert srv.measured.total_bytes > 0
    assert srv.measured.check_roofline(factor=10.0) == []


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b",
                                  "recurrentgemma-9b", "rwkv6-3b"])
def test_modeled_and_real_serve_identically(arch):
    """Decisions, counters and every decode call's greedy tokens: the
    swapped-in bytes are the bytes that were demoted.  olmoe's, the RG-LRU's
    and RWKV6's caches hold f32 state and a ``rem`` list."""
    cfg = get_arch(arch).reduced()
    prompts = _prompts(cfg.vocab_size)
    runs = {}
    for payload in ("modeled", "real"):
        srv = DiffusionServer(cfg, device="cpu", payload=payload, **KW)
        runs[payload] = _serve(srv, prompts) + (srv,)
    (m_log, m_stats, m_tok, modeled), (r_log, r_stats, r_tok, real) = (
        runs["modeled"], runs["real"])
    assert r_log == m_log and len(r_log) == 6
    assert r_stats == m_stats and r_stats["swap_ins"] >= 1
    assert r_tok == m_tok and len(r_tok) == r_stats["decode_steps"]
    assert real.measured.bandwidth("hbm", "dram") > 0.0
    assert real.swap_in_bandwidth() > 0.0
    assert modeled.measured.total_bytes == 0


def test_tier_rooflines_are_the_h100s():
    """The dram tier reads the card's host link (PCIe Gen5 x16, 64 GB/s a
    direction), not NVLink; hbm and the disk class stay where they were."""
    from repro_torch.diffusion.tiers import roofline_tier_bw
    assert roofline_tier_bw("hbm") == 3.35e12
    assert roofline_tier_bw("dram") == 64e9
    assert roofline_tier_bw("disk") == 18e9
