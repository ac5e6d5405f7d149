"""The traffic generators: deterministic by seed, within their declared
bounds, and with the declared popularity."""

import numpy as np
import pytest

from portbench import spec
from pb_helpers import bench

DOC_MIXES = sorted({w["traffic"] for w in bench()["workloads"]
                    if spec.load_json(spec.HERE / "traffic" / f"{w['traffic']}.json")
                    ["kind"] == "doc_stream"})
SEED = 2**31 + 4242


def stream(name, seed=SEED):
    t = spec.load_json(spec.HERE / "traffic" / f"{name}.json")
    return t, spec.traffic_kind(t).make(t, seed, 50304)


@pytest.mark.parametrize("mix", DOC_MIXES)
def test_same_seed_same_stream(mix):
    (_, a), (_, b), (_, c) = stream(mix), stream(mix), stream(mix, SEED + 1)
    xs, ys, zs = ([s.next() for _ in range(300)] for s in (a, b, c))
    assert all(x.session == y.session and np.array_equal(x.prompt, y.prompt)
               for x, y in zip(xs, ys))
    # another seed: other tokens, the same sizes and arrivals
    assert not any(np.array_equal(x.prompt, z.prompt) for x, z in zip(xs, zs))
    assert all(x.session == z.session and len(x.prompt) == len(z.prompt)
               for x, z in zip(xs, zs))


@pytest.mark.parametrize("mix", DOC_MIXES)
def test_max_asks_and_cache_cap(mix):
    """No document is asked more than ``max_asks`` times, every length is
    in [len_min, len_max], and no session's cache position (its prompt
    plus one token an ask) reaches the configuration's cache cap."""
    t, s = stream(mix)
    caps = [spec.load_json(spec.HERE / "configs" / f"{w['config']}.json")["serve"]["cache_cap"]
            for w in bench()["workloads"] if w["traffic"] == mix]
    asks, longest = {}, {}
    for _ in range(4000):
        a = s.next()
        asks[a.session] = asks.get(a.session, 0) + 1
        assert t["len_min"] <= len(a.prompt) <= t["len_max"]
        assert a.ask == asks[a.session] - 1
        longest[a.session] = len(a.prompt) + asks[a.session] * a.new_tokens
    assert max(asks.values()) <= t["max_asks"]
    assert max(longest.values()) < min(caps) - 1


@pytest.mark.parametrize("mix", DOC_MIXES)
def test_zipf_shares(mix):
    """Rank r is picked with probability (1/r^s) / sum: the empirical
    shares of the first ranks within four standard errors."""
    t, s = stream(mix)
    n = 20000
    counts = np.zeros(t["pool"])
    for _ in range(n):
        counts[s.next().rank] += 1
    r = np.arange(1, t["pool"] + 1, dtype=float)
    want = (1 / r ** t["zipf_s"]) / np.sum(1 / r ** t["zipf_s"])
    assert np.allclose(s.shares, want)
    for k in range(5):
        se = np.sqrt(want[k] * (1 - want[k]) / n)
        assert abs(counts[k] / n - want[k]) < 4 * se


def test_shard_store_is_seeded():
    t = spec.load_json(spec.HERE / "traffic" / "train-8x256.json")

    class Spec:
        shard_id, num_tokens, nbytes = 3, 1000, 4000

    a = spec.traffic_kind(t).make(t, SEED, 92544).fetch(Spec)
    b = spec.traffic_kind(t).make(t, SEED, 92544).fetch(Spec)
    c = spec.traffic_kind(t).make(t, SEED + 1, 92544).fetch(Spec)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 92544
