"""The readers of the program's named spans (``portbench/spans.py`` and the
five metrics on it) on a synthetic profiler trace whose answers are known:
two ``model.decode`` spans on one thread holding 3 and 5 launches, one of
them inside a nested ``attn_scores`` region; a launch outside any span;
and a launch on another thread inside a span's interval, which must not
count."""

from types import SimpleNamespace

import pytest

from portbench import spans, spec
from portbench.trace import Trace

MAIN, OTHER = 1, 2


class Events:
    def __init__(self):
        self.events, self._corr = [], 0

    def span(self, name, ts, dur, tid=MAIN):
        self.events.append({"name": name, "cat": "user_annotation", "ph": "X", "ts": ts,
                            "dur": dur, "tid": tid})

    def launch(self, ts, dur, tid=MAIN, cat="kernel"):
        """A launch at ``ts`` on ``tid`` and its device work of ``dur`` us."""
        self._corr += 1
        args = {"correlation": self._corr}
        self.events.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ph": "X",
                            "ts": ts, "dur": 2, "tid": tid, "args": args})
        self.events.append({"name": f"work{self._corr}", "cat": cat, "ph": "X",
                            "ts": 10_000 + 100 * self._corr, "dur": dur, "tid": 7,
                            "args": args})


def serve_trace():
    ev = Events()
    ev.span("model.decode", 100, 100)                 # 3 launches: 10 + 20 + 30 us
    ev.launch(110, 10)
    ev.span("attn_scores", 140, 20)
    ev.launch(150, 20)
    ev.launch(170, 30)
    ev.launch(150, 4000, tid=OTHER)                   # another thread: not counted
    ev.launch(250, 1000)                              # outside any span
    ev.span("model.decode", 300, 100)                 # 5 launches, one a copy: 100 us
    for i, cat in enumerate(("kernel", "kernel", "gpu_memcpy", "kernel", "gpu_memset")):
        ev.launch(310 + 10 * i, 20, cat=cat)
    ev.span("serve.cache", 500, 100)                  # 100 + 300 us
    ev.launch(510, 100, cat="gpu_memset")
    ev.launch(520, 300, cat="gpu_memcpy")
    ev.span("serve.cache", 700, 100)                  # none
    ev.span("serve.route", 0, 50)                     # 50 + 40 + 30 us of host
    ev.span("serve.route", 610, 40)
    ev.span("serve.score", 660, 30)
    ev.span("serve.route", 665, 10)                   # inside the score span: once
    return Trace(ev.events, 1.0)


def serve_obs(trace, on_card=True):
    reqs = [SimpleNamespace(in_profile=p, failed=f)
            for p, f in ((True, False), (True, False), (True, False), (True, True),
                         (False, False), (False, False))]
    return SimpleNamespace(on_card=on_card, trace=trace, requests=reqs)


def train_trace():
    ev = Events()
    for t0, durs in ((0, (400, 600)), (1000, (500, 700, 800))):
        ev.span("train.optimizer", t0, 500)
        for i, d in enumerate(durs):
            ev.launch(t0 + 10 + 10 * i, d)
        ev.launch(t0 + 600, 9999)                     # the next step's forward
    return Trace(ev.events, 1.0)


EXPECT = {
    "decode_launches.serve": 4.0,                     # (3 + 5) / 2
    "decode_device_ms.serve": (60 + 100) / 1e3 / 2,
    "cache_ms.serve": 400 / 1e3 / 2,
    "dispatch_ms.serve": 120 / 1e3 / 3,               # 3 requests served in the profile
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_serving_readers(name):
    got = spec.metric_reader(name).read(serve_obs(serve_trace()))
    assert got == pytest.approx(EXPECT[name], rel=1e-12)


def test_adamw_reader():
    obs = SimpleNamespace(on_card=True, trace=train_trace(), requests=[])
    got = spec.metric_reader("adamw_ms.train").read(obs)
    assert got == pytest.approx((1000 + 2000) / 1e3 / 2, rel=1e-12)


def test_launched_keeps_to_the_span_and_its_thread():
    tr = serve_trace()
    assert spans.count(tr, "model.decode") == 2
    got = {e["args"]["correlation"] for e in spans.launched(tr, "model.decode")}
    assert got == {1, 2, 3, 6, 7, 8, 9, 10}           # not 4 (other thread), 5 (outside)
    assert spans.intervals(tr, ["serve.route", "serve.score"]) == {
        MAIN: [(0, 50), (610, 650), (660, 690)]}


@pytest.mark.parametrize("name", sorted(EXPECT) + ["adamw_ms.train"])
def test_readers_report_nothing_without_a_card_a_trace_or_a_span(name):
    read = spec.metric_reader(name).read
    assert read(serve_obs(serve_trace(), on_card=False)) is None
    assert read(serve_obs(None)) is None
    bare = Trace([e for e in serve_trace().events if e["cat"] != "user_annotation"], 1.0)
    assert read(serve_obs(bare)) is None
