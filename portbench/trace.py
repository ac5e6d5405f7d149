"""Reading a ``torch.profiler`` trace: device busy time, the device time of
the kernels launched inside a named ``record_function`` region, and the
breakdown the result line carries.

The trace is the profiler's Chrome-trace export, read as a list of events
(``name``, ``cat``, ``ts`` and ``dur`` in microseconds, ``tid``, and for a
kernel and its launch the shared ``args.correlation``).  A kernel belongs
to a region when the host call that launched it lies inside one of the
region's spans on the same thread.
"""

from __future__ import annotations

import gzip
import json
import os
import tempfile
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PROFILE_S = 8.0     # a traced run profiles the last seconds of its window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class Trace:
    events: List[dict]
    span_s: float                       # the traced window, host clock
    busy: List[Tuple[float, float]] = field(default_factory=list)   # merged, us

    @classmethod
    def from_profiler(cls, prof, span_s: float) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            events = load_events(path)
        finally:
            os.unlink(path)
        return cls(events, span_s)

    def __post_init__(self):
        self.busy = merge([(e["ts"], e["ts"] + e["dur"]) for e in self.device_events()])

    def device_events(self) -> List[dict]:
        return [e for e in self.events if e.get("cat") in DEVICE_CATS and "dur" in e]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def region_device_s(self, region: str) -> Optional[float]:
        """Device seconds of the kernels launched inside ``region``; None
        when the trace holds no span of it."""
        spans = defaultdict(list)
        for e in self.events:
            if e.get("cat") in HOST_CATS and e.get("name") == region and "dur" in e:
                spans[e.get("tid")].append((e["ts"], e["ts"] + e["dur"]))
        if not spans:
            return None
        for v in spans.values():
            v.sort()
        starts = {t: [a for a, _ in v] for t, v in spans.items()}
        inside = set()
        for e in self.events:
            if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
                continue
            corr = (e.get("args") or {}).get("correlation")
            v = spans.get(e.get("tid"))
            if corr is None or not v:
                continue
            i = bisect_right(starts[e.get("tid")], e["ts"]) - 1
            if i >= 0 and v[i][0] <= e["ts"] <= v[i][1]:
                inside.add(corr)
        total = sum(e["dur"] for e in self.device_events()
                    if (e.get("args") or {}).get("correlation") in inside)
        return total / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, List[list]]:
        """The device operations that took most time, by name, and the
        longest idle gaps summed by the innermost host op running at each
        gap's middle (``idle`` where none was)."""
        ops: Dict[str, float] = defaultdict(float)
        for e in self.device_events():
            ops[e["name"][:120]] += e["dur"] / 1e6
        host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in self.events
                       if e.get("cat") in HOST_CATS and "dur" in e),
                      key=lambda x: x[0])
        gaps: Dict[str, float] = defaultdict(float)
        timed = [e for e in self.events if "dur" in e
                 and e.get("cat") in HOST_CATS + DEVICE_CATS]
        lo = min((e["ts"] for e in timed), default=0.0)
        hi = max((e["ts"] + e["dur"] for e in timed), default=0.0)
        edges = [lo] + [x for ab in self.busy for x in ab] + [hi]
        starts = [h[0] for h in host]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name = "idle"
            # nested host ops: the latest-starting one that holds mid is
            # the innermost
            i = bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - 2000), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            gaps[name[:120]] += (b - a) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out
