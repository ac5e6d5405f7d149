"""Reading the program's named spans (``repro_torch.obs.spans``) from a
``torch.profiler`` trace (``trace.Trace``): a span's host intervals on each
thread, and the device work (kernels, copies, memsets) whose launch lies
inside one of them on the same thread, matched by the launch's
``args.correlation`` as ``Trace.region_device_s`` matches it.  A program
that opens no such span (an older one) gives nothing, and the readers of
these metrics then report nothing."""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from .trace import HOST_CATS, Trace, merge

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def intervals(trace: Trace, names: Iterable[str]) -> Dict[object, List[Tuple[float, float]]]:
    """Host intervals (us) of the spans named ``names``, by thread, each
    thread's merged so that nested or touching spans count once."""
    names = set(names)
    out = defaultdict(list)
    for e in trace.events:
        if e.get("cat") in HOST_CATS and e.get("name") in names and "dur" in e:
            out[e.get("tid")].append((e["ts"], e["ts"] + e["dur"]))
    return {t: merge(v) for t, v in out.items()}


def count(trace: Trace, name: str) -> int:
    """How many spans ``name`` the trace holds."""
    return sum(1 for e in trace.events
               if e.get("cat") in HOST_CATS and e.get("name") == name and "dur" in e)


def launched(trace: Trace, name: str) -> List[dict]:
    """The device events whose launch lies inside a span ``name`` on the
    launching thread."""
    spans = intervals(trace, [name])
    starts = {t: [a for a, _ in v] for t, v in spans.items()}
    inside = set()
    for e in trace.events:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        v = spans.get(e.get("tid"))
        if corr is None or not v:
            continue
        i = bisect_right(starts[e.get("tid")], e["ts"]) - 1
        if i >= 0 and v[i][0] <= e["ts"] <= v[i][1]:
            inside.add(corr)
    return [e for e in trace.device_events()
            if (e.get("args") or {}).get("correlation") in inside]


def per_span(obs, name: str) -> Optional[Tuple[int, List[dict]]]:
    """(number of spans ``name``, the device events launched inside them)
    in a run's device trace; None off the card, without a trace, or when
    the trace holds no such span."""
    if not obs.on_card or obs.trace is None:
        return None
    n = count(obs.trace, name)
    return (n, launched(obs.trace, name)) if n else None


def device_ms_per_span(obs, name: str) -> Optional[float]:
    """Device ms of the work launched inside the spans ``name``, over
    their number."""
    got = per_span(obs, name)
    if got is None:
        return None
    n, events = got
    return sum(e["dur"] for e in events) / 1e3 / n
