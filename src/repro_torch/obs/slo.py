"""Declarative SLOs: error budgets and multi-window burn-rate alerts.

An ``SLOSpec`` states an objective over the live request stream:

    latency       fraction of requests answering within ``threshold_s``
                  must be >= ``target``    (e.g. p99 <= 50ms <=> target
                  0.99, threshold_s 0.05)
    hit_rate      object-level cache hit fraction must be >= ``target``
    availability  fraction of requests completing without failure must
                  be >= ``target``

Each spec compiles to an ``SLOTracker`` that counts good/bad events in two
time-bucketed rolling windows (a fast one for detection latency, a slow
one for confidence) plus lifetime error-budget accounting.  The alert rule
is the standard multi-window burn rate: with ``burn = bad_frac / (1 -
target)`` (1.0 = consuming budget exactly as fast as the objective
allows), the alert **fires** when *both* windows burn at >=
``fire_burn``, and **clears** only when *both* fall to <= ``fire_burn *
clear_frac``.  Between those bounds the state *holds* — the same dead-band
shape as ``CoherenceBus.adapt`` (fire above target, clear below target/2,
hold between), so a burn rate oscillating around the threshold cannot
flap the alert.

Clock discipline matches the rest of the runtime: callers pass ``now``
explicitly, so the DES drives SLO windows in virtual time and the serve
loop in wall-clock with the same code.

Stdlib-only; no repro imports.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence

__all__ = ["SLOBoard", "SLOSpec", "SLOTracker", "parse_slo_specs"]

_KINDS = ("latency", "hit_rate", "availability")


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective (see module docstring for kinds)."""

    name: str
    kind: str                    # "latency" | "hit_rate" | "availability"
    target: float                # good-fraction objective in (0, 1)
    threshold_s: float = 0.0     # latency kind only: the "good" bound
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fire_burn: float = 2.0       # fire when both windows burn >= this
    clear_frac: float = 0.5      # clear when both burn <= fire_burn * this

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r} (want {_KINDS})")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1): {self.target}")
        if self.kind == "latency" and self.threshold_s <= 0.0:
            raise ValueError("latency SLO needs threshold_s > 0")
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError("fast window must be shorter than slow window")


class _RollingWindow:
    """Good/bad event counts over the trailing ``window_s`` seconds.

    Time-bucketed (``buckets`` sub-intervals) so memory is O(buckets)
    regardless of event rate; counts age out a bucket at a time.  Running
    sums are maintained incrementally — ``observe`` and ``totals`` are
    O(1) amortized (eviction pops each bucket once), because this sits on
    the router's per-request completion path.
    """

    __slots__ = ("bucket_s", "buckets", "good", "bad", "_dq")

    def __init__(self, window_s: float, buckets: int = 12):
        self.buckets = int(buckets)
        self.bucket_s = float(window_s) / self.buckets
        self.good = 0.0          # running in-window totals
        self.bad = 0.0
        # (bucket_index, good, bad), ascending index.
        self._dq: Deque[List[float]] = deque()

    def _evict(self, idx: int) -> None:
        dq = self._dq
        floor = idx - self.buckets + 1
        while dq and dq[0][0] < floor:
            _, g, b = dq.popleft()
            self.good -= g
            self.bad -= b

    def observe(self, now: float, good: float, bad: float) -> None:
        self.observe_bucket(int(now / self.bucket_s), good, bad)

    def observe_bucket(self, idx: int, good: float, bad: float) -> None:
        """Feed a pre-bucketed count (``SLOTracker`` flushes whole buckets)."""
        dq = self._dq
        self.good += good
        self.bad += bad
        if dq and dq[-1][0] == idx:
            dq[-1][1] += good
            dq[-1][2] += bad
        else:
            dq.append([idx, good, bad])
            self._evict(idx)

    def totals(self, now: float) -> tuple:
        self._evict(int(now / self.bucket_s))
        return self.good, self.bad


class SLOTracker:
    """Live state of one ``SLOSpec``: windows, budget, alert latch."""

    __slots__ = ("spec", "fast", "slow", "good_total", "bad_total",
                 "firing", "fired_count", "cleared_count", "_last_now",
                 "_inv_bucket", "_cur_idx", "_cur_good", "_cur_bad")

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.fast = _RollingWindow(spec.fast_window_s)
        # The slow window shares the fast window's bucket granularity so
        # one flushed bucket feeds both (memory stays O(buckets), ~120 for
        # the default 600s/5s pair).
        self.slow = _RollingWindow(
            spec.slow_window_s,
            buckets=max(1, round(spec.slow_window_s / self.fast.bucket_s)))
        self.good_total = 0.0
        self.bad_total = 0.0
        self.firing = False
        self.fired_count = 0      # transitions into firing (not event count)
        self.cleared_count = 0
        self._last_now = 0.0
        self._inv_bucket = 1.0 / self.fast.bucket_s
        self._cur_idx: Optional[int] = None     # open (unflushed) bucket
        self._cur_good = 0.0
        self._cur_bad = 0.0

    def observe(self, now: float, good: float, bad: float) -> None:
        # Per-request cost is one multiply, one compare, and four adds:
        # events accumulate into the open fast bucket and flush into the
        # rolling windows only when it turns over — the window aggregates
        # cannot move before that, so neither can the alert latch, and
        # this sits on the router's per-request completion path.
        # ``snapshot()`` (and any burn query) flushes and re-judges on
        # demand, so the exported state is never stale.
        self.good_total += good
        self.bad_total += bad
        self._last_now = now
        idx = int(now * self._inv_bucket)
        if idx != self._cur_idx:
            self._flush()
            self._cur_idx = idx
            self._update_alert(now)
        self._cur_good += good
        self._cur_bad += bad

    def _flush(self) -> None:
        """Push the open bucket's counts into both rolling windows."""
        g, b = self._cur_good, self._cur_bad
        if g or b:
            idx = self._cur_idx
            self.fast.observe_bucket(idx, g, b)
            self.slow.observe_bucket(idx, g, b)
            self._cur_good = 0.0
            self._cur_bad = 0.0

    @staticmethod
    def _burn(good: float, bad: float, target: float) -> float:
        total = good + bad
        if total <= 0.0:
            return 0.0
        return (bad / total) / (1.0 - target)

    def burn_rates(self, now: Optional[float] = None) -> tuple:
        now = self._last_now if now is None else now
        self._flush()
        t = self.spec.target
        return (self._burn(*self.fast.totals(now), t),
                self._burn(*self.slow.totals(now), t))

    def _update_alert(self, now: float) -> None:
        # Bounded dead-band controller (CoherenceBus.adapt shape): fire
        # above fire_burn on BOTH windows, clear below fire_burn*clear_frac
        # on BOTH, hold state in the band between.
        fast_b, slow_b = self.burn_rates(now)
        spec = self.spec
        if not self.firing and fast_b >= spec.fire_burn and slow_b >= spec.fire_burn:
            self.firing = True
            self.fired_count += 1
        elif self.firing and fast_b <= spec.fire_burn * spec.clear_frac \
                and slow_b <= spec.fire_burn * spec.clear_frac:
            self.firing = False
            self.cleared_count += 1

    @property
    def budget_remaining(self) -> float:
        """Lifetime error budget left, in [0, 1] (1 = untouched)."""
        total = self.good_total + self.bad_total
        if total <= 0.0:
            return 1.0
        allowed = (1.0 - self.spec.target) * total
        if allowed <= 0.0:
            return 0.0 if self.bad_total else 1.0
        return max(0.0, min(1.0, 1.0 - self.bad_total / allowed))

    def snapshot(self) -> Dict[str, float]:
        self._update_alert(self._last_now)      # judge the latch on demand
        fast_b, slow_b = self.burn_rates()
        return {
            "target": self.spec.target,
            "good": self.good_total,
            "bad": self.bad_total,
            "burn_fast": fast_b,
            "burn_slow": slow_b,
            "firing": 1.0 if self.firing else 0.0,
            "fired_count": float(self.fired_count),
            "cleared_count": float(self.cleared_count),
            "budget_remaining": self.budget_remaining,
        }


class SLOBoard:
    """All configured SLOs, fed from the router's completion path.

    ``on_complete`` fans one finished request out to every tracker whose
    kind can judge it; ``record_failure`` marks an availability breach.
    Registered as the ``slo`` metrics source, so every tracker surfaces as
    ``slo.<name>.{firing,burn_fast,burn_slow,budget_remaining,...}``.
    """

    def __init__(self, specs: Sequence[SLOSpec] = ()):
        self.trackers: Dict[str, SLOTracker] = {
            s.name: SLOTracker(s) for s in specs}
        # Kind-split lists: on_complete runs per completed request, so the
        # per-call work is a plain loop over prebuilt lists, no dispatch.
        trs = self.trackers.values()
        self._latency = tuple(t for t in trs if t.spec.kind == "latency")
        self._hit_rate = tuple(t for t in trs if t.spec.kind == "hit_rate")
        self._avail = tuple(t for t in trs if t.spec.kind == "availability")

    def __bool__(self) -> bool:
        return bool(self.trackers)

    def on_complete(self, now: float, latency_s: float,
                    hits: int = 0, misses: int = 0) -> None:
        for tr in self._latency:
            if latency_s <= tr.spec.threshold_s:
                tr.observe(now, 1.0, 0.0)
            else:
                tr.observe(now, 0.0, 1.0)
        if hits or misses:
            g, b = float(hits), float(misses)
            for tr in self._hit_rate:
                tr.observe(now, g, b)
        for tr in self._avail:          # availability: completion = good
            tr.observe(now, 1.0, 0.0)

    def record_failure(self, now: float) -> None:
        for tr in self.trackers.values():
            if tr.spec.kind == "availability":
                tr.observe(now, 0.0, 1.0)

    def signal(self, name: str) -> SLOTracker:
        """Queryable live signal for one objective (admission control /
        the multi-tenant arc read this, not the flattened metrics)."""
        return self.trackers[name]

    def firing(self) -> List[str]:
        return [n for n, tr in self.trackers.items() if tr.firing]

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, tr in self.trackers.items():
            for k, v in tr.snapshot().items():
                out[f"{name}.{k}"] = v
        return out


def parse_slo_specs(text: str) -> List[SLOSpec]:
    """Parse the CLI grammar: ``p99_ms=50:hit_rate=0.8:avail=0.999``.

    ``p<NN>_ms=X`` declares a latency objective (target NN/100, threshold
    X milliseconds); ``hit_rate=Y`` and ``avail=Z`` declare the other two
    kinds with fraction targets.  Colon-separated; order free.
    """
    specs: List[SLOSpec] = []
    for part in filter(None, (p.strip() for p in text.split(":"))):
        key, _, val = part.partition("=")
        if not val:
            raise ValueError(f"bad SLO clause {part!r} (want key=value)")
        if key.startswith("p") and key.endswith("_ms"):
            pct = float(key[1:-3])
            if not 0.0 < pct < 100.0:
                raise ValueError(f"bad latency percentile in {part!r}")
            specs.append(SLOSpec(
                name=f"p{key[1:-3]}_latency", kind="latency",
                target=pct / 100.0, threshold_s=float(val) / 1000.0))
        elif key == "hit_rate":
            specs.append(SLOSpec(name="hit_rate", kind="hit_rate",
                                 target=float(val)))
        elif key in ("avail", "availability"):
            specs.append(SLOSpec(name="availability", kind="availability",
                                 target=float(val)))
        else:
            raise ValueError(f"unknown SLO clause {part!r}")
    return specs
