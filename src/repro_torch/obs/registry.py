"""Metrics registry: one namespace over every ``*Stats`` island.

The runtime accumulates telemetry in nine disconnected dataclasses
(``RouterStats``, ``TransferStats``, ``CoherenceStats``, ``PrefetchStats``,
``MirrorStats``, ``WarmStartStats``, ``SchedulerStats``, ``CacheStats``,
``ServeStats``) plus per-store counters on ``TieredStore``.  Each of those
stays the *owner* of its numbers — the registry never copies or
double-counts; it adopts each island as a **source** through one shared
protocol:

    source.snapshot() -> Dict[str, float]     # relative dotted names

and prefixes the source's metrics with its plane name at collect time, so
``TransferStats.bytes_from_peers`` surfaces as ``transfer.bytes.peer`` and
``RouterStats.hit_rate`` as ``router.hit_rate`` in one flat, stable
namespace.  ``stats_snapshot`` is the generic implementation the dataclass
islands share: numeric fields, numeric-valued dict fields (flattened one
level), declared properties, and a per-class rename map for names whose
wire form differs from the attribute (``bytes_from_peers`` ->
``bytes.peer``).

On top of adopted sources the registry carries its own instruments —
``Counter``, ``Gauge``, and ``WindowedHistogram`` (ring-buffered samples
with streaming lifetime sum/min/max plus P² lifetime quantile estimates,
so the mean and ``est_p50``/``est_p99`` survive window wraps while
``win_p50``/``win_p99`` stay exact-but-window-only) — for values no island
owns, e.g. the live DES sample gauges.

Everything here is dependency-free (stdlib only): the runtime, core, and
diffusion planes import helpers from this module without cycles.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "P2Quantile",
    "SCHEMA_VERSION",
    "WindowedHistogram",
    "nearest_rank_index",
    "stats_snapshot",
]

# Version of the exported metrics/trace/BENCH document schema.  Bump when a
# metric is renamed or an export layout changes so downstream consumers of
# the JSON artifacts can dispatch on it.
SCHEMA_VERSION = 1


def nearest_rank_index(pct: float, n: int) -> int:
    """Index of the nearest-rank ``pct`` percentile in a sorted n-sample.

    The standard definition: rank ``ceil(pct * n)`` (1-based), clamped.
    ``int(pct * n)`` — the formula this replaces — is one too high whenever
    ``pct * n`` lands on an integer (p50 of 2 samples picked the *max*),
    which is exactly the small-sample regime the DES's peak-throughput
    summary runs in.  ``pct`` is a fraction in (0, 1].
    """
    if n <= 0:
        raise ValueError("empty sample has no percentile")
    return min(n - 1, max(0, math.ceil(pct * n) - 1))


def stats_snapshot(
    stats: Any,
    props: Tuple[str, ...] = (),
    rename: Optional[Dict[str, str]] = None,
) -> Dict[str, float]:
    """Generic ``snapshot()`` body for a ``*Stats`` dataclass.

    Emits every int/float field, flattens numeric-valued dict fields one
    level (``hits_by_tier`` -> ``hits_by_tier.hbm``), appends the declared
    ``props`` (derived values like ``hit_rate``), and applies ``rename`` to
    map attribute names onto their stable wire names.  Non-numeric fields
    (lists, objects) are skipped — islands with structured members override
    or extend the result themselves.
    """
    rename = rename or {}
    out: Dict[str, float] = {}

    def put(name: str, value: Any) -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        out[rename.get(name, name)] = float(value)

    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if isinstance(v, dict):
            for k, sub in sorted(v.items()):
                put(f"{f.name}.{k}", sub)
        else:
            put(f.name, v)
    for p in props:
        put(p, getattr(stats, p))
    return out


class P2Quantile:
    """Streaming quantile estimate: the P² piecewise-parabolic algorithm.

    Jain & Chlamtac (1985): five markers track the min, max, target
    quantile, and its two flanking mid-quantiles; each observation shifts
    marker *positions* by one and repairs marker *heights* with a
    piecewise-parabolic (falling back to linear) interpolation.  O(1) time
    and O(1) memory per observation — the estimate covers the *lifetime*
    stream, so it survives the ring wraps that make ``win_p50``/``win_p99``
    window-only.  Exact until five samples have arrived; approximate (and
    for smooth distributions, tight — pinned by test against exact
    percentiles on seeded streams) afterwards.
    """

    __slots__ = ("p", "count", "_q", "_n", "_np")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1): {p}")
        self.p = float(p)
        self.count = 0
        self._q: List[float] = []      # marker heights
        self._n: List[float] = []      # marker positions (0-based)
        self._np: List[float] = []     # desired marker positions

    def observe(self, x: float) -> None:
        self.count += 1
        q = self._q
        if self.count <= 5:
            q.append(x)
            q.sort()
            if self.count == 5:
                p = self.p
                self._n = [0.0, 1.0, 2.0, 3.0, 4.0]
                self._np = [0.0, 2.0 * p, 4.0 * p, 2.0 + 2.0 * p, 4.0]
            return
        n, np_ = self._n, self._np
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 3
            for i in range(1, 4):
                if x < q[i]:
                    k = i - 1
                    break
        for i in range(k + 1, 5):
            n[i] += 1.0
        p = self.p
        np_[1] += p / 2.0
        np_[2] += p
        np_[3] += (1.0 + p) / 2.0
        np_[4] += 1.0
        for i in (1, 2, 3):
            d = np_[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or \
               (d <= -1.0 and n[i - 1] - n[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                # piecewise-parabolic (P²) height update …
                qp = q[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1]))
                if not q[i - 1] < qp < q[i + 1]:
                    # … unless it would leave the bracket: linear repair
                    j = i + (1 if d > 0 else -1)
                    qp = q[i] + d * (q[j] - q[i]) / (n[j] - n[i])
                q[i] = qp
                n[i] += d

    @property
    def value(self) -> float:
        """Current estimate (exact nearest-rank below five samples)."""
        if self.count == 0:
            return 0.0
        if self.count <= 5:      # still exact: markers not yet adjusted
            return self._q[nearest_rank_index(self.p, len(self._q))]
        return self._q[2]


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class WindowedHistogram:
    """Ring buffer of samples + streaming lifetime aggregates.

    Percentiles are **window-only** (exact over the most recent ``maxlen``
    samples — the name says so: ``window_percentile``); ``mean``/``min``/
    ``max``/``sum``/``count`` are lifetime-true streaming values that
    survive ring wraps.
    """

    __slots__ = ("name", "maxlen", "_buf", "_next", "count", "sum",
                 "lifetime_min", "lifetime_max", "_p2_50", "_p2_99")

    def __init__(self, name: str, maxlen: int = 4096):
        self.name = name
        self.maxlen = int(maxlen)
        self._buf: List[float] = []
        self._next = 0
        self.count = 0
        self.sum = 0.0
        self.lifetime_min = math.inf
        self.lifetime_max = -math.inf
        # Lifetime-stream P² estimators complement the exact-but-window-only
        # sorted percentiles.
        self._p2_50 = P2Quantile(0.50)
        self._p2_99 = P2Quantile(0.99)

    def observe(self, x: float) -> None:
        self.count += 1
        self.sum += x
        if x < self.lifetime_min:
            self.lifetime_min = x
        if x > self.lifetime_max:
            self.lifetime_max = x
        self._p2_50.observe(x)
        self._p2_99.observe(x)
        if len(self._buf) < self.maxlen:
            self._buf.append(x)
        else:
            self._buf[self._next] = x
            self._next = (self._next + 1) % self.maxlen

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[float]:
        return iter(self._buf)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def window_percentile(self, pct: float) -> float:
        """Exact percentile over the retained window only (NOT lifetime)."""
        if not self._buf:
            return 0.0
        xs = sorted(self._buf)
        return xs[nearest_rank_index(pct / 100.0, len(xs))]

    def snapshot(self) -> Dict[str, float]:
        out = {
            "count": float(self.count),
            "sum": self.sum,
            "mean": self.mean,
            "window": float(len(self._buf)),
            "win_p50": self.window_percentile(50.0),
            "win_p99": self.window_percentile(99.0),
            "est_p50": self._p2_50.value,
            "est_p99": self._p2_99.value,
        }
        if self.count:
            out["min"] = self.lifetime_min
            out["max"] = self.lifetime_max
        return out


class MetricsRegistry:
    """Named instruments + adopted ``snapshot()`` sources, one namespace.

    ``collect()`` returns a flat ``{dotted_name: value}`` dict: every
    registered source's snapshot under its prefix, then every owned
    instrument under its own name.  A prefix can be re-registered (the
    latest source wins) so a rebuilt plane replaces its predecessor instead
    of double-reporting.
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, WindowedHistogram] = {}
        # prefix -> source with .snapshot(); insertion-ordered for stable
        # collect output.
        self._sources: Dict[str, Any] = {}

    # -- instruments ---------------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, maxlen: int = 4096) -> WindowedHistogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = WindowedHistogram(name, maxlen)
        return h

    # -- sources -------------------------------------------------------------
    def register_source(self, prefix: str, source: Any) -> None:
        """Adopt a ``*Stats`` island (anything with ``snapshot() -> dict``).

        The island stays authoritative; the registry reads it lazily at
        ``collect()`` so nothing is double-counted.
        """
        if not callable(getattr(source, "snapshot", None)):
            raise TypeError(
                f"source for {prefix!r} has no snapshot() method: {source!r}")
        self._sources[prefix] = source

    def register_callable(self, prefix: str, fn: Callable[[], Dict[str, float]]) -> None:
        """Adopt a plain callable producing a snapshot dict (aggregates)."""
        self._sources[prefix] = _CallableSource(fn)

    def sources(self) -> List[str]:
        return list(self._sources)

    # -- collection ----------------------------------------------------------
    def collect(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for prefix, source in self._sources.items():
            for k, v in source.snapshot().items():
                out[f"{prefix}.{k}"] = v
        for c in self._counters.values():
            out[c.name] = c.value
        for g in self._gauges.values():
            out[g.name] = g.value
        for h in self._histograms.values():
            for k, v in h.snapshot().items():
                out[f"{h.name}.{k}"] = v
        return out


class _CallableSource:
    __slots__ = ("_fn",)

    def __init__(self, fn: Callable[[], Dict[str, float]]):
        self._fn = fn

    def snapshot(self) -> Dict[str, float]:
        return self._fn()
