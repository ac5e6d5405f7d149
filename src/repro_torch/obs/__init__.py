"""Unified observability plane: metrics, traces, perf, analysis, SLOs.

One ``Observability`` object per serving process, threaded through
``DiffusionServer(obs=...)`` / ``CacheAffinityRouter(obs=...)`` /
``Simulator(obs=...)``:

  * ``obs.registry`` — the metrics namespace.  Every ``*Stats`` island is
    adopted as a ``snapshot()`` source under its plane prefix
    (``router.hit_rate``, ``transfer.bytes.peer``, ``dispatch.decisions``,
    ``serve.prefix_hits`` …); nothing is copied or double-counted.
  * ``obs.trace``    — the per-request span ring (``obs.trace``), exportable
    as JSONL and Chrome-trace/Perfetto JSON.  ``trace_sample=N`` thins the
    batch-level structural spans 1-in-N; request-attributed spans are
    always recorded (parity and attribution are sampling-invariant).
  * ``obs.perf``     — the live reducer for the paper's evaluation metrics
    (``perf.performance_index``, ``perf.speedup``, per-interval throughput
    and utilization rows), name-shared with the DES projection in
    ``obs.perf.sim_perf_rows`` so sim-vs-live curves overlay.
  * ``obs.analyze``  — critical-path attribution over the trace ring:
    per-request wall time decomposed into non-overlapping segments (queue /
    dispatch / promote / transfer_peer / transfer_persistent / payload /
    service), surfaced as ``analyze.crit.*`` and a markdown blame report.
  * ``obs.slo``      — declarative SLOs (latency / hit-rate / availability)
    with error budgets and multi-window burn-rate alerts, surfaced as
    ``slo.*``; ``None`` when no specs were configured (the router's
    completion hook stays a single ``is not None`` test).

**Overhead contract**: obs is opt-in and ``obs=None`` (the default
everywhere) is a no-op stub path — consumers hold ``trace = obs.trace if
obs else None`` and guard each hook with one ``is not None`` test, so the
disabled path allocates no span objects and performs no metric work
(asserted by ``tests/test_obs.py``); the enabled path must cost <= 5% of
``bench_serve_batch`` requests/sec (asserted as an ERROR row, measured
overhead recorded in ``BENCH_serve.json``).  Analysis is snapshot-time
only — ``CriticalPathAnalyzer`` reads the ring lazily and adds nothing to
the request path.

``collect_all()`` is the one entry point that merges every adopted island;
``write_snapshot(dir)`` dumps ``metrics.json`` (flat metrics + per-interval
perf rows + the analysis blame table + SLO state, schema-versioned) plus
``trace.jsonl``, ``trace_chrome.json``, and ``crit_path.md`` — the
artifacts ``repro.launch.serve --metrics-dir`` emits and CI uploads next
to the ``BENCH_*.json`` history.
"""

from __future__ import annotations

import json
import os
from datetime import datetime, timezone
from typing import Dict, Optional, Sequence

from .analyze import SEGMENTS, CriticalPathAnalyzer, decompose_request
from .perf import PerfMeter, sim_perf_rows, sim_perf_summary
from .registry import (SCHEMA_VERSION, Counter, Gauge, MetricsRegistry,
                       P2Quantile, WindowedHistogram, nearest_rank_index,
                       stats_snapshot)
from .slo import SLOBoard, SLOSpec, SLOTracker, parse_slo_specs
from .trace import PARITY_PHASES, TraceBuffer

__all__ = [
    "Counter",
    "CriticalPathAnalyzer",
    "Gauge",
    "MetricsRegistry",
    "Observability",
    "P2Quantile",
    "PARITY_PHASES",
    "PerfMeter",
    "SCHEMA_VERSION",
    "SEGMENTS",
    "SLOBoard",
    "SLOSpec",
    "SLOTracker",
    "TraceBuffer",
    "WindowedHistogram",
    "decompose_request",
    "nearest_rank_index",
    "parse_slo_specs",
    "sim_perf_rows",
    "sim_perf_summary",
    "stats_snapshot",
]


class Observability:
    """Registry + tracer + perf reducer + analyzer (+ SLO board), wired."""

    def __init__(
        self,
        trace_maxlen: int = 65536,
        perf_interval_s: float = 1.0,
        baseline_service_s: Optional[float] = None,
        trace_sample: int = 1,
        slo_specs: Sequence[SLOSpec] = (),
    ):
        self.registry = MetricsRegistry()
        self.trace = TraceBuffer(maxlen=trace_maxlen, sample=trace_sample)
        self.perf = PerfMeter(interval_s=perf_interval_s,
                              baseline_service_s=baseline_service_s)
        self.analyze = CriticalPathAnalyzer(self.trace)
        self.registry.register_source("perf", self.perf)
        self.registry.register_source("trace", self.trace)
        self.registry.register_source("analyze", self.analyze)
        # None (not an empty board) when unconfigured so consumers keep the
        # one-guard stub pattern: `slo = obs.slo if obs is not None else None`
        # costs nothing per request when no objectives are declared.
        self.slo: Optional[SLOBoard] = None
        if slo_specs:
            self.slo = SLOBoard(slo_specs)
            self.registry.register_source("slo", self.slo)

    def collect_all(self) -> Dict[str, float]:
        """Every adopted island + instrument, one flat dotted namespace."""
        return self.registry.collect()

    def write_snapshot(self, out_dir: str, tag: str = "") -> Dict[str, str]:
        """Dump metrics + trace + analysis artifacts into ``out_dir``."""
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        metrics_path = os.path.join(out_dir, f"metrics{suffix}.json")
        jsonl_path = os.path.join(out_dir, f"trace{suffix}.jsonl")
        chrome_path = os.path.join(out_dir, f"trace_chrome{suffix}.json")
        crit_path = os.path.join(out_dir, f"crit_path{suffix}.md")
        doc = {
            "schema_version": SCHEMA_VERSION,
            "ts": datetime.now(timezone.utc).isoformat(timespec="seconds"),
            "metrics": self.collect_all(),
            "perf_intervals": self.perf.interval_rows(),
            "analysis": {
                "blame": self.analyze.blame_table(),
                "top_slowest": self.analyze.top_slowest(5),
            },
        }
        if self.slo is not None:
            doc["slo"] = {"state": self.slo.snapshot(),
                          "firing": self.slo.firing()}
        with open(metrics_path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        self.trace.to_jsonl(jsonl_path)
        self.trace.write_chrome_trace(chrome_path)
        with open(crit_path, "w") as f:
            f.write(self.analyze.report_markdown())
        return {"metrics": metrics_path, "trace_jsonl": jsonl_path,
                "trace_chrome": chrome_path, "crit_path": crit_path}
