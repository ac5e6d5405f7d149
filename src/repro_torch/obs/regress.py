"""Bench regression sentinel: flag perf drops the BENCH history can prove.

Every benchmark appends a timestamped entry to its ``BENCH_*.json``
``history`` (see ``benchmarks/bench_util.append_history``).  This module
turns that trajectory into a CI gate: for each **declared** metric it
builds a robust baseline — median and MAD (median absolute deviation) over
the last ``last_k`` *config-matched* prior entries — and flags the latest
run only when it falls beyond a noise-scaled threshold on the metric's bad
side:

    threshold = max(abs_floor, rel_floor * |median|, mad_mult * 1.4826 * MAD)
    regression (higher-is-better):  latest < median - threshold
    regression (lower-is-better):   latest > median + threshold

Design points the real histories forced:

  * **Config matching.** One file's history mixes workload sizes (e.g.
    ``requests=300`` vs ``3000`` runs of the serve bench) whose absolute
    rates differ by design; baselines compare like with like by matching
    the latest entry's ``config`` dict exactly, falling back (with a note)
    to all entries carrying the metric only when matches are too few.
  * **Robustness over recency.** Median/MAD ignores a single outlier run
    (a noisy CI machine) where mean/stddev would chase it; the relative
    floor keeps near-zero-MAD histories (identical repeated runs) from
    flagging on measurement jitter.
  * **One-sided.** Improvements never flag, however large.
  * **Schema tolerance.** Entries predating the ``schema`` stamp (or
    carrying ``migrated: true``) are plain dicts with metric keys — they
    participate normally; entries *missing* a metric are skipped, and a
    document whose ``schema`` is newer than this module understands is
    skipped entirely with a note (never a false alarm on format drift).

``main()`` scans the given BENCH files, writes a markdown report, and
returns a process exit code: 0 quiet, 1 regressions found — wired into CI
via ``python -m benchmarks.run --check-regressions``.

Stdlib-only; no repro imports beyond the sibling registry (schema const).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .registry import SCHEMA_VERSION

__all__ = ["DECLARED_METRICS", "MetricSpec", "RegressionReport",
           "check_file", "main", "render_markdown"]


@dataclass(frozen=True)
class MetricSpec:
    """One watched metric inside a BENCH document's history entries.

    ``key`` is a dotted path into the entry (``measured_gbps.hbm->dram``
    reads the nested per-edge dict the payload bench writes).
    """

    key: str
    higher_is_better: bool = True
    rel_floor: float = 0.10      # min relative drop worth flagging
    abs_floor: float = 0.0       # min absolute drop (near-zero medians make
                                 # the relative floor meaningless)
    mad_mult: float = 3.0        # noise scale: 3 robust sigmas
    min_history: int = 3         # baseline entries required to judge
    last_k: int = 8              # baseline window (most recent prior runs)


#: The watched surface, by BENCH file basename.  Adding a metric here is
#: the whole act of putting it under sentinel protection.
DECLARED_METRICS: Dict[str, Tuple[MetricSpec, ...]] = {
    "BENCH_serve.json": (
        MetricSpec("batched_rps"),
        # The looped reference path runs at a smaller request count, so its
        # rate is dominated by machine weather; the batched headline above
        # keeps the tight floor.
        MetricSpec("looped_rps", rel_floor=0.30),
        MetricSpec("measured_swapin_gbps"),
        # Observability tax: lower is better, and the healthy value sits
        # near zero (sometimes below — measurement jitter), so only an
        # absolute drift matters; the bench's significance-tested 0.95x
        # gate is the hard per-run enforcement.
        MetricSpec("obs_overhead_pct", higher_is_better=False,
                   rel_floor=0.50, abs_floor=15.0),
    ),
    "BENCH_dispatch.json": (
        MetricSpec("vectorized_decisions_per_s"),
        MetricSpec("reference_decisions_per_s"),
    ),
    "BENCH_payload.json": (
        MetricSpec("measured_gbps.hbm->dram"),
        MetricSpec("measured_gbps.disk->hbm"),
    ),
    "BENCH_admission.json": (
        # Wall-clock throughput of the overload storm and the idle-parity
        # pump; the fairness invariants themselves are hard per-run raises
        # in the bench, so only the perf trajectory needs the sentinel.
        MetricSpec("overload.rps", rel_floor=0.30),
        MetricSpec("idle_parity.rps", rel_floor=0.30),
    ),
}


def _lookup(entry: Dict[str, Any], dotted: str) -> Optional[float]:
    node: Any = entry
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    if isinstance(node, bool) or not isinstance(node, (int, float)):
        return None
    return float(node)


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _mad_sigma(xs: Sequence[float], med: float) -> float:
    """Robust sigma estimate: 1.4826 * median(|x - med|)."""
    if not xs:
        return 0.0
    return 1.4826 * _median([abs(x - med) for x in xs])


@dataclass
class Finding:
    """Judgement for one (file, metric) pair."""

    file: str
    metric: str
    status: str                  # "ok" | "regression" | "skipped"
    latest: Optional[float] = None
    baseline: Optional[float] = None
    threshold: Optional[float] = None
    n_baseline: int = 0
    note: str = ""

    @property
    def delta_pct(self) -> Optional[float]:
        if self.latest is None or not self.baseline:
            return None
        return 100.0 * (self.latest - self.baseline) / abs(self.baseline)


@dataclass
class RegressionReport:
    findings: List[Finding]

    @property
    def regressions(self) -> List[Finding]:
        return [f for f in self.findings if f.status == "regression"]

    @property
    def exit_code(self) -> int:
        return 1 if self.regressions else 0


def check_file(path: str,
               specs: Optional[Sequence[MetricSpec]] = None) -> List[Finding]:
    """Judge every declared metric of one BENCH document."""
    base = os.path.basename(path)
    if specs is None:
        specs = DECLARED_METRICS.get(base, ())
    if not specs:
        return [Finding(base, "*", "skipped", note="no declared metrics")]
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [Finding(base, "*", "skipped", note=f"unreadable: {e}")]
    schema = doc.get("schema", 0)
    if isinstance(schema, (int, float)) and schema > SCHEMA_VERSION:
        return [Finding(base, "*", "skipped",
                        note=f"schema {schema} newer than supported "
                             f"{SCHEMA_VERSION}")]
    history = doc.get("history") or []
    if not history:
        return [Finding(base, "*", "skipped", note="no history")]
    latest = history[-1]
    prior = history[:-1]

    out: List[Finding] = []
    for spec in specs:
        value = _lookup(latest, spec.key)
        if value is None:
            out.append(Finding(base, spec.key, "skipped",
                               note="metric absent from latest entry"))
            continue
        # Baseline pool: config-matched prior entries carrying the metric;
        # fall back to all carriers when matches are too few (noted, so a
        # quiet verdict on mixed configs is auditable).
        cfg = latest.get("config")
        matched = [e for e in prior
                   if e.get("config") == cfg and _lookup(e, spec.key) is not None]
        note = ""
        pool = matched
        if len(matched) < spec.min_history:
            pool = [e for e in prior if _lookup(e, spec.key) is not None]
            if len(pool) > len(matched):
                note = "config-mismatched baseline (few matching runs)"
        values = [_lookup(e, spec.key) for e in pool[-spec.last_k:]]
        if len(values) < spec.min_history:
            out.append(Finding(base, spec.key, "skipped", latest=value,
                               n_baseline=len(values),
                               note=f"history too short "
                                    f"({len(values)} < {spec.min_history})"))
            continue
        med = _median(values)
        threshold = max(spec.abs_floor, spec.rel_floor * abs(med),
                        spec.mad_mult * _mad_sigma(values, med))
        if spec.higher_is_better:
            bad = value < med - threshold
        else:
            bad = value > med + threshold
        out.append(Finding(
            base, spec.key, "regression" if bad else "ok",
            latest=value, baseline=med, threshold=threshold,
            n_baseline=len(values), note=note))
    return out


def render_markdown(report: RegressionReport) -> str:
    lines = ["# Bench regression sentinel", ""]
    regs = report.regressions
    if regs:
        lines.append(f"**{len(regs)} regression(s) flagged.**")
    else:
        lines.append("No regressions flagged.")
    lines += ["", "| file | metric | status | latest | baseline (median) "
              "| delta | note |", "|---|---|---|---:|---:|---:|---|"]

    def fmt(v: Optional[float]) -> str:
        return f"{v:.4g}" if v is not None else "-"

    order = {"regression": 0, "ok": 1, "skipped": 2}
    for f in sorted(report.findings,
                    key=lambda f: (order[f.status], f.file, f.metric)):
        d = f.delta_pct
        delta = f"{d:+.1f}%" if d is not None else "-"
        lines.append(f"| {f.file} | {f.metric} | {f.status} | "
                     f"{fmt(f.latest)} | {fmt(f.baseline)} | {delta} "
                     f"| {f.note} |")
    return "\n".join(lines) + "\n"


def check_paths(paths: Sequence[str]) -> RegressionReport:
    findings: List[Finding] = []
    for p in paths:
        findings.extend(check_file(p))
    return RegressionReport(findings)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``python -m repro.obs.regress [--report OUT.md] BENCH...``."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="BENCH_*.json files (default: declared set in cwd)")
    ap.add_argument("--report", default="",
                    help="write the markdown report here too")
    ns = ap.parse_args(argv)
    paths = list(ns.paths) or [p for p in DECLARED_METRICS
                               if os.path.exists(p)]
    report = check_paths(paths)
    md = render_markdown(report)
    print(md, end="")
    if ns.report:
        with open(ns.report, "w") as f:
            f.write(md)
    return report.exit_code


if __name__ == "__main__":
    raise SystemExit(main())
