"""Critical-path attribution: where each request's wall time actually went.

``TraceBuffer`` records the causal span chain of every request (root
"request" span ← "dispatch" decision ← "transfer"/"promote"/"payload"
children).  This module reconstructs that chain per request and decomposes
the root span's wall time into **non-overlapping segments** that sum
exactly to the request's response time:

    queue                submit -> dispatch decision, nothing active
    dispatch             width of the dispatch-decision span(s) themselves
    promote              lower-tier hit swap-in (tier promotion toward HBM)
    transfer_peer        data diffusion over a peer NIC link
    transfer_persistent  cold read from the persistent store
    payload              measured byte movement (real-payload plane)
    service              post-dispatch time not covered by any data span
                         (compute + anything uninstrumented)

The decomposition is a boundary sweep: every instant of ``[submit,
finish]`` is attributed to exactly one segment — the highest-priority
*active* child span covering it (``dispatch > promote > transfer_peer >
transfer_persistent > payload``), else "queue" before the dispatch
decision and "service" after.  Overlapping transfers therefore do not
double-count (the paper's restore costs are concurrent by design), and the
per-request segments sum to the request's wall time **by construction** —
property-tested on random span soups in ``tests/test_obs_analyze.py``.

Determinism contract: attribution is a pure function of the parity span
chain plus the request-attributed promote/payload spans, all of which are
recorded identically by the looped and batched drains (and never sampled
out — see ``TraceBuffer`` sampling).  ``attribution_digest()`` canonical-
izes the per-request decomposition so ``bench_serve_batch`` can assert the
batched drain blames the exact same segments as the looped path, one level
up from ``parity_digest()`` (which checks span structure; this checks the
*time accounting* derived from it).  Like the decision-parity gate, the
assertion applies to zero-stale-conversion regimes (the seeded Zipf
streams the bench drives; ``stale_snapshot_drops`` is asserted zero).

Stdlib-only, no repro imports beyond the sibling trace module.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .registry import nearest_rank_index

__all__ = ["SEGMENTS", "CriticalPathAnalyzer", "decompose_request"]

# Attribution order: when several child spans cover the same instant, the
# earliest segment in this tuple wins.  Any fixed order keeps the partition
# property; this one ranks the *scheduling* work above the data movement it
# triggers, and peer diffusion above the persistent fallback it replaces.
SEGMENTS = ("queue", "dispatch", "promote", "transfer_peer",
            "transfer_persistent", "payload", "service")

# Child phases that carry wall-time intervals, mapped to their segment
# (transfer resolves per-span on its source detail).
_PRIORITY = {"dispatch": 0, "promote": 1, "transfer_peer": 2,
             "transfer_persistent": 3, "payload": 4}


def _segment_of(span: Dict[str, Any]) -> Optional[str]:
    phase = span["phase"]
    if phase == "dispatch":
        return "dispatch"
    if phase == "promote":
        return "promote"
    if phase == "payload":
        return "payload"
    if phase == "transfer":
        detail = span.get("detail") or []
        src = str(detail[0]) if detail else ""
        return "transfer_peer" if src.startswith("peer") else "transfer_persistent"
    return None      # unknown/structural phase: falls into "service"


def decompose_request(root: Dict[str, Any],
                      children: List[Dict[str, Any]]) -> Dict[str, float]:
    """Partition one request's ``[submit, finish]`` into ``SEGMENTS``.

    ``root`` is the request's "request" span; ``children`` its same-id
    spans.  Returns ``{segment: seconds}`` over all seven segments (zeros
    included); the values sum to ``root.end_s - root.start_s`` exactly (up
    to float associativity — the property test allows 1e-9 slack).
    """
    t0, t1 = root["start_s"], root["end_s"]
    out = {seg: 0.0 for seg in SEGMENTS}
    if t1 <= t0:
        return out

    # Classified child intervals, clipped to the root span.
    intervals: List[Tuple[float, float, int]] = []
    dispatch_t: Optional[float] = None
    for sp in children:
        seg = _segment_of(sp)
        if seg is None:
            continue
        a, b = max(t0, sp["start_s"]), min(t1, sp["end_s"])
        if seg == "dispatch":
            d = a if dispatch_t is None else min(dispatch_t, a)
            dispatch_t = d
        if b > a:
            intervals.append((a, b, _PRIORITY[seg]))
    # No dispatch decision recorded (ring wrap ate it): everything
    # uncovered counts as queue — visibly wrong-shaped rather than a
    # silently optimistic "service".
    td = dispatch_t if dispatch_t is not None else t1

    cuts = {t0, t1, min(t1, max(t0, td))}
    for a, b, _prio in intervals:
        cuts.add(a)
        cuts.add(b)
    edges = sorted(cuts)
    seg_names = ("dispatch", "promote", "transfer_peer",
                 "transfer_persistent", "payload")
    for a, b in zip(edges, edges[1:]):
        mid_active: Optional[int] = None
        for ia, ib, prio in intervals:
            if ia <= a and b <= ib and (mid_active is None or prio < mid_active):
                mid_active = prio
        if mid_active is not None:
            out[seg_names[mid_active]] += b - a
        elif b <= td:
            out["queue"] += b - a
        else:
            out["service"] += b - a
    return out


class CriticalPathAnalyzer:
    """Lazy blame-table view over a ``TraceBuffer``.

    Recomputes from the live trace at call time (analysis is an offline /
    snapshot-time concern — nothing here runs on the request hot path).
    Requests whose root span was overwritten by the ring are skipped.
    """

    def __init__(self, trace: Any):
        self.trace = trace

    # -- per-request ---------------------------------------------------------
    def breakdowns(self) -> Dict[int, Dict[str, float]]:
        """``{request_id: {segment: seconds, "wall": seconds}}``."""
        roots: Dict[int, Dict[str, Any]] = {}
        kids: Dict[int, List[Dict[str, Any]]] = {}
        for sp in self.trace.spans():
            rid = sp["request_id"]
            if rid < 0:
                continue
            if sp["phase"] == "request":
                roots[rid] = sp
            else:
                kids.setdefault(rid, []).append(sp)
        out: Dict[int, Dict[str, float]] = {}
        for rid, root in roots.items():
            br = decompose_request(root, kids.get(rid, []))
            br["wall"] = root["end_s"] - root["start_s"]
            out[rid] = br
        return out

    # -- aggregates ----------------------------------------------------------
    def blame_table(self) -> Dict[str, Dict[str, float]]:
        """Per-segment ``{mean, win_p99, frac}`` over the retained window.

        ``frac`` is the segment's share of total wall time (all fracs sum
        to 1 when any wall time exists); ``win_p99`` is the nearest-rank
        p99 of the per-request segment values — window-only, like every
        ``win_``-prefixed metric.
        """
        brs = self.breakdowns()
        table: Dict[str, Dict[str, float]] = {}
        total_wall = sum(b["wall"] for b in brs.values())
        n = len(brs)
        for seg in SEGMENTS:
            vals = sorted(b[seg] for b in brs.values())
            total = sum(vals)
            table[seg] = {
                "mean": total / n if n else 0.0,
                "win_p99": vals[nearest_rank_index(0.99, n)] if n else 0.0,
                "frac": total / total_wall if total_wall > 0 else 0.0,
            }
        return table

    def attribution_digest(self, ndigits: int = 9) -> Dict[int, Tuple]:
        """Canonical per-request attribution for looped-vs-batched asserts.

        Zero segments are dropped and values rounded so the digest compares
        the *accounting*, not float noise from summation order.
        """
        out: Dict[int, Tuple] = {}
        for rid, br in self.breakdowns().items():
            out[rid] = tuple(sorted(
                (seg, round(br[seg], ndigits))
                for seg in SEGMENTS if br[seg] > 0.0))
        return out

    def top_slowest(self, k: int = 5) -> List[Dict[str, Any]]:
        """The ``k`` slowest retained requests with their dominant segment."""
        roots = {sp["request_id"]: sp for sp in self.trace.spans()
                 if sp["request_id"] >= 0 and sp["phase"] == "request"}
        rows = []
        for rid, br in self.breakdowns().items():
            top_seg = max(SEGMENTS, key=lambda s: br[s])
            rows.append({
                "request_id": rid,
                "replica": roots[rid]["replica"] if rid in roots else "",
                "wall_s": br["wall"],
                "top_segment": top_seg,
                "top_segment_s": br[top_seg],
                "segments": {s: br[s] for s in SEGMENTS if br[s] > 0.0},
            })
        rows.sort(key=lambda r: (-r["wall_s"], r["request_id"]))
        return rows[:k]

    # -- exports -------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Registry-source view: ``crit.<segment>.{mean,win_p99,frac}``."""
        out: Dict[str, float] = {}
        table = self.blame_table()
        out["requests"] = float(len(self.breakdowns()))
        for seg in SEGMENTS:
            for stat, v in table[seg].items():
                out[f"crit.{seg}.{stat}"] = v
        return out

    def report_markdown(self, top_k: int = 5) -> str:
        """Human-readable blame table + top-K slowest requests."""
        brs = self.breakdowns()
        table = self.blame_table()
        lines = [
            "# Critical-path attribution",
            "",
            f"Requests analyzed (retained window): {len(brs)}",
            "",
            "| segment | mean (s) | win_p99 (s) | frac |",
            "|---|---:|---:|---:|",
        ]
        for seg in SEGMENTS:
            row = table[seg]
            lines.append(f"| {seg} | {row['mean']:.6f} | "
                         f"{row['win_p99']:.6f} | {row['frac']:.3f} |")
        lines += ["", f"## Top {top_k} slowest requests", "",
                  "| request | replica | wall (s) | dominant segment |",
                  "|---|---|---:|---|"]
        for r in self.top_slowest(top_k):
            lines.append(
                f"| {r['request_id']} | {r['replica']} | {r['wall_s']:.6f} "
                f"| {r['top_segment']} ({r['top_segment_s']:.6f}s) |")
        return "\n".join(lines) + "\n"
