"""Per-request trace spans: the causal story of one request, ring-buffered.

A span is one completed phase of a request's life — recorded *once, at its
end*, as a plain tuple (no open-span mutation on the hot path, no dict
allocation per request; at ~10k requests/sec the serving path has a
microsecond-scale budget per request for observability):

    (seq, request_id, name, phase, parent, start_s, end_s, replica, detail)

``request_id`` is the causal key: every span of one request carries it, so
the propagation chain the batch plane needs — router enqueue → dispatch
decision → tier-promotion replay → transfer flight → payload move →
completion — reassembles by id.  ``parent`` is the *phase name* of the span
this one is causally nested under ("request" ← "dispatch" ← "transfer"),
which keeps edges stable across drain modes (batched span seq ordering
differs from looped by design; names do not).  Batch-level spans that have
no single owning request (the drain scan itself, the coalesced promotion
replay, speculative flights) carry ``request_id = -1``.

Phases split into two classes:

  * **parity phases** (``PARITY_PHASES``): "request", "dispatch",
    "transfer" — one span per request event in *both* drain modes, with
    identical per-request hit/miss attribution.  ``parity_digest()``
    canonicalizes exactly these, so ``bench_serve_batch`` can assert the
    batched drain's span DAG ≡ the looped path's the same way it asserts
    assignment logs.
  * **structural phases**: "drain", "promote", "flight", "payload",
    "sample" — artifacts of *how* the work was executed (a batched drain
    coalesces promotions; speculative flights depend on queue timing).
    Excluded from the digest, included in every export.

Exports: ``to_jsonl()`` (one span dict per line) and ``to_chrome_trace()``
(Chrome ``traceEvents`` / Perfetto-loadable JSON: complete "X" events with
``tid`` = replica lane, so a batched drain renders as one visible wave
across the replica lanes).

**Sampling** (``sample=N``): batch-level structural spans — exactly the
``request_id = -1`` class: drain scans, coalesced promotion replays,
engine flights, batch payload moves, DES sample ticks — are recorded
1-in-N.  Request-attributed spans (any phase with ``request_id >= 0``,
which includes every parity phase and the per-request promote/payload
segments the critical-path analyzer consumes) are *always* recorded, so
``parity_digest()`` and ``obs.analyze`` attribution are byte-identical at
any sampling rate; only the how-was-it-executed volume thins out.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

__all__ = ["PARITY_PHASES", "TraceBuffer"]

PARITY_PHASES = ("request", "dispatch", "transfer")

# Record layout indices (kept as a tuple for hot-path cheapness).
_SEQ, _RID, _NAME, _PHASE, _PARENT, _T0, _T1, _REPLICA, _DETAIL = range(9)


class TraceBuffer:
    """Fixed-capacity ring of span records (oldest overwritten)."""

    __slots__ = ("maxlen", "sample", "_buf", "_seq", "_struct_seen",
                 "_sampled_out", "_t0_min")

    def __init__(self, maxlen: int = 65536, sample: int = 1):
        self.maxlen = int(maxlen)
        self.sample = max(1, int(sample))   # 1-in-N for structural rid=-1 spans
        # Bounded deque: C-level oldest-first eviction keeps record() free
        # of ring-index branches on the per-span hot path.
        self._buf: Deque[Tuple] = deque(maxlen=self.maxlen)
        self._seq = 0           # lifetime span count (ids are unique)
        self._struct_seen = 0   # structural spans offered (sampled or not)
        self._sampled_out = 0   # structural spans the sampler dropped
        # Earliest start ever *recorded* — the stable Chrome-trace origin.
        # The ring overwrites old spans, so deriving the origin from the
        # surviving minimum shifts every exported timestamp after a wrap;
        # this anchor never moves once set (tracked at record() time).
        self._t0_min = float("inf")

    def record(
        self,
        request_id: int,
        name: str,
        phase: str,
        start_s: float,
        end_s: float,
        replica: str = "",
        parent: str = "",
        detail: Tuple = (),
    ) -> int:
        """Append one completed span; returns its sequence id (-1: sampled out)."""
        if request_id < 0 and self.sample > 1:
            self._struct_seen += 1
            if self._struct_seen % self.sample:
                self._sampled_out += 1
                return -1
        seq = self._seq
        self._seq = seq + 1
        if start_s < self._t0_min:
            self._t0_min = start_s
        self._buf.append((seq, request_id, name, phase, parent, start_s,
                          end_s, replica, detail))
        return seq

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def total(self) -> int:
        """Lifetime spans recorded (>= len() once the ring wraps)."""
        return self._seq

    def spans(self) -> List[Dict[str, Any]]:
        """Materialize the retained window as dicts, in record order."""
        out = []
        for rec in sorted(self._buf):        # seq order == causal record order
            out.append({
                "seq": rec[_SEQ],
                "request_id": rec[_RID],
                "name": rec[_NAME],
                "phase": rec[_PHASE],
                "parent": rec[_PARENT],
                "start_s": rec[_T0],
                "end_s": rec[_T1],
                "replica": rec[_REPLICA],
                "detail": list(rec[_DETAIL]),
            })
        return out

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view: volume counters only."""
        return {"recorded": float(self._seq),
                "retained": float(len(self._buf)),
                "sampled_out": float(self._sampled_out)}

    # -- parity --------------------------------------------------------------
    def parity_digest(self) -> Dict[int, Tuple]:
        """Canonical per-request span DAG over the parity phases.

        Maps ``request_id`` to a sorted tuple of
        ``(phase, name, parent, replica, detail)`` — span counts, causal
        edges (parent links), and the per-request hit/miss attribution each
        span's detail carries.  Sequence ids and wall offsets are excluded:
        a batched drain interleaves record order differently by design, but
        the causal structure must be identical to the looped path's.

        Details are canonicalized here, not at record time: a dispatch
        span's per-object source map arrives in whichever insertion order
        its drain mode produced, and sorting it on the hot path would tax
        every request to make this snapshot-time comparison cheaper.
        """
        out: Dict[int, List[Tuple]] = {}
        for rec in self._buf:
            if rec[_RID] < 0 or rec[_PHASE] not in PARITY_PHASES:
                continue
            detail = rec[_DETAIL]
            if rec[_PHASE] == "dispatch" and len(detail) == 3 \
                    and isinstance(detail[2], tuple):
                detail = (detail[0], detail[1], tuple(sorted(detail[2])))
            out.setdefault(rec[_RID], []).append(
                (rec[_PHASE], rec[_NAME], rec[_PARENT], rec[_REPLICA],
                 detail))
        return {rid: tuple(sorted(entries)) for rid, entries in out.items()}

    # -- exports -------------------------------------------------------------
    def to_jsonl(self, path: str) -> int:
        """One span dict per line; returns the number written."""
        spans = self.spans()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s) + "\n")
        return len(spans)

    def to_chrome_trace(self, time_origin_s: Optional[float] = None) -> Dict[str, Any]:
        """Chrome ``chrome://tracing`` / Perfetto document.

        Complete ("X") events on ``pid`` = phase class, ``tid`` = replica
        lane (unattributed spans ride a lane named after their phase).
        Timestamps are microseconds relative to the earliest span *ever
        recorded* (not the earliest surviving one — after a ring wrap those
        differ, and an origin derived from survivors would shift every
        timestamp relative to an earlier export of the same run), so
        virtual-time traces load at t=0 and repeated exports stay aligned.
        """
        events = []
        recs = sorted(self._buf)
        if recs and time_origin_s is None:
            time_origin_s = self._t0_min
        for rec in recs:
            dur_us = max(0.0, (rec[_T1] - rec[_T0]) * 1e6)
            events.append({
                "name": rec[_NAME],
                "cat": rec[_PHASE],
                "ph": "X",
                "ts": (rec[_T0] - (time_origin_s or 0.0)) * 1e6,
                "dur": dur_us,
                "pid": 1,
                "tid": rec[_REPLICA] or rec[_PHASE],
                "args": {
                    "request_id": rec[_RID],
                    "parent": rec[_PARENT],
                    "detail": list(rec[_DETAIL]),
                },
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> int:
        doc = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])
