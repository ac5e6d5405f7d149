"""Payload plane: the actual KV bytes behind the tier-stack bookkeeping.

``TieredStore`` / ``TransferEngine`` account object *names and sizes* — the
modeled plane the DES and the router's decision path run on.  This module
adds the physical plane underneath: a ``PayloadBackend`` attached to a store
receives a callback for every placement change (admit / promote / demote /
drop) and moves the real tensors between physical homes:

  * ``hbm``  — accelerator device arrays (``jax.device_put``; every timed
    edge is closed with ``jax.block_until_ready`` so async dispatch cannot
    fake bandwidth);
  * ``dram`` — host numpy (``jax.device_get`` on the way down);
  * ``disk`` — chunked spill files written through the checkpoint plane's
    dtype-safe byte view (``checkpoint.checkpointer.to_raw_bytes``), with a
    per-chunk sha256 verified on every read back.

Three backends share the interface:

  * ``NullPayload`` — the modeled default: every notification is a tolerated
    placeholder (counted, never an error).  Attaching no backend at all is
    equivalent; decisions are identical by construction.
  * ``FakePayload`` — deterministic in-memory tiers for tier-1 tests: moves
    copy host bytes and record *modeled* seconds (size / roofline), so
    measured rows are reproducible without an accelerator.
  * ``RealPayload`` — the physical homes above, timed with
    ``time.perf_counter``.  Not in this package yet: its homes are device
    arrays, and the serving launcher never selects ``payload="real"``
    (``DiffusionServer`` raises ``NotImplementedError`` for it).

The decision plane never reads the payload plane: a backend with no bytes
registered for an object (a placeholder — e.g. the DES, or a peer fetch of
an object whose payload was never put) degrades to bookkeeping-only, so the
``payload="modeled"`` and ``payload="real"`` engine modes make bit-identical
promote/demote/fetch decisions (asserted in ``tests/test_payload.py``).

``MeasuredBandwidth`` accumulates bytes/seconds per (src tier, dst tier)
edge; ``check_roofline`` flags any edge whose *aggregate* measured bandwidth
exceeds ``factor``x the roofline of its slower endpoint — measured transfers
can be slower than roofline (overheads), but 10x faster is always a timing
bug (an unblocked async copy), which is exactly what the
``payload_roundtrip`` smoke row turns into an ERROR.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "MeasuredBandwidth",
    "PayloadBackend",
    "NullPayload",
    "FakePayload",
]

# Tier names with a physical roofline; edges touching anything else (engine
# source labels like "persistent"/"peer" ride modeled links, and in-process
# memcpy legitimately beats a modeled GPFS wire) are exempt from the
# impossibly-fast check.
_ROOFLINE_TIERS = ("hbm", "dram", "disk")


class MeasuredBandwidth:
    """Per-(src, dst) accumulator of measured byte movement."""

    def __init__(self) -> None:
        # (src, dst) -> [bytes, seconds, moves]
        self._acc: Dict[Tuple[str, str], List[float]] = {}

    def record(self, src: str, dst: str, nbytes: float, seconds: float) -> None:
        ent = self._acc.setdefault((src, dst), [0.0, 0.0, 0.0])
        ent[0] += float(nbytes)
        ent[1] += max(0.0, float(seconds))
        ent[2] += 1.0

    def bandwidth(self, src: str, dst: str) -> float:
        """Aggregate bytes/s over every recorded move on the edge (0 if none)."""
        ent = self._acc.get((src, dst))
        if ent is None or ent[1] <= 0.0:
            return 0.0
        return ent[0] / ent[1]

    @property
    def total_bytes(self) -> float:
        return sum(ent[0] for ent in self._acc.values())

    def rows(self) -> List[Dict[str, float]]:
        """Stable-sorted export rows for BENCH_* history entries."""
        out = []
        for (src, dst) in sorted(self._acc):
            b, s, n = self._acc[(src, dst)]
            out.append({
                "src": src, "dst": dst, "bytes": b, "seconds": s,
                "moves": int(n), "bytes_per_s": b / s if s > 0 else 0.0,
            })
        return out

    def merge(self, other: "MeasuredBandwidth") -> None:
        for (src, dst), (b, s, n) in other._acc.items():
            ent = self._acc.setdefault((src, dst), [0.0, 0.0, 0.0])
            ent[0] += b
            ent[1] += s
            ent[2] += n

    def check_roofline(self, factor: float = 10.0) -> List[str]:
        """Edges measured impossibly fast: aggregate bandwidth more than
        ``factor``x the roofline of the edge's slower physical endpoint.
        Returns violation strings (empty = sane); slower-than-roofline is
        normal and never flagged."""
        from .tiers import roofline_tier_bw  # deferred: avoids import cycle
        bad = []
        for (src, dst) in sorted(self._acc):
            if src not in _ROOFLINE_TIERS or dst not in _ROOFLINE_TIERS:
                continue
            roof = min(roofline_tier_bw(src), roofline_tier_bw(dst))
            bw = self.bandwidth(src, dst)
            if bw > factor * roof:
                bad.append(
                    f"{src}->{dst}: measured {bw / 1e9:.1f} GB/s exceeds "
                    f"{factor:g}x roofline {roof / 1e9:.1f} GB/s "
                    f"(unblocked async copy?)")
        return bad


# -- structure helpers (dict/list/tuple trees of arrays, no jax needed) -------

def _tree_leaves(value: Any, out: List[Any]) -> Any:
    """Flatten into ``out`` and return a template with leaf indices in place
    of arrays.  Dict keys are visited sorted so the order is deterministic."""
    if isinstance(value, dict):
        return {k: _tree_leaves(value[k], out) for k in sorted(value)}
    if isinstance(value, (list, tuple)):
        seq = [_tree_leaves(v, out) for v in value]
        return tuple(seq) if isinstance(value, tuple) else seq
    out.append(value)
    return len(out) - 1


def _tree_rebuild(template: Any, leaves: List[Any]) -> Any:
    if isinstance(template, dict):
        return {k: _tree_rebuild(v, leaves) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_tree_rebuild(v, leaves) for v in template]
        return tuple(seq) if isinstance(template, tuple) else seq
    return leaves[template]


def _leaf_nbytes(leaves: List[Any]) -> float:
    return float(sum(int(np.asarray(l).nbytes) for l in leaves))


class PayloadBackend:
    """Interface + placeholder-tolerant base.

    The store calls ``moved(obj, tier)`` after every placement change and
    ``dropped(obj)`` when an object leaves the node.  An object with no
    registered bytes is a *placeholder*: the notification is counted and
    ignored — the modeled plane keeps full fidelity without payloads.
    """

    def __init__(self, measured: Optional[MeasuredBandwidth] = None):
        self.measured = measured if measured is not None else MeasuredBandwidth()
        self.placeholder_moves = 0

    # -- registration ---------------------------------------------------------
    def put(self, obj: str, value: Any, tier: str) -> None:
        """Register ``obj``'s bytes, homed at ``tier`` (not a timed move)."""
        raise NotImplementedError

    def get(self, obj: str) -> Optional[Any]:
        """Host-materialized copy of the payload (None for placeholders)."""
        return None

    def has(self, obj: str) -> bool:
        return False

    def tier_of(self, obj: str) -> Optional[str]:
        return None

    def nbytes(self, obj: str) -> float:
        return 0.0

    # -- store notifications --------------------------------------------------
    def moved(self, obj: str, tier: str) -> None:
        self.placeholder_moves += 1

    def dropped(self, obj: str) -> None:
        pass


class NullPayload(PayloadBackend):
    """Modeled mode: every object is a placeholder; nothing is stored."""

    def put(self, obj: str, value: Any, tier: str) -> None:
        pass


class FakePayload(PayloadBackend):
    """Deterministic in-memory payload plane for tier-1 tests.

    Bytes live in host numpy regardless of tier; a move copies the leaves
    (so an aliasing bug would corrupt detectably) and records *modeled*
    seconds — size over the slower endpoint's roofline — so measured rows
    are bit-reproducible with no accelerator in the loop.
    """

    def __init__(self, measured: Optional[MeasuredBandwidth] = None):
        super().__init__(measured)
        self._tiers: Dict[str, str] = {}
        self._templates: Dict[str, Any] = {}
        self._leaves: Dict[str, List[np.ndarray]] = {}

    def put(self, obj: str, value: Any, tier: str) -> None:
        leaves: List[Any] = []
        template = _tree_leaves(value, leaves)
        self._templates[obj] = template
        self._leaves[obj] = [np.ascontiguousarray(l) for l in leaves]
        self._tiers[obj] = tier

    def get(self, obj: str) -> Optional[Any]:
        if obj not in self._leaves:
            return None
        return _tree_rebuild(self._templates[obj], self._leaves[obj])

    def has(self, obj: str) -> bool:
        return obj in self._leaves

    def tier_of(self, obj: str) -> Optional[str]:
        return self._tiers.get(obj)

    def nbytes(self, obj: str) -> float:
        return _leaf_nbytes(self._leaves.get(obj, []))

    def moved(self, obj: str, tier: str) -> None:
        src = self._tiers.get(obj)
        if src is None:
            self.placeholder_moves += 1
            return
        if src == tier:
            return
        from .tiers import roofline_tier_bw  # deferred: avoids import cycle
        self._leaves[obj] = [l.copy() for l in self._leaves[obj]]
        self._tiers[obj] = tier
        nbytes = self.nbytes(obj)
        bw = min(roofline_tier_bw(src), roofline_tier_bw(tier))
        self.measured.record(src, tier, nbytes, nbytes / bw)

    def dropped(self, obj: str) -> None:
        self._tiers.pop(obj, None)
        self._templates.pop(obj, None)
        self._leaves.pop(obj, None)

