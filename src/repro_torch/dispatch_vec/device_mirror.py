"""Device-resident mirror of the vectorized dispatcher's Sw score matrix.

The incremental dispatch plane keeps ``Sw = demand @ presence.T`` in host
numpy and that copy stays *decision-authoritative* — every phase-1/phase-2
comparison reads it.  This module adds the accelerator-resident shadow the
payload plane wants next to the data: once KV bytes live on the device
(the reference's ``RealPayload``; not in this port yet), the score matrix
that prices placement against them should not round-trip through the host
per epoch either.

``DeviceScoreMirror`` follows the CoherenceBus shape one level down
(``index/coherence.py``): presence events are *enqueued* as they happen and
*applied* as one coalesced delta batch per flush epoch —

  * every ``_bump`` (index add / tier change / remove / late registration
    reaching a demanded object) enqueues ``(col, erow, dw)``; repeats on the
    same ``(col, erow)`` key coalesce additively, exactly as the bus folds
    per-op messages on one ``(file, executor)`` key into a single net op;
  * ``flush()`` turns the epoch's K surviving keys into the rank-K update
    ``Sw += mult @ delta`` (``mult[r, k]`` = row r's multiplicity of delta
    k's object column, ``delta[k, :]`` = one-hot executor row times dw) and
    runs it through ``kernels.dispatch_score.dispatch_score_update`` — the
    SIMT CUDA kernel in which each thread owns one float4 of outputs (reads
    its resident scores, adds its K products), so the matrix never leaves
    the device between epochs.
    ``backend="numpy"`` applies the identical float32 product host-side;
  * row/executor *lifecycle* events (submit, dequeue, deregister) do not
    fit a rank-K product — they rewrite whole rows/columns.  They are
    tracked as dirty sets and resolved at flush by overwriting those
    rows/columns from the authoritative host matrix after the rank-K
    apply.  That order also makes the batch insensitive to enqueue-vs-
    lifecycle interleaving: a delta landing on a row that was since
    recycled is corrected by the overwrite, never left stale.

Parity contract: after any ``flush()``, ``verify()`` must be exact (0.0)
whenever tier weights are dyadic and scores stay within float32's exact-
integer-scaled range — the same argument that makes the incremental host
plane bit-identical to the reference (``default_tier_weights`` is 0.5**i,
multiplicities are small ints, so every partial sum is representable).
Capacity growth of the host arrays and ``rebuild_scores(apply=True)``
re-seed the mirror wholesale (counted, never silent).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Set, Tuple

import numpy as np
import torch

__all__ = ["DeviceScoreMirror", "MirrorStats"]


@dataclass
class MirrorStats:
    deltas_enqueued: int = 0        # record_delta calls
    deltas_coalesced: int = 0       # absorbed by an existing (col, erow) key
    rank_k_applied: int = 0         # delta keys flushed through the product
    rows_overwritten: int = 0       # dirty-row authoritative repairs
    cols_overwritten: int = 0       # dirty-executor-column repairs
    flushes: int = 0
    reseeds: int = 0                # full re-seeds (growth / bulk rebuild)

    @property
    def coalesce_rate(self) -> float:
        return (self.deltas_coalesced / self.deltas_enqueued
                if self.deltas_enqueued else 0.0)

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view (prefixed ``mirror.`` when adopted)."""
        from ..obs.registry import stats_snapshot
        return stats_snapshot(self, props=("coalesce_rate",))


class DeviceScoreMirror:
    """Accelerator-resident Sw shadow fed by coalesced delta epochs.

    ``backend="cuda"`` keeps a float32 tensor on ``device`` and applies
    epochs with the rank-K CUDA kernel (on a CPU ``device`` the kernel's
    plain version runs); ``backend="numpy"`` keeps a float32 ndarray and
    applies the identical product host-side.  Dirty-row and dirty-column
    repairs are plain tensor index writes.  The host ``_Sw`` stays
    decision-authoritative either way; the mirror is read by device-side
    consumers and verified against the host, never the reverse.
    """

    def __init__(self, dispatcher, backend: str = "numpy",
                 device: str = "cuda"):
        if backend not in ("numpy", "cuda"):
            raise ValueError(f"backend must be numpy|cuda, got {backend!r}")
        self.backend = backend
        self.device = device
        self._d = dispatcher
        self.stats = MirrorStats()
        self._pending: Dict[Tuple[int, int], float] = {}
        self._dirty_rows: Set[int] = set()
        self._dirty_cols: Set[int] = set()
        self._dev = None
        self.reseed()

    # ------------------------------------------------------------- enqueue
    def record_delta(self, col: int, erow: int, dw: float) -> None:
        """One presence event touching demanded rows: dw at (col, erow)."""
        self.stats.deltas_enqueued += 1
        key = (col, erow)
        if key in self._pending:
            self.stats.deltas_coalesced += 1
            self._pending[key] += dw
        else:
            self._pending[key] = dw

    def record_row_dirty(self, row: int) -> None:
        """Row lifecycle (submit / dequeue): rewrite from host at flush."""
        self._dirty_rows.add(row)

    def record_col_dirty(self, erow: int) -> None:
        """Executor lifecycle (deregister): rewrite column at flush."""
        self._dirty_cols.add(erow)

    def pending(self) -> int:
        return len(self._pending)

    # --------------------------------------------------------------- apply
    def reseed(self) -> None:
        """Full authoritative copy; drops any pending epoch state."""
        self.stats.reseeds += 1
        self._pending.clear()
        self._dirty_rows.clear()
        self._dirty_cols.clear()
        host = self._d._Sw.astype(np.float32)
        if self.backend == "cuda":
            self._dev = self._tensor(host)
        else:
            self._dev = host

    def flush(self) -> int:
        """Apply the epoch: rank-K product, then dirty-row/col repairs.

        Returns the number of delta keys applied.  A host capacity growth
        since the last flush (the score matrices reallocated) re-seeds
        instead — growth is rare and amortized, and a partial epoch against
        a resized matrix has no cheap exact replay.
        """
        sw = self._d._Sw
        if self._dev.shape != sw.shape:
            self.reseed()
            return 0
        self.stats.flushes += 1
        k = len(self._pending)
        if k:
            cols = np.fromiter((c for c, _ in self._pending),
                               dtype=np.intp, count=k)
            erows = np.fromiter((e for _, e in self._pending),
                                dtype=np.intp, count=k)
            dws = np.fromiter(self._pending.values(), dtype=np.float32,
                              count=k)
            # mult[r, j]: how many of row r's demanded slots name delta j's
            # column — non-dirty rows' _row_cols are unchanged since the
            # event (any row whose slots changed is in the dirty set), so
            # computing multiplicity at flush time equals event time.
            mult = (self._d._row_cols[:, :, None] == cols[None, None, :]
                    ).sum(axis=1).astype(np.float32)
            delta = np.zeros((k, sw.shape[1]), dtype=np.float32)
            delta[np.arange(k), erows] = dws
            if self.backend == "cuda":
                from ..kernels.dispatch_score.ops import dispatch_score_update
                self._dev = dispatch_score_update(
                    self._dev, self._tensor(mult), self._tensor(delta))
            else:
                self._dev = self._dev + mult @ delta
            self.stats.rank_k_applied += k
            self._pending.clear()
        if self._dirty_rows:
            rows = np.fromiter(self._dirty_rows, dtype=np.intp,
                               count=len(self._dirty_rows))
            if self.backend == "cuda":
                self._dev[self._tensor(rows)] = self._tensor(
                    sw[rows].astype(np.float32))
            else:
                self._dev[rows] = sw[rows].astype(np.float32)
            self.stats.rows_overwritten += rows.size
            self._dirty_rows.clear()
        if self._dirty_cols:
            ec = np.fromiter(self._dirty_cols, dtype=np.intp,
                             count=len(self._dirty_cols))
            if self.backend == "cuda":
                self._dev[:, self._tensor(ec)] = self._tensor(
                    sw[:, ec].astype(np.float32))
            else:
                self._dev[:, ec] = sw[:, ec].astype(np.float32)
            self.stats.cols_overwritten += ec.size
            self._dirty_cols.clear()
        return k

    # -------------------------------------------------------------- verify
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def scores(self) -> np.ndarray:
        """Host view of the mirror (device transfer under cuda)."""
        if self.backend == "cuda":
            return self._dev.cpu().numpy()
        return np.asarray(self._dev)

    def verify(self) -> float:
        """Max |mirror - authoritative Sw| after a flush; 0.0 in the dyadic
        tier-weight regime (the parity contract)."""
        return float(np.abs(self.scores().astype(np.float64)
                            - self._d._Sw).max(initial=0.0))
