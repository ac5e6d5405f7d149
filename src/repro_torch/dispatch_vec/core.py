"""Array-backed vectorized dispatch core: batched window scoring.

``core.dispatch.DataAwareDispatcher`` implements the paper's two-phase
algorithm over hash maps and sorted sets — the promised O(|theta(T_i)| +
min(|Q|, W)) per decision, but paid in pure-Python dict/set iteration:
``notify`` re-walks up to W queued items and ``pick_items`` re-sorts the
executor's cached set on every call.  At serving rates the dispatcher
becomes the critical path.  This module keeps the *decisions* bit-identical
while moving the arithmetic into dense numpy state:

  demand     : each queued item is a row of object-column ids (the window x
               objects demand bitmap, stored row-sparse; ``demand_matrix()``
               materializes the dense bitmap for the bulk/kernel path);
  presence   : (executors x objects) bitmap + tier-weighted matrix, mirroring
               the index for *registered* executors;
  Sb / Sw    : (items x executors) unweighted-hit-count / weighted score
               matrices — exactly ``demand @ presence.T`` — maintained
               *incrementally* from three sources (no per-decision rebuild):
                 * ``submit`` / ``_remove_from_queue`` (row lifecycle),
                 * index entry-change events (``CacheLocationIndex.subscribe``),
                 * executor registration (column lifecycle).

Phase 1 then reduces to an argmax over score rows and phase 2 to a top-k
over a score column.  ``notify_batch`` drains every free executor from a
single window scan; repeated ``notify`` calls produce the same sequence (the
golden reference semantics).  Consumers that interleave state mutation
between assignments keep calling ``notify`` one at a time and still get the
array-fast path; the serving router's batch mode instead defers its tier
promotions out of the decision path (``CacheAffinityRouter(batch_drain=
True)``) so it can ride the single-scan drain.

Bulk (re)scoring — ``rebuild_scores()`` — runs the one-shot matmul on the
materialized bitmaps: numpy always; ``score_backend="cuda"`` routes it
through the SIMT CUDA kernel in ``kernels.dispatch_score`` (one warp per
executor and two window rows; float32 FMA on the card, exact in the dyadic
tier-weight regime).
The incremental plane never needs it in steady state — it exists for
bootstrap-from-snapshot, consistency verification, and the benchmark's
kernel-vs-numpy comparison.

``attach_device_mirror()`` adds the accelerator-resident shadow of ``Sw``
(``device_mirror.DeviceScoreMirror``): presence deltas flowing through
``_bump`` are enqueued as CoherenceBus-shaped batches and applied per flush
epoch as one rank-K ``Sw += mult @ delta`` through the incremental CUDA
kernel (``kernels.dispatch_score.dispatch_score_update``), with row/executor
lifecycle events repaired from the host copy.  The numpy ``_Sw`` stays
decision-authoritative; the mirror exists so device-side consumers (the
real payload plane's placement pricing) read scores without a host
round-trip, and its ``verify()`` is exact in the dyadic tier-weight regime.

Decision equivalence (the ``bench_dispatch_vec`` gate and the property tests
in ``tests/test_dispatch_vec.py`` assert bit-identical assignment sequences
against the reference on seeded streams, all five policies x tier weights x
GCC floor) relies on two documented properties:

  * score updates are exact: with tier weights drawn from dyadic values
    (``default_tier_weights`` uses 0.5**i) every incremental add/subtract is
    exact in float64, so vectorized comparisons see the same ties the
    reference's sequential accumulation sees;
  * tie-breaks replay the reference iteration order: among free executors
    with the maximal weighted count, the reference keeps the first to
    *reach* that count (objects in item order, holders in name order) —
    equivalently the one whose last contributing object comes earliest,
    then the smaller name.
"""

from __future__ import annotations

from itertools import islice
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np

from ..core.dispatch import DataAwareDispatcher
from ..core.task import ExecutorState

__all__ = ["VectorizedDispatcher"]


class VectorizedDispatcher(DataAwareDispatcher):
    """Drop-in ``DataAwareDispatcher`` with array-backed scoring state.

    Same constructor surface plus ``score_backend`` ("numpy" | "cuda") for
    the bulk-rescore path.  Requires an index that supports ``subscribe`` /
    ``entries`` (both ``CentralizedIndex`` and ``ShardedIndex`` do).
    """

    def __init__(self, *args, score_backend: str = "numpy", **kwargs):
        super().__init__(*args, **kwargs)
        if not hasattr(self.index, "subscribe") or not hasattr(self.index, "entries"):
            raise TypeError(
                "VectorizedDispatcher needs an index with subscribe()/entries() "
                f"(got {type(self.index).__name__}); use CentralizedIndex or "
                "ShardedIndex")
        self.score_backend = score_backend
        self._mirror = None             # attach_device_mirror() installs
        # -- object columns --------------------------------------------------
        o_cap = 256
        self._obj_col: Dict[str, int] = {}
        self._col_obj: List[Optional[str]] = [None] * o_cap
        self._col_free: List[int] = list(range(o_cap - 1, -1, -1))
        self._col_holders = np.zeros(o_cap, dtype=np.int32)   # replication factor
        self._colmax_w = np.zeros(o_cap, dtype=np.float64)    # max weight over
        #                                                       registered execs
        # -- executor rows ---------------------------------------------------
        e_cap = 16
        self._exec_row: Dict[str, int] = {}
        self._row_execname: List[Optional[str]] = [None] * e_cap
        self._erow_free: List[int] = list(range(e_cap - 1, -1, -1))
        self._presence = np.zeros((e_cap, o_cap), dtype=np.uint8)
        self._presence_w = np.zeros((e_cap, o_cap), dtype=np.float64)
        # -- item rows (the demand bitmap, row-sparse) -----------------------
        r_cap, maxobj = 256, 8
        self._item_row: Dict[Hashable, int] = {}
        self._row_key: List[Optional[Hashable]] = [None] * r_cap
        self._irow_free: List[int] = list(range(r_cap - 1, -1, -1))
        self._row_cols = np.full((r_cap, maxobj), -1, dtype=np.int32)
        self._row_nobj = np.zeros(r_cap, dtype=np.int32)
        self._row_seq = np.zeros(r_cap, dtype=np.int64)
        # -- score matrices: Sb = demand @ presence.T (counts), Sw weighted --
        self._Sb = np.zeros((r_cap, e_cap), dtype=np.int32)
        self._Sw = np.zeros((r_cap, e_cap), dtype=np.float64)
        # Bootstrap holder counts from entries that predate this dispatcher
        # (presence rows are built per executor at register_executor).
        for f, _e, _tier in self.index.entries():
            self._col_holders[self._col_for(f)] += 1
        self.index.subscribe(self._on_index_event)

    # ------------------------------------------------------------ capacity
    def _grow_cols(self) -> None:
        old = self._presence.shape[1]
        new = old * 2
        self._presence = np.hstack(
            [self._presence, np.zeros((self._presence.shape[0], old), np.uint8)])
        self._presence_w = np.hstack(
            [self._presence_w, np.zeros((self._presence_w.shape[0], old), np.float64)])
        self._col_holders = np.concatenate(
            [self._col_holders, np.zeros(old, np.int32)])
        self._colmax_w = np.concatenate(
            [self._colmax_w, np.zeros(old, np.float64)])
        self._col_obj.extend([None] * old)
        self._col_free.extend(range(new - 1, old - 1, -1))

    def _grow_execs(self) -> None:
        old = self._presence.shape[0]
        o_cap = self._presence.shape[1]
        self._presence = np.vstack(
            [self._presence, np.zeros((old, o_cap), np.uint8)])
        self._presence_w = np.vstack(
            [self._presence_w, np.zeros((old, o_cap), np.float64)])
        self._Sb = np.hstack([self._Sb, np.zeros((self._Sb.shape[0], old), np.int32)])
        self._Sw = np.hstack([self._Sw, np.zeros((self._Sw.shape[0], old), np.float64)])
        self._row_execname.extend([None] * old)
        self._erow_free.extend(range(2 * old - 1, old - 1, -1))

    def _grow_rows(self) -> None:
        old = self._Sb.shape[0]
        e_cap = self._Sb.shape[1]
        maxobj = self._row_cols.shape[1]
        self._Sb = np.vstack([self._Sb, np.zeros((old, e_cap), np.int32)])
        self._Sw = np.vstack([self._Sw, np.zeros((old, e_cap), np.float64)])
        self._row_cols = np.vstack(
            [self._row_cols, np.full((old, maxobj), -1, np.int32)])
        self._row_nobj = np.concatenate([self._row_nobj, np.zeros(old, np.int32)])
        self._row_seq = np.concatenate([self._row_seq, np.zeros(old, np.int64)])
        self._row_key.extend([None] * old)
        self._irow_free.extend(range(2 * old - 1, old - 1, -1))

    def _grow_maxobj(self, need: int) -> None:
        have = self._row_cols.shape[1]
        new = max(need, have * 2)
        pad = np.full((self._row_cols.shape[0], new - have), -1, np.int32)
        self._row_cols = np.hstack([self._row_cols, pad])

    # ------------------------------------------------------------- columns
    def _col_for(self, file: str) -> int:
        col = self._obj_col.get(file)
        if col is not None:
            return col
        if not self._col_free:
            self._grow_cols()
        col = self._col_free.pop()
        self._obj_col[file] = col
        self._col_obj[col] = file
        return col

    def _maybe_free_col(self, file: str, col: int) -> None:
        """Release a column once nothing holds and nothing demands it."""
        if self._col_holders[col] == 0 and file not in self._demand \
                and self._obj_col.get(file) == col:
            del self._obj_col[file]
            self._col_obj[col] = None
            self._colmax_w[col] = 0.0
            self._col_free.append(col)

    def _weight_value(self, tier: Optional[str]) -> float:
        """Mirror of the reference ``_weight``: flat entries weigh 1.0."""
        if self.tier_weights is None or tier is None:
            return 1.0
        return self.tier_weights.get(tier, 1.0)

    def _refresh_colmax(self, col: int) -> None:
        self._colmax_w[col] = float(self._presence_w[:, col].max())

    # ----------------------------------------------------- incremental plane
    def _bump(self, file: str, erow: int, db: int, dw: float) -> None:
        """Apply a presence delta at (file, executor) to every demanding row,
        honoring per-item object multiplicity (an item naming ``file`` twice
        scores it twice, as the reference accumulation does)."""
        keys = self._demand.get(file)
        if not keys:
            return
        col = self._obj_col[file]
        rows = np.fromiter((self._item_row[k] for k in keys),
                           dtype=np.intp, count=len(keys))
        mult = (self._row_cols[rows] == col).sum(axis=1)
        if db:
            self._Sb[rows, erow] += db * mult
        if dw:
            self._Sw[rows, erow] += dw * mult
            if self._mirror is not None:
                self._mirror.record_delta(col, erow, dw)

    def _on_index_event(self, op: str, file: str, executor: str,
                        tier: Optional[str]) -> None:
        if op == "add":
            col = self._col_for(file)
            self._col_holders[col] += 1
            erow = self._exec_row.get(executor)
            if erow is not None:
                w = self._weight_value(tier)
                self._presence[erow, col] = 1
                self._presence_w[erow, col] = w
                if w > self._colmax_w[col]:
                    self._colmax_w[col] = w
                self._bump(file, erow, 1, w)
        elif op == "tier":
            col = self._obj_col.get(file)
            erow = self._exec_row.get(executor)
            if col is None or erow is None or not self._presence[erow, col]:
                return
            w = self._weight_value(tier)
            old = self._presence_w[erow, col]
            if w != old:
                self._presence_w[erow, col] = w
                self._refresh_colmax(col)
                self._bump(file, erow, 0, w - old)
        else:  # remove
            col = self._obj_col.get(file)
            if col is None:
                return
            self._col_holders[col] -= 1
            erow = self._exec_row.get(executor)
            if erow is not None and self._presence[erow, col]:
                old = self._presence_w[erow, col]
                self._presence[erow, col] = 0
                self._presence_w[erow, col] = 0.0
                self._refresh_colmax(col)
                self._bump(file, erow, -1, -old)
            self._maybe_free_col(file, col)

    # ------------------------------------------------------------ executors
    def register_executor(self, name: str) -> None:
        super().register_executor(name)
        if name in self._exec_row:
            return
        if not self._erow_free:
            self._grow_execs()
        erow = self._erow_free.pop()
        self._exec_row[name] = erow
        self._row_execname[erow] = name
        # Late registration: mirror any presence the index already records.
        for f in self.index.cached_at(name):
            col = self._col_for(f)
            w = self._weight_value(self.index.tier_of(f, name))
            self._presence[erow, col] = 1
            self._presence_w[erow, col] = w
            if w > self._colmax_w[col]:
                self._colmax_w[col] = w
            self._bump(f, erow, 1, w)

    def deregister_executor(self, name: str) -> None:
        erow = self._exec_row.get(name)
        # super() drops the executor from the index, which fires per-entry
        # remove events through _on_index_event while the row still exists.
        super().deregister_executor(name)
        if erow is None:
            return
        del self._exec_row[name]
        self._row_execname[erow] = None
        self._presence[erow, :] = 0
        self._presence_w[erow, :] = 0.0
        self._Sb[:, erow] = 0
        self._Sw[:, erow] = 0.0
        self._erow_free.append(erow)
        if self._mirror is not None:
            self._mirror.record_col_dirty(erow)

    # ---------------------------------------------------------------- queue
    def submit(self, item: Any) -> None:
        key = self._key(item)
        old_row = self._item_row.pop(key, None)
        if old_row is not None:
            # Re-submit of an already-queued key: the reference engine
            # replaces the queue entry in place; release the stale row so it
            # cannot linger with nonzero scores.  (If the new item names
            # *different* objects, the reference additionally keeps the old
            # objects' demand-index entries around as a quirk; here scores
            # reflect the current item only.)
            n_old = int(self._row_nobj[old_row])
            self._row_cols[old_row, :n_old] = -1
            self._row_nobj[old_row] = 0
            self._row_key[old_row] = None
            self._Sb[old_row, :] = 0
            self._Sw[old_row, :] = 0.0
            self._irow_free.append(old_row)
            if self._mirror is not None:
                self._mirror.record_row_dirty(old_row)
        super().submit(item)
        objs = self._objects(item)
        n = len(objs)
        if n > self._row_cols.shape[1]:
            self._grow_maxobj(n)
        if not self._irow_free:
            self._grow_rows()
        row = self._irow_free.pop()
        self._item_row[key] = row
        self._row_key[row] = key
        self._row_nobj[row] = n
        self._row_seq[row] = self._seq_of[key]
        if n:
            cols = np.fromiter((self._col_for(f) for f in objs),
                               dtype=np.int32, count=n)
            self._row_cols[row, :n] = cols
            self._Sb[row, :] = self._presence[:, cols].sum(axis=1, dtype=np.int32)
            self._Sw[row, :] = self._presence_w[:, cols].sum(axis=1)
        if self._mirror is not None:
            self._mirror.record_row_dirty(row)

    def _remove_from_queue(self, item: Any) -> None:
        key = self._key(item)
        super()._remove_from_queue(item)
        row = self._item_row.pop(key, None)
        if row is None:
            return
        n = int(self._row_nobj[row])
        cols = self._row_cols[row, :n].tolist()
        self._row_cols[row, :n] = -1
        self._row_nobj[row] = 0
        self._row_key[row] = None
        self._Sb[row, :] = 0
        self._Sw[row, :] = 0.0
        self._irow_free.append(row)
        if self._mirror is not None:
            self._mirror.record_row_dirty(row)
        for c in set(cols):
            obj = self._col_obj[c]
            if obj is not None:
                self._maybe_free_col(obj, c)

    # ------------------------------------------------------------- phase 1
    def _free_arrays(self) -> Tuple[List[str], np.ndarray]:
        names = list(self._free)
        rows = np.fromiter((self._exec_row[n] for n in names),
                           dtype=np.intp, count=len(names))
        return names, rows

    def _tie_break(self, row: int, names: List[str], erows: List[int]) -> str:
        """Reference tie-break among free executors sharing the max weighted
        count: first to *reach* it in (object order, holder-name order) ==
        min over ties of (index of last contributing object, name)."""
        n = int(self._row_nobj[row])
        cols = self._row_cols[row, :n]
        best_key: Optional[Tuple[int, str]] = None
        best_name = names[0]
        for name, er in zip(names, erows):
            w = self._presence_w[er, cols]
            nz = np.nonzero(w > 0.0)[0]
            j = int(nz[-1])             # max>0 guarantees a contribution
            k = (j, name)
            if best_key is None or k < best_key:
                best_key, best_name = k, name
        return best_name

    def _filter_penalized(self, ties: np.ndarray,
                          names: List[str]) -> np.ndarray:
        """Straggler tie rule, reference-equivalent: the reference's
        steal-at-equal iteration ends on the first *unpenalized* executor to
        reach the max (else the first overall), which is exactly the plain
        reach-order tie-break restricted to the unpenalized subset when that
        subset is non-empty."""
        if not self.penalties or ties.size <= 1:
            return ties
        pen = self.penalties
        unpen = [int(t) for t in ties if names[int(t)] not in pen]
        if unpen and len(unpen) < ties.size:
            return np.asarray(unpen, dtype=ties.dtype)
        return ties

    def _choose_executor(self, row: int) -> str:
        """Best free executor for one item (phase-1 decision), reference-
        identical: weighted-count argmax among frees, else first free."""
        names, rows = self._free_arrays()
        vals = self._Sw[row, rows]
        mx = vals.max()
        if mx <= 0.0:
            return names[0]
        ties = np.nonzero(vals == mx)[0]
        ties = self._filter_penalized(ties, names)
        if ties.size == 1:
            return names[int(ties[0])]
        return self._tie_break(row, [names[i] for i in ties],
                               [int(rows[i]) for i in ties])

    def notify(self) -> Optional[Tuple[str, Any]]:
        head = self._head()
        if head is None or not self._free:
            return None
        self.stats.decisions += 1
        if self.policy == "first-available":
            return self._assign(next(iter(self._free)), head)
        cache_mode = self._cache_mode()
        if (cache_mode and not self._scan_dirty
                and self._idx_version_seen == self.index.version):
            self.stats.delayed += 1
            return None
        if not cache_mode:
            # Non-delaying policies always place the queue head.
            row = self._item_row[self._key(head)]
            return self._assign(self._choose_executor(row), head)
        pairs = self._cache_scan(limit=1, batch=False)
        if pairs:
            return pairs[0]
        self._scan_dirty = False
        self._idx_version_seen = self.index.version
        return None

    def notify_batch(self, limit: Optional[int] = None) -> List[Tuple[str, Any]]:
        """Single-scan drain, decision-identical to looping ``notify()``.

        Valid only when nothing mutates dispatcher or index state between
        the emulated calls — the DES ``_try_notify`` contract, and since the
        router's batched drain (``CacheAffinityRouter(batch_drain=True)``)
        defers tier promotions and miss admissions until after the scan,
        the live serving path too.  ``stats.decisions`` stays exact;
        ``stats.delayed`` counts each delayed item once per scan instead of
        once per emulated call.
        """
        self.stats.batch_drains += 1
        out: List[Tuple[str, Any]] = []
        if self.policy == "first-available":
            while self._queue and self._free and (limit is None or len(out) < limit):
                self.stats.decisions += 1
                out.append(self._assign(next(iter(self._free)), self._head()))
            return out
        cache_mode = self._cache_mode()   # constant while states stay PENDING
        ov_seed: Optional[Dict[int, set]] = None
        if not cache_mode:
            # GCC mid-drain utilization flip: the looped serving path marks
            # each assignment BUSY before its next decision, so utilization
            # rises by 1/n per assignment and can cross the GCC threshold
            # inside the drain.  Busy only grows, so the flip point is
            # deterministic: with admission emulation the compute-mode loop
            # stops there and the remainder drains through the cache scan
            # (seeded with this loop's would-be admissions); without it
            # every decision past the flip is counted stale — never silent.
            gcc = self.policy == "good-cache-compute"
            n_exec = len(self._executors)
            busy = sum(1 for s in self._executors.values()
                       if s == ExecutorState.BUSY)
            if gcc and self.emulate_batch_admissions:
                ov_seed = {}
            while self._queue and self._free and (limit is None or len(out) < limit):
                if gcc and n_exec and \
                        (busy + len(out)) / n_exec >= self.cpu_util_threshold:
                    if ov_seed is not None:
                        cache_mode = True       # emulated mid-drain flip
                        break
                    self.stats.batch_stale_decisions += 1
                self.stats.decisions += 1
                head = self._head()
                row = self._item_row[self._key(head)]
                name = self._choose_executor(row)
                if ov_seed is not None:
                    self._ov_record(ov_seed, name, row)
                out.append(self._assign(name, head))
            if not cache_mode:
                return out
        if not self._queue or not self._free:
            return out
        if not self._scan_dirty and self._idx_version_seen == self.index.version:
            self.stats.decisions += 1     # the memoized failing call
            self.stats.delayed += 1
            return out
        rest = None if limit is None else limit - len(out)
        out.extend(self._cache_scan(limit=rest, batch=True, ov_init=ov_seed))
        if self._queue and self._free and (limit is None or len(out) < limit):
            # The terminal emulated call completed a full failed scan.
            self.stats.decisions += 1
            self._scan_dirty = False
            self._idx_version_seen = self.index.version
        return out

    def _ov_record(self, ov: Dict[int, set], name: str, r: int) -> None:
        """Record an assignment's would-be admissions into the batch-scan
        overlay: every demanded column the executor does not already hold
        would land in its store before the looped path's next decision."""
        erow = self._exec_row[name]
        for c in self._row_cols[r, :int(self._row_nobj[r])].tolist():
            if not self._presence[erow, c]:
                s = ov.get(c)
                if s is None:
                    s = ov[c] = set()
                s.add(name)

    def _cache_scan(self, limit: Optional[int], batch: bool,
                    ov_init: Optional[Dict[int, set]] = None,
                    ) -> List[Tuple[str, Any]]:
        """Window scan for the delaying policies (MCH / GCC-above-threshold).

        Emulates the reference per-call scan; in batch mode the scan
        continues past each assignment instead of restarting (delayed items
        stay delayed — nothing an assignment changes can free their
        preferred holders), with the visit budget extended exactly as the
        restarts would have: an item is visitable while the count of
        delayed-in-place items ahead of it is below the window.

        Items the policy delays in place are classified *vectorized* (no
        free holder scores them, and for GCC the replication cap binds with
        the tier floor satisfied) and never enter the python loop — under a
        deep backlog of affinity-delayed requests (the serving saturation
        regime) the loop body runs only for the <= F items that actually
        produce assignments.  Row-max staleness after an assignment consumes
        a free column is fixed by a vectorized *group* repair at the
        assignment (all remaining rows pointing at the consumed column in
        one pass), never per visited item.
        """
        free_names, free_rows = self._free_arrays()
        F = len(free_names)
        budget = min(len(self._queue), self.window + (F if batch else 0))
        keys = list(islice(self._queue, budget))
        n = len(keys)
        rows = np.fromiter((self._item_row[k] for k in keys),
                           dtype=np.intp, count=n)
        SwF = self._Sw[np.ix_(rows, free_rows)]           # (n, F)
        maxw = SwF.max(axis=1)
        argw = SwF.argmax(axis=1)
        anylive = self._Sb[rows].any(axis=1)
        gcc = self.policy == "good-cache-compute"
        floor_on = False
        if gcc:
            idx = self._row_cols[rows]                     # (n, maxobj), -1 pad
            valid = idx >= 0
            safe = np.where(valid, idx, 0)
            rep = np.where(valid, self._col_holders[safe], 0).max(axis=1)
            floor_on = self.tier_weights is not None and self.gcc_delay_tier_floor > 0.0
            if floor_on:
                worthwhile = np.where(
                    valid, self._colmax_w[safe] >= self.gcc_delay_tier_floor,
                    False).any(axis=1)
        # Delay classification (exactly the loop body's fall-through path):
        # no free holder scores the item, some live holder exists, and —
        # under GCC — the replication cap binds while the floor says the
        # wait is worthwhile.
        no_free = (maxw <= 0.0) & anylive
        if gcc:
            delay_mask = no_free & (rep >= self.max_replicas)
            if floor_on:
                delay_mask &= worthwhile
        else:
            delay_mask = no_free
        # delayed_ahead[i]: delayed-in-place items strictly before position i.
        delayed_ahead = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(delay_mask, out=delayed_ahead[1:])
        visit = np.nonzero(~delay_mask)[0]
        active = np.ones(F, dtype=bool)
        n_active = F
        out: List[Tuple[str, Any]] = []
        extra_delayed = 0           # argmax-repaired items that became delayed
        scan_end = n                # first position the emulated scan never saw
        name_to_fcol = {nm: i for i, nm in enumerate(free_names)}
        nv = int(visit.size)
        vpos = 0
        # Batch-scan admission overlay (column id -> executors assigned work
        # naming it this scan that do not already hold it): the looped
        # serving path admits each assignment's objects before the next
        # decision; the overlay tracks that evolution so a diverging branch
        # is counted (stats.batch_stale_decisions) or — with admission
        # emulation on — replayed bit-exactly (stats.batch_emulated_decisions).
        ov: Optional[Dict[int, set]] = (
            ov_init if ov_init is not None else {}) if batch else None
        ov_top_ok = floor_on and self.tier_weights is not None and \
            max(self.tier_weights.values()) >= self.gcc_delay_tier_floor

        def assign(i: int, name: str) -> None:
            nonlocal n_active
            if batch:
                self.stats.decisions += 1  # one emulated call per assignment
            if ov is not None:
                # Record before _assign releases the item's row (and with it
                # the _row_cols slice the overlay needs).
                self._ov_record(ov, name, int(rows[i]))
            out.append(self._assign(name, self._queue[keys[i]]))
            fcol = name_to_fcol[name]
            active[fcol] = False
            n_active -= 1
            # Group-repair the row max of every not-yet-visited item whose
            # cached argmax column was just consumed: one vectorized pass
            # per assignment instead of a lazy nonzero+argmax pair at each
            # subsequent visit (under saturation most of the window points
            # at the same hot executor, so the lazy repair fired on nearly
            # every visited item — the cost that made the batched drain
            # lose to the looped path at large streams).
            if n_active > 0 and vpos + 1 < nv:
                rem = visit[vpos + 1:]
                need = rem[argw[rem] == fcol]
                if need.size:
                    live = np.nonzero(active)[0]
                    sub = SwF[np.ix_(need, live)]
                    am = sub.argmax(axis=1)
                    maxw[need] = sub[np.arange(need.size), am]
                    argw[need] = live[am]

        while vpos < nv:
            i = int(visit[vpos])
            if delayed_ahead[i] + extra_delayed >= self.window or n_active == 0:
                scan_end = i
                break
            if maxw[i] > 0.0:
                ties_mask = active & (SwF[i] == maxw[i])
                ties = np.nonzero(ties_mask)[0]
                ties = self._filter_penalized(ties, free_names)
                if ties.size == 1:
                    name = free_names[int(ties[0])]
                else:
                    name = self._tie_break(
                        int(rows[i]), [free_names[t] for t in ties],
                        [int(free_rows[t]) for t in ties])
                assign(i, name)
            else:
                # No free holder scores the item: the tail decision, frozen
                # first, then re-evaluated under the admission overlay
                # (which can only convert an assign into a delay).
                if not anylive[i]:
                    dec = "assign"
                elif not gcc:
                    dec = "delay"
                elif rep[i] < self.max_replicas:
                    # Preferred holder(s) busy (score consumed by a repair).
                    dec = "assign"
                elif floor_on and not worthwhile[i]:
                    dec = "bypass"
                else:
                    dec = "delay"
                if ov and dec != "delay":
                    r = int(rows[i])
                    ocols = self._row_cols[r, :int(self._row_nobj[r])].tolist()
                    if any(c in ov for c in ocols):
                        if not gcc:
                            eff = "delay"
                        else:
                            rep_eff = max(int(self._col_holders[c])
                                          + len(ov.get(c, ())) for c in ocols)
                            if rep_eff < self.max_replicas:
                                eff = "assign"
                            elif floor_on and not (worthwhile[i] or ov_top_ok):
                                eff = "bypass"
                            else:
                                eff = "delay"
                        if eff != dec:
                            if self.emulate_batch_admissions:
                                self.stats.batch_emulated_decisions += 1
                                dec = eff
                            else:
                                self.stats.batch_stale_decisions += 1
                if dec == "assign":
                    assign(i, next(iter(self._free)))
                elif dec == "bypass":
                    self.stats.tier_floor_bypasses += 1
                    assign(i, next(iter(self._free)))
                else:
                    extra_delayed += 1
                    vpos += 1
                    continue
            if n_active == 0 or (limit is not None and len(out) >= limit):
                # The emulated call returned at this assignment (limit), or
                # the next emulated call returns at the no-free check before
                # scanning anything: positions past it were never scanned
                # (delayed stats stay reference-exact on both ends).
                scan_end = i + 1
                break
            vpos += 1
        self.stats.delayed += min(
            self.window, int(delayed_ahead[min(scan_end, n)]) + extra_delayed)
        return out

    # ------------------------------------------------------------- phase 2
    def pick_items(self, executor: str, m: int = 1) -> List[Any]:
        erow = self._exec_row.get(executor)
        if erow is None:           # unregistered executor: reference path
            return super().pick_items(executor, m)
        if not self._queue:
            self.set_state(executor, ExecutorState.FREE)
            return []
        self.stats.window_scans += 1
        head_seq = self._seq_of[next(iter(self._queue))]
        horizon = head_seq + self.window
        cand = np.nonzero(self._Sb[:, erow] > 0)[0]       # active rows only
        if cand.size:
            cand = cand[self._row_seq[cand] < horizon]
        picked: List[Any] = []
        if cand.size:
            self.stats.tasks_scanned += int(cand.size)
            frac = self._Sw[cand, erow] / self._row_nobj[cand]
            perfect_mask = frac >= 1.0
            perfect = cand[perfect_mask]

            def fstar(r: int) -> str:
                """First cached object the reference traversal visits the
                item at: min demanded-and-cached object name."""
                n = int(self._row_nobj[r])
                cols = self._row_cols[r, :n]
                held = cols[self._presence[erow, cols] > 0]
                return min(self._col_obj[c] for c in held)

            tw = self.tenant_weights
            if tw:
                # Weighted overload mode: same generalization as the
                # reference engine — tenant weight first, then the exact
                # (first-cached-object, key) traversal order within a weight.
                perf_rows = sorted(
                    perfect.tolist(),
                    key=lambda r: (-self._tenant_w(
                        self._queue[self._row_key[r]]),
                        fstar(r), self._row_key[r]))
            else:
                perf_rows = sorted(perfect.tolist(),
                                   key=lambda r: (fstar(r), self._row_key[r]))
            for r in perf_rows[:m]:
                item = self._queue[self._row_key[r]]
                self.stats.perfect_hits += 1
                self._dispatch_item(item, executor)
                picked.append(item)
            if len(picked) >= m:
                self.set_state(executor, ExecutorState.BUSY)
                return picked
            # Fewer than m perfect hits: highest-scoring partials next,
            # ordered by (-score, FIFO seq) exactly as the reference sort.
            prows = cand[~perfect_mask]
            if prows.size:
                if tw:
                    wvec = np.array(
                        [self._tenant_w(self._queue[self._row_key[int(r)]])
                         for r in prows], dtype=np.float64)
                    order = np.lexsort((self._row_seq[prows], -wvec,
                                        -frac[~perfect_mask]))
                else:
                    order = np.lexsort((self._row_seq[prows],
                                        -frac[~perfect_mask]))
                for oi in order:
                    if len(picked) >= m:
                        break
                    item = self._queue[self._row_key[int(prows[oi])]]
                    self._dispatch_item(item, executor)
                    picked.append(item)
        if picked:
            self.set_state(executor, ExecutorState.BUSY)
            return picked
        return self._no_hit_fallback(executor, m)

    # ------------------------------------------------- bulk scoring / debug
    def demand_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, dense window-x-objects demand bitmap) for active items, in
        row-id order; entry counts per-item object multiplicity."""
        rows = np.fromiter(sorted(self._item_row.values()), dtype=np.intp,
                           count=len(self._item_row))
        o_cap = self._presence.shape[1]
        dm = np.zeros((len(rows), o_cap), dtype=np.float32)
        for i, r in enumerate(rows):
            n = int(self._row_nobj[r])
            np.add.at(dm[i], self._row_cols[r, :n], 1.0)
        return rows, dm

    def presence_matrices(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._presence, self._presence_w

    def rebuild_scores(self, backend: Optional[str] = None,
                       apply: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """One-shot ``demand @ presence.T`` over the materialized bitmaps.

        Returns (Sb, Sw) for active rows (row-id order).  ``backend`` falls
        back to ``self.score_backend``; "cuda" runs the SIMT scoring
        kernel from ``kernels.dispatch_score`` on the card (float32, one
        warp per executor and two window rows),
        "numpy" the float64 BLAS path.  With ``apply=True``
        the incremental matrices are overwritten — the recovery path after
        adopting a pre-populated index snapshot.
        """
        backend = backend or self.score_backend
        rows, dm = self.demand_matrix()
        pb = self._presence.astype(np.float64)
        pw = self._presence_w
        if backend == "cuda":
            import torch
            from ..kernels.dispatch_score.ops import dispatch_scores
            dmc = torch.from_numpy(dm).to("cuda")
            sb = dispatch_scores(dmc, torch.from_numpy(
                pb.astype(np.float32)).to("cuda")).cpu().numpy()
            sw = dispatch_scores(dmc, torch.from_numpy(
                pw.astype(np.float32)).to("cuda")).cpu().numpy()
        else:
            sb = dm.astype(np.float64) @ pb.T
            sw = dm.astype(np.float64) @ pw.T
        if apply:
            self._Sb[rows] = np.rint(sb).astype(np.int32)
            self._Sw[rows] = sw.astype(np.float64)
            if self._mirror is not None:
                self._mirror.reseed()
        return sb, sw

    # -------------------------------------------------------- device mirror
    def attach_device_mirror(self, backend: str = "numpy",
                             device: str = "cuda"):
        """Install (or replace) the device-resident Sw shadow.

        ``backend="cuda"`` holds a float32 tensor on ``device`` updated per
        flush epoch by the rank-K CUDA kernel (``device="cpu"`` runs its
        plain version); ``backend="numpy"`` is the host float32 shadow.
        Returns the mirror; the caller owns the flush cadence (one flush
        per drain epoch is the intended shape).
        """
        from .device_mirror import DeviceScoreMirror
        self._mirror = DeviceScoreMirror(self, backend=backend,
                                         device=device)
        return self._mirror

    def check_consistency(self) -> bool:
        """Exact invariant check: the incremental Sb/Sw equal the one-shot
        matmul over the materialized bitmaps (numpy float64 path)."""
        rows, dm = self.demand_matrix()
        sb = dm.astype(np.float64) @ self._presence.astype(np.float64).T
        sw = dm.astype(np.float64) @ self._presence_w.T
        ok_b = np.array_equal(self._Sb[rows].astype(np.float64), sb)
        ok_w = bool(np.all(self._Sw[rows] == sw))
        return ok_b and ok_w
