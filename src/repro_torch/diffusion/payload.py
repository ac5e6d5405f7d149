"""Payload plane: the actual KV bytes behind the tier-stack bookkeeping.

``TieredStore`` / ``TransferEngine`` account object *names and sizes* — the
modeled plane the DES and the router's decision path run on.  This module
adds the physical plane underneath: a ``PayloadBackend`` attached to a store
receives a callback for every placement change (admit / promote / demote /
drop) and moves the real tensors between physical homes:

  * ``hbm``  — torch tensors on the backend's device (the card by default;
    every timed edge that touches it is closed with
    ``torch.cuda.synchronize`` so the asynchronous CUDA queue cannot fake
    bandwidth);
  * ``dram`` — distinct CPU tensors (pageable host memory);
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
    ``time.perf_counter``.  A payload whose leaves are DTensors (a server
    under a mesh) moves each rank's local shard alone: the byte counts and
    the measured bandwidth are per rank, and ``value`` rebuilds each leaf
    as a DTensor with its mesh, placements and global shape; ``get`` hands
    out the local shards.

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
import torch

__all__ = [
    "MeasuredBandwidth",
    "PayloadBackend",
    "NullPayload",
    "FakePayload",
    "RealPayload",
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
    # numpy cannot view a CUDA or a bfloat16 tensor: count a tensor's bytes
    return float(sum(l.numel() * l.element_size() if isinstance(l, torch.Tensor)
                     else int(np.asarray(l).nbytes) for l in leaves))


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


class _SpilledLeaf:
    """One leaf's on-disk home: chunked raw files + per-chunk sha256."""

    __slots__ = ("dtype", "shape", "nbytes", "chunks")

    def __init__(self, dtype: str, shape: Tuple[int, ...], nbytes: int,
                 chunks: List[Tuple[str, str]]):
        self.dtype = dtype
        self.shape = shape
        self.nbytes = nbytes
        self.chunks = chunks            # [(path, sha256 hexdigest), ...]


def _copy_to(leaf: Any, device: torch.device) -> torch.Tensor:
    """A distinct contiguous copy of ``leaf`` (a tensor, or anything
    ``torch.as_tensor`` takes) on ``device``.  ``Tensor.to`` returns the
    tensor itself when it is already there, and ``.numpy()`` of a CPU tensor
    shares its storage: neither is a snapshot of a cache that decode then
    updates in place."""
    src = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
    return torch.empty(src.shape, dtype=src.dtype, device=device).copy_(src)


def _layout(leaf: Any):
    """(mesh, placements, shape, stride) of a DTensor leaf, else None."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        return (leaf.device_mesh, tuple(leaf.placements), leaf.shape, leaf.stride())
    return None


def _rebuild(local: torch.Tensor, layout) -> Any:
    """``local`` as the DTensor ``layout`` describes (or itself)."""
    if layout is None:
        return local
    from torch.distributed.tensor import DTensor
    mesh, placements, shape, stride = layout
    if local.device.type != mesh.device_type:
        local = local.to(mesh.device_type)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


class RealPayload(PayloadBackend):
    """Physical KV homes: torch tensors on ``device`` (hbm), CPU tensors
    (everything else), chunked spill files with verified digests (disk).

    Every home is a private copy: a put copies at any tier, a move copies,
    and ``get``/``value`` hand out copies, so no caller can write into what
    the backend holds (decode updates its caches in place).  Every timed
    edge that touches a CUDA device synchronizes before the clock stops —
    the measured bandwidth is the bytes actually landed, not the enqueue.
    """

    def __init__(
        self,
        name: str = "payload",
        measured: Optional[MeasuredBandwidth] = None,
        spill_dir: Optional[str] = None,
        chunk_bytes: int = 64 * 1024 * 1024,
        device: Any = "cuda",
        corrupt_mode: str = "raise",
    ):
        super().__init__(measured)
        if corrupt_mode not in ("raise", "recover"):
            raise ValueError(f"unknown corrupt_mode {corrupt_mode!r}")
        self.name = name
        self.spill_dir = spill_dir
        self.chunk_bytes = max(1, int(chunk_bytes))
        self.device = torch.device(device)
        # Serving-path degradation: "raise" surfaces a poisoned spill chunk
        # as IOError (checkpoint/training semantics — corrupt state halts);
        # "recover" drops the poisoned copy, fires ``on_corruption(obj)``
        # (the router quarantines the index entry and re-fetches from a
        # clean source), and the read returns None like a placeholder.
        self.corrupt_mode = corrupt_mode
        self.on_corruption: Optional[Callable[[str], None]] = None
        self.corruptions_recovered = 0
        self._tiers: Dict[str, str] = {}
        self._templates: Dict[str, Any] = {}
        self._layouts: Dict[str, List[Any]] = {}   # DTensor leaves' layouts
        # leaves: in-memory tensors (device or CPU), or _SpilledLeaf on disk
        self._leaves: Dict[str, List[Any]] = {}
        self._nbytes: Dict[str, float] = {}
        self._spill_seq = 0

    # -- physical homes -------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, leaves: List[Any]) -> List[torch.Tensor]:
        out = [_copy_to(l, self.device) for l in leaves]
        self._sync()                    # the bytes have landed
        return out

    def _to_host(self, obj: str) -> List[torch.Tensor]:
        """Materialize the current home into contiguous CPU tensors.

        Always a real copy: a "demotion" that aliased the device buffer (as
        ``Tensor.to("cpu")`` does for a CPU device) would be a free pointer
        cast and its measured bandwidth a lie — the DRAM home must be a
        distinct host buffer that survives the device copy being dropped."""
        leaves = self._leaves[obj]
        if leaves and isinstance(leaves[0], _SpilledLeaf):
            return [self._read_spilled(s) for s in leaves]
        return [_copy_to(l, torch.device("cpu")) for l in leaves]

    def _spill(self, obj: str, host: List[torch.Tensor]) -> List[_SpilledLeaf]:
        if self.spill_dir is None:
            raise ValueError(
                f"RealPayload {self.name!r}: disk tier used without spill_dir")
        from ..checkpoint.checkpointer import dtype_name, to_raw_bytes
        os.makedirs(self.spill_dir, exist_ok=True)
        out = []
        for t in host:
            raw = to_raw_bytes(t)
            chunks: List[Tuple[str, str]] = []
            for lo in range(0, max(1, raw.nbytes), self.chunk_bytes):
                piece = raw[lo:lo + self.chunk_bytes]
                self._spill_seq += 1
                path = os.path.join(
                    self.spill_dir, f"{self.name}.{self._spill_seq:08d}.kv")
                with open(path, "wb") as f:
                    f.write(piece)
                chunks.append((path, hashlib.sha256(piece).hexdigest()))
            out.append(_SpilledLeaf(dtype_name(t), tuple(t.shape),
                                    int(raw.nbytes), chunks))
        return out

    def _read_spilled(self, leaf: _SpilledLeaf) -> torch.Tensor:
        from ..checkpoint.checkpointer import from_raw_bytes
        parts = []
        for path, digest in leaf.chunks:
            with open(path, "rb") as f:
                data = f.read()
            if hashlib.sha256(data).hexdigest() != digest:
                raise IOError(f"KV spill chunk corrupt: {path}")
            parts.append(np.frombuffer(data, dtype=np.uint8))
        raw = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return from_raw_bytes(raw, leaf.dtype, leaf.shape)

    def _free_spill(self, leaves: List[Any]) -> None:
        for leaf in leaves:
            if isinstance(leaf, _SpilledLeaf):
                for path, _ in leaf.chunks:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass

    def _home(self, obj: str, host: List[torch.Tensor], tier: str) -> List[Any]:
        if tier == "hbm":
            return self._to_device(host)
        if tier == "disk":
            return self._spill(obj, host)
        return host

    # -- interface ------------------------------------------------------------
    def put(self, obj: str, value: Any, tier: str) -> None:
        """Register a copy of ``value``'s leaves at ``tier``; at hbm it
        returns once the bytes are on the device (callers time it)."""
        self.dropped(obj)               # re-put replaces (frees old spill)
        leaves: List[Any] = []
        template = _tree_leaves(value, leaves)
        layouts = [_layout(l) for l in leaves]
        if any(layouts):                # a rank holds and moves its shards
            self._layouts[obj] = layouts
            leaves = [l.to_local() if lay else l for l, lay in zip(leaves, layouts)]
        self._nbytes[obj] = _leaf_nbytes(leaves)
        self._templates[obj] = template
        if tier == "hbm":
            self._leaves[obj] = self._to_device(leaves)
        else:
            host = [_copy_to(l, torch.device("cpu")) for l in leaves]
            self._leaves[obj] = self._home(obj, host, tier)
        self._tiers[obj] = tier

    def _recover_corrupt(self, obj: str) -> None:
        """Poisoned spill copy: drop it (remaining chunks freed), notify the
        owner so the index entry quarantines and a re-fetch is queued."""
        self.corruptions_recovered += 1
        self.dropped(obj)
        if self.on_corruption is not None:
            self.on_corruption(obj)

    def get(self, obj: str) -> Optional[Any]:
        """Host (CPU tensor) copy of the payload; None for placeholders."""
        if obj not in self._leaves:
            return None
        try:
            host = self._to_host(obj)
        except IOError:
            if self.corrupt_mode != "recover":
                raise
            self._recover_corrupt(obj)
            return None                 # degrades to placeholder semantics
        return _tree_rebuild(self._templates[obj], host)

    def value(self, obj: str) -> Optional[Any]:
        """A copy of the payload in its *current* home (device tensors when
        resident in hbm) — what a decode step wants after a swap-in, and
        free for it to update in place."""
        if obj not in self._leaves:
            return None
        leaves = self._leaves[obj]
        if leaves and isinstance(leaves[0], _SpilledLeaf):
            try:
                leaves = [self._read_spilled(s) for s in leaves]
            except IOError:
                if self.corrupt_mode != "recover":
                    raise
                self._recover_corrupt(obj)
                return None
        else:
            leaves = [l.clone() for l in leaves]
        layouts = self._layouts.get(obj)
        if layouts:
            leaves = [_rebuild(l, lay) for l, lay in zip(leaves, layouts)]
        return _tree_rebuild(self._templates[obj], leaves)

    def has(self, obj: str) -> bool:
        return obj in self._leaves

    def tier_of(self, obj: str) -> Optional[str]:
        return self._tiers.get(obj)

    def nbytes(self, obj: str) -> float:
        return self._nbytes.get(obj, 0.0)

    def moved(self, obj: str, tier: str) -> None:
        src = self._tiers.get(obj)
        if src is None:
            self.placeholder_moves += 1
            return
        if src == tier:
            return
        old = self._leaves[obj]
        if "hbm" in (src, tier):
            # Unlike a JAX array's, a CUDA copy waits in the stream behind
            # whatever was queued before it (the tail of the last decode):
            # drain the queue first so the clock bills this move alone.
            self._sync()
        t0 = time.perf_counter()
        try:
            host = self._to_host(obj)   # verified read out of the old home
        except IOError:
            if self.corrupt_mode != "recover":
                raise
            self._recover_corrupt(obj)
            return                      # no move recorded; copy is gone
        self._leaves[obj] = self._home(obj, host, tier)
        dt = time.perf_counter() - t0
        self._free_spill(old)
        self._tiers[obj] = tier
        self.measured.record(src, tier, self._nbytes[obj], dt)

    def dropped(self, obj: str) -> None:
        leaves = self._leaves.pop(obj, None)
        if leaves:
            self._free_spill(leaves)
        self._tiers.pop(obj, None)
        self._templates.pop(obj, None)
        self._layouts.pop(obj, None)
        self._nbytes.pop(obj, None)
