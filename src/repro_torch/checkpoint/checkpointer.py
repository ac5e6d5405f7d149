"""Sharded, atomic, async checkpointing of torch tensor trees.

A port of the reference's ``checkpoint/checkpointer.py`` with the same
on-disk layout, so a checkpoint crosses between the two packages in both
directions:

  <dir>/step_<n:08d>/
      manifest.json       — leaf paths, shapes, dtypes, file map
      arrays_<i>.npz      — raw bytes of the flattened leaves, split into
                            files of about ``MAX_FILE_BYTES``
      _COMMITTED          — atomic commit marker (written last)

  * atomic commit: readers only trust ``_COMMITTED`` checkpoints;
  * async save: every leaf is copied to host memory on the caller's thread
    (torch tensors change in place, so the copy is the snapshot), then a
    writer thread writes the files;
  * integrity: a sha256 per file in the manifest, verified on restore;
  * restore lands each leaf on the device of the matching leaf of the
    target tree, cast to its dtype, or, given ``shardings``, places it
    under the current mesh: elastic resharding, a checkpoint saved under
    one mesh shape restored under another;
  * sharded trees: each DTensor leaf is gathered whole on every rank
    (``full_tensor``), rank 0 writes, and every rank meets at a barrier
    once the write is committed, so the files are those of an unsharded
    save.

Leaves are stored as raw bytes with numpy's dtype names (``"bfloat16"``,
``"float32"``, ``"int32"`` ...); bfloat16 travels as its bit pattern, so no
bf16 numpy dtype is needed on this side.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.sharding import full, is_dtensor
from ..tree import tree_flatten_with_paths

MAX_FILE_BYTES = 1 << 28  # 256 MiB per npz member group

_STEP_DIR = re.compile(r"step_(\d+)")


# -- the raw-byte codec (shared with the KV spill of diffusion.payload) -------

def dtype_name(x: Any) -> str:
    """numpy's name for the dtype of a tensor or array (``"bfloat16"``)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def to_raw_bytes(x: Any) -> np.ndarray:
    """Flat ``uint8`` numpy view of the bytes of ``x`` (a torch tensor on any
    device, or a numpy array), in C order.  CUDA tensors come to the host;
    a contiguous CPU tensor or array is viewed, not copied."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def from_raw_bytes(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """CPU tensor of ``dtype`` (a numpy dtype name) and ``shape`` from the
    bytes ``to_raw_bytes`` gave."""
    raw = np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
    if not raw.flags.writeable:         # torch tensors may not wrap read-only memory
        raw = raw.copy()
    return torch.from_numpy(raw).view(getattr(torch, dtype)).reshape(tuple(shape))


# -- save ---------------------------------------------------------------------

class _Writer(threading.Thread):
    """The async writer; ``join()`` re-raises what the write raised, and,
    for a sharded save, then meets the other ranks at the barrier."""

    def __init__(self, write: Callable[[], str], barrier: bool = False):
        super().__init__(daemon=True)
        self._write = write
        self._barrier = barrier
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._write()
        except BaseException as e:      # re-raised on the joining thread
            self.error = e

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise self.error
        if self._barrier:
            _Barrier().join()


def _host_snapshot(leaf: Any) -> Tuple[str, List[int], np.ndarray]:
    """(dtype name, shape, raw bytes) of a private host copy of ``leaf``
    (a DTensor gathered whole first: a collective)."""
    if isinstance(leaf, torch.Tensor):
        t = full(leaf.detach())
        copy = torch.empty(t.shape, dtype=t.dtype, device="cpu").copy_(t)
        return dtype_name(copy), list(copy.shape), to_raw_bytes(copy)
    arr = np.array(leaf, copy=True)
    return dtype_name(arr), list(arr.shape), to_raw_bytes(arr)


def _sharded(leaves) -> bool:
    return any(is_dtensor(l) for l in leaves)


class _Barrier:
    """What a rank other than 0 holds for a sharded save: nothing to write;
    ``join`` meets rank 0 at the barrier after its commit."""

    def join(self, timeout: Optional[float] = None) -> None:
        import torch.distributed as dist

        dist.barrier()


def save_checkpoint(directory: str, step: int, tree, *, blocking: bool = True):
    """Write checkpoint for ``step``.  Returns the checkpoint path, or the
    started writer thread when ``blocking=False``.  A tree with DTensor
    leaves is saved by every rank of their mesh together: all gather, rank
    0 writes, and all meet at a barrier when it has committed (on return
    when blocking, else on ``join`` of what this returns)."""
    paths, leaves, _ = tree_flatten_with_paths(tree)
    sharded = _sharded(leaves)
    # Snapshot now: the caller may change its tensors in place (the next
    # optimizer step, a decode step) as soon as this returns.
    host_leaves = [_host_snapshot(l) for l in leaves]
    if sharded:
        import torch.distributed as dist

        if dist.get_rank() != 0:
            if blocking:
                _Barrier().join()
                return os.path.join(directory, f"step_{step:08d}")
            return _Barrier()

    def write() -> str:
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        manifest: Dict[str, Any] = {"step": step, "leaves": [], "files": {}}
        file_idx, file_bytes, bucket = 0, 0, {}

        def flush():
            nonlocal file_idx, file_bytes, bucket
            if not bucket:
                return
            fname = f"arrays_{file_idx}.npz"
            fpath = os.path.join(tmp, fname)
            np.savez(fpath, **bucket)
            with open(fpath, "rb") as f:
                manifest["files"][fname] = hashlib.sha256(f.read()).hexdigest()
            file_idx += 1
            file_bytes = 0
            bucket = {}

        for i, (path, (dtype, shape, raw)) in enumerate(zip(paths, host_leaves)):
            key = f"a{i}"
            manifest["leaves"].append(
                {"path": path, "key": key, "file": file_idx,
                 "shape": shape, "dtype": dtype})
            bucket[key] = raw
            file_bytes += raw.nbytes
            if file_bytes >= MAX_FILE_BYTES:
                flush()
        flush()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write(str(time.time()))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        return final

    if blocking:
        path = write()
        if sharded:
            _Barrier().join()
        return path
    t = _Writer(write, barrier=sharded)
    t.start()
    return t


class AsyncCheckpointer:
    """Serializes async saves; ``wait()`` joins the in-flight write and
    raises what it raised."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._inflight: Optional[Any] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree) -> None:
        self.wait()
        self._inflight = save_checkpoint(self.directory, step, tree, blocking=False)
        self._gc()

    def wait(self) -> None:
        if self._inflight is not None:
            inflight, self._inflight = self._inflight, None
            inflight.join()

    def _gc(self) -> None:
        if isinstance(self._inflight, _Barrier):
            return                      # a sharded save: rank 0 collects
        steps = sorted(list_checkpoints(self.directory))
        for s in steps[: -self.keep] if len(steps) > self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)


def list_checkpoints(directory: str) -> List[int]:
    """Committed steps, sorted.  Only names of the form ``step_<digits>``
    count: unlike the reference, which parses every ``step_*`` name, an
    in-flight ``step_<n>.tmp`` directory is skipped instead of raising."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_DIR.fullmatch(name)
        if m and os.path.exists(os.path.join(directory, name, "_COMMITTED")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[int]:
    steps = list_checkpoints(directory)
    return steps[-1] if steps else None


# -- restore ------------------------------------------------------------------

def _target_dtype(leaf: Any, stored: torch.dtype) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    if hasattr(leaf, "dtype"):          # numpy arrays, by dtype name
        return getattr(torch, np.dtype(leaf.dtype).name)
    return stored


def _sharding_by_path(shardings) -> Dict[str, Any]:
    """{path: NamedSharding or None} of a shardings tree, whose None
    leaves (replicate / leave as is) the tree walkers would drop."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], prefix + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + (str(i),))
        else:
            out["/".join(prefix)] = node

    walk(shardings, ())
    return out


def restore_checkpoint(directory: str, step: int, target_tree,
                       shardings=None, verify: bool = True):
    """Restore into the structure of ``target_tree``: each leaf lands on the
    device of its target leaf (CPU for non-tensors), cast to the target
    leaf's dtype.  ``shardings`` (a tree of the target's structure, of
    ``NamedSharding`` or None) re-places each leaf under the current mesh:
    the elastic-resharding path, where the mesh differs from the one the
    checkpoint was saved under."""
    ckpt = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(ckpt, "_COMMITTED")):
        raise FileNotFoundError(f"no committed checkpoint at {ckpt}")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    if verify:
        for fname, digest in manifest["files"].items():
            with open(os.path.join(ckpt, fname), "rb") as f:
                actual = hashlib.sha256(f.read()).hexdigest()
            if actual != digest:
                raise IOError(f"checksum mismatch in {fname}")

    by_file: Dict[int, List[dict]] = {}
    for entry in manifest["leaves"]:
        by_file.setdefault(entry["file"], []).append(entry)
    path_to_t: Dict[str, torch.Tensor] = {}
    for fidx, entries in by_file.items():
        with np.load(os.path.join(ckpt, f"arrays_{fidx}.npz")) as data:
            for e in entries:
                path_to_t[e["path"]] = from_raw_bytes(data[e["key"]], e["dtype"],
                                                      e["shape"])

    paths, leaves, unflatten = tree_flatten_with_paths(target_tree)
    placed = _sharding_by_path(shardings) if shardings is not None else {}
    out = []
    for path, leaf in zip(paths, leaves):
        if path not in path_to_t:
            raise KeyError(f"checkpoint missing leaf {path}")
        t = path_to_t[path].to(dtype=_target_dtype(leaf, path_to_t[path].dtype))
        sh = placed.get(path)
        if sh is not None:
            out.append(sh.place(t.to(sh.mesh.device_type)))
        else:
            dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            out.append(t.to(device=dev))
    return unflatten(out)
