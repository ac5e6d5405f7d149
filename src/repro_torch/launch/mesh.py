"""Device meshes over the ranks of a ``torch.distributed`` process group.

A port of the reference's ``launch/mesh.py``.  Functions, not module
constants, so importing touches no process group.  The production meshes
are the reference's: one pod, (16, 16) ranks on ("data", "model"); two
pods, (2, 16, 16) on ("pod", "data", "model"), 'pod' carrying data
parallelism across the pod boundary.  They are built only on a process
group of exactly that many ranks.  ``make_host_mesh`` spans whatever
ranks the group has (tests, examples, the launcher's ``--mesh host``).

``init_process_group`` starts a group when none exists: from ``torchrun``'s
environment when it is set, else a world of one on a TCP store of a free
local port; NCCL for the card, gloo for the CPU.  ``torchrun
--master-port 0`` binds its own store to a free port but hands every worker
``MASTER_PORT=0``, on which ``env://`` then waits for ever; that
environment is refused with a message instead.
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import torch
import torch.distributed as dist

from ..models.sharding import ShardCtx


def init_process_group(device="cuda") -> bool:
    """Start the default process group unless one exists; True when this
    call started it (the caller then ends it)."""
    if dist.is_initialized():
        return False
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", device.index or 0)))
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if os.environ.get("MASTER_PORT", "").strip() == "0":
            raise RuntimeError(
                "MASTER_PORT is 0: torchrun --master-port 0 gives its workers "
                "port 0, not the port its store bound, and joining it would "
                "hang; pass a fixed free port (--master-port 29533)")
        dist.init_process_group(backend)                 # torchrun's env://
    else:
        store = dist.TCPStore("localhost", 0, 1, is_master=True)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return True


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"the production mesh {shape} over {axes} needs a process group of "
            f"{need} ranks; this one has {have}")
    return _mesh(shape, axes)


def make_ctx(mesh) -> ShardCtx:
    names = mesh.mesh_dim_names
    dp = ("pod", "data") if "pod" in names else ("data",)
    return ShardCtx(mesh=mesh, dp_axes=dp, tp_axis="model")


def make_host_mesh(n_devices: int = 0, model_axis: int = 1):
    """("data", "model") mesh of (n // model_axis, model_axis) over the
    process group's ranks (tests / examples / ``--mesh host``)."""
    n = n_devices or dist.get_world_size()
    assert n % model_axis == 0
    return _mesh((n // model_axis, model_axis), ("data", "model"))
