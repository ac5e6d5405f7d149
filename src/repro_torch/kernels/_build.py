"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Every ``csrc/<name>.cu`` compiles on its own into
``build/kernels/lib<name>-<hash>.so`` at the repository root, where the hash
covers the source, the shared headers (``csrc/*.cuh``) and the flags: a
changed source rebuilds, an unchanged one is loaded as built.  All missing
libraries build at once, one ``nvcc`` per source started together.  The C
entry points take ``void*`` for pointers and the stream, ``int`` for
sizes and ``float`` for a scale, and return ``cudaGetLastError()``; ``check`` raises on anything but 0.
A kernel writes a fresh output through raw pointers, so autograd cannot see
through it: ``refuse_grad`` raises before a launch that would lose a
gradient.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from csrc/ with the CUDA toolkit")
    return found


def target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared by several sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every listed source whose library is missing, all in
    parallel.  Returns {name: seconds} for the sources it compiled; the
    ptxas report of each lands beside its library as ``.log``."""
    names = list(names) if names is not None else sources()
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = target(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    took: Dict[str, float] = {}
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>``, setting each entry point's
    argument types; every entry point returns a C int error code."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(target(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def refuse_grad(kernel: str, *operands) -> None:
    """Raise when grad mode is on and an operand requires grad.  The
    kernels have no backward and their outputs no ``grad_fn``: a launch
    would silently cut the graph.  Called on the CUDA path only; CPU
    tensors take the plain versions, which autograd differentiates.  The
    models train through their train route (``mode="train"``), which
    reaches no kernel."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in operands):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward and an input requires "
            "grad; call it under torch.no_grad(), or train through the model's "
            "train route (mode='train'), which runs the reference's plain ops "
            "and launches no kernel")


def refuse_dtensor(kernel: str, *operands) -> None:
    """Raise on a DTensor operand.  A kernel reads one device's memory:
    given a sharded tensor it would run on the local shard alone.  Called
    on the CUDA path only, beside ``refuse_grad``; the sharded train route
    reaches no kernel."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(x, DTensor) for x in operands):
        raise TypeError(
            f"{kernel}: the CUDA kernel takes plain tensors, and an input is a "
            "DTensor; kernels on the local shards of a mesh are not ported")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
