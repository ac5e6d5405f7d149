"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake ranks.

The counterpart of the reference's ``launch/dryrun.py``.  For each cell:
a fake process group of the production mesh's 256 or 512 ranks
(``torch.distributed``'s ``"fake"`` backend: collectives complete without
moving data), the production mesh over it, params, optimizer state and
batch as ``FakeTensor``s laid out as DTensors by the sharding rules, then
one call of the cell's step under ``op_analysis.trace_step``, which counts
what rank 0 runs: flops, memory traffic and collective bytes per device,
and the step's peak memory (the stand-in for XLA's ``memory_analysis()``),
with the three roofline terms of one H100 beside them.  The loops over
time (the RWKV6 and RG-LRU recurrences) count by their trip counts, as the
reference's ``while`` loops do.

This is a shape-only analysis, as the reference's lowering on forced host
devices is: it allocates nothing on any device and has no ``--device``.
It traces on ``cpu`` FakeTensors, prefill attention through the chunked
``attention_core`` (``ShardCtx(flash=False)``, the reference's jnp route),
every other kernel call through its wrapper's plain version.
Importing this module starts no process group and changes no environment
variable (the reference sets ``XLA_FLAGS`` at import); ``run_cell`` starts
the fake group it needs and ends it.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --out artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..configs import SHAPES, all_archs, cells, get_arch
from ..models import init_opt_state, input_specs, make_step, param_specs
from ..models.sharding import tree_param_specs
from ..tree import tree_map
from .mesh import _mesh, make_ctx, make_production_mesh
from .op_analysis import CostSummary, group_axes, trace_step
from .rooflines import HBM_BW, IB_BW, NODE_CARDS, NVLINK_BW, PEAK_FLOPS
from .shardings import batch_specs, opt_state_specs, with_shardings


# A cell's trace stops past this many ops run (20-150 us an op on fake
# ranks).  The loops over time count by their trip counts and run three
# steps each (``trips.scan``), so no cell comes near it (rwkv6-3b x
# train_4k runs ~0.2 M ops, ~65 M with every step run); it guards a loop
# that is not marked.
MAX_OPS = 12_000_000


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS (global): 6*N*D train, 2*N*D inference."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def mesh_label(multi_pod: bool, mesh_shape: Optional[Tuple[int, ...]] = None) -> str:
    if mesh_shape is not None:
        return "x".join(str(n) for n in mesh_shape)
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of ``n`` ranks (this process is rank
    0) for the duration, ended on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fakes(specs):
    """Uninitialized FakeTensors of a ``Spec`` tree (the active fake mode)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype), specs)


def build_cell(arch_name: str, shape_name: str, multi_pod: bool, *,
               reduced: bool = False, mesh_shape: Optional[Tuple[int, ...]] = None):
    """(cfg, shape, mesh, step, args, donate) of one cell, inside a process
    group of the mesh's size.  ``reduced``: the arch's and shape's smoke
    sizes; ``mesh_shape``: a ("data", "model") mesh of that shape instead
    of the production mesh (tests)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, shape = get_arch(arch_name), SHAPES[shape_name]
    if reduced:
        cfg, shape = cfg.reduced(), shape.reduced()
    mesh = (make_production_mesh(multi_pod=multi_pod) if mesh_shape is None
            else _mesh(tuple(mesh_shape), ("data", "model")))
    ctx = dataclasses.replace(make_ctx(mesh), flash=False)
    pspecs, bspecs = param_specs(cfg), input_specs(cfg, shape)
    with FakeTensorMode():
        params = _fakes(pspecs)
        params_in = with_shardings(ctx, params, tree_param_specs(ctx, pspecs))
        batch = _fakes(bspecs)
        batch_in = with_shardings(ctx, batch, batch_specs(ctx, cfg, shape, bspecs))
        if "pos" in batch_in:
            batch_in["pos"] = shape.seq_len - 1     # a host int: the cache is full
        if shape.kind == "train":
            opt = init_opt_state(params, cfg)
            opt_in = with_shardings(ctx, opt, opt_state_specs(ctx, params, opt))
            args = (params_in, opt_in, batch_in)
        else:
            args = (params_in, batch_in)
    step = make_step(cfg, shape, ctx=ctx)
    donate = (0, 1) if shape.kind == "train" else ((1,) if shape.kind == "decode" else ())
    return cfg, shape, mesh, step, args, donate


def axis_link_bw(mesh, axis: str) -> float:
    """The link a collective over ``axis`` crosses: NVLink when the ranks
    along it (laid out row-major) share one 8-card node, else InfiniBand."""
    if axis not in mesh.mesh_dim_names:
        return IB_BW
    i = mesh.mesh_dim_names.index(axis)
    ranks = mesh.mesh.movedim(i, -1).reshape(-1, mesh.mesh.shape[i])[0].tolist()
    return NVLINK_BW if len({r // NODE_CARDS for r in ranks}) == 1 else IB_BW


def roofline_terms(hlo: CostSummary, mesh) -> Dict[str, float]:
    # compute term uses matmul (dot) FLOPs: elementwise work is
    # bandwidth-bound and therefore accounted by the memory term
    coll = sum(b / axis_link_bw(mesh, a) for a, b in hlo.collective_axis_bytes.items())
    return {"compute_s": hlo.dot_flops / PEAK_FLOPS, "memory_s": hlo.bytes / HBM_BW,
            "collective_s": coll}


def trace_cell(arch_name: str, shape_name: str, multi_pod: bool, *,
               reduced: bool = False, mesh_shape: Optional[Tuple[int, ...]] = None,
               regions=(), top: int = 20, max_ops: Optional[int] = MAX_OPS,
               trip_counts: bool = True):
    """Build a cell on fake ranks (a group started here and ended) and
    trace its step once (``trip_counts=False``: the loops over time run
    every step).  Returns (cfg, shape, mesh size, mesh shape, roofline
    terms, ``StepTrace``)."""
    n_dev = math.prod(mesh_shape) if mesh_shape else (512 if multi_pod else 256)
    with fake_world(n_dev):
        cfg, shape, mesh, fn, args, donate = build_cell(
            arch_name, shape_name, multi_pod, reduced=reduced, mesh_shape=mesh_shape)
        tr = trace_step(fn, *args, regions=regions, donate=donate, top=top,
                        axes=group_axes(mesh), max_ops=max_ops, trip_counts=trip_counts)
        return cfg, shape, mesh.size(), tuple(mesh.shape), roofline_terms(tr.total, mesh), tr


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             *, reduced: bool = False,
             mesh_shape: Optional[Tuple[int, ...]] = None) -> Dict[str, Any]:
    t0 = time.time()
    cfg, shape, n_dev, _, terms, tr = trace_cell(
        arch_name, shape_name, multi_pod, reduced=reduced, mesh_shape=mesh_shape)
    hlo, mem = tr.total, tr.memory
    mf = model_flops(cfg, shape)
    dominant = max(terms, key=terms.get)
    result = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh_label(multi_pod, mesh_shape),
        "devices": int(n_dev),
        "ok": True,
        "trace_s": round(time.time() - t0, 1),
        "ops": tr.ops,
        "memory": {k: mem[k] for k in ("argument_bytes", "output_bytes", "temp_bytes",
                                       "alias_bytes", "peak_device_bytes",
                                       "peak_device_gib", "eager_peak_bytes")},
        "hlo_analysis": hlo.to_dict(),
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / max(1.0, hlo.dot_flops),
        "roofline_terms_s": terms,
        "dominant_term": dominant,
        "step_time_bound_s": max(terms.values()),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if verbose:
        print(f"== {arch_name} x {shape_name} @ {result['mesh']} "
              f"(trace {result['trace_s']:.0f}s)")
        print(f"   memory: {result['memory']}")
        print(f"   ops: flops={hlo.flops:.3e} dot={hlo.dot_flops:.3e} "
              f"bytes={hlo.bytes:.3e} coll={hlo.total_collective_bytes:.3e} "
              f"({dict(hlo.collective_count)})")
        print(f"   terms: compute={terms['compute_s']:.4f}s "
              f"memory={terms['memory_s']:.4f}s "
              f"collective={terms['collective_s']:.4f}s -> {dominant}")
        print(f"   useful_flops_ratio={result['useful_flops_ratio']:.3f} "
              f"peak_dev={result['memory']['peak_device_gib']} GiB")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    todo = []
    if args.all:
        for name, cfg in all_archs().items():
            for s in cells(cfg):
                todo.append((name, s.name))
    else:
        todo.append((args.arch, args.shape))

    failures = 0
    for arch_name, shape_name in todo:
        for mp in meshes:
            tag = f"{arch_name}_{shape_name}_{'mp' if mp else 'sp'}".replace(".", "_")
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"skip {tag} (exists)")
                continue
            try:
                res = run_cell(arch_name, shape_name, mp)
            except Exception as e:  # noqa: BLE001 — record and continue
                failures += 1
                res = {"arch": arch_name, "shape": shape_name,
                       "mesh": mesh_label(mp), "ok": False,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                print(f"!! FAIL {tag}: {res['error']}")
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            gc.collect()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
