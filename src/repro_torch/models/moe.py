"""Mixture-of-Experts FFN on torch: capacity-based dispatch on one device.

A port of ``moe_ffn`` in the reference's ``models/moe.py`` (the mesh-free
path): the router's softmax with renormalised top-k, the stable rank of
each assignment within its expert, the k-sliced scatter into an [E, C, D]
capacity buffer, SwiGLU experts, and the gated gather back.  Assignments
past an expert's capacity are dropped (their slot is clipped to C-1 and
they add zero), so their tokens fall through the residual, as in GShard.

The scatter accumulates (``index_add_``), as the reference's ``.at[].add``
does: a dropped entry shares its clipped slot with a kept one, and a plain
index assignment would let its zero overwrite the kept row.

Serving (``train=False``) runs the experts through the grouped-GEMM kernel
(``kernels.moe_gmm``).  Each expert's fill, ``min(assignments, C)``, goes to
the three GEMMs as ``counts``: rows at and past it are empty, so the kernel
skips them and reads no weights of an expert that holds no token.  A
dropped assignment is clipped to slot C-1 only in an expert whose fill is
C, so every row the gather reads lies below its expert's fill.  The counts
are summed on the device by ``scatter_add_`` (``torch.bincount`` reads its
input's maximum back to the host on CUDA), so the FFN makes no host sync
for them.

Training (``train=True``) follows the reference's train path, which never
reaches its Pallas kernel: the experts are the three einsums of its
``_expert_mlp`` with ``preferred_element_type=F32``, written here on
f32-upcast operands (a bf16 product is exact in f32), so autograd
differentiates them on the CPU and on the card alike.  The kernel has no
backward.  No fill mask is needed there: the empty rows of the buffer are
zero and stay zero through the SwiGLU.

``moe_ffn_sharded`` is the reference's row x column expert parallelism
(its ``shard_map`` path), written as explicit per-rank code on the local
shards of DTensors: rank (i, j) of a ("data", "model") mesh takes data-row
i's tokens and model-column j's E/tp experts, ranks only its local
assignments (the rest go to overflow slot C of a C+1-wide buffer, with C
from the *local* token count), runs the reference's three einsums in f32,
and the partial outputs are reduce-scattered over "model" along the
sequence dim (``dist.reduce_scatter_tensor``).  Routing and the aux term
run on the local rows; aux is averaged over "model" and then over "data".
The gated sum of the K expert outputs runs in f32 and is rounded once to
the tokens' dtype, as in ``moe_ffn``: the reference writes it as a bf16
sum, which its jitted step (XLA keeps the fused chain in f32 by default)
does not round K times either; op by op in bf16 it moved the first loss
of olmoe-1b-7b at full width 3.7e-3 from the unsharded path (an NVIDIA
H100, ``chip_smoke.py``'s mesh phase).
The partial outputs cross ranks in the tokens' dtype, as the reference's
``psum_scatter`` does.  In training (``train=True``) it runs the reference's
einsums and reaches no kernel, as the reference's sharded path does; in
serving each rank runs the grouped-GEMM kernel on its local [E/tp, C, D]
buffer with its experts' fills, as ``moe_ffn`` does on one device.  The
gradients of
the replicated operands (the row's tokens, the router, the experts over
"data") are partial sums on each rank, summed by DTensor.

Where the model axis cannot split the tokens (a decode step, S < tp),
serving lays the capacity buffer out as the reference's GSPMD path does,
experts over "model" and slots over "data" (``_moe_ffn_blocks``): every
rank routes all T tokens alike and runs the kernel on its own block.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.moe_gmm.ops import moe_gmm
from .layers import F32, dense_init
from ..tree import tree_map
from .sharding import P, ShardCtx, is_dtensor


def moe_init(gen, d_model: int, d_ff: int, n_experts: int, lead=()):
    return {
        "router": dense_init(gen, (d_model, n_experts), dtype=F32, lead=lead),
        "experts": {
            "w1": dense_init(gen, (n_experts, d_model, d_ff), lead=lead),   # gate
            "w3": dense_init(gen, (n_experts, d_model, d_ff), lead=lead),   # up
            "w2": dense_init(gen, (n_experts, d_ff, d_model), lead=lead),   # down
        },
    }


def capacity(T: int, top_k: int, n_experts: int, factor: float,
             multiple: int = 8) -> int:
    c = int(math.ceil(T * top_k / n_experts * factor))
    return max(multiple, ((c + multiple - 1) // multiple) * multiple)


def _rank_positions(flat_e):
    """Stable rank of each entry within its bucket (argsort + searchsorted)."""
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=flat_e.device) - first
    return pos


def _router(p, x2d, top_k: int):
    logits = x2d.to(F32) @ p["router"].to(F32)                        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)            # [T, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def _expert_counts(flat_e, n_experts: int):
    """Assignments per expert, int32 [E], summed on the device."""
    ones = torch.ones_like(flat_e, dtype=torch.int32)
    return torch.zeros(n_experts, dtype=torch.int32,
                       device=flat_e.device).scatter_add_(0, flat_e, ones)


def _aux_loss(probs, counts, n_assignments: int):
    f_e = counts.to(F32) / n_assignments
    return counts.numel() * torch.sum(f_e * probs.mean(dim=0))


def _expert_mlp(w, buf, counts=None, train=False):
    """buf: [E, C, D] -> [E, C, D] through SwiGLU experts, the gate and up
    products kept in fp32 and the down product rounded to buf's dtype, where
    the reference's einsums round.  Serving: three grouped GEMMs, rows at
    and past ``counts[e]`` come out 0.  Training: the reference's einsums,
    summed in fp32 on upcast operands."""
    if train:
        bf = buf.to(F32)
        g = torch.einsum("ecd,edf->ecf", bf, w["w1"].to(F32))
        u = torch.einsum("ecd,edf->ecf", bf, w["w3"].to(F32))
        h = (F.silu(g) * u).to(buf.dtype)
        return torch.einsum("ecf,efd->ecd", h.to(F32), w["w2"].to(F32)).to(buf.dtype)
    g = moe_gmm(buf, w["w1"], out_dtype=F32, counts=counts)
    u = moe_gmm(buf, w["w3"], out_dtype=F32, counts=counts)
    h = (F.silu(g) * u).to(buf.dtype)
    return moe_gmm(h, w["w2"], counts=counts)


def _dispatch(p, x2d, E: int, K: int, C: int):
    """Routing of x2d's T tokens into a capacity-C buffer: (gate values and
    expert ids [T, K], each expert's fill ``min(assigned, C)``, aux, and the
    keep flag and slot of each of the T * K picks)."""
    T = x2d.shape[0]
    probs, gate_vals, gate_idx = _router(p, x2d, K)
    flat_e = gate_idx.reshape(T * K)
    assigned = _expert_counts(flat_e, E)
    aux = _aux_loss(probs, assigned, T * K)
    pos = _rank_positions(flat_e)
    return (gate_vals, gate_idx, torch.clamp(assigned, max=C), aux, pos < C,
            torch.clamp(pos, 0, C - 1))


def moe_ffn(p, x2d, *, n_experts: int, top_k: int, capacity_factor: float,
            train: bool = False, ctx: ShardCtx = ShardCtx()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d: [T, D] -> ([T, D], aux).  ``train``: the experts run the
    reference's einsums instead of the kernel.  Given DTensors (a mesh
    whose model axis ``moe_ffn_sharded`` cannot split the tokens over:
    a decode step), serving runs each rank's block of the capacity buffer
    (``_moe_ffn_blocks``, on ``ctx``'s mesh), as the reference lays it
    out; training, which no cell reaches there, runs the whole dispatch on
    replicated operands on every rank."""
    if is_dtensor(x2d):
        if not train:
            return _moe_ffn_blocks(p, x2d, n_experts=n_experts, top_k=top_k,
                                   capacity_factor=capacity_factor, ctx=ctx)
        return _replicated(moe_ffn, p, x2d, n_experts=n_experts, top_k=top_k,
                           capacity_factor=capacity_factor, train=train)
    T, D = x2d.shape
    E, K = n_experts, top_k
    C = capacity(T, K, E, capacity_factor)
    gate_vals, gate_idx, fill, aux, keep, slot = _dispatch(p, x2d, E, K, C)
    flat_e = gate_idx.reshape(T * K)
    row = flat_e * C + slot                                           # into [E*C]

    buf = torch.zeros((E * C, D), dtype=x2d.dtype, device=x2d.device)
    zero = torch.zeros((), dtype=x2d.dtype, device=x2d.device)
    for k in range(K):      # k-sliced scatters cap the transient at [T, D]
        buf.index_add_(0, row[k::K], torch.where(keep[k::K, None], x2d, zero))
    y = _expert_mlp(p["experts"], buf.view(E, C, D), fill, train).view(E * C, D)
    out = torch.zeros((T, D), dtype=F32, device=x2d.device)
    for k in range(K):
        w = (gate_vals[:, k] * keep[k::K]).to(F32)
        out = out + y[row[k::K]].to(F32) * w[:, None]
    return out.to(x2d.dtype), aux


def _moe_ffn_blocks(p, x2d, *, n_experts: int, top_k: int, capacity_factor: float,
                    ctx: ShardCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` in serving on DTensors, laid out as the reference's
    GSPMD path lays its capacity buffer out (``cstr(buf, "tp", "dp",
    None)``).  Every rank gathers the T tokens and routes them all alike:
    the gates, slots, fills and aux of one device.  Rank (i, j) keeps the
    kept picks that fall in its block of the [E, C, D] buffer, experts over
    'tp' and slots over 'dp', each split as DTensor's ``Shard`` splits a
    dim (``ShardCtx.span``; a rank past the last chunk holds an empty
    block and launches nothing), and runs K4 on it with each expert's fill
    less the block's first slot.  Each weight gathers its FSDP dim over
    'dp' only; no expert crosses 'tp'.  The f32 contributions of the
    block's picks are summed over every rank (another order of addition
    than one device's), and each 'dp' row keeps its own tokens, laid out as
    ``x2d`` was."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = ctx.mesh
    T, D = x2d.shape
    E, K = n_experts, top_k
    C = capacity(T, K, E, capacity_factor)
    every = [Replicate()] * mesh.ndim
    x = x2d.redistribute(mesh, every).to_local()                     # the T tokens
    router = p["router"].redistribute(mesh, every).to_local()
    gate_vals, gate_idx, fill, aux, keep, slot = _dispatch({"router": router}, x, E, K, C)

    e_lo, n_e = ctx.span(ctx.tp_axis, E)
    c_lo, n_c = ctx.span(ctx.dp_axes, C)
    out = torch.zeros((T, D), dtype=F32, device=x.device)
    if n_e and n_c:
        w = {k: _block_experts(ctx, p["experts"][k], e_lo, n_e) for k in ("w1", "w3", "w2")}
        flat_e = gate_idx.reshape(T * K)
        mine = (keep & (flat_e >= e_lo) & (flat_e < e_lo + n_e)
                & (slot >= c_lo) & (slot < c_lo + n_c))
        n = n_e * n_c
        # the block's picks, in order; every other pick lands in row n,
        # sliced off before the GEMMs
        row = torch.where(mine, (flat_e - e_lo) * n_c + slot - c_lo,
                          torch.full_like(flat_e, n))
        buf = torch.zeros((n + 1, D), dtype=x.dtype, device=x.device)
        for k in range(K):
            buf.index_add_(0, row[k::K], x)
        y = _expert_mlp(w, buf[:n].view(n_e, n_c, D),
                        torch.clamp(fill[e_lo:e_lo + n_e] - c_lo, 0, n_c)).view(n, D)
        row = torch.clamp(row, max=n - 1)
        for k in range(K):
            wk = (gate_vals[:, k] * mine[k::K]).to(F32)
            out = out + y[row[k::K]].to(F32) * wk[:, None]
    out = DTensor.from_local(out, mesh, [Partial()] * mesh.ndim, run_check=False,
                             shape=torch.Size((T, D)), stride=(D, 1))
    out = out.redistribute(mesh, x2d.placements).to(x2d.dtype)
    return out, DTensor.from_local(aux, mesh, every, run_check=False)


def _block_experts(ctx: ShardCtx, w, e_lo: int, n_e: int):
    """Experts [e_lo, e_lo + n_e) of an expert weight [E, ., .], its FSDP
    dim gathered over 'dp' (the other mesh axes); split over 'tp' when E
    divides it, else whole on every rank and sliced here."""
    from torch.distributed.tensor import Replicate, Shard

    names = ctx.mesh.mesh_dim_names
    want = [p if a == ctx.tp_axis else Replicate() for a, p in zip(names, w.placements)]
    local = w.redistribute(ctx.mesh, want).to_local()
    if not isinstance(w.placements[names.index(ctx.tp_axis)], Shard):
        local = local[e_lo:e_lo + n_e]
    return local.contiguous()


def _replicated(fn, p, x, **kw):
    """``fn`` on the whole values of DTensors ``p`` and ``x``, the same on
    every rank; its outputs as replicated DTensors.  Every rank's grad is
    then the whole grad, as ``Replicate`` says."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim

    def whole(t):
        return t.redistribute(mesh, rep).to_local() if is_dtensor(t) else t

    outs = fn(tree_map(whole, p), whole(x), **kw)
    return tuple(DTensor.from_local(o, mesh, rep, run_check=False) for o in outs)


# ------------------------------------------------- row x column expert parallelism
class _ReduceScatterDim1(torch.autograd.Function):
    """Sum over ``group``, each rank keeping its 1/n slice of dim 1 (the
    reference's ``psum_scatter(scatter_dimension=1, tiled=True)``); the
    backward all-gathers that slice."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        n = dist.get_world_size(group)
        xt = x.transpose(0, 1).contiguous()                  # scatter on dim 0
        out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, xt, group=group)
        return out.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        n = dist.get_world_size(ctx.group)
        gt = g.transpose(0, 1).contiguous()
        full = torch.empty((gt.shape[0] * n,) + tuple(gt.shape[1:]),
                           dtype=g.dtype, device=g.device)
        dist.all_gather_into_tensor(full, gt, group=ctx.group)
        return full.transpose(0, 1).contiguous(), None


class _MeanOver(torch.autograd.Function):
    """The mean of a per-rank value over ``groups`` in turn (the reference's
    ``pmean``).  The result is the same on every rank, and so is its
    cotangent, so each rank's input gets 1/n of it."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist

        out = x.clone()
        n = 1
        for g in groups:
            dist.all_reduce(out, group=g)
            n *= dist.get_world_size(g)
        ctx.n = n
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _local_in(ctx: ShardCtx, x, spec, grad_spec):
    """The local shard of DTensor ``x`` laid out by ``spec``; its grad comes
    back laid out by ``grad_spec`` (Partial on the mesh axes the shard is
    replicated over but the per-rank code reads only part of)."""
    from torch.distributed.tensor import Partial

    x = x.redistribute(ctx.mesh, ctx.placements(spec))
    grad = [Partial() if a in grad_spec else p
            for a, p in zip(ctx.mesh.mesh_dim_names, x.placements)]
    return x.to_local(grad_placements=grad)


def moe_ffn_sharded(p, x, *, n_experts: int, top_k: int, capacity_factor: float,
                    ctx: ShardCtx, train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] DTensor.  Returns ([B, S, D] DTensor sharded (dp, tp,
    None), replicated f32 aux).

    Row x column EP: rank (i, j) processes dp-row i's tokens for tp-column
    j's experts; the partial outputs reduce-scatter over 'tp'.  ``train``:
    the reference's einsums; else the kernel on the local experts.
    """
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ctx.mesh
    E, K = n_experts, top_k
    tp = ctx.tp_axis
    tp_size = ctx.tp
    assert E % tp_size == 0, (E, tp_size)
    E_loc = E // tp_size
    dp_spec = ctx._resolve("dp", x.shape[0])
    dp_names = (() if dp_spec is None else
                (dp_spec,) if isinstance(dp_spec, str) else tuple(dp_spec))
    every = tuple(mesh.mesh_dim_names)

    xl = _local_in(ctx, x, P(dp_spec, None, None), (tp,))           # row tokens
    router_w = _local_in(ctx, p["router"], P(None, None), every)
    w = {k: _local_in(ctx, p["experts"][k], P(tp, None, None),
                      tuple(a for a in every if a != tp))
         for k in ("w1", "w3", "w2")}

    B_loc, S, D = xl.shape
    T = B_loc * S
    x2 = xl.reshape(T, D)
    probs, gate_vals, gate_idx = _router({"router": router_w}, x2, K)
    aux = _aux_loss(probs, _expert_counts(gate_idx.reshape(T * K), E), T * K)
    aux = _MeanOver.apply(aux, [mesh.get_group(tp)]
                          + [mesh.get_group(a) for a in dp_names])

    e_lo = mesh.get_local_rank(tp) * E_loc
    local = (gate_idx >= e_lo) & (gate_idx < e_lo + E_loc)           # [T, K]
    C = capacity(T, K, E, capacity_factor)
    # rank only local assignments; non-local entries go to bucket E_loc
    flat_e = torch.where(local, gate_idx - e_lo,
                         torch.full_like(gate_idx, E_loc)).reshape(T * K)
    pos = _rank_positions(flat_e)
    keep = (flat_e < E_loc) & (pos < C)
    # dropped and non-local entries land in overflow slot C of a C+1-wide
    # buffer, sliced off before the GEMMs
    slot = torch.where(keep, torch.clamp(pos, 0, C - 1), torch.full_like(pos, C))
    eid = torch.clamp(flat_e, 0, E_loc - 1)
    row = eid * (C + 1) + slot                                       # into [E_loc*(C+1)]

    buf = torch.zeros((E_loc * (C + 1), D), dtype=x2.dtype, device=x2.device)
    for k in range(K):
        buf = buf.index_add(0, row[k::K], x2)
    if train:
        y = _expert_mlp(w, buf.view(E_loc, C + 1, D)[:, :C], train=True)
    else:
        # kept entries fill slots 0 .. fill - 1 of their expert
        fill = torch.clamp(_expert_counts(torch.where(keep, flat_e, E_loc),
                                          E_loc + 1)[:E_loc], max=C)
        y = _expert_mlp({k: v.contiguous() for k, v in w.items()},
                        buf.view(E_loc, C + 1, D)[:, :C].contiguous(), fill)
    # the gated sum in f32, rounded once (``moe_ffn``'s sum, and what XLA's
    # fusion makes of the reference's bf16 one)
    out = torch.zeros((T, D), dtype=F32, device=x2.device)
    for k in range(K):
        wk = (gate_vals[:, k] * keep[k::K]).to(F32)
        yk = y[eid[k::K], torch.clamp(slot[k::K], 0, C - 1)]
        out = out + yk.to(F32) * wk[:, None]
    out = out.to(x2.dtype).reshape(B_loc, S, D)
    # partial sums over expert columns -> the seq-sharded residual
    out = _ReduceScatterDim1.apply(out, mesh.get_group(tp))
    out = DTensor.from_local(out, mesh, ctx.placements(P(dp_spec, tp, None)),
                             run_check=False)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return out, aux
