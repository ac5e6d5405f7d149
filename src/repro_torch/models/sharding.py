"""Logical-axis sharding for the port's model code, on torch DTensors.

A port of the reference's ``models/sharding.py``.  Models annotate
activations with *logical* dims ('dp' batch-ish, 'tp' tensor-ish, 'dptp',
None); the context maps them to the axes of a named
``torch.distributed.device_mesh.DeviceMesh`` and drops any assignment that
does not divide its dim, which then stays replicated.  Param shardings come
from tree paths (FSDP over 'dp' x Megatron column/row over 'tp').

A spec is the port's ``P``: a tuple with one entry per tensor dim, each a
mesh-axis name, a tuple of names, or None, equal element for element to the
reference's ``PartitionSpec``.  ``placements`` turns it into one DTensor
``Shard(d)`` / ``Replicate()`` per mesh dim (the counterpart of
``NamedSharding``), and ``cstr`` redistributes a DTensor to it (the
counterpart of ``with_sharding_constraint``); a plain tensor, or any tensor
under the no-op context (``mesh=None``), passes through unchanged.

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``), or, for building specs without a process group, any
object whose ``shape`` maps axis names to sizes.
"""

from __future__ import annotations

import contextlib
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..tree import tree_flatten_with_paths


class P(tuple):
    """A partition spec: ``P("data", None)`` -> ("data", None)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a size-only fake mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


@dataclass(frozen=True)
class ShardCtx:
    """Maps logical dims to mesh axes; None mesh = no-op (single device)."""

    mesh: Optional[Any] = None
    dp_axes: Tuple[str, ...] = ("data",)     # ('pod','data') on multi-pod
    tp_axis: str = "model"
    # False: prefill and cross-attention run the chunked ``attention_core``
    # instead of the flash kernel, the route the reference's dry run lowers.
    # The port's dry run traces FakeTensors, where the kernel's plain
    # version would stand in, and it holds every [Sq, Skv] score (32 GiB a
    # layer and rank at 32k positions), which the kernel never does.
    flash: bool = True

    def axis_size(self, axes) -> int:
        if self.mesh is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        sizes = mesh_sizes(self.mesh)
        n = 1
        for a in axes:
            n *= sizes[a]
        return n

    @property
    def dp(self) -> int:
        return self.axis_size(self.dp_axes)

    @property
    def tp(self) -> int:
        return self.axis_size(self.tp_axis)

    def _resolve(self, logical, size: int):
        """logical in {None,'dp','tp','dptp'} -> mesh axes or None (guarded)."""
        if logical is None or self.mesh is None:
            return None
        if logical == "dp":
            axes: Tuple[str, ...] = tuple(self.dp_axes)
        elif logical == "tp":
            axes = (self.tp_axis,)
        elif logical == "dptp":
            axes = tuple(self.dp_axes) + (self.tp_axis,)
        else:
            raise ValueError(f"unknown logical axis {logical!r}")
        if size % self.axis_size(axes) != 0:
            return None  # would not divide: replicate instead
        return axes if len(axes) > 1 else axes[0]

    def span(self, axes, size: int) -> Tuple[int, int]:
        """(first index, length) of this rank's chunk of a dim of ``size``
        split over mesh ``axes`` (a name or names, outer first) as DTensor's
        ``Shard`` splits it, ``torch.chunk`` on each axis in turn: a size
        that does not divide leaves the last ranks less or nothing.  (0,
        size) without a mesh."""
        start = 0
        if self.mesh is None:
            return start, size
        sizes = mesh_sizes(self.mesh)
        for a in ((axes,) if isinstance(axes, str) else axes):
            chunk, i = -(-size // sizes[a]), self.mesh.get_local_rank(a)
            start += i * chunk
            size = max(0, min(chunk, size - i * chunk))
        return start, size

    def spec(self, logical_dims: Sequence, shape: Sequence[int]) -> P:
        return P(*[self._resolve(l, s) for l, s in zip(logical_dims, shape)])

    def placements(self, spec: Sequence):
        """One DTensor placement per mesh dim for ``spec``: ``Shard(d)``
        on each axis of more than one rank that tensor dim d is split
        over, ``Replicate()`` on the others (on an axis of one rank the two
        hold the same data, and a replicated dim is one DTensor never has
        to gather before a reshape)."""
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.mesh_dim_names)
        sizes = mesh_sizes(self.mesh)
        out = [Replicate()] * len(names)
        for d, axes in enumerate(spec):
            if axes is None:
                continue
            for a in ((axes,) if isinstance(axes, str) else axes):
                if sizes[a] > 1:
                    out[names.index(a)] = Shard(d)
        return tuple(out)

    def cstr(self, x, *logical_dims):
        """Lay a DTensor out by logical dims, and its cotangent too, as the
        transpose of ``with_sharding_constraint`` does: a partial grad is
        summed here, before it meets a cast to bf16 further back (no-op
        w/o mesh, and on a plain tensor)."""
        if self.mesh is None or not is_dtensor(x):
            return x
        want = self.placements(self.spec(logical_dims, x.shape))
        if tuple(x.placements) != want:
            x = x.redistribute(self.mesh, want)
        return _GradLayout.apply(x, want)

    def named(self, spec: Sequence) -> Optional["NamedSharding"]:
        return None if self.mesh is None else NamedSharding(
            self.mesh, self.placements(spec))

    def scope(self):
        """Where plain tensors (positions, masks, fresh buffers: the same on
        every rank) may meet DTensors as replicated ones; a no-op context
        without a mesh."""
        return contextlib.nullcontext() if self.mesh is None else _replicating()

    def replicate(self, x):
        """A plain tensor made the same on every rank, as a replicated
        DTensor on the mesh (no-op w/o mesh or on a DTensor)."""
        if self.mesh is None or is_dtensor(x):
            return x
        from torch.distributed.tensor import DTensor, Replicate

        return DTensor.from_local(x, self.mesh, [Replicate()] * self.mesh.ndim,
                                  run_check=False)

    def local_call(self, fn, operands, in_layouts, out_layouts, grad_partial=()):
        """``fn``, a kernel entry point that takes plain tensors, run on each
        rank's local shards.  Each operand (a DTensor, a plain tensor that
        is the same on every rank, or None) is laid out by its logical dims
        in ``in_layouts``: a dim the kernel is independent along (batch,
        heads, width) may stay sharded, every other dim is gathered.  ``fn``
        gets the ``to_local()`` tensors, and each of its outputs comes back
        as a DTensor laid out by its ``(logical dims, global shape)`` in
        ``out_layouts``.  ``grad_partial`` names, for each operand, the mesh
        axes its local grad is a partial sum over (it is replicated there,
        and ``fn`` reads part of it on each rank).  Without a mesh:
        ``fn(*operands)``."""
        if self.mesh is None:
            return fn(*operands)
        from torch.distributed.tensor import DTensor, Partial

        local_ops = []
        for i, (x, logical) in enumerate(zip(operands, in_layouts)):
            if x is not None:
                x = self.replicate(x)
                want = self.placements(self.spec(logical, x.shape))
                if tuple(x.placements) != want:
                    x = x.redistribute(self.mesh, want)
                partial = grad_partial[i] if i < len(grad_partial) else ()
                x = x.to_local(grad_placements=[
                    Partial() if a in partial else p
                    for a, p in zip(self.mesh.mesh_dim_names, x.placements)])
            local_ops.append(x)
        outs = fn(*local_ops)
        single = not isinstance(outs, tuple)
        wrapped = tuple(
            DTensor.from_local(o.contiguous(), self.mesh,
                               self.placements(self.spec(logical, shape)),
                               run_check=False, shape=torch.Size(shape),
                               stride=torch.empty(shape, device="meta").stride())
            for o, (logical, shape) in zip((outs,) if single else outs, out_layouts))
        return wrapped[0] if single else wrapped


class _GradLayout(torch.autograd.Function):
    """Identity; its backward lays the incoming grad out as ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


_scope_depth = 0


@contextlib.contextmanager
def _replicating():
    """``implicit_replication``, made re-entrant: its exit clears a global
    flag, so only the outermost scope enters it (backward runs after an
    inner scope, the loss function's own, has closed)."""
    global _scope_depth
    from torch.distributed.tensor.experimental import implicit_replication

    _scope_depth += 1
    try:
        if _scope_depth > 1:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _scope_depth -= 1


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and the DTensor placements of one spec on it (a tree leaf)."""

    mesh: Any
    placements: Tuple[Any, ...]

    def place(self, x: torch.Tensor):
        """``x`` (the same whole tensor on every rank) laid out here."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(full(x).detach(), self.mesh, self.placements)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def unshard_dim(x, dim: int):
    """A DTensor gathered along tensor dim ``dim`` (its other placements
    kept), or ``x`` itself: for ops that cannot split a sharded dim."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.ndim
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(x.device_mesh, want)


def reshape(x, *shape):
    """``x.reshape(shape)``; a DTensor first gathers every dim it shards
    from the first dim the reshape changes on (DTensor cannot split or
    merge a dim that is not evenly sharded), its leading dims kept.  A
    merge of dims ``i..j`` into one keeps dim ``i``'s shards where they
    divide it evenly (the merged dim is then sharded as ``i`` was, as the
    reference's attention output [B, S, H, Dh] -> [B, S, H * Dh] stays
    split by heads before the row-parallel output product)."""
    if is_dtensor(x):
        i = 0
        while i < min(x.ndim, len(shape)) and x.shape[i] == shape[i]:
            i += 1
        j = x.ndim - (len(shape) - i - 1)       # a merge of dims i..j-1
        ways = math.prod(n for n, p in zip(x.device_mesh.shape, x.placements)
                         if p.is_shard(i))
        keep = (i < len(shape) and j > i + 1 and math.prod(x.shape[i:j]) == shape[i]
                and tuple(x.shape[j:]) == tuple(shape[i + 1:]) and x.shape[i] % ways == 0)
        for d in range(i + 1 if keep else i, j if keep else x.ndim):
            x = unshard_dim(x, d)
    return x.reshape(*shape)


def mm(x, w):
    """``x @ w`` for activations ``x`` [..., D] and a weight [D, F].  A
    DTensor ``x`` first gathers every dim it shards between its first and
    its last (the sequence, over 'tp'): the all-gather before a
    column-parallel matmul that the reference's compiled step makes, and
    one torch 2.11's DTensor needs, since it refuses to flatten [B, S, D]
    to [B * S, D] with S sharded.  The sums are those of ``x @ w``."""
    if not is_dtensor(x):
        return x @ w
    x = gather_inner(x)
    if is_dtensor(w):
        # FSDP: a weight gathers its shards over the axes the batch is split
        # on (as the reference's compiled step does), so that no operand is
        # split two ways on one axis; torch 2.11's DTensor otherwise asks
        # for a redistribute from Shard to Partial that it does not have
        from torch.distributed.tensor import Replicate, Shard

        batch = {m for m, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == 0}
        want = [Replicate() if m in batch else p for m, p in enumerate(w.placements)]
        if want != list(w.placements):
            w = w.redistribute(w.device_mesh, want)
    return _InnerWholeGrad.apply(x @ w)


def einsum(equation: str, *operands):
    """``torch.einsum`` for batched products whose operands are sharded on
    their first dim at most: every other dim of a DTensor operand, and of
    the result's cotangent, is gathered first (torch 2.11's DTensor
    refuses to flatten two batch dims of which a later one is sharded).
    The sums are those of ``torch.einsum``."""
    if not any(is_dtensor(x) for x in operands):
        return torch.einsum(equation, *operands)
    operands = [gather_inner(x, last=True) for x in operands]
    return _InnerWholeGrad.apply(torch.einsum(equation, *operands), True)


def gather_inner(x, last: bool = False):
    """Activations [B, S, ..., D] with every dim after the first (but the
    last, unless ``last``) gathered, or ``x`` itself when not a DTensor.
    Called once on an input that several matmuls read (``mm`` then gathers
    nothing), so that in backward their partial input grads are summed
    before one reduction, as on the layout DTensor propagates itself."""
    if is_dtensor(x):
        for d in range(1, x.ndim if last else x.ndim - 1):
            x = unshard_dim(x, d)
    return x


class _InnerWholeGrad(torch.autograd.Function):
    """Identity; its backward gathers the cotangent's dims as
    ``gather_inner`` does, so that the product's backward flattens no
    sharded inner dim either."""

    @staticmethod
    def forward(ctx, y, last=False):
        ctx.last = last
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return gather_inner(g, ctx.last), None


def gather_last(x, index):
    """``torch.gather(x, -1, index[..., None])[..., 0]``: for each position
    the entry of ``x``'s last dim that ``index`` names.  A DTensor ``x``
    whole along its last dim picks on each rank's own rows (``index`` laid
    out as ``x``'s leading dims), so that its grad is local too: DTensor's
    own gather backward builds a zero buffer of the global shape of ``x``
    on every rank (a [B, chunk, vocab] f32 of the loss a chunk)."""
    placements = getattr(x, "placements", ())
    if not is_dtensor(x) or any(p.is_partial() or (p.is_shard() and p.dim >= x.ndim - 1)
                                for p in placements):
        return torch.gather(x, -1, index[..., None].long())[..., 0]
    from torch.distributed.tensor import DTensor

    picked = torch.gather(x.to_local(), -1, _as_layout(
        index, x.device_mesh, list(placements)).to_local()[..., None].long())[..., 0]
    return DTensor.from_local(picked, x.device_mesh, placements, run_check=False,
                              shape=index.shape, stride=torch.empty(
                                  tuple(index.shape), device="meta").stride())


def laid_like(x, ref):
    """DTensor ``x`` redistributed to ``ref``'s placements (a partial grad
    summed into its param's layout), or ``x`` itself."""
    if is_dtensor(x) and is_dtensor(ref) and tuple(x.placements) != tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def local(x):
    """The local shard of a DTensor, or ``x`` itself."""
    return x.to_local() if is_dtensor(x) else x


def shard_span(x, dim: int) -> Tuple[int, int]:
    """(first index, length) of DTensor ``x``'s local shard along ``dim``,
    by ``torch.chunk``'s split, which is DTensor's ``Shard``."""
    from torch.distributed.tensor import Shard

    dim = dim % x.ndim
    start, size = 0, x.shape[dim]
    coord = x.device_mesh.get_coordinate()
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // x.device_mesh.size(m))
            start += coord[m] * chunk
            size = max(0, min(chunk, size - coord[m] * chunk))
    return start, size


def _laid_without(value, buf, dim: int):
    """``value`` (``buf`` without its dim ``dim``; plain tensors are the same
    on every rank) as a DTensor on ``buf``'s mesh, sharded as ``buf`` is
    on every other dim."""
    from torch.distributed.tensor import Replicate, Shard

    want = []
    for p in buf.placements:
        if isinstance(p, Shard) and p.dim == dim:
            p = Replicate()
        elif isinstance(p, Shard) and p.dim > dim:
            p = Shard(p.dim - 1)
        want.append(p)
    return _as_layout(value, buf.device_mesh, want)


def write_slot(buf, dim: int, index: int, value) -> None:
    """``buf.select(dim, index).copy_(value)``, in place.  For a DTensor
    ``buf`` the rank whose shard holds ``index`` writes its part of
    ``value`` into its local shard and the others write nothing; the
    buffer is never gathered."""
    if not is_dtensor(buf):
        buf.select(dim, index).copy_(value)
        return
    dim = dim % buf.ndim
    value = _laid_without(value, buf, dim).to_local()
    start, size = shard_span(buf, dim)
    if start <= index < start + size:
        buf.to_local().select(dim, index - start).copy_(value)


def write_prefix(buf, dim: int, value) -> None:
    """``buf.narrow(dim, 0, n).copy_(value)`` for ``value`` of length n <=
    ``buf.shape[dim]`` along ``dim``, in place.  For a DTensor ``buf`` each
    rank copies the positions its shard of ``buf`` holds: ``value`` is
    gathered along ``dim`` (its other dims laid out as ``buf``'s), the
    buffer never."""
    dim = dim % buf.ndim
    n = value.shape[dim]
    if not is_dtensor(buf):
        buf.narrow(dim, 0, n).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard

    start, size = shard_span(buf, dim)
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in buf.placements]
    value = _as_layout(value, buf.device_mesh, want)
    lo, hi = start, min(start + size, n)
    if hi > lo:
        buf.to_local().narrow(dim, 0, hi - lo).copy_(
            value.to_local().narrow(dim, lo, hi - lo))


def copy_into(dst, src) -> None:
    """``dst.copy_(src)`` in place; for a DTensor ``dst``, ``src`` is laid
    out as ``dst`` first and each rank copies its own shard."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    dst.to_local().copy_(_as_layout(src, dst.device_mesh, list(dst.placements))
                         .to_local())


def _as_layout(x, mesh, placements):
    """``x`` (a DTensor, or a plain tensor the same on every rank) as a
    DTensor on ``mesh`` with ``placements``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return x if list(x.placements) == list(placements) else x.redistribute(
        mesh, placements)


def full(x):
    """The whole (gathered) value of a DTensor on every rank, or ``x``."""
    return x.full_tensor() if is_dtensor(x) else x


# --------------------------------------------------------------------------
# Parameter sharding by tree path (FSDP on dp x tensor-parallel on tp).
# --------------------------------------------------------------------------

_LAST2_RULES = (
    # (path regex, (logical for dim -2, logical for dim -1))
    (r"embed",            ("tp", "dp")),    # [V, D] vocab-sharded
    (r"lm_head",          ("dp", "tp")),    # [D, V]
    (r"pos_embed",        (None, "dp")),    # [maxpos, D]
    (r"(wo|w_down|out_proj|w2)$", ("tp", "dp")),  # row-parallel
    (r"router",           ("dp", None)),
    (r"conv",             (None, "tp")),
    (r".*",               ("dp", "tp")),    # default column-parallel
)


def spec_for_param(ctx: ShardCtx, path: str, shape: Tuple[int, ...]) -> P:
    if len(shape) == 0:
        return P()
    if len(shape) == 1:
        return P(None)
    for pat, (a, b) in _LAST2_RULES:
        if re.search(pat, path):
            lead = [None] * (len(shape) - 2)
            # MoE 3D weights: shard experts dim (axis -3) on tp, switch the
            # matmul dims to (dp, None)/(None, dp).
            if len(shape) >= 3 and re.search(r"(w1|w2|w3|wi|wg)$", path) and "experts" in path:
                lead = [None] * (len(shape) - 3) + ["tp"]
                a2, b2 = ("dp", None) if path.endswith(("w1", "w3", "wi", "wg")) else (None, "dp")
                return ctx.spec(lead + [a2, b2], shape)
            return ctx.spec(lead + [a, b], shape)
    return P(*([None] * len(shape)))


def tree_param_specs(ctx: ShardCtx, params) -> Any:
    """P tree mirroring ``params`` (tensors, or anything with a shape);
    the paths are the reference's ``tree_map_with_path`` keys."""
    paths, leaves, unflatten = tree_flatten_with_paths(params)
    return unflatten([spec_for_param(ctx, p, tuple(l.shape))
                      for p, l in zip(paths, leaves)])


def map_specs(fn, specs):
    """``fn`` over the P leaves of a spec tree (a P is a tuple, so the
    tree walkers of ``tree.py`` would take it apart)."""
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        out = [map_specs(fn, v) for v in specs]
        return tuple(out) if isinstance(specs, tuple) else out
    return specs


def spec_leaves(specs) -> list:
    """The P leaves of a spec tree, in ``tree_leaves`` order (dict keys
    sorted)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [s for v in specs for s in spec_leaves(v)]
    return []


def tree_shardings(ctx: ShardCtx, params) -> Any:
    """NamedSharding tree for ``params`` (None leaves without a mesh)."""
    _, _, unflatten = tree_flatten_with_paths(params)
    return unflatten([ctx.named(s) for s in spec_leaves(tree_param_specs(ctx, params))])


def distribute(ctx: ShardCtx, x: torch.Tensor, spec: Sequence):
    """``x`` (the same whole tensor on every rank) as a DTensor laid out by
    ``spec``; ``x`` itself without a mesh."""
    return x if ctx.mesh is None else ctx.named(spec).place(x)


def distribute_tree(ctx: ShardCtx, tree, specs):
    """Each leaf of ``tree`` distributed by its P in the spec tree."""
    _, leaves, unflatten = tree_flatten_with_paths(tree)
    return unflatten([distribute(ctx, x, s)
                      for x, s in zip(leaves, spec_leaves(specs))])
