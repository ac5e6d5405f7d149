"""Op-level cost analysis of one step: flops, memory traffic and collective
bytes per device, with region attribution and the step's peak memory.

The counterpart of the reference's ``launch/hlo_analysis.py``, which parses
the compiled, partitioned HLO of a jitted step.  There is no HLO here: the
step runs eagerly (on ``FakeTensor``s for the dry run, so nothing is
allocated) under a ``TorchDispatchMode`` that sees every aten op one rank
runs, and counts it.

* **Per device.** An op on DTensors reaches the mode first as the DTensor
  op; the mode declines it (``NotImplemented``), DTensor's handler runs the
  **local** op, collectives included, and the mode counts that.  On a cache
  miss DTensor's sharding propagator also runs the op once on global-shape
  fake tensors to infer its output's metadata, and torch 2.13 may run its
  decomposition on a fake mesh to infer a strategy; ops run inside
  ``ShardingPropagator._propagate_tensor_meta_non_cached`` or
  ``DecompShardingStrategy.propagate_strategy`` are never counted.
* **Flops.** ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
  baddbmm, einsum's products, convolutions, attention) give ``dot_flops``;
  every other op adds one operation per output element to ``flops``, and
  exp, log, tanh, sigmoid, rsqrt and softmax elements are
  ``transcendentals``.
* **Loops.** A plain Python loop is counted once per iteration.  A loop
  marked through ``repro_torch.trips.scan`` (the recurrences over time:
  ``wkv_scan``, ``wkv_chunked``, ``rglru_scan`` and the two scans' plain
  versions) runs its first, second and last steps, and the second's ops,
  forward and backward, count for steps 1 to n - 2: everything above, the
  collectives and the region's sums multiplied by n - 2, as the reference
  multiplies a ``while`` body by its ``known_trip_count``.  Nested marked
  loops multiply.  A backward op takes the multiplier of the step whose
  node it runs (autograd sequence numbers), a checkpointed chunk's
  recompute that of the node that asked for it.  ``ops`` stays the number
  of ops run.  ``trip_counts=False`` runs every step instead.
* **Bytes.** Eager PyTorch does not fuse: each op reads its operands and
  writes its outputs, and that is its traffic on the card.  ``bytes`` is the
  sum over ops of operand bytes plus output bytes; view and alias ops
  (``view``, ``reshape`` of a contiguous tensor, ``transpose``, ``expand``,
  ``slice``, ``detach``, ``t``, ``as_strided``), the profiler's ops and a
  ``copy_`` onto itself count zero.  This is the port's real eager traffic,
  not the reference's fusion-boundary model, on purpose.  The reference's
  ``bytes_bf16_native`` corrects XLA:CPU's f32 promotion of bf16 dots; eager
  torch does not promote, so there is nothing to correct and no such field.
* **Collectives.** The functional collectives (``_c10d_functional.*``,
  ``c10d_functional.*``) the local ops issue, by the reference's kinds
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``); bytes are the operand bytes on this rank, kept
  per kind and per mesh axis (the link each crosses).  A Shard -> Shard
  redistribute is counted as the one ``all-to-all`` a card issues: on a CPU
  mesh DTensor runs it as an all-gather plus a chunk (gloo has no
  all-to-all), so inside ``_collective_utils.shard_dim_alltoall`` the
  collective is counted as an all-to-all of its input and the rest of the
  fallback not at all.
* **Regions.** ``torch.profiler.record_function`` scopes in the models
  (``attn_scores``, ``wkv_scan``, ``rglru_rec``, the reference's
  ``jax.named_scope`` names) reach the mode as profiler ops.  An op goes to
  the innermost open region asked for; a backward op outside any open region
  goes to the region its forward node was made in (autograd sequence
  numbers), so a checkpointed chunk's recompute and its grads stay inside.
* **Memory.** XLA's ``memory_analysis()`` has no equal; the mode tracks the
  live storage of every tensor the step makes (a finalizer on each storage)
  and takes its high-water mark over the step, beside the bytes of the
  arguments and outputs.  What a marked loop's second step still holds at
  the end of its last step (the saved tensors every step would hold)
  counts n - 2 times until it is freed; its carry-out's copies live as
  long as its carry-in.  Donated arguments count once: a new output of
  the shape and dtype of a donated argument's leaf takes that leaf's
  storage, as XLA's buffer aliasing does.
"""

from __future__ import annotations

import contextlib
import sys
import time
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import trips
from ..tree import tree_leaves

_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")
_KIND_BY_PREFIX = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
                   ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
                   ("shard_dim_alltoall", "all-to-all"), ("permute", "collective-permute"),
                   ("broadcast", "broadcast"))
_TRANSCENDENTAL = {"exp", "exp_", "log", "log_", "tanh", "tanh_", "sigmoid", "sigmoid_",
                   "rsqrt", "rsqrt_", "_softmax", "_log_softmax"}
# ops that move no bytes: aliases that the schema does not mark as views,
# allocations that write nothing, and the collectives' completion
_ZERO_BYTES = {"_unsafe_view", "lift_fresh", "empty", "empty_strided", "empty_like",
               "new_empty", "new_empty_strided", "wait_tensor"}
# ops that read only the rows they pick (their traffic: what they write,
# twice, and the indices), and in-place writes of rows (their source, twice)
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
_SCATTERS_ = {"index_put_", "_index_put_impl_", "scatter_", "scatter_add_", "index_add_",
              "index_copy_"}
# (function, file) of DTensor's shape inference (torch 2.13 also infers a
# strategy by running an op's decomposition on a fake mesh) and of its
# Shard -> Shard move
_SHADOW = (("_propagate_tensor_meta_non_cached", "_sharding_prop.py"),
           ("propagate_strategy", "_decompositions.py"))
_ALLTOALL = ("shard_dim_alltoall", "_collective_utils.py")


@dataclass
class CostSummary:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    collective_count: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    dot_flops: float = 0.0
    # collective operand bytes by the mesh axis (or axes) of their group
    collective_axis_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "dot_flops": self.dot_flops,
            "transcendentals": self.transcendentals,
            "collective_bytes": dict(self.collective_bytes),
            "collective_count": dict(self.collective_count),
            "collective_axis_bytes": dict(self.collective_axis_bytes),
            "total_collective_bytes": self.total_collective_bytes,
        }


class TraceBudgetExceeded(RuntimeError):
    """A traced step ran more ops than it was allowed."""


@dataclass
class StepTrace:
    """What one traced step gives: the totals, the regions asked for (plus
    'other'), the top traffic keys, the memory (bytes per device), the
    trace's wall seconds and the ops counted."""

    total: CostSummary
    regions: Dict[str, CostSummary]
    breakdown: List[Tuple[str, float, int]]
    memory: Dict[str, float]
    seconds: float
    ops: int


def _local(x):
    from torch.distributed.tensor import DTensor

    return x._local_tensor if isinstance(x, DTensor) else x


def _tensors(tree) -> List[torch.Tensor]:
    """The local tensors among ``tree``'s leaves (DTensors unwrapped)."""
    return [_local(x) for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _flat_tensors(obj) -> List[torch.Tensor]:
    """Tensors in an op's args / outputs (nested lists and tuples)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _flat_tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _flat_tensors(o)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _collective_kind(func) -> Optional[str]:
    if func.namespace not in _COLLECTIVE_NS:
        return None
    name = func._opname
    for prefix, kind in _KIND_BY_PREFIX:
        if name.startswith(prefix):
            return kind
    return None


def _within() -> Tuple[bool, bool]:
    """(inside DTensor's shape inference, inside its Shard -> Shard move)."""
    shadow = alltoall = False
    f = sys._getframe(2)
    while f is not None:
        c = f.f_code
        if any(c.co_name == n and c.co_filename.endswith(p) for n, p in _SHADOW):
            shadow = True
            break
        if c.co_name == _ALLTOALL[0] and c.co_filename.endswith(_ALLTOALL[1]):
            alltoall = True
        f = f.f_back
    return shadow, alltoall


def group_axes(mesh) -> Dict[str, str]:
    """{process-group name: mesh axis name} for each axis of a DeviceMesh."""
    if mesh is None:
        return {}
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}


class _Counter(TorchDispatchMode):
    """Counts the local ops of one step; see the module docstring."""

    def __init__(self, regions: Sequence[str] = (), axes: Optional[Dict[str, str]] = None,
                 max_ops: Optional[int] = None):
        super().__init__()
        self.ops, self.max_ops = 0, max_ops
        self.names = set(regions)
        self.total = CostSummary()
        self.regions = {r: CostSummary() for r in regions}
        self.regions["other"] = CostSummary()
        self.axes = axes or {}
        self.traffic: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.open: List[list] = []          # [name, interval index or None]
        self.intervals: List[list] = []     # [first seq, end seq, name, parent]
        # marked loops: the multiplier of each counted step running now
        # (innermost last); [first seq, end seq, multiplier, parent] of each
        # counted step's autograd nodes; the open ones' indices
        self.dyn: List[int] = []
        self.trip_ivs: List[list] = []
        self.open_trips: List[int] = []
        # a skipped step's stand-in runs: not counted (True: its outputs
        # are still live memory); None: count
        self.skipping: Optional[bool] = None
        # memory: storages the step allocated, live bytes after each allocation
        self.inputs: set = set()
        self.live: Dict[int, int] = {}
        self.alloc_at: Dict[int, int] = {}
        self.born: Dict[int, int] = {}      # storage -> its place in ``born_order``
        self.born_order: List[int] = []
        self.series: List[int] = []
        self.live_bytes = 0

    # ----------------------------------------------------------- regions
    def _enter(self, name):
        """Regions nest (context managers), so an exit closes the innermost
        open one; only those asked for get an interval of sequence numbers."""
        iv = None
        if name in self.names and torch.is_grad_enabled():
            parent = next((o[1] for o in reversed(self.open) if o[1] is not None), -1)
            iv = len(self.intervals)
            self.intervals.append([torch._C._autograd._get_sequence_nr(), None, name,
                                   parent])
        self.open.append([name, iv])

    def _exit(self):
        if self.open:
            iv = self.open.pop()[1]
            if iv is not None:
                self.intervals[iv][1] = torch._C._autograd._get_sequence_nr()

    def _region(self) -> str:
        inner = next((o[0] for o in reversed(self.open) if o[0] in self.names), None)
        if inner is not None:
            return inner
        node = torch._C._current_autograd_node()
        if node is None or not self.intervals:
            return "other"
        i = _innermost(self.intervals, node._sequence_nr())
        return self.intervals[i][2] if i >= 0 else "other"

    # ------------------------------------------------------- marked loops
    def _mult(self) -> int:
        """How many steps the op stands for: the innermost counted step
        running now, else the one whose autograd node runs (backward, or a
        checkpointed chunk's recompute that node asked for)."""
        if self.dyn:
            return self.dyn[-1]
        node = torch._C._current_autograd_node()
        if node is None or not self.trip_ivs:
            return 1
        i = _innermost(self.trip_ivs, node._sequence_nr())
        return self.trip_ivs[i][2] if i >= 0 else 1

    @contextlib.contextmanager
    def trip(self, k: int, carry):
        """Around the step of a marked loop that stands for ``k`` steps, given
        its carry-in.  Yields the mark ``carried`` and ``retain`` take:
        [first allocation, end, k, carry-in storages, carry-out storages]."""
        m = self._mult() * k
        iv = None
        if torch.is_grad_enabled():
            parent = next((i for i in reversed(self.open_trips) if i is not None), -1)
            iv = len(self.trip_ivs)
            self.trip_ivs.append([torch._C._autograd._get_sequence_nr(), None, m, parent])
        self.dyn.append(m)
        self.open_trips.append(iv)
        mark = [len(self.born_order), None, k, {_key(t) for t in _tensors(carry)}, set()]
        try:
            yield mark
        finally:
            self.dyn.pop()
            self.open_trips.pop()
            if iv is not None:
                self.trip_ivs[iv][1] = torch._C._autograd._get_sequence_nr()
            mark[1] = len(self.born_order)

    @contextlib.contextmanager
    def quiet(self, track: bool):
        prev, self.skipping = self.skipping, track
        try:
            yield
        finally:
            self.skipping = prev

    def carried(self, mark, carry):
        """The counted step's carry-out (storages only: holding the tensors
        would keep them live)."""
        mark[4] = {_key(t) for t in _tensors(carry)}

    def retain(self, mark):
        """What the counted step allocated and is still live at the end of
        the loop's last step (its saved tensors, an output not yet stacked)
        counts ``k`` times, and all copies go when it is freed.  Its
        carry-out is the exception: the last step holds it, and the copies
        of steps 1 to n - 3 are held by the steps after them, as the
        counted step holds its carry-in, so they live as long as that."""
        first, end, k, into, outs = mark
        add = 0
        for idx in range(first, end):
            key = self.born_order[idx]
            if self.born.get(key) != idx or key not in self.live:
                continue
            if key in outs:
                held = [c for c in into if c in self.live and self.born[c] < first]
                if held:
                    extra = self.live[key] * (k - 1) // len(held)
                    for c in held:
                        self.live[c] += extra
                        add += extra
                continue
            extra = self.live[key] * (k - 1)
            self.live[key] += extra
            add += extra
        if add:
            self.live_bytes += add
            self.series.append(self.live_bytes)

    # ------------------------------------------------------------ memory
    def _free(self, key):
        self.live_bytes -= self.live.pop(key, 0)

    def _track(self, outs):
        for t in outs:
            st = t.untyped_storage()
            k = st._cdata
            if k in self.live or k in self.inputs:
                continue
            n = st.nbytes()
            self.live[k] = n
            self.alloc_at[k] = len(self.series)
            self.born[k] = len(self.born_order)
            self.born_order.append(k)
            self.live_bytes += n
            self.series.append(self.live_bytes)
            weakref.finalize(st, self._free, k)

    # ------------------------------------------------------------ counting
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor runs the local op: count that
        name = func._opname
        if func.namespace == "profiler":
            out = func(*args, **kwargs)
            if name.startswith("_record_function_enter"):
                self._enter(args[0])
            elif name.startswith("_record_function_exit"):
                self._exit()
            return out
        out = func(*args, **kwargs)
        if self.skipping is not None:        # a skipped step's stand-in
            if self.skipping and not func.is_view:
                self._track(_flat_tensors(out))
            return out
        shadow, alltoall = _within()
        if shadow:
            return out
        kind = _collective_kind(func)
        if alltoall and kind is None:
            # the CPU fallback's chunk of the gathered tensor: the card's
            # all-to-all writes its output directly
            if not (func.is_view or name in _ZERO_BYTES):
                self._track(_flat_tensors(out))
            return out
        if alltoall:
            kind = "all-to-all"
        self._count(func, name, kind, args, kwargs, out, alltoall)
        return out

    def _count(self, func, name, kind, args, kwargs, out, alltoall):
        self.ops += 1
        if self.max_ops is not None and self.ops > self.max_ops:
            raise TraceBudgetExceeded(f"the step runs more than {self.max_ops} ops")
        region = self._region() if self.names else "other"
        m = self._mult()
        sums = (self.total, self.regions[region])
        ins = _flat_tensors(args) + _flat_tensors(kwargs)
        outs = _flat_tensors(out)
        if func.is_view or name in _ZERO_BYTES or not outs:
            return                           # no output: a metadata query (device, size)
        if name == "copy_":                  # writes its first operand, reads the second
            if _same_view(ins[0], ins[1]):
                return
            ins = ins[1:]
        in_b = sum(_nbytes(t) for t in {id(t): t for t in ins}.values())
        out_b = sum(_nbytes(t) for t in {id(t): t for t in outs}.values())
        if name in _GATHERS or name in _SCATTERS_:
            idx = sum(_nbytes(t) for t in ins if not t.is_floating_point())
            moved = out_b if name in _GATHERS else max(
                (_nbytes(t) for t in ins[1:] if t.is_floating_point()), default=0)
            in_b, out_b = moved + idx, moved
        if kind is not None:
            operand = _nbytes(ins[0]) if alltoall else in_b
            axis = next((self.axes[a] for a in args if isinstance(a, str)
                         and a in self.axes), "?")
            traffic = 2 * operand if alltoall else in_b + out_b
            for s in sums:
                s.collective_bytes[kind] += m * operand
                s.collective_count[kind] += m
                s.collective_axis_bytes[axis] += m * operand
                s.bytes += m * traffic
            if not alltoall:
                self._track(outs)
            self._tally(name, outs or ins, traffic, m)
            return
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        out_elems = sum(t.numel() for t in outs)
        dot = float(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0.0
        for s in sums:
            s.bytes += m * (in_b + out_b)
            if dot:
                s.dot_flops += m * dot
                s.flops += m * dot
            else:
                s.flops += m * out_elems
            if name in _TRANSCENDENTAL:
                s.transcendentals += m * out_elems
        self._track(outs)
        self._tally(name, outs or ins, in_b + out_b, m)

    def _tally(self, name, tensors, nbytes, m=1):
        t = tensors[0] if tensors else None
        key = name if t is None else (
            f"{name} {str(t.dtype).replace('torch.', '')}{list(t.shape)}")
        self.traffic[key] += m * nbytes
        self.count[key] += m


def _innermost(intervals: List[list], seq: int) -> int:
    """Index of the innermost of the nested ``[first, end, _, parent]``
    intervals of sequence numbers that holds ``seq``, or -1."""
    lo, hi = 0, len(intervals)
    while lo < hi:                           # last interval starting at or before seq
        mid = (lo + hi) // 2
        if intervals[mid][0] <= seq:
            lo = mid + 1
        else:
            hi = mid
    i = lo - 1
    while i >= 0:
        first, end, _, parent = intervals[i]
        if end is None or seq < end:
            return i
        i = parent                           # intervals nest: try the enclosing one
    return -1


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (_key(a) == _key(b) and a.storage_offset() == b.storage_offset()
            and a.shape == b.shape and a.stride() == b.stride())


def _fake_mode_of(tensors):
    from torch._subclasses.fake_tensor import FakeTensor

    return next((t.fake_mode for t in tensors if isinstance(t, FakeTensor)), None)


def _unique_bytes(tensors) -> Tuple[int, Dict[int, torch.Tensor]]:
    by_key = {}
    for t in tensors:
        by_key.setdefault(_key(t), t)
    return sum(t.untyped_storage().nbytes() for t in by_key.values()), by_key


def trace_step(fn, *args, regions: Sequence[str] = (), donate: Sequence[int] = (),
               top: int = 20, axes: Optional[Dict[str, str]] = None,
               max_ops: Optional[int] = None, trip_counts: bool = True) -> StepTrace:
    """Run ``fn(*args)`` once under the counting mode (inside the fake mode
    of its FakeTensor arguments, if they are fake) and return its costs per
    device, per region, its top traffic keys and its memory.  ``donate``:
    the indices of the arguments whose storage the step may reuse for its
    outputs (the reference's ``donate_argnums``); ``axes``: {group name:
    mesh axis} for the per-axis collective bytes (``group_axes(mesh)``);
    ``max_ops``: raise ``TraceBudgetExceeded`` past that many ops run;
    ``trip_counts``: marked loops run three steps and count by their trip
    count (False: every step runs and counts)."""
    arg_t = _tensors(list(args))
    counter = _Counter(regions, axes, max_ops)
    arg_bytes, arg_keys = _unique_bytes(arg_t)
    counter.inputs = set(arg_keys)
    fake = _fake_mode_of(arg_t)
    t0 = time.perf_counter()
    loops = trips.counting(counter) if trip_counts else contextlib.nullcontext()
    with (fake if fake is not None else contextlib.nullcontext()), counter, loops:
        out = fn(*args)
    seconds = time.perf_counter() - t0

    out_t = _tensors(out)
    out_bytes, out_keys = _unique_bytes(out_t)
    # donation: an output written in place into a donated leaf aliases it;
    # an output the step made takes a donated leaf of its local shape and
    # dtype (once each) that no output was written into
    donated = {_key(t): t for i in donate for t in _tensors(args[i])}
    alias = sum(t.untyped_storage().nbytes() for k, t in out_keys.items() if k in donated)
    pool = defaultdict(int)
    for k, t in donated.items():
        if k not in out_keys:
            pool[(tuple(t.shape), t.dtype)] += 1
    reuse = []
    for k, t in out_keys.items():
        sig = (tuple(t.shape), t.dtype)
        if k in counter.alloc_at and pool[sig]:
            pool[sig] -= 1
            n = t.untyped_storage().nbytes()
            alias += n
            reuse.append((counter.alloc_at[k], n))
    reuse.sort()
    peak_new, taken, j = 0, 0, 0
    for i, live in enumerate(counter.series):
        while j < len(reuse) and reuse[j][0] <= i:
            taken += reuse[j][1]
            j += 1
        peak_new = max(peak_new, live - taken)
    eager_peak = arg_bytes + max(counter.series, default=0)
    peak = arg_bytes + peak_new
    memory = {
        "argument_bytes": arg_bytes, "output_bytes": out_bytes,
        "temp_bytes": peak - arg_bytes - out_bytes + alias, "alias_bytes": alias,
        "peak_device_bytes": peak, "peak_device_gib": round(peak / 2**30, 3),
        "eager_peak_bytes": eager_peak,
    }
    breakdown = sorted(((k, v, counter.count[k]) for k, v in counter.traffic.items()),
                       key=lambda r: -r[1])[:top]
    return StepTrace(counter.total, counter.regions, breakdown, memory, seconds,
                     counter.ops)


def analyze_step(fn, *args) -> CostSummary:
    """Per-device costs of ``fn(*args)``, the counterpart of the reference's
    ``analyze_compiled``."""
    return trace_step(fn, *args).total


def region_costs(fn, args, regions: List[str]) -> Dict[str, CostSummary]:
    """Per-device costs of ``fn(*args)`` by ``record_function`` region:
    each op under the innermost open region named in ``regions``, backward
    ops under their forward node's, everything else under 'other'."""
    return trace_step(fn, *args, regions=regions).regions


def traffic_breakdown(fn, args, top: int = 20) -> List[Tuple[str, float, int]]:
    """Top traffic contributors of ``fn(*args)`` as (op dtype[shape],
    bytes, count), the reference's profiling view."""
    return trace_step(fn, *args, top=top).breakdown
