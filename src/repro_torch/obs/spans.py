"""Named spans of the port's phases: ``torch.profiler`` regions that the
device trace holds, and optionally the same span in a ``TraceBuffer``.

``span(name, trace=None, ...)`` is the one entry point.  It opens
``torch.profiler.record_function(name)`` when the profiler is on, or when
a Python dispatch mode is active: the cost model's counter
(``launch/op_analysis.py``) reads the regions it asks for as
``_record_function_enter`` ops through a ``TorchDispatchMode``.  Given a
``TraceBuffer``, it also records the span there on exit, under ``ring``
or else the name's last dotted part (``serve.prefill`` is recorded as
``prefill``, the name ``parity_digest`` and ``obs.analyze`` know), with
``time.time()`` at its start and end.  Otherwise it returns one shared null context: with the
profiler off, a span costs a test of two flags, no allocation and no op.

One clock: a region's profiler timestamp (its ``ts`` in microseconds plus
the exported trace's ``baseTimeNanoseconds``) is on the wall clock that
``time.time()`` reads, so a ``TraceBuffer`` span lies inside the profiler
region of the same call, and the operator's ``--metrics-dir`` export and
a device trace of the same run line up.

The port's spans (``PERF.md`` section 3 names the metric each feeds):

    serve.route      each call the server makes into its router
    serve.score      the vectorized dispatcher's rescore and mirror flush
    serve.prefill    a miss's prefill and cache re-home (ring: "prefill")
    serve.cache      inside serve.prefill: the decode cache made and filled
    serve.decode     a request's decode loop (ring: "decode")
    serve.payload    a swap-in's KV tensors handed back (ring: the object)
    model.decode     one decode step of the model
    moe.route        a MoE layer's router, top-k and counts
    moe.fill         a dropless prefill's read of its fullest expert's count
    moe.experts      a MoE layer's routed experts (K4's three GEMMs, SwiGLU)
    train.grad       forward and backward of one (micro)batch
    train.optimizer  the optimizer's update
    attn_scores, rglru_rec, wkv_scan   the cost model's regions
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

__all__ = ["span", "NULL_SPAN", "profiling"]

NULL_SPAN = contextlib.nullcontext()
_mode_depth = torch._C._len_torch_dispatch_stack


class _Recorded:
    """A span bound for a ``TraceBuffer``, inside its profiler region when
    one is wanted."""

    __slots__ = ("region", "trace", "args", "t0")

    def __init__(self, region, trace, args):
        self.region, self.trace, self.args = region, trace, args

    def __enter__(self):
        self.region.__enter__()
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        t1 = time.time()
        self.region.__exit__(*exc)
        rid, name, phase, parent, replica, detail = self.args
        self.trace.record(rid, name, phase, self.t0, t1, replica=replica, parent=parent,
                          detail=detail)
        return False


def profiling() -> bool:
    """Whether ``torch.profiler`` is recording: a traced window."""
    return _profiler._is_profiler_enabled


def span(name: str, trace: Optional[Any] = None, request_id: int = -1, phase: str = "",
         parent: str = "", replica: str = "", detail: Tuple = (),
         ring: Optional[str] = None):
    """A context manager around one phase (module docstring)."""
    wanted = _profiler._is_profiler_enabled or _mode_depth() > 0
    if trace is None:
        return record_function(name) if wanted else NULL_SPAN
    return _Recorded(record_function(name) if wanted else NULL_SPAN, trace,
                     (request_id, ring or name.rpartition(".")[2], phase, parent, replica,
                      detail))
