"""Data-aware scheduler: simulator ``Task`` adapter over the dispatch engines.

The five dispatch policies and the two-phase notify/pick algorithm live in
``core.dispatch.DataAwareDispatcher`` in work-item-generic form (see that
module for the paper mapping), with an array-backed decision-identical twin
in ``repro.dispatch_vec.VectorizedDispatcher``.  The ``_TaskAdapterMixin``
binds either engine to simulator ``Task``s: a task's identity is
``task_id``, its needed objects are ``files``, and dispatch mutates the
task's state/executor/attempts fields — which is all the discrete-event
simulator needs.  The serving runtime binds the same engines to live
requests in ``runtime.router``.

``make_scheduler`` picks the engine: the reference (golden semantics, pure
Python) or the vectorized plane (same decisions, array arithmetic —
``SimConfig.vectorized_dispatch`` routes the DES here).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .dispatch import POLICIES, DataAwareDispatcher, SchedulerStats
from .index import CentralizedIndex
from .task import Task, TaskState

__all__ = ["POLICIES", "DataAwareScheduler", "SchedulerStats",
           "VectorizedScheduler", "make_scheduler"]


class _TaskAdapterMixin:
    """Binds a dispatch engine to simulator ``Task`` work items."""

    def __init__(
        self,
        policy: str = "good-cache-compute",
        window: int = 3200,
        cpu_util_threshold: float = 0.8,
        max_replicas: int = 4,
        utilization_fn=None,
        index: Optional[CentralizedIndex] = None,
        **engine_kwargs,
    ):
        super().__init__(
            policy=policy,
            window=window,
            cpu_util_threshold=cpu_util_threshold,
            max_replicas=max_replicas,
            utilization_fn=utilization_fn,
            index=index,
            key_fn=lambda t: t.task_id,
            objects_fn=lambda t: t.files,
            **engine_kwargs,
        )

    # ---------------------------------------------------------------- queue
    def submit(self, task: Task) -> None:
        task.state = TaskState.QUEUED
        super().submit(task)

    # ------------------------------------------------------------- dispatch
    def _on_dispatch(self, task: Task, executor: str) -> None:
        task.state = TaskState.PENDING
        task.executor = executor
        task.attempts += 1

    def _dispatch(self, task: Task, executor: str) -> None:
        """Force-dispatch (bypasses policy): legacy hook kept for callers."""
        self._dispatch_item(task, executor)

    def pick_tasks(self, executor: str, m: int = 1) -> List[Task]:
        """Phase 2 under the task vocabulary (see ``pick_items``)."""
        return self.pick_items(executor, m=m)

    # ------------------------------------------------------------- failures
    def requeue(self, task: Task) -> None:
        """Replay policy: re-dispatch a failed/timed-out task."""
        task.executor = None
        self.submit(task)


class DataAwareScheduler(_TaskAdapterMixin, DataAwareDispatcher):
    """Falkon-style dispatcher over simulator tasks (paper Section 3.2)."""


# ``repro.dispatch_vec`` itself imports ``repro.core`` (whose package init
# loads this module), so the vectorized scheduler class is materialized
# lazily on first use — either import order works.
_vectorized_cls = None


def _vectorized_scheduler_cls():
    global _vectorized_cls
    if _vectorized_cls is None:
        from ..dispatch_vec import VectorizedDispatcher

        class VectorizedScheduler(_TaskAdapterMixin, VectorizedDispatcher):
            """Array-backed task scheduler: decision-identical reference twin."""

        _vectorized_cls = VectorizedScheduler
    return _vectorized_cls


def __getattr__(name):          # PEP 562: lazy VectorizedScheduler export
    if name == "VectorizedScheduler":
        return _vectorized_scheduler_cls()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_scheduler(vectorized: bool = False, **kwargs):
    """Task scheduler factory: reference engine, or the array-backed one."""
    if vectorized:
        return _vectorized_scheduler_cls()(**kwargs)
    return DataAwareScheduler(**kwargs)
