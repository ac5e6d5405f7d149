"""Task and executor-state definitions shared by scheduler/simulator/runtime."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class ExecutorState(enum.Enum):
    FREE = "free"
    PENDING = "pending"   # notified, about to pick up work
    BUSY = "busy"
    LOST = "lost"         # failed / released


class TaskState(enum.Enum):
    QUEUED = "queued"
    PENDING = "pending"   # removed from wait queue, notification in flight
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


@dataclass
class Task:
    """kappa in K: requires data objects theta(kappa), runs for mu(kappa)."""

    task_id: int
    files: Tuple[str, ...]            # theta(kappa)
    compute_time_s: float             # mu(kappa)
    submit_time_s: float = 0.0
    state: TaskState = TaskState.QUEUED
    # bookkeeping filled in by the simulator / runtime
    executor: Optional[str] = None
    dispatch_time_s: Optional[float] = None
    start_time_s: Optional[float] = None
    finish_time_s: Optional[float] = None
    hits_local: int = 0
    hits_remote: int = 0
    misses: int = 0
    attempts: int = 0                 # replay-policy re-dispatch count

    @property
    def response_time_s(self) -> Optional[float]:
        if self.finish_time_s is None:
            return None
        return self.finish_time_s - self.submit_time_s
