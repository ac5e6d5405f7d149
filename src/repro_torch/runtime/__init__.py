"""Serving runtime of the port: the copied router/admission/chaos/fault
planes plus the torch serving loop.  No training loop is pulled in."""

from .fault_tolerance import (
    FailureInjector,
    HeartbeatMonitor,
    RecoveryActions,
    recover,
)
from .router import (
    Assignment,
    CacheAffinityRouter,
    ReplicaStore,
    RoutedRequest,
    RouterStats,
)
from .serve_loop import DiffusionServer, Replica, Request, ServeStats

__all__ = [
    "FailureInjector", "HeartbeatMonitor", "RecoveryActions", "recover",
    "Assignment", "CacheAffinityRouter", "ReplicaStore", "RoutedRequest",
    "RouterStats",
    "DiffusionServer", "Replica", "Request", "ServeStats",
]
