"""Dynamic Resource Provisioner (DRP) — paper Sections 1, 3.1, 5.2.

Wait-queue length triggers allocation requests through a (slow) LRM — GRAM4
in the paper, with 30–60 s allocation latency; release is idle-timeout based.
Falkon's tunable allocation policies are implemented:

  * ``one``         — one node per trigger
  * ``additive``    — fixed chunk per trigger
  * ``exponential`` — doubling chunks (1, 2, 4, ...) while backlog persists
  * ``all``         — straight to ``max_nodes``
  * ``watermark``   — proportional: enough nodes to drain queue_len/target

The provisioner is deliberately transport-agnostic: the DES drives it with
simulated time, the elastic training runtime drives it with wall-clock time
(see ``runtime/elastic.py``), both through the same policy code.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

ALLOCATION_POLICIES = ("one", "additive", "exponential", "all", "watermark")


@dataclass
class ProvisionRequest:
    nodes: int
    request_time_s: float
    ready_time_s: float  # request_time + LRM allocation latency


class DynamicResourceProvisioner:
    """Queue-triggered allocation + idle-timeout release."""

    def __init__(
        self,
        max_nodes: int,
        min_nodes: int = 0,
        policy: str = "watermark",
        chunk: int = 1,
        queue_threshold: int = 1,
        tasks_per_node_target: float = 32.0,
        allocation_latency_s: Tuple[float, float] = (30.0, 60.0),
        idle_release_s: float = 60.0,
        seed: int = 0,
    ):
        if policy not in ALLOCATION_POLICIES:
            raise ValueError(f"unknown allocation policy {policy!r}")
        self.max_nodes = max_nodes
        self.min_nodes = min_nodes
        self.policy = policy
        self.chunk = chunk
        self.queue_threshold = queue_threshold
        self.tasks_per_node_target = tasks_per_node_target
        self.allocation_latency_s = allocation_latency_s
        self.idle_release_s = idle_release_s
        self._rng = _random.Random(seed)
        self._exp_next = 1
        self.registered = 0
        self.pending: List[ProvisionRequest] = []
        self.total_requested = 0
        self.total_released = 0
        # Demand-aware scale-down floor: the node count currently-admitted
        # (non-shed) demand needs.  A queue valley right after an admission
        # shed episode must not over-shrink the pool below what the work
        # still held under backpressure requires — the router's admission
        # pump keeps this current; 0 (default) preserves min_nodes-only
        # release semantics.
        self.demand_floor = 0

    @property
    def _release_floor(self) -> int:
        return max(self.min_nodes, self.demand_floor)

    # ------------------------------------------------------------ allocation
    def _latency(self) -> float:
        lo, hi = self.allocation_latency_s
        return self._rng.uniform(lo, hi)

    def desired_increment(self, queue_len: int) -> int:
        """How many nodes the allocation policy wants right now."""
        in_flight = sum(r.nodes for r in self.pending)
        capacity = self.registered + in_flight
        headroom = self.max_nodes - capacity
        if headroom <= 0 or queue_len < self.queue_threshold:
            return 0
        if self.policy == "one":
            want = 1
        elif self.policy == "additive":
            want = self.chunk
        elif self.policy == "exponential":
            want = self._exp_next
        elif self.policy == "all":
            want = headroom
        else:  # watermark: enough nodes for the backlog at target load
            want = max(0, int(round(queue_len / self.tasks_per_node_target)) - capacity)
            want = max(want, 1 if capacity == 0 else 0)
        return max(0, min(want, headroom))

    def on_queue_change(self, now: float, queue_len: int) -> Optional[ProvisionRequest]:
        """Called whenever queue length changes; may issue one LRM request."""
        n = self.desired_increment(queue_len)
        if n <= 0:
            return None
        if self.policy == "exponential":
            self._exp_next = min(self._exp_next * 2, self.max_nodes)
        req = ProvisionRequest(nodes=n, request_time_s=now, ready_time_s=now + self._latency())
        self.pending.append(req)
        self.total_requested += n
        return req

    def request(self, nodes: int, now: float) -> Optional[ProvisionRequest]:
        """Direct replacement request (failure back-fill), headroom-clamped."""
        in_flight = sum(r.nodes for r in self.pending)
        headroom = self.max_nodes - self.registered - in_flight
        n = max(0, min(nodes, headroom))
        if n == 0:
            return None
        req = ProvisionRequest(nodes=n, request_time_s=now,
                               ready_time_s=now + self._latency())
        self.pending.append(req)
        self.total_requested += n
        return req

    def complete(self, req: ProvisionRequest) -> int:
        """LRM granted the request: nodes register. Returns node count."""
        if req in self.pending:
            self.pending.remove(req)
        self.registered += req.nodes
        return req.nodes

    # --------------------------------------------------------------- release
    def should_release(self, idle_since_s: float, now: float) -> bool:
        if self.registered <= self._release_floor:
            return False
        return (now - idle_since_s) >= self.idle_release_s

    def release(self, nodes: int = 1) -> int:
        n = min(nodes, max(0, self.registered - self._release_floor))
        self.registered -= n
        self.total_released += n
        if self.policy == "exponential":
            self._exp_next = 1
        return n
