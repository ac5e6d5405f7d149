"""Elastic scaling driver: DRP-triggered re-mesh + checkpoint-restore.

Scale events (queue pressure up, node loss down) re-provision the
data-parallel axis: the driver checkpoints, rebuilds the mesh over the new
device set, re-places parameters under the new shardings (restore-with-
resharding), and resumes — the ~tens-of-seconds cost matches the paper's
GRAM4 allocation latency regime, and the policy deciding WHEN is the same
``DynamicResourceProvisioner``.

On CPU the device set is fixed, so re-meshing varies the *logical* DP degree
(hosts in the data pipeline + batch sharding) — the mechanism (checkpoint,
rebuild, restore, resume) is identical to the multi-host path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..core.model import ModelInputs, optimize_resources
from ..core.provisioner import DynamicResourceProvisioner


@dataclass
class ScaleEvent:
    time_s: float
    from_hosts: int
    to_hosts: int
    reason: str
    restore_s: float


class ElasticController:
    """Decides and executes DP-degree changes for the training loop."""

    def __init__(
        self,
        provisioner: DynamicResourceProvisioner,
        *,
        checkpoint_fn: Callable[[], None],
        restore_fn: Callable[[int], None],   # new host count -> rebuild
        min_hosts: int = 1,
        cooldown_s: float = 5.0,
    ):
        self.drp = provisioner
        self.checkpoint_fn = checkpoint_fn
        self.restore_fn = restore_fn
        self.min_hosts = min_hosts
        self.cooldown_s = cooldown_s
        self.events: List[ScaleEvent] = []
        self._last_scale = -1e9

    def desired_hosts(self, backlog: int, current: int) -> int:
        inc = self.drp.desired_increment(backlog)
        want = current + inc
        if backlog == 0 and current > self.min_hosts:
            want = max(self.min_hosts, current - 1)
        return max(self.min_hosts, min(want, self.drp.max_nodes))

    def plan_with_model(self, m: ModelInputs) -> int:
        """Abstract-model-guided sizing (paper Section 4.3 optimizer)."""
        best_t, _ = optimize_resources(m, self.drp.max_nodes)
        return max(self.min_hosts, best_t)

    def maybe_scale(self, backlog: int, current: int,
                    now: Optional[float] = None) -> Optional[ScaleEvent]:
        now = now if now is not None else time.time()
        if now - self._last_scale < self.cooldown_s:
            return None
        want = self.desired_hosts(backlog, current)
        if want == current:
            return None
        t0 = time.time()
        self.checkpoint_fn()
        self.restore_fn(want)
        ev = ScaleEvent(
            time_s=now, from_hosts=current, to_hosts=want,
            reason="backlog" if want > current else "idle",
            restore_s=time.time() - t0,
        )
        self.events.append(ev)
        self._last_scale = now
        self.drp.registered = want
        return ev
