"""Multi-tier data stores: the vertical axis of data diffusion.

The paper's transient store is a single node-local cache in front of a
persistent store (GPFS).  Real serving nodes have a *hierarchy*: accelerator
HBM, host DRAM, local disk, then the shared persistent/object store.  This
module generalizes ``core.store.TransientStore`` into a ``TieredStore`` —
an ordered stack of ``core.cache.Cache``-accounted tiers, each with its own
capacity, eviction policy, and read-bandwidth ``BandwidthResource``:

  * an access found in a lower tier *promotes* the object to the top tier
    (data diffuses toward compute);
  * a tier eviction *demotes* the victim to the next tier down instead of
    dropping it (a "miss" becomes a cheap swap-in rather than a refetch);
  * only the bottom tier's evictions actually leave the node, at which point
    presence is withdrawn from the ``CentralizedIndex`` and the optional
    ``on_drop`` callback lets the owner free the real payload.

Presence *per tier* is published to the index (``CentralizedIndex.add``'s
``tier`` argument) so the dispatcher's tier-aware scoring can rank an HBM
hit above a disk hit above a peer fetch (``core.dispatch.tier_weights``).

The store itself tracks names and sizes only (the modeled plane).  An
attached ``diffusion.payload.PayloadBackend`` is notified after every
placement change (one hook in ``_place`` covers admit / promote / demote /
victim demotion, plus the two drop paths) and moves the *actual* tensors
between physical homes — objects the backend holds no bytes for degrade to
tolerated placeholder notifications, so decisions never depend on payloads.

Invariants (property-tested in ``tests/test_diffusion_properties.py``):
  * an object resides in at most one tier per node;
  * each tier's used bytes never exceed its capacity;
  * demotion preserves the node's total object count until the bottom tier
    evicts (or an object fits in no tier and passes through uncached).

Deferred promotion epochs (the serving batch plane): ``defer_promotions()``
switches the store into intent-logging mode — an ``access()`` that would
relocate an object toward the top tier instead records a promote intent in a
delta log keyed by object with last-writer-wins coalescing (the
``CoherenceBus`` delta shape, one level down).  ``apply_promotions()`` ends
the epoch and applies the coalesced delta in one pass: N hot-object accesses
inside one batch become a single relocation and a single index tier update,
and — critically for the batched router drain — presence and tier entries in
the index stay *frozen* while a batch of dispatch decisions is being made,
so ``notify_batch`` sees one consistent snapshot.  Intents whose object was
dropped, demoted away, or already promoted by the time the epoch closes are
discarded (they are hints, not obligations).
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.cache import Cache
from ..core.index import CentralizedIndex
from ..core.store import BandwidthResource

__all__ = [
    "TierSpec",
    "StoreTier",
    "TieredStore",
    "default_tier_weights",
    "roofline_tier_bw",
    "serving_tier_specs",
]


@dataclass(frozen=True)
class TierSpec:
    """Static description of one tier (top of the list = closest to compute)."""

    name: str                                  # e.g. "hbm", "dram", "disk"
    capacity_bytes: float
    bw_bytes_per_s: float = float("inf")       # read bandwidth for swap-ins
    eviction: str = "lru"

    @classmethod
    def from_roofline(cls, name: str, capacity_bytes: float,
                      eviction: str = "lru") -> "TierSpec":
        """Tier spec with bandwidth calibrated from the roofline constants
        the perf driver uses (``launch.rooflines``), instead of nominal values:

          hbm   -> HBM_BW   (accelerator memory bandwidth)
          dram  -> ICI_BW   (host<->device swap-ins ride the interconnect)
          other -> ICI_BW/25 (local-disk class: the nominal 2 GB/s at the
                   reference 50 GB/s link, kept as a pinned ratio)

        ``tests/test_diffusion.py`` pins this mapping so the locality sweeps
        stay anchored to the same machine model as the kernel roofline.
        """
        return cls(name, capacity_bytes, roofline_tier_bw(name), eviction)


def roofline_tier_bw(name: str) -> float:
    """Tier read bandwidth derived from the ``launch.rooflines`` constants
    (the side-effect-free home of the dryrun/perf machine model)."""
    from ..launch.rooflines import DISK_BW, HBM_BW, ICI_BW
    if name == "hbm":
        return HBM_BW
    if name == "dram":
        return ICI_BW
    return DISK_BW


def serving_tier_specs(
    hbm_bytes: float,
    dram_bytes: float = 0.0,
    disk_bytes: float = 0.0,
    hbm_bw: float = float("inf"),
    dram_bw: float = 50e9,
    disk_bw: float = 2e9,
    eviction: str = "lru",
) -> List[TierSpec]:
    """The standard serving hierarchy; zero-capacity tiers are omitted."""
    specs = [TierSpec("hbm", hbm_bytes, hbm_bw, eviction)]
    if dram_bytes > 0:
        specs.append(TierSpec("dram", dram_bytes, dram_bw, eviction))
    if disk_bytes > 0:
        specs.append(TierSpec("disk", disk_bytes, disk_bw, eviction))
    return specs


def default_tier_weights(specs: Sequence[TierSpec]) -> Dict[str, float]:
    """Geometric scoring weights: a hit in tier i is worth 2x a hit in i+1.

    A peer fetch / persistent read scores 0 (the object is simply not in the
    executor's column), so any resident tier outscores any remote source —
    exactly the ordering the dispatcher's ``max-compute-util`` needs.
    """
    return {spec.name: 0.5 ** i for i, spec in enumerate(specs)}


class StoreTier:
    """One level of the hierarchy: cache accounting + a read-bandwidth link."""

    def __init__(self, spec: TierSpec, owner: str, rng: Optional[_random.Random] = None):
        self.spec = spec
        self.cache = Cache(spec.capacity_bytes, policy=spec.eviction, rng=rng)
        self.bw = BandwidthResource(f"{owner}.{spec.name}", spec.bw_bytes_per_s)

    @property
    def name(self) -> str:
        return self.spec.name


class TieredStore:
    """A node's tier stack + peer-serving NIC.  See module docstring."""

    def __init__(
        self,
        name: str,
        specs: Sequence[TierSpec],
        index: Optional[CentralizedIndex] = None,
        nic_bw_bytes_per_s: float = float("inf"),
        on_drop: Optional[Callable[[str, float], None]] = None,
        rng: Optional[_random.Random] = None,
        payload=None,
    ):
        if not specs:
            raise ValueError("TieredStore needs at least one tier")
        self.name = name
        self.index = index
        self.tiers = [StoreTier(s, name, rng) for s in specs]
        self.nic = BandwidthResource(f"{name}.nic", nic_bw_bytes_per_s)
        self._on_drop = on_drop
        # Physical plane (diffusion.payload.PayloadBackend): notified after
        # every placement change so the real KV bytes follow the bookkeeping.
        # None = modeled-only (identical decisions either way).
        self.payload = payload
        self._sizes: Dict[str, float] = {}
        self._tier_idx: Dict[str, int] = {}     # object -> resident tier index
        self.misses = 0
        self.hits_by_tier: Dict[str, int] = {t.name: 0 for t in self.tiers}
        self.demotions = 0
        self.promotions = 0
        self.drops = 0
        # Deferred-promotion epoch: None = immediate relocation (classic
        # behavior); a dict = intent log ``obj -> (op, target tier index)``
        # with last-writer-wins coalescing, applied by apply_promotions().
        self._promo_log: Optional[Dict[str, Tuple[str, int]]] = None
        self.deferred_applied = 0       # intents that became relocations
        self.deferred_coalesced = 0     # intents absorbed by a later intent
        # Per-tenant admission quotas (the overload-fairness plane): with
        # quotas set, a *fresh* placement whose tenant is already at its
        # resident-byte cap passes through uncached instead of evicting
        # other tenants' working sets.  None (default) = zero extra work.
        self._tenant_quota: Optional[Dict[str, float]] = None
        self._tenant_of: Optional[Callable[[str], Optional[str]]] = None
        self._tenant_owner: Dict[str, str] = {}   # resident obj -> tenant
        self.tenant_bytes: Dict[str, float] = {}  # resident bytes per tenant
        self.quota_refusals = 0

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view of this store's counters.

        The router aggregates these across every replica under the
        ``tiers.`` prefix (one fleet-wide sum; per-store attribution stays
        on the store itself)."""
        out: Dict[str, float] = {
            "objects": float(len(self._tier_idx)),
            "misses": float(self.misses),
            "promotions": float(self.promotions),
            "demotions": float(self.demotions),
            "drops": float(self.drops),
            "deferred_applied": float(self.deferred_applied),
            "deferred_coalesced": float(self.deferred_coalesced),
            "quota_refusals": float(self.quota_refusals),
        }
        for tier, n in self.hits_by_tier.items():
            out[f"hits_by_tier.{tier}"] = float(n)
        return out

    def attach_payload(self, backend) -> None:
        """Wire a payload backend after construction (the router builds its
        stores internally); already-resident objects stay placeholders."""
        self.payload = backend

    def set_tenant_quotas(self, quotas: Dict[str, float],
                          tenant_of: Callable[[str], Optional[str]]) -> None:
        """Cap each tenant's resident bytes on this store.

        ``tenant_of`` maps an object to its owning tenant (None = untracked,
        never refused).  A fresh admit for a tenant already at its cap is
        refused at ``_place`` (pass-through, counted in ``quota_refusals``),
        so resident bytes never exceed ``quota + one object``.  Relocations
        (promote / demote / victim cascade) of already-resident objects are
        never quota-checked — they move bytes between tiers, not tenants."""
        self._tenant_quota = dict(quotas)
        self._tenant_of = tenant_of

    # -- queries --------------------------------------------------------------
    def __contains__(self, obj: str) -> bool:
        return obj in self._tier_idx

    def contains(self, obj: str) -> bool:
        return obj in self._tier_idx

    def __len__(self) -> int:
        return len(self._tier_idx)

    def tier_of(self, obj: str) -> Optional[str]:
        i = self._tier_idx.get(obj)
        return self.tiers[i].name if i is not None else None

    def size_of(self, obj: str) -> float:
        return self._sizes[obj]

    def tier_bw(self, tier_name: str) -> BandwidthResource:
        for t in self.tiers:
            if t.name == tier_name:
                return t.bw
        raise KeyError(tier_name)

    @property
    def top_tier(self) -> str:
        return self.tiers[0].name

    def contents(self) -> Dict[str, str]:
        """Snapshot ``object -> tier name`` (the publish payload)."""
        return {obj: self.tiers[i].name for obj, i in self._tier_idx.items()}

    # -- access path ----------------------------------------------------------
    def access(self, obj: str, promote: bool = True) -> Optional[str]:
        """Hit test; returns the tier the object was *found* in (or None).

        A hit in a lower tier promotes the object to the top tier — the
        caller charges the swap-in against the found tier's bandwidth.
        """
        i = self._tier_idx.get(obj)
        if i is None:
            self.misses += 1
            return None
        tier = self.tiers[i]
        tier.cache.access(obj)                 # recency/frequency bump
        self.hits_by_tier[tier.name] += 1
        if promote and i > 0:
            # Only relocate when some higher tier can actually hold the
            # object — otherwise the "promotion" would land it back where it
            # is, churning the cache and bumping the index version for
            # nothing (which defeats the dispatcher's failed-scan memo).
            size = self._sizes[obj]
            if any(t.spec.capacity_bytes >= size for t in self.tiers[:i]):
                if self._promo_log is not None:
                    self._log_intent(obj, "promote", 0)
                else:
                    self._relocate(obj, target=0)
                    self.promotions += 1
        return tier.name

    # -- deferred promotion epochs (serving batch plane) ----------------------
    def defer_promotions(self) -> None:
        """Begin (or continue) a deferred-promotion epoch: relocations from
        ``access`` are recorded as intents instead of applied, freezing the
        store's tier layout and its index entries until
        ``apply_promotions``.  Idempotent — re-entering keeps the open log."""
        if self._promo_log is None:
            self._promo_log = {}

    @property
    def deferring(self) -> bool:
        return self._promo_log is not None

    def pending_promotions(self) -> int:
        return len(self._promo_log) if self._promo_log is not None else 0

    def has_intent(self, obj: str) -> bool:
        """Is a promote/demote intent logged for ``obj`` in the open epoch?"""
        return self._promo_log is not None and obj in self._promo_log

    def _log_intent(self, obj: str, op: str, target: int) -> None:
        if obj in self._promo_log:
            self.deferred_coalesced += 1    # last-writer-wins, CoherenceBus-style
        self._promo_log[obj] = (op, target)

    def demote(self, obj: str, target: int) -> bool:
        """Push a resident object down to tier ``target`` (cache-pressure
        relief).  Deferred to the delta log inside an epoch.  Returns whether
        the demotion applied (or was logged)."""
        i = self._tier_idx.get(obj)
        if i is None or i >= target or target >= len(self.tiers):
            return False
        if self._promo_log is not None:
            self._log_intent(obj, "demote", target)
            return True
        self._relocate(obj, target)
        self.demotions += 1
        return True

    def _apply_intent(self, obj: str, op: str, target: int) -> bool:
        """Validate + apply one logged intent against the *current* layout —
        an object dropped, already promoted, or no longer fitting is skipped
        silently (intents are hints, not obligations)."""
        i = self._tier_idx.get(obj)
        if i is None:
            return False                    # dropped/evicted since the intent
        if op == "promote":
            if i <= target:
                return False                # already at or above the target
            size = self._sizes[obj]
            if not any(t.spec.capacity_bytes >= size
                       for t in self.tiers[target:i]):
                return False
            self._relocate(obj, target)
            self.promotions += 1
            return True
        if i >= target or target >= len(self.tiers):
            return False
        self._relocate(obj, target)
        self.demotions += 1
        return True

    def apply_promotion(self, obj: str) -> bool:
        """Apply (and discard) the logged intent for one object, if any.

        The batched router replays a drained assignment's store mutations in
        object order — promotion here, admission there — so recency order
        evolves exactly as the looped per-decision path would have."""
        if self._promo_log is None:
            return False
        ent = self._promo_log.pop(obj, None)
        if ent is None:
            return False
        ok = self._apply_intent(obj, *ent)
        if ok:
            self.deferred_applied += 1
        return ok

    def apply_promotions(self) -> int:
        """End the epoch: apply the remaining coalesced promote/demote delta
        in one pass and return the number of relocations performed."""
        log, self._promo_log = self._promo_log, None
        if not log:
            return 0
        applied = 0
        for obj, (op, target) in log.items():
            if self._apply_intent(obj, op, target):
                applied += 1
        self.deferred_applied += applied
        return applied

    def admit(self, obj: str, size_bytes: float, start_tier: int = 0) -> List[str]:
        """Place an object (new arrival), demoting victims down the stack.

        Returns the names of objects fully dropped off the bottom tier.  An
        object fitting in no tier from ``start_tier`` down passes through
        uncached (the paper's streaming fallback) and is not stored.
        """
        if obj in self._tier_idx:
            return []
        dropped: List[str] = []
        self._sizes[obj] = size_bytes
        self._place(obj, size_bytes, start_tier, dropped)
        return dropped

    def drop(self, obj: str) -> None:
        """Explicitly remove an object from whatever tier holds it."""
        i = self._tier_idx.pop(obj, None)
        if i is None:
            return
        self.tiers[i].cache.remove(obj)
        size = self._sizes.pop(obj, 0.0)
        self._tenant_forget(obj, size)
        self.drops += 1
        if self.index is not None:
            self.index.remove(obj, self.name)
        if self._on_drop is not None:
            self._on_drop(obj, size)
        if self.payload is not None:
            self.payload.dropped(obj)

    def clear(self) -> None:
        for obj in list(self._tier_idx):
            self.drop(obj)

    def publish(self):
        """Full per-tier snapshot re-sync into the index (recovery path)."""
        if self.index is None:
            raise ValueError(f"TieredStore {self.name!r} has no index to publish to")
        return self.index.publish(self.name, self.contents())

    # -- placement machinery --------------------------------------------------
    def _quota_admit(self, obj: str, size: float) -> bool:
        """Fresh-placement quota gate: charge the owning tenant, or refuse.

        Admission is allowed while the tenant is strictly *under* its cap, so
        resident bytes are bounded by ``quota + one object`` — the last admit
        may straddle the line but the next one is refused."""
        t = self._tenant_of(obj) if self._tenant_of is not None else None
        if t is None:
            return True
        q = self._tenant_quota.get(t)
        if q is not None and self.tenant_bytes.get(t, 0.0) >= q:
            return False
        self._tenant_owner[obj] = t
        self.tenant_bytes[t] = self.tenant_bytes.get(t, 0.0) + size
        return True

    def _tenant_forget(self, obj: str, size: float) -> None:
        t = self._tenant_owner.pop(obj, None)
        if t is not None:
            self.tenant_bytes[t] = max(0.0, self.tenant_bytes.get(t, 0.0) - size)

    def _place(self, obj: str, size: float, start: int, dropped: List[str]) -> None:
        if (self._tenant_quota is not None and obj not in self._tenant_owner
                and not self._quota_admit(obj, size)):
            # Tenant at cap: same pass-through exit as fitting no tier.
            self.quota_refusals += 1
            size_dropped = self._sizes.pop(obj, 0.0)
            dropped.append(obj)
            self.drops += 1
            if self.index is not None:
                self.index.remove(obj, self.name)
            if self._on_drop is not None:
                self._on_drop(obj, size_dropped)
            if self.payload is not None:
                self.payload.dropped(obj)
            return
        for i in range(start, len(self.tiers)):
            tier = self.tiers[i]
            if size > tier.spec.capacity_bytes:
                continue                       # too big for this tier: go down
            victims = tier.cache.insert(obj, size)
            self._tier_idx[obj] = i
            if self.index is not None:
                self.index.add(obj, self.name, tier=tier.name)
            if self.payload is not None:
                # one hook covers admit, promote, demote, victim demotion;
                # the backend moves real bytes iff it holds them (else this
                # is a tolerated placeholder notification).
                self.payload.moved(obj, tier.name)
            for victim in victims:
                vsize = self._sizes[victim]
                del self._tier_idx[victim]     # off this tier; re-place below
                self.demotions += 1
                self._place(victim, vsize, i + 1, dropped)
            return
        # No tier from `start` down can hold it: it leaves the node entirely.
        size_dropped = self._sizes.pop(obj, 0.0)
        self._tenant_forget(obj, size_dropped)
        dropped.append(obj)
        self.drops += 1
        if self.index is not None:
            self.index.remove(obj, self.name)
        if self._on_drop is not None:
            self._on_drop(obj, size_dropped)
        if self.payload is not None:
            self.payload.dropped(obj)

    def _relocate(self, obj: str, target: int) -> None:
        """Move a resident object to ``target`` tier (promotion path)."""
        i = self._tier_idx.pop(obj)
        self.tiers[i].cache.remove(obj)
        dropped: List[str] = []
        self._place(obj, self._sizes[obj], target, dropped)
