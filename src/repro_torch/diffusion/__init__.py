"""Tiered data-diffusion plane: the data layer scheduler and router diffuse
objects through.

  * ``tiers``    — ``TieredStore``: HBM -> host DRAM -> local disk stacks with
    promote-on-access / demote-on-evict and per-tier index publication.
  * ``transfer`` — ``TransferEngine``: cheapest-source (peer NIC vs persistent
    store) resolution with single-flight dedup and bounded concurrency.
  * ``payload``  — the physical plane under the bookkeeping: the modeled
    and in-memory backends and the measured-bandwidth accumulator, checked
    against the ``launch.rooflines`` machine model.  ``RealPayload`` (KV
    tensors moved between device, host and verified disk spill) is not
    ported yet.
  * ``prefetch`` — ``Prefetcher``: warm an executor's tiers for upcoming work
    so transfer overlaps compute.
"""

from .payload import (
    FakePayload,
    MeasuredBandwidth,
    NullPayload,
    PayloadBackend,
)
from .prefetch import Prefetcher, PrefetchStats
from .tiers import StoreTier, TieredStore, TierSpec, default_tier_weights, serving_tier_specs
from .transfer import Transfer, TransferEngine, TransferStats

__all__ = [
    "FakePayload",
    "MeasuredBandwidth",
    "NullPayload",
    "PayloadBackend",
    "Prefetcher",
    "PrefetchStats",
    "StoreTier",
    "TieredStore",
    "TierSpec",
    "Transfer",
    "TransferEngine",
    "TransferStats",
    "default_tier_weights",
    "serving_tier_specs",
]
