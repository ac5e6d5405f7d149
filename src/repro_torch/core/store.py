"""Data stores with load-dependent available bandwidth (paper Section 4.1).

Implements the abstract model's store taxonomy:

  * persistent stores  Pi  (|Pi| >= 1): highly available, large, shared —
    GPFS in the paper, an object store (GCS-like) in the TPU adaptation.
  * transient stores   T   (|T| >= 0): co-located with compute, small,
    lower-latency — executor local disk in the paper, host DRAM here.

Bandwidth model:  ideal bandwidth nu(store); load omega(store) = number of
concurrent transfers; available bandwidth eta(nu, omega) = nu for omega == 0
and nu / omega for omega >= 1 (fair processor sharing).  Copy time
zeta(delta, tau) = beta(delta) / min(eta_src, eta_dst)   — paper Eq. (copy time).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from .cache import Cache


def eta(nu: float, omega: int) -> float:
    """Available bandwidth under load (paper: eta(nu(.), omega(.)))."""
    return nu if omega <= 0 else nu / omega


@dataclass
class DataObject:
    """delta in Delta: a logical immutable object with size beta(delta)."""

    name: str
    size_bytes: float

    @property
    def beta(self) -> float:
        return self.size_bytes


class BandwidthResource:
    """A shared link/disk with ideal bandwidth nu and load tracking omega."""

    def __init__(self, name: str, nu_bytes_per_s: float):
        self.name = name
        self.nu = float(nu_bytes_per_s)
        self.omega = 0  # concurrent transfers
        self.bytes_served = 0.0

    def available(self, extra_load: int = 1) -> float:
        """Bandwidth a new transfer would get: eta(nu, omega + extra)."""
        return eta(self.nu, self.omega + extra_load)

    def begin(self) -> None:
        self.omega += 1

    def end(self, nbytes: float) -> None:
        self.omega = max(0, self.omega - 1)
        self.bytes_served += nbytes


class PersistentStore:
    """pi in Pi — e.g. GPFS / object store.  Holds every object (Delta)."""

    def __init__(self, name: str, nu_bytes_per_s: float):
        self.name = name
        self.link = BandwidthResource(f"{name}.link", nu_bytes_per_s)
        self.objects: Dict[str, DataObject] = {}

    def add(self, obj: DataObject) -> None:
        self.objects[obj.name] = obj

    def __contains__(self, name: str) -> bool:
        return name in self.objects

    def size_of(self, name: str) -> float:
        return self.objects[name].size_bytes


class TransientStore:
    """tau in T — a node-local cache plus disk + NIC bandwidth resources.

    In the paper each *node* hosts one cache shared by its executors (one per
    CPU), a local disk serving cache hits, and a GridFTP server (NIC) serving
    peer reads.  sigma(tau) = cache capacity.
    """

    def __init__(
        self,
        name: str,
        capacity_bytes: float,
        disk_bw_bytes_per_s: float,
        nic_bw_bytes_per_s: float,
        eviction: str = "lru",
    ):
        self.name = name
        self.cache = Cache(capacity_bytes, policy=eviction)
        self.disk = BandwidthResource(f"{name}.disk", disk_bw_bytes_per_s)
        self.nic = BandwidthResource(f"{name}.nic", nic_bw_bytes_per_s)

    @property
    def sigma(self) -> float:
        return self.cache.capacity_bytes

    def __contains__(self, name: str) -> bool:
        return name in self.cache


def copy_time(
    size_bytes: float,
    src: BandwidthResource,
    dst: Optional[BandwidthResource] = None,
    latency_s: float = 0.0,
) -> float:
    """zeta(delta, tau): transfer time at the min of src/dst available bw.

    Rates are frozen at transfer start (load-at-admission approximation of
    processor sharing) — the same simplification the paper's model makes.
    """
    rate = src.available()
    if dst is not None:
        rate = min(rate, dst.available())
    rate = max(rate, 1e-9)
    return latency_s + size_bytes / rate
