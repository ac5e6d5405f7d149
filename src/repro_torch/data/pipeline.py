"""Diffusion-scheduled training data pipeline.

The paper's technique as a first-class data-plane feature: dataset *shards*
are the data objects; per-host DRAM caches are the transient stores; the
persistent store is an (emulated) object store; and microbatch tasks are
dispatched to data-parallel replicas by the SAME ``DataAwareScheduler`` the
DES validates (good-cache-compute by default) — so locality-of-reference in
the shard access stream turns into cache hits instead of object-store reads.

Everything is deterministic: shard contents derive from a seed + shard id,
so restarts (fault tolerance) replay identical data.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.cache import Cache
from ..core.index import CentralizedIndex
from ..core.scheduler import DataAwareScheduler
from ..core.task import ExecutorState, Task


@dataclass
class ShardSpec:
    shard_id: int
    num_tokens: int
    seed: int

    @property
    def name(self) -> str:
        return f"shard-{self.seed:04d}-{self.shard_id:06d}"

    @property
    def nbytes(self) -> int:
        return self.num_tokens * 4


class ObjectStoreEmulator:
    """Persistent store: materializes shard token arrays deterministically.

    ``read_delay_per_byte`` emulates object-store bandwidth so cache hits are
    measurably cheaper in examples/tests (0 disables the delay)."""

    def __init__(self, vocab_size: int, read_delay_per_byte: float = 0.0):
        self.vocab = vocab_size
        self.read_delay_per_byte = read_delay_per_byte
        self.reads = 0
        self.bytes_read = 0

    def fetch(self, spec: ShardSpec) -> np.ndarray:
        self.reads += 1
        self.bytes_read += spec.nbytes
        if self.read_delay_per_byte:
            time.sleep(self.read_delay_per_byte * spec.nbytes)
        # content-addressed deterministic tokens
        digest = hashlib.sha256(spec.name.encode()).digest()
        rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
        return rng.integers(0, self.vocab, size=(spec.num_tokens,), dtype=np.int32)


class HostShardCache:
    """Per-host DRAM shard cache: core Cache bookkeeping + payload dict."""

    def __init__(self, capacity_bytes: float, eviction: str = "lru"):
        self.meta = Cache(capacity_bytes, policy=eviction)
        self.payloads: Dict[str, np.ndarray] = {}

    def get(self, name: str) -> Optional[np.ndarray]:
        if self.meta.access(name):
            return self.payloads[name]
        return None

    def put(self, name: str, payload: np.ndarray) -> List[str]:
        evicted = self.meta.insert(name, payload.nbytes)
        for ev in evicted:
            self.payloads.pop(ev, None)
        if name in self.meta:
            self.payloads[name] = payload
        return evicted


@dataclass
class PipelineConfig:
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 8
    shard_tokens: int = 1 << 14
    num_shards: int = 64
    cache_bytes_per_host: float = 1 << 20
    policy: str = "good-cache-compute"
    eviction: str = "lru"
    locality: int = 8            # consecutive batches drawn from one shard
    seed: int = 0
    prefetch_depth: int = 2


class DiffusionDataPipeline:
    """Assigns shard-read tasks to host workers by cache affinity.

    ``hosts`` model the data-parallel replicas' host processes (in-process
    here; the dispatch plane is host-level and framework-agnostic).
    """

    def __init__(self, cfg: PipelineConfig, num_hosts: int):
        self.cfg = cfg
        self.store = ObjectStoreEmulator(cfg.vocab_size)
        self.index = CentralizedIndex()
        self.sched = DataAwareScheduler(
            policy=cfg.policy, window=256, index=self.index, max_replicas=2
        )
        self.caches: Dict[str, HostShardCache] = {}
        for i in range(num_hosts):
            name = f"host{i}"
            self.caches[name] = HostShardCache(cfg.cache_bytes_per_host, cfg.eviction)
            self.sched.register_executor(name)
        self.specs = [
            ShardSpec(i, cfg.shard_tokens, cfg.seed) for i in range(cfg.num_shards)
        ]
        self._rng = np.random.default_rng(cfg.seed)
        self._task_id = 0
        self._access_plan = self._make_access_plan()
        self.stats = {"hits": 0, "misses": 0, "store_reads": 0}

    # ------------------------------------------------------------- access
    def _make_access_plan(self) -> Iterator[int]:
        """Shard access stream with locality of reference (paper Sec. 1)."""
        def gen():
            while True:
                sid = int(self._rng.integers(0, self.cfg.num_shards))
                for _ in range(self.cfg.locality):
                    yield sid
        return gen()

    def add_host(self, name: str) -> None:
        self.caches[name] = HostShardCache(self.cfg.cache_bytes_per_host, self.cfg.eviction)
        self.sched.register_executor(name)

    def remove_host(self, name: str) -> None:
        self.caches.pop(name, None)
        self.sched.deregister_executor(name)

    def num_hosts(self) -> int:
        return len(self.caches)

    # ------------------------------------------------------------ batches
    def _read_shard(self, host: str, spec: ShardSpec) -> np.ndarray:
        cache = self.caches[host]
        payload = cache.get(spec.name)
        if payload is not None:
            self.stats["hits"] += 1
            return payload
        # peer fetch: any other host caching it (remote hit) else store
        for e in self.index.locations(spec.name):
            peer = self.caches.get(e)
            if peer is not None:
                payload = peer.get(spec.name)
                if payload is not None:
                    break
        if payload is None:
            payload = self.store.fetch(spec)
            self.stats["store_reads"] += 1
        self.stats["misses"] += 1
        evicted = cache.put(spec.name, payload)
        for ev in evicted:
            self.index.remove(ev, host)
        if spec.name in cache.meta:
            self.index.add(spec.name, host)
        return payload

    def next_batch(self) -> Tuple[np.ndarray, Dict[str, int]]:
        """Dispatch one shard-read task via the diffusion scheduler, slice a
        [global_batch, seq_len] token batch from it."""
        sid = next(self._access_plan)
        spec = self.specs[sid]
        task = Task(self._task_id, (spec.name,), compute_time_s=0.0)
        self._task_id += 1
        self.sched.submit(task)
        pair = self.sched.notify()
        if pair is None:  # policy delayed: synchronous pipeline forces head
            host = next(iter(self.caches))
            self.sched._dispatch(task, host)
        else:
            host, task = pair
        tokens = self._read_shard(host, spec)
        self.sched.set_state(host, ExecutorState.FREE)

        need = self.cfg.global_batch * (self.cfg.seq_len + 1)
        start = int(self._rng.integers(0, max(1, len(tokens) - need)))
        window = tokens[start : start + need]
        batch = window.reshape(self.cfg.global_batch, self.cfg.seq_len + 1)
        return batch, {"host": host, "shard": sid}

    def batches(self, n: int) -> Iterator[np.ndarray]:
        for _ in range(n):
            yield self.next_batch()[0]

    @property
    def hit_rate(self) -> float:
        tot = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / tot if tot else 0.0


class PrefetchingPipeline:
    """Thread-backed prefetch wrapper (hides store latency / stragglers)."""

    def __init__(self, pipeline: DiffusionDataPipeline, depth: int = 2):
        self.pipeline = pipeline
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._stop = False
        self._depth = depth
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while not self._stop:
            with self._lock:
                depth = len(self._queue)
            if depth >= self._depth:
                time.sleep(0.001)
                continue
            batch, info = self.pipeline.next_batch()
            with self._lock:
                self._queue.append((batch, info))

    def next_batch(self):
        while True:
            with self._lock:
                if self._queue:
                    return self._queue.popleft()
            time.sleep(0.0005)

    def close(self) -> None:
        self._stop = True
        self._thread.join(timeout=2)
