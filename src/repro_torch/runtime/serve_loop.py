"""Serving runtime on torch: cache-affinity request routing + elastic
replica pool.

The paper's data-aware dispatch, reincarnated for LLM serving: a request's
data objects are its session's KV-cache segments (prefix blocks).  Replicas
that already hold a session's state serve it from "local cache" (decode
continues in place); a replica without it pays the "copy" cost (replaying
the prefix = the paper's persistent-store fetch).  Routing, per-replica
transient-store accounting (``core.cache.Cache``), index publication, and
DRP-driven elasticity all live in ``runtime.router.CacheAffinityRouter`` —
this module owns only the model: params, prefill, decode, KV tensors.

A port of the reference's ``runtime/serve_loop.py``: routing is the copied
``CacheAffinityRouter`` unchanged, the model is the torch decoder on
``device`` (the card by default; ``device="cpu"`` runs the kernels' plain
versions).  ``payload="real"`` moves each session's KV tensors between the
card, host memory and disk under the tier bookkeeping.  With the
vectorized dispatcher, each step() (one drain epoch) also runs the
dispatcher's scoring on the model's device: the dispatch-score kernel
rescores the window and the rank-K kernel keeps the device-resident score
mirror current, each held exactly to the host matrices.

``ctx`` serves under a mesh, as the reference's ``DiffusionServer(ctx=)``
does: the params are placed by their path rules (``tree_param_specs``),
the decode caches by ``cache_leaf_spec``, the prompt and each token on
'dp', and prefill and decode run under the mesh, every kernel on the
local shards.  Greedy decoding takes the argmax of each rank's replicated
logits.  Every rank runs the same routing on the same stream, so each
makes the same decisions.  The scoring kernels and the host matrices are
those of one device.

The server's phases run in named spans (``obs.spans``): ``serve.route``
(each call into the router), ``serve.score`` (the dispatcher's device
scoring, opened once the model's queued device work is done),
``serve.prefill`` with ``serve.cache`` inside it (a miss's prefill and the
decode cache made and filled from it), ``serve.decode`` (a request's decode
loop; each step runs in the model's ``model.decode``) and ``serve.payload``
(a swap-in's KV tensors handed back).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..core.provisioner import DynamicResourceProvisioner
from ..diffusion.payload import MeasuredBandwidth, RealPayload
from ..diffusion.tiers import TierSpec
from ..models import (cache_init, init_params, is_encdec, make_decode_step,
                      make_prefill_step)
from ..models.sharding import (ShardCtx, copy_into, distribute, distribute_tree,
                               tree_param_specs, write_prefix)
from ..obs.spans import span
from .router import (Assignment, AdmissionController, CacheAffinityRouter,
                     RoutedRequest)


@dataclass
class Request:
    request_id: int
    session_id: str
    prompt: np.ndarray              # token ids
    max_new_tokens: int = 8
    submit_time_s: float = 0.0
    finish_time_s: Optional[float] = None
    replica: Optional[str] = None
    prefix_hit: bool = False
    tenant: str = ""                # multi-tenant admission account
    verdict: Optional[Any] = None   # AdmissionVerdict when admission is on

    @property
    def response_time_s(self) -> Optional[float]:
        if self.finish_time_s is None:
            return None
        return self.finish_time_s - self.submit_time_s


class Replica:
    """One model replica: params + per-session KV tensors.

    Which sessions *may* live here (capacity, eviction order) is decided by
    the router's ``ReplicaStore``; this class just holds the payloads.
    """

    def __init__(self, name: str, cfg: ArchConfig, params, cap: int):
        self.name = name
        self.cfg = cfg
        self.params = params
        self.cap = cap
        self.sessions: Dict[str, Dict[str, Any]] = {}  # sid -> {caches, pos}

    def has_session(self, sid: str) -> bool:
        return sid in self.sessions


@dataclass
class ServeStats:
    served: int = 0
    prefix_hits: int = 0
    swap_ins: int = 0               # prefix found in a lower tier (host DRAM)
    prefills: int = 0
    decode_steps: int = 0
    restore_time_s: float = 0.0     # tier swap-in / transfer cost charged
    response_times: List[float] = field(default_factory=list)

    @property
    def hit_rate(self) -> float:
        return self.prefix_hits / self.served if self.served else 0.0

    @property
    def avg_response_s(self) -> float:
        return float(np.mean(self.response_times)) if self.response_times else 0.0

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view (prefixed ``serve.`` when adopted)."""
        from ..obs.registry import stats_snapshot
        return stats_snapshot(self, props=("hit_rate", "avg_response_s"))


@dataclass
class ScoreStats:
    """Device-side scoring of the vectorized dispatcher, per drain epoch."""
    epochs: int = 0
    rows_rescored: int = 0          # window rows through the bulk rescore
    max_rows: int = 0
    rank_k_keys: int = 0            # presence-delta keys through the mirror
    max_epoch_keys: int = 0


CACHE_CAP = 128                     # decode-cache length per session


def session_object(sid: str) -> str:
    """Logical data-object name for a session's KV prefix state."""
    return f"kv:{sid}"


class DiffusionServer:
    """Single-process serving demo with the paper's routing policies."""

    def __init__(
        self,
        cfg: ArchConfig,
        *,
        policy: str = "good-cache-compute",
        max_replicas: int = 4,
        min_replicas: int = 1,
        cache_cap: int = CACHE_CAP,
        max_sessions: int = 8,
        host_cache_sessions: int = 0,
        eviction: str = "lru",
        dispatcher_impl: str = "reference",
        # batch_drain=True runs the serving batch plane: submit() only
        # enqueues, and step() decides the whole accumulated burst in one
        # notify_batch() window scan with tier promotions applied as a
        # per-batch delta and misses admitted through one batched transfer
        # resolution.  Best paired with dispatcher_impl="vectorized".
        batch_drain: bool = False,
        # payload="real" runs the physical plane under the tier bookkeeping:
        # each session's KV tree is registered with its replica store's
        # RealPayload backend, HBM evictions demote copies of the actual
        # tensors to host memory (and to verified spill files when spill_dir
        # names a disk tier home), and a lower-tier prefix hit copies the
        # real bytes back onto the device — wall-clock timed into
        # ``self.measured`` (the dram->hbm edge is the measured swap-in
        # bandwidth).  Routing decisions are identical to payload="modeled"
        # by construction.
        payload: str = "modeled",
        spill_dir: Optional[str] = None,
        # obs: a repro.obs.Observability instance threads the unified
        # observability plane through the server — every stats island
        # (serve/router/dispatch/transfer/tiers/...) is adopted into its
        # registry, the request span chain lands in its trace ring, and the
        # paper's live performance metrics accumulate in its PerfMeter.
        # None (default) is the zero-overhead stub path.
        obs: Optional[Any] = None,
        # chaos: a runtime.chaos.ChaosInjector drives seeded fault injection
        # (replica crashes, stragglers, transfer flakes, spill corruption)
        # through the per-step chaos tick.  Attached-but-idle (schedule with
        # all rates 0) is a strict no-op: the serving stream is bit-identical
        # to chaos=None (bench_chaos gates on it).
        chaos: Optional[Any] = None,
        # heartbeat_timeout_s enables the liveness plane: replicas heartbeat
        # every step, lapsed beats crash them through fail_replica, and EWMA
        # stragglers lose cache-affinity dispatch ties.
        heartbeat_timeout_s: Optional[float] = None,
        straggler_factor: float = 2.0,
        # Multi-tenant overload plane: tenants > 0 builds an
        # AdmissionController over tenants t0..t{n-1} — requests carry a
        # tenant label, enqueue becomes a backpressure contract, and under
        # overload the lowest-credit tenant sheds first.  slo_per_tenant
        # (the ``p99_ms=50:hit_rate=0.8`` CLI grammar) gives every tenant
        # its own SLO board feeding the credit formula;
        # tenant_quota_frac > 0 caps each tenant's resident session slots
        # at frac * max_sessions per replica.  An explicit ``admission``
        # instance overrides all three.
        admission: Optional[AdmissionController] = None,
        tenants: int = 0,
        slo_per_tenant: str = "",
        tenant_quota_frac: float = 0.0,
        ctx: ShardCtx = ShardCtx(),
        seed: int = 0,
        device: str = "cuda",
        # params: the model's weights (a tree as init_params draws it, on
        # ``device``) in place of the server's own draw from ``seed``.
        params: Optional[Any] = None,
        # on_token(request_id, pos, logits) is called after each decode
        # step a request runs, with the step's input position and logits.
        # ``logits`` is the decode step's own output buffer, which a later
        # step may reuse: a caller that keeps it copies it.
        on_token: Optional[Callable[[int, int, Any], None]] = None,
    ):
        if payload not in ("modeled", "real"):
            raise ValueError(f"payload must be 'modeled' or 'real': {payload!r}")
        if is_encdec(cfg):
            # the reference cannot serve one either: its prefill batch is
            # {"tokens": prompt} (repro/runtime/serve_loop.py), while
            # encdec_prefill reads batch["audio_embeds"]
            raise NotImplementedError(
                f"{cfg.name}: the server's prefill batch holds tokens only, and "
                "an encoder-decoder prefill needs audio_embeds; the reference's "
                "DiffusionServer serves no encoder-decoder either")
        self.cfg = cfg
        self.ctx = ctx
        self.device = torch.device(device)
        self.cap = cache_cap
        self.measured = MeasuredBandwidth()
        self.payload_mode = payload
        if params is None:
            params = init_params(cfg, device=self.device, seed=seed)
        self.params = distribute_tree(ctx, params, tree_param_specs(ctx, params))
        shape = ShapeConfig("serve", "prefill", cache_cap, 1)
        self.prefill_fn = make_prefill_step(cfg, shape, ctx=ctx)
        self.decode_fn = make_decode_step(cfg, ctx=ctx)
        # host_cache_sessions > 0 enables the tiered diffusion plane: HBM
        # session slots backed by a host-DRAM tier, so an HBM eviction
        # demotes the KV prefix instead of dropping it and a later request
        # swaps it back in without a prefill replay.
        tier_specs = None
        if host_cache_sessions > 0:
            tier_specs = [
                TierSpec("hbm", float(max_sessions), eviction=eviction),
                TierSpec("dram", float(host_cache_sessions), eviction=eviction),
            ]
        self._tenants = int(tenants)
        if admission is None and tenants > 0:
            from ..obs.slo import parse_slo_specs
            names = [f"t{i}" for i in range(tenants)]
            specs = parse_slo_specs(slo_per_tenant) if slo_per_tenant else None
            admission = AdmissionController(
                names,
                slo_specs_by_tenant=(
                    {n: specs for n in names} if specs else None),
                tier_quota_bytes=(
                    {n: tenant_quota_frac * max_sessions for n in names}
                    if tenant_quota_frac > 0.0 else None),
            )
        self.router = CacheAffinityRouter(
            policy=policy,
            window=64,
            # each session's KV state is one unit-sized object; the store's
            # byte capacity is therefore the session-slot count.
            replica_capacity_bytes=float(max_sessions),
            eviction=eviction,
            object_size_fn=lambda obj: 1.0,
            tier_specs=tier_specs,
            provisioner=DynamicResourceProvisioner(
                max_nodes=max_replicas, min_nodes=min_replicas,
                policy="watermark", tasks_per_node_target=4.0,
                allocation_latency_s=(0.0, 0.0),
            ),
            spawn_replica=self._build_replica,
            stop_replica=self._drop_replica,
            on_object_evicted=self._on_session_evicted,
            dispatcher_impl=dispatcher_impl,
            batch_drain=batch_drain,
            transfer_payload=payload if tier_specs is not None else "modeled",
            payload_factory=(
                # Serving path degrades on a poisoned spill chunk instead of
                # failing the request: drop the copy, quarantine, re-fetch.
                (lambda name: RealPayload(name=name, measured=self.measured,
                                          spill_dir=spill_dir,
                                          device=self.device,
                                          corrupt_mode="recover"))
                if payload == "real" and tier_specs is not None else None),
            obs=obs,
            chaos=chaos,
            heartbeat_timeout_s=heartbeat_timeout_s,
            straggler_factor=straggler_factor,
            admission=admission,
        )
        # The vectorized dispatcher's scoring runs on the model's device,
        # once per step() (one drain epoch): the epoch opens with a bulk
        # rescore of the window (dispatch-score kernel) and closes by
        # flushing its presence deltas into the device-resident Sw mirror
        # (rank-K kernel).  Both are held to the incremental host matrices,
        # which stay decision-authoritative, and a difference raises: with
        # the dyadic tier weights serving uses they are exact.  On a CPU
        # device the plain versions run.
        self.score_stats = ScoreStats()
        if dispatcher_impl == "vectorized":
            disp = self.router.dispatcher
            if self.device.type == "cuda":
                disp.score_backend = "cuda"
            disp.attach_device_mirror(backend="cuda", device=str(self.device))
        self.admission = admission
        self.chaos = chaos
        self.batch_drain = batch_drain
        self.replicas: Dict[str, Replica] = {}
        for _ in range(min_replicas):
            self._build_replica(self.router.add_replica())
        self.router.drp.registered = min_replicas
        self.stats = ServeStats()
        self.on_token = on_token
        self.obs = obs
        self._trace = obs.trace if obs is not None else None
        if obs is not None:
            obs.registry.register_source("serve", self.stats)
        self._ready: List[Assignment] = []
        self._req_id = 0

    # ---------------------------------------------------------- replicas
    def _build_replica(self, name: str) -> None:
        self.replicas[name] = Replica(name, self.cfg, self.params, self.cap)

    def _drop_replica(self, name: str) -> None:
        """Router idle-released the replica: free its KV payloads too."""
        self.replicas.pop(name, None)

    def _on_session_evicted(self, replica: str, obj: str) -> None:
        rep = self.replicas.get(replica)
        if rep is not None:
            rep.sessions.pop(obj[len("kv:"):], None)

    def scale_to(self, n: int) -> None:
        while len(self.replicas) < n:
            self._build_replica(self.router.add_replica())
        while len(self.replicas) > n:
            name = next(reversed(self.replicas))
            self.router.remove_replica(name)
            del self.replicas[name]
        self.router.drp.registered = n

    def _on_dp(self, x):
        """A batch-leading tensor (the same on every rank) placed on 'dp'."""
        return distribute(self.ctx, x, self.ctx.spec(["dp"] + [None] * (x.ndim - 1),
                                                     x.shape))

    def _greedy(self, logits):
        """argmax over the vocab of each rank's replicated logits rows."""
        B = logits.shape[0]
        return self.ctx.local_call(lambda lg: torch.argmax(lg, dim=-1), (logits,),
                                   [("dp", None)], [(("dp",), (B,))])

    def swap_in_bandwidth(self) -> float:
        """Measured dram->hbm swap-in bytes/s (0.0 until one happened)."""
        return self.measured.bandwidth("dram", "hbm")

    # ------------------------------------------------------------ submit
    def tenant_of_session(self, session_id: str) -> str:
        """Stable session → tenant assignment ("" when single-tenant):
        trailing digits modulo the tenant count, so seeded workloads land
        the same sessions on the same tenants every run."""
        if self._tenants <= 0:
            return ""
        digits = "".join(ch for ch in session_id if ch.isdigit())
        h = int(digits) if digits else sum(session_id.encode())
        return f"t{h % self._tenants}"

    def arrival_multiplier(self) -> float:
        """Chaos arrival-spike factor for this step (1.0 = no spike) — the
        workload driver multiplies its offered load by it."""
        return self.chaos.arrival_multiplier() if self.chaos is not None else 1.0

    def submit(self, session_id: str, prompt: np.ndarray,
               max_new_tokens: int = 8,
               tenant: Optional[str] = None) -> Request:
        now = time.time()
        tenant = self.tenant_of_session(session_id) if tenant is None else tenant
        req = Request(self._req_id, session_id, prompt, max_new_tokens,
                      submit_time_s=now, tenant=tenant)
        self._req_id += 1
        routed = RoutedRequest(req.request_id, (session_object(session_id),),
                               payload=req, submit_time_s=now, tenant=tenant)
        # enqueue carries the backpressure contract; a REJECTED request is
        # refused at the edge (counted + traced), never silently dropped.
        with span("serve.route"):
            req.verdict = self.router.enqueue(routed, now=now)
            if not self.batch_drain:
                # The router runs phase 1 (and DRP scaling) immediately;
                # execution happens in step().  Requests whose policy delays
                # dispatch stay in the wait queue until a replica frees and
                # picks them (phase 2).  (Batch plane: only enqueue — step()
                # drains the accumulated burst in one notify_batch per tick.)
                self._ready.extend(self.router.tick(now))
        return req

    # ------------------------------------------------------------- serve
    def _run_request(self, replica: Replica, routed: RoutedRequest) -> None:
        req: Request = routed.payload
        req.replica = replica.name
        sid = req.session_id
        use_cache = self.router.dispatcher.provides_location_info()
        state = replica.sessions.get(sid) if use_cache else None
        if routed.hits and state is not None:
            req.prefix_hit = True
            self.stats.prefix_hits += 1
            # Charge restore by the tier the prefix was found in: an HBM hit
            # continues in place for free; a lower-tier (host DRAM) hit is a
            # swap-in — far cheaper than a prefill replay, but not free.
            found = routed.sources.get(session_object(sid))
            store = self.router.stores.get(replica.name)
            caches, pos = state["caches"], state["pos"]
            if store is not None and found is not None and found != store.top_tier:
                self.stats.swap_ins += 1
                if self.payload_mode == "real":
                    # The routing access already promoted the object, which
                    # made the backend copy the demoted host bytes back onto
                    # the device (timed into self.measured).  Decode must
                    # continue on those swapped-in tensors (``value`` hands
                    # out a copy, which decode may update in place), not on
                    # the working copy the eviction left behind.
                    # The ring's "payload" span: the real KV bytes
                    # returning to the device for this request.
                    backend = store.tiers.payload
                    with span("serve.payload", self._trace, routed.request_id,
                              "payload", "dispatch", replica.name,
                              (found, store.top_tier), ring=session_object(sid)):
                        restored = (backend.value(session_object(sid))
                                    if backend is not None else None)
                    if restored is not None:
                        caches = restored
            self.stats.restore_time_s += routed.restore_cost_s
        else:
            # "copy from persistent storage": replay the prompt (prefill).
            self.stats.prefills += 1
            pos = req.prompt.shape[0]
            # The ring's "prefill" compute span is a segment timestamp for
            # the critical-path analyzer: compute phases are not attribution
            # segments (they land in "service" by construction), but the
            # span makes the prefill-vs-decode split visible in the exports.
            with span("serve.prefill", self._trace, routed.request_id, "compute",
                      "dispatch", replica.name, (pos,)):
                prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                         device=self.device)[None, :]
                batch = {"tokens": self._on_dp(prompt)}
                _, pre_caches = self.prefill_fn(self.params, batch)
                # prefill caches are full-seq; re-home into a decode cache buffer
                with span("serve.cache"):
                    caches = cache_init(self.cfg, 1, self.cap, device=self.device,
                                        ctx=self.ctx)
                    caches = _merge_prefill_caches(caches, pre_caches, self.cfg)

        steps = max(0, min(req.max_new_tokens, self.cap - 1 - pos))
        with span("serve.decode", self._trace, routed.request_id, "compute", "dispatch",
                  replica.name, (pos + steps,)):
            token = self._on_dp(torch.tensor([int(req.prompt[-1]) % self.cfg.vocab_size],
                                             dtype=torch.int64, device=self.device))
            for _ in range(steps):
                logits, caches = self.decode_fn(
                    self.params, {"token": token, "pos": pos, "caches": caches}
                )
                if self.on_token is not None:
                    self.on_token(req.request_id, pos, logits)
                token = self._greedy(logits)
                pos += 1
                self.stats.decode_steps += 1
        if use_cache:
            # keep the KV payload iff the router's store admitted the object
            # (first-available ships no location info and caches nothing;
            # pass-through objects larger than the store are never admitted,
            # so their payloads must not linger unaccounted either).
            store = self.router.stores.get(replica.name)
            if store is not None and store.contains(session_object(sid)):
                replica.sessions[sid] = {"caches": caches, "pos": pos}
                if self.payload_mode == "real":
                    backend = store.tiers.payload
                    if backend is not None:
                        # Register/refresh the session's actual KV bytes in
                        # the physical plane so later demotions/swap-ins
                        # move real tensors (an untimed copy of the working
                        # caches, not a tier move).
                        obj = session_object(sid)
                        backend.put(obj, caches,
                                    store.tier_of(obj) or store.top_tier)
            else:
                replica.sessions.pop(sid, None)
        req.finish_time_s = time.time()
        self.stats.served += 1
        self.stats.response_times.append(req.response_time_s)

    # -------------------------------------------------------------- chaos
    def chaos_tick(self, now: Optional[float] = None) -> List[str]:
        """One failure-domain step: feed heartbeats (straggle-inflated when
        chaos says so), crash this step's victims, corrupt a spilled chunk.
        Called once per ``step()``; safe (and a strict no-op) with no chaos
        injector and no heartbeat monitor attached.  Returns replicas
        crashed this tick."""
        now = time.time() if now is None else now
        chaos = self.chaos
        if self.router.monitor is not None:
            for name in self.router.replicas():
                factor = chaos.service_factor(name) if chaos is not None else 1.0
                self.router.record_heartbeat(name, 1.0 * factor, now)
            self.router.check_liveness(now)
        if chaos is None or chaos.idle:
            return []
        victims, _fresh = chaos.begin_step(self.router.replicas())
        for name in victims:
            self.router.fail_replica(name, now)
        self._inject_corruption(chaos)
        return victims

    def _inject_corruption(self, chaos: Any) -> None:
        """Flip one byte in one spilled KV chunk (sha256 will catch it on
        the next read; recover mode turns that into a drop + re-fetch)."""
        from .chaos import flip_spill_byte
        for store in self.router.stores.values():
            backend = store.tiers.payload
            spilled = [obj for obj, leaves in getattr(backend, "_leaves",
                                                      {}).items()
                       if leaves and hasattr(leaves[0], "chunks")]
            victim = chaos.corruption_victim(spilled)
            if victim is not None:
                flip_spill_byte(backend, victim)

    def step(self) -> int:
        """Execute routed work until queue and assignments drain. Returns served."""
        served = 0
        idle_rounds = 0
        if self.chaos is not None or self.router.monitor is not None:
            self.chaos_tick(time.time())
        if self.score_mirror is not None:
            self._rescore_window()
        while (self._ready or self.router.queue_length() > 0
               or self.router.pending_admission() > 0):
            if not self._ready:
                # delayed requests: replicas all freed by now, re-run phase 1
                with span("serve.route"):
                    self._ready.extend(self.router.tick(time.time()))
                idle_rounds += 1
                if not self._ready and idle_rounds > 2:
                    break  # policy refuses the remainder (all holders lost)
                continue
            idle_rounds = 0
            if self.batch_drain:
                # Batch plane: run the whole ready wave, then hand the
                # finished requests back as one batched completion — a
                # single drain (and pickup pass) instead of one per request.
                wave, self._ready = self._ready, []
                finished: List[RoutedRequest] = []
                for assignment in wave:
                    replica = self.replicas.get(assignment.replica)
                    for routed in assignment.requests:
                        if replica is None \
                                or routed.replica != assignment.replica:
                            continue    # crashed from under the assignment;
                            #             the router already requeued it
                        self._run_request(replica, routed)
                        served += 1
                        finished.append(routed)
                with span("serve.route"):
                    self._ready.extend(
                        self.router.complete_batch(finished, now=time.time()))
                continue
            assignment = self._ready.pop(0)
            replica = self.replicas.get(assignment.replica)
            for routed in assignment.requests:
                if replica is None or routed.replica != assignment.replica:
                    continue            # crashed from under the assignment
                self._run_request(replica, routed)
                served += 1
                with span("serve.route"):
                    self._ready.extend(self.router.complete(routed, now=time.time()))
        if self.score_mirror is not None:
            self._flush_scores()
        return served

    # ------------------------------------------------------ device scores
    @property
    def score_mirror(self):
        """The vectorized dispatcher's device score mirror (None under the
        reference dispatcher); step() owns its flush cadence."""
        return getattr(self.router.dispatcher, "_mirror", None)

    def _wait_for_model(self) -> None:
        """Wait for the device work already queued (the model's) before a
        scoring span: the scoring's uploads and read-back wait for it in
        any case, and ``serve.score`` then times the dispatcher alone."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _rescore_window(self) -> None:
        """Epoch open: the window's bulk rescore (on the device under CUDA)
        must equal the dispatcher's incremental score rows."""
        disp = self.router.dispatcher
        self._wait_for_model()
        with span("serve.score"):
            sb, sw = disp.rebuild_scores()
            rows = np.sort(np.fromiter(disp._item_row.values(), dtype=np.intp,
                                       count=len(disp._item_row)))
            if not (np.array_equal(sb, disp._Sb[rows])
                    and np.array_equal(sw, disp._Sw[rows])):
                raise RuntimeError("device rescore disagrees with the "
                                   "dispatcher's incremental scores")
        st = self.score_stats
        st.epochs += 1
        st.rows_rescored += len(rows)
        st.max_rows = max(st.max_rows, len(rows))

    def _flush_scores(self) -> None:
        """Epoch close: apply the epoch's presence deltas to the device
        mirror, which must then equal the host Sw."""
        self._wait_for_model()
        with span("serve.score"):
            keys = self.score_mirror.flush()
            err = self.score_mirror.verify()
        if err != 0.0:
            raise RuntimeError(f"device score mirror off by {err} after a flush")
        st = self.score_stats
        st.rank_k_keys += keys
        st.max_epoch_keys = max(st.max_epoch_keys, keys)


def _merge_prefill_caches(decode_caches, prefill_caches, cfg: ArchConfig):
    """Copy prefill K/V (length S) into the decode cache buffers (cap >= S),
    in place; returns ``decode_caches``.  DTensor buffers stay where they
    are: each rank copies into its own shard (``write_prefix``)."""

    def merge(dst, src):
        if isinstance(dst, dict):
            return {k: merge(dst[k], src[k]) for k in dst}
        if isinstance(dst, (list, tuple)):
            return type(dst)(merge(d, s) for d, s in zip(dst, src))
        if dst.ndim >= 3 and src.ndim == dst.ndim and src.shape != dst.shape:
            # K/V buffers: [.., B, S, H, D] into [.., B, cap, H, D]
            if src.shape[-3] <= dst.shape[-3]:
                write_prefix(dst, dst.ndim - 3, src)
            return dst
        if src.shape == dst.shape:
            copy_into(dst, src)
        return dst

    return merge(decode_caches, prefill_caches)
