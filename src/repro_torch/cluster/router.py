"""Cluster router: replica-sharded verification behind one serving surface.

The port of ``repro.cluster.router`` for in-process replicas. At scale the
target tier is N engine replicas behind one front door; the
:class:`Router` owns them and turns admission into a placement decision:

  * **placement**: a :class:`PlacementPolicy` (``least-loaded``,
    ``affinity``, ``round-robin``, ``class-affinity``) picks the replica for
    each new stream among those with a free pool slot;
  * **migration**: when a stream retires and frees a slot, the router may
    pull an active stream over from the most-loaded replica
    (``migrate_on_retire``). The KV row is copied bit for bit
    (``export_stream``/``import_stream``: K/V, the int8 pool's scales, the
    ssm family's state), so migration never changes a stream's tokens,
    only which replica's batches it rides in;
  * **aggregation**: cluster stats are ``EngineStats.merge`` over the
    replicas, and verdicts carry replica-local queue-depth feedback.

Replicas come in two flavours behind one driver surface:

  :class:`LocalReplica` - an in-process ServerEngine;
  RemoteReplica (cluster/remote.py) - the same surface proxied to a worker
      process over the codec's control frames. The Router steps its remote
      replicas CONCURRENTLY on a thread pool (each worker verifies in its
      own process, with its own CUDA context on the card), and a transport
      failure evicts the replica (``_evict``) instead of stalling the
      fleet.

Migration is flavour-guarded: local <-> local moves copy the row in
memory; remote <-> remote moves ride ExportStream/ImportStream frames (both
workers rebuilt their weights from one spec seed); a mixed move raises
:class:`MigrationError`, since the two sides' weights have different
provenance.

The router mirrors the ServerEngine surface (admit / submit / step /
retire / cancel_request / force_extend / stats / warmup), so the in-process
pump and the transport server drive a replica fleet by holding a Router
where they held an engine.

Failures follow the default FaultPolicy, evict only: a replica whose
worker is unreachable is marked dead, its streams go to ``lost_devices``
and the survivors keep serving; with no replica left the router raises.
Respawn, stream recovery, heartbeats and flight recorders come with the
next slice (ROADMAP.md Queue A).
"""

from __future__ import annotations

import logging
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch import telemetry
from repro_torch.core.admission import DeviceStream
from repro_torch.core.engine import EngineStats, Verdict
from repro_torch.core.server_engine import ServerEngine

log = logging.getLogger(__name__)


class MigrationError(RuntimeError):
    """A stream move that cannot preserve bit-identity was requested."""


class LocalReplica:
    """In-process replica: a ServerEngine behind the replica surface.

    Everything not listed here (admit/submit/step/...) delegates to the
    engine; the explicit members are what the Router needs uniform across
    flavors (capacity, fingerprint).
    """

    flavor = "local"

    def __init__(self, engine: ServerEngine):
        self.engine = engine
        self.dead = False

    @property
    def n_free(self) -> int:
        return self.engine.pool.n_free

    @property
    def max_len(self) -> int:
        return self.engine.pool.max_len

    @property
    def fingerprint(self) -> tuple:
        e = self.engine
        # kv_dtype is part of the identity: an int8 row written into a bf16
        # pool (or the reverse) would be cast and corrupt the cache
        return (e.k_max, e.pool.max_len, e.greedy, e.paged_attention, e.kv_dtype)

    def drain(self) -> None:  # lifecycle parity with RemoteReplica
        pass

    def close(self) -> None:
        pass

    def __getattr__(self, name: str):
        return getattr(self.engine, name)


class PlacementPolicy:
    """Chooses the replica for a new stream; None when every pool is full."""

    name = "base"

    def choose(self, router: "Router", device_id: int) -> Optional[int]:
        raise NotImplementedError

    @staticmethod
    def _open(router: "Router") -> List[int]:
        return [i for i, r in enumerate(router.replicas) if not r.dead and r.n_free > 0]


class LeastLoadedPlacement(PlacementPolicy):
    """Fewest active streams wins (ties break toward the lowest replica id):
    keeps per-replica batch fill even under staggered arrivals."""

    name = "least-loaded"

    def choose(self, router: "Router", device_id: int) -> Optional[int]:
        open_ = self._open(router)
        if not open_:
            return None
        return min(open_, key=lambda i: (len(router.replicas[i].streams), i))


class AffinityPlacement(PlacementPolicy):
    """Deterministic device->replica hash (session/cache affinity); falls
    over to least-loaded when the home replica is full or dead."""

    name = "affinity"

    def choose(self, router: "Router", device_id: int) -> Optional[int]:
        home = device_id % len(router.replicas)
        if not router.replicas[home].dead and router.replicas[home].n_free > 0:
            return home
        return LeastLoadedPlacement().choose(router, device_id)


class RoundRobinPlacement(PlacementPolicy):
    """Cycle through replicas, skipping full pools and dead replicas."""

    name = "round-robin"

    def __init__(self) -> None:
        self._next = 0

    def choose(self, router: "Router", device_id: int) -> Optional[int]:
        n = len(router.replicas)
        for off in range(n):
            i = (self._next + off) % n
            if not router.replicas[i].dead and router.replicas[i].n_free > 0:
                self._next = i + 1
                return i
        return None


class ClassAffinityPlacement(PlacementPolicy):
    """Home a heterogeneous fleet's device CLASSES on replicas (class i ->
    replica i % n): same-class streams share a verify batch, so each
    replica's rounds keep one (k, c_th, draft model) shape. Spills to
    least-loaded when the home replica is full or dead.

    ``class_of`` maps device_id -> class index (System supplies it from the
    fleet spec); without one it degrades to per-device affinity.
    """

    name = "class-affinity"

    def __init__(self, class_of: Optional[Callable[[int], int]] = None) -> None:
        self.class_of = class_of

    def choose(self, router: "Router", device_id: int) -> Optional[int]:
        cls = self.class_of(device_id) if self.class_of is not None else device_id
        home = cls % len(router.replicas)
        if not router.replicas[home].dead and router.replicas[home].n_free > 0:
            return home
        return LeastLoadedPlacement().choose(router, device_id)


PLACEMENT_POLICIES = {
    p.name: p for p in (
        LeastLoadedPlacement, AffinityPlacement, RoundRobinPlacement, ClassAffinityPlacement,
    )
}


def make_placement(policy: str) -> PlacementPolicy:
    if policy not in PLACEMENT_POLICIES:
        raise ValueError(
            f"unknown placement policy {policy!r} (one of {sorted(PLACEMENT_POLICIES)})"
        )
    return PLACEMENT_POLICIES[policy]()


class _StreamView(Mapping):
    """Read-only dict-like view over every replica's streams: membership
    and lookup go through the router's placement map (O(1) per transport
    frame) instead of merging N dicts per access."""

    def __init__(self, router: "Router"):
        self._router = router

    def __contains__(self, device_id) -> bool:
        return device_id in self._router._where

    def __getitem__(self, device_id) -> DeviceStream:
        return self._router._replica(device_id).streams[device_id]

    def __iter__(self) -> Iterator[int]:
        return iter(self._router._where)

    def __len__(self) -> int:
        return len(self._router._where)


class Router:
    """N replicas (in-process and/or worker processes) + placement."""

    def __init__(
        self,
        replicas: Sequence[Any],
        *,
        placement: Union[str, PlacementPolicy] = "least-loaded",
        migrate_on_retire: bool = True,
    ):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        wrapped = [LocalReplica(r) if isinstance(r, ServerEngine) else r for r in replicas]
        k_maxes = {r.k_max for r in wrapped}
        max_lens = {r.max_len for r in wrapped}
        if len(k_maxes) > 1 or len(max_lens) > 1:
            raise ValueError(
                f"replicas must be homogeneous for migration: k_max {k_maxes}, "
                f"max_len {max_lens}"
            )
        self.replicas: List[Any] = wrapped
        self.placement = (
            placement if isinstance(placement, PlacementPolicy) else make_placement(placement)
        )
        self.migrate_on_retire = migrate_on_retire
        self.migrations = 0
        self.evictions = 0
        self.shed_streams = 0
        self.lost_devices: List[int] = []  # streams lost with evicted replicas
        self._where: Dict[int, int] = {}  # device_id -> replica index
        self._pool: Optional[ThreadPoolExecutor] = None  # remote step fan-out

    @classmethod
    def build(
        cls,
        model: Any,
        params: Any,
        *,
        replicas: int,
        n_slots: int,
        placement: Union[str, PlacementPolicy] = "least-loaded",
        migrate_on_retire: bool = True,
        **engine_kw,
    ) -> "Router":
        """N homogeneous in-process replicas of ``n_slots`` rows each. They
        share the target's parameter tensors (one object); each has its own
        pool. Remote fleets are assembled by ``System.build`` (spawn or
        dial, PlaceReplica, then ``Router``)."""
        if replicas < 1:
            raise ValueError(f"need at least 1 replica, got {replicas}")
        engines = [ServerEngine(model, params, n_slots=n_slots, **engine_kw)
                   for _ in range(replicas)]
        return cls(engines, placement=placement, migrate_on_retire=migrate_on_retire)

    # -- introspection -------------------------------------------------------

    @property
    def alive(self) -> List[Any]:
        return [r for r in self.replicas if not r.dead]

    @property
    def streams(self) -> Mapping:
        """Device -> stream across replicas (read-only, O(1) lookups)."""
        return _StreamView(self)

    @property
    def queue_depth(self) -> int:
        return sum(r.queue_depth for r in self.alive)

    def replica_of(self, device_id: int) -> int:
        return self._where[device_id]

    def loads(self) -> List[int]:
        """Active stream count per replica."""
        return [len(r.streams) for r in self.replicas]

    def _replica(self, device_id: int):
        return self.replicas[self._where[device_id]]

    # -- failures (the default FaultPolicy: evict only) ----------------------

    def _evict(self, idx: int) -> None:
        """Replica ``idx``'s worker is unreachable: mark it dead, record the
        streams that went down with it in ``lost_devices`` and keep serving
        on the survivors; with none left, raise."""
        replica = self.replicas[idx]
        if replica.dead:
            return
        replica.dead = True
        lost = [d for d, i in self._where.items() if i == idx]
        for d in lost:
            del self._where[d]
        self.evictions += 1
        log.warning("evicting replica %d (%s): streams down %s", idx, replica.flavor, lost)
        telemetry.count("router_evictions_total")
        replica.close()
        for d in lost:
            self._shed(d)
        if not self.alive:
            raise RuntimeError(
                f"all {len(self.replicas)} replicas evicted; cluster has no capacity")

    def _shed(self, dev: int) -> None:
        """Give up on one stream: record the loss."""
        self.lost_devices.append(dev)
        self.shed_streams += 1
        telemetry.count("router_shed_streams_total")

    def _guard(self, idx: int):
        """``with router._guard(idx):`` one replica RPC; a transport failure
        (a ConnectionError) evicts the replica and is raised again."""
        return _EvictOnGone(self, idx)

    # -- admission as placement ----------------------------------------------

    def admit(self, device_id: int, prompt, now: float = 0.0) -> Optional[DeviceStream]:
        """Place the stream on the replica the policy chooses; None when
        every live pool is full (the caller queues and retries on retire).
        A replica that dies before acking is evicted and the stream placed
        on a survivor: it was never placed anywhere."""
        if device_id in self._where:
            raise ValueError(f"device {device_id} already admitted")
        while True:
            idx = self.placement.choose(self, device_id)
            if idx is None:
                return None
            try:
                with telemetry.span("router_place_seconds"):
                    stream = self.replicas[idx].admit(device_id, prompt, now)
            except ConnectionError:
                self._evict(idx)
                continue
            if stream is None:  # the policy saw a free slot the replica lacks
                return None
            self._where[device_id] = idx
            log.info("placed device %d on replica %d (%s, %d free slot(s) left)",
                     device_id, idx, self.replicas[idx].flavor, self.replicas[idx].n_free)
            return stream

    def retire(self, device_id: int) -> DeviceStream:
        idx = self._where.pop(device_id)
        with self._guard(idx):
            stream = self.replicas[idx].retire(device_id)
        if self.migrate_on_retire:
            self._rebalance_into(idx)
        return stream

    def migrate(self, device_id: int, dst: int) -> None:
        """Move a quiescent stream to replica ``dst`` bit for bit: the row is
        copied exactly between same-flavour replicas with equal
        fingerprints, so the stream's future tokens are unchanged (only its
        batch-mates are). In-process replicas share the parameters by
        object; two workers rebuilt theirs from one spec seed."""
        src = self._where[device_id]
        if src == dst:
            return
        src_r, dst_r = self.replicas[src], self.replicas[dst]
        if dst_r.dead:
            raise MigrationError(f"replica {dst} was evicted; cannot migrate into it")
        if src_r.flavor != dst_r.flavor:
            raise MigrationError(
                f"cannot migrate device {device_id} from {src_r.flavor} replica {src} to "
                f"{dst_r.flavor} replica {dst}: parameters on the two sides have different "
                "provenance (in-process object vs worker spec-seed rebuild), so bit-identity "
                "across the move cannot be guaranteed"
            )
        if src_r.fingerprint != dst_r.fingerprint:
            raise MigrationError(
                f"replica fingerprints differ ({src_r.fingerprint} vs "
                f"{dst_r.fingerprint}); migration would change the stream's tokens"
            )
        with telemetry.span("router_migrate_seconds"):
            with self._guard(src):
                stream, row = src_r.export_stream(device_id)
            try:
                with self._guard(dst):
                    dst_r.import_stream(stream, row)
            except Exception:
                # roll back: a stream is never lost mid-migration
                src_r.import_stream(stream, row)
                raise
        self._where[device_id] = dst
        self.migrations += 1
        telemetry.count("router_migrations_total")
        log.info("migrated device %d: replica %d -> %d", device_id, src, dst)

    def _rebalance_into(self, dst: int) -> None:
        """After a retirement freed a slot on ``dst``: pull one quiescent
        same-flavour stream over from the most-loaded live replica when the
        imbalance is >= 2 (moving one stream then strictly improves it)."""
        dst_r = self.replicas[dst]
        if dst_r.dead or dst_r.n_free == 0:
            return
        loads = self.loads()
        candidates = [i for i, r in enumerate(self.replicas)
                      if i != dst and not r.dead and r.flavor == dst_r.flavor]
        if not candidates:
            return
        src = max(candidates, key=lambda i: (loads[i], -i))
        if loads[src] - loads[dst] < 2:
            return
        replica = self.replicas[src]
        movable = [d for d in replica.streams if not replica.has_inflight(d)]
        if movable:
            self.migrate(movable[0], dst)

    # -- request path (delegated via the placement map) ----------------------

    def submit(self, device_id: int, draft_tokens: np.ndarray, now: float,
               draft_q: Optional[np.ndarray] = None) -> None:
        idx = self._where[device_id]
        with self._guard(idx):
            self.replicas[idx].submit(device_id, np.asarray(draft_tokens), now, draft_q=draft_q)

    def cancel_request(self, device_id: int) -> bool:
        idx = self._where[device_id]
        with self._guard(idx):
            return self.replicas[idx].cancel_request(device_id)

    def force_extend(self, device_id: int, tokens: np.ndarray) -> int:
        idx = self._where[device_id]
        with self._guard(idx):
            return self.replicas[idx].force_extend(
                device_id, np.asarray(tokens, np.int32).reshape(-1))

    def has_inflight(self, device_id: int) -> bool:
        return device_id in self._where and self._replica(device_id).has_inflight(device_id)

    def next_event_hint(self, now: float) -> Optional[float]:
        hints = [h for r in self.alive if (h := r.next_event_hint(now)) is not None]
        return min(hints) if hints else None

    # -- the serving hot loop ------------------------------------------------

    def step(self, now: float) -> Optional[List[Verdict]]:
        """Step every live replica whose policy fires; one verdict list,
        merged in replica order. In-process replicas step back to back
        (they share this process and its card); remote replicas step
        concurrently on a thread pool, each RPC blocking only on its own
        worker. A replica that fails mid-step is evicted after every step
        has resolved, and the survivors' verdicts are still returned. Each
        verdict's queue-depth feedback stays replica-local: the congestion
        signal of the streams riding that replica."""
        remote_idx = [i for i, r in enumerate(self.replicas)
                      if not r.dead and r.flavor == "remote"]
        futures = {}
        results: Dict[int, Optional[List[Verdict]]] = {}
        failed: List[int] = []
        with telemetry.span("router_step_seconds"):
            if len(remote_idx) > 1:
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(max_workers=len(self.replicas),
                                                    thread_name_prefix="router-step")
                futures = {i: self._pool.submit(self.replicas[i].step, now) for i in remote_idx}
            for i, replica in enumerate(self.replicas):
                if replica.dead or i in futures:
                    continue
                try:
                    results[i] = replica.step(now)
                except ConnectionError:
                    failed.append(i)
            for i, fut in futures.items():
                try:
                    results[i] = fut.result()
                except ConnectionError:
                    failed.append(i)
            # evict only once every step has resolved: a channel is not
            # thread-safe, and eviction closes one
            for i in failed:
                self._evict(i)
        verdicts: List[Verdict] = []
        for i in sorted(results):
            verdicts.extend(results[i] or ())
        return verdicts or None

    def warmup(self) -> Dict[int, float]:
        """Warm one in-process replica (the kernels, their builds and the
        libraries' handles are the process's, shared by every local
        replica) and every remote one (each worker is a process of its
        own). Returns each bucket's longest warmup."""
        out: Dict[int, float] = {}
        warmed_local = False
        for r in self.alive:
            if r.flavor == "local":
                if warmed_local:
                    continue
                warmed_local = True
            for k, v in r.warmup().items():
                out[k] = max(out.get(k, 0.0), v)
        return out

    def drain(self) -> None:
        """Ask every live worker to exit (reaping spawned processes); local
        replicas do nothing. Safe to call twice."""
        for r in self.replicas:
            if not r.dead:
                r.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    # -- stats ---------------------------------------------------------------

    def stats(self, now: Optional[float] = None) -> EngineStats:
        return EngineStats.merge(self.replica_stats(now))

    def replica_stats(self, now: Optional[float] = None) -> List[EngineStats]:
        """Each live replica's record (a replica found dead here is evicted)."""
        out = []
        for i, r in enumerate(self.replicas):
            if r.dead:
                continue
            try:
                out.append(r.stats(now))
            except ConnectionError:
                self._evict(i)
        return out

    def telemetry_payload(self) -> dict:
        """Cluster-level telemetry record, the keys of
        ``ServerEngine.telemetry_payload`` plus each live replica's pool
        capacity (a worker's from the gauges of its last ReplicaStats
        payload), the workers' payloads and the evictions; empty while
        telemetry is off. ``flight`` stays empty until the flight recorder
        is ported (ROADMAP.md Queue A, faults)."""
        if not telemetry.enabled():
            return {}
        out = {"snapshot": telemetry.registry().snapshot(), "flight": []}
        pools, workers = {}, {}
        for i, r in enumerate(self.replicas):
            if r.dead:
                continue
            if r.flavor == "local":
                pools[str(i)] = {
                    "kv_dtype": r.engine.kv_dtype,
                    "kv_pool_bytes": r.engine.pool.pool_bytes(),
                    "bytes_per_slot": r.engine.pool.bytes_per_slot(),
                }
                continue
            if r.last_telemetry:
                workers[str(i)] = r.last_telemetry
            gauges = ((r.last_telemetry or {}).get("snapshot") or {}).get("gauges", {})
            if "engine_kv_pool_bytes" in gauges:
                pools[str(i)] = {
                    "kv_dtype": getattr(r.spec, "kv_dtype", "bf16"),
                    "kv_pool_bytes": int(gauges["engine_kv_pool_bytes"]),
                    "bytes_per_slot": int(gauges.get("engine_bytes_per_slot", 0)),
                }
        if pools:
            out["pools"] = pools
        if workers:
            out["workers"] = workers
        if self.evictions:
            out["supervision"] = {"evictions": self.evictions, "shed_streams": self.shed_streams,
                                  "lost_devices": list(self.lost_devices)}
        return out


class _EvictOnGone:
    """``with router._guard(idx):`` evict replica ``idx`` when the body dies
    of a transport failure (ReplicaGone is a ConnectionError), then raise
    it again so the caller sees the loss."""

    def __init__(self, router: Router, idx: int):
        self.router = router
        self.idx = idx

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and issubclass(exc_type, ConnectionError):
            self.router._evict(self.idx)
        return False
