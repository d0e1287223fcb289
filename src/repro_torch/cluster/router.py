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

**Supervision** follows a :class:`~repro_torch.api.spec.FaultPolicy`
(the default: evict only; a dead replica is marked dead, its streams go to
``lost_devices``, the survivors keep serving, and with no replica left the
router raises). With ``respawn`` on, an evicted replica is revived in
place (respawn the worker, or redial a dial-only address, place its spec
again, warm it up) under a capped, seeded-jitter
:class:`~repro_torch.cluster.faults.Backoff` and a ``max_respawns``
budget; dead replicas are also redialed from the step loop, and an
all-dead fleet keeps trying until ``all_dead_deadline_s``. With
``recover_streams`` on, the streams that went down with a replica are
admitted again to a live (or revived) replica by DEVICE REPLAY: the router
shadows each stream's prompt, committed tokens and last unanswered submit,
so recovery is an admit, ``force_extend`` of the committed history in runs
of at most k_max+1, and the submit again; a greedy stream goes on with the
fault-free tokens. Only streams beyond the live capacity are shed into
``lost_devices``. ``heartbeat_interval_s`` > 0 starts a background Ping
monitor that marks a silent worker ``suspect`` within seconds instead of
the control RPC's timeout. Each replica has a flight ring of its last
rounds, fed from the verdicts the router merges, dumped at its eviction.
"""

from __future__ import annotations

import logging
import threading
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from repro_torch import telemetry
from repro_torch.cluster.faults import Backoff
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
        self.suspect = False
        self._killed = False  # chaos: delegated calls fail as a dead worker's do

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

    def chaos_kill(self) -> None:
        """Fault injection: every delegated call now raises ConnectionError,
        which is what a crashed worker looks like to the Router, so the
        in-process path runs the same evict and recover code."""
        self._killed = True

    def can_revive(self) -> bool:
        return self._killed  # only a chaos-killed local replica comes back

    def revive(self) -> None:
        """Undo a chaos kill. The engine was never broken, so reviving
        clears the flag and retires the dead incarnation's streams (a
        respawned worker starts with an empty pool too)."""
        self._killed = False
        for dev in list(self.engine.streams):
            self.engine.cancel_request(dev)
            self.engine.retire(dev)
        self.dead = False
        self.suspect = False

    def drain(self) -> None:  # lifecycle parity with RemoteReplica
        pass

    def close(self) -> None:
        pass

    def __getattr__(self, name: str):
        if self.__dict__.get("_killed"):
            raise ConnectionError(f"local replica is chaos-killed ({name!r})")
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
        faults: Optional[Any] = None,
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
        if faults is None:
            from repro_torch.api.spec import FaultPolicy  # api sits above cluster

            faults = FaultPolicy()
        self.replicas: List[Any] = wrapped
        self.placement = (
            placement if isinstance(placement, PlacementPolicy) else make_placement(placement)
        )
        self.migrate_on_retire = migrate_on_retire
        self.faults = faults
        self.chaos: Optional[Any] = None  # a ChaosInjector, attached by System or a test
        self.migrations = 0
        self.evictions = 0
        self.respawns = 0
        self.recovered_streams = 0
        self.shed_streams = 0
        self.steps_taken = 0  # the cluster's step counter (the chaos schedule's clock)
        self.lost_devices: List[int] = []  # streams shed with evicted replicas
        self._where: Dict[int, int] = {}  # device_id -> replica index
        self._pool: Optional[ThreadPoolExecutor] = None  # remote step fan-out
        # one flight ring per replica, fed from the verdicts the router
        # merges, so a post-mortem survives a worker that died without
        # answering another RPC
        self.flight: Dict[int, telemetry.FlightRecorder] = {
            i: telemetry.FlightRecorder() for i in range(len(wrapped))}
        self.flight_dumps: Dict[int, List[dict]] = {}  # idx -> its ring at eviction
        self._round_seq: Dict[int, int] = {}  # device_id -> round seq
        self._last_k: Dict[int, int] = {}  # device_id -> last submitted length
        # device-replay shadows: what rebuilds a stream on another replica
        # after its worker dies (the prompt, the committed history, and the
        # round in flight, if any)
        self._prompts: Dict[int, np.ndarray] = {}
        self._admit_now: Dict[int, float] = {}
        self._committed: Dict[int, List[int]] = {}
        self._last_submit: Dict[int, Tuple] = {}  # dev -> (tokens, now, draft_q)
        # respawn bookkeeping
        self._backoff: Dict[int, Backoff] = {}
        self._respawn_count: Dict[int, int] = {}
        self._redial_at: Dict[int, float] = {}
        self._hb: Optional[_HeartbeatMonitor] = None

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
        faults: Optional[Any] = None,
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
        return cls(engines, placement=placement, migrate_on_retire=migrate_on_retire,
                   faults=faults)

    # -- introspection -------------------------------------------------------

    @property
    def alive(self) -> List[Any]:
        return [r for r in self.replicas if not r.dead]

    @property
    def k_max(self) -> int:
        return self.replicas[0].k_max

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
        """Active stream count per replica (0 for a chaos-killed local one)."""
        out = []
        for r in self.replicas:
            try:
                out.append(len(r.streams))
            except ConnectionError:
                out.append(0)
        return out

    def _replica(self, device_id: int):
        return self.replicas[self._where[device_id]]

    # -- supervision ---------------------------------------------------------

    def _evict(self, idx: int) -> None:
        """Replica ``idx``'s worker is unreachable: mark it dead, collect the
        streams that went down with it and keep serving on the survivors.
        Under the default FaultPolicy that is all (a one-shot RPC retry
        happens below this layer, behind the worker's replay cache); with
        ``respawn`` or ``recover_streams`` on, the replica is revived in
        place and its streams re-placed by device replay, and only what
        exceeds the live capacity is shed."""
        replica = self.replicas[idx]
        if replica.dead:
            return
        replica.dead = True
        lost = [d for d, i in self._where.items() if i == idx]
        for d in lost:
            del self._where[d]
        self.evictions += 1
        # the worker may be gone without a word: the router's own ring holds
        # the replica's last rounds
        dump = self.flight[idx].dump()
        self.flight_dumps[idx] = dump
        log.warning("evicting replica %d (%s): streams down %s; flight recorder holds %d "
                    "round(s)", idx, replica.flavor, lost, len(dump))
        for row in dump[-8:]:
            log.warning("  flight[replica %d]: %s", idx, row)
        telemetry.count("router_evictions_total")
        replica.close()
        if self.faults.respawn or self.faults.recover_streams:
            recovered = self._recover(idx, lost)
            lost = [d for d in lost if d not in recovered]
        for d in lost:
            self._shed(d)
        if not self.alive:
            raise RuntimeError(
                f"all {len(self.replicas)} replicas evicted; cluster has no capacity")

    def _drop_shadows(self, dev: int) -> None:
        for shadow in (self._prompts, self._admit_now, self._committed,
                       self._last_submit, self._round_seq, self._last_k):
            shadow.pop(dev, None)

    def _shed(self, dev: int) -> None:
        """Give up on one stream: record the loss and drop its shadows."""
        self.lost_devices.append(dev)
        self.shed_streams += 1
        self._drop_shadows(dev)
        telemetry.count("router_shed_streams_total")

    # -- recovery: respawn and device replay -----------------------------------

    def _recover(self, idx: int, lost: List[int]) -> Set[int]:
        """After an eviction: revive the dead replica (if the policy says
        so), then re-place each lost stream by device replay. Returns the
        devices that made it back."""
        p = self.faults
        if p.respawn:
            self._try_revive(idx)
        if not self.alive:
            if not p.respawn:
                return set()
            self._revive_until_deadline()  # raises when the fleet is gone
        if not p.recover_streams or not lost:
            return set()
        recovered: Set[int] = set()
        with telemetry.span("router_recovery_seconds"):
            for dev in lost:
                if self._readmit(dev):
                    recovered.add(dev)
                    self.recovered_streams += 1
                    telemetry.count("router_recovered_streams_total")
                else:
                    log.warning("device %d could not be re-placed; shedding", dev)
        log.info("recovered %d/%d stream(s) after evicting replica %d",
                 len(recovered), len(lost), idx)
        return recovered

    def _readmit(self, dev: int) -> bool:
        """Re-place one orphaned stream by DEVICE REPLAY: admit the original
        prompt, ``force_extend`` the committed history in runs of at most
        k_max+1 (the engine's fallback-run ceiling), then submit the round
        that was in flight again. The rebuilt state is the fault-free
        stream's, so a greedy stream goes on with the same tokens."""
        prompt = self._prompts.get(dev)
        if prompt is None:
            return False
        committed = list(self._committed.get(dev, ()))
        if self.admit(dev, prompt, self._admit_now.get(dev, 0.0)) is None:
            return False  # every live pool is full: shed
        run = self.k_max + 1
        try:
            idx = self._where[dev]
            for i in range(0, len(committed), run):
                with self._guard(idx):
                    self.replicas[idx].force_extend(dev, np.asarray(committed[i:i + run],
                                                                    np.int32))
            pending = self._last_submit.get(dev)
            if pending is not None:
                tokens, t_sub, draft_q = pending
                with self._guard(idx):
                    self.replicas[idx].submit(dev, tokens, t_sub, draft_q=draft_q)
        except ConnectionError:
            # the new home died mid-replay; its eviction recovered in turn,
            # so the stream is either re-placed in full or lost
            return dev in self._where
        return True

    def _try_revive(self, idx: int, *, wait: bool = True) -> bool:
        """One supervised revive: a seeded-jitter backoff (skipped on the
        periodic redial, which ``redial_interval_s`` paces), the
        ``max_respawns`` budget, and the replica's own ``revive()`` (respawn
        or redial, place again, warm up)."""
        replica = self.replicas[idx]
        if not replica.dead:
            return True
        if not replica.can_revive():
            return False
        p = self.faults
        n = self._respawn_count.get(idx, 0)
        if n >= p.max_respawns:
            return False
        bo = self._backoff.get(idx)
        if bo is None:
            bo = self._backoff[idx] = Backoff(p.backoff_base_s, p.backoff_max_s,
                                              p.backoff_jitter, seed=idx)
        if wait:
            time.sleep(bo.attempt())
        self._respawn_count[idx] = n + 1
        try:
            with telemetry.span("router_respawn_seconds"):
                replica.revive()
        except Exception as e:  # a failed attempt counts against the budget
            log.warning("revive of replica %d failed (attempt %d/%d): %s",
                        idx, n + 1, p.max_respawns, e)
            return False
        bo.reset()
        self.respawns += 1
        telemetry.count("router_respawns_total")
        log.info("replica %d revived (respawn %d/%d)", idx, n + 1, p.max_respawns)
        return True

    def _revivable(self, i: int) -> bool:
        r = self.replicas[i]
        return (r.dead and r.can_revive()
                and self._respawn_count.get(i, 0) < self.faults.max_respawns)

    def _revive_until_deadline(self) -> None:
        """Every replica is dead but respawn is on: keep trying to bring one
        back until ``all_dead_deadline_s`` runs out, then raise."""
        p = self.faults
        deadline = time.monotonic() + p.all_dead_deadline_s
        while time.monotonic() < deadline:
            eligible = [i for i in range(len(self.replicas)) if self._revivable(i)]
            if not eligible:
                break
            if any(self._try_revive(i) for i in eligible):
                return
        raise RuntimeError(
            f"all {len(self.replicas)} replicas evicted and none revived within "
            f"{p.all_dead_deadline_s:.1f}s; cluster has no capacity")

    def _maybe_redial(self) -> None:
        """The step loop's supervision tick: now and then retry the dead
        replicas that can come back (a dial-only peer whose partition may
        have healed, a spawned worker under its respawn budget)."""
        if not self.faults.respawn:
            return
        t = time.monotonic()
        for i in range(len(self.replicas)):
            if not self._revivable(i) or t < self._redial_at.get(i, 0.0):
                continue
            self._redial_at[i] = t + self.faults.redial_interval_s
            self._try_revive(i, wait=False)

    def _check_suspects(self) -> None:
        """Evict the replicas the heartbeat monitor marked suspect (they
        stopped answering Pings); eviction runs the recovery path."""
        for i, r in enumerate(self.replicas):
            if not r.dead and r.suspect:
                log.warning("replica %d failed heartbeat; evicting", i)
                self._evict(i)

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
            self._prompts[device_id] = np.asarray(prompt, np.int32).reshape(-1)
            self._admit_now[device_id] = now
            self._committed.setdefault(device_id, [])
            log.info("placed device %d on replica %d (%s, %d free slot(s) left)",
                     device_id, idx, self.replicas[idx].flavor, self.replicas[idx].n_free)
            return stream

    def retire(self, device_id: int) -> DeviceStream:
        idx = self._where.pop(device_id)
        self._drop_shadows(device_id)
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
        tokens = np.asarray(draft_tokens)
        self._last_k[device_id] = int(tokens.shape[0])
        self._last_submit[device_id] = (tokens, now, draft_q)
        idx = self._where[device_id]
        try:
            self.replicas[idx].submit(device_id, tokens, now, draft_q=draft_q)
        except ConnectionError:
            self._evict(idx)
            if device_id not in self._where:
                raise  # the stream was shed with the replica
            # recovery re-placed the stream and submitted this round again
            # (it was in _last_submit already): the caller's submit stands

    def cancel_request(self, device_id: int) -> bool:
        idx = self._where[device_id]
        try:
            ok = self.replicas[idx].cancel_request(device_id)
        except ConnectionError:
            self._evict(idx)
            if device_id not in self._where:
                raise
            # recovered elsewhere with its round submitted again: cancel that
            with self._guard(self._where[device_id]):
                ok = self.replicas[self._where[device_id]].cancel_request(device_id)
        if ok:
            self._last_submit.pop(device_id, None)
        return ok

    def force_extend(self, device_id: int, tokens: np.ndarray) -> int:
        toks = np.asarray(tokens, np.int32).reshape(-1)
        idx = self._where[device_id]
        try:
            prev = self.replicas[idx].force_extend(device_id, toks)
        except ConnectionError:
            self._evict(idx)
            if device_id not in self._where:
                raise
            # recovered: the committed shadow does not hold these tokens yet,
            # so the replay stopped short of them; apply them on the new home
            with self._guard(self._where[device_id]):
                prev = self.replicas[self._where[device_id]].force_extend(device_id, toks)
        self._committed.setdefault(device_id, []).extend(int(t) for t in toks)
        return prev

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
        signal of the streams riding that replica.

        This is also the supervision tick: the chaos schedule fires on the
        step counter, suspect (heartbeat-silent) replicas are evicted, and
        dead replicas get their periodic redial."""
        self.steps_taken += 1
        if self.chaos is not None:
            self.chaos.on_step(self.steps_taken)
        if self._hb is None and self.faults.heartbeat_interval_s > 0:
            self._hb = _HeartbeatMonitor(self, self.faults)
            self._hb.start()
        self._check_suspects()
        self._maybe_redial()
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
            # evict only once every step has resolved: recovery may admit
            # streams to the survivors, whose channels must be idle first
            # (a channel is not thread-safe)
            for i in failed:
                self._evict(i)
        verdicts: List[Verdict] = []
        for i in sorted(results):
            out = results[i] or ()
            ring = self.flight[i]
            for v in out:
                # the ring records every round, telemetry on or off, so an
                # eviction always has its post-mortem (a deque append each)
                seq = self._round_seq.get(v.device_id, 0)
                self._round_seq[v.device_id] = seq + 1
                ring.record(telemetry.TraceEvent(
                    device_id=v.device_id, round=seq, t=now,
                    k=self._last_k.get(v.device_id, 0), n_accepted=v.n_accepted,
                    n_commit=len(v.tokens), queue_s=v.queue_s, verify_s=v.verify_s,
                    replica=i))
                # device-replay shadow: the verdict's tokens are committed
                # history now, and its round is no longer in flight
                self._committed.setdefault(v.device_id, []).extend(int(t) for t in v.tokens)
                self._last_submit.pop(v.device_id, None)
            verdicts.extend(out)
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
        """Stop the heartbeat and ask every live worker to exit (reaping
        spawned processes); local replicas do nothing. Safe to call twice."""
        if self._hb is not None:
            self._hb.stop()
            self._hb.join(timeout=10.0)
            self._hb = None
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
        ``ServerEngine.telemetry_payload`` (``flight``: every replica's ring,
        each event tagged with its replica, in time order) plus each live
        replica's pool capacity (a worker's from the gauges of its last
        ReplicaStats payload), the workers' payloads, the rings dumped at
        evictions (``evicted``) and the supervision counters; empty while
        telemetry is off."""
        if not telemetry.enabled():
            return {}
        flight = [ev.to_json() for ring in self.flight.values() for ev in ring.events()]
        flight.sort(key=lambda e: e["t"])
        out = {"snapshot": telemetry.registry().snapshot(), "flight": flight}
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
        if self.flight_dumps:
            out["evicted"] = {str(i): d for i, d in self.flight_dumps.items()}
        if self.evictions or self.respawns or self.shed_streams:
            out["supervision"] = {
                "evictions": self.evictions, "respawns": self.respawns,
                "recovered_streams": self.recovered_streams,
                "shed_streams": self.shed_streams, "lost_devices": list(self.lost_devices),
            }
        return out


class _HeartbeatMonitor(threading.Thread):
    """Background Ping loop over every remote replica's own heartbeat
    channel: ``heartbeat_misses`` Pings in a row unanswered mark the replica
    ``suspect``, and the Router evicts suspects at the top of its next step,
    so a partitioned or stopped worker is found in seconds, not after the
    control RPC's timeout. A worker answers a Ping after the request it is
    handling, so the timeout must sit above its longest RPC. Replicas
    without ``ping`` (in-process ones) are skipped."""

    def __init__(self, router: Router, policy: Any):
        super().__init__(daemon=True, name="router-heartbeat")
        self.router = router
        self.policy = policy
        self.misses: Dict[int, int] = {}
        self._stopped = threading.Event()

    def stop(self) -> None:
        self._stopped.set()

    def run(self) -> None:
        while not self._stopped.wait(self.policy.heartbeat_interval_s):
            self.sweep()

    def sweep(self) -> None:
        """One pass over the fleet (apart from run(), for tests)."""
        for i, r in enumerate(self.router.replicas):
            ping = getattr(r, "ping", None)
            if r.dead or r.suspect or ping is None:
                continue
            if ping(timeout=self.policy.heartbeat_timeout_s):
                self.misses[i] = 0
                continue
            self.misses[i] = self.misses.get(i, 0) + 1
            telemetry.count("router_heartbeat_misses_total")
            if self.misses[i] >= self.policy.heartbeat_misses:
                log.warning("replica %d missed %d heartbeat(s) in a row; marking suspect",
                            i, self.misses[i])
                r.suspect = True
                self.misses[i] = 0


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
