"""ServeSpec: one declarative, serializable config for every SLED backend.

The port's own copy of ``repro.api.spec``: the same fields, validation and
JSON form, so a spec file serves both packages. The port's ``System``
builds every backend, with in-process or remote replicas, and serves fault
schedules (``faults``) and fault policies (``cluster.faults``).

The repo grew four ways to run the same system — the lock-step reference
loop, the in-process ServerEngine, the asyncio transport runtime, and the
replica-sharded cluster router — and every driver used to re-wire models,
pools, planners, and links by hand.  A :class:`ServeSpec` is the single
source of truth instead: a validated tree of frozen dataclasses that names
the model pair, the execution backend, and every serving knob, and that
round-trips through JSON (``to_json`` / ``from_json``) so a *run
configuration is an artifact* — sweepable, diffable, committable, and (the
ROADMAP's cross-process follow-on) shippable to another host as a placement
RPC.

``System.build(spec)`` (api/system.py) turns a spec into a running backend.
Validation happens at construction: invalid combinations (replicas on the
reference loop, adaptive spec-length control without the v2 feedback codec,
unknown policies) fail here with a message, not deep inside a driver.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union

BACKENDS = ("reference", "engine", "transport", "cluster")
LINKS = ("loopback", "sim")
KCTLS = ("fixed", "adaptive")
CCTLS = ("fixed", "adaptive")
POLICIES = ("continuous", "deadline", "static")
PLACEMENTS = ("least-loaded", "affinity", "round-robin", "class-affinity")
QMODES = ("none", "f32", "f16", "int8")
QUANT_BITS = (4, 8, 16)
# server-pool KV storage dtype: "int8" stores pool rows quantized with
# per-(slot, layer, head) dequant scales (core/engine.py KV_DTYPES)
KV_DTYPES = ("bf16", "int8")
# v1: no Verdict feedback fields; v2: feedback wire; v3: + the
# Router<->worker control plane (PlaceReplica / driver RPCs / Drain);
# v4: + per-RPC sequence ids (replay-safe retries) and Ping/Pong heartbeat
CODEC_VERSIONS = (1, 2, 3, 4)
FLAVORS = ("inproc", "remote")
FAULT_KINDS = ("kill", "hang", "drop", "delay", "flap")


class SpecError(ValueError):
    """A ServeSpec names an invalid value or an invalid combination."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The draft/target model pair (reduced configs, deterministic init).

    ``seed`` keys the target's init params; the draft uses ``seed + 1`` —
    one integer pins the whole weight state, which is what makes a spec a
    reproducible artifact.  ``draft_noise`` Gaussian-perturbs the draft
    (random-init reduced pairs otherwise agree greedily, so acceptance is a
    trivial 1.0); ``bits`` < 16 serves a weight-only-quantized target.
    """

    arch: str = "qwen2-1.5b"
    draft_arch: str = "qwen2-1.5b"
    vocab_size: int = 256
    target_layers: Optional[int] = None  # None: the reduced config's own depth
    draft_layers: Optional[int] = 1
    bits: int = 16
    draft_noise: float = 0.0
    seed: int = 0

    def validate(self) -> None:
        _check(bool(self.arch), "model.arch must name a config")
        _check(bool(self.draft_arch), "model.draft_arch must name a config")
        _check(self.vocab_size >= 8, f"model.vocab_size {self.vocab_size} too small")
        _check(self.bits in QUANT_BITS, f"model.bits {self.bits} not in {QUANT_BITS}")
        _check(self.draft_noise >= 0.0, "model.draft_noise must be >= 0")
        for name in ("target_layers", "draft_layers"):
            v = getattr(self, name)
            _check(v is None or v >= 1, f"model.{name} must be None or >= 1")


@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """Wire-runtime knobs (``backend="transport"`` only).

    ``codec_version`` declares the frame protocol the deployment speaks;
    v1 Verdicts carried no accept_rate/queue_depth feedback, so adaptive
    spec-length control is rejected on a v1 codec at validation time.
    """

    link: str = "loopback"  # loopback | sim
    net: str = "wlan"  # NetProfile name for link="sim"
    qmode: str = "none"
    pipeline: bool = True  # draft ahead while a round is in flight
    verify_timeout: float = 30.0  # device-side round timeout (s)
    stagger_s: float = 0.0  # client i joins i * stagger_s seconds in
    draft_rate: Optional[float] = None  # emulated device tokens/s (None: unthrottled)
    codec_version: int = 4

    def validate(self) -> None:
        _check(self.link in LINKS, f"transport.link {self.link!r} not in {LINKS}")
        _check(self.qmode in QMODES, f"transport.qmode {self.qmode!r} not in {QMODES}")
        _check(
            self.codec_version in CODEC_VERSIONS,
            f"transport.codec_version {self.codec_version} not in {CODEC_VERSIONS}",
        )
        _check(self.verify_timeout > 0, "transport.verify_timeout must be > 0")
        _check(self.stagger_s >= 0, "transport.stagger_s must be >= 0")
        _check(
            self.draft_rate is None or self.draft_rate > 0,
            "transport.draft_rate must be None or > 0",
        )
        # net is validated for every link (serving resolves the profile even
        # on loopback): a typo'd spec must fail here, not deep in a driver
        from repro_torch.serving.devices import NETS  # lazy: keep spec import light

        _check(self.net in NETS, f"transport.net {self.net!r} not in {sorted(NETS)}")


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One replica's placement: where it runs and how it is reached.

    ``flavor="inproc"`` constructs a ServerEngine in the driving process
    (the pre-PR-6 behaviour).  ``flavor="remote"`` places the replica in a
    ``repro worker`` process: with an ``address`` the System DIALS a worker
    you already started (``repro worker --listen ADDR``); with no address
    it SPAWNS one on a private unix socket and reaps it on close.
    ``slots`` overrides the pool rows for this replica alone (0 = the
    spec-level ``slots_per_replica`` split).
    """

    flavor: str = "inproc"
    address: str = ""  # remote only: tcp:HOST:PORT or uds:/path.sock
    slots: int = 0  # per-replica pool-row override; 0 = spec-level split

    def validate(self) -> None:
        _check(self.flavor in FLAVORS, f"replica.flavor {self.flavor!r} not in {FLAVORS}")
        _check(self.slots >= 0, "replica.slots must be >= 0 (0 = spec split)")
        if self.flavor == "inproc":
            _check(
                not self.address,
                f"replica.address {self.address!r} is meaningless for an inproc "
                f"replica (set flavor='remote' to dial a worker)",
            )
        elif self.address:
            from repro_torch.transport.links import parse_addr  # lazy: keep spec light

            try:
                parse_addr(self.address)
            except ValueError as e:
                raise SpecError(f"replica.address invalid: {e}") from e


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Fault-tolerance knobs for the replica Router (``cluster.faults``).

    Everything defaults to today's fail-fast behaviour: a dead replica is
    evicted, its streams are reported in ``lost_devices``, and an all-dead
    cluster raises.  Flip ``respawn`` / ``recover_streams`` to get
    supervised worker restarts and device-replay stream recovery instead.

    ``heartbeat_interval_s > 0`` starts a background monitor that Pings
    each remote replica over its own control connection (codec v4); a peer
    that misses ``heartbeat_misses`` consecutive pings within
    ``heartbeat_timeout_s`` each is marked suspect and evicted at the next
    router step — seconds, not the 120 s RPC timeout.
    """

    respawn: bool = False  # restart spawned workers / redial dialed ones
    recover_streams: bool = False  # re-admit lost streams by device replay
    max_respawns: int = 3  # per replica, across its lifetime
    backoff_base_s: float = 0.2  # first respawn delay
    backoff_max_s: float = 5.0  # exponential backoff cap
    backoff_jitter: float = 0.1  # +- fraction of the delay, seeded
    redial_interval_s: float = 1.0  # dead dial-only replicas: retry cadence
    all_dead_deadline_s: float = 30.0  # all-dead: keep respawning this long
    heartbeat_interval_s: float = 0.0  # 0 = heartbeat monitor off
    heartbeat_timeout_s: float = 2.0  # per-ping reply deadline
    heartbeat_misses: int = 3  # consecutive misses before suspect
    rpc_timeout_s: float = 0.0  # control-plane RPC timeout; 0 = codec default
    retry_rpcs: bool = True  # one-shot idempotent retry over reconnect (v4)

    def validate(self) -> None:
        _check(self.max_respawns >= 0, "faults.max_respawns must be >= 0")
        _check(self.backoff_base_s > 0, "faults.backoff_base_s must be > 0")
        _check(
            self.backoff_max_s >= self.backoff_base_s,
            "faults.backoff_max_s must be >= backoff_base_s",
        )
        _check(
            0.0 <= self.backoff_jitter < 1.0,
            "faults.backoff_jitter must be in [0, 1)",
        )
        _check(self.redial_interval_s > 0, "faults.redial_interval_s must be > 0")
        _check(self.all_dead_deadline_s >= 0, "faults.all_dead_deadline_s must be >= 0")
        _check(self.heartbeat_interval_s >= 0, "faults.heartbeat_interval_s must be >= 0")
        _check(self.heartbeat_timeout_s > 0, "faults.heartbeat_timeout_s must be > 0")
        _check(self.heartbeat_misses >= 1, "faults.heartbeat_misses must be >= 1")
        _check(self.rpc_timeout_s >= 0, "faults.rpc_timeout_s must be >= 0 (0 = default)")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Replica fleet shape (``backend="cluster"`` or ``"transport"``).

    ``replicas`` is either the legacy bare int — shorthand for N identical
    in-process replicas — or a per-replica list of :class:`ReplicaSpec`
    objects (JSON: a list of objects).  Migration table::

        before (shorthand)   after (per-replica)                     meaning
        ------------------   -------------------------------------   -------
        "replicas": 2        "replicas": [{}, {}]                    2 inproc
        "replicas": 2        "replicas": [{"flavor": "inproc"},      same,
                                          {"flavor": "inproc"}]      explicit
        (not expressible)    "replicas": [{"flavor": "remote"},      spawn 2
                                          {"flavor": "remote"}]      workers
        (not expressible)    "replicas": [{"flavor": "remote",       dial 2
                               "address": "tcp:host-a:7001"},        running
                              {"flavor": "remote",                   workers
                               "address": "tcp:host-b:7001"}]

    The int shorthand stays first-class: it validates, round-trips, and
    expands to N inproc ReplicaSpecs via :attr:`replica_specs`.
    """

    replicas: Union[int, Tuple[ReplicaSpec, ...]] = 1
    placement: str = "least-loaded"
    migrate_on_retire: bool = True
    faults: FaultPolicy = dataclasses.field(default_factory=FaultPolicy)

    def __post_init__(self) -> None:
        # normalize list/tuple forms (JSON gives a list of dicts) into a
        # tuple of ReplicaSpec so the frozen dataclass stays hashable
        reps = self.replicas
        if isinstance(reps, (list, tuple)):
            object.__setattr__(
                self, "replicas", tuple(_replica_from(r) for r in reps)
            )
        if isinstance(self.faults, dict):
            object.__setattr__(
                self, "faults", _sub_from_dict(FaultPolicy, "cluster.faults", self.faults)
            )

    @property
    def n_replicas(self) -> int:
        return self.replicas if isinstance(self.replicas, int) else len(self.replicas)

    @property
    def replica_specs(self) -> Tuple[ReplicaSpec, ...]:
        """Per-replica form; the int shorthand expands to N inproc specs."""
        if isinstance(self.replicas, int):
            return tuple(ReplicaSpec() for _ in range(self.replicas))
        return self.replicas

    @property
    def has_remote(self) -> bool:
        return any(r.flavor == "remote" for r in self.replica_specs)

    def validate(self) -> None:
        if isinstance(self.replicas, int):
            _check(
                self.replicas >= 1, f"cluster.replicas must be >= 1, got {self.replicas}"
            )
        else:
            _check(
                len(self.replicas) >= 1,
                "cluster.replicas list must name at least one replica",
            )
            for r in self.replicas:
                r.validate()
        _check(
            self.placement in PLACEMENTS,
            f"cluster.placement {self.placement!r} not in {PLACEMENTS}",
        )
        self.faults.validate()


def _replica_from(r) -> ReplicaSpec:
    if isinstance(r, ReplicaSpec):
        return r
    if not isinstance(r, dict):
        raise SpecError(
            f"cluster.replicas entries must be objects, got {type(r).__name__}"
        )
    known = {f.name for f in dataclasses.fields(ReplicaSpec)}
    unknown = sorted(set(r) - known)
    if unknown:
        raise SpecError(f"unknown replica keys {unknown}")
    try:
        return ReplicaSpec(**r)
    except SpecError:
        raise
    except (TypeError, ValueError) as e:
        raise SpecError(f"bad replica value: {e}") from e


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: *what* happens to *which* replica at which
    router step.  ``round`` counts Router.step() calls (the cluster's
    logical clock), so a schedule is deterministic across runs.

      kill    SIGKILL a spawned worker / sever a dialed control channel
      hang    SIGSTOP a spawned worker (heartbeat detects; no clean close)
      drop    fail the next ``count`` control RPCs with a connection error
      delay   stall the next ``count`` control RPCs by ``delay_s`` each
      flap    sever the control link once, then heal (retryable blip)
    """

    kind: str = "kill"
    replica: int = 0
    round: int = 1
    count: int = 1  # drop/delay: how many RPCs are affected
    delay_s: float = 0.0  # delay: per-RPC stall seconds

    def validate(self) -> None:
        _check(self.kind in FAULT_KINDS, f"fault.kind {self.kind!r} not in {FAULT_KINDS}")
        _check(self.replica >= 0, "fault.replica must be >= 0")
        _check(self.round >= 0, "fault.round must be >= 0")
        _check(self.count >= 1, "fault.count must be >= 1")
        _check(self.delay_s >= 0, "fault.delay_s must be >= 0")
        if self.kind == "delay":
            _check(self.delay_s > 0, "fault kind 'delay' needs delay_s > 0")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A deterministic chaos schedule (``ServeSpec.faults``).

    ``seed`` keys every random choice the harness makes (backoff jitter,
    injector tie-breaks), so a chaos run is exactly reproducible: same
    spec, same kills, same recovery, same tokens.
    """

    seed: int = 0
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self) -> None:
        evs = self.events
        if isinstance(evs, (list, tuple)):
            object.__setattr__(self, "events", tuple(_fault_event_from(e) for e in evs))

    def validate(self) -> None:
        for e in self.events:
            e.validate()

    @property
    def active(self) -> bool:
        return bool(self.events)


def _fault_event_from(e) -> FaultEvent:
    if isinstance(e, FaultEvent):
        return e
    if not isinstance(e, dict):
        raise SpecError(f"faults.events entries must be objects, got {type(e).__name__}")
    return _sub_from_dict(FaultEvent, "faults.events", e)


@dataclasses.dataclass(frozen=True)
class SchedulerSpec:
    """BatchPlanner policy + pool sizing for the engine-backed backends."""

    policy: str = "continuous"
    max_wait: float = 0.05
    slots: int = 0  # pool rows PER REPLICA; 0 = ceil(devices / replicas)
    straggler_timeout: float = 30.0
    stagger_ticks: int = 3  # in-process driver: device i joins i*stagger ticks in

    def validate(self) -> None:
        _check(self.policy in POLICIES, f"scheduler.policy {self.policy!r} not in {POLICIES}")
        _check(self.max_wait >= 0, "scheduler.max_wait must be >= 0")
        _check(self.slots >= 0, "scheduler.slots must be >= 0 (0 = auto)")
        _check(self.straggler_timeout > 0, "scheduler.straggler_timeout must be > 0")
        _check(self.stagger_ticks >= 0, "scheduler.stagger_ticks must be >= 0")


@dataclasses.dataclass(frozen=True)
class DeviceClassSpec:
    """One homogeneous slice of a heterogeneous edge fleet.

    A class names a *hardware profile* (``serving/devices.DEVICES`` — Jetson
    Orin Nano, RPi 4B/5), how many devices of that class join the fleet, and
    the per-class serving configuration the paper's ConfigSpec-style tuner
    selects: draft model family + weight precision (keying the profile's
    measured tokens/s table), speculation length ``k``, drafting confidence
    ``c_th``, and the network profile the class reaches the server over.

    Sentinel defaults inherit the spec-level value, so a class only states
    what differs: ``k=0`` -> ``ServeSpec.k_max``, ``c_th=-1`` ->
    ``ServeSpec.c_th``, ``net=""`` -> ``transport.net``, ``draft_layers=0``
    -> ``model.draft_layers``, ``draft_noise=-1`` -> ``model.draft_noise``.
    ``draft_layers``/``draft_noise`` emulate the class's draft *model* in
    reduced-model land (a deeper, less-perturbed draft stands in for a
    larger family member with higher acceptance).
    """

    profile: str = "rpi5"
    count: int = 1
    draft_model: str = "llama-1b-draft"  # family in the profile's rate table
    bits: int = 4  # draft weight precision for the rate lookup
    k: int = 0  # per-class speculation length; 0 = spec k_max
    c_th: float = -1.0  # per-class confidence bar; -1 = spec c_th
    net: str = ""  # per-class NetProfile; "" = transport.net
    draft_layers: int = 0  # emulated draft depth; 0 = model.draft_layers
    draft_noise: float = -1.0  # emulated draft quality; -1 = model.draft_noise

    def validate(self) -> None:
        # lazy: keep spec import light (same pattern as TransportSpec.net)
        from repro_torch.serving.devices import DEVICES, NETS

        _check(
            self.profile in DEVICES,
            f"fleet class profile {self.profile!r} not in {sorted(DEVICES)}",
        )
        _check(self.count >= 1, f"fleet class count must be >= 1, got {self.count}")
        table = DEVICES[self.profile].draft_rate
        _check(
            (self.draft_model, self.bits) in table,
            f"fleet class {self.profile!r} has no draft rate for "
            f"(draft_model={self.draft_model!r}, bits={self.bits}); available "
            f"combos: {', '.join(f'({m!r}, {b})' for m, b in sorted(table))}",
        )
        _check(
            self.c_th == -1.0 or 0.0 <= self.c_th <= 1.0,
            f"fleet class c_th must be in [0, 1] (or -1 to inherit), got {self.c_th}",
        )
        _check(self.k >= 0, "fleet class k must be >= 0 (0 = spec k_max)")
        _check(
            not self.net or self.net in NETS,
            f"fleet class net {self.net!r} not in {sorted(NETS)}",
        )
        _check(self.draft_layers >= 0, "fleet class draft_layers must be >= 0")
        _check(
            self.draft_noise == -1.0 or self.draft_noise >= 0.0,
            "fleet class draft_noise must be >= 0 (or -1 to inherit)",
        )


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """A heterogeneous device fleet: an ordered list of device classes.

    When ``classes`` is non-empty the fleet is *active*: ``ServeSpec.devices``
    is derived from the class counts (device ids are assigned contiguously in
    class order: class 0 gets ids ``[0, count_0)``, class 1 the next
    ``count_1``, ...), and every backend resolves per-device k / c_th /
    draft model / net from the owning class.

    ``emulate_rates`` throttles each class's drafting to its hardware
    profile's measured tokens/s (times ``rate_scale``, so benchmarks can
    compress wall-clock while preserving the RPi-vs-Jetson ratios) — the
    transport runtime sleeps between drafted tokens exactly like the
    single-rate ``transport.draft_rate`` knob, but per class.
    """

    classes: Tuple[DeviceClassSpec, ...] = ()
    emulate_rates: bool = False
    rate_scale: float = 1.0

    def __post_init__(self) -> None:
        cls = self.classes
        if isinstance(cls, (list, tuple)):
            object.__setattr__(
                self, "classes", tuple(_device_class_from(c) for c in cls)
            )

    @property
    def active(self) -> bool:
        return bool(self.classes)

    @property
    def total(self) -> int:
        return sum(c.count for c in self.classes)

    def validate(self) -> None:
        for c in self.classes:
            c.validate()
        _check(self.rate_scale > 0, "fleet.rate_scale must be > 0")


def _device_class_from(c) -> DeviceClassSpec:
    if isinstance(c, DeviceClassSpec):
        return c
    if not isinstance(c, dict):
        raise SpecError(
            f"fleet.classes entries must be objects, got {type(c).__name__}"
        )
    return _sub_from_dict(DeviceClassSpec, "fleet.classes", c)


@dataclasses.dataclass(frozen=True)
class ResolvedClass:
    """A fleet class with spec-level defaults filled in and its device-id
    range assigned — what System / the tuner / the simulator consume."""

    index: int
    lo: int  # device ids [lo, hi) belong to this class
    hi: int
    spec: DeviceClassSpec
    k: int
    c_th: float
    net: str
    draft_layers: Optional[int]
    draft_noise: float

    @property
    def count(self) -> int:
        return self.hi - self.lo

    def hardware_rate(self) -> float:
        """The class's measured drafting tokens/s from its hardware profile."""
        from repro_torch.serving.devices import DEVICES

        return DEVICES[self.spec.profile].rate(self.spec.draft_model, self.spec.bits)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """The full deployment: model pair + backend + workload + every knob.

    ``backend`` selects the execution stack ``System.build`` constructs:

      reference   lock-step sled_generate loop (algorithmic ground truth)
      engine      one in-process ServerEngine (continuous batching)
      cluster     Router over N in-process engine replicas + placement
      transport   asyncio wire runtime (codec frames over loopback/sim links),
                  fronting one engine or a replica Router

    All four commit token-identical streams for the same spec under greedy
    drafting on lossless links — tests/test_api.py enforces it.
    """

    backend: str = "engine"
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    transport: TransportSpec = dataclasses.field(default_factory=TransportSpec)
    cluster: ClusterSpec = dataclasses.field(default_factory=ClusterSpec)
    scheduler: SchedulerSpec = dataclasses.field(default_factory=SchedulerSpec)
    # workload: the fleet this spec serves by default.  ``fleet`` makes it
    # heterogeneous: when fleet.classes is non-empty, ``devices`` is DERIVED
    # from the class counts (any explicit value is overwritten) and each
    # device resolves k/c_th/draft/net from its owning class.
    fleet: FleetSpec = dataclasses.field(default_factory=FleetSpec)
    devices: int = 6
    prompt_len: int = 12
    prompt_seed: int = 2
    max_new: int = 24
    session_seed_base: int = 1000  # device i drafts with seed base + i
    # decoding / verification
    k_max: int = 4
    c_th: float = 0.3  # Eq. 1 dynamic-drafting confidence threshold
    greedy: bool = True
    kctl: str = "fixed"  # fixed | adaptive (closed-loop spec length)
    cctl: str = "fixed"  # fixed | adaptive (closed-loop drafting confidence)
    max_len: int = 128
    attn_chunk: int = 32
    paged_attention: bool = True
    # KV-pool storage dtype: "int8" roughly halves bytes-per-slot (doubling
    # server capacity at a fixed HBM budget) at the cost of quantized cache
    # reads; rejected for ssm/hybrid families at System.build (their
    # recurrent state has no quantized layout)
    kv_dtype: str = "bf16"
    # observability: metrics registry + per-round traces (repro.telemetry).
    # Off by default — spans wrap host-side boundaries only, and the
    # server-timing Verdict fields are populated either way, so flipping
    # this can never change the committed token streams.
    telemetry: bool = False
    # chaos: a seeded, deterministic fault schedule injected while serving
    # (kill/hang workers at a router step, drop/delay control RPCs).  Empty
    # by default — no faults, no behaviour change.
    faults: FaultSpec = dataclasses.field(default_factory=FaultSpec)

    def __post_init__(self) -> None:
        if self.fleet.active:
            # devices is derived from the fleet — class counts are the single
            # source of truth, so replace(spec, fleet=...) sweeps stay coherent
            object.__setattr__(self, "devices", self.fleet.total)
        self.validate()

    # -- validation ----------------------------------------------------------

    def validate(self) -> None:
        _check(self.backend in BACKENDS, f"backend {self.backend!r} not in {BACKENDS}")
        self.model.validate()
        self.transport.validate()
        self.cluster.validate()
        self.scheduler.validate()
        self.fleet.validate()
        _check(self.devices >= 1, "devices must be >= 1")
        _check(self.prompt_len >= 1, "prompt_len must be >= 1")
        _check(self.max_new >= 1, "max_new must be >= 1")
        _check(self.k_max >= 1, "k_max must be >= 1")
        _check(0.0 <= self.c_th <= 1.0, "c_th must be in [0, 1]")
        _check(self.kctl in KCTLS, f"kctl {self.kctl!r} not in {KCTLS}")
        # a stream occupies prompt + committed tokens + one in-flight round of
        # slack in its pool row; a spec that can overflow a row would silently
        # clamp dynamic_update_slice appends and corrupt the cache tail
        _check(
            self.max_len >= self.prompt_len + self.max_new + self.k_max + 1,
            f"max_len {self.max_len} cannot hold prompt_len {self.prompt_len} "
            f"+ max_new {self.max_new} + k_max+1 in-flight slack",
        )
        _check(self.attn_chunk >= 1, "attn_chunk must be >= 1")
        _check(
            self.kv_dtype in KV_DTYPES, f"kv_dtype {self.kv_dtype!r} not in {KV_DTYPES}"
        )
        # cross-field combinations
        _check(
            self.cluster.n_replicas == 1 or self.backend in ("cluster", "transport"),
            f"replicas={self.cluster.n_replicas} needs backend 'cluster' or "
            f"'transport', not {self.backend!r} (the reference loop and the "
            "bare engine are single-replica by definition)",
        )
        _check(
            not self.cluster.has_remote or self.backend in ("cluster", "transport"),
            f"remote replicas need backend 'cluster' or 'transport', not "
            f"{self.backend!r} (a worker process is a cluster member)",
        )
        _check(
            not self.cluster.has_remote or self.transport.codec_version >= 3,
            "remote replicas need codec_version >= 3 (the Router<->worker "
            "control plane — PlaceReplica, driver RPCs, stream export — is v3)",
        )
        _check(
            self.kctl != "adaptive" or self.backend == "transport",
            "kctl='adaptive' needs backend='transport': the acceptance/"
            "queue-depth feedback rides Verdict frames",
        )
        _check(
            self.kctl != "adaptive" or self.transport.codec_version >= 2,
            "kctl='adaptive' needs codec_version >= 2 (v1 Verdict frames "
            "carry no accept_rate/queue_depth feedback)",
        )
        _check(self.cctl in CCTLS, f"cctl {self.cctl!r} not in {CCTLS}")
        _check(
            self.cctl != "adaptive" or self.backend == "transport",
            "cctl='adaptive' needs backend='transport': the acceptance/"
            "queue-depth feedback rides Verdict frames",
        )
        _check(
            self.cctl != "adaptive" or self.transport.codec_version >= 2,
            "cctl='adaptive' needs codec_version >= 2 (v1 Verdict frames "
            "carry no accept_rate/queue_depth feedback)",
        )
        # heterogeneous fleets
        _check(
            not self.fleet.active or self.backend != "reference",
            "a heterogeneous fleet needs backend 'engine', 'cluster', or "
            "'transport': the lock-step reference loop batches every device "
            "through one (k, c_th, draft) configuration (use "
            "fleet_reference_specs() for per-class ground truth)",
        )
        if self.fleet.active:
            for rc in self.resolved_classes():
                _check(
                    1 <= rc.k <= self.k_max,
                    f"fleet class {rc.index} ({rc.spec.profile!r}) resolves "
                    f"k={rc.k}, outside [1, k_max={self.k_max}] (the engine's "
                    "verify width is sized by k_max)",
                )
        _check(
            self.cluster.placement != "class-affinity" or self.fleet.active,
            "cluster.placement 'class-affinity' needs a fleet: without "
            "device classes it has nothing to group by",
        )
        self.faults.validate()
        _check(
            not self.faults.active or self.backend in ("cluster", "transport"),
            f"a fault schedule needs backend 'cluster' or 'transport', not "
            f"{self.backend!r} (faults target replica workers and control links)",
        )
        if self.faults.active:
            n = self.cluster.n_replicas
            for e in self.faults.events:
                _check(
                    e.replica < n,
                    f"fault event targets replica {e.replica} but the cluster "
                    f"has only {n} replicas",
                )

    # -- derived -------------------------------------------------------------

    @property
    def slots_per_replica(self) -> int:
        """Pool rows per replica: explicit, or the fleet split evenly.
        A per-replica ``ReplicaSpec.slots`` override beats both."""
        if self.scheduler.slots:
            return self.scheduler.slots
        return -(-self.devices // self.cluster.n_replicas)  # ceil div

    def resolved_classes(self) -> Tuple[ResolvedClass, ...]:
        """The fleet with spec-level defaults filled in and contiguous
        device-id ranges assigned; empty when the fleet is inactive."""
        out, lo = [], 0
        for i, c in enumerate(self.fleet.classes):
            hi = lo + c.count
            out.append(ResolvedClass(
                index=i, lo=lo, hi=hi, spec=c,
                k=c.k or self.k_max,
                c_th=c.c_th if c.c_th >= 0 else self.c_th,
                net=c.net or self.transport.net,
                draft_layers=c.draft_layers or self.model.draft_layers,
                draft_noise=c.draft_noise if c.draft_noise >= 0 else self.model.draft_noise,
            ))
            lo = hi
        return tuple(out)

    def class_of(self, device_id: int) -> Optional[ResolvedClass]:
        """The resolved class owning ``device_id``; None without a fleet."""
        for rc in self.resolved_classes():
            if rc.lo <= device_id < rc.hi:
                return rc
        return None

    def fleet_reference_specs(self) -> Tuple[Tuple[int, int, "ServeSpec"], ...]:
        """Per-class lock-step ground truth: each fleet class is homogeneous
        (one k, c_th, draft config), so it has an exact single-class
        reference equivalent.  Returns ``(lo, hi, refspec)`` per class —
        serve the refspec with the fleet prompts' ``[lo:hi]`` slice and the
        committed streams must match token-for-token (launch/serve.py
        ``--check`` does exactly that)."""
        out = []
        for rc in self.resolved_classes():
            model = dataclasses.replace(
                self.model,
                draft_layers=rc.draft_layers,
                draft_noise=rc.draft_noise,
            )
            ref = self.with_backend(
                "reference",
                fleet=FleetSpec(),
                devices=rc.count,
                k_max=rc.k,
                c_th=rc.c_th,
                model=model,
            )
            out.append((rc.lo, rc.hi, ref))
        return tuple(out)

    def with_backend(self, backend: str, **changes) -> "ServeSpec":
        """Same deployment on a different backend (replicas reset to 1 and
        kctl/cctl to fixed where the target backend demands it, BEFORE the
        replace so the result always validates)."""
        kw = dict(changes)
        cluster = kw.pop("cluster", self.cluster)
        kctl = kw.pop("kctl", self.kctl)
        cctl = kw.pop("cctl", self.cctl)
        if backend in ("reference", "engine") and (
            cluster.n_replicas != 1 or cluster.has_remote
        ):
            cluster = dataclasses.replace(cluster, replicas=1)
        if backend != "transport":
            if kctl == "adaptive":
                kctl = "fixed"
            if cctl == "adaptive":
                cctl = "fixed"
        fleet = kw.get("fleet", self.fleet)
        if not fleet.active and cluster.placement == "class-affinity":
            cluster = dataclasses.replace(cluster, placement="least-loaded")
        return dataclasses.replace(
            self, backend=backend, cluster=cluster, kctl=kctl, cctl=cctl, **kw
        )

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        """Plain-dict form (nested specs as sub-dicts); json.dumps-safe.
        A per-replica fleet serializes as a list of replica objects (the
        int shorthand stays an int)."""
        d = dataclasses.asdict(self)
        reps = d["cluster"]["replicas"]
        if isinstance(reps, tuple):
            d["cluster"]["replicas"] = [dict(r) for r in reps]
        d["faults"]["events"] = [dict(e) for e in d["faults"]["events"]]
        d["fleet"]["classes"] = [dict(c) for c in d["fleet"]["classes"]]
        return d

    def to_json_str(self, indent: int = 2) -> str:
        return json.dumps(self.to_json(), indent=indent)

    @classmethod
    def from_json(cls, data: Union[str, bytes, dict]) -> "ServeSpec":
        """Inverse of :meth:`to_json`.  Every malformation — bad JSON,
        unknown keys, wrong-typed values — surfaces as a SpecError (a typo'd
        sweep artifact must fail loudly with one exception type, not leak a
        TypeError traceback through a driver)."""
        if isinstance(data, (str, bytes)):
            try:
                data = json.loads(data)
            except json.JSONDecodeError as e:
                raise SpecError(f"spec is not valid JSON: {e}") from e
        if not isinstance(data, dict):
            raise SpecError(f"spec JSON must be an object, got {type(data).__name__}")
        data = dict(data)
        kw = {}
        for name, sub_cls in (
            ("model", ModelSpec),
            ("transport", TransportSpec),
            ("cluster", ClusterSpec),
            ("scheduler", SchedulerSpec),
            ("fleet", FleetSpec),
            ("faults", FaultSpec),
        ):
            if name in data:
                kw[name] = _sub_from_dict(sub_cls, name, data.pop(name))
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise SpecError(f"unknown ServeSpec keys {unknown}")
        try:
            return cls(**kw, **data)
        except SpecError:
            raise
        except (TypeError, ValueError) as e:  # wrong-typed values
            raise SpecError(f"bad ServeSpec value: {e}") from e


def _sub_from_dict(sub_cls, name: str, d: dict):
    if not isinstance(d, dict):
        raise SpecError(f"spec key {name!r} must be an object, got {type(d).__name__}")
    known = {f.name for f in dataclasses.fields(sub_cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise SpecError(f"unknown {name} keys {unknown}")
    try:
        return sub_cls(**d)
    except SpecError:
        raise
    except (TypeError, ValueError) as e:  # wrong-typed values
        raise SpecError(f"bad {name} value: {e}") from e
