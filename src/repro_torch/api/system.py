"""System + Session: the front door over the port's SLED backends.

The port of ``repro.api.system``: the ``reference`` (lock-step loop),
``engine`` (in-process ServerEngine), ``cluster`` (a Router over in-process
replicas) and ``transport`` (asyncio EdgeClients and a TransportServer
over loopback or simulated links) backends::

    system = System.build(ServeSpec(backend="engine"))   # on the card
    result = system.serve(prompts)                        # ServeResult

``System.build`` takes ``device`` ("cuda" unless the caller asks for the
CPU) and an optional prebuilt ``ModelBundle``, which is how a caller serves
a model at full width: build the bundle from the full config and pass it
in. Sampling (``greedy=False``), quantized targets (``model.bits`` 8 and
4), heterogeneous fleets (one drafting kit per device class), remote
replicas (worker processes behind the Router, on the cluster and
transport backends), fault policies (respawn, device-replay recovery,
heartbeats) and chaos schedules (``spec.faults``) are served as the JAX
package serves them. A stream shed with an evicted replica ends its
session with ``SessionResult.shed`` and is listed in
``ServeResult.lost_devices``; on the transport backend it fails the serve
instead (the JAX package's client waits out its retries there). The
dense, vlm, moe, ssm and hybrid families are served; ``paged_attention=False``
selects the gather/scatter verify, which the ssm and hybrid families ride
anyway (``System.build`` logs that fallback, as the JAX package does). An
encdec spec is refused at build: its prefill needs encoder frames that a
serve does not carry (the JAX ``System`` crashes at its first prefill).

Sessions on the engine and cluster backends interleave cooperatively: each
``generate()`` pump admits waiting sessions, submits ready drafts and steps
the engine once, so concurrently pumped sessions batch together. Transport
sessions run the asyncio client (a loop thread of its own when one session
is streamed).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.api.events import DoneEvent, Event, RoundEvent, ServeResult, SessionResult, TokenEvent
from repro_torch.api.spec import FaultSpec, ServeSpec
from repro_torch.cluster.faults import ChaosInjector, FaultyChannel
from repro_torch.cluster.router import ClassAffinityPlacement, Router
from repro_torch.configs.base import get_config
from repro_torch.core import engine_loop
from repro_torch.core.engine import EngineStats
from repro_torch.core.server_engine import EdgeDeviceKit, ServerEngine
from repro_torch.models.kvcache import supports_paged_attention
from repro_torch.models.model_zoo import build_model, perturb_params
from repro_torch.quant import dequantize_pytree, quantize_pytree
from repro_torch.runtime import resolve_device
from repro_torch.serving.devices import NETS
from repro_torch.transport import codec
from repro_torch.transport.client import ClientStats, EdgeClient
from repro_torch.transport.links import make_link
from repro_torch.transport.server import TransportServer

log = logging.getLogger(__name__)

PERTURB_SEED = 7  # the draft-noise stream (the JAX package's perturb default)


@dataclasses.dataclass
class ModelBundle:
    """The built draft/target pair: configs, functional models, weights."""

    target_cfg: Any
    draft_cfg: Any
    target: Any
    draft: Any
    target_params: Any
    draft_params: Any

    @property
    def vocab(self) -> int:
        return self.target_cfg.vocab_size


def _gen(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def build_models(mspec, device="cuda") -> ModelBundle:
    """Deterministically build the spec's reduced model pair with the port's
    seeded init: target from ``seed`` (weight-quantized to ``bits`` and
    dequantized, when ``bits < 16``), draft from ``seed + 1`` (optionally
    noise-perturbed). The draws differ from the JAX package's
    ``jax.random`` ones; to serve the JAX weights, bridge them in
    (``repro_torch.bridge``) and pass the bundle to ``System.build``."""
    dev = resolve_device(device)
    tcfg = dataclasses.replace(get_config(mspec.arch).reduced(), vocab_size=mspec.vocab_size)
    if mspec.target_layers is not None:
        tcfg = dataclasses.replace(tcfg, num_layers=mspec.target_layers)
    target = build_model(tcfg)
    tp = target.init_params(_gen(dev, mspec.seed))
    if mspec.bits < 16:
        tp = dequantize_pytree(quantize_pytree(tp, mspec.bits))
    dcfg, draft, dp = build_draft_variant(mspec, draft_layers=mspec.draft_layers,
                                          draft_noise=mspec.draft_noise, device=dev)
    return ModelBundle(tcfg, dcfg, target, draft, tp, dp)


def build_draft_variant(mspec, *, draft_layers: Optional[int], draft_noise: float,
                        device="cuda") -> Tuple[Any, Any, Any]:
    """One device class's draft ``(cfg, model, params)``: the spec's draft
    arch, vocab and seed with its own depth and noise. Deterministic: a
    class whose overrides equal the spec model's gets ``build_models``'s
    draft weights."""
    dev = resolve_device(device)
    dcfg = dataclasses.replace(
        get_config(mspec.draft_arch).reduced(), name="edge-draft", vocab_size=mspec.vocab_size
    )
    if draft_layers is not None:
        dcfg = dataclasses.replace(dcfg, num_layers=draft_layers)
    draft = build_model(dcfg)
    dp = perturb_params(draft.init_params(_gen(dev, mspec.seed + 1)), draft_noise,
                        _gen(dev, PERTURB_SEED))
    return dcfg, draft, dp


class KitCache:
    """Per-class draft bundles and drafting kits shared across Systems.

    ``drafts`` maps a draft key ``(draft_arch, draft_layers, draft_noise,
    vocab_size, seed)`` to its ``(cfg, model, params)``; ``kits`` maps the
    draft key plus ``(k, c_th, greedy, attn_chunk)`` to its
    :class:`EdgeDeviceKit`. A caller may fill ``drafts`` with weights of its
    own (the tests bridge the JAX package's class drafts in)."""

    def __init__(self) -> None:
        self.drafts: Dict[tuple, tuple] = {}
        self.kits: Dict[tuple, EdgeDeviceKit] = {}


class Session:
    """One device's stream against a System backend. ``generate()`` yields
    typed events and leaves the :class:`SessionResult` in ``.result``."""

    def __init__(self, system: "System", device_id: int, prompt: np.ndarray, max_new: int,
                 join_tick: int = 0):
        self._system = system
        self.device_id = device_id
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new = max_new
        self.join_tick = join_tick
        self.result: Optional[SessionResult] = None
        self._events: deque = deque()
        self._sink: Optional[Callable[[Event], None]] = None
        self._device = None  # EdgeDevice once admitted (engine backend)
        self._last_drafted = 0
        self._rounds = 0
        self._drafted = 0
        self._accepted = 0
        self._fallback_rounds = 0
        self._fallback_tokens = 0
        self._committed = 0
        self._t_open = time.time()
        self._trace: List = []  # per-round TraceEvents (telemetry on)

    @property
    def done(self) -> bool:
        return self.result is not None

    def generate(self) -> Iterator[Event]:
        return self._system._generate(self)

    def run(self) -> SessionResult:
        for _ in self.generate():
            pass
        return self.result

    def _push(self, ev: Event) -> None:
        if self._sink is not None:
            self._sink(ev)
        else:
            self._events.append(ev)

    def _note_round(self, tokens, n_drafted: int, n_accepted: int,
                    fallback: bool = False) -> None:
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        for t in toks:
            if self._committed < self.max_new:
                self._push(TokenEvent(self.device_id, t, self._committed))
            self._committed += 1
        self._push(RoundEvent(device_id=self.device_id, round=self._rounds,
                              n_drafted=int(n_drafted), n_accepted=int(n_accepted),
                              tokens=tuple(toks), fallback=fallback))
        self._rounds += 1
        self._drafted += int(n_drafted)
        if fallback:
            self._fallback_rounds += 1
            self._fallback_tokens += len(toks)
        else:
            self._accepted += int(n_accepted)

    def _finish(self, tokens, client: Optional[ClientStats] = None, shed: bool = False) -> None:
        tokens = [int(t) for t in tokens][: self.max_new]
        self.result = SessionResult(
            device_id=self.device_id, tokens=tokens, rounds=self._rounds,
            drafted=self._drafted, accepted=self._accepted,
            fallback_rounds=self._fallback_rounds, fallback_tokens=self._fallback_tokens,
            wall_seconds=(client.wall_seconds if client is not None
                          else time.time() - self._t_open),
            shed=shed, client=client, trace=self._trace,
        )
        self._system._waiting.pop(self.device_id, None)
        self._system._running.pop(self.device_id, None)
        self._push(DoneEvent(self.device_id, len(tokens)))


class System:
    """A built SLED deployment: models + the spec's execution backend."""

    def __init__(self, spec: ServeSpec, models: ModelBundle,
                 engine: Union[ServerEngine, Router, None], kit: Optional[EdgeDeviceKit],
                 device: torch.device, class_kits: Optional[List[EdgeDeviceKit]] = None):
        self.spec = spec
        self.models = models
        self.engine = engine  # ServerEngine | Router | None (reference)
        self.kit = kit
        # a fleet: one kit per resolved device class (kit_for routes)
        self.class_kits: List[EdgeDeviceKit] = list(class_kits or [])
        self.device = device
        self._waiting: Dict[int, Session] = {}
        self._running: Dict[int, Session] = {}
        self._used_ids: set = set()
        self._tick = 0
        self._t0: Optional[float] = None
        self._ref_steps: Optional[dict] = None
        # one transport fleet at a time: the engine is not thread-safe, and
        # each fleet run owns its own TransportServer and event loop
        self._transport_lock = threading.Lock()

    @classmethod
    def build(
        cls,
        spec: ServeSpec,
        *,
        models: Optional[ModelBundle] = None,
        kits: Optional[KitCache] = None,
        warmup: bool = False,
        device="cuda",
    ) -> "System":
        """Construct the backend the spec names, on ``device``. ``kits`` (a
        :class:`KitCache`) shares a fleet's class drafts and kits across
        Systems."""
        dev = resolve_device(device)
        spec.validate()
        cfgs = [get_config(arch) for arch in (spec.model.arch, spec.model.draft_arch)]
        if models is not None:
            cfgs += [models.target_cfg, models.draft_cfg]
        encdec = sorted({cfg.name for cfg in cfgs if cfg.is_encdec})
        if encdec:
            # the JAX System builds this spec and crashes at the first
            # prefill (no enc_frames reach transformer.encode); refusing here
            # is a departure, and a spec has no frames input to add
            raise ValueError(
                f"{', '.join(encdec)}: an encdec model needs its encoder frames (the "
                "enc_frames of model_zoo.frontend_stub) at every prefill, and a serve "
                "has no encoder frames to give it; run the family through "
                "model_zoo.build_model and verification.make_prefill_step(with_frontend=True)"
            )
        if spec.backend == "transport" and not spec.greedy and spec.transport.qmode == "none":
            # the clients would send no q and the server's admission refuses
            # a sampled round without one (a departure: the JAX package
            # builds this spec and its serve hangs)
            raise ValueError("a sampled transport serve (greedy=False) needs a draft-q "
                             "payload: set transport.qmode to 'f32', 'f16' or 'int8'")
        if spec.backend == "transport" and spec.transport.codec_version != codec.VERSION:
            # the spec can describe other protocol versions; this runtime
            # speaks the current one only
            raise ValueError(
                f"this runtime speaks codec v{codec.VERSION} only; the spec declares "
                f"codec_version={spec.transport.codec_version}"
            )
        if spec.telemetry:
            telemetry.enable(True)  # enable-only, as in the JAX package
        if models is not None and spec.cluster.has_remote:
            log.warning(
                "a shared ModelBundle cannot ship to remote workers: each "
                "worker rebuilds params from the spec's model seed, so a "
                "bundle that differs from build_models(spec.model) would "
                "break cross-process token identity"
            )
        models = models or build_models(spec.model, device=dev)
        if spec.kv_dtype == "int8" and not supports_paged_attention(models.target_cfg):
            # loud: a silently-bf16 pool would report double the capacity
            # the deployment has
            raise ValueError(
                f"kv_dtype='int8' is not supported for model family "
                f"{models.target_cfg.family!r} "
                f"({spec.model.arch}): its caches ride the gather/scatter "
                "fallback (models/kvcache.py) whose recurrent state leaves "
                "have no quantized layout — serve this family with "
                "kv_dtype='bf16'"
            )
        if (spec.backend != "reference" and spec.paged_attention
                and not supports_paged_attention(models.target_cfg)):
            log.warning(
                "paged attention is unavailable for model family %r (%s): "
                "verification falls back to gather/scatter cache paging",
                models.target_cfg.family, spec.model.arch,
            )
        for name in ("target_params", "draft_params"):
            if getattr(models, name).device != dev:
                raise ValueError(f"models.{name} live on {getattr(models, name).device}, "
                                 f"the System on {dev}")
        engine: Union[ServerEngine, Router, None] = None
        if spec.backend != "reference":
            engine_kw = dict(
                max_len=spec.max_len, k_max=spec.k_max, policy=spec.scheduler.policy,
                max_wait=spec.scheduler.max_wait,
                straggler_timeout=spec.scheduler.straggler_timeout, greedy=spec.greedy,
                attn_chunk=spec.attn_chunk, paged_attention=spec.paged_attention,
                kv_dtype=spec.kv_dtype, device=dev,
            )
            if spec.cluster.has_remote:
                engine = cls._build_remote_cluster(spec, models, engine_kw, dev)
            elif spec.backend == "engine" or (
                spec.backend == "transport" and spec.cluster.n_replicas == 1
                and not spec.faults.active
            ):
                # one replica: the bare engine (the transport server fronts an
                # engine or a Router alike); a chaos schedule needs the
                # Router's supervision, so a chaos run keeps it
                engine = ServerEngine(models.target, models.target_params,
                                      n_slots=spec.slots_per_replica, **engine_kw)
            else:  # cluster, or transport fronting a replica set
                engine = Router.build(
                    models.target, models.target_params, replicas=spec.cluster.n_replicas,
                    n_slots=spec.slots_per_replica, placement=cls._placement(spec),
                    migrate_on_retire=spec.cluster.migrate_on_retire,
                    faults=spec.cluster.faults, **engine_kw,
                )
            if spec.faults.active and isinstance(engine, Router):
                engine.chaos = ChaosInjector(spec.faults, engine)
        kit = EdgeDeviceKit(
            models.draft, models.draft_params, k_max=spec.k_max, c_th=spec.c_th,
            greedy=spec.greedy, attn_chunk=spec.attn_chunk, device=dev,
        )
        class_kits = cls._build_class_kits(spec, models, kits, dev) if spec.fleet.active else None
        system = cls(spec, models, engine, kit, dev, class_kits=class_kits)
        if warmup:
            system.warmup()
        return system

    @classmethod
    def _placement(cls, spec: ServeSpec):
        """The Router's placement: the spec's policy name, or a
        ClassAffinityPlacement on the fleet's device -> class map, so each
        device class has a home replica (one k, one draft per batch)."""
        if spec.cluster.placement == "class-affinity" and spec.fleet.active:
            ranges = tuple((rc.lo, rc.hi) for rc in spec.resolved_classes())

            def class_index(dev: int) -> int:
                for i, (lo, hi) in enumerate(ranges):
                    if lo <= dev < hi:
                        return i
                return dev  # a late-joined id outside the fleet: its own bucket

            return ClassAffinityPlacement(class_index)
        return spec.cluster.placement

    @classmethod
    def _build_remote_cluster(cls, spec: ServeSpec, models: ModelBundle, engine_kw: dict,
                              dev: torch.device) -> Router:
        """A Router over the spec's replica list, under the spec's
        FaultPolicy. A remote replica DIALS the worker its ReplicaSpec
        addresses, or SPAWNS one on ``dev`` on a private unix socket (reaped
        by ``close()``; a revive spawns its successor on ``dev`` too), and
        is then PLACED: the worker receives this spec as one engine replica
        (same model seed, its pool's slots, no chaos schedule: the Router
        runs that) and rebuilds the weights from the seed. Its control
        channel is a FaultyChannel when the schedule drops, delays or flaps
        RPCs. An in-process entry builds its ServerEngine here. Every worker
        is drained when any step fails."""
        from repro_torch.cluster.remote import DEFAULT_TIMEOUT, RemoteReplica

        policy = spec.cluster.faults
        rpc_timeout = policy.rpc_timeout_s if policy.rpc_timeout_s > 0 else DEFAULT_TIMEOUT
        # drop, delay and flap act on the control channel
        wrap_channels = any(e.kind in ("drop", "delay", "flap") for e in spec.faults.events)
        worker_base = spec.with_backend("engine", faults=FaultSpec())
        replicas: list = []
        try:
            for rs in spec.cluster.replica_specs:
                slots = rs.slots or spec.slots_per_replica
                if rs.flavor == "inproc":
                    replicas.append(ServerEngine(models.target, models.target_params,
                                                 n_slots=slots, **engine_kw))
                    continue
                worker_spec = dataclasses.replace(
                    worker_base,
                    scheduler=dataclasses.replace(worker_base.scheduler, slots=slots))
                if rs.address:
                    remote = RemoteReplica.dial(rs.address, timeout=rpc_timeout)
                else:
                    remote = RemoteReplica.spawn(device=dev, timeout=rpc_timeout)
                replicas.append(remote)
                remote.retry_rpcs = policy.retry_rpcs
                if wrap_channels:
                    remote.channel = FaultyChannel(remote.channel)
                remote.place(worker_spec)
        except BaseException:
            for r in replicas:
                if getattr(r, "flavor", "local") == "remote":
                    r.drain()
            raise
        return Router(replicas, placement=cls._placement(spec),
                      migrate_on_retire=spec.cluster.migrate_on_retire, faults=policy)

    @classmethod
    def _build_class_kits(cls, spec: ServeSpec, models: ModelBundle, cache: Optional[KitCache],
                          dev: torch.device) -> List[EdgeDeviceKit]:
        """One drafting kit per resolved fleet class. A class whose draft
        config is the spec model's rides the bundle's draft; another builds
        its own deterministic variant, unless ``cache`` holds it. Classes
        that agree on (draft, k, c_th) share one kit."""
        mspec = spec.model
        cache = cache if cache is not None else KitCache()
        out: List[EdgeDeviceKit] = []
        for rc in spec.resolved_classes():
            dkey = (mspec.draft_arch, rc.draft_layers, rc.draft_noise, mspec.vocab_size,
                    mspec.seed)
            if (rc.draft_layers, rc.draft_noise) == (mspec.draft_layers, mspec.draft_noise):
                bundle = (models.draft_cfg, models.draft, models.draft_params)
            else:
                bundle = cache.drafts.get(dkey)
                if bundle is None:
                    bundle = build_draft_variant(mspec, draft_layers=rc.draft_layers,
                                                 draft_noise=rc.draft_noise, device=dev)
                    cache.drafts[dkey] = bundle
            _, dmodel, dparams = bundle
            kkey = dkey + (rc.k, rc.c_th, spec.greedy, spec.attn_chunk)
            kit = cache.kits.get(kkey)
            if kit is None:
                kit = EdgeDeviceKit(dmodel, dparams, k_max=rc.k, c_th=rc.c_th,
                                    greedy=spec.greedy, attn_chunk=spec.attn_chunk, device=dev)
                cache.kits[kkey] = kit
            out.append(kit)
        return out

    def kit_for(self, device_id: int) -> EdgeDeviceKit:
        """The drafting kit serving ``device_id``: its device class's kit
        under a fleet spec, else the spec's kit."""
        if self.class_kits:
            rc = self.spec.class_of(device_id)
            if rc is not None:
                return self.class_kits[rc.index]
        return self.kit

    def rate_for(self, device_id: int) -> Optional[float]:
        """Draft-rate throttle for ``device_id`` in tokens/s (None: none):
        the class's hardware rate times ``fleet.rate_scale`` when the fleet
        emulates device speeds, else the transport's ``draft_rate``."""
        fleet = self.spec.fleet
        if fleet.active and fleet.emulate_rates:
            rc = self.spec.class_of(device_id)
            if rc is not None:
                return rc.hardware_rate() * fleet.rate_scale
        return self.spec.transport.draft_rate

    def warmup(self) -> Dict[int, float]:
        """Run the verify buckets once (engine-backed backends only)."""
        if self.engine is None:
            return {}
        return self.engine.warmup()

    def close(self) -> None:
        """Release what outlives a serve: drain every remote worker (and
        reap the ones this System spawned). The in-process backends hold
        nothing of the kind; safe to call twice."""
        if isinstance(self.engine, Router):
            self.engine.drain()

    def __enter__(self) -> "System":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def prompts(self) -> np.ndarray:
        """The spec's default workload: ``(devices, prompt_len)`` prompts drawn
        with numpy from ``prompt_seed`` (not the JAX package's draws)."""
        rng = np.random.default_rng(self.spec.prompt_seed)
        return rng.integers(0, self.models.vocab, size=(self.spec.devices, self.spec.prompt_len),
                            dtype=np.int32)

    # -- sessions ------------------------------------------------------------

    def open_session(self, prompt=None, *, device_id: Optional[int] = None,
                     max_new: Optional[int] = None, join_tick: int = 0) -> Session:
        """Register a stream; it joins the backend when first pumped."""
        if device_id is None:
            device_id = 0
            while device_id in self._used_ids:
                device_id += 1
        if device_id in self._used_ids:
            raise ValueError(f"device {device_id} already has a session")
        if prompt is None:
            defaults = self.prompts()
            if device_id >= defaults.shape[0]:
                raise ValueError(
                    f"no default prompt for device {device_id} "
                    f"(spec.devices={self.spec.devices}); pass prompt="
                )
            prompt = defaults[device_id]
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        budget = max_new or self.spec.max_new
        if self.engine is not None and prompt.shape[0] + budget + self.spec.k_max + 1 > self.spec.max_len:
            raise ValueError(
                f"prompt of {prompt.shape[0]} + max_new {budget} + k_max+1 slack "
                f"exceeds the pool row length max_len={self.spec.max_len}"
            )
        self._used_ids.add(device_id)
        session = Session(self, device_id, prompt, budget, join_tick=join_tick)
        self._waiting[device_id] = session
        return session

    def serve(self, prompts=None, *, max_new: Optional[int] = None,
              on_event: Optional[Callable[[Event], None]] = None) -> ServeResult:
        """Run the whole fleet (spec workload, or explicit ``prompts``)
        concurrently to completion. Engine stats are lifetime-cumulative
        across repeated serve() calls on one System."""
        if self._waiting or self._running:
            raise RuntimeError("serve() needs a fresh System (sessions already open)")
        self._tick, self._t0 = 0, None
        self._used_ids.clear()
        prompts = self.prompts() if prompts is None else np.asarray(prompts)
        sink = on_event or (lambda ev: None)
        sessions = []
        for i in range(prompts.shape[0]):
            s = self.open_session(prompts[i], device_id=i, max_new=max_new,
                                  join_tick=i * self.spec.scheduler.stagger_ticks)
            s._sink = sink
            sessions.append(s)
        t0 = time.time()
        clients: Optional[ClientStats] = None
        if self.spec.backend == "reference":
            for _ in self._reference_rounds(sessions):
                pass
            stats = self._reference_stats(sessions, time.time() - t0)
        elif self.spec.backend == "transport":
            with self._transport_lock:
                stats, clients = asyncio.run(self._transport_fleet(sessions))
        else:
            deadline = time.time() + 600.0
            while not all(s.done for s in sessions):
                self._pump_inproc()
                if time.time() > deadline:
                    raise RuntimeError("in-process fleet failed to drain in 600s")
            stats = self.engine.stats(time.time() - (self._t0 or t0))
        payload: Optional[dict] = None
        if telemetry.enabled():
            payload = (self.engine.telemetry_payload() if self.engine is not None
                       else {"snapshot": telemetry.registry().snapshot(), "flight": []})
        return ServeResult(backend=self.spec.backend, sessions=[s.result for s in sessions],
                           engine=stats, clients=clients, wall_seconds=time.time() - t0,
                           lost_devices=sorted(getattr(self.engine, "lost_devices", ())),
                           telemetry=payload)

    def _generate(self, session: Session) -> Iterator[Event]:
        if session.done:
            return
        if self.spec.backend == "transport":
            yield from self._generate_transport(session)
            return
        gen = (self._reference_rounds([session]) if self.spec.backend == "reference"
               else self._pump_driver(session))
        for _ in gen:
            while session._events:
                yield session._events.popleft()
        while session._events:
            yield session._events.popleft()

    def _pump_driver(self, session: Session) -> Iterator[None]:
        deadline = time.time() + 600.0
        while not session.done:
            self._pump_inproc()
            if time.time() > deadline:
                raise RuntimeError(f"session {session.device_id} failed to finish in 600s")
            yield None

    def _generate_transport(self, session: Session) -> Iterator[Event]:
        """Stream one transport session: the asyncio client runs on a loop
        thread of its own and its events cross over a queue. Concurrent
        transport streams take turns behind the System's transport lock (the
        engine is not thread-safe). Closing the generator early cancels the
        run and retires the stream, so its slot frees."""
        q: queue.Queue = queue.Queue()
        session._sink = q.put
        done = object()
        cancelled = threading.Event()
        handle: dict = {}

        def work():
            async def runner():
                handle["loop"] = asyncio.get_running_loop()
                handle["task"] = asyncio.current_task()
                await self._transport_fleet([session])

            with self._transport_lock:
                if cancelled.is_set():  # the consumer left before our turn
                    q.put(done)
                    return
                try:
                    asyncio.run(runner())
                except asyncio.CancelledError:
                    pass
                except BaseException as e:  # raised again on the consumer's side
                    q.put(e)
                finally:
                    if not session.done:  # cancelled mid-stream: free the slot
                        self._waiting.pop(session.device_id, None)
                        if self.engine is not None and session.device_id in self.engine.streams:
                            self.engine.retire(session.device_id)
                q.put(done)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancelled.set()
            if not session.done and handle.get("task") is not None:
                try:
                    handle["loop"].call_soon_threadsafe(handle["task"].cancel)
                except RuntimeError:
                    pass  # the loop has closed already
            t.join(timeout=60.0)

    # -- engine and cluster backends -----------------------------------------

    def _pump_inproc(self) -> None:
        """One scheduler tick: admit joined sessions, submit ready drafts,
        step the engine, route verdicts back to their sessions."""
        if self.engine is None:
            raise RuntimeError("the reference backend has no engine to pump")
        if self._t0 is None:
            self._t0 = time.time()
        self._tick += 1
        now = time.time() - self._t0
        for dev_id in sorted(self._waiting):
            s = self._waiting[dev_id]
            if s.join_tick > self._tick:
                continue
            if self.engine.admit(dev_id, s.prompt, now) is None:
                break  # pool full: stays waiting, admitted when a slot frees
            s._device = self.kit_for(dev_id).spawn(dev_id, s.prompt, max_len=self.spec.max_len,
                                                   seed=self.spec.session_seed_base + dev_id)
            self._running[dev_id] = s
            del self._waiting[dev_id]
        for s in list(self._running.values()):
            if not s._device.awaiting:
                toks = s._device.draft()
                s._last_drafted = len(toks)
                # the JAX package's in-process pump submits no q, so its
                # engine backend refuses greedy=False; the port submits the
                # q row as the JAX transport client does
                try:
                    self.engine.submit(s.device_id, toks, time.time() - self._t0,
                                       draft_q=None if self.spec.greedy else s._device.pending_q)
                except ConnectionError:
                    # the replica died and the stream could not be placed
                    # again: the sweep below ends its session as shed
                    if s.device_id in self.engine.streams:
                        raise
        finished = []
        traced = telemetry.enabled()
        for v in self.engine.step(time.time() - self._t0) or []:
            s = self._running[v.device_id]
            s._device.on_verdict(v)
            if traced:
                s._trace.append(telemetry.TraceEvent(
                    device_id=v.device_id, round=s._rounds, t=time.time() - self._t0,
                    k=s._last_drafted, n_accepted=int(v.n_accepted), n_commit=len(v.tokens),
                    queue_s=float(v.queue_s), verify_s=float(v.verify_s),
                ))
            s._note_round(v.tokens, n_drafted=s._last_drafted, n_accepted=v.n_accepted)
            if len(s._device.committed) >= s.max_new:
                finished.append(s)
        for s in finished:
            self.engine.retire(s.device_id)
            del self._running[s.device_id]
            s._finish(s._device.committed)
        self._sweep_lost()

    def _sweep_lost(self) -> None:
        """Sessions whose streams were shed with an evicted replica end with
        an explicit rejection (``SessionResult.shed``) and what they had
        committed, never with a serve loop that waits for ever."""
        lost = set(getattr(self.engine, "lost_devices", ()))
        for dev in [d for d in self._running if d in lost]:
            s = self._running.pop(dev)
            log.warning("session %d was shed with its replica; ending it", dev)
            s._finish(s._device.committed, shed=True)
        for dev in [d for d in self._waiting if d in lost]:
            self._waiting.pop(dev)._finish([], shed=True)

    # -- reference backend ---------------------------------------------------

    def _reference_rounds(self, sessions: List[Session]) -> Iterator[None]:
        """Lock-step draft+verify over the sessions' prompts (a thin consumer
        of engine_loop.sled_rounds), yielding once per round."""
        spec = self.spec
        lens = {s.prompt.shape[0] for s in sessions}
        if len(lens) > 1:
            raise ValueError(
                "the reference backend batches sessions lock-step and needs "
                f"equal prompt lengths, got {sorted(lens)}"
            )
        prompts = np.stack([s.prompt for s in sessions])
        budgets = [s.max_new for s in sessions]
        committed: List[List[int]] = [[] for _ in sessions]
        if self._ref_steps is None:
            self._ref_steps = engine_loop.make_sled_steps(
                self.models.draft, self.models.target, k_max=spec.k_max, c_th=spec.c_th,
                greedy=spec.greedy, attn_chunk=spec.attn_chunk,
            )
        gen = engine_loop.sled_rounds(
            self.models.draft, self.models.draft_params,
            self.models.target, self.models.target_params, prompts,
            max_new=max(budgets), k_max=spec.k_max, c_th=spec.c_th, greedy=spec.greedy,
            seed=0, attn_chunk=spec.attn_chunk, steps=self._ref_steps, kv_dtype=spec.kv_dtype,
        )
        for rnd in gen:
            for b, s in enumerate(sessions):
                if len(committed[b]) >= budgets[b]:
                    continue  # this stream is done; it just rides the batch
                row = [int(t) for t in rnd.tokens[b, : int(rnd.n_commit[b])]]
                committed[b].extend(row)
                s._note_round(row, n_drafted=int(rnd.lengths[b]),
                              n_accepted=int(rnd.n_accepted[b]))
                if len(committed[b]) >= budgets[b]:
                    s._finish(committed[b])
            if all(s.done for s in sessions):
                break  # heterogeneous budgets: don't ride out the longest row
            yield None

    def _reference_stats(self, sessions: List[Session], wall: float) -> EngineStats:
        """Stats record for the reference loop (no server)."""
        total = sum(len(s.result.tokens) for s in sessions)
        rounds = max((s.result.rounds for s in sessions), default=0)
        drafted = sum(s.result.drafted for s in sessions)
        accepted = sum(s.result.accepted for s in sessions)
        wall = max(wall, 1e-9)
        return EngineStats(
            wstgr=total / wall, per_device_rate=total / max(len(sessions), 1) / wall,
            server_busy_frac=1.0, rounds=rounds, timeouts=0, fallback_tokens=0,
            mean_batch_fill=float(len(sessions)), mean_round_latency=0.0,
            server_rounds_per_s=rounds / wall, streams_served=len(sessions),
            acceptance_rate=accepted / max(drafted, 1),
        )

    # -- transport backend ---------------------------------------------------

    async def _transport_fleet(self, sessions: List[Session]):
        """The sessions as asyncio EdgeClients against one TransportServer
        fronting the engine: one link per device, seeded
        ``session_seed_base + id``, over its class's network, with a
        reconnect hook that dials a fresh link of the same kind. Returns the
        server's stats (wire counters folded in) and the merged client
        stats."""
        spec, tspec = self.spec, self.spec.transport
        server = TransportServer(self.engine)

        def net_for(dev: int) -> str:
            rc = spec.class_of(dev)
            return rc.net if rc is not None else tspec.net

        def relink(dev: int):
            async def dial():
                fresh = make_link(tspec.link, net=NETS[net_for(dev)],
                                  seed=spec.session_seed_base + dev)
                server.attach(fresh.server)
                return fresh.device

            return dial

        runs = []
        for idx, s in enumerate(sessions):
            link = make_link(tspec.link, net=NETS[net_for(s.device_id)],
                             seed=spec.session_seed_base + s.device_id)
            server.attach(link.server)
            client = EdgeClient(
                self.kit_for(s.device_id), s.device_id, s.prompt, link.device,
                max_new=s.max_new, max_len=spec.max_len, qmode=tspec.qmode,
                pipeline=tspec.pipeline, verify_timeout=tspec.verify_timeout,
                admit_timeout=tspec.verify_timeout, draft_rate=self.rate_for(s.device_id),
                kctl=spec.kctl, cctl=spec.cctl, seed=spec.session_seed_base + s.device_id,
                on_round=s._note_round, reconnect=relink(s.device_id),
            )
            runs.append((idx, s, client))

        async def run_one(idx: int, s: Session, client: EdgeClient):
            await asyncio.sleep(idx * tspec.stagger_s)
            tokens = await client.run()
            s._trace = client.trace  # the client's attribution, wire_s included
            s._finish(tokens, client=client.stats)

        clients = asyncio.gather(*(run_one(i, s, c) for i, s, c in runs))
        watch = asyncio.ensure_future(server.raise_on_error())
        try:
            await asyncio.wait({clients, watch}, return_when=asyncio.FIRST_COMPLETED)
            if watch.done():  # a server task raised: fail the serve, do not hang
                clients.cancel()
                await asyncio.gather(clients, return_exceptions=True)
                await server.stop()
                watch.result()
            await clients
        finally:
            watch.cancel()
            if not clients.done():  # this serve was cancelled: so are its clients
                clients.cancel()
                clients.add_done_callback(lambda f: f.cancelled() or f.exception())
        for _ in range(500):  # let in-flight Close frames retire their streams
            if not self.engine.streams:
                break
            await asyncio.sleep(0.01)
        stats = server.stats()
        await server.stop()
        return stats, ClientStats.merge([c.stats for _, _, c in runs])
