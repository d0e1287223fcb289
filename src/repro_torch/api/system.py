"""System + Session: the front door over the port's SLED backends.

The port of ``repro.api.system`` for the ``reference`` (lock-step loop) and
``engine`` (in-process ServerEngine) backends::

    system = System.build(ServeSpec(backend="engine"))   # on the card
    result = system.serve(prompts)                        # ServeResult

``System.build`` takes ``device`` ("cuda" unless the caller asks for the
CPU) and an optional prebuilt ``ModelBundle``, which is how a caller serves
a model at full width: build the bundle from the full config and pass it
in. Sampling (``greedy=False``), quantized targets (``model.bits`` 8 and
4) and heterogeneous fleets (engine backend, one drafting kit per device
class) are served as the JAX package serves them. Specs that need a later
slice (cluster, transport and the fleet knobs only they use,
``paged_attention=False``, the families other than dense and ssm) raise
``NotImplementedError`` naming the ROADMAP.md item.

Sessions on the engine backend interleave cooperatively: each
``generate()`` pump admits waiting sessions, submits ready drafts and steps
the engine once, so concurrently pumped sessions batch together.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.api.events import DoneEvent, Event, RoundEvent, ServeResult, SessionResult, TokenEvent
from repro_torch.api.spec import ServeSpec
from repro_torch.configs.base import get_config
from repro_torch.core import engine_loop
from repro_torch.core.engine import EngineStats
from repro_torch.core.server_engine import EdgeDeviceKit, ServerEngine
from repro_torch.models.kvcache import supports_paged_attention
from repro_torch.models.model_zoo import build_model, perturb_params
from repro_torch.quant import dequantize_pytree, quantize_pytree
from repro_torch.runtime import resolve_device

log = logging.getLogger(__name__)

_PORTED_BACKENDS = ("reference", "engine")
PERTURB_SEED = 7  # the draft-noise stream (the JAX package's perturb default)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue A, {item!r})")


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
        self._committed = 0
        self._t_open = time.time()

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

    def _note_round(self, tokens, n_drafted: int, n_accepted: int) -> None:
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        for t in toks:
            if self._committed < self.max_new:
                self._push(TokenEvent(self.device_id, t, self._committed))
            self._committed += 1
        self._push(RoundEvent(device_id=self.device_id, round=self._rounds,
                              n_drafted=int(n_drafted), n_accepted=int(n_accepted),
                              tokens=tuple(toks)))
        self._rounds += 1
        self._drafted += int(n_drafted)
        self._accepted += int(n_accepted)

    def _finish(self, tokens) -> None:
        tokens = [int(t) for t in tokens][: self.max_new]
        self.result = SessionResult(
            device_id=self.device_id, tokens=tokens, rounds=self._rounds,
            drafted=self._drafted, accepted=self._accepted,
            wall_seconds=time.time() - self._t_open,
        )
        self._system._waiting.pop(self.device_id, None)
        self._system._running.pop(self.device_id, None)
        self._push(DoneEvent(self.device_id, len(tokens)))


class System:
    """A built SLED deployment: models + the spec's execution backend."""

    def __init__(self, spec: ServeSpec, models: ModelBundle, engine: Optional[ServerEngine],
                 kit: Optional[EdgeDeviceKit], device: torch.device,
                 class_kits: Optional[List[EdgeDeviceKit]] = None):
        self.spec = spec
        self.models = models
        self.engine = engine  # ServerEngine | None (reference)
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
        if spec.backend not in _PORTED_BACKENDS:
            raise _not_ported(f"backend {spec.backend!r}", "Cluster and transport")
        # what the transport runtime does with a fleet: per-class draft rates
        # and one home replica per class
        if spec.fleet.emulate_rates:
            raise _not_ported("fleet.emulate_rates", "Cluster and transport")
        if spec.cluster.placement == "class-affinity":
            raise _not_ported("cluster.placement='class-affinity'", "Cluster and transport")
        if not spec.paged_attention:
            raise _not_ported("paged_attention=False", "Other model families")
        if spec.telemetry:
            telemetry.enable(True)  # enable-only, as in the JAX package
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
        for name in ("target_params", "draft_params"):
            if getattr(models, name).device != dev:
                raise ValueError(f"models.{name} live on {getattr(models, name).device}, "
                                 f"the System on {dev}")
        engine = None
        if spec.backend == "engine":
            engine = ServerEngine(
                models.target, models.target_params,
                n_slots=spec.slots_per_replica, max_len=spec.max_len, k_max=spec.k_max,
                policy=spec.scheduler.policy, max_wait=spec.scheduler.max_wait,
                straggler_timeout=spec.scheduler.straggler_timeout, greedy=spec.greedy,
                attn_chunk=spec.attn_chunk, kv_dtype=spec.kv_dtype, device=dev,
            )
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

    def warmup(self) -> Dict[int, float]:
        """Run the verify buckets once (engine backend only)."""
        if self.engine is None:
            return {}
        return self.engine.warmup()

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
        if self.spec.backend == "reference":
            for _ in self._reference_rounds(sessions):
                pass
            stats = self._reference_stats(sessions, time.time() - t0)
        else:
            deadline = time.time() + 600.0
            while not all(s.done for s in sessions):
                self._pump_inproc()
                if time.time() > deadline:
                    raise RuntimeError("in-process fleet failed to drain in 600s")
            stats = self.engine.stats(time.time() - (self._t0 or t0))
        payload = {"snapshot": telemetry.registry().snapshot()} if telemetry.enabled() else None
        return ServeResult(backend=self.spec.backend, sessions=[s.result for s in sessions],
                           engine=stats, wall_seconds=time.time() - t0, telemetry=payload)

    def _generate(self, session: Session) -> Iterator[Event]:
        if session.done:
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

    # -- engine backend ------------------------------------------------------

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
                self.engine.submit(s.device_id, toks, time.time() - self._t0,
                                   draft_q=s._device.pending_q)
        finished = []
        for v in self.engine.step(time.time() - self._t0) or []:
            s = self._running[v.device_id]
            s._device.on_verdict(v)
            s._note_round(v.tokens, n_drafted=s._last_drafted, n_accepted=v.n_accepted)
            if len(s._device.committed) >= s.max_new:
                finished.append(s)
        for s in finished:
            self.engine.retire(s.device_id)
            del self._running[s.device_id]
            s._finish(s._device.committed)

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
