"""Profiling pass of the auto-tuner (``repro_torch.launch.tune``, step 1 of 3).

A short measured run of the fleet spec (telemetry on) calibrates everything
the candidate sweep needs to score configurations WITHOUT serving them:

  per class     acceptance + mean draft length (from per-session counters
                grouped by the spec's device->class ranges)
  server        ``server_latency_scale`` — the ratio between the verify
                spans the engine actually measured (TraceEvent.verify_s)
                and the ServerProfile roofline prediction, which maps the
                simulator's clock onto this deployment's clock
  network       per-class RTT straight from the class NetProfile

Candidate draft configs the profiled fleet is NOT running are priced by
:func:`probe_draft_config`: a tiny lock-step reference run measures the
(acceptance, mean draft length) of one ``(k, c_th, draft_layers,
draft_noise)`` combination.  Acceptance depends only on the model pair and
the drafting knobs — not on device hardware — so one cached probe prices
every class and every candidate that shares the config.

The port's copy of ``repro.tuning.profile``. Its serves run on ``device``
("cuda" unless the caller asks for the CPU) and take no ``steps`` (the
port's eager steps compile nothing to share).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.api import ServeSpec, System
from repro_torch.api.spec import FleetSpec
from repro_torch.serving.devices import NETS, ServerProfile


@dataclasses.dataclass(frozen=True)
class ClassCalibration:
    """Measured priors for one resolved fleet class."""

    index: int
    profile: str             # hardware profile name (serving/devices.py)
    count: int
    k: int
    c_th: float
    acceptance: float        # accepted / drafted over the profiling run
    mean_draft_len: float    # drafted / rounds (c_th cuts drafts short)
    draft_rate: float        # MEASURED drafted tokens per device-second
    commit_rate: float       # MEASURED committed tokens per device-second
    hardware_rate: float     # profile-table tokens/s for the profiled combo
    rtt_mean: float          # class link RTT (0 off simulated links)


@dataclasses.dataclass(frozen=True)
class FleetCalibration:
    """Everything the sweep's simulator scoring needs, all measured."""

    classes: Tuple[ClassCalibration, ...]
    server_latency_scale: float
    verify_s_mean: float
    queue_s_mean: float
    round_latency_mean: float   # queue + verify + wire, per resolved round
    round_latency_p95: float    # tail of the same spans (deadline anchor)
    mean_batch_fill: float
    wstgr: float

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _span_latencies(sessions) -> list:
    """Per-round service latency (queue + verify + wire) from the traces."""
    return [
        ev.queue_s + ev.verify_s + ev.wire_s
        for s in sessions
        for ev in (s.trace or [])
    ]


def _trace_span_rate(rows, total_fn, wall: float) -> float:
    """Mean per-session steady rate: each session's total (tokens, drafts)
    after the first verdict, over its own first->last verdict span.

    Run-to-completion fleets all commit exactly ``max_new`` tokens, so
    ``total / shared_wall`` is identical for every class by construction —
    the per-class signal lives in each stream's time-to-finish.  Sessions
    too short to span two verdicts fall back to ``total / wall``."""
    rates = []
    for s in rows:
        ts = [ev.t for ev in (s.trace or [])]
        total = total_fn(s)
        if len(ts) >= 2 and max(ts) > min(ts):
            rates.append((total - total / len(ts)) / (max(ts) - min(ts)))
        elif wall > 0:
            rates.append(total / wall)
    return sum(rates) / len(rates) if rates else 0.0


def class_commit_rate(rows, *, wall: float = 0.0) -> float:
    """Per-device committed tokens/s (the goodput the floors guard)."""
    return _trace_span_rate(rows, lambda s: len(s.tokens), wall)


def class_draft_rate(rows, *, wall: float = 0.0) -> float:
    """Per-device DRAFTING tokens/s — the simulator's pacing clock.

    Transport clients measure the draft span per round, so the throttled
    (emulated-hardware) rate falls straight out of ``sum k / sum draft_s``;
    in-process backends never fill ``draft_s`` and fall back to the
    trace-span drafted rate (drafting there is compute-bound and cheap, so
    the cadence-diluted estimate is the honest pacing clock)."""
    num = sum(ev.k for s in rows for ev in (s.trace or []) if ev.draft_s > 0)
    den = sum(ev.draft_s for s in rows for ev in (s.trace or []))
    if num and den > 0:
        return num / den
    return _trace_span_rate(rows, lambda s: s.drafted, wall)


def profile_fleet(
    spec: ServeSpec,
    *,
    server: ServerProfile,
    target_params: float,
    models=None,
    kits=None,
    max_new: Optional[int] = None,
    device="cuda",
) -> FleetCalibration:
    """One short telemetry-on serve of the fleet spec -> FleetCalibration."""
    if not spec.fleet.active:
        raise ValueError("profile_fleet needs a spec with an active fleet")
    pspec = dataclasses.replace(spec, telemetry=True)
    with System.build(pspec, models=models, kits=kits, device=device) as system:
        result = system.serve(max_new=max_new)

    wall = max(result.wall_seconds, 1e-9)
    sim_links = pspec.backend == "transport" and pspec.transport.link == "sim"
    classes = []
    for rc in pspec.resolved_classes():
        rows = [s for s in result.sessions if rc.lo <= s.device_id < rc.hi]
        drafted = sum(s.drafted for s in rows)
        accepted = sum(s.accepted for s in rows)
        rounds = sum(s.rounds for s in rows)
        classes.append(ClassCalibration(
            index=rc.index,
            profile=rc.spec.profile,
            count=rc.count,
            k=rc.k,
            c_th=rc.c_th,
            acceptance=accepted / max(drafted, 1),
            mean_draft_len=drafted / max(rounds, 1),
            # measured, not assumed: throttled transport runs measure the
            # emulated hardware rate; free-drafting in-process runs measure
            # the round-trip-bound rate — either way the simulator's clock
            # matches what validation will observe
            draft_rate=class_draft_rate(rows, wall=wall),
            commit_rate=class_commit_rate(rows, wall=wall),
            hardware_rate=rc.hardware_rate(),
            # only simulated links pay the class NetProfile; loopback and
            # in-process rounds have no wire (sim floors rtt at ~1 ms)
            rtt_mean=NETS[rc.net].rtt_mean if sim_links else 0.0,
        ))

    verify = [ev.verify_s for s in result.sessions for ev in (s.trace or [])]
    queue = [ev.queue_s for s in result.sessions for ev in (s.trace or [])]
    lat = _span_latencies(result.sessions)
    verify_mean = sum(verify) / max(len(verify), 1)
    fill = max(result.engine.mean_batch_fill, 1.0)
    k_top = max(rc.k for rc in pspec.resolved_classes())
    predicted = server.verify_latency(target_params, int(round(fill)), k_top + 1)
    return FleetCalibration(
        classes=tuple(classes),
        # the scale folds the gap between the roofline's paper-scale server
        # model and this deployment's measured verify spans, so simulator
        # latencies land in the same clock the validation runs measure
        server_latency_scale=verify_mean / max(predicted, 1e-9),
        verify_s_mean=verify_mean,
        queue_s_mean=sum(queue) / max(len(queue), 1),
        round_latency_mean=sum(lat) / max(len(lat), 1),
        round_latency_p95=(
            sorted(lat)[max(int(0.95 * len(lat)) - 1, 0)] if lat else 0.0
        ),
        mean_batch_fill=fill,
        wstgr=result.engine.wstgr,
    )


def probe_draft_config(
    spec: ServeSpec,
    *,
    k: int,
    c_th: float,
    draft_layers: Optional[int],
    draft_noise: float,
    devices: int = 2,
    max_new: int = 12,
    cache: Optional[Dict[tuple, Tuple[float, float]]] = None,
    device="cuda",
) -> Tuple[float, float]:
    """Measured ``(acceptance, mean_draft_len)`` for one draft config.

    A tiny lock-step reference serve — the cheapest honest measurement of
    how a candidate's drafting knobs behave on the actual model pair."""
    key = (k, round(c_th, 4), draft_layers, round(draft_noise, 4), devices, max_new)
    if cache is not None and key in cache:
        return cache[key]
    ref = spec.with_backend(
        "reference",
        fleet=FleetSpec(),
        devices=devices,
        k_max=k,
        c_th=c_th,
        max_new=max_new,
        telemetry=False,
        model=dataclasses.replace(
            spec.model, draft_layers=draft_layers, draft_noise=draft_noise
        ),
    )
    res = System.build(ref, device=device).serve()
    drafted = sum(s.drafted for s in res.sessions)
    accepted = sum(s.accepted for s in res.sessions)
    rounds = sum(s.rounds for s in res.sessions)
    out = (accepted / max(drafted, 1), drafted / max(rounds, 1))
    if cache is not None:
        cache[key] = out
    return out


def make_prober(
    spec: ServeSpec, *, devices: int = 2, max_new: int = 12, device="cuda"
) -> Callable[..., Tuple[float, float]]:
    """A cached probe bound to one base spec — what the sweep hands around."""
    cache: Dict[tuple, Tuple[float, float]] = {}

    def probe(*, k, c_th, draft_layers, draft_noise):
        return probe_draft_config(
            spec, k=k, c_th=c_th, draft_layers=draft_layers,
            draft_noise=draft_noise, devices=devices, max_new=max_new,
            cache=cache, device=device,
        )

    return probe
