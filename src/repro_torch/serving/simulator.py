"""Discrete-event simulator of the SLED service area (paper §IV methodology).

The paper evaluates system-scale behaviour by modelling each edge device as
an independent Poisson source of verification requests whose rate derives
from measured device drafting throughput; we implement exactly that, plus
the full device state machine from §III-A:

  draft (k tokens at device rate) -> send (RTT/2) -> server queue ->
  batched verification (BatchPlanner + server latency model) ->
  reply (RTT/2) -> commit m+1 tokens, roll back, draft again

with the paper's async decoding (devices draft ahead while a request is in
flight; on full acceptance the draft-ahead tokens seed the next round) and
the timeout protocol (fallback release of local drafts after
``verify_timeout``; the device resyncs on the next round).

Three system modes share the loop:
  sled         — the above
  centralized  — devices send one-token generation requests; the server
                 decodes autoregressively in batches (no local drafting)
  all_edge     — devices decode locally, never contact the server

The port's copy of ``repro.serving.simulator``, host-side Python on the
port's own ``core.scheduler``: with the same seed it gives the JAX
package's ``SimResult`` (it draws from Python's ``random`` alike).
"""
from __future__ import annotations

import dataclasses
import heapq
import random
from typing import List, Optional, Tuple

from repro_torch.core.scheduler import BatchPlanner, VerifyRequest
from repro_torch.serving.devices import ServerProfile


@dataclasses.dataclass(frozen=True)
class ClassLoad:
    """One heterogeneous device class in the service area: ``count`` devices
    sharing a drafting rate, spec length, acceptance and (optionally) their
    own network RTT.  ``SimConfig.classes`` holds one per fleet class —
    the calibrated counterpart of a ServeSpec's resolved fleet."""

    count: int = 1
    device_rate: float = 8.0        # draft tokens/s (devices.py profile)
    spec_len: int = 4               # the class's k
    acceptance: float = 0.75        # per-token alpha for this draft config
    rtt_mean: float = -1.0          # seconds; -1 inherits SimConfig.rtt_mean


@dataclasses.dataclass
class SimConfig:
    mode: str = "sled"              # sled | centralized | all_edge
    n_devices: int = 8
    spec_len: int = 4               # K (fixed-length drafting)
    dynamic: bool = False           # dynamic drafting: geometric draft lengths
    c_th_mean_len: float = 4.0      #   mean dynamic draft length at c_th
    acceptance: float = 0.75        # per-token acceptance probability alpha
    device_rate: float = 8.0        # draft tokens/s (devices.py profile)
    draft_model_params: float = 1.2e9
    target_params: float = 11e9
    server_batch: int = 8
    batch_policy: str = "static"    # static | deadline | continuous
    max_wait: float = 0.05
    rtt_mean: float = 0.020         # network round-trip, seconds
    rtt_jitter: float = 0.005
    verify_timeout: float = 0.8     # paper §III-A timeout protocol
    drop_prob: float = 0.0          # network loss -> exercises the timeout
    draft_ahead: int = 4            # async decoding depth
    sim_time: float = 120.0
    seed: int = 0
    bits: int = 16
    cache_tokens: int = 1024        # context depth for kv-read cost
    server_latency_scale: float = 1.0
    # heterogeneous fleet: when non-empty, overrides n_devices / device_rate /
    # spec_len / acceptance with per-class values (devices get contiguous ids
    # class by class, matching ServeSpec.resolved_classes ranges)
    classes: Tuple[ClassLoad, ...] = ()
    # deadline SLO: rounds slower than this (and timeout rounds) count as
    # misses in SimResult.deadline_miss_rate; 0 disables the accounting
    deadline_s: float = 0.0


@dataclasses.dataclass
class SimResult:
    wstgr: float                 # whole-system token generation rate (tok/s)
    per_device_rate: float       # committed tokens/s per device
    server_busy_frac: float
    rounds: int
    timeouts: int
    fallback_tokens: int
    mean_batch_fill: float
    mean_round_latency: float
    server_rounds_per_s: float
    deadline_miss_rate: float = 0.0  # rounds over SimConfig.deadline_s
    # committed tokens/s PER DEVICE by fleet class (SimConfig.classes order);
    # empty for uniform configs — the per-class response-rate surface that
    # capacity admission (tuning/search.py) holds a goodput floor against
    class_device_rates: Tuple[float, ...] = ()

    def as_dict(self):
        return dataclasses.asdict(self)


def _device_cfgs(cfg: SimConfig) -> List[SimConfig]:
    """Per-device views of the config: uniform without classes, else each
    class's overrides applied (the returned list's length IS the fleet
    size — ``n_devices`` is derived, not read, under a fleet)."""
    if not cfg.classes:
        return [cfg] * cfg.n_devices
    out: List[SimConfig] = []
    for cl in cfg.classes:
        dcfg = dataclasses.replace(
            cfg,
            device_rate=cl.device_rate,
            spec_len=cl.spec_len,
            acceptance=cl.acceptance,
            rtt_mean=cl.rtt_mean if cl.rtt_mean >= 0 else cfg.rtt_mean,
            classes=(),
        )
        out.extend([dcfg] * cl.count)
    return out


class _Device:
    def __init__(self, i: int, cfg: SimConfig, rng: random.Random):
        self.i = i
        self.cfg = cfg
        self.rng = rng
        self.committed = 0
        self.inflight: Optional[int] = None  # request id awaiting verdict
        self.sent_at = 0.0
        self.ahead = 0  # draft-ahead tokens banked while waiting
        self.timeouts = 0
        self.fallback = 0
        self.round_latencies: List[float] = []

    def draft_len(self) -> int:
        cfg = self.cfg
        if not cfg.dynamic:
            return cfg.spec_len
        # dynamic drafting: confidence-thresholded lengths are geometric-ish
        p = 1.0 / max(cfg.c_th_mean_len, 1.01)
        k = 1
        while k < cfg.spec_len * 4 and self.rng.random() > p:
            k += 1
        return k


def _accepted(k: int, alpha: float, rng: random.Random) -> int:
    m = 0
    while m < k and rng.random() < alpha:
        m += 1
    return m


def simulate(cfg: SimConfig, server: ServerProfile) -> SimResult:
    rng = random.Random(cfg.seed)
    dcfgs = _device_cfgs(cfg)
    n_devices = len(dcfgs)
    devices = [_Device(i, dcfgs[i], random.Random(cfg.seed * 977 + i)) for i in range(n_devices)]

    if cfg.mode == "all_edge":
        # no server: closed-form — devices decode locally
        total = sum(c.device_rate for c in dcfgs)
        return SimResult(
            wstgr=total, per_device_rate=total / max(n_devices, 1),
            server_busy_frac=0.0, rounds=0, timeouts=0, fallback_tokens=0,
            mean_batch_fill=0.0,
            mean_round_latency=1.0 / max(total / max(n_devices, 1), 1e-9),
            server_rounds_per_s=0.0,
        )

    # static batching can only ever fill up to n_devices (closed loop): cap
    # so an oversized fixed batch doesn't deadlock waiting for itself
    eff_batch = min(cfg.server_batch, n_devices)
    k_top = max(c.spec_len for c in dcfgs)
    planner = BatchPlanner(
        batch_size=eff_batch, k_max=k_top * 4,
        policy=cfg.batch_policy, max_wait=cfg.max_wait,
        straggler_timeout=cfg.verify_timeout,
    )
    # event heap: (time, seq, kind, payload)
    evq: List = []
    seq = 0

    def push(t: float, kind: str, payload) -> None:
        nonlocal seq
        heapq.heappush(evq, (t, seq, kind, payload))
        seq += 1

    def rtt_half(c: SimConfig = cfg) -> float:
        return max(0.001, c.rtt_mean / 2 + rng.gauss(0.0, cfg.rtt_jitter / 2))

    # verify width is padded to the widest class's k (matching the engine's
    # k_max-padded batches), so server cost is set by the fleet's max k
    k1 = k_top + 1
    verify_lat = lambda b: cfg.server_latency_scale * server.verify_latency(
        cfg.target_params, b, k1, cache_tokens=cfg.cache_tokens, bits=cfg.bits
    )
    decode_lat = lambda b: cfg.server_latency_scale * server.decode_latency(
        cfg.target_params, b, cache_tokens=cfg.cache_tokens, bits=cfg.bits
    )

    server_busy_until = 0.0
    server_busy_time = 0.0
    server_rounds = 0
    batch_fills: List[int] = []
    rounds = 0
    reqid = 0
    next_tick_at = float("inf")  # throttle: at most one pending planner tick

    # warm start: every device begins a drafting round at a random phase
    for d in devices:
        if cfg.mode == "sled":
            k = d.draft_len()
            push(rng.random() * 0.05 + k / d.cfg.device_rate, "draft_done", (d.i, k))
        else:  # centralized: device immediately requests its next token
            push(rng.random() * 0.01, "request", (d.i, 1))

    def maybe_dispatch(now: float) -> None:
        nonlocal server_busy_until, server_busy_time, server_rounds
        if now < server_busy_until:
            return
        batch = planner.next_batch(now, server_idle=True)
        if batch is None:
            return
        b = batch.size
        lat = verify_lat(b) if cfg.mode == "sled" else decode_lat(b)
        server_busy_until = now + lat
        server_busy_time += lat
        server_rounds += 1
        batch_fills.append(b)
        push(now + lat, "batch_done", batch)

    T = cfg.sim_time
    now = 0.0
    while evq:
        now, _, kind, payload = heapq.heappop(evq)
        if now > T:
            break
        if kind == "draft_done":
            i, k = payload
            d = devices[i]
            if d.inflight is not None:
                continue  # stale event from a superseded round
            if rng.random() < cfg.drop_prob:
                # request lost: timeout will fire
                d.inflight = reqid
                d.sent_at = now
                push(now + cfg.verify_timeout, "timeout", (i, reqid, k))
            else:
                req = VerifyRequest(device_id=i, arrival=now + rtt_half(d.cfg),
                                    prev_token=0, draft_tokens=[0] * k,
                                    request_id=reqid)
                d.inflight = reqid
                d.sent_at = now
                push(req.arrival, "arrive", req)
                push(now + cfg.verify_timeout, "timeout", (i, reqid, k))
            reqid += 1
        elif kind == "request":  # centralized mode
            i, _ = payload
            req = VerifyRequest(device_id=i, arrival=now + rtt_half(devices[i].cfg),
                                prev_token=0, draft_tokens=[0], request_id=reqid)
            devices[i].inflight = reqid
            devices[i].sent_at = now
            push(req.arrival, "arrive", req)
            reqid += 1
        elif kind == "arrive":
            planner.add(payload)
            maybe_dispatch(now)
        elif kind == "batch_done":
            for req in payload.requests:
                d = devices[req.device_id]
                if d.inflight != req.request_id:
                    continue  # superseded by a timeout fallback
                d.inflight = None
                d.round_latencies.append(now - d.sent_at)
                if cfg.mode == "sled":
                    k = len(req.draft_tokens)
                    m = _accepted(k, d.cfg.acceptance, d.rng)
                    d.committed += m + 1
                    # §III-A async decoding: the device kept drafting during
                    # the round trip; on full acceptance those tokens seed
                    # the next round (on rejection they are discarded)
                    wait = max(now - d.sent_at, 0.0)
                    carry = 0
                    if m == k:
                        carry = min(int(wait * d.cfg.device_rate), cfg.draft_ahead)
                    nk = d.draft_len()
                    need = max(nk - carry, 0)
                    push(now + rtt_half(d.cfg) + need / d.cfg.device_rate,
                         "draft_done", (req.device_id, nk))
                else:
                    d.committed += 1
                    push(now + rtt_half(d.cfg), "request", (req.device_id, 1))
            maybe_dispatch(now)
        elif kind == "timeout":
            i, rid, k = payload
            d = devices[i]
            if d.inflight == rid:
                # paper §III-A: release local drafts, resync next round
                d.inflight = None
                d.timeouts += 1
                d.fallback += k
                d.committed += k
                nk = d.draft_len()
                push(now + nk / d.cfg.device_rate, "draft_done", (i, nk))
        if kind == "tick":
            next_tick_at = float("inf")
            maybe_dispatch(now)
        # deadline-policy batches may become ready without a new arrival;
        # keep at most ONE pending tick (unthrottled ticks are O(events^2))
        hint = planner.next_event_hint(now)
        if hint is not None and hint <= T and hint + 1e-6 < next_tick_at:
            next_tick_at = hint + 1e-6
            push(next_tick_at, "tick", None)

    total = sum(d.committed for d in devices)
    lat = [x for d in devices for x in d.round_latencies]
    timeouts = sum(d.timeouts for d in devices)
    miss_rate = 0.0
    if cfg.deadline_s > 0:
        # timeout rounds never produced a verdict in time: always misses
        misses = sum(1 for x in lat if x > cfg.deadline_s) + timeouts
        miss_rate = misses / max(len(lat) + timeouts, 1)
    class_rates: List[float] = []
    if cfg.classes and now > 0:
        # devices hold contiguous ids class by class (same layout as
        # ServeSpec.resolved_classes), so slice by the class counts
        lo = 0
        for cl in cfg.classes:
            rows = devices[lo:lo + cl.count]
            class_rates.append(
                sum(d.committed for d in rows) / max(cl.count, 1) / now
            )
            lo += cl.count
    return SimResult(
        wstgr=total / now if now > 0 else 0.0,
        per_device_rate=total / max(n_devices, 1) / now if now > 0 else 0.0,
        server_busy_frac=server_busy_time / now if now > 0 else 0.0,
        rounds=sum(len(d.round_latencies) for d in devices),
        timeouts=timeouts,
        fallback_tokens=sum(d.fallback for d in devices),
        mean_batch_fill=sum(batch_fills) / max(len(batch_fills), 1),
        mean_round_latency=sum(lat) / max(len(lat), 1),
        server_rounds_per_s=server_rounds / now if now > 0 else 0.0,
        deadline_miss_rate=miss_rate,
        class_device_rates=tuple(class_rates),
    )


def capacity(cfg: SimConfig, server: ServerProfile, *, min_rate_frac: float = 0.8,
             n_max: int = 512, probe_time: float = 8.0) -> int:
    """Max devices sustaining >= min_rate_frac of their solo token rate
    (Table I's 'system capacity' at an equal response-rate requirement)."""
    if cfg.classes:
        # n_devices is derived under a fleet, so the n-sweep below would
        # silently probe the same load at every n — refuse loudly
        raise ValueError(
            "capacity() sweeps n_devices, which a fleet config overrides; "
            "scale ClassLoad.count per class (tuning/search.py does) instead"
        )
    cfg = dataclasses.replace(cfg, sim_time=min(cfg.sim_time, probe_time))
    solo = simulate(dataclasses.replace(cfg, n_devices=1), server).per_device_rate
    if solo <= 0:
        return 0

    def ok(n: int) -> bool:
        r = simulate(dataclasses.replace(cfg, n_devices=n), server)
        return r.per_device_rate >= min_rate_frac * solo

    if ok(n_max):  # saturates the probe range: skip the search
        return n_max
    lo, hi = 1, n_max
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo
