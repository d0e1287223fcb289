"""The port's supervision and fault injection, held to the JAX package.

Mirrors of tests/test_faults.py: the seeded Backoff, the FaultyChannel's
drop, delay and kill over the whole wire path but the socket (a fake
channel through the port's WorkerCore), the worker's replay cache, a
retried RPC absorbing a flap, the ChaosInjector's schedule and its refusal
of an unwrapped channel, the heartbeat monitor marking a silent replica
suspect (``sweep()``, no sleeps) and the Router evicting it, a seeded kill
with and without recovery, recovery without respawn shedding what is over
capacity, spec-driven chaos through ``System.build``, every replica
evicted being fatal, the FaultSpec's JSON, and two spawned CPU workers
with a SIGKILL and a respawn.

Where both packages run a case, the port runs on weights bridged from the
JAX package (tests/test_torch_serve.py) with the same prompts, and must
commit the JAX package's tokens (up to a printed near tie) with the same
``lost_devices`` and supervision counters. The file also holds the repair
of the port's serve that waited for ever after an eviction (a shed session
ends, ``shed=True``), the transport serve that fails instead, and the
eviction's flight-recorder dump. Every serve runs on a watchdog thread
with a bound, so a hang fails the test.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.api import ClusterSpec as JClusterSpec
from repro.api import FaultPolicy as JFaultPolicy
from repro.api import FaultSpec as JFaultSpec
from repro.api import System as JSystem
from repro.cluster import Backoff as JBackoff
from repro.cluster import ChaosInjector as JChaosInjector
from repro.cluster import Router as JRouter
from repro.core.server_engine import ServerEngine as JServerEngine
from repro.transport.worker import WorkerCore as JWorkerCore
from repro_torch.api import ServeSpec, System, build_models
from repro_torch.api.spec import ClusterSpec, FaultPolicy, FaultSpec
from repro_torch.cluster import (
    Backoff,
    ChaosInjector,
    FaultyChannel,
    RemoteReplica,
    ReplicaGone,
    Router,
    WorkerError,
)
from repro_torch.cluster.remote import worker_sock_dir
from repro_torch.cluster.router import _HeartbeatMonitor
from repro_torch.transport import codec
from repro_torch.transport.worker import WorkerCore
from test_faults import FakeChannel as JFakeChannel
from test_faults import _fake_remote as _jax_fake_remote
from test_faults import _spec as _jspec
from test_torch_remote import _alive, _bounded
from test_torch_serve import _assert_same_tokens, _port_bundle, jax_build_models
from test_torch_worker import _engines, _spec

V = 64
SERVE_BOUND_S = 60.0
RECOVER = dict(respawn=True, recover_streams=True, backoff_base_s=0.01, backoff_max_s=0.05)
PROMPTS = np.random.default_rng(7).integers(0, V, size=(4, 6)).astype(np.int32)


def _kill(round_no: int = 5, replica: int = 1) -> dict:
    return {"kind": "kill", "replica": replica, "round": round_no}


class FakeChannel:
    """A ControlChannel in process (the mirror of tests/test_faults.py's):
    each request is encoded, handled by the WorkerCore and its reply
    encoded and decoded again; ``killed`` fails every RPC as a dead peer."""

    def __init__(self, core: WorkerCore):
        self.core = core
        self.address = "fake:0"
        self.killed = False
        self.connected = True
        self._seq = 0

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def request(self, msg, *, timeout=None):
        if self.killed:
            raise ReplicaGone("worker killed (fake)")
        wire, _ = codec.decode_frame(codec.encode_frame(msg))
        reply, _ = codec.decode_frame(codec.encode_frame(self.core.handle(wire)))
        if isinstance(reply, codec.ErrorReply):
            raise WorkerError(reply.message)
        return reply

    def kill(self):
        self.killed = True

    def close(self):
        pass

    def connect(self):
        if self.killed:
            raise ReplicaGone("worker dead (fake)")

    reconnect = connect


@pytest.fixture(scope="module")
def jax_models():
    return jax_build_models(_jspec().model)


@pytest.fixture(scope="module")
def bundle(jax_models):
    return _port_bundle(jax_models)


@pytest.fixture(scope="module")
def jax_inproc(jax_models):
    """The JAX package's fault-free in-process cluster serve of PROMPTS;
    its compiled steps are shared by every JAX engine of this module."""
    system = JSystem.build(_jspec(), models=jax_models)
    return system, system.serve(PROMPTS).outputs


@pytest.fixture(scope="module")
def want(bundle):
    """The port's fault-free in-process cluster serve of PROMPTS."""
    return System.build(_spec(), models=bundle, device="cpu").serve(PROMPTS).outputs


def _fake_remote(engine) -> RemoteReplica:
    """A RemoteReplica around a prebuilt engine, shaped as a PlaceAck would."""
    remote = RemoteReplica(FakeChannel(WorkerCore(engine)))
    remote.adopt(n_slots=engine.pool.n_slots, k_max=engine.k_max, max_len=engine.pool.max_len,
                 greedy=engine.greedy, paged_attention=engine.paged_attention)
    return remote


def _fake_fleet(spec, bundle, n: int = 2):
    """Remote replicas over fake channels around port engines on the bridged
    weights; revive() gets a fresh fake worker from ``channel_factory`` (an
    in-process respawn), the shape adopted at the start kept."""
    def fresh():
        return FakeChannel(WorkerCore(_engines(spec, 1, bundle)[0]))

    remotes = []
    for _ in range(n):
        r = _fake_remote(_engines(spec, 1, bundle)[0])
        r.channel_factory = fresh
        remotes.append(r)
    return remotes


def _kit(spec, bundle):
    return System.build(spec.with_backend("reference"), models=bundle, device="cpu").kit


def _counters(router) -> dict:
    return {k: getattr(router, k) for k in ("evictions", "respawns", "recovered_streams",
                                            "shed_streams")}


def _same(got, want, jax_models) -> None:
    _assert_same_tokens([got[i] for i in range(len(want))], [want[i] for i in range(len(want))],
                        jax_models, PROMPTS)


# ---------------------------------------------------------------------------
# primitives: Backoff, FaultyChannel, replay cache, retry, injector, heartbeat
# ---------------------------------------------------------------------------


def test_backoff_deterministic_and_capped():
    a = Backoff(base_s=0.1, max_s=1.0, jitter=0.2, seed=7)
    b = JBackoff(base_s=0.1, max_s=1.0, jitter=0.2, seed=7)
    seq = [a.attempt() for _ in range(8)]
    assert seq == [b.attempt() for _ in range(8)], "the JAX package's delays, seed for seed"
    assert all(d <= 1.0 * 1.2 + 1e-9 for d in seq)
    assert 0.08 <= seq[0] <= 0.12
    a.reset()
    assert a.attempts == 0
    with pytest.raises(ValueError):
        Backoff(base_s=0.0)


def test_faulty_channel_drop_delay_kill():
    chan = FaultyChannel(FakeChannel(WorkerCore(_engines(_spec(), 1)[0])))
    prompt = np.arange(6, dtype=np.int32)
    ok = chan.request(codec.AdmitRequest(device_id=0, prompt=prompt, now=0.0, seq=1))
    assert isinstance(ok, codec.AdmitReply) and ok.ok  # transparent until armed
    chan.arm_drop(2)
    for _ in range(2):
        with pytest.raises(ReplicaGone, match="chaos"):
            chan.request(codec.StepRequest(now=0.0, seq=chan.next_seq()))
    assert chan.dropped == 2 and chan.drop_n == 0
    chan.request(codec.StepRequest(now=0.0, seq=chan.next_seq()))  # healed
    chan.arm_delay(1, 0.01)
    chan.request(codec.StepRequest(now=0.0, seq=chan.next_seq()))
    assert chan.delayed == 1
    chan.kill()
    with pytest.raises(ReplicaGone):
        chan.request(codec.StepRequest(now=0.0, seq=chan.next_seq()))
    with pytest.raises(ReplicaGone):
        chan.reconnect()


def test_worker_replay_cache_dedups_resent_frames():
    """A resent (frame, device, seq) returns the original reply without
    applying it again, so a one-shot retry is safe."""
    core = WorkerCore(_engines(_spec(), 1)[0])
    prompt = np.arange(6, dtype=np.int32)
    first = core.handle(codec.AdmitRequest(device_id=0, prompt=prompt, now=0.0, seq=1))
    again = core.handle(codec.AdmitRequest(device_id=0, prompt=prompt, now=0.0, seq=1))
    assert core.replay_hits == 1
    assert again.slot == first.slot and len(core.engine.streams) == 1
    toks = np.asarray([1, 2, 3], np.int32)
    core.handle(codec.SubmitRequest(device_id=0, tokens=toks, now=0.1, seq=2))
    core.handle(codec.SubmitRequest(device_id=0, tokens=toks, now=0.1, seq=2))
    assert core.replay_hits == 2
    step = core.handle(codec.StepRequest(now=0.2, seq=3))
    assert len(step.verdicts) == 1, "the duplicate submit must not queue a round"
    assert core._replay_key(codec.StepRequest(now=0.0)) is None  # seq 0: never cached
    pong = core.handle(codec.Ping(seq=9, t=1.5))
    assert isinstance(pong, codec.Pong) and pong.seq == 9 and pong.t == 1.5


def test_retry_rpcs_absorbs_link_flap():
    remote = _fake_remote(_engines(_spec(), 1)[0])
    remote.channel = FaultyChannel(remote.channel)
    remote.retry_rpcs = True
    router = Router([remote])
    assert router.admit(0, np.arange(6, dtype=np.int32), 0.0) is not None
    remote.channel.flap()
    router.submit(0, np.asarray([1, 2, 3], np.int32), 0.1)  # survives the flap
    assert remote.retries == 1 and remote.channel.dropped == 1
    assert router.evictions == 0 and not remote.dead
    verdicts = router.step(0.2)
    assert verdicts is not None and verdicts[0].device_id == 0


def test_chaos_injector_fires_on_schedule():
    router = Router([_fake_remote(e) for e in _engines(_spec(), 2)])
    spec = FaultSpec(events=(_kill(3), {"kind": "flap", "replica": 0, "round": 2}))
    router.replicas[0].channel = FaultyChannel(router.replicas[0].channel)
    inj = ChaosInjector(spec, router)
    inj.on_step(1)
    assert not inj.fired and not inj.done
    inj.on_step(2)
    assert inj.fired == [(2, "flap", 0)]
    assert router.replicas[0].channel.drop_n == 1
    inj.on_step(5)  # a past-due event still fires, once
    assert inj.fired[-1] == (5, "kill", 1) and inj.done
    assert router.replicas[1].channel.killed
    inj.on_step(9)
    assert len(inj.fired) == 2


def test_chaos_injector_refuses_unwrapped_channel():
    router = Router([_fake_remote(_engines(_spec(), 1)[0])])
    inj = ChaosInjector(FaultSpec(events=({"kind": "drop", "replica": 0, "round": 1},)), router)
    with pytest.raises(RuntimeError, match="not a FaultyChannel"):
        inj.on_step(1)


def test_heartbeat_monitor_marks_suspect_then_router_evicts():
    class Silent:
        dead = False
        suspect = False

        def ping(self, *, timeout):
            return False

    class Fleet:
        replicas = [Silent()]

    mon = _HeartbeatMonitor(Fleet(), FaultPolicy(heartbeat_interval_s=0.05, heartbeat_misses=3))
    mon.sweep()
    mon.sweep()
    assert not Fleet.replicas[0].suspect
    mon.sweep()
    assert Fleet.replicas[0].suspect, "3 misses in a row make a suspect"
    router = Router([_fake_remote(e) for e in _engines(_spec(), 2)])
    router.replicas[1].suspect = True
    router.step(0.0)
    assert router.replicas[1].dead and router.evictions == 1
    assert not router.replicas[0].dead


# ---------------------------------------------------------------------------
# a seeded kill mid-serve, with and without recovery, against the JAX package
# ---------------------------------------------------------------------------


def _jax_serve(jax_models, jax_inproc, policy=None, schedule=_kill()):
    """The JAX package's case: remote replicas over its fake channels around
    its engines (revived through ``channel_factory``, as the port's), its
    Router under ``policy``, the kill schedule; the result and the Router."""
    spec, inproc = _jspec(), jax_inproc[0]

    def engine():
        return JServerEngine(jax_models.target, jax_models.target_params, n_slots=2,
                             max_len=spec.max_len, k_max=spec.k_max, greedy=True,
                             steps=inproc.steps)

    remotes = [_jax_fake_remote(engine()) for _ in range(2)]
    for r in remotes:
        r.channel_factory = lambda: JFakeChannel(JWorkerCore(engine()))
    router = JRouter(remotes, placement=spec.cluster.placement,
                     faults=JFaultPolicy(**policy) if policy else None)
    router.chaos = JChaosInjector(JFaultSpec(events=(schedule,)), router)
    return JSystem(spec, jax_models, router, inproc.kit).serve(PROMPTS), router


def _port_serve(bundle, policy=None, schedule=_kill(), prepare=None):
    spec = _spec()
    router = Router(_fake_fleet(spec, bundle), placement=spec.cluster.placement,
                    faults=FaultPolicy(**policy) if policy else None)
    router.chaos = ChaosInjector(FaultSpec(events=(schedule,)), router)
    if prepare is not None:
        prepare(router)
    system = System(spec, bundle, router, _kit(spec, bundle), torch.device("cpu"))
    return _bounded(lambda: system.serve(PROMPTS), SERVE_BOUND_S), router


def test_kill_with_recovery_is_token_identical(bundle, jax_models, jax_inproc, want):
    """Kill 1 of 2 workers mid-serve with respawn and device replay: every
    session completes with the fault-free tokens, nothing shed, and the
    JAX package's tokens and counters."""
    res, router = _port_serve(bundle, RECOVER)
    jres, jrouter = _jax_serve(jax_models, jax_inproc, RECOVER)
    assert jres.outputs == jax_inproc[1]
    assert router.chaos.done and router.evictions == 1 and router.respawns == 1
    assert router.shed_streams == 0 and res.lost_devices == [] and router.recovered_streams >= 1
    assert not any(s.shed for s in res.sessions)
    assert res.outputs == want, "recovery diverged from the fault-free run"
    _same(res.outputs, jres.outputs, jax_models)
    assert _counters(router) == _counters(jrouter)
    assert res.lost_devices == jres.lost_devices


def test_kill_without_recovery_sheds_lost_streams(bundle, jax_models, jax_inproc, want):
    """The same schedule under the default policy: the dead replica's
    streams are shed (their sessions end with the committed prefix), the
    survivors complete; the JAX package sheds the same devices."""
    res, router = _port_serve(bundle)
    jres, jrouter = _jax_serve(jax_models, jax_inproc)
    assert router.evictions == 1 and router.respawns == 0
    lost = sorted(res.lost_devices)
    assert lost and lost == sorted(router.lost_devices) == sorted(jres.lost_devices)
    by_dev = {s.device_id: s for s in res.sessions}
    for dev, s in by_dev.items():
        if dev in lost:
            assert s.shed and len(s.tokens) < len(want[dev])
            assert want[dev][:len(s.tokens)] == s.tokens, "a shed prefix must match"
        else:
            assert not s.shed and s.tokens == want[dev]
    _same(res.outputs, jres.outputs, jax_models)
    assert _counters(router) == _counters(jrouter)


def test_recovery_without_respawn_sheds_over_capacity(bundle):
    """recover_streams alone: orphans fit only the survivor's free slots;
    with both pools full at the kill, both of the dead replica's streams
    are shed (the JAX package's [1, 3])."""
    spec = _spec()
    router = Router(_fake_fleet(spec, bundle), placement=spec.cluster.placement,
                    faults=FaultPolicy(recover_streams=True))
    for dev in range(4):
        assert router.admit(dev, PROMPTS[dev], 0.0) is not None
    router.replicas[1].chaos_kill()
    for dev in range(4):
        if dev in router.streams:
            try:
                router.submit(dev, np.asarray([1, 2, 3], np.int32), 0.1)
            except ConnectionError:
                pass
    router.step(0.2)
    assert router.evictions == 1
    assert router.recovered_streams == 0 and router.shed_streams == 2
    assert sorted(router.lost_devices) == [1, 3]


def test_eviction_dumps_the_replicas_flight_ring(bundle):
    """The Router's ring of the evicted replica, dumped at its eviction,
    holds the last rounds that replica verified (as its own step returned
    them), in order, tagged with the replica."""
    seen = []

    def log_replica_1(router):
        step = router.replicas[1].step

        def logged(now):
            out = step(now)
            seen.extend((v.device_id, v.n_accepted, len(v.tokens)) for v in out or ())
            return out

        router.replicas[1].step = logged

    _, router = _port_serve(bundle, prepare=log_replica_1)
    dump = router.flight_dumps[1]
    assert seen and router.evictions == 1
    assert all(ev["replica"] == 1 for ev in dump)
    assert [(ev["device_id"], ev["n_accepted"], ev["n_commit"]) for ev in dump] == seen[-64:]
    assert [ev.to_json() for ev in router.flight[1].events()] == dump


# ---------------------------------------------------------------------------
# the serve that spun for ever after an eviction
# ---------------------------------------------------------------------------


def _dies_on_third_step(replica) -> None:
    """Replica ``replica``'s engine step raises ConnectionError from its
    third call on (a worker lost mid-serve)."""
    engine = replica.engine
    step, calls = engine.step, []

    def failing(now):
        calls.append(now)
        if len(calls) >= 3:
            raise ConnectionError("replica lost (probe)")
        return step(now)

    engine.step = failing


def test_an_eviction_under_the_default_policy_ends_the_lost_sessions(bundle, jax_models,
                                                                      jax_inproc):
    """2 in-process replicas, replica 1's step raising from its third call:
    the serve returns (it used to wait for ever), the lost sessions end
    ``shed=True`` with what they had committed, and ``lost_devices`` is
    the JAX package's."""
    jsystem = JSystem.build(_jspec(), models=jax_models, steps=jax_inproc[0].steps)
    _dies_on_third_step(jsystem.engine.replicas[1])
    jres = jsystem.serve(PROMPTS)
    system = System.build(_spec(), models=bundle, device="cpu")
    _dies_on_third_step(system.engine.replicas[1])
    res = _bounded(lambda: system.serve(PROMPTS), SERVE_BOUND_S)
    assert res.lost_devices == jres.lost_devices == [1, 3]
    assert {s.device_id for s in res.sessions if s.shed} == {1, 3}
    assert [s.tokens for s in res.sessions] == [s.tokens for s in jres.sessions]
    assert res.to_json()["sessions"][1]["shed"] is True


def test_a_shed_stream_fails_the_transport_serve(bundle):
    """On the transport backend a shed stream's client would wait out its
    retries: the serve fails instead (a departure from the JAX package)."""
    spec = dataclasses.replace(_spec(), backend="transport",
                               faults=FaultSpec(events=(_kill(3),)))
    system = System.build(spec, models=bundle, device="cpu")
    assert isinstance(system.engine, Router) and system.engine.chaos is not None
    with pytest.raises(RuntimeError, match="shed"):
        _bounded(lambda: system.serve(PROMPTS), SERVE_BOUND_S)


# ---------------------------------------------------------------------------
# spec-driven chaos through System.build (in-process replicas)
# ---------------------------------------------------------------------------


def _chaos_pair(jax_models, jax_inproc, bundle, **faults):
    """The same chaos spec served by both packages (in-process replicas)."""
    jspec = dataclasses.replace(_jspec(), faults=JFaultSpec(events=(_kill(),)), **{
        k: JClusterSpec(replicas=2, faults=v) for k, v in faults.items()})
    spec = dataclasses.replace(_spec(), faults=FaultSpec(events=(_kill(),)), **{
        k: ClusterSpec(replicas=2, faults=v) for k, v in faults.items()})
    jsystem = JSystem.build(jspec, models=jax_models, steps=jax_inproc[0].steps)
    jres = jsystem.serve(PROMPTS)
    system = System.build(spec, models=bundle, device="cpu")
    assert system.engine.chaos is not None, "a FaultSpec must attach the injector"
    res = _bounded(lambda: system.serve(PROMPTS), SERVE_BOUND_S)
    assert _counters(system.engine) == _counters(jsystem.engine)
    assert res.lost_devices == jres.lost_devices
    _same(res.outputs, jres.outputs, jax_models)
    return spec, system, res


def test_spec_driven_local_chaos_recovers_token_identical(bundle, jax_models, jax_inproc, want):
    _, system, res = _chaos_pair(jax_models, jax_inproc, bundle, cluster=RECOVER)
    assert system.engine.evictions == 1 and system.engine.respawns == 1
    assert res.lost_devices == [] and not any(s.shed for s in res.sessions)
    assert res.outputs == want


def test_spec_driven_chaos_without_recovery_surfaces_lost_devices(bundle, jax_models,
                                                                   jax_inproc):
    _, system, res = _chaos_pair(jax_models, jax_inproc, bundle)
    assert system.engine.evictions == 1
    assert res.lost_devices, "the ServeResult must list the shed devices"
    assert {s.device_id for s in res.sessions if s.shed} == set(res.lost_devices)
    assert "lost_devices" in res.to_json()


def test_sampled_recovery_completes_with_nothing_shed(bundle):
    """greedy=False under the same kill: recovery submits the stored q
    again, but the revived replica draws from its own generator, so the
    tokens are not the fault-free run's; the serve completes every session
    with its budget and sheds nothing."""
    spec = dataclasses.replace(_spec(), greedy=False, faults=FaultSpec(events=(_kill(),)),
                               cluster=ClusterSpec(replicas=2, faults=RECOVER))
    system = System.build(spec, models=bundle, device="cpu")
    res = _bounded(lambda: system.serve(PROMPTS), SERVE_BOUND_S)
    router = system.engine
    assert (router.evictions, router.respawns, router.shed_streams) == (1, 1, 0)
    assert router.recovered_streams >= 1 and res.lost_devices == []
    assert all(len(s.tokens) == spec.max_new and not s.shed for s in res.sessions)
    assert all(0 <= t < V for s in res.sessions for t in s.tokens)


def test_all_replicas_evicted_is_fatal_through_serve(bundle):
    spec = dataclasses.replace(_spec(), cluster=ClusterSpec(replicas=1), devices=2,
                               faults=FaultSpec(events=(_kill(3, replica=0),)))
    system = System.build(spec, models=bundle, device="cpu")
    with pytest.raises(RuntimeError, match="all 1 replicas evicted"):
        _bounded(lambda: system.serve(PROMPTS[:2]), SERVE_BOUND_S)


def test_fault_spec_json_round_trip():
    """The port's spec round-trips, and its JSON is the JAX package's."""
    faults = FaultSpec(seed=3, events=(
        _kill(4), {"kind": "delay", "replica": 0, "round": 2, "count": 3, "delay_s": 0.5}))
    spec = dataclasses.replace(_spec(), faults=faults, cluster=ClusterSpec(
        replicas=2, faults={"respawn": True, "max_respawns": 5}))
    assert spec.cluster.faults.respawn and spec.cluster.faults.max_respawns == 5
    assert spec.faults.active and spec.faults.events[0].kind == "kill"
    assert ServeSpec.from_json(spec.to_json_str()) == spec
    jspec = dataclasses.replace(_jspec(), faults=JFaultSpec(**dataclasses.asdict(faults)),
                                cluster=JClusterSpec(replicas=2, faults={
                                    "respawn": True, "max_respawns": 5}))
    assert spec.to_json() == jspec.to_json()


# ---------------------------------------------------------------------------
# real worker processes on the CPU: SIGKILL and respawn
# ---------------------------------------------------------------------------


def test_spawned_worker_sigkill_respawn_recovers():
    """Two ``python -m repro_torch.transport.worker --device cpu`` processes;
    replica 1 is SIGKILLed at step 5, respawned on the CPU with its first
    spawn's arguments, and its streams rebuilt by device replay: the serve
    equals the in-process fault-free serve (the workers rebuild the port's
    seeded weights), nothing shed, and close() leaves no process and no
    socket directory."""
    spec = _spec()
    want = System.build(spec, models=build_models(spec.model, device="cpu"),
                        device="cpu").serve(PROMPTS).outputs
    chaos = dataclasses.replace(
        spec, cluster=ClusterSpec(replicas=[{"flavor": "remote"}] * 2, faults=dict(
            RECOVER, backoff_base_s=0.05, backoff_max_s=0.5)),
        faults=FaultSpec(events=(_kill(),)))
    system = _bounded(lambda: System.build(chaos, device="cpu"))
    procs, dirs = [], []
    try:
        replicas = system.engine.replicas
        first = replicas[1].proc
        res = _bounded(lambda: system.serve(PROMPTS))
        router = system.engine
        procs = [first] + [r.proc for r in replicas]
        dirs = [worker_sock_dir(r.address) for r in replicas]
        assert router.evictions == 1 and router.respawns == 1 and router.shed_streams == 0
        assert replicas[1].proc is not first and first.poll() is not None
        assert replicas[1].spawn_kw == {"device": torch.device("cpu")}
    finally:
        system.close()
    assert res.lost_devices == [] and res.outputs == want
    for proc in procs:
        assert proc.poll() is not None and not _alive(proc.pid)
    assert not any(d is not None and os.path.exists(d) for d in dirs)
