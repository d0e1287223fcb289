"""The port's control plane and remote replicas, held to the JAX package.

Codec: every control frame (types 8-34) encodes to the JAX codec's bytes
for the same field values and each side decodes the other's frames; a
StreamState row with bf16, int8 and f32 leaves survives bit for bit (the
JAX side writes ``ml_dtypes.bfloat16``, the port its uint16 words); a
truncated or corrupt frame raises CodecError. WorkerCore: a double place,
an RPC before placement and a resent seq (the cached reply, the engine not
advanced), and ``build_engine_from_spec`` forcing the engine backend.
Router: a FakeChannel sends every request and reply through encode and
decode (the whole wire path but the socket); two RemoteReplicas over it,
wrapping port engines on weights bridged from the JAX package, commit the
JAX package's in-process cluster serve up to a printed near tie;
remote-to-remote migration copies the row bit for bit on the bf16 pool,
the int8 pool (its scales) and the mamba2 state; a mixed-flavour move is
refused; a WorkerError does not evict, a dead channel does, the survivors
keep serving and a fleet with no replica left raises; the cluster's
telemetry record reads each worker's pool gauges from its ReplicaStats
payload. Mirrors of tests/test_worker.py.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.api import ClusterSpec as JClusterSpec
from repro.api import ModelSpec as JModelSpec
from repro.api import SchedulerSpec as JSchedulerSpec
from repro.api import ServeSpec as JServeSpec
from repro.api import System as JSystem
from repro.transport import codec as jcodec
from repro_torch import telemetry
from repro_torch.api import ServeSpec, System, build_models
from repro_torch.api.spec import ClusterSpec, ModelSpec, SchedulerSpec
from repro_torch.cluster import MigrationError, RemoteReplica, ReplicaGone, Router, WorkerError
from repro_torch.core.server_engine import ServerEngine
from repro_torch.transport import codec
from repro_torch.transport.worker import WorkerCore, build_engine_from_spec
from test_torch_cluster import _family_spec, _raw_row
from test_torch_serve import _assert_same_tokens, _port_bundle, jax_build_models

V = 64
BF16 = (np.arange(24, dtype=np.float32).reshape(2, 3, 4) / 7).astype(ml_dtypes.bfloat16)


def _spec_kw():
    return dict(devices=4, prompt_len=6, max_new=6, k_max=3, c_th=0.3)


def _spec(**kw) -> ServeSpec:
    base = dict(backend="cluster",
                model=ModelSpec(vocab_size=V, target_layers=2, draft_layers=1, draft_noise=0.03),
                cluster=ClusterSpec(replicas=2), scheduler=SchedulerSpec(slots=2, stagger_ticks=1),
                **_spec_kw())
    base.update(kw)
    return ServeSpec(**base)


def _jspec() -> JServeSpec:
    return JServeSpec(backend="cluster",
                      model=JModelSpec(vocab_size=V, target_layers=2, draft_layers=1,
                                       draft_noise=0.03),
                      cluster=JClusterSpec(replicas=2),
                      scheduler=JSchedulerSpec(slots=2, stagger_ticks=1), **_spec_kw())


# ---------------------------------------------------------------------------
# the codec's control frames against the JAX codec's
# ---------------------------------------------------------------------------


def _row(mod):
    bf = BF16 if mod is jcodec else codec.BF16Words(BF16.view(np.uint16))
    return {"layer0/k": bf,
            "layer0/v": np.linspace(-2, 2, 24, dtype=np.float32).reshape(2, 3, 4),
            "k_scale": np.asarray([[0.5, 0.25]], np.float32),
            "q": np.arange(-6, 6, dtype=np.int8).reshape(2, 6),
            "length": np.asarray([7], np.int32)}


def _state(mod):
    return mod.StreamState(device_id=3, slot=1, prev_token=42, committed=(5, 9, 1),
                           admitted_at=1.25, rounds=4, drafted=12, accepted=9, row=_row(mod))


def _control_messages(mod):
    """One of each control message of ``mod`` (v3 forms and v4 seqs)."""
    toks = np.asarray([5, 0, V - 1, 3], np.int32)
    q = np.asarray([0.5, 0.25, 0.125, 1.0], np.float32)
    return [
        mod.PlaceReplica(spec_json='{"backend": "engine"}'),
        mod.PlaceAck(ok=True, n_slots=2, k_max=3, max_len=64, greedy=True,
                     paged_attention=False),
        mod.PlaceAck(ok=False, error="no: bad spec"),
        mod.AdmitRequest(device_id=7, prompt=toks, now=0.5),
        mod.AdmitReply(device_id=7, ok=True, slot=1, prev_token=-3),
        mod.SubmitRequest(device_id=7, tokens=toks, now=1.5),
        mod.SubmitRequest(device_id=7, tokens=toks, now=1.5, draft_q=q, qmode="f32", seq=3),
        mod.SubmitAck(device_id=7),
        mod.StepRequest(now=2.25),
        mod.StepReply(verdicts=(mod.VerdictRec(device_id=7, n_accepted=2, tokens=toks[:3],
                                               next_prev=9, accept_rate=0.5, queue_depth=1,
                                               queue_s=0.5, verify_s=0.25),),
                      queue_depth=1, n_free=1, hint=3.5),
        mod.StepReply(verdicts=(), queue_depth=0, n_free=2, hint=None),
        mod.RetireRequest(device_id=7),
        mod.RetireReply(stream=_state(mod)),
        mod.CancelRequest(device_id=7),
        mod.CancelReply(device_id=7, ok=False),
        mod.ForceExtendRequest(device_id=7, tokens=toks),
        mod.ForceExtendReply(device_id=7, next_prev=11),
        mod.ExportStream(device_id=7),
        mod.ExportReply(stream=_state(mod)),
        mod.ImportStream(stream=_state(mod)),
        mod.ImportAck(device_id=7, slot=0),
        mod.StatsRequest(now=9.0, has_now=True),
        mod.ReplicaStats(stats_json='{"rounds": 3}'),
        mod.ReplicaStats(stats_json='{"rounds": 3}', telemetry_json='{"snapshot": {}}'),
        mod.WarmupRequest(),
        mod.WarmupReply(compile_json='{"4": 0.1}'),
        mod.Drain(),
        mod.DrainAck(streams_left=2),
        mod.ErrorReply(message="ValueError: boom"),
        mod.AdmitRequest(device_id=7, prompt=toks, now=0.5, seq=12),
        mod.StepRequest(now=2.25, seq=14),
        mod.RetireRequest(device_id=7, seq=15),
        mod.CancelRequest(device_id=7, seq=16),
        mod.ForceExtendRequest(device_id=7, tokens=toks, seq=17),
        mod.ExportStream(device_id=7, seq=18),
        mod.ImportStream(stream=_state(mod), seq=19),
        mod.Ping(seq=20, t=1.25),
        mod.Pong(seq=20, t=1.25),
    ]


def _bits(x) -> np.ndarray:
    """An array leaf's raw bytes (a bf16 leaf of either package as its words)."""
    if isinstance(x, codec.BF16Words):
        return x.words
    if x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16)
    return x


def _same(a, b) -> None:
    """Field-for-field equality of a port and a JAX message (or record)."""
    assert type(a).__name__ == type(b).__name__
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            x, y = _bits(a[k]), _bits(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def test_codec_assigns_the_jax_type_ids():
    assert codec.VERSION == jcodec.VERSION == 4
    ids = {n: getattr(codec, n) for n in dir(codec) if n.startswith("T_")}
    assert ids == {n: getattr(jcodec, n) for n in dir(jcodec) if n.startswith("T_")}
    assert sorted(ids.values()) == list(range(1, 35))


@pytest.mark.parametrize("i", range(len(_control_messages(codec))))
def test_control_frames_are_the_jax_codecs_bytes(i):
    """Each control message encodes to the JAX codec's bytes, and each side
    decodes the other's frame to the same fields (bf16 leaves by bits)."""
    mine, theirs = _control_messages(codec)[i], _control_messages(jcodec)[i]
    frame = codec.encode_frame(mine)
    assert frame == jcodec.encode_frame(theirs)
    got_here, used = codec.decode_frame(frame)
    got_there, used_there = jcodec.decode_frame(frame)
    assert used == used_there == len(frame)
    _same(got_here, got_there)
    _same(got_here, theirs)
    if isinstance(mine, (codec.RetireReply, codec.ExportReply, codec.ImportStream)):
        assert got_here.stream == mine.stream


def test_stream_state_row_survives_bit_for_bit():
    """A row of bf16, f32, int8 and int32 leaves crosses either way with
    every bit: the port decodes JAX's ml_dtypes bf16 leaf to its words, and
    JAX decodes the port's words to the same bf16 values."""
    row = codec.decode_frame(jcodec.encode_frame(jcodec.ImportStream(_state(jcodec))))[0].stream.row
    assert isinstance(row["layer0/k"], codec.BF16Words)
    np.testing.assert_array_equal(row["layer0/k"].words, BF16.view(np.uint16))
    back = jcodec.decode_frame(codec.encode_frame(codec.ImportStream(_state(codec))))[0].stream.row
    assert back["layer0/k"].dtype == ml_dtypes.bfloat16
    for k, want in _row(jcodec).items():
        np.testing.assert_array_equal(_bits(back[k]), _bits(want))
        np.testing.assert_array_equal(_bits(row[k]), _bits(want))


def test_codec_truncation_never_yields_a_frame():
    """Every strict prefix of a control frame reassembles to nothing and
    decodes to a CodecError, never to a message."""
    for msg in _control_messages(codec):
        buf = codec.encode_frame(msg)
        for cut in range(len(buf)):
            dec = codec.FrameDecoder()
            dec.feed(buf[:cut])
            assert dec.next_raw() is None, (type(msg).__name__, cut)
            with pytest.raises(codec.CodecError):
                codec.decode_frame(buf[:cut])


@pytest.mark.parametrize("msg", [
    codec.ImportStream(stream=_state(codec)),
    codec.AdmitRequest(device_id=1, prompt=np.arange(4, dtype=np.int32)),
])
def test_codec_corrupt_payload_raises_codec_error(msg):
    """A payload cut short under a fixed-up length raises CodecError (not
    IndexError or struct.error), and so does an unknown dtype name."""
    buf = bytearray(codec.encode_frame(msg))
    body = buf[codec.HEADER_SIZE:][:-3]
    trimmed = bytearray(buf[: codec.HEADER_SIZE]) + body
    trimmed[4:8] = len(body).to_bytes(4, "big")
    with pytest.raises(codec.CodecError):
        codec.decode_frame(bytes(trimmed))
    if isinstance(msg, codec.ImportStream):
        bad = codec.encode_frame(msg).replace(b"int32", b"inX32")
        with pytest.raises(codec.CodecError, match="dtype"):
            codec.decode_frame(bad)


# ---------------------------------------------------------------------------
# WorkerCore and a Router over a fake wire
# ---------------------------------------------------------------------------


class FakeChannel:
    """A ControlChannel in process: each request is encoded, decoded by the
    worker's dispatch, and its reply encoded and decoded again (the whole
    wire path but the socket). ``killed`` makes every RPC raise ReplicaGone,
    like a dead peer."""

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

    def close(self):
        pass

    def reconnect(self):
        if self.killed:
            raise ReplicaGone("worker still dead (fake)")


def _fake_remote(engine: ServerEngine, spec=None) -> RemoteReplica:
    """A RemoteReplica over a FakeChannel around a prebuilt engine, its
    shape adopted as a PlaceAck would give it."""
    remote = RemoteReplica(FakeChannel(WorkerCore(engine)))
    remote.adopt(n_slots=engine.pool.n_slots, k_max=engine.k_max, max_len=engine.pool.max_len,
                 greedy=engine.greedy, paged_attention=engine.paged_attention)
    remote.spec = spec
    remote.retry_rpcs = True  # the default FaultPolicy's
    return remote


def _engines(spec, n: int, bundle=None, slots: int = 2):
    bundle = bundle or build_models(spec.model, device="cpu")
    one = spec.with_backend("engine", scheduler=dataclasses.replace(spec.scheduler, slots=slots))
    return [System.build(one, models=bundle, device="cpu").engine for _ in range(n)]


def test_worker_core_place_refuses_a_second_placement_and_a_missing_one():
    spec = _spec()
    core = WorkerCore(device="cpu")
    reply = core.handle(codec.StepRequest(now=0.0))
    assert isinstance(reply, codec.ErrorReply) and "PlaceReplica" in reply.message
    assert isinstance(core.handle(codec.Ping(seq=3, t=1.5)), codec.Pong)
    ack = core.handle(codec.PlaceReplica(spec.with_backend("engine").to_json_str()))
    assert ack.ok and ack.n_slots == spec.slots_per_replica and ack.k_max == spec.k_max
    again = core.handle(codec.PlaceReplica(spec.to_json_str()))
    assert isinstance(again, codec.PlaceAck) and not again.ok and "already" in again.error


def test_build_engine_from_spec_forces_the_engine_backend():
    spec = _spec()  # backend cluster, 2 replicas
    engine = build_engine_from_spec(spec, device="cpu")
    assert isinstance(engine, ServerEngine)
    assert engine.pool.n_slots == spec.slots_per_replica


def test_a_resent_seq_returns_the_cached_reply():
    """Admit and step resent with their seqs: the original replies, and the
    engine neither admits twice nor steps again."""
    engine = _engines(_spec(), 1)[0]
    core = WorkerCore(engine)
    prompt = np.arange(6, dtype=np.int32)
    first = core.handle(codec.AdmitRequest(0, prompt, 0.0, seq=5))
    assert core.handle(codec.AdmitRequest(0, prompt, 0.0, seq=5)) is first
    core.handle(codec.SubmitRequest(0, np.asarray([1, 2], np.int32), 0.1, seq=6))
    step = core.handle(codec.StepRequest(0.2, seq=7))
    assert len(step.verdicts) == 1
    rounds = len(engine.round_log)
    assert core.handle(codec.StepRequest(0.2, seq=7)) is step
    assert len(engine.round_log) == rounds and core.replay_hits == 2
    fresh = core.handle(codec.AdmitRequest(0, prompt, 0.0, seq=8))
    assert isinstance(fresh, codec.ErrorReply) and "already admitted" in fresh.message


def test_remote_router_commits_the_jax_clusters_tokens():
    """The invariant that holds the remote path to the JAX package: two
    RemoteReplicas over the encode/decode wire, around port engines on
    weights bridged from the JAX package, commit the JAX package's
    in-process cluster serve of the same spec and prompts."""
    jspec = _jspec()
    mb = jax_build_models(jspec.model)
    pb = _port_bundle(mb)
    prompts = np.random.default_rng(7).integers(0, V, size=(4, 6)).astype(np.int32)
    want = JSystem.build(jspec, models=mb).serve(prompts).outputs
    spec = _spec()
    remotes = [_fake_remote(e) for e in _engines(spec, 2, pb)]
    router = Router(remotes, placement=spec.cluster.placement,
                    migrate_on_retire=spec.cluster.migrate_on_retire)
    kit = System.build(spec.with_backend("reference"), models=pb, device="cpu").kit
    got = System(spec, pb, router, kit, torch.device("cpu")).serve(prompts).outputs
    _assert_same_tokens([got[i] for i in range(4)], [want[i] for i in range(4)], mb, prompts)
    assert router.evictions == 0 and router.stats().replicas == 2


@pytest.mark.parametrize("family", ["bf16", "int8", "mamba2", "zamba2"])
def test_remote_migration_is_a_copy_of_bits(family):
    """Four streams on two remote replicas, three verify rounds each (so
    the int8 scales and the ssm state are set and differ by row); a stream
    of replica 0 moves to replica 1 over ExportStream/ImportStream: every
    leaf of its new row equals the old row bit for bit, and the shadow
    record (prev token, committed tokens) moves with it."""
    spec = _family_spec(family)
    engines = _engines(spec, 2, slots=3)
    router = Router([_fake_remote(e, spec) for e in engines], placement="round-robin",
                    migrate_on_retire=False)
    prompts = np.random.default_rng(1).integers(0, spec.model.vocab_size,
                                                size=(4, spec.prompt_len)).astype(np.int32)
    rng = np.random.default_rng(2)
    for i in range(4):
        router.admit(i, prompts[i], 0.0)
    assert router.loads() == [2, 2]
    for t in range(3):
        for i in range(4):
            router.submit(i, rng.integers(0, spec.model.vocab_size, size=1 + (i + t) % 4),
                          float(t))
        router.step(float(t) + 0.5)
    before = _raw_row(engines[0], engines[0].streams[2].slot)
    shadow = router.streams[2]
    record = (shadow.prev_token, list(shadow.committed))
    assert record[1] == engines[0].streams[2].committed
    router.migrate(2, 1)
    assert router.replica_of(2) == 1 and router.migrations == 1
    assert 2 in engines[1].streams and 2 not in engines[0].streams
    after = _raw_row(engines[1], engines[1].streams[2].slot)
    assert sorted(after) == sorted(before)
    for name in before:
        a, b = before[name], after[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.is_floating_point():
            a, b = (x.view(torch.int16 if x.element_size() == 2 else torch.int32) for x in (a, b))
        assert torch.equal(a, b), name
    moved = router.streams[2]
    assert (moved.prev_token, list(moved.committed)) == record


def test_mixed_flavour_migration_is_refused():
    spec = _spec()
    local, far = _engines(spec, 2)
    router = Router([local, _fake_remote(far)])
    assert [r.flavor for r in router.replicas] == ["local", "remote"]
    router.admit(0, np.arange(6, dtype=np.int32), 0.0)
    assert router.replica_of(0) == 0
    with pytest.raises(MigrationError, match="provenance"):
        router.migrate(0, 1)
    assert router.replica_of(0) == 0 and 0 in router.streams


def test_a_worker_error_does_not_evict():
    remote = _fake_remote(_engines(_spec(), 1)[0])
    router = Router([remote])
    with pytest.raises(WorkerError, match="KeyError"):
        remote.retire(99)  # no such stream: the worker says so
    assert not remote.dead and router.evictions == 0


def test_a_dead_worker_is_evicted_and_the_survivors_serve():
    """Replica 1's channel dies mid-step: it is evicted (its streams lost),
    replica 0's verdicts are still returned, new streams land on replica 0
    and the merged stats skip the dead replica."""
    router = Router([_fake_remote(e) for e in _engines(_spec(), 2)])
    prompts = np.arange(4 * 6, dtype=np.int32).reshape(4, 6) % V
    for dev in range(4):  # least-loaded: 0, 2 -> replica 0; 1, 3 -> replica 1
        assert router.admit(dev, prompts[dev], 0.0) is not None
    assert router.loads() == [2, 2]
    for dev in range(4):
        router.submit(dev, np.asarray([1, 2, 3], np.int32), 0.1)
    router.replicas[1].channel.killed = True
    verdicts = router.step(0.2)
    assert router.evictions == 1 and router.replicas[1].dead and not router.replicas[0].dead
    assert sorted(router.lost_devices) == [1, 3]
    assert {v.device_id for v in verdicts} == {0, 2}
    assert 1 not in router.streams and 3 not in router.streams
    router.retire(0)
    assert router.admit(9, prompts[1], 1.0) is not None and router.replica_of(9) == 0
    assert router.stats(1.0).replicas == 1


def test_no_replica_left_is_fatal():
    router = Router([_fake_remote(_engines(_spec(), 1)[0])])
    router.replicas[0].channel.killed = True
    with pytest.raises(RuntimeError, match="no capacity"):
        router.admit(0, np.zeros(6, np.int32), 0.0)


def test_telemetry_payload_reads_the_workers_pool_gauges():
    """With telemetry on, a worker's ReplicaStats carries its metrics
    snapshot and its flight ring (empty before any round), and the cluster
    record takes each remote replica's pool from its gauges."""
    was = telemetry.enabled()
    telemetry.enable(True)
    try:
        engines = _engines(_spec(), 2)
        router = Router([_fake_remote(e) for e in engines])
        router.stats()
        payload = router.telemetry_payload()
    finally:
        telemetry.enable(was)
    assert sorted(payload["workers"]) == ["0", "1"]
    assert all(w["flight"] == [] for w in payload["workers"].values())
    assert payload["pools"] == {
        str(i): {"kv_dtype": "bf16", "kv_pool_bytes": e.pool.pool_bytes(),
                 "bytes_per_slot": e.pool.bytes_per_slot()} for i, e in enumerate(engines)}
