"""The port's cluster backend: a Router over in-process replicas, held to
the JAX package.

``EngineStats.merge`` and every placement policy give the JAX package's
records and choices; a stream's pool row moves between replicas bit for
bit on the bf16 pool, the int8 pool (its scale leaves included) and the
mamba2 state; and ``System`` with ``backend="cluster"`` over two replicas,
with migrations forced by unequal budgets, commits the streams of the
port's reference backend and of the JAX reference (weights bridged from
the JAX package, tests/test_torch_serve.py), up to a printed near tie.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import ServeSpec as JServeSpec
from repro.api import System as JSystem
from repro.cluster import router as jrouter
from repro.core.engine import EngineStats as JEngineStats
from repro_torch.api import ServeSpec, System, build_models
from repro_torch.api.events import RoundEvent
from repro_torch.api.spec import ClusterSpec, DeviceClassSpec, FleetSpec, ModelSpec
from repro_torch.cluster import router
from repro_torch.core.engine import EngineStats
from repro_torch.core.server_engine import ServerEngine
from test_torch_serve import SPEC_JSON, _assert_same_tokens, _port_bundle, jax_build_models

BUSY = dict(wstgr=10.0, per_device_rate=5.0, server_busy_frac=0.4, rounds=8, timeouts=1,
            fallback_tokens=3, mean_batch_fill=2.0, mean_round_latency=0.1,
            server_rounds_per_s=4.0, partial_rounds=2, streams_served=2,
            acceptance_rate=0.8, mean_queue_depth=1.0, bytes_tx=100, frames_tx=10)
BUSIER = dict(BUSY, wstgr=30.0, server_busy_frac=0.2, rounds=24, timeouts=0,
              fallback_tokens=1, mean_batch_fill=4.0, mean_round_latency=0.3,
              server_rounds_per_s=12.0, partial_rounds=1, streams_served=6,
              acceptance_rate=0.4, mean_queue_depth=3.0, bytes_rx=7, frames_dropped=2,
              fallback_rounds=1)
IDLE = dict(wstgr=0.0, per_device_rate=0.0, server_busy_frac=0.0, rounds=0, timeouts=0,
            fallback_tokens=0, mean_batch_fill=0.0, mean_round_latency=0.0,
            server_rounds_per_s=0.0, streams_served=1)


@pytest.mark.parametrize("records", [[BUSY], [BUSY, BUSIER], [BUSY, IDLE], [IDLE, IDLE],
                                     [BUSY, BUSIER, IDLE]])
def test_engine_stats_merge_matches_jax(records):
    """The merged record equals the JAX package's field for field, an idle
    replica (no rounds, no rate) included."""
    got = EngineStats.merge([EngineStats(**r) for r in records]).to_json()
    want = JEngineStats.merge([JEngineStats(**r) for r in records]).to_json()
    assert list(got) == list(want)
    assert got == pytest.approx(want)


class _Replica:
    """A stand-in replica with a load and a free-slot count, readable by
    both packages' placement policies."""

    dead = False

    def __init__(self, load: int, free: int):
        self.streams = dict.fromkeys(range(load))
        self.n_free = free


class _Fleet:
    def __init__(self, replicas):
        self.replicas = replicas


# each step: (device_id, [(load, free) per replica])
SCRIPT = [
    (0, [(0, 2), (0, 2), (0, 2)]),
    (1, [(1, 1), (0, 2), (0, 2)]),
    (5, [(1, 1), (1, 1), (0, 2)]),
    (2, [(1, 1), (1, 1), (1, 1)]),
    (3, [(2, 0), (1, 1), (1, 1)]),
    (7, [(2, 0), (2, 0), (1, 1)]),
    (4, [(1, 1), (2, 0), (2, 0)]),
    (9, [(2, 0), (2, 0), (2, 0)]),
    (6, [(0, 2), (2, 0), (1, 1)]),
]


@pytest.mark.parametrize("name", sorted(router.PLACEMENT_POLICIES))
def test_placement_picks_the_jax_replica(name):
    """Every policy, driven through one script of loads and free slots
    (full pools, ties, a full home replica), picks the JAX policy's replica
    at every step; class-affinity with a device -> class map and without."""
    for class_of in ((lambda d: d // 3), None) if name == "class-affinity" else (None,):
        if name == "class-affinity":
            mine = router.ClassAffinityPlacement(class_of)
            theirs = jrouter.ClassAffinityPlacement(class_of)
        else:
            mine, theirs = router.make_placement(name), jrouter.make_placement(name)
        for dev, state in SCRIPT:
            fleet = _Fleet([_Replica(load, free) for load, free in state])
            assert mine.choose(fleet, dev) == theirs.choose(fleet, dev), (name, dev, state)


def _family_spec(family: str) -> ServeSpec:
    spec = ServeSpec.from_json(SPEC_JSON)
    if family == "int8":
        return dataclasses.replace(spec, kv_dtype="int8")
    if family in ("mamba2", "zamba2"):
        arch = {"mamba2": "mamba2-370m", "zamba2": "zamba2-1.2b"}[family]
        return dataclasses.replace(spec, prompt_len=40, model=dataclasses.replace(
            spec.model, arch=arch, draft_arch=arch))
    return spec


def _raw_row(engine, slot: int) -> dict:
    """Pool row ``slot`` read straight off the pool's leaves (the batch on
    axis 1, ``length`` on axis 0), apart from the gather that migrates it."""
    return {n: (a[slot] if n == "length" else a[:, slot]).clone()
            for n, a in engine.pool.cache.items()}


@pytest.mark.parametrize("family", ["bf16", "int8", "mamba2", "zamba2"])
def test_migrated_row_is_a_copy_of_bits(family):
    """Three streams on replica a, two on replica b, a few verify rounds
    each (so the int8 scales and the ssm state are set and differ by row;
    zamba2's rows carry both the state and the shared block's K/V):
    the middle stream of a moves into b's third slot. Every leaf of its new
    row equals its old row bit for bit, b's other rows and a's remaining
    rows are untouched, and a stream with a request in flight refuses to
    move."""
    spec = _family_spec(family)
    pb = build_models(spec.model, device="cpu")
    kw = dict(n_slots=3, max_len=spec.max_len, k_max=spec.k_max, attn_chunk=spec.attn_chunk,
              kv_dtype=spec.kv_dtype, device="cpu")
    a, b = ServerEngine(pb.target, pb.target_params, **kw), ServerEngine(
        pb.target, pb.target_params, **kw)
    prompts = np.random.default_rng(1).integers(0, spec.model.vocab_size,
                                                size=(5, spec.prompt_len)).astype(np.int32)
    rng = np.random.default_rng(2)
    for eng, ids in ((a, (0, 1, 2)), (b, (3, 4))):
        for i in ids:
            eng.admit(i, prompts[i], 0.0)
        for t in range(3):
            for i in ids:
                eng.submit(i, rng.integers(0, spec.model.vocab_size, size=1 + (i + t) % 4),
                           float(t))
            eng.step(float(t) + 0.5)
    before_a = {i: _raw_row(a, a.streams[i].slot) for i in (0, 1, 2)}
    before_b = {i: _raw_row(b, b.streams[i].slot) for i in (3, 4)}
    leaves = set(before_a[1])
    if family == "int8":
        assert {"k_scale", "v_scale"} <= leaves
        assert not torch.equal(before_a[0]["k_scale"], before_a[1]["k_scale"])
    if family in ("mamba2", "zamba2"):
        assert {"ssm", "conv"} <= leaves
        assert not torch.equal(before_a[0]["ssm"], before_a[1]["ssm"])
    if family == "zamba2":
        assert {"k", "v"} <= leaves and before_a[1]["k"].shape[0] == 1  # one application
        assert before_a[1]["ssm"].dtype == torch.float32
        assert {before_a[1][n].dtype for n in ("conv", "k", "v")} == {torch.bfloat16}
    stream, row = a.export_stream(1)
    assert 1 not in a.streams and a.pool.n_free == 1
    b.import_stream(stream, row)
    assert b.streams[1].slot == 2 and b.streams[1].prev_token == stream.prev_token
    moved = _raw_row(b, 2)
    for name in leaves:
        assert torch.equal(moved[name], before_a[1][name]), name
    for eng, before in ((a, before_a), (b, before_b)):
        for i, old in before.items():
            if i == 1:
                continue
            now = _raw_row(eng, eng.streams[i].slot)
            assert all(torch.equal(now[n], old[n]) for n in leaves), (i, family)
    b.submit(1, np.asarray([1, 2], np.int32), 9.0)
    with pytest.raises(ValueError, match="in flight"):
        b.export_stream(1)


def test_router_guards():
    """No replicas, an unknown policy, unequal k_max, and a move between
    pools of another kv_dtype are refused; the move leaves the stream where
    it was."""
    spec = ServeSpec.from_json(SPEC_JSON)
    pb = build_models(spec.model, device="cpu")
    kw = dict(n_slots=1, max_len=64, attn_chunk=32, device="cpu")
    with pytest.raises(ValueError):
        router.Router([])
    with pytest.raises(ValueError, match="unknown placement"):
        router.make_placement("warp")
    a = ServerEngine(pb.target, pb.target_params, k_max=4, **kw)
    with pytest.raises(ValueError, match="homogeneous"):
        router.Router([a, ServerEngine(pb.target, pb.target_params, k_max=2, **kw)])
    r = router.Router([a, ServerEngine(pb.target, pb.target_params, k_max=4, kv_dtype="int8",
                                       **kw)], migrate_on_retire=False)
    r.admit(0, np.arange(5, dtype=np.int32))
    with pytest.raises(router.MigrationError, match="fingerprints"):
        r.migrate(0, 1)
    assert r.replica_of(0) == 0 and r.loads() == [1, 0]


def _serve_sessions(system, prompts, budgets):
    """Every device's session, pumped in turn until all finish (budgets may
    differ); returns device -> tokens."""
    sessions = [system.open_session(prompts[i], device_id=i, max_new=budgets[i])
                for i in range(len(budgets))]
    gens = [s.generate() for s in sessions]
    while not all(s.done for s in sessions):
        for s, g in zip(sessions, gens):
            if not s.done:
                next(g, None)
    return {s.device_id: s.result.tokens for s in sessions}


@pytest.mark.parametrize("placement", ["least-loaded", "round-robin"])
def test_cluster_serve_equals_reference_and_jax(placement):
    """Six devices on 2 replicas x 3 slots; even ids stop after 4 tokens and
    odd ids after 16, so the replica holding the even ids empties first and
    migration must move streams. Every stream equals the port's reference
    and the JAX reference (their first ``budget`` tokens)."""
    jspec = dataclasses.replace(JServeSpec.from_json(SPEC_JSON), devices=6, max_new=16)
    pspec = dataclasses.replace(ServeSpec.from_json(SPEC_JSON), devices=6, max_new=16)
    mb = jax_build_models(jspec.model)
    pb = _port_bundle(mb)
    prompts = np.random.default_rng(5).integers(
        0, jspec.model.vocab_size, size=(6, jspec.prompt_len)).astype(np.int32)
    want = JSystem.build(jspec.with_backend("reference"), models=mb).serve(prompts).outputs
    ref = System.build(pspec.with_backend("reference"), models=pb, device="cpu").serve(prompts)
    system = System.build(
        dataclasses.replace(pspec, backend="cluster",
                            cluster=ClusterSpec(replicas=2, placement=placement)),
        models=pb, device="cpu")
    budgets = [4 if i % 2 == 0 else 16 for i in range(6)]
    got = _serve_sessions(system, prompts, budgets)
    assert system.engine.migrations >= 1
    _assert_same_tokens([ref.outputs[i] for i in range(6)], [want[i] for i in range(6)], mb,
                        prompts)
    _assert_same_tokens([got[i] for i in range(6)],
                        [ref.outputs[i][:budgets[i]] for i in range(6)], mb, prompts)
    assert [len(got[i]) for i in range(6)] == budgets
    st = system.engine.stats()
    assert st.replicas == 2 and st.streams_served == 6  # a migration serves no stream


def test_class_affinity_homes_each_class():
    """A two-class fleet on 2 replicas with class-affinity placement: every
    round of a class's device is verified on the class's home replica
    (migration off: it would move a stream off its home)."""
    fleet = FleetSpec(classes=(
        DeviceClassSpec(profile="jetson-orin-nano", count=3, bits=4, k=4),
        DeviceClassSpec(profile="rpi4b", count=2, bits=4, k=2),
    ))
    spec = ServeSpec(backend="cluster", model=ModelSpec(vocab_size=64, target_layers=2),
                     fleet=fleet, max_new=6, prompt_len=8,
                     cluster=ClusterSpec(replicas=2, placement="class-affinity",
                                         migrate_on_retire=False))
    system = System.build(spec, models=build_models(spec.model, device="cpu"), device="cpu")
    homes = {}

    def on_event(ev):
        if isinstance(ev, RoundEvent):  # the stream is placed until it retires
            homes.setdefault(ev.device_id, set()).add(system.engine.replica_of(ev.device_id))

    system.serve(on_event=on_event)
    assert homes == {d: {spec.class_of(d).index} for d in range(spec.devices)}
