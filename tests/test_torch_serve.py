"""End-to-end parity of the port's serving slice with the JAX package.

Weights come from the JAX side (``build_models``) through the bridge, so
both packages serve the same model; prompts are passed explicitly (the JAX
``System.prompts()`` draws from ``jax.random``). Greedy decoding makes the
committed tokens the comparison: they must be identical, except at a near
tie, where the JAX reference's top-2 logit gap is below ``TIE_TOL`` (the
two packages round the same bf16 steps but sum f32 products in different
orders, ~1e-7 on the logits). The test prints any such gap.
"""
import ast
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.spec import ModelSpec as JModelSpec
from repro.api.spec import ServeSpec as JServeSpec
from repro.api.system import System as JSystem
from repro.api.system import build_models as _jax_build_models
from repro.core import engine_loop as jax_loop
from repro_torch import bridge
from repro_torch.api import (
    ModelBundle,
    ModelSpec,
    ServeSpec,
    System,
    build_draft_variant,
    build_models,
)
from repro_torch.api.events import RoundEvent
from repro_torch.api.spec import (
    ClusterSpec,
    DeviceClassSpec,
    FaultEvent,
    FaultPolicy,
    FaultSpec,
    FleetSpec,
    ReplicaSpec,
)
from repro_torch.cluster.remote import ReplicaGone, spawn_worker
from repro_torch.cluster.router import Router
from repro_torch.configs.base import ModelConfig
from repro_torch.core import engine_loop, verification
from repro_torch.core.server_engine import EdgeDeviceKit, ServerEngine
from repro_torch.models.model_zoo import build_model
from repro_torch.transport import worker

ROOT = Path(__file__).resolve().parents[1]
TIE_TOL = 1e-3
SPEC_JSON = (ROOT / "examples" / "specs" / "engine.json").read_text()
# model builds shared across this module's tests (the JAX init compiles)
jax_build_models = functools.lru_cache(maxsize=None)(_jax_build_models)


def _port_bundle(mb) -> ModelBundle:
    tcfg = ModelConfig(**dataclasses.asdict(mb.target_cfg))
    dcfg = ModelConfig(**dataclasses.asdict(mb.draft_cfg))
    return ModelBundle(
        tcfg, dcfg, build_model(tcfg), build_model(dcfg),
        bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, mb.target_params), device="cpu"),
        bridge.params_from_jax(dcfg, jax.tree.map(np.asarray, mb.draft_params), device="cpu"),
    )


def _top2_gap(mb, prompt, prefix, kv_dtype=jnp.bfloat16) -> float:
    toks = jnp.asarray(np.concatenate([prompt, np.asarray(prefix, np.int32)])[None], jnp.int32)
    cache = mb.target.make_cache(1, toks.shape[1] + 8, attn_chunk=32, kv_dtype=kv_dtype)
    logits, _ = mb.target.prefill(mb.target_params, toks, cache, attn_chunk=32)
    top = jax.lax.top_k(logits[0], 2)[0]
    return float(top[0] - top[1])


def _assert_same_tokens(got, want, mb, prompts, kv_dtype=jnp.bfloat16) -> None:
    """Identical streams, or a first divergence at a printed near tie."""
    for i in range(len(want)):
        g, w = list(got[i]), list(want[i])
        if g == w:
            continue
        p = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        gap = _top2_gap(mb, prompts[i], w[:p], kv_dtype)
        print(f"stream {i}: first divergence at token {p}, reference top-2 gap {gap:.3g}")
        assert gap < TIE_TOL, f"stream {i} diverges at token {p} with top-2 gap {gap}"


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_sled_generate_matches_jax(noise):
    """Greedy lock-step SLED on the reduced default spec: tokens and
    SledStats equal the JAX loop's (0.1 noise forces rejections)."""
    mb = jax_build_models(JModelSpec(draft_noise=noise))
    pb = _port_bundle(mb)
    prompts = np.random.default_rng(3).integers(0, 256, size=(4, 12)).astype(np.int32)
    kw = dict(max_new=16, k_max=4, c_th=0.3)
    jt, js, _ = jax_loop.sled_generate(mb.draft, mb.draft_params, mb.target, mb.target_params,
                                       jnp.asarray(prompts), **kw)
    pt, ps = engine_loop.sled_generate(pb.draft, pb.draft_params, pb.target, pb.target_params,
                                       prompts, **kw)
    _assert_same_tokens(pt, jt, mb, prompts)
    if np.array_equal(pt, jt):
        assert dataclasses.asdict(ps) == dataclasses.asdict(js)


@pytest.mark.parametrize("noise", [None, 0.08])
def test_system_engine_equals_reference_equals_jax_reference(noise):
    """examples/specs/engine.json (and a noisier draft that forces partial
    acceptance): port engine == port reference == JAX reference."""
    jspec, pspec = JServeSpec.from_json(SPEC_JSON), ServeSpec.from_json(SPEC_JSON)
    if noise is not None:
        jspec = dataclasses.replace(jspec, model=dataclasses.replace(jspec.model, draft_noise=noise))
        pspec = dataclasses.replace(pspec, model=dataclasses.replace(pspec.model, draft_noise=noise))
    mb = jax_build_models(jspec.model)
    pb = _port_bundle(mb)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jspec.model.vocab_size,
                           size=(jspec.devices, jspec.prompt_len)).astype(np.int32)
    want = JSystem.build(jspec.with_backend("reference"), models=mb).serve(prompts).outputs
    ref = System.build(pspec.with_backend("reference"), models=pb, device="cpu").serve(prompts)
    eng = System.build(pspec, models=pb, device="cpu").serve(prompts)
    _assert_same_tokens([ref.outputs[i] for i in range(len(want))],
                        [want[i] for i in range(len(want))], mb, prompts)
    _assert_same_tokens([eng.outputs[i] for i in range(len(want))],
                        [ref.outputs[i] for i in range(len(want))], mb, prompts)
    assert eng.engine.rounds > 0 and all(len(t) == jspec.max_new for t in eng.outputs.values())


def _serve_three_ways(jspec, pspec, kv_dtype=jnp.bfloat16):
    """JAX reference, port reference and port engine on one bridged bundle
    and one numpy prompt set; the port's streams must equal JAX's."""
    mb = jax_build_models(jspec.model)
    pb = _port_bundle(mb)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jspec.model.vocab_size,
                           size=(jspec.devices, jspec.prompt_len)).astype(np.int32)
    want = JSystem.build(jspec.with_backend("reference"), models=mb).serve(prompts).outputs
    ref = System.build(pspec.with_backend("reference"), models=pb, device="cpu").serve(prompts)
    eng = System.build(pspec, models=pb, device="cpu").serve(prompts)
    n = len(want)
    _assert_same_tokens([ref.outputs[i] for i in range(n)], [want[i] for i in range(n)], mb,
                        prompts, kv_dtype)
    _assert_same_tokens([eng.outputs[i] for i in range(n)], [ref.outputs[i] for i in range(n)],
                        mb, prompts, kv_dtype)
    assert eng.engine.rounds > 0 and all(len(t) == jspec.max_new for t in eng.outputs.values())
    return eng


@pytest.mark.parametrize("noise", [None, 0.08])
def test_system_int8_pool_engine_equals_reference_equals_jax_reference(noise):
    """The default spec on an int8 pool (engine) and an int8 target cache
    (reference), and a noisier draft: port engine == port reference == JAX
    reference."""
    jspec, pspec = JServeSpec.from_json(SPEC_JSON), ServeSpec.from_json(SPEC_JSON)
    jspec, pspec = (dataclasses.replace(s, kv_dtype="int8") for s in (jspec, pspec))
    if noise is not None:
        jspec, pspec = (dataclasses.replace(s, model=dataclasses.replace(s.model, draft_noise=noise))
                        for s in (jspec, pspec))
    eng = _serve_three_ways(jspec, pspec, jnp.int8)
    assert eng.engine.acceptance_rate > 0


def test_system_mamba2_engine_equals_reference_equals_jax_reference():
    """Reduced mamba2-370m target and draft, prompts of 2.5 scan chunks:
    the engine's gather/scatter verify with state checkpoints == the port's
    reference == the JAX reference, with drafts both accepted and rejected."""
    eng = _serve_three_ways(*_mamba2_specs())
    assert 0 < eng.engine.acceptance_rate < 1


@pytest.mark.parametrize("arch,draft_arch,noise", [
    ("llama-11b-target", "llama-1b-draft", None),
    ("llama-1b-draft", "llama-1b-draft", 0.08),
])
def test_paper_pairs_engine_equals_reference_equals_jax_reference(arch, draft_arch, noise):
    """The paper's pairs (configs/sled_paper.py) reduced, on the default
    spec: the untied 11B head under an independent 1B draft, and the 1B
    drafting for itself with noise 0.08, which forces partial acceptance."""
    jspec, pspec = JServeSpec.from_json(SPEC_JSON), ServeSpec.from_json(SPEC_JSON)
    change = dict(arch=arch, draft_arch=draft_arch)
    if noise is not None:
        change["draft_noise"] = noise
    jspec, pspec = (dataclasses.replace(s, model=dataclasses.replace(s.model, **change))
                    for s in (jspec, pspec))
    eng = _serve_three_ways(jspec, pspec)
    if noise is not None:
        assert 0 < eng.engine.acceptance_rate < 1


def test_traced_inproc_sessions_record_the_jax_rounds():
    """With telemetry on, each session of an engine serve carries one
    TraceEvent per verdict, with the JAX pump's counts."""
    from repro import telemetry as jax_telemetry
    from repro_torch import telemetry

    was = telemetry.enabled(), jax_telemetry.enabled()
    try:
        jspec = dataclasses.replace(JServeSpec.from_json(SPEC_JSON), telemetry=True)
        pspec = dataclasses.replace(ServeSpec.from_json(SPEC_JSON), telemetry=True)
        mb = jax_build_models(jspec.model)
        prompts = np.random.default_rng(5).integers(
            0, jspec.model.vocab_size, size=(jspec.devices, jspec.prompt_len)).astype(np.int32)
        want = JSystem.build(jspec, models=mb).serve(prompts).sessions
        got = System.build(pspec, models=_port_bundle(mb), device="cpu").serve(prompts).sessions
    finally:
        telemetry.enable(was[0])
        jax_telemetry.enable(was[1])

    def counts(s):
        return [(e.device_id, e.round, e.k, e.n_accepted, e.n_commit) for e in s.trace]
    assert [len(s.trace) for s in got] == [len(s.trace) for s in want]
    assert [counts(s) for s in got] == [counts(s) for s in want]
    assert all(len(s.trace) == s.rounds > 0 for s in got)
    assert all(e.verify_s > 0 and e.queue_s >= 0 for s in got for e in s.trace)


def _mamba2_specs():
    return tuple(dataclasses.replace(
        s, prompt_len=40, model=dataclasses.replace(
            s.model, arch="mamba2-370m", draft_arch="mamba2-370m", draft_noise=0.0))
        for s in (JServeSpec.from_json(SPEC_JSON), ServeSpec.from_json(SPEC_JSON)))


class _LateCommit:
    """A model whose commit keeps one fed token too many: for the ssm family
    the state checkpoint after the first rejected draft (a wrong rollback)."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def commit(self, cache, n_commit):
        return self._model.commit(cache, n_commit + 1)


@pytest.mark.parametrize("case", ["engine", "reference", "engine_late_commit"])
def test_replay_stream_witnesses_the_served_streams(case):
    """engine_loop.replay_stream, the witness chip_smoke.py holds the card's
    mamba2 serve to: replayed on a served stream's own commit boundaries,
    the target alone gives back every committed token of the engine and of
    the reference backend (reduced mamba2-370m, drafts accepted and
    rejected), and exposes an engine whose rollback keeps a rejected draft."""
    jspec, pspec = _mamba2_specs()
    if case == "reference":
        pspec = pspec.with_backend("reference")
    pb = _port_bundle(jax_build_models(jspec.model))
    prompts = np.random.default_rng(5).integers(
        0, pspec.model.vocab_size, size=(pspec.devices, pspec.prompt_len)).astype(np.int32)
    system = System.build(pspec, models=pb, device="cpu")
    if case == "engine_late_commit":
        core = system.engine.core
        core.steps.verify = verification.make_paged_verify_step(
            _LateCommit(pb.target), scratch_slot=core.pool.scratch_slot,
            attn_chunk=pspec.attn_chunk)
    rounds = {d: [] for d in range(pspec.devices)}
    res = system.serve(prompts, on_event=lambda ev: rounds[ev.device_id].append(ev.tokens)
                       if isinstance(ev, RoundEvent) else None)
    # the reference verifies every round in one batch of all devices
    n_rows = pspec.devices if case == "reference" else 1
    off = 0
    for d, toks in res.outputs.items():
        greedy, margin = engine_loop.replay_stream(
            pb.target, pb.target_params, prompts[d], rounds[d], k_max=pspec.k_max,
            max_len=pspec.max_len, prefill_rows=n_rows, rows=[n_rows] * len(rounds[d]),
            attn_chunk=pspec.attn_chunk)
        n = len(toks)
        assert greedy.shape[0] >= n
        # a committed token the target does not choose: off by more than a near tie
        off += int(np.sum((greedy[:n] != np.asarray(toks)) & (margin[:n] >= TIE_TOL)))
    if case == "engine_late_commit":
        assert off > 0
    else:
        assert off == 0
        assert any(len(r) > 1 for rs in rounds.values() for r in rs)  # drafts accepted


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{f}: imports {mod}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
        "import repro_torch.api, repro_torch.bridge, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.build, repro_torch.kernels.verify_attn\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.models.mamba2\n"
        "import repro_torch.cluster.remote, repro_torch.transport.worker\n"
        "import repro_torch.cluster.faults, repro_torch.launch.chaos\n"
        "import repro_torch.configs.sled_paper, repro_torch.serving.simulator\n"
        "import repro_torch.serving.cost_model, repro_torch.tuning, repro_torch.launch.tune\n"
        "import repro_torch.cli, repro_torch.launch.serve, repro_torch.telemetry.top\n"
        "import repro_torch.telemetry.logs, repro_torch.models.hybrid\n"
        "import repro_torch.configs.zamba2_1_2b, repro_torch.configs.whisper_tiny\n"
        "import repro_torch.checkpoint, repro_torch.kernels.attn_bwd\n"
        "import repro_torch.training.train_step, repro_torch.launch.train\n"
        "import repro_torch.launch.mesh, repro_torch.sharding.policy\n"
        "import repro_torch.distributed.collectives\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("entry", ["System.build", "build_models", "ServerEngine", "EdgeDeviceKit",
                                   "bridge.params_from_jax", "build_draft_variant",
                                   "spawn_worker", "worker.main"])
def test_entry_points_default_to_the_card(entry):
    """With no card and no explicit device="cpu", every entry point raises
    (spawn_worker before it starts a process, a worker's main before it
    listens)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    spec = ServeSpec.from_json(SPEC_JSON)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "spawn_worker":
            spawn_worker(startup_timeout=5.0)
        elif entry == "worker.main":
            worker.main(["--listen", "tcp:127.0.0.1:0"])
        elif entry == "System.build":
            System.build(spec)
        elif entry == "build_models":
            build_models(spec.model)
        elif entry == "build_draft_variant":
            build_draft_variant(spec.model, draft_layers=1, draft_noise=0.0)
        elif entry == "bridge.params_from_jax":
            mb = jax_build_models(JServeSpec.from_json(SPEC_JSON).model)
            bridge.params_from_jax(ModelConfig(**dataclasses.asdict(mb.target_cfg)),
                                   jax.tree.map(np.asarray, mb.target_params))
        else:
            pb = build_models(spec.model, device="cpu")
            if entry == "ServerEngine":
                ServerEngine(pb.target, pb.target_params, n_slots=2, max_len=64, k_max=4)
            else:
                EdgeDeviceKit(pb.draft, pb.draft_params, k_max=4)


_FLEET = FleetSpec(classes=(DeviceClassSpec(profile="jetson-orin-nano", count=3),))
_REMOTE = ReplicaSpec(flavor="remote", address="tcp:127.0.0.1:7001")
_KILL = FaultSpec(events=(FaultEvent(kind="kill", replica=0, round=2),))


@pytest.mark.parametrize("change", [
    {"family": "encdec", "is_encdec": True, "encoder_layers": 2},
    {"family": "encdec"},
    {"family": "encdec", "norm": "layernorm", "use_rope": False},
    {"family": "encdec", "act": "gelu", "tie_embeddings": True},
])
def test_unported_specs_raise_not_implemented(change):
    """The encdec specs build and prefill as in JAX. The test keeps the name
    of the refusal it replaced case for case (the encdec family, whisper-
    shaped or not, was refused here before it was ported): the reduced
    qwen2 with ``change`` (an encoder and
    cross-attention; the encdec family's name alone; its layernorm and
    learned positions; its gelu MLP with a tied head) builds in the port as
    in JAX, and on the JAX weights (bridged) the prefill behind 32 stub
    frames gives JAX's logits (within 2e-3) and greedy argmaxes. Every spec
    the port's configs can name is served (``paged_attention=False`` and the
    hybrid family: tests/test_torch_hybrid.py; the moe family:
    tests/test_torch_moe.py; the vlm family and the gelu MLP:
    tests/test_torch_families.py; the encdec family:
    tests/test_torch_encdec.py), as are the cluster and transport backends
    with in-process or remote replicas, fault schedules and policies,
    sampling, quantized targets and fleets; ``System.build`` refuses an
    encdec spec (a serve carries no encoder frames)."""
    from repro.configs.base import get_config as jax_config
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.models.model_zoo import frontend_stub as jax_frontend_stub
    from repro_torch.configs import get_config

    jcfg = dataclasses.replace(jax_config("qwen2-1.5b").reduced(), **change)
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), **change)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm, pm = jax_build_model(jcfg), build_model(cfg)
    jp = jm.init_params(jax.random.key(0), max_pos=64)
    own = pm.init_params(torch.Generator().manual_seed(0), max_pos=64)
    pp = bridge.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert sorted(own.state_dict()) == sorted(pp.state_dict())
    assert (pp.enc is not None) == cfg.is_encdec and (pp.pos_embed is None) == cfg.use_rope
    frames = jax_frontend_stub(jcfg, 2, jax.random.key(7))[:, :32]
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    jl, _ = jm.prefill(jp, jnp.asarray(toks), jm.make_cache(2, 64, attn_chunk=32, enc_len=32),
                       attn_chunk=32, enc_frames=frames)
    pl, _ = pm.prefill(pp, torch.from_numpy(toks),
                       pm.make_cache(2, 64, device="cpu", attn_chunk=32, enc_len=32),
                       attn_chunk=32, enc_frames=bridge.to_tensor(np.asarray(frames)))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-3, rtol=0)
    assert pl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()


@pytest.mark.parametrize("change", [{"family": "vlm"}, {"act": "gelu"}])
def test_vlm_family_and_gelu_mlp_now_build(change):
    """The vlm family and the gelu MLP, refused before they were ported,
    build and prefill on the CPU (held to JAX in tests/test_torch_families.py)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), **change)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    logits, cache = model.prefill(params, torch.zeros((1, 4), dtype=torch.int32),
                                  model.make_cache(1, 32, device="cpu", attn_chunk=32),
                                  attn_chunk=32)
    assert logits.shape == (1, cfg.vocab_size) and cache["length"].tolist() == [4]


@pytest.mark.parametrize("change", [
    {"backend": "cluster", "cluster": ClusterSpec(replicas=(_REMOTE,)), "faults": _KILL},
    {"backend": "transport",
     "cluster": ClusterSpec(replicas=(_REMOTE,), faults=FaultPolicy(respawn=True))},
    {"backend": "cluster", "cluster": ClusterSpec(replicas=2), "faults": _KILL},
    {"backend": "transport", "faults": _KILL},
    {"backend": "cluster", "cluster": ClusterSpec(replicas=2, faults=FaultPolicy(respawn=True))},
    {"backend": "transport", "cluster": ClusterSpec(faults=FaultPolicy(recover_streams=True))},
    {"backend": "cluster", "cluster": ClusterSpec(faults=FaultPolicy(heartbeat_interval_s=1.0))},
])
def test_fault_specs_build_as_in_the_jax_package(change):
    """The fault schedules and policies the port refused until the faults
    slice now build the JAX package's engine: a Router under the spec's
    FaultPolicy, with a ChaosInjector when a schedule is active (one
    transport replica under chaos keeps the Router; without a schedule it
    is the bare engine). With a remote replica the build gets as far as
    dialing its worker (nobody listens)."""
    spec = dataclasses.replace(ServeSpec.from_json(SPEC_JSON), **change)
    if spec.cluster.has_remote:
        with pytest.raises(ReplicaGone, match="cannot dial"):
            System.build(spec, device="cpu")
        return
    engine = System.build(spec, device="cpu").engine
    if spec.backend == "transport" and spec.cluster.n_replicas == 1 and not spec.faults.active:
        assert type(engine) is ServerEngine
        return
    assert isinstance(engine, Router) and engine.faults == spec.cluster.faults
    assert (engine.chaos is not None) == spec.faults.active


@pytest.mark.parametrize("change,engine", [
    ({"backend": "cluster"}, Router),
    ({"backend": "transport"}, ServerEngine),
    ({"fleet": dataclasses.replace(_FLEET, emulate_rates=True)}, ServerEngine),
    ({"fleet": _FLEET, "cluster": ClusterSpec(placement="class-affinity")}, ServerEngine),
    ({"backend": "cluster", "cluster": ClusterSpec(replicas=2)}, Router),
    ({"backend": "transport", "fleet": _FLEET}, ServerEngine),
])
def test_specs_refused_before_the_cluster_slice_build(change, engine):
    """The specs the port refused until the cluster and transport slice
    build, on the engine the JAX package builds for them (a bare engine
    for one transport replica, a Router for a cluster)."""
    spec = dataclasses.replace(ServeSpec.from_json(SPEC_JSON), **change)
    system = System.build(spec, device="cpu")
    assert type(system.engine) is engine


def _protocol_script(engine, spawn, prompts, max_new=8):
    """Two staggered devices through admission, verification, pipelined
    draft-ahead (device 0) and a §III-A fallback release + server resync
    (device 1, third tick). Returns each device's committed stream."""
    devices, done, now = {}, {}, 0.0
    for tick in range(1, 200):
        now = float(tick)
        for i in range(len(prompts)):
            if i not in devices and i not in done and i * 2 < now:
                assert engine.admit(i, prompts[i], now) is not None
                devices[i] = spawn(i, prompts[i])
        for i, dev in devices.items():
            if dev.awaiting:
                continue
            toks = dev.draft()
            if i == 1 and tick == 3:
                engine.force_extend(i, dev.fallback_release())
                continue
            engine.submit(i, toks, now)
            if i == 0:
                dev.draft_ahead()
        for v in engine.step(now) or []:
            dev = devices[v.device_id]
            nxt = dev.on_verdict(v)
            if len(dev.committed) >= max_new:
                done[v.device_id] = dev.committed[:max_new]
                engine.retire(v.device_id)
                del devices[v.device_id]
            elif nxt is not None:
                engine.submit(v.device_id, nxt, now)
                dev.draft_ahead()
        if len(done) == len(prompts):
            return done
    raise AssertionError("protocol script did not finish")


def test_engine_protocol_matches_jax():
    """ServerEngine + EdgeDevice driven through the same script in both
    packages (a draft noise with partial acceptance, so draft-ahead both
    hits and misses; one fallback resync): identical committed streams and
    engine counters."""
    from repro.core.server_engine import EdgeDeviceKit as JKit
    from repro.core.server_engine import ServerEngine as JEngine

    jspec = JServeSpec.from_json(SPEC_JSON)
    mb = jax_build_models(dataclasses.replace(jspec.model, draft_noise=0.08))
    pb = _port_bundle(mb)
    prompts = np.random.default_rng(9).integers(0, 128, size=(2, 10)).astype(np.int32)
    kw = dict(n_slots=2, max_len=64, k_max=4, attn_chunk=32)
    jeng = JEngine(mb.target, mb.target_params, **kw)
    jkit = JKit(mb.draft, mb.draft_params, k_max=4, c_th=0.3, attn_chunk=32)
    want = _protocol_script(jeng, lambda i, p: jkit.spawn(i, jnp.asarray(p), max_len=64, seed=i),
                            prompts)
    peng = ServerEngine(pb.target, pb.target_params, device="cpu", **kw)
    pkit = EdgeDeviceKit(pb.draft, pb.draft_params, k_max=4, c_th=0.3, attn_chunk=32, device="cpu")
    got = _protocol_script(peng, lambda i, p: pkit.spawn(i, p, max_len=64), prompts)
    _assert_same_tokens([got[0], got[1]], [want[0], want[1]], mb, prompts)
    js, ps = jeng.stats(), peng.stats()
    assert (ps.rounds, ps.fallback_tokens, ps.acceptance_rate) == (
        js.rounds, js.fallback_tokens, js.acceptance_rate)


def test_greedy_sled_equals_target_only_decoding():
    pb = build_models(ModelSpec(draft_noise=0.1), device="cpu")
    prompts = np.random.default_rng(4).integers(0, 256, size=(3, 12)).astype(np.int32)
    sled, stats = engine_loop.sled_generate(pb.draft, pb.draft_params, pb.target, pb.target_params,
                                            prompts, max_new=16, k_max=4, c_th=0.3)
    plain = engine_loop.autoregressive_generate(pb.target, pb.target_params, prompts, max_new=16)
    np.testing.assert_array_equal(sled, plain)
    assert stats.rounds > 0
