"""The port's hybrid family (zamba2) and gather/scatter verify, against the
JAX package.

Reduced zamba2-1.2b (4 SSD layers, the shared attention block after every
2, so 2 applications; d_model 64, 4 query heads on 4 KV heads of 16, d_inner
128 in 8 SSD heads of 16, state 16, chunk 16), vocab 64, ``max_len`` 32,
on weights bridged from the JAX package (``bridge.params_from_jax``). The
same numpy inputs go through the JAX ``hybrid`` (jitted, XLA on the CPU)
and the port on the CPU.

Tolerances: ``BF16_TOL`` (2e-2) for bf16 leaves (K/V, conv windows, the
state checkpoints), ``F32_TOL`` (2e-3) for f32 ones (logits, the SSD
state). The port rounds where the JAX path rounds, so what is left is f32
summation order: measured 1.0e-3 on the prefill logits, 5e-7 on the state
and one bf16 ulp on a few K/V entries.

Greedy streams are compared as ``tests/test_torch_serve.py`` compares them:
identical, or a first divergence at a printed near tie (``TIE_TOL``).
"""
import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.api import ServeSpec as JServeSpec
from repro.api import System as JSystem
from repro.core import drafting as jdrafting
from repro.models import hybrid as jhybrid
from repro.transport import codec as jcodec
from repro_torch import bridge
from repro_torch.api import ServeSpec, System, build_models
from repro_torch.api.spec import ClusterSpec
from repro_torch.cluster.router import LocalReplica
from repro_torch.core import drafting, verification
from repro_torch.core.server_engine import ServerEngine
from repro_torch.models import hybrid
from repro_torch.models.kvcache import supports_paged_attention
from repro_torch.transport import codec
from repro_torch.transport.worker import row_to_wire, stream_to_state
from test_torch_serve import SPEC_JSON, _assert_same_tokens, _port_bundle

BF16_TOL = 2e-2
F32_TOL = 2e-3
V = 64
MAX_LEN = 32
CHUNK = 32  # attn_chunk: the cache rounds max_len up to it
NOISE = 0.1  # the draft's perturbation: drafts both accepted and rejected


def _specs(arch="zamba2-1.2b", draft_arch="zamba2-1.2b", **changes):
    """(JAX spec, port spec): engine.json with the model swapped, at the
    reduced config's depth (zamba2: 4 layers), vocab 64."""
    out = []
    for cls in (JServeSpec, ServeSpec):
        spec = cls.from_json(SPEC_JSON)
        model = dataclasses.replace(spec.model, arch=arch, draft_arch=draft_arch, vocab_size=V,
                                    target_layers=None)  # the reduced config's depth
        out.append(dataclasses.replace(spec, model=model, **changes))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_bundle(mspec):
    """The JAX package's ``build_models(mspec)`` (a JAX ModelSpec) with its
    inits and the draft's perturbation jitted: the same weights, built in
    seconds instead of op by op."""
    from repro.api.system import ModelBundle as JModelBundle
    from repro.configs.base import get_config as jax_config
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.models.model_zoo import perturb_params

    tcfg = dataclasses.replace(jax_config(mspec.arch).reduced(), vocab_size=mspec.vocab_size)
    if mspec.target_layers is not None:
        tcfg = dataclasses.replace(tcfg, num_layers=mspec.target_layers)
    dcfg = dataclasses.replace(jax_config(mspec.draft_arch).reduced(), name="edge-draft",
                               vocab_size=mspec.vocab_size)
    if mspec.draft_layers is not None:
        dcfg = dataclasses.replace(dcfg, num_layers=mspec.draft_layers)
    target, draft = jax_build_model(tcfg), jax_build_model(dcfg)
    tp = jax.jit(target.init_params)(jax.random.key(mspec.seed))
    dp = jax.jit(lambda k: perturb_params(draft.init_params(k), mspec.draft_noise))(
        jax.random.key(mspec.seed + 1))
    return JModelBundle(tcfg, dcfg, target, draft, tp, dp)


@functools.lru_cache(maxsize=None)
def _bundles(mspec):
    """(JAX bundle, its bridge into the port) for a JAX ModelSpec."""
    mb = _jax_bundle(mspec)
    return mb, _port_bundle(mb)


def _pair():
    """The hybrid pair of ``_specs()``, its draft perturbed by ``NOISE``."""
    jspec, _ = _specs()
    return _bundles(dataclasses.replace(jspec.model, draft_noise=NOISE))


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0, err_msg=what)


def test_config_is_the_published_one():
    """zamba2-1.2b at its published widths, the port's own copy, and the
    reduced widths these tests run."""
    from repro.configs.base import get_config as jax_config
    from repro_torch.configs import get_config

    cfg = get_config("zamba2-1.2b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config("zamba2-1.2b"))
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.ssm_state, cfg.ssm_head_dim,
            cfg.ssm_heads, cfg.attn_every, cfg.tie_embeddings) == (
        "hybrid", 38, 2048, 32, 32, 64, 8192, 32000, 64, 64, 64, 6, False)
    assert hybrid.n_apps(cfg) == 6 and not supports_paged_attention(cfg)
    red = cfg.reduced()
    assert (red.num_layers, red.attn_every, red.ssm_head_dim, red.ssm_state, red.ssm_chunk,
            red.ssm_heads, red.num_heads, red.num_kv_heads, red.head_dim) == (
        4, 2, 16, 16, 16, 8, 4, 4, 16)


@functools.lru_cache(maxsize=None)
def _prefill_decode():
    """Prefill 21 tokens (1.3 scan chunks) and a verify-shaped decode of 5
    in both packages, with the JAX commits at every acceptance count."""
    mb, pb = _pair()
    jm, jp = mb.target, mb.target_params
    rng = np.random.default_rng(0)
    toks = rng.integers(0, V, size=(2, 21)).astype(np.int32)
    fresh = rng.integers(0, V, size=(2, 5)).astype(np.int32)

    @jax.jit
    def jax_side(p, t, f, c):
        logits, c = jm.prefill(p, t, c, attn_chunk=CHUNK)
        h, ck, _ = jm.decode_forward(p, c, f, attn_chunk=CHUNK)
        sel = [jhybrid.select_checkpoint(ck, jnp.full((2,), n, jnp.int32)) for n in range(1, 6)]
        return logits, c, jm.lm_head(p, h), ck, sel

    want = jax_side(jp, jnp.asarray(toks), jnp.asarray(fresh),
                    jm.make_cache(2, MAX_LEN, attn_chunk=CHUNK))
    pm, pp = pb.target, pb.target_params
    pl, pc = pm.prefill(pp, torch.from_numpy(toks),
                        pm.make_cache(2, MAX_LEN, device="cpu", attn_chunk=CHUNK),
                        attn_chunk=CHUNK)
    # the decode writes its K/V rows in place: it runs on a copy
    h, pck = pm.decode_forward(pp, {k: v.clone() for k, v in pc.items()},
                               torch.from_numpy(fresh), attn_chunk=CHUNK)
    return want, (pl, pc, pm.lm_head(pp, h), pck)


def test_prefill_logits_and_cache_leaves_match_jax():
    (jl, jc, *_), (pl, pc, *_) = _prefill_decode()
    assert sorted(pc) == sorted(jc) == ["conv", "k", "length", "ssm", "v"]
    assert pc["k"].shape == (2, 2, MAX_LEN, 4, 16) and pc["k"].dtype == torch.bfloat16
    assert pc["ssm"].dtype == torch.float32 and pc["conv"].dtype == torch.bfloat16
    _close(pl, jl, F32_TOL, "logits")
    _close(pc["ssm"], jc["ssm"], F32_TOL, "ssm")
    for name in ("conv", "k", "v"):
        _close(pc[name], jc[name], BF16_TOL, name)
    np.testing.assert_array_equal(pc["length"].numpy(), np.asarray(jc["length"]))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_decode_and_select_checkpoint_match_jax(n):
    """The K+1 = 5 token decode's logits and checkpoints, and the commit of
    ``n`` tokens: the f32 state is the bf16 checkpoint widened back, the K/V
    leaves are the decode's own."""
    (_, _, jl2, jck, jsel), (_, _, pl2, pck) = _prefill_decode()
    _close(pl2, jl2, F32_TOL, "decode logits")
    assert pck["ssm_ckpt"].dtype == torch.bfloat16 and pck["ssm_ckpt"].shape[:3] == (4, 2, 5)
    for name in ("ssm_ckpt", "conv_ckpt", "k", "v"):
        _close(pck[name], jck[name], BF16_TOL, name)
    got = hybrid.select_checkpoint(pck, torch.full((2,), n, dtype=torch.int32))
    want = jsel[n - 1]
    assert sorted(got) == sorted(want) == ["conv", "k", "length", "ssm", "v"]
    assert torch.equal(got["ssm"], pck["ssm_ckpt"][:, :, n - 1].float())
    assert got["k"] is pck["k"]
    _close(got["ssm"], want["ssm"], BF16_TOL, "ssm")
    _close(got["conv"], want["conv"], BF16_TOL, "conv")
    np.testing.assert_array_equal(got["length"].numpy(), np.asarray(want["length"]))


def test_decode_forward_refuses_slots():
    _, pb = _pair()
    pm = pb.target
    cache = pm.make_cache(2, MAX_LEN, device="cpu", attn_chunk=CHUNK)
    with pytest.raises(NotImplementedError, match="gather/scatter"):
        pm.decode_forward(pb.target_params, cache, torch.zeros((2, 5), dtype=torch.int32),
                          slots=torch.tensor([0, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="int8"):
        pm.make_cache(2, MAX_LEN, device="cpu", kv_dtype="int8")


@pytest.mark.parametrize("which", ["draft", "target"])
def test_draft_round_and_rollback_match_jax(which):
    """A drafting round and its rollback to each acceptance count (0 .. 4,
    the last clamped as JAX's gather clamps it). ``draft``: the spec's
    1-layer draft, no application of the shared block (empty K/V leaves);
    ``target``: 4 layers, 2 applications, whose K/V roll back by length in
    the port (JAX checkpoints them): equal on every valid position."""
    mb, pb = _pair()
    jm, jp = (mb.draft, mb.draft_params) if which == "draft" else (mb.target, mb.target_params)
    pm, pp = (pb.draft, pb.draft_params) if which == "draft" else (pb.target, pb.target_params)
    prompt = np.random.default_rng(1).integers(0, V, size=(5, 12)).astype(np.int32)
    n_acc = np.array([0, 1, 2, 3, 4], np.int32)

    @jax.jit
    def jax_side(p, t, c, n):
        _, c = jm.prefill(p, t[:, :-1], c, attn_chunk=CHUNK)
        d = jdrafting.draft_round(jm, p, c, t[:, -1], jax.random.key(0), k_max=4, c_th=0.0,
                                  greedy=True, attn_chunk=CHUNK)
        return d.tokens, jdrafting.resume_after_verify(jm, d, n)

    jt, jres = jax_side(jp, jnp.asarray(prompt), jm.make_cache(5, MAX_LEN, attn_chunk=CHUNK),
                        jnp.asarray(n_acc))
    _, pc = pm.prefill(pp, torch.from_numpy(prompt[:, :-1]),
                       pm.make_cache(5, MAX_LEN, device="cpu", attn_chunk=CHUNK),
                       attn_chunk=CHUNK)
    d = drafting.draft_round(pm, pp, pc, torch.from_numpy(prompt[:, -1]), k_max=4, c_th=0.0,
                             attn_chunk=CHUNK)
    assert sorted(d.cache_ckpts) == ["conv", "length", "ssm"]  # K/V roll back by length
    np.testing.assert_array_equal(d.tokens.numpy(), np.asarray(jt))
    res = drafting.resume_after_verify(d, torch.from_numpy(n_acc))
    apps = 0 if which == "draft" else 2
    assert res["k"].shape == (apps, 5, MAX_LEN, 4, 16) == tuple(jres["k"].shape)
    _close(res["ssm"], jres["ssm"], BF16_TOL, "ssm")
    _close(res["conv"], jres["conv"], BF16_TOL, "conv")
    np.testing.assert_array_equal(res["length"].numpy(), np.asarray(jres["length"]))
    for b, n in enumerate(res["length"].tolist()):
        for name in ("k", "v"):
            _close(res[name][:, b, :n], jres[name][:, b, :n], BF16_TOL, f"{name} row {b}")


def _prompts(jspec) -> np.ndarray:
    return np.random.default_rng(5).integers(
        0, jspec.model.vocab_size, size=(jspec.devices, jspec.prompt_len)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_streams(jspec):
    """The JAX engine's streams of ``jspec`` on ``_prompts`` (the JAX
    package's own tests hold them to its reference)."""
    mb, _ = _bundles(jspec.model)
    return JSystem.build(jspec.with_backend("engine"), models=mb).serve(_prompts(jspec)).outputs


def _hybrid_specs():
    """Four devices, 12 tokens each, the draft perturbed by ``NOISE``."""
    return tuple(dataclasses.replace(s, model=dataclasses.replace(s.model, draft_noise=NOISE))
                 for s in _specs(devices=4, max_new=12, max_len=64))


def test_engine_streams_equal_the_jax_engines():
    """The engine backend (gather/scatter verify with state checkpoints) on
    the hybrid pair: the JAX engine's greedy streams, with drafts both
    accepted and rejected."""
    jspec, pspec = _hybrid_specs()
    mb, pb = _bundles(jspec.model)
    want = _jax_streams(jspec)
    prompts = _prompts(jspec)
    eng = System.build(pspec, models=pb, device="cpu").serve(prompts)
    got = [eng.outputs[i] for i in range(jspec.devices)]
    _assert_same_tokens(got, [want[i] for i in range(jspec.devices)], mb, prompts)
    assert all(len(t) == 12 for t in got)
    assert 0 < eng.engine.acceptance_rate < 1


def test_cluster_migrating_a_hybrid_stream_gives_the_jax_streams():
    """The four devices on 2 replicas x 2 slots; even ids stop after 4
    tokens and odd ids after 12, so the replica holding the even ids
    empties and retirement migrates hybrid rows (f32 state, bf16 conv and
    K/V) between pools; every stream is the JAX engine's."""
    jspec, pspec = _hybrid_specs()
    mb, pb = _bundles(jspec.model)
    ref = _jax_streams(jspec)
    prompts = _prompts(jspec)
    system = System.build(dataclasses.replace(pspec, backend="cluster",
                                              cluster=ClusterSpec(replicas=2)),
                          models=pb, device="cpu")
    budgets = [4 if i % 2 == 0 else 12 for i in range(4)]
    sessions = [system.open_session(prompts[i], device_id=i, max_new=budgets[i])
                for i in range(4)]
    gens = [s.generate() for s in sessions]
    while not all(s.done for s in sessions):
        for s, g in zip(sessions, gens):
            if not s.done:
                next(g, None)
    assert system.engine.migrations >= 1
    _assert_same_tokens([sessions[i].result.tokens for i in range(4)],
                        [ref[i][:budgets[i]] for i in range(4)], mb, prompts)


def test_hybrid_row_crosses_the_codec_as_the_jax_encoder_writes_it():
    """A served pool row (ssm f32, conv/K/V bf16, length) in an ImportStream
    frame: the same bytes as the JAX encoder's for the same row, and decoded
    back bit for bit."""
    _, pspec = _specs(devices=2, max_new=6, max_len=64)
    engine = System.build(pspec, models=_pair()[1], device="cpu").engine
    prompt = np.arange(pspec.prompt_len, dtype=np.int32) % V
    engine.admit(0, prompt, 0.0)
    engine.submit(0, np.asarray([3, 5], np.int32), 0.0)
    engine.step(0.5)
    stream, row = engine.export_stream(0)
    assert {n: row[n].dtype for n in row} == {
        "ssm": torch.float32, "conv": torch.bfloat16, "k": torch.bfloat16,
        "v": torch.bfloat16, "length": torch.int32}
    wire = row_to_wire(row)
    mine = codec.ImportStream(stream_to_state(stream, wire))
    jrow = {n: (leaf.words.view(ml_dtypes.bfloat16) if isinstance(leaf, codec.BF16Words)
                else leaf) for n, leaf in wire.items()}
    theirs = jcodec.ImportStream(jcodec.StreamState(**{
        f.name: getattr(mine.stream, f.name) for f in dataclasses.fields(codec.StreamState)
        if f.name != "row"}, row=jrow))
    frame = codec.encode_frame(mine)
    assert frame == jcodec.encode_frame(theirs)
    back = codec.decode_frame(frame)[0].stream.row
    for name, leaf in wire.items():
        got = back[name]
        if isinstance(leaf, codec.BF16Words):
            np.testing.assert_array_equal(got.words, leaf.words)
        else:
            assert got.dtype == leaf.dtype
            np.testing.assert_array_equal(got.view(np.uint8), leaf.view(np.uint8))


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_recurrent_families_fall_back_to_gather(arch, caplog):
    """The twins of the JAX package's tests/test_server_engine.py
    ``test_ssm_family_falls_back_to_gather`` and tests/test_api.py
    ``test_paged_attention_fallback_warning``: the verify step refuses the
    slot-indexed path even when asked for it, the engine (and a replica's
    fingerprint) report it, and System.build names the fallback."""
    _, pspec = _specs(arch=arch, draft_arch=arch, devices=1)
    models = build_models(pspec.model, device="cpu")
    step = verification.make_paged_verify_step(models.target, scratch_slot=2, attn_chunk=32,
                                               paged_attention=True)
    assert not step.paged_attention
    engine = ServerEngine(models.target, models.target_params, n_slots=2, max_len=64, k_max=4,
                          attn_chunk=32, device="cpu")
    assert not engine.paged_attention and not engine.core.steps.paged_attention
    assert LocalReplica(engine).fingerprint[3] is False
    with caplog.at_level(logging.WARNING, logger="repro_torch.api.system"):
        system = System.build(pspec, models=models, device="cpu")
    assert any("gather/scatter" in r.getMessage() for r in caplog.records), \
        "System.build must name the paging fallback for ssm and hybrid families"
    assert not system.engine.paged_attention
    with pytest.raises(ValueError, match="int8"):
        System.build(dataclasses.replace(pspec, kv_dtype="int8"), models=models, device="cpu")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_dense_gather_verify_equals_paged_and_jax(kv_dtype):
    """``paged_attention=False`` on the reduced qwen2: the engine gathers and
    scatters pool rows (no slot-indexed forward) and commits the paged
    engine's streams, and on the bf16 pool the JAX engine's with the same
    flag."""
    jspec, pspec = (dataclasses.replace(s, devices=3, max_new=12, kv_dtype=kv_dtype,
                                        paged_attention=False,
                                        model=dataclasses.replace(s.model, draft_noise=NOISE))
                    for s in (JServeSpec.from_json(SPEC_JSON), ServeSpec.from_json(SPEC_JSON)))
    mb, pb = _bundles(jspec.model)
    prompts = _prompts(jspec)
    system = System.build(pspec, models=pb, device="cpu")
    assert not system.engine.paged_attention
    got = system.serve(prompts)
    paged = System.build(dataclasses.replace(pspec, paged_attention=True), models=pb,
                         device="cpu")
    assert paged.engine.paged_attention
    want = paged.serve(prompts).outputs
    _assert_same_tokens([got.outputs[i] for i in range(3)], [want[i] for i in range(3)], mb,
                        prompts, jnp.int8 if kv_dtype == "int8" else jnp.bfloat16)
    if kv_dtype == "bf16":
        jeng = _jax_streams(jspec)
        _assert_same_tokens([got.outputs[i] for i in range(3)], [jeng[i] for i in range(3)],
                            mb, prompts)
    assert 0 < got.engine.acceptance_rate < 1
