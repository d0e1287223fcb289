"""The vlm family and the last dense configs of the port against the JAX
package: llava-next-mistral-7b (vlm: the mistral backbone behind a stub
frontend of patch embeddings), phi3-mini-3.8b, granite-34b (the gelu MLP,
MQA) and qwen1.5-32b.

Reduced configs (2 layers, d_model 64, 4 query heads of 16, vocab 128; the
reduced granite-34b keeps its one KV head, the reduced llava 8 patches), on
weights bridged from the JAX package (``bridge.params_from_jax``). Two
widened one-layer configs reach the card's new kernel shapes on the CPU:
head_dim 96 (phi3-mini's) and 48 query heads on 1 KV head (granite-34b's
G = 48). The same numpy inputs go through the JAX functions (jitted, XLA on
the CPU) and the port on the CPU.

Tolerances: ``BF16_TOL`` (2e-2) for bf16 outputs and K/V, ``F32_TOL``
(2e-3) for f32 logits. ``gelu`` is held bit for bit, except where the two
libraries' ``tanh`` of the same bf16 argument differ (counted, and bounded
by ``TANH_SHARE``). Greedy streams are compared as
``tests/test_torch_serve.py`` compares them: identical, or a first
divergence at a printed near tie.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ServeSpec as JServeSpec
from repro.api import System as JSystem
from repro.api.system import ModelBundle as JModelBundle
from repro.configs.base import get_config as jax_config
from repro.core import verification as jax_verification
from repro.models import layers as JL
from repro.models.model_zoo import build_model as jax_build_model
from repro.models.model_zoo import frontend_stub as jax_frontend_stub
from repro.models.model_zoo import perturb_params
from repro_torch import bridge
from repro_torch.api import ServeSpec, System
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import verification
from repro_torch.models import layers as L
from repro_torch.models.kvcache import PagedKVCache
from repro_torch.models.model_zoo import build_model, frontend_stub
from test_torch_serve import SPEC_JSON, _assert_same_tokens, _port_bundle

BF16_TOL = 2e-2
F32_TOL = 2e-3
# the share of bf16 arguments whose tanh may round differently in the two
# libraries (0 of 65,536 in this repo's runs); gelu must be bit-equal elsewhere
TANH_SHARE = 1e-2
# the served drafts' perturbation (see _bundles)
NOISE = 0.005
V = 128
CHUNK = 32
MAX_LEN = 64
ARCHS = ("llava-next-mistral-7b", "phi3-mini-3.8b", "granite-34b", "qwen1.5-32b")
# per arch: (family, layers, d_model, query heads, KV heads, head_dim, d_ff,
# vocab, act, QKV bias, tied head, patches)
PUBLISHED = {
    "llava-next-mistral-7b": ("vlm", 32, 4096, 32, 8, 128, 14336, 32000, "swiglu", False, False,
                              576),
    "phi3-mini-3.8b": ("dense", 32, 3072, 32, 32, 96, 8192, 32064, "swiglu", False, False, 0),
    "granite-34b": ("dense", 88, 6144, 48, 1, 128, 24576, 49152, "gelu", False, False, 0),
    "qwen1.5-32b": ("dense", 64, 5120, 40, 40, 128, 27392, 152064, "swiglu", True, False, 0),
}
# the widened one-layer configs: head_dim 96 (2 heads of 96 on 2) and G = 48
# (48 query heads of 16 on 1 KV head, the gelu MLP)
WIDE = {
    "head_dim-96": ("phi3-mini-3.8b", dict(num_heads=2, num_kv_heads=2, d_head=96)),
    "G-48": ("granite-34b", dict(num_heads=48, num_kv_heads=1, d_head=16)),
}


def _reduced(arch: str, **changes):
    """The JAX reduced config at vocab ``V``, with ``changes``."""
    return dataclasses.replace(jax_config(arch).reduced(), vocab_size=V, **changes)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0, err_msg=what)


def _bits(a) -> np.ndarray:
    """bf16 values as their 16 bits, from torch or JAX."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _scaled(leaf, gain: float):
    return (leaf.astype(jnp.float32) * gain).astype(leaf.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax(arch):
    """The port's copy of each config: every field, the parameter count
    (the JAX count, gated MLP and all, kept for parity), the published
    widths, and the reduced widths these tests run."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.act, cfg.qkv_bias, cfg.tie_embeddings,
            cfg.num_patches) == PUBLISHED[arch]
    red = cfg.reduced()
    assert dataclasses.asdict(red) == dataclasses.asdict(jcfg.reduced())
    assert (red.num_heads, red.head_dim) == (4, 16)


def test_gelu_equals_jax_bit_for_bit_outside_tanh():
    """``layers.gelu`` against ``jax.nn.gelu(approximate=True)`` on 65,536
    bf16 values (N(0, 3) and the edges of its range): every value bit-equal
    where the two libraries' tanh of the same argument agree; those where
    they differ are counted and stay under ``TANH_SHARE``. The one-rounding
    ``F.gelu`` does not follow the JAX chain (printed)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(65_536 - 8) * 3,
                        [0.0, -0.0, 1e-3, -1e-3, 8.0, -8.0, 60.0, -60.0]]).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = bridge.to_tensor(np.asarray(xj))
    want = _bits(jax.jit(lambda a: jax.nn.gelu(a, approximate=True))(xj))
    got = L.gelu(xt)
    assert got.dtype == torch.bfloat16
    # the argument of tanh, as the JAX chain rounds it (the port's own steps)
    c3 = torch.tensor(0.044715, dtype=torch.bfloat16)
    c1 = torch.tensor(float(np.sqrt(2 / np.pi)), dtype=torch.bfloat16)
    arg = c1 * (xt + c3 * (xt * xt * xt))
    tanh_differs = _bits(torch.tanh(arg)) != _bits(jnp.tanh(jnp.asarray(_bits(arg).view(
        jnp.bfloat16))))
    differs = _bits(got) != want
    fused = int((_bits(torch.nn.functional.gelu(xt, approximate="tanh")) != want).sum())
    print(f"gelu: {int(differs.sum())} of {x.size} differ, {int(tanh_differs.sum())} tanh "
          f"results differ; F.gelu differs on {fused}")
    assert not (differs & ~tanh_differs).any()
    assert tanh_differs.sum() <= TANH_SHARE * x.size


def test_gelu_mlp_block_equals_jax():
    """The gelu MLP (``wi``, ``wd``) against the JAX ``mlp_block``, its
    tables scaled so that gelu sees O(1) inputs and the outputs are O(1)."""
    jcfg = _reduced("granite-34b")
    jp = JL.init_mlp(jax.random.key(3), jcfg)
    jp = {"wi": _scaled(jp["wi"], 8.0), "wd": _scaled(jp["wd"], 16.0)}
    mlp = L.MLP(_port_cfg(jcfg))
    assert mlp.wg is None and mlp.wu is None
    with torch.no_grad():
        for name in ("wi", "wd"):
            getattr(mlp, name).copy_(bridge.to_tensor(np.asarray(jp[name])))
    x = jnp.asarray(np.random.default_rng(4).standard_normal((3, 7, jcfg.d_model)), jnp.bfloat16)
    want = jax.jit(lambda a, p: JL.mlp_block(a, p, jcfg))(x, jp)
    got = mlp(bridge.to_tensor(np.asarray(x)))
    assert got.dtype == torch.bfloat16 and np.abs(_f32(want)).max() > 0.5
    _close(got, want, BF16_TOL, "gelu mlp")


@functools.lru_cache(maxsize=None)
def _model_pair(arch: str, wide: str = ""):
    """(JAX config, model, params; port config, model, params) of the
    reduced ``arch`` (or the widened one-layer config ``wide``)."""
    jcfg = _reduced(arch) if not wide else _reduced(WIDE[wide][0], num_layers=1,
                                                     **WIDE[wide][1])
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init_params)(jax.random.key(0))
    cfg = _port_cfg(jcfg)
    return (jcfg, jm, jp, cfg, build_model(cfg),
            bridge.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu"))


def _prefill_decode_commit(arch: str, wide: str, prefix: bool):
    """Prefill a (2, 10) prompt (behind JAX's stub patches when
    ``prefix``), then a verify-shaped dense decode (S = 5) after the rows
    rolled back to uneven lengths, then commit [5, 2]: logits, K/V and the
    cache length against JAX at each step."""
    jcfg, jm, jp, cfg, pm, pp = _model_pair(arch, wide)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, V, size=(2, 10)).astype(np.int32)
    fresh = rng.integers(0, V, size=(2, 5)).astype(np.int32)
    stub = jax_frontend_stub(jcfg, 2, jax.random.key(7)) if prefix else None
    P = stub.shape[1] if prefix else 0
    lengths = np.array([P + 10, P + 7], np.int32)

    @jax.jit
    def jax_side(p, t, f, s):
        logits, c = jm.prefill(p, t, jm.make_cache(2, MAX_LEN, attn_chunk=CHUNK),
                               attn_chunk=CHUNK, embeds_prefix=s)
        h, c2, _ = jm.decode_forward(p, {**c, "length": jnp.asarray(lengths)}, f,
                                     attn_chunk=CHUNK)
        c2 = jm.commit(c2, jnp.asarray([5, 2]))
        return logits, c, jm.lm_head(p, h), c2

    jl, jc, jl2, jc2 = jax_side(jp, jnp.asarray(prompt), jnp.asarray(fresh), stub)
    kw = {} if stub is None else {"embeds_prefix": bridge.to_tensor(np.asarray(stub))}
    pl, pc = pm.prefill(pp, torch.from_numpy(prompt),
                        pm.make_cache(2, MAX_LEN, device="cpu", attn_chunk=CHUNK),
                        attn_chunk=CHUNK, **kw)
    assert pc["length"].tolist() == [P + 10] * 2 == np.asarray(jc["length"]).tolist()
    _close(pl, jl, F32_TOL, "prefill logits")
    for name in ("k", "v"):
        _close(pc[name], jc[name], BF16_TOL, f"prefill {name}")
    h, pc = pm.decode_forward(pp, {**pc, "length": torch.from_numpy(lengths)},
                              torch.from_numpy(fresh), attn_chunk=CHUNK)
    _close(pm.lm_head(pp, h), jl2, F32_TOL, "decode logits")
    pc = pm.commit(pc, torch.tensor([5, 2]))
    assert pc["length"].tolist() == [P + 15, P + 9] == np.asarray(jc2["length"]).tolist()
    for name in ("k", "v"):
        _close(pc[name], jc2[name], BF16_TOL, f"decode {name}")
    return jcfg, jm, jp, pm, pp, pc


PREFILL_CASES = [("llava-next-mistral-7b", True), ("llava-next-mistral-7b", False),
                 ("phi3-mini-3.8b", False), ("granite-34b", False), ("qwen1.5-32b", False)]


@pytest.mark.parametrize("arch,prefix", PREFILL_CASES)
def test_prefill_decode_and_commit_match_jax(arch, prefix):
    """Each reduced config (llava with and without its stub patches):
    prefill, a verify-shaped decode and the commit, against JAX."""
    _prefill_decode_commit(arch, "", prefix)


@pytest.mark.parametrize("wide", sorted(WIDE))
def test_widened_shapes_match_jax(wide):
    """head_dim 96 and G = 48 on the CPU: prefill, dense decode and commit
    (``_prefill_decode_commit``), then a slot-indexed decode against a pool
    (slots out of order, the scratch row padding the bucket), against JAX."""
    jcfg, jm, jp, pm, pp, _ = _prefill_decode_commit(WIDE[wide][0], wide, False)
    assert jcfg.head_dim == (96 if wide == "head_dim-96" else 16)
    assert jcfg.num_heads // jcfg.num_kv_heads == (1 if wide == "head_dim-96" else 48)
    rng = np.random.default_rng(2)
    n_slots = 3
    pool_np = jax.tree.map(np.array, jm.make_cache(n_slots + 1, MAX_LEN, attn_chunk=CHUNK))
    for name in ("k", "v"):
        pool_np[name][:] = rng.standard_normal(pool_np[name].shape).astype(pool_np[name].dtype)
    pool_np["length"][:] = [9, 12, 6, 0]
    slots = np.array([2, 0, 1, n_slots], np.int32)
    fresh = rng.integers(0, V, size=(4, 5)).astype(np.int32)

    @jax.jit
    def jax_side(p, c, t, s):
        h, c, _ = jm.decode_forward(p, c, t, attn_chunk=CHUNK, slots=s)
        return jm.lm_head(p, h), c

    jl, jc = jax_side(jp, jax.tree.map(jnp.asarray, pool_np), jnp.asarray(fresh),
                      jnp.asarray(slots))
    pool = PagedKVCache(pm, n_slots, MAX_LEN, device="cpu", attn_chunk=CHUNK)
    pool.cache = bridge.cache_from_jax(pool_np, device="cpu")
    h, after = pm.decode_forward(pp, pool.cache, torch.from_numpy(fresh), attn_chunk=CHUNK,
                                 slots=torch.from_numpy(slots))
    _close(pm.lm_head(pp, h)[:3], np.asarray(jl)[:3], F32_TOL, "slot logits")
    for name in ("k", "v"):
        _close(after[name][:, :n_slots], np.asarray(jc[name])[:, :n_slots], BF16_TOL, name)


def test_prefill_step_with_frontend_equals_jax():
    """``make_prefill_step(with_frontend=True)``: a vlm prompt behind the
    stub patches leaves the cache at P + prompt - 1 and returns the last
    token, as the JAX step does; a family without a frontend ignores it."""
    jcfg, jm, jp, cfg, pm, pp = _model_pair("llava-next-mistral-7b")
    tokens = np.random.default_rng(6).integers(0, V, size=(2, 11)).astype(np.int32)
    stub = jax_frontend_stub(jcfg, 2, jax.random.key(7))
    jstep = jax_verification.make_prefill_step(jm, attn_chunk=CHUNK, with_frontend=True)
    jl, jc, jlast = jax.jit(jstep)(jp, jm.make_cache(2, MAX_LEN, attn_chunk=CHUNK),
                                   jnp.asarray(tokens), stub)
    step = verification.make_prefill_step(pm, attn_chunk=CHUNK, with_frontend=True)
    pl, pc, plast = step(pp, pm.make_cache(2, MAX_LEN, device="cpu", attn_chunk=CHUNK),
                         torch.from_numpy(tokens), bridge.to_tensor(np.asarray(stub)))
    assert pc["length"].tolist() == np.asarray(jc["length"]).tolist() == [8 + 10] * 2
    assert plast.tolist() == np.asarray(jlast).tolist()
    _close(pl, jl, F32_TOL, "logits")
    _close(pc["k"], jc["k"], BF16_TOL, "k")
    _, gm, _, _, gpm, gpp = _model_pair("granite-34b")
    with_fe, without = (verification.make_prefill_step(gpm, attn_chunk=CHUNK, with_frontend=f)(
        gpp, gpm.make_cache(2, MAX_LEN, device="cpu", attn_chunk=CHUNK),
        torch.from_numpy(tokens), None) for f in (True, False))
    assert torch.equal(with_fe[0], without[0]) and with_fe[1]["length"].tolist() == [10, 10]


def test_frontend_stub_and_refusals():
    """The port's stub: (B, num_patches, d) bf16 at N(0, 0.02) for vlm, None
    without a frontend; encdec (once refused here) builds, stubs its
    (B, encoder_seq, d) frames and bridges the JAX tree, and
    ``System.build`` refuses it (a serve carries no encoder frames;
    tests/test_torch_encdec.py holds the family to JAX)."""
    gen = torch.Generator().manual_seed(0)
    stub = frontend_stub(get_config("llava-next-mistral-7b"), 2, gen)
    assert stub.shape == (2, 576, 4096) and stub.dtype == torch.bfloat16
    assert abs(stub.float().std().item() - 0.02) < 1e-3
    assert frontend_stub(get_config("granite-34b"), 2, gen) is None
    jwhisper = jax_config("whisper-tiny").reduced()
    whisper = _port_cfg(jwhisper)
    params = build_model(whisper).init_params(gen, max_pos=16)
    assert params.enc is not None and params.pos_embed.shape == (16, whisper.d_model)
    frames = frontend_stub(whisper, 1, gen)
    assert frames.shape == (1, whisper.encoder_seq, whisper.d_model)
    assert frames.dtype == torch.bfloat16
    jp = jax.jit(functools.partial(jax_build_model(jwhisper).init_params, max_pos=16))(
        jax.random.key(0))
    bridged = bridge.params_from_jax(whisper, jax.tree.map(np.asarray, jp), device="cpu")
    assert sorted(bridged.state_dict()) == sorted(params.state_dict())
    spec = ServeSpec.from_json(SPEC_JSON)
    with pytest.raises(ValueError, match="encoder frames"):
        System.build(dataclasses.replace(spec, model=dataclasses.replace(
            spec.model, arch="whisper-tiny", draft_arch="whisper-tiny")), device="cpu")
    with pytest.raises(ValueError, match="unknown act"):
        L.MLP(dataclasses.replace(get_config("granite-34b").reduced(), act="relu"))


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "granite-34b"])
def test_bridge_round_trips_both_ways(arch):
    """A vlm tree and a gelu tree: JAX -> port -> JAX gives the JAX leaves
    bit for bit, and port -> JAX -> port the port's weights."""
    jcfg, _, jp, cfg, pm, pp = _model_pair(arch)
    tree = jax.tree.map(np.asarray, jp)
    back = bridge.params_to_jax(pp)
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(_bits(w) if w.dtype.name ==
                                                            "bfloat16" else w, g), tree, back)
    assert sorted(back["layers"]["mlp"]) == (["wd", "wi"] if jcfg.act == "gelu"
                                             else ["wd", "wg", "wu"])
    own = pm.init_params(torch.Generator().manual_seed(3))
    again = bridge.params_from_jax(cfg, {k: _as_bf16(v) for k, v in
                                         bridge.params_to_jax(own).items()}, device="cpu")
    for (name, a), (_, b) in zip(own.state_dict().items(), again.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _as_bf16(tree):
    """A ``params_to_jax`` tree with its uint16 bits viewed as bf16 again."""
    if isinstance(tree, dict):
        return {k: _as_bf16(v) for k, v in tree.items()}
    return tree.view(jnp.bfloat16) if tree.dtype == np.uint16 else tree


@functools.lru_cache(maxsize=None)
def _bundles(arch: str):
    """(JAX bundle, port bundle): the reduced target of ``arch`` and a draft
    made of its embedding, first layer, norm and head, perturbed by
    ``NOISE``. The JAX ``build_models`` draft is an independent init, which
    never agrees with an untied target, so no draft would be accepted."""
    jcfg, jm, jp, _, _, _ = _model_pair(arch)
    dcfg = dataclasses.replace(jcfg, name="edge-draft", num_layers=1)
    dp = jax.jit(lambda p: perturb_params(p, NOISE))(
        {**jp, "layers": jax.tree.map(lambda a: a[:1], jp["layers"])})
    mb = JModelBundle(jcfg, dcfg, jm, jax_build_model(dcfg), jp, dp)
    return mb, _port_bundle(mb)


def _specs(arch: str, kv_dtype: str):
    """(JAX spec, port spec): engine.json with ``arch`` as target and draft
    at the reduced widths, vocab ``V``, 12 new tokens."""
    out = []
    for cls in (JServeSpec, ServeSpec):
        spec = cls.from_json(SPEC_JSON)
        model = dataclasses.replace(spec.model, arch=arch, draft_arch=arch, vocab_size=V)
        out.append(dataclasses.replace(spec, model=model, max_new=12, kv_dtype=kv_dtype))
    return tuple(out)


@pytest.mark.parametrize("arch,kv_dtype", [("llava-next-mistral-7b", "bf16"),
                                           ("granite-34b", "bf16"), ("granite-34b", "int8")])
def test_engine_and_reference_serves_equal_jax(arch, kv_dtype):
    """engine.json with the reduced llava (served as its backbone, no
    patches, as the JAX System serves it) and the reduced granite-34b (gelu,
    MQA; on a bf16 and an int8 pool): the port's reference streams equal
    the JAX System's, and its engine streams the JAX engine's."""
    jspec, pspec = _specs(arch, kv_dtype)
    mb, pb = _bundles(arch)
    prompts = np.random.default_rng(5).integers(0, V, size=(jspec.devices, jspec.prompt_len))
    prompts = prompts.astype(np.int32)
    kvd = jnp.int8 if kv_dtype == "int8" else jnp.bfloat16
    n = jspec.devices
    for backend in ("reference", "engine"):
        want = JSystem.build(jspec.with_backend(backend), models=mb).serve(prompts).outputs
        got = System.build(pspec.with_backend(backend), models=pb, device="cpu").serve(prompts)
        _assert_same_tokens([got.outputs[i] for i in range(n)], [want[i] for i in range(n)], mb,
                            prompts, kvd)
        assert all(len(t) == jspec.max_new for t in got.outputs.values())
        if backend == "engine":
            print(f"{arch} {kv_dtype}: acceptance {got.engine.acceptance_rate:.3f}, "
                  f"rounds {got.engine.rounds}")
            assert 0 < got.engine.acceptance_rate < 1
            assert all(len(set(got.outputs[i])) > 1 for i in range(n))  # the streams vary
