"""The port's moe family (granite-moe-3b-a800m, qwen3-moe-30b-a3b) against
the JAX package.

Reduced configs (2 layers, d_model 64, 4 query heads on 4 KV heads of 16, 4
experts of d_ff 32, top-2; and a wider one of 8 experts), vocab 128, on
weights bridged from the JAX package (``bridge.params_from_jax``). The same
numpy inputs go through the JAX functions (jitted, XLA on the CPU) and the
port on the CPU.

The JAX ``moe_block`` dispatches with a capacity per expert and drops the
assignments past it, the first tokens of the flattened call winning, so a
row's output depends on the other rows of its call. The port mirrors that:
every case below that compares outputs includes inputs on which the JAX
router drops assignments (counted from JAX's own router), and the serves
hold the port's batches, padding rows included, to JAX's.

Tolerances: ``BF16_TOL`` (2e-2) for bf16 outputs and K/V, ``F32_TOL``
(2e-3) for f32 ones (logits, the aux loss). Greedy streams are compared as
``tests/test_torch_serve.py`` compares them: identical, or a first
divergence at a printed near tie.

Choosing the served bundles: the JAX ``build_models`` pair of engine.json
repeats one token per device for granite-moe (its tied head and small
random layers make the prompt's last token an attractor), and an
independently initialised draft never agrees with an untied qwen3-moe
target. So the serves use a bundle built here on the JAX side: the target's
init with its attention sharpened and its layer outputs enlarged (granite;
``GAINS``), and a draft made of the target's embedding, first layer, norm
and head, perturbed by ``NOISE``. Its streams vary and its drafts are partly
rejected.
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
from repro.models import layers as JL
from repro.models.layers import NO_MESH
from repro.models.model_zoo import build_model as jax_build_model
from repro.models.model_zoo import perturb_params
from repro.quant import quantize as jquant
from repro_torch import bridge, quant
from repro_torch.api import ServeSpec, System
from repro_torch.api.spec import ClusterSpec
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.kvcache import PagedKVCache, supports_paged_attention
from repro_torch.models.model_zoo import build_model
from test_torch_cluster import _serve_sessions
from test_torch_serve import SPEC_JSON, _assert_same_tokens, _port_bundle

BF16_TOL = 2e-2
F32_TOL = 2e-3
V = 128
CHUNK = 32
MAX_LEN = 64
ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")
# per arch: (gain of attention's wo and the experts' wd, gain of wq and wk)
GAINS = {"granite-moe-3b-a800m": (8.0, 16.0), "qwen3-moe-30b-a3b": (1.0, 1.0)}
NOISE = 0.005
# the gain of ``wd`` in the moe_block cases: at the init's scale their
# outputs stay under ~0.01, inside BF16_TOL; times 128 they are O(1), so the
# tolerance sees a wrong or missing drop
WD_GAIN = 128.0


def _reduced(arch: str, **changes):
    """The JAX reduced config at vocab ``V``, with ``changes``."""
    return dataclasses.replace(jax_config(arch).reduced(), vocab_size=V, **changes)


def _wide():
    """A wider reduced config: 8 experts, top-2."""
    return _reduced("granite-moe-3b-a800m", num_experts=8, experts_per_token=2)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _dropless(cfg):
    """The dropless twin: ``capacity_factor = E / K``, so capacity >= T."""
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0, err_msg=what)


def _scaled(leaf, gain: float):
    return (leaf.astype(jnp.float32) * gain).astype(leaf.dtype)


def _moe_params(jcfg, seed: int = 0):
    """(JAX moe params, the port's MoE holding the same weights), ``wd``
    times ``WD_GAIN``."""
    jp = JL.init_moe(jax.random.key(seed), jcfg)
    jp = {**jp, "wd": _scaled(jp["wd"], WD_GAIN)}
    moe = L.MoE(_port_cfg(jcfg))
    with torch.no_grad():
        for name in ("router", "wg", "wu", "wd"):
            getattr(moe, name).copy_(bridge.to_tensor(np.asarray(jp[name])))
    return jp, moe


def _jax_drops(x: np.ndarray, jp, cfg) -> int:
    """Assignments the JAX router drops for ``x`` (B, S, d): its own gates,
    top-k and row-major positions against the call's capacity."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    xf = jnp.asarray(x, jnp.bfloat16).reshape(B * S, d).astype(jnp.float32)
    gates = jax.nn.softmax(xf @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(gates, K)
    onehot = jax.nn.one_hot(idx.reshape(-1), E, dtype=jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
    return int((pos >= L.moe_capacity(B * S, cfg)).sum())


def _inputs(cfg, shape, skew: float, seed: int = 0) -> np.ndarray:
    """(B, S, d) activations: unit normal plus ``skew`` times one shared
    direction, which routes most tokens to the same experts."""
    rng = np.random.default_rng(seed)
    common = rng.standard_normal(cfg.d_model)
    return (rng.standard_normal((*shape, cfg.d_model)) + skew * common).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_moe(cfg):
    return jax.jit(functools.partial(JL.moe_block, cfg=cfg, ctx=NO_MESH))


def _port_moe(x: np.ndarray, moe, cfg):
    """The port's (out, aux, dropped by its tally) for ``x`` rounded to bf16."""
    L.reset_moe_tally()
    xt = bridge.to_tensor(np.asarray(jnp.asarray(x, jnp.bfloat16)))
    out, aux = L.moe_block(xt, moe, _port_cfg(cfg))
    assigned, dropped = L.moe_tally("cpu").tolist()
    assert assigned == x.shape[0] * x.shape[1] * cfg.experts_per_token
    return out, aux, dropped


def _both_moe(x: np.ndarray, jp, moe, cfg):
    """(JAX out, aux), (port out, aux, dropped by the port's tally)."""
    return _jax_moe(cfg)(jnp.asarray(x, jnp.bfloat16), jp), _port_moe(x, moe, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax(arch):
    """The port's copy of each registered config: every field, the
    parameter counts, and the reduced widths these tests run."""
    cfg = get_config(arch)
    jcfg = jax_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert supports_paged_attention(cfg)
    want = {"granite-moe-3b-a800m": (32, 1536, 24, 8, 64, 40, 8, 512, True),
            "qwen3-moe-30b-a3b": (48, 2048, 32, 4, 64, 128, 8, 768, False)}[arch]
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.num_experts, cfg.experts_per_token, cfg.moe_d_ff, cfg.tie_embeddings) == want
    red = cfg.reduced()
    assert (red.num_experts, red.experts_per_token, red.moe_d_ff, red.num_heads,
            red.num_kv_heads, red.head_dim, red.capacity_factor) == (4, 2, 32, 4, 4, 16, 1.25)
    model = build_model(red)
    params = model.init_params(torch.Generator().manual_seed(0))
    assert params.layers[0].moe.router.dtype == torch.float32
    assert params.layers[0].moe.wg.shape == (4, 64, 32)
    assert not hasattr(params.layers[0], "mlp")


def test_moe_capacity_equals_jax(monkeypatch):
    """``moe_capacity(T, cfg)`` is the slot count the JAX ``moe_block``
    hands its dispatch, for T in 1..1200, at the registered capacity
    factors and the dropless twins'."""
    seen = []

    def record(x_flat, p, cfg, e_start, e_local, capacity):
        seen.append(capacity)
        return x_flat, jnp.zeros((), jnp.float32)

    monkeypatch.setattr(JL, "_moe_local", record)
    cfgs = [c for arch in ARCHS for c in (jax_config(arch), jax_config(arch).reduced())]
    cfgs += [_dropless(c) for c in cfgs] + [_wide()]
    for cfg in cfgs:
        seen.clear()
        for T in range(1, 1201):
            JL.moe_block(np.zeros((1, T, 1), np.float32), {}, cfg, NO_MESH)
        assert [L.moe_capacity(T, cfg) for T in range(1, 1201)] == seen, cfg.name
    assert L.moe_capacity(30, jax_config("granite-moe-3b-a800m")) == 8
    assert L.moe_capacity(199, jax_config("qwen3-moe-30b-a3b")) == 16


# (config, input shape, skew): each input drops assignments on the JAX side
MOE_CASES = {
    "granite-verify": (lambda: _reduced("granite-moe-3b-a800m"), (2, 5), 2.0),
    "granite-prefill": (lambda: _reduced("granite-moe-3b-a800m"), (1, 199), 2.0),
    "qwen3-verify": (lambda: _reduced("qwen3-moe-30b-a3b"), (6, 5), 2.0),
    "qwen3-bucket": (lambda: _reduced("qwen3-moe-30b-a3b"), (4, 5), 1.0),
    "wide-verify": (_wide, (6, 5), 2.0),
    "wide-prefill": (_wide, (3, 40), 1.0),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_equals_jax(case):
    """``moe_block`` out and aux against the JAX package's on inputs the JAX
    router drops assignments of; the port's tally counts the same drops."""
    make_cfg, shape, skew = MOE_CASES[case]
    cfg = make_cfg()
    jp, moe = _moe_params(cfg)
    x = _inputs(cfg, shape, skew)
    drops = _jax_drops(x, jp, cfg)
    assert 0 < drops < shape[0] * shape[1] * cfg.experts_per_token
    (jout, jaux), (out, aux, dropped) = _both_moe(x, jp, moe, cfg)
    assert dropped == drops
    assert out.dtype == torch.bfloat16 and out.shape == (*shape, cfg.d_model)
    _close(out, jout, BF16_TOL, "moe out")
    _close(aux, jaux, F32_TOL, "aux")
    # the drops move the output by more than the tolerance: the dropless
    # twin's output on the same input is farther from JAX's than BF16_TOL
    twin, _, twin_dropped = _port_moe(x, moe, _dropless(cfg))
    assert twin_dropped == 0
    assert np.abs(_f32(twin) - _f32(jout)).max() > 5 * BF16_TOL


@pytest.mark.parametrize("tie", ["flat", "twin-columns"])
def test_tied_gates_pick_the_lower_expert_as_jax_does(tie):
    """Equal gates: ``jax.lax.top_k`` takes the lower expert index first.
    ``flat``: a zero router, every gate 1/E, so experts 0 and 1 take every
    one of 12 tokens and drop the 4 past their capacity of 8;
    ``twin-columns``: experts 1 and 3 share one router column, so where
    they tie at the K boundary expert 1 is taken and 3 is not."""
    cfg = _reduced("granite-moe-3b-a800m")
    jp, moe = _moe_params(cfg, seed=1)
    router = np.asarray(jp["router"]).copy()
    if tie == "flat":
        router[:] = 0
    else:
        router[:, 3] = router[:, 1]
    jp = {**jp, "router": jnp.asarray(router)}
    with torch.no_grad():
        moe.router.copy_(torch.from_numpy(router))
    x = _inputs(cfg, (2, 6), 0.0, seed=3)
    gates = torch.softmax(bridge.to_tensor(np.asarray(jnp.asarray(x, jnp.bfloat16))).float()
                          .reshape(12, -1) @ moe.router, dim=-1)
    _, idx = L._top_k(gates, cfg.experts_per_token)
    _, jidx = jax.lax.top_k(jnp.asarray(gates.numpy()), cfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if tie == "flat":
        assert (idx.numpy() == [0, 1]).all()
    else:
        has1, has3 = (np.isin(idx.numpy(), e).any(-1) for e in (1, 3))
        assert not (has3 & ~has1).any() and (has1 & ~has3).any()
    (jout, jaux), (out, aux, dropped) = _both_moe(x, jp, moe, cfg)
    assert dropped == _jax_drops(x, jp, cfg)
    if tie == "flat":
        assert dropped == 8  # 12 tokens on experts 0 and 1, 8 slots each
    _close(out, jout, BF16_TOL, "moe out")
    _close(aux, jaux, F32_TOL, "aux")


def test_dropless_twin_rows_do_not_depend_on_their_batch():
    """At the registered capacity a row's output depends on its batch (rows
    alone differ from the same rows in a batch that drops), in both
    packages alike; the dropless twin drops nothing and each row alone
    equals the same row in the batch."""
    cfg = _reduced("granite-moe-3b-a800m")
    jp, moe = _moe_params(cfg)
    x = _inputs(cfg, (6, 5), 2.0)
    assert _jax_drops(x, jp, cfg) > 0
    for c, drops in ((cfg, True), (_dropless(cfg), False)):
        (jout, _), (out, _, dropped) = _both_moe(x, jp, moe, c)
        assert (dropped > 0) == drops
        _close(out, jout, BF16_TOL, "batch")
        alone = [_both_moe(x[b:b + 1], jp, moe, c) for b in range(6)]
        assert all(a[1][2] == 0 for a in alone)  # 5 tokens never fill 8 slots
        for b, ((jrow, _), (row, _, _)) in enumerate(alone):
            _close(row, jrow, BF16_TOL, f"row {b} alone")
        same = [torch.equal(row[0], out[b]) for b, (_, (row, _, _)) in enumerate(alone)]
        assert all(same) != drops, same


@functools.lru_cache(maxsize=None)
def _model_pair(arch: str, group: int):
    """(JAX model, JAX params, port model, port params, the JAX prefill of
    a (3, 12) prompt into a fresh cache, jitted) of the reduced ``arch``
    with ``group`` query heads per KV head (2 KV heads)."""
    jcfg = _reduced(arch, num_heads=2 * group, num_kv_heads=2)
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init_params)(jax.random.key(0))
    cfg = _port_cfg(jcfg)
    prefill = jax.jit(lambda p, t: jm.prefill(p, t, jm.make_cache(3, MAX_LEN, attn_chunk=CHUNK),
                                              attn_chunk=CHUNK))
    return (jm, jp, build_model(cfg),
            bridge.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu"), prefill)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("group", [1, 3])
def test_prefill_and_dense_decode_match_jax(arch, group):
    """Prefill logits and K/V, then a verify-shaped dense decode (S = 5)
    after rows rolled back to uneven lengths, at G = 1 and G = 3."""
    jm, jp, pm, pp, jax_prefill = _model_pair(arch, group)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, V, size=(3, 12)).astype(np.int32)
    fresh = rng.integers(0, V, size=(3, 5)).astype(np.int32)
    lengths = np.array([12, 7, 9], np.int32)

    @jax.jit
    def jax_decode(p, c, f):
        h, c, aux = jm.decode_forward(p, {**c, "length": jnp.asarray(lengths)}, f,
                                      attn_chunk=CHUNK)
        return jm.lm_head(p, h), c

    jl, jc = jax_prefill(jp, jnp.asarray(prompt))
    jl2, jc2 = jax_decode(jp, jc, jnp.asarray(fresh))
    pl, pc = pm.prefill(pp, torch.from_numpy(prompt),
                        pm.make_cache(3, MAX_LEN, device="cpu", attn_chunk=CHUNK),
                        attn_chunk=CHUNK)
    _close(pl, jl, F32_TOL, "prefill logits")
    for name in ("k", "v"):
        _close(pc[name], jc[name], BF16_TOL, name)
    pc = {**pc, "length": torch.from_numpy(lengths)}
    h, pc = pm.decode_forward(pp, pc, torch.from_numpy(fresh), attn_chunk=CHUNK)
    _close(pm.lm_head(pp, h), jl2, F32_TOL, "decode logits")
    _close(pc["k"], jc2["k"], BF16_TOL, "decode k")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("group", [1, 3])
def test_slot_indexed_decode_matches_jax(arch, group):
    """Verify against a pool: uneven lengths, slots out of order, the bucket
    padded with the duplicated scratch slot, whose filler tokens take expert
    capacity in both packages."""
    jm, jp, pm, pp, jax_prefill = _model_pair(arch, group)
    rng = np.random.default_rng(2)
    n_slots, S = 4, 5
    prompts = {0: 9, 2: 12, 3: 6}  # slot: its length, of a (3, 12) prefill
    pool_np = jax.tree.map(np.array, jm.make_cache(n_slots + 1, MAX_LEN, attn_chunk=CHUNK))
    _, rows = jax_prefill(jp, jnp.asarray(rng.integers(0, V, size=(3, 12)), jnp.int32))
    for r, (slot, n) in enumerate(prompts.items()):
        for name in ("k", "v"):
            pool_np[name][:, slot] = np.asarray(rows[name])[:, r]
        pool_np["length"][slot] = n
    slots = np.array([2, 0, 3, n_slots, n_slots], np.int32)
    fresh = rng.integers(0, V, size=(slots.shape[0], S)).astype(np.int32)

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
    real = slots < n_slots
    _close(pm.lm_head(pp, h)[torch.from_numpy(real)], np.asarray(jl)[real], F32_TOL, "logits")
    for name in ("k", "v"):
        _close(after[name][:, :n_slots], np.asarray(jc[name])[:, :n_slots], BF16_TOL, name)


@functools.lru_cache(maxsize=None)
def _jax_bundle(arch: str, bits: int = 16):
    """The served pair (module note): the reduced target, ``GAINS`` applied,
    weight-quantized to ``bits``; the draft its first layer perturbed by
    ``NOISE``."""
    if bits < 16:
        mb = _jax_bundle(arch)
        tp = jquant.dequantize_pytree(jquant.quantize_pytree(mb.target_params, bits))
        return dataclasses.replace(mb, target_params=tp)
    tcfg = _reduced(arch)
    dcfg = dataclasses.replace(tcfg, name="edge-draft", num_layers=1)
    target, draft = jax_build_model(tcfg), jax_build_model(dcfg)
    tp = jax.jit(target.init_params)(jax.random.key(0))
    out_gain, qk_gain = GAINS[arch]
    layers = dict(tp["layers"])
    layers["attn"] = {**layers["attn"], **{n: _scaled(layers["attn"][n], qk_gain)
                                           for n in ("wq", "wk")}}
    layers["attn"]["wo"] = _scaled(layers["attn"]["wo"], out_gain)
    layers["moe"] = {**layers["moe"], "wd": _scaled(layers["moe"]["wd"], out_gain)}
    tp = {**tp, "layers": layers}
    dp = jax.jit(lambda p: perturb_params(p, NOISE))(
        {**tp, "layers": jax.tree.map(lambda a: a[:1], layers)})
    return JModelBundle(tcfg, dcfg, target, draft, tp, dp)


@functools.lru_cache(maxsize=None)
def _bundles(arch: str, bits: int = 16):
    mb = _jax_bundle(arch, bits)
    return mb, _port_bundle(mb)


def _specs(arch: str, *, bits: int = 16, slots: int = 4, **changes):
    """(JAX spec, port spec): engine.json with the moe pair at the reduced
    depth, vocab ``V``, 3 devices on 4 slots (the verify bucket of 4 has a
    padding row) and 12 new tokens."""
    out = []
    for cls in (JServeSpec, ServeSpec):
        spec = cls.from_json(SPEC_JSON)
        model = dataclasses.replace(spec.model, arch=arch, draft_arch=arch, vocab_size=V,
                                    target_layers=None, draft_layers=1, bits=bits)
        out.append(dataclasses.replace(spec, model=model, max_new=12,
                                       scheduler=dataclasses.replace(spec.scheduler, slots=slots),
                                       **changes))
    return tuple(out)


def _prompts(n: int, prompt_len: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, V, size=(n, prompt_len)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_dtype,bits", [("bf16", 16), ("int8", 8)])
def test_engine_and_reference_serves_equal_jax(arch, kv_dtype, bits):
    """engine.json with the moe pair on the engine backend (3 devices in a
    verify bucket of 4: a padding row, its filler tokens taking capacity)
    and the reference backend, on a bf16 pool and a 16-bit target, and on
    an int8 pool with an 8-bit target (its router bf16): each stream the
    JAX package's, with drafts both accepted and rejected and the engine's
    verifies dropping assignments."""
    jspec, pspec = _specs(arch, kv_dtype=kv_dtype, bits=bits)
    mb, pb = _bundles(arch, bits)
    if bits < 16:
        assert pb.target_params.layers[0].moe.router.dtype == torch.bfloat16
    prompts = _prompts(jspec.devices, jspec.prompt_len)
    jeng = JSystem.build(jspec, models=mb).serve(prompts).outputs
    jref = JSystem.build(jspec.with_backend("reference"), models=mb).serve(prompts).outputs
    L.reset_moe_tally()
    eng = System.build(pspec, models=pb, device="cpu").serve(prompts)
    assigned, dropped = L.moe_tally("cpu").tolist()
    print(f"{arch} {kv_dtype} bits {bits}: engine dropped {dropped} of {assigned} assignments")
    ref = System.build(pspec.with_backend("reference"), models=pb, device="cpu").serve(prompts)
    n = jspec.devices
    kvd = jnp.int8 if kv_dtype == "int8" else jnp.bfloat16
    _assert_same_tokens([eng.outputs[i] for i in range(n)], [jeng[i] for i in range(n)], mb,
                        prompts, kvd)
    _assert_same_tokens([ref.outputs[i] for i in range(n)], [jref[i] for i in range(n)], mb,
                        prompts, kvd)
    assert 0 < eng.engine.acceptance_rate < 1 and dropped > 0
    assert all(len(set(eng.outputs[i])) > 1 for i in range(n))  # the streams vary


@pytest.mark.parametrize("arch", ARCHS)
def test_cluster_with_migration_equals_jax_cluster(arch):
    """Four devices on 2 replicas x 2 slots, even ids stopping after 4
    tokens and odd ids after 12, so retirement migrates streams between the
    pools: each stream the JAX cluster's, whose replicas batch the same
    rows."""
    jspec, pspec = _specs(arch, slots=0, devices=4, backend="cluster")
    jspec = dataclasses.replace(jspec, cluster=dataclasses.replace(jspec.cluster, replicas=2))
    pspec = dataclasses.replace(pspec, cluster=ClusterSpec(replicas=2))
    mb, pb = _bundles(arch)
    prompts = _prompts(4, jspec.prompt_len)
    budgets = [4 if i % 2 == 0 else 12 for i in range(4)]
    systems = [JSystem.build(jspec, models=mb), System.build(pspec, models=pb, device="cpu")]
    want, got = (_serve_sessions(s, prompts, budgets) for s in systems)
    assert systems[0].engine.migrations >= 1 and systems[1].engine.migrations >= 1
    _assert_same_tokens([got[i] for i in range(4)], [want[i] for i in range(4)], mb, prompts)
    assert [len(got[i]) for i in range(4)] == budgets


@pytest.mark.parametrize("arch", ARCHS)
def test_dropless_twin_engine_equals_reference(arch):
    """The dropless twin of the served pair (the same weights, the configs'
    ``capacity_factor = E / K``): nothing dropped in either backend, and the
    engine's streams equal the reference's, since a row's output depends on
    its own tokens only."""
    _, pspec = _specs(arch)
    mb, pb = _bundles(arch)
    tcfg, dcfg = _dropless(pb.target_cfg), _dropless(pb.draft_cfg)
    twin = dataclasses.replace(pb, target_cfg=tcfg, draft_cfg=dcfg, target=build_model(tcfg),
                               draft=build_model(dcfg))
    prompts = _prompts(pspec.devices, pspec.prompt_len)
    outs = []
    for backend in ("engine", "reference"):
        L.reset_moe_tally()
        outs.append(System.build(pspec.with_backend(backend), models=twin,
                                 device="cpu").serve(prompts).outputs)
        assigned, dropped = L.moe_tally("cpu").tolist()
        assert assigned > 0 and dropped == 0, backend
    n = pspec.devices
    _assert_same_tokens([outs[0][i] for i in range(n)], [outs[1][i] for i in range(n)], mb,
                        prompts)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_and_quantized_leaves(arch):
    """``params_to_jax(params_from_jax(tree))`` gives back the JAX tree bit
    for bit; quantizing the bridged params gives the JAX package's
    dequantized leaves (the 3-D expert tables per row of their last axis,
    the router in bf16) and its ``quantized_bytes``."""
    mb = _jax_bundle(arch)
    tree = jax.tree.map(np.asarray, mb.target_params)
    cfg = _port_cfg(mb.target_cfg)
    params = bridge.params_from_jax(cfg, tree, device="cpu")
    back = bridge.params_to_jax(params)
    assert sorted(back["layers"]["moe"]) == ["router", "wd", "wg", "wu"]
    assert back["layers"]["moe"]["wg"].shape == (2, 4, 64, 32)

    def bits16(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    jax.tree.map(lambda w, g: np.testing.assert_array_equal(bits16(w), g), tree, back)
    for bits in (8, 4):
        assert quant.quantized_bytes(params, bits) == jquant.quantized_bytes(tree, bits)
        deq = quant.dequantize_pytree(quant.quantize_pytree(params, bits))
        jdeq = jax.tree.map(np.asarray, jquant.dequantize_pytree(
            jquant.quantize_pytree(jax.tree.map(jnp.asarray, tree), bits)))
        assert deq.layers[0].moe.router.dtype == torch.bfloat16
        jax.tree.map(lambda w, g: np.testing.assert_array_equal(bits16(w), g), jdeq,
                     bridge.params_to_jax(deq))
    assert quant.quantized_bytes(params, 16) == jquant.quantized_bytes(tree, 16)


def test_port_seeded_moe_serves_on_its_own():
    """The port's own seeded build of a moe spec (no JAX weights): the
    engine serve equals the reference's on the CPU."""
    _, pspec = _specs("qwen3-moe-30b-a3b")
    prompts = _prompts(pspec.devices, pspec.prompt_len)
    eng = System.build(pspec, device="cpu").serve(prompts).outputs
    ref = System.build(pspec.with_backend("reference"), device="cpu").serve(prompts).outputs
    assert eng == ref and all(len(t) == pspec.max_new for t in eng.values())
