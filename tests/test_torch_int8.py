"""The port's int8 KV cache against the JAX package's, bridged weights.

Reduced qwen2 (2 layers, d_model 64, 4 query heads on 2 KV heads). The
quantization itself (``kv_quant``, ``kv_dequant``, ``kv_fresh_scale``) must
be bit-equal to JAX's: f32 divide, round half to even, clip, and a bf16
rounding of the dequantized value. The int8 rows and scales a forward
writes must then be bit-equal too; logits are held to the dense model
tests' ``LOGIT_TOL`` (1e-3, f32 summation order inside the products).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.api.spec import ModelSpec
from repro.api.system import build_models
from repro.models import layers as jlayers
from repro_torch import bridge
from repro_torch.api import ServeSpec, System
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import EngineCore
from repro_torch.models import layers
from repro_torch.models.kvcache import PagedKVCache
from repro_torch.models.model_zoo import build_model

LOGIT_TOL = 1e-3
CHUNK = 32
MAX_LEN = 64


@pytest.fixture(scope="module")
def pair():
    mb = build_models(ModelSpec())
    cfg = ModelConfig(**dataclasses.asdict(mb.target_cfg))
    params = bridge.params_from_jax(cfg, jax.tree.map(np.asarray, mb.target_params), device="cpu")
    return mb.target, mb.target_params, build_model(cfg), params


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(ml_dtypes.bfloat16).view(np.int16)).view(torch.bfloat16)


def test_quantization_is_bit_equal_to_jax():
    """Fresh scales, int8 rows (incl. values exactly on .5 boundaries and
    beyond the clip) and dequantized bf16 values, against JAX's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 2, 16)).astype(np.float32) * 3
    scale = np.array([[0.5, 0.25], [1.0, 0.125], [0.02, 2.0]], np.float32)
    # k + 0.5 times the scale lands on a rounding tie of x / scale
    x[0, 0, 0, :8] = (np.arange(-4, 4) + 0.5) * scale[0, 0]
    x[1, 0, 1, :4] = [200 * 0.125, -300 * 0.125, 126.5 * 0.125, -127.5 * 0.125]
    xb = x.astype(ml_dtypes.bfloat16)
    j_scale = np.asarray(jlayers.kv_fresh_scale(jnp.asarray(xb)))
    p_scale = layers.kv_fresh_scale(_bf16(x))
    np.testing.assert_array_equal(p_scale.numpy(), j_scale)
    for s in (scale, j_scale):
        jq = np.asarray(jlayers.kv_quant(jnp.asarray(xb), jnp.int8, jnp.asarray(s)))
        pq = layers.kv_quant(_bf16(x), torch.tensor(s))
        np.testing.assert_array_equal(pq.numpy(), jq)
        jd = np.asarray(jlayers.kv_dequant(jnp.asarray(jq), jnp.asarray(s)))
        pd = layers.kv_dequant(pq, torch.tensor(s))
        np.testing.assert_array_equal(bridge.to_numpy(pd), jd.view(np.uint16))
    # ties round half to even
    tie = layers.kv_quant(torch.tensor([[[[0.5, 1.5, 2.5, -0.5]]]]), torch.ones((1, 1)))
    assert tie.flatten().tolist() == [0, 2, 2, 0]


def test_int8_prefill_then_slot_decode_bit_equal_to_jax(pair):
    """Row prefill into an int8 pool, then a slot-indexed verify-shaped
    decode (uneven lengths, real slots out of order, scratch padding): the
    int8 rows and the scale leaves equal JAX's bit for bit."""
    jm, jp, pm, pp = pair
    rng = np.random.default_rng(2)
    n_slots, S = 4, 5
    prompts = {0: 9, 2: 13, 3: 6}
    kw = dict(attn_chunk=CHUNK, kv_dtype=jnp.int8)
    pool_np = jax.tree.map(np.array, jm.make_cache(n_slots + 1, MAX_LEN, **kw))
    row_prefill = jax.jit(lambda p, t, c: jm.prefill(p, t, c, attn_chunk=CHUNK))
    pool = PagedKVCache(pm, n_slots, MAX_LEN, device="cpu", attn_chunk=CHUNK, kv_dtype="int8")
    for slot, n in prompts.items():
        toks = rng.integers(0, 256, size=(1, n)).astype(np.int32)
        jl, row = row_prefill(jp, jnp.asarray(toks), jm.make_cache(1, MAX_LEN, **kw))
        for name in ("k", "v", "k_scale", "v_scale"):
            pool_np[name][:, slot] = np.asarray(row[name])[:, 0]
        pool_np["length"][slot] = n
        pl, prow = pm.prefill(pp, torch.from_numpy(toks), pool.make_row_cache(), attn_chunk=CHUNK)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
        pool.write_slot(slot, prow)
    for name in ("k", "v", "k_scale", "v_scale", "length"):
        np.testing.assert_array_equal(pool.cache[name].numpy(), pool_np[name], err_msg=name)

    slots = np.array([2, 0, 3, n_slots, n_slots], np.int32)
    fresh = rng.integers(0, 256, size=(slots.shape[0], S)).astype(np.int32)

    def jax_side(p, c, t, s):
        h, c, _ = jm.decode_forward(p, c, t, attn_chunk=CHUNK, slots=s)
        return jm.lm_head(p, h), c

    jl, jc = jax.jit(jax_side)(jp, jax.tree.map(jnp.asarray, pool_np), jnp.asarray(fresh),
                               jnp.asarray(slots))
    h, after = pm.decode_forward(pp, pool.cache, torch.from_numpy(fresh), attn_chunk=CHUNK,
                                 slots=torch.from_numpy(slots))
    real = slots < n_slots
    np.testing.assert_allclose(pm.lm_head(pp, h).numpy()[real], np.asarray(jl)[real],
                               atol=LOGIT_TOL, rtol=0)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(after[name].numpy()[:, :n_slots],
                                      np.asarray(jc[name])[:, :n_slots], err_msg=name)


def test_int8_pool_halves_bytes_per_slot(pair):
    """bytes_per_slot counts the scale leaves; int8 K/V is half of bf16."""
    _, _, pm, _ = pair
    bf16 = PagedKVCache(pm, 4, MAX_LEN, device="cpu", attn_chunk=CHUNK)
    int8 = PagedKVCache(pm, 4, MAX_LEN, device="cpu", attn_chunk=CHUNK, kv_dtype="int8")
    cfg = pm.cfg
    kv = 2 * cfg.num_layers * MAX_LEN * cfg.num_kv_heads * cfg.head_dim
    assert bf16.bytes_per_slot() == 2 * kv + 4
    assert int8.bytes_per_slot() == kv + 2 * cfg.num_layers * cfg.num_kv_heads * 4 + 4
    assert int8.bytes_per_slot() / bf16.bytes_per_slot() < 0.51


def test_int8_is_refused_for_the_ssm_family():
    """The ssm state has no quantized layout: the engine and System.build
    raise ValueError, as the JAX package does."""
    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(), vocab_size=128)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="int8"):
        EngineCore(model, params, n_slots=2, max_len=64, k_max=4, kv_dtype="int8", device="cpu")
    spec = ServeSpec(kv_dtype="int8")
    spec = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, arch="mamba2-370m", draft_arch="mamba2-370m"))
    with pytest.raises(ValueError, match="kv_dtype='int8' is not supported"):
        System.build(spec, device="cpu")
