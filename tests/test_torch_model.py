"""The port's dense transformer against the JAX package's, bridged weights.

Reduced qwen2 (2 layers, d_model 64, 4 query heads on 2 KV heads, QKV
bias, tied embeddings). The same numpy inputs go through the JAX
``transformer`` (jitted, XLA on the CPU) and the port on the CPU.

Tolerance: the port rounds to bf16 at the same points as the compiled JAX
path and runs the same chunked online softmax, so what is left is f32
summation order inside the products (measured ~1e-7 on the f32 logits,
which are of magnitude ~1.5). ``LOGIT_TOL = 1e-3`` leaves room for a rare
1-ulp bf16 flip of one hidden element (~1e-4 on a logit) and is below what
a single misplaced bf16 rounding step per layer produced (~2e-3). Cache
rows are compared at bf16's resolution (2e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.spec import ModelSpec
from repro.api.system import build_models
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.models.kvcache import PagedKVCache
from repro_torch.models.model_zoo import build_model

LOGIT_TOL = 1e-3
CACHE_TOL = 2e-2
CHUNK = 32
MAX_LEN = 64


@pytest.fixture(scope="module")
def pair():
    mb = build_models(ModelSpec())
    cfg = ModelConfig(**dataclasses.asdict(mb.target_cfg))
    params = bridge.params_from_jax(cfg, jax.tree.map(np.asarray, mb.target_params), device="cpu")
    return mb.target, mb.target_params, build_model(cfg), params


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jnp_cache(cache) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in cache.items()}


def test_prefill_logits_and_cache_match_jax(pair):
    jm, jp, pm, pp = pair
    toks = np.random.default_rng(0).integers(0, 256, size=(3, 11)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t, c: jm.prefill(p, t, c, attn_chunk=CHUNK))(
        jp, jnp.asarray(toks), jm.make_cache(3, MAX_LEN, attn_chunk=CHUNK)
    )
    pl, pc = pm.prefill(pp, torch.from_numpy(toks), pm.make_cache(3, MAX_LEN, device="cpu",
                                                                  attn_chunk=CHUNK),
                        attn_chunk=CHUNK)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    jc = _jnp_cache(jc)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(pc[name]), jc[name], atol=CACHE_TOL, rtol=0)
    np.testing.assert_array_equal(pc["length"].numpy(), jc["length"])


def test_dense_decode_with_uneven_lengths_matches_jax(pair):
    """Verify-shaped dense decode (S=5) after rows rolled back to uneven
    committed lengths."""
    jm, jp, pm, pp = pair
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 256, size=(3, 12)).astype(np.int32)
    fresh = rng.integers(0, 256, size=(3, 5)).astype(np.int32)
    lengths = np.array([12, 7, 9], np.int32)

    def jax_side(p, t, f, c):
        _, c = jm.prefill(p, t, c, attn_chunk=CHUNK)
        c = {**c, "length": jnp.asarray(lengths)}
        h, c, _ = jm.decode_forward(p, c, f, attn_chunk=CHUNK)
        return jm.lm_head(p, h), c

    jl, jc = jax.jit(jax_side)(jp, jnp.asarray(prompt), jnp.asarray(fresh),
                               jm.make_cache(3, MAX_LEN, attn_chunk=CHUNK))
    _, pc = pm.prefill(pp, torch.from_numpy(prompt),
                       pm.make_cache(3, MAX_LEN, device="cpu", attn_chunk=CHUNK), attn_chunk=CHUNK)
    pc = {**pc, "length": torch.from_numpy(lengths)}
    h, pc = pm.decode_forward(pp, pc, torch.from_numpy(fresh), attn_chunk=CHUNK)
    np.testing.assert_allclose(pm.lm_head(pp, h).numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(_np(pc["k"]), _jnp_cache(jc)["k"], atol=CACHE_TOL, rtol=0)


def test_slot_indexed_decode_matches_jax_and_writes_only_fresh_rows(pair):
    """Verify against a PagedKVCache pool: uneven per-slot lengths, real
    slots out of order, the bucket padded with the duplicated scratch slot."""
    jm, jp, pm, pp = pair
    rng = np.random.default_rng(2)
    n_slots, S = 4, 5
    prompts = {0: 9, 2: 13, 3: 6}  # slot -> prompt length (slot 1 stays empty)
    pool_np = jax.tree.map(np.array, jm.make_cache(n_slots + 1, MAX_LEN, attn_chunk=CHUNK))
    row_prefill = jax.jit(lambda p, t, c: jm.prefill(p, t, c, attn_chunk=CHUNK)[1])
    for slot, n in prompts.items():
        row = row_prefill(jp, jnp.asarray(rng.integers(0, 256, size=(1, n)), jnp.int32),
                          jm.make_cache(1, MAX_LEN, attn_chunk=CHUNK))
        for name in ("k", "v"):
            pool_np[name][:, slot] = np.asarray(row[name])[:, 0]
        pool_np["length"][slot] = n
    slots = np.array([2, 0, 3, n_slots, n_slots], np.int32)
    fresh = rng.integers(0, 256, size=(slots.shape[0], S)).astype(np.int32)

    def jax_side(p, c, t, s):
        h, c, _ = jm.decode_forward(p, c, t, attn_chunk=CHUNK, slots=s)
        return jm.lm_head(p, h), c

    jl, jc = jax.jit(jax_side)(jp, jax.tree.map(jnp.asarray, pool_np), jnp.asarray(fresh),
                               jnp.asarray(slots))
    pool = PagedKVCache(pm, n_slots, MAX_LEN, device="cpu", attn_chunk=CHUNK)
    pool.cache = bridge.cache_from_jax(pool_np, device="cpu")
    before = {k: v.clone() for k, v in pool.cache.items()}
    h, after = pm.decode_forward(pp, pool.cache, torch.from_numpy(fresh), attn_chunk=CHUNK,
                                 slots=torch.from_numpy(slots))
    real = slots < n_slots
    np.testing.assert_allclose(pm.lm_head(pp, h).numpy()[real], np.asarray(jl)[real],
                               atol=LOGIT_TOL, rtol=0)
    jc = _jnp_cache(jc)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(after[name])[:, :n_slots], jc[name][:, :n_slots],
                                   atol=CACHE_TOL, rtol=0)
        # outside the fresh rows of the real slots and the scratch row, the
        # pool is bit-for-bit what it was
        touched = torch.zeros(after[name].shape[1:3], dtype=torch.bool)
        for slot in slots[real]:
            n = prompts[int(slot)]
            touched[slot, n:n + S] = True
        touched[n_slots] = True
        assert torch.equal(after[name][:, ~touched], before[name][:, ~touched])
    assert torch.equal(after["length"], before["length"])  # commit is the caller's


def test_lm_head_is_f32_over_the_bf16_table(pair):
    _, _, pm, pp = pair
    h = torch.randn(2, 3, 64).to(torch.bfloat16)
    want = h.double() @ pp.embed.double().t()
    got = pm.lm_head(pp, h)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
