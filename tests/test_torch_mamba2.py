"""The port's Mamba2 (ssm family) against the JAX package's, bridged weights.

Reduced mamba2-370m (2 layers, d_model 64, d_inner 128 in 8 heads of 16,
state 16, conv width 4, chunk 16). The same numpy inputs go through the
JAX ``mamba2`` (jitted, XLA on the CPU) and the port on the CPU, with a
prompt of 2.5 chunks and more so that the scan carries its state across
chunks and ends on a ragged one.

Tolerances. The port rounds where the JAX path rounds (the causal conv's
bf16 sum of products, f32 silu/softplus, bf16 state checkpoints), so what
is left is f32 summation order. In the bf16 projections that order decides
a value that lies on a bf16 rounding midpoint: measured here, one in_proj
output of ~12,000 flips by one bf16 ulp, and through the conv, the scan and
the gated norm that moves the f32 logits by up to 1.9e-3. ``LOGIT_TOL =
5e-3`` leaves room for a second such flip; one misplaced rounding step (the
failure the test exists for) moves them by more than 1e-2. States are f32
(measured within 1e-6 of JAX's): ``STATE_TOL = 1e-4``. bf16 checkpoints and
the conv window are compared at bf16's resolution (2e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.spec import ModelSpec
from repro.api.system import build_models
from repro.core import drafting as jdrafting
from repro.models import mamba2 as jmamba2
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.core import drafting
from repro_torch.models.kvcache import gather_slots, scatter_slots, supports_paged_attention
from repro_torch.models.model_zoo import build_model

LOGIT_TOL = 5e-3
STATE_TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def pair():
    mb = build_models(ModelSpec(arch="mamba2-370m", draft_arch="mamba2-370m"))
    cfg = ModelConfig(**dataclasses.asdict(mb.target_cfg))
    params = bridge.params_from_jax(cfg, jax.tree.map(np.asarray, mb.target_params), device="cpu")
    return mb, build_model(cfg), params


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def test_config_is_the_published_one():
    """mamba2-370m at its published widths, the port's own copy."""
    from repro.configs.base import get_config as jax_config
    from repro_torch.configs import get_config

    assert dataclasses.asdict(get_config("mamba2-370m")) == dataclasses.asdict(
        jax_config("mamba2-370m"))
    cfg = get_config("mamba2-370m")
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.ssm_state, cfg.ssm_head_dim,
            cfg.d_inner, cfg.ssm_heads, cfg.conv_width, cfg.ssm_chunk) == (
        48, 1024, 50280, 128, 64, 2048, 32, 4, 256)
    assert not supports_paged_attention(cfg)


def test_prefill_decode_and_checkpoint_selection_match_jax(pair):
    """Prefill of 41 tokens (2.5 chunks of 16), a verify-shaped decode of 5
    tokens with per-position checkpoints, and the commit of uneven
    acceptance counts, against JAX's."""
    mb, pm, pp = pair
    jm, jp = mb.target, mb.target_params
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, size=(2, 41)).astype(np.int32)
    fresh = rng.integers(0, 256, size=(2, 5)).astype(np.int32)
    n_commit = np.array([3, 5], np.int32)

    def jax_side(p, t, f, c, n):
        logits, c = jm.prefill(p, t, c)
        h, ck, _ = jm.decode_forward(p, c, f)
        return logits, c, jm.lm_head(p, h), ck, jmamba2.select_checkpoint(ck, n)

    jl, jc, jl2, jck, jsel = jax.jit(jax_side)(jp, jnp.asarray(toks), jnp.asarray(fresh),
                                               jm.make_cache(2, 64), jnp.asarray(n_commit))
    pl, pc = pm.prefill(pp, torch.from_numpy(toks), pm.make_cache(2, 64, device="cpu"))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(pc["ssm"].numpy(), np.asarray(jc["ssm"]), atol=STATE_TOL, rtol=0)
    np.testing.assert_allclose(_f32(pc["conv"]), _f32(jc["conv"]), atol=BF16_TOL, rtol=0)
    np.testing.assert_array_equal(pc["length"].numpy(), np.asarray(jc["length"]))

    h, pck = pm.decode_forward(pp, pc, torch.from_numpy(fresh))
    np.testing.assert_allclose(pm.lm_head(pp, h).numpy(), np.asarray(jl2), atol=LOGIT_TOL, rtol=0)
    assert pck["ssm_ckpt"].dtype == torch.bfloat16 and pck["ssm_ckpt"].shape[2] == 5
    for name in ("ssm_ckpt", "conv_ckpt"):
        np.testing.assert_allclose(_f32(pck[name]), _f32(jck[name]), atol=BF16_TOL, rtol=0)

    psel = pm.commit(pck, torch.from_numpy(n_commit))
    assert set(psel) == {"ssm", "conv", "length"} and psel["ssm"].dtype == torch.float32
    # the committed state is the bf16 checkpoint widened back: exactly the
    # checkpoint the acceptance count points at
    for b, n in enumerate(n_commit):
        assert torch.equal(psel["ssm"][:, b], pck["ssm_ckpt"][:, b, n - 1].float())
    np.testing.assert_allclose(psel["ssm"].numpy(), np.asarray(jsel["ssm"]), atol=BF16_TOL, rtol=0)
    np.testing.assert_array_equal(psel["length"].numpy(), np.asarray(jsel["length"]))


def test_gather_scatter_moves_state_rows_bit_exactly(pair):
    """gather_slots / scatter_slots on an ssm pool copy rows bit for bit and
    leave the other rows alone."""
    _, pm, _ = pair
    pool = pm.make_cache(5, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for name in ("ssm", "conv"):
        pool[name].copy_(torch.randn(pool[name].shape, generator=gen).to(pool[name].dtype))
    pool["length"] = torch.arange(5, dtype=torch.int32)
    before = {k: v.clone() for k, v in pool.items()}
    slots = torch.tensor([3, 1], dtype=torch.int32)
    sub = gather_slots(pool, slots)
    assert torch.equal(sub["ssm"], before["ssm"][:, [3, 1]])
    assert torch.equal(sub["length"], torch.tensor([3, 1], dtype=torch.int32))
    # write the two rows back swapped: row 1's state lands in slot 3
    sub = {k: v.flip(1) if v.dim() > 1 else v.flip(0) for k, v in sub.items()}
    out = scatter_slots(pool, slots, sub)
    for name in ("ssm", "conv"):
        assert torch.equal(out[name][:, 3], before[name][:, 1])
        assert torch.equal(out[name][:, 1], before[name][:, 3])
        assert torch.equal(out[name][:, [0, 2, 4]], before[name][:, [0, 2, 4]])
    assert out["length"].tolist() == [0, 3, 2, 1, 4]


def test_ssm_draft_rollback_matches_jax(pair):
    """A drafting round of an ssm draft keeps one cache checkpoint per step;
    the rollback to each acceptance count (0 .. k_max, the last clamped as
    JAX's gather clamps it) gives JAX's state."""
    mb, pm, pp = pair
    jm, jp = mb.target, mb.target_params
    prompt = np.random.default_rng(1).integers(0, 256, size=(4, 20)).astype(np.int32)
    n_acc = np.array([0, 1, 3, 4], np.int32)

    def jax_side(p, t, c, n):
        _, c = jm.prefill(p, t[:, :-1], c)
        d = jdrafting.draft_round(jm, p, c, t[:, -1], jax.random.key(0), k_max=4, c_th=0.0,
                                  greedy=True)
        return d.tokens, jdrafting.resume_after_verify(jm, d, n)

    jt, jres = jax.jit(jax_side)(jp, jnp.asarray(prompt), jm.make_cache(4, 64),
                                 jnp.asarray(n_acc))
    _, pc = pm.prefill(pp, torch.from_numpy(prompt[:, :-1]), pm.make_cache(4, 64, device="cpu"))
    d = drafting.draft_round(pm, pp, pc, torch.from_numpy(prompt[:, -1]), k_max=4, c_th=0.0)
    assert d.cache_ckpts["ssm"].shape[:3] == (4, 2, 4)
    np.testing.assert_array_equal(d.tokens.numpy(), np.asarray(jt))
    res = drafting.resume_after_verify(d, torch.from_numpy(n_acc))
    np.testing.assert_allclose(res["ssm"].numpy(), np.asarray(jres["ssm"]), atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(_f32(res["conv"]), _f32(jres["conv"]), atol=BF16_TOL, rtol=0)
    np.testing.assert_array_equal(res["length"].numpy(), np.asarray(jres["length"]))
    # rows that accepted k_max-1 and k_max drafts resume from the same checkpoint
    assert torch.equal(d.cache_ckpts["ssm"][3, :, 3], res["ssm"][:, 3])
