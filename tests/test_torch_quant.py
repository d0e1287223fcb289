"""The port's weight-only quantization against the JAX package's.

Reduced qwen2 (dense) and mamba2-370m (ssm), bits 8 and 4, on the JAX
package's weights bridged into the port. Bounds:
  * ``quantize_pytree``: the same ``q`` and ``scale`` bit for bit, leaf by
    leaf in the JAX layout (a port per-layer tensor is one layer of a
    stacked JAX leaf), and the same dequantized weights, dtype included (the
    JAX package returns every quantized leaf in bf16, its f32 norm scales
    and SSM parameters too). Both round half to even and divide in f32.
  * ``quantized_bytes``: equal. ``quant_error``: within 1e-6 (both sum
    squares of the same numbers, in another order and precision).
  * A ``bits=8`` target's prefill and decode logits: within the port's
    logit tolerances of the JAX forward (tests/test_torch_model.py 1e-3 for
    the dense family, tests/test_torch_mamba2.py 5e-3 for the ssm family).
  * A quantized target served greedily by the port's engine: the JAX
    reference's streams, up to a printed near tie (tests/test_torch_serve.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.api.spec import ModelSpec as JModelSpec
from repro.core import engine_loop as jax_loop
from repro.quant import quantize as jq
from repro_torch import bridge, quant
from repro_torch.api import ServeSpec, System
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model_zoo import build_model
from test_torch_serve import _assert_same_tokens, _port_bundle, jax_build_models

LOGIT_TOL = {"qwen2-1.5b": 1e-3, "mamba2-370m": 5e-3}
ARCHS = ["qwen2-1.5b", "mamba2-370m"]


@functools.lru_cache(maxsize=None)
def _jax_bundle(arch: str, bits: int = 16):
    """The JAX package's ``build_models`` for the arch at ``bits``: its
    16-bit target quantized and dequantized, as ``build_models`` does it
    (one init per arch: the JAX package's eager init is slow here)."""
    mb = jax_build_models(JModelSpec(arch=arch, draft_arch=arch))
    if bits >= 16:
        return mb
    return dataclasses.replace(mb, target_params=jq.dequantize_pytree(
        jq.quantize_pytree(mb.target_params, bits)))


@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    """The JAX 16-bit target's params and the port module holding them."""
    mb = _jax_bundle(arch)
    cfg = ModelConfig(**dataclasses.asdict(mb.target_cfg))
    return mb, cfg, bridge.params_from_jax(cfg, jax.tree.map(np.asarray, mb.target_params),
                                           device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_steps(arch: str):
    """The JAX reference loop's jitted steps, shared by both bit widths."""
    mb = _jax_bundle(arch)
    return jax_loop.make_sled_steps(mb.draft, mb.target, k_max=4, c_th=0.3, greedy=True,
                                    attn_chunk=32)


def _jax_leaves(tree, prefix=""):
    """The JAX pytree's leaves by the port's names: ``layers.<name>`` for a
    stacked leaf, ``lm_head_w`` for the untied head."""
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _jax_leaves(val, name + ".")
        else:
            yield ("lm_head_w" if name == "lm_head" else name), val


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _per_layer(name: str, n_layers: int):
    """The port's parameter names behind one JAX leaf."""
    if name.startswith("layers."):
        return [f"layers.{i}.{name[len('layers.'):]}" for i in range(n_layers)]
    return [name]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_pytree_matches_jax_bit_for_bit(arch, bits):
    mb, cfg, pp = _pair(arch)
    jqt = jq.quantize_pytree(mb.target_params, bits)
    jdq = dict(_jax_leaves(jq.dequantize_pytree(jqt)))
    pqt = quant.quantize_pytree(pp, bits)
    pdq = dict(quant.dequantize_pytree(pqt).named_parameters())
    n_quantized = 0
    for name, leaf in _jax_leaves(jqt):
        names = _per_layer(name, cfg.num_layers)
        # a stacked JAX leaf against the port's layers, stacked
        as_jax = np.stack if name.startswith("layers.") else (lambda ts: ts[0])
        got, want = as_jax([_np(pdq[n]) for n in names]), np.asarray(jdq[name])
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=name)
        qts = [pqt.leaves[n] for n in names]
        if not isinstance(leaf, jq.QTensor):
            assert not any(isinstance(t, quant.QTensor) for t in qts), name
            continue
        n_quantized += 1
        assert all(isinstance(t, quant.QTensor) and t.bits == bits for t in qts), name
        q = as_jax([t.q.numpy() for t in qts])
        assert q.dtype == np.int8
        np.testing.assert_array_equal(q, np.asarray(leaf.q), err_msg=name)
        np.testing.assert_array_equal(as_jax([t.scale.numpy() for t in qts]),
                                      np.asarray(leaf.scale), err_msg=name)
    # every leaf but final_norm.scale is a matrix in the JAX layout
    assert n_quantized == len(list(_jax_leaves(mb.target_params))) - 1


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_bytes_and_quant_error_match_jax(arch, bits):
    mb, _, pp = _pair(arch)
    assert quant.quantized_bytes(pp, bits) == jq.quantized_bytes(mb.target_params, bits)
    got, want = quant.quant_error(pp, bits), jq.quant_error(mb.target_params, bits)
    assert abs(got - want) <= 1e-6, (got, want)
    if bits < 16:
        assert 0 < got < 0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_bits8_target_logits_match_jax(arch):
    """A bits=8 target: the port's own quantization of the 16-bit weights is
    the JAX package's, and its prefill and decode logits follow the JAX
    forward."""
    mb = _jax_bundle(arch, 8)
    cfg = ModelConfig(**dataclasses.asdict(mb.target_cfg))
    pp = bridge.params_from_jax(cfg, jax.tree.map(np.asarray, mb.target_params), device="cpu")
    mine = quant.dequantize_pytree(quant.quantize_pytree(_pair(arch)[2], 8))
    for (name, a), b in zip(mine.named_parameters(), pp.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    pm, jm = build_model(cfg), mb.target
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t, c: jm.prefill(p, t, c, attn_chunk=32))(
        mb.target_params, jnp.asarray(toks[:, :8]), jm.make_cache(2, 64, attn_chunk=32))
    pl, pc = pm.prefill(pp, torch.from_numpy(toks[:, :8]),
                        pm.make_cache(2, 64, device="cpu", attn_chunk=32), attn_chunk=32)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL[arch], rtol=0)
    jh, _, _ = jax.jit(lambda p, c, t: jm.decode_forward(p, c, t, attn_chunk=32))(
        mb.target_params, jc, jnp.asarray(toks[:, 8:]))
    ph, _ = pm.decode_forward(pp, pc, torch.from_numpy(toks[:, 8:]), attn_chunk=32)
    np.testing.assert_allclose(pm.lm_head(pp, ph).numpy(),
                               np.asarray(jm.lm_head(mb.target_params, jh)),
                               atol=LOGIT_TOL[arch], rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_engine_streams_match_jax_reference(arch, bits):
    """A quantized target (the JAX bundle's, bridged, so both packages serve
    the same weights) served greedily by the port's engine gives the JAX
    reference's streams (its lock-step loop, which the JAX reference
    backend runs)."""
    mb = _jax_bundle(arch, bits)
    pb = _port_bundle(mb)
    key = "ln1.scale" if arch.startswith("qwen2") else "A_log"
    assert pb.target_params.layers[0].state_dict()[key].dtype == torch.bfloat16
    pspec = ServeSpec(devices=3, max_new=12, prompt_len=10,
                      model=dataclasses.replace(ServeSpec().model, arch=arch, draft_arch=arch,
                                                bits=bits))
    prompts = np.random.default_rng(5).integers(
        0, pspec.model.vocab_size, size=(pspec.devices, pspec.prompt_len)).astype(np.int32)
    want, _, _ = jax_loop.sled_generate(
        mb.draft, mb.draft_params, mb.target, mb.target_params, jnp.asarray(prompts),
        max_new=pspec.max_new, k_max=pspec.k_max, c_th=pspec.c_th, attn_chunk=pspec.attn_chunk,
        steps=_jax_steps(arch))
    got = System.build(pspec, models=pb, device="cpu").serve(prompts)
    _assert_same_tokens([got.outputs[i] for i in range(3)], list(want), mb, prompts)
    assert got.engine.rounds > 0
