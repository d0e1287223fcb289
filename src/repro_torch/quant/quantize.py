"""Weight-only quantization (int8 / int4, per-output-channel scales).

The port of ``repro.quant.quantize``, over the port's parameter modules
(``Transformer``, ``Mamba2``). The paper's Fig. 6 sweeps 16/8/4-bit
weights; a ``bits < 16`` target is served as the JAX package serves it:
quantized, then dequantized to bf16 at build time (``dequantize_pytree``),
so the forward runs on bf16 weights.

Three things follow the JAX package exactly, quirks included:
  * Which tensors are quantized is decided in the JAX package's layout,
    where each per-layer tensor is one layer of a stacked ``(L, ...)`` leaf:
    every float leaf with ndim >= 2 there. So every per-layer tensor of the
    port is quantized, 1-D ones too (biases, norm scales, the SSM's
    ``A_log``/``D``/``dt_bias``/``gnorm``); of the rest, ``embed`` and
    ``lm_head``, not ``final_norm.scale``. Scales are per row of the last
    axis, so quantizing layer by layer gives the stacked leaf's numbers.
  * ``dequantize_pytree`` returns every quantized tensor in bf16, f32 ones
    too: a quantized target's norm scales and SSM parameters are bf16.
  * bits=4 is stored in int8 with ``qmax = 7``, one value per byte (the JAX
    docstring's nibble packing does not exist); ``quantized_bytes`` counts
    ``n * bits // 8`` bytes of payload and ``shape[-2]`` f32 scales per
    stacked leaf, as the JAX function counts them.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, NamedTuple, Tuple, Union

import torch

_FLOATS = (torch.bfloat16, torch.float32, torch.float16)
_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")


class QTensor(NamedTuple):
    q: torch.Tensor      # int8 payload (bits=4: values in [-7, 7], one per byte)
    scale: torch.Tensor  # f32, one per row of the last axis
    bits: int
    shape: tuple


@dataclasses.dataclass
class QuantizedParams:
    """A parameter module's tensors by ``named_parameters`` name, the
    quantized ones as :class:`QTensor`, with what it takes to rebuild the
    module."""

    cls: type
    cfg: Any
    device: torch.device
    leaves: Dict[str, Union[QTensor, torch.Tensor]]


def quantize(w: torch.Tensor, bits: int) -> QTensor:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = 127 if bits == 8 else 7
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=-1, keepdim=True) / qmax, min=1e-12)
    q = torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(torch.int8)
    return QTensor(q=q, scale=scale, bits=bits, shape=tuple(w.shape))


def dequantize(t: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (t.q.float() * t.scale).to(dtype)


def jax_leaves(params) -> List[Tuple[str, Tuple[int, ...], List[str]]]:
    """The JAX parameter pytree's leaves as ``(name, stacked shape, the
    port's parameter names)``: a per-layer tensor of the port is one layer
    of a stacked ``(L, ...)`` leaf (``layers.<name>``)."""
    out: Dict[str, Tuple[Tuple[int, ...], List[str]]] = {}
    for name, p in params.named_parameters():
        m = _LAYER.match(name)
        key = f"layers.{m.group(2)}" if m else name
        shape, names = out.setdefault(key, (tuple(p.shape), []))
        names.append(name)
    return [(key, ((len(names),) + shape) if key.startswith("layers.") else shape, names)
            for key, (shape, names) in out.items()]


def _is_matrix(shape: Tuple[int, ...], dtype: torch.dtype) -> bool:
    return len(shape) >= 2 and dtype in _FLOATS


def quantize_pytree(params, bits: int):
    """Every matrix leaf (in the JAX layout, see the module note) as a
    :class:`QTensor`; ``bits >= 16`` returns ``params`` as they are."""
    if bits >= 16:
        return params
    tensors = dict(params.named_parameters())
    leaves: Dict[str, Union[QTensor, torch.Tensor]] = {}
    for _, shape, names in jax_leaves(params):
        for name in names:
            t = tensors[name]
            leaves[name] = quantize(t, bits) if _is_matrix(shape, t.dtype) else t
    return QuantizedParams(type(params), params.cfg, params.device, leaves)


def dequantize_pytree(qparams, dtype=torch.bfloat16):
    """A new parameter module holding the dequantized weights (``dtype``,
    bf16 by default, for every quantized tensor whatever its dtype was) and
    the untouched ones as they are; anything else is returned as it is."""
    if not isinstance(qparams, QuantizedParams):
        return qparams
    model = qparams.cls(qparams.cfg, device=qparams.device)
    with torch.no_grad():
        for name, t in qparams.leaves.items():
            model.set_weight(name, dequantize(t, dtype) if isinstance(t, QTensor) else t.clone())
    return model


def quantized_bytes(params, bits: int) -> int:
    """Model-weight footprint at the given precision, counted over the JAX
    layout's stacked leaves as the JAX package counts it."""
    tensors = dict(params.named_parameters())
    total = 0
    for _, shape, names in jax_leaves(params):
        dtype = tensors[names[0]].dtype
        n = sum(tensors[name].numel() for name in names)
        if _is_matrix(shape, dtype) and bits < 16:
            total += n * bits // 8 + shape[-2] * 4  # payload + scales
        else:
            total += n * tensors[names[0]].element_size()
    return total


def quant_error(params, bits: int) -> float:
    """Mean relative L2 error across the JAX layout's matrix leaves (a
    quality proxy); each leaf's norms run over all its layers."""
    if bits >= 16:
        return 0.0
    tensors = dict(params.named_parameters())
    errs = []
    with torch.no_grad():
        for _, shape, names in jax_leaves(params):
            if not _is_matrix(shape, tensors[names[0]].dtype):
                continue
            diff = ref = 0.0
            for name in names:
                w = tensors[name].float()
                d = dequantize(quantize(w, bits), torch.float32)
                diff += float((d - w).double().square().sum())
                ref += float(w.double().square().sum())
            errs.append(diff ** 0.5 / max(ref ** 0.5, 1e-9))
    return sum(errs) / max(len(errs), 1)
