"""Bridge between the JAX package's pytrees and the port's modules.

The JAX side hands over its parameter and cache pytrees as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, tree)``); nothing here imports JAX.
bf16 moves bit-exactly through a 16-bit integer view, as the JAX
checkpoint format stores it. Weights keep JAX's ``(in, out)`` layout, so a
weight is a plain copy. The stacked ``(L, ...)`` leaves of
``params["layers"]`` become the per-layer blocks of ``Transformer.layers``
(dense, vlm and moe families; a gelu MLP's ``wi``/``wd`` where a SwiGLU one
has ``wg``/``wu``/``wd``; a moe layer's router and expert tables stacked
``(L, E, ...)`` under ``params["layers"]["moe"]``) or ``Mamba2.layers``
(ssm family); the hybrid family's
``params["ssm_layers"]`` become ``Hybrid.layers`` and its
``params["shared_attn"]`` the one ``Hybrid.shared`` block. Caches move leaf
by leaf in their JAX layouts: bf16 or int8 K/V with the int8 scale leaves,
or the ssm and hybrid families' ``ssm``/``conv`` state (and the hybrid's
per-application K/V). A leaf keeps its JAX dtype: a
quantized bundle (``model.bits < 16``, dequantized at build time) carries
bf16 norm scales and SSM parameters where a 16-bit one has f32.

Going back, bf16 tensors come out as their ``uint16`` bits (the checkpoint
convention); ``arr.view(ml_dtypes.bfloat16)`` restores the dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.hybrid import Hybrid
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.transformer import CausalLM, Transformer
from repro_torch.runtime import resolve_device

# per family: port parameter name inside a layer -> path under the JAX
# stacked layers (params["layers"], the hybrid's params["ssm_layers"])
_LAYER_PARAMS = {
    "dense": {
        "ln1.scale": ("ln1", "scale"),
        "ln2.scale": ("ln2", "scale"),
        "attn.wq": ("attn", "wq"), "attn.wk": ("attn", "wk"),
        "attn.wv": ("attn", "wv"), "attn.wo": ("attn", "wo"),
        "attn.bq": ("attn", "bq"), "attn.bk": ("attn", "bk"), "attn.bv": ("attn", "bv"),
        "mlp.wg": ("mlp", "wg"), "mlp.wu": ("mlp", "wu"), "mlp.wi": ("mlp", "wi"),
        "mlp.wd": ("mlp", "wd"),
    },
    "ssm": {
        "norm.scale": ("norm", "scale"),
        **{name: (name,) for name in ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                                       "gnorm", "out_proj")},
    },
}
_LAYER_PARAMS["moe"] = {
    **{name: path for name, path in _LAYER_PARAMS["dense"].items() if path[0] != "mlp"},
    **{f"moe.{name}": ("moe", name) for name in ("router", "wg", "wu", "wd")},
}
_LAYER_PARAMS["hybrid"] = _LAYER_PARAMS["ssm"]
_LAYER_PARAMS["vlm"] = _LAYER_PARAMS["dense"]
_STACK_KEY = {"dense": "layers", "vlm": "layers", "moe": "layers", "ssm": "layers",
              "hybrid": "ssm_layers"}
# the hybrid's shared block: port name under ``shared`` -> path under the
# JAX params["shared_attn"] (the dense layer's names, without a stack axis)
_SHARED_PARAMS = _LAYER_PARAMS["dense"]
_MODELS = {"dense": Transformer, "vlm": Transformer, "moe": Transformer, "ssm": Mamba2,
           "hybrid": Hybrid}


def to_tensor(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy -> torch, bf16 (ml_dtypes or JAX bfloat16) bit-exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy; bf16 comes out as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _get(tree: Dict[str, Any], path) -> np.ndarray:
    for key in path:
        tree = tree[key]
    return tree


def _family(cfg) -> str:
    if cfg.family not in _MODELS:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the encdec family "
            "(ROADMAP.md Queue A, 'Other model families')"
        )
    return cfg.family


def params_from_jax(cfg, tree: Dict[str, Any], device="cuda") -> CausalLM:
    """The family's module (``Transformer``, ``Mamba2`` or ``Hybrid``) on
    ``device`` holding the JAX params pytree's weights."""
    device = resolve_device(device)
    family = _family(cfg)
    model = _MODELS[family](cfg, device=device)
    with torch.no_grad():
        _assign(model, "embed", to_tensor(tree["embed"], device))
        _assign(model, "final_norm.scale", to_tensor(tree["final_norm"]["scale"], device))
        if model.lm_head_w is not None:
            _assign(model, "lm_head_w", to_tensor(tree["lm_head"], device))
        for name, path in _LAYER_PARAMS[family].items():
            if _dotted(model.layers[0], name) is None:
                continue  # e.g. no QKV bias, or the other MLP's tables
            stacked = to_tensor(_get(tree[_STACK_KEY[family]], path), device)
            if stacked.shape[0] != cfg.num_layers:
                raise ValueError(f"layers/{'/'.join(path)} has {stacked.shape[0]} layers, "
                                 f"config has {cfg.num_layers}")
            for li in range(cfg.num_layers):
                _assign(model, f"layers.{li}.{name}", stacked[li])
        if family == "hybrid":
            for name, path in _SHARED_PARAMS.items():
                if _dotted(model.shared, name) is not None:
                    _assign(model, f"shared.{name}",
                            to_tensor(_get(tree["shared_attn"], path), device))
    return model


def _assign(model: CausalLM, name: str, value: torch.Tensor) -> None:
    """Copy ``value`` into parameter ``name``; a leaf whose dtype differs
    from the module's (the bf16 norm scales and SSM parameters of a
    quantized JAX bundle, f32 in a 16-bit one) replaces the parameter."""
    param = _dotted(model, name)
    if param.shape != value.shape:
        raise ValueError(f"{name}: shape {tuple(value.shape)}, the model has {tuple(param.shape)}")
    if param.dtype == value.dtype:
        param.copy_(value)
    else:
        model.set_weight(name, value.clone())


def params_to_jax(model: CausalLM) -> Dict[str, Any]:
    """The JAX params pytree layout, as numpy arrays (bf16 as uint16 bits)."""
    family = _family(model.cfg)
    layers: Dict[str, Any] = {}
    for name, path in _LAYER_PARAMS[family].items():
        if _dotted(model.layers[0], name) is None:
            continue
        stacked = torch.stack([_dotted(blk, name) for blk in model.layers])
        node = layers
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_numpy(stacked)
    tree: Dict[str, Any] = {
        "embed": to_numpy(model.embed),
        "final_norm": {"scale": to_numpy(model.final_norm.scale)},
        _STACK_KEY[family]: layers,
    }
    if family == "hybrid":
        shared: Dict[str, Any] = {}
        for name, path in _SHARED_PARAMS.items():
            if _dotted(model.shared, name) is not None:
                shared.setdefault(path[0], {})[path[1]] = to_numpy(_dotted(model.shared, name))
        tree["shared_attn"] = shared
    if model.lm_head_w is not None:
        tree["lm_head"] = to_numpy(model.lm_head_w)
    return tree


def cache_from_jax(tree: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """A JAX cache / ``PagedKVCache.cache`` pytree as the port's cache dict."""
    device = resolve_device(device)
    return {name: to_tensor(a, device) for name, a in tree.items()}


def cache_to_jax(cache: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {name: to_numpy(t) for name, t in cache.items()}


def _dotted(module, name: str):
    obj = module
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj
