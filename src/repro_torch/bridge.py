"""Bridge between the JAX package's pytrees and the port's modules.

The JAX side hands over its parameter and cache pytrees as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, tree)``); nothing here imports JAX.
bf16 moves bit-exactly through a 16-bit integer view, as the JAX
checkpoint format stores it. Weights keep JAX's ``(in, out)`` layout, so a
weight is a plain copy. The stacked ``(L, ...)`` leaves of
``params["layers"]`` become the per-layer blocks of ``Transformer.layers``
(dense, vlm, moe and encdec families; a gelu MLP's ``wi``/``wd`` where a
SwiGLU one has ``wg``/``wu``/``wd``; a moe layer's router and expert tables
stacked ``(L, E, ...)`` under ``params["layers"]["moe"]``; a layernorm's
``bias`` beside its ``scale``; an encdec decoder layer's ``ln_x`` and
``xattn``) or ``Mamba2.layers`` (ssm family); a learned ``pos_embed`` and
the encdec encoder's ``enc/{pos_embed,layers,final_norm}`` move as they
are (the encoder's stacked layers into ``Transformer.enc.layers``); the
hybrid family's
``params["ssm_layers"]`` become ``Hybrid.layers`` and its
``params["shared_attn"]`` the one ``Hybrid.shared`` block. Caches move leaf
by leaf in their JAX layouts: bf16 or int8 K/V with the int8 scale leaves,
or the ssm and hybrid families' ``ssm``/``conv`` state (and the hybrid's
per-application K/V). A leaf keeps its JAX dtype: a
quantized bundle (``model.bits < 16``, dequantized at build time) carries
bf16 norm scales and SSM parameters where a 16-bit one has f32.

Going back, bf16 tensors come out as their ``uint16`` bits (the checkpoint
convention); ``arr.view(ml_dtypes.bfloat16)`` restores the dtype.
``params_tree`` gives the same tree with torch tensors as its leaves (bf16
kept as bf16), the form ``repro_torch.checkpoint`` saves and restores, and
``params_from_jax`` also takes such a tree.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

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
        "ln1.scale": ("ln1", "scale"), "ln1.bias": ("ln1", "bias"),
        "ln2.scale": ("ln2", "scale"), "ln2.bias": ("ln2", "bias"),
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
_LAYER_PARAMS["vlm"] = _LAYER_PARAMS["encdec"] = _LAYER_PARAMS["dense"]
# what a decoder layer adds where ``cfg.is_encdec`` (as in JAX, the flag and
# not the family decides): its cross-attention and the norm before it
_CROSS_PARAMS = {
    "ln_x.scale": ("ln_x", "scale"), "ln_x.bias": ("ln_x", "bias"),
    **{f"xattn.{name}": ("xattn", name) for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")},
}
_STACK_KEY = {"dense": "layers", "vlm": "layers", "moe": "layers", "ssm": "layers",
              "hybrid": "ssm_layers", "encdec": "layers"}
# the hybrid's shared block: port name under ``shared`` -> path under the
# JAX params["shared_attn"] (the dense layer's names, without a stack axis)
_SHARED_PARAMS = _LAYER_PARAMS["dense"]
_MODELS = {"dense": Transformer, "vlm": Transformer, "moe": Transformer, "ssm": Mamba2,
           "hybrid": Hybrid, "encdec": Transformer}
# the final norm's leaves (a layernorm has a bias)
_NORM_PARAMS = {"scale": ("scale",), "bias": ("bias",)}


def to_tensor(arr, device="cpu") -> torch.Tensor:
    """numpy -> torch, bf16 (ml_dtypes or JAX bfloat16) bit-exactly; a torch
    tensor moves to ``device`` as it is."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.array(arr, order="C")  # a C-ordered copy; a 0-d leaf stays 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


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
        raise ValueError(f"unknown model family {cfg.family!r} (one of {sorted(_MODELS)})")
    return cfg.family


def _layer_params(cfg) -> Dict[str, Any]:
    """Port name -> JAX path of a stacked layer's leaves."""
    names = _LAYER_PARAMS[_family(cfg)]
    return {**names, **_CROSS_PARAMS} if cfg.is_encdec else names


def params_from_jax(cfg, tree: Dict[str, Any], device="cuda") -> CausalLM:
    """The family's module (``Transformer``, ``Mamba2`` or ``Hybrid``) on
    ``device`` holding the JAX params pytree's weights (numpy leaves, or the
    torch leaves of ``params_tree``)."""
    device = resolve_device(device)
    family = _family(cfg)
    kw = {"max_pos": tree["pos_embed"].shape[0]} if "pos_embed" in tree else {}
    model = _MODELS[family](cfg, device=device, **kw)
    _load(model, tree, device)
    return model


def load_params_(model: CausalLM, tree: Dict[str, Any]) -> CausalLM:
    """Copy a params tree (the JAX layout; numpy or torch leaves, any float
    dtype) into ``model``'s parameters in place, each converted to the
    parameter's own dtype (round to nearest even, as JAX's ``astype``):
    the train step's ``cast_like`` of the f32 master weights, without a
    second tree."""
    _load(model, tree, model.device, cast=True)
    return model


def _load(model: CausalLM, tree: Dict[str, Any], device, cast: bool = False) -> None:
    cfg = model.cfg
    family = _family(cfg)
    _assign = functools.partial(_assign_leaf, cast=cast)
    _assign_stack = functools.partial(_assign_stack_leaves, assign=_assign)
    _assign_block = functools.partial(_assign_block_leaves, assign=_assign)
    with torch.no_grad():
        _assign(model, "embed", to_tensor(tree["embed"], device))
        _assign_block(model, "final_norm", model.final_norm, tree["final_norm"], _NORM_PARAMS,
                      device)
        if model.lm_head_w is not None:
            _assign(model, "lm_head_w", to_tensor(tree["lm_head"], device))
        if getattr(model, "pos_embed", None) is not None:
            _assign(model, "pos_embed", to_tensor(tree["pos_embed"], device))
        _assign_stack(model, "layers", tree[_STACK_KEY[family]], _layer_params(cfg), device)
        if getattr(model, "enc", None) is not None:
            enc = tree["enc"]
            _assign(model, "enc.pos_embed", to_tensor(enc["pos_embed"], device))
            _assign_stack(model, "enc.layers", enc["layers"], _LAYER_PARAMS["dense"], device)
            _assign_block(model, "enc.final_norm", model.enc.final_norm, enc["final_norm"],
                          _NORM_PARAMS, device)
        if family == "hybrid":
            _assign_block(model, "shared", model.shared, tree["shared_attn"], _SHARED_PARAMS,
                          device)


def _assign_stack_leaves(model: CausalLM, prefix: str, stack: Dict[str, Any], names, device,
                         assign) -> None:
    """The stacked (L, ...) leaves under ``stack`` into the blocks of the
    ModuleList ``prefix``, for each port name the blocks have."""
    blocks = _dotted(model, prefix)
    for name, path in names.items():
        if _dotted(blocks[0], name) is None:
            continue  # e.g. no QKV bias, an RMSNorm's bias, or the other MLP's tables
        stacked = to_tensor(_get(stack, path), device)
        if stacked.shape[0] != len(blocks):
            raise ValueError(f"{prefix}/{'/'.join(path)} has {stacked.shape[0]} layers, "
                             f"the model has {len(blocks)}")
        for li in range(len(blocks)):
            assign(model, f"{prefix}.{li}.{name}", stacked[li])


def _assign_block_leaves(model: CausalLM, prefix: str, block, tree: Dict[str, Any], names,
                         device, assign) -> None:
    """The leaves of one unstacked block (a norm, the hybrid's shared block)."""
    for name, path in names.items():
        if _dotted(block, name) is not None:
            assign(model, f"{prefix}.{name}", to_tensor(_get(tree, path), device))


def _assign_leaf(model: CausalLM, name: str, value: torch.Tensor, cast: bool = False) -> None:
    """Copy ``value`` into parameter ``name``; unless ``cast``, a leaf whose
    dtype differs from the module's (the bf16 norm scales and SSM
    parameters of a quantized JAX bundle, f32 in a 16-bit one) replaces the
    parameter."""
    param = _dotted(model, name)
    if param.shape != value.shape:
        raise ValueError(f"{name}: shape {tuple(value.shape)}, the model has {tuple(param.shape)}")
    if cast or param.dtype == value.dtype:
        param.copy_(value)
    else:
        model.set_weight(name, value.clone())


def param_paths(model: CausalLM) -> List[Tuple[str, Tuple[str, ...], Optional[int]]]:
    """(port parameter name, JAX path, layer) for every parameter of
    ``model``: ``layer`` is the block's index under a stacked (L, ...) JAX
    leaf, None for an unstacked one (the order of ``params_tree``)."""
    cfg = model.cfg
    family = _family(cfg)
    out: List[Tuple[str, Tuple[str, ...], Optional[int]]] = [("embed", ("embed",), None)]

    def block(prefix, blk, names, root):
        for name, path in names.items():
            if _dotted(blk, name) is not None:
                out.append((f"{prefix}.{name}", root + path, None))

    def stack(prefix, blocks, names, root):
        for li in range(len(blocks)):
            for name, path in names.items():
                if _dotted(blocks[li], name) is not None:
                    out.append((f"{prefix}.{li}.{name}", root + path, li))

    block("final_norm", model.final_norm, _NORM_PARAMS, ("final_norm",))
    stack("layers", model.layers, _layer_params(cfg), (_STACK_KEY[family],))
    if family == "hybrid":
        block("shared", model.shared, _SHARED_PARAMS, ("shared_attn",))
    if model.lm_head_w is not None:
        out.append(("lm_head_w", ("lm_head",), None))
    if getattr(model, "pos_embed", None) is not None:
        out.append(("pos_embed", ("pos_embed",), None))
    if getattr(model, "enc", None) is not None:
        out.append(("enc.pos_embed", ("enc", "pos_embed"), None))
        stack("enc.layers", model.enc.layers, _LAYER_PARAMS["dense"], ("enc", "layers"))
        block("enc.final_norm", model.enc.final_norm, _NORM_PARAMS, ("enc", "final_norm"))
    return out


def _put(tree: Dict[str, Any], path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _detached(p: torch.Tensor) -> torch.Tensor:
    return p.detach()


def _grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _stack_tree(blocks, names, leaf=_detached) -> Dict[str, Any]:
    """The JAX stacked (L, ...) subtree of a ModuleList's blocks."""
    tree: Dict[str, Any] = {}
    for name, path in names.items():
        if _dotted(blocks[0], name) is not None:
            _put(tree, path, torch.stack([leaf(_dotted(blk, name)) for blk in blocks]))
    return tree


def _block_tree(block, names, leaf=_detached) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, path in names.items():
        if _dotted(block, name) is not None:
            _put(tree, path, leaf(_dotted(block, name)))
    return tree


def params_tree(model: CausalLM, leaf=_detached) -> Dict[str, Any]:
    """The JAX params pytree layout with torch tensors as leaves (bf16 kept
    as bf16, on the model's device); ``leaf`` maps each parameter to the
    tensor stored for it (``grads_tree`` takes its gradient)."""
    family = _family(model.cfg)
    tree: Dict[str, Any] = {
        "embed": leaf(model.embed),
        "final_norm": _block_tree(model.final_norm, _NORM_PARAMS, leaf),
        _STACK_KEY[family]: _stack_tree(model.layers, _layer_params(model.cfg), leaf),
    }
    if family == "hybrid":
        tree["shared_attn"] = _block_tree(model.shared, _SHARED_PARAMS, leaf)
    if model.lm_head_w is not None:
        tree["lm_head"] = leaf(model.lm_head_w)
    if getattr(model, "pos_embed", None) is not None:
        tree["pos_embed"] = leaf(model.pos_embed)
    if getattr(model, "enc", None) is not None:
        tree["enc"] = {
            "pos_embed": leaf(model.enc.pos_embed),
            "layers": _stack_tree(model.enc.layers, _LAYER_PARAMS["dense"], leaf),
            "final_norm": _block_tree(model.enc.final_norm, _NORM_PARAMS, leaf),
        }
    return tree


def grads_tree(model: CausalLM) -> Dict[str, Any]:
    """The parameters' gradients in the JAX params layout (what
    ``jax.value_and_grad`` returns): bf16 for bf16 parameters, zeros where
    a parameter took no gradient (JAX's zero cotangent)."""
    return params_tree(model, _grad)


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def params_to_jax(model: CausalLM) -> Dict[str, Any]:
    """The JAX params pytree layout, as numpy arrays (bf16 as uint16 bits)."""
    return _map(to_numpy, params_tree(model))


def cache_from_jax(tree: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """A JAX cache / ``PagedKVCache.cache`` pytree as the port's cache dict."""
    device = resolve_device(device)
    return {name: to_tensor(a, device) for name, a in tree.items()}


def cache_to_jax(cache: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {name: to_numpy(t) for name, t in cache.items()}


def _dotted(module, name: str):
    """Attribute ``name`` (dotted) of ``module``; None where a part is None
    (no QKV bias, an RMSNorm's bias, the other MLP's tables). A part the
    module lacks raises AttributeError."""
    obj = module
    for part in name.split("."):
        obj = getattr(obj, part)
        if obj is None:
            return None
    return obj
