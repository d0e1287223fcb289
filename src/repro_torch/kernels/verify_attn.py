"""Launch wrappers for the Hopper verification-attention kernels.

``verify_attention_packed`` (dense KV) and ``verify_attention_paged`` (slot-
indexed pool KV) launch ``csrc/verify_attn.cu`` on PyTorch's current stream.
They take CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to the
plain versions in ``kernels/ref.py``. Each wrapper adds one to
``LAUNCHES[<its name>]`` per kernel launch and nowhere else, so a run can
show which kernels its path went through.

The cache may be handed over as the model's stacked buffer
(L, rows, Skv, Hkv, D) with a ``layer`` index: the kernel addresses the
layer through strides, so the layer loop never copies the cache.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = {"verify_attention_packed": 0, "verify_attention_paged": 0}
HEAD_DIMS = (64, 128)

_ARGTYPES = (
    [ctypes.c_void_p] * 6       # q, k, v, kv_valid, slots, out
    + [ctypes.c_int] * 6        # B, Sq, Hq, Hkv, D, Skv
    + [ctypes.c_longlong] * 5   # layer, s_layer, s_row, s_seq, s_head
    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _function():
    fn = build.load("verify_attn").verify_attn_bf16
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _cache_view(k: torch.Tensor, layer: Optional[int]) -> Tuple[int, int]:
    """(layer index, layer stride) of a (rows, Skv, Hkv, D) or stacked
    (L, rows, Skv, Hkv, D) cache."""
    if layer is None:
        if k.dim() != 4:
            raise ValueError(f"cache must be (rows, Skv, Hkv, D), got {tuple(k.shape)}")
        return 0, 0
    if k.dim() != 5:
        raise ValueError(f"layer= needs a stacked (L, rows, Skv, Hkv, D) cache, got {tuple(k.shape)}")
    if not 0 <= layer < k.shape[0]:
        raise ValueError(f"layer {layer} outside the cache's {k.shape[0]} layers")
    return int(layer), k.stride(0)


def _check(q, k, v, kv_valid, slots) -> None:
    tensors = [q, k, v, kv_valid] + ([slots] if slots is not None else [])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA verify-attention kernels take CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k, v, kv_valid and slots must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous (B, Sq, Hq, D) tensor, got {tuple(q.shape)}")
    B, Sq, Hq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported by the CUDA kernel (one of {HEAD_DIMS})")
    if k.shape != v.shape or k.stride() != v.stride():
        raise ValueError("k and v must share one shape and one layout")
    if k.shape[-1] != D or k.stride(-1) != 1:
        raise ValueError(f"cache rows must be contiguous head_dim {D} vectors")
    Hkv = k.shape[-2]
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} is not a multiple of Hkv {Hkv}")
    # the kernel reads K/V in 16-byte vectors
    if any(s % 8 for s in k.stride()[:-1]) or k.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("q, k and v must be 16-byte aligned with strides that are multiples of 8")
    for name, t in (("kv_valid", kv_valid), ("slots", slots)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 tensor")
    if Sq < 1 or B < 1:
        raise ValueError(f"empty query batch {tuple(q.shape)}")


def _launch(name, q, k, v, kv_valid, slots, layer, scale) -> torch.Tensor:
    _check(q, k, v, kv_valid, slots)
    li, s_layer = _cache_view(k, layer)
    B, Sq, Hq, D = q.shape
    s_row, s_seq, s_head = k.stride()[-4:-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _function()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
            slots.data_ptr() if slots is not None else None, out.data_ptr(),
            B, Sq, Hq, k.shape[-2], D, k.shape[-3],
            li, s_layer, s_row, s_seq, s_head, float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def verify_attention_packed(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k: torch.Tensor,         # (B, Skv, Hkv, D), or (L, B, Skv, Hkv, D) with layer
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # (B,) int32
    *,
    layer: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense verification attention: batch entry b attends cache row b."""
    if k.shape[-4] != q.shape[0]:
        raise ValueError(f"cache has {k.shape[-4]} rows for a batch of {q.shape[0]}")
    return _launch("verify_attention_packed", q, k, v, kv_valid, None, layer, scale)


def verify_attention_paged(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k_pool: torch.Tensor,    # (n_slots+1, Skv, Hkv, D), or (L, n_slots+1, ...) with layer
    v_pool: torch.Tensor,
    slots: torch.Tensor,     # (B,) int32 pool row per batch entry (dups legal)
    kv_valid: torch.Tensor,  # (B,) int32
    *,
    layer: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Slot-indexed verification attention straight out of the cache pool.
    Slot ids are not range-checked on the device (that would cost a sync);
    callers pass rows of the pool they own."""
    return _launch("verify_attention_paged", q, k_pool, v_pool, kv_valid, slots, layer, scale)
