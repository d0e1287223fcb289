"""Launch wrappers for the Hopper verification-attention kernels.

``verify_attention_packed`` (dense KV) and ``verify_attention_paged`` (slot-
indexed pool KV) launch ``csrc/verify_attn.cu`` on PyTorch's current stream,
over a bf16 cache or an int8 cache with its per-(row, head) f32 scales.
They take CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to the
plain versions in ``kernels/ref.py``. Each wrapper adds one to
``LAUNCHES[<its name>]`` per kernel launch and nowhere else (an int8 cache
counts under ``<name>_int8``, a non-causal call, ``causal=False``, under
``<name>_noncausal``), so a run can show which kernels its path went
through.

``causal=False`` is the encdec family's case: the encoder's self-attention
over fresh K/V and cross-attention over the ``cross_k``/``cross_v`` leaves,
where every query row sees every position below its ``kv_valid``.

``verify_attention_packed(..., return_lse=True)`` is training's forward
(``kernels/ops.py``'s ``attention``): over a bf16 cache with no ``layer``
it also returns each query row's log-sum-exp, (B, Hq, Sq) f32 from the
kernel's merge (0 for a row that sees no position), which the backward
kernels take. Its ``out`` is the same bits as without it; the flag is
refused with a ``layer``, an int8 cache and on the paged entry, which
training does not run.

``verify_attention_packed_shard`` is the shard form over one sequence
shard of a dense bf16 cache (``distributed/collectives.py``'s
``sp_append_attend``; the JAX package's ``flash_attention(pos_offset=,
return_stats=True)``): the shard's position 0 is the global position
``pos_offset``, and it returns the shard's f32 output, normalised over the
shard and not rounded, with each row's log-sum-exp over the shard, -inf
(and output 0) for a row that sees none of it. It counts under
``verify_attention_packed_shard``.

The cache may be handed over as the model's stacked buffer
(L, rows, Skv, Hkv, D) with a ``layer`` index, and an int8 cache's scales as
the stacked (L, rows, Hkv) leaves: the kernel addresses the layer and row
through strides, so the layer loop never copies or gathers the cache.

The kernel splits the cache into fixed 64-position splits and merges them
in the same launch (see the source). Its scratch is kept here, one set per
device and grown as a call needs: an f32 buffer for the splits' partials
and the zeroed int32 block counter and flags the splits signal each other
with. The kernel returns every counter and flag it raises to zero, so the
calls on one stream share the scratch; calls on two streams at once would
not. ``release_scratch`` drops it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = {
    **{f"verify_attention_{entry}{kv}{mask}": 0
       for entry in ("packed", "paged") for kv in ("", "_int8") for mask in ("", "_noncausal")},
    "verify_attention_packed_shard": 0, "verify_attention_packed_shard_noncausal": 0,
}
HEAD_DIMS = (16, 64, 96, 128)  # 16: the reduced configs; the rest: the published ones

_ARGTYPES = {
    "verify_attn_bf16": (
        [ctypes.c_void_p] * 9       # q, k, v, kv_valid, slots, out, lse, part, sync
        + [ctypes.c_int] * 6        # B, Sq, Hq, Hkv, D, Skv
        + [ctypes.c_longlong] * 5   # layer, s_layer, s_row, s_seq, s_head
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, causal, stream
    ),
    "verify_attn_bf16_shard": (
        [ctypes.c_void_p] * 8       # q, k, v, kv_valid, out_f32, lse, part, sync
        + [ctypes.c_int] * 6        # B, Sq, Hq, Hkv, D, Skv
        + [ctypes.c_longlong] * 5   # layer, s_layer, s_row, s_seq, s_head
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # pos_offset, scale,
    ),                                                                  # causal, stream
    "verify_attn_int8": (
        [ctypes.c_void_p] * 10      # q, k, v, k_scale, v_scale, kv_valid, slots, out, part, sync
        + [ctypes.c_int] * 6        # B, Sq, Hq, Hkv, D, Skv
        + [ctypes.c_longlong] * 7   # layer, s_layer, s_row, s_seq, s_head, sc_layer, sc_row
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, causal, stream
    ),
    "verify_attn_scratch": (
        [ctypes.c_int] * 6                               # B, Sq, Hq, Hkv, D, Skv
        + [ctypes.POINTER(ctypes.c_longlong)] * 2        # -> partial floats, sync ints
    ),
}
# per device: (f32 partials, zeroed int32 counter and flags)
_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def release_scratch() -> None:
    """Drop every device's scratch (it keeps the largest call's size: a
    prefill of 2045 rows at G 48 over 4096 positions holds 12 GiB)."""
    _SCRATCH.clear()


def _function(symbol: str):
    fn = getattr(build.load("verify_attn"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = None if symbol == "verify_attn_scratch" else ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _scratch_sizes(dims: Tuple[int, ...]) -> Tuple[int, int]:
    """(f32 partials, int32 sync ints) one call of these dimensions needs."""
    n_part, n_sync = ctypes.c_longlong(), ctypes.c_longlong()
    _function("verify_attn_scratch")(*dims, ctypes.byref(n_part), ctypes.byref(n_sync))
    return n_part.value, n_sync.value


def _scratch(device: torch.device, dims: Tuple[int, ...]) -> Tuple[int, int]:
    """Pointers to the device's scratch, grown to what a call of these
    dimensions needs."""
    n_part, n_sync = _scratch_sizes(dims)
    part, sync = _SCRATCH.get(device, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty((max(n_part, 1 << 20),), dtype=torch.float32, device=device)
    if sync is None or sync.numel() < n_sync:
        sync = torch.zeros((max(n_sync, 4096),), dtype=torch.int32, device=device)
    _SCRATCH[device] = (part, sync)
    return part.data_ptr(), sync.data_ptr()


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


def _check(q, k, v, kv_valid, slots, k_scale, v_scale) -> None:
    tensors = [t for t in (q, k, v, kv_valid, slots, k_scale, v_scale) if t is not None]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA verify-attention kernels take CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k, v, kv_valid, slots and the scales must be on one device")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype not in (torch.bfloat16, torch.int8) or t.dtype != k.dtype:
            raise ValueError(f"{name} must be bfloat16 or int8 like k, got {t.dtype}")
    if k.dtype == torch.int8:
        _check_scales(k, k_scale, v_scale)
    elif k_scale is not None or v_scale is not None:
        raise ValueError("scales are for an int8 cache; this cache is bfloat16")
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
    # the kernel reads K/V in 16-byte vectors: 8 bf16 or 16 int8 elements
    vec = 16 // k.element_size()
    if any(s % vec for s in k.stride()[:-1]) or k.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"q, k and v must be 16-byte aligned with strides that are "
                         f"multiples of {vec} elements")
    for name, t in (("kv_valid", kv_valid), ("slots", slots)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 tensor")
    if Sq < 1 or B < 1:
        raise ValueError(f"empty query batch {tuple(q.shape)}")


def _check_scales(k, k_scale, v_scale) -> None:
    """int8 scales: (rows, Hkv) f32, or stacked (L, rows, Hkv) with ``layer``,
    one layout for both, the head contiguous."""
    if k_scale is None or v_scale is None:
        raise ValueError("an int8 cache needs k_scale and v_scale")
    want = tuple(k.shape[:-3]) + (k.shape[-2],)  # ([L,] rows, Hkv)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32 or tuple(t.shape) != want or t.stride(-1) != 1:
            raise ValueError(f"{name} must be a float32 {want} tensor with the head "
                             f"contiguous, got {t.dtype} {tuple(t.shape)}")
    if k_scale.stride() != v_scale.stride():
        raise ValueError("k_scale and v_scale must share one layout")


def _launch(name, q, k, v, kv_valid, slots, layer, scale, k_scale, v_scale, causal,
            return_lse=False):
    _check(q, k, v, kv_valid, slots, k_scale, v_scale)
    if return_lse and (slots is not None or layer is not None or k.dtype == torch.int8):
        raise ValueError("return_lse is for the dense entry over a bf16 cache with no layer "
                         "(training's forward)")
    li, s_layer = _cache_view(k, layer)
    B, Sq, Hq, D = q.shape
    s_row, s_seq, s_head = k.stride()[-4:-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    dims = (B, Sq, Hq, k.shape[-2], D, k.shape[-3])
    common = (*dims, li, s_layer, s_row, s_seq, s_head)
    slot_ptr = slots.data_ptr() if slots is not None else None
    with torch.cuda.device(q.device):
        scratch = _scratch(q.device, dims)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if k.dtype == torch.int8:
            name += "_int8"
            sc_layer = k_scale.stride(0) if layer is not None else 0
            rc = _function("verify_attn_int8")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), kv_valid.data_ptr(), slot_ptr, out.data_ptr(), *scratch,
                *common, sc_layer, k_scale.stride(-2), float(scale), int(causal), stream,
            )
        else:
            rc = _function("verify_attn_bf16")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(), slot_ptr,
                out.data_ptr(), None if lse is None else lse.data_ptr(), *scratch, *common,
                float(scale), int(causal), stream,
            )
    if not causal:
        name += "_noncausal"
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return (out, lse) if return_lse else out


def verify_attention_packed(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k: torch.Tensor,         # (B, Skv, Hkv, D), or (L, B, Skv, Hkv, D) with layer
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # (B,) int32
    *,
    layer: Optional[int] = None,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # int8 cache: (B, Hkv) f32, or (L, B, Hkv)
    v_scale: Optional[torch.Tensor] = None,
    causal: bool = True,
    return_lse: bool = False,
):
    """Dense verification attention: batch entry b attends cache row b.
    ``return_lse``: (out, each row's log-sum-exp (B, Hq, Sq) f32)."""
    if k.shape[-4] != q.shape[0]:
        raise ValueError(f"cache has {k.shape[-4]} rows for a batch of {q.shape[0]}")
    return _launch("verify_attention_packed", q, k, v, kv_valid, None, layer, scale,
                   k_scale, v_scale, causal, return_lse)


def verify_attention_packed_shard(
    q: torch.Tensor,         # (B, Sq, Hq, D) bf16
    k: torch.Tensor,         # (B, S_loc, Hkv, D) bf16, or (L, B, S_loc, Hkv, D) with layer
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # (B,) int32, global: may pass S_loc
    *,
    pos_offset: int,         # the global position of k[..., 0, :, :]
    layer: Optional[int] = None,
    scale: Optional[float] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shard form: query i of row b sits at the global position
    ``kv_valid[b] - Sq + i`` and sees local position j iff ``pos_offset + j``
    is at most that (``causal``) and below ``kv_valid[b]``. Returns (out,
    lse): the (B, Sq, Hq, D) f32 output normalised over the shard, and each
    row's (B, Hq, Sq) f32 log-sum-exp over it, -inf (out 0) for a row that
    sees no position of the shard."""
    if k.shape[-4] != q.shape[0]:
        raise ValueError(f"cache has {k.shape[-4]} rows for a batch of {q.shape[0]}")
    if k.dtype != torch.bfloat16:
        raise ValueError(f"the shard form reads a bfloat16 cache, got {k.dtype}")
    if int(pos_offset) < 0:
        raise ValueError(f"pos_offset must be >= 0, got {pos_offset}")
    _check(q, k, v, kv_valid, None, None, None)
    li, s_layer = _cache_view(k, layer)
    B, Sq, Hq, D = q.shape
    s_row, s_seq, s_head = k.stride()[-4:-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    dims = (B, Sq, Hq, k.shape[-2], D, k.shape[-3])
    with torch.cuda.device(q.device):
        scratch = _scratch(q.device, dims)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _function("verify_attn_bf16_shard")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *scratch, *dims, li, s_layer, s_row, s_seq, s_head,
            int(pos_offset), float(scale), int(causal), stream,
        )
    name = "verify_attention_packed_shard" + ("" if causal else "_noncausal")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return out, lse


def verify_attention_paged(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k_pool: torch.Tensor,    # (n_slots+1, Skv, Hkv, D), or (L, n_slots+1, ...) with layer
    v_pool: torch.Tensor,
    slots: torch.Tensor,     # (B,) int32 pool row per batch entry (dups legal)
    kv_valid: torch.Tensor,  # (B,) int32
    *,
    layer: Optional[int] = None,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # int8 pool: (n_slots+1, Hkv) f32, or stacked
    v_scale: Optional[torch.Tensor] = None,
    causal: bool = True,
    return_lse: bool = False,
) -> torch.Tensor:
    """Slot-indexed verification attention straight out of the cache pool.
    Slot ids are not range-checked on the device (that would cost a sync);
    callers pass rows of the pool they own. ``return_lse`` raises: training
    runs the dense entry."""
    return _launch("verify_attention_paged", q, k_pool, v_pool, kv_valid, slots, layer, scale,
                   k_scale, v_scale, causal, return_lse)
