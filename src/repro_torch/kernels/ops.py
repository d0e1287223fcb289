"""Public verification-attention ops in the JAX package's layouts.

A CUDA tensor goes to the Hopper kernel (``kernels/verify_attn.py``), a CPU
tensor to its plain version (``kernels/ref.py``); there is no other route.
``block_k`` sets the chunking of the plain version only: the CUDA kernel
tiles the cache in its own 64-position chunks.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref, verify_attn


def verify_attention(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k: torch.Tensor,         # (B, Skv, Hkv, D), or (L, B, Skv, Hkv, D) with layer
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # (B,) int32
    *,
    layer: Optional[int] = None,
    block_k: int = 64,
) -> torch.Tensor:
    """SLED verification attention over a dense cache (see verify_attn.cu)."""
    if q.is_cuda:
        return verify_attn.verify_attention_packed(q, k, v, kv_valid, layer=layer)
    if layer is not None:
        k, v = k[layer], v[layer]
    return ref.verify_attention_ref(q, k, v, kv_valid, block_k=block_k)


def verify_attention_paged(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k_pool: torch.Tensor,    # (n_slots+1, Skv, Hkv, D), or stacked with layer
    v_pool: torch.Tensor,
    slots: torch.Tensor,     # (B,) int32 pool row per batch entry
    kv_valid: torch.Tensor,  # (B,) int32
    *,
    layer: Optional[int] = None,
    block_k: int = 64,
) -> torch.Tensor:
    """Slot-indexed verification attention straight out of the cache pool."""
    if q.is_cuda:
        return verify_attn.verify_attention_paged(q, k_pool, v_pool, slots, kv_valid, layer=layer)
    if layer is not None:
        k_pool, v_pool = k_pool[layer], v_pool[layer]
    return ref.verify_attention_paged_ref(q, k_pool, v_pool, slots, kv_valid, block_k=block_k)
