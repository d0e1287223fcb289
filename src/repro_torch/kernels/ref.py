"""Plain PyTorch versions of the port's kernels.

They repeat the kernels' arithmetic: an online softmax over ``block_k``
chunks of the cache with f32 running max / sum / accumulator, f32 scores of
the bf16 inputs, and P rounded to the value dtype before the P.V product
(``kernels/csrc/verify_attn.cu``; the same steps as the JAX package's Pallas
``_attend_chunk`` and its XLA ``flash_attention``). With ``block_k`` equal
to the model's ``attn_chunk`` they follow the JAX serving path step for
step, which is what the CPU path of the port runs. The CUDA path never
calls them; ``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def verify_attention_ref(
    q: torch.Tensor,         # (B, Sq, Hq, D) - the verify tokens' queries
    k: torch.Tensor,         # (B, Skv, Hkv, D) cache (buffer index == position)
    v: torch.Tensor,         # (B, Skv, Hkv, D)
    kv_valid: torch.Tensor,  # (B,) valid entries incl. the Sq new rows
    *,
    scale: Optional[float] = None,
    block_k: int = 64,
) -> torch.Tensor:
    """Causal-offset attention: query i sits at position kv_valid - Sq + i,
    and sees positions j <= kv_valid - Sq + i with j < Skv."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    q_pos = kv_valid.to(dev, torch.int64)[:, None] - Sq + torch.arange(Sq, device=dev)[None]
    kv_end = min(Skv, int(kv_valid.max()))  # chunks past every row's limit add nothing
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    for j0 in range(0, kv_end, block_k):
        j1 = min(j0 + block_k, Skv)
        j = torch.arange(j0, j1, device=dev)
        visible = j[None, None, :] <= q_pos[:, :, None]  # (B, Sq, C)
        kb = k[:, j0:j1].float()
        # rows no query may see are zeroed, so a stale value never meets a
        # zero weight (0 * NaN = NaN)
        row_seen = (j[None, :] <= q_pos[:, -1:]).reshape(B, j1 - j0, 1, 1)
        vb = torch.where(row_seen, v[:, j0:j1], torch.zeros((), dtype=v.dtype, device=dev))
        s = torch.einsum("bshgd,bchd->bshgc", qg, kb) * scale
        s = torch.where(visible[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bshgc,bchd->bshgd", p.to(v.dtype).float(), vb.float()
        )
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def verify_attention_paged_ref(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k_pool: torch.Tensor,    # (n_slots+1, Skv, Hkv, D) cache-row pool
    v_pool: torch.Tensor,
    slots: torch.Tensor,     # (B,) int32 pool row per batch entry (dups legal)
    kv_valid: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
    block_k: int = 64,
) -> torch.Tensor:
    """Pool-indexed version: gather the scheduled rows, then dense attention.
    The gather is the traffic the kernel avoids; as a plain version it is the
    clearest statement of the semantics."""
    idx = slots.to(k_pool.device, torch.int64)
    return verify_attention_ref(
        q, k_pool[idx], v_pool[idx], kv_valid, scale=scale, block_k=block_k
    )
