"""Plain PyTorch versions of the port's kernels.

Attention (``kernels/csrc/verify_attn.cu``): an online softmax over
``block_k`` chunks of the cache with f32 running max / sum / accumulator,
f32 scores of the bf16 inputs, and P rounded to the value dtype before the
P.V product (the same steps as the JAX package's Pallas ``_attend_chunk``
and its XLA ``flash_attention``). An int8 cache is dequantized chunk by
chunk as ``(int8 -> f32 * scale) -> bf16``, the rounding of the JAX
package's ``kv_dequant``. With ``block_k`` equal to the model's
``attn_chunk`` they follow the JAX serving path step for step.

SSD scan (``kernels/csrc/ssd_scan.cu``): the chunked Mamba2 scan in f32,
the arithmetic of the JAX package's Pallas ``ssd_scan._kernel`` and of its
XLA ``mamba2.ssd_chunked`` (which pads a ragged last chunk with zeros; a
zero-padded row changes neither the outputs nor the state).

The CPU path of the port runs these; the CUDA path never calls them, and
``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def dequant(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """A (B, S, Hkv, D) int8 tile as bf16 with per-(row, head) scales
    (B, Hkv): ``(x -> f32 * scale) -> bf16``. Other dtypes pass through."""
    if x.dtype != torch.int8:
        return x
    if scale is None:
        raise ValueError("an int8 cache needs k_scale and v_scale")
    return (x.float() * scale[:, None, :, None].float()).to(torch.bfloat16)


def verify_attention_ref(
    q: torch.Tensor,         # (B, Sq, Hq, D) - the verify tokens' queries
    k: torch.Tensor,         # (B, Skv, Hkv, D) cache (buffer index == position)
    v: torch.Tensor,         # (B, Skv, Hkv, D)
    kv_valid: torch.Tensor,  # (B,) valid entries incl. the Sq new rows
    *,
    scale: Optional[float] = None,
    block_k: int = 64,
    k_scale: Optional[torch.Tensor] = None,  # (B, Hkv) f32, for an int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal-offset attention: query i sits at position kv_valid - Sq + i,
    and sees positions j <= kv_valid - Sq + i with j < Skv. An int8 cache
    takes its per-(row, head) dequant scales."""
    if k.dtype == torch.int8 and (k_scale is None or v_scale is None):
        raise ValueError("an int8 cache needs k_scale and v_scale")
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
        kb = dequant(k[:, j0:j1], k_scale).float()
        # rows no query may see are zeroed, so a stale value never meets a
        # zero weight (0 * NaN = NaN)
        row_seen = (j[None, :] <= q_pos[:, -1:]).reshape(B, j1 - j0, 1, 1)
        vb = dequant(v[:, j0:j1], v_scale)
        vb = torch.where(row_seen, vb, torch.zeros((), dtype=vb.dtype, device=dev))
        s = torch.einsum("bshgd,bchd->bshgc", qg, kb) * scale
        s = torch.where(visible[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bshgc,bchd->bshgd", p.to(vb.dtype).float(), vb.float()
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
    k_scale: Optional[torch.Tensor] = None,  # (n_slots+1, Hkv) f32, int8 pool
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pool-indexed version: gather the scheduled rows (and an int8 pool's
    scales), then dense attention. The gather is the traffic the kernel
    avoids; as a plain version it is the clearest statement of the
    semantics."""
    if k_pool.dtype == torch.int8 and (k_scale is None or v_scale is None):
        raise ValueError("an int8 pool needs k_scale and v_scale")
    idx = slots.to(k_pool.device, torch.int64)
    ks = k_scale[idx] if k_scale is not None else None
    vs = v_scale[idx] if v_scale is not None else None
    return verify_attention_ref(
        q, k_pool[idx], v_pool[idx], kv_valid, scale=scale, block_k=block_k,
        k_scale=ks, v_scale=vs,
    )


def ssd_scan_ref(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H) f32, post-softplus
    A: torch.Tensor,    # (H,) f32, negative
    Bm: torch.Tensor,   # (B, S, N)
    Cm: torch.Tensor,   # (B, S, N)
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) f32). Per chunk of Q = min(chunk, S) steps, with
    ``cum`` the running sum of ``dt * A``:
      carry-in   y_i += exp(cum_i) * C_i . h
      intra      y_i += sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
      state      h = exp(cum_Q) h + x^T (B * exp(cum_Q - cum) dt)
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    f32 = torch.float32
    xf, Bf, Cf, dtf = x.to(f32), Bm.to(f32), Cm.to(f32), dt.to(f32)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, pad))
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32).clone())
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(dtq * A.to(f32)[None, None], dim=1)  # (B, Q, H)
        y_off = torch.einsum("bqn,bhpn->bqhp", Cq, h) * torch.exp(cum)[..., None]
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B, i, j, H)
        decay = torch.where(tri[None, :, :, None], torch.exp(seg), torch.zeros((), device=x.device))
        cb = torch.einsum("bin,bjn->bij", Cq, Bq)
        W = cb[..., None] * decay * dtq[:, None, :, :]
        y_diag = torch.einsum("bijh,bjhp->bihp", W, xq)
        ys.append((y_off + y_diag).to(x.dtype))
        d_end = torch.exp(cum[:, -1:, :] - cum) * dtq  # (B, Q, H)
        h_new = torch.einsum("bqhp,bqhn->bhpn", xq, Bq[:, :, None, :] * d_end[..., None])
        h = torch.exp(cum[:, -1])[..., None, None] * h + h_new
    return torch.cat(ys, dim=1)[:, :S], h
