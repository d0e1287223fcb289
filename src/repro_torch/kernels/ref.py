"""Plain PyTorch versions of the port's kernels.

Attention (``kernels/csrc/verify_attn.cu``): an online softmax over
``block_k`` chunks of the cache with f32 running max / sum / accumulator,
f32 scores of the bf16 inputs, and P rounded to the value dtype before the
P.V product (the same steps as the JAX package's Pallas ``_attend_chunk``
and its XLA ``flash_attention``). A masked position weighs exactly 0, so a
query row that sees no position (kv_valid < Sq, outside the JAX kernels'
contract) gives 0. An int8 cache is dequantized chunk by
chunk as ``(int8 -> f32 * scale) -> bf16``, the rounding of the JAX
package's ``kv_dequant``. With ``block_k`` equal to the model's
``attn_chunk`` they follow the JAX serving path step for step.

``causal=False`` (the encoder's self-attention and cross-attention) lets
every query row see every position ``j < kv_valid`` (and ``j < Skv``), as
the JAX package's ``flash_attention(causal=False)`` does, in the same
chunk order.

SSD scan (``kernels/csrc/ssd_scan.cu``): the chunked Mamba2 scan in f32,
the arithmetic of the JAX package's Pallas ``ssd_scan._kernel`` and of its
XLA ``mamba2.ssd_chunked`` (which pads a ragged last chunk with zeros; a
zero-padded row changes neither the outputs nor the state). The decay
exp(cum_i - cum_j) is taken on the causal triangle only: the exponent is
masked to -inf above the diagonal before the exp, where JAX masks the exp's
result. The values are the same; but above the diagonal cum_i - cum_j is
positive, and once a chunk's |sum dt A| passes ~88 its exp overflows, so
JAX's gradient there is 0 * inf = NaN where autograd's of this one stays
finite (a recorded departure). The backward kernels of the same source
have the closed form ``ssd_scan_bwd_ref``.

The CPU path of the port runs these; the CUDA path never calls them, and
``chip_smoke.py`` holds the kernels against them on the card.

Three more plain versions restate the kernels' own decompositions and
serve the tests only (nothing on a serving or training path calls them):
``verify_attention_split_ref`` cuts the cache into fixed splits, each
rounded at its running max, and merges them in split order,
``attention_bwd_split_ref`` is the backward kernels' (the LSE from the
split forward, dS rounded to bf16 for dQ and dK, dK and dV as
per-query-head f32 partials summed in head order), and
``ssd_scan_sliced_ref`` computes C.B^T once per (b, chunk) and the rest
P-slice by P-slice, optionally with the chunk's running sum in the
kernel's order (``warp_scan_cumsum``), and ``ssd_scan_bwd_split_ref`` is
the SSD backward kernels' (a reverse pass for each chunk's end cotangent
but the last, a pass per (b, chunk, head) that forms its Gram blocks
itself and, with one chunk, dh0, per-head partials of dB, dC and dA, and
their sums in head and (b, chunk) order).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

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


def query_limits(kv_valid: torch.Tensor, Sq: int, causal: bool, device) -> torch.Tensor:
    """(B, Sq) the last position each query row sees: kv_valid - Sq + i
    (query i's own position) when causal, else kv_valid - 1 for every row."""
    kv = kv_valid.to(device, torch.int64)[:, None]
    if causal:
        return kv - Sq + torch.arange(Sq, device=device)[None]
    return (kv - 1).expand(-1, Sq)


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
    causal: bool = True,
) -> torch.Tensor:
    """Causal-offset attention: query i sits at position kv_valid - Sq + i,
    and sees positions j <= kv_valid - Sq + i with j < Skv; with
    ``causal=False`` every query sees every j < kv_valid. An int8 cache
    takes its per-(row, head) dequant scales."""
    B, Sq, Hq, D = q.shape
    acc, _, l = _online_softmax(q, k, v, kv_valid, 0, scale=scale, block_k=block_k,
                                k_scale=k_scale, v_scale=v_scale, causal=causal)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def verify_attention_shard_ref(
    q: torch.Tensor,         # (B, Sq, Hq, D) bf16
    k: torch.Tensor,         # (B, S_loc, Hkv, D): one sequence shard of the cache
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # (B,) global valid entries incl. the Sq new rows
    pos_offset: int,         # the global position of k[:, 0]
    *,
    scale: Optional[float] = None,
    block_k: int = 64,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shard form of ``verify_attention_ref`` (the CUDA kernel's
    ``verify_attention_packed_shard``; the JAX package's
    ``flash_attention(pos_offset=, return_stats=True)``): local position j is
    the global position ``pos_offset + j``, visible to query i of row b iff
    it is at most ``kv_valid[b] - Sq + i`` (``causal``) and below
    ``kv_valid[b]``. Returns (out, lse): (B, Sq, Hq, D) f32 normalised over
    the shard, acc / max(l, 1e-30), and (B, Hq, Sq) f32 m + log(l), -inf
    with out 0 for a row that sees no position of the shard."""
    B, Sq, Hq, D = q.shape
    acc, m, l = _online_softmax(q, k, v, kv_valid, int(pos_offset), scale=scale,
                                block_k=block_k, causal=causal)
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, Sq, Hq, D)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, -math.inf))
    return out, lse.reshape(B, Sq, Hq).transpose(1, 2).contiguous()


def _online_softmax(q, k, v, kv_valid, pos_offset: int, *, scale, block_k, k_scale=None,
                    v_scale=None, causal=True):
    """(acc (B, Sq, Hkv, G, D), m, l (B, Sq, Hkv, G)) f32 of the online
    softmax over ``block_k`` chunks of k/v, whose position 0 is the global
    position ``pos_offset``."""
    if k.dtype == torch.int8 and (k_scale is None or v_scale is None):
        raise ValueError("an int8 cache needs k_scale and v_scale")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    q_pos = query_limits(kv_valid, Sq, causal, dev) - pos_offset  # local limits
    # chunks past every row's limit add nothing
    kv_end = max(0, min(Skv, int(kv_valid.max()) - pos_offset))
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    for j0 in range(0, kv_end, block_k):
        j1 = min(j0 + block_k, Skv)
        j = torch.arange(j0, j1, device=dev)
        visible = (j[None, None, :] <= q_pos[:, :, None])[:, :, None, None, :]  # (B, Sq, 1, 1, C)
        kb = dequant(k[:, j0:j1], k_scale).float()
        # rows no query may see are zeroed, so a stale value never meets a
        # zero weight (0 * NaN = NaN)
        row_seen = (j[None, :] <= q_pos[:, -1:]).reshape(B, j1 - j0, 1, 1)
        vb = dequant(v[:, j0:j1], v_scale)
        vb = torch.where(row_seen, vb, torch.zeros((), dtype=vb.dtype, device=dev))
        s = torch.einsum("bshgd,bchd->bshgc", qg, kb) * scale
        s = torch.where(visible, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # masked positions weigh exactly 0, also while a row has seen nothing
        # (m_new = NEG_INF), so a row with no visible position gives 0
        p = torch.where(visible, torch.exp(s - m_new[..., None]), torch.zeros((), device=dev))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bshgc,bchd->bshgd", p.to(vb.dtype).float(), vb.float()
        )
        m = m_new
    return acc, m, l


def verify_attention_split_ref(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k: torch.Tensor,         # (B, Skv, Hkv, D)
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # (B,)
    *,
    split: int,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    causal: bool = True,
    return_lse: bool = False,
):
    """The CUDA kernel's decomposition (tests only): the cache in fixed
    ``split``-position splits, each computed on its own once the splits
    before it have published their rows' local maxima: m_s the running max
    through split s, P_s = exp(S - m_s) rounded to the value dtype, l_s the
    sum of the unrounded values and acc_s = P_s V; then merged in split order
    by the online softmax's chain, acc = acc * e^{m_{s-1} - m_s} + acc_s and
    l likewise, out = acc / max(l, 1e-30). With ``split`` equal to
    ``verify_attention_ref``'s ``block_k`` the two compute the same values
    in the same steps. ``return_lse``: also each row's log-sum-exp as the
    kernel writes it from the merge, m + log(l) (0 where l == 0, a row that
    sees no position), (B, Hq, Sq) f32."""
    if k.dtype == torch.int8 and (k_scale is None or v_scale is None):
        raise ValueError("an int8 cache needs k_scale and v_scale")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    q_pos = query_limits(kv_valid, Sq, causal, dev)
    kv_end = min(Skv, int(kv_valid.max()))
    splits = []  # per split: (masked S, visible, V rows), as every split computes them at once
    for j0 in range(0, kv_end, split):
        j = torch.arange(j0, min(j0 + split, Skv), device=dev)
        visible = (j[None, None, :] <= q_pos[:, :, None])[:, :, None, None, :]
        row_seen = (j[None, :] <= q_pos[:, -1:]).reshape(B, j.numel(), 1, 1)
        vb = dequant(v[:, j0:j0 + j.numel()], v_scale)
        vb = torch.where(row_seen, vb, torch.zeros((), dtype=vb.dtype, device=dev))
        sc = torch.einsum("bshgd,bchd->bshgc", qg,
                          dequant(k[:, j0:j0 + j.numel()], k_scale).float()) * scale
        splits.append((torch.where(visible, sc, torch.full_like(sc, NEG_INF)), visible, vb))
    if not splits:
        out = torch.zeros_like(q)
        lse = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=dev)
        return (out, lse) if return_lse else out
    local_max = torch.stack([sc.amax(dim=-1) for sc, _, _ in splits])
    running_max = torch.cummax(local_max, dim=0).values  # what each split reads of the others
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    for (sc, visible, vb), m_s in zip(splits, running_max):
        p = torch.where(visible, torch.exp(sc - m_s[..., None]), torch.zeros((), device=dev))
        acc_s = torch.einsum("bshgc,bchd->bshgd", p.to(vb.dtype).float(), vb.float())
        corr = torch.exp(m - m_s)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + acc_s
        m = m_s
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, Sq, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.zeros((), device=dev))
    return out, lse.reshape(B, Sq, Hq).transpose(1, 2).contiguous()


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
    causal: bool = True,
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
        k_scale=ks, v_scale=vs, causal=causal,
    )


def _bwd_scale(q: torch.Tensor) -> float:
    """The forward's score scale 1 / sqrt(D), which the backward differentiates."""
    return 1.0 / math.sqrt(q.shape[-1])


def _bwd_scores(q, k, kv_valid, causal):
    """f32 scores (B, Sq, Hkv, G, Skv) of the backward and their mask."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bshgd,bchd->bshgc", qg, k.float()) * _bwd_scale(q)
    lim = query_limits(kv_valid, Sq, causal, q.device)
    visible = (torch.arange(Skv, device=q.device)[None, None, :] <= lim[:, :, None])
    return s, visible[:, :, None, None, :]


def attention_lse_ref(q, k, kv_valid, *, causal: bool = True) -> torch.Tensor:
    """Each query row's log-sum-exp over the positions it sees, in one pass
    over the whole row (f32; 0 for a row that sees none), (B, Hq, Sq): the
    oracle of the LSE the forward kernel keeps from its merge
    (``verify_attention_split_ref(return_lse=True)`` restates that)."""
    B, Sq, Hq, D = q.shape
    s, visible = _bwd_scores(q, k, kv_valid, causal)
    s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    l = torch.where(visible, torch.exp(s - m), torch.zeros((), device=q.device)).sum(-1)
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)),
                      torch.zeros((), device=q.device))
    return lse.reshape(B, Sq, Hq).transpose(1, 2).contiguous()


def attention_bwd_delta_ref(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The plain version of ``attn_bwd_delta``: Delta = sum_d dO * O of each
    query row and head in f32, (B, Hq, Sq)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_probs(q, k, v, dout, kv_valid, lse, delta, causal):
    """P = exp(S - LSE) under the mask (f32) and dS = P * (dP - Delta), with
    dP = dO V^T, each (B, Sq, Hkv, G, Skv)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s, visible = _bwd_scores(q, k, kv_valid, causal)
    lse_r = lse.transpose(1, 2).reshape(B, Sq, Hkv, G, 1)
    p = torch.where(visible, torch.exp(s - lse_r), torch.zeros((), device=q.device))
    dog = dout.reshape(B, Sq, Hkv, G, D).float()
    dp = torch.einsum("bshgd,bchd->bshgc", dog, v.float())
    ds = p * (dp - delta.transpose(1, 2).reshape(B, Sq, Hkv, G, 1))
    return p, ds, dog


def attention_bwd_dkdv_ref(q, k, v, dout, kv_valid, lse, delta, *, causal: bool = True):
    """The plain version of ``attn_bwd_dkdv``: dV = P^T dO with P rounded to
    the value dtype first (as the forward rounds it before P.V) and dK =
    dS^T Q * scale, summed over the G query heads of each KV head in f32."""
    p, ds, dog = _bwd_probs(q, k, v, dout, kv_valid, lse, delta, causal)
    qg = q.reshape(dog.shape).float()
    dv = torch.einsum("bshgc,bshgd->bchd", p.to(v.dtype).float(), dog)
    dk = torch.einsum("bshgc,bshgd->bchd", ds, qg) * _bwd_scale(q)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_dq_ref(q, k, v, dout, kv_valid, lse, delta, *, causal: bool = True):
    """The plain version of ``attn_bwd_dq``: dQ = dS K * scale."""
    B, Sq, Hq, D = q.shape
    _, ds, _ = _bwd_probs(q, k, v, dout, kv_valid, lse, delta, causal)
    dq = torch.einsum("bshgc,bchd->bshgd", ds, k.float()) * _bwd_scale(q)
    return dq.reshape(B, Sq, Hq, D).to(q.dtype)


def attention_bwd_ref(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k: torch.Tensor,         # (B, Skv, Hkv, D) fresh K/V (no cache, no layer)
    v: torch.Tensor,
    out: torch.Tensor,       # (B, Sq, Hq, D) the forward's output
    dout: torch.Tensor,      # (B, Sq, Hq, D) its gradient
    kv_valid: torch.Tensor,  # (B,)
    *,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of ``verify_attention_ref`` in the backward kernels'
    decomposition (``kernels/csrc/attn_bwd.cu``): the row LSE recomputed in
    f32 (``attention_lse_ref``; on the card it is the forward kernel's),
    Delta = rowsum(dO * O), P = exp(S - LSE) under the forward's mask
    (causal-offset limit ``kv_valid - Sq + i``, or ``kv_valid - 1`` when
    not causal), dV = P^T dO with P rounded to the value dtype, dS = P *
    (dP - Delta), dQ = dS K * scale, dK = dS^T Q * scale; for GQA dK and dV
    sum over the G query heads in f32. It differs from autograd of the
    forward only where the forward rounds: P before P.V (there P is rounded
    before the division by the row sum) and O to its dtype (Delta takes the
    rounded O); with f32 inputs it is autograd's result to f32 precision."""
    lse = attention_lse_ref(q, k, kv_valid, causal=causal)
    delta = attention_bwd_delta_ref(out, dout)
    dk, dv = attention_bwd_dkdv_ref(q, k, v, dout, kv_valid, lse, delta, causal=causal)
    dq = attention_bwd_dq_ref(q, k, v, dout, kv_valid, lse, delta, causal=causal)
    return dq, dk, dv


def attention_bwd_split_ref(q, k, v, out, dout, kv_valid, *, causal: bool = True):
    """(dQ, dK, dV) in the decomposition of ``kernels/csrc/attn_bwd.cu``'s
    dq and dkdv kernels (tests only): the LSE of the split forward at the
    kernel's 64-position splits (``verify_attention_split_ref(split=64,
    return_lse=True)``), as the card path takes it from the forward kernel;
    Delta, P and dS in f32 as ``attention_bwd_ref``'s; then dS rounded to
    bf16 (round to nearest even) for dQ = bf16(dS) K * scale and dK =
    bf16(dS)^T Q * scale, and dK and dV taken per query head as f32
    partials, summed over the G heads of their KV head in head order (head
    0 first) before the scale and the rounding to the output dtype."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    _, lse = verify_attention_split_ref(q, k, v, kv_valid, split=64, causal=causal,
                                        return_lse=True)
    delta = attention_bwd_delta_ref(out, dout)
    p, ds, dog = _bwd_probs(q, k, v, dout, kv_valid, lse, delta, causal)
    ds = ds.to(torch.bfloat16).float()
    qg = q.reshape(dog.shape).float()
    dv_parts = torch.einsum("bshgc,bshgd->bchgd", p.to(v.dtype).float(), dog)
    dk_parts = torch.einsum("bshgc,bshgd->bchgd", ds, qg)
    dk, dv = dk_parts[:, :, :, 0], dv_parts[:, :, :, 0]
    for g in range(1, Hq // Hkv):
        dk, dv = dk + dk_parts[:, :, :, g], dv + dv_parts[:, :, :, g]
    dq = torch.einsum("bshgc,bchd->bshgd", ds, k.float()) * _bwd_scale(q)
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), (dk * _bwd_scale(q)).to(k.dtype),
            dv.to(v.dtype))


def _causal_decay(cum: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """exp(cum_i - cum_j), (B, i, j, H), on the causal triangle j <= i and 0
    above it, the exponent masked before the exp (see the module note)."""
    seg = cum[:, :, None, :] - cum[:, None, :, :]
    return torch.exp(torch.where(tri[None, :, :, None], seg, float("-inf")))


def ssd_scan_ref(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H) f32, post-softplus
    A: torch.Tensor,    # (H,) f32, negative
    Bm: torch.Tensor,   # (B, S, N)
    Cm: torch.Tensor,   # (B, S, N)
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
    *,
    chunk: int,
    return_states: bool = False,
):
    """Chunked SSD. Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) f32), and with ``return_states`` also each chunk's start
    state (B, n_chunks, H, P, N) f32. Per chunk of Q = min(chunk, S) steps,
    with ``cum`` the running sum of ``dt * A``:
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
    ys, states = [], []
    for c in range(nc):
        states.append(h)
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(dtq * A.to(f32)[None, None], dim=1)  # (B, Q, H)
        y_off = torch.einsum("bqn,bhpn->bqhp", Cq, h) * torch.exp(cum)[..., None]
        decay = _causal_decay(cum, tri)  # (B, i, j, H)
        cb = torch.einsum("bin,bjn->bij", Cq, Bq)
        W = cb[..., None] * decay * dtq[:, None, :, :]
        y_diag = torch.einsum("bijh,bjhp->bihp", W, xq)
        ys.append((y_off + y_diag).to(x.dtype))
        d_end = torch.exp(cum[:, -1:, :] - cum) * dtq  # (B, Q, H)
        h_new = torch.einsum("bqhp,bqhn->bhpn", xq, Bq[:, :, None, :] * d_end[..., None])
        h = torch.exp(cum[:, -1])[..., None, None] * h + h_new
    y = torch.cat(ys, dim=1)[:, :S]
    if return_states:
        return y, h, torch.stack(states, dim=1)
    return y, h


def ssd_scan_sliced_ref(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H) f32, post-softplus
    A: torch.Tensor,    # (H,) f32, negative
    Bm: torch.Tensor,   # (B, S, N)
    Cm: torch.Tensor,   # (B, S, N)
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
    *,
    chunk: int,
    slice_p: int = 16,
    cumsum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's decomposition of ``ssd_scan_ref`` (tests only): per
    chunk, C.B^T once for all heads, then y's columns, the carry-in and the
    state rows P-slice by P-slice (``slice_p`` columns; the last slice may be
    narrower), each slice alone with its own rows of the state. ``cumsum``
    takes the chunk's running sum of dt * A, (B, q, H) over q (default
    ``torch.cumsum``; ``warp_scan_cumsum`` is the kernel's order)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    f32 = torch.float32
    xf, Bf, Cf, dtf = x.to(f32), Bm.to(f32), Cm.to(f32), dt.to(f32)
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32).clone())
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    for t0 in range(0, S, Q):
        q = min(Q, S - t0)
        sl = slice(t0, t0 + q)
        xq, dtq, Bq, Cq = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        da = dtq * A.to(f32)[None, None]
        cum = cumsum(da) if cumsum is not None else torch.cumsum(da, dim=1)  # (B, q, H)
        tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
        cb = torch.einsum("bin,bjn->bij", Cq, Bq)  # once per (b, chunk)
        W = cb[..., None] * _causal_decay(cum, tri) * dtq[:, None, :, :]  # (B, i, j, H)
        d_end = torch.exp(cum[:, -1:, :] - cum) * dtq  # (B, q, H)
        bd = Bq[:, :, None, :] * d_end[..., None]  # (B, q, H, N)
        decay_last = torch.exp(cum[:, -1])[..., None, None]
        for p0 in range(0, P, slice_p):
            ps = slice(p0, min(p0 + slice_p, P))
            hs = h[:, :, ps]
            y_off = torch.einsum("bqn,bhpn->bqhp", Cq, hs) * torch.exp(cum)[..., None]
            y_diag = torch.einsum("bijh,bjhp->bihp", W, xq[..., ps])
            y[:, sl, :, ps] = (y_off + y_diag).to(x.dtype)
            h[:, :, ps] = decay_last * hs + torch.einsum("bqhp,bqhn->bhpn", xq[..., ps], bd)
    return y, h


def warp_scan_cumsum(v: torch.Tensor, lanes: int = 32, warps: int = 8) -> torch.Tensor:
    """The running sum of ``v`` (B, q, H) over its steps in the SSD kernel's
    order (tests only; ``chunk_cumsum`` in ``csrc/ssd_scan.cu``): per segment
    of ``lanes * warps`` steps, a Hillis-Steele scan inside each warp (lane l
    adds lane l - off, off = 1, 2, .., lanes / 2), then each warp adds the
    carry of the earlier segments and the totals of the warps before it, one
    by one in warp order. On the card the plain version's ``torch.cumsum``
    (over a dimension that is not the innermost) adds step by step."""
    B, q, H = v.shape
    seg = lanes * warps
    out = torch.empty_like(v)
    carry = torch.zeros((B, H), dtype=v.dtype, device=v.device)
    for base in range(0, q, seg):
        n = min(seg, q - base)
        w = torch.zeros((B, seg, H), dtype=v.dtype, device=v.device)
        w[:, :n] = v[:, base:base + n]
        w = w.reshape(B, warps, lanes, H)
        off = 1
        while off < lanes:
            w = torch.cat([w[:, :, :off], w[:, :, off:] + w[:, :, :-off]], dim=2)
            off *= 2
        tot = w[:, :, -1]  # (B, warps, H)
        before = [carry]
        for u in range(warps - 1):
            before.append(before[-1] + tot[:, u])
        carry = before[-1] + tot[:, -1]
        cum = torch.stack(before, dim=1)[:, :, None] + w  # (B, warps, lanes, H)
        out[:, base:base + n] = cum.reshape(B, seg, H)[:, :n]
    return out


def _reverse_cumsum(v: torch.Tensor) -> torch.Tensor:
    """sum_{t' >= t} v[:, t'] over dimension 1."""
    return torch.flip(torch.cumsum(torch.flip(v, [1]), dim=1), [1])


def ssd_scan_bwd_ref(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H) f32
    A: torch.Tensor,    # (H,) f32
    Bm: torch.Tensor,   # (B, S, N)
    Cm: torch.Tensor,   # (B, S, N)
    h0: Optional[torch.Tensor],      # (B, H, P, N) f32, None: zeros
    dy: torch.Tensor,   # (B, S, H, P): the cotangent of y
    dh_out: Optional[torch.Tensor],  # (B, H, P, N) f32: of the final state, None: zeros
    *,
    chunk: int,
    cumsum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """The gradient of ``ssd_scan_ref`` in closed form: (dx, ddt, dA, dB,
    dC, dh0), dx, dB and dC in their inputs' dtypes, the rest f32 (f64 for
    f64 inputs). All in f32 (f64) over zero-padded chunks, as the forward.
    The chunk start states come from the forward's recurrence; then the
    chunks are walked in reverse, carrying dh, the cotangent of the state
    at the chunk's end:
      dh_prev = exp(cum_Q) dh + sum_i exp(cum_i) dy_i^T C_i.
    Within a chunk, with L_ij = exp(cum_i - cum_j) on the triangle j <= i
    (the exp is evaluated there only), G_ij = dy_i . x_j, CB_ij = C_i . B_j,
    W_ij = CB_ij L_ij dt_j and dS_ij = G_ij L_ij dt_j:
      carry-in  dC_i += exp(cum_i) dy_i h,  dcum_i += dy_i . y_off_i
      intra     dx_j += sum_i W_ij dy_i,  dC_i += sum_j dS_ij B_j,
                dB_j += sum_i dS_ij C_i,  ddt_j += sum_i G_ij CB_ij L_ij,
                dcum_i += sum_j G_ij W_ij,  dcum_j -= sum_i G_ij W_ij
      state     dx_j += d_end_j dh B_j,  dB_j += d_end_j x_j dh,
                ddt_j += exp(cum_Q - cum_j) x_j dh B_j,  dcum_j -= ... d_end_j,
                dcum_Q += sum_j (x_j dh B_j) d_end_j + exp(cum_Q) sum dh h
    and cum = cumsum(dt A) gives ddt_t += A sum_{i>=t} dcum_i and dA the
    same times dt_t summed. ``cumsum`` replaces the chunk's running sum
    (tests: an exclusive one is the off-by-one control)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    f32 = torch.promote_types(x.dtype, torch.float32)
    xf, Bf, Cf, dtf, dyf = (t.to(f32) for t in (x, Bm, Cm, dt, dy))
    Af = A.to(f32)
    if pad:
        xf, dyf = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, dyf))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        Bf, Cf = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (Bf, Cf))
    running = cumsum if cumsum is not None else (lambda v: torch.cumsum(v, dim=1))
    dev = x.device
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=dev) if h0 is None else h0.to(f32)
    states = []
    for c in range(nc):
        states.append(h)
        sl = slice(c * Q, (c + 1) * Q)
        cum = running(dtf[:, sl] * Af)
        d_end = torch.exp(cum[:, -1:] - cum) * dtf[:, sl]
        h = (torch.exp(cum[:, -1])[..., None, None] * h
             + torch.einsum("bqhp,bqn,bqh->bhpn", xf[:, sl], Bf[:, sl], d_end))
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    dh = torch.zeros((Bsz, H, P, N), dtype=f32, device=dev) if dh_out is None else dh_out.to(f32)
    dx, dB, dC = torch.zeros_like(xf), torch.zeros_like(Bf), torch.zeros_like(Cf)
    ddt = torch.zeros_like(dtf)
    dA = torch.zeros((H,), dtype=f32, device=dev)
    for c in reversed(range(nc)):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq, dyq, h = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl], dyf[:, sl], states[c]
        cum = running(dtq * Af)                                   # (B, Q, H)
        ecum = torch.exp(cum)
        Lmat = _causal_decay(cum, tri)                            # (B, i, j, H)
        CB = torch.einsum("bin,bjn->bij", Cq, Bq)
        G = torch.einsum("bihp,bjhp->bijh", dyq, xq)
        V = CB[..., None] * Lmat
        W = V * dtq[:, None]
        dS = G * Lmat * dtq[:, None]
        M = G * W
        # carry-in and intra-chunk terms of y
        y_off = torch.einsum("bqn,bhpn->bqhp", Cq, h) * ecum[..., None]
        dCq = (torch.einsum("bqhp,bhpn->bqn", dyq * ecum[..., None], h)
               + torch.einsum("bijh,bjn->bin", dS, Bq))
        dBq = torch.einsum("bijh,bin->bjn", dS, Cq)
        dxq = torch.einsum("bijh,bihp->bjhp", W, dyq)
        dcum = (dyq * y_off).sum(-1) + M.sum(2) - M.sum(1)
        ddtq = (G * V).sum(1)
        # the state at the chunk's end
        last = cum[:, -1]                                         # (B, H)
        e_end = torch.exp(last[:, None] - cum)
        d_end = e_end * dtq
        T = torch.einsum("bhpn,bjn->bjhp", dh, Bq)
        dxq = dxq + d_end[..., None] * T
        dBq = dBq + torch.einsum("bjhp,bhpn->bjn", xq * d_end[..., None], dh)
        s = (xq * T).sum(-1)                                      # (B, Q, H)
        ddtq = ddtq + e_end * s
        dcum = dcum - s * d_end
        dcum[:, -1] += (s * d_end).sum(1) + torch.exp(last) * (dh * h).sum((-2, -1))
        dda = _reverse_cumsum(dcum)
        ddt[:, sl] = ddtq + dda * Af
        dA = dA + (dda * dtq).sum((0, 1))
        dx[:, sl], dB[:, sl], dC[:, sl] = dxq, dBq, dCq
        dh = (torch.exp(last)[..., None, None] * dh
              + torch.einsum("bqhp,bqn->bhpn", dyq * ecum[..., None], Cq))
    return (dx[:, :S].to(x.dtype), ddt[:, :S], dA, dB[:, :S].to(Bm.dtype),
            dC[:, :S].to(Cm.dtype), dh)


def gram_k16_alternating(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (B, i, K) . b (B, j, K)^T as the SSD backward's chunk pass sums a
    Gram block (tests only): K in slices of 16, the even slices into one
    running sum and the odd ones into another, in slice order, then the two
    added."""
    K = a.shape[-1]
    even = odd = None
    for k0 in range(0, K, 16):
        part = torch.einsum("bik,bjk->bij", a[..., k0:k0 + 16], b[..., k0:k0 + 16])
        if (k0 // 16) % 2 == 0:
            even = part if even is None else even + part
        else:
            odd = part if odd is None else odd + part
    return even if odd is None else even + odd


def ssd_scan_bwd_split_ref(
    x: torch.Tensor,       # (B, S, H, P)
    dt: torch.Tensor,      # (B, S, H) f32
    A: torch.Tensor,       # (H,) f32
    Bm: torch.Tensor,      # (B, S, N)
    Cm: torch.Tensor,      # (B, S, N)
    states: torch.Tensor,  # (B, n_chunks, H, P, N) f32: each chunk's start state
    dy: torch.Tensor,      # (B, S, H, P)
    dh_out: Optional[torch.Tensor],  # (B, H, P, N) f32, None: zeros
    *,
    chunk: int,
    cumsum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """The SSD backward kernels' decomposition of ``ssd_scan_bwd_ref``
    (tests only), on the chunk start states the forward kernel keeps:
      (a) the reverse pass: each chunk's end cotangent dh (the last chunk's
          is dh_out itself) and, with more than one chunk, dh0;
      (b) per (b, chunk, h), over the chunk's q rows (no padding), with the
          Gram blocks C B^T and dy x^T formed in the pass
          (``gram_k16_alternating``; the column pass's transposes are the
          same sums) and V_ij = (C B^T)_ij exp(cum_i - cum_j) on the
          triangle:
            Y = exp(cum) C h^T + (V dt_j) x     (the forward's f32 y)
            U = V^T dy,  T = B dh^T,  dx = dt U + d_end T
            a = dy . Y,  u = x . U,  s = x . T  (row by row over P)
            dcum = a - dt u - d_end s, at the last row also + sum d_end s
            + exp(cum_q) sum dh h; dda its reverse running sum;
            ddt = u + exp(cum_q - cum) s + A dda, dA's part sum dda dt;
            dS = (dy x^T) exp(cum_i - cum_j) dt_j on the triangle,
            the head's dC = exp(cum) dy h + dS B, dB = dS^T C + d_end x dh;
          with one chunk also dh0 = exp(cum_q) dh_out + (dy exp(cum))^T C;
      (c) dB and dC summed over heads in head order, dA over (b, chunk) in
          that order.
    ``cumsum`` as in ``ssd_scan_sliced_ref`` (``warp_scan_cumsum``: the
    kernels' order)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    f32 = torch.float32
    xf, Bf, Cf, dtf, dyf = (t.to(f32) for t in (x, Bm, Cm, dt, dy))
    Af = A.to(f32)
    running = cumsum if cumsum is not None else (lambda v: torch.cumsum(v, dim=1))
    dev = x.device
    starts = list(range(0, S, Q))
    cums = [running(dtf[:, t0:t0 + Q] * Af) for t0 in starts]
    # (a); with one chunk (b) forms dh0 from the same sums
    dh = torch.zeros((Bsz, H, P, N), dtype=f32, device=dev) if dh_out is None else dh_out.to(f32)
    dh_end = [None] * len(starts)
    for c in reversed(range(len(starts))):
        sl, cum = slice(starts[c], starts[c] + Q), cums[c]
        dh_end[c] = dh
        dh = (torch.exp(cum[:, -1])[..., None, None] * dh
              + torch.einsum("bqhp,bqn->bhpn", dyf[:, sl] * torch.exp(cum)[..., None], Cf[:, sl]))
    dh0 = dh
    # (b)
    dx = torch.empty_like(xf)
    ddt = torch.empty_like(dtf)
    dBp = torch.empty((Bsz, H, S, N), dtype=f32, device=dev)
    dCp = torch.empty((Bsz, H, S, N), dtype=f32, device=dev)
    dAp = torch.empty((Bsz, len(starts), H), dtype=f32, device=dev)
    for c, t0 in enumerate(starts):
        q = min(Q, S - t0)
        sl, cum = slice(t0, t0 + q), cums[c]
        xq, dtq, Bq, Cq, dyq = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl], dyf[:, sl]
        h, dhc = states[:, c].to(f32), dh_end[c]
        tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
        Lmat = _causal_decay(cum, tri)
        Ld = Lmat * dtq[:, None]  # the decay with dt_j, once for W and dS
        CB = gram_k16_alternating(Cq, Bq)[..., None]
        V = CB * Lmat
        ecum = torch.exp(cum)
        e_end = torch.exp(cum[:, -1:] - cum)
        d_end = e_end * dtq
        Y = (torch.einsum("bqn,bhpn->bqhp", Cq, h) * ecum[..., None]
             + torch.einsum("bijh,bjhp->bihp", CB * Ld, xq))
        U = torch.einsum("bijh,bihp->bjhp", V, dyq)
        T = torch.einsum("bjn,bhpn->bjhp", Bq, dhc)
        dx[:, sl] = dtq[..., None] * U + d_end[..., None] * T
        a, u, s = (dyq * Y).sum(-1), (xq * U).sum(-1), (xq * T).sum(-1)
        dcum = a - dtq * u - d_end * s
        dcum[:, -1] += (d_end * s).sum(1) + ecum[:, -1] * (dhc * h).sum((-2, -1))
        dda = _reverse_cumsum(dcum)
        ddt[:, sl] = u + e_end * s + Af * dda
        dAp[:, c] = (dda * dtq).sum(1)
        G = torch.stack([gram_k16_alternating(dyq[:, :, hh], xq[:, :, hh]) for hh in range(H)], -1)
        dS = G * Ld
        dCp[:, :, sl] = (torch.einsum("bqhp,bhpn->bhqn", dyq * ecum[..., None], h)
                         + torch.einsum("bijh,bjn->bhin", dS, Bq))
        dBp[:, :, sl] = (torch.einsum("bijh,bin->bhjn", dS, Cq)
                         + torch.einsum("bjhp,bhpn->bhjn", xq * d_end[..., None], dhc))
    # (c)
    dB, dC = dBp[:, 0].clone(), dCp[:, 0].clone()
    for hh in range(1, H):
        dB, dC = dB + dBp[:, hh], dC + dCp[:, hh]
    dA = torch.zeros((H,), dtype=f32, device=dev)
    for b in range(Bsz):
        for c in range(len(starts)):
            dA = dA + dAp[b, c]
    return dx.to(x.dtype), ddt, dA, dB.to(Bm.dtype), dC.to(Cm.dtype), dh0
