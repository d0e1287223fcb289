"""Collectives over a mesh's model axis, and sequence-parallel attention.

The port of ``repro.distributed.collectives``. GQA models with few KV heads
(granite-34b with 1, llava with 8, qwen1.5's 40 on a model axis of 16)
cannot shard their caches by head; sharding the cache's sequence over the
model axis fits it, at the price of a softmax combine across the shards
(flash-decoding's split-KV reduction):

  per shard:  (out_r, lse_r) = attention(q, K_r, V_r)   # f32, normalised
  combine:    lse* = max_r lse_r;  w_r = exp(lse_r - lse*)
              out = sum_r(out_r * w_r) / max(sum_r w_r, 1e-30)

``out_r * w_r`` is ``acc_r * c_r / exp(lse* - m*)`` of the JAX package's
``psum(acc * c) / psum(l * c)``: the same quotient. A shard a row sees
nothing of gives lse -inf and weighs exactly 0; a row that sees nothing in
any shard gives 0. The combine runs in f32 (JAX's ``COMBINE_DTYPE =
None``) and rounds once, to q's dtype.

Every collective is an ``all_reduce`` over the model axis's process group
(``ctx.model_group``): gloo reduces CUDA tensors that way only, so a
gather is an ``all_reduce`` of a zero buffer that each rank fills at its
own columns (adding zeros is exact, so the result equals a gather bit for
bit). Values travel as f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, ctx, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the model axis, as a new f32 tensor."""
    y = x.float().contiguous()
    if y is x:
        y = y.clone()
    if ctx.tp > 1:
        dist.all_reduce(y, op=_OPS[op], group=ctx.model_group)
    return y


def gather_columns(x: torch.Tensor, ctx) -> torch.Tensor:
    """The model ranks' ``x`` (..., n) side by side in rank order, (...,
    tp * n), in x's dtype."""
    tp = ctx.tp
    if tp == 1:
        return x
    n = x.shape[-1]
    r = ctx.model_rank
    buf = x.new_zeros((*x.shape[:-1], tp * n), dtype=torch.float32)
    buf[..., r * n:(r + 1) * n] = x
    dist.all_reduce(buf, group=ctx.model_group)
    return buf.to(x.dtype)


def sp_append_attend(
    q: torch.Tensor,          # (B, Sq, Hq, D): every query head, this rank's rows
    k_cache: torch.Tensor,    # (B, S_loc, Hkv, D), or stacked (L, B, S_loc, Hkv, D) with layer
    v_cache: torch.Tensor,
    k_new: torch.Tensor,      # (B, Sq, Hkv, D) the fresh rows
    v_new: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) committed lengths
    start,                    # int: the one insert position of every row (padded batch)
    ctx,
    *,
    causal: bool = True,
    chunk: int = 1024,
    layer: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Append the fresh K/V rows to this rank's sequence shard and attend
    over every shard: (attn_out (B, Sq, Hq, D) in q's dtype, k_cache,
    v_cache), the caches written in place.

    This rank holds positions ``[base, base + S_loc)``, ``base = model rank
    * S_loc``, and writes only the fresh rows that land there (rows that
    straddle two shards are split between them). Every batch row's rows go
    to ``start + arange(Sq)``, the JAX package's padded-batch contract (its
    caller passes ``cache_len[0]``), while row b's queries sit at
    ``cache_len[b] + i``: the two agree when the lengths are equal.
    Attention over the shard is ``ops.verify_attention_shard`` (on the card
    the kernel's shard form), then the combine across the model axis."""
    if k_cache.dtype == torch.int8:
        raise NotImplementedError(
            "an int8 cache is not sequence-sharded here: the JAX package's sp_append_attend "
            "quantizes it at the static scale and attends without the row scales, which the "
            "port does not mirror (ROADMAP.md Queue A)")
    B, Sq, Hq, D = q.shape
    S_loc = k_cache.shape[-3]
    base = ctx.model_rank * S_loc
    start = int(start)
    lo, hi = max(start, base), min(start + Sq, base + S_loc)
    if lo < hi:  # the fresh rows [lo - start, hi - start) land in this shard
        kc = k_cache if layer is None else k_cache[layer]
        vc = v_cache if layer is None else v_cache[layer]
        kc[:, lo - base:hi - base] = k_new[:, lo - start:hi - start]
        vc[:, lo - base:hi - base] = v_new[:, lo - start:hi - start]
    kv_valid = (cache_len + Sq).to(torch.int32)
    out, lse = ops.verify_attention_shard(q, k_cache, v_cache, kv_valid, pos_offset=base,
                                          layer=layer, block_k=min(chunk, S_loc), causal=causal)
    lse = lse.transpose(1, 2)[..., None]  # (B, Sq, Hq, 1)
    lse_max = all_reduce(lse, ctx, "max")
    w = torch.where(lse == -torch.inf, torch.zeros((), device=lse.device),
                    torch.exp(lse - lse_max))
    # one all_reduce for the weighted outputs and their weights
    both = all_reduce(torch.cat([out * w, w], dim=-1), ctx)
    out = both[..., :D] / torch.clamp(both[..., D:], min=1e-30)
    return out.to(q.dtype), k_cache, v_cache
