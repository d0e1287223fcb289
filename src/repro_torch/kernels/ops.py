"""Public kernel ops in the JAX package's layouts.

A CUDA tensor goes to the Hopper kernel (``kernels/verify_attn.py``,
``kernels/ssd_scan.py``), a CPU tensor to its plain version
(``kernels/ref.py``); there is no other route. ``block_k`` sets the
chunking of the plain attention only: the CUDA kernel tiles the cache in
its own 64-position chunks.

An int8 cache comes with its scale leaves in the cache's own layout,
(rows, Hkv) or stacked (L, rows, Hkv) with ``layer``; the kernel reads
them by the same (layer, row) addressing as the K/V rows, the plain
version selects the rows it needs first.

``verify_attention_shard`` is the shard form over one sequence shard of
the cache (``distributed/collectives.py``): the shard's f32 output and
each row's LSE over it, for the combine across shards.

``causal=False`` (the encdec family's encoder and cross-attention) lets
every query row see every position below its ``kv_valid``; the kernel
takes it as a flag and counts such launches under their own names.

``attention`` is the differentiable form over fresh K/V (training: the
cache-free forward's self- and cross-attention, the encoder): on CUDA
tensors a ``torch.autograd.Function`` whose forward is the dense kernel,
which also keeps each query row's log-sum-exp from its merge
(``return_lse=True``), and whose backward is ``kernels/attn_bwd.py``'s
three kernels on that LSE; on CPU tensors the plain version, which
autograd differentiates itself. ``ssd_scan`` is differentiable the same
way: on CUDA tensors that need a gradient a ``torch.autograd.Function``
whose forward is the scan kernel, keeping each chunk's start state
(``return_states=True``), and whose backward is ``kernels/ssd_scan.py``'s
``ssd_scan_bwd`` on those states; without a gradient (a serve) the scan
kernel alone, as before.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import attn_bwd, ref, ssd_scan as ssd_kernel, verify_attn


def _layer(t: Optional[torch.Tensor], layer: Optional[int]) -> Optional[torch.Tensor]:
    return t if t is None or layer is None else t[layer]


def verify_attention(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k: torch.Tensor,         # (B, Skv, Hkv, D), or (L, B, Skv, Hkv, D) with layer
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # (B,) int32
    *,
    layer: Optional[int] = None,
    block_k: int = 64,
    k_scale: Optional[torch.Tensor] = None,  # int8 cache: (B, Hkv) f32, or (L, B, Hkv)
    v_scale: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """SLED verification attention over a dense cache (see verify_attn.cu)."""
    if q.is_cuda:
        return verify_attn.verify_attention_packed(q, k, v, kv_valid, layer=layer,
                                                   k_scale=k_scale, v_scale=v_scale,
                                                   causal=causal)
    return ref.verify_attention_ref(q, _layer(k, layer), _layer(v, layer), kv_valid,
                                    block_k=block_k, k_scale=_layer(k_scale, layer),
                                    v_scale=_layer(v_scale, layer), causal=causal)


def verify_attention_shard(
    q: torch.Tensor,         # (B, Sq, Hq, D) bf16
    k: torch.Tensor,         # (B, S_loc, Hkv, D) bf16 shard, or (L, B, S_loc, Hkv, D) with layer
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # (B,) int32, global
    *,
    pos_offset: int,
    layer: Optional[int] = None,
    block_k: int = 64,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over one sequence shard of a dense bf16 cache whose first
    position is the global position ``pos_offset``: (out (B, Sq, Hq, D)
    f32 normalised over the shard, lse (B, Hq, Sq) f32, -inf for a row
    that sees nothing there). On a CUDA tensor the shard form of the
    kernel runs (or raises); never the plain version."""
    if q.is_cuda:
        return verify_attn.verify_attention_packed_shard(q.contiguous(), k, v, kv_valid,
                                                         pos_offset=pos_offset, layer=layer,
                                                         causal=causal)
    return ref.verify_attention_shard_ref(q, _layer(k, layer), _layer(v, layer), kv_valid,
                                          pos_offset, block_k=block_k, causal=causal)


class _Attention(torch.autograd.Function):
    """The forward kernel (dense entry, no layer; it keeps each row's LSE)
    and its backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal):
        out, lse = verify_attn.verify_attention_packed(q, k, v, kv_valid, causal=causal,
                                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, kv_valid, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, kv_valid, lse = ctx.saved_tensors
        dq, dk, dv = attn_bwd.attention_bwd(q, k, v, out, dout.contiguous(), kv_valid, lse,
                                            causal=ctx.causal)
        return dq, dk, dv, None, None


def attention(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k: torch.Tensor,         # (B, Skv, Hkv, D) fresh K/V
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # (B,) int32
    *,
    causal: bool = True,
    block_k: int = 64,
) -> torch.Tensor:
    """Attention over fresh K/V with a gradient: query i sees j <= kv_valid -
    Sq + i (``causal``) or j < kv_valid (not). On a CUDA tensor the forward
    and backward kernels run (or raise); never the plain version."""
    if q.is_cuda:
        return _Attention.apply(q.contiguous(), k.contiguous(), v.contiguous(), kv_valid, causal)
    return ref.verify_attention_ref(q, k, v, kv_valid, block_k=block_k, causal=causal)


def verify_attention_paged(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k_pool: torch.Tensor,    # (n_slots+1, Skv, Hkv, D), or stacked with layer
    v_pool: torch.Tensor,
    slots: torch.Tensor,     # (B,) int32 pool row per batch entry
    kv_valid: torch.Tensor,  # (B,) int32
    *,
    layer: Optional[int] = None,
    block_k: int = 64,
    k_scale: Optional[torch.Tensor] = None,  # int8 pool: (n_slots+1, Hkv) f32, or stacked
    v_scale: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Slot-indexed verification attention straight out of the cache pool."""
    if q.is_cuda:
        return verify_attn.verify_attention_paged(q, k_pool, v_pool, slots, kv_valid,
                                                  layer=layer, k_scale=k_scale, v_scale=v_scale,
                                                  causal=causal)
    return ref.verify_attention_paged_ref(
        q, _layer(k_pool, layer), _layer(v_pool, layer), slots, kv_valid, block_k=block_k,
        k_scale=_layer(k_scale, layer), v_scale=_layer(v_scale, layer), causal=causal,
    )


class _SSDScan(torch.autograd.Function):
    """The scan kernel, keeping each chunk's start state, and the scan's
    backward kernels."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk):
        y, h, states = ssd_kernel.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk, return_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused final state's cotangent stays None
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dx, ddt, dA, dB, dC, dh0 = ssd_kernel.ssd_scan_bwd(
            x, dt, A, Bm, Cm, states, dy, None if dh is None else dh.contiguous(),
            chunk=ctx.chunk)
        return dx, ddt, dA, dB, dC, dh0 if ctx.needs_input_grad[5] else None, None


def ssd_scan(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H) f32, post-softplus
    A: torch.Tensor,    # (H,) f32, negative
    Bm: torch.Tensor,   # (B, S, N)
    Cm: torch.Tensor,   # (B, S, N)
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD over a whole sequence: (y in x's dtype, final f32 state)
    (see ssd_scan.cu). On CUDA tensors the kernels run (or raise), forward
    and, where an input needs a gradient, backward; never the plain
    version."""
    if x.is_cuda:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, h0)):
            return _SSDScan.apply(x, dt, A, Bm, Cm, h0, chunk)
        return ssd_kernel.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk)
    return ref.ssd_scan_ref(x, dt, A, Bm, Cm, h0, chunk=chunk)
