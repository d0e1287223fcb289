"""Transformer (dense, vlm, moe, encdec): init, cache, prefill, SLED verify.

The port of ``repro.models.transformer`` for the dense, vlm, moe and encdec
families. The same ``decode_forward`` serves prefill (S = prompt length,
cache_len = 0), the draft's one-token steps and SLED verification (S = K
draft tokens + 1, cache_len = committed length), on a dense cache or, with
``slots``, straight against a PagedKVCache pool. A moe layer's aux loss is
dropped, as the JAX engine drops it: serving reads the hidden states only
(``forward``, the training form, returns it).

The vlm family (llava-next) is its dense backbone; its stub frontend's patch
embeddings (``model_zoo.frontend_stub``) enter ``prefill`` as
``embeds_prefix`` and take the first P positions of the cache.

The encdec family (whisper-tiny) adds a bidirectional encoder over stub
frame embeddings (``encode``), learned position tables (``pos_embed``, no
RoPE; a position past the decoder table's end takes its last row, as
JAX's gather clamps) and, in each decoder block, cross-attention between
self-attention and the MLP. ``prefill(enc_frames=)`` encodes the frames
once and stores every layer's cross K/V (the shared encoder output times
that layer's ``xattn.wk``/``wv``, without their biases, as in JAX) in the
cache leaves ``cross_k``/``cross_v`` (L, B, F, Hkv, D), bf16 whatever the
self-attention cache's dtype; ``decode_forward`` reads them, densely or
through ``slots`` from a PagedKVCache pool, non-causally over all F frames.

Under a mesh (``ctx``, a ``layers.MeshContext``) ``decode_forward``,
``prefill``, ``encode`` and ``lm_head`` run on this rank's rows, weight
pieces and cache piece (``sharding.policy``): the layers combine over the
model axis (``layers``), and the logits are vocabulary-parallel, each
rank's columns written into a zero f32 buffer that an ``all_reduce`` fills
(adding zeros is exact: the logits equal a gather bit for bit, and
``argmax`` keeps its first-index ties). A sequence-sharded cache takes
every row's fresh rows at row 0's length, the JAX package's padded-batch
contract (``distributed/collectives.py``). The vlm prefix and the encdec
frames are this rank's rows; the encoder runs on the rank's heads and its
cross K/V leaves hold the rank's KV heads (every head where they do not
split). A slot pool and a train-mode layout raise under a sharded mesh
(``layers.check_mesh``).

Training runs ``forward``, the cache-free form of the JAX package's
``forward``: every block's self-attention over its fresh K/V (causal),
the encdec decoder's cross-attention over K/V projected afresh from the
encoder output, the moe aux losses summed, each block optionally
recomputed in the backward (``remat``); ``train_lm_head`` takes the
logits against the live output table, with a gradient to it.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models.kvcache import init_kv_cache


class Block(nn.Module):
    """A pre-norm block: attention, with ``cross`` (an encdec decoder layer)
    a cross-attention (``ln_x``, ``xattn``), then the MLP (``mlp``) or, for
    the moe family, the routed experts (``moe``). The norms are
    ``cfg.norm``'s."""

    def __init__(self, cfg, device=None, cross: bool = False):
        super().__init__()
        self.ln1 = L.make_norm(cfg, device=device)
        self.attn = L.Attention(cfg, device=device)
        if cross:
            self.ln_x = L.make_norm(cfg, device=device)
            self.xattn = L.Attention(cfg, device=device)
        self.ln2 = L.make_norm(cfg, device=device)
        if cfg.family == "moe":
            self.moe = L.MoE(cfg, device=device)
        else:
            self.mlp = L.MLP(cfg, device=device)


class CausalLM(nn.Module):
    """What every family's weights share, in the JAX package's layout:
    ``embed`` (V, d), ``final_norm``, and ``lm_head`` (d, V) unless tied,
    with the f32 output table the logits are taken against."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = L._weight(cfg.vocab_size, cfg.d_model, device=device)
        self.final_norm = L.make_norm(cfg, device=device)
        self.lm_head_w = None if cfg.tie_embeddings else L._weight(cfg.d_model, cfg.vocab_size, device=device)
        self._head_f32: Tuple[int, Optional[torch.Tensor]] = (-1, None)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def set_weight(self, name: str, value: torch.Tensor) -> None:
        """Replace parameter ``name`` (a ``named_parameters`` name) by
        ``value``, whose dtype wins: a quantized bundle's norm scales and
        SSM parameters are bf16 where a 16-bit one keeps them in f32."""
        owner, _, attr = name.rpartition(".")
        module = self.get_submodule(owner) if owner else self
        setattr(module, attr, nn.Parameter(value, requires_grad=False))
        self._head_f32 = (-1, None)

    def head_f32(self) -> torch.Tensor:
        """The output projection (d, V) widened to f32, kept until the
        weight changes. Widening bf16 is exact; keeping it saves a full
        convert of the (V, d) table on every step."""
        w = self.embed if self.cfg.tie_embeddings else self.lm_head_w
        version, cached = self._head_f32
        if cached is None or version != w._version:
            cached = (w.t() if self.cfg.tie_embeddings else w).float().contiguous()
            self._head_f32 = (w._version, cached)
        return cached


class Encoder(nn.Module):
    """The encdec family's encoder: a learned position table ``pos_embed``
    (encoder_seq, d), ``encoder_layers`` blocks and ``final_norm``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.pos_embed = L._weight(cfg.encoder_seq, cfg.d_model, device=device)
        self.layers = nn.ModuleList(Block(cfg, device=device) for _ in range(cfg.encoder_layers))
        self.final_norm = L.make_norm(cfg, device=device)


class Transformer(CausalLM):
    """Weights of one dense, vlm, moe or encdec model: the shared embedding,
    norm and head, and the per-layer blocks (the JAX stack's leading L axis
    unrolled into a ModuleList); without RoPE the learned position table
    ``pos_embed`` (max(max_pos, 1), d), and for encdec the ``enc`` encoder
    and a cross-attention in every decoder block."""

    def __init__(self, cfg, device=None, max_pos: int = 0):
        super().__init__(cfg, device=device)
        self.layers = nn.ModuleList(Block(cfg, device=device, cross=cfg.is_encdec)
                                    for _ in range(cfg.num_layers))
        self.pos_embed = (None if cfg.use_rope
                          else L._weight(max(max_pos, 1), cfg.d_model, device=device))
        self.enc = Encoder(cfg, device=device) if cfg.is_encdec else None


def _init_block_(blk: Block, cfg, gen: torch.Generator) -> None:
    L.init_attention_(blk.attn, cfg, gen)
    if hasattr(blk, "xattn"):
        L.init_attention_(blk.xattn, cfg, gen)
    if cfg.family == "moe":
        L.init_moe_(blk.moe, cfg, gen)
    else:
        L.init_mlp_(blk.mlp, cfg, gen)


def init_params(cfg, generator: torch.Generator, *, max_pos: int = 0) -> Transformer:
    """Seeded random weights with the JAX package's distributions (the draws
    differ from ``jax.random``'s; tests bridge JAX weights in instead). The
    model lives on the generator's device. ``max_pos`` sizes the learned
    position table of a model without RoPE, as in JAX."""
    dev = generator.device

    def normal_(w: torch.Tensor, std: float) -> None:
        w.copy_(torch.randn(w.shape, generator=generator, device=dev) * std)

    model = Transformer(cfg, device=dev, max_pos=max_pos)
    with torch.no_grad():
        normal_(model.embed, 0.02)
        for blk in model.layers:
            _init_block_(blk, cfg, generator)
        if model.lm_head_w is not None:
            normal_(model.lm_head_w, 0.02)
        if model.pos_embed is not None:
            normal_(model.pos_embed, 0.01)
        if model.enc is not None:
            normal_(model.enc.pos_embed, 0.01)
            for blk in model.enc.layers:
                _init_block_(blk, cfg, generator)
    return model


def lm_head(params: CausalLM, h: torch.Tensor, ctx: L.MeshContext = L.NO_MESH) -> torch.Tensor:
    """f32 logits of bf16 hidden states, as the JAX path's einsum with
    ``preferred_element_type=f32``: both operands are widened exactly and the
    products sum in f32. At vocab 151936 a bf16 output (8-bit mantissa)
    would round neighbouring logits together and decide greedy ties by
    rounding, so nothing here is kept in bf16. Under a mesh whose rank
    holds a vocabulary range, the ranks' columns side by side."""
    head = params.head_f32()
    if ctx.tp > 1 and head.shape[1] != params.cfg.vocab_size:
        return C.gather_columns(h.float() @ head, ctx)
    return h.float() @ head


KV_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def make_cache(cfg, batch: int, max_len: int, *, device, attn_chunk: int = 1024,
               kv_dtype: str = "bf16", enc_len: int = 0) -> Dict[str, torch.Tensor]:
    """Cache buffer rounded up to a multiple of the attention chunk.

    ``kv_dtype="int8"`` halves the K/V bytes and adds the per-(layer, row,
    KV head) dequant scales ``k_scale``/``v_scale`` (L, batch, Hkv) f32,
    fixed at prefill (``layers.kv_fresh_scale``). An encdec model's cache
    also holds the bf16 cross leaves ``cross_k``/``cross_v`` (L, batch,
    enc_len or encoder_seq, Hkv, D), zeros until a prefill fills them."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r} (one of {sorted(KV_DTYPES)})")
    max_len = -(-max_len // attn_chunk) * attn_chunk
    cache = init_kv_cache(cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim,
                          device=device, dtype=KV_DTYPES[kv_dtype])
    if kv_dtype == "int8":
        shape = (cfg.num_layers, batch, cfg.num_kv_heads)
        cache["k_scale"] = torch.ones(shape, dtype=torch.float32, device=device)
        cache["v_scale"] = torch.ones(shape, dtype=torch.float32, device=device)
    if cfg.is_encdec:
        shape = (cfg.num_layers, batch, enc_len or cfg.encoder_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return cache


def decode_forward(
    cfg,
    params: Transformer,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,  # (B, S_new) int
    *,
    attn_chunk: int = 1024,
    slots: Optional[torch.Tensor] = None,  # (B,) cache is a PagedKVCache pool
    embeds: Optional[torch.Tensor] = None,  # (B, S_new, d): replaces the token embedding
    ctx: L.MeshContext = L.NO_MESH,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run S_new tokens against the cache starting at ``cache['length']``.

    Returns (hidden (B, S_new, d), cache). The fresh K/V rows are written
    into the cache's buffers in place; ``length`` is unchanged, and callers
    commit through ``model.commit`` once the acceptance count is known.

    With ``slots``, the cache is a pool ``(L, n_pool, S, H, D)``: per-row
    lengths come from ``length[slots]``, the fresh rows go straight into
    pool rows ``slots``, and attention reads those rows out of the pool; no
    gathered sub-cache exists.

    An int8 cache's ``k_scale``/``v_scale`` leaves are threaded to every
    layer and written in place along the K/V rows.

    ``embeds`` (the vlm prefill's patches and token embeddings) stands in
    for the embedding of ``tokens``; the positions follow its rows.

    An encdec cache's ``cross_k``/``cross_v`` leaves feed every layer's
    cross-attention (rows b, or pool rows ``slots``), over all their frames.

    Under a mesh ``params``, ``cache`` and ``tokens`` are this rank's pieces
    and rows; a sequence-sharded cache takes the fresh rows at
    ``length[0]`` for every row (one host read per forward).
    """
    L.check_mesh(cfg, ctx, slots)
    x = (L.embed_lookup(params.embed, tokens, ctx, cfg.vocab_size) if embeds is None
         else embeds.to(torch.bfloat16))
    S = x.shape[1]
    ck, cv = cache["k"], cache["v"]
    cache_len, write, start = cache_append(cache, S, ctx, slots)
    positions = cache_len[:, None] + torch.arange(S, dtype=torch.int32, device=x.device)[None]
    if params.pos_embed is not None:
        x = x + learned_positions(params.pos_embed, positions)
    kv_valid = cache_len + S
    cross = (cache["cross_k"], cache["cross_v"]) if cfg.is_encdec else None
    for li, blk in enumerate(params.layers):
        x = block_forward(cfg, blk, x, positions, ck, cv, kv_valid, write, layer=li,
                          chunk=attn_chunk, slots=slots, k_scale=cache.get("k_scale"),
                          v_scale=cache.get("v_scale"), cross=cross, ctx=ctx, start=start)
    return L.apply_norm(x, params.final_norm, cfg.norm), cache


def cache_append(cache: Dict[str, torch.Tensor], S: int, ctx: L.MeshContext,
                 slots: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[L.CacheWrite], Optional[int]]:
    """Where a forward's S fresh K/V rows go in ``cache``'s ``k``/``v``:
    (each row's length, its ``CacheWrite``, None), or for a
    sequence-sharded cache under a mesh (length, None, ``length[0]``):
    every row's fresh rows at row 0's length, the JAX package's
    padded-batch contract (one host read)."""
    if ctx.sharded and ctx.seq_shard_kv:
        return cache["length"], None, int(cache["length"][0])
    s_max = cache["k"].shape[2]
    if slots is None:
        return cache["length"], L.CacheWrite.dense(cache["length"], S, s_max), None
    cache_len = cache["length"][slots.long()]
    return cache_len, L.CacheWrite.slots(cache_len, slots, S, s_max), None


def learned_positions(table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rows ``positions`` of a learned position table; a position past its
    end takes the last row, as the JAX gather clamps its index."""
    return table[positions.long().clamp(0, table.shape[0] - 1)]


def block_forward(cfg, blk: Block, x: torch.Tensor, positions: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor, kv_valid: torch.Tensor,
                  write: L.CacheWrite, *, layer: int, chunk: int,
                  slots: Optional[torch.Tensor] = None,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None,
                  cross: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  ctx: L.MeshContext = L.NO_MESH, start: Optional[int] = None) -> torch.Tensor:
    """One pre-norm block against layer ``layer`` of the stacked cache: the
    dense, moe and encdec families' decoder layers (``cross``: the stacked
    cross leaves), and the hybrid family's shared block at each of its
    applications."""
    h = L.apply_norm(x, blk.ln1, cfg.norm)
    a = blk.attn(h, positions, ck, cv, kv_valid, write, layer=layer, chunk=chunk, slots=slots,
                 k_scale=k_scale, v_scale=v_scale, ctx=ctx, start=start)
    if cross is not None:  # x + a in f32 for ln_x, as for ln2 below
        x_mid = x.float() + a.float()
        h = L.apply_norm(x_mid, blk.ln_x, cfg.norm).to(x.dtype)
        x = x_mid.to(x.dtype)
        a = blk.xattn.cross(h, cross[0], cross[1], layer=layer, chunk=chunk, slots=slots,
                            ctx=ctx)
    return _mlp_residual(cfg, blk, x, a, ctx)


def _mlp_residual(cfg, blk: Block, x: torch.Tensor, a: torch.Tensor,
                  ctx: L.MeshContext = L.NO_MESH) -> torch.Tensor:
    # the JAX path's compiled block keeps x + a in f32 for the second norm
    # and rounds it to bf16 only for the MLP residual; mirroring that keeps
    # the CPU path bit-exact with it
    x_mid = x.float() + a.float()
    h = L.apply_norm(x_mid, blk.ln2, cfg.norm).to(x.dtype)
    m = L.moe_block(h, blk.moe, cfg, ctx)[0] if cfg.family == "moe" else blk.mlp(h, ctx)
    return x_mid.to(x.dtype) + m


def encode(cfg, params: Transformer, frames: torch.Tensor, *, attn_chunk: int = 1024,
           ctx: L.MeshContext = L.NO_MESH) -> torch.Tensor:
    """The encdec family's bidirectional encoder over stub frame embeddings
    (B, F, d), F <= encoder_seq: frames cast to bf16 plus the first F rows
    of ``enc.pos_embed``, each block's self-attention non-causal over all F
    frames, then the encoder's final norm. Under a mesh, this rank's rows
    of the frames, attention and the MLP on its pieces."""
    enc = params.enc
    B, F, _ = frames.shape
    x = frames.to(torch.bfloat16) + enc.pos_embed[None, :F]
    positions = torch.arange(F, dtype=torch.int32, device=x.device)[None].expand(B, F)
    for blk in enc.layers:
        h = L.apply_norm(x, blk.ln1, cfg.norm)
        a = blk.attn.fresh(h, positions, chunk=attn_chunk, causal=False, ctx=ctx)
        x = _mlp_residual(cfg, blk, x, a, ctx)
    return L.apply_norm(x, enc.final_norm, cfg.norm)


def forward(
    cfg,
    params: Transformer,
    tokens: torch.Tensor,  # (B, S) int
    *,
    embeds_prefix: Optional[torch.Tensor] = None,  # (B, P, d) vlm patch embeddings
    enc_frames: Optional[torch.Tensor] = None,  # (B, F, d) encdec stub frames
    remat: bool = False,
    attn_chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache-free training forward: (hidden (B, S_total, d), aux loss).
    Use ``train_lm_head`` for the logits.

    The port of the JAX ``forward``: token embeddings (the vlm family's
    patches ``embeds_prefix`` in front), learned positions where the model
    has no RoPE, the encdec family's encoder over ``enc_frames`` and each
    decoder layer's cross-attention over it, every block's self-attention
    causal over the fresh K/V, the moe blocks' aux losses summed in f32.
    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``, as JAX checkpoints its scan body). The
    embedding and position lookups are ``F.embedding`` (its backward sums
    a row's contributions in a fixed order on the card); a moe block's
    (assignments, dropped) go to ``layers.moe_tally`` once per forward,
    not again when remat recomputes the block."""
    x = torch.nn.functional.embedding(tokens.long(), params.embed)
    if embeds_prefix is not None:
        x = torch.cat([embeds_prefix.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    if params.pos_embed is not None:
        idx = positions.long().clamp(0, params.pos_embed.shape[0] - 1)
        x = x + torch.nn.functional.embedding(idx, params.pos_embed)
    enc_out = None
    if cfg.is_encdec:
        if enc_frames is None:
            raise ValueError(f"{cfg.name}: an encdec forward needs enc_frames, the encoder's "
                             "(B, F, d) frame embeddings (model_zoo.frontend_stub)")
        enc_out = encode(cfg, params, enc_frames, attn_chunk=attn_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    counts = torch.zeros(2, dtype=torch.int64, device=x.device)
    for blk in params.layers:
        fn = functools.partial(_train_block, cfg, blk, positions=positions, chunk=attn_chunk)
        if remat:
            x, a, c = torch.utils.checkpoint.checkpoint(fn, x, enc_out, use_reentrant=False)
        else:
            x, a, c = fn(x, enc_out)
        aux = aux + a
        counts = counts + c
    if cfg.family == "moe":
        L.moe_tally(x.device).add_(counts)
    return L.apply_norm(x, params.final_norm, cfg.norm), aux


def _train_block(cfg, blk: Block, x: torch.Tensor, enc_out: Optional[torch.Tensor], *,
                 positions: torch.Tensor, chunk: int):
    """One block of the training forward: (x, aux, moe counts). The rounding
    points are the serving block's (x + a kept in f32 for the next norm)."""
    h = L.apply_norm(x, blk.ln1, cfg.norm)
    a = blk.attn.fresh(h, positions, chunk=chunk)
    if enc_out is not None:
        x_mid = x.float() + a.float()
        h = L.apply_norm(x_mid, blk.ln_x, cfg.norm).to(x.dtype)
        x = x_mid.to(x.dtype)
        a = blk.xattn.cross_fresh(h, enc_out, chunk=chunk)
    x_mid = x.float() + a.float()
    h = L.apply_norm(x_mid, blk.ln2, cfg.norm).to(x.dtype)
    if cfg.family == "moe":
        m, aux, counts = L.moe_block_train(h, blk.moe, cfg)
    else:
        m = blk.mlp(h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        counts = torch.zeros(2, dtype=torch.int64, device=x.device)
    return x_mid.to(x.dtype) + m, aux, counts


def train_lm_head(params: CausalLM, h: torch.Tensor) -> torch.Tensor:
    """f32 logits of bf16 hidden states against the live output table (the
    tied ``embed`` or ``lm_head_w``), with a gradient to it: both operands
    widened exactly and the products summed in f32, as JAX's einsum with
    ``preferred_element_type=f32``. The serving ``lm_head`` reads a cached
    f32 copy, which has no gradient."""
    w = params.embed.t() if params.cfg.tie_embeddings else params.lm_head_w
    return h.float() @ w.float()


def cross_kv(cfg, params: Transformer, enc_out: torch.Tensor,
             ctx: L.MeshContext = L.NO_MESH) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K and V of the shared encoder output,
    stacked (L, B, F, Hkv, D): ``enc_out @ xattn.wk`` (and ``wv``), without
    the biases, as the JAX ``_map_layers_xkv`` projects them. Under a mesh
    this rank's KV heads where they split over the model axis (the
    policy's ``cross_k`` layout), else every head (a sharded projection's
    columns gathered)."""
    kvs = [blk.xattn.cross_kv(enc_out, ctx) for blk in params.layers]
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def prefill(
    cfg,
    params: Transformer,
    tokens: torch.Tensor,  # (B, S_prompt)
    cache: Dict[str, torch.Tensor],
    *,
    attn_chunk: int = 1024,
    embeds_prefix: Optional[torch.Tensor] = None,  # (B, P, d) vlm patch embeddings
    enc_frames: Optional[torch.Tensor] = None,  # (B, F, d) encdec stub frames
    ctx: L.MeshContext = L.NO_MESH,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fill the cache from a prompt; returns (last-position logits, cache).
    An ``embeds_prefix`` goes before the prompt's token embeddings, so the
    cache's ``length`` grows by P + S_prompt. An encdec model encodes
    ``enc_frames`` and stores each layer's cross K/V as the cache's
    ``cross_k``/``cross_v`` (shaped by the frames, as in JAX). Under a
    mesh, this rank's rows (of the tokens, the prefix and the frames) and
    pieces."""
    L.check_mesh(cfg, ctx)
    if cfg.is_encdec:
        if enc_frames is None:
            raise ValueError(f"{cfg.name}: an encdec prefill needs enc_frames, the encoder's "
                             "(B, F, d) frame embeddings (model_zoo.frontend_stub)")
        enc_out = encode(cfg, params, enc_frames, attn_chunk=attn_chunk, ctx=ctx)
        cks, cvs = cross_kv(cfg, params, enc_out, ctx)
        cache = {**cache, "cross_k": cks, "cross_v": cvs}
    embeds = None
    if embeds_prefix is not None:
        tok = L.embed_lookup(params.embed, tokens, ctx, cfg.vocab_size)
        embeds = torch.cat([embeds_prefix.to(tok.dtype), tok], dim=1)
    h, cache = decode_forward(cfg, params, cache, tokens, attn_chunk=attn_chunk, embeds=embeds,
                              ctx=ctx)
    cache = {**cache, "length": cache["length"] + h.shape[1]}
    return lm_head(params, h[:, -1:, :], ctx)[:, 0], cache
