"""Zamba2-style hybrid: a Mamba2 backbone and one shared attention block.

The port of ``repro.models.hybrid``. The shared block (ln1, attn, ln2,
mlp) runs after every ``cfg.attn_every`` SSD layers; its weights are tied
across the ``n_apps = L // attn_every`` applications, but each application
has its own K/V slice of the cache. SSD layers past the last full group
(the tail) run after it.

Prefill runs each SSD layer's chunked scan (``kernels/ops.ssd_scan``: the
Hopper kernel on CUDA) and the shared block's attention over a dense cache
(``kernels/ops.verify_attention``); the verify step runs the SSD layers'
O(1) recurrence token by token with per-position state checkpoints, as
``models/mamba2.py`` does, and the shared block's attention over the
cache. Speculative rollback: ``select_checkpoint`` commits the SSD states
at the acceptance boundary (bf16 checkpoints widened to f32, as in the JAX
package); the K/V leaves roll back by ``length`` like any KV cache.

Training runs ``forward``, the cache-free form: the SSD layers' scans
from a zero state and each application of the shared block causal over
its fresh K/V (``transformer._train_block``), each layer and application
optionally recomputed in the backward (``remat``). The tied block's
gradient sums its applications' in reverse order of application (JAX's
scan transpose sums them in its own order: the same sum, rounded
differently).

The cache is ``ssm`` (L, B, H, P, N) f32, ``conv`` (L, B, cw-1, C) bf16,
``k``/``v`` (n_apps, B, max_len, Hkv, D) bf16 and ``length`` (B,): every
leaf but ``length`` carries the batch on axis 1, so the pool's
gather/scatter and a migrated row move it leaf by leaf. A draft of fewer
layers than ``attn_every`` has ``n_apps`` 0 and empty K/V leaves.

Under a mesh (``ctx``) each rank runs its rows: the embedding and head
vocabulary-parallel where the vocabulary splits, every SSD layer on the
rank's heads as ``models/mamba2.py`` runs it, and the shared block's
attention and MLP in their tensor-parallel forms (``transformer.
block_forward``), its K/V leaves split by KV head (or by sequence where
the KV heads do not split: every row's fresh rows at row 0's length).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T
from repro_torch.models.transformer import CausalLM, lm_head  # noqa: F401 - the family's head


def n_apps(cfg) -> int:
    return cfg.num_layers // cfg.attn_every


class Hybrid(CausalLM):
    """Weights of one hybrid model: the shared embedding, norm and head, the
    per-layer SSD blocks (``layers``) and the weight-tied attention block
    (``shared``)."""

    def __init__(self, cfg, device=None):
        if cfg.family != "hybrid":
            raise ValueError(f"Hybrid holds the hybrid family, not {cfg.family!r}")
        super().__init__(cfg, device=device)
        self.layers = nn.ModuleList(M2.SSDLayer(cfg, device=device) for _ in range(cfg.num_layers))
        self.shared = T.Block(cfg, device=device)


def init_params(cfg, generator: torch.Generator) -> Hybrid:
    """Seeded random weights with the JAX package's distributions (the draws
    differ from ``jax.random``'s; tests bridge JAX weights in instead)."""
    dev = generator.device
    model = Hybrid(cfg, device=dev)
    with torch.no_grad():
        model.embed.copy_(torch.randn(model.embed.shape, generator=generator, device=dev) * 0.02)
        for lp in model.layers:
            M2.init_ssd_layer_(lp, cfg, generator)
        L.init_attention_(model.shared.attn, cfg, generator)
        L.init_mlp_(model.shared.mlp, cfg, generator)
        if model.lm_head_w is not None:
            model.lm_head_w.copy_(
                torch.randn(model.lm_head_w.shape, generator=generator, device=dev) * 0.02)
    return model


def make_cache(cfg, batch: int, max_len: int, *, device, attn_chunk: int = 1024,
               kv_dtype: str = "bf16", **_) -> Dict[str, torch.Tensor]:
    """The SSD state leaves and one K/V slice per application, ``max_len``
    rounded up to a multiple of the attention chunk. No quantized layout."""
    if kv_dtype != "bf16":
        raise ValueError(f"the hybrid family's cache has no {kv_dtype!r} layout")
    max_len = -(-max_len // attn_chunk) * attn_chunk
    shape = (n_apps(cfg), batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        **M2.make_cache(cfg, batch, device=device),
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }


def forward(cfg, params: Hybrid, tokens: torch.Tensor, *, remat: bool = False,
            attn_chunk: int = 1024, **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache-free training forward (the JAX ``forward``): groups of
    ``attn_every`` SSD layers, each followed by the weight-tied shared
    block, then the tail layers; (hidden after the final norm, a zero aux
    loss). Use ``transformer.train_lm_head`` for the logits."""
    x = torch.nn.functional.embedding(tokens.long(), params.embed)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    shared = functools.partial(T._train_block, cfg, params.shared, positions=positions,
                               chunk=attn_chunk)
    for li, lp in enumerate(params.layers):
        x = M2.train_layer(cfg, lp, x, remat)
        if (li + 1) % cfg.attn_every == 0:  # the end of a group: the shared block
            if remat:
                x = torch.utils.checkpoint.checkpoint(shared, x, None, use_reentrant=False)[0]
            else:
                x = shared(x, None)[0]
    return (L.apply_norm(x, params.final_norm, cfg.norm),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _run_cached(cfg, params: Hybrid, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                attn_chunk: int, decode: bool, ctx: L.MeshContext):
    """Every layer in order over ``tokens``, the shared block after each
    group. Prefill returns each SSD layer's final state (the conv window in
    bf16); decode its per-position checkpoints. The fresh K/V rows go into
    the cache's buffers in place."""
    x = L.embed_lookup(params.embed, tokens, ctx, cfg.vocab_size)
    S = tokens.shape[1]
    cache_len, write, start = (T.cache_append(cache, S, ctx) if n_apps(cfg)
                               else (cache["length"], None, None))
    positions = cache_len[:, None] + torch.arange(S, dtype=torch.int32, device=x.device)[None]
    ck, cv = cache["k"], cache["v"]
    kv_valid = cache_len + S
    states, convs = [], []
    for li, lp in enumerate(params.layers):
        h0, c0 = cache["ssm"][li], cache["conv"][li]
        if decode:
            x, h, c = M2.ssd_layer_decode(cfg, lp, x, h0, c0, ctx)
        else:
            x, (h, c) = M2.ssd_layer_forward(cfg, lp, x, h0=h0, conv0=c0, return_state=True,
                                             ctx=ctx)
            c = c.to(torch.bfloat16)
        states.append(h)
        convs.append(c)
        if (li + 1) % cfg.attn_every == 0:  # the end of a group: the shared block
            x = T.block_forward(cfg, params.shared, x, positions, ck, cv, kv_valid, write,
                                layer=(li + 1) // cfg.attn_every - 1, chunk=attn_chunk, ctx=ctx,
                                start=start)
    return L.apply_norm(x, params.final_norm, cfg.norm), torch.stack(states), torch.stack(convs)


def prefill(cfg, params: Hybrid, tokens: torch.Tensor, cache: Dict[str, torch.Tensor], *,
            attn_chunk: int = 1024, ctx: L.MeshContext = L.NO_MESH, **_):
    """Fill the cache from a prompt; returns (last-position logits, cache).
    Under a mesh, this rank's rows, pieces and heads."""
    L.check_mesh(cfg, ctx)
    x, ssm, conv = _run_cached(cfg, params, cache, tokens, attn_chunk, False, ctx)
    new_cache = {"ssm": ssm, "conv": conv, "k": cache["k"], "v": cache["v"],
                 "length": cache["length"] + tokens.shape[1]}
    return lm_head(params, x[:, -1:], ctx)[:, 0], new_cache


def decode_forward(cfg, params: Hybrid, cache: Dict[str, torch.Tensor], tokens: torch.Tensor, *,
                   attn_chunk: int = 1024, slots: Optional[torch.Tensor] = None,
                   ctx: L.MeshContext = L.NO_MESH, **_):
    """Verify-style decode of K tokens: (hidden (B, K, d), cache with the
    K/V rows written and ``ssm_ckpt``/``conv_ckpt`` checkpoints); commit
    with ``select_checkpoint``. Under a mesh, this rank's rows, pieces and
    heads."""
    L.check_mesh(cfg, ctx, slots)
    if slots is not None:
        raise NotImplementedError(
            "slot-indexed paged attention is not supported for the 'hybrid' "
            "family: its recurrent state leaves (ssm, conv) are not position-"
            "indexed K/V, so pool rows cannot be addressed in place.  Route "
            "this model through the gather/scatter fallback instead "
            "(paged_attention=False, or gate on "
            "models.kvcache.supports_paged_attention(cfg))."
        )
    x, ssm_ck, conv_ck = _run_cached(cfg, params, cache, tokens, attn_chunk, True, ctx)
    return x, {**cache, "ssm_ckpt": ssm_ck, "conv_ckpt": conv_ck}


def select_checkpoint(cache: Dict[str, torch.Tensor],
                      n_commit: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Commit the SSD states after ``n_commit`` tokens per row (f32 again)
    and keep the K/V leaves, whose rows past the new length are masked."""
    return {**M2.select_checkpoint(cache, n_commit), "k": cache["k"], "v": cache["v"]}
