"""Dispatch: one functional interface over the model families.

``build_model(cfg)`` returns a ``Model`` whose functions take the weights
(``params``, a ``transformer.Transformer``, ``mamba2.Mamba2`` or
``hybrid.Hybrid`` module) as their first argument, as the JAX package's
``Model`` takes its parameter pytree:

  init_params(generator, max_pos=0)      -> params on the generator's device
  lm_head(params, hidden)                -> logits f32
  make_cache(batch, max_len, device=...) -> cache dict
  prefill(params, tokens, cache)         -> (last logits, cache)
  decode_forward(params, cache, toks)    -> (hidden, cache)   [verify]
  commit(cache, n_commit)                -> cache  [speculative rollback]
  forward(params, tokens, **kw)          -> (hidden, aux)   [training]
  train_lm_head(params, hidden)          -> logits f32, with a gradient to the table

Every family of the JAX package is ported, serving and training: dense,
vlm, moe, encdec, ssm and hybrid. The stub frontends (``frontend_stub``) enter ``prefill`` as in
the JAX package: the vlm family's patches as ``embeds_prefix``, the encdec
family's frames as ``enc_frames``.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.models import hybrid as HY
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init_params: Callable
    lm_head: Callable
    make_cache: Callable
    prefill: Callable
    decode_forward: Callable
    commit: Callable
    forward: Callable
    train_lm_head: Callable


def _attn_commit(cache, n_commit: torch.Tensor):
    return {k: v for k, v in cache.items() if not k.endswith("_ckpt")} | {
        "length": cache["length"] + n_commit.to(torch.int32)
    }


def build_model(cfg) -> Model:
    if cfg.family == "ssm":
        mod, commit = M2, M2.select_checkpoint
    elif cfg.family == "hybrid":
        mod, commit = HY, HY.select_checkpoint
    else:  # dense | vlm | moe | encdec
        mod, commit = T, _attn_commit
    return Model(
        cfg=cfg,
        init_params=lambda generator, **kw: mod.init_params(cfg, generator, **kw),
        lm_head=mod.lm_head,
        make_cache=lambda batch, max_len, **kw: mod.make_cache(cfg, batch, max_len, **kw),
        prefill=lambda params, tokens, cache, **kw: mod.prefill(cfg, params, tokens, cache, **kw),
        decode_forward=lambda params, cache, tokens, **kw: mod.decode_forward(
            cfg, params, cache, tokens, **kw
        ),
        commit=commit,
        forward=lambda params, tokens, **kw: mod.forward(cfg, params, tokens, **kw),
        train_lm_head=T.train_lm_head,
    )


def frontend_stub(cfg, batch: int, generator: torch.Generator) -> Optional[torch.Tensor]:
    """The stub frontends: the encdec family's (batch, encoder_seq, d) frame
    embeddings, the vlm family's (batch, num_patches, d) patch embeddings;
    bf16, N(0, 1) * 0.02 drawn in f32 from ``generator`` on its device (the
    JAX stub's distribution; the draws differ). None for a family without
    a frontend."""
    if cfg.family == "encdec":
        shape = (batch, cfg.encoder_seq, cfg.d_model)
    elif cfg.family == "vlm":
        shape = (batch, cfg.num_patches, cfg.d_model)
    else:
        return None
    draws = torch.randn(shape, generator=generator, device=generator.device)
    return (draws * 0.02).to(torch.bfloat16)


def perturb_params(params: T.CausalLM, scale: float, generator: torch.Generator) -> T.CausalLM:
    """Gaussian-perturb the matrix weights (norm scales and biases untouched)
    of a copy of ``params``. Two random-init models tend to agree on greedy
    argmax; perturbing the draft dials in partial acceptance."""
    if scale <= 0:
        return params
    noisy = copy.deepcopy(params)
    noisy._head_f32 = (-1, None)
    with torch.no_grad():
        for p in noisy.parameters():
            if p.dim() >= 2:
                noise = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
                p.copy_(p + (scale * noise).to(p.dtype))
    return noisy
