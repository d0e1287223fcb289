"""Server-side batched verification (SLED §III-B): the serve step.

The port of ``repro.core.verification``. Invariant (shared with
core/drafting.py):
  * ``cache.length`` counts K/V-committed tokens = (#committed tokens) - 1;
  * a verify step feeds ``tokens_in = [prev_committed, d_1 .. d_K]`` (K+1
    tokens), so ``logits[i]`` judges ``d_{i+1}`` and ``logits[m]`` is the
    correction/bonus distribution (core/speculative.py);
  * commit sets ``length += n_commit``.

The steps are plain functions (PyTorch runs eagerly; the JAX package jits
them). They update the cache's K/V buffers in place and return the cache
dict with a new ``length``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.speculative import VerifyResult, speculative_verify
from repro_torch.models.kvcache import supports_paged_attention


def make_verify_batch(prev_token: torch.Tensor, draft_tokens: torch.Tensor,
                      lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Assemble the padded verification request batch."""
    return {
        "tokens_in": torch.cat([prev_token[:, None].to(torch.int32),
                                draft_tokens.to(torch.int32)], dim=1),
        "draft_tokens": draft_tokens.to(torch.int32),
        "lengths": lengths.to(torch.int32),
    }


def make_verify_step(model, *, greedy: bool = True, attn_chunk: int = 1024):
    """Dense-cache step: ``verify_step(params, cache, batch) -> (VerifyResult, cache)``."""

    def verify_step(params, cache, batch) -> Tuple[VerifyResult, Any]:
        h, ck_cache = model.decode_forward(params, cache, batch["tokens_in"], attn_chunk=attn_chunk)
        logits = model.lm_head(params, h)  # (B, K+1, V) f32
        res = speculative_verify(batch["draft_tokens"], logits, lengths=batch["lengths"],
                                 greedy=greedy)
        return res, model.commit(ck_cache, res.n_commit)

    return verify_step


def _require_paged(model) -> None:
    if not supports_paged_attention(model.cfg):
        raise NotImplementedError(
            f"{model.cfg.family!r} caches need the gather/scatter verify path, which is not "
            "ported yet (ROADMAP.md Queue A, 'Other model families')"
        )


def make_paged_verify_step(model, *, scratch_slot: int, greedy: bool = True,
                           attn_chunk: int = 1024):
    """Slot-indexed verify step for continuous batching over a row pool:
    ``verify_step(params, pool, slots, batch) -> (VerifyResult, pool)``.

    The forward runs straight against the pool: the K+1 fresh K/V rows go
    into pool rows ``slots`` and attention reads the rows out of the pool
    (the paged kernel on CUDA); commit is a per-slot length bump.

    Padding entries point at ``scratch_slot`` with ``lengths = 0``; the step
    resets the scratch row's length so padding never walks it off the end.
    """
    _require_paged(model)

    def verify_step(params, pool, slots, batch) -> Tuple[VerifyResult, Any]:
        idx = slots.long()
        base_len = pool["length"][idx]
        h, new_pool = model.decode_forward(params, pool, batch["tokens_in"],
                                           attn_chunk=attn_chunk, slots=slots)
        logits = model.lm_head(params, h)  # (B_bucket, K+1, V) f32
        res = speculative_verify(batch["draft_tokens"], logits, lengths=batch["lengths"],
                                 greedy=greedy)
        # duplicate scratch entries race here; the scratch row is reset
        # right after and never read as committed
        length = new_pool["length"].clone()
        length[idx] = base_len + res.n_commit
        length[scratch_slot] = 0
        return res, {**new_pool, "length": length}

    return verify_step


def make_force_extend_step(model, *, attn_chunk: int = 1024):
    """Slot-indexed forced cache extension (no verification):
    ``extend_step(params, pool, slots, tokens_in, n) -> pool`` appends
    ``n[i]`` tokens of ``tokens_in[i]`` to pool row ``slots[i]`` (the §III-A
    fallback resync), against the pool like the verify step."""
    _require_paged(model)

    def extend_step(params, pool, slots, tokens_in, n):
        idx = slots.long()
        base_len = pool["length"][idx]
        _, new_pool = model.decode_forward(params, pool, tokens_in, attn_chunk=attn_chunk,
                                           slots=slots)
        length = new_pool["length"].clone()
        length[idx] = base_len + n.to(torch.int32)
        return {**new_pool, "length": length}

    return extend_step


def make_prefill_step(model, *, attn_chunk: int = 1024):
    """``prefill_step(params, cache, tokens) -> (logits, cache, last_token)``.

    Leaves the cache at ``length = prompt_len - 1`` and returns the last
    prompt token separately: the "all committed but the last" invariant, so
    the first verify round can feed it."""

    def prefill_step(params, cache, tokens):
        logits, cache = model.prefill(params, tokens[:, :-1], cache, attn_chunk=attn_chunk)
        return logits, cache, tokens[:, -1]

    return prefill_step
