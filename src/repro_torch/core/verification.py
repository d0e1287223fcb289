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

Two dispatch modes serve a row pool, as in the JAX package: the pool-
resident slot-indexed forward (the attention families with
``paged_attention=True``), and gather/scatter, which copies the scheduled
rows into a dense sub-cache, runs the dense forward and commit there, and
writes the rows back (``paged_attention=False``, and the ssm and hybrid
families, whose recurrent state is not position-indexed). Each pool step
carries the mode it runs as ``.paged_attention``.

Under a mesh (``ctx``, ``sharding.policy.Policy.ctx``), the dense-cache
steps ``make_verify_step`` and ``make_prefill_step`` run in every rank on
its pieces (``policy.shard_params``, ``policy.shard_cache``,
``policy.shard_batch``) and return its rows: the decode cell's batched
verification on a mesh, every family (an ssm or hybrid commit selects
the rank's piece of the state checkpoints, its heads). The pool steps
stay single-rank, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.speculative import VerifyResult, speculative_verify
from repro_torch.models.kvcache import gather_slots, scatter_slots, supports_paged_attention
from repro_torch.models.layers import NO_MESH, MeshContext
from repro_torch.runtime import VERIFY_STREAM, seeded_generator


def _use_paged(model, paged_attention: bool) -> bool:
    """The slot-indexed mode: asked for, and every cache leaf position-indexed."""
    return bool(paged_attention) and supports_paged_attention(model.cfg)


def make_verify_batch(prev_token: torch.Tensor, draft_tokens: torch.Tensor,
                      lengths: torch.Tensor, draft_q: Optional[torch.Tensor] = None,
                      seed: int = 0) -> Dict[str, Any]:
    """Assemble the padded verification request batch. ``seed`` (a uint32,
    as in the JAX package) seeds the round's acceptance and correction
    draws in sampling mode; ``draft_q`` (B, K) carries q(d_i)."""
    batch = {
        "tokens_in": torch.cat([prev_token[:, None].to(torch.int32),
                                draft_tokens.to(torch.int32)], dim=1),
        "draft_tokens": draft_tokens.to(torch.int32),
        "lengths": lengths.to(torch.int32),
        "seed": int(seed) & 0xFFFFFFFF,
    }
    if draft_q is not None:
        batch["draft_q"] = draft_q
    return batch


def _verify(model, params, h, batch, *, greedy: bool, ctx: MeshContext = NO_MESH
            ) -> VerifyResult:
    """Logits of the fed positions, then the acceptance rule; a sampling
    round draws at temperature 1 (a ServeSpec sets none) from a generator on
    the logits' device seeded from the batch's seed."""
    # (B, K+1, V) f32; the mesh's ctx only under a mesh: the model's head
    # keeps the JAX interface, lm_head(params, h)
    logits = model.lm_head(params, h, ctx) if ctx.sharded else model.lm_head(params, h)
    gen = None if greedy else seeded_generator(logits.device, batch["seed"], VERIFY_STREAM)
    return speculative_verify(
        batch["draft_tokens"], logits, gen, lengths=batch["lengths"],
        draft_q=batch.get("draft_q"), draft_q_full=batch.get("draft_q_full"),
        greedy=greedy,
    )


def make_verify_step(model, *, ctx: MeshContext = NO_MESH, greedy: bool = True,
                     attn_chunk: int = 1024):
    """Dense-cache step: ``verify_step(params, cache, batch) -> (VerifyResult, cache)``
    (under a mesh: this rank's pieces and rows)."""

    def verify_step(params, cache, batch) -> Tuple[VerifyResult, Any]:
        h, ck_cache = model.decode_forward(params, cache, batch["tokens_in"], attn_chunk=attn_chunk,
                                           ctx=ctx)
        res = _verify(model, params, h, batch, greedy=greedy, ctx=ctx)
        return res, model.commit(ck_cache, res.n_commit)

    return verify_step


def make_paged_verify_step(model, *, scratch_slot: int, greedy: bool = True,
                           attn_chunk: int = 1024, paged_attention: bool = True):
    """Verify step for continuous batching over a row pool:
    ``verify_step(params, pool, slots, batch) -> (VerifyResult, pool)``.

    Slot-indexed for the attention families with ``paged_attention``: the
    forward runs straight against the pool, the K+1 fresh K/V rows go into
    pool rows ``slots`` and attention reads the rows out of the pool (the
    paged kernel on CUDA); commit is a per-slot length bump. Gather/scatter
    otherwise (``paged_attention=False``, the ssm and hybrid families): the
    rows are copied out, run and committed densely (``model.commit``; for a
    recurrent state the checkpoint at the acceptance boundary), and written
    back.

    Padding entries point at ``scratch_slot`` with ``lengths = 0``; the step
    resets the scratch row's length so padding never walks it off the end.
    """

    def paged_verify_step(params, pool, slots, batch) -> Tuple[VerifyResult, Any]:
        idx = slots.long()
        base_len = pool["length"][idx]
        h, new_pool = model.decode_forward(params, pool, batch["tokens_in"],
                                           attn_chunk=attn_chunk, slots=slots)
        res = _verify(model, params, h, batch, greedy=greedy)
        # duplicate scratch entries race here; the scratch row is reset
        # right after and never read as committed
        length = new_pool["length"].clone()
        length[idx] = base_len + res.n_commit
        length[scratch_slot] = 0
        return res, {**new_pool, "length": length}

    def gather_verify_step(params, pool, slots, batch) -> Tuple[VerifyResult, Any]:
        sub = gather_slots(pool, slots)
        h, ck_sub = model.decode_forward(params, sub, batch["tokens_in"], attn_chunk=attn_chunk)
        res = _verify(model, params, h, batch, greedy=greedy)
        new_pool = scatter_slots(pool, slots, model.commit(ck_sub, res.n_commit))
        new_pool["length"][scratch_slot] = 0  # scatter_slots made a new length tensor
        return res, new_pool

    step = paged_verify_step if _use_paged(model, paged_attention) else gather_verify_step
    step.paged_attention = step is paged_verify_step
    return step


def make_force_extend_step(model, *, attn_chunk: int = 1024, paged_attention: bool = True):
    """Forced cache extension over a row pool (no verification):
    ``extend_step(params, pool, slots, tokens_in, n) -> pool`` appends
    ``n[i]`` tokens of ``tokens_in[i]`` to pool row ``slots[i]`` (the §III-A
    fallback resync), slot-indexed or by gather/scatter like the verify
    step."""

    def paged_extend_step(params, pool, slots, tokens_in, n):
        idx = slots.long()
        base_len = pool["length"][idx]
        _, new_pool = model.decode_forward(params, pool, tokens_in, attn_chunk=attn_chunk,
                                           slots=slots)
        length = new_pool["length"].clone()
        length[idx] = base_len + n.to(torch.int32)
        return {**new_pool, "length": length}

    def gather_extend_step(params, pool, slots, tokens_in, n):
        sub = gather_slots(pool, slots)
        _, ck_sub = model.decode_forward(params, sub, tokens_in, attn_chunk=attn_chunk)
        return scatter_slots(pool, slots, model.commit(ck_sub, n.to(torch.int32)))

    step = paged_extend_step if _use_paged(model, paged_attention) else gather_extend_step
    step.paged_attention = step is paged_extend_step
    return step


def make_prefill_step(model, *, ctx: MeshContext = NO_MESH, attn_chunk: int = 1024,
                      with_frontend: bool = False):
    """``prefill_step(params, cache, tokens, stub=None) -> (logits, cache,
    last_token)``.

    Leaves the cache at ``length = prompt_len - 1`` (plus the stub's rows)
    and returns the last prompt token separately: the "all committed but
    the last" invariant, so the first verify round can feed it. With
    ``with_frontend``, ``stub`` is the model's stub frontend
    (``model_zoo.frontend_stub``): an encdec model's encoder frames, or a
    vlm model's patch embeddings, which precede its prompt. Under a mesh,
    this rank's pieces and rows: ``tokens`` and ``stub`` are its rows
    (``policy.shard_batch``)."""

    def prefill_step(params, cache, tokens, stub=None):
        kw = {}
        if with_frontend and model.cfg.family == "encdec":
            kw["enc_frames"] = stub
        if with_frontend and model.cfg.family == "vlm":
            kw["embeds_prefix"] = stub
        logits, cache = model.prefill(params, tokens[:, :-1], cache, attn_chunk=attn_chunk,
                                      ctx=ctx, **kw)
        return logits, cache, tokens[:, -1]

    return prefill_step
