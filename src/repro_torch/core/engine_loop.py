"""Synchronous single-host SLED reference loop (draft + verify, real models).

The port of ``repro.core.engine_loop``: the algorithmic ground truth that
the ``reference`` backend runs. A draft model and a target model run the
SLED drafting/verification protocol in lock-step over a batch of prompts;
greedy SLED output must equal greedy target-only output. In sampling mode
the drafts are drawn from a generator seeded with ``seed`` and the verify
batch carries the full draft distributions, so corrections come from the
exact residual.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import drafting, verification
from repro_torch.core.speculative import PAD_TOKEN, sample_token
from repro_torch.models.kvcache import gather_slots
from repro_torch.runtime import DRAFT_STREAM, seeded_generator


@dataclasses.dataclass
class SledStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    committed: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)


def make_sled_steps(draft_model, target_model, *, k_max: int = 4, c_th: float = 0.0,
                    greedy: bool = True, attn_chunk: int = 256) -> dict:
    """The lock-step loop's step bundle (prefill both models, draft, verify)."""
    return {
        "d_prefill": verification.make_prefill_step(draft_model, attn_chunk=attn_chunk),
        "t_prefill": verification.make_prefill_step(target_model, attn_chunk=attn_chunk),
        "verify": verification.make_verify_step(target_model, greedy=greedy,
                                                attn_chunk=attn_chunk),
        "draft": lambda params, cache, prev, generator: drafting.draft_round(
            draft_model, params, cache, prev, k_max=k_max, c_th=c_th, greedy=greedy,
            generator=generator, keep_q_full=not greedy, attn_chunk=attn_chunk,
        ),
    }


@dataclasses.dataclass
class SledRound:
    """One lock-step round's per-row outcome (host numpy)."""

    tokens: np.ndarray  # (B, k_max+1) committed candidates per row
    n_commit: np.ndarray  # (B,) tokens actually committed this round
    lengths: np.ndarray  # (B,) draft tokens proposed
    n_accepted: np.ndarray  # (B,) draft tokens accepted


def _as_prompts(prompts, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(device)


def sled_rounds(
    draft_model, draft_params,
    target_model, target_params,
    prompts,  # (B, P) int
    *,
    max_new: int,
    k_max: int = 4,
    c_th: float = 0.0,
    greedy: bool = True,
    seed: int = 0,
    attn_chunk: int = 256,
    steps: Optional[dict] = None,
    kv_dtype: str = "bf16",
) -> Iterator[SledRound]:
    """THE lock-step SLED loop, as a per-round generator: yields a
    :class:`SledRound` per draft+verify round until every row has committed
    ``max_new`` tokens. Runs on the device the target's weights live on.

    Sampling draws come from the card: the drafts from one generator seeded
    with ``seed``, round r's acceptance and corrections from the verify
    step's, seeded with ``seed + r`` (the JAX package's batch seed), in
    another draw stream (``runtime.seeded_generator``)."""
    dev = target_params.device
    prompts = _as_prompts(prompts, dev)
    B, P = prompts.shape
    max_len = P + max_new + k_max + 8
    steps = steps or make_sled_steps(draft_model, target_model, k_max=k_max, c_th=c_th,
                                     greedy=greedy, attn_chunk=attn_chunk)
    # the target cache honours kv_dtype (it stands in for the server pool the
    # engine must match token for token); the device-side draft cache is bf16
    d_cache = draft_model.make_cache(B, max_len, device=dev, attn_chunk=attn_chunk)
    t_cache = target_model.make_cache(B, max_len, device=dev, attn_chunk=attn_chunk,
                                      kv_dtype=kv_dtype)
    _, d_cache, prev = steps["d_prefill"](draft_params, d_cache, prompts)
    _, t_cache, _ = steps["t_prefill"](target_params, t_cache, prompts)
    gen = seeded_generator(dev, seed, DRAFT_STREAM)
    counts = np.zeros((B,), np.int64)
    rounds = 0
    while counts.min() < max_new:
        dres = steps["draft"](draft_params, d_cache, prev, gen)
        batch = verification.make_verify_batch(
            prev, dres.tokens, dres.lengths, draft_q=None if greedy else dres.q_sel,
            seed=rounds + seed)
        if not greedy and dres.q_full is not None:
            batch["draft_q_full"] = dres.q_full
        res, t_cache = steps["verify"](target_params, t_cache, batch)
        rounds += 1
        d_cache = drafting.resume_after_verify(dres, res.n_accepted)
        prev = res.extra_token
        n_commit = res.n_commit.cpu().numpy()
        counts += n_commit
        yield SledRound(
            tokens=res.out_tokens.cpu().numpy(),
            n_commit=n_commit,
            lengths=dres.lengths.cpu().numpy(),
            n_accepted=res.n_accepted.cpu().numpy(),
        )


def sled_generate(
    draft_model, draft_params,
    target_model, target_params,
    prompts,  # (B, P) int
    *,
    max_new: int,
    k_max: int = 4,
    c_th: float = 0.0,
    greedy: bool = True,
    seed: int = 0,
    attn_chunk: int = 256,
    steps: Optional[dict] = None,
    kv_dtype: str = "bf16",
) -> Tuple[np.ndarray, SledStats]:
    """Run SLED end-to-end. Returns (tokens (B, max_new), stats)."""
    B = np.asarray(prompts).shape[0]
    # rows commit at different rates; a fast row may overshoot max_new by
    # (k_max+1) per round until the slowest row finishes
    out = np.full((B, max_new + 16 * (k_max + 1)), PAD_TOKEN, np.int64)
    counts = np.zeros((B,), np.int64)
    stats = SledStats()
    for rnd in sled_rounds(
        draft_model, draft_params, target_model, target_params, prompts,
        max_new=max_new, k_max=k_max, c_th=c_th, greedy=greedy, seed=seed,
        attn_chunk=attn_chunk, steps=steps, kv_dtype=kv_dtype,
    ):
        for b in range(B):
            n = min(int(rnd.n_commit[b]), out.shape[1] - int(counts[b]))
            out[b, counts[b]: counts[b] + n] = rnd.tokens[b, :n]
            counts[b] += n
        stats.rounds += 1
        stats.drafted += int(rnd.lengths.sum())
        stats.accepted += int(rnd.n_accepted.sum())
        stats.committed += int(rnd.n_commit.sum())
    return out[:, :max_new], stats


def autoregressive_generate(model, params, prompts, *, max_new: int, greedy: bool = True,
                            seed: int = 0, attn_chunk: int = 256) -> np.ndarray:
    """Plain target-only decoding, the centralized-serving baseline; sampled
    tokens come from a generator on the card seeded with ``seed``."""
    dev = params.device
    prompts = _as_prompts(prompts, dev)
    B, P = prompts.shape
    cache = model.make_cache(B, P + max_new + 8, device=dev, attn_chunk=attn_chunk)
    _, cache, prev = verification.make_prefill_step(model, attn_chunk=attn_chunk)(
        params, cache, prompts
    )
    ones = torch.ones((B,), dtype=torch.int32, device=dev)
    gen = seeded_generator(dev, seed, DRAFT_STREAM)
    out = torch.zeros((B, max_new), dtype=torch.int32, device=dev)
    for t in range(max_new):
        h, ck = model.decode_forward(params, cache, prev[:, None], attn_chunk=attn_chunk)
        cache = model.commit(ck, ones)
        logits = model.lm_head(params, h)[:, 0]
        if greedy:
            prev = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            prev = sample_token(logits, gen, greedy=False)[0]
        out[:, t] = prev
    return out.cpu().numpy().astype(np.int64)


def replay_stream(
    model, params, prompt, rounds: Sequence[Sequence[int]], *,
    k_max: int,
    max_len: int,
    prefill_rows: int = 1,
    rows: Optional[Sequence[int]] = None,
    attn_chunk: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """Target-only greedy replay of one served stream on its own commit
    boundaries: what the target computes for the stream, without the
    drafts, the scheduler or the pool.

    ``rounds[r]`` holds the tokens the stream committed in verify round
    ``r``, in order. The replay prefills ``prompt``; then each round feeds
    ``[prev, the round's tokens but the last]``, padded to ``k_max + 1`` as
    a verify step pads it, reads the target's logits at the round's
    positions and commits the round's length (the ssm family: the bf16
    state checkpoint at that boundary, as the verify step commits it).

    The stream's row is repeated to ``prefill_rows`` rows for the prefill
    and to ``rows[r]`` rows in round ``r`` (default 1), so that every
    product can run at the row count the server ran it at: a bf16
    product's last bit may depend on it. Returns ``(greedy, margin)`` per
    committed position: the target's argmax, and how far the committed
    token's logit lies below the largest logit (0 where they agree)."""
    dev = params.device
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    cache = model.make_cache(prefill_rows, max_len, device=dev, attn_chunk=attn_chunk)
    tokens = torch.as_tensor(prompt).to(dev)[None].repeat(prefill_rows, 1)
    _, cache, _ = verification.make_prefill_step(model, attn_chunk=attn_chunk)(
        params, cache, tokens)
    row0 = torch.zeros((1,), dtype=torch.int64, device=dev)
    cache = gather_slots(cache, row0)
    prev = int(prompt[-1])
    greedy, margin = [], []
    for r, committed in enumerate(rounds):
        n = len(committed)
        m = rows[r] if rows is not None else 1
        feed = np.zeros((k_max + 1,), np.int32)
        feed[0] = prev
        feed[1:n] = committed[:-1]
        h, ck = model.decode_forward(
            params, gather_slots(cache, row0.repeat(m)),
            torch.as_tensor(feed).to(dev)[None].repeat(m, 1), attn_chunk=attn_chunk)
        logits = model.lm_head(params, h)[0, :n].float()
        n_commit = torch.full((m,), n, dtype=torch.int32, device=dev)
        cache = gather_slots(model.commit(ck, n_commit), row0)
        chosen = logits[torch.arange(n, device=dev),
                        torch.as_tensor(np.asarray(committed, np.int64)).to(dev)]
        greedy.extend(logits.argmax(dim=-1).tolist())
        margin.extend((logits.max(dim=-1).values - chosen).tolist())
        prev = int(committed[-1])
    return np.asarray(greedy, np.int64), np.asarray(margin, np.float64)
