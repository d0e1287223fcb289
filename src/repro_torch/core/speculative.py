"""Batched lossless speculative verification (Leviathan et al. 2023), SLED-style.

The port of ``repro.core.speculative``. Alignment invariant (see
core/verification.py): the server feeds ``tokens_in = [prev_committed_token,
d_1 .. d_K]`` and the target returns ``logits[i] = p(. | context,
tokens_in[:i+1])``, so ``logits[i]`` judges draft ``d_{i+1}`` and
``logits[m]`` gives the correction/bonus token after ``m`` accepted drafts.

Modes:
  greedy=True   acceptance is argmax equality; exactly lossless.
  greedy=False  Leviathan rejection sampling, with draws from a
                ``torch.Generator`` on the tensors' device (the JAX package
                takes a ``jax.random`` key; the streams differ, so sampling is
                held to the JAX package statistically). Exact residual
                sampling needs the draft distribution at the rejected position
                (``draft_q_full``); without it the correction is sampled from
                the target distribution, the JAX package's documented
                deviation, copied here as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

PAD_TOKEN = -1


@dataclasses.dataclass
class VerifyResult:
    n_accepted: torch.Tensor  # (B,) accepted draft count m in [0, K]
    n_commit: torch.Tensor    # (B,) committed new tokens = m + 1
    out_tokens: torch.Tensor  # (B, K+1): d_1..d_m, extra, PAD...
    extra_token: torch.Tensor  # (B,) correction (rejected) or bonus (all accepted)
    accepted_mask: torch.Tensor  # (B, K)
    rejected: torch.Tensor    # (B,) True if a draft was rejected (m < length)


def _categorical(dist: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of (B, V) probabilities, on their device. Entries are
    floored at 1e-30 as the JAX package's ``categorical(log(max(dist,
    1e-30)))`` floors them."""
    return torch.multinomial(torch.clamp(dist, min=1e-30), 1, generator=generator)[:, 0]


def speculative_verify(
    draft_tokens: torch.Tensor,   # (B, K) int32 (padded with anything past length)
    target_logits: torch.Tensor,  # (B, K+1, V) f32
    generator: Optional[torch.Generator] = None,
    *,
    lengths: Optional[torch.Tensor] = None,  # (B,) in [0, K]; None -> all K
    draft_q: Optional[torch.Tensor] = None,  # (B, K) q(d_i) from the draft model
    draft_q_full: Optional[torch.Tensor] = None,  # (B, K, V) full draft dists
    temperature: float = 1.0,
    greedy: bool = True,
) -> VerifyResult:
    B, K = draft_tokens.shape
    dev = draft_tokens.device
    if lengths is None:
        lengths = torch.full((B,), K, dtype=torch.int32, device=dev)
    lengths = lengths.to(torch.int32)
    b_idx = torch.arange(B, device=dev)
    if greedy:
        accept = torch.argmax(target_logits[:, :K], dim=-1) == draft_tokens
    else:
        if draft_q is None:
            raise ValueError("sampling mode needs draft token probabilities (draft_q)")
        logp = torch.log_softmax(target_logits[:, :K] / temperature, dim=-1)
        p_sel = torch.exp(torch.gather(logp, -1, draft_tokens.long()[..., None])[..., 0])
        del logp  # (B, K, V) f32: 5 GB at B=8192 and V=151936
        u = torch.rand((B, K), generator=generator, device=dev)
        accept = u < p_sel / torch.clamp(draft_q, min=1e-20)
    valid = torch.arange(K, device=dev)[None, :] < lengths[:, None]
    accept = accept & valid
    # first failure = acceptance count m (positions past length auto-fail)
    fail = ~accept
    first_fail = torch.argmax(fail.to(torch.int32), dim=1)
    m = torch.where(fail.any(dim=1), first_fail, torch.full_like(first_fail, K)).to(torch.int32)
    rejected = m < lengths
    extra_logits = target_logits[b_idx, m.long()]  # (B, V)
    if greedy:
        extra = torch.argmax(extra_logits, dim=-1)
    else:
        p_m = torch.softmax(extra_logits / temperature, dim=-1)
        if draft_q_full is not None:
            q_m = draft_q_full[b_idx, torch.clamp(m, max=K - 1).long()]
            resid = torch.clamp(p_m - q_m, min=0.0)
            rs = resid.sum(-1, keepdim=True)
            resid = torch.where(rs > 1e-9, resid / torch.clamp(rs, min=1e-9), p_m)
            dist = torch.where(rejected[:, None], resid, p_m)
        else:
            dist = p_m  # the target-fallback residual (approximate; see module doc)
        extra = _categorical(dist, generator)
    extra = extra.to(draft_tokens.dtype)
    # committed tokens: accepted drafts, then the extra token, then PAD
    pos = torch.arange(K + 1, device=dev)[None, :]
    drafts_p1 = torch.nn.functional.pad(draft_tokens, (0, 1))
    out = torch.where(pos < m[:, None], drafts_p1, torch.full_like(drafts_p1, PAD_TOKEN))
    out = torch.where(pos == m[:, None], extra[:, None], out)
    return VerifyResult(
        n_accepted=m,
        n_commit=m + 1,
        out_tokens=out,
        extra_token=extra,
        accepted_mask=accept,
        rejected=rejected,
    )


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0, greedy: bool = True):
    """(token, prob-of-token, full-dist) from (B, V) logits; a sampled token is
    drawn from ``generator`` on the logits' device."""
    probs = torch.softmax(logits.float() / max(temperature, 1e-6), dim=-1)
    if greedy or temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
    else:
        # the JAX package draws categorical(logits / T): the same distribution
        tok = _categorical(probs, generator)
    p = torch.gather(probs, -1, tok[..., None])[..., 0]
    return tok.to(torch.int32), p, probs
