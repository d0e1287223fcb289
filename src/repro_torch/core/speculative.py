"""Batched lossless speculative verification, SLED-style (greedy mode).

The port of ``repro.core.speculative``. Alignment invariant (see
core/verification.py): the server feeds ``tokens_in = [prev_committed_token,
d_1 .. d_K]`` and the target returns ``logits[i] = p(. | context,
tokens_in[:i+1])``, so ``logits[i]`` judges draft ``d_{i+1}`` and
``logits[m]`` gives the correction/bonus token after ``m`` accepted drafts.

Only greedy acceptance (argmax equality, exactly lossless) is ported; the
rejection-sampling mode needs its own statistical parity tests and comes
later (ROADMAP.md Queue A, 'Sampling').
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

PAD_TOKEN = -1


def _sampling_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "greedy=False (rejection sampling) is not ported yet (ROADMAP.md Queue A, 'Sampling')"
    )


@dataclasses.dataclass
class VerifyResult:
    n_accepted: torch.Tensor  # (B,) accepted draft count m in [0, K]
    n_commit: torch.Tensor    # (B,) committed new tokens = m + 1
    out_tokens: torch.Tensor  # (B, K+1): d_1..d_m, extra, PAD...
    extra_token: torch.Tensor  # (B,) correction (rejected) or bonus (all accepted)
    accepted_mask: torch.Tensor  # (B, K)
    rejected: torch.Tensor    # (B,) True if a draft was rejected (m < length)


def speculative_verify(
    draft_tokens: torch.Tensor,   # (B, K) int32 (padded with anything past length)
    target_logits: torch.Tensor,  # (B, K+1, V) f32
    *,
    lengths: Optional[torch.Tensor] = None,  # (B,) in [0, K]; None -> all K
    greedy: bool = True,
) -> VerifyResult:
    if not greedy:
        raise _sampling_not_ported()
    B, K = draft_tokens.shape
    dev = draft_tokens.device
    if lengths is None:
        lengths = torch.full((B,), K, dtype=torch.int32, device=dev)
    lengths = lengths.to(torch.int32)
    tgt_choice = torch.argmax(target_logits[:, :K], dim=-1)  # (B, K)
    accept = tgt_choice == draft_tokens
    valid = torch.arange(K, device=dev)[None, :] < lengths[:, None]
    accept = accept & valid
    # first failure = acceptance count m (positions past length auto-fail)
    fail = ~accept
    first_fail = torch.argmax(fail.to(torch.int32), dim=1)
    m = torch.where(fail.any(dim=1), first_fail, torch.full_like(first_fail, K)).to(torch.int32)
    rejected = m < lengths
    extra_logits = target_logits[torch.arange(B, device=dev), m.long()]  # (B, V)
    extra = torch.argmax(extra_logits, dim=-1).to(draft_tokens.dtype)
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


def sample_token(logits: torch.Tensor, temperature: float = 1.0, greedy: bool = True):
    """(token, prob-of-token, full-dist) from (B, V) logits (greedy only)."""
    if not (greedy or temperature <= 0.0):
        raise _sampling_not_ported()
    probs = torch.softmax(logits.float() / max(temperature, 1e-6), dim=-1)
    tok = torch.argmax(logits, dim=-1)
    p = torch.gather(probs, -1, tok[..., None])[..., 0]
    return tok.to(torch.int32), p, probs
