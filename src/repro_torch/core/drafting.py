"""Device-side dynamic drafting (SLED §III-A).

The port of ``repro.core.drafting``. The edge device drafts up to ``k_max``
tokens with its local draft model and stops early when the draft
confidence ``c_i`` drops below ``c_th`` (paper Eq. 1): a low-confidence
token is still included in the verification request, but nothing is drafted
behind it. As in the JAX scan, every row runs all ``k_max`` steps and rows
that stopped early carry padding. Sampled drafting (``greedy=False``) draws
each token from the caller's ``torch.Generator`` on the cache's device.

Rollback: the draft KV cache rolls back by setting ``length = base + 1 +
n_accepted``; stale entries past it are masked and later overwritten. An
ssm or hybrid draft's recurrent state cannot roll back by length, so the
round keeps the committed state leaves after every step (a checkpoint) and
the rollback selects the one at the acceptance boundary.

A hybrid draft's K/V leaves are not checkpointed (the JAX package keeps a
copy per step): they are written in place and roll back by length, like a
dense draft's. The two agree on every position a later step reads: a
checkpoint's K/V differ from the round's last cache only at positions the
rolled-back steps wrote, which lie at or past the new length, so the next
round writes each of them before attending to it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core.speculative import sample_token


# cache leaves a draft round does not checkpoint: written in place, rolled
# back by length
_ROLLED_BY_LENGTH = ("k", "v")


@dataclasses.dataclass
class DraftResult:
    tokens: torch.Tensor       # (B, K) drafted tokens (padding past length)
    q_sel: torch.Tensor        # (B, K) q(token)
    q_full: Optional[torch.Tensor]  # (B, K, V) f32 full draft dists (exact residual)
    lengths: torch.Tensor      # (B,) dynamic draft lengths in [1, K]
    confidence: torch.Tensor   # (B, K)
    cache: Any                 # cache after the drafting steps (uncommitted)
    base_length: torch.Tensor  # (B,) cache length before the round
    # ssm, hybrid: the state leaves (and length) after each step, stacked
    # on a leading K axis
    cache_ckpts: Optional[Dict[str, torch.Tensor]] = None


def draft_round(
    model,
    params,
    cache: Dict[str, torch.Tensor],
    prev_token: torch.Tensor,  # (B,) last committed token (cache has not seen it)
    *,
    k_max: int,
    c_th: Union[float, torch.Tensor] = 0.0,  # 0.0 -> fixed-length drafting
    temperature: float = 1.0,
    greedy: bool = True,
    generator: Optional[torch.Generator] = None,
    keep_q_full: bool = False,
    attn_chunk: int = 1024,
) -> DraftResult:
    """One drafting round: feed prev_token, then draft up to k_max tokens."""
    is_ssm = model.cfg.family in ("ssm", "hybrid")
    B = prev_token.shape[0]
    dev = prev_token.device
    base_length = cache["length"]
    tok = prev_token.to(torch.int32)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    ones = torch.ones((B,), dtype=torch.int32, device=dev)
    toks, qs, qf, emitted_all, confs, ckpts = [], [], [], [], [], []
    for _ in range(k_max):
        h, ck = model.decode_forward(params, cache, tok[:, None], attn_chunk=attn_chunk)
        cache = model.commit(ck, ones)  # consume exactly this one token
        if is_ssm:
            ckpts.append({k: a for k, a in cache.items() if k not in _ROLLED_BY_LENGTH})
        logits = model.lm_head(params, h)[:, 0]
        nxt, q, dist = sample_token(logits, generator, temperature, greedy)
        conf = dist.max(dim=-1).values
        emitted = active
        toks.append(torch.where(emitted, nxt, torch.zeros_like(nxt)))
        qs.append(torch.where(emitted, q, torch.zeros_like(q)))
        if keep_q_full:
            qf.append(dist)
        emitted_all.append(emitted)
        confs.append(torch.where(emitted, conf, torch.zeros_like(conf)))
        tok = torch.where(emitted, nxt, tok)
        active = active & (conf >= c_th)
    emitted = torch.stack(emitted_all, dim=1)
    return DraftResult(
        tokens=torch.stack(toks, dim=1),
        q_sel=torch.stack(qs, dim=1),
        q_full=torch.stack(qf, dim=1) if keep_q_full else None,
        lengths=emitted.sum(dim=1).to(torch.int32),
        confidence=torch.stack(confs, dim=1),
        cache=cache,
        base_length=base_length,
        cache_ckpts={k: torch.stack([c[k] for c in ckpts]) for k in ckpts[0]} if is_ssm else None,
    )


def resume_after_verify(draft: DraftResult, n_accepted: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Roll the device cache back to the server-verified prefix: committed
    length ``base + 1 + n_accepted`` (prev_token + accepted drafts); the next
    round feeds the server's correction/bonus token as ``prev_token``.

    An ssm or hybrid draft takes checkpoint ``n_accepted`` per row, the
    state after prev_token and n_accepted drafts; with every draft accepted
    the index is clamped to the last checkpoint, as the JAX package's gather
    clamps it. A hybrid draft keeps the round's K/V leaves."""
    n_accepted = n_accepted.to(draft.base_length.device, torch.int32)
    new_len = draft.base_length + 1 + n_accepted
    if draft.cache_ckpts is None:
        return {**draft.cache, "length": new_len}
    K = draft.cache_ckpts["length"].shape[0]
    i = torch.clamp(n_accepted.long(), 0, K - 1)
    b = torch.arange(i.shape[0], device=i.device)
    cache = {k: a[i, :, b].movedim(0, 1) for k, a in draft.cache_ckpts.items() if k != "length"}
    return {**draft.cache, **cache, "length": new_len}
