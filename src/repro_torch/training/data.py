"""Synthetic data: deterministic, restart-safe (the port of ``repro.training.data``).

``batch_at(step)`` is a pure function of (seed, step, shape), so a resumed
run regenerates exactly the batches it would have seen, which is what
makes a kill-and-resume bit for bit. Tokens and labels are numpy, drawn as
the JAX package draws them (the same generator, seeds and arithmetic), so
the two packages train on the same tokens.

The vlm and encdec families' stub frontend (``model_zoo.frontend_stub``)
draws from a CPU ``torch.Generator`` seeded with ``seed ^ (step + 1)``,
where the JAX package uses ``jax.random.key`` of the same number: the
draws differ between the packages (the tests hand JAX's stub over), and
are the same on every device, since the generator is the CPU's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.model_zoo import frontend_stub


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_clusters: int = 32   # structure level of the synthetic distribution
    mode: str = "cluster"  # cluster | markov
    det_frac: float = 0.85  # markov mode: P(next token is the deterministic successor)


def _batch_tokens(dcfg: DataConfig, step: int) -> np.ndarray:
    rng = np.random.default_rng((dcfg.seed << 20) ^ step)
    B, S, V = dcfg.global_batch, dcfg.seq_len, dcfg.vocab_size
    if dcfg.mode == "markov":
        # mostly-deterministic chain: next = f(cur) w.p. det_frac else uniform
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.integers(0, V, (B,))
        det = rng.random((B, S)) < dcfg.det_frac
        jumps = rng.integers(0, V, (B, S))
        for t in range(1, S):
            nxt = (toks[:, t - 1] * 31 + 7) % V
            toks[:, t] = np.where(det[:, t], nxt, jumps[:, t])
        return toks.astype(np.int32)
    k = min(dcfg.n_clusters, V)
    # cluster-conditioned token stream: p(next | cluster) is low-entropy
    clusters = rng.integers(0, k, (B, 1))
    drift = rng.integers(0, k, (B, S)) == 0
    clusters = (clusters + np.cumsum(drift, axis=1)) % k
    centers = (clusters * (V // k)) % V
    offsets = rng.integers(0, max(V // k, 1), (B, S))
    return ((centers + offsets) % V).astype(np.int32)


def batch_at(dcfg: DataConfig, step: int, model_cfg=None) -> Dict[str, object]:
    """``tokens`` and ``labels`` (B, S-1) int32 numpy; for the vlm and
    encdec families also ``frontend``, a bf16 CPU tensor."""
    toks = _batch_tokens(dcfg, step)
    tokens, labels = toks[:, :-1], toks[:, 1:].astype(np.int32)
    batch: Dict[str, object] = {"tokens": tokens, "labels": labels}
    if model_cfg is not None and model_cfg.family in ("encdec", "vlm"):
        gen = torch.Generator(device="cpu").manual_seed(dcfg.seed ^ (step + 1))
        batch["frontend"] = frontend_stub(model_cfg, dcfg.global_batch, gen)
    return batch


def data_iterator(dcfg: DataConfig, start_step: int = 0, model_cfg=None) -> Iterator[Dict]:
    step = start_step
    while True:
        yield batch_at(dcfg, step, model_cfg)
        step += 1
