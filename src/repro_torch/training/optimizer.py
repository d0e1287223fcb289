"""AdamW with f32 master weights, grad clipping, LR schedule (the port of
``repro.training.optimizer``).

State (per parameter leaf), in the JAX package's tree layout
(``bridge.params_tree``: nested dicts, the per-layer leaves stacked along
L), so ``checkpoint.save({"params": ..., "opt": state})`` writes the keys
the JAX ``restore`` reads, and back:
  master: f32 copy of the weights (the live parameters stay bf16)
  m, v:   f32 Adam moments
  step:   int32 scalar tensor

The update is written as tensor ops that follow the JAX code line by line:
the schedule and the bias corrections are f32 tensors, and each leaf's
update runs in its order (``torch.optim.AdamW`` decays and rounds in
another). Decoupled weight decay applies where the master leaf has rank
>= 2; since the leaves are the JAX ones, stacked per-layer norm scales and
biases (L, d) are decayed and only the unstacked 1-D leaves
(``final_norm``, the encoder's final norm) are not, as in JAX.

Trees are nested dicts of tensors; their leaves are taken in sorted key
order, the order of ``jax.tree.leaves``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import bridge
from repro_torch.runtime import resolve_device


class AdamWState(NamedTuple):
    step: torch.Tensor
    master: Any
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, in f32, op by op as
    the JAX function reads. The cosine of the f32 angle is taken in f64
    and rounded once: that is XLA's f32 cosine at every step tested, where
    torch's f32 cosine can be an ulp off."""
    step = step.to(torch.float32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, step))
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos((_f32(math.pi, step) * t).double()).float())
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: Any) -> AdamWState:
    """State for a tree of parameters (``bridge.params_tree(model)``)."""
    leaves = tree_leaves(params)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
    )


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)))


def adamw_update(grads: Any, state: AdamWState,
                 cfg: AdamWConfig) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (the f32 master tree, the state, metrics). The master, m and
    v tensors are updated in place (the JAX update returns new arrays): at
    full width the state is 12 bytes a parameter, and a second copy of it
    would not fit beside the first. Each in-place op rounds as the JAX
    expression it stands for (``b1 * m + (1 - b1) * g``: two products
    rounded, then their sum)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, gnorm), cfg.grad_clip / torch.maximum(gnorm, _f32(1e-9, gnorm)))
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(g, mst, m, v):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = m / bc1  # mhat
        delta.div_((v / bc2).sqrt_().add_(cfg.eps))  # mhat / (sqrt(vhat) + eps)
        if mst.dim() >= 2:  # decoupled weight decay on matrices (and stacked leaves)
            delta.add_(cfg.weight_decay * mst)
        mst.sub_(lr * delta)

    tree_map(upd, grads, state.master, state.m, state.v)
    return state.master, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}


def _pick(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _pick(t, i) for k, t in tree.items()}
    return tree[i]


def cast_like(params_template: Any, master: Any) -> Any:
    return tree_map(lambda t, m: m.to(t.dtype), params_template, master)


# ---------------------------------------------------------------------------
# Gradient compression: int8 with error feedback
# ---------------------------------------------------------------------------


def compress_grads_int8(grads: Any, error_fb: Optional[Any]) -> Tuple[Any, Any]:
    """Int8 quantization with error feedback: (dequantized grads for the
    optimizer, new error buffers). Modelled numerically (quantize, then
    dequantize), as in the JAX package."""
    if error_fb is None:
        error_fb = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                            grads)

    def q(g, e):
        g32 = g.to(torch.float32) + e
        scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
        qi = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq = qi.to(torch.float32) * scale
        return deq.to(g.dtype), g32 - deq

    pairs = tree_map(q, grads, error_fb)
    return _pick(pairs, 0), _pick(pairs, 1)


def opt_state_to_jax(state: AdamWState) -> AdamWState:
    """An ``AdamWState`` with numpy leaves (bf16 as uint16 bits; the master
    weights and moments are f32), the JAX optimizer state's layout."""
    return AdamWState(*(tree_map(bridge.to_numpy, t) for t in state))


def opt_state_from_jax(state: Any, device="cuda") -> AdamWState:
    """The port's ``AdamWState`` on ``device`` of a JAX one (numpy leaves,
    as ``jax.tree.map(np.asarray, state)`` gives them)."""
    device = resolve_device(device)
    conv = lambda a: bridge.to_tensor(a, device)  # noqa: E731
    return AdamWState(step=conv(state.step).to(torch.int32), master=tree_map(conv, state.master),
                      m=tree_map(conv, state.m), v=tree_map(conv, state.v))
