"""Training step: remat forward, sequence-chunked cross-entropy, AdamW (the
port of ``repro.training.train_step``).

  * ``remat`` recomputes each block in the backward, so live activations
    stay near one layer's;
  * the (B, S, V) logits never exist at once: the loss walks sequence
    chunks, each chunk's f32 logits under ``torch.utils.checkpoint`` (its
    logits recomputed in the backward);
  * the gradients come back in the JAX params layout (``bridge.grads_tree``:
    bf16 for bf16 parameters), AdamW updates the f32 master tree, and the
    new master weights are cast into the model's parameters in place (the
    JAX step returns new arrays; here the module is updated and returned).

On the card the attention of every block runs the hand-written forward
and backward kernels (``ops.attention``), and every SSD layer of the ssm
and hybrid families the scan's forward and backward kernels
(``ops.ssd_scan``). Mesh and gradient-sharding arguments belong to the
port's sharding slice and are not taken.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import bridge
from repro_torch.training.optimizer import (
    AdamWConfig, AdamWState, adamw_update, compress_grads_int8, tree_map,
)

IGNORE = -100


def chunked_ce_loss(model, params, h: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 1024) -> torch.Tensor:
    """Mean cross-entropy over the labels that are not IGNORE, chunk by
    chunk of the sequence."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=IGNORE)

    def body(hb, lb):
        logits = model.train_lm_head(params, hb)  # (B, chunk, V) f32
        mask = lb != IGNORE
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, torch.clamp(lb, min=0)[..., None].long())[..., 0]
        nll = (lse - tgt) * mask
        return nll.sum(), mask.sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(0, S + pad, chunk):
        nll, n = torch.utils.checkpoint.checkpoint(body, h[:, i:i + chunk], labels[:, i:i + chunk],
                                                   use_reentrant=False)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    remat: bool = True
    loss_chunk: int = 1024
    attn_chunk: int = 1024
    grad_accum: int = 1
    compress_grads: bool = False  # int8 error-feedback compression
    aux_coef: float = 0.001       # MoE load-balance loss weight


def make_loss_fn(model, tcfg: TrainConfig):
    """loss_fn(params, batch) -> (loss, {"ce", "aux"}); ``batch`` holds
    ``tokens`` and ``labels`` (B, S) and, for the vlm and encdec families,
    ``frontend`` (B, P or F, d), all on the model's device."""
    def loss_fn(params, batch):
        kw = {}
        if model.cfg.family == "encdec":
            kw["enc_frames"] = batch["frontend"]
        elif model.cfg.family == "vlm":
            kw["embeds_prefix"] = batch["frontend"]
        h, aux = model.forward(params, batch["tokens"], remat=tcfg.remat,
                               attn_chunk=tcfg.attn_chunk, **kw)
        labels = batch["labels"]
        if model.cfg.family == "vlm":  # the hidden states include the patch prefix
            labels = F.pad(labels, (model.cfg.num_patches, 0), value=IGNORE)
        loss = chunked_ce_loss(model, params, h, labels, tcfg.loss_chunk)
        return loss + tcfg.aux_coef * aux, {"ce": loss, "aux": aux}

    return loss_fn


def make_train_step(model, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, err_fb, batch) -> (params,
    opt_state, err_fb, metrics), ``metrics`` holding ``loss``, ``ce``,
    ``aux``, ``grad_norm`` and ``lr`` (0-d tensors). ``params`` (the
    model's module) is updated in place and returned; its parameters take
    gradients from the first call on."""
    loss_fn = make_loss_fn(model, tcfg)

    def grad_fn(params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], dict]:
        for p in params.parameters():
            p.requires_grad_(True)
            p.grad = None
        loss, metrics = loss_fn(params, batch)
        loss.backward()
        grads = bridge.grads_tree(params)
        for p in params.parameters():
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state: AdamWState, err_fb, batch):
        if tcfg.grad_accum > 1:
            # microbatches along the leading batch axis, the gradients summed
            # in f32 and divided once, as the JAX scan does
            n = tcfg.grad_accum
            parts = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
            grads = loss = None
            mets = []
            for i in range(n):
                l, met, g = grad_fn(params, {k: v[i] for k, v in parts.items()})
                grads = tree_map(lambda x: x.float(), g) if grads is None else tree_map(
                    torch.add, grads, g)
                loss = l if loss is None else loss + l
                mets.append(met)
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
            metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        else:
            loss, metrics, grads = grad_fn(params, batch)

        if tcfg.compress_grads:
            grads, err_fb = compress_grads_int8(grads, err_fb)
        master, opt_state, opt_metrics = adamw_update(grads, opt_state, tcfg.optimizer)
        del grads
        bridge.load_params_(params, master)  # cast_like(params, master), in place
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return params, opt_state, err_fb, metrics

    return train_step
