"""Mamba2 (SSD, state-space duality): the ssm family (mamba2-370m).

The port of ``repro.models.mamba2``. Prefill runs the chunked SSD scan over
the whole prompt (``kernels/ops.ssd_scan``: the Hopper kernel
``kernels/csrc/ssd_scan.cu`` on CUDA, its plain version on the CPU); the
verify step runs the O(1) recurrence token by token. Training runs
``forward``, the cache-free form: every layer's scan over the whole
sequence from a zero state, with a gradient (on CUDA the scan's backward
kernels of the same source), each layer optionally recomputed in the
backward (``remat``).

SSM and conv states cannot be rolled back by masking as a KV cache can, so
``decode_forward`` emits a state CHECKPOINT after each of the K+1 fed tokens
and ``select_checkpoint`` commits the one at the acceptance boundary. The
checkpoints are stored in bf16 and widened back to f32 on commit, as the
JAX package does: a committed state after a verify is bf16-rounded.

Under a mesh (``ctx``, ``sharding.policy``: the SSD weights replicated,
the embedding and head vocabulary-parallel where the vocabulary splits,
the ``ssm`` state split by head over the model axis where the heads
split) every rank runs its rows: the norm, ``in_proj`` and the causal
conv in full (the ``conv`` window whole on each rank), the scan or the
recurrence over its heads ``[r H/tp, (r+1) H/tp)`` from its piece of the
state, then y's head columns gathered exactly (``gather_columns``) for
``+ D x``, the gated norm over all of ``d_inner`` and ``out_proj``, as one
rank runs them. Only the scan sees fewer heads; where the heads do not
split every rank runs them all.

The weights live in a ``Mamba2`` module whose per-layer names match the JAX
package's ``init_ssd_layer`` (``norm, in_proj, conv_w, conv_b, A_log, D,
dt_bias, gnorm, out_proj``), in its layouts. Each op rounds where the JAX
serving path does: the depthwise causal conv is a bf16 sum of shifted
products in a fixed order (not ``conv1d``), ``silu`` and ``softplus`` are
taken in f32 one op at a time.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.transformer import CausalLM, lm_head  # noqa: F401 - the family's head


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state  # x, B, C share the causal conv


class SSDLayer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        d, di, H, N, cw = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.conv_width
        f32 = torch.float32
        self.norm = L.RMSNorm(d, device=device)
        self.in_proj = L._weight(d, 2 * di + 2 * N + H, device=device)  # z, x, B, C, dt
        self.conv_w = L._weight(cw, conv_dim(cfg), device=device)
        self.conv_b = L._weight(conv_dim(cfg), device=device)
        self.A_log = L._weight(H, device=device, dtype=f32)
        self.D = L._weight(H, device=device, dtype=f32)
        self.dt_bias = L._weight(H, device=device, dtype=f32)
        self.gnorm = L._weight(di, device=device, dtype=f32)
        self.out_proj = L._weight(di, d, device=device)


class Mamba2(CausalLM):
    """Weights of one pure-SSM model: the shared embedding, norm and head,
    and the per-layer SSD blocks."""

    def __init__(self, cfg, device=None):
        if cfg.family != "ssm":
            raise ValueError(f"Mamba2 holds the ssm family, not {cfg.family!r}")
        super().__init__(cfg, device=device)
        self.layers = nn.ModuleList(SSDLayer(cfg, device=device) for _ in range(cfg.num_layers))


def _split_in_proj(cfg, zxbcdt: torch.Tensor):
    di, N = cfg.d_inner, cfg.ssm_state
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N], zxbcdt[..., 2 * di + 2 * N:]


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, u: (B, S, C), w: (cw, C): the JAX package's sum
    of shifted products, rounded to u's dtype after each product and add."""
    cw = w.shape[0]
    up = torch.nn.functional.pad(u, (0, 0, cw - 1, 0))
    S = u.shape[1]
    y = sum(up[:, i:i + S] * w[i][None, None] for i in range(cw))
    return y + b[None, None]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` (logaddexp(x, 0)) evaluates it."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _gated_out(lp: SSDLayer, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Mamba2 RMSNormGated + out_proj. y (f32), z: (B, S, di)."""
    y = L.rmsnorm(y * L.silu(z.float()).to(y.dtype), lp.gnorm)
    return y.to(torch.bfloat16) @ lp.out_proj


def _ssm_inputs(cfg, lp: SSDLayer, x: torch.Tensor, conv0: Optional[torch.Tensor]):
    """Norm, in_proj, causal conv (over ``conv0`` then the fresh rows) and
    the scan's inputs: (z, x_ssm bf16, B, C, dt f32, A, full conv input).

    With quantized weights ``dt_bias``, ``A_log``, ``D`` and ``gnorm`` are
    bf16, as the JAX package's ``dequantize_pytree`` leaves them, and each op
    promotes as the JAX expression does: ``dt + dt_bias`` and ``dt * A`` in
    f32, ``A = -exp(A_log)`` in bf16, the norms widening their scales."""
    B, S, _ = x.shape
    cw, di, N = cfg.conv_width, cfg.d_inner, cfg.ssm_state
    zxbcdt = L.apply_norm(x, lp.norm, cfg.norm) @ lp.in_proj
    z, xBC, dt = _split_in_proj(cfg, zxbcdt)
    if conv0 is not None:
        full = torch.cat([conv0.to(xBC.dtype), xBC], dim=1)
        conv_out = _causal_conv(full, lp.conv_w, lp.conv_b)[:, cw - 1:]
    else:
        full = xBC
        conv_out = _causal_conv(xBC, lp.conv_w, lp.conv_b)
    xBC = L.silu(conv_out.float()).to(torch.bfloat16)
    x_ssm = xBC[..., :di].reshape(B, S, cfg.ssm_heads, cfg.ssm_head_dim)
    dt = softplus(dt.float() + lp.dt_bias[None, None])
    return z, x_ssm, xBC[..., di:di + N], xBC[..., di + N:], dt, -torch.exp(lp.A_log), full


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain chunked SSD (the JAX package's ``ssd_chunked``): returns
    (y (B, S, H, P), final state (B, H, P, N)) for any S."""
    return ref.ssd_scan_ref(x, dt, A, Bm, Cm, h0, chunk=chunk)


def ssd_heads(cfg, ctx: L.MeshContext) -> Optional[slice]:
    """This rank's SSD heads under a mesh whose model axis splits them (the
    policy's ``ssm`` layout); None: every head."""
    H, tp = cfg.ssm_heads, ctx.tp
    if not ctx.sharded or H % tp:
        return None
    r = ctx.model_rank
    return slice(r * H // tp, (r + 1) * H // tp)


def _gather_heads(y: torch.Tensor, heads: Optional[slice], ctx: L.MeshContext) -> torch.Tensor:
    """(B, S, H_local, P) per-head outputs -> every head's, in head order."""
    if heads is None:
        return y
    B, S, _, P = y.shape
    return C.gather_columns(y.reshape(B, S, -1), ctx).reshape(B, S, -1, P)


def ssd_layer_forward(cfg, lp: SSDLayer, x: torch.Tensor, *, chunk: Optional[int] = None,
                      h0: Optional[torch.Tensor] = None, conv0: Optional[torch.Tensor] = None,
                      return_state: bool = False, ctx: L.MeshContext = L.NO_MESH):
    """Full-sequence SSD block, x: (B, S, d) -> (B, S, d); the scan is the
    Hopper kernel on CUDA and ``ssd_chunked`` on the CPU. Under a mesh the
    scan runs over this rank's heads (``ssd_heads``) from ``h0``, its piece
    of the state, and returns the final state of those heads."""
    B, S, _ = x.shape
    cw = cfg.conv_width
    z, x_ssm, Bm, Cm, dt, A, full = _ssm_inputs(cfg, lp, x, conv0)
    # A is bf16 where the weights were quantized (A_log is bf16 then); the
    # JAX scan widens it in ``dt * A`` and the kernel takes it in f32: the
    # same values
    xs, dts, As = x_ssm, dt, A.float()
    heads = ssd_heads(cfg, ctx)
    if heads is not None:  # the kernel takes dt contiguous, x with its heads adjacent
        xs, dts, As = x_ssm[:, :, heads], dt[..., heads].contiguous(), As[heads]
    y, h = ops.ssd_scan(xs, dts, As, Bm, Cm, h0, chunk=chunk or cfg.ssm_chunk)
    y = _gather_heads(y, heads, ctx).float() + lp.D[None, None, :, None] * x_ssm.float()
    out = x + _gated_out(lp, y.reshape(B, S, cfg.d_inner), z)
    if return_state:
        return out, (h, full[:, -(cw - 1):])
    return out


def ssd_layer_decode(cfg, lp: SSDLayer, x: torch.Tensor, h0: torch.Tensor, conv0: torch.Tensor,
                     ctx: L.MeshContext = L.NO_MESH):
    """Sequential decode over K tokens, emitting per-position checkpoints.

    Returns (out (B, K, d), h_ckpts (B, K, H, P, N) bf16, conv_ckpts
    (B, K, cw-1, C)); ``h_ckpts[:, i]`` is the state after token i. Under
    a mesh the recurrence runs over this rank's heads from ``h0``, its
    piece of the state: the checkpoints are (B, K, H/tp, P, N)."""
    B, K, _ = x.shape
    cw = cfg.conv_width
    z, x_ssm, Bm, Cm, dt, A, full = _ssm_inputs(cfg, lp, x, conv0)
    # the cw-1 conv inputs ending at each position
    idx = torch.arange(K, device=x.device)[:, None] + torch.arange(1, cw, device=x.device)[None]
    conv_ckpts = full[:, idx]
    xs_all = x_ssm.float()
    xs, Bf, Cf = xs_all, Bm.float(), Cm.float()
    heads = ssd_heads(cfg, ctx)
    if heads is not None:
        xs, dt, A = xs[:, :, heads], dt[..., heads], A[heads]
    h = h0.float()
    ys, hs = [], []
    for t in range(K):
        dtt = dt[:, t]  # (B, H)
        decay = torch.exp(dtt * A[None])
        # dt * B first, then * x: the pairing of the JAX path's einsum
        update = (dtt[..., None] * Bf[:, t, None, :])[:, :, None, :] * xs[:, t, ..., None]
        h = decay[..., None, None] * h + update
        # C . h over N as a product and a sum over the last dim, whose order
        # is set by N alone: a batched einsum's kernel depends on the shape,
        # so a mesh rank's heads would not keep one rank's bits
        ys.append((h * Cf[:, t, None, None, :]).sum(-1))
        hs.append(h.to(torch.bfloat16))
    y = _gather_heads(torch.stack(ys, dim=1), heads, ctx) + lp.D[None, None, :, None] * xs_all
    out = x + _gated_out(lp, y.reshape(B, K, cfg.d_inner), z)
    return out, torch.stack(hs, dim=1), conv_ckpts


def train_layer(cfg, lp: SSDLayer, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """One SSD layer of the training forward, recomputed in the backward
    with ``remat`` (``torch.utils.checkpoint``, as JAX checkpoints its scan
    body): its scan then runs twice."""
    if remat:
        return torch.utils.checkpoint.checkpoint(functools.partial(ssd_layer_forward, cfg, lp), x,
                                                 use_reentrant=False)
    return ssd_layer_forward(cfg, lp, x)


def forward(cfg, params: Mamba2, tokens: torch.Tensor, *, remat: bool = False,
            **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache-free training forward (the JAX ``forward``): (hidden
    (B, S, d) after the final norm, a zero aux loss). The embedding lookup
    is ``F.embedding``, as ``transformer.forward``'s. Use
    ``transformer.train_lm_head`` for the logits."""
    x = torch.nn.functional.embedding(tokens.long(), params.embed)
    for lp in params.layers:
        x = train_layer(cfg, lp, x, remat)
    return (L.apply_norm(x, params.final_norm, cfg.norm),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_params(cfg, generator: torch.Generator) -> Mamba2:
    """Seeded random weights with the JAX package's distributions (the draws
    differ from ``jax.random``'s; tests bridge JAX weights in instead)."""
    dev = generator.device
    model = Mamba2(cfg, device=dev)
    with torch.no_grad():
        model.embed.copy_(torch.randn(model.embed.shape, generator=generator, device=dev) * 0.02)
        for lp in model.layers:
            init_ssd_layer_(lp, cfg, generator)
        if model.lm_head_w is not None:
            model.lm_head_w.copy_(
                torch.randn(model.lm_head_w.shape, generator=generator, device=dev) * 0.02)
    return model


def init_ssd_layer_(lp: SSDLayer, cfg, generator: torch.Generator) -> None:
    """One SSD layer's seeded init, in place (the ssm and hybrid families)."""
    dev = generator.device
    std, out_std = 0.02, 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))

    def normal(w, s):
        w.copy_(torch.randn(w.shape, generator=generator, device=dev) * s)

    normal(lp.in_proj, std)
    normal(lp.conv_w, 0.2)
    lp.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, cfg.ssm_heads, device=dev)))
    lp.D.fill_(1.0)
    lp.dt_bias.fill_(math.log(math.expm1(0.01)))
    lp.gnorm.fill_(1.0)
    normal(lp.out_proj, out_std)


def make_cache(cfg, batch: int, max_len: int = 0, *, device, kv_dtype: str = "bf16",
               **_) -> Dict[str, torch.Tensor]:
    """SSM cache, O(1) in sequence length (``max_len`` is ignored): the f32
    state ``ssm`` (L, B, H, P, N), the bf16 conv window ``conv``
    (L, B, cw-1, C) and ``length``. It has no quantized layout."""
    if kv_dtype != "bf16":
        raise ValueError(f"the ssm family's cache has no {kv_dtype!r} layout")
    H, N, Pd, cw = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.conv_width
    return {
        "ssm": torch.zeros((cfg.num_layers, batch, H, Pd, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.num_layers, batch, cw - 1, conv_dim(cfg)), dtype=torch.bfloat16,
                            device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(cfg, params: Mamba2, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
            ctx: L.MeshContext = L.NO_MESH, **_):
    """Run the prompt through every layer's scan; returns (last-position
    logits, cache with the final states). Under a mesh, this rank's rows,
    pieces and heads."""
    L.check_mesh(cfg, ctx)
    x = L.embed_lookup(params.embed, tokens, ctx, cfg.vocab_size)
    hs, convs = [], []
    for li, lp in enumerate(params.layers):
        x, (h, conv) = ssd_layer_forward(cfg, lp, x, h0=cache["ssm"][li], conv0=cache["conv"][li],
                                         return_state=True, ctx=ctx)
        hs.append(h)
        convs.append(conv.to(torch.bfloat16))
    last = L.apply_norm(x[:, -1:], params.final_norm, cfg.norm)
    new_cache = {"ssm": torch.stack(hs), "conv": torch.stack(convs),
                 "length": cache["length"] + tokens.shape[1]}
    return lm_head(params, last, ctx)[:, 0], new_cache


def decode_forward(cfg, params: Mamba2, cache: Dict[str, torch.Tensor], tokens: torch.Tensor, *,
                   slots: Optional[torch.Tensor] = None, ctx: L.MeshContext = L.NO_MESH, **_):
    """Verify-style decode of K tokens with per-position state checkpoints.

    Returns (hidden (B, K, d), cache with ``ssm_ckpt`` (L, B, K, H, P, N)
    and ``conv_ckpt`` (L, B, K, cw-1, C)); commit with ``select_checkpoint``.
    A pool cannot be addressed in place (``slots``): the recurrent state is
    not position-indexed, so the engine gathers rows first. Under a mesh,
    this rank's rows, pieces and heads."""
    L.check_mesh(cfg, ctx, slots)
    if slots is not None:
        raise ValueError("the ssm family has no slot-indexed forward: gather the pool rows "
                         "(kvcache.gather_slots) and run the dense forward")
    x = L.embed_lookup(params.embed, tokens, ctx, cfg.vocab_size)
    h_cks, c_cks = [], []
    for li, lp in enumerate(params.layers):
        x, h_ck, c_ck = ssd_layer_decode(cfg, lp, x, cache["ssm"][li], cache["conv"][li], ctx)
        h_cks.append(h_ck)
        c_cks.append(c_ck)
    x = L.apply_norm(x, params.final_norm, cfg.norm)
    return x, {**cache, "ssm_ckpt": torch.stack(h_cks), "conv_ckpt": torch.stack(c_cks)}


def select_checkpoint(cache: Dict[str, torch.Tensor],
                      n_commit: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Commit the state after ``n_commit`` tokens per row (n_commit >= 1:
    the first fed token is the previously committed one). Indices are
    clamped to the checkpoints there are, as the JAX gather clamps them."""
    ck = cache["ssm_ckpt"]
    B, K = ck.shape[1], ck.shape[2]
    i = torch.clamp(n_commit.to(ck.device, torch.int64) - 1, 0, K - 1)
    b = torch.arange(B, device=ck.device)
    return {
        "ssm": ck[:, b, i].float(),
        "conv": cache["conv_ckpt"][:, b, i],
        "length": cache["length"] + n_commit.to(torch.int32),
    }
