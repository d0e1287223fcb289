"""Transformer layers: norms, RoPE, verification attention, MLP, MoE.

The port of ``repro.models.layers`` for the dense, vlm, moe and encdec
families (and the hybrid family's shared block). The modules hold their
weights in the JAX package's ``(in, out)`` layout and run them as
``x @ w``, so bridged weights need no transpose. Each op rounds to bf16
where the JAX serving path does (f32 inside the norms and RoPE; bf16 after
each projection), so the CPU path follows the XLA path to within summation
order.

Attention runs against a cache whose buffer index is the absolute position.
Every self-attention call of a decoder has the verification kernels'
semantics: query i of S fresh tokens sits at ``kv_valid - S + i`` with
``kv_valid = cache_len + S``. The encdec family adds two non-causal forms
(``causal=False``: every query sees every position below ``kv_valid``):
the encoder's cache-free self-attention (``Attention.fresh``) and the
decoder's cross-attention over the ``cross_k``/``cross_v`` cache leaves
(``Attention.cross``). ``flash_attention`` dispatches on the device: CUDA
tensors run the Hopper kernels (``kernels/csrc/verify_attn.cu``), CPU
tensors their plain versions.

Training (``transformer.forward``) runs the cache-free forms with a
gradient: ``Attention.fresh`` (causal over the fresh K/V, or not for the
encoder), ``Attention.cross_fresh`` (K/V projected afresh from the encoder
output) and ``moe_block_train``. Their attention goes through
``ops.attention``, whose backward on the card is
``kernels/csrc/attn_bwd.cu``. The parameters are built without gradients;
a trainer turns them on for its own model only.

An int8 cache (``kv_dtype="int8"``) stores K/V with a symmetric scale per
(layer, row, KV head), fixed at the first append into an empty row: that
append derives it from the fresh rows' absolute maximum, every later append
reuses it, so replayed appends quantize bit-identically however they are
grouped. Attention reads the int8 rows and dequantizes them chunk by chunk.

The moe family's ``moe_block`` is the JAX package's capacity-based dispatch
without a mesh: each expert takes at most ``moe_capacity(T, cfg)`` of the
call's T tokens, the first in the flattened batch winning, and drops the
rest, so a row's output depends on the other rows of its call, as in JAX.

Under a mesh (``MeshContext``, from ``sharding.policy.Policy.ctx``) each
rank runs its own rows with its pieces of the weights (the policy's specs,
``sharding.policy.shard_params``), and the layers combine over the model
axis with ``all_reduce`` (``distributed/collectives.py``): the embedding
vocabulary-parallel (each rank looks up its range, zeros elsewhere, then a
sum), attention on the rank's heads, or, with ``seq_shard_kv``, on every
head over the rank's sequence shard of the cache (``sp_append_attend``;
the sharded projections' outputs gathered first), ``wo`` and the MLP's
``wd`` row-parallel (f32 partial products summed, rounded once), and
``moe_block`` expert-parallel or tensor-parallel inside each expert as the
JAX branch is. The encdec family's encoder attention and cross-attention
take the same forms: the rank's heads, or every head where the KV heads
do not split (the cross leaves then whole on every rank). Which pieces a
rank holds is read off the weights' and the cache's shapes.
Without a mesh (``NO_MESH``) every path is the single-device one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops

KV_SCALE = 0.05  # static scale for a caller that passes none
KV_SCALE_EPS = 1e-6  # floor for amax / 127, so an all-zero row stays invertible


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """How a layer shards itself under a mesh (the JAX ``MeshContext``).

    ``mesh=None`` means single-device math. ``batch_axes`` are the mesh
    axes carrying the batch, ``model_axis`` carries tensor and expert
    parallelism, ``seq_shard_kv`` switches attention caches to sequence
    shards over the model axis (the flash-decoding combine of
    ``distributed/collectives.py``). ``fsdp`` marks a train-mode layout,
    which the serving path does not run."""

    mesh: Any = None
    batch_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    fsdp: bool = False
    seq_shard_kv: bool = False

    @property
    def tp(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]

    @property
    def n_batch_shards(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.mesh.shape[a] if self.mesh is not None else 1
        return n

    def bspec(self, batch_size: int):
        """Batch-dim axes, or None when the batch can't shard evenly."""
        if self.batch_axes and batch_size % self.n_batch_shards == 0:
            return self.batch_axes
        return None

    @property
    def sharded(self) -> bool:
        """Whether a layer must combine across the model axis."""
        return self.mesh is not None and (self.tp > 1 or self.seq_shard_kv)

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on the model axis (0 without a mesh)."""
        if self.mesh is None or self.model_axis is None:
            return 0
        return self.mesh.coords[self.model_axis]

    @property
    def model_group(self):
        return self.mesh.group(self.model_axis)


NO_MESH = MeshContext()


def check_mesh(cfg, ctx: MeshContext, slots=None) -> None:
    """What a sharded mesh serves: every family's prefill and verify over a
    dense cache in the serve layout. A slot pool or a train-mode (FSDP)
    layout raises rather than run unsharded in silence."""
    if not ctx.sharded:
        return
    if ctx.fsdp:
        raise NotImplementedError(f"{cfg.name}: a train-mode (FSDP) layout does not serve "
                                  "(ROADMAP.md Queue A: train-mode FSDP/ZeRO execution)")
    if slots is not None:
        raise NotImplementedError("slot-pool caches are not served under a mesh: the paged "
                                  "engine, System and the cluster stay single-rank")


def _bc(scale: torch.Tensor) -> torch.Tensor:
    """(B, Hkv) scales broadcast against a (B, S, Hkv, D) K/V tile."""
    return scale[:, None, :, None]


def kv_quant(x: torch.Tensor, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K/V -> int8: f32 divide, round half to even, clip to +-127."""
    s = KV_SCALE if scale is None else _bc(scale)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def kv_dequant(x: torch.Tensor, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 -> bf16 as ``(x -> f32 * scale) -> bf16``; other dtypes pass through."""
    if x.dtype != torch.int8:
        return x
    s = KV_SCALE if scale is None else _bc(scale)
    return (x.float() * s).to(torch.bfloat16)


def kv_fresh_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-(row, KV head) symmetric scale of a fresh (B, S, Hkv, D) tile."""
    amax = x.float().abs().amax(dim=(1, 3))
    return torch.clamp(amax / 127.0, min=KV_SCALE_EPS)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """The JAX package's rounding points: f32 mean, the variance of x - mu,
    rsqrt(var + eps), scale and bias in f32, one cast back."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def apply_norm(x: torch.Tensor, norm: "RMSNorm", kind: str) -> torch.Tensor:
    """``rmsnorm`` for ``kind="rmsnorm"``, else ``layernorm`` (as in JAX)."""
    if kind == "rmsnorm":
        return rmsnorm(x, norm.scale)
    return layernorm(x, norm.scale, norm.bias)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, ctx: MeshContext = NO_MESH,
                 vocab_size: int = 0) -> torch.Tensor:
    """Rows ``tokens`` of the table. Under a mesh whose rank holds a
    vocabulary range of a ``vocab_size`` table, the range's rows (zeros for
    other tokens) summed over the model axis: exact, one nonzero term."""
    if ctx.tp == 1 or embed.shape[0] == vocab_size or not vocab_size:
        return embed[tokens]
    v_loc = embed.shape[0]
    rel = tokens.long() - ctx.model_rank * v_loc
    ok = (rel >= 0) & (rel < v_loc)
    rows = embed[rel.clamp(0, v_loc - 1)]
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return C.all_reduce(rows, ctx).to(embed.dtype)


def row_parallel(h: torch.Tensor, w: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """``h @ w`` for a weight whose input rows are split over the model
    axis (``h`` the matching columns): each rank's f32 partial product,
    summed over the axis and rounded to bf16 once."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if h2.is_cuda:
        part = torch.mm(h2, w, out_dtype=torch.float32)
    else:  # the CPU build has no bf16 x bf16 -> f32 product: widen (exactly)
        part = h2.float() @ w.float()
    return C.all_reduce(part, ctx).to(h.dtype).reshape(*lead, w.shape[1])


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated at ``positions`` (..., S); angles in f32."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def flash_attention(
    q: torch.Tensor,         # (B, Sq, Hq, D)
    k: torch.Tensor,         # stacked (L, rows, Skv, Hkv, D); (rows, Skv, Hkv, D) without layer
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # (B,) int32, incl. the Sq fresh rows
    *,
    layer: Optional[int],
    chunk: int,
    slots: Optional[torch.Tensor] = None,  # (B,) pool rows; None: row b
    k_scale: Optional[torch.Tensor] = None,  # int8 cache: stacked (L, rows, Hkv) f32
    v_scale: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Verification attention over layer ``layer`` of the stacked cache (or
    over ``k``/``v`` themselves when ``layer`` is None); ``causal=False``
    lets every query see every position below its ``kv_valid``.

    ``chunk`` is the model's ``attn_chunk``: the plain (CPU) version walks the
    cache in chunks of that size, as the JAX package's XLA path does, so the
    two agree to within summation order."""
    kw = dict(layer=layer, block_k=chunk, k_scale=k_scale, v_scale=v_scale, causal=causal)
    if slots is not None:
        return ops.verify_attention_paged(q, k, v, slots, kv_valid, **kw)
    return ops.verify_attention(q, k, v, kv_valid, **kw)


@dataclasses.dataclass
class CacheWrite:
    """Where a forward's fresh K/V rows land in the stacked cache.

    Computed once per forward and reused by every layer: entry n of the
    flattened (B * S) fresh rows (or fresh row ``src[n]``) goes to cache row
    ``rows[n]``, position ``pos[n]``.
    """

    rows: torch.Tensor
    pos: torch.Tensor
    src: Optional[torch.Tensor] = None

    @classmethod
    def dense(cls, cache_len: torch.Tensor, S: int, s_max: int) -> "CacheWrite":
        """Row b appends at ``cache_len[b] + arange(S)``. Positions past the
        buffer are dropped, as the JAX path's ``mode="drop"`` scatter does
        (only a row that already finished its budget gets there, in the
        lock-step loop); finding them costs one device sync per forward."""
        B = cache_len.shape[0]
        dev = cache_len.device
        rows = torch.arange(B, device=dev).repeat_interleave(S)
        pos = (cache_len.long()[:, None] + torch.arange(S, device=dev)[None]).reshape(-1)
        keep = pos < s_max
        if bool(keep.all()):
            return cls(rows, pos)
        src = keep.nonzero().squeeze(1)
        return cls(rows[src], pos[src], src)

    @classmethod
    def slots(cls, cache_len: torch.Tensor, slots: torch.Tensor, S: int, s_max: int) -> "CacheWrite":
        """Batch row b appends its S rows into pool row ``slots[b]``. The
        start is clamped to ``s_max - S`` as JAX's ``dynamic_update_slice``
        clamps it; the engine keeps ``max_len >= committed + S`` so the clamp
        never fires there.

        Padding rows all point at the scratch slot, so their writes collide
        and no winner is defined on CUDA. That cannot reach a committed
        token: a padding row's outputs are discarded, the scratch row's
        length is reset to 0 after every step, and a later padding row reads
        only the positions its own step wrote. Real rows own distinct slots.
        """
        dev = cache_len.device
        start = torch.clamp(cache_len.long(), 0, s_max - S)
        rows = slots.long().repeat_interleave(S)
        pos = (start[:, None] + torch.arange(S, device=dev)[None]).reshape(-1)
        return cls(rows, pos)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device),
                                  requires_grad=False)
        self.register_parameter("bias", None)  # a layernorm's (LayerNorm)


class LayerNorm(RMSNorm):
    """The layernorm's f32 ``scale`` (ones) and ``bias`` (zeros)."""

    def __init__(self, d: int, device=None):
        super().__init__(d, device=device)
        self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device),
                                 requires_grad=False)


def make_norm(cfg, device=None) -> RMSNorm:
    """The norm ``cfg.norm`` names: RMSNorm for ``"rmsnorm"``, else LayerNorm."""
    return (RMSNorm if cfg.norm == "rmsnorm" else LayerNorm)(cfg.d_model, device=device)


def _weight(*shape, device=None, dtype=torch.bfloat16) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, dtype=dtype, device=device), requires_grad=False)


class Attention(nn.Module):
    """QKV -> RoPE -> cache append -> verification attention -> out proj."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        self.cfg = cfg
        self.wq = _weight(d, hq * hd, device=device)
        self.wk = _weight(d, hkv * hd, device=device)
        self.wv = _weight(d, hkv * hd, device=device)
        self.wo = _weight(hq * hd, d, device=device)
        if cfg.qkv_bias:
            self.bq = _weight(hq * hd, device=device)
            self.bk = _weight(hkv * hd, device=device)
            self.bv = _weight(hkv * hd, device=device)
        else:
            self.bq = self.bk = self.bv = None

    def forward(
        self,
        x: torch.Tensor,          # (B, S, d)
        positions: torch.Tensor,  # (B, S)
        cache_k: torch.Tensor,    # stacked (L, rows, S_max, Hkv, D), written in place
        cache_v: torch.Tensor,
        kv_valid: torch.Tensor,   # (B,) cache_len + S
        write: CacheWrite,
        *,
        layer: int,
        chunk: int,
        slots: Optional[torch.Tensor] = None,
        k_scale: Optional[torch.Tensor] = None,  # int8 cache: (L, rows, Hkv), in place
        v_scale: Optional[torch.Tensor] = None,
        ctx: MeshContext = NO_MESH,
        start: Optional[int] = None,  # seq_shard_kv: every row's insert position
    ) -> torch.Tensor:
        if ctx.sharded:
            return self._forward_mesh(x, positions, cache_k, cache_v, kv_valid, write,
                                      layer=layer, chunk=chunk, ctx=ctx, start=start)
        B, S, _ = x.shape
        hkv, hd = self.cfg.num_kv_heads, self.cfg.head_dim
        q, k, v = self._qkv(x, positions)
        # the cache is updated in place (JAX returned a new buffer): only the
        # B * S fresh rows are written, and stale rows past a row's committed
        # length are masked by kv_valid, so rollback stays a length change
        if cache_k.dtype == torch.int8:
            k, v = self._quantize_append(k, v, kv_valid - S, k_scale, v_scale, layer, slots)
        kf = k.reshape(B * S, hkv, hd)
        vf = v.reshape(B * S, hkv, hd)
        if write.src is not None:
            kf, vf = kf[write.src], vf[write.src]
        cache_k[layer].index_put_((write.rows, write.pos), kf)
        cache_v[layer].index_put_((write.rows, write.pos), vf)
        out = flash_attention(q, cache_k, cache_v, kv_valid, layer=layer, chunk=chunk, slots=slots,
                              k_scale=k_scale, v_scale=v_scale)
        return self._out(out)

    def _forward_mesh(self, x, positions, cache_k, cache_v, kv_valid, write, *, layer, chunk,
                      ctx, start):
        """The layer on this rank's pieces (``_qkv``): with ``seq_shard_kv``
        every query and KV head against this rank's sequence shard of the
        cache, otherwise the rank's query heads against its KV heads of the
        cache; then ``_out``."""
        S = x.shape[1]
        q, k, v = self._qkv(x, positions, ctx)
        if ctx.seq_shard_kv:
            out, _, _ = C.sp_append_attend(q, cache_k, cache_v, k, v, kv_valid - S, start, ctx,
                                           chunk=chunk, layer=layer)
        else:
            if cache_k.dtype == torch.int8:
                raise NotImplementedError("an int8 cache under a mesh (ROADMAP.md Queue A)")
            kf, vf = k.reshape(-1, *k.shape[2:]), v.reshape(-1, *v.shape[2:])
            if write.src is not None:
                kf, vf = kf[write.src], vf[write.src]
            cache_k[layer].index_put_((write.rows, write.pos), kf)
            cache_v[layer].index_put_((write.rows, write.pos), vf)
            out = flash_attention(q, cache_k, cache_v, kv_valid, layer=layer, chunk=chunk)
        return self._out(out, ctx)

    def _query(self, x: torch.Tensor, ctx: MeshContext = NO_MESH,
               whole: bool = False) -> torch.Tensor:
        """q (B, S, heads, D) = x wq + bq on this rank's columns of ``wq``
        (every head on one device), or with ``whole`` every head (a sharded
        projection's columns gathered)."""
        q = x @ self.wq
        if self.bq is not None:
            q = q + self.bq
        if whole:
            q = self._whole(q, self.cfg.num_heads, ctx)
        return q.reshape(x.shape[0], x.shape[1], -1, self.cfg.head_dim)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor, ctx: MeshContext = NO_MESH):
        """q, k, v (B, S, heads, D) of x on this rank's pieces of the
        projections (all of them on one device), biased and, with RoPE,
        rotated at ``positions``: the rank's heads (the policy shards query
        and KV heads both or neither), or with ``seq_shard_kv`` every head
        (the JAX package's q is replicated over the model axis there)."""
        cfg = self.cfg
        B, S, _ = x.shape
        q = self._query(x, ctx, whole=ctx.seq_shard_kv)
        k, v = x @ self.wk, x @ self.wv
        if self.bk is not None:
            k, v = k + self.bk, v + self.bv
        if ctx.seq_shard_kv:
            k, v = self._whole(k, cfg.num_kv_heads, ctx), self._whole(v, cfg.num_kv_heads, ctx)
        elif (q.shape[2] == cfg.num_heads) != (k.shape[-1] == cfg.num_kv_heads * cfg.head_dim):
            raise NotImplementedError(
                f"{cfg.name}: query heads and KV heads sharded unlike (a train-mode layout; "
                "ROADMAP.md Queue A: train-mode FSDP/ZeRO execution)")
        k, v = k.reshape(B, S, -1, cfg.head_dim), v.reshape(B, S, -1, cfg.head_dim)
        if cfg.use_rope:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _whole(self, t: torch.Tensor, heads: int, ctx: MeshContext) -> torch.Tensor:
        """Every one of ``heads`` heads' columns of a projection's output,
        gathered over the model axis where this rank holds a piece of them."""
        if t.shape[-1] != heads * self.cfg.head_dim:
            return C.gather_columns(t, ctx)
        return t

    def _out(self, out: torch.Tensor, ctx: MeshContext = NO_MESH) -> torch.Tensor:
        """``wo`` of an attention output (B, S, heads, D) on this rank: its
        head columns (sliced out where it attended every head) times its
        rows of ``wo``, row-parallel where the rows are split (on one
        device, ``out @ wo``)."""
        B, S = out.shape[:2]
        out = out.reshape(B, S, -1)
        n = self.wo.shape[0]
        if n != out.shape[-1]:
            out = out[..., ctx.model_rank * n:(ctx.model_rank + 1) * n]
        if n != self.cfg.num_heads * self.cfg.head_dim:
            return row_parallel(out, self.wo, ctx)
        return out @ self.wo

    def cross_kv(self, enc_out: torch.Tensor,
                 ctx: MeshContext = NO_MESH) -> Tuple[torch.Tensor, torch.Tensor]:
        """K and V (B, F, heads, D) of the encoder output (B, F, d), without
        ``bk``/``bv`` as the JAX package projects them: under a mesh this
        rank's KV heads where they split over the model axis (the policy's
        ``cross_k`` layout), else every head (a sharded projection's
        columns gathered)."""
        B, F, _ = enc_out.shape
        hkv = self.cfg.num_kv_heads
        k, v = enc_out @ self.wk, enc_out @ self.wv
        if hkv % ctx.tp:
            k, v = self._whole(k, hkv, ctx), self._whole(v, hkv, ctx)
        return k.reshape(B, F, -1, self.cfg.head_dim), v.reshape(B, F, -1, self.cfg.head_dim)

    def fresh(self, x: torch.Tensor, positions: torch.Tensor, *, chunk: int,
              causal: bool = True, ctx: MeshContext = NO_MESH) -> torch.Tensor:
        """The cache-free form over the fresh K/V of all S rows of x: causal
        (the training forward's self-attention, row i seeing rows <= i) or
        not (the encdec family's encoder, every row seeing all of them).
        It has a gradient: on the card the forward and backward kernels
        (``ops.attention``). Under a mesh (the encoder of a serve) the
        rank's heads, or every head where the KV heads do not split."""
        B, S, _ = x.shape
        q, k, v = self._qkv(x, positions, ctx)
        kv_valid = torch.full((B,), S, dtype=torch.int32, device=x.device)
        return self._out(ops.attention(q, k, v, kv_valid, causal=causal, block_k=chunk), ctx)

    def cross_fresh(self, x: torch.Tensor, enc_out: torch.Tensor, *, chunk: int) -> torch.Tensor:
        """The training form of cross-attention: K/V projected afresh from
        the encoder output (B, F, d) (``cross_kv``), non-causal over all F
        frames, with a gradient into the encoder."""
        B = x.shape[0]
        k, v = self.cross_kv(enc_out)
        kv_valid = torch.full((B,), enc_out.shape[1], dtype=torch.int32, device=x.device)
        return self._out(ops.attention(self._query(x), k, v, kv_valid, causal=False,
                                       block_k=chunk))

    def cross(self, x: torch.Tensor, cross_k: torch.Tensor, cross_v: torch.Tensor, *,
              layer: int, chunk: int, slots: Optional[torch.Tensor] = None,
              ctx: MeshContext = NO_MESH) -> torch.Tensor:
        """The decoder's cross-attention: q = x wq + bq (no RoPE), K/V layer
        ``layer`` of the stacked cross leaves (L, rows, F, Hkv, D), rows b or
        pool rows ``slots``, non-causal over all F frames. The leaves were
        projected without ``bk``/``bv``, as in JAX. Under a mesh the leaves
        hold this rank's KV heads (its query heads attend them) or, where
        the KV heads do not split, every head (every query head attends,
        a sharded q gathered first)."""
        B = x.shape[0]
        q = self._query(x, ctx, whole=cross_k.shape[3] == self.cfg.num_kv_heads)
        kv_valid = torch.full((B,), cross_k.shape[2], dtype=torch.int32, device=x.device)
        out = flash_attention(q, cross_k, cross_v, kv_valid, layer=layer, chunk=chunk,
                              slots=slots, causal=False)
        return self._out(out, ctx)

    @staticmethod
    def _quantize_append(k, v, cache_len, k_scale, v_scale, layer, slots):
        """int8 rows of the fresh K/V. Each row's scale is fixed at its first
        append (``cache_len == 0``: the fresh rows' own scale) and read back
        otherwise; the selected scales are written along the K/V rows'
        addressing (row b, or pool row ``slots[b]``), a rewrite of the same
        value where the scale was already fixed."""
        if k_scale is None or v_scale is None:
            raise ValueError("an int8 cache needs its k_scale and v_scale leaves")
        rows = slots.long() if slots is not None else torch.arange(k.shape[0], device=k.device)
        first = (cache_len == 0)[:, None]
        out = []
        for x, leaf in ((k, k_scale), (v, v_scale)):
            scale = torch.where(first, kv_fresh_scale(x), leaf[layer][rows])
            leaf[layer].index_put_((rows,), scale)
            out.append(kv_quant(x, scale))
        return out


class MLP(nn.Module):
    """The dense MLP: SwiGLU (``act="swiglu"``: ``wg``, ``wu``, ``wd``) or
    tanh-approximated GELU (``act="gelu"``: ``wi``, ``wd``); the tables the
    other activation uses are None."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.act not in ("swiglu", "gelu"):
            raise ValueError(f"unknown act {cfg.act!r} (swiglu or gelu)")
        d, f = cfg.d_model, cfg.d_ff
        self.wg = self.wu = self.wi = None
        if cfg.act == "swiglu":
            self.wg = _weight(d, f, device=device)
            self.wu = _weight(d, f, device=device)
        else:
            self.wi = _weight(d, f, device=device)
        self.wd = _weight(f, d, device=device)

    def forward(self, x: torch.Tensor, ctx: MeshContext = NO_MESH) -> torch.Tensor:
        return mlp_block(x, self, ctx)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as the JAX path evaluates it, one rounding per op
    (exp, +1, reciprocal, product), rather than one fused rounding."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` as XLA evaluates it on bf16: one
    rounding per op, in its order (x*x, *x, *0.044715, +x, *sqrt(2/pi),
    tanh, 1+, 0.5*, x*), with the constants rounded to x's dtype first.
    ``F.gelu(approximate="tanh")`` rounds once and gives other bf16 values."""
    c3 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    c1 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    t = torch.tanh(c1 * (x + c3 * (x * x * x)))
    return x * (0.5 * (1 + t))


def mlp_block(x: torch.Tensor, p: MLP, ctx: MeshContext = NO_MESH) -> torch.Tensor:
    """The MLP; under a mesh with a model axis ``wg``/``wu``/``wi`` are
    column pieces (the policy always splits d_ff) and ``wd`` row-parallel."""
    h = gelu(x @ p.wi) if p.wi is not None else silu(x @ p.wg) * (x @ p.wu)
    if ctx.tp > 1:
        return row_parallel(h, p.wd, ctx)
    return h @ p.wd


def init_attention_(attn: Attention, cfg, gen: torch.Generator) -> None:
    """Seeded init with the JAX package's distributions: N(0, 0.02) for the
    projections, N(0, 0.02 / sqrt(2 L)) for the output, zero biases."""
    std = 0.02
    out_std = std / math.sqrt(2 * max(cfg.num_layers, 1))
    for w, s in ((attn.wq, std), (attn.wk, std), (attn.wv, std), (attn.wo, out_std)):
        w.copy_(torch.randn(w.shape, generator=gen, device=w.device) * s)


def init_mlp_(mlp: MLP, cfg, gen: torch.Generator) -> None:
    """The JAX distributions: N(0, 0.02) for ``wg``, ``wu`` (or ``wi``),
    N(0, 0.02 / sqrt(2 L)) for ``wd``."""
    std = 0.02
    out_std = std / math.sqrt(2 * max(cfg.num_layers, 1))
    for w, s in ((mlp.wg, std), (mlp.wu, std), (mlp.wi, std), (mlp.wd, out_std)):
        if w is not None:
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device) * s)


class MoE(nn.Module):
    """Top-K routed SwiGLU experts: an f32 ``router`` (d, E) and the bf16
    expert tables ``wg``, ``wu`` (E, d, f) and ``wd`` (E, f, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
        self.router = _weight(d, e, device=device, dtype=torch.float32)
        self.wg = _weight(e, d, f, device=device)
        self.wu = _weight(e, d, f, device=device)
        self.wd = _weight(e, f, d, device=device)


def init_moe_(moe: MoE, cfg, gen: torch.Generator) -> None:
    """The JAX distributions: N(0, 0.02) for the router and ``wg``/``wu``,
    N(0, 0.02 / sqrt(2 L)) for ``wd``."""
    std = 0.02
    out_std = std / math.sqrt(2 * max(cfg.num_layers, 1))
    for w, s in ((moe.router, std), (moe.wg, std), (moe.wu, std), (moe.wd, out_std)):
        w.copy_(torch.randn(w.shape, generator=gen, device=w.device) * s)


def moe_capacity(tokens: int, cfg) -> int:
    """Slots per expert for a call of ``tokens`` tokens: the mean load times
    ``capacity_factor``, rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(tokens * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


# per device: int64 (assignments, dropped) over every moe_block call since
# the last reset_moe_tally(), accumulated on the device (no host sync)
_MOE_TALLY: Dict[torch.device, torch.Tensor] = {}


def moe_tally(device) -> torch.Tensor:
    """The device's running (assignments, dropped) counts (``"cuda"``: the
    current card's)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _MOE_TALLY:
        _MOE_TALLY[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return _MOE_TALLY[device]


def reset_moe_tally() -> None:
    for tally in _MOE_TALLY.values():
        tally.zero_()


def _top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest gates per row as ``jax.lax.top_k`` picks them: among
    equal gates the lower expert index first (a stable descending sort)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _expert_products(a: torch.Tensor, w: torch.Tensor, widen: bool = False) -> torch.Tensor:
    """(E, C, i) x (E, i, o) bf16 operands, f32 products and sums, as JAX's
    einsum with ``preferred_element_type=f32``. The CPU build has no bf16 x
    bf16 -> f32 product and widens both operands (exactly); on the card the
    expert tables are read as they are, unless ``widen`` (training: the
    widened product has a derivative)."""
    if a.is_cuda and not widen:
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.float(), w.float())


def _moe_local(x_flat: torch.Tensor, p: MoE, cfg, capacity: int,
               widen: bool = False, e_start: int = 0,
               e_local: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX ``_moe_local``: (out (T, d), aux loss, the call's int64
    (assignments, dropped)) over the experts ``[e_start, e_start +
    e_local)`` that ``p``'s tables hold (``e_local`` 0: every expert).

    Assignment (t, k) takes slot ``pos`` of its expert, the count of the
    expert's earlier assignments in row-major (t, k) order, and is dropped
    when ``pos >= capacity``: it writes nothing into the (E, capacity, d)
    slab (here: a sink row past the slab) and adds nothing to ``out``. The
    router and the aux loss see every expert; an assignment to an expert
    outside the range is neither kept nor counted. No op here reads a
    device value back to the host, so a call on the card never waits."""
    T, d = x_flat.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    dev = x_flat.device

    gates = torch.softmax(x_flat.float() @ p.router.float(), dim=-1)  # (T, E)
    top_vals, top_idx = _top_k(gates, K)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)

    expert = top_idx.reshape(-1)  # (T*K,)
    onehot = torch.nn.functional.one_hot(expert, E)

    # Switch-style load-balancing loss over every expert
    ce = onehot.sum(0).float() / (T * K)
    aux = E * torch.sum(gates.mean(dim=0) * ce)

    if e_local and e_local != E:  # expert-parallel: this rank's range only
        expert = expert - e_start
        local = (expert >= 0) & (expert < e_local)
        onehot = onehot[:, e_start:e_start + e_local]
        E = e_local
    else:
        local = None
    pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
    keep = pos < capacity
    if local is None:
        counts = torch.stack([torch.full_like(pos[0], T * K), (~keep).sum()])
    else:
        keep = keep & local
        counts = torch.stack([local.sum(), (local & ~keep).sum()])

    dest = torch.where(keep, expert * capacity + pos, E * capacity)
    token = torch.arange(T * K, device=dev) // K
    disp = x_flat.new_zeros((E * capacity + 1, d))
    disp.index_put_((dest,), x_flat[token])  # dropped assignments all land on the sink row
    disp = disp[:-1].view(E, capacity, d)

    h = _expert_products(disp, p.wg, widen)
    u = _expert_products(disp, p.wu, widen)
    y = _expert_products((silu(h) * u).to(x_flat.dtype), p.wd, widen)  # (E, capacity, d) f32

    src = torch.where(keep, dest, 0)
    vals = y.reshape(E * capacity, d)[src] * (top_vals.reshape(-1, 1) * keep.reshape(-1, 1))
    vals = vals.view(T, K, d)
    # summed in k order, as the JAX scatter-add accumulates a token's rows
    # (no index_add_: its atomics would make the order vary on the card)
    out = vals[:, 0]
    for k in range(1, K):
        out = out + vals[:, k]
    return out.to(x_flat.dtype), aux, counts


def moe_block(x: torch.Tensor, p: MoE, cfg, ctx: MeshContext = NO_MESH
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d), aux loss), every B * S token of the call
    competing for ``moe_capacity(B * S, cfg)`` slots per expert (the JAX
    ``moe_block`` without a mesh); the call's counts go to ``moe_tally``.

    Under a mesh (the JAX branch): x is this rank's rows, whose B * S
    tokens set the capacity; the rank holds experts ``[r E/tp, (r+1)
    E/tp)`` (EP, E % tp == 0) or a d_ff slice of every expert (f-TP); the
    partial outputs (bf16, as JAX's) and ``aux / tp`` are summed over the
    model axis, then aux is divided by the batch shards. The tally counts
    this rank's assignments."""
    if ctx.mesh is None:
        out, aux, counts = moe_block_train(x, p, cfg, widen=False)
        moe_tally(x.device).add_(counts)
        return out, aux
    B, S, d = x.shape
    E, tp = cfg.num_experts, ctx.tp
    e_local = p.wg.shape[0] if p.wg.shape[0] != E else 0  # EP: this rank's experts
    out, aux, counts = _moe_local(x.reshape(B * S, d), p, cfg, moe_capacity(B * S, cfg),
                                  e_start=ctx.model_rank * e_local, e_local=e_local)
    moe_tally(x.device).add_(counts)
    out = C.all_reduce(out, ctx).to(x.dtype)
    aux = C.all_reduce(aux / tp, ctx)
    return out.reshape(B, S, d), aux / ctx.n_batch_shards


def moe_block_train(x: torch.Tensor, p: MoE, cfg, widen: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training form of ``moe_block``: ((B, S, d), aux loss, the call's
    (assignments, dropped)), the expert products widened on the card too (a
    product with a derivative) and nothing added to the tally, so that a
    block recomputed for its gradient is not counted twice: the training
    forward adds the counts of each block's first run."""
    B, S, d = x.shape
    out, aux, counts = _moe_local(x.reshape(B * S, d), p, cfg, moe_capacity(B * S, cfg), widen)
    return out.reshape(B, S, d), aux, counts
