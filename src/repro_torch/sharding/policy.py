"""Per-architecture sharding policy: where each parameter, cache and batch
leaf lies on a mesh.

The port of ``repro.sharding.policy``, rule for rule. A spec is a tuple with
one entry per dimension: None (replicated), an axis name, or a tuple of
axis names (sharded over their product, the first the major one), so that
``tuple(jax_spec) == spec`` for the JAX package's ``PartitionSpec``.
Specs are keyed by the JAX layout's paths (``"layers/attn/wq"``, a stacked
leaf's leading L axis included), which ``bridge`` maps to the port's
parameter names.

Decisions (as in JAX):
  * attention: query heads over ``model`` when they divide it ("heads"),
    else the packed (H * hd) dim when that divides and H > tp ("flat":
    the weights shard evenly, the layer re-gathers the activations around
    the per-head reshape), else replicated; KV heads likewise only when
    Hkv % tp == 0, and otherwise (serve mode) the cache shards its
    sequence over ``model`` instead (``seq_shard_kv``);
  * mlp: d_ff over ``model``; vocab: embedding rows and lm_head columns
    over ``model`` when V % tp == 0;
  * moe: expert-parallel when E % tp == 0, else each expert's d_ff
    (f-TP), the router replicated;
  * ssm: the mamba weights replicated, the batch over ``data``; the
    ``ssm`` state split by SSD head over ``model`` where the heads divide
    it (each rank scans its heads), the ``conv`` window whole;
  * encdec: the cross K/V leaves split by KV head where the heads divide;
  * train mode: FSDP adds ``data`` on the largest remaining divisible dim of
    every leaf of at least 2M elements.

In place of JAX's ``named`` (NamedSharding, which the XLA partitioner
reads), ``local_shard`` cuts this rank's piece out of a full tensor, and
``shard_params``/``shard_module``/``shard_cache``/``shard_batch`` apply
the specs to whole trees: each rank then holds only its pieces.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import bridge
from repro_torch.models.layers import MeshContext
from repro_torch.runtime import resolve_device

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Policy:
    cfg: Any
    mesh: Any
    mode: str  # "train" | "serve"
    fsdp: bool

    @property
    def tp(self) -> int:
        return self.mesh.shape["model"]

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)

    @property
    def n_batch_shards(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def ctx(self) -> MeshContext:
        return MeshContext(mesh=self.mesh, batch_axes=self.batch_axes,
                           model_axis="model", fsdp=self.fsdp,
                           seq_shard_kv=self.seq_shard_kv())

    # -- parameters ---------------------------------------------------------
    # every rule checks divisibility: the pieces are even

    def shard_attn_q(self) -> str:
        """'heads' | 'flat' | 'none'."""
        cfg, tp = self.cfg, self.tp
        if cfg.num_heads == 0:
            return "none"
        if cfg.num_heads % tp == 0:
            return "heads"
        if (cfg.num_heads * cfg.head_dim) % tp == 0 and cfg.num_heads > tp:
            return "flat"
        return "none"

    def shard_attn_kv(self) -> bool:
        return self.cfg.num_kv_heads > 0 and self.cfg.num_kv_heads % self.tp == 0

    def seq_shard_kv(self) -> bool:
        """Sequence-shard the attention caches when KV heads can't shard:
        the replicated cache would not fit (granite MQA)."""
        cfg = self.cfg
        if self.mode == "train" or cfg.num_kv_heads == 0:
            return False
        return not self.shard_attn_kv()

    def shard_vocab(self) -> bool:
        return self.cfg.vocab_size % self.tp == 0

    def _fsdp_axis(self, spec: Spec, shape: Tuple[int, ...], threshold: int = 1 << 21) -> Spec:
        """Add 'data' on the largest unsharded divisible dim of big leaves."""
        if not self.fsdp or "data" not in self.mesh.axis_names:
            return spec
        if math.prod(shape) < threshold:
            return spec
        dp = self.mesh.shape["data"]
        cands = [(shape[i], i) for i in range(len(shape))
                 if spec[i] is None and shape[i] % dp == 0 and shape[i] >= dp]
        if not cands:
            return spec
        _, i = max(cands)
        out = list(spec)
        out[i] = "data"
        return tuple(out)

    def param_spec_for(self, path: str, shape: Tuple[int, ...]) -> Spec:
        cfg, tp = self.cfg, self.tp
        name = path.split("/")[-1]
        stacked = "layers" in path  # leading L (or group) axes
        lead: Spec = ()
        if stacked:
            known_tail = {
                "wq": 2, "wk": 2, "wv": 2, "wo": 2, "bq": 1, "bk": 1, "bv": 1,
                "wg": 2, "wu": 2, "wd": 2, "wi": 2, "router": 2,
                "scale": 1, "bias": 1,
                "in_proj": 2, "conv_w": 2, "conv_b": 1, "A_log": 1, "D": 1,
                "dt_bias": 1, "gnorm": 1, "out_proj": 2,
            }
            tail = known_tail.get(name, len(shape))
            if "/moe/" in path and name in ("wg", "wu", "wd"):
                tail = 3  # (E, d, f)
            lead = (None,) * (len(shape) - tail)

        def out(*spec):
            return self._fsdp_axis(lead + spec, shape)

        if name in ("scale", "bias", "conv_b", "A_log", "D", "dt_bias", "gnorm",
                    "pos_embed", "conv_w"):
            return (None,) * len(shape)
        if name == "embed":
            return out("model", None) if self.shard_vocab() else out(None, None)
        if name == "lm_head":
            return out(None, "model") if self.shard_vocab() else out(None, None)
        q_mode = self.shard_attn_q()
        kv_mode = self.shard_attn_kv() or (q_mode == "flat")
        if name == "wq":
            return out(None, "model") if q_mode != "none" else out(None, None)
        if name in ("wk", "wv"):
            return out(None, "model") if kv_mode else out(None, None)
        if name == "wo":
            return out("model", None) if q_mode != "none" else out(None, None)
        if name == "bq":
            return out("model") if q_mode != "none" else out(None)
        if name in ("bk", "bv"):
            return out("model") if kv_mode else out(None)
        if name == "router":
            return out(None, None)
        if "/moe/" in path and name in ("wg", "wu"):
            if cfg.num_experts % tp == 0:
                return out("model", None, None)
            return out(None, None, "model")
        if "/moe/" in path and name == "wd":
            if cfg.num_experts % tp == 0:
                return out("model", None, None)
            return out(None, "model", None)
        if name in ("wg", "wu", "wi"):  # dense mlp
            return out(None, "model")
        if name == "wd":
            return out("model", None)
        if name in ("in_proj", "out_proj"):
            return out(None, None)
        return (None,) * len(shape)

    def param_specs(self, params_tree: Any, fsdp: Optional[bool] = None) -> Any:
        """The specs of a params tree in the JAX layout (leaves with a
        ``shape``). ``fsdp`` overrides the policy's (the ZeRO-2 layout:
        live params TP-only, the optimizer state fully sharded)."""
        pol = self if fsdp is None else dataclasses.replace(self, fsdp=fsdp)

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
            return pol.param_spec_for("/".join(path), tuple(tree.shape))

        return walk(params_tree, ())

    # -- caches & batches ----------------------------------------------------

    def _bspec(self, batch_size: int):
        """Batch axis spec; replicate when the batch can't shard evenly."""
        if batch_size % max(self.n_batch_shards, 1) == 0 and batch_size >= self.n_batch_shards:
            ax = self.batch_axes
            return ax if len(ax) > 1 else ax[0] if ax else None
        return None

    def cache_spec_for(self, key: str, shape: Tuple[int, ...]) -> Spec:
        cfg = self.cfg
        if key == "length":
            return (self._bspec(shape[0]),)
        if key in ("cross_k", "cross_v"):  # (L, B, F, Hkv, hd): the encoder side
            h = "model" if self.shard_attn_kv() else None
            return (None, self._bspec(shape[1]), None, h, None)
        if key in ("k", "v"):  # (L|n, B, S, Hkv, hd)
            if self.seq_shard_kv() and shape[2] % self.tp == 0:
                return (None, self._bspec(shape[1]), "model", None, None)
            h = "model" if self.shard_attn_kv() else None
            return (None, self._bspec(shape[1]), None, h, None)
        if key.startswith("ssm"):  # (L, B, H, P, N)
            h = "model" if cfg.ssm_heads % self.tp == 0 else None
            return (None, self._bspec(shape[1]), h, None, None)
        if key.startswith("conv"):  # (L, B, w, C)
            return (None, self._bspec(shape[1]), None, None)
        return (None,) * len(shape)

    def cache_specs(self, cache_tree: Dict[str, Any]) -> Dict[str, Spec]:
        return {k: self.cache_spec_for(k, tuple(v.shape)) for k, v in cache_tree.items()}

    def batch_specs(self, batch_tree: Dict[str, Any]) -> Dict[str, Spec]:
        def spec(v):
            ndim = len(getattr(v, "shape", ()))
            if ndim == 0:
                return ()
            return (self._bspec(v.shape[0]),) + (None,) * (ndim - 1)

        return {k: spec(v) for k, v in batch_tree.items()}

    # -- this rank's pieces --------------------------------------------------

    def shard_cache(self, cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's piece of every leaf of a full cache (``ssm`` by SSD
        head, ``k``/``v`` and ``cross_k``/``cross_v`` by KV head or
        sequence, every leaf by batch row). A verify's state checkpoints
        (``ssm_ckpt``, ``conv_ckpt``: (L, B, K, ...)) are not cut here:
        ``cache_spec_for`` would put the model axis on their K axis, as
        JAX's does."""
        ckpts = [k for k in cache if k.endswith("_ckpt")]
        if ckpts:
            raise ValueError(f"shard the committed cache, not the checkpoints {ckpts}")
        specs = self.cache_specs(cache)
        return {k: local_shard(v, specs[k], self.mesh) for k, v in cache.items()}

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a batch (0-d leaves and plain numbers as they are)."""
        specs = self.batch_specs(batch)
        return {k: local_shard(v, specs[k], self.mesh) if specs[k] else v
                for k, v in batch.items()}


def make_policy(cfg, mesh, *, mode: str = "serve", fsdp: Optional[bool] = None) -> Policy:
    if fsdp is None:
        fsdp = mode == "train"
    return Policy(cfg=cfg, mesh=mesh, mode=mode, fsdp=fsdp)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def local_shard(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's piece of ``full`` under ``spec``: along each sharded
    dimension, piece ``i`` of ``n`` equal ones, n the product of the entry's
    axis sizes and i this rank's coordinates over them (the first axis the
    major one). A copy of its own, never a view that keeps ``full`` alive."""
    if len(spec) != full.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(full.shape)}")
    out = full
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + mesh.coords[a]
        size = full.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split {n} ways")
        out = out.narrow(dim, idx * (size // n), size // n)
    return out.clone(memory_format=torch.contiguous_format)


def port_param_specs(policy: Policy, model) -> Dict[str, Spec]:
    """Port parameter name -> spec of that parameter's own shape (a
    stacked JAX leaf's layer axis dropped)."""
    L = len(model.layers)
    specs = {}
    for name, path, layer in bridge.param_paths(model):
        shape = tuple(bridge._dotted(model, name).shape)
        if layer is None:
            specs[name] = policy.param_spec_for("/".join(path), shape)
        else:
            specs[name] = policy.param_spec_for("/".join(path), (L,) + shape)[1:]
    return specs


def shard_module(model, policy: Policy):
    """Replace every parameter of a full port model (on this rank's device)
    by this rank's piece of it, in place; returns the model. The full
    tensors are freed as their pieces replace them."""
    with torch.no_grad():
        for name, spec in port_param_specs(policy, model).items():
            if any(spec):
                model.set_weight(name, local_shard(bridge._dotted(model, name), spec, policy.mesh))
    return model


def shard_params(tree: Dict[str, Any], policy: Policy, *, device="cuda"):
    """The weights-across function of a mesh: a params tree in the JAX
    layout (numpy leaves, or the torch leaves of ``bridge.params_tree``)
    -> the port's model on ``device`` holding this rank's pieces only. The
    full leaves stay on the host; only the pieces reach the device."""
    device = resolve_device(device)
    model = shard_module(bridge.params_from_jax(policy.cfg, tree, device="cpu"), policy)
    return model.to(device)
