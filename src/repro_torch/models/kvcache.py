"""KV cache with speculative-rollback semantics, and the paged slot pool.

The port of ``repro.models.kvcache``. The cache buffer index IS the absolute
token position and a per-row ``length`` marks how many entries are
committed; rollback after verification only changes ``length``. The layout
is the JAX package's: ``k``/``v`` are ``(L, B, S, Hkv, D)`` (bf16, or int8
with ``k_scale``/``v_scale`` leaves of shape ``(L, B, Hkv)`` f32), the ssm
and hybrid families' ``ssm``/``conv`` state leaves are ``(L, B, ...)`` (the
hybrid's ``k``/``v`` are ``(n_apps, B, S, Hkv, D)``), and ``length`` is
``(B,)`` int32, so every leaf but ``length`` carries the batch on axis 1.

Unlike the JAX pytrees, the ``k``/``v`` buffers and the int8 scale leaves
are updated in place (the forward writes its fresh rows into them;
``write_slot`` and ``scatter_slots`` write pool rows). ``length`` is never
written in place: each commit makes a new tensor, so a caller holding an
older cache dict still sees its own committed length.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch


def init_kv_cache(
    num_layers: int,
    batch: int,
    max_len: int,
    num_kv_heads: int,
    head_dim: int,
    *,
    device,
    dtype=torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    # zeros, not empty: rows past a sequence's length are never attended, but
    # an uninitialised NaN there would still be a hazard for any 0 * x
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def supports_paged_attention(cfg) -> bool:
    """True when every cache leaf the verify forward touches is attention-
    shaped, so the slot-indexed path can run against the pool. The ssm and
    hybrid families carry recurrent state leaves that are not position-
    indexed and ride the gather/scatter verify path."""
    return getattr(cfg, "family", None) not in ("ssm", "hybrid")


def _batch_axis(leaf: torch.Tensor) -> int:
    return 0 if leaf.dim() == 1 else 1  # "length" vs stacked per-layer leaves


def gather_slots(cache: Dict[str, torch.Tensor], slots: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Dense sub-cache (a copy) holding pool rows ``slots``."""
    idx = slots.to(torch.int64)
    return {name: a.index_select(_batch_axis(a), idx) for name, a in cache.items()}


def scatter_slots(
    pool: Dict[str, torch.Tensor], slots: torch.Tensor, sub: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Write dense sub-cache rows back into pool rows ``slots``, in place for
    ``k``/``v`` (``length`` gets a new tensor). Duplicate slot ids (scratch
    padding) have no defined winner; scratch contents are never read as
    committed state."""
    idx = slots.to(torch.int64)
    out = dict(pool)
    for name, a in pool.items():
        if name == "length":
            length = a.clone()
            length[idx] = sub[name]
            out[name] = length
        else:
            a[:, idx] = sub[name]
    return out


class SlotExhausted(RuntimeError):
    """No free cache row: admission must wait for a stream to retire."""


class SlotAllocator:
    """Host-side free-list over ``n_slots`` cache rows (LIFO reuse)."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self._used: set = set()

    def alloc(self) -> int:
        if not self._free:
            raise SlotExhausted(f"all {self.n_slots} cache slots in use")
        slot = self._free.pop()
        self._used.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._used:
            raise ValueError(f"slot {slot} is not allocated")
        self._used.remove(slot)
        self._free.append(slot)

    @property
    def n_free(self) -> int:
        return len(self._free)


class PagedKVCache:
    """Fixed pool of cache rows + slot map: the server-side state behind
    continuous-batching verification.

    The pool holds ``n_slots`` device rows plus ONE scratch row (index
    ``n_slots``) that padded verify batches point at, so real rows are never
    touched by the fill.
    """

    def __init__(self, model: Any, n_slots: int, max_len: int, *, device, **cache_kw):
        self.model = model
        self.n_slots = n_slots
        self.scratch_slot = n_slots
        self.max_len = max_len
        self.device = device
        self.cache_kw = dict(cache_kw)
        self.cache = model.make_cache(n_slots + 1, max_len, device=device, **cache_kw)
        self.allocator = SlotAllocator(n_slots)

    def pool_bytes(self) -> int:
        """Device bytes held by the pool (all leaves, incl. the scratch row)."""
        return sum(a.numel() * a.element_size() for a in self.cache.values())

    def bytes_per_slot(self) -> int:
        return self.pool_bytes() // (self.n_slots + 1)

    def alloc(self) -> int:
        return self.allocator.alloc()

    def free(self, slot: int) -> None:
        self.allocator.free(slot)

    @property
    def n_free(self) -> int:
        return self.allocator.n_free

    def make_row_cache(self) -> Dict[str, torch.Tensor]:
        """Fresh dense batch-1 cache shaped to scatter into one pool row."""
        return self.model.make_cache(1, self.max_len, device=self.device, **self.cache_kw)

    def write_slot(self, slot: int, row_cache: Dict[str, torch.Tensor]) -> None:
        """Install a prefilled batch-1 cache into pool row ``slot``."""
        slots = torch.tensor([slot], dtype=torch.int32, device=self.device)
        self.cache = scatter_slots(self.cache, slots, row_cache)
