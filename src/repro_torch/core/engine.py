"""Engine core: the pure single-replica verify stepper (no admission logic).

The port of ``repro.core.engine``: a :class:`PagedKVCache` row pool plus
the prefill / bucketed slot-indexed verify / force-extend steps that run
against it. Policy (who is admitted, what batches together) lives one layer
up in core/admission.py and core/server_engine.py.

The step bundle (:class:`VerifySteps`) holds plain step functions: PyTorch
runs eagerly, so there is nothing to compile. Capturing the steps in CUDA
graphs is later work (ROADMAP.md Queue B).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import verification
from repro_torch.models.kvcache import PagedKVCache, gather_slots, supports_paged_attention
from repro_torch.models.transformer import KV_DTYPES
from repro_torch.runtime import resolve_device

log = logging.getLogger(__name__)


def _check_kv_dtype(kv_dtype: str, cfg) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r} (one of {sorted(KV_DTYPES)})")
    if kv_dtype == "int8" and not supports_paged_attention(cfg):
        raise ValueError(
            f"kv_dtype='int8' is not supported for the {cfg.family!r} family: its "
            "recurrent-state cache leaves ride the gather/scatter fallback "
            "(models/kvcache.py), which has no quantized layout — serve it with "
            "kv_dtype='bf16'"
        )
    return kv_dtype


@dataclasses.dataclass
class Verdict:
    """Per-request outcome of one engine round (device resume protocol)."""

    device_id: int
    n_accepted: int
    tokens: np.ndarray  # committed this round: accepted drafts + extra
    next_prev: int  # correction/bonus token the device feeds next round
    accept_rate: float = 0.0  # this round's accepted/drafted
    queue_depth: int = 0  # replica queue depth after this dispatch
    queue_s: float = 0.0  # time this round waited in the admission queue
    verify_s: float = 0.0  # wall time of its verify step


@dataclasses.dataclass
class RoundStats:
    time: float
    size: int  # batch fill (requests verified)
    bucket: int  # padded batch size
    queue_depth: int  # planner queue after dispatch
    n_commit: int  # tokens committed this round
    step_seconds: float  # wall time of the verify call


@dataclasses.dataclass
class EngineStats:
    """Aggregate serving stats (field names mirror the JAX package's)."""

    wstgr: float
    per_device_rate: float
    server_busy_frac: float
    rounds: int
    timeouts: int
    fallback_tokens: int
    mean_batch_fill: float
    mean_round_latency: float
    server_rounds_per_s: float
    partial_rounds: int = 0
    streams_served: int = 0
    acceptance_rate: float = 0.0
    mean_queue_depth: float = 0.0
    # wire stats: zero in process, filled from the link stats by the
    # transport server (transport/server.py)
    bytes_tx: int = 0
    bytes_rx: int = 0
    frames_tx: int = 0
    frames_rx: int = 0
    frames_dropped: int = 0
    fallback_rounds: int = 0
    replicas: int = 1  # > 1 only for cluster-merged records

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def merge(cls, stats: Sequence["EngineStats"]) -> "EngineStats":
        """One cluster-level record from per-replica records. Replicas serve
        concurrently, so counts and rates sum (busy fractions too: above 1
        means more than one replica's worth of compute); means and
        acceptance are weighted by each replica's rounds, an idle replica
        carrying no weight. ``per_device_rate`` is the merged rate over the
        summed stream counts, each rebuilt as ``wstgr / per_device_rate``
        (an idle replica's ``streams_served``)."""
        stats = list(stats)
        if not stats:
            raise ValueError("EngineStats.merge needs at least one record")
        if len(stats) == 1:
            return dataclasses.replace(stats[0])
        rounds = [s.rounds for s in stats]
        total_rounds = sum(rounds)

        def wmean(vals):
            if total_rounds == 0:
                return float(sum(vals) / len(vals))
            return float(sum(v * r for v, r in zip(vals, rounds)) / total_rounds)

        n_streams = [s.wstgr / s.per_device_rate if s.per_device_rate > 0
                     else float(s.streams_served) for s in stats]
        wstgr = sum(s.wstgr for s in stats)
        summed = ("server_busy_frac", "timeouts", "fallback_tokens", "server_rounds_per_s",
                  "partial_rounds", "streams_served", "bytes_tx", "bytes_rx", "frames_tx",
                  "frames_rx", "frames_dropped", "fallback_rounds", "replicas")
        return cls(
            wstgr=wstgr,
            per_device_rate=wstgr / max(sum(n_streams), 1e-9),
            rounds=total_rounds,
            mean_batch_fill=wmean([s.mean_batch_fill for s in stats]),
            mean_round_latency=wmean([s.mean_round_latency for s in stats]),
            acceptance_rate=wmean([s.acceptance_rate for s in stats]),
            mean_queue_depth=wmean([s.mean_queue_depth for s in stats]),
            **{f: sum(getattr(s, f) for s in stats) for f in summed},
        )


def _pad_to(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


class VerifySteps:
    """The step bundle for one (model, serving config): prefill, bucketed
    pool verify, force-extend. The pool steps run slot-indexed for the
    attention families with ``paged_attention``, gather/scatter otherwise
    (``paged_attention=False``, the ssm and hybrid families);
    ``self.paged_attention`` says which."""

    def __init__(
        self,
        model: Any,
        *,
        scratch_slot: int,
        greedy: bool = True,
        attn_chunk: int = 32,
        kv_dtype: str = "bf16",
        paged_attention: bool = True,
    ):
        self.model = model
        self.greedy = greedy
        self.scratch_slot = scratch_slot
        self.attn_chunk = attn_chunk
        self.kv_dtype = _check_kv_dtype(kv_dtype, model.cfg)
        self.verify = verification.make_paged_verify_step(
            model, scratch_slot=scratch_slot, greedy=greedy, attn_chunk=attn_chunk,
            paged_attention=paged_attention,
        )
        self.paged_attention = self.verify.paged_attention
        self.prefill = verification.make_prefill_step(model, attn_chunk=attn_chunk)
        self.extend = verification.make_force_extend_step(model, attn_chunk=attn_chunk,
                                                          paged_attention=paged_attention)


class EngineCore:
    """Pure single-replica verify stepper: row pool + bucketed verification.

    Owns the :class:`PagedKVCache` pool on ``device`` (the card unless the
    caller asks for the CPU), in ``kv_dtype`` (bf16, or int8 with its scale
    leaves; the ssm family's state has no int8 layout and raises), and runs
    padded verify batches against arbitrary slot subsets.
    """

    def __init__(
        self,
        model: Any,
        params: Any,
        *,
        n_slots: int,
        max_len: int,
        k_max: int,
        greedy: bool = True,
        attn_chunk: int = 32,
        buckets: Optional[Sequence[int]] = None,
        batch_cap: Optional[int] = None,
        kv_dtype: str = "bf16",
        paged_attention: bool = True,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"target weights are on {params.device}, the engine on {self.device}")
        self.model = model
        self.params = params
        self.k_max = k_max
        self.greedy = greedy
        self.kv_dtype = _check_kv_dtype(kv_dtype, model.cfg)
        cache_kw = {"attn_chunk": attn_chunk}
        if self.kv_dtype == "int8":
            cache_kw["kv_dtype"] = "int8"
        self.pool = PagedKVCache(model, n_slots, max_len, device=self.device, **cache_kw)
        self.steps = VerifySteps(
            model, scratch_slot=self.pool.scratch_slot, greedy=greedy, attn_chunk=attn_chunk,
            kv_dtype=self.kv_dtype, paged_attention=paged_attention,
        )
        # the verify step the engine really runs (False: gather/scatter)
        self.paged_attention = self.steps.paged_attention
        if telemetry.enabled():
            reg = telemetry.registry()
            reg.gauge("engine_kv_pool_bytes").set(float(self.pool.pool_bytes()))
            reg.gauge("engine_bytes_per_slot").set(float(self.pool.bytes_per_slot()))
        cap = batch_cap or n_slots
        self.batch_cap = cap
        if buckets is None:
            buckets, b = [], 1
            while b < cap:
                buckets.append(b)
                b *= 2
            buckets.append(cap)
        self.buckets = sorted(set(buckets))
        self.compile_log: Dict[int, float] = {}  # bucket -> warmup seconds
        self._seed = 0  # the verify batches' per-round seed (sampling draws)

    # -- slot lifecycle ------------------------------------------------------

    def alloc_slot(self) -> int:
        """Free pool row for a new stream; raises SlotExhausted when full."""
        return self.pool.alloc()

    def free_slot(self, slot: int) -> None:
        self.pool.free(slot)

    @property
    def n_free(self) -> int:
        return self.pool.n_free

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

    def _q_tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def prefill_slot(self, slot: int, prompt) -> int:
        """Prefill ``prompt`` into pool row ``slot``; returns the last prompt
        token (the stream's first ``prev_token``)."""
        with telemetry.span("engine_prefill_seconds"):
            row = self.pool.make_row_cache()
            _, row, prev = self.steps.prefill(self.params, row, self._tensor(prompt)[None, :])
            self.pool.write_slot(slot, row)
            return int(prev[0])

    def export_row(self, slot: int) -> Dict[str, torch.Tensor]:
        """A dense batch-1 copy of pool row ``slot``, every leaf (K/V, the
        int8 pool's scales, the ssm family's state): a migrated stream
        moves to another replica's pool bit for bit."""
        return gather_slots(self.pool.cache, self._tensor([slot]))

    def import_row(self, slot: int, row_cache: Dict[str, torch.Tensor]) -> None:
        """Install an exported row into pool row ``slot``."""
        self.pool.write_slot(slot, row_cache)

    # -- compute -------------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def warmup(self) -> Dict[int, float]:
        """Run the verify step once per bucket on scratch-slot rows, so the
        first real round pays no one-time set-up (kernel build and load,
        library handles). Safe anytime: scratch contents are never read as
        committed state. Returns ``{bucket: seconds}``."""
        times: Dict[int, float] = {}
        for b in self.buckets:
            t0 = time.perf_counter()
            zeros = self._tensor(np.zeros((b,)))
            vb = verification.make_verify_batch(
                zeros, self._tensor(np.zeros((b, self.k_max))), zeros,
                draft_q=None if self.greedy else self._q_tensor(np.zeros((b, self.k_max))))
            slots = self._tensor(np.full((b,), self.pool.scratch_slot))
            _, self.pool.cache = self.steps.verify(self.params, self.pool.cache, slots, vb)
            self.pool.cache["length"].cpu()  # wait for the step
            times[b] = time.perf_counter() - t0
            log.info("warmup: bucket %d verify step ready in %.2fs", b, times[b])
        self.compile_log.update(times)
        return times

    def verify(self, slots: np.ndarray, prev: np.ndarray, toks: np.ndarray,
               qs: Optional[np.ndarray], lens: np.ndarray) -> Tuple[Any, int, float]:
        """One bucketed verify pass over pool rows ``slots``.

        Inputs are the un-padded per-request arrays (``qs``: the drafts'
        q(d_i), sampling mode only); the core pads them to the enclosing
        bucket (scratch-slot rows for the fill), seeds the round's draws
        with its round counter and commits the accepted prefixes into the
        pool. Returns ``(VerifyResult with host numpy fields, bucket,
        step_seconds)``.
        """
        t_wall = time.perf_counter()
        bucket = self.bucket_for(slots.shape[0])
        slots_p = _pad_to(np.asarray(slots, np.int32), bucket, fill=self.pool.scratch_slot)
        vb = verification.make_verify_batch(
            self._tensor(_pad_to(prev, bucket)),
            self._tensor(_pad_to(toks, bucket)),
            self._tensor(_pad_to(lens, bucket)),
            draft_q=self._q_tensor(_pad_to(qs, bucket)) if qs is not None else None,
            seed=self._seed,
        )
        res, self.pool.cache = self.steps.verify(self.params, self.pool.cache,
                                                 self._tensor(slots_p), vb)
        self._seed += 1
        res = dataclasses.replace(res, **{f.name: getattr(res, f.name).cpu().numpy()
                                          for f in dataclasses.fields(res)})
        step_seconds = time.perf_counter() - t_wall
        if telemetry.enabled():
            telemetry.observe("engine_verify_seconds", step_seconds)
            telemetry.observe("engine_verify_fill", slots.shape[0], buckets=telemetry.K_BUCKETS)
        return res, bucket, step_seconds

    def force_extend(self, slot: int, feed: np.ndarray) -> None:
        """Append ``feed`` (already shifted to satisfy the KV invariant) to
        pool row ``slot`` without verification (§III-A fallback resync)."""
        with telemetry.span("engine_commit_seconds"):
            padded = np.zeros((self.k_max + 1,), np.int32)
            padded[: feed.size] = feed
            self.pool.cache = self.steps.extend(
                self.params, self.pool.cache, self._tensor([slot]),
                self._tensor(padded[None, :]), self._tensor([feed.size]),
            )
