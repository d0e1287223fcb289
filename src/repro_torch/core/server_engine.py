"""Single-replica verification engine: EngineCore + AdmissionControl composed.

The port of ``repro.core.server_engine``: verification requests from edge
devices queue in a BatchPlanner, and whenever the policy fires the engine
verifies the scheduled subset of device streams in one forward pass
(partial fills, heterogeneous draft lengths, devices joining and leaving).

EdgeDeviceKit / EdgeDevice are the host-side stand-ins for device drafting
loops (a batch-1 draft model per device, sharing one kit).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import drafting, verification
from repro_torch.core.admission import AdmissionControl, DeviceStream
from repro_torch.core.engine import EngineCore, EngineStats, RoundStats, Verdict
from repro_torch.models.kvcache import SlotExhausted
from repro_torch.runtime import DRAFT_STREAM, resolve_device, seeded_generator

__all__ = [
    "DeviceStream",
    "EdgeDevice",
    "EdgeDeviceKit",
    "EngineStats",
    "RoundStats",
    "ServerEngine",
    "Verdict",
]


class ServerEngine:
    """Admission + step loop for ONE replica: PagedKVCache pool, BatchPlanner
    policies, bucketed slot-indexed verification::

        engine = ServerEngine(target, tp, n_slots=8, max_len=256, k_max=4)
        engine.admit(device_id, prompt, now)          # joins a free slot
        engine.submit(device_id, draft_tokens, now)   # device -> server hop
        verdicts = engine.step(now)                   # policy may dispatch
        engine.retire(device_id)                      # frees the slot
    """

    def __init__(
        self,
        model: Any,
        params: Any,
        *,
        n_slots: int,
        max_len: int,
        k_max: int,
        policy: str = "continuous",
        batch_size: Optional[int] = None,
        max_wait: float = 0.050,
        straggler_timeout: float = 1.0,
        greedy: bool = True,
        attn_chunk: int = 32,
        buckets: Optional[Sequence[int]] = None,
        kv_dtype: str = "bf16",
        paged_attention: bool = True,
        device="cuda",
    ):
        cap = batch_size or n_slots
        self.core = EngineCore(
            model, params, n_slots=n_slots, max_len=max_len, k_max=k_max, greedy=greedy,
            attn_chunk=attn_chunk, buckets=buckets, batch_cap=cap,
            kv_dtype=kv_dtype, paged_attention=paged_attention, device=device,
        )
        self.admission = AdmissionControl(
            batch_size=cap, k_max=k_max, policy=policy, max_wait=max_wait,
            straggler_timeout=straggler_timeout, greedy=greedy,
        )
        self.k_max = k_max
        self.greedy = greedy
        self.kv_dtype = kv_dtype
        self._batch_cap = cap
        self.round_log: List[RoundStats] = []
        # telemetry on: the last rounds, for crash, eviction and drain reports
        self.flight = telemetry.FlightRecorder()
        self._round_seq: Dict[int, int] = {}  # device_id -> next round seq
        self._t0: Optional[float] = None
        self._t_last = 0.0
        self._committed_total = 0
        self._busy_seconds = 0.0
        self._latencies: List[float] = []
        self._drafted = 0
        self._accepted = 0
        self._fallback_tokens = 0
        self._fallback_rounds = 0

    @property
    def pool(self):
        return self.core.pool

    @property
    def paged_attention(self) -> bool:
        """The core's verify mode: False where the engine gathers and
        scatters pool rows (``paged_attention=False``, the ssm and hybrid
        families); read by ``LocalReplica.fingerprint``."""
        return self.core.paged_attention

    @property
    def streams(self) -> Dict[int, DeviceStream]:
        return self.admission.streams

    def warmup(self) -> Dict[int, float]:
        return self.core.warmup()

    # -- admission -----------------------------------------------------------

    def admit(self, device_id: int, prompt, now: float = 0.0) -> Optional[DeviceStream]:
        """Prefill ``prompt`` into a free pool slot; None when the pool is full."""
        if device_id in self.streams:
            raise ValueError(f"device {device_id} already admitted")
        try:
            slot = self.core.alloc_slot()
        except SlotExhausted:
            return None
        prev = self.core.prefill_slot(slot, prompt)
        stream = self.admission.register(device_id, slot, prev, now)
        if self._t0 is None:
            self._t0 = now
        return stream

    def retire(self, device_id: int) -> DeviceStream:
        """Stream finished (or left): free its slot for the next admission."""
        stream = self.admission.release(device_id, served=True)
        self.core.free_slot(stream.slot)
        return stream

    # -- stream migration (cluster router) -----------------------------------

    def export_stream(self, device_id: int):
        """Detach a quiescent stream for migration to another replica:
        ``(stream, row_cache)``, the server-side stream state and a bit-exact
        copy of its pool row. Refuses while a request is in flight (the row
        would change under the copy)."""
        if self.admission.has_inflight(device_id):
            raise ValueError(f"device {device_id} has a request in flight; cannot migrate")
        row = self.core.export_row(self.streams[device_id].slot)
        stream = self.admission.release(device_id, served=False)
        self.core.free_slot(stream.slot)
        return stream, row

    def import_stream(self, stream: DeviceStream, row_cache) -> DeviceStream:
        """Adopt a stream exported from another replica: a free slot, the row
        installed bit for bit, the stream registered."""
        slot = self.core.alloc_slot()  # raises SlotExhausted when full
        self.core.import_row(slot, row_cache)
        stream.slot = slot
        self.admission.adopt(stream)
        if self._t0 is None:
            self._t0 = stream.admitted_at
        return stream

    # -- request queue -------------------------------------------------------

    def submit(self, device_id: int, draft_tokens: np.ndarray, now: float,
               draft_q: Optional[np.ndarray] = None) -> None:
        """Queue a device's proposal; sampling mode needs its q(d_i) row
        (``EdgeDevice.pending_q``)."""
        self.admission.submit(device_id, draft_tokens, now, draft_q=draft_q)

    def cancel_request(self, device_id: int) -> bool:
        """Withdraw the device's queued request (the transport's fallback:
        the device timed out and released its drafts). False when nothing is
        queued: the round was verified and its verdict, on its way, is
        authoritative."""
        return self.admission.cancel(device_id)

    def force_extend(self, device_id: int, tokens: np.ndarray) -> int:
        """Append ``tokens`` to the stream unverified (§III-A fallback resync:
        the device already released them). Returns the new prev token."""
        stream = self.streams[device_id]
        if self.admission.has_inflight(device_id):
            raise ValueError(f"device {device_id} still has a request in flight")
        toks = np.asarray(tokens, np.int32).reshape(-1)
        if toks.size == 0:
            return stream.prev_token
        if toks.size > self.k_max + 1:
            raise ValueError(f"fallback run of {toks.size} exceeds k_max+1")
        # KV invariant: the last committed token is never in the cache, so we
        # feed [prev, t_1 .. t_{n-1}] and the new prev becomes t_n
        feed = np.concatenate([[stream.prev_token], toks[:-1]]).astype(np.int32)
        self.core.force_extend(stream.slot, feed)
        stream.committed.extend(int(t) for t in toks)
        stream.prev_token = int(toks[-1])
        self._committed_total += toks.size
        self._fallback_tokens += toks.size
        self._fallback_rounds += 1
        if telemetry.enabled():
            telemetry.count("engine_fallback_rounds_total")
            self.flight.record(telemetry.TraceEvent(
                device_id=device_id, round=self._next_round(device_id), t=self._t_last,
                k=0, n_accepted=0, n_commit=int(toks.size), fallback=True))
        return stream.prev_token

    def _next_round(self, device_id: int) -> int:
        seq = self._round_seq.get(device_id, 0)
        self._round_seq[device_id] = seq + 1
        return seq

    def has_inflight(self, device_id: int) -> bool:
        return self.admission.has_inflight(device_id)

    @property
    def queue_depth(self) -> int:
        return self.admission.queue_depth

    def next_event_hint(self, now: float) -> Optional[float]:
        """Earliest future planner deadline or straggler event (when the
        transport server's step loop should wake)."""
        return self.admission.next_event_hint(now)

    # -- the serving hot loop ------------------------------------------------

    def step(self, now: float) -> Optional[List[Verdict]]:
        """Ask the planner for a batch; if the policy fires, verify that row
        subset and commit. Returns per-request verdicts, or None."""
        batch = self.admission.next_batch(now)
        if batch is None:
            return None
        prev, toks, qs, lens = batch.padded_arrays()
        slots = np.asarray([self.streams[r.device_id].slot for r in batch.requests], np.int32)
        # only q(d_i) goes on the wire, never the full draft distribution, so
        # corrections are sampled from the target (the JAX package's engine
        # path does the same)
        res, bucket, step_seconds = self.core.verify(
            slots, prev, toks, qs if any(r.draft_q is not None for r in batch.requests) else None,
            lens)
        depth_after = self.queue_depth
        verdicts = []
        committed_round = 0
        for i, req in enumerate(batch.requests):
            stream = self.streams[req.device_id]
            self.admission.resolve(req.device_id)
            n_acc = int(res.n_accepted[i])
            self._drafted += int(lens[i])
            self._accepted += n_acc
            stream.drafted += int(lens[i])
            stream.accepted += n_acc
            n = int(res.n_commit[i])
            toks_i = res.out_tokens[i, :n]
            stream.committed.extend(int(t) for t in toks_i)
            stream.prev_token = int(res.extra_token[i])
            stream.rounds += 1
            committed_round += n
            queue_s = now - req.arrival
            self._latencies.append(queue_s)
            verdicts.append(Verdict(
                device_id=req.device_id,
                n_accepted=n_acc,
                tokens=toks_i,
                next_prev=int(res.extra_token[i]),
                accept_rate=n_acc / max(int(lens[i]), 1),
                queue_depth=depth_after,
                queue_s=queue_s,
                verify_s=step_seconds,
            ))
            if telemetry.enabled():
                self.flight.record(telemetry.TraceEvent(
                    device_id=req.device_id, round=self._next_round(req.device_id), t=now,
                    k=int(lens[i]), n_accepted=n_acc, n_commit=n, queue_s=queue_s,
                    verify_s=step_seconds))
                telemetry.observe("engine_round_latency_seconds", queue_s + step_seconds)
                telemetry.observe("engine_k", int(lens[i]), buckets=telemetry.K_BUCKETS)
        self._busy_seconds += step_seconds
        self._committed_total += committed_round
        self._t_last = max(self._t_last, now)
        self.round_log.append(RoundStats(
            time=now, size=batch.size, bucket=bucket, queue_depth=depth_after,
            n_commit=committed_round, step_seconds=step_seconds,
        ))
        return verdicts

    # -- stats ---------------------------------------------------------------

    def stats(self, now: Optional[float] = None) -> EngineStats:
        elapsed = max((now if now is not None else self._t_last) - (self._t0 or 0.0), 1e-9)
        fills = [r.size for r in self.round_log]
        n_streams = max(self.admission.streams_served + len(self.streams), 1)
        return EngineStats(
            wstgr=self._committed_total / elapsed,
            per_device_rate=self._committed_total / n_streams / elapsed,
            server_busy_frac=self._busy_seconds / elapsed,
            rounds=len(self.round_log),
            timeouts=self.admission.timeouts,
            fallback_tokens=self._fallback_tokens,
            mean_batch_fill=float(np.mean(fills)) if fills else 0.0,
            mean_round_latency=float(np.mean(self._latencies)) if self._latencies else 0.0,
            server_rounds_per_s=len(self.round_log) / elapsed,
            partial_rounds=sum(1 for r in self.round_log if r.size < self._batch_cap),
            streams_served=self.admission.streams_served,
            acceptance_rate=self._accepted / max(self._drafted, 1),
            mean_queue_depth=(
                float(np.mean([r.queue_depth for r in self.round_log])) if self.round_log else 0.0
            ),
            fallback_rounds=self._fallback_rounds,
        )

    def telemetry_payload(self) -> dict:
        """This replica's telemetry as one JSON-shaped record, empty while
        telemetry is off: the metrics snapshot, with the pool gauges read
        now, and the flight recorder's last rounds."""
        if not telemetry.enabled():
            return {}
        reg = telemetry.registry()
        reg.gauge("engine_kv_pool_bytes").set(float(self.pool.pool_bytes()))
        reg.gauge("engine_bytes_per_slot").set(float(self.pool.bytes_per_slot()))
        return {"snapshot": reg.snapshot(), "flight": self.flight.dump()}


# ---------------------------------------------------------------------------
# Device side: batch-1 drafting loops sharing one kit
# ---------------------------------------------------------------------------


class EdgeDeviceKit:
    """Shared draft/prefill steps for a fleet of batch-1 edge devices. With
    ``greedy=False`` each device samples its drafts from its own generator
    and keeps the full draft distributions (``keep_q_full``), as the JAX
    kit does; only their q(d_i) rows are submitted."""

    def __init__(
        self,
        draft_model: Any,
        draft_params: Any,
        *,
        k_max: int,
        c_th: float = 0.0,
        greedy: bool = True,
        attn_chunk: int = 32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if draft_params.device != self.device:
            raise ValueError(f"draft weights are on {draft_params.device}, the kit on {self.device}")
        self.model = draft_model
        self.params = draft_params
        self.k_max = k_max
        self.c_th = float(c_th)
        self.greedy = greedy
        self._attn_chunk = attn_chunk
        self._prefill = verification.make_prefill_step(draft_model, attn_chunk=attn_chunk)
        # draft-ahead replays the post-acceptance state exactly; the dense
        # family's cache rolls back by length alone, an ssm state would need
        # a checkpoint of the draft-ahead round too
        self.supports_pipeline = greedy and draft_model.cfg.family not in ("ssm", "hybrid")

    def draft(self, cache, prev: torch.Tensor, generator: Optional[torch.Generator] = None,
              c_th: Optional[float] = None) -> drafting.DraftResult:
        """One round of ``k_max`` draft steps; ``c_th`` overrides the kit's
        confidence bar for this round (the adaptive controller moves it)."""
        return drafting.draft_round(self.model, self.params, cache, prev, k_max=self.k_max,
                                    c_th=self.c_th if c_th is None else float(c_th),
                                    greedy=self.greedy, generator=generator,
                                    keep_q_full=not self.greedy, attn_chunk=self._attn_chunk)

    def peek(self, cache, tok: torch.Tensor) -> torch.Tensor:
        """Greedy next-token guess for ``tok`` against ``cache`` (no commit).
        It writes ``tok``'s K/V at the cache's length, past every committed
        row, where the next round would write the same values."""
        h, _ = self.model.decode_forward(self.params, cache, tok[:, None],
                                         attn_chunk=self._attn_chunk)
        return torch.argmax(self.model.lm_head(self.params, h)[:, 0], dim=-1).to(torch.int32)

    def spawn(self, device_id: int, prompt, *, max_len: int, seed: int = 0) -> "EdgeDevice":
        return EdgeDevice(self, device_id, prompt, max_len=max_len, seed=seed)


def _clamp_draft(dres: drafting.DraftResult, k: Optional[int]) -> drafting.DraftResult:
    """Cap a round's proposal at ``k`` tokens (adaptive speculation length).
    The round always runs ``k_max`` steps; drafting is autoregressive, so
    the first ``k`` tokens are what a ``k``-step round would have drafted,
    and rollback reads only ``lengths`` and the verdict's acceptance."""
    if k is None or k < 1:
        return dres
    return dataclasses.replace(dres, lengths=torch.clamp(dres.lengths, max=int(k)))


class EdgeDevice:
    """One edge device's drafting loop (SLED §III-A), batch size 1.

    Supports pipelined draft-ahead: after submitting a round the device may
    keep drafting on the assumption that every token will be accepted,
    seeding the ahead round with its own greedy guess at the bonus token. A
    confirmed guess submits the pre-drafted round at once; greedy drafting
    is deterministic from (cache, prev), so pipelining never changes
    outputs. The cache buffers are shared and written in place; every
    speculative write lands past the committed length of the state it may be
    rolled back to, so a miss is undone by length alone.

    A sampling device draws its drafts from its own generator on the kit's
    device, seeded with ``seed``; ``pending_q`` holds the q(d_i) row of the
    round in flight, for ``engine.submit(..., draft_q=dev.pending_q)``.
    """

    def __init__(self, kit: EdgeDeviceKit, device_id: int, prompt, *, max_len: int,
                 seed: int = 0):
        self.kit = kit
        self.device_id = device_id
        cache = kit.model.make_cache(1, max_len, device=kit.device, attn_chunk=kit._attn_chunk)
        prompt = torch.as_tensor(np.asarray(prompt, np.int32)).to(kit.device)
        _, self.cache, self.prev = kit._prefill(kit.params, cache, prompt[None, :])
        self.generator = seeded_generator(kit.device, seed, DRAFT_STREAM)
        self.committed: List[int] = []
        self._pending: Optional[drafting.DraftResult] = None
        self.pending_q: Optional[np.ndarray] = None
        self._ahead: Optional[tuple] = None  # (bonus_guess, cache_acc, dres)
        self.pipeline_hits = 0
        self.pipeline_misses = 0
        self.fallback_tokens = 0
        self.drafted = 0

    def draft(self, k: Optional[int] = None, c_th: Optional[float] = None) -> np.ndarray:
        """Draft up to ``min(k, k_max)`` tokens at confidence bar ``c_th``
        (the kit's when None); returns the variable-length proposal."""
        if self._pending is not None:
            raise RuntimeError("previous round still awaiting a verdict")
        dres = _clamp_draft(self.kit.draft(self.cache, self.prev, self.generator, c_th), k)
        self._set_pending(dres)
        n = int(dres.lengths[0])
        self.drafted += n
        return dres.tokens[0, :n].cpu().numpy()

    def _set_pending(self, dres: drafting.DraftResult) -> None:
        self._pending = dres
        # the round's q row leaves the card once, for the wire or the engine
        self.pending_q = dres.q_sel[0, :int(dres.lengths[0])].cpu().numpy()

    def draft_ahead(self, k: Optional[int] = None,
                    c_th: Optional[float] = None) -> Optional[np.ndarray]:
        """Pre-draft the next round while the current one is in flight;
        it becomes live only if on_verdict() confirms the speculation."""
        if self._pending is None:
            raise RuntimeError("draft_ahead needs a round in flight")
        if self._ahead is not None or not self.kit.supports_pipeline:
            return None
        pend = self._pending
        n = int(pend.lengths[0])
        last = pend.tokens[:, n - 1]
        # the draft model's bonus-position guess: feed d_n against the cache
        # rolled to just before d_n (logits only)
        peek_cache = {**pend.cache, "length": pend.base_length + n}
        bonus_guess = int(self.kit.peek(peek_cache, last)[0])
        cache_acc = drafting.resume_after_verify(pend, torch.tensor([n], dtype=torch.int32))
        prev_guess = torch.tensor([bonus_guess], dtype=torch.int32, device=self.kit.device)
        dres = _clamp_draft(self.kit.draft(cache_acc, prev_guess, self.generator, c_th), k)
        self._ahead = (bonus_guess, cache_acc, dres)
        return dres.tokens[0, : int(dres.lengths[0])].cpu().numpy()

    def on_verdict(self, verdict: Verdict) -> Optional[np.ndarray]:
        """Roll the draft cache back to the verified prefix and resync.
        Returns the next round's proposal when draft-ahead was confirmed."""
        if self._pending is None:
            raise RuntimeError("no round awaiting a verdict")
        pend = self._pending
        n = int(pend.lengths[0])
        self.committed.extend(int(t) for t in verdict.tokens)
        if self._ahead is not None:
            bonus_guess, cache_acc, ahead = self._ahead
            self._ahead = None
            if verdict.n_accepted == n and verdict.next_prev == bonus_guess:
                self.pipeline_hits += 1
                self.cache = cache_acc
                self.prev = torch.tensor([bonus_guess], dtype=torch.int32, device=self.kit.device)
                self._set_pending(ahead)
                return ahead.tokens[0, : int(ahead.lengths[0])].cpu().numpy()
            self.pipeline_misses += 1
        self.cache = drafting.resume_after_verify(
            pend, torch.tensor([verdict.n_accepted], dtype=torch.int32)
        )
        self.prev = torch.tensor([verdict.next_prev], dtype=torch.int32, device=self.kit.device)
        self._pending = None
        return None

    def fallback_release(self) -> np.ndarray:
        """§III-A timeout fallback: release the in-flight drafts locally and
        continue as if they were committed. The caller resyncs the server
        (engine.force_extend) with the returned tokens."""
        if self._pending is None:
            raise RuntimeError("no round in flight to release")
        pend = self._pending
        n = int(pend.lengths[0])
        toks = pend.tokens[0, :n].cpu().numpy()
        # accept n-1 drafts cache-side; the nth rides as prev_token
        self.cache = drafting.resume_after_verify(pend, torch.tensor([n - 1], dtype=torch.int32))
        self.prev = torch.tensor([int(toks[-1])], dtype=torch.int32, device=self.kit.device)
        self.committed.extend(int(t) for t in toks)
        self.fallback_tokens += n
        self._pending = None
        self._ahead = None
        return toks

    @property
    def awaiting(self) -> bool:
        return self._pending is not None
