"""Admission control + stream lifecycle for one verification replica.

The port's own copy of ``repro.core.admission`` (host-side, tensor-free).

The middle layer of the serving stack: :class:`AdmissionControl` owns the
per-stream server state (DeviceStream registry), the request queue discipline
(one in-flight round per device, duplicate/cancel arbitration), and the
:class:`~repro.core.scheduler.BatchPlanner` that decides *when* queued
requests dispatch.  It never touches model state — the engine core
(core/engine.py) owns the pool and the compute; core/server_engine.py
composes the two into the single-replica ``ServerEngine``, and
cluster/router.py places streams across many of them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch import telemetry
from repro_torch.core.scheduler import BatchPlanner, PlannedBatch, VerifyRequest


@dataclasses.dataclass
class DeviceStream:
    """Server-side state of one admitted device stream."""

    device_id: int
    slot: int
    prev_token: int
    committed: List[int] = dataclasses.field(default_factory=list)
    admitted_at: float = 0.0
    rounds: int = 0
    drafted: int = 0  # lifetime draft tokens verified for this stream
    accepted: int = 0  # lifetime accepted draft tokens

    @property
    def accept_rate(self) -> float:
        """Lifetime acceptance ratio (stats/diagnostics; verdict feedback
        carries the per-round rate so the control loop stays responsive)."""
        return self.accepted / max(self.drafted, 1)


class AdmissionControl:
    """Stream registry + request queue for one replica.

    Invariants enforced here (they used to live inline in ServerEngine):

      * a device has at most ONE queued (unverdicted) request — a second
        would put the same cache row twice in one verify batch;
      * retiring or cancelling a device purges its queued request;
      * straggler-evicted requests from still-active streams are requeued
        with a fresh arrival (in-process drivers never abandon a round —
        transport clients instead cancel + force-extend on timeout).
    """

    def __init__(
        self,
        *,
        batch_size: int,
        k_max: int,
        policy: str = "continuous",
        max_wait: float = 0.050,
        straggler_timeout: float = 1.0,
        greedy: bool = True,
    ):
        self.planner = BatchPlanner(
            batch_size=batch_size,
            k_max=k_max,
            policy=policy,
            max_wait=max_wait,
            straggler_timeout=straggler_timeout,
        )
        self.batch_cap = batch_size
        self.greedy = greedy
        self.streams: Dict[int, DeviceStream] = {}
        self.timeouts = 0
        self.streams_served = 0
        self._inflight: set = set()
        self._req_id = 0

    # -- stream lifecycle ----------------------------------------------------

    def register(self, device_id: int, slot: int, prev_token: int, now: float) -> DeviceStream:
        if device_id in self.streams:
            raise ValueError(f"device {device_id} already admitted")
        stream = DeviceStream(device_id, slot, prev_token, admitted_at=now)
        self.streams[device_id] = stream
        return stream

    def adopt(self, stream: DeviceStream) -> None:
        """Take over a stream migrated from another replica (slot already
        rewritten by the caller); its history rides along untouched."""
        if stream.device_id in self.streams:
            raise ValueError(f"device {stream.device_id} already admitted")
        self.streams[stream.device_id] = stream

    def release(self, device_id: int, *, served: bool = True) -> DeviceStream:
        """Drop the stream (retire or migrate away); purges any queued
        request.  ``served=False`` (migration) skips the served counter."""
        stream = self.streams.pop(device_id)
        if device_id in self._inflight:
            self.planner.queue = type(self.planner.queue)(
                r for r in self.planner.queue if r.device_id != device_id
            )
            self._inflight.discard(device_id)
        if served:
            self.streams_served += 1
        return stream

    # -- request queue -------------------------------------------------------

    def submit(
        self,
        device_id: int,
        draft_tokens: np.ndarray,
        now: float,
        draft_q: Optional[np.ndarray] = None,
    ) -> None:
        stream = self.streams[device_id]
        if device_id in self._inflight:
            # a second in-flight request would put the same cache row twice
            # in one scatter (undefined winner) — the device must wait for
            # its verdict (EdgeDevice.awaiting mirrors this server-side)
            raise ValueError(f"device {device_id} already has a request in flight")
        if not self.greedy and draft_q is None:
            raise ValueError("sampling mode needs per-request draft_q")
        if self.greedy:
            # greedy verification ignores q — and feeding it anyway would
            # change the jitted verify batch's pytree structure and recompile
            # every bucket behind warmup()'s back
            draft_q = None
        self.planner.add(
            VerifyRequest(
                device_id=device_id,
                arrival=now,
                prev_token=stream.prev_token,
                draft_tokens=np.asarray(draft_tokens),
                draft_q=draft_q,
                request_id=self._req_id,
            )
        )
        self._inflight.add(device_id)
        self._req_id += 1

    def cancel(self, device_id: int) -> bool:
        """Withdraw the device's queued request (transport fallback protocol).
        Returns False when nothing is queued — the round already verified and
        the verdict is authoritative."""
        if device_id not in self._inflight:
            return False
        self.planner.queue = type(self.planner.queue)(
            r for r in self.planner.queue if r.device_id != device_id
        )
        self._inflight.discard(device_id)
        return True

    def resolve(self, device_id: int) -> None:
        """The device's request left the queue inside a dispatched batch."""
        self._inflight.discard(device_id)

    def has_inflight(self, device_id: int) -> bool:
        return device_id in self._inflight

    @property
    def queue_depth(self) -> int:
        return len(self.planner.queue)

    # -- dispatch ------------------------------------------------------------

    def next_batch(self, now: float) -> Optional[PlannedBatch]:
        """Ask the planner for a batch, capped at the active stream count.

        The closed-loop cap mirrors the simulator's eff_batch: never wait
        for more requests than there are active streams, otherwise the
        static policy deadlocks as soon as the first stream retires.
        Straggler-evicted requests from live streams are requeued.
        """
        self.planner.batch_size = max(1, min(self.batch_cap, len(self.streams) or 1))
        batch = self.planner.next_batch(now, server_idle=True)
        if batch is not None and telemetry.enabled():
            for req in batch.requests:
                telemetry.observe("admission_queue_wait_seconds", now - req.arrival)
            telemetry.registry().gauge("admission_queue_depth").set(self.queue_depth)
        if self.planner.dropped:
            for req in self.planner.dropped:
                if req.device_id in self.streams:
                    self.timeouts += 1
                    req.arrival = now
                    self.planner.add(req)
                else:
                    self._inflight.discard(req.device_id)
            self.planner.dropped = []
        return batch

    def next_event_hint(self, now: float) -> Optional[float]:
        return self.planner.next_event_hint(now)
