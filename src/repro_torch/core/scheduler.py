"""Server-side batch planner (SLED §III-B) + timeout/straggler policies.

The port's own copy of ``repro.core.scheduler`` (host-side, tensor-free).

The paper's implementation uses *static batching*: verification requests
queue until a fixed batch size is reached, then a batch planner pads token
lengths and dispatches one verification forward pass.  We implement that
faithfully, plus two beyond-paper policies the paper lists as future work
("adaptive queue and batching strategy ... for better server utilization"):

  * ``continuous`` — dispatch whatever is queued whenever the target model
    is idle (up to batch_size), vLLM-style.
  * ``deadline``   — static batching with a max-wait: a partially filled
    batch is dispatched once its oldest request has waited ``max_wait``.

Straggler mitigation: requests whose device link stalls past
``straggler_timeout`` are dropped from the queue (the device falls back to
local drafts per §III-A's timeout protocol) rather than holding the batch.

All host-side, deterministic, and driven either by the discrete-event
simulator (serving/simulator.py) or a real serving loop (launch/serve.py).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np


@dataclasses.dataclass
class VerifyRequest:
    device_id: int
    arrival: float            # seconds
    prev_token: int
    draft_tokens: np.ndarray  # (k,) variable length <= k_max
    draft_q: Optional[np.ndarray] = None
    request_id: int = 0

    @property
    def k(self) -> int:
        return len(self.draft_tokens)


@dataclasses.dataclass
class PlannedBatch:
    requests: List[VerifyRequest]
    dispatch_time: float
    k_max: int

    @property
    def size(self) -> int:
        return len(self.requests)

    def padded_arrays(self):
        """The paper's padding step: equalize token lengths across the batch."""
        B = len(self.requests)
        toks = np.zeros((B, self.k_max), np.int32)
        qs = np.zeros((B, self.k_max), np.float32)
        lens = np.zeros((B,), np.int32)
        prev = np.zeros((B,), np.int32)
        for i, r in enumerate(self.requests):
            k = min(r.k, self.k_max)
            toks[i, :k] = r.draft_tokens[:k]
            if r.draft_q is not None:
                qs[i, :k] = r.draft_q[:k]
            lens[i] = k
            prev[i] = r.prev_token
        return prev, toks, qs, lens


class BatchPlanner:
    def __init__(
        self,
        batch_size: int,
        k_max: int,
        policy: str = "static",       # static | continuous | deadline
        max_wait: float = 0.050,      # deadline policy: oldest-request wait cap
        straggler_timeout: float = 1.0,
    ):
        assert policy in ("static", "continuous", "deadline")
        self.batch_size = batch_size
        self.k_max = k_max
        self.policy = policy
        self.max_wait = max_wait
        self.straggler_timeout = straggler_timeout
        self.queue: Deque[VerifyRequest] = deque()
        self.dropped: List[VerifyRequest] = []

    def add(self, req: VerifyRequest) -> None:
        self.queue.append(req)

    def _evict_stragglers(self, now: float) -> None:
        kept: Deque[VerifyRequest] = deque()
        for r in self.queue:
            if now - r.arrival > self.straggler_timeout:
                self.dropped.append(r)  # device falls back per §III-A timeout
            else:
                kept.append(r)
        self.queue = kept

    def next_batch(self, now: float, server_idle: bool) -> Optional[PlannedBatch]:
        """Called by the event loop; returns a batch to dispatch or None."""
        self._evict_stragglers(now)
        if not self.queue:
            return None
        if self.policy == "static":
            if len(self.queue) < self.batch_size:
                return None
        elif self.policy == "deadline":
            oldest_wait = now - self.queue[0].arrival
            if len(self.queue) < self.batch_size and oldest_wait < self.max_wait:
                return None
        elif self.policy == "continuous":
            if not server_idle:
                return None
        n = min(self.batch_size, len(self.queue))
        reqs = [self.queue.popleft() for _ in range(n)]
        return PlannedBatch(requests=reqs, dispatch_time=now, k_max=self.k_max)

    def next_event_hint(self, now: float) -> Optional[float]:
        """Earliest future time at which a deadline/straggler fires."""
        times = []
        for r in self.queue:
            times.append(r.arrival + self.straggler_timeout)
            if self.policy == "deadline":
                times.append(r.arrival + self.max_wait)
        future = [t for t in times if t > now]
        return min(future) if future else None
