"""Supervision primitives: capped exponential backoff with seeded jitter.

The port's copy of :class:`Backoff` from ``repro.cluster.faults``; the edge
client's reconnect paces its redials with it. The chaos harness
(``ChaosInjector``, ``FaultyChannel``) comes with the faults slice
(ROADMAP.md Queue A).
"""

from __future__ import annotations

import random


class Backoff:
    """Capped jittered exponential backoff: base * 2^n, +- jitter, <= cap.

    ``attempt()`` returns the next delay in seconds and advances; ``reset()``
    after a success. Jitter comes from a dedicated seeded Random, so two runs
    of one schedule sleep alike.
    """

    def __init__(
        self,
        base_s: float = 0.2,
        max_s: float = 5.0,
        jitter: float = 0.1,
        seed: int = 0,
    ):
        if base_s <= 0 or max_s < base_s or not 0.0 <= jitter < 1.0:
            raise ValueError(
                f"bad backoff (base_s={base_s}, max_s={max_s}, jitter={jitter})"
            )
        self.base_s = base_s
        self.max_s = max_s
        self.jitter = jitter
        self.attempts = 0
        self._rng = random.Random(seed)

    def peek(self) -> float:
        delay = min(self.base_s * (2.0 ** self.attempts), self.max_s)
        if self.jitter:
            delay *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return delay

    def attempt(self) -> float:
        delay = self.peek()
        self.attempts += 1
        return delay

    def reset(self) -> None:
        self.attempts = 0
