"""Deterministic fault injection and the supervision primitives it exercises.

The port of ``repro.cluster.faults``, three pieces:

* :class:`Backoff`: capped, jittered exponential backoff with a seeded
  jitter source, so a supervised respawn schedule (and the edge client's
  redials) repeat exactly from run to run;
* :class:`FaultyChannel`: a ControlChannel wrapper the injector arms to
  drop, delay or flap control-plane RPCs without touching the worker;
* :class:`ChaosInjector`: runs a :class:`~repro_torch.api.spec.FaultSpec`
  schedule against a live Router: each event fires when the Router's step
  counter reaches its ``round`` (kill and hang act on the replica; drop,
  delay and flap arm its FaultyChannel).

Faults go through the surfaces real failures use (SIGKILL, a severed
socket, an RPC that raises), so the recovery paths chaos tests are the
ones a real fault takes.
"""

from __future__ import annotations

import logging
import random
import time
from typing import List, Optional

from repro_torch.cluster.remote import ReplicaGone

log = logging.getLogger(__name__)


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


class FaultyChannel:
    """ControlChannel wrapper with armable fault modes (chaos injection).

    Transparent until armed; then the next ``drop_n`` requests raise
    :class:`ReplicaGone` (the frame is lost before the worker sees it), the
    next ``delay_n`` requests stall ``delay_s`` each before going out, and
    ``flap()`` severs the link once, so exactly one request fails and the
    next reconnect heals (what the one-shot retry absorbs). ``kill()`` is
    terminal: every request fails until the channel is replaced, which is
    what a crashed worker looks like from the dialing side.
    """

    def __init__(self, inner):
        self.inner = inner
        self.drop_n = 0
        self.delay_n = 0
        self.delay_s = 0.0
        self.killed = False
        self.dropped = 0
        self.delayed = 0

    # -- chaos arms ----------------------------------------------------------

    def arm_drop(self, n: int) -> None:
        self.drop_n += int(n)

    def arm_delay(self, n: int, delay_s: float) -> None:
        self.delay_n += int(n)
        self.delay_s = float(delay_s)

    def flap(self) -> None:
        """One transient failure, then healthy: drop exactly one RPC and
        sever the socket, so the retry has to reconnect."""
        self.drop_n += 1

    def kill(self) -> None:
        self.killed = True
        self.inner.close()

    def hang(self) -> None:
        """A silent peer: every RPC stalls for an hour."""
        self.delay_n = 1 << 30
        self.delay_s = 3600.0

    # -- the ControlChannel surface ------------------------------------------

    @property
    def address(self) -> str:
        return self.inner.address

    @property
    def timeout(self) -> float:
        return self.inner.timeout

    @property
    def connected(self) -> bool:
        return self.inner.connected

    def next_seq(self) -> int:
        return self.inner.next_seq()

    def _refuse_if_killed(self) -> None:
        if self.killed:
            raise ReplicaGone(f"worker at {self.address} is chaos-killed")

    def connect(self) -> None:
        self._refuse_if_killed()
        self.inner.connect()

    def reconnect(self) -> None:
        self._refuse_if_killed()
        self.inner.reconnect()

    def close(self) -> None:
        self.inner.close()

    def request(self, msg, *, timeout: Optional[float] = None):
        self._refuse_if_killed()
        if self.drop_n > 0:
            self.drop_n -= 1
            self.dropped += 1
            self.inner.close()  # the frame never made it: the link looks severed
            raise ReplicaGone(f"chaos: control frame to {self.address} dropped "
                              f"({type(msg).__name__})")
        if self.delay_n > 0:
            self.delay_n -= 1
            self.delayed += 1
            time.sleep(self.delay_s)
        return self.inner.request(msg, timeout=timeout)


class ChaosInjector:
    """Runs a seeded FaultSpec schedule against a live Router.

    The Router calls :meth:`on_step` with its step counter before every
    cluster step; events whose ``round`` has come fire once, in schedule
    order. Kill and hang act on the replica (SIGKILL / SIGSTOP for a worker
    process, channel-level equivalents otherwise); drop, delay and flap arm
    the replica's FaultyChannel, and raise if the channel was never
    wrapped: a chaos spec that does nothing unnoticed is worse than one
    that fails.
    """

    def __init__(self, fault_spec, router):
        self.spec = fault_spec
        self.router = router
        self.fired: List[tuple] = []  # (round, kind, replica), for the report
        self._pending = sorted(fault_spec.events, key=lambda e: (e.round, e.replica, e.kind))

    @property
    def done(self) -> bool:
        return not self._pending

    def on_step(self, step_no: int) -> None:
        while self._pending and self._pending[0].round <= step_no:
            self._fire(self._pending.pop(0), step_no)

    def _fire(self, ev, step_no: int) -> None:
        replica = self.router.replicas[ev.replica]
        log.warning("chaos: firing %s on replica %d at step %d", ev.kind, ev.replica, step_no)
        if ev.kind in ("kill", "hang"):
            act = getattr(replica, f"chaos_{ev.kind}", None)
            if act is None:
                raise RuntimeError(f"replica {ev.replica} ({type(replica).__name__}) does not "
                                   f"support chaos kind {ev.kind!r}")
            act()
        else:  # drop / delay / flap: needs a FaultyChannel on the link
            chan = getattr(replica, "channel", None)
            if not isinstance(chan, FaultyChannel):
                raise RuntimeError(
                    f"chaos kind {ev.kind!r} targets replica {ev.replica} but its control "
                    f"channel is not a FaultyChannel (build the system with a fault schedule "
                    f"so channels get wrapped)")
            if ev.kind == "drop":
                chan.arm_drop(ev.count)
            elif ev.kind == "delay":
                chan.arm_delay(ev.count, ev.delay_s)
            else:  # flap
                for _ in range(ev.count):
                    chan.flap()
        self.fired.append((step_no, ev.kind, ev.replica))
