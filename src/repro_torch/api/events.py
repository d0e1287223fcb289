"""Typed streaming events and unified result records for the session API.

The port of ``repro.api.events``. A Session's ``generate()`` yields, per
round, a ``TokenEvent`` for each token committed to the stream (capped at
the session's budget), then one ``RoundEvent``, and finally one
``DoneEvent``; every backend emits the same records. A transport session's
result also carries its client's stats and per-round trace.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.engine import EngineStats
from repro_torch.transport.client import ClientStats


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One token committed to a stream (``index`` = position in the stream)."""

    device_id: int
    token: int
    index: int


@dataclasses.dataclass(frozen=True)
class RoundEvent:
    """One resolved drafting round (verification verdict or §III-A fallback)."""

    device_id: int
    round: int  # 0-based round index within the session
    n_drafted: int
    n_accepted: int  # verified acceptances only; 0 on fallback rounds
    tokens: Tuple[int, ...]  # committed this round
    fallback: bool = False


@dataclasses.dataclass(frozen=True)
class DoneEvent:
    """The session reached its token budget (or the stream closed)."""

    device_id: int
    n_tokens: int


Event = Union[TokenEvent, RoundEvent, DoneEvent]


@dataclasses.dataclass
class SessionResult:
    """One stream's unified outcome, identical in shape across backends."""

    device_id: int
    tokens: List[int]
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    fallback_rounds: int = 0
    fallback_tokens: int = 0
    wall_seconds: float = 0.0
    # the stream went down with an evicted replica and could not be
    # re-placed: ``tokens`` holds what was committed before the loss, and
    # the session ended with an explicit rejection instead of a hang
    shed: bool = False
    client: Optional[ClientStats] = None  # transport backend only
    # per-round TraceEvents of a transport session's client (telemetry on)
    trace: List = dataclasses.field(default_factory=list)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    def to_json(self) -> dict:
        d = {
            "device_id": self.device_id,
            "n_tokens": len(self.tokens),
            "tokens": [int(t) for t in self.tokens],
            "rounds": self.rounds,
            "drafted": self.drafted,
            "accepted": self.accepted,
            "acceptance_rate": self.acceptance_rate,
            "fallback_rounds": self.fallback_rounds,
            "fallback_tokens": self.fallback_tokens,
            "wall_seconds": self.wall_seconds,
        }
        if self.shed:
            d["shed"] = True
        if self.client is not None:
            d["client"] = self.client.to_json()
        if self.trace:
            d["trace"] = [ev.to_json() for ev in self.trace]
        return d


@dataclasses.dataclass
class ServeResult:
    """A full fleet run: per-session results + merged server/client stats."""

    backend: str
    sessions: List[SessionResult]
    engine: EngineStats
    clients: Optional[ClientStats] = None  # ClientStats.merge over the fleet
    wall_seconds: float = 0.0
    # devices whose streams were shed with an evicted replica (the Router's
    # supervision); empty on fault-free runs and when recovery re-placed
    # every stream
    lost_devices: List[int] = dataclasses.field(default_factory=list)
    # metrics snapshot and flight-recorder rows; None unless telemetry was
    # enabled for the run
    telemetry: Optional[dict] = None

    @property
    def outputs(self) -> Dict[int, List[int]]:
        """device_id -> committed tokens (the equivalence-check surface)."""
        return {s.device_id: s.tokens for s in self.sessions}

    @property
    def total_tokens(self) -> int:
        return sum(len(s.tokens) for s in self.sessions)

    @property
    def trace(self) -> List:
        """Fleet-wide per-round trace: every session's TraceEvents, in
        session order (sort by ``.t`` for a global timeline)."""
        return [ev for s in self.sessions for ev in s.trace]

    def to_json(self) -> dict:
        d = {
            "backend": self.backend,
            "wall_seconds": self.wall_seconds,
            "total_tokens": self.total_tokens,
            "engine": self.engine.to_json(),
            "sessions": [s.to_json() for s in self.sessions],
        }
        if self.lost_devices:
            d["lost_devices"] = [int(x) for x in self.lost_devices]
        if self.clients is not None:
            d["clients"] = self.clients.to_json()
        if self.telemetry is not None:
            d["telemetry"] = self.telemetry
        return d
