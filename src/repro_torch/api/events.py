"""Typed streaming events and unified result records for the session API.

The port of ``repro.api.events``. A Session's ``generate()`` yields, per
round, a ``TokenEvent`` for each token committed to the stream (capped at
the session's budget), then one ``RoundEvent``, and finally one
``DoneEvent``; every backend emits the same records. The transport
client's stats and per-round traces arrive with those backends.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.engine import EngineStats


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

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    def to_json(self) -> dict:
        return {
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


@dataclasses.dataclass
class ServeResult:
    """A full fleet run: per-session results + the server's stats."""

    backend: str
    sessions: List[SessionResult]
    engine: EngineStats
    wall_seconds: float = 0.0
    # metrics snapshot; None unless telemetry was enabled for the run
    telemetry: Optional[dict] = None

    @property
    def outputs(self) -> Dict[int, List[int]]:
        """device_id -> committed tokens (the equivalence-check surface)."""
        return {s.device_id: s.tokens for s in self.sessions}

    @property
    def total_tokens(self) -> int:
        return sum(len(s.tokens) for s in self.sessions)

    def to_json(self) -> dict:
        d = {
            "backend": self.backend,
            "wall_seconds": self.wall_seconds,
            "total_tokens": self.total_tokens,
            "engine": self.engine.to_json(),
            "sessions": [s.to_json() for s in self.sessions],
        }
        if self.telemetry is not None:
            d["telemetry"] = self.telemetry
        return d
