"""Per-round trace records and the bounded flight recorder.

The port of ``repro.telemetry.trace``. A :class:`TraceEvent` is the
round-level record every layer speaks: the engine stamps queue and verify
spans, the Router adds the serving replica, and an edge client its own
draft and wire attribution (the round trip minus the server's spans is
time on the wire).

A :class:`FlightRecorder` is a bounded ring of the most recent rounds: the
engine keeps one, and the Router one per replica, so an eviction's report
carries the replica's last rounds even when its worker died without
answering another RPC.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Iterable, List


@dataclasses.dataclass
class TraceEvent:
    """One resolved round of one stream, with its span breakdown (seconds).
    Fields a given layer cannot know keep their defaults."""

    device_id: int
    round: int  # 0-based round seq within the stream
    t: float  # engine/client clock at verdict time (run-relative seconds)
    k: int  # tokens drafted this round
    n_accepted: int
    n_commit: int  # tokens committed (accepted + bonus/correction)
    queue_s: float = 0.0  # admission-queue wait (server-side)
    verify_s: float = 0.0  # verify step wall time (server-side)
    wire_s: float = 0.0  # round-trip minus server time (client-side)
    draft_s: float = 0.0  # device draft time (client-side)
    replica: int = -1  # serving replica index (-1: unknown / single engine)
    fallback: bool = False  # §III-A locally-released round

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "TraceEvent":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class FlightRecorder:
    """Bounded ring buffer of the most recent :class:`TraceEvent`s."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"flight recorder needs capacity >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: Deque[TraceEvent] = deque(maxlen=capacity)

    def record(self, ev: TraceEvent) -> None:
        self._ring.append(ev)

    def extend(self, evs: Iterable[TraceEvent]) -> None:
        self._ring.extend(evs)

    def events(self) -> List[TraceEvent]:
        return list(self._ring)

    def dump(self) -> List[dict]:
        """The ring as JSON-shaped rows, oldest first."""
        return [ev.to_json() for ev in self._ring]

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)
