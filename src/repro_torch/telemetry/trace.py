"""Per-round trace records.

The port's copy of ``repro.telemetry.trace``'s :class:`TraceEvent`, the
round-level record an edge client keeps of each resolved round: the server's
queue and verify spans from the verdict, and the client's own draft and wire
attribution (the round trip minus the server's spans is time on the wire).
The flight recorder comes with the faults slice (ROADMAP.md Queue A).
"""

from __future__ import annotations

import dataclasses


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
