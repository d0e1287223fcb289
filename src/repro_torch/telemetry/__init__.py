"""repro_torch.telemetry: the port of the JAX package's telemetry.

Off by default; ``System.build`` turns it on when the spec says
``telemetry: true``. Spans wrap host-side boundaries only. ``TraceEvent``
is the per-round record; a ``FlightRecorder`` keeps the last rounds of an
engine or of each replica behind a Router. ``setup_logging`` configures
the ``repro_torch`` logger root; ``top`` (``repro_torch.telemetry.top``)
polls workers over the control plane.
"""

from repro_torch.telemetry.logs import setup_logging
from repro_torch.telemetry.metrics import (
    C_TH_BUCKETS,
    K_BUCKETS,
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    count,
    enable,
    enabled,
    observe,
    registry,
    span,
)
from repro_torch.telemetry.trace import FlightRecorder, TraceEvent

__all__ = [
    "C_TH_BUCKETS",
    "FlightRecorder",
    "K_BUCKETS",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "count",
    "enable",
    "enabled",
    "observe",
    "registry",
    "setup_logging",
    "span",
    "TraceEvent",
]
