"""repro_torch.telemetry: the metrics half of the JAX package's telemetry.

Off by default; ``System.build`` turns it on when the spec says
``telemetry: true``. Spans wrap host-side boundaries only.
"""

from repro_torch.telemetry.metrics import (
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

__all__ = [
    "K_BUCKETS",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "count",
    "enable",
    "enabled",
    "observe",
    "registry",
    "span",
]
