"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

The port's own copy of ``repro.telemetry.metrics``: the registry renders a
Prometheus-style text exposition (``exposition()``, byte for byte the JAX
package's, ``repro_`` prefix included, so one scrape configuration reads
both) and a JSON snapshot (``snapshot()``), which is what crosses process
boundaries inside ``ReplicaStats`` telemetry payloads.

Everything here is observation-only and cheap: a metric update is a dict hit
plus a locked float add, and the :func:`span` context manager short-circuits
to a shared no-op object while telemetry is disabled, so instrumenting a
host-side boundary costs one global-flag check per round when off.  Nothing
in this module ever runs inside a jitted computation.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple, Union

# default span buckets: sub-millisecond device hops up through multi-second
# straggler rounds (seconds, ascending; +Inf is implicit)
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
# speculation-length buckets: k is small and integral
K_BUCKETS: Tuple[float, ...] = (1, 2, 3, 4, 6, 8, 12, 16)
# drafting-confidence buckets: c_th lives on [0, 1]
C_TH_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0,
)

_LabelArg = Optional[Dict[str, Union[str, int]]]
_Key = Tuple[str, Tuple[Tuple[str, str], ...]]

_LOCK = threading.Lock()  # shared by every metric: updates are rare (per
# round, host-side) and the critical section is a float add


def _label_items(labels: _LabelArg) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(items: Sequence[Tuple[str, str]]) -> str:
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


def _prom_name(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return out if out.startswith("repro_") else f"repro_{out}"


class Counter:
    """Monotonically increasing count."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "_value")

    def __init__(self, name: str, help: str = "", labels: _LabelArg = None):
        self.name = name
        self.help = help
        self.labels = _label_items(labels)
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with _LOCK:
            self._value += v

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value (set or adjusted)."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "_value")

    def __init__(self, name: str, help: str = "", labels: _LabelArg = None):
        self.name = name
        self.help = help
        self.labels = _label_items(labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with _LOCK:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with _LOCK:
            self._value += v

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (Prometheus-style cumulative exposition).

    Buckets are upper bounds in ascending order; observations above the last
    bound land in the implicit +Inf bucket.  ``quantile`` interpolates inside
    the winning bucket, which is as precise as a fixed-bucket histogram gets —
    good enough for a p50/p95 column in ``repro top``.
    """

    kind = "histogram"
    __slots__ = ("name", "help", "labels", "buckets", "counts", "sum", "count")

    def __init__(
        self,
        name: str,
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
        help: str = "",
        labels: _LabelArg = None,
    ):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram buckets must be ascending, got {buckets!r}")
        self.name = name
        self.help = help
        self.labels = _label_items(labels)
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        n = len(self.buckets)
        while i < n and v > self.buckets[i]:
            i += 1
        with _LOCK:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0..1) by interpolating within buckets."""
        if not self.count:
            return 0.0
        target = q * self.count
        cum = 0
        lo = 0.0
        for i, ub in enumerate(self.buckets):
            prev = cum
            cum += self.counts[i]
            if cum >= target:
                frac = (target - prev) / max(self.counts[i], 1)
                return lo + frac * (ub - lo)
            lo = ub
        return self.buckets[-1]  # fell in +Inf: clamp to the last finite bound

    def to_json(self) -> dict:
        cum, rows = 0, []
        for i, ub in enumerate(self.buckets):
            cum += self.counts[i]
            rows.append([ub, cum])
        rows.append(["+Inf", cum + self.counts[-1]])
        return {
            "sum": self.sum,
            "count": self.count,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "buckets": rows,
        }


class MetricsRegistry:
    """Name+labels → metric, with get-or-create semantics.

    One registry per process (module-level default in
    :mod:`repro.telemetry`); workers ship their registry's ``snapshot()``
    back over the control plane inside ``ReplicaStats``.
    """

    def __init__(self) -> None:
        self._metrics: Dict[_Key, Union[Counter, Gauge, Histogram]] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: _LabelArg, **kw):
        key = (name, _label_items(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels=labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, not {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "", labels: _LabelArg = None) -> Counter:
        return self._get(Counter, name, labels, help=help)

    def gauge(self, name: str, help: str = "", labels: _LabelArg = None) -> Gauge:
        return self._get(Gauge, name, labels, help=help)

    def histogram(
        self,
        name: str,
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
        help: str = "",
        labels: _LabelArg = None,
    ) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets, help=help)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """JSON-shaped dump: {counters, gauges, histograms} keyed by
        ``name`` or ``name{label="v"}``."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            key = m.name + _fmt_labels(m.labels)
            if isinstance(m, Histogram):
                out["histograms"][key] = m.to_json()
            elif isinstance(m, Counter):
                out["counters"][key] = m.value
            else:
                out["gauges"][key] = m.value
        return out

    def exposition(self) -> str:
        """Prometheus text-format exposition of every registered metric."""
        with self._lock:
            metrics = sorted(
                self._metrics.values(), key=lambda m: (m.name, m.labels)
            )
        lines = []
        seen_header = set()
        for m in metrics:
            pname = _prom_name(m.name)
            if pname not in seen_header:
                seen_header.add(pname)
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for i, ub in enumerate(m.buckets):
                    cum += m.counts[i]
                    lbl = _fmt_labels(m.labels + (("le", repr(ub)),))
                    lines.append(f"{pname}_bucket{lbl} {cum}")
                lbl = _fmt_labels(m.labels + (("le", "+Inf"),))
                lines.append(f"{pname}_bucket{lbl} {cum + m.counts[-1]}")
                base = _fmt_labels(m.labels)
                lines.append(f"{pname}_sum{base} {m.sum}")
                lines.append(f"{pname}_count{base} {m.count}")
            else:
                lines.append(f"{pname}{_fmt_labels(m.labels)} {m.value}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# the process-global registry + enable switch, and the span primitive
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()
_ENABLED = False


def registry() -> MetricsRegistry:
    return _REGISTRY


def enable(on: bool = True) -> None:
    """Flip telemetry collection for this process (spans + traces).

    Off by default: instrumented call sites pay one flag check per round.
    ``System.build`` turns it on when the spec says ``telemetry: true`` (and
    a worker does the same when placed with such a spec); benchmarks flip it
    both ways to measure overhead.
    """
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "labels", "t0", "seconds")

    def __init__(self, name: str, labels: _LabelArg):
        self.name = name
        self.labels = labels
        self.t0 = 0.0
        self.seconds = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        _REGISTRY.histogram(self.name, labels=self.labels).observe(self.seconds)
        return False


def span(name: str, labels: _LabelArg = None):
    """Monotonic-clock span → histogram ``name``; a shared no-op when
    telemetry is disabled.  Host-side boundaries only — never wrap jitted
    code with this (the span would time dispatch, not compute)."""
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name, labels)


def observe(name: str, value: float, buckets: Sequence[float] = LATENCY_BUCKETS_S,
            labels: _LabelArg = None) -> None:
    """Record one histogram observation iff telemetry is enabled."""
    if _ENABLED:
        _REGISTRY.histogram(name, buckets=buckets, labels=labels).observe(value)


def count(name: str, v: float = 1.0, labels: _LabelArg = None) -> None:
    """Bump a counter iff telemetry is enabled."""
    if _ENABLED:
        _REGISTRY.counter(name, labels=labels).inc(v)
