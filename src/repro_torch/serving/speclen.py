"""Closed-loop adaptive speculation length (bounded AIMD).

The port's copy of ``repro.serving.speclen`` (pure Python, unchanged but
for its imports).

SLED's ConfigSpec picks a static draft length per device class offline; the
heterogeneous-edge result (PAPERS.md, arXiv:2510.11331) is that the right
``k`` drifts at runtime with acceptance and server congestion.  The v2
Verdict frames feed back exactly those two signals — the round's
draft-acceptance ratio (per-round, so regime shifts register immediately;
this controller's EWMA does the smoothing) and the serving replica's queue
depth — and this controller closes the loop device-side:

  * additive increase  — acceptance high AND the replica queue shallow:
    speculation is paying, draft one more token per round (up to ``k_max``);
  * multiplicative decrease — acceptance low OR the queue deep: wrong drafts
    (or an oversubscribed replica) burn server verify compute, so halve the
    round length (down to ``k_min``).

AIMD keeps the control stable under the same argument as congestion control:
increases probe linearly, wrong guesses back off geometrically, and the
bounds make the worst case exactly the fixed-``k`` policies it replaces
(``k_min == k_max`` degenerates to fixed).  Acceptance is EWMA-smoothed so a
single unlucky round doesn't collapse ``k``.

Host-side and deterministic: the draft round always runs ``k_max`` steps
and the proposal is truncated to ``k`` host-side (EdgeDevice.draft(k=...)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch import telemetry


@dataclasses.dataclass
class SpecLenController:
    """Bounded AIMD controller for the per-device speculation length ``k``.

    ``update(accept_rate, queue_depth)`` is called once per verdict and
    returns the length to draft next round.  All thresholds are plain
    constructor knobs so benchmarks can sweep them (ConfigSpec-style, but
    online).
    """

    k_max: int
    k_min: int = 1
    k_init: Optional[int] = None  # None: start at k_max (optimistic probe)
    increase: int = 1  # additive step up
    decrease: float = 0.5  # multiplicative back-off factor
    accept_hi: float = 0.7  # smoothed acceptance to justify a longer round
    accept_lo: float = 0.4  # below this, drafts are burning verify compute
    queue_hi: int = 2  # replica queue depth that reads as congestion
    ewma: float = 0.5  # smoothing on the acceptance feedback

    def __post_init__(self) -> None:
        if not (1 <= self.k_min <= self.k_max):
            raise ValueError(f"need 1 <= k_min <= k_max, got [{self.k_min}, {self.k_max}]")
        self.k = min(self.k_init or self.k_max, self.k_max)
        self.k = max(self.k, self.k_min)
        self._acc: Optional[float] = None
        self.updates = 0
        self.increases = 0
        self.decreases = 0

    @property
    def smoothed_accept(self) -> float:
        return self._acc if self._acc is not None else 1.0

    def update(self, accept_rate: float, queue_depth: int) -> int:
        """One feedback observation -> the next round's draft length."""
        a = float(accept_rate)
        self._acc = a if self._acc is None else self.ewma * a + (1 - self.ewma) * self._acc
        self.updates += 1
        congested = queue_depth > self.queue_hi
        if congested or self._acc < self.accept_lo:
            new_k = max(self.k_min, int(self.k * self.decrease))
            if new_k < self.k:
                self.decreases += 1
                telemetry.count("kctl_decrease_total")
            self.k = new_k
        elif self._acc >= self.accept_hi:
            new_k = min(self.k_max, self.k + self.increase)
            if new_k > self.k:
                self.increases += 1
                telemetry.count("kctl_increase_total")
            self.k = new_k
        telemetry.observe("kctl_k", self.k, buckets=telemetry.K_BUCKETS)
        return self.k


def make_controller(kctl: str, *, k_max: int, **kw) -> Optional[SpecLenController]:
    """``adaptive`` -> a controller, ``fixed`` -> None (draft k_max always)."""
    if kctl == "fixed":
        return None
    if kctl == "adaptive":
        return SpecLenController(k_max=k_max, **kw)
    raise ValueError(f"unknown kctl {kctl!r} (fixed | adaptive)")


@dataclasses.dataclass
class ConfidenceController:
    """Bounded additive controller for the drafting confidence ``c_th``.

    The dual of :class:`SpecLenController`: where ``k`` caps how MANY tokens
    a round may draft, ``c_th`` decides how SURE the draft model must be to
    keep going (Eq. 1 — drafting stops early once the proposal's confidence
    drops below the threshold).  This closes the loop from the same v2
    Verdict feedback:

      * acceptance high AND the replica queue shallow — the draft model is
        trustworthy, so LOWER the bar and let rounds run deeper;
      * acceptance low OR the queue deep — low-confidence speculation is
        burning server verify compute, so RAISE the bar and only ship tokens
        the draft model is sure about.

    Additive steps in both directions (c_th lives on a bounded interval, so
    the AIMD asymmetry that stabilizes ``k`` is unnecessary); acceptance is
    EWMA-smoothed exactly like the k controller.  ``c_th`` is an argument of
    each draft round (EdgeDevice.draft(c_th=...)).
    """

    c_init: float = 0.3
    c_min: float = 0.0
    c_max: float = 0.95
    step: float = 0.05  # additive step in both directions
    accept_hi: float = 0.75  # above: relax the bar, draft deeper rounds
    accept_lo: float = 0.45  # below: tighten, only confident tokens go out
    queue_hi: int = 2  # replica queue depth that reads as congestion
    ewma: float = 0.5  # smoothing on the acceptance feedback
    device_id: int = -1  # labels the per-device telemetry gauge (-1: unlabeled)

    def __post_init__(self) -> None:
        if not (0.0 <= self.c_min <= self.c_max <= 1.0):
            raise ValueError(
                f"need 0 <= c_min <= c_max <= 1, got [{self.c_min}, {self.c_max}]")
        self.c = min(max(self.c_init, self.c_min), self.c_max)
        self._acc: Optional[float] = None
        self.updates = 0
        self.raises = 0
        self.lowers = 0
        self._c_sum = 0.0

    @property
    def smoothed_accept(self) -> float:
        return self._acc if self._acc is not None else 1.0

    @property
    def c_mean(self) -> float:
        return self._c_sum / self.updates if self.updates else self.c

    def update(self, accept_rate: float, queue_depth: int) -> float:
        """One feedback observation -> the next round's confidence bar."""
        a = float(accept_rate)
        self._acc = a if self._acc is None else self.ewma * a + (1 - self.ewma) * self._acc
        self.updates += 1
        congested = queue_depth > self.queue_hi
        if congested or self._acc < self.accept_lo:
            new_c = min(self.c_max, self.c + self.step)
            if new_c > self.c:
                self.raises += 1
                telemetry.count("cctl_raise_total")
            self.c = new_c
        elif self._acc >= self.accept_hi:
            new_c = max(self.c_min, self.c - self.step)
            if new_c < self.c:
                self.lowers += 1
                telemetry.count("cctl_lower_total")
            self.c = new_c
        self._c_sum += self.c
        telemetry.observe("cctl_c_th", self.c, buckets=telemetry.C_TH_BUCKETS)
        if telemetry.enabled():
            telemetry.registry().gauge(
                "client_c_th",
                labels={"device": str(self.device_id)} if self.device_id >= 0 else None,
            ).set(self.c)
        return self.c


def make_confidence_controller(
    cctl: str, *, c_init: float, device_id: int = -1, **kw
) -> Optional[ConfidenceController]:
    """``adaptive`` -> a controller seeded at the spec's c_th, ``fixed`` -> None."""
    if cctl == "fixed":
        return None
    if cctl == "adaptive":
        return ConfidenceController(c_init=c_init, device_id=device_id, **kw)
    raise ValueError(f"unknown cctl {cctl!r} (fixed | adaptive)")
