"""repro_torch.tuning — profiling-driven auto-configuration of heterogeneous
fleets (``python -m repro_torch.launch.tune``), the port of ``repro.tuning``.

    profile.py   measure: a short telemetry-on serve calibrates per-class
                 acceptance/draft-length priors and the server latency
                 scale; tiny reference probes price candidate draft configs
    search.py    decide: coordinate-descent sweep of per-class (k, c_th,
                 draft model, bits) candidates through the calibrated
                 simulator + Eq. 2 cost model, validated on the real engine

Every serve runs on ``device`` ("cuda" unless the caller asks for the CPU).
"""

from repro_torch.tuning.profile import (
    ClassCalibration,
    FleetCalibration,
    class_commit_rate,
    class_draft_rate,
    make_prober,
    probe_draft_config,
    profile_fleet,
)
from repro_torch.tuning.search import (
    TuneConfig,
    TuneResult,
    at_multiplier,
    measured_run,
    scaled_fleet,
    score_candidate,
    sim_config_for,
    sim_fleet_capacity,
    tune,
    with_class,
)

__all__ = [
    "ClassCalibration",
    "FleetCalibration",
    "TuneConfig",
    "TuneResult",
    "at_multiplier",
    "class_commit_rate",
    "class_draft_rate",
    "make_prober",
    "measured_run",
    "probe_draft_config",
    "profile_fleet",
    "scaled_fleet",
    "score_candidate",
    "sim_config_for",
    "sim_fleet_capacity",
    "tune",
    "with_class",
]
