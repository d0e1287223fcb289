"""The port's tuner (``repro_torch.tuning``, ``repro_torch.launch.tune``),
held to the JAX package's.

On the fleet of tests/test_torch_fleet.py (two device classes, the JAX
class drafts bridged into a ``KitCache``): ``profile_fleet`` measures the
JAX package's per-class priors from a traced engine serve, and a nonzero
``server_latency_scale`` from the sessions' verify spans;
``score_candidate`` gives the JAX row for one fixed calibration and probe;
a tiny ``tune`` on the CPU returns a winner that validates and round-trips;
the CLI refuses a spec without a fleet and asks for the card unless given
``--device cpu``. No JAX ``tune`` runs here (its compiles take minutes on
the CPU); the port's tune runs with ``m_max`` 4 and ``sim_time`` 2.0.
"""
import dataclasses
import functools
import json
import types
from pathlib import Path

import pytest
import torch

from repro import telemetry as jax_telemetry
from repro import tuning as jax_tuning
from repro.api import System as JSystem
from repro.serving.devices import SERVERS as JAX_SERVERS
from repro.telemetry.trace import TraceEvent as JTraceEvent
from repro_torch import telemetry, tuning
from repro_torch.api import ServeSpec, System
from repro_torch.launch import tune as tune_cli
from repro_torch.serving.devices import SERVERS
from repro_torch.telemetry.trace import TraceEvent
from test_torch_fleet import _fleet_spec, fleet  # noqa: F401 - the shared fixture

ROOT = Path(__file__).resolve().parents[1]
FLEET_JSON = ROOT / "examples" / "specs" / "fleet.json"
TINY = dict(quick=True, n_validate=1, sim_time=2.0, passes=1, m_max=4)


@pytest.fixture
def telemetry_restored():
    """profile_fleet turns both packages' telemetry on; put them back."""
    was = telemetry.enabled(), jax_telemetry.enabled()
    yield
    telemetry.enable(was[0])
    jax_telemetry.enable(was[1])


def test_profile_fleet_equals_jax(fleet, telemetry_restored, monkeypatch):  # noqa: F811
    jspec, mb, _, pb, cache, prompts = fleet
    # profile_fleet serves the spec's default prompts, which each package
    # draws its own way: give both the fixture's numpy prompts
    for cls in (JSystem, System):
        monkeypatch.setattr(cls, "prompts", lambda self: prompts)
    want = jax_tuning.profile_fleet(jspec, server=JAX_SERVERS["a100x4"], target_params=11e9,
                                    models=mb)
    got = tuning.profile_fleet(_fleet_spec(), server=SERVERS["a100x4"], target_params=11e9,
                               models=pb, kits=cache, device="cpu")
    keys = ("index", "profile", "count", "k", "c_th", "acceptance", "mean_draft_len",
            "hardware_rate", "rtt_mean")
    for g, w in zip(got.classes, want.classes, strict=True):
        assert {k: getattr(g, k) for k in keys} == {k: getattr(w, k) for k in keys}
        assert g.commit_rate > 0 and g.draft_rate > 0
    assert got.classes[0].acceptance > got.classes[1].acceptance
    # measured from the sessions' verify spans: 0 when the in-process pump
    # records no trace
    assert got.verify_s_mean > 0 and got.server_latency_scale > 0
    assert got.round_latency_p95 >= got.verify_s_mean


def _calibration(pkg):
    cls = [pkg.ClassCalibration(
        index=i, profile=p, count=2, k=k, c_th=c, acceptance=a, mean_draft_len=m,
        draft_rate=d, commit_rate=r, hardware_rate=h, rtt_mean=0.0)
        for i, (p, k, c, a, m, d, r, h) in enumerate((
            ("jetson-orin-nano", 4, 0.0, 0.82, 3.6, 40.0, 55.0, 21.0),
            ("rpi4b", 2, 0.4, 0.31, 1.4, 28.0, 30.0, 3.1)))]
    return pkg.FleetCalibration(
        classes=tuple(cls), server_latency_scale=0.7, verify_s_mean=0.004, queue_s_mean=0.002,
        round_latency_mean=0.008, round_latency_p95=0.02, mean_batch_fill=2.5, wstgr=160.0)


def _probe(*, k, c_th, draft_layers, draft_noise):
    """A fixed stand-in for the reference probe: acceptance and mean draft
    length as plain functions of the draft knobs."""
    return max(0.05, 0.95 - 0.08 * k - draft_noise + 0.2 * c_th), k * (1.0 - 0.4 * c_th)


@pytest.mark.parametrize("server", ["a100x4", "h100"])
def test_score_candidate_equals_jax(server):
    jspec, pspec = _fleet_spec(jax_side=True), _fleet_spec()
    jcfg = jax_tuning.TuneConfig(**{**TINY, "server": "a100x4"})
    pcfg = tuning.TuneConfig(**{**TINY, "server": server})
    jcal, pcal = _calibration(jax_tuning), _calibration(tuning)
    assert pcal.to_json() == jcal.to_json()
    opts = tuning.search.class_options(pspec, 1, pcfg)
    assert opts == jax_tuning.search.class_options(jspec, 1, jcfg)
    for i, opt in [(None, None), (0, opts[0]), (1, opts[-1])]:
        js = jspec if i is None else jax_tuning.with_class(jspec, i, **opt)
        ps = pspec if i is None else tuning.with_class(pspec, i, **opt)
        kw = dict(deadline_s=0.03)
        assert dataclasses.asdict(tuning.sim_config_for(ps, pcal, pcfg, _probe, **kw)) == \
            dataclasses.asdict(jax_tuning.sim_config_for(js, jcal, jcfg, _probe, **kw))
        row = tuning.score_candidate(ps, pcal, pcfg, _probe, **kw)
        if server == "a100x4":
            assert row == jax_tuning.score_candidate(js, jcal, jcfg, _probe, **kw)
        else:  # the card's profile prices the same load: only the server differs
            assert row["classes"] and row["capacity_mult"] >= 0 and row["cost_per_1k_usd"] > 0


def test_trace_rates_equal_jax():
    def sessions(ev_cls, draft_s):
        return [types.SimpleNamespace(
            tokens=[0] * (3 * n), drafted=4 * n,
            trace=[ev_cls(device_id=d, round=r, t=0.1 * r + 0.03 * d, k=4, n_accepted=2,
                          n_commit=3, draft_s=draft_s) for r in range(n)])
            for d, n in enumerate((1, 3, 5))]
    for draft_s in (0.0, 0.02):
        js, ps = sessions(JTraceEvent, draft_s), sessions(TraceEvent, draft_s)
        assert tuning.class_commit_rate(ps, wall=2.0) == jax_tuning.class_commit_rate(js, wall=2.0)
        assert tuning.class_draft_rate(ps, wall=2.0) == jax_tuning.class_draft_rate(js, wall=2.0)


def test_tiny_tune_on_the_cpu_returns_a_winner_that_round_trips(telemetry_restored):
    spec = _fleet_spec()
    res = tuning.tune(spec, tuning.TuneConfig(**TINY), device="cpu", log=lambda msg: None)
    res.winner.validate()
    assert ServeSpec.from_json(res.winner.to_json()) == res.winner
    assert res.winner.fleet.total == spec.fleet.total
    assert res.deadline_s > 0 and res.rows and len(res.validated) == 2
    assert res.calibration.server_latency_scale > 0
    json.dumps(res.to_json())


def test_cli_refuses_a_spec_without_a_fleet():
    with pytest.raises(SystemExit, match="no fleet.classes"):
        tune_cli.main(["--spec", str(ROOT / "examples" / "specs" / "engine.json"),
                       "--device", "cpu"])


def test_cli_asks_for_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune_cli.main(["--spec", str(FLEET_JSON), "--quick"])


def test_cli_writes_the_winner_and_the_record(tmp_path, monkeypatch, telemetry_restored):
    # the CLI's own sweep at the tiny sizes above
    monkeypatch.setattr(tune_cli, "TuneConfig", functools.partial(
        tuning.TuneConfig, sim_time=2.0, m_max=4, passes=1))
    out, rec = tmp_path / "tuned.json", tmp_path / "bench.json"
    tune_cli.main(["--spec", str(FLEET_JSON), "--quick", "--server", "h100", "--validate", "1",
                   "--device", "cpu", "--out", str(out), "--json", str(rec)])
    winner = ServeSpec.from_json(out.read_text())
    winner.validate()
    record = json.loads(rec.read_text())
    assert record["benchmark"] == "tune" and record["quick"] is True
    assert ServeSpec.from_json(json.dumps(record["winner_spec"])) == winner
