"""The port's simulator, cost model, server profiles and paper configs,
held to the JAX package.

``repro_torch.serving.{simulator,cost_model,devices}`` and
``repro_torch.configs.sled_paper`` are host-side copies of the JAX
modules, so each is held to exact equality: the same ``SimConfig`` with the
same seed gives the JAX package's ``SimResult`` field for field (both draw
from Python's ``random``), the cost model the same floats, the JAX server
profiles the same numbers, and the paper's four configs the same fields
and parameter counts. Every case runs in well under a second.
"""
import dataclasses
import math

import pytest

from repro.configs import base as jax_base
from repro.serving import cost_model as jax_cost
from repro.serving import devices as jax_devices
from repro.serving import simulator as jax_sim
from repro_torch.configs import base as port_base
from repro_torch.serving import cost_model as port_cost
from repro_torch.serving import devices as port_devices
from repro_torch.serving import simulator as port_sim

PAPER = ("llama-1b-draft", "llama-3b-draft", "llama-11b-target", "llama-70b-target")
TWO_CLASSES = (dict(count=3, device_rate=21.0, spec_len=4, acceptance=0.8, rtt_mean=0.01),
               dict(count=5, device_rate=3.1, spec_len=2, acceptance=0.4))
# (label, SimConfig fields): every mode and batch policy, loss, dynamic
# drafting, a two-class fleet with a deadline
SIM_CASES = [
    ("sled-static", dict(mode="sled", batch_policy="static")),
    ("sled-deadline", dict(mode="sled", batch_policy="deadline", max_wait=0.03)),
    ("sled-continuous", dict(mode="sled", batch_policy="continuous", n_devices=12)),
    ("centralized-static", dict(mode="centralized", batch_policy="static")),
    ("centralized-deadline", dict(mode="centralized", batch_policy="deadline")),
    ("centralized-continuous", dict(mode="centralized", batch_policy="continuous")),
    ("all_edge", dict(mode="all_edge", n_devices=5)),
    ("drop", dict(drop_prob=0.1, verify_timeout=0.2, seed=3)),
    ("dynamic", dict(dynamic=True, c_th_mean_len=2.5, acceptance=0.6)),
    ("classes-deadline", dict(batch_policy="continuous", deadline_s=0.05, seed=1)),
    ("paper-11b-b8", dict(n_devices=64 * 8, server_batch=8, device_rate=3.4,
                          draft_model_params=3e9, acceptance=0.9)),
]


def _sim_config(pkg, fields: dict, label: str):
    kw = {"sim_time": 3.0, **fields}
    if label.startswith("classes"):
        kw["classes"] = tuple(pkg.ClassLoad(**c) for c in TWO_CLASSES)
    return pkg.SimConfig(**kw)


@pytest.mark.parametrize("server", ["a100x4", "v5e-16"])
@pytest.mark.parametrize("label,fields", SIM_CASES, ids=[c[0] for c in SIM_CASES])
def test_simulate_equals_jax(label, fields, server):
    want = jax_sim.simulate(_sim_config(jax_sim, fields, label), jax_devices.SERVERS[server])
    got = port_sim.simulate(_sim_config(port_sim, fields, label), port_devices.SERVERS[server])
    assert got.as_dict() == want.as_dict()
    assert got.rounds > 0 or label == "all_edge"
    if label.startswith("classes"):
        assert len(got.class_device_rates) == 2


def test_capacity_equals_jax_and_refuses_classes():
    kw = dict(acceptance=0.8, device_rate=8.2, server_batch=16, batch_policy="continuous")
    want = jax_sim.capacity(jax_sim.SimConfig(**kw), jax_devices.A100_X4, n_max=48,
                            probe_time=2.0)
    got = port_sim.capacity(port_sim.SimConfig(**kw), port_devices.A100_X4, n_max=48,
                            probe_time=2.0)
    assert got == want and 1 <= got <= 48
    for pkg, devs in ((jax_sim, jax_devices), (port_sim, port_devices)):
        cfg = pkg.SimConfig(classes=(pkg.ClassLoad(count=2),))
        with pytest.raises(ValueError, match="fleet"):
            pkg.capacity(cfg, devs.A100_X4)


def test_server_profiles_equal_jax():
    for name in ("a100x4", "v5e-16"):
        want, got = jax_devices.SERVERS[name], port_devices.SERVERS[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for params in (1.2e9, 11e9, 70e9):
            for batch in (1, 2, 8, 32):
                for k1 in (1, 3, 5):
                    for bits in (4, 16):
                        kw = dict(cache_tokens=batch * 100, bits=bits)
                        assert got.verify_latency(params, batch, k1, **kw) == \
                            want.verify_latency(params, batch, k1, **kw)
                assert got.decode_latency(params, batch) == want.decode_latency(params, batch)
    assert port_devices.ELECTRICITY_USD_PER_KWH == jax_devices.ELECTRICITY_USD_PER_KWH
    h100 = port_devices.SERVERS["h100"]
    assert (h100.peak_flops, h100.hbm_bw, h100.power_w) == (989e12, 3.35e12, 700.0)
    assert 0 < h100.launch_overhead_s < 0.1 and h100.price_usd > 0
    # the weight stream sets the step at batch 1: 9.78e9 bf16 parameters
    assert h100.verify_latency(9.775e9, 1, 5) == pytest.approx(
        h100.launch_overhead_s + (9.775e9 * 2 + 1024 * 4096) / 3.35e12)


def test_cost_model_equals_jax():
    for rate in (0.0, 0.5, 8.2, 120.0):
        for price, watts in ((80.0, 8.0), (60_000.0, 2_200.0), (249.0, 15.0)):
            assert port_cost.hourly_cost(price, watts) == jax_cost.hourly_cost(price, watts)
            a = port_cost.cost_per_1k_tokens(rate, price, watts)
            b = jax_cost.cost_per_1k_tokens(rate, price, watts)
            assert a == b or (math.isinf(a) and math.isinf(b))
        for dev in ("rpi4b", "rpi5", "jetson-orin-nano"):
            for server in ("a100x4", "v5e-16"):
                for share in (0.0, 0.01, 0.3):
                    a = port_cost.sled_cost_per_1k(rate, port_devices.DEVICES[dev],
                                                   port_devices.SERVERS[server], share)
                    b = jax_cost.sled_cost_per_1k(rate, jax_devices.DEVICES[dev],
                                                  jax_devices.SERVERS[server], share)
                    assert a == b or (math.isinf(a) and math.isinf(b))
    fleet = [(3, 4.5, "jetson-orin-nano"), (5, 1.25, "rpi4b"), (1, 0.0, "rpi5")]
    for busy in (1e-3, 0.4, 1.0):
        for server in ("a100x4", "v5e-16"):
            a = port_cost.fleet_cost_per_1k(
                [(n, r, port_devices.DEVICES[d]) for n, r, d in fleet],
                port_devices.SERVERS[server], server_busy_frac=busy)
            b = jax_cost.fleet_cost_per_1k(
                [(n, r, jax_devices.DEVICES[d]) for n, r, d in fleet],
                jax_devices.SERVERS[server], server_busy_frac=busy)
            assert a == b
    assert math.isinf(port_cost.fleet_cost_per_1k([], port_devices.H100))


@pytest.mark.parametrize("name", PAPER)
def test_paper_configs_equal_jax(name):
    want, got = jax_base.get_config(name), port_base.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.notes.startswith("paper-")
    assert all(cfg.name != name for cfg, _ in port_base.all_cells())
    assert {c.name for c, _ in port_base.all_cells()} <= {c.name for c, _ in jax_base.all_cells()}
