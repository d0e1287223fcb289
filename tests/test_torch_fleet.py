"""Heterogeneous fleets on the port's engine backend, held to the JAX package.

The port's mirror of tests/test_fleet.py::test_engine_fleet_matches_per_
class_references and ::test_kit_for_routes_class_kits on the same
``_fleet_spec``: two device classes (Jetson Orin Nano, k 4, c_th 0.0;
RPi 4B, k 2, c_th 0.4) with their own draft noise. The class drafts are
the JAX package's ``build_draft_variant`` weights, bridged into a
``KitCache``; every device's stream must equal its class's JAX reference
stream (the lock-step reference of ``fleet_reference_specs()``), up to a
printed near tie (tests/test_torch_serve.py).

Also here: the scratch rows of the engine's padded verify batches (the
padding up to a bucket) each see at least their own fed tokens
(``kv_valid >= Sq``), on the bf16 and the int8 pool, so the attention's
empty-row convention (0 where a query sees no position; the JAX oracle
averages every position there) never meets a served batch.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.api import DeviceClassSpec as JDeviceClassSpec
from repro.api import FleetSpec as JFleetSpec
from repro.api import ModelSpec as JModelSpec
from repro.api import SchedulerSpec as JSchedulerSpec
from repro.api import ServeSpec as JServeSpec
from repro.api import System as JSystem
from repro.api import TransportSpec as JTransportSpec
from repro.api.system import build_draft_variant as jax_build_draft_variant
from repro_torch import bridge
from repro_torch.api import KitCache, ModelSpec, ServeSpec, System, build_models
from repro_torch.api.spec import DeviceClassSpec, FleetSpec, SchedulerSpec, TransportSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.model_zoo import build_model
from test_torch_serve import _assert_same_tokens, _port_bundle, jax_build_models

V = 64
CLASSES = (
    dict(profile="jetson-orin-nano", count=2, draft_model="llama-1b-draft", bits=4,
         k=4, c_th=0.0, draft_noise=0.02),
    dict(profile="rpi4b", count=2, draft_model="llama-1b-draft", bits=4,
         k=2, c_th=0.4, draft_noise=0.3),
)


def _fleet_spec(jax_side: bool = False, **kw):
    """tests/test_fleet.py's ``_fleet_spec``, in either package."""
    M, T, S, F, C, Spec = ((JModelSpec, JTransportSpec, JSchedulerSpec, JFleetSpec,
                            JDeviceClassSpec, JServeSpec) if jax_side else
                           (ModelSpec, TransportSpec, SchedulerSpec, FleetSpec, DeviceClassSpec,
                            ServeSpec))
    base = dict(
        backend="engine",
        model=M(vocab_size=V, target_layers=2, draft_layers=1, draft_noise=0.03),
        transport=T(stagger_s=0.0),
        scheduler=S(stagger_ticks=0, slots=4),
        fleet=F(classes=tuple(C(**c) for c in CLASSES)),
        prompt_len=8, max_new=8, k_max=4, c_th=0.3,
    )
    base.update(kw)
    return Spec(**base)


@pytest.fixture(scope="module")
def fleet():
    """The JAX bundle and class drafts, the port's bundle and a KitCache
    holding the bridged class drafts, and numpy prompts."""
    jspec = _fleet_spec(jax_side=True)
    mb = jax_build_models(jspec.model)
    pb = _port_bundle(mb)
    jdrafts, cache = {}, KitCache()
    for rc in jspec.resolved_classes():
        dcfg, dmodel, dp = jax_build_draft_variant(jspec.model, draft_layers=rc.draft_layers,
                                                   draft_noise=rc.draft_noise)
        jdrafts[rc.index] = (dcfg, dmodel, dp)
        pcfg = ModelConfig(**dataclasses.asdict(dcfg))
        key = (jspec.model.draft_arch, rc.draft_layers, rc.draft_noise, V, jspec.model.seed)
        cache.drafts[key] = (pcfg, build_model(pcfg), bridge.params_from_jax(
            pcfg, jax.tree.map(np.asarray, dp), device="cpu"))
    prompts = np.random.default_rng(6).integers(
        0, V, size=(jspec.devices, jspec.prompt_len)).astype(np.int32)
    return jspec, mb, jdrafts, pb, cache, prompts


def test_engine_fleet_matches_per_class_references(fleet):
    jspec, mb, jdrafts, pb, cache, prompts = fleet
    result = System.build(_fleet_spec(), models=pb, kits=cache, device="cpu").serve(prompts)
    for (lo, hi, refspec), rc in zip(jspec.fleet_reference_specs(), jspec.resolved_classes()):
        dcfg, dmodel, dp = jdrafts[rc.index]
        models = dataclasses.replace(mb, draft_cfg=dcfg, draft=dmodel, draft_params=dp)
        ref = JSystem.build(refspec, models=models).serve(prompts[lo:hi])
        _assert_same_tokens([result.outputs[lo + i] for i in range(hi - lo)],
                            [ref.outputs[i] for i in range(hi - lo)], models, prompts[lo:hi])
    assert result.engine.rounds > 0
    assert all(len(t) == jspec.max_new for t in result.outputs.values())


def test_kit_for_routes_class_kits(fleet):
    _, _, _, pb, cache, _ = fleet
    spec = _fleet_spec()
    system = System.build(spec, models=pb, kits=cache, device="cpu")
    k_fast, k_slow = system.kit_for(0), system.kit_for(spec.devices - 1)
    assert k_fast.k_max == 4 and k_slow.k_max == 2
    assert k_fast.c_th == pytest.approx(0.0)
    assert k_slow.c_th == pytest.approx(0.4)
    assert k_fast.params is cache.drafts[(spec.model.draft_arch, 1, 0.02, V, 0)][2]
    # a class that inherits the spec model's draft rides the bundle's draft;
    # identical classes share one kit through the cache
    same = dataclasses.replace(spec, fleet=FleetSpec(classes=(
        DeviceClassSpec(profile="rpi4b", count=1, bits=4, k=2),
        DeviceClassSpec(profile="rpi5", count=1, bits=4, k=2))))
    s2 = System.build(same, models=pb, kits=cache, device="cpu")
    assert s2.kit_for(0) is s2.kit_for(1) and s2.kit_for(0).params is pb.draft_params


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_padded_verify_scratch_rows_see_their_own_tokens(kv_dtype, monkeypatch):
    """Every row the engine's padded verify hands the paged attention,
    scratch rows included, has ``kv_valid >= Sq`` (the JAX kernels'
    contract): a fleet with mixed draft lengths and partial fills, after a
    warmup of all-scratch batches. Three devices on four slots: every
    round of all three pads with a scratch row."""
    classes = (CLASSES[0], {**CLASSES[1], "count": 1})
    spec = _fleet_spec(kv_dtype=kv_dtype, max_new=12,
                       fleet=FleetSpec(classes=tuple(DeviceClassSpec(**c) for c in classes)))
    seen = []
    paged = ops.verify_attention_paged

    def recording(q, k_pool, v_pool, slots, kv_valid, **kw):
        seen.append((slots.tolist(), kv_valid.tolist(), q.shape[1]))
        return paged(q, k_pool, v_pool, slots, kv_valid, **kw)

    monkeypatch.setattr(ops, "verify_attention_paged", recording)
    system = System.build(spec, models=build_models(spec.model, device="cpu"), warmup=True,
                          device="cpu")
    system.serve()
    scratch = system.engine.pool.scratch_slot
    rows = [(s, n, sq) for slots, kvv, sq in seen for s, n in zip(slots, kvv)]
    scratch_rows = [(n, sq) for s, n, sq in rows if s == scratch]
    assert scratch_rows and any(s != scratch for slots, _, _ in seen for s in slots
                                if scratch in slots)  # padding beside real rows
    assert all(n >= sq for _, n, sq in rows), [r for r in rows if r[1] < r[2]]
