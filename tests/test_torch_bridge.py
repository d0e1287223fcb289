"""The JAX <-> port bridge moves weights and caches bit-exactly."""
import jax
import numpy as np
import pytest
import torch

from repro.api.spec import ModelSpec
from repro.api.system import build_models
from repro.models.kvcache import PagedKVCache
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig


@pytest.fixture(scope="module")
def mb():
    return build_models(ModelSpec())


def _port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**{f: getattr(cfg, f) for f in ModelConfig.__dataclass_fields__})


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_tree(jax_tree, back):
    flat_j = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        got = flat_b[path]
        want = _bits(leaf)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path


@pytest.mark.parametrize("which", ["target", "draft"])
def test_params_round_trip_bit_exact(mb, which):
    cfg = mb.target_cfg if which == "target" else mb.draft_cfg
    tree = jax.tree.map(np.asarray, getattr(mb, f"{which}_params"))
    model = bridge.params_from_jax(_port_cfg(cfg), tree, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert tuple(model.layers[0].attn.wq.shape) == tree["layers"]["attn"]["wq"].shape[1:]
    _assert_same_tree(tree, bridge.params_to_jax(model))


def test_paged_cache_round_trip_bit_exact(mb):
    pool = PagedKVCache(mb.target, 3, 64, attn_chunk=32)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, pool.cache)
    tree["k"] = rng.standard_normal(tree["k"].shape).astype(tree["k"].dtype)
    tree["v"] = rng.standard_normal(tree["v"].shape).astype(tree["v"].dtype)
    tree["length"] = np.array([5, 17, 0, 9], np.int32)
    cache = bridge.cache_from_jax(tree, device="cpu")
    assert cache["k"].shape == tree["k"].shape and cache["length"].dtype == torch.int32
    _assert_same_tree(tree, bridge.cache_to_jax(cache))


def test_layer_count_mismatch_is_refused(mb):
    tree = jax.tree.map(np.asarray, mb.target_params)
    cfg = _port_cfg(mb.target_cfg)
    with pytest.raises(ValueError, match="layers"):
        bridge.params_from_jax(ModelConfig(**{**cfg.__dict__, "num_layers": 3}), tree, device="cpu")


def test_mamba2_params_round_trip_bit_exact():
    """The ssm family's params tree (layers stacked on L: norm, in_proj,
    conv_w, conv_b, A_log, D, dt_bias, gnorm, out_proj) goes to a Mamba2
    module and back bit for bit."""
    m2 = build_models(ModelSpec(arch="mamba2-370m", draft_arch="mamba2-370m"))
    tree = jax.tree.map(np.asarray, m2.target_params)
    model = bridge.params_from_jax(_port_cfg(m2.target_cfg), tree, device="cpu")
    assert tuple(model.layers[1].conv_w.shape) == tree["layers"]["conv_w"].shape[1:]
    assert model.layers[0].A_log.dtype == torch.float32
    _assert_same_tree(tree, bridge.params_to_jax(model))


@pytest.mark.parametrize("family", ["int8", "ssm"])
def test_int8_and_ssm_caches_round_trip_bit_exact(mb, family):
    """An int8 pool (int8 rows and f32 scale leaves) and an ssm pool (f32
    state, bf16 conv window) move leaf by leaf, bit for bit."""
    rng = np.random.default_rng(1)
    if family == "int8":
        pool = PagedKVCache(mb.target, 3, 64, attn_chunk=32, kv_dtype=jax.numpy.int8)
    else:
        m2 = build_models(ModelSpec(arch="mamba2-370m", draft_arch="mamba2-370m"))
        pool = PagedKVCache(m2.target, 3, 64)
    tree = jax.tree.map(np.array, pool.cache)
    for name, a in tree.items():
        if a.dtype == np.int8:
            tree[name] = rng.integers(-127, 128, size=a.shape).astype(np.int8)
        elif name != "length":
            tree[name] = rng.standard_normal(a.shape).astype(a.dtype)
    cache = bridge.cache_from_jax(tree, device="cpu")
    want = {"int8": {"k": torch.int8, "k_scale": torch.float32},
            "ssm": {"ssm": torch.float32, "conv": torch.bfloat16}}[family]
    assert {k: cache[k].dtype for k in want} == want
    _assert_same_tree(tree, bridge.cache_to_jax(cache))
