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
