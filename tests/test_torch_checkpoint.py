"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint.checkpoint``): one format, read both ways.

On the reduced params of every family (dense qwen2-1.5b, moe
granite-moe-3b-a800m, ssm mamba2-370m, hybrid zamba2-1.2b, vlm
llava-next-mistral-7b, encdec whisper-tiny) and on an int8 KV cache (int8
K/V, f32 scales, int32 length): a JAX save restores in the port into the
bridge's tree (``bridge.params_tree``) bit for bit, and a port save
restores in JAX bit for bit, with the same manifest (keys, shapes, dtypes;
bf16 stored as uint16 bits). Then the step bookkeeping: ``keep_last``,
``latest_step``, ``async_save`` and a step directory without a manifest,
which is never chosen.
"""
import dataclasses
import functools
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import get_config as jax_config
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch import bridge
from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig

FAMILIES = {
    "dense": "qwen2-1.5b", "moe": "granite-moe-3b-a800m", "ssm": "mamba2-370m",
    "hybrid": "zamba2-1.2b", "vlm": "llava-next-mistral-7b", "encdec": "whisper-tiny",
}


def _bits(a) -> np.ndarray:
    """A leaf's bytes as an integer array: bf16 as uint16 bits."""
    if isinstance(a, torch.Tensor):
        a = bridge.to_numpy(a)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@functools.lru_cache(maxsize=None)
def _params(family: str):
    """(port config, JAX params, the port's model on them) of the reduced
    config of ``family``."""
    jcfg = jax_config(FAMILIES[family]).reduced()
    assert jcfg.family == family
    jm = jax_build_model(jcfg)
    jp = jax.jit(functools.partial(jm.init_params, max_pos=32))(jax.random.key(0))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return cfg, jp, bridge.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_same_tree(port_tree, jax_tree):
    """Every JAX leaf has the port leaf of its key, equal bit for bit and of
    the same dtype."""
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in _leaves(port_tree)}
    for path, want in _leaves(jax_tree):
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        got = flat.pop(key)
        want_dtype = np.asarray(want).dtype.name
        got_dtype = got.dtype if not isinstance(got, torch.Tensor) else str(got.dtype)
        assert want_dtype in str(got_dtype), (key, got_dtype, want_dtype)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=key)
    assert not flat, f"port leaves JAX does not have: {sorted(flat)}"


def _manifest(d: str, step: int) -> dict:
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_checkpoint_restores_in_the_port(family):
    """``repro.checkpoint.save`` of the JAX params; the port restores it into
    the bridge's tree of its model, bit for bit, and builds the same model
    from it."""
    cfg, jp, model = _params(family)
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 5, jp, extras={"family": family})
        tree, extras = ckpt.restore(d, bridge.params_tree(model), device="cpu")
    assert extras == {"family": family}
    _assert_same_tree(tree, jp)
    again = bridge.params_from_jax(cfg, tree, device="cpu")
    for name, want in model.state_dict().items():
        got = again.state_dict()[name]
        assert got.dtype == want.dtype and torch.equal(got, want), name


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_checkpoint_restores_in_jax(family):
    """The port's save of ``bridge.params_tree``; ``repro.checkpoint.restore``
    reads it into the JAX params' structure, bit for bit, and the manifest
    equals the one JAX writes of the same params."""
    _, jp, model = _params(family)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 7, bridge.params_tree(model), extras={"step": 7})
        tree, extras = jckpt.restore(d, jp)
        mine = _manifest(d, 7)
        jckpt.save(d, 8, jp, extras={"step": 7})
        theirs = _manifest(d, 8)
    assert extras == {"step": 7}
    _assert_same_tree(tree, jp)
    for field in ("keys", "shapes", "dtypes", "extras"):
        assert mine[field] == theirs[field], field


@functools.lru_cache(maxsize=None)
def _cache_trees():
    """A prefilled int8 cache of the reduced qwen2 and a bf16 cache of the
    reduced whisper-tiny with its cross leaves (JAX pytrees)."""
    trees = {}
    for name, arch, kw in (("int8", "qwen2-1.5b", {"kv_dtype": jnp.int8}),
                           ("encdec", "whisper-tiny", {"enc_len": 8})):
        jcfg = jax_config(arch).reduced()
        jm = jax_build_model(jcfg)
        toks = jnp.asarray(np.arange(12, dtype=np.int32).reshape(2, 6) % jcfg.vocab_size)
        frames = jax.random.normal(jax.random.key(2), (2, 8, jcfg.d_model)).astype(jnp.bfloat16)

        @jax.jit
        def prefill(key):
            jp = jm.init_params(key, max_pos=32)
            return jm.prefill(jp, toks, jm.make_cache(2, 32, attn_chunk=16, **kw),
                              attn_chunk=16, enc_frames=frames if jcfg.is_encdec else None)[1]

        trees[name] = prefill(jax.random.key(1))
    return trees


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_int8_cache_tree_round_trips(direction):
    """A prefilled int8 cache of the reduced qwen2 (int8 K/V, f32 scales,
    int32 length) and a bf16 cache with whisper's cross leaves, bit for
    bit either way."""
    tree = _cache_trees()
    assert np.asarray(tree["int8"]["k"]).dtype == np.int8
    assert np.asarray(tree["encdec"]["cross_k"]).dtype.name == "bfloat16"
    port = {name: bridge.cache_from_jax(jax.tree.map(np.asarray, c), device="cpu")
            for name, c in tree.items()}
    with tempfile.TemporaryDirectory() as d:
        if direction == "jax_to_port":
            jckpt.save(d, 1, tree)
            got, _ = ckpt.restore(d, port, device="cpu")
        else:
            ckpt.save(d, 1, port)
            got, _ = jckpt.restore(d, tree)
    _assert_same_tree(got, tree)


def test_keep_last_and_latest_step():
    """``keep_last`` keeps the newest steps; ``latest_step`` and
    ``all_steps`` read what is on disk, JAX's steps and the port's alike."""
    x = {"x": torch.arange(3, dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as d:
        assert ckpt.latest_step(d) is None and ckpt.all_steps(d) == []
        for s in (1, 2, 3, 4):
            ckpt.save(d, s, x, keep_last=2)
        assert ckpt.all_steps(d) == [3, 4] == jckpt.all_steps(d)
        assert ckpt.latest_step(d) == 4
        jckpt.save(d, 9, {"x": jnp.zeros(3)}, keep_last=2)
        assert ckpt.all_steps(d) == [4, 9] and ckpt.latest_step(d) == 9
        got, _ = ckpt.restore(d, x, step=4, device="cpu")
        assert torch.equal(got["x"], x["x"])
        with pytest.raises(FileNotFoundError):
            ckpt.restore(os.path.join(d, "none"), x, device="cpu")


def test_async_save_and_a_step_without_a_manifest():
    """``async_save`` returns the writer thread, and the tree changed after
    the call is saved as it was at the call; a step directory without a
    manifest (a torn write) is never listed or restored."""
    x = {"x": torch.arange(5, dtype=torch.int32), "h": torch.ones(4, dtype=torch.bfloat16)}
    with tempfile.TemporaryDirectory() as d:
        t = ckpt.save(d, 7, x, async_save=True)
        x["x"].add_(100)
        t.join()
        os.makedirs(os.path.join(d, f"step_{8:09d}"))
        os.makedirs(os.path.join(d, f"step_{9:09d}.tmp"))
        assert ckpt.all_steps(d) == [7] == jckpt.all_steps(d)
        got, _ = ckpt.restore(d, x, device="cpu")
        assert got["x"].tolist() == list(range(5)) and got["h"].dtype == torch.bfloat16
        jgot, _ = jckpt.restore(d, {"x": jnp.zeros(5, jnp.int32), "h": jnp.zeros(4, jnp.bfloat16)})
        assert np.asarray(jgot["x"]).tolist() == list(range(5))


def test_restore_defaults_to_the_card():
    """``restore(device=)`` replaces the JAX ``shardings=``: the card unless
    the caller asks for the CPU; without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, {"x": torch.zeros(2)})
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ckpt.restore(d, {"x": torch.zeros(2)})


def test_a_zero_dim_leaf_restores_zero_dim():
    """A 0-d leaf (an optimizer's step) keeps its shape both ways."""
    tree = {"step": torch.tensor(3, dtype=torch.int32), "w": torch.ones(2, dtype=torch.bfloat16)}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, tree)
        back, _ = ckpt.restore(d, tree, device="cpu")
        theirs, _ = jckpt.restore(d, {"step": jnp.zeros((), jnp.int32),
                                      "w": jnp.zeros(2, jnp.bfloat16)})
    assert back["step"].shape == () and back["step"].dtype == torch.int32 and int(back["step"]) == 3
    assert np.asarray(theirs["step"]).shape == () and int(theirs["step"]) == 3
    assert bridge.to_tensor(np.asarray(theirs["step"])).shape == ()
