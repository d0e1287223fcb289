"""The port's sharding policy (``repro_torch.sharding.policy``) against the
JAX package's, rule for rule, and ``local_shard``'s pieces.

Every config of ``list_configs()``, modes ``serve`` and ``train``, on
meshes (2, 2), (2, 4), (16, 16) and (2, 16, 16). The JAX ``Policy`` runs on
a stand-in mesh (an object with ``shape`` and ``axis_names``) over the
parameter tree of ``jax.eval_shape``, so no devices are needed; the port's
runs on a bare ``launch.mesh.Mesh`` over its own model's tree
(``bridge.params_tree`` of the model built on the meta device) and its own
caches (``make_cache`` on the meta device). Every parameter, cache and
batch spec must be equal (``tuple`` of the JAX ``PartitionSpec``), and so
must ``shard_attn_q``, ``seq_shard_kv`` and ``shard_vocab``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.configs.base import list_configs as jax_list_configs
from repro.core.verification import verify_batch_spec
from repro.models.model_zoo import build_model as jax_build_model
from repro.sharding.policy import make_policy as jax_make_policy
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import list_configs
from repro_torch.launch.mesh import Mesh, batch_axes, model_axis
from repro_torch.models.model_zoo import build_model
from repro_torch.sharding.policy import local_shard, make_policy, port_param_specs

MESHES = {
    "2x2": {"data": 2, "model": 2},
    "2x4": {"data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
MODES = ("serve", "train")
B, MAX_LEN, CHUNK, K = 32, 4096, 1024, 4


@dataclasses.dataclass(frozen=True)
class _StandInMesh:
    """What the JAX Policy reads of a mesh: ``shape`` and ``axis_names``."""

    shape: dict
    axis_names: tuple


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    return {"/".join(path): tree}


@functools.lru_cache(maxsize=None)
def _jax_trees(name: str):
    jm = jax_build_model(jax_config(name))
    params = jm.init_params_spec()
    cache = jm.make_cache(B, MAX_LEN, spec_only=True, attn_chunk=CHUNK)
    return params, cache


@functools.lru_cache(maxsize=None)
def _port_trees(name: str):
    cfg = get_config(name)
    model = bridge._MODELS[cfg.family](cfg, device="meta")
    cache = build_model(cfg).make_cache(B, MAX_LEN, device="meta", attn_chunk=CHUNK)
    return model, bridge.params_tree(model), cache


def _batches():
    jb = verify_batch_spec(B, K)
    pb = {"tokens_in": torch.zeros((B, K + 1), dtype=torch.int32),
          "draft_tokens": torch.zeros((B, K), dtype=torch.int32),
          "lengths": torch.zeros((B,), dtype=torch.int32), "seed": 0,
          "odd": torch.zeros((B - 1, 3))}
    jb = {**jb, "odd": jax.ShapeDtypeStruct((B - 1, 3), np.float32)}
    return jb, pb


def test_the_port_lists_every_jax_config():
    assert list_configs() == jax_list_configs()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_spec_equals_jax(mesh, mode):
    shape = MESHES[mesh]
    jmesh = _StandInMesh(dict(shape), tuple(shape))
    pmesh = Mesh.from_shape(shape)
    assert batch_axes(pmesh) == tuple(a for a in ("pod", "data") if a in shape)
    assert model_axis(pmesh) == "model"
    jbatch, pbatch = _batches()
    for name in list_configs():
        jpol = jax_make_policy(jax_config(name), jmesh, mode=mode)
        pol = make_policy(get_config(name), pmesh, mode=mode)
        assert (pol.shard_attn_q(), pol.seq_shard_kv(), pol.shard_vocab(), pol.shard_attn_kv()) == (
            jpol.shard_attn_q(), jpol.seq_shard_kv(), jpol.shard_vocab(), jpol.shard_attn_kv()), name
        assert (pol.tp, pol.batch_axes, pol.n_batch_shards) == (
            jpol.tp, jpol.batch_axes, jpol.n_batch_shards)
        ctx, jctx = pol.ctx, jpol.ctx
        assert (ctx.batch_axes, ctx.model_axis, ctx.fsdp, ctx.seq_shard_kv, ctx.tp,
                ctx.n_batch_shards, ctx.bspec(B)) == (
            jctx.batch_axes, jctx.model_axis, jctx.fsdp, jctx.seq_shard_kv, jctx.tp,
            jctx.n_batch_shards, jctx.bspec(B)), name
        jparams, jcache = _jax_trees(name)
        _, pparams, pcache = _port_trees(name)
        for fsdp in (None, False, True):
            want = {k: tuple(v) for k, v in _flat(jpol.param_specs(jparams, fsdp=fsdp)).items()}
            got = _flat(pol.param_specs(pparams, fsdp=fsdp))
            assert got == want, (name, mesh, mode, fsdp)
        want = {k: tuple(v) for k, v in jpol.cache_specs(jcache).items()}
        assert pol.cache_specs(pcache) == want, (name, mesh, mode)
        want = {k: tuple(v) for k, v in jpol.batch_specs(jbatch).items()}
        assert pol.batch_specs(pbatch) == want, (name, mesh, mode)


@pytest.mark.parametrize("name", ["granite-34b", "qwen3-moe-30b-a3b", "qwen1.5-32b"])
def test_port_param_specs_are_the_stacked_specs_without_the_layer_axis(name):
    """``port_param_specs`` (what ``shard_module`` cuts by) is the JAX
    layout's spec of each leaf, a stacked leaf's layer axis dropped."""
    pol = make_policy(get_config(name), Mesh.from_shape(MESHES["16x16"]))
    model, tree, _ = _port_trees(name)
    by_path = _flat(pol.param_specs(tree))
    specs = port_param_specs(pol, model)
    for pname, path, layer in bridge.param_paths(model):
        want = by_path["/".join(path)]
        assert specs[pname] == (want if layer is None else want[1:]), pname


@pytest.mark.parametrize("spec", [
    ("data", "model", None), (None, "model", "data"), (("pod", "data"), None, "model"),
    (None, None, None), ("model", None, None),
])
def test_local_shard_pieces_reassemble_bit_for_bit(spec):
    shape = {"pod": 2, "data": 2, "model": 2}
    full = torch.randn(8, 4, 6, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    size = 8
    rebuilt = torch.full_like(full, float("nan"))
    for rank in range(size):
        mesh = Mesh(shape, rank=rank)
        piece = local_shard(full, spec, mesh)
        assert piece.is_contiguous() and piece.untyped_storage().data_ptr() != \
            full.untyped_storage().data_ptr()
        index = []
        for dim, entry in enumerate(spec):
            axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
            n, i = 1, 0
            for a in axes:
                n, i = n * shape[a], i * shape[a] + mesh.coords[a]
            step = full.shape[dim] // n
            index.append(slice(i * step, (i + 1) * step))
        rebuilt[tuple(index)] = piece
    assert torch.equal(rebuilt.view(torch.int16), full.view(torch.int16))


def test_mesh_coordinates_are_row_major():
    mesh = Mesh({"data": 2, "model": 4}, rank=6)
    assert mesh.coords == {"data": 1, "model": 2} and mesh.size == 8
    with pytest.raises(ValueError, match="no process groups"):
        Mesh.from_shape({"data": 2, "model": 4}).group("model")


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_debug_mesh(2, 2, device="cpu")


def test_the_serving_steps_refuse_what_they_do_not_shard():
    """A slot pool, a train-mode (FSDP) layout and an int8 sequence-sharded
    cache raise under a mesh instead of running unsharded."""
    import dataclasses as dc

    from repro_torch.distributed.collectives import sp_append_attend
    from repro_torch.models.layers import MeshContext

    cfg = dc.replace(get_config("granite-34b").reduced(), vocab_size=64)
    model = build_model(cfg)
    params = bridge._MODELS[cfg.family](cfg, device="cpu")
    mesh = Mesh.from_shape({"data": 1, "model": 2})
    cache = model.make_cache(2, 32, device="cpu", attn_chunk=16)
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="slot-pool"):
        model.decode_forward(params, cache, tokens, slots=torch.zeros(2, dtype=torch.int32),
                             ctx=make_policy(cfg, mesh).ctx)
    with pytest.raises(NotImplementedError, match="FSDP"):
        model.decode_forward(params, cache, tokens, ctx=make_policy(cfg, mesh, mode="train").ctx)
    ctx = MeshContext(mesh=mesh, model_axis="model", seq_shard_kv=True)
    q = torch.zeros((1, 2, 4, 16), dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 1, 16), dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="int8"):
        sp_append_attend(q, kv, kv, kv[:, :2], kv[:, :2], torch.zeros(1, dtype=torch.int32), 0,
                         ctx)


@pytest.mark.parametrize("entry", ["make_debug_mesh", "shard_params"])
def test_mesh_entry_points_default_to_the_card(entry):
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.policy import shard_params

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "make_debug_mesh":
            make_debug_mesh(2, 2)
        else:
            cfg = get_config("granite-34b").reduced()
            shard_params({}, make_policy(cfg, Mesh.from_shape({"data": 1, "model": 2})))
