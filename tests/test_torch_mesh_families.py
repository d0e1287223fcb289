"""The ssm, hybrid, encdec and vlm families served across a mesh, against
the JAX package's NO_MESH steps.

One (2, 2) mesh of data x model runs as four CPU processes (gloo on
localhost, forked as ``tests/test_torch_collectives.py`` forks them, every
wait bounded by ``RANK_TIMEOUT_S``) for every case. Each rank holds its
pieces of the weights and the cache (``sharding.policy``) and runs
``make_prefill_step(ctx=, with_frontend=)`` and three rounds of
``make_verify_step(ctx=)`` on its rows; round r's drafts make every row
accept r drafts, as ``_jax_serve`` there chooses them. The JAX package's
reduced model runs the same steps under NO_MESH in this process (JAX 0.9.0
refuses the hybrid, encdec and llava prefills under the policy's
shardings, so its NO_MESH steps are the reference).

Cases: the reduced mamba2-370m (8 SSD heads, 4 a rank), zamba2-1.2b (its
shared block over 4 KV heads, 2 a rank), whisper-tiny (its 4 heads, the
cross K/V leaves split by KV head) and llava-next-mistral-7b (8 stub
patches before the prompt, the token lookup vocabulary-parallel), and one
case for each replicated branch of the policy: mamba2 with 3 SSD heads
(the state whole on every rank, every rank scanning all heads) and
whisper with 3 heads (the cross leaves whole, the projections split by
columns and gathered, the self-attention cache sequence-sharded).

Held: the prefill's and every round's logits within ``LOGIT_TOL``, tokens
and commits equal but at a printed near tie (top-2 gap below
``TIE_GAP``), the model ranks' logits bit-equal, and every rank's cache
piece (after the prefill; after the last round) against ``local_shard`` of
JAX's cache under JAX's own ``Policy.cache_spec_for``, within
``CACHE_RTOL`` of the leaf's largest element (the states are ~1e-2, the
K/V ~0.7), lengths equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.sharding.policy import make_policy as jax_make_policy
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.sharding.policy import local_shard, make_policy
from test_torch_collectives import (LOGIT_TOL, TIE_GAP, _f32, _finish, _gap, _gather_rows,
                                    _start)
from test_torch_sharding import _StandInMesh

MESH = {"data": 2, "model": 2}
# five bf16 steps (2^-8 each) of the leaf's largest element: the hybrid's
# K/V land ~1.2e-2 from JAX's (a TP sum in another order moves a bf16
# rounding), the other leaves under 7e-3; a rank whose heads were gathered
# out of order moved its ssm and conv leaves by 5e-2 or more
CACHE_RTOL = 2e-2
V, CHUNK, MAX_LEN, PROMPT, K, B, ROUNDS = 256, 16, 64, 30, 4, 4, 3
# name: (arch, changes to the reduced config)
CASES = {
    "mamba2": ("mamba2-370m", {}),
    "zamba2": ("zamba2-1.2b", {}),
    "whisper": ("whisper-tiny", {}),
    "llava": ("llava-next-mistral-7b", {}),
    "mamba2 3 heads": ("mamba2-370m", {"d_model": 48, "ssm_head_dim": 32}),
    "whisper 3 heads": ("whisper-tiny", {"num_heads": 3, "num_kv_heads": 3}),
}


# ---------------------------------------------------------------- a rank


def _cpu(tree):
    return {k: v.clone() for k, v in tree.items() if not k.endswith("_ckpt")}


def _run_family(mesh, case):
    from repro_torch.core import verification
    from repro_torch.sharding.policy import shard_params

    cfg = case["cfg"]
    policy = make_policy(cfg, mesh)
    ctx = policy.ctx
    model = build_model(cfg)
    params = shard_params(case["params"], policy, device="cpu")
    cache = policy.shard_cache(model.make_cache(B, MAX_LEN, device="cpu", attn_chunk=CHUNK))
    rows = policy.shard_batch({"tokens": case["tokens"], "stub": case["stub"]})
    prefill = verification.make_prefill_step(model, ctx=ctx, attn_chunk=CHUNK,
                                             with_frontend=case["stub"] is not None)
    logits, cache, _ = prefill(params, cache, rows["tokens"], rows["stub"])
    got = {"prefill": logits, "prefill_cache": _cpu(cache), "rounds": []}
    step = verification.make_verify_step(model, ctx=ctx, attn_chunk=CHUNK)
    for batch in case["batches"]:
        batch = policy.shard_batch(batch)
        h, ck = model.decode_forward(params, cache, batch["tokens_in"], attn_chunk=CHUNK, ctx=ctx)
        lg = model.lm_head(params, h, ctx)  # the step's logits (it rewrites the same rows)
        got["ckpt_shape"] = tuple(ck["ssm_ckpt"].shape) if "ssm_ckpt" in ck else None
        res, cache = step(params, cache, batch)
        got["rounds"].append({"logits": lg, "out_tokens": res.out_tokens,
                              "n_commit": res.n_commit})
    got["cache"] = _cpu(cache)
    return got


_RUNNERS = {"family": _run_family}


# ---------------------------------------------------------------- JAX


def _jax_case(name: str):
    """The JAX reduced model's prefill step and three verify rounds under
    NO_MESH (round r accepts r drafts in every row): (the ranks' case,
    the results and caches to hold them to)."""
    import jax
    import jax.numpy as jnp
    from repro.core import verification as JV
    from repro.models.model_zoo import build_model as jax_build_model

    arch, changes = CASES[name]
    jcfg = dataclasses.replace(jax_config(arch).reduced(), vocab_size=V, **changes)
    jm = jax_build_model(jcfg)
    jp = jax.jit(lambda k: jm.init_params(k, max_pos=MAX_LEN))(jax.random.key(0))
    rng = np.random.default_rng(7)
    stack = {"ssm": "layers", "hybrid": "ssm_layers"}.get(jcfg.family)
    if stack:
        # the init's D (1) and dt (softplus(dt_bias) = 0.01) leave the scan's
        # output a few percent of D x and its states ~1e-5: heads scanned or
        # gathered out of order moved the logits by ~3e-3, under LOGIT_TOL.
        # D ~ N(0, 0.1) per head and dt ~ 0.7 put the scan in charge
        ssd = dict(jp[stack])
        ssd["D"] = jnp.asarray(rng.standard_normal(ssd["D"].shape) * 0.1, ssd["D"].dtype)
        ssd["dt_bias"] = jnp.zeros_like(ssd["dt_bias"])
        jp = {**jp, stack: ssd}
    prompt = rng.integers(0, V, size=(B, PROMPT)).astype(np.int32)
    n_stub = {"encdec": jcfg.encoder_seq, "vlm": jcfg.num_patches}.get(jcfg.family)
    stub = None
    if n_stub:  # the stub frontend's distribution, drawn by numpy
        stub = (rng.standard_normal((B, n_stub, jcfg.d_model)) * 0.02).astype(np.float32)
    jstub = None if stub is None else jnp.asarray(stub, jnp.bfloat16)
    prefill = jax.jit(JV.make_prefill_step(jm, attn_chunk=CHUNK, with_frontend=stub is not None))
    verify = jax.jit(JV.make_verify_step(jm, attn_chunk=CHUNK))

    @jax.jit
    def logits_of(p, c, t):
        h = jm.decode_forward(p, c, t, attn_chunk=CHUNK)[0]
        return jm.lm_head(p, h)

    pl, cache, last = prefill(jp, jm.make_cache(B, MAX_LEN, attn_chunk=CHUNK),
                              jnp.asarray(prompt), jstub)
    want = {"prefill": np.asarray(pl), "prefill_cache": jax.tree.map(np.asarray, cache),
            "rounds": []}
    batches = []
    prev = np.asarray(last)
    for accept in range(ROUNDS):
        drafts = rng.integers(0, V, size=(B, K)).astype(np.int32)
        for i in range(accept + 1):  # drafts 1..accept greedy, draft accept+1 not
            lg = np.asarray(logits_of(jp, cache, jnp.asarray(np.c_[prev, drafts])))
            top = lg[:, i].argmax(-1)
            drafts[:, i] = top if i < accept else (top + 1) % V
        batch = {"tokens_in": np.c_[prev, drafts].astype(np.int32), "draft_tokens": drafts,
                 "lengths": np.full((B,), K, np.int32), "seed": 0}
        lg = np.asarray(logits_of(jp, cache, jnp.asarray(batch["tokens_in"])))
        res, cache = verify(jp, cache, {k: jnp.asarray(v) for k, v in batch.items()})
        out_tokens, n_commit = np.asarray(res.out_tokens), np.asarray(res.n_commit)
        assert (n_commit == accept + 1).all(), n_commit
        want["rounds"].append({"logits": lg, "out_tokens": out_tokens, "n_commit": n_commit})
        batches.append({k: torch.from_numpy(np.asarray(v)) if k != "seed" else 0
                        for k, v in batch.items()})
        prev = out_tokens[np.arange(B), n_commit - 1]
    want["cache"] = jax.tree.map(np.asarray, cache)
    want["jcfg"] = jcfg
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = bridge.params_tree(bridge.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                                     device="cpu"))
    case = {"kind": "family", "cfg": cfg, "params": tree, "tokens": torch.from_numpy(prompt),
            "stub": None if stub is None else torch.from_numpy(stub).to(torch.bfloat16),
            "batches": batches}
    return case, want


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case's JAX reference, then one spawn of the (2, 2) mesh for
    all of them: (the ranks' outputs, by rank; the references, by case)."""
    cases, wants = {}, {}
    for name in CASES:
        cases[name], wants[name] = _jax_case(name)
    work = tmp_path_factory.mktemp("mesh_families")
    ranks = _finish(_start({"mesh": tuple(MESH.values()), "cases": cases}, 4, work, _RUNNERS))
    return ranks, wants


# ---------------------------------------------------------------- checks


def _hold_cache(ranks, name, key, want, jcfg):
    """Every rank's cache piece against its piece of JAX's cache."""
    jpol = jax_make_policy(jcfg, _StandInMesh(dict(MESH), tuple(MESH)))
    for r, got_rank in enumerate(ranks):
        got = got_rank[name][key]
        assert sorted(got) == sorted(want), (name, key, sorted(got), sorted(want))
        mesh = Mesh(MESH, rank=r)
        for leaf, full in want.items():
            spec = tuple(jpol.cache_spec_for(leaf, full.shape))
            piece = local_shard(torch.from_numpy(np.array(full, np.float32)), spec, mesh)
            g = got[leaf]
            assert tuple(g.shape) == tuple(piece.shape), (name, key, leaf, r, spec)
            what = f"{name} {key} {leaf} rank {r}"
            if leaf == "length":
                assert g.tolist() == piece.int().tolist(), what
                continue
            tol = CACHE_RTOL * float(piece.abs().max())
            np.testing.assert_allclose(_f32(g), piece.numpy(), atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_under_a_mesh_matches_jax(served, name):
    """The prefill step's last-position logits and every rank's cache piece:
    the ssm state by SSD head (whole with 3 heads), the conv window whole,
    K/V by KV head (whisper with 3 heads: by sequence), the cross leaves by
    KV head (whisper with 3 heads: whole), every leaf by row."""
    ranks, wants = served
    want = wants[name]
    got = _gather_rows(ranks, name, "prefill", (2, 2))
    np.testing.assert_allclose(_f32(got), want["prefill"], atol=LOGIT_TOL, rtol=0)
    _hold_cache(ranks, name, "prefill_cache", want["prefill_cache"], want["jcfg"])
    cfg = get_config(CASES[name][0])
    if cfg.family in ("ssm", "hybrid"):
        H = want["prefill_cache"]["ssm"].shape[2]
        assert ranks[0][name]["prefill_cache"]["ssm"].shape[2] == (H if H % 2 else H // 2)


@pytest.mark.parametrize("name", list(CASES))
def test_verify_rounds_under_a_mesh_match_jax(served, name):
    """Three verify rounds accepting 0, 1 and 2 drafts: logits, tokens and
    commits against JAX's, the model ranks' logits bit-equal, the state
    checkpoints on the rank's heads, then the committed cache's pieces."""
    ranks, wants = served
    want = wants[name]
    for r, w in enumerate(want["rounds"]):
        for d in range(2):
            assert torch.equal(ranks[d * 2 + 1][name]["rounds"][r]["logits"],
                               ranks[d * 2][name]["rounds"][r]["logits"]), (name, r, d)
        logits = torch.cat([ranks[d * 2][name]["rounds"][r]["logits"] for d in range(2)])
        np.testing.assert_allclose(_f32(logits), w["logits"], atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"{name} round {r}")
        toks = torch.cat([ranks[d * 2][name]["rounds"][r]["out_tokens"] for d in range(2)])
        commit = torch.cat([ranks[d * 2][name]["rounds"][r]["n_commit"] for d in range(2)])
        gaps = _gap(w["logits"])
        for b in range(toks.shape[0]):
            if not (np.array_equal(toks[b].numpy(), w["out_tokens"][b])
                    and int(commit[b]) == int(w["n_commit"][b])):
                print(f"{name} round {r} row {b}: tokens {toks[b].tolist()} vs "
                      f"{w['out_tokens'][b].tolist()}, top-2 gaps {gaps[b].tolist()}")
                assert gaps[b].min() < TIE_GAP, (name, r, b)
    shape = ranks[0][name]["ckpt_shape"]
    if shape is not None:  # (L, B / 2, K + 1, heads of the rank, P, N)
        H = want["cache"]["ssm"].shape[2]
        assert shape[1:4] == (B // 2, K + 1, H if H % 2 else H // 2), shape
    _hold_cache(ranks, name, "cache", want["cache"], want["jcfg"])


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b", "whisper-tiny",
                                  "llava-next-mistral-7b"])
def test_families_under_a_mesh_refuse_slots_and_a_train_layout(arch):
    """What stays refused under a sharded mesh, before anything runs: a
    slot pool and a train-mode (FSDP) layout."""
    cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=64)
    model = build_model(cfg)
    params = bridge._MODELS[cfg.family](cfg, device="cpu")
    mesh = Mesh.from_shape({"data": 1, "model": 2})
    cache = model.make_cache(2, 32, device="cpu", attn_chunk=16)
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="slot-pool"):
        model.decode_forward(params, cache, tokens, slots=torch.zeros(2, dtype=torch.int32),
                             ctx=make_policy(cfg, mesh).ctx)
    with pytest.raises(NotImplementedError, match="FSDP"):
        model.prefill(params, tokens, cache, attn_chunk=16,
                      ctx=make_policy(cfg, mesh, mode="train").ctx)


def test_shard_cache_refuses_the_state_checkpoints():
    """``cache_spec_for("ssm_ckpt")`` would put the model axis on the
    checkpoints' K axis (as JAX's does): only a committed cache is cut."""
    cfg = get_config("mamba2-370m").reduced()
    cache = build_model(cfg).make_cache(2, 0, device="cpu")
    policy = make_policy(cfg, Mesh(MESH, rank=0))
    assert policy.shard_cache(cache)["ssm"].shape[1:3] == (1, cfg.ssm_heads // 2)
    ckpt = {**cache, "ssm_ckpt": cache["ssm"][:, :, None].expand(-1, -1, K + 1, -1, -1, -1)}
    with pytest.raises(ValueError, match="checkpoints"):
        policy.shard_cache(ckpt)
