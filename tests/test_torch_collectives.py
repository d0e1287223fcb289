"""The port's serving across a mesh against the JAX package, on gloo ranks.

Each mesh runs as CPU processes (forked from a server that has imported
torch), one rank per mesh point, over a gloo process group on localhost;
every rank and every wait is bounded by ``RANK_TIMEOUT_S``. The cases of a
mesh share one start. The JAX package's own sharded functions run
in one subprocess with 8 host devices (as ``tests/test_sharding.py`` runs
them); its single-device functions run here.

  (a) ``sp_append_attend`` on a (2, 4) mesh with the JAX test's shapes and
      dtype (B 4, Sq 3, Hq 8, Hkv 2, S 64, D 16; f32): the cache length 30; 14,
      whose fresh rows straddle the shards' boundary at 16; 5, where three
      whole shards see nothing; and unequal lengths, where every row's rows
      go to row 0's length in both packages (the padded-batch contract).
      Outputs within ``SP_TOL`` (2e-3) of JAX's sharded and single-device
      results, caches bit-equal to JAX's.
  (b) ``moe_block`` on the (2, 4) mesh at E 8 (expert-parallel) and E 6
      (tensor-parallel inside each expert) against JAX's under ``NO_MESH``
      and under its host mesh, within ``MOE_TOL`` (6e-2, JAX's own bound).
  (c) the prefill step and three verify steps of reduced granite-34b (MQA:
      the cache sequence-sharded, the first verify's rows straddling the
      shards) and of reduced qwen3-moe-30b-a3b's dropless twin (KV heads
      and experts sharded) on a (2, 2) mesh, against JAX's
      ``make_prefill_step``/``make_verify_step`` under ``NO_MESH``: logits
      within ``LOGIT_TOL`` (2e-2, the bf16 bound of tests/test_kernels.py),
      tokens and commit counts equal but at a printed near tie (a top-2
      logit gap below ``TIE_GAP``). The rounds accept 0, 1 and 2 drafts.
  (d) ``verify_attention_shard_ref`` against JAX's ``flash_attention(
      pos_offset=, return_stats=True)``: acc / l and m + log l.
"""
import dataclasses
import multiprocessing
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 150.0
SP_TOL = 2e-3
MOE_TOL = 6e-2
LOGIT_TOL = 2e-2
TIE_GAP = 2e-2
SP_SHAPE = dict(B=4, Sq=3, Hq=8, Hkv=2, S=64, D=16)
SP_CASES = {  # name: (cache lengths, chunk)
    "length 30": ([30] * 4, 16),
    "straddle 14": ([14] * 4, 16),
    "empty shards 5": ([5] * 4, 16),
    "unequal": ([30, 14, 20, 9], 16),
}
MOE_EXPERTS = (8, 6)
SERVE_ARCHS = ("granite-34b", "qwen3-moe-30b-a3b")
V, CHUNK, MAX_LEN, PROMPT, K = 256, 16, 64, 30, 4


# ---------------------------------------------------------------- the ranks


def _rank_main(rank, world, port, work, runners=None):
    from repro_torch.launch import mesh as M

    M.init_process_group(rank, world, f"tcp://127.0.0.1:{port}", timeout_s=RANK_TIMEOUT_S)
    job = torch.load(work / "job.pt", weights_only=False)
    mesh = M.make_debug_mesh(*job["mesh"], device="cpu", timeout_s=RANK_TIMEOUT_S)
    runners = runners or _RUNNERS
    out = {name: runners[case["kind"]](mesh, case) for name, case in job["cases"].items()}
    torch.save(out, work / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def _rows(mesh, n):
    """This rank's batch rows of n: the data coordinate's contiguous block."""
    b = n // mesh.shape["data"]
    return slice(mesh.coords["data"] * b, (mesh.coords["data"] + 1) * b)


def _run_sp(mesh, case):
    from repro_torch.distributed.collectives import sp_append_attend
    from repro_torch.models.layers import MeshContext
    from repro_torch.sharding.policy import local_shard

    ctx = MeshContext(mesh=mesh, batch_axes=("data",), model_axis="model", seq_shard_kv=True)
    rows = _rows(mesh, case["q"].shape[0])
    cache = [local_shard(case[n], ("data", "model", None, None), mesh) for n in ("kc", "vc")]
    out, kc, vc = sp_append_attend(case["q"][rows], cache[0], cache[1], case["kn"][rows],
                                   case["vn"][rows], case["clen"][rows], case["start"], ctx,
                                   chunk=case["chunk"])
    return {"out": out, "kc": kc, "vc": vc}


def _run_moe(mesh, case):
    from repro_torch.models import layers as L
    from repro_torch.sharding.policy import local_shard, make_policy

    cfg = case["cfg"]
    policy = make_policy(cfg, mesh)
    moe = L.MoE(cfg)
    with torch.no_grad():
        for name in ("router", "wg", "wu", "wd"):
            full = case["p"][name]
            spec = policy.param_spec_for(f"layers/moe/{name}", (1,) + tuple(full.shape))[1:]
            setattr(moe, name, torch.nn.Parameter(local_shard(full, spec, mesh),
                                                  requires_grad=False))
    ctx = dataclasses.replace(policy.ctx, seq_shard_kv=False)
    out, aux = L.moe_block(case["x"][_rows(mesh, case["x"].shape[0])], moe, cfg, ctx)
    return {"out": out, "aux": aux}


def _run_serve(mesh, case):
    from repro_torch.core import verification
    from repro_torch.models.model_zoo import build_model
    from repro_torch.sharding.policy import make_policy, shard_params

    cfg = case["cfg"]
    policy = make_policy(cfg, mesh)
    ctx = policy.ctx
    model = build_model(cfg)
    params = shard_params(case["params"], policy, device="cpu")
    cache = policy.shard_cache(model.make_cache(case["tokens"].shape[0], MAX_LEN, device="cpu",
                                                attn_chunk=CHUNK))
    tokens = case["tokens"][_rows(mesh, case["tokens"].shape[0])]
    logits, cache, _ = verification.make_prefill_step(model, ctx=ctx, attn_chunk=CHUNK)(
        params, cache, tokens)
    got = {"prefill": logits, "rounds": [], "cache_shape": tuple(cache["k"].shape),
           "seq_shard": ctx.seq_shard_kv}
    step = verification.make_verify_step(model, ctx=ctx, attn_chunk=CHUNK)
    for batch in case["batches"]:
        batch = policy.shard_batch(batch)
        h, _ = model.decode_forward(params, cache, batch["tokens_in"], attn_chunk=CHUNK, ctx=ctx)
        lg = model.lm_head(params, h, ctx)  # the step's logits (it rewrites the same rows)
        res, cache = step(params, cache, batch)
        got["rounds"].append({"logits": lg, "out_tokens": res.out_tokens,
                              "n_commit": res.n_commit})
    return got


_RUNNERS = {"sp": _run_sp, "moe": _run_moe, "serve": _run_serve}


# ---------------------------------------------------------------- spawning


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(job: dict, world: int, work: Path, runners=None):
    """Start ``job`` on ``world`` ranks: processes forked from a server that
    has imported torch (spawned ranks would each import it again). A case
    runs ``runners[case["kind"]]`` (default: this file's)."""
    work.mkdir(parents=True, exist_ok=True)
    torch.save(job, work / "job.pt")
    port = _free_port()
    mp = multiprocessing.get_context("forkserver")
    mp.set_forkserver_preload(["torch", "numpy"])
    procs = [mp.Process(target=_rank_main, args=(r, world, port, work, runners))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, work, time.monotonic() + RANK_TIMEOUT_S


def _finish(started):
    """Wait for the ranks (killed at the deadline); their outputs, by rank."""
    procs, work, deadline = started
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    assert not bad, f"ranks {bad} failed or timed out (exit codes "\
        f"{[p.exitcode for p in procs]})"
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


# ---------------------------------------------------------------- inputs


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _sp_inputs(lengths, chunk, seed=0):
    s = SP_SHAPE
    rng = np.random.default_rng(seed)
    arr = {n: rng.standard_normal(shape).astype(np.float32) for n, shape in (
        ("q", (s["B"], s["Sq"], s["Hq"], s["D"])), ("kc", (s["B"], s["S"], s["Hkv"], s["D"])),
        ("vc", (s["B"], s["S"], s["Hkv"], s["D"])), ("kn", (s["B"], s["Sq"], s["Hkv"], s["D"])),
        ("vn", (s["B"], s["Sq"], s["Hkv"], s["D"])))}
    case = {"kind": "sp", **{n: torch.from_numpy(a) for n, a in arr.items()},
            "clen": torch.tensor(lengths, dtype=torch.int32), "start": lengths[0], "chunk": chunk}
    return case


def _moe_inputs(E):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as jax_config
    from repro.models import layers as JL
    from repro_torch.configs.base import ModelConfig

    jcfg = dataclasses.replace(jax_config("qwen3-moe-30b-a3b").reduced(), num_experts=E,
                               experts_per_token=2, moe_d_ff=32)
    p = JL.init_moe(jax.random.key(0), jcfg)
    x = jax.random.normal(jax.random.key(1), (4, 8, jcfg.d_model), jnp.bfloat16)
    from repro_torch import bridge
    return jcfg, p, x, {"kind": "moe", "cfg": ModelConfig(**dataclasses.asdict(jcfg)),
                        "p": {k: bridge.to_tensor(np.asarray(v)) for k, v in p.items()},
                        "x": bridge.to_tensor(np.asarray(x))}


_JAX_MESH_CODE = textwrap.dedent("""
    import dataclasses, pickle
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import use_mesh
    from repro.configs.base import get_config
    from repro.distributed.collectives import sp_append_attend
    from repro.models import layers as JL
    from repro.models.layers import MeshContext
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    job = pickle.load(open("jax_job.pkl", "rb"))
    out = {}
    sp_ctx = MeshContext(mesh=mesh, batch_axes=("data",), model_axis="model", seq_shard_kv=True)
    sp = jax.jit(lambda *x, chunk: sp_append_attend(*x, sp_ctx, chunk=chunk),
                 static_argnames="chunk")
    for name, c in job["sp"].items():
        a = {k: jnp.asarray(v) for k, v in c["arrays"].items()}
        clen = jnp.asarray(c["clen"], jnp.int32)
        with use_mesh(mesh):
            o, kc, vc = sp(a["q"], a["kc"], a["vc"], a["kn"], a["vn"], clen,
                           jnp.int32(c["start"]), chunk=c["chunk"])
        for k, v in (("out", o), ("kc", kc), ("vc", vc)):
            out[f"sp {name} {k}"] = np.asarray(v, np.float32)
    moe_ctx = MeshContext(mesh=mesh, batch_axes=("data",), model_axis="model")
    for E in job["moe"]:
        cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), num_experts=E,
                                  experts_per_token=2, moe_d_ff=32)
        p = JL.init_moe(jax.random.key(0), cfg)
        x = jax.random.normal(jax.random.key(1), (4, 8, cfg.d_model), jnp.bfloat16)
        with use_mesh(mesh):
            o, _ = jax.jit(lambda x, p: JL.moe_block(x, p, cfg, moe_ctx))(x, p)
        out[f"moe {E}"] = np.asarray(o, np.float32)
    np.savez("out.npz", **out)
""")


# ---------------------------------------------------------------- (a), (b)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """One spawn of the (2, 4) mesh for (a) and (b) with the JAX package's own
    sharded runs in a subprocess beside it, the JAX NO_MESH serves of (c)
    computed meanwhile, then one spawn of the (2, 2) mesh for (c)."""
    import pickle

    work = tmp_path_factory.mktemp("meshes")
    sp = {name: _sp_inputs(lengths, chunk) for name, (lengths, chunk) in SP_CASES.items()}
    moe = {E: _moe_inputs(E) for E in MOE_EXPERTS}
    cases = {**{f"sp {n}": c for n, c in sp.items()},
             **{f"moe {E}": m[3] for E, m in moe.items()}}
    jax_job = {"sp": {n: {"arrays": {k: _f32(c[k]) for k in ("q", "kc", "vc", "kn", "vn")},
                          "clen": c["clen"].numpy(), "start": c["start"], "chunk": c["chunk"]}
                      for n, c in sp.items()},
               "moe": list(MOE_EXPERTS)}
    with open(work / "jax_job.pkl", "wb") as f:
        pickle.dump(jax_job, f)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX_MESH_CODE], cwd=work, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        started = _start({"mesh": (2, 4), "cases": cases}, 8, work / "mesh24")
        serve_cases, wants = {}, {}
        for arch in SERVE_ARCHS:
            serve_cases[arch], wants[arch] = _jax_serve(arch)
        ranks24 = _finish(started)
        ranks22 = _finish(_start({"mesh": (2, 2), "cases": serve_cases}, 4, work / "mesh22"))
        _, err = jax_proc.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-4000:]
    return {"inputs": sp, "moe": moe, "ranks": ranks24, "jax": dict(np.load(work / "out.npz")),
            "ranks22": ranks22, "wants": wants}


@pytest.fixture(scope="module")
def mesh24(meshes):
    return meshes


def _gather_rows(ranks, name, key, mesh=(2, 4)):
    """(batch rows of every data rank, model rank 0's), each model rank's
    copy equal to model rank 0's bit for bit."""
    n_data, n_model = mesh
    parts = []
    for d in range(n_data):
        first = ranks[d * n_model][name][key]
        for m in range(1, n_model):
            assert torch.equal(ranks[d * n_model + m][name][key], first), (name, key, d, m)
        parts.append(first)
    return torch.cat(parts)


def _gather_cache(ranks, name, key, mesh=(2, 4)):
    """The full (B, S, Hkv, D) cache from the ranks' (rows, sequence) pieces."""
    n_data, n_model = mesh
    return torch.cat([torch.cat([ranks[d * n_model + m][name][key] for m in range(n_model)], 1)
                      for d in range(n_data)])


@pytest.mark.parametrize("name", list(SP_CASES))
def test_sp_append_attend_matches_jax(mesh24, name):
    """(a): outputs against JAX's sharded sp_append_attend and its single
    device flash_attention over the appended cache; caches bit for bit."""
    import jax.numpy as jnp
    from repro.models.layers import flash_attention

    c = mesh24["inputs"][name]
    jax_out = mesh24["jax"]
    out = _gather_rows(mesh24["ranks"], f"sp {name}", "out")
    np.testing.assert_allclose(_f32(out), jax_out[f"sp {name} out"], atol=SP_TOL, rtol=0)
    start, Sq = c["start"], SP_SHAPE["Sq"]
    for key, fresh in (("kc", "kn"), ("vc", "vn")):
        got = _gather_cache(mesh24["ranks"], f"sp {name}", key)
        np.testing.assert_array_equal(_f32(got), jax_out[f"sp {name} {key}"])
        want = c[key].clone()
        want[:, start:start + Sq] = c[fresh]  # every row at row 0's length
        assert torch.equal(got, want), key
    kref, vref = (jnp.asarray(_f32(_gather_cache(mesh24["ranks"], f"sp {name}", k)))
                  for k in ("kc", "vc"))
    clen = jnp.asarray(c["clen"].numpy())
    single = flash_attention(jnp.asarray(_f32(c["q"])), kref, vref,
                             q_pos=clen[:, None] + jnp.arange(Sq)[None], kv_valid=clen + Sq,
                             chunk=c["chunk"])
    np.testing.assert_allclose(_f32(out), np.asarray(single, np.float32), atol=SP_TOL, rtol=0)


def test_sp_unequal_lengths_place_rows_alike(mesh24):
    """The padded-batch contract, kept for parity: at unequal lengths both
    packages write every row's fresh K/V at row 0's length (here 30), while
    each row's queries sit at its own; the rows of row 1 (length 14) land
    at 30..32, not at 14..16."""
    c = mesh24["inputs"]["unequal"]
    got = _gather_cache(mesh24["ranks"], "sp unequal", "kc")
    np.testing.assert_array_equal(_f32(got), mesh24["jax"]["sp unequal kc"])
    assert torch.equal(got[1, 30:33], c["kn"][1])
    assert torch.equal(got[1, 14:17], c["kc"][1, 14:17])


@pytest.mark.parametrize("E", MOE_EXPERTS)
def test_moe_block_under_the_mesh_matches_jax(mesh24, E):
    """(b): E 8 runs expert-parallel (2 experts a model rank), E 6
    tensor-parallel inside each expert (d_ff 32 in 4 slices of 8)."""
    import jax
    from repro.models.layers import NO_MESH, moe_block

    jcfg, p, x, _ = mesh24["moe"][E]
    out = _gather_rows(mesh24["ranks"], f"moe {E}", "out")
    ref, _ = jax.jit(lambda x, p: moe_block(x, p, jcfg, NO_MESH))(x, p)
    np.testing.assert_allclose(_f32(out), np.asarray(ref, np.float32), atol=MOE_TOL, rtol=MOE_TOL)
    np.testing.assert_allclose(_f32(out), mesh24["jax"][f"moe {E}"], atol=MOE_TOL, rtol=MOE_TOL)


# ---------------------------------------------------------------- (c)


def _jax_serve(arch: str):
    """The JAX reduced model's prefill and three verify rounds under
    NO_MESH, the drafts chosen so that round r accepts r drafts in every
    row: (port config, params as a torch tree, prompt, batches, results)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as jax_config
    from repro.core import verification as JV
    from repro.models.model_zoo import build_model as jax_build_model
    from repro_torch import bridge
    from repro_torch.configs.base import ModelConfig

    jcfg = dataclasses.replace(jax_config(arch).reduced(), vocab_size=V)
    if jcfg.family == "moe":  # the dropless twin: capacity >= the call's tokens
        jcfg = dataclasses.replace(jcfg, capacity_factor=jcfg.num_experts / jcfg.experts_per_token)
    jm = jax_build_model(jcfg)
    jp = jax.jit(jm.init_params)(jax.random.key(0))
    B = 4
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, V, size=(B, PROMPT)).astype(np.int32)
    prefill = jax.jit(JV.make_prefill_step(jm, attn_chunk=CHUNK))
    verify = jax.jit(JV.make_verify_step(jm, attn_chunk=CHUNK))

    @jax.jit
    def logits_of(p, c, t):
        h, _, _ = jm.decode_forward(p, c, t, attn_chunk=CHUNK)
        return jm.lm_head(p, h)

    pl, cache, last = prefill(jp, jm.make_cache(B, MAX_LEN, attn_chunk=CHUNK),
                              jnp.asarray(prompt))
    want = {"prefill": np.asarray(pl), "rounds": []}
    batches = []
    prev = np.asarray(last)
    for accept in range(3):
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
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = bridge.params_tree(bridge.params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                                     device="cpu"))
    case = {"kind": "serve", "cfg": cfg, "params": tree, "tokens": torch.from_numpy(prompt),
            "batches": batches}
    return case, want


@pytest.fixture(scope="module")
def mesh22(meshes):
    return meshes["ranks22"], meshes["wants"]


def _gap(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_verify_steps_under_a_mesh_match_jax(mesh22, arch):
    """(c): granite-34b's cache is sequence-sharded (one KV head), qwen3-moe's
    by KV head with its experts split; the logits, tokens and commits of
    every step against the JAX NO_MESH steps."""
    ranks, wants = mesh22
    want = wants[arch]
    mesh = (2, 2)
    assert ranks[0][arch]["seq_shard"] == (arch == "granite-34b")
    # each rank holds its piece of the cache: half the rows, and half the
    # sequence (granite) or half the KV heads (qwen3-moe)
    shape = ranks[0][arch]["cache_shape"]
    assert shape[1] == 2 and (shape[2] == MAX_LEN // 2 if arch == "granite-34b" else shape[3] == 2)
    got = _gather_rows(ranks, arch, "prefill", mesh)
    np.testing.assert_allclose(_f32(got), want["prefill"], atol=LOGIT_TOL, rtol=0)
    for r, w in enumerate(want["rounds"]):
        logits = torch.cat([ranks[d * 2][arch]["rounds"][r]["logits"] for d in range(2)])
        for m in range(2):
            for d in range(2):
                assert torch.equal(ranks[d * 2 + m][arch]["rounds"][r]["logits"],
                                   ranks[d * 2][arch]["rounds"][r]["logits"])
        np.testing.assert_allclose(_f32(logits), w["logits"], atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"round {r}")
        toks = torch.cat([ranks[d * 2][arch]["rounds"][r]["out_tokens"] for d in range(2)])
        commit = torch.cat([ranks[d * 2][arch]["rounds"][r]["n_commit"] for d in range(2)])
        gaps = _gap(w["logits"])
        for b in range(toks.shape[0]):
            if not (np.array_equal(toks[b].numpy(), w["out_tokens"][b])
                    and int(commit[b]) == int(w["n_commit"][b])):
                print(f"{arch} round {r} row {b}: tokens {toks[b].tolist()} vs "
                      f"{w['out_tokens'][b].tolist()}, top-2 gaps {gaps[b].tolist()}")
                assert gaps[b].min() < TIE_GAP, (arch, r, b)


def test_shard_ref_matches_jax_flash_stats():
    """(d): the shard form's plain version against JAX's flash_attention(
    pos_offset=, return_stats=True) on one shard: out = acc / l and
    lse = m + log l where a row sees the shard; -inf and 0 where not."""
    import jax.numpy as jnp
    from repro.models.layers import flash_attention
    from repro_torch.kernels import ref

    s = SP_SHAPE
    rng = np.random.default_rng(3)
    B, Sq, Hq, Hkv, D, S_loc = s["B"], 5, s["Hq"], s["Hkv"], s["D"], 32
    q = _bf16(rng.standard_normal((B, Sq, Hq, D)))
    k = _bf16(rng.standard_normal((B, S_loc, Hkv, D)))
    v = _bf16(rng.standard_normal((B, S_loc, Hkv, D)))
    kv_valid = np.array([40, 34, 70, 30], np.int32)  # row 3 sees none of [32, 64)
    for off in (0, 32):
        out, lse = ref.verify_attention_shard_ref(q, k, v, torch.from_numpy(kv_valid), off,
                                                  block_k=16)
        jq, jk, jv = (jnp.asarray(_f32(t), jnp.bfloat16) for t in (q, k, v))
        acc, m, l = flash_attention(
            jq, jk, jv, q_pos=jnp.asarray(kv_valid)[:, None] - Sq + jnp.arange(Sq)[None],
            kv_valid=jnp.asarray(kv_valid), chunk=16, pos_offset=off, return_stats=True)
        acc, m, l = (np.asarray(a, np.float32) for a in (acc, m, l))
        seen = (kv_valid - Sq + np.arange(Sq)[:, None]).T >= off  # (B, Sq)
        want = (acc / np.maximum(l, 1e-30)[..., None]).reshape(B, Sq, Hq, D)
        want_lse = (m + np.log(np.maximum(l, 1e-30))).reshape(B, Sq, Hq)
        got_lse = lse.transpose(1, 2).numpy()
        np.testing.assert_allclose(out.numpy()[seen], want[seen], atol=SP_TOL, rtol=0)
        np.testing.assert_allclose(got_lse[seen], want_lse[seen], atol=1e-4, rtol=1e-5)
        assert np.isneginf(got_lse[~seen]).all() and (out.numpy()[~seen] == 0).all()
        assert (~seen).any() == (off == 32)

