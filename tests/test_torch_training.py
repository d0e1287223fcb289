"""The port's training path (``repro_torch.training``, ``launch/train.py``, the
cache-free ``transformer.forward``) against the JAX package.

Reduced configs (``reduced()`` with vocab 160): dense qwen2-1.5b, moe
granite-moe-3b-a800m, vlm llava-next-mistral-7b (8 stub patches, JAX's stub
handed over), encdec whisper-tiny (32 stub frames), ssm mamba2-370m and
hybrid zamba2-1.2b (4 SSD layers, the shared block after every 2; also at 5
layers, a tail layer after the last group), B 2, S 16, ``loss_chunk`` 8,
``attn_chunk`` 16; the weights bridged from JAX, the SSD layers' decay,
skip and norm leaves at JAX's init values. The JAX
references are computed once per module. Cases: the data bit for bit; the
LR schedule bit for bit; one AdamW update on the same gradients and state;
the int8 compression; the plain attention backward (``attention_bwd_ref``)
against autograd of the plain forward; the forward, the loss and every
gradient; one train step and a 5-step trajectory; grad accumulation;
kill-and-resume in the port and across the two packages' checkpoints; the
launcher (also on mamba2-370m); no graph on the serving path. The JAX functions are
compiled at XLA's backend optimisation level 0 (``_compile``), which
halves their compile time on the CPU.

Tolerances: ``BF16_TOL`` (2e-2, absolute) for bf16 hidden states; the loss
within ``LOSS_REL`` (2e-3) relative; each gradient leaf within
``GRAD_REL`` (4e-2) relative Frobenius of JAX's, plus ``GRAD_FLOOR``
(1e-5) absolute. Every leaf but one is within 1e-2; whisper's encoder
value bias is 3.1e-2 off (its gradient sums the attention output's
gradient over every frame, where the two packages' bf16 roundings do not
cancel). A model without RoPE has a key bias whose exact gradient is zero
(the bias shifts every score of a row alike), so both packages give
rounding noise of ~1e-6 there, which the floor takes; the AdamW state within ``ADAM_REL``
(1e-6) relative; the attention backward within ``F32_REL`` (1e-5 of the
largest gradient) on f32 inputs and ``BF16_REL`` (2e-2) on bf16 inputs,
where the plain backward rounds P and O as the kernels do.
"""
import dataclasses
import functools
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
from repro.models.model_zoo import frontend_stub as jax_frontend_stub
from repro.training import data as jdata
from repro.training import optimizer as JO
from repro.training import train_step as JTS
from repro_torch import bridge
from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model
from repro_torch.training import data, optimizer as O, train_step as TS

BF16_TOL = 2e-2
LOSS_REL = 2e-3
GRAD_REL = 4e-2
GRAD_FLOOR = 1e-5
ADAM_REL = 1e-6
F32_REL = 1e-5
BF16_REL = 2e-2
B, S, VOCAB, CHUNK, LOSS_CHUNK = 2, 16, 160, 16, 8
FAMILIES = {"dense": "qwen2-1.5b", "moe": "granite-moe-3b-a800m",
            "vlm": "llava-next-mistral-7b", "encdec": "whisper-tiny",
            "ssm": "mamba2-370m", "hybrid": "zamba2-1.2b"}
# reduced configs changed further: (family, changes to ``reduced()``)
VARIANTS = {"hybrid_tail": ("hybrid", {"num_layers": 5})}
ADAM = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _tcfgs(**kw):
    shared = dict(loss_chunk=LOSS_CHUNK, attn_chunk=CHUNK, **kw)
    return (JTS.TrainConfig(optimizer=JO.AdamWConfig(**ADAM), **shared),
            TS.TrainConfig(optimizer=O.AdamWConfig(**ADAM), **shared))


def _t(a) -> torch.Tensor:
    return bridge.to_tensor(np.asarray(a))


def _f32(a) -> np.ndarray:
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = bridge.to_numpy(a)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _paths(tree):
    """(key path, leaf) of a JAX tree, the keys as strings."""
    return [(tuple(str(getattr(p, "key", getattr(p, "name", p))) for p in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@functools.lru_cache(maxsize=None)
def _pair(family: str):
    """(JAX config, model, params; port config, model, params) of the reduced
    config of ``family`` at vocab 160."""
    base, changes = VARIANTS.get(family, (family, {}))
    jcfg = dataclasses.replace(jax_config(FAMILIES[base]).reduced(), vocab_size=VOCAB, **changes)
    jm = jax_build_model(jcfg)
    kw = {"max_pos": 64} if not jcfg.use_rope else {}
    jp = _numpy_params(jax.eval_shape(lambda key: jm.init_params(key, **kw), jax.random.key(0)))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jm, jp, cfg, build_model(cfg), _port_params(cfg, jp)


# an SSD layer's leaves at JAX's init values (``init_ssd_layer``), by name,
# from the leaf's shape: (layers, heads) or (layers, width)
_SSD_INIT = {
    "A_log": lambda shape: np.broadcast_to(np.log(np.linspace(1.0, 16.0, shape[-1])), shape),
    "D": np.ones, "gnorm": np.ones, "conv_b": np.zeros,
    "dt_bias": lambda shape: np.full(shape, np.log(np.expm1(0.01))),
}


def _numpy_params(spec):
    """Weights for both packages from a numpy seed, in the layout of JAX's
    ``init_params`` (traced, not run: nothing to compile) and near its
    distributions: the norms' scales 1 and biases 0, an SSD layer's decay,
    skip, norm and conv bias leaves at JAX's values, its conv weights
    N(0, 0.2), N(0, 0.02) for every other leaf."""
    rng = np.random.default_rng(0)

    def leaf(path, s):
        name = path[-1].key
        if name in ("scale", "bias"):
            return jnp.full(s.shape, 1.0 if name == "scale" else 0.0, s.dtype)
        if name in _SSD_INIT:
            return jnp.asarray(_SSD_INIT[name](s.shape).astype(np.float32), s.dtype)
        std = 0.2 if name == "conv_w" else 0.02
        return jnp.asarray((std * rng.standard_normal(s.shape)).astype(np.float32), s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, spec)


def _port_params(cfg, jp):
    return bridge.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _batch(family: str, seed: int = 1):
    """A numpy batch: tokens, labels (B, S) and the JAX stub frontend."""
    jcfg = _pair(family)[0]
    toks = np.random.default_rng(seed).integers(0, VOCAB, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.family in ("vlm", "encdec"):
        batch["frontend"] = np.asarray(jax_frontend_stub(jcfg, B, jax.random.key(7)))
    return batch


def _front_kw(family, frontend):
    if family == "encdec":
        return {"enc_frames": frontend}
    return {"embeds_prefix": frontend} if family == "vlm" else {}


@functools.lru_cache(maxsize=None)
def _jax_ref(family: str):
    """JAX's forward (hidden, aux) and value_and_grad of its loss."""
    jcfg, jm, jp, *_ = _pair(family)
    jb = {k: jnp.asarray(v) for k, v in _batch(family).items()}
    grad_fn = jax.value_and_grad(JTS.make_loss_fn(jm, _tcfgs()[0]), has_aux=True)

    def both(p, b):  # one compile for the forward and the gradient
        h, aux = jm.forward(p, b["tokens"], attn_chunk=CHUNK,
                            **_front_kw(family, b.get("frontend")))
        return h, aux, grad_fn(p, b)

    h, aux, ((loss, met), grads) = _compile(both, jp, jb)(jp, jb)
    return h, aux, loss, met, grads


def _compile(fn, *args):
    """``jax.jit(fn)`` compiled at XLA's backend optimisation level 0: half
    the compile time on the CPU; the values move in their last f32 bits,
    far inside every tolerance here."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _port_batch(family: str, seed: int = 1):
    return {k: _t(v) for k, v in _batch(family, seed).items()}


# ---------------------------------------------------------------------------
# data, schedule, optimizer, compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["cluster", "markov"])
def test_batch_at_is_bit_equal(mode):
    for vocab, seq, batch in ((160, 17, 4), (512, 33, 2)):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=3, mode=mode)
        jd, pd = jdata.DataConfig(**kw), data.DataConfig(**kw)
        for step in (0, 1, 5, 1000):
            want, got = jdata.batch_at(jd, step), data.batch_at(pd, step)
            for key in ("tokens", "labels"):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])


def test_batch_at_frontend_is_seeded_by_step():
    from repro_torch.configs import get_config

    cfg = get_config("whisper-tiny").reduced()
    dcfg = data.DataConfig(vocab_size=VOCAB, seq_len=9, global_batch=2)
    a, b, c = (data.batch_at(dcfg, s, cfg)["frontend"] for s in (0, 0, 1))
    assert a.dtype == torch.bfloat16 and a.shape == (2, cfg.encoder_seq, cfg.d_model)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_lr_schedule_is_bit_equal():
    """Bit for bit with the JAX function run op by op (as it reads) at every
    step of the launcher's schedule and the tests' (0 to 2N + 2). At the
    default 10,000-step schedule XLA's f32 cosine is not correctly rounded
    at some angles (8 of 409 steps sampled), where the port's (taken in f64
    and rounded once) is: there the two stay within 1 ulp. XLA's jit folds
    the constants (a division into a reciprocal product, 0.5 * (1 + cos) *
    0.9 + 0.1 into (1 + cos) * 0.45 + 0.1), which moves the jitted
    schedule by a few ulps (up to 3 seen) from both."""
    for cfg_kw, exact in ((dict(lr=1e-3, warmup_steps=10, total_steps=40), True), (ADAM, True),
                          (dict(lr=3e-4, warmup_steps=100, total_steps=10_000), False)):
        jc, pc = JO.AdamWConfig(**cfg_kw), O.AdamWConfig(**cfg_kw)
        steps = np.arange(0, 2 * cfg_kw["total_steps"] + 3, 1 if exact else 49, dtype=np.int32)
        want = np.array([np.float32(JO.lr_schedule(jc, jnp.int32(s))) for s in steps])
        got = O.lr_schedule(pc, torch.from_numpy(steps)).numpy()
        assert got.dtype == np.float32
        ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32))
        assert ulps.max() <= (0 if exact else 1), (cfg_kw, steps[ulps > 0])
        jit = jax.jit(lambda s: JO.lr_schedule(jc, s))
        jitted = np.array([np.float32(jit(jnp.int32(s))) for s in steps[:24]])
        ulps = np.abs(jitted.view(np.int32).astype(np.int64) - got[:24].view(np.int32))
        assert ulps.max() <= 4, ulps


def _opt_trees(rng):
    """A params-like tree: a stacked per-layer 1-D leaf (L, d), a 3-D stacked
    matrix, an unstacked 1-D leaf and a bf16 2-D table."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    params = {"final_norm": {"scale": f32(8)}, "layers": {"ln1": {"scale": f32(3, 8)},
                                                         "attn": {"wq": f32(3, 8, 8)}},
              "embed": f32(16, 8)}
    grads = jax.tree.map(lambda p: (p * 0.1 + rng.standard_normal(p.shape)).astype(np.float32),
                         params)
    return params, grads


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(0)
    params, grads = _opt_trees(rng)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.5)
    jc, pc = JO.AdamWConfig(**cfg_kw), O.AdamWConfig(**cfg_kw)
    jstate = JO.adamw_init(jax.tree.map(jnp.asarray, params))
    pstate = O.adamw_init(jax.tree.map(torch.from_numpy, params))
    for _ in range(3):  # a few steps, so m, v and the bias corrections move
        jm, jstate, jmet = JO.adamw_update(jax.tree.map(jnp.asarray, grads), jstate, jc)
        pm, pstate, pmet = O.adamw_update(jax.tree.map(torch.from_numpy, grads), pstate, pc)
        grads = jax.tree.map(lambda g: g * 0.7, grads)
    assert int(pstate.step) == int(jstate.step) == 3
    for name in ("master", "m", "v"):
        for path, want in _paths(getattr(jstate, name)):
            np.testing.assert_allclose(_at(getattr(pstate, name), path).numpy(), np.asarray(want),
                                       rtol=ADAM_REL, atol=1e-9, err_msg=f"{name} {path}")
    np.testing.assert_allclose(float(pmet["grad_norm"]), float(jmet["grad_norm"]), rtol=ADAM_REL)
    np.testing.assert_allclose(float(pmet["lr"]), float(jmet["lr"]), rtol=ADAM_REL)
    cast = O.cast_like({"w": torch.zeros(2, dtype=torch.bfloat16)}, {"w": torch.full((2,), 1.006)})
    assert cast["w"].dtype == torch.bfloat16 and float(cast["w"][0]) == 1.0078125
    # the stacked per-layer norm scale is decayed (JAX's leaf is 2-D), the
    # unstacked final norm is not: with decay off, only the former moves
    nodecay = O.AdamWConfig(**{**cfg_kw, "weight_decay": 0.0})
    # the update is in place: each of the two runs from its own copy
    with_wd, without = (O.adamw_update(jax.tree.map(torch.from_numpy, grads),
                                       jax.tree.map(torch.clone, pstate), c)[0]
                        for c in (pc, nodecay))
    for leaf, decayed in ((("layers", "ln1", "scale"), True), (("final_norm", "scale"), False)):
        assert (not torch.equal(_at(with_wd, leaf), _at(without, leaf))) == decayed, leaf


def test_compress_grads_int8_is_equal():
    rng = np.random.default_rng(1)
    _, grads = _opt_trees(rng)
    jerr = perr = None
    for i in range(3):
        g = jax.tree.map(lambda x: x * (1 + i), grads)
        jdeq, jerr = JO.compress_grads_int8(jax.tree.map(jnp.asarray, g), jerr)
        pdeq, perr = O.compress_grads_int8(jax.tree.map(torch.from_numpy, g), perr)
        for tree_j, tree_p in ((jdeq, pdeq), (jerr, perr)):
            for path, want in _paths(tree_j):
                np.testing.assert_array_equal(_at(tree_p, path).numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the plain attention backward
# ---------------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, kv_valid, causal, block_k)
ATTN_CASES = {
    "causal_sq_eq_skv_g1_d16": (2, 16, 16, 2, 2, 16, [16, 16], True, 16),
    "causal_offset_g2_d64": (2, 8, 24, 4, 2, 64, [24, 13], True, 16),
    "noncausal_sq_ne_skv_g3_d16": (2, 5, 40, 6, 2, 16, [40, 17], False, 16),
    "causal_unseen_chunks_g3_d64": (1, 12, 12, 3, 1, 64, [12], True, 4),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_bwd_ref_matches_autograd(case, dtype):
    Bq, Sq, Skv, Hq, Hkv, D, kvv, causal, block_k = ATTN_CASES[case]
    gen = torch.Generator().manual_seed(0)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v = (torch.randn(*shape, generator=gen).to(dt).requires_grad_()
               for shape in ((Bq, Sq, Hq, D), (Bq, Skv, Hkv, D), (Bq, Skv, Hkv, D)))
    kv_valid = torch.tensor(kvv, dtype=torch.int32)
    out = ref.verify_attention_ref(q, k, v, kv_valid, block_k=block_k, causal=causal)
    dout = torch.randn(out.shape, generator=gen).to(dt)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(), dout, kv_valid,
                                causal=causal)
    tol = F32_REL if dtype == "f32" else BF16_REL
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype == dt and bool(torch.isfinite(w).all()), name
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err <= tol, (name, float(err))
    # a causal limit one position late is far outside the bound
    late = ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(), dout,
                                 kv_valid + 1, causal=causal)
    worst = max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
                for g, w in zip(late, want))
    assert worst > 5 * BF16_REL, worst


def test_plain_attention_gradient_is_finite_where_a_row_sees_nothing():
    """Rows that see no position of a chunk, and rows that see none at all
    (kv_valid < Sq, outside training), keep finite gradients."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 6, 2, 16, generator=gen).requires_grad_()
    k = torch.randn(2, 12, 1, 16, generator=gen).requires_grad_()
    v = torch.randn(2, 12, 1, 16, generator=gen).requires_grad_()
    out = ref.verify_attention_ref(q, k, v, torch.tensor([3, 12], dtype=torch.int32), block_k=4)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[0][0, :2].abs().max()) == 0.0  # rows 0 and 1 of entry 0 see nothing


# ---------------------------------------------------------------------------
# forward, loss and gradients against JAX
# ---------------------------------------------------------------------------


def _check_forward(family):
    *_, cfg, pm, pp = _pair(family)
    jh, jaux = _jax_ref(family)[:2]
    pb = _port_batch(family)
    with torch.no_grad():
        h, aux = pm.forward(pp, pb["tokens"], attn_chunk=CHUNK,
                            **_front_kw(family, pb.get("frontend")))
    assert h.shape == jh.shape and h.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(h), _f32(jh), atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == (family == "moe")


def _check_loss_and_gradients(family):
    *_, cfg, pm, pp = _pair(family)
    _, _, jloss, jmet, jgrads = _jax_ref(family)
    _, ptcfg = _tcfgs()
    pp = _port_params(cfg, _pair(family)[2])  # a fresh copy: gradients are turned on
    for p in pp.parameters():
        p.requires_grad_(True)
    loss, met = TS.make_loss_fn(pm, ptcfg)(pp, _port_batch(family))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_REL)
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]), rtol=1e-5, atol=1e-7)
    grads = bridge.grads_tree(pp)
    for path, want in _paths(jgrads):
        got = _at(grads, path)
        assert got.dtype == bridge.to_tensor(np.asarray(want)).dtype, path
        w, g = _f32(want), _f32(got)
        assert np.isfinite(g).all(), path
        err = np.linalg.norm(g - w)
        assert err <= GRAD_REL * np.linalg.norm(w) + GRAD_FLOOR, (path, err, np.linalg.norm(w))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_jax(family):
    _check_forward(family)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_gradients_match_jax(family):
    _check_loss_and_gradients(family)


def test_hybrid_with_a_tail_matches_jax():
    """zamba2 reduced to 5 SSD layers: two groups of 2, each followed by
    the shared block, then one tail layer; forward, loss and every
    gradient held to JAX."""
    assert _pair("hybrid_tail")[3].num_layers % _pair("hybrid_tail")[3].attn_every == 1
    _check_forward("hybrid_tail")
    _check_loss_and_gradients("hybrid_tail")


def test_training_builds_no_graph_on_the_serving_path():
    *_, cfg, pm, pp = _pair("dense")
    assert not any(p.requires_grad for p in pp.parameters())
    h, _ = pm.forward(pp, _port_batch("dense")["tokens"], attn_chunk=CHUNK)
    assert h.grad_fn is None


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_ssm_and_hybrid_build_no_graph_on_the_serving_path(family):
    """Serving weights take no gradient: the training forward and a
    prefill build no graph through the SSD scan."""
    *_, cfg, pm, pp = _pair(family)
    assert not any(p.requires_grad for p in pp.parameters())
    tokens = _port_batch(family)["tokens"]
    h, _ = pm.forward(pp, tokens, attn_chunk=CHUNK)
    logits, cache = pm.prefill(pp, tokens, pm.make_cache(B, 2 * S, device="cpu"),
                               attn_chunk=CHUNK)
    assert h.grad_fn is None and logits.grad_fn is None and cache["ssm"].grad_fn is None


def test_moe_tally_counts_once_under_remat():
    *_, cfg, pm, pp = _pair("moe")
    pp = _port_params(cfg, _pair("moe")[2])
    for p in pp.parameters():
        p.requires_grad_(True)
    tallies = []
    for remat in (False, True):
        L.reset_moe_tally()
        h, aux = pm.forward(pp, _port_batch("moe")["tokens"], attn_chunk=CHUNK, remat=remat)
        (h.float().square().mean() + aux).backward()
        tallies.append(L.moe_tally("cpu").clone())
    assert torch.equal(tallies[0], tallies[1])
    assert int(tallies[0][0]) == cfg.num_layers * B * S * cfg.experts_per_token


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

TRAJ_STEPS = 5


@functools.lru_cache(maxsize=None)
def _jax_trajectory(family: str = "dense"):
    """JAX's reduced ``family`` trained TRAJ_STEPS steps on batch_at's data:
    (metrics per step, the (params, opt) after 2 steps)."""
    jcfg, jm, jp, *_ = _pair(family)
    dcfg = jdata.DataConfig(vocab_size=VOCAB, seq_len=S + 1, global_batch=B)
    params, opt, err, mets, at2 = jp, JO.adamw_init(jp), None, [], None
    step = None
    for s in range(TRAJ_STEPS):
        b = {k: jnp.asarray(v) for k, v in jdata.batch_at(dcfg, s).items()}
        if step is None:
            step = _compile(JTS.make_train_step(jm, _tcfgs()[0]), params, opt, err, b)
        params, opt, err, m = step(params, opt, err, b)
        mets.append({k: float(v) for k, v in m.items()})
        if s == 1:
            at2 = (params, opt)
    return mets, at2


def _port_start(family="dense"):
    """(model, fresh port params bridged from JAX, their AdamW state)."""
    *_, cfg, pm, _ = _pair(family)
    pp = _port_params(cfg, _pair(family)[2])
    return pm, pp, O.adamw_init(bridge.params_tree(pp))


def _run(step, pm, pp, opt, steps, dcfg):
    mets, err = [], None
    for s in steps:
        b = {k: torch.as_tensor(v) for k, v in data.batch_at(dcfg, s, pm.cfg).items()}
        pp, opt, err, m = step(pp, opt, err, b)
        mets.append({k: float(v) for k, v in m.items()})
    return pp, opt, mets


def _dcfg():
    return data.DataConfig(vocab_size=VOCAB, seq_len=S + 1, global_batch=B)


def _check_trajectory(family, falls=True):
    want, _ = _jax_trajectory(family)
    pm, pp, opt = _port_start(family)
    _, opt, got = _run(TS.make_train_step(pm, _tcfgs()[1]), pm, pp, opt, range(TRAJ_STEPS),
                       _dcfg())
    assert int(opt.step) == TRAJ_STEPS
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got[0][key], want[0][key], rtol=LOSS_REL, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose([m["loss"] for m in got], [m["loss"] for m in want],
                               rtol=LOSS_REL)
    if falls:
        assert got[-1]["loss"] < got[0]["loss"]


def test_train_steps_track_jax():
    _check_trajectory("dense")


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_ssm_and_hybrid_train_steps_track_jax(family):
    """5 steps of the reduced mamba2 and zamba2 against JAX's: the SSD
    leaves (L, H) and (L, d_inner) decayed, the shared block's 1-D norm
    scales not, as JAX's rule reads the ranks of its tree. In 5 steps on
    fresh batches neither package's loss falls (JAX's: 5.081 to 5.086 and
    5.023 to 5.144), so the port is held to JAX's every step."""
    _check_trajectory(family, falls=False)


def test_grad_accum_matches_full_batch():
    """grad_accum=4 gives the update of one batch of 8 (same math, another
    schedule), as the JAX package's test holds it."""
    dcfg = data.DataConfig(vocab_size=VOCAB, seq_len=S + 1, global_batch=8)
    outs = {}
    for accum in (1, 4):
        pm, pp, opt = _port_start()
        step = TS.make_train_step(pm, _tcfgs(grad_accum=accum)[1])
        pp, _, mets = _run(step, pm, pp, opt, [0], dcfg)
        outs[accum] = (bridge.params_tree(pp), mets[0]["loss"])
    np.testing.assert_allclose(outs[1][1], outs[4][1], rtol=2e-2)
    for path, a in _paths(jax.tree.map(_f32, outs[1][0])):
        np.testing.assert_allclose(_f32(_at(outs[4][0], path)), a, rtol=0.1, atol=5e-3)


def test_compressed_train_step_runs_and_carries_error():
    pm, pp, opt = _port_start()
    step = TS.make_train_step(pm, _tcfgs(compress_grads=True)[1])
    b = {k: torch.as_tensor(v) for k, v in data.batch_at(_dcfg(), 0).items()}
    _, _, err, m = step(pp, opt, None, b)
    assert np.isfinite(float(m["loss"]))
    assert 0 < float(sum(e.abs().sum() for e in O.tree_leaves(err)))


def test_checkpoint_resume_bitwise():
    """Kill-and-resume reproduces the uninterrupted trajectory bit for bit."""
    step_of = lambda pm: TS.make_train_step(pm, _tcfgs()[1])  # noqa: E731
    pm, pp, opt = _port_start()
    full, _, mets_full = _run(step_of(pm), pm, pp, opt, range(4), _dcfg())
    pm, pp, opt = _port_start()
    pp, opt, _ = _run(step_of(pm), pm, pp, opt, range(2), _dcfg())
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 2, {"p": bridge.params_tree(pp), "opt": opt})
        pm, fresh, opt0 = _port_start()
        state, _ = ckpt.restore(d, {"p": bridge.params_tree(fresh), "opt": opt0}, device="cpu")
    assert isinstance(state["opt"], O.AdamWState) and int(state["opt"].step) == 2
    assert state["opt"].step.shape == () and state["opt"].step.dtype == torch.int32
    bridge.load_params_(fresh, state["p"])
    resumed, _, mets = _run(step_of(pm), pm, fresh, state["opt"], range(2, 4), _dcfg())
    assert mets[-1]["loss"] == mets_full[-1]["loss"]
    for path, a in _paths(jax.tree.map(_bits, bridge.params_tree(full))):
        np.testing.assert_array_equal(_bits(_at(bridge.params_tree(resumed), path)), a)


def test_checkpoints_cross_packages():
    """JAX trains 2 steps and saves; the port restores and runs step 3 (its
    loss near JAX's step 3); a state the port saves restores in JAX bit for
    bit."""
    want, (jparams, jopt) = _jax_trajectory()
    pm, fresh, opt0 = _port_start()
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 2, {"params": jparams, "opt": jopt})
        state, _ = ckpt.restore(d, {"params": bridge.params_tree(fresh), "opt": opt0},
                                device="cpu")
    bridge.load_params_(fresh, state["params"])
    pp, popt, mets = _run(TS.make_train_step(pm, _tcfgs()[1]), pm, fresh, state["opt"], [2],
                          _dcfg())
    np.testing.assert_allclose(mets[0]["loss"], want[2]["loss"], rtol=LOSS_REL)
    assert int(popt.step) == 3

    tree = {"params": bridge.params_tree(pp), "opt": popt}
    like = {"params": jparams, "opt": jopt}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 3, tree)
        back, _ = jckpt.restore(d, like)
    assert isinstance(back["opt"], JO.AdamWState)
    theirs = dict(_paths(back))
    for path, mine in _paths(jax.tree.map(_bits, tree)):
        np.testing.assert_array_equal(_bits(theirs[path]), mine, err_msg=str(path))


def test_opt_state_bridges_both_ways():
    _, (jparams, jopt) = _jax_trajectory()
    port = O.opt_state_from_jax(jax.tree.map(np.asarray, jopt), device="cpu")
    assert port.step.dtype == torch.int32 and port.step.shape == () and int(port.step) == 2
    back = O.opt_state_to_jax(port)
    for (path, a), (_, b) in zip(_paths(jopt), _paths(back)):
        np.testing.assert_array_equal(np.asarray(b), _bits(a), err_msg=str(path))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--smoke", "--steps", "4", "--seq", "16", "--batch", "2"]


def _fail_and_resume(capsys, launch):
    with tempfile.TemporaryDirectory() as d:
        straight, broken = os.path.join(d, "a"), os.path.join(d, "b")
        assert launch_train.main([*launch, "--device", "cpu", "--ckpt-dir", straight]) == 0
        with pytest.raises(SystemExit) as e:
            launch_train.main([*launch, "--device", "cpu", "--ckpt-dir", broken, "--fail-at", "3",
                               "--ckpt-every", "2"])
        assert e.value.code not in (0, None)
        assert ckpt.latest_step(broken) == 3  # written after step 2: three steps done
        assert launch_train.main([*launch, "--device", "cpu", "--ckpt-dir", broken,
                                  "--ckpt-every", "2"]) == 0
        out = capsys.readouterr().out
        assert "[resume] restored step 3" in out
        assert ckpt.latest_step(broken) == 4
        _assert_same_checkpoint(straight, broken, 4)
        lasts = [ln.split(" launches ", 1)[0] for ln in out.splitlines()
                 if ln.startswith("done. last loss")]
        assert len(lasts) == 2 and lasts[0] == lasts[1]


def test_launcher_fails_then_resumes_bitwise(capsys):
    _fail_and_resume(capsys, LAUNCH)


def test_launcher_trains_mamba2_and_resumes_bitwise(capsys):
    _fail_and_resume(capsys, [*LAUNCH, "--arch", "mamba2-370m"])


def test_launcher_extends_a_finished_run_bitwise(capsys):
    """--steps 2 and then --steps 4 in the same directory give the state of
    a straight --steps 4 run: the rerun starts at step 2, the one after the
    last that ran (the schedule's warmup of 10 steps makes the two runs'
    learning rates equal)."""
    with tempfile.TemporaryDirectory() as d:
        straight, extended = os.path.join(d, "a"), os.path.join(d, "b")
        assert launch_train.main([*LAUNCH, "--device", "cpu", "--ckpt-dir", straight]) == 0
        short = [*LAUNCH[:1], "--steps", "2", *LAUNCH[3:]]
        assert launch_train.main([*short, "--device", "cpu", "--ckpt-dir", extended]) == 0
        assert ckpt.latest_step(extended) == 2
        assert launch_train.main([*LAUNCH, "--device", "cpu", "--ckpt-dir", extended]) == 0
        assert "[resume] restored step 2" in capsys.readouterr().out
        _assert_same_checkpoint(straight, extended, 4)


def _assert_same_checkpoint(dir_a: str, dir_b: str, step: int) -> None:
    a = np.load(os.path.join(dir_a, f"step_{step:09d}", "arrays.npz"))
    b = np.load(os.path.join(dir_b, f"step_{step:09d}", "arrays.npz"))
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:  # shapes and dtypes too: a 0-d step stays 0-d
        assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    steps = [k for k in a.files if k.endswith("step")]
    assert steps and all(int(a[k]) == step for k in steps), steps


def test_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main([*LAUNCH, "--ckpt-dir", "/nonexistent/never-written"])
