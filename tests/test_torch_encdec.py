"""The encdec family of the port (whisper-tiny) against the JAX package.

The reduced whisper-tiny (2 decoder and 2 encoder layers of 64, 4 heads of
16 on 4 KV heads, the gelu MLP, layernorm, learned positions, QKV bias,
vocab 256, ``encoder_seq`` 32) on weights bridged from the JAX package
(``bridge.params_from_jax``); the JAX stub frontend's frames go to both.
The same numpy inputs go through the JAX functions (jitted, XLA on the
CPU) and the port on the CPU: the layernorm, the encoder, the prefill with
frames (logits and every cache leaf, the cross leaves included),
``decode_forward`` on a dense cache and on a pool (``slots=``), commit,
``make_prefill_step(with_frontend=True)`` and the paged verify step, a
PagedKVCache round trip of the cross leaves, an encoder length that is not
a multiple of ``attn_chunk`` (JAX's pad path), a prompt past the decoder's
position table (the clamp) and an int8 self-attention pool beside the
bf16 cross leaves. At kernel level the plain attention's non-causal case
(``kernels/ref.py``, ``causal=False``) is held to JAX's XLA
``flash_attention(causal=False)``, the kernel's split decomposition to the
plain version bit for bit.

Tolerances: ``BF16_TOL`` (2e-2) for bf16 outputs and K/V, ``F32_TOL``
(2e-3) for f32 logits (those of tests/test_kernels.py); greedy argmaxes
equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import verification as jax_verification
from repro.models import kvcache as jax_kvcache
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro.models.model_zoo import frontend_stub as jax_frontend_stub
from repro_torch import bridge
from repro_torch.api import ServeSpec, System
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import verification
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.kvcache import PagedKVCache, gather_slots, scatter_slots
from repro_torch.models.model_zoo import build_model, frontend_stub
from test_torch_serve import SPEC_JSON

BF16_TOL = 2e-2
F32_TOL = 2e-3
CHUNK = 16
MAX_LEN = 64
MAX_POS = 64
B = 2


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0, err_msg=what)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return bridge.to_numpy(a).view(np.uint16) if a.dtype == torch.bfloat16 \
            else bridge.to_numpy(a)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _t(a) -> torch.Tensor:
    return bridge.to_tensor(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _pair(max_pos: int = MAX_POS, **changes):
    """(JAX config, model, params; port config, model, params) of the
    reduced whisper-tiny with ``changes``."""
    jcfg = dataclasses.replace(jax_config("whisper-tiny").reduced(), **changes)
    jm = jax_build_model(jcfg)
    jp = jax.jit(functools.partial(jm.init_params, max_pos=max_pos))(jax.random.key(0))
    cfg = _port_cfg(jcfg)
    return (jcfg, jm, jp, cfg, build_model(cfg),
            bridge.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu"))


def _frames(jcfg, F: int = 0):
    stub = jax_frontend_stub(jcfg, B, jax.random.key(7))
    return stub[:, :F] if F else stub


@functools.lru_cache(maxsize=None)
def _jax_prefill(P: int = 11, F: int = 0, kv_dtype: str = "bf16", max_pos: int = MAX_POS,
                 **changes):
    """JAX's prefill of a (B, P) prompt behind the stub frames: (tokens,
    frames, logits, cache), and the port's on the same inputs."""
    jcfg, jm, jp, cfg, pm, pp = _pair(max_pos, **changes)
    toks = np.random.default_rng(P).integers(0, jcfg.vocab_size, size=(B, P)).astype(np.int32)
    frames = _frames(jcfg, F)
    enc_len = frames.shape[1]
    jdt = jnp.int8 if kv_dtype == "int8" else jnp.bfloat16
    jl, jc = jax.jit(lambda p, t, f: jm.prefill(
        p, t, jm.make_cache(B, MAX_LEN, attn_chunk=CHUNK, enc_len=enc_len, kv_dtype=jdt),
        attn_chunk=CHUNK, enc_frames=f))(jp, jnp.asarray(toks), frames)
    cache = pm.make_cache(B, MAX_LEN, device="cpu", attn_chunk=CHUNK, enc_len=enc_len,
                          kv_dtype=kv_dtype)
    pl, pc = pm.prefill(pp, torch.from_numpy(toks), cache, attn_chunk=CHUNK,
                        enc_frames=_t(frames))
    return toks, frames, (jl, jc), (pl, pc)


def _assert_cache_close(pc, jc, what):
    assert sorted(pc) == sorted(jc), what
    for name, want in jc.items():
        got = pc[name]
        assert tuple(got.shape) == tuple(np.shape(want)), (what, name)
        if name == "length":
            assert got.tolist() == np.asarray(want).tolist(), (what, name)
        elif got.dtype == torch.int8:
            assert np.abs(_bits(got).astype(np.int32)
                          - np.asarray(want).astype(np.int32)).max() <= 1, (what, name)
        else:
            _close(got, want, BF16_TOL if got.dtype == torch.bfloat16 else F32_TOL,
                   f"{what}: {name}")


def test_config_equals_jax():
    """The port's whisper-tiny: every field and the parameter count equal
    JAX's, the published widths (arXiv:2212.04356), and JAX's encdec cut."""
    cfg, jcfg = get_config("whisper-tiny"), jax_config("whisper-tiny")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert (cfg.family, cfg.num_layers, cfg.encoder_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.act, cfg.norm,
            cfg.use_rope, cfg.qkv_bias, cfg.is_encdec, cfg.encoder_seq) == (
        "encdec", 4, 4, 384, 6, 6, 64, 1536, 51865, "gelu", "layernorm", False, True, True,
        1500)
    red = cfg.reduced()
    assert dataclasses.asdict(red) == dataclasses.asdict(jcfg.reduced())
    assert (red.encoder_layers, red.encoder_seq, red.num_layers, red.head_dim) == (2, 32, 2, 16)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_layernorm_equals_jax(dtype):
    """``layers.layernorm`` against the JAX one at its rounding points: a
    bf16 input within one bf16 rounding of JAX's, an f32 input within f32
    summation order; the module's ones/zeros init is JAX's."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 40, 64)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want = jax.jit(JL.layernorm)(xj, jnp.asarray(scale), jnp.asarray(bias))
    got = L.layernorm(_t(xj), torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    _close(got, want, BF16_TOL if dtype == "bf16" else 1e-5, "layernorm")
    if dtype == "bf16":
        assert (_bits(got) == _bits(want)).mean() > 0.999
    norm = L.make_norm(_port_cfg(jax_config("whisper-tiny").reduced()))
    init = JL.init_norm(64, "layernorm")
    assert isinstance(norm, L.LayerNorm)
    np.testing.assert_array_equal(norm.scale.numpy(), init["scale"])
    np.testing.assert_array_equal(norm.bias.numpy(), init["bias"])


def test_encode_equals_jax():
    """The bidirectional encoder over the stub frames: frames cast to bf16
    plus the position table, every block non-causal, the final layernorm."""
    jcfg, _, jp, cfg, _, pp = _pair()
    frames = _frames(jcfg)
    want = jax.jit(lambda p, f: JT.encode(jcfg, p, f, attn_chunk=CHUNK))(jp, frames)
    got = T.encode(cfg, pp, _t(frames), attn_chunk=CHUNK)
    assert got.shape == (B, jcfg.encoder_seq, jcfg.d_model) and got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL, "encode")
    assert (_bits(got) == _bits(want)).mean() > 0.99


def test_prefill_with_frames_equals_jax():
    """prefill(enc_frames=): the last logits (and their argmax), K, V, the
    cross leaves (one K/V pair per layer from the shared encoder output)
    and the length."""
    _, _, (jl, jc), (pl, pc) = _jax_prefill()
    _close(pl, jl, F32_TOL, "logits")
    assert pl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    _assert_cache_close(pc, jc, "prefill")
    assert pc["cross_k"].dtype == torch.bfloat16 and pc["length"].tolist() == [11, 11]


def _pool(pm, rows: int, enc_len: int, kv_dtype="bf16"):
    return pm.make_cache(rows, MAX_LEN, device="cpu", attn_chunk=CHUNK, enc_len=enc_len,
                         kv_dtype=kv_dtype)


@pytest.mark.parametrize("form", ["dense", "slots"])
def test_decode_forward_equals_jax(form):
    """A verify-shaped decode (S = 5) after the prefill, the rows rolled back
    to uneven lengths: on the dense cache, and on a pool of 4 rows holding
    the prefilled rows at slots [3, 1] (``slots=``, the paged path): the
    logits, their argmaxes and every leaf of the cache or pool."""
    jcfg, jm, jp, cfg, pm, pp = _pair()
    toks, frames, (_, jc), (_, pc) = _jax_prefill()
    fresh = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=(B, 5)).astype(np.int32)
    lengths = np.array([11, 8], np.int32)
    jc = {**jc, "length": jnp.asarray(lengths)}
    pc = {**{k: v.clone() for k, v in pc.items()}, "length": torch.from_numpy(lengths)}
    if form == "slots":
        slots = np.array([3, 1], np.int32)
        jpool = jax_kvcache.scatter_slots(
            jm.make_cache(4, MAX_LEN, attn_chunk=CHUNK, enc_len=jcfg.encoder_seq),
            jnp.asarray(slots), jc)
        ppool = scatter_slots(_pool(pm, 4, jcfg.encoder_seq), torch.from_numpy(slots), pc)
        jh, jc2, _ = jax.jit(lambda p, c, t, s: jm.decode_forward(
            p, c, t, attn_chunk=CHUNK, slots=s))(jp, jpool, jnp.asarray(fresh),
                                                 jnp.asarray(slots))
        ph, pc2 = pm.decode_forward(pp, ppool, torch.from_numpy(fresh), attn_chunk=CHUNK,
                                    slots=torch.from_numpy(slots))
    else:
        jh, jc2, _ = jax.jit(lambda p, c, t: jm.decode_forward(p, c, t, attn_chunk=CHUNK))(
            jp, jc, jnp.asarray(fresh))
        ph, pc2 = pm.decode_forward(pp, pc, torch.from_numpy(fresh), attn_chunk=CHUNK)
    jl, pl = jm.lm_head(jp, jh), pm.lm_head(pp, ph)
    _close(pl, jl, F32_TOL, f"{form} logits")
    assert pl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    _assert_cache_close(pc2, jc2, form)


def test_commit_equals_jax():
    """The attention family's commit: ``length += n_commit``, every other
    leaf (the cross leaves too) as it was."""
    _, jm, _, _, pm, _ = _pair()
    _, _, (_, jc), (_, pc) = _jax_prefill()
    n = np.array([3, 1], np.int32)
    want = jm.commit(jc, jnp.asarray(n))
    got = pm.commit(pc, torch.from_numpy(n))
    assert got["length"].tolist() == np.asarray(want["length"]).tolist() == [14, 12]
    assert got["cross_k"] is pc["cross_k"] and got["cross_v"] is pc["cross_v"]
    assert sorted(got) == sorted(want)


def _greedy_drafts(jm, jp, jc, last, k: int):
    """JAX's greedy continuation of each row: k tokens after ``last``."""
    step = jax.jit(lambda p, c, t: jm.decode_forward(p, c, t, attn_chunk=CHUNK))
    out, tok = [], jnp.asarray(last)[:, None]
    for _ in range(k):
        h, c2, _ = step(jp, jc, tok)
        jc = jm.commit(c2, jnp.ones((B,), jnp.int32))
        tok = jnp.argmax(jm.lm_head(jp, h)[:, -1], axis=-1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok[:, 0]))
    return np.stack(out, axis=1)


def test_prefill_step_and_paged_verify_step_equal_jax():
    """``make_prefill_step(with_frontend=True)`` hands the stub frames to the
    encoder (the cache left at prompt - 1, the last token returned), the
    rows go into a pool of 3 slots and a scratch row, and two rounds of
    ``make_paged_verify_step`` (K = 4; row 0 drafts JAX's greedy
    continuation, row 1 a wrong first draft) commit what JAX's commit:
    accepted counts, output tokens and pool lengths."""
    jcfg, jm, jp, cfg, pm, pp = _pair()
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, size=(B, 12)).astype(np.int32)
    frames = _frames(jcfg)
    F = jcfg.encoder_seq
    jstep = jax_verification.make_prefill_step(jm, attn_chunk=CHUNK, with_frontend=True)
    jl, jc, jlast = jax.jit(jstep)(jp, jm.make_cache(B, MAX_LEN, attn_chunk=CHUNK, enc_len=F),
                                   jnp.asarray(toks), frames)
    step = verification.make_prefill_step(pm, attn_chunk=CHUNK, with_frontend=True)
    pl, pc, plast = step(pp, pm.make_cache(B, MAX_LEN, device="cpu", attn_chunk=CHUNK,
                                           enc_len=F), torch.from_numpy(toks), _t(frames))
    assert pc["length"].tolist() == np.asarray(jc["length"]).tolist() == [11, 11]
    assert plast.tolist() == np.asarray(jlast).tolist()
    _close(pl, jl, F32_TOL, "prefill step logits")
    _assert_cache_close(pc, jc, "prefill step")

    slots = np.array([2, 0], np.int32)
    jpool = jax_kvcache.scatter_slots(jm.make_cache(4, MAX_LEN, attn_chunk=CHUNK, enc_len=F),
                                      jnp.asarray(slots), jc)
    ppool = scatter_slots(_pool(pm, 4, F), torch.from_numpy(slots), pc)
    greedy = _greedy_drafts(jm, jp, jc, jlast, 4)
    drafts = greedy.copy()
    drafts[1, 0] = (drafts[1, 0] + 1) % jcfg.vocab_size
    jverify = jax.jit(jax_verification.make_paged_verify_step(jm, scratch_slot=3,
                                                              attn_chunk=CHUNK))
    pverify = verification.make_paged_verify_step(pm, scratch_slot=3, attn_chunk=CHUNK)
    assert pverify.paged_attention
    jprev, pprev = np.asarray(jlast), plast
    for rnd in range(2):
        lengths = np.full((B,), 4, np.int32)
        jb = jax_verification.make_verify_batch(jnp.asarray(jprev), jnp.asarray(drafts),
                                                jnp.asarray(lengths))
        pb = verification.make_verify_batch(torch.as_tensor(pprev), torch.from_numpy(drafts),
                                            torch.from_numpy(lengths))
        jres, jpool = jverify(jp, jpool, jnp.asarray(slots), jb)
        pres, ppool = pverify(pp, ppool, torch.from_numpy(slots), pb)
        for f in ("n_accepted", "n_commit", "out_tokens", "extra_token"):
            assert getattr(pres, f).tolist() == np.asarray(getattr(jres, f)).tolist(), (rnd, f)
        assert ppool["length"].tolist() == np.asarray(jpool["length"]).tolist()
        if rnd == 0:
            assert pres.n_accepted.tolist()[0] == 4 and pres.n_accepted.tolist()[1] == 0
        jprev = np.asarray(jres.extra_token)
        pprev = pres.extra_token
        drafts = np.random.default_rng(9 + rnd).integers(
            0, jcfg.vocab_size, size=(B, 4)).astype(np.int32)
    _assert_cache_close(ppool, jpool, "pool after two verify rounds")


def test_paged_pool_moves_the_cross_leaves_bit_for_bit():
    """A PagedKVCache of whisper rows: ``write_slot`` of a prefilled row,
    ``gather_slots`` back, both bit for bit with the cross leaves (batch on
    axis 1); ``bytes_per_slot`` counts them."""
    jcfg, _, _, cfg, pm, pp = _pair()
    F = jcfg.encoder_seq
    pool = PagedKVCache(pm, n_slots=3, max_len=MAX_LEN, device="cpu", attn_chunk=CHUNK,
                        enc_len=F)
    row = pool.make_row_cache()
    assert row["cross_k"].shape == (cfg.num_layers, 1, F, cfg.num_kv_heads, cfg.head_dim)
    toks = torch.arange(7, dtype=torch.int32)[None]
    frames = frontend_stub(cfg, 1, torch.Generator().manual_seed(3))
    _, row = pm.prefill(pp, toks, row, attn_chunk=CHUNK, enc_frames=frames)
    slot = pool.alloc()
    pool.write_slot(slot, row)
    back = gather_slots(pool.cache, torch.tensor([slot], dtype=torch.int32))
    for name in ("k", "v", "cross_k", "cross_v", "length"):
        assert torch.equal(back[name], row[name]), name
    cross = 2 * cfg.num_layers * F * cfg.num_kv_heads * cfg.head_dim * 2
    self_kv = 2 * cfg.num_layers * MAX_LEN * cfg.num_kv_heads * cfg.head_dim * 2
    assert pool.bytes_per_slot() == cross + self_kv + 4


def test_ragged_encoder_length_takes_the_pad_path():
    """F = 40 frames at ``attn_chunk`` 16 (not a multiple: JAX pads the
    fresh K/V, the plain version walks a short last chunk): encode and
    prefill equal JAX's."""
    toks, frames, (jl, jc), (pl, pc) = _jax_prefill(F=40, encoder_seq=40)
    jcfg, _, jp, cfg, _, pp = _pair(encoder_seq=40)
    assert frames.shape[1] == 40 and 40 % CHUNK
    want = jax.jit(lambda p, f: JT.encode(jcfg, p, f, attn_chunk=CHUNK))(jp, frames)
    _close(T.encode(cfg, pp, _t(frames), attn_chunk=CHUNK), want, BF16_TOL, "encode F=40")
    _close(pl, jl, F32_TOL, "logits F=40")
    assert pl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    _assert_cache_close(pc, jc, "prefill F=40")


def test_prompt_past_the_position_table_clamps():
    """A 24-token prompt against a 16-row decoder position table: JAX's
    gather clamps positions 16..23 to the last row, and so does the port
    (``transformer.learned_positions``)."""
    toks, _, (jl, jc), (pl, pc) = _jax_prefill(P=24, max_pos=16)
    _, _, _, _, _, pp = _pair(16)
    assert pp.pos_embed.shape[0] == 16
    _close(pl, jl, F32_TOL, "logits past max_pos")
    assert pl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    _assert_cache_close(pc, jc, "prefill past max_pos")
    pos = torch.tensor([[0, 15, 16, 40]])
    got = T.learned_positions(pp.pos_embed, pos)
    assert torch.equal(got[0, 2], pp.pos_embed[15]) and torch.equal(got[0, 3], pp.pos_embed[15])


def test_int8_self_attention_pool_keeps_bf16_cross_leaves():
    """``kv_dtype="int8"``: the self-attention K/V in int8 with their scales
    (within one int8 step of JAX's), the cross leaves bf16, and the logits
    of the prefill and a decode equal JAX's."""
    jcfg, jm, jp, cfg, pm, pp = _pair()
    _, _, (jl, jc), (pl, pc) = _jax_prefill(kv_dtype="int8")
    assert pc["k"].dtype == torch.int8 and pc["cross_k"].dtype == torch.bfloat16
    assert np.asarray(jc["cross_k"]).dtype.name == "bfloat16"
    _close(pl, jl, F32_TOL, "int8 logits")
    _assert_cache_close(pc, jc, "int8 prefill")
    fresh = np.random.default_rng(6).integers(0, jcfg.vocab_size, size=(B, 3)).astype(np.int32)
    jh, _, _ = jax.jit(lambda p, c, t: jm.decode_forward(p, c, t, attn_chunk=CHUNK))(
        jp, jc, jnp.asarray(fresh))
    ph, _ = pm.decode_forward(pp, pc, torch.from_numpy(fresh), attn_chunk=CHUNK)
    _close(pm.lm_head(pp, ph), jm.lm_head(jp, jh), F32_TOL, "int8 decode logits")


def _attn_inputs(seed, Bq, Sq, Hq, Hkv, D, Skv):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.standard_normal((Bq, Sq, Hq, D)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((Bq, Skv, Hkv, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((Bq, Skv, Hkv, D)), jnp.bfloat16)
    return q, k, v


@pytest.mark.parametrize("form", ["dense", "paged"])
@pytest.mark.parametrize("Sq, Skv", [(40, 40), (5, 40)])
def test_noncausal_plain_attention_equals_jax_flash(form, Sq, Skv):
    """``ref.verify_attention_ref(causal=False)`` (and its paged form, rows
    through a slot index) against JAX's XLA ``flash_attention(causal=False)``
    at the encoder's shape (Sq = Skv = F = 40, a ragged last chunk of 16)
    and cross-attention's (Sq 5 over 40 frames), G = 2; the control: the
    causal result differs by far more than the bound."""
    q, k, v = _attn_inputs(Sq, 2, Sq, 4, 2, 16, Skv)
    kvv = np.array([Skv, Skv - 7], np.int32)
    want = jax.jit(lambda q, k, v, n: JL.flash_attention(
        q, k, v, kv_valid=n, causal=False, chunk=CHUNK))(q, k, v, jnp.asarray(kvv))
    tq, tk, tv, tn = _t(q), _t(k), _t(v), torch.from_numpy(kvv)
    if form == "paged":
        slots = torch.tensor([2, 0], dtype=torch.int32)
        pool_k = torch.zeros((3,) + tuple(tk.shape[1:]), dtype=torch.bfloat16)
        pool_v = torch.zeros_like(pool_k)
        pool_k[slots.long()], pool_v[slots.long()] = tk, tv
        run = lambda causal: ref.verify_attention_paged_ref(  # noqa: E731
            tq, pool_k, pool_v, slots, tn, block_k=CHUNK, causal=causal)
    else:
        run = lambda causal: ref.verify_attention_ref(  # noqa: E731
            tq, tk, tv, tn, block_k=CHUNK, causal=causal)
    got = run(False)
    _close(got, want, BF16_TOL, f"non-causal {form}")
    control = (run(True).float() - got.float()).abs().max().item()
    assert control > 10 * BF16_TOL, control


@pytest.mark.parametrize("Sq", [40, 5])
def test_noncausal_split_decomposition_equals_plain_version(Sq):
    """The CUDA kernel's decomposition (fixed splits merged in order,
    ``ref.verify_attention_split_ref``) gives the plain version's bits in
    the non-causal case, with its split equal to the plain chunk."""
    q, k, v = _attn_inputs(Sq + 1, 2, Sq, 4, 2, 16, 40)
    tn = torch.tensor([40, 23], dtype=torch.int32)
    plain = ref.verify_attention_ref(_t(q), _t(k), _t(v), tn, block_k=CHUNK, causal=False)
    split = ref.verify_attention_split_ref(_t(q), _t(k), _t(v), tn, split=CHUNK, causal=False)
    assert torch.equal(plain, split)


def test_bridge_round_trips_an_encdec_tree_both_ways():
    """JAX -> port -> JAX gives the JAX leaves bit for bit (encoder,
    cross-attention, layernorm biases, both position tables); port -> JAX
    -> port the port's weights; a JAX cache with cross leaves likewise."""
    jcfg, _, jp, cfg, pm, pp = _pair()
    tree = jax.tree.map(np.asarray, jp)
    back = bridge.params_to_jax(pp)
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(_bits(w), g), tree, back)
    assert sorted(back["enc"]) == ["final_norm", "layers", "pos_embed"]
    assert sorted(back["layers"]) == ["attn", "ln1", "ln2", "ln_x", "mlp", "xattn"]
    own = pm.init_params(torch.Generator().manual_seed(3), max_pos=MAX_POS)
    as_jax = jax.tree.map(lambda a: a.view(jnp.bfloat16) if a.dtype == np.uint16 else a,
                          bridge.params_to_jax(own))
    for tree in (as_jax, bridge.params_tree(own)):
        again = bridge.params_from_jax(cfg, tree, device="cpu")
        assert sorted(own.state_dict()) == sorted(again.state_dict())
        for name, a in own.state_dict().items():
            b = again.state_dict()[name]
            assert a.dtype == b.dtype and torch.equal(a, b), name
    _, _, (_, jc), _ = _jax_prefill()
    cache = bridge.cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    for name, leaf in bridge.cache_to_jax(cache).items():
        np.testing.assert_array_equal(leaf, _bits(jc[name]))


def test_bridge_skips_only_leaves_that_are_none():
    """The bridge skips a name whose module holds None there (an RMSNorm's
    bias, no QKV bias, the other MLP's tables) and raises on a name the
    module lacks, so a misspelt or missing leaf is never skipped."""
    dense = build_model(get_config("qwen2-1.5b").reduced())
    block = dense.init_params(torch.Generator().manual_seed(0)).layers[0]
    assert bridge._dotted(block, "ln1.bias") is None
    assert bridge._dotted(block, "mlp.wi") is None
    assert bridge._dotted(block, "ln1.scale") is block.ln1.scale
    for name in ("ln_y.scale", "ln1.shift", "xattn.wq"):
        with pytest.raises(AttributeError):
            bridge._dotted(block, name)


def test_frontend_stub_and_system_refusal():
    """The port's stub frames: (B, encoder_seq, d) bf16 at N(0, 0.02), from
    the caller's generator; ``System.build`` refuses an encdec spec with a
    message naming the missing encoder frames (the JAX System crashes at
    its first prefill instead), as target or as draft."""
    cfg = get_config("whisper-tiny")
    stub = frontend_stub(cfg, 2, torch.Generator().manual_seed(0))
    assert stub.shape == (2, 1500, 384) and stub.dtype == torch.bfloat16
    assert abs(stub.float().std().item() - 0.02) < 1e-3
    spec = ServeSpec.from_json(SPEC_JSON)
    for model in ({"arch": "whisper-tiny", "draft_arch": "whisper-tiny"},
                  {"draft_arch": "whisper-tiny"}):
        bad = dataclasses.replace(spec, model=dataclasses.replace(spec.model, **model))
        with pytest.raises(ValueError, match="encoder frames"):
            System.build(bad, device="cpu")
