"""The CUDA kernels' decompositions, restated in plain PyTorch, against the
plain versions and the JAX package.

``ref.verify_attention_split_ref`` is the attention kernel's split-KV
algorithm (fixed splits computed side by side, each rounded at its running
max, merged in split order; with ``return_lse=True`` also each row's
log-sum-exp from the merge, which training's backward takes);
``ref.attention_bwd_split_ref`` is the backward kernels' (that LSE, dS
rounded to bf16 for dQ and dK, dK and dV as per-query-head f32 partials
summed in head order); ``ref.ssd_scan_sliced_ref``
is the SSD kernel's (C.B^T once per (b, chunk), the rest in P slices). All
serve the tests only. Inputs come from a numpy seed. Tolerances:
  - against the port's plain versions: attention with ``split`` equal to
    the plain version's ``block_k`` takes the same steps, so it must agree
    bit for bit (the kernel relies on it); the SSD scan 1e-5 relative and
    absolute (all f32, sums in another order); the backward
    ``SPLIT_BWD_TOL`` (1e-2 of each gradient's largest element, half of
    chip_smoke.py's GRAD_TIGHT: the one new rounding, dS to bf16, moves
    dQ and dK by one or two bf16 steps of their largest element); the
    split forward's LSE ``LSE_TOL`` (1e-5 of its largest element: f32 sums
    of the same values in another order);
  - against the JAX package, those of tests/test_kernels.py: attention
    bf16 2e-2, f32 2e-3; SSD f32 3e-3; the backward bf16 2e-2 of each
    gradient's largest element (``jax.vjp`` of the XLA mirror
    ``flash_attention`` on the same bf16 inputs); the LSE ``LSE_TOL``
    against ``jax.nn.logsumexp`` of the f32 scores of the same bf16 inputs,
    masked as ``flash_attention`` masks them.
"""
import inspect

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba2
from repro_torch.kernels import attn_bwd, ref

JAX_TOL = {"bf16": 2e-2, "f32": 2e-3}
SSD_TIGHT = 1e-5
SSD_JAX_TOL = 3e-3
SPLIT_BWD_TOL = 1e-2
LSE_TOL = 1e-5


def _torch(a: np.ndarray, dt: str) -> torch.Tensor:
    if dt == "bf16":
        return torch.from_numpy(a.astype(ml_dtypes.bfloat16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.astype(np.float32))


def _attn_inputs(seed, B, Sq, Hq, Hkv, Skv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    return q, k, v


def _close(got: torch.Tensor, want, tol: float) -> None:
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# (B, Sq, Hq, Hkv, Skv, D, kv_valid, split): the kernel's split is 64
ATTN_CASES = [
    (4, 5, 12, 2, 200, 128, [64, 65, 128, 129], 64),  # last row at a split end, one past
    (3, 1, 12, 2, 256, 128, [230, 64, 1], 64),        # one-token decode, kv_valid at a split end
    (2, 4, 8, 2, 100, 64, [100, 9], 64),              # D = 64, ragged Skv
    (2, 5, 8, 2, 160, 64, [160, 96], 32),             # another split length
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_split_attention_matches_plain_and_jax(case, dt):
    """Split-and-merge against the plain online softmax at block_k = split
    (the same rounding of P) and against the JAX oracle."""
    B, Sq, Hq, Hkv, Skv, D, kvv, split = case
    q, k, v = _attn_inputs(sum(kvv) + split, B, Sq, Hq, Hkv, Skv, D)
    kv_valid = np.asarray(kvv, np.int32)
    args = (_torch(q, dt), _torch(k, dt), _torch(v, dt), torch.from_numpy(kv_valid))
    got = ref.verify_attention_split_ref(*args, split=split)
    assert torch.equal(got, ref.verify_attention_ref(*args, block_k=split))
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    want = jref.verify_attention_ref(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                     jnp.asarray(kv_valid))
    _close(got, want, JAX_TOL[dt])


def test_split_attention_int8_matches_plain():
    """An int8 cache with per-(row, head) scales, dequantized as the kernel
    does, split at 64."""
    q, kf, vf = _attn_inputs(5, 3, 5, 12, 2, 192, 128)
    scale = lambda a: (np.abs(a).max(axis=(1, 3)) / 127.0 + 1e-6).astype(np.float32)  # noqa: E731
    ks, vs = scale(kf), scale(vf)
    k = np.clip(np.round(kf / ks[:, None, :, None]), -127, 127).astype(np.int8)
    v = np.clip(np.round(vf / vs[:, None, :, None]), -127, 127).astype(np.int8)
    args = (_torch(q, "bf16"), torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor([192, 128, 70], dtype=torch.int32))
    sc = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    assert torch.equal(ref.verify_attention_split_ref(*args, split=64, **sc),
                       ref.verify_attention_ref(*args, block_k=64, **sc))


@pytest.mark.parametrize("split", [64, None])
def test_rows_that_see_nothing_give_zero(split):
    """kv_valid < Sq: the first queries sit before position 0 and see no
    position; both the plain version and the split version give them 0 and
    leave the other rows as they are. (The JAX kernels require
    kv_valid >= Sq; its oracle averages every position for such rows.)"""
    B, Sq, Hq, Hkv, Skv, D = 2, 5, 8, 2, 96, 64
    q, k, v = _attn_inputs(9, B, Sq, Hq, Hkv, Skv, D)
    kv_valid = torch.tensor([3, 70], dtype=torch.int32)
    args = (_torch(q, "f32"), _torch(k, "f32"), _torch(v, "f32"), kv_valid)
    out = (ref.verify_attention_ref(*args) if split is None
           else ref.verify_attention_split_ref(*args, split=split))
    assert torch.equal(out[0, :2], torch.zeros_like(out[0, :2]))  # positions -2, -1
    assert out[0, 2:].abs().amax() > 0
    want = jref.verify_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                     jnp.asarray(kv_valid.numpy()))
    _close(out[0, 2:], np.asarray(want)[0, 2:], JAX_TOL["f32"])
    _close(out[1], np.asarray(want)[1], JAX_TOL["f32"])


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


# (B, S, H, P, N, chunk, slice_p)
SSD_CASES = [
    (2, 40, 3, 32, 16, 16, 16),  # two full chunks and a ragged one
    (1, 32, 2, 16, 32, 16, 16),  # two chunks exactly
    (2, 17, 2, 24, 16, 16, 16),  # P not a multiple of the slice, a one-row chunk
    (1, 24, 4, 64, 32, 24, 16),  # the mamba2 slicing of P = 64, chunk == S
]


@pytest.mark.parametrize("case", SSD_CASES)
def test_sliced_ssd_matches_plain_and_jax(case):
    """C.B^T once per (b, chunk) and P in slices against the plain scan and
    the JAX package's XLA mirror (which pads a ragged chunk)."""
    B, S, H, P, N, chunk, slice_p = case
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(S + P, B, S, H, P, N)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h0)]
    y, h = ref.ssd_scan_sliced_ref(*args, chunk=chunk, slice_p=slice_p)
    yp, hp = ref.ssd_scan_ref(*args, chunk=chunk)
    _close(y, yp, SSD_TIGHT)
    _close(h, hp, SSD_TIGHT)
    yw, hw = jmamba2.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
                                 h0=jnp.asarray(h0))
    _close(y, yw, SSD_JAX_TOL)
    _close(h, hw, SSD_JAX_TOL)


@pytest.mark.parametrize("q", [1, 31, 199, 256, 300, 512])
def test_warp_scan_cumsum_is_a_running_sum(q):
    """The kernel's scan order computes the running sum: on small integers,
    which every order adds exactly, it equals torch.cumsum bit for bit
    (one and two 256-step segments, partial warps)."""
    v = torch.from_numpy(np.random.default_rng(q).integers(-8, 9, (2, q, 3)).astype(np.float32))
    assert torch.equal(ref.warp_scan_cumsum(v), torch.cumsum(v, dim=1))


def test_kernel_cumsum_order_within_chip_tolerance():
    """The SSD kernel's decomposition with its own cumsum order against the
    plain scan, within chip_smoke.py's SSD_TOL (|d| <= tol * (1 + |plain|)),
    at a chunk of 256 steps where the running sum reaches about -200 and a
    few f32 ulps of it move exp(cum_i - cum_j) by ~1e-5 relative."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(7, 1, 300, 4, 16, 16)
    args = [_torch(x, "bf16"), torch.from_numpy(dt), torch.from_numpy(A), _torch(Bm, "bf16"),
            _torch(Cm, "bf16"), torch.from_numpy(h0)]
    cum_end = (args[1][:, :256] * args[2]).sum(dim=1)
    assert cum_end.min() < -100
    y, h = ref.ssd_scan_sliced_ref(*args, chunk=256, cumsum=ref.warp_scan_cumsum)
    yp, hp = ref.ssd_scan_ref(*args, chunk=256)
    for got, want, tol in ((y, yp, 4e-2), (h, hp, 3e-3)):
        assert ((got.float() - want.float()).abs() / (1 + want.float().abs())).max() <= tol


# (B, Sq, Skv, Hq, Hkv, D, kv_valid, causal): G 1, 6 and 48; D 16, 64, 96, 128
BWD_CASES = [
    (2, 16, 16, 2, 2, 16, [16, 16], True),      # G 1, D 16, Sq = Skv = kv_valid
    (2, 20, 40, 12, 2, 128, [40, 27], True),    # G 6 (qwen2's), causal offset, ragged
    (1, 16, 40, 48, 1, 128, [40], True),        # G 48 (granite-34b's)
    (2, 7, 50, 6, 6, 64, [50, 23], False),      # non-causal, Sq < Skv (cross-attention)
    (2, 33, 33, 4, 2, 96, [33, 33], True),      # D 96
]


def _rel(got: torch.Tensor, want) -> float:
    """max |got - want| over max |want|."""
    want = np.asarray(want.float().numpy() if isinstance(want, torch.Tensor) else want,
                      np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def _jax_attention_grads(arrs, kv_valid, causal):
    """(dQ, dK, dV) by jax.vjp of the XLA mirror flash_attention, the query
    rows at the causal offset kv_valid - Sq + i (compiled at XLA's backend
    optimisation level 0, as tests/test_torch_training.py does)."""
    Sq = arrs[0].shape[1]
    kv = jnp.asarray(kv_valid, jnp.int32)
    q_pos = kv[:, None] - Sq + jnp.arange(Sq)[None]

    def grads(q, k, v, dout):
        _, vjp = jax.vjp(lambda q, k, v: jlayers.flash_attention(
            q, k, v, q_pos=q_pos, kv_valid=kv, causal=causal), q, k, v)
        return vjp(dout)

    args = [jnp.asarray(a.astype(ml_dtypes.bfloat16)) for a in arrs]
    fn = jax.jit(grads).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return [np.asarray(g, np.float32) for g in fn(*args)]


def _jax_lse(q, k, kv_valid, causal):
    """(B, Hq, Sq) jax.nn.logsumexp of the f32 scores of q and k over the
    positions flash_attention (src/repro/models/layers.py) lets each row
    see: j < kv_valid and, when causal, j <= kv_valid - Sq + i."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]

    def lse(q, k, kv):
        s = jnp.einsum("bshgd,bchd->bshgc", q.reshape(B, Sq, Hkv, Hq // Hkv, D), k,
                       precision=jax.lax.Precision.HIGHEST) * (1.0 / np.sqrt(D))
        j = jnp.arange(Skv)[None, None, :]
        seen = j < kv[:, None, None]
        if causal:
            seen &= j <= (kv[:, None] - Sq + jnp.arange(Sq)[None])[:, :, None]
        return jax.nn.logsumexp(jnp.where(seen[:, :, None, None, :], s, -jnp.inf), axis=-1)

    got = jax.jit(lse)(jnp.asarray(q, jnp.float32), jnp.asarray(k, jnp.float32),
                       jnp.asarray(kv_valid, jnp.int32))
    return np.asarray(got, np.float32).reshape(B, Sq, Hq).transpose(0, 2, 1)


def _bwd_inputs(case):
    """bf16 q, k, v, dout of a BWD_CASES row, from a numpy seed, and the
    f32 arrays they were rounded from."""
    B, Sq, Skv, Hq, Hkv, D, kvv, causal = case
    rng = np.random.default_rng(Sq + Skv + Hq + D)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D), (B, Sq, Hq, D))]
    return [_torch(a, "bf16") for a in arrs], arrs


@pytest.mark.parametrize("case", BWD_CASES)
def test_split_forward_lse_matches_oracle_and_jax(case):
    """The LSE the forward kernel keeps from its merge (the split
    decomposition at the kernel's 64-position splits): within LSE_TOL of
    the one-pass oracle attention_lse_ref and of JAX's logsumexp of the
    masked scores, with the output bit-equal to the call without it."""
    B, Sq, Skv, Hq, Hkv, D, kvv, causal = case
    (q, k, v, _), _ = _bwd_inputs(case)
    kv_valid = torch.tensor(kvv, dtype=torch.int32)
    out, lse = ref.verify_attention_split_ref(q, k, v, kv_valid, split=64, causal=causal,
                                              return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    assert torch.equal(out, ref.verify_attention_split_ref(q, k, v, kv_valid, split=64,
                                                           causal=causal))
    assert _rel(lse, ref.attention_lse_ref(q, k, kv_valid, causal=causal)) <= LSE_TOL
    want = _jax_lse(q.float().numpy(), k.float().numpy(), kvv, causal)
    assert np.isfinite(want).all()
    assert _rel(lse, want) <= LSE_TOL, _rel(lse, want)


@pytest.mark.parametrize("causal,kvv", [(True, [3, 70]), (False, [0, 70])])
def test_rows_that_see_nothing_get_lse_zero_and_no_gradient(causal, kvv):
    """A row that sees no position (causal: kv_valid < Sq puts the first
    queries before position 0; non-causal: kv_valid 0) gets LSE 0 from the
    split forward and from the oracle, and a zero dQ row from the split and
    the plain backward; the other rows see positions and get neither."""
    B, Sq, Hq, Hkv, Skv, D = 2, 5, 8, 2, 96, 64
    q, k, v = (_torch(a, "bf16") for a in _attn_inputs(9, B, Sq, Hq, Hkv, Skv, D))
    dout = _torch(np.random.default_rng(10).standard_normal((B, Sq, Hq, D)), "bf16")
    kv_valid = torch.tensor(kvv, dtype=torch.int32)
    blind = 2 if causal else Sq  # rows of entry 0 that see nothing
    out, lse = ref.verify_attention_split_ref(q, k, v, kv_valid, split=64, causal=causal,
                                              return_lse=True)
    oracle = ref.attention_lse_ref(q, k, kv_valid, causal=causal)
    for got in (lse, oracle):
        assert torch.equal(got[0, :, :blind], torch.zeros_like(got[0, :, :blind]))
        assert (got[0, :, blind:] != 0).all() and (got[1] != 0).all()
    for dq, _, _ in (ref.attention_bwd_split_ref(q, k, v, out, dout, kv_valid, causal=causal),
                     ref.attention_bwd_ref(q, k, v, out, dout, kv_valid, causal=causal)):
        assert torch.equal(dq[0, :blind], torch.zeros_like(dq[0, :blind]))
        assert dq[1].abs().amax() > 0


@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_delta_ref_is_rowsum_of_dout_times_out(case):
    """attention_bwd_delta_ref, the plain version of attn_bwd_delta, is
    sum_d dO * O in f32 with heads before rows, (B, Hq, Sq); against the
    same sum in f64 within 1e-5 of its largest element."""
    B, Sq, Skv, Hq, Hkv, D, kvv, causal = case
    (q, k, v, dout), _ = _bwd_inputs(case)
    out = ref.verify_attention_ref(q, k, v, torch.tensor(kvv, dtype=torch.int32), causal=causal)
    got = ref.attention_bwd_delta_ref(out, dout)
    assert got.dtype == torch.float32 and got.shape == (B, Hq, Sq) and got.is_contiguous()
    assert torch.equal(got, (dout.float() * out.float()).sum(-1).transpose(1, 2))
    want = (dout.double() * out.double()).sum(-1).transpose(1, 2)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("case", BWD_CASES)
def test_split_attention_bwd_matches_plain_and_jax(case):
    """The backward kernels' decomposition, on the split forward's LSE as
    the card path takes it, against the plain backward (SPLIT_BWD_TOL) and
    JAX's gradient (bf16 2e-2); a causal limit one position late is outside
    the JAX bound."""
    B, Sq, Skv, Hq, Hkv, D, kvv, causal = case
    (q, k, v, dout), arrs = _bwd_inputs(case)
    kv_valid = torch.tensor(kvv, dtype=torch.int32)
    out = ref.verify_attention_ref(q, k, v, kv_valid, causal=causal)
    got = ref.attention_bwd_split_ref(q, k, v, out, dout, kv_valid, causal=causal)
    plain = ref.attention_bwd_ref(q, k, v, out, dout, kv_valid, causal=causal)
    want = _jax_attention_grads(arrs, kvv, causal)
    for name, g, p, w in zip("qkv", got, plain, want):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape, name
        assert _rel(g, p) <= SPLIT_BWD_TOL, (name, _rel(g, p))
        assert _rel(g, w) <= JAX_TOL["bf16"], (name, _rel(g, w))
    if causal:
        late = ref.attention_bwd_split_ref(q, k, v, out, dout, kv_valid + 1, causal=causal)
        worst = max(_rel(g, w) for g, w in zip(late, want))
        assert worst > JAX_TOL["bf16"], worst


def test_split_attention_bwd_dv_is_the_plain_dv_summed_by_head():
    """dV has no new rounding: at G 1 the split version's dV is the plain
    version's bit for bit (the same products; only the head sum differs
    at G > 1)."""
    rng = np.random.default_rng(3)
    q, k, v, dout = (_torch(rng.standard_normal(s).astype(np.float32), "bf16") for s in
                     ((2, 9, 3, 16), (2, 21, 3, 16), (2, 21, 3, 16), (2, 9, 3, 16)))
    kv_valid = torch.tensor([21, 12], dtype=torch.int32)
    out = ref.verify_attention_ref(q, k, v, kv_valid)
    got = ref.attention_bwd_split_ref(q, k, v, out, dout, kv_valid)
    plain = ref.attention_bwd_ref(q, k, v, out, dout, kv_valid)
    assert torch.equal(got[2], plain[2])


# (Sq, Skv, Hq, Hkv, D, blocks a batch entry): qwen2-1.5b's training rows,
# whisper-tiny's encoder, the G 48 case, G 1
PLANS = [
    ((128, 128, 12, 2, 128), 24),
    ((1500, 1500, 6, 6, 64), 144),
    ((16, 40, 48, 1, 128), 48),
    ((33, 33, 32, 32, 96), 32),
]


@pytest.mark.parametrize("shape,blocks", PLANS)
def test_dkdv_plan_takes_no_batch_size(shape, blocks):
    """The dkdv kernel's split (and so its sum order) is a function of
    (Sq, Skv, Hq, Hkv, D) alone: the plan's signature has no batch size,
    and qwen2's rows give 2 x 12 x 8 = 192 blocks at B 8, the encoder's 288
    at B 2, G 48's 48 at B 1, with a workspace of B Skv Hq D 8 bytes
    (Skv rounded up to 64) only where G > 1."""
    assert list(inspect.signature(attn_bwd.dkdv_plan).parameters) == ["Sq", "Skv", "Hq", "Hkv", "D"]
    Sq, Skv, Hq, Hkv, D = shape
    plan = attn_bwd.dkdv_plan(*shape)
    assert plan.position_blocks * plan.query_heads == blocks
    assert plan.position_blocks == -(-Skv // attn_bwd.POSITIONS) and plan.query_heads == Hq
    if Hq == Hkv:
        assert plan.work_shape == () and plan.tickets == 0
    else:
        assert plan.work_shape == (Hkv, plan.position_blocks, Hq // Hkv, 2, 64, D)
        assert int(np.prod(plan.work_shape)) * 4 == plan.position_blocks * 64 * Hq * D * 8
        assert plan.tickets == Hkv * plan.position_blocks
    if shape == (128, 128, 12, 2, 128):  # qwen2's training rows, B 8
        assert 8 * blocks == 192 and 8 * int(np.prod(plan.work_shape)) * 4 == 12_582_912
