"""The port's kernel ops against the JAX package's.

The same numpy inputs go through the JAX Pallas kernels (interpret mode)
or their jnp oracles (``repro.kernels.ref``) and through the port's plain
versions (``repro_torch.kernels.ref``, which the port runs for CPU tensors):
verification attention over bf16 and int8 caches, and the Mamba2 SSD scan.
Tolerances are those of tests/test_kernels.py: attention bf16 2e-2, f32
2e-3; SSD bf16 4e-2, f32 3e-3. The CUDA kernels themselves run only on the
card (``chip_smoke.py`` and tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as jmamba2
from repro_torch.kernels import ops, ssd_scan, verify_attn
from repro_torch.models import mamba2

TOL = {"bf16": 2e-2, "f32": 2e-3}
ORACLE = jax.jit(jref.verify_attention_ref)
PAGED_ORACLE = jax.jit(jref.verify_attention_paged_ref)
JNP = {"bf16": jnp.bfloat16, "f32": jnp.float32}


def _torch(a: np.ndarray, dt: str) -> torch.Tensor:
    if dt == "bf16":
        bits = a.astype(ml_dtypes.bfloat16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(a.astype(np.float32))


def _inputs(seed, B, Sq, Hq, Hkv, Skv, D, rows=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((rows or B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((rows or B, Skv, Hkv, D)).astype(np.float32)
    kv_valid = rng.integers(Sq, Skv + 1, size=B).astype(np.int32)
    kv_valid[0] = Skv  # one row reads the ragged tail chunk to its end
    return q, k, v, kv_valid


def _close(got: torch.Tensor, want, dt: str) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dt], atol=TOL[dt])


# (B, Sq, Hq, Hkv, Skv, D, block_k): a subset of tests/test_kernels.py ATTN_SHAPES
ATTN_SHAPES = [
    (2, 5, 8, 2, 128, 64, 32),     # GQA
    (3, 5, 12, 1, 256, 16, 64),    # MQA
    (2, 1, 8, 8, 128, 64, 32),     # plain decode (Sq=1), MHA
    (2, 5, 8, 2, 80, 64, 64),      # Skv % block_k != 0 (ragged tail chunk)
]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_verify_attention_matches_jax_oracle(shape, dt):
    B, Sq, Hq, Hkv, Skv, D, blk = shape
    q, k, v, kvv = _inputs(sum(shape), B, Sq, Hq, Hkv, Skv, D)
    want = ORACLE(*(jnp.asarray(a, JNP[dt]) for a in (q, k, v)), jnp.asarray(kvv))
    got = ops.verify_attention(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                               torch.from_numpy(kvv), block_k=blk)
    _close(got, want, dt)


# (n_slots, B, Sq, Hq, Hkv, Skv, D, block_k): tests/test_kernels.py PAGED_SHAPES
PAGED_SHAPES = [
    (6, 3, 5, 8, 2, 128, 64, 32),    # GQA, bucket < pool
    (4, 2, 4, 4, 4, 96, 32, 64),     # MHA, ragged tail chunk
    (5, 4, 5, 12, 1, 160, 16, 64),   # MQA, ragged tail chunk
]


def _paged_slots(seed, n_slots, B):
    """Real rows out of order, the last entries padded with the duplicated
    scratch slot (the engine's partial-fill convention)."""
    real = np.random.default_rng(seed).permutation(n_slots)[: max(B - 2, 1)]
    return np.concatenate([real, np.full((B - real.shape[0],), n_slots)]).astype(np.int32)


@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_verify_attention_paged_matches_jax_oracle(shape, dt):
    n_slots, B, Sq, Hq, Hkv, Skv, D, blk = shape
    q, k, v, kvv = _inputs(sum(shape), B, Sq, Hq, Hkv, Skv, D, rows=n_slots + 1)
    slots = _paged_slots(sum(shape), n_slots, B)
    want = PAGED_ORACLE(
        *(jnp.asarray(a, JNP[dt]) for a in (q, k, v)), jnp.asarray(slots), jnp.asarray(kvv)
    )
    got = ops.verify_attention_paged(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                                     torch.from_numpy(slots), torch.from_numpy(kvv), block_k=blk)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_verify_attention_matches_pallas_interpret(dt):
    """Against the Pallas kernel itself (interpret mode) at the same block:
    the plain version repeats its arithmetic, so bf16 agrees far inside
    the bound (uneven kv_valid, GQA, ragged tail)."""
    B, Sq, Hq, Hkv, Skv, D, blk = 2, 5, 8, 2, 80, 64, 32
    q, k, v, kvv = _inputs(7, B, Sq, Hq, Hkv, Skv, D)
    want = jops.verify_attention(*(jnp.asarray(a, JNP[dt]) for a in (q, k, v)),
                                 jnp.asarray(kvv), block_k=blk)
    got = ops.verify_attention(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                               torch.from_numpy(kvv), block_k=blk)
    _close(got, want, dt)


def test_verify_attention_paged_matches_pallas_interpret():
    """The paged Pallas kernel (interpret mode), duplicate scratch slots,
    uneven kv_valid, MQA, ragged tail chunk, in bf16."""
    n_slots, B, Sq, Hq, Hkv, Skv, D, blk = 5, 4, 5, 12, 1, 160, 16, 64
    q, k, v, kvv = _inputs(11, B, Sq, Hq, Hkv, Skv, D, rows=n_slots + 1)
    slots = _paged_slots(11, n_slots, B)
    want = jops.verify_attention_paged(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(slots),
        jnp.asarray(kvv), block_k=blk,
    )
    got = ops.verify_attention_paged(_torch(q, "bf16"), _torch(k, "bf16"), _torch(v, "bf16"),
                                     torch.from_numpy(slots), torch.from_numpy(kvv), block_k=blk)
    _close(got, want, "bf16")


def test_stacked_cache_layer_addressing_matches_slice():
    """``layer=`` on the stacked (L, rows, S, H, D) cache is the same as
    handing over that layer's slice."""
    q, k, v, kvv = _inputs(3, 2, 5, 8, 2, 64, 16)
    ks = np.stack([k[::-1], k]).copy()
    vs = np.stack([v[::-1], v]).copy()
    t = lambda a: _torch(a, "bf16")  # noqa: E731
    a = ops.verify_attention(t(q), t(ks), t(vs), torch.from_numpy(kvv), layer=1)
    b = ops.verify_attention(t(q), t(k), t(v), torch.from_numpy(kvv))
    assert torch.equal(a, b)


def test_masked_rows_cannot_leak_nan():
    """Cache rows past kv_valid hold NaN; the output stays finite."""
    q, k, v, kvv = _inputs(5, 2, 5, 8, 2, 64, 16)
    kvv[:] = [20, 33]
    for b, n in enumerate(kvv):
        k[b, n:] = np.nan
        v[b, n:] = np.nan
    out = ops.verify_attention(_torch(q, "bf16"), _torch(k, "bf16"), _torch(v, "bf16"),
                               torch.from_numpy(kvv), block_k=16)
    assert torch.isfinite(out.float()).all()


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    verify_attn.reset_launches()
    ssd_scan.reset_launches()
    q, k, v, kvv = _inputs(1, 1, 1, 4, 2, 32, 16)
    ops.verify_attention(_torch(q, "bf16"), _torch(k, "bf16"), _torch(v, "bf16"),
                         torch.from_numpy(kvv))
    kq, ks = (torch.from_numpy(a[None]) for a in _quantize(k))
    ops.verify_attention(_torch(q, "bf16"), kq, kq, torch.from_numpy(kvv), layer=0,
                         k_scale=ks, v_scale=ks)
    ops.verify_attention(_torch(q, "bf16"), _torch(k, "bf16"), _torch(v, "bf16"),
                         torch.from_numpy(kvv), causal=False)
    ops.verify_attention_shard(_torch(q, "bf16"), _torch(k, "bf16"), _torch(v, "bf16"),
                               torch.from_numpy(kvv), pos_offset=0)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(1, (1, 16, 2, 8, 8, 8))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm, h0)]
    y, h = ops.ssd_scan(*leaves, chunk=8)
    (y.square().sum() + h.sum()).backward()  # autograd of the plain scan: no backward kernel
    assert set(verify_attn.LAUNCHES) == {
        f"verify_attention_{entry}{kv}{mask}" for entry in ("packed", "paged")
        for kv in ("", "_int8") for mask in ("", "_noncausal")
    } | {"verify_attention_packed_shard", "verify_attention_packed_shard_noncausal"}
    assert not any(verify_attn.LAUNCHES.values())
    assert ssd_scan.LAUNCHES == {"ssd_scan": 0, "ssd_scan_bwd": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, kvv = _inputs(1, 1, 1, 4, 2, 32, 64)
    args = (_torch(q, "bf16"), _torch(k, "bf16"), _torch(v, "bf16"), torch.from_numpy(kvv))
    with pytest.raises(ValueError, match="CUDA tensors"):
        verify_attn.verify_attention_packed(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        verify_attn.verify_attention_paged(args[0], args[1], args[2],
                                           torch.zeros(1, dtype=torch.int32), args[3])
    with pytest.raises(ValueError, match="CUDA tensors"):
        verify_attn.verify_attention_packed_shard(*args, pos_offset=0)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(1, (1, 16, 2, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan.ssd_scan(*(_torch(a, "bf16") for a in (x,)),
                          *(torch.from_numpy(a) for a in (dt, A)),
                          _torch(Bm, "bf16"), _torch(Cm, "bf16"), torch.from_numpy(h0), chunk=8)


# ---------------------------------------------------------------------------
# int8 caches
# ---------------------------------------------------------------------------


def _quantize(kf: np.ndarray):
    """A (rows, Skv, Hkv, D) f32 cache as int8 with per-(row, head) scales,
    the construction of tests/test_kernels.py's int8 sweep."""
    scale = (np.abs(kf).max(axis=(1, 3)) / 127.0 + 1e-6).astype(np.float32)
    q = np.clip(np.round(kf / scale[:, None, :, None]), -127, 127).astype(np.int8)
    return q, scale


# (n_slots, B, Sq, Hq, Hkv, Skv, D, block_k): tests/test_kernels.py PAGED_SHAPES,
# the shapes of its int8 sweep
INT8_SHAPES = [
    (6, 3, 5, 8, 2, 128, 64, 32),    # GQA, bucket < pool
    (4, 2, 4, 4, 4, 96, 32, 64),     # MHA, ragged tail chunk
    (5, 4, 5, 12, 1, 160, 16, 64),   # MQA, ragged tail chunk
    (3, 3, 2, 16, 2, 64, 32, 64),    # deep GQA group, block_k == Skv
]


@pytest.mark.parametrize("shape", INT8_SHAPES)
@pytest.mark.parametrize("entry", ["paged", "dense"])
def test_int8_attention_matches_pallas_interpret(shape, entry):
    """The int8 plain versions against the Pallas int8 paged kernel
    (interpret mode), bf16 2e-2: uneven kv_valid, duplicate scratch slots
    (paged); the dense entry is the paged kernel over rows 0..B-1."""
    n_slots, B, Sq, Hq, Hkv, Skv, D, blk = shape
    q, kf, vf, kvv = _inputs(sum(shape) + 17, B, Sq, Hq, Hkv, Skv, D, rows=n_slots + 1)
    (k, ks), (v, vs) = _quantize(kf), _quantize(vf)
    if entry == "paged":
        slots = _paged_slots(sum(shape), n_slots, B)
        got = ops.verify_attention_paged(
            _torch(q, "bf16"), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(slots),
            torch.from_numpy(kvv), block_k=blk, k_scale=torch.from_numpy(ks),
            v_scale=torch.from_numpy(vs),
        )
    else:
        slots = np.arange(B, dtype=np.int32)
        got = ops.verify_attention(
            _torch(q, "bf16"), torch.from_numpy(k[:B]), torch.from_numpy(v[:B]),
            torch.from_numpy(kvv), block_k=blk, k_scale=torch.from_numpy(ks[:B]),
            v_scale=torch.from_numpy(vs[:B]),
        )
    want = jops.verify_attention_paged(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots),
        jnp.asarray(kvv), jnp.asarray(ks), jnp.asarray(vs), block_k=blk,
    )
    _close(got, want, "bf16")


def test_int8_stacked_scales_match_the_layer_slice():
    """A stacked (L, rows, ...) int8 cache with its (L, rows, Hkv) scale
    leaves and ``layer=`` is the same as that layer's slices."""
    q, kf, vf, kvv = _inputs(4, 2, 5, 8, 2, 64, 16, rows=3)
    (k, ks), (v, vs) = _quantize(kf), _quantize(vf)
    t = torch.from_numpy
    slots = t(np.array([2, 0], np.int32))
    a = ops.verify_attention_paged(_torch(q, "bf16"), t(np.stack([k[::-1], k])),
                                   t(np.stack([v[::-1], v])), slots, t(kvv), layer=1,
                                   k_scale=t(np.stack([ks[::-1], ks])),
                                   v_scale=t(np.stack([vs[::-1], vs])))
    b = ops.verify_attention_paged(_torch(q, "bf16"), t(k), t(v), slots, t(kvv),
                                   k_scale=t(ks), v_scale=t(vs))
    assert torch.equal(a, b)


def test_int8_without_scales_raises():
    """As the Pallas wrapper, an int8 cache without its scales is refused."""
    n_slots, B, Sq, Hq, Hkv, Skv, D = 3, 2, 2, 4, 2, 64, 32
    q = torch.zeros((B, Sq, Hq, D), dtype=torch.bfloat16)
    pool = torch.zeros((n_slots + 1, Skv, Hkv, D), dtype=torch.int8)
    kvv = torch.full((B,), Sq, dtype=torch.int32)
    with pytest.raises(ValueError, match="k_scale"):
        ops.verify_attention_paged(q, pool, pool, torch.zeros((B,), dtype=torch.int32), kvv)
    with pytest.raises(ValueError, match="k_scale"):
        ops.verify_attention(q, pool[:B], pool[:B], kvv)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

SSD_TOL = {"bf16": 4e-2, "f32": 3e-3}
# (B, S, H, P, N, chunk): tests/test_kernels.py SSD_SHAPES
SSD_SHAPES = [
    (2, 64, 4, 16, 32, 16),
    (1, 128, 2, 8, 16, 32),
    (2, 32, 1, 32, 8, 32),   # single head, chunk == S
    (1, 96, 3, 16, 64, 24),  # odd-ish chunking
]


def _ssd_inputs(seed, shape):
    """x, dt (post-softplus), A (negative), B, C, h0 with the distributions
    of tests/test_kernels.py's SSD sweep, from a numpy seed."""
    B, S, H, P, N = shape[:5]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_ssd_scan_matches_pallas_interpret(shape, dt):
    """The plain SSD scan against the Pallas kernel (interpret mode)."""
    x, dtv, A, Bm, Cm, h0 = _ssd_inputs(sum(shape), shape)
    chunk = shape[5]
    yw, hw = jops.ssd_scan(jnp.asarray(x, JNP[dt]), jnp.asarray(dtv), jnp.asarray(A),
                           jnp.asarray(Bm, JNP[dt]), jnp.asarray(Cm, JNP[dt]), jnp.asarray(h0),
                           chunk=chunk)
    y, h = ops.ssd_scan(_torch(x, dt), torch.from_numpy(dtv), torch.from_numpy(A),
                        _torch(Bm, dt), _torch(Cm, dt), torch.from_numpy(h0), chunk=chunk)
    assert y.dtype == _torch(x, dt).dtype and h.dtype == torch.float32
    tol = SSD_TOL[dt]
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yw, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(hw), rtol=tol, atol=tol)


@pytest.mark.parametrize("S", [40, 17])
def test_ssd_chunked_ragged_sequence_matches_jax(S):
    """``mamba2.ssd_chunked`` where S is not a multiple of the 16-row chunk
    (two full chunks and a ragged one; a full chunk and a one-row chunk):
    the JAX mirror pads, the Pallas kernel would refuse. f32 3e-3."""
    shape = (2, S, 3, 8, 16, 16)
    x, dtv, A, Bm, Cm, h0 = _ssd_inputs(S, shape)
    yw, hw = jmamba2.ssd_chunked(*(jnp.asarray(a) for a in (x, dtv, A, Bm, Cm)), 16,
                                 h0=jnp.asarray(h0))
    y, h = mamba2.ssd_chunked(*(torch.from_numpy(a) for a in (x, dtv, A, Bm, Cm)), 16,
                              h0=torch.from_numpy(h0))
    tol = SSD_TOL["f32"]
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), rtol=tol, atol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(hw), rtol=tol, atol=tol)
