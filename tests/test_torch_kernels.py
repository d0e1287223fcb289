"""The port's verification-attention ops against the JAX package's.

The same numpy inputs go through the JAX Pallas kernels (interpret mode)
or their jnp oracles (``repro.kernels.ref``) and through the port's plain
versions (``repro_torch.kernels.ref``, which the port runs for CPU tensors).
Tolerances are those of tests/test_kernels.py: bf16 2e-2, f32 2e-3. The
CUDA kernels themselves run only on the card (``chip_smoke.py`` and the
``cuda``-marked tests here).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, verify_attn

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
    q, k, v, kvv = _inputs(1, 1, 1, 4, 2, 32, 16)
    ops.verify_attention(_torch(q, "bf16"), _torch(k, "bf16"), _torch(v, "bf16"),
                         torch.from_numpy(kvv))
    assert verify_attn.LAUNCHES == {"verify_attention_packed": 0, "verify_attention_paged": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, kvv = _inputs(1, 1, 1, 4, 2, 32, 64)
    args = (_torch(q, "bf16"), _torch(k, "bf16"), _torch(v, "bf16"), torch.from_numpy(kvv))
    with pytest.raises(ValueError, match="CUDA tensors"):
        verify_attn.verify_attention_packed(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        verify_attn.verify_attention_paged(args[0], args[1], args[2],
                                           torch.zeros(1, dtype=torch.int32), args[3])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "head_dim"])
def test_cuda_kernel_rejects_unsupported_inputs(bad):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    D = 32 if bad == "head_dim" else 64
    dt = torch.float32 if bad == "dtype" else torch.bfloat16
    q = torch.zeros((1, 1, 4, D), dtype=dt, device="cuda")
    k = torch.zeros((1, 64, 2, D), dtype=dt, device="cuda")
    kvv = torch.ones((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        verify_attn.verify_attention_packed(q, k, k, kvv)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_kernels_match_plain_versions(paged):
    """On the card: each kernel against its plain version (bf16 bound),
    main-path widths, ragged Skv, uneven kv_valid, duplicate scratch slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    from repro_torch.kernels import ref

    q, k, v, kvv = _inputs(13, 4, 5, 12, 2, 200, 128, rows=5)
    t = lambda a: _torch(a, "bf16").cuda()  # noqa: E731
    kv_valid = torch.from_numpy(kvv).cuda()
    if paged:
        slots = torch.tensor([1, 0, 4, 4], dtype=torch.int32, device="cuda")
        got = verify_attn.verify_attention_paged(t(q), t(k), t(v), slots, kv_valid)
        want = ref.verify_attention_paged_ref(t(q), t(k), t(v), slots, kv_valid)
    else:
        got = verify_attn.verify_attention_packed(t(q), t(k[:4]), t(v[:4]), kv_valid)
        want = ref.verify_attention_ref(t(q), t(k[:4]), t(v[:4]), kv_valid)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=TOL["bf16"], atol=TOL["bf16"])
