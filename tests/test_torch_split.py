"""The CUDA kernels' decompositions, restated in plain PyTorch, against the
plain versions and the JAX package.

``ref.verify_attention_split_ref`` is the attention kernel's split-KV
algorithm (fixed splits computed side by side, each rounded at its running
max, merged in split order); ``ref.ssd_scan_sliced_ref`` is the SSD
kernel's (C.B^T once per (b, chunk), the rest in P slices). Both serve the
tests only. Inputs come from a numpy seed. Tolerances:
  - against the port's plain versions: attention with ``split`` equal to
    the plain version's ``block_k`` takes the same steps, so it must agree
    bit for bit (the kernel relies on it); the SSD scan 1e-5 relative and
    absolute (all f32, sums in another order);
  - against the JAX package, those of tests/test_kernels.py: attention
    bf16 2e-2, f32 2e-3; SSD f32 3e-3.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import mamba2 as jmamba2
from repro_torch.kernels import ref

JAX_TOL = {"bf16": 2e-2, "f32": 2e-3}
SSD_TIGHT = 1e-5
SSD_JAX_TOL = 3e-3


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
