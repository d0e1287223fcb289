"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and carries the ``cuda`` marker; on a
machine without one each skips inside the test. The file imports nothing
of JAX (nor ml_dtypes), so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.) Inputs come from a
numpy seed; bf16 tensors are rounded from f32 by PyTorch (round to nearest
even). Tolerances are those of tests/test_kernels.py: attention bf16 2e-2;
the SSD scan bf16 4e-2 for y, f32 3e-3 for the state. The attention
kernel's batch invariance is exact (bit for bit). The cases at head_dim 96
and G = 48, and the non-causal case, hold attention to ``ATTN_TIGHT``
(2e-3, chip_smoke.py's bound). The attention backward's kernels
(``attn_bwd``) are held to the plain version's autograd gradient within
``GRAD_TIGHT`` (2e-2 of the largest element, chip_smoke.py's bound), and
two calls to each other bit for bit; ``ops.attention`` on CUDA tensors
runs the kernels, forward and backward. The forward's LSE
(``return_lse=True``) and ``attn_bwd.delta`` are held to
``ref.attention_lse_ref`` and ``ref.attention_bwd_delta_ref`` within
``STATS_TIGHT`` (1e-4 of the largest element, chip_smoke.py's bound), the
forward's output with the LSE to the output without it bit for bit. The
shard form (``verify_attention_packed_shard``, one sequence shard of the
cache at ``pos_offset``) is held to ``ref.verify_attention_shard_ref``: its
f32 output within ``ATTN_TIGHT``, its LSE within ``STATS_TIGHT``, -inf
exactly where a row sees nothing of the shard.
The SSD scan's backward kernels (``ssd_scan.ssd_scan_bwd``) are held to
the plain backward (``ref.ssd_scan_bwd_ref``) within ``SSD_GRAD_TIGHT``
(1e-2 of each output's largest element, chip_smoke.py's bound), two calls
to each other bit for bit; the forward's chunk states to the plain scan's
within the f32 SSD tolerance, its y and state with and without them bit
for bit; ``ops.ssd_scan`` on CUDA tensors that need a gradient runs the
forward and backward kernels; the backward takes every chunk size and
width its earlier design took.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import attn_bwd, ops, ref, ssd_scan, verify_attn

ATTN_TOL = 2e-2
ATTN_TIGHT = 2e-3
GRAD_TIGHT = 2e-2
STATS_TIGHT = 1e-4
SSD_TOL = {"bf16": 4e-2, "f32": 3e-3}
SSD_GRAD_TIGHT = 1e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _bf16(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, torch.bfloat16)


def _quantize(kf: np.ndarray):
    """A (rows, Skv, Hkv, D) f32 cache as int8 with per-(row, head) scales."""
    scale = (np.abs(kf).max(axis=(1, 3)) / 127.0 + 1e-6).astype(np.float32)
    q = np.clip(np.round(kf / scale[:, None, :, None]), -127, 127).astype(np.int8)
    return q, scale


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "head_dim"])
def test_cuda_kernel_rejects_unsupported_inputs(bad):
    dev = _card()
    D = 32 if bad == "head_dim" else 64
    dt = torch.float32 if bad == "dtype" else torch.bfloat16
    q = torch.zeros((1, 1, 4, D), dtype=dt, device=dev)
    k = torch.zeros((1, 64, 2, D), dtype=dt, device=dev)
    kvv = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        verify_attn.verify_attention_packed(q, k, k, kvv)


@pytest.mark.cuda
def test_cuda_int8_kernel_requires_scales():
    dev = _card()
    q = torch.zeros((1, 1, 4, 64), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((1, 64, 2, 64), dtype=torch.int8, device=dev)
    kvv = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="k_scale"):
        verify_attn.verify_attention_packed(q, k, k, kvv)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_kernels_match_plain_versions(paged, kv):
    """Each attention entry against its plain version (bf16 bound),
    main-path widths, ragged Skv, uneven kv_valid, duplicate scratch slots."""
    dev = _card()
    rng = np.random.default_rng(13)
    B, Sq, Hq, Hkv, Skv, D, rows = 4, 5, 12, 2, 200, 128, 5
    q = _bf16(rng.standard_normal((B, Sq, Hq, D)), dev)
    kf = rng.standard_normal((rows, Skv, Hkv, D)).astype(np.float32)
    vf = rng.standard_normal((rows, Skv, Hkv, D)).astype(np.float32)
    kv_valid = torch.tensor([Skv, 120, 6, 17], dtype=torch.int32, device=dev)
    if kv == "int8":
        (k, ks), (v, vs) = _quantize(kf), _quantize(vf)
        k, v, ks, vs = (torch.from_numpy(a).to(dev) for a in (k, v, ks, vs))
    else:
        k, v = _bf16(kf, dev), _bf16(vf, dev)
        ks = vs = None
    if paged:
        slots = torch.tensor([1, 0, 4, 4], dtype=torch.int32, device=dev)
        got = verify_attn.verify_attention_paged(q, k, v, slots, kv_valid, k_scale=ks, v_scale=vs)
        want = ref.verify_attention_paged_ref(q, k, v, slots, kv_valid, k_scale=ks, v_scale=vs)
    else:
        sel = lambda t: None if t is None else t[:B]  # noqa: E731
        got = verify_attn.verify_attention_packed(q, k[:B], v[:B], kv_valid, k_scale=sel(ks),
                                                  v_scale=sel(vs))
        want = ref.verify_attention_ref(q, k[:B], v[:B], kv_valid, k_scale=sel(ks),
                                        v_scale=sel(vs))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


# the reduced qwen2's attention (Hq 4, Hkv 2, head_dim 16, max_len 128):
# (B, Sq, Skv, kv_valid, pool slots or None for a dense cache)
_D16_SHAPES = [
    (4, 5, 128, [40, 17, 128, 5], [1, 0, 3, 3]),  # engine verify, k_max 4, a scratch row
    (1, 8, 128, [8], None),                          # slot prefill of an 8-token prompt
    (1, 1, 128, [23], None),                         # draft decode
    (2, 5, 128, [70, 65], [2, 1]),                   # two splits
]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("shape", range(len(_D16_SHAPES)))
def test_cuda_head_dim_16_matches_plain_version(shape, kv):
    """head_dim 16, the reduced configs' (its P.V tile: 4 column groups of
    4 by 32 row groups), dense and paged, bf16 and int8 caches, against
    the plain version."""
    dev = _card()
    B, Sq, Skv, kvv, slots = _D16_SHAPES[shape]
    rng = np.random.default_rng(29 + shape)
    rows = B if slots is None else max(slots) + 1
    q = _bf16(rng.standard_normal((B, Sq, 4, 16)), dev)
    kf = rng.standard_normal((rows, Skv, 2, 16)).astype(np.float32)
    vf = rng.standard_normal((rows, Skv, 2, 16)).astype(np.float32)
    kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
    sc = {}
    if kv == "int8":
        (k, ks), (v, vs) = _quantize(kf), _quantize(vf)
        k, v, ks, vs = (torch.from_numpy(a).to(dev) for a in (k, v, ks, vs))
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = _bf16(kf, dev), _bf16(vf, dev)
    if slots is None:
        got = verify_attn.verify_attention_packed(q, k, v, kv_valid, **sc)
        want = ref.verify_attention_ref(q, k, v, kv_valid, **sc)
    else:
        sl = torch.tensor(slots, dtype=torch.int32, device=dev)
        got = verify_attn.verify_attention_paged(q, k, v, sl, kv_valid, **sc)
        want = ref.verify_attention_paged_ref(q, k, v, sl, kv_valid, **sc)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 199, 32, 64, 128, 256), (2, 300, 4, 16, 32, 64)])
def test_cuda_ssd_scan_matches_plain_version(shape):
    """The SSD kernel against its plain version: bf16 x, B, C as strided
    views of one conv output, a ragged last chunk."""
    dev = _card()
    B, S, H, P, N, chunk = shape
    rng = np.random.default_rng(3)
    xbc = _bf16(rng.standard_normal((B, S, H * P + 2 * N)), dev)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32))
    A = torch.from_numpy((-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(np.float32))
    dt, A, h0 = dt.to(dev), A.to(dev), h0.to(dev)
    y, h = ssd_scan.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk)
    yw, hw = ref.ssd_scan_ref(x, dt, A, Bm, Cm, h0, chunk=chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.float().cpu().numpy(), yw.float().cpu().numpy(),
                               rtol=SSD_TOL["bf16"], atol=SSD_TOL["bf16"])
    np.testing.assert_allclose(h.cpu().numpy(), hw.cpu().numpy(),
                               rtol=SSD_TOL["f32"], atol=SSD_TOL["f32"])


def _attn_case(dev, rng, kv, B, Sq, Skv, rows, kvv):
    Hq, Hkv, D = 12, 2, 128
    q = _bf16(rng.standard_normal((B, Sq, Hq, D)), dev)
    kf = rng.standard_normal((rows, Skv, Hkv, D)).astype(np.float32)
    vf = rng.standard_normal((rows, Skv, Hkv, D)).astype(np.float32)
    kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
    if kv == "int8":
        (k, ks), (v, vs) = _quantize(kf), _quantize(vf)
        k, v, ks, vs = (torch.from_numpy(a).to(dev) for a in (k, v, ks, vs))
        return q, k, v, kv_valid, dict(k_scale=ks, v_scale=vs)
    return q, _bf16(kf, dev), _bf16(vf, dev), kv_valid, {}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_kernels_at_split_edges(paged, kv):
    """The kernel's 64-position splits: the last query's position at a
    split's end (kv_valid 64, 128) and one past it (65, 129), and
    kv_valid < Sq (rows before position 0 see nothing and give 0)."""
    dev = _card()
    rng = np.random.default_rng(17)
    kvv = [64, 65, 128, 129, 3]
    q, k, v, kv_valid, sc = _attn_case(dev, rng, kv, 5, 5, 200, 5, kvv)
    if paged:
        slots = torch.tensor([4, 3, 2, 1, 0], dtype=torch.int32, device=dev)
        got = verify_attn.verify_attention_paged(q, k, v, slots, kv_valid, **sc)
        want = ref.verify_attention_paged_ref(q, k, v, slots, kv_valid, **sc)
    else:
        got = verify_attn.verify_attention_packed(q, k, v, kv_valid, **sc)
        want = ref.verify_attention_ref(q, k, v, kv_valid, **sc)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    assert torch.equal(got[4, :2], torch.zeros_like(got[4, :2]))  # positions -2, -1


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_cuda_attention_is_batch_invariant(kv):
    """Each row of a batch of 6 (the engine's verify with scratch rows)
    equals the same row served alone, bit for bit, paged and dense."""
    dev = _card()
    rng = np.random.default_rng(23)
    kvv = [205, 233, 240, 5, 5, 5]
    q, k, v, kv_valid, sc = _attn_case(dev, rng, kv, 6, 5, 512, 6, kvv)
    slots = torch.tensor([3, 0, 5, 1, 1, 1], dtype=torch.int32, device=dev)
    paged = verify_attn.verify_attention_paged(q, k, v, slots, kv_valid, **sc)
    dense = verify_attn.verify_attention_packed(q, k, v, kv_valid, **sc)
    for b in range(6):
        one = lambda t: t[b:b + 1].contiguous()  # noqa: E731
        alone = verify_attn.verify_attention_paged(one(q), k, v, one(slots), one(kv_valid), **sc)
        dense_sc = {name: one(t) for name, t in sc.items()}
        alone_dense = verify_attn.verify_attention_packed(one(q), one(k), one(v), one(kv_valid),
                                                          **dense_sc)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], paged[b]), b
        assert torch.equal(alone_dense[0], dense[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("P, N", [(24, 32), (16, 24)])
def test_cuda_ssd_scan_refuses_widths_it_does_not_tile(P, N):
    """The kernel takes P in 16-column slices and N in 16-column steps."""
    dev = _card()
    x = torch.zeros((1, 32, 2, P), dtype=torch.bfloat16, device=dev)
    bc = torch.zeros((1, 32, N), dtype=torch.bfloat16, device=dev)
    dt = torch.ones((1, 32, 2), device=dev)
    with pytest.raises(ValueError, match="slices"):
        ssd_scan.ssd_scan(x, dt, -torch.ones(2, device=dev), bc, bc, chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_attention_at_one_query_head_per_kv_head(paged, D):
    """G = 1, zamba2's shared block (32 query heads on 32 KV heads of 64;
    the reduced config's 4 on 4 of 16): against the plain version at a
    gathered verify's shape (B 6, Sq 5, kv ~230 of 512), and each row of the
    batch equal to the same row alone, bit for bit."""
    dev = _card()
    H = 32 if D == 64 else 4
    rng = np.random.default_rng(31 + D)
    kvv = [205, 212, 233, 240, 219, 5]
    q = _bf16(rng.standard_normal((6, 5, H, D)), dev)
    k = _bf16(rng.standard_normal((6, 512, H, D)), dev)
    v = _bf16(rng.standard_normal((6, 512, H, D)), dev)
    kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
    slots = torch.tensor([2, 0, 5, 1, 4, 3], dtype=torch.int32, device=dev)
    if paged:
        run = lambda b: verify_attn.verify_attention_paged(  # noqa: E731
            q[b], k, v, slots[b], kv_valid[b])
        want = ref.verify_attention_paged_ref(q, k, v, slots, kv_valid)
    else:
        run = lambda b: verify_attn.verify_attention_packed(  # noqa: E731
            q[b], k[b], v[b], kv_valid[b])
        want = ref.verify_attention_ref(q, k, v, kv_valid)
    got = run(slice(None))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    for b in range(6):
        alone = run(slice(b, b + 1))
        torch.cuda.synchronize()
        assert torch.equal(alone[0], got[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 199, 64, 64, 64, 256), (2, 300, 64, 64, 64, 256),
                                   (2, 40, 8, 16, 16, 16)])
def test_cuda_ssd_scan_at_zamba2_widths(shape):
    """zamba2-1.2b's prefill scan (64 heads of 64, state 64; a ragged chunk,
    and a full one then a ragged one at B 2) and the reduced config's (8
    heads of 16, state 16, chunk 16) against the plain version."""
    test_cuda_ssd_scan_matches_plain_version(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("Hq, Hkv", [(24, 8), (32, 4)])
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_attention_at_the_moe_groupings(paged, Hq, Hkv, kv):
    """The moe family's groupings at head_dim 64: granite-moe-3b-a800m's 24
    query heads on 8 KV heads (G = 3, the first G that is not a power of
    two) and qwen3-moe-30b-a3b's 32 on 4 (G = 8), at a verify's shape (B 6,
    Sq 5, kv ~230 of 512, slots out of order), against the plain version,
    and each row of the batch equal to the same row alone, bit for bit."""
    dev = _card()
    D = 64
    rng = np.random.default_rng(41 + Hq)
    kvv = [205, 212, 233, 240, 219, 5]
    q = _bf16(rng.standard_normal((6, 5, Hq, D)), dev)
    kf = rng.standard_normal((6, 512, Hkv, D)).astype(np.float32)
    vf = rng.standard_normal((6, 512, Hkv, D)).astype(np.float32)
    if kv == "int8":
        (k, ks), (v, vs) = _quantize(kf), _quantize(vf)
        k, v, ks, vs = (torch.from_numpy(a).to(dev) for a in (k, v, ks, vs))
    else:
        k, v, ks, vs = _bf16(kf, dev), _bf16(vf, dev), None, None
    kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
    slots = torch.tensor([2, 0, 5, 1, 4, 3], dtype=torch.int32, device=dev)

    def sc(b):
        return {} if ks is None else dict(k_scale=ks[b], v_scale=vs[b])

    if paged:
        run = lambda b: verify_attn.verify_attention_paged(  # noqa: E731
            q[b], k, v, slots[b], kv_valid[b], **sc(slice(None)))
        want = ref.verify_attention_paged_ref(q, k, v, slots, kv_valid, **sc(slice(None)))
    else:
        run = lambda b: verify_attn.verify_attention_packed(  # noqa: E731
            q[b], k[b], v[b], kv_valid[b], **sc(b))
        want = ref.verify_attention_ref(q, k, v, kv_valid, **sc(slice(None)))
    got = run(slice(None))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    for b in range(6):
        alone = run(slice(b, b + 1))
        torch.cuda.synchronize()
        assert torch.equal(alone[0], got[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("Hq, Hkv, D", [(32, 32, 96), (48, 1, 128)])
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_attention_at_head_dim_96_and_mqa(paged, Hq, Hkv, D, kv):
    """phi3-mini's 32 query heads on 32 KV heads of 96 (the D = 96
    instantiation, its P.V tile 2 rows x 12 columns a thread) and
    granite-34b's 48 on 1 of 128 (G = 48: each query's 48 rows straddle two
    32-row tiles), at a verify's shape (B 6, Sq 5) with the splits' edges
    (kv_valid 64, 65, 129) and a scratch-like row (5), against the plain
    version within ``ATTN_TIGHT``, and each row of the batch equal to the
    same row alone, bit for bit."""
    dev = _card()
    rng = np.random.default_rng(47 + Hq)
    kvv = [205, 64, 65, 129, 240, 5]
    q = _bf16(rng.standard_normal((6, 5, Hq, D)), dev)
    kf = rng.standard_normal((6, 512, Hkv, D)).astype(np.float32)
    vf = rng.standard_normal((6, 512, Hkv, D)).astype(np.float32)
    if kv == "int8":
        (k, ks), (v, vs) = _quantize(kf), _quantize(vf)
        k, v, ks, vs = (torch.from_numpy(a).to(dev) for a in (k, v, ks, vs))
    else:
        k, v, ks, vs = _bf16(kf, dev), _bf16(vf, dev), None, None
    kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
    slots = torch.tensor([2, 0, 5, 1, 4, 3], dtype=torch.int32, device=dev)

    def sc(b):
        return {} if ks is None else dict(k_scale=ks[b], v_scale=vs[b])

    if paged:
        run = lambda b: verify_attn.verify_attention_paged(  # noqa: E731
            q[b], k, v, slots[b], kv_valid[b], **sc(slice(None)))
        want = ref.verify_attention_paged_ref(q, k, v, slots, kv_valid, **sc(slice(None)))
    else:
        run = lambda b: verify_attn.verify_attention_packed(  # noqa: E731
            q[b], k[b], v[b], kv_valid[b], **sc(b))
        want = ref.verify_attention_ref(q, k, v, kv_valid, **sc(slice(None)))
    got = run(slice(None))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=0, atol=ATTN_TIGHT)
    for b in range(6):
        alone = run(slice(b, b + 1))
        torch.cuda.synchronize()
        assert torch.equal(alone[0], got[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [300, 63, 5])
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_noncausal_attention_matches_plain_version(paged, Sq):
    """The non-causal case (``causal=False``: the encdec family's encoder
    and cross-attention) at whisper-tiny's 6 heads on 6 of 64: 300 rows
    over 300 fresh positions (an encoder of 300 frames, a ragged last
    split), 63 rows (a prefill's cross-attention) and 5 (a verify's) over
    uneven kv_valid (300, 64, 65, 129) and a layer of a stacked cache or
    pool, within ``ATTN_TIGHT`` of the plain version, each row equal to
    the same row alone bit for bit, and (with 63 rows or more) the causal
    result far from it."""
    dev = _card()
    rng = np.random.default_rng(71 + Sq)
    B, H, D, Skv, L = 4, 6, 64, 300, 2
    kvv = [300, 64, 65, 129]
    q = _bf16(rng.standard_normal((B, Sq, H, D)), dev)
    k = _bf16(rng.standard_normal((L, B + 1, Skv, H, D)), dev)
    v = _bf16(rng.standard_normal((L, B + 1, Skv, H, D)), dev)
    kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
    slots = torch.tensor([4, 0, 2, 1], dtype=torch.int32, device=dev)

    def run(b, causal=False):
        if paged:
            return verify_attn.verify_attention_paged(q[b], k, v, slots[b], kv_valid[b],
                                                      layer=1, causal=causal)
        return verify_attn.verify_attention_packed(q[b], k[:, :B][:, b].contiguous(),
                                                   v[:, :B][:, b].contiguous(), kv_valid[b],
                                                   layer=1, causal=causal)

    if paged:
        want = ref.verify_attention_paged_ref(q, k[1], v[1], slots, kv_valid, causal=False)
    else:
        want = ref.verify_attention_ref(q, k[1, :B], v[1, :B], kv_valid, causal=False)
    got = run(slice(None))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=0, atol=ATTN_TIGHT)
    if Sq > 5:  # the first rows see a few positions when causal, all of kv_valid when not
        causal = run(slice(None), causal=True)
        assert (causal.float() - got.float()).abs().max().item() > 10 * ATTN_TOL
    for b in range(B):
        alone = run(slice(b, b + 1))
        torch.cuda.synchronize()
        assert torch.equal(alone[0], got[b]), b


# (B, Sq, Skv, Hq, Hkv, D, kv_valid, causal): qwen2-1.5b's training rows,
# a causal offset at G 3, a non-causal cross-attention (Sq < Skv), D 16, and
# the edges of the kernels' 64 x 64 tiles: a ragged position block and query
# tile under a head split (G 6, D 128), D 96 with Sq not a multiple of 64
_BWD_SHAPES = [
    (2, 128, 128, 12, 2, 128, [128, 128], True),
    (2, 29, 70, 24, 8, 64, [70, 45], True),
    (2, 33, 150, 6, 6, 64, [150, 97], False),
    (2, 16, 16, 4, 2, 16, [16, 16], True),
    (2, 100, 200, 12, 2, 128, [200, 131], True),
    (2, 100, 100, 8, 4, 96, [100, 77], True),
]


def _bwd_inputs(shape, dev):
    """A _BWD_SHAPES row's bf16 q, k, v, dout and kv_valid on the card."""
    B, Sq, Skv, Hq, Hkv, D, kvv, causal = _BWD_SHAPES[shape]
    rng = np.random.default_rng(41 + shape)
    q, k, v, dout = (_bf16(rng.standard_normal(s), dev) for s in
                     ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D), (B, Sq, Hq, D)))
    return q, k, v, dout, torch.tensor(kvv, dtype=torch.int32, device=dev), causal


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(_BWD_SHAPES)))
def test_cuda_forward_lse_matches_plain(shape):
    """The dense entry with return_lse=True: its output the same bits as
    without the LSE, the LSE within STATS_TIGHT of the one-pass oracle."""
    dev = _card()
    q, k, v, _, kv_valid, causal = _bwd_inputs(shape, dev)
    out, lse = verify_attn.verify_attention_packed(q, k, v, kv_valid, causal=causal,
                                                   return_lse=True)
    plain_out = verify_attn.verify_attention_packed(q, k, v, kv_valid, causal=causal)
    want = ref.attention_lse_ref(q, k, kv_valid, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert _rel(lse, want) <= STATS_TIGHT, _rel(lse, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["layer", "int8", "paged"])
def test_cuda_return_lse_refuses_what_training_does_not_run(bad):
    dev = _card()
    q = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=dev)
    kvv = torch.full((1,), 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="return_lse"):
        if bad == "layer":
            verify_attn.verify_attention_packed(q, k[None], k[None], kvv, layer=0,
                                                return_lse=True)
        elif bad == "int8":
            k8, sc = k.to(torch.int8), torch.ones((1, 2), device=dev)
            verify_attn.verify_attention_packed(q, k8, k8, kvv, k_scale=sc, v_scale=sc,
                                                return_lse=True)
        else:
            slots = torch.zeros((1,), dtype=torch.int32, device=dev)
            verify_attn.verify_attention_paged(q, k, k, slots, kvv, return_lse=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(_BWD_SHAPES)))
def test_cuda_attention_delta_matches_plain(shape):
    """attn_bwd.delta within STATS_TIGHT of its plain version; two calls
    bit-equal."""
    dev = _card()
    q, k, v, dout, kv_valid, causal = _bwd_inputs(shape, dev)
    out = verify_attn.verify_attention_packed(q, k, v, kv_valid, causal=causal)
    got, again = attn_bwd.delta(out, dout), attn_bwd.delta(out, dout)
    want = ref.attention_bwd_delta_ref(out, dout)
    torch.cuda.synchronize()
    assert got.shape == want.shape and _rel(got, want) <= STATS_TIGHT, _rel(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(_BWD_SHAPES)))
def test_cuda_attention_backward_matches_plain_gradient(shape):
    """dQ, dK, dV of the three backward kernels, on the forward kernel's
    LSE, against autograd of the plain attention, within GRAD_TIGHT of the
    largest element; two calls bit-equal; ops.attention's gradient is the
    kernels'."""
    dev = _card()
    q, k, v, dout, kv_valid, causal = _bwd_inputs(shape, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.verify_attention_ref(*leaves, kv_valid, causal=causal),
                               leaves, dout)
    out, lse = verify_attn.verify_attention_packed(q, k, v, kv_valid, causal=causal,
                                                   return_lse=True)
    got = attn_bwd.attention_bwd(q, k, v, out, dout, kv_valid, lse, causal=causal)
    again = attn_bwd.attention_bwd(q, k, v, out, dout, kv_valid, lse, causal=causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    through_ops = torch.autograd.grad(ops.attention(*leaves, kv_valid, causal=causal), leaves,
                                      dout)
    torch.cuda.synchronize()
    for name, g, w, a, o in zip("qkv", got, want, again, through_ops):
        err = _rel(g, w)
        assert err <= GRAD_TIGHT, (name, err)
        assert torch.equal(g, a) and torch.equal(g, o), name


@pytest.mark.cuda
def test_cuda_attention_backward_rejects_unsupported_inputs():
    dev = _card()
    q = torch.zeros((1, 4, 2, 32), dtype=torch.bfloat16, device=dev)
    kvv = torch.full((1,), 4, dtype=torch.int32, device=dev)
    lse = torch.zeros((1, 2, 4), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        attn_bwd.attention_bwd(q, q[:, :, :1], q[:, :, :1], q, q, kvv, lse)
    q = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16, device=dev)
    for bad in (lse[:, :, :3], lse.double(), lse.transpose(1, 2)):
        with pytest.raises(ValueError, match="lse"):
            attn_bwd.attention_bwd(q, q[:, :, :1], q[:, :, :1], q, q, kvv, bad)


def _ssd_grad_inputs(shape, dev, seed=11):
    """x, B and C as strided bf16 views of one conv output, dt, A, a start
    state, dy (bf16) and the final state's cotangent."""
    B, S, H, P, N, _ = shape
    rng = np.random.default_rng(seed)
    xbc = _bf16(rng.standard_normal((B, S, H * P + 2 * N)), dev)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    dt = f32(np.log1p(np.exp(rng.standard_normal((B, S, H)))))
    A = f32(-np.exp(rng.standard_normal(H) * 0.5))
    h0, dh = f32(rng.standard_normal((B, H, P, N))), f32(rng.standard_normal((B, H, P, N)))
    dy = _bf16(rng.standard_normal((B, S, H, P)), dev)
    return x, dt, A, Bm, Cm, h0, dy, dh


# the last five: the chunk pass's edges. Q = 256 at P 64, N 128 (the state
# in strips), the same with a ragged last chunk; zamba2-1.2b's training rows
# (the N 64 instantiation, two blocks an SM); P and N of three 16-wide k
# slices over a ragged second chunk (the generic instantiation, the Gram
# blocks' alternating sums); N 256 at P 48 (strips, the P group narrowed, k
# slabs of 8, two N groups)
_SSD_GRAD_SHAPES = [(2, 64, 4, 16, 32, 16), (1, 199, 32, 64, 128, 256),
                    (2, 300, 8, 64, 64, 128), (8, 128, 32, 64, 128, 256),
                    (1, 256, 4, 64, 128, 256), (2, 300, 4, 64, 128, 256),
                    (8, 128, 64, 64, 64, 256), (1, 100, 5, 48, 48, 64),
                    (1, 161, 2, 48, 256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _SSD_GRAD_SHAPES)
def test_cuda_ssd_scan_bwd_matches_plain(shape):
    """The backward kernels on the forward kernel's chunk states against
    the plain backward within SSD_GRAD_TIGHT; two calls bit-equal; the
    states against the plain scan's; y and the state the same bits with
    and without the states."""
    dev = _card()
    chunk = shape[-1]
    x, dt, A, Bm, Cm, h0, dy, dh = _ssd_grad_inputs(shape, dev)
    y, h, states = ssd_scan.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk, return_states=True)
    y2, h2 = ssd_scan.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk)
    _, _, plain_states = ref.ssd_scan_ref(x, dt, A, Bm, Cm, h0, chunk=chunk, return_states=True)
    got = ssd_scan.ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy, dh, chunk=chunk)
    again = ssd_scan.ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy, dh, chunk=chunk)
    want = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    np.testing.assert_allclose(states.cpu().numpy(), plain_states.cpu().numpy(),
                               rtol=SSD_TOL["f32"], atol=SSD_TOL["f32"])
    for name, g, w, a in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want, again):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= SSD_GRAD_TIGHT, (name, _rel(g, w))
        assert torch.equal(g, a), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 4, 16, 32, 16), (8, 128, 32, 64, 128, 256),
                                   (2, 300, 4, 64, 128, 256)])
def test_cuda_ssd_scan_bwd_without_state_cotangent(shape):
    """dh_out None (zeros): the last chunk's end cotangent is read as zeros,
    in the resident tiles and in strips, with one chunk and with several."""
    dev = _card()
    chunk = shape[-1]
    x, dt, A, Bm, Cm, h0, dy, _ = _ssd_grad_inputs(shape, dev, seed=13)
    _, _, states = ssd_scan.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk, return_states=True)
    got = ssd_scan.ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy, None, chunk=chunk)
    again = ssd_scan.ssd_scan_bwd(x, dt, A, Bm, Cm, states, dy, None, chunk=chunk)
    want = ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, h0, dy, None, chunk=chunk)
    torch.cuda.synchronize()
    for name, g, w, a in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want, again):
        assert _rel(g, w) <= SSD_GRAD_TIGHT, (name, _rel(g, w))
        assert torch.equal(g, a), name


def _earlier_bwd_smem(q: int, n: int, p: int) -> int:
    """Shared memory of the backward's chunk block in its earlier design (4
    padded bf16 tiles and 10 rows of f32 per row of the chunk): the shapes
    the wrapper took then."""
    q16 = -(-q // 16) * 16
    o = 0
    for w in (p, p, n, n):
        o = -(-(o + 2 * q16 * (w + 8)) // 16) * 16
    o += 10 * 4 * q16
    return o + 32 + 32


@pytest.mark.cuda
def test_cuda_ssd_scan_bwd_takes_every_shape_it_took():
    """No (chunk, P, N) whose backward and forward blocks fit before is
    refused now: the chunk pass stages the state in strips where it cannot
    hold it whole (the kernels' library answers the sizes; no launch)."""
    _card()
    lib = ssd_scan._library()
    refused = []
    for p in range(16, 257, 16):
        for n in range(16, ssd_scan.MAX_N + 1, 16):
            for q in range(1, 1025):
                if (_earlier_bwd_smem(q, n, p) > ssd_scan.SMEM_LIMIT
                        or lib.ssd_scan_smem_bytes(q, n) > ssd_scan.SMEM_LIMIT):
                    continue
                if lib.ssd_scan_bwd_smem_bytes(q, n, p) > ssd_scan.SMEM_LIMIT:
                    refused.append((q, p, n))
    assert not refused, refused[:10]


@pytest.mark.cuda
def test_cuda_ops_ssd_scan_backward_runs_the_kernels():
    """ops.ssd_scan on CUDA tensors that need a gradient: one forward and
    one backward launch, gradients within SSD_GRAD_TIGHT of autograd of the
    plain scan; without a gradient no backward and no graph."""
    dev = _card()
    shape = (2, 64, 4, 16, 32, 16)
    x, dt, A, Bm, Cm, h0, dy, dh = _ssd_grad_inputs(shape, dev, seed=12)
    before = dict(ssd_scan.LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, h0)]
    y, h = ops.ssd_scan(*leaves, chunk=16)
    got = torch.autograd.grad([y, h], leaves, [dy, dh])
    assert ssd_scan.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    assert ssd_scan.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    plain = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, h0)]
    yp, hp = ref.ssd_scan_ref(*plain, chunk=16)
    want = torch.autograd.grad([yp, hp], plain, [dy, dh])
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        assert _rel(g, w) <= SSD_GRAD_TIGHT, (name, _rel(g, w))
    y3, _ = ops.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=16)
    assert y3.grad_fn is None and ssd_scan.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1


# the shard form's cases: (B, Sq, Hq, Hkv, D, S_loc, kv_valid, pos_offset);
# granite-34b's G = 48 at D 128 and a reduced D 16
_SHARD_CASES = [
    (2, 5, 48, 1, 128, 256, [1000, 700], 0),      # a shard wholly in the past
    (2, 5, 48, 1, 128, 256, [258, 258], 0),       # straddling rows, the first shard
    (2, 5, 48, 1, 128, 256, [258, 258], 256),     # the same rows, the second shard
    (2, 5, 48, 1, 128, 256, [200, 100], 256),     # a shard that sees nothing
    (3, 40, 4, 2, 16, 64, [100, 70, 64], 32),     # D 16, rows seeing part of it
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(_SHARD_CASES)))
@pytest.mark.parametrize("layered", [False, True])
def test_cuda_shard_form_matches_plain_version(case, layered):
    """``verify_attention_packed_shard`` against ``ref.verify_attention_shard_ref``:
    the f32 output within ``ATTN_TIGHT``, the LSE within ``STATS_TIGHT`` of
    its largest finite element, -inf (output 0) exactly where the plain
    version's LSE is; ``ops.verify_attention_shard`` on CUDA tensors runs the
    kernel (its launch counted)."""
    dev = _card()
    B, Sq, Hq, Hkv, D, skv, kvv, off = _SHARD_CASES[case]
    rng = np.random.default_rng(29 + case)
    lead = (3,) if layered else ()
    q = _bf16(rng.standard_normal((B, Sq, Hq, D)), dev)
    k = _bf16(rng.standard_normal((*lead, B, skv, Hkv, D)), dev)
    v = _bf16(rng.standard_normal((*lead, B, skv, Hkv, D)), dev)
    kv_valid = torch.tensor(kvv, dtype=torch.int32, device=dev)
    layer = 1 if layered else None
    before = verify_attn.LAUNCHES["verify_attention_packed_shard"]
    out, lse = ops.verify_attention_shard(q, k, v, kv_valid, pos_offset=off, layer=layer)
    assert verify_attn.LAUNCHES["verify_attention_packed_shard"] == before + 1
    kc, vc = (k[1], v[1]) if layered else (k, v)
    want, want_lse = ref.verify_attention_shard_ref(q, kc, vc, kv_valid, off)
    empty = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), empty)
    assert out.dtype == torch.float32 and bool((out[empty.transpose(1, 2)] == 0).all())
    assert (out - want).abs().max().item() <= ATTN_TIGHT
    if bool((~empty).any()):
        scale = want_lse[~empty].abs().max().item()
        assert (lse[~empty] - want_lse[~empty]).abs().max().item() <= STATS_TIGHT * scale


@pytest.mark.cuda
def test_cuda_shard_form_leaves_the_serve_and_training_forms_bit_for_bit():
    """pos_offset 0 over a whole cache: the shard form's output is the serve
    form's before its bf16 rounding, and the training form's LSE where rows
    see something (the serve and training forms keep their own bits)."""
    dev = _card()
    rng = np.random.default_rng(31)
    q = _bf16(rng.standard_normal((2, 5, 12, 128)), dev)
    k = _bf16(rng.standard_normal((2, 200, 2, 128)), dev)
    v = _bf16(rng.standard_normal((2, 200, 2, 128)), dev)
    kv_valid = torch.tensor([200, 77], dtype=torch.int32, device=dev)
    out, lse = verify_attn.verify_attention_packed_shard(q, k, v, kv_valid, pos_offset=0)
    serve, train_lse = verify_attn.verify_attention_packed(q, k, v, kv_valid, return_lse=True)
    assert torch.equal(out.to(torch.bfloat16), serve)
    assert torch.equal(lse, train_lse)
