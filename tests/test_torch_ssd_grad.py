"""The SSD scan's backward (``kernels/ref.py``: ``ssd_scan_bwd_ref``, the
closed form, and ``ssd_scan_bwd_split_ref``, the CUDA kernels'
decomposition) against autograd of the plain scan and against ``jax.vjp``
of the JAX package's ``mamba2.ssd_chunked``.

Inputs come from a numpy seed, f32 unless a case says bf16, with both
cotangents (of y and of the final state) and a start state unless a case
leaves them out. Tolerances, each a share of the output's largest element:
``F32_REL`` (1e-5) for the closed form against autograd and for the split
form against the closed form (f32 sums in another order; the largest seen
2.4e-6), except dA, a sum over every (b, t) whose terms cancel, within
``DA_REL`` (1e-4; the largest seen 5.7e-5); ``JAX_REL`` (1e-5) against
``jax.vjp`` (the largest seen 5.6e-7); on bf16 inputs dx, dB and dC within
one bf16 step of the largest element (2^-8: both sides sum in f32 and round
once). ``SSD_GRAD_TIGHT`` is chip_smoke.py's bound for the kernels (1e-2):
a running sum of dt * A that leaves out each step's own term (exclusive
instead of inclusive) moves some output by far more (0.17 or more here).

The departure: once a chunk's |sum dt A| passes ~88, exp(cum_i - cum_j)
above the causal diagonal overflows. JAX masks the exp's result, so its
gradient there is 0 * inf = NaN in ddt and dA; the port masks the exponent
and evaluates the exp on the triangle only, so its gradient is finite and
equals its closed form evaluated in f64, which equals autograd of the f64
step-by-step recurrence (no exp of a positive number anywhere).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels import ref

F32_REL = 1e-5
DA_REL = 1e-4
JAX_REL = 1e-5
BF16_STEP = 2.0 ** -8
SSD_GRAD_TIGHT = 1e-2
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")

# (B, S, H, P, N, chunk, with h0 and dh_out)
CASES = {
    "one_chunk": (1, 16, 2, 16, 16, 16, True),
    "three_chunks": (1, 48, 2, 16, 16, 16, True),
    "ragged_last_chunk": (1, 37, 3, 16, 32, 16, True),
    "batch_2": (2, 40, 3, 16, 16, 16, True),
    "chunk_longer_than_s": (1, 10, 2, 16, 16, 32, True),
    "zero_start_and_no_state_cotangent": (2, 24, 2, 16, 16, 8, False),
    # P and N of three 16-wide k slices: the chunk pass's Gram blocks sum two
    # slices into one running sum and one into the other
    "odd_k16_slices": (1, 20, 2, 48, 48, 20, True),
}


def _inputs(B, S, H, P, N, with_state, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    d = {"x": f(B, S, H, P), "dt": np.log1p(np.exp(f(B, S, H))), "A": -np.exp(0.5 * f(H)),
         "Bm": f(B, S, N), "Cm": f(B, S, N), "dy": f(B, S, H, P)}
    d["h0"] = f(B, H, P, N) if with_state else None
    d["dh"] = f(B, H, P, N) if with_state else None
    return d


def _torch(d, dtype=torch.float32):
    out = {k: None if v is None else torch.from_numpy(v) for k, v in d.items()}
    for k in ("x", "Bm", "Cm", "dy"):
        out[k] = out[k].to(dtype)
    return out


def _bwd(t, chunk, **kw):
    return ref.ssd_scan_bwd_ref(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["h0"], t["dy"],
                                t["dh"], chunk=chunk, **kw)


def _autograd(t, chunk):
    leaves = {k: t[k].clone().requires_grad_() for k in ("x", "dt", "A", "Bm", "Cm")}
    h0 = None if t["h0"] is None else t["h0"].clone().requires_grad_()
    y, h = ref.ssd_scan_ref(leaves["x"], leaves["dt"], leaves["A"], leaves["Bm"], leaves["Cm"],
                            h0, chunk=chunk)
    outs, cots = [y], [t["dy"]]
    if t["dh"] is not None:
        outs, cots = [y, h], [t["dy"], t["dh"]]
    inputs = list(leaves.values()) + ([h0] if h0 is not None else [])
    grads = torch.autograd.grad(outs, inputs, cots)
    return grads if h0 is not None else (*grads, None)


def _rel(got, want) -> float:
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_ref_matches_autograd(case):
    B, S, H, P, N, chunk, with_state = CASES[case]
    t = _torch(_inputs(B, S, H, P, N, with_state))
    got, want = _bwd(t, chunk), _autograd(t, chunk)
    for name, g, w in zip(NAMES, got, want):
        if w is None:  # no start state: no gradient to it
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= (DA_REL if name == "dA" else F32_REL), (name, _rel(g, w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_ref_matches_jax_vjp(case):
    B, S, H, P, N, chunk, with_state = CASES[case]
    d = _inputs(B, S, H, P, N, with_state)
    h0 = d["h0"] if with_state else np.zeros((B, H, P, N), np.float32)
    dh = d["dh"] if with_state else np.zeros((B, H, P, N), np.float32)
    _, vjp = jax.vjp(lambda x, dt, A, Bm, Cm, h: ssd_chunked(x, dt, A, Bm, Cm, chunk, h0=h),
                     *(jnp.asarray(a) for a in (d["x"], d["dt"], d["A"], d["Bm"], d["Cm"], h0)))
    want = vjp((jnp.asarray(d["dy"]), jnp.asarray(dh)))
    got = _bwd(_torch(d), chunk)
    for name, g, w in zip(NAMES, got, want):
        w = torch.from_numpy(np.array(w))
        assert _rel(g, w) <= JAX_REL, (name, _rel(g, w))


@pytest.mark.parametrize("cumsum", ["torch", "kernel_order"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_bwd_matches_closed_form(case, cumsum):
    B, S, H, P, N, chunk, with_state = CASES[case]
    t = _torch(_inputs(B, S, H, P, N, with_state))
    kw = {"cumsum": ref.warp_scan_cumsum} if cumsum == "kernel_order" else {}
    _, _, states = ref.ssd_scan_ref(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["h0"],
                                    chunk=chunk, return_states=True)
    assert states.shape == (B, -(-S // min(chunk, S)), H, P, N)
    got = ref.ssd_scan_bwd_split_ref(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], states, t["dy"],
                                     t["dh"], chunk=chunk, **kw)
    want = _bwd(t, chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= (DA_REL if name == "dA" else F32_REL), (name, _rel(g, w))


@pytest.mark.parametrize("K", [16, 48, 64, 128])
def test_gram_k16_alternating_is_the_gram(K):
    """The chunk pass's Gram sum order (even and odd 16-wide k slices in two
    running sums) against one einsum in f64: within f32 rounding."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((2, 24, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 20, K)).astype(np.float32))
    got = ref.gram_k16_alternating(a, b)
    want = torch.einsum("bik,bjk->bij", a.double(), b.double())
    assert got.shape == (2, 24, 20) and got.dtype == torch.float32
    assert _rel(got, want) <= F32_REL


def test_chunk_states_are_the_scan_carried_state():
    """The first chunk starts at h0; each later chunk at the state the scan
    reached, so a scan of the first c chunks ends at chunk c's start."""
    B, S, H, P, N, chunk, _ = CASES["ragged_last_chunk"]
    t = _torch(_inputs(B, S, H, P, N, True))
    y, h, states = ref.ssd_scan_ref(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["h0"],
                                    chunk=chunk, return_states=True)
    assert torch.equal(states[:, 0], t["h0"])
    for c in range(1, states.shape[1]):
        _, hc = ref.ssd_scan_ref(t["x"][:, :c * chunk], t["dt"][:, :c * chunk], t["A"],
                                 t["Bm"][:, :c * chunk], t["Cm"][:, :c * chunk], t["h0"],
                                 chunk=chunk)
        torch.testing.assert_close(states[:, c], hc, rtol=0, atol=0)
    y2, h2 = ref.ssd_scan_ref(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["h0"], chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_bwd_ref_rounds_once(case):
    """bf16 x, B, C and dy (the card's dtypes): dx, dB and dC come back in
    bf16 within one bf16 step of the largest element of autograd's."""
    B, S, H, P, N, chunk, with_state = CASES[case]
    t = _torch(_inputs(B, S, H, P, N, with_state), torch.bfloat16)
    got, want = _bwd(t, chunk), _autograd(t, chunk)
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            continue
        assert g.dtype == w.dtype, name
        tol = BF16_STEP if g.dtype == torch.bfloat16 else (DA_REL if name == "dA" else F32_REL)
        assert _rel(g, w) <= tol, (name, _rel(g, w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_exclusive_cumsum_control_is_beyond_the_bound(case):
    B, S, H, P, N, chunk, with_state = CASES[case]
    t = _torch(_inputs(B, S, H, P, N, with_state))
    want = _bwd(t, chunk)
    late = _bwd(t, chunk, cumsum=lambda v: torch.cumsum(v, dim=1) - v)
    worst = max(_rel(g, w) for g, w in zip(late, want))
    assert worst > 10 * SSD_GRAD_TIGHT, worst


def _recurrence_f64(x, dt, A, Bm, Cm, h0):
    """The scan step by step in f64: h_t = exp(dt_t A) h_{t-1} + dt_t x_t
    B_t^T, y_t = h_t C_t. Returns (y, final h)."""
    h, ys = h0, []
    for t in range(x.shape[1]):
        h = (torch.exp(dt[:, t] * A)[..., None, None] * h
             + dt[:, t, :, None, None] * x[:, t, ..., None] * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def test_gradient_is_finite_where_jax_overflows():
    """dt = 1 and A = -1.5 over one 64-step chunk: |sum dt A| = 96 > 88.
    The port's f32 gradient is finite and equals its closed form evaluated
    in f64 (exp on the triangle only), which equals autograd of the f64
    step-by-step recurrence; JAX's is NaN in ddt and dA and agrees
    elsewhere."""
    B, S, H, P, N, chunk = 1, 64, 2, 16, 16, 64
    d = _inputs(B, S, H, P, N, True, seed=3)
    d["dt"] = np.ones((B, S, H), np.float32)
    d["A"] = np.full((H,), -1.5, np.float32)
    _, vjp = jax.vjp(lambda x, dt, A, Bm, Cm, h: ssd_chunked(x, dt, A, Bm, Cm, chunk, h0=h),
                     *(jnp.asarray(d[k]) for k in ("x", "dt", "A", "Bm", "Cm", "h0")))
    jg = dict(zip(NAMES, (np.array(g) for g in vjp((jnp.asarray(d["dy"]),
                                                      jnp.asarray(d["dh"]))))))
    assert np.isnan(jg["ddt"]).any() and np.isnan(jg["dA"]).any()

    t = _torch(d)
    got = dict(zip(NAMES, _bwd(t, chunk)))
    auto = dict(zip(NAMES, _autograd(t, chunk)))
    f64 = dict(zip(NAMES, _bwd({k: v.double() for k, v in t.items()}, chunk)))
    leaves = [torch.from_numpy(d[k]).double().requires_grad_()
              for k in ("x", "dt", "A", "Bm", "Cm", "h0")]
    y, h = _recurrence_f64(*leaves)
    rec = dict(zip(NAMES, torch.autograd.grad(
        [y, h], leaves, [torch.from_numpy(d["dy"]).double(), torch.from_numpy(d["dh"]).double()])))
    for name in NAMES:
        tol = DA_REL if name == "dA" else F32_REL
        assert f64[name].dtype == torch.float64 and _rel(f64[name], rec[name]) <= 1e-12, name
        for mine in (got[name], auto[name]):
            assert bool(torch.isfinite(mine).all()), name
            assert _rel(mine, f64[name]) <= tol, (name, _rel(mine, f64[name]))
        if name not in ("ddt", "dA"):  # JAX is finite there, and agrees
            assert _rel(got[name], torch.from_numpy(jg[name])) <= JAX_REL, name
