"""The port's sampling mode (``greedy=False``) against the JAX package's.

The two packages draw from different generators (``torch.Generator`` on
the tensors' device, ``jax.random`` keys), so sampling is held
statistically, never token for token:
  * the first committed token of Leviathan rejection sampling with exact
    residuals follows the target softmax: chi-square over a 16-token
    vocabulary (df 15) under its 0.999 quantile, 37.7 (the statistical twin
    of tests/test_speculative.py::test_sampling_mode_statistically_lossless);
  * the acceptance count of the port's and of the JAX package's
    ``speculative_verify`` on the same logits, drafts and q each lies within
    4 sigma of its analytic mean sum_b min(1, p(d_b)/q(d_b)) (sigma from the
    Bernoulli variances), with and without ``draft_q_full``; without it
    both packages sample the correction from the target (the JAX package's
    documented deviation), whose first-token law is min(p, q) + (1 - beta) p;
  * ``sample_token`` histograms follow the softmax at the temperature;
  * served end to end (reference and engine backends) on the JAX package's
    bridged weights, the port's acceptance rate lies within 4 sigma of the
    JAX package's, sigma from both rates' binomial variances; the same seeds
    give the same tokens twice;
  * greedy streams do not depend on the session seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.server_engine import EdgeDeviceKit as JKit
from repro.core.server_engine import ServerEngine as JEngine
from repro.core.speculative import speculative_verify as jax_verify
from repro.api.spec import ServeSpec as JServeSpec
from repro.api.system import System as JSystem
from repro_torch.api import ServeSpec, System, build_models
from repro_torch.core.speculative import sample_token, speculative_verify
from test_torch_serve import SPEC_JSON, _port_bundle, jax_build_models

V, B = 16, 20000
CHI2_999_DF15 = 37.697  # scipy.stats.chi2.ppf(0.999, 15)
Z_MAX = 4.0


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _chi2(tokens: np.ndarray, probs: np.ndarray) -> float:
    counts = np.bincount(tokens, minlength=probs.shape[0])
    expected = tokens.shape[0] * probs
    return float(((counts - expected) ** 2 / expected).sum())


def _problem(K: int, seed: int = 0):
    """Target logits (K+1, V), draft dists q (K, V), and B drafts per row
    drawn from q with a torch generator (q(d) alongside)."""
    rng = np.random.default_rng(seed)
    t_logits = (rng.standard_normal((K + 1, V)) * 1.5).astype(np.float32)
    q = _softmax(rng.standard_normal((K, V)) * 1.5).astype(np.float32)
    gen = torch.Generator().manual_seed(seed)
    drafts = torch.multinomial(torch.from_numpy(q), B, replacement=True, generator=gen).T
    q_sel = np.take_along_axis(q[None], drafts.numpy()[..., None], -1)[..., 0]
    return t_logits, q, drafts.to(torch.int32).numpy(), q_sel


def _port(t_logits, q, drafts, q_sel, *, full: bool, seed: int = 1):
    K = drafts.shape[1]
    res = speculative_verify(
        torch.from_numpy(drafts), torch.from_numpy(t_logits).expand(B, K + 1, V),
        torch.Generator().manual_seed(seed), draft_q=torch.from_numpy(q_sel),
        draft_q_full=torch.from_numpy(q).expand(B, K, V) if full else None, greedy=False)
    return res.n_accepted.numpy(), res.out_tokens[:, 0].numpy()


def _jax(t_logits, q, drafts, q_sel, *, full: bool):
    K = drafts.shape[1]
    fn = jax.jit(lambda d, t, key, dq, qf: jax_verify(
        d, jnp.broadcast_to(t, (B, K + 1, V)), key, draft_q=dq,
        draft_q_full=None if qf is None else jnp.broadcast_to(qf, (B, K, V)), greedy=False))
    res = fn(jnp.asarray(drafts), jnp.asarray(t_logits), jax.random.key(1), jnp.asarray(q_sel),
             jnp.asarray(q) if full else None)
    return np.asarray(res.n_accepted), np.asarray(res.out_tokens[:, 0])


@pytest.mark.parametrize("K", [1, 3])
def test_exact_residual_first_token_follows_target(K):
    t_logits, q, drafts, q_sel = _problem(K)
    n_acc, first = _port(t_logits, q, drafts, q_sel, full=True)
    chi2 = _chi2(first, _softmax(t_logits[0]))
    print(f"K={K}: chi-square {chi2:.2f} (df 15, 0.999 quantile {CHI2_999_DF15})")
    assert chi2 < CHI2_999_DF15
    assert 0 < n_acc.mean() < K  # drafts both accepted and rejected


@pytest.mark.parametrize("full", [True, False], ids=["q_full", "target_fallback"])
def test_acceptance_and_correction_match_analytic_and_jax(full):
    t_logits, q, drafts, q_sel = _problem(1, seed=3)
    p = _softmax(t_logits[0])
    a = np.minimum(1.0, p[drafts[:, 0]] / q_sel[:, 0])
    mean, sigma = a.sum(), np.sqrt((a * (1 - a)).sum())
    beta = np.minimum(p, q[0]).sum()
    first_law = p if full else np.minimum(p, q[0]) + (1 - beta) * p
    for who, (n_acc, first) in (("port", _port(t_logits, q, drafts, q_sel, full=full)),
                                ("jax", _jax(t_logits, q, drafts, q_sel, full=full))):
        z = (n_acc.sum() - mean) / sigma
        chi2 = _chi2(first, first_law)
        print(f"{who}: accepted {n_acc.sum()} of {B}, analytic {mean:.1f}, z {z:.2f}; "
              f"first-token chi-square {chi2:.2f}")
        assert abs(z) <= Z_MAX
        assert chi2 < CHI2_999_DF15


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_sample_token_follows_softmax(temperature):
    logits = torch.from_numpy((np.random.default_rng(4).standard_normal(V) * 1.5)
                              .astype(np.float32)).expand(B, V)
    tok, p, probs = sample_token(logits, torch.Generator().manual_seed(5), temperature,
                                 greedy=False)
    want = _softmax(logits[0].numpy() / temperature)
    np.testing.assert_allclose(probs[0].numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(p.numpy(), probs.numpy()[np.arange(B), tok.numpy()])
    chi2 = _chi2(tok.numpy(), want)
    print(f"T={temperature}: chi-square {chi2:.2f}")
    assert chi2 < CHI2_999_DF15
    g, _, _ = sample_token(logits[:2], None, temperature, greedy=True)
    assert (g == int(np.argmax(want))).all()


# examples/specs/engine.json with enough drafted tokens for the rates'
# binomial sigmas (~0.02): 8 devices, 48 tokens each, fixed-length drafts
SERVE = dict(greedy=False, devices=8, max_new=48, c_th=0.0)


@pytest.fixture(scope="module")
def served():
    """The spec on the JAX package's weights, with numpy prompts."""
    jspec = dataclasses.replace(JServeSpec.from_json(SPEC_JSON), **SERVE)
    mb = jax_build_models(jspec.model)
    pb = _port_bundle(mb)
    prompts = np.random.default_rng(5).integers(
        0, jspec.model.vocab_size, size=(jspec.devices, jspec.prompt_len)).astype(np.int32)
    return jspec, mb, pb, prompts


def _jax_engine_rate(jspec, mb, prompts) -> tuple:
    """The JAX package's ServerEngine and sampling EdgeDevices, each round's
    q submitted (its System's in-process pump submits none, so its engine
    backend refuses greedy=False): (acceptance rate, drafted tokens)."""
    # one bucket: one verify compile (the padding does not move acceptance)
    eng = JEngine(mb.target, mb.target_params, n_slots=jspec.slots_per_replica,
                  max_len=jspec.max_len, k_max=jspec.k_max, greedy=False,
                  attn_chunk=jspec.attn_chunk, buckets=[jspec.slots_per_replica])
    kit = JKit(mb.draft, mb.draft_params, k_max=jspec.k_max, c_th=jspec.c_th, greedy=False,
               attn_chunk=jspec.attn_chunk)
    devs = {}
    for i, p in enumerate(prompts):
        eng.admit(i, jnp.asarray(p), 0.0)
        devs[i] = kit.spawn(i, jnp.asarray(p), max_len=jspec.max_len,
                            seed=jspec.session_seed_base + i)
    for tick in range(1, 1000):
        for i, dev in devs.items():
            if i in eng.streams and not dev.awaiting:
                eng.submit(i, dev.draft(), float(tick), draft_q=dev.pending_q)
        for v in eng.step(float(tick)) or []:
            devs[v.device_id].on_verdict(v)
            if len(devs[v.device_id].committed) >= jspec.max_new:
                eng.retire(v.device_id)
        if not eng.streams:
            st = eng.stats()
            return st.acceptance_rate, eng.drafted_tokens
    raise AssertionError("the JAX engine did not drain")


@pytest.mark.parametrize("backend", ["reference", "engine"])
def test_sampled_serve_acceptance_matches_jax(served, backend):
    jspec, mb, pb, prompts = served
    pspec = dataclasses.replace(ServeSpec.from_json(SPEC_JSON), **SERVE).with_backend(backend)
    if backend == "reference":
        jres = JSystem.build(jspec.with_backend("reference"), models=mb).serve(prompts)
        j_rate, j_n = jres.engine.acceptance_rate, sum(s.drafted for s in jres.sessions)
    else:
        j_rate, j_n = _jax_engine_rate(jspec, mb, prompts)
    runs = [System.build(pspec, models=pb, device="cpu").serve(prompts) for _ in range(2)]
    res = runs[0]
    p_rate, p_n = res.engine.acceptance_rate, sum(s.drafted for s in res.sessions)
    sigma = np.sqrt(j_rate * (1 - j_rate) / j_n + p_rate * (1 - p_rate) / p_n)
    z = (p_rate - j_rate) / max(sigma, 1e-9)
    print(f"{backend}: acceptance port {p_rate:.4f} ({p_n} drafted), "
          f"jax {j_rate:.4f} ({j_n} drafted), z {z:.2f}")
    assert abs(z) <= Z_MAX
    assert 0 < p_rate < 1
    assert runs[1].outputs == res.outputs  # the same seeds, the same tokens
    vocab = pspec.model.vocab_size
    assert all(len(t) == pspec.max_new and all(0 <= x < vocab for x in t)
               for t in res.outputs.values())
    if backend == "engine":
        other = System.build(dataclasses.replace(pspec, session_seed_base=7), models=pb,
                             device="cpu").serve(prompts)
        assert other.outputs != res.outputs  # the device seeds drive the drafts


def test_greedy_streams_ignore_session_seeds(served):
    _, _, pb, prompts = served
    spec = dataclasses.replace(ServeSpec.from_json(SPEC_JSON), **{**SERVE, "greedy": True})
    a = System.build(spec, models=pb, device="cpu").serve(prompts)
    b = System.build(dataclasses.replace(spec, session_seed_base=7), models=pb,
                     device="cpu").serve(prompts)
    ref = System.build(spec.with_backend("reference"), models=pb, device="cpu").serve(prompts)
    assert a.outputs == b.outputs == ref.outputs


@pytest.mark.parametrize("backend", ["reference", "engine"])
def test_sampled_ssm_serve_is_seeded_and_in_vocabulary(backend):
    """The ssm family samples too: its drafts roll back by per-step
    checkpoints and the engine verifies by gather/scatter."""
    model = dict(arch="mamba2-370m", draft_arch="mamba2-370m", draft_noise=0.05)
    spec = dataclasses.replace(ServeSpec.from_json(SPEC_JSON), greedy=False, backend=backend,
                               model=dataclasses.replace(ServeSpec().model, **model))
    pb = build_models(spec.model, device="cpu")
    a, b = (System.build(spec, models=pb, device="cpu").serve() for _ in range(2))
    assert a.outputs == b.outputs
    assert all(len(t) == spec.max_new and all(0 <= x < spec.model.vocab_size for x in t)
               for t in a.outputs.values())
    assert a.engine.rounds > 0
