"""The scanned state-space models (``models/ssm.py``), the slice as a whole,
against ``genjax_tpu`` and the exact Gaussian answers.

``linear_gaussian_ssm().scan(n=8)`` scores the same choices as the
reference to 1e-5; its exact log marginal is the reference's Kalman filter;
a vmapped ``generate`` under ``C[:, "y"]`` weighs each particle
``sum_t log N(y_t; z_t, 0.5)`` (the float64 reckoning ``chip_smoke.py``
gates on the card); the one-step ``IndexRequest`` and ``Regenerate`` of a
step weigh ``assess(new) - assess(old)`` lane by lane; ``sample_posterior``
over ``S[..., "z"]`` returns an ``IndexedChm`` of draws shaped ``(chains,
samples, T)``, held in law against the exact posterior from dense Gaussian
conditioning; the column algorithms refuse an indexed selection with the
reference's message, and the batched HMC runner refuses the SSM's traces on
the card (no device body). A JAX ``ScanTrace``'s choices cross as numpy.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu.models import linear_gaussian_ssm as ref_lgssm
from genjax_tpu.models import stochastic_volatility as ref_sv
from genjax_tpu_torch.inference import mcmc
from genjax_tpu_torch.inference import sample_posterior
from genjax_tpu_torch.interop import choice_map_from_numpy
from genjax_tpu_torch.models import linear_gaussian_ssm, stochastic_volatility
from torch_chm_bridge import to_jax
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
T = 8


def gen_at(seed):
    return torch.Generator().manual_seed(seed)


def _close(a, b, tol=TOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= tol + tol * abs(b), (a, b)


def _ys(seed=0, n=T):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def exact_posterior(ys, q=1.0, r=0.25):
    """Dense Gaussian conditioning of z_1..T on y_1..T (z_0 = 0): the
    precision is tridiagonal, ``1/q`` chains plus ``1/r`` on the diagonal."""
    n = len(ys)
    prec = np.zeros((n, n))
    for t in range(n):
        prec[t, t] += 1 / q + 1 / r
        if t + 1 < n:
            prec[t, t] += 1 / q
            prec[t, t + 1] -= 1 / q
            prec[t + 1, t] -= 1 / q
    cov = np.linalg.inv(prec)
    return cov @ (np.asarray(ys, np.float64) / r), cov


def test_scores_match_reference():
    kernel, _ = linear_gaussian_ssm()
    ref_kernel, _ = ref_lgssm()
    model, ref_model = kernel.scan(n=T), ref_kernel.scan(n=T)
    for seed in range(3):
        tr = model.simulate(gen_at(seed), (0.0, None))
        ref_score, (ref_c, ref_ys) = ref_model.assess(to_jax(tr.get_choices()), (0.0, None))
        _close(tr.get_score(), ref_score)
        c, ys = tr.get_retval()
        np.testing.assert_allclose(ys.numpy(), np.asarray(ref_ys), rtol=1e-6)
        _close(c, ref_c)


def test_generate_weights_match_reference_and_float64():
    kernel, _ = linear_gaussian_ssm()
    ref_kernel, _ = ref_lgssm()
    ys = torch.from_numpy(_ys(1))
    model = kernel.scan(n=T)
    trs, ws = torch.func.vmap(
        lambda _: model.generate(gen_at(0), g.C[:, "y"].set(ys), (0.0, None)), randomness="different"
    )(torch.zeros(16))
    z = trs.get_choices()[:, "z"].double()  # (16, T): lanes in front, then steps
    y64 = ys.double()
    expected = (-0.5 * (math.log(2 * math.pi * 0.25) + (y64 - z) ** 2 / 0.25)).sum(1)
    torch.testing.assert_close(ws.double(), expected, rtol=1e-5, atol=0)
    scores = torch.func.vmap(lambda tr: model.assess(tr.get_choices(), (0.0, None))[0])(trs)
    torch.testing.assert_close(scores, torch.func.vmap(lambda tr: tr.get_score())(trs), rtol=1e-5, atol=1e-5)
    one = torch.utils._pytree.tree_map(lambda v: v[3], trs)
    _, ref_w = ref_kernel.scan(n=T).generate(jax.random.key(0), to_jax(one.get_choices()), (0.0, None))
    _close(one.get_score(), ref_w)


def test_exact_log_marginal_matches_reference_and_importance():
    """The Kalman filter against the reference's, and the bootstrap
    importance estimate against it at three steps (where 20,000 particles
    leave about 3,000 effective ones: the error's sd is about 0.02)."""
    kernel, exact = linear_gaussian_ssm()
    _, ref_exact = ref_lgssm()
    _close(exact(_ys(2)), ref_exact(jnp.asarray(_ys(2))), 1e-5)
    ys = _ys(2, n=3)
    _, ws = torch.func.vmap(
        lambda _: kernel.scan(n=3).generate(gen_at(1), g.C[:, "y"].set(torch.from_numpy(ys)), (0.0, None)),
        randomness="different",
    )(torch.zeros(20000))
    log_z = float(torch.logsumexp(ws.double(), 0) - math.log(20000))
    assert abs(log_z - exact(ys)) < 0.1


def test_simulate_variance_in_law():
    """``z_t``'s prior variance is ``t`` (unit steps from ``z_0 = 0``)."""
    kernel, _ = linear_gaussian_ssm()
    n = 20000
    trs = torch.func.vmap(lambda _: kernel.scan(n=T).simulate(gen_at(2), (0.0, None)), randomness="different")(
        torch.zeros(n)
    )
    z = trs.get_choices()[:, "z"]
    for t in (0, T - 1):
        var = float(z[:, t].var())
        se = (t + 1) * math.sqrt(2 / (n - 1))
        assert abs(var - (t + 1)) < 4 * se, (t, var)


def test_stochastic_volatility_matches_reference():
    kernel, ref_kernel = stochastic_volatility(), ref_sv()
    tr = kernel.scan(n=T).simulate(gen_at(3), (-1.0, None))
    ref_score, _ = ref_kernel.scan(n=T).assess(to_jax(tr.get_choices()), (-1.0, None))
    _close(tr.get_score(), ref_score)


def test_vmapped_index_request_and_regenerate():
    """The card path's edits, on a few lanes: the weight equals ``assess(new)
    - assess(old)`` and the backward request cancels it, for the one-step
    ``IndexRequest`` (at a Python int and at a per-lane tensor index) and
    for a Regenerate of one step; a dense Update of the same value weighs
    the same as the IndexRequest."""
    kernel, _ = linear_gaussian_ssm()
    model = kernel.scan(n=T)
    ys = torch.from_numpy(_ys(4))
    trs = torch.func.vmap(
        lambda _: model.generate(gen_at(4), g.C[:, "y"].set(ys), (0.0, None))[0], randomness="different"
    )(torch.zeros(6))
    v = torch.linspace(-1, 1, 6)
    assess = torch.func.vmap(lambda tr: model.assess(tr.get_choices(), (0.0, None))[0])
    old = assess(trs)
    lanes = torch.tensor([0, 2, 3, 5, 6, T - 1])  # the last step has no next one
    for req_of in [
        lambda i, x: g.IndexRequest(3, g.Update(g.C["z"].set(x))),
        lambda i, x: g.IndexRequest(i, g.Update(g.C["z"].set(x))),
        lambda i, x: g.Update(g.C[3, "z"].set(x)),
        lambda i, x: g.IndexRequest(3, g.Regenerate(g.S["z"])),
    ]:
        def fwd(tr, i, x):
            new_tr, w, _rd, bwd = tr.edit(gen_at(5), req_of(i, x))
            return new_tr, w, bwd

        new, w, bwd = torch.func.vmap(fwd, randomness="different")(trs, lanes, v)
        torch.testing.assert_close(w, assess(new) - old, rtol=0, atol=1e-4)
        wb = torch.func.vmap(lambda tr, b: tr.edit(gen_at(6), b)[1], randomness="different")(new, bwd)
        torch.testing.assert_close(w + wb, torch.zeros(6), rtol=0, atol=1e-4)


@pytest.mark.parametrize("algorithm", ["hmc", "nuts"])
def test_sample_posterior_indexed_positions(algorithm):
    """``S[..., "z"]`` on the scanned model: the draws are an ``IndexedChm``
    shaped ``(chains, samples, T)``, in law against the exact posterior."""
    kernel, _ = linear_gaussian_ssm()
    ys = _ys(5)
    kw = dict(n_chains=256, n_warmup=30, n_samples=20, L=5) if algorithm == "hmc" else \
        dict(n_chains=64, n_warmup=10, n_samples=8, max_depth=3)
    res = sample_posterior(
        0, kernel.scan(n=T), g.C[:, "y"].set(torch.from_numpy(ys)), (0.0, None), g.S[..., "z"],
        algorithm=algorithm, eps0=0.2, device="cpu", **kw,
    )
    assert isinstance(res.positions, g.generative.choice_map.IndexedChm)
    z = res[:, "z"]
    assert tuple(z.shape) == (kw["n_chains"], kw["n_samples"], T)
    assert tuple(res.rhat_of((slice(None), "z")).shape) == (T,)
    if algorithm == "hmc":
        mean, cov = exact_posterior(ys)
        draws = z.reshape(-1, T).double().numpy()
        sd = np.sqrt(np.diag(cov))
        assert np.all(np.abs(draws.mean(0) - mean) < 0.1 * sd + 0.05)
        assert np.all(np.abs(draws.std(0) / sd - 1) < 0.15)
        assert float(res.rhat_of((slice(None), "z")).max()) < 1.1


def test_indexed_selection_raises():
    """The column algorithms refuse an index level with the reference's
    message (``genjax_tpu/inference/sample.py::_static_value_paths``)."""

    @g.gen
    def kern(c, x):
        z = g.normal(c, 1.0) @ "z"
        return (z, None)

    with pytest.raises(ValueError, match="statically"):
        sample_posterior(
            0, kern.scan(n=3), g.ChoiceMap.empty(), (0.0, torch.zeros(3)), g.S[..., "z"],
            n_chains=8, n_samples=4, algorithm="chees", device="cpu",
        )


def test_batched_hmc_runs_the_twin_here_and_refuses_on_the_card(monkeypatch):
    kernel, _ = linear_gaussian_ssm()
    model = kernel.scan(n=T)
    ys = torch.from_numpy(_ys(6))
    trs = torch.func.vmap(
        lambda _: model.generate(gen_at(7), g.C[:, "y"].set(ys), (0.0, None))[0], randomness="different"
    )(torch.zeros(8))
    new, _ = g.run_chains_hmc(gen_at(8), trs, g.S[..., "z"], eps=0.1, L=3, n_steps=2)
    assert g.run_chains_hmc.last_backend == "torch"
    assert torch.equal(new.get_choices()[:, "y"], trs.get_choices()[:, "y"])
    monkeypatch.setattr(mcmc, "trace_device", lambda tree: torch.device("cuda"))
    g.run_chains_hmc.last_backend = None
    with pytest.raises(ValueError, match="device body"):
        g.run_chains_hmc(gen_at(8), trs, g.S[..., "z"], eps=0.1, L=3)
    assert g.run_chains_hmc.last_backend is None


def test_scan_trace_choices_cross_as_numpy():
    """A JAX ``ScanTrace``'s choices, flattened to numpy under ``...``
    addresses, give the port the same ``assess`` to 1e-5."""
    ref_kernel, _ = ref_lgssm()
    ref_tr = ref_kernel.scan(n=T).simulate(jax.random.key(3), (0.0, None))
    flat = {(..., a): np.asarray(ref_tr.get_choices()[:, a], np.float32) for a in ("z", "y")}
    kernel, _ = linear_gaussian_ssm()
    score, _ = kernel.scan(n=T).assess(choice_map_from_numpy(flat), (0.0, None))
    _close(score, ref_tr.get_score())


def test_postfix_methods_need_the_combinators(monkeypatch):
    """``GenerativeFunction``'s postfix methods reach the combinators through
    the table ``combinators/__init__.py`` fills; an empty table names the
    import."""
    from genjax_tpu_torch.generative import gfi

    monkeypatch.setattr(gfi, "_COMBINATORS", {})
    kernel, _ = linear_gaussian_ssm()
    with pytest.raises(RuntimeError, match="import genjax_tpu_torch.combinators"):
        kernel.scan(n=3)


def test_combinator_names_match_the_reference():
    import genjax_tpu.combinators as jc

    import genjax_tpu_torch.combinators as tc

    assert tc.__all__ == jc.__all__
    for name in jc.__all__:
        assert hasattr(tc, name), name
    for name in ("IndexRequest", "VectorRequest", "categorical"):
        assert hasattr(g, name), name
