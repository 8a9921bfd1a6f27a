"""Pathfinder (``inference/pathfinder.py``) and its L-BFGS
(``inference/_lbfgs.py``) against ``genjax_tpu``, ``optax`` and exact
Gaussian algebra.

Deterministic against the reference to 1e-5: ``_inverse_hessian`` (with
invalid history slots) and ``_mvn_logpdf_cols``; against an explicit BFGS
recursion at the reference test's 2e-4. The port's L-BFGS against
``optax.lbfgs`` (imported here only) in float64: on a strictly convex
quadratic, D = 8, the first 10 iterates within 1e-6; on the 2-d Rosenbrock
function, the optimum within 1e-4.

In law (``tests/inference/test_pathfinder.py``'s tolerances): on a Gaussian
target the best Gaussian's mean within 0.02 and its ELBO within 0.05 of log
Z, the importance ratios nearly constant (SD < 0.1), the draws' mean within
0.1; the pooled multi-path resample's mean within 0.1 and covariance within
0.2, its smoothed weights and k-hat those of the reference's smoothing of
the same pooled ratios to 1e-5 (in place of the reference test's k-hat <
0.7, which a Gaussian target's nearly constant ratios leave undetermined,
see the test); the column bridge's posterior mean within 0.05 and SD
within 15% of the conjugate posterior. The single path runs with 1,024 ELBO
samples where the reference test takes 64: at 64 the best-ELBO pick is
noisy enough that for some seeds it is an iterate of inexact curvature, in
the reference as in the port (a KL of up to 0.19 from the target over
seeds 0-7); at 1,024 its KL stays below 0.002, which the test holds to
0.01, in place of the reference test's element-wise covariance check,
which an iterate that close can still miss.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import column_pathfinder, multi_pathfinder, pathfinder
from genjax_tpu_torch.inference._lbfgs import lbfgs_init, lbfgs_update, value_and_grad_from_state
from torch_threads import _one_thread  # noqa: F401

# the modules (the packages' ``pathfinder`` names are the functions)
ref = importlib.import_module("genjax_tpu.inference.pathfinder")
ref_mc = importlib.import_module("genjax_tpu.inference.model_comparison")
port = importlib.import_module("genjax_tpu_torch.inference.pathfinder")


def test_inverse_hessian_matches_explicit_bfgs_recursion():
    rng = np.random.default_rng(0)
    dim, J = 4, 3
    S = rng.normal(size=(dim, J))
    Z = S * 2.0 + 0.3 * rng.normal(size=(dim, J))
    gamma = float(S[:, -1] @ Z[:, -1] / (Z[:, -1] @ Z[:, -1]))
    H = gamma * np.eye(dim)
    for j in range(J):
        s, z = S[:, j], Z[:, j]
        rho = 1.0 / (s @ z)
        V = np.eye(dim) - rho * np.outer(s, z)
        H = V @ H @ V.T + rho * np.outer(s, s)
    got = port._inverse_hessian(torch.tensor(S, dtype=torch.float32), torch.tensor(Z, dtype=torch.float32),
                                torch.ones(J), torch.tensor(gamma))
    np.testing.assert_allclose(got.numpy(), H, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("valid", [[0.0, 1.0, 0.0, 1.0], [1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 1.0]])
def test_inverse_hessian_matches_reference(valid):
    rng = np.random.default_rng(1)
    S = rng.normal(size=(3, 4)).astype(np.float32)
    Z = (S * 1.5 + 0.2 * rng.normal(size=(3, 4))).astype(np.float32)
    got = port._inverse_hessian(torch.from_numpy(S), torch.from_numpy(Z), torch.tensor(valid), 0.7)
    want = ref._inverse_hessian(jnp.asarray(S), jnp.asarray(Z), jnp.asarray(valid, jnp.float32), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_invalid_slots_contribute_zero():
    rng = np.random.default_rng(1)
    S = rng.normal(size=(3, 4)).astype(np.float32)
    Z = (S * 1.5).astype(np.float32)
    got = port._inverse_hessian(torch.from_numpy(S), torch.from_numpy(Z), torch.tensor([0.0, 1.0, 0.0, 1.0]), 0.7)
    want = port._inverse_hessian(torch.from_numpy(S[:, [1, 3]]), torch.from_numpy(Z[:, [1, 3]]), torch.ones(2), 0.7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_mvn_logpdf_cols_matches_reference():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 3))
    chol = np.linalg.cholesky(a @ a.T + np.eye(3)).astype(np.float32)
    mu = rng.normal(size=3).astype(np.float32)
    z = rng.normal(size=(3, 11)).astype(np.float32)
    got = port._mvn_logpdf_cols(torch.from_numpy(z), torch.from_numpy(mu), torch.from_numpy(chol))
    want = ref._mvn_logpdf_cols(jnp.asarray(z), jnp.asarray(mu), jnp.asarray(chol))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---- the L-BFGS against optax.lbfgs


def _optax_path(f, x0, n):
    with jax.enable_x64(True):
        opt = optax.lbfgs(memory_size=6)
        vag = optax.value_and_grad_from_state(f)

        @jax.jit
        def step(x, state):
            v, grad = vag(x, state=state)
            updates, state = opt.update(grad, state, x, value=v, grad=grad, value_fn=f)
            return optax.apply_updates(x, updates), state

        x = jnp.asarray(x0, jnp.float64)
        state, out = opt.init(x), []
        for _ in range(n):
            x, state = step(x, state)
            out.append(np.asarray(x))
    return np.array(out)


def _port_path(f_batch, x0, n):
    def vag(x):
        x = x.detach().requires_grad_(True)
        v = f_batch(x)
        (grad,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), grad

    x = torch.tensor(x0, dtype=torch.float64)[None]
    state, out = lbfgs_init(x, 6), []
    for _ in range(n):
        v, grad = value_and_grad_from_state(vag, x, state)
        x, state = lbfgs_update(vag, grad, state, x, v)
        out.append(x[0].numpy())
    return np.array(out)


def test_lbfgs_matches_optax_on_a_quadratic():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(8, 8))
    A, b, x0 = a @ a.T + 0.5 * np.eye(8), rng.normal(size=8), rng.normal(size=8)
    At, bt = torch.tensor(A), torch.tensor(b)
    want = _optax_path(lambda x: 0.5 * x @ jnp.asarray(A) @ x - jnp.asarray(b) @ x, x0, 10)
    got = _port_path(lambda x: 0.5 * torch.einsum("pi,ij,pj->p", x, At, x) - x @ bt, x0, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_lbfgs_finds_the_rosenbrock_optimum():
    x0 = np.array([-1.2, 1.0])
    want = _optax_path(lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2, x0, 60)
    got = _port_path(lambda x: (1 - x[:, 0]) ** 2 + 100 * (x[:, 1] - x[:, 0] ** 2) ** 2, x0, 60)
    np.testing.assert_allclose(got[-1], [1.0, 1.0], atol=1e-4)
    np.testing.assert_allclose(want[-1], [1.0, 1.0], atol=1e-4)


# ---- Pathfinder in law


def _gaussian_target(m, cov):
    m = torch.as_tensor(m, dtype=torch.float32)
    prec = torch.linalg.inv(torch.as_tensor(cov, dtype=torch.float32))

    def logp(z):
        d = z - m[:, None]
        return -0.5 * torch.sum(d * (prec @ d), dim=0)

    return logp


_A = np.random.default_rng(5).normal(size=(3, 3))
COV = np.asarray(_A @ _A.T + 2.0 * np.eye(3), np.float32)
M = np.asarray([1.5, -0.5, 2.0], np.float32)
LOG_Z = 0.5 * 3 * np.log(2 * np.pi) + 0.5 * np.linalg.slogdet(COV)[1]


def _kl_to_target(mu, chol):
    S = (chol @ chol.T).double().numpy()
    P = np.linalg.inv(COV.astype(np.float64))
    dm = M - mu.double().numpy()
    return 0.5 * (np.trace(P @ S) + dm @ P @ dm - 3 + np.linalg.slogdet(COV)[1] - np.linalg.slogdet(S)[1])


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_recovers_mean_and_log_normalizer(seed):
    res = pathfinder(seed, _gaussian_target(M, COV), 3, n_iters=40, history=6, n_elbo_samples=1024, n_draws=4000,
                     device="cpu")
    np.testing.assert_allclose(res.mu.numpy(), M, atol=0.02)
    assert float(res.elbo) == pytest.approx(float(LOG_Z), abs=0.05)
    assert _kl_to_target(res.mu, res.scale_tril) < 0.01
    assert tuple(res.draws.shape) == (3, 4000)
    assert float((res.logp - res.logq).std()) < 0.1
    np.testing.assert_allclose(res.draws.mean(dim=1).numpy(), M, atol=0.1)


def test_elbo_is_the_best_of_its_trace():
    res = pathfinder(11, _gaussian_target(M, COV), 3, n_iters=30, device="cpu")
    assert np.isfinite(float(res.elbo))
    assert float(res.elbo) == pytest.approx(float(res.elbo_trace.max()), abs=1e-5)
    assert tuple(res.linesearch_steps.shape) == (30,) and int(res.linesearch_steps.min()) >= 1


def test_multi_pathfinder_runs_its_paths_as_one_batch():
    widths = []
    logp = _gaussian_target(M, COV)

    def counted(z):
        widths.append(z.shape[1])
        return logp(z)

    res = multi_pathfinder(0, counted, 3, n_paths=5, n_resample=100, n_iters=8, n_draws=50, device="cpu")
    assert all(w % 5 == 0 for w in widths), widths
    assert tuple(res.paths.mu.shape) == (5, 3) and tuple(res.paths.draws.shape) == (5, 3, 50)


def test_pooled_resampling_targets_posterior():
    cov = np.asarray([[1.0, 0.6], [0.6, 1.5]], np.float32)
    m = np.asarray([0.5, -1.0], np.float32)
    res = multi_pathfinder(11, _gaussian_target(m, cov), 2, n_paths=4, n_resample=2000, n_iters=30, n_draws=500,
                           device="cpu")
    assert tuple(res.draws.shape) == (2, 2000)
    np.testing.assert_allclose(res.mean().numpy(), m, atol=0.1)
    np.testing.assert_allclose(torch.cov(res.draws).numpy(), cov, atol=0.2)
    assert tuple(res.path_elbos.shape) == (4,)
    # the pooling: draw j of path p is pooled column p * n_draws + j, its
    # ratio beside it, and every resampled draw is a pooled one
    pooled, lw_s, k_hat = port._pool(res.paths)
    logp = res.paths.logp.reshape(-1)
    np.testing.assert_allclose(_gaussian_target(m, cov)(pooled).numpy(), logp.numpy(), rtol=1e-5, atol=1e-5)
    assert bool((res.draws.T[:, None, :] == pooled.T[None]).all(dim=2).any(dim=1).all())
    # the reference test asks k-hat < 0.7 of a Gaussian target, whose pooled
    # ratios are nearly constant, so that the tail fit is undetermined and
    # falls on either side of 0.7 from key to key. What is held instead: the
    # smoothed weights and k-hat are the reference's ``_psis_smooth_column``
    # of the same pooled ratios (1e-5, as the smoothing's own test)
    lw = (res.paths.logp - res.paths.logq).reshape(-1).numpy()
    lw = lw - lw.max()
    ref_lw, ref_k = jax.jit(ref_mc._psis_smooth_column, static_argnums=1)(jnp.asarray(lw), lw.shape[0])
    np.testing.assert_allclose(lw_s.numpy(), np.asarray(ref_lw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(k_hat), float(ref_k), rtol=1e-5, atol=1e-5)
    assert float(res.pareto_k) == float(k_hat)


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 0.5) @ "y"


def test_column_bridge_conjugate():
    post = column_pathfinder(11, conjugate, g.C["y"].set(1.0), (), ["mu"], n_paths=4, n_iters=30, n_resample=2000,
                             device="cpu")
    assert float(post.mean_choices()["mu"]) == pytest.approx(0.8, abs=0.05)
    chms = post.sample_choices(torch.Generator().manual_seed(2), 3000)
    draws = chms.get_submap("mu").get_value()
    assert float(torch.std(draws)) == pytest.approx(np.sqrt(0.2), rel=0.15)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    logp = _gaussian_target(M, COV)
    for call in (lambda: pathfinder(0, logp, 3, n_iters=2),
                 lambda: multi_pathfinder(0, logp, 3, n_paths=2, n_iters=2),
                 lambda: column_pathfinder(0, conjugate, g.C["y"].set(1.0), (), ["mu"], n_iters=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
