"""The Kalman family and ``LinearGaussianSSM`` (``dists/lgssm.py``) against
``genjax_tpu/dists/lgssm.py`` on random stable systems.

Every deterministic function on the same float32 inputs (state dimension 2
and 3, observation dimension 1 and 2, lengths 1 to 17) to rtol 1e-4 (atol
1e-5): ``kalman_update``, ``kalman_filter``, both parallel passes,
``kalman_smoother``, ``_smoother_with_lag1``, ``kalman_predict``,
``path_log_joint``, ``exact_path_log_posterior``, five iterations of
``lgssm_em``; the parallel passes against the sequential ones at every
length, as ``tests/dists/test_parallel_filters.py`` holds the reference's
(rtol 1e-3, atol 1e-5); ``LinearGaussianSSM.assess`` to 1e-5. ``ffbs`` in
law: its draws' mean and sd against the smoothed marginals (4 SE and 10%),
each draw's density the exact posterior's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu.dists.lgssm as ref
import genjax_tpu_torch as g
from genjax_tpu_torch.dists import lgssm as lg
from torch_threads import _one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


def _spd(rng, d, scale):
    m = rng.normal(size=(d, d))
    return (scale * (m @ m.T / d + 0.5 * np.eye(d))).astype(np.float32)


def _system(dz, dy, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(dz, dz))
    A = 0.9 * A / max(1.0, np.abs(np.linalg.eigvals(A)).max())
    arrays = dict(A=A.astype(np.float32), Q=_spd(rng, dz, 0.3), C=rng.normal(size=(dy, dz)).astype(np.float32),
                  R=_spd(rng, dy, 0.2), mu0=rng.normal(size=dz).astype(np.float32), P0=_spd(rng, dz, 0.6))
    return (lg.LGSSMParams(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
            ref.LGSSMParams(**{k: jnp.asarray(v) for k, v in arrays.items()}), rng)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = [got] if isinstance(got, torch.Tensor) else got
    want = [want] if not isinstance(want, (tuple, list)) else want
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


CASES = [(2, 1, 1), (2, 1, 2), (3, 2, 3), (2, 2, 8), (3, 1, 17)]


@pytest.mark.parametrize("dz,dy,T", CASES)
def test_kalman_family_matches_reference(dz, dy, T):
    P, RP, rng = _system(dz, dy, 10 * dz + T)
    ys_np = rng.normal(size=(T, dy)).astype(np.float32)
    ys, rys = torch.from_numpy(ys_np), jnp.asarray(ys_np)
    _close(lg.kalman_update(P.mu0, P.P0, P.C, P.R, ys[0]), jax.jit(ref.kalman_update)(RP.mu0, RP.P0, RP.C, RP.R, rys[0]))
    _close(lg.kalman_filter(P, ys), jax.jit(ref.kalman_filter)(RP, rys))
    _close(lg.kalman_filter_parallel(P, ys), jax.jit(ref.kalman_filter_parallel)(RP, rys))
    _close(lg.kalman_smoother(P, ys), jax.jit(ref.kalman_smoother)(RP, rys))
    _close(lg.kalman_smoother_parallel(P, ys), jax.jit(ref.kalman_smoother_parallel)(RP, rys))
    _close(lg._smoother_with_lag1(P, ys), jax.jit(ref._smoother_with_lag1)(RP, rys))
    _close(lg.kalman_predict(P, ys, 3), jax.jit(ref.kalman_predict, static_argnums=2)(RP, rys, 3))
    zs_np = rng.normal(size=(T, dz)).astype(np.float32)
    zs, rzs = torch.from_numpy(zs_np), jnp.asarray(zs_np)
    _close(lg.path_log_joint(P, zs, ys), jax.jit(ref.path_log_joint)(RP, rzs, rys))
    _close(lg.exact_path_log_posterior(P, zs, ys), jax.jit(ref.exact_path_log_posterior)(RP, rzs, rys))
    score, v = lg.LinearGaussianSSM.assess(g.ChoiceMap.entry(zs), (P, ys))
    want = float(ref.LinearGaussianSSM.assess(ref_chm(rzs), (RP, rys))[0])
    assert abs(float(score) - want) <= 1e-5 * (1 + abs(want)) and v is zs
    _close(lg.LinearGaussianSSM.data_logpdf(P, ys), ref.LinearGaussianSSM.data_logpdf(RP, rys))


def ref_chm(v):
    import genjax_tpu as gj

    return gj.ChoiceMap.entry(v)


@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 37])
def test_parallel_passes_match_sequential_at_every_length(T):
    P, _, rng = _system(2, 1, 0)
    ys = torch.from_numpy(rng.normal(size=(T, 1)).astype(np.float32))
    m_seq, c_seq, _ = lg.kalman_filter(P, ys)
    m_par, c_par = lg.kalman_filter_parallel(P, ys)
    _close((m_par, c_par), (m_seq.numpy(), c_seq.numpy()), rtol=1e-3)
    m_seq, c_seq, _ = lg.kalman_smoother(P, ys)
    m_par, c_par = lg.kalman_smoother_parallel(P, ys)
    _close((m_par, c_par), (m_seq.numpy(), c_seq.numpy()), rtol=1e-3)


def test_em_matches_reference():
    P, RP, rng = _system(2, 1, 5)
    ys_np = rng.normal(size=(30, 1)).astype(np.float32)
    fitted, lms = lg.lgssm_em(P, torch.from_numpy(ys_np), n_iters=5)
    rfitted, rlms = jax.jit(functools.partial(ref.lgssm_em, n_iters=5))(RP, jnp.asarray(ys_np))
    _close(lms, rlms)
    for name in ("A", "Q", "C", "R", "mu0", "P0"):
        _close(getattr(fitted, name), getattr(rfitted, name))
    assert bool((torch.diff(lms) > -1e-3).all())  # EM ascends
    frozen, _ = lg.lgssm_em(P, torch.from_numpy(ys_np), n_iters=2, fit=("A",))
    assert torch.equal(frozen.Q, P.Q) and not torch.equal(frozen.A, P.A)


def test_ffbs_in_law_against_the_smoother():
    P, _, rng = _system(2, 1, 7)
    T, n = 6, 4000
    ys = torch.from_numpy(rng.normal(size=(T, 1)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    zs = torch.func.vmap(lambda _: lg.ffbs(gen, P, ys)[0], randomness="different")(torch.zeros(n))
    means, covs, lm = lg.kalman_smoother(P, ys)
    sd = torch.sqrt(torch.diagonal(covs, dim1=-2, dim2=-1))
    assert float(((zs.mean(0) - means).abs() / (sd / n**0.5)).max()) < 4.0
    assert float((zs.std(0) / sd - 1).abs().max()) < 0.1
    w, draw = lg.LinearGaussianSSM.random_weighted(gen, P, ys)
    assert abs(float(w) - float(lg.exact_path_log_posterior(P, draw, ys))) < 1e-4
    assert tuple(draw.shape) == (T, 2)


def test_scalar_params_and_not_positive_definite_nan():
    p = lg.LGSSMParams.scalar(0.9, 0.5, r=0.3)
    assert tuple(p.A.shape) == (1, 1) and float(p.P0) == pytest.approx(0.5)
    bad = lg.LGSSMParams(p.A, p.Q, p.C, -10.0 * p.R, p.mu0, p.P0)  # S = 0.5 - 3
    _, _, lm = lg.kalman_filter(bad, torch.tensor([[0.0]]))
    assert torch.isnan(lm)
