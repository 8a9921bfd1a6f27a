"""``sample_posterior``'s column algorithms and ``sample_logdensity`` under a
key, draw for draw against ``genjax_tpu``.

The reference's driver splits its key per algorithm: ChEES and PT
``k_init, k_run = split(key)``, the dense algorithms ``split(key, 3)``, the
chains from ``split(k_init, n_chains)``; dense NUTS sweeps the white space on
the rbg streams of ``randint(fold_in(k_warm, 7), (), 0, 2**11)`` and
``randint(fold_in(k_run, 7), (), 0, 2**30)``. The port splits and draws
alike. Tolerances: draws within 1e-4 for at least the stated share of chains,
the adapted ``eps`` to rtol 1e-5, ``inv_mass`` and the accept rate to rtol
1e-4, split-R-hat and ESS to rtol 1e-4 where every chain agrees.
"""

import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.core import keys
from genjax_tpu_torch.inference import sample_logdensity, sample_posterior
from torch_threads import _one_thread  # noqa: F401


def jr():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax.random


def agree(a, b, share, tol=1e-4):
    """At least ``share`` of the chains (the first axis) within ``tol``."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    ok = (np.abs(a - b) <= tol).reshape(a.shape[0], -1).all(axis=1)
    assert ok.mean() >= share, f"{ok.mean():.4f} of chains within {tol}"


def close(a, b, tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=1e-6)


def _linear():
    import genjax_tpu as gj
    from genjax_tpu.models import linear_regression as ref_linear
    from genjax_tpu_torch.models import linear_regression

    X = np.random.default_rng(3).normal(size=(6, 2)).astype(np.float32)
    y = np.random.default_rng(4).normal(size=(6,)).astype(np.float32)
    (model, _), (model_ref, _) = linear_regression(torch.from_numpy(X)), ref_linear(X)
    return model, g.C["y"].set(torch.from_numpy(y)), model_ref, gj.C["y"].set(y)


# dense NUTS whitens with the dense warmup's Cholesky factor (its metric's
# diagonal 1.7e-4 relative apart, from four one-transition phases of 32
# chains), and the white-space NUTS step size comes out 3e-5 relative apart
# (XLA's and torch's float32 triangular solve and products): one of the 32
# chains moved by it (measured), so its share is 0.95, its inv_mass is held
# to 1e-3 and its diagnostics to 1e-2
CASES = [
    ("chees", dict(), 1.0, 1e-4),
    ("pt", dict(L=3, n_rungs=3), 1.0, 1e-4),
    ("dense_hmc", dict(L=3), 1.0, 1e-4),
    ("dense_nuts", dict(max_depth=3), 0.95, 1e-2),
]


@pytest.mark.parametrize("algorithm,budget,share,diag_tol", CASES, ids=[c[0] for c in CASES])
def test_the_column_algorithms_under_a_key_draw_for_draw(algorithm, budget, share, diag_tol):
    """32 chains, 8 warmup transitions, 4 draws, under ``key(0)``."""
    import genjax_tpu as gj
    from genjax_tpu.inference import sample_posterior as ref_sample_posterior

    model, obs, model_ref, obs_ref = _linear()
    kw = dict(n_chains=32, n_warmup=8, n_samples=4, algorithm=algorithm, eps0=0.1, **budget)
    res = sample_posterior(keys.key(0, device="cpu"), model, obs, (), g.S["w"], device="cpu", **kw)
    want = ref_sample_posterior(jr().key(0), model_ref, obs_ref, (), gj.S["w"], **kw)
    assert tuple(res["w"].shape) == (32, 4, 2)
    agree(res["w"], want["w"], share)
    close(res.eps, want.eps, 1e-5 if share == 1.0 else 1e-4)
    close(res.inv_mass, want.inv_mass, 1e-4 if share == 1.0 else 1e-3)
    close(res.accept_rate, want.accept_rate, 1e-4 if share == 1.0 else 1e-2)
    close(res.rhat_of("w"), want.rhat_of("w"), diag_tol)
    close(res.ess_of("w"), want.ess_of("w"), diag_tol)


def test_a_generator_still_draws_the_column_algorithms_in_law():
    """A generator (or an int seeding one) draws its own stream: the same
    seed repeats, and it is not ``key(0)``'s."""
    model, obs, _m, _o = _linear()
    kw = dict(n_chains=16, n_warmup=4, n_samples=3, algorithm="chees", eps0=0.1, device="cpu")
    a = sample_posterior(0, model, obs, (), g.S["w"], **kw)
    b = sample_posterior(torch.Generator().manual_seed(0), model, obs, (), g.S["w"], **kw)
    c = sample_posterior(keys.key(0, device="cpu"), model, obs, (), g.S["w"], **kw)
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])


def test_sample_logdensity_under_a_key_draw_for_draw():
    """ChEES on a raw density from the same start, under ``key(1)`` (and an
    int, ``chees_hmc``'s ``key(seed, "rbg")``)."""
    import jax.numpy as jnp

    from genjax_tpu.inference import sample_logdensity as ref_sample_logdensity

    scales = np.asarray([0.3, 1.0, 2.0], np.float32)
    q0 = np.random.default_rng(5).normal(size=(3, 64)).astype(np.float32)

    def t_ld(q):
        return -0.5 * torch.sum((q / torch.from_numpy(scales)[:, None]) ** 2, 0)

    def j_ld(q):
        return -0.5 * jnp.sum((q / scales[:, None]) ** 2, 0)

    kw = dict(n_warmup=10, n_samples=5)
    for tk, rk in ((keys.key(1, device="cpu"), jr().key(1)), (7, 7)):
        res = sample_logdensity(tk, t_ld, torch.from_numpy(q0), **kw)
        want = ref_sample_logdensity(rk, j_ld, q0, **kw)
        agree(res.draws, want.draws, 1.0)
        close(res.eps, want.eps, 1e-5)
        close(res.rhat, want.rhat, 1e-4)
        close(res.ess, want.ess, 1e-4)
