"""``jax.random.gamma`` and the samplers that rest on it, draw for draw.

``core/keys.py``'s ``gamma`` (and ``loggamma``), ``beta``, ``dirichlet``,
``chisquare`` and ``t`` against ``jax.random``'s from the same key. The
tolerance: at least 99% of the elements within rtol 1e-6 of the reference's
(XLA's float32 ``log``, ``log1p`` and ``pow`` differ from torch's by an ulp
on a few percent of inputs). A log-gamma near 0 is held to 1e-6 absolute
there, that is 1e-6 relative on the gamma draw it is the log of:
``|got - want| <= 1e-6 max(1, |want|)``. Under ``torch.func.vmap`` over keys
the sampler's collective loops give each lane its own draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu_torch.core import keys
from torch_threads import _one_thread  # noqa: F401

RTOL = 1e-6
SHARE = 0.99
SIZE = 2000


def _share_within(got, want, floor=0.0):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want), floor)
    return float(((np.abs(got - want) <= RTOL * scale) | (got == want)).mean())


@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("alpha", [1e-3, 0.3, 1.0, 3.7, 50.0])
def test_gamma_and_loggamma(alpha, log_space):
    fn = jax.random.loggamma if log_space else jax.random.gamma
    want = fn(jax.random.key(7), alpha, (SIZE,))
    got = keys.gamma(keys.key(7, device="cpu"), alpha, (SIZE,), log_space=log_space)
    assert _share_within(got, want, 1.0 if log_space else 0.0) >= SHARE
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("alpha", [0.3, 3.7])
def test_gamma_under_an_rbg_key(alpha):
    want = jax.random.gamma(jax.random.key(2, impl="rbg"), alpha, (SIZE,))
    got = keys.gamma(keys.key(2, device="cpu", impl="rbg"), alpha, (SIZE,))
    assert _share_within(got, want) >= SHARE


def test_gamma_broadcasts_its_concentration():
    a = torch.tensor([[0.5], [2.0]])
    got = keys.gamma(keys.key(3, device="cpu"), a, (2, 3))
    want = jax.random.gamma(jax.random.key(3), jnp.asarray([[0.5], [2.0]]), (2, 3))
    assert _share_within(got, want) == 1.0
    assert tuple(keys.gamma(keys.key(3, device="cpu"), 2.0).shape) == ()


@pytest.mark.parametrize("name", ["beta", "dirichlet", "chisquare", "t"])
def test_the_samplers_on_gamma(name):
    k, jk = keys.key(5, device="cpu"), jax.random.key(5)
    if name == "beta":
        got, want = keys.beta(k, 0.5, 2.0, (SIZE,)), jax.random.beta(jk, 0.5, 2.0, (SIZE,))
    elif name == "dirichlet":
        alpha = [0.2, 1.0, 3.0]
        got, want = keys.dirichlet(k, torch.tensor(alpha), (SIZE // 3,)), jax.random.dirichlet(jk, jnp.asarray(alpha),
                                                                                              (SIZE // 3,))
    elif name == "chisquare":
        got, want = keys.chisquare(k, 3.0, (SIZE,)), jax.random.chisquare(jk, 3.0, (SIZE,))
    else:
        got, want = keys.t(k, 4.0, (SIZE,)), jax.random.t(jk, 4.0, (SIZE,))
    assert _share_within(got, want) >= SHARE


def test_gamma_under_vmap_draws_each_lane_its_own():
    ks = keys.split(keys.key(9, device="cpu"), 6)
    alpha = torch.linspace(0.2, 3.0, 6)
    batched = torch.func.vmap(lambda k, a: keys.gamma(k, a, (5,)))(ks, alpha)
    looped = torch.stack([keys.gamma(ks[i], alpha[i], (5,)) for i in range(6)])
    assert torch.equal(batched, looped)
