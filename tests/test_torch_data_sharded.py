"""The port's data-sharded log density (``genjax_tpu_torch/parallel/
data.py``) against ``genjax_tpu/parallel/data.py`` and the reference's
``tests/parallel/test_data_sharded.py``.

One spawned gloo world of 4 ranks (``torch_worlds.data_world``) evaluates
the logistic-regression density of the reference's test on ``(chains,
data)`` meshes ``(2, 2)`` and ``(1, 4)`` and with the chains replicated:
values and gradients agree with the reference's on the same numpy inputs
(4 of the forced CPU devices) and with the dense density to 1e-5. The
conjugate Gaussian mean, data 2-way and chains 2-way, runs through the
column HMC twin (``pallas_hmc(backend="torch")``, 100 sweeps where the
reference runs 300) and is held in law at the reference's tolerances (mean
within 0.03, variance within 25%).
``minibatch_logdensity`` needs no ranks and runs here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_worlds
from genjax_tpu.parallel import data_sharded_logdensity as ref_data_sharded
from genjax_tpu.parallel import make_mesh_2d as ref_mesh_2d
from genjax_tpu.parallel import minibatch_logdensity as ref_minibatch
from genjax_tpu.parallel import shard_data as ref_shard_data
from genjax_tpu_torch.parallel import minibatch_logdensity
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
D_REAL, M_DATA = 3, 64
_rng = np.random.RandomState(0)
X = _rng.randn(M_DATA, D_REAL).astype(np.float32)
W_TRUE = np.asarray([1.0, -2.0, 0.5], np.float32)
Y = (_rng.rand(M_DATA) < 1.0 / (1.0 + np.exp(-(X @ W_TRUE)))).astype(np.float32)
Q = _rng.randn(8, 16).astype(np.float32)
OBS = np.asarray(_rng.randn(40) * 0.7 + 1.3, np.float32)
Q0 = _rng.randn(8, 512).astype(np.float32)
SIGMA = 0.7


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_worlds.run_world(torch_worlds.data_world, 4, tmp_path_factory.mktemp("data"), X=X, Y=Y, q=Q,
                                  obs=OBS, q0=Q0)


def ref_log_prior(q):
    return -0.5 * jnp.sum(q**2, axis=0)


def ref_log_lik(q, shard):
    x, y = shard
    logits = x @ q[:D_REAL]
    return jnp.sum(y[:, None] * jax.nn.log_sigmoid(logits) + (1.0 - y[:, None]) * jax.nn.log_sigmoid(-logits),
                   axis=0)


def _reference(shape, chain_axis="batch"):
    mesh = ref_mesh_2d(shape, devices=jax.devices()[:4])
    data = ref_shard_data((jnp.asarray(X), jnp.asarray(Y)), mesh)
    ld = ref_data_sharded(ref_log_prior, ref_log_lik, data, mesh, chain_axis=chain_axis)
    vals, grad = jax.jit(lambda qq: (ld(qq), jax.grad(lambda x: jnp.sum(ld(x)))(qq)))(jnp.asarray(Q))
    return np.asarray(vals), np.asarray(grad)


@functools.cache
def _dense():
    def ld(q):
        return ref_log_prior(q) + ref_log_lik(q, (jnp.asarray(X), jnp.asarray(Y)))

    q = jnp.asarray(Q)
    return np.asarray(ld(q)), np.asarray(jax.grad(lambda qq: jnp.sum(ld(qq)))(q))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_value_and_gradient_match_the_reference(world, shape):
    val, grad = world[shape]
    ref_val, ref_grad = _reference(shape)
    _close(val, ref_val)
    _close(grad, ref_grad)
    dense_val, dense_grad = _dense()
    _close(val, dense_val)
    _close(grad, dense_grad)


def test_replicated_chains_value_and_gradient(world):
    """``chain_axis=None``: every rank holds every chain, and the gradient
    each holds is the whole sum's (the replicated positions' cotangents
    summed over the data axis)."""
    val, grad = world["replicated_chains"]
    ref_val, ref_grad = _reference((1, 4), chain_axis=None)
    _close(val, ref_val)
    _close(grad, ref_grad)


def test_indivisible_data_raises_the_references_message(world):
    mesh = ref_mesh_2d((1, 4), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="divisible") as info:
        ref_data_sharded(ref_log_prior, ref_log_lik, (jnp.zeros((13, D_REAL)), jnp.zeros((13,))), mesh)
    assert world["indivisible"] == str(info.value)


def test_conjugate_posterior_through_the_column_hmc_twin(world):
    draws, accept = world["hmc"]
    v_post = 1.0 / (1.0 + len(OBS) / SIGMA**2)
    m_post = v_post * OBS.sum() / SIGMA**2
    assert draws.shape == (512,)
    assert accept > 0.6
    np.testing.assert_allclose(draws.mean(), m_post, atol=0.03)
    np.testing.assert_allclose(draws.var(), v_post, rtol=0.25, atol=5e-3)


@pytest.mark.parametrize("scale", [True, False])
def test_minibatch_logdensity_matches_the_reference(scale):
    batch = slice(0, 16)

    def t_prior(q):
        return -0.5 * torch.sum(q**2, dim=0)

    def t_lik(q, shard):
        x, y = shard
        logits = x @ q[:D_REAL]
        return torch.sum(y[:, None] * torch.nn.functional.logsigmoid(logits)
                         + (1.0 - y[:, None]) * torch.nn.functional.logsigmoid(-logits), dim=0)

    ld = minibatch_logdensity(t_prior, t_lik, (torch.from_numpy(X[batch]), torch.from_numpy(Y[batch])), M_DATA,
                              scale=scale)
    ref = ref_minibatch(ref_log_prior, ref_log_lik, (jnp.asarray(X[batch]), jnp.asarray(Y[batch])), M_DATA,
                        scale=scale)
    _close(ld(torch.from_numpy(Q)).numpy(), np.asarray(ref(jnp.asarray(Q))))
