"""The port's tensor-parallel log densities (``genjax_tpu_torch/parallel/
tensor_parallel.py``) against ``genjax_tpu/parallel/tensor_parallel.py``
and the reference's ``tests/parallel/test_tensor_parallel.py``.

One spawned gloo world of 4 ranks (``torch_worlds.tensor_parallel_world``)
evaluates ``tp_bnn_logdensity`` on ``(model, batch)`` meshes ``(2, 2)``,
``(4, 1)`` and ``(1, 4)``: values and gradients agree with the reference's
``tp_bnn_logdensity`` on 4 of the forced CPU devices and with
``bnn_logdensity_reference`` to 1e-5, as does a generic
``tensor_parallel_logdensity``. ``bnn_param_count`` and the unsharded twin
need no ranks and run here.

The same world samples the row-sharded density (the reference's
``test_hmc_sweep_matches_unsharded`` and ``test_posterior_moves_toward_data``):
the HMC twin on ``(4, 1)`` equals the unsharded twin on the same seed, and
on ``(2, 2)`` each chain block equals the unsharded twin on that block with
its stream seed; the NUTS twin, ChEES and the HMC warmup on ``(4, 1)`` equal
their unsharded runs; the sweep's collectives are counted; and the samplers
that do not reduce over the model axis refuse the density.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_worlds
from genjax_tpu.parallel import bnn_logdensity_reference as ref_bnn
from genjax_tpu.parallel import bnn_param_count as ref_count
from genjax_tpu.parallel import make_mesh_2d as ref_mesh_2d
from genjax_tpu.parallel import shard_params as ref_shard_params
from genjax_tpu.parallel import tp_bnn_logdensity as ref_tp_bnn
from genjax_tpu_torch.core.device import stream_seed
from genjax_tpu_torch.kernels import chees_hmc, nuts_sweep_cols, pallas_hmc, warmup_column
from genjax_tpu_torch.parallel import bnn_logdensity_reference, bnn_param_count
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
D_IN, HIDDEN, M, N = 3, 16, 24, 16
_rng = np.random.default_rng(7)
X = _rng.normal(size=(M, D_IN)).astype(np.float32)
Y = _rng.normal(size=(M,)).astype(np.float32)
Q = (np.random.default_rng(1).normal(size=(HIDDEN * (D_IN + 2), N)) * 0.3).astype(np.float32)
Q_FAR = (np.random.default_rng(5).normal(size=(HIDDEN * (D_IN + 2), N)) * 0.3 * 13.0).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_worlds.run_world(torch_worlds.tensor_parallel_world, 4, tmp_path_factory.mktemp("tp"), X=X, y=Y,
                                  q=Q, hidden=HIDDEN, q_far=Q_FAR)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=tol)


def _reference(shape):
    mesh = ref_mesh_2d(shape, axes=("model", "batch"), devices=jax.devices()[:4])
    ld = ref_tp_bnn(X, Y, HIDDEN, mesh)
    q = ref_shard_params(jnp.asarray(Q), mesh)
    vals, grad = jax.jit(lambda qq: (ld(qq), jax.grad(lambda x: jnp.sum(ld(x)))(qq)))(q)
    return np.asarray(vals), np.asarray(grad)


@functools.cache
def _unsharded():
    ld = ref_bnn(X, Y, HIDDEN)
    q = jnp.asarray(Q)
    return np.asarray(ld(q)), np.asarray(jax.grad(lambda qq: jnp.sum(ld(qq)))(q))


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_tp_bnn_value_and_gradient_match_the_reference(world, shape):
    val, grad = world[shape]
    ref_val, ref_grad = _reference(shape)
    _close(val, ref_val)
    _close(grad, ref_grad)
    dense_val, dense_grad = _unsharded()
    _close(val, dense_val)
    _close(grad, dense_grad)


def test_generic_tensor_parallel_logdensity(world):
    val, grad = world["generic"]
    q = torch.from_numpy(Q).requires_grad_(True)
    want = -0.5 * torch.sum(q * q, dim=0) + 0.1 * torch.sum(q, dim=0)
    (want_grad,) = torch.autograd.grad(want.sum(), q)
    _close(val, want.detach().numpy())
    _close(grad, want_grad.numpy())


def test_indivisible_hidden_raises_the_references_message(world):
    mesh = ref_mesh_2d((4, 1), axes=("model", "batch"), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="not divisible") as info:
        ref_tp_bnn(X, Y, HIDDEN + 2, mesh)
    assert world["indivisible"] == str(info.value)


@pytest.mark.parametrize("d_in,hidden", [(3, 16), (1, 1), (8, 128)])
def test_bnn_param_count(d_in, hidden):
    assert bnn_param_count(d_in, hidden) == ref_count(d_in, hidden) == hidden * (d_in + 2)


def test_the_unsharded_twin_matches_the_reference():
    ld = bnn_logdensity_reference(torch.from_numpy(X), torch.from_numpy(Y), HIDDEN)
    q = torch.from_numpy(Q).requires_grad_(True)
    val = ld(q)
    (grad,) = torch.autograd.grad(val.sum(), q)
    ref_val, ref_grad = _unsharded()
    _close(val.detach().numpy(), ref_val)
    _close(grad.numpy(), ref_grad)


def _twin_density():
    return bnn_logdensity_reference(torch.from_numpy(X), torch.from_numpy(Y), HIDDEN)


def test_hmc_sweep_matches_unsharded_on_a_model_axis(world):
    """The reference's test_hmc_sweep_matches_unsharded: three sweeps through
    the row-sharded density on (4, 1) reproduce the unsharded twin on the
    same seed, positions to 1e-4 and accept to 1e-6."""
    q, acc = world[("hmc", (4, 1))]
    q_ref, acc_ref = pallas_hmc(_twin_density(), torch.from_numpy(Q), 11, n_steps=3, eps=0.01, L=3, backend="torch")
    assert float(acc_ref) > 0.0
    np.testing.assert_allclose(acc, float(acc_ref), atol=1e-6)
    np.testing.assert_allclose(q, q_ref.numpy(), rtol=1e-4, atol=1e-4)


def test_hmc_sweep_matches_unsharded_block_by_block(world):
    """On (2, 2) each chain block is the unsharded twin run on that block
    with the block's stream seed; the accept rate is the mean over both."""
    q, acc = world[("hmc", (2, 2))]
    half = N // 2
    accs = []
    for c in range(2):
        cols = slice(c * half, (c + 1) * half)
        q_ref, acc_ref = pallas_hmc(_twin_density(), torch.from_numpy(Q[:, cols]), stream_seed(11, c), n_steps=3,
                                    eps=0.01, L=3, backend="torch")
        np.testing.assert_allclose(q[:, cols], q_ref.numpy(), rtol=1e-4, atol=1e-4)
        accs.append(float(acc_ref))
    np.testing.assert_allclose(acc, np.mean(accs), atol=1e-6)


def test_posterior_moves_toward_data(world):
    """The reference's test_posterior_moves_toward_data: from 13 times the
    start, 25 sweeps accept more than a fifth of the time and raise the mean
    log density."""
    lp0, lp1, acc = world["climb"]
    assert acc > 0.2
    assert lp1 > lp0


def test_nuts_twin_matches_unsharded(world):
    q, acc, leaps = world["nuts"]
    q_ref, acc_ref, leaps_ref = nuts_sweep_cols(_twin_density(), torch.from_numpy(Q), 5, n_steps=2, eps=0.05,
                                                max_depth=4)
    np.testing.assert_allclose(q, q_ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(acc, float(acc_ref), atol=1e-5)
    assert leaps == float(leaps_ref)


def test_chees_matches_unsharded(world):
    q, eps, t, acc = world["chees"]
    q_ref, info = chees_hmc(_twin_density(), torch.from_numpy(Q), 6, n_warmup=6, n_steps=3, eps0=0.05)
    np.testing.assert_allclose(q, q_ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose([eps, t, acc], [float(info.eps), float(info.trajectory_length),
                                               float(info.accept_rate)], rtol=1e-4, atol=1e-5)


def test_hmc_warmup_matches_unsharded(world):
    q, eps, inv_mass = world["warmup"]
    q_ref, eps_ref, inv_ref = warmup_column(_twin_density(), torch.from_numpy(Q), 7, n_phases=2, steps_per_phase=3,
                                            eps0=0.05, L=3, backend="torch")
    np.testing.assert_allclose(q, q_ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(eps, eps_ref, rtol=1e-5)
    np.testing.assert_allclose(inv_mass, inv_ref.numpy(), rtol=1e-4, atol=1e-6)


def test_hmc_sweep_collectives_are_the_kinetic_energies_and_the_densitys(world):
    """Three sweeps of L = 3: the density's one (M + 1) x N sum an evaluation
    (1 + 3 x 3) and one N-float sum a kinetic energy (two a sweep), all over
    the model axis; a chain axis of one rank adds none."""
    ops = {(op["group"], op["bytes"]): op["calls"] for op in world["hmc_audit"]["ops"]}
    assert ops == {("model", 4 * (M + 1) * N): 10, ("model", 4 * N): 6}


@pytest.mark.parametrize("name", ["pt_hmc", "svgd"])
def test_untaught_samplers_refuse_a_row_sharded_density(world, name):
    msg = world["refusals"][name]
    assert msg is not None and msg.startswith(f"{name} does not sample a row-sharded density")
    assert "'model'" in msg
