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
from genjax_tpu_torch.parallel import bnn_logdensity_reference, bnn_param_count
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
D_IN, HIDDEN, M, N = 3, 16, 24, 16
_rng = np.random.default_rng(7)
X = _rng.normal(size=(M, D_IN)).astype(np.float32)
Y = _rng.normal(size=(M,)).astype(np.float32)
Q = (np.random.default_rng(1).normal(size=(HIDDEN * (D_IN + 2), N)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_worlds.run_world(torch_worlds.tensor_parallel_world, 4, tmp_path_factory.mktemp("tp"), X=X, y=Y,
                                  q=Q, hidden=HIDDEN)


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
