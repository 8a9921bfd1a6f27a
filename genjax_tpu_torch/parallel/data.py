"""Data-axis sharding: the log density of a large dataset over a 2-D
(chains x data) mesh.

Counterpart of ``genjax_tpu/parallel/data.py``. A factorised posterior

    log p(q | x_1..M) = log p(q) + sum_i log p(x_i | q)        (+ const)

has its work in the likelihood sum, which splits over the data. Each rank
keeps its shard of the data on its device, and the sum is one differentiable
``all_reduce`` over the data axis (``_comm.sum_partials``): the reference's
``shard_map`` with one ``lax.psum``. The positions every rank of the data
axis holds alike enter through ``_comm.replicated``, so that the gradient
each rank holds is the gradient of the whole sum.

The result is a column log density ``(D, N_local) -> (N_local,)`` over this
rank's chain columns (the chains optionally sharded over the chain axis,
``shard_batch``), for the column samplers' plain twins
(``pallas_hmc(..., backend="torch")``): the CUDA kernels take a device body,
which a collective cannot be part of, so ``backend="auto"`` on the card
raises for it as for any density without a body.
"""

from __future__ import annotations

from typing import Any, Callable

import torch.utils._pytree as pytree

from . import _comm
from .mesh import Mesh, _mesh, _world, shard_batch


def make_mesh_2d(
    shape: tuple[int, int] | None = None,
    axes: tuple[str, str] = ("batch", "data"),
    *,
    device="cuda",
) -> Mesh:
    """A 2-D mesh ``axes = (chain_axis, data_axis)`` over the world's ranks.
    The default shape puts every rank on the data axis, ``(1, world)``:
    chains replicated, data spread, for when the dataset and not the chain
    count is what exceeds one card."""
    world, device = _world("make_mesh_2d", device)
    if shape is None:
        shape = (1, world)
    n = shape[0] * shape[1]
    if n > world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices but only {world} are available")
    if n < world:
        raise ValueError(f"mesh shape {tuple(shape)}: a mesh spans every rank of the world ({world})")
    return _mesh(device, tuple(shape), tuple(axes))


def shard_data(tree: Any, mesh: Mesh, data_axis: str = "data") -> Any:
    """This rank's shard of every leaf's leading (data) axis, on its
    device (replicated over every other mesh axis)."""
    return shard_batch(tree, mesh, data_axis)


def data_sharded_logdensity(
    log_prior: Callable,
    log_lik: Callable,
    data: Any,
    mesh: Mesh,
    *,
    chain_axis: str | None = "batch",
    data_axis: str = "data",
) -> Callable:
    """A column log density ``(D, N_local) -> (N_local,)`` whose likelihood
    is evaluated on this rank's data shard and summed over ``data_axis``.

    Args:
        log_prior: a columns function ``(D, N) -> (N,)``, evaluated once a
            chain (outside the data sum).
        log_lik: ``(q_block (D, N), data_shard) -> (N,)``, the summed
            log likelihood of one shard for each chain column.
        data: the whole dataset, alike on every rank, each leaf's data
            dimension leading and divisible by the ``data_axis`` size (pad
            with zero-weight rows otherwise); each rank keeps its shard on
            its device.
        mesh: a mesh with ``data_axis`` (and ``chain_axis`` where given:
            ``make_mesh_2d``).
        chain_axis: the axis the chain columns are sharded over, or None
            where every rank holds every chain.

    Every rank of the mesh calls the returned function alike; it is
    differentiable (one ``all_reduce`` over the data axis forward, one
    backward).
    """
    d_size = mesh.axis_size(data_axis)
    if chain_axis is not None:
        mesh.axis_size(chain_axis)  # the mesh must carry it
    for leaf in pytree.tree_leaves(data):
        if leaf.shape[0] % d_size:
            raise ValueError(
                f"data leading axis {leaf.shape[0]} is not divisible by the '{data_axis}' mesh size "
                f"{d_size}; pad the dataset (with zero-weight rows) to a multiple"
            )
    shard = shard_data(data, mesh, data_axis)

    def logdensity_cols(q):
        lik = log_lik(_comm.replicated(q, mesh, data_axis), shard)
        return log_prior(q) + _comm.sum_partials(lik, mesh, data_axis)

    # the mesh axis its sum runs over, which no device body can reduce
    # (kernels/staged.py refuses the density by it)
    logdensity_cols.collective_axis = data_axis
    return logdensity_cols


def minibatch_logdensity(
    log_prior: Callable,
    log_lik: Callable,
    data: Any,
    n_total: int,
    *,
    scale: bool = True,
) -> Callable:
    """The unsharded companion: a stochastic-gradient surrogate from one
    minibatch, its likelihood scaled by ``n_total / batch`` so that its
    gradient is an unbiased estimate of the full-data gradient (SGLD and
    SGHMC)."""
    batch = pytree.tree_leaves(data)[0].shape[0]
    factor = (n_total / batch) if scale else 1.0

    def logdensity_cols(q):
        return log_prior(q) + factor * log_lik(q, data)

    return logdensity_cols
