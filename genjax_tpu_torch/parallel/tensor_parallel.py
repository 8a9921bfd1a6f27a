"""Tensor parallelism: column log densities with the parameters sharded.

Counterpart of ``genjax_tpu/parallel/tensor_parallel.py``. The positions
``(D, N)`` are split by rows over a model axis (and by chain columns over a
chain axis, where given): each rank computes partial statistics from its own
parameter rows, one differentiable ``all_reduce`` of the stacked partials
over the model axis (``_comm.sum_partials``) assembles them, and a cheap
combine that every rank runs alike gives the log density of each chain. The
gradient each rank holds is that of its own rows.

The flagship is ``tp_bnn_logdensity``: a wide one-hidden-layer Bayesian
neural network whose hidden units are split over the model axis, a step's
collective one ``(M + 1) x N_local`` sum whatever the width.

The density carries its row reduction (``.row_shard``, a ``RowShard``):
the sum of a per-chain partial over the model axis, and the rank's place on
that axis and on the chain axis. The column twins read it
(``kernels/rows.py``), so ``pallas_hmc`` and ``pallas_nuts`` with
``backend="torch"``, ``nuts_sweep_cols``, ``chees_hmc`` and their warmups
sum their kinetic energies, U-turn checks and ChEES criterion over the model
axis and draw the same momenta and uniforms on every model rank of a chain,
as the reference's samplers do over its row-sharded array. The other column
samplers raise on such a density. The data-sharded density (``data.py``),
whose ranks hold whole chains, has no such need.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.utils._pytree as pytree

from . import _comm
from .mesh import Mesh


def shard_params(q: torch.Tensor, mesh: Mesh, model_axis: str = "model", chain_axis: str | None = "batch"):
    """This rank's block of the positions ``(D, N)``, alike on every rank:
    rows split over ``model_axis``, columns over ``chain_axis`` where
    given, on this rank's device."""

    def block(n: int, axis: str | None) -> slice:
        if axis is None:
            return slice(0, n)
        size, idx = mesh.axis_size(axis), mesh.axis_index(axis)
        if n % size:
            raise ValueError(f"{n} does not divide over the {size}-rank {axis!r} axis")
        return slice(idx * (n // size), (idx + 1) * (n // size))

    return q[block(q.shape[0], model_axis), block(q.shape[1], chain_axis)].to(mesh.device)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A row-sharded density's reduction and this rank's place: ``size``
    ranks along ``model_axis``, this rank ``index`` among them, holding row
    block ``rows(d_local)`` of the positions; its columns split over
    ``chain_axis`` where given."""

    mesh: Mesh
    model_axis: str
    chain_axis: str | None
    size: int
    index: int

    def rows(self, d_local: int) -> slice:
        """This rank's rows of the full-height positions."""
        return slice(self.index * d_local, (self.index + 1) * d_local)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """A per-chain partial summed over the model axis: one collective."""
        return _comm.all_reduce_sum(x, self.mesh, self.model_axis)

    @property
    def chain_size(self) -> int:
        return 1 if self.chain_axis is None else self.mesh.axis_size(self.chain_axis)

    @property
    def chain_index(self) -> int:
        return 0 if self.chain_axis is None else self.mesh.axis_index(self.chain_axis)

    def chain_mean(self, x: torch.Tensor) -> torch.Tensor:
        """A rank-local mean over chains made the mean over the chain axis
        (no collective where the axis has one rank)."""
        return x if self.chain_size == 1 else _comm.all_reduce_mean(x, self.mesh, self.chain_axis)


def tensor_parallel_logdensity(
    shard_fn: Callable,
    combine_fn: Callable,
    mesh: Mesh,
    *,
    model_axis: str = "model",
    chain_axis: str | None = "batch",
) -> Callable:
    """A column log density from a rank-local map of partial statistics and
    a combine every rank runs alike:

    ``logdensity(q_block) = combine_fn(sum over model_axis of shard_fn(q_block))``

    ``shard_fn``: ``(D_local, N_local) -> pytree of partials``, from this
    rank's rows alone; the leaves are summed over the model axis in one
    ``all_reduce`` of their concatenation. ``combine_fn``: ``summed pytree
    -> (N_local,)``. Differentiable: the gradient reaching each rank's
    partials is that of the combine, so each rank holds the gradient of its
    own block. ``chain_axis`` names the axis the chain columns are split
    over (checked to be on the mesh). The density carries ``.row_shard``
    (``RowShard``), which the column twins read."""
    mesh.axis_size(model_axis)
    if chain_axis is not None:
        mesh.axis_size(chain_axis)

    def logdensity_cols(q_block):
        leaves, spec = pytree.tree_flatten(shard_fn(q_block))
        flat = _comm.sum_partials(torch.cat([v.reshape(-1) for v in leaves]), mesh, model_axis)
        parts = torch.split(flat, [v.numel() for v in leaves])
        return combine_fn(pytree.tree_unflatten([p.reshape(v.shape) for p, v in zip(parts, leaves)], spec))

    logdensity_cols.row_shard = RowShard(mesh, model_axis, chain_axis, mesh.axis_size(model_axis),
                                         mesh.axis_index(model_axis))
    return logdensity_cols


def bnn_param_count(d_in: int, hidden: int) -> int:
    """The parameter rows of ``tp_bnn_logdensity``'s layout: ``hidden``
    units of ``d_in`` input weights, a bias and an output weight."""
    return hidden * (d_in + 2)


def _bnn_parts(X, y, hidden: int, obs_scale: float, weight_scale: float, device):
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    return X, y, 1.0 / math.sqrt(hidden), 1.0 / (weight_scale * weight_scale), 1.0 / (obs_scale * obs_scale)


def _bnn_out(q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``sum_j w2_j tanh(W1_j x + b1_j)`` over the units of ``q``'s rows,
    ``(N, M)``: one ``(H N, d_in) @ (d_in, M)`` product."""
    d_in = X.shape[1]
    h, n = q.shape[0] // (d_in + 2), q.shape[1]
    u = q.reshape(h, d_in + 2, n)
    w1, b1, w2 = u[:, :d_in, :], u[:, d_in, :], u[:, d_in + 1, :]
    pre = (w1.permute(0, 2, 1).reshape(h * n, d_in) @ X.T).reshape(h, n, -1)
    act = torch.tanh(pre + b1[:, :, None])
    return torch.einsum("hn,hnm->nm", w2, act)


def tp_bnn_logdensity(
    X,
    y,
    hidden: int,
    mesh: Mesh,
    *,
    model_axis: str = "model",
    chain_axis: str | None = "batch",
    obs_scale: float = 0.5,
    weight_scale: float = 1.0,
) -> Callable:
    """The column log density of a wide one-hidden-layer Bayesian neural
    network, the hidden units split over ``model_axis``:

        W1, b1, w2 ~ N(0, weight_scale^2)
        f(x) = (1 / sqrt(hidden)) sum_j w2_j tanh(W1_j x + b1_j)
        y_m ~ N(f(x_m), obs_scale^2)

    Unit ``j`` owns rows ``[j (d_in + 2), (j + 1) (d_in + 2))``: its input
    weights, bias and output weight, so an even split of the rows is an
    even split of the units; ``hidden`` must divide over the model axis.
    ``bnn_param_count`` gives ``D``, ``shard_params`` a rank's block."""
    m_size = mesh.axis_size(model_axis)
    if hidden % m_size:
        raise ValueError(f"hidden={hidden} is not divisible by the '{model_axis}' mesh size {m_size}")
    X, y, out_scale, inv_w2, inv_o2 = _bnn_parts(X, y, hidden, obs_scale, weight_scale, mesh.device)

    def shard_fn(q_block):
        # the network's partial first, then the prior's: the unsharded twin's
        # order, so that autograd sums a row's gradient terms in its order
        out = _bnn_out(q_block, X)
        prior = -0.5 * inv_w2 * torch.sum(q_block * q_block, dim=0, keepdim=True)  # (1, N)
        return {"out": out, "prior": prior}

    def combine_fn(summed):
        resid = y[None, :] - out_scale * summed["out"]
        return summed["prior"][0] - 0.5 * inv_o2 * torch.sum(resid * resid, dim=1)

    return tensor_parallel_logdensity(shard_fn, combine_fn, mesh, model_axis=model_axis, chain_axis=chain_axis)


def bnn_logdensity_reference(X, y, hidden: int, *, obs_scale: float = 0.5, weight_scale: float = 1.0,
                             device=None) -> Callable:
    """The unsharded twin of ``tp_bnn_logdensity`` (the same layout and
    arithmetic on one device): the one-card path, and the oracle the sharded
    one is held to. ``device`` defaults to ``X``'s."""
    device = X.device if device is None and isinstance(X, torch.Tensor) else device
    X, y, out_scale, inv_w2, inv_o2 = _bnn_parts(X, y, hidden, obs_scale, weight_scale, device)

    def logdensity_cols(q):
        resid = y[None, :] - out_scale * _bnn_out(q, X)
        return -0.5 * inv_w2 * torch.sum(q * q, dim=0) - 0.5 * inv_o2 * torch.sum(resid * resid, dim=1)

    return logdensity_cols
