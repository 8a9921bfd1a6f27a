"""The collectives of the scale-out layer: the one place the port issues one.

The reference runs one program over many devices (``shard_map``) and names
its collectives ``lax.psum``, ``lax.pmax`` and ``lax.all_gather`` over a mesh
axis; XLA adds more where a reduction runs over a sharded axis. The port runs
one process a rank on a ``torch.distributed`` process group, every rank the
same program, and every reduction over a sharded chain or particle axis is a
call here, over the process group of one dimension of a mesh
(``parallel.mesh.Mesh``). A world of one rank runs the same calls.

Every call appends a ``Collective`` record to each active log
(``collective_log``), which ``parallel.audit.collective_counts`` summarises:
the port's counterpart of the reference's audit of compiled HLO, built from
the calls issued.

The two differentiable forms are the transposes JAX gives ``psum`` in a
``shard_map``: ``sum_partials`` sums a partial statistic into a value every
rank holds alike (its backward passes the cotangent through, since every rank
holds the same cotangent of a replicated value), and ``replicated`` marks a
value every rank holds alike as the input of rank-local work (its backward
sums the rank-local cotangents, as the transpose of a broadcast does).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

_LOGS: list[list] = []
_STEPS: list = [None]


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as issued: the operation, the mesh dimension, the
    shape and dtype of this rank's operand, the ranks on the dimension, and
    the driver step that issued it (None outside a step loop)."""

    op: str
    axis: str
    shape: tuple
    dtype: torch.dtype
    span: int
    step: int | None


@contextlib.contextmanager
def collective_log():
    """Record every collective issued inside the block, on this rank, into
    the list it yields.

    >>> from genjax_tpu_torch.parallel import collective_log
    >>> with collective_log() as log:
    ...     pass
    >>> log
    []
    """
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


@contextlib.contextmanager
def step(t: int):
    """Mark the collectives issued inside the block as those of driver step
    ``t`` (the reference audit's ``per_step``)."""
    _STEPS.append(int(t))
    try:
        yield
    finally:
        _STEPS.pop()


def _record(op: str, mesh, axis: str, x: torch.Tensor) -> None:
    if _LOGS:
        rec = Collective(op, axis, tuple(x.shape), x.dtype, axis_size(mesh, axis), _STEPS[-1])
        for log in _LOGS:
            log.append(rec)


def axis_size(mesh, axis: str) -> int:
    """The ranks along ``axis`` of ``mesh`` (the reference's
    ``lax.axis_size``)."""
    return mesh.device_mesh.size(mesh.axis_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.device_mesh.get_local_rank(axis)


def _group(mesh, axis: str):
    return mesh.device_mesh.get_group(axis)


def _reduce(x: torch.Tensor, mesh, axis: str, op, name: str) -> torch.Tensor:
    _record(name, mesh, axis, x)
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=_group(mesh, axis))
    return out


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis`` (``lax.psum``), on
    every rank; ``x`` is left as it was."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM, "all_reduce_sum")


def all_reduce_max(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum over the ranks along ``axis``
    (``lax.pmax``)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX, "all_reduce_max")


def all_reduce_mean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean over the ranks along ``axis`` of a rank-local mean over
    equal shards: the global mean."""
    return all_reduce_sum(x, mesh, axis) / axis_size(mesh, axis)


def all_gather_cat(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on the leading axis, in
    rank order (``lax.all_gather`` then a reshape); a 0-d ``x`` gives a
    vector."""
    _record("all_gather", mesh, axis, x)
    x = x.detach().contiguous()
    x1 = x.reshape((1,) + tuple(x.shape)) if x.dim() == 0 else x
    parts = [torch.empty_like(x1) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x1, group=_group(mesh, axis))
    return torch.cat(parts, dim=0)


def barrier() -> None:
    """Wait for every rank of the world."""
    dist.barrier()


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axis):
        return all_reduce_sum(x, mesh, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, axis):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh, ctx.axis), None, None


def sum_partials(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The differentiable ``all_reduce_sum`` of rank-local partial
    statistics whose sum every rank then uses alike; the gradient flows to
    each rank's own partial unchanged."""
    return _SumPartials.apply(x, mesh, axis)


def replicated(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``, held alike by every rank along ``axis``, as the input of
    rank-local work: the gradient reaching it is summed over those ranks,
    so each holds the gradient of the whole."""
    return _Replicated.apply(x, mesh, axis)
