"""Process groups, named meshes and the batch's shards.

Counterpart of ``genjax_tpu/parallel/mesh.py``. The reference drives every
device from one process through a ``jax.sharding.Mesh``, and a sharded batch
is one global array. The port runs one process a rank on a
``torch.distributed`` process group (NCCL on the card, gloo on the CPU): a
``Mesh`` names the dimensions of a ``torch.distributed.device_mesh``
``DeviceMesh`` over every rank of the world, and a sharded batch is each
rank's own slice, a plain tensor on its device. Every algorithm the reference
writes as a ``shard_map`` program is the same program run by every rank, its
collectives written out (``parallel/_comm.py``).

``shard_map_compat`` and ``batch_spec`` have no counterpart: there is no
``shard_map`` to call and no ``PartitionSpec`` to give.

Randomness: rank ``r`` draws from a generator on its device seeded by
``stream_seed(base, r)``, the base drawn once from the caller's generator,
which every rank seeds alike (``mesh_generators``); what every rank must
draw alike (the global resampling indices) comes from the caller's
generator itself, in the same state on every rank.
"""

from __future__ import annotations

import socket
from datetime import timedelta
from typing import Any

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from ..core import keys
from ..core.device import chain_generator, entry_device, int_seed, stream_seed
from ..generative.typecheck import check_generator
from . import _comm


class Mesh:
    """Named dimensions over the ranks of the world, and this rank's device.

    ``axis_names`` and ``shape`` (a dict from name to size) read as the
    reference's ``Mesh``; ``device_mesh`` is the ``DeviceMesh`` whose
    dimension groups the collectives run over. The collective methods
    forward to ``parallel/_comm.py`` (modules below this layer, the
    kernels' warmups, take a mesh and call them)."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"

    @property
    def rank(self) -> int:
        """This rank's index in the world."""
        return dist.get_rank()

    @property
    def world_size(self) -> int:
        return dist.get_world_size()

    def barrier(self) -> None:
        _comm.barrier()

    def axis_size(self, axis: str) -> int:
        return _comm.axis_size(self, axis)

    def axis_index(self, axis: str) -> int:
        return _comm.axis_index(self, axis)

    def all_reduce_sum(self, x, axis: str):
        return _comm.all_reduce_sum(x, self, axis)

    def all_reduce_mean(self, x, axis: str):
        return _comm.all_reduce_mean(x, self, axis)

    def all_gather_cat(self, x, axis: str):
        return _comm.all_gather_cat(x, self, axis)


def initialize_distributed(
    *,
    rank: int,
    world_size: int,
    init_method: str | None = None,
    store=None,
    device_type: str = "cuda",
    local_rank: int | None = None,
    timeout_s: float | None = None,
) -> torch.device:
    """Join this process to the world as ``rank`` of ``world_size`` (call
    once in every rank before making a mesh; the reference's pass-through to
    ``jax.distributed.initialize``). Returns this rank's device.

    ``device_type="cuda"`` (the default) runs NCCL, rank ``r`` on card
    ``cuda:<local_rank>`` (``r`` modulo the cards this host has, unless
    given); without a card it raises. ``device_type="cpu"`` runs gloo.
    Nothing falls back from one to the other. The rendezvous is
    ``init_method`` (``tcp://host:port``, ``file://path``) or a ``store``;
    with neither, torch's ``env://``.
    """
    kw = {} if timeout_s is None else {"timeout": timedelta(seconds=timeout_s)}
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_distributed runs NCCL on the card by default (device_type='cuda'), and "
                "torch sees no CUDA device here; pass device_type='cpu' to run gloo on the CPU"
            )
        local_rank = rank % torch.cuda.device_count() if local_rank is None else local_rank
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
        backend = "nccl"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    dist.init_process_group(backend, init_method=init_method, store=store, rank=rank,
                            world_size=world_size, **kw)
    return device


def _world(entry: str, device) -> tuple[int, torch.device]:
    """The world's size and this rank's device of type ``device``, checked
    against the group's backend."""
    device = entry_device(device, entry)
    if not dist.is_initialized():
        raise RuntimeError(
            f"{entry}: no process group; call parallel.initialize_distributed(rank=..., world_size=...) "
            "in every rank first (a world of 1 on one card)"
        )
    backend = dist.get_backend()
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"{entry}: a mesh on {device.type} needs a {want} process group, this one is {backend}")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return dist.get_world_size(), device


def _mesh(device: torch.device, shape: tuple, names: tuple) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(device.type, shape, mesh_dim_names=names), device)


def make_mesh(n_devices: int | None = None, axis: str = "batch", *, device="cuda") -> Mesh:
    """A 1-D mesh over every rank of the world, with one named axis for the
    chain or particle batch. ``device`` is the ranks' device type: the card
    by default (NCCL), ``"cpu"`` for a gloo world. ``n_devices``, where
    given, must be the world's size: a mesh spans the world.

    >>> import os, tempfile
    >>> import torch.distributed as dist
    >>> from genjax_tpu_torch.parallel import initialize_distributed, make_mesh
    >>> store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    >>> _ = initialize_distributed(rank=0, world_size=1, store=store, device_type="cpu")
    >>> mesh = make_mesh(device="cpu")
    >>> mesh.axis_names, mesh.shape["batch"]
    (('batch',), 1)
    >>> dist.destroy_process_group()
    """
    world, device = _world("make_mesh", device)
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(
            f"make_mesh({n}) but only {world} rank(s) are in the world; start one process a rank "
            "(initialize_distributed(rank=..., world_size=...))"
        )
    if n < world:
        raise ValueError(f"make_mesh({n}): a mesh spans every rank of the world ({world})")
    return _mesh(device, (n,), (axis,))


def make_hier_mesh(
    n_islands: int,
    n_shards: int | None = None,
    axes: tuple[str, str] = ("island", "batch"),
    *,
    device="cuda",
) -> Mesh:
    """A 2-D hierarchical mesh ``axes[0]`` (islands, the slow interconnect)
    x ``axes[1]`` (shards within an island), ranks laid out in order, for
    the island particle filter and other rare-exchange algorithms."""
    world, device = _world("make_hier_mesh", device)
    if n_shards is None:
        if world % n_islands:
            raise ValueError(f"{world} devices do not split into {n_islands} islands")
        n_shards = world // n_islands
    need = n_islands * n_shards
    if need > world:
        raise ValueError(
            f"make_hier_mesh({n_islands}, {n_shards}) needs {need} devices but only {world} are available"
        )
    if need < world:
        raise ValueError(f"make_hier_mesh({n_islands}, {n_shards}): a mesh spans every rank of the world ({world})")
    return _mesh(device, (n_islands, n_shards), tuple(axes))


def host_local_mesh(axis: str = "batch", *, device="cuda") -> Mesh:
    """A 1-D mesh over this host's ranks only. The world's ranks must sit
    on their hosts in contiguous, equal blocks (as a launcher starts them);
    on one host it is ``make_mesh``."""
    world, device = _world("host_local_mesh", device)
    hosts: list = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    order = list(dict.fromkeys(hosts))
    n_local = hosts.count(hosts[0])
    if hosts != [h for h in order for _ in range(n_local)]:
        raise ValueError("host_local_mesh: the ranks of each host must be contiguous and equal in number")
    if len(order) == 1:
        return _mesh(device, (world,), (axis,))
    grid = _mesh(device, (len(order), n_local), ("host", axis))
    return Mesh(grid.device_mesh[axis], device)


def shard_batch(tree: Any, mesh: Mesh, axis: str = "batch") -> Any:
    """This rank's slice of the leading axis of every tensor leaf of
    ``tree`` (the whole batch, alike on every rank), on its device; 0-d
    leaves are replicated. A leading size the axis does not divide
    raises."""
    size, idx = mesh.axis_size(axis), mesh.axis_index(axis)

    def place(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if leaf.dim() == 0:
            return leaf.to(mesh.device)
        if leaf.shape[0] % size:
            raise ValueError(f"leading axis {leaf.shape[0]} does not divide over the {size}-rank {axis!r} axis")
        k = leaf.shape[0] // size
        return leaf[idx * k : (idx + 1) * k].to(mesh.device)

    return pytree.tree_map(place, tree)


def gather_batch(tree: Any, mesh: Mesh, axis: str = "batch") -> Any:
    """The global batch rebuilt on every rank from the ranks' slices along
    ``axis`` (rank order): for tests and diagnostics, not the hot path."""
    return pytree.tree_map(
        lambda v: mesh.all_gather_cat(v, axis) if isinstance(v, torch.Tensor) and v.dim() >= 1 else v, tree
    )


def mesh_generators(gen, mesh: Mesh, entry: str) -> tuple[torch.Generator, torch.Generator]:
    """``(shared, local)``: the caller's generator on this rank's device
    (``gen`` itself, or one seeded by the int ``gen``), which every rank
    holds in the same state, and this rank's own, seeded by
    ``stream_seed(base, rank)`` with ``base`` drawn once from the shared
    one. A key raises ``GFITypeError``: a run over a mesh draws from
    generators only."""
    if keys.is_key(gen):
        check_generator(gen, entry)
    shared = chain_generator(gen, mesh.device, entry)
    local = torch.Generator(device=mesh.device).manual_seed(stream_seed(int_seed(shared), mesh.rank))
    return shared, local


def local_count(n: int, mesh: Mesh, axis: str, what: str) -> int:
    """The rank's share of ``n`` items sharded over ``axis``; an ``n`` the
    axis does not divide raises."""
    size = mesh.axis_size(axis)
    if n % size:
        raise ValueError(f"{what}={n} must divide over {size} shards")
    return n // size


__all__ = [
    "Mesh",
    "gather_batch",
    "host_local_mesh",
    "initialize_distributed",
    "make_hier_mesh",
    "make_mesh",
    "mesh_generators",
    "shard_batch",
]
