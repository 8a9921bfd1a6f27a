"""The island particle filter over a two-level mesh.

Counterpart of ``genjax_tpu/parallel/islands.py`` (``IslandFilterResult``,
``IslandParticleFilter.run_sharded``). The population splits into islands,
one a slice of the ``"island"`` axis (the slow interconnect); within an
island the particles shard over the ``"batch"`` axis, and every step's
weight statistics and adaptive resampling are collectives over ``"batch"``
alone. Islands interact only every ``exchange_every`` steps: each island
folds its weights into a scalar island log weight ``G`` by an exact
within-island resample, the islands gather the ``G`` (the only scalar
traffic over ``"island"``), resample islands by them from a stream every
rank shares, and copy the winning island's particles over ``"island"``.

The log marginal is the double-resampling island estimator: the island
level increments ``log (1 / I) sum_i exp(G_i)`` at the exchanges, the
within-island increments in each ``G_i`` between them (Vergé, Dubarry, Del
Moral and Moulines 2015).

Every rank of the mesh calls ``run_sharded`` alike. The reference's island
normalizer is a max and a sum over ``"island"`` and the selection a gather of
the same ``G``; here the gather alone serves both.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils._pytree as pytree

from ..core.device import int_seed, stream_seed, to_device
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from . import _comm
from .mesh import Mesh, mesh_generators
from .resampling import collective_log_normalizer, collective_resample, collective_weight_stats, resample_indices
from .smc import _broadcast, _extend, _steps


@Pytree.dataclass
class IslandFilterResult(Pytree):
    """This rank's particles and log weights, the island log weights
    ``(n_islands,)``, the island estimator's log marginal, the ESS history
    ``(T, n_islands)`` (each island's, before its resample) and the number
    of exchanges; all but the first two alike on every rank."""

    carries: Any
    log_weights: Any
    island_log_weights: Any
    log_marginal: Any
    ess_history: Any
    n_exchanges: Any


@Pytree.dataclass
class IslandParticleFilter(Pytree):
    """Island SMC for a scanned kernel ``(carry, x) -> (carry, y)`` with
    constrained observations at each step (``SSMParticleFilter``'s kernel
    contract).

    ``n_particles`` is an island's population, sharded over the
    ``"batch"`` axis; the total is ``n_islands * n_particles``. An island
    resamples when its ESS falls below ``ess_threshold * n_particles``;
    islands exchange every ``exchange_every`` steps.
    """

    kernel: GenerativeFunction
    n_particles: int = Pytree.static()
    ess_threshold: float = Pytree.static(default=0.5)
    exchange_every: int = Pytree.static(default=16)
    method: str = Pytree.static(default="systematic")

    def run_sharded(
        self,
        gen,
        init_carry: Any,
        xs: Any,
        constraint: ChoiceMap,
        mesh: Mesh,
        *,
        island_axis: str = "island",
        particle_axis: str = "batch",
        n_steps: int | None = None,
    ) -> IslandFilterResult:
        """Filter over ``xs`` with islands over ``island_axis`` and each
        island's particles over ``particle_axis`` of ``mesh``
        (``make_hier_mesh``). ``gen`` (a generator on the ranks' device or
        an int seed) must be in the same state on every rank."""
        if island_axis not in mesh.shape or particle_axis not in mesh.shape:
            raise ValueError(
                f"mesh must carry axes {island_axis!r} and {particle_axis!r} (got {tuple(mesh.shape)}); "
                "build one with parallel.make_hier_mesh(n_islands, n_shards)"
            )
        n_islands, n_shards = mesh.shape[island_axis], mesh.shape[particle_axis]
        if self.n_particles % n_shards:
            raise ValueError(
                f"n_particles={self.n_particles} must divide over the {n_shards}-shard {particle_axis!r} axis"
            )
        entry = "IslandParticleFilter.run_sharded"
        k_island = self.n_particles
        k_local = k_island // n_shards
        island = mesh.axis_index(island_axis)
        shared, local = mesh_generators(gen, mesh, entry)
        # the stream every rank of one island shares: the exchange's
        # within-island resample draws its global indices from it
        island_gen = torch.Generator(device=mesh.device).manual_seed(stream_seed(int_seed(shared), island))
        device = mesh.device
        t_count = _steps(xs, n_steps, entry)
        xs, constraint = to_device(xs, device), to_device(constraint, device)
        carries = _broadcast(init_carry, k_local, device)
        log_w = torch.zeros(k_local, device=device)
        g = torch.zeros((), device=device)
        log_z = torch.zeros((), device=device)
        n_ex = 0
        ess_hist = []
        for t in range(t_count):
            with _comm.step(t):
                carries, ws = _extend(self.kernel, local, carries, xs, constraint, t)
                log_w = log_w + ws
                # within the island: collectives over the particle axis only
                ess, log_z_inc = collective_weight_stats(log_w, mesh, particle_axis)
                ess_hist.append(ess)
                if bool(ess < self.ess_threshold * k_island):
                    carries, log_w, inc = collective_resample(
                        local, carries, log_w, mesh, particle_axis, method=self.method, mode="local",
                        log_z_inc=log_z_inc,
                    )
                    g = g + inc
                if (t + 1) % self.exchange_every == 0:
                    carries, inc = self._exchange(shared, island_gen, carries, log_w, g, mesh, island_axis,
                                                  particle_axis, island, n_islands)
                    log_w, g, log_z, n_ex = torch.zeros_like(log_w), torch.zeros_like(g), log_z + inc, n_ex + 1
        all_g = mesh.all_gather_cat(g + collective_log_normalizer(log_w, mesh, particle_axis), island_axis)
        log_marginal = log_z + torch.logsumexp(all_g, dim=0) - math.log(n_islands)
        ess_all = mesh.all_gather_cat(torch.stack(ess_hist), island_axis).reshape(n_islands, t_count).T
        return IslandFilterResult(carries, log_w, all_g, log_marginal, ess_all, n_ex)

    def _exchange(self, shared, island_gen, carries, log_w, g, mesh, island_axis, particle_axis, island,
                  n_islands):
        """The scheduled exchange: ``(carries, island-level increment)``."""
        k_island = self.n_particles
        # fold the residual weights into the island weight by an exact
        # within-island resample (weights become uniform)
        local_norm = collective_log_normalizer(log_w, mesh, particle_axis)
        carries, _, _ = collective_resample(
            island_gen, carries, log_w, mesh, particle_axis, method=self.method, mode="all_gather",
            log_z_inc=local_norm,
        )
        all_g = mesh.all_gather_cat(g + local_norm, island_axis)  # I floats over the slow axis
        inc = torch.logsumexp(all_g, dim=0) - math.log(n_islands)
        # every rank draws the same island ancestors from the shared stream
        anc = resample_indices(shared, all_g, n_islands, self.method)[island]
        k_local = k_island // mesh.shape[particle_axis]

        def take(v):
            blocks = mesh.all_gather_cat(v, island_axis)
            return blocks.reshape((n_islands, k_local) + tuple(v.shape[1:]))[anc]

        return pytree.tree_map(take, carries), inc
