"""The particle filter for state-space models on one device.

Counterpart of ``genjax_tpu/parallel/smc.py:37-168``: ``ParticleFilterResult``
and ``SSMParticleFilter.run``, sequential importance resampling over a
scanned kernel ``(carry, x) -> (carry, y)`` whose observations at each step
are constrained. Each step extends every particle by one ``torch.func.vmap``
of ``kernel.generate`` under the step's observation submap, adds the
weights, and resamples when the effective sample size falls below
``ess_threshold * K``.

The reference decides inside ``lax.cond``, on the device. Here the decision
is one read of the ESS to the host a step (``resample_if``): the host sets
the pace of a step, so the read costs little, and a step that does not
resample launches nothing for it. The other design, resampling every step
and selecting with ``torch.where``, reads nothing and launches the resample
always; ``chip_smoke.py`` times both. The run lives on ``device``, the card
unless the caller asks for the CPU.

``run`` takes a key (``core/keys.py``), a ``torch.Generator`` or an int
seed. Under a key step ``t`` draws as the reference's does: ``extend_key,
resample_key = split(fold_in(key, t))`` (made for every step at once, in
two hashes), particle ``i`` extends under the ``i``-th of ``split(extend_key,
K)``, and a step that resamples draws under ``resample_key``; the filter is
then the reference's draw for draw. A generator is drawn from in sequence.
The sharded drivers draw from generators only: a key there raises
``GFITypeError``.

``run_sharded`` is the reference's ``shard_map`` program run by every rank
of a mesh axis on its own ``n_particles / world`` particles: the global ESS
and normalizer in two collectives a step (``collective_weight_stats``), the
decision one host read of the global ESS a step, as in ``run``, and the
resample ``collective_resample`` in either mode. ``sharded_importance`` is
importance sampling with the particles sharded the same way.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.device import to_device
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..generative.typecheck import check_generator
from . import _comm
from .mesh import Mesh, local_count, mesh_generators
from .resampling import (
    collective_log_normalizer,
    collective_resample,
    collective_weight_stats,
    effective_sample_size,
    resample_particles,
)


def _steps(xs, n_steps, entry: str) -> int:
    leaves = [v for v in pytree.tree_leaves(xs) if v is not None]
    t_count = leaves[0].shape[0] if leaves else n_steps
    if t_count is None:
        raise ValueError(f"{entry}: xs is None/empty — pass n_steps.")
    return t_count


def _broadcast(init_carry, k: int, device):
    """``k`` copies of the initial carry on ``device``, numbers as float32."""

    def one(v):
        v = torch.as_tensor(v, device=device)
        if v.is_floating_point():
            v = v.to(torch.float32)
        return v.expand((k,) + tuple(v.shape)).contiguous()

    return pytree.tree_map(one, init_carry)


def _extend(kernel, gen, carries, xs, constraint, t: int):
    """Every particle extended by one step of ``kernel`` under the
    observations at ``t``: ``(carries, incremental log weights)``. Under a
    key particle ``i`` draws under the ``i``-th of ``split(key, K)``."""
    x = pytree.tree_map(lambda v: None if v is None else v[t], xs)
    submap = constraint.get_submap(t)

    def extend(g, c):
        tr, w = kernel.generate(g, submap, (c, x))
        c_new, _y = tr.get_retval()
        return c_new, w

    return keys.vmap_streams(extend, gen, pytree.tree_leaves(carries)[0].shape[0])(carries)


def step_streams(gen, t_count: int) -> list:
    """Each step's ``(extend, resample)`` streams: under a key the pairs
    ``split(fold_in(key, t))`` of the reference's filters, made for every
    step in two hashes; a generator twice each step."""
    if not keys.is_key(gen):
        return [(gen, gen)] * t_count
    steps = keys.fold_in(gen, torch.arange(t_count, device=gen.device))
    return [tuple(pair.unbind(0)) for pair in keys.split(steps).unbind(0)]


def resample_if(gen: torch.Generator, fire: torch.Tensor, particles: Any, log_w: torch.Tensor,
                log_z: torch.Tensor, method: str):
    """Resample ``particles`` when ``fire`` holds, folding the mean weight
    into ``log_z`` and resetting the weights: one read of ``fire`` to the
    host, and no launch when it is false."""
    if not bool(fire):
        return particles, log_w, log_z
    k = log_w.shape[0]
    inc = torch.logsumexp(log_w, dim=0) - math.log(k)
    particles = resample_particles(gen, particles, log_w, k, method)
    return particles, torch.zeros_like(log_w), log_z + inc


@Pytree.dataclass
class ParticleFilterResult(Pytree):
    """Final carries and weights, the log marginal likelihood estimate, and
    the ESS of every step (before its resample)."""

    carries: Any
    log_weights: Any
    log_marginal: Any
    ess_history: Any


@Pytree.dataclass
class SSMParticleFilter(Pytree):
    """Sequential importance resampling for a scanned kernel
    ``(carry, x) -> (carry, y)`` whose observations at step ``t`` are
    ``constraint.get_submap(t)``.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> from genjax_tpu_torch.models import linear_gaussian_ssm
    >>> from genjax_tpu_torch.parallel import SSMParticleFilter
    >>> kernel, exact = linear_gaussian_ssm()
    >>> ys = torch.tensor([0.3, -0.1, 0.4])
    >>> pf = SSMParticleFilter(kernel, n_particles=4096)
    >>> res = pf.run(0, 0.0, torch.zeros(3), g.C[:, "y"].set(ys), device="cpu")
    >>> abs(float(res.log_marginal) - exact(ys.tolist())) < 0.1
    True
    """

    kernel: GenerativeFunction
    n_particles: int = Pytree.static()
    ess_threshold: float = Pytree.static(default=0.5)
    method: str = Pytree.static(default="systematic")

    def run(
        self,
        gen,
        init_carry: Any,
        xs: Any,
        constraint: ChoiceMap,
        *,
        n_steps: int | None = None,
        device="cuda",
    ) -> ParticleFilterResult:
        """Filter over ``xs`` (a pytree with the step axis leading, or None
        with ``n_steps``) from ``init_carry``, with particles on ``device``.
        ``gen`` is a key (placed there), a ``torch.Generator`` there or an
        int seed."""
        gen, device = keys.entry_stream(gen, device, "SSMParticleFilter.run")
        k = self.n_particles
        t_count = _steps(xs, n_steps, "SSMParticleFilter.run")
        xs, constraint = to_device(xs, device), to_device(constraint, device)
        carries = _broadcast(init_carry, k, device)
        log_w = torch.zeros(k, device=device)
        log_z = torch.zeros((), device=device)
        ess_hist = []
        for t, (extend_gen, resample_gen) in enumerate(step_streams(gen, t_count)):
            carries, ws = _extend(self.kernel, extend_gen, carries, xs, constraint, t)
            log_w = log_w + ws
            ess = effective_sample_size(log_w)
            ess_hist.append(ess)
            carries, log_w, log_z = resample_if(
                resample_gen, ess < self.ess_threshold * k, carries, log_w, log_z, self.method
            )
        log_marginal = log_z + torch.logsumexp(log_w, dim=0) - math.log(k)
        return ParticleFilterResult(carries, log_w, log_marginal, torch.stack(ess_hist))

    def run_sharded(
        self,
        gen,
        init_carry: Any,
        xs: Any,
        constraint: ChoiceMap,
        mesh: Mesh,
        *,
        axis: str = "batch",
        resample_mode: str = "local",
        n_steps: int | None = None,
    ) -> ParticleFilterResult:
        """The filter with the particles sharded over ``mesh``'s ``axis``:
        every rank of the axis calls it alike and holds ``n_particles /
        size`` particles on its device. ``gen`` (a generator on that device,
        or an int seed) must be in the same state on every rank: each rank
        draws its particles from its own stream (``mesh_generators``), and
        ``"all_gather"`` resampling its global indices from ``gen``.

        Returns this rank's carries and log weights, and the global log
        marginal likelihood and ESS history (alike on every rank)."""
        entry = "SSMParticleFilter.run_sharded"
        if keys.is_key(gen):
            check_generator(gen, entry)
        k = self.n_particles
        k_local = local_count(k, mesh, axis, "n_particles")
        shared, local = mesh_generators(gen, mesh, entry)
        resample_gen = {"local": local, "all_gather": shared}.get(resample_mode)
        if resample_gen is None:
            raise ValueError(f"Unknown collective resampling mode: {resample_mode!r}")
        device = mesh.device
        t_count = _steps(xs, n_steps, entry)
        xs, constraint = to_device(xs, device), to_device(constraint, device)
        carries = _broadcast(init_carry, k_local, device)
        log_w = torch.zeros(k_local, device=device)
        log_z = torch.zeros((), device=device)
        ess_hist = []
        for t in range(t_count):
            with _comm.step(t):
                carries, ws = _extend(self.kernel, local, carries, xs, constraint, t)
                log_w = log_w + ws
                # one fused pair of collectives: the ESS of the decision and
                # the normalizer the resample needs
                ess, log_z_inc = collective_weight_stats(log_w, mesh, axis)
                ess_hist.append(ess)
                if bool(ess < self.ess_threshold * k):
                    carries, log_w, inc = collective_resample(
                        resample_gen, carries, log_w, mesh, axis, method=self.method, mode=resample_mode,
                        log_z_inc=log_z_inc,
                    )
                    log_z = log_z + inc
        log_marginal = log_z + collective_log_normalizer(log_w, mesh, axis)
        return ParticleFilterResult(carries, log_w, log_marginal, torch.stack(ess_hist))


def sharded_importance(target_importance, gen, k_particles: int, mesh: Mesh, *, axis: str = "batch"):
    """Importance sampling with the particles sharded over ``mesh``'s
    ``axis``: every rank runs ``target_importance(gen) -> (trace,
    log_weight)`` for its ``k_particles / size`` particles, vmapped, from its
    own stream, and the normalizer is one max and one sum over the axis.
    Returns this rank's ``(traces, log_weights)`` and the global ``log_z``.
    ``gen`` must be in the same state on every rank."""
    if keys.is_key(gen):
        check_generator(gen, "sharded_importance")
    k_local = local_count(k_particles, mesh, axis, "k_particles")
    _shared, local = mesh_generators(gen, mesh, "sharded_importance")
    trs, ws = torch.func.vmap(lambda _: target_importance(local), randomness="different")(
        torch.zeros(k_local, device=mesh.device)
    )
    return trs, ws, collective_log_normalizer(ws, mesh, axis)
