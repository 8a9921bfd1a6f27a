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
unless the caller asks for the CPU. ``run_sharded`` waits for the
scale-out port (``ROADMAP.md`` item 15).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils._pytree as pytree

from ..core.device import entry_generator, to_device
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from .resampling import effective_sample_size, resample_particles


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
        ``gen`` is a ``torch.Generator`` there or an int seed."""
        gen, device = entry_generator(gen, device, "SSMParticleFilter.run")
        k = self.n_particles
        leaves = [v for v in pytree.tree_leaves(xs) if v is not None]
        t_count = leaves[0].shape[0] if leaves else n_steps
        if t_count is None:
            raise ValueError("SSMParticleFilter.run: xs is None/empty — pass n_steps.")
        xs, constraint = to_device(xs, device), to_device(constraint, device)

        def broadcast(v):
            v = torch.as_tensor(v, device=device)
            if v.is_floating_point():
                v = v.to(torch.float32)
            return v.expand((k,) + tuple(v.shape)).contiguous()

        carries = pytree.tree_map(broadcast, init_carry)
        log_w = torch.zeros(k, device=device)
        log_z = torch.zeros((), device=device)
        ess_hist = []
        for t in range(t_count):
            x = pytree.tree_map(lambda v: None if v is None else v[t], xs)
            submap = constraint.get_submap(t)

            def extend(c):
                tr, w = self.kernel.generate(gen, submap, (c, x))
                c_new, _y = tr.get_retval()
                return c_new, w

            carries, ws = torch.func.vmap(extend, randomness="different")(carries)
            log_w = log_w + ws
            ess = effective_sample_size(log_w)
            ess_hist.append(ess)
            carries, log_w, log_z = resample_if(
                gen, ess < self.ess_threshold * k, carries, log_w, log_z, self.method
            )
        log_marginal = log_z + torch.logsumexp(log_w, dim=0) - math.log(k)
        return ParticleFilterResult(carries, log_w, log_marginal, torch.stack(ess_hist))

    def run_sharded(self, *args, **kwargs):
        """The reference's multi-chip filter (one ``shard_map`` program,
        collective resampling): not ported yet."""
        raise NotImplementedError(
            "SSMParticleFilter.run_sharded: the collective resampling across devices waits for the "
            "torch.distributed port (ROADMAP.md item 15); run() filters on one device"
        )
