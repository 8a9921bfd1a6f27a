"""Univariate slice sampling (Neal 2003) as an edit request.

Counterpart of ``genjax_tpu/inference/requests/slice_.py``: the tuning-free
move for one scalar site of any density. Draw a level ``log u < log p(x)``,
step an interval out until it brackets the slice (Neal's capped variant,
the step budget split at random between the sides), then shrink it until a
point inside the slice is found. The target is the joint density of the
whole trace as a function of the selected scalar, so any model structure
composes; the transition is in detailed balance with the joint, so the
SMCP3 weight is 0 and ``mh`` always accepts.

The reference's three loops are ``lax.while_loop``s. Here each runs its
fixed budget, masked: each side's stepping out ``max_steps - 1`` steps (a
side's random budget never exceeds it), the shrink ``max_steps``; a step
evaluates the density whatever the lane's state, a lane that is done keeps
its values, and every bound is a function of the step index alone, so the
transition runs under ``torch.func.vmap`` over chains. A lane whose shrink
finds no point in budget stays where it was (an exact no-op, as the
reference's); the backward request carries ``exhausted``, True there.
Under a key the draws are the reference's: ``k_u, k_pos, k_dir, k_shrink,
k_update = split(key, 5)``, shrink step ``j``'s uniform under
``fold_in(k_shrink, j)``, the ``Update`` under ``k_update``; a generator is
drawn in sequence.

>>> import torch
>>> import genjax_tpu_torch as g
>>> @g.gen
... def model():
...     mu = g.normal(0.0, 1.0) @ "mu"
...     _ = g.normal(mu, 1.0) @ "y"
>>> gen = torch.Generator().manual_seed(0)
>>> tr, _ = model.generate(gen, g.C["y"].set(1.0), ())
>>> new_tr, w, _rd, bwd = tr.edit(gen, SliceSample(g.S["mu"]))
>>> float(w), bool(bwd.exhausted)
(0.0, False)
"""

from __future__ import annotations

from typing import Any

import torch

from ...core import keys
from ...core.diff import Diff
from ...core.pytree import Pytree
from ...generative.concepts import Argdiffs, EditRequest, Retdiff, Update, Weight
from ...generative.selection import Selection
from ...generative.trace import Trace
from .grad_view import selected_logdensity


def _slice_draws(gen, x0, max_steps: int):
    """The transition's uniforms ``(level, position, split, shrink steps)``:
    under a key the reference's (``split(gen, 5)``'s first four; shrink step
    ``j``'s under ``fold_in(k_shrink, j)``), under a generator in that
    order."""
    if keys.is_key(gen):
        k_u, k_pos, k_dir, k_shrink = keys.split(gen, 5).unbind(-2)[:4]
        steps = torch.arange(max_steps, device=gen.device)
        return keys.uniform(k_u), keys.uniform(k_pos), keys.uniform(k_dir), keys.uniform(keys.fold_in(k_shrink, steps))
    dev, dt = x0.device, x0.dtype
    return (torch.rand((), generator=gen, device=dev, dtype=dt), torch.rand((), generator=gen, device=dev, dtype=dt),
            torch.rand((), generator=gen, device=dev), torch.rand((max_steps,), generator=gen, device=dev, dtype=dt))


def slice_transition(gen, logp, x0, width, max_steps: int):
    """One capped stepping-out and shrink slice transition of the scalar
    ``x0`` under the log-density ``logp``, over the fixed budgets. Draws
    (``_slice_draws``, under a key or from a generator) the level, the
    interval's position, the side split and one uniform a shrink step.
    Returns ``(x1, exhausted)``."""
    dev, dt = x0.device, x0.dtype
    u_level, u_pos, u_dir, us = _slice_draws(gen, x0, max_steps)
    log_y = logp(x0) + torch.log(u_level)
    w = torch.as_tensor(width, dtype=dt, device=dev)
    lo = x0 - w * u_pos
    hi = lo + w
    # the budget split at random between the sides (J = floor(m u), K = m -
    # 1 - J): required for reversibility when the cap binds
    j_budget = torch.floor(max_steps * u_dir).to(torch.int64)

    def step_out(pos, budget, direction):
        inside = logp(pos) > log_y
        for j in range(max_steps - 1):
            active = inside & (j < budget)
            moved = pos + direction * w
            inside = torch.where(active, logp(moved) > log_y, inside)
            pos = torch.where(active, moved, pos)
        return pos

    lo = step_out(lo, j_budget, -1.0)
    hi = step_out(hi, max_steps - 1 - j_budget, 1.0)

    x, ok = x0, torch.zeros((), dtype=torch.bool, device=dev)
    for j in range(max_steps):
        x_new = lo + (hi - lo) * us[j]
        ok_new = (logp(x_new) > log_y) & ~ok
        # a lane that has its point keeps its bracket
        lo = torch.where(ok | ok_new | (x_new >= x0), lo, x_new)
        hi = torch.where(ok | ok_new | (x_new < x0), hi, x_new)
        x = torch.where(ok_new, x_new, x)
        ok = ok | ok_new
    return x, ~ok


@Pytree.dataclass
class SliceSample(EditRequest):
    """One slice-sampling transition of the selected scalar choice.

    ``width`` is the initial bracket size; ``max_steps`` the stepping-out
    budget (split at random between the sides) and the shrink budget.
    ``exhausted`` is set on the backward request an edit returns (True
    where the shrink budget ran out); it plays no part in an edit."""

    selection: Selection
    width: Any = 1.0
    max_steps: int = Pytree.static(default=32)
    exhausted: Any = None

    def edit(
        self, gen: torch.Generator, tr: Trace, argdiffs: Argdiffs
    ) -> tuple[Trace, Weight, Retdiff, EditRequest]:
        if not Diff.static_check_no_change(argdiffs):
            raise NotImplementedError("SliceSample requires unchanged arguments.")
        z0, logdensity, to_choices = selected_logdensity(
            tr.get_gen_fn(), tr.get_choices(), self.selection, Diff.tree_primal(argdiffs)
        )
        if tuple(z0.shape) != (1,):
            raise ValueError(
                "SliceSample targets exactly one scalar choice; the selection ravels to shape "
                f"{tuple(z0.shape)}. Use EllipticalSlice or HMC for vector blocks."
            )
        x1, exhausted = slice_transition(gen, lambda x: logdensity(x[None]), z0[0], self.width, self.max_steps)
        k_update = keys.split(gen, 5)[4] if keys.is_key(gen) else gen
        final_trace, _, retdiff, _ = Update(to_choices(x1[None])).edit(k_update, tr, argdiffs)
        return (
            final_trace,
            torch.zeros((), device=z0.device),
            retdiff,
            SliceSample(self.selection, self.width, self.max_steps, exhausted),
        )
