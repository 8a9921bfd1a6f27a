"""No-U-Turn sampling as an edit request over arbitrary traces.

Counterpart of ``genjax_tpu/inference/requests/nuts.py``. The selected
continuous choices ravel into one position vector, the log-joint comes from
``assess`` (``grad_view.selected_logdensity``), and one fixed-budget NUTS
transition (``kernels.nuts.nuts_transition``) moves it; the new trace is one
``Update`` of the selected choices.

The move leaves the posterior invariant and is its own reverse, so the SMCP3
weight is 0 (where ``HMC`` returns the MH log-acceptance for an outside
accept step: NUTS's multinomial trajectory sampling accepts inside). Use it
with ``tr.edit``; ``mh`` composes too, its accept at alpha = 0 a no-op.
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
from ...kernels.nuts import nuts_transition
from .grad_view import selected_logdensity


@Pytree.dataclass
class NUTS(EditRequest):
    """One No-U-Turn transition over the selected (continuous) choices.

    ``inv_mass``: optional diagonal inverse mass over the *raveled*
    selected-choice vector (for example ``inference.adaptation.
    cross_chain_inv_mass`` of a batch of raveled positions). Each transition
    integrates ``2**max_depth - 1`` leaves (``nuts_transition``).

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 1.0) @ "y"
    >>> gen = torch.Generator().manual_seed(0)
    >>> tr, _ = model.generate(gen, g.C["y"].set(2.0), ())
    >>> new_tr, w, _rd, bwd = tr.edit(gen, g.NUTS(g.S["mu"], 0.4, max_depth=4))
    >>> float(w), isinstance(bwd, g.NUTS)
    (0.0, True)
    """

    selection: Selection
    eps: Any
    max_depth: int = Pytree.static(default=8)
    divergence_threshold: float = Pytree.static(default=1000.0)
    inv_mass: Any = None

    def edit_with_info(self, gen: torch.Generator, tr: Trace, argdiffs: Argdiffs):
        """``edit``, and the transition's ``NUTSInfo`` (accept statistic,
        leapfrogs, divergence, depth) after the backward request: for
        drivers that report the sampler's health (``sample_posterior``).
        Under a key, the key splits in two as the reference's does: the move
        and the ``Update``."""
        if not Diff.static_check_no_change(argdiffs):
            raise NotImplementedError("NUTS requires unchanged arguments.")
        z0, logdensity, to_choices = selected_logdensity(
            tr.get_gen_fn(), tr.get_choices(), self.selection, Diff.tree_primal(argdiffs)
        )
        k_move, k_update = keys.split(gen).unbind(-2) if keys.is_key(gen) else (gen, gen)
        z_new, info = nuts_transition(
            logdensity, z0.to(torch.float32), k_move, self.eps, max_depth=self.max_depth,
            divergence_threshold=self.divergence_threshold, inv_mass=self.inv_mass,
        )
        new_tr, _w, retdiff, _bwd = Update(to_choices(z_new)).edit(k_update, tr, argdiffs)
        bwd = NUTS(self.selection, self.eps, self.max_depth, self.divergence_threshold, self.inv_mass)
        return new_tr, torch.zeros((), device=z0.device), retdiff, bwd, info

    def edit(
        self, gen: torch.Generator, tr: Trace, argdiffs: Argdiffs
    ) -> tuple[Trace, Weight, Retdiff, EditRequest]:
        new_tr, w, retdiff, bwd, _info = self.edit_with_info(gen, tr, argdiffs)
        return new_tr, w, retdiff, bwd
