"""Metropolis-adjusted Langevin (MALA) as an edit request.

Counterpart of ``genjax_tpu/inference/requests/mala.py``: one Langevin step
over the selected continuous choices,

    q' = q + (eps^2 / 2) grad log p(q) + eps xi,   xi ~ N(0, I),

with the exact MH log-ratio as the SMCP3 weight (the asymmetric proposal's
correction included). Gradients flow through ``assess``
(``grad_view.selection_gradient``), so any model composes, vmapped over
chains. Under a key the noise is the reference's: ``key, noise_key =
split(key)``, leaf ``i``'s noise ``normal(fold_in(noise_key, i))``, and the
``Update`` edits under ``key``; under a generator the noise is drawn from
it a leaf at a time.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils._pytree as pytree

from ...core import keys
from ...core.diff import Diff
from ...core.pytree import Pytree
from ...core.typing_ import static_check_supports_grad
from ...generative.concepts import Argdiffs, EditRequest, Retdiff, Update, Weight
from ...generative.selection import Selection
from ...generative.trace import Trace
from .grad_view import selection_gradient


def _tree_dot(a, b):
    return sum(torch.sum(x * y) for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


@Pytree.dataclass
class MALA(EditRequest):
    """One Langevin proposal and its exact MH weight over ``selection``.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> from genjax_tpu_torch.inference.requests import MALA
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 0.5) @ "y"
    >>> gen = torch.Generator().manual_seed(0)
    >>> tr, _ = model.generate(gen, g.C["y"].set(1.0), ())
    >>> new_tr, alpha, _rd, bwd = tr.edit(gen, MALA(g.S["mu"], 0.3))
    >>> bool(torch.isfinite(alpha)), isinstance(bwd, MALA)
    (True, True)
    """

    selection: Selection
    eps: Any

    def edit(
        self, gen: torch.Generator, tr: Trace, argdiffs: Argdiffs
    ) -> tuple[Trace, Weight, Retdiff, EditRequest]:
        if not Diff.static_check_no_change(argdiffs):
            raise NotImplementedError("MALA requires unchanged arguments.")
        eps = self.eps
        values, grads = selection_gradient(self.selection, tr, argdiffs)
        leaves, spec = pytree.tree_flatten(values)
        if keys.is_key(gen):
            gen, noise_key = keys.split(gen).unbind(-2)
            noise = [keys.normal(keys.fold_in(noise_key, i), tuple(torch.as_tensor(v).shape))
                     for i, v in enumerate(leaves)]
        else:
            noise = [torch.randn(tuple(torch.as_tensor(v).shape), generator=gen, device=gen.device)
                     for v in leaves]
        noise = pytree.tree_unflatten(noise, spec)
        fwd_mean = pytree.tree_map(lambda v, g_: v + 0.5 * eps * eps * g_, values, grads)

        def perturb(v, m, x):
            # only differentiable leaves move; discrete choices riding in the
            # lazily filtered tree stay on their support
            if static_check_supports_grad(v):
                return m + eps * x
            return v

        proposed = pytree.tree_map(perturb, values, fwd_mean, noise)
        new_tr, w, retdiff, _bwd = Update(proposed).edit(gen, tr, argdiffs)

        new_values, new_grads = selection_gradient(self.selection, new_tr, argdiffs)
        bwd_mean = pytree.tree_map(lambda v, g_: v + 0.5 * eps * eps * g_, new_values, new_grads)
        # both proposal densities from the residuals of what the traces hold,
        # not from the noise drawn: a leaf the Update cannot write reads back
        # unchanged with a zero gradient, and its two residuals cancel
        fwd_resid = pytree.tree_map(lambda new, m: (new - m) / eps, new_values, fwd_mean)
        bwd_resid = pytree.tree_map(lambda old, m: (old - m) / eps, values, bwd_mean)
        fwd_lq = -_tree_dot(fwd_resid, fwd_resid) / 2.0
        bwd_lq = -_tree_dot(bwd_resid, bwd_resid) / 2.0
        return new_tr, w + bwd_lq - fwd_lq, retdiff, MALA(self.selection, self.eps)
