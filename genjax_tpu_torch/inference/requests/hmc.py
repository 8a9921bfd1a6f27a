"""Hamiltonian Monte Carlo as an edit request.

Counterpart of ``genjax_tpu/inference/requests/hmc.py``: ``HMC`` (leapfrog
over the raveled selected choices, the MH log-acceptance ratio as the
weight), ``SafeHMC`` and ``mh_accept``. Position updates are ``Update``
edits of the trace, so any model composes. Gradients flow through ``assess``
by ``torch.func.grad_and_value``, which composes with ``torch.func.vmap``
over thousands of chains; the trajectory is a Python loop of ``L`` steps.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ...core import keys
from ...core.diff import Diff
from ...core.pytree import Pytree
from ...generative.concepts import Argdiffs, DiffAnnotate, EditRequest, Retdiff, Update, Weight
from ...generative.selection import Selection
from ...generative.trace import Trace, check_same_device
from .grad_view import selected_logdensity, selection_gradient, split_ravel  # noqa: F401


def hmc_trajectory(value_and_grad: Callable, z0, r0, eps, L: int, inv_mass):
    """The deterministic part of an HMC move: ``L`` leapfrog steps of size
    ``eps`` from position ``z0`` and momentum ``r0`` under the diagonal
    inverse mass ``inv_mass``. ``value_and_grad(z)`` returns the log-density
    and its gradient. Returns ``(z1, r1, lp0, lp1)``."""
    lp0, g = value_and_grad(z0)
    z, r, lp = z0, r0, lp0
    for _ in range(L):
        r = r + (eps / 2) * g
        z = z + eps * inv_mass * r
        lp, g = value_and_grad(z)
        r = r + (eps / 2) * g
    return z, r, lp0, lp


def _value_and_grad(logdensity: Callable) -> Callable:
    grad_and_value = torch.func.grad_and_value(logdensity)

    def value_and_grad(z):
        g, lp = grad_and_value(z)
        return lp, g

    return value_and_grad


@Pytree.dataclass
class HMC(EditRequest):
    """Leapfrog-integrate Hamiltonian dynamics over the selected (continuous)
    choices; the SMCP3 weight is the MH log-acceptance ratio alpha.

    ``inv_mass``: optional diagonal inverse mass over the *raveled*
    selected-choice vector; momenta draw from ``N(0, M)`` and the drift is
    ``eps * M^-1 r``.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 0.5) @ "y"
    >>> gen = torch.Generator().manual_seed(0)
    >>> tr, _ = model.generate(gen, g.C["y"].set(1.0), ())
    >>> new_tr, alpha, _rd, bwd = tr.edit(gen, g.HMC(g.S["mu"], 0.1, L=5))
    >>> bool(torch.isfinite(alpha))         # the MH log-acceptance ratio
    True
    >>> isinstance(bwd, g.HMC)              # backward request for SMCP3
    True
    """

    selection: Selection
    eps: Any
    L: int = Pytree.static(default=10)
    inv_mass: Any = None

    def edit(
        self, gen: torch.Generator, tr: Trace, argdiffs: Argdiffs
    ) -> tuple[Trace, Weight, Retdiff, EditRequest]:
        if not Diff.static_check_no_change(argdiffs):
            raise NotImplementedError("HMC requires unchanged arguments.")

        # one differentiable log-joint over the RAVELED selected values: the
        # trajectory carries three flat vectors, each step costs one
        # value-and-gradient of assess, and the trace is made once at the end
        z0, logdensity, to_choices = selected_logdensity(
            tr.get_gen_fn(), tr.get_choices(), self.selection, Diff.tree_primal(argdiffs)
        )
        if self.inv_mass is None:
            inv_mass = torch.ones_like(z0)
        else:
            inv_mass = torch.as_tensor(self.inv_mass, dtype=z0.dtype, device=z0.device)
            inv_mass = inv_mass.broadcast_to(z0.shape)
        if keys.is_key(gen):
            # the reference's split in three: the momenta and the final Update
            _, k_mom, k_update = keys.split(gen, 3).unbind(-2)
            r0 = (1.0 / torch.sqrt(inv_mass)) * keys.normal(k_mom, tuple(z0.shape))
        else:
            k_update = gen
            r0 = torch.randn(z0.shape, generator=gen, device=z0.device) / torch.sqrt(inv_mass)

        def kinetic(r):
            return 0.5 * torch.sum(inv_mass * r * r)

        z1, r1, lp0, lp1 = hmc_trajectory(
            _value_and_grad(logdensity), z0, r0, self.eps, self.L, inv_mass
        )
        final_trace, _, retdiff, _ = Update(to_choices(z1)).edit(k_update, tr, argdiffs)
        alpha = lp1 - lp0 + kinetic(r0) - kinetic(r1)
        return final_trace, alpha, retdiff, HMC(self.selection, self.eps, self.L, self.inv_mass)


def SafeHMC(selection: Selection, eps, L: int = 10) -> DiffAnnotate:
    """HMC wrapped with an assertion that the return value did not change."""

    def retdiff_assertion(retdiff):
        assert Diff.static_check_no_change(retdiff), (
            "SafeHMC: the return value changed under the move."
        )
        return retdiff

    return HMC(selection, eps, L).map(retdiff_assertion)


def mh_accept(gen: torch.Generator, trace: Trace, new_trace: Trace, alpha: Weight):
    """Metropolis-Hastings accept step over an edit's alpha weight: returns
    the accepted trace and the accept flag. One ``tree_map`` of selects, which
    vmaps over chains.

    Robust to callee-identity churn: a model whose body builds local ``@gen``
    or ``Closure`` objects mints fresh (semantically identical) static fields
    at every handler run, so old and new tree structures can differ while
    the leaves align exactly; the select then goes leaf by leaf and keeps the
    new trace's structure."""
    check_same_device(gen, trace, "mh_accept")
    if keys.is_key(gen):
        log_u = torch.log(keys.uniform(gen))
    else:
        log_u = torch.log(torch.rand((), generator=gen, device=gen.device))
    accept = log_u < alpha

    def pick(new, old):
        return torch.where(accept, new, old)

    try:
        out = pytree.tree_map(pick, new_trace, trace)
    except ValueError:
        new_leaves, new_spec = pytree.tree_flatten(new_trace)
        old_leaves = pytree.tree_leaves(trace)
        if len(new_leaves) != len(old_leaves) or any(
            _signature(n) != _signature(o) for n, o in zip(new_leaves, old_leaves)
        ):
            # a REAL structural difference, not static-identity churn: mixing
            # leaves by position would corrupt the trace
            raise
        out = pytree.tree_unflatten([pick(n, o) for n, o in zip(new_leaves, old_leaves)], new_spec)
    return out, accept


def _signature(leaf):
    return tuple(leaf.shape), leaf.dtype
