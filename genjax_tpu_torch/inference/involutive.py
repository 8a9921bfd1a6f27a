"""Involutive MCMC: MH moves defined by an auxiliary generative function and
a deterministic involution on (model choices, auxiliary choices).

Counterpart of ``genjax_tpu/inference/involutive.py`` (Cusumano-Towner,
Lew & Mansinghka 2020; Gen.jl's ``mh(trace, proposal, involution)``). The
kernel draws auxiliary choices ``u ~ q(.; t)``, maps ``(t', u') = f(t, u)``
with ``f`` an involution, and accepts with

    alpha = [log p(t') + log q(u'; t')] - [log p(t) + log q(u; t)] + log |det J_f|

the Jacobian taken over the continuous coordinates of ``(t, u)`` (discrete
leaves pass through and add no volume). The model-score ratio comes from
one fully determined ``Update`` edit; the Jacobian is ``torch.func.jacfwd``
of the involution over the raveled continuous coordinates with
``torch.linalg.slogdet``, where the reference takes ``jax.jacfwd``; the move
runs under ``torch.func.vmap`` over chains. A key is split into the
auxiliary draw's, the edit's and the accept draw's keys, as the reference
splits it; a ``torch.Generator`` is drawn from in sequence.

>>> import torch
>>> import genjax_tpu_torch as g
>>> @g.gen
... def model():
...     return g.log_normal(0.0, 1.0) @ "sigma"
>>> @g.gen
... def aux():
...     return g.normal(0.0, 0.4) @ "u"
>>> def scale(t, u):
...     return g.C["sigma"].set(t["sigma"] * torch.exp(u["u"])), g.C["u"].set(-u["u"])
>>> gen = torch.Generator().manual_seed(0)
>>> tr = model.simulate(gen, ())
>>> _, info = involutive_mh(gen, tr, aux, scale, check=True)
>>> float(info.involution_error) < 1e-6
True
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core import keys
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap
from ..generative.concepts import Update
from ..generative.gfi import GenerativeFunction
from ..generative.trace import Trace, trace_device
from .requests.grad_view import split_ravel
from .requests.hmc import mh_accept


@Pytree.dataclass
class InvolutiveInfo(Pytree):
    """Move diagnostics: the accept flag, the log-acceptance, the Jacobian's
    log-determinant, and (with ``check=True``) the largest round-trip error
    of applying the involution twice (about 0 for a true involution)."""

    accepted: Any
    alpha: Any
    logdet: Any
    involution_error: Any


def involutive_mh(
    gen: torch.Generator,
    trace: Trace,
    aux_model: GenerativeFunction,
    involution: Callable[[ChoiceMap, ChoiceMap], tuple[ChoiceMap, ChoiceMap]],
    *,
    aux_args: Callable[[Trace], tuple] | tuple = (),
    jacobian: str = "auto",
    check: bool = False,
) -> tuple[Trace, InvolutiveInfo]:
    """One involutive-MH step on ``trace``, where it lives.

    ``aux_model`` proposes the auxiliary choices from ``aux_args`` (a tuple,
    or a callable ``trace -> tuple`` for a data-driven proposal).
    ``involution`` maps ``(model_choices, aux_choices) -> (new_model_choices,
    new_aux_choices)``, must be its own inverse, and must emit every address
    of the new model structure (so the ``Update`` that applies it draws
    nothing).

    ``jacobian``: ``"auto"`` differentiates the involution's continuous
    ravel (the exact log-|det|); ``"zero"`` certifies a volume-preserving
    move and skips the Jacobian."""
    if jacobian not in ("auto", "zero"):
        raise ValueError(f"jacobian must be 'auto' or 'zero', got {jacobian!r}")
    args_of = aux_args if callable(aux_args) else (lambda _tr: aux_args)
    dev = trace_device(trace)
    k_aux, k_edit, k_acc = keys.split_stream(gen, 3)

    t = trace.get_choices()
    u_trace = aux_model.simulate(k_aux, args_of(trace))
    u = u_trace.get_choices()
    q_fwd = u_trace.get_score()
    t_new, u_new = involution(t, u)

    # the Jacobian over the continuous coordinates
    flat_in, rebuild = split_ravel((t, u))
    if jacobian == "zero" or flat_in.numel() == 0:
        logdet = torch.zeros((), device=dev)
    else:
        out_dim = split_ravel((t_new, u_new))[0].shape[0]
        if out_dim != flat_in.shape[0]:
            raise ValueError(
                "involution is not dimension-balanced on the continuous coordinates: dim(t)+dim(u) = "
                f"{flat_in.shape[0]} in, {out_dim} out; balance with auxiliary choices"
            )
        jac = torch.func.jacfwd(lambda z: split_ravel(involution(*rebuild(z)))[0])(flat_in)
        logdet = torch.linalg.slogdet(jac)[1]

    new_trace, w_model, _rd, _bwd = trace.edit(k_edit, Update(t_new))
    q_bwd, _ = aux_model.assess(u_new, args_of(new_trace))
    alpha = w_model + q_bwd - q_fwd + logdet

    if not check:
        involution_error = torch.zeros((), device=dev)
    else:
        # the round trip on the continuous ravel: f(f(t, u)) restores it
        flat_rt, _ = split_ravel(involution(t_new, u_new))
        if flat_rt.numel() != flat_in.numel():
            involution_error = torch.full((), torch.inf, device=dev)
        elif flat_in.numel():
            involution_error = torch.max(torch.abs(flat_rt - flat_in))
        else:
            involution_error = torch.zeros((), device=dev)

    out, accepted = mh_accept(k_acc, trace, new_trace, alpha)
    return out, InvolutiveInfo(accepted=accepted, alpha=alpha, logdet=logdet, involution_error=involution_error)


def involutive_move(
    aux_model: GenerativeFunction,
    involution: Callable,
    *,
    aux_args: Callable[[Trace], tuple] | tuple = (),
    jacobian: str = "auto",
) -> Callable:
    """A ``gibbs_sweep`` move from an involutive kernel."""

    def move(gen: torch.Generator, trace: Trace) -> Trace:
        return involutive_mh(gen, trace, aux_model, involution, aux_args=aux_args, jacobian=jacobian)[0]

    return move
