"""One shared gradient path over selected choices.

Counterpart of ``genjax_tpu/inference/requests/grad_view.py``. Every
gradient-using move needs the same view of a trace: the choices a
``Selection`` picks out, with the differentiable leaves raveled into ONE
flat vector ``z`` and a scalar log-joint ``logdensity(z)`` that
``torch.func`` can differentiate and vmap. The selected tree is flattened
once into a leaf list plus a differentiability mask, the differentiable
leaves ravel into ``z``, and ``rebuild`` splices vector slices back into
their slots; other leaves (discrete choices) ride along untouched.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.utils._pytree as pytree

from ...core import keys
from ...core.diff import Diff
from ...core.typing_ import static_check_supports_grad
from ...generative.choice_map import ChoiceMap
from ...generative.concepts import Argdiffs
from ...generative.selection import Selection
from ...generative.trace import Trace, trace_device


def split_ravel(tree) -> tuple[torch.Tensor, Callable]:
    """Ravel the differentiable leaves of ``tree`` into one flat vector.

    Returns ``(z0, rebuild)``: ``rebuild(z)`` reassembles the full tree with
    ``z``'s slices in the differentiable slots and the original values
    everywhere else; ``rebuild(z, nongrad_fill=fn)`` replaces each other leaf
    with ``fn(leaf)`` instead (zeros for a gradient tree). ``z`` may carry
    leading batch axes: ``z (..., d)`` gives differentiable leaves shaped
    ``(..., *shape)``.
    """
    leaves, spec = pytree.tree_flatten(tree)
    diff_mask = tuple(static_check_supports_grad(leaf) for leaf in leaves)
    parts = [leaf for leaf, d in zip(leaves, diff_mask) if d]
    shapes = [tuple(p.shape) for p in parts]
    sizes = [math.prod(s) for s in shapes]
    z0 = torch.cat([p.reshape(-1) for p in parts]) if parts else torch.zeros(0, device=trace_device(tree))

    def rebuild(z, nongrad_fill: Callable | None = None):
        slices = iter(
            piece.reshape(tuple(z.shape[:-1]) + shape).to(part.dtype)
            for piece, shape, part in zip(torch.split(z, sizes, dim=-1), shapes, parts)
        )
        out = [
            next(slices) if d else (leaf if nongrad_fill is None else nongrad_fill(leaf))
            for leaf, d in zip(leaves, diff_mask)
        ]
        return pytree.tree_unflatten(out, spec)

    return z0, rebuild


def selected_logdensity(
    gen_fn, chm: ChoiceMap, selection: Selection, args: tuple
) -> tuple[torch.Tensor, Callable, Callable]:
    """The standard sampler entry point: materialize ``selection``'s choices,
    ravel them, and close ``assess`` over the frozen complement.

    Returns ``(z0, logdensity, to_choices)``: ``logdensity(z)`` is the
    differentiable log-joint and ``to_choices(z)`` the selected-choice map a
    position vector stands for (for the final ``Update``)."""
    frozen = chm.filter(~selection)
    z0, rebuild = split_ravel(chm.filter_eager(selection))

    def logdensity(z):
        weight, _ = gen_fn.assess(rebuild(z).merge(frozen), args)
        return weight

    return z0, logdensity, rebuild


def column_view(traces, selection: Selection, chain_axis: int = 0):
    """The bridge between a trace batch and the column layout, for the
    batched samplers.

    Given a batched trace pytree (chain axis at ``chain_axis`` on every
    leaf), returns ``(z_cols, ld_cols, write_back)``:

    - ``z_cols``: the selected choices of all chains raveled into a
      ``(d, n_chains)`` column block;
    - ``ld_cols(Z)``: the batched log-joint ``(d, N) -> (N,)``, each chain's
      GFI ``assess`` over its own frozen complement, so per-chain
      constraints are honored;
    - ``write_back(z_final, gen)``: the trace batch rebuilt at the final
      positions by one vmapped ``Update`` edit.
    """

    def sel_chm(tr):
        return tr.get_choices().filter_eager(selection)

    def z_of(tr):
        return split_ravel(sel_chm(tr))[0]

    z_cols = torch.func.vmap(z_of, in_dims=chain_axis, out_dims=1)(traces)

    def ld_one(tr, z):
        chm = tr.get_choices()
        _z0, rebuild = split_ravel(chm.filter_eager(selection))
        w, _ = tr.get_gen_fn().assess(rebuild(z).merge(chm.filter(~selection)), tr.get_args())
        return w

    def ld_cols(z):
        return torch.func.vmap(ld_one, in_dims=(chain_axis, 1))(traces, z)

    def write_back(z_final, gen):
        def one(tr, z, g):
            _z0, rebuild = split_ravel(sel_chm(tr))
            new_tr, _w, _rd, _bwd = tr.update(g, rebuild(z))
            return new_tr

        # out at axis 0 and moved after: a negative out_dims misplaces the
        # leaves that do not depend on the batch. Under a key, chain i
        # updates with the i-th of split(key, n), as the reference's does
        if keys.is_key(gen):
            new = torch.func.vmap(one, in_dims=(chain_axis, 1, 0))(traces, z_final,
                                                                   keys.split(gen, z_final.shape[1]))
        else:
            new = torch.func.vmap(lambda tr, z: one(tr, z, gen), in_dims=(chain_axis, 1),
                                  randomness="different")(traces, z_final)
        if chain_axis == 0:
            return new
        return pytree.tree_map(lambda v: torch.movedim(v, 0, chain_axis), new)

    return z_cols, ld_cols, write_back


def _zero_like_float(leaf):
    leaf = torch.as_tensor(leaf)
    return torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)


def selection_gradient(
    selection: Selection, trace: Trace, argdiffs: Argdiffs
) -> tuple[ChoiceMap, ChoiceMap]:
    """Value and gradient of the log-joint with respect to the selected
    choices, both shaped like the LAZILY filtered choice map (the lazy filter
    keeps the unselected leaves in the tree, inert: they read as absent and
    their gradient is zero).

    Returns ``(values, gradients)``; leaves that are not differentiable
    carry zero gradients of float dtype."""
    chm = trace.get_choices()
    target = chm.filter(selection)
    frozen = chm.filter(~selection)
    z0, rebuild = split_ravel(target)
    args = Diff.tree_primal(argdiffs)
    gen_fn = trace.get_gen_fn()
    gz = torch.func.grad(lambda z: gen_fn.assess(rebuild(z).merge(frozen), args)[0])(z0)
    return rebuild(z0), rebuild(gz, nongrad_fill=_zero_like_float)
