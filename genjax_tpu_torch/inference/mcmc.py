"""MCMC loops: Metropolis-Hastings over edit requests, and chain runners.

Counterpart of ``genjax_tpu/inference/mcmc.py``: ``mh``, ``run_chain``,
``run_chains`` and the batched sweep runners ``run_chains_hmc`` and
``run_chains_nuts``. A chain is a Python loop of edits, and many chains are
one ``torch.func.vmap`` over the trace batch. An entry point that receives
traces runs where they live, with a ``torch.Generator`` on the same device;
``run_chains``, which makes its chains, runs on the card unless asked for
the CPU.

Weight conventions (why ``mh`` treats ``Regenerate`` specially): a
``Regenerate`` edit returns the *joint*-density ratio as its weight, which a
round trip cancels, while the MH log-acceptance of a regenerate-from-prior
move is the *likelihood* ratio. ``mh`` subtracts the selected choices' score
change (by ``project``) to convert: alpha = w - [proj_new(sel) -
proj_old(sel)]. ``HMC`` already returns alpha as its weight.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core.device import entry_device, int_seed
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap, StaticChm, ValueChm
from ..generative.concepts import EditRequest, Regenerate
from ..generative.selection import Selection
from ..generative.trace import Trace, check_same_device, trace_device
from ..kernels.bodies import body_for, body_packing
from ..kernels.hmc import _route, pallas_hmc
from ..kernels.model_interface import ColumnPacker
from ..kernels.nuts_pallas import pallas_nuts
from .requests.grad_view import column_view
from .requests.hmc import mh_accept


def mh(
    gen: torch.Generator, trace: Trace, request: EditRequest | Selection
) -> tuple[Trace, Any]:
    """One Metropolis-Hastings step driven by an edit request (or a
    ``Selection``, shorthand for ``Regenerate(selection)``), on the trace's
    device. Returns ``(trace, accepted)``."""
    check_same_device(gen, trace, "mh")
    if isinstance(request, Selection):
        request = Regenerate(request)
    new_trace, w, _rd, _bwd = trace.edit(gen, request)
    if isinstance(request, Regenerate):
        sel = request.selection
        w = w - (new_trace.project(gen, sel) - trace.project(gen, sel))
    return mh_accept(gen, trace, new_trace, w)


@Pytree.dataclass
class MHChainResult(Pytree):
    """Final trace(s) plus per-step diagnostics."""

    trace: Trace
    accept_rate: Any
    history: Any  # pytree of recorded values per step (or None)


def run_chain(
    gen: torch.Generator,
    trace: Trace,
    request: EditRequest | Selection,
    n_steps: int,
    *,
    record: Callable[[Trace], Any] | None = None,
) -> MHChainResult:
    """Run ``n_steps`` of MH on one trace, where it lives. ``record(trace)``
    is kept for every step, stacked along a leading step axis."""
    accepts, history = [], []
    for _ in range(n_steps):
        trace, accepted = mh(gen, trace, request)
        accepts.append(accepted.to(torch.float32))
        if record is not None:
            history.append(record(trace))
    stacked = pytree.tree_map(lambda *xs: torch.stack(xs), *history) if history else None
    return MHChainResult(trace, torch.stack(accepts).mean(), stacked)


# ----------------------------------------------------------------------
# the batched sweep runner
# ----------------------------------------------------------------------


def _leaf_paths(chm: ChoiceMap, prefix: tuple = ()):
    """``(address path, value)`` of every leaf of a choice map of static and
    value nodes, in tree-flatten order; None for any other node."""
    if isinstance(chm, ValueChm):
        return [(prefix, chm.v)] if isinstance(chm.v, torch.Tensor) else None
    if isinstance(chm, StaticChm):
        out = []
        for key, sub in zip(chm.keys, chm.submaps):
            inner = _leaf_paths(sub, prefix + (key,))
            if inner is None:
                return None
            out += inner
        return out
    return None if not chm.static_is_empty() else []


class _KernelView:
    """A trace batch in the layout of the CUDA sweep kernels' device body.

    ``z`` from ``column_view`` ravels the selected choices in tree-flatten
    order, unpadded; a device body wants its own address order, padded to the
    packer's dimension. The packer (``ColumnPacker``) owns that layout: this
    finds the body, which exists only when the model has one for this
    selection (``kernels/bodies.py``), the traces take no arguments, and
    every chain's frozen complement is the same (the body carries one set of
    constants for all chains), and binds the packer's row map from ``z``."""

    def __init__(self, traces, selection: Selection, chain_axis: int, d: int):
        self.body = None
        self.chains_differ = False
        model = traces.get_gen_fn()
        order = body_packing(model)
        if order is None or pytree.tree_leaves(traces.get_args()):
            return
        choices = traces.get_choices()
        selected = _leaf_paths(choices.filter_eager(selection))
        frozen_chm = choices.filter_eager(~selection)
        if selected is None or sorted(p for p, _ in selected) != sorted(order):
            return
        # the frozen complement of chain 0, if every chain's equals it: one
        # reduction on the device and one host read
        first = pytree.tree_map(lambda v: v.select(chain_axis, 0), frozen_chm)
        same = [
            (v == v.select(chain_axis, 0).unsqueeze(chain_axis)).all()
            for v in pytree.tree_leaves(frozen_chm)
        ]
        if same and not bool(torch.stack(same).all()):
            self.chains_differ = True
            return
        packer = ColumnPacker(model, first, (), list(order))
        body = body_for(model, first, (), list(order))
        if body is None or packer.dim != d:
            return
        z_offset, offset = {}, 0
        for path, v in selected:
            z_offset[path] = offset
            offset += v.numel() // v.shape[chain_axis]
        self.body, self.packer, self.rows = body, packer, packer.row_map(z_offset)


# a sweep's int seed, drawn from a generator: one host read
_seed = int_seed


class _ColumnSweep:
    """The launch that the batched runners (``run_chains_hmc``,
    ``run_chains_nuts``) and ``sample_posterior(algorithm="hmc_sweep")``
    share: a trace batch's selected choices as one column block
    (``column_view``), the backend, and sweeps over the block.

    The backend is the samplers' (``hmc._route``): on the card ``"auto"``
    takes the CUDA kernel, which needs the batch's device body
    (``_KernelView``), and raises without one; ``"torch"``, and the CPU, run
    the plain twin over the GFI's own ``assess`` of each chain's frozen
    complement. The view is built once here, so a phase of many launches
    builds it once. A sweep runs on a block in the launch's layout
    (``start``): on the kernel the body's rows padded with fresh normals, on
    the twin ``z`` itself; ``finish`` maps a block, or a stack of draws of
    its ``real`` rows, back to ``z``'s order."""

    def __init__(self, traces, selection: Selection, chain_axis: int, backend: str, entry: str):
        device = trace_device(traces)
        self.z, self.ld_cols, self.write_back = column_view(traces, selection, chain_axis)
        view = None
        if backend == "cuda" or (backend == "auto" and device.type == "cuda"):
            view = _KernelView(traces, selection, chain_axis, self.z.shape[0])
            if view.body is None and view.chains_differ:
                raise ValueError(
                    f"{entry}: the chains' frozen choices differ, and the CUDA sweep kernel's "
                    "device body carries one set of constants for all chains. Pass "
                    "backend='torch' to run the plain torch twin over each chain's own."
                )
        self.backend = _route(backend, device, view is not None and view.body is not None)
        self.view = view if self.backend == "cuda" else None

    def start(self, gen: torch.Generator) -> torch.Tensor:
        return self.view.packer.pack_columns(self.z, self.view.rows, gen) if self.view else self.z

    def inv_mass(self, inv_mass):
        """An inverse mass over ``z``'s rows, in the launch's layout."""
        if not self.view:
            return inv_mass
        return self.view.packer.pack_inv_mass(inv_mass, self.view.rows, self.z.device)

    def sweep(self, sampler: Callable, q: torch.Tensor, seed: int, inv_mass, **kw):
        """``sampler`` (``pallas_hmc`` or ``pallas_nuts``) from ``q``, with
        ``inv_mass`` in the launch's layout: one launch on the kernel."""
        density = self.view.body if self.view else self.ld_cols
        return sampler(density, q, seed, backend=self.backend, inv_mass=inv_mass, **kw)

    def real(self, q: torch.Tensor) -> torch.Tensor:
        """The rows of a launch block that hold the selected choices."""
        return q[: self.view.packer.dim] if self.view else q

    def finish(self, q: torch.Tensor) -> torch.Tensor:
        return self.view.packer.unpack_columns(q, self.view.rows).to(self.z.dtype) if self.view else q


def run_chains_hmc(
    gen: torch.Generator,
    traces: Trace,
    selection: Selection,
    *,
    eps,
    L: int = 10,
    n_steps: int = 1,
    inv_mass: Any = None,
    chain_axis: int = 0,
    backend: str = "auto",
) -> tuple[Trace, Any]:
    """``n_steps`` of MH-adjusted HMC on a BATCH of traces, amortizing the
    trace machinery over the whole sweep: the fast path for the workload
    that ``run_chains(..., HMC(...))`` expresses one transition at a time.

    Same Markov chain as iterating ``mh(gen, tr, HMC(selection, eps, L))``
    (momentum refresh, ``L`` leapfrogs, MH accept on the selected choices,
    everything else frozen), restructured:

    - the selected choices of ALL chains are raveled once into a
      ``(d, n_chains)`` column block;
    - the sweep runs through ``kernels.hmc.pallas_hmc``, the routing of the
      column samplers;
    - the traces are rebuilt ONCE at the end by a vmapped ``Update`` edit,
      instead of once per transition.

    ``backend`` is ``pallas_hmc``'s. The traces run where they live. On the
    card the default ``"auto"`` launches the CUDA sweep kernel, which takes
    the density as a device body: a batch whose model, selection and frozen
    choices have one (``kernels/bodies.py``; the flagship
    ``hierarchical_regression`` over ``tau`` and ``w`` with the same ``y``
    frozen in every chain) runs it, and any other batch raises. With
    ``backend="torch"``, and on the CPU, the plain twin ``_reference_hmc``
    runs over the GFI's own ``assess`` of each chain's frozen complement, so
    any model composes and per-chain constraints are honored. The backend
    taken is recorded on ``run_chains_hmc.last_backend``.

    Args:
        traces: a batched trace pytree (from ``torch.func.vmap`` of
            ``generate``), chain axis at ``chain_axis`` on every leaf.
        selection: continuous choices to sample (same contract as ``HMC``).
        inv_mass: optional diagonal inverse mass over the raveled selected
            vector (shape ``(d,)``), as in the ``HMC`` request.

    Returns:
        ``(traces, accept_rate)``, in the layout of the input batch.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 1.0) @ "y"
    >>> obs = g.C["y"].set(2.0)
    >>> gen = torch.Generator().manual_seed(0)
    >>> trs = torch.func.vmap(
    ...     lambda _: model.generate(gen, obs, ())[0], randomness="different"
    ... )(torch.zeros(512))
    >>> trs, acc = g.run_chains_hmc(gen, trs, g.S["mu"], eps=0.6, L=5, n_steps=100)
    >>> bool(abs(trs.get_choices()["mu"].mean() - 1.0) < 0.15)  # post. mean 1
    True
    >>> bool(acc > 0.5)
    True
    """
    check_same_device(gen, traces, "run_chains_hmc")
    seed = _seed(gen)
    run = _ColumnSweep(traces, selection, chain_axis, backend, "run_chains_hmc")
    q, accept_rate = run.sweep(
        pallas_hmc, run.start(gen), seed, run.inv_mass(inv_mass), n_steps=n_steps, eps=eps, L=L
    )
    run_chains_hmc.last_backend = run.backend
    return run.write_back(run.finish(q), gen), accept_rate


run_chains_hmc.last_backend = None


def run_chains_nuts(
    gen: torch.Generator,
    traces: Trace,
    selection: Selection,
    *,
    eps,
    max_depth: int = 8,
    n_steps: int = 1,
    inv_mass: Any = None,
    chain_axis: int = 0,
    backend: str = "auto",
) -> tuple[Trace, Any, Any]:
    """``n_steps`` of NUTS on a BATCH of traces: the ``run_chains_hmc``
    pattern with NUTS as the dynamics, the same chain as iterating the
    ``NUTS`` edit request. The selected choices ravel once into a column
    block, one sweep runs through ``kernels.nuts_pallas.pallas_nuts``, and
    the traces are rebuilt by one vmapped ``Update`` at the end.

    The routing is ``run_chains_hmc``'s: on the card ``"auto"`` launches the
    CUDA NUTS kernel (K4) over the batch's device body, and a batch with
    none raises; ``backend="torch"``, and the CPU, run the twin
    ``nuts_sweep_cols`` over the GFI's own ``assess``. The backend taken is
    recorded on ``run_chains_nuts.last_backend``.

    Returns ``(traces, accept_stat, mean_leapfrogs)``, the traces in the
    layout of the input batch.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 1.0) @ "y"
    >>> obs = g.C["y"].set(2.0)
    >>> gen = torch.Generator().manual_seed(0)
    >>> trs = torch.func.vmap(
    ...     lambda _: model.generate(gen, obs, ())[0], randomness="different"
    ... )(torch.zeros(256))
    >>> trs, acc, leaps = g.run_chains_nuts(gen, trs, g.S["mu"], eps=0.5, n_steps=50)
    >>> bool(abs(trs.get_choices()["mu"].mean() - 1.0) < 0.2)
    True
    >>> bool(acc > 0.5) and bool(leaps >= 1.0)
    True
    """
    check_same_device(gen, traces, "run_chains_nuts")
    seed = _seed(gen)
    run = _ColumnSweep(traces, selection, chain_axis, backend, "run_chains_nuts")
    q, accept_stat, leaps = run.sweep(
        pallas_nuts, run.start(gen), seed, run.inv_mass(inv_mass), n_steps=n_steps, eps=eps,
        max_depth=max_depth,
    )
    run_chains_nuts.last_backend = run.backend
    return run.write_back(run.finish(q), gen), accept_stat, leaps


run_chains_nuts.last_backend = None


def generator_on(gen: torch.Generator | int, device: torch.device, entry: str) -> torch.Generator:
    """``gen`` if it is a generator on ``device``'s type, or a generator on
    ``device`` seeded with the int ``gen``; a generator elsewhere raises."""
    if not isinstance(gen, torch.Generator):
        return torch.Generator(device=device).manual_seed(int(gen))
    if gen.device.type != device.type:
        raise ValueError(
            f"{entry}: the generator lives on {gen.device} and the chains are to run on "
            f"{device}; pass device={gen.device.type!r} or a generator on {device}"
        )
    return gen


def run_chains(
    gen: torch.Generator | int,
    make_trace: Callable[[torch.Generator], Trace],
    request: EditRequest | Selection,
    n_steps: int,
    n_chains: int,
    *,
    record: Callable[[Trace], Any] | None = None,
    layout: str = "lanes",
    device="cuda",
) -> MHChainResult:
    """Many independent MH chains as one vmapped program, on ``device``: the
    card by default; ``device="cpu"`` runs on the CPU, and without a card
    the default raises. ``gen`` is a generator on that device, or an int
    that seeds one; ``make_trace(gen)`` makes one chain's initial trace.

    ``layout`` keeps the reference's signature. There ``"lanes"`` batches
    with the chain axis last inside the vmapped program, which fills the
    TPU's lanes with chains, and moves it back to the front on the way out;
    ``torch.func.vmap`` has no such layout to choose, so both values give
    the conventional chains-leading result (with a custom ``record``, the
    step axis follows the chain axis).
    """
    device = entry_device(device, "run_chains")
    gen = generator_on(gen, device, "run_chains")
    if layout not in ("lanes", "batch"):
        raise ValueError(f"layout must be 'lanes' or 'batch', got {layout!r}")

    def one(_):
        return run_chain(gen, make_trace(gen), request, n_steps, record=record)

    return torch.func.vmap(one, randomness="different")(torch.zeros(n_chains, device=device))
