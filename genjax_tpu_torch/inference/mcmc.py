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

import math
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.device import entry_device, int_seed, same_device
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap, StaticChm, ValueChm
from ..generative.concepts import EditRequest, Regenerate
from ..generative.selection import Selection
from ..generative.trace import Trace, check_same_device, trace_device
from ..generative.typecheck import check_generator
from ..kernels.bodies import body_for, body_packing
from ..kernels.hmc import _route, pallas_hmc
from ..kernels.model_interface import ColumnPacker, column_logdensity, packed_score
from ..kernels.nuts_pallas import pallas_nuts
from ..kernels.staged import scope_store, stage_body
from .requests.grad_view import column_view
from .requests.hmc import mh_accept


def mh(
    gen: torch.Generator, trace: Trace, request: EditRequest | Selection
) -> tuple[Trace, Any]:
    """One Metropolis-Hastings step driven by an edit request (or a
    ``Selection``, shorthand for ``Regenerate(selection)``), on the trace's
    device. Returns ``(trace, accepted)``. Under a key, the key splits in
    four as the reference's does: the edit, the two projections and the
    accept draw."""
    check_same_device(gen, trace, "mh")
    if isinstance(request, Selection):
        request = Regenerate(request)
    if keys.is_key(gen):
        k_edit, k_proj_new, k_proj_old, k_acc = keys.split(gen, 4).unbind(-2)
    else:
        k_edit = k_proj_new = k_proj_old = k_acc = gen
    new_trace, w, _rd, _bwd = trace.edit(k_edit, request)
    if isinstance(request, Regenerate):
        sel = request.selection
        w = w - (new_trace.project(k_proj_new, sel) - trace.project(k_proj_old, sel))
    return mh_accept(k_acc, trace, new_trace, w)


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
    is kept for every step, stacked along a leading step axis. Under a key,
    step ``t`` takes the ``t``-th of ``split(key, n_steps)``, as the
    reference's scan does."""
    accepts, history = [], []
    steps = keys.split(gen, n_steps).unbind(-2) if keys.is_key(gen) else [gen] * n_steps
    for step_gen in steps:
        trace, accepted = mh(step_gen, trace, request)
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


_TWIN = "Pass backend='torch' to run the plain torch twin over each chain's own choices on the card."
# an integer chain operand travels as float32, exact up to this magnitude
_EXACT_INT = 2**24


def _refuse(entry: str, what: str) -> ValueError:
    return ValueError(f"{entry}: {what}, so the CUDA sweep kernels have no device body for it. {_TWIN}")


def _integer(v: torch.Tensor) -> bool:
    return not (v.is_floating_point() or v.dtype == torch.bool)


def chain_varying(leaves: list, chain_axis: int, entry: str = "run_chains_hmc") -> list[int]:
    """The indices of the tensor ``leaves`` (a batch's frozen choices and
    arguments, chain axis at ``chain_axis``) that differ between chains:
    one reduction each on the device (NaN equals NaN), and for an integer
    leaf one more for its magnitude, read to the host at once. An integer
    leaf that differs and exceeds 2^24 in magnitude raises: as a chain
    operand it travels as float32."""
    return _sort_leaves(leaves, chain_axis, entry, ())[0]


def _equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise equality in which NaN equals NaN."""
    same = a == b
    return same | (a.isnan() & b.isnan()) if a.is_floating_point() else same


def _sort_leaves(leaves: list, chain_axis: int, entry: str, kept) -> tuple[list[int], bool]:
    """``chain_varying``, and in the same host read whether chain 0 of each
    leaf of ``kept`` (pairs of an index and the value it is compared with)
    equals that value."""
    tensors = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor)]
    flags = []
    for i in tensors:
        v = leaves[i]
        flags.append(_equal(v, v.select(chain_axis, 0).unsqueeze(chain_axis)).all())
        if _integer(v):
            flags.append((v.abs() > _EXACT_INT).any())
    flags += [_equal(leaves[i].select(chain_axis, 0), value).all() for i, value in kept]
    read = iter(torch.stack(flags).tolist() if flags else [])
    varying = []
    for i in tensors:
        differs = not next(read)
        if _integer(leaves[i]) and next(read) and differs:
            raise _refuse(entry, f"a frozen integer choice or argument that differs between chains exceeds "
                                 f"{_EXACT_INT} in magnitude, past float32's exact integers")
        if differs:
            varying.append(i)
    return varying, all(read)


def _chain_density(model, packer: ColumnPacker, leaves: list, spec, varying: list):
    """The model's column density over one chain's frozen choices and
    arguments with chain operands: ``(q (D, N), c (k, N)) -> (N,)``, the
    leaves at ``varying`` (index, shape, dtype) rebuilt from consecutive
    rows of each chain's ``c``, every other leaf as ``leaves`` holds it."""

    def one(q, c):
        vals, row = list(leaves), 0
        for i, shape, dtype in varying:
            size = math.prod(shape)
            vals[i] = c[row : row + size].reshape(shape).to(dtype)
            row += size
        frozen, args = pytree.tree_unflatten(vals, spec)
        return packed_score(model, frozen, args, packer, q)

    return torch.func.vmap(one, in_dims=(1, 1))


class _KernelView:
    """A trace batch in the layout of the CUDA sweep kernels' device body.

    ``z`` from ``column_view`` ravels the selected choices in tree-flatten
    order, unpadded; a device body takes its packer's rows
    (``ColumnPacker``), padded, and the view binds the packer's row map from
    ``z``. The body is the model's hand-written one (``kernels/bodies.py``)
    where it applies (the traces take no arguments, the selection is the
    body's addresses, and every chain's frozen complement is the same), else
    the model's column density (``packed_score``, as ``column_hmc`` builds
    it) over chain 0's frozen choices and arguments, staged
    (``kernels/staged.py``). Each frozen and argument leaf is sorted by one
    reduction on the device, all of them read to the host at once: a leaf
    equal along the chain axis is a constant of the staged program (so a
    batch whose leaves are all equal stages the program ``column_hmc``
    stages), a leaf that differs becomes rows of the chain operands, a
    ``(k, N)`` float32 block (integers and booleans as float32) bound to
    the body. The staging is kept for a ``staging_scope`` (``sample_posterior``
    opens one) under what decides the program: the model, the selected
    paths and shapes, and every leaf's shape and dtype; a later view of the
    scope reuses it where the same leaves are chain operands and chain 0 of
    every other leaf holds the values folded into it (compared in the
    sort's host read), and stages again where not. Raises, naming the reason and ``backend='torch'``,
    where no body can be made: selected choices that are not static
    addresses of continuous values, an integer chain operand past 2^24,
    and the stager's refusals (an op outside its set, ``D`` beyond
    ``MAX_D``, a collective)."""

    def __init__(self, traces, selection: Selection, chain_axis: int, d: int, entry: str = "run_chains_hmc"):
        model = traces.get_gen_fn()
        choices = traces.get_choices()
        selected = _leaf_paths(choices.filter_eager(selection))
        if selected is None:
            raise _refuse(entry, "the selected choices are not static addresses (an indexed, masked or "
                                 "switched choice map), which a packed column block needs")
        if not selected or not all(v.is_floating_point() for _, v in selected):
            raise _refuse(entry, "the selection holds no choice, or a discrete one")
        paths = [p for p, _ in selected]
        device = selected[0][1].device  # where the model is staged: the choices' own
        z_offset, offset = {}, 0
        for path, v in selected:
            z_offset[path] = offset
            offset += v.numel() // v.shape[chain_axis]
        leaves, spec = pytree.tree_flatten((choices.filter_eager(~selection), traces.get_args()))
        tensors = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor)]
        first = [v.select(chain_axis, 0) if isinstance(v, torch.Tensor) else v for v in leaves]
        # a batch's model is remade with its traces: its structure (static
        # fields, the body's function) names it; with the selection, the
        # shapes and the dtypes (and any leaf that is no tensor) it decides
        # the program, and the values of the tensor leaves folded into it
        # are checked at a hit, in the sort's host read
        store = scope_store()
        key = ("trace path", str(pytree.tree_structure(model)), tuple(paths),
               tuple(tuple(v.shape) for _, v in selected), str(spec),
               tuple((tuple(first[i].shape), str(first[i].dtype)) if i in tensors else repr(v)
                     for i, v in enumerate(first)), str(device))
        kept = store.get(key) if store is not None else None  # (varying, constants, body)
        varying, same = _sort_leaves(leaves, chain_axis, entry, kept[1] if kept else ())
        frozen0, args0 = pytree.tree_unflatten(first, spec)
        self.body = None
        order = body_packing(model)
        if order is not None and not varying and not pytree.tree_leaves(args0) and sorted(paths) == sorted(order):
            packer = ColumnPacker(model, frozen0, (), list(order))
            body = body_for(model, frozen0, (), list(order))
            if body is not None and packer.dim == d:
                self.body, self.packer = body, packer
        if self.body is None:
            self.packer = packer = ColumnPacker(model, frozen0, args0, paths, device=device)
            chain = None
            if varying:
                n = selected[0][1].shape[chain_axis]
                chain = torch.cat([leaves[i].movedim(chain_axis, -1).reshape(-1, n).to(torch.float32)
                                   for i in varying]).contiguous()
            if kept and kept[0] == varying and same:
                body = kept[2]
            else:
                if chain is None:
                    density = column_logdensity(model, frozen0, args0, packer)
                else:
                    density = _chain_density(model, packer, first, spec,
                                             [(i, tuple(first[i].shape), first[i].dtype) for i in varying])
                body = stage_body(density, packer.padded_dim, device=device, chain=chain)
                if store is not None:
                    store[key] = (varying, [(i, first[i].clone()) for i in tensors if i not in varying], body)
            self.body = body if chain is None else body.bind(chain)
        self.rows = self.packer.row_map(z_offset)


# a sweep's int seed, drawn from a generator: one host read
_seed = int_seed


def key_seed(key: torch.Tensor, data=None) -> int:
    """A sweep's int seed drawn from a key as the reference draws it,
    ``randint(key, (), 0, 2**30)`` (of ``fold_in(key, data)`` where ``data``
    is given): one host read."""
    return int(keys.randint(key if data is None else keys.fold_in(key, data), (), 0, 2**30))


class _ColumnSweep:
    """The launch that the batched runners (``run_chains_hmc``,
    ``run_chains_nuts``) and ``sample_posterior(algorithm="hmc_sweep")``
    share: a trace batch's selected choices as one column block
    (``column_view``), the backend, and sweeps over the block.

    The backend is the samplers' (``hmc._route``): on the card ``"auto"``
    takes the CUDA kernel over the batch's device body (``_KernelView``:
    the hand-written one, else the model staged with each chain's own
    frozen choices and arguments as chain operands), and raises where none
    can be made; ``"torch"``, and the CPU, run the plain twin over the
    GFI's own ``assess`` of each chain's frozen complement. The view is
    built once here, so a phase of many launches builds it once, and the
    body it runs is named by ``body_name``. A sweep runs on a block in the launch's layout
    (``start``): on the kernel the body's rows padded with fresh normals
    (with zeros on the rbg stream, which draws nothing for them), on the
    twin ``z`` itself; ``finish`` maps a block, or a stack of draws of its
    ``real`` rows, back to ``z``'s order. On the rbg stream (``rng="rbg"``,
    the keyed drivers) the kernel draws each launch row as the reference
    draws the row of ``z`` it holds (``stream_rows``), so the kernel, the
    twin and the reference's XLA twin draw alike."""

    def __init__(self, traces, selection: Selection, chain_axis: int, backend: str, entry: str):
        device = trace_device(traces)
        self.z, self.ld_cols, self.write_back = column_view(traces, selection, chain_axis)
        view = None
        if backend == "cuda" or (backend == "auto" and device.type == "cuda"):
            view = _KernelView(traces, selection, chain_axis, self.z.shape[0], entry)
        self.backend = _route(backend, device)
        self.view = view if self.backend == "cuda" else None
        self.body_name = self.view.body.name if self.view else None

    def start(self, gen: torch.Generator | None) -> torch.Tensor:
        """The block a sweep starts from; ``gen`` draws the kernel's padding
        rows (None: zeros, for the rbg stream)."""
        return self.view.packer.pack_columns(self.z, self.view.rows, gen) if self.view else self.z

    def inv_mass(self, inv_mass):
        """An inverse mass over ``z``'s rows, in the launch's layout."""
        if not self.view:
            return inv_mass
        return self.view.packer.pack_inv_mass(inv_mass, self.view.rows, self.z.device)

    def stream_rows(self) -> list[int] | None:
        """The row of ``z`` each launch row draws on the rbg stream (-1 for
        the padding); None where the launch block is ``z``."""
        if not self.view:
            return None
        packer = self.view.packer
        return list(self.view.rows) + [-1] * (packer.padded_dim - packer.dim)

    def sweep(self, sampler: Callable, q: torch.Tensor, seed: int, inv_mass, rng: str | None = None, **kw):
        """``sampler`` (``pallas_hmc`` or ``pallas_nuts``) from ``q``, with
        ``inv_mass`` in the launch's layout: one launch on the kernel. With
        ``rng="rbg"`` the sweep draws the reference twin's keyed stream from
        the int ``seed``."""
        density = self.view.body if self.view else self.ld_cols
        if rng == "rbg":
            kw = dict(kw, rng="rbg", stream_rows=self.stream_rows())
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
    card the default ``"auto"`` launches the CUDA sweep kernel (K1), which
    takes the density as a device body (``_KernelView``): the model's
    hand-written one where it applies (the flagship
    ``hierarchical_regression`` over ``tau`` and ``w`` with the same ``y``
    frozen in every chain, ``kernels/bodies.py``), else the model's column
    density staged (``kernels/staged.py``), every frozen choice and argument
    that differs between chains read by each chain from its own chain
    operands; a batch whose density cannot be staged raises, naming why.
    With ``backend="torch"``, and on the CPU, the plain twin
    ``_reference_hmc`` runs over the GFI's own ``assess`` of each chain's
    frozen complement. The backend taken is recorded on
    ``run_chains_hmc.last_backend``, and the device body the kernel ran on
    ``run_chains_hmc.last_body`` (``"hier_regression"``, ``"staged"``;
    None on the twin).

    ``gen`` is a ``torch.Generator`` on the traces' device, or a PRNG key
    (``core/keys.py``). Under a key it draws what the reference's
    ``run_chains_hmc`` draws: ``k_sweep, k_upd = split(key)``, the sweep
    seeded ``randint(k_sweep, (), 0, 2**30)`` (one host read) on the rbg
    stream (K1's rbg kernel on the card, the twin's rbg stream elsewhere),
    and the traces rebuilt under ``k_upd``.

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
    gen, seed, k_upd, rng = _sweep_stream(gen, "run_chains_hmc")
    run = _ColumnSweep(traces, selection, chain_axis, backend, "run_chains_hmc")
    q, accept_rate = run.sweep(
        pallas_hmc, run.start(gen), seed, run.inv_mass(inv_mass), rng=rng, n_steps=n_steps, eps=eps, L=L
    )
    run_chains_hmc.last_backend, run_chains_hmc.last_body = run.backend, run.body_name
    return run.write_back(run.finish(q), k_upd), accept_rate


run_chains_hmc.last_backend = None
run_chains_hmc.last_body = None


def _sweep_stream(gen, entry: str):
    """A batched driver's stream: ``(generator for the padding, seed, the
    write-back's generator or key, rng)``. A generator draws the seed (the
    production stream); a key splits into ``k_sweep, k_upd`` and seeds the
    rbg stream from ``k_sweep``, as the reference does."""
    if keys.is_key(gen):
        k_sweep, k_upd = keys.split(gen).unbind(-2)
        return None, key_seed(k_sweep), k_upd, "rbg"
    check_generator(gen, entry)
    return gen, _seed(gen), gen, None


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
    CUDA NUTS kernel (K4) over the batch's device body, hand-written or
    staged with each chain's own chain operands, and a batch whose density
    cannot be staged raises; ``backend="torch"``, and the CPU, run the twin
    ``nuts_sweep_cols`` over the GFI's own ``assess``. The backend taken is
    recorded on ``run_chains_nuts.last_backend``, the body on
    ``run_chains_nuts.last_body``. Under a key it draws what the reference's
    ``run_chains_nuts`` draws, as ``run_chains_hmc`` does (K4's rbg kernel
    on the card).

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
    gen, seed, k_upd, rng = _sweep_stream(gen, "run_chains_nuts")
    run = _ColumnSweep(traces, selection, chain_axis, backend, "run_chains_nuts")
    q, accept_stat, leaps = run.sweep(
        pallas_nuts, run.start(gen), seed, run.inv_mass(inv_mass), rng=rng, n_steps=n_steps, eps=eps,
        max_depth=max_depth,
    )
    run_chains_nuts.last_backend, run_chains_nuts.last_body = run.backend, run.body_name
    return run.write_back(run.finish(q), k_upd), accept_stat, leaps


run_chains_nuts.last_backend = None
run_chains_nuts.last_body = None


def generator_on(gen: torch.Generator | int, device: torch.device, entry: str) -> torch.Generator:
    """``gen`` if it is a generator on ``device``'s type, or a generator on
    ``device`` seeded with the int ``gen``; a generator elsewhere raises, and
    so does a key (these entry points draw from generators only)."""
    if keys.is_key(gen):
        check_generator(gen, entry)
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
    the default raises. ``gen`` is a key or a generator on that device, or
    an int that seeds a generator; ``make_trace(gen)`` makes one chain's
    initial trace. Under a key, chain ``i`` takes the ``i``-th of
    ``split(key, n_chains)`` and splits it in two, for its initial trace and
    its steps, as the reference's chains do.

    ``layout`` keeps the reference's signature. There ``"lanes"`` batches
    with the chain axis last inside the vmapped program, which fills the
    TPU's lanes with chains, and moves it back to the front on the way out;
    ``torch.func.vmap`` has no such layout to choose, so both values give
    the conventional chains-leading result (with a custom ``record``, the
    step axis follows the chain axis).
    """
    device = entry_device(device, "run_chains")
    if layout not in ("lanes", "batch"):
        raise ValueError(f"layout must be 'lanes' or 'batch', got {layout!r}")
    if keys.is_key(gen):
        if not same_device(gen.device, device):
            raise ValueError(
                f"run_chains: the key lives on {gen.device} and the chains are to run on {device}; "
                f"pass device={gen.device.type!r} or a key on {device}"
            )

        def one_keyed(k):
            k_init, k_run = keys.split(k).unbind(-2)
            return run_chain(k_run, make_trace(k_init), request, n_steps, record=record)

        return torch.func.vmap(one_keyed)(keys.split(gen, n_chains))
    gen = generator_on(gen, device, "run_chains")

    def one(_):
        return run_chain(gen, make_trace(gen), request, n_steps, record=record)

    return torch.func.vmap(one, randomness="different")(torch.zeros(n_chains, device=device))
