"""Bridge from ``@gen`` models to the fused column-layout sweeps.

Counterpart of ``genjax_tpu/kernels/model_interface.py``: ``ColumnPacker``,
``column_logdensity``, ``column_hmc`` (a diagonal metric, or with
``mass="dense"`` a full one) and ``column_nuts``, each with the windowed
warmup, and the prior-initialised column samplers ``column_chees``,
``column_pt`` and ``column_svgd``. Each makes its chains on the card unless
the caller asks for the CPU, from the reference's start for an int seed
(``init_columns``; ``column_hmc`` and ``column_nuts`` with ``rng="rbg"``,
which else start from ``prior_generator``). Positions
are packed chains-on-the-last-axis: ``(D, N)`` with ``D`` the flattened
dimension of the selected addresses padded to a multiple of 8. Padding
dimensions carry an independent standard-normal density (see
``column_logdensity``): flat padding directions random-walk and never
U-turn, so they must not be made flat.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from ..core import keys
from ..core.device import chain_generator, entry_device, same_device, stream_seed
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..generative.mask import Mask
from ..generative.trace import trace_device
from .bodies import body_for
from .chees import chees_hmc
from .dense_mass import hmc_sweep_dense_cols, warmup_column_dense
from .hmc import pallas_hmc, warmup_column
from .nuts_pallas import pallas_nuts, warmup_column_nuts
from .pt import geometric_ladder, pt_hmc
from .staged import staging_scope
from .svgd import svgd


# The inverse mass of a padding row when a block packed from a trace batch's
# selection runs through a sweep kernel. Its momentum comes out 2**50 times
# larger, so a leapfrog moves the row by a part in 1e15 of its momentum's
# draw and the gradient does not change the momentum in float32: the row
# stays put, its kinetic energy is constant, and it adds nothing to the
# energy change or to a U-turn check. With a unit mass the rows would move
# under their standard-normal density and lengthen or shorten NUTS's trees.
PAD_INV_MASS = 2.0**-100


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _path(addr) -> tuple:
    return addr if isinstance(addr, tuple) else (addr,)


def _value(chm: ChoiceMap, path: tuple):
    v = chm.get_submap(*path).get_value()
    return v.value if isinstance(v, Mask) else v


class ColumnPacker:
    """Flatten/unflatten a set of addresses to/from a padded column vector.
    The shapes come from one ``simulate`` on ``device``: the chains', where
    given, else the arguments' (else the CPU), so that a model whose
    arguments or constants live on the card draws there."""

    def __init__(self, model, constraint, args, addresses: Sequence[Any], device=None):
        self.addresses = list(addresses)
        device = device if device is not None else trace_device(args) or torch.device("cpu")
        template = model.simulate(torch.Generator(device=device).manual_seed(0), args).get_choices()
        self.shapes = []
        offset = 0
        for addr in self.addresses:
            path = _path(addr)
            if constraint is not None and not constraint.get_submap(*path).static_is_empty():
                raise ValueError(
                    f"address {addr!r} is constrained — packing it as a "
                    "latent would silently override the observation"
                )
            shape = tuple(torch.as_tensor(_value(template, path)).shape)
            size = math.prod(shape)
            self.shapes.append((path, shape, offset, size))
            offset += size
        self.dim = offset
        self.padded_dim = max(_round_up(offset, 8), 8)

    def unpack(self, q) -> ChoiceMap:
        """(padded_dim,) -> ChoiceMap over the addresses."""
        chm = ChoiceMap.empty()
        for path, shape, offset, size in self.shapes:
            v = q[offset : offset + size]
            chm |= ChoiceMap.entry(v.reshape(shape) if shape else v[0], *path)
        return chm

    def pack(self, chm: ChoiceMap) -> torch.Tensor:
        """ChoiceMap -> (padded_dim,) float32 vector."""
        parts = [
            torch.as_tensor(_value(chm, path), dtype=torch.float32).reshape(size)
            for path, _shape, _offset, size in self.shapes
        ]
        flat = torch.cat(parts)
        return torch.nn.functional.pad(flat, (0, self.padded_dim - self.dim))

    # ---- columns in another order of the same addresses (a trace batch's
    # raveled selection, ``grad_view.column_view``), mapped by a row index

    def row_map(self, offsets: dict) -> list[int]:
        """Row ``i`` of the packed block is row ``rows[i]`` of a block in
        which address path ``p`` starts at row ``offsets[p]``."""
        rows = []
        for path, _shape, _offset, size in self.shapes:
            rows += range(offsets[path], offsets[path] + size)
        return rows

    def pack_columns(self, z: torch.Tensor, rows: list[int], gen: torch.Generator | None) -> torch.Tensor:
        """``z (dim, N)`` as a contiguous float32 ``(padded_dim, N)`` block in
        this packing, the padding rows fresh standard normals from ``gen``
        (the padding's density, ``column_logdensity``), or zeros where
        ``gen`` is None (the padding's mode, where a sweep that draws no
        momentum for it leaves it)."""
        shape = (self.padded_dim - self.dim, z.shape[1])
        pad = (torch.zeros(shape, device=z.device) if gen is None
               else torch.randn(shape, generator=gen, device=z.device))
        return torch.cat([z[rows].to(torch.float32), pad]).contiguous()

    def pack_inv_mass(self, inv_mass, rows: list[int], device) -> torch.Tensor:
        """An inverse mass over ``z``'s rows (None: ones), in this packing,
        with ``PAD_INV_MASS`` on the padding, which makes the padding rows
        inert: a sweep over the packed block then runs the chain of ``z``'s
        rows alone, as the twin does over ``z``."""
        if inv_mass is None:
            real = torch.ones(self.dim, device=device)
        else:
            real = torch.as_tensor(inv_mass, dtype=torch.float32, device=device).reshape(-1)[rows]
        return torch.cat([real, torch.full((self.padded_dim - self.dim,), PAD_INV_MASS, device=device)])

    def unpack_columns(self, q: torch.Tensor, rows: list[int]) -> torch.Tensor:
        """A packed block ``(..., padded_dim, N)`` back in ``z``'s row order
        ``(..., dim, N)``, the padding dropped."""
        z = torch.empty((*q.shape[:-2], self.dim, q.shape[-1]), dtype=q.dtype, device=q.device)
        z[..., rows, :] = q[..., : self.dim, :]
        return z


def packed_score(model, constraint, args, packer: ColumnPacker, q: torch.Tensor) -> torch.Tensor:
    """The model's log-joint at one packed column ``q (padded_dim,)`` under
    ``constraint`` and ``args``, the padding rows' standard normal added."""
    score, _ = model.assess(packer.unpack(q) | constraint, args)
    if packer.padded_dim > packer.dim:
        score = score - 0.5 * torch.sum(q[packer.dim :] ** 2)
    return score


def column_logdensity(model, constraint, args, packer: ColumnPacker):
    """The model's log-joint as a batched column function ``(D, N) -> (N,)``.

    The padding dimensions (``packer.dim .. padded_dim``) carry an
    independent standard-normal density, which leaves the marginal over the
    real dimensions unchanged. The returned callable's ``body`` attribute is
    the CUDA sweep's device body for this model and packing
    (``bodies.body_for``), or None."""

    def one(q):
        return packed_score(model, constraint, args, packer, q)

    batched = torch.func.vmap(one, in_dims=1)

    def logdensity_cols(q: torch.Tensor) -> torch.Tensor:
        return batched(q)

    logdensity_cols.body = body_for(model, constraint, args, packer.addresses)
    return logdensity_cols


def init_columns(model, constraint, args, packer: ColumnPacker, n_chains: int, seed, device):
    """``n_chains`` draws of ``model.generate`` under ``constraint``, packed
    as columns ``(padded_dim, n_chains)`` on ``device``. ``seed`` is a key
    on ``device`` or an int, read as ``key(seed)`` (threefry): chain ``i``
    generates under the ``i``-th of ``split(fold_in(key, 0xC0FFEE),
    n_chains)``, as the reference's column entry points start their chains;
    or a ``torch.Generator`` on ``device``, drawn from (``prior_generator``
    is the one an int seeds on the Philox path of ``column_hmc`` and
    ``column_nuts``)."""
    device = torch.device(device)
    if isinstance(seed, torch.Generator):
        gen = chain_generator(seed, device, "init_columns")

        def init_one(_):
            tr, _w = model.generate(gen, constraint, args)
            return packer.pack(tr.get_choices())

        dummy = torch.zeros(n_chains, device=device)
        return torch.func.vmap(init_one, randomness="different", out_dims=1)(dummy).contiguous()
    k = seed if keys.is_key(seed) else keys.key(seed, device=device)
    if not same_device(k.device, torch.device(device)):
        raise ValueError(f"init_columns: the key lives on {k.device} and the chains are made on {device}")
    return keyed_columns(model, constraint, args, packer, keys.split(keys.fold_in(k, 0xC0FFEE), n_chains))


def keyed_columns(model, constraint, args, packer: ColumnPacker, chain_keys: torch.Tensor) -> torch.Tensor:
    """The packed columns ``(padded_dim, N)`` of ``model.generate`` under
    each of ``chain_keys (N, w)``, on their device."""

    def init_one(k):
        tr, _w = model.generate(k, constraint, args)
        return packer.pack(tr.get_choices())

    return torch.func.vmap(init_one, out_dims=1)(chain_keys).contiguous()


def prior_generator(seed: int, device) -> torch.Generator:
    """The generator an int ``seed`` starts the chains of ``column_hmc``
    and ``column_nuts`` from on their Philox path, apart from every int32
    sweep seed."""
    return chain_generator((0xC0FFEE << 32) | (int(seed) & 0xFFFFFFFF), torch.device(device), "init_columns")


def tempered_factors(model, constraint, args, packer: ColumnPacker, device):
    """The prior and likelihood column densities of a ``@gen`` model in the
    column layout: the prior is the ``generate`` weight under the packed
    latents alone (the unconstrained data add nothing), the padding rows'
    standard normal in it; the likelihood is the joint minus the prior, so
    the padding cancels from it and contributes a factor 1 to the
    evidence."""
    joint_cols = column_logdensity(model, constraint, args, packer)
    n_pad = packer.padded_dim - packer.dim
    # the data the prior's generate samples are not scored: any stream does
    scratch = torch.Generator(device=device).manual_seed(0)

    def prior_one(q):
        _, w = model.generate(scratch, packer.unpack(q), args)
        if n_pad:
            w = w - 0.5 * torch.sum(q[packer.dim :] ** 2)
        return w

    prior_cols = torch.func.vmap(prior_one, in_dims=1, randomness="different")

    def lik_cols(q):
        return joint_cols(q) - prior_cols(q)

    return prior_cols, lik_cols


def packed_prior_draws(gen, model, constraint, args, packer: ColumnPacker, n: int, device):
    """``n`` prior draws of the packed latents ``(padded_dim, n)`` from
    ``model.generate`` under ``constraint``, the padding rows standard
    normal (the padding's prior factor)."""
    q = init_columns(model, constraint, args, packer, n, gen, device)
    n_pad = packer.padded_dim - packer.dim
    if n_pad:
        q[packer.dim :] = torch.randn((n_pad, n), generator=gen, device=device)
    return q


def _prior_columns(model, constraint, args, addresses, n_chains: int, seed, device):
    """The packer, the column log-density and ``n_chains`` prior-initialised
    columns on ``device`` (``init_columns`` of ``seed``)."""
    if constraint is None:
        constraint = ChoiceMap.empty()
    packer = ColumnPacker(model, constraint, args, addresses, device=device)
    logdensity_cols = column_logdensity(model, constraint, args, packer)
    return packer, logdensity_cols, init_columns(model, constraint, args, packer, n_chains, seed, device)


def _column_stream(rng: str | None, interpret: bool, mesh, entry: str):
    """Check the stream ``column_hmc`` and ``column_nuts`` were asked for:
    ``rng="rbg"`` takes no counter stream and no mesh."""
    if rng not in (None, "rbg"):
        raise ValueError(f"{entry}: rng must be None (the Philox stream) or 'rbg', got {rng!r}")
    if rng == "rbg" and interpret:
        raise ValueError(f"{entry}: interpret=True selects the counter stream; it cannot be combined with rng='rbg'")
    if rng == "rbg" and mesh is not None:
        raise ValueError(
            f"{entry}: rng='rbg' with mesh= is not reproduced: the reference's stream is not split over ranks "
            "(a key under mesh=, ROADMAP item 4's step 4); drop mesh= or rng"
        )


def _prior_start(seed: int, rng: str | None, device):
    """What ``init_columns`` draws the start of ``column_hmc`` and
    ``column_nuts`` from: the int itself on the rbg stream, the Philox
    path's ``prior_generator`` otherwise."""
    return seed if rng == "rbg" else prior_generator(seed, device)


def _shard_of(n_chains: int, seed: int, device, mesh, axis: str, entry: str):
    """``(chains, seed, device)`` of this rank: with ``mesh``, the rank's
    share of ``n_chains`` sharded over ``axis`` (which must divide it), a
    seed of its own (``stream_seed(seed, rank)``'s top 30 bits) and the
    rank's device; without, the arguments as they are."""
    if mesh is None:
        return n_chains, seed, entry_device(device, entry)
    size = mesh.axis_size(axis)
    if n_chains % size:
        raise ValueError(f"{entry}: n_chains={n_chains} must divide over {size} shards")
    return n_chains // size, stream_seed(seed, mesh.rank) >> 34, mesh.device


@staging_scope()
def column_hmc(
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    addresses: Sequence[Any],
    *,
    n_chains: int,
    n_steps: int,
    eps: float,
    L: int = 5,
    seed: int = 0,
    block_n: int | None = None,
    interpret: bool = False,
    backend: str = "auto",
    warmup: bool = False,
    inv_mass=None,
    mass: str = "diag",
    device="cuda",
    mesh=None,
    axis: str = "batch",
    rng: str | None = None,
):
    """Prior-initialized, MH-adjusted HMC over ``addresses`` in the column
    layout, on ``device``: the card by default; ``device="cpu"`` runs the
    plain twin on the CPU, and without a card the default raises. Returns
    ``(positions, accept_rate, packer)``; decode single chains with
    ``packer.unpack(positions[:, i])``.

    ``backend``, ``interpret`` and ``block_n`` are those of ``pallas_hmc``.
    ``warmup=True`` first adapts ``eps`` (from ``eps`` as its start) and the
    diagonal inverse mass with ``warmup_column``, whose phases take the same
    routing. On a CUDA device the default runs the CUDA sweep kernel on the
    model's hand-written device body (``kernels/bodies.py`` ``body_for``)
    where there is one, else on its column density staged into one
    (``kernels/staged.py``, staged once a call); a density that cannot be
    staged raises, and ``backend="torch"`` runs the plain twin on the card
    instead. ``interpret=True`` is the reference's
    name for the counter stream (``rng="counter"`` of the kernel and the
    twin): it chooses the random stream, not an interpret mode.

    ``rng`` is ``pallas_hmc``'s. ``None`` (the default) starts the chains
    from ``prior_generator(seed)`` and sweeps on the Philox stream (the
    twin's generator on the CPU). ``"rbg"`` draws what the reference's
    ``column_hmc(backend="xla")`` draws from ``seed`` (the path its
    ``"auto"`` takes for the flagship), draw for draw: the start of
    ``init_columns(seed)``, the warmup's phases and the main sweep on the
    rbg stream, through K1's rbg kernel on the card. It takes no ``mesh``
    and no ``interpret``.

    ``mass="dense"`` (with ``warmup=True``, and no ``inv_mass``) adapts a
    full covariance metric from the cross-chain spread
    (``dense_mass.warmup_column_dense``) and runs the dense sweep
    ``hmc_sweep_dense_cols``, torch products on ``device`` for which no kernel
    exists in either package: ``backend``, ``interpret`` and ``block_n`` do
    not apply to it.

    ``mesh`` (a ``parallel.Mesh``) shards the ``n_chains`` chains over its
    ``axis``: every rank of the axis calls ``column_hmc`` alike, runs its
    share on its device from a seed of its own, and the warmup adapts to
    every rank's chains; the positions returned are the rank's.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> from genjax_tpu_torch.kernels import column_hmc
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 1.0) @ "y"
    >>> q, accept, packer = column_hmc(
    ...     model, g.C["y"].set(2.0), (), ["mu"],
    ...     n_chains=256, n_steps=100, eps=0.5, L=5, seed=1, device="cpu",
    ... )
    >>> tuple(q.shape)   # (packed dims padded to a multiple of 8, chains)
    (8, 256)
    >>> bool(abs(q[0].mean() - 1.0) < 0.3)   # posterior mean = 1
    True
    """
    if mass not in ("diag", "dense"):
        raise ValueError(f"mass must be 'diag' or 'dense', got {mass!r}")
    if mass == "dense" and not warmup:
        raise ValueError(
            "mass='dense' requires warmup=True (the dense metric is estimated from the "
            "cross-chain spread during warmup)"
        )
    if mass == "dense" and inv_mass is not None:
        raise ValueError(
            "mass='dense' adapts its own full-covariance metric; inv_mass (a diagonal) "
            "cannot be combined with it"
        )
    if mesh is not None and mass == "dense":
        raise ValueError("column_hmc: mass='dense' estimates its metric on one device; it takes no mesh")
    _column_stream(rng, interpret, mesh, "column_hmc")
    n_chains, seed, device = _shard_of(n_chains, seed, device, mesh, axis, "column_hmc")
    packer, logdensity_cols, q0 = _prior_columns(model, constraint, args, addresses, n_chains,
                                                 _prior_start(seed, rng, device), device)
    if mass == "dense":
        q0, eps_d, cov_chol = warmup_column_dense(logdensity_cols, q0, seed, eps0=eps, L=L)
        q, accept = hmc_sweep_dense_cols(
            logdensity_cols, q0, seed, n_steps=n_steps, eps=eps_d, L=L, cov_chol=cov_chol
        )
        return q, accept, packer
    if warmup:
        q0, eps, inv_mass = warmup_column(logdensity_cols, q0, seed, eps0=eps, L=L, backend=backend,
                                          mesh=mesh, axis=axis, rng=rng)
    q, accept = pallas_hmc(
        logdensity_cols, q0, seed, n_steps=n_steps, eps=eps, L=L,
        block_n=block_n, interpret=interpret, backend=backend, inv_mass=inv_mass, rng=rng,
    )
    return q, accept, packer


@staging_scope()
def column_nuts(
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    addresses: Sequence[Any],
    *,
    n_chains: int,
    n_steps: int,
    eps: float,
    max_depth: int = 8,
    seed: int = 0,
    warmup: bool = False,
    inv_mass=None,
    block_n: int | None = None,
    interpret: bool = False,
    backend: str = "auto",
    device="cuda",
    mesh=None,
    axis: str = "batch",
    rng: str | None = None,
):
    """Prior-initialized No-U-Turn sampling over ``addresses`` in the column
    layout, on ``device``: the card by default; ``device="cpu"`` runs the
    plain twin on the CPU, and without a card the default raises. Returns
    ``(positions, accept_stat, mean_leapfrogs, packer)``.

    ``backend``, ``interpret`` and ``block_n`` are those of
    ``nuts_pallas.pallas_nuts``: on a CUDA device the default runs the CUDA
    NUTS kernel on the model's hand-written device body or its column
    density staged into one, as ``column_hmc`` does, and raises for a
    density that cannot be staged (``backend="torch"`` runs the plain twin
    there).
    ``warmup=True`` first adapts ``eps`` (from ``eps`` as its start) and the
    diagonal inverse mass with ``warmup_column_nuts``, whose phases take the
    same routing: on the card, one kernel launch per phase. ``mesh`` shards
    the chains as in ``column_hmc``. ``rng`` is ``pallas_nuts``'s:
    ``"rbg"`` draws what the reference's ``column_nuts`` draws from
    ``seed``, start, warmup and main sweep (its ``nuts_sweep_cols``), on
    K4's rbg kernel on the card; ``None`` keeps the Philox path, as
    ``column_hmc``'s.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> from genjax_tpu_torch.kernels import column_nuts
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 1.0) @ "y"
    >>> q, accept, leaps, packer = column_nuts(
    ...     model, g.C["y"].set(2.0), (), ["mu"],
    ...     n_chains=256, n_steps=20, eps=0.5, max_depth=5, seed=1, device="cpu",
    ... )
    >>> tuple(q.shape)
    (8, 256)
    >>> bool(abs(q[0].mean() - 1.0) < 0.3)   # posterior mean = 1
    True
    """
    _column_stream(rng, interpret, mesh, "column_nuts")
    n_chains, seed, device = _shard_of(n_chains, seed, device, mesh, axis, "column_nuts")
    packer, logdensity_cols, q0 = _prior_columns(model, constraint, args, addresses, n_chains,
                                                 _prior_start(seed, rng, device), device)
    if warmup:
        q0, eps, inv_mass = warmup_column_nuts(
            logdensity_cols, q0, seed, eps0=eps, max_depth=max_depth, backend=backend,
            block_n=block_n, mesh=mesh, axis=axis, rng=rng,
        )
    q, accept, leaps = pallas_nuts(
        logdensity_cols, q0, seed, n_steps=n_steps, eps=eps, max_depth=max_depth,
        inv_mass=inv_mass, block_n=block_n, interpret=interpret, backend=backend, rng=rng,
    )
    return q, accept, leaps, packer


def column_chees(
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    addresses: Sequence[Any],
    *,
    n_chains: int,
    n_warmup: int = 300,
    n_steps: int = 200,
    eps: float = 0.05,
    seed: int = 0,
    collect: bool = False,
    device="cuda",
    **chees_kwargs,
):
    """Prior-initialised ChEES-adaptive HMC over ``addresses`` in the column
    layout (``chees.chees_hmc``), on ``device``: the card by default,
    raising without one; ``device="cpu"`` runs on the CPU. Step size,
    diagonal mass and trajectory length adapt jointly from cross-chain
    statistics. An int ``seed`` draws what the reference's ``column_chees``
    draws from it: the start of ``init_columns(seed)`` and ``chees_hmc``'s
    stream of the int (``rng_impl`` among ``chees_kwargs``); a
    ``torch.Generator`` in its place draws both in law. Returns
    ``(positions, info, packer)``."""
    device = entry_device(device, "column_chees")
    packer, ld, q0 = _prior_columns(model, constraint, args, addresses, n_chains, seed, device)
    q, info = chees_hmc(
        ld, q0, seed, n_warmup=n_warmup, n_steps=n_steps, eps0=eps, collect=collect, **chees_kwargs
    )
    return q, info, packer


def column_svgd(
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    addresses: Sequence[Any],
    *,
    n_particles: int,
    n_steps: int,
    step_size: float = 0.15,
    seed: int = 0,
    device="cuda",
    **svgd_kwargs,
):
    """Prior-initialised SVGD over ``addresses`` (``svgd.svgd``): a
    deterministic particle flow to the posterior, on ``device`` (the card by
    default, raising without one; ``device="cpu"`` runs on the CPU). SVGD
    runs on the real dimensions only: padding rows are pinned at zero and
    left out of the kernel's distances, since inert padding directions
    inflate the RBF metric and weaken the repulsion. The flow draws nothing:
    an int ``seed`` gives the reference's start (``init_columns``), a
    generator one in law. Returns ``(positions (dim, n_particles),
    packer)``."""
    device = entry_device(device, "column_svgd")
    packer, ld, q0 = _prior_columns(model, constraint, args, addresses, n_particles, seed, device)
    pad = packer.padded_dim - packer.dim

    def ld_real(qr):
        return ld(torch.cat([qr, qr.new_zeros((pad, qr.shape[1]))]))

    q = svgd(ld_real, q0[: packer.dim], n_steps=n_steps, step_size=step_size, **svgd_kwargs)
    return q, packer


def column_pt(
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    addresses: Sequence[Any],
    *,
    n_chains: int,
    n_rungs: int = 6,
    betas=None,
    n_warmup: int = 300,
    n_steps: int = 200,
    eps: float = 0.05,
    L: int = 8,
    seed: int = 0,
    collect: bool = False,
    device="cuda",
    **pt_kwargs,
):
    """Prior-initialised parallel-tempering HMC over ``addresses``
    (``pt.pt_hmc``), on ``device`` (the card by default, raising without
    one; ``device="cpu"`` runs on the CPU): a geometric ladder of
    ``n_rungs`` inverse temperatures unless ``betas`` is given, with
    even-odd replica exchange, for multimodal posteriors. An int ``seed``
    draws what the reference's ``column_pt`` draws (the start of
    ``init_columns(seed)``, ``pt_hmc``'s stream of the int), a generator in
    law. Returns ``(cold_positions, info, packer)``."""
    device = entry_device(device, "column_pt")
    if betas is None:
        betas = geometric_ladder(n_rungs)
    packer, ld, q0 = _prior_columns(model, constraint, args, addresses, n_chains, seed, device)
    q, info = pt_hmc(
        ld, q0, seed, betas=betas, n_warmup=n_warmup, n_steps=n_steps, eps0=eps, L=L,
        collect=collect, **pt_kwargs,
    )
    return q, info, packer
