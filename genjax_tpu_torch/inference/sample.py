"""``sample_posterior`` and ``sample_logdensity``: the one-call sampling
drivers.

Counterpart of ``genjax_tpu/inference/sample.py``: make a batch of chains
from the prior under the constraint, adapt over the warmup, draw thinned
samples, and report split-R̂ and ESS for each sampled parameter.

- ``"nuts"`` (the default) and ``"hmc"`` are the per-transition trace path:
  each transition is one ``torch.func.vmap`` over the chain batch of
  ``NUTS.edit_with_info`` or ``mh(HMC)``. There is no kernel on this path;
  NUTS integrates a fixed ``2**max_depth - 1`` leaves a transition
  (``kernels.nuts.nuts_transition``).
- ``"hmc_sweep"`` is the throughput form of ``"hmc"``, the same chain run
  batch-first over a column block (``mcmc._ColumnSweep``, the launch that
  ``run_chains_hmc`` uses): on the card one launch of the CUDA HMC kernel
  (K1) per warmup window and per draw, the traces rebuilt once a phase; a
  model without a hand-written device body is staged once a call.
- ``"chees"``, ``"pt"``, ``"dense_hmc"`` and ``"dense_nuts"`` are the column
  samplers over the selection packed by ``ColumnPacker``
  (``kernels.chees``, ``pt``, ``dense_mass`` and ``nuts``): torch on the
  chains' device, as the reference runs them as XLA, with no kernel.
- ``sample_logdensity`` runs ChEES on a raw column log-density.

Chains are made on ``device``, the card unless the caller asks for the CPU;
randomness comes from one ``torch.Generator`` on it, or from a PRNG key
(``core/keys.py``), under which every algorithm draws what the reference
draws from the same key. The trace-path
algorithms run their sampling in segments and, given ``checkpoint_dir``,
save the whole sampler state after the warmup and after every segment
(``io.save_segment_state``), so that a call with the same arguments resumes
where the last one stopped and returns the draws of the uninterrupted run bit
for bit. Each save writes the state the next segment starts from and that
segment's draws once, beside the earlier segments' (the reference rewrites
every draw so far at each save). ``mesh=`` shards the chains of every
algorithm over the ranks of a mesh axis.
"""

from __future__ import annotations

import hashlib
from typing import Any

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.device import entry_device, same_device, stream_seed, to_device
from ..core.diff import Diff
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..generative.mask import Mask
from ..generative.selection import Selection
from ..io import check_meta_matches, load_increments, load_segment_state, save_segment_state
from ..kernels.adaptation import cross_chain_inv_mass, multiplicative_nudge, windowed_warmup
from ..kernels.chees import chees_hmc
from ..kernels.dense_mass import hmc_sweep_dense_cols, warmup_column_dense
from ..kernels.hmc import pallas_hmc, phase_seed_base
from ..kernels.model_interface import ColumnPacker, column_logdensity, init_columns, keyed_columns
from ..kernels.nuts import nuts_sweep_cols
from ..kernels.pt import geometric_ladder, pt_hmc
from ..kernels.staged import staging_scope
from ..parallel.mesh import local_count, mesh_generators
from .diagnostics import ess, split_rhat
from .mcmc import _ColumnSweep, _seed, generator_on, key_seed, mh
from .requests.grad_view import column_view, split_ravel
from .requests.hmc import HMC
from .requests.nuts import NUTS

_TRACE_ALGORITHMS = ("nuts", "hmc", "hmc_sweep")
_COLUMN_ALGORITHMS = ("chees", "pt", "dense_hmc", "dense_nuts")


@Pytree.dataclass
class PosteriorSamples(Pytree):
    """Thinned posterior draws and convergence diagnostics.

    ``positions``: a choice map of the selected addresses, each value shaped
    ``(n_chains, n_samples, *event_shape)``. ``rhat``/``ess`` hold the same
    addresses' split-R̂ and bulk effective sample size, one for each element
    of the event. ``eps``/``inv_mass`` are the adapted kernel settings,
    ``inv_mass`` over the raveled selection.
    """

    positions: Any
    rhat: Any
    ess: Any
    accept_rate: Any
    divergence_rate: Any
    eps: Any
    inv_mass: Any

    @staticmethod
    def _read(tree, addr):
        path = addr if isinstance(addr, tuple) else (addr,)
        v = tree.get_submap(*path).get_value()
        return v.value if isinstance(v, Mask) else v

    def __getitem__(self, addr):
        """Draws at ``addr``: shape ``(n_chains, n_samples, *event)``."""
        return self._read(self.positions, addr)

    def rhat_of(self, addr):
        return self._read(self.rhat, addr)

    def ess_of(self, addr):
        return self._read(self.ess, addr)


def _column_diagnostics(draws: torch.Tensor, n_samples: int, mesh=None, axis: str = "batch"):
    """Split-R̂ and bulk ESS of each dimension of ``draws (chains, samples,
    dim)`` (every rank's chains, with ``mesh``): the one place the
    diagnostics' lag budget lives."""
    return (split_rhat(draws, mesh=mesh, axis=axis),
            ess(draws, max_lag=min(n_samples - 1, 64), mesh=mesh, axis=axis))


def _windows(n_warmup: int) -> list[int]:
    """The warmup's windows: up to 6, totalling exactly ``n_warmup``
    transitions, the first ``n_warmup % 6`` one longer."""
    n_windows = min(6, n_warmup)
    if n_windows == 0:
        return []
    base, rem = divmod(n_warmup, n_windows)
    return [base + (1 if i < rem else 0) for i in range(n_windows)]


def _positions(traces, selection: Selection) -> torch.Tensor:
    """The raveled selected choices of a chains-first trace batch: ``(N, d)``."""
    return column_view(traces, selection)[0].T


def _init_traces(gen, model, constraint, args, n_chains: int, device):
    """``n_chains`` traces of ``model.generate`` under ``constraint``, chains
    first, on ``device``; under a key, chain ``i`` generates from the
    ``i``-th of ``split(key, n_chains)``, as the reference's do."""
    constraint, args = to_device(constraint, device), to_device(args, device)
    if keys.is_key(gen):
        return torch.func.vmap(lambda k: model.generate(k, constraint, args)[0])(keys.split(gen, n_chains))
    return torch.func.vmap(
        lambda _: model.generate(gen, constraint, args)[0], randomness="different"
    )(torch.zeros(n_chains, device=device))


def _trace_step(gen, selection: Selection, algorithm: str, *, L: int, max_depth: int):
    """One transition of every chain of a trace batch at ``(eps,
    inv_mass)``: ``step(traces, eps, inv_mass, key=None) -> (traces,
    accept, divergence)``, the last two means over the chains. NUTS reports
    its accept statistic and divergences; HMC its MH accepts and no
    divergence. Every chain draws from ``gen``, or, given ``key``, chain
    ``i`` from the ``i``-th of ``split(key, n_chains)``, as the reference's
    transitions do."""

    def one(g, tr, eps, inv_mass):
        if algorithm == "nuts":
            request = NUTS(selection, eps, max_depth=max_depth, inv_mass=inv_mass)
            argdiffs = Diff.tree_diff_no_change(tr.get_args())
            new_tr, _w, _rd, _bwd, info = request.edit_with_info(g, tr, argdiffs)
            return new_tr, info.accept_prob, info.diverged.to(torch.float32)
        new_tr, accepted = mh(g, tr, HMC(selection, eps, L=L, inv_mass=inv_mass))
        accepted = accepted.to(torch.float32)
        return new_tr, accepted, torch.zeros_like(accepted)

    batched = torch.func.vmap(lambda tr, eps, inv_mass: one(gen, tr, eps, inv_mass), in_dims=(0, None, None),
                              randomness="different")
    keyed = torch.func.vmap(one, in_dims=(0, 0, None, None))

    def step(traces, eps, inv_mass, key=None):
        if key is None:
            traces, accs, divs = batched(traces, eps, inv_mass)
        else:
            n = pytree.tree_leaves(traces)[0].shape[0]
            traces, accs, divs = keyed(keys.split(key, n), traces, eps, inv_mass)
        return traces, accs.mean(), divs.mean()

    return step


def _warm(step, traces, selection: Selection, *, n_warmup: int, eps0, target_accept: float, mesh=None,
          axis: str = "batch", key=None):
    """The trace path's warmup: each window runs its transitions at the
    current settings, nudges ``eps`` toward ``target_accept`` by the
    window's mean accept, and takes the inverse mass from the cross-chain
    variance of the raveled selected choices (over every rank's chains
    with ``mesh``). ``eps`` stays on the device. Under ``key`` (the
    reference's ``k_warm``) window ``w`` takes the ``w``-th of
    ``split(key, n_windows)`` and splits it over its transitions."""
    z = _positions(traces, selection)
    eps = torch.tensor(eps0, dtype=torch.float32, device=z.device)
    inv_mass = torch.ones(z.shape[1], device=z.device)
    windows = _windows(n_warmup)
    wkeys = keys.split(key, len(windows)) if key is not None and windows else None
    for wi, n_steps in enumerate(windows):
        accs = []
        step_keys = keys.split(wkeys[wi], n_steps) if wkeys is not None else [None] * n_steps
        for kk in step_keys:
            traces, acc, _div = step(traces, eps, inv_mass, kk)
            accs.append(acc)
        acc = torch.stack(accs).mean()
        if mesh is not None:
            acc = mesh.all_reduce_mean(acc, axis)
        eps = multiplicative_nudge(eps, acc, target_accept=target_accept)
        inv_mass = cross_chain_inv_mass(_positions(traces, selection), chain_axis=0, mesh=mesh, axis=axis)
    return traces, eps, inv_mass


# the stream index of ``hmc_sweep``'s padding rows, past every draw's
_PAD_STREAM = 2**32 - 1
# the seed of draw ``s``'s stream: a function of the run's base seed and the
# draw's index alone, so that where a run is cut changes no draw
_draw_seed = stream_seed


def _sweep_seed(base: int, s: int) -> int:
    """Draw ``s``'s K1 sweep seed: the top 30 bits of its ``_draw_seed``,
    in the range of every int sweep seed (``_seed``)."""
    return _draw_seed(base, s) >> 34


def _draw(step, draw_gen: torch.Generator, traces, selection: Selection, *, lo: int, hi: int, base: int,
          thin: int, eps, inv_mass, sample_keys=None):
    """The trace path's sampling of draws ``lo .. hi - 1``: a draw of every
    chain each ``thin`` transitions, ``step`` drawing from ``draw_gen``,
    reseeded for each draw (``_draw_seed``), or under ``sample_keys`` (the
    reference's pre-split draw keys) from the ``thin`` keys of
    ``split(sample_keys[s], thin)`` for draw ``s``. Returns ``(traces, draws
    (N, hi - lo, d), accepts (hi - lo,), divergences (hi - lo,))``."""
    draws, accs, divs = [], [], []
    for s in range(lo, hi):
        if sample_keys is None:
            draw_gen.manual_seed(_draw_seed(base, s))
        a, dv = [], []
        for kk in (keys.split(sample_keys[s], thin) if sample_keys is not None else [None] * thin):
            traces, acc, div = step(traces, eps, inv_mass, kk)
            a.append(acc)
            dv.append(div)
        draws.append(_positions(traces, selection))
        accs.append(torch.stack(a).mean())
        divs.append(torch.stack(dv).mean())
    return traces, torch.stack(draws, dim=1), torch.stack(accs), torch.stack(divs)


def _warm_sweep(gen, traces, selection: Selection, *, n_warmup: int, eps0, L: int,
                target_accept: float, backend: str, mesh=None, axis: str = "batch"):
    """``"hmc_sweep"``'s warmup on one column block: one sweep (on the card
    one K1 launch) per window, the window's accept nudging ``eps`` (read to
    the host once a window, as the launch takes it) and the block's
    cross-chain variance giving the inverse mass; the traces are rebuilt
    once at the end. With ``mesh``, the accept and the mass are those of
    every rank's chains. Under a key (the reference's ``k_warm``) window
    ``w`` is seeded ``randint(fold_in(key, 3)) + w`` on the rbg stream and
    the traces are rebuilt under ``fold_in(key, 9)``, as the reference's
    are."""
    run = _ColumnSweep(traces, selection, 0, backend, "sample_posterior")
    eps = torch.tensor(eps0, dtype=torch.float32, device=run.z.device)
    inv_mass = torch.ones(run.z.shape[0], device=run.z.device)
    windows = _windows(n_warmup)
    if not windows:
        return traces, eps, inv_mass
    keyed = keys.is_key(gen)
    seed = key_seed(gen, 3) if keyed else _seed(gen)
    q = run.start(None if keyed else gen)
    for wi, n_steps in enumerate(windows):
        q, acc = run.sweep(pallas_hmc, q, seed + wi, run.inv_mass(inv_mass), rng="rbg" if keyed else None,
                           n_steps=n_steps, eps=float(eps), L=L)
        if mesh is not None:
            acc = mesh.all_reduce_mean(acc, axis)
        eps = multiplicative_nudge(eps, acc, target_accept=target_accept)
        inv_mass = cross_chain_inv_mass(run.finish(q), chain_axis=1, mesh=mesh, axis=axis)
    return run.write_back(run.finish(q), keys.fold_in(gen, 9) if keyed else gen), eps, inv_mass


def _draw_sweep(draw_gen: torch.Generator, traces, selection: Selection, *, lo: int, hi: int, base: int,
                thin: int, eps, inv_mass, L: int, backend: str, sample_keys=None):
    """``"hmc_sweep"``'s sampling of draws ``lo .. hi - 1`` on one column
    block: one sweep of ``thin`` steps per draw (on the card one K1 launch),
    seeded ``_sweep_seed(base, s)`` for draw ``s``, ``eps`` read and the
    inverse mass packed once for all of them; the draws are kept in the
    launch's layout and mapped back once, and the traces rebuilt once (from
    the stream of draw ``hi``). The block's padding rows (on the kernel) are
    drawn from the stream ``_PAD_STREAM``, the same in every segment: they
    are inert, so every segment starts them where a whole run keeps them.
    Under ``sample_keys`` (the reference's pre-split draw keys) draw ``s``
    is seeded ``randint(sample_keys[s])`` on the rbg stream (the segment's
    seeds read to the host at once), the padding starts at 0, and the traces
    are rebuilt under ``fold_in(sample_keys[hi - 1], 17)``, as the
    reference's are. Returns ``(traces, draws (N, hi - lo, d), accepts (hi -
    lo,))``."""
    run = _ColumnSweep(traces, selection, 0, backend, "sample_posterior")
    keyed = sample_keys is not None
    q = run.start(None if keyed else draw_gen.manual_seed(_draw_seed(base, _PAD_STREAM)))
    eps, inv_mass = float(eps), run.inv_mass(inv_mass)
    seeds = (keys.randint(sample_keys[lo:hi], (), 0, 2**30).tolist() if keyed
             else [_sweep_seed(base, s) for s in range(lo, hi)])
    draws, accs = [], []
    for seed in seeds:
        q, acc = run.sweep(pallas_hmc, q, seed, inv_mass, rng="rbg" if keyed else None, n_steps=thin, eps=eps,
                           L=L)
        draws.append(run.real(q))
        accs.append(acc)
    z = run.finish(torch.stack(draws))  # (hi - lo, d, N)
    upd = keys.fold_in(sample_keys[hi - 1], 17) if keyed else draw_gen.manual_seed(_draw_seed(base, hi))
    traces = run.write_back(z[-1], upd)
    return traces, z.permute(2, 0, 1), torch.stack(accs)


def _unraveler(traces, selection: Selection):
    """Maps raveled selected values ``(..., d)`` back onto the selection's
    choice map. Positions carry the sampled (differentiable) leaves only:
    the others are blanked, so the draws do not repeat chain 0's values."""
    template = pytree.tree_map(lambda v: v[0], traces.get_choices().filter_eager(selection))
    _z0, rebuild = split_ravel(template)
    return lambda z: rebuild(z, nongrad_fill=lambda _leaf: None)


def _finish_trace_result(traces, draws, accs, divs, selection: Selection, eps, inv_mass, mesh=None,
                         axis: str = "batch"):
    """Diagnostics of ``draws (N, n_samples, d)``, and the draws and
    diagnostics mapped back onto the selection's addresses. With ``mesh``,
    ``draws`` are this rank's chains, and the diagnostics and rates are
    those of every rank's."""
    if draws.shape[1] == 0:
        raise ValueError(
            "no sampling segments ran (max_segments=0 on a fresh run?) — nothing to return; run at "
            "least one segment"
        )
    rhat, ess_ = _column_diagnostics(draws, draws.shape[1], mesh, axis)
    if mesh is not None:
        accs, divs = mesh.all_reduce_mean(torch.stack([accs, divs]), axis)
    unravel = _unraveler(traces, selection)
    return PosteriorSamples(
        positions=unravel(draws),
        rhat=unravel(rhat.to(torch.float32)),
        ess=unravel(ess_.to(torch.float32)),
        accept_rate=accs.mean(),
        divergence_rate=divs.mean(),
        eps=eps,
        inv_mass=inv_mass,
    )


# ----------------------------------------------------------------------
# checkpointed resume of the trace-path algorithms
# ----------------------------------------------------------------------


def _state_hash(gen: torch.Generator) -> str:
    return hashlib.sha256(gen.get_state().numpy().tobytes()).hexdigest()[:16]


def _gen_state(gen) -> torch.Tensor:
    """What a checkpoint keeps of the caller's stream: a generator's state
    (after the base seed was drawn), or a key's words."""
    return gen.get_state() if isinstance(gen, torch.Generator) else gen.cpu()


def _key_on(key: torch.Tensor, device, mesh) -> torch.device:
    """The device of a keyed ``sample_posterior``: ``device``, where the key
    must live. The keyed path runs on one process; ``mesh=`` takes a
    generator."""
    if mesh is not None:
        raise ValueError(
            "sample_posterior: a key with mesh= is not reproduced (the sharded run draws each rank's "
            "stream from a generator); pass a torch.Generator, or drop mesh="
        )
    device = entry_device(device, "sample_posterior")
    if not same_device(key.device, device):
        raise ValueError(
            f"sample_posterior: the key lives on {key.device} and the chains are to run on {device}; "
            f"pass device={key.device.type!r} or a key on {device}"
        )
    return device


def _save_sampler_state(checkpoint_dir, traces, eps, inv_mass, base: int, gen_state, increment,
                        next_segment: int, n_done: int, *, run_identity: dict, group=None):
    """Checkpoint the sampler through the crash-safe segmented save
    (``io.save_segment_state``): the state the next segment starts from (the
    traces, the adapted ``eps`` and ``inv_mass``, the base seed of the
    draws' streams and the caller's generator's state after it was drawn),
    and ``increment``, the last segment's draws, accepts and divergences
    (None after the warmup), saved once beside it. The meta records the run
    identity, so that a resume with other dynamics is refused."""
    state = {"traces": traces, "eps": eps, "inv_mass": inv_mass, "base": torch.tensor(base),
             "gen_state": gen_state}
    meta = {"next_segment": int(next_segment), "n_done": int(n_done), "d": int(inv_mass.shape[0]),
            **run_identity}
    save_segment_state(checkpoint_dir, state, meta, increment=increment, group=group)


def _restore_sampler_state(checkpoint_dir, template_traces, gen: torch.Generator, bounds: list, n_local: int, *,
                           run_identity: dict, group=None):
    """The resume point: None where there is no checkpoint, else ``(traces,
    eps, inv_mass, base, increments, next_segment)``, ``increments`` the
    saved segments' ``(draws, accs, divs)`` in order, with ``gen`` set to
    the state it had when the checkpointed run drew ``base``. A checkpoint
    of another run is refused. The template's traces are the run's init
    program executed, so their structure is the run's."""
    device = next(v for v in pytree.tree_leaves(template_traces) if isinstance(v, torch.Tensor)).device

    def make_template(meta):
        check_meta_matches(checkpoint_dir, meta, run_identity)
        return {"traces": template_traces, "eps": torch.zeros((), device=device),
                "inv_mass": torch.zeros(meta["d"], device=device), "base": torch.tensor(0),
                "gen_state": torch.zeros_like(_gen_state(gen))}

    out = load_segment_state(checkpoint_dir, make_template, group=group)
    if out is None:
        return None
    state, meta = out
    if isinstance(gen, torch.Generator):
        gen.set_state(state["gen_state"])
    d = meta["d"]

    def increment_template(si):
        rows = bounds[si][1] - bounds[si][0]
        return {"draws": torch.zeros((n_local, rows, d), device=device), "accs": torch.zeros(rows, device=device),
                "divs": torch.zeros(rows, device=device)}

    increments = load_increments(checkpoint_dir, meta["next_segment"], increment_template, group=group)
    return (state["traces"], state["eps"], state["inv_mass"], int(state["base"]),
            [(i["draws"], i["accs"], i["divs"]) for i in increments], meta["next_segment"])


# ----------------------------------------------------------------------
# the column algorithms: chees, pt, dense_hmc, dense_nuts
# ----------------------------------------------------------------------


def _static_value_paths(chm, prefix=()):
    """Paths of every value-bearing node reachable through static address
    components (the ``ColumnPacker`` address contract)."""
    v = chm.get_value()
    if v is not None:
        if not prefix:
            raise ValueError(
                "sample_posterior column algorithms (chees/pt) need an ADDRESSED model (the "
                "selection resolved to a root value, e.g. a bare Distribution); use "
                "algorithm='nuts' or 'hmc'."
            )
        return [prefix if len(prefix) > 1 else prefix[0]]
    out = []
    for a in chm.static_addresses():
        out.extend(_static_value_paths(chm.get_submap(a), prefix + (a,)))
    if not out and not chm.static_is_empty():
        raise ValueError(
            "sample_posterior column algorithms (chees/pt) need a statically addressed "
            "selection (no scan/vmap index levels); use algorithm='nuts' or 'hmc' for "
            "indexed selections."
        )
    return out


def _column_prep(gen, model, constraint, args, selection: Selection, n_chains: int, device):
    """The column drivers' set-up: the selection resolved to packer paths
    (from the shapes of one trace simulated on ``device``, where the model's
    arguments and constants live), the column log-density, and ``n_chains``
    prior-initialised columns on ``device`` drawn from ``gen``, or under a
    key (the reference's ``k_init``) chain ``i`` from the ``i``-th of
    ``split(key, n_chains)``. Returns ``(packer, ld, q0)``."""
    constraint, args = to_device(constraint, device), to_device(args, device)
    shape_chm = model.simulate(torch.Generator(device=device).manual_seed(0), args).get_choices()
    paths = _static_value_paths(shape_chm.filter_eager(selection))
    packer = ColumnPacker(model, constraint, args, paths, device=device)
    ld = column_logdensity(model, constraint, args, packer)
    if keys.is_key(gen):
        return packer, ld, keyed_columns(model, constraint, args, packer, keys.split(gen, n_chains))
    return packer, ld, init_columns(model, constraint, args, packer, n_chains, gen, device)


def _column_result(draws_all, packer: ColumnPacker, n_samples: int, thin: int, *, accept_rate,
                   divergence_rate, eps, inv_mass, mesh=None, axis: str = "batch") -> PosteriorSamples:
    """The column drivers' results: every ``thin``-th of the collected
    ``(n_steps, padded_dim, N)`` draws unpacked per chain, and split-R̂/ESS
    over the real (unpadded) rows (every rank's chains, with ``mesh``)
    mapped onto the selection's addresses."""
    draws = draws_all[thin - 1 :: thin]  # (n_samples, padded_dim, N)
    unpack = torch.func.vmap(torch.func.vmap(packer.unpack))
    positions = unpack(draws.permute(2, 0, 1))  # (N, n_samples, ...) a leaf
    rhat, ess_ = _column_diagnostics(draws[:, : packer.dim, :].permute(2, 0, 1), n_samples, mesh, axis)
    pad = packer.padded_dim - packer.dim

    def unflatten(flat):
        return packer.unpack(torch.nn.functional.pad(flat.to(torch.float32), (0, pad)))

    return PosteriorSamples(
        positions=positions,
        rhat=unflatten(rhat),
        ess=unflatten(ess_),
        accept_rate=accept_rate,
        divergence_rate=divergence_rate,
        eps=eps,
        inv_mass=inv_mass,
    )


def _sample_chees(gen, packer, ld, q0, *, n_warmup, n_samples, thin, eps0, target_accept, mesh=None,
                  axis="batch"):
    _q, info = chees_hmc(
        ld, q0, gen, n_warmup=n_warmup, n_steps=n_samples * thin, eps0=eps0,
        target_accept=target_accept, collect=True, mesh=mesh, axis=axis,
    )
    return _column_result(
        info.draws, packer, n_samples, thin, accept_rate=info.accept_rate,
        divergence_rate=info.divergence_rate, eps=info.eps, inv_mass=info.inv_mass[: packer.dim],
        mesh=mesh, axis=axis,
    )


def _sample_dense(packer, ld, q0, *, warm, leftover_stream, run, n_warmup, n_samples, thin, eps0, L,
                  target_accept, mesh=None, axis="batch"):
    """The dense metric: up to 6 warmup phases and a remainder sweep,
    totalling exactly ``n_warmup`` transitions (``n_warmup=0`` keeps
    ``eps0`` and the identity metric). NaN trajectories are rejections, so
    ``divergence_rate`` is 0. ``warm`` roots the phases, ``leftover_stream``
    draws the remainder and ``run`` the sampling sweep: the reference's
    ``k_warm``, ``fold_in(k_warm, 999)`` and ``k_run`` under a key, the
    generator for each otherwise."""
    if n_warmup > 0:
        n_phases = min(6, n_warmup)
        steps_per_phase = n_warmup // n_phases
        leftover = n_warmup - n_phases * steps_per_phase
        q0, eps, cov_chol = warmup_column_dense(
            ld, q0, warm, n_phases=n_phases, steps_per_phase=steps_per_phase, eps0=eps0, L=L,
            target_accept=target_accept, mesh=mesh, axis=axis,
        )
        if leftover:
            q0, _acc = hmc_sweep_dense_cols(ld, q0, leftover_stream, n_steps=leftover, eps=eps, L=L,
                                            cov_chol=cov_chol, mesh=mesh, axis=axis)
    else:
        eps = torch.tensor(eps0, dtype=torch.float32, device=q0.device)
        cov_chol = torch.eye(q0.shape[0], device=q0.device)
    _q, accept, draws_all = hmc_sweep_dense_cols(
        ld, q0, run, n_steps=n_samples * thin, eps=eps, L=L, cov_chol=cov_chol, collect=True, mesh=mesh,
        axis=axis,
    )
    return _column_result(
        draws_all, packer, n_samples, thin, accept_rate=accept,
        divergence_rate=torch.zeros((), device=q0.device), eps=eps,
        inv_mass=torch.diagonal(cov_chol @ cov_chol.T)[: packer.dim], mesh=mesh, axis=axis,
    )


def _sample_dense_nuts(packer, ld, q0, *, warm, white_phase, white_run, rng, n_warmup, n_samples, thin, eps0,
                       max_depth, target_accept, mesh=None, axis="batch"):
    """Dense-metric NUTS by whitening (Stan's dense_e with NUTS): about half
    of ``n_warmup`` estimates the full covariance with dense HMC (L = 5), the
    cloud is whitened, and the rest adapts the white-space NUTS step size
    and diagonal mass; sampling runs column NUTS in white coordinates and
    maps the draws back. The returned ``eps`` is the white-space step size;
    ``inv_mass`` the metric's diagonal in the original space. ``warm`` roots
    the dense phases; white-space phase ``i`` draws ``white_phase(i)`` and
    the sampling sweep ``white_run`` on ``nuts_sweep_cols``'s stream ``rng``
    (under a key the reference's rbg seeds, else the generator)."""
    d = q0.shape[0]
    if n_warmup > 0:
        n_a = max(1, n_warmup // 2)
        n_phases_a = min(4, n_a)
        q0, _eps_hmc, cov_chol = warmup_column_dense(
            ld, q0, warm, n_phases=n_phases_a, steps_per_phase=max(1, n_a // n_phases_a), eps0=eps0,
            L=5, target_accept=target_accept, mesh=mesh, axis=axis,
        )
        n_b = max(1, n_warmup - n_a)
        n_phases_b = min(6, n_b)
    else:
        cov_chol = torch.eye(d, device=q0.device)
        n_b = n_phases_b = 0

    def white_ld(u):
        return ld(cov_chol @ u)

    u0 = torch.linalg.solve_triangular(cov_chol, q0, upper=False)
    if n_b:
        def sweep(u, idx, eps, inv_mass):
            u, acc, _leaps = nuts_sweep_cols(
                white_ld, u, white_phase(idx), n_steps=max(1, n_b // n_phases_b), eps=eps, max_depth=max_depth,
                inv_mass=inv_mass, rng=rng,
            )
            return u, acc

        u0, eps_w, inv_mass_w, _accs = windowed_warmup(
            sweep, u0, n_windows=n_phases_b, eps0=eps0, target_accept=target_accept, mesh=mesh, axis=axis
        )
    else:
        eps_w = torch.tensor(eps0, dtype=torch.float32, device=q0.device)
        inv_mass_w = torch.ones(d, device=q0.device)
    _u, acc, _leaps, draws_u, div = nuts_sweep_cols(
        white_ld, u0, white_run, n_steps=n_samples * thin, eps=float(eps_w), max_depth=max_depth,
        inv_mass=inv_mass_w, collect=True, rng=rng,
    )
    draws_all = torch.einsum("ij,sjn->sin", cov_chol, draws_u)  # q = L u
    if mesh is not None:
        acc, div = mesh.all_reduce_mean(torch.stack([acc, div]), axis)
    return _column_result(
        draws_all, packer, n_samples, thin, accept_rate=acc, divergence_rate=div, eps=eps_w,
        inv_mass=torch.diagonal(cov_chol @ cov_chol.T)[: packer.dim], mesh=mesh, axis=axis,
    )


def _sample_pt(gen, packer, ld, q0, *, n_warmup, n_samples, thin, eps0, L, target_accept, n_rungs, mesh=None,
               axis="batch"):
    """Parallel tempering: draws, ``eps``, ``inv_mass`` and ``accept_rate``
    of the cold rung. Non-finite proposals are rejections, never
    divergences, so ``divergence_rate`` is 0."""
    _q, info = pt_hmc(
        ld, q0, gen, betas=geometric_ladder(n_rungs), n_warmup=n_warmup, n_steps=n_samples * thin,
        eps0=eps0, L=L, target_accept=target_accept, collect=True, mesh=mesh, axis=axis,
    )
    return _column_result(
        info.draws, packer, n_samples, thin, accept_rate=info.accept_rate[0],
        divergence_rate=torch.zeros((), device=q0.device), eps=info.eps[0],
        inv_mass=info.inv_mass[0, : packer.dim], mesh=mesh, axis=axis,
    )


def _sample_columns(gen, model, constraint, args, selection, algorithm: str, n_chains: int, device, *, L: int,
                    n_rungs: int, max_depth: int, **kw) -> PosteriorSamples:
    """A column algorithm's run. Under a key, split as the reference's
    ``sample_posterior`` splits it: ChEES and PT ``k_init, k_run = split(key)``, the run
    rooted at ``k_run``; the dense algorithms ``k_init, k_warm, k_run =
    split(key, 3)``; the chains from ``split(k_init, n_chains)``. Else
    every part draws from the generator ``gen``."""
    keyed = keys.is_key(gen)
    if algorithm in ("chees", "pt"):
        k_init, k_run = keys.split_stream(gen)
        packer, ld, q0 = _column_prep(k_init, model, constraint, args, selection, n_chains, device)
        if algorithm == "chees":
            return _sample_chees(k_run, packer, ld, q0, **kw)
        return _sample_pt(k_run, packer, ld, q0, L=L, n_rungs=n_rungs, **kw)
    k_init, k_warm, k_run = keys.split_stream(gen, 3)
    packer, ld, q0 = _column_prep(k_init, model, constraint, args, selection, n_chains, device)
    if algorithm == "dense_hmc":
        leftover = keys.fold_in(k_warm, 999) if keyed else gen
        return _sample_dense(packer, ld, q0, warm=k_warm, leftover_stream=leftover, run=k_run, L=L, **kw)
    if keyed:
        seed_w = int(keys.randint(keys.fold_in(k_warm, 7), (), 0, 2**11))
        base_w = phase_seed_base(seed_w, "rbg")
        white = dict(white_phase=lambda idx: base_w + idx,
                     white_run=int(keys.randint(keys.fold_in(k_run, 7), (), 0, 2**30)), rng="rbg")
    else:
        white = dict(white_phase=lambda _idx: gen, white_run=gen, rng="generator")
    return _sample_dense_nuts(packer, ld, q0, warm=k_warm, max_depth=max_depth, **white, **kw)


@staging_scope()
def sample_posterior(
    gen: torch.Generator | int,
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    selection: Selection,
    *,
    n_chains: int = 1024,
    n_warmup: int = 300,
    n_samples: int = 100,
    thin: int = 1,
    algorithm: str = "nuts",
    eps0: float = 0.1,
    L: int = 8,
    max_depth: int = 8,
    target_accept: float = 0.8,
    n_rungs: int = 6,
    device="cuda",
    backend: str = "auto",
    mesh=None,
    axis: str = "batch",
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    max_segments: int | None = None,
) -> PosteriorSamples:
    """Sample ``p(selection | constraint)`` with adaptive NUTS, HMC, ChEES,
    parallel tempering or a dense metric.

    ``n_chains`` chains start from ``model.generate`` under ``constraint``
    on ``device``: the card by default; ``device="cpu"`` runs on the CPU,
    and without a card the default raises. ``gen`` is a ``torch.Generator``
    on that device, or an int that seeds one; the constraint's and the
    arguments' tensors are moved there.

    ``gen`` may also be a key on that device: the run then draws what the
    reference's draws from the same key, draw for draw. The trace
    algorithms split it ``k_init, k_warm, k_run = split(key, 3)``, the
    chains from ``split(k_init, n_chains)``, the warmup's windows and the
    pre-split draw keys of ``k_run`` (``"hmc_sweep"`` seeds its sweeps with
    ``randint`` of those keys on the rbg stream, K1's rbg kernel on the
    card). ``"chees"`` and ``"pt"`` split it ``k_init, k_run``, the sampler
    rooted at ``k_run``; ``"dense_hmc"`` and ``"dense_nuts"`` in three, the
    dense phases rooted at ``k_warm`` and ``"dense_nuts"``'s white-space
    NUTS on the rbg streams of ``randint`` draws of ``fold_in(k_warm, 7)``
    and ``fold_in(k_run, 7)``. A key with ``mesh=`` raises, naming a
    generator.

    Warmup: up to 6 windows totalling exactly ``n_warmup`` transitions
    (``n_warmup=0`` keeps ``eps0`` and the identity mass); each runs its
    transitions at the current settings, nudges the step size toward
    ``target_accept`` and takes the diagonal inverse mass from the
    cross-chain variance of the raveled selected choices. Sampling then
    records one draw each ``thin`` transitions.

    ``algorithm``:

    - ``"nuts"``: vmapped ``NUTS.edit_with_info`` over the chains, to
      ``max_depth``, recording its accept statistic and divergences;
    - ``"hmc"``: vmapped ``mh(HMC(selection, eps, L))``, divergence rate 0;
    - ``"hmc_sweep"``: the same chain as ``"hmc"`` run batch-first over a
      column block: on the card one launch of the CUDA HMC kernel (K1) per
      warmup window and per draw over the batch's device body, the
      hand-written one where the model has it, else its density staged once
      for the whole call (warmup, draws and every checkpoint segment, each
      chain's own frozen choices as chain operands); ``backend`` is that of
      ``run_chains_hmc`` (on the card ``"auto"`` launches K1 or raises,
      naming why, ``"torch"`` runs the plain twin over the GFI's
      ``assess``). Divergences surface as rejections (``divergence_rate``
      is 0).

    The column algorithms pack a statically addressed selection of an
    addressed model (else ``ValueError``) and run torch on ``device``, no
    kernel; each returns its own adapted settings:

    - ``"chees"``: ``kernels.chees_hmc``, trajectory length, step size and
      diagonal mass adapted jointly; ``target_accept`` is forwarded (ChEES's
      optimum is 0.651, this driver's default 0.8);
    - ``"pt"``: ``kernels.pt_hmc`` over an ``n_rungs`` geometric ladder, for
      multimodal posteriors; draws and settings of the cold rung,
      ``divergence_rate`` 0;
    - ``"dense_hmc"``: a full covariance metric from the cross-chain spread
      (``kernels.dense_mass``), up to 6 warmup phases and a remainder
      totalling ``n_warmup``; ``inv_mass`` is the metric's diagonal,
      ``divergence_rate`` 0;
    - ``"dense_nuts"``: about half the warmup estimates the covariance with
      dense HMC, the rest adapts column NUTS in whitened coordinates;
      ``eps`` is the white-space step size, ``inv_mass`` the metric's
      diagonal. ``n_warmup=0`` keeps ``eps0`` and the identity metric.

    Resume (the trace-path algorithms): with ``checkpoint_dir`` and
    ``checkpoint_every=k``, sampling runs in segments of ``k`` draws and
    the whole sampler state (the traces, the adapted ``eps``/``inv_mass``,
    the draws so far, the segment cursor, and the generator state the rest
    of the run reads) is saved after the warmup and after every segment.
    Called again with the same arguments and seed, the run resumes from the
    last saved segment, in the same process or a fresh one, and returns the
    draws of the uninterrupted run bit for bit: each draw's random stream
    is seeded from one base seed, drawn after the warmup, and the draw's
    index, so where the run is cut changes nothing (a run without a
    checkpoint is the same run). A checkpoint of other arguments or another
    seed (or key: the run identity records its words) is refused.
    ``max_segments`` bounds the new segments a call runs;
    a call that stops early returns the draws so far, and one that ran
    none raises. The column algorithms refuse ``checkpoint_dir``
    (``ValueError``).

    ``mesh`` (a ``parallel.Mesh``) shards the chains over its ``axis``,
    for every algorithm: every rank of the axis calls
    ``sample_posterior`` alike, with ``gen`` in the same state, and runs its
    ``n_chains / size`` chains on its device from a stream of its own
    (``parallel.mesh_generators``); the warmup adapts to every rank's
    chains, and the diagnostics and rates are every rank's. The draws
    returned are the rank's chains (``parallel.gather_batch`` rebuilds the
    whole). On the card, ``"hmc_sweep"`` launches K1 on each rank's shard as
    often as the unsharded call does. A checkpoint of a sharded run is
    saved by every rank under ``rank_<r>/`` (``io.save_segment_state``'s
    ``group``) and resumes bit for bit at the same world size. The column
    algorithms' adaptation (ChEES's trajectory, the tempered rungs' step
    sizes, the dense metric) reduces over every rank's chains.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> from genjax_tpu_torch.inference import sample_posterior
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 1.0) @ "y"
    >>> res = sample_posterior(
    ...     0, model, g.C["y"].set(2.0), (), g.S["mu"], n_chains=256, n_warmup=30,
    ...     n_samples=20, algorithm="hmc_sweep", eps0=0.1, L=5, device="cpu",
    ... )
    >>> tuple(res["mu"].shape)
    (256, 20)
    >>> bool(abs(res["mu"].mean() - 1.0) < 0.1)   # posterior mean 1
    True
    """
    if algorithm not in _TRACE_ALGORITHMS + _COLUMN_ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if checkpoint_dir is not None and algorithm not in _TRACE_ALGORITHMS:
        raise ValueError(
            "checkpoint_dir/resume is supported for the trace-path algorithms ('nuts'/'hmc'/'hmc_sweep'); "
            "the column algorithms (chees/pt/dense_hmc/dense_nuts) run warmup and sampling with no segment "
            "boundary to checkpoint at"
        )
    if n_samples <= 0:
        # before the warmup, which would otherwise run in full first
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    keyed = keys.is_key(gen)
    if keyed:
        device = _key_on(gen, device, mesh)
        n_local = n_chains
        seed_identity = (gen.tolist(), "key")
        k_init, k_warm, k_run = keys.split(gen, 3).unbind(-2)
    elif mesh is None:
        device = entry_device(device, "sample_posterior")
        gen = generator_on(gen, device, "sample_posterior")
        n_local = n_chains
        seed_identity = (int(gen.initial_seed()), _state_hash(gen))
    else:
        n_local = local_count(n_chains, mesh, axis, "n_chains")
        device = mesh.device
        # the run is named by the caller's generator, alike on every rank
        shared = generator_on(gen, device, "sample_posterior")
        seed_identity = (int(shared.initial_seed()), _state_hash(shared))
        _shared, gen = mesh_generators(shared, mesh, "sample_posterior")
    if algorithm in _COLUMN_ALGORITHMS:
        return _sample_columns(gen, model, constraint, args, selection, algorithm, n_local, device, L=L,
                               n_rungs=n_rungs, max_depth=max_depth, n_warmup=n_warmup, n_samples=n_samples,
                               thin=thin, eps0=eps0, target_accept=target_accept, mesh=mesh, axis=axis)
    seg_size = checkpoint_every if (checkpoint_dir is not None and checkpoint_every > 0) else n_samples
    # the whole run identity rides in the checkpoint's meta: a resume with
    # other dynamics (algorithm, step sizes, thin, seed, ...) is refused
    # rather than mixing two samplers; "layout" refuses the checkpoints that
    # saved every draw so far in each state
    run_identity = {
        "n_samples": int(n_samples), "seg_size": int(seg_size), "n_chains": int(n_chains),
        "n_warmup": int(n_warmup), "thin": int(thin), "algorithm": algorithm, "eps0": float(eps0),
        "L": int(L), "max_depth": int(max_depth), "target_accept": float(target_accept),
        "seed": seed_identity[0], "state_hash": seed_identity[1], "device": device.type,
        "backend": backend, "layout": "increments", "world": 1 if mesh is None else mesh.world_size,
    }
    bounds = [(lo, min(lo + seg_size, n_samples)) for lo in range(0, n_samples, seg_size)]
    traces = _init_traces(k_init if keyed else gen, model, constraint, args, n_local, device)
    restored = None
    if checkpoint_dir is not None:
        restored = _restore_sampler_state(checkpoint_dir, traces, gen, bounds, n_local, run_identity=run_identity,
                                          group=mesh)
    if restored is not None:
        traces, eps, inv_mass, base, parts, start_seg = restored
    else:
        if algorithm == "hmc_sweep":
            traces, eps, inv_mass = _warm_sweep(
                k_warm if keyed else gen, traces, selection, n_warmup=n_warmup, eps0=eps0, L=L,
                target_accept=target_accept, backend=backend, mesh=mesh, axis=axis,
            )
        else:
            traces, eps, inv_mass = _warm(
                _trace_step(gen, selection, algorithm, L=L, max_depth=max_depth), traces, selection,
                n_warmup=n_warmup, eps0=eps0, target_accept=target_accept, mesh=mesh, axis=axis,
                key=k_warm if keyed else None,
            )
        # every draw's stream is seeded from this and its index alone (under
        # a key, from the draw's own pre-split key)
        base = 0 if keyed else _seed(gen)
        parts, start_seg = [], 0
        if checkpoint_dir is not None:
            _save_sampler_state(checkpoint_dir, traces, eps, inv_mass, base, _gen_state(gen), None, 0, 0,
                                run_identity=run_identity, group=mesh)
    gen_state = _gen_state(gen)
    sample_keys = keys.split(k_run, n_samples) if keyed else None
    draw_gen = torch.Generator(device=device)
    step = _trace_step(draw_gen, selection, algorithm, L=L, max_depth=max_depth)
    for si in range(start_seg, len(bounds)):
        if max_segments is not None and si - start_seg >= max_segments:
            break
        lo, hi = bounds[si]
        if algorithm == "hmc_sweep":
            traces, d_i, a_i = _draw_sweep(
                draw_gen, traces, selection, lo=lo, hi=hi, base=base, thin=thin, eps=eps,
                inv_mass=inv_mass, L=L, backend=backend, sample_keys=sample_keys,
            )
            v_i = torch.zeros_like(a_i)
        else:
            traces, d_i, a_i, v_i = _draw(
                step, draw_gen, traces, selection, lo=lo, hi=hi, base=base, thin=thin, eps=eps,
                inv_mass=inv_mass, sample_keys=sample_keys,
            )
        parts.append((d_i, a_i, v_i))
        if checkpoint_dir is not None:
            _save_sampler_state(checkpoint_dir, traces, eps, inv_mass, base, gen_state,
                                {"draws": d_i, "accs": a_i, "divs": v_i}, si + 1, hi,
                                run_identity=run_identity, group=mesh)
    if parts:
        draws, accs, divs = (torch.cat(x, dim=dim) for x, dim in zip(zip(*parts), (1, 0, 0)))
    else:
        draws = eps.new_zeros((n_local, 0, inv_mass.shape[0]))
        accs = divs = eps.new_zeros(0)
    return _finish_trace_result(traces, draws, accs, divs, selection, eps, inv_mass, mesh, axis)


@Pytree.dataclass
class LogdensitySamples(Pytree):
    """Draws and diagnostics from ``sample_logdensity``. ``draws`` is
    ``(n_chains, n_samples, D)``; ``rhat``/``ess`` are per dimension."""

    draws: Any
    rhat: Any
    ess: Any
    accept_rate: Any
    divergence_rate: Any
    eps: Any
    inv_mass: Any


def sample_logdensity(
    gen: torch.Generator | torch.Tensor | int,
    logdensity_cols,
    q0,
    *,
    n_warmup: int = 300,
    n_samples: int = 100,
    thin: int = 1,
    eps0: float = 0.05,
    target_accept: float = 0.651,
) -> LogdensitySamples:
    """The one-call adaptive driver for a raw column log-density ``(D, N) ->
    (N,)``, for targets that do not come from a ``@gen`` model: ChEES-adaptive
    HMC (``kernels.chees_hmc``: step size, diagonal mass and trajectory
    length adapted jointly) from the start columns ``q0 (D, N)``, then
    ``n_samples`` draws each ``thin`` sweeps with split-R̂/ESS per dimension.

    It runs where ``q0`` lives and never moves it. ``gen`` is a key on that
    device or an int (``chees_hmc``'s ``key(gen, "rbg")``), under which the
    draws are the reference's ``sample_logdensity``'s from the same key, or a
    ``torch.Generator`` there, drawn from in law. The log-density's only
    contract is that autograd goes through it.

    >>> import torch
    >>> from genjax_tpu_torch.inference import sample_logdensity
    >>> ld = lambda q: -0.5 * ((q[0] - 1.0) ** 2 / 0.04 + torch.sum(q[1:] ** 2, dim=0))
    >>> res = sample_logdensity(0, ld, torch.zeros(2, 256), n_warmup=100, n_samples=50)
    >>> tuple(res.draws.shape)
    (256, 50, 2)
    >>> bool(abs(res.draws[:, :, 0].mean() - 1.0) < 0.05)
    True
    """
    q0 = torch.as_tensor(q0, dtype=torch.float32)
    if n_samples <= 0:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    _q, info = chees_hmc(
        logdensity_cols, q0, gen, n_warmup=n_warmup, n_steps=n_samples * thin, eps0=eps0,
        target_accept=target_accept, collect=True,
    )
    arr = info.draws[thin - 1 :: thin].permute(2, 0, 1)  # (chains, samples, D)
    rhat, ess_ = _column_diagnostics(arr, n_samples)
    return LogdensitySamples(
        draws=arr,
        rhat=rhat,
        ess=ess_,
        accept_rate=info.accept_rate,
        divergence_rate=info.divergence_rate,
        eps=info.eps,
        inv_mass=info.inv_mass,
    )


__all__ = ["LogdensitySamples", "PosteriorSamples", "sample_logdensity", "sample_posterior"]
