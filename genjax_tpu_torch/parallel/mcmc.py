"""Sharded MCMC: chain batches over a mesh axis, with cross-chain step-size
adaptation.

Counterpart of ``genjax_tpu/parallel/mcmc.py`` (``run_chains_sharded``,
``warmup_adapt_step_size``). Chains are independent, so every rank of the
axis runs its ``n_chains / size`` chains on its device, from a stream of its
own (``mesh.mesh_generators``); the one cross-chain statistic, the mean
accept probability of the step-size adaptation, is a sum over the axis
where the reference has XLA insert it.

As in the reference, the runners reach ``inference.mcmc`` (``mh``,
``mh_accept``) from inside their functions: the one import of this layer
from ``inference``.

``run_chains_sharded`` runs its steps in segments. Step ``s`` of every chain
draws from a generator seeded by ``stream_seed(base, s)``, ``base`` drawn
once from the rank's stream, so a run cut into segments is the same run,
and with ``checkpoint_dir`` each segment saves its accept flags and records
once, as an increment beside the state (the reference rewrites every step
so far at each save): every rank under ``rank_<r>/``, rank 0 flipping the
pointer once all have written. A stopped run resumes bit for bit at the
same world size.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core.device import entry_generator, int_seed, stream_seed
from ..io import check_meta_matches, load_increments, load_segment_state, save_segment_state
from ..kernels.adaptation import StepSizeAdaptState, dual_averaging_update
from .mesh import Mesh, local_count, mesh_generators


def _vmap(fn, **kw):
    return torch.func.vmap(fn, randomness="different", **kw)


def _request_fingerprint(request) -> str:
    """A stable string of an edit request for resume validation: its tree
    spec and its leaves' values (a warmup-adapted ``inv_mass`` included)."""
    leaves, spec = pytree.tree_flatten(request)
    vals = [torch.as_tensor(v, dtype=torch.float64).cpu().reshape(-1).round(decimals=9).tolist()
            if isinstance(v, (torch.Tensor, int, float)) else repr(v) for v in leaves]
    return f"{spec}|{vals}"


def run_chains_sharded(
    gen,
    make_trace: Callable[[torch.Generator], Any],
    request,
    n_steps: int,
    n_chains: int,
    mesh: Mesh,
    *,
    axis: str = "batch",
    record: Callable[[Any], Any] | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    max_segments: int | None = None,
):
    """``inference.mcmc.run_chains`` with the chains sharded over ``mesh``'s
    ``axis``: every rank of the axis calls it alike, ``gen`` (a generator on
    the rank's device, or an int seed) in the same state, and runs its
    ``n_chains / size`` chains there. Returns this rank's
    ``MHChainResult``: its chains' traces, per-chain accept rates and,
    with ``record``, the records ``(chains, steps, ...)``.

    With ``checkpoint_dir`` and ``checkpoint_every=k``, the run saves after
    every segment of ``k`` steps; called again with the same arguments (the
    same world size), it resumes at the last saved segment and returns the
    uninterrupted run bit for bit. ``max_segments`` bounds the new segments
    a call runs; a call that ran none on a fresh run raises."""
    from ..inference.mcmc import MHChainResult, mh

    n_local = local_count(n_chains, mesh, axis, "n_chains")
    _shared, local = mesh_generators(gen, mesh, "run_chains_sharded")
    device = mesh.device
    traces = _vmap(lambda _: make_trace(local))(torch.zeros(n_local, device=device))
    base = int_seed(local)
    seg = checkpoint_every if (checkpoint_dir is not None and checkpoint_every > 0) else n_steps
    bounds = [(lo, min(lo + seg, n_steps)) for lo in range(0, n_steps, seg)]
    step_gen = torch.Generator(device=device)
    one_step = _vmap(lambda tr: mh(step_gen, tr, request))
    rec = None if record is None else _vmap(record)

    def run_segment(traces, lo, hi):
        accs, hist = [], []
        for s in range(lo, hi):
            step_gen.manual_seed(stream_seed(base, s))
            traces, accepted = one_step(traces)
            accs.append(accepted.to(torch.float32))
            if rec is not None:
                hist.append(rec(traces))
        stacked = pytree.tree_map(lambda *xs: torch.stack(xs), *hist) if hist else None
        return traces, {"accs": torch.stack(accs), "hist": stacked}

    parts, start = [], 0
    if checkpoint_dir is not None:
        identity = {"n_steps": int(n_steps), "seg_size": int(seg), "n_chains": int(n_chains),
                    "world": mesh.world_size, "request": _request_fingerprint(request), "layout": "increments"}
        rec_shapes = None if rec is None else rec(traces)

        def template_of(si):
            rows = bounds[si][1] - bounds[si][0]
            hist = None if rec_shapes is None else pytree.tree_map(
                lambda v: v.new_zeros((rows,) + tuple(v.shape)), rec_shapes)
            return {"accs": torch.zeros((rows, n_local), device=device), "hist": hist}

        def make_template(meta):
            check_meta_matches(checkpoint_dir, meta, identity)
            return {"traces": traces}

        restored = load_segment_state(checkpoint_dir, make_template, group=mesh)
        if restored is not None:
            state, meta = restored
            traces, start = state["traces"], meta["next_segment"]
            parts = load_increments(checkpoint_dir, start, template_of, group=mesh)
    ran = 0
    for si in range(start, len(bounds)):
        if max_segments is not None and ran >= max_segments:
            break
        traces, inc = run_segment(traces, *bounds[si])
        parts.append(inc)
        ran += 1
        if checkpoint_dir is not None:
            save_segment_state(checkpoint_dir, {"traces": traces}, {"next_segment": si + 1, **identity},
                               increment=inc, group=mesh)
    if not parts:
        raise ValueError(
            "no chain segments ran (max_segments=0 on a fresh run?) — nothing to return; run at least one segment"
        )
    accs = torch.cat([p["accs"] for p in parts])  # (steps, chains)
    history = None
    if rec is not None:
        history = pytree.tree_map(lambda *xs: torch.cat(xs).transpose(0, 1), *[p["hist"] for p in parts])
    return MHChainResult(traces, accs.mean(dim=0), history)


def warmup_adapt_step_size(
    gen,
    traces: Any,
    make_request: Callable[[Any], Any],
    n_warmup: int,
    *,
    eps0: float = 0.1,
    target_accept: float = 0.8,
    mesh: Mesh | None = None,
    axis: str = "batch",
) -> tuple[Any, Any]:
    """Adapt one HMC step size for a batch of chains by dual averaging on
    the cross-chain mean accept probability.

    ``traces`` is a chains-first batch; ``make_request(eps)`` builds the
    request at a step size (an ``HMC``). Each warmup step edits every chain,
    counts a NaN accept probability (a diverged leapfrog) as 0, accepts by
    MH, and updates the adaptation on the mean accept. With ``mesh``, the
    chains are this rank's shard over its ``axis``, the mean is every
    rank's (one sum a step), and each rank draws from its own stream
    (``gen``, a generator on the chains' device or an int seed, in the same
    state on every rank). Returns ``(traces, eps)``, ``eps`` the averaged
    step size (a float32 scalar, alike on every rank)."""
    from ..inference.mcmc import mh_accept

    device = next(v for v in pytree.tree_leaves(traces) if isinstance(v, torch.Tensor)).device
    if mesh is None:
        gen, _ = entry_generator(gen, device, "warmup_adapt_step_size")
    else:
        _shared, gen = mesh_generators(gen, mesh, "warmup_adapt_step_size")

    def one(tr, eps):
        new_tr, alpha, _rd, _bwd = tr.edit(gen, make_request(eps))
        accept_prob = torch.where(torch.isnan(alpha), 0.0, torch.clamp(torch.exp(alpha), max=1.0))
        out, _accepted = mh_accept(gen, tr, new_tr, alpha)
        return out, accept_prob

    step = _vmap(one, in_dims=(0, None))
    adapt = StepSizeAdaptState.init(eps0, device=device)
    for _ in range(n_warmup):
        traces, accept_probs = step(traces, torch.exp(adapt.log_eps))
        mean_accept = accept_probs.mean()
        if mesh is not None:
            mean_accept = mesh.all_reduce_mean(mean_accept, axis)
        adapt = dual_averaging_update(adapt, mean_accept, target_accept=target_accept)
    return traces, torch.exp(adapt.log_eps_bar)
