"""Likelihood-free inference: ABC rejection and adaptive ABC-SMC.

Counterpart of ``genjax_tpu/inference/abc.py``: ``ABCRejectionResult``,
``abc_rejection``, ``ABCSMCResult``, ``abc_smc`` and
``column_weighted_moments``, for models whose simulator is a ``@gen``
program and whose likelihood is never evaluated.

- ``abc_rejection`` simulates the prior predictive as one
  ``torch.func.vmap`` of ``model.simulate`` (``keys.vmap_streams``) and
  returns every choice map in one vectorised ``Mask`` whose flag marks
  acceptance (Pritchard et al. 1999).
- ``abc_smc`` is the adaptive tolerance ladder (Del Moral, Doucet & Jasra
  2012) with Beaumont et al. (2009)'s move kernel: each generation lowers
  the tolerance to a quantile of the distances (held while the moves accept
  less than ``min_accept``), resamples the live particles, and moves each by
  ABC-MCMC with a Gaussian perturbation of ``proposal_scale`` times the
  population's variance. The parameters ride the column layout
  (``ColumnPacker``), and the simulator is re-entered through
  ``model.generate`` under the unpacked parameters, whose weight is the
  parameters' prior density, the MH correction.

The generations and moves are Python loops (the reference's ``lax.scan``);
nothing is read to the host inside them. Both entry points make their
simulations on ``device``, the card unless the caller asks for the CPU.
Under a key (``core/keys.py``) they split it as the reference does and draw
its draws: simulation ``i`` under the ``i``-th of ``split(key,
n_samples)``; ABC-SMC's ``k_init, k_gens = split(key)``, the initial
particles under ``split(k_init, N)`` and their prior scores under
``split(fold_in(k_init, 1), N)``, generation ``g`` under ``split(k_gens,
n_generations)[g]``, split into its resample and move keys, and each move's
key in three (the perturbation, the re-simulations, the accepts). A
``torch.Generator`` (an int seed makes one) is drawn from in sequence.

>>> import torch
>>> import genjax_tpu_torch as g
>>> from genjax_tpu_torch.inference import abc_rejection
>>> @g.gen
... def model():
...     theta = g.normal(0.0, 1.0) @ "theta"
...     _ = g.normal(theta, 0.5) @ "y"
>>> res = abc_rejection(0, model, (), lambda tr: torch.abs(tr.get_choices()["y"] - 1.0),
...                     n_samples=2000, tolerance=0.2, device="cpu")
>>> tuple(res.choices.flag.shape), bool(0.0 < float(res.accept_rate) < 0.5)
((2000,), True)
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ..core import keys
from ..core.device import to_device
from ..core.pytree import Pytree
from ..generative.gfi import GenerativeFunction
from ..generative.mask import Mask
from ..kernels.model_interface import ColumnPacker
from ..parallel.resampling import resample_particles


@Pytree.dataclass
class ABCRejectionResult(Pytree):
    """Vectorised-``Mask`` choices (flag = accepted), the distances, and the
    acceptance rate."""

    choices: Any
    distances: Any
    accept_rate: Any


def abc_rejection(
    gen,
    model: GenerativeFunction,
    args: tuple,
    distance_fn: Callable[[Any], Any],
    *,
    n_samples: int,
    tolerance: float,
    device="cuda",
) -> ABCRejectionResult:
    """Simulate ``n_samples`` traces from the prior predictive and accept
    those whose ``distance_fn(trace)`` is within ``tolerance``. All the
    choice maps come back, in one vectorised ``Mask`` whose flag marks
    acceptance: filter with ``result.choices.flag`` downstream."""
    gen, device = keys.entry_stream(gen, device, "abc_rejection")
    args = to_device(args, device)

    def one(g):
        tr = model.simulate(g, args)
        return tr.get_choices(), distance_fn(tr)

    chms, d = keys.vmap_streams(one, gen, n_samples)()
    accept = d <= tolerance
    return ABCRejectionResult(Mask(chms, accept), d, accept.to(torch.float32).mean())


@Pytree.dataclass
class ABCSMCResult(Pytree):
    """Final parameter columns ``(D_pad, N)``, their distances and prior
    scores, the tolerance ladder, the MH acceptance of each generation, and
    the final tolerance."""

    params: Any
    distances: Any
    prior_scores: Any
    tolerance_history: Any
    move_accept_history: Any
    tolerance: Any


def abc_smc(
    gen,
    model: GenerativeFunction,
    args: tuple,
    distance_fn: Callable[[Any], Any],
    addresses: Sequence[Any],
    *,
    n_particles: int,
    n_generations: int,
    quantile: float = 0.5,
    mh_moves: int = 2,
    proposal_scale: float = 2.0,
    min_accept: float = 0.10,
    method: str = "systematic",
    packer: ColumnPacker | None = None,
    device="cuda",
) -> tuple[ABCSMCResult, ColumnPacker]:
    """Adaptive ABC-SMC over the parameter ``addresses`` of ``model``.

    Each generation: the tolerance becomes the ``quantile`` of the current
    distances (never increasing, and held while the last generation's moves
    accepted less than ``min_accept``: lowering it faster than the moves
    mix collapses the population onto a few ancestors), the live particles
    resample, and each takes ``mh_moves`` ABC-MCMC moves with a diagonal
    Gaussian proposal of ``proposal_scale`` times the population variance.
    Returns the result and the ``ColumnPacker``: unpack a particle with
    ``packer.unpack(result.params[:, j])``."""
    gen, device = keys.entry_stream(gen, device, "abc_smc")
    keyed = keys.is_key(gen)
    args = to_device(args, device)
    if packer is None:
        packer = ColumnPacker(model, None, args, list(addresses))
    n = n_particles
    # the padding dimensions carry no parameter: they do not move
    real = (torch.arange(packer.padded_dim, device=device) < packer.dim).to(torch.float32)[:, None]

    def sim_one(g, q):
        """Re-simulate under the parameter column ``q``: the weight is the
        parameters' prior log-density (the data are not constrained)."""
        tr, w = model.generate(g, packer.unpack(q), args)
        return w, distance_fn(tr)

    def init_one(g):
        tr = model.simulate(g, args)
        return packer.pack(tr.get_choices()), distance_fn(tr)

    def simulate(g, q):
        return keys.vmap_streams(sim_one, g, n, in_dims=(1,))(q)

    if keyed:
        k_init, k_gens = keys.split(gen).unbind(-2)
        gens = [tuple(ks.unbind(0)) for ks in keys.split(keys.split(k_gens, n_generations)).unbind(0)]
        k_scores = keys.fold_in(k_init, 1)
    else:
        k_init = k_scores = gen
        gens = [(gen, gen)] * n_generations
    q, d = keys.vmap_streams(init_one, k_init, n, out_dims=(1, 0))()
    # the prior scores of the initial columns, through the path MH uses
    prior_w, _ = simulate(k_scores, q)
    eps = torch.tensor(float("inf"), device=device)
    prev_acc = torch.tensor(1.0, device=device)
    eps_hist, acc_hist = [], []
    for k_res, k_mh in gens:
        eps = torch.where(prev_acc >= min_accept, torch.minimum(torch.quantile(d, quantile), eps), eps)
        log_w = torch.where(d <= eps, 0.0, float("-inf"))
        qT, prior_w, d = resample_particles(k_res, (q.T, prior_w, d), log_w, n, method)
        q = qT.T
        sigma = torch.sqrt(proposal_scale * torch.var(q, dim=1, keepdim=True, correction=0) + 1e-12) * real
        accs = []
        moves = keys.split(keys.split(k_mh, mh_moves), 3).unbind(0) if keyed else [(gen,) * 3] * mh_moves
        for k_prop, k_sim, k_acc in (tuple(m.unbind(0)) if keyed else m for m in moves):
            q_prop = q + sigma * keys.normal_from(k_prop, q.shape, device)
            w_prop, d_prop = simulate(k_sim, q_prop)
            log_u = torch.log(keys.uniform_from(k_acc, (n,), device))
            accept = (log_u < w_prop - prior_w) & (d_prop <= eps)
            q = torch.where(accept[None, :], q_prop, q)
            prior_w = torch.where(accept, w_prop, prior_w)
            d = torch.where(accept, d_prop, d)
            accs.append(accept.to(torch.float32).mean())
        prev_acc = torch.stack(accs).mean()
        eps_hist.append(eps)
        acc_hist.append(prev_acc)
    res = ABCSMCResult(q, d, prior_w, torch.stack(eps_hist), torch.stack(acc_hist), eps)
    return res, packer


def column_weighted_moments(params, d_real: int):
    """Mean and variance over the particles of the real (unpadded) parameter
    rows of an ABC-SMC column matrix."""
    q = params[:d_real]
    return q.mean(dim=1), torch.var(q, dim=1, correction=0)


__all__ = ["ABCRejectionResult", "ABCSMCResult", "abc_rejection", "abc_smc", "column_weighted_moments"]
