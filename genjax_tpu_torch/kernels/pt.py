"""Parallel-tempering (replica-exchange) HMC on the column layout.

Counterpart of ``genjax_tpu/kernels/pt.py``. A ladder of ``R`` inverse
temperatures ``1 = beta_0 > ... > beta_{R-1}`` targets ``pi**beta`` on each
rung, and adjacent rungs exchange states by a Metropolis swap, so chains cross
barriers at the hot rungs and the crossings percolate down to the cold one.

- The state is ``(R, D, N)``: rungs up front. A column log-density is
  columnwise, so the rungs' densities are one call over the ``(D, R * N)``
  block, reshaped back: the same numbers as a call per rung.
- Swaps are even-odd adjacent exchanges (Okabe et al. 2001): pairs ``(r,
  r + 1)`` with ``r = sweep (mod 2)`` are disjoint, so an exchange is two
  rolls and a select, and its acceptance reuses the untempered
  log-densities already computed.
- Per-rung step sizes adapt by dual averaging (one ``StepSizeAdaptState``
  with ``(R,)`` leaves and one shared step counter), per-rung diagonal
  inverse masses from the cross-chain variance.

The sweeps are a Python loop on the chains' device. The draws are the
reference's: an int ``seed`` is the root key ``key(seed, impl=rng_impl)``
and a key is the root itself; warmup sweep ``m`` takes the ``m``-th of
``split(fold_in(root, 1), n_warmup)``, sampling sweep ``m`` the ``m``-th of
``split(fold_in(root, 2), n_steps)``, each split into the HMC move's key
(split again into the momentum's and the accept uniforms') and the swap's.
A ``torch.Generator`` in the seed's place is drawn from in sequence, in law.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core import keys
from .adaptation import StepSizeAdaptState, _f32, chain_mean, cross_chain_inv_mass, dual_averaging_update
from .hmc import _lp_grad
from .rows import refuse_row_sharded


@dataclasses.dataclass(frozen=True)
class PTInfo:
    """Adapted settings and run statistics. ``eps``/``inv_mass``/
    ``accept_rate`` are per rung (``(R,)``, ``(R, D)``, ``(R,)``);
    ``swap_rate`` is per adjacent pair (``(R-1,)``); ``draws`` is None unless
    ``collect``: then the cold chain's positions ``(n_steps, D, N)``."""

    eps: Any
    accept_rate: Any
    swap_rate: Any
    inv_mass: Any
    draws: Any


def geometric_ladder(n_rungs: int, beta_min: float = 0.05) -> torch.Tensor:
    """``n_rungs`` inverse temperatures from 1 down to ``beta_min``,
    geometrically spaced, float32 on the CPU."""
    if n_rungs < 1:
        raise ValueError("need at least one rung")
    if n_rungs == 1:
        return torch.ones(1, dtype=torch.float32)
    return (beta_min ** (torch.arange(n_rungs, dtype=torch.float32) / (n_rungs - 1))).to(torch.float32)


def pt_hmc(
    logdensity_cols: Callable,
    q0: torch.Tensor,
    seed,
    *,
    betas,
    n_warmup: int = 300,
    n_steps: int = 200,
    eps0: float = 0.05,
    L: int = 8,
    target_accept: float = 0.8,
    inv_mass: Any | None = None,
    adapt_mass: bool = True,
    rng_impl: str = "rbg",
    collect: bool = False,
    mesh=None,
    axis: str = "batch",
):
    """Replica-exchange HMC over ``N`` column-layout chains x ``R`` rungs, on
    ``q0``'s device.

    ``logdensity_cols`` is the untempered ``(D, N) -> (N,)``; ``q0`` is
    ``(D, N)`` (the same start on every rung) or ``(R, D, N)``; ``seed`` an
    int (the root key ``key(seed, impl=rng_impl)``) or a key on ``q0``'s
    device, under which the chains are the reference's draw for draw, or a
    ``torch.Generator`` there, drawn from in sequence; ``betas`` the descending
    ladder, ``betas[0] == 1`` the cold rung whose draws are returned (see
    ``geometric_ladder``). ``n_warmup`` sweeps adapt each rung's step size
    and (with ``adapt_mass``) its inverse mass; ``n_steps`` sampling sweeps
    follow. A sweep is an HMC move of ``L`` leapfrogs on every rung, then an
    even-odd exchange. ``collect`` records the cold chain's positions. With
    ``mesh`` (a ``parallel.Mesh``), ``q0`` holds this rank's share of
    chains sharded over its ``axis``, and the rungs' accept and swap rates
    and inverse masses are every rank's: every rank adapts alike.

    Returns ``(q_cold (D, N), PTInfo)``.
    """
    refuse_row_sharded(logdensity_cols, "pt_hmc")
    device = q0.device
    betas = _f32(betas).to(device)
    if betas.ndim != 1:
        raise ValueError("betas must be a 1-D descending ladder")
    r = betas.shape[0]
    if q0.ndim == 2:
        q0 = q0[None].expand((r,) + tuple(q0.shape))
    if q0.ndim != 3 or q0.shape[0] != r:
        raise ValueError(f"q0 must be (D, N) or (R, D, N) with R={r}, got {tuple(q0.shape)}")
    root = keys.sampler_stream(seed, device, "pt_hmc", rng_impl)
    q = q0.to(torch.float32).contiguous()
    _, d, n = q.shape
    beta_col = betas[:, None, None]  # over (R, D, N)
    beta_row = betas[:, None]  # over (R, N)
    if inv_mass is None:
        inv_mass0 = torch.ones((r, d), dtype=torch.float32, device=device)
    else:
        inv_mass0 = _f32(inv_mass).to(device).expand(r, d).contiguous()

    def lp_g(q):
        # the rungs as one (D, R * N) block: a column density is columnwise
        lp, g = _lp_grad(logdensity_cols, q.permute(1, 0, 2).reshape(d, r * n))
        return lp.reshape(r, n), g.reshape(d, r, n).permute(1, 0, 2)

    def hmc_sweep(q, lp, g, stream, eps, inv_mass):
        """One tempered HMC transition on every rung and chain; ``lp``/``g``
        are untempered, the temperature multiplies the potential only."""
        im = inv_mass[:, :, None]
        eps_b = eps[:, None, None]
        kp, ku = keys.split_stream(stream)
        p = keys.normal_from(kp, (r, d, n), device) / torch.sqrt(im)
        u = keys.uniform_from(ku, (r, n), device)

        def kinetic(p_):
            return 0.5 * torch.sum(im * p_ * p_, dim=1)  # (R, N)

        q1, p1, g1, lp1 = q, p, g, lp
        for _ in range(L):
            p1 = p1 + (eps_b / 2.0) * (beta_col * g1)
            q1 = q1 + eps_b * im * p1
            lp1, g1 = lp_g(q1)
            p1 = p1 + (eps_b / 2.0) * (beta_col * g1)
        log_alpha = (beta_row * lp1 - kinetic(p1)) - (beta_row * lp - kinetic(p))
        accept = (torch.log(u) < log_alpha) & torch.all(torch.isfinite(q1), dim=1)  # NaN rejects
        qn = torch.where(accept[:, None, :], q1, q)
        lpn = torch.where(accept, lp1, lp)
        gn = torch.where(accept[:, None, :], g1, g)
        alpha = torch.where(
            torch.isnan(log_alpha), 0.0, torch.clamp(torch.exp(torch.clamp(log_alpha, max=0.0)), max=1.0)
        )
        return qn, lpn, gn, chain_mean(alpha, 1, mesh=mesh, axis=axis)  # accept per rung

    def swap_sweep(q, lp, g, stream, parity: int):
        """Even-odd adjacent exchange: pair ``(r, r + 1)`` is active when
        ``r = parity (mod 2)``; active pairs are disjoint, so the update is a
        select between a state and its neighbour by one roll."""
        if r == 1:
            return q, lp, g, torch.zeros(0, dtype=torch.float32, device=device)
        log_s = (betas[:-1] - betas[1:])[:, None] * (lp[1:] - lp[:-1])  # (R-1, N)
        u = keys.uniform_from(stream, (r - 1, n), device)
        active = (torch.arange(r - 1, device=device) % 2) == parity
        do = active[:, None] & (torch.log(u) < log_s)
        pad = torch.zeros((1, n), dtype=torch.bool, device=device)
        swap_up = torch.cat([do, pad])  # rung r takes rung r + 1's state
        swap_dn = torch.cat([pad, do])  # and rung r + 1 takes rung r's

        def exchange(x, up_mask, dn_mask):
            return torch.where(up_mask, torch.roll(x, -1, 0), torch.where(dn_mask, torch.roll(x, 1, 0), x))

        up3, dn3 = swap_up[:, None, :], swap_dn[:, None, :]
        return (exchange(q, up3, dn3), exchange(lp, swap_up, swap_dn), exchange(g, up3, dn3),
                chain_mean(do.to(torch.float32), 1, mesh=mesh, axis=axis))

    lp, g = lp_g(q)
    if n_warmup > 0:
        adapt = StepSizeAdaptState.init(torch.full((r,), float(eps0)), device=device)
        inv_mass_f = inv_mass0
        for idx, (k_hmc, k_swap) in enumerate(keys.sweep_streams(root, 1, n_warmup)):
            q, lp, g, acc = hmc_sweep(q, lp, g, k_hmc, torch.exp(adapt.log_eps), inv_mass_f)
            q, lp, g, _sw = swap_sweep(q, lp, g, k_swap, idx % 2)
            adapt = dual_averaging_update(adapt, acc, target_accept=target_accept)
            if adapt_mass:
                inv_mass_f = cross_chain_inv_mass(q, chain_axis=2, mesh=mesh, axis=axis)
        eps_f = torch.exp(adapt.log_eps_bar)
    else:
        eps_f = torch.full((r,), float(eps0), dtype=torch.float32, device=device)
        inv_mass_f = inv_mass0

    accs, sws, draws = [], [], []
    for idx, (k_hmc, k_swap) in zip(range(n_warmup, n_warmup + n_steps), keys.sweep_streams(root, 2, n_steps)):
        q, lp, g, acc = hmc_sweep(q, lp, g, k_hmc, eps_f, inv_mass_f)
        q, lp, g, sw = swap_sweep(q, lp, g, k_swap, idx % 2)
        accs.append(acc)
        sws.append(sw)
        if collect:
            draws.append(q[0])
    info = PTInfo(
        eps=eps_f,
        accept_rate=torch.stack(accs).mean(dim=0) if accs else torch.full((r,), torch.nan, device=device),
        # each pair is active every other sweep: the rate per attempt is
        # twice the raw mean
        swap_rate=2.0 * torch.stack(sws).mean(dim=0) if sws else torch.full((r - 1,), torch.nan, device=device),
        inv_mass=inv_mass_f,
        draws=(torch.stack(draws) if draws else q.new_zeros((0, d, n))) if collect else None,
    )
    return q[0], info


__all__ = ["PTInfo", "geometric_ladder", "pt_hmc"]
