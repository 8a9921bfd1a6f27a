"""ChEES-HMC: adaptive trajectory lengths for many parallel chains.

Counterpart of ``genjax_tpu/kernels/chees.py`` (Hoffman & Sountsov, AISTATS
2021) on the ``(D, N)`` column layout. The trajectory length is one
parameter shared by every chain and adapted from cross-chain statistics, so
a sweep costs exactly ``L`` gradients for every chain. Per sweep ``m``:

1. jitter: ``tau_m = h_m * t`` with ``h_m`` the base-2 van der Corput
   sequence (``adaptation._halton2``), shared across chains;
2. ``L = clip(ceil(tau_m / eps), 1, max_leapfrogs)`` leapfrog steps;
3. per-chain MH accept; NaN trajectories and non-finite positions reject;
4. the ChEES gradient in trajectory time, centred on the cross-chain means,
   ascends ``log t`` with Adam;
5. dual averaging of the step size toward ``target_accept`` (0.651 is
   ChEES's optimum), and the diagonal inverse mass from the cross-chain
   variance.

The reference runs the sweeps as one ``lax.scan`` with ``L`` traced. Here the
sweeps are a Python loop on the chains' device and ``L`` is a Python int:
one host read a sweep. The draws are the reference's: an int ``seed`` is the
root key ``key(seed, impl=rng_impl)`` and a key is the root itself, warmup
sweep ``m`` draws under the ``m``-th of ``split(fold_in(root, 1),
n_warmup)`` and sampling sweep ``m`` under the ``m``-th of
``split(fold_in(root, 2), n_steps)``, each split into the momentum's and
the accept uniforms' keys (``core/keys.py``). A ``torch.Generator`` in the
seed's place is drawn from in sequence, in law.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..core import keys
from .adaptation import StepSizeAdaptState, _f32, _halton2, chain_mean, cross_chain_inv_mass, dual_averaging_update
from .hmc import _lp_grad
from .rows import Rows, chain_mesh


@dataclasses.dataclass(frozen=True)
class ChEESInfo:
    """Adapted settings and sweep statistics. ``draws`` is None unless
    ``collect`` was asked for: then every sampling sweep's positions
    ``(n_steps, D, N)``."""

    eps: Any
    trajectory_length: Any
    accept_rate: Any
    mean_leapfrogs: Any
    divergence_rate: Any
    inv_mass: Any
    draws: Any


def _adam(mv, grad, step):
    """One Adam step on a scalar (b1 0.9, b2 0.95): the new moments and the
    update direction. ``step`` counts the updates made before this one."""
    m, v = mv
    b1, b2 = 0.9, 0.95
    m = b1 * m + (1.0 - b1) * grad
    v = b2 * v + (1.0 - b2) * grad * grad
    s = step.to(torch.float32) + 1.0
    mhat = m / (1.0 - b1**s)
    vhat = v / (1.0 - b2**s)
    return (m, v), mhat / (torch.sqrt(vhat) + 1e-8)


def chees_hmc(
    logdensity_cols: Callable,
    q0: torch.Tensor,
    seed,
    *,
    n_warmup: int = 300,
    n_steps: int = 200,
    eps0: float = 0.05,
    t0: float = 1.0,
    target_accept: float = 0.651,
    max_leapfrogs: int = 1000,
    adam_lr: float = 0.025,
    inv_mass: Any | None = None,
    adapt_mass: bool = True,
    rng_impl: str = "rbg",
    collect: bool = False,
    mesh=None,
    axis: str = "batch",
):
    """ChEES-adaptive HMC on ``N`` column-layout chains, on ``q0``'s device.

    ``logdensity_cols`` maps ``(D, N) -> (N,)``; ``q0`` holds the starting
    positions ``(D, N)``; ``seed`` is an int (the root key ``key(seed,
    impl=rng_impl)``), a key on ``q0``'s device (the root itself), under
    either of which the chains are the reference's draw for draw, or a
    ``torch.Generator`` there, drawn from in sequence. ``n_warmup`` sweeps
    adapt the step size, the trajectory length and (with ``adapt_mass``) the
    diagonal inverse mass; ``n_warmup=0``
    runs at ``eps0``, ``t0`` and ``inv_mass`` as given. ``n_steps`` sampling
    sweeps follow at the adapted settings, the jitter still on; ``collect``
    records their positions in ``info.draws``. With ``mesh`` (a
    ``parallel.Mesh``), ``q0`` is this rank's share of chains sharded over
    its ``axis``: the cross-chain means and sums of the adaptation and the
    reported rates are every rank's, so every rank adapts alike. A
    row-sharded density (``.row_shard``): ``q0`` is this rank's block, the
    kinetic energies, the finiteness check and the criterion's sums over
    rows are sums over the model axis, every model rank of a chain draws
    alike (its rows of the full-height momentum, the same uniforms), and the
    chain means run over the density's chain axis where no ``mesh`` is
    given; an int seed is then the chain block's (``Rows.seed``), and a key
    on a chain axis of more than one rank raises.

    Returns ``(q_final, ChEESInfo)``.
    """
    d, n = q0.shape
    device = q0.device
    rows = Rows(logdensity_cols, d)
    mesh, axis = chain_mesh(logdensity_cols, mesh, axis)
    root = rows.stream(seed, device, "chees_hmc", rng_impl)
    q = q0.to(torch.float32)
    if inv_mass is None:
        inv_mass0 = torch.ones(d, dtype=torch.float32, device=device)
    else:
        inv_mass0 = _f32(inv_mass).to(device).reshape(d)

    def sweep(q, lp, g, streams, step_idx, eps, log_t, inv_mass):
        im_col = inv_mass[:, None]
        kp, ku = streams
        p = (1.0 / torch.sqrt(im_col)) * rows.normal(lambda dd: keys.normal_from(kp, (dd, n), device))
        u = keys.uniform_from(ku, (n,), device)

        def kinetic(p_):
            return 0.5 * rows.sum(im_col * p_ * p_)

        tau = float(_halton2(step_idx)) * torch.exp(log_t)
        # the shared leapfrog count: one host read a sweep
        n_leap = int(torch.clamp(torch.nan_to_num(torch.ceil(tau / eps), nan=1.0), 1, max_leapfrogs))
        q1, p1, g1, lp1 = q, p, g, lp
        for _ in range(n_leap):
            p1 = p1 + (eps / 2.0) * g1
            q1 = q1 + eps * im_col * p1
            lp1, g1 = _lp_grad(logdensity_cols, q1)
            p1 = p1 + (eps / 2.0) * g1
        log_alpha = (lp1 - kinetic(p1)) - (lp - kinetic(p))
        alpha = torch.where(
            torch.isnan(log_alpha), 0.0, torch.clamp(torch.exp(torch.clamp(log_alpha, max=0.0)), max=1.0)
        )
        finite_pos = rows.all_finite(q1)
        accept = (torch.log(u) < log_alpha) & finite_pos
        qn = torch.where(accept, q1, q)
        lpn = torch.where(accept, lp1, lp)
        gn = torch.where(accept, g1, g)

        # the ChEES gradient in trajectory time, centred on the cross-chain
        # means. A diverged proposal (non-finite position, or NaN density)
        # is replaced by the current position so that it cannot poison the
        # means; its alpha is 0, so it adds nothing. A -inf density at a
        # finite position is an ordinary out-of-support rejection.
        diverged = ~finite_pos | torch.isnan(lp1)
        ok = ~diverged
        q1s = torch.where(ok, q1, q)
        p1s = torch.where(ok, p1, torch.zeros_like(p1))
        qm = chain_mean(q, 1, mesh=mesh, axis=axis, keepdim=True)
        qm1 = chain_mean(q1s, 1, mesh=mesh, axis=axis, keepdim=True)
        v1 = im_col * p1s  # dq/dtime at the endpoint
        dsq0, dsq1, proj = rows.sums((q - qm) ** 2, (q1s - qm1) ** 2, (q1s - qm1) * v1)
        per_chain = (dsq1 - dsq0) * proj
        contrib = torch.where(torch.isfinite(per_chain), alpha * per_chain, 0.0)
        sums = torch.stack([torch.sum(contrib), torch.sum(alpha)])
        if mesh is not None:
            sums = mesh.all_reduce_sum(sums, axis)
        grad_tau = sums[0] / (sums[1] + 1e-12)
        # d/d log t = dChEES/dtau * dtau/dt * t = grad_tau * h * t
        grad_logt = grad_tau * tau
        grad_logt = torch.where(torch.isfinite(grad_logt), grad_logt, 0.0)
        div = chain_mean(diverged.to(torch.float32), 0, mesh=mesh, axis=axis)
        return qn, lpn, gn, alpha, grad_logt, n_leap, div

    def clamp_logt(log_t, eps):
        # at least one step, at most the budget
        return torch.minimum(torch.maximum(log_t, torch.log(eps)), torch.log(eps * max_leapfrogs))

    lp, g = _lp_grad(logdensity_cols, q)
    log_t = torch.log(_f32(t0)).to(device)
    if n_warmup > 0:
        adapt = StepSizeAdaptState.init(eps0, device=device)
        mv = (torch.zeros((), device=device), torch.zeros((), device=device))
        inv_mass_f = inv_mass0
        for step_idx, streams in enumerate(keys.sweep_streams(root, 1, n_warmup)):
            eps = torch.exp(adapt.log_eps)
            q, lp, g, alpha, grad_logt, _n, _div = sweep(q, lp, g, streams, step_idx, eps, log_t, inv_mass_f)
            mv, update = _adam(mv, grad_logt, adapt.step)
            log_t = clamp_logt(log_t + adam_lr * update, eps)
            adapt = dual_averaging_update(adapt, chain_mean(alpha, 0, mesh=mesh, axis=axis),
                                          target_accept=target_accept)
            if adapt_mass:
                inv_mass_f = cross_chain_inv_mass(q, chain_axis=1, mesh=mesh, axis=axis)
        eps_f = torch.exp(adapt.log_eps_bar)
        log_t = clamp_logt(log_t, eps_f)
    else:
        # adaptation off: the caller's settings verbatim
        eps_f = _f32(eps0).to(device)
        inv_mass_f = inv_mass0

    accs, n_leaps, divs, draws = [], [], [], []
    for step_idx, streams in zip(range(n_warmup, n_warmup + n_steps), keys.sweep_streams(root, 2, n_steps)):
        q, lp, g, alpha, _gl, n_leap, div = sweep(q, lp, g, streams, step_idx, eps_f, log_t, inv_mass_f)
        accs.append(chain_mean(alpha, 0, mesh=mesh, axis=axis))
        n_leaps.append(n_leap)
        divs.append(div)
        if collect:
            draws.append(q)
    nan = torch.tensor(math.nan, device=device)
    info = ChEESInfo(
        eps=eps_f,
        trajectory_length=torch.exp(log_t),
        accept_rate=torch.stack(accs).mean() if accs else nan,
        mean_leapfrogs=torch.tensor(sum(n_leaps) / len(n_leaps) if n_leaps else math.nan, device=device),
        divergence_rate=torch.stack(divs).mean() if divs else nan,
        inv_mass=inv_mass_f,
        draws=(torch.stack(draws) if draws else q.new_zeros((0, d, n))) if collect else None,
    )
    return q, info


__all__ = ["ChEESInfo", "chees_hmc"]
