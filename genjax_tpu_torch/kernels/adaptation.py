"""MCMC warmup adaptation: step size and diagonal mass matrix.

Counterpart of ``genjax_tpu/kernels/adaptation.py``, shared by the column
warmups (``hmc.warmup_column``, ``nuts_pallas.warmup_column_nuts``):

- ``StepSizeAdaptState`` / ``dual_averaging_update``: Nesterov dual
  averaging on the cross-chain mean accept probability (Hoffman & Gelman
  2014, section 3.2), for adapting per transition;
- ``multiplicative_nudge``: the coarse per-window step-size update;
- ``cross_chain_inv_mass``: the diagonal inverse mass from the cross-chain
  variance of one time slice;
- ``windowed_warmup``: per window, a sweep, a nudge and a new mass;
- ``_halton2``: the base-2 van der Corput jitter of ChEES's trajectory
  length (``chees.py``).

Arithmetic is float32 on the device of its inputs, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class StepSizeAdaptState:
    """Dual-averaging state (Nesterov 2009 / Hoffman & Gelman 2014 §3.2)."""

    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    step: torch.Tensor
    mu: torch.Tensor  # shrinkage point: log(10 * eps0), fixed

    @staticmethod
    def init(eps0, *, device=None) -> "StepSizeAdaptState":
        """The state before the first update, every leaf on ``device`` (the
        chains'; by default ``eps0``'s, or the CPU). A tensor ``eps0`` of
        shape ``(R,)`` gives ``(R,)`` leaves and one shared step counter."""
        eps0 = _f32(eps0).to(device)
        zero = torch.zeros_like(eps0)
        return StepSizeAdaptState(
            torch.log(eps0), zero, zero.clone(),
            torch.tensor(0, dtype=torch.int32, device=eps0.device), torch.log(10.0 * eps0),
        )


def dual_averaging_update(
    state: StepSizeAdaptState,
    accept_rate,
    *,
    target_accept: float = 0.8,
    t0: float = 10.0,
    gamma: float = 0.05,
    kappa: float = 0.75,
) -> StepSizeAdaptState:
    step = state.step + 1
    step_f = step.to(torch.float32)
    eta = 1.0 / (step_f + t0)
    h_bar = (1.0 - eta) * state.h_bar + eta * (target_accept - _f32(accept_rate))
    log_eps = state.mu - torch.sqrt(step_f) / gamma * h_bar
    w = step_f ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * state.log_eps_bar
    return StepSizeAdaptState(log_eps, log_eps_bar, h_bar, step, state.mu)


def multiplicative_nudge(eps, accept_rate, *, target_accept: float = 0.8, rate: float = 1.5):
    """``eps * exp(rate * (accept - target))``: monotone, scale-free, and
    convergent in a handful of windows."""
    return _f32(eps) * torch.exp(rate * (_f32(accept_rate) - target_accept))


def chain_mean(x: torch.Tensor, dim: int, *, mesh=None, axis: str = "batch", keepdim: bool = False):
    """The mean of ``x`` over its chain dimension ``dim``: with ``mesh`` (a
    ``parallel.Mesh``), over every rank's chains along ``axis``, which hold
    equal shares (one sum)."""
    m = x.mean(dim=dim, keepdim=keepdim)
    return m if mesh is None else mesh.all_reduce_mean(m, axis)


def cross_chain_inv_mass(q: torch.Tensor, *, chain_axis: int = 1, floor: float = 1e-6, mesh=None,
                         axis: str = "batch"):
    """Diagonal inverse mass from the cross-chain (population) variance of
    one time slice; padding dimensions (zero variance) are floored so their
    momenta stay finite. With ``mesh`` (a ``parallel.Mesh``), the chains are
    sharded over its ``axis`` and the variance is that of every rank's
    chains: the global mean in one sum, then the squared deviations in a
    second."""
    if mesh is None:
        var = torch.var(q, dim=chain_axis, correction=0)
    else:
        n = q.shape[chain_axis] * mesh.axis_size(axis)
        mean = mesh.all_reduce_sum(q.sum(dim=chain_axis, keepdim=True), axis) / n
        var = mesh.all_reduce_sum(((q - mean) ** 2).sum(dim=chain_axis), axis) / n
    return torch.maximum(var, torch.tensor(floor, dtype=var.dtype, device=var.device))


def windowed_warmup(
    sweep: Callable,
    q0: torch.Tensor,
    *,
    n_windows: int,
    eps0,
    target_accept: float = 0.8,
    chain_axis: int = 1,
    nudge_rate: float = 1.5,
    mesh=None,
    axis: str = "batch",
):
    """Windowed warmup: per window, run ``sweep(q, window_index, eps,
    inv_mass) -> (q, accept_rate)``, nudge the step size toward
    ``target_accept``, and re-estimate the diagonal inverse mass from the
    cross-chain variance.

    The reference compiles this to one ``lax.scan``. Here it is a loop over
    windows that keeps ``q`` and ``inv_mass`` on their device. The sweep
    kernels take ``eps`` as a launch argument, so ``sweep`` gets it as a
    Python float: one host read of ``eps`` per window.

    With ``mesh`` (a ``parallel.Mesh``), ``q`` is this rank's shard of
    chains sharded over its ``axis``, and the window's accept rate and the
    inverse mass are those of every rank's chains (the mean accept in one
    sum, the variance in two): every rank adapts to the same settings.

    Returns ``(q, eps, inv_mass, accept_history)``, ``eps`` a float32 scalar
    tensor and ``accept_history`` of shape ``(n_windows,)``.
    """
    d = q0.shape[0] if chain_axis == 1 else q0.shape[-1]
    q = q0
    eps = _f32(eps0).to(q0.device)
    inv_mass = torch.ones(d, dtype=torch.float32, device=q0.device)
    accs = []
    for idx in range(n_windows):
        q, acc = sweep(q, idx, float(eps), inv_mass)
        acc = _f32(acc).to(q0.device)
        if mesh is not None:
            acc = mesh.all_reduce_mean(acc, axis)
        eps = multiplicative_nudge(eps, acc, target_accept=target_accept, rate=nudge_rate)
        inv_mass = cross_chain_inv_mass(q, chain_axis=chain_axis, mesh=mesh, axis=axis)
        accs.append(acc)
    return q, eps, inv_mass, torch.stack(accs) if accs else torch.zeros(0, device=q0.device)


def _halton2(i: int) -> torch.Tensor:
    """Base-2 van der Corput value of the integer ``i`` in (0, 1): its low
    24 bits reversed behind the binary point, plus ``2**-25``, as a float32
    scalar on the CPU (every partial sum is exact in float32, so the order
    of the sum does not matter)."""
    bits = torch.arange(24)
    digits = (int(i) >> bits) & 1
    return torch.sum(digits * 0.5 ** (bits + 1.0)).to(torch.float32) + 2.0**-25
