"""L-BFGS with a zoom linesearch, for a batch of independent problems.

A copy of ``optax.lbfgs`` as optax 0.2.6 defines it (memory ``history``,
``scale_init_precond=True``, ``scale_by_zoom_linesearch(max_linesearch_steps=
20, initial_guess_strategy="one")``), so that Pathfinder's optimisation path,
and with it the best-ELBO iterate, is the reference's:

- ``scale_by_lbfgs`` (optax ``transform.py``): the memory buffers updated
  from the last move, the initial inverse Hessian ``gamma I`` (the capped
  reciprocal of the gradient norm on the first step), and the two-loop
  recursion (Nocedal & Wright, algorithm 7.4);
- ``zoom_linesearch`` (optax ``linesearch.py``): the interval search
  doubling the step, then the zoom by cubic, quadratic or bisection
  interpolation (Nocedal & Wright, algorithms 3.5 and 3.6), with the
  approximate Wolfe decrease of Hager & Zhang, and the fall-back to the
  best safe step when it fails.

``torch.optim.LBFGS`` is not used: its linesearch and memory rules differ.

Every tensor leads with the problem axis ``P``: parameters ``(P, D)``,
values ``(P,)``. ``value_and_grad(x (P, D)) -> (values (P,), grads (P,
D))`` is called once a linesearch step on every problem's trial point
together; a problem freezes when its own linesearch ends, and the loop ends
when all have: one host read a linesearch step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

_MAX_LINESEARCH_STEPS = 20
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5
_INCREASE_FACTOR = 2.0


class LBFGSState(NamedTuple):
    count: int  # updates made (the same for every problem)
    params: torch.Tensor  # (P, D) the last update's parameters
    updates: torch.Tensor  # (P, D) and gradients
    diff_params_memory: torch.Tensor  # (m, P, D)
    diff_updates_memory: torch.Tensor  # (m, P, D)
    weights_memory: torch.Tensor  # (m, P)
    value: torch.Tensor  # (P,) the value and gradient where the last linesearch ended
    grad: torch.Tensor  # (P, D)
    linesearch_steps: torch.Tensor  # (P,) the last linesearch's steps


def lbfgs_init(params: torch.Tensor, memory_size: int) -> LBFGSState:
    p, d = params.shape
    z = torch.zeros_like(params)
    mem = params.new_zeros((memory_size, p, d))
    return LBFGSState(
        0, z, z.clone(), mem, mem.clone(), params.new_zeros((memory_size, p)),
        params.new_full((p,), float("inf")), z.clone(), torch.zeros(p, dtype=torch.int64, device=params.device),
    )


def _vdot(a, b):
    return torch.sum(a * b, dim=-1)


def value_and_grad_from_state(value_and_grad: Callable, params: torch.Tensor, state: LBFGSState):
    """``optax.value_and_grad_from_state``: the value and gradient that the
    last linesearch stored, recomputed where they are not finite."""
    fresh = ~torch.isfinite(state.value)
    if not bool(fresh.any()):
        return state.value, state.grad
    v, g = value_and_grad(params)
    return torch.where(fresh, v, state.value), torch.where(fresh[:, None], g, state.grad)


def _precondition(updates, rhos, dw_mem, du_mem, identity_scale, memory_idx):
    """The two-loop recursion: the approximate inverse Hessian times
    ``updates``, the oldest pair innermost."""
    m = rhos.shape[0]
    order = [(memory_idx + i) % m for i in range(m)]
    vec = updates
    alphas = {}
    for idx in reversed(order):
        alpha = rhos[idx] * _vdot(dw_mem[idx], vec)
        vec = vec - alpha[:, None] * du_mem[idx]
        alphas[idx] = alpha
    vec = identity_scale[:, None] * vec
    for idx in order:
        beta = rhos[idx] * _vdot(du_mem[idx], vec)
        vec = vec + (alphas[idx] - beta)[:, None] * dw_mem[idx]
    return vec


def _scale_by_lbfgs(grad, state: LBFGSState, params):
    """``optax.scale_by_lbfgs``'s update: the memory from the move just
    made, then the preconditioned gradient. Returns ``(direction, memory
    buffers)``."""
    m = state.weights_memory.shape[0]
    memory_idx = state.count % m
    prev_idx = (state.count - 1) % m
    diff_params = params - state.params
    diff_updates = grad - state.updates
    vdot = _vdot(diff_updates, diff_params)
    weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
    if state.count == 0:
        diff_params, diff_updates, weight = (torch.zeros_like(v) for v in (diff_params, diff_updates, weight))
    dw_mem, du_mem = state.diff_params_memory.clone(), state.diff_updates_memory.clone()
    rhos = state.weights_memory.clone()
    dw_mem[prev_idx], du_mem[prev_idx], rhos[prev_idx] = diff_params, diff_updates, weight
    if state.count > 0:
        den = _vdot(diff_updates, diff_updates)
        identity_scale = torch.where(den > 0.0, _vdot(diff_updates, diff_params) / den, 1.0)
    else:  # the first step: a capped reciprocal of the gradient norm
        identity_scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad, dim=-1), max=1.0)
    direction = _precondition(grad, rhos, dw_mem, du_mem, identity_scale, memory_idx)
    return direction, (dw_mem, du_mem, rhos)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The minimiser of the cubic through ``(a, fa)``, ``(b, fb)``, ``(c,
    fc)`` with slope ``fpa`` at ``a`` (NaN where there is none)."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1, r2 = fb - fa - fpa * db, fc - fa - fpa * dc
    big_a = (dc**2 * r1 - db**2 * r2) / denom
    big_b = (-(dc**3) * r1 + db**3 * r2) / denom
    radical = big_b * big_b - 3.0 * big_a * fpa
    return a + (-big_b + torch.sqrt(radical)) / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    big_b = (fb - fa - fpa * db) / db**2
    return a - fpa / (2.0 * big_b)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * _SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - _APPROX_DEC_RTOL * torch.abs(value_init)
    err = torch.minimum(torch.maximum(approx, delta_values), err)
    err = torch.clamp(err, min=0.0)
    return torch.where(torch.isnan(err), float("inf"), err)


def _curvature_error(slope, slope_init):
    err = torch.clamp(torch.abs(slope) - _CURV_RTOL * torch.abs(slope_init), min=0.0)
    return torch.where(torch.isnan(err), float("inf"), err)


def _where(cond, a: dict, b: dict) -> dict:
    def pick(x, y):
        c = cond if x.dim() == cond.dim() else cond[:, None]
        return torch.where(c, x, y)

    return {k: pick(a[k], b[k]) for k in a}


def zoom_linesearch(value_and_grad: Callable, params, updates, value, grad):
    """``optax.scale_by_zoom_linesearch``'s search from ``params`` along
    ``updates`` for every problem, its first guess 1. Returns ``(stepsize
    (P,), value (P,), grad (P, D), steps (P,))`` where each search ended."""
    p = params.shape[0]
    zero = params.new_zeros(p)
    inf = params.new_full((p,), float("inf"))
    no = torch.zeros(p, dtype=torch.bool, device=params.device)
    slope = _vdot(updates, grad)
    st = dict(
        count=torch.zeros(p, dtype=torch.int64, device=params.device), stepsize=zero, value=value, grad=grad,
        slope=slope, decrease_error=inf, curvature_error=inf, interval_found=no, done=no, failed=no,
        low=zero, value_low=value, slope_low=slope, high=zero, value_high=value, slope_high=slope,
        cubic_ref=zero, value_cubic_ref=value, safe_stepsize=zero, safe_value=value, safe_grad=grad,
    )
    value_init, slope_init = value, slope
    while True:
        active = ~(st["done"] | st["failed"])
        if not bool(active.any()):  # one host read a linesearch step
            break
        search, zoom = _trial_steps(st)
        trial = torch.where(st["interval_found"], zoom["middle"], search["stepsize"])
        v, g = value_and_grad(params + trial[:, None] * updates)
        s = _vdot(g, updates)
        new = _where(st["interval_found"], _zoom_into_interval(st, zoom, trial, v, g, s, value_init, slope_init),
                     _search_interval(st, trial, v, g, s, value_init, slope_init))
        new = _where(new["failed"], _try_safe_step(new), new)
        st = _where(active, new, st)
    return st["stepsize"], st["value"], st["grad"], st["count"]


def _trial_steps(st):
    """The next trial step of each problem: doubling while the interval is
    searched, an interpolation inside it once found."""
    new_stepsize = torch.where(st["count"] == 0, torch.ones_like(st["stepsize"]), _INCREASE_FACTOR * st["stepsize"])
    low, high = st["low"], st["high"]
    delta = torch.abs(high - low)
    left, right = torch.minimum(high, low), torch.maximum(high, low)
    middle_cubic = _cubicmin(low, st["value_low"], st["slope_low"], high, st["value_high"], st["cubic_ref"],
                             st["value_cubic_ref"])
    use_cubic = (middle_cubic > left + 0.2 * delta) & (middle_cubic < right - 0.2 * delta)
    middle_quad = _quadmin(low, st["value_low"], st["slope_low"], high, st["value_high"])
    use_quad = ~use_cubic & (middle_quad > left + 0.1 * delta) & (middle_quad < right - 0.1 * delta)
    use_bisection = ~use_cubic & ~use_quad
    middle = torch.where(use_cubic, middle_cubic, st["cubic_ref"])
    middle = torch.where(use_quad, middle_quad, middle)
    middle = torch.where(use_bisection, (low + high) / 2.0, middle)
    return {"stepsize": new_stepsize}, {"middle": middle, "too_small": delta <= _INTERVAL_THRESHOLD}


def _search_interval(st, new_stepsize, v, g, s, value_init, slope_init):
    dec = _decrease_error(new_stepsize, v, s, value_init, slope_init)
    curv = _curvature_error(s, slope_init)
    err = torch.maximum(dec, curv)
    safe = _where(dec <= 0.0, {"safe_stepsize": new_stepsize, "safe_value": v, "safe_grad": g},
                  {k: st[k] for k in ("safe_stepsize", "safe_value", "safe_grad")})
    set_high_to_new = (dec > 0.0) | ((v >= st["value"]) & (st["count"] > 0))
    set_low_to_new = (s >= 0.0) & ~set_high_to_new
    bounds = _where(
        set_low_to_new,
        dict(low=new_stepsize, value_low=v, slope_low=s, high=st["stepsize"], value_high=st["value"],
             slope_high=st["slope"]),
        dict(low=st["stepsize"], value_low=st["value"], slope_low=st["slope"], high=new_stepsize, value_high=v,
             slope_high=s),
    )
    done = err <= 0.0
    return dict(
        st, count=st["count"] + 1, stepsize=new_stepsize, value=v, grad=g, slope=s, decrease_error=dec,
        curvature_error=curv, interval_found=set_high_to_new | set_low_to_new | done, done=done,
        failed=(st["count"] + 1 >= _MAX_LINESEARCH_STEPS) & ~done, **bounds,
        cubic_ref=bounds["low"], value_cubic_ref=bounds["value_low"], **safe,
    )


def _zoom_into_interval(st, zoom, middle, v, g, s, value_init, slope_init):
    dec = _decrease_error(middle, v, s, value_init, slope_init)
    curv = _curvature_error(s, slope_init)
    err = torch.maximum(dec, curv)
    safe = _where((dec <= 0.0) & (v < st["safe_value"]), {"safe_stepsize": middle, "safe_value": v, "safe_grad": g},
                  {k: st[k] for k in ("safe_stepsize", "safe_value", "safe_grad")})
    done = err <= 0.0
    set_high_to_middle = (dec > 0.0) | (v >= st["value_low"])
    set_high_to_low = (s * (st["high"] - st["low"]) >= 0.0) & ~set_high_to_middle
    high = _where(set_high_to_middle, dict(high=middle, value_high=v, slope_high=s),
                  {k: st[k] for k in ("high", "value_high", "slope_high")})
    high = _where(set_high_to_low, dict(high=st["low"], value_high=st["value_low"], slope_high=st["slope_low"]), high)
    low = _where(~set_high_to_middle, dict(low=middle, value_low=v, slope_low=s),
                 {k: st[k] for k in ("low", "value_low", "slope_low")})
    ref = _where(set_high_to_middle | set_high_to_low, dict(cubic_ref=st["high"], value_cubic_ref=st["value_high"]),
                 dict(cubic_ref=st["low"], value_cubic_ref=st["value_low"]))
    presumably_failed = (st["count"] + 1 >= _MAX_LINESEARCH_STEPS) | (zoom["too_small"] & (safe["safe_stepsize"] > 0.0))
    return dict(
        st, count=st["count"] + 1, stepsize=middle, value=v, grad=g, slope=s, decrease_error=dec,
        curvature_error=curv, done=done, failed=presumably_failed & ~done, **low, **high, **ref, **safe,
    )


def _try_safe_step(st):
    """A failed search ends at its best step of sufficient decrease, if it
    met one (or at none, where no step had a finite value)."""
    use_safe = (st["safe_stepsize"] > 0.0) | torch.isinf(st["decrease_error"])
    return dict(st, **_where(use_safe, dict(stepsize=st["safe_stepsize"], value=st["safe_value"], grad=st["safe_grad"]),
                             dict(stepsize=st["stepsize"], value=st["value"], grad=st["grad"])))


def lbfgs_update(value_and_grad: Callable, grad, state: LBFGSState, params, value):
    """One ``optax.lbfgs`` update of every problem at ``params`` with its
    ``value`` and ``grad``: ``(new params, new state)``."""
    direction, (dw_mem, du_mem, rhos) = _scale_by_lbfgs(grad, state, params)
    updates = -direction
    stepsize, ls_value, ls_grad, steps = zoom_linesearch(value_and_grad, params, updates, value, grad)
    new_state = LBFGSState(state.count + 1, params, grad, dw_mem, du_mem, rhos, ls_value, ls_grad, steps)
    return params + stepsize[:, None] * updates, new_state
