"""Elliptical slice sampling (Murray, Adams & MacKay 2010) in the column
layout, and the Gaussian-likelihood ESS sweep as one CUDA kernel (K3).

Counterpart of ``genjax_tpu/kernels/elliptical.py``. ESS targets
``p(f) ∝ N(f; mu, Sigma) L(f)`` with no step size and acceptance 1: each
transition draws an ellipse through the current state and a prior draw,
then shrinks an angle bracket until the likelihood clears a slice level.
Positions are ``(D, N)`` float32, chains on the last axis.

- ``ess_transition_cols`` / ``ess_sweep_cols``: any column log-likelihood.
- ``ess_transition_gauss_cols`` / ``ess_sweep_gauss_cols``: the fast path
  for a Gaussian likelihood, whose value along the ellipse is a
  trigonometric quadratic with six per-chain coefficients.

  Both shrink all chains in one Python loop with a per-chain done mask and
  the collective exit ``~all(done)`` (one host read per iteration), and
  draw the same numbers in the same order, so with the matching likelihood
  they run the same chain up to float roundoff. A transition draws under a
  key (``core/keys.py``) what the reference's draws under the same key, or
  in sequence from a ``torch.Generator``; a sweep with an int seed draws the
  reference's stream, ``jax.random.key(seed ^ 0xE5517)`` (threefry, or rbg
  with ``rng_impl="rbg"``), step ``i`` under ``fold_in(root, i)``, and a
  generator in the seed's place draws from it in sequence.
- ``ess_gauss_sweep``: the CUDA kernel (``csrc/ess_gauss_sweep.cu``), a
  chain block's whole sweep on chip. It replaces the Pallas TPU kernel
  ``_ess_gauss_kernel``. On the counter and Philox streams its plain torch
  version is ``_reference_ess_gauss``, step for step, and
  ``ess_sweep_gauss_pallas`` routes between them with ``hmc._route``; on
  the keyed streams (``"threefry"``, ``"rbg"``) it draws what
  ``ess_sweep_gauss_cols`` draws from the same seed, and
  ``ess_sweep_gauss_cols`` routes between the kernel and itself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from ..core import keys
from ..core.device import entry_device
from . import _build
from .hmc import _M32, _counter_stream, _int32, _normal, _route, _uniform_01
from .rows import refuse_row_sharded

_TWO_PI = 6.283185307179586
_SEED_MIX = 0xE5517

# launches of the CUDA Gaussian-ESS kernel in this process
ess_gauss_sweep_launches = 0


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _col(x, d: int, device) -> torch.Tensor:
    """A scalar, ``(D,)`` or ``(D, 1)`` value as a ``(D, 1)`` column."""
    return torch.broadcast_to(_f32(x, device).reshape(-1, 1), (d, 1))


def _ellipse_draw(chol_prior, z: torch.Tensor) -> torch.Tensor:
    """``nu = chol_prior @ z`` for a ``(D, D)`` factor; a ``(D,)`` or scalar
    factor is a diagonal prior standard deviation."""
    chol = _f32(chol_prior, z.device)
    if chol.ndim == 2:
        return chol @ z
    return chol.reshape(-1, 1) * z if chol.ndim == 1 else chol * z


def _shrink(ll_theta: Callable, log_y, theta0, uniform: Callable, max_iters: int):
    """The bracket shrink of every chain in one loop with a done mask, until
    all chains are done or ``max_iters`` iterations have run; iteration ``i``
    takes the ``(N,)`` uniforms ``uniform(i)``. One host read per iteration.
    Returns ``(theta_acc, done, n_iters)``."""
    n = theta0.shape[0]
    lo, hi = theta0 - _TWO_PI, theta0
    theta = theta_acc = theta0
    done = ll_theta(theta0) > log_y
    counts = torch.zeros(n, dtype=torch.int32, device=theta0.device)
    i = 0
    while i < max_iters and not bool(done.all()):
        # shrink the bracket toward 0 on the rejected side
        keep = done | (theta >= 0)
        lo = torch.where(keep, lo, theta)
        hi = torch.where(keep, theta, hi)
        theta_new = lo + (hi - lo) * uniform(i)
        theta = torch.where(done, theta, theta_new)
        ok = ll_theta(theta) > log_y
        theta_acc = torch.where(~done & ok, theta, theta_acc)
        counts += (~done).to(torch.int32)
        done = done | ok
        i += 1
    return theta_acc, done, counts


#: The shrink uniforms a keyed transition draws at once: iterations ``i ..
#: i + 7`` in one hash (the loop rarely runs past 16).
_SHRINK_CHUNK = 8


def _transition_draws(stream, d: int, n: int, device):
    """A transition's draws: ``(z (D, N), u (N,), theta0 (N,), uniform)``,
    ``uniform(i)`` the ``(N,)`` uniforms of shrink iteration ``i``. Under a
    key, the reference's: ``k_nu, k_u, k_theta = split(key, 3)``, ``z =
    normal(k_nu)``, the slice uniform from ``k_u``, the first angle's from
    ``k_theta`` and iteration ``i``'s from ``fold_in(k_theta, i + 1)``
    (made ``_SHRINK_CHUNK`` iterations at a time); under a generator, the
    same shapes drawn in that order."""
    if keys.is_key(stream):
        if stream.device != torch.device(device):
            raise ValueError(f"the key is on {stream.device} and the chains on {device}")
        k_nu, k_u, k_theta = keys.split(stream, 3).unbind(-2)
        chunks = {}

        def uniform(i):
            c = i // _SHRINK_CHUNK
            if c not in chunks:
                first = c * _SHRINK_CHUNK + 1
                ks = keys.fold_in(k_theta, torch.arange(first, first + _SHRINK_CHUNK, device=stream.device))
                chunks[c] = keys.uniform(ks, (n,))
            return chunks[c][i % _SHRINK_CHUNK]

        return keys.normal(k_nu, (d, n)), keys.uniform(k_u, (n,)), keys.uniform(k_theta, (n,)) * _TWO_PI, uniform
    z = torch.randn((d, n), generator=stream, device=device)
    u = torch.rand(n, generator=stream, device=device)
    theta0 = torch.rand(n, generator=stream, device=device) * _TWO_PI
    return z, u, theta0, lambda _i: torch.rand(n, generator=stream, device=device)


_IMPLS = {None: "threefry2x32", "threefry2x32": "threefry2x32", "rbg": "rbg"}


def _impl(rng_impl) -> str:
    """The key implementation ``rng_impl`` names, as ``jax.random.key(...,
    impl=rng_impl)`` reads it (None: threefry2x32)."""
    if rng_impl not in _IMPLS:
        raise ValueError(f"rng_impl must be None, 'threefry2x32' or 'rbg', got {rng_impl!r}")
    return _IMPLS[rng_impl]


def _step_keys(seed, rng_impl, device):
    """The stream of a sweep given ``seed``: a function of the step index
    that gives the step's key, ``fold_in(key(seed ^ 0xE5517), i)`` for an
    int seed, as the reference's ``lax.scan`` folds; a ``torch.Generator``
    in the seed's place is drawn in sequence (the same generator every
    step)."""
    if isinstance(seed, torch.Generator):
        return lambda _i: seed
    root = keys.key(int(seed) ^ _SEED_MIX, device=device, impl=_impl(rng_impl))
    return lambda i: keys.fold_in(root, i)


def ess_transition_cols(
    log_lik_cols: Callable,
    q: torch.Tensor,
    gen,
    *,
    chol_prior,
    mean=0.0,
    max_iters: int = 64,
):
    """One elliptical-slice transition for every chain column.

    Args:
        log_lik_cols: ``(D, N) -> (N,)`` log-likelihood (not including the
            Gaussian prior, which is sampled exactly on the ellipse).
        q: ``(D, N)`` current positions.
        gen: a key (``core/keys.py``, on ``q``'s device), under which the
            draws are the reference's under the same key (``split(gen,
            3)``: ``z (D, N)`` from the first, the slice uniform ``(N,)``
            from the second, the first angle from the third and shrink
            iteration ``i``'s uniform from ``fold_in(third, i + 1)``), or a
            ``torch.Generator``, drawn in that order.
        chol_prior: ``(D, D)`` lower Cholesky factor of the prior covariance,
            or a ``(D,)``/scalar standard deviation for a diagonal prior.
        mean: prior mean, scalar, ``(D,)`` or ``(D, 1)``.
        max_iters: cap on shrink iterations; a chain at the cap keeps its
            current point (an exact no-op move).

    Returns ``(q_new, n_iters)``, ``n_iters`` the ``(N,)`` per-chain shrink
    iteration counts (0 = first proposal accepted).
    """
    refuse_row_sharded(log_lik_cols, "ess_transition_cols")
    d, n = q.shape
    mean = _col(mean, d, q.device)
    z, u, theta0, uniform = _transition_draws(gen, d, n, q.device)
    nu = _ellipse_draw(chol_prior, z)
    log_y = log_lik_cols(q) + torch.log(u)
    centered = q - mean

    def proposal(theta):
        return mean + centered * torch.cos(theta) + nu * torch.sin(theta)

    theta_acc, done, n_iters = _shrink(
        lambda th: log_lik_cols(proposal(th)), log_y, theta0, uniform, max_iters
    )
    return torch.where(done[None, :], proposal(theta_acc), q), n_iters


def ess_sweep_cols(
    log_lik_cols: Callable,
    q0,
    seed: int,
    *,
    n_steps: int,
    chol_prior,
    mean=0.0,
    max_iters: int = 64,
    collect: bool = False,
    rng_impl: str | None = None,
):
    """``n_steps`` elliptical-slice transitions. Returns ``(q_final, draws)``
    with ``draws`` of shape ``(n_steps, D, N)`` when ``collect`` else
    ``None``.

    An int ``seed`` draws the reference's stream on the chains' device: the
    root key ``key(seed ^ 0xE5517)``, threefry2x32, or rbg with
    ``rng_impl="rbg"``, and step ``i`` under ``fold_in(root, i)``, so the
    chains are the reference's draw for draw. A ``torch.Generator`` in the
    seed's place (on the chains' device) is drawn from in sequence."""
    refuse_row_sharded(log_lik_cols, "ess_sweep_cols")
    q = _f32(q0, None)
    step_key = _step_keys(seed, rng_impl, q.device)
    draws = []
    for i in range(n_steps):
        q, _ = ess_transition_cols(
            log_lik_cols, q, step_key(i), chol_prior=chol_prior, mean=mean, max_iters=max_iters
        )
        if collect:
            draws.append(q)
    return q, (torch.stack(draws) if collect else None)


def ess_transition_gauss_cols(
    q: torch.Tensor,
    gen,
    *,
    chol_prior,
    y,
    prec=1.0,
    mean=0.0,
    max_iters: int = 64,
):
    """One elliptical-slice transition for a Gaussian (diagonal-quadratic)
    log-likelihood ``ll(f) = -1/2 sum_d prec_d (f_d - y_d)^2`` (+ const).

    Along the ellipse ``f(theta) = m + c cos(theta) + nu sin(theta)``,
    ``ll(theta) = -1/2 [A cos^2 + B sin^2 + 2C cos sin + 2D cos + 2E sin
    + F]``, whose coefficients are per-chain sums over dimensions computed
    once per transition; every shrink iteration is then O(N). The draws are
    :func:`ess_transition_cols`'s under a key or a generator ``gen``, so
    the two run the same chain with the matching likelihood.

    Args:
        y: ``(D,)`` or ``(D, 1)`` observations.
        prec: scalar or ``(D,)``/``(D, 1)`` observation precisions.

    Returns ``(q_new, n_iters)`` as :func:`ess_transition_cols`.
    """
    d, n = q.shape
    mean = _col(mean, d, q.device)
    y = _f32(y, q.device).reshape(d, 1)
    prec = _col(prec, d, q.device)

    z, u, theta0, uniform = _transition_draws(gen, d, n, q.device)
    nu = _ellipse_draw(chol_prior, z)
    c = q - mean
    r0 = mean - y  # (D, 1): chain-independent residual of the prior mean
    A = torch.sum(prec * c * c, dim=0)
    B = torch.sum(prec * nu * nu, dim=0)
    Cc = torch.sum(prec * c * nu, dim=0)
    Dc = torch.sum(prec * c * r0, dim=0)
    E = torch.sum(prec * nu * r0, dim=0)
    F = torch.sum(prec * r0 * r0)

    def ll_theta(theta):
        ct, st = torch.cos(theta), torch.sin(theta)
        return -0.5 * (A * ct * ct + B * st * st + 2.0 * Cc * ct * st + 2.0 * Dc * ct + 2.0 * E * st + F)

    # ll at the current point is theta = 0: cos = 1, sin = 0
    log_y = -0.5 * (A + 2.0 * Dc + F) + torch.log(u)
    theta_acc, done, n_iters = _shrink(ll_theta, log_y, theta0, uniform, max_iters)
    q_new = mean + c * torch.cos(theta_acc) + nu * torch.sin(theta_acc)
    return torch.where(done[None, :], q_new, q), n_iters


def ess_sweep_gauss_cols(
    q0,
    seed: int,
    *,
    n_steps: int,
    chol_prior,
    y,
    prec=1.0,
    mean=0.0,
    max_iters: int = 64,
    collect: bool = False,
    rng_impl: str | None = None,
    backend: str = "auto",
):
    """``n_steps`` Gaussian-likelihood ESS transitions: the fast path of
    :func:`ess_sweep_cols`, on the same stream (an int ``seed`` draws the
    reference's, ``key(seed ^ 0xE5517)`` as threefry2x32 or, with
    ``rng_impl="rbg"``, rbg; a ``torch.Generator`` in its place is drawn in
    sequence), so the two give the same chains for the matching likelihood.

    It runs where ``q0`` lives. ``backend="auto"`` (default) launches K3's
    keyed kernel for chains on the card (``ess_gauss_sweep`` with
    ``rng="threefry"`` or ``"rbg"``, one launch a call, or a step with
    ``collect``; a generator raises there, since the kernel draws the keyed
    stream) and runs this plain torch version for chains on the CPU;
    ``"torch"`` runs the plain version anywhere, which is the keyed kernel's
    plain version; ``"cuda"`` the kernel. The route is recorded on
    ``ess_sweep_gauss_cols.last_backend``."""
    q = _f32(q0, None)
    backend = _route(backend, q.device)
    if backend == "cuda":
        if isinstance(seed, torch.Generator):
            raise ValueError(
                "ess_sweep_gauss_cols: K3 draws the keyed stream of an int seed; a torch.Generator's "
                "stream runs with backend='torch'"
            )
        q, draws = _keyed_sweep_cuda(
            q, seed, n_steps=n_steps, chol_prior=chol_prior, y=y, prec=prec, mean=mean,
            max_iters=max_iters, collect=collect, rng="rbg" if _impl(rng_impl) == "rbg" else "threefry",
        )
    else:
        step_key = _step_keys(seed, rng_impl, q.device)
        draws = []
        for i in range(n_steps):
            q, _ = ess_transition_gauss_cols(
                q, step_key(i), chol_prior=chol_prior, y=y, prec=prec, mean=mean, max_iters=max_iters
            )
            if collect:
                draws.append(q)
        draws = torch.stack(draws) if collect else None
    ess_sweep_gauss_cols.last_backend = backend
    return q, draws


ess_sweep_gauss_cols.last_backend = None


def _keyed_sweep_cuda(q, seed, *, n_steps, chol_prior, y, prec, mean, max_iters, collect, rng):
    """``ess_sweep_gauss_cols`` on K3's keyed kernel: the inputs as
    ``ess_sweep_gauss_pallas`` takes them (a diagonal factor for a scalar or
    ``(D,)`` ``chol_prior``), one launch, or one a step with ``collect``."""
    d = q.shape[0]
    chol = _f32(chol_prior, q.device)
    if chol.ndim < 2:
        chol = torch.diag(torch.broadcast_to(chol.reshape(-1), (d,)))
    kw = dict(chol=chol.contiguous(), y=y, prec=prec, mean=mean, max_iters=max_iters, rng=rng)
    q = q.contiguous()
    if not collect:
        return ess_gauss_sweep(q, seed, n_steps=n_steps, **kw), None
    draws = []
    for i in range(n_steps):
        q = ess_gauss_sweep(q, seed, n_steps=1, first_step=i, **kw)
        draws.append(q)
    return q, torch.stack(draws)


# ----------------------------------------------------------------------
# K3: the Gaussian-ESS sweep, its plain version and its routing
# ----------------------------------------------------------------------


def _reference_ess_gauss(
    q0: torch.Tensor,
    seed_or_generator,
    *,
    n_steps: int,
    chol: torch.Tensor,
    y: torch.Tensor,
    prec: torch.Tensor,
    mean: torch.Tensor,
    max_iters: int = 24,
    rng: str = "generator",
    block_n: int | None = None,
) -> torch.Tensor:
    """Plain torch version of the kernel, step for step as the reference's
    ``_ess_gauss_kernel``: per step the ellipse draw ``nu = chol @ z``, the
    coefficient rows, the slice level and first angle, all ``max_iters``
    shrink uniforms in one draw, the shrink unrolled to ``max_iters`` with a
    done mask, and ``q = m + c cos + nu sin`` where done (capped chains keep
    ``q``). ``chol`` is ``(D, D)``; ``y``, ``prec`` and ``mean`` are
    ``(D, 1)``.

    ``rng="counter"`` is the reference's interpret-mode stream for chain
    block ``block_n`` (required): step ``i`` draws ``z`` on salts ``s`` and
    ``s + 1`` over ``(D, block)``, the slice uniform on ``s + 4`` and the
    angle on ``s + 5`` over ``(1, block)``, and the shrink uniforms on
    ``s + 6`` over ``(max_iters, block)``, with ``s = i (8 + max_iters)``.
    ``rng="generator"`` draws the same shapes from a ``torch.Generator``
    (the one given, or one on ``q0``'s device seeded with the int given).

    Returns ``q`` ``(D, N)``.
    """
    d, n = q0.shape
    device = q0.device
    if rng == "counter":
        if block_n is None:
            raise ValueError("the counter stream needs its chain block: pass block_n")
        bits = _counter_stream(int(seed_or_generator), n, block_n, device)

        def draws(salt):
            return (
                _normal(bits, (d, n), salt),
                _uniform_01(bits, (1, n), salt + 4),
                _uniform_01(bits, (1, n), salt + 5),
                _uniform_01(bits, (max_iters, n), salt + 6),
            )

    elif rng == "generator":
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(gen))

        def draws(_salt):
            return (
                torch.randn((d, n), generator=gen, device=device),
                torch.rand((1, n), generator=gen, device=device),
                torch.rand((1, n), generator=gen, device=device),
                torch.rand((max_iters, n), generator=gen, device=device),
            )

    else:
        raise ValueError(f"rng must be 'generator' or 'counter', got {rng!r}")

    r0 = mean - y
    f_coef = torch.sum(prec * r0 * r0)
    q = q0.to(torch.float32)
    for i in range(n_steps):
        z, u, u_theta, u_all = draws(i * (8 + max_iters))
        nu = chol @ z
        c = q - mean
        a_c = torch.sum(prec * c * c, dim=0, keepdim=True)  # (1, N)
        b_c = torch.sum(prec * nu * nu, dim=0, keepdim=True)
        cc = torch.sum(prec * c * nu, dim=0, keepdim=True)
        dc = torch.sum(prec * c * r0, dim=0, keepdim=True)
        e_c = torch.sum(prec * nu * r0, dim=0, keepdim=True)

        def ll_theta(theta):
            ct, st = torch.cos(theta), torch.sin(theta)
            return -0.5 * (
                a_c * ct * ct + b_c * st * st + 2.0 * cc * ct * st + 2.0 * dc * ct
                + 2.0 * e_c * st + f_coef
            )

        log_y = -0.5 * (a_c + 2.0 * dc + f_coef) + torch.log(u)
        theta0 = u_theta * _TWO_PI
        done = ll_theta(theta0) > log_y
        lo, hi = theta0 - _TWO_PI, theta0
        th = th_acc = theta0
        for j in range(max_iters):
            keep = done | (th >= 0)
            lo = torch.where(keep, lo, th)
            hi = torch.where(keep, th, hi)
            th = torch.where(done, th, lo + (hi - lo) * u_all[j : j + 1])
            ok = ll_theta(th) > log_y
            th_acc = torch.where(~done & ok, th, th_acc)
            done = done | ok
        q_new = mean + c * torch.cos(th_acc) + nu * torch.sin(th_acc)
        q = torch.where(done, q_new, q)
    return q


# K3's geometry (the kernel's constants): 64 chains a block. The tiled
# variant (D <= 256; 256 compute threads and a copy warp) cuts chol into
# tiles of 16 rows by 32 columns and keeps in shared memory a two-stage ring
# of chol's tiles (rows padded to 16; it holds nu between the product and
# the update) with 1 KiB for its alignment, q (D x 64) and z (rows padded to
# 32, 72 floats a row). The generic variant (256 threads) keeps q and nu
# (D x 64), a transposed 16 x 260 chol slab and a 16 x 64 z slab.
NB = 64
_PARTS, _COEFS = 4, 5
_BAND, _SLAB, _STAGES, _TILED_MAX_DIM = 16, 32, 2, 256
_Z_STRIDE = NB + 8
_TK, _CHOL_STRIDE = 16, 256 + 4
VARIANTS = ("tiled", "generic")  # the kernel's ids 0 and 1
# K3's streams and their ids in the kernel (column_common.cuh's Rng); the
# keyed streams' kernels are their own (ess_tiled_keyed_kernel,
# ess_generic_keyed_kernel)
RNG_IDS = {"counter": 0, "philox": 1, "rbg": 2, "threefry": 3}
KEYED = ("threefry", "rbg")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _rng_id(rng: str) -> int:
    if rng not in RNG_IDS:
        raise ValueError(f"rng must be one of {sorted(RNG_IDS)}, got {rng!r}")
    return RNG_IDS[rng]


def _kernel_name(variant: str, rng: str) -> str:
    _rng_id(rng)
    return f"ess_{variant}_keyed_kernel<{rng}>" if rng in KEYED else f"ess_{variant}_kernel"


def geometry(d: int, rng: str = "philox") -> dict:
    """K3's launch geometry at dimension ``d`` on stream ``rng``: its
    variant, the dynamic shared memory of a block in bytes, the tiles of
    ``chol`` the tiled variant marks for its zero-tile skip (0 in the
    generic variant), the threads of a block, and the kernel that runs (a
    keyed stream's own, which adds its step keys' static shared memory to
    the same dynamic shared memory)."""
    geo = _geometry(d)
    return {**geo, "kernel": _kernel_name(geo["variant"], rng)}


def _geometry(d: int) -> dict:
    floats = _PARTS * _COEFS * NB + 3 * NB + 3 * d  # partial sums, angles, prec / mean / r0
    if d > _TILED_MAX_DIM:
        floats += 2 * d * NB + _TK * _CHOL_STRIDE + _TK * NB
        return {"variant": "generic", "smem_bytes": 4 * floats, "tiles": 0, "threads": 256}
    ring = _STAGES * _round_up(d, _BAND) * _SLAB + 256  # and its 1024-byte alignment
    floats += ring + d * NB + _round_up(d, _SLAB) * _Z_STRIDE
    tiles = (_round_up(d, _BAND) // _BAND) * (_round_up(d, _SLAB) // _SLAB)
    return {"variant": "tiled", "smem_bytes": 4 * floats, "tiles": tiles, "threads": 256 + 32}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ess_gauss_sweep")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ess_gauss_sweep.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, P, I, P]
    lib.ess_gauss_sweep.restype = I
    lib.ess_gauss_geometry.argtypes = [I, P]
    lib.ess_gauss_geometry.restype = None
    lib.ess_gauss_smem_limit.argtypes = [I]
    lib.ess_gauss_smem_limit.restype = I
    lib.ess_gauss_kernel_info.argtypes = [I, I, P]
    lib.ess_gauss_kernel_info.restype = I
    return lib


def geometry_cuda(d: int, rng: str = "philox") -> dict:
    """:func:`geometry` as the compiled kernel reckons it."""
    out = (ctypes.c_long * 4)()
    _lib().ess_gauss_geometry(d, out)
    variant = VARIANTS[out[0]]
    return {"variant": variant, "smem_bytes": out[1], "tiles": out[2], "threads": out[3],
            "kernel": _kernel_name(variant, rng)}


@functools.cache
def _smem_limit(device_index: int) -> int:
    limit = _lib().ess_gauss_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(f"could not read the shared-memory limit of CUDA device {device_index}")
    return limit


def kernel_info(d: int, rng: str = "philox") -> dict:
    """The CUDA runtime's view of K3 at ``D = d`` on stream ``rng`` (a keyed
    stream's own kernel for ``"threefry"`` and ``"rbg"``): registers a
    thread, local (spill) bytes a thread, resident blocks an SM."""
    out = (ctypes.c_int * 3)()
    err = _lib().ess_gauss_kernel_info(d, _rng_id(rng), out)
    if err != 0:
        raise RuntimeError(f"ess_gauss_kernel_info failed with CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2]}


def ess_gauss_sweep(
    q0: torch.Tensor,
    seed: int,
    *,
    n_steps: int,
    chol: torch.Tensor,
    y,
    prec,
    mean,
    max_iters: int = 24,
    rng: str = "philox",
    block_n: int | None = None,
    first_step: int = 0,
) -> torch.Tensor:
    """Launch the CUDA Gaussian-ESS kernel on the current stream, without
    synchronising. ``q0`` is a contiguous float32 CUDA tensor ``(D, N)`` and
    ``chol`` a contiguous float32 CUDA tensor ``(D, D)``; ``y``, ``prec``
    and ``mean`` are scalars or hold ``D`` values each. Inputs already on
    the card as contiguous float32 ``(D,)`` (or ``(D, 1)``) tensors are
    passed as they are, with no copy. ``rng="counter"`` is the counter
    stream for chain block ``block_n`` (required, dividing ``N``);
    ``rng="philox"`` draws from Philox keyed by (seed, chain).
    ``rng="threefry"`` and ``"rbg"`` launch the keyed kernel, which draws
    what ``ess_sweep_gauss_cols(q0, seed, rng_impl=...)`` draws (the root
    key ``key(seed ^ 0xE5517)`` of that stream, made here, and the launch's
    step ``i`` that sweep's step ``first_step + i``; any ``N``). The variant
    (:func:`geometry`) is recorded on ``ess_gauss_sweep.last_variant``.

    Returns ``q`` ``(D, N)``.
    """
    global ess_gauss_sweep_launches
    for name, t in (("q0", q0), ("chol", chol)):
        if not (isinstance(t, torch.Tensor) and t.is_cuda):
            raise ValueError(f"ess_gauss_sweep takes CUDA tensors; {name} is not one")
        if t.dtype != torch.float32 or t.ndim != 2 or not t.is_contiguous():
            raise ValueError(
                f"ess_gauss_sweep takes a contiguous float32 2-D {name}, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    d, n = q0.shape
    if tuple(chol.shape) != (d, d) or chol.device != q0.device:
        raise ValueError(f"chol must be ({d}, {d}) on {q0.device}, got {tuple(chol.shape)} on {chol.device}")
    rng_id = _rng_id(rng)
    if rng == "counter" and (block_n is None or block_n < 1 or n % block_n):
        raise ValueError(f"the counter stream needs a chain block dividing N={n}: got block_n={block_n}")
    if n_steps < 0 or max_iters < 0 or first_step < 0:
        raise ValueError("n_steps, max_iters and first_step must be non-negative")
    geo = geometry(d, rng)
    y, prec, mean = (
        torch.broadcast_to(_f32(v, q0.device).reshape(-1), (d,)).contiguous() for v in (y, prec, mean)
    )
    device_index = q0.device.index if q0.device.index is not None else torch.cuda.current_device()
    smem, limit = geo["smem_bytes"], _smem_limit(device_index)
    if smem > limit:
        raise ValueError(
            f"K3 needs {smem} B of shared memory per block at D={d}; this card allows {limit} B "
            f"per block (cudaDevAttrMaxSharedMemoryPerBlockOptin)"
        )
    # key(seed ^ 0xE5517)'s words: (0, s) for threefry2x32, (0, s, 0, s) for rbg
    s = (int(seed) ^ _SEED_MIX) & _M32
    root = (ctypes.c_uint32 * 4)(0, s, 0, s if rng == "rbg" else 0)
    q_out = torch.empty_like(q0)
    with torch.cuda.device(q0.device):
        err = _lib().ess_gauss_sweep(
            q0.data_ptr(), q_out.data_ptr(), chol.data_ptr(), y.data_ptr(), prec.data_ptr(),
            mean.data_ptr(), d, n, n_steps, max_iters, _int32(seed), rng_id,
            block_n or 1, ctypes.cast(root, ctypes.c_void_p), int(first_step),
            torch.cuda.current_stream(q0.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ess_gauss_sweep kernel launch failed with CUDA error {err}")
    ess_gauss_sweep_launches += 1
    ess_gauss_sweep.last_variant = geo["variant"]
    return q_out


ess_gauss_sweep.last_variant = None


def _default_block_n(d: int, n: int) -> int:
    """The reference's chain block: an 8 MiB budget over about six live
    ``(D, NB)`` float32 buffers, a multiple of 128 dividing ``n`` where one
    exists."""
    budget = 8 * 1024 * 1024
    block_n = min(2048, n, max(128, budget // (6 * 4 * max(d, 1))))
    block_n = max(128, (block_n // 128) * 128)
    block_n = min(block_n, n)
    while n % block_n and block_n > 128:
        block_n -= 128
    return block_n


def ess_sweep_gauss_pallas(
    q0,
    seed: int,
    *,
    n_steps: int,
    chol_prior,
    y,
    prec=1.0,
    mean=0.0,
    max_iters: int = 24,
    block_n: int | None = None,
    interpret: bool = False,
    backend: str = "auto",
    device="cuda",
) -> torch.Tensor:
    """:func:`ess_sweep_gauss_cols` as one kernel launch: ``n_steps``
    Gaussian-likelihood ESS transitions with the shrink unrolled to
    ``max_iters`` (capped chains keep their point).

    Inputs are normalised as the reference does: a scalar or ``(D,)``
    ``chol_prior`` becomes a diagonal factor, and ``y``, ``prec`` and
    ``mean`` become ``(D, 1)``. ``block_n`` defaults to the reference's
    chain block and must divide the chain count.

    It runs on the card unless the caller asks for the CPU: ``q0``,
    ``chol_prior``, ``y``, ``prec`` and ``mean`` are placed on ``device``
    (``"cuda"`` by default; with no card that raises, naming
    ``device="cpu"``). Inputs already there as float32 tensors are used as
    they are, with no copy: a caller of many sweeps keeps ``chol`` on the
    card and passes it to each call.

    Backends: ``"cuda"`` is the kernel (needs chains on the card),
    ``"torch"`` the plain version ``_reference_ess_gauss``, and ``"auto"``
    (default) takes ``"cuda"`` for chains on the card and ``"torch"`` for
    chains on the CPU (``device="cpu"``). ``interpret=True`` selects the
    counter stream, the port of the reference's interpret-mode PRNG for
    chain block ``block_n``; otherwise the kernel draws from Philox and the
    plain version from a ``torch.Generator`` seeded with ``seed``. The
    backend taken is recorded on ``ess_sweep_gauss_pallas.last_backend``.

    Returns ``q`` of shape ``(D, N)``.
    """
    device = entry_device(device, "ess_sweep_gauss_pallas")
    q0 = _f32(q0, device)
    d, n = q0.shape
    chol = _f32(chol_prior, device)
    if chol.ndim < 2:
        # scalar or (D,) standard deviations -> diagonal factor
        chol = torch.diag(torch.broadcast_to(chol.reshape(-1), (d,)))
    y = _f32(y, device).reshape(d, 1)
    prec, mean = (_col(v, d, device) for v in (prec, mean))

    if block_n is None:
        block_n = _default_block_n(d, n)
    if n % block_n:
        raise ValueError(
            f"n_chains={n} must be divisible by block_n={block_n} "
            "(pad the chain count or pass block_n explicitly)"
        )
    backend = _route(backend, device)
    if backend == "cuda":
        q = ess_gauss_sweep(
            q0.contiguous(), seed, n_steps=n_steps, chol=chol.contiguous(), y=y, prec=prec, mean=mean,
            max_iters=max_iters, rng="counter" if interpret else "philox", block_n=block_n,
        )
    else:
        q = _reference_ess_gauss(
            q0, seed, n_steps=n_steps, chol=chol, y=y, prec=prec, mean=mean, max_iters=max_iters,
            rng="counter" if interpret else "generator", block_n=block_n,
        )
    ess_sweep_gauss_pallas.last_backend = backend
    return q


ess_sweep_gauss_pallas.last_backend = None
