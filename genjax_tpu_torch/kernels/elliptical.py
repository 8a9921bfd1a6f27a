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
  they run the same chain up to float roundoff.
- ``ess_gauss_sweep``: the CUDA kernel (``csrc/ess_gauss_sweep.cu``), a
  chain block's whole sweep on chip. It replaces the Pallas TPU kernel
  ``_ess_gauss_kernel``.
- ``_reference_ess_gauss``: its plain torch version, step for step.
- ``ess_sweep_gauss_pallas`` routes between them with ``hmc._route``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from ..core.device import entry_device
from . import _build
from .hmc import _RNG_IDS, _counter_stream, _int32, _normal, _route, _uniform_01
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


def _shrink(ll_theta: Callable, log_y, theta0, gen, max_iters: int):
    """The bracket shrink of every chain in one loop with a done mask, until
    all chains are done or ``max_iters`` iterations have run. One host read
    per iteration. Returns ``(theta_acc, done, n_iters)``."""
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
        theta_new = lo + (hi - lo) * torch.rand(n, generator=gen, device=theta0.device)
        theta = torch.where(done, theta, theta_new)
        ok = ll_theta(theta) > log_y
        theta_acc = torch.where(~done & ok, theta, theta_acc)
        counts += (~done).to(torch.int32)
        done = done | ok
        i += 1
    return theta_acc, done, counts


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) ^ _SEED_MIX)


def ess_transition_cols(
    log_lik_cols: Callable,
    q: torch.Tensor,
    gen: torch.Generator,
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
        gen: the ``torch.Generator`` every draw comes from: ``z (D, N)``,
            the slice uniform ``(N,)``, the first angle ``(N,)``, then one
            ``(N,)`` uniform per shrink iteration.
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
    z = torch.randn((d, n), generator=gen, device=q.device)
    nu = _ellipse_draw(chol_prior, z)
    log_y = log_lik_cols(q) + torch.log(torch.rand(n, generator=gen, device=q.device))
    theta0 = torch.rand(n, generator=gen, device=q.device) * _TWO_PI
    centered = q - mean

    def proposal(theta):
        return mean + centered * torch.cos(theta) + nu * torch.sin(theta)

    theta_acc, done, n_iters = _shrink(
        lambda th: log_lik_cols(proposal(th)), log_y, theta0, gen, max_iters
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

    Every value draws from one ``torch.Generator`` on the chains' device,
    seeded with ``seed ^ 0xE5517``; ``rng_impl`` is accepted for the
    reference's signature and selects nothing (the port has no threefry or
    rbg stream)."""
    refuse_row_sharded(log_lik_cols, "ess_sweep_cols")
    q = _f32(q0, None)
    gen = _generator(seed, q.device)
    draws = []
    for _ in range(n_steps):
        q, _ = ess_transition_cols(
            log_lik_cols, q, gen, chol_prior=chol_prior, mean=mean, max_iters=max_iters
        )
        if collect:
            draws.append(q)
    return q, (torch.stack(draws) if collect else None)


def ess_transition_gauss_cols(
    q: torch.Tensor,
    gen: torch.Generator,
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
    :func:`ess_transition_cols`'s, in the same order, so the two run the
    same chain with the matching likelihood.

    Args:
        y: ``(D,)`` or ``(D, 1)`` observations.
        prec: scalar or ``(D,)``/``(D, 1)`` observation precisions.

    Returns ``(q_new, n_iters)`` as :func:`ess_transition_cols`.
    """
    d, n = q.shape
    mean = _col(mean, d, q.device)
    y = _f32(y, q.device).reshape(d, 1)
    prec = _col(prec, d, q.device)

    z = torch.randn((d, n), generator=gen, device=q.device)
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
    log_y = -0.5 * (A + 2.0 * Dc + F) + torch.log(torch.rand(n, generator=gen, device=q.device))
    theta0 = torch.rand(n, generator=gen, device=q.device) * _TWO_PI
    theta_acc, done, n_iters = _shrink(ll_theta, log_y, theta0, gen, max_iters)
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
):
    """``n_steps`` Gaussian-likelihood ESS transitions: the fast path of
    :func:`ess_sweep_cols`, on the same stream (one ``torch.Generator``
    seeded with ``seed ^ 0xE5517``; ``rng_impl`` selects nothing), so the
    two give the same chains for the matching likelihood."""
    q = _f32(q0, None)
    gen = _generator(seed, q.device)
    draws = []
    for _ in range(n_steps):
        q, _ = ess_transition_gauss_cols(
            q, gen, chol_prior=chol_prior, y=y, prec=prec, mean=mean, max_iters=max_iters
        )
        if collect:
            draws.append(q)
    return q, (torch.stack(draws) if collect else None)


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


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def geometry(d: int) -> dict:
    """K3's launch geometry at dimension ``d``: its variant, the dynamic
    shared memory of a block in bytes, the tiles of ``chol`` the tiled
    variant marks for its zero-tile skip (0 in the generic variant), and the
    threads of a block."""
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
    lib.ess_gauss_sweep.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, P]
    lib.ess_gauss_sweep.restype = I
    lib.ess_gauss_geometry.argtypes = [I, P]
    lib.ess_gauss_geometry.restype = None
    lib.ess_gauss_smem_limit.argtypes = [I]
    lib.ess_gauss_smem_limit.restype = I
    lib.ess_gauss_kernel_info.argtypes = [I, P]
    lib.ess_gauss_kernel_info.restype = I
    return lib


def geometry_cuda(d: int) -> dict:
    """:func:`geometry` as the compiled kernel reckons it."""
    out = (ctypes.c_long * 4)()
    _lib().ess_gauss_geometry(d, out)
    return {"variant": VARIANTS[out[0]], "smem_bytes": out[1], "tiles": out[2], "threads": out[3]}


@functools.cache
def _smem_limit(device_index: int) -> int:
    limit = _lib().ess_gauss_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(f"could not read the shared-memory limit of CUDA device {device_index}")
    return limit


def kernel_info(d: int) -> dict:
    """The CUDA runtime's view of K3 at ``D = d``: registers a thread, local
    (spill) bytes a thread, resident blocks an SM."""
    out = (ctypes.c_int * 3)()
    err = _lib().ess_gauss_kernel_info(d, out)
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
) -> torch.Tensor:
    """Launch the CUDA Gaussian-ESS kernel on the current stream, without
    synchronising. ``q0`` is a contiguous float32 CUDA tensor ``(D, N)`` and
    ``chol`` a contiguous float32 CUDA tensor ``(D, D)``; ``y``, ``prec``
    and ``mean`` are scalars or hold ``D`` values each. Inputs already on
    the card as contiguous float32 ``(D,)`` (or ``(D, 1)``) tensors are
    passed as they are, with no copy. ``rng="counter"`` is the counter
    stream for chain block ``block_n`` (required, dividing ``N``);
    ``rng="philox"`` draws from Philox keyed by (seed, chain). The variant
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
    if rng not in _RNG_IDS:
        raise ValueError(f"rng must be 'philox' or 'counter', got {rng!r}")
    if rng == "counter" and (block_n is None or block_n < 1 or n % block_n):
        raise ValueError(f"the counter stream needs a chain block dividing N={n}: got block_n={block_n}")
    if n_steps < 0 or max_iters < 0:
        raise ValueError("n_steps and max_iters must be non-negative")
    geo = geometry(d)
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
    q_out = torch.empty_like(q0)
    with torch.cuda.device(q0.device):
        err = _lib().ess_gauss_sweep(
            q0.data_ptr(), q_out.data_ptr(), chol.data_ptr(), y.data_ptr(), prec.data_ptr(),
            mean.data_ptr(), d, n, n_steps, max_iters, _int32(seed), _RNG_IDS[rng],
            block_n or 1, torch.cuda.current_stream(q0.device).cuda_stream,
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
    backend = _route(backend, device, True)
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
