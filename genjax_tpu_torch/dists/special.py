"""Special math for the distribution catalog.

Counterpart of ``genjax_tpu/dists/special.py``: the Bessel functions
``log I_v`` and ``log I_0``, the Lambert W function (torch has none, so the
reference's fixed Halley iteration), ``erfcinv``, Gauss-Legendre nodes, and
the samplers that need more than one uniform: von Mises, Zipf, the power
spherical and von Mises-Fisher families. Everything runs at static shapes in
float32 with no host read, so that the samplers run under
``torch.func.vmap``: a rejection sampler takes a fixed number of rounds
(``_masked_rejection``) and keeps each lane's first accepted proposal.
Samplers draw from the caller's ``torch.Generator`` on its device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32) if device is None else x.to(device, torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _log_iv_hankel(v, x, num_terms: int = 10):
    """Hankel's large-argument expansion ``I_v(x) ~ e^x / sqrt(2 pi x)
    sum_k (-1)^k a_k(v) / x^k``, accurate for ``x >> v^2``."""
    t = torch.ones_like(x)
    s = t
    for k in range(1, num_terms):
        t = t * -(4.0 * v * v - (2.0 * k - 1.0) ** 2) / (k * 8.0 * x)
        s = s + t
    return x - 0.5 * torch.log(2.0 * math.pi * x) + torch.log(torch.clamp_min(s, 1e-30))


def _log_iv_uniform(v, x):
    """Olver's uniform large-order expansion (A&S 9.7.7), three ``u_k``
    terms."""
    z = x / v
    s = torch.sqrt(1.0 + z * z)
    t = 1.0 / s
    eta = s + torch.log(z / (1.0 + s))
    u1 = (3.0 * t - 5.0 * t**3) / 24.0
    u2 = (81.0 * t**2 - 462.0 * t**4 + 385.0 * t**6) / 1152.0
    u3 = (30375.0 * t**3 - 369603.0 * t**5 + 765765.0 * t**7 - 425425.0 * t**9) / 414720.0
    corr = 1.0 + u1 / v + u2 / v**2 + u3 / v**3
    return (
        -0.5 * torch.log(2.0 * math.pi * v)
        + v * eta
        - 0.5 * torch.log(s)
        + torch.log(torch.clamp_min(corr, 1e-30))
    )


def log_bessel_iv(v, x, num_terms: int = 512):
    """``log I_v(x)`` for ``v >= 0``, ``x >= 0``: the ascending series in
    log space over ``num_terms`` static terms for ``x < 400``, Hankel's
    expansion (``v <= 10``) or Olver's (larger orders) above. Branches are
    clamped so the unselected side stays finite."""
    if not isinstance(x, torch.Tensor) and isinstance(v, torch.Tensor):
        x = _f32(x, v.device)
    x = _f32(x)
    v = _f32(v, x.device)
    bshape = torch.broadcast_shapes(v.shape, x.shape)
    m = torch.arange(num_terms, dtype=torch.float32, device=x.device).reshape(
        (num_terms,) + (1,) * len(bshape)
    )
    log_half_x = torch.log(torch.clamp_min(x, 1e-30) / 2.0)
    terms = (2.0 * m + v) * log_half_x - torch.lgamma(m + 1.0) - torch.lgamma(m + v + 1.0)
    series = torch.logsumexp(terms, dim=0)
    x_lg = torch.clamp_min(x, 1.0)
    large = torch.where(
        v <= 10.0, _log_iv_hankel(v, x_lg), _log_iv_uniform(torch.clamp_min(v, 1.0), x_lg)
    )
    out = torch.where(x < 400.0, series, large)
    at_zero = torch.where(v == 0.0, 0.0, -torch.inf)
    return torch.where(x == 0.0, at_zero, out)


def log_bessel_i0(x):
    """``log I_0(x)`` for all ``x`` through the exponentially scaled
    ``i0e``."""
    x = _f32(x)
    return torch.log(torch.special.i0e(x)) + torch.abs(x)


def lambertw(z, iters: int = 32):
    """The principal branch ``W_0(z)`` for ``z >= -1/e`` by a fixed number
    of Halley steps."""
    z = _f32(z)
    log_z = torch.log(torch.clamp_min(z, 1e-30))
    w = torch.where(
        z > math.e,
        log_z - torch.log(torch.clamp_min(log_z, 1e-30)),
        torch.where(z > 0, z / (1.0 + z), z * (1.0 - z)),
    )
    for _ in range(iters):
        ew = torch.exp(w)
        f = w * ew - z
        wp1 = w + 1.0
        denom = ew * wp1 - (w + 2.0) * f / (2.0 * wp1)
        w = w - f / torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
    return w


def erfcinv(u):
    return torch.erfinv(1.0 - _f32(u))


# ------------------------------------------------------------------
# fixed-round rejection samplers (masked accept; static shapes)
# ------------------------------------------------------------------

_REJECTION_ROUNDS = 64


def _masked_rejection(gen: torch.Generator, propose, rounds: int = _REJECTION_ROUNDS):
    """Fixed-round rejection: ``propose(gen) -> (sample, accept)``; each lane
    keeps its first accepted proposal (the first proposal where none is
    accepted). No host read, so it runs under ``torch.func.vmap``."""
    out, done = propose(gen)
    for _ in range(rounds):
        cand, acc = propose(gen)
        out = torch.where(acc & ~done, cand, out)
        done = done | acc
    return out


def _uniform(gen, shape, low=0.0, high=1.0):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return low + (high - low) * u if (low, high) != (0.0, 1.0) else u


def standard_gamma(gen, alpha, shape) -> torch.Tensor:
    """Gamma(alpha, 1) draws of ``shape`` (``alpha`` broadcast to it)."""
    a = _f32(alpha, gen.device)
    return torch._standard_gamma(a.expand(shape).contiguous(), generator=gen)


def beta_sample(gen, a, b, shape) -> torch.Tensor:
    """Beta(a, b) draws of ``shape`` as ``X / (X + Y)`` of two gamma draws."""
    x = standard_gamma(gen, a, shape)
    y = standard_gamma(gen, b, shape)
    return x / (x + y)


def von_mises_sample(gen, loc, concentration, shape=()):
    """Best-Fisher (1979) wrapped-Cauchy rejection sampler for the von
    Mises distribution."""
    loc = _f32(loc, gen.device)
    kappa = torch.clamp_min(_f32(concentration, gen.device), 1e-6)
    shape = tuple(torch.broadcast_shapes(tuple(shape), loc.shape, kappa.shape))
    tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa**2)
    rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa)
    r = (1.0 + rho**2) / (2.0 * rho)

    def propose(g):
        u1, u2, u3 = _uniform(g, shape), _uniform(g, shape), _uniform(g, shape)
        z = torch.cos(math.pi * u1)
        f = (1.0 + r * z) / (r + z)
        c = kappa * (r - f)
        accept = (c * (2.0 - c) - u2 > 0.0) | (
            torch.log(c / torch.clamp_min(u2, 1e-30)) + 1.0 - c >= 0.0
        )
        theta = torch.where(u3 < 0.5, -1.0, 1.0) * torch.arccos(torch.clamp(f, -1.0, 1.0))
        return theta, accept

    theta = _masked_rejection(gen, propose)
    return torch.remainder(theta + loc + math.pi, 2.0 * math.pi) - math.pi


def zipf_sample(gen, power, shape=()):
    """Devroye's rejection-inversion sampler for the Zipf distribution
    (int32, as the reference's)."""
    a = _f32(power, gen.device)
    shape = tuple(torch.broadcast_shapes(tuple(shape), a.shape))
    am1 = a - 1.0
    b = torch.pow(2.0, am1)

    def propose(g):
        u = _uniform(g, shape, 1e-10, 1.0)
        v = _uniform(g, shape)
        x = torch.floor(torch.pow(u, -1.0 / am1))
        t = torch.pow(1.0 + 1.0 / x, am1)
        return x, v * x * (t - 1.0) / (b - 1.0) <= t / b

    return _masked_rejection(gen, propose).to(torch.int32)


def _uniform_on_sphere(gen, shape, dim):
    x = torch.randn(tuple(shape) + (dim,), generator=gen, device=gen.device)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _householder_rotate(y, mu):
    """Reflect ``y`` so that the north pole ``e1`` maps to ``mu``."""
    e1 = torch.zeros_like(mu)
    e1[..., 0] = 1.0
    u = e1 - mu
    norm = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    u = u / torch.where(norm < 1e-8, 1.0, norm)
    reflected = y - 2.0 * torch.sum(y * u, dim=-1, keepdim=True) * u
    return torch.where(norm < 1e-8, y, reflected)


def _on_sphere(t, v):
    return torch.cat([t[..., None], torch.sqrt(torch.clamp_min(1.0 - t[..., None] ** 2, 0.0)) * v], dim=-1)


def power_spherical_sample(gen, mean_direction, concentration):
    """Exact, rejection-free sampler of the power spherical distribution
    (De Cao & Aziz, 2020)."""
    mu = _f32(mean_direction, gen.device)
    kappa = _f32(concentration, gen.device)
    d = mu.shape[-1]
    batch = tuple(torch.broadcast_shapes(mu.shape[:-1], kappa.shape))
    z = beta_sample(gen, (d - 1.0) / 2.0 + kappa, (d - 1.0) / 2.0, batch)
    y = _on_sphere(2.0 * z - 1.0, _uniform_on_sphere(gen, batch, d - 1))
    return _householder_rotate(y, torch.broadcast_to(mu, batch + (d,)).clone())


def power_spherical_logpdf(x, mean_direction, concentration):
    x = _f32(x)
    mu = _f32(mean_direction, x.device)
    kappa = _f32(concentration, x.device)
    d = mu.shape[-1]
    alpha = (d - 1.0) / 2.0 + kappa
    beta = (d - 1.0) / 2.0
    log_norm = (
        (alpha + beta) * math.log(2.0)
        + beta * math.log(math.pi)
        + torch.lgamma(alpha)
        - torch.lgamma(alpha + beta)
    )
    dot = torch.sum(mu * x, dim=-1)
    return kappa * torch.log1p(torch.clamp(dot, -1.0 + 1e-7, 1.0)) - log_norm


def von_mises_fisher_sample(gen, mean_direction, concentration):
    """Wood's (1994) rejection sampler, fixed rounds with masked
    acceptance."""
    mu = _f32(mean_direction, gen.device)
    kappa = torch.clamp_min(_f32(concentration, gen.device), 1e-6)
    d = mu.shape[-1]
    batch = tuple(torch.broadcast_shapes(mu.shape[:-1], kappa.shape))
    dm1 = d - 1.0
    b = (-2.0 * kappa + torch.sqrt(4.0 * kappa**2 + dm1**2)) / dm1
    x0 = (1.0 - b) / (1.0 + b)
    c = kappa * x0 + dm1 * torch.log(1.0 - x0**2)

    def propose(g):
        z = beta_sample(g, dm1 / 2.0, dm1 / 2.0, batch)
        w = (1.0 - (1.0 + b) * z) / (1.0 - (1.0 - b) * z)
        u = _uniform(g, batch, 1e-10, 1.0)
        accept = kappa * w + dm1 * torch.log(torch.clamp_min(1.0 - x0 * w, 1e-30)) - c >= torch.log(u)
        return w, accept

    w = _masked_rejection(gen, propose)
    y = _on_sphere(w, _uniform_on_sphere(gen, batch, d - 1))
    return _householder_rotate(y, torch.broadcast_to(mu, batch + (d,)).clone())


def von_mises_fisher_logpdf(x, mean_direction, concentration):
    x = _f32(x)
    mu = _f32(mean_direction, x.device)
    kappa = _f32(concentration, x.device)
    d = mu.shape[-1]
    nu = d / 2.0 - 1.0
    log_c = (
        nu * torch.log(torch.clamp_min(kappa, 1e-30))
        - (d / 2.0) * math.log(2.0 * math.pi)
        - log_bessel_iv(nu, kappa)
    )
    # kappa -> 0: the uniform density on the sphere
    log_c0 = nu * math.log(2.0) + math.lgamma(nu + 1.0) - (d / 2.0) * math.log(2.0 * math.pi)
    log_c = torch.where(kappa < 1e-6, log_c0, log_c)
    return kappa * torch.sum(mu * x, dim=-1) + log_c


def gauss_legendre(n: int = 128, device=None):
    """Gauss-Legendre nodes and weights on ``[0, 1]`` (numpy, made once a
    call)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (
        torch.as_tensor((x + 1.0) / 2.0, dtype=torch.float32, device=device),
        torch.as_tensor(w / 2.0, dtype=torch.float32, device=device),
    )
