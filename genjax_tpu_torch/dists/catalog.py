"""The distributions of the flagship model and the README quickstart.

Counterpart of part of ``genjax_tpu/dists/catalog.py``: ``normal``,
``log_normal``, ``mv_normal_diag``, ``mv_normal``, ``beta``, ``flip`` and
``categorical`` (over the last axis of its logits),
with the same names, TFP parameter orders and log-density formulas (the
normal density is ``-(log(2 pi s^2) + (x - m)^2 / s^2) / 2``, as
``jax.scipy.stats.norm`` computes it). Log-densities are elementwise over
batch dimensions; ``mv_normal_diag`` and ``mv_normal`` reduce over the event
axis. Every sampler takes ``sample_shape=`` with TFP's meaning: the count of
independent draws, which PREPENDS the parameters' batch shape; the
log-densities accept and ignore it. Arguments that are not tensors are made float32 tensors on the device
of the tensor arguments (a CUDA device wins over the CPU); samples are drawn
on the generator's device.
"""

from __future__ import annotations

import functools
import math

import torch

from .distribution import exact_density

_LOG_2PI = math.log(2.0 * math.pi)


@functools.lru_cache(maxsize=256)
def _number(x: float, negative: bool, device) -> torch.Tensor:
    # the sign is part of the key: -0.0 equals 0.0 and hashes the same; the
    # tensor is never written into, so one serves every call
    return torch.full((), x, dtype=torch.float32, device=device)


def _tensors(*xs, device=None) -> list[torch.Tensor]:
    """Coerce ``xs`` to float tensors on one device: ``device`` if given,
    else the first CUDA tensor's, else the CPU."""
    if device is None:
        devices = [x.device for x in xs if isinstance(x, torch.Tensor)]
        device = next((d for d in devices if d.type != "cpu"), devices[0] if devices else None)
    out = []
    for x in xs:
        if isinstance(x, (bool, int, float)):
            # filled on the device, as a trace records a number: a copy from
            # the host would make the card's stream wait for it
            out.append(_number(float(x), math.copysign(1.0, x) < 0, device))
        elif not isinstance(x, torch.Tensor):
            out.append(torch.as_tensor(x, dtype=torch.float32, device=device))
        else:
            t = x.to(device)
            out.append(t if t.is_floating_point() else t.to(torch.float32))
    return out


def _shape(kwargs) -> tuple:
    """The ``sample_shape`` keyword as a tuple of ints (an int is one axis)."""
    s = kwargs.pop("sample_shape", ())
    if kwargs:
        raise TypeError(f"unexpected keyword arguments {sorted(kwargs)}")
    return tuple(int(n) for n in (s if isinstance(s, (tuple, list, torch.Size)) else (s,)))


def _bshape(sample_shape, *params) -> tuple:
    """``sample_shape`` before the broadcast batch shape of ``params``
    (tensors, or explicit shape tuples): it counts independent draws and is
    not another broadcast operand."""
    batch: tuple = ()
    for p in params:
        shape = p if isinstance(p, tuple) else tuple(p.shape)
        if shape and shape != batch:  # a scalar broadcasts to anything
            batch = tuple(torch.broadcast_shapes(batch, shape)) if batch else shape
    return tuple(sample_shape) + batch


def _normal_logpdf(v, loc=0.0, scale=1.0, **kw):
    v, loc, scale = _tensors(v, loc, scale)
    s2 = scale * scale
    return (torch.log((2.0 * math.pi) * s2) + (v - loc) ** 2 / s2) / -2.0


def _normal_sample(gen, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=gen.device)
    z = torch.randn(_bshape(_shape(kw), loc, scale), generator=gen, device=gen.device)
    return loc + scale * z


def _log_normal_logpdf(v, loc=0.0, scale=1.0, **kw):
    (v,) = _tensors(v)
    log_v = torch.log(v)
    return torch.where(
        v > 0.0, _normal_logpdf(log_v, loc, scale) - log_v, -torch.inf
    )


def _mv_normal_diag_logpdf(v, loc, scale_diag, **kw):
    return torch.sum(_normal_logpdf(v, loc, scale_diag), dim=-1)


def cholesky_or_nan(cov: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of each matrix of ``cov``, all NaN where a
    matrix is not positive definite, as ``jnp.linalg.cholesky`` gives it:
    one bad batch element raises nothing and spoils no other, and nothing
    waits on the card for the factorisation's error code."""
    chol, info = torch.linalg.cholesky_ex(cov)
    return torch.where((info != 0)[..., None, None], torch.nan, chol)


def _mv_normal_logpdf(v, loc, covariance_matrix, **kw):
    """``jax.scipy.stats.multivariate_normal.logpdf``: one Cholesky factor
    gives the quadratic form (a triangular solve) and the log-determinant
    (its diagonal); NaN for a covariance that is not positive definite."""
    v, loc, cov = _tensors(v, loc, covariance_matrix)
    chol = cholesky_or_nan(cov)
    z = torch.linalg.solve_triangular(chol, (v - loc).unsqueeze(-1), upper=False).squeeze(-1)
    n = cov.shape[-1]
    log_det = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * torch.sum(z * z, dim=-1) - 0.5 * n * _LOG_2PI - log_det


def _mv_normal_sample(gen, loc, covariance_matrix, **kw):
    """``loc + L z`` with ``L`` the lower Cholesky factor and ``z ~ N(0, I)``
    (NaN for a covariance that is not positive definite)."""
    loc, cov = _tensors(loc, covariance_matrix, device=gen.device)
    chol = cholesky_or_nan(cov)
    shape = _bshape(_shape(kw), loc, tuple(cov.shape[:-1]))
    z = torch.randn(shape, generator=gen, device=gen.device)
    return loc + (chol @ z.unsqueeze(-1)).squeeze(-1)


def _betaln(a, b):
    """log B(a, b), summed in the reference's order for max(a, b) < 8 and
    in float64 above, where the float32 sum cancels."""
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small_b = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    a64, b64 = a.double(), b.double()
    large_b = (torch.lgamma(a64) + torch.lgamma(b64) - torch.lgamma(a64 + b64)).to(a.dtype)
    return torch.where(b < 8.0, small_b, large_b)


def _beta_logpdf(v, concentration1, concentration0, **kw):
    x, a, b = _tensors(v, concentration1, concentration0)
    log_probs = -_betaln(a, b) + (
        torch.xlogy(a - 1.0, x) + torch.special.xlog1py(b - 1.0, -x)
    )
    out = torch.where((x > 1.0) | (x < 0.0), -torch.inf, log_probs)
    return torch.where((a <= 0.0) | (b <= 0.0), torch.nan, out)


def _beta_sample(gen, concentration1, concentration0, **kw):
    a, b = _tensors(concentration1, concentration0, device=gen.device)
    shape = _bshape(_shape(kw), a, b)
    x = torch._standard_gamma(a.expand(shape).contiguous(), generator=gen)
    y = torch._standard_gamma(b.expand(shape).contiguous(), generator=gen)
    return x / (x + y)


def _flip_logpdf(v, p, **kw):
    v, p = _tensors(v, p)
    return torch.xlogy(v, p) + torch.special.xlog1py(1.0 - v, -p)


def _flip_sample(gen, p, **kw):
    (p,) = _tensors(p, device=gen.device)
    return torch.rand(_bshape(_shape(kw), p), generator=gen, device=gen.device) < p


def _categorical_logpmf(v, logits, **kw):
    """``log softmax(logits)[v]``, with TFP's batch semantics (a batched
    value against one logits vector scores elementwise); ``-inf`` outside
    ``0..K-1``."""
    (logits,) = _tensors(logits)
    vi = torch.as_tensor(v, device=logits.device).to(torch.int64)
    batch = torch.broadcast_shapes(tuple(vi.shape), tuple(logits.shape[:-1]))
    logits_b = torch.broadcast_to(logits, batch + tuple(logits.shape[-1:]))
    vi_b = torch.broadcast_to(vi, batch)
    k = logits.shape[-1]
    picked = torch.gather(logits_b, -1, vi_b.clamp(0, k - 1).unsqueeze(-1)).squeeze(-1)
    lp = picked - torch.logsumexp(logits_b, dim=-1)
    return torch.where((vi_b >= 0) & (vi_b < k), lp, -torch.inf)


def _categorical_sample(gen, logits, **kw):
    """An int64 draw from ``softmax(logits)`` by the Gumbel-max trick, as
    ``jax.random.categorical`` draws."""
    (logits,) = _tensors(logits, device=gen.device)
    shape = _bshape(_shape(kw), tuple(logits.shape[:-1])) + tuple(logits.shape[-1:])
    u = torch.rand(shape, generator=gen, device=gen.device)
    tiny = torch.finfo(u.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


normal = exact_density(_normal_sample, _normal_logpdf, "normal")

log_normal = exact_density(
    lambda gen, loc=0.0, scale=1.0, **kw: torch.exp(_normal_sample(gen, loc, scale, **kw)),
    _log_normal_logpdf,
    "log_normal",
)

mv_normal_diag = exact_density(_normal_sample, _mv_normal_diag_logpdf, "mv_normal_diag")

mv_normal = exact_density(_mv_normal_sample, _mv_normal_logpdf, "mv_normal")

beta = exact_density(_beta_sample, _beta_logpdf, "beta")

flip = exact_density(_flip_sample, _flip_logpdf, "flip")

categorical = exact_density(_categorical_sample, _categorical_logpmf, "categorical")

__all__ = ["beta", "categorical", "flip", "log_normal", "mv_normal", "mv_normal_diag", "normal"]
