"""The distribution catalog: the reference's 48 exact-density distributions.

Counterpart of ``genjax_tpu/dists/catalog.py``, with the same names, TFP
parameter orders and log-density formulas (``geometric`` counts failures,
``gamma`` takes a rate, ``bernoulli`` and ``binomial`` take logits, ``flip``
a probability). The normal density is ``-(log(2 pi s^2) + (x - m)^2 / s^2)
/ 2``, as ``jax.scipy.stats.norm`` computes it; the other families follow
the ``jax.scipy.stats`` formula the reference calls, term for term.
Log-densities are elementwise over batch dimensions; the event families
(``dirichlet``, ``multinomial``, ``dirichlet_multinomial``, ``mv_normal*``,
``power_spherical``, ``von_mises_fisher``) reduce over the last axis. Every
sampler takes ``sample_shape=`` with TFP's meaning: the count of independent
draws, which PREPENDS the parameters' batch shape; the log-densities accept
and ignore it. Arguments that are not tensors are made float32 tensors on the
device of the tensor arguments (a CUDA device wins over the CPU). Under a
key (``core/keys.py``) a distribution draws what the reference's sampler
draws from the same key, through the same ``jax.random`` formula, for the 33
whose reference sampler is a transform of ``jax.random.uniform``,
``normal`` or ``gamma`` (``_KEYED``; ``core/keys.py`` ports ``gamma`` and
``loggamma``, ``beta``, ``dirichlet``, ``chisquare`` and ``t``); the others
raise ``GFITypeError`` naming the ``jax.random`` function they would need
(``UNKEYED``). Under a generator,
samples are drawn from it on its device, by ``torch.rand``,
``torch.randn``, ``torch._standard_gamma``, ``torch.poisson``,
``torch.binomial`` and ``torch._sample_dirichlet``, so that every sampler
runs under ``torch.func.vmap(..., randomness="different")``. Discrete
samples keep the reference's dtypes (int32 counts from ``poisson``,
``geometric``, ``bernoulli``, ``negative_binomial``, ``skellam`` and ``zipf``;
float32 from ``binomial``, ``beta_binomial`` and the multinomials).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..core import keys
from ..generative.typecheck import GFITypeError
from . import special
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
    return special.beta_sample(gen, a, b, _bshape(_shape(kw), a, b))


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


__all__: list[str] = []


def _register(name, sampler, logpdf):
    def sample(gen, *args, **kw):
        if keys.is_key(gen):
            return _keyed_sampler(name)(gen, *args, **kw)
        return sampler(gen, *args, **kw)

    d = exact_density(sample, logpdf, name)
    globals()[name] = d
    __all__.append(name)
    return d


#: The draw under a key of each distribution whose reference sampler is
#: reproduced (the end of this module).
_KEYED: dict = {}

#: The ``jax.random`` function behind each reference sampler that a key
#: does not reproduce yet: under a key these raise.
UNKEYED = {
    "moyal": "jax.random.uniform with the special erfcinv",
    "double_sided_maxwell": "jax.random.double_sided_maxwell",
    "inverse_gaussian": "jax.random.wald",
    "von_mises": "the reference's special.von_mises_sample",
    "binomial": "jax.random.binomial",
    "poisson": "jax.random.poisson",
    "negative_binomial": "jax.random.gamma and jax.random.poisson",
    "beta_binomial": "jax.random.beta and jax.random.binomial",
    "skellam": "jax.random.poisson",
    "zipf": "the reference's special.zipf_sample",
    "non_central_chi2": "jax.random.poisson and jax.random.chisquare",
    "multinomial": "jax.random.multinomial",
    "dirichlet_multinomial": "jax.random.dirichlet and jax.random.multinomial",
    "power_spherical": "the reference's special.power_spherical_sample",
    "von_mises_fisher": "the reference's special.von_mises_fisher_sample",
}


def _keyed_sampler(name):
    try:
        return _KEYED[name]
    except KeyError:
        raise GFITypeError(
            f"{name}: drawing under a key is not reproduced for this distribution (its reference "
            f"sampler is {UNKEYED.get(name, 'not ported')}); pass a torch.Generator to draw it"
        ) from None


def _keyed(name):
    def register(fn):
        _KEYED[name] = fn
        return fn

    return register


def _u01(gen, shape, low: float = 0.0) -> torch.Tensor:
    """Uniforms in ``[low, 1)`` of ``shape`` from ``gen``."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u if low == 0.0 else low + (1.0 - low) * u


_EPS = torch.finfo(torch.float32).eps
_TINY = torch.finfo(torch.float32).tiny
_LOG2 = math.log(2.0)


_std_gamma = special.standard_gamma


def _chisquare(gen, df, shape) -> torch.Tensor:
    return 2.0 * _std_gamma(gen, df / 2.0, shape)


def _poisson(gen, rate, shape) -> torch.Tensor:
    return torch.poisson(rate.expand(shape).contiguous(), generator=gen).to(torch.int32)


def _binomial(gen, count, prob, shape) -> torch.Tensor:
    count = torch.as_tensor(count, dtype=torch.float32, device=gen.device).expand(shape)
    prob = prob.clamp(0.0, 1.0).expand(shape)
    # under torch.func.vmap both operands carry the lane axis, or the
    # batching rule writes a batched draw into an unbatched output
    count, prob = count + torch.zeros_like(prob), prob + torch.zeros_like(count)
    return torch.binomial(count.contiguous(), prob.contiguous(), generator=gen)


def _multinomial_counts(gen, n, p) -> torch.Tensor:
    """Counts of ``n`` trials over the last axis of ``p`` by a binomial a
    category on what is left, as ``jax.random.multinomial`` draws."""
    remaining = torch.flip(torch.cumsum(torch.flip(p, (-1,)), -1), (-1,))
    ratios = p / torch.where(remaining == 0.0, 1.0, remaining)
    left = n.expand(p.shape[:-1]).to(torch.float32)
    counts = []
    for k in range(p.shape[-1]):
        c = _binomial(gen, left, ratios[..., k], tuple(p.shape[:-1]))
        counts.append(c)
        left = left - c
    return torch.stack(counts, dim=-1)


def _std_cauchy(gen, shape):
    return torch.tan(math.pi * (_u01(gen, shape).clamp_min(_EPS) - 0.5))


def _std_t(gen, df, shape):
    n = torch.randn(shape, generator=gen, device=gen.device)
    half_df = df / 2.0
    return n * torch.sqrt(half_df / _std_gamma(gen, half_df, shape))


def _cauchy_logpdf(v, loc=0.0, scale=1.0, **kw):
    v, loc, scale = _tensors(v, loc, scale)
    z = (v - loc) / scale
    return -(torch.log(math.pi * scale) + torch.log1p(z * z))


def _t_logpdf(v, df, loc=0.0, scale=1.0, **kw):
    """``jax.scipy.stats.t.logpdf``."""
    v, df, loc, scale = _tensors(v, df, loc, scale)
    z = (v - loc) / scale
    df_over_two = df / 2.0
    df_plus_one_over_two = df_over_two + 0.5
    normalize = (
        torch.lgamma(df_over_two)
        + torch.log(scale * scale * math.pi * df) / 2.0
        - torch.lgamma(df_plus_one_over_two)
    )
    return -(normalize + df_plus_one_over_two * torch.log1p(z * z / df))


def _chi2_logpdf(v, df, **kw):
    """``jax.scipy.stats.chi2.logpdf``."""
    v, df = _tensors(v, df)
    df_on_two = df / 2.0
    kernel = (df_on_two - 1.0) * torch.log(v) - v / 2.0
    nrml = -(torch.lgamma(df_on_two) + _LOG2 * df / 2.0)
    return torch.where(v < 0.0, -torch.inf, nrml + kernel)


def _gamma_logpdf_scale(v, a, scale):
    """``jax.scipy.stats.gamma.logpdf(v, a, scale=scale)``."""
    ok = v >= 0.0
    y = torch.where(ok, v / scale, 1.0)
    lp = torch.xlogy(a - 1.0, y) - y - (torch.lgamma(a) + torch.log(scale))
    return torch.where(ok, lp, -torch.inf)


# ----------------------------------------------------------------------
# continuous scalar families
# ----------------------------------------------------------------------

_register("normal", _normal_sample, _normal_logpdf)


def _cauchy_sample(gen, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=gen.device)
    return loc + scale * _std_cauchy(gen, _bshape(_shape(kw), loc, scale))


_register("cauchy", _cauchy_sample, _cauchy_logpdf)


def _laplace_sample(gen, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=gen.device)
    u = -1.0 + _EPS + (2.0 - _EPS) * _u01(gen, _bshape(_shape(kw), loc, scale))
    return loc + scale * torch.sign(u) * -torch.log1p(-torch.abs(u))


def _laplace_logpdf(v, loc=0.0, scale=1.0, **kw):
    v, loc, scale = _tensors(v, loc, scale)
    return -(torch.abs(v - loc) / scale + torch.log(2.0 * scale))


_register("laplace", _laplace_sample, _laplace_logpdf)


def _logistic_sample(gen, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=gen.device)
    u = _u01(gen, _bshape(_shape(kw), loc, scale)).clamp_min(_TINY)
    return loc + scale * (torch.log(u) - torch.log1p(-u))


def _logistic_logpdf(v, loc=0.0, scale=1.0, **kw):
    v, loc, scale = _tensors(v, loc, scale)
    half_z = (v - loc) / scale / 2.0
    return -2.0 * torch.logaddexp(half_z, -half_z) - torch.log(scale)


_register("logistic", _logistic_sample, _logistic_logpdf)


def _gumbel_sample(gen, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=gen.device)
    u = _u01(gen, _bshape(_shape(kw), loc, scale)).clamp_min(_TINY)
    return loc + scale * -torch.log(-torch.log(u))


def _gumbel_logpdf(v, loc=0.0, scale=1.0, **kw):
    v, loc, scale = _tensors(v, loc, scale)
    z = (v - loc) / scale
    return -(z + torch.exp(-z)) - torch.log(scale)


_register("gumbel", _gumbel_sample, _gumbel_logpdf)


def _student_t_sample(gen, df, loc=0.0, scale=1.0, **kw):
    df, loc, scale = _tensors(df, loc, scale, device=gen.device)
    return loc + scale * _std_t(gen, df, _bshape(_shape(kw), df, loc, scale))


_register("student_t", _student_t_sample, _t_logpdf)


def _half_normal_sample(gen, scale=1.0, **kw):
    (scale,) = _tensors(scale, device=gen.device)
    return scale * torch.abs(torch.randn(_bshape(_shape(kw), scale), generator=gen, device=gen.device))


def _half_normal_logpdf(v, scale=1.0, **kw):
    (v,) = _tensors(v)
    return torch.where(v >= 0.0, _LOG2 + _normal_logpdf(v, 0.0, scale), -torch.inf)


_register("half_normal", _half_normal_sample, _half_normal_logpdf)


def _half_cauchy_sample(gen, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=gen.device)
    return loc + scale * torch.abs(_std_cauchy(gen, _bshape(_shape(kw), loc, scale)))


def _half_cauchy_logpdf(v, loc=0.0, scale=1.0, **kw):
    v, loc = _tensors(v, loc)
    return torch.where(v >= loc, _LOG2 + _cauchy_logpdf(v, loc, scale), -torch.inf)


_register("half_cauchy", _half_cauchy_sample, _half_cauchy_logpdf)


def _half_student_t_sample(gen, df, loc=0.0, scale=1.0, **kw):
    df, loc, scale = _tensors(df, loc, scale, device=gen.device)
    return loc + scale * torch.abs(_std_t(gen, df, _bshape(_shape(kw), df, loc, scale)))


def _half_student_t_logpdf(v, df, loc=0.0, scale=1.0, **kw):
    v, loc = _tensors(v, loc)
    return torch.where(v >= loc, _LOG2 + _t_logpdf(v, df, loc, scale), -torch.inf)


_register("half_student_t", _half_student_t_sample, _half_student_t_logpdf)


def _uniform_sample(gen, low=0.0, high=1.0, **kw):
    low, high = _tensors(low, high, device=gen.device)
    u = _u01(gen, _bshape(_shape(kw), low, high))
    return torch.maximum(low, u * (high - low) + low)


def _uniform_logpdf(v, low=0.0, high=1.0, **kw):
    """``jax.scipy.stats.uniform.logpdf(v, low, high - low)``."""
    v, low, high = _tensors(v, low, high)
    scale = high - low
    return torch.where((v > low + scale) | (v < low), -torch.inf, -torch.log(scale))


_register("uniform", _uniform_sample, _uniform_logpdf)

_register("beta", _beta_sample, _beta_logpdf)


def _exponential_sample(gen, rate, **kw):
    (rate,) = _tensors(rate, device=gen.device)
    return -torch.log1p(-_u01(gen, _bshape(_shape(kw), rate))) / rate


def _exponential_logpdf(v, rate, **kw):
    v, rate = _tensors(v, rate)
    return torch.where(v >= 0.0, torch.log(rate) - rate * v, -torch.inf)


_register("exponential", _exponential_sample, _exponential_logpdf)


def _gamma_sample(gen, concentration, rate=1.0, **kw):
    a, rate = _tensors(concentration, rate, device=gen.device)
    return _std_gamma(gen, a, _bshape(_shape(kw), a, rate)) / rate


def _gamma_logpdf(v, concentration, rate=1.0, **kw):
    v, a, rate = _tensors(v, concentration, rate)
    return _gamma_logpdf_scale(v, a, 1.0 / rate)


_register("gamma", _gamma_sample, _gamma_logpdf)


def _inverse_gamma_sample(gen, concentration, scale, **kw):
    a, scale = _tensors(concentration, scale, device=gen.device)
    return scale / _std_gamma(gen, a, _bshape(_shape(kw), a, scale))


def _inverse_gamma_logpdf(v, concentration, scale, **kw):
    v, a, scale = _tensors(v, concentration, scale)
    return torch.where(
        v > 0.0,
        torch.xlogy(a, scale) - torch.lgamma(a) - (a + 1.0) * torch.log(v) - scale / v,
        -torch.inf,
    )


_register("inverse_gamma", _inverse_gamma_sample, _inverse_gamma_logpdf)


def _chi_sample(gen, df, **kw):
    (df,) = _tensors(df, device=gen.device)
    return torch.sqrt(_chisquare(gen, df, _bshape(_shape(kw), df)))


def _chi_logpdf(v, df, **kw):
    v, df = _tensors(v, df)
    return torch.where(
        v > 0.0,
        (df - 1.0) * torch.log(v) - v**2 / 2.0 - (df / 2.0 - 1.0) * _LOG2 - torch.lgamma(df / 2.0),
        -torch.inf,
    )


_register("chi", _chi_sample, _chi_logpdf)


def _chi2_sample(gen, df, **kw):
    (df,) = _tensors(df, device=gen.device)
    return _chisquare(gen, df, _bshape(_shape(kw), df))


_register("chi2", _chi2_sample, _chi2_logpdf)


def _weibull_sample(gen, concentration, scale, **kw):
    k, lam = _tensors(concentration, scale, device=gen.device)
    u = _u01(gen, _bshape(_shape(kw), k, lam))
    return torch.pow(-torch.log1p(-u), 1.0 / k) * lam


def _weibull_logpdf(v, concentration, scale, **kw):
    v, k, lam = _tensors(v, concentration, scale)
    z = v / lam
    return torch.where(
        v >= 0.0, torch.log(k) - torch.log(lam) + torch.xlogy(k - 1.0, z) - z**k, -torch.inf
    )


_register("weibull", _weibull_sample, _weibull_logpdf)

_register(
    "log_normal",
    lambda gen, loc=0.0, scale=1.0, **kw: torch.exp(_normal_sample(gen, loc, scale, **kw)),
    _log_normal_logpdf,
)


def _logit_normal_logpdf(v, loc=0.0, scale=1.0, **kw):
    (v,) = _tensors(v)
    logit = torch.log(v) - torch.log1p(-v)
    return _normal_logpdf(logit, loc, scale) - torch.log(v) - torch.log1p(-v)


_register(
    "logit_normal",
    lambda gen, loc=0.0, scale=1.0, **kw: torch.sigmoid(_normal_sample(gen, loc, scale, **kw)),
    _logit_normal_logpdf,
)


def _truncated_normal_sample(gen, loc, scale, low, high, **kw):
    """Inverse-CDF draw through ``erf``, clipped inside the bounds, as
    ``jax.random.truncated_normal`` draws."""
    loc, scale, low, high = _tensors(loc, scale, low, high, device=gen.device)
    a = (low - loc) / scale
    b = (high - loc) / scale
    sqrt2 = math.sqrt(2.0)
    ea, eb = torch.erf(a / sqrt2), torch.erf(b / sqrt2)
    u = _u01(gen, _bshape(_shape(kw), loc, scale, low, high))
    z = sqrt2 * torch.erfinv(torch.maximum(ea, u * (eb - ea) + ea))
    z = torch.clamp(z, torch.nextafter(a, torch.full_like(a, torch.inf)), torch.nextafter(b, torch.full_like(b, -torch.inf)))
    return loc + scale * z


def _truncated_normal_logpdf(v, loc, scale, low, high, **kw):
    """The normal density over ``log(Phi(b) - Phi(a))``, the difference of
    ``log_ndtr`` taken on the side where the CDF is small."""
    v, loc, scale, low, high = _tensors(v, loc, scale, low, high)
    a = (low - loc) / scale
    b = (high - loc) / scale

    def log_diff(lo, hi):
        hi_l = torch.special.log_ndtr(hi)
        return hi_l + torch.log1p(-torch.exp(torch.special.log_ndtr(lo) - hi_l))

    lz = torch.where(a >= 0.0, log_diff(-b, -a), log_diff(a, b))
    lp = _normal_logpdf(v, loc, scale) - lz
    return torch.where((v >= low) & (v <= high), lp, -torch.inf)


_register("truncated_normal", _truncated_normal_sample, _truncated_normal_logpdf)


def _cauchy_cdf(v, loc, scale):
    return 0.5 + torch.arctan((v - loc) / scale) / math.pi


def _truncated_cauchy_sample(gen, loc, scale, low, high, **kw):
    loc, scale, low, high = _tensors(loc, scale, low, high, device=gen.device)
    fa, fb = _cauchy_cdf(low, loc, scale), _cauchy_cdf(high, loc, scale)
    u = _u01(gen, _bshape(_shape(kw), loc, scale, low, high))
    return loc + scale * torch.tan(math.pi * (fa + u * (fb - fa) - 0.5))


def _truncated_cauchy_logpdf(v, loc, scale, low, high, **kw):
    v, loc, scale, low, high = _tensors(v, loc, scale, low, high)
    fa, fb = _cauchy_cdf(low, loc, scale), _cauchy_cdf(high, loc, scale)
    lp = _cauchy_logpdf(v, loc, scale) - torch.log(fb - fa)
    return torch.where((v >= low) & (v <= high), lp, -torch.inf)


_register("truncated_cauchy", _truncated_cauchy_sample, _truncated_cauchy_logpdf)


def _kumaraswamy_sample(gen, concentration1, concentration0, **kw):
    a, b = _tensors(concentration1, concentration0, device=gen.device)
    u = _u01(gen, _bshape(_shape(kw), a, b), low=1e-7)
    return (1.0 - (1.0 - u) ** (1.0 / b)) ** (1.0 / a)


def _kumaraswamy_logpdf(v, concentration1, concentration0, **kw):
    v, a, b = _tensors(v, concentration1, concentration0)
    return torch.where(
        (v > 0.0) & (v < 1.0),
        torch.log(a) + torch.log(b) + torch.xlogy(a - 1.0, v) + torch.special.xlog1py(b - 1.0, -(v**a)),
        -torch.inf,
    )


_register("kumaraswamy", _kumaraswamy_sample, _kumaraswamy_logpdf)


def _moyal_sample(gen, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=gen.device)
    u = 1e-7 + (1.0 - 2e-7) * _u01(gen, _bshape(_shape(kw), loc, scale))
    return loc + scale * (-2.0 * torch.log(math.sqrt(2.0) * special.erfcinv(u)))


def _moyal_logpdf(v, loc=0.0, scale=1.0, **kw):
    v, loc, scale = _tensors(v, loc, scale)
    z = (v - loc) / scale
    return -0.5 * (z + torch.exp(-z)) - 0.5 * math.log(2.0 * math.pi) - torch.log(scale)


_register("moyal", _moyal_sample, _moyal_logpdf)


def _dsmaxwell_sample(gen, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=gen.device)
    shape = _bshape(_shape(kw), loc, scale)
    maxwell = torch.linalg.vector_norm(
        torch.randn(shape + (3,), generator=gen, device=gen.device), dim=-1
    )
    sign = torch.where(_u01(gen, shape) < 0.5, -1.0, 1.0)
    return sign * maxwell * scale + loc


def _dsmaxwell_logpdf(v, loc=0.0, scale=1.0, **kw):
    v, loc, scale = _tensors(v, loc, scale)
    z = (v - loc) / scale
    return (
        2.0 * torch.log(torch.abs(z) + 1e-30)
        - z**2 / 2.0
        - 0.5 * math.log(2.0 * math.pi)
        - torch.log(scale)
    )


_register("double_sided_maxwell", _dsmaxwell_sample, _dsmaxwell_logpdf)


def _log_gamma_sample(gen, a, shape):
    """``log Gamma(a, 1)`` without underflow for small ``a``:
    ``log G(a + 1) + log(U) / a``."""
    return torch.log(_std_gamma(gen, a + 1.0, shape)) + torch.log(_u01(gen, shape).clamp_min(_TINY)) / a


def _exp_gamma_sample(gen, concentration, rate=1.0, **kw):
    a, rate = _tensors(concentration, rate, device=gen.device)
    return _log_gamma_sample(gen, a, _bshape(_shape(kw), a, rate)) - torch.log(rate)


def _exp_gamma_logpdf(v, concentration, rate=1.0, **kw):
    v, a, rate = _tensors(v, concentration, rate)
    return torch.xlogy(a, rate) + a * v - rate * torch.exp(v) - torch.lgamma(a)


_register("exp_gamma", _exp_gamma_sample, _exp_gamma_logpdf)


def _exp_inverse_gamma_sample(gen, concentration, scale=1.0, **kw):
    a, scale = _tensors(concentration, scale, device=gen.device)
    return torch.log(scale) - _log_gamma_sample(gen, a, _bshape(_shape(kw), a, scale))


def _exp_inverse_gamma_logpdf(v, concentration, scale=1.0, **kw):
    v, a, scale = _tensors(v, concentration, scale)
    return torch.xlogy(a, scale) - a * v - scale * torch.exp(-v) - torch.lgamma(a)


_register("exp_inverse_gamma", _exp_inverse_gamma_sample, _exp_inverse_gamma_logpdf)


def _inverse_gaussian_sample(gen, loc, concentration, **kw):
    """``concentration`` times a unit-shape Wald draw of mean ``loc /
    concentration`` (Michael, Schucany and Haas), as
    ``jax.random.wald`` draws."""
    mu, lam = _tensors(loc, concentration, device=gen.device)
    shape = _bshape(_shape(kw), mu, lam)
    mean = mu / lam
    y = torch.randn(shape, generator=gen, device=gen.device) ** 2
    z = _u01(gen, shape)
    mean_sq = mean**2
    x = mean + mean_sq * y / 2.0 - mean * torch.sqrt(4.0 * mean * y + mean_sq * y**2) / 2.0
    return lam * torch.where(z <= mean / (mean + x), x, mean_sq / x)


def _inverse_gaussian_logpdf(v, loc, concentration, **kw):
    v, mu, lam = _tensors(v, loc, concentration)
    return torch.where(
        v > 0.0,
        0.5 * (torch.log(lam) - math.log(2.0 * math.pi) - 3.0 * torch.log(v))
        - lam * (v - mu) ** 2 / (2.0 * mu**2 * v),
        -torch.inf,
    )


_register("inverse_gaussian", _inverse_gaussian_sample, _inverse_gaussian_logpdf)


def _von_mises_sample(gen, loc, concentration, **kw):
    loc, kappa = _tensors(loc, concentration, device=gen.device)
    return special.von_mises_sample(gen, loc, kappa, _bshape(_shape(kw), loc, kappa))


def _von_mises_logpdf(v, loc, concentration, **kw):
    v, loc, kappa = _tensors(v, loc, concentration)
    return kappa * torch.cos(v - loc) - math.log(2.0 * math.pi) - special.log_bessel_i0(kappa)


_register("von_mises", _von_mises_sample, _von_mises_logpdf)


def _lambert_w_normal_sample(gen, loc=0.0, scale=1.0, tailweight=0.0, **kw):
    loc, scale, delta = _tensors(loc, scale, tailweight, device=gen.device)
    u = torch.randn(_bshape(_shape(kw), loc, scale, delta), generator=gen, device=gen.device)
    return loc + scale * u * torch.exp(delta / 2.0 * u**2)


def _lambert_w_normal_logpdf(v, loc=0.0, scale=1.0, tailweight=0.0, **kw):
    """The inverse transform ``u = sign(z) sqrt(W(delta z^2) / delta)`` and
    its Jacobian ``|du/dz| = u / (z (1 + W))``, 1 at ``delta = 0`` and in the
    limit ``z -> 0``."""
    v, loc, scale, delta = _tensors(v, loc, scale, tailweight)
    z = (v - loc) / scale
    wz = special.lambertw(delta * z**2)
    u = torch.sign(z) * torch.sqrt(torch.clamp_min(wz / torch.where(delta == 0.0, 1.0, delta), 0.0))
    u = torch.where(delta == 0.0, z, u)
    dudz = torch.where(
        (delta == 0.0) | (torch.abs(z) < 1e-6),
        1.0,
        torch.abs(u) / torch.clamp_min(torch.abs(z) * (1.0 + wz), 1e-30),
    )
    return _normal_logpdf(u, 0.0, 1.0) + torch.log(torch.clamp_min(dudz, 1e-30)) - torch.log(scale)


_register("lambert_w_normal", _lambert_w_normal_sample, _lambert_w_normal_logpdf)


# ----------------------------------------------------------------------
# discrete families
# ----------------------------------------------------------------------


def _bernoulli_sample(gen, logits=None, **kw):
    (logits,) = _tensors(logits, device=gen.device)
    u = _u01(gen, _bshape(_shape(kw), logits))
    return (u < torch.sigmoid(logits)).to(torch.int32)


def _bernoulli_logpmf(v, logits=None, **kw):
    v, logits = _tensors(v, logits)
    return v * logits - F.softplus(logits)


_register("bernoulli", _bernoulli_sample, _bernoulli_logpmf)

_register("flip", _flip_sample, _flip_logpdf)

_register("categorical", _categorical_sample, _categorical_logpmf)


def _binomial_sample(gen, total_count, logits=None, **kw):
    n, logits = _tensors(total_count, logits, device=gen.device)
    return _binomial(gen, n, torch.sigmoid(logits), _bshape(_shape(kw), n, logits))


def _binomial_logpmf(v, total_count, logits=None, **kw):
    k, n, logits = _tensors(v, total_count, logits)
    comb = torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)
    lp = comb + k * logits - n * F.softplus(logits)
    return torch.where((k >= 0) & (k <= n), lp, -torch.inf)


_register("binomial", _binomial_sample, _binomial_logpmf)


def _geometric_sample(gen, logits, **kw):
    """Failures before the first success (TFP's support ``0, 1, ...``):
    ``floor(log1p(-U) / log1p(-p))``."""
    (logits,) = _tensors(logits, device=gen.device)
    u = _u01(gen, _bshape(_shape(kw), logits))
    p = torch.sigmoid(logits)
    return torch.floor(torch.log1p(-u) / torch.log1p(-p)).to(torch.int32)


def _geometric_logpmf(v, logits, **kw):
    k, logits = _tensors(v, logits)
    return torch.where(k >= 0, logits - (k + 1.0) * F.softplus(logits), -torch.inf)


_register("geometric", _geometric_sample, _geometric_logpmf)


def _poisson_sample(gen, rate, **kw):
    (rate,) = _tensors(rate, device=gen.device)
    return _poisson(gen, rate, _bshape(_shape(kw), rate))


def _poisson_logpmf(v, rate, **kw):
    """``jax.scipy.stats.poisson.logpmf``: ``-inf`` off the non-negative
    integers."""
    k, mu = _tensors(v, rate)
    lp = torch.xlogy(k, mu) - torch.lgamma(k + 1.0) - mu
    return torch.where((k < 0.0) | (torch.round(k) != k), -torch.inf, lp)


_register("poisson", _poisson_sample, _poisson_logpmf)


def _negative_binomial_sample(gen, total_count, logits, **kw):
    n, logits = _tensors(total_count, logits, device=gen.device)
    shape = _bshape(_shape(kw), n, logits)
    p = torch.sigmoid(logits)
    return _poisson(gen, _std_gamma(gen, n, shape) * (p / (1.0 - p)), shape)


def _negative_binomial_logpmf(v, total_count, logits, **kw):
    k, n, logits = _tensors(v, total_count, logits)
    sp = F.softplus(logits)
    lp = torch.lgamma(k + n) - torch.lgamma(n) - torch.lgamma(k + 1.0) + k * (logits - sp) - n * sp
    return torch.where(k >= 0, lp, -torch.inf)


_register("negative_binomial", _negative_binomial_sample, _negative_binomial_logpmf)


def _beta_binomial_sample(gen, total_count, concentration1, concentration0, **kw):
    n, a, b = _tensors(total_count, concentration1, concentration0, device=gen.device)
    shape = _bshape(_shape(kw), n, a, b)
    return _binomial(gen, n, special.beta_sample(gen, a, b, shape), shape)


def _beta_binomial_logpmf(v, total_count, concentration1, concentration0, **kw):
    k, n, a, b = _tensors(v, total_count, concentration1, concentration0)
    lp = (
        torch.lgamma(n + 1.0)
        - torch.lgamma(k + 1.0)
        - torch.lgamma(n - k + 1.0)
        + _betaln(k + a, n - k + b)
        - _betaln(a, b)
    )
    return torch.where((k >= 0) & (k <= n), lp, -torch.inf)


_register("beta_binomial", _beta_binomial_sample, _beta_binomial_logpmf)


def _skellam_sample(gen, rate1, rate2, **kw):
    mu1, mu2 = _tensors(rate1, rate2, device=gen.device)
    shape = _bshape(_shape(kw), mu1, mu2)
    return _poisson(gen, mu1, shape) - _poisson(gen, mu2, shape)


def _skellam_logpmf(v, rate1, rate2, **kw):
    k, mu1, mu2 = _tensors(v, rate1, rate2)
    return (
        -(mu1 + mu2)
        + 0.5 * k * (torch.log(mu1) - torch.log(mu2))
        + special.log_bessel_iv(torch.abs(k), 2.0 * torch.sqrt(mu1 * mu2))
    )


_register("skellam", _skellam_sample, _skellam_logpmf)


def _zipf_sample(gen, power, **kw):
    (a,) = _tensors(power, device=gen.device)
    return special.zipf_sample(gen, a, _bshape(_shape(kw), a))


def _zipf_logpmf(v, power, **kw):
    k, a = _tensors(v, power)
    return torch.where(
        k >= 1.0, -a * torch.log(k) - torch.log(torch.special.zeta(a, torch.ones_like(a))), -torch.inf
    )


_register("zipf", _zipf_sample, _zipf_logpmf)


def _non_central_chi2_sample(gen, df, noncentrality, **kw):
    df, nc = _tensors(df, noncentrality, device=gen.device)
    shape = _bshape(_shape(kw), df, nc)
    j = _poisson(gen, nc / 2.0, shape)
    return _chisquare(gen, df + 2.0 * j, shape)


def _non_central_chi2_logpdf(v, df, noncentrality, **kw):
    x, df, nc = _tensors(v, df, noncentrality)
    hd = df / 2.0 - 1.0
    lp = (
        -_LOG2
        - (x + nc) / 2.0
        + hd / 2.0 * (torch.log(x) - torch.log(torch.clamp_min(nc, 1e-30)))
        + special.log_bessel_iv(hd, torch.sqrt(torch.clamp_min(nc * x, 0.0)))
    )
    lp = torch.where(nc < 1e-10, _chi2_logpdf(x, df), lp)
    return torch.where(x > 0.0, lp, -torch.inf)


_register("non_central_chi2", _non_central_chi2_sample, _non_central_chi2_logpdf)


# ----------------------------------------------------------------------
# event-dimension families
# ----------------------------------------------------------------------


def _dirichlet_sample(gen, concentration, **kw):
    (alpha,) = _tensors(concentration, device=gen.device)
    shape = _bshape(_shape(kw), tuple(alpha.shape[:-1])) + tuple(alpha.shape[-1:])
    return torch._sample_dirichlet(alpha.expand(shape).contiguous(), generator=gen)


def _dirichlet_logpdf(v, concentration, **kw):
    """``jax.scipy.stats.dirichlet.logpdf`` over the last axis: ``-inf``
    off the simplex (a coordinate not positive, or a sum off 1 by 1e-6)."""
    x, alpha = _tensors(v, concentration)
    normalize = torch.sum(torch.lgamma(alpha), -1) - torch.lgamma(torch.sum(alpha, -1))
    lp = torch.sum(torch.xlogy(alpha - 1.0, x), -1) - normalize
    simplex = torch.all(x > 0, dim=-1) & (torch.abs(torch.sum(x, -1) - 1.0) < 1e-6)
    return torch.where(simplex, lp, -torch.inf)


_register("dirichlet", _dirichlet_sample, _dirichlet_logpdf)


def _multinomial_sample(gen, total_count, logits, **kw):
    n, logits = _tensors(total_count, logits, device=gen.device)
    batch = _bshape(_shape(kw), tuple(logits.shape[:-1]), tuple(n.shape))
    p = torch.softmax(logits, dim=-1).expand(batch + tuple(logits.shape[-1:]))
    return _multinomial_counts(gen, n, p)


def _multinomial_logpmf(v, total_count, logits, **kw):
    x, n, logits = _tensors(v, total_count, logits)
    logp = torch.log_softmax(logits, dim=-1)
    return torch.lgamma(n + 1.0) - torch.sum(torch.lgamma(x + 1.0), -1) + torch.sum(x * logp, -1)


_register("multinomial", _multinomial_sample, _multinomial_logpmf)


def _dirichlet_multinomial_sample(gen, total_count, concentration, **kw):
    n, alpha = _tensors(total_count, concentration, device=gen.device)
    batch = _bshape(_shape(kw), tuple(alpha.shape[:-1]))
    p = torch._sample_dirichlet(alpha.expand(batch + tuple(alpha.shape[-1:])).contiguous(), generator=gen)
    return _multinomial_counts(gen, n, p)


def _dirichlet_multinomial_logpmf(v, total_count, concentration, **kw):
    x, n, a = _tensors(v, total_count, concentration)
    a0 = torch.sum(a, -1)
    return (
        torch.lgamma(n + 1.0)
        - torch.sum(torch.lgamma(x + 1.0), -1)
        + torch.lgamma(a0)
        - torch.lgamma(n + a0)
        + torch.sum(torch.lgamma(x + a) - torch.lgamma(a), -1)
    )


_register("dirichlet_multinomial", _dirichlet_multinomial_sample, _dirichlet_multinomial_logpmf)

_register("mv_normal_diag", _normal_sample, _mv_normal_diag_logpdf)

_register("mv_normal", _mv_normal_sample, _mv_normal_logpdf)


def _directional(sampler):
    """A directional sampler over its parameters' batch, with
    ``sample_shape`` draws prepended by broadcasting the parameters to
    them (the reference vmaps a single-draw sampler over split keys)."""

    def sample(gen, mean_direction, concentration, **kw):
        mu, kappa = _tensors(mean_direction, concentration, device=gen.device)
        batch = _bshape(_shape(kw), tuple(mu.shape[:-1]), kappa)
        return sampler(gen, mu.expand(batch + tuple(mu.shape[-1:])), kappa.expand(batch))

    return sample


_register(
    "power_spherical",
    _directional(special.power_spherical_sample),
    lambda v, mean_direction, concentration, **kw: special.power_spherical_logpdf(
        *_tensors(v, mean_direction, concentration)
    ),
)

_register(
    "von_mises_fisher",
    _directional(special.von_mises_fisher_sample),
    lambda v, mean_direction, concentration, **kw: special.von_mises_fisher_logpdf(
        *_tensors(v, mean_direction, concentration)
    ),
)


# ----------------------------------------------------------------------
# quotient family (quadrature-based density)
# ----------------------------------------------------------------------


def _beta_quotient_sample(gen, c1_num, c0_num, c1_den, c0_den, **kw):
    a1, b1, a2, b2 = _tensors(c1_num, c0_num, c1_den, c0_den, device=gen.device)
    shape = _bshape(_shape(kw), a1, b1, a2, b2)
    return special.beta_sample(gen, a1, b1, shape) / special.beta_sample(gen, a2, b2, shape)


def _beta_quotient_logpdf(v, c1_num, c0_num, c1_den, c0_den, **kw):
    """The density of ``X / Y`` for independent betas by 128-node
    Gauss-Legendre quadrature over the denominator: ``f(z) = int f_X(z y)
    f_Y(y) y dy`` for ``y`` in ``(0, min(1, 1 / z))``."""
    z, a1, b1, a2, b2 = _tensors(v, c1_num, c0_num, c1_den, c0_den)
    nodes, weights = special.gauss_legendre(128, device=z.device)
    upper = torch.clamp_max(1.0 / torch.clamp_min(z, 1e-30), 1.0)
    expand = (...,) + (None,) * z.dim()
    y = nodes[expand] * upper
    vals = torch.exp(
        _beta_logpdf(torch.clamp(z * y, 1e-30, 1.0 - 1e-7), a1, b1)
        + _beta_logpdf(torch.clamp(y, 1e-30, 1.0 - 1e-7), a2, b2)
        + torch.log(y)
    )
    integral = torch.sum(weights[expand] * vals, dim=0) * upper
    return torch.where(z > 0.0, torch.log(torch.clamp_min(integral, 1e-38)), -torch.inf)


_register("beta_quotient", _beta_quotient_sample, _beta_quotient_logpdf)


# ----------------------------------------------------------------------
# draws under a key: the reference's samplers on ``jax.random``, reproduced
# through ``core/keys.py`` so that a key draws what the reference draws
# ----------------------------------------------------------------------

_F32_EPSNEG = 2.0**-24


@_keyed("normal")
@_keyed("mv_normal_diag")
def _key_normal(key, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=key.device)
    return loc + scale * keys.normal(key, _bshape(_shape(kw), loc, scale))


@_keyed("log_normal")
def _key_log_normal(key, loc=0.0, scale=1.0, **kw):
    return torch.exp(_key_normal(key, loc, scale, **kw))


@_keyed("logit_normal")
def _key_logit_normal(key, loc=0.0, scale=1.0, **kw):
    return torch.sigmoid(_key_normal(key, loc, scale, **kw))


@_keyed("half_normal")
def _key_half_normal(key, scale=1.0, **kw):
    (scale,) = _tensors(scale, device=key.device)
    return scale * torch.abs(keys.normal(key, _bshape(_shape(kw), scale)))


@_keyed("lambert_w_normal")
def _key_lambert_w_normal(key, loc=0.0, scale=1.0, tailweight=0.0, **kw):
    loc, scale, delta = _tensors(loc, scale, tailweight, device=key.device)
    u = keys.normal(key, _bshape(_shape(kw), loc, scale, delta))
    return loc + scale * u * torch.exp(delta / 2.0 * u**2)


def _key_std_cauchy(key, shape):
    u = keys.uniform(key, shape, minval=_EPS, maxval=1.0)
    return torch.tan(math.pi * (u - 0.5))


@_keyed("cauchy")
def _key_cauchy(key, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=key.device)
    return loc + scale * _key_std_cauchy(key, _bshape(_shape(kw), loc, scale))


@_keyed("half_cauchy")
def _key_half_cauchy(key, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=key.device)
    return loc + scale * torch.abs(_key_std_cauchy(key, _bshape(_shape(kw), loc, scale)))


@_keyed("laplace")
def _key_laplace(key, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=key.device)
    u = keys.uniform(key, _bshape(_shape(kw), loc, scale), minval=-1.0 + _F32_EPSNEG, maxval=1.0)
    return loc + scale * (torch.sign(u) * torch.log1p(-torch.abs(u)))


@_keyed("logistic")
def _key_logistic(key, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=key.device)
    x = keys.uniform(key, _bshape(_shape(kw), loc, scale), minval=_TINY, maxval=1.0)
    return loc + scale * (torch.log(x) - torch.log1p(-x))


@_keyed("gumbel")
def _key_gumbel(key, loc=0.0, scale=1.0, **kw):
    loc, scale = _tensors(loc, scale, device=key.device)
    return loc + scale * keys.gumbel(key, _bshape(_shape(kw), loc, scale))


@_keyed("uniform")
def _key_uniform(key, low=0.0, high=1.0, **kw):
    low, high = _tensors(low, high, device=key.device)
    return keys.uniform(key, _bshape(_shape(kw), low, high), minval=low, maxval=high)


@_keyed("exponential")
def _key_exponential(key, rate, **kw):
    (rate,) = _tensors(rate, device=key.device)
    return -torch.log1p(-keys.uniform(key, _bshape(_shape(kw), rate))) / rate


@_keyed("weibull")
def _key_weibull(key, concentration, scale, **kw):
    k, lam = _tensors(concentration, scale, device=key.device)
    u = keys.uniform(key, _bshape(_shape(kw), k, lam))
    return torch.pow(-torch.log1p(-u), 1.0 / k) * lam


@_keyed("kumaraswamy")
def _key_kumaraswamy(key, concentration1, concentration0, **kw):
    a, b = _tensors(concentration1, concentration0, device=key.device)
    u = keys.uniform(key, _bshape(_shape(kw), a, b), minval=1e-7, maxval=1.0)
    return (1.0 - (1.0 - u) ** (1.0 / b)) ** (1.0 / a)


@_keyed("truncated_normal")
def _key_truncated_normal(key, loc, scale, low, high, **kw):
    loc, scale, low, high = _tensors(loc, scale, low, high, device=key.device)
    a = (low - loc) / scale
    b = (high - loc) / scale
    sqrt2 = math.sqrt(2.0)
    u = keys.uniform(key, _bshape(_shape(kw), loc, scale, low, high), minval=torch.erf(a / sqrt2), maxval=torch.erf(b / sqrt2))
    z = sqrt2 * keys.erfinv(u)
    z = torch.clamp(z, torch.nextafter(a, torch.full_like(a, torch.inf)), torch.nextafter(b, torch.full_like(b, -torch.inf)))
    return loc + scale * z


@_keyed("truncated_cauchy")
def _key_truncated_cauchy(key, loc, scale, low, high, **kw):
    loc, scale, low, high = _tensors(loc, scale, low, high, device=key.device)
    fa, fb = _cauchy_cdf(low, loc, scale), _cauchy_cdf(high, loc, scale)
    u = keys.uniform(key, _bshape(_shape(kw), loc, scale, low, high))
    return loc + scale * torch.tan(math.pi * (fa + u * (fb - fa) - 0.5))


@_keyed("bernoulli")
def _key_bernoulli(key, logits=None, **kw):
    (logits,) = _tensors(logits, device=key.device)
    return (keys.uniform(key, _bshape(_shape(kw), logits)) < torch.sigmoid(logits)).to(torch.int32)


@_keyed("flip")
def _key_flip(key, p, **kw):
    (p,) = _tensors(p, device=key.device)
    return keys.uniform(key, _bshape(_shape(kw), p)) < p


@_keyed("categorical")
def _key_categorical(key, logits, **kw):
    """``jax.random.categorical``: the Gumbel-max trick over the last axis."""
    (logits,) = _tensors(logits, device=key.device)
    return keys.categorical(key, logits, shape=_bshape(_shape(kw), tuple(logits.shape[:-1])))


@_keyed("geometric")
def _key_geometric(key, logits, **kw):
    """``jax.random.geometric`` less one: failures before the first
    success."""
    (logits,) = _tensors(logits, device=key.device)
    u = keys.uniform(key, _bshape(_shape(kw), logits))
    return torch.floor(torch.log(u) / torch.log1p(-torch.sigmoid(logits))).to(torch.int32)


@_keyed("mv_normal")
def _key_mv_normal(key, loc, covariance_matrix, **kw):
    """``jax.random.multivariate_normal`` by its Cholesky factor: ``loc + L
    z`` with ``z`` of shape ``sample_shape + (d,)``, or the parameters'
    batch shape where no ``sample_shape`` is given."""
    loc, cov = _tensors(loc, covariance_matrix, device=key.device)
    shape = _shape(kw) or tuple(torch.broadcast_shapes(tuple(loc.shape[:-1]), tuple(cov.shape[:-2])))
    z = keys.normal(key, tuple(shape) + tuple(loc.shape[-1:]))
    return loc + (cholesky_or_nan(cov) @ z.unsqueeze(-1)).squeeze(-1)


@_keyed("gamma")
def _key_gamma(key, concentration, rate=1.0, **kw):
    conc, rate = _tensors(concentration, rate, device=key.device)
    return keys.gamma(key, conc, _bshape(_shape(kw), conc, rate)) / rate


@_keyed("inverse_gamma")
def _key_inverse_gamma(key, concentration, scale, **kw):
    conc, scale = _tensors(concentration, scale, device=key.device)
    return scale / keys.gamma(key, conc, _bshape(_shape(kw), conc, scale))


@_keyed("exp_gamma")
def _key_exp_gamma(key, concentration, rate=1.0, **kw):
    conc, rate = _tensors(concentration, rate, device=key.device)
    return keys.loggamma(key, conc, _bshape(_shape(kw), conc, rate)) - torch.log(rate)


@_keyed("exp_inverse_gamma")
def _key_exp_inverse_gamma(key, concentration, scale=1.0, **kw):
    conc, scale = _tensors(concentration, scale, device=key.device)
    return torch.log(scale) - keys.loggamma(key, conc, _bshape(_shape(kw), conc, scale))


@_keyed("beta")
def _key_beta(key, concentration1, concentration0, **kw):
    a, b = _tensors(concentration1, concentration0, device=key.device)
    return keys.beta(key, a, b, _bshape(_shape(kw), a, b))


@_keyed("beta_quotient")
def _key_beta_quotient(key, concentration1_numerator, concentration0_numerator,
                       concentration1_denominator, concentration0_denominator, **kw):
    a1, b1, a2, b2 = _tensors(concentration1_numerator, concentration0_numerator, concentration1_denominator,
                              concentration0_denominator, device=key.device)
    shape = _bshape(_shape(kw), a1, b1, a2, b2)
    k1, k2 = keys.split(key).unbind(-2)
    return keys.beta(k1, a1, b1, shape) / keys.beta(k2, a2, b2, shape)


@_keyed("dirichlet")
def _key_dirichlet(key, concentration, **kw):
    (conc,) = _tensors(concentration, device=key.device)
    return keys.dirichlet(key, conc, _bshape(_shape(kw), tuple(conc.shape[:-1])) or None)


@_keyed("chi")
def _key_chi(key, df, **kw):
    (df,) = _tensors(df, device=key.device)
    return torch.sqrt(keys.chisquare(key, df, _bshape(_shape(kw), df)))


@_keyed("chi2")
def _key_chi2(key, df, **kw):
    (df,) = _tensors(df, device=key.device)
    return keys.chisquare(key, df, _bshape(_shape(kw), df))


@_keyed("student_t")
def _key_student_t(key, df, loc=0.0, scale=1.0, **kw):
    df, loc, scale = _tensors(df, loc, scale, device=key.device)
    return loc + scale * keys.t(key, df, _bshape(_shape(kw), df, loc, scale))


@_keyed("half_student_t")
def _key_half_student_t(key, df, loc=0.0, scale=1.0, **kw):
    df, loc, scale = _tensors(df, loc, scale, device=key.device)
    return loc + scale * torch.abs(keys.t(key, df, _bshape(_shape(kw), df, loc, scale)))
