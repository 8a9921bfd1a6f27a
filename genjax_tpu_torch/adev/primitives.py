"""The ADEV gradient-estimator zoo.

Counterpart of ``genjax_tpu/adev/primitives.py``: ``REINFORCE`` and the
ready-made ``flip_reinforce``, ``geometric_reinforce`` and
``normal_reinforce``; the enumerations ``flip_enum``,
``flip_enum_parallel`` and ``categorical_enum_parallel``; the
measure-valued derivative ``flip_mvd``; the tail calls ``normal_reparam``,
``mv_normal_diag_reparam``, ``mv_normal_reparam``, ``uniform`` and
``beta_implicit``; ``Baseline`` and ``AddCost``. Samplers draw from a
key (``core/keys.py``), split as the reference splits it at each strategy,
so that they draw the reference's draws, or from a ``torch.Generator``, in
sequence; dual values are tensors whose derivative is their tangent
(``core``), so every estimator below is the reference's ``jax.jvp``
expression with ``detach()`` as its stop-gradient.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch

from ..core import keys
from ..core.pytree import Pytree
from ..dists.special import beta_sample
from .core import ADEVPrimitive, TailCallADEVPrimitive


def _primal(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


def _score(lp: torch.Tensor) -> torch.Tensor:
    """``lp`` less its primal: zero, with ``lp``'s derivative."""
    return lp - lp.detach()


def _sub(stream):
    """The reference's ``_, sub_key = split(key)``: the second key of a
    split, or the generator."""
    return keys.split_stream(stream)[1]


def _randn(stream, *params) -> torch.Tensor:
    shape = torch.broadcast_shapes(*(p.shape for p in params))
    if keys.is_key(stream):
        return keys.normal(stream, shape)
    return torch.randn(shape, generator=stream, device=stream.device)


def _rand(stream, shape=()) -> torch.Tensor:
    if keys.is_key(stream):
        return keys.uniform(stream, shape)
    return torch.rand(shape, generator=stream, device=stream.device)


def _bernoulli(stream, p) -> torch.Tensor:
    return _rand(stream, p.shape) < p


# ----------------------------------------------------------------------
# score-function (REINFORCE)
# ----------------------------------------------------------------------


@Pytree.dataclass
class REINFORCE(ADEVPrimitive):
    """Score-function estimator: correlates the continuation's value with
    the score ``d log q(v; theta)``."""

    sample_function: Callable = Pytree.static()
    differentiable_logpdf: Callable = Pytree.static()

    def sample(self, stream, *args):
        return self.sample_function(stream, *args)

    def inline_estimate(self, stream, dual_tree):
        cont, sub = keys.split_stream(stream)
        v = self.sample(sub, *(_primal(a) for a in dual_tree))
        score = _score(self.differentiable_logpdf(v, *dual_tree))
        return v, lambda r: r + r.detach() * score, cont


def reinforce(sample_func, logpdf_func) -> REINFORCE:
    return REINFORCE(sample_func, logpdf_func)


# ----------------------------------------------------------------------
# exact enumeration
# ----------------------------------------------------------------------


def _flag(stream, value: bool) -> torch.Tensor:
    return torch.full((), value, dtype=torch.bool, device=stream.device)


@Pytree.dataclass
class FlipEnum(ADEVPrimitive):
    """Exact two-branch enumeration of a Bernoulli: runs the continuation
    for both outcomes and mixes them by probability."""

    def sample(self, stream, *args):
        (p,) = args
        return _bernoulli(stream, p)

    def jvp_estimate(self, stream, dual_tree, konts):
        # both branches continue from the same key, as the reference's do
        _, kdual = konts
        (p,) = dual_tree
        true_out = kdual(stream, _flag(stream, True))
        false_out = kdual(stream, _flag(stream, False))
        return p * true_out + (1.0 - p) * false_out


flip_enum = FlipEnum()


def _branches(kdual, stream, values: torch.Tensor) -> torch.Tensor:
    """The continuation's value at each of ``values``: under a key one
    ``torch.func.vmap`` over ``split(key, n)`` and the values, as the
    reference vmaps its continuation (so that an rbg key's draws in it
    follow JAX's batching rule); under a generator one run a value."""
    if keys.is_key(stream):
        return torch.func.vmap(kdual)(keys.split(stream, values.shape[0]), values)
    return torch.stack([kdual(stream, v) for v in values.unbind(0)])


@Pytree.dataclass
class FlipEnumParallel(ADEVPrimitive):
    """Both Bernoulli branches, their values stacked and mixed in one
    reduction (the reference vmaps the two continuation calls; here they
    are two runs of the program)."""

    def sample(self, stream, *args):
        (p,) = args
        return _bernoulli(stream, p)

    def jvp_estimate(self, stream, dual_tree, konts):
        _, kdual = konts
        (p,) = dual_tree
        flags = torch.tensor([True, False], device=stream.device)
        rets = _branches(kdual, stream, flags)
        return torch.sum(torch.stack([p, 1.0 - p]) * rets)


flip_enum_parallel = FlipEnumParallel()


@Pytree.dataclass
class CategoricalEnumParallel(ADEVPrimitive):
    """Exact enumeration over a categorical's support. Args:
    ``(logits,)``."""

    def sample(self, stream, *args):
        (logits,) = args
        if keys.is_key(stream):
            return keys.categorical(stream, logits)
        u = torch.rand(logits.shape, generator=stream, device=stream.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return torch.argmax(logits + gumbel, dim=-1)

    def jvp_estimate(self, stream, dual_tree, konts):
        _, kdual = konts
        (logits,) = dual_tree
        n = logits.shape[-1]
        rets = _branches(kdual, stream, torch.arange(n, device=stream.device))
        return torch.sum(torch.softmax(logits, dim=-1) * rets)


categorical_enum_parallel = CategoricalEnumParallel()


# ----------------------------------------------------------------------
# measure-valued derivatives
# ----------------------------------------------------------------------


@Pytree.dataclass
class FlipMVD(ADEVPrimitive):
    """Measure-valued derivative for a Bernoulli: the continuation at the
    sampled branch against the flipped branch's pure value."""

    def sample(self, stream, *args):
        (p,) = args
        return _bernoulli(stream, p)

    def jvp_estimate(self, stream, dual_tree, konts):
        kpure, kdual = konts
        (p,) = dual_tree
        cont, sub = keys.split_stream(stream)
        b = _bernoulli(sub, p.detach())
        out = kdual(cont, b)
        other = kpure(cont, torch.logical_not(b))
        est = torch.where(b, 1.0, -1.0) * (out.detach() - other)
        return out + est * _score(p)


flip_mvd = FlipMVD()


# ----------------------------------------------------------------------
# reparameterization (tail-call strategies)
# ----------------------------------------------------------------------


@Pytree.dataclass
class NormalREPARAM(TailCallADEVPrimitive):
    """Location-scale reparameterization of the normal."""

    def sample(self, stream, *args):
        loc, scale = args
        return loc + scale * _randn(stream, loc, scale)

    def before_tail_call(self, stream, dual_tree):
        mu, sigma = dual_tree
        return mu + sigma * _randn(_sub(stream), mu, sigma)


normal_reparam = NormalREPARAM()


@Pytree.dataclass
class MvNormalDiagREPARAM(TailCallADEVPrimitive):
    """Diagonal-covariance multivariate normal reparameterization."""

    def sample(self, stream, *args):
        loc, scale_diag = args
        return loc + scale_diag * _randn(stream, loc)

    def before_tail_call(self, stream, dual_tree):
        loc, diag = dual_tree
        return loc + diag * _randn(_sub(stream), loc)


mv_normal_diag_reparam = MvNormalDiagREPARAM()


@Pytree.dataclass
class MvNormalREPARAM(TailCallADEVPrimitive):
    """Full-covariance multivariate normal through its Cholesky factor."""

    def sample(self, stream, *args):
        mu, cov = args
        return mu + torch.linalg.cholesky(cov) @ _randn(stream, mu)

    def before_tail_call(self, stream, dual_tree):
        mu, cov = dual_tree
        return mu + torch.linalg.cholesky(cov) @ _randn(_sub(stream), mu)


mv_normal_reparam = MvNormalREPARAM()


@Pytree.dataclass
class Uniform(TailCallADEVPrimitive):
    """A parameterless uniform(0, 1) draw."""

    def sample(self, stream, *_args):
        return _rand(stream)

    def before_tail_call(self, stream, dual_tree):
        return _rand(_sub(stream))


uniform = Uniform()


@functools.cache
def _gamma_grad_op():
    """``torch._standard_gamma_grad`` as a custom op with a vmap rule: torch
    has no batching rule for it, and its fallback runs one call a lane."""

    @torch.library.custom_op("genjax_tpu_torch::standard_gamma_grad", mutates_args=())
    def op(alpha: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch._standard_gamma_grad(alpha, x)

    @op.register_fake
    def _(alpha, x):
        return torch.empty_like(x)

    def batched(info, in_dims, alpha, x):
        # elementwise: every operand with its lane axis first, broadcast
        alpha = alpha.movedim(in_dims[0], 0) if in_dims[0] is not None else alpha.unsqueeze(0)
        x = x.movedim(in_dims[1], 0) if in_dims[1] is not None else x.unsqueeze(0)
        alpha, x = torch.broadcast_tensors(alpha, x)
        return op(alpha.contiguous(), x.contiguous()), 0

    op.register_vmap(batched)
    return op


def _implicit_gamma(gen, alpha):
    """A Gamma(alpha, 1) draw whose derivative in ``alpha`` is the implicit
    one, ``torch._standard_gamma_grad(alpha, x)`` (torch gives
    ``_standard_gamma`` no forward-mode formula)."""
    a = alpha.detach().contiguous()
    x = torch._standard_gamma(a, generator=gen)
    return x + _gamma_grad_op()(a, x) * _score(alpha)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its subnormal values made 0, as ``keys.beta`` (and XLA on
    the CPU) makes them."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, torch.zeros_like(x), x)


def _implicit_loggamma(k, alpha):
    """``keys.loggamma(k, alpha)`` with the derivative the reference's
    ``jax.random.loggamma`` carries: the implicit ``dx/dalpha`` of the gamma
    draw ``x = exp(log x)`` over ``x`` (``x`` at least float32's smallest
    normal, as the reference takes it)."""
    a = alpha.detach().contiguous()
    log_x = keys.loggamma(k, a)
    x = torch.exp(log_x).clamp_min(torch.finfo(torch.float32).tiny)
    return log_x + (_gamma_grad_op()(a, x) / x) * _score(alpha)


@Pytree.dataclass
class BetaIMPLICIT(TailCallADEVPrimitive):
    """Beta with implicit reparameterization (Figurnov et al. 2018): the
    draw is ``X / (X + Y)`` of two gamma draws, each with its implicit
    derivative. Under a key the draw is ``keys.beta``'s (the reference's
    ``jax.random.beta`` under the site's key, unsplit): the log-gammas of
    ``split(k)``, each with its implicit derivative, less their maximum,
    exponentiated and normalised."""

    def sample(self, stream, *args):
        alpha, beta_ = args
        if keys.is_key(stream):
            return keys.beta(stream, alpha, beta_)
        return beta_sample(stream, alpha, beta_, torch.broadcast_shapes(alpha.shape, beta_.shape))

    def before_tail_call(self, stream, dual_tree):
        alpha, beta_ = dual_tree
        shape = torch.broadcast_shapes(alpha.shape, beta_.shape)
        if keys.is_key(stream):
            key_a, key_b = keys.split_stream(stream)
            log_a = _implicit_loggamma(key_a, alpha.expand(shape))
            log_b = _implicit_loggamma(key_b, beta_.expand(shape))
            log_max = torch.maximum(log_a, log_b).detach()
            ga, gb = (_flush(torch.exp(lg - log_max)) for lg in (log_a, log_b))
            return ga / (ga + gb)
        x = _implicit_gamma(stream, alpha.expand(shape))
        y = _implicit_gamma(stream, beta_.expand(shape))
        return x / (x + y)


beta_implicit = BetaIMPLICIT()


# ----------------------------------------------------------------------
# ready-made REINFORCE samplers
# ----------------------------------------------------------------------


def _bernoulli_logpdf(v, p):
    vf = v.to(p.dtype)
    return vf * torch.log(p) + (1.0 - vf) * torch.log1p(-p)


flip_reinforce = reinforce(_bernoulli, _bernoulli_logpdf)


def _geometric_sample(stream, p):
    """Failures before the first success (TFP's ``Geometric``); under a key
    the reference's ``jax.random.geometric(key, p) - 1``."""
    if keys.is_key(stream):
        return (keys.geometric(stream, p) - 1).to(torch.int32)
    u = torch.rand(p.shape, generator=stream, device=stream.device)
    return torch.floor(torch.log1p(-u) / torch.log1p(-p)).to(torch.int32)


def _geometric_logpdf(v, p):
    return v.to(p.dtype) * torch.log1p(-p) + torch.log(p)


geometric_reinforce = reinforce(_geometric_sample, _geometric_logpdf)


def _normal_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return -0.5 * z * z - torch.log(scale) - 0.5 * math.log(2.0 * math.pi)


def _normal_reinforce_sample(stream, loc, scale):
    """``loc + scale * eps``; under a key ``eps`` is the reference's one
    normal, ``jax.random.normal(key)``."""
    if keys.is_key(stream):
        return loc + scale * keys.normal(stream)
    return loc + scale * _randn(stream, loc, scale)


normal_reinforce = reinforce(_normal_reinforce_sample, _normal_logpdf)


# ----------------------------------------------------------------------
# variance reduction & loss accumulation
# ----------------------------------------------------------------------


@Pytree.dataclass
class Baseline(ADEVPrimitive):
    """Control variate: subtract a baseline ``b`` from the continuation
    value inside the inner strategy, add it back outside. Args: ``(b,
    *prim_args)``."""

    prim: ADEVPrimitive

    def sample(self, stream, *args):
        return self.prim.sample(stream, *args[1:])

    def pure_sample(self, stream, *args):
        return self.prim.pure_sample(stream, *args[1:])

    def pure_cost(self, *args):
        return self.prim.pure_cost(*args[1:])

    def inline_estimate(self, stream, dual_tree):
        b, *rest = dual_tree
        inline = self.prim.inline_estimate(stream, tuple(rest))
        if inline is None:
            return None
        value, post, cont = inline
        if post is None:  # a tail call: the shift cancels
            return value, None, cont
        return value, lambda r: post(r - b) + b, cont

    def jvp_estimate(self, stream, dual_tree, konts):
        kpure, kdual = konts
        b, *rest = dual_tree
        # the PURE continuation sees the same shift: enumeration and MVD
        # evaluate alternative branches through it, and an unshifted branch
        # leaves a -(2p - 1) b bias in the difference estimator
        inner = self.prim.jvp_estimate(
            stream, tuple(rest), (lambda k, v: kpure(k, v) - b.detach(), lambda k, v: kdual(k, v) - b)
        )
        return inner + b


def baseline(prim: ADEVPrimitive) -> Baseline:
    return Baseline(prim)


@Pytree.dataclass
class AddCost(ADEVPrimitive):
    """Add a (differentiable) cost term to the enclosing expectation."""

    def sample(self, stream, *args):
        (w,) = args
        return w

    def pure_cost(self, *args):
        (w,) = args
        return w

    def inline_estimate(self, stream, dual_tree):
        (w,) = dual_tree
        return w, lambda r: w + r, stream


def add_cost(w):
    """Statement form: ``add_cost(w)`` inside an ``@expectation`` program."""
    AddCost()(w)
