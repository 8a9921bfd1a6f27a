"""The ADEV gradient-estimator zoo.

Counterpart of ``genjax_tpu/adev/primitives.py``: ``REINFORCE`` and the
ready-made ``flip_reinforce``, ``geometric_reinforce`` and
``normal_reinforce``; the enumerations ``flip_enum``,
``flip_enum_parallel`` and ``categorical_enum_parallel``; the
measure-valued derivative ``flip_mvd``; the tail calls ``normal_reparam``,
``mv_normal_diag_reparam``, ``mv_normal_reparam``, ``uniform`` and
``beta_implicit``; ``Baseline`` and ``AddCost``. Samplers draw from the
caller's ``torch.Generator``; dual values are tensors whose derivative is
their tangent (``core``), so every estimator below is the reference's
``jax.jvp`` expression with ``detach()`` as its stop-gradient.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch

from ..core.pytree import Pytree
from ..dists.special import beta_sample
from .core import ADEVPrimitive, TailCallADEVPrimitive


def _primal(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


def _score(lp: torch.Tensor) -> torch.Tensor:
    """``lp`` less its primal: zero, with ``lp``'s derivative."""
    return lp - lp.detach()


def _randn(gen, *params) -> torch.Tensor:
    shape = torch.broadcast_shapes(*(p.shape for p in params))
    return torch.randn(shape, generator=gen, device=gen.device)


def _bernoulli(gen, p) -> torch.Tensor:
    return torch.rand(p.shape, generator=gen, device=gen.device) < p


# ----------------------------------------------------------------------
# score-function (REINFORCE)
# ----------------------------------------------------------------------


@Pytree.dataclass
class REINFORCE(ADEVPrimitive):
    """Score-function estimator: correlates the continuation's value with
    the score ``d log q(v; theta)``."""

    sample_function: Callable = Pytree.static()
    differentiable_logpdf: Callable = Pytree.static()

    def sample(self, gen, *args):
        return self.sample_function(gen, *args)

    def inline_estimate(self, gen, dual_tree):
        v = self.sample(gen, *(_primal(a) for a in dual_tree))
        score = _score(self.differentiable_logpdf(v, *dual_tree))
        return v, lambda r: r + r.detach() * score


def reinforce(sample_func, logpdf_func) -> REINFORCE:
    return REINFORCE(sample_func, logpdf_func)


# ----------------------------------------------------------------------
# exact enumeration
# ----------------------------------------------------------------------


def _flag(gen, value: bool) -> torch.Tensor:
    return torch.full((), value, dtype=torch.bool, device=gen.device)


@Pytree.dataclass
class FlipEnum(ADEVPrimitive):
    """Exact two-branch enumeration of a Bernoulli: runs the continuation
    for both outcomes and mixes them by probability."""

    def sample(self, gen, *args):
        (p,) = args
        return _bernoulli(gen, p)

    def jvp_estimate(self, gen, dual_tree, konts):
        _, kdual = konts
        (p,) = dual_tree
        true_out = kdual(_flag(gen, True))
        false_out = kdual(_flag(gen, False))
        return p * true_out + (1.0 - p) * false_out


flip_enum = FlipEnum()


@Pytree.dataclass
class FlipEnumParallel(ADEVPrimitive):
    """Both Bernoulli branches, their values stacked and mixed in one
    reduction (the reference vmaps the two continuation calls; here they
    are two runs of the program)."""

    def sample(self, gen, *args):
        (p,) = args
        return _bernoulli(gen, p)

    def jvp_estimate(self, gen, dual_tree, konts):
        _, kdual = konts
        (p,) = dual_tree
        rets = torch.stack([kdual(_flag(gen, True)), kdual(_flag(gen, False))])
        return torch.sum(torch.stack([p, 1.0 - p]) * rets)


flip_enum_parallel = FlipEnumParallel()


@Pytree.dataclass
class CategoricalEnumParallel(ADEVPrimitive):
    """Exact enumeration over a categorical's support. Args:
    ``(logits,)``."""

    def sample(self, gen, *args):
        (logits,) = args
        u = torch.rand(logits.shape, generator=gen, device=gen.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return torch.argmax(logits + gumbel, dim=-1)

    def jvp_estimate(self, gen, dual_tree, konts):
        _, kdual = konts
        (logits,) = dual_tree
        n = logits.shape[-1]
        rets = torch.stack([kdual(torch.full((), i, dtype=torch.int64, device=gen.device)) for i in range(n)])
        return torch.sum(torch.softmax(logits, dim=-1) * rets)


categorical_enum_parallel = CategoricalEnumParallel()


# ----------------------------------------------------------------------
# measure-valued derivatives
# ----------------------------------------------------------------------


@Pytree.dataclass
class FlipMVD(ADEVPrimitive):
    """Measure-valued derivative for a Bernoulli: the continuation at the
    sampled branch against the flipped branch's pure value."""

    def sample(self, gen, *args):
        (p,) = args
        return _bernoulli(gen, p)

    def jvp_estimate(self, gen, dual_tree, konts):
        kpure, kdual = konts
        (p,) = dual_tree
        b = _bernoulli(gen, p.detach())
        out = kdual(b)
        other = kpure(torch.logical_not(b))
        est = torch.where(b, 1.0, -1.0) * (out.detach() - other)
        return out + est * _score(p)


flip_mvd = FlipMVD()


# ----------------------------------------------------------------------
# reparameterization (tail-call strategies)
# ----------------------------------------------------------------------


@Pytree.dataclass
class NormalREPARAM(TailCallADEVPrimitive):
    """Location-scale reparameterization of the normal."""

    def sample(self, gen, *args):
        loc, scale = args
        return loc + scale * _randn(gen, loc, scale)

    def before_tail_call(self, gen, dual_tree):
        mu, sigma = dual_tree
        return mu + sigma * _randn(gen, mu, sigma)


normal_reparam = NormalREPARAM()


@Pytree.dataclass
class MvNormalDiagREPARAM(TailCallADEVPrimitive):
    """Diagonal-covariance multivariate normal reparameterization."""

    def sample(self, gen, *args):
        loc, scale_diag = args
        return loc + scale_diag * _randn(gen, loc)

    def before_tail_call(self, gen, dual_tree):
        loc, diag = dual_tree
        return loc + diag * _randn(gen, loc)


mv_normal_diag_reparam = MvNormalDiagREPARAM()


@Pytree.dataclass
class MvNormalREPARAM(TailCallADEVPrimitive):
    """Full-covariance multivariate normal through its Cholesky factor."""

    def sample(self, gen, *args):
        mu, cov = args
        return mu + torch.linalg.cholesky(cov) @ _randn(gen, mu)

    def before_tail_call(self, gen, dual_tree):
        mu, cov = dual_tree
        return mu + torch.linalg.cholesky(cov) @ _randn(gen, mu)


mv_normal_reparam = MvNormalREPARAM()


@Pytree.dataclass
class Uniform(TailCallADEVPrimitive):
    """A parameterless uniform(0, 1) draw."""

    def sample(self, gen, *_args):
        return torch.rand((), generator=gen, device=gen.device)

    def before_tail_call(self, gen, dual_tree):
        return torch.rand((), generator=gen, device=gen.device)


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


@Pytree.dataclass
class BetaIMPLICIT(TailCallADEVPrimitive):
    """Beta with implicit reparameterization (Figurnov et al. 2018): the
    draw is ``X / (X + Y)`` of two gamma draws, each with its implicit
    derivative."""

    def sample(self, gen, *args):
        alpha, beta_ = args
        return beta_sample(gen, alpha, beta_, torch.broadcast_shapes(alpha.shape, beta_.shape))

    def before_tail_call(self, gen, dual_tree):
        alpha, beta_ = dual_tree
        shape = torch.broadcast_shapes(alpha.shape, beta_.shape)
        x = _implicit_gamma(gen, alpha.expand(shape))
        y = _implicit_gamma(gen, beta_.expand(shape))
        return x / (x + y)


beta_implicit = BetaIMPLICIT()


# ----------------------------------------------------------------------
# ready-made REINFORCE samplers
# ----------------------------------------------------------------------


def _bernoulli_logpdf(v, p):
    vf = v.to(p.dtype)
    return vf * torch.log(p) + (1.0 - vf) * torch.log1p(-p)


flip_reinforce = reinforce(_bernoulli, _bernoulli_logpdf)


def _geometric_sample(gen, p):
    """Failures before the first success (TFP's ``Geometric``)."""
    u = torch.rand(p.shape, generator=gen, device=gen.device)
    return torch.floor(torch.log1p(-u) / torch.log1p(-p)).to(torch.int32)


def _geometric_logpdf(v, p):
    return v.to(p.dtype) * torch.log1p(-p) + torch.log(p)


geometric_reinforce = reinforce(_geometric_sample, _geometric_logpdf)


def _normal_logpdf(v, loc, scale):
    z = (v - loc) / scale
    return -0.5 * z * z - torch.log(scale) - 0.5 * math.log(2.0 * math.pi)


normal_reinforce = reinforce(
    lambda gen, loc, scale: loc + scale * _randn(gen, loc, scale),
    _normal_logpdf,
)


# ----------------------------------------------------------------------
# variance reduction & loss accumulation
# ----------------------------------------------------------------------


@Pytree.dataclass
class Baseline(ADEVPrimitive):
    """Control variate: subtract a baseline ``b`` from the continuation
    value inside the inner strategy, add it back outside. Args: ``(b,
    *prim_args)``."""

    prim: ADEVPrimitive

    def sample(self, gen, *args):
        return self.prim.sample(gen, *args[1:])

    def pure_sample(self, gen, *args):
        return self.prim.pure_sample(gen, *args[1:])

    def pure_cost(self, *args):
        return self.prim.pure_cost(*args[1:])

    def inline_estimate(self, gen, dual_tree):
        b, *rest = dual_tree
        inline = self.prim.inline_estimate(gen, tuple(rest))
        if inline is None:
            return None
        value, post = inline
        if post is None:  # a tail call: the shift cancels
            return value, None
        return value, lambda r: post(r - b) + b

    def jvp_estimate(self, gen, dual_tree, konts):
        kpure, kdual = konts
        b, *rest = dual_tree
        # the PURE continuation sees the same shift: enumeration and MVD
        # evaluate alternative branches through it, and an unshifted branch
        # leaves a -(2p - 1) b bias in the difference estimator
        inner = self.prim.jvp_estimate(
            gen, tuple(rest), (lambda v: kpure(v) - b.detach(), lambda v: kdual(v) - b)
        )
        return inner + b


def baseline(prim: ADEVPrimitive) -> Baseline:
    return Baseline(prim)


@Pytree.dataclass
class AddCost(ADEVPrimitive):
    """Add a (differentiable) cost term to the enclosing expectation."""

    def sample(self, gen, *args):
        (w,) = args
        return w

    def pure_cost(self, *args):
        (w,) = args
        return w

    def inline_estimate(self, gen, dual_tree):
        (w,) = dual_tree
        return w, lambda r: w + r


def add_cost(w):
    """Statement form: ``add_cost(w)`` inside an ``@expectation`` program."""
    AddCost()(w)
