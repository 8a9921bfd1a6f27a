"""Automatic differentiation variational inference (Kucukelbir et al.,
JMLR 2017) over column log-densities.

Counterpart of ``genjax_tpu/inference/advi.py``: the guide is a Gaussian
over the packed column vector (mean-field diagonal, or full rank through a
Cholesky factor), fit by reparameterized Monte-Carlo ELBO gradients with
Adam (optax's update). A K-sample ELBO batch is one ``(D, K)`` matrix, the
full-rank draw ``z = mu + L @ eps`` one ``(D, D) @ (D, K)`` product, and the
target is any column log-density ``(D, K) -> (K,)``
(``kernels.model_interface.column_logdensity``).

Two gradient estimators:

- ``"stl"`` (sticking the landing; Roeder et al. 2017, the default): the
  entropy term is the Monte-Carlo ``-log q(z)`` with the variational
  parameters detached inside ``log q``, which gives zero-variance
  gradients once ``q`` reaches the target's family;
- ``"entropy"``: the analytic Gaussian entropy (classic ADVI).

``advi`` and ``column_advi`` make their own randomness: they take a key
(``core/keys.py``), a ``torch.Generator`` or an int seed, and ``device``,
the card unless the caller asks for the CPU. A key is split as the
reference splits it (a fitting key, split into a key a step, and the final
ELBO's key), so the fit draws the reference's draws; a generator is drawn
from in sequence.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.device import to_device
from ..core.pytree import Pytree
from ._adam import adam_init, adam_update
from ..kernels.rows import refuse_row_sharded

_LOG2PI = 1.8378770664093453


@Pytree.dataclass
class ADVIResult(Pytree):
    """A fitted Gaussian over a column vector: ``mu (D,)``, the lower
    Cholesky factor ``scale_tril (D, D)`` of its covariance (a mean-field
    fit stores its diagonal so), the Monte-Carlo ELBO at each step
    (``elbo_trace``) and the final ELBO from a fresh, larger sample
    (``elbo``)."""

    mu: Any
    scale_tril: Any
    elbo_trace: Any
    elbo: Any

    @property
    def cov(self):
        return self.scale_tril @ self.scale_tril.T

    @property
    def sd(self):
        return torch.sqrt(torch.sum(self.scale_tril**2, dim=1))

    def sample(self, gen, n: int):
        """``(D, n)`` columns from the fitted Gaussian, under a key or from a
        generator."""
        eps = keys.normal_from(gen, (self.mu.shape[0], n), gen.device)
        return self.mu[:, None] + self.scale_tril @ eps

    def logq(self, z):
        """The guide's log-density over columns, ``(D, N) -> (N,)``."""
        return _mvn_logpdf_cols(z, self.mu, self.scale_tril)


def _mvn_logpdf_cols(z, mu, scale_tril):
    y = torch.linalg.solve_triangular(scale_tril, z - mu[:, None], upper=False)
    logdet = torch.sum(torch.log(torch.diagonal(scale_tril)))
    return -0.5 * torch.sum(y**2, dim=0) - logdet - 0.5 * mu.shape[0] * _LOG2PI


def _diag_logpdf_cols(z, mu, log_sigma):
    y = (z - mu[:, None]) * torch.exp(-log_sigma)[:, None]
    return -0.5 * torch.sum(y**2, dim=0) - torch.sum(log_sigma) - 0.5 * mu.shape[0] * _LOG2PI


def advi(
    gen,
    logdensity_cols: Callable,
    dim: int,
    *,
    rank: str = "diag",
    n_steps: int = 1000,
    n_samples: int = 32,
    learning_rate=0.05,
    estimator: str = "stl",
    init_mu=None,
    init_log_sigma: float = -1.0,
    n_elbo_samples: int = 256,
    device="cuda",
) -> ADVIResult:
    """Fit a Gaussian ``q`` to ``exp(logdensity_cols)`` by maximizing the
    reparameterized Monte-Carlo ELBO with Adam.

    ``rank``: ``"diag"`` (mean-field) or ``"full"`` (Cholesky).
    ``learning_rate`` is a number or a schedule ``step -> rate``: where
    ``q`` cannot reach the target's family, STL gradients do not vanish at
    the optimum and a decaying schedule passes below the noise floor.
    """
    refuse_row_sharded(logdensity_cols, "advi")
    if rank not in ("diag", "full"):
        raise ValueError(f"rank must be 'diag' or 'full', got {rank!r}")
    if estimator not in ("stl", "entropy"):
        raise ValueError(f"estimator must be 'stl' or 'entropy', got {estimator!r}")
    gen, device = keys.entry_stream(gen, device, "advi")
    mu0 = (
        torch.zeros(dim, device=device)
        if init_mu is None
        else torch.as_tensor(init_mu, dtype=torch.float32, device=device)
    )
    if rank == "diag":
        params = {"mu": mu0, "log_sigma": torch.full((dim,), init_log_sigma, device=device)}
    else:
        # an unconstrained diagonal (exp-transformed) and a strict lower triangle
        params = {
            "mu": mu0,
            "log_diag": torch.full((dim,), init_log_sigma, device=device),
            "lower": torch.zeros((dim, dim), device=device),
        }

    def build_tril(p):
        return torch.tril(p["lower"], diagonal=-1) + torch.diag(torch.exp(p["log_diag"]))

    def reparam(p, eps):
        if rank == "diag":
            return p["mu"][:, None] + torch.exp(p["log_sigma"])[:, None] * eps
        return p["mu"][:, None] + build_tril(p) @ eps

    def logq(p, z):
        if rank == "diag":
            return _diag_logpdf_cols(z, p["mu"], p["log_sigma"])
        return _mvn_logpdf_cols(z, p["mu"], build_tril(p))

    def entropy(p):
        log_diag = p["log_sigma"] if rank == "diag" else p["log_diag"]
        return torch.sum(log_diag) + 0.5 * dim * (_LOG2PI + 1.0)

    def elbo_est(p, eps):
        z = reparam(p, eps)
        lp = torch.mean(logdensity_cols(z))
        if estimator == "entropy":
            return lp + entropy(p)
        return lp - torch.mean(logq(pytree.tree_map(torch.detach, p), z))

    neg_grad = torch.func.grad_and_value(lambda p, eps: -elbo_est(p, eps))
    state = adam_init(params)
    trace = []
    fit_gen, eval_gen = keys.split_stream(gen)
    for k in keys.split_stream(fit_gen, n_steps):
        eps = keys.normal_from(k, (dim, n_samples), device)
        g, loss = neg_grad(params, eps)
        params, state = adam_update(g, state, params, learning_rate)
        trace.append(-loss)
    final = elbo_est(params, keys.normal_from(eval_gen, (dim, n_elbo_samples), device))
    tril = torch.diag(torch.exp(params["log_sigma"])) if rank == "diag" else build_tril(params)
    return ADVIResult(
        mu=params["mu"],
        scale_tril=tril,
        elbo_trace=torch.stack(trace) if trace else torch.zeros(0, device=device),
        elbo=final,
    )


@Pytree.dataclass
class ADVIPosterior(Pytree):
    """An :class:`ADVIResult` bound to a model's ``ColumnPacker``: draws
    decode back to choice maps over the fitted addresses."""

    result: ADVIResult
    packer: Any = Pytree.static(compare=False)

    def sample_choices(self, gen, n: int):
        """``n`` posterior choice maps (leaves carry a leading ``n`` axis)."""
        cols = self.result.sample(gen, n)
        return torch.func.vmap(self.packer.unpack, in_dims=1)(cols)

    def mean_choices(self):
        return self.packer.unpack(self.result.mu)


def column_advi(
    gen,
    model,
    constraint,
    args: tuple,
    addresses: Sequence[Any],
    *,
    device="cuda",
    **advi_kwargs,
) -> ADVIPosterior:
    """ADVI over a model's continuous addresses in the column layout: pack
    the addresses, fit :func:`advi` against the model's log-joint, return
    decodable posterior draws. The packer's padding dimensions carry a
    standard-normal factor (``column_logdensity``), which ADVI fits exactly;
    the marginal over the real dimensions is unchanged."""
    from ..generative.choice_map import ChoiceMap
    from ..kernels.model_interface import ColumnPacker, column_logdensity

    gen, device = keys.entry_stream(gen, device, "column_advi")
    if constraint is None:
        constraint = ChoiceMap.empty()
    constraint, args = to_device((constraint, args), device)
    packer = ColumnPacker(model, constraint, args, addresses)
    logdensity_cols = column_logdensity(model, constraint, args, packer)
    result = advi(gen, logdensity_cols, packer.padded_dim, device=device, **advi_kwargs)
    return ADVIPosterior(result=result, packer=packer)
