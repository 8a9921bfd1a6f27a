"""Dense-HMM tools: forward-backward smoothing, the parallel passes,
exact posterior draws, Viterbi and Baum-Welch EM.

Counterpart of ``genjax_tpu/dists/hmm_tools.py``. Convention: ``log_pi
(N,)`` initial, ``log_trans (N, N)`` rows ``log p(z_t = j | z_{t-1} =
i)``, ``log_obs (N, M)`` rows ``log p(y = m | z = i)``, observations an
int sequence ``(T,)``; everything in log space, where the inputs live. The
sequential passes are Python loops over ``T`` of ``(N, N)`` log-matrix
steps, where the reference runs ``lax.scan``. The parallel passes compose
the per-step matrices ``M_t(i, j) = trans(i, j) + obs_t(j)`` over the
(logsumexp, +) or (max, +) semiring with ``core/scan.py``'s log-depth scan,
where the reference calls ``lax.associative_scan``.

Memory of the parallel passes: the scan's first combine materializes
``(T/2, N, N, N)`` values, 2.1 GB of float32 at N = 64, T = 4,096 and 17 GB
at N = 128; the sequential passes hold ``(T, N)``.

>>> import torch
>>> lp = torch.log(torch.tensor([0.5, 0.5]))
>>> lt = torch.log(torch.tensor([[0.9, 0.1], [0.2, 0.8]]))
>>> lo = torch.log(torch.tensor([[0.8, 0.2], [0.25, 0.75]]))
>>> ys = torch.tensor([0, 0, 1, 1, 0])
>>> bool(torch.allclose(hmm_log_marginal(lp, lt, lo, ys), forward_parallel(lp, lt, lo, ys)[1]))
True
>>> viterbi(lp, lt, lo, ys)[0].tolist()
[0, 0, 0, 0, 0]
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.pytree import Pytree
from ..core.scan import associative_scan, reverse_scan
from .catalog import categorical


@Pytree.dataclass
class HMMPosterior(Pytree):
    """Forward-backward output: per-step smoothed state log-marginals
    ``log p(z_t | y)``, pairwise ``log p(z_t, z_{t+1} | y)``, and the data
    log-likelihood."""

    log_gammas: Any  # (T, N)
    log_xis: Any  # (T-1, N, N)
    log_marginal: Any


def _obs_rows(log_obs, ys) -> torch.Tensor:
    """``(T, N)``: ``log p(y_t | z_t = i)``."""
    return log_obs[:, ys].T


def _normalized(steps) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows normalized at each step, stacked, and the running sums of their
    normalizers: a recursion that adds each step to a total of order ``T``
    loses the total's precision in float32 (over 4,096 steps of a 64-state
    HMM the log marginal drifted 5e-5 relative on an NVIDIA H100 80GB HBM3
    at 700.00 W), where the normalizers' sums are summed as a scan."""
    rows, norms = zip(*steps)
    return torch.stack(rows), torch.cumsum(torch.stack(norms), dim=0)


def _forward_filters(log_pi, log_trans, lo):
    """The sequential forward recursion from the observation rows ``lo``,
    normalized at each step: the filters ``log p(z_t | y_{0:t})`` ``(T,
    N)`` and the running log marginals ``log p(y_{0:t})`` ``(T,)``."""

    def steps():
        a = log_pi + lo[0]
        for t in range(lo.shape[0]):
            if t:
                a = lo[t] + torch.logsumexp(a[:, None] + log_trans, dim=0)
            c = torch.logsumexp(a, dim=0)
            a = a - c
            yield a, c

    return _normalized(steps())


def forward_backward(log_pi, log_trans, log_obs, ys) -> HMMPosterior:
    """Exact smoothing for a dense HMM. The marginals come from the
    normalized forward and backward messages, normalized again at each step
    (the unnormalized messages of a long sequence are large numbers whose
    float32 rounding would reach the marginals)."""
    lo = _obs_rows(log_obs, ys)
    filters, offsets = _forward_filters(log_pi, log_trans, lo)

    def steps():
        b = torch.zeros_like(log_pi)
        yield b, torch.zeros_like(offsets[-1])
        for t in range(lo.shape[0] - 1, 0, -1):
            b = torch.logsumexp(log_trans + (lo[t] + b)[None, :], dim=1)
            c = torch.max(b)
            b = b - c
            yield b, c

    betas = torch.flip(_normalized(steps())[0], dims=(0,))
    log_gammas = torch.log_softmax(filters + betas, dim=1)
    x = filters[:-1, :, None] + log_trans[None] + (lo[1:] + betas[1:])[:, None, :]
    # xi_t(i, j) = alpha_t(i) + trans(i, j) + obs_{t+1}(j) + beta_{t+1}(j)
    log_xis = x - torch.logsumexp(x.flatten(1), dim=1)[:, None, None]
    return HMMPosterior(log_gammas, log_xis, offsets[-1])


def hmm_log_marginal(log_pi, log_trans, log_obs, ys):
    """Exact ``log p(y_{0:T-1})`` (forward pass only)."""
    return _forward_filters(log_pi, log_trans, _obs_rows(log_obs, ys))[1][-1]


def _logsumexp_product(a, b):
    return torch.logsumexp(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def _max_product(a, b):
    return torch.amax(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def _step_matrices(log_trans, lo):
    """``(T-1, N, N)``: ``M_t(i, j) = trans(i, j) + obs_t(j)``."""
    return log_trans[None] + lo[1:, None, :]


def _semiring_prefix(log_trans, lo, product: Callable):
    """Prefix products ``M_1 x ... x M_{t+1}`` of the per-step matrices
    under the semiring ``product`` (``_logsumexp_product``: sum-product;
    ``_max_product``: max-product)."""
    return associative_scan(lambda a, b: (product(a[0], b[0]),), (_step_matrices(log_trans, lo),))[0]


def forward_parallel(log_pi, log_trans, log_obs, ys):
    """The forward pass in O(log T) depth (T N^3 work): the recursion
    ``alpha_t = alpha_{t-1} o M_t`` is a chain of (log, +)-semiring matrix
    products, composed by the associative scan. Returns ``(alphas (T, N),
    log_marginal)``, the sequential pass's up to summation order."""
    lo = _obs_rows(log_obs, ys)
    alpha0 = log_pi + lo[0]
    if lo.shape[0] == 1:
        return alpha0[None], torch.logsumexp(alpha0, dim=0)
    prefix = _semiring_prefix(log_trans, lo, _logsumexp_product)
    alphas = torch.cat([alpha0[None], torch.logsumexp(alpha0[None, :, None] + prefix, dim=-2)], dim=0)
    return alphas, torch.logsumexp(alphas[-1], dim=0)


def forward_backward_parallel(log_pi, log_trans, log_obs, ys) -> HMMPosterior:
    """Smoothing with both recursions as semiring product chains (two
    associative scans, O(log T) depth). Returns what
    :func:`forward_backward` returns."""
    lo = _obs_rows(log_obs, ys)
    alphas, log_marginal = forward_parallel(log_pi, log_trans, log_obs, ys)
    if lo.shape[0] == 1:
        return HMMPosterior(
            alphas - log_marginal, torch.zeros((0,) + tuple(log_trans.shape), dtype=alphas.dtype,
                                               device=alphas.device), log_marginal)
    mats = _step_matrices(log_trans, lo)
    # beta_t needs the ORDERED suffix product M_{t+1} ... M_{T-1}: the
    # reversed scan folds from the end, so the operands swap
    (suffix,) = reverse_scan(lambda a, b: (_logsumexp_product(b[0], a[0]),), (mats,))
    betas = torch.cat([torch.logsumexp(suffix, dim=-1), torch.zeros_like(log_pi)[None]], dim=0)
    log_xis = alphas[:-1, :, None] + log_trans[None] + (lo[1:] + betas[1:])[:, None, :] - log_marginal
    return HMMPosterior(alphas + betas - log_marginal, log_xis, log_marginal)


def hmm_posterior_sample(gen: torch.Generator, log_pi, log_trans, log_obs, ys):
    """One exact joint draw ``z_{0:T-1} ~ p(z | y)`` by forward filtering,
    backward sampling. Returns ``(path (T,), log_marginal)``; runs under
    ``torch.func.vmap(..., randomness="different")`` for many paths."""
    lo = _obs_rows(log_obs, ys)
    filters, offsets = _forward_filters(log_pi, log_trans, lo)
    trans_t = log_trans.T
    z = categorical.sample(gen, filters[-1])
    path = [z]
    for t in range(lo.shape[0] - 2, -1, -1):
        z = categorical.sample(gen, filters[t] + torch.index_select(trans_t, 0, z.reshape(1))[0])
        path.append(z)
    return torch.stack(path[::-1]), offsets[-1]


def _backtrack(z_last, pick: Callable, T: int) -> torch.Tensor:
    path = [z_last]
    for t in range(T - 2, -1, -1):
        path.append(pick(t, path[-1]))
    return torch.stack(path[::-1])


def viterbi(log_pi, log_trans, log_obs, ys):
    """The MAP state path: ``(path (T,), log p(path, y))``."""
    lo = _obs_rows(log_obs, ys)
    backptrs = []

    def steps():
        # each step's delta shifted by its max, the shifts summed as a scan
        d = log_pi + lo[0]
        for t in range(lo.shape[0]):
            if t:
                best, arg = torch.max(d[:, None] + log_trans, dim=0)
                backptrs.append(arg)
                d = lo[t] + best
            c = torch.max(d)
            d = d - c
            yield d, c

    deltas, offsets = _normalized(steps())
    path = _backtrack(torch.argmax(deltas[-1]), lambda t, z: backptrs[t][z], lo.shape[0])
    return path, offsets[-1]


def viterbi_parallel(log_pi, log_trans, log_obs, ys):
    """Viterbi with the max-product forward pass as one associative scan
    (O(log T) depth); the backtrack reconstructs an optimal path from the
    deltas with a sequential argmax. Same output as :func:`viterbi`."""
    lo = _obs_rows(log_obs, ys)
    delta0 = log_pi + lo[0]
    T = lo.shape[0]
    if T == 1:
        return torch.argmax(delta0)[None], torch.max(delta0)
    prefix = _semiring_prefix(log_trans, lo, _max_product)
    deltas = torch.cat([delta0[None], torch.amax(delta0[None, :, None] + prefix, dim=-2)], dim=0)
    path = _backtrack(torch.argmax(deltas[-1]), lambda t, z: torch.argmax(deltas[t] + log_trans[:, z]), T)
    return path, torch.max(deltas[-1])


def _safe_row_normalize(num, old_log_rows):
    # a state with zero posterior mass has a 0/0 row: it keeps its old
    # parameters (it is unvisited, so any row is optimal in the M-step)
    den = num.sum(dim=1, keepdim=True)
    rows = torch.log(num / torch.where(den > 0, den, torch.ones_like(den)))
    return torch.where(den > 0, rows, old_log_rows)


def hmm_em(log_pi, log_trans, log_obs, ys, *, n_iters: int = 20, fit: tuple = ("pi", "trans", "obs")):
    """Baum-Welch: EM over the dense HMM's parameters. Returns ``((log_pi,
    log_trans, log_obs), log_marginals (n_iters,))``, each iteration's log
    marginal taken before its update (non-decreasing)."""
    ys = torch.as_tensor(ys, device=log_obs.device)
    y_onehot = torch.nn.functional.one_hot(ys.to(torch.int64), log_obs.shape[1]).to(log_obs.dtype)
    lp, lt, lo = log_pi, log_trans, log_obs
    lms = []
    for _ in range(n_iters):
        post = forward_backward(lp, lt, lo, ys)
        lms.append(post.log_marginal)
        lp_new = post.log_gammas[0] if "pi" in fit else lp
        lt_new = _safe_row_normalize(torch.exp(post.log_xis).sum(0), lt) if "trans" in fit else lt
        lo_new = _safe_row_normalize(torch.exp(post.log_gammas).T @ y_onehot, lo) if "obs" in fit else lo
        lp, lt, lo = lp_new, lt_new, lo_new
    return (lp, lt, lo), torch.stack(lms)
