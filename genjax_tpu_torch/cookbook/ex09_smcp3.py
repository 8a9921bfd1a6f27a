"""SMCP3: sequential Monte Carlo with probabilistic-program proposals.

Counterpart of ``examples/09_smcp3.py``:

1. a custom drift-kernel move via ``Rejuvenate`` (the forward kernel
   proposes from a random walk, the backward kernel's density is scored
   automatically, the SMCP3 weight is the exact MH log-ratio);
2. tempered SMC on a bimodal posterior, prior regeneration against the
   drift kernel, held to the quadrature log marginal;
3. the round-trip identity: each move's backward request undoes it.
"""

import math

import numpy as np
import torch
from scipy import stats as st
from scipy.special import logsumexp

import genjax_tpu_torch as g
from genjax_tpu_torch.inference.tempered import geometric_ladder, tempered_smc

from ._common import cli, device_of

# A well-separated bimodal posterior: mu ~ N(0, 3); y_i ~ N(mu^2, 0.5)
# (the square folds two modes mu = +-sqrt(4) onto the same data).
N_OBS = 12


@g.gen
def obs_point(i, mu):
    return g.normal(mu * mu, 0.5) @ "y"


@g.gen
def model():
    mu = g.normal(0.0, 3.0) @ "mu"
    _ = obs_point.vmap(in_axes=(0, None))(torch.arange(N_OBS, device=mu.device), mu) @ "obs"
    return mu


DATA = np.full((N_OBS,), 4.0, np.float32)  # consistent with mu = +-2


def drift_move(scale):
    """A random-walk kernel over "mu" as a generative function: the forward
    move proposes mu' ~ N(mu, scale); Rejuvenate scores the backward move
    q(mu | mu') automatically."""

    @g.gen
    def kernel(center):
        _ = g.normal(center, scale) @ "mu"

    return g.Rejuvenate(kernel, lambda chm: (chm["mu"],))


def exact_log_marginal():
    """Quadrature ground truth for log p(DATA)."""
    mus = np.linspace(-12.0, 12.0, 40001)
    log_prior = st.norm.logpdf(mus, 0.0, 3.0)
    log_lik = np.sum(st.norm.logpdf(DATA[:, None].astype(np.float64), mus[None, :] ** 2, 0.5), axis=0)
    return logsumexp(log_prior + log_lik) + math.log(mus[1] - mus[0])


def main(device="cuda"):
    device = device_of(device)
    exact = float(exact_log_marginal())
    constraint = g.C["obs", :, "y"].set(torch.from_numpy(DATA).to(device))

    # --- 1. the move in isolation: exact MH ratio and round trip
    tr, _ = model.generate(torch.Generator(device=device).manual_seed(0), constraint, ())
    move = drift_move(0.3)
    new_tr, alpha, _rd, bwd = tr.edit(torch.Generator(device=device).manual_seed(1), move)
    # the proposal actually moved "mu" and the trace stayed consistent
    assert float(new_tr.get_choices()["mu"]) != float(tr.get_choices()["mu"])
    score, _ = model.assess(new_tr.get_choices(), ())
    assert torch.allclose(new_tr.get_score(), score, atol=1e-4)
    # alpha is a finite MH log-ratio; the backward request is again a
    # Rejuvenate with the same kernel (the move family is self-reversing)
    assert math.isfinite(float(alpha))
    assert isinstance(bwd, g.Rejuvenate)

    # --- 2. tempered SMC: prior regeneration vs the SMCP3 drift kernel
    betas = geometric_ladder(30)
    res_prior = tempered_smc(3, model, constraint, (), n_particles=512, betas=betas, rejuvenation=g.S["mu"],
                             n_rejuvenation=2, device=device)
    res_drift = tempered_smc(3, model, constraint, (), n_particles=512, betas=betas, rejuvenation=drift_move(0.3),
                             n_rejuvenation=2, device=device)
    err_prior = abs(float(res_prior.log_marginal) - exact)
    err_drift = abs(float(res_drift.log_marginal) - exact)
    print(f"exact logZ {exact:.3f} | prior-regen err {err_prior:.3f} | drift-kernel err {err_drift:.3f}")
    # the local drift kernel tracks the tempered path; prior regeneration
    # proposes from N(0,3) and is rarely accepted near the modes
    assert err_drift < 1.0
    assert err_drift <= err_prior + 0.25

    # --- 3. both modes survive in the drift-kernel posterior
    mus = res_drift.traces.get_choices()["mu"]
    assert float(torch.mean((mus > 0).float())) > 0.05
    assert float(torch.mean((mus < 0).float())) > 0.05
    assert abs(float(torch.mean(torch.abs(mus))) - 2.0) <= 0.2

    print("SMCP3 cookbook: all sections OK")


if __name__ == "__main__":
    cli(main)
