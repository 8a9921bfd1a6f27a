"""Stochastic probabilities: distributions whose densities are unbiasedly
estimated by nested inference (GenSP).

Counterpart of ``examples/11_stochastic_probabilities.py``. ``Marginal``
turns a generative function and a selection into a ``SampleDistribution``:
sampling runs the model and keeps the selected addresses;
``estimate_logpdf`` runs an inference algorithm over the marginalized
randomness. The estimates are unbiased in density space.
"""

import math

import torch
from scipy import stats as st

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import ImportanceK, Marginal, Target

from ._common import batch, cli, device_of


# A two-component mixture with the discrete component auxiliary:
@g.gen
def mixture():
    z = g.flip(0.3) @ "z"
    mu = torch.where(z, 2.0, -2.0)
    x = g.normal(mu, 0.7) @ "x"
    return x


def exact_density(x):
    return 0.3 * st.norm.pdf(x, 2.0, 0.7) + 0.7 * st.norm.pdf(x, -2.0, 0.7)


def _mean_density(ests):
    return math.exp(float(torch.logsumexp(ests, 0)) - math.log(ests.shape[0]))


def main(device="cuda"):
    device = device_of(device)
    # Marginal over "x": z is marginalized by nested inference
    marg = Marginal(mixture, g.Pytree.const(g.S["x"]), g.Pytree.const(None))

    # --- sampling runs the model; the score is a density ESTIMATE
    score_est, chm = marg.random_weighted(torch.Generator(device=device).manual_seed(0))
    assert math.isfinite(float(score_est))

    # --- unbiasedness: E[exp(estimate_logpdf(x))] = p(x)
    x_probe = 1.0
    probe_chm = g.C["x"].set(torch.tensor(x_probe, device=device))
    gen1 = torch.Generator(device=device).manual_seed(1)
    ests = batch(lambda: marg.estimate_logpdf(gen1, probe_chm), 8000, device)
    mean_density = _mean_density(ests)
    truth = float(exact_density(x_probe))
    assert abs(mean_density - truth) <= 0.1 * abs(truth), (mean_density, truth)

    # --- a custom algorithm sharpens the estimate: K-particle importance
    # sampling over the auxiliary choice, retargeted to each queried
    # conditional via ChangeTarget reweighting. The base target constrains
    # the SAME addresses as the queries (here "x", with a placeholder
    # value) so the reweighting spaces align.
    base = Target(mixture, (), g.C["x"].set(torch.tensor(0.0, device=device)))
    marg_k = Marginal(mixture, g.Pytree.const(g.S["x"]), g.Pytree.const(ImportanceK(base, k_particles=64)))
    gen2 = torch.Generator(device=device).manual_seed(2)
    ests_k = batch(lambda: marg_k.estimate_logpdf(gen2, probe_chm), 500, device)
    # still unbiased, and much lower variance than the 1-particle default
    mean_k = _mean_density(ests_k)
    assert abs(mean_k - truth) <= 0.1 * abs(truth)
    assert torch.var(ests_k, correction=0) < torch.var(ests, correction=0)

    # --- nested use: the marginal as a prior inside another model
    @g.gen
    def outer():
        x_chm = marg() @ "x"
        y = g.normal(x_chm["x"], 0.5) @ "y"
        return y

    tr = outer.simulate(torch.Generator(device=device).manual_seed(3), ())
    assert math.isfinite(float(tr.get_score()))

    print(f"p({x_probe}) exact {truth:.4f} | 1-particle estimate {mean_density:.4f} | "
          f"64-particle estimate {mean_k:.4f}")
    print("stochastic-probabilities cookbook: OK")


if __name__ == "__main__":
    cli(main)
