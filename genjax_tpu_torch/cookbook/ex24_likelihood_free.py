"""Likelihood-free inference: ABC when only the simulator exists.

Counterpart of ``examples/24_likelihood_free.py``. Inference uses only prior
simulation and a distance between simulated and observed data:

1. ``abc_rejection``: simulate N draws, accept those within tolerance; all
   draws come back under one vectorized ``Mask``;
2. ``abc_smc``: the adaptive tolerance ladder, each generation lowering
   the tolerance to a quantile of the current distances, resampling the
   survivors and diversifying them with ABC-MCMC moves.

The toy simulator is a Gaussian, so the ABC posterior has a closed form
(prior times interval probability) that the narrative asserts against.
"""

import numpy as np
import torch
from scipy.stats import norm

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import abc_rejection, abc_smc, column_weighted_moments

from ._common import cli, device_of

T0 = 1.0  # prior sd of the parameter
S = 0.7  # simulator noise sd
Y_OBS = 1.3


@g.gen
def simulator():
    theta = g.normal(0.0, T0) @ "theta"
    y = g.normal(theta, S) @ "y"  # stand-in for an intractable simulator
    return y


def distance(tr):
    return torch.abs(tr.get_choices()["y"] - Y_OBS)


def exact_abc_moments(eps, grid_n=100_001, lim=6.0):
    """Ground truth by quadrature: p_eps(theta) ~ prior(theta) x
    P(|y - Y_OBS| < eps | theta)."""
    th = np.linspace(-lim, lim, grid_n)
    w = np.array(norm.pdf(th, 0.0, T0) * (norm.cdf((Y_OBS + eps - th) / S) - norm.cdf((Y_OBS - eps - th) / S)))
    w = w / np.trapezoid(w, th)
    mean = np.trapezoid(th * w, th)
    var = np.trapezoid((th - mean) ** 2 * w, th)
    return float(mean), float(var)


def main(device="cuda"):
    device = device_of(device)
    # ---- 1. rejection ABC: one vmapped simulate-and-compare
    eps = 0.4
    rej = abc_rejection(0, simulator, (), distance, n_samples=200_000, tolerance=eps, device=device)
    flag = rej.choices.flag
    th = rej.choices.value["theta"]
    w = flag.to(torch.float32)
    mean = float(torch.sum(w * th) / torch.sum(w))
    exact_mean, _ = exact_abc_moments(eps)
    print(f"rejection ABC @ eps={eps}: accept={float(rej.accept_rate):.3f}, posterior mean={mean:.3f} "
          f"(exact {exact_mean:.3f})")
    assert abs(mean - exact_mean) < 0.03

    # ---- 2. adaptive ABC-SMC: the tolerance ladder
    res, packer = abc_smc(1, simulator, (), distance, ["theta"], n_particles=4096, n_generations=10, device=device)
    smc_mean, smc_var = column_weighted_moments(res.params, packer.dim)
    eps_final = float(res.tolerance)
    exact_mean, exact_var = exact_abc_moments(eps_final)
    ladder = [f"{float(e):.2f}" for e in res.tolerance_history]
    print(f"ABC-SMC ladder: {' > '.join(ladder)}")
    print(f"final eps={eps_final:.3f}: mean={float(smc_mean[0]):.3f} (exact {exact_mean:.3f}), "
          f"var={float(smc_var[0]):.3f} (exact {exact_var:.3f})")
    assert abs(float(smc_mean[0]) - exact_mean) < 0.07
    assert abs(float(smc_var[0]) - exact_var) < 0.08
    # the ladder is monotone and ends far below where rejection started
    hist = torch.as_tensor(res.tolerance_history).cpu().numpy()
    assert (np.diff(hist) <= 1e-7).all()
    assert eps_final < eps

    # a particle is a column; unpack it back into model address space
    chm = packer.unpack(res.params[:, 0])
    print(f"one posterior draw: theta = {float(chm['theta']):.3f}")


if __name__ == "__main__":
    cli(main)
