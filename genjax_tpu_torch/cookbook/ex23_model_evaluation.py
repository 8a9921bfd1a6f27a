"""Model evaluation: information criteria and calibration.

Counterpart of ``examples/23_model_evaluation.py``: after fitting, (1) score
candidate models on held-out-equivalent predictive density with WAIC and
PSIS-LOO, checking the Pareto k-hat reliability diagnostics, (2)
``compare`` them, and (3) audit the pipeline's calibration with
simulation-based calibration.

Ground truth: the data come from a quadratic curve, so the quadratic
regression must beat the linear one by more than the comparison's standard
error, and the exact conjugate sampler must pass SBC.

One correction of the reference (``ROADMAP.md``, "Defects in the
reference"): the reference fits each model with 600 posterior draws (8
chains x 75), at which the linear model's largest k-hat exceeds 0.7 at some
seeds in both packages (0.786 in the reference at seed 1; 0.742 in the port
at seed 0); ``scripts/loo_khat_seeds.py --draws`` finds the smallest count
at which the claim holds at seeds 0-5 in both, the port on the CPU and on
the card alike, ``N_DRAWS`` here. The bound is the reference's.
"""

import numpy as np
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.dists import mv_normal_diag
from genjax_tpu_torch.inference import compare, psis_loo, sample_posterior, sbc_ranks, sbc_uniformity, waic

from ._common import cli, device_of

N, SIGMA = 40, 0.3
rng = np.random.RandomState(0)
XS = np.sort(rng.uniform(-2, 2, N)).astype(np.float32)
YS = (0.5 * XS**2 - 0.4 * XS + SIGMA * rng.randn(N)).astype(np.float32)
N_CHAINS = 8
N_DRAWS = 3600  # the reference's 600 (8 x 75), corrected: see the module docstring


def make_model(degree, device):
    feats = torch.from_numpy(np.stack([XS**p for p in range(degree + 1)], 1).astype(np.float32)).to(device)

    @g.gen
    def model():
        w = mv_normal_diag(torch.zeros(degree + 1, device=device), torch.ones(degree + 1, device=device)) @ "w"
        mv_normal_diag(feats @ w, SIGMA * torch.ones(N, device=device)) @ "y"

    return model, feats


def pointwise_loglik(model, feats, device, n_draws=N_DRAWS, seed=0):
    """Fit, then build the (S, N) pointwise log-likelihood matrix from the
    posterior draws of w: one batched density evaluation. Returns it and
    the fit (``scripts/loo_khat_seeds.py`` reads its step size and ESS)."""
    ys = torch.from_numpy(YS).to(device)
    res = sample_posterior(seed, model, g.C["y"].set(ys), (), g.S["w"], n_chains=N_CHAINS, n_warmup=200,
                           n_samples=n_draws // N_CHAINS, algorithm="hmc", eps0=0.1, device=device)
    ws = res["w"].reshape(-1, feats.shape[1])
    mus = ws @ feats.T  # (S, N)
    return torch.distributions.Normal(mus, SIGMA).log_prob(ys[None, :]), res


def main(device="cuda"):
    device = device_of(device)
    # ---- 1 & 2: information criteria and comparison
    results = {}
    k_hats = {}
    for name, degree in (("linear", 1), ("quadratic", 2)):
        model, feats = make_model(degree, device)
        ll, _ = pointwise_loglik(model, feats, device)
        res = psis_loo(ll)
        results[name] = res
        k_max = float(torch.as_tensor(res.pareto_k).max())
        k_hats[name] = k_max
        print(f"{name:10s}: LOO elpd={float(res.elpd):7.1f} (p_eff={float(res.p_eff):.1f}, "
              f"max k-hat={k_max:.2f}); WAIC elpd={float(waic(ll).elpd):7.1f}")
        assert k_max < 0.7  # reliable estimates

    rows = compare(results)
    print("ranking:", [(r[0], round(r[2], 1)) for r in rows])
    assert rows[0][0] == "quadratic"
    d_elpd, d_se = rows[1][2], rows[1][3]
    assert d_elpd < -d_se, (d_elpd, d_se)  # decisively worse

    # ---- 3: calibration audit of the pipeline
    @g.gen
    def small():
        mu = g.normal(0.0, 1.0) @ "mu"
        g.normal(mu, 0.5) @ "y"

    v = 1.0 / (1.0 + 1.0 / 0.25)

    def exact_sampler(gen, constraint):
        y = constraint.get_submap("y").get_value()
        return (v * y / 0.25 + v**0.5 * torch.randn(99, generator=gen, device=gen.device))[:, None]

    res = sbc_ranks(1, small, (), g.S["mu"], exact_sampler, n_sims=300, device=device)
    pvals, _ = sbc_uniformity(res, n_bins=20)
    print(f"SBC uniformity p-value: {float(pvals[0]):.3f}")
    assert float(pvals[0]) > 0.01
    print("model evaluation cookbook: OK")
    return {"k_hats": k_hats, "d_elpd": d_elpd, "d_se": d_se, "sbc_p": float(pvals[0])}


if __name__ == "__main__":
    cli(main)
