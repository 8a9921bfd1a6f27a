"""ChEES-adaptive HMC: the sampler picks its own trajectory length.

Counterpart of ``examples/16_chees.py``. ChEES (Hoffman & Sountsov 2021)
adapts one shared trajectory length from cross-chain statistics. Three
entry points, top-down:

1. ``sample_posterior(algorithm="chees")``, the one-call driver;
2. ``kernels.column_chees``, a ``@gen`` model through the packer;
3. ``kernels.chees_hmc``, a bare ``(D, N) -> (N,)`` log density.
"""

import numpy as np
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import sample_posterior
from genjax_tpu_torch.kernels import chees_hmc, column_chees
from genjax_tpu_torch.models import linear_regression

from ._common import cli, device_of


def main(device="cuda"):
    device = device_of(device)
    N, D = 24, 3
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, D)).astype(np.float32)
    w_true = np.asarray([1.0, -2.0, 0.5], np.float32)
    y = (X @ w_true + 0.25 * rng.normal(size=N)).astype(np.float32)
    model, exact_posterior = linear_regression(X)
    post_mean, post_cov = (torch.as_tensor(v, dtype=torch.float32).to(device)
                           for v in exact_posterior(torch.from_numpy(y)))
    obs = g.C["y"].set(torch.from_numpy(y).to(device))

    # ---- 1. the one-call driver
    res = sample_posterior(0, model, obs, (), g.S["w"], n_chains=512, n_warmup=300, n_samples=100,
                           algorithm="chees", eps0=0.05, device=device)
    draws = res["w"][:, 30:]  # (chains, samples, D)
    emp_mean = torch.mean(draws.reshape(-1, D), dim=0)
    assert torch.allclose(emp_mean, post_mean, atol=0.02), emp_mean
    emp_cov = torch.cov(draws.reshape(-1, D).T)
    assert torch.allclose(emp_cov, post_cov, atol=5e-3)
    assert float(torch.max(res.rhat_of("w"))) < 1.1
    print("driver: mean", np.round(emp_mean.cpu().numpy(), 3), "exact", np.round(post_mean.cpu().numpy(), 3))
    print("adapted eps:", float(res.eps), "divergences:", float(res.divergence_rate))

    # ---- 2. the model-level column sampler
    q, info, packer = column_chees(model, obs, (), ["w"], n_chains=512, n_warmup=300, n_steps=100, eps=0.05,
                                   device=device)
    w_draws = q[: packer.dim, :]  # (D, chains) final positions
    assert torch.allclose(torch.mean(w_draws, dim=1), post_mean, atol=0.03)
    print("column_chees: trajectory length", round(float(info.trajectory_length), 3),
          "mean leapfrogs/sweep", round(float(info.mean_leapfrogs), 1))

    # ---- 3. the bare sampler on a custom log density
    scales = torch.tensor([1.0, 5.0], device=device)

    def ld(qcols):  # (2, N) -> (N,)
        return -0.5 * torch.sum((qcols / scales[:, None]) ** 2, dim=0)

    q0 = 0.1 * torch.randn((2, 1024), generator=torch.Generator(device=device).manual_seed(1), device=device)
    qf, info = chees_hmc(ld, q0, 7, n_warmup=300, n_steps=150, eps0=0.05)
    sd = np.std(qf.cpu().numpy(), axis=1)
    assert np.allclose(sd, scales.cpu().numpy(), rtol=0.12)
    print("bare sampler: recovered scales", np.round(sd, 2), "accept", round(float(info.accept_rate), 2))


if __name__ == "__main__":
    cli(main)
