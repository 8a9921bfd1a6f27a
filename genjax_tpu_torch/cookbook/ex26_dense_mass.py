"""Dense mass-matrix HMC: precondition correlated posteriors for free.

Counterpart of ``examples/26_dense_mass.py``. A diagonal metric caps the
integrator step at the smallest conditional scale of the target; one
cross-chain time slice of many chains estimates the full posterior
covariance, and applying it costs two (D, D) x (D, N) products a leapfrog.
Three entry points, top-down:

1. ``sample_posterior(algorithm="dense_hmc")`` (and ``"dense_nuts"``);
2. ``kernels.column_hmc(mass="dense", warmup=True)``, the ``@gen`` bridge;
3. ``kernels.dense_mass.{warmup_column_dense, hmc_sweep_dense_cols}`` on a
   bare ``(D, N) -> (N,)`` log density.

The running example is Bayesian linear regression with a near-collinear
design, whose posterior is an exactly known correlated Gaussian.
"""

import numpy as np
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import sample_posterior
from genjax_tpu_torch.kernels import column_hmc
from genjax_tpu_torch.kernels.dense_mass import cross_chain_cov, hmc_sweep_dense_cols, warmup_column_dense

from ._common import cli, device_of


def make_problem(seed=0, n_obs=32, s2=0.25):
    rng = np.random.RandomState(seed)
    x1 = rng.randn(n_obs)
    # second column = first + small noise: near-collinear design
    X = np.stack([x1, x1 + 0.15 * rng.randn(n_obs)], axis=1).astype(np.float32)
    y = (X @ np.asarray([1.0, -0.5]) + np.sqrt(s2) * rng.randn(n_obs)).astype(np.float32)
    prec_post = np.eye(2) + X.T @ X / s2
    cov_post = np.linalg.inv(prec_post)
    mean_post = cov_post @ (X.T @ y) / s2
    rho = cov_post[0, 1] / np.sqrt(cov_post[0, 0] * cov_post[1, 1])
    return X, y, s2, mean_post, cov_post, rho


def main(device="cuda"):
    device = device_of(device)
    X, y, s2, mean_post, cov_post, rho = make_problem()
    print(f"posterior correlation rho = {rho:.3f}")
    assert abs(rho) > 0.9  # the regime this sampler exists for
    Xt = torch.from_numpy(X).to(device)

    @g.gen
    def model():
        w = g.mv_normal_diag(torch.zeros(2, device=device), torch.ones(2, device=device)) @ "w"
        _ = g.mv_normal_diag(Xt @ w, torch.full((len(y),), float(np.sqrt(s2)), device=device)) @ "y"

    obs = g.C["y"].set(torch.from_numpy(y).to(device))

    # ---- 1. the one-call driver
    res = sample_posterior(0, model, obs, (), g.S["w"], n_chains=512, n_warmup=200, n_samples=100, thin=2,
                           algorithm="dense_hmc", eps0=0.2, L=4, device=device)
    flat = res["w"].reshape(-1, 2).T.cpu().numpy()
    print(f"driver: accept={float(res.accept_rate):.2f} mean={flat.mean(axis=1).round(3)} (exact {mean_post.round(3)})")
    assert float(res.accept_rate) > 0.5
    np.testing.assert_allclose(flat.mean(axis=1), mean_post, atol=0.05)
    np.testing.assert_allclose(np.cov(flat), cov_post, atol=0.03)

    # ---- 1b. dense metric + NUTS: the metric estimated during warmup,
    # then NUTS in whitened coordinates where the target is isotropic
    res_n = sample_posterior(1, model, obs, (), g.S["w"], n_chains=512, n_warmup=200, n_samples=100, thin=2,
                             algorithm="dense_nuts", eps0=0.2, max_depth=6, device=device)
    flat_n = res_n["w"].reshape(-1, 2).T.cpu().numpy()
    np.testing.assert_allclose(flat_n.mean(axis=1), mean_post, atol=0.05)
    np.testing.assert_allclose(np.cov(flat_n), cov_post, atol=0.03)
    print(f"dense_nuts: accept={float(res_n.accept_rate):.2f} divergences={float(res_n.divergence_rate):.3f}")

    # ---- 2. the @gen column bridge (the dense metric has no kernel: the
    # torch sweep, as the reference's XLA one)
    q, accept, packer = column_hmc(model, obs, (), ["w"], n_chains=512, n_steps=300, eps=0.3, L=4, warmup=True,
                                   mass="dense", backend="torch", device=device)
    draws = q[:2].cpu().numpy()
    np.testing.assert_allclose(draws.mean(axis=1), mean_post, atol=0.05)
    print(f"column bridge: accept={float(accept):.2f}")

    # ---- 3. bare columns: see the metric do its work
    prec = torch.from_numpy((np.eye(2) + X.T @ X / s2).astype(np.float32)).to(device)
    mean_t = torch.from_numpy(mean_post.astype(np.float32)).to(device)

    def ld(q):
        r = q - mean_t[:, None]
        return -0.5 * torch.sum(r * (prec @ r), dim=0)

    q0 = torch.from_numpy(np.random.RandomState(1).randn(2, 1024).astype(np.float32)).to(device)
    q0, eps, cov_chol = warmup_column_dense(ld, q0, 7, n_phases=6, steps_per_phase=25, eps0=0.1, L=4)
    # the adapted metric ~ the exact posterior covariance
    est = (cov_chol @ cov_chol.T).cpu().numpy()
    np.testing.assert_allclose(est, cov_post, rtol=0.4, atol=0.02)

    # same step size, dense vs identity metric: the acceptance gap IS the
    # sqrt(1 - rho^2) conditioning penalty
    _, acc_dense = hmc_sweep_dense_cols(ld, q0, 1, n_steps=50, eps=float(eps), L=4, cov_chol=cov_chol)
    _, acc_diag = hmc_sweep_dense_cols(ld, q0, 1, n_steps=50, eps=float(eps), L=4,
                                       cov_chol=torch.eye(2, device=device) * float(np.sqrt(cov_post.diagonal().max())))
    print(f"same eps: dense accept={float(acc_dense):.2f}, diagonal accept={float(acc_diag):.2f}")
    assert float(acc_dense) > 0.6
    assert float(acc_diag) < float(acc_dense) - 0.2

    # the estimator itself, on known draws
    chol_true = np.linalg.cholesky(cov_post).astype(np.float32)
    cloud = torch.from_numpy(chol_true @ np.random.RandomState(2).randn(2, 8192).astype(np.float32)
                             + mean_post[:, None].astype(np.float32)).to(device)
    est2 = cross_chain_cov(cloud, shrinkage=0.0).cpu().numpy()
    np.testing.assert_allclose(est2, cov_post, atol=0.02)
    print("cross-chain covariance estimator: exact on known draws")


if __name__ == "__main__":
    cli(main)
