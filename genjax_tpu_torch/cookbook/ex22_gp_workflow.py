"""Gaussian-process regression end to end.

Counterpart of ``examples/22_gp_workflow.py``. One GP dataset through the
whole stack:

1. hyperparameters: ``models.gp_regression`` marginalizes the function
   values exactly, so column HMC over (log_amp, log_ls, log_noise) targets
   the exact hyperposterior. The reference runs its XLA twin
   (``backend="xla"``); the port runs the torch twin (``backend="torch"``),
   the model having no device body for K1;
2. prediction: the closed-form ``gp_posterior`` at the posterior-mean
   hyperparameters, calibration checked against held-out truth;
3. latent sampling: elliptical slice sampling draws f | y exactly, its
   moments held to the closed form; the Gaussian-likelihood fast path is
   ``ess_sweep_gauss_pallas``, which launches K3 for chains on the card and
   runs its plain twin on the CPU.
"""

import numpy as np
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.kernels import column_hmc, ess_sweep_cols, ess_sweep_gauss_pallas
from genjax_tpu_torch.models import gp_posterior, gp_regression, sq_exp_kernel

from ._common import cli, device_of

AMP, LS, NOISE = 1.2, 0.8, 0.25
N_TRAIN, N_TEST = 24, 8


def make_data(seed=0):
    rng = np.random.RandomState(seed)
    X = np.sort(rng.uniform(-3, 3, size=(N_TRAIN + N_TEST, 1)), axis=0)
    K = sq_exp_kernel(torch.from_numpy(X), torch.from_numpy(X), AMP, LS).numpy() + 1e-6 * np.eye(len(X))
    f = rng.multivariate_normal(np.zeros(len(X)), K)
    idx = rng.permutation(len(X))
    tr_i, te_i = idx[:N_TRAIN], idx[N_TRAIN:]
    y_train = (f[tr_i] + NOISE * rng.randn(N_TRAIN)).astype(np.float32)
    return X[tr_i].astype(np.float32), y_train, X[te_i].astype(np.float32), f[te_i]


def main(device="cuda"):
    device = device_of(device)
    X, y, X_test, f_test = make_data()
    y_t = torch.from_numpy(y).to(device)

    # ---- 1. hyperparameter posterior through column HMC
    model = gp_regression(X)
    q, accept, packer = column_hmc(model, g.C["y"].set(y_t), (), ["log_amp", "log_ls", "log_noise"], n_chains=64,
                                   n_steps=300, eps=0.05, L=8, backend="torch", device=device)
    draws = q[:3].cpu().numpy()  # (3, chains)
    la, ll_, ln = (float(v) for v in draws.mean(axis=1))
    print(f"hyperposterior means: amp={np.exp(la):.2f} (true {AMP}), ls={np.exp(ll_):.2f} (true {LS}), "
          f"noise={np.exp(ln):.2f} (true {NOISE}); accept={float(accept):.2f}")
    assert float(accept) > 0.5
    assert abs(ln - np.log(NOISE)) < 1.0  # N=24: broad but centered

    # ---- 2. closed-form prediction at the posterior mean
    mean, cov = gp_posterior(X, y, X_test, np.exp(la), np.exp(ll_), np.exp(ln), device=device)
    sd = np.sqrt(np.diag(cov.cpu().numpy()))
    z = np.abs(mean.cpu().numpy() - f_test) / (sd + 1e-6)
    print(f"held-out |z|-scores: max={z.max():.2f}")
    assert (z < 4.0).all(), z  # calibrated predictive

    # ---- 3. exact latent draws by elliptical slice sampling
    K = sq_exp_kernel(torch.from_numpy(X), torch.from_numpy(X), np.exp(la), np.exp(ll_)).numpy() + 1e-5 * np.eye(
        N_TRAIN)
    chol = torch.from_numpy(np.linalg.cholesky(K).astype(np.float32)).to(device)
    noise2 = float(np.exp(2 * ln))

    def log_lik(f_cols):
        resid = y_t[:, None] - f_cols
        return -0.5 * torch.sum(resid**2, dim=0) / noise2

    f_cols, _ = ess_sweep_cols(log_lik, torch.zeros((N_TRAIN, 1024), device=device), 3, n_steps=200,
                               chol_prior=chol)
    mean_exact, _ = gp_posterior(X, y, X, np.exp(la), np.exp(ll_), np.exp(ln), jitter=1e-5, device=device)
    err = np.abs(f_cols.mean(dim=1).cpu().numpy() - mean_exact.cpu().numpy())
    print(f"ESS latent means vs closed form: max err={err.max():.3f}")
    assert err.max() < 0.1

    # Gaussian observation noise: the fast path, ll(theta) along the
    # ellipse a six-coefficient trig quadratic, one K3 launch on the card
    f_fast = ess_sweep_gauss_pallas(torch.zeros((N_TRAIN, 1024), device=device), 3, n_steps=200, chol_prior=chol,
                                    y=y_t, prec=1.0 / noise2, max_iters=64, device=device)
    err_fast = np.abs(f_fast.mean(dim=1).cpu().numpy() - mean_exact.cpu().numpy())
    print(f"fast-path latent means vs closed form: max err={err_fast.max():.3f}")
    assert err_fast.max() < 0.1


if __name__ == "__main__":
    cli(main)
