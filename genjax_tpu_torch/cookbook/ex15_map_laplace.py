"""Point estimation and Gaussian approximation: fit_map and Laplace.

Counterpart of ``examples/15_map_laplace.py``: gradient-based MAP over the
selected continuous choices, and the Laplace approximation built on it,
exact on a Gaussian posterior, checked for mean, covariance and evidence
against closed forms. ``main`` returns the MAP point and the Laplace
moments and evidence, which the tests hold to the reference's.
"""

import numpy as np
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import fit_map, laplace_approximation
from genjax_tpu_torch.models import linear_regression

from ._common import cli, device_of


def main(device="cuda"):
    device = device_of(device)
    N, D = 24, 3
    rng = np.random.default_rng(3)
    X = rng.normal(size=(N, D)).astype(np.float32)
    w_true = np.asarray([1.5, -0.5, 2.0], np.float32)
    y = (X @ w_true + 0.25 * rng.normal(size=N)).astype(np.float32)

    model, exact_posterior = linear_regression(X)
    post_mean, post_cov = (torch.as_tensor(v, dtype=torch.float32).to(device)
                           for v in exact_posterior(torch.from_numpy(y)))
    obs = g.C["y"].set(torch.from_numpy(y).to(device))

    # --- MAP: batched-restart Adam
    res = fit_map(0, model, obs, (), g.S["w"], n_steps=400, learning_rate=0.05, device=device)
    assert torch.allclose(res["w"], post_mean, atol=0.01)  # mode == mean here

    # --- Laplace: curvature at the mode
    lap = laplace_approximation(1, model, obs, (), g.S["w"], n_steps=400, learning_rate=0.05, device=device)
    assert torch.allclose(lap.mean, post_mean, atol=0.01)
    assert torch.allclose(lap.cov, post_cov, atol=1e-3)

    # the Laplace evidence matches the exact marginal likelihood
    S = 0.25**2 * np.eye(N) + X.astype(np.float64) @ X.T.astype(np.float64)
    _sign, logdet = np.linalg.slogdet(2 * np.pi * S)
    exact_lml = -0.5 * (logdet + y @ np.linalg.solve(S, y))
    assert abs(float(lap.log_marginal) - exact_lml) <= 0.01 + 1e-5 * abs(exact_lml)

    print(f"MAP w = {np.round(res['w'].cpu().numpy(), 3)} (exact mode {np.round(post_mean.cpu().numpy(), 3)}); "
          f"Laplace logZ {float(lap.log_marginal):.3f} (exact {float(exact_lml):.3f})")
    print("MAP/Laplace cookbook: OK")
    return {"map": res["w"].cpu().numpy(), "mean": lap.mean.cpu().numpy(), "cov": lap.cov.cpu().numpy(),
            "log_marginal": float(lap.log_marginal), "X": X, "y": y}


if __name__ == "__main__":
    cli(main)
