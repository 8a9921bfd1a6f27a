"""Big-data Bayesian inference: data sharding and stochastic gradients.

Counterpart of ``examples/20_big_data.py``, two regimes:

1. exact, data-sharded: the dataset is split over a mesh axis; the log
   likelihood and its gradient are computed shard by shard and summed over
   that axis. The result is an ordinary column log density, and full-batch
   HMC runs on it unchanged;
2. stochastic-gradient: SGLD steps on unbiased minibatch gradients.

Both are held to the closed-form posterior of Bayesian linear regression
with known noise. Each rank holds its share of the chains, so the accept
rate read is the mesh's mean and the draws are gathered before the checks
("a sharded batch is each rank's local slice", ``ROADMAP.md``, Deviations
of slice 16). On the card the HMC sweep runs the torch twin, asked for with
``backend="torch"``: a density that issues a collective has no device body.
"""

import numpy as np
import torch

from genjax_tpu_torch.kernels import minibatch_grad_cols, pallas_hmc, sgld_sweep_cols
from genjax_tpu_torch.parallel import data_sharded_logdensity, gather_batch, make_mesh_2d, shard_batch, shard_data

from ._common import cli, device_of, world_of_one

D, M = 4, 256
SIGMA = 0.5


def make_dataset():
    rng = np.random.RandomState(7)
    X = rng.randn(M, D).astype(np.float32)
    w_true = rng.randn(D).astype(np.float32)
    y = (X @ w_true + SIGMA * rng.randn(M)).astype(np.float32)
    return X, y


def exact_posterior(X, y):
    """w ~ N(0, I), y | w ~ N(Xw, sigma^2 I): posterior N(mu, Sigma) with
    Sigma = (I + X'X/sigma^2)^-1, mu = Sigma X'y / sigma^2."""
    prec = np.eye(D) + X.T @ X / SIGMA**2
    cov = np.linalg.inv(prec)
    mu = cov @ (X.T @ y) / SIGMA**2
    return mu, cov


def log_prior(q):
    return -0.5 * torch.sum(q**2, dim=0)


def log_lik(q, shard):
    x, y = shard
    resid = y[:, None] - x @ q[:D]
    return -0.5 * torch.sum(resid**2, dim=0) / SIGMA**2


def run(mesh, X, y, mu_post, cov_post):
    device = mesh.device
    n_dev = mesh.world_size
    print(f"2-D mesh {mesh.shape}")
    data = shard_data((torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)), mesh)
    ld = data_sharded_logdensity(log_prior, log_lik, data, mesh)

    n_chains = 512
    q0 = torch.from_numpy(np.random.RandomState(1).randn(8, n_chains).astype(np.float32))
    q0_local = shard_batch(q0.T, mesh, "batch").T.contiguous().to(device)
    q, accept = pallas_hmc(ld, q0_local, 11 + mesh.axis_index("batch"), n_steps=400, eps=0.04, L=10,
                           backend="torch")
    accept = float(mesh.all_reduce_mean(accept, "batch"))
    draws = gather_batch(q[:D].T.contiguous(), mesh, "batch").T.cpu().numpy()
    err = np.abs(draws.mean(axis=1) - mu_post).max()
    print(f"sharded HMC ({n_dev} rank(s)): accept={accept:.2f}, max|mean err|={err:.3f}")
    assert accept > 0.5
    assert err < 0.05, (draws.mean(axis=1), mu_post)
    # marginal sds too: the geometry survived the sharding
    np.testing.assert_allclose(draws.std(axis=1), np.sqrt(np.diag(cov_post)), rtol=0.35)


def main(device="cuda"):
    device = device_of(device)
    X, y = make_dataset()
    mu_post, cov_post = exact_posterior(X, y)

    # ---- regime 1: exact inference over a chains x data mesh
    with world_of_one(device):
        n_dev = torch.distributed.get_world_size()
        shape = (2, n_dev // 2) if n_dev % 2 == 0 and n_dev > 1 else (1, n_dev)
        run(make_mesh_2d(shape, device=device.type), X, y, mu_post, cov_post)

    # ---- regime 2: SGLD on minibatches of 32 of the 256 rows
    grad = minibatch_grad_cols(log_prior, log_lik, (torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)),
                               batch_size=32)
    start = torch.zeros(8, device=device)
    start[:D] = torch.from_numpy(mu_post.astype(np.float32)).to(device)
    q0 = start[:, None].repeat(1, 512)
    q, _ = sgld_sweep_cols(grad, q0, 5, n_steps=1200, eps=4e-5)
    draws = q[:D].cpu().numpy()
    err = np.abs(draws.mean(axis=1) - mu_post).max()
    print(f"minibatch SGLD: max|mean err|={err:.3f}")
    assert err < 0.06, (draws.mean(axis=1), mu_post)


if __name__ == "__main__":
    cli(main)
