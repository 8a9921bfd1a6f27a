"""The production sampling workflow in one call.

Counterpart of ``examples/10_sample_posterior.py``: ``sample_posterior``
ties prior initialization, step-size and diagonal-mass adaptation, thinned
sampling and split-R-hat/ESS diagnostics together, its chain axis sharded
over a mesh (a world of one rank made here when the script runs alone),
checked against the exact posterior of a Bayesian linear regression.
"""

import numpy as np
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import sample_posterior
from genjax_tpu_torch.models import linear_regression
from genjax_tpu_torch.parallel import gather_batch, make_mesh

from ._common import cli, device_of, world_of_one


def main(device="cuda"):
    device = device_of(device)
    # Bayesian linear regression with a conjugate (exactly known) posterior
    N, D = 24, 3
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, D)).astype(np.float32)
    w_true = np.asarray([1.0, -2.0, 0.5], np.float32)
    y = (X @ w_true + 0.25 * rng.normal(size=N)).astype(np.float32)

    model, exact_posterior = linear_regression(X)
    post_mean, post_cov = (torch.as_tensor(v, dtype=torch.float32).cpu() for v in exact_posterior(torch.from_numpy(y)))

    with world_of_one(device):
        mesh = make_mesh(device=device.type)  # shard the chain axis over every rank
        res = sample_posterior(0, model, g.C["y"].set(torch.from_numpy(y).to(device)), (), g.S["w"], n_chains=512,
                               n_warmup=120, n_samples=80, algorithm="nuts", eps0=0.02, max_depth=6, mesh=mesh,
                               device=device)
        draws = gather_batch(res["w"], mesh)[:, -40:].cpu()  # (chains, draws, D) post-burn-in
    flat = draws.reshape(-1, D)
    assert torch.allclose(torch.mean(flat, dim=0), post_mean, atol=0.05), (torch.mean(flat, dim=0), post_mean)
    assert torch.allclose(torch.std(flat, dim=0), torch.sqrt(torch.diag(post_cov)), rtol=0.25)
    # convergence diagnostics come with the result
    assert torch.all(res.rhat_of("w") < 1.15)
    assert torch.all(res.ess_of("w") > 200.0)
    # adaptation moved the (deliberately tiny) initial step size
    assert float(res.eps) > 0.05
    print(f"posterior mean {np.round(torch.mean(flat, dim=0).numpy(), 3)} "
          f"(exact {np.round(post_mean.numpy(), 3)}), eps* {float(res.eps):.3f}, "
          f"min ESS {float(torch.min(res.ess_of('w'))):.0f}")
    print("sample_posterior cookbook: OK")


if __name__ == "__main__":
    cli(main)
