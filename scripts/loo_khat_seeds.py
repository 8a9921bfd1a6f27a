"""The largest Pareto k-hat of ``examples/23_model_evaluation.py``'s linear
model over several seeds, in the reference and in the port, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/loo_khat_seeds.py [--seeds 6]

For each seed, both packages fit the cookbook's degree-1 regression with
``sample_posterior(algorithm="hmc")`` (8 chains, 200 warmup, 75 draws,
``eps0=0.1``), build the (600, 40) pointwise log-likelihood matrix and run
``psis_loo`` on it; the row shows the largest k-hat (the cookbook asserts it
is under 0.7), the adapted step size and the smallest ESS of ``w``. It
shows whether the cookbook's claim holds in law or at one seed only.
"""

import argparse
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import torch

import genjax_tpu as gj
import genjax_tpu_torch as gt
from genjax_tpu.inference import psis_loo as ref_psis_loo
from genjax_tpu.inference import sample_posterior as ref_sample_posterior
from genjax_tpu_torch.dists import mv_normal_diag
from genjax_tpu_torch.inference import psis_loo, sample_posterior

EXAMPLE = pathlib.Path(__file__).parents[1] / "examples" / "23_model_evaluation.py"


def reference_row(ex, seed):
    model, feats = ex.make_model(1)
    res = ref_sample_posterior(jr.key(seed), model, gj.C["y"].set(jnp.asarray(ex.YS)), (), gj.S["w"], n_chains=8,
                               n_warmup=200, n_samples=75, algorithm="hmc", eps0=0.1)
    ws = jnp.asarray(res.positions[("w",)]).reshape(-1, 2)
    ll = jax.scipy.stats.norm.logpdf(jnp.asarray(ex.YS)[None], ws @ feats.T, ex.SIGMA)
    return float(np.max(np.asarray(ref_psis_loo(ll).pareto_k))), float(res.eps), float(np.min(res.ess_of("w")))


def port_row(ex, seed):
    feats = torch.from_numpy(np.stack([ex.XS**p for p in range(2)], 1).astype(np.float32))
    ys = torch.from_numpy(ex.YS)

    @gt.gen
    def model():
        w = mv_normal_diag(torch.zeros(2), torch.ones(2)) @ "w"
        mv_normal_diag(feats @ w, ex.SIGMA * torch.ones(ex.N)) @ "y"

    res = sample_posterior(seed, model, gt.C["y"].set(ys), (), gt.S["w"], n_chains=8, n_warmup=200, n_samples=75,
                           algorithm="hmc", eps0=0.1, device="cpu")
    ws = res["w"].reshape(-1, 2)
    ll = torch.distributions.Normal(ws @ feats.T, ex.SIGMA).log_prob(ys[None])
    return float(torch.max(torch.as_tensor(psis_loo(ll).pareto_k))), float(res.eps), float(res.ess_of("w").min())


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=6)
    args = parser.parse_args()
    spec = importlib.util.spec_from_file_location("ex23", EXAMPLE)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    print("seed  package    max k-hat  eps      min ESS(w)")
    for seed in range(args.seeds):
        for name, row in (("reference", reference_row), ("port", port_row)):
            k, eps, ess = row(ex, seed)
            print(f"{seed:4d}  {name:9s}  {k:.4f}     {eps:.4f}   {ess:.1f}")


if __name__ == "__main__":
    main()
