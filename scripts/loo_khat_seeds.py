"""The largest Pareto k-hat of the model-evaluation cookbook's linear model
over several seeds and draw counts, in the reference and in the port.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/loo_khat_seeds.py [--seeds 6] [--draws 600 1200 ...]
    PYTHONPATH=. python scripts/loo_khat_seeds.py --port-only --device cuda --draws 3200 4000

For each draw count and seed, each package fits the cookbook's degree-1
regression with ``sample_posterior(algorithm="hmc")`` (8 chains, 200
warmup, ``draws / 8`` draws a chain, ``eps0=0.1``; the reference's
``examples/23_model_evaluation.py`` takes 600 draws), builds the (draws, 40)
pointwise log-likelihood matrix and runs ``psis_loo`` on it; the row shows
the largest k-hat (the cookbook asserts it is under 0.7), the adapted step
size and the smallest ESS of ``w``. The port's row is the cookbook's own
computation (``genjax_tpu_torch/cookbook/ex23_model_evaluation.py``,
``pointwise_loglik`` at the seed), on ``--device``; ``--port-only`` leaves
the reference out and imports no JAX, so it runs on a machine with a CUDA
card and no JAX. The last line of each count says whether the claim holds
at every seed.
"""

import argparse
import importlib.util
import pathlib

import numpy as np
import torch

EXAMPLE = pathlib.Path(__file__).parents[1] / "examples" / "23_model_evaluation.py"


def reference_row(seed, draws):
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    import genjax_tpu as gj
    from genjax_tpu.inference import psis_loo, sample_posterior

    spec = importlib.util.spec_from_file_location("ex23", EXAMPLE)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    model, feats = ex.make_model(1)
    res = sample_posterior(jr.key(seed), model, gj.C["y"].set(jnp.asarray(ex.YS)), (), gj.S["w"], n_chains=8,
                           n_warmup=200, n_samples=draws // 8, algorithm="hmc", eps0=0.1)
    ws = jnp.asarray(res.positions[("w",)]).reshape(-1, 2)
    ll = jax.scipy.stats.norm.logpdf(jnp.asarray(ex.YS)[None], ws @ feats.T, ex.SIGMA)
    return float(np.max(np.asarray(psis_loo(ll).pareto_k))), float(res.eps), float(np.min(res.ess_of("w")))


def port_row(seed, draws, device):
    from genjax_tpu_torch.cookbook import ex23_model_evaluation as ex
    from genjax_tpu_torch.inference import psis_loo

    model, feats = ex.make_model(1, device)
    ll, res = ex.pointwise_loglik(model, feats, device, n_draws=draws, seed=seed)
    k = float(torch.as_tensor(psis_loo(ll).pareto_k).max())
    return k, float(res.eps), float(res.ess_of("w").min())


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=6)
    parser.add_argument("--draws", type=int, nargs="+", default=[600], help="total draws (8 chains)")
    parser.add_argument("--device", default="cpu", choices=("cpu", "cuda"), help="the port's device")
    parser.add_argument("--port-only", action="store_true", help="leave the reference (and JAX) out")
    args = parser.parse_args()
    device = torch.device(args.device)
    rows = [] if args.port_only else [("reference", reference_row)]
    rows.append((f"port-{args.device}", lambda seed, draws: port_row(seed, draws, device)))
    print("draws  seed  package      max k-hat  eps      min ESS(w)")
    for draws in args.draws:
        worst = {}
        for seed in range(args.seeds):
            for name, row in rows:
                k, eps, ess = row(seed, draws)
                worst[name] = max(worst.get(name, 0.0), k)
                print(f"{draws:5d}  {seed:4d}  {name:11s}  {k:.4f}     {eps:.4f}   {ess:.1f}", flush=True)
        holds = all(k < 0.7 for k in worst.values())
        print(f"{draws:5d}  largest k-hat: " + ", ".join(f"{n} {k:.4f}" for n, k in worst.items())
              + f"; k_max < 0.7 at every seed: {holds}", flush=True)


if __name__ == "__main__":
    main()
