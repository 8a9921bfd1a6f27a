"""Split-R-hat of the flagship through ``sample_posterior(algorithm="hmc_sweep")``
in the JAX reference and in the PyTorch port, on the CPU, over several seeds.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/flagship_rhat.py \
        [--chains 2048] [--seeds 0 1 2] [--thin 1 10]

Both run the hierarchical regression of ``bench.py::_regression_setup``
over ``S["w"] | S["tau"]`` with ``n_warmup=300``, ``n_samples=100``,
``eps0=0.02`` and ``L=5`` (the reference on its XLA twin, the port on its
plain torch twin), one call a package, seed and thinning (the reference's
key is ``jax.random.key(seed)``, the port's generator is seeded with
``seed``), and print the adapted step size, the adapted inverse mass of
``tau``, the accept rate, and the split-R-hat of ``tau`` and of each
``w_j``. It shows whether a split-R-hat far from 1 is the
configuration's (both packages, every seed) or the port's.
"""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import genjax_tpu as gj
import genjax_tpu_torch as gt
from genjax_tpu.inference.sample import sample_posterior as sample_reference
from genjax_tpu.models import hierarchical_regression as hier_reference
from genjax_tpu_torch.inference.sample import sample_posterior as sample_port
from genjax_tpu_torch.models import hierarchical_regression as hier_port


def _line(name, seed, thin, n_chains, res, secs):
    rhat = np.concatenate([np.reshape(np.asarray(res.rhat_of("tau")), 1), np.asarray(res.rhat_of("w"))])
    inv_mass = np.asarray(res.inv_mass, np.float64).reshape(-1)
    print(f"{name} seed={seed} thin={thin} ({n_chains} chains, {secs:.1f} s): eps {float(res.eps):.6g}, "
          f"inv_mass[tau] {inv_mass[0]:.4g}, accept {float(res.accept_rate):.4f}, split-R-hat tau "
          f"{rhat[0]:.4f}, w {rhat[1:].min():.4f}-{rhat[1:].max():.4f}", flush=True)


def main(n_chains: int, seeds: list[int], thins: list[int]) -> None:
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    kw = dict(n_chains=n_chains, n_warmup=300, n_samples=100, algorithm="hmc_sweep", eps0=0.02, L=5)
    for seed in seeds:
        for thin in thins:
            t0 = time.perf_counter()
            ref = sample_reference(jax.random.key(seed), hier_reference(X), gj.C["y"].set(jnp.asarray(y)), (),
                                   gj.S["w"] | gj.S["tau"], thin=thin, **kw)
            _line("reference", seed, thin, n_chains, ref, time.perf_counter() - t0)
            t0 = time.perf_counter()
            port = sample_port(seed, hier_port(X), gt.C["y"].set(torch.as_tensor(y)), (),
                               gt.S["w"] | gt.S["tau"], thin=thin, device="cpu", **kw)
            _line("port", seed, thin, n_chains, port, time.perf_counter() - t0)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chains", type=int, default=2048)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--thin", type=int, nargs="+", default=[1, 10])
    a = parser.parse_args()
    main(a.chains, a.seeds, a.thin)
