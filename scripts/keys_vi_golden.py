"""Print ``chip_smoke.py``'s ``KV_GOLDEN``: what ``genjax_tpu`` draws on the
CPU for the ``[keys vi]`` phase's cut-size calls, from the same keys and
data (``chip_smoke.kv_calls``, the one definition of those calls, run here
through the reference under ``jax.random.key(seed)``, with ``jnp.asarray``
and ``jax.random.normal`` as its array maker and normal draws).

    JAX_PLATFORMS=cpu python scripts/keys_vi_golden.py

Each entry is a list of floats: F9's three cases (``posterior_predictive``'s
draws, ``involutive_mh``'s new ``sigma`` and log-acceptance,
``enumerative_gibbs``'s indices under six keys); the two ADEV programs'
gradients; ``bench_vi``'s ELBO gradient at ``KV_PHI``; ``IWELBO``'s,
``PWake``'s and ``QWake``'s gradients; ``fit``'s parameters; ADVI's mean and
final ELBO; ``fit_map``'s mode and log joint; the Laplace mean, covariance
and log marginal; two of Pathfinder's draws and its ELBO.
"""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import genjax_tpu as gj  # noqa: E402
import genjax_tpu.adev  # noqa: E402,F401
import genjax_tpu.inference  # noqa: E402,F401
import genjax_tpu.inference.vi  # noqa: E402,F401


def main():
    print(json.dumps(cs.kv_calls(gj, jax.random.key, jnp.asarray, jax.random.normal), indent=1))


if __name__ == "__main__":
    main()
