"""Print ``chip_smoke.py``'s ``KS_GOLDEN``: what ``genjax_tpu`` draws on the
CPU for the ``[keys smc]`` phase's cut-size calls, from the same keys and
data (``chip_smoke.ks_calls``, the one definition of those calls, run here
through the reference under ``jax.random.key(seed)``, with ``jnp.asarray``
and ``jax.random.normal`` as its array maker and normal draws).

    JAX_PLATFORMS=cpu python scripts/keys_smc_golden.py

Each entry is a list of floats: the particle filter's log marginal, final
mean and ESS history; ``ImportanceK``'s ``random_weighted`` (weight and
``mu``) and ``estimate_logpdf``; the tempered DP mixture's log marginal and
ESS history; particle Gibbs's log marginals and last trajectory's mean;
SMC²'s log evidence, mean parameter and acceptance; ABC-SMC's tolerances
and mean parameter; ChEES tempered SMC's log marginal, rungs and means; the
nested sampler's log evidence of each run.
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
import genjax_tpu.inference  # noqa: E402,F401
import genjax_tpu.models  # noqa: E402,F401
import genjax_tpu.parallel  # noqa: E402,F401


def main():
    print(json.dumps(cs.ks_calls(gj, jax.random.key, jnp.asarray, jax.random.normal), indent=1))


if __name__ == "__main__":
    main()
