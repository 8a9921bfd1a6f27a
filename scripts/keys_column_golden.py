"""Print ``chip_smoke.py``'s ``KC_GOLDEN``: what ``genjax_tpu`` draws on the
CPU for the ``[keys column]`` phase's cut-size calls, from the same seeds
and keys (the flagship, ``chip_smoke.flagship_data``, at ``KC_CHAINS``
chains).

    JAX_PLATFORMS=cpu python scripts/keys_column_golden.py

Each entry holds the chains' mean of the packed real rows (``tau``, then
``w``) or of the draws, the accept rate, and where there is one the adapted
``eps``; the column entry points also the first ``KC_FIRST`` chains' ``tau``.
"""

import json
import pathlib
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import genjax_tpu as gj  # noqa: E402
from genjax_tpu.inference import sample_posterior  # noqa: E402
from genjax_tpu.kernels import column_hmc, column_nuts  # noqa: E402
from genjax_tpu.models import hierarchical_regression  # noqa: E402


def main():
    X, y = cs.flagship_data()
    model, obs = hierarchical_regression(X), gj.C["y"].set(y)
    out = {}
    q, acc, _p = column_hmc(model, obs, (), ["tau", "w"], backend="xla", seed=cs.SEED, **cs.KC_HMC)
    q = np.asarray(q)
    out["column_hmc"] = {"mean": q[:9].mean(1).tolist(), "acc": float(acc), "tau": q[0, : cs.KC_FIRST].tolist()}
    q, acc, leaps, _p = column_nuts(model, obs, (), ["tau", "w"], seed=cs.SEED, **cs.KC_NUTS)
    q = np.asarray(q)
    out["column_nuts"] = {"mean": q[:9].mean(1).tolist(), "acc": float(acc), "leaps": float(leaps),
                          "tau": q[0, : cs.KC_FIRST].tolist()}
    for algorithm, kw in cs.KC_SP.items():
        res = sample_posterior(jax.random.key(0), model, obs, (), gj.S["w"] | gj.S["tau"], algorithm=algorithm,
                               **kw)
        d = np.concatenate([np.asarray(res["tau"])[:, :, None], np.asarray(res["w"])], axis=2)
        out[f"sp_{algorithm}"] = {"mean": d.mean((0, 1)).tolist(), "acc": float(res.accept_rate),
                                  "eps": float(np.asarray(res.eps).reshape(-1)[0])}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
