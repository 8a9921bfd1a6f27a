"""Multi-slice SMC: the island particle filter on a 2-level mesh.

Counterpart of ``examples/25_island_pf.py``. The population divides into
islands; within an island every step's weight statistics and adaptive
resampling run over the fast axis; islands interact only at scheduled
exchange points, a systematic resample of whole islands by their scalar
weights. The log Z estimate is held to the exact Kalman answer, and the
per-step collective footprint is audited: the reference reads it out of
compiled HLO through ``_island_run_sharded.lower``; the port reads the
collectives the run issued (``collective_log``, ``collective_counts``,
``parallel/audit.py``; "the audit counts the collectives issued",
``ROADMAP.md``, Deviations of slice 16). Alone it makes a world of one
rank; under a launcher it runs on every rank.
"""

import numpy as np
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.parallel import IslandParticleFilter, collective_counts, collective_log, make_hier_mesh

from ._common import cli, device_of, world_of_one


@g.gen
def ssm_kernel(c, x):
    z = g.normal(c, 1.0) @ "z"
    y = g.normal(z, 0.5) @ "y"
    return (z, y)


def exact_lgss_logZ(ys, trans_sd=1.0, obs_sd=0.5):
    q, r = trans_sd**2, obs_sd**2
    mean, var = 0.0, q
    logZ = 0.0
    for y in ys:
        s = var + r
        logZ += -0.5 * (np.log(2 * np.pi * s) + (y - mean) ** 2 / s)
        kgain = var / s
        mean = mean + kgain * (y - mean)
        var = var * (1 - kgain) + q
    return float(logZ)


def run(device):
    n_dev = torch.distributed.get_world_size()
    n_islands = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = make_hier_mesh(n_islands, n_dev // n_islands, device=device.type)
    print(f"hierarchical mesh: {dict(mesh.shape)}")

    T = 16
    ys = (torch.randn(T, generator=torch.Generator().manual_seed(3)) * 0.8).numpy().astype(np.float32)
    obs = g.C[:, "y"].set(torch.from_numpy(ys).to(mesh.device))
    exact = exact_lgss_logZ(ys)

    ipf = IslandParticleFilter(ssm_kernel, n_particles=4096, exchange_every=4)
    with collective_log() as log:
        res = ipf.run_sharded(0, 0.0, torch.zeros(T, device=mesh.device), obs, mesh)
    print(f"island PF logZ = {float(res.log_marginal):.3f} (Kalman exact {exact:.3f}), "
          f"{int(res.n_exchanges)} island exchanges over {T} steps")
    assert abs(float(res.log_marginal) - exact) < 0.15
    assert int(res.n_exchanges) == T // 4

    # ---- the communication receipt, from the collectives issued
    audit = collective_counts(log)
    hot = [o for o in audit["ops"] if o["per_step"] and o["kind"] == "all-reduce"]
    n_shards = mesh.shape["batch"]
    print(f"per-step all-reduces: {len(hot)}, max replica-group span "
          f"{max((o['group_span'] or 0) for o in hot)} (within-island axis = {n_shards} devices), "
          f"payload {sum(o['bytes'] for o in hot)} bytes")
    for o in hot:
        assert o["group_span"] is None or o["group_span"] <= max(n_shards, n_islands), o
    return audit


def main(device="cuda"):
    device = device_of(device)
    with world_of_one(device):
        return run(device)


if __name__ == "__main__":
    cli(main)
