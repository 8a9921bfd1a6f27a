"""The multi-chip story: one mesh, sharded particles and chains.

Counterpart of ``examples/14_multichip.py``. The port runs one process a
rank on a ``torch.distributed`` group; a sharded batch is each rank's own
slice on its device, where the reference holds one global array ("a
sharded batch is each rank's local slice", ``ROADMAP.md``, Deviations of
slice 16). So where the reference asserts that an array's sharding spans
every device, this narrative asserts that each rank holds its share on its
own device and that the shares gather to the whole. Alone it makes a world
of one rank; under ``torchrun`` (or ``initialize_distributed``) it runs on
every rank of the world.
"""

import torch
import torch.utils._pytree as pytree

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import sample_posterior
from genjax_tpu_torch.parallel import (
    SSMParticleFilter,
    gather_batch,
    make_mesh,
    run_chains_sharded,
    shard_batch,
)

from ._common import batch, cli, device_of, world_of_one


@g.gen
def ssm_kernel(c, x):
    z = g.normal(c, 1.0) @ "z"
    y = g.normal(z, 0.5) @ "y"
    return (z, y)


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


def _on_rank(x, n_local, mesh):
    return x.shape[0] == n_local and x.device.type == mesh.device.type


def run(mesh):
    device = mesh.device
    n_dev = mesh.world_size
    print(f"mesh over {n_dev} rank(s): {mesh}")

    # --- sharded particle filter: the collectives of every step
    T = 12
    ys = torch.sin(torch.linspace(0, 2, T, device=device))
    pf = SSMParticleFilter(ssm_kernel, n_particles=1024 * n_dev)
    for mode in ("local", "all_gather"):
        res = pf.run_sharded(0, 0.0, torch.zeros(T, device=device), g.C[:, "y"].set(ys), mesh, resample_mode=mode)
        assert torch.isfinite(res.log_marginal)
        # the particle axis really is sharded: each rank holds its share
        assert _on_rank(res.carries, 1024, mesh)
        assert gather_batch(res.carries, mesh).shape[0] == 1024 * n_dev
        print(f"  PF [{mode:10s}] logZ = {float(res.log_marginal):.3f}")

    # --- a sharded chain batch: each rank runs its chains
    obs = g.C["y"].set(2.0)
    res = run_chains_sharded(1, lambda gg: conjugate.generate(gg, obs, ())[0], g.HMC(g.S["mu"], 0.3, L=10),
                             n_steps=50, n_chains=128 * n_dev, mesh=mesh, record=lambda t: t.get_choices()["mu"])
    finals = gather_batch(res.history[:, -1], mesh)
    assert abs(float(torch.mean(finals)) - 1.0) < 0.15
    print(f"  chains: posterior mean {float(torch.mean(finals)):.3f} (exact 1.0)")

    # --- the one-call driver shards the same way
    post = sample_posterior(2, conjugate, obs, (), g.S["mu"], n_chains=128 * n_dev, n_warmup=40, n_samples=30,
                            algorithm="hmc", eps0=0.1, L=5, mesh=mesh, device=device)
    assert abs(float(torch.mean(gather_batch(post["mu"], mesh)[:, -10:])) - 1.0) < 0.15

    # --- shard any framework pytree with one call
    gen = torch.Generator(device=device).manual_seed(3)
    whole = batch(lambda: conjugate.simulate(gen, ()), 64 * n_dev, device)
    placed = shard_batch(whole, mesh)
    leaf = pytree.tree_leaves(placed)[0]
    assert _on_rank(leaf, 64, mesh)

    print("multi-chip cookbook: all sections OK")


def main(device="cuda"):
    device = device_of(device)
    with world_of_one(device):
        run(make_mesh(device=device.type))


if __name__ == "__main__":
    cli(main)
