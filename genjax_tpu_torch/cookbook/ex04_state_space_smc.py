"""State-space particle filtering: on one device and sharded.

Counterpart of ``examples/04_state_space_smc.py``. The sharded run builds a
mesh over the process group's ranks: a world of one rank made here when the
script runs alone (``torchrun`` or ``initialize_distributed`` give more).
"""

import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.parallel import SSMParticleFilter, make_mesh

from ._common import cli, device_of, world_of_one


@g.gen
def kernel(carry, x):
    """Latent random walk with noisy observations."""
    z = g.normal(carry, 1.0) @ "z"
    y = g.normal(z, 0.5) @ "y"
    return (z, y)


def main(device="cuda"):
    device = device_of(device)
    gen = torch.Generator(device=device).manual_seed(0)
    T = 50
    # synthesize observations from the scanned model itself
    ssm = kernel.scan()
    true_tr = ssm.simulate(gen, (0.0, torch.zeros(T, device=device)))
    ys = torch.stack([true_tr.get_choices()[t, "y"] for t in range(T)])

    obs = g.C[:, "y"].set(ys)
    pf = SSMParticleFilter(kernel, n_particles=4096, ess_threshold=0.5)

    # one device
    res = pf.run(0, 0.0, torch.zeros(T, device=device), obs, device=device)
    print(f"logZ estimate: {float(res.log_marginal):.2f}")
    print(f"final-step ESS: {float(res.ess_history[-1]):.0f} / 4096")

    # sharded over every rank of the process group
    with world_of_one(device):
        mesh = make_mesh(device=device.type)
        res_sharded = pf.run_sharded(0, 0.0, torch.zeros(T, device=device), obs, mesh)
        print(f"sharded logZ estimate: {float(res_sharded.log_marginal):.2f} ({mesh.world_size} rank(s))")


if __name__ == "__main__":
    cli(main)
