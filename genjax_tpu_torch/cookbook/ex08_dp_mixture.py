"""Dirichlet-process mixture (truncated stick-breaking) with SMC and MH
rejuvenation.

Counterpart of ``examples/08_dp_mixture.py``. Model: weights ~
stick-breaking(alpha) truncated at K; cluster means ~ N(0, 3); assignments ~
categorical(weights); observations ~ N(mean_z, 0.5). The reference scans a
jitted sweep over split keys; here the sweep is a Python loop drawing from
one generator.
"""

import numpy as np
import torch

import genjax_tpu_torch as g

from ._common import cli, device_of

K = 8  # truncation level
SIGMA_OBS = 0.5
N_DATA = 60


@g.gen
def obs_point(i, weights, means):
    z = g.categorical(torch.log(weights + 1e-37)) @ "z"
    x = g.normal(means[z], SIGMA_OBS) @ "x"
    return x


@g.gen
def dp_mixture(data):
    # stick-breaking weights (explicit loop: addresses "beta_i")
    sticks = []
    rest = 1.0
    for i in range(K - 1):
        b = g.beta(1.0, 2.0) @ f"beta_{i}"
        sticks.append(rest * b)
        rest = rest * (1.0 - b)
    weights = torch.stack([*sticks, rest])

    means = g.mv_normal_diag(torch.zeros(K, device=data.device), 3.0 * torch.ones(K, device=data.device)) @ "means"
    _ = obs_point.vmap(in_axes=(0, None, None))(torch.arange(data.shape[0], device=data.device), weights,
                                                  means) @ "obs"
    return weights


def make_data(gen):
    """Three well-separated clusters."""
    centers = torch.tensor([-4.0, 0.0, 4.0], device=gen.device)
    comps = torch.randint(0, 3, (N_DATA,), generator=gen, device=gen.device)
    return centers[comps] + 0.4 * torch.randn(N_DATA, generator=gen, device=gen.device)


def _plain(v):
    return v.unmask() if isinstance(v, g.Mask) else v


def main(device="cuda"):
    device = device_of(device)
    gen = torch.Generator(device=device).manual_seed(0)
    data = make_data(gen)
    constraint = g.C["obs", :, "x"].set(data)
    target = g.Target(dp_mixture, (data,), constraint)

    # SMC initialization: K-particle importance sampling
    alg = g.ImportanceK(target, k_particles=512)
    collection = alg.run_smc(gen, device=device)
    print(f"SMC logZ estimate: {float(collection.get_log_marginal_likelihood_estimate()):.1f}")
    print(f"ESS: {float(collection.effective_sample_size()):.0f} / 512")

    # Gibbs-style rejuvenation (programmable inference): per-point
    # assignment moves, HMC on the cluster means, stick updates
    tr = collection.sample_particle(gen)

    def sweep(tr):
        for i in range(N_DATA):
            tr, _ = g.mh(gen, tr, g.S["obs", i, "z"])
        tr, _ = g.mh(gen, tr, g.HMC(g.S["means"], 0.05, L=5))
        for i in range(K - 1):
            tr, _ = g.mh(gen, tr, g.S[f"beta_{i}"])
        return tr

    for _ in range(150):
        tr = sweep(tr)
    means = _plain(tr.get_choices()["means"])

    # report clusters that carry data mass
    zs = torch.stack([_plain(tr.get_choices()["obs", i, "z"]) for i in range(N_DATA)])
    used, counts = np.unique(zs.cpu().numpy(), return_counts=True)
    print("occupied clusters (mean, count):")
    for c, n in zip(used, counts):
        print(f"  mean {float(means[c]):+.2f}  n={n}")
    print("(true cluster centers: -4, 0, +4)")


if __name__ == "__main__":
    cli(main)
