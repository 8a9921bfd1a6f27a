"""Variational inference with ADEV gradient estimators.

Counterpart of ``examples/06_vi.py``: an ELBO-trained reparameterized guide
recovers the exact conjugate posterior, mean and scale; then a raw ADEV
expectation against its closed-form gradient. The reference jits a batched
gradient step; here the step is a plain Python loop over a vmapped batch
(the ``inference/_adam.py`` deviation: no compiled step, ``ROADMAP.md``,
Deviations of the catalog and ADEV).
"""

import math

import torch
import torch.nn.functional as F

import genjax_tpu_torch as g
from genjax_tpu_torch.adev import expectation, normal_reparam
from genjax_tpu_torch.inference import Target, vi
from genjax_tpu_torch.inference.sp import Marginal

from ._common import cli, device_of


@g.gen
def model(phi):
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


@g.gen
def guide_fn(target):
    phi = target.args[0]
    _ = vi.normal_reparam(phi[0], F.softplus(phi[1])) @ "mu"


def main(device="cuda"):
    device = device_of(device)
    gen = torch.Generator(device=device).manual_seed(1)
    guide = Marginal(guide_fn, g.Pytree.const(g.Selection.all()), g.Pytree.const(None))
    elbo_grad = vi.ELBO(guide, lambda phi: Target(model, (phi,), g.C["y"].set(2.0)))

    # batched gradient estimates, SGD
    def step(phi):
        grads = torch.func.vmap(lambda _, p: elbo_grad(gen, (p,))[0], in_dims=(0, None),
                                randomness="different")(torch.zeros(32, device=device), phi)
        return torch.mean(grads, dim=0)

    phi = torch.zeros(2, device=device)
    for _ in range(300):
        phi = phi - 0.05 * step(phi)

    print(f"guide mean  {float(phi[0]):.3f}   (exact posterior mean  1.000)")
    print(f"guide scale {float(F.softplus(phi[1])):.3f}   (exact posterior scale {1 / math.sqrt(2):.3f})")

    # a raw ADEV expectation, for comparison with a closed form
    @expectation
    def loss(mu):
        x = normal_reparam(mu, 1.0)
        return (x - 2.0) ** 2

    grads = torch.func.vmap(lambda _: loss.grad_estimate(gen, (0.5,))[0], randomness="different")(
        torch.zeros(2000, device=device))
    print(f"ADEV dE[(x-2)^2]/dmu at mu=0.5: {float(torch.mean(grads)):.3f} (exact -3.0)")


if __name__ == "__main__":
    cli(main)
