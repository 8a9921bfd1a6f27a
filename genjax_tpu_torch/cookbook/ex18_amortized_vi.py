"""Amortized variational inference: a neural network as the guide.

Counterpart of ``examples/18_amortized_vi.py``. The guide's parameters are
a pytree riding through ``Target.args``, so a network slots straight into
the ADEV variational stack: the reparameterized sample differentiates
through the network, and one Adam loop trains an amortized posterior, a
single network from any observation to its approximate posterior.

The reference's network is a flax module and its loop a jitted
``lax.scan`` of optax Adam under a cosine decay. Here the network is a
one-hidden-layer tanh MLP written in torch (16 units, as the reference's),
and the loop a plain Python step loop over the port's Adam
(``inference/_adam.py``, ``ROADMAP.md``, Deviations of the catalog and
ADEV), each step one vmapped batch of the 18 ELBO gradient estimates the
reference averages (two for each of the nine training points).

The model is conjugate (mu ~ N(0,1), x ~ N(mu, 0.5)), so the exact
posterior is N(0.8 x, 0.2): the network must recover the linear map 0.8 x
and the constant scale sqrt(0.2), on a held-out x* too.
"""

import math

import numpy as np
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import Target, vi
from genjax_tpu_torch.inference._adam import adam_init, adam_update
from genjax_tpu_torch.inference.sp import Marginal

from ._common import cli, device_of

HIDDEN = 16


def init_net(gen):
    """Dense(16) -> tanh -> Dense(2): LeCun-normal weights, zero biases."""
    dev = gen.device
    return {
        "w1": torch.randn((HIDDEN, 1), generator=gen, device=dev),
        "b1": torch.zeros(HIDDEN, device=dev),
        "w2": torch.randn((2, HIDDEN), generator=gen, device=dev) / math.sqrt(HIDDEN),
        "b2": torch.zeros(2, device=dev),
    }


def apply_net(phi, x):
    h = torch.tanh(phi["w1"][:, 0] * x + phi["b1"])
    out = phi["w2"] @ h + phi["b2"]
    return out[0], torch.exp(out[1])  # loc, scale


def cosine_decay(init_value, decay_steps):
    """``optax.cosine_decay_schedule(init_value, decay_steps)``."""

    def schedule(step):
        return init_value * 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps) / decay_steps))

    return schedule


@g.gen
def model(phi, x_i):  # phi and x_i ride through Target.args for the guide
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 0.5) @ "x"


@g.gen
def guide_fn(target):
    phi, x_i = target.args
    loc, scale = apply_net(phi, x_i)
    _ = vi.normal_reparam(loc, scale) @ "mu"


def main(device="cuda"):
    device = device_of(device)
    guide = Marginal(guide_fn, g.Pytree.const(g.Selection.all()), g.Pytree.const(None))
    grad_fn = vi.ELBO(guide, lambda phi, x_i: Target(model, (phi, x_i), g.C["x"].set(x_i)))

    xs_train = torch.linspace(-2.0, 2.0, 9, device=device)
    lanes = xs_train.repeat_interleave(2)  # two estimates a training point
    gen = torch.Generator(device=device).manual_seed(0)
    phi = init_net(gen)
    gen = torch.Generator(device=device).manual_seed(1)
    opt_state = adam_init(phi)
    schedule = cosine_decay(0.03, 1000)
    grads_of = torch.func.vmap(lambda p, x: grad_fn(gen, (p, x))[0], in_dims=(None, 0), randomness="different")
    for _ in range(1000):
        grads = grads_of(phi, lanes)
        mean_grad = {k: v.mean(dim=0) for k, v in grads.items()}
        phi, opt_state = adam_update(mean_grad, opt_state, phi, schedule)

    # Exact posterior: N(0.8 x, 0.2). Check train AND held-out points.
    for x_star in [-1.5, 0.3, 1.7, 0.95]:  # 0.95 never seen in training
        loc, scale = apply_net(phi, torch.tensor(x_star, device=device))
        assert abs(float(loc) - 0.8 * x_star) < 0.08, (x_star, float(loc))
        assert abs(float(scale) - np.sqrt(0.2)) < 0.08, (x_star, float(scale))
    print("amortized guide recovers the exact posterior map: "
          f"loc(0.95) = {float(apply_net(phi, torch.tensor(0.95, device=device))[0]):.3f} (exact {0.8 * 0.95:.3f})")


if __name__ == "__main__":
    cli(main)
