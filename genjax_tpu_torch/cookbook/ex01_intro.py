"""Intro: the README beta-bernoulli model and sampling-importance-resampling.

Counterpart of ``examples/01_intro.py``. The reference vmaps and jits over
split keys; here one ``torch.Generator`` on the device feeds a vmapped
batch (the deviation "a ``torch.Generator``, drawn from in sequence, where
the reference splits a key", ``ROADMAP.md``, Deviations of the trace path).
"""

import torch

import genjax_tpu_torch as g

from ._common import batch, cli, device_of


@g.gen
def beta_bernoulli(alpha, beta):
    """p ~ Beta(alpha, beta); v ~ Bernoulli(p)."""
    p = g.beta(alpha, beta) @ "p"
    v = g.flip(p) @ "v"
    return v


def sampling_importance_resampling(gen, n_trials, k_particles=50):
    """Infer p given v=True by SIR: ``n_trials`` independent runs of
    ``k_particles`` importance samples and one resampled particle each."""
    obs = g.C["v"].set(True)
    trs, ws = batch(lambda: beta_bernoulli.importance(gen, obs, (2.0, 2.0)), n_trials * k_particles, gen.device)
    ps = trs.get_choices()["p"].reshape(n_trials, k_particles)
    idx = torch.multinomial(torch.softmax(ws.reshape(n_trials, k_particles), dim=1), 1, generator=gen)
    return torch.gather(ps, 1, idx)[:, 0]


def main(device="cuda"):
    device = device_of(device)
    gen = torch.Generator(device=device).manual_seed(314159)

    # simulate: sample a full trace
    tr = beta_bernoulli.simulate(gen, (2.0, 2.0))
    print("p =", float(tr.get_choices()["p"]), " v =", bool(tr.get_choices()["v"]))
    print("log density =", float(tr.get_score()))

    # 50 SIR trials in one vmapped batch (the reference README demo)
    posterior_samples = sampling_importance_resampling(gen, 50)
    print("posterior mean of p | v=True:", float(torch.mean(posterior_samples)))
    print("(exact: 3/5 = 0.6)")


if __name__ == "__main__":
    cli(main)
