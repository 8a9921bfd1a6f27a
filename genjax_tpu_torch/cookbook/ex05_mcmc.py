"""MCMC: regenerate-MH, custom-proposal rejuvenation, and HMC at scale.

Counterpart of ``examples/05_mcmc.py``: the chain drivers (``run_chain``,
``run_chains_sharded``), dual-averaging step-size adaptation, the batched
trace drivers and column NUTS. The model has no device body
(``kernels/bodies.py``), so on the card the batched drivers and column NUTS
run their torch twins, asked for with ``backend="torch"`` (nothing falls
back on its own: ``ROADMAP.md``, Ground rules, "Entry points run on the
card by default").
"""

import math

import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.kernels import column_nuts
from genjax_tpu_torch.parallel import make_mesh, run_chains_sharded, warmup_adapt_step_size

from ._common import batch, cli, device_of, world_of_one


@g.gen
def model():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


def main(device="cuda"):
    device = device_of(device)
    gen = torch.Generator(device=device).manual_seed(0)
    obs = g.C["y"].set(2.0)
    # exact posterior: mu | y=2 ~ N(1, 1/sqrt(2))

    def make_trace(gg):
        tr, _ = model.generate(gg, obs, ())
        return tr

    # --- one chain, regenerate-MH ---
    tr = make_trace(gen)
    res = g.run_chain(gen, tr, g.S["mu"], 2000, record=lambda t: t.get_choices()["mu"])
    print(f"MH: mean {float(torch.mean(res.history[200:])):.3f} (exact 1.0), accept {float(res.accept_rate):.2f}")

    # --- custom random-walk proposal via Rejuvenate ---
    @g.gen
    def rw(chm):
        old = chm["mu"]
        old = old.unmask() if isinstance(old, g.Mask) else old
        _ = g.normal(old, 0.5) @ "mu"

    req = g.Rejuvenate(rw, lambda chm: (chm,))
    res = g.run_chain(gen, tr, req, 2000, record=lambda t: t.get_choices()["mu"])
    print(f"RW-MH: mean {float(torch.mean(res.history[200:])):.3f}, accept {float(res.accept_rate):.2f}")

    # --- adapted HMC over a sharded batch of chains ---
    traces = batch(lambda: make_trace(gen), 512, device)
    traces, eps = warmup_adapt_step_size(gen, traces, lambda e: g.HMC(g.S["mu"], e, L=5), n_warmup=100, eps0=1.0)
    print(f"adapted step size: {float(eps):.3f}")

    with world_of_one(device):
        mesh = make_mesh(device=device.type)
        out = run_chains_sharded(gen, make_trace, g.HMC(g.S["mu"], eps, L=5), n_steps=100, n_chains=2048,
                                 mesh=mesh, record=lambda t: t.get_choices()["mu"])
    finals = out.history[:, -1]
    print(f"HMC x2048 chains: mean {float(torch.mean(finals)):.3f} (exact 1.0), "
          f"std {float(torch.std(finals)):.3f} (exact {1 / math.sqrt(2):.3f})")

    # --- the batched trace drivers: the GFI throughput path, one column
    # sweep with one trace write-back ---
    gen7 = torch.Generator(device=device).manual_seed(7)
    traces = batch(lambda: make_trace(gen7), 2048, device)
    gen8 = torch.Generator(device=device).manual_seed(8)
    traces, acc = g.run_chains_hmc(gen8, traces, g.S["mu"], eps=float(eps), L=5, n_steps=200, backend="torch")
    mus = traces.get_choices()["mu"]
    print(f"run_chains_hmc x2048: mean {float(torch.mean(mus)):.3f} (exact 1.0), accept {float(acc):.2f}")
    gen9 = torch.Generator(device=device).manual_seed(9)
    traces, acc, leaps = g.run_chains_nuts(gen9, traces, g.S["mu"], eps=0.5, n_steps=100, backend="torch")
    mus = traces.get_choices()["mu"]
    print(f"run_chains_nuts x2048: mean {float(torch.mean(mus)):.3f}, ~{float(leaps):.1f} leapfrogs/transition")

    # --- NUTS on the column layout ---
    q, acc, leaps, packer = column_nuts(model, obs, (), ["mu"], n_chains=1024, n_steps=60, eps=0.3, max_depth=6,
                                        device=device, backend="torch")
    print(f"column NUTS: mean {float(torch.mean(q[0])):.3f}, std {float(torch.std(q[0])):.3f}, "
          f"accept {float(acc):.2f}, ~{float(leaps):.0f} leapfrogs/transition")


if __name__ == "__main__":
    cli(main)
