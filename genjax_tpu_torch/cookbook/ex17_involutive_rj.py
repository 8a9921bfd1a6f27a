"""Involutive MCMC: programmable moves from an auxiliary generative function
and a deterministic involution on (model choices, aux choices).

Counterpart of ``examples/17_involutive_rj.py``. The acceptance ratio

    alpha = [log p(t') + log q(u'; t')] - [log p(t) + log q(u; t)] + log|det J|

is assembled by the framework, the Jacobian taken automatically
(``torch.func.jacfwd``) over the continuous coordinates. The
reversible-jump section uses the saturated-space formulation: every
structure's block is always sampled, the likelihood selects the live block
by the structure flag, and dormant blocks sit at their pseudo-prior.
"""

import numpy as np
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch import gen, normal
from genjax_tpu_torch.inference import gibbs_sweep, involutive_mh, involutive_move

from ._common import cli, device_of


def main(device="cuda"):
    device = device_of(device)

    def stream(seed):
        return torch.Generator(device=device).manual_seed(seed)

    # ------------------------------------------------------------------
    # 1. A random-walk move is the simplest involution:
    #    (mu, eps) -> (mu + eps, -eps).
    # ------------------------------------------------------------------
    x_obs = 1.2

    @gen
    def conj_model():
        mu = normal(0.0, 1.0) @ "mu"
        _ = normal(mu, 1.0) @ "x"

    @gen
    def rw_aux():
        _ = normal(0.0, 0.6) @ "eps"

    def rw_involution(t, u):
        t_new = g.C["mu"].set(t["mu"] + u["eps"]) | g.C["x"].set(t["x"])
        return t_new, g.C["eps"].set(-u["eps"])

    tr, _ = conj_model.generate(stream(0), g.C["x"].set(x_obs), ())
    _, info = involutive_mh(stream(1), tr, rw_aux, rw_involution, check=True)
    # A translation is volume-preserving, and the round-trip check is free:
    assert abs(float(info.logdet)) < 1e-5
    assert float(info.involution_error) < 1e-6

    res = gibbs_sweep(stream(2), tr, [involutive_move(rw_aux, rw_involution)], n_sweeps=5000,
                      record=lambda t: t.get_choices()["mu"])
    mus = res.history.cpu().numpy()[500:]
    assert abs(mus.mean() - x_obs / 2.0) < 0.1  # conjugate posterior mean

    # ------------------------------------------------------------------
    # 2. Reversible jump: 1 component vs 2 components, saturated space.
    # ------------------------------------------------------------------
    ys = torch.tensor([-0.8, -0.5, 0.4, 0.7], device=device)

    @gen
    def sat_model():
        k = g.flip(0.5) @ "k"  # structure flag: False = 1 comp
        theta = normal(0.0, 2.0) @ "theta"
        a = normal(0.0, 2.0) @ "a"
        b = normal(0.0, 2.0) @ "b"
        mus = torch.where(k, torch.stack([a, a, b, b]), theta.expand(4))
        _ = normal.vmap(in_axes=(0, None))(mus, 0.8) @ "ys"
        return k

    @gen
    def jump_aux():
        _ = normal(0.0, 1.2) @ "du"

    def jump_involution(t, u):
        # Split: (theta, du) -> (theta - du, theta + du)   [det 2]
        # Merge: (a, b)      -> ((a+b)/2, (b-a)/2)         [det 1/2]
        # Applied at once to live and dormant blocks: net |J| = 1.
        theta, a, b, du = t["theta"], t["a"], t["b"], u["du"]
        t_new = (
            g.C["k"].set(torch.logical_not(t["k"]))
            | g.C["theta"].set((a + b) / 2.0)
            | g.C["a"].set(theta - du)
            | g.C["b"].set(theta + du)
            | g.C["ys", :].set(t["ys", :])
        )
        return t_new, g.C["du"].set((b - a) / 2.0)

    def sat_rw_involution(t, u):
        k, eps = t["k"], u["eps"]
        t_new = (
            g.C["k"].set(k)
            | g.C["theta"].set(t["theta"] + torch.where(k, 0.0, eps))
            | g.C["a"].set(t["a"] + torch.where(k, eps, 0.0))
            | g.C["b"].set(t["b"] - torch.where(k, eps, 0.0))
            | g.C["ys", :].set(t["ys", :])
        )
        return t_new, g.C["eps"].set(-eps)

    @gen
    def refresh_aux():
        _ = normal(0.0, 2.0) @ "u1"
        _ = normal(0.0, 2.0) @ "u2"

    def refresh_involution(t, u):
        # Swap the dormant block with fresh pseudo-prior draws: since the
        # proposal equals the pseudo-prior, alpha = 0, a perfect Gibbs refresh.
        k = t["k"]
        t_new = (
            g.C["k"].set(k)
            | g.C["theta"].set(torch.where(k, u["u1"], t["theta"]))
            | g.C["a"].set(torch.where(k, t["a"], u["u1"]))
            | g.C["b"].set(torch.where(k, t["b"], u["u2"]))
            | g.C["ys", :].set(t["ys", :])
        )
        u_new = g.C["u1"].set(torch.where(k, t["theta"], t["a"])) | g.C["u2"].set(torch.where(k, u["u2"], t["b"]))
        return t_new, u_new

    # Exact p(k=1 | ys): both structures are linear-Gaussian, so the
    # structure posterior follows from two marginal-likelihood slogdets.
    def branch_logml(design):
        cov = 4.0 * design @ design.T + 0.64 * np.eye(4)
        y = ys.cpu().numpy().astype(np.float64)
        _s, ld = np.linalg.slogdet(2 * np.pi * cov)
        return -0.5 * (ld + y @ np.linalg.solve(cov, y))

    lm0 = branch_logml(np.ones((4, 1)))
    lm1 = branch_logml(np.array([[1.0, 0], [1, 0], [0, 1], [0, 1]]))
    p_k1 = 1.0 / (1.0 + np.exp(lm0 - lm1))

    tr, _ = sat_model.generate(stream(3), g.C["k"].set(False) | g.C["ys", :].set(ys), ())
    res = gibbs_sweep(
        stream(4),
        tr,
        [
            involutive_move(jump_aux, jump_involution),
            involutive_move(rw_aux, sat_rw_involution),
            involutive_move(refresh_aux, refresh_involution),
        ],
        n_sweeps=6000,
        record=lambda t: t.get_choices()["k"],
    )
    ks = res.history.cpu().numpy().astype(np.float64)[1000:]
    print(f"p(k=2 comps | ys): chain {ks.mean():.3f} vs exact {p_k1:.3f}")
    assert abs(ks.mean() - p_k1) < 0.08


if __name__ == "__main__":
    cli(main)
