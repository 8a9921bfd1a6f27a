"""The discrete-inference workflow: exact enumeration, enumerative Gibbs,
and posterior-predictive replay.

Counterpart of ``examples/19_discrete_workflow.py``. A Gaussian-mixture
classification task run three ways, each checked against the others:

1. ``enumerate_posterior``: the ground truth, the joint table over all
   assignments in one vmapped ``assess``;
2. ``enumerative_gibbs_vmap``: per-lane block Gibbs, every lane's full
   conditional enumerated against the same base trace;
3. ``posterior_predictive``: the fitted assignments replayed through the
   model to sample replicated data.
"""

import numpy as np
import torch
from scipy import stats as st
from scipy.special import logsumexp

import genjax_tpu_torch as g
from genjax_tpu_torch import categorical, gen, normal
from genjax_tpu_torch.inference import enumerate_posterior, enumerative_gibbs_vmap, posterior_predictive

from ._common import cli, device_of

PI = np.asarray([0.4, 0.6], np.float32)
MUS = np.asarray([-1.5, 1.5], np.float32)
XS = np.asarray([-1.9, -0.2, 1.1, 2.0], np.float32)


def build(device):
    log_pi = torch.log(torch.from_numpy(PI)).to(device)
    mus = torch.from_numpy(MUS).to(device)

    @gen
    def site(x):
        z = categorical(log_pi) @ "z"
        _ = normal(mus[z], 1.0) @ "y"

    @gen
    def model(xs):
        _ = site.vmap(in_axes=(0,))(xs) @ "assign"

    return model


def main(device="cuda"):
    device = device_of(device)
    model = build(device)
    xs = torch.from_numpy(XS).to(device)
    obs = g.C["assign", torch.arange(4, device=device), "y"].set(xs)

    # 1. Ground truth: enumerate all 2^4 assignment combinations.
    res = enumerate_posterior(model, (xs,), obs, {("assign", i, "z"): torch.arange(2, device=device)
                                                  for i in range(4)}, device=device)
    # Lanes are independent given the fixed means, so each lane's
    # enumerated marginal equals its pointwise conditional.
    for i, x in enumerate(XS):
        lw = np.log(PI.astype(np.float64)) + st.norm.logpdf(x, MUS, 1.0)
        exact_i = np.exp(lw - logsumexp(lw))
        np.testing.assert_allclose(np.exp(res.marginal(i).cpu().numpy()), exact_i, atol=1e-5)

    # 2. One block-Gibbs move samples every lane's exact conditional.
    tr, _ = model.generate(torch.Generator(device=device).manual_seed(0), obs, (xs,))
    _, info = enumerative_gibbs_vmap(torch.Generator(device=device).manual_seed(1), tr, ("assign", None, "z"),
                                     torch.arange(2, device=device))
    for i in range(4):
        np.testing.assert_allclose(np.exp(info.log_probs[i].cpu().numpy()), np.exp(res.marginal(i).cpu().numpy()),
                                   atol=1e-4)

    # 3. Predictive replay: condition on hard assignments (all lane-0) and
    # check the replicated data's mean tracks the cluster.
    zs = {("assign", i, "z"): torch.zeros((4000,), dtype=torch.int64, device=device) for i in range(4)}
    rep = posterior_predictive(torch.Generator(device=device).manual_seed(2), model, (xs,), zs)
    y_rep = rep["assign", :, "y"]  # structural read: (n_draws, 4)
    y_rep = y_rep.unmask() if hasattr(y_rep, "unmask") else y_rep
    assert abs(float(torch.mean(y_rep)) - float(MUS[0])) < 0.05

    print(f"enumeration, block Gibbs, and predictive replay agree; logZ = {float(res.log_evidence):.4f}")


if __name__ == "__main__":
    cli(main)
