"""The state-space workflow: exact, Rao-Blackwellized, and online.

Counterpart of ``examples/21_state_space_workflow.py``. One linear-Gaussian
time series worked four ways, every answer checked against a closed form:

1. exact: ``LinearGaussianSSM``'s Kalman filter, RTS smoother and FFBS;
2. the generic ``SSMParticleFilter``, whose log Z must agree with Kalman;
3. a Rao-Blackwellized PF over a switching regime with an exact Gaussian
   sub-filter per particle;
4. SMC^2: the transition coefficient becomes unknown, parameter particles
   each carry their own filter.

``main`` returns the data and the Kalman log marginal, which the tests hold
to the reference's Kalman filter on the same data.
"""

import numpy as np
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.core.device import to_device
from genjax_tpu_torch.dists import LGSSMParams, ffbs, kalman_filter, kalman_smoother
from genjax_tpu_torch.inference import smc2
from genjax_tpu_torch.parallel import SSMParticleFilter, rbpf

from ._common import cli, device_of

T = 16
A, Q_SD, R_SD = 0.85, 0.6, 0.4


def make_data(seed=0):
    rng = np.random.RandomState(seed)
    z, ys = 0.0, []
    for _ in range(T):
        z = A * z + Q_SD * rng.randn()
        ys.append(z + R_SD * rng.randn())
    return np.asarray(ys, np.float32)


@g.gen
def kernel(c, x):
    z = g.normal(A * c, Q_SD) @ "z"
    y = g.normal(z, R_SD) @ "y"
    return (z, y)


@g.gen
def theta_kernel(c, x):
    a, z = c
    z2 = g.normal(a * z, Q_SD) @ "z"
    y = g.normal(z2, R_SD) @ "y"
    return ((a, z2), y)


def main(device="cuda"):
    device = device_of(device)
    ys = make_data()
    ys_t = torch.from_numpy(ys).to(device)

    # ---- 1. exact: filter, smoother, posterior path sample
    # kernel convention: y_0 observes z_1 ~ N(A*0, Q) => mu0=0, P0=Q^2
    params = LGSSMParams.scalar(A, Q_SD**2, 1.0, R_SD**2, 0.0, p0=Q_SD**2)
    params = to_device(params, device)
    ys_col = ys_t.reshape(-1, 1)
    means_f, _, logz_exact = kalman_filter(params, ys_col)
    means_s, covs_s, _ = kalman_smoother(params, ys_col)
    zs, _ = ffbs(torch.Generator(device=device).manual_seed(0), params, ys_col)
    print(f"exact logZ = {float(logz_exact):.3f}")
    # smoothed uncertainty can only shrink relative to filtered
    assert float(covs_s[0, 0, 0]) <= Q_SD**2 + 1e-6
    # an FFBS path is a plausible posterior draw
    assert bool(torch.all(torch.abs(zs - means_s) < 5.0))

    # ---- 2. the generic particle filter agrees
    pf = SSMParticleFilter(kernel, n_particles=16384)
    res = pf.run(1, 0.0, torch.zeros(T, device=device), g.C[:, "y"].set(ys_t), device=device)
    print(f"PF    logZ = {float(res.log_marginal):.3f}")
    assert abs(float(res.log_marginal) - float(logz_exact)) < 0.08

    # ---- 3. Rao-Blackwellized: switching regimes
    a_reg = torch.tensor([0.85, 0.2], device=device)
    log_trans = torch.log(torch.tensor([[0.9, 0.1], [0.3, 0.7]], device=device))
    res_rb = rbpf(
        2,
        lambda gen, u, t: g.categorical.sample(gen, log_trans[u]),
        lambda u: (a_reg[u].reshape(1, 1), torch.tensor([[Q_SD**2]], device=device),
                   torch.tensor([[1.0]], device=device), torch.tensor([[R_SD**2]], device=device)),
        ys_col,
        n_particles=1024,
        init_regime=torch.tensor(0, device=device),
        mu0=torch.tensor([0.0], device=device),
        P0=torch.tensor([[Q_SD**2]], device=device),
        device=device,
    )
    w = np.exp(res_rb.log_weights.cpu().numpy())
    p_fast = float(w @ (res_rb.regimes == 0).cpu().numpy().astype(np.float32))
    print(f"RBPF  logZ = {float(res_rb.log_marginal):.3f}, P(final regime = persistent) = {p_fast:.2f}")
    assert np.isfinite(float(res_rb.log_marginal))

    # ---- 4. SMC^2: the coefficient becomes a parameter
    res2 = smc2(
        3,
        theta_kernel,
        lambda gen: 0.5 + 0.4 * torch.randn((), generator=gen, device=gen.device),
        lambda a: -0.5 * ((a - 0.5) / 0.4) ** 2,
        0.0,
        torch.zeros(T, device=device),
        g.C[:, "y"].set(ys_t),
        n_theta=128,
        n_x=64,
        rw_scales=0.15,
        n_rejuv=1,
        device=device,
    )
    wt = np.exp(res2.log_weights.cpu().numpy())
    a_mean = float(wt @ res2.thetas.cpu().numpy())
    print(f"SMC2  E[a | y] = {a_mean:.2f} (true {A}), logZ = {float(res2.log_evidence):.3f}")
    assert 0.2 < a_mean < 1.3
    assert np.isfinite(float(res2.log_evidence))
    return {"ys": ys, "log_marginal": float(logz_exact), "filtered_means": means_f.cpu().numpy(),
            "smoothed_means": means_s.cpu().numpy()}


if __name__ == "__main__":
    cli(main)
