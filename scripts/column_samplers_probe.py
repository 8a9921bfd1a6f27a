"""Three CPU probes of the column samplers on the flagship, JAX reference
against PyTorch port.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/column_samplers_probe.py chees \
        [--chains 65536] [--thin 8 16] [--adapt-chains 4096]
    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/column_samplers_probe.py svgd \
        [--particles 4096] [--steps 5 100]
    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/column_samplers_probe.py moments [--chains 65536]

``chees``: the split-R-hat of ``sample_posterior(algorithm="chees")`` in
the reference at each thinning (``n_warmup=200``, ``n_samples=25``,
``eps0=0.02``, ``target_accept=0.651``: ``chip_smoke.py``'s ChEES phase),
and ``chees_hmc``'s adapted step size, trajectory length and accept rate
in both packages from one numpy ``q0`` (200 warmup, 50 sampling sweeps, two
seeds), which shows whether the two adapt alike.

``moments``: in the reference, the largest gap (in pooled Monte Carlo
standard errors of the chains' means, as ``chip_smoke.py``'s
``chain_means_z``) between the first and the last half of the thin-10 draws
of ``sample_posterior(algorithm="hmc_sweep")`` (300 warmup, 100 draws,
``eps0=0.02``, ``L=5``), and between ChEES's (thin 16) and PT's (6 rungs)
draws and each half: which of K1's draws are a sound reference.

``svgd``: the port's ``svgd`` on the flagship's column density over the real
rows (``column_svgd``'s flow), run twice from starts 1e-7 apart (relative):
how far the particles and their means drift apart after each step count,
and how many particle-steps fell outside the support (``tau <= 0``).
"""

import argparse
import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import genjax_tpu as gj
import genjax_tpu_torch as gt
from genjax_tpu.inference.sample import sample_posterior as sample_reference
from genjax_tpu.kernels import ColumnPacker as PackerReference
from genjax_tpu.kernels import chees_hmc as chees_reference
from genjax_tpu.kernels import column_logdensity as density_reference
from genjax_tpu.models import hierarchical_regression as hier_reference
from genjax_tpu_torch.kernels import chees_hmc as chees_port
from genjax_tpu_torch.kernels.model_interface import ColumnPacker, column_logdensity, init_columns
from genjax_tpu_torch.models import hierarchical_regression as hier_port

X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
Y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)


def chees(args):
    model, obs = hier_reference(jnp.asarray(X)), gj.C["y"].set(jnp.asarray(Y))
    for thin in args.thin:
        t0 = time.perf_counter()
        res = sample_reference(jax.random.key(0), model, obs, (), gj.S["w"] | gj.S["tau"], n_chains=args.chains,
                               n_warmup=200, n_samples=25, thin=thin, algorithm="chees", eps0=0.02,
                               target_accept=0.651)
        rhat = np.concatenate([np.reshape(np.asarray(res.rhat_of("tau")), 1), np.asarray(res.rhat_of("w"))])
        print(f"reference chees {args.chains} chains thin={thin} ({time.perf_counter() - t0:.1f} s): split-R-hat "
              f"{rhat.min():.4f}-{rhat.max():.4f}, accept {float(res.accept_rate):.4f}, eps {float(res.eps):.6g}",
              flush=True)
    n = args.adapt_chains
    rp = PackerReference(model, obs, (), ["tau", "w"])
    r_ld = density_reference(model, obs, (), rp)
    port, p_obs = hier_port(X), gt.C["y"].set(torch.as_tensor(Y))
    p_ld = column_logdensity(port, p_obs, (), ColumnPacker(port, p_obs, (), ["tau", "w"]))
    rng = np.random.default_rng(5)
    q0 = (0.3 * rng.normal(size=(16, n))).astype(np.float32)
    q0[0] = rng.uniform(0.5, 1.5, size=n)
    kw = dict(n_warmup=200, n_steps=50, eps0=0.02)
    for seed in (0, 1):
        _q, ri = jax.jit(lambda q: chees_reference(r_ld, q, seed, rng_impl="threefry2x32", **kw))(jnp.asarray(q0))
        _q, pi = chees_port(p_ld, torch.from_numpy(q0), seed, **kw)
        for name, info in (("reference", ri), ("port", pi)):
            print(f"{name} chees_hmc {n} chains seed={seed}: eps {float(info.eps):.4f}, trajectory "
                  f"{float(info.trajectory_length):.4f}, accept {float(info.accept_rate):.4f}, mean leapfrogs "
                  f"{float(info.mean_leapfrogs):.3f}", flush=True)


def _gap(a, b):
    ma, mb = a.mean(1), b.mean(1)
    se = np.sqrt(ma.var(0, ddof=1) / ma.shape[0] + mb.var(0, ddof=1) / mb.shape[0])
    return float(np.abs((ma.mean(0) - mb.mean(0)) / se).max())


def moments(args):
    model, obs, sel = hier_reference(jnp.asarray(X)), gj.C["y"].set(jnp.asarray(Y)), gj.S["w"] | gj.S["tau"]

    def draws(key, **kw):
        res = sample_reference(jax.random.key(key), model, obs, (), sel, n_chains=args.chains, eps0=0.02, **kw)
        return np.concatenate([np.asarray(res["tau"])[:, :, None], np.asarray(res["w"])], axis=2)

    k1 = draws(1, n_warmup=300, n_samples=100, thin=10, algorithm="hmc_sweep", L=5)
    first, last = k1[:, :50], k1[:, 50:]
    print(f"K1 thin 10, {args.chains} chains: first half against last half {_gap(first, last):.2f} SE", flush=True)
    for name, d in (("chees", draws(0, n_warmup=200, n_samples=25, thin=16, algorithm="chees", target_accept=0.651)),
                    ("pt", draws(0, n_warmup=200, n_samples=25, algorithm="pt", L=8, n_rungs=6))):
        print(f"{name}: against K1's first half {_gap(d, first):.2f} SE, its last half {_gap(d, last):.2f} SE",
              flush=True)


def svgd(args):
    svgd_module = importlib.import_module("genjax_tpu_torch.kernels.svgd")
    model, obs = hier_port(X), gt.C["y"].set(torch.as_tensor(Y))
    packer = ColumnPacker(model, obs, (), ["tau", "w"])
    ld = column_logdensity(model, obs, (), packer)
    pad = packer.padded_dim - packer.dim

    def ld_real(q):
        return ld(torch.cat([q, q.new_zeros((pad, q.shape[1]))]))

    q0 = init_columns(model, obs, (), packer, args.particles, 0, "cpu")[: packer.dim]
    nudged = q0 * (1 + 1e-7 * torch.randn(q0.shape, generator=torch.Generator().manual_seed(1)))
    outside = [0]
    lp_grad = svgd_module._lp_grad

    def counting(f, q):
        lp, g = lp_grad(f, q)
        outside[0] += int((~torch.isfinite(lp)).sum())
        return lp, g

    svgd_module._lp_grad = counting
    for steps in args.steps:
        outside[0] = 0
        a = svgd_module.svgd(ld_real, q0, n_steps=steps, step_size=0.15)
        b = svgd_module.svgd(ld_real, nudged, n_steps=steps, step_size=0.15)
        print(f"svgd {args.particles} particles, {steps} steps: particles up to {float((a - b).abs().max()):.3g} "
              f"apart, means up to {float((a.mean(1) - b.mean(1)).abs().max()):.3g} apart, tau's mean "
              f"{float(a[0].mean()):.4f}, {outside[0]} particle-steps outside the support", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="probe", required=True)
    p = sub.add_parser("chees")
    p.add_argument("--chains", type=int, default=65536)
    p.add_argument("--thin", type=int, nargs="+", default=[8, 16])
    p.add_argument("--adapt-chains", type=int, default=4096)
    p = sub.add_parser("moments")
    p.add_argument("--chains", type=int, default=65536)
    p = sub.add_parser("svgd")
    p.add_argument("--particles", type=int, default=4096)
    p.add_argument("--steps", type=int, nargs="+", default=[5, 100])
    args = parser.parse_args()
    {"chees": chees, "moments": moments, "svgd": svgd}[args.probe](args)


if __name__ == "__main__":
    main()
