"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``genjax_tpu_torch/kernels/csrc``
(the HMC sweep K1 with its PRNG K2, the NUTS sweep K4 and the Gaussian
elliptical-slice sweep K3, one nvcc each, in parallel), reports each
kernel's registers, spills and resident blocks an SM, holds each kernel
against its plain torch version on the card (the flagship's body shape and
a generic one), and drives three workloads through the public entry points:
the flagship (hierarchical regression, 65,536 chains) with ``column_hmc``,
``column_hmc(warmup=True)`` and the adapted ``column_nuts(warmup=True)``;
the same model through the trace path (``bench.py::bench_gfi``'s shape):
``torch.func.vmap`` of ``generate``, 20 transitions of vmapped
``mh(HMC(...))``, and the batched runner ``run_chains_hmc``, which launches
K1, held against its plain twin and the per-transition runner in law; the
one-call driver ``sample_posterior(algorithm="hmc_sweep")`` on the
flagship at full width (one K1 launch a warmup window and a draw, split-R̂
under 1.05, in law against its twin); the trace path's
``sample_posterior`` with ``"nuts"`` and ``"hmc"`` on a linear regression
against its exact posterior, one vmapped NUTS trace transition on the
flagship, and ``run_chains_nuts``, which launches K4, against its twin;
K2 alone (``csrc/k2_stream.cu``, the device functions of one K1 sweep
making its normals and uniforms, written out or folded into one store a
chain): the counter variant bit for bit against the torch port, the Philox
variant against a torch port of Philox4x32-10 and in law (moments and
Kolmogorov-Smirnov), its Box-Muller over all 2^23 of its uniforms against
float64, the SASS of its hot loop, and its time beside the Philox variant
from before K2's redesign, its bound and ``torch.randn``;
the column samplers, which have no kernel in either package, at full width:
``sample_posterior`` with ``"chees"`` (split-R̂ under 1.05 at thin 8),
``"pt"`` (the flagship, and a bimodal toy's mode weights), ``"dense_hmc"``
and ``"dense_nuts"`` and ``column_hmc(mass="dense")`` on
``bench.py::bench_dense``'s 128-d correlated Gaussian (the sample covariance
against the target's), ``sample_logdensity`` and ``column_svgd`` (the card
against the CPU from the same start), the flagship's means held against the
K1 draws of ``sample_posterior(hmc_sweep)``, each timed with the card's busy
share; and exact sampling of GP latents (D = 256, 8,192 chains,
``bench.py::bench_gp``'s setup, with ``chol`` put on the card once) with
``ess_sweep_gauss_pallas``, held against the closed-form posterior; and the
combinators, which are torch in both packages: ``linear_gaussian_ssm``'s
kernel scanned over 100 steps (``bench.py::bench_pf``'s shape), a vmapped
``generate`` of 131,072 particles under ``C[:, "y"]`` (weights against
their float64 reckoning), the one-step ``IndexRequest`` beside the dense
``Update``, ``sample_posterior(hmc)`` over ``S[..., "z"]`` against the exact
Gaussian posterior, and every combinator configuration of the reference's
GFI-contract test vmapped over 4,096 lanes; and SMC, which is torch in both
packages: ``bench.py::bench_pf``'s particle filter (131,072 particles x 100
steps, systematic resampling decided by one host read a step, against the
float64 Kalman filter over 10 seeds, with its step taken apart, the other
resample design and the row moves timed beside it), ``bench_dp``'s tempered
SMC on the DP mixture (4,096 particles, 10 rungs; the card against the CPU
in law), the conjugate normal model through ``tempered_smc`` (prior
``Regenerate`` and HMC rejuvenation) and ``adaptive_tempered_smc``,
``bench_sir``'s 65,536 importance estimates through ``ImportanceK``, and the
Kalman filters, sequential and parallel, on a 4-state system over 4,096
steps; and the catalog, ADEV and variational inference, torch in both
packages: ``bench.py::bench_vi``'s ELBO gradient (the flip/normal mixture,
4,096 estimates a step, against the exact gradient in float64, then 300
descent steps that must lower the exact loss, the reverse pass timed
beside one forward pass a parameter), the ``@expectation`` example and two
estimators at 2^20 lanes against their closed forms, 2^20 draws of each of
the 48 distributions (log-densities on the card against the CPU, moments
against scipy or the CPU's draws), ``poisson_regression`` at n = 100,000,
d = 16 through ``fit_map`` and ``laplace_approximation`` against a float64
Newton optimum and inverse Hessian, and full-rank ADVI on the 128-d dense
target against its covariance; and the discrete and trace-level families,
torch in both packages: a 64-state discrete HMM over 4,096 observations
(the sequential and parallel log marginals against each other and float64
numpy, both Viterbi passes, 16,384 FFBS paths against the smoothed
marginals), Gibbs within MH over 16,384 chains and block Gibbs over 4,096
lanes against their closed forms, particle Gibbs on the exact testbed
against forward-backward and a PMMH run, the elliptical and slice requests
and involutive MCMC over 65,536 chains in law, SBC over 16,384
simulations, the posterior predictive of ``linear_regression``, PPCA at n =
100,000 x d = 64 against float64 and its ML fit, and the BNN's ADVI fit
against its exact linear posterior; the column samplers' twins (HMC, NUTS,
ChEES) on the row-sharded ``tp_bnn_logdensity`` over a one-rank model axis
against the unsharded twin on the same seed; and every cookbook of
``genjax_tpu_torch/cookbook`` (the reference's ``examples/``) as
``--device cuda`` runs it, in a process of its own beside the host-bound
phases from the column samplers on (``python3 chip_smoke.py --cookbooks
OUT`` is that process), each with its seconds and K1/K3/K4 launches. It checks
that each path launched its kernel in the variant it should (K1 and K4: the
body's; K3: the tiled one), and agrees in law with the plain twin; it checks
each kernel's shared-memory reckoning in Python against the kernel's own,
times the kernels and the twins, computes each kernel's bound from the work
this run's inputs need (K3's on the FP32 pipes and on the tensor cores), and
prints one JSON line of kernel results and a last JSON line naming the
device. Any failed check exits non-zero; so does a machine
without CUDA.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_CHAINS = 65536
N_STEPS = 50
EPS = 0.02
L = 5
SEED = 0
BLOCK_N = 128  # chain block of the counter stream, as in the reference's tests
K1_TIMED_SWEEPS = 2000  # a window of about a second at 0.5 ms a sweep
TWIN_TIMED_SWEEPS = 2
HMC_WARMUP_PHASES = 6  # warmup_column's default

# the adapted column-NUTS path: the reference's bench_nuts setup
NUTS_STEPS = 10
NUTS_DEPTH = 8
NUTS_EPS0 = 0.1
NUTS_WARMUP_PHASES = 10  # warmup_column_nuts's default
K4_WINDOW_S = 1.5

# the trace path: the reference's bench_gfi setup
GFI_STEPS = 20

# the GP / elliptical-slice path: the reference's bench_gp setup
GP_D = 256
GP_CHAINS = 8192
GP_STEPS = 50
GP_SWEEPS = 40  # 2,000 transitions from q0 = 0 reach the posterior
GP_NOISE = 0.3
K3_WINDOW_S = 1.5
K3_TWIN_TIMED_SWEEPS = 2

# the one-call driver on the flagship (sample_posterior, "hmc_sweep"): the
# reference's defaults at bench_hmc's step size and L
SP_WARMUP = 300
SP_SAMPLES = 100
SP_EPS0 = 0.02
SP_TWIN_CHAINS = 8192  # the backend="torch" run it is held against
# at thin=1 the 100 draws of L=5 do not mix the flagship's hierarchy (the
# reference's split-R-hat is 1.16-1.34 there too); at thin=10 they do
SP_THIN_CONVERGED = 10

# the trace path's NUTS and HMC through sample_posterior:
# examples/10_sample_posterior.py's linear regression, cut to about 15 s
# (NUTS pays 31 gradients a transition at depth 5 whatever its tree)
TP_N, TP_D = 24, 3
TP_CHAINS = 512
TP_WARMUP = 40
TP_SAMPLES = 40
TP_DEPTH = 5
TP_L = 8

# the batched NUTS runner on the flagship's traces
RCN_STEPS = 10
RCN_EPS = 0.05

# the column samplers (no kernel in either package): bench.py's bench_chees,
# bench_dense and bench_svgd shapes. ChEES at thin 16, where the reference's
# split-R-hat is 1.007-1.027 on this model at 65,536 chains on the CPU
# (1.027-1.078 at thin 8, and the port's 1.0647 at most on the card;
# scripts/column_samplers_probe.py chees)
CS_WARMUP = 200
CS_SAMPLES = 25
CHEES_EPS0 = 0.02
CHEES_TARGET = 0.651  # ChEES's optimal acceptance, chees_hmc's default
CHEES_THIN = 16
PT_RUNGS = 6
PT_L = 8
PT_TOY_CHAINS = 4096  # the reference test's 256, more chains at no cost on the card
DENSE_D = 128
DENSE_CHAINS = 16384
DENSE_L = 5
DENSE_EPS0 = 0.5
DENSE_WARMUP = 40  # bench_dense's 4 phases x 10 steps
DENSE_NUTS_CHAINS = 2048
DENSE_NUTS_DEPTH = 6
DENSE_NUTS_SAMPLES = 10
DENSE_COV_FACTOR = 1.5  # the covariance gate, in RMS Monte Carlo errors at the chain count
SVGD_PARTICLES = 4096
SVGD_STEPS = 100
# SVGD's 100 steps from the prior do not converge on this model, and once a
# particle crosses tau = 0 the flow is sensitive to rounding (the CPU at 4,096
# particles: tau's mean 0.61 against K1's 0.39, and two starts 1e-7 apart end
# 0.34 apart in it; scripts/column_samplers_probe.py svgd). The means are
# held within this many posterior sds of K1's draws (the prior's tau mean is
# 5.4 away), and the card against the CPU over the first SVGD_AGREE_STEPS
# steps, before the flow is chaotic
SVGD_MEAN_BOUND = 4.0
SVGD_AGREE_STEPS = 5
SVGD_CHAOS_STEPS = 20  # reported, not gated: how far apart the two are by then

# K2 alone (csrc/k2_stream.cu): the counter variant held bit for bit
# against the torch port of the counter stream, and the Philox variant
# against a torch port of Philox4x32-10 and the same Box-Muller in float64
# (uniforms bit for bit, normals to K2_PHILOX_TOL: the SFU's sin, cos, lg2
# and sqrt at |z| < 6), at this many chains and steps; the timed launches
# make one flagship K1 sweep's numbers. The whole-domain check runs the
# Philox stream's radius and angle over all 2^23 of its uniforms against
# float64, the normals within K2_DOMAIN_TOL where u1 <= 1 - 2^-16 and
# K2_DOMAIN_TOP_TOL above; one sweep's normals against the standard normal
# by Kolmogorov-Smirnov, under K2_KS_FACTOR / sqrt(n) (5% level)
K2_CHECK_CHAINS = 4096
K2_CHECK_STEPS = 3
K2_PHILOX_TOL = 1e-5
K2_TIMED_LAUNCHES = 200
K2_DOMAIN_TOL = 1e-5
K2_DOMAIN_TOP_TOL = 1e-3
K2_KS_FACTOR = 1.63

# the combinators' card path: bench.py::bench_pf's shape (a linear-Gaussian
# state-space model scanned over 100 steps, 131,072 particles, ys = 0)
SSM_T = 100
SSM_PARTICLES = 131072
SSM_EDIT_STEP = 50
# its latent posterior through sample_posterior("hmc"): the exact posterior
# from dense Gaussian conditioning (precision eigenvalues 4-8, so HMC mixes
# fast); means within 0.05 (about 0.12 posterior sd), sds within 10%
SSM_CHAINS = 16384
SSM_WARMUP = 40
SSM_SAMPLES = 20
SSM_L = 5
SSM_EPS0 = 0.2
SSM_YS_SEED = 3
SSM_MEAN_TOL = 0.05
SSM_SD_TOL = 0.10
SSM_RHAT = 1.1
# every combinator configuration of the reference's GFI-contract test,
# vmapped over this many lanes
COMB_LANES = 4096
COMB_TOL = 1e-4

# the H100 SXM's published peaks: FP32 outside the tensor cores, TF32 on
# the tensor cores (dense), and HBM3
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_S = 3.35e12
# INT32: 64 integer lanes an SM (16 a partition, the Hopper white paper) x
# 132 SMs x the 1.98 GHz boost clock; NVIDIA's data sheet gives no INT32 rate
INT32_OPS = 64 * 132 * 1.98e9
# the SFU (MUFU: sin, cos, lg2, sqrt, rsqrt, ...): 16 results a clock an SM
# (NVIDIA's arithmetic-instruction throughput table, compute capability 9.0)
SFU_OPS = 16 * 132 * 1.98e9
# Philox4x32-10, as the SASS of csrc/k2_stream.cu shows it (cuobjdump on
# the H100 build): a round is two 32 x 32 -> 64-bit products (IMAD.WIDE.U32,
# on the FMA pipe, taken as two slots each) and two three-input XORs (LOP3,
# on the ALU pipe); the round keys are the same for every call of a thread
# and leave the loop. 60 slots a call, all on one INT32 pipe in the issue
# form, an upper estimate; the two pipes, 64 lanes an SM each, run in
# parallel, so a call needs 40 slots of the busier, and the bound takes that
PHILOX_INT_OPS = 10 * (2 * 2 + 2)
PHILOX_PIPE_OPS = max(10 * 2 * 2, 10 * 2)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


T_START = time.perf_counter()


def phase(name: str, line: str) -> None:
    print(f"[{name}] {line} [t+{time.perf_counter() - T_START:.1f} s]", flush=True)


def flagship_data():
    """``X`` and ``y`` of the reference's flagship benchmark setup."""
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return X, y


def gp_data():
    """``chol`` and ``y`` as the reference's ``bench_gp`` builds them: inputs
    uniform on [0, 10] from numpy seed 0, a unit squared-exponential Gram
    matrix with 1e-4 jitter factored in float64, ``y`` a draw of the GP
    plus noise 0.3."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 10.0, size=(GP_D, 1))
    K = np.exp(-0.5 * (X - X.T) ** 2) + 1e-4 * np.eye(GP_D)
    chol = np.linalg.cholesky(K).astype(np.float32)
    f_true = (chol @ rng.normal(size=GP_D)).astype(np.float32)
    y = (f_true + GP_NOISE * rng.normal(size=GP_D)).astype(np.float32)
    return chol, y


def gp_closed_form(chol: np.ndarray, y: np.ndarray):
    """Posterior mean ``C prec y`` and sds of the latents, ``C = (K^-1 +
    prec I)^-1 = K - K (K + noise^2 I)^-1 K``, in float64."""
    L = chol.astype(np.float64)
    K = L @ L.T
    C = K - K @ np.linalg.solve(K + GP_NOISE**2 * np.eye(GP_D), K)
    return C @ (y.astype(np.float64) / GP_NOISE**2), np.sqrt(np.diag(C))


def numpy_q0(d: int, n: int, seed: int, tau_row: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q0 = (0.3 * rng.normal(size=(d, n))).astype(np.float32)
    if tau_row:
        q0[0] = rng.uniform(0.5, 1.5, size=n)
    return q0


def hier_grad_flop(n_obs: int, d_w: int, d: int) -> int:
    """FP32 FLOP of one ``hier_regression`` gradient (an FMA is 2): per
    observation the residual and the gradient terms (2 d_w FMAs), r^2 and
    r / s^2; the weights' prior (3 a weight); the padding (3 a dimension);
    about 20 for tau's scalars. Logs, divisions' refinement and the PRNG are
    not counted, so the bound is low."""
    return n_obs * (4 * d_w + 3) + 3 * d_w + 3 * (d - 1 - d_w) + 20


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of the FLOP
    over the FP32 peak and the bytes over the HBM rate, and which bounds."""
    t_ops, t_bytes = flop / FP32_FLOPS, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound(n: int, d: int, n_steps: int, leapfrogs: int, grad_flop: int, n_consts: int):
    """K1's bound: ``n_steps * L + 1`` gradients a chain, a leapfrog's
    three FMAs a dimension, two kinetic energies and the momentum scale a
    step; q read and written once, the accepts written, the constants and
    inverse mass read."""
    flop = n * ((n_steps * leapfrogs + 1) * grad_flop + n_steps * leapfrogs * 6 * d + n_steps * 7 * d)
    return bound(flop, 4 * (2 * d * n + n + d + n_consts))


def k4_bound(n: int, d: int, n_steps: int, leaps_total: float, grad_flop: int, n_consts: int):
    """K4's bound from the leapfrogs this run's chains took (``leaps``,
    summed over chains): a gradient, the leapfrog's three FMAs and the
    kinetic energy a leaf, and a gradient and a kinetic energy a transition;
    the U-turn checks are not counted. q read and written once, accepts and
    leaps written."""
    flop = leaps_total * (grad_flop + 9 * d) + n * n_steps * (grad_flop + 4 * d)
    return bound(flop, 4 * (2 * d * n + 2 * n + d + n_consts))


def k3_bound(chol: torch.Tensor, n: int, n_steps: int) -> dict:
    """K3's bound, two lines for the same work: the product ``chol @ z`` a
    chain and step, D (D + 1) FLOP where ``chol`` is lower-triangular
    (checked: a Cholesky factor is, and its zero upper triangle needs no
    work), else 2 D^2; about 15 D for the five coefficient sums and the
    update (the shrink and the draws are not counted); q read and written
    once, chol, y, prec and mean read. ``fp32``: all of it over the FP32
    FFMA peak. ``tensor``: the product as 3xTF32, three times its FLOP over
    the TF32 tensor-core peak, beside the rest over the FP32 peak (the two
    pipes run side by side). Each line is the larger of its operations and
    its bytes; K3's bound is the lesser line."""
    d = chol.shape[0]
    product = n * n_steps * (d * (d + 1) if bool((chol.triu(1) == 0).all()) else 2 * d * d)
    rest = n * n_steps * 15 * d
    t_bytes = 4 * (2 * d * n + d * d + 3 * d) / HBM_BYTES_S
    fp32 = max((product + rest) / FP32_FLOPS, t_bytes)
    tensor = max(3 * product / TF32_FLOPS, rest / FP32_FLOPS, t_bytes)
    return {
        "fp32_ms": 1e3 * fp32, "tensor_ms": 1e3 * tensor, "bytes_ms": 1e3 * t_bytes,
        "product_gflop": product / 1e9, "rest_gflop": rest / 1e9,
        "ms": 1e3 * min(fp32, tensor), "by": "operations" if min(fp32, tensor) > t_bytes else "bytes",
    }


def cuda_ms(fn, reps: int) -> float:
    """Mean wall time of ``fn`` on the card in ms, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_kernels(report: str):
    """``(kernel, registers, spill stores, spill loads, static smem, stack
    frame)`` for each entry function in an ``nvcc -Xptxas -v`` report."""
    out = []
    for chunk in report.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        m = re.search(r"([a-z][a-z0-9_]*_kernel)", mangled)
        name = m.group(1) if m else mangled
        targs = re.search(r"_kernelI((?:L[ib]\d+E)+)E", mangled)
        if targs:
            name += "<" + ",".join(re.findall(r"L[ib](\d+)E", targs.group(1))) + ">"
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        stack = re.search(r"(\d+) bytes stack frame", chunk)
        out.append((
            name, int(regs.group(1)) if regs else -1,
            int(spills.group(1)) if spills else -1, int(spills.group(2)) if spills else -1,
            int(smem.group(1)) if smem else 0, int(stack.group(1)) if stack else -1,
        ))
    return out


def compare_nuts_counter(density, body, q0_np, seed, eps, depth, device, nuts, nuts_pallas):
    """K4 and its plain version on the counter stream from one ``q0``, 3
    transitions: ``(fraction within 1e-4, differing chains, differing
    blocks, max abs err over agreeing chains, (accept, leapfrogs) of the
    kernel, of the twin)``."""
    q0 = torch.from_numpy(q0_np).to(device)
    kw = dict(n_steps=3, eps=eps, max_depth=depth, rng="counter", block_n=BLOCK_N)
    qk, acc_k, leaps_k = nuts_pallas.nuts_sweep(body, q0, seed, **kw)
    qt, acc_t, leaps_t = nuts.nuts_sweep_cols(density, q0, seed, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(qk).all()), "K4 positions are not finite")
    err = (qk - qt).abs().amax(dim=0)
    close = err <= 1e-4
    return (
        float(close.float().mean()),
        int((~close).sum()),
        int((~close).view(-1, BLOCK_N).any(dim=1).sum()),
        float(err[close].max()),
        (float(acc_k.mean()) / 3, float(leaps_k.mean()) / 3),
        (float(acc_t), float(leaps_t)),
    )


def generic_body(bodies):
    """A hier_regression body at a shape with no specialised kernel:
    ``(n_obs, d_w) = (5, 3)``, packed in D = 8."""
    rng = np.random.default_rng(53)
    return bodies.hier_regression(
        rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=5).astype(np.float32), 0.25
    )


def compare_counter(ld, body, q0_np, seed, eps, device, hmc):
    """The kernel and the plain twin on the counter stream from one ``q0``:
    ``(fraction within 1e-4, flipped chains, max abs err over agreeing
    chains, kernel accept rate, twin accept rate)``. The variant the kernel
    took is on ``hmc.hmc_sweep.last_variant``."""
    q0 = torch.from_numpy(q0_np).to(device)
    qk, acc_k = hmc.hmc_sweep(
        body, q0, seed, n_steps=5, eps=eps, L=L, rng="counter", block_n=BLOCK_N
    )
    qt, rate_t = hmc._reference_hmc(
        ld, q0, seed, n_steps=5, eps=eps, L=L, rng="counter", block_n=BLOCK_N
    )
    torch.cuda.synchronize()
    err = (qk - qt).abs().amax(dim=0)
    close = err <= 1e-4
    check(bool(torch.isfinite(qk).all()), "kernel positions are not finite")
    rate_k = float(acc_k.mean()) / 5
    return (
        float(close.float().mean()),
        int((~close).sum()),
        float(err[close].max()),
        rate_k,
        float(rate_t),
    )


def symmetric_root(chol: np.ndarray) -> np.ndarray:
    """The symmetric square root of ``chol chol'``, in float64: a full
    factor of the same prior, with no zero tile."""
    L = chol.astype(np.float64)
    w, V = np.linalg.eigh(L @ L.T)
    return ((V * np.sqrt(np.clip(w, 0.0, None))) @ V.T).astype(np.float32)


def compare_ess_counter(d, n, block_n, factor, device, elliptical):
    """K3 and its plain version on the counter stream, through
    ``ess_sweep_gauss_pallas(interpret=True)``, 5 steps from one numpy
    ``q0``: ``(fraction within 1e-4, differing chains, max abs err over
    agreeing chains)``; the variant K3 took is on
    ``elliptical.ess_gauss_sweep.last_variant``. D = 256 is the GP path's
    data, with its Cholesky factor or (``factor="full"``) the symmetric
    square root of the same prior; smaller D take a random SPD prior, D = 16
    with vector ``prec`` and ``mean``."""
    rng = np.random.default_rng(100 + d)
    if d == GP_D:
        chol, y = gp_data()
        if factor == "full":
            chol = symmetric_root(chol)
        kw = dict(prec=1.0 / GP_NOISE**2)
    else:
        A = rng.normal(size=(d, d))
        chol = np.linalg.cholesky(A @ A.T / d + np.eye(d)).astype(np.float32)
        y = rng.normal(size=d).astype(np.float32)
        kw = dict(prec=4.0)
        if d == 16:
            kw = dict(prec=np.linspace(0.5, 8.0, d, dtype=np.float32),
                      mean=np.linspace(-1.0, 1.0, d, dtype=np.float32))
    q0 = torch.from_numpy(rng.normal(size=(d, n)).astype(np.float32)).to(device)
    kw.update(n_steps=5, chol_prior=chol, y=y, block_n=block_n, interpret=True)
    qk = elliptical.ess_sweep_gauss_pallas(q0, 7, backend="cuda", **kw)
    variant = elliptical.ess_gauss_sweep.last_variant
    qt = elliptical.ess_sweep_gauss_pallas(q0, 7, backend="torch", **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(qk).all()), "K3 positions are not finite")
    err = (qk - qt).abs().amax(dim=0)
    close = err <= 1e-4
    return float(close.float().mean()), int((~close).sum()), float(err[close].max()), variant


def gp_path(device, smi: str, elliptical) -> dict:
    """K3 against its plain version, the GP main path, the main path against
    the twin in law, and the timings. Returns K3's entry of the kernels
    line."""
    for d, n, block_n, factor in [(3, 512, None, "lower"), (16, 4096, 128, "lower"),
                                  (GP_D, GP_CHAINS, None, "lower"), (GP_D, GP_CHAINS, None, "full")]:
        frac, n_diff, err, variant = compare_ess_counter(d, n, block_n, factor, device, elliptical)
        block = block_n or elliptical._default_block_n(d, n)
        phase("K3 vs plain", f"({d}, {n}), {factor} factor, {variant} variant, block_n {block}, 5 "
                             f"steps: {frac:.5f} of chains within 1e-4 ({n_diff} chains differ), max "
                             f"abs err {err:.3g} on the rest")
        check(frac >= 0.99, f"K3 ({d}, {n}, {factor}): only {frac:.4f} of chains agree within 1e-4")
        check(variant == "tiled", f"K3 ({d}, {n}) took the {variant} variant")
        if d == GP_D and factor == "lower":
            k3_err = err

    # ---- the main path: 40 calls of the public entry point from q0 = 0, with
    # chol, y, prec and mean put on the card once (as bench_gp's jit makes them
    # device constants)
    chol, y = gp_data()
    prec = 1.0 / GP_NOISE**2
    chol_d = torch.as_tensor(chol, device=device)
    y_d, prec_d, mean_d = (torch.as_tensor(v, dtype=torch.float32, device=device)
                           for v in (y, np.full(GP_D, prec), np.zeros(GP_D)))
    gp_kw = dict(n_steps=GP_STEPS, chol_prior=chol_d, y=y_d, prec=prec_d, mean=mean_d)
    q = torch.zeros(GP_D, GP_CHAINS, device=device)
    torch.cuda.synchronize()
    elliptical.ess_gauss_sweep_launches = 0
    t0 = time.perf_counter()
    for s in range(GP_SWEEPS):
        q_prev = q
        q = elliptical.ess_sweep_gauss_pallas(q, SEED + s, **gp_kw)
    torch.cuda.synchronize()
    gp_s = time.perf_counter() - t0
    launches = elliptical.ess_gauss_sweep_launches
    check(elliptical.ess_sweep_gauss_pallas.last_backend == "cuda",
          f"the GP path took {elliptical.ess_sweep_gauss_pallas.last_backend}")
    check(elliptical.ess_gauss_sweep.last_variant == "tiled",
          f"the GP path took K3's {elliptical.ess_gauss_sweep.last_variant} variant")
    check(launches == GP_SWEEPS, f"{GP_SWEEPS} calls made {launches} K3 launches")
    main_variant = elliptical.ess_gauss_sweep.last_variant
    check(tuple(q.shape) == (GP_D, GP_CHAINS), f"GP positions have shape {tuple(q.shape)}")
    check(bool(torch.isfinite(q).all()), "GP positions are not finite")
    q_again = elliptical.ess_sweep_gauss_pallas(q_prev, SEED + GP_SWEEPS - 1, **gp_kw)
    check(torch.equal(q_again, q), "K3 is not deterministic: the last call did not repeat")
    m_exact, sd_exact = gp_closed_form(chol, y)
    draws = q.double().cpu().numpy()
    z_mean = np.abs(draws.mean(axis=1) - m_exact) / sd_exact
    sd_ratio = draws.std(axis=1) / sd_exact
    phase("main path GP", f"ess_sweep_gauss_pallas D={GP_D} x {GP_CHAINS} chains x {GP_STEPS} "
                          f"steps, {GP_SWEEPS} calls from q0 = 0 on "
                          f"{elliptical.ess_sweep_gauss_pallas.last_backend}, K3's "
                          f"{elliptical.ess_gauss_sweep.last_variant} variant: {launches} K3 "
                          f"launches, {gp_s:.4f} s (host clock); repeat of the last call equal; "
                          f"|mean - closed form| / posterior sd: mean over dims "
                          f"{float(z_mean.mean()):.4f} (limit 0.1), max {float(z_mean.max()):.4f}; "
                          f"sd / closed form in [{float(sd_ratio.min()):.4f}, "
                          f"{float(sd_ratio.max()):.4f}] (limit 10%)")
    check(float(z_mean.mean()) < 0.1, f"GP means are {float(z_mean.mean()):.4f} posterior sd off")
    check(bool((np.abs(sd_ratio - 1.0) <= 0.1).all()), "a GP sd is more than 10% off the closed form")

    # ---- one more sweep by K3 (Philox) and by the twin (generator), in law
    seed = SEED + GP_SWEEPS
    qk = elliptical.ess_sweep_gauss_pallas(q, seed, **gp_kw)
    t0 = time.perf_counter()
    qt = elliptical.ess_sweep_gauss_pallas(q, seed, backend="torch", **gp_kw)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    check(elliptical.ess_sweep_gauss_pallas.last_backend == "torch", "the twin run did not take the twin")
    se = torch.sqrt((qk.var(dim=1) + qt.var(dim=1)) / GP_CHAINS)
    z = ((qk.mean(dim=1) - qt.mean(dim=1)) / se).abs()
    sd_rel = (qk.std(dim=1) / qt.std(dim=1) - 1.0).abs()
    phase("main path GP vs twin", f"one {GP_STEPS}-step sweep from K3's state: per-dim means within "
                                  f"{float(z.max()):.3f} MC standard errors (limit 5), sds within "
                                  f"{float(sd_rel.max()):.4f} (limit 0.05); twin sweep {twin_s:.3f} s")
    check(bool((z < 5).all()), f"GP means differ from the twin by up to {float(z.max()):.2f} SE")
    check(bool((sd_rel < 0.05).all()), f"GP sds differ from the twin by up to {float(sd_rel.max()):.4f}")

    # ---- timings at the path's shape, from K3's state
    k3_kw = dict(n_steps=GP_STEPS, chol=chol_d, y=y_d, prec=prec_d, mean=mean_d)

    def k3_sweep(**kw):
        return elliptical.ess_gauss_sweep(q, seed, **k3_kw, **kw)

    k3_reps = max(3, math.ceil(1.2 * K3_WINDOW_S * 1e3 / cuda_ms(k3_sweep, 20)))
    k3_ms = cuda_ms(k3_sweep, k3_reps)
    check(k3_ms * k3_reps >= K3_WINDOW_S * 1e3, f"K3 timing window {k3_ms * k3_reps:.0f} ms < {K3_WINDOW_S} s")
    plain_ms = cuda_ms(lambda: elliptical._reference_ess_gauss(
        q, seed, **dict(k3_kw, y=y_d[:, None], prec=prec_d[:, None], mean=mean_d[:, None])
    ), K3_TWIN_TIMED_SWEEPS)
    b = k3_bound(chol_d, GP_CHAINS, GP_STEPS)
    transitions = GP_CHAINS * GP_STEPS
    phase("timing GP", f"{smi}: K3 {k3_ms:.4f} ms per {GP_STEPS}-step sweep (window "
                       f"{k3_ms * k3_reps / 1e3:.2f} s, {k3_reps} sweeps) = "
                       f"{transitions / k3_ms * 1e3:.6g} transitions/s, the triangle's product "
                       f"{b['product_gflop'] / k3_ms * 1e3:.6g} GFLOP/s ({b['product_gflop']:.4g} "
                       f"GFLOP a sweep); plain twin {plain_ms:.2f} ms per sweep "
                       f"({K3_TWIN_TIMED_SWEEPS} sweeps) = {transitions / plain_ms * 1e3:.6g} "
                       f"transitions/s ({GP_CHAINS} chains x {GP_STEPS} steps, D={GP_D}, max_iters 24)")

    # K3 without its shrink loop (max_iters 0), on the counter stream, with a
    # full factor of the same prior, and with chol = 0 (every tile skipped);
    # the same 50 square products as a cuBLAS FP32 GEMM, for reference
    no_shrink_ms = cuda_ms(lambda: k3_sweep(max_iters=0), 200)
    block_n = elliptical._default_block_n(GP_D, GP_CHAINS)
    counter_ms = cuda_ms(lambda: k3_sweep(rng="counter", block_n=block_n), 200)
    full_d = torch.as_tensor(symmetric_root(chol), device=device)
    full_ms = cuda_ms(lambda: elliptical.ess_gauss_sweep(q, seed, **dict(k3_kw, chol=full_d)), 200)
    zero_d = torch.zeros_like(chol_d)  # every tile skipped: no product at all
    no_product_ms = cuda_ms(lambda: elliptical.ess_gauss_sweep(q, seed, **dict(k3_kw, chol=zero_d)), 200)
    z_gemm = torch.randn(GP_D, GP_CHAINS, device=device)
    gemm_ms = cuda_ms(lambda: [chol_d @ z_gemm for _ in range(GP_STEPS)], 20)
    phase("where the time goes", f"GP: {GP_SWEEPS} calls {gp_s * 1e3:.3f} ms (host clock) against "
                                 f"{GP_SWEEPS} K3 sweeps {GP_SWEEPS * k3_ms:.3f} ms; K3 {k3_ms:.4f} "
                                 f"ms per sweep, {no_shrink_ms:.4f} ms with max_iters 0 (no shrink "
                                 f"loop), {counter_ms:.4f} ms on the counter stream, {full_ms:.4f} "
                                 f"ms with a full factor (no zero tile to skip), {no_product_ms:.4f} "
                                 f"ms with chol = 0 (no tile, no product: the draws, sums, shrink "
                                 f"and updates); the sweep's {GP_STEPS} square products alone as a "
                                 f"cuBLAS FP32 GEMM {gemm_ms:.4f} ms")
    phase("bound GP", f"K3 at D={GP_D} x {GP_CHAINS} chains x {GP_STEPS} steps, chol "
                      f"lower-triangular ({b['product_gflop']:.4g} GFLOP of product, "
                      f"{b['rest_gflop']:.4g} GFLOP of sums and updates, {b['bytes_ms']:.4f} ms of "
                      f"bytes): tensor-core line {b['tensor_ms']:.4f} ms (the product as 3xTF32 at "
                      f"{TF32_FLOPS / 1e12:.0f} TFLOP/s), K3 at {b['tensor_ms'] / k3_ms:.4f} of it; "
                      f"FP32 line {b['fp32_ms']:.4f} ms ({FP32_FLOPS / 1e12:.0f} TFLOP/s), K3 at "
                      f"{b['fp32_ms'] / k3_ms:.4f} of it; bound {b['ms']:.4f} ms ({b['by']})")
    return {
        "name": "ess_gauss_sweep (K3)",
        "route": "cuda",
        "source": "genjax_tpu_torch/kernels/csrc/ess_gauss_sweep.cu",
        "replaces": "genjax_tpu/kernels/elliptical.py:364",
        "variant": main_variant,
        "launches": launches,
        "max_abs_err": k3_err,
        "ms": k3_ms,
        "plain_ms": plain_ms,
        "bound_ms": b["ms"],
        "bound_by": b["by"],
        "bound_fp32_ms": b["fp32_ms"],
        "library_ms": None,  # no single PyTorch call computes the sweep
    }


def wall_ms(fn, reps=3):
    """Median host-clock time of ``fn`` in ms, each call ended by a device
    synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def device_busy(fn):
    """One call of ``fn`` under ``torch.profiler``: the time the card was
    busy (the union of its kernels' and copies' intervals, in ms), how many
    of them there were, and the call's host-clock time with the profiler on.
    None when the profiler recorded nothing on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy_us, lo, hi = busy_us + (hi - lo), a, b
        else:
            hi = max(hi, b)
    busy_us += hi - lo
    return busy_us / 1e3, len(spans), host_ms


def busy_line(what: str, busy, call_ms: float) -> str:
    if busy is None:
        return f"{what}: device busy time not measured (torch.profiler recorded nothing on the device)"
    busy_ms, n, host_ms = busy
    return (f"{what}: the card busy {busy_ms:.3f} ms in {n} kernels and copies (torch.profiler, one call, "
            f"{host_ms:.3f} ms on the host clock with the profiler on) = {busy_ms / call_ms:.4f} of the "
            f"{call_ms:.3f} ms call without it, idle the other {1 - busy_ms / call_ms:.4f}")


def in_law(a, b, n: int):
    """Largest gap between the cross-chain means of two ``(n, k)`` samples,
    in combined Monte Carlo standard errors."""
    se = torch.sqrt((a.var(dim=0) + b.var(dim=0)) / n)
    return float(((a.mean(dim=0) - b.mean(dim=0)) / se).abs().max())


def gfi_path(device, smi: str, g, hmc, model, y, ld, q0) -> dict:
    """The trace path at the flagship's full width: the per-transition edit
    API, the batched sweep runner (which launches K1) at both chain axes,
    both against the plain twin in law, and where a ``run_chains_hmc`` call
    spends its time. Returns the K1 launches of each sweep call."""
    from genjax_tpu_torch.inference import mcmc

    pytree = torch.utils._pytree
    sel = g.S["w"] | g.S["tau"]
    request = g.HMC(sel, EPS, L=L)
    y_d = torch.as_tensor(y, device=device)
    obs = g.C["y"].set(y_d)
    gen = torch.Generator(device=device).manual_seed(SEED)
    dummy = torch.zeros(N_CHAINS, device=device)
    init = torch.func.vmap(lambda _: model.generate(gen, obs, ())[0], randomness="different")
    step = torch.func.vmap(lambda tr: g.mh(gen, tr, request), randomness="different")
    assess = lambda trs, axis=0: torch.func.vmap(  # noqa: E731
        lambda tr: model.assess(tr.get_choices(), ())[0], in_dims=axis)(trs)

    def gates(name, trs, axis=0):
        w = trs["w"].movedim(axis, 0)
        check(tuple(w.shape) == (N_CHAINS, 8), f"{name}: w has shape {tuple(trs['w'].shape)}")
        check(torch.equal(trs["y"].movedim(axis, 0), y_d.expand(N_CHAINS, 16)),
              f"{name}: a trace's y is not the observation bit for bit")
        check(bool(torch.isfinite(w).all()) and bool((trs["tau"] > 0).all()),
              f"{name}: w is not finite or tau left its support")
        score, again = trs.get_score(), assess(trs, axis)
        rel = float(((score - again).abs() / again.abs().clamp_min(1.0)).max())
        check(rel <= 1e-4, f"{name}: get_score() is {rel:.3g} (relative) off assess of the choices")
        return rel

    # ---- the per-transition edit API: entry()'s program at bench_gfi's width
    trs0 = init(dummy)
    hmc.hmc_sweep_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trs_t, accs = trs0, []
    for _ in range(GFI_STEPS):
        trs_t, acc = step(trs_t)
        accs.append(acc.float().mean())
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    acc_t = float(torch.stack(accs).mean())
    check(hmc.hmc_sweep_launches == 0, "the per-transition runner launched K1")
    check(0.0 < acc_t <= 1.0, f"per-transition accept rate {acc_t}")
    rel = gates("GFI trace", trs_t)
    phase("main path GFI trace", f"vmap(generate) then {GFI_STEPS} transitions of vmap(mh(HMC(S[w] | "
                                 f"S[tau], {EPS}, L={L}))) over {N_CHAINS} chains on the card: accept "
                                 f"{acc_t:.4f}, {trace_s:.3f} s (host clock, first call), y equal bit for "
                                 f"bit, get_score() within {rel:.3g} of assess (limit 1e-4), w "
                                 f"{tuple(trs_t['w'].shape)}")

    # ---- run_chains makes its chains itself, on the card by default
    rc_steps = 2
    hmc.hmc_sweep_launches = 0
    res = g.run_chains(SEED, lambda gn: model.generate(gn, obs, ())[0], request, rc_steps, N_CHAINS,
                       record=lambda tr: tr["tau"])
    torch.cuda.synchronize()
    leaves = pytree.tree_leaves(res)
    check(all(isinstance(v, torch.Tensor) and v.is_cuda for v in leaves), "run_chains left a leaf off the card")
    check(hmc.hmc_sweep_launches == 0, "run_chains launched K1")
    check(tuple(res.accept_rate.shape) == (N_CHAINS,) and tuple(res.history.shape) == (N_CHAINS, rc_steps),
          f"run_chains: accept_rate {tuple(res.accept_rate.shape)}, history {tuple(res.history.shape)}")
    check(torch.equal(res.history[:, -1], res.trace["tau"]), "run_chains: the last recorded tau is not the trace's")
    acc_rc = float(res.accept_rate.mean())
    check(0.0 < acc_rc <= 1.0, f"run_chains accept rate {acc_rc}")
    rel = gates("GFI run_chains", res.trace)
    phase("main path GFI run_chains", f"run_chains(seed, generate, HMC, {rc_steps} steps, {N_CHAINS} chains, "
                                      f"record=tau) with the default device: every leaf on the card, accept "
                                      f"{acc_rc:.4f}, history {tuple(res.history.shape)}, y equal bit for bit, "
                                      f"get_score() within {rel:.3g} of assess")

    # ---- the batched runner, chains first and chains last: one K1 launch a call
    sweeps, launches = {}, {}
    for axis in (0, -1):
        batch = trs0 if axis == 0 else pytree.tree_map(lambda v: v.movedim(0, -1), trs0)
        hmc.hmc_sweep_launches = 0
        new, acc = g.run_chains_hmc(gen, batch, sel, eps=EPS, L=L, n_steps=GFI_STEPS, chain_axis=axis)
        torch.cuda.synchronize()
        launches[axis] = hmc.hmc_sweep_launches
        check(g.run_chains_hmc.last_backend == "cuda", f"run_chains_hmc took {g.run_chains_hmc.last_backend}")
        check(launches[axis] == 1, f"run_chains_hmc(chain_axis={axis}) made {launches[axis]} K1 launches")
        check(hmc.hmc_sweep.last_variant == "specialised", f"K1 took {hmc.hmc_sweep.last_variant}")
        check(0.0 < float(acc) <= 1.0, f"sweep accept rate {float(acc)}")
        check(pytree.tree_structure(new) == pytree.tree_structure(batch), "the trace structure changed")
        rel = gates(f"GFI sweep (chain_axis={axis})", new, axis)
        sweeps[axis] = (new, float(acc))
        phase("main path GFI sweep", f"run_chains_hmc(chain_axis={axis}) {N_CHAINS} chains x {GFI_STEPS} "
                                     f"steps on {g.run_chains_hmc.last_backend}, K1's "
                                     f"{hmc.hmc_sweep.last_variant} variant: {launches[axis]} K1 launch, "
                                     f"accept {float(acc):.4f}, y equal bit for bit, get_score() within "
                                     f"{rel:.3g} of assess, w {tuple(new['w'].shape)}")

    # ---- against the twin and the per-transition runner, in law, pairwise
    hmc.hmc_sweep_launches = 0
    trs_tw, acc_tw = g.run_chains_hmc(gen, trs0, sel, eps=EPS, L=L, n_steps=GFI_STEPS, backend="torch")
    torch.cuda.synchronize()
    check(g.run_chains_hmc.last_backend == "torch" and hmc.hmc_sweep_launches == 0,
          "backend='torch' did not run the twin")
    gates("GFI twin", trs_tw)
    flat = lambda trs, axis=0: torch.cat(  # noqa: E731
        [trs["tau"].movedim(axis, 0).reshape(N_CHAINS, 1), trs["w"].movedim(axis, 0)], dim=1)
    runs = {"sweep": (flat(sweeps[0][0]), sweeps[0][1]), "sweep, chains last": (flat(sweeps[-1][0], -1), sweeps[-1][1]),
            "twin": (flat(trs_tw), float(acc_tw)), "trace": (flat(trs_t), acc_t)}
    worst_z = worst_acc = 0.0
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            z, d_acc = in_law(runs[a][0], runs[b][0], N_CHAINS), abs(runs[a][1] - runs[b][1])
            check(z < 4, f"{a} and {b}: tau, w means differ by {z:.2f} MC standard errors")
            check(d_acc <= 0.02, f"{a} and {b}: accept rates {runs[a][1]} and {runs[b][1]}")
            worst_z, worst_acc = max(worst_z, z), max(worst_acc, d_acc)
    phase("main path GFI vs twin", "; ".join(f"{k}: accept {v[1]:.4f}, tau mean {float(v[0][:, 0].mean()):.4f}"
                                             for k, v in runs.items())
                                   + f"; every pair's tau and w_j means within {worst_z:.2f} MC standard "
                                     f"errors (limit 4), accept rates within {worst_acc:.4f} (limit 0.02)")

    # ---- a model with no device body: auto raises, the twin runs when asked
    @g.gen
    def conjugate():
        mu = g.normal(0.0, 1.0) @ "mu"
        g.normal(mu, 1.0) @ "y"

    obs_c = g.C["y"].set(torch.as_tensor(2.0, device=device))
    trs_c = torch.func.vmap(lambda _: conjugate.generate(gen, obs_c, ())[0], randomness="different")(dummy[: min(4096, N_CHAINS)])
    refused = False
    try:
        g.run_chains_hmc(gen, trs_c, g.S["mu"], eps=0.5, L=5, n_steps=GFI_STEPS)
    except ValueError as e:
        refused = "backend='torch'" in str(e)
    check(refused, "a model with no device body did not raise under backend='auto' on the card")
    trs_c, acc_c = g.run_chains_hmc(gen, trs_c, g.S["mu"], eps=0.5, L=5, n_steps=100, backend="torch")
    mu = trs_c["mu"]
    check(g.run_chains_hmc.last_backend == "torch" and mu.is_cuda, "the twin did not run on the card")
    check(abs(float(mu.mean()) - 1.0) < 0.08 and abs(float(mu.var()) - 0.5) < 0.08,
          f"conjugate posterior moments {float(mu.mean())}, {float(mu.var())} (exact 1, 0.5)")
    phase("main path GFI routing", f"a model with no device body: backend='auto' raises on the card, "
                                   f"backend='torch' runs the twin there: 4096 chains x 100 steps, accept "
                                   f"{float(acc_c):.4f}, mean {float(mu.mean()):.4f} (exact 1), variance "
                                   f"{float(mu.var()):.4f} (exact 0.5)")

    # ---- the three runners on the host clock, as bench_gfi names them
    transitions = N_CHAINS * GFI_STEPS

    def run_trace():
        trs = trs0
        for _ in range(GFI_STEPS):
            trs, _acc = step(trs)

    trace_ms = wall_ms(run_trace)
    sweep_ms = wall_ms(lambda: g.run_chains_hmc(gen, trs0, sel, eps=EPS, L=L, n_steps=GFI_STEPS))
    lanes0 = pytree.tree_map(lambda v: v.movedim(0, -1), trs0)
    sweep_last_ms = wall_ms(
        lambda: g.run_chains_hmc(gen, lanes0, sel, eps=EPS, L=L, n_steps=GFI_STEPS, chain_axis=-1))
    twin_ms = wall_ms(
        lambda: g.run_chains_hmc(gen, trs0, sel, eps=EPS, L=L, n_steps=GFI_STEPS, backend="torch"), reps=1)
    column_ms = wall_ms(lambda: hmc.pallas_hmc(ld, q0, SEED, n_steps=GFI_STEPS, eps=EPS, L=L), reps=9)
    rate = lambda ms: transitions / ms * 1e3  # noqa: E731
    phase("timing GFI", f"{smi}: {N_CHAINS} chains x {GFI_STEPS} transitions a call, host clock, median of "
                        f"3: trace (vmapped mh(HMC) a transition) {trace_ms:.3f} ms = {rate(trace_ms):.6g} "
                        f"transitions/s; sweep (run_chains_hmc, K1) {sweep_ms:.3f} ms = "
                        f"{rate(sweep_ms):.6g} transitions/s (chains last: {sweep_last_ms:.3f} ms; "
                        f"backend='torch', 1 call: {twin_ms:.3f} ms = {rate(twin_ms):.6g} transitions/s); "
                        f"column (pallas_hmc on packed columns, K1, median of 9) {column_ms:.4f} ms = "
                        f"{rate(column_ms):.6g} transitions/s; column/sweep {sweep_ms / column_ms:.2f}x, "
                        f"column/trace {trace_ms / column_ms:.2f}x")

    # ---- where a run_chains_hmc call spends its time: its stages again, each
    # ended by a synchronise, and K1 by CUDA events
    stage = {}
    stage["seed read"] = wall_ms(lambda: int(torch.randint(0, 2**30, (), generator=gen, device=device)))
    stage["column_view"] = wall_ms(lambda: mcmc.column_view(trs0, sel, 0))
    z_cols, _ld_cols, write_back = mcmc.column_view(trs0, sel, 0)
    stage["kernel view (equal-y check, packer, body)"] = wall_ms(
        lambda: mcmc._KernelView(trs0, sel, 0, z_cols.shape[0]))
    y_b = trs0["y"]
    stage["of which the equal-y check"] = wall_ms(lambda: bool((y_b == y_b.select(0, 0).unsqueeze(0)).all()))
    view = mcmc._KernelView(trs0, sel, 0, z_cols.shape[0])
    stage["pack"] = wall_ms(lambda: view.packer.pack_columns(z_cols, view.rows, gen))
    q_in = view.packer.pack_columns(z_cols, view.rows, gen)
    k1_ms = cuda_ms(lambda: hmc.hmc_sweep(view.body, q_in, SEED, n_steps=GFI_STEPS, eps=EPS, L=L), 500)
    stage["K1 call (host clock)"] = wall_ms(
        lambda: hmc.pallas_hmc(view.body, q_in, SEED, n_steps=GFI_STEPS, eps=EPS, L=L))
    q_out, _ = hmc.pallas_hmc(view.body, q_in, SEED, n_steps=GFI_STEPS, eps=EPS, L=L)
    stage["unpack"] = wall_ms(lambda: view.packer.unpack_columns(q_out, view.rows))
    z_final = view.packer.unpack_columns(q_out, view.rows)
    stage["write_back"] = wall_ms(lambda: write_back(z_final, gen))
    parts = sum(v for k, v in stage.items() if not k.startswith("of which"))
    phase("where the time goes", f"GFI, {smi}: run_chains_hmc call {sweep_ms:.3f} ms (host clock, median of "
                                 f"3); its stages alone, each ended by a synchronise: "
                                 + ", ".join(f"{k} {v:.3f} ms" for k, v in stage.items())
                                 + f" (sum {parts:.3f} ms); K1 on the card {k1_ms:.4f} ms a {GFI_STEPS}-step "
                                   f"sweep by CUDA events (500 sweeps) = {k1_ms / sweep_ms:.4f} of the call")
    # ---- how long the card itself works in a call of each runner
    busy_sweep = device_busy(lambda: g.run_chains_hmc(gen, trs0, sel, eps=EPS, L=L, n_steps=GFI_STEPS))
    busy_step = device_busy(lambda: step(trs0))
    phase("where the time goes", f"GFI, {smi}: " + busy_line("run_chains_hmc", busy_sweep, sweep_ms) + "; "
                                 + busy_line("one vmapped mh(HMC) transition", busy_step, trace_ms / GFI_STEPS))
    return {"run_chains_hmc": launches[0], "run_chains_hmc(chain_axis=-1)": launches[-1]}


def k2_line(device, smi: str):
    """K2's bound and library time: the random numbers one flagship K1 sweep
    draws in its Philox stream, against ``torch.randn`` and ``torch.rand``
    of the same counts on a CUDA generator (Philox4x32-10 too), which write
    them out. The bound reads the work whatever implements it: Philox calls
    as the words the numbers need over 4 (a normal or a uniform takes one
    word), each of ``PHILOX_PIPE_OPS`` on the busier integer pipe; the
    transform's least work, a log, a square root, a sine and a cosine a pair
    of normals on the SFU; the numbers written out once. The largest line
    bounds; the operations lines alone bound the numbers folded into one
    store a chain."""
    normals, uniforms = N_CHAINS * 16 * N_STEPS, N_CHAINS * N_STEPS
    calls = (normals + uniforms) / 4
    t_ops = calls * PHILOX_PIPE_OPS / INT32_OPS
    t_issue = calls * PHILOX_INT_OPS / INT32_OPS
    t_sfu = normals / 2 * 4 / SFU_OPS
    t_bytes = 4 * (normals + uniforms) / HBM_BYTES_S
    lines = {"bytes": t_bytes, "operations": max(t_ops, t_sfu)}
    by = max(lines, key=lines.get)
    bound_ms = 1e3 * lines[by]
    gen = torch.Generator(device=device).manual_seed(SEED)

    def draw():
        torch.randn(normals, generator=gen, device=device)
        torch.rand(uniforms, generator=gen, device=device)

    library_ms = cuda_ms(draw, 50)
    phase("K2", f"{smi}: the Philox stream of one flagship K1 sweep ({N_CHAINS} chains x 16 dims x "
                f"{N_STEPS} steps = {normals} normals and {uniforms} accept uniforms, {calls:.0f} "
                f"Philox4x32-10 calls' words, each call {PHILOX_INT_OPS} integer slots, {PHILOX_PIPE_OPS} on "
                f"the busier of the FMA and ALU pipes): bound {bound_ms:.4f} ms ({by}; Philox "
                f"{1e3 * t_ops:.4f} ms at {INT32_OPS / 1e12:.2f} TOP/s a pipe, all {PHILOX_INT_OPS} on one "
                f"pipe {1e3 * t_issue:.4f} ms; the transform's {2 * normals} SFU operations "
                f"{1e3 * t_sfu:.4f} ms at {SFU_OPS / 1e12:.2f} TOP/s; the numbers written out "
                f"{1e3 * t_bytes:.4f} ms at {HBM_BYTES_S / 1e12:.2f} TB/s); torch.randn + torch.rand of the "
                f"same counts on a CUDA generator {library_ms:.4f} ms by CUDA events (50 calls), at "
                f"{bound_ms / library_ms:.4f} of the bound")
    return {"bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms,
            "ops_bound_ms": 1e3 * max(t_ops, t_sfu)}


SASS_CLASSES = {
    "sfu": ("MUFU",),
    "convert": ("I2F", "F2I", "I2FP", "F2F"),
    "int_fma_pipe": ("IMAD",),
    "int_alu": ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "IABS", "IMNMX", "PRMT", "FLO", "POPC"),
    "fp32": ("FFMA", "FADD", "FMUL", "FSEL", "FSETP", "FMNMX", "FCHK"),
    "memory": ("LDG", "STG", "LDS", "STS", "LDL", "STL", "LDC", "ULDC"),
}
PHILOX_M0 = ("0xd2511f53", "-0x2daee0ad")  # Philox4x32's first multiplier, as SASS may print it


def sass_loops(sass: str) -> dict:
    """Instruction counts of each kernel in ``cuobjdump -sass`` text: the
    whole function and its first loop (the instructions from the earliest
    target of a backward branch to the first branch back to it, the hot
    path; out-of-line slow paths after it are not counted), by opcode class
    (``SASS_CLASSES``), and the loop's Philox rounds (products by the first
    multiplier)."""
    out = {}
    for func in sass.split("Function : ")[1:]:
        name = func.split(None, 1)[0]
        instrs, labels, pending = [], {}, []
        for line in func.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if not m:
                continue
            addr, text = int(m.group(1), 16), m.group(2)
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            instrs.append((addr, text))
        back = []
        for addr, text in instrs:
            t = re.search(r"BRA\s+(?:\S+\s+)?`\((\.L_x_\d+)\)", text) or re.search(r"BRA\s+(0x[0-9a-f]+)", text)
            if t:
                target = labels.get(t.group(1)) if t.group(1).startswith(".") else int(t.group(1), 16)
                if target is not None and target <= addr:
                    back.append((target, addr))
        loop = []
        if back:
            head = min(t for t, _ in back)
            latch = min(a for t, a in back if t == head)
            loop = [text for addr, text in instrs if head <= addr <= latch]

        def classes(texts):
            ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in texts]
            c = {k: sum(op.split(".")[0] in v for op in ops) for k, v in SASS_CLASSES.items()}
            c["total"] = len(ops)
            return c

        out[name] = {"function": classes([t for _, t in instrs]), "loop": classes(loop),
                     "loop_philox_rounds": sum(("IMAD.WIDE" in t or "IMAD.HI" in t)
                                               and any(k in t for k in PHILOX_M0) for t in loop)}
    return out


def sass_of(lib) -> str:
    """``cuobjdump -sass`` of a library built by ``_build.load``, with the
    toolkit's cuobjdump beside its nvcc."""
    from pathlib import Path

    from genjax_tpu_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", lib._name], capture_output=True, text=True, check=True).stdout


def chain_means_z(a, b):
    """Largest gap between two runs' posterior means of ``(chains, samples,
    k)`` draws, in combined Monte Carlo standard errors from the spread of
    the chains' own means (independent across chains, whatever the
    autocorrelation inside them)."""
    ma, mb = a.mean(dim=1), b.mean(dim=1)
    se = torch.sqrt(ma.var(dim=0) / ma.shape[0] + mb.var(dim=0) / mb.shape[0])
    return float(((ma.mean(dim=0) - mb.mean(dim=0)) / se).abs().max())


def sample_posterior_path(device, smi: str, g, hmc, model, y):
    """``sample_posterior(algorithm="hmc_sweep")`` on the flagship at full
    width: its K1 launches, its diagnostics, in law against the same call on
    the plain twin, a call's time by stage and the card's busy share.
    Returns the K1 launches of a call and the thin-10 draws of ``tau`` and
    ``w``, ``(chains, samples, 9)``."""
    from genjax_tpu_torch.inference import sample

    sel = g.S["w"] | g.S["tau"]
    obs = g.C["y"].set(torch.as_tensor(y, device=device))
    kw = dict(n_warmup=SP_WARMUP, n_samples=SP_SAMPLES, algorithm="hmc_sweep", eps0=SP_EPS0, L=L)

    def call(seed=SEED, n_chains=N_CHAINS, thin=1, **extra):
        return sample.sample_posterior(seed, model, obs, (), sel, n_chains=n_chains, thin=thin, **kw, **extra)

    def diag_range(r):
        rhat = torch.cat([r.rhat_of("tau").reshape(1), r.rhat_of("w")])
        ess_ = torch.cat([r.ess_of("tau").reshape(1), r.ess_of("w")])
        return (f"split-R-hat of tau, w {float(rhat.min()):.4f}-{float(rhat.max()):.4f} (tau "
                f"{float(rhat[0]):.4f}), ESS {float(ess_.min()):.1f}-{float(ess_.max()):.1f}")

    hmc.hmc_sweep_launches = 0
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = hmc.hmc_sweep_launches
    want = min(6, SP_WARMUP) + SP_SAMPLES
    check(launches == want, f"sample_posterior(hmc_sweep) made {launches} K1 launches, not {want}")
    check(hmc.pallas_hmc.last_backend == "cuda" and hmc.hmc_sweep.last_variant == "specialised",
          f"sample_posterior(hmc_sweep) took {hmc.pallas_hmc.last_backend}, {hmc.hmc_sweep.last_variant}")
    w, tau = res["w"], res["tau"]
    check(tuple(w.shape) == (N_CHAINS, SP_SAMPLES, 8) and tuple(tau.shape) == (N_CHAINS, SP_SAMPLES)
          and w.is_cuda, f"draws: w {tuple(w.shape)}, tau {tuple(tau.shape)}, on {w.device}")
    check(bool(torch.isfinite(w).all()) and bool((tau > 0).all()), "draws are not finite or tau left its support")
    check(float(res.divergence_rate) == 0.0, f"divergence rate {float(res.divergence_rate)}")
    acc, eps = float(res.accept_rate), float(res.eps)
    phase("main path sample_posterior hmc_sweep",
          f"sample_posterior(hierarchical_regression, S[w] | S[tau], {N_CHAINS} chains, n_warmup="
          f"{SP_WARMUP}, n_samples={SP_SAMPLES}, thin=1, eps0={SP_EPS0}, L={L}, algorithm='hmc_sweep') on "
          f"{hmc.pallas_hmc.last_backend}, K1's {hmc.hmc_sweep.last_variant} variant: {launches} K1 "
          f"launches ({min(6, SP_WARMUP)} windows + {SP_SAMPLES} draws), draws w {tuple(w.shape)} on the "
          f"card, adapted eps {eps:.6g}, accept {acc:.4f}, divergence rate 0, {diag_range(res)}, "
          f"{first_s:.3f} s (host clock, first call)")

    # ---- converged: the same call drawing every SP_THIN_CONVERGED transitions
    hmc.hmc_sweep_launches = 0
    res_c = call(thin=SP_THIN_CONVERGED)
    launches_c = hmc.hmc_sweep_launches
    check(launches_c == want, f"sample_posterior(hmc_sweep, thin={SP_THIN_CONVERGED}) made {launches_c} K1 launches")
    rhat = torch.cat([res_c.rhat_of("tau").reshape(1), res_c.rhat_of("w")])
    check(bool((rhat < 1.05).all()), f"thin={SP_THIN_CONVERGED}: split-R-hat of tau, w {rhat.tolist()} (limit 1.05)")
    check(float(res_c.divergence_rate) == 0.0, f"divergence rate {float(res_c.divergence_rate)}")
    phase("main path sample_posterior hmc_sweep",
          f"the same with thin={SP_THIN_CONVERGED} ({SP_SAMPLES * SP_THIN_CONVERGED} sampling transitions): "
          f"{launches_c} K1 launches, accept {float(res_c.accept_rate):.4f}, {diag_range(res_c)}; every "
          f"split-R-hat under 1.05")

    # ---- in law against the plain twin (the GFI's assess), at fewer chains
    t0 = time.perf_counter()
    res_t = call(seed=SEED + 1, n_chains=SP_TWIN_CHAINS, backend="torch")
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    check(hmc.hmc_sweep_launches == launches, "the backend='torch' call launched K1")
    flat = lambda r: torch.cat([r["tau"][:, :, None], r["w"]], dim=2)  # noqa: E731
    z = chain_means_z(flat(res), flat(res_t))
    d_acc = abs(acc - float(res_t.accept_rate))
    check(d_acc <= 0.02, f"hmc_sweep accept {acc} vs twin {float(res_t.accept_rate)}")
    check(z < 4, f"hmc_sweep tau, w means differ from the twin's by {z:.2f} MC standard errors")
    phase("main path sample_posterior hmc_sweep vs twin",
          f"backend='torch' at {SP_TWIN_CHAINS} chains ({twin_s:.2f} s, {diag_range(res_t)}): accept "
          f"{acc:.4f} vs {float(res_t.accept_rate):.4f} (limit 0.02), eps {eps:.6g} vs {float(res_t.eps):.6g}, tau mean "
          f"{float(tau.mean()):.4f} vs {float(res_t['tau'].mean()):.4f}; tau and w_j means within {z:.2f} "
          f"MC standard errors of the chains' means (limit 4)")

    # ---- a call's time, its stages, K1's share and the card's busy share
    call_ms = wall_ms(call)
    gen = torch.Generator(device=device).manual_seed(SEED)
    stage = {"init": wall_ms(lambda: sample._init_traces(gen, model, obs, (), N_CHAINS, device))}
    trs = sample._init_traces(gen, model, obs, (), N_CHAINS, device)
    warm_kw = dict(n_warmup=SP_WARMUP, eps0=SP_EPS0, L=L, target_accept=0.8, backend="auto")
    stage["warmup"] = wall_ms(lambda: sample._warm_sweep(gen, trs, sel, **warm_kw))
    trs_w, eps_w, im_w = sample._warm_sweep(gen, trs, sel, **warm_kw)
    draw_kw = dict(lo=0, hi=SP_SAMPLES, base=SEED, thin=1, eps=eps_w, inv_mass=im_w, L=L, backend="auto")
    stage["draws"] = wall_ms(lambda: sample._draw_sweep(gen, trs_w, sel, **draw_kw))
    trs_d, draws, _accs = sample._draw_sweep(gen, trs_w, sel, **draw_kw)
    stage["diagnostics"] = wall_ms(lambda: sample._column_diagnostics(draws, SP_SAMPLES))
    stage["unravel"] = wall_ms(lambda: sample._unraveler(trs_d, sel)(draws))
    run = sample._ColumnSweep(trs_w, sel, 0, "auto", "chip_smoke")
    q = run.start(gen)
    sweep_kw = dict(eps=float(eps_w), L=L, inv_mass=run.inv_mass(im_w))
    k1_window_ms = cuda_ms(lambda: hmc.hmc_sweep(run.view.body, q, SEED, n_steps=SP_WARMUP // 6, **sweep_kw), 20)
    k1_draw_ms = cuda_ms(lambda: hmc.hmc_sweep(run.view.body, q, SEED, n_steps=1, **sweep_kw), 200)
    k1_ms = 6 * k1_window_ms + SP_SAMPLES * k1_draw_ms
    parts = sum(stage.values())
    phase("where the time goes",
          f"sample_posterior(hmc_sweep), {smi}: a call {call_ms:.3f} ms (host clock, median of 3); its "
          f"stages alone, each ended by a synchronise: " + ", ".join(f"{k} {v:.3f} ms" for k, v in stage.items())
          + f" (sum {parts:.3f} ms); K1 on the card {k1_ms:.4f} ms a call by CUDA events (6 windows x "
            f"{k1_window_ms:.4f} ms a {SP_WARMUP // 6}-step sweep + {SP_SAMPLES} draws x {k1_draw_ms:.4f} ms "
            f"a 1-step sweep) = {k1_ms / call_ms:.4f} of the call")
    busy = device_busy(call)
    phase("where the time goes", f"sample_posterior(hmc_sweep), {smi}: " + busy_line("a call", busy, call_ms))
    return launches, flat(res_c)


def trace_nuts_path(device, smi: str, g, hmc, nuts_pallas, model_flag, y) -> int:
    """The trace path's ``sample_posterior`` (``"nuts"`` and ``"hmc"``, no
    kernel) against the exact posterior of the linear regression of
    ``examples/10_sample_posterior.py``; one vmapped NUTS trace transition
    on the flagship at full width; and ``run_chains_nuts`` on the flagship's
    traces, which launches K4, against its twin. Returns the K4 launches of
    a ``run_chains_nuts`` call."""
    from genjax_tpu_torch.inference import sample
    from genjax_tpu_torch.models import linear_regression

    # ---- "nuts" and "hmc" against the exact posterior
    rng = np.random.default_rng(0)
    X = rng.normal(size=(TP_N, TP_D)).astype(np.float32)
    w_true = np.asarray([1.0, -2.0, 0.5], np.float32)
    y_lr = (X @ w_true + 0.25 * rng.normal(size=TP_N)).astype(np.float32)
    lin, exact_posterior = linear_regression(X)
    post_mean, post_cov = exact_posterior(y_lr)
    post_sd = torch.sqrt(torch.diagonal(post_cov))
    obs_lr = g.C["y"].set(torch.as_tensor(y_lr, device=device))
    lines = []
    for algorithm in ("nuts", "hmc"):
        hmc.hmc_sweep_launches = nuts_pallas.nuts_sweep_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sample.sample_posterior(
            SEED, lin, obs_lr, (), g.S["w"], n_chains=TP_CHAINS, n_warmup=TP_WARMUP,
            n_samples=TP_SAMPLES, algorithm=algorithm, eps0=0.02, max_depth=TP_DEPTH, L=TP_L,
        )
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(hmc.hmc_sweep_launches == 0 and nuts_pallas.nuts_sweep_launches == 0,
              f"sample_posterior({algorithm!r}) launched a kernel")
        w = res["w"]
        check(tuple(w.shape) == (TP_CHAINS, TP_SAMPLES, TP_D) and w.is_cuda, f"{algorithm}: w {tuple(w.shape)}")
        flat = w[:, -TP_SAMPLES // 2:].reshape(-1, TP_D).cpu()
        d_mean = float((flat.mean(dim=0) - post_mean).abs().max())
        sd_rel = float((flat.std(dim=0) / post_sd - 1.0).abs().max())
        rhat = res.rhat_of("w")
        check(d_mean < 0.05, f"{algorithm}: posterior means {flat.mean(dim=0).tolist()} vs exact {post_mean.tolist()}")
        check(sd_rel < 0.25, f"{algorithm}: posterior sds {flat.std(dim=0).tolist()} vs exact {post_sd.tolist()}")
        check(bool((rhat < 1.15).all()), f"{algorithm}: split-R-hat {rhat.tolist()} (limit 1.15)")
        check(float(res.eps) != 0.02, f"{algorithm}: the warmup left eps at eps0")
        lines.append(f"{algorithm}: {secs:.2f} s, means within {d_mean:.4f} of exact (limit 0.05), sds within "
                     f"{sd_rel:.4f} (limit 25%), split-R-hat max {float(rhat.max()):.4f} (limit 1.15), ESS min "
                     f"{float(res.ess_of('w').min()):.1f}, eps 0.02 -> {float(res.eps):.6g}, accept "
                     f"{float(res.accept_rate):.4f}, divergence rate {float(res.divergence_rate):.4f}")
    phase("main path sample_posterior nuts/hmc",
          f"linear_regression(X {TP_N} x {TP_D}), S[w], {TP_CHAINS} chains on the card, n_warmup={TP_WARMUP}, "
          f"n_samples={TP_SAMPLES}, eps0=0.02, max_depth={TP_DEPTH} (nuts), L={TP_L} (hmc), no kernel: "
          + "; ".join(lines) + " (the last half of the draws against the exact posterior)")

    # ---- one vmapped NUTS trace transition on the flagship at full width
    sel = g.S["w"] | g.S["tau"]
    obs = g.C["y"].set(torch.as_tensor(y, device=device))
    gen = torch.Generator(device=device).manual_seed(SEED)
    trs = sample._init_traces(gen, model_flag, obs, (), N_CHAINS, device)
    step = sample._trace_step(gen, sel, "nuts", L=L, max_depth=NUTS_DEPTH)
    eps_t, im_t = torch.tensor(RCN_EPS, device=device), torch.ones(9, device=device)
    step(trs, eps_t, im_t)
    nuts_ms = wall_ms(lambda: step(trs, eps_t, im_t), reps=1)
    phase("timing NUTS trace", f"{smi}: one vmapped NUTS.edit_with_info transition of {N_CHAINS} flagship "
                               f"traces at max_depth {NUTS_DEPTH} ({2**NUTS_DEPTH - 1} leaves, each a vmapped "
                               f"grad_and_value of assess, whatever the tree), eps {RCN_EPS}: {nuts_ms:.1f} ms "
                               f"(host clock, 1 call after one warm-up call)")

    # ---- run_chains_nuts: one K4 launch a call, against the twin in law
    nuts_pallas.nuts_sweep_launches = 0
    new, acc, leaps = g.run_chains_nuts(gen, trs, sel, eps=RCN_EPS, max_depth=NUTS_DEPTH, n_steps=RCN_STEPS)
    torch.cuda.synchronize()
    launches = nuts_pallas.nuts_sweep_launches
    check(g.run_chains_nuts.last_backend == "cuda", f"run_chains_nuts took {g.run_chains_nuts.last_backend}")
    check(launches == 1, f"run_chains_nuts made {launches} K4 launches")
    check(nuts_pallas.nuts_sweep.last_variant == "specialised", f"K4 took {nuts_pallas.nuts_sweep.last_variant}")
    check(torch.equal(new["y"], trs["y"]) and bool(torch.isfinite(new["w"]).all()),
          "run_chains_nuts: y changed or w is not finite")
    t0 = time.perf_counter()
    twin, acc_t, leaps_t = g.run_chains_nuts(gen, trs, sel, eps=RCN_EPS, max_depth=NUTS_DEPTH,
                                             n_steps=RCN_STEPS, backend="torch")
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    check(g.run_chains_nuts.last_backend == "torch" and nuts_pallas.nuts_sweep_launches == 1,
          "backend='torch' did not run the twin")
    flat = lambda t: torch.cat([t["tau"].reshape(N_CHAINS, 1), t["w"]], dim=1)  # noqa: E731
    z = in_law(flat(new), flat(twin), N_CHAINS)
    check(abs(float(acc) - float(acc_t)) <= 0.02, f"run_chains_nuts accept {float(acc)} vs twin {float(acc_t)}")
    check(abs(float(leaps) - float(leaps_t)) <= 0.05 * float(leaps_t),
          f"run_chains_nuts leapfrogs {float(leaps)} vs twin {float(leaps_t)}")
    check(z < 4, f"run_chains_nuts tau, w means differ from the twin's by {z:.2f} MC standard errors")

    @g.gen
    def conjugate():
        mu = g.normal(0.0, 1.0) @ "mu"
        g.normal(mu, 1.0) @ "y"

    trs_c = sample._init_traces(gen, conjugate, g.C["y"].set(2.0), (), 1024, device)
    refused = False
    try:
        g.run_chains_nuts(gen, trs_c, g.S["mu"], eps=0.5, max_depth=4)
    except ValueError as e:
        refused = "backend='torch'" in str(e)
    check(refused, "run_chains_nuts: a model with no device body did not raise under backend='auto'")
    call_ms = wall_ms(lambda: g.run_chains_nuts(gen, trs, sel, eps=RCN_EPS, max_depth=NUTS_DEPTH, n_steps=RCN_STEPS))
    run = sample._ColumnSweep(trs, sel, 0, "auto", "chip_smoke")
    q, im = run.start(gen), run.inv_mass(None)  # the call's block and mass, its padding inert
    k4_ms = cuda_ms(lambda: nuts_pallas.nuts_sweep(run.view.body, q, SEED, n_steps=RCN_STEPS, eps=RCN_EPS,
                                                   max_depth=NUTS_DEPTH, inv_mass=im), 20)
    busy = device_busy(lambda: g.run_chains_nuts(gen, trs, sel, eps=RCN_EPS, max_depth=NUTS_DEPTH, n_steps=RCN_STEPS))
    phase("main path run_chains_nuts",
          f"{smi}: run_chains_nuts(flagship, {N_CHAINS} traces from vmap(generate), eps {RCN_EPS}, max_depth "
          f"{NUTS_DEPTH}, {RCN_STEPS} transitions) on {g.run_chains_nuts.last_backend}, K4's "
          f"{nuts_pallas.nuts_sweep.last_variant} variant: {launches} K4 launch a call, accept {float(acc):.4f} "
          f"vs twin {float(acc_t):.4f} (limit 0.02), mean leapfrogs {float(leaps):.4f} vs {float(leaps_t):.4f} "
          f"(limit 5%), tau and w_j means within {z:.2f} SE (limit 4), twin {twin_s:.2f} s; no device body "
          f"raises under 'auto'; a call {call_ms:.3f} ms (host clock, median of 3), K4 {k4_ms:.4f} ms of it "
          f"by CUDA events (20 sweeps) = {k4_ms / call_ms:.4f}; " + busy_line("a call", busy, call_ms))
    return launches


PAR_PF_SEEDS = 5  # each resample mode's runs of the sharded filter
PAR_RBPF_PARTICLES, PAR_RBPF_T = 65536, 100
PAR_ISLAND_PARTICLES, PAR_ISLAND_T, PAR_ISLAND_EVERY = 4096, 16, 4  # examples/25's shape
PAR_ISLAND_SEEDS = 8  # the gate holds the runs' mean log marginal
PAR_DATA_ROWS, PAR_DATA_D, PAR_DATA_CHAINS = 4096, 8, 1024
PAR_BNN_D_IN, PAR_BNN_HIDDEN, PAR_BNN_M, PAR_BNN_CHAINS = 8, 256, 64, 1024


def parallel_path(device, smi: str, g, hmc, nuts_pallas, model, y, ref_draws) -> dict:
    """The scale-out layer on the card at a world of one rank on NCCL (a
    card holds one rank, and NCCL refuses two ranks on one GPU; the
    multi-rank runs are the CPU tests' gloo worlds): the sharded flagship
    ``sample_posterior(hmc_sweep, mesh=)`` (K1) and ``column_nuts(warmup=True,
    mesh=)`` (K4) with their launch counts, the sharded particle filter in
    both resample modes against Kalman, the RBPF, the island filter on a
    ``(1, 1)`` hierarchical mesh with its audit, and the data-sharded and
    tensor-parallel densities against their unsharded twins. Returns the
    K1 and K4 launches of the sharded calls."""
    import os
    import tempfile

    import torch.distributed as dist
    from genjax_tpu_torch.dists import LGSSMParams, kalman_filter
    from genjax_tpu_torch.inference import sample
    from genjax_tpu_torch.kernels.model_interface import column_nuts
    from genjax_tpu_torch.models import linear_gaussian_ssm
    from genjax_tpu_torch.parallel import (
        IslandParticleFilter, SSMParticleFilter, bnn_logdensity_reference, collective_counts, collective_log,
        data_sharded_logdensity, initialize_distributed, make_hier_mesh, make_mesh, make_mesh_2d, rbpf,
        shard_params, tp_bnn_logdensity,
    )

    t_par = time.perf_counter()
    out = {}
    store_dir = tempfile.mkdtemp()
    try:
        rank_device = initialize_distributed(rank=0, world_size=1,
                                             store=dist.FileStore(os.path.join(store_dir, "store"), 1))
    except Exception as e:  # noqa: BLE001 - reported as the phase's failure
        check(False, f"[parallel] the NCCL group did not start: {type(e).__name__}: {e}")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1 and rank_device.type == "cuda",
              f"[parallel] group: backend {dist.get_backend()}, world {dist.get_world_size()}, {rank_device}")
        mesh = make_mesh()
        phase("parallel", f"{smi}: NCCL process group of 1 rank (FileStore rendezvous), mesh {mesh.shape} on "
                          f"{mesh.device}, {time.perf_counter() - t_par:.2f} s")

        # ---- the sharded flagship HMC: K1 on the rank's shard
        sel = g.S["w"] | g.S["tau"]
        obs = g.C["y"].set(torch.as_tensor(y, device=device))
        kw = dict(n_chains=N_CHAINS, n_warmup=SP_WARMUP, n_samples=SP_SAMPLES, thin=SP_THIN_CONVERGED,
                  algorithm="hmc_sweep", eps0=SP_EPS0, L=L)
        hmc.hmc_sweep_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sample.sample_posterior(SEED + 5, model, obs, (), sel, mesh=mesh, **kw)
        torch.cuda.synchronize()
        sharded_ms = (time.perf_counter() - t0) * 1e3
        k1 = hmc.hmc_sweep_launches
        want = min(6, SP_WARMUP) + SP_SAMPLES
        check(k1 == want, f"[parallel] sharded sample_posterior(hmc_sweep) made {k1} K1 launches, not {want}")
        check(hmc.pallas_hmc.last_backend == "cuda", "[parallel] the sharded sweep left the card")
        rhat = torch.cat([res.rhat_of("tau").reshape(1), res.rhat_of("w")])
        check(bool((rhat < 1.05).all()), f"[parallel] sharded split-R-hat {rhat.tolist()} (limit 1.05)")
        flat = torch.cat([res["tau"][:, :, None], res["w"]], dim=2)
        z = chain_means_z(flat, ref_draws)
        check(z < 4, f"[parallel] sharded posterior means {z:.2f} SE from the unsharded call's (limit 4)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample.sample_posterior(SEED + 6, model, obs, (), sel, **kw)
        torch.cuda.synchronize()
        plain_call_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample.sample_posterior(SEED + 7, model, obs, (), sel, mesh=mesh, **kw)
        torch.cuda.synchronize()
        sharded_again_ms = (time.perf_counter() - t0) * 1e3
        out["k1"] = k1
        phase("parallel", f"{smi}: sample_posterior(flagship, {N_CHAINS} chains, {SP_WARMUP} + {SP_SAMPLES} x thin "
                          f"{SP_THIN_CONVERGED}, hmc_sweep, mesh=make_mesh()): {k1} K1 launches (as unsharded), "
                          f"split-R-hat {float(rhat.min()):.4f}-{float(rhat.max()):.4f}, means within {z:.2f} SE of "
                          f"the unsharded call's; a call {sharded_ms:.1f} ms first, {sharded_again_ms:.1f} ms again, "
                          f"unsharded {plain_call_ms:.1f} ms (host clock)")

        # ---- the sharded column NUTS: K4 on the rank's shard
        nuts_pallas.nuts_sweep_launches = 0
        hmc.hmc_sweep_launches = 0
        nkw = dict(n_chains=N_CHAINS, n_steps=NUTS_STEPS, eps=NUTS_EPS0, max_depth=NUTS_DEPTH, warmup=True)
        t0 = time.perf_counter()
        q_s, acc_s, leaps_s, _ = column_nuts(model, obs, (), ["tau", "w"], seed=SEED, mesh=mesh, **nkw)
        torch.cuda.synchronize()
        nuts_ms = (time.perf_counter() - t0) * 1e3
        k4 = nuts_pallas.nuts_sweep_launches
        check(k4 == NUTS_WARMUP_PHASES + 1, f"[parallel] sharded column_nuts made {k4} K4 launches")
        check(hmc.hmc_sweep_launches == 0 and nuts_pallas.pallas_nuts.last_backend == "cuda",
              "[parallel] the sharded NUTS path left K4")
        q_u, acc_u, leaps_u, _ = column_nuts(model, obs, (), ["tau", "w"], seed=SEED + 1, **nkw)
        real_s, real_u = q_s[:9], q_u[:9]
        se = torch.sqrt((real_s.var(dim=1) + real_u.var(dim=1)) / N_CHAINS)
        z_n = float(((real_s.mean(dim=1) - real_u.mean(dim=1)) / se).abs().max())
        check(z_n < 4 and abs(float(acc_s) - float(acc_u)) <= 0.02,
              f"[parallel] sharded NUTS: means {z_n:.2f} SE, accept {float(acc_s)} vs {float(acc_u)}")
        out["k4"] = k4
        phase("parallel", f"{smi}: column_nuts(flagship, {N_CHAINS} chains, warmup=True, mesh): {k4} K4 launches, "
                          f"accept {float(acc_s):.4f} vs {float(acc_u):.4f} unsharded, mean leapfrogs "
                          f"{float(leaps_s):.3f} vs {float(leaps_u):.3f}, tau and w means within {z_n:.2f} SE; "
                          f"{nuts_ms:.1f} ms (host clock)")

        # ---- the sharded particle filter: bench_pf's shape, both modes
        kernel, exact = linear_gaussian_ssm()
        xs = torch.zeros(PF_T, device=device)
        ys_pf = torch.zeros(PF_T, device=device)
        pobs = g.C[:, "y"].set(ys_pf)
        want_pf = exact(ys_pf.cpu().tolist())
        pf = SSMParticleFilter(kernel, n_particles=PF_PARTICLES, ess_threshold=0.5, method="systematic")
        for mode in ("local", "all_gather"):
            lzs, ms_runs = [], []
            for seed in range(PAR_PF_SEEDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = pf.run_sharded(100 + seed, 0.0, xs, pobs, mesh, resample_mode=mode)
                lzs.append(float(r.log_marginal))
                ms_runs.append((time.perf_counter() - t0) * 1e3)
            mean_lz, se_lz, _ = se_gap(lzs, want_pf)
            check(abs(mean_lz - want_pf) <= 4 * se_lz + 0.01,
                  f"[parallel] run_sharded({mode}) log marginal {mean_lz:.5f} (SE {se_lz:.5f}) vs Kalman {want_pf:.5f}")
            reads = host_reads(lambda: pf.run_sharded(200, 0.0, xs, pobs, mesh, resample_mode=mode))
            phase("parallel", f"{smi}: SSMParticleFilter.run_sharded({PF_PARTICLES} particles x T = {PF_T}, "
                              f"resample_mode='{mode}'), {PAR_PF_SEEDS} seeds: mean log marginal {mean_lz:.5f} (SE "
                              f"{se_lz:.5f}) against Kalman's {want_pf:.5f} (limit 4 SE + 0.01); a run "
                              f"{float(np.median(ms_runs)):.1f} ms (host clock, median); host reads a step "
                              f"{reads / PF_T:.3f}")

        # ---- the RBPF: no regime switch (the Kalman oracle), and examples/21's two regimes
        a, q_sd, r_sd = 0.85, 0.6, 0.4
        rng = np.random.default_rng(21)
        zt, ys_rb = 0.0, []
        for _ in range(PAR_RBPF_T):
            zt = a * zt + q_sd * rng.normal()
            ys_rb.append(zt + r_sd * rng.normal())
        ys_rb = torch.tensor(ys_rb, dtype=torch.float32, device=device).reshape(-1, 1)
        mats = tuple(torch.tensor([[v]], device=device) for v in (a, q_sd**2, 1.0, r_sd**2))
        params = LGSSMParams(A=mats[0].double(), Q=mats[1].double(), C=mats[2].double(), R=mats[3].double(),
                             mu0=torch.zeros(1, dtype=torch.float64, device=device), P0=mats[1].double())
        want_rb = float(kalman_filter(params, ys_rb.double())[2])
        lzs = []
        t0 = time.perf_counter()
        for seed in range(3):
            # z_0 = 0 exactly: y_0 observes z_1 ~ N(0, Q), as the data are made
            r = rbpf(seed, lambda gen, u, t: u, lambda u: mats, ys_rb, n_particles=PAR_RBPF_PARTICLES,
                     init_regime=torch.tensor(0, device=device), mu0=torch.zeros(1, device=device),
                     P0=torch.zeros(1, 1, device=device), device=device)
            lzs.append(float(r.log_marginal))
        torch.cuda.synchronize()
        rb_ms = (time.perf_counter() - t0) * 1e3 / 3
        mean_lz, se_lz, _ = se_gap(lzs, want_rb) if len(set(lzs)) > 1 else (lzs[0], 0.0, 0.0)
        check(abs(mean_lz - want_rb) <= 4 * se_lz + 0.01 and bool(torch.isfinite(r.means).all()),
              f"[parallel] rbpf log marginal {mean_lz:.5f} (SE {se_lz:.5f}) vs Kalman {want_rb:.5f}")
        a_reg = torch.tensor([0.85, 0.2], device=device)
        trans = torch.tensor([[0.9, 0.1], [0.3, 0.7]], device=device)

        def two_regimes(u):
            return (a_reg[u].reshape(1, 1), mats[1], mats[2], mats[3])

        r2 = rbpf(1, lambda gen, u, t: (torch.rand((), generator=gen, device=device) < trans[u, 1]).long(),
                  two_regimes, ys_rb[:16], n_particles=1024, init_regime=torch.tensor(0, device=device),
                  mu0=torch.zeros(1, device=device), P0=torch.zeros(1, 1, device=device), device=device)
        p_persist = float((torch.exp(r2.log_weights) * (r2.regimes == 0).float()).sum())
        check(math.isfinite(float(r2.log_marginal)) and 0.0 <= p_persist <= 1.0, "[parallel] two-regime rbpf")
        phase("parallel", f"{smi}: rbpf({PAR_RBPF_PARTICLES} particles x T = {PAR_RBPF_T}, no regime switch): "
                          f"log marginal {mean_lz:.5f} against Kalman's {want_rb:.5f} (limit 4 SE + 0.01), a run "
                          f"{rb_ms:.1f} ms (host clock); examples/21's two regimes at 1024 particles x T = 16: log "
                          f"marginal {float(r2.log_marginal):.4f}, P(final regime = persistent) {p_persist:.3f}")

        # ---- the island filter on a (1, 1) mesh, with its audit
        hier = make_hier_mesh(1, 1)
        ys_is = torch.tensor(np.random.default_rng(3).normal(size=PAR_ISLAND_T) * 0.8, dtype=torch.float32,
                             device=device)
        ipf = IslandParticleFilter(kernel, n_particles=PAR_ISLAND_PARTICLES, exchange_every=PAR_ISLAND_EVERY)
        iobs, ixs = g.C[:, "y"].set(ys_is), torch.zeros(PAR_ISLAND_T, device=device)
        t0 = time.perf_counter()
        with collective_log() as log:
            ires = ipf.run_sharded(7, 0.0, ixs, iobs, hier)
        torch.cuda.synchronize()
        is_ms = (time.perf_counter() - t0) * 1e3
        lzs = [float(ires.log_marginal)] + [float(ipf.run_sharded(8 + s, 0.0, ixs, iobs, hier).log_marginal)
                                            for s in range(PAR_ISLAND_SEEDS - 1)]
        want_is = exact(ys_is.cpu().tolist())
        mean_is = float(np.mean(lzs))
        n_ex = int(ires.n_exchanges)
        check(abs(mean_is - want_is) <= 0.15 and n_ex == PAR_ISLAND_T // PAR_ISLAND_EVERY,
              f"[parallel] islands: mean log marginal {mean_is:.4f} vs {want_is:.4f}, {n_ex} exchanges")
        counts = collective_counts(log)
        island_ops = [o for o in counts["ops"] if o["group"] == "island"]
        check(all(o["kind"] == "all-gather" for o in island_ops)
              and all(o["group"] == "batch" for o in counts["ops"] if o["per_step"] and o["kind"] == "all-reduce"),
              f"[parallel] islands: a per-step all-reduce left the batch axis: {counts['ops']}")
        phase("parallel", f"{smi}: IslandParticleFilter.run_sharded({PAR_ISLAND_PARTICLES} particles x T = "
                          f"{PAR_ISLAND_T}, exchange_every={PAR_ISLAND_EVERY}, mesh (1, 1)), {PAR_ISLAND_SEEDS} "
                          f"seeds: mean log marginal {mean_is:.4f} (runs {min(lzs):.4f} to {max(lzs):.4f}) against "
                          f"Kalman's {want_is:.4f} (limit 0.15), {n_ex} exchanges, the first run {is_ms:.1f} ms "
                          f"(host clock); its collectives {counts['count']} "
                          f"({counts['by_kind']}), per step {counts['per_step']}, once {counts['once_per_run']}")

        # ---- the data-sharded and tensor-parallel densities against their twins
        gen = torch.Generator(device=device).manual_seed(3)
        Xd = torch.randn(PAR_DATA_ROWS, PAR_DATA_D, generator=gen, device=device)
        yd = (torch.rand(PAR_DATA_ROWS, generator=gen, device=device)
              < torch.sigmoid(Xd @ torch.linspace(-1, 1, PAR_DATA_D, device=device))).float()

        def lprior(q):
            return -0.5 * torch.sum(q**2, dim=0)

        def llik(q, shard):
            x, yy = shard
            logits = x @ q
            return torch.sum(yy[:, None] * torch.nn.functional.logsigmoid(logits)
                             + (1.0 - yy[:, None]) * torch.nn.functional.logsigmoid(-logits), dim=0)

        mesh2 = make_mesh_2d((1, 1))
        ld_data = data_sharded_logdensity(lprior, llik, (Xd, yd), mesh2)
        qd = (0.3 * torch.randn(PAR_DATA_D, PAR_DATA_CHAINS, generator=gen, device=device)).requires_grad_(True)
        v_s = ld_data(qd)
        (g_s,) = torch.autograd.grad(v_s.sum(), qd)
        v_u = lprior(qd) + llik(qd, (Xd, yd))
        (g_u,) = torch.autograd.grad(v_u.sum(), qd)
        v_s, v_u = v_s.detach(), v_u.detach()
        err_d = max(float(((v_s - v_u).abs() / v_u.abs().clamp_min(1.0)).max()),
                    float(((g_s - g_u).abs() / g_u.abs().clamp_min(1.0)).max()))
        check(err_d <= 1e-5, f"[parallel] data-sharded density against the unsharded: {err_d:.3g}")
        qf, acc_d = hmc.pallas_hmc(ld_data, qd.detach(), SEED, n_steps=20, eps=0.01, L=5, backend="torch")
        check(hmc.pallas_hmc.last_backend == "torch" and bool(torch.isfinite(qf).all()),
              "[parallel] pallas_hmc(backend='torch') on the data-sharded density")
        try:
            hmc.pallas_hmc(ld_data, qd.detach(), SEED, n_steps=1, eps=0.01, L=5)
            raised = None
        except ValueError as e:
            raised = str(e)
        check(raised is not None and "backend='torch'" in raised,
              "[parallel] backend='auto' on the data-sharded density did not raise")
        mesh_tp = make_mesh_2d((1, 1), axes=("model", "batch"))
        Xb = torch.randn(PAR_BNN_M, PAR_BNN_D_IN, generator=gen, device=device)
        yb = torch.randn(PAR_BNN_M, generator=gen, device=device)
        ld_tp = tp_bnn_logdensity(Xb, yb, PAR_BNN_HIDDEN, mesh_tp)
        ld_ref = bnn_logdensity_reference(Xb, yb, PAR_BNN_HIDDEN)
        qb = (0.3 * torch.randn(PAR_BNN_HIDDEN * (PAR_BNN_D_IN + 2), PAR_BNN_CHAINS, generator=gen,
                                device=device))
        qb_s = shard_params(qb, mesh_tp).requires_grad_(True)
        v_s = ld_tp(qb_s)
        (g_s,) = torch.autograd.grad(v_s.sum(), qb_s)
        qb_u = qb.clone().requires_grad_(True)
        v_u = ld_ref(qb_u)
        (g_u,) = torch.autograd.grad(v_u.sum(), qb_u)
        v_s, v_u = v_s.detach(), v_u.detach()
        err_t = max(float(((v_s - v_u).abs() / v_u.abs().clamp_min(1.0)).max()),
                    float(((g_s - g_u).abs() / g_u.abs().clamp_min(1.0)).max()))
        check(err_t <= 1e-5, f"[parallel] tensor-parallel density against the unsharded: {err_t:.3g}")
        phase("parallel", f"{smi}: data_sharded_logdensity (logistic, {PAR_DATA_ROWS} rows x {PAR_DATA_D}, "
                          f"{PAR_DATA_CHAINS} chains, mesh (1, 1)) value and gradient within {err_d:.3g} of the "
                          f"unsharded (limit 1e-5, relative past 1); pallas_hmc(backend='torch') on it ran, accept "
                          f"{float(acc_d):.4f}; backend='auto' raised for want of a device body; tp_bnn_logdensity "
                          f"(hidden {PAR_BNN_HIDDEN}, d_in {PAR_BNN_D_IN}, {PAR_BNN_M} rows, {PAR_BNN_CHAINS} chains) "
                          f"within {err_t:.3g} of bnn_logdensity_reference")
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "[parallel] the process group outlived the phase")
    phase("parallel", f"the parallel phase took {time.perf_counter() - t_par:.1f} s; group destroyed")
    return out


def dense_target(device):
    """``bench.py::bench_dense``'s target: ``Sigma* = A A^T / d + 0.05 I``
    with ``A`` from numpy seed 0, as the ``@gen`` model ``x ~ mv_normal(0,
    Sigma*)`` with its parameters on the card. Returns the model and
    ``Sigma*`` in float64 on the host."""
    import genjax_tpu_torch as g

    rng = np.random.default_rng(0)
    A = rng.normal(size=(DENSE_D, DENSE_D))
    sigma = A @ A.T / DENSE_D + 0.05 * np.eye(DENSE_D)
    loc = torch.zeros(DENSE_D, device=device)
    cov = torch.as_tensor(sigma, dtype=torch.float32, device=device)

    @g.gen
    def correlated():
        return g.mv_normal(loc, cov) @ "x"

    return correlated, sigma


def cov_error(draws: torch.Tensor, sigma: np.ndarray) -> float:
    """Relative Frobenius error of the sample covariance of ``draws (n,
    d)`` against ``sigma``."""
    s = np.cov(draws.double().cpu().numpy(), rowvar=False)
    return float(np.linalg.norm(s - sigma) / np.linalg.norm(sigma))


def cov_bound(sigma: np.ndarray, n: int) -> float:
    """``DENSE_COV_FACTOR`` times the RMS relative Frobenius error of the
    sample covariance of ``n`` independent exact draws, ``sqrt((tr(S)^2 +
    |S|_F^2) / n) / |S|_F`` for a Gaussian. Draws pooled over several
    samples a chain hold at least ``n`` independent ones' worth, so this is
    an upper bound on their error's scale."""
    fro2 = float(np.sum(sigma * sigma))
    return DENSE_COV_FACTOR * math.sqrt((np.trace(sigma) ** 2 + fro2) / n) / math.sqrt(fro2)


def column_samplers_path(device, smi: str, g, hmc, nuts_pallas, elliptical, model, y, ref_draws) -> None:
    """The column samplers, which have no kernel in either package, on the
    card at full width through their entry points: ``sample_posterior``
    with ``"chees"``, ``"pt"``, ``"dense_hmc"`` and ``"dense_nuts"``,
    ``sample_logdensity``, ``column_hmc(mass="dense")`` and ``column_svgd``.
    The flagship's moments are held against the last half of ``ref_draws``,
    the ``(chains, samples, 9)`` draws of ``tau`` and ``w`` of
    ``sample_posterior(hmc_sweep)`` at thin 10 (K1, split-R-hat under 1.05):
    its first half still drifts in ``tau`` (the reference's own halves are
    3.77 SE apart at 65,536 chains; scripts/column_samplers_probe.py
    moments). Each phase prints its line, then holds its gates."""
    from genjax_tpu_torch.inference import sample
    from genjax_tpu_torch.kernels import column_hmc, column_svgd, svgd
    from genjax_tpu_torch.kernels.model_interface import column_logdensity, init_columns

    sel = g.S["w"] | g.S["tau"]
    obs = g.C["y"].set(torch.as_tensor(y, device=device))
    half = ref_draws.shape[1] // 2
    z_halves = chain_means_z(ref_draws[:, :half], ref_draws[:, half:])
    ref_draws = ref_draws[:, half:]

    def launches():
        return hmc.hmc_sweep_launches + nuts_pallas.nuts_sweep_launches + elliptical.ess_gauss_sweep_launches

    def flat(r):
        return torch.cat([r["tau"][:, :, None], r["w"]], dim=2)

    def rhat_max(r):
        return float(torch.cat([r.rhat_of("tau").reshape(1), r.rhat_of("w")]).max())

    def gated(name: str, line: str, gates) -> None:
        phase(name, line)
        for ok, what in gates:
            check(ok, what)

    timings = {}

    def timed(name, fn):
        """Run ``fn`` once on the host clock, ended by a synchronise; the
        kernels' launch counts must not move (no kernel on these paths)."""
        before = launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        timings[name] = time.perf_counter() - t0
        check(launches() == before, f"{name} launched a kernel")
        return out

    # ---- ChEES on the flagship
    res = timed("chees", lambda: sample.sample_posterior(
        SEED, model, obs, (), sel, n_chains=N_CHAINS, n_warmup=CS_WARMUP, n_samples=CS_SAMPLES,
        thin=CHEES_THIN, algorithm="chees", eps0=CHEES_EPS0, target_accept=CHEES_TARGET, device=device))
    d = flat(res)
    hi, z, acc = rhat_max(res), chain_means_z(d, ref_draws), float(res.accept_rate)
    gated("main path sample_posterior chees",
          f"sample_posterior(hierarchical_regression, S[w] | S[tau], {N_CHAINS} chains, n_warmup={CS_WARMUP}, "
          f"n_samples={CS_SAMPLES}, thin={CHEES_THIN}, eps0={CHEES_EPS0}, target_accept={CHEES_TARGET}, "
          f"algorithm='chees') on the card, no kernel: {timings['chees']:.2f} s, draws {tuple(d.shape)}, "
          f"split-R-hat of tau, w up to {hi:.4f} (limit 1.05 at thin {CHEES_THIN}), accept {acc:.4f} (limit "
          f"{CHEES_TARGET} +- 0.05), eps {float(res.eps):.6g}, divergence rate {float(res.divergence_rate):.4f}; "
          f"tau and w_j means within {z:.2f} pooled MC standard errors of the last {ref_draws.shape[1]} of K1's "
          f"thin-10 draws (limit 4; K1's first {half} against its last: {z_halves:.2f})",
          [(tuple(d.shape) == (N_CHAINS, CS_SAMPLES, 9) and d.is_cuda and bool(torch.isfinite(d).all()),
            f"chees draws {tuple(d.shape)} on {d.device}"),
           (hi < 1.05, f"chees: split-R-hat up to {hi:.4f} at thin {CHEES_THIN} (limit 1.05)"),
           (z < 4, f"chees: tau, w means {z:.2f} MC standard errors from K1's (limit 4)"),
           (abs(acc - CHEES_TARGET) <= 0.05, f"chees: accept {acc:.4f}, target {CHEES_TARGET} (limit 0.05)")])

    # ---- sample_logdensity: the raw-density twin, from the same q0
    gen = torch.Generator(device=device).manual_seed(SEED)
    _packer, ld, q0_l = sample._column_prep(gen, model, obs, (), sel, N_CHAINS, device)
    res_l = timed("sample_logdensity", lambda: sample.sample_logdensity(
        SEED + 1, ld, q0_l, n_warmup=CS_WARMUP, n_samples=CS_SAMPLES, thin=CHEES_THIN, eps0=CHEES_EPS0))
    d_l = res_l.draws[:, :, :9]
    z_l, rh_l = chain_means_z(d_l, ref_draws), float(res_l.rhat[:9].max())
    gated("main path sample_logdensity",
          f"sample_logdensity(the flagship's column_logdensity, the same q0 {tuple(q0_l.shape)} on the card, "
          f"n_warmup={CS_WARMUP}, n_samples={CS_SAMPLES}, thin={CHEES_THIN}): {timings['sample_logdensity']:.2f} s, "
          f"split-R-hat of tau, w up to {rh_l:.4f} (limit 1.05), accept {float(res_l.accept_rate):.4f}, tau and "
          f"w_j means within {z_l:.2f} pooled MC standard errors of K1's (limit 4)",
          [(d_l.is_cuda and bool(torch.isfinite(d_l).all()), "sample_logdensity draws"),
           (z_l < 4, f"sample_logdensity: means {z_l:.2f} MC standard errors from K1's (limit 4)"),
           (rh_l < 1.05, f"sample_logdensity: split-R-hat up to {rh_l:.4f} (limit 1.05)")])

    # ---- parallel tempering: the flagship, and the bimodal toy
    res_p = timed("pt", lambda: sample.sample_posterior(
        SEED, model, obs, (), sel, n_chains=N_CHAINS, n_warmup=CS_WARMUP, n_samples=CS_SAMPLES,
        algorithm="pt", eps0=CHEES_EPS0, L=PT_L, n_rungs=PT_RUNGS, device=device))
    d_p = flat(res_p)
    z_p = chain_means_z(d_p, ref_draws)

    @g.gen
    def bimodal():
        mu = g.normal(0.0, 10.0) @ "mu"
        _ = g.normal(mu * mu, 1.0) @ "y"

    res_b = timed("pt toy", lambda: sample.sample_posterior(
        SEED, bimodal, g.C["y"].set(4.0), (), g.S["mu"], n_chains=PT_TOY_CHAINS, n_warmup=200, n_samples=200,
        algorithm="pt", eps0=0.05, L=8, n_rungs=5, device=device))
    mu = res_b["mu"][:, 100:]
    frac, abs_mu = float((mu > 0).float().mean()), float(mu.abs().mean())
    gated("main path sample_posterior pt",
          f"flagship, {N_CHAINS} chains x {PT_RUNGS} rungs, n_warmup={CS_WARMUP}, n_samples={CS_SAMPLES}, "
          f"eps0={CHEES_EPS0}, L={PT_L}: {timings['pt']:.2f} s, split-R-hat up to {rhat_max(res_p):.4f}, cold "
          f"accept {float(res_p.accept_rate):.4f}, tau and w_j means within {z_p:.2f} MC standard errors of "
          f"K1's (limit 4), divergence rate {float(res_p.divergence_rate)}; the bimodal toy of "
          f"tests/kernels/test_pt.py (mu ~ N(0, 10), y ~ N(mu^2, 1), y = 4) at {PT_TOY_CHAINS} chains x 5 "
          f"rungs, 200 + 200 sweeps: {timings['pt toy']:.2f} s, {frac:.4f} of the last 100 draws positive "
          f"(limit 0.5 +- 0.1), mean |mu| {abs_mu:.4f} (limit 2 +- 0.1)",
          [(d_p.is_cuda and bool(torch.isfinite(d_p).all()), "pt draws"),
           (z_p < 4, f"pt: tau, w means {z_p:.2f} MC standard errors from K1's (limit 4)"),
           (float(res_p.divergence_rate) == 0.0, "pt: a divergence rate"),
           (abs(frac - 0.5) <= 0.1, f"pt toy: {frac:.4f} of the draws in the positive mode (limit 0.5 +- 0.1)"),
           (abs(abs_mu - 2.0) <= 0.1, f"pt toy: mean |mu| {abs_mu:.4f} (limit 2 +- 0.1)")])

    # ---- the dense metric on bench_dense's 128-d correlated Gaussian
    dense, sigma = dense_target(device)
    diag = np.diag(sigma)
    res_d = timed("dense_hmc", lambda: sample.sample_posterior(
        SEED, dense, g.ChoiceMap.empty(), (), g.S["x"], n_chains=DENSE_CHAINS, n_warmup=DENSE_WARMUP,
        n_samples=CS_SAMPLES, algorithm="dense_hmc", eps0=DENSE_EPS0, L=DENSE_L, device=device))
    x = res_d["x"]
    err_d, bound_d = cov_error(x.reshape(-1, DENSE_D), sigma), cov_bound(sigma, DENSE_CHAINS)
    im_d = float(np.max(np.abs(res_d.inv_mass.double().cpu().numpy() / diag - 1.0)))
    im_bound = 5.0 * math.sqrt(2.0 / DENSE_CHAINS)
    q_c, acc_c, _packer = timed("column_hmc dense", lambda: column_hmc(
        dense, g.ChoiceMap.empty(), (), ["x"], n_chains=DENSE_CHAINS, n_steps=CS_SAMPLES, eps=DENSE_EPS0,
        L=DENSE_L, seed=SEED, warmup=True, mass="dense", device=device))
    err_c = cov_error(q_c[:DENSE_D].T, sigma)
    res_n = timed("dense_nuts", lambda: sample.sample_posterior(
        SEED, dense, g.ChoiceMap.empty(), (), g.S["x"], n_chains=DENSE_NUTS_CHAINS, n_warmup=DENSE_WARMUP,
        n_samples=DENSE_NUTS_SAMPLES, algorithm="dense_nuts", eps0=DENSE_EPS0, max_depth=DENSE_NUTS_DEPTH,
        device=device))
    x_n = res_n["x"]
    err_n, bound_n = cov_error(x_n.reshape(-1, DENSE_D), sigma), cov_bound(sigma, DENSE_NUTS_CHAINS)
    im_n = float(np.max(np.abs(res_n.inv_mass.double().cpu().numpy() / diag - 1.0)))
    im_bound_n = 5.0 * math.sqrt(2.0 / DENSE_NUTS_CHAINS)
    gated("main path dense",
          f"bench_dense's Sigma* (D={DENSE_D}, A A^T/d + 0.05 I, numpy seed 0) as x ~ mv_normal(0, Sigma*): "
          f"sample_posterior(dense_hmc, {DENSE_CHAINS} chains, n_warmup={DENSE_WARMUP}, n_samples={CS_SAMPLES}, "
          f"eps0={DENSE_EPS0}, L={DENSE_L}) {timings['dense_hmc']:.2f} s, accept {float(res_d.accept_rate):.4f}, "
          f"eps {float(res_d.eps):.6g}, covariance error {err_d:.4f} (relative Frobenius; limit {bound_d:.4f} = "
          f"{DENSE_COV_FACTOR} x the RMS error of {DENSE_CHAINS} exact draws), inv_mass within {im_d:.4f} of "
          f"diag(Sigma*) (limit {im_bound:.4f} = 5 sqrt(2/N)); column_hmc(mass='dense', warmup=True, "
          f"{CS_SAMPLES} steps) {timings['column_hmc dense']:.2f} s, accept {float(acc_c):.4f}, covariance "
          f"error {err_c:.4f} (limit {bound_d:.4f}); sample_posterior(dense_nuts, {DENSE_NUTS_CHAINS} chains, "
          f"depth {DENSE_NUTS_DEPTH}, n_samples={DENSE_NUTS_SAMPLES}) {timings['dense_nuts']:.2f} s, accept "
          f"{float(res_n.accept_rate):.4f}, white eps {float(res_n.eps):.6g}, divergence rate "
          f"{float(res_n.divergence_rate):.4f}, covariance error {err_n:.4f} (limit {bound_n:.4f}), inv_mass "
          f"within {im_n:.4f} (limit {im_bound_n:.4f})",
          [(tuple(x.shape) == (DENSE_CHAINS, CS_SAMPLES, DENSE_D) and x.is_cuda and bool(torch.isfinite(x).all()),
            f"dense_hmc draws {tuple(x.shape)}"),
           (err_d < bound_d, f"dense_hmc: covariance error {err_d:.4f} (limit {bound_d:.4f})"),
           (im_d < im_bound, f"dense_hmc: inv_mass off diag(Sigma*) by {im_d:.4f} (limit {im_bound:.4f})"),
           (err_c < bound_d, f"column_hmc(mass='dense'): covariance error {err_c:.4f} (limit {bound_d:.4f})"),
           (bool(torch.isfinite(x_n).all()) and err_n < bound_n,
            f"dense_nuts: covariance error {err_n:.4f} (limit {bound_n:.4f})"),
           (im_n < im_bound_n, f"dense_nuts: inv_mass off diag(Sigma*) by {im_n:.4f} (limit {im_bound_n:.4f})")])

    # ---- SVGD on the flagship: the means against K1's; the card against the CPU
    q_s, packer_s = timed("column_svgd", lambda: column_svgd(
        model, obs, (), ["tau", "w"], n_particles=SVGD_PARTICLES, n_steps=SVGD_STEPS, seed=SEED, device=device))
    ref_flat = ref_draws.reshape(-1, 9)
    ref_mean, ref_sd = ref_flat.mean(dim=0), ref_flat.std(dim=0)
    gap = (q_s.mean(dim=1) - ref_mean).abs() / ref_sd
    pad = packer_s.padded_dim - packer_s.dim
    q0 = init_columns(model, obs, (), packer_s, SVGD_PARTICLES, SEED, device)[: packer_s.dim]

    def on_real_rows(ld):
        return lambda q: ld(torch.cat([q, q.new_zeros((pad, q.shape[1]))]))

    ld_card = on_real_rows(column_logdensity(model, obs, (), packer_s))
    ld_cpu = on_real_rows(column_logdensity(model, g.C["y"].set(torch.as_tensor(y)), (), packer_s))
    same = torch.equal(svgd(ld_card, q0, n_steps=SVGD_STEPS, step_size=0.15), q_s)
    agree = []
    for steps in (SVGD_AGREE_STEPS, SVGD_CHAOS_STEPS):
        a = svgd(ld_card, q0, n_steps=steps, step_size=0.15).cpu()
        b = svgd(ld_cpu, q0.cpu(), n_steps=steps, step_size=0.15)
        agree.append((steps, torch.allclose(a.mean(dim=1), b.mean(dim=1), rtol=1e-3, atol=1e-4),
                      torch.allclose(a, b, rtol=1e-3, atol=1e-5), float((a - b).abs().max()),
                      float((a.mean(dim=1) - b.mean(dim=1)).abs().max())))
    gated("main path svgd",
          f"column_svgd(flagship, {SVGD_PARTICLES} particles, {SVGD_STEPS} steps, step 0.15, AdaGrad) on the card: "
          f"{timings['column_svgd']:.2f} s, no kernel, particles finite {bool(torch.isfinite(q_s).all())}; tau, w "
          f"means within {float(gap.max()):.3f} posterior sds of K1's (limit {SVGD_MEAN_BOUND}; tau "
          f"{float(q_s[0].mean()):.4f} vs {float(ref_mean[0]):.4f}; {int((q_s[0] <= 0).sum())} particles at "
          f"tau <= 0); a second card run from the same q0 equal bit for bit: {same}; the card against the CPU "
          f"from the same q0: " + "; ".join(
              f"{n} steps: means allclose(rtol 1e-3, atol 1e-4) {m_ok}, particles allclose(rtol 1e-3, atol "
              f"1e-5) {ok}, max abs {err:.3g}, means {mgap:.3g} apart"
              for n, m_ok, ok, err, mgap in agree) + f" (the means gated at {SVGD_AGREE_STEPS} steps)",
          [(tuple(q_s.shape) == (9, SVGD_PARTICLES) and q_s.is_cuda and bool(torch.isfinite(q_s).all()),
            f"column_svgd particles {tuple(q_s.shape)}"),
           (bool((gap < SVGD_MEAN_BOUND).all()),
            f"column_svgd: tau, w means {gap.tolist()} posterior sds from K1's (limit {SVGD_MEAN_BOUND})"),
           (agree[0][1], f"column_svgd: the particles' means on the card and the CPU differ after "
                         f"{SVGD_AGREE_STEPS} steps by {agree[0][4]:.3g} (rtol 1e-3, atol 1e-4)")])

    # ---- timing: a call of each at cut depth (4 + 1 sweeps or transitions,
    # 5 steps), host clock, median of 3, and the card's busy share
    small = dict(n_warmup=4, n_samples=1, device=device)
    calls = {
        "chees (4 + 1 sweeps)": lambda: sample.sample_posterior(
            SEED, model, obs, (), sel, n_chains=N_CHAINS, algorithm="chees", eps0=CHEES_EPS0,
            target_accept=CHEES_TARGET, **small),
        "sample_logdensity (4 + 1 sweeps)": lambda: sample.sample_logdensity(
            SEED, ld, q0_l, eps0=CHEES_EPS0, n_warmup=4, n_samples=1),
        f"pt ({PT_RUNGS} rungs, 4 + 1 sweeps)": lambda: sample.sample_posterior(
            SEED, model, obs, (), sel, n_chains=N_CHAINS, algorithm="pt", eps0=CHEES_EPS0, L=PT_L,
            n_rungs=PT_RUNGS, **small),
        "dense_hmc (4 + 1 transitions)": lambda: sample.sample_posterior(
            SEED, dense, g.ChoiceMap.empty(), (), g.S["x"], n_chains=DENSE_CHAINS, algorithm="dense_hmc",
            eps0=DENSE_EPS0, L=DENSE_L, **small),
        "dense_nuts (4 + 1 transitions)": lambda: sample.sample_posterior(
            SEED, dense, g.ChoiceMap.empty(), (), g.S["x"], n_chains=DENSE_NUTS_CHAINS, algorithm="dense_nuts",
            eps0=DENSE_EPS0, max_depth=DENSE_NUTS_DEPTH, **small),
        "column_svgd (5 steps)": lambda: column_svgd(
            model, obs, (), ["tau", "w"], n_particles=SVGD_PARTICLES, n_steps=5, seed=SEED, device=device),
    }
    for name, fn in calls.items():
        call_ms = wall_ms(fn)
        phase("timing column samplers", f"{smi}: {name}: a call {call_ms:.3f} ms (host clock, median of 3); "
                                        + busy_line("a call", device_busy(fn), call_ms))

_U32 = 0xFFFFFFFF


def _mulhilo32(a, m: int):
    """The high and low words of ``a * m`` for ``a`` an int64 tensor of
    uint32 values and ``m`` a uint32, by 16-bit halves (no int64 overflow)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh, hl, hh = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo, a_hi * m_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    return hh + (lh >> 16) + (hl >> 16) + (mid >> 16), ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)


def philox4x32_10(c, k):
    """Philox4x32-10 (Salmon et al. 2011; curand_Philox4x32_10) on int64
    tensors holding uint32 words: the plain version of K2's Philox stream."""
    c0, c1, c2, c3 = c
    k0, k1 = k
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _U32, (k1 + 0xBB67AE85) & _U32
        hi0, lo0 = _mulhilo32(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo32(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_u01(w):
    """The Philox stream's uniform (``column_common.cuh::philox_u01``) of
    uint32 words in int64 tensors: ``(2m + 1) 2^-24`` for ``m`` the low 23
    bits, float32 (exact)."""
    return (((w & 0x7FFFFF) * 2 + 1).double() * 2.0**-24).float()


def box_muller_plain(words):
    """The four normals ``philox_normals4`` makes of one call's words, in
    float64 and rounded to float32 once: radii ``sqrt(-2 ln u)`` from words 0
    and 2, angles ``2 pi u - pi`` from words 1 and 3. Stacked on a new axis
    after the words' leading axes' first two (``(..., 4, n)`` for words
    ``(..., n)``)."""
    u = [philox_u01(w).double() for w in words]
    r0, r1 = torch.sqrt(-2.0 * torch.log(u[0])), torch.sqrt(-2.0 * torch.log(u[2]))
    a0, a1 = 2 * math.pi * u[1] - math.pi, 2 * math.pi * u[3] - math.pi
    return torch.stack([r0 * torch.cos(a0), r0 * torch.sin(a0), r1 * torch.cos(a1), r1 * torch.sin(a1)],
                       dim=-2).float()


def philox_k1_counters(steps: int, D: int):
    """The Philox counters K1 draws one chain's sweep at (``hmc_sweep.cu``):
    ``(counter, word)`` for each number, ``word`` None where a call makes
    four normals: the momenta at ``(step, j, 0, 0)``, ``j < D / 4``, and the
    accept uniform of step ``i`` at word ``i % 4`` of ``(i // 4, 0, 2, 0)``
    (``PhiloxUniforms``)."""
    normals = [((i, j, 0, 0), None) for i in range(steps) for j in range(D // 4)]
    uniforms = [((i // 4, 0, 2, 0), i % 4) for i in range(steps)]
    return normals, uniforms


def philox_k4_counters(n_steps: int, max_depth: int, D: int):
    """The Philox counters K4 draws one chain's sweep at
    (``nuts_sweep.cu``), for trees that double ``max_depth`` times with every
    leaf integrated (the most draws a sweep makes): the salt starts at 1 and
    moves by 4 a draw; r0 at ``(salt, j, 1, 0)``; a direction, a leaf and a
    subtree's uniform at word ``m % 4`` of ``(m // 4, 0, 2, 0)``, ``m = salt
    // 4``. ``(normals, uniforms)`` as in ``philox_k1_counters``."""
    normals, uniforms = [], []
    salt = 1

    def uniform():
        nonlocal salt
        uniforms.append(((salt // 4 // 4, 0, 2, 0), salt // 4 % 4))
        salt += 4

    for _ in range(n_steps):
        normals += [((salt, j, 1, 0), None) for j in range(D // 4)]
        salt += 4
        for j in range(max_depth):
            uniform()  # the direction
            for _ in range(2**j):
                uniform()  # a leaf
            uniform()  # the subtree's acceptance
        salt += 4
    return normals, uniforms


def philox_k1_stream(seed: int, n: int, steps: int, D: int, device):
    """The plain version of K1's Philox draws (``philox_normals4`` at
    ``(step, j, 0, 0)``, the accept uniforms four steps a call at ``(step //
    4, 0, 2, 0)``, keyed by ``(seed, chain)``; ``philox_k1_counters``):
    normals ``(steps, D, n)`` and uniforms ``(steps, n)``."""
    key = (torch.full((1, 1, 1), seed & _U32, device=device), torch.arange(n, device=device).view(1, 1, -1))
    shape = (steps, D // 4, n)
    step = torch.arange(steps, device=device).view(-1, 1, 1).expand(shape)
    draw = torch.arange(D // 4, device=device).view(1, -1, 1).expand(shape)
    zero = torch.zeros(shape, dtype=torch.int64, device=device)
    z = box_muller_plain(philox4x32_10((step, draw, zero, zero), key))
    shape = ((steps + 3) // 4, 1, n)
    group = torch.arange(shape[0], device=device).view(-1, 1, 1).expand(shape)
    zero = torch.zeros(shape, dtype=torch.int64, device=device)
    words = torch.cat(philox4x32_10((group, zero, zero + 2, zero), key), dim=1)  # (groups, 4, n)
    return z.reshape(steps, D, n), philox_u01(words.reshape(-1, n)[:steps])


def k2_domain(device, smi: str, lib) -> dict:
    """The Philox stream's Box-Muller over its whole domain: ``k2_transform``
    runs the kernels' own radius (on ``u1``) and angle (on ``u2``) at all
    2^23 uniforms ``philox_u01`` gives, held against float64 Box-Muller of
    the same uniforms. A normal ``r c`` of any pair errs by at most
    ``|r - r64| (1 + e_trig) + r64 e_trig`` plus the product's rounding (half
    an ulp, ``r 2^-24``), with ``e_trig`` the largest error of the cosine and
    sine over all ``u2``: that bound is the largest absolute error of the
    normals over all 2^46 pairs, gated by ``u1``'s region."""
    import ctypes

    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k2_transform.argtypes = [P, P, P, I, P]
    lib.k2_transform.restype = I
    count = 1 << 23
    radius, cos_k, sin_k = (torch.empty(count, device=device) for _ in range(3))
    err = lib.k2_transform(radius.data_ptr(), cos_k.data_ptr(), sin_k.data_ptr(), count,
                           torch.cuda.current_stream(device).cuda_stream)
    check(err == 0, f"k2_transform launch failed with CUDA error {err}")
    torch.cuda.synchronize()
    nonfinite = int((~torch.isfinite(radius)).sum() + (~torch.isfinite(cos_k)).sum()
                    + (~torch.isfinite(sin_k)).sum())
    u = (torch.arange(count, device=device, dtype=torch.float64) * 2 + 1) * 2.0**-24
    r64 = torch.sqrt(-2.0 * torch.log(u))
    angle = 2 * math.pi * u - math.pi
    e_r = (radius.double() - r64).abs()
    e_trig = float(torch.maximum((cos_k.double() - torch.cos(angle)).abs(),
                                 (sin_k.double() - torch.sin(angle)).abs()).max())
    bound = e_r * (1 + e_trig) + r64 * (e_trig + 2.0**-24)
    top = u > 1 - 2.0**-16
    low_max, top_max = float(bound[~top].max()), float(bound[top].max())
    # the normals themselves on two pairings of u1 with u2, as the kernel
    # multiplies them
    direct = []
    for shift in (0, 4_194_301):
        gap = ((radius * torch.roll(cos_k, shift)).double() - r64 * torch.cos(torch.roll(angle, shift))).abs()
        direct.append((float(gap[~top].max()), float(gap[top].max())))
        del gap
    phase("K2 domain", f"{smi}: the Philox stream's radius on all {count} values of u1 and angle on all "
                       f"{count} of u2 (the 23-bit uniforms), against float64 Box-Muller: {nonfinite} "
                       f"non-finite; radius max abs err {float(e_r[~top].max()):.3g} for u1 <= 1 - 2^-16, "
                       f"{float(e_r[top].max()):.3g} above; cosine and sine max abs err {e_trig:.3g}; the "
                       f"normals of every pair within {low_max:.3g} for u1 <= 1 - 2^-16 (limit "
                       f"{K2_DOMAIN_TOL}) and {top_max:.3g} above (limit {K2_DOMAIN_TOP_TOL}); measured on "
                       f"two pairings: {direct[0][0]:.3g} and {direct[1][0]:.3g} below, {direct[0][1]:.3g} "
                       f"and {direct[1][1]:.3g} above")
    check(nonfinite == 0, f"the Philox transform gave {nonfinite} non-finite values")
    check(low_max <= K2_DOMAIN_TOL and top_max <= K2_DOMAIN_TOP_TOL,
          f"the Philox normals err by up to {low_max:.3g} (u1 <= 1 - 2^-16) and {top_max:.3g} above")
    return {"nonfinite": nonfinite, "max_abs_err": max(low_max, top_max), "max_abs_err_low": low_max,
            "max_abs_err_top": top_max, "trig_max_abs_err": e_trig}


def k2_sass(lib) -> dict:
    """SASS instruction counts of K2 alone's folded kernels (the
    generation's hot loop, which makes one step's numbers: five Philox calls
    in the code, of which the redesign's accept uniform runs one step in
    four) and of ``k2_transform_kernel``, from ``cuobjdump -sass``."""
    counts = sass_loops(sass_of(lib))
    out = {}
    for mangled, c in counts.items():
        m = re.search(r"k2_stream_kernelILi(\d)ELb1E", mangled)
        if m:
            out[{"0": "counter", "1": "philox", "2": "philox_before"}[m.group(1)]] = c
        elif "k2_transform_kernel" in mangled:
            out["transform"] = c
    return out


def k2_own(device, smi: str, hmc, lib, entry: dict) -> dict:
    """K2 alone (``csrc/k2_stream.cu``, the device functions K1 draws with):
    the counter variant bit for bit against the torch port of the counter
    stream, the Philox variant against ``philox_k1_stream`` and in law
    (moments, and Kolmogorov-Smirnov on one sweep's normals), the variant
    before the redesign in law, the transform over its whole domain
    (``k2_domain``), the SASS of the generation, and the three variants' time
    making one flagship K1 sweep's normals and uniforms, written out and
    folded into one store a chain, beside K2's bound and ``torch.randn`` +
    ``torch.rand`` (``k2_line``). Returns ``entry`` with K2's own numbers;
    ``launches`` counts the timed Philox run's launches."""
    import ctypes

    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k2_stream.argtypes = [P, P, I, I, I, I, I, I, P]
    lib.k2_stream.restype = I
    D = lib.k2_stream_dim()
    stream = torch.cuda.current_stream(device).cuda_stream
    launched = [0]

    def launch(rng: int, n: int, steps: int, out=None, fold: int = 0):
        normals, uniforms = out if out is not None else (
            torch.empty((steps, D, n), device=device), torch.empty((steps, n), device=device))
        err = lib.k2_stream(normals.data_ptr(), uniforms.data_ptr(), n, steps, SEED, rng, fold, BLOCK_N,
                            stream)
        check(err == 0, f"k2_stream launch failed with CUDA error {err}")
        launched[0] += 1
        return normals, uniforms

    # the counter variant against the torch port, step by step
    n, steps = K2_CHECK_CHAINS, K2_CHECK_STEPS
    normals, uniforms = launch(0, n, steps)
    bits = hmc._counter_stream(SEED, n, BLOCK_N, device)
    same_u = same_n = True
    counter_err = 0.0
    for i in range(steps):
        ref_n = hmc._normal(bits, (D, n), 4 * i)
        ref_u = hmc._uniform_01(bits, (n,), 4 * i + 2)
        same_u &= torch.equal(uniforms[i], ref_u)
        same_n &= torch.equal(normals[i], ref_n)
        counter_err = max(counter_err, float((normals[i] - ref_n).abs().max()))
    check(same_u and same_n, f"K2's counter variant differs from the torch port: uniforms equal {same_u}, "
                             f"normals equal {same_n}, max abs err {counter_err:.3g}")

    # the Philox variant against the torch port of Philox4x32-10, at more
    # steps than a uniform call serves
    steps = 4 * K2_CHECK_STEPS + 1
    normals, uniforms = launch(1, n, steps)
    ref_n, ref_u = philox_k1_stream(SEED, n, steps, D, device)
    philox_err = float((normals - ref_n).abs().max())
    philox_u_same = torch.equal(uniforms, ref_u)
    check(philox_u_same and philox_err <= K2_PHILOX_TOL,
          f"K2's Philox variant differs from the torch port: uniforms equal {philox_u_same}, normals max abs "
          f"err {philox_err:.3g} (limit {K2_PHILOX_TOL})")

    # the Philox variants at the flagship sweep's counts: moments in law,
    # and the redesign's normals against the standard normal
    n, steps = N_CHAINS, N_STEPS
    laws = {}
    for rng, name in ((2, "before the redesign"), (1, "redesigned")):
        normals, uniforms = launch(rng, n, steps)
        z = normals.double()
        k = z.numel()
        z_mean, z_var = float(z.mean()), float(z.var())
        u_mean, u_var = float(uniforms.double().mean()), float(uniforms.double().var())
        lag = float((z[:, :, 1:] * z[:, :, :-1]).mean())  # neighbouring chains
        pair = float((z[:, 0::4] * z[:, 1::4]).mean())  # one Box-Muller pair
        nu = uniforms.numel()
        check(abs(z_mean) < 4 / math.sqrt(k), f"K2 Philox ({name}) normals' mean {z_mean}")
        check(abs(z_var - 1) < 4 * math.sqrt(2 / k), f"K2 Philox ({name}) normals' variance {z_var}")
        check(abs(lag) < 4 / math.sqrt(k) and abs(pair) < 4 / math.sqrt(k / 4),
              f"K2 Philox ({name}) normals correlate: neighbouring chains {lag}, Box-Muller pair {pair}")
        check(abs(u_mean - 0.5) < 4 * math.sqrt(1 / 12 / nu), f"K2 Philox ({name}) uniforms' mean {u_mean}")
        check(abs(u_var - 1 / 12) < 4 * math.sqrt(1 / 180 / nu), f"K2 Philox ({name}) uniforms' variance {u_var}")
        laws[name] = (z_mean, z_var, lag, pair, u_mean, u_var)
        del z
    out = normals, uniforms
    zs = torch.sort(normals.flatten())[0].double()
    cdf = 0.5 * torch.erfc(-zs / math.sqrt(2.0))
    del zs
    rank = torch.arange(1, k + 1, device=device, dtype=torch.float64)
    ks = max(float((rank / k - cdf).max()), float((cdf - (rank - 1) / k).max()))
    del cdf, rank
    ks_limit = K2_KS_FACTOR / math.sqrt(k)
    check(ks < ks_limit, f"K2 Philox normals' Kolmogorov-Smirnov statistic {ks:.4g} (limit {ks_limit:.4g})")

    # times at one flagship sweep's counts, the output reused: the numbers
    # written out, and folded into one store a chain (the generation
    # alone); the redesign and the variant before it in turns
    def timed(rng, fold):
        return cuda_ms(lambda: launch(rng, n, steps, out, fold=fold), K2_TIMED_LAUNCHES)

    launched[0] = 0
    t_new = [timed(1, 0)]
    launches = launched[0]
    t_before = [timed(2, 0), timed(2, 0)]
    t_new.append(timed(1, 0))
    t_new_fold = [timed(1, 1)]
    t_before_fold = [timed(2, 1), timed(2, 1)]
    t_new_fold.append(timed(1, 1))
    counter_ms = timed(0, 0)
    counter_fold_ms = timed(0, 1)
    philox_ms, before_ms = sum(t_new) / 2, sum(t_before) / 2
    philox_fold_ms, before_fold_ms = sum(t_new_fold) / 2, sum(t_before_fold) / 2
    del out, normals, uniforms
    full_bits = hmc._counter_stream(SEED, n, BLOCK_N, device)

    def counter_plain():
        for i in range(steps):
            hmc._normal(full_bits, (D, n), 4 * i)
            hmc._uniform_01(full_bits, (n,), 4 * i + 2)

    counter_plain_ms = cuda_ms(counter_plain, 2)
    del full_bits
    philox_plain_ms = cuda_ms(lambda: philox_k1_stream(SEED, n, steps, D, device), 2)
    entry = dict(entry)
    ops_ms = entry.pop("ops_bound_ms")  # reported as the fold's bound
    bound_ms, library_ms = entry["bound_ms"], entry["library_ms"]
    phase("K2", f"{smi}: K2 alone (csrc/k2_stream.cu), one flagship K1 sweep's {steps * D * n} normals and "
                f"{steps * n} uniforms written out: Philox {philox_ms:.4f} ms (windows {t_new[0]:.4f}, "
                f"{t_new[1]:.4f}), before the redesign {before_ms:.4f} ms (windows {t_before[0]:.4f}, "
                f"{t_before[1]:.4f}), counter stream {counter_ms:.4f} ms by CUDA events "
                f"({K2_TIMED_LAUNCHES} launches a window, {launches} launches of k2_stream counted in the "
                f"first Philox window); bound {bound_ms:.4f} ms ({entry['bound_by']}), Philox at "
                f"{bound_ms / philox_ms:.4f} of it (before {bound_ms / before_ms:.4f}); torch.randn + "
                f"torch.rand {library_ms:.4f} ms = {library_ms / philox_ms:.3f} x K2's time (before "
                f"{library_ms / before_ms:.3f}); plain versions: the torch port of Philox4x32-10 "
                f"{philox_plain_ms:.3f} ms, of the counter stream {counter_plain_ms:.3f} ms")
    phase("K2", f"{smi}: K2 alone, the same numbers folded into one store a chain (the generation without "
                f"the {4 * steps * (D + 1) * n / 1e6:.1f} MB of stores): Philox {philox_fold_ms:.4f} ms "
                f"(windows {t_new_fold[0]:.4f}, {t_new_fold[1]:.4f}), before the redesign "
                f"{before_fold_ms:.4f} ms (windows {t_before_fold[0]:.4f}, {t_before_fold[1]:.4f}), counter "
                f"stream {counter_fold_ms:.4f} ms; the operations bound {ops_ms:.4f} ms, Philox at "
                f"{ops_ms / philox_fold_ms:.4f} of it (before {ops_ms / before_fold_ms:.4f})")
    sass = k2_sass(lib)
    for name in ("philox", "philox_before", "counter", "transform"):
        c = sass.get(name)
        if c is None:
            phase("K2 SASS", f"{name}: not found in cuobjdump's output")
            continue
        lp, fn = c["loop"], c["function"]
        per_call = "" if name in ("counter", "transform") else (
            f", {lp['total'] / 5:.1f} a Philox call of the 5 in the loop's code "
            f"({c['loop_philox_rounds']} Philox rounds identified by their first multiplier)")
        phase("K2 SASS", f"{name}: the hot loop {lp['total']} instructions{per_call}: "
                         + ", ".join(f"{k} {v}" for k, v in lp.items() if k != "total")
                         + f"; the whole kernel {fn['total']} (" + ", ".join(
                             f"{k} {v}" for k, v in fn.items() if k != "total") + ")")
    phase("K2", f"Philox variant against the torch port of Philox4x32-10 ({K2_CHECK_CHAINS} chains x "
                f"{4 * K2_CHECK_STEPS + 1} steps): uniforms bit for bit, normals max abs err {philox_err:.3g} "
                f"(limit {K2_PHILOX_TOL}); counter variant bit for bit equal to the torch port of the counter "
                f"stream; Philox moments at the flagship counts (limits 4 SE), "
                + "; ".join(f"{name}: normals mean {m:.3g}, variance {v:.6f}, neighbour correlation {lg:.3g}, "
                            f"pair correlation {pr:.3g}, uniforms mean {um:.6f}, variance {uv:.6f}"
                            for name, (m, v, lg, pr, um, uv) in laws.items())
                + f"; Kolmogorov-Smirnov statistic of the redesign's {k} normals {ks:.4g} (limit "
                  f"{K2_KS_FACTOR} / sqrt(n) = {ks_limit:.4g})")
    return {**entry, "ms": philox_ms, "plain_ms": philox_plain_ms, "max_abs_err": philox_err,
            "launches": launches, "fold_ms": philox_fold_ms, "fold_bound_ms": ops_ms,
            "before_ms": before_ms, "before_fold_ms": before_fold_ms, "ks": ks, "ks_limit": ks_limit,
            "counter_ms": counter_ms, "counter_fold_ms": counter_fold_ms, "counter_plain_ms": counter_plain_ms,
            "counter_max_abs_err": counter_err,
            "sass_loop": {name: c["loop"]["total"] for name, c in sass.items()},
            "source": "genjax_tpu_torch/kernels/csrc/k2_stream.cu (column_common.cuh's philox_normals4 and "
                      "PhiloxUniforms, which K1, K4 and K3 draw with)"}


def _leaves_on(tree, device) -> bool:
    return all(v.device.type == device.type
               for v in torch.utils._pytree.tree_leaves(tree) if isinstance(v, torch.Tensor))


def _double(chm):
    return torch.utils._pytree.tree_map(
        lambda v: v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v, chm)


def ssm_exact_posterior(ys: np.ndarray):
    """The exact posterior of ``z_1..T`` given ``y_1..T`` under
    ``linear_gaussian_ssm()`` (unit steps from ``z_0 = 0``, noise sd 0.5) by
    dense Gaussian conditioning in float64: mean and sds."""
    n = len(ys)
    prec = np.diag(np.full(n, 1.0 + 4.0))
    prec[np.arange(n - 1), np.arange(n - 1)] += 1.0
    prec[np.arange(n - 1), np.arange(1, n)] = prec[np.arange(1, n), np.arange(n - 1)] = -1.0
    cov = np.linalg.inv(prec)
    return cov @ (4.0 * ys.astype(np.float64)), np.sqrt(np.diag(cov))


def ssm_path(device, smi: str, g, hmc) -> None:
    """The combinators' card path: ``linear_gaussian_ssm``'s kernel scanned
    over 100 steps (``bench.py::bench_pf``'s shape), generated under
    ``C[:, "y"]`` by ``torch.func.vmap`` over 131,072 particles, edited at
    one step, and sampled with ``sample_posterior(hmc)``. Torch on the card:
    the reference's combinators are XLA, not Pallas, so no kernel."""
    from genjax_tpu_torch.inference import sample_posterior
    from genjax_tpu_torch.models import linear_gaussian_ssm

    kernel, exact = linear_gaussian_ssm()
    model = kernel.scan(n=SSM_T)
    args = (0.0, None)
    n, T = SSM_PARTICLES, SSM_T
    gen = torch.Generator(device=device).manual_seed(SEED)
    ys = torch.zeros(T, device=device)
    obs = g.C[:, "y"].set(ys)
    lanes = torch.zeros(n, device=device)
    generate = torch.func.vmap(lambda _: model.generate(gen, obs, args), randomness="different")
    hmc.hmc_sweep_launches = 0
    trs, ws = generate(lanes)
    torch.cuda.synchronize()
    gen_ms = wall_ms(lambda: generate(lanes))
    busy = device_busy(lambda: generate(lanes))
    check(_leaves_on((trs, ws), device), "[main path scan] an output of generate is not on the card")
    z = trs.get_choices()[:, "z"]
    check(tuple(z.shape) == (n, T), f"[main path scan] z has shape {tuple(z.shape)}")
    z64 = z.double().cpu()
    want = (-0.5 * (math.log(2 * math.pi * 0.25) + (ys.double().cpu() - z64) ** 2 / 0.25)).sum(1)
    w_err = float(((ws.double().cpu() - want).abs() / want.abs()).max())
    check(w_err < 1e-5, f"[main path scan] weights against sum_t log N(y_t; z_t, 0.5): rel err {w_err:.3g}")
    assess = torch.func.vmap(lambda tr: model.assess(tr.get_choices(), args)[0])
    score = torch.func.vmap(lambda tr: tr.get_score())(trs)
    s_err = float(((score - assess(trs)).abs() / score.abs()).max())
    check(s_err < 1e-5, f"[main path scan] get_score against assess: rel err {s_err:.3g}")
    sims = torch.func.vmap(lambda _: model.simulate(gen, args), randomness="different")(lanes)
    zs = sims.get_choices()[:, "z"]
    var_T, var_1 = float(zs[:, T - 1].double().var()), float(zs[:, 0].double().var())
    se_T, se_1 = T * math.sqrt(2 / (n - 1)), math.sqrt(2 / (n - 1))
    check(abs(var_T - T) < 4 * se_T and abs(var_1 - 1) < 4 * se_1,
          f"[main path scan] simulate's var z_100 {var_T} (SE {se_T:.3g}), var z_1 {var_1} (SE {se_1:.3g})")
    check(hmc.hmc_sweep_launches == 0, "the scan path launched K1")
    del sims, zs, z64
    phase("main path scan", f"{smi}: vmap of linear_gaussian_ssm().scan(n={T}).generate over {n} particles "
                            f"under C[:, 'y'] (ys = 0), on {ws.device}: {gen_ms:.3f} ms a call (host clock, "
                            f"median of 3); weights against sum_t log N(y_t; z_t, 0.5) in float64 rel err "
                            f"{w_err:.3g}, get_score against assess rel err {s_err:.3g} (limits 1e-5); simulate "
                            f"var z_100 {var_T:.4f} ({abs(var_T - T) / se_T:.2f} SE), var z_1 {var_1:.5f} "
                            f"({abs(var_1 - 1) / se_1:.2f} SE); log-mean-exp weight "
                            f"{float(torch.logsumexp(ws.double(), 0) - math.log(n)):.4f} against the Kalman "
                            f"filter's {exact(ys.cpu().tolist()):.4f}")
    phase("where the time goes", f"scan, {smi}: " + busy_line("one vmapped generate", busy, gen_ms))

    # ---- one step edited: the O(1) IndexRequest beside the dense Update
    t = SSM_EDIT_STEP
    v = 0.5 * torch.randn(n, generator=gen, device=device)
    assess64 = torch.func.vmap(lambda tr: model.assess(_double(tr.get_choices()), args)[0])
    old = assess64(trs)

    def edited(request_of):
        def one(tr, x):
            new_tr, w, _rd, bwd = tr.edit(gen, request_of(x))
            return new_tr, w, bwd
        return torch.func.vmap(one, randomness="different")

    index_edit = edited(lambda x: g.IndexRequest(t, g.Update(g.C["z"].set(x))))
    dense_edit = edited(lambda x: g.Update(g.C[t, "z"].set(x)))
    regen_edit = edited(lambda x: g.IndexRequest(t, g.Regenerate(g.S["z"])))
    back = torch.func.vmap(lambda tr, b: tr.edit(gen, b)[1], randomness="different")
    # the weights subtract float32 step scores that reach -800 on this shape
    # (ys = 0, particles from the prior): 1e-4, plus 8 ulp of the two steps'
    # scores where their rounding alone exceeds it
    steps = torch.func.vmap(torch.func.vmap(lambda st: st.get_score()))(trs.inner)
    tol = 1e-4 + 8 * 2.0**-23 * (steps[:, t].abs() + steps[:, t + 1].abs()).double()
    new, w, bwd = index_edit(trs, v)
    gap_v = (w.double() - (assess64(new) - old)).abs()
    gap, gap_ok = float(gap_v.max()), bool((gap_v <= tol).all())
    cancel = float((w + back(new, bwd)).abs().max())
    check(_leaves_on((new, w, bwd), device), "[main path scan edit] an output is not on the card")
    check(gap_ok and cancel < 1e-4,
          f"[main path scan edit] IndexRequest weight against assess(new) - assess(old) {gap:.3g} "
          f"(limit {float(tol.max()):.3g}), round trip {cancel:.3g} (limit 1e-4)")
    new_d, w_d, _ = dense_edit(trs, v)
    dense_v = (w_d - w).double().abs()
    dense_gap = float(dense_v.max())
    check(bool((dense_v <= tol).all()), f"[main path scan edit] the dense Update's weight differs by {dense_gap:.3g}")
    # a distribution's Regenerate weighs its new score against its old, as
    # the reference's does, so this weight too is assess(new) - assess(old)
    new_r, w_r, bwd_r = regen_edit(trs, v)
    moved = float((new_r.get_choices()[:, "z"][:, t] != trs.get_choices()[:, "z"][:, t]).double().mean())
    check(moved > 0.99, f"[main path scan edit] Regenerate moved z_{t} in {moved} of the lanes")
    r_gap_v = (w_r.double() - (assess64(new_r) - old)).abs()
    r_gap = float(r_gap_v.max())
    r_cancel = float((w_r + back(new_r, bwd_r)).abs().max())
    check(bool((r_gap_v <= tol).all()) and r_cancel < 1e-4,
          f"[main path scan edit] Regenerate weight gap {r_gap:.3g}, round trip {r_cancel:.3g}")
    index_ms = wall_ms(lambda: index_edit(trs, v))
    dense_ms = wall_ms(lambda: dense_edit(trs, v))
    regen_ms = wall_ms(lambda: regen_edit(trs, v))
    del new, new_d, new_r, bwd, bwd_r
    phase("main path scan edit", f"{smi}: vmapped IndexRequest({t}, Update(C['z'])) over {n} traces of "
                                 f"T = {T}: {index_ms:.3f} ms a call, the dense Update(C[{t}, 'z']) of the "
                                 f"same values {dense_ms:.3f} ms (ratio {index_ms / dense_ms:.4f}), "
                                 f"IndexRequest({t}, Regenerate) {regen_ms:.3f} ms (host clock, median of 3); "
                                 f"weight against assess(new) - assess(old) in float64 {gap:.3g}, against "
                                 f"the dense Update {dense_gap:.3g}, IndexRequest({t}, Regenerate)'s against "
                                 f"assess(new) - assess(old) {r_gap:.3g} (limit 1e-4 + 8 ulp of the two steps' "
                                 f"float32 scores: {float(tol.max()):.3g} at most); round trips {cancel:.3g} "
                                 f"and {r_cancel:.3g} (limit 1e-4)")
    del trs, ws

    # ---- the latent posterior through the one-call driver
    ys_np = np.random.default_rng(SSM_YS_SEED).normal(size=T).astype(np.float32)
    mean, sd = ssm_exact_posterior(ys_np)
    obs = g.C[:, "y"].set(torch.from_numpy(ys_np))
    t0 = time.perf_counter()
    res = sample_posterior(SEED, model, obs, args, g.S[..., "z"], algorithm="hmc", n_chains=SSM_CHAINS,
                           n_warmup=SSM_WARMUP, n_samples=SSM_SAMPLES, L=SSM_L, eps0=SSM_EPS0,
                           device=device)
    torch.cuda.synchronize()
    sp_s = time.perf_counter() - t0
    draws = res[:, "z"]
    check(tuple(draws.shape) == (SSM_CHAINS, SSM_SAMPLES, T) and type(res.positions).__name__ == "IndexedChm",
          f"[main path scan sample_posterior] positions {type(res.positions).__name__} {tuple(draws.shape)}")
    check(_leaves_on(res.positions, device), "[main path scan sample_posterior] draws are not on the card")
    flat = draws.reshape(-1, T).double().cpu().numpy()
    mean_gap = float(np.abs(flat.mean(0) - mean).max())
    sd_gap = float(np.abs(flat.std(0) / sd - 1).max())
    rhat = float(res.rhat_of((slice(None), "z")).max())
    check(mean_gap < SSM_MEAN_TOL and sd_gap < SSM_SD_TOL and rhat < SSM_RHAT,
          f"[main path scan sample_posterior] mean gap {mean_gap:.4f}, sd gap {sd_gap:.4f}, split-R-hat {rhat:.4f}")
    check(hmc.hmc_sweep_launches == 0, "sample_posterior('hmc') on the scan launched K1")
    # no device body for the scan's traces: the batched runner refuses on the card
    few = torch.func.vmap(lambda _: model.generate(gen, obs, args)[0], randomness="different")(
        torch.zeros(64, device=device))
    try:
        g.run_chains_hmc(gen, few, g.S[..., "z"], eps=0.1, L=SSM_L)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("device body" in refused and hmc.hmc_sweep_launches == 0,
          f"run_chains_hmc(backend='auto') on the scan's traces did not refuse: {refused!r}")
    phase("main path scan sample_posterior", f"{smi}: sample_posterior(hmc) over S[..., 'z'] of the T = {T} "
                                             f"model, {SSM_CHAINS} chains, {SSM_WARMUP} warmup + {SSM_SAMPLES} "
                                             f"draws, L = {SSM_L}: {sp_s:.2f} s (host clock, one call), eps "
                                             f"{float(res.eps):.4f}, accept {float(res.accept_rate):.4f}; "
                                             f"draws IndexedChm {tuple(draws.shape)}; against the exact "
                                             f"posterior: max mean gap {mean_gap:.4f} (limit {SSM_MEAN_TOL}), "
                                             f"max sd gap {sd_gap:.4f} (limit {SSM_SD_TOL}), max split-R-hat "
                                             f"{rhat:.4f} (limit {SSM_RHAT}); run_chains_hmc(backend='auto') "
                                             f"refused the scan's traces: no device body")


def combinator_zoo(g, device):
    """``tests/generative_functions/test_gfi_contract.py``'s combinator
    configurations in the port, arguments on ``device``."""

    def A(x):
        x = np.asarray(x)
        return torch.as_tensor(x.astype(np.float32) if x.dtype == np.float64 else x, device=device)

    @g.gen
    def leaf(mu):
        x = g.normal(mu, 1.0) @ "x"
        return x + g.normal(x, 0.5) @ "y"

    @g.gen
    def kern(c, _x):
        z = g.normal(0.7 * c, 1.0) @ "z"
        return (z, z)

    @g.gen
    def b0():
        return g.normal(0.0, 1.0) @ "a"

    @g.gen
    def b1():
        return g.normal(1.0, 2.0) @ "b"

    sw = g.switch(b0, b1)

    @g.gen
    def switch_in_static(idx):
        return sw(idx, (), ()) @ "sw"

    @g.gen
    def nested(mu):
        return g.normal(leaf(mu) @ "sub", 1.0) @ "top"

    @g.gen
    def step(x):
        return g.normal(0.5 * x, 1.0) @ "w"

    @g.gen
    def acc_step(c, x):
        return g.normal(c + x, 1.0) @ "w"

    sv = kern.scan(n=4)
    return {
        "static": (nested, (0.3,)),
        "vmap": (leaf.vmap(in_axes=(0,)), (A([0.0, 1.0, 2.0]),)),
        "scan": (sv, (0.0, A(np.zeros(4)))),
        "vmap-of-scan": (sv.vmap(in_axes=(0, None)), (A([0.0, 1.0]), A(np.zeros(4)))),
        "switch": (sw, (0, (), ())),
        "switch tensor index": (switch_in_static, (A(1),)),
        "mask": (g.mask_combinator(leaf), (A(True), 0.3)),
        "dimap": (leaf.dimap(pre=lambda a: (a * 2.0,), post=lambda args, r: r + 1.0), (0.15,)),
        "repeat": (leaf.repeat(n=3), (0.3,)),
        "or_else": (b0.or_else(b1), (A(True), (), ())),
        "mix": (g.mix(b0, b1), (A(np.zeros(2)), (), ())),
        "iterate": (step.iterate(n=3), (0.5,)),
        "iterate_final": (step.iterate_final(n=3), (0.5,)),
        "accumulate": (acc_step.accumulate(), (0.0, A(np.ones(3)))),
        "reduce": (acc_step.reduce(), (0.0, A(np.ones(3)))),
        "masked_iterate_final": (step.masked_iterate_final(), (0.5, A([True, False, True]))),
    }


def combinators_path(device, smi: str, g) -> None:
    """Every combinator configuration on the card, vmapped over
    ``COMB_LANES`` lanes: ``generate`` under each lane's full choices weighs
    its ``assess``, an ``Update`` to another lane's choices and its backward
    request cancel, and every leaf lives on the card."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    lanes = torch.zeros(COMB_LANES, device=device)
    t0 = time.perf_counter()
    worst = {}
    for name, (model, args) in combinator_zoo(g, device).items():
        sim = torch.func.vmap(lambda _: model.simulate(gen, args), randomness="different")
        trs, donors = sim(lanes), sim(lanes)
        own = torch.func.vmap(lambda tr: tr.get_score())(trs)
        scores = torch.func.vmap(lambda tr: model.assess(tr.get_choices(), args)[0])(trs)
        ws = torch.func.vmap(lambda tr: model.generate(gen, tr.get_choices(), args)[1],
                             randomness="different")(trs)

        def forward(tr, donor):
            new_tr, w, _rd, bwd = model.edit(gen, tr, g.Update(donor.get_choices()),
                                             g.Diff.tree_diff_no_change(args))
            return new_tr, w, bwd

        new, w, bwd = torch.func.vmap(forward, randomness="different")(trs, donors)
        wb = torch.func.vmap(lambda tr, b: tr.edit(gen, b)[1], randomness="different")(new, bwd)
        gen_gap = float(torch.maximum((ws - scores).abs(), (own - scores).abs()).max())
        trip = float((w + wb).abs().max())
        check(_leaves_on((trs, new, ws, w, wb, bwd), device), f"[combinators] {name}: a leaf is not on the card")
        check(gen_gap < COMB_TOL and trip < COMB_TOL,
              f"[combinators] {name}: generate/score against assess {gen_gap:.3g}, round trip {trip:.3g}")
        worst[name] = (gen_gap, trip)
    torch.cuda.synchronize()
    phase("combinators", f"{smi}: {len(worst)} configurations x {COMB_LANES} lanes on the card in "
                         f"{time.perf_counter() - t0:.2f} s; generate under full choices and get_score against "
                         f"assess, and the Update round trip, worst "
                         f"{max(v[0] for v in worst.values()):.3g} and {max(v[1] for v in worst.values()):.3g} "
                         f"(limits {COMB_TOL}): " + ", ".join(worst))


PF_PARTICLES = 131072  # bench.py::bench_pf, not cut
PF_T = 100
PF_SEEDS = 10
PF_DESIGN_RUNS = 5  # each resample design, in turns
DP_PARTICLES = 4096  # bench.py::bench_dp, cut in reps only
DP_RUNGS = 10
DP_DATA = 60
DP_TRUNC = 8
DP_SEEDS = 10
CONJ_PARTICLES = 4096
CONJ_SEEDS = 8
CONJ_Y = 1.5
SIR_TRIALS = 65536  # bench.py::bench_sir, cut in reps only
SIR_K = 50
SIR_REPS = 3
KALMAN_D = 4
KALMAN_T = 4096


def per_call_ms(fn, reps: int) -> float:
    """Host-clock ms a call of ``fn`` over ``reps`` calls in a row, the
    device synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def host_reads(fn) -> int:
    """How many times one call of ``fn`` waits on the card for a value
    (``torch.cuda.set_sync_debug_mode``'s warnings, counted)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the first switch to "warn" in a process also warns that the mode is a
    # prototype; that warning is no read
    return sum("synchroniz" in str(w.message) and "prototype" not in str(w.message) for w in caught)


def resample_where(gen, fire, particles, log_w, log_z, method):
    """The other design of ``parallel.smc.resample_if``, kept here to time it
    against the package's: resample on every step and select with
    ``torch.where``, reading nothing on the host."""
    from genjax_tpu_torch.parallel.resampling import resample_particles

    k = log_w.shape[0]
    inc = torch.logsumexp(log_w, dim=0) - math.log(k)
    moved = resample_particles(gen, particles, log_w, k, method)
    particles = torch.utils._pytree.tree_map(
        lambda new, old: torch.where(fire.reshape((1,) * new.ndim), new, old), moved, particles)
    return (particles, torch.where(fire, torch.zeros_like(log_w), log_w),
            torch.where(fire, log_z + inc, log_z))


def packed_move(tree, counts, n: int):
    """``redistribute`` as the reference moves rows: every leaf whose rows
    are whole 4-byte words bit-cast to int32 and laid side by side in one
    matrix (at least 8 wide), one repeat of the matrix, the leaves read back
    as views of it; other leaves repeated one by one."""
    leaves, spec = torch.utils._pytree.tree_flatten(tree)
    k = counts.shape[0]
    pack = [i for i, v in enumerate(leaves) if v.ndim >= 1 and v.element_size() % 4 == 0]
    out = [torch.repeat_interleave(v, counts, dim=0, output_size=n) if i not in pack else None
           for i, v in enumerate(leaves)]
    if pack:
        cols = [leaves[i].reshape(k, -1).contiguous().view(torch.int32) for i in pack]
        width = sum(c.shape[1] for c in cols)
        if width < 8:
            cols.append(torch.zeros((k, 8 - width), dtype=torch.int32, device=counts.device))
        moved = torch.repeat_interleave(torch.cat(cols, dim=1), counts, dim=0, output_size=n)
        c0 = 0
        for i, c in zip(pack, cols):
            words = moved[:, c0:c0 + c.shape[1]]
            if leaves[i].element_size() > 4:
                words = words.contiguous()
            out[i] = words.view(leaves[i].dtype).reshape((n,) + tuple(leaves[i].shape[1:]))
            c0 += c.shape[1]
    return torch.utils._pytree.tree_unflatten(out, spec)


def leafwise_move(tree, counts, n: int):
    """``redistribute`` leaf by leaf, without packing: the row move the
    packed one is timed against."""
    return torch.utils._pytree.tree_map(
        lambda v: torch.repeat_interleave(v, counts, dim=0, output_size=n), tree)


def gather_move(tree, counts, n: int):
    """``redistribute`` as one index vector from the counts and a gather of
    each leaf along it."""
    idx = torch.repeat_interleave(torch.arange(counts.shape[0], device=counts.device), counts, output_size=n)
    return torch.utils._pytree.tree_map(lambda v: torch.index_select(v, 0, idx), tree)


def se_gap(values, want: float):
    """Mean of ``values``, its standard error, and its gap to ``want`` in
    standard errors."""
    v = np.asarray(values, np.float64)
    se = v.std(ddof=1) / math.sqrt(len(v))
    return float(v.mean()), float(se), float(abs(v.mean() - want) / se)


def dp_data() -> np.ndarray:
    """``bench.py::bench_dp``'s 60 points: three centres, noise 0.4, numpy
    seed 0."""
    rng = np.random.default_rng(0)
    return (np.array([-4.0, 0.0, 4.0])[rng.integers(0, 3, DP_DATA)]
            + 0.4 * rng.normal(size=DP_DATA)).astype(np.float32)


def kalman_system(d: int, seed: int):
    """A random stable ``d``-state system observed in ``d // 2`` outputs
    (float64, numpy)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, d))
    A = 0.95 * A / np.abs(np.linalg.eigvals(A)).max()

    def spd(k, scale):
        m = rng.normal(size=(k, k))
        return scale * (m @ m.T / k + 0.5 * np.eye(k))

    dy = max(1, d // 2)
    return dict(A=A, Q=spd(d, 0.2), C=rng.normal(size=(dy, d)), R=spd(dy, 0.3), mu0=np.zeros(d),
                P0=np.eye(d)), rng


def smc_path(device, smi: str, g) -> dict:
    """SMC and GenSP on the card (no kernel: the reference runs them as XLA):
    ``bench.py::bench_pf``'s particle filter with systematic resampling,
    ``bench_dp``'s tempered SMC on the DP mixture, the conjugate normal
    model through both tempered drivers, ``bench_sir``'s importance
    estimates through ``ImportanceK``, and the Kalman filters, sequential and
    parallel, on a 4-state system over 4,096 steps."""
    import genjax_tpu_torch.parallel.smc as pf_mod
    from genjax_tpu_torch.dists import LGSSMParams, kalman_filter, kalman_filter_parallel
    from genjax_tpu_torch.inference import (
        ImportanceK, Target, adaptive_tempered_smc, geometric_ladder, tempered_smc,
    )
    from genjax_tpu_torch.models import dp_mixture_model, linear_gaussian_ssm
    from genjax_tpu_torch.parallel import SSMParticleFilter, effective_sample_size, resample_particles
    from genjax_tpu_torch.parallel.resampling import redistribute, systematic_counts

    t_smc = time.perf_counter()
    out = {}

    # ---- the particle filter: bench_pf
    kernel, exact = linear_gaussian_ssm()
    K, T = PF_PARTICLES, PF_T
    ys = torch.zeros(T, device=device)
    obs = g.C[:, "y"].set(ys)
    xs = torch.zeros(T, device=device)
    pf = SSMParticleFilter(kernel, n_particles=K, ess_threshold=0.5, method="systematic")

    def run_pf(seed):
        return pf.run(seed, 0.0, xs, obs, device=device)

    first = run_pf(0)
    check(_leaves_on(first, device) and tuple(first.carries.shape) == (K,)
          and tuple(first.ess_history.shape) == (T,), "[main path pf] an output is off the card or misshapen")
    torch.cuda.synchronize()
    lzs, pf_ms = [], []
    for seed in range(1, PF_SEEDS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_pf(seed)
        lzs.append(float(res.log_marginal))
        pf_ms.append((time.perf_counter() - t0) * 1e3)
    want = exact(ys.cpu().tolist())
    mean_lz, se_lz, _ = se_gap(lzs, want)
    check(abs(mean_lz - want) <= 4 * se_lz + 0.01,
          f"[main path pf] mean log marginal {mean_lz:.5f} (SE {se_lz:.5f}) against the Kalman filter's {want:.5f}")
    reads = host_reads(lambda: run_pf(99))
    busy = device_busy(lambda: run_pf(98))
    run_ms = float(np.median(pf_ms))
    fire = float((first.ess_history < 0.5 * K).double().mean())
    # bench_pf's decomposition: a vmapped extend, the ESS, a standalone resample
    gen = torch.Generator(device=device).manual_seed(77)
    carry = torch.zeros(K, device=device)
    sub0 = obs.get_submap(0)

    def extend():
        def one(c):
            tr, w = kernel.generate(gen, sub0, (c, xs[0]))
            return tr.get_retval()[0], w
        return torch.func.vmap(one, randomness="different")(carry)

    lw = torch.randn(K, generator=gen, device=device)
    t_ext = per_call_ms(extend, 20)
    t_ess = per_call_ms(lambda: effective_sample_size(lw), 200)
    t_res = per_call_ms(lambda: resample_particles(gen, carry, lw, K, "systematic"), 100)
    step_ms = run_ms / T
    explained = (t_ext + t_ess + fire * t_res) / step_ms
    # the two designs of the resample decision, in turns in this call
    design_ms = {"host read": [], "torch.where": []}
    package_resample_if = pf_mod.resample_if
    try:
        for r in range(PF_DESIGN_RUNS):
            for name, fn in (("host read", package_resample_if), ("torch.where", resample_where)):
                pf_mod.resample_if = fn
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lz = float(run_pf(200 + r).log_marginal)
                design_ms[name].append((time.perf_counter() - t0) * 1e3)
                check(math.isfinite(lz), f"[pf resample designs] {name}: log marginal {lz}")
        pf_mod.resample_if = resample_where
        where_reads = host_reads(lambda: run_pf(300))
    finally:
        pf_mod.resample_if = package_resample_if
    # the packed row move against leaf by leaf, on the pf's carry and bench_dp's traces
    counts = systematic_counts(gen, lw, K)
    data = torch.from_numpy(dp_data()).to(device)
    dp_model = dp_mixture_model(DP_TRUNC)
    dp_obs = g.C["obs", :, "x"].set(data)
    dp_traces = torch.func.vmap(lambda _: dp_model.generate(gen, dp_obs, (data,))[0], randomness="different")(
        torch.zeros(K, device=device))
    n_leaves = len(torch.utils._pytree.tree_leaves(dp_traces))
    moves = {}
    for what, tree in (("pf carry", carry), ("bench_dp trace", dp_traces)):
        kept = torch.utils._pytree.tree_leaves(redistribute(tree, counts, K))
        for other in (packed_move, leafwise_move, gather_move):
            same = all(torch.equal(a, b) for a, b in zip(kept, torch.utils._pytree.tree_leaves(other(tree, counts, K))))
            check(same, f"[pf row moves] {what}: {other.__name__} differs from redistribute")
        moves[what] = tuple(per_call_ms(lambda: fn(tree, counts, K), 50)
                            for fn in (packed_move, leafwise_move, gather_move, redistribute))
    del dp_traces
    phase("main path pf", f"{smi}: SSMParticleFilter(linear_gaussian_ssm, n_particles={K}, ess_threshold=0.5, "
                          f"systematic).run over T = {T}, ys = 0 (bench_pf), {PF_SEEDS} seeds: a run "
                          f"{run_ms:.2f} ms (host clock, median; {min(pf_ms):.2f}-{max(pf_ms):.2f}) = "
                          f"{K * T / run_ms * 1e3:.6g} particle-steps/s; mean log marginal {mean_lz:.5f} (SE "
                          f"{se_lz:.5f}) against the float64 Kalman filter's {want:.5f} (limit 4 SE + 0.01); "
                          f"host reads a run {reads} = {reads / T:.3f} a step")
    phase("where the time goes", f"pf, {smi}: a step {step_ms * 1e3:.1f} us; vmapped extend {t_ext * 1e3:.1f} us, "
                                 f"ESS {t_ess * 1e3:.1f} us, standalone systematic resample {t_res * 1e3:.1f} us "
                                 f"(host clock, means of 20, 200, 100 calls), firing rate {fire:.3f} (ess_history "
                                 f"of seed 0): they explain {explained:.4f} of the step; "
                                 + busy_line("one run", busy, run_ms))
    phase("pf resample designs", f"{smi}: a run with the decision read on the host (kept) "
                                 f"{', '.join(f'{v:.2f}' for v in design_ms['host read'])} ms, resampling every step "
                                 f"and selecting with torch.where {', '.join(f'{v:.2f}' for v in design_ms['torch.where'])} "
                                 f"ms (in turns, host clock); host reads a run {reads} and {where_reads}")
    phase("pf row moves", f"{smi}: redistribute at K = {K} (host clock, means of 50): " + "; ".join(
        f"{what} ({1 if what == 'pf carry' else n_leaves} leaves) {a * 1e3:.1f} us packed into one int32 matrix "
        f"(the reference's design), {b * 1e3:.1f} us a repeat_interleave a leaf, {c * 1e3:.1f} us one index vector "
        f"and an index_select a leaf, {d * 1e3:.1f} us the package's redistribute (a repeat for one leaf, the "
        f"gather for more)" for what, (a, b, c, d) in moves.items()))
    out["pf"] = dict(run_ms=run_ms, reads=reads, explained=explained, design_ms=design_ms, moves=moves)

    # ---- tempered SMC on the DP mixture: bench_dp
    betas = geometric_ladder(DP_RUNGS)

    def run_dp(seed, dev):
        d = data.to(dev)
        return tempered_smc(seed, dp_model, g.C["obs", :, "x"].set(d), (d,), n_particles=DP_PARTICLES,
                            betas=betas, device=dev)

    first = run_dp(0, device)
    check(_leaves_on(first, device), "[main path dp] an output is off the card")
    card, dp_ms = [], []
    for seed in range(1, DP_SEEDS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.append(float(run_dp(seed, device).log_marginal))
        dp_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    cpu = [float(run_dp(1000 + seed, "cpu").log_marginal) for seed in range(DP_SEEDS)]
    cpu_ms = (time.perf_counter() - t0) * 1e3 / DP_SEEDS
    pooled = math.sqrt(np.var(card, ddof=1) / len(card) + np.var(cpu, ddof=1) / len(cpu))
    dp_gap = abs(np.mean(card) - np.mean(cpu)) / pooled
    check(all(map(math.isfinite, card + cpu)) and dp_gap < 4,
          f"[main path dp] the card's mean log marginal {np.mean(card):.4f} against the CPU's {np.mean(cpu):.4f}: "
          f"{dp_gap:.2f} pooled SE")
    dp_busy = device_busy(lambda: run_dp(97, device))
    dp_call = float(np.median(dp_ms))
    phase("main path dp", f"{smi}: tempered_smc(dp_mixture_model({DP_TRUNC}), n_particles={DP_PARTICLES}, "
                          f"geometric_ladder({DP_RUNGS})) on bench_dp's {DP_DATA} points, no rejuvenation: a call "
                          f"{dp_call:.2f} ms (host clock, median of {DP_SEEDS}) = {1e3 / dp_call:.4g} calls/s = "
                          f"{DP_PARTICLES * DP_RUNGS / dp_call * 1e3:.6g} particle-rungs/s; on the CPU {cpu_ms:.1f} ms "
                          f"a call; mean log marginal {np.mean(card):.4f} (card, {DP_SEEDS} seeds) against "
                          f"{np.mean(cpu):.4f} (CPU, {DP_SEEDS} other seeds): {dp_gap:.2f} pooled SE (limit 4); "
                          + busy_line("one call", dp_busy, dp_call))
    out["dp"] = dict(call_ms=dp_call)

    # ---- the conjugate check: test_tempered.py's normal-normal model
    @g.gen
    def conjugate():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 0.5) @ "y"

    conj_obs = g.C["y"].set(torch.tensor(CONJ_Y, device=device))
    exact_lz = -0.5 * math.log(2 * math.pi * 1.25) - CONJ_Y**2 / 2.5
    post_mean, post_sd = 0.8 * CONJ_Y, math.sqrt(0.2)
    configs = {
        "tempered_smc, rejuvenation S['mu']": lambda s: tempered_smc(
            s, conjugate, conj_obs, (), n_particles=CONJ_PARTICLES, betas=geometric_ladder(10),
            rejuvenation=g.S["mu"], n_rejuvenation=2, device=device),
        "tempered_smc, HMC(S['mu'], 0.3, L=5)": lambda s: tempered_smc(
            s, conjugate, conj_obs, (), n_particles=CONJ_PARTICLES, betas=geometric_ladder(12),
            rejuvenation=g.HMC(g.S["mu"], 0.3, L=5), n_rejuvenation=2, device=device),
        "adaptive_tempered_smc, HMC(S['mu'], 0.15, L=5)": lambda s: adaptive_tempered_smc(
            s, conjugate, conj_obs, (), n_particles=CONJ_PARTICLES,
            rejuvenation=g.HMC(g.S["mu"], 0.15, L=5), device=device),
    }
    lines = []
    for name, run in configs.items():
        lz, means, sds, rungs, t0 = [], [], [], [], time.perf_counter()
        for seed in range(CONJ_SEEDS):
            res = run(seed)
            w = torch.softmax(res.log_weights.double(), 0)
            mu = res.traces.get_choices()["mu"].double()
            m = float((w * mu).sum())
            lz.append(float(res.log_marginal))
            means.append(m)
            sds.append(math.sqrt(float((w * (mu - m) ** 2).sum())))
            rungs.append(int(getattr(res, "n_rungs", len(res.ess_history))))
        call_s = (time.perf_counter() - t0) / CONJ_SEEDS
        lz_m, lz_se, _ = se_gap(lz, exact_lz)
        m_m, m_se, _ = se_gap(means, post_mean)
        sd_gap = abs(np.mean(sds) / post_sd - 1)
        check(abs(lz_m - exact_lz) <= 4 * lz_se + 0.01 and abs(m_m - post_mean) <= 4 * m_se + 0.01
              and sd_gap < 0.10,
              f"[conjugate] {name}: evidence {lz_m:.4f} (SE {lz_se:.4f}) against {exact_lz:.4f}, mean {m_m:.4f} "
              f"(SE {m_se:.4f}) against {post_mean}, sd off by {sd_gap:.3f}")
        lines.append(f"{name}: {call_s:.3f} s a call, evidence {lz_m:.4f} (SE {lz_se:.4f}; exact {exact_lz:.4f}), "
                     f"posterior mean {m_m:.4f} (SE {m_se:.4f}; exact {post_mean}), sd {np.mean(sds):.4f} "
                     f"(exact {post_sd:.4f}), n_rungs {min(rungs)}-{max(rungs)}; "
                     + busy_line("one call", device_busy(lambda: run(CONJ_SEEDS)), call_s * 1e3))
    phase("conjugate", f"{smi}: {CONJ_PARTICLES} particles, {CONJ_SEEDS} seeds each (limits: 4 SE + 0.01, sd "
                       f"10%): " + "; ".join(lines))

    # ---- SIR: bench_sir through ImportanceK
    @g.gen
    def beta_bernoulli():
        p = g.beta(2.0, 2.0) @ "p"
        return g.flip(p) @ "v"

    sir_target = Target(beta_bernoulli, (), g.C["v"].set(True))
    alg = ImportanceK(sir_target, k_particles=SIR_K)
    sir_gen = torch.Generator(device=device).manual_seed(SEED)

    def sir():
        def one(_):
            collection = alg.run_smc(sir_gen, device=device)
            return collection.sample_particle(sir_gen).get_choices()["p"]
        return torch.func.vmap(one, randomness="different")(torch.zeros(SIR_TRIALS, device=device))

    ps = sir()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SIR_REPS):
        ps = sir()
    torch.cuda.synchronize()
    sir_ms = (time.perf_counter() - t0) * 1e3 / SIR_REPS
    sir_busy = device_busy(sir)
    ps = ps.double().cpu().numpy()
    # the law of one estimate at K = 50: E[sum p_i^2 / sum p_i] under the
    # Beta(2, 2) prior, in float64 from two million numpy draws (3/5 at K = oo)
    rng = np.random.default_rng(5)
    prior = rng.beta(2.0, 2.0, size=(2_000_000, SIR_K))
    law = (prior * prior).sum(1) / prior.sum(1)
    law_mean, law_se = float(law.mean()), float(law.std() / math.sqrt(law.size))
    sir_se = float(ps.std() / math.sqrt(ps.size))
    sir_gap = abs(ps.mean() - law_mean) / math.hypot(sir_se, law_se)
    check(ps.shape == (SIR_TRIALS,) and sir_gap < 4 and abs(ps.mean() - 0.6) < 4 * sir_se + abs(law_mean - 0.6),
          f"[main path sir] mean {ps.mean():.5f} (SE {sir_se:.5f}) against the K = {SIR_K} law {law_mean:.5f}")
    phase("main path sir", f"{smi}: vmap over {SIR_TRIALS} trials of ImportanceK(beta_bernoulli, k_particles="
                           f"{SIR_K}).run_smc and sample_particle (bench_sir): {sir_ms:.2f} ms a call (host clock, "
                           f"mean of {SIR_REPS}) = {SIR_TRIALS / sir_ms * 1e3:.6g} SIR estimates/s; mean p "
                           f"{ps.mean():.5f} (SE {sir_se:.5f}) against {law_mean:.5f}, the mean of a {SIR_K}-particle "
                           f"estimate ({sir_gap:.2f} SE, limit 4), and 3/5 at infinitely many; "
                           + busy_line("one call", sir_busy, sir_ms))

    # ---- the Kalman filters: a random stable 4-state system over 4,096 steps
    sys64, rng = kalman_system(KALMAN_D, 11)
    params64 = LGSSMParams(**{k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in sys64.items()})
    dy = sys64["C"].shape[0]
    z = np.zeros(KALMAN_D)
    ys_np = []
    for _ in range(KALMAN_T):
        z = sys64["A"] @ z + rng.multivariate_normal(np.zeros(KALMAN_D), sys64["Q"])
        ys_np.append(sys64["C"] @ z + rng.multivariate_normal(np.zeros(dy), sys64["R"]))
    ys64 = torch.from_numpy(np.asarray(ys_np))
    m64, _c64, lm64 = kalman_filter(params64, ys64)
    params = LGSSMParams(**{k: v.to(device, torch.float32) for k, v in vars(params64).items()})
    ys32 = ys64.to(device, torch.float32)
    m_seq, _c, lm = kalman_filter(params, ys32)
    m_par, _cp = kalman_filter_parallel(params, ys32)
    check(_leaves_on((m_seq, m_par, lm), device), "[kalman] an output is off the card")
    lm_rel = abs(float(lm) - float(lm64)) / abs(float(lm64))
    scale = max(1.0, float(m64.abs().max()))
    seq_err = float((m_seq.double().cpu() - m64).abs().max()) / scale
    par_err = float((m_par.double().cpu() - m64).abs().max()) / scale
    check(lm_rel < 1e-4 and seq_err < 1e-3 and par_err < 1e-3,
          f"[kalman] log marginal rel err {lm_rel:.3g}, filtered means {seq_err:.3g} and {par_err:.3g}")
    seq_ms = wall_ms(lambda: kalman_filter(params, ys32), reps=1)
    par_ms = wall_ms(lambda: kalman_filter_parallel(params, ys32))
    par_busy = device_busy(lambda: kalman_filter_parallel(params, ys32))
    phase("kalman", f"{smi}: a {KALMAN_D}-state system, {dy} outputs, T = {KALMAN_T}, float32 on the card against "
                    f"float64 on the CPU: kalman_filter {seq_ms:.2f} ms (one call), kalman_filter_parallel {par_ms:.2f} ms "
                    f"(median of 3; host clock); log marginal {float(lm):.3f} against {float(lm64):.3f}, rel err "
                    f"{lm_rel:.3g} (limit 1e-4); filtered means max err {seq_err:.3g} and {par_err:.3g} of "
                    f"max(1, |m|) (limit 1e-3); " + busy_line("one parallel filter", par_busy, par_ms))
    phase("smc", f"the SMC phases took {time.perf_counter() - t_smc:.1f} s")
    return out


# ----------------------------------------------------------------------
# slice 12: the catalog, ADEV, VI, MAP/Laplace and ADVI (no kernel)
# ----------------------------------------------------------------------

VI_BATCH = 4096  # bench.py::bench_vi's gradient estimates a step
VI_STEPS = 300
VI_WARMUP = 5
VI_LR = 0.05
VI_PHI0 = (0.0, 1.0, -1.0, -1.0, -1.0)  # (component logit, mu1, log_s1, mu0, log_s0)
ADEV_LANES = 2**20
CATALOG_N = 2**20
CATALOG_LP_TOL = 1e-4  # card against CPU, relative to max(1, |value|)
GLM_N, GLM_D = 100_000, 16
GLM_STEPS, GLM_LR = 300, 0.05
GLM_TOL = 1e-3
ADVI_STEPS, ADVI_LR, ADVI_SAMPLES = 1000, 0.01, 128  # the rate cosine-decayed to 0 over the steps
ADVI_DRAWS = 16384  # the dense phase's chain count: cov_bound's n


def mixture_vi(g):
    """``bench.py::bench_vi``'s program: the flip/normal mixture with ``y =
    1.5`` observed, the guide ``flip_reinforce`` on ``z`` and
    ``normal_reparam`` on ``mu`` inside ``Marginal``. Returns the ELBO's
    gradient estimator and the guide and target, for the forward pass."""
    from genjax_tpu_torch.core.pytree import Const
    from genjax_tpu_torch.inference import Target, vi
    from genjax_tpu_torch.inference.sp import Marginal

    @g.gen
    def model_fn(phi):
        z = g.flip(0.5) @ "z"
        mu = g.normal(torch.where(z, 2.0, -2.0), 1.0) @ "mu"
        _ = g.normal(mu, 0.5) @ "y"

    @g.gen
    def guide_fn(target):
        (phi,) = target.args
        z = vi.flip_reinforce(torch.sigmoid(phi[0])) @ "z"
        zf = z.to(torch.float32)
        m = zf * phi[1] + (1.0 - zf) * phi[3]
        s = torch.exp(zf * phi[2] + (1.0 - zf) * phi[4])
        _ = vi.normal_reparam(m, s) @ "mu"

    guide = Marginal(guide_fn, Const(g.Selection.all()), Const(None))
    make_target = lambda phi: Target(model_fn, (phi,), g.C["y"].set(1.5))  # noqa: E731
    return vi.ELBO(guide, make_target), guide, make_target


def exact_neg_elbo(phi, y=1.5, sigma=0.5):
    """The mixture's negative ELBO and its gradient in float64 numpy: ``z``
    enumerated over {0, 1}, every ``mu`` term a Gaussian expectation."""
    phi = np.asarray(phi, np.float64)
    q1 = 1.0 / (1.0 + math.exp(-phi[0]))
    q = {1: q1, 0: 1.0 - q1}
    m, s = {1: phi[1], 0: phi[3]}, {1: math.exp(phi[2]), 0: math.exp(phi[4])}
    c = {1: 2.0, 0: -2.0}

    def f(z):  # E_{mu ~ N(m, s)}[log p(z, mu, y) - log q(mu | z)]
        return (math.log(0.5) - 0.5 * ((m[z] - c[z]) ** 2 + s[z] ** 2)
                - 0.5 * math.log(2 * math.pi * sigma**2) - 0.5 * ((y - m[z]) ** 2 + s[z] ** 2) / sigma**2
                + 0.5 + math.log(s[z]))

    elbo = sum(q[z] * (f(z) - math.log(q[z])) for z in (0, 1))
    dm = {z: -(m[z] - c[z]) + (y - m[z]) / sigma**2 for z in (0, 1)}
    ds = {z: 1.0 - s[z] ** 2 * (1.0 + 1.0 / sigma**2) for z in (0, 1)}
    grad = [q[1] * q[0] * (f(1) - f(0) + math.log(q[0]) - math.log(q[1])),
            q[1] * dm[1], q[1] * ds[1], q[0] * dm[0], q[0] * ds[0]]
    return -elbo, -np.asarray(grad)


def vi_main_path(device, smi: str, g) -> None:
    """``[main path vi]``: bench_vi's ELBO gradient at full width (4,096
    estimates a step through ``torch.func.vmap``), held against the exact
    gradient at ``phi0``, then ``VI_STEPS`` descent steps that must lower
    the exact loss; the reverse pass beside the forward pass that the other
    design would take (one ``jvp_estimate`` a parameter)."""
    from genjax_tpu_torch.adev import Dual, expectation
    from genjax_tpu_torch.adev.core import fork
    from genjax_tpu_torch.inference import Importance

    elbo_grad, guide, make_target = mixture_vi(g)
    gen = torch.Generator(device=device).manual_seed(SEED)
    lanes = torch.zeros(VI_BATCH, device=device)
    batched = torch.func.vmap(lambda _, phi: elbo_grad(gen, (phi,))[0], in_dims=(0, None), randomness="different")
    phi0 = torch.tensor(VI_PHI0, device=device)

    def step(phi):
        return phi - VI_LR * batched(lanes, phi).mean(dim=0)

    # gate (a): the 4,096-estimate mean at phi0 against the exact gradient
    gs = batched(lanes, phi0).double()
    loss0, exact = exact_neg_elbo(VI_PHI0)
    mean, se = gs.mean(0).cpu().numpy(), (gs.std(0) / math.sqrt(VI_BATCH)).cpu().numpy()
    z = np.abs(mean - exact) / se
    check(bool(np.all(z < 5)), f"ELBO gradient at phi0 {mean.tolist()} vs exact {exact.tolist()}: {z.tolist()} SE")

    # the other design: one forward (jvp) pass a parameter, 5 vmapped passes
    def forward_grad(phi):
        def one(_):
            model_gen = fork(gen)

            @expectation
            def loss(p):
                target = make_target(p)
                return -Importance(target, guide).estimate_normalizing_constant(
                    model_gen, target, device=model_gen.device)

            eye = torch.eye(5, device=device)
            return torch.stack([loss.jvp_estimate(gen, (Dual(phi, eye[i]),), streams=(model_gen,)).tangent
                                for i in range(5)])

        return torch.func.vmap(one, randomness="different")(lanes)

    fs = forward_grad(phi0).double()
    zf = np.abs(fs.mean(0).cpu().numpy() - exact) / (fs.std(0) / math.sqrt(VI_BATCH)).cpu().numpy()
    check(bool(np.all(zf < 5)), f"forward-pass ELBO gradient off the exact one by {zf.tolist()} SE")
    rev_ms = wall_ms(lambda: batched(lanes, phi0), reps=5)
    fwd_ms = wall_ms(lambda: forward_grad(phi0), reps=3)

    # the descent: warm up, then VI_STEPS timed steps on the host clock
    phi = phi0
    for _ in range(VI_WARMUP):
        phi = step(phi)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(VI_STEPS):
        phi = step(phi)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = wall_s / VI_STEPS * 1e3
    busy = device_busy(lambda: step(phi))
    loss1, _ = exact_neg_elbo(phi.cpu().numpy())
    check(math.isfinite(loss1) and loss1 < loss0, f"exact negative ELBO {loss1} after the descent vs {loss0} at phi0")
    phase("main path vi", f"{smi}: bench_vi's ELBO, {VI_BATCH} gradient estimates a step (torch.func.vmap "
                          f"of vi.ELBO's grad_estimate): at phi0 the mean within {float(z.max()):.2f} SE of the "
                          f"exact float64 gradient (limit 5; {np.round(mean, 4).tolist()} vs "
                          f"{np.round(exact, 4).tolist()}); {VI_WARMUP} + {VI_STEPS} steps of {VI_LR}: "
                          f"{step_ms:.3f} ms a step (host clock, mean of {VI_STEPS}) = "
                          f"{VI_BATCH / step_ms * 1e3:.6g} gradient estimates/s; exact negative ELBO "
                          f"{loss0:.4f} -> {loss1:.4f} (phi {np.round(phi.cpu().numpy(), 4).tolist()}); "
                          + busy_line("a step", busy, step_ms))
    phase("main path vi", f"{smi}: the gradient pass at {VI_BATCH} x 5 parameters: one reverse pass "
                          f"(torch.func.grad over the transformed run, the port's design) {rev_ms:.3f} ms; "
                          f"one forward pass a parameter (5 jvp_estimate passes) {fwd_ms:.3f} ms, "
                          f"{fwd_ms / rev_ms:.2f}x; its mean within {float(zf.max()):.2f} SE of the exact "
                          f"gradient (host clock, median)")


def adev_path(device, smi: str) -> None:
    """``[adev]``: the ``@expectation`` docstring example (d/dp of
    ``flip_enum`` exactly 1), and ``normal_reparam`` and ``beta_implicit``
    at 2^20 vmapped estimates against their closed forms."""
    from genjax_tpu_torch.adev import beta_implicit, expectation, flip_enum, normal_reparam

    gen = torch.Generator(device=device).manual_seed(SEED)

    @expectation
    def obj(p):
        return torch.where(flip_enum(p), 1.0, 0.0)

    (dp,) = obj.grad_estimate(gen, (0.3,))
    check(dp.device.type == device.type and float(dp) == 1.0, f"d/dp of the flip_enum example is {float(dp)}, not 1")

    @expectation
    def quad(mu):
        return (normal_reparam(mu, 1.0) - 2.0) ** 2

    @expectation
    def beta_mean(ab):
        a, b = ab
        return beta_implicit(a, b)

    lanes = torch.zeros(ADEV_LANES, device=device)
    quad_b = torch.func.vmap(lambda _: quad.grad_estimate(gen, (0.5,))[0], randomness="different")
    beta_b = torch.func.vmap(lambda _: torch.stack(beta_mean.grad_estimate(gen, ((2.0, 2.0),))[0]),
                             randomness="different")
    gq, gb = quad_b(lanes).double(), beta_b(lanes).double()
    zq = abs(float(gq.mean()) + 3.0) / (float(gq.std()) / math.sqrt(ADEV_LANES))
    want = torch.tensor([0.125, -0.125], dtype=torch.float64, device=device)
    zb = ((gb.mean(0) - want).abs() / (gb.std(0) / math.sqrt(ADEV_LANES))).max().item()
    check(zq < 5 and zb < 5, f"normal_reparam off -3 by {zq:.2f} SE, beta_implicit off (1/8, -1/8) by {zb:.2f} SE")
    q_ms, b_ms = wall_ms(lambda: quad_b(lanes)), wall_ms(lambda: beta_b(lanes))
    phase("adev", f"{smi}: d/dp E[flip_enum(p)] = {float(dp)} (exact); normal_reparam d/dmu E[(x - 2)^2] "
                  f"at mu 0.5: {float(gq.mean()):.5f} (exact -3, {zq:.2f} SE) over {ADEV_LANES} vmapped "
                  f"estimates in {q_ms:.3f} ms; beta_implicit d/da, d/db E[Beta(2, 2)]: "
                  f"{gb.mean(0).cpu().numpy().round(5).tolist()} (exact 1/8, -1/8, {zb:.2f} SE) in "
                  f"{b_ms:.3f} ms (host clock, median of 3)")


def catalog_cases():
    """The chip phase's parameters of each of the 48 distributions, and
    scipy's float64 distribution where it has one (else None: the CPU port's
    own draws stand in)."""
    import scipy.stats as ss

    logp = np.log([0.2, 0.3, 0.5]).astype(np.float32)
    alpha = np.asarray([2.0, 3.0, 4.0], np.float32)
    logit = lambda p: float(np.log(p / (1 - p)))  # noqa: E731
    return {
        "normal": ((0.3, 1.7), ss.norm(0.3, 1.7)),
        "cauchy": ((0.5, 2.0), ss.cauchy(0.5, 2.0)),
        "laplace": ((0.5, 2.0), ss.laplace(0.5, 2.0)),
        "logistic": ((0.5, 2.0), ss.logistic(0.5, 2.0)),
        "gumbel": ((0.5, 2.0), ss.gumbel_r(0.5, 2.0)),
        "student_t": ((4.0, 0.5, 2.0), ss.t(4.0, 0.5, 2.0)),
        "half_normal": ((1.5,), ss.halfnorm(0, 1.5)),
        "half_cauchy": ((0.0, 1.5), ss.halfcauchy(0, 1.5)),
        "half_student_t": ((4.0, 0.0, 1.5), None),
        "uniform": ((1.0, 3.0), ss.uniform(1.0, 2.0)),
        "exponential": ((2.0,), ss.expon(scale=0.5)),
        "gamma": ((2.0, 3.0), ss.gamma(2.0, scale=1 / 3)),
        "inverse_gamma": ((5.0, 3.0), ss.invgamma(5.0, scale=3.0)),
        "chi": ((3.0,), ss.chi(3.0)),
        "chi2": ((3.0,), ss.chi2(3.0)),
        "weibull": ((2.0, 1.5), ss.weibull_min(2.0, scale=1.5)),
        "log_normal": ((0.3, 0.8), ss.lognorm(0.8, scale=np.exp(0.3))),
        "logit_normal": ((0.3, 0.8), None),
        "truncated_normal": ((0.0, 1.0, -1.0, 2.0), ss.truncnorm(-1.0, 2.0)),
        "truncated_cauchy": ((0.0, 1.0, -2.0, 3.0), None),
        "kumaraswamy": ((2.0, 3.0), None),
        "moyal": ((0.5, 2.0), ss.moyal(0.5, 2.0)),
        "double_sided_maxwell": ((0.5, 1.0), None),
        "exp_gamma": ((2.0, 1.5), None),
        "exp_inverse_gamma": ((2.0, 1.5), None),
        "inverse_gaussian": ((2.0, 3.0), ss.invgauss(2.0 / 3.0, scale=3.0)),
        "von_mises": ((0.0, 2.0), ss.vonmises(2.0)),
        "lambert_w_normal": ((0.3, 1.0, 0.1), None),
        "beta": ((2.0, 3.0), ss.beta(2.0, 3.0)),
        "bernoulli": ((logit(0.3),), ss.bernoulli(0.3)),
        "flip": ((0.3,), ss.bernoulli(0.3)),
        "categorical": ((logp,), None),
        "binomial": ((10.0, logit(0.4)), ss.binom(10, 0.4)),
        "geometric": ((logit(0.3),), ss.geom(0.3, loc=-1)),
        "poisson": ((3.5,), ss.poisson(3.5)),
        "negative_binomial": ((5.0, logit(0.4)), ss.nbinom(5, 0.6)),
        "beta_binomial": ((10.0, 2.0, 3.0), ss.betabinom(10, 2.0, 3.0)),
        "skellam": ((3.0, 2.0), ss.skellam(3.0, 2.0)),
        "zipf": ((5.5,), ss.zipf(5.5)),
        "non_central_chi2": ((3.0, 1.5), ss.ncx2(3.0, 1.5)),
        "dirichlet": ((alpha,), None),
        "multinomial": ((5.0, logp), None),
        "dirichlet_multinomial": ((5.0, alpha), None),
        "mv_normal_diag": ((np.asarray([0.5, -0.5, 0.0], np.float32), np.asarray([1.5, 0.5, 1.0], np.float32)), None),
        "mv_normal": ((np.asarray([0.5, -0.5], np.float32), np.asarray([[2.0, 0.3], [0.3, 1.0]], np.float32)), None),
        "power_spherical": ((np.asarray([0.0, 0.0, 1.0], np.float32), 5.0), None),
        "von_mises_fisher": ((np.asarray([0.0, 0.0, 1.0], np.float32), 5.0), None),
        "beta_quotient": ((3.0, 2.0, 4.0, 2.0), None),
    }


def catalog_path(device, smi: str, g) -> None:
    """``[catalog]``: 2^20 draws of each of the 48 distributions on the
    card from one generator, timed; the card's log-density of those values
    against the CPU port's; mean (and variance where scipy's fourth moment
    is finite) within 5 SE of scipy's float64 moments, and the CDF at the
    quartiles within 5 SE, or, with no scipy counterpart, within 5 combined
    SE of the CPU port's own 2^20 draws."""
    from genjax_tpu_torch.dists import catalog

    cases = catalog_cases()
    check(sorted(cases) == sorted(catalog.__all__) and len(cases) == 48, "the chip phase does not cover the 48")
    gen = torch.Generator(device=device).manual_seed(SEED)
    cpu_gen = torch.Generator().manual_seed(SEED)
    times = []
    n = CATALOG_N
    for name in sorted(cases):
        args, ref = cases[name]
        d = getattr(g, name)
        on_card = [torch.as_tensor(a, device=device) if isinstance(a, np.ndarray) else a for a in args]
        x = d.sample(gen, *on_card, sample_shape=(n,))  # first call outside the clock
        ms = wall_ms(lambda: d.sample(gen, *on_card, sample_shape=(n,)))
        check(x.device.type == device.type and x.shape[0] == n, f"{name}: draws {tuple(x.shape)} on {x.device}")
        lp_card = d.logpdf(x, *on_card).cpu()
        lp_cpu = d.logpdf(x.cpu(), *args)
        fin = torch.isfinite(lp_cpu)
        check(bool(torch.equal(fin, torch.isfinite(lp_card))) and bool(fin.all()),
              f"{name}: the log-density's finite values differ between the card and the CPU, or a draw scores "
              "outside the support")
        lp_err = float(((lp_card - lp_cpu).abs() / lp_cpu.abs().clamp_min(1.0)).max())
        check(lp_err <= CATALOG_LP_TOL, f"{name}: card log-density off the CPU's by {lp_err:.3g} (limit {CATALOG_LP_TOL})")
        xs = x.double().reshape(n, -1).cpu()
        m, sd = xs.mean(0), xs.std(0)
        if ref is not None:
            mean, var, kurt = (float(v) for v in ref.stats(moments="mvk"))
            worst = 0.0
            if math.isfinite(var):
                worst = abs(float(m[0]) - mean) / math.sqrt(var / n)
            if math.isfinite(kurt):
                m4 = float(((xs[:, 0] - m[0]) ** 4).mean())
                worst = max(worst, abs(float(sd[0]) ** 2 - var) / math.sqrt(max(m4 - var * var, 1e-30) / n))
            for q in (0.25, 0.5, 0.75):
                at = float(ref.ppf(q))
                p = float(ref.cdf(at))
                if 0 < p < 1:
                    worst = max(worst, abs(float((xs[:, 0] <= at).double().mean()) - p) / math.sqrt(p * (1 - p) / n))
            against = "scipy"
        else:
            y = d.sample(cpu_gen, *args, sample_shape=(n,)).double().reshape(n, -1)
            se = torch.sqrt((xs.var(0) + y.var(0)) / n).clamp_min(1e-12)
            worst = float(((m - y.mean(0)).abs() / se).max())
            v4 = lambda s: ((s - s.mean(0)) ** 4).mean(0) - s.var(0) ** 2  # noqa: E731
            se_v = torch.sqrt((v4(xs) + v4(y)) / n).clamp_min(1e-12)
            worst = max(worst, float(((xs.var(0) - y.var(0)).abs() / se_v).max()))
            against = "the CPU port's draws"
        check(worst < 5, f"{name}: 2^20 draws off {against} by {worst:.2f} SE")
        times.append((name, ms))
        phase("catalog", f"{smi}: {name}{tuple(args) if len(str(args)) < 60 else ''}: {n} draws in {ms:.3f} ms "
                         f"(host clock, median of 3, {n / ms * 1e3:.6g} draws/s); logpdf card vs CPU within "
                         f"{lp_err:.3g} (limit {CATALOG_LP_TOL}, relative to max(1, |value|)); moments within "
                         f"{worst:.2f} SE of {against} (limit 5)")
    # torch_distribution: a draw that is a function of the card's generator
    td = g.torch_distribution(torch.distributions.Normal, "normal_td")
    loc, scale = torch.tensor(0.3, device=device), torch.tensor(1.7, device=device)
    a, b = (td.sample(torch.Generator(device=device).manual_seed(SEED), loc, scale, sample_shape=(n,))
            for _ in range(2))
    z_td = abs(float(a.double().mean()) - 0.3) / (1.7 / math.sqrt(n))
    check(a.device.type == device.type and torch.equal(a, b) and z_td < 5,
          f"torch_distribution: draws not a function of the generator, or off N(0.3, 1.7) by {z_td:.2f} SE")
    total = sum(ms for _, ms in times)
    slow = sorted(times, key=lambda t: -t[1])[:3]
    phase("catalog", f"{smi}: 48 distributions x {n} draws in {total:.2f} ms in all; slowest "
                     + ", ".join(f"{name} {ms:.3f} ms" for name, ms in slow)
                     + f"; torch_distribution(Normal) repeats under one seed, mean within {z_td:.2f} SE")


def glm_path(device, smi: str, g) -> None:
    """``[main path glm]``: ``poisson_regression`` at n = 100,000, d = 16
    (numpy seed 0), ``fit_map`` and ``laplace_approximation`` on the card,
    the mode against the float64 Newton optimum and the covariance against
    the float64 inverse Hessian, both to 1e-3 relative."""
    from genjax_tpu_torch.inference import fit_map, laplace_approximation
    from genjax_tpu_torch.models import poisson_regression

    rng = np.random.default_rng(0)
    X = (rng.normal(size=(GLM_N, GLM_D)) / 4).astype(np.float32)
    w_true = rng.normal(size=GLM_D) * 0.5
    Y = rng.poisson(np.exp(X.astype(np.float64) @ w_true)).astype(np.float32)
    Xd, Yd = X.astype(np.float64), Y.astype(np.float64)
    w64 = np.zeros(GLM_D)
    for _ in range(30):
        rate = np.exp(Xd @ w64)
        w64 -= np.linalg.solve(np.eye(GLM_D) + Xd.T @ (rate[:, None] * Xd), w64 + Xd.T @ (rate - Yd))
    rate = np.exp(Xd @ w64)
    cov64 = np.linalg.inv(np.eye(GLM_D) + Xd.T @ (rate[:, None] * Xd))

    model = poisson_regression(X)
    obs = g.C["obs", torch.arange(GLM_N, device=device), "y"].set(torch.as_tensor(Y, device=device))
    kw = dict(n_steps=GLM_STEPS, learning_rate=GLM_LR, device=device)
    res = fit_map(SEED, model, obs, (), g.S["w"], **kw)
    lap = laplace_approximation(SEED, model, obs, (), g.S["w"], **kw)
    check(res["w"].device.type == device.type == lap.cov.device.type, "the GLM did not run on the card")
    mode_err = float(np.linalg.norm(res["w"].double().cpu().numpy() - w64) / np.linalg.norm(w64))
    lap_mode_err = float(np.linalg.norm(lap.mean.double().cpu().numpy() - w64) / np.linalg.norm(w64))
    cov_err = float(np.linalg.norm(lap.cov.double().cpu().numpy() - cov64) / np.linalg.norm(cov64))
    check(max(mode_err, lap_mode_err) < GLM_TOL and cov_err < GLM_TOL,
          f"GLM mode {mode_err:.3g} / {lap_mode_err:.3g} and covariance {cov_err:.3g} off float64 (limit {GLM_TOL})")
    fit_ms = wall_ms(lambda: fit_map(SEED, model, obs, (), g.S["w"], **kw), reps=1)
    lap_ms = wall_ms(lambda: laplace_approximation(SEED, model, obs, (), g.S["w"], **kw), reps=1)
    fit_busy = device_busy(lambda: fit_map(SEED, model, obs, (), g.S["w"], **kw))
    lap_busy = device_busy(lambda: laplace_approximation(SEED, model, obs, (), g.S["w"], **kw))
    phase("main path glm", f"{smi}: poisson_regression n {GLM_N}, d {GLM_D}: fit_map ({GLM_STEPS} Adam steps "
                           f"of {GLM_LR}, 8 restarts) mode within {mode_err:.3g} relative of the float64 "
                           f"Newton optimum, laplace_approximation's within {lap_mode_err:.3g} and its "
                           f"covariance within {cov_err:.3g} of the float64 inverse Hessian (limit "
                           f"{GLM_TOL}); fit_map {fit_ms:.1f} ms, laplace_approximation {lap_ms:.1f} ms "
                           f"(host clock, one call each); " + busy_line("fit_map", fit_busy, fit_ms) + "; "
                           + busy_line("laplace_approximation", lap_busy, lap_ms))


def advi_path(device, smi: str) -> None:
    """``[advi]``: full-rank ``"stl"`` ADVI (``column_advi``) on
    ``dense_target``, ``bench_dense``'s 128-d correlated Gaussian: the
    covariance of ``ADVI_DRAWS`` draws from the fit against the target's
    within ``cov_bound``, their mean within 5 SE of 0."""
    from genjax_tpu_torch.inference import column_advi

    model, sigma = dense_target(device)

    def cosine(step):
        # a constant rate lets Adam kick the fit off its optimum once STL's
        # gradients vanish there (the ELBO dropped 0.9 nats between steps
        # 300 and 500 at a constant 0.01, on the CPU); decayed, it settles
        return ADVI_LR * 0.5 * (1.0 + math.cos(math.pi * min(step, ADVI_STEPS) / ADVI_STEPS))

    t0 = time.perf_counter()
    post = column_advi(SEED, model, None, (), ["x"], rank="full", estimator="stl", n_steps=ADVI_STEPS,
                       learning_rate=cosine, n_samples=ADVI_SAMPLES, device=device)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    res = post.result
    check(res.mu.device.type == device.type, "ADVI did not run on the card")
    draws = res.sample(torch.Generator(device=device).manual_seed(SEED + 1), ADVI_DRAWS).T
    err, lim = cov_error(draws, sigma), cov_bound(sigma, ADVI_DRAWS)
    z = float((draws.double().mean(0).cpu() / torch.sqrt(torch.as_tensor(np.diag(sigma).copy()) / ADVI_DRAWS)).abs().max())
    direct = float(np.linalg.norm(res.cov.double().cpu().numpy() - sigma) / np.linalg.norm(sigma))
    check(err < lim and z < 5, f"ADVI covariance error {err:.4f} (limit {lim:.4f}), mean {z:.2f} SE (limit 5)")
    phase("advi", f"{smi}: column_advi full rank, stl, {DENSE_D}-d dense target, {ADVI_STEPS} Adam steps from "
                  f"{ADVI_LR} cosine-decayed, {ADVI_SAMPLES} samples a step: {call_s:.2f} s (host clock, one call) = "
                  f"{call_s / ADVI_STEPS * 1e3:.3f} ms a step; covariance of {ADVI_DRAWS} draws off the "
                  f"target's by {err:.4f} (relative Frobenius; limit {lim:.4f}), the fit's own "
                  f"{direct:.4f}; mean within {z:.2f} SE (limit 5); final ELBO {float(res.elbo):.4f} "
                  f"(the target is normalised: 0 at the optimum)")


def vi_path(device, smi: str, g) -> None:
    """Slice 12's phases: VI's main path, ADEV, the catalog, the GLM's MAP
    and Laplace fits and ADVI."""
    t0 = time.perf_counter()
    vi_main_path(device, smi, g)
    adev_path(device, smi)
    catalog_path(device, smi, g)
    glm_path(device, smi, g)
    advi_path(device, smi)
    phase("vi", f"{smi}: the catalog, ADEV, VI, GLM and ADVI phases took {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------------
# slice 13: the discrete HMM and its exact tools, enumeration and Gibbs,
# particle Gibbs and PMMH, the ESS and slice requests, involutive MCMC,
# predictive checks and SBC, PPCA and the BNN (no kernel)
# ----------------------------------------------------------------------

HMM_N, HMM_T = 64, 4096
HMM_FFBS_PATHS = 16384  # (16,384 x 4,096) int64 paths: 537 MB
HMM_VITERBI_DRAWS = 1024
HMM_MARGINAL_STEPS = 8
HMM_LOGPDF_DRAWS = 16
GIBBS_CHAINS, GIBBS_SWEEPS, GIBBS_BURN = 16384, 400, 100
GIBBS_X = 1.4
GIBBS_LANES = 4096
# 200 sweeps after 50 of burn-in: the run's slowest path, kept short so that
# the script, with the cookbooks' process beside it, stays well inside its
# time; the gate below is in SEs of the draws kept
PG_STATES, PG_T, PG_PARTICLES, PG_SWEEPS, PG_BURN = 16, 64, 256, 200, 50
# tests/inference/test_pgibbs.py holds 500 draws' smoothed means within 0.25
# of the RTS smoother's, whose sds are about 0.41 (13.6 SE of independent
# draws), and their variances within a ratio of 0.5 to 1.7 (7.9 and 11 SE):
# about 8 SE. Here each state's smoothed probability at each step is held
# within 8 SE of independent draws, sqrt(p (1 - p) / n), plus 1e-3
PG_SES = 8.0
PMMH_T, PMMH_STEPS, PMMH_PARTICLES = 10, 200, 256
REQ_CHAINS, REQ_STEPS = 65536, 20
INV_CHAINS, INV_SWEEPS, RJ_SWEEPS = 65536, 40, 30
INV_X = 1.2
RJ_YS = (-0.8, -0.5, 0.4, 0.7)
SBC_SIMS, SBC_DRAWS = 16384, 100
PRED_DRAWS = 65536
# the noise sd 2 (W ~ N(0, 1)): at sd 0.5 EM's convergence is slow, 1.4% short
# of the ML likelihood after 50 iterations (the port and the reference alike)
PPCA_N, PPCA_D, PPCA_Q, PPCA_SIGMA, PPCA_EM_ITERS = 100_000, 64, 8, 2.0, 50
BNN_N, BNN_D, BNN_HIDDEN, BNN_DRAWS, BNN_PREDICT_N = 10_000, 16, 64, 4096, 1024
BNN_STEPS, BNN_LR = 1000, 0.03  # the rate cosine-decayed to 0, as advi_path's
BNN_TOL = 0.05  # tests/models/test_bnn.py's on the posterior mean


def timed(fn):
    """``(fn(), host-clock seconds)``, the card synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel_gap(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(1.0, abs(b))


def in_law_gap(x: torch.Tensor, mean, var) -> tuple[float, float]:
    """The largest gap of the mean and of the variance of ``x (n, ...)`` to
    the closed form's, each in its standard errors (``sqrt(var / n)``,
    ``var sqrt(2 / n)``)."""
    x = x.double().reshape(x.shape[0], -1)
    n = x.shape[0]
    mean = torch.as_tensor(np.array(mean, np.float64), device=x.device).reshape(-1)
    var = torch.as_tensor(np.array(var, np.float64), device=x.device).reshape(-1)
    zm = ((x.mean(0) - mean).abs() / torch.sqrt(var / n)).max()
    zv = ((x.var(0) - var).abs() / (var * math.sqrt(2.0 / n))).max()
    return float(zm), float(zv)


def numpy_circulant_logits(n: int, k: int, s: float) -> np.ndarray:
    """The banded circulant logits in float64, written from the definition:
    ``s ** d`` at cyclic distance ``d <= k``, ``-1 / s`` beyond (``s > 0``)."""
    i = np.arange(n)
    d = np.abs(i[:, None] - i[None, :])
    d = np.minimum(d, n - d)
    return np.where(d <= k, s ** d.astype(np.float64), -1.0 / s)


def numpy_log_softmax(a: np.ndarray) -> np.ndarray:
    from scipy.special import logsumexp

    return a - logsumexp(a, axis=-1, keepdims=True)


def numpy_hmm_forward(log_pi, log_trans, log_obs, ys) -> float:
    """The float64 forward pass: ``log p(y)``."""
    from scipy.special import logsumexp

    alpha = log_pi + log_obs[:, ys[0]]
    for y in ys[1:]:
        alpha = log_obs[:, y] + logsumexp(alpha[:, None] + log_trans, axis=0)
    return float(logsumexp(alpha))


def numpy_path_log_joint(log_pi, log_trans, log_obs, zs, ys) -> np.ndarray:
    """``log p(z, y)`` of each path of ``zs (n, T)``, float64."""
    zs = np.atleast_2d(zs)
    return (log_pi[zs[:, 0]] + log_trans[zs[:, :-1], zs[:, 1:]].sum(1) + log_obs[zs, ys[None, :]].sum(1))


def hmm_path(device, smi: str) -> None:
    """``[main path hmm]``: ``DiscreteHMMConfiguration(64, 3, 3, 1, 1)`` over
    4,096 observations simulated by ``discrete_hmm_model``: the three log
    marginals against each other and float64 numpy, both Viterbi passes,
    16,384 FFBS paths against the smoothed marginals, ``DiscreteHMM``'s
    density, and the sequential passes timed beside the parallel ones."""
    from genjax_tpu_torch.dists import DiscreteHMM, DiscreteHMMConfiguration
    from genjax_tpu_torch.dists import discrete_hmm as dh
    from genjax_tpu_torch.dists import hmm_tools as ht
    from genjax_tpu_torch.generative.choice_map import ChoiceMap
    from genjax_tpu_torch.models import discrete_hmm_model

    cfg = DiscreteHMMConfiguration(HMM_N, 3, 3, 1.0, 1.0)
    gen = torch.Generator(device=device).manual_seed(SEED)
    chain, _ = discrete_hmm_model(cfg, HMM_T)
    tr, sim_s = timed(lambda: chain.simulate(gen, (torch.tensor(HMM_N // 2, device=device),
                                                   torch.zeros(HMM_T, device=device))))
    ys = tr.get_choices()[:, "x"]
    check(ys.device.type == device.type and tuple(ys.shape) == (HMM_T,), "the HMM did not simulate on the card")
    lp, lt, lo = cfg.log_initial(device), cfg.log_transition(device), cfg.log_observation(device)
    for warm in (lambda y: dh.forward_filter(cfg, y), lambda y: ht.hmm_log_marginal(lp, lt, lo, y),
                 lambda y: ht.forward_parallel(lp, lt, lo, y), lambda y: ht.viterbi(lp, lt, lo, y),
                 lambda y: ht.viterbi_parallel(lp, lt, lo, y), lambda y: ht.forward_backward(lp, lt, lo, y)):
        warm(ys[:16])

    (filters, lm_ff), ff_s = timed(lambda: dh.forward_filter(cfg, ys))
    lm_seq, seq_s = timed(lambda: ht.hmm_log_marginal(lp, lt, lo, ys))
    (_, lm_par), par_s = timed(lambda: ht.forward_parallel(lp, lt, lo, ys))
    ys_np = ys.cpu().numpy()
    lt64 = numpy_log_softmax(numpy_circulant_logits(HMM_N, 3, 1.0))
    lo64 = lt64.copy()  # the same band and sigma
    lp64 = lt64[HMM_N // 2]
    lm64 = numpy_hmm_forward(lp64, lt64, lo64, ys_np)
    gaps = [rel_gap(lm_seq, lm_ff), rel_gap(lm_par, lm_ff)]
    gaps64 = [rel_gap(v, lm64) for v in (lm_ff, lm_seq, lm_par)]
    check(max(gaps) <= 1e-5 and max(gaps64) <= 1e-4,
          f"HMM log marginals {float(lm_ff)}, {float(lm_seq)}, {float(lm_par)} vs float64 {lm64}")

    (path_s, score_s), vit_s = timed(lambda: ht.viterbi(lp, lt, lo, ys))
    (path_p, score_p), vitp_s = timed(lambda: ht.viterbi_parallel(lp, lt, lo, ys))
    j_s, j_p = numpy_path_log_joint(lp64, lt64, lo64, np.stack([path_s.cpu().numpy(), path_p.cpu().numpy()]), ys_np)
    check(abs(j_s - j_p) <= 1e-3, f"Viterbi paths' log joints {j_s} and {j_p} (float64) differ")

    n = HMM_FFBS_PATHS
    paths, ffbs_s = timed(lambda: torch.func.vmap(lambda _: dh.backward_sample(gen, cfg, filters),
                                                  randomness="different")(torch.zeros(n, device=device)))
    check(tuple(paths.shape) == (n, HMM_T) and paths.dtype == torch.int64, f"FFBS paths {tuple(paths.shape)}")
    j_draws = numpy_path_log_joint(lp64, lt64, lo64, paths[:HMM_VITERBI_DRAWS].cpu().numpy(), ys_np)
    check(float(j_draws.max()) <= min(j_s, j_p) + 1e-3,
          f"an FFBS draw's log joint {float(j_draws.max())} beats Viterbi's {min(j_s, j_p)}")
    (post, fb_s) = timed(lambda: ht.forward_backward(lp, lt, lo, ys))
    gammas = torch.exp(post.log_gammas.double())
    steps = np.linspace(0, HMM_T - 1, HMM_MARGINAL_STEPS).astype(int)
    worst = -math.inf
    for t in steps:
        freq = torch.bincount(paths[:, t], minlength=HMM_N).double() / n
        se = torch.sqrt(gammas[t] * (1 - gammas[t]) / n)
        worst = max(worst, float(((freq - gammas[t]).abs() - 1e-3 - 4 * se).max()))
    check(worst <= 0, f"FFBS marginals off the smoothed ones by {worst} beyond 4 SE + 1e-3")

    draws = paths[:HMM_LOGPDF_DRAWS]
    w = torch.func.vmap(lambda z: DiscreteHMM.assess(ChoiceMap.entry(z), (cfg, ys))[0])(draws)
    want = torch.func.vmap(lambda z: dh.path_log_joint(cfg, z, ys))(draws) - lm_ff
    w64 = numpy_path_log_joint(lp64, lt64, lo64, draws.cpu().numpy(), ys_np) - lm64
    check(float((w - want).abs().max()) <= 1e-3,
          f"DiscreteHMM.logpdf off path_log_joint - log marginal by {float((w - want).abs().max())}")
    busy_ff = device_busy(lambda: dh.forward_filter(cfg, ys))
    busy_par = device_busy(lambda: ht.forward_parallel(lp, lt, lo, ys))
    phase("main path hmm", f"{smi}: DiscreteHMMConfiguration({HMM_N}, 3, 3, 1.0, 1.0), T = {HMM_T} simulated by "
                           f"discrete_hmm_model in {sim_s:.3f} s; log p(y) {float(lm_ff):.6f}: forward_filter, "
                           f"hmm_log_marginal, forward_parallel within {max(gaps):.3g} of each other (limit 1e-5), "
                           f"of float64 numpy's {lm64:.6f} within {max(gaps64):.3g} (limit 1e-4); Viterbi log "
                           f"joints {j_s:.4f} and {j_p:.4f} (float64), the best of {HMM_VITERBI_DRAWS} FFBS draws "
                           f"{float(j_draws.max()):.4f}; {n} FFBS paths in {ffbs_s:.3f} s, their marginals at "
                           f"{HMM_MARGINAL_STEPS} steps within 4 SE + 1e-3 (margin {-worst:.3g}); DiscreteHMM.logpdf "
                           f"of {HMM_LOGPDF_DRAWS} draws within {float((w - want).abs().max()):.3g} of the formula, "
                           f"{float(np.abs(w.double().cpu().numpy() - w64).max()):.3g} of float64")
    phase("main path hmm", f"{smi}: sequential against parallel (host clock, one call each): forward_filter "
                           f"{ff_s * 1e3:.1f} ms, hmm_log_marginal {seq_s * 1e3:.1f} ms, forward_parallel "
                           f"{par_s * 1e3:.1f} ms ({seq_s / par_s:.2f}x); viterbi {vit_s * 1e3:.1f} ms, "
                           f"viterbi_parallel {vitp_s * 1e3:.1f} ms ({vit_s / vitp_s:.2f}x); forward_backward "
                           f"{fb_s * 1e3:.1f} ms; " + busy_line("forward_filter", busy_ff, ff_s * 1e3) + "; "
                           + busy_line("forward_parallel", busy_par, par_s * 1e3))


def gibbs_path(device, smi: str, g) -> None:
    """``[main path gibbs]``: Gibbs within MH (``enum_move`` on ``z``,
    ``mh_move(HMC)`` on ``mu``) on the reference test's ``mixed_model``,
    vmapped over 16,384 chains for 400 sweeps, against the closed form; and
    ``enumerative_gibbs_vmap`` over 4,096 lanes against float64 numpy."""
    from scipy.special import logsumexp
    from scipy.stats import norm

    from genjax_tpu_torch.inference.gibbs import enum_move, enumerative_gibbs_vmap, gibbs_sweep, mh_move
    from genjax_tpu_torch.inference.requests import HMC

    @g.gen
    def mixed_model():
        mu = g.normal(0.0, 1.0) @ "mu"
        z = g.flip(0.3) @ "z"
        return g.normal(mu + 2.0 * z.to(torch.float32), 1.0) @ "x"

    lw = np.array([np.log(0.7) + norm.logpdf(GIBBS_X, 0.0, np.sqrt(2.0)),
                   np.log(0.3) + norm.logpdf(GIBBS_X, 2.0, np.sqrt(2.0))])
    p_z = np.exp(lw - logsumexp(lw))
    mu_mean = float(p_z @ np.array([GIBBS_X / 2.0, (GIBBS_X - 2.0) / 2.0]))
    gen = torch.Generator(device=device).manual_seed(SEED)
    moves = [enum_move("z", torch.tensor([False, True], device=device)), mh_move(HMC(g.S["mu"], 0.25, 8))]

    def run(n_sweeps, n_chains):
        def chain(_):
            tr, _ = mixed_model.generate(gen, g.C["x"].set(GIBBS_X), ())
            res = gibbs_sweep(gen, tr, moves, n_sweeps=n_sweeps,
                              record=lambda t: (t.get_choices()["z"].to(torch.float32), t.get_choices()["mu"]))
            return res.history

        return torch.func.vmap(chain, randomness="different")(torch.zeros(n_chains, device=device))

    run(2, 16)  # warm-up
    (zs, mus), run_s = timed(lambda: run(GIBBS_SWEEPS, GIBBS_CHAINS))
    zgaps = []
    for draws, want in ((zs, p_z[1]), (mus, mu_mean)):
        means = draws[:, GIBBS_BURN:].double().mean(dim=1)
        se = float(means.std() / math.sqrt(GIBBS_CHAINS))
        zgaps.append((float(means.mean()), want, abs(float(means.mean()) - want) / se))
    check(all(z < 4 for _, _, z in zgaps), f"Gibbs within MH off the closed form: {zgaps}")
    sweep_ms = wall_ms(lambda: run(1, GIBBS_CHAINS), reps=3)
    busy = device_busy(lambda: run(1, GIBBS_CHAINS))

    mus_t = torch.tensor([-2.0, 0.0, 3.0], device=device)
    log_pi = torch.log(torch.tensor([0.2, 0.5, 0.3], device=device))

    @g.gen
    def site(x):
        z = g.categorical(log_pi) @ "z"
        return g.normal(mus_t[z], 1.0) @ "y"

    @g.gen
    def lanes_model(xs):
        return site.vmap(in_axes=(0,))(xs) @ "assign"

    xs_np = np.random.default_rng(SEED).uniform(-3.0, 4.0, size=GIBBS_LANES).astype(np.float32)
    xs = torch.from_numpy(xs_np).to(device)
    tr, _ = lanes_model.generate(gen, g.C["assign", torch.arange(GIBBS_LANES, device=device), "y"].set(xs), (xs,))
    (new, info), lanes_s = timed(lambda: enumerative_gibbs_vmap(gen, tr, ("assign", None, "z"),
                                                                torch.arange(3, device=device)))
    lw64 = np.log([0.2, 0.5, 0.3])[None, :] + norm.logpdf(xs_np.astype(np.float64)[:, None], [-2.0, 0.0, 3.0], 1.0)
    exact = np.exp(lw64 - logsumexp(lw64, axis=1, keepdims=True))
    err = float(np.abs(torch.exp(info.log_probs.double()).cpu().numpy() - exact).max())
    check(err <= 1e-4, f"enumerative_gibbs_vmap's conditionals off float64 by {err}")
    phase("main path gibbs", f"{smi}: gibbs_sweep [enum_move(z), mh_move(HMC(mu, 0.25, 8))] on mixed_model "
                             f"(x = {GIBBS_X}), torch.func.vmap over {GIBBS_CHAINS} chains x {GIBBS_SWEEPS} sweeps "
                             f"in {run_s:.2f} s (host clock) = {run_s / GIBBS_SWEEPS * 1e3:.2f} ms a sweep; after "
                             f"{GIBBS_BURN}: P(z = 1) {zgaps[0][0]:.5f} vs {zgaps[0][1]:.5f} ({zgaps[0][2]:.2f} SE), "
                             f"E[mu] {zgaps[1][0]:.5f} vs {zgaps[1][1]:.5f} ({zgaps[1][2]:.2f} SE; limit 4, the SE "
                             f"over chain means); enumerative_gibbs_vmap over {GIBBS_LANES} lanes x 3 in "
                             f"{lanes_s * 1e3:.1f} ms, within {err:.3g} of float64 (limit 1e-4); "
                             + busy_line("one sweep", busy, sweep_ms))


def pgibbs_path(device, smi: str, g) -> None:
    """``[main path pgibbs]``: ``particle_gibbs`` with ancestor sampling on
    the exact testbed's chain (16 states, T = 64), 256 particles x 200
    sweeps, against ``forward_backward``'s smoothed marginals; one ``pmmh``
    run over a particle filter's estimate."""
    from genjax_tpu_torch.dists import hmm_tools as ht
    from genjax_tpu_torch.inference.exact_testbed import build_test_against_exact_inference
    from genjax_tpu_torch.inference.pgibbs import csmc_sweep, particle_gibbs, pmmh
    from genjax_tpu_torch.parallel import SSMParticleFilter

    make, chain, cfg = build_test_against_exact_inference(PG_T, PG_STATES, 1, 1, 0.5, 0.5)
    gen = torch.Generator(device=device).manual_seed(SEED)
    p = make(gen)
    kernel, xs = chain.gen_fn, torch.zeros(PG_T, device=device)
    obs = g.C[:, "x"].set(p.observation_sequence)
    out, pg_s = timed(lambda: particle_gibbs(gen, kernel, p.initial_state, xs, obs, latent_selection=g.S["z"],
                                             n_particles=PG_PARTICLES, n_sweeps=PG_SWEEPS, device=device))
    zs = out.trajectories["z"][PG_BURN:]
    n = zs.shape[0]
    check(tuple(out.trajectories["z"].shape) == (PG_SWEEPS, PG_T), "particle_gibbs's trajectories' shape")
    gam = torch.exp(ht.forward_backward(cfg.log_initial(device), cfg.log_transition(device),
                                        cfg.log_observation(device), p.observation_sequence).log_gammas.double())
    freq = torch.stack([torch.bincount(zs[:, t], minlength=PG_STATES).double() / n for t in range(PG_T)])
    ses = float((((freq - gam).abs() - 1e-3) / torch.sqrt(gam * (1 - gam) / n)).max())
    tv = float(0.5 * (freq - gam).abs().sum(dim=1).max())
    z0 = zs[:, 0].double() - zs[:, 0].double().mean()
    rho1 = float((z0[1:] * z0[:-1]).mean() / (z0 * z0).mean())
    check(ses <= PG_SES, f"particle Gibbs marginals off forward_backward's by {ses:.2f} SE + 1e-3 (limit {PG_SES})")
    last = torch.utils._pytree.tree_map(lambda v: v[-1], out.trajectories)
    busy = device_busy(lambda: csmc_sweep(gen, kernel, p.initial_state, xs, obs, last, latent_selection=g.S["z"],
                                          n_particles=PG_PARTICLES))
    sweep_ms = pg_s / (PG_SWEEPS + 1) * 1e3

    # pmmh: a drifted random walk's drift, on a particle filter's log marginal
    rng = np.random.default_rng(7)
    ys = (np.cumsum(0.6 + rng.normal(size=PMMH_T)) + 0.5 * rng.normal(size=PMMH_T)).astype(np.float32)

    @g.gen
    def drift_kernel(carry, x):
        z_prev, m = carry
        z = g.normal(z_prev + m, 1.0) @ "z"
        y = g.normal(z, 0.5) @ "y"
        return ((z, m), y)

    pf = SSMParticleFilter(drift_kernel, n_particles=PMMH_PARTICLES, ess_threshold=2.0)
    pobs = g.C[:, "y"].set(torch.from_numpy(ys).to(device))
    pxs = torch.zeros(PMMH_T, device=device)

    def pf_lz(pgen, m):
        return pf.run(pgen, (torch.zeros((), device=device), m), pxs, pobs, device=device).log_marginal

    res, pmmh_s = timed(lambda: pmmh(gen, 0.0, lambda m: -0.5 * m**2, pf_lz, n_steps=PMMH_STEPS, step_scales=0.5,
                                     device=device))
    acc = float(res.accept_rate)
    check(bool(torch.isfinite(res.log_zs).all()) and 0.0 < acc < 1.0,
          f"pmmh: log-evidence finite {bool(torch.isfinite(res.log_zs).all())}, acceptance {acc}")
    phase("main path pgibbs", f"{smi}: particle_gibbs (ancestor sampling) on the exact testbed's chain "
                              f"({PG_STATES} states, T = {PG_T}), {PG_PARTICLES} particles x {PG_SWEEPS} sweeps in "
                              f"{pg_s:.2f} s (host clock) = {sweep_ms:.1f} ms a sweep, {sweep_ms / PG_T:.2f} ms a "
                              f"step; after {PG_BURN}: every state's smoothed probability within {ses:.2f} SE + 1e-3 of "
                              f"forward_backward's (limit {PG_SES}), largest total variation of a marginal {tv:.4f}, "
                              f"lag-1 autocorrelation of z_0 across sweeps {rho1:.3f}; "
                              + busy_line("one conditional sweep", busy, sweep_ms))
    phase("main path pgibbs", f"{smi}: pmmh over SSMParticleFilter's log marginal ({PMMH_PARTICLES} particles, "
                              f"T = {PMMH_T}), {PMMH_STEPS} steps in {pmmh_s:.2f} s (host clock): acceptance {acc:.3f}, "
                              f"log-evidence finite, the drift's chain mean {float(res.params[PMMH_STEPS // 4:].mean()):.4f}")


def requests_path(device, smi: str, g) -> None:
    """``[main path slice requests]``: ``run_chains`` of ``mh(EllipticalSlice)``
    on the reference test's linear regression and of ``mh(SliceSample)`` on
    its normal-normal model, 65,536 chains x 20 transitions, against the
    closed forms; the lanes that ran out of budget counted in one more
    transition."""
    from genjax_tpu_torch.dists import mv_normal_diag
    from genjax_tpu_torch.inference.requests import EllipticalSlice, SliceSample

    rng = np.random.RandomState(0)
    X = rng.randn(10, 3).astype(np.float32)
    s = 0.5
    y = (X @ np.asarray([1.0, -1.0, 0.5]) + s * rng.randn(10)).astype(np.float32)
    cov = np.linalg.inv(np.eye(3) + X.T.astype(np.float64) @ X / s**2)
    m_post = cov @ (X.T.astype(np.float64) @ y) / s**2
    Xt = torch.from_numpy(X).to(device)

    @g.gen
    def linreg():
        w = mv_normal_diag(torch.zeros(3, device=device), torch.ones(3, device=device)) @ "w"
        mv_normal_diag(Xt @ w, s * torch.ones(10, device=device)) @ "y"

    @g.gen
    def nn_model():
        mu = g.normal(1.0, 2.0) @ "mu"
        g.normal(mu, 0.5) @ "y"

    v_nn = 1.0 / (1.0 / 4.0 + 1.0 / 0.25)
    m_nn = v_nn * (1.0 / 4.0 + 2.4 / 0.25)
    cases = [("EllipticalSlice", linreg, g.C["y"].set(torch.from_numpy(y).to(device)), EllipticalSlice(g.S["w"]),
              "w", m_post, cov),
             ("SliceSample", nn_model, g.C["y"].set(2.4), SliceSample(g.S["mu"]), "mu", np.array([m_nn]),
              np.array([[v_nn]]))]
    lines = []
    for name, model, obs, req, addr, mean, cov_ in cases:
        # each chain starts at an exact posterior draw, so the gate holds the
        # transitions' invariance (the ellipse through a prior draw mixes
        # slowly where the posterior is much narrower than the prior)
        m_t = torch.as_tensor(mean, dtype=torch.float32, device=device)
        l_t = torch.as_tensor(np.linalg.cholesky(cov_), dtype=torch.float32, device=device)

        def make(gen, model=model, obs=obs, addr=addr, m_t=m_t, l_t=l_t):
            start = m_t + l_t @ torch.randn(m_t.shape, generator=gen, device=device)
            return model.generate(gen, obs | g.C[addr].set(start if addr == "w" else start[0]), ())[0]

        g.run_chains(SEED, make, req, 1, 16, device=device)  # warm-up
        res, call_s = timed(lambda: g.run_chains(SEED, make, req, REQ_STEPS, REQ_CHAINS, device=device))
        zm, zv = in_law_gap(res.trace.get_choices()[addr], mean, np.diag(cov_))
        check(zm < 4 and zv < 4, f"{name}: means {zm:.2f} SE, variances {zv:.2f} SE off the closed form")
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        exhausted = torch.func.vmap(lambda tr: tr.edit(gen, req)[3].exhausted, randomness="different")(res.trace)
        busy = device_busy(lambda: g.run_chains(SEED, make, req, 1, REQ_CHAINS, device=device))
        lines.append(f"mh({name}) {REQ_CHAINS} chains x {REQ_STEPS} in {call_s:.3f} s (host clock) = "
                     f"{call_s / REQ_STEPS * 1e3:.1f} ms a transition from exact posterior draws, means within "
                     f"{zm:.2f} SE and variances "
                     f"within {zv:.2f} SE of the closed form (limit 4), {int(exhausted.sum())} of {REQ_CHAINS} lanes "
                     f"out of budget in one more transition; "
                     + busy_line("a one-transition call", busy, call_s / REQ_STEPS * 1e3))
    phase("main path slice requests", f"{smi}: " + "; ".join(lines))


def involutive_path(device, smi: str, g) -> None:
    """``[main path involutive]``: the reference test's random-walk
    involution on its conjugate model and its reversible-jump chain, each
    vmapped over 65,536 chains, in law; ``check=True`` on both."""
    from genjax_tpu_torch.inference.gibbs import gibbs_sweep
    from genjax_tpu_torch.inference.involutive import involutive_mh, involutive_move

    @g.gen
    def conj_model():
        mu = g.normal(0.0, 1.0) @ "mu"
        return g.normal(mu, 1.0) @ "x"

    @g.gen
    def rw_aux():
        return g.normal(0.0, 0.6) @ "eps"

    def rw_involution(t, u):
        return g.C["mu"].set(t["mu"] + u["eps"]) | g.C["x"].set(t["x"]), g.C["eps"].set(-u["eps"])

    ys = torch.tensor(RJ_YS, device=device)

    @g.gen
    def sat_model():
        k = g.flip(0.5) @ "k"
        theta = g.normal(0.0, 2.0) @ "theta"
        a = g.normal(0.0, 2.0) @ "a"
        b = g.normal(0.0, 2.0) @ "b"
        mus = torch.where(k, torch.stack([a, a, b, b]), theta.expand(4))
        _ = g.normal.vmap(in_axes=(0, None))(mus, 0.8) @ "ys"
        return k

    @g.gen
    def jump_aux():
        return g.normal(0.0, 1.2) @ "du"

    def jump_involution(t, u):
        theta, a, b, du = t["theta"], t["a"], t["b"], u["du"]
        t_new = (g.C["k"].set(torch.logical_not(t["k"])) | g.C["theta"].set((a + b) / 2.0)
                 | g.C["a"].set(theta - du) | g.C["b"].set(theta + du) | g.C["ys", :].set(t["ys", :]))
        return t_new, g.C["du"].set((b - a) / 2.0)

    @g.gen
    def refresh_aux():
        u1 = g.normal(0.0, 2.0) @ "u1"
        u2 = g.normal(0.0, 2.0) @ "u2"
        return u1 + u2

    def refresh_involution(t, u):
        k, theta, a, b, u1, u2 = t["k"], t["theta"], t["a"], t["b"], u["u1"], u["u2"]
        t_new = (g.C["k"].set(k) | g.C["theta"].set(torch.where(k, u1, theta)) | g.C["a"].set(torch.where(k, a, u1))
                 | g.C["b"].set(torch.where(k, b, u2)) | g.C["ys", :].set(t["ys", :]))
        return t_new, g.C["u1"].set(torch.where(k, theta, a)) | g.C["u2"].set(torch.where(k, u2, b))

    def sat_rw_involution(t, u):
        k, eps = t["k"], u["eps"]
        zero = torch.zeros_like(eps)
        t_new = (g.C["k"].set(k) | g.C["theta"].set(t["theta"] + torch.where(k, zero, eps))
                 | g.C["a"].set(t["a"] + torch.where(k, eps, zero)) | g.C["b"].set(t["b"] - torch.where(k, eps, zero))
                 | g.C["ys", :].set(t["ys", :]))
        return t_new, g.C["eps"].set(-eps)

    gen = torch.Generator(device=device).manual_seed(SEED)
    lanes = torch.zeros(INV_CHAINS, device=device)

    def conj_chains(n_sweeps):
        def chain(_):
            tr, _ = conj_model.generate(gen, g.C["x"].set(INV_X), ())
            return gibbs_sweep(gen, tr, [involutive_move(rw_aux, rw_involution)], n_sweeps=n_sweeps).trace
        return torch.func.vmap(chain, randomness="different")(lanes)

    moves = [involutive_move(jump_aux, jump_involution), involutive_move(rw_aux, sat_rw_involution),
             involutive_move(refresh_aux, refresh_involution)]

    def sat_trace():
        return sat_model.generate(gen, g.C["k"].set(False) | g.C["ys", :].set(ys), ())[0]

    def rj_chains(n_sweeps):
        return torch.func.vmap(lambda _: gibbs_sweep(gen, sat_trace(), moves, n_sweeps=n_sweeps).trace,
                               randomness="different")(lanes)

    conj_chains(1)
    trs, conj_s = timed(lambda: conj_chains(INV_SWEEPS))
    zm, zv = in_law_gap(trs.get_choices()["mu"], INV_X / 2.0, 0.5)
    check(zm < 4 and zv < 4, f"involutive random walk: mean {zm:.2f} SE, variance {zv:.2f} SE off the posterior")

    def branch_logml(design):
        c = 4.0 * design @ design.T + 0.64 * np.eye(4)
        yv = np.asarray(RJ_YS)
        return -0.5 * (np.linalg.slogdet(2 * np.pi * c)[1] + yv @ np.linalg.solve(c, yv))

    p_k1 = 1.0 / (1.0 + np.exp(branch_logml(np.ones((4, 1)))
                               - branch_logml(np.array([[1.0, 0], [1, 0], [0, 1], [0, 1]]))))
    rj, rj_s = timed(lambda: rj_chains(RJ_SWEEPS))
    pk = float(rj.get_choices()["k"].double().mean())
    zk = abs(pk - p_k1) / math.sqrt(p_k1 * (1 - p_k1) / INV_CHAINS)
    check(zk < 4, f"reversible jump: P(k = 1) {pk} vs {p_k1} ({zk:.2f} SE)")

    def checked(aux, inv, tr):
        def one(t):
            info = involutive_mh(gen, t, aux, inv, check=True)[1]
            return info.involution_error, info.logdet

        return torch.func.vmap(one, randomness="different")(tr)

    err_rw, ld_rw = checked(rw_aux, rw_involution, trs)
    err_j, ld_j = checked(jump_aux, jump_involution, rj)
    worst = max(float(err_rw.max()), float(err_j.max()), float(ld_rw.abs().max()), float(ld_j.abs().max()))
    check(worst <= 1e-5, f"involutions not exact: round-trip error or |log det| {worst}")
    busy = device_busy(lambda: rj_chains(1))
    rj_sweep_ms = rj_s / RJ_SWEEPS * 1e3
    phase("main path involutive", f"{smi}: involutive_mh, torch.func.vmap over {INV_CHAINS} chains: the random walk "
                                  f"on the conjugate model ({INV_SWEEPS} sweeps in {conj_s:.2f} s, host clock) within "
                                  f"{zm:.2f} SE (mean) and {zv:.2f} SE (variance) of N({INV_X / 2}, 0.5); the "
                                  f"reversible-jump chain ({RJ_SWEEPS} sweeps of 3 moves in {rj_s:.2f} s) P(k = 1) "
                                  f"{pk:.5f} vs the enumerated {p_k1:.5f} ({zk:.2f} SE, limit 4); check=True: round "
                                  f"trip and |log det| at most {worst:.3g} (limit 1e-5); "
                                  + busy_line("one reversible-jump sweep", busy, rj_sweep_ms))


def predictive_sbc_path(device, smi: str, g) -> None:
    """``[predictive sbc]``: ``sbc_ranks`` with the exact conjugate sampler
    (16,384 simulations x 100 draws, uniform by ``sbc_uniformity``), and
    ``posterior_predictive`` over 65,536 exact posterior draws of
    ``linear_regression`` against the closed-form predictive."""
    from genjax_tpu_torch.inference.predictive import posterior_predictive
    from genjax_tpu_torch.inference.sbc import sbc_ranks, sbc_uniformity
    from genjax_tpu_torch.models import linear_regression

    @g.gen
    def nn_model():
        mu = g.normal(0.0, 1.0) @ "mu"
        g.normal(mu, 0.5) @ "y"

    v = 1.0 / (1.0 + 1.0 / 0.25)

    def exact_sampler(gen, constraint):
        y = constraint.get_submap("y").get_value()
        return (v * y / 0.25 + math.sqrt(v) * torch.randn(SBC_DRAWS, generator=gen, device=gen.device))[:, None]

    sbc_ranks(SEED, nn_model, (), g.S["mu"], exact_sampler, n_sims=16, device=device)
    res, sbc_s = timed(lambda: sbc_ranks(SEED, nn_model, (), g.S["mu"], exact_sampler, n_sims=SBC_SIMS,
                                         device=device))
    pvals, counts = sbc_uniformity(res, n_bins=SBC_DRAWS + 1)
    check(float(pvals[0]) > 1e-3, f"SBC of the exact sampler: p {float(pvals[0])}")

    X, y = flagship_data()
    model, exact_posterior = linear_regression(X)
    mean, cov = exact_posterior(y)
    mean, cov = mean.to(device), cov.to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    w = mean + torch.randn(PRED_DRAWS, mean.shape[0], generator=gen, device=device) @ torch.linalg.cholesky(cov).T
    posterior_predictive(gen, model, (), {"w": w[:16]})
    out, pred_s = timed(lambda: posterior_predictive(gen, model, (), {"w": w}))
    Xd = torch.from_numpy(X).to(device).double()
    pm = (Xd @ mean.double()).cpu().numpy()
    pv = (torch.diagonal(Xd @ cov.double() @ Xd.T) + 0.25**2).cpu().numpy()
    zm, zv = in_law_gap(out["y"], pm, pv)
    check(zm < 4 and zv < 4, f"posterior predictive: means {zm:.2f} SE, variances {zv:.2f} SE off the closed form")
    busy = device_busy(lambda: posterior_predictive(gen, model, (), {"w": w}))
    phase("predictive sbc", f"{smi}: sbc_ranks with the exact conjugate sampler, {SBC_SIMS} simulations x "
                            f"{SBC_DRAWS} draws in {sbc_s * 1e3:.1f} ms (host clock), sbc_uniformity over "
                            f"{SBC_DRAWS + 1} bins p = {float(pvals[0]):.4f} (limit above 1e-3); posterior_predictive "
                            f"of linear_regression over {PRED_DRAWS} exact draws in {pred_s * 1e3:.1f} ms, y_rep "
                            f"means within {zm:.2f} SE and variances within {zv:.2f} SE of the closed form "
                            f"(limit 4); " + busy_line("posterior_predictive", busy, pred_s * 1e3))


def ppca_path(device, smi: str) -> None:
    """``[ppca]``: n = 100,000 x d = 64, q = 8 from numpy seed 0: the
    log-likelihood on the card against float64 numpy, and 50 EM iterations
    against the spectral ML fit."""
    from scipy.linalg import solve_triangular

    from genjax_tpu_torch.interop import ppca_params_from_numpy
    from genjax_tpu_torch.models.ppca import ppca_em, ppca_log_likelihood, ppca_ml

    rng = np.random.default_rng(SEED)
    W = rng.normal(size=(PPCA_D, PPCA_Q)).astype(np.float32)
    mu = rng.normal(size=PPCA_D).astype(np.float32)
    X = (rng.normal(size=(PPCA_N, PPCA_Q)) @ W.T + mu + PPCA_SIGMA * rng.normal(size=(PPCA_N, PPCA_D))).astype(np.float32)
    Wt, mut, st = ppca_params_from_numpy(W, mu, PPCA_SIGMA, device=device)
    Xt = torch.from_numpy(X).to(device)
    ll, ll_s = timed(lambda: ppca_log_likelihood(Xt, Wt, mut, st**2))
    c64 = W.astype(np.float64) @ W.T + PPCA_SIGMA**2 * np.eye(PPCA_D)
    l64 = np.linalg.cholesky(c64)
    r64 = solve_triangular(l64, (X.astype(np.float64) - mu).T, lower=True)
    ll64 = float(-0.5 * np.sum(r64**2) - PPCA_N * np.sum(np.log(np.diag(l64))) - 0.5 * PPCA_N * PPCA_D * math.log(2 * math.pi))
    gap = abs(float(ll) - ll64) / abs(ll64)
    check(gap <= 1e-4, f"PPCA log-likelihood {float(ll)} vs float64 {ll64}")
    (W_ml, mu_ml, s2_ml), ml_s = timed(lambda: ppca_ml(Xt, PPCA_Q))
    ((W_em, _, s2_em), lls), em_s = timed(lambda: ppca_em(Xt, PPCA_Q, n_iters=PPCA_EM_ITERS))
    ll_ml = ppca_log_likelihood(Xt, W_ml, mu_ml, s2_ml)
    ll_em = ppca_log_likelihood(Xt, W_em, mu_ml, s2_em)
    em_gap = abs(float(ll_em) - float(ll_ml)) / abs(float(ll_ml))
    check(em_gap <= 1e-3, f"PPCA EM {float(ll_em)} vs ML {float(ll_ml)}")
    busy = device_busy(lambda: ppca_em(Xt, PPCA_Q, n_iters=PPCA_EM_ITERS))
    phase("ppca", f"{smi}: n = {PPCA_N} x d = {PPCA_D}, q = {PPCA_Q}: ppca_log_likelihood {float(ll):.2f} in "
                  f"{ll_s * 1e3:.2f} ms (host clock), within {gap:.3g} of float64 numpy's {ll64:.2f} (limit 1e-4); "
                  f"ppca_ml {ml_s * 1e3:.2f} ms, ll {float(ll_ml):.2f}; ppca_em ({PPCA_EM_ITERS} iterations) "
                  f"{em_s * 1e3:.1f} ms, ll {float(ll_em):.2f}, within {em_gap:.3g} of ML's (limit 1e-3), "
                  f"sigma2 {float(s2_em):.5f} vs {float(s2_ml):.5f}; " + busy_line("ppca_em", busy, em_s * 1e3))


def bnn_path(device, smi: str) -> None:
    """``[bnn]``: ``column_advi`` on ``bayesian_nn(X, hidden=())`` (n = 10,000,
    d = 16) against ``bnn_exact_linear_posterior``; ``bnn_predict`` over
    4,096 prior draws of a ``hidden=(64,)`` tanh net, held against the
    network written out."""
    import genjax_tpu_torch as g
    from genjax_tpu_torch.inference import column_advi
    from genjax_tpu_torch.models.bnn import bayesian_nn, bnn_exact_linear_posterior, bnn_predict

    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(BNN_N, BNN_D)).astype(np.float32)
    y = (X @ rng.normal(size=BNN_D) + 0.3 + 0.25 * rng.normal(size=BNN_N)).astype(np.float32)
    Xt, yt = torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)
    model, addresses, _ = bayesian_nn(X, hidden=())

    def cosine(step):
        return BNN_LR * 0.5 * (1.0 + math.cos(math.pi * min(step, BNN_STEPS) / BNN_STEPS))

    post, advi_s = timed(lambda: column_advi(SEED, model, g.C["y"].set(yt), (), addresses, rank="full",
                                             n_steps=BNN_STEPS, learning_rate=cosine, device=device))
    mean, _ = bnn_exact_linear_posterior(Xt, yt)
    err = float((post.result.mu[:BNN_D + 1] - mean).abs().max())
    check(post.result.mu.device.type == device.type and err <= BNN_TOL,
          f"column_advi's mean off the exact linear posterior by {err} (limit {BNN_TOL})")

    net, _, forward = bayesian_nn(X, hidden=(BNN_HIDDEN,))
    gen = torch.Generator(device=device).manual_seed(SEED)
    draws = torch.func.vmap(lambda _: net.simulate(gen, ()).get_choices(), randomness="different")(
        torch.zeros(BNN_DRAWS, device=device))
    Xn = Xt[:BNN_PREDICT_N]
    bnn_predict(draws, Xn[:8], forward)
    (pm, psd), pred_s = timed(lambda: bnn_predict(draws, Xn, forward))
    W0, b0, W1, b1 = (draws[a] for a in ("W0", "b0", "W1", "b1"))
    outs = torch.tanh(torch.einsum("nd,sdh->snh", Xn, W0.reshape(-1, BNN_D, BNN_HIDDEN)) + b0[:, None, :])
    outs = torch.einsum("snh,sho->sno", outs, W1.reshape(-1, BNN_HIDDEN, 1)) + b1[:, None, :]
    perr = max(float((pm - outs.mean(0)).abs().max()), float((psd - outs.std(0, unbiased=False)).abs().max()))
    check(perr <= 1e-4 and bool(torch.isfinite(pm).all()), f"bnn_predict off the network written out by {perr}")
    busy = device_busy(lambda: bnn_predict(draws, Xn, forward))
    flop = 2.0 * BNN_DRAWS * BNN_PREDICT_N * (BNN_D * BNN_HIDDEN + BNN_HIDDEN)
    phase("bnn", f"{smi}: column_advi (full rank, {BNN_STEPS} steps from {BNN_LR} cosine-decayed) on bayesian_nn(X, "
                 f"hidden=()), n = {BNN_N}, d = {BNN_D}: {advi_s:.2f} s (host clock), its mean within {err:.4f} of "
                 f"bnn_exact_linear_posterior's (limit {BNN_TOL}); bnn_predict over {BNN_DRAWS} draws of a "
                 f"hidden=({BNN_HIDDEN},) tanh net at {BNN_PREDICT_N} inputs: {pred_s * 1e3:.2f} ms = "
                 f"{flop / pred_s / 1e12:.3f} TFLOP/s of its {flop / 1e9:.2f} GFLOP, within {perr:.3g} of the "
                 f"network written out; " + busy_line("bnn_predict", busy, pred_s * 1e3))


def discrete_path(device, smi: str, g) -> None:
    """Slice 13's phases: the discrete HMM, Gibbs, particle Gibbs and PMMH,
    the ESS and slice requests, involutive MCMC, predictive checks and SBC,
    PPCA and the BNN."""
    t0 = time.perf_counter()
    hmm_path(device, smi)
    gibbs_path(device, smi, g)
    pgibbs_path(device, smi, g)
    requests_path(device, smi, g)
    involutive_path(device, smi, g)
    predictive_sbc_path(device, smi, g)
    ppca_path(device, smi)
    bnn_path(device, smi)
    phase("discrete", f"{smi}: the HMM, Gibbs, particle Gibbs, request, involutive, predictive, SBC, PPCA and BNN "
                      f"phases took {time.perf_counter() - t0:.1f} s")


# ---- slice 14: the population and column-density algorithms, model
# comparison, and checkpointed resume (no kernel; K1 in [checkpoint])

ABC_REJ_N, ABC_SMC_N, ABC_GENS = 400_000, 65_536, 10
SMC2_THETA, SMC2_X, SMC2_T = 1024, 1024, 20
CHEES_N = 65_536
NS_LIVE, NS_ITER, NS_MCMC, NS_RUNS = 200, 1600, 20, 1024
NS_BUSY_ITER = 20  # the profiled and read-counted call: the same at fewer iterations
PF_PATHS, PF_DRAWS = 64, 4096
PF_RESAMPLE = PF_PATHS * PF_DRAWS
PF_COLUMN_PATHS, PF_COLUMN_ITERS = 8, 30
PF_BUSY_ITERS = 3  # column_pathfinder's profiled and read-counted call
MC_S, MC_N = 4000, 10_000
CK_EVERY, CK_SEGMENTS = 25, 2
CK_HMC_CHAINS, CK_HMC_WARMUP, CK_HMC_SAMPLES, CK_HMC_EVERY = 512, 120, 80, 20


def trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    return float(np.sum((y[1:] + y[:-1]) * np.diff(x)) / 2.0)


def costs(fn, call_s: float, what: str = "one call") -> str:
    """A call's host reads and the card's busy share in it, both of one
    more call of ``fn`` (whose host-clock time is ``call_s``)."""
    reads = host_reads(fn)
    return f"host reads {reads} a call; " + busy_line(what, device_busy(fn), call_s * 1e3)


def abc_path(device, smi: str, g) -> None:
    """``[main path abc]``: ``abc_rejection`` and ``abc_smc`` on
    ``tests/inference/test_abc.py``'s Gaussian simulator against the
    quadrature of the closed-form ABC posterior."""
    from scipy.stats import norm

    from genjax_tpu_torch.inference import abc_rejection, abc_smc, column_weighted_moments

    t0_, s_, y_obs = 1.0, 0.7, 1.3

    @g.gen
    def gauss():
        theta = g.normal(0.0, t0_) @ "theta"
        return g.normal(theta, s_) @ "y"

    def distance(tr):
        return torch.abs(tr.get_choices()["y"] - y_obs)

    def exact(eps):
        th = np.linspace(-6.0, 6.0, 200_001)
        w = norm.pdf(th, 0.0, t0_) * (norm.cdf((y_obs + eps - th) / s_) - norm.cdf((y_obs - eps - th) / s_))
        w = w / trapezoid(w, th)
        mean = trapezoid(th * w, th)
        return mean, trapezoid((th - mean) ** 2 * w, th)

    gen = torch.Generator(device=device).manual_seed(SEED)
    rej = lambda: abc_rejection(gen, gauss, (), distance, n_samples=ABC_REJ_N, tolerance=0.5, device=device)  # noqa: E731
    res, s = timed(rej)
    w = res.choices.flag.double()
    th = res.choices.value["theta"].double()
    mean = float((w * th).sum() / w.sum())
    var = float((w * (th - mean) ** 2).sum() / w.sum())
    em, ev = exact(0.5)
    s_marg = math.sqrt(t0_**2 + s_**2)
    p_hit = norm.cdf((y_obs + 0.5) / s_marg) - norm.cdf((y_obs - 0.5) / s_marg)
    check(res.choices.flag.is_cuda and abs(mean - em) <= 0.02 and abs(var - ev) <= 0.02,
          f"abc_rejection: mean {mean} vs {em}, variance {var} vs {ev} (limits 0.02)")
    check(abs(float(res.accept_rate) - p_hit) <= 0.01, f"abc_rejection accept {float(res.accept_rate)} vs {p_hit}")
    phase("main path abc", f"{smi}: abc_rejection, {ABC_REJ_N} simulations: mean {mean:.4f} vs the quadrature's "
                           f"{em:.4f}, variance {var:.4f} vs {ev:.4f} (limits 0.02), accept {float(res.accept_rate):.4f}"
                           f" vs {p_hit:.4f}; {s:.3f} s; " + costs(rej, s))
    smc = lambda: abc_smc(gen, gauss, (), distance, ["theta"], n_particles=ABC_SMC_N, n_generations=ABC_GENS,  # noqa: E731
                          mh_moves=2, device=device)
    (res, packer), s = timed(smc)
    m, v = column_weighted_moments(res.params, packer.dim)
    eps = float(res.tolerance)
    em, ev = exact(eps)
    ladder = res.tolerance_history
    check(bool(torch.all(ladder[1:] <= ladder[:-1])), f"abc_smc's tolerance ladder rose: {ladder.tolist()}")
    check(abs(float(m[0]) - em) <= 0.06 and abs(float(v[0]) - ev) <= 0.2 * ev,
          f"abc_smc: mean {float(m[0])} vs {em} (limit 0.06), variance {float(v[0])} vs {ev} (rel 0.2)")
    phase("main path abc", f"{smi}: abc_smc, {ABC_SMC_N} particles x {ABC_GENS} generations, mh_moves 2: final "
                           f"tolerance {eps:.4f}, mean {float(m[0]):.4f} vs the quadrature's {em:.4f} (limit 0.06), "
                           f"variance {float(v[0]):.4f} vs {ev:.4f} (rel 0.2), ladder non-increasing, move accept "
                           f"{float(res.move_accept_history.mean()):.4f}; {s:.3f} s; " + costs(smc, s))


def smc2_path(device, smi: str, g) -> None:
    """``[main path smc2]``: SMC² on ``tests/inference/test_smc2.py``'s AR(1)
    state-space model against the Kalman grid."""
    from scipy.stats import norm

    from genjax_tpu_torch.inference import smc2

    q_, r_, a_true, pm, ps = 1.0, 0.5, 0.8, 0.5, 0.3
    rng = np.random.RandomState(0)
    z, ys = 0.0, []
    for _ in range(SMC2_T):
        z = a_true * z + q_ * rng.randn()
        ys.append(z + r_ * rng.randn())
    ys = np.asarray(ys, np.float32)

    def kalman(a):
        mean, var, ll = 0.0, 0.0, 0.0
        for yv in ys:
            mean, var = a * mean, a * a * var + q_**2
            sv = var + r_**2
            ll += norm.logpdf(yv, mean, math.sqrt(sv))
            gain = var / sv
            mean, var = mean + gain * (yv - mean), (1 - gain) * var
        return ll

    grid = np.linspace(-0.6, 1.8, 1201)
    lw = np.array([norm.logpdf(a, pm, ps) + kalman(a) for a in grid])
    log_ev = math.log(trapezoid(np.exp(lw - lw.max()), grid)) + lw.max()
    wg = np.exp(lw - lw.max())
    exact_mean = float(wg @ grid / wg.sum())

    @g.gen
    def kernel(c, x):
        a, zz = c
        z_new = g.normal(a * zz, q_) @ "z"
        y = g.normal(z_new, r_) @ "y"
        return ((a, z_new), y)

    gen = torch.Generator(device=device).manual_seed(SEED)
    obs = g.C[:, "y"].set(torch.from_numpy(ys).to(device))
    run = lambda: smc2(  # noqa: E731
        gen, kernel, lambda gg: pm + ps * torch.randn((), generator=gg, device=gg.device),
        lambda a: -0.5 * ((a - pm) / ps) ** 2 - math.log(ps) - 0.5 * math.log(2 * math.pi),
        0.0, torch.zeros(SMC2_T, device=device), obs, n_theta=SMC2_THETA, n_x=SMC2_X, rw_scales=0.15, n_rejuv=2,
        device=device)
    res, s = timed(run)
    wt = torch.exp(res.log_weights.double())
    mean = float(wt @ res.thetas.double())
    acc = float(res.rejuv_accept_rate)
    check(abs(mean - exact_mean) <= 0.06 and abs(float(res.log_evidence) - log_ev) <= 0.6 and acc > 0.05,
          f"smc2: mean {mean} vs {exact_mean} (0.06), log evidence {float(res.log_evidence)} vs {log_ev} (0.6), "
          f"rejuvenation accept {acc} (> 0.05)")
    n_res = int((res.ess_history < 0.5 * SMC2_THETA).sum())
    phase("main path smc2", f"{smi}: smc2, {SMC2_THETA} parameters x {SMC2_X} state particles, T = {SMC2_T}: "
                            f"posterior mean of a {mean:.4f} vs the grid's {exact_mean:.4f} (limit 0.06), log evidence "
                            f"{float(res.log_evidence):.4f} vs {log_ev:.4f} (limit 0.6), {n_res} rejuvenations "
                            f"accepting {acc:.4f} (> 0.05); {s:.3f} s; " + costs(run, s))


def chees_tempered_path(device, smi: str, g) -> None:
    """``[main path smc_chees]``: ChEES-tempered SMC on
    ``test_smc_chees.py``'s d = 4 Gaussian and, through the column bridge,
    on the conjugate model, against the closed forms."""
    from genjax_tpu_torch.inference import chees_tempered_smc, column_tempered_chees

    c = -0.5 * math.log(2 * math.pi)
    d, y, sig = 4, 1.5, 0.5
    s2 = 1.0 + sig**2
    logz = d * (-0.5 * y * y / s2 - 0.5 * math.log(s2) + c)
    gen = torch.Generator(device=device).manual_seed(SEED)
    q0 = torch.randn((d, CHEES_N), generator=gen, device=device)
    run = lambda: chees_tempered_smc(  # noqa: E731
        gen, lambda q: torch.sum(-0.5 * q**2 + c, 0),
        lambda q: torch.sum(-0.5 * ((y - q) / sig) ** 2 - math.log(sig) + c, 0), q0, n_rejuvenation=3)
    res, s = timed(run)
    w = torch.softmax(res.log_weights, 0)
    mean = torch.sum(w * res.particles, 1)
    var = torch.sum(w * (res.particles - mean[:, None]) ** 2, 1)
    gm = float((mean - y / s2).abs().max())
    gv = float((var - sig**2 / s2).abs().max())
    check(float(res.final_beta) == 1.0 and abs(float(res.log_marginal) - logz) <= 0.05 and gm <= 0.08 and gv <= 0.08,
          f"chees_tempered_smc: final beta {float(res.final_beta)}, log marginal {float(res.log_marginal)} vs "
          f"{logz} (0.05), moments off by {gm}, {gv} (0.08)")
    k = int(res.n_rungs)
    phase("main path smc_chees", f"{smi}: chees_tempered_smc, d = {d} Gaussian, {CHEES_N} particles, n_rejuvenation "
                                 f"3: {k} rungs to beta 1, log marginal {float(res.log_marginal):.4f} vs {logz:.4f} "
                                 f"(limit 0.05), moments within {gm:.4f}, {gv:.4f} (limit 0.08), acceptance "
                                 f"{float(res.accept_history[:k].mean()):.4f}, mean leapfrogs a sweep "
                                 f"{float(res.leapfrog_history[:k].mean()):.2f}; {s:.3f} s; " + costs(run, s))

    @g.gen
    def conjugate():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 0.5) @ "y"

    obs = g.C["y"].set(1.5)
    exact = -0.5 * 1.5**2 / 1.25 - 0.5 * math.log(1.25) + c
    run = lambda: column_tempered_chees(conjugate, obs, (), ["mu"], gen, CHEES_N, device=device)  # noqa: E731
    (res, _packer), s = timed(run)
    w = torch.softmax(res.log_weights, 0)
    mu = res.particles[0]
    m = float(torch.sum(w * mu))
    v = float(torch.sum(w * (mu - m) ** 2))
    check(abs(float(res.log_marginal) - exact) <= 0.05 and abs(m - 1.2) <= 0.08 and abs(v - 0.2) <= 0.08,
          f"column_tempered_chees: log marginal {float(res.log_marginal)} vs {exact}, mean {m}, variance {v}")
    phase("main path smc_chees", f"{smi}: column_tempered_chees on the conjugate model, {CHEES_N} particles: "
                                 f"{int(res.n_rungs)} rungs, log marginal {float(res.log_marginal):.4f} vs "
                                 f"{exact:.4f} (limit 0.05), posterior mean {m:.4f} vs 1.2, variance {v:.4f} vs 0.2 "
                                 f"(limits 0.08); {s:.3f} s; " + costs(run, s))


def nested_path(device, smi: str) -> None:
    """``[main path nested]``: nested sampling on ``test_nested.py``'s
    Gaussian evidence problem, the runs one batch."""
    from genjax_tpu_torch.inference import nested_sampling

    c = -0.5 * math.log(2 * math.pi)
    sig = 0.5
    y = torch.tensor(np.linspace(0.4, 1.0, 2), dtype=torch.float32, device=device)
    exact = float(sum(-0.5 * float(v) ** 2 / (1 + sig**2) - 0.5 * math.log(1 + sig**2) + c for v in y))
    gen = torch.Generator(device=device).manual_seed(SEED)

    def run(n_iter=NS_ITER):
        return nested_sampling(
            lambda gg, n: torch.randn((2, n), generator=gg, device=gg.device),
            lambda q: torch.sum(-0.5 * q**2 + c, 0),
            lambda q: torch.sum(-0.5 * ((q - y[:, None]) / sig) ** 2 - math.log(sig) + c, 0),
            gen, n_live=NS_LIVE, n_iter=n_iter, n_mcmc=NS_MCMC, n_runs=NS_RUNS, device=device)

    res, s = timed(run)
    se = float(res.log_z.std()) / math.sqrt(NS_RUNS)
    gap = abs(float(res.log_z_mean) - exact)
    mono = bool(torch.all(torch.diff(res.dead_log_lik, dim=1) >= 0))
    check(gap <= 4 * se + 0.05 and mono,
          f"nested_sampling: mean log Z {float(res.log_z_mean)} vs {exact} (limit {4 * se + 0.05}), dead likelihoods "
          f"non-decreasing {mono}")
    small = lambda: run(NS_BUSY_ITER)  # noqa: E731
    _, small_s = timed(small)
    phase("main path nested", f"{smi}: nested_sampling, {NS_RUNS} runs as one batch x {NS_LIVE} live points x "
                              f"{NS_ITER} iterations x {NS_MCMC} walk steps: mean log Z {float(res.log_z_mean):.4f} vs "
                              f"{exact:.4f}, gap {gap:.4f} (limit 4 x SE {se:.4f} + 0.05), between-run SD "
                              f"{float(res.log_z.std()):.4f}, classic error {float(res.error_estimate()):.4f}, walk "
                              f"accept {float(res.accept_rate.mean()):.4f}, dead likelihoods non-decreasing in every "
                              f"run; {s:.3f} s = {s / (NS_ITER * NS_MCMC) * 1e6:.1f} us a walk step of all runs; at "
                              f"{NS_BUSY_ITER} iterations ({small_s:.3f} s): " + costs(small, small_s))


def pathfinder_path(device, smi: str, g) -> None:
    """``[main path pathfinder]``: ``multi_pathfinder`` on
    ``test_pathfinder.py``'s 3-d Gaussian target, and ``column_pathfinder``
    on the conjugate model."""
    from genjax_tpu_torch.inference import column_pathfinder, multi_pathfinder

    a = np.random.default_rng(5).normal(size=(3, 3))
    cov = a @ a.T + 2.0 * np.eye(3)
    m = np.asarray([1.5, -0.5, 2.0])
    log_z = 0.5 * 3 * math.log(2 * math.pi) + 0.5 * np.linalg.slogdet(cov)[1]
    prec = torch.tensor(np.linalg.inv(cov), dtype=torch.float32, device=device)
    mt = torch.tensor(m, dtype=torch.float32, device=device)

    def logp(zz):
        dz = zz - mt[:, None]
        return -0.5 * torch.sum(dz * (prec @ dz), dim=0)

    gen = torch.Generator(device=device).manual_seed(SEED)
    run = lambda: multi_pathfinder(gen, logp, 3, n_paths=PF_PATHS, n_resample=PF_RESAMPLE, n_draws=PF_DRAWS,  # noqa: E731
                                   device=device)
    res, s = timed(run)
    gm = float((res.mean().double().cpu() - torch.tensor(m)).abs().max())
    cov_hat = torch.cov(res.draws.double()).cpu().numpy()
    cov_ok = bool(np.all(np.abs(cov_hat - cov) <= 0.05 + 0.05 * np.abs(cov)))
    # the ELBO of each path's chosen Gaussian from its own 4,096 draws: the
    # best-ELBO pick over 60 iterates of 30 draws each is biased upward
    fresh = float((res.paths.logp - res.paths.logq).double().mean(dim=1).max())
    best = float(res.path_elbos.max())
    check(gm <= 0.02 and cov_ok and abs(fresh - log_z) <= 0.05,
          f"multi_pathfinder: mean off by {gm} (0.02), covariance {cov_hat.tolist()} vs {cov.tolist()} (0.05 + 5%), "
          f"the best path's ELBO over its draws {fresh} vs log Z {log_z} (0.05)")
    steps = res.paths.linesearch_steps.double()
    reads = host_reads(run)
    phase("main path pathfinder", f"{smi}: multi_pathfinder, {PF_PATHS} paths as one batch x 60 L-BFGS iterations, "
                                  f"{PF_DRAWS} draws a path, {PF_RESAMPLE} PSIS resamples: mean within {gm:.4f} "
                                  f"(limit 0.02), covariance within 0.05 + 5%, the best path's ELBO over its "
                                  f"{PF_DRAWS} draws {fresh:.4f} vs log Z {log_z:.4f} (limit 0.05; the best-ELBO "
                                  f"picks' own estimates, 30 draws each, up to {best:.4f}), pooled k-hat "
                                  f"{float(res.pareto_k):.3f}; linesearch steps "
                                  f"a path and iteration {float(steps.mean()):.3f} (max {int(steps.max())}), "
                                  f"{int(steps.sum(dim=1).max())} on the longest path; host reads {reads} a call, "
                                  f"{reads / steps.shape[1]:.2f} an iteration of all the paths together "
                                  f"({reads / PF_PATHS:.2f} a path); {s:.3f} s; "
                                  + busy_line("one call", device_busy(run), s * 1e3))

    @g.gen
    def conjugate():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 0.5) @ "y"

    def run(n_iters=PF_COLUMN_ITERS):
        return column_pathfinder(gen, conjugate, g.C["y"].set(1.0), (), ["mu"], n_paths=PF_COLUMN_PATHS,
                                 n_iters=n_iters, n_resample=65_536, device=device)

    post, s = timed(run)
    small = lambda: run(PF_BUSY_ITERS)  # noqa: E731
    _, small_s = timed(small)
    mean = float(post.mean_choices()["mu"])
    sd = float(post.sample_choices(gen, 65_536)["mu"].std())
    check(abs(mean - 0.8) <= 0.05 and abs(sd - math.sqrt(0.2)) <= 0.15 * math.sqrt(0.2),
          f"column_pathfinder: mean {mean} vs 0.8 (0.05), SD {sd} vs {math.sqrt(0.2)} (15%)")
    phase("main path pathfinder", f"{smi}: column_pathfinder on the conjugate model, {PF_COLUMN_PATHS} paths x "
                                  f"{PF_COLUMN_ITERS} iterations (the reference test's): posterior "
                                  f"mean {mean:.4f} vs 0.8 (limit 0.05), SD {sd:.4f} vs {math.sqrt(0.2):.4f} (limit "
                                  f"15%); {s:.3f} s; at {PF_BUSY_ITERS} iterations ({small_s:.3f} s): "
                                  + costs(small, small_s))


def model_comparison_path(device, smi: str) -> None:
    """``[model comparison]``: ``psis_loo`` and ``waic`` on a (4,000,
    10,000) float32 log-likelihood matrix on the card, against the port's
    own float64 run on the CPU."""
    from scipy.stats import norm

    from genjax_tpu_torch.inference import psis_loo, waic

    rng = np.random.default_rng(SEED)
    ys = rng.normal(0.5, 0.8, size=MC_N)
    v = 1.0 / (1.0 + MC_N / 0.64)
    mus = v * ys.sum() / 0.64 + math.sqrt(v) * rng.normal(size=MC_S)
    ll = norm.logpdf(ys[None, :], mus[:, None], 0.8).astype(np.float32)
    ll_gpu = torch.from_numpy(ll).to(device)
    loo, loo_s = timed(lambda: psis_loo(ll_gpu))
    wa, waic_s = timed(lambda: waic(ll_gpu))
    t0 = time.perf_counter()
    ll64 = torch.from_numpy(ll).double()
    loo64, wa64 = psis_loo(ll64), waic(ll64)
    cpu_s = time.perf_counter() - t0
    gaps = {"elpd": rel_gap(loo.elpd, loo64.elpd), "p_eff": rel_gap(loo.p_eff, loo64.p_eff),
            "pareto_k": float(((loo.pareto_k.double().cpu() - loo64.pareto_k).abs()
                               / loo64.pareto_k.abs().clamp(min=1.0)).max()),
            "waic elpd": rel_gap(wa.elpd, wa64.elpd), "waic p_eff": rel_gap(wa.p_eff, wa64.p_eff)}
    check(all(gv <= 1e-4 for gv in gaps.values()), f"model comparison off the float64 CPU run: {gaps}")
    phase("model comparison", f"{smi}: psis_loo and waic on ({MC_S}, {MC_N}) float32 log-likelihoods "
                              f"({ll.nbytes / 1e6:.0f} MB): psis_loo {loo_s * 1e3:.2f} ms, waic {waic_s * 1e3:.2f} ms "
                              f"(host clock); elpd {float(loo.elpd):.3f}, p_eff {float(loo.p_eff):.3f}, max k-hat "
                              f"{float(loo.pareto_k.max()):.4f}; relative gaps to the port's float64 CPU run ("
                              f"{cpu_s:.2f} s): " + ", ".join(f"{k} {gv:.2e}" for k, gv in gaps.items())
                              + " (limit 1e-4); " + costs(lambda: psis_loo(ll_gpu), loo_s, "one psis_loo"))


def checkpoint_path(device, smi: str, g, hmc, model, y) -> int:
    """``[checkpoint]``: ``sample_posterior(hmc_sweep)`` on the flagship and
    ``"hmc"`` on ``examples/10``'s regression, each run whole without a
    checkpoint, whole with one, and stopped after ``max_segments`` and
    resumed: the draws, accepts, ``eps`` and ``inv_mass`` bitwise equal.
    Returns the K1 launches of the checkpointed whole run."""
    import os
    import tempfile

    from genjax_tpu_torch.inference import sample
    from genjax_tpu_torch.models import linear_regression

    saves, loads, sizes = [], [], []
    save0, load0 = sample.save_segment_state, sample.load_segment_state

    def timed_save(d, state, meta, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save0(d, state, meta, **kw)
        saves.append(time.perf_counter() - t0)
        # what this save wrote: the state, and the segment's draws once
        seg = meta["next_segment"]
        written = [os.path.join(d, f"state_{seg}", "leaves.pt")]
        if kw.get("increment") is not None:
            written.append(os.path.join(d, f"increment_{seg - 1}", "leaves.pt"))
        sizes.append(sum(os.path.getsize(f) for f in written))

    def timed_load(d, make_template, **kw):
        t0 = time.perf_counter()
        out = load0(d, make_template, **kw)
        torch.cuda.synchronize()
        if out is not None:
            loads.append(time.perf_counter() - t0)
        return out

    def same(a, b, addr):
        return (torch.equal(a[addr], b[addr]) and torch.equal(a.accept_rate, b.accept_rate)
                and torch.equal(a.eps, b.eps) and torch.equal(a.inv_mass, b.inv_mass))

    sample.save_segment_state, sample.load_segment_state = timed_save, timed_load
    try:
        cases = []
        sel = g.S["w"] | g.S["tau"]
        obs = g.C["y"].set(torch.as_tensor(y, device=device))
        kw = dict(n_chains=N_CHAINS, n_warmup=SP_WARMUP, n_samples=SP_SAMPLES, algorithm="hmc_sweep", eps0=SP_EPS0,
                  L=L, device=device)
        cases.append(("hmc_sweep", "w", CK_EVERY, lambda **o: sample.sample_posterior(SEED, model, obs, (), sel,
                                                                                       **{**kw, **o})))
        X = np.random.default_rng(0).normal(size=(24, 3)).astype(np.float32)
        w_true = np.asarray([1.0, -2.0, 0.5], np.float32)
        y10 = (X @ w_true + 0.25 * np.random.default_rng(0).normal(size=24)).astype(np.float32)
        model10, _exact = linear_regression(X)
        obs10 = g.C["y"].set(torch.from_numpy(y10).to(device))
        kw10 = dict(n_chains=CK_HMC_CHAINS, n_warmup=CK_HMC_WARMUP, n_samples=CK_HMC_SAMPLES, algorithm="hmc",
                    eps0=0.02, device=device)
        cases.append(("hmc", "w", CK_HMC_EVERY, lambda **o: sample.sample_posterior(SEED, model10, obs10, (),
                                                                                    g.S["w"], **{**kw10, **o})))
        k1_whole = 0
        for (name, addr, every, call), small_kw in zip(cases, (dict(), dict(n_warmup=12, n_samples=8))):
            with tempfile.TemporaryDirectory() as d:
                plain, plain_s = timed(call)
                hmc.hmc_sweep_launches = 0
                whole, whole_s = timed(lambda: call(checkpoint_dir=os.path.join(d, "whole"), checkpoint_every=every))
                launches_whole = hmc.hmc_sweep_launches
                n_saves = len(saves)
                hmc.hmc_sweep_launches = 0
                part, part_s = timed(lambda: call(checkpoint_dir=os.path.join(d, "part"), checkpoint_every=every,
                                                  max_segments=CK_SEGMENTS))
                resumed, resume_s = timed(lambda: call(checkpoint_dir=os.path.join(d, "part"),
                                                       checkpoint_every=every))
                launches_split = hmc.hmc_sweep_launches
            ok = same(plain, whole, addr) and same(plain, resumed, addr)
            check(ok, f"[checkpoint] {name}: the checkpointed runs differ from the whole run")
            check(tuple(part[addr].shape[:2]) == (plain[addr].shape[0], CK_SEGMENTS * every),
                  f"[checkpoint] {name}: the stopped run returned {tuple(part[addr].shape)}")
            if name == "hmc_sweep":
                want = min(6, SP_WARMUP) + SP_SAMPLES
                check(launches_whole == want and launches_split == want,
                      f"[checkpoint] hmc_sweep made {launches_whole} and {launches_split} K1 launches, not {want}")
                k1_whole = launches_whole
            phase("checkpoint", f"{smi}: sample_posterior({name}) at {plain[addr].shape[0]} chains, "
                                f"checkpoint_every {every}: draws, accepts, eps and inv_mass bitwise equal "
                                f"(torch.equal) to the run without a checkpoint, whole ({whole_s:.3f} s vs "
                                f"{plain_s:.3f} s, {n_saves} saves) and stopped after {CK_SEGMENTS} segments "
                                f"({part_s:.3f} s) then resumed ({resume_s:.3f} s); K1 launches {launches_whole} "
                                f"whole, {launches_split} stopped and resumed")
            phase("checkpoint", f"{smi}: {name}: a save {min(saves) * 1e3:.1f}-{max(saves) * 1e3:.1f} ms (host "
                                f"clock, {len(saves)} saves), a restore {loads[-1] * 1e3:.1f} ms; a save wrote "
                                f"{min(sizes) / 1e6:.2f}-{max(sizes) / 1e6:.2f} MB (after the warmup: the state; "
                                f"after a segment: the state and that segment's draws, each draw saved once)")
            saves.clear(), loads.clear(), sizes.clear()
            with tempfile.TemporaryDirectory() as d:
                every_small = every if not small_kw else 4
                small = lambda: call(checkpoint_dir=os.path.join(d, str(time.perf_counter())),  # noqa: E731
                                     checkpoint_every=every_small, **small_kw)
                _, small_s = timed(small)
                what = "the checkpointed run" if not small_kw else (
                    f"a checkpointed run of {small_kw['n_warmup']} + {small_kw['n_samples']} (every {every_small})")
                phase("checkpoint", f"{smi}: {name}: {what} {small_s:.3f} s; " + costs(small, small_s))
            saves.clear(), loads.clear(), sizes.clear()
    finally:
        sample.save_segment_state, sample.load_segment_state = save0, load0
    return k1_whole


def population_path(device, smi: str, g, hmc, model, y) -> int:
    """Slice 14's phases: ABC, SMC², ChEES-tempered SMC, nested sampling,
    Pathfinder, model comparison and checkpointed resume. Returns the K1
    launches of the checkpointed ``sample_posterior(hmc_sweep)``."""
    t0 = time.perf_counter()
    abc_path(device, smi, g)
    smc2_path(device, smi, g)
    chees_tempered_path(device, smi, g)
    nested_path(device, smi)
    pathfinder_path(device, smi, g)
    model_comparison_path(device, smi)
    launches = checkpoint_path(device, smi, g, hmc, model, y)
    phase("population", f"{smi}: the ABC, SMC², ChEES-tempered, nested, Pathfinder, model comparison and "
                        f"checkpoint phases took {time.perf_counter() - t0:.1f} s")
    return launches


EDIT_D = 512
EDIT_WIDE = 50
EDIT_CHAIN = 12


def close_rel(a, b, tol: float) -> float:
    """The largest gap between ``a`` and ``b``, relative to ``max(1, |b|)``."""
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def edit_path(device, smi: str, g, model, y) -> None:
    """The incremental edit of ``@gen`` bodies at the flagship trace path's
    width (``N_CHAINS`` traces, vmapped): the reference tests' 50-address
    body and 12-address chain at d = 512, and the flagship under
    ``mh(Regenerate(S["tau"]))`` and the ``HMC`` request. Each edit is held
    to the clean-prefix rule on the same traces (the rule a degraded edit
    takes, forced here), timed beside it on the host clock."""
    from genjax_tpu_torch.lang.static_lang import StaticGenerativeFunction, forced_clean_prefix

    edit = StaticGenerativeFunction.edit
    dummy = torch.zeros(N_CHAINS, device=device)
    zeros = torch.zeros(EDIT_D, device=device)

    @g.gen
    def wide():
        for i in range(EDIT_WIDE):
            g.normal(zeros + float(i), 1.0) @ f"a{i}"
        return zeros

    @g.gen
    def chain():
        x = g.normal(zeros, 1.0) @ "a0"
        for i in range(1, EDIT_CHAIN):
            x = g.normal(x, 1.0) @ f"a{i}"
        return x

    def vm(fn):
        return torch.func.vmap(fn, randomness="different")

    def run_edit(trs, request, seed=SEED):
        gen = torch.Generator(device=device).manual_seed(seed)
        return vm(lambda tr: tr.edit(gen, request))(trs)

    def both_rules(name, trs, request, dispatched, addrs):
        """The edit under both rules: gates, round trip, times."""
        new, w, _rd, bwd = run_edit(trs, request)
        torch.cuda.synchronize()
        rule, n = edit.last_rule, edit.last_dispatched
        check(rule == "incremental", f"{name}: the edit took {rule} ({edit.last_rule_reason})")
        check(n == dispatched, f"{name}: {n} sub-edits dispatched, expected {dispatched}")
        with forced_clean_prefix():
            new_c, w_c, _, _ = run_edit(trs, request)
            n_c = edit.last_dispatched
        gap = close_rel(w, w_c, 1e-5)
        check(gap <= 1e-5, f"{name}: weights {gap:.3g} (relative) off the clean-prefix rule's")
        choice_gap = max(close_rel(new[a], new_c[a], 1e-5) for a in addrs)
        check(choice_gap <= 1e-5, f"{name}: new choices {choice_gap:.3g} off the clean-prefix rule's")
        check(bool(torch.isfinite(w).all()), f"{name}: a weight is not finite")
        _, w_b, _, _ = vm(lambda tr, b: tr.edit(torch.Generator(device=device).manual_seed(SEED), b))(new, bwd)
        trip = float((w + w_b).abs().max())
        check(trip <= 1e-4, f"{name}: the round trip leaves |w + w_bwd| = {trip:.3g} (limit 1e-4)")
        inc_ms = wall_ms(lambda: run_edit(trs, request))
        with forced_clean_prefix():
            cp_ms = wall_ms(lambda: run_edit(trs, request))
        return (f"{name}: {n} sub-edits dispatched ({n_c} under the clean-prefix rule), {inc_ms:.3f} ms against "
                f"{cp_ms:.3f} ms = {cp_ms / inc_ms:.2f}x; weights within {gap:.2g} and choices within "
                f"{choice_gap:.2g} of the clean-prefix rule's (limit 1e-5), |w + w_bwd| <= {trip:.2g}"), inc_ms

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    v = torch.full((EDIT_D,), 0.5, device=device)
    trs_wide = vm(lambda _: wide.simulate(gen, ()))(dummy)
    torch.cuda.synchronize()
    nbytes = sum(trs_wide[f"a{i}"].numel() for i in range(EDIT_WIDE)) * 4
    two = g.Update(g.C["a0"].set(v) | g.C[f"a{EDIT_WIDE - 1}"].set(v))
    every = g.Update(g.ChoiceMap.d({f"a{i}": v for i in range(EDIT_WIDE)}))
    line_two, two_ms = both_rules("wide, 2 of 50", trs_wide, two, 2, ["a0", "a1", f"a{EDIT_WIDE - 1}"])
    line_all, all_ms = both_rules("wide, all 50", trs_wide, every, EDIT_WIDE, ["a0", "a1", f"a{EDIT_WIDE - 1}"])
    busy = device_busy(lambda: run_edit(trs_wide, two))
    phase("incremental edit", f"{smi}: {N_CHAINS} traces of the 50-address body at d = {EDIT_D} "
                              f"({nbytes / 1e9:.2f} GB of choices), vmapped Update, host clock, median of 3: "
                              f"{line_two}; {line_all}; all/two {all_ms / two_ms:.2f}x; "
                              + busy_line("the 2-address edit", busy, two_ms))
    del trs_wide

    trs_chain = vm(lambda _: chain.simulate(gen, ()))(dummy)
    addrs = [f"a{i}" for i in range(EDIT_CHAIN)]
    line_head, head_ms = both_rules("chain, head", trs_chain, g.Update(g.C["a0"].set(v)), 2, addrs)
    line_tail, tail_ms = both_rules("chain, tail", trs_chain, g.Update(g.C[f"a{EDIT_CHAIN - 1}"].set(v)), 1, addrs)
    phase("incremental edit", f"{smi}: {N_CHAINS} traces of the {EDIT_CHAIN}-address chain at d = {EDIT_D}: "
                              f"{line_head}; {line_tail}; head/tail {head_ms / tail_ms:.2f}x")
    del trs_chain

    obs = g.C["y"].set(torch.as_tensor(y, device=device))
    trs = vm(lambda _: model.generate(gen, obs, ())[0])(dummy)
    line_regen, _ = both_rules('flagship, Regenerate(S["tau"])', trs, g.Regenerate(g.S["tau"]), 2,
                               ["tau", "w", "y"])

    def mh_of(request, seed):
        gen_m = torch.Generator(device=device).manual_seed(seed)
        return vm(lambda tr: g.mh(gen_m, tr, request))(trs)

    lines = []
    for name, request, dispatched in (('mh(Regenerate(S["tau"]))', g.Regenerate(g.S["tau"]), 2),
                                      ("mh(HMC(S[w] | S[tau]))", g.HMC(g.S["w"] | g.S["tau"], EPS, L=L), 3)):
        new, acc = mh_of(request, SEED + 1)
        torch.cuda.synchronize()
        check(edit.last_rule == "incremental", f"{name}: the edit took {edit.last_rule} ({edit.last_rule_reason})")
        check(edit.last_dispatched == dispatched, f"{name}: {edit.last_dispatched} sub-edits, expected {dispatched}")
        with forced_clean_prefix():
            new_c, acc_c = mh_of(request, SEED + 1)
        gap = max(close_rel(new[a], new_c[a], 1e-5) for a in ("tau", "w"))
        check(gap <= 1e-5 and torch.equal(acc, acc_c), f"{name}: the chains part from the clean-prefix rule's "
                                                        f"({gap:.3g})")
        inc_ms = wall_ms(lambda: mh_of(request, SEED + 2))
        with forced_clean_prefix():
            cp_ms = wall_ms(lambda: mh_of(request, SEED + 2))
        lines.append(f"{name}: accept {float(acc.float().mean()):.4f}, {dispatched} sub-edits in the final edit, "
                     f"{inc_ms:.3f} ms against {cp_ms:.3f} ms under the clean-prefix rule; the same "
                     f"accepts and choices within {gap:.2g}")
    phase("incremental edit", f"{smi}: the flagship at {N_CHAINS} traces: {line_regen}; " + "; ".join(lines)
                              + f"; the phase took {time.perf_counter() - t0:.1f} s")


def checkify_path(device, smi: str, g) -> None:
    """The runtime checks on the card, inside ``torch.func.vmap``: each
    raises under ``do_checkify()``, and none raises, nor reads the card from
    the host, outside it."""
    from genjax_tpu_torch.checkify import CheckError, do_checkify
    from genjax_tpu_torch.generative.choice_map import ChoiceMapInvalidAddress

    t0 = time.perf_counter()
    n = 4096
    gen = torch.Generator(device=device).manual_seed(SEED)

    @g.gen
    def model():
        x = g.normal(torch.zeros(8, device=device), 1.0) @ "x"
        return g.normal(x.sum(), 1.0) @ "y"

    flags = torch.ones(n, dtype=torch.bool, device=device)
    flags[n // 2] = False
    value = torch.tensor(0.5, device=device)
    calls = {
        "a typo'd constraint address": (
            lambda: torch.func.vmap(lambda _: model.generate(gen, g.C["yy"].set(value), ())[1],
                                    randomness="different")(flags), ChoiceMapInvalidAddress),
        "a typo'd address under a tensor flag": (
            lambda: torch.func.vmap(lambda f: model.generate(gen, g.C["yy"].set(value).mask(~f), ())[1],
                                    randomness="different")(flags), ChoiceMapInvalidAddress),
        "an invalid Mask unmasked": (
            lambda: torch.func.vmap(lambda f: g.Mask(value, f).unmask())(flags), CheckError),
        "a false masked flag in assess": (
            lambda: torch.func.vmap(lambda f: g.normal.assess(g.ChoiceMap.entry(g.Mask(value, f)), (0.0, 1.0))[0])(
                flags), CheckError),
    }
    raised = []
    for name, (fn, error) in calls.items():
        with do_checkify():
            try:
                fn()
                torch.cuda.synchronize()
            except error:
                raised.append(name)
        check(name in raised, f"checkify: {name} did not raise {error.__name__} inside torch.func.vmap on the card")
        reads = host_reads(fn)
        check(reads == 0, f"checkify: {name} read the card {reads} times outside do_checkify")
    phase("checkify", f"{smi}: {len(raised)} checks raised inside torch.func.vmap over {n} lanes on the card "
                      f"under do_checkify ({', '.join(raised)}); outside it none raised and none read the card "
                      f"from the host (host_reads 0); {time.perf_counter() - t0:.1f} s")


def time_travel_path(device, smi: str, g) -> None:
    """The time-travel debugger on card tensors: the reference test's
    frames and tags, a remix equal to a plain run, and a ``@gen`` program on
    a card generator whose prefix a remix draws again bit for bit."""
    from genjax_tpu_torch.debug import rec, tag, time_machine

    t0 = time.perf_counter()

    def program(x):
        y = rec(lambda a: a * 2.0, "double")(x)
        z = rec(lambda a: a + 10.0, "add10")(y)
        return tag(z * z, "squared")

    x = torch.tensor(3.0, device=device)
    dbg = time_machine(program)(x)
    tags = [f.debug_tag for f in dbg.sequence]
    check(tags == ["_enter", "double", "add10", "squared", "_exit"], f"time travel: frames {tags}")
    at = dbg.jump("add10")
    check(float(dbg.final_retval) == 256.0 and float(at.frame()[1].args[0]) == 6.0
          and float(at.frame()[1].local_retval) == 16.0, "time travel: the program's values")
    new = torch.tensor(100.0, device=device)
    remixed = at.remix(new)
    check(torch.equal(remixed.final_retval, (new + 10.0) * (new + 10.0)), "time travel: remix is no plain run")
    check(at.fwd().frame()[0] == "squared" and at.bwd().frame()[0] == "double", "time travel: fwd/bwd")

    def prog(v):
        s = tag(torch.sum(v**2), "ss")
        return s + tag(torch.mean(v), "mean")

    dbg2 = time_machine(prog)(torch.arange(4.0, device=device))
    check(float(dbg2.final_retval) == 15.5 and [f.debug_tag for f in dbg2.sequence] == ["_enter", "ss", "mean", "_exit"],
          "time travel: the array program")

    @g.gen
    def model(mu):
        x = g.normal(mu, 1.0) @ "x"
        shifted = tag(x + 100.0, "shifted")
        return g.normal(shifted, 0.5) @ "y"

    gen = torch.Generator(device=device).manual_seed(SEED)
    mu = torch.zeros(N_CHAINS, device=device)

    def run(m):
        trs = torch.func.vmap(lambda a: model.simulate(gen, (a,)), randomness="different")(m)
        return trs["x"], trs["y"]

    dbg3 = time_machine(run, streams=(gen,))(mu)
    x0, y0 = dbg3.final_retval
    at3 = dbg3.jump("shifted")
    remixed3 = at3.remix(torch.full((N_CHAINS,), -50.0, device=device))
    x1, y1 = remixed3.final_retval
    check(torch.equal(x1, x0), "time travel: a remix drew the prefix's x differently")
    check(x1.device == x0.device == mu.device and bool((y1.mean() + 50.0).abs() < 0.05), f"time travel: remixed y mean {float(y1.mean())}")
    again = dbg3.jump("_enter").remix(mu)
    check(torch.equal(again.final_retval[0], x0) and torch.equal(again.final_retval[1], y0),
          "time travel: a remix with the first arguments is no replay")
    phase("time travel", f"{smi}: the reference test's frames and tags, remix (100 + 10)^2 = "
                         f"{float(remixed.final_retval)} as a plain run gives; a vmapped @gen simulate of {N_CHAINS} "
                         f"lanes on a card generator named in streams: a remix at 'shifted' draws the prefix's x "
                         f"bit for bit, and a remix at '_enter' replays x and y bit for bit; "
                         f"{time.perf_counter() - t0:.1f} s")


# the column samplers on the row-sharded tp_bnn_logdensity at a world of one
# rank (the [parallel] phase's BNN shape), each against the unsharded twin on
# the same seed: positions within TPS_TOL, the statistics within TPS_STAT_TOL
TPS_SEED = 17
TPS_HMC_STEPS, TPS_HMC_L, TPS_EPS = 10, 5, 0.005
TPS_NUTS_STEPS, TPS_NUTS_DEPTH = 2, 5
TPS_CHEES_WARMUP, TPS_CHEES_STEPS = 10, 5
TPS_TOL = 1e-4
TPS_STAT_TOL = 1e-5


def tp_sampling_path(device, smi: str) -> None:
    """``[tensor-parallel sampling]``: ``pallas_hmc(backend="torch")``, the
    NUTS twin ``nuts_sweep_cols`` and ``chees_hmc`` on ``tp_bnn_logdensity``
    (hidden 256, d_in 8, 64 rows, 1,024 chains) over a ``(1, 1)`` ``("model",
    "batch")`` mesh of one NCCL rank, each held against the unsharded twin
    ``bnn_logdensity_reference`` on the same seed, with its time (host clock
    around a synchronised run) and the collectives it issued."""
    import os
    import tempfile

    import torch.distributed as dist
    from genjax_tpu_torch.kernels import chees_hmc, nuts_sweep_cols, pallas_hmc
    from genjax_tpu_torch.parallel import (
        bnn_logdensity_reference, bnn_param_count, collective_counts, collective_log, initialize_distributed,
        make_mesh_2d, shard_params, tp_bnn_logdensity,
    )

    t_tp = time.perf_counter()
    rng = np.random.default_rng(TPS_SEED)
    d = bnn_param_count(PAR_BNN_D_IN, PAR_BNN_HIDDEN)
    X = torch.from_numpy(rng.normal(size=(PAR_BNN_M, PAR_BNN_D_IN)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.normal(size=PAR_BNN_M).astype(np.float32)).to(device)
    q_all = torch.from_numpy((rng.normal(size=(d, PAR_BNN_CHAINS)) * 0.3).astype(np.float32)).to(device)
    samplers = [
        ("pallas_hmc(backend='torch')", lambda ld, q: pallas_hmc(
            ld, q, 11, n_steps=TPS_HMC_STEPS, eps=TPS_EPS, L=TPS_HMC_L, backend="torch")),
        ("nuts_sweep_cols", lambda ld, q: nuts_sweep_cols(
            ld, q, 5, n_steps=TPS_NUTS_STEPS, eps=TPS_EPS, max_depth=TPS_NUTS_DEPTH)),
        ("chees_hmc", lambda ld, q: (lambda qi: (qi[0], qi[1].accept_rate))(chees_hmc(
            ld, q, 6, n_warmup=TPS_CHEES_WARMUP, n_steps=TPS_CHEES_STEPS, eps0=TPS_EPS))),
    ]
    store_dir = tempfile.mkdtemp()
    initialize_distributed(rank=0, world_size=1, store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                           device_type=device.type)
    try:
        mesh = make_mesh_2d((1, 1), axes=("model", "batch"), device=device.type)
        ld_tp = tp_bnn_logdensity(X, y, PAR_BNN_HIDDEN, mesh)
        ld_ref = bnn_logdensity_reference(X, y, PAR_BNN_HIDDEN)
        q0 = shard_params(q_all, mesh)
        for name, run in samplers:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with collective_log() as log:
                q_tp, stat_tp = run(ld_tp, q0)[:2]
                torch.cuda.synchronize()
            tp_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            q_ref, stat_ref = run(ld_ref, q_all)[:2]
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
            diff = (q_tp - q_ref).abs().amax(dim=0)
            frac = float((diff <= TPS_TOL).float().mean())
            stat_err = abs(float(stat_tp) - float(stat_ref))
            counts = collective_counts(log)
            check(bool(torch.isfinite(q_tp).all()), f"[tensor-parallel sampling] {name}: non-finite positions")
            check(frac == 1.0, f"[tensor-parallel sampling] {name}: {frac:.5f} of chains within {TPS_TOL} "
                               f"of the unsharded twin (max {float(diff.max()):.3g})")
            check(stat_err <= TPS_STAT_TOL, f"[tensor-parallel sampling] {name}: accept {float(stat_tp)} vs "
                                            f"{float(stat_ref)}")
            check(counts["count"] > 0 and {o["group"] for o in counts["ops"]} <= {"model", "batch"},
                  f"[tensor-parallel sampling] {name}: collectives {counts['ops']}")
            by_group = {}
            for o in counts["ops"]:
                by_group[o["group"]] = by_group.get(o["group"], 0) + o["calls"]
            phase("tensor-parallel sampling",
                  f"{smi}: {name} on tp_bnn_logdensity (hidden {PAR_BNN_HIDDEN}, d_in {PAR_BNN_D_IN}, "
                  f"{PAR_BNN_M} rows, D = {d}, {PAR_BNN_CHAINS} chains, mesh {mesh.shape}): every chain within "
                  f"{TPS_TOL} of the unsharded twin (max {float(diff.max()):.3g}), accept {float(stat_tp):.6f} vs "
                  f"{float(stat_ref):.6f}; {tp_s * 1e3:.1f} ms sharded, {ref_s * 1e3:.1f} ms unsharded (host "
                  f"clock, synchronised, first call); {counts['count']} collectives ({counts['bytes']} B): "
                  + ", ".join(f"{n} over {g_}" for g_, n in sorted(by_group.items())))
    finally:
        dist.destroy_process_group()
    phase("tensor-parallel sampling", f"the phase took {time.perf_counter() - t_tp:.1f} s; group destroyed")


def cookbook_child(device, out_path: str) -> None:
    """``[cookbook]``'s work: every cookbook of ``genjax_tpu_torch/cookbook``
    run as ``--device cuda`` runs it (``main(device="cuda")``, in this
    process), its own assertions its gate, so a cookbook that raises ends
    the process with an error. For each, its wall seconds (host clock), the
    K1, K3 and K4 launches it made (the counts set to 0 just before it and
    read just after) and its last printed line, written to ``out_path`` as
    JSON after each cookbook, with the seconds since the process started
    (``at``)."""
    import contextlib
    import importlib
    import io

    from genjax_tpu_torch.cookbook import COOKBOOKS
    from genjax_tpu_torch.kernels import elliptical, hmc, nuts_pallas

    out = {}
    for name in COOKBOOKS:
        hmc.hmc_sweep_launches = 0
        nuts_pallas.nuts_sweep_launches = 0
        elliptical.ess_gauss_sweep_launches = 0
        mod = importlib.import_module(f"genjax_tpu_torch.cookbook.{name}")
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            mod.main(device=device.type)
        if device.type == "cuda":
            torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0, "K1": hmc.hmc_sweep_launches,
                     "K3": elliptical.ess_gauss_sweep_launches, "K4": nuts_pallas.nuts_sweep_launches,
                     "said": (printed.getvalue().strip().splitlines() or [""])[-1][:160],
                     "at": time.perf_counter() - T_START}
        print(f"[cookbook] {name}: {out[name]['s']:.2f} s [t+{time.perf_counter() - T_START:.1f} s]", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        with open(out_path, "w") as f:
            json.dump(out, f)


def cookbook_start():
    """Start ``[cookbook]`` in a process of its own, ``python3 chip_smoke.py
    --cookbooks OUT``, beside the later phases: the cookbooks are host-bound
    (the card idle most of the time) and the kernels' timings are done by
    then. Returns ``(process, out_path, log_path, t0)``."""
    import os
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_cookbook_")
    out_path, log_path = os.path.join(work, "cookbooks.json"), os.path.join(work, "cookbooks.log")
    log = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, __file__, "--cookbooks", out_path], stdout=log,
                            stderr=subprocess.STDOUT)
    log.close()
    return proc, out_path, log_path, time.perf_counter()


def cookbook_finish(started, smi: str) -> None:
    """Wait for ``[cookbook]``'s process and report each cookbook; the run
    fails unless every cookbook of the package ran and the process ended
    with 0."""
    from genjax_tpu_torch.cookbook import COOKBOOKS

    proc, out_path, log_path, t0 = started
    rc = proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(log_path) as f:
            print(f.read()[-8000:], flush=True)
    check(rc == 0, f"[cookbook] the cookbooks' process ended with {rc} (its log's end above)")
    with open(out_path) as f:
        out = json.load(f)
    check(list(out) == list(COOKBOOKS), f"[cookbook] ran {list(out)}, not {list(COOKBOOKS)}")
    for name, r in out.items():
        phase("cookbook", f"{smi}: {name} --device cuda: {r['s']:.2f} s, K1 {r['K1']}, K3 {r['K3']}, "
                          f"K4 {r['K4']} launches; it said: {r['said']}")
    phase("cookbook", f"{len(out)} cookbooks in {sum(r['s'] for r in out.values()):.1f} s of their own, done "
                      f"{out[COOKBOOKS[-1]]['at']:.1f} s after their process started, beside the phases from "
                      f"[column samplers] on (collected {wall:.1f} s after the start, when those ended)")


def finish_phases(device, smi: str, g, hmc, nuts_pallas, elliptical, model, y, k1_draws) -> int:
    """The phases after the GP path, which need no kernel timing of their
    own and run beside ``[cookbook]``'s process. Each path returns the
    memory its allocator cached (``torch.cuda.empty_cache``) before the
    next: the two processes share the card, and NCCL allocates outside
    torch's allocator. Returns the K1 launches of the checkpointed run."""

    def settled(fn, *args):
        out = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return out

    # ---- the column samplers: ChEES, PT, the dense metric, SVGD (no kernel)
    settled(column_samplers_path, device, smi, g, hmc, nuts_pallas, elliptical, model, y, k1_draws)

    # ---- the combinators: the scanned state-space model and every configuration
    t_comb = time.perf_counter()
    settled(ssm_path, device, smi, g, hmc)
    settled(combinators_path, device, smi, g)
    phase("combinators", f"the combinator phases took {time.perf_counter() - t_comb:.1f} s")

    # ---- SMC and GenSP: the particle filter, tempered SMC, SIR, the Kalman oracle (no kernel)
    settled(smc_path, device, smi, g)

    # ---- the catalog, ADEV and VI, MAP and Laplace, ADVI (no kernel)
    settled(vi_path, device, smi, g)

    # ---- the discrete HMM, Gibbs, particle Gibbs, the requests, involutive
    # MCMC, predictive checks and SBC, PPCA and the BNN (no kernel)
    settled(discrete_path, device, smi, g)

    # ---- ABC, SMC², ChEES-tempered SMC, nested sampling, Pathfinder, model
    # comparison (no kernel), and checkpointed resume of sample_posterior (K1)
    ck_launches = settled(population_path, device, smi, g, hmc, model, y)

    # ---- the incremental edit, the runtime checks and the time-travel debugger (no kernel)
    settled(edit_path, device, smi, g, model, y)
    settled(checkify_path, device, smi, g)
    settled(time_travel_path, device, smi, g)

    return ck_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}, matmul tf32 off")

    import genjax_tpu_torch as g
    from genjax_tpu_torch.kernels import _build, adaptation, bodies, elliptical, hmc, nuts, nuts_pallas
    from genjax_tpu_torch.kernels.model_interface import (
        ColumnPacker, column_hmc, column_logdensity, column_nuts, init_columns,
    )
    from genjax_tpu_torch.models import hierarchical_regression

    # ---- build: one nvcc for each source, started together
    def timed_load(lib):
        t0 = time.perf_counter()
        lib()
        return time.perf_counter() - t0

    def first_grad():
        # the first torch.func.grad_and_value imports torch._dynamo, sympy and
        # torch.distributed.tensor, seconds of host work that the trace path
        # would otherwise pay in its first transition: done beside the builds
        x = torch.ones(4, 3, device=device)
        torch.func.vmap(torch.func.grad_and_value(lambda z: (z * z).sum()))(x)

    with ThreadPoolExecutor(5) as pool:
        k1_load, k4_load, k3_load, k2_load, grad_load = pool.map(
            timed_load, (hmc._lib, nuts_pallas._lib, elliptical._lib, lambda: _build.load("k2_stream"),
                         first_grad))
    phase("build", f"K1 loaded from genjax_tpu_torch/kernels/csrc/hmc_sweep.cu "
                   f"in {k1_load:.2f} s (build included)")
    phase("build", f"K4 loaded from genjax_tpu_torch/kernels/csrc/nuts_sweep.cu "
                   f"in {k4_load:.2f} s (build included, in parallel with K1's)")
    phase("build", f"K3 loaded from genjax_tpu_torch/kernels/csrc/ess_gauss_sweep.cu "
                   f"in {k3_load:.2f} s (build included, in parallel with K1's and K4's)")
    phase("build", f"K2 alone loaded from genjax_tpu_torch/kernels/csrc/k2_stream.cu "
                   f"in {k2_load:.2f} s (build included, in parallel with the others)")
    phase("build", f"torch.func's first grad_and_value (its lazy imports) took {grad_load:.2f} s beside the builds")
    X, y = flagship_data()
    flag_body = bodies.hier_regression(X, y, 0.25)
    gen_body = generic_body(bodies)
    for body, d in [(flag_body, 16), (gen_body, 8)]:
        spec = int(body.variant(d) == "specialised")
        k1_smem = hmc.smem_bytes(body, d)
        c_smem = hmc._lib().hmc_smem_bytes(d, body.kind, spec, body.n_obs, body.d_w)
        check(k1_smem == c_smem, f"K1 shared memory: the wrapper says {k1_smem} B, the kernel {c_smem} B")
        k4_smem = nuts_pallas.smem_bytes(body, d, NUTS_DEPTH, nuts_pallas.DEFAULT_BLOCK)
        c_smem = nuts_pallas._lib().nuts_smem_bytes(d, body.kind, spec, body.n_obs, body.d_w,
                                                    NUTS_DEPTH, nuts_pallas.DEFAULT_BLOCK)
        check(k4_smem == c_smem, f"K4 shared memory: the wrapper says {k4_smem} B, the kernel {c_smem} B")
        phase("build", f"dynamic shared memory, {body.name} ({body.n_obs}, {body.d_w}) "
                       f"{body.variant(d)}, D={d}: K1 {k1_smem} B a block; K4 {k4_smem} B a block "
                       f"(depth {NUTS_DEPTH}, {nuts_pallas.DEFAULT_BLOCK} chains) of the card's "
                       f"{nuts_pallas._lib().nuts_smem_limit(0)} B")
    for d in (3, 16, 250, GP_D, 300):
        geo, c_geo = elliptical.geometry(d), elliptical.geometry_cuda(d)
        check(geo == c_geo, f"K3 geometry at D={d}: the wrapper says {geo}, the kernel {c_geo}")
        phase("build", f"K3 at D={d}: {geo['variant']} variant, {geo['smem_bytes']} B of dynamic "
                       f"shared memory a block ({elliptical.NB} chains) of the card's "
                       f"{elliptical._lib().ess_gauss_smem_limit(0)} B, {geo['tiles']} tiles of chol "
                       f"(the wrapper's reckoning equals the kernel's)")
    for source in ("hmc_sweep", "nuts_sweep", "ess_gauss_sweep", "k2_stream"):
        for name, regs, stores, loads, smem, stack in ptxas_kernels(_build.ptxas_report(source)):
            phase("build", f"{source}.cu {name}: {regs} registers, stack frame {stack} B, spill "
                           f"stores {stores} B, spill loads {loads} B, static smem {smem} B")

    # ---- registers, spills and resident blocks an SM, from the CUDA runtime
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for body, d in [(flag_body, 16), (gen_body, 8)]:
        info = hmc.kernel_info(body, d)
        blocks = -(-N_CHAINS // hmc.THREADS)
        phase("occupancy", f"K1 {body.name} ({body.n_obs}, {body.d_w}) {body.variant(d)}, D={d}, "
                           f"{hmc.THREADS} threads a block: {info['registers']} registers, "
                           f"{info['local_bytes']} B local a thread, {info['blocks_per_sm']} "
                           f"blocks an SM ({info['blocks_per_sm'] * hmc.THREADS // 32} warps); "
                           f"{N_CHAINS} chains make {blocks} blocks = "
                           f"{blocks / (n_sms * info['blocks_per_sm']):.3f} waves on {n_sms} SMs")
    for block in (nuts_pallas.DEFAULT_BLOCK, BLOCK_N):
        info = nuts_pallas.kernel_info(flag_body, 16, NUTS_DEPTH, block)
        phase("occupancy", f"K4 hier_regression (16, 8) specialised, D=16, {block} chains a "
                           f"block, depth {NUTS_DEPTH}: {info['registers']} registers, "
                           f"{info['local_bytes']} B local a thread, {info['blocks_per_sm']} "
                           f"blocks an SM ({info['blocks_per_sm'] * block // 32} warps)")

    for d in (GP_D, 300):
        info = elliptical.kernel_info(d)
        blocks = -(-GP_CHAINS // elliptical.NB)
        geo = elliptical.geometry(d)
        phase("occupancy", f"K3 at D={d}, {geo['variant']} variant, {geo['threads']} threads "
                           f"a block: {info['registers']} registers, {info['local_bytes']} B local a "
                           f"thread, {info['blocks_per_sm']} block(s) an SM; {GP_CHAINS} chains make "
                           f"{blocks} blocks = {blocks / (n_sms * max(info['blocks_per_sm'], 1)):.3f} "
                           f"waves on {n_sms} SMs")

    # ---- K2 on the card: bit for bit against the plain counter stream
    worst_rel = 0.0
    for seed, block, salt, shape in [
        (0, 0, 0, (8, 128)), (-5, 3, 6, (16, 128)), (2**31 - 1, 2, 2, (128,)),
        (-2**31, 1, 198, (1, 128)), (123456789, 3, 9, (16, 2048)),
    ]:
        bits, unif, normals = hmc.counter_stream_cuda(seed, block, salt, shape, device)
        rand_bits = hmc._sw_rand_bits_factory(
            hmc._block_base(seed, block) + torch.zeros((), dtype=torch.int64, device=device)
        )
        check(torch.equal(bits, rand_bits(shape, salt)), f"counter bits differ at {seed, block, salt, shape}")
        check(torch.equal(unif, hmc._uniform_01(rand_bits, shape, salt)), "counter uniforms differ")
        ref = hmc._normal(rand_bits, shape, salt)
        rel = float(((normals - ref).abs() / ref.abs().clamp_min(1e-3)).max())
        worst_rel = max(worst_rel, rel)
    check(worst_rel < 1e-5, f"counter normals differ: max rel err {worst_rel:.3g}")
    phase("K2", f"counter bits and uniforms equal bit for bit over 5 draws; "
                f"normals max rel err {worst_rel:.3g}")
    k2_lib = _build.load("k2_stream")
    k2_entry = k2_own(device, smi, hmc, k2_lib, k2_line(device, smi))
    k2_entry["domain"] = k2_domain(device, smi, k2_lib)

    # ---- K1 against its plain version on the counter stream
    model = hierarchical_regression(X)
    obs = g.C["y"].set(y)
    packer = ColumnPacker(model, obs, (), ["tau", "w"])
    ld = column_logdensity(model, obs, (), packer)
    check(ld.body is not None and ld.body.name == "hier_regression", "flagship density has no body")
    iid = bodies.iid_normal()
    cases = [
        ("iid_normal", iid, iid, numpy_q0(8, 4096, 11, False), 0.2, "specialised"),
        ("hier_regression", ld, ld.body, numpy_q0(16, 4096, 12, True), EPS, "specialised"),
        ("hier_regression", ld, ld.body, numpy_q0(16, N_CHAINS, 13, True), EPS, "specialised"),
        ("hier_regression (5, 3)", gen_body, gen_body, numpy_q0(8, 4096, 14, True), EPS, "generic"),
    ]
    flagship_err = None
    for name, density, body, q0_np, eps, variant in cases:
        frac, flipped, err, rate_k, rate_t = compare_counter(density, body, q0_np, 7, eps, device, hmc)
        phase("K1 vs plain", f"{name} {q0_np.shape}, {hmc.hmc_sweep.last_variant} variant: "
                             f"{frac:.5f} of chains within 1e-4 ({flipped} flipped MH "
                             f"decisions), max abs err {err:.3g} on the rest; accept "
                             f"{rate_k:.5f} vs {rate_t:.5f}")
        check(hmc.hmc_sweep.last_variant == variant, f"{name}: K1 took {hmc.hmc_sweep.last_variant}")
        check(frac >= 0.995, f"{name}: only {frac:.4f} of chains agree within 1e-4")
        check(abs(rate_k - rate_t) <= 0.005, f"{name}: accept rates {rate_k} vs {rate_t}")
        if q0_np.shape[1] == N_CHAINS:
            flagship_err = err

    # ---- the main path, through the public entry point
    hmc.hmc_sweep_launches = 0
    t0 = time.perf_counter()
    q, accept, packer = column_hmc(
        model, obs, (), ["tau", "w"], n_chains=N_CHAINS, n_steps=N_STEPS, eps=EPS, L=L,
        seed=SEED, device="cuda",
    )
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = hmc.hmc_sweep_launches
    check(launches > 0, "the main path launched the sweep kernel no time")
    check(hmc.pallas_hmc.last_backend == "cuda", f"main path took {hmc.pallas_hmc.last_backend}")
    check(hmc.hmc_sweep.last_variant == "specialised",
          f"the flagship took K1's {hmc.hmc_sweep.last_variant} variant")
    check(tuple(q.shape) == (16, N_CHAINS), f"positions have shape {tuple(q.shape)}")
    check(bool(torch.isfinite(q).all()), "main-path positions are not finite")
    phase("main path", f"column_hmc flagship {N_CHAINS} chains x {N_STEPS} steps on "
                       f"{hmc.pallas_hmc.last_backend}, K1's {hmc.hmc_sweep.last_variant} "
                       f"variant: {launches} kernel launch(es), accept {float(accept):.4f}, "
                       f"{main_s:.2f} s including init")

    q0 = init_columns(model, obs, (), packer, N_CHAINS, SEED, device)
    q_twin, accept_twin = hmc.pallas_hmc(
        ld, q0, SEED, n_steps=N_STEPS, eps=EPS, L=L, backend="torch"
    )
    check(abs(float(accept) - float(accept_twin)) <= 0.02,
          f"accept rates {float(accept)} vs twin {float(accept_twin)}")
    # tau (row 0) and w (rows 1-8): cross-chain means within 4 Monte Carlo
    # standard errors of the twin's
    real_k, real_t = q[:9], q_twin[:9]
    se = torch.sqrt((real_k.var(dim=1) + real_t.var(dim=1)) / N_CHAINS)
    z = ((real_k.mean(dim=1) - real_t.mean(dim=1)) / se).abs()
    check(bool((z < 4).all()), f"tau, w means differ from the twin by {z.tolist()} standard errors")
    phase("main path vs twin", f"accept {float(accept):.4f} vs {float(accept_twin):.4f}; "
                               f"tau mean {float(q[0].mean()):.4f} vs {float(q_twin[0].mean()):.4f} "
                               f"({float(z[0]):.2f} SE), w means within {float(z[1:].max()):.2f} SE "
                               f"(limit 4 MC standard errors)")

    # ---- the HMC warmup path: one K1 launch per phase and one for the sweep
    hmc.hmc_sweep_launches = 0
    q_w, accept_w, _ = column_hmc(
        model, obs, (), ["tau", "w"], n_chains=N_CHAINS, n_steps=N_STEPS, eps=EPS, L=L,
        seed=SEED, warmup=True, device="cuda",
    )
    torch.cuda.synchronize()
    warm_launches = hmc.hmc_sweep_launches
    check(warm_launches == HMC_WARMUP_PHASES + 1,
          f"column_hmc(warmup=True) made {warm_launches} K1 launches, not {HMC_WARMUP_PHASES + 1}")
    check(hmc.pallas_hmc.last_backend == "cuda", "the HMC warmup path left the card")
    check(hmc.hmc_sweep.last_variant == "specialised", "the HMC warmup left the specialised variant")
    check(bool(torch.isfinite(q_w).all()), "warmed-up HMC positions are not finite")
    phase("main path HMC warmup", f"column_hmc(warmup=True) flagship: {warm_launches} K1 "
                                  f"launches ({HMC_WARMUP_PHASES} phases + 1), accept "
                                  f"{float(accept_w):.4f}")

    # ---- the trace path: mh(HMC) a transition, and run_chains_hmc on K1
    gfi_launches = gfi_path(device, smi, g, hmc, model, y, ld, q0)

    # ---- the one-call driver on K1
    sp_launches, k1_draws = sample_posterior_path(device, smi, g, hmc, model, y)

    # ---- K4 against its plain version on the counter stream
    k4_cases = [
        ("iid_normal", iid, iid, numpy_q0(8, 4096, 21, False), 0.4),
        ("hier_regression", ld, ld.body, numpy_q0(16, 4096, 22, True), 0.05),
        ("hier_regression", ld, ld.body, numpy_q0(16, N_CHAINS, 23, True), 0.05),
        ("hier_regression (5, 3)", gen_body, gen_body, numpy_q0(8, 4096, 24, True), 0.05),
    ]
    k4_err = None
    for name, density, body, q0_np, eps in k4_cases:
        frac, n_chains_diff, n_blocks_diff, err, (acc_k, lf_k), (acc_t, lf_t) = (
            compare_nuts_counter(density, body, q0_np, 7, eps, 6, device, nuts, nuts_pallas)
        )
        phase("K4 vs plain", f"{name} {q0_np.shape}, {nuts_pallas.nuts_sweep.last_variant} "
                             f"variant, eps {eps}, depth 6, 3 transitions: "
                             f"{frac:.5f} of chains within 1e-4 ({n_chains_diff} chains in "
                             f"{n_blocks_diff} of {q0_np.shape[1] // BLOCK_N} blocks differ), max "
                             f"abs err {err:.3g} on the rest; accept {acc_k:.5f} vs {acc_t:.5f}; "
                             f"leapfrogs {lf_k:.4f} vs {lf_t:.4f}")
        check(nuts_pallas.nuts_sweep.last_variant == body.variant(q0_np.shape[0]),
              f"{name}: K4 took {nuts_pallas.nuts_sweep.last_variant}")
        check(frac >= 0.99, f"{name}: only {frac:.4f} of chains agree within 1e-4")
        check(abs(acc_k - acc_t) <= 0.005, f"{name}: accept statistics {acc_k} vs {acc_t}")
        check(abs(lf_k - lf_t) <= 0.01 * lf_t, f"{name}: mean leapfrogs {lf_k} vs {lf_t}")
        if q0_np.shape[1] == N_CHAINS:
            k4_err = err

    # ---- the adapted column-NUTS path, through the public entry point
    hmc.hmc_sweep_launches = 0
    nuts_pallas.nuts_sweep_launches = 0
    t0 = time.perf_counter()
    q_n, acc_n, leaps_n, _ = column_nuts(
        model, obs, (), ["tau", "w"], n_chains=N_CHAINS, n_steps=NUTS_STEPS, eps=NUTS_EPS0,
        max_depth=NUTS_DEPTH, seed=SEED, warmup=True, device="cuda",
    )
    torch.cuda.synchronize()
    nuts_s = time.perf_counter() - t0
    k4_launches = nuts_pallas.nuts_sweep_launches
    check(k4_launches == NUTS_WARMUP_PHASES + 1,
          f"column_nuts(warmup=True) made {k4_launches} K4 launches, not {NUTS_WARMUP_PHASES + 1}")
    check(hmc.hmc_sweep_launches == 0, "the NUTS path launched K1")
    check(nuts_pallas.pallas_nuts.last_backend == "cuda",
          f"the NUTS path took {nuts_pallas.pallas_nuts.last_backend}")
    check(nuts_pallas.nuts_sweep.last_variant == "specialised",
          f"the flagship took K4's {nuts_pallas.nuts_sweep.last_variant} variant")
    check(tuple(q_n.shape) == (16, N_CHAINS), f"NUTS positions have shape {tuple(q_n.shape)}")
    check(bool(torch.isfinite(q_n).all()), "NUTS positions are not finite")

    # the same warmup again, outside the counted run, for its eps and mass:
    # K4 is deterministic, so its sweep must give the main path's positions
    q0_n = init_columns(model, obs, (), packer, N_CHAINS, SEED, device)
    t0 = time.perf_counter()
    q_wn, eps_n, im_n = nuts_pallas.warmup_column_nuts(
        ld, q0_n, SEED, eps0=NUTS_EPS0, max_depth=NUTS_DEPTH
    )
    torch.cuda.synchronize()
    nuts_warm_s = time.perf_counter() - t0
    sweep_kw = dict(n_steps=NUTS_STEPS, eps=eps_n, max_depth=NUTS_DEPTH, inv_mass=im_n)
    q_again, _, _ = nuts_pallas.pallas_nuts(ld, q_wn, SEED, **sweep_kw)
    check(torch.equal(q_again, q_n), "K4 is not deterministic: the main path did not repeat")
    phase("main path NUTS", f"column_nuts(warmup=True) flagship {N_CHAINS} chains x "
                            f"{NUTS_STEPS} steps, depth {NUTS_DEPTH}, on "
                            f"{nuts_pallas.pallas_nuts.last_backend}, K4's "
                            f"{nuts_pallas.nuts_sweep.last_variant} variant, "
                            f"{nuts_pallas.DEFAULT_BLOCK} chains a block: {k4_launches} K4 "
                            f"launches ({NUTS_WARMUP_PHASES} warmup phases + 1), adapted eps {eps_n:.6g}, "
                            f"accept {float(acc_n):.4f}, mean leapfrogs {float(leaps_n):.4f}, "
                            f"{nuts_s:.2f} s including init and warmup; repeat equal")

    # ---- the NUTS main path against the twin, in law, from the warmed-up state
    t0 = time.perf_counter()
    q_nt, acc_nt, leaps_nt = nuts_pallas.pallas_nuts(ld, q_wn, SEED, backend="torch", **sweep_kw)
    torch.cuda.synchronize()
    twin_nuts_s = time.perf_counter() - t0
    check(nuts_pallas.pallas_nuts.last_backend == "torch", "the twin run did not take the twin")
    check(abs(float(acc_n) - float(acc_nt)) <= 0.02,
          f"NUTS accept statistics {float(acc_n)} vs twin {float(acc_nt)}")
    check(abs(float(leaps_n) - float(leaps_nt)) <= 0.05 * float(leaps_nt),
          f"NUTS mean leapfrogs {float(leaps_n)} vs twin {float(leaps_nt)}")
    real_k, real_t = q_n[:9], q_nt[:9]
    se = torch.sqrt((real_k.var(dim=1) + real_t.var(dim=1)) / N_CHAINS)
    z_n = ((real_k.mean(dim=1) - real_t.mean(dim=1)) / se).abs()
    check(bool((z_n < 4).all()), f"NUTS tau, w means differ from the twin by {z_n.tolist()} SE")
    phase("main path NUTS vs twin", f"accept {float(acc_n):.4f} vs {float(acc_nt):.4f}; mean "
                                    f"leapfrogs {float(leaps_n):.4f} vs {float(leaps_nt):.4f}; tau "
                                    f"mean {float(q_n[0].mean()):.4f} vs {float(q_nt[0].mean()):.4f} "
                                    f"({float(z_n[0]):.2f} SE), w means within "
                                    f"{float(z_n[1:].max()):.2f} SE (limit 4); twin sweep "
                                    f"{twin_nuts_s:.2f} s")

    # ---- timings at the main path's shape: K1 over two windows of about a
    # second; 5 twin sweeps
    grad_flop = hier_grad_flop(16, 8, 16)
    k1_times = [
        cuda_ms(lambda: hmc.hmc_sweep(ld.body, q0, SEED, n_steps=N_STEPS, eps=EPS, L=L), K1_TIMED_SWEEPS)
        for _ in range(2)
    ]
    ms = sum(k1_times) / 2
    plain_ms = cuda_ms(
        lambda: hmc._reference_hmc(ld, q0, SEED, n_steps=N_STEPS, eps=EPS, L=L), TWIN_TIMED_SWEEPS
    )
    k1_bound_ms, k1_bound_by = k1_bound(N_CHAINS, 16, N_STEPS, L, grad_flop, 144)
    samples = N_CHAINS * N_STEPS
    phase("timing", f"{smi}: K1 {ms:.4f} ms/sweep = {samples / ms * 1e3:.6g} samples/s (two "
                    f"windows of {K1_TIMED_SWEEPS} sweeps: {k1_times[0]:.4f} and {k1_times[1]:.4f} "
                    f"ms); plain twin {plain_ms:.2f} ms/sweep = {samples / plain_ms * 1e3:.6g} "
                    f"samples/s (window {plain_ms * TWIN_TIMED_SWEEPS / 1e3:.2f} s) ({N_CHAINS} "
                    f"chains x {N_STEPS} steps, L={L}); bound {k1_bound_ms:.4f} ms "
                    f"({k1_bound_by}: {grad_flop} FLOP a gradient), K1 at "
                    f"{k1_bound_ms / ms:.4f} of it")

    call_ms = wall_ms(lambda: column_hmc(
        model, obs, (), ["tau", "w"], n_chains=N_CHAINS, n_steps=N_STEPS, eps=EPS, L=L,
        seed=SEED, device="cuda",
    ))
    init_ms = wall_ms(lambda: init_columns(model, obs, (), packer, N_CHAINS, SEED, device))
    phase("where the time goes", f"column_hmc call {call_ms:.3f} ms (host clock, median of 3): "
                                 f"init_columns {init_ms:.3f} ms, K1 sweep {ms:.4f} ms, the rest "
                                 f"(packer, density closure, routing) "
                                 f"{call_ms - init_ms - ms:.3f} ms")

    # ---- each NUTS warmup phase's K4 time and leapfrogs: warmup_column_nuts's
    # loop again with CUDA events around each sweep, which must repeat it
    warm = []

    def timed_phase(q, idx, eps, inv_mass):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        q, acc, leaps = nuts_pallas.nuts_sweep(
            ld.body, q, (SEED + 1) * 1_000_003 + idx, n_steps=NUTS_STEPS, eps=eps,
            max_depth=NUTS_DEPTH, inv_mass=inv_mass,
        )
        end.record()
        warm.append((start, end, leaps, eps))
        return q, acc.mean() / NUTS_STEPS

    q_wp, eps_wp, _, _ = adaptation.windowed_warmup(
        timed_phase, q0_n, n_windows=NUTS_WARMUP_PHASES, eps0=NUTS_EPS0
    )
    torch.cuda.synchronize()
    check(torch.equal(q_wp, q_wn) and float(eps_wp) == eps_n,
          "the timed warmup did not repeat warmup_column_nuts")
    warm_ms = warm_bound_ms = 0.0
    for idx, (start, end, leaps, eps) in enumerate(warm):
        t = start.elapsed_time(end)
        b, by = k4_bound(N_CHAINS, 16, NUTS_STEPS, float(leaps.sum()), grad_flop, 144)
        warm_ms, warm_bound_ms = warm_ms + t, warm_bound_ms + b
        phase("NUTS warmup phases", f"phase {idx}: eps {eps:.6g}, mean leapfrogs a transition "
                                    f"{float(leaps.mean()) / NUTS_STEPS:.4f}, K4 {t:.4f} ms, bound "
                                    f"{b:.4f} ms ({by}), K4 at {b / t:.4f} of it")
    phase("NUTS warmup phases", f"{smi}: the {NUTS_WARMUP_PHASES} warmup sweeps take {warm_ms:.4f} "
                                f"ms of K4 against a bound of {warm_bound_ms:.4f} ms; the timed "
                                f"warmup repeats warmup_column_nuts exactly")

    # ---- NUTS timings from the warmed-up state: K4 over two windows of
    # >= 1.5 s; the twin over 1 sweep
    def k4_sweep():
        return nuts_pallas.nuts_sweep(
            ld.body, q_wn, SEED, n_steps=NUTS_STEPS, eps=eps_n, max_depth=NUTS_DEPTH, inv_mass=im_n,
        )

    k4_reps = max(3, math.ceil(1.2 * K4_WINDOW_S / 2 * 1e3 / cuda_ms(k4_sweep, 5)))
    k4_times = [cuda_ms(k4_sweep, k4_reps) for _ in range(2)]
    k4_ms = sum(k4_times) / 2
    check(k4_ms * 2 * k4_reps >= K4_WINDOW_S * 1e3, f"K4 timing window {k4_ms * 2 * k4_reps:.0f} ms < {K4_WINDOW_S} s")
    _, _, leaps = k4_sweep()
    k4_bound_ms, k4_bound_by = k4_bound(N_CHAINS, 16, NUTS_STEPS, float(leaps.sum()), grad_flop, 144)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    nuts.nuts_sweep_cols(ld, q_wn, SEED, **sweep_kw)  # the vs-twin run was its warm-up
    end.record()
    torch.cuda.synchronize()
    nuts_plain_ms = start.elapsed_time(end)
    transitions = N_CHAINS * NUTS_STEPS
    phase("timing NUTS", f"{smi}: K4 {k4_ms:.4f} ms per {NUTS_STEPS}-transition sweep, "
                         f"{nuts_pallas.DEFAULT_BLOCK} chains a block (two windows of {k4_reps} "
                         f"sweeps: {k4_times[0]:.4f} and {k4_times[1]:.4f} ms) = "
                         f"{transitions / k4_ms * 1e3:.6g} samples/s = "
                         f"{transitions * float(leaps_n) / k4_ms * 1e3:.6g} leapfrogs/s; plain "
                         f"twin {nuts_plain_ms:.2f} ms per sweep (1 sweep) = "
                         f"{transitions / nuts_plain_ms * 1e3:.6g} samples/s = "
                         f"{transitions * float(leaps_nt) / nuts_plain_ms * 1e3:.6g} leapfrogs/s "
                         f"({N_CHAINS} chains x {NUTS_STEPS} transitions, depth {NUTS_DEPTH}, "
                         f"adapted eps {eps_n:.6g}); bound {k4_bound_ms:.4f} ms ({k4_bound_by}), "
                         f"K4 at {k4_bound_ms / k4_ms:.4f} of it")

    # a chain block runs until its longest tree is done: the share of
    # thread-leaf slots that integrate a live chain, from one transition
    shares = []
    for block in (nuts_pallas.DEFAULT_BLOCK, BLOCK_N):
        _, _, leaves_1 = nuts_pallas.nuts_sweep(ld.body, q_wn, SEED + 1, n_steps=1, eps=eps_n,
                                                max_depth=NUTS_DEPTH, inv_mass=im_n, block_n=block)
        block_max = leaves_1.view(-1, block).amax(dim=1)
        shares.append(f"{block}-chain blocks: mean leapfrogs a chain {float(leaves_1.mean()):.3f}, "
                      f"mean of the block maxima {float(block_max.mean()):.3f}, so "
                      f"{float(leaves_1.mean() / block_max.mean()):.3f} of the slots busy")
    phase("where the time goes", "NUTS, one transition: " + "; ".join(shares)
                                 + f"; column_nuts call {nuts_s:.3f} s (host clock): "
                                 f"warmup_column_nuts {nuts_warm_s:.3f} s ({NUTS_WARMUP_PHASES} K4 "
                                 f"sweeps, {warm_ms / 1e3:.4f} s of K4, and host reads of eps), "
                                 f"the main K4 sweep {k4_ms / 1e3:.4f} s")

    # ---- the scale-out layer at a world of one rank on NCCL (K1 and K4 on the shard)
    par_launches = parallel_path(device, smi, g, hmc, nuts_pallas, model, y, k1_draws)

    # ---- the column samplers on a row-sharded (tensor-parallel) density (no kernel)
    tp_sampling_path(device, smi)

    # ---- the NUTS trace path: sample_posterior nuts/hmc, and run_chains_nuts on K4
    rcn_launches = trace_nuts_path(device, smi, g, hmc, nuts_pallas, model, y)

    # ---- the GP / elliptical-slice path (K3)
    k3_entry = gp_path(device, smi, elliptical)

    # ---- the reference's cookbooks on the port, each as --device cuda runs
    # it, in a process of its own beside the host-bound phases that follow
    cookbooks = cookbook_start()
    try:
        ck_launches = finish_phases(device, smi, g, hmc, nuts_pallas, elliptical, model, y, k1_draws)
        cookbook_finish(cookbooks, smi)
    except BaseException:
        with open(cookbooks[2]) as f:
            print("[cookbook] the cookbooks' process, its log so far:\n" + f.read()[-6000:], flush=True)
        raise
    finally:
        if cookbooks[0].poll() is None:
            cookbooks[0].kill()
            cookbooks[0].wait()

    print(json.dumps({"kernels": [{
        "name": "hmc_sweep (K1, with K2's counter PRNG as device functions)",
        "route": "cuda",
        "source": "genjax_tpu_torch/kernels/csrc/hmc_sweep.cu",
        "replaces": "genjax_tpu/kernels/hmc.py:93",
        "launches": launches,
        "launches_by_path": {"column_hmc": launches, "column_hmc(warmup=True)": warm_launches,
                             **gfi_launches, "sample_posterior(hmc_sweep)": sp_launches,
                             f"sample_posterior(hmc_sweep, checkpoint_every={CK_EVERY})": ck_launches,
                             f"sample_posterior(hmc_sweep, thin={SP_THIN_CONVERGED}, mesh=make_mesh())":
                                 par_launches["k1"]},
        "max_abs_err": flagship_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by,
        "library_ms": None,  # no single PyTorch call computes the sweep
        # K2, the PRNG's device functions inside K1 (and K4, K3): its own time
        # from the standalone launch of csrc/k2_stream.cu, beside its bound and
        # torch.randn + torch.rand
        "k2_philox": {"name": "k2_stream (K2 alone, Philox)", "route": "cuda",
                      "replaces": "genjax_tpu/kernels/hmc.py:39", **k2_entry},
    }, {
        "name": "nuts_sweep (K4)",
        "route": "cuda",
        "source": "genjax_tpu_torch/kernels/csrc/nuts_sweep.cu",
        "replaces": "genjax_tpu/kernels/nuts_pallas.py:72",
        "launches": k4_launches,
        "launches_by_path": {"column_nuts(warmup=True)": k4_launches, "run_chains_nuts": rcn_launches,
                             "column_nuts(warmup=True, mesh=make_mesh())": par_launches["k4"]},
        "max_abs_err": k4_err,
        "ms": k4_ms,
        "plain_ms": nuts_plain_ms,
        "bound_ms": k4_bound_ms,
        "bound_by": k4_bound_by,
        "library_ms": None,  # no single PyTorch call computes the sweep
    }, k3_entry]}), flush=True)
    check(all(math.isfinite(v) for v in (ms, plain_ms, flagship_err, k4_ms, nuts_plain_ms, k4_err,
                                         k2_entry["ms"], k2_entry["plain_ms"], k2_entry["fold_ms"],
                                         k2_entry["before_ms"], k2_entry["before_fold_ms"],
                                         k3_entry["max_abs_err"], k3_entry["ms"], k3_entry["plain_ms"])),
          "non-finite result")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cookbooks"]:
        # [cookbook]'s process (cookbook_start): the card's, TF32 off as in the run
        if not torch.cuda.is_available():
            sys.exit(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        cookbook_child(torch.device("cuda"), sys.argv[2])
        sys.exit(0)
    sys.exit(main())
