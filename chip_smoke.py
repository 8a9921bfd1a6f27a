"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``genjax_tpu_torch/kernels/csrc``,
holds the kernel and its PRNG against their plain torch versions on the
card, drives the flagship column-HMC path (hierarchical regression, 65,536
chains) through the public entry point ``column_hmc``, checks that the path
launched the kernel and agrees in law with the plain twin, times both, and
prints one JSON line of kernel results and a last JSON line naming the
device. Any failed check exits non-zero; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

N_CHAINS = 65536
N_STEPS = 50
EPS = 0.02
L = 5
SEED = 0
BLOCK_N = 128  # chain block of the counter stream, as in the reference's tests
K1_TIMED_SWEEPS = 2000
TWIN_TIMED_SWEEPS = 5


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase(name: str, line: str) -> None:
    print(f"[{name}] {line}", flush=True)


def flagship_data():
    """``X`` and ``y`` of the reference's flagship benchmark setup."""
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return X, y


def numpy_q0(d: int, n: int, seed: int, tau_row: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q0 = (0.3 * rng.normal(size=(d, n))).astype(np.float32)
    if tau_row:
        q0[0] = rng.uniform(0.5, 1.5, size=n)
    return q0


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


def compare_counter(ld, body, q0_np, seed, eps, device, hmc):
    """The kernel and the plain twin on the counter stream from one ``q0``:
    ``(fraction within 1e-4, flipped chains, max abs err over agreeing
    chains, kernel accept rate, twin accept rate)``."""
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
    from genjax_tpu_torch.kernels import bodies, hmc
    from genjax_tpu_torch.kernels.model_interface import (
        ColumnPacker, column_hmc, column_logdensity, init_columns,
    )
    from genjax_tpu_torch.models import hierarchical_regression

    # ---- build
    t0 = time.perf_counter()
    hmc._lib()
    phase("build", f"K1 loaded from genjax_tpu_torch/kernels/csrc/hmc_sweep.cu "
                   f"in {time.perf_counter() - t0:.2f} s (build included)")

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

    # ---- K1 against its plain version on the counter stream
    X, y = flagship_data()
    model = hierarchical_regression(X)
    obs = g.C["y"].set(y)
    packer = ColumnPacker(model, obs, (), ["tau", "w"])
    ld = column_logdensity(model, obs, (), packer)
    check(ld.body is not None and ld.body.name == "hier_regression", "flagship density has no body")
    iid = bodies.iid_normal()
    cases = [
        ("iid_normal", iid, iid, numpy_q0(8, 4096, 11, False), 0.2),
        ("hier_regression", ld, ld.body, numpy_q0(16, 4096, 12, True), EPS),
        ("hier_regression", ld, ld.body, numpy_q0(16, N_CHAINS, 13, True), EPS),
    ]
    flagship_err = None
    for name, density, body, q0_np, eps in cases:
        frac, flipped, err, rate_k, rate_t = compare_counter(density, body, q0_np, 7, eps, device, hmc)
        phase("K1 vs plain", f"{name} {q0_np.shape}: {frac:.5f} of chains within 1e-4 "
                             f"({flipped} flipped MH decisions), max abs err {err:.3g} on the "
                             f"rest; accept {rate_k:.5f} vs {rate_t:.5f}")
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
    check(tuple(q.shape) == (16, N_CHAINS), f"positions have shape {tuple(q.shape)}")
    check(bool(torch.isfinite(q).all()), "main-path positions are not finite")
    phase("main path", f"column_hmc flagship {N_CHAINS} chains x {N_STEPS} steps on "
                       f"{hmc.pallas_hmc.last_backend}: {launches} kernel launch(es), accept "
                       f"{float(accept):.4f}, {main_s:.2f} s including init")

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

    # ---- timings at the main path's shape
    # windows of a few seconds each: 2000 K1 sweeps, 5 twin sweeps
    ms = cuda_ms(lambda: hmc.hmc_sweep(ld.body, q0, SEED, n_steps=N_STEPS, eps=EPS, L=L),
                 K1_TIMED_SWEEPS)
    plain_ms = cuda_ms(
        lambda: hmc._reference_hmc(ld, q0, SEED, n_steps=N_STEPS, eps=EPS, L=L), TWIN_TIMED_SWEEPS
    )
    samples = N_CHAINS * N_STEPS
    phase("timing", f"{smi}: K1 {ms:.4f} ms/sweep = {samples / ms * 1e3:.6g} samples/s "
                    f"(window {ms * K1_TIMED_SWEEPS / 1e3:.2f} s); plain twin {plain_ms:.2f} "
                    f"ms/sweep = {samples / plain_ms * 1e3:.6g} samples/s (window "
                    f"{plain_ms * TWIN_TIMED_SWEEPS / 1e3:.2f} s) ({N_CHAINS} chains x "
                    f"{N_STEPS} steps, L={L})")

    def wall_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    call_ms = wall_ms(lambda: column_hmc(
        model, obs, (), ["tau", "w"], n_chains=N_CHAINS, n_steps=N_STEPS, eps=EPS, L=L,
        seed=SEED, device="cuda",
    ))
    init_ms = wall_ms(lambda: init_columns(model, obs, (), packer, N_CHAINS, SEED, device))
    phase("where the time goes", f"column_hmc call {call_ms:.3f} ms (host clock, median of 3): "
                                 f"init_columns {init_ms:.3f} ms, K1 sweep {ms:.4f} ms, the rest "
                                 f"(packer, density closure, routing) "
                                 f"{call_ms - init_ms - ms:.3f} ms")

    print(json.dumps({"kernels": [{
        "name": "hmc_sweep (K1, with K2's counter PRNG as device functions)",
        "route": "cuda",
        "source": "genjax_tpu_torch/kernels/csrc/hmc_sweep.cu",
        "replaces": "genjax_tpu/kernels/hmc.py:93",
        "launches": launches,
        "max_abs_err": flagship_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    check(all(math.isfinite(v) for v in (ms, plain_ms, flagship_err)), "non-finite result")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
