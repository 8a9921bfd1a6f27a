"""K3's streams on one CUDA card: its keyed kernels checked and timed beside Philox.

Builds ``csrc/ess_gauss_sweep.cu`` (``kernels/_build.py``), prints each
kernel's ``-Xptxas -v`` line and the CUDA runtime's registers, spills and
blocks an SM for every stream at D = 256 (tiled) and D = 300 (generic), then:

- the keyed kernels (``rng="threefry"``, ``"rbg"``) through
  ``ess_sweep_gauss_cols`` against its plain version
  (``backend="torch"``), 3 steps, at the GP shape (D = 256 x 8,192, the
  GP path's data), a generic D, chain counts that are not a multiple of the
  block (1,000) or of four (1,001), and with ``collect=True`` (a launch a
  step): the share of chains within 1e-4 and the largest difference on them;
- the three streams' times at the GP shape (50 steps from the state after
  40 Philox sweeps), by CUDA events, in turns (philox, threefry, rbg, rbg,
  threefry, philox; 200 sweeps a window) at max_iters 24 and 64, and each
  keyed stream with max_iters 0 (no shrink) and with chol = 0 (no product:
  the draws, sums, shrink and updates).

    python scripts/k3_streams.py

The first line after the builds is the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402  (its data, timing and report parsers)
from genjax_tpu_torch.kernels import _build  # noqa: E402
from genjax_tpu_torch.kernels import elliptical as E  # noqa: E402

STEPS = 3
TOL = 1e-4


def compare(d: int, n: int, seed: int, rng_impl, device, collect: bool = False) -> str:
    rs = np.random.default_rng(d + n)
    if d == cs.GP_D:
        chol, y = cs.gp_data()
        prec = 1.0 / cs.GP_NOISE**2
    else:
        A = rs.normal(size=(d, d))
        chol = np.linalg.cholesky(A @ A.T / d + np.eye(d)).astype(np.float32)
        y = rs.normal(size=d).astype(np.float32)
        prec = 4.0
    q0 = torch.from_numpy(rs.normal(size=(d, n)).astype(np.float32)).to(device)
    kw = dict(n_steps=STEPS + collect, chol_prior=torch.as_tensor(chol, device=device),
              y=torch.as_tensor(y, device=device), prec=prec, rng_impl=rng_impl, collect=collect)
    E.ess_gauss_sweep_launches = 0
    qk, dk = E.ess_sweep_gauss_cols(q0, seed, **kw)
    launches, route = E.ess_gauss_sweep_launches, E.ess_sweep_gauss_cols.last_backend
    t0 = time.perf_counter()
    qt, dt = E.ess_sweep_gauss_cols(q0, seed, backend="torch", **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    a, b = (dk, dt) if collect else (qk, qt)
    err = (a - b).abs().reshape(-1, n).amax(dim=0)
    ok = err <= TOL
    return (f"({d}, {n}) seed {seed} rng_impl {rng_impl} collect {collect}: {route}, {launches} launches, "
            f"{E.ess_gauss_sweep.last_variant}: {float(ok.float().mean()):.5f} of chains within {TOL}, max abs "
            f"err {float(err[ok].max()) if bool(ok.any()) else float('inf'):.3g} on them, finite "
            f"{bool(torch.isfinite(a).all())}; plain {plain_s:.2f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_streams: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    E._lib()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for k in cs.ptxas_kernels(_build.ptxas_report("ess_gauss_sweep")):
        print("ptxas", k, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for rng in ("philox", "threefry", "rbg"):
        for d in (256, 300):
            print(f"kernel {E.geometry(d, rng)['kernel']} D={d}: {E.kernel_info(d, rng)}", flush=True)
    for impl in (None, "rbg"):
        for d, n in ((256, 8192), (300, 1024), (16, 1000), (16, 1001), (250, 640)):
            print("compare " + compare(d, n, 7, impl, device), flush=True)
        print("compare " + compare(16, 512, 2**31 - 1, impl, device, collect=True), flush=True)

    chol, y = cs.gp_data()
    chol_d = torch.as_tensor(chol, device=device)
    y_d, prec_d, mean_d = (torch.as_tensor(v, dtype=torch.float32, device=device)
                           for v in (y, np.full(cs.GP_D, 1.0 / cs.GP_NOISE**2), np.zeros(cs.GP_D)))
    q = torch.zeros(cs.GP_D, cs.GP_CHAINS, device=device)
    for s in range(cs.GP_SWEEPS):
        q = E.ess_sweep_gauss_pallas(q, s, n_steps=cs.GP_STEPS, chol_prior=chol_d, y=y_d, prec=prec_d, mean=mean_d)

    def sweep_ms(rng, max_iters, chol=chol_d):
        return cs.cuda_ms(lambda: E.ess_gauss_sweep(q, cs.GP_SWEEPS, n_steps=cs.GP_STEPS, chol=chol, y=y_d,
                                                    prec=prec_d, mean=mean_d, max_iters=max_iters, rng=rng), 200)

    for max_iters in (24, 64):
        row = [f"{rng} {sweep_ms(rng, max_iters):.4f}" for rng in ("philox", "threefry", "rbg", "rbg", "threefry",
                                                                    "philox")]
        print(f"timing max_iters {max_iters}: " + ", ".join(row) + " ms a sweep", flush=True)
    for rng in ("threefry", "rbg"):
        print(f"timing {rng}: max_iters 0 {sweep_ms(rng, 0):.4f} ms, chol = 0 "
              f"{sweep_ms(rng, 64, torch.zeros_like(chol_d)):.4f} ms", flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
