"""Choose the staged K1's and K4's launch bounds on one CUDA card.

The staged flagship (the hierarchical regression's column density, staged by
``kernels/staged.py``) is built once for each candidate bound: copies of
``kernels/csrc`` under ``build/genjax_tpu_torch/bounds/<variant>/`` with
``hmc_sweep.cu``'s ``kStagedMinBlocks`` (K1: 128-thread blocks, at most
65536 / (128 * n) registers a thread) or ``nuts_sweep.cu``'s (K4: at most
65536 / (256 * n)) set to one value, one ``nvcc`` each, all started
together; the package's own sources are not touched. For each build the
script prints

- the ``-Xptxas -v`` report of both kernels (registers, spill stores and
  loads, stack frame) and the CUDA runtime's resident blocks an SM;
- the loads in the staged K1's SASS (``cuobjdump -sass``): shared (``LDS``),
  local (``LDL``) and constant-bank (``LDC``) loads, and the FFMAs whose
  operand is a constant-bank word;
- K1 and K4 against their plain versions on the counter stream (the share
  of chains within 1e-4, as ``chip_smoke.py`` gates them);
- K1 at the flagship's shape (65,536 chains x 50 steps, L = 5) and K4 (10
  transitions at depth 8 from a warmed-up state), each timed by CUDA events
  in turns with the hand-written flagship (hand, staged, staged, hand).

    python scripts/staged_launch_bounds.py [--k1 2 3 4] [--k4 1 2]

The first line is the card's name and power limit; the last is one JSON
object with every build's numbers.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

K1_DEFAULT_LINE = re.compile(r"constexpr int kStagedMinBlocks = \d+;")


def _helpers():
    """``chip_smoke.py`` of this checkout, for its data, bounds, timing and
    report parsers (it imports the package only inside its functions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variant(_build, header: str, k1: int, k4: int) -> tuple[Path, float]:
    """K1 and K4 with ``header`` and the two bounds, in a copy of the
    sources: the library's path and the build's seconds."""
    root = _build.BUILD_DIR / "bounds" / f"k1_{k1}_k4_{k4}"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    for src in _build.CSRC.glob("*.cu*"):
        shutil.copy(src, root / src.name)
    for name, value in (("hmc_sweep.cu", k1), ("nuts_sweep.cu", k4)):
        path = root / name
        text, n = K1_DEFAULT_LINE.subn(f"constexpr int kStagedMinBlocks = {value};", path.read_text())
        if n != 1:
            raise RuntimeError(f"{name} has {n} kStagedMinBlocks lines, not one")
        path.write_text(text)
    (root / "staged.cuh").write_text(header)
    so = root / "staged.so"
    t0 = time.perf_counter()
    _build._compile(so, [root / "hmc_sweep.cu", root / "nuts_sweep.cu"],
                    (f"-I{root}", "-DGJT_STAGED_HEADER=<staged.cuh>"))
    return so, time.perf_counter() - t0


def sass_loads(so: Path, nvcc: str, kernels: dict) -> dict:
    """Loads in the SASS of the kernels ``kernels`` (name -> a substring of
    the mangled name): counts of shared (LDS), local (LDL), constant (LDC,
    ULDC) and global (LDG) loads, and of FFMAs with an operand from the
    constant bank (``c[0x0][...]``) or a uniform register (``UR``)."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        head = block.split("\n", 1)[0]
        name = next((k for k, v in kernels.items() if v in head), None)
        if name is None:
            continue
        lines = [ln for ln in block.splitlines() if "/*" in ln and ";" in ln]
        count = lambda pat: sum(1 for ln in lines if re.search(pat, ln))  # noqa: E731
        out[name] = {"instructions": len(lines), "LDS": count(r"\bLDS"), "LDL": count(r"\bLDL"),
                     "STL": count(r"\bSTL"), "LDC": count(r"\bLDC"), "ULDC": count(r"\bULDC"),
                     "LDG": count(r"\bLDG"), "FFMA": count(r"\bFFMA\b"),
                     "FFMA_const_bank": count(r"\bFFMA\b.*c\[0x0\]"), "FFMA_uniform": count(r"\bFFMA\b.*\bUR\d")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k1", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--k4", type=int, nargs="+", default=[1, 2])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("staged_launch_bounds: needs a CUDA card", file=sys.stderr)
        return 1
    h = _helpers()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    import genjax_tpu_torch as g
    from genjax_tpu_torch.kernels import _build, bodies, hmc, nuts, nuts_pallas, staged
    from genjax_tpu_torch.kernels.model_interface import ColumnPacker, column_logdensity, init_columns
    from genjax_tpu_torch.models import hierarchical_regression

    dev = torch.device("cuda")
    X, y = h.flagship_data()
    model = hierarchical_regression(X)
    obs = g.C["y"].set(y)
    packer = ColumnPacker(model, obs, (), ["tau", "w"], device=dev)
    ld = column_logdensity(model, obs, (), packer)
    body = staged.stage_body(ld, 16, device=dev)
    hand = bodies.hier_regression(X, y, 0.25)
    print(f"staged flagship: {body}, constants {body.const_mode}, "
          f"{body.program.elements('log')} log and {body.program.elements('div', 'recip', 'rsqrt')} division "
          f"elements a gradient", flush=True)
    k1_default = int(K1_DEFAULT_LINE.search((_build.CSRC / "hmc_sweep.cu").read_text()).group(0).split()[-1][:-1])
    k4_default = int(K1_DEFAULT_LINE.search((_build.CSRC / "nuts_sweep.cu").read_text()).group(0).split()[-1][:-1])
    variants = [(a, k4_default) for a in args.k1] + [(k1_default, b) for b in args.k4 if b != k4_default]
    with ThreadPoolExecutor(len(variants) + 2) as pool:
        futs = {v: pool.submit(build_variant, _build, body.header, *v) for v in variants}
        hand_k1, hand_k4 = pool.submit(hmc._lib), pool.submit(nuts_pallas._lib)
        built = {v: f.result() for v, f in futs.items()}
        hand_k1.result(), hand_k4.result()

    # the flagship's NUTS state after its warmup (the hand-written K4's)
    q0_n = init_columns(model, obs, (), packer, h.N_CHAINS, h.SEED, dev)
    q_wn, eps_n, im_n = nuts_pallas.warmup_column_nuts(ld, q0_n, h.SEED, eps0=h.NUTS_EPS0, max_depth=h.NUTS_DEPTH)
    q0 = torch.from_numpy(h.numpy_q0(16, h.N_CHAINS, 13, True)).to(dev)
    q_cmp = torch.from_numpy(h.numpy_q0(16, 4096, 32, True)).to(dev)
    flop = min(h.hier_grad_flop(16, 8, 16), body.flop)
    b1, _ = h.k1_bound(h.N_CHAINS, 16, h.N_STEPS, h.L, flop, min(144, body.n_consts))
    hand_so = _build._so_path("hmc_sweep")
    print(f"hand-written K1 (hier_regression (16, 8) specialised) SASS: "
          f"{sass_loads(hand_so, _build._nvcc(), {'K1': 'hmc_sweep_kernelILi16ELi1ELi16ELi8E'})}", flush=True)
    results = {}
    for (k1, k4), (so, secs) in built.items():
        b = copy.copy(body)
        b._libs = {False: ctypes.CDLL(str(so))}
        report = so.with_suffix(".ptxas.txt").read_text()
        ptx = {("K1" if "hmc_sweep" in k else "K4"): {"registers": r, "spill_stores": st, "spill_loads": lo,
                                                      "stack": sf}
               for k, r, st, lo, _, sf in h.ptxas_kernels(report) if "sweep_kernel" in k}
        occ1 = hmc.kernel_info(b, 16)
        occ4 = nuts_pallas.kernel_info(b, 16, h.NUTS_DEPTH, nuts_pallas.DEFAULT_BLOCK)
        kw = dict(rng="counter", block_n=h.BLOCK_N)
        qk, acc = hmc.hmc_sweep(b, q_cmp, 7, n_steps=5, eps=h.EPS, L=h.L, **kw)
        qt, rate = hmc._reference_hmc(body, q_cmp, 7, n_steps=5, eps=h.EPS, L=h.L, **kw)
        frac1 = float(((qk - qt).abs().amax(dim=0) <= 1e-4).float().mean())
        qk, _, _ = nuts_pallas.nuts_sweep(b, q_cmp, 7, n_steps=3, eps=2.5 * h.EPS, max_depth=6, **kw)
        qt, _, _ = nuts.nuts_sweep_cols(body, q_cmp, 7, n_steps=3, eps=2.5 * h.EPS, max_depth=6, **kw)
        frac4 = float(((qk - qt).abs().amax(dim=0) <= 1e-4).float().mean())
        hand1, st1 = h.turns(lambda: hmc.hmc_sweep(hand, q0, h.SEED, n_steps=h.N_STEPS, eps=h.EPS, L=h.L),
                             lambda: hmc.hmc_sweep(b, q0, h.SEED, n_steps=h.N_STEPS, eps=h.EPS, L=h.L), 200, 200)
        nkw = dict(n_steps=h.NUTS_STEPS, eps=eps_n, max_depth=h.NUTS_DEPTH, inv_mass=im_n)
        hand4, st4 = h.turns(lambda: nuts_pallas.nuts_sweep(hand, q_wn, h.SEED, **nkw),
                             lambda: nuts_pallas.nuts_sweep(b, q_wn, h.SEED, **nkw), 20, 20)
        entry = {"build_s": secs, "ptxas": ptx, "K1_occupancy": occ1, "K4_occupancy": occ4,
                 "sass": sass_loads(so, _build._nvcc(), {"K1": "hmc_sweep_kernel", "K4": "nuts_sweep_kernel"}), "K1_within_1e-4": frac1, "K4_within_1e-4": frac4,
                 "K1_ms": st1, "K1_hand_written_ms": hand1, "K1_ratio": sum(st1) / sum(hand1),
                 "K1_share_of_bound": b1 / (sum(st1) / 2),
                 "K4_ms": st4, "K4_hand_written_ms": hand4, "K4_ratio": sum(st4) / sum(hand4)}
        results[f"k1_{k1}_k4_{k4}"] = entry
        print(f"[bounds] K1 kStagedMinBlocks {k1}, K4 {k4}: built in {secs:.1f} s; K1 {ptx.get('K1')}, "
              f"{occ1['blocks_per_sm']} blocks an SM; K4 {ptx.get('K4')}, {occ4['blocks_per_sm']} blocks an SM; "
              f"SASS {entry['sass']}; K1 {frac1:.5f} and K4 {frac4:.5f} of chains within 1e-4 of plain; "
              f"{smi}: K1 staged {st1[0]:.4f} and {st1[1]:.4f} ms against hand-written {hand1[0]:.4f} and "
              f"{hand1[1]:.4f} ms ({entry['K1_ratio']:.3f}x, {entry['K1_share_of_bound']:.4f} of the "
              f"{b1:.4f} ms bound); K4 staged {st4[0]:.4f} and {st4[1]:.4f} ms against {hand4[0]:.4f} and "
              f"{hand4[1]:.4f} ms ({entry['K4_ratio']:.3f}x)", flush=True)
    print(json.dumps({"device": smi, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
