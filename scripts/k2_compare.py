"""Time K2's Philox stream and the three kernels that draw from it (K1, K4,
K3) in two checkouts of the port, on one CUDA card.

Two checkouts share a package name, so each run is a process of its own
with its checkout first on ``sys.path``; the checkouts take turns (A B B A
with ``--rounds 2``), so that a drift of the card's clock falls on both.
Each process builds its checkout's kernels (``kernels/_build.py``, into that
checkout's ``build/``), prints each kernel's registers, stack frame and
spills from its ``-Xptxas -v`` report and the SASS of K2 alone's hot loops,
and times at the flagship's and the GP path's shapes, by CUDA events:

- K1: ``hmc_sweep``, 65,536 chains x 50 steps, L = 5, eps 0.02;
- K4: ``nuts_sweep``, 10 transitions at depth 8 from a warmed-up state;
- K3: ``ess_gauss_sweep``, D = 256 x 8,192 chains x 50 steps from a state
  after 40 sweeps;
- K2 alone (``csrc/k2_stream.cu``): one flagship K1 sweep's Philox numbers
  written out and folded into one store a chain, and, where the checkout
  has it, the Philox variant from before K2's redesign (``rng = 2``);
- ``torch.randn`` + ``torch.rand`` of the same counts.

The warmed-up states (K4's positions, step size and inverse mass, K3's
positions) are made once, by the first process, and read by the others, so
both checkouts start from the same numbers.

Each process also stages, with its checkout's ``kernels/staged.py``, two
column densities that take no chain operands (the flagship's
``hierarchical_regression`` over ``["tau", "w"]`` and the conjugate normal
model over ``["mu"]``) and builds their K1 and K4 beside the sources. The
script then compares the two checkouts' ``-Xptxas -v`` reports of every
build, entry function by entry function (each kernel's registers, spills,
stack frame, barriers, shared, constant and global memory), leaving out
what does not come from the kernels: the compile times, and the tag of the
anonymous namespace in the mangled names, which nvcc derives from the
source file. Every kernel of the first checkout must have the same report
in the second; kernels the second adds are listed with theirs.

    python scripts/k2_compare.py [--rounds 2] PARENT_ROOT CHANGE_ROOT
    python scripts/k2_compare.py --ptxas PARENT_ROOT CHANGE_ROOT

The first line is the card's name and power limit; the last lines give each
number's runs in each checkout and the ratio of their means. Each build's
reports are ``equal`` or ``DIFFERENT`` (with the lines that differ), and one
JSON line ``{"equal": {build: bool}}`` follows. ``--ptxas`` builds each
checkout once, times nothing, and exits 1 where a report differs.
"""

from __future__ import annotations

import argparse
import difflib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
K1_SWEEPS = 1000
K4_SWEEPS = 1000
K3_SWEEPS = 600
K2_LAUNCHES = 200
GP_WARM_SWEEPS = 40


def _helpers():
    """``chip_smoke.py`` of this checkout, for its data, timing and report
    parsers (it imports the package only inside its functions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SOURCES = ("hmc_sweep", "nuts_sweep", "ess_gauss_sweep", "k2_stream")


def child(root: str, state_path: str, ptxas_only: bool) -> None:
    sys.path.insert(0, root)
    import ctypes

    import numpy as np
    import torch

    cs = _helpers()
    import genjax_tpu_torch as g
    from genjax_tpu_torch.kernels import _build, elliptical, hmc, nuts_pallas, staged
    from genjax_tpu_torch.kernels.model_interface import ColumnPacker, column_logdensity, init_columns
    from genjax_tpu_torch.models import hierarchical_regression

    @g.gen
    def conjugate():
        mu = g.normal(0.0, 1.0) @ "mu"
        g.normal(mu, 1.0) @ "y"

    device = torch.device("cuda")
    X, y = cs.flagship_data()
    model = hierarchical_regression(X)
    obs = g.C["y"].set(y)
    packer = ColumnPacker(model, obs, (), ["tau", "w"])
    ld = column_logdensity(model, obs, (), packer)
    # the staged builds without chain operands, staged by this checkout
    bodies = {"staged flagship": staged.stage_body(ld, packer.padded_dim)}
    conj_obs = g.C["y"].set(2.0)
    conj_packer = ColumnPacker(conjugate, conj_obs, (), ["mu"])
    bodies["staged conjugate"] = staged.stage_body(column_logdensity(conjugate, conj_obs, (), conj_packer),
                                                   conj_packer.padded_dim)
    with ThreadPoolExecutor(6) as pool:
        list(pool.map(lambda f: f(), (hmc._lib, nuts_pallas._lib, elliptical._lib,
                                      lambda: _build.load("k2_stream"), *(b.lib for b in bodies.values()))))
    out = {"root": root, "ptxas": {}, "ms": {},
           "reports": {source: _build.ptxas_report(source) for source in SOURCES}}
    out["reports"].update({name: _build.staged_ptxas_report(b.header) for name, b in bodies.items()})
    for source in SOURCES:
        out["ptxas"][source] = cs.ptxas_kernels(out["reports"][source])
    if ptxas_only:
        print("RESULT " + json.dumps(out), flush=True)
        return
    q0 = init_columns(model, obs, (), packer, cs.N_CHAINS, cs.SEED, device)
    chol, y_gp = cs.gp_data()
    chol_d = torch.as_tensor(chol, device=device)
    y_d, prec_d, mean_d = (torch.as_tensor(v, dtype=torch.float32, device=device)
                           for v in (y_gp, np.full(cs.GP_D, 1.0 / cs.GP_NOISE**2), np.zeros(cs.GP_D)))
    state = Path(state_path)
    if not state.exists():
        q4, eps4, im4 = nuts_pallas.warmup_column_nuts(ld, q0, cs.SEED, eps0=cs.NUTS_EPS0,
                                                       max_depth=cs.NUTS_DEPTH)
        q3 = torch.zeros(cs.GP_D, cs.GP_CHAINS, device=device)
        for s in range(GP_WARM_SWEEPS):
            q3 = elliptical.ess_sweep_gauss_pallas(q3, cs.SEED + s, n_steps=cs.GP_STEPS, chol_prior=chol_d,
                                                   y=y_d, prec=prec_d, mean=mean_d)
        torch.save({"q4": q4.cpu(), "eps4": float(eps4), "im4": torch.as_tensor(im4).cpu(),
                    "q3": q3.cpu()}, state)
    st = torch.load(state)
    q4, eps4, im4, q3 = st["q4"].to(device), st["eps4"], st["im4"].to(device), st["q3"].to(device)

    def windows(fn, reps):
        return [cs.cuda_ms(fn, reps) for _ in range(2)]

    out["ms"]["K1"] = windows(lambda: hmc.hmc_sweep(ld.body, q0, cs.SEED, n_steps=cs.N_STEPS, eps=cs.EPS,
                                                    L=cs.L), K1_SWEEPS)

    def k4():
        return nuts_pallas.nuts_sweep(ld.body, q4, cs.SEED, n_steps=cs.NUTS_STEPS, eps=eps4,
                                      max_depth=cs.NUTS_DEPTH, inv_mass=im4)

    out["ms"]["K4"] = windows(k4, K4_SWEEPS)
    out["K4_leapfrogs"] = float(k4()[2].mean()) / cs.NUTS_STEPS
    out["ms"]["K3"] = windows(lambda: elliptical.ess_gauss_sweep(
        q3, cs.SEED + GP_WARM_SWEEPS, n_steps=cs.GP_STEPS, chol=chol_d, y=y_d, prec=prec_d, mean=mean_d),
        K3_SWEEPS)

    lib = _build.load("k2_stream")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k2_stream.argtypes = [P, P, I, I, I, I, I, I, P]
    lib.k2_stream.restype = I
    D, n, steps = lib.k2_stream_dim(), cs.N_CHAINS, cs.N_STEPS
    normals, uniforms = torch.empty((steps, D, n), device=device), torch.empty((steps, n), device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def k2(rng, fold):
        return lib.k2_stream(normals.data_ptr(), uniforms.data_ptr(), n, steps, cs.SEED, rng, fold,
                             cs.BLOCK_N, stream)

    for rng, name in ((1, "K2"), (2, "K2_before")):
        if k2(rng, 0) != 0:  # a checkout without the variant refuses it
            continue
        out["ms"][name] = windows(lambda: k2(rng, 0), K2_LAUNCHES)
        out["ms"][name + "_fold"] = windows(lambda: k2(rng, 1), K2_LAUNCHES)
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    out["ms"]["randn+rand"] = windows(lambda: (torch.randn(steps * D * n, generator=gen, device=device),
                                               torch.rand(steps * n, generator=gen, device=device)), 50)
    out["k2_sass"] = {name: c["loop"] for name, c in cs.sass_loops(cs.sass_of(lib)).items()
                      if "k2_stream_kernel" in name and "Lb1E" in name}
    print("RESULT " + json.dumps(out), flush=True)


def normalised(report: str) -> list[str]:
    """A ``-Xptxas -v`` report's lines without compile times, the anonymous
    namespace's tag blanked."""
    return [re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__*_", line) for line in report.splitlines()
            if "Compile time" not in line]


def entries(report: str) -> dict:
    """A normalised ``-Xptxas -v`` report cut into its entry functions: the
    mangled name of each and its lines (the properties, registers, spills
    and memory), and under ``""`` the lines before the first."""
    out, name = {"": []}, ""
    for line in normalised(report):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = []
        out[name].append(line)
    return out


def compare_reports(a: dict, b: dict, names: tuple[str, str]) -> bool:
    """Print whether each build's kernels of the first checkout have equal
    reports in the second (each entry function's lines, in any order), the
    lines that differ, the entry functions the second adds, and the module's
    own lines where they differ; return whether every kernel's are equal."""
    equal = {}
    for name in a:
        ea, eb = entries(a[name]), entries(b.get(name, ""))
        differ = [k for k in ea if k and ea[k] != eb.get(k)]
        added = [k for k in eb if k not in ea]
        equal[name] = not differ
        print(f"[ptxas] {name}: {len(ea) - 1} kernels, reports {'equal' if equal[name] else 'DIFFERENT'} "
              f"({names[0]} against {names[1]}); {len(added)} kernels added in {names[1]}")
        if ea[""] != eb[""]:  # the module's own lines (its global and constant memory)
            print(f"[ptxas] {name}: the module's lines before its first kernel: {ea['']} against {eb['']}")
        for k in differ:
            print("\n".join(list(difflib.unified_diff(ea[k], eb.get(k, []), lineterm="", n=0))[:30]))
        for k in added:
            print(f"[ptxas] {name}: added {k}: " + "; ".join(x.split(":", 1)[-1].strip() for x in eb[k][1:]))
    print(json.dumps({"equal": equal}), flush=True)
    return all(equal.values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs=2)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ptxas", action="store_true", help="build each checkout once and compare the reports")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--state", default=str(HERE / "build" / "k2_compare_state.pt"))
    args = ap.parse_args()
    if args.child:
        child(args.roots[0], args.state, args.ptxas)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    Path(args.state).parent.mkdir(parents=True, exist_ok=True)
    Path(args.state).unlink(missing_ok=True)
    order = []
    for r in range(1 if args.ptxas else args.rounds):
        order += [0, 1] if r % 2 == 0 else [1, 0]
    results = {0: [], 1: []}
    for idx in order:
        root = args.roots[idx]
        proc = subprocess.run([sys.executable, __file__, "--child", "--state", args.state, root, root]
                              + (["--ptxas"] if args.ptxas else []), capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.split("RESULT ", 1)[1].splitlines()[0])
        results[idx].append(res)
        if not args.ptxas:
            print(f"{root}: " + ", ".join(f"{k} {statistics.mean(v):.4f}" for k, v in res["ms"].items())
                  + f" ms; K4 leapfrogs a transition {res['K4_leapfrogs']:.4f}", flush=True)
    Path(args.state).unlink(missing_ok=True)
    names = tuple(Path(r).resolve().name for r in args.roots)
    same = compare_reports(results[0][0]["reports"], results[1][0]["reports"], names)
    if args.ptxas:
        return 0 if same else 1
    for idx in (0, 1):
        first = results[idx][0]
        for source, rows in first["ptxas"].items():
            for name, regs, stores, loads, smem, stack in rows:
                print(f"{args.roots[idx]} {source}.cu {name}: {regs} registers, stack frame {stack} B, "
                      f"spill stores {stores} B, spill loads {loads} B")
        for name, loop in first["k2_sass"].items():
            print(f"{args.roots[idx]} SASS {name} hot loop: " + ", ".join(f"{k} {v}" for k, v in loop.items()))
    for key in results[1][0]["ms"]:
        runs = [[t for res in results[idx] for t in res["ms"].get(key, [])] for idx in (0, 1)]
        line = f"{key}: " + "; ".join(
            f"{args.roots[idx]} {min(r):.4f}-{max(r):.4f} ms (mean {statistics.mean(r):.4f}, {len(r)} windows)"
            for idx, r in enumerate(runs) if r)
        if all(runs):
            line += f"; change / parent {statistics.mean(runs[1]) / statistics.mean(runs[0]):.4f}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
