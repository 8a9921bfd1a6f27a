"""The PyTorch port's package boundary and layer order.

``genjax_tpu_torch`` must import without JAX (it runs on a CUDA machine that
has none), must never name ``jax`` or ``genjax_tpu`` in an import, and its
imports, function-level ones included, must point down its layer order
without cycles, as ``tests/test_layering.py`` enforces for the JAX package.
"""

import ast
import os
import subprocess
import sys
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "genjax_tpu_torch"
PKG_ROOT = os.path.join(REPO, PKG)

LAYERS = {
    "core": 0,
    "io": 1,
    "generative": 2,
    "lang": 3,
    "dists": 3,
    "combinators": 4,
    "adev": 4,
    "models": 5,
    # below parallel, as in the reference (kernels 5, parallel 6): the
    # scale-out layer's MCMC reaches the adaptation kernels
    "kernels": 5.5,
    "parallel": 6,
    "inference": 7,
    "debug": 8,
    "<root>": 9,
    "interop": 9,
    "checkify": 9,
    "typecheck": 9,
    "time_travel": 9,
    "typing": 9,
    "pretty": 9,
    "incremental": 9,
    "experimental": 9,
    # the narratives use the whole package; nothing imports them
    "cookbook": 10,
}


# The one import that points up the layer order, as in the reference: the
# sharded MCMC runners reach ``inference.mcmc`` from inside their functions
# (``genjax_tpu/parallel/mcmc.py``). It is left out of the graph only where
# it stands inside a function; anywhere else it is an edge like any other.
FUNCTION_LEVEL_EXCEPTIONS = {(f"{PKG}.parallel.mcmc", f"{PKG}.inference.mcmc")}


def _module_name(path):
    parts = os.path.relpath(path, REPO)[: -len(".py")].split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _subpackage(modname):
    parts = modname.split(".")
    return "<root>" if len(parts) == 1 else parts[1]


def _iter_py_files():
    for root, dirs, files in os.walk(PKG_ROOT):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path, modname, *, with_scope=False):
    """Absolute module names imported anywhere in ``path``, function-level
    imports included, so a deferred import cannot hide an upward edge; with
    ``with_scope``, pairs ``(name, inside_a_function)``."""
    tree = ast.parse(open(path).read(), filename=path)
    parts = modname.split(".")
    base_pkg = parts if os.path.basename(path) == "__init__.py" else parts[:-1]
    in_function = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            in_function.update(id(n) for n in ast.walk(fn) if n is not fn)

    def out(name, node):
        return (name, id(node) in in_function) if with_scope else name

    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.level > 0:
                base = base_pkg[: len(base_pkg) - (node.level - 1)]
                target = base + (node.module.split(".") if node.module else [])
                yield out(".".join(target), node)
                if node.module is None:
                    for alias in node.names:
                        yield out(".".join(target + [alias.name]), node)
            elif node.module:
                yield out(node.module, node)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                yield out(alias.name, node)


def _graph():
    mods = {_module_name(p): p for p in _iter_py_files()}
    edges = defaultdict(set)
    for mod, path in mods.items():
        for target, lazy in _imports(path, mod, with_scope=True):
            if target.split(".")[0] != PKG:
                continue
            while target and target not in mods:
                target = ".".join(target.split(".")[:-1])
            if not target or target == mod or mod.startswith(target + "."):
                continue
            if lazy and (mod, target) in FUNCTION_LEVEL_EXCEPTIONS:
                continue
            edges[mod].add(target)
            anc = target.split(".")
            while len(anc) > 1:
                anc = anc[:-1]
                pkg = ".".join(anc)
                if pkg in mods and pkg != mod and not mod.startswith(pkg + "."):
                    edges[mod].add(pkg)
    return mods, edges


def test_imports_without_jax():
    code = (
        "import sys, genjax_tpu_torch, genjax_tpu_torch.kernels, "
        "genjax_tpu_torch.kernels.elliptical, genjax_tpu_torch.models, "
        "genjax_tpu_torch.models.gp, genjax_tpu_torch.interop, "
        "genjax_tpu_torch.inference.mcmc, genjax_tpu_torch.inference.requests.hmc, "
        "genjax_tpu_torch.inference.requests.nuts, genjax_tpu_torch.inference.sample, "
        "genjax_tpu_torch.inference.diagnostics, genjax_tpu_torch.inference.adaptation, "
        "genjax_tpu_torch.kernels.chees, genjax_tpu_torch.kernels.pt, "
        "genjax_tpu_torch.kernels.dense_mass, genjax_tpu_torch.kernels.svgd, "
        "genjax_tpu_torch.kernels.sgld, genjax_tpu_torch.core.staging, "
        "genjax_tpu_torch.combinators, genjax_tpu_torch.combinators.vmap, "
        "genjax_tpu_torch.combinators.scan, genjax_tpu_torch.combinators.switch, "
        "genjax_tpu_torch.combinators.mask_comb, genjax_tpu_torch.combinators.dimap, "
        "genjax_tpu_torch.combinators.repeat, genjax_tpu_torch.combinators.or_else, "
        "genjax_tpu_torch.combinators.mixture, genjax_tpu_torch.models.ssm, "
        "genjax_tpu_torch.parallel, genjax_tpu_torch.parallel.resampling, "
        "genjax_tpu_torch.parallel.smc, genjax_tpu_torch.inference.sp, "
        "genjax_tpu_torch.inference.smc, genjax_tpu_torch.inference.tempered, "
        "genjax_tpu_torch.inference.requests.mala, genjax_tpu_torch.inference.requests.rejuvenate, "
        "genjax_tpu_torch.dists.lgssm, genjax_tpu_torch.models.mixture, "
        "genjax_tpu_torch.core.scan, genjax_tpu_torch.dists.discrete_hmm, genjax_tpu_torch.dists.hmm_tools, "
        "genjax_tpu_torch.models.hmm, genjax_tpu_torch.models.ppca, genjax_tpu_torch.models.bnn, "
        "genjax_tpu_torch.inference.exact_testbed, genjax_tpu_torch.inference.enumerate_, "
        "genjax_tpu_torch.inference.gibbs, genjax_tpu_torch.inference.pgibbs, "
        "genjax_tpu_torch.inference.requests.elliptical, genjax_tpu_torch.inference.requests.slice_, "
        "genjax_tpu_torch.inference.involutive, genjax_tpu_torch.inference.predictive, "
        "genjax_tpu_torch.inference.sbc, genjax_tpu_torch.inference.model_comparison, "
        "genjax_tpu_torch.inference.abc, genjax_tpu_torch.inference.smc2, genjax_tpu_torch.inference.smc_chees, "
        "genjax_tpu_torch.inference.nested, genjax_tpu_torch.inference._lbfgs, "
        "genjax_tpu_torch.inference.pathfinder, genjax_tpu_torch.io, genjax_tpu_torch.io.checkpoint, "
        "genjax_tpu_torch.core.changes, genjax_tpu_torch.debug, genjax_tpu_torch.checkify, "
        "genjax_tpu_torch.typecheck, genjax_tpu_torch.time_travel, genjax_tpu_torch.pretty, "
        "genjax_tpu_torch.typing, genjax_tpu_torch.incremental, genjax_tpu_torch.experimental, "
        "genjax_tpu_torch.parallel.mesh, genjax_tpu_torch.parallel.mcmc, genjax_tpu_torch.parallel.islands, "
        "genjax_tpu_torch.parallel.data, genjax_tpu_torch.parallel.tensor_parallel, "
        "genjax_tpu_torch.parallel.rbpf, genjax_tpu_torch.parallel.audit, genjax_tpu_torch.kernels.rows, "
        "genjax_tpu_torch.cookbook, genjax_tpu_torch.cookbook._common; "
        "import importlib; from genjax_tpu_torch.cookbook import COOKBOOKS; "
        "[importlib.import_module('genjax_tpu_torch.cookbook.' + n) for n in COOKBOOKS]; "
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'genjax_tpu' or m.startswith('genjax_tpu.') or m.split('.')[0] in ('optax', 'orbax', 'treescope', 'typeguard', 'jaxtyping')))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_no_jax_import_anywhere():
    bad = []
    for path in _iter_py_files():
        for target in _imports(path, _module_name(path)):
            if target.split(".")[0] in ("jax", "jaxlib", "genjax_tpu", "optax", "orbax", "treescope", "typeguard", "jaxtyping"):
                bad.append(f"{os.path.relpath(path, REPO)} imports {target}")
    assert not bad, "\n".join(bad)


def test_gp_and_elliptical_modules_are_layered():
    """The GP model sits at layer 4 and reaches no kernel module; the
    elliptical sampler sits at layer 5, above it."""
    mods, edges = _graph()
    for mod in (f"{PKG}.models.gp", f"{PKG}.kernels.elliptical", f"{PKG}.dists.catalog"):
        assert mod in mods, mod
    assert not [t for t in edges[f"{PKG}.models.gp"] if _subpackage(t) == "kernels"]
    assert f"{PKG}.kernels.hmc" in edges[f"{PKG}.kernels.elliptical"]


def test_inference_sits_above_kernels_lang_and_dists():
    """The trace path's runners reach the column kernels' routing
    (``run_chains_hmc`` through ``pallas_hmc``, ``run_chains_nuts`` through
    ``pallas_nuts``), the NUTS request its transition in ``kernels.nuts``,
    the driver ``sample`` the runners' shared launch in ``mcmc``, and
    nothing below reaches up into them."""
    mods, edges = _graph()
    for mod in (f"{PKG}.inference.mcmc", f"{PKG}.inference.requests.hmc",
                f"{PKG}.inference.requests.grad_view", f"{PKG}.core.diff",
                f"{PKG}.inference.requests.nuts", f"{PKG}.inference.sample",
                f"{PKG}.inference.diagnostics", f"{PKG}.inference.adaptation"):
        assert mod in mods, mod
    assert f"{PKG}.kernels.hmc" in edges[f"{PKG}.inference.mcmc"]
    assert f"{PKG}.kernels.nuts_pallas" in edges[f"{PKG}.inference.mcmc"]
    assert f"{PKG}.kernels.nuts" in edges[f"{PKG}.inference.requests.nuts"]
    assert f"{PKG}.inference.mcmc" in edges[f"{PKG}.inference.sample"]
    for sub in ("kernels", "lang", "dists", "generative", "core", "models"):
        assert LAYERS["inference"] > LAYERS[sub]
    below = [m for m in mods if _subpackage(m) not in ("inference", "<root>", "interop", "cookbook")]
    assert not [f"{m} -> {t}" for m in below for t in edges[m] if _subpackage(t) == "inference"]


def test_column_samplers_sit_below_inference():
    """The column samplers (ChEES, parallel tempering, the dense metric,
    SVGD, SG-MCMC) are kernel modules: the model bridge and the driver reach
    down to them, and they reach nothing in ``inference``."""
    mods, edges = _graph()
    samplers = [f"{PKG}.kernels.{m}" for m in ("chees", "pt", "dense_mass", "svgd", "sgld")]
    for mod in samplers:
        assert mod in mods, mod
        assert not [t for t in edges[mod] if _subpackage(t) in ("inference", "<root>", "interop")], mod
    for mod in samplers[:4]:
        assert mod in edges[f"{PKG}.kernels.model_interface"], mod
    for mod in (f"{PKG}.kernels.chees", f"{PKG}.kernels.pt", f"{PKG}.kernels.dense_mass"):
        assert mod in edges[f"{PKG}.inference.sample"], mod
    assert LAYERS["kernels"] < LAYERS["inference"]


def test_combinators_sit_between_the_language_and_the_models():
    """The combinators build on ``generative``, ``lang`` and ``dists`` and
    nothing above; ``generative/gfi.py``'s postfix methods reach them only
    through the constructor table that ``combinators/__init__.py`` fills."""
    mods, edges = _graph()
    for mod in ("vmap", "scan", "switch", "mask_comb", "dimap", "repeat", "or_else", "mixture"):
        mod = f"{PKG}.combinators.{mod}"
        assert mod in mods, mod
        assert not [t for t in edges[mod] if _subpackage(t) not in ("core", "generative", "lang",
                                                                   "dists", "combinators")], mod
    assert f"{PKG}.lang.static_lang" in edges[f"{PKG}.combinators.mixture"]
    assert f"{PKG}.generative.gfi" in edges[f"{PKG}.combinators"]
    assert not [t for t in edges[f"{PKG}.generative.gfi"] if _subpackage(t) == "combinators"]
    assert LAYERS["lang"] < LAYERS["combinators"] < LAYERS["models"]
    assert LAYERS["dists"] < LAYERS["combinators"]


def test_kernels_and_parallel_never_import_inference():
    """The reference's rule (``tests/test_layering.py``): nothing under
    ``kernels/`` or ``parallel/`` imports ``inference/``, but for the one
    named exception, ``parallel.mcmc -> inference.mcmc`` inside functions
    (``FUNCTION_LEVEL_EXCEPTIONS``)."""
    _, edges = _graph()
    bad = [
        f"{src} -> {dst}"
        for src, targets in edges.items()
        if _subpackage(src) in ("kernels", "parallel")
        for dst in targets
        if _subpackage(dst) == "inference"
    ]
    assert not bad, "\n".join(bad)


def test_smc_modules_are_layered():
    """SMC and GenSP: the particle filter and the resamplers sit in
    ``parallel`` (layer 6) on the GFI below them; ``inference.smc`` and
    ``inference.tempered`` reach down to them; the Kalman oracle and the
    mixture models sit with the distributions and the models."""
    mods, edges = _graph()
    for mod in ("parallel.resampling", "parallel.smc", "inference.sp", "inference.smc",
                "inference.tempered", "inference.requests.mala", "inference.requests.rejuvenate",
                "dists.lgssm", "models.mixture"):
        assert f"{PKG}.{mod}" in mods, mod
    assert f"{PKG}.parallel.resampling" in edges[f"{PKG}.parallel.smc"]
    assert f"{PKG}.parallel.resampling" in edges[f"{PKG}.inference.smc"]
    assert f"{PKG}.parallel.smc" in edges[f"{PKG}.inference.tempered"]
    assert f"{PKG}.parallel.resampling" in edges[f"{PKG}.inference.tempered"]
    assert f"{PKG}.inference.requests.grad_view" in edges[f"{PKG}.inference.requests.mala"]
    for mod in ("parallel.resampling", "parallel.smc"):
        assert not [t for t in edges[f"{PKG}.{mod}"]
                    if _subpackage(t) not in ("core", "generative", "dists", "parallel")], mod
    assert not [t for t in edges[f"{PKG}.dists.lgssm"] if _subpackage(t) not in ("core", "generative", "dists")]
    assert LAYERS["models"] < LAYERS["parallel"] < LAYERS["inference"]


def test_slice13_modules_are_layered():
    """The discrete and trace-level families: the one associative scan sits
    in ``core`` and serves both the Kalman family and the HMM tools; the HMM
    distributions sit with the distributions, on ``core`` and ``generative``
    alone; the models reach no kernel or inference module; the inference
    modules reach down to the GFI, the models, the resamplers and the
    gradient view."""
    mods, edges = _graph()
    slice13 = ["core.scan", "dists.discrete_hmm", "dists.hmm_tools", "models.hmm", "models.ppca", "models.bnn",
               "inference.exact_testbed", "inference.enumerate_", "inference.gibbs", "inference.pgibbs",
               "inference.requests.elliptical", "inference.requests.slice_", "inference.involutive",
               "inference.predictive", "inference.sbc"]
    for mod in slice13:
        assert f"{PKG}.{mod}" in mods, mod
    assert f"{PKG}.core.scan" in edges[f"{PKG}.dists.lgssm"]
    assert f"{PKG}.core.scan" in edges[f"{PKG}.dists.hmm_tools"]
    for mod in ("dists.discrete_hmm", "dists.hmm_tools"):
        assert not [t for t in edges[f"{PKG}.{mod}"] if _subpackage(t) not in ("core", "generative", "dists")], mod
    for mod in ("models.hmm", "models.ppca", "models.bnn"):
        assert not [t for t in edges[f"{PKG}.{mod}"] if _subpackage(t) in ("kernels", "inference", "parallel")], mod
    assert f"{PKG}.models.hmm" in edges[f"{PKG}.inference.exact_testbed"]
    assert f"{PKG}.parallel.resampling" in edges[f"{PKG}.inference.pgibbs"]
    assert f"{PKG}.inference.requests.grad_view" in edges[f"{PKG}.inference.involutive"]
    assert f"{PKG}.inference.requests.grad_view" in edges[f"{PKG}.inference.requests.elliptical"]
    assert f"{PKG}.inference.requests.grad_view" in edges[f"{PKG}.inference.requests.slice_"]
    assert f"{PKG}.inference.sample" in edges[f"{PKG}.inference.predictive"]


def test_slice14_modules_are_layered():
    """The population and column-density algorithms sit in ``inference`` on
    the column bridge, the resamplers and the adaptation kernels; Pathfinder
    reaches its own L-BFGS and the PSIS of ``model_comparison``; the
    checkpoint layer sits low, on torch alone, and the driver reaches it."""
    mods, edges = _graph()
    slice14 = ["inference.model_comparison", "inference.abc", "inference.smc2", "inference.smc_chees",
               "inference.nested", "inference._lbfgs", "inference.pathfinder", "io", "io.checkpoint"]
    for mod in slice14:
        assert f"{PKG}.{mod}" in mods, mod
    assert f"{PKG}.inference._lbfgs" in edges[f"{PKG}.inference.pathfinder"]
    assert f"{PKG}.inference.model_comparison" in edges[f"{PKG}.inference.pathfinder"]
    assert f"{PKG}.kernels.model_interface" in edges[f"{PKG}.inference.abc"]
    assert f"{PKG}.parallel.resampling" in edges[f"{PKG}.inference.abc"]
    assert f"{PKG}.parallel.resampling" in edges[f"{PKG}.inference.smc2"]
    assert f"{PKG}.kernels.adaptation" in edges[f"{PKG}.inference.smc_chees"]
    assert f"{PKG}.kernels.chees" in edges[f"{PKG}.inference.smc_chees"]
    assert f"{PKG}.kernels.model_interface" in edges[f"{PKG}.inference.nested"]
    assert f"{PKG}.io" in edges[f"{PKG}.inference.sample"]
    assert not edges[f"{PKG}.inference._lbfgs"] and not edges[f"{PKG}.inference.model_comparison"] - {
        f"{PKG}.core.pytree", f"{PKG}.core"}
    assert not [t for t in edges[f"{PKG}.io.checkpoint"]]
    assert LAYERS["io"] < LAYERS["inference"]


def test_slice15_modules_are_layered():
    """The change propagation, the named effects, the environment and the
    checks sit in ``core`` on nothing above it; the language reaches the
    propagation and the checks; the debugger sits above ``inference`` on
    the named effects; the facades re-export from below."""
    mods, edges = _graph()
    for mod in ("core.changes", "core.primitive", "core.environment", "core.checkify", "generative.typecheck",
                "debug", "debug.time_travel", "checkify", "typecheck", "time_travel", "typing", "pretty",
                "incremental", "experimental"):
        assert f"{PKG}.{mod}" in mods, mod
    for mod in ("core.changes", "core.primitive", "core.environment", "core.checkify"):
        assert not [t for t in edges[f"{PKG}.{mod}"] if _subpackage(t) != "core"], mod
    assert f"{PKG}.core.changes" in edges[f"{PKG}.lang.static_lang"]
    assert f"{PKG}.core.changes" in edges[f"{PKG}.combinators.dimap"]
    assert f"{PKG}.core.checkify" in edges[f"{PKG}.generative.mask"]
    assert f"{PKG}.core.primitive" in edges[f"{PKG}.debug.time_travel"]
    assert f"{PKG}.debug.time_travel" in edges[f"{PKG}.time_travel"]
    assert LAYERS["inference"] < LAYERS["debug"] < LAYERS["<root>"]


def test_slice16_scale_out_layer_is_layered():
    """The scale-out layer sits in ``parallel`` (layer 6): the collectives
    in ``_comm`` on torch alone, the mesh on ``core``, the drivers on the
    resamplers, the GFI and, for the sharded MCMC, the adaptation kernels;
    ``inference.sample`` and ``inference.smc2`` reach down to it. Its one
    import from ``inference`` is ``parallel.mcmc``'s of ``inference.mcmc``,
    and it stands inside functions only."""
    mods, edges = _graph()
    new = ["parallel._comm", "parallel.mesh", "parallel.rbpf", "parallel.data", "parallel.tensor_parallel",
           "parallel.islands", "parallel.mcmc", "parallel.audit"]
    for mod in new:
        assert f"{PKG}.{mod}" in mods, mod
        assert not [t for t in edges[f"{PKG}.{mod}"]
                    if _subpackage(t) not in ("core", "io", "generative", "dists", "kernels", "parallel")], mod
    assert not edges[f"{PKG}.parallel._comm"]
    assert f"{PKG}.parallel._comm" in edges[f"{PKG}.parallel.resampling"]
    assert f"{PKG}.kernels.adaptation" in edges[f"{PKG}.parallel.mcmc"]
    assert f"{PKG}.dists.lgssm" in edges[f"{PKG}.parallel.rbpf"]
    assert f"{PKG}.parallel.mesh" in edges[f"{PKG}.inference.sample"]
    assert f"{PKG}.parallel.resampling" in edges[f"{PKG}.inference.smc2"]
    assert not [t for t in edges[f"{PKG}.kernels.adaptation"] if _subpackage(t) == "parallel"]
    scoped = {}
    for mod, path in mods.items():
        if _subpackage(mod) != "parallel":
            continue
        for target, lazy in _imports(path, mod, with_scope=True):
            if target.startswith(f"{PKG}.inference"):
                scoped.setdefault((mod, target), set()).add(lazy)
    assert scoped == {(f"{PKG}.parallel.mcmc", f"{PKG}.inference.mcmc"): {True}}, scoped
    assert LAYERS["kernels"] < LAYERS["parallel"] < LAYERS["inference"]


def test_cookbook_sits_above_every_layer():
    """The cookbooks reach down into the package; no module of it reaches
    up into them, and they hold to the no-jax rule with the rest."""
    mods, edges = _graph()
    cookbooks = [m for m in mods if _subpackage(m) == "cookbook"]
    assert f"{PKG}.cookbook.ex10_sample_posterior" in cookbooks
    assert LAYERS["cookbook"] > max(v for k, v in LAYERS.items() if k != "cookbook")
    assert not [f"{src} -> {dst}" for src, targets in edges.items() for dst in targets
                if _subpackage(dst) == "cookbook" and _subpackage(src) != "cookbook"]
    assert any(_subpackage(t) == "inference" for m in cookbooks for t in edges[m])


def test_row_reduction_is_read_not_imported_by_the_kernels():
    """The column twins read a row-sharded density's ``.row_shard``
    through ``kernels.rows``, which imports ``core`` alone: ``kernels``
    imports nothing of ``parallel``."""
    mods, edges = _graph()
    assert {_subpackage(t) for t in edges[f"{PKG}.kernels.rows"]} <= {"core"}
    for mod in ("hmc", "nuts", "chees"):
        assert f"{PKG}.kernels.rows" in edges[f"{PKG}.kernels.{mod}"], mod
    assert not [t for m in mods if _subpackage(m) == "kernels" for t in edges[m] if _subpackage(t) == "parallel"]


def test_layer_direction():
    _, edges = _graph()
    violations = [
        f"{src} -> {dst}"
        for src, targets in edges.items()
        for dst in targets
        if _subpackage(src) != _subpackage(dst)
        and LAYERS[_subpackage(src)] <= LAYERS[_subpackage(dst)]
        and LAYERS[_subpackage(src)] != 9
    ]
    assert not violations, "\n".join(sorted(violations))


def test_import_graph_acyclic():
    mods, edges = _graph()
    color = {m: 0 for m in mods}
    stack, cycles = [], []

    def dfs(m):
        color[m] = 1
        stack.append(m)
        for nxt in sorted(edges.get(m, ())):
            if color[nxt] == 1:
                cycles.append(" -> ".join(stack[stack.index(nxt):] + [nxt]))
            elif color[nxt] == 0:
                dfs(nxt)
        stack.pop()
        color[m] = 2

    for m in sorted(mods):
        if color[m] == 0:
            dfs(m)
    assert not cycles, "\n".join(cycles)
