"""API parity of the PyTorch port with the reference's public names.

``tests/fixtures_reference_api.json`` lists the reference's public names by
facade module (166 distinct names, ``tests/test_api_parity.py``). Every name
resolves in the port's counterpart namespaces, with ``tfp_distribution``
named ``torch_distribution``, except those the port has not ported yet:
``NOT_YET`` lists them with the ``ROADMAP.md`` item that ports them (or the
reason there is none). The list only shrinks: a name on it that the port
exports fails the test until it is taken off.
"""

import importlib
import json
import pathlib

import pytest
import torch

FIXTURE = pathlib.Path(__file__).parent / "fixtures_reference_api.json"
RENAMED = {"tfp_distribution": "torch_distribution"}

NOT_YET = {
    # the reference's addressed calls are a jaxpr primitive; the port's
    # (as genjax_tpu's) run under a handler stack: no trace primitive
    ("generative_functions.static", "trace_p"),
}


def _namespaces():
    g = importlib.import_module("genjax_tpu_torch")
    mod = importlib.import_module
    return {
        "adev": [g.adev],
        "checkify": [g],
        "incremental": [g],
        "pretty": [g],
        "time_travel": [g],
        "generative_functions.combinators": [g, mod("genjax_tpu_torch.combinators")],
        "generative_functions.static": [g, g.lang],
        "generative_functions.distributions": [g, mod("genjax_tpu_torch.dists")],
        "inference": [g.inference, g],
        "inference.requests": [mod("genjax_tpu_torch.inference.requests"), g],
        "inference.smc": [g.inference, g],
        "inference.vi": [g.vi, g],
        "core.compiler": [g, g.core],
        "core.generative": [g, g.core, mod("genjax_tpu_torch.generative")],
        "core.pytree": [g, g.core],
        "core.requests": [g, g.core],
    }


def _fixture():
    return json.loads(FIXTURE.read_text())


def test_not_yet_names_are_reference_names():
    fix = _fixture()
    assert all(name in fix[module] for module, name in NOT_YET)


@pytest.mark.parametrize("module", sorted(_fixture().keys()))
def test_ported_names_resolve(module):
    spaces = _namespaces()[module]

    def resolves(name):
        return any(hasattr(ns, RENAMED.get(name, name)) for ns in spaces)

    names = _fixture()[module]
    missing = [n for n in names if (module, n) not in NOT_YET and not resolves(n)]
    assert not missing, f"the port does not export {missing} of reference module {module!r}"
    ported_since = [n for n in names if (module, n) in NOT_YET and resolves(n)]
    assert not ported_since, f"{ported_since} of {module!r} are exported now: take them off NOT_YET"


def test_trace_function_form_and_builders():
    """``trace(addr, gen_fn, args)`` is ``gen_fn(*args) @ addr``, and the
    builder aliases are the builders."""
    g = importlib.import_module("genjax_tpu_torch")

    @g.gen
    def at_form():
        return g.normal(0.0, 1.0) @ "x"

    @g.gen
    def function_form():
        return g.trace("x", g.normal, (0.0, 1.0))

    a = at_form.simulate(torch.Generator().manual_seed(0), ())
    b = function_form.simulate(torch.Generator().manual_seed(0), ())
    assert torch.equal(a.get_choices()["x"], b.get_choices()["x"])
    assert torch.equal(a.get_score(), b.get_score())
    assert g.ChoiceMapBuilder is g.C
    assert isinstance(g.S, g.SelectionBuilder)


# ----------------------------------------------------------------------
# the names of ``genjax_tpu``'s own ``__all__``, namespace by namespace
# ----------------------------------------------------------------------

#: Subpackages of ``genjax_tpu`` with an ``__all__``, each against the
#: port's namespace of the same path.
ALL_NAMESPACES = ["", ".core", ".generative", ".dists", ".inference", ".combinators", ".lang",
                  ".parallel", ".kernels", ".models", ".adev"]

#: Names of those ``__all__`` lists the port does not export, each with its
#: reason. The list only shrinks: a name on it that the port exports fails.
EXCLUDED = {
    # renamed: the port wraps torch.distributions, not TFP
    ("", "tfp_distribution"): "renamed torch_distribution",
    (".dists", "tfp_distribution"): "renamed torch_distribution",
    # exist only for JAX
    (".parallel", "shard_map_compat"): "a shim over jax's shard_map; the port's collectives are "
                                       "torch.distributed calls, with no shard_map to call",
    (".core", "nobeartype"): "an escape hatch from beartype, which the port does not use",
    (".core", "cached_stage_dynamic"): "caches the jaxpr of an edit; the port's incremental edit "
                                       "follows changes on running ops and stages no program",
}


def _all_of(sub):
    import jax

    jax.config.update("jax_platforms", "cpu")
    return importlib.import_module("genjax_tpu" + sub).__all__


@pytest.mark.parametrize("sub", ALL_NAMESPACES, ids=lambda s: s or "top")
def test_every_name_of_the_reference_all_resolves(sub):
    port = importlib.import_module("genjax_tpu_torch" + sub)
    names = _all_of(sub)
    missing = [n for n in names if (sub, n) not in EXCLUDED and not hasattr(port, n)]
    assert not missing, f"genjax_tpu_torch{sub} does not export {missing}"
    exported = [n for (s, n) in EXCLUDED if s == sub and hasattr(port, n)]
    assert not exported, f"{exported} of genjax_tpu_torch{sub} are exported now: take them off EXCLUDED"


def test_excluded_names_are_reference_names_with_reasons():
    for (sub, name), reason in EXCLUDED.items():
        assert name in _all_of(sub) and reason


def test_the_core_names_the_generative_types_and_the_key():
    from genjax_tpu_torch import core, generative
    from genjax_tpu_torch.core import keys

    assert core.ChoiceMap is generative.ChoiceMap and core.Trace is generative.Trace
    assert core.PRNGKey is keys.PRNGKey is torch.Tensor
    assert core.tree_const_unwrap(core.tree_const((1, "a"))) == (1, "a")
    tr = core.empty_trace(importlib.import_module("genjax_tpu_torch").normal, (0.0, 1.0))
    assert float(tr.get_score()) == 0.0 and float(tr.get_retval()) == 0.0
    assert core.staged_check(True) and not core.staged_check(torch.tensor(True))
    assert core.static_check_is_concrete(1) and not core.static_check_is_concrete(torch.ones(()))
