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
