"""Executed docstring examples of the PyTorch port.

Every ``>>>`` example in a ``genjax_tpu_torch`` module docstring runs here,
as ``tests/test_doctests.py`` runs those of the JAX package.
"""

import doctest
import importlib
import pkgutil

import pytest

import genjax_tpu_torch

FLAGS = doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE
_FINDER = doctest.DocTestFinder(exclude_empty=True)


def _modules():
    yield genjax_tpu_torch
    for info in pkgutil.walk_packages(genjax_tpu_torch.__path__, prefix="genjax_tpu_torch."):
        yield importlib.import_module(info.name)


WITH_EXAMPLES = [m for m in _modules() if any(t.examples for t in _FINDER.find(m))]


@pytest.mark.parametrize("mod", WITH_EXAMPLES, ids=lambda m: m.__name__)
def test_docstring_examples(mod):
    failed = doctest.testmod(mod, optionflags=FLAGS).failed
    assert failed == 0, f"{mod.__name__}: {failed} docstring example(s) failed"


def test_example_volume():
    """The modules that carry the slice's examples keep them."""
    names = {m.__name__ for m in WITH_EXAMPLES}
    assert {
        "genjax_tpu_torch.core.pytree",
        "genjax_tpu_torch.generative.choice_map",
        "genjax_tpu_torch.generative.mask",
        "genjax_tpu_torch.generative.selection",
        "genjax_tpu_torch.dists.distribution",
        "genjax_tpu_torch.lang.static_lang",
        "genjax_tpu_torch.kernels.model_interface",
        "genjax_tpu_torch.core.diff",
        "genjax_tpu_torch.inference.requests.hmc",
        "genjax_tpu_torch.inference.mcmc",
        "genjax_tpu_torch.core.scan",
        "genjax_tpu_torch.dists.discrete_hmm",
        "genjax_tpu_torch.dists.hmm_tools",
        "genjax_tpu_torch.models.hmm",
        "genjax_tpu_torch.models.ppca",
        "genjax_tpu_torch.models.bnn",
        "genjax_tpu_torch.inference.exact_testbed",
        "genjax_tpu_torch.inference.enumerate_",
        "genjax_tpu_torch.inference.gibbs",
        "genjax_tpu_torch.inference.pgibbs",
        "genjax_tpu_torch.inference.requests.elliptical",
        "genjax_tpu_torch.inference.requests.slice_",
        "genjax_tpu_torch.inference.involutive",
        "genjax_tpu_torch.inference.predictive",
        "genjax_tpu_torch.inference.sbc",
        "genjax_tpu_torch.inference.model_comparison",
        "genjax_tpu_torch.inference.abc",
        "genjax_tpu_torch.inference.nested",
        "genjax_tpu_torch.inference.pathfinder",
        "genjax_tpu_torch.io.checkpoint",
        "genjax_tpu_torch.inference.sample",
    } <= names, sorted(names)
