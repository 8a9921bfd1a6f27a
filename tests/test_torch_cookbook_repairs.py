"""Faults the cookbooks found where the port's modules meet, each shown
without a cookbook and held to ``genjax_tpu``:

- the choice-map builder lacked the reference's constructors at a path
  (``C.d``, ``C.v``/``C.value``, ``C.from_mapping``, ``C.switch``,
  ``C.empty``, ``update``), ``ChoiceMap.choice``/``ChoiceMap.value`` and
  the ``chm.at[...]`` builder that layers an entry over a map
  (``examples/02_gfi.py``, ``examples/03_choice_maps.py``);
- ``Pytree`` lacked ``const``, ``field``, ``partial`` and ``replace``
  (``examples/06_vi.py``, ``11``, ``18``, ``27``);
- a vmap combinator whose body returns nothing failed in ``assess`` and
  ``generate``, torch's vmap refusing a ``None`` output
  (``examples/19_discrete_workflow.py``).

The fourth, the column samplers' shapes traced on the CPU
(``examples/26_dense_mass.py``), shows only on the card:
``tests/test_torch_cookbook_devices.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import genjax_tpu as gj
import genjax_tpu_torch as gt
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5


def _f(v):
    v = v.unmask() if hasattr(v, "unmask") else v
    return np.asarray(v, np.float64)


@pytest.mark.parametrize(
    "build",
    [
        lambda g: g.C["p"].d({"a": 1.0, ("b", "c"): 2.0}),
        lambda g: g.C["p", "q"].v(3.0),
        lambda g: g.C["p"].value(4.0),
        lambda g: g.C["p"].from_mapping([("a", 5.0), (("b", "c"), 6.0)]),
        lambda g: g.C["p"].kw(u=7.0, v=8.0),
        lambda g: g.C.empty() | g.C["z"].set(9.0),
        lambda g: g.C["a"].set(1.0).at["a"].set(10.0),
        lambda g: g.C.d({"a": 1.0, "b": 2.0}).at["b"].update(lambda v: v * 3.0),
        lambda g: g.C["x"].update(lambda v: 11.0 if v is None else v),
        lambda g: g.C["w"].set(g.ChoiceMap.choice(12.0)) | g.C["v"].set(g.ChoiceMap.value(13.0)),
    ],
    ids=["d", "v", "value", "from_mapping", "kw", "empty", "at_set", "at_update", "update_no_base", "choice"],
)
def test_builder_constructors_match_the_reference(build):
    ours, ref = build(gt), build(gj)
    paths = [("p", "a"), ("p", "b", "c"), ("p", "q"), ("p",), ("p", "u"), ("p", "v"), ("z",), ("a",), ("b",),
             ("x",), ("w",), ("v",)]
    for path in paths:
        want = ref.get_submap(*path).get_value()
        got = ours.get_submap(*path).get_value()
        assert (got is None) == (want is None), path
        if want is not None:
            np.testing.assert_allclose(_f(got), _f(want), rtol=TOL)


def test_at_layers_over_the_map_with_priority():
    base = gt.C["a"].set(0.0) | gt.C["b"].set(1.0)
    updated = base.at["a"].set(10.0)
    assert float(updated["a"]) == 10.0 and float(updated["b"]) == 1.0
    assert float(base["a"]) == 0.0  # the base is left as it was


def test_switch_at_a_path():
    ours = gt.C["s"].switch(1, [gt.C["x"].set(1.0), gt.C["x"].set(2.0)])
    ref = gj.C["s"].switch(1, [gj.C["x"].set(1.0), gj.C["x"].set(2.0)])
    assert float(ours["s", "x"]) == float(ref["s", "x"]) == 2.0


def test_pytree_const_field_partial_replace():
    c = gt.Pytree.const(3)
    assert pytree.tree_leaves(c) == [] and jax.tree_util.tree_leaves(gj.Pytree.const(3)) == []
    assert gt.Pytree.const(c) is c and c.unwrap() == 3

    @gt.Pytree.dataclass
    class Point(gt.Pytree):
        x: torch.Tensor = gt.Pytree.field(default=None)
        tag: str = gt.Pytree.static(default="p")

    p = Point(torch.ones(2))
    assert [tuple(v.shape) for v in pytree.tree_leaves(p)] == [(2,)]
    q = p.replace(tag="q")
    assert q.tag == "q" and q.x is p.x and dataclasses.is_dataclass(q)

    closed = gt.Pytree.partial(torch.tensor(2.0))(lambda a, b: a * b)
    ref = gj.Pytree.partial(jnp.asarray(2.0))(lambda a, b: a * b)
    assert float(closed(3.0)) == float(ref(3.0)) == 6.0
    assert len(pytree.tree_leaves(closed)) == 1


def _site_models(g, np_):
    mus = np_.asarray(np.asarray([-1.5, 1.5], np.float32))
    log_pi = np_.log(np_.asarray(np.asarray([0.4, 0.6], np.float32)))

    @g.gen
    def site(x):
        z = g.categorical(log_pi) @ "z"
        _ = g.normal(mus[z], 1.0) @ "y"

    @g.gen
    def model(xs):
        _ = site.vmap(in_axes=(0,))(xs) @ "assign"

    return model


def test_vmap_of_a_body_that_returns_nothing_matches_the_reference():
    xs = np.asarray([-1.9, -0.2, 1.1, 2.0], np.float32)
    zs = np.asarray([0, 1, 1, 0])
    ours = _site_models(gt, torch)
    ref = _site_models(gj, jnp)
    chm_t = gt.C["assign", :, "z"].set(torch.from_numpy(zs)) | gt.C["assign", :, "y"].set(torch.from_numpy(xs))
    chm_j = gj.C["assign", :, "z"].set(jnp.asarray(zs)) | gj.C["assign", :, "y"].set(jnp.asarray(xs))
    score, retval = ours.assess(chm_t, (torch.from_numpy(xs),))
    want, _ = ref.assess(chm_j, (jnp.asarray(xs),))
    np.testing.assert_allclose(float(score), float(want), rtol=TOL, atol=TOL)
    assert retval is None
    tr, w = ours.generate(torch.Generator().manual_seed(0), chm_t, (torch.from_numpy(xs),))
    np.testing.assert_allclose(float(w), float(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(tr.get_score()), float(want), rtol=TOL, atol=TOL)
