"""The port's cookbooks (``genjax_tpu_torch/cookbook/``) on the CPU.

Every ``examples/NN_*.py`` has one counterpart, apart from those that
``ROADMAP.md`` queue 3 lists as blocked; each runs as its reference does in
``tests/test_examples.py``, ``--device cpu`` standing in for the card, the
reference's ``SLOW`` set under the ``slow`` marker (``chip_smoke.py``'s
``[cookbook]`` phase runs every one on the card). The mesh narratives
(``14``, ``20``, ``25``) run in a gloo world of 2 ranks in
``tests/test_torch_cookbook_world.py``.

The deterministic numbers the cookbooks compute are held to ``genjax_tpu``
on the same inputs, to 1e-5: ``02``'s scores and weights, ``03``'s
choice-map reads, ``15``'s MAP point and Laplace fit, ``21``'s Kalman
filter.
"""

import importlib
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
from genjax_tpu_torch.cookbook import COOKBOOKS
from test_examples import SLOW
from torch_threads import _one_thread  # noqa: F401

REPO = pathlib.Path(__file__).parents[1]
WORLD = {"14_multichip", "20_big_data", "25_island_pf"}
TOL = 1e-5


def _blocked():
    """The cookbooks ``ROADMAP.md`` queue 3 lists as blocked, by stem."""
    text = (REPO / "ROADMAP.md").read_text()
    queue = text.split("### Queue 3", 1)[1].split("\n### ", 1)[0]
    return set(re.findall(r"blocked cookbook `examples/(\d\d_\w+)\.py`", queue))


def _stem(name):
    """``ex10_sample_posterior`` -> ``10_sample_posterior``."""
    return name[2:]


def test_every_reference_cookbook_has_one_counterpart():
    stems = sorted(p.stem for p in (REPO / "examples").glob("[0-9][0-9]_*.py"))
    ours = sorted(p.stem for p in (REPO / "genjax_tpu_torch" / "cookbook").glob("ex[0-9][0-9]_*.py"))
    assert list(COOKBOOKS) == ours
    blocked = _blocked()
    assert blocked <= set(stems)
    by_number = {}
    for name in ours:
        by_number.setdefault(name[2:4], []).append(name)
    for stem in stems:
        mine = by_number.get(stem[:2], [])
        if stem in blocked:
            assert mine == [], stem
        else:
            assert len(mine) == 1, (stem, mine)
    # the basics cookbook is the port's own "torch basics"; every other
    # counterpart keeps the reference's name
    assert {_stem(n) for n in ours} - set(stems) == {"27_torch_basics"}


def _param(name):
    stem = _stem(name)
    ref_stem = "27_jax_basics" if stem == "27_torch_basics" else stem
    marks = [pytest.mark.slow] if ref_stem in SLOW else []
    return pytest.param(name, id=stem, marks=marks)


@pytest.mark.parametrize("name", [_param(n) for n in COOKBOOKS if _stem(n) not in WORLD])
def test_cookbook_runs(name):
    importlib.import_module(f"genjax_tpu_torch.cookbook.{name}").main(device="cpu")


# ----------------------------------------------------------------------
# the deterministic numbers against the reference
# ----------------------------------------------------------------------


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=tol)


def test_gfi_scores_and_weights_match_the_reference():
    from genjax_tpu.core.diff import Diff

    out = importlib.import_module("genjax_tpu_torch.cookbook.ex02_gfi").main(device="cpu")

    @gj.gen
    def model(mu):
        x = gj.normal(mu, 1.0) @ "x"
        y = gj.normal(x, 0.5) @ "y"
        return y

    key = jax.random.key(0)
    tr, _ = model.generate(key, gj.C.d({"x": out["x"], "y": out["y"]}), (0.0,))
    _close(out["score"], tr.get_score())
    _close(out["assess"], model.assess(gj.C.d({"x": 1.0, "y": 1.2}), (0.0,))[0])
    _close(out["importance"], gj.normal.assess(gj.ChoiceMap.choice(2.0), (out["x_c"], 0.5))[0])
    _close(out["update"], tr.update(key, gj.C["x"].set(0.5))[1])
    _close(out["argdiff"], model.edit(key, tr, gj.Update(gj.C.empty()), (Diff.unknown_change(1.0),))[1])
    _close(out["project"], tr.project(key, gj.S["x"]))


def _reference_choice_map_reads():
    C = gj.C
    c2 = C["outer", "inner"].set(2.0)
    c3 = gj.ChoiceMap.d({"a": 3.0, ("b", "c"): 4.0})
    c4 = gj.ChoiceMap.kw(u=5.0, v=6.0)
    v = gj.ChoiceMap.choice(7.0)
    acc = gj.ChoiceMap.empty()
    for i, name in enumerate(["a", "b", "c"]):
        acc |= C[name].set(float(i))
    updated = acc.at["a"].set(10.0)
    merged = C["x"].set(10.0) | C["x"].set(1.0)
    builders = [c2["outer", "inner"], c3["a"], c3["b", "c"], c4["u"], c4["v"], v.get_value(), acc["a"], acc["b"],
                acc["c"], updated["a"], updated["b"], updated["c"], merged["x"]]
    dense = C[:, "z"].set(jnp.arange(5.0))
    sparse = C[jnp.asarray([1, 3]), "z"].set(jnp.asarray([10.0, 30.0]))
    hit = sparse.get_submap(jnp.asarray(3), "z").get_value()
    miss = sparse.get_submap(jnp.asarray(0), "z").get_value()
    multi = C[jnp.asarray([0, 2])].set(gj.ChoiceMap.d({"z": jnp.asarray([0.1, 0.2]), "y": jnp.asarray([1.0, 2.0])}))
    mv = multi.get_submap(jnp.asarray(2), "y").get_value()
    chm = gj.ChoiceMap.d({"x": 1.0, "y": 2.0})
    only_x = chm.filter(gj.S["x"])
    y_val = only_x.get_submap("y").get_value()
    return {
        "builders": [float(b) for b in builders],
        "indexed": [float(dense[2, "z"]), float(hit.value), bool(miss.primal_flag()), float(mv.unmask())],
        "selections": [float(only_x.get_submap("x").get_value()), y_val is None],
    }


def test_choice_map_reads_match_the_reference():
    out = importlib.import_module("genjax_tpu_torch.cookbook.ex03_choice_maps").main(device="cpu")
    want = _reference_choice_map_reads()
    _close(out["builders"], want["builders"])
    assert out["indexed"][:4] == pytest.approx(want["indexed"], abs=TOL)
    _close(out["indexed"][4], np.linspace(-1, 1, 5))
    assert out["nested"] == 0.5
    assert out["selections"] == want["selections"]


def test_map_point_and_laplace_match_the_reference():
    from genjax_tpu.inference import fit_map, laplace_approximation
    from genjax_tpu.models import linear_regression

    out = importlib.import_module("genjax_tpu_torch.cookbook.ex15_map_laplace").main(device="cpu")
    model, _ = linear_regression(out["X"])
    obs = gj.C["y"].set(jnp.asarray(out["y"]))
    res = fit_map(jax.random.key(0), model, obs, (), gj.S["w"], n_steps=400, learning_rate=0.05)
    lap = laplace_approximation(jax.random.key(1), model, obs, (), gj.S["w"], n_steps=400, learning_rate=0.05)
    _close(out["map"], res["w"])
    _close(out["mean"], lap.mean)
    _close(out["cov"], lap.cov)
    _close(out["log_marginal"], lap.log_marginal)


def test_kalman_log_marginal_matches_the_reference():
    from genjax_tpu.dists import LGSSMParams, kalman_filter, kalman_smoother

    mod = importlib.import_module("genjax_tpu_torch.cookbook.ex21_state_space_workflow")
    out = mod.main(device="cpu")
    params = LGSSMParams.scalar(mod.A, mod.Q_SD**2, 1.0, mod.R_SD**2, 0.0, p0=mod.Q_SD**2)
    ys = jnp.asarray(out["ys"]).reshape(-1, 1)
    means_f, _, logz = kalman_filter(params, ys)
    means_s, _, _ = kalman_smoother(params, ys)
    _close(out["log_marginal"], logz)
    _close(out["filtered_means"], means_f)
    _close(out["smoothed_means"], means_s)


def test_the_cookbooks_import_no_jax():
    """Each cookbook module imports torch, numpy, scipy and the port only."""
    for name in COOKBOOKS:
        src = (REPO / "genjax_tpu_torch" / "cookbook" / f"{name}.py").read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|genjax_tpu\b|flax|optax)", src, re.M), name
