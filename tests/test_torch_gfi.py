"""The port's generative core against ``genjax_tpu``.

Choice maps, selections and masks are held against the JAX package's
answers on the same inputs; GFI scores and weights of the flagship
``hierarchical_regression`` on the same choices (carried across as numpy
through ``interop``) agree to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.models import hierarchical_regression as jax_hier
from genjax_tpu_torch.interop import choice_map_from_numpy
from genjax_tpu_torch.models import hierarchical_regression

RTOL = 1e-5


def flagship_data():
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return X, y


def _flatten(chm, addresses):
    """A JAX choice map as the ``{address_tuple: ndarray}`` dict interop takes."""
    return {a: np.asarray(chm[a]) for a in addresses}


# ----------------------------------------------------------------------
# choice maps, selections, masks
# ----------------------------------------------------------------------


def _build(mod):
    return (
        mod.C["obs", "y"].set(1.0)
        | mod.C["mu"].set(0.5)
        | mod.C["obs", "z"].set(-2.0)
    )


@pytest.mark.parametrize(
    "addr", [("obs", "y"), ("mu",), ("obs", "z"), ("obs",), ("nope",), ("obs", "q")]
)
def test_choice_map_reads_match_jax(addr):
    jc, tc = _build(gj), _build(g)
    assert (addr in tc) == (addr in jc)
    assert tc.get_submap(*addr).static_is_empty() == jc.get_submap(*addr).static_is_empty()
    if addr in jc:
        assert float(tc[addr]) == float(jc[addr])
    else:
        with pytest.raises(g.generative.ChoiceMapNoValueAtAddress):
            tc[addr]


def test_choice_map_left_priority_and_empty():
    chm = _build(g)
    assert float((g.C["mu"].set(9.9) | chm)["mu"]) == float((gj.C["mu"].set(9.9) | _build(gj))["mu"])
    assert g.ChoiceMap.empty().static_is_empty()
    assert (g.ChoiceMap.empty() | chm) is chm
    assert g.ChoiceMap.entry(3.0, "a", "b").get_submap("a", "b").get_value() == 3.0
    assert chm.get_submap("obs").static_addresses() == ("y", "z")


SELECTIONS = {
    "or": lambda m: m.S["x"] | m.S["y", "z"],
    "and": lambda m: (m.S["x"] | m.S["y"]) & m.S["y"],
    "not": lambda m: ~(m.S["x"] | m.S["y", "z"]),
    "wildcard": lambda m: m.S[..., "z"],
    "all": lambda m: m.S.all(),
    "none": lambda m: m.S.none(),
}
ADDRS = [("x",), ("y",), ("y", "z"), ("w", "z"), ("other",)]


@pytest.mark.parametrize("name", sorted(SELECTIONS))
def test_selection_membership_matches_jax(name):
    jsel, tsel = SELECTIONS[name](gj), SELECTIONS[name](g)
    for addr in ADDRS:
        assert (addr in tsel) == (addr in jsel), addr


def test_mask_matches_jax():
    for flag in (True, False):
        assert float(g.Mask(1.5, flag).unmask(default=0.0)) == float(
            gj.Mask(1.5, flag).unmask(default=0.0)
        )
    a = g.Mask(torch.tensor([1.0, 2.0]), torch.tensor([True, False]))
    b = g.Mask(torch.tensor([5.0, 6.0]), torch.tensor([False, True]))
    ja = gj.Mask(jnp.asarray([1.0, 2.0]), jnp.asarray([True, False]))
    jb = gj.Mask(jnp.asarray([5.0, 6.0]), jnp.asarray([False, True]))
    np.testing.assert_array_equal((a | b).value.numpy(), np.asarray((ja | jb).value))
    np.testing.assert_array_equal((a | b).flag.numpy(), np.asarray((ja | jb).flag))
    np.testing.assert_array_equal((~a).flag.numpy(), np.asarray((~ja).flag))
    with pytest.raises(ValueError, match="prefix"):
        g.Mask(torch.zeros(3), torch.tensor([True, False]))


# ----------------------------------------------------------------------
# the GFI on the flagship model
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def flagship():
    X, y = flagship_data()
    jm = jax_hier(X)
    choices = [
        _flatten(jm.simulate(jax.random.key(k), ()).get_choices(), [("tau",), ("w",), ("y",)])
        for k in range(4)
    ]
    return jm, hierarchical_regression(X), choices


@pytest.mark.parametrize("k", range(4))
def test_assess_matches_jax(flagship, k):
    jm, tm, choices = flagship
    flat = choices[k]
    j_score, _ = jm.assess(gj.ChoiceMap.d({a[0]: v for a, v in flat.items()}), ())
    t_score, t_ret = tm.assess(choice_map_from_numpy(flat), ())
    np.testing.assert_allclose(float(t_score), float(j_score), rtol=RTOL)
    np.testing.assert_array_equal(t_ret.numpy(), flat[("y",)])


@pytest.mark.parametrize("k", range(4))
def test_fully_constrained_generate_weight_matches_jax(flagship, k):
    jm, tm, choices = flagship
    flat = choices[k]
    _, j_w = jm.generate(jax.random.key(9), gj.ChoiceMap.d({a[0]: v for a, v in flat.items()}), ())
    tr, t_w = tm.generate(torch.Generator().manual_seed(9), choice_map_from_numpy(flat), ())
    np.testing.assert_allclose(float(t_w), float(j_w), rtol=RTOL)
    np.testing.assert_allclose(float(tr.get_score()), float(j_w), rtol=RTOL)


def test_partially_constrained_generate_weight_is_likelihood():
    X, y = flagship_data()
    tm = hierarchical_regression(X)
    tr, w = tm.generate(torch.Generator().manual_seed(3), g.C["y"].set(y), ())
    np.testing.assert_array_equal(np.asarray(tr.get_choices()["y"]), y)
    lik = g.mv_normal_diag.logpdf(
        y, torch.from_numpy(X) @ tr.get_choices()["w"], 0.25 * torch.ones(16)
    )
    torch.testing.assert_close(w, lik)


@pytest.mark.parametrize("seed", range(3))
def test_simulate_score_equals_assess_of_its_choices(seed):
    X, _ = flagship_data()
    tm = hierarchical_regression(X)
    tr = tm.simulate(torch.Generator().manual_seed(seed), ())
    score, retval = tm.assess(tr.get_choices(), ())
    torch.testing.assert_close(tr.get_score(), score)
    assert torch.equal(retval, tr.get_retval())


def test_address_reuse_raises():
    @g.gen
    def twice():
        g.normal(0.0, 1.0) @ "x"
        g.normal(0.0, 1.0) @ "x"

    with pytest.raises(g.AddressReuse):
        twice.simulate(torch.Generator().manual_seed(0), ())


def test_missing_address_raises_in_assess():
    X, y = flagship_data()
    with pytest.raises(g.MissingAddress):
        hierarchical_regression(X).assess(g.C["y"].set(y), ())


def test_readme_quickstart_runs():
    @g.gen
    def beta_bernoulli(alpha, beta):
        p = g.beta(alpha, beta) @ "p"
        v = g.flip(p) @ "v"
        return v

    tr = beta_bernoulli.simulate(torch.Generator().manual_seed(0), (2.0, 2.0))
    p, v = tr.get_choices()["p"], tr.get_choices()["v"]
    assert 0.0 < float(p) < 1.0 and v.dtype == torch.bool
    expected = g.beta.logpdf(p, 2.0, 2.0) + g.flip.logpdf(v, p)
    torch.testing.assert_close(tr.get_score(), expected)
    j_expected = gj.beta.logpdf(float(p), 2.0, 2.0) + gj.flip.logpdf(bool(v), float(p))
    np.testing.assert_allclose(float(tr.get_score()), float(j_expected), rtol=RTOL)
