"""The port's column bridge against ``genjax_tpu``.

``ColumnPacker`` packs the flagship's ``["tau", "w"]`` into 9 dimensions
padded to 16 in the reference's order; ``column_logdensity`` and its
autograd gradient match the reference's log-density and ``jax.vjp`` on a
``(16, 64)`` grid (rtol 1e-5, atol 1e-4); and the ``hier_regression`` device
body's plain formula matches autograd through ``assess``, which ties the
kernel's hand-written gradient to the model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.kernels import ColumnPacker as JaxPacker
from genjax_tpu.kernels import column_logdensity as jax_column_logdensity
from genjax_tpu.models import hierarchical_regression as jax_hier
from genjax_tpu_torch.interop import columns_from_numpy
from genjax_tpu_torch.kernels import ColumnPacker, bodies, column_logdensity
from genjax_tpu_torch.models import hierarchical_regression


def flagship_data():
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def both():
    X, y = flagship_data()
    jm, tm = jax_hier(X), hierarchical_regression(X)
    jobs, tobs = gj.C["y"].set(y), g.C["y"].set(y)
    jp = JaxPacker(jm, jobs, (), ["tau", "w"])
    tp = ColumnPacker(tm, tobs, (), ["tau", "w"])
    return (
        (jm, jobs, jp, jax_column_logdensity(jm, jobs, (), jp)),
        (tm, tobs, tp, column_logdensity(tm, tobs, (), tp)),
    )


def grid(n=64, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(16, n)).astype(np.float32)
    q[0] = rng.uniform(0.2, 3.0, size=n)
    return q


def test_packer_dims_and_layout_match_jax(both):
    (_, _, jp, _), (_, _, tp, _) = both
    assert (tp.dim, tp.padded_dim) == (jp.dim, jp.padded_dim) == (9, 16)
    assert [(p, tuple(s), o, n) for p, s, o, n in tp.shapes] == [
        (p, tuple(s), o, n) for p, s, o, n in jp.shapes
    ]


@pytest.mark.parametrize("col", range(3))
def test_pack_unpack_order_matches_jax(both, col):
    (jm, _, jp, _), (_, _, tp, _) = both
    q = grid(4)[:, col]
    q[9:] = 0.0
    jchm = jp.unpack(jnp.asarray(q))
    tchm = tp.unpack(torch.from_numpy(q))
    for addr in ("tau", "w"):
        np.testing.assert_array_equal(tchm[addr].numpy(), np.asarray(jchm[addr]))
    np.testing.assert_array_equal(tp.pack(tchm).numpy(), np.asarray(jp.pack(jchm)))


def test_logdensity_and_gradient_match_jax_vjp(both):
    (_, _, _, jld), (_, _, _, tld) = both
    q = grid()
    j_lp, pullback = jax.vjp(jld, jnp.asarray(q))
    (j_g,) = pullback(jnp.ones_like(j_lp))
    tq = columns_from_numpy(q, "cpu").requires_grad_(True)
    t_lp = tld(tq)
    (t_g,) = torch.autograd.grad(t_lp.sum(), tq)
    np.testing.assert_allclose(t_lp.detach().numpy(), np.asarray(j_lp), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), rtol=1e-5, atol=1e-4)


def test_logdensity_matches_assess(both):
    _, (tm, tobs, tp, tld) = both
    q = torch.from_numpy(grid(4))
    lp = tld(q)
    for i in range(4):
        expected, _ = tm.assess(tp.unpack(q[:, i]) | tobs, ())
        expected = expected - 0.5 * torch.sum(q[9:, i] ** 2)
        torch.testing.assert_close(lp[i], expected)


def test_body_plain_formula_matches_autograd_through_assess(both):
    _, (_, _, _, tld) = both
    assert tld.body is not None and tld.body.name == "hier_regression"
    q = torch.from_numpy(grid(128, seed=4)).requires_grad_(True)
    lp = tld(q)
    (grad,) = torch.autograd.grad(lp.sum(), q)
    b_lp, b_grad = tld.body.lp_grad(q.detach())
    torch.testing.assert_close(b_lp, lp.detach(), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(b_grad, grad, rtol=1e-5, atol=1e-4)


def test_body_off_support_matches_autograd(both):
    """tau <= 0: the log-density is -inf and the gradient NaN in the body
    exactly where autograd through the model gives them."""
    _, (_, _, _, tld) = both
    q = torch.from_numpy(grid(8, seed=5))
    q[0, :4] = torch.tensor([-1.0, -0.1, -2.0, -0.5])
    q.requires_grad_(True)
    lp = tld(q)
    (grad,) = torch.autograd.grad(lp.sum(), q)
    b_lp, b_grad = tld.body.lp_grad(q.detach())
    assert torch.equal(torch.isneginf(b_lp), torch.isneginf(lp.detach()))
    assert bool(torch.isneginf(b_lp[:4]).all())
    assert torch.equal(torch.isnan(b_grad), torch.isnan(grad))


@pytest.mark.parametrize(
    "addresses, constraint",
    [
        (["w", "tau"], "y"),
        (["tau"], "y"),
        (["tau", "w"], None),
    ],
)
def test_body_only_for_the_exact_packing(addresses, constraint):
    X, y = flagship_data()
    tm = hierarchical_regression(X)
    obs = g.C["y"].set(y) if constraint == "y" else g.ChoiceMap.empty()
    if addresses == ["tau"]:
        obs = obs | g.C["w"].set(np.zeros(8, np.float32))
    packer = ColumnPacker(tm, obs, (), addresses)
    assert column_logdensity(tm, obs, (), packer).body is None


@pytest.mark.parametrize(
    "n_obs, d_w, variant",
    [(16, 8, "specialised"), (5, 3, "generic"), (3, 7, "generic"), (20, 8, "generic")],
)
def test_body_matches_jax_at_shape(n_obs, d_w, variant):
    """``Body.lp_grad``, the plain version of the kernels' device body, equals
    the reference's column log-density and its ``jax.vjp`` gradient to 1e-5,
    at the shape the kernels specialise and at runtime shapes."""
    rng = np.random.default_rng(10 * n_obs + d_w)
    X = rng.normal(size=(n_obs, d_w)).astype(np.float32)
    y = rng.normal(size=(n_obs,)).astype(np.float32)
    jm, jobs = jax_hier(X), gj.C["y"].set(y)
    jld = jax_column_logdensity(jm, jobs, (), JaxPacker(jm, jobs, (), ["tau", "w"]))
    d = max(-(-(1 + d_w) // 8) * 8, 8)
    q = rng.normal(size=(d, 32)).astype(np.float32)
    q[0] = rng.uniform(0.5, 2.0, size=32)
    j_lp, pullback = jax.vjp(jld, jnp.asarray(q))
    (j_g,) = pullback(jnp.ones_like(j_lp))
    body = bodies.hier_regression(X, y, 0.25)
    assert body.variant(d) == variant
    t_lp, t_g = body.lp_grad(torch.from_numpy(q))
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), rtol=1e-5, atol=1e-5)
