"""The port's ADEV against ``genjax_tpu/adev`` and closed-form derivatives.

Every case of ``tests/adev/test_adev.py`` has its counterpart here, with the
reference's tolerances: a Monte-Carlo estimate is the mean of a
``torch.func.vmap(..., randomness="different")`` batch of estimates (where
the reference vmaps over split keys), a ``lax.cond`` on a draw is a
``torch.where``. The exact strategies (enumeration, and MVD on a
deterministic continuation) are also held to the reference's own estimates
on the same arguments (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import _one_thread  # noqa: F401

import genjax_tpu.adev as RA
from genjax_tpu_torch.adev import (
    Dual,
    add_cost,
    baseline,
    beta_implicit,
    categorical_enum_parallel,
    expectation,
    flip_enum,
    flip_enum_parallel,
    flip_mvd,
    flip_reinforce,
    mv_normal_diag_reparam,
    normal_reinforce,
    normal_reparam,
)
from genjax_tpu_torch.adev.core import sample_primitive
from genjax_tpu_torch.adev.primitives import FlipEnum, NormalREPARAM


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(314159)


def lanes(gen, n, f):
    """``n`` independent runs of ``f()`` in one vmapped batch."""
    return torch.func.vmap(lambda _: f(), randomness="different")(torch.zeros(n))


class TestExactStrategies:
    def test_flip_enum_branch_loss(self, gen):
        @expectation
        def loss(p):
            b = flip_enum(p)
            return torch.where(b, 7.0, 3.0)

        # E = 3 + 4p, dE/dp = 4 exactly, for any p
        for p in [0.1, 0.3, 0.7, 0.9]:
            (grad,) = loss.grad_estimate(gen, (p,))
            assert float(grad) == pytest.approx(4.0, rel=1e-5)
            assert float(loss.estimate(gen, (p,))) == pytest.approx(3.0 + 4.0 * p, rel=1e-5)

    def test_flip_enum_jvp(self, gen):
        @expectation
        def loss(p):
            b = flip_enum(p)
            return torch.where(b, 1.0, 0.0)

        dual = loss.jvp_estimate(gen, (Dual(0.4, 1.0),))
        assert float(dual.primal) == pytest.approx(0.4, rel=1e-5)
        assert float(dual.tangent) == pytest.approx(1.0, rel=1e-5)

    def test_flip_enum_parallel(self, gen):
        @expectation
        def loss(p):
            b = flip_enum_parallel(p)
            return torch.where(b, 5.0, 1.0)

        (grad,) = loss.grad_estimate(gen, (0.25,))
        assert float(grad) == pytest.approx(4.0, rel=1e-5)

    def test_categorical_enum(self, gen):
        @expectation
        def loss(logits):
            i = categorical_enum_parallel(logits)
            return i.to(torch.float32) ** 2

        (grad,) = loss.grad_estimate(gen, (torch.zeros(3),))
        # E = sum softmax(l) i^2; at zeros p = 1/3, E = 5/3; dE/dl_j = p_j (j^2 - E)
        expected = (torch.tensor([0.0, 1.0, 4.0]) - 5.0 / 3.0) / 3.0
        assert torch.allclose(grad, expected, atol=1e-5)

    def test_composition_of_enum_and_reparam_in_cond(self, gen):
        @expectation
        def loss(p):
            b = flip_enum(p)
            return torch.where(b, normal_reparam(2.0, 0.01), normal_reparam(-1.0, 0.01))

        grads = lanes(gen, 200, lambda: loss.grad_estimate(gen, (0.5,))[0])
        # E = 2p - (1 - p), dE/dp = 3
        assert float(torch.mean(grads)) == pytest.approx(3.0, abs=0.05)


class TestMonteCarloStrategies:
    def test_normal_reparam_quadratic(self, gen):
        @expectation
        def loss(mu):
            x = normal_reparam(mu, 1.0)
            return (x - 2.0) ** 2

        # dE/dmu = 2 (mu - 2)
        grads = lanes(gen, 5000, lambda: loss.grad_estimate(gen, (0.5,))[0])
        assert float(torch.mean(grads)) == pytest.approx(-3.0, abs=0.1)

    def test_normal_reinforce_matches_reparam(self, gen):
        @expectation
        def loss(mu):
            x = normal_reinforce(mu, 1.0)
            return (x - 2.0) ** 2

        grads = lanes(gen, 30000, lambda: loss.grad_estimate(gen, (0.5,))[0])
        assert float(torch.mean(grads)) == pytest.approx(-3.0, abs=0.15)

    def test_flip_reinforce(self, gen):
        @expectation
        def loss(p):
            b = flip_reinforce(p)
            return b.to(torch.float32) * 10.0

        grads = lanes(gen, 30000, lambda: loss.grad_estimate(gen, (0.4,))[0])
        assert float(torch.mean(grads)) == pytest.approx(10.0, abs=0.3)

    def test_flip_mvd(self, gen):
        @expectation
        def loss(p):
            b = flip_mvd(p)
            return torch.where(b, 4.0, 1.0)

        grads = lanes(gen, 2000, lambda: loss.grad_estimate(gen, (0.3,))[0])
        assert float(torch.mean(grads)) == pytest.approx(3.0, abs=0.1)

    def test_mv_normal_diag_reparam(self, gen):
        @expectation
        def loss(params):
            mu, sig = params
            x = mv_normal_diag_reparam(mu, sig)
            return torch.sum(x**2)

        grads = lanes(gen, 5000, lambda: loss.grad_estimate(gen, ((torch.ones(3), torch.ones(3)),)))
        mu_grads, sig_grads = grads[0]
        # dE/dmu = 2 mu = 2; dE/dsig = 2 sig = 2
        assert torch.allclose(torch.mean(mu_grads, 0), torch.tensor(2.0), atol=0.15)
        assert torch.allclose(torch.mean(sig_grads, 0), torch.tensor(2.0), atol=0.15)

    def test_beta_implicit(self, gen):
        @expectation
        def loss(ab):
            a, b = ab
            return beta_implicit(a, b)

        grads = lanes(gen, 5000, lambda: loss.grad_estimate(gen, ((2.0, 2.0),)))
        da, db = grads[0]
        # E[Beta(a, b)] = a / (a + b): d/da = 1/8, d/db = -1/8 at (2, 2)
        assert float(torch.mean(da)) == pytest.approx(0.125, abs=0.02)
        assert float(torch.mean(db)) == pytest.approx(-0.125, abs=0.02)

    def test_baseline_reduces_variance(self, gen):
        @expectation
        def plain(p):
            b = flip_reinforce(p)
            return b.to(torch.float32) + 10.0

        @expectation
        def with_baseline(p):
            b = baseline(flip_reinforce)(10.5, p)
            return b.to(torch.float32) + 10.0

        g_plain = lanes(gen, 5000, lambda: plain.grad_estimate(gen, (0.4,))[0])
        g_base = lanes(gen, 5000, lambda: with_baseline.grad_estimate(gen, (0.4,))[0])
        assert float(torch.mean(g_plain)) == pytest.approx(1.0, abs=0.4)
        assert float(torch.mean(g_base)) == pytest.approx(1.0, abs=0.2)
        assert float(torch.var(g_base)) < float(torch.var(g_plain))

    def test_add_cost(self, gen):
        @expectation
        def loss(mu):
            x = normal_reparam(mu, 1.0)
            add_cost(3.0 * mu)
            return x

        grads = lanes(gen, 1000, lambda: loss.grad_estimate(gen, (1.0,))[0])
        # E = mu + 3 mu -> 4
        assert float(torch.mean(grads)) == pytest.approx(4.0, abs=0.1)


class TestTorchIntegration:
    def test_vmapped_grad_estimate(self, gen):
        """The reference's ``jit`` case: the estimator under an outer
        transform (here the vmap of lanes) as one batched program."""

        @expectation
        def loss(mu):
            x = normal_reparam(mu, 1.0)
            return x * x

        f = torch.func.vmap(lambda _, mu: loss.grad_estimate(gen, (mu,))[0], in_dims=(0, None), randomness="different")
        grads = f(torch.zeros(3000), torch.tensor(1.0))
        assert float(torch.mean(grads)) == pytest.approx(2.0, abs=0.1)

    def test_grad_through_parameter_transform(self, gen):
        """Duals propagate through deterministic prologue code."""

        @expectation
        def loss(theta):
            mu = torch.tanh(theta)
            return normal_reparam(mu, 1.0)

        theta = 0.7
        grads = lanes(gen, 100, lambda: loss.grad_estimate(gen, (theta,))[0])
        expected = 1.0 - torch.tanh(torch.tensor(theta)) ** 2
        assert float(torch.mean(grads)) == pytest.approx(float(expected), abs=1e-4)


class TestBatchedPrimitives:
    def test_vmapped_reparam_draws_keep_strategy(self, gen):
        nr = NormalREPARAM()

        @expectation
        def loss(mu):
            xs = torch.func.vmap(lambda _: sample_primitive(nr, mu, 1.0), randomness="different")(torch.zeros(4))
            return torch.mean((xs - 2.0) ** 2)

        gs = lanes(gen, 4000, lambda: loss.grad_estimate(gen, (0.5,))[0])
        assert float(torch.mean(gs)) == pytest.approx(-3.0, abs=0.1)

    def test_vmapped_enum_raises(self, gen):
        fe = FlipEnum()

        @expectation
        def bad(p):
            bs = torch.func.vmap(lambda _: sample_primitive(fe, p).to(torch.float32), randomness="different")(
                torch.zeros(3)
            )
            return torch.mean(bs)

        with pytest.raises(NotImplementedError):
            bad.grad_estimate(gen, (0.4,))


class TestKeyDiscipline:
    def test_consecutive_reparam_draws_are_independent(self, gen):
        @expectation
        def loss(mu):
            x = normal_reparam(mu, 1.0)
            y = normal_reparam(0.0, 1.0)
            return x - y

        ests = lanes(gen, 2000, lambda: loss.estimate(gen, (1.5,)))
        assert float(torch.mean(ests)) == pytest.approx(1.5, abs=0.1)
        # var(x - y) = 2: identical noise would make every estimate mu
        assert float(torch.std(ests)) == pytest.approx(2.0**0.5, abs=0.1)

    def test_branch_and_continuation_draws_independent(self, gen):
        @expectation
        def loss(p):
            b = flip_enum(p)
            inner = torch.where(b, normal_reparam(0.0, 1.0), normal_reparam(0.0, 1.0))
            after = normal_reparam(0.0, 1.0)
            return inner * after

        # E[inner * after] = 0 only if the draws are independent
        ests = lanes(gen, 4000, lambda: loss.estimate(gen, (0.5,)))
        assert float(torch.mean(ests)) == pytest.approx(0.0, abs=0.06)


class TestPureContinuationSemantics:
    def test_add_cost_downstream_of_flip_mvd(self, gen):
        # E[1{b} + c] has d/dp = 1 whatever the constant cost c
        @expectation
        def loss(p):
            b = flip_mvd(p)
            add_cost(10.0)
            return torch.where(b, 1.0, 0.0)

        grads = lanes(gen, 2000, lambda: loss.grad_estimate(gen, (0.3,))[0])
        assert float(torch.mean(grads)) == pytest.approx(1.0, abs=0.05)

    def test_add_cost_downstream_of_flip_enum(self, gen):
        @expectation
        def loss(p):
            b = flip_enum(p)
            add_cost(2.0 * p)
            return torch.where(b, 2.0, 1.0)

        g = loss.grad_estimate(gen, (0.4,))[0]
        assert float(g) == pytest.approx(1.0 + 2.0, abs=1e-5)

    def test_estimate_with_array_args(self, gen):
        @expectation
        def loss(ps):
            x = normal_reparam(torch.sum(ps), 1.0)
            return x * x

        val = loss.estimate(gen, (torch.tensor([0.5, 0.2]),))
        assert val.shape == ()
        assert bool(torch.isfinite(val))

    def test_flip_mvd_upstream_of_vmapped_reparam(self, gen):
        @expectation
        def loss(p, mus):
            b = flip_mvd(p)
            xs = torch.func.vmap(lambda m: sample_primitive(NormalREPARAM(), m, 1.0), randomness="different")(mus)
            return torch.where(b, torch.sum(xs), 0.0)

        g = loss.grad_estimate(gen, (0.5, torch.zeros(4)))
        assert all(bool(torch.all(torch.isfinite(x))) for x in g)


def test_baseline_unbiased_with_kpure_strategy(gen):
    """Baseline shifts the PURE continuation too (the exact derivative of
    E[where(b, 3, 1)] in p is 2)."""
    based = baseline(flip_mvd)

    @expectation
    def loss(p):
        b = based(5.0, p)
        return torch.where(b, 3.0, 1.0)

    grads = lanes(gen, 4000, lambda: loss.grad_estimate(gen, (0.3,))[0])
    assert float(torch.mean(grads)) == pytest.approx(2.0, abs=0.1)


# ---------------------------------------------------------------------
# the exact strategies against the reference's own estimates
# ---------------------------------------------------------------------


def _ref_enum(p):
    @RA.expectation
    def loss(p):
        b = RA.flip_enum(p)
        RA.add_cost(2.0 * p * p)
        return jax.lax.cond(b, lambda: RA.normal_reparam(2.0, 0.0), lambda: -1.5)

    return loss


def _port_enum(p):
    @expectation
    def loss(p):
        b = flip_enum(p)
        add_cost(2.0 * p * p)
        return torch.where(b, normal_reparam(2.0, 0.0), -1.5)

    return loss


@pytest.mark.parametrize("p", [0.2, 0.55, 0.9])
def test_enumeration_estimates_match_reference(p, gen):
    ref = _ref_enum(p)
    port = _port_enum(p)
    key = jax.random.key(0)
    (rg,) = ref.grad_estimate(key, (p,))
    (pg,) = port.grad_estimate(gen, (p,))
    assert float(pg) == pytest.approx(float(rg), rel=1e-6)
    assert float(port.estimate(gen, (p,))) == pytest.approx(float(ref.estimate(key, (p,))), rel=1e-6)
    rd = ref.jvp_estimate(key, (RA.Dual(jnp.float32(p), jnp.float32(1.0)),))
    pd = port.jvp_estimate(gen, (Dual(p, 1.0),))
    assert float(pd.tangent) == pytest.approx(float(rd.tangent), rel=1e-6)


def test_categorical_enumeration_matches_reference(gen):
    logits = [0.3, -1.0, 2.0, 0.5]

    @RA.expectation
    def ref(lg):
        i = RA.categorical_enum_parallel(lg)
        return jnp.sin(jnp.asarray(i, jnp.float32)) * jnp.sum(lg)

    @expectation
    def port(lg):
        i = categorical_enum_parallel(lg)
        return torch.sin(i.to(torch.float32)) * torch.sum(lg)

    (rg,) = ref.grad_estimate(jax.random.key(0), (jnp.asarray(logits, jnp.float32),))
    (pg,) = port.grad_estimate(gen, (torch.tensor(logits),))
    torch.testing.assert_close(pg, torch.tensor(np.asarray(rg)), rtol=1e-6, atol=1e-6)


def test_mvd_on_a_deterministic_continuation_is_exact(gen):
    """``flip_mvd`` on ``where(b, 4, 1)``: every estimate is the
    difference 3, at either draw, as the reference's."""

    @expectation
    def loss(p):
        return torch.where(flip_mvd(p), 4.0, 1.0)

    grads = lanes(gen, 64, lambda: loss.grad_estimate(gen, (0.3,))[0])
    assert torch.all(grads == 3.0)

    @RA.expectation
    def ref(p):
        return jnp.where(RA.flip_mvd(p), 4.0, 1.0)

    rg = jax.vmap(lambda k: ref.grad_estimate(k, (0.3,))[0])(jax.random.split(jax.random.key(0), 8))
    assert bool(jnp.all(rg == 3.0))


def test_sample_primitive_outside_a_transform_samples():
    gen = torch.Generator().manual_seed(0)
    x = normal_reparam(torch.zeros(20000), 2.0, gen=gen)
    assert float(x.std()) == pytest.approx(2.0, rel=0.03)
    with pytest.raises(ValueError, match="generator"):
        normal_reparam(0.0, 1.0)
