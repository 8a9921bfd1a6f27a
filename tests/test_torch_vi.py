"""The port's variational inference against ``genjax_tpu/inference/vi.py``.

The cases of ``tests/inference/test_vi.py`` (convergence of the guide's mean
and scale under ``ELBO``, ``IWELBO``'s mean, finite wake gradients, an
enumerated discrete guide) with the reference's tolerances; the wrapped
guide distributions' log-densities against the reference's (rtol 1e-6);
``fit``'s Adam against ``optax.adam`` on the same deterministic gradient
(rtol 1e-5 over 50 steps); and ``bench.py::bench_vi``'s program: the mean
of 4,096 ELBO gradient estimates at its start within 5 standard errors of
the exact gradient, computed in float64 from the closed form.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import _one_thread  # noqa: F401

import genjax_tpu.inference.vi as RV
import genjax_tpu_torch as g
from genjax_tpu_torch.core.pytree import Const
from genjax_tpu_torch.inference import Target, vi
from genjax_tpu_torch.inference.sp import Marginal


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(314159)


def make_guide(gen_fn):
    return Marginal(gen_fn, Const(g.Selection.all()), Const(None))


def batched_grad(grad_estimate, gen, n):
    f = torch.func.vmap(lambda _, phi: grad_estimate(gen, (phi,))[0], in_dims=(0, None), randomness="different")
    return lambda phi: torch.mean(f(torch.zeros(n), phi), dim=0)


class TestELBO:
    def test_normal_normal_mean_convergence(self, gen):
        @g.gen
        def model(v):
            mu = g.normal(0.0, 10.0) @ "mu"
            _ = g.normal(mu, 0.1) @ "v"

        @g.gen
        def guide_fn(target):
            (v,) = target.args
            _ = vi.normal_reparam(v, 0.1) @ "mu"

        elbo_grad = vi.ELBO(make_guide(guide_fn), lambda v: Target(model, (v,), g.C["v"].set(3.0)))
        v = torch.tensor(0.1)
        for _ in range(200):
            (v_grad,) = elbo_grad(gen, (v,))
            v = v - 1e-3 * v_grad
        assert float(v) == pytest.approx(3.0, rel=5e-2)

    def test_posterior_mean_and_scale(self, gen):
        """Both the guide's mean and its scale reach the conjugate
        posterior (the entropy term)."""

        @g.gen
        def model(phi):
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        @g.gen
        def guide_fn(target):
            phi = target.args[0]
            _ = vi.normal_reparam(phi[0], torch.nn.functional.softplus(phi[1])) @ "mu"

        elbo_grad = vi.ELBO(make_guide(guide_fn), lambda phi: Target(model, (phi,), g.C["y"].set(2.0)))
        step = batched_grad(elbo_grad, gen, 32)
        phi = torch.zeros(2)
        for _ in range(400):
            phi = phi - 0.05 * step(phi)
        # posterior: N(1, 1 / sqrt(2))
        assert float(phi[0]) == pytest.approx(1.0, abs=0.1)
        assert float(torch.nn.functional.softplus(phi[1])) == pytest.approx(0.7071, abs=0.1)


class TestIWELBO:
    def test_gradient_is_finite_and_converges_mean(self, gen):
        @g.gen
        def model(phi):
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        @g.gen
        def guide_fn(target):
            phi = target.args[0]
            _ = vi.normal_reparam(phi[0], torch.nn.functional.softplus(phi[1])) @ "mu"

        iwelbo_grad = vi.IWELBO(make_guide(guide_fn), lambda phi: Target(model, (phi,), g.C["y"].set(2.0)), N=5)
        step = batched_grad(iwelbo_grad, gen, 16)
        phi = torch.zeros(2)
        for _ in range(200):
            phi = phi - 0.05 * step(phi)
        assert float(phi[0]) == pytest.approx(1.0, abs=0.2)


class TestWakeSleep:
    def test_pwake_qwake_gradients_finite(self, gen):
        @g.gen
        def model(phi):
            mu = g.normal(phi[0], 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        @g.gen
        def guide_fn(target):
            phi = target.args[0]
            _ = vi.normal_reparam(phi[1], 1.0) @ "mu"

        guide = make_guide(guide_fn)
        make_target = lambda phi: Target(model, (phi,), g.C["y"].set(2.0))  # noqa: E731
        phi = torch.tensor([0.0, 0.5])
        (gp,) = vi.PWake(guide, make_target)(gen, (phi,))
        (gq,) = vi.QWake(guide, guide, make_target)(gen, (phi,))
        assert bool(torch.all(torch.isfinite(gp))) and bool(torch.all(torch.isfinite(gq)))

    def test_pwake_gradient_in_law(self, gen):
        """d/dphi0 of -E_{mu ~ N(phi1, 1)}[log N(mu; phi0, 1)] = phi0 -
        phi1, and the guide's parameter gets none."""

        @g.gen
        def model(phi):
            mu = g.normal(phi[0], 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        @g.gen
        def guide_fn(target):
            phi = target.args[0]
            _ = vi.normal_reparam(phi[1], 1.0) @ "mu"

        pwake = vi.PWake(make_guide(guide_fn), lambda phi: Target(model, (phi,), g.C["y"].set(2.0)))
        phi = torch.tensor([0.3, 1.5])
        gs = torch.func.vmap(lambda _: pwake(gen, (phi,))[0], randomness="different")(torch.zeros(4000))
        assert float(gs[:, 0].mean()) == pytest.approx(0.3 - 1.5, abs=5 * float(gs[:, 0].std()) / math.sqrt(4000))

    def test_qwake_gradient_vanishes_for_its_own_guide(self, gen):
        """With the guide as its own posterior approximation, ``mu = phi1 +
        eps`` scores ``log N(eps; 0, 1)`` whatever ``phi``: every QWake
        estimate is exactly 0, as the reference's."""

        @g.gen
        def model(phi):
            mu = g.normal(phi[0], 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        @g.gen
        def guide_fn(target):
            phi = target.args[0]
            _ = vi.normal_reparam(phi[1], 1.0) @ "mu"

        guide = make_guide(guide_fn)
        qwake = vi.QWake(guide, guide, lambda phi: Target(model, (phi,), g.C["y"].set(2.0)))
        phi = torch.tensor([0.3, 1.5])
        gs = torch.func.vmap(lambda _: qwake(gen, (phi,))[0], randomness="different")(torch.zeros(64))
        assert torch.all(gs == 0.0)


class TestEnumGuides:
    def test_flip_enum_guide_distribution(self, gen):
        @g.gen
        def model(phi):
            b = g.flip(0.5) @ "b"
            _ = g.normal(torch.where(b, 2.0, -2.0), 0.5) @ "y"

        @g.gen
        def guide_fn(target):
            phi = target.args[0]
            _ = vi.flip_enum(torch.sigmoid(phi)) @ "b"

        elbo_grad = vi.ELBO(make_guide(guide_fn), lambda phi: Target(model, (phi,), g.C["y"].set(2.0)))
        phi = torch.tensor(0.0)
        for _ in range(150):
            (grad,) = elbo_grad(gen, (phi,))
            phi = phi - 0.5 * grad
        # the observation strongly supports b = True
        assert float(torch.sigmoid(phi)) > 0.95


# ---------------------------------------------------------------------
# the wrapped guide distributions and the optimizer
# ---------------------------------------------------------------------

GUIDES = {
    "flip_enum": (np.float32(1.0), (np.float32(0.3),)),
    "flip_mvd": (np.float32(0.0), (np.float32(0.3),)),
    "flip_reinforce": (np.float32(1.0), (np.float32(0.7),)),
    "categorical_enum": (np.int32(2), (np.asarray([0.1, -0.4, 1.2], np.float32),)),
    "normal_reinforce": (np.float32(0.4), (np.float32(0.5), np.float32(1.5))),
    "normal_reparam": (np.float32(-0.4), (np.float32(0.5), np.float32(1.5))),
    "mv_normal_diag_reparam": (
        np.asarray([0.3, -1.0], np.float32),
        (np.asarray([0.0, 1.0], np.float32), np.asarray([1.0, 2.0], np.float32)),
    ),
    "geometric_reinforce": (np.float32(3.0), (np.float32(0.3),)),
    "beta_implicit": (np.float32(0.35), (np.float32(2.0), np.float32(3.0))),
}


@pytest.mark.parametrize("name", sorted(GUIDES))
def test_guide_distribution_logpdf_matches_reference(name, gen):
    v, args = GUIDES[name]
    ref = float(getattr(RV, name).logpdf(jnp.asarray(v), *args))
    got = getattr(vi, name).logpdf(torch.as_tensor(v), *(torch.as_tensor(a) for a in args))
    assert float(got) == pytest.approx(ref, rel=1e-6, abs=1e-6)
    # outside a transform the guide distribution samples from its generator
    tr = getattr(vi, name).simulate(gen, tuple(torch.as_tensor(a) for a in args))
    assert bool(torch.isfinite(tr.get_score()))


def test_fit_matches_optax_adam():
    target = np.asarray([1.0, -2.0, 0.5], np.float32)
    scale = np.asarray([3.0, 0.5, 1.0], np.float32)

    def grad_estimate(gen, args):
        (phi,) = args
        return (torch.as_tensor(scale) * (phi - torch.as_tensor(target)),)

    got = vi.fit(grad_estimate, torch.zeros(3), gen=torch.Generator().manual_seed(0), n_steps=50, learning_rate=0.05)
    opt = optax.adam(0.05)
    phi = jnp.zeros(3)
    state = opt.init(phi)
    for _ in range(50):
        updates, state = opt.update(jnp.asarray(scale) * (phi - jnp.asarray(target)), state)
        phi = optax.apply_updates(phi, updates)
    np.testing.assert_allclose(got.numpy(), np.asarray(phi), rtol=1e-5, atol=1e-6)


def test_fit_drives_the_elbo(gen):
    @g.gen
    def model(phi):
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 1.0) @ "y"

    @g.gen
    def guide_fn(target):
        phi = target.args[0]
        _ = vi.normal_reparam(phi[0], torch.exp(phi[1])) @ "mu"

    elbo_grad = vi.ELBO(make_guide(guide_fn), lambda phi: Target(model, (phi,), g.C["y"].set(2.0)))
    phi = vi.fit(elbo_grad, torch.zeros(2), gen=gen, n_steps=300, learning_rate=0.05, batch_size=16)
    assert float(phi[0]) == pytest.approx(1.0, abs=0.1)
    assert float(torch.exp(phi[1])) == pytest.approx(0.7071, abs=0.1)


# ---------------------------------------------------------------------
# bench.py::bench_vi's program
# ---------------------------------------------------------------------


def mixture_vi():
    """``bench.py::bench_vi``: a two-component mixture with ``y = 1.5``
    observed, the guide REINFORCE on ``z`` and reparameterized on ``mu``."""

    @g.gen
    def model_fn(phi):
        z = g.flip(0.5) @ "z"
        mu = g.normal(torch.where(z, 2.0, -2.0), 1.0) @ "mu"
        _ = g.normal(mu, 0.5) @ "y"

    @g.gen
    def guide_fn(target):
        (phi,) = target.args
        z = vi.flip_reinforce(torch.sigmoid(phi[0])) @ "z"
        zf = z.to(torch.float32)
        m = zf * phi[1] + (1.0 - zf) * phi[3]
        s = torch.exp(zf * phi[2] + (1.0 - zf) * phi[4])
        _ = vi.normal_reparam(m, s) @ "mu"

    return vi.ELBO(make_guide(guide_fn), lambda phi: Target(model_fn, (phi,), g.C["y"].set(1.5)))


def exact_neg_elbo(phi, y=1.5, sigma=0.5):
    """The negative ELBO of ``mixture_vi`` and its gradient in float64:
    ``z`` enumerated, every ``mu`` term a Gaussian expectation."""
    phi = np.asarray(phi, np.float64)
    q1 = 1.0 / (1.0 + np.exp(-phi[0]))
    q = {1: q1, 0: 1.0 - q1}
    m = {1: phi[1], 0: phi[3]}
    s = {1: np.exp(phi[2]), 0: np.exp(phi[4])}
    c = {1: 2.0, 0: -2.0}
    half_log_2pi = 0.5 * math.log(2 * math.pi)

    def f(z):  # E_{mu ~ N(m, s)}[log p(z, mu, y) - log q(mu | z)]
        return (
            math.log(0.5)
            - half_log_2pi
            - 0.5 * ((m[z] - c[z]) ** 2 + s[z] ** 2)
            - 0.5 * math.log(2 * math.pi * sigma**2)
            - 0.5 * ((y - m[z]) ** 2 + s[z] ** 2) / sigma**2
            + half_log_2pi
            + 0.5
            + math.log(s[z])
        )

    elbo = sum(q[z] * (f(z) - math.log(q[z])) for z in (0, 1))
    dm = {z: -(m[z] - c[z]) + (y - m[z]) / sigma**2 for z in (0, 1)}
    ds = {z: 1.0 - s[z] ** 2 * (1.0 + 1.0 / sigma**2) for z in (0, 1)}
    grad = np.array(
        [
            q[1] * q[0] * (f(1) - f(0) + math.log(q[0]) - math.log(q[1])),
            q[1] * dm[1],
            q[1] * ds[1],
            q[0] * dm[0],
            q[0] * ds[0],
        ]
    )
    return -elbo, -grad


def test_bench_vi_gradient_matches_closed_form(gen):
    elbo_grad = mixture_vi()
    phi0 = torch.tensor([0.0, 1.0, -1.0, -1.0, -1.0])
    f = torch.func.vmap(lambda _, phi: elbo_grad(gen, (phi,))[0], in_dims=(0, None), randomness="different")
    gs = f(torch.zeros(4096), phi0).double().numpy()
    _, exact = exact_neg_elbo(phi0.numpy())
    se = gs.std(0) / math.sqrt(gs.shape[0])
    np.testing.assert_array_less(np.abs(gs.mean(0) - exact), 5 * se)
    # and the reference's own estimator agrees in law at the same point
    ref = jax.vmap(lambda k: _reference_mixture_grad()(k, (jnp.asarray(phi0.numpy()),))[0])(
        jax.random.split(jax.random.key(0), 4096)
    )
    ref = np.asarray(ref, np.float64)
    np.testing.assert_array_less(np.abs(ref.mean(0) - exact), 5 * ref.std(0) / math.sqrt(4096))


def _reference_mixture_grad():
    import genjax_tpu as gj
    from genjax_tpu.inference import Target as RTarget
    from genjax_tpu.inference.sp import Marginal as RMarginal

    @gj.gen
    def model_fn(phi):
        z = gj.flip(0.5) @ "z"
        mu = gj.normal(jnp.where(z, 2.0, -2.0), 1.0) @ "mu"
        _ = gj.normal(mu, 0.5) @ "y"

    @gj.gen
    def guide_fn(target):
        (phi,) = target.args
        z = RV.flip_reinforce(jax.nn.sigmoid(phi[0])) @ "z"
        zf = jnp.asarray(z, jnp.float32)
        _ = RV.normal_reparam(zf * phi[1] + (1.0 - zf) * phi[3], jnp.exp(zf * phi[2] + (1.0 - zf) * phi[4])) @ "mu"

    guide = RMarginal(guide_fn, gj.Pytree.const(gj.Selection.all()), gj.Pytree.const(None))
    return RV.ELBO(guide, lambda phi: RTarget(model_fn, (phi,), gj.C["y"].set(1.5)))


def test_bench_vi_descent_lowers_the_exact_loss(gen):
    elbo_grad = mixture_vi()
    step = batched_grad(elbo_grad, gen, 256)
    phi = torch.tensor([0.0, 1.0, -1.0, -1.0, -1.0])
    start, _ = exact_neg_elbo(phi.numpy())
    for _ in range(100):
        phi = phi - 0.05 * step(phi)
    end, _ = exact_neg_elbo(phi.numpy())
    assert end < start - 1.0
