"""The mixture models (``models/mixture.py``) and ``logistic_regression``
against ``genjax_tpu``, and the DP mixture under inference.

``assess`` of the same choices (simulated by the port, carried across node
for node) to 1e-5: ``gaussian_mixture_model(3)`` and ``dp_mixture_model(8)``
on 20 points, ``logistic_regression`` on 12 points of 3 features; the
weights of a vmapped ``generate`` under the observed ``x`` against ``sum_i
log N(x_i; means[z_i], 0.5)`` in float64 to rel 1e-5. The
counterpart of ``tests/inference/test_dp_mixture.py`` (SMC initialisation,
then per-point assignment MH and HMC on the means recover two clusters):
cut from 100 sweeps to 15, the same gate (over 90% of points within 1 of
their assigned mean). ``bench.py::bench_dp``'s tempered SMC at a tenth of its
particles: a finite evidence, the particles' leaves all of one length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.models import dp_mixture_model as ref_dp
from genjax_tpu.models import gaussian_mixture_model as ref_gmm
from genjax_tpu.models import logistic_regression as ref_logistic
from genjax_tpu_torch.inference import ImportanceK, Target, geometric_ladder, tempered_smc
from genjax_tpu_torch.models import dp_mixture_model, gaussian_mixture_model, logistic_regression
from torch_chm_bridge import to_jax
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (np.array([-4.0, 0.0, 4.0])[rng.integers(0, 3, n)] + 0.4 * rng.normal(size=n)).astype(np.float32)


def _close(a, b):
    assert abs(float(a) - float(b)) <= TOL * (1 + abs(float(b))), (float(a), float(b))


@pytest.mark.parametrize("name", ["gmm", "dp"])
def test_mixture_assess_matches_reference(name):
    data = _data(20)
    model, ref_model = ((gaussian_mixture_model(3), ref_gmm(3)) if name == "gmm"
                        else (dp_mixture_model(8), ref_dp(8)))
    args, ref_args = (torch.from_numpy(data),), (jnp.asarray(data),)
    for seed in range(3):
        tr = model.simulate(torch.Generator().manual_seed(seed), args)
        score, _ = model.assess(tr.get_choices(), args)
        ref_score, _ = ref_model.assess(to_jax(tr.get_choices()), ref_args)
        _close(score, ref_score)
        _close(tr.get_score(), ref_score)
    obs = g.C["obs", :, "x"].set(torch.from_numpy(data))
    gen = torch.Generator().manual_seed(0)
    trs, ws = torch.func.vmap(lambda _: model.generate(gen, obs, args), randomness="different")(torch.zeros(4))
    chm = trs.get_choices()
    means = chm["means"].double().numpy()
    zs = chm["obs", :, "z"].numpy()
    xs = chm["obs", :, "x"].double().numpy()
    np.testing.assert_array_equal(xs, np.broadcast_to(data, xs.shape))
    mu = np.take_along_axis(means, zs, axis=1)
    want = (-0.5 * np.log(2 * np.pi * 0.25) - (data[None, :] - mu) ** 2 / 0.5).sum(1)
    np.testing.assert_allclose(ws.double().numpy(), want, rtol=TOL)


def test_logistic_regression_assess_matches_reference():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(12, 3)).astype(np.float32)
    model, ref_model = logistic_regression(X), ref_logistic(X)
    for seed in range(3):
        tr = model.simulate(torch.Generator().manual_seed(seed), ())
        ref_score, ref_probs = ref_model.assess(to_jax(tr.get_choices()), ())
        _close(model.assess(tr.get_choices(), ())[0], ref_score)
        np.testing.assert_allclose(tr.get_retval().numpy(), np.asarray(ref_probs), rtol=1e-5)
    y01 = torch.from_numpy(rng.integers(0, 2, 12).astype(np.float32))
    _, w = model.generate(torch.Generator().manual_seed(0), g.C["obs", :, "y"].set(y01), ())
    assert torch.isfinite(w)


K, N_DATA, SIGMA_OBS = 6, 30, 0.4


@g.gen
def _obs_point(i, weights, means):
    z = g.categorical(torch.log(weights + 1e-37)) @ "z"
    return g.normal(means[z], SIGMA_OBS) @ "x"


_obs = _obs_point.vmap(in_axes=(0, None, None))


@g.gen
def dp_mixture(data):
    sticks = []
    rest = torch.ones(())
    for i in range(K - 1):
        b = g.beta(1.0, 2.0) @ f"beta_{i}"
        sticks.append(rest * b)
        rest = rest * (1.0 - b)
    means = g.mv_normal_diag(torch.zeros(K), 3.0 * torch.ones(K)) @ "means"
    _ = _obs(torch.arange(data.shape[0]), torch.stack([*sticks, rest]), means) @ "obs"


def test_cluster_recovery():
    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        (np.array([-3.0, 3.0])[rng.integers(0, 2, N_DATA)] + 0.3 * rng.normal(size=N_DATA)).astype(np.float32))
    target = Target(dp_mixture, (data,), g.C["obs", :, "x"].set(data))
    collection = ImportanceK(target, k_particles=256).run_smc(0, device="cpu")
    assert torch.isfinite(collection.get_log_marginal_likelihood_estimate())
    gen = torch.Generator().manual_seed(2)
    tr = collection.sample_particle(gen)
    for _ in range(15):
        for i in range(N_DATA):
            tr, _ = g.mh(gen, tr, g.S["obs", i, "z"])
        tr, _ = g.mh(gen, tr, g.HMC(g.S["means"], 0.05, L=5))
    means, zs = tr.get_choices()["means"], tr.get_choices()["obs", :, "z"]
    assert float(((means[zs] - data).abs() < 1.0).float().mean()) > 0.9


def test_bench_dp_shape_runs():
    data = torch.from_numpy(_data(60))
    res = tempered_smc(0, dp_mixture_model(8), g.C["obs", :, "x"].set(data), (data,), n_particles=409,
                       betas=geometric_ladder(10), device="cpu")
    assert torch.isfinite(res.log_marginal) and tuple(res.ess_history.shape) == (10,)
    lengths = {v.shape[0] for v in torch.utils._pytree.tree_leaves(res.traces) if isinstance(v, torch.Tensor)}
    assert lengths == {409}
    assert tuple(res.traces.get_choices()["obs", :, "z"].shape) == (409, 60)
