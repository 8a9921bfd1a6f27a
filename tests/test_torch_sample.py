"""The port's one-call driver ``sample_posterior`` and its diagnostics.

``split_rhat`` and ``ess`` are deterministic: the port and
``genjax_tpu.inference.diagnostics`` see the same numpy draws and agree to
rtol 1e-5 (both in float32, summed in different orders). ``ess``'s
``truncated`` flag is the reference's negated (a deviation: the reference's
flag means the opposite of its name). ``sample_posterior`` draws from a
``torch.Generator``, so it is held in law against the conjugate closed form
of ``tests/inference/test_sample_posterior.py``; each limit is stated beside
its check. The warmup contract (windows totalling exactly ``n_warmup``) is
counted, not sampled.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu.inference import diagnostics as ref_diag
from genjax_tpu.inference.sample import _column_diagnostics as ref_column_diagnostics
from genjax_tpu_torch.inference import diagnostics, sample
from genjax_tpu_torch.inference.requests.grad_view import split_ravel
from genjax_tpu_torch.inference.sample import sample_posterior

RTOL = 1e-5


def _ar1(rng, n_chains, n, rho):
    eps = rng.normal(size=(n_chains, n))
    x = np.zeros((n_chains, n))
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + np.sqrt(1 - rho**2) * eps[:, t]
    return x


def _regimes():
    rng = np.random.default_rng(0)
    return {
        "iid": rng.normal(size=(4, 500)),
        "ar1": _ar1(rng, 4, 800, 0.9),
        "stuck": np.asarray([-10.0, -10.0, 10.0, 10.0])[:, None] + 0.05 * rng.normal(size=(4, 400)),
        "drift": np.linspace(0.0, 4.0, 600)[None, :] + 0.05 * rng.normal(size=(4, 600)),
        "odd": rng.normal(size=(3, 101)),
        "one_draw": rng.normal(size=(3, 1)),
        "two_draws": rng.normal(size=(5, 2)),
    }


REGIMES = _regimes()


@pytest.mark.parametrize("max_lag", [None, 1, 4, 64, 512])
@pytest.mark.parametrize("name", sorted(REGIMES))
def test_ess_matches_reference(name, max_lag):
    x = REGIMES[name].astype(np.float32)
    out, (tau, truncated) = diagnostics.ess(torch.from_numpy(x), max_lag, return_tau=True)
    r_out, (r_tau, r_flag) = ref_diag.ess(jnp.asarray(x), max_lag, return_tau=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=RTOL)
    np.testing.assert_allclose(tau.numpy(), np.asarray(r_tau), rtol=RTOL)
    # the deviation: the reference's flag is True when the sum stopped
    # inside the budget, the port's when the budget cut it short
    assert bool(truncated) == (not bool(r_flag))
    assert out.dtype == torch.float32 and tau.dtype == torch.float32


@pytest.mark.parametrize("name", sorted(set(REGIMES) - {"one_draw", "two_draws"}))
def test_split_rhat_matches_reference(name):
    x = REGIMES[name].astype(np.float32)
    np.testing.assert_allclose(
        diagnostics.split_rhat(torch.from_numpy(x)).numpy(),
        np.asarray(ref_diag.split_rhat(jnp.asarray(x))),
        rtol=RTOL,
    )


def test_diagnostics_batch_over_trailing_axes():
    """Draws ``(chains, draws, 2, 3)`` give one value an element, each the
    reference's on that element's ``(chains, draws)`` slice."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(4, 60, 2, 3)) + np.arange(6).reshape(2, 3)).astype(np.float32)
    x[:, :, 1, 2] += np.linspace(0.0, 3.0, 60)[None, :]  # one drifting element
    e, (tau, truncated) = diagnostics.ess(torch.from_numpy(x), 16, return_tau=True)
    r = diagnostics.split_rhat(torch.from_numpy(x))
    assert e.shape == tau.shape == truncated.shape == r.shape == (2, 3)
    for i in range(2):
        for j in range(3):
            xs = jnp.asarray(x[:, :, i, j])
            r_e, (r_tau, r_flag) = ref_diag.ess(xs, 16, return_tau=True)
            np.testing.assert_allclose(float(e[i, j]), float(r_e), rtol=RTOL)
            np.testing.assert_allclose(float(tau[i, j]), float(r_tau), rtol=RTOL)
            assert bool(truncated[i, j]) == (not bool(r_flag))
            np.testing.assert_allclose(float(r[i, j]), float(ref_diag.split_rhat(xs)), rtol=RTOL)


@pytest.mark.parametrize("n_samples", [2, 30, 100])
def test_column_diagnostics_match_reference(n_samples):
    """``_column_diagnostics`` of a ``(chains, samples, dim)`` block, with
    its lag budget ``min(n_samples - 1, 64)``."""
    rng = np.random.default_rng(n_samples)
    x = np.concatenate([
        rng.normal(size=(8, n_samples, 2)),
        _ar1(rng, 8, n_samples, 0.7)[:, :, None],
    ], axis=2).astype(np.float32)
    rhat, e = sample._column_diagnostics(torch.from_numpy(x), n_samples)
    r_rhat, r_e = ref_column_diagnostics(jnp.asarray(x), n_samples)
    np.testing.assert_allclose(e.numpy(), np.asarray(r_e), rtol=RTOL)
    np.testing.assert_allclose(rhat.numpy(), np.asarray(r_rhat), rtol=RTOL)  # NaN at 2 samples


def test_column_diagnostics_of_one_sample():
    """One sample a chain: ESS is the draw count (tau = 1), as the
    reference's ``ess``; split-R̂ has no halves and is NaN, where the
    reference's ``split_rhat`` divides by zero."""
    x = np.random.default_rng(1).normal(size=(8, 1, 3)).astype(np.float32)
    rhat, e = sample._column_diagnostics(torch.from_numpy(x), 1)
    for k in range(3):
        assert float(e[k]) == float(ref_diag.ess(jnp.asarray(x[:, :, k]), max_lag=0)) == 8.0
    assert bool(torch.isnan(rhat).all())


# ----------------------------------------------------------------------
# sample_posterior on the conjugate model: mu ~ N(0, 1), y ~ N(mu, 1), y = 2
# ----------------------------------------------------------------------


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


OBS = g.C["y"].set(2.0)  # posterior N(1, 1/2)
ALG_KW = {"nuts": dict(max_depth=4), "hmc": dict(L=8), "hmc_sweep": dict(L=8)}


def _run(algorithm, **kw):
    kw = {**dict(n_chains=256, n_warmup=30, n_samples=30, eps0=0.02, device="cpu"),
          **ALG_KW[algorithm], **kw}
    return sample_posterior(0, conjugate, OBS, (), g.S["mu"], algorithm=algorithm, **kw)


@pytest.mark.parametrize("algorithm", ["nuts", "hmc", "hmc_sweep"])
def test_conjugate_recovery_with_adaptation(algorithm):
    res = _run(algorithm)
    assert tuple(res["mu"].shape) == (256, 30)
    draws = res["mu"][:, -15:]
    # 256 x 15 draws of N(1, 1/2): the mean's MC error is about 0.02
    assert abs(float(draws.mean()) - 1.0) < 0.1
    assert abs(float(draws.std()) - 1.0 / np.sqrt(2.0)) < 0.1
    assert float(res.eps) > 0.1  # adaptation moved eps from 0.02
    assert abs(float(res.rhat_of("mu")) - 1.0) < 0.15
    assert float(res.ess_of("mu")) > 100.0
    assert 0.5 < float(res.accept_rate) <= 1.0
    assert float(res.divergence_rate) == 0.0
    assert res.inv_mass.shape == (1,) and float(res.inv_mass[0]) != 1.0


def _count_transitions(monkeypatch, algorithm):
    """Wrap the driver's transition (trace path) or sweep launch
    (``hmc_sweep``): returns the list of transitions each call made."""
    calls = []
    if algorithm == "hmc_sweep":
        real = sample.pallas_hmc

        def counted(*args, n_steps, **kw):
            calls.append(n_steps)
            return real(*args, n_steps=n_steps, **kw)

        monkeypatch.setattr(sample, "pallas_hmc", counted)
    else:
        real_step = sample._trace_step

        def counted_step(*args, **kw):
            step = real_step(*args, **kw)

            def one(*a):
                calls.append(1)
                return step(*a)

            return one

        monkeypatch.setattr(sample, "_trace_step", counted_step)
    return calls


@pytest.mark.parametrize("n_warmup", [0, 1, 5, 7, 13])
@pytest.mark.parametrize("algorithm", ["hmc", "hmc_sweep"])
def test_warmup_budget_is_exactly_n_warmup(algorithm, n_warmup, monkeypatch):
    """Up to 6 windows totalling exactly ``n_warmup`` transitions, then
    ``n_samples`` draws of ``thin`` transitions each."""
    calls = _count_transitions(monkeypatch, algorithm)
    n_samples, thin = 3, 2
    _run(algorithm, n_chains=16, n_warmup=n_warmup, n_samples=n_samples, thin=thin, L=2)
    assert sum(calls) == n_warmup + n_samples * thin
    if algorithm == "hmc_sweep":
        windows = calls[: len(calls) - n_samples]
        assert len(windows) == min(6, n_warmup) and max(windows, default=0) - min(windows, default=0) <= 1
        assert calls[len(windows):] == [thin] * n_samples


def test_nuts_warmup_budget_is_exactly_n_warmup(monkeypatch):
    calls = _count_transitions(monkeypatch, "nuts")
    _run("nuts", n_chains=8, n_warmup=8, n_samples=2, thin=3, max_depth=2)
    assert sum(calls) == 8 + 2 * 3


@pytest.mark.parametrize("algorithm", ["nuts", "hmc", "hmc_sweep"])
def test_zero_warmup_keeps_caller_settings(algorithm):
    res = _run(algorithm, n_chains=32, n_warmup=0, n_samples=5, eps0=0.237, L=3, max_depth=3)
    assert float(res.eps) == pytest.approx(0.237)
    assert bool((res.inv_mass == 1.0).all())


@pytest.mark.parametrize("algorithm", ["nuts", "hmc_sweep"])
def test_zero_samples_raises_before_warmup(algorithm, monkeypatch):
    calls = _count_transitions(monkeypatch, algorithm)
    with pytest.raises(ValueError, match="n_samples must be >= 1"):
        _run(algorithm, n_samples=0)
    assert calls == []


def test_vector_address_positions_and_diagnostics():
    """``PosteriorSamples[addr]`` is ``(n_chains, n_samples, *event)``, and
    ``rhat``/``ess`` carry one value an element, on the selection's
    addresses; the anisotropic scales come back through the adapted mass."""
    scales = torch.tensor([0.2, 2.0])

    @g.gen
    def model():
        a = g.normal(0.0, 1.0) @ "a"
        _ = g.mv_normal_diag(torch.zeros(2), scales) @ "b"
        _ = g.normal(a, 0.5) @ "y"

    res = sample_posterior(
        1, model, g.C["y"].set(1.0), (), g.S["a"] | g.S["b"], n_chains=256, n_warmup=60,
        n_samples=20, algorithm="hmc_sweep", eps0=0.05, L=8, device="cpu",
    )
    assert tuple(res["a"].shape) == (256, 20) and tuple(res["b"].shape) == (256, 20, 2)
    assert tuple(res.rhat_of("b").shape) == (2,) and tuple(res.ess_of("a").shape) == ()
    assert res.inv_mass.shape == (3,)
    # posterior of a: precision 1 + 4, mean 4/5; b keeps its prior scales
    assert abs(float(res["a"].mean()) - 0.8) < 0.1
    torch.testing.assert_close(res["b"].reshape(-1, 2).std(dim=0), scales, rtol=0.25, atol=0.0)
    assert bool((res.inv_mass[1:] / scales**2 - 1.0).abs().max() < 0.5)


def test_batched_rebuild_matches_one_draw_at_a_time():
    """``split_ravel``'s ``rebuild`` of a ``(chains, samples, d)`` block
    gives each ``(chains, samples)`` index the tree ``rebuild`` gives its
    ``(d,)`` row."""
    tree = g.C["a"].set(torch.tensor(0.5)) | g.C["b"].set(torch.zeros(2, 3))
    _z0, rebuild = split_ravel(tree)
    z = torch.randn(4, 5, 7)
    out = rebuild(z)
    for c, s in [(0, 0), (3, 4), (2, 1)]:
        one = rebuild(z[c, s])
        assert torch.equal(out["a"][c, s], one["a"]) and torch.equal(out["b"][c, s], one["b"])
    assert out["b"].shape == (4, 5, 2, 3)


class _ThreeRanks:
    """A mesh axis of three ranks, enough to reach the sharding checks
    without a process group."""

    def axis_size(self, axis):
        return 3


@pytest.mark.parametrize("kw, item", [
    (dict(mesh=_ThreeRanks(), algorithm="chees"), "must divide over 3 shards"),
    (dict(mesh=_ThreeRanks(), algorithm="hmc"), "must divide over 3 shards"),
])
def test_options_not_ported_raise_naming_their_item(kw, item):
    """Every option is ported: a mesh shards the chains of the column and
    the trace-path algorithms alike, and a chain count the axis does not
    divide raises."""
    with pytest.raises(ValueError, match=item):
        sample_posterior(0, conjugate, OBS, (), g.S["mu"], device="cpu", **kw)


def test_sample_logdensity_and_unknown_algorithms_raise():
    with pytest.raises(ValueError, match="unknown algorithm"):
        sample_posterior(0, conjugate, OBS, (), g.S["mu"], algorithm="gibbs", device="cpu")


def test_default_device_needs_a_card_and_the_cpu_runs():
    """``sample_posterior`` makes its chains: without a card the default
    ``device="cuda"`` raises naming ``device='cpu'``; on the CPU it runs, and
    a generator on another device than the chains' raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_posterior(0, conjugate, OBS, (), g.S["mu"], n_chains=4, n_samples=1)
    res = sample_posterior(torch.Generator().manual_seed(3), conjugate, OBS, (), g.S["mu"],
                           n_chains=4, n_warmup=2, n_samples=2, algorithm="hmc", device="cpu")
    assert res["mu"].device.type == "cpu" and res.eps.device.type == "cpu"
    with pytest.raises(ValueError, match="the generator lives on cpu"):
        sample_posterior(torch.Generator(), conjugate, OBS, (), g.S["mu"], device="meta")


# ----------------------------------------------------------------------
# device repairs: the zero of a sum with no term lives where the trace does
# ----------------------------------------------------------------------


@g.gen
def no_addresses(x):
    return x + 1.0


def test_empty_scores_and_positions_take_the_trees_device():
    """A body with no address scores a float32 zero on its arguments'
    device, from ``get_score`` and ``assess`` alike, and an empty selection
    ravels to an empty float32 vector on the tree's device. The meta device
    stands in for the card: a CPU zero would show as ``cpu``."""
    x = torch.tensor(1.0, device="meta")
    tr = no_addresses.simulate(torch.Generator(), (x,))
    for score in (tr.get_score(), no_addresses.assess(g.ChoiceMap.empty(), (x,))[0]):
        assert score.device.type == "meta" and score.dtype == torch.float32 and score.shape == ()
    z0, _ = split_ravel(g.C["k"].set(torch.tensor(3, device="meta")))
    assert z0.device.type == "meta" and z0.dtype == torch.float32 and z0.shape == (0,)
    cpu_tr = no_addresses.simulate(torch.Generator(), (1.0,))
    assert cpu_tr.get_score().dtype == torch.float32 and float(cpu_tr.get_score()) == 0.0


def test_a_distribution_traces_arguments_live_on_its_device():
    """``linear_regression`` makes its prior's parameters on the device the
    model runs on (its generator's, or in ``assess`` its choices'), so every
    leaf of its traces shares one device; a distribution trace records its
    arguments as it is given them. The meta device stands in for the card:
    a constant left on the CPU would show as ``cpu``."""
    from genjax_tpu_torch.models import linear_regression

    class MetaGenerator(torch.Generator):  # every choice is given below: it draws nothing
        device = property(lambda self: torch.device("meta"))

    model, _exact = linear_regression(np.ones((4, 3), np.float32))
    choices = g.C["w"].set(torch.zeros(3, device="meta")) | g.C["y"].set(torch.zeros(4, device="meta"))
    tr, _w = model.generate(MetaGenerator(), choices, ())
    leaves = torch.utils._pytree.tree_leaves(tr)
    assert leaves and all(leaf.device.type == "meta" for leaf in leaves)
    assert model.assess(choices, ())[0].device.type == "meta"
    cpu_tr = model.simulate(torch.Generator(), ())
    assert all(leaf.device.type == "cpu" for leaf in torch.utils._pytree.tree_leaves(cpu_tr))
    scale = torch.ones(3)
    assert g.mv_normal_diag.simulate(torch.Generator(), (0.0, scale)).get_args()[1] is scale
