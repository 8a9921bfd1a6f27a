"""The discrete HMM and its exact tools (``dists/discrete_hmm.py``,
``dists/hmm_tools.py``, ``models/hmm.py``, ``inference/exact_testbed.py``)
against ``genjax_tpu`` on the same numpy-seeded inputs.

Deterministic parts to 1e-5 (rtol, atol 1e-5): the configuration's three
log-tensors (1e-6), the forward filters and log marginal, ``path_log_joint``
and ``exact_path_log_posterior``, ``DiscreteHMM``'s densities,
forward-backward's gammas, xis and marginal, both parallel passes, Viterbi
(the path exactly, its score), five Baum-Welch iterations, the HMM models'
``assess`` and the testbed's exact values. Random parts in law: FFBS and
``hmm_posterior_sample`` path frequencies against brute-force enumeration
(each frequency within 4 SE + 1e-3), and the HMM model's importance
estimate against the exact marginal (0.15, the reference test's).
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu.dists.discrete_hmm as rdh
import genjax_tpu.dists.hmm_tools as rht
import genjax_tpu_torch as g
from genjax_tpu.models import dense_hmm_model as ref_dense_hmm_model
from genjax_tpu.models import discrete_hmm_model as ref_discrete_hmm_model
from genjax_tpu_torch import interop
from genjax_tpu_torch.dists import discrete_hmm as dh
from genjax_tpu_torch.dists import hmm_tools as ht
from genjax_tpu_torch.inference.exact_testbed import build_test_against_exact_inference
from genjax_tpu_torch.models import dense_hmm_model, discrete_hmm_model
from torch_threads import _one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5

CONFIGS = [(4, 1, 1, 0.5, 0.5), (6, 2, 1, 0.8, 0.3), (5, 1, 1, 0.0, 0.0), (8, 3, 2, 1.0, 1.0)]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _configs(numbers):
    return interop.discrete_hmm_configuration(numbers), rdh.DiscreteHMMConfiguration(*numbers)


def _observations(n, T, seed):
    return np.random.default_rng(seed).integers(0, n, size=T)


@pytest.mark.parametrize("numbers", CONFIGS)
def test_configuration_log_tensors_match_reference(numbers):
    cfg, ref = _configs(numbers)
    _close(cfg.transition_tensor(), ref.transition_tensor(), 1e-6, 1e-6)
    _close(cfg.observation_tensor(), ref.observation_tensor(), 1e-6, 1e-6)
    for name in ("log_initial", "log_transition", "log_observation"):
        _close(getattr(cfg, name)(), getattr(ref, name)(), 1e-6, 1e-6)
    assert not torch.isnan(cfg.log_transition()).any()


@pytest.mark.parametrize("numbers,T", [(CONFIGS[0], 1), (CONFIGS[0], 7), (CONFIGS[1], 12), (CONFIGS[3], 20)])
def test_forward_filter_and_path_densities_match_reference(numbers, T):
    cfg, ref = _configs(numbers)
    ys = _observations(numbers[0], T, T)
    filters, lm = dh.forward_filter(cfg, torch.from_numpy(ys))
    r_filters, r_lm = rdh.forward_filter(ref, jnp.asarray(ys))
    _close(filters, r_filters)
    _close(lm, r_lm)
    zs = np.random.default_rng(T + 1).integers(0, numbers[0], size=T)
    _close(dh.path_log_joint(cfg, torch.from_numpy(zs), torch.from_numpy(ys)),
           rdh.path_log_joint(ref, jnp.asarray(zs), jnp.asarray(ys)))
    post, lm2 = dh.exact_path_log_posterior(cfg, torch.from_numpy(zs), torch.from_numpy(ys))
    r_post, _ = rdh.exact_path_log_posterior(ref, jnp.asarray(zs), jnp.asarray(ys))
    _close(post, r_post)
    _close(lm2, r_lm)
    _close(g.dists.DiscreteHMM.data_logpdf(cfg, torch.from_numpy(ys)), gj.DiscreteHMM.data_logpdf(ref, jnp.asarray(ys)))
    w, v = g.dists.DiscreteHMM.assess(g.ChoiceMap.entry(torch.from_numpy(zs)), (cfg, torch.from_numpy(ys)))
    _close(w, r_post)
    assert torch.equal(v, torch.from_numpy(zs))


def _enumerate(log_pi, log_trans, log_obs, ys):
    """Every path of a small HMM with its float64 log joint."""
    n, T = log_pi.shape[0], len(ys)
    rows = []
    for zs in itertools.product(range(n), repeat=T):
        lp = log_pi[zs[0]] + log_obs[zs[0], ys[0]]
        for t in range(1, T):
            lp += log_trans[zs[t - 1], zs[t]] + log_obs[zs[t], ys[t]]
        rows.append((zs, lp))
    log_z = np.logaddexp.reduce(np.asarray([lp for _, lp in rows]))
    marg = np.zeros((T, n))
    for zs, lp in rows:
        for t, z in enumerate(zs):
            marg[t, z] += np.exp(lp - log_z)
    return marg, log_z


def _in_law(paths: torch.Tensor, exact: np.ndarray):
    n = paths.shape[0]
    for t in range(paths.shape[1]):
        freq = np.bincount(paths[:, t].numpy(), minlength=exact.shape[1]) / n
        se = np.sqrt(exact[t] * (1 - exact[t]) / n)
        assert np.all(np.abs(freq - exact[t]) <= 4 * se + 1e-3), (t, freq, exact[t])


def test_ffbs_paths_in_law_against_enumeration():
    cfg = dh.DiscreteHMMConfiguration(3, 1, 1, 0.6, 0.6)
    ys = torch.tensor([0, 2, 1, 1, 0])
    gen = torch.Generator().manual_seed(0)
    _, (zs, filters) = dh.forward_filtering_backward_sampling(gen, cfg, ys)
    assert zs.dtype == torch.int64 and tuple(zs.shape) == (5,)
    _close(filters, dh.forward_filter(cfg, ys)[0])
    paths = torch.func.vmap(lambda _: dh.backward_sample(gen, cfg, filters), randomness="different")(
        torch.zeros(6000))
    marg, log_z = _enumerate(*(t.double().numpy() for t in (cfg.log_initial(), cfg.log_transition(),
                                                            cfg.log_observation())), ys.numpy())
    _in_law(paths, marg)
    w, zs1 = g.dists.DiscreteHMM.random_weighted(gen, cfg, ys)
    _close(w, np.float64(dh.path_log_joint(cfg, zs1, ys)) - log_z, 1e-4, 1e-4)


def _dense(N, M, seed):
    rng = np.random.RandomState(seed)
    arrays = [np.log(rng.dirichlet(np.ones(N))), np.log(rng.dirichlet(np.ones(N), size=N)),
              np.log(rng.dirichlet(np.ones(M), size=N))]
    arrays = [a.astype(np.float32) for a in arrays]
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays], rng


@pytest.mark.parametrize("N,M,T", [(3, 4, 1), (3, 4, 6), (4, 3, 9), (5, 5, 17)])
def test_dense_hmm_tools_match_reference(N, M, T):
    port, ref, rng = _dense(N, M, 10 * N + T)
    ys = rng.randint(0, M, size=T)
    yt, yj = torch.from_numpy(ys), jnp.asarray(ys)
    _close(ht.hmm_log_marginal(*port, yt), jax.jit(rht.hmm_log_marginal)(*ref, yj))
    for fn in ("forward_backward", "forward_backward_parallel"):
        post, r_post = getattr(ht, fn)(*port, yt), jax.jit(getattr(rht, fn))(*ref, yj)
        _close(post.log_gammas, r_post.log_gammas)
        _close(post.log_xis, r_post.log_xis)
        _close(post.log_marginal, r_post.log_marginal)
    alphas, lm = ht.forward_parallel(*port, yt)
    r_alphas, r_lm = jax.jit(rht.forward_parallel)(*ref, yj)
    _close(alphas, r_alphas)
    _close(lm, r_lm)
    for fn in ("viterbi", "viterbi_parallel"):
        path, score = getattr(ht, fn)(*port, yt)
        r_path, r_score = jax.jit(getattr(rht, fn))(*ref, yj)
        np.testing.assert_array_equal(path.numpy(), np.asarray(r_path))
        _close(score, r_score)
    (lp, lt, lo), lms = ht.hmm_em(*port, yt, n_iters=5)
    (r_lp, r_lt, r_lo), r_lms = jax.jit(functools.partial(rht.hmm_em, n_iters=5))(*ref, yj)
    for a, b in ((lp, r_lp), (lt, r_lt), (lo, r_lo), (lms, r_lms)):
        _close(a, b, 1e-4, 1e-5)


def test_long_sequence_passes_hold_float64_precision():
    """The sequential passes normalize each step and sum the normalizers as
    a scan: at T = 4,096 the log marginal and the Viterbi score stay within
    1e-6 of float64 (the reference's unnormalized float32 recursion drifts
    about 3e-6 here, 5e-5 at 64 states on an NVIDIA H100 80GB HBM3 at
    700.00 W)."""
    from scipy.special import logsumexp

    rng = np.random.RandomState(5)
    n, T = 16, 4096
    p64 = [np.log(rng.dirichlet(np.ones(n))), np.log(rng.dirichlet(np.ones(n), size=n)),
           np.log(rng.dirichlet(np.ones(n), size=n))]
    ys = rng.randint(0, n, size=T)
    a = p64[0] + p64[2][:, ys[0]]
    d = a.copy()
    for y in ys[1:]:
        a = p64[2][:, y] + logsumexp(a[:, None] + p64[1], axis=0)
        d = p64[2][:, y] + np.max(d[:, None] + p64[1], axis=0)
    port = [torch.from_numpy(x.astype(np.float32)) for x in p64]
    yt = torch.from_numpy(ys)
    for got, want in ((ht.hmm_log_marginal(*port, yt), logsumexp(a)), (ht.viterbi(*port, yt)[1], d.max()),
                      (ht.forward_backward(*port, yt).log_marginal, logsumexp(a))):
        assert abs(float(got) - want) <= 1e-6 * abs(want), (float(got), want)
    gammas = torch.exp(ht.forward_backward(*port, yt).log_gammas)
    _close(gammas.sum(dim=1), np.ones(T), 1e-4, 1e-4)


def test_hmm_posterior_sample_in_law_against_enumeration():
    port, _, rng = _dense(3, 4, 0)
    ys = rng.randint(0, 4, size=6)
    gen = torch.Generator().manual_seed(1)
    paths, lm = torch.func.vmap(lambda _: ht.hmm_posterior_sample(gen, *port, torch.from_numpy(ys)),
                                randomness="different")(torch.zeros(6000))
    marg, log_z = _enumerate(*(t.double().numpy() for t in port), ys)
    _close(lm[0], log_z, 1e-5, 1e-5)
    _in_law(paths, marg)


def test_em_keeps_an_unreachable_state_finite():
    rng = np.random.RandomState(1)
    ys = torch.from_numpy(rng.randint(0, 2, size=100))
    lp = torch.log(torch.tensor([0.5, 0.5, 1e-30]))
    lt = torch.log(torch.tensor([[0.6, 0.4, 1e-30], [0.4, 0.6, 1e-30], [0.3, 0.3, 0.4]]))
    lo = torch.log(torch.tensor([[0.6, 0.4], [0.45, 0.55], [0.5, 0.5]]))
    (_, lt_f, lo_f), lms = ht.hmm_em(lp, lt, lo, ys, n_iters=10)
    assert torch.isfinite(lms).all() and not torch.isnan(lt_f).any() and not torch.isnan(lo_f).any()
    assert bool((torch.diff(lms) > -1e-3).all())


def test_dense_hmm_model_assess_matches_reference():
    port, ref, rng = _dense(3, 4, 0)
    T = 8
    ys, zs = rng.randint(0, 4, size=T), rng.randint(0, 3, size=T)
    model = dense_hmm_model(*port, T)
    r_model = ref_dense_hmm_model(*ref, T)
    chm = g.C[:, "z"].set(torch.from_numpy(zs)) | g.C[:, "y"].set(torch.from_numpy(ys))
    r_chm = gj.C[:, "z"].set(jnp.asarray(zs)) | gj.C[:, "y"].set(jnp.asarray(ys))
    score, _ = model.assess(chm, (torch.tensor(-1), torch.zeros(T)))
    r_score, _ = r_model.assess(r_chm, (jnp.asarray(-1), jnp.zeros(T)))
    _close(score, r_score)


def test_discrete_hmm_model_assess_matches_reference_and_exact():
    numbers = (4, 1, 1, 0.5, 0.5)
    cfg, ref = _configs(numbers)
    chain, _ = discrete_hmm_model(cfg, 5)
    r_chain, _ = ref_discrete_hmm_model(ref, 5)
    rng = np.random.default_rng(3)
    zs, xs = rng.integers(0, 4, size=5), rng.integers(0, 4, size=5)
    score, _ = chain.assess(g.C[:, "z"].set(torch.from_numpy(zs)) | g.C[:, "x"].set(torch.from_numpy(xs)),
                            (torch.tensor(2), torch.zeros(5)))
    r_score, _ = r_chain.assess(gj.C[:, "z"].set(jnp.asarray(zs)) | gj.C[:, "x"].set(jnp.asarray(xs)),
                                (jnp.asarray(2), jnp.zeros(5)))
    _close(score, r_score)
    _close(score, dh.path_log_joint(cfg, torch.from_numpy(zs), torch.from_numpy(xs)))


def test_testbed_problem_is_exact_and_consistent():
    make, chain, cfg = build_test_against_exact_inference(5, 4, 1, 1, 0.5, 0.5)
    p = make(torch.Generator().manual_seed(0))
    assert int(p.initial_state) == cfg.linear_grid_dim // 2
    ref = rdh.DiscreteHMMConfiguration(4, 1, 1, 0.5, 0.5)
    zs, xs = jnp.asarray(p.latent_sequence.numpy()), jnp.asarray(p.observation_sequence.numpy())
    _close(p.log_data_marginal, gj.DiscreteHMM.data_logpdf(ref, xs))
    _close(p.log_posterior, gj.DiscreteHMM.estimate_logpdf(jr.key(0), zs, ref, xs))
    # the importance estimate of the chain's marginal, in law (the reference test's 0.15)
    target = g.Target(chain, (p.initial_state, torch.zeros(5)), g.C[:, "x"].set(p.observation_sequence))
    est = g.ImportanceK(target, k_particles=3000).run_smc(0, device="cpu").get_log_marginal_likelihood_estimate()
    assert abs(float(est) - float(p.log_data_marginal)) < 0.15
