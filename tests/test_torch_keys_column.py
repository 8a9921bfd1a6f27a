"""The column path on the reference's streams, draw for draw against
``genjax_tpu``.

An int seed or a key now gives every column entry point and column sampler
the reference's draws: ``init_columns`` the start of
``split(fold_in(key(seed), 0xC0FFEE), n_chains)``; ``column_hmc`` and
``column_nuts`` with ``rng="rbg"`` the warmup's phases on ``key((seed + 1) *
1_000_003 + phase, "rbg")`` and the main sweep on ``key(seed, "rbg")`` (the
reference's ``column_hmc(backend="xla")`` and ``column_nuts``); ChEES, PT,
the dense sweeps and SG-MCMC their roots, splits and fold-ins. A
``torch.Generator`` in the seed's place draws in law, and ``column_hmc`` and
``column_nuts`` without ``rng`` draw exactly what they drew before.

Tolerances: packed start columns to 1e-6; adapted ``eps`` to rtol 1e-5,
inverse masses and Cholesky factors to rtol 1e-4; positions within 1e-4 for
at least 99% of chains (``agree``), statistics to rtol 1e-5. The file imports
JAX inside the CPU tests only, so that its ``cuda`` cases run on the card.
``tests/test_torch_keys_sample_column.py`` holds the one-call drivers.
"""

import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.core import keys
from genjax_tpu_torch.kernels import chees as chees_mod
from genjax_tpu_torch.kernels import (chees_hmc, column_chees, column_hmc, column_nuts, column_pt, column_svgd, hmc,
                                      nuts_pallas, pt_hmc)
from genjax_tpu_torch.kernels.dense_mass import hmc_sweep_dense_cols, warmup_column_dense
from genjax_tpu_torch.kernels.pt import geometric_ladder
from genjax_tpu_torch.kernels.model_interface import ColumnPacker, init_columns, prior_generator
from genjax_tpu_torch.kernels.sgld import minibatch_grad_cols, sghmc_sweep_cols, sgld_sweep_cols
from torch_threads import _one_thread  # noqa: F401

SEEDS = [0, 1, 42]
POS_TOL = 1e-4


def jax_mod():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def agree(a, b, share=0.99, tol=POS_TOL):
    """At least ``share`` of the chains (columns of ``(D, N)``, or of each
    leading slice) within ``tol`` in every row."""
    a, b = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    assert a.shape == b.shape, (a.shape, b.shape)
    ok = (np.abs(a - b) <= tol).reshape(-1, a.shape[-1]).all(axis=0)
    assert ok.mean() >= share, f"{ok.mean():.4f} of chains within {tol}"


def close(a, b, tol=1e-5):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=1e-6)


# a 5-d anisotropic, quartic-tailed target for the samplers on a raw density
D, N = 5, 128
_SCALE = np.linspace(0.5, 3.0, D).astype(np.float32)


def t_ld(q):
    s = torch.from_numpy(_SCALE)[:, None]
    return -0.5 * torch.sum((q / s) ** 2, 0) - 0.05 * torch.sum(q**4, 0)


def j_ld(q):
    import jax.numpy as jnp

    return -0.5 * jnp.sum((q / _SCALE[:, None]) ** 2, 0) - 0.05 * jnp.sum(q**4, 0)


def _q0(d=D, n=N, seed=0):
    return np.random.default_rng(seed).normal(size=(d, n)).astype(np.float32)


def _seed_pair(seed):
    """The port's and the reference's form of a seed: an int, or for
    ``"key"`` the rbg key ``key(3, "rbg")`` in both."""
    if seed == "key":
        return keys.key(3, device="cpu", impl="rbg"), jax_mod().random.key(3, impl="rbg")
    return seed, seed


def _flagship():
    import genjax_tpu as gj
    from genjax_tpu.models import hierarchical_regression as ref_model
    from genjax_tpu_torch.models import hierarchical_regression

    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return (hierarchical_regression(torch.from_numpy(X)), g.C["y"].set(torch.from_numpy(y)), ref_model(X),
            gj.C["y"].set(y))


# ----------------------------------------------------------------------
# the start, column_hmc and column_nuts
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS + ["key"])
def test_init_columns_draws_the_references_start(seed):
    """The packed columns of ``generate`` under ``split(fold_in(key(seed),
    0xC0FFEE), n)``, to 1e-6 (a key given is used as ``key(seed)``)."""
    jax = jax_mod()
    from genjax_tpu.kernels.model_interface import ColumnPacker as RefPacker

    model, obs, model_ref, obs_ref = _flagship()
    tk = keys.key(3, device="cpu") if seed == "key" else seed
    rk = jax.random.key(3 if seed == "key" else seed)
    packer = ColumnPacker(model, obs, (), ["tau", "w"], device="cpu")
    got = init_columns(model, obs, (), packer, 64, tk, "cpu")
    ref_packer = RefPacker(model_ref, obs_ref, (), ["tau", "w"])
    want = jax.jit(jax.vmap(lambda k: ref_packer.pack(model_ref.generate(k, obs_ref, ())[0].get_choices()),
                            out_axes=1))(jax.random.split(jax.random.fold_in(rk, 0xC0FFEE), 64))
    assert tuple(got.shape) == (16, 64) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 42])
def test_column_hmc_rbg_with_warmup_draws_the_references(seed):
    """``column_hmc(rng="rbg", warmup=True)`` against the reference's
    ``column_hmc(backend="xla", warmup=True)``: the start, six warmup phases
    of 25 steps and the main sweep, 128 flagship chains."""
    from genjax_tpu.kernels import column_hmc as ref_column_hmc

    model, obs, model_ref, obs_ref = _flagship()
    kw = dict(n_chains=128, n_steps=5, eps=0.02, L=5, seed=seed, warmup=True)
    q, acc, _p = column_hmc(model, obs, (), ["tau", "w"], rng="rbg", device="cpu", **kw)
    assert hmc.pallas_hmc.last_backend == "torch"
    want, want_acc, _rp = ref_column_hmc(model_ref, obs_ref, (), ["tau", "w"], backend="xla", **kw)
    agree(q, want)
    close(acc, want_acc)


def test_column_nuts_rbg_with_warmup_draws_the_references():
    """``column_nuts(rng="rbg", warmup=True)`` against the reference's
    ``column_nuts(warmup=True)``: ten warmup phases of ten transitions and
    the main sweep (its ``nuts_sweep_cols`` on ``key(seed, "rbg")``), 32
    flagship chains at depth 3."""
    from genjax_tpu.kernels import column_nuts as ref_column_nuts

    model, obs, model_ref, obs_ref = _flagship()
    kw = dict(n_chains=32, n_steps=3, eps=0.05, max_depth=3, seed=1, warmup=True)
    q, acc, leaps, _p = column_nuts(model, obs, (), ["tau", "w"], rng="rbg", device="cpu", **kw)
    assert nuts_pallas.pallas_nuts.last_backend == "torch"
    want, want_acc, want_leaps, _rp = ref_column_nuts(model_ref, obs_ref, (), ["tau", "w"], **kw)
    agree(q, want)
    close(acc, want_acc)
    close(leaps, want_leaps)


def test_the_warmups_adapt_as_the_references():
    """``warmup_column`` and ``warmup_column_nuts`` with ``rng="rbg"``: the
    adapted ``eps`` (rtol 1e-5) and inverse mass (rtol 1e-4) and the
    positions, on the raw density."""
    jax_mod()
    from genjax_tpu.kernels.hmc import warmup_column as ref_warm
    from genjax_tpu.kernels.nuts import warmup_column_nuts as ref_warm_nuts

    q0 = _q0(seed=2)
    q, eps, im = hmc.warmup_column(t_ld, torch.from_numpy(q0), 5, n_phases=3, steps_per_phase=4, L=3, rng="rbg")
    rq, reps, rim = ref_warm(j_ld, q0, 5, n_phases=3, steps_per_phase=4, L=3)
    agree(q, rq)
    close(eps, reps)
    close(im, rim, tol=1e-4)
    q, eps, im = nuts_pallas.warmup_column_nuts(t_ld, torch.from_numpy(q0), 5, n_phases=3, steps_per_phase=2,
                                                max_depth=4, rng="rbg")
    rq, reps, rim = ref_warm_nuts(j_ld, q0, 5, n_phases=3, steps_per_phase=2, max_depth=4)
    agree(q, rq)
    close(eps, reps)
    close(im, rim, tol=1e-4)


@pytest.mark.parametrize("seed,fits", [(2146, True), (2147, False), (-2148, True), (-2149, False)])
def test_the_int32_phase_seed_edge(seed, fits):
    """The reference adds the phase index to ``(seed + 1) * 1_000_003``
    inside ``jit``, as an int32: seeds 2146 and -2148 fit and draw alike,
    2147 and -2149 raise an ``OverflowError`` in both packages (on the rbg
    stream; the Philox path keeps the seed's low 32 bits and runs)."""
    from genjax_tpu.kernels.hmc import warmup_column as ref_warm

    q0 = _q0(n=16, seed=3)
    kw = dict(n_phases=2, steps_per_phase=1, L=1)
    if fits:
        q, eps, _im = hmc.warmup_column(t_ld, torch.from_numpy(q0), seed, rng="rbg", **kw)
        rq, reps, _rim = ref_warm(j_ld, q0, seed, **kw)
        agree(q, rq, share=1.0)
        close(eps, reps)
        return
    with pytest.raises(OverflowError, match="int32"):
        hmc.warmup_column(t_ld, torch.from_numpy(q0), seed, rng="rbg", **kw)
    with pytest.raises(OverflowError, match="int32"):
        nuts_pallas.warmup_column_nuts(t_ld, torch.from_numpy(q0), seed, rng="rbg", n_phases=1, steps_per_phase=1)
    with pytest.raises(OverflowError):
        ref_warm(j_ld, q0, seed, **kw)
    q, _eps, _im = hmc.warmup_column(t_ld, torch.from_numpy(q0), seed, **kw)
    assert bool(torch.isfinite(q).all())


def test_the_phase_seeds_make_the_references_rbg_keys():
    """``key(phase_seed, "rbg")`` of the exact ints the reference forms, a
    negative one among them, equals ``jax.random``'s."""
    jax = jax_mod()
    for seed in (0, 2146, -1, -2148):
        for idx in (0, 5):
            ps = hmc.phase_seed_base(seed, "rbg") + idx
            want = np.asarray(jax.random.key_data(jax.random.key(np.int32(ps), impl="rbg"))).astype(np.int64)
            np.testing.assert_array_equal(keys.key(ps, device="cpu", impl="rbg").numpy(), want)


@pytest.mark.parametrize("entry", ["hmc", "nuts"])
def test_without_rng_the_column_entry_points_draw_as_before(entry):
    """``rng=None`` starts from ``prior_generator(seed)`` and sweeps on the
    generator stream, bit for bit what the warmup and sweep draw given that
    start."""
    model, obs, _m, _o = _flagship()
    packer = ColumnPacker(model, obs, (), ["tau", "w"], device="cpu")
    from genjax_tpu_torch.kernels.model_interface import column_logdensity

    ld = column_logdensity(model, obs, (), packer)
    q0 = init_columns(model, obs, (), packer, 32, prior_generator(7, "cpu"), "cpu")
    if entry == "hmc":
        q, acc, _p = column_hmc(model, obs, (), ["tau", "w"], n_chains=32, n_steps=3, eps=0.02, L=3, seed=7,
                                warmup=True, device="cpu")
        qw, eps, im = hmc.warmup_column(ld, q0, 7, eps0=0.02, L=3)
        want, want_acc = hmc.pallas_hmc(ld, qw, 7, n_steps=3, eps=eps, L=3, inv_mass=im)
    else:
        q, acc, _l, _p = column_nuts(model, obs, (), ["tau", "w"], n_chains=32, n_steps=2, eps=0.05, max_depth=3,
                                     seed=7, device="cpu")
        want, want_acc, _wl = nuts_pallas.pallas_nuts(ld, q0, 7, n_steps=2, eps=0.05, max_depth=3)
    assert torch.equal(q, want) and torch.equal(torch.as_tensor(acc), torch.as_tensor(want_acc))


def test_rng_rbg_refuses_a_mesh_and_the_counter_stream():
    model, obs, _m, _o = _flagship()
    with pytest.raises(ValueError, match="mesh="):
        column_hmc(model, obs, (), ["tau", "w"], n_chains=8, n_steps=1, eps=0.02, rng="rbg", device="cpu",
                   mesh=object())
    with pytest.raises(ValueError, match="counter stream"):
        column_nuts(model, obs, (), ["tau", "w"], n_chains=8, n_steps=1, eps=0.02, rng="rbg", interpret=True,
                    device="cpu")
    with pytest.raises(ValueError, match="rng must be"):
        column_hmc(model, obs, (), ["tau", "w"], n_chains=8, n_steps=1, eps=0.02, rng="philox", device="cpu")


def test_on_the_kernels_route_rbg_launches_the_rbg_kernels(monkeypatch):
    """Routed as on the card, ``column_hmc(rng="rbg", warmup=True)`` asks
    K1 for its rbg kernel 7 times (six phases at ``(seed + 1) * 1_000_003 +
    phase``, then the sweep at ``seed``) and ``column_nuts`` K4 11 times;
    each launch here runs the twin it stands for, and the chains are the
    twin path's."""
    model, obs, _m, _o = _flagship()
    seen = []

    def k1(body, q, seed, **kw):
        seen.append(("K1", seed, kw["rng"]))
        qq, rate = hmc._reference_hmc(ld_of[0], q, seed, n_steps=kw["n_steps"], eps=kw["eps"], L=kw["L"],
                                      inv_mass=kw["inv_mass"], rng=kw["rng"])
        return qq, torch.full((q.shape[1],), float(rate) * kw["n_steps"])

    def k4(body, q, seed, **kw):
        seen.append(("K4", seed, kw["rng"]))
        from genjax_tpu_torch.kernels.nuts import nuts_sweep_cols

        qq, acc, leaps = nuts_sweep_cols(ld_of[0], q, seed, n_steps=kw["n_steps"], eps=kw["eps"],
                                         max_depth=kw["max_depth"], inv_mass=kw["inv_mass"], rng=kw["rng"])
        n = q.shape[1]
        return qq, torch.full((n,), float(acc) * kw["n_steps"]), torch.full((n,), float(leaps) * kw["n_steps"])

    ld_of = []
    real_body = hmc.device_body

    def body_of(ld, d, device):
        ld_of[:] = [ld]
        return real_body(ld, d, device)

    monkeypatch.setattr(hmc, "_route", lambda backend, device: "cuda")
    monkeypatch.setattr(nuts_pallas, "_route", lambda backend, device: "cuda")
    monkeypatch.setattr(hmc, "device_body", body_of)
    monkeypatch.setattr(nuts_pallas, "device_body", body_of)
    monkeypatch.setattr(hmc, "hmc_sweep", k1)
    monkeypatch.setattr(nuts_pallas, "nuts_sweep", k4)
    q, _acc, _p = column_hmc(model, obs, (), ["tau", "w"], n_chains=16, n_steps=2, eps=0.02, L=2, seed=4,
                             warmup=True, rng="rbg", device="cpu")
    assert [s[1:] for s in seen] == [((5 * 1_000_003) + i, "rbg") for i in range(6)] + [(4, "rbg")]
    assert hmc.pallas_hmc.last_backend == "cuda" and hmc.pallas_hmc.last_body == "hier_regression"
    seen.clear()
    column_nuts(model, obs, (), ["tau", "w"], n_chains=16, n_steps=1, eps=0.05, max_depth=2, seed=4,
                warmup=True, rng="rbg", device="cpu")
    assert [s for s in seen] == [("K4", 5 * 1_000_003 + i, "rbg") for i in range(10)] + [("K4", 4, "rbg")]
    assert nuts_pallas.pallas_nuts.last_backend == "cuda"
    monkeypatch.undo()
    want, _a, _p = column_hmc(model, obs, (), ["tau", "w"], n_chains=16, n_steps=2, eps=0.02, L=2, seed=4,
                              warmup=True, rng="rbg", device="cpu")
    agree(q, want, share=1.0)


# ----------------------------------------------------------------------
# ChEES, PT, the dense metric, SG-MCMC
# ----------------------------------------------------------------------


class _CeilRecorder:
    """``torch`` for ``kernels/chees.py`` with ``ceil`` recording its
    argument, ``tau / eps`` of each sweep."""

    def __init__(self):
        self.ratios = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def ceil(self, x):
        self.ratios.append(float(x))
        return torch.ceil(x)


@pytest.mark.parametrize("seed", SEEDS + ["key"])
@pytest.mark.parametrize("impl", ["rbg", "threefry2x32"])
def test_chees_draws_the_references(seed, impl, monkeypatch):
    """60 warmup and 20 sampling sweeps: the shared leapfrog count flips
    every chain if ``tau / eps`` crosses an integer, so the smallest
    distance of ``tau / eps`` to an integer of 1 or more over the run is
    reported (and held above 1e-4, so that a one-ulp difference cannot flip
    it). The shared dual averaging feeds the float32 rounding that differs
    between XLA and torch back into the sweeps, and an accept decision at a
    near-tie then moves a chain now and then: at least 0.97 of the chains
    are held within 1e-4 (measured 0.984-1.0)."""
    jax = jax_mod()
    from genjax_tpu.kernels import chees_hmc as ref_chees

    if seed == "key" and impl == "threefry2x32":
        tk, rk = keys.key(3, device="cpu"), jax.random.key(3)
    else:
        tk, rk = _seed_pair(seed)
    rec = _CeilRecorder()
    monkeypatch.setattr(chees_mod, "torch", rec)
    q0 = _q0(seed=4)
    kw = dict(n_warmup=60, n_steps=20, eps0=0.05, rng_impl=impl, collect=True)
    q, info = chees_hmc(t_ld, torch.from_numpy(q0), tk, **kw)
    monkeypatch.undo()
    rq, rinfo = jax.jit(lambda q0, k: ref_chees(j_ld, q0, k, **kw))(q0, rk)
    # ceil is clipped to at least 1: the boundaries that move L are the
    # integers from 1 on
    gap = min(abs(r - max(1, round(r))) for r in rec.ratios)
    print(f"chees seed={seed} impl={impl}: smallest |tau/eps - integer| over {len(rec.ratios)} sweeps {gap:.3g}")
    assert gap > 1e-4
    agree(q, rq, share=0.97)
    agree(info.draws, rinfo.draws, share=0.97)
    close(info.eps, rinfo.eps)
    close(info.trajectory_length, rinfo.trajectory_length)
    close(info.inv_mass, rinfo.inv_mass, tol=1e-4)
    close(info.mean_leapfrogs, rinfo.mean_leapfrogs)
    close(info.accept_rate, rinfo.accept_rate)


def test_chees_under_a_generator_draws_in_law():
    """A generator in the seed's place draws its own stream: the same
    generator state repeats, and it is not the int seed's."""
    q0 = torch.from_numpy(_q0(seed=5))
    kw = dict(n_warmup=10, n_steps=5, eps0=0.05)
    a, _ = chees_hmc(t_ld, q0, torch.Generator().manual_seed(0), **kw)
    b, _ = chees_hmc(t_ld, q0, torch.Generator().manual_seed(0), **kw)
    c, _ = chees_hmc(t_ld, q0, 0, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="the key lives on meta"):
        chees_hmc(t_ld, q0, keys.key(0, device="meta"), **kw)


@pytest.mark.parametrize("seed", SEEDS + ["key"])
def test_pt_draws_the_references(seed):
    """Three rungs of HMC moves and even-odd swaps. At fixed settings (no
    warmup, 40 sweeps) every chain and both swap rates are the reference's.
    With the warmup on, each rung's dual averaging feeds the float32
    rounding that differs between XLA and torch (about 2e-7 relative in a
    rung's ``eps`` after one sweep) back into the next sweep's leapfrogs, and
    a hot rung's log-densities (hundreds in size) then move a swap decision
    now and then: measured on this target, 0.94-1.0 of the cold chains
    within 1e-4 after 4 + 4 sweeps, 0.72-0.93 after 6 + 4, none after 20 +
    10. The adapted run is held at 4 + 4 sweeps: 0.85 of the chains, the
    adapted ``eps`` to rtol 2e-5."""
    jax = jax_mod()
    from genjax_tpu.kernels.pt import geometric_ladder as ref_ladder
    from genjax_tpu.kernels.pt import pt_hmc as ref_pt

    tk, rk = _seed_pair(seed)
    q0 = _q0(seed=6)
    kw = dict(n_warmup=0, n_steps=40, eps0=0.3, L=4, collect=True)
    q, info = pt_hmc(t_ld, torch.from_numpy(q0), tk, betas=geometric_ladder(3), **kw)
    rq, rinfo = jax.jit(lambda q0, k: ref_pt(j_ld, q0, k, betas=ref_ladder(3), **kw))(q0, rk)
    agree(q, rq, share=1.0)
    agree(info.draws, rinfo.draws, share=1.0)
    close(info.accept_rate, rinfo.accept_rate)
    close(info.swap_rate, rinfo.swap_rate)
    kw = dict(n_warmup=4, n_steps=4, eps0=0.1, L=4)
    q, info = pt_hmc(t_ld, torch.from_numpy(q0), tk, betas=geometric_ladder(3), **kw)
    rq, rinfo = jax.jit(lambda q0, k: ref_pt(j_ld, q0, k, betas=ref_ladder(3), **kw))(q0, rk)
    agree(q, rq, share=0.85)
    close(info.eps, rinfo.eps, tol=2e-5)


@pytest.mark.parametrize("seed", SEEDS + ["key"])
def test_the_dense_sweeps_draw_the_references(seed):
    """``warmup_column_dense`` (three phases, its root ``key((seed + 1) *
    1_000_003)`` or the key) then ``hmc_sweep_dense_cols`` (its root
    ``key(seed)`` or the key): positions, the adapted ``eps`` and the
    Cholesky factor of the covariance."""
    jax = jax_mod()
    from genjax_tpu.kernels.dense_mass import hmc_sweep_dense_cols as ref_sweep
    from genjax_tpu.kernels.dense_mass import warmup_column_dense as ref_warm

    tk, rk = _seed_pair(seed)
    q0 = _q0(seed=7)
    q, eps, chol = warmup_column_dense(t_ld, torch.from_numpy(q0), tk, n_phases=3, steps_per_phase=4, L=3)
    rq, reps, rchol = ref_warm(j_ld, q0, rk, n_phases=3, steps_per_phase=4, L=3)
    agree(q, rq)
    close(eps, reps)
    close(chol, rchol, tol=1e-4)
    q2, acc, draws = hmc_sweep_dense_cols(t_ld, q, tk, n_steps=4, eps=float(eps), L=3, cov_chol=chol, collect=True)
    rq2, racc, rdraws = jax.jit(lambda q, k, c: ref_sweep(j_ld, q, k, n_steps=4, eps=float(reps), L=3, cov_chol=c,
                                                          collect=True))(np.asarray(rq), rk, np.asarray(rchol))
    agree(q2, rq2)
    agree(draws, rdraws)
    close(acc, racc)


_X = np.random.default_rng(8).normal(size=(64, 3)).astype(np.float32)
_Y = (_X @ np.asarray([1.0, -0.5, 0.25], np.float32) + 0.3 * np.random.default_rng(9).normal(size=64)).astype(
    np.float32)


def _grads():
    """The minibatch gradient of a Bayesian linear regression (64 rows,
    batches of 8) in both packages."""
    import jax.numpy as jnp

    from genjax_tpu.kernels.sgld import minibatch_grad_cols as ref_grad

    def t_prior(q):
        return -0.5 * torch.sum(q**2, 0)

    def t_lik(q, rows):
        x, y = rows
        return -0.5 * torch.sum((y[:, None] - x @ q) ** 2, 0) / 0.09

    def j_prior(q):
        return -0.5 * jnp.sum(q**2, 0)

    def j_lik(q, rows):
        x, y = rows
        return -0.5 * jnp.sum((y[:, None] - x @ q) ** 2, 0) / 0.09

    return (minibatch_grad_cols(t_prior, t_lik, (torch.from_numpy(_X), torch.from_numpy(_Y)), 8),
            ref_grad(j_prior, j_lik, (jnp.asarray(_X), jnp.asarray(_Y)), 8))


@pytest.mark.parametrize("seed", SEEDS)
def test_sgld_and_sghmc_draw_the_references(seed):
    """20 steps of SGLD, pSGLD and SGHMC on minibatch gradients:
    ``fold_in(key(seed), i)`` split into the batch's ``randint`` key and the
    noise's (SGHMC's root ``key(seed ^ 0x5A17)``, its momentum from
    ``fold_in(root, n_steps)``)."""
    jax = jax_mod()
    from genjax_tpu.kernels.sgld import sghmc_sweep_cols as ref_sghmc
    from genjax_tpu.kernels.sgld import sgld_sweep_cols as ref_sgld

    grad, ref_grad = _grads()
    q0 = 0.1 * _q0(d=3, n=32, seed=10)
    for pre in (False, True):
        q, draws = sgld_sweep_cols(grad, torch.from_numpy(q0), seed, n_steps=20, eps=1e-3, collect=True,
                                   precondition=pre)
        rq, rdraws = jax.jit(lambda q0: ref_sgld(ref_grad, q0, seed, n_steps=20, eps=1e-3, collect=True,
                                                 precondition=pre))(q0)
        agree(q, rq, share=1.0)
        agree(draws, rdraws, share=1.0)
    q, p = sghmc_sweep_cols(grad, torch.from_numpy(q0), seed, n_steps=20, eps=1e-3, friction=2.0)
    rq, rp = jax.jit(lambda q0: ref_sghmc(ref_grad, q0, seed, n_steps=20, eps=1e-3, friction=2.0))(q0)
    agree(q, rq, share=1.0)
    agree(p, rp, share=1.0)


def test_sg_mcmc_takes_a_key_as_its_root_and_a_generator_in_law():
    """A key is the root itself: ``key(seed)`` given draws what the int
    draws (SGHMC's ``key(seed ^ 0x5A17)``). ``grad_fn`` draws its batch from
    a key as ``randint`` does and still takes a generator."""
    grad, _ref = _grads()
    q0 = torch.from_numpy(0.1 * _q0(d=3, n=16, seed=11))
    a, _ = sgld_sweep_cols(grad, q0, 5, n_steps=6, eps=1e-3)
    b, _ = sgld_sweep_cols(grad, q0, keys.key(5, device="cpu"), n_steps=6, eps=1e-3)
    assert torch.equal(a, b)
    a, pa = sghmc_sweep_cols(grad, q0, 5, n_steps=6, eps=1e-3)
    b, pb = sghmc_sweep_cols(grad, q0, keys.key(5 ^ 0x5A17, device="cpu"), n_steps=6, eps=1e-3)
    assert torch.equal(a, b) and torch.equal(pa, pb)
    k = keys.key(9, device="cpu")
    idx = keys.randint(k, (8,), 0, 64)
    assert torch.equal(grad(q0, k), grad.on_rows(q0, idx))
    c, _ = sgld_sweep_cols(grad, q0, torch.Generator().manual_seed(5), n_steps=6, eps=1e-3)
    assert bool(torch.isfinite(c).all()) and not torch.equal(c, a)


# ----------------------------------------------------------------------
# the prior-initialised column samplers
# ----------------------------------------------------------------------


@g.gen
def _conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 0.5) @ "y"


def _ref_conjugate():
    import genjax_tpu as gj

    @gj.gen
    def conjugate():
        mu = gj.normal(0.0, 1.0) @ "mu"
        _ = gj.normal(mu, 0.5) @ "y"

    return conjugate, gj.C["y"].set(1.5)


@pytest.mark.parametrize("seed", [0, 42])
def test_column_chees_pt_and_svgd_draw_the_references(seed):
    """``column_chees``, ``column_pt`` and ``column_svgd`` from an int seed:
    the reference's start (``init_columns``) and sampler stream; SVGD's flow
    draws nothing, so its particles agree to 1e-4 in full. ChEES runs 10
    warmup sweeps: on this one-dimensional target its adaptation (the mass
    from a 64-chain variance, dual averaging, Adam on the trajectory) carries
    the float32 rounding that differs between XLA and torch from sweep to
    sweep, and with every decision alike the positions drift apart (measured
    at seed 0: all 64 chains within 1e-4 after 10 sweeps, 0.95 after 20,
    0.17 after 30, their largest gap 4e-4, ``eps`` 8e-7 relative apart)."""
    import genjax_tpu as gj

    ref, ref_obs = _ref_conjugate()
    obs = g.C["y"].set(1.5)
    q, info, _p = column_chees(_conjugate, obs, (), ["mu"], n_chains=64, n_warmup=10, n_steps=10, eps=0.1,
                               seed=seed, device="cpu")
    rq, rinfo, _rp = gj.kernels.column_chees(ref, ref_obs, (), ["mu"], n_chains=64, n_warmup=10, n_steps=10,
                                             eps=0.1, seed=seed)
    agree(q, rq)
    close(info.eps, rinfo.eps)
    # PT at fixed settings: its warmup's amplification is test_pt_draws_the_references's
    q, info, _p = column_pt(_conjugate, obs, (), ["mu"], n_chains=64, n_rungs=3, n_warmup=0, n_steps=20, eps=0.3,
                            L=4, seed=seed, device="cpu")
    rq, rinfo, _rp = gj.kernels.column_pt(ref, ref_obs, (), ["mu"], n_chains=64, n_rungs=3, n_warmup=0,
                                          n_steps=20, eps=0.3, L=4, seed=seed)
    agree(q, rq, share=1.0)
    close(info.swap_rate, rinfo.swap_rate)
    q, _p = column_svgd(_conjugate, obs, (), ["mu"], n_particles=32, n_steps=20, seed=seed, device="cpu")
    rq, _rp = gj.kernels.column_svgd(ref, ref_obs, (), ["mu"], n_particles=32, n_steps=20, seed=seed)
    agree(q, rq, share=1.0)


# ----------------------------------------------------------------------
# on the card: column_hmc and column_nuts on K1's and K4's rbg kernels
# ----------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _card_flagship(dev):
    from genjax_tpu_torch.models import hierarchical_regression

    X = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(1).normal(size=(16,)).astype(np.float32))
    return hierarchical_regression(X), g.C["y"].set(y.to(dev))


@pytest.mark.cuda
def test_column_hmc_rbg_on_k1_matches_its_twin():
    dev = _cuda()
    model, obs = _card_flagship(dev)
    kw = dict(n_chains=4096, n_steps=10, eps=0.02, L=5, seed=3, warmup=True, rng="rbg", device=dev)
    hmc.hmc_sweep_launches = 0
    q, acc, _p = column_hmc(model, obs, (), ["tau", "w"], **kw)
    assert hmc.hmc_sweep_launches == 7 and hmc.pallas_hmc.last_backend == "cuda"
    want, want_acc, _p = column_hmc(model, obs, (), ["tau", "w"], backend="torch", **kw)
    agree(q, want, share=0.995)
    assert abs(float(acc) - float(want_acc)) < 1e-3


@pytest.mark.cuda
def test_column_nuts_rbg_on_k4_matches_its_twin(monkeypatch):
    """Each of the call's 11 K4 rbg launches against its twin from the
    launch's own input: over a whole call of trees up to 2**depth - 1
    leapfrogs the kernel's and the twin's rounding drift the chains apart
    smoothly (``chip_smoke.py``'s ``[keys column]``)."""
    from genjax_tpu_torch.kernels.model_interface import column_logdensity
    from genjax_tpu_torch.kernels.nuts import nuts_sweep_cols

    dev = _cuda()
    model, obs = _card_flagship(dev)
    launch, records = nuts_pallas.nuts_sweep, []

    def recording(body, q0, seed, **kw):
        out = launch(body, q0, seed, **kw)
        records.append((q0.clone(), seed, kw, out[0]))
        return out

    monkeypatch.setattr(nuts_pallas, "nuts_sweep", recording)
    kw = dict(n_chains=2048, n_steps=3, eps=0.05, max_depth=5, seed=3, warmup=True, rng="rbg", device=dev)
    column_nuts(model, obs, (), ["tau", "w"], **kw)
    assert len(records) == 11 and nuts_pallas.pallas_nuts.last_backend == "cuda"
    assert [r[1] for r in records] == [4 * 1_000_003 + i for i in range(10)] + [3]
    ld = column_logdensity(model, obs, (), ColumnPacker(model, obs, (), ["tau", "w"], device=dev))
    for q_in, seed, k, q_out in records:
        want, _a, _l = nuts_sweep_cols(ld, q_in, seed, n_steps=k["n_steps"], eps=k["eps"], max_depth=k["max_depth"],
                                       inv_mass=k["inv_mass"], rng="rbg")
        agree(q_out, want, share=0.99)
