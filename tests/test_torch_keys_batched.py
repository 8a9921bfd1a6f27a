"""The batched drivers under a key, draw for draw against ``genjax_tpu``.

The reference's batched drivers (``run_chains_hmc``, ``run_chains_nuts``,
``sample_posterior(algorithm="hmc_sweep")``) turn their key into an int seed
and sweep on ``jax.random.key(seed, impl="rbg")``, whose bits JAX's CPU
backend draws with XLA's Philox4x32-10. The port reproduces that stream
(``core/keys.py``: rbg keys, ``randint``, ``bernoulli``), its twins draw it
(``_reference_hmc`` and ``nuts_sweep_cols`` with ``rng="rbg"``, the
single-chain ``nuts_transition`` under a key), and so do K1's and K4's rbg
kernels on the card (the ``cuda`` cases, against the twins). Bits, splits,
fold-ins, integers and coin flips are held equal to ``jax.random``'s,
normals to rtol 1e-6; positions within 1e-4 for at least 99% of chains,
statistics to 1e-5. The file imports JAX inside the CPU tests only, so that
its ``cuda`` cases run on the card, where JAX is not installed.
"""

import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.core import keys
from genjax_tpu_torch.inference import mcmc, sample_posterior
from genjax_tpu_torch.kernels import bodies, hmc, nuts_pallas
from genjax_tpu_torch.kernels.nuts import nuts_sweep_cols, nuts_transition
from torch_threads import _one_thread  # noqa: F401

SEEDS = [0, 1, 42, 2**31 - 1, 2**32 + 5, -3]
# key words of an rbg key: two made by key(), a carry of w2 into w3 within
# the first blocks, and one whose halves differ
WORDS = [[0, 0, 0, 0], [0, 42, 0, 42], [7, 9, 0xFFFFFFF0, 5], [1, 2, 3, 4]]
POS_TOL = 1e-4


def jr():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax.random


def jkey(words):
    import jax.numpy as jnp

    return jr().wrap_key_data(jnp.asarray(np.asarray(words, np.uint32)), impl="rbg")


def tkey(words):
    return torch.tensor(words, dtype=torch.int64)


def words_of(jkeys):
    return np.asarray(jr().key_data(jkeys)).astype(np.int64)


def agree(a, b, share=0.99, tol=POS_TOL):
    """At least ``share`` of the chains (columns of ``(D, N)``, or entries
    of ``(N,)``) within ``tol`` in every row."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    ok = np.abs(a - b) <= tol
    ok = ok.all(axis=0) if ok.ndim > 1 else ok
    assert ok.mean() >= share, f"{ok.mean():.4f} of chains within {tol}"


def close(a, b, tol=1e-5):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=1e-6)


# ----------------------------------------------------------------------
# rbg keys, randint and bernoulli
# ----------------------------------------------------------------------


@pytest.mark.parametrize("words", WORDS)
@pytest.mark.parametrize("shape", [(), (5,), (3, 7), (16, 4096)])
def test_rbg_bits_equal_jax(words, shape):
    got = keys.bits(tkey(words), shape).numpy()
    want = np.asarray(jr().bits(jkey(words), shape)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_rbg_key_split_and_fold_in_equal_jax(seed):
    k, ref = keys.key(seed, device="cpu", impl="rbg"), jr().key(seed, impl="rbg")
    np.testing.assert_array_equal(k.numpy(), words_of(ref))
    assert k.shape == (4,) and keys.key(seed, device="cpu").shape == (2,)
    for num in (2, 3, (2, 3)):
        np.testing.assert_array_equal(keys.split(k, num).numpy(), words_of(jr().split(ref, num)))
    for data in (0, 9, 1 << 30):
        np.testing.assert_array_equal(keys.fold_in(k, data).numpy(), words_of(jr().fold_in(ref, data)))
    batch = keys.split(k, 4)
    np.testing.assert_array_equal(keys.fold_in(batch, torch.arange(4)).numpy(),
                                  np.stack([words_of(jr().fold_in(kk, i))
                                            for i, kk in enumerate(jr().split(ref, 4))]))


@pytest.mark.parametrize("words", WORDS + [[w, s, w, s] for w, s in ((0, 1), (0, 7))])
@pytest.mark.parametrize("shape", [(3,), (9, 256), (16, 4096)])
def test_rbg_uniform_equal_and_normal_close(words, shape):
    np.testing.assert_array_equal(keys.uniform(tkey(words), shape).numpy(),
                                  np.asarray(jr().uniform(jkey(words), shape)))
    np.testing.assert_allclose(keys.normal(tkey(words), shape).numpy(),
                               np.asarray(jr().normal(jkey(words), shape)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_and_bernoulli_equal_jax(impl, seed):
    k, ref = keys.key(seed, device="cpu", impl=impl), jr().key(seed, impl=impl)
    for shape, lo, hi in [((), 0, 2**30), ((7,), -5, 17), ((3, 4), -(2**31), 2**31 - 1), ((5,), 3, 3),
                          ((5,), 10, 2)]:
        np.testing.assert_array_equal(keys.randint(k, shape, lo, hi).numpy(),
                                      np.asarray(jr().randint(ref, shape, lo, hi)).astype(np.int64))
    for p, shape in [(0.5, (64,)), (0.3, (4, 5)), (0.9, ())]:
        np.testing.assert_array_equal(keys.bernoulli(k, p, shape).numpy(),
                                      np.asarray(jr().bernoulli(ref, p, shape)))


def test_an_rbg_key_refuses_float64_uniforms():
    with pytest.raises(TypeError, match="rbg"):
        keys.uniform(keys.key(0, device="cpu", impl="rbg"), (3,), dtype=torch.float64)
    with pytest.raises(ValueError, match="impl"):
        keys.key(0, device="cpu", impl="philox")


# ----------------------------------------------------------------------
# the plain versions on the rbg stream: D = 9, N = 256, 5 steps
# ----------------------------------------------------------------------

D, N = 9, 256
_SCALE = np.linspace(0.5, 2.0, D).astype(np.float32)
_INV_MASS = np.linspace(0.5, 1.5, D).astype(np.float32)


def t_ld(q):
    s = torch.from_numpy(_SCALE)[:, None]
    return -0.5 * torch.sum((q / s) ** 2, 0) - 0.05 * torch.sum(q**4, 0)


def j_ld(q):
    import jax.numpy as jnp

    return -0.5 * jnp.sum((q / _SCALE[:, None]) ** 2, 0) - 0.05 * jnp.sum(q**4, 0)


def _q0(d=D, n=N, seed=0):
    return np.random.default_rng(seed).normal(size=(d, n)).astype(np.float32)


def test_hmc_twin_on_the_rbg_stream_draw_for_draw():
    from genjax_tpu.kernels.hmc import _reference_hmc as ref_hmc

    q0 = _q0()
    want, want_acc = ref_hmc(j_ld, q0, 123, n_steps=5, eps=0.2, L=5, inv_mass=_INV_MASS)
    got, acc = hmc._reference_hmc(t_ld, torch.from_numpy(q0), 123, n_steps=5, eps=0.2, L=5,
                                  inv_mass=_INV_MASS, rng="rbg")
    agree(got, want)
    close(acc, want_acc)
    # the draws themselves: step 3's momentum and accept uniforms
    step = jr().split(jr().key(123, impl="rbg"), 5)[3]
    kp, ku = jr().split(step)
    tp, tu = keys.split(hmc.rbg_step_keys(123, 5, "cpu")[3]).unbind(-2)
    np.testing.assert_allclose(hmc.rbg_rows_normal(tp, D, N).numpy(), np.asarray(jr().normal(kp, (D, N))),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(keys.uniform(tu, (N,)).numpy(), np.asarray(jr().uniform(ku, (N,))))


def test_nuts_twin_on_the_rbg_stream_draw_for_draw():
    from genjax_tpu.kernels.nuts import nuts_sweep_cols as ref_nuts

    q0 = _q0(seed=1)
    want, want_acc, want_leaps = ref_nuts(j_ld, q0, 77, n_steps=5, eps=0.3, max_depth=6, inv_mass=_INV_MASS)
    got, acc, leaps = nuts_sweep_cols(t_ld, torch.from_numpy(q0), 77, n_steps=5, eps=0.3, max_depth=6,
                                      inv_mass=_INV_MASS, rng="rbg")
    agree(got, want)
    close(acc, want_acc)
    close(leaps, want_leaps)


def test_rbg_row_map_draws_the_reference_rows():
    """A packed block's rows in another order, with padding: each launch row
    draws its reference row, the padding 0."""
    k = keys.key(5, device="cpu", impl="rbg")
    rows = [2, 0, 1, -1, -1]
    z = hmc.rbg_rows_normal(k, 5, 6, rows)
    ref = keys.normal(k, (3, 6))
    assert torch.equal(z[0], ref[2]) and torch.equal(z[1], ref[0]) and torch.equal(z[2], ref[1])
    assert torch.equal(z[3:], torch.zeros(2, 6))
    with pytest.raises(ValueError, match="distinct"):
        hmc.rbg_rows_on((0, 0, -1), 3, torch.device("cpu"))


def test_the_key_tables_hold_the_references_keys():
    """K1's table holds each step's ``(kp, ku)``; the NUTS table (the twin's
    and K4's) each transition's ``kr``, direction, subtree and leaf keys at
    the places the kernel reads, as the reference derives them."""
    t1 = hmc.rbg_keys_table(11, 4, torch.device("cpu"))
    steps = hmc.rbg_step_keys(11, 4, "cpu")
    assert torch.equal(t1.to(torch.int64) & 0xFFFFFFFF, keys.split(steps))
    md = 4
    table = nuts_pallas.rbg_keys_table(11, 3, md, torch.device("cpu")).to(torch.int64) & 0xFFFFFFFF
    assert table.shape == (3, nuts_pallas.rbg_keys_stride(md), 4)
    ref_steps = jr().split(jr().key(11, impl="rbg"), 3)
    for t in range(3):
        kr, kd, ku = jr().split(ref_steps[t], 3)
        want = [kr] + [jr().fold_in(kd, j) for j in range(md)]
        want += [jr().fold_in(jr().fold_in(ku, j), 1 << 30) for j in range(md)]
        want += [jr().fold_in(jr().fold_in(ku, j), i) for j in range(md) for i in range(1 << j)]
        np.testing.assert_array_equal(table[t].numpy(), np.stack([words_of(k) for k in want]))


def test_the_single_chain_transition_under_a_key():
    """``nuts_transition`` vmapped over split keys against the reference's
    (threefry keys, the request's stream), and ``nuts_transition_cols``
    given a key."""
    import jax

    from genjax_tpu.kernels.nuts import nuts_transition as ref_transition

    q0 = _q0(n=16, seed=2)
    tk_, jk_ = keys.split(keys.key(3, device="cpu"), 16), jr().split(jr().key(3), 16)
    got, info = torch.func.vmap(lambda k, z: nuts_transition(lambda x: t_ld(x[:, None])[0], z, k, 0.3,
                                                             max_depth=3, inv_mass=_INV_MASS),
                                in_dims=(0, 1), out_dims=(1, 0))(tk_, torch.from_numpy(q0))
    want, winfo = jax.jit(jax.vmap(lambda k, z: ref_transition(lambda x: j_ld(x[:, None])[0], z, k, 0.3, max_depth=3,
                                                               inv_mass=_INV_MASS), in_axes=(0, 1), out_axes=(1, 0)))(jk_, q0)
    agree(got, want)
    np.testing.assert_array_equal(info.num_leapfrogs.numpy(), np.asarray(winfo.num_leapfrogs))
    from genjax_tpu.kernels.nuts import nuts_transition_cols as ref_cols
    from genjax_tpu_torch.kernels.nuts import nuts_transition_cols

    got, info = nuts_transition_cols(t_ld, torch.from_numpy(q0), keys.key(4, device="cpu", impl="rbg"), 0.3,
                                     max_depth=4)
    want, winfo = jax.jit(lambda k, q: ref_cols(j_ld, q, k, 0.3, max_depth=4))(jr().key(4, impl="rbg"), q0)
    agree(got, want)
    close(info.accept_prob.mean(), np.mean(winfo.accept_prob))


# ----------------------------------------------------------------------
# the drivers and the request under key(0)
# ----------------------------------------------------------------------


def _flagship(n_chains):
    """The flagship's traces in both packages from the same keys: 16 x 8
    numpy inputs, ``key(1)``'s split over the chains."""
    import genjax_tpu as gj
    from genjax_tpu.models import hierarchical_regression as ref_model
    from genjax_tpu_torch.models import hierarchical_regression

    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    model, model_ref = hierarchical_regression(torch.from_numpy(X)), ref_model(X)
    obs, obs_ref = g.C["y"].set(torch.from_numpy(y)), gj.C["y"].set(y)
    trs = torch.func.vmap(lambda k: model.generate(k, obs, ())[0])(keys.split(keys.key(1, device="cpu"), n_chains))
    import jax

    ref = jax.jit(jax.vmap(lambda k: model_ref.generate(k, obs_ref, ())[0]))(jr().split(jr().key(1), n_chains))
    return trs, ref


def test_run_chains_hmc_and_nuts_under_a_key_draw_for_draw():
    import genjax_tpu as gj

    trs, ref = _flagship(32)
    sel, sel_ref = g.S["w"] | g.S["tau"], gj.S["w"] | gj.S["tau"]
    new, acc = g.run_chains_hmc(keys.key(0, device="cpu"), trs, sel, eps=0.02, L=5, n_steps=5)
    import jax

    want, want_acc = jax.jit(lambda k, t: gj.run_chains_hmc(k, t, sel_ref, eps=0.02, L=5, n_steps=5))(jr().key(0), ref)
    assert g.run_chains_hmc.last_backend == "torch"
    for addr in ("tau", "w"):
        agree(new.get_choices()[addr].reshape(32, -1).T, np.asarray(want.get_choices()[addr]).reshape(32, -1).T)
    close(acc, want_acc)
    close(new.get_score(), want.get_score(), tol=1e-4)
    new, acc, leaps = g.run_chains_nuts(keys.key(0, device="cpu"), trs, sel, eps=0.05, max_depth=4, n_steps=2)
    want, want_acc, want_leaps = jax.jit(lambda k, t: gj.run_chains_nuts(k, t, sel_ref, eps=0.05, max_depth=4,
                                                                         n_steps=2))(jr().key(0), ref)
    for addr in ("tau", "w"):
        agree(new.get_choices()[addr].reshape(32, -1).T, np.asarray(want.get_choices()[addr]).reshape(32, -1).T)
    close(acc, want_acc)
    close(leaps, want_leaps)


def test_the_nuts_request_under_a_key_draw_for_draw():
    import jax

    import genjax_tpu as gj

    trs, ref = _flagship(8)
    sel, sel_ref = g.S["w"] | g.S["tau"], gj.S["w"] | gj.S["tau"]
    req, req_ref = g.NUTS(sel, 0.05, max_depth=3), gj.NUTS(sel_ref, 0.05, max_depth=3)
    new = torch.func.vmap(lambda k, tr: tr.edit(k, req)[0])(keys.split(keys.key(2, device="cpu"), 8), trs)
    want = jax.jit(jax.vmap(lambda k, tr: tr.edit(k, req_ref)[0]))(jr().split(jr().key(2), 8), ref)
    for addr in ("tau", "w"):
        agree(new.get_choices()[addr].reshape(8, -1).T, np.asarray(want.get_choices()[addr]).reshape(8, -1).T,
              share=1.0)


def _linear(n_obs=6, d=2):
    import genjax_tpu as gj
    from genjax_tpu.models import linear_regression as ref_linear
    from genjax_tpu_torch.models import linear_regression

    X = np.random.default_rng(3).normal(size=(n_obs, d)).astype(np.float32)
    y = np.random.default_rng(4).normal(size=(n_obs,)).astype(np.float32)
    (model, _), (model_ref, _) = linear_regression(torch.from_numpy(X)), ref_linear(X)
    return model, g.C["y"].set(torch.from_numpy(y)), model_ref, gj.C["y"].set(y)


@pytest.mark.parametrize("algorithm,budget", [("nuts", dict(max_depth=3)), ("hmc", dict(L=3)),
                                              ("hmc_sweep", dict(L=5))])
def test_sample_posterior_under_a_key_draw_for_draw(algorithm, budget):
    """16 chains, six warmup windows of one transition, three draws. Each window's inverse mass is a 16-chain variance of a cloud
    that shrinks as it adapts, which amplifies the float32 rounding that
    differs between XLA (its fused multiply-adds) and torch: the same run
    with a seventh warmup transition (eps 0.33) still takes every accept
    decision alike, but its positions drift to 9e-4 apart."""
    import genjax_tpu as gj

    model, obs, model_ref, obs_ref = _linear()
    kw = dict(n_chains=16, n_warmup=6, n_samples=3, algorithm=algorithm, eps0=0.1, **budget)
    res = sample_posterior(keys.key(0, device="cpu"), model, obs, (), g.S["w"], device="cpu", **kw)
    from genjax_tpu.inference import sample_posterior as ref_sample_posterior

    want = ref_sample_posterior(jr().key(0), model_ref, obs_ref, (), gj.S["w"], **kw)
    close(res.eps, want.eps)
    close(res.inv_mass, want.inv_mass, tol=1e-4)
    draws, ref_draws = res["w"].numpy(), np.asarray(want["w"])
    assert draws.shape == ref_draws.shape == (16, 3, 2)
    agree(draws.reshape(16, -1).T, ref_draws.reshape(16, -1).T)
    close(res.accept_rate, want.accept_rate)


def test_a_checkpointed_keyed_run_resumes_bit_for_bit(tmp_path):
    model, obs, _m, _o = _linear()
    kw = dict(n_chains=8, n_warmup=4, n_samples=4, algorithm="hmc_sweep", eps0=0.1, L=3, device="cpu")
    whole = sample_posterior(keys.key(5, device="cpu"), model, obs, (), g.S["w"], **kw)
    ck = str(tmp_path / "ck")
    part = sample_posterior(keys.key(5, device="cpu"), model, obs, (), g.S["w"], checkpoint_dir=ck,
                              checkpoint_every=1, max_segments=2, **kw)
    assert part["w"].shape[1] == 2
    rest = sample_posterior(keys.key(5, device="cpu"), model, obs, (), g.S["w"], checkpoint_dir=ck,
                              checkpoint_every=1, **kw)
    assert torch.equal(rest["w"], whole["w"]) and torch.equal(rest.accept_rate, whole.accept_rate)
    with pytest.raises(ValueError, match="different run"):
        sample_posterior(keys.key(6, device="cpu"), model, obs, (), g.S["w"], checkpoint_dir=ck,
                           checkpoint_every=1, **kw)


def test_a_key_where_the_keyed_path_does_not_reach_raises():
    model, obs, _m, _o = _linear()
    with pytest.raises(ValueError, match="a key with mesh= is not reproduced"):
        sample_posterior(keys.key(0, device="cpu"), model, obs, (), g.S["w"], algorithm="chees", device="cpu",
                           n_chains=4, n_warmup=2, n_samples=2, mesh=object())
    with pytest.raises(ValueError, match="the key lives on meta"):
        sample_posterior(keys.key(0, device="meta"), model, obs, (), g.S["w"], device="cpu", n_chains=4)


def test_on_the_kernels_route_a_key_launches_the_rbg_stream(monkeypatch):
    """Through the kernels' route (the traces reported on the card), a keyed
    driver asks K1 and K4 for the rbg stream with the packer's row map, and
    a generator keeps the Philox stream."""
    trs, _ref = _flagship(8)
    monkeypatch.setattr(mcmc, "trace_device", lambda tree: torch.device("cuda"))
    seen = []
    monkeypatch.setattr(hmc, "hmc_sweep", lambda body, q, seed, **kw: seen.append(("K1", kw)) or
                        (q, torch.zeros(q.shape[1])))
    monkeypatch.setattr(nuts_pallas, "nuts_sweep", lambda body, q, seed, **kw: seen.append(("K4", kw)) or
                        (q, torch.zeros(q.shape[1]), torch.zeros(q.shape[1])))
    sel = g.S["w"] | g.S["tau"]
    g.run_chains_hmc(keys.key(0, device="cpu"), trs, sel, eps=0.02, n_steps=2)
    g.run_chains_nuts(keys.key(0, device="cpu"), trs, sel, eps=0.02, n_steps=2)
    g.run_chains_hmc(torch.Generator().manual_seed(0), trs, sel, eps=0.02, n_steps=2)
    (k1, kw1), (k4, kw4), (_k, kw_gen) = seen
    assert (k1, k4) == ("K1", "K4") and kw1["rng"] == kw4["rng"] == "rbg" and kw_gen["rng"] == "philox"
    rows = kw1["stream_rows"]
    assert len(rows) == 16 and sorted(r for r in rows if r >= 0) == list(range(9)) and rows.count(-1) == 7
    assert g.run_chains_hmc.last_backend == "cuda"


# ----------------------------------------------------------------------
# on the card: K1's and K4's rbg kernels against their plain versions
# ----------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4099])  # four chains a momentum Philox call, and one a word
def test_k1_rbg_kernel_matches_its_plain_version(n):
    from genjax_tpu_torch.kernels.model_interface import ColumnPacker, column_logdensity
    from genjax_tpu_torch.models import hierarchical_regression

    dev = _cuda()
    X = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(1).normal(size=(16,)).astype(np.float32))
    model = hierarchical_regression(X)
    obs = g.C["y"].set(y.to(dev))
    packer = ColumnPacker(model, obs, (), ["tau", "w"], device=dev)
    ld = column_logdensity(model, obs, (), packer)
    q0 = torch.from_numpy(_q0(16, n, seed=5)).to(dev)
    q0[0] = q0[0].abs() + 0.5
    hmc.hmc_sweep_launches = 0
    rows = list(range(1, 9)) + [0] + [-1] * 7  # a packed block's rows moved, its padding drawing nothing
    got, acc = hmc.pallas_hmc(ld, q0, 9, n_steps=5, eps=0.02, L=5, rng="rbg", stream_rows=rows)
    assert hmc.hmc_sweep_launches == 1
    want, want_acc = hmc.pallas_hmc(ld, q0, 9, n_steps=5, eps=0.02, L=5, rng="rbg", stream_rows=rows,
                                    backend="torch")
    agree(got.cpu(), want.cpu().numpy(), share=0.995)
    assert abs(float(acc) - float(want_acc)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,block", [(2048, None), (2050, None), (2048, 30)])
def test_k4_rbg_kernel_matches_its_plain_version(n, block):
    """Groups of four chains share the momentum's Philox calls where N and
    the block are multiples of 4, and draw one call a word otherwise."""
    dev = _cuda()
    q0 = torch.from_numpy(_q0(8, n, seed=6)).to(dev)
    ld = bodies.iid_normal()
    nuts_pallas.nuts_sweep_launches = 0
    got, acc, leaps = nuts_pallas.pallas_nuts(ld, q0, 9, n_steps=3, eps=0.3, max_depth=6, rng="rbg", block_n=block)
    assert nuts_pallas.nuts_sweep_launches == 1
    want, want_acc, want_leaps = nuts_pallas.pallas_nuts(ld, q0, 9, n_steps=3, eps=0.3, max_depth=6, rng="rbg",
                                                         backend="torch")
    agree(got.cpu(), want.cpu().numpy(), share=0.99)
    assert abs(float(leaps) - float(want_leaps)) < 0.05 * float(want_leaps)
