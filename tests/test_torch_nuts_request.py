"""The NUTS trace path of the port: ``nuts_transition`` (one chain, a fixed
budget, under ``torch.func.vmap``), the ``NUTS`` edit request, and the
batched runner ``run_chains_nuts`` with the launch it shares with
``run_chains_hmc`` and ``sample_posterior(algorithm="hmc_sweep")``.

The port draws from a ``torch.Generator`` where the reference splits keys,
so chains are held in law: against the column twin ``nuts_sweep_cols`` (the
same sampler over an explicit batch, itself held draw for draw against the
reference's Pallas kernel in ``test_torch_nuts.py``) and against the
conjugate closed forms of ``tests/inference/test_nuts_request.py``; each
limit is stated beside its check (``test_torch_nuts_reference.py`` holds
them against the reference's own). The file imports no JAX, so that its
``cuda`` cases run on the card, where JAX is not installed.
"""

import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import mcmc, sample
from genjax_tpu_torch.kernels import hmc, nuts_pallas
from genjax_tpu_torch.kernels.model_interface import PAD_INV_MASS, ColumnPacker
from genjax_tpu_torch.kernels.nuts import nuts_sweep_cols, nuts_transition
from genjax_tpu_torch.models import hierarchical_regression
from torch_threads import _one_thread  # noqa: F401


def gen_at(seed, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


# ----------------------------------------------------------------------
# nuts_transition under vmap, in law against the column twin
# ----------------------------------------------------------------------

_PREC = torch.tensor([[1.0, 0.9], [0.9, 1.0]]).inverse()  # correlation 0.9, unit variances

TARGETS = {
    # name: (one chain's log-density, the batch's column log-density, D, eps)
    "standard_normal": (lambda z: -0.5 * (z * z).sum(), lambda q: -0.5 * (q * q).sum(0), 3, 0.5),
    "correlated": (lambda z: -0.5 * z @ _PREC @ z, lambda q: -0.5 * (q * (_PREC @ q)).sum(0), 2, 0.25),
    # mu ~ N(0, 1), y = 2 ~ N(mu, 1): the posterior N(1, 1/2)
    "conjugate": (lambda z: -0.5 * (z * z).sum() - 0.5 * ((2.0 - z) ** 2).sum(),
                  lambda q: -0.5 * (q * q).sum(0) - 0.5 * ((2.0 - q) ** 2).sum(0), 1, 0.6),
}
MOMENTS = {
    "standard_normal": (torch.zeros(3), torch.ones(3)),
    "correlated": (torch.zeros(2), torch.ones(2)),
    "conjugate": (torch.ones(1), torch.full((1,), 0.5)),
}


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_vmapped_transition_in_law_with_the_column_twin(name):
    """1,024 chains from the same numpy start, 12 transitions at depth 5 by
    the vmapped single-chain transition and by ``nuts_sweep_cols``: the
    accept statistics within 0.02 and the mean leapfrogs within 5% of each
    other, and both batches' moments at the target's (means within 0.15,
    variances within 20%)."""
    ld, ld_cols, d, eps = TARGETS[name]
    n, steps = 1024, 12
    q0 = torch.from_numpy(np.random.default_rng(7).normal(size=(d, n)).astype(np.float32))
    gen = gen_at(1)
    step = torch.func.vmap(lambda z: nuts_transition(ld, z, gen, eps, max_depth=5), randomness="different")
    z, accs, leaps, depths = q0.T.clone(), [], [], []
    for _ in range(steps):
        z, info = step(z)
        accs.append(info.accept_prob.mean())
        leaps.append(info.num_leapfrogs.float().mean())
        depths.append(info.depth.float())
        assert info.num_leapfrogs.dtype == torch.int32 and not bool(info.diverged.any())
        # a chain that stopped after `depth` doublings took 2**depth - 1 leapfrogs
        assert torch.equal(info.num_leapfrogs, (1 << info.depth) - 1)
    acc_v, leaps_v = float(torch.stack(accs).mean()), float(torch.stack(leaps).mean())
    q, acc_c, leaps_c = nuts_sweep_cols(ld_cols, q0, 2, n_steps=steps, eps=eps, max_depth=5)
    assert abs(acc_v - float(acc_c)) < 0.02, (acc_v, float(acc_c))
    assert abs(leaps_v - float(leaps_c)) < 0.05 * float(leaps_c), (leaps_v, float(leaps_c))
    depth = torch.stack(depths)
    assert bool(((depth >= 1) & (depth <= 5)).all())
    mean, var = MOMENTS[name]
    for batch in (z, q.T):
        assert bool(((batch.mean(0) - mean).abs() < 0.15).all()), batch.mean(0)
        assert bool(((batch.var(0) / var - 1.0).abs() < 0.2).all()), batch.var(0)


def test_chains_draw_their_own_randomness():
    """Under vmap with ``randomness="different"`` every chain gets its own
    momentum, directions and uniforms: chains started at one point part."""
    gen = gen_at(3)
    ld = TARGETS["standard_normal"][0]
    z = torch.zeros(64, 3)
    out, info = torch.func.vmap(lambda z: nuts_transition(ld, z, gen, 0.5, max_depth=4),
                                randomness="different")(z)
    assert len({tuple(row.tolist()) for row in out}) == 64


def test_inv_mass_column_shape_is_accepted():
    """A ``(D, 1)`` inverse mass (the column layout's) gives what ``(D,)``
    gives, draw for draw from the same generator state, and the leapfrogs
    reflect it: a mass matched to a 100x-conditioned target needs fewer."""
    scales = torch.tensor([0.1, 10.0])
    ld = lambda z: -0.5 * ((z / scales) ** 2).sum()  # noqa: E731
    z0 = torch.tensor([0.05, -3.0])
    flat = nuts_transition(ld, z0, gen_at(5), 0.15, max_depth=6, inv_mass=scales**2)
    col = nuts_transition(ld, z0, gen_at(5), 0.15, max_depth=6, inv_mass=(scales**2)[:, None])
    assert torch.equal(flat[0], col[0]) and all(torch.equal(a, b) for a, b in zip(flat[1], col[1]))
    plain = nuts_transition(ld, z0, gen_at(5), 0.015, max_depth=6)
    assert int(flat[1].num_leapfrogs) < int(plain[1].num_leapfrogs)


def test_divergence_is_flagged_and_gated():
    """A step far too large for a narrow target diverges (the energy rises
    past 1000) at its first leaf: the chain stops after that doubling, and
    keeps a finite position."""
    ld = lambda z: -0.5 * ((z / 0.01) ** 2).sum()  # noqa: E731
    z, info = nuts_transition(ld, torch.tensor([0.01, -0.01]), gen_at(0), 5.0, max_depth=5)
    assert bool(info.diverged) and int(info.depth) == 1 and int(info.num_leapfrogs) == 1
    assert bool(torch.isfinite(z).all())


# ----------------------------------------------------------------------
# the NUTS edit request
# ----------------------------------------------------------------------


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


OBS = g.C["y"].set(2.0)  # posterior N(1, 1/2)


def _init(n, seed=0):
    gen = gen_at(seed)
    return torch.func.vmap(lambda _: conjugate.generate(gen, OBS, ())[0], randomness="different")(
        torch.zeros(n)
    )


def test_conjugate_posterior_recovery():
    """512 chains, 25 vmapped ``tr.edit(NUTS(S["mu"], 0.4))`` each (the
    reference's test runs 40): the final draws' mean within 0.1 of 1 and sd
    within 0.08 of 1/sqrt(2)."""
    gen = gen_at(1)
    step = torch.func.vmap(lambda tr: tr.edit(gen, g.NUTS(g.S["mu"], 0.4, max_depth=4))[0],
                           randomness="different")
    trs = _init(512)
    for _ in range(25):
        trs = step(trs)
    mu = trs["mu"]
    assert abs(float(mu.mean()) - 1.0) < 0.1 and abs(float(mu.std()) - 1.0 / np.sqrt(2.0)) < 0.08


def test_multi_address_and_vector_choices():
    """NUTS ravels a scalar and a vector address into one position; their
    prior scales (2 and 0.5) come back within 15% and 20%."""

    @g.gen
    def model():
        a = g.normal(0.0, 2.0) @ "a"
        b = g.mv_normal_diag(torch.zeros(3), 0.5 * torch.ones(3)) @ "b"
        return a + b.sum()

    gen = gen_at(2)
    trs = torch.func.vmap(lambda _: model.simulate(gen, ()), randomness="different")(torch.zeros(512))
    step = torch.func.vmap(lambda tr: tr.edit(gen, g.NUTS(g.S["a"] | g.S["b"], 0.25, max_depth=4))[0],
                           randomness="different")
    for _ in range(20):
        trs = step(trs)
    assert abs(float(trs["a"].std()) / 2.0 - 1.0) < 0.15
    assert abs(float(trs["b"].std()) / 0.5 - 1.0) < 0.2


def test_weight_zero_and_untouched_choices_fixed():
    tr = conjugate.simulate(gen_at(0), ())
    y0 = float(tr["y"])
    new_tr, w, _rd, bwd = tr.edit(gen_at(1), g.NUTS(g.S["mu"], 0.3, max_depth=4))
    assert float(w) == 0.0 and w.dtype == torch.float32
    assert float(new_tr["y"]) == y0
    assert isinstance(bwd, g.NUTS) and bwd.max_depth == 4 and bwd.eps == 0.3
    score, _ = conjugate.assess(new_tr.get_choices(), ())
    torch.testing.assert_close(new_tr.get_score(), score, atol=1e-5, rtol=0.0)
    # edit_with_info reports the transition's health beside the edit
    *_, info = g.NUTS(g.S["mu"], 0.3, max_depth=4).edit_with_info(
        gen_at(1), tr, g.Diff.tree_diff_no_change(tr.get_args())
    )
    assert 0.0 <= float(info.accept_prob) <= 1.0 and int(info.num_leapfrogs) >= 1


def test_nuts_in_mh_driver_and_changed_args_rejected():
    @g.gen
    def model(s):
        return g.normal(0.0, s) @ "x"

    tr = model.simulate(gen_at(0), (1.0,))
    _new_tr, accepted = g.mh(gen_at(2), tr, g.NUTS(g.S["x"], 0.5, max_depth=3))
    assert bool(accepted)  # alpha = 0 accepts always; NUTS accepts inside
    with pytest.raises(NotImplementedError):
        g.NUTS(g.S["x"], 0.5).edit(gen_at(3), tr, (g.Diff(2.0, g.UnknownChange),))


# ----------------------------------------------------------------------
# run_chains_nuts and the shared launch
# ----------------------------------------------------------------------


@pytest.mark.parametrize("chain_axis", [0, -1])
def test_run_chains_nuts_conjugate_moments(chain_axis):
    """1,024 chains x 30 transitions on the CPU (the twin over the GFI's
    ``assess``), chains first or last (the reference's lanes layout):
    posterior mean within 0.05 of 1, variance within 0.06 of 1/2, accept
    statistic over 0.6, leapfrogs at least 1; ``y`` stays the observation."""
    trs = _init(1024)
    if chain_axis == -1:
        trs = torch.utils._pytree.tree_map(lambda v: v.movedim(0, -1), trs)
    nuts_pallas.nuts_sweep_launches = 0
    new, acc, leaps = g.run_chains_nuts(gen_at(1), trs, g.S["mu"], eps=0.6, max_depth=5, n_steps=30,
                                        chain_axis=chain_axis)
    assert g.run_chains_nuts.last_backend == "torch" and nuts_pallas.nuts_sweep_launches == 0
    mu = new["mu"].movedim(chain_axis, 0)
    assert abs(float(mu.mean()) - 1.0) < 0.05 and abs(float(mu.var()) - 0.5) < 0.06
    assert float(acc) > 0.6 and float(leaps) >= 1.0
    assert torch.equal(new["y"], trs["y"])
    assert torch.utils._pytree.tree_structure(new) == torch.utils._pytree.tree_structure(trs)


def test_run_chains_nuts_inv_mass_and_routing():
    trs = _init(64)
    new, _acc, _leaps = g.run_chains_nuts(gen_at(1), trs, g.S["mu"], eps=0.6, max_depth=3,
                                          inv_mass=torch.tensor([0.5]))
    assert new["mu"].shape == (64,)
    # 'cuda' stages the model into a device body and reaches the kernel's
    # wrapper, which takes no CPU tensor
    with pytest.raises(ValueError, match="takes a CUDA tensor"):
        g.run_chains_nuts(gen_at(0), trs, g.S["mu"], eps=0.1, backend="cuda")
    with pytest.raises(ValueError, match="backend must be"):
        g.run_chains_nuts(gen_at(0), trs, g.S["mu"], eps=0.1, backend="xla")


@g.gen
def cumsummed():
    x = g.normal(torch.zeros(3), torch.ones(3)) @ "x"
    _ = g.normal(torch.cumsum(x, 0)[-1], 1.0) @ "y"


def test_on_the_card_auto_raises_without_a_device_body(monkeypatch):
    """With the traces taken to live on a CUDA device, ``run_chains_nuts``
    and ``sample_posterior(hmc_sweep)``'s launch (``_ColumnSweep``) take the
    kernel under ``auto`` for a model staged into a device body (the
    conjugate model), and refuse one whose density cannot be staged,
    naming ``backend="torch"``; ``backend="torch"`` runs the twin on
    purpose."""
    monkeypatch.setattr(mcmc, "trace_device", lambda tree: torch.device("cuda"))
    g.run_chains_nuts.last_backend = None
    with pytest.raises(ValueError, match="takes a CUDA tensor"):
        g.run_chains_nuts(gen_at(0), _init(8), g.S["mu"], eps=0.1)
    assert g.run_chains_nuts.last_backend is None
    run = mcmc._ColumnSweep(_init(8), g.S["mu"], 0, "auto", "sample_posterior")
    assert run.backend == "cuda" and run.body_name == "staged" and run.view.body.k == 0
    gen = gen_at(3)
    unstageable = torch.func.vmap(lambda _: cumsummed.generate(gen, g.C["y"].set(0.5), ())[0],
                                  randomness="different")(torch.zeros(8))
    with pytest.raises(ValueError, match="Pass backend='torch' to run the plain torch twin"):
        g.run_chains_nuts(gen_at(0), unstageable, g.S["x"], eps=0.1)
    with pytest.raises(ValueError, match="Pass backend='torch'"):
        mcmc._ColumnSweep(unstageable, g.S["x"], 0, "auto", "sample_posterior")
    g.run_chains_nuts(gen_at(0), _init(8), g.S["mu"], eps=0.1, max_depth=2, backend="torch")
    assert g.run_chains_nuts.last_backend == "torch" and g.run_chains_nuts.last_body is None


def flagship_data():
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return X, y


def _flagship_batch(n, seed=0, device="cpu"):
    X, y = flagship_data()
    model = hierarchical_regression(X)
    gen = gen_at(seed, device)
    obs = g.C["y"].set(torch.as_tensor(y, device=device))
    trs = torch.func.vmap(lambda _: model.generate(gen, obs, ())[0], randomness="different")(
        torch.zeros(n, device=device)
    )
    return model, gen, trs, obs


@pytest.mark.parametrize("order", [(("tau",), ("w",)), (("w",), ("tau",))], ids=["tau-w", "w-tau"])
def test_packer_owns_the_row_map_and_padding(order):
    """``ColumnPacker`` hands out the row map from ``z``'s order and the
    padding: ``pack_columns`` puts ``z``'s rows in the packer's order with
    fresh standard-normal padding, ``pack_inv_mass`` pads with ones, and
    ``unpack_columns`` inverts ``pack_columns`` on one block or a stack."""
    model, gen, trs, obs = _flagship_batch(32)
    packer = ColumnPacker(model, obs, (), [p[0] for p in order])
    rows = packer.row_map({("tau",): 0, ("w",): 1})
    tau_row = 0 if order[0] == ("tau",) else 8
    assert rows[tau_row] == 0 and sorted(rows) == list(range(9)) and packer.padded_dim == 16
    z, _, _ = mcmc.column_view(trs, g.S["w"] | g.S["tau"], 0)
    q = packer.pack_columns(z, rows, gen)
    assert tuple(q.shape) == (16, 32) and q.is_contiguous()
    assert torch.equal(q[:9], z[rows]) and torch.equal(q[tau_row], trs["tau"])
    assert torch.equal(packer.unpack_columns(q, rows), z)
    stack = torch.stack([q, q + 1.0])
    assert torch.equal(packer.unpack_columns(stack, rows), torch.stack([z, z + 1.0]))
    im = packer.pack_inv_mass(torch.arange(1.0, 10.0), rows, "cpu")
    assert torch.equal(im[:9], torch.arange(1.0, 10.0)[rows])
    assert torch.equal(im[9:], torch.full((7,), PAD_INV_MASS))
    assert torch.equal(packer.pack_inv_mass(None, rows, "cpu")[:9], torch.ones(9))


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_padding_rows_are_inert(sampler):
    """A packed block's padding rows, under ``PAD_INV_MASS``, do not move and
    change neither the accept statistics nor the NUTS trees: the body's
    plain version over the padded block runs the chain that it runs over
    the 9 real rows alone, to float32 rounding. The counter stream draws a
    row's normals from its own counter, so both runs see the same numbers."""
    model, gen, trs, obs = _flagship_batch(256)
    run = mcmc._ColumnSweep(trs, g.S["w"] | g.S["tau"], 0, "cuda", "test")
    body, rows = run.view.body, run.view.rows
    q = run.start(gen)
    im = run.inv_mass(None)

    def real(q):  # the body's density over the real rows alone
        return body(torch.cat([q, torch.zeros(7, q.shape[1])]))

    kw = dict(rng="counter", block_n=64)
    if sampler == "hmc":
        padded = hmc._reference_hmc(body, q, 9, n_steps=5, eps=0.02, L=5, inv_mass=im, **kw)
        alone = hmc._reference_hmc(real, q[:9], 9, n_steps=5, eps=0.02, L=5, **kw)
    else:
        padded = nuts_sweep_cols(body, q, 9, n_steps=3, eps=0.05, max_depth=5, inv_mass=im, **kw)
        alone = nuts_sweep_cols(real, q[:9], 9, n_steps=3, eps=0.05, max_depth=5, **kw)
    assert torch.equal(padded[0][9:], q[9:])
    for a, b in zip(padded[1:], alone[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(padded[0][:9], alone[0], rtol=1e-4, atol=1e-4)
    assert rows == list(range(9))


def test_the_shared_launch_on_the_twin():
    """``_ColumnSweep`` on the CPU: the launch block is ``z`` itself, the
    twin runs over the GFI's ``assess``, and ``finish`` is the identity."""
    model, gen, trs, obs = _flagship_batch(16)
    run = mcmc._ColumnSweep(trs, g.S["w"] | g.S["tau"], 0, "auto", "sample_posterior")
    assert run.backend == "torch" and run.view is None
    q = run.start(gen)
    assert q is run.z and run.real(q) is q and run.finish(q) is q and run.inv_mass(None) is None
    q1, acc = run.sweep(hmc.pallas_hmc, q, 3, None, n_steps=2, eps=0.02, L=2)
    assert q1.shape == (9, 16) and 0.0 <= float(acc) <= 1.0


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.mark.cuda
def test_run_chains_nuts_makes_one_k4_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    n = 4096
    model, gen, trs, _obs = _flagship_batch(n, device="cuda")
    sel = g.S["w"] | g.S["tau"]
    nuts_pallas.nuts_sweep_launches = 0
    new, acc, leaps = g.run_chains_nuts(gen, trs, sel, eps=0.05, max_depth=6, n_steps=5)
    assert g.run_chains_nuts.last_backend == "cuda" and nuts_pallas.nuts_sweep_launches == 1
    assert torch.equal(new["y"], trs["y"]) and new["w"].is_cuda
    twin, acc_t, leaps_t = g.run_chains_nuts(gen, trs, sel, eps=0.05, max_depth=6, n_steps=5,
                                             backend="torch")
    assert g.run_chains_nuts.last_backend == "torch" and nuts_pallas.nuts_sweep_launches == 1
    assert abs(float(acc) - float(acc_t)) < 0.02
    assert abs(float(leaps) - float(leaps_t)) < 0.05 * float(leaps_t)
    for addr in ("tau", "w"):
        xa, xb = new[addr].reshape(n, -1), twin[addr].reshape(n, -1)
        se = torch.sqrt((xa.var(dim=0) + xb.var(dim=0)) / n)
        assert bool((((xa.mean(dim=0) - xb.mean(dim=0)) / se).abs() < 4).all())


@pytest.mark.cuda
def test_sample_posterior_hmc_sweep_launch_count():
    """``min(6, n_warmup) + n_samples`` K1 launches: one a warmup window and
    one a draw, at any ``thin``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    model, _gen, _trs, obs = _flagship_batch(4, device="cuda")
    hmc.hmc_sweep_launches = 0
    res = sample.sample_posterior(
        0, model, obs, (), g.S["w"] | g.S["tau"], n_chains=4096, n_warmup=20, n_samples=7, thin=2,
        algorithm="hmc_sweep", eps0=0.02, L=5,
    )
    assert hmc.hmc_sweep_launches == 6 + 7
    assert res["w"].shape == (4096, 7, 8) and res["w"].is_cuda
    assert float(res.divergence_rate) == 0.0 and bool(torch.isfinite(res.rhat_of("tau")))


@pytest.mark.cuda
def test_address_less_body_scores_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")

    @g.gen
    def nothing(x):
        return x + 1.0

    x = torch.tensor(1.0, device="cuda")
    tr = nothing.simulate(gen_at(0, "cuda"), (x,))
    assert tr.get_score().is_cuda and nothing.assess(g.ChoiceMap.empty(), (x,))[0].is_cuda


@pytest.mark.cuda
def test_trace_path_on_the_card_with_cpu_constants_in_the_model():
    """``linear_regression`` makes its prior scale on the CPU; on the card
    its traces record it on the card, so ``mh(HMC)`` (which selects leaf by
    leaf) and NUTS run there through ``sample_posterior``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from genjax_tpu_torch.models import linear_regression

    X = np.random.default_rng(0).normal(size=(24, 3)).astype(np.float32)
    model, _exact = linear_regression(X)
    obs = g.C["y"].set(torch.zeros(24, device="cuda"))
    for algorithm in ("hmc", "nuts"):
        res = sample.sample_posterior(0, model, obs, (), g.S["w"], n_chains=64, n_warmup=4, n_samples=3,
                                      algorithm=algorithm, max_depth=3, L=3)
        assert res["w"].shape == (64, 3, 3) and res["w"].is_cuda

