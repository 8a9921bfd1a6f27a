"""The port's MCMC runners (``mh``, ``run_chain``, ``run_chains``,
``run_chains_hmc``) in law against the conjugate closed forms of the
reference's ``tests/inference/test_requests.py`` and
``tests/inference/test_run_chains_hmc.py``, with the structural invariants
of the batched runner (frozen choices stay, returned traces score what they
hold) and its routing between the CUDA sweep kernel and the plain twin.

The port draws from a ``torch.Generator`` where the reference splits keys,
so the comparison is of laws; each limit is stated beside its check.
"""

import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.inference import mcmc, sample_posterior
from genjax_tpu_torch.kernels import bodies, hmc
from genjax_tpu_torch.kernels.model_interface import PAD_INV_MASS
from genjax_tpu_torch.models import hierarchical_regression, linear_gaussian_ssm
from torch_threads import _one_thread  # noqa: F401


def gen_at(seed):
    return torch.Generator().manual_seed(seed)


def vmap_chains(fn, n):
    return torch.func.vmap(lambda _: fn(), randomness="different")(torch.zeros(n))


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


OBS = g.C["y"].set(2.0)  # posterior N(1, 0.5)


def _init(n, seed=0):
    gen = gen_at(seed)
    return vmap_chains(lambda: conjugate.generate(gen, OBS, ())[0], n)


@g.gen
def cumsummed():
    x = g.normal(torch.zeros(3), torch.ones(3)) @ "x"
    _ = g.normal(torch.cumsum(x, 0)[-1], 1.0) @ "y"


def _init_cumsum(n):
    """Traces of a model whose density reads ``cumsum``, outside the staged
    op set."""
    gen = gen_at(2)
    return vmap_chains(lambda: cumsummed.generate(gen, g.C["y"].set(0.5), ())[0], n)


def lanes(trs):
    """The batch with its chain axis moved last on every leaf."""
    return torch.utils._pytree.tree_map(lambda v: v.movedim(0, -1), trs)


def flagship_data():
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return X, y


def _flagship_batch(n, seed=0, device="cpu"):
    X, y = flagship_data()
    model = hierarchical_regression(X)
    gen = torch.Generator(device=device).manual_seed(seed)
    obs = g.C["y"].set(torch.as_tensor(y, device=device))
    dummy = torch.zeros(n, device=device)
    trs = torch.func.vmap(lambda _: model.generate(gen, obs, ())[0], randomness="different")(dummy)
    return model, gen, trs, y


def _assess_each(model, trs, chain_axis=0):
    return torch.func.vmap(
        lambda tr: model.assess(tr.get_choices(), ())[0], in_dims=chain_axis
    )(trs)


# ----------------------------------------------------------------------
# mh, run_chain, run_chains
# ----------------------------------------------------------------------


def test_entry_program_runs_vmapped():
    """The reference's entry program: ``generate`` under the observation,
    then one ``mh`` step of the HMC request, over 256 vmapped chains."""
    model, gen, trs, y = _flagship_batch(256)
    request = g.HMC(g.S["w"] | g.S["tau"], 0.02, L=5)
    new, accepted = torch.func.vmap(lambda tr: g.mh(gen, tr, request), randomness="different")(trs)
    assert tuple(new["w"].shape) == (256, 8) and accepted.dtype == torch.bool
    assert 0.0 < float(accepted.float().mean()) <= 1.0
    assert torch.equal(new["y"], torch.as_tensor(y).expand(256, 16))
    moved = (new["w"] != trs["w"]).any(dim=1)
    assert torch.equal(moved, accepted)  # a rejected chain keeps its trace
    torch.testing.assert_close(new.get_score(), _assess_each(model, new), rtol=1e-4, atol=1e-4)


def test_regenerate_mh_converges_over_chains():
    """``mh`` with a ``Selection`` (regenerate from the prior, the joint
    ratio turned into the likelihood ratio): 512 chains x 60 steps reach
    N(1/2, 1/sqrt 2) for y = 1. Limits 0.1, about 3 standard errors."""
    gen = gen_at(42)
    obs = g.C["y"].set(1.0)

    def chain():
        tr, _ = conjugate.generate(gen, obs, ())
        for _ in range(60):
            tr, _acc = g.mh(gen, tr, g.S["mu"])
        return tr["mu"]

    mus = vmap_chains(chain, 512)
    assert float(mus.mean()) == pytest.approx(0.5, abs=0.1)
    assert float(mus.std()) == pytest.approx(1 / np.sqrt(2), abs=0.1)


def test_run_chain_records_each_step():
    gen = gen_at(1)
    tr, _ = conjugate.generate(gen, OBS, ())
    res = g.run_chain(gen, tr, g.HMC(g.S["mu"], 0.5, L=5), 20,
                      record=lambda t: {"mu": t["mu"], "score": t.get_score()})
    assert isinstance(res, g.MHChainResult)
    assert tuple(res.history["mu"].shape) == (20,) == tuple(res.history["score"].shape)
    assert float(res.history["mu"][-1]) == float(res.trace["mu"])
    assert 0.0 < float(res.accept_rate) <= 1.0
    assert g.run_chain(gen, tr, g.S["mu"], 3).history is None


@pytest.mark.parametrize("layout", ["lanes", "batch"])
def test_run_chains_vmapped(layout):
    """256 chains x 150 regenerate steps for y = 1; the last recorded draw of
    each chain has the posterior's moments. Limits 0.15, about 3.4 standard
    errors of the mean."""
    obs = g.C["y"].set(1.0)
    res = g.run_chains(
        42, lambda gen: conjugate.generate(gen, obs, ())[0], g.S["mu"], n_steps=150,
        n_chains=256, record=lambda t: t["mu"], layout=layout, device="cpu",
    )
    assert tuple(res.history.shape) == (256, 150) and tuple(res.accept_rate.shape) == (256,)
    assert tuple(res.trace["mu"].shape) == (256,)
    final = res.history[:, -1]
    assert torch.equal(final, res.trace["mu"])
    assert float(final.mean()) == pytest.approx(0.5, abs=0.15)
    assert float(final.std()) == pytest.approx(1 / np.sqrt(2), abs=0.15)


def test_run_chains_takes_a_generator_on_its_device():
    kw = dict(n_steps=2, n_chains=4, device="cpu")
    res = g.run_chains(gen_at(3), lambda gen: conjugate.generate(gen, OBS, ())[0], g.S["mu"], **kw)
    assert tuple(res.trace["mu"].shape) == (4,) and res.history is None
    with pytest.raises(ValueError, match="layout"):
        g.run_chains(3, lambda gen: None, g.S["mu"], layout="rows", **kw)


class _CardGenerator:
    device = torch.device("cuda")


def test_a_generator_and_a_trace_on_different_devices_raise():
    trs = _init(4)
    tr = conjugate.simulate(gen_at(0), ())
    for call in (
        lambda: g.mh(_CardGenerator(), tr, g.S["mu"]),
        lambda: tr.edit(_CardGenerator(), g.Regenerate(g.S["mu"])),
        lambda: g.run_chain(_CardGenerator(), tr, g.S["mu"], 2),
        lambda: g.run_chains_hmc(_CardGenerator(), trs, g.S["mu"], eps=0.1),
        lambda: g.mh_accept(_CardGenerator(), tr, tr, torch.tensor(0.0)),
    ):
        with pytest.raises(ValueError, match="the trace lives on cpu and the generator on cuda"):
            call()


# ----------------------------------------------------------------------
# run_chains_hmc
# ----------------------------------------------------------------------


def test_conjugate_posterior_moments():
    """The posterior is N(1, 0.5): 512 chains x 150 steps recover both
    moments. Limits 0.1 (3 standard errors of the mean) and 0.12."""
    trs, acc = g.run_chains_hmc(gen_at(1), _init(512), g.S["mu"], eps=0.5, L=5, n_steps=150)
    assert g.run_chains_hmc.last_backend == "torch"
    mus = trs["mu"]
    assert 0.2 < float(acc) <= 1.0
    assert abs(float(mus.mean()) - 1.0) < 0.1
    assert abs(float(mus.var()) - 0.5) < 0.12


def test_frozen_choices_and_score_consistency():
    trs0 = _init(64, seed=3)
    trs, _ = g.run_chains_hmc(gen_at(4), trs0, g.S["mu"], eps=0.4, L=3, n_steps=10)
    assert torch.equal(trs["y"], trs0["y"])
    assert not torch.equal(trs["mu"], trs0["mu"])
    torch.testing.assert_close(_assess_each(conjugate, trs), trs.get_score(), rtol=1e-5, atol=1e-6)
    spec = torch.utils._pytree.tree_structure
    assert spec(trs) == spec(trs0)


def test_matches_per_transition_api_distribution():
    """Same Markov chain as iterating ``mh(HMC(...))``: 512 chains x 100
    steps by each runner land on the same posterior. Limits 0.12 and 0.15,
    the reference test's."""
    n, steps = 512, 100
    gen = gen_at(6)
    request = g.HMC(g.S["mu"], 0.5, L=5)
    trs_a = _init(n, seed=5)
    step = torch.func.vmap(lambda tr: g.mh(gen, tr, request), randomness="different")
    for _ in range(steps):
        trs_a, _acc = step(trs_a)
    trs_b, _ = g.run_chains_hmc(gen_at(7), _init(n, seed=8), g.S["mu"], eps=0.5, L=5, n_steps=steps)
    assert abs(float(trs_a["mu"].mean()) - float(trs_b["mu"].mean())) < 0.12
    assert abs(float(trs_a["mu"].var()) - float(trs_b["mu"].var())) < 0.15


@g.gen
def hierarchical():
    tau = g.log_normal(0.0, 0.5) @ "tau"
    w = g.mv_normal_diag(torch.zeros(4), torch.ones(4) / torch.sqrt(tau)) @ "w"
    _ = g.normal(torch.sum(w), 0.5) @ "y"


def test_vector_addresses_and_inv_mass():
    """Scalar and vector leaves ravel into one z, and a diagonal inverse
    mass flows through; tau keeps to its support (the log-normal's -inf
    rejects)."""
    gen = gen_at(9)
    obs = g.C["y"].set(1.0)
    trs = vmap_chains(lambda: hierarchical.generate(gen, obs, ())[0], 128)
    trs, acc = g.run_chains_hmc(
        gen_at(10), trs, g.S["tau"] | g.S["w"], eps=0.05, L=5, n_steps=50,
        inv_mass=torch.full((5,), 0.5),
    )
    assert 0.2 < float(acc) <= 1.0
    assert tuple(trs["w"].shape) == (128, 4) and bool(torch.isfinite(trs["w"]).all())
    assert bool((trs["tau"] > 0).all())
    torch.testing.assert_close(_assess_each(hierarchical, trs), trs.get_score(), rtol=1e-4, atol=1e-4)


def test_chain_axis_lanes_layout():
    trs = lanes(_init(64, seed=11))
    trs, acc = g.run_chains_hmc(
        gen_at(12), trs, g.S["mu"], eps=0.5, L=3, n_steps=20, chain_axis=-1
    )
    assert tuple(trs["mu"].shape) == (64,)
    assert 0.2 < float(acc) <= 1.0
    model, gen, trs, y = _flagship_batch(32)
    trs = lanes(trs)
    assert tuple(trs["w"].shape) == (8, 32)
    new, acc = g.run_chains_hmc(
        gen, trs, g.S["w"] | g.S["tau"], eps=0.02, L=5, n_steps=5, chain_axis=-1
    )
    assert tuple(new["w"].shape) == (8, 32) and torch.equal(new["y"], trs["y"])
    torch.testing.assert_close(
        _assess_each(model, new, chain_axis=-1), new.get_score(), rtol=1e-4, atol=1e-4
    )


def test_one_policy_for_trace_leaves_across_the_runners():
    """``vmap(generate)`` -> ``vmap(mh)`` -> ``run_chains_hmc`` -> ``vmap(mh)``
    again: every stage takes the last one's traces, whose structure and
    leaf types never drift."""
    model, gen, trs, y = _flagship_batch(64)
    request = g.HMC(g.S["w"] | g.S["tau"], 0.02, L=5)
    step = torch.func.vmap(lambda tr: g.mh(gen, tr, request), randomness="different")
    flatten = torch.utils._pytree.tree_flatten
    leaves0, spec0 = flatten(trs)
    assert all(isinstance(leaf, torch.Tensor) and leaf.shape[0] == 64 for leaf in leaves0)
    stages = [trs]
    stages.append(step(stages[-1])[0])
    stages.append(g.run_chains_hmc(gen, stages[-1], request.selection, eps=0.02, L=5, n_steps=5)[0])
    stages.append(step(stages[-1])[0])
    stages.append(torch.func.vmap(lambda tr: g.mh(gen, tr, g.S["w"]), randomness="different")(stages[-1])[0])
    for stage in stages[1:]:
        leaves, spec = flatten(stage)
        assert spec == spec0
        assert [(leaf.dtype, leaf.shape) for leaf in leaves] == [(leaf.dtype, leaf.shape) for leaf in leaves0]
        assert torch.equal(stage["y"], trs["y"])
        torch.testing.assert_close(stage.get_score(), _assess_each(model, stage), rtol=1e-4, atol=1e-4)


def test_flagship_sweep_in_law_with_the_per_transition_runner():
    """512 flagship chains, 40 transitions by each runner from the same
    initial law: cross-chain means of tau and each w_j within 4 combined
    Monte Carlo standard errors, accept rates within 0.03."""
    model, gen, trs, y = _flagship_batch(512, seed=2)
    sel = g.S["w"] | g.S["tau"]
    request = g.HMC(sel, 0.02, L=5)
    step = torch.func.vmap(lambda tr: g.mh(gen, tr, request), randomness="different")
    a, accs = trs, []
    for _ in range(40):
        a, acc = step(a)
        accs.append(acc.float().mean())
    b, acc_b = g.run_chains_hmc(gen, trs, sel, eps=0.02, L=5, n_steps=40)
    assert abs(float(torch.stack(accs).mean()) - float(acc_b)) < 0.03
    for addr in ("tau", "w"):
        xa, xb = a[addr].reshape(512, -1), b[addr].reshape(512, -1)
        se = torch.sqrt((xa.var(dim=0) + xb.var(dim=0)) / 512)
        z = ((xa.mean(dim=0) - xb.mean(dim=0)) / se).abs()
        assert bool((z < 4).all()), (addr, z)


# ----------------------------------------------------------------------
# routing
# ----------------------------------------------------------------------


def test_on_the_cpu_auto_runs_the_twin_and_cuda_raises():
    model, gen, trs, y = _flagship_batch(16)
    sel = g.S["w"] | g.S["tau"]
    hmc.hmc_sweep_launches = 0
    g.run_chains_hmc(gen, trs, sel, eps=0.02, L=2, n_steps=1)
    assert g.run_chains_hmc.last_backend == "torch" and hmc.hmc_sweep_launches == 0
    # the flagship has a device body, so 'cuda' reaches the kernel's wrapper,
    # which takes no CPU tensor; so does a model staged into one
    with pytest.raises(ValueError, match="takes a CUDA tensor"):
        g.run_chains_hmc(gen, trs, sel, eps=0.02, L=2, n_steps=1, backend="cuda")
    with pytest.raises(ValueError, match="takes a CUDA tensor"):
        g.run_chains_hmc(gen_at(0), _init(8), g.S["mu"], eps=0.1, backend="cuda")
    # a model whose density cannot be staged cannot take 'cuda' at all
    with pytest.raises(ValueError, match="aten.cumsum.*backend='torch'"):
        g.run_chains_hmc(gen_at(0), _init_cumsum(8), g.S["x"], eps=0.1, backend="cuda")
    with pytest.raises(ValueError, match="backend must be"):
        g.run_chains_hmc(gen_at(0), _init(8), g.S["mu"], eps=0.1, backend="xla")
    assert hmc.hmc_sweep_launches == 0


def test_on_the_card_auto_raises_without_a_device_body(monkeypatch):
    """With the traces taken to live on a CUDA device, ``auto`` routes every
    batch whose density can be staged to the kernel (whose wrapper takes no
    CPU tensor): the conjugate model, the flagship with ``tau`` frozen per
    chain (``S["w"]``, one chain operand) and with each chain's own ``y``
    (sixteen), through ``run_chains_hmc``, ``run_chains_nuts`` and
    ``sample_posterior(hmc_sweep)``; a model whose density cannot be staged
    raises, naming the op and ``backend="torch"``; ``backend="torch"`` runs
    the twin on purpose; nothing falls back quietly."""
    monkeypatch.setattr(mcmc, "trace_device", lambda tree: torch.device("cuda"))
    g.run_chains_hmc.last_backend = None
    with pytest.raises(ValueError, match="aten.cumsum.*Pass backend='torch' to run the plain torch twin"):
        g.run_chains_hmc(gen_at(0), _init_cumsum(8), g.S["x"], eps=0.1)
    with pytest.raises(ValueError, match="aten.cumsum.*backend='torch'"):
        g.run_chains_nuts(gen_at(0), _init_cumsum(8), g.S["x"], eps=0.1)
    assert g.run_chains_hmc.last_backend is None
    g.run_chains_hmc(gen_at(0), _init(8), g.S["mu"], eps=0.1, backend="torch")
    assert g.run_chains_hmc.last_backend == "torch" and g.run_chains_hmc.last_body is None

    model, gen, trs, y = _flagship_batch(16)
    sel = g.S["w"] | g.S["tau"]
    own_y = torch.func.vmap(
        lambda yy: model.generate(gen, g.C["y"].set(yy), ())[0], randomness="different"
    )(torch.as_tensor(y).expand(16, 16) + torch.arange(16.0)[:, None])
    for batch, selection in [(_init(8), g.S["mu"]), (trs, sel), (trs, g.S["w"]), (own_y, sel)]:
        for driver in (g.run_chains_hmc, g.run_chains_nuts):
            with pytest.raises(ValueError, match="takes a CUDA tensor"):  # routed to the kernel
                driver(gen, batch, selection, eps=0.02)
    for model_, obs, selection in [(conjugate, OBS, g.S["mu"]), (model, g.C["y"].set(torch.as_tensor(y)), g.S["w"])]:
        with pytest.raises(ValueError, match="takes a CUDA tensor"):
            sample_posterior(0, model_, obs, (), selection, n_chains=8, n_warmup=6, n_samples=2,
                             algorithm="hmc_sweep", device="cpu")
    assert mcmc._KernelView(own_y, sel, 0, 9).body.k == 16
    new, _ = g.run_chains_hmc(gen, own_y, sel, eps=0.02, L=2, backend="torch")
    assert torch.equal(new["y"], own_y["y"])


@pytest.mark.parametrize("order", [(("tau",), ("w",)), (("w",), ("tau",))], ids=["tau-w", "w-tau"])
def test_kernel_view_maps_z_to_the_bodys_rows(order, monkeypatch):
    """``z`` ravels in tree-flatten order (tau, w), unpadded; the kernel's
    block follows the body's packing, padded to 16 with fresh standard
    normals, made inert by their inverse mass (``PAD_INV_MASS``). Held for
    the flagship's packing and for the other order of the same addresses."""
    monkeypatch.setattr(bodies, "body_packing", lambda model: order)
    monkeypatch.setattr(mcmc, "body_packing", lambda model: order)
    model, gen, trs, y = _flagship_batch(32)
    sel = g.S["w"] | g.S["tau"]
    z, _, _ = mcmc.column_view(trs, sel, 0)
    assert tuple(z.shape) == (9, 32) and torch.equal(z[0], trs["tau"]) and torch.equal(z[1:].T, trs["w"])
    view = mcmc._KernelView(trs, sel, 0, 9)
    assert view.body is not None and view.body.name == "hier_regression"
    np.testing.assert_array_equal(view.body.consts[-16:].numpy(), y)
    q = view.packer.pack_columns(z, view.rows, gen)
    assert tuple(q.shape) == (16, 32) and q.is_contiguous()
    tau_row = 0 if order[0] == ("tau",) else 8
    w_rows = slice(1, 9) if order[0] == ("tau",) else slice(0, 8)
    assert torch.equal(q[tau_row], trs["tau"]) and torch.equal(q[w_rows].T, trs["w"])
    pad = q[9:]
    assert abs(float(pad.mean())) < 0.2 and abs(float(pad.std()) - 1.0) < 0.2
    assert not torch.equal(view.packer.pack_columns(z, view.rows, gen)[9:], pad)  # fresh at every call
    assert torch.equal(view.packer.unpack_columns(q, view.rows), z)
    im = view.packer.pack_inv_mass(torch.arange(1.0, 10.0), view.rows, "cpu")
    assert im[tau_row] == 1.0 and torch.equal(im[w_rows], torch.arange(2.0, 10.0))
    pad = torch.full((7,), PAD_INV_MASS)
    assert torch.equal(im[9:], pad)
    assert torch.equal(view.packer.pack_inv_mass(None, view.rows, "cpu"), torch.cat([torch.ones(9), pad]))


def test_kernel_view_refuses_what_the_body_does_not_cover():
    """Where the hand-written body does not cover a batch, the view stages
    the model (``tau`` frozen per chain becomes a chain operand; ``y`` the
    same in every chain, a constant); it refuses a density outside the
    staged op set and a selection that is not static addresses."""
    model, gen, trs, y = _flagship_batch(8)
    view = mcmc._KernelView(trs, g.S["w"], 0, 8)
    assert view.body.name == "staged" and view.body.k == 1 and torch.equal(view.body.chain, trs["tau"][None])
    view = mcmc._KernelView(trs, g.S["w"] | g.S["tau"] | g.S["y"], 0, 25)
    assert view.body.name == "staged" and view.body.k == 0 and view.packer.padded_dim == 32
    view = mcmc._KernelView(_init(8), g.S["mu"], 0, 1)
    assert view.body.name == "staged" and view.body.k == 0 and view.rows == [0]
    view = mcmc._KernelView(lanes(trs), g.S["w"] | g.S["tau"], -1, 9)
    assert view.body.name == "hier_regression" and view.rows == list(range(9))
    view = mcmc._KernelView(lanes(trs), g.S["w"], -1, 8)
    assert view.body.k == 1 and torch.equal(view.body.chain, trs["tau"][None])
    with pytest.raises(ValueError, match="aten.cumsum.*backend='torch'"):
        mcmc._KernelView(_init_cumsum(8), g.S["x"], 0, 3)
    kernel, _ = linear_gaussian_ssm()
    scanned = torch.func.vmap(lambda _: kernel.scan(n=3).simulate(gen_at(1), (0.0, None)),
                              randomness="different")(torch.zeros(4))
    with pytest.raises(ValueError, match="not static addresses.*backend='torch'"):
        mcmc._KernelView(scanned, g.S[..., "z"], 0, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("chain_axis", [0, -1])
def test_flagship_sweep_runs_the_cuda_kernel(chain_axis):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    n = 4096
    model, gen, trs, y = _flagship_batch(n, device="cuda")
    if chain_axis == -1:
        trs = lanes(trs)
    sel = g.S["w"] | g.S["tau"]
    hmc.hmc_sweep_launches = 0
    new, acc = g.run_chains_hmc(gen, trs, sel, eps=0.02, L=5, n_steps=20, chain_axis=chain_axis)
    assert g.run_chains_hmc.last_backend == "cuda" and hmc.hmc_sweep_launches == 1
    assert hmc.hmc_sweep.last_variant == "specialised"
    assert torch.equal(new["y"], trs["y"]) and new["w"].is_cuda
    torch.testing.assert_close(
        new.get_score(), _assess_each(model, new, chain_axis), rtol=1e-4, atol=1e-4
    )
    twin, acc_t = g.run_chains_hmc(
        gen, trs, sel, eps=0.02, L=5, n_steps=20, chain_axis=chain_axis, backend="torch"
    )
    assert g.run_chains_hmc.last_backend == "torch" and hmc.hmc_sweep_launches == 1
    assert abs(float(acc) - float(acc_t)) < 0.02
    for addr in ("tau", "w"):
        xa = new[addr].movedim(chain_axis, 0).reshape(n, -1)
        xb = twin[addr].movedim(chain_axis, 0).reshape(n, -1)
        se = torch.sqrt((xa.var(dim=0) + xb.var(dim=0)) / n)
        assert bool((((xa.mean(dim=0) - xb.mean(dim=0)) / se).abs() < 4).all())
    # tau frozen per chain: the model staged with one chain operand
    hmc.hmc_sweep_launches = 0
    new, _ = g.run_chains_hmc(gen, trs, g.S["w"], eps=0.02, L=5, chain_axis=chain_axis)
    assert g.run_chains_hmc.last_body == "staged" and hmc.hmc_sweep_launches == 1
    assert torch.equal(new["tau"], trs["tau"])


@pytest.mark.cuda
def test_run_chains_runs_on_the_card_by_default():
    """``run_chains`` makes its chains: with no ``device=`` every leaf of the
    result lives on the card, ``record`` included, and an edit on the clean
    path (nothing asked, so the weight is the 0.0 no address added to) gives
    its weight there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    n, steps = 1024, 3
    model, _gen, _trs, y = _flagship_batch(4, device="cuda")
    obs = g.C["y"].set(torch.as_tensor(y, device="cuda"))
    request = g.HMC(g.S["w"] | g.S["tau"], 0.02, L=5)
    res = g.run_chains(
        5, lambda gen: model.generate(gen, obs, ())[0], request, steps, n, record=lambda tr: tr["tau"]
    )
    assert all(v.is_cuda for v in torch.utils._pytree.tree_leaves(res))
    assert res.trace["w"].shape == (n, 8) and res.history.shape == (n, steps)
    assert torch.equal(res.history[:, -1], res.trace["tau"])
    assert 0.0 < float(res.accept_rate.mean()) <= 1.0
    torch.testing.assert_close(
        res.trace.get_score(), _assess_each(model, res.trace, 0), rtol=1e-4, atol=1e-4
    )
    gen = torch.Generator(device="cuda").manual_seed(1)
    tr = model.generate(gen, obs, ())[0]
    _new, w, _rd, _bwd = tr.edit(gen, g.Update(g.ChoiceMap.empty()))
    assert w.is_cuda and float(w) == 0.0
    assert tr.project(gen, g.S["nothing here"]).is_cuda
