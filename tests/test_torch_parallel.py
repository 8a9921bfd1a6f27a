"""The port's scale-out layer (``genjax_tpu_torch/parallel/``: ``_comm``,
``mesh``, the collective half of ``resampling``, ``smc.run_sharded``,
``sharded_importance``, ``mcmc``) against ``genjax_tpu/parallel`` and the
reference's ``tests/parallel/test_parallel.py``.

The multi-rank checks run in one spawned gloo world of 4 ranks
(``torch_worlds.parallel_world``, 90 s at most); rank 0 returns its results
and each test below asserts on one of them. The reference runs on the 8
forced CPU devices of ``tests/conftest.py`` (meshes of 2 and 4). The
deterministic parts (the weight statistics, the normalizer, the global
resampling, the diagnostics) agree to 1e-5 (the diagnostics across ranks to
1e-6 of one rank on the gathered draws); the draws are held in law at the
reference tests' tolerances: the filter against Kalman within 0.1 (local
mode) and 0.15 (all-gather mode), importance within 0.05 of ``log 0.5``,
the conjugate chains' mean and sd within 0.1.

The rank-free checks run in this process on a 1-rank gloo group, destroyed
after the module.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

import genjax_tpu_torch as g
import torch_worlds
from genjax_tpu.parallel.resampling import collective_log_normalizer as ref_normalizer
from genjax_tpu.parallel import collective_weight_stats as ref_stats
from genjax_tpu.parallel import shard_map_compat
from genjax_tpu_torch.parallel import (
    SSMParticleFilter,
    collective_counts,
    collective_log,
    collective_weight_stats,
    effective_sample_size,
    initialize_distributed,
    make_mesh,
    resample_particles,
    shard_batch,
)
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
RNG = np.random.default_rng(0)
LW = (RNG.normal(size=64) * 2).astype(np.float32)
DRAWS = RNG.normal(size=(8, 50, 3)).astype(np.float32)
YS_LOCAL = np.sin(np.linspace(0, 2, 10)).astype(np.float32)
YS_GATHER = np.ones(6, np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_worlds.run_world(torch_worlds.parallel_world, 4, tmp_path_factory.mktemp("parallel"), lw=LW,
                                  draws=DRAWS, ys_local=YS_LOCAL, ys_gather=YS_GATHER)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    torch_worlds.one_rank_group(tmp_path_factory.mktemp("one_rank"))
    yield make_mesh(device="cpu")
    dist.destroy_process_group()


def _reference_stats(lw, n_dev):
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("batch",))

    def prog(w):
        ess, norm = ref_stats(w, "batch")
        return ess, norm, ref_normalizer(w, "batch")

    f = shard_map_compat(prog, mesh=mesh, in_specs=(P("batch"),), out_specs=(P(), P(), P()))
    return [float(v) for v in jax.jit(f)(jnp.asarray(lw))]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=tol)


# ---- the collectives against the reference's shard_map


@pytest.mark.parametrize("ranks", [2, 4])
def test_collective_weight_stats_and_normalizer_match_the_reference(world, ranks):
    lw = LW if ranks == 4 else LW[:32]
    ess, norm, norm_only = _reference_stats(lw, ranks)
    got = world[f"stats{ranks}"]
    _close(got[0], ess)
    _close(got[1], norm)
    _close(world[f"norm{ranks}"], norm_only)


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
def test_all_gather_resampling_is_single_device_resampling_of_the_whole(world, method):
    """Every rank draws the global indices from the same stream: the
    gathered result is the single-device resample of the concatenated
    weights from that stream, exactly."""
    want = resample_particles(torch.Generator().manual_seed(5), torch.arange(64.0), torch.from_numpy(LW), 64,
                              method)
    np.testing.assert_array_equal(world[f"all_gather_{method}"], want.numpy())
    assert not world[f"all_gather_lw_{method}"].any()
    _close(world[f"all_gather_inc_{method}"], float(jax.scipy.special.logsumexp(LW) - math.log(64)), 1e-4)


def test_local_mode_keeps_the_global_weighting(world):
    expected = float(jax.scipy.special.logsumexp(LW) - math.log(64))
    _close(world["local_inc"], expected, 1e-4)
    lw = world["local_lw"]
    _close(float(jax.scipy.special.logsumexp(lw)) - math.log(lw.shape[0]), 0.0, 1e-4)


# ---- the sharded drivers in law


def test_run_sharded_matches_kalman_local_mode(world):
    assert world["pf_local"] == pytest.approx(torch_worlds.exact_lgss_logz(YS_LOCAL), abs=0.1)
    assert world["pf_local_shapes"] == ((1024,), (10,))


def test_run_sharded_matches_kalman_all_gather_mode(world):
    assert world["pf_gather"] == pytest.approx(torch_worlds.exact_lgss_logz(YS_GATHER), abs=0.15)


def test_run_sharded_issues_two_collectives_a_step_over_the_batch_axis(world):
    """The fused weight statistics: one max and one sum a step, none
    crossing another axis, and the final normalizer's pair."""
    calls = world["pf_local_calls"]
    for t in range(10):
        assert [c for c in calls if c[2] == t][:2] == [("all_reduce_max", "batch", t), ("all_reduce_sum", "batch", t)]
    assert calls[-2:] == [("all_reduce_max", "batch", None), ("all_reduce_sum", "batch", None)]


def test_run_sharded_is_deterministic_under_its_seed(world):
    assert world["pf_repeat_equal"]


def test_sharded_importance_log_z(world):
    log_z, shape = world["importance"]
    assert log_z == pytest.approx(math.log(0.5), abs=0.05)
    assert shape == (1024,)


def test_run_chains_sharded_matches_the_conjugate_posterior(world):
    finals = world["chains_finals"]
    assert finals.shape == (512,)
    assert finals.mean() == pytest.approx(1.0, abs=0.1)
    assert finals.std() == pytest.approx(1.0 / math.sqrt(2.0), abs=0.1)
    assert world["chains_shapes"] == ((128, 60), (128,))


@pytest.mark.parametrize("algorithm", ["hmc_sweep"])
def test_sample_posterior_on_a_mesh_matches_the_conjugate_posterior(world, algorithm):
    """``examples/14_multichip.py``'s check: the sharded chains' posterior
    mean within 0.1 of 1 and R-hat under 1.05 (``"hmc"`` on a mesh resumes
    bit for bit in ``test_torch_distributed.py``)."""
    draws, rhat, ess_, accept, local_shape = world[f"sample_{algorithm}"]
    assert draws.shape == (512, 40) and local_shape == (128, 40)
    assert draws.mean() == pytest.approx(1.0, abs=0.1)
    assert draws.std() == pytest.approx(1.0 / math.sqrt(2.0), abs=0.1)
    assert rhat < 1.05 and ess_ > 100 and 0.3 < accept <= 1.0


@pytest.mark.parametrize("algorithm,n_chains", [("chees", 64), ("pt", 64), ("dense_hmc", 64), ("dense_nuts", 64)])
def test_column_algorithms_on_a_mesh_match_the_conjugate_posterior(world, algorithm, n_chains):
    """The reference's ``test_sharded_chain_axis`` (ChEES: the last 20
    draws' mean within 0.12 of 1 and sd within 0.1 of 1/sqrt(2)), for every
    column algorithm at 64 chains, their adaptation reduced over the 4
    ranks' chains."""
    draws, rhat, accept, local_shape = world[f"column_{algorithm}"]
    assert draws.shape[0] == n_chains and local_shape[0] == n_chains // 4
    last = draws[:, -20:]
    assert last.mean() == pytest.approx(1.0, abs=0.12)
    assert last.std() == pytest.approx(1.0 / math.sqrt(2.0), abs=0.1)
    assert rhat < 1.1 and 0.3 < accept <= 1.0


def test_warmup_adapt_step_size_reaches_the_target_accept(world):
    eps, accept = world["warmup"]
    assert 0.05 < eps < 1.5
    assert 0.6 < accept <= 1.0


def test_diagnostics_across_ranks_equal_one_rank_on_the_gathered_draws(world):
    for key in ("rhat", "ess"):
        sharded, whole = world[key]
        _close(sharded, whole, 1e-6)
    e_l, tau_l, trunc_l, e_a, tau_a, trunc_a = world["ess_tau"]
    _close(e_l, e_a, 1e-6)
    _close(tau_l, tau_a, 1e-6)
    np.testing.assert_array_equal(trunc_l, trunc_a)


def test_the_mesh_refusals_keep_the_references_words(world):
    msgs = world["messages"]
    assert msgs["make_mesh_over"].startswith("make_mesh(8) but only 4")
    assert "spans every rank" in msgs["make_mesh_under"]
    assert msgs["hier_split"] == "4 devices do not split into 3 islands"
    assert msgs["hier_need"] == "make_hier_mesh(2, 4) needs 8 devices but only 4 are available"
    assert "does not divide" in msgs["shard_batch"]
    assert msgs["pf_divide"] == "n_particles=17 must divide over 4 shards"


# ---- rank-free: a world of one rank in this process


def test_a_world_of_one_runs_the_same_collectives(one_rank):
    """At one rank the statistics are the single-device ones, and the calls
    are still issued (and logged)."""
    lw = torch.from_numpy(LW)
    with collective_log() as log:
        ess, norm = collective_weight_stats(lw, one_rank)
    _close(float(ess), float(effective_sample_size(lw)))
    _close(float(norm), float(torch.logsumexp(lw, 0) - math.log(64)))
    assert [(c.op, c.axis, c.span) for c in log] == [("all_reduce_max", "batch", 1), ("all_reduce_sum", "batch", 1)]
    assert torch.equal(shard_batch(lw, one_rank), lw)


def test_the_audit_of_a_world_of_one_filter(one_rank):
    kernel = torch_worlds.ssm_kernel()
    ys = torch.from_numpy(YS_GATHER)
    with collective_log() as log:
        res = SSMParticleFilter(kernel, n_particles=2048).run_sharded(0, 0.0, torch.zeros(6), g.C[:, "y"].set(ys),
                                                                     one_rank)
    counts = collective_counts(log)
    assert counts["per_step"] == {"count": 12, "bytes": 6 * (4 + 8)}
    assert counts["once_per_run"]["count"] == 2
    assert {(o["kind"], o["group"], o["bytes"], o["per_step"]) for o in counts["ops"]} == {
        ("all-reduce", "batch", 4, True), ("all-reduce", "batch", 8, True), ("all-reduce", "batch", 4, False)}
    assert res.log_marginal == pytest.approx(torch_worlds.exact_lgss_logz(YS_GATHER), abs=0.15)


def test_the_card_is_the_default_and_nothing_falls_back(one_rank):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        initialize_distributed(rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
