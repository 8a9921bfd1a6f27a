"""The port's island particle filter (``genjax_tpu_torch/parallel/
islands.py``) and its audit of issued collectives, against
``genjax_tpu/parallel/islands.py`` and the reference's
``tests/parallel/test_islands.py``.

One spawned gloo world of 4 ranks (``torch_worlds.islands_world``) runs the
filter on ``(islands, shards)`` meshes ``(2, 2)``, ``(4, 1)`` and ``(1, 4)``
over the reference's problem (``make_problem``: T = 12, ``exchange_every=4``,
2,048 particles an island). In law, at the reference's tolerances: the log
marginal within 0.1 of Kalman where an island has more than one shard, 0.15
at one shard an island and for the exchange cadences. Structure: the
exchanges counted, the shapes, the reference's refusals word for word, and
the audit: every all-reduce a step issues stays on the ``"batch"`` axis and
carries at most 64 bytes, and the ``"island"`` axis carries gathers only, at
exchange steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import genjax_tpu as gj
import torch_worlds
from genjax_tpu.parallel import IslandParticleFilter as RefIslands
from genjax_tpu.parallel import make_hier_mesh as ref_hier_mesh
from genjax_tpu.parallel import make_mesh as ref_make_mesh
from torch_threads import _one_thread  # noqa: F401

T = 12
YS = np.asarray(jax.random.normal(jax.random.key(7), (T,)) * 0.8, np.float32)
YS_SHORT = np.zeros(8, np.float32)
EXACT = torch_worlds.exact_lgss_logz(YS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_worlds.run_world(torch_worlds.islands_world, 4, tmp_path_factory.mktemp("islands"), ys=YS,
                                  ys_short=YS_SHORT)


@gj.gen
def ref_kernel(c, x):
    z = gj.normal(c, 1.0) @ "z"
    y = gj.normal(z, 0.5) @ "y"
    return (z, y)


@pytest.mark.parametrize("shape,tol", [((2, 2), 0.1), ((4, 1), 0.15), ((1, 4), 0.1)])
def test_island_log_marginal_matches_kalman(world, shape, tol):
    log_z, n_ex, g_shape, ess_shape, carries_shape = world[shape]
    assert log_z == pytest.approx(EXACT, abs=tol)
    assert n_ex == T // 4
    assert g_shape == (shape[0],) and ess_shape == (T, shape[0])
    assert carries_shape == (2048 // shape[1],)


def test_the_reference_agrees_on_the_same_problem(world):
    """The reference on a (2, 2) mesh of 4 of the forced CPU devices lands
    within the same tolerance of Kalman as the port: both estimate one
    quantity."""
    mesh = ref_hier_mesh(2, 2, devices=jax.devices()[:4])
    pf = RefIslands(ref_kernel, n_particles=2048, exchange_every=4)
    res = pf.run_sharded(jax.random.key(20260820), 0.0, jnp.zeros(T), gj.C[:, "y"].set(jnp.asarray(YS)), mesh)
    assert float(res.log_marginal) == pytest.approx(EXACT, abs=0.1)
    assert abs(world[(2, 2)][0] - float(res.log_marginal)) < 0.2


@pytest.mark.parametrize("every,n_ex", [(1, T), (10_000, 0)])
def test_exchange_every_step_and_never(world, every, n_ex):
    log_z, got = world[f"every_{every}"]
    assert got == n_ex
    assert log_z == pytest.approx(EXACT, abs=0.15)


def test_per_step_all_reduces_stay_within_an_island(world):
    audit = world["audit"]
    per_step = [o for o in audit["ops"] if o["per_step"]]
    assert per_step
    reduces = [o for o in per_step if o["kind"] == "all-reduce"]
    assert reduces and all(o["group"] == "batch" and o["group_span"] == 2 for o in reduces)
    assert all(o["kind"] == "all-gather" for o in audit["ops"] if o["group"] == "island")


def test_island_traffic_only_at_exchange_steps(world):
    calls = world["audit_calls"]
    island_steps = {step for op, axis, step, _shape in calls if axis == "island" and step is not None}
    assert island_steps == {3, 7}
    # the weight statistics of every step: one max and one sum over batch
    for t in range(8):
        ops = [(op, axis) for op, axis, step, _ in calls if step == t][:2]
        assert ops == [("all_reduce_max", "batch"), ("all_reduce_sum", "batch")]


def test_the_exchange_payload_is_bounded(world):
    """The per-step all-reduces carry at most 64 bytes; the only larger
    collectives are the exchange's gathers of particles."""
    audit = world["audit"]
    hot = [o for o in audit["ops"] if o["per_step"] and o["kind"] == "all-reduce"]
    assert hot and all(o["bytes"] <= 64 for o in hot)
    big = [o for o in audit["ops"] if o["bytes"] > 64]
    assert big and all(o["kind"] == "all-gather" for o in big)
    assert audit["count"] == sum(o["calls"] for o in audit["ops"])
    assert audit["per_step"]["count"] >= 2 * 8


def test_mesh_validation_keeps_the_references_messages(world):
    msgs = world["messages"]
    ref_msgs = {}
    pf = RefIslands(ref_kernel, n_particles=64)
    obs = gj.C[:, "y"].set(jnp.asarray(YS))
    try:
        pf.run_sharded(jax.random.key(0), 0.0, jnp.zeros(4), obs, ref_make_mesh(4))
    except ValueError as e:
        ref_msgs["axes"] = str(e)
    try:
        RefIslands(ref_kernel, n_particles=63).run_sharded(jax.random.key(0), 0.0, jnp.zeros(4), obs,
                                                          ref_hier_mesh(2, 2, devices=jax.devices()[:4]))
    except ValueError as e:
        ref_msgs["divide"] = str(e)
    assert msgs == ref_msgs
