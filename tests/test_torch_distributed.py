"""A 2-rank world of the port's scale-out layer: the process group and the
sharded checkpoint, the counterparts of the reference's
``tests/parallel/test_distributed.py`` (which spawns
``_distributed_worker.py``: a cross-process sum) and of its
``_distributed_ckpt_worker.py`` (a sharded ``run_chains_sharded`` stopped
and resumed).

One spawned gloo world of 2 ranks (``torch_worlds.distributed_world``):
``initialize_distributed`` joins both ranks, whose sum of ``rank + 1`` is 3;
``run_chains_sharded`` cut into segments, and stopped after 2 of them and
resumed, returns the uninterrupted run bit for bit (``torch.equal``) on both
ranks, each having saved under ``rank_<r>/`` beside one ``meta.json``;
``sample_posterior(mesh=)`` resumes bit for bit too; ``smc2(mesh=)`` holds
each rank's half of the parameter particles under weights normalised over
both.
"""

import numpy as np
import pytest

import torch_worlds
from torch_threads import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("distributed")
    return torch_worlds.run_world(torch_worlds.distributed_world, 2, root, ckpt_root=str(root))


def test_two_ranks_sum_one_plus_two(world):
    assert world["sum"] == 3.0
    assert world["ranks"] == (0, 2, "gloo")


def test_run_chains_sharded_segments_and_resume_bitwise(world):
    chains = world["chains"]
    assert chains["segmented_equal"]
    assert chains["resumed_equal"] and chains["all_equal"] == [True, True]
    assert chains["partial_steps"] == (32, 8)


def test_each_rank_saves_its_shard_beside_one_pointer(world):
    top, mine = world["chains"]["layout"]
    assert top == ["meta.json", "rank_0", "rank_1"]
    assert mine == ["increment_0", "increment_1", "state_2"]


def test_sample_posterior_on_a_mesh_resumes_bitwise(world):
    assert world["sample_resumed_equal"]


def test_smc2_with_the_parameters_sharded(world):
    """``smc2(mesh=)``: each rank holds half the 64 parameter particles,
    their weights normalised over both ranks' (log-sum-exp 0), one global
    ESS a step, a finite evidence and a rejuvenation that ran."""
    shape, lse, log_ev, ess_shape, accept = world["smc2"]
    assert shape == (32,) and ess_shape == (6,)
    assert abs(lse) < 1e-5
    assert np.isfinite(log_ev) and 0.0 < accept <= 1.0
