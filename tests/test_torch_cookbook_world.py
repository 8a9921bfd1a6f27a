"""The mesh cookbooks on a gloo world of 2 ranks (``tests/torch_worlds.py::
cookbook_world``): ``20_big_data`` on a ``(2, 1)`` chains x data mesh, its
accept rate the mesh's mean and its draws gathered before it asserts, and
``25_island_pf`` on 2 islands of 1 rank, its per-step collectives read from
``collective_counts``. ``14_multichip`` is in the reference's ``SLOW`` set
and runs in a world of its own under the ``slow`` marker.
"""

import pytest

import torch_worlds
from torch_threads import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_worlds.run_world(torch_worlds.cookbook_world, 2, tmp_path_factory.mktemp("cookbook"),
                                  names=("20", "25"))


def test_big_data_on_a_chains_by_data_mesh(world):
    assert world["20"] == {"batch": 2, "data": 1}


def test_island_filter_exchanges_over_two_islands(world):
    audit = world["25"]
    hot = [o for o in audit["ops"] if o["per_step"] and o["kind"] == "all-reduce"]
    assert hot and all(o["group"] == "batch" and o["group_span"] == 1 for o in hot)
    # the islands meet only at the exchanges: gathers over "island", not per step
    island = [o for o in audit["ops"] if o["group"] == "island"]
    assert island and all(o["kind"] == "all-gather" for o in island)


@pytest.mark.slow
def test_multichip_on_two_ranks(tmp_path):
    out = torch_worlds.run_world(torch_worlds.cookbook_world, 2, tmp_path, names=("14",))
    assert out["14"] is True
