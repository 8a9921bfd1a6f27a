"""Choice maps and selections: builders, algebra, and vectorized layouts.

Counterpart of ``examples/03_choice_maps.py``, section for section. Each
section returns the values it read, which the tests hold to the
reference's reads of the same maps.
"""

import math

import torch
import torch.utils._pytree as pytree

import genjax_tpu_torch as g
from genjax_tpu_torch import C, S

from ._common import batch, cli, device_of


def _plain(v):
    return v.unmask() if isinstance(v, g.Mask) else v


# ----------------------------------------------------------------------
# choice maps come from traces
# ----------------------------------------------------------------------


@g.gen
def beta_bernoulli():
    p = g.beta(2.0, 2.0) @ "p"
    v = g.flip(p) @ "v"
    return v


def traces_produce_choice_maps(device):
    tr = beta_bernoulli.simulate(torch.Generator(device=device).manual_seed(0), ())
    # two equivalent accessors
    chm = tr.get_choices()
    assert tr.get_sample() is not None
    # read specific subparts
    p = chm["p"]
    assert 0.0 < float(p) < 1.0
    # sub-map access
    sub = chm.get_submap("v")
    assert sub.get_value() is not None


# ----------------------------------------------------------------------
# building observation maps: many equivalent spellings
# ----------------------------------------------------------------------


def builders():
    # entry builder
    c1 = C["x"].set(1.0)
    # hierarchical addresses
    c2 = C["outer", "inner"].set(2.0)
    assert float(c2["outer", "inner"]) == 2.0
    # dict-style (tuple keys are paths)
    c3 = g.ChoiceMap.d({"a": 3.0, ("b", "c"): 4.0})
    assert float(c3["b", "c"]) == 4.0
    # kwargs-style
    c4 = g.ChoiceMap.kw(u=5.0, v=6.0)
    assert float(c4["u"]) == 5.0
    # directly set a value node / the empty map
    v = g.ChoiceMap.choice(7.0)
    assert float(v.get_value()) == 7.0
    assert g.ChoiceMap.empty().static_is_empty()

    # iteratively accumulating choices (left-priority merge)
    acc = g.ChoiceMap.empty()
    for i, name in enumerate(["a", "b", "c"]):
        acc |= C[name].set(float(i))
    assert float(acc["c"]) == 2.0
    # later .at entries layer OVER an existing map
    updated = acc.at["a"].set(10.0)
    assert float(updated["a"]) == 10.0
    assert float(updated["b"]) == 1.0

    # merge is left-priority
    merged = C["x"].set(10.0) | c1
    assert float(merged["x"]) == 10.0
    return [float(c2["outer", "inner"]), float(c3["a"]), float(c3["b", "c"]), float(c4["u"]), float(c4["v"]),
            float(v.get_value()), float(acc["a"]), float(acc["b"]), float(acc["c"]), float(updated["a"]),
            float(updated["b"]), float(updated["c"]), float(merged["x"])]


# ----------------------------------------------------------------------
# vectorized (Indexed) choice maps: the layout of scan/vmap traces
# ----------------------------------------------------------------------


@g.gen
def kernel(c, x):
    z = g.normal(c, 1.0) @ "z"
    y = g.normal(z, 0.5) @ "y"
    return (z, y)


def indexed_maps(device):
    # numpy-style creation: a dense map over all indices
    dense = C[:, "z"].set(torch.arange(5.0, device=device))
    assert float(dense[2, "z"]) == 2.0
    # full-slice read returns the whole dense inner
    assert torch.allclose(dense[:, "z"], torch.arange(5.0, device=device))

    # sparse indexed creation: values at a subset of indices; reads at
    # other indices come back as invalid Masks (fixed-shape sum type)
    sparse = C[torch.tensor([1, 3], device=device), "z"].set(torch.tensor([10.0, 30.0], device=device))
    hit = sparse.get_submap(torch.tensor(3, device=device), "z").get_value()
    assert isinstance(hit, g.Mask) and bool(hit.primal_flag())
    assert float(hit.value) == 30.0
    miss = sparse.get_submap(torch.tensor(0, device=device), "z").get_value()
    assert isinstance(miss, g.Mask) and not bool(miss.primal_flag())

    # more than one variable per index
    multi = C[torch.tensor([0, 2], device=device)].set(
        g.ChoiceMap.d({"z": torch.tensor([0.1, 0.2], device=device), "y": torch.tensor([1.0, 2.0], device=device)})
    )
    v = multi.get_submap(torch.tensor(2, device=device), "y").get_value()
    assert float(v.unmask()) == 2.0

    # scan traces use the dense layout: constrain every step's "y"
    sc = kernel.scan(n=5)
    ys = torch.linspace(-1, 1, 5, device=device)
    tr, w = sc.generate(torch.Generator(device=device).manual_seed(1), C[:, "y"].set(ys), (0.0, None))
    got = _plain(tr.get_choices()[:, "y"])
    assert torch.allclose(got, ys)
    return [float(dense[2, "z"]), float(hit.value), bool(miss.primal_flag()), float(v.unmask()),
            got.tolist()]


# ----------------------------------------------------------------------
# nested vmap: the address hierarchy carries one index level per vmap
# ----------------------------------------------------------------------


def nested_vmap_maps(device):
    @g.gen
    def point(i, j):
        return g.normal(0.0, 1.0) @ "x"

    inner = point.vmap(in_axes=(None, 0))
    outer = inner.vmap(in_axes=(0, None))
    args = (torch.arange(2, device=device), torch.arange(3, device=device))
    tr = outer.simulate(torch.Generator(device=device).manual_seed(2), args)
    chm = tr.get_choices()
    # two integer levels before the leaf address
    v = _plain(chm[1, 2, "x"])
    assert v.dim() == 0
    # constraints address the same hierarchy
    con = C[1, 2, "x"].set(0.5)
    tr2, _ = outer.generate(torch.Generator(device=device).manual_seed(3), con, args)
    got = _plain(tr2.get_choices()[1, 2, "x"])
    assert float(got) == 0.5

    # batched traces via vmap over simulate: slice one lane out to get a
    # valid single trace
    gen = torch.Generator(device=device).manual_seed(4)
    batched = batch(lambda: beta_bernoulli.simulate(gen, ()), 8, device)
    lane0 = pytree.tree_map(lambda leaf: leaf[0] if isinstance(leaf, torch.Tensor) else leaf, batched)
    assert math.isfinite(float(lane0.get_score()))
    return float(got)


# ----------------------------------------------------------------------
# filtering and the selection algebra
# ----------------------------------------------------------------------


def selections(device):
    chm = g.ChoiceMap.d({"x": 1.0, "y": 2.0})
    only_x = chm.filter(S["x"])
    assert float(only_x.get_submap("x").get_value()) == 1.0
    y_val = only_x.get_submap("y").get_value()
    assert y_val is None or not bool(y_val.primal_flag())

    # algebra: union, intersection via filter, complement, wildcard
    sel = S["x"] | S["y", "inner"]
    assert sel("x").check()
    assert sel("y")("inner").check()
    assert not sel("z").check()
    comp = ~S["x"]
    assert not comp("x").check()
    assert comp("y").check()
    wild = S[..., "z"]
    assert wild(3)("z").check()

    # a choice map is itself a selection of its own addresses
    from_chm = chm.get_selection()
    assert from_chm["x"] and not from_chm["nope"]

    # masks: fixed-shape sum types
    m = g.Mask(torch.tensor(3.0, device=device), torch.tensor(True, device=device))
    assert float(m.unmask()) == 3.0
    assert not bool((~m).primal_flag())
    return [float(only_x.get_submap("x").get_value()), y_val is None]


def main(device="cuda"):
    device = device_of(device)
    traces_produce_choice_maps(device)
    out = {"builders": builders(), "indexed": indexed_maps(device), "nested": nested_vmap_maps(device),
           "selections": selections(device)}
    print("choice-map cookbook: all sections OK")
    return out


if __name__ == "__main__":
    cli(main)
