"""Torch basics for probabilistic programmers.

Counterpart of ``examples/27_jax_basics.py``, section for section: the
mental model a ``genjax_tpu_torch`` user needs, each rule stated and then
proven by assertion. Where the reference's rule is about JAX (``jit``
tracing once, splittable keys, ``lax.cond``), the section states its torch
counterpart: the port runs eagerly and takes its randomness from explicit
``torch.Generator``s ("a ``torch.Generator``, drawn from in sequence, where
the reference splits a key", ``ROADMAP.md``, Deviations of the trace path).
"""

import math

import torch
import torch.utils._pytree as pytree

import genjax_tpu_torch as g

from ._common import batch, cli, device_of


# ----------------------------------------------------------------------
# 1. torch runs your Python EVERY call: there is no trace to replay.
#    Side effects happen each time; nothing is compiled per shape.
# ----------------------------------------------------------------------
def eager_not_traced(device):
    calls = []

    def f(x):
        calls.append("ran")  # side effect: every call
        return x * 2.0

    f(torch.ones(3, device=device))
    f(torch.ones(3, device=device) + 1)
    f(torch.ones(3, device=device) + 2)
    assert calls == ["ran"] * 3, calls  # three runs, three side effects
    # a new shape is just another call
    f(torch.ones(5, device=device))
    assert len(calls) == 4


# ----------------------------------------------------------------------
# 2. Explicit generators: no global random state in the framework. A
#    generator rewound to a seed reproduces its draws; two seeds give two
#    streams. @gen models draw each address from the generator in turn.
# ----------------------------------------------------------------------
def generator_discipline(device):
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(3, generator=gen, device=device)
    gen.manual_seed(0)  # rewind
    assert torch.equal(a, torch.randn(3, generator=gen, device=device))
    g1 = torch.Generator(device=device).manual_seed(1)
    g2 = torch.Generator(device=device).manual_seed(2)
    assert not torch.equal(torch.randn(3, generator=g1, device=device), torch.randn(3, generator=g2, device=device))

    @g.gen
    def model():
        a = g.normal(0.0, 1.0) @ "a"
        b = g.normal(0.0, 1.0) @ "b"
        return a, b

    tr = model.simulate(torch.Generator(device=device).manual_seed(1), ())
    a, b = tr.get_retval()
    assert float(a) != float(b)  # distinct draws for distinct addresses
    tr2 = model.simulate(torch.Generator(device=device).manual_seed(1), ())
    assert float(tr2.get_score()) == float(tr.get_score())  # same seed, same trace


# ----------------------------------------------------------------------
# 3. vmap: write the single-sample program, batch it mechanically with
#    torch.func.vmap over a pure body (randomness="different" gives every
#    lane its own draws). Meshes shard the vmapped axis over ranks.
# ----------------------------------------------------------------------
def vmap_is_the_batch_story(device):
    @g.gen
    def flip_model():
        p = g.beta(2.0, 2.0) @ "p"
        _ = g.flip(p) @ "v"

    obs = g.C["v"].set(True)
    gen = torch.Generator(device=device).manual_seed(2)
    _trs, ws = batch(lambda: flip_model.generate(gen, obs, ()), 1000, device)
    assert tuple(ws.shape) == (1000,)
    # E[p] = 1/2 under the prior, and P(v=True | p) = p, so the average
    # importance weight estimates log E[p] = log 0.5
    lz = torch.logsumexp(ws, 0) - math.log(1000.0)
    assert abs(float(lz) - math.log(0.5)) < 0.05


# ----------------------------------------------------------------------
# 4. No Python branch on a tensor inside a vmapped body: the lanes hold
#    different values, so `if x > 0:` cannot be decided. Use torch.where
#    (both branches computed), or the framework's Switch / Scan
#    combinators.
# ----------------------------------------------------------------------
def structured_control_flow(device):
    def bad_style(x):
        return x if x > 0 else -x

    try:
        torch.func.vmap(bad_style)(torch.tensor([-3.0, 2.0], device=device))
        raise AssertionError("a Python branch on a vmapped tensor must raise")
    except RuntimeError:
        pass

    def good_style(x):
        return torch.where(x > 0, x, -x)

    assert torch.func.vmap(good_style)(torch.tensor([-3.0, 2.0], device=device)).tolist() == [3.0, 2.0]

    # the Scan combinator: a step kernel iterated with GFI semantics
    @g.gen
    def step(carry, _):
        nxt = g.normal(0.9 * carry, 0.1) @ "x"
        return nxt, None

    chain = step.scan(n=50)
    tr = chain.simulate(torch.Generator(device=device).manual_seed(3), (1.0, None))
    xs = tr.get_choices()[:, "x"]
    xs = xs.unmask() if hasattr(xs, "unmask") else xs
    assert tuple(xs.shape) == (50,)


# ----------------------------------------------------------------------
# 5. Everything is a pytree of tensors, traces included: tree_map is how
#    you post-process draws; static structure rides in the tree's context
#    (which is why checkpointing and sharding are simple: leaves are
#    tensors).
# ----------------------------------------------------------------------
def traces_are_pytrees(device):
    @g.gen
    def model():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 1.0) @ "y"

    gen = torch.Generator(device=device).manual_seed(4)
    trs = batch(lambda: model.simulate(gen, ()), 8, device)
    halved = pytree.tree_map(lambda leaf: leaf * 0.5 if isinstance(leaf, torch.Tensor) else leaf, trs)
    assert torch.allclose(halved.get_choices()["mu"], trs.get_choices()["mu"] * 0.5)
    # static values are carried by Const, not as tensor leaves
    c = g.Pytree.const(3)
    assert pytree.tree_leaves(c) == []


# ----------------------------------------------------------------------
# 6. float32 is the default, and the device is explicit: tensors are made
#    where they are asked for, and a model draws where its generator lives.
# ----------------------------------------------------------------------
def dtype_and_device(device):
    x = torch.ones(3, device=device)
    assert x.dtype == torch.float32
    # Python floats do not upcast a tensor
    assert (x * 2.0).dtype == torch.float32

    @g.gen
    def model():
        return g.normal(0.0, 1.0) @ "z"

    tr = model.simulate(torch.Generator(device=device).manual_seed(5), ())
    assert tr.get_choices()["z"].device.type == device.type


def main(device="cuda"):
    device = device_of(device)
    eager_not_traced(device)
    generator_discipline(device)
    vmap_is_the_batch_story(device)
    structured_control_flow(device)
    traces_are_pytrees(device)
    dtype_and_device(device)
    print("torch basics cookbook: all sections verified")


if __name__ == "__main__":
    cli(main)
