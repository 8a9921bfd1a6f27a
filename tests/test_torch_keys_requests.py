"""The edit requests under a key, draw for draw against ``genjax_tpu``.

From the same seed, ``core.keys.key(s)`` and ``jax.random.key(s)`` drive the
port's and the reference's requests to the same draws:

- ``Rejuvenate`` splits the key as the reference does, the proposal under
  the second half and the ``Update`` under the first (a fault, F7, fixed
  here: it passed the unsplit key to both and drew something else);
- ``MALA``, ``EllipticalSlice`` and ``SliceSample`` follow the reference's
  splits, as a single edit and through ``mh`` and ``run_chains``;
- the audit: every edit request the port defines (``EditRequest``'s
  subclasses, and ``SafeHMC``) either draws the reference's draw under a key
  or raises ``GFITypeError``; none draws something else.

Choices, scores and weights are held to rtol 1e-5 (atol 1e-6), accept flags
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.inference.requests import EllipticalSlice as RESS
from genjax_tpu.inference.requests import MALA as RMALA
from genjax_tpu.inference.requests import NUTS as RNUTS
from genjax_tpu.inference.requests import Rejuvenate as RRejuvenate
from genjax_tpu.inference.requests import SliceSample as RSlice
from genjax_tpu.inference.requests.hmc import SafeHMC as RSafeHMC
from genjax_tpu_torch.core import keys
from genjax_tpu_torch.generative.concepts import EditRequest, PrimitiveEditRequest
from genjax_tpu_torch.generative.typecheck import GFITypeError
from genjax_tpu_torch.inference.requests import MALA, NUTS, EllipticalSlice, Rejuvenate, SafeHMC, SliceSample
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5


def tk(seed):
    return keys.key(seed, device="cpu")


def jk(seed):
    return jax.random.key(seed)


def close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=1e-6)


@g.gen
def model():
    mu = g.normal(0.0, 1.0) @ "mu"
    g.normal(mu, 1.0) @ "y"


@gj.gen
def model_ref():
    mu = gj.normal(0.0, 1.0) @ "mu"
    gj.normal(mu, 1.0) @ "y"


@g.gen
def rw(c):
    g.normal(c["mu"], 0.5) @ "mu"


@gj.gen
def rw_ref(c):
    gj.normal(c["mu"], 0.5) @ "mu"


@g.gen
def vector_model():
    x = g.mv_normal_diag(torch.zeros(3), torch.ones(3)) @ "x"
    g.normal(x.sum(), 0.5) @ "y"


@gj.gen
def vector_model_ref():
    x = gj.mv_normal_diag(jnp.zeros(3), jnp.ones(3)) @ "x"
    gj.normal(x.sum(), 0.5) @ "y"


def traces(seed, vector=False):
    if vector:
        return (vector_model.generate(tk(seed), g.C["y"].set(1.2), ())[0],
                vector_model_ref.generate(jk(seed), gj.C["y"].set(1.2), ())[0])
    return model.generate(tk(seed), g.C["y"].set(1.0), ())[0], model_ref.generate(jk(seed), gj.C["y"].set(1.0), ())[0]


def same_edit(out, ref_out, addr):
    new, w, _rd, _bwd = out
    ref_new, rw_, _rd, _bwd = ref_out
    close(new.get_choices()[addr], ref_new.get_choices()[addr])
    close(w, rw_)
    close(new.get_score(), ref_new.get_score())


# ----------------------------------------------------------------------
# F7: Rejuvenate under a key
# ----------------------------------------------------------------------


def test_rejuvenate_splits_the_key_as_the_reference_does():
    tr, rt = traces(42)
    close(tr.get_choices()["mu"], 0.07592554)
    close(rt.get_choices()["mu"], 0.07592554)
    new, w, _rd, bwd = tr.edit(tk(42), Rejuvenate(rw, lambda c: (c,)))
    close(new.get_choices()["mu"], -0.29613465)
    close(w, -0.45399135)
    assert isinstance(bwd, Rejuvenate)
    same_edit((new, w, None, None), rt.edit(jk(42), RRejuvenate(rw_ref, lambda c: (c,))), "mu")


# ----------------------------------------------------------------------
# MALA, EllipticalSlice, SliceSample: one edit, mh, run_chains
# ----------------------------------------------------------------------

KEYED_REQUESTS = {
    "MALA": (lambda: MALA(g.S["x"], 0.3), lambda: RMALA(gj.S["x"], 0.3), True),
    "EllipticalSlice": (lambda: EllipticalSlice(g.S["x"], max_iters=12),
                        lambda: RESS(gj.S["x"], max_iters=12), True),
    "SliceSample": (lambda: SliceSample(g.S["mu"], width=0.8, max_steps=10),
                    lambda: RSlice(gj.S["mu"], width=0.8, max_steps=10), False),
}


@pytest.mark.parametrize("name", sorted(KEYED_REQUESTS))
@pytest.mark.parametrize("seed", [3, 2**31 - 1])
def test_request_edit_draws_the_reference_draw(name, seed):
    port_req, ref_req, vector = KEYED_REQUESTS[name]
    tr, rt = traces(seed % 1000, vector)
    same_edit(tr.edit(tk(seed), port_req()), rt.edit(jk(seed), ref_req()), "x" if vector else "mu")


@pytest.mark.parametrize("name", sorted(KEYED_REQUESTS))
def test_request_under_mh_and_run_chains(name):
    port_req, ref_req, vector = KEYED_REQUESTS[name]
    addr = "x" if vector else "mu"
    tr, rt = traces(20, vector)
    for seed in range(21, 24):
        tr, acc = g.mh(tk(seed), tr, port_req())
        rt, racc = gj.mh(jk(seed), rt, ref_req())
        assert bool(acc) == bool(racc)
        close(tr.get_choices()[addr], rt.get_choices()[addr])
    if vector:
        init = lambda k: vector_model.generate(k, g.C["y"].set(1.2), ())[0]  # noqa: E731
        ref_init = lambda k: vector_model_ref.generate(k, gj.C["y"].set(1.2), ())[0]  # noqa: E731
    else:
        init = lambda k: model.generate(k, g.C["y"].set(1.0), ())[0]  # noqa: E731
        ref_init = lambda k: model_ref.generate(k, gj.C["y"].set(1.0), ())[0]  # noqa: E731
    res = g.run_chains(tk(30), init, port_req(), 3, 4, device="cpu", record=lambda t: t.get_choices()[addr])
    ref = gj.run_chains(jk(30), ref_init, ref_req(), 3, 4, record=lambda t: t.get_choices()[addr])
    close(res.history, ref.history)
    close(res.accept_rate, ref.accept_rate)


# ----------------------------------------------------------------------
# the audit: every edit request under a key
# ----------------------------------------------------------------------


@g.gen
def lane(m):
    g.normal(m, 1.0) @ "x"


@gj.gen
def lane_ref(m):
    gj.normal(m, 1.0) @ "x"


def _lanes(seed):
    return (lane.vmap().simulate(tk(seed), (torch.tensor([0.0, 1.0, -1.0]),)),
            lane_ref.vmap().simulate(jk(seed), (jnp.asarray([0.0, 1.0, -1.0]),)))


AUDIT = {
    "HMC": (lambda: g.HMC(g.S["mu"], 0.2, L=3), lambda: gj.HMC(gj.S["mu"], 0.2, L=3), "scalar"),
    "SafeHMC": (lambda: SafeHMC(g.S["mu"], 0.2, L=3), lambda: RSafeHMC(gj.S["mu"], 0.2, L=3), "scalar"),
    "NUTS": (lambda: NUTS(g.S["mu"], 0.2, max_depth=3), lambda: RNUTS(gj.S["mu"], 0.2, max_depth=3), "scalar"),
    "MALA": (*KEYED_REQUESTS["MALA"][:2], "vector"),
    "EllipticalSlice": (*KEYED_REQUESTS["EllipticalSlice"][:2], "vector"),
    "SliceSample": (*KEYED_REQUESTS["SliceSample"][:2], "scalar"),
    "Rejuvenate": (lambda: Rejuvenate(rw, lambda c: (c,)), lambda: RRejuvenate(rw_ref, lambda c: (c,)), "scalar"),
    "Regenerate": (lambda: g.Regenerate(g.S["mu"]), lambda: gj.Regenerate(gj.S["mu"]), "scalar"),
    "Update": (lambda: g.Update(g.C["mu"].set(0.3)), lambda: gj.Update(gj.C["mu"].set(0.3)), "scalar"),
    "EmptyRequest": (lambda: g.EmptyRequest(), lambda: gj.EmptyRequest(), "scalar"),
    "DiffAnnotate": (lambda: g.DiffAnnotate(g.Regenerate(g.S["mu"])),
                     lambda: gj.DiffAnnotate(gj.Regenerate(gj.S["mu"])), "scalar"),
    "StaticRequest": (lambda: g.StaticRequest.d({"mu": g.Regenerate(g.S.all())}),
                      lambda: gj.StaticRequest.d({"mu": gj.Regenerate(gj.S.all())}), "scalar"),
    "IndexRequest": (lambda: g.IndexRequest(torch.tensor(1), g.Regenerate(g.S["x"])),
                     lambda: gj.IndexRequest(jnp.asarray(1), gj.Regenerate(gj.S["x"])), "lanes"),
    "VectorRequest": (lambda: g.VectorRequest(g.Regenerate(g.S["x"])),
                      lambda: gj.VectorRequest(gj.Regenerate(gj.S["x"])), "lanes"),
}


def _defined_requests() -> set:
    found, todo = set(), [EditRequest]
    while todo:
        for sub in todo.pop().__subclasses__():
            if sub.__module__.startswith("genjax_tpu_torch."):
                found.add(sub.__name__)
            todo.append(sub)
    return (found - {PrimitiveEditRequest.__name__}) | {"SafeHMC"}


def test_the_audit_covers_every_request_the_port_defines():
    assert _defined_requests() <= set(AUDIT), _defined_requests() - set(AUDIT)


@pytest.mark.parametrize("name", sorted(AUDIT))
def test_every_request_draws_the_reference_draw_or_raises(name):
    port_req, ref_req, kind = AUDIT[name]
    if kind == "lanes":
        tr, rt = _lanes(5)
        addr = (slice(None), "x")
    else:
        tr, rt = traces(5, kind == "vector")
        addr = "x" if kind == "vector" else "mu"
    try:
        out = tr.edit(tk(6), port_req())
    except GFITypeError:
        return
    same_edit(out, rt.edit(jk(6), ref_req()), addr)
