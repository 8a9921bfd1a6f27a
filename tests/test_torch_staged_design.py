"""The staged body's Hopper design (``kernels/staged.py``): the simplified,
broadcast-aware program, its straight-line printing and its constant modes.

On numpy-seeded inputs, on the CPU:

- the flagship's program does at most 660 operations a gradient, 2 ``log``
  and 3 division or reciprocal elements, and copies no view into an array;
  no density of ``test_torch_staged_body.DENSITIES`` counts more operations
  than before the redesign;
- each rewrite, on a small density that exercises it, gives the value and
  gradient of ``genjax_tpu`` (``jax.value_and_grad``) and of torch autograd
  on the same density to 1e-5, with the same NaN, infinity and finite
  pattern, at ordinary inputs and at 0, +-inf, NaN, 1e30 and subnormals
  (the subnormals against torch only: XLA's CPU backend flushes them to
  zero, the port keeps them, as the card does without fast-math);
- the emitted header, compiled by the host's C++ compiler, equals the plain
  version in the straight-line form and in the loop form (a product above
  ``UNROLL_LIMIT``), at the same edge inputs, the fast program's fallback
  included;
- two datasets of one shape stage to one header, which holds none of their
  values.
"""

import numpy as np
import pytest
import torch

from genjax_tpu_torch.kernels import hmc, staged
from test_torch_staged_body import DENSITIES, _host_build, jax_density, torch_density
from torch_threads import _one_thread  # noqa: F401

# Program.flop of each density as staged before the redesign (one op per
# materialised array element; the lowering of the first staged body)
FLOP_BEFORE = {"iid_normal": 41, "anisotropic": 49, "const_hoisting": 79, "scales5": 35, "conjugate": 56,
               "flagship": 923, "flagship_5x3": 229, "linear_regression": 563}

EDGE = np.asarray([0.0, np.inf, -np.inf, np.nan, 1e30, -1e30], np.float32)
SUBNORMAL = np.asarray([1e-40, -3e-39], np.float32)
SC = np.asarray([0.5, 2.0, 4.0, 0.25, 3.0, 1.5], np.float32)


def _views_copied(program) -> int:
    return sum(1 for i in program.instrs if i.kind == "map" and i.op == "copy" and i.out.kind == "v")


def test_flagship_program_counts():
    ld, d = torch_density("flagship")
    body = staged.stage_body(ld, d)
    p = body.program
    assert p.flop <= 660, p.flop
    assert p.elements("log") <= 2
    assert p.elements("div", "recip", "rsqrt") <= 3
    assert _views_copied(p) == 0 and _views_copied(p.fallback) == 0
    assert body.const_mode == "param"


@pytest.mark.parametrize("name", DENSITIES)
def test_no_density_counts_more_operations(name):
    ld, d = torch_density(name)
    assert staged.stage_body(ld, d).flop <= FLOP_BEFORE[name]


# ---- one small density for each rewrite, in torch and in jnp

def _sc_t():
    return torch.from_numpy(SC)[:, None]


REWRITES = {
    # broadcast-aware lowering: a chain scalar broadcast over the model axis,
    # divided by repeatedly (one reciprocal) and taken out of a sum (guarded)
    "broadcast": (lambda q: -0.5 * torch.sum((q[1:] / q[:1]) ** 2, 0) - 5.0 * torch.log(q[0] ** 2),
                  lambda q, jnp: -0.5 * jnp.sum((q[1:] / q[:1]) ** 2, 0) - 5.0 * jnp.log(q[0] ** 2)),
    # identities on literals, neg of neg, chains of scalings
    "identities": (lambda q: torch.sum(-(-(q * 1.0 + 0.0 - 0.0)) * 2.0 * -8.0 * 0.25 / 4.0 - q * q, 0),
                   lambda q, jnp: jnp.sum(-(-(q * 1.0 + 0.0 - 0.0)) * 2.0 * -8.0 * 0.25 / 4.0 - q * q, 0)),
    # a hoisted divisor (its reciprocal at stage time) and a repeated
    # subexpression
    "hoisted_cse": (lambda q: torch.sum(q / _sc_t() + q / _sc_t() - torch.exp(q / _sc_t()), 0),
                    lambda q, jnp: jnp.sum(q / SC[:, None] + q / SC[:, None] - jnp.exp(q / SC[:, None]), 0)),
    # uniform terms and scalings taken out of sums, a chain multiplier (guarded)
    "sum_pull_out": (lambda q: torch.sum((q[1:] * q[0] + 3.0) * 0.5, 0) * q[0] - torch.sum(q[1:] * q[1:] - q[0], 0),
                     lambda q, jnp: jnp.sum((q[1:] * q[0] + 3.0) * 0.5, 0) * q[0] - jnp.sum(q[1:] * q[1:] - q[0], 0)),
    # the gradient's scatters written piece by piece into g
    "scatter": (lambda q: -0.5 * (q[:3] ** 2).sum(0) + torch.log1p(q[3:5] ** 2).sum(0) + q[5] * q[4],
                lambda q, jnp: -0.5 * (q[:3] ** 2).sum(0) + jnp.log1p(q[3:5] ** 2).sum(0) + q[5] * q[4]),
}


def _edge_q(d: int, n_random: int, values) -> np.ndarray:
    """Ordinary columns, then for each special value a column with it in
    each row in turn, and a column of it in every row."""
    rng = np.random.default_rng(7)
    cols = [(0.5 + rng.uniform(size=(d, n_random))).astype(np.float32)]
    base = (0.5 + rng.uniform(size=(d, 1))).astype(np.float32)
    for v in values:
        for k in range(d):
            c = base.copy()
            c[k] = v
            cols.append(c)
        cols.append(np.full((d, 1), v, np.float32))
    return np.concatenate(cols, axis=1)


def _same_pattern(a: np.ndarray, b: np.ndarray, what: str) -> None:
    for test in (np.isnan, np.isposinf, np.isneginf):
        bad = test(a) != test(b)
        assert not bad.any(), f"{what}: {test.__name__} differs at {np.argwhere(bad)[:5].tolist()}"
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5, atol=1e-5, err_msg=what)


def _jax_value_and_grad(jfn, q: np.ndarray):
    import jax
    import jax.numpy as jnp

    f = lambda x: jfn(x, jnp)  # noqa: E731
    lp, g = jax.jit(lambda x: (f(x), jax.grad(lambda z: jnp.sum(f(z)))(x)))(jnp.asarray(q))
    return np.asarray(lp), np.asarray(g)


@pytest.mark.parametrize("name", sorted(REWRITES))
def test_rewrite_keeps_value_gradient_and_pattern(name, tmp_path):
    tfn, jfn = REWRITES[name]
    body = staged.stage_body(tfn, 6)
    lib = _host_build(body, tmp_path)
    for values, with_jax in ((EDGE, True), (SUBNORMAL, False)):
        q = _edge_q(6, 8, values)
        lp_t, g_t = (x.numpy() for x in hmc._lp_grad(tfn, torch.from_numpy(q)))
        lp, g = (x.numpy() for x in body.lp_grad(torch.from_numpy(q)))
        _same_pattern(lp, lp_t, f"{name} lp against autograd")
        _same_pattern(g, g_t, f"{name} gradient against autograd")
        if with_jax:
            lp_j, g_j = _jax_value_and_grad(jfn, q)
            _same_pattern(lp, lp_j, f"{name} lp against genjax_tpu")
            _same_pattern(g, g_j, f"{name} gradient against genjax_tpu")
        # the printed body, compiled on the host, runs the same arithmetic
        n = q.shape[1]
        lp_h, g_h = np.empty(n, np.float32), np.empty((6, n), np.float32)
        consts = body.consts_on(torch.device("cpu"))
        lib.run(q.ctypes.data, lp_h.ctypes.data, g_h.ctypes.data, consts.data_ptr(), n)
        _same_pattern(lp_h, lp, f"{name} host-compiled lp")
        _same_pattern(g_h, g, f"{name} host-compiled gradient")


def test_rewrites_are_exercised():
    """Each density of ``REWRITES`` takes the rewrite it is named for."""
    progs = {name: staged.stage_body(fns[0], 6).program for name, fns in REWRITES.items()}
    bc = progs["broadcast"]
    # one reciprocal of q0 for the divisions by it (the value's and the
    # gradient's), log(q0^2) once
    assert bc.elements("recip") == 1 and bc.elements("divr") >= 10 and bc.elements("div") <= 1
    assert bc.elements("log") == 1 and _views_copied(bc) == 0
    ident = progs["identities"]
    lits = [s.value for i in ident.instrs for s in i.srcs if s.kind == "lit"]
    assert 0.0 not in lits and 1.0 not in lits and ident.elements("div") == 0
    assert sum(1 for i in ident.instrs if i.op == "neg" or (i.op == "mul" and i.srcs[1].kind == "lit")) <= 2
    hc = progs["hoisted_cse"]
    assert hc.elements("div") == 0 and hc.elements("exp") == 6
    po = progs["sum_pull_out"]
    assert po.guards and po.fallback is not None and po.fallback.guards == 0
    assert any(i.kind == "reduce" and i.srcs[0].kind == "q" for i in po.instrs)
    sc = progs["scatter"]
    assert _views_copied(sc) == 0 and sum(1 for i in sc.instrs if i.out.kind == "g") >= 3


@pytest.mark.parametrize("name", ["flagship", "linear_regression", "conjugate"])
def test_model_densities_at_edge_inputs(name, tmp_path):
    """The model densities at the edge inputs: the staged program against
    autograd and ``genjax_tpu``, and the printed body against the program
    (a flagship chain with tau at 0 or inf runs the fallback)."""
    ld, d = torch_density(name)
    body = staged.stage_body(ld, d)
    lib = _host_build(body, tmp_path)
    jld = jax_density(name)
    for values, with_jax in ((EDGE, True), (SUBNORMAL, False)):
        q = _edge_q(d, 4, values)
        lp_t, g_t = (x.numpy() for x in hmc._lp_grad(ld, torch.from_numpy(q)))
        lp, g = (x.numpy() for x in body.lp_grad(torch.from_numpy(q)))
        _same_pattern(lp, lp_t, f"{name} lp against autograd")
        _same_pattern(g, g_t, f"{name} gradient against autograd")
        if with_jax:
            lp_j, g_j = _jax_value_and_grad(lambda x, jnp: jld(x), q)
            _same_pattern(lp, lp_j, f"{name} lp against genjax_tpu")
            _same_pattern(g, g_j, f"{name} gradient against genjax_tpu")
        n = q.shape[1]
        lp_h, g_h = np.empty(n, np.float32), np.empty((d, n), np.float32)
        lib.run(q.ctypes.data, lp_h.ctypes.data, g_h.ctypes.data, body.consts_on(torch.device("cpu")).data_ptr(), n)
        _same_pattern(lp_h, lp, f"{name} host-compiled lp")
        _same_pattern(g_h, g, f"{name} host-compiled gradient")


def test_loop_form_above_the_unroll_limit_matches_on_the_host(tmp_path):
    """D = 64 with a 64 x 64 product (4,096 iterations): the product and the
    sums over it print as loops over arrays, the rest straight-line; the
    compiled body equals the plain version and autograd."""
    A = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 64)).astype(np.float32) / 8)
    density = lambda q: -0.5 * ((A @ q) ** 2).sum(0) - 0.25 * (q[:4] ** 2).sum(0)  # noqa: E731
    body = staged.stage_body(density, 64)
    assert any(i.iterations > staged.UNROLL_LIMIT for i in body.program.instrs)
    assert "for (int" in body.header and "const float t" in body.header
    lib = _host_build(body, tmp_path)
    q = _edge_q(64, 16, EDGE[:2])
    n = q.shape[1]
    lp_h, g_h = np.empty(n, np.float32), np.empty((64, n), np.float32)
    lib.run(q.ctypes.data, lp_h.ctypes.data, g_h.ctypes.data, body.consts_on(torch.device("cpu")).data_ptr(), n)
    lp, g = (x.numpy() for x in body.lp_grad(torch.from_numpy(q)))
    _same_pattern(lp_h, lp, "loop form lp")
    _same_pattern(g_h, g, "loop form gradient")
    lp_t, g_t = (x.numpy() for x in hmc._lp_grad(density, torch.from_numpy(q)))
    _same_pattern(lp, lp_t, "loop form lp against autograd")
    _same_pattern(g, g_t, "loop form gradient against autograd")


def test_two_datasets_of_one_shape_stage_to_one_header():
    from genjax_tpu_torch.kernels import ColumnPacker, column_logdensity
    from genjax_tpu_torch.models import hierarchical_regression

    import genjax_tpu_torch as g

    bodies = []
    for seed in (0, 5):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(16, 8)).astype(np.float32)
        y = rng.normal(size=16).astype(np.float32)
        model, obs = hierarchical_regression(X), g.C["y"].set(y)
        packer = ColumnPacker(model, obs, (), ["tau", "w"])
        bodies.append((staged.stage_body(column_logdensity(model, obs, (), packer), packer.padded_dim), X, y))
    (a, Xa, ya), (b, Xb, yb) = bodies
    assert a.header == b.header and a.digest == b.digest
    assert not torch.equal(a.consts, b.consts)
    for X, y in ((Xa, ya), (Xb, yb)):
        for v in (X[0, 0], X[3, 5], y[7]):
            assert staged._literal(v, "f") not in a.header


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_obs,mode", [(100, "param"), (300, "shared"), (1500, "global")])
def test_staged_kernels_in_each_constant_mode(n_obs, mode):
    """A regression's density whose product is printed in the loop form,
    its constants in each of the three modes: K1 and K4 against their
    plain versions on the counter stream, as ``chip_smoke.py`` gates them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from genjax_tpu_torch.kernels import nuts, nuts_pallas

    dev = torch.device("cuda")
    X = torch.from_numpy((np.random.default_rng(8).normal(size=(n_obs, 8)) / np.sqrt(n_obs)).astype(np.float32))
    X = X.to(dev)
    density = lambda q: -0.5 * torch.sum((X @ q) ** 2, dim=0) - 0.5 * torch.sum(q * q, dim=0)  # noqa: E731
    body = staged.stage_body(density, 8, device=dev)
    assert body.const_mode == mode and any(i.iterations > staged.UNROLL_LIMIT for i in body.program.instrs)
    q0 = torch.from_numpy((0.5 * np.random.default_rng(9).normal(size=(8, 4096))).astype(np.float32)).to(dev)
    kw = dict(rng="counter", block_n=128)
    qk, acc = hmc.hmc_sweep(body, q0, 5, n_steps=5, eps=0.2, L=5, **kw)
    qt, rate = hmc._reference_hmc(body, q0, 5, n_steps=5, eps=0.2, L=5, **kw)
    assert float(((qk - qt).abs().amax(dim=0) <= 1e-4).float().mean()) >= 0.995
    assert abs(float(acc.mean()) / 5 - float(rate)) <= 0.005
    qk, acc, _ = nuts_pallas.nuts_sweep(body, q0, 5, n_steps=3, eps=0.3, max_depth=6, **kw)
    qt, acc_t, _ = nuts.nuts_sweep_cols(body, q0, 5, n_steps=3, eps=0.3, max_depth=6, **kw)
    assert float(((qk - qt).abs().amax(dim=0) <= 1e-4).float().mean()) >= 0.99
    assert abs(float(acc.mean()) / 3 - float(acc_t)) <= 0.005
