"""The staged device body (``kernels/staged.py``) against the reference.

The reference's Pallas kernels replay any column density's jaxpr; the port
stages it into a per-chain program that K1 and K4 compile. Here, on
numpy-seeded inputs:

- the lowered program (``StagedBody.lp_grad``, which interprets the op list
  the emitter prints) equals ``jax.value_and_grad`` of the same density in
  ``genjax_tpu`` to rtol 1e-5 and atol 1e-5, on seven densities;
- the emitted function, compiled by the host's C++ compiler through a small
  driver loaded with ``ctypes``, equals the lowered program to 1e-5, with
  -inf and NaN at the same places off the support;
- the counter-stream twins driven by a staged body equal the reference's
  Pallas kernels in interpret mode draw for draw;
- densities outside the op set raise, naming the op and ``backend='torch'``.

The ``cuda`` cases hold the staged K1 and K4 against their plain versions
and the default route of ``column_hmc`` on the card; JAX is imported inside
the tests that compare with it, so that they also run on a machine with no
JAX: ``python -m pytest tests/test_torch_staged_body.py -m cuda --noconftest``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu_torch.kernels import ColumnPacker, column_logdensity, hmc, nuts, nuts_pallas, staged
from torch_threads import _one_thread  # noqa: F401

ANISO = np.geomspace(0.3, 3.0, 8).astype(np.float32)  # tests/kernels/test_nuts_pallas.py:34
SCALES5 = np.asarray([0.05, 0.2, 1.0, 3.0, 5.0], np.float32)  # test_column_hmc.py's TestMassAdaptation
HOIST_X = np.asarray([[1.0, 0.5], [0.0, 1.0]], np.float32)  # test_kernel_const_hoisting
HOIST_Y = np.asarray([1.0, -1.0], np.float32)
N_CHAINS = 64


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


def _hoist_torch(q):
    r = torch.from_numpy(HOIST_X) @ q[:2, :] - torch.from_numpy(HOIST_Y)[:, None]
    return -0.5 * torch.sum(r * r, dim=0) - 0.5 * torch.sum(q * q, dim=0)


def _aniso_torch(q):
    return -0.5 * torch.sum((q / torch.from_numpy(ANISO)[:, None]) ** 2, dim=0)


def _regression_data(shape):
    X = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(shape[0],)).astype(np.float32)
    return X, y


def _linreg_data():
    """``examples/10_sample_posterior.py``'s data: 24 x 3, ``w_true``."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(24, 3)).astype(np.float32)
    y = (X @ np.asarray([1.0, -2.0, 0.5], np.float32) + 0.25 * rng.normal(size=24)).astype(np.float32)
    return X, y


def torch_density(name, device=None):
    """``(density, d)`` of one of the seven densities in the port, its
    constants on ``device`` (the CPU by default)."""
    if name == "iid_normal":
        return (lambda q: -0.5 * torch.sum(q * q, dim=0)), 8
    if name == "anisotropic":
        return _aniso_torch, 8
    if name == "const_hoisting":
        return _hoist_torch, 8
    if name == "scales5":
        sc = torch.from_numpy(SCALES5).to(device)
        return (lambda q: torch.sum(-0.5 * (q / sc[:, None]) ** 2, dim=0)), 5
    from genjax_tpu_torch.models import hierarchical_regression, linear_regression

    if name == "conjugate":
        model, obs, addrs = conjugate, g.C["y"].set(2.0), ["mu"]
    elif name.startswith("flagship"):
        X, y = _regression_data((16, 8) if name == "flagship" else (5, 3))
        model, obs, addrs = hierarchical_regression(X), g.C["y"].set(y), ["tau", "w"]
    else:
        X, y = _linreg_data()
        model, obs, addrs = linear_regression(X)[0], g.C["y"].set(y), ["w"]
    packer = ColumnPacker(model, obs, (), addrs, device=device)
    return column_logdensity(model, obs, (), packer), packer.padded_dim


def jax_density(name):
    """The same density built from ``genjax_tpu`` on the same numpy data."""
    import jax.numpy as jnp

    import genjax_tpu as gj
    from genjax_tpu.kernels import ColumnPacker as JP
    from genjax_tpu.kernels import column_logdensity as jld

    if name == "iid_normal":
        return lambda q: -0.5 * jnp.sum(q * q, axis=0)
    if name == "anisotropic":
        return lambda q: -0.5 * jnp.sum((q / jnp.asarray(ANISO)[:, None]) ** 2, axis=0)
    if name == "const_hoisting":
        def ld(q):
            resid = HOIST_X @ q[:2, :] - HOIST_Y[:, None]
            return -0.5 * jnp.sum(resid * resid, axis=0) - 0.5 * jnp.sum(q * q, axis=0)
        return ld
    if name == "scales5":
        sc = jnp.asarray(SCALES5)
        return lambda q: jnp.sum(-0.5 * (q / sc[:, None]) ** 2, axis=0)
    from genjax_tpu.models import hierarchical_regression, linear_regression

    if name == "conjugate":
        @gj.gen
        def jconj():
            mu = gj.normal(0.0, 1.0) @ "mu"
            _ = gj.normal(mu, 1.0) @ "y"

        model, obs, addrs = jconj, gj.C["y"].set(2.0), ["mu"]
    elif name.startswith("flagship"):
        X, y = _regression_data((16, 8) if name == "flagship" else (5, 3))
        model, obs, addrs = hierarchical_regression(X), gj.C["y"].set(jnp.asarray(y)), ["tau", "w"]
    else:
        X, y = _linreg_data()
        model, obs, addrs = linear_regression(X)[0], gj.C["y"].set(jnp.asarray(y)), ["w"]
    return jld(model, obs, (), JP(model, obs, (), addrs))


DENSITIES = ["iid_normal", "anisotropic", "const_hoisting", "scales5", "conjugate", "flagship",
             "flagship_5x3", "linear_regression"]


def _q(name, d, n, seed=0):
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.normal(size=(d, n))).astype(np.float32)
    if name.startswith("flagship"):
        q[0] = rng.uniform(0.5, 1.5, size=n)
        q[0, :4] = (-0.5, -0.25, -1e-3, -2.0)  # off the support: lp -inf, gradient NaN
    return q


@pytest.fixture(scope="module")
def bodies_by_name():
    out = {}
    for name in DENSITIES:
        ld, d = torch_density(name)
        out[name] = staged.stage_body(ld, d)
    return out


@pytest.mark.parametrize("name", DENSITIES)
def test_lowering_matches_jax_value_and_grad(name, bodies_by_name):
    import jax
    import jax.numpy as jnp

    body = bodies_by_name[name]
    q = _q(name, body.d, N_CHAINS)
    jld = jax_density(name)
    # chains are independent: the gradient of the sum is every chain's own
    jlp, jg = jax.jit(lambda x: (jld(x), jax.value_and_grad(lambda z: jnp.sum(jld(z)))(x)[1]))(
        jnp.asarray(q))
    lp, grad = body.lp_grad(torch.from_numpy(q))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    if name.startswith("flagship"):
        assert np.isneginf(lp.numpy()[:4]).all() and np.isnan(grad.numpy()[0, :4]).all()


def _host_compiler():
    return shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")


def _host_build(body, tmp_path):
    """The emitted header compiled by the host's C++ compiler into a driver
    that runs ``gjt_staged::lp_grad`` over the columns of ``q``."""
    cxx = _host_compiler()
    if cxx is None:
        pytest.skip("no host C++ compiler (g++, c++ or clang++) to compile the emitted body")
    (tmp_path / "staged.cuh").write_text(body.header)
    (tmp_path / "driver.cpp").write_text(
        '#include "staged.cuh"\n'
        'extern "C" void run(const float* q, float* lp, float* g, const float* c, int n) {\n'
        "  for (int j = 0; j < n; ++j) {\n"
        "    float qq[gjt_staged::kD], gg[gjt_staged::kD];\n"
        "    for (int d = 0; d < gjt_staged::kD; ++d) qq[d] = q[d * n + j];\n"
        "    lp[j] = gjt_staged::lp_grad(qq, gg, c);\n"
        "    for (int d = 0; d < gjt_staged::kD; ++d) g[d * n + j] = gg[d];\n"
        "  }\n"
        "}\n"
    )
    so = tmp_path / "driver.so"
    proc = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                           str(tmp_path / "driver.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    return lib


@pytest.mark.parametrize("name", DENSITIES)
def test_emitted_body_on_the_host_matches_the_lowering(name, bodies_by_name, tmp_path):
    body = bodies_by_name[name]
    lib = _host_build(body, tmp_path)
    q = torch.from_numpy(_q(name, body.d, N_CHAINS, seed=1))
    lp = torch.empty(N_CHAINS)
    grad = torch.empty(body.d, N_CHAINS)
    consts = body.consts_on(torch.device("cpu"))
    lib.run(q.data_ptr(), lp.data_ptr(), grad.data_ptr(), consts.data_ptr(), N_CHAINS)
    lp_ref, g_ref = body.lp_grad(q)
    np.testing.assert_allclose(lp.numpy(), lp_ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), g_ref.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(torch.isneginf(lp), torch.isneginf(lp_ref))
    assert torch.equal(torch.isnan(grad), torch.isnan(g_ref))
    if name.startswith("flagship"):
        assert bool(torch.isneginf(lp[:4]).all())


def test_hmc_twin_on_a_staged_body_matches_pallas_interpret_draw_for_draw():
    """The reference's ``test_kernel_const_hoisting`` density: the counter
    twin driven by its staged body against ``pallas_hmc(interpret=True,
    backend="pallas")``, at ``test_torch_hmc.py``'s tolerance."""
    import jax.numpy as jnp
    from genjax_tpu.kernels import hmc as jax_hmc

    body = staged.stage_body(_hoist_torch, 8)
    q0 = (0.3 * np.random.default_rng(1).normal(size=(8, 256))).astype(np.float32)
    for seed in (5, -11):
        jq, jacc = jax_hmc.pallas_hmc(jax_density("const_hoisting"), jnp.asarray(q0), seed, n_steps=5,
                                      eps=0.3, L=5, block_n=128, interpret=True, backend="pallas")
        tq, tacc = hmc._reference_hmc(body, torch.from_numpy(q0), seed, n_steps=5, eps=0.3, L=5,
                                      rng="counter", block_n=128)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
        assert float(tacc) == float(jacc)


def test_nuts_twin_on_a_staged_body_matches_pallas_interpret_draw_for_draw():
    """The anisotropic Gaussian of ``tests/kernels/test_nuts_pallas.py``:
    the counter twin driven by its staged body against
    ``pallas_nuts(interpret=True)``, at ``test_torch_nuts.py``'s tolerance."""
    import jax.numpy as jnp
    from genjax_tpu.kernels.nuts_pallas import pallas_nuts as jax_pallas_nuts

    body = staged.stage_body(_aniso_torch, 8)
    q0 = (3.0 * 0.3 * np.random.default_rng(1).normal(size=(8, 256))).astype(np.float32)
    kw = dict(n_steps=3, eps=0.3, max_depth=5, inv_mass=ANISO**2, block_n=128)
    jq, jacc, jleaps = jax_pallas_nuts(jax_density("anisotropic"), jnp.asarray(q0), 5, interpret=True, **kw)
    tq, tacc, tleaps = nuts.nuts_sweep_cols(body, torch.from_numpy(q0), 5, rng="counter", **kw)
    err = np.abs(tq.numpy() - np.asarray(jq)).max(axis=0)
    assert float((err <= 1e-5).mean()) >= 0.99, err.max()
    assert float(tleaps) == float(jleaps)
    assert abs(float(tacc) - float(jacc)) <= 1e-6


_W = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 6)).astype(np.float32))
_B = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 2, 3)).astype(np.float32))
MORE_OPS = {
    "linear": lambda q: -0.5 * (torch.nn.functional.linear(q.T, _W, _W[:, 0]) ** 2).sum(1),
    "stack_transpose": lambda q: -0.5 * torch.stack([q[0] * q[1], q[2] - q[3]], 0).transpose(0, 1).pow(2).sum(1),
    "bmm": lambda q: -0.5 * (torch.einsum("kij,jn->kin", _B, q[:3]) ** 2).sum((0, 1)),
    "addmm": lambda q: -(torch.addmm(_W[:, :1], _W, q, beta=2.0, alpha=0.5) ** 2).sum(0),
    "special": lambda q: (torch.erf(q) + torch.expm1(-q * q) + torch.log1p(q * q) + torch.rsqrt(1 + q * q)).sum(0),
    "activations": lambda q: (q.masked_fill(q < -0.5, 0.0) - torch.nn.functional.logsigmoid(q)
                              + torch.nn.functional.softplus(q) + torch.tanh(q) + torch.relu(q)).sum(0)
    + torch.logsumexp(q, 0),
    "per_chain_dot": lambda q: torch.func.vmap(lambda c: -0.5 * (c @ c) + torch.sin(c).sum(), in_dims=1)(q),
    "reshape_amax": lambda q: -0.5 * (q.reshape(2, 3, -1) ** 2).sum((0, 1)) + q.T.reshape(-1, 2, 3).amax((1, 2)),
}


@pytest.mark.parametrize("name", sorted(MORE_OPS))
def test_more_ops_lower_to_their_autograd_values(name):
    """Ops beyond the seven densities' (products, stacking, the activations
    and their backward ops, a per-chain product under vmap): the lowered
    program equals the density and its autograd gradient to 1e-5."""
    ld = MORE_OPS[name]
    body = staged.stage_body(ld, 6)
    q = torch.from_numpy(np.random.default_rng(4).normal(size=(6, 32)).astype(np.float32))
    lp_ref, g_ref = hmc._lp_grad(ld, q)
    lp, grad = body.lp_grad(q)
    torch.testing.assert_close(lp, lp_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grad, g_ref, rtol=1e-5, atol=1e-5)


class _RowSharded:
    row_shard = object()

    def __call__(self, q):
        return -0.5 * torch.sum(q * q, dim=0)


_IDX = torch.tensor([0, 2, 3])
REFUSALS = {
    "sort": (lambda q: torch.sort(q, dim=0).values[0], "aten.sort"),
    "cumsum": (lambda q: torch.cumsum(q, dim=0).sum(0), "aten.cumsum"),
    "gather": (lambda q: q[_IDX].sum(0), "aten.index"),
    "item": (lambda q: -0.5 * (q * q).sum(0) * q[0, 0].item(), "_local_scalar_dense"),
    "chain_reduction": (lambda q: -0.5 * (q * q).sum() + 0.0 * q[0], "aten.sum.default"),
    "chain_constant": (lambda q: -0.5 * ((q - torch.arange(q.shape[1])) ** 2).sum(0), "aten.arange"),
    "row_shard": (_RowSharded(), ".row_shard"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_unstageable_densities_raise_naming_the_op(case):
    ld, op = REFUSALS[case]
    with pytest.raises(ValueError) as err:
        staged.stage_body(ld, 8)
    assert op in str(err.value) and "backend='torch'" in str(err.value)


@pytest.mark.parametrize("d", [0, staged.MAX_D + 1])
def test_dimensions_outside_the_range_raise(d):
    with pytest.raises(ValueError, match="backend='torch'"):
        staged.stage_body(lambda q: -0.5 * torch.sum(q * q, dim=0), d)


def test_device_body_stages_once_per_callable_and_dimension():
    """``warmup_column``'s phases stage once: inside a ``staging_scope``
    (which ``column_hmc``, ``column_nuts`` and the two warmups open) the
    body is kept per callable and ``(d, device)``; outside one every call
    stages anew, so a tensor the density captured and that was updated in
    place since is read as it is now. A hand-written body is taken as it
    is."""
    ld, d = torch_density("conjugate")
    cpu = torch.device("cpu")
    with staged.staging_scope():
        first = hmc.device_body(ld, d, cpu)
        with staged.staging_scope():
            assert first.name == "staged" and hmc.device_body(ld, d, cpu) is first
    assert hmc.device_body(ld, d, cpu) is not first

    scales = torch.ones(3)
    aniso = lambda q: torch.sum(-0.5 * (q / scales[:, None]) ** 2, dim=0)  # noqa: E731
    q = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 7)).astype(np.float32))
    before = hmc.device_body(aniso, 3, cpu).lp_grad(q)[0]
    scales.mul_(2.0)
    after = hmc.device_body(aniso, 3, cpu).lp_grad(q)[0]
    torch.testing.assert_close(after, before / 4.0, rtol=1e-6, atol=1e-6)
    from genjax_tpu_torch.kernels import bodies

    iid = bodies.iid_normal()
    assert hmc.device_body(iid, 8, cpu) is iid


def test_program_interpreter_is_the_bodys_gradient_under_autograd(bodies_by_name):
    """A twin differentiates a staged body by autograd and gets the
    program's own gradient (``_StagedLp``)."""
    body = bodies_by_name["linear_regression"]
    q = torch.from_numpy(_q("linear_regression", body.d, 32, seed=3))
    lp, grad = hmc._lp_grad(body, q)
    lp_ref, g_ref = body.lp_grad(q)
    assert torch.equal(lp, lp_ref) and torch.equal(grad, g_ref)


def test_staged_shared_memory_reckoning(bodies_by_name):
    """K1 and K4 count a staged body's constants in their shared memory
    (to a float4) only where the body copies them there: none where they
    travel by value as a kernel parameter (up to ``PARAM_CAP_BYTES``, the
    flagship's) or are read from global memory (past ``SMEM_CAP_BYTES``)."""
    body = bodies_by_name["flagship"]
    assert body.const_mode == "param" and not body.shared and body.shared_consts_floats(16) == 0
    assert 4 * body.n_consts <= staged.PARAM_CAP_BYTES and "kConstMode = 0" in body.header
    assert hmc.smem_bytes(body, 16) == 4 * 3 * 16
    assert nuts_pallas.smem_bytes(body, 16, 8, 32) == 4 * 2 * 8 * 16 * 32

    def regression(n):
        X = torch.from_numpy(np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32))
        return staged.stage_body(lambda q: -0.5 * torch.sum((X @ q) ** 2, dim=0), 8)

    mid = regression(300)  # 9.6 kB: past the parameter cap, under the shared-memory cap
    floats = (mid.n_consts + 3) // 4 * 4
    assert mid.const_mode == "shared" and mid.shared and "kConstMode = 1" in mid.header
    assert hmc.smem_bytes(mid, 8) == 4 * (floats + 3 * 8)
    assert nuts_pallas.smem_bytes(mid, 8, 8, 32) == 4 * (floats + 2 * 8 * 8 * 32)
    big = regression(5000)  # 160 kB
    # X once: its folded transpose (the gradient's) reads the same copy
    assert 40000 <= big.n_consts < 40008 and big.const_mode == "global" and big.shared_consts_floats(8) == 0
    assert "__ldg" in big.header


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scales5", "conjugate", "flagship"])
def test_staged_kernels_match_their_plain_versions(name):
    device = _cuda()
    ld, d = torch_density(name, device)
    body = staged.stage_body(ld, d, device=device)
    q0 = torch.from_numpy(_q(name, d, 4096, seed=6)).to(device)
    if name.startswith("flagship"):
        q0[0] = q0[0].abs() + 0.5
    kw = dict(rng="counter", block_n=128)
    qk, acc = hmc.hmc_sweep(body, q0, 5, n_steps=5, eps=0.02, L=5, **kw)
    assert hmc.hmc_sweep.last_variant == "staged"
    qt, rate = hmc._reference_hmc(body, q0, 5, n_steps=5, eps=0.02, L=5, **kw)
    assert float(((qk - qt).abs().amax(dim=0) <= 1e-4).float().mean()) >= 0.995
    assert abs(float(acc.mean()) / 5 - float(rate)) <= 0.005
    qk, acc, leaps = nuts_pallas.nuts_sweep(body, q0, 5, n_steps=3, eps=0.05, max_depth=6, **kw)
    qt, acc_t, leaps_t = nuts.nuts_sweep_cols(body, q0, 5, n_steps=3, eps=0.05, max_depth=6, **kw)
    assert float(((qk - qt).abs().amax(dim=0) <= 1e-4).float().mean()) >= 0.99
    assert abs(float(acc.mean()) / 3 - float(acc_t)) <= 0.005


@pytest.mark.cuda
def test_column_hmc_of_a_model_without_a_hand_written_body_runs_staged():
    _cuda()
    from genjax_tpu_torch.kernels import column_hmc

    q, _, _ = column_hmc(conjugate, g.C["y"].set(2.0), (), ["mu"], n_chains=4096, n_steps=200, eps=0.5,
                         L=5, device="cuda")
    assert hmc.pallas_hmc.last_backend == "cuda" and hmc.pallas_hmc.last_body == "staged"
    se = float(q[0].std()) / 4096**0.5
    assert abs(float(q[0].mean()) - 1.0) < 4 * se + 0.01
