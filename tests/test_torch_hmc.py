"""The port's HMC sweep against the reference's Pallas kernel.

The counter stream equals the reference's ``_sw_rand_bits_factory`` bit for
bit (uniforms exactly, normals to rtol 1e-6), and the plain twin on that
stream reproduces ``pallas_hmc(interpret=True, backend="pallas")`` draw for
draw (positions atol 1e-5, equal accept rates). The CUDA kernel is held
against the twin in a test marked ``cuda``, which skips without a card.

JAX is imported inside the tests that compare with it, so that the ``cuda``
case also runs on a machine with no JAX:
``python -m pytest tests/test_torch_hmc.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from genjax_tpu_torch.kernels import bodies, hmc


def _jax_hmc():
    from genjax_tpu.kernels import hmc as jax_hmc

    return jax_hmc


SEEDS = [0, 1, -1, 12345, -987654321, 2**31 - 1, -(2**31), 2**31 - 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_counter_bits_match_reference(seed):
    import jax.numpy as jnp

    jh = _jax_hmc()
    for block in range(4):
        jbase = jnp.int32(seed) + jnp.int32(block) * jnp.int32(0x3504F333)
        tbase = hmc._block_base(seed, block)
        for salt in (0, 1, 2, 5, 198, 401):
            for shape in ((8, 128), (16, 128), (1, 128), (128,), (37,)):
                ref = np.asarray(jh._sw_rand_bits_factory(jbase)(shape, salt)).astype(np.int64)
                got = hmc._sw_rand_bits_factory(tbase)(shape, salt).numpy()
                np.testing.assert_array_equal(got, ref, err_msg=f"{block} {salt} {shape}")


@pytest.mark.parametrize("seed", [0, -3, 2**31 - 1])
def test_uniform_and_normal_match_reference(seed):
    import jax.numpy as jnp

    jh = _jax_hmc()
    for block in range(4):
        jbits = jh._sw_rand_bits_factory(jnp.int32(seed) + jnp.int32(block) * jnp.int32(0x3504F333))
        tbits = hmc._sw_rand_bits_factory(hmc._block_base(seed, block))
        for salt, shape in ((0, (8, 128)), (6, (1, 128)), (9, (16, 256))):
            np.testing.assert_array_equal(
                hmc._uniform_01(tbits, shape, salt).numpy(),
                np.asarray(jh._uniform_01(jbits, shape, salt)),
            )
            np.testing.assert_allclose(
                hmc._normal(tbits, shape, salt).numpy(),
                np.asarray(jh._normal(jbits, shape, salt)),
                rtol=1e-6, atol=1e-6,
            )


def _flagship_densities():
    import genjax_tpu as gj
    from genjax_tpu.kernels import ColumnPacker as JP
    from genjax_tpu.kernels import column_logdensity as jld
    from genjax_tpu.models import hierarchical_regression as jhier

    import genjax_tpu_torch as g
    from genjax_tpu_torch.kernels import ColumnPacker, column_logdensity
    from genjax_tpu_torch.models import hierarchical_regression

    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    jm, jobs = jhier(X), gj.C["y"].set(y)
    tm, tobs = hierarchical_regression(X), g.C["y"].set(y)
    return (
        jld(jm, jobs, (), JP(jm, jobs, (), ["tau", "w"])),
        column_logdensity(tm, tobs, (), ColumnPacker(tm, tobs, (), ["tau", "w"])),
    )


def _q0(d, n, seed, tau_row):
    rng = np.random.default_rng(seed)
    q0 = (0.3 * rng.normal(size=(d, n))).astype(np.float32)
    if tau_row:
        q0[0] = rng.uniform(0.5, 1.5, size=n)
    return q0


@pytest.mark.parametrize(
    "case, seed",
    [
        ("iid_normal", 3),
        ("iid_normal", -11),
        ("flagship", 3),
        ("flagship", 2**31 - 2),
        ("flagship_inv_mass", 5),
    ],
)
def test_counter_twin_matches_pallas_interpret_draw_for_draw(case, seed):
    import jax.numpy as jnp

    jh = _jax_hmc()
    inv_mass = np.linspace(0.5, 2.0, 16, dtype=np.float32) if case.endswith("inv_mass") else None
    if case == "iid_normal":
        jld, tld, q0, eps = (
            lambda q: -0.5 * jnp.sum(q * q, axis=0), bodies.iid_normal(), _q0(8, 256, 1, False), 0.2
        )
    else:
        (jld, tld), q0, eps = _flagship_densities(), _q0(16, 256, 2, True), 0.02
    jq, jacc = jh.pallas_hmc(
        jld, jnp.asarray(q0), seed, n_steps=5, eps=eps, L=5, block_n=128,
        interpret=True, backend="pallas", inv_mass=inv_mass,
    )
    tq, tacc = hmc._reference_hmc(
        tld, torch.from_numpy(q0), seed, n_steps=5, eps=eps, L=5, inv_mass=inv_mass,
        rng="counter", block_n=128,
    )
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    assert float(tacc) == float(jacc)
    # the twin through pallas_hmc's routing is the same computation
    rq, racc = hmc.pallas_hmc(
        tld, torch.from_numpy(q0), seed, n_steps=5, eps=eps, L=5, block_n=128, interpret=True,
        inv_mass=inv_mass,
    )
    assert hmc.pallas_hmc.last_backend == "torch"
    assert torch.equal(rq, tq) and float(racc) == float(tacc)


def test_twin_rejects_off_support_proposals():
    """A trajectory into tau <= 0 yields NaN/-inf lp_new, which must reject."""
    _, tld = _flagship_densities()
    q0 = torch.from_numpy(_q0(16, 256, 4, True))
    q0[0] = 0.01
    q, acc = hmc._reference_hmc(tld, q0, 0, n_steps=3, eps=0.5, L=5, rng="counter", block_n=128)
    assert bool(torch.isfinite(q).all()) and bool((q[0] > 0).all())
    assert float(acc) < 1.0


@pytest.mark.parametrize("interpret", [True, False], ids=["counter", "generator"])
def test_kernel_grid_blocks_get_distinct_streams(interpret):
    """The reference's ``test_column_hmc.py`` case of the same name: two
    chain blocks that start identically must decorrelate, on the counter
    stream (a base per block of ``block_n``) and on the generator."""
    q0 = torch.zeros(8, 256)
    q, _ = hmc.pallas_hmc(
        lambda q: -0.5 * (q * q).sum(dim=0), q0, 3, n_steps=20, eps=0.5, L=3, block_n=128,
        interpret=interpret, backend="torch",
    )
    assert hmc.pallas_hmc.last_backend == "torch"
    assert not torch.allclose(q[:, :128], q[:, 128:])


def test_routing_on_the_cpu():
    q0 = torch.zeros(8, 128)
    hmc.pallas_hmc(bodies.iid_normal(), q0, 0, n_steps=1, eps=0.1, L=1)
    assert hmc.pallas_hmc.last_backend == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        hmc.pallas_hmc(bodies.iid_normal(), q0, 0, n_steps=1, eps=0.1, L=1, backend="cuda")
    with pytest.raises(ValueError, match="block_n"):
        hmc.pallas_hmc(bodies.iid_normal(), q0, 0, n_steps=1, eps=0.1, L=1, interpret=True)


@pytest.mark.parametrize(
    "backend, device, taken",
    [
        ("auto", "cpu", "torch"),
        ("torch", "cpu", "torch"),
        ("auto", "cuda", "cuda"),
        ("torch", "cuda", "torch"),
        ("cuda", "cuda", "cuda"),
    ],
)
def test_route(backend, device, taken):
    assert hmc._route(backend, torch.device(device)) == taken


def _cumsum_density(q):
    return -0.5 * torch.cumsum(q * q, dim=0)[-1]


@pytest.mark.parametrize("density", ["stageable", "unstageable"])
@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_route_refuses_the_card_without_a_body(backend, density):
    """Chains on the card never fall back to the twin unasked: a density
    with no hand-written body routes to the kernel with its staged body
    (``hmc.device_body``), and one that cannot be staged raises naming
    ``backend='torch'``."""
    assert hmc._route(backend, torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="backend must be"):
        hmc._route(backend.upper(), torch.device("cuda"))
    if density == "stageable":
        body = hmc.device_body(lambda q: -0.5 * (q * q).sum(dim=0), 8, torch.device("cpu"))
        assert body.name == "staged" and body.kind == 2
    else:
        with pytest.raises(ValueError, match="aten.cumsum.*backend='torch'"):
            hmc.device_body(_cumsum_density, 8, torch.device("cpu"))


@pytest.mark.parametrize(
    "shape, d, smem",
    [
        (None, 8, 4 * 24),  # iid_normal: eps * M^-1, M^-1 and the momentum sd
        ((16, 8), 16, 4 * 48),  # the flagship: X, y as kernel parameters
        ((5, 3), 8, 4 * (20 + 24)),  # 5 x 4 floats of X, y
        ((1500, 8), 16, 4 * (13500 + 48)),  # past 48 KiB: the launch opts in
    ],
)
def test_shared_memory(shape, d, smem):
    """K1's shared memory a block. The generic variant keeps X as compact as
    in device memory, so its size grows as n_obs (d_w + 1); above 48 KiB the
    launch opts in to more, up to the card's limit (232,448 B on an H100)."""
    if shape is None:
        body = bodies.iid_normal()
    else:
        rng = np.random.default_rng(1)
        body = bodies.hier_regression(
            rng.normal(size=shape).astype(np.float32), rng.normal(size=shape[0]).astype(np.float32), 0.25
        )
    assert hmc.smem_bytes(body, d) == smem
    assert hmc.smem_bytes(bodies.hier_regression(np.ones((5000, 8)), np.ones(5000), 1.0), 16) <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("density", ["stageable", "unstageable"])
def test_column_hmc_on_the_card_without_a_body_raises(density):
    """A model with no hand-written body runs K1 with its staged body under
    the default backend; one whose density cannot be staged raises, and
    ``backend="torch"`` runs the twin on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import genjax_tpu_torch as g
    from genjax_tpu_torch.kernels import column_hmc

    @g.gen
    def model():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 1.0) @ "y"

    @g.gen
    def cumulative():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(torch.cumsum(mu * torch.ones(3, device=mu.device), dim=0)[-1], 1.0) @ "y"

    kw = dict(n_chains=256, n_steps=2, eps=0.5, L=2, device="cuda")
    if density == "stageable":
        q, _, _ = column_hmc(model, g.C["y"].set(2.0), (), ["mu"], **kw)
        assert hmc.pallas_hmc.last_backend == "cuda" and hmc.pallas_hmc.last_body == "staged"
        return
    with pytest.raises(ValueError, match="backend='torch'"):
        column_hmc(cumulative, g.C["y"].set(2.0), (), ["mu"], **kw)
    q, _, _ = column_hmc(cumulative, g.C["y"].set(2.0), (), ["mu"], backend="torch", **kw)
    assert hmc.pallas_hmc.last_backend == "torch" and q.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize(
    "body_name, d, variant",
    [
        ("iid_normal", 8, "specialised"),
        ("hier_regression", 16, "specialised"),
        ("hier_regression_5x3", 8, "generic"),
        ("hier_regression_1500x8", 16, "generic"),  # 54,192 B of shared memory
    ],
)
def test_cuda_kernel_matches_plain_twin(body_name, d, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if body_name == "iid_normal":
        body = bodies.iid_normal()
    elif body_name == "hier_regression":
        X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
        y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
        body = bodies.hier_regression(X, y, 0.25)
    elif body_name == "hier_regression_5x3":
        rng = np.random.default_rng(53)
        body = bodies.hier_regression(
            rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=5).astype(np.float32), 0.25
        )
    else:
        rng = np.random.default_rng(54)
        body = bodies.hier_regression(
            rng.normal(size=(1500, 8)).astype(np.float32), rng.normal(size=1500).astype(np.float32), 2.0
        )
    q0 = torch.from_numpy(_q0(d, 4096, 6, body_name != "iid_normal")).cuda()
    eps = {"iid_normal": 0.2, "hier_regression_1500x8": 0.005}.get(body_name, 0.02)
    inv_mass = torch.linspace(0.5, 2.0, d)
    kw = dict(n_steps=5, eps=eps, L=5, inv_mass=inv_mass, rng="counter", block_n=128)
    qk, acc = hmc.hmc_sweep(body, q0, 5, **kw)
    assert hmc.hmc_sweep.last_variant == variant
    qt, rate = hmc._reference_hmc(body, q0, 5, **kw)
    close = (qk - qt).abs().amax(dim=0) <= 1e-4
    assert float(close.float().mean()) >= 0.995
    assert abs(float(acc.mean()) / 5 - float(rate)) <= 0.005
    bits, unif, _ = hmc.counter_stream_cuda(-7, 2, 6, (d, 128), q0.device)
    ref = hmc._sw_rand_bits_factory(hmc._block_base(-7, 2))((d, 128), 6).to(q0.device)
    assert torch.equal(bits, ref)
