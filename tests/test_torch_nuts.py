"""The port's NUTS sweep against the reference's.

- The counter-stream twin reproduces the reference's Pallas NUTS kernel
  under ``interpret=True`` draw for draw (the same salts, the same per-block
  exits): positions within 1e-5 on at least 99% of chains, equal mean
  leapfrog counts, accept statistics within 1e-6.
- The generator twin agrees in law with the reference's XLA twin
  ``nuts_sweep_cols`` on the anisotropic target of
  ``tests/kernels/test_nuts_pallas.py``.
- ``column_nuts(warmup=True)`` reaches the conjugate posterior, and its
  adapted step size is within 25% of the reference warmup's.
- Routing: the twin on the CPU; no silent fallback for chains on the card.

The CUDA kernel is held against the twin in tests marked ``cuda``, which
skip without a card; JAX is imported inside the tests that compare with it,
so those also run on a machine without JAX:
``python -m pytest tests/test_torch_nuts.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from genjax_tpu_torch.kernels import bodies, nuts, nuts_pallas
from torch_threads import _one_thread  # noqa: F401


SCALES = np.geomspace(0.3, 3.0, 8).astype(np.float32)


def _q0(d, n, seed, tau_row):
    rng = np.random.default_rng(seed)
    q0 = (0.3 * rng.normal(size=(d, n))).astype(np.float32)
    if tau_row:
        q0[0] = rng.uniform(0.5, 1.5, size=n)
    return q0


def _aniso_torch(q):
    return -0.5 * torch.sum((q / torch.from_numpy(SCALES)[:, None]) ** 2, dim=0)


def _aniso_jax():
    import jax.numpy as jnp

    return lambda q: -0.5 * jnp.sum((q / jnp.asarray(SCALES)[:, None]) ** 2, axis=0)


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


# The flagship's seeds are ones whose 3-transition trajectories stay inside
# float32 agreement: its funnel in tau amplifies the last-bit differences of
# the two frameworks, and other seeds leave 1-2% of chains beyond 1e-5 (the
# leapfrog counts still agree).
@pytest.mark.parametrize(
    "case, seed",
    [
        ("iid_normal", 3),
        ("iid_normal", -7),
        ("anisotropic_inv_mass", 5),
        ("flagship", -11),
        ("flagship", 1),
    ],
)
def test_counter_twin_matches_pallas_interpret_draw_for_draw(case, seed):
    import jax.numpy as jnp
    from genjax_tpu.kernels.nuts_pallas import pallas_nuts as jax_pallas_nuts

    inv_mass = None
    if case == "iid_normal":
        jld = lambda q: -0.5 * jnp.sum(q * q, axis=0)  # noqa: E731
        tld, q0, eps = bodies.iid_normal(), _q0(8, 256, 0, False), 0.4
    elif case == "anisotropic_inv_mass":
        jld, tld, eps = _aniso_jax(), _aniso_torch, 0.3
        q0 = 3.0 * _q0(8, 256, 1, False)
        inv_mass = SCALES**2
    else:
        (jld, flagship), q0, eps = _flagship_densities(), _q0(16, 256, 2, True), 0.05
        tld = flagship.body
    kw = dict(n_steps=3, eps=eps, max_depth=5, inv_mass=inv_mass, block_n=128)
    jq, jacc, jleaps = jax_pallas_nuts(jld, jnp.asarray(q0), seed, interpret=True, **kw)
    tq, tacc, tleaps = nuts.nuts_sweep_cols(tld, torch.from_numpy(q0), seed, rng="counter", **kw)
    err = np.abs(tq.numpy() - np.asarray(jq)).max(axis=0)
    assert float((err <= 1e-5).mean()) >= 0.99, err.max()
    assert float(tleaps) == float(jleaps)
    assert abs(float(tacc) - float(jacc)) <= 1e-6
    # the twin through pallas_nuts's routing is the same computation
    rq, racc, rleaps = nuts_pallas.pallas_nuts(tld, torch.from_numpy(q0), seed, interpret=True, **kw)
    assert nuts_pallas.pallas_nuts.last_backend == "torch"
    assert torch.equal(rq, tq) and float(racc) == float(tacc) and float(rleaps) == float(tleaps)


def test_counter_twin_salts_are_per_block():
    """Two chain blocks see different salts once their exits differ: the
    first block's chains must not depend on the second's."""
    q0 = _q0(8, 256, 0, False)
    both, _, _ = nuts.nuts_sweep_cols(
        bodies.iid_normal(), torch.from_numpy(q0), 3, n_steps=3, eps=0.4, max_depth=5,
        rng="counter", block_n=128,
    )
    first, _, _ = nuts.nuts_sweep_cols(
        bodies.iid_normal(), torch.from_numpy(q0[:, :128].copy()), 3, n_steps=3, eps=0.4,
        max_depth=5, rng="counter", block_n=128,
    )
    assert torch.equal(both[:, :128], first)


def test_generator_twin_agrees_in_law_with_reference_anisotropic():
    """``test_nuts_pallas.py::test_agrees_with_xla_twin_anisotropic``'s
    target: accept statistics within 0.05, mean leapfrogs within 15%, and
    per-dimension sd within 15% of the truth for both."""
    import jax.numpy as jnp
    from genjax_tpu.kernels.nuts import nuts_sweep_cols as jax_nuts_sweep_cols

    d, n = 8, 512
    q0 = (np.random.default_rng(1).normal(size=(d, n)) * SCALES[:, None]).astype(np.float32)
    kw = dict(n_steps=50, eps=0.25, max_depth=7)
    jq, jacc, jleaps = jax_nuts_sweep_cols(
        _aniso_jax(), jnp.asarray(q0), 3, rng_impl="threefry2x32", **kw
    )
    tq, tacc, tleaps = nuts.nuts_sweep_cols(_aniso_torch, torch.from_numpy(q0), 3, **kw)
    assert abs(float(tacc) - float(jacc)) < 0.05
    assert abs(float(tleaps) - float(jleaps)) / float(jleaps) < 0.15
    np.testing.assert_allclose(tq.numpy().std(axis=1) / SCALES, np.ones(d), rtol=0.15)
    np.testing.assert_allclose(np.asarray(jq).std(axis=1) / SCALES, np.ones(d), rtol=0.15)


def test_collect_returns_every_transition():
    q0 = torch.from_numpy(_q0(8, 128, 4, False))
    q, acc, leaps, draws, div = nuts.nuts_sweep_cols(
        bodies.iid_normal(), q0, 2, n_steps=4, eps=0.4, max_depth=4, collect=True
    )
    q2, acc2, leaps2 = nuts.nuts_sweep_cols(bodies.iid_normal(), q0, 2, n_steps=4, eps=0.4, max_depth=4)
    assert tuple(draws.shape) == (4, 8, 128)
    assert torch.equal(draws[-1], q) and torch.equal(q, q2)
    assert float(acc) == float(acc2) and float(leaps) == float(leaps2)
    assert float(div) == 0.0


def test_divergent_trajectories_are_flagged_not_nan():
    """An eps far too large diverges: positions stay finite, the divergence
    rate is high, and every transition stops at its first doubling."""
    q0 = torch.from_numpy(_q0(16, 128, 5, True))
    _, flagship = _flagship_densities()
    q, acc, leaps, _, div = nuts.nuts_sweep_cols(
        flagship.body, q0, 0, n_steps=2, eps=5.0, max_depth=5, collect=True
    )
    assert bool(torch.isfinite(q).all()) and bool((q[0] > 0).all())
    assert float(div) > 0.5 and 0.0 <= float(acc) < 0.5 and float(leaps) == 1.0


def _normal_model():
    import genjax_tpu_torch as g

    @g.gen
    def model():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 1.0) @ "y"

    return model


def test_column_nuts_warmup_reaches_the_conjugate_posterior():
    """mu ~ N(0, 1), y ~ N(mu, 1), y = 2: the posterior is N(1, 1/2)."""
    import genjax_tpu_torch as g
    from genjax_tpu_torch.kernels import column_nuts

    n = 512
    q, acc, leaps, packer = column_nuts(
        _normal_model(), g.C["y"].set(2.0), (), ["mu"], n_chains=n, n_steps=10, eps=0.1,
        max_depth=6, seed=3, warmup=True, device="cpu",
    )
    assert nuts_pallas.pallas_nuts.last_backend == "torch"
    assert tuple(q.shape) == (8, n) and packer.dim == 1
    se = (0.5 / n) ** 0.5
    assert abs(float(q[0].mean()) - 1.0) < 4 * se
    assert abs(float(q[0].var()) - 0.5) < 0.15
    assert 0.5 < float(acc) <= 1.0 and float(leaps) >= 1.0


def test_warmup_eps_matches_reference():
    """The adapted step size within 25% of the reference warmup's, from the
    same positions; the adapted inverse mass of the real dimension near the
    posterior variance 1/2 for both."""
    import genjax_tpu as gj
    import jax.numpy as jnp
    from genjax_tpu.kernels import ColumnPacker as JP
    from genjax_tpu.kernels import column_logdensity as jcl
    from genjax_tpu.kernels.nuts import warmup_column_nuts as jax_warmup

    import genjax_tpu_torch as g
    from genjax_tpu_torch.kernels import ColumnPacker, column_logdensity

    @gj.gen
    def jmodel():
        mu = gj.normal(0.0, 1.0) @ "mu"
        _ = gj.normal(mu, 1.0) @ "y"

    tmodel = _normal_model()
    jobs, tobs = gj.C["y"].set(2.0), g.C["y"].set(2.0)
    jld = jcl(jmodel, jobs, (), JP(jmodel, jobs, (), ["mu"]))
    tld = column_logdensity(tmodel, tobs, (), ColumnPacker(tmodel, tobs, (), ["mu"]))
    q0 = np.random.default_rng(7).normal(size=(8, 512)).astype(np.float32)
    _, jeps, jim = jax_warmup(jld, jnp.asarray(q0), 4, eps0=0.1, max_depth=6)
    _, teps, tim = nuts_pallas.warmup_column_nuts(tld, torch.from_numpy(q0), 4, eps0=0.1, max_depth=6)
    assert abs(teps - jeps) / jeps < 0.25, (teps, jeps)
    assert abs(float(tim[0]) - 0.5) < 0.15 and abs(float(jim[0]) - 0.5) < 0.15


def test_routing_on_the_cpu():
    q0 = torch.zeros(8, 128)
    nuts_pallas.pallas_nuts(bodies.iid_normal(), q0, 0, n_steps=1, eps=0.1, max_depth=2)
    assert nuts_pallas.pallas_nuts.last_backend == "torch"
    # a request for the card never falls back: a density without a
    # hand-written body is staged (and the kernel then refuses a CPU tensor),
    # one that cannot be staged raises
    with pytest.raises(ValueError, match="CUDA"):
        nuts_pallas.pallas_nuts(_aniso_torch, q0, 0, n_steps=1, eps=0.1, backend="cuda")
    with pytest.raises(ValueError, match="aten.sort.*backend='torch'"):
        nuts_pallas.pallas_nuts(lambda q: torch.sort(q, dim=0).values[0], q0, 0, n_steps=1, eps=0.1,
                                backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        nuts_pallas.pallas_nuts(bodies.iid_normal(), q0, 0, n_steps=1, eps=0.1, backend="cuda")
    with pytest.raises(ValueError, match="block_n"):
        nuts_pallas.pallas_nuts(bodies.iid_normal(), q0, 0, n_steps=1, eps=0.1, interpret=True)
    with pytest.raises(ValueError, match="multiple"):
        nuts.nuts_sweep_cols(bodies.iid_normal(), q0, 0, n_steps=1, eps=0.1, rng="counter", block_n=100)


def _flagship_body():
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return bodies.hier_regression(X, y, 0.25)


def test_shared_memory_budget():
    """The flagship's default K4 block: X and y are kernel parameters, so
    only the two (max_depth, D, 32) stacks; six such blocks fit the 228 KiB
    of shared memory of an H100 SM."""
    smem = nuts_pallas.smem_bytes(_flagship_body(), 16, 8, nuts_pallas.DEFAULT_BLOCK)
    assert smem == 4 * 2 * 8 * 16 * 32
    assert 6 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize(
    "shape, d, depth, block, variant, consts_floats",
    [
        ((16, 8), 16, 8, 32, "specialised", 0),  # the flagship: X, y as kernel parameters
        ((5, 3), 8, 6, 128, "generic", 20),  # 5 x 4 floats
        ((1500, 8), 16, 4, 32, "generic", 13500),  # X as compact as in device memory
        (None, 8, 6, 128, "specialised", 0),  # iid_normal: no constants
    ],
)
def test_geometry(shape, d, depth, block, variant, consts_floats):
    """K4's geometry helpers: the body's variant, the shared memory of a
    block (the generic variant's constants first, rounded up to a float4),
    and the block sizes the kernel takes."""
    if shape is None:
        body = bodies.iid_normal()
    else:
        rng = np.random.default_rng(0)
        body = bodies.hier_regression(
            rng.normal(size=shape).astype(np.float32), rng.normal(size=shape[0]).astype(np.float32), 0.25
        )
    assert body.variant(d) == variant
    assert body.shared_consts_floats(d) == consts_floats
    smem = nuts_pallas.smem_bytes(body, d, depth, block)
    assert smem == 4 * (consts_floats + 2 * depth * d * block)
    assert block <= nuts_pallas.MAX_BLOCK == 256
    assert nuts_pallas.DEFAULT_BLOCK == 32


@pytest.mark.cuda
@pytest.mark.parametrize("density", ["stageable", "unstageable"])
def test_column_nuts_on_the_card_without_a_body_raises(density):
    """A model with no hand-written body runs K4 with its staged body under
    the default backend; one whose density cannot be staged raises, and
    ``backend="torch"`` runs the twin on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import genjax_tpu_torch as g
    from genjax_tpu_torch.kernels import column_nuts

    @g.gen
    def cumulative():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(torch.cumsum(mu * torch.ones(3, device=mu.device), dim=0)[-1], 1.0) @ "y"

    kw = dict(n_chains=256, n_steps=2, eps=0.5, max_depth=3, device="cuda")
    if density == "stageable":
        q, _, _, _ = column_nuts(_normal_model(), g.C["y"].set(2.0), (), ["mu"], **kw)
        assert nuts_pallas.pallas_nuts.last_backend == "cuda" and nuts_pallas.pallas_nuts.last_body == "staged"
        return
    with pytest.raises(ValueError, match="backend='torch'"):
        column_nuts(cumulative, g.C["y"].set(2.0), (), ["mu"], **kw)
    q, _, _, _ = column_nuts(cumulative, g.C["y"].set(2.0), (), ["mu"], backend="torch", **kw)
    assert nuts_pallas.pallas_nuts.last_backend == "torch" and q.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize(
    "body_name, d",
    [("iid_normal", 8), ("hier_regression", 16), ("hier_regression_5x3", 8)],
)
def test_cuda_kernel_matches_plain_twin(body_name, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if body_name == "iid_normal":
        body = bodies.iid_normal()
    elif body_name == "hier_regression":
        body = _flagship_body()
    else:
        rng = np.random.default_rng(53)
        body = bodies.hier_regression(
            rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=5).astype(np.float32), 0.25
        )
    q0 = torch.from_numpy(_q0(d, 4096, 6, body_name != "iid_normal")).cuda()
    eps = 0.4 if body_name == "iid_normal" else 0.05
    inv_mass = torch.linspace(0.5, 2.0, d)
    kw = dict(n_steps=3, eps=eps, max_depth=6, inv_mass=inv_mass, rng="counter", block_n=128)
    qk, acc, leaps = nuts_pallas.nuts_sweep(body, q0, 5, **kw)
    assert nuts_pallas.nuts_sweep.last_variant == body.variant(d)
    qt, rate, mean_leaps = nuts.nuts_sweep_cols(body, q0, 5, **kw)
    close = (qk - qt).abs().amax(dim=0) <= 1e-4
    assert float(close.float().mean()) >= 0.99
    assert abs(float(acc.mean()) / 3 - float(rate)) <= 0.005
    assert abs(float(leaps.mean()) / 3 - float(mean_leaps)) <= 0.01 * float(mean_leaps)
    with pytest.raises(ValueError, match="shared memory"):
        nuts_pallas.nuts_sweep(body, q0, 5, n_steps=1, eps=eps, max_depth=30, block_n=128)
