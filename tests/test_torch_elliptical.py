"""The port's elliptical slice sampling against the reference's.

- The counter-stream version of K3 (``_reference_ess_gauss(rng="counter")``
  and ``ess_sweep_gauss_pallas(interpret=True)`` on the CPU) reproduces the
  reference's Pallas kernel under ``interpret=True`` draw for draw:
  positions within 1e-5 on at least 99% of chains.
- The default chain block equals the reference's, read from the grid of
  the reference's ``pallas_call``.
- The generic and fast paths, and K3's plain version on its generator
  stream, agree in law with the conjugate closed forms of
  ``tests/kernels/test_elliptical.py`` (at 1024 chains, not 2048).
- The fast path runs the generic path's chain on the same stream.
- Routing: the plain version on the CPU; no fallback for chains on the card.
- The entry point runs on the card by default and places its inputs on
  ``device``; K3's geometry (variant, shared memory, tiles of ``chol``).
- A factor that is not triangular, draw for draw against the reference.

The CUDA kernel is held against its plain version in tests marked ``cuda``,
which skip without a card; JAX is imported inside the tests that compare
with it, so those also run on a machine without JAX:
``python -m pytest tests/test_torch_elliptical.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from genjax_tpu_torch.kernels import elliptical as E
from genjax_tpu_torch.models import gp_posterior, sq_exp_kernel
from torch_threads import _one_thread  # noqa: F401


N_CHAINS = 1024


def _spd(seed, d):
    rng = np.random.RandomState(seed)
    A = rng.randn(d, d)
    return (A @ A.T + d * np.eye(d)).astype(np.float32) / d, rng


def _cols(x, d):
    return torch.as_tensor(np.broadcast_to(np.asarray(x, np.float32).reshape(-1, 1), (d, 1)).copy())


def _counter_case(case):
    """``(q0, kwargs)`` of a counter-stream comparison case."""
    if case == "d3_default_block":
        Sigma, rng = _spd(4, 3)
        kw = dict(chol_prior=np.linalg.cholesky(Sigma), y=rng.randn(3).astype(np.float32), prec=4.0)
        q0 = np.random.default_rng(0).normal(size=(3, 512))
    elif case == "d2_scalar_chol_two_blocks":
        kw = dict(chol_prior=1.0, y=np.asarray([1.0, -1.0], np.float32), prec=2.0, block_n=256)
        q0 = np.random.default_rng(1).normal(size=(2, 512))
    else:  # d8_vector_prec_mean
        Sigma, rng = _spd(6, 8)
        kw = dict(
            chol_prior=np.linalg.cholesky(Sigma), y=rng.randn(8).astype(np.float32),
            prec=np.linspace(0.5, 4.0, 8, dtype=np.float32),
            mean=np.linspace(-1.0, 1.0, 8, dtype=np.float32)[:, None], block_n=128,
        )
        q0 = np.random.default_rng(2).normal(size=(8, 256))
    return q0.astype(np.float32), kw


@pytest.mark.parametrize(
    "case, seed, n_steps",
    [
        ("d3_default_block", 5, 8),
        ("d3_default_block", -3, 5),
        ("d2_scalar_chol_two_blocks", 3, 10),
        ("d8_vector_prec_mean", 11, 6),
    ],
)
def test_counter_version_matches_pallas_interpret_draw_for_draw(case, seed, n_steps):
    import jax.numpy as jnp
    from genjax_tpu.kernels.elliptical import ess_sweep_gauss_pallas as jax_ess_pallas

    q0, kw = _counter_case(case)
    jq = np.asarray(jax_ess_pallas(jnp.asarray(q0), seed, n_steps=n_steps, interpret=True, **kw))
    tq = E.ess_sweep_gauss_pallas(q0, seed, n_steps=n_steps, interpret=True, device="cpu", **kw)
    assert E.ess_sweep_gauss_pallas.last_backend == "torch"
    err = np.abs(tq.numpy() - jq).max(axis=0)
    assert float((err <= 1e-5).mean()) >= 0.99, err.max()
    # the plain version called directly, on normalised inputs, is the same computation
    d, n = q0.shape
    chol = kw["chol_prior"]
    chol = torch.as_tensor(np.asarray(chol, np.float32) if np.ndim(chol) == 2 else float(chol) * np.eye(d, dtype=np.float32))
    rq = E._reference_ess_gauss(
        torch.from_numpy(q0), seed, n_steps=n_steps, chol=chol, y=_cols(kw["y"], d),
        prec=_cols(kw["prec"], d), mean=_cols(kw.get("mean", 0.0), d), rng="counter",
        block_n=kw.get("block_n", E._default_block_n(d, n)),
    )
    assert torch.equal(rq, tq)


@pytest.mark.parametrize("d, n", [(3, 512), (16, 4096), (256, 8192), (40, 1152)])
def test_default_block_matches_reference(d, n, monkeypatch):
    """The reference's chain block, read from the grid of its ``pallas_call``
    (captured, not run)."""
    import types

    import jax.numpy as jnp
    from genjax_tpu.kernels import elliptical as jax_elliptical

    grids = []

    def capture(kernel, *, grid, out_shape, **_kw):
        grids.append(grid)
        return lambda *args: jnp.zeros(out_shape.shape, out_shape.dtype)

    monkeypatch.setattr(
        jax_elliptical, "pl", types.SimpleNamespace(BlockSpec=jax_elliptical.pl.BlockSpec, pallas_call=capture)
    )
    jax_elliptical.ess_sweep_gauss_pallas(
        jnp.zeros((d, n), jnp.float32), 0, n_steps=1, chol_prior=1.0, y=np.zeros(d, np.float32), interpret=True
    )
    assert grids and n // grids[0][0] == E._default_block_n(d, n)
    if (d, n) == (256, 8192):
        assert E._default_block_n(d, n) == 1024


def _ll_cols(y, s2):
    y = torch.as_tensor(np.asarray(y, np.float32))[:, None]
    return lambda q: -0.5 * torch.sum((q - y) ** 2, dim=0) / s2


def test_generic_posterior_moments_exact():
    """prior N(0, Sigma), likelihood N(y | f, s2 I): posterior N(C y / s2, C)
    with C = (Sigma^-1 + I / s2)^-1."""
    Sigma, rng = _spd(0, 3)
    s2 = 0.25
    y = rng.randn(3).astype(np.float32)
    C = np.linalg.inv(np.linalg.inv(Sigma) + np.eye(3) / s2)
    q, _ = E.ess_sweep_cols(
        _ll_cols(y, s2), torch.zeros(3, N_CHAINS), 0, n_steps=200, chol_prior=np.linalg.cholesky(Sigma)
    )
    draws = q.numpy()
    np.testing.assert_allclose(draws.mean(axis=1), C @ y / s2, atol=0.06)
    np.testing.assert_allclose(np.cov(draws), C, atol=0.08)


def test_generic_nonzero_prior_mean():
    mu = np.asarray([2.0, -1.0], np.float32)
    s2 = 0.5
    y = np.asarray([1.0, 0.0], np.float32)
    v = 1.0 / (1.0 + 1.0 / s2)  # prior N(mu, I): posterior N(v (mu + y / s2), v I)
    q0 = torch.as_tensor(np.tile(mu[:, None], (1, N_CHAINS)))
    q, _ = E.ess_sweep_cols(_ll_cols(y, s2), q0, 1, n_steps=150, chol_prior=1.0, mean=mu[:, None])
    draws = q.numpy()
    np.testing.assert_allclose(draws.mean(axis=1), v * (mu + y / s2), atol=0.05)
    np.testing.assert_allclose(draws.var(axis=1), v, rtol=0.12)


def test_generic_stationarity_one_step():
    """Chains started at exact posterior draws keep the posterior's moments
    after one transition (catches bracket and threshold sign errors)."""
    rng = np.random.RandomState(5)
    s2 = 0.3
    Sigma = np.asarray([[1.0, 0.6], [0.6, 1.0]], np.float32)
    y = np.asarray([0.8, -0.4], np.float32)
    C = np.linalg.inv(np.linalg.inv(Sigma) + np.eye(2) / s2)
    m_post = C @ y / s2
    q0 = (np.linalg.cholesky(C) @ rng.randn(2, 4096) + m_post[:, None]).astype(np.float32)
    q1, n_iters = E.ess_transition_cols(
        _ll_cols(y, s2), torch.from_numpy(q0), torch.Generator().manual_seed(7),
        chol_prior=np.linalg.cholesky(Sigma),
    )
    draws = q1.numpy()
    np.testing.assert_allclose(draws.mean(axis=1), m_post, atol=0.05)
    np.testing.assert_allclose(np.cov(draws), C, atol=0.05)
    assert n_iters.dtype == torch.int32 and int(n_iters.min()) >= 0


def test_generic_gp_latents_match_gp_posterior():
    """Latent GP f ~ N(0, K), y = f + noise: the posterior over f at the
    training inputs is the port's ``gp_posterior``."""
    rng = np.random.RandomState(1)
    X = rng.randn(6, 1).astype(np.float32)
    amp, ls, noise = 1.0, 1.2, 0.4
    K = sq_exp_kernel(X, X, amp, ls).double().numpy() + 1e-6 * np.eye(6)
    y = (rng.multivariate_normal(np.zeros(6), K) + noise * rng.randn(6)).astype(np.float32)
    mean_exact, cov_exact = gp_posterior(X, y, X, amp, ls, noise, jitter=1e-6, device="cpu")
    q, _ = E.ess_sweep_cols(
        _ll_cols(y, noise**2), torch.zeros(6, N_CHAINS), 2, n_steps=250, chol_prior=np.linalg.cholesky(K)
    )
    draws = q.numpy()
    np.testing.assert_allclose(draws.mean(axis=1), mean_exact.numpy(), atol=0.08)
    np.testing.assert_allclose(draws.std(axis=1), np.sqrt(np.diag(cov_exact.numpy())), rtol=0.15)


def _gauss_sweep(path, q0, seed, **kw):
    if path == "fast":
        return E.ess_sweep_gauss_cols(q0, seed, **kw)[0]
    return E.ess_sweep_gauss_pallas(q0, seed, device="cpu", **kw)  # K3's plain version, generator stream


@pytest.mark.parametrize("path", ["fast", "k3_plain"])
def test_gauss_posterior_moments_exact(path):
    Sigma, rng = _spd(4, 3)
    s2 = 0.25
    y = rng.randn(3).astype(np.float32)
    C = np.linalg.inv(np.linalg.inv(Sigma) + np.eye(3) / s2)
    q = _gauss_sweep(
        path, torch.zeros(3, N_CHAINS), 0, n_steps=200, chol_prior=np.linalg.cholesky(Sigma), y=y, prec=1.0 / s2
    )
    draws = q.numpy()
    np.testing.assert_allclose(draws.mean(axis=1), C @ y / s2, atol=0.06)
    np.testing.assert_allclose(np.cov(draws), C, atol=0.08)


@pytest.mark.parametrize("path", ["fast", "k3_plain"])
def test_gauss_heteroscedastic_and_nonzero_mean(path):
    """Per-dimension precisions and a nonzero prior mean: prior N(mu, I),
    posterior precision 1 + prec per dimension."""
    mu = np.asarray([1.0, -2.0], np.float32)
    prec = np.asarray([4.0, 0.5], np.float32)
    y = np.asarray([0.0, 1.0], np.float32)
    v = 1.0 / (1.0 + prec)
    q0 = torch.as_tensor(np.tile(mu[:, None], (1, N_CHAINS)))
    q = _gauss_sweep(path, q0, 9, n_steps=150, chol_prior=1.0, y=y, prec=prec, mean=mu[:, None])
    draws = q.numpy()
    np.testing.assert_allclose(draws.mean(axis=1), v * (mu + prec * y), atol=0.05)
    np.testing.assert_allclose(draws.var(axis=1), v, rtol=0.15)


def test_fast_path_runs_the_generic_chain():
    """The same stream and the matching likelihood: the trig-quadratic fast
    path and the generic path make the same accept and shrink decisions up
    to float roundoff, so compare by quantile."""
    Sigma, rng = _spd(3, 4)
    s2 = 0.3
    chol = np.linalg.cholesky(Sigma)
    y = rng.randn(4).astype(np.float32)
    q0 = torch.as_tensor(rng.randn(4, 256).astype(np.float32))
    q_gen, _ = E.ess_sweep_cols(_ll_cols(y, s2), q0, 11, n_steps=30, chol_prior=chol)
    q_fast, _ = E.ess_sweep_gauss_cols(q0, 11, n_steps=30, chol_prior=chol, y=y, prec=1.0 / s2)
    diff = (q_gen - q_fast).abs().numpy()
    assert np.quantile(diff, 0.98) < 1e-3, np.quantile(diff, 0.98)


def test_collect_returns_every_transition():
    q0 = torch.zeros(2, 64)
    kw = dict(n_steps=4, chol_prior=1.0, y=np.ones(2, np.float32), prec=2.0)
    q, draws = E.ess_sweep_gauss_cols(q0, 2, collect=True, **kw)
    q2, none = E.ess_sweep_gauss_cols(q0, 2, **kw)
    assert tuple(draws.shape) == (4, 2, 64) and none is None
    assert torch.equal(draws[-1], q) and torch.equal(q, q2)


def test_max_iters_zero_is_a_no_op_for_chains_not_accepted_at_once():
    """``max_iters=0``: no shrink iteration runs; a chain whose first
    proposal fails keeps its point exactly, in the generic path and in K3's
    counter version, which still matches the reference's kernel."""
    import jax.numpy as jnp
    from genjax_tpu.kernels.elliptical import ess_sweep_gauss_pallas as jax_ess_pallas

    q0 = torch.full((2, 128), 0.05)
    q1, n_iters = E.ess_transition_cols(
        lambda q: -50.0 * torch.sum(q**2, dim=0), q0, torch.Generator().manual_seed(0),
        chol_prior=1.0, max_iters=0,
    )
    assert bool((n_iters == 0).all()) and bool(torch.isfinite(q1).all())
    kept = (q1 == q0).all(dim=0)
    assert 0 < int(kept.sum()) < 128

    kw = dict(n_steps=1, chol_prior=1.0, y=np.zeros(2, np.float32), prec=100.0, max_iters=0, block_n=128)
    tq = E.ess_sweep_gauss_pallas(q0, 4, interpret=True, device="cpu", **kw)
    jq = np.asarray(jax_ess_pallas(jnp.asarray(q0.numpy()), 4, interpret=True, **kw))
    np.testing.assert_allclose(tq.numpy(), jq, atol=1e-6)
    kept = (tq == q0).all(dim=0)
    assert 0 < int(kept.sum()) < 128


def test_routing_on_the_cpu():
    q0 = torch.zeros(2, 256)
    kw = dict(n_steps=1, chol_prior=1.0, y=np.zeros(2, np.float32), device="cpu")
    E.ess_sweep_gauss_pallas(q0, 0, **kw)
    assert E.ess_sweep_gauss_pallas.last_backend == "torch"
    # a request for the card with chains on the CPU raises, never falls back
    with pytest.raises(ValueError, match="CUDA"):
        E.ess_sweep_gauss_pallas(q0, 0, backend="cuda", **kw)
    with pytest.raises(ValueError, match="CUDA"):
        E.ess_gauss_sweep(q0, 0, n_steps=1, chol=torch.eye(2), y=0.0, prec=1.0, mean=0.0)
    with pytest.raises(ValueError, match="divisible"):
        E.ess_sweep_gauss_pallas(q0, 0, block_n=100, **kw)
    with pytest.raises(ValueError, match="backend"):
        E.ess_sweep_gauss_pallas(q0, 0, backend="xla", **kw)
    with pytest.raises(ValueError, match="block_n"):
        E._reference_ess_gauss(
            q0, 0, n_steps=1, chol=torch.eye(2), y=torch.zeros(2, 1), prec=torch.ones(2, 1),
            mean=torch.zeros(2, 1), rng="counter",
        )


def test_default_device_is_the_card(monkeypatch):
    """Without a card the default ``device`` raises, naming ``device='cpu'``,
    and runs nothing on the CPU; ``device="cpu"`` runs the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(n_steps=1, chol_prior=1.0, y=np.zeros(2, np.float32))
    E.ess_sweep_gauss_pallas.last_backend = None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.ess_sweep_gauss_pallas(torch.zeros(2, 128), 0, **kw)
    assert E.ess_sweep_gauss_pallas.last_backend is None
    q = E.ess_sweep_gauss_pallas(torch.zeros(2, 128), 0, device="cpu", **kw)
    assert q.device.type == "cpu" and E.ess_sweep_gauss_pallas.last_backend == "torch"


def test_numpy_inputs_follow_device():
    """A numpy ``q0``, ``chol_prior``, ``y``, ``prec`` and ``mean`` are placed
    on ``device``, and give what the same values as tensors give."""
    q0, kw = _counter_case("d8_vector_prec_mean")
    q_np = E.ess_sweep_gauss_pallas(q0, 3, n_steps=2, interpret=True, device="cpu", **kw)
    kw_t = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    q_t = E.ess_sweep_gauss_pallas(torch.from_numpy(q0), 3, n_steps=2, interpret=True, device="cpu", **kw_t)
    assert q_np.device.type == "cpu" and torch.equal(q_np, q_t)


# (variant, shared memory a block in bytes, tiles of chol, threads), from the kernel's
# constants: 64 chains a block; tiled: two ring stages of 16 x 32 tiles of
# chol (rows padded to 16) and 1 KiB for their alignment, q D x 64, z rows
# padded to 32 at 72 floats; generic: q and nu D x 64, a 16 x 260 chol
# slab, a 16 x 64 z slab; both: partial sums 4 x 5 x 64, three angles a
# chain, prec / mean / r0
@pytest.mark.parametrize(
    "d, expected",
    [
        (3, ("tiled", 21028, 1, 288)),
        (16, ("tiled", 24512, 1, 288)),
        (250, ("tiled", 213176, 128, 288)),
        (256, ("tiled", 214784, 128, 288)),
        (300, ("generic", 183824, 0, 256)),
    ],
)
def test_geometry(d, expected):
    geo = E.geometry(d)
    assert (geo["variant"], geo["smem_bytes"], geo["tiles"], geo["threads"]) == expected
    assert geo["smem_bytes"] <= 232448  # an H100's shared memory a block


@pytest.mark.parametrize("seed", [4, -9])
def test_full_factor_counter_version_matches_pallas_interpret(seed):
    """A factor that is not triangular (the symmetric square root of an SPD
    matrix): the plain version against the reference's Pallas kernel in
    interpret mode, draw for draw on the counter stream."""
    import jax.numpy as jnp
    from genjax_tpu.kernels.elliptical import ess_sweep_gauss_pallas as jax_ess_pallas

    Sigma, rng = _spd(8, 12)
    w, V = np.linalg.eigh(Sigma.astype(np.float64))
    root = ((V * np.sqrt(w)) @ V.T).astype(np.float32)
    assert np.abs(np.triu(root, 1)).max() > 1e-2  # not triangular
    kw = dict(chol_prior=root, y=rng.randn(12).astype(np.float32), prec=3.0, block_n=128)
    q0 = np.random.default_rng(3).normal(size=(12, 256)).astype(np.float32)
    jq = np.asarray(jax_ess_pallas(jnp.asarray(q0), seed, n_steps=6, interpret=True, **kw))
    tq = E.ess_sweep_gauss_pallas(q0, seed, n_steps=6, interpret=True, device="cpu", **kw)
    err = np.abs(tq.numpy() - jq).max(axis=0)
    assert float((err <= 1e-5).mean()) >= 0.99, err.max()


def _kernel_case(d, factor):
    """``(chol, y, prec, mean)`` on the card: a lower Cholesky factor or the
    symmetric square root of a random SPD matrix."""
    rng = np.random.default_rng(d)
    A = rng.normal(size=(d, d))
    S = A @ A.T / d + np.eye(d)
    if factor == "lower":
        chol = np.linalg.cholesky(S)
    else:
        w, V = np.linalg.eigh(S)
        chol = (V * np.sqrt(w)) @ V.T
    chol = torch.as_tensor(chol.astype(np.float32)).cuda()
    y, prec, mean = (torch.as_tensor(rng.normal(size=(d, 1)).astype(np.float32)).cuda() for _ in range(3))
    return chol, y, prec.abs() + 0.5, mean


@pytest.mark.cuda
@pytest.mark.parametrize(
    "d, n, block_n, factor",
    [
        (3, 512, 512, "lower"),
        (16, 4096, 128, "lower"),
        (300, 256, 128, "lower"),
        (256, 2048, 1024, "lower"),
        (256, 2048, 1024, "full"),
        (250, 2048, 1024, "lower"),
    ],
)
def test_cuda_kernel_matches_plain_version(d, n, block_n, factor):
    """K3 against its plain version on the counter stream, 5 steps: at least
    99% of chains within 1e-4 (f32 sums over D in another order can flip a
    borderline shrink decision). D <= 256 takes the tiled variant (a full
    factor shows that the tile skip skips only zeros; D = 250 is not a
    multiple of a tile), D = 300 the generic one with two row chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chol, y, prec, mean = _kernel_case(d, factor)
    q0 = torch.as_tensor(np.random.default_rng(d + 1).normal(size=(d, n)).astype(np.float32)).cuda()
    kw = dict(n_steps=5, chol=chol, y=y, prec=prec, mean=mean, max_iters=24, block_n=block_n)
    qk = E.ess_gauss_sweep(q0, 7, rng="counter", **kw)
    assert E.ess_gauss_sweep.last_variant == E.geometry(d)["variant"] == ("generic" if d > 256 else "tiled")
    qt = E._reference_ess_gauss(q0, 7, rng="counter", **kw)
    close = (qk - qt).abs().amax(dim=0) <= 1e-4
    assert float(close.float().mean()) >= 0.99
    qp = E.ess_gauss_sweep(q0, 7, **kw)
    assert bool(torch.isfinite(qp).all()) and torch.equal(qp, E.ess_gauss_sweep(q0, 7, **kw))
    with pytest.raises(ValueError, match="shared memory"):
        E.ess_gauss_sweep(torch.zeros(1024, 64, device="cuda"), 0, n_steps=1,
                          chol=torch.eye(1024, device="cuda"), y=0.0, prec=1.0, mean=0.0)


@pytest.mark.cuda
def test_cuda_geometry_and_default_device():
    """The kernel's own reckoning of its geometry equals the wrapper's, and
    numpy inputs go to the card by default and launch K3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for d in (3, 16, 250, 256, 300):
        assert E.geometry_cuda(d) == E.geometry(d)
    q0, kw = _counter_case("d8_vector_prec_mean")
    launches = E.ess_gauss_sweep_launches
    q = E.ess_sweep_gauss_pallas(q0, 3, n_steps=2, **kw)
    assert q.is_cuda and E.ess_sweep_gauss_pallas.last_backend == "cuda"
    assert E.ess_gauss_sweep_launches == launches + 1
