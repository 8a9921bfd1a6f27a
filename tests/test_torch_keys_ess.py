"""The elliptical family under a key, draw for draw against ``genjax_tpu``.

- ``ess_transition_cols`` and ``ess_transition_gauss_cols`` under a key, and
  ``ess_sweep_cols`` and ``ess_sweep_gauss_cols`` with an int seed (the
  reference's ``key(seed ^ 0xE5517)``, threefry or ``rng_impl="rbg"``), give
  the reference's chains: at least 99% of chains within 1e-4 of the
  reference's at every collected step, and the transitions' shrink counts
  equal on those chains (seeds 0 and 2**31 - 1, D 8 and 32, N 256, 5 steps).
- The generic and fast paths on the same key give the same chains (1e-4).
- A ``torch.Generator`` in the seed's place is drawn in sequence, as before.
- The routes on the CPU: ``ess_sweep_gauss_cols`` runs its plain version
  there (``last_backend == "torch"``) and never falls back: the kernel's
  route with chains on the CPU raises; the streams' kernels by name.
- ``cuda`` cases (which skip without a card): K3's threefry and rbg kernels
  against their plain version, ``ess_sweep_gauss_cols(backend="torch")``,
  at a tiled and a generic D: at least 99% of chains within 1e-4. JAX is
  imported inside the CPU tests, so these run on a machine without it:
  ``python -m pytest tests/test_torch_keys_ess.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from genjax_tpu_torch.core import keys
from genjax_tpu_torch.kernels import elliptical as E
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-4  # positions, each chain's largest difference over dims and steps
SHARE = 0.99  # of chains within TOL
N = 256
STEPS = 5


def _problem(d, n=N, seed=0):
    rng = np.random.default_rng(100 + d + seed % 7)
    A = rng.normal(size=(d, d))
    chol = np.linalg.cholesky(A @ A.T / d + np.eye(d)).astype(np.float32)
    y = rng.normal(size=d).astype(np.float32)
    q0 = rng.normal(size=(d, n)).astype(np.float32)
    return chol, y, q0


PREC = 4.0


def _ll(y):
    yt = torch.from_numpy(y)[:, None]
    return lambda q: -0.5 * PREC * torch.sum((q - yt) ** 2, dim=0)


def _ll_ref(y):
    import jax.numpy as jnp

    yj = jnp.asarray(y)[:, None]
    return lambda q: -0.5 * PREC * jnp.sum((q - yj) ** 2, axis=0)


def _agree(a, b, n):
    """The chains (columns) within TOL of each other over every other axis."""
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).reshape(-1, n).max(axis=0)
    return err <= TOL


@pytest.mark.parametrize("rng_impl", [None, "rbg"])
@pytest.mark.parametrize("seed", [0, 2**31 - 1])
@pytest.mark.parametrize("d", [8, 32])
def test_sweeps_draw_the_reference_chains(d, seed, rng_impl):
    import jax.numpy as jnp
    from genjax_tpu.kernels import elliptical as R

    chol, y, q0 = _problem(d, seed=seed)
    kw = dict(n_steps=STEPS, chol_prior=chol, collect=True, rng_impl=rng_impl)
    _, draws = E.ess_sweep_gauss_cols(torch.from_numpy(q0), seed, y=y, prec=PREC, **kw)
    assert E.ess_sweep_gauss_cols.last_backend == "torch"
    _, ref = R.ess_sweep_gauss_cols(jnp.asarray(q0), seed, y=y, prec=PREC, **kw)
    assert _agree(draws.numpy(), ref, N).mean() >= SHARE
    _, draws_g = E.ess_sweep_cols(_ll(y), torch.from_numpy(q0), seed, **kw)
    _, ref_g = R.ess_sweep_cols(_ll_ref(y), jnp.asarray(q0), seed, **kw)
    assert _agree(draws_g.numpy(), ref_g, N).mean() >= SHARE


@pytest.mark.parametrize("rng_impl", ["threefry2x32", "rbg"])
@pytest.mark.parametrize("d", [8, 32])
def test_transitions_draw_the_reference_draws(d, rng_impl):
    import jax
    import jax.numpy as jnp
    from genjax_tpu.kernels import elliptical as R

    chol, y, q0 = _problem(d, seed=3)
    k, jk = keys.key(11, device="cpu", impl=rng_impl), jax.random.key(11, impl=rng_impl)
    q1, n1 = E.ess_transition_gauss_cols(torch.from_numpy(q0), k, chol_prior=chol, y=y, prec=PREC)
    rq1, rn1 = R.ess_transition_gauss_cols(jnp.asarray(q0), jk, chol_prior=chol, y=y, prec=PREC)
    ok = _agree(q1.numpy(), rq1, N)
    assert ok.mean() >= SHARE
    np.testing.assert_array_equal(n1.numpy()[ok], np.asarray(rn1)[ok])
    q2, n2 = E.ess_transition_cols(_ll(y), torch.from_numpy(q0), k, chol_prior=chol)
    rq2, rn2 = R.ess_transition_cols(_ll_ref(y), jnp.asarray(q0), jk, chol_prior=chol)
    ok = _agree(q2.numpy(), rq2, N)
    assert ok.mean() >= SHARE
    np.testing.assert_array_equal(n2.numpy()[ok], np.asarray(rn2)[ok])
    assert n1.dtype == torch.int32 and int(n1.max()) > 0


@pytest.mark.parametrize("rng_impl", [None, "rbg"])
def test_generic_and_fast_paths_give_the_same_chains(rng_impl):
    chol, y, q0 = _problem(8, seed=5)
    kw = dict(n_steps=STEPS, chol_prior=chol, collect=True, rng_impl=rng_impl)
    _, fast = E.ess_sweep_gauss_cols(torch.from_numpy(q0), 5, y=y, prec=PREC, **kw)
    _, generic = E.ess_sweep_cols(_ll(y), torch.from_numpy(q0), 5, **kw)
    assert _agree(fast.numpy(), generic.numpy(), N).mean() >= SHARE


def test_a_generator_in_the_seed_place_is_drawn_in_sequence():
    chol, y, q0 = _problem(8, seed=6)
    q, _ = E.ess_sweep_gauss_cols(torch.from_numpy(q0), torch.Generator().manual_seed(4), n_steps=3,
                                  chol_prior=chol, y=y, prec=PREC)
    gen, want = torch.Generator().manual_seed(4), torch.from_numpy(q0)
    for _ in range(3):
        want, _ = E.ess_transition_gauss_cols(want, gen, chol_prior=chol, y=y, prec=PREC)
    assert torch.equal(q, want)
    # a key in the transitions' place is not a generator: the two streams differ
    keyed, _ = E.ess_sweep_gauss_cols(torch.from_numpy(q0), 4, n_steps=3, chol_prior=chol, y=y, prec=PREC)
    assert not torch.equal(keyed, q)


def test_routes_on_the_cpu():
    chol, y, q0 = _problem(8)
    kw = dict(n_steps=1, chol_prior=chol, y=y, prec=PREC)
    E.ess_sweep_gauss_cols.last_backend = None
    E.ess_sweep_gauss_cols(torch.from_numpy(q0), 0, **kw)
    assert E.ess_sweep_gauss_cols.last_backend == "torch"
    E.ess_sweep_gauss_cols(torch.from_numpy(q0), 0, backend="torch", **kw)
    assert E.ess_sweep_gauss_cols.last_backend == "torch"
    # the kernel's route with chains on the CPU raises; nothing falls back
    with pytest.raises(ValueError, match="CUDA tensors"):
        E.ess_sweep_gauss_cols(torch.from_numpy(q0), 0, backend="cuda", **kw)
    with pytest.raises(ValueError, match="backend"):
        E.ess_sweep_gauss_cols(torch.from_numpy(q0), 0, backend="xla", **kw)
    with pytest.raises(ValueError, match="rng_impl"):
        E.ess_sweep_gauss_cols(torch.from_numpy(q0), 0, rng_impl="unsafe_rbg", **kw)
    with pytest.raises(ValueError, match="key is on"):
        E.ess_transition_gauss_cols(torch.from_numpy(q0), keys.key(0, device="meta"), chol_prior=chol, y=y)


@pytest.mark.parametrize("rng, d, kernel", [
    ("philox", 256, "ess_tiled_kernel"), ("counter", 300, "ess_generic_kernel"),
    ("threefry", 16, "ess_tiled_keyed_kernel<threefry>"), ("rbg", 300, "ess_generic_keyed_kernel<rbg>"),
])
def test_each_stream_names_its_kernel(rng, d, kernel):
    assert E.geometry(d, rng)["kernel"] == kernel
    assert {k: v for k, v in E.geometry(d, rng).items() if k != "kernel"} == {
        k: v for k, v in E.geometry(d).items() if k != "kernel"}
    with pytest.raises(ValueError, match="rng must be"):
        E.geometry(d, "xla")


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("rng_impl", [None, "rbg"])
@pytest.mark.parametrize("d, n", [(256, 2048), (300, 512), (16, 1001)])
def test_cuda_keyed_kernel_matches_plain_version(d, n, rng_impl):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chol, y, q0 = _problem(d, n=n)
    kw = dict(n_steps=3, chol_prior=torch.as_tensor(chol).cuda(), y=torch.as_tensor(y).cuda(), prec=PREC,
              rng_impl=rng_impl, collect=True)
    E.ess_gauss_sweep_launches = 0
    _, qk = E.ess_sweep_gauss_cols(torch.as_tensor(q0).cuda(), 9, **kw)
    assert E.ess_sweep_gauss_cols.last_backend == "cuda" and E.ess_gauss_sweep_launches == 3
    assert E.ess_gauss_sweep.last_variant == ("tiled" if d <= 256 else "generic")
    _, qt = E.ess_sweep_gauss_cols(torch.as_tensor(q0).cuda(), 9, backend="torch", **kw)
    assert E.ess_sweep_gauss_cols.last_backend == "torch"
    assert _agree(qk.cpu().numpy(), qt.cpu().numpy(), n).mean() >= SHARE
    with pytest.raises(ValueError, match="backend='torch'"):
        E.ess_sweep_gauss_cols(torch.as_tensor(q0).cuda(), torch.Generator(device="cuda"), **kw)
