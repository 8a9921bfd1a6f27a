"""The resamplers (``genjax_tpu_torch/parallel/resampling.py``) against
``genjax_tpu`` on the same inputs.

The ESS to rel 1e-5; systematic and stratified counts from the reference's
own uniforms (``jr.uniform`` of the key it is given, fed to the port's
``_systematic_counts``/``_stratified_counts``): equal on dyadic weights,
and on random log-weights at K = 4,096 apart in at most 0.1% of buckets, by
one copy each (the two float32 cumulative sums round differently), with the
total always ``n``; residual resampling's deterministic copies equal;
``redistribute`` and ``packed_take`` bit for bit on a pytree of float32,
int32, int64, bool and int8 leaves given the same counts or indices, with
``n != k`` too. Every method in law as
``tests/parallel/test_parallel.py::test_all_methods_preserve_distribution``
holds the reference (4,000 draws of 4, frequencies within 0.02).
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import genjax_tpu.parallel.resampling as ref
from genjax_tpu_torch.parallel import resampling as rs
from torch_threads import _one_thread  # noqa: F401


def _lw(seed, k, scale=2.0):
    return (np.random.default_rng(seed).normal(size=k) * scale).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_ess_matches_reference(seed):
    lw = _lw(seed, 257)
    got = float(rs.effective_sample_size(torch.from_numpy(lw)))
    want = float(ref.effective_sample_size(jnp.asarray(lw)))
    assert abs(got - want) <= 1e-5 * abs(want)
    assert float(rs.effective_sample_size(torch.zeros(10))) == pytest.approx(10.0, rel=1e-6)
    degenerate = torch.log(torch.tensor([1.0, 1e-20, 1e-20]))
    assert float(rs.effective_sample_size(degenerate)) == pytest.approx(1.0, abs=1e-3)


def _dyadic(k, seed):
    """Log-weights whose normalised weights are multiples of 2^-12."""
    counts = np.random.default_rng(seed).multinomial(4096, np.ones(k) / k).astype(np.float32) + 1.0
    counts[0] += 4096 * 2 - counts.sum()
    return np.log(counts / counts.sum()).astype(np.float32)


@pytest.mark.parametrize("kind", ["systematic", "stratified"])
@pytest.mark.parametrize("seed", [0, 3])
def test_counts_match_reference_from_the_same_uniforms(kind, seed):
    key = jr.key(seed)
    for lw, n, exact in ((_dyadic(64, seed), 64, True), (_lw(seed, 4096), 4096, False),
                         (_lw(seed + 7, 4096), 3000, False)):
        if kind == "systematic":
            want = np.asarray(ref.systematic_counts(key, jnp.asarray(lw), n))
            got = rs._systematic_counts(torch.tensor(float(jr.uniform(key))), torch.from_numpy(lw), n)
        else:
            want = np.asarray(ref.stratified_counts(key, jnp.asarray(lw), n))
            us = torch.from_numpy(np.array(jr.uniform(key, (n,))))
            got = rs._stratified_counts(us, torch.from_numpy(lw), n)
        got = got.numpy()
        assert got.sum() == n == want.sum() and (got >= 0).all()
        diff = np.abs(got - want.astype(np.int64))
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).sum())


def test_residual_deterministic_copies_match_reference():
    lw = _lw(5, 64, scale=1.0)
    n = 64
    want = np.asarray(ref.residual_indices(jr.key(0), jnp.asarray(lw), n))
    got = rs.residual_indices(torch.Generator().manual_seed(0), torch.from_numpy(lw), n).numpy()
    n_det = int(np.floor(n * np.exp(lw - np.log(np.exp(lw.astype(np.float64)).sum()))).sum())
    assert 0 < n_det < n
    np.testing.assert_array_equal(got[:n_det], want[:n_det])
    assert got.min() >= 0 and got.max() < 64


def _tree(k, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f": rng.normal(size=(k, 3)).astype(np.float32),
        "i": rng.integers(-5, 5, size=(k,)).astype(np.int32),
        "l": rng.integers(-5, 5, size=(k, 2)).astype(np.int64),
        "b": rng.random(size=(k, 2)) < 0.5,
        "s": rng.integers(-100, 100, size=(k,)).astype(np.int8),
    }


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("k,n", [(16, 16), (16, 11), (13, 20)])
def test_row_moves_match_reference_bit_for_bit(k, n):
    tree = _tree(k)
    t_tree = {name: torch.from_numpy(v) for name, v in tree.items()}
    j_tree = {name: jnp.asarray(v) for name, v in tree.items() if name != "l"}
    counts = np.random.default_rng(k + n).multinomial(n, np.ones(k) / k).astype(np.int32)
    idx = np.random.default_rng(n).integers(0, k, size=n).astype(np.int32)
    moved = rs.redistribute(t_tree, torch.from_numpy(counts).long(), n)
    taken = rs.packed_take(t_tree, torch.from_numpy(idx).long(), k)
    ref_moved = ref.redistribute(j_tree, jnp.asarray(counts), n)
    ref_taken = ref.packed_take(j_tree, jnp.asarray(idx), k)
    for name in tree:
        want_m = np.repeat(tree[name], counts, axis=0) if name == "l" else ref_moved[name]
        want_t = tree[name][idx] if name == "l" else ref_taken[name]
        assert moved[name].dtype == t_tree[name].dtype and tuple(moved[name].shape) == (n,) + tree[name].shape[1:]
        np.testing.assert_array_equal(_bits(moved[name].numpy()), _bits(want_m))
        np.testing.assert_array_equal(_bits(taken[name].numpy()), _bits(want_t))


@pytest.mark.parametrize("method", ["systematic", "stratified", "multinomial", "residual"])
def test_all_methods_preserve_distribution(method):
    lw = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    gen = torch.Generator().manual_seed(0)
    idx = torch.cat([rs.resample_indices(gen, lw, 4, method) for _ in range(4000)])
    freqs = torch.bincount(idx, minlength=4).double() / idx.numel()
    assert torch.allclose(freqs, torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64), atol=0.02), freqs
    particles = {"x": torch.arange(4.0)}
    out = rs.resample_particles(gen, particles, lw, 6, method)
    assert tuple(out["x"].shape) == (6,) and set(out["x"].tolist()) <= {0.0, 1.0, 2.0, 3.0}


def test_counts_stay_nonnegative_where_the_cdf_steps_back():
    """The card's parallel cumulative sum can round a CDF down across an
    underflowed weight; the running maximum keeps every count >= 0, the
    total ``n``, and a monotone CDF's counts as they were."""
    stepped = rs._last_bucket(torch.tensor([2, 5, 4, 7, 6]), 8)
    assert stepped.tolist() == [2, 3, 0, 2, 1] and int(stepped.sum()) == 8
    assert rs._last_bucket(torch.tensor([1, 1, 3, 8]), 8).tolist() == [1, 0, 2, 5]
