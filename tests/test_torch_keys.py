"""The port's threefry2x32 keys (``genjax_tpu_torch/core/keys.py``) against
``jax.random``.

Key words, splits, fold-ins, bits and uniforms are equal bit for bit over a
grid of seeds (negative ones and ones of 2**32 and more among them),
shapes, splits and fold-ins; normals agree to rtol 1e-6 (the inverse error
function's polynomial is XLA's, its last ulp not always).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu_torch.core import keys
from torch_threads import _one_thread  # noqa: F401

SEEDS = [0, 1, 42, 2**31 - 1, 2**32 + 5, -3]
SHAPES = [(), (3,), (2, 5)]


def words(jkey) -> np.ndarray:
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


def derived(seed, how):
    """The same key derived in both packages from ``seed``: as made, after a
    split (the last of ``num``), or after a fold-in of ``data``."""
    jk, tk = jax.random.key(seed), keys.key(seed, device="cpu")
    kind, n = how
    if kind == "split":
        return jax.random.split(jk, n)[-1], keys.split(tk, n)[-1]
    if kind == "fold_in":
        return jax.random.fold_in(jk, n), keys.fold_in(tk, n)
    return jk, tk


DERIVATIONS = [("key", 0), ("split", 2), ("split", 3), ("split", 7), ("fold_in", 0), ("fold_in", 1),
               ("fold_in", 1000)]


def test_the_installed_jax_splits_partitionably():
    """The port carries the ``jax_threefry_partitionable=True`` semantics."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words(seed):
    assert np.array_equal(words(jax.random.key(seed)), keys.key(seed, device="cpu").numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_words(seed, num):
    jk, tk = jax.random.key(seed), keys.key(seed, device="cpu")
    assert np.array_equal(words(jax.random.split(jk, num)), keys.split(tk, num).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 1000])
def test_fold_in_words(seed, data):
    jk, tk = jax.random.key(seed), keys.key(seed, device="cpu")
    assert np.array_equal(words(jax.random.fold_in(jk, data)), keys.fold_in(tk, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("how", DERIVATIONS, ids=lambda h: f"{h[0]}{h[1]}")
def test_bits_and_uniforms_bit_for_bit(seed, how):
    jk, tk = derived(seed, how)
    for shape in SHAPES:
        jb = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
        assert np.array_equal(jb, keys.bits(tk, shape).numpy()), shape
        ju = np.asarray(jax.random.uniform(jk, shape))
        tu = keys.uniform(tk, shape).numpy()
        assert ju.dtype == tu.dtype and np.array_equal(ju, tu), shape


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("how", DERIVATIONS, ids=lambda h: f"{h[0]}{h[1]}")
def test_normals_to_rtol_1e_6(seed, how):
    jk, tk = derived(seed, how)
    for shape in SHAPES:
        jn = np.asarray(jax.random.normal(jk, shape))
        np.testing.assert_allclose(keys.normal(tk, shape).numpy(), jn, rtol=1e-6, atol=0)


def test_many_normals_and_the_erfinv_polynomial():
    """Over 2**16 draws the normals hold rtol 1e-6 and nearly all are equal;
    ``torch.erfinv`` alone would miss 1e-6 (up to 6e-6 relative)."""
    jk, tk = jax.random.key(5), keys.key(5, device="cpu")
    jn = np.asarray(jax.random.normal(jk, (2**16,)))
    tn = keys.normal(tk, (2**16,)).numpy()
    np.testing.assert_allclose(tn, jn, rtol=1e-6, atol=0)
    assert np.mean(tn == jn) > 0.95
    u = keys.uniform(tk, (2**16,), minval=keys._NORMAL_LOW, maxval=1.0)
    je = np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy())))
    np.testing.assert_allclose(keys.erfinv(u).numpy(), je, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, -3])
def test_uniform_on_a_range_and_in_float64(seed):
    jk, tk = jax.random.key(seed), keys.key(seed, device="cpu")
    ju = np.asarray(jax.random.uniform(jk, (4096,), minval=-2.0, maxval=3.5))
    assert np.array_equal(ju, keys.uniform(tk, (4096,), minval=-2.0, maxval=3.5).numpy())
    lo = np.asarray([0.0, -1.0, 10.0], np.float32)
    hi = np.asarray([1.0, 2.0, 10.5], np.float32)
    ju = np.asarray(jax.random.uniform(jk, (3,), minval=lo, maxval=hi))
    tu = keys.uniform(tk, (3,), minval=torch.from_numpy(lo), maxval=torch.from_numpy(hi)).numpy()
    assert np.array_equal(ju, tu)
    with jax.enable_x64(True):
        # the same key's words (a seed is made another key in 64-bit mode)
        same = jax.random.wrap_key_data(jnp.asarray(tk.numpy().astype(np.uint32)))
        ju = np.asarray(jax.random.uniform(same, (257,), dtype=jnp.float64))
    assert np.array_equal(ju, keys.uniform(tk, (257,), dtype=torch.float64).numpy())


def test_batched_keys_and_vmap():
    """A batch of keys carries leading axes; ``torch.func.vmap`` maps over
    them as ``jax.vmap`` maps over JAX's keys; a tensor of seeds or of
    fold-in data gives a key each."""
    jks = jax.random.split(jax.random.key(9), 4)
    tks = keys.split(keys.key(9, device="cpu"), 4)
    jn = np.asarray(jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 3), (2,)))(jks))
    tn = torch.func.vmap(lambda k: keys.normal(keys.fold_in(k, 3), (2,)))(tks).numpy()
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    assert np.array_equal(words(jax.vmap(lambda k: jax.random.split(k, 3))(jks)), keys.split(tks, 3).numpy())
    assert np.array_equal(np.asarray(jax.random.bits(jax.random.key(9), (5,))).astype(np.int64),
                          keys.bits(keys.key(9, device="cpu"), 5).numpy())
    data = torch.tensor([0, 1, 1000])
    assert np.array_equal(keys.fold_in(keys.key(9, device="cpu"), data).numpy(),
                          np.stack([words(jax.random.fold_in(jax.random.key(9), int(d))) for d in data]))
    seeds = torch.tensor([0, 7, -3])
    assert np.array_equal(keys.key(seeds, device="cpu").numpy(), np.stack([words(jax.random.key(int(s))) for s in seeds]))


def test_key_is_an_entry_point_on_the_card():
    if torch.cuda.is_available():
        assert keys.key(0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            keys.key(0)
    with pytest.raises(TypeError, match="integer"):
        keys.key(1.5, device="cpu")
    with pytest.raises(TypeError, match="expected a key"):
        keys.split(torch.zeros(2), 2)
    assert keys.is_key(keys.key(0, device="cpu")) and not keys.is_key(torch.Generator())
