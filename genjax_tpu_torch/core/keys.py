"""JAX's threefry2x32 PRNG keys, in torch.

The counterpart of ``jax.random``'s default key implementation, with
``jax_threefry_partitionable`` on (JAX's default): the same key words, splits,
fold-ins, bits, uniforms and normals as ``jax.random`` gives for the same
seed, so that a model driven by ``key(0)`` draws what the JAX package draws
from ``jax.random.key(0)``.

A key is an int64 tensor whose last axis holds the key's two 32-bit words,
each in ``[0, 2**32)``; a batch of keys carries leading axes (``split``
returns ``(num, 2)``), and ``torch.func.vmap`` maps over them like any
tensor. The words stay in int64 and every sum and shift is masked back to 32
bits, since torch on the CPU has no shifts of uint32. A key lives on a
device; every function but ``key`` runs where its key lives.

The sources are ``jax/_src/prng.py`` (``threefry_seed``,
``_threefry2x32_lowering``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_uniform``, ``_normal_real`` and the samplers the
distributions reproduce).

>>> k = key(0, device="cpu")
>>> k.tolist()
[0, 0]
>>> split(k, 2).tolist()
[[1797259609, 2579123966], [928981903, 3453687069]]
>>> round(float(normal(k)), 6)
1.622642
"""

from __future__ import annotations

import math
import operator

import torch

from .device import entry_device

#: A key: an int64 tensor of two 32-bit words on its last axis.
PRNGKey = torch.Tensor

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def is_key(x) -> bool:
    """Whether ``x`` is a key: an int64 tensor with a last axis of 2."""
    return isinstance(x, torch.Tensor) and x.dtype == torch.int64 and x.dim() >= 1 and x.shape[-1] == 2


def key(seed, device=None) -> torch.Tensor:
    """The key of an integer seed, as ``jax.random.key(seed)`` makes it under
    JAX's default 32-bit mode: the seed is taken as an int32 (its low 32
    bits), so the high word is 0 and the low word is ``seed mod 2**32``
    (``-3`` gives ``[0, 4294967293]``, ``2**32 + 5`` gives ``[0, 5]``). An
    integer tensor of seeds gives a key for each.

    An entry point: it makes the key on the card unless ``device`` names
    another, and raises naming ``device="cpu"`` where torch sees no card."""
    device = entry_device("cuda" if device is None else device, "key")
    if isinstance(seed, torch.Tensor):
        if seed.is_floating_point() or seed.dtype == torch.bool:
            raise TypeError(f"key: a seed must be an integer, got {seed.dtype}")
        low = seed.to(device=device, dtype=torch.int64) & _M32
    else:
        try:
            low = torch.tensor(operator.index(seed) & _M32, dtype=torch.int64, device=device)
        except TypeError:
            raise TypeError(f"key: a seed must be an integer, got {type(seed).__name__}") from None
    return torch.stack([torch.zeros_like(low), low], dim=-1)


def _check(k, what: str) -> None:
    if not is_key(k):
        raise TypeError(f"{what}: expected a key (an int64 tensor of two words on its last axis), got {_describe(k)}")


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"a {x.dtype} tensor of shape {tuple(x.shape)}"
    return type(x).__name__


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the counter pairs ``(x1, x2)`` under the key
    words ``(k1, k2)``: twenty rounds, a key injection every four, all words
    int64 tensors in ``[0, 2**32)`` that broadcast together."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    a = (x1 + k1) & _M32
    b = (x2 + k2) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = ((b << r) & _M32) | (b >> (32 - r))
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def _shape(shape) -> tuple:
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(n) for n in shape)


def _hash_iota(k: torch.Tensor, shape: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry of the row-major position of each element of ``shape`` (its
    high and low 32-bit words as the counter pair) under each key of ``k``:
    two tensors of shape ``k.shape[:-1] + shape``."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    lead = tuple(k.shape[:-1])
    k1 = k[..., 0].reshape(lead + (1,) * len(shape))
    k2 = k[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k1, k2, i >> 32, i & _M32)


def split(k: torch.Tensor, num=2) -> torch.Tensor:
    """``num`` new keys from ``k`` (``num`` an int or a shape), as
    ``jax.random.split``: shape ``k.shape[:-1] + shape + (2,)``."""
    _check(k, "split")
    b1, b2 = _hash_iota(k, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``k`` with the integer ``data`` (its low 32 bits) folded in, as
    ``jax.random.fold_in``. ``data`` may be an integer tensor that
    broadcasts against the key's batch axes."""
    _check(k, "fold_in")
    if isinstance(data, torch.Tensor):
        d = data.to(device=k.device, dtype=torch.int64) & _M32
    else:
        d = int(data) & _M32
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(k[..., 0]), d + torch.zeros_like(k[..., 1]))
    return torch.stack([b1, b2], dim=-1)


def bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits for each element of ``shape``, as
    ``jax.random.bits(k, shape)`` (uint32 there, int64 in ``[0, 2**32)``
    here): shape ``k.shape[:-1] + shape``."""
    _check(k, "bits")
    b1, b2 = _hash_iota(k, _shape(shape))
    return b1 ^ b2


def uniform(k: torch.Tensor, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0) -> torch.Tensor:
    """Uniforms on ``[minval, maxval)``, as ``jax.random.uniform``: the top
    mantissa bits of the random bits under an exponent of 1, less 1, scaled
    and shifted, and clipped below at ``minval``. Equal to JAX's bit for bit
    in float32 and float64; ``minval`` and ``maxval`` broadcast against
    ``shape``."""
    _check(k, "uniform")
    shape = _shape(shape)
    if dtype == torch.float32:
        m = bits(k, shape) >> 9
        floats = m.to(torch.float32) * (2.0 ** -23)
    elif dtype == torch.float64:
        hi, lo = _hash_iota(k, shape)  # 64 bits an element, high word first
        m = (hi << 20) | (lo >> 12)
        floats = m.to(torch.float64) * (2.0 ** -52)
    else:
        raise TypeError(f"uniform: dtype must be torch.float32 or torch.float64, got {dtype}")
    lo_ = torch.as_tensor(minval, dtype=dtype, device=k.device)
    hi_ = torch.as_tensor(maxval, dtype=dtype, device=k.device)
    return torch.maximum(lo_, _fma(floats, hi_ - lo_, lo_))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` as XLA's fused multiply-add gives it in float32: the
    product of two float32 numbers is exact in float64, so one rounding of
    the sum there stands for the fused one (twice-rounded in rare ties)."""
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).to(torch.float32)


# XLA's float32 inverse error function (Giles' single-precision
# approximation), which ``jax.lax.erf_inv`` lowers to: a polynomial in
# ``w - 2.5`` where ``w = -log1p(-x^2) < 5``, else in ``sqrt(w) - 3``.
_ERFINV_CENTRAL = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_TAIL = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function in float32 as XLA computes it (the
    polynomial ``jax.lax.erf_inv`` lowers to, its steps fused multiply-adds),
    so normals drawn from a key equal JAX's to an ulp or two (``torch.erfinv``
    differs by up to 6e-6 relative); ``erfinv(+-1)`` is ``+-inf``."""
    x = x.to(torch.float32)
    w = -torch.log1p(-x * x)
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(central, _ERFINV_CENTRAL[0], _ERFINV_TAIL[0]).to(torch.float32)
    for c, t in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = _fma(p, w, torch.where(central, c, t).to(torch.float32))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LOW = -0.99999994  # nextafter(-1, 0) in float32


def normal(k: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """Standard normals, as ``jax.random.normal``: ``sqrt(2) erfinv(u)`` with
    ``u`` uniform on ``[nextafter(-1, 0), 1)``."""
    if dtype != torch.float32:
        raise TypeError(f"normal: dtype must be torch.float32, got {dtype}")
    u = uniform(k, shape, dtype, _NORMAL_LOW, 1.0)
    return math.sqrt(2.0) * erfinv(u)
