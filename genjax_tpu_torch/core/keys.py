"""JAX's PRNG keys, in torch: threefry2x32 and rbg.

The counterpart of ``jax.random``'s two key implementations, with
``jax_threefry_partitionable`` on (JAX's default): the same key words, splits,
fold-ins, bits, uniforms, normals, integers and coin flips as ``jax.random``
gives for the same seed, and its gamma draws and the samplers built on them
alone (``gamma``, ``loggamma``, ``beta``, ``dirichlet``, ``chisquare``,
``t``), so that a model driven by ``key(0)`` draws what the JAX package
draws from ``jax.random.key(0)``. Gumbel noise, categorical draws, draws
of an index with replacement and geometric draws come with them
(``gumbel``, ``categorical``, ``choice``, ``geometric``).

A key is an int64 tensor whose last axis holds the key's 32-bit words, each in
``[0, 2**32)``: two for threefry2x32 (JAX's default), four for rbg; a batch of
keys carries leading axes (``split`` returns ``(num, 2)`` or ``(num, 4)``),
and ``torch.func.vmap`` maps over them like any tensor. The words stay in
int64 and every sum, product and shift is masked back to 32 bits, since torch
on the CPU has no shifts of uint32. A key lives on a device; every function
but ``key`` runs where its key lives.

An rbg key is two threefry keys side by side: ``key``, ``split`` and
``fold_in`` apply threefry to each half, so a key made by them has equal
halves. Its bits are XLA's ``RngBitGenerator`` as JAX's CPU backend runs it,
Philox4x32-10: for key words ``(w0, w1, w2, w3)`` the Philox key is ``(w0,
w1)``, block ``b`` is counted at ``(w2 + b, w3 + carry, w0, w1)`` (a 64-bit
add over the two low words), and its four words are the row-major elements
``4b .. 4b + 3`` of the draw. (On a TPU, rbg is the chip's own generator,
which this does not reproduce.)

The sources are ``jax/_src/prng.py`` (``threefry_seed``,
``_threefry2x32_lowering``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``, ``_rbg_seed``,
``_rbg_split``, ``_rbg_fold_in``, ``_rbg_random_bits``) and
``jax/_src/random.py`` (``_uniform``, ``_normal_real``, ``_randint``,
``_bernoulli``, ``_gumbel``, ``categorical``, ``choice``, ``_geometric``, ``_gamma_one``, ``_gamma_impl``, ``_beta``, ``_dirichlet``,
``_chisquare``, ``_t`` and the samplers the distributions reproduce).

>>> k = key(0, device="cpu")
>>> k.tolist()
[0, 0]
>>> split(k, 2).tolist()
[[1797259609, 2579123966], [928981903, 3453687069]]
>>> round(float(normal(k)), 6)
1.622642
>>> key(0, device="cpu", impl="rbg").tolist()
[0, 0, 0, 0]
>>> int(randint(k, (), 0, 2**30))
31327077
"""

from __future__ import annotations

import functools
import math
import operator

import torch

from .device import chain_generator, entry_device, is_key, same_device

#: A key: an int64 tensor of two (threefry2x32) or four (rbg) 32-bit words
#: on its last axis.
PRNGKey = torch.Tensor

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_IMPLS = {"threefry2x32": 2, "rbg": 4}
# Philox4x32-10's multipliers and key increments
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def key(seed, device=None, impl: str = "threefry2x32") -> torch.Tensor:
    """The key of an integer seed, as ``jax.random.key(seed, impl=impl)``
    makes it under JAX's default 32-bit mode: the seed is taken as an int32
    (its low 32 bits), so the high word is 0 and the low word is ``seed mod
    2**32`` (``-3`` gives ``[0, 4294967293]``, ``2**32 + 5`` gives ``[0,
    5]``); an rbg key holds that pair twice. An integer tensor of seeds gives
    a key for each.

    An entry point: it makes the key on the card unless ``device`` names
    another, and raises naming ``device="cpu"`` where torch sees no card."""
    if impl not in _IMPLS:
        raise ValueError(f"key: impl must be one of {sorted(_IMPLS)}, got {impl!r}")
    device = entry_device("cuda" if device is None else device, "key")
    if isinstance(seed, torch.Tensor):
        if seed.is_floating_point() or seed.dtype == torch.bool:
            raise TypeError(f"key: a seed must be an integer, got {seed.dtype}")
        low = seed.to(device=device, dtype=torch.int64) & _M32
    else:
        try:
            low = _on(operator.index(seed) & _M32, torch.int64, device)
        except TypeError:
            raise TypeError(f"key: a seed must be an integer, got {type(seed).__name__}") from None
    half = [torch.zeros_like(low), low]
    return torch.stack(half * (_IMPLS[impl] // 2), dim=-1)


def entry_stream(seed, device, entry: str):
    """The device of an entry point that makes its particles or chains
    (``entry_device``) and its stream there: a key, placed on that device,
    or the generator ``chain_generator`` gives for a ``torch.Generator`` or
    an int seed."""
    device = entry_device(device, entry)
    if is_key(seed):
        return seed.to(device), device
    return chain_generator(seed, device, entry), device


def sampler_stream(seed, device, entry: str, impl: str = "rbg"):
    """The stream a column sampler draws from on ``device``, as the
    reference's samplers read their ``seed``: a key is used as it is, and an
    integer is ``key(seed, impl=impl)`` (``impl`` the sampler's
    ``rng_impl``); a ``torch.Generator`` in the seed's place is returned
    as it is, to be drawn from in sequence. A key or a generator on another
    device raises a ``ValueError`` naming ``entry``."""
    if isinstance(seed, torch.Generator):
        return chain_generator(seed, device, entry)
    if is_key(seed):
        if not same_device(seed.device, torch.device(device)):
            raise ValueError(f"{entry}: the key lives on {seed.device} and the chains on {device}")
        return seed
    return key(seed, device=device, impl=impl)


def split_stream(stream, num: int = 2) -> tuple:
    """``num`` streams of a sampler's ``stream``: ``split(stream, num)``'s
    keys, or the same ``torch.Generator`` ``num`` times (drawn from in
    sequence)."""
    return split(stream, num).unbind(-2) if is_key(stream) else (stream,) * num


def vmap_streams(fn, stream, n: int, in_dims=0, out_dims=0):
    """``fn(lane_stream, *args)`` vmapped over ``n`` lanes, as a function of
    ``args``: under a key lane ``i`` draws under the ``i``-th of
    ``split(key, n)``, as the reference's ``vmap`` over split keys does; a
    ``torch.Generator`` is shared by the lanes, each drawing its own
    (``randomness="different"``). ``in_dims`` (a tuple) and ``out_dims``
    are ``args``'s and the outputs', as ``torch.func.vmap`` takes them."""
    dims = (0, *in_dims) if isinstance(in_dims, tuple) else in_dims
    if is_key(stream):
        lanes, body, kw = split(stream, n), fn, {}
    else:
        lanes, body, kw = torch.zeros(n, device=stream.device), (lambda _, *a: fn(stream, *a)), {"randomness": "different"}
    batched = torch.func.vmap(body, in_dims=dims, out_dims=out_dims, **kw)
    return lambda *args: batched(lanes, *args)


def split_each(batch: torch.Tensor) -> tuple:
    """``split(k)`` of each key ``k`` of a batch ``(count, w)``, made in one
    hash: a pair of keys for each."""
    return tuple(tuple(pair.unbind(0)) for pair in split(batch).unbind(0))


def split_pairs(root, count: int) -> tuple:
    """``split(k)`` of each key ``k`` of ``split(root, count)``, as the
    reference's samplers pre-split a scan's keys and split each in its
    body, made for every step in two hashes; or the generator twice each
    step."""
    if not is_key(root):
        return ((root, root),) * count
    return split_each(split(root, count)) if count else ()


def sweep_streams(root, tag: int, count: int) -> tuple:
    """The split keys of ``count`` sweeps rooted at ``fold_in(root, tag)``
    (``split_pairs``), or the generator twice each sweep."""
    return split_pairs(fold_in(root, tag) if is_key(root) else root, count)


def normal_from(stream, shape, device) -> torch.Tensor:
    """float32 standard normals: ``normal(stream, shape)`` under a key,
    ``torch.randn`` from a generator on ``device``."""
    if is_key(stream):
        return normal(stream, shape)
    return torch.randn(_shape(shape), generator=stream, device=device)


def uniform_from(stream, shape, device) -> torch.Tensor:
    """float32 uniforms on ``[0, 1)``: ``uniform(stream, shape)`` under a
    key, ``torch.rand`` from a generator on ``device``."""
    if is_key(stream):
        return uniform(stream, shape)
    return torch.rand(_shape(shape), generator=stream, device=device)


def _on(x, dtype, device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``; a Python number is filled
    there, not copied from the host (a copy waits for the card)."""
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def _check(k, what: str) -> None:
    if not is_key(k):
        raise TypeError(f"{what}: expected a key (an int64 tensor of two or four words on its last axis), "
                        f"got {_describe(k)}")


def _halves(k: torch.Tensor) -> torch.Tensor:
    """A key as threefry keys: itself, or an rbg key's two halves on a new
    axis before the words (``(..., 2, 2)``), hashed in one pass."""
    return k if k.shape[-1] == 2 else k.unflatten(-1, (2, 2))


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


def _hash_iota(k: torch.Tensor, shape: tuple, start: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry of the row-major position of each element of ``shape`` (its
    high and low 32-bit words as the counter pair), counted from ``start``,
    under each key of ``k``: two tensors of shape ``k.shape[:-1] + shape``."""
    n = math.prod(shape)
    i = torch.arange(start, start + n, dtype=torch.int64, device=k.device).reshape(shape)
    lead = tuple(k.shape[:-1])
    k1 = k[..., 0].reshape(lead + (1,) * len(shape))
    k2 = k[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k1, k2, i >> 32, i & _M32)


def split(k: torch.Tensor, num=2) -> torch.Tensor:
    """``num`` new keys from ``k`` (``num`` an int or a shape), as
    ``jax.random.split``: shape ``k.shape[:-1] + shape + (2,)`` (``(4,)``
    for rbg keys, each half split as a threefry key)."""
    _check(k, "split")
    shape = _shape(num)
    b1, b2 = _hash_iota(_halves(k), shape)
    out = torch.stack([b1, b2], dim=-1)
    if k.shape[-1] == 2:
        return out
    # (..., half, *shape, word) -> (..., *shape, half, word) -> (..., *shape, 4)
    return out.movedim(k.dim() - 1, -2).flatten(-2)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``k`` with the integer ``data`` (its low 32 bits) folded in, as
    ``jax.random.fold_in``. ``data`` may be an integer tensor that
    broadcasts against the key's batch axes."""
    _check(k, "fold_in")
    rbg = k.shape[-1] == 4
    if isinstance(data, torch.Tensor):
        d = data.to(device=k.device, dtype=torch.int64) & _M32
        d = d.unsqueeze(-1) if rbg else d  # against the halves' axis
    else:
        d = int(data) & _M32
    half = _halves(k)
    b1, b2 = threefry2x32(half[..., 0], half[..., 1], torch.zeros_like(half[..., 0]),
                          d + torch.zeros_like(half[..., 1]))
    out = torch.stack([b1, b2], dim=-1)
    return out.flatten(-2) if rbg else out


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The high and low words of the 64-bit product ``a * m`` (``a`` in
    ``[0, 2**32)``, ``m`` a 32-bit constant), from ``a``'s 16-bit halves:
    torch has no unsigned 64-bit multiply, and each half's product with
    ``m`` stays under ``2**48``."""
    p1, p0 = (a >> 16) * m, (a & 0xFFFF) * m
    return (p1 + (p0 >> 16)) >> 16, (((p1 & 0xFFFF) << 16) + p0) & _M32


def _philox4x32(counter: tuple, key_words: tuple) -> tuple:
    """Philox4x32-10 of the counter words ``(c0, c1, c2, c3)`` under the key
    words ``(k0, k1)``: ten rounds, the key bumped between them; int64
    tensors in ``[0, 2**32)`` that broadcast together."""
    c0, c1, c2, c3 = counter
    rounds = torch.arange(10, dtype=torch.int64, device=key_words[0].device)
    k0s = ((key_words[0][..., None] + rounds * _PHILOX_W[0]) & _M32).unbind(-1)
    k1s = ((key_words[1][..., None] + rounds * _PHILOX_W[1]) & _M32).unbind(-1)
    for r in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0s[r], lo1, hi0 ^ c3 ^ k1s[r], lo0
    return c0, c1, c2, c3


def _rbg_bits(k: torch.Tensor, shape: tuple, start: int = 0) -> torch.Tensor:
    """XLA's ``RngBitGenerator`` (Philox4x32-10) under each rbg key of ``k``:
    block ``b`` at counter ``(w2 + b, w3 + carry, w0, w1)`` and key ``(w0,
    w1)`` gives the row-major elements ``4b .. 4b + 3`` of a draw, of which
    ``shape`` takes the ones from ``start`` on."""
    n = math.prod(shape)
    lead = tuple(k.shape[:-1])
    w = [k[..., i].reshape(lead + (1,)) for i in range(4)]
    first, skip = divmod(start, 4)
    low = w[2] + torch.arange(first, first + (skip + n + 3) // 4, dtype=torch.int64, device=k.device)
    words = _philox4x32((low & _M32, (w[3] + (low >> 32)) & _M32, w[0], w[1]), (w[0], w[1]))
    flat = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(lead + (-1,))
    return flat[..., skip : skip + n].reshape(lead + shape)


@functools.cache
def _rbg_op():
    """``_rbg_bits`` as a custom op whose ``torch.func.vmap`` rule is JAX's
    batching rule for ``rng_bit_generator``: under ``jax.vmap`` an rbg draw
    takes the first lane's key alone and draws every lane's elements from
    it, lane ``b`` the ``b``-th block of ``lane`` elements (``lane`` the
    size of one lane's whole draw, of which the op makes the elements from
    ``start`` on). Outside a vmap each key of a batch draws its own."""

    @torch.library.custom_op("genjax_tpu_torch::rbg_bits", mutates_args=())
    def op(k: torch.Tensor, shape: list[int], start: int, lane: int) -> torch.Tensor:
        return _rbg_bits(k, tuple(shape), start)

    @op.register_fake
    def _(k, shape, start, lane):
        return k.new_empty(tuple(k.shape[:-1]) + tuple(shape))

    def batched(info, in_dims, k, shape, start, lane):
        first = k.movedim(in_dims[0], 0)[0]
        size = info.batch_size
        if start == 0 and math.prod(shape) == lane:
            out = op(first, [size, *shape], 0, size * lane)
        else:
            out = torch.stack([op(first, shape, b * lane + start, size * lane) for b in range(size)],
                              dim=first.dim() - 1)
        return out, first.dim() - 1

    op.register_vmap(batched)
    return op


def _bits(k: torch.Tensor, shape: tuple, start: int = 0, lane: int | None = None) -> torch.Tensor:
    """The bits of the row-major elements ``start .. start + prod(shape) -
    1`` of a draw of ``lane`` elements (``prod(shape)`` by default) under
    each key of ``k``, in ``shape``: a slice of a larger draw, made alone
    (both key kinds count an element's bits from its position only). Under
    ``torch.func.vmap`` an rbg draw follows JAX's batching rule
    (``_rbg_op``)."""
    if k.shape[-1] == 4:
        n = math.prod(shape)
        return _rbg_op()(k, list(shape), start, n if lane is None else lane)
    b1, b2 = _hash_iota(k, shape, start)
    return b1 ^ b2


def bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits for each element of ``shape``, as
    ``jax.random.bits(k, shape)`` (uint32 there, int64 in ``[0, 2**32)``
    here): shape ``k.shape[:-1] + shape``."""
    _check(k, "bits")
    return _bits(k, _shape(shape))


def uniform(k: torch.Tensor, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0) -> torch.Tensor:
    """Uniforms on ``[minval, maxval)``, as ``jax.random.uniform``: the top
    mantissa bits of the random bits under an exponent of 1, less 1, scaled
    and shifted, and clipped below at ``minval``. Equal to JAX's bit for bit
    in float32 and float64; ``minval`` and ``maxval`` broadcast against
    ``shape``."""
    _check(k, "uniform")
    shape = _shape(shape)
    if dtype == torch.float32:
        return _unit_floats(bits(k, shape), k.device, minval, maxval)
    if dtype == torch.float64:
        if k.shape[-1] == 4:
            raise TypeError("uniform: float64 draws of an rbg key are not reproduced; use float32")
        hi, lo = _hash_iota(k, shape)  # 64 bits an element, high word first
        m = (hi << 20) | (lo >> 12)
        floats = m.to(torch.float64) * (2.0 ** -52)
        lo_, hi_ = _on(minval, dtype, k.device), _on(maxval, dtype, k.device)
        return torch.maximum(lo_, floats * (hi_ - lo_) + lo_)
    raise TypeError(f"uniform: dtype must be torch.float32 or torch.float64, got {dtype}")


def _unit_floats(b: torch.Tensor, device, minval, maxval) -> torch.Tensor:
    """float32 uniforms on ``[minval, maxval)`` from 32-bit draws ``b``:
    the top 23 bits under an exponent of 1, less 1, scaled and shifted with
    XLA's fused multiply-add, clipped below at ``minval``."""
    floats = (b >> 9).to(torch.float32) * (2.0 ** -23)
    lo_, hi_ = _on(minval, torch.float32, device), _on(maxval, torch.float32, device)
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


def _mullo(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 tensors in ``[0, 2**32)``."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def randint(k: torch.Tensor, shape=(), minval=0, maxval=None) -> torch.Tensor:
    """Integers in ``[minval, maxval)``, as ``jax.random.randint(k, shape,
    minval, maxval)`` gives them in its default int32 (int64 here): two
    32-bit draws from ``split(k)``, the high one's remainder scaled by
    ``2**32 mod span`` and the low one's added, modulo the span. Bounds are
    integers (or integer tensors that broadcast against ``shape``), clipped
    to int32; a ``maxval`` past int32's largest widens the span by one."""
    _check(k, "randint")
    if maxval is None:
        raise TypeError("randint: maxval is required")
    shape = _shape(shape)
    lo_, hi_ = (_on(v, torch.int64, k.device) for v in (minval, maxval))
    out_of_range = hi_ > _I32_MAX
    lo_, hi_ = lo_.clamp(_I32_MIN, _I32_MAX), hi_.clamp(_I32_MIN, _I32_MAX)
    k1, k2 = split(k).unbind(-2)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = (hi_ - lo_) & _M32
    span = torch.where(hi_ <= lo_, torch.ones_like(span), span)
    span = torch.where(out_of_range & (hi_ > lo_), (span + 1) & _M32, span)
    # a span that wrapped to 0 leaves the bits as they are (JAX's rem by 0
    # in uint32 is the dividend)
    safe = torch.where(span == 0, torch.ones_like(span), span)

    def rem(a):
        return torch.where(span == 0, a, a % safe)

    multiplier = rem(torch.full_like(span, 2**16))
    multiplier = rem(_mullo(multiplier, multiplier))
    offset = rem((_mullo(rem(higher), multiplier) + rem(lower)) & _M32)
    return ((lo_ + offset + 2**31) & _M32) - 2**31


def bernoulli(k: torch.Tensor, p=0.5, shape=None) -> torch.Tensor:
    """Coin flips that come up True with probability ``p``, as
    ``jax.random.bernoulli``: float32 uniforms below ``p``. ``shape``
    defaults to ``p``'s."""
    _check(k, "bernoulli")
    p = _on(p, torch.float32, k.device)
    shape = tuple(p.shape) if shape is None else _shape(shape)
    return uniform(k, shape) < p


_TINY32 = torch.finfo(torch.float32).tiny

#: The most gumbel draws ``categorical`` makes at once: a larger draw is made
#: in slices of its leading axis, each alone (the bits depend on an
#: element's position only), so memory stays bounded.
CATEGORICAL_CHUNK = 2**22


def _gumbel_of(b: torch.Tensor, device) -> torch.Tensor:
    return -torch.log(-torch.log(_unit_floats(b, device, _TINY32, 1.0)))


def gumbel(k: torch.Tensor, shape=()) -> torch.Tensor:
    """Standard Gumbel draws in float32, as ``jax.random.gumbel`` (its
    default ``mode="low"``): ``-log(-log(u))`` of uniforms on ``[tiny,
    1)``."""
    _check(k, "gumbel")
    return _gumbel_of(bits(k, shape), k.device)


def categorical(k: torch.Tensor, logits, axis: int = -1, shape=None) -> torch.Tensor:
    """Draws from ``softmax(logits, axis)``, as ``jax.random.categorical``
    (with replacement): the argmax of ``logits`` plus Gumbel noise of shape
    ``(*prefix, *logits_shape)``, where ``shape`` (the batch shape of
    ``logits`` without ``axis`` by default) is ``prefix`` before that
    batch shape. int64, of shape ``shape``; one key. A noise of more than
    ``CATEGORICAL_CHUNK`` elements is made in slices of its leading axis,
    which draw what the whole does."""
    _check(k, "categorical")
    if k.dim() != 1:
        raise ValueError(f"categorical: expected one key, got a batch of shape {tuple(k.shape[:-1])}")
    logits = torch.as_tensor(logits, device=k.device)
    if not logits.is_floating_point():
        logits = logits.to(torch.float32)
    nd = logits.dim()
    axis = axis % nd
    batch = tuple(logits.shape[:axis]) + tuple(logits.shape[axis + 1 :])
    shape = batch if shape is None else _shape(shape)
    if tuple(shape[len(shape) - len(batch) :]) != batch:
        raise ValueError(f"categorical: shape {shape} must end with the logits' batch shape {batch}")
    prefix = tuple(shape[: len(shape) - len(batch)])
    noise_shape = prefix + batch[:axis] + (logits.shape[axis],) + batch[axis:]
    red = axis - nd  # the category axis, counted from the end
    if not prefix or math.prod(noise_shape) <= CATEGORICAL_CHUNK:
        return torch.argmax(_gumbel_of(_bits(k, noise_shape), k.device) + logits, dim=red)
    inner = math.prod(noise_shape[1:])
    rows = max(1, CATEGORICAL_CHUNK // max(inner, 1))
    out = []
    for r0 in range(0, noise_shape[0], rows):
        r1 = min(noise_shape[0], r0 + rows)
        b = _bits(k, (r1 - r0,) + noise_shape[1:], start=r0 * inner, lane=math.prod(noise_shape))
        out.append(torch.argmax(_gumbel_of(b, k.device) + logits, dim=red))
    return torch.cat(out, dim=0)


def choice(k: torch.Tensor, a, shape=(), replace: bool = True, axis: int = 0) -> torch.Tensor:
    """Draws from ``a``, as ``jax.random.choice(k, a, shape)`` makes them
    with replacement and uniform weights: ``randint(k, shape, 0, n)``, then
    those indices of ``a`` along ``axis`` (an int ``a`` is ``arange(a)``,
    and the indices are the draw). Without replacement the reference takes
    a permutation, which is not reproduced: ``replace=False`` raises a
    ``TypeError``; draw it from a ``torch.Generator`` instead
    (``torch.randperm``)."""
    _check(k, "choice")
    if not replace:
        raise TypeError("choice: a draw without replacement under a key is not reproduced here; pass a "
                        "torch.Generator and draw it with torch.randperm")
    shape = _shape(shape)
    arr = a if isinstance(a, torch.Tensor) else torch.as_tensor(a, device=k.device)
    n = int(arr) if arr.dim() == 0 else int(arr.shape[axis])
    if n <= 0:
        raise ValueError("choice: a must be greater than 0 unless no samples are taken")
    ind = randint(k, shape, 0, n)
    if arr.dim() == 0:
        return ind
    return torch.index_select(arr, axis, ind.reshape(-1)).unflatten(axis, shape)


def geometric(k: torch.Tensor, p, shape=None) -> torch.Tensor:
    """Trials up to the first success, as ``jax.random.geometric`` draws
    them in its default int32 (int64 here): ``floor(log u / log1p(-p)) + 1``
    of float32 uniforms ``u``. ``shape`` defaults to ``p``'s."""
    _check(k, "geometric")
    p = _on(p, torch.float32, k.device)
    shape = tuple(p.shape) if shape is None else _shape(shape)
    u = uniform(k, shape)
    g = torch.floor(torch.log(u) / torch.log1p(-p).expand(shape)) + 1
    return g.to(torch.int64)


# ----------------------------------------------------------------------
# jax.random.gamma and what rests on it alone
# ----------------------------------------------------------------------


def _any(mask: torch.Tensor) -> bool:
    """Whether any element of ``mask`` is set, over every lane of an
    enclosing ``torch.func`` transform: the gamma sampler's loops exit
    collectively, once no element of any lane is left (the lanes' values
    are read under the transform's wrappers, as ``core/changes.py`` reads
    them). One host read."""
    from torch._C import _functorch

    while _functorch.is_functorch_wrapped_tensor(mask):
        mask = _functorch.get_unwrapped(mask)
    return bool(mask.any())


def _flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its subnormal values made 0, as XLA computes on the CPU
    (and a TPU, which has no subnormals): where a gamma draw or its boost
    underflows past float32's smallest normal, the reference's is 0."""
    return torch.where(x.abs() < _TINY32, torch.zeros_like(x), x)


def _each_uniform(k: torch.Tensor, minval: float = 0.0) -> torch.Tensor:
    """One float32 uniform on ``[minval, 1)`` under each key of the batch
    ``k``, as ``uniform(k, (), minval=minval)``, but each rbg key draws its
    own under ``torch.func.vmap`` too: ``jax.random.gamma`` maps its sampler
    over the keys with ``lax.map``, not ``vmap``, so JAX's batching rule for
    an rbg draw (``_rbg_op``) does not apply."""
    b = _rbg_bits(k, ()) if k.shape[-1] == 4 else _bits(k, ())
    return _unit_floats(b, k.device, minval, 1.0)


def _gamma_one(k: torch.Tensor, alpha: torch.Tensor, log_space: bool) -> torch.Tensor:
    """``jax.random``'s ``_gamma_one`` for each element at once: ``k``
    ``(n, W)``, one key an element, ``alpha`` ``(n,)`` float32.
    Marsaglia and Tsang: a round splits an element's key in three, draws a
    normal ``x`` with ``v = 1 + c x > 0`` (an inner loop that splits in two
    until it holds) and a uniform ``U``, and the element is done once ``U <
    1 - 0.0331 X^2`` or ``log U < X / 2 + d (1 - V + log V)`` (``X = x^2``,
    ``V = v^3``); ``alpha < 1`` takes ``alpha + 1`` and the boost ``u^(1 /
    alpha)``, in log space ``log(u) / alpha``; subnormal values are made 0
    (``_flush``). The loops are masked over all elements and exit when no
    element is left, so each element draws what its own ``lax.while_loop``
    draws."""
    one_third = torch.tensor(1.0 / 3.0, dtype=torch.float32)
    boost_mask = alpha >= 1.0
    alpha_orig = alpha
    alpha = torch.where(boost_mask, alpha, alpha + 1.0)
    d = alpha - one_third
    c = one_third / torch.sqrt(d)

    def rejected(X, V, U):
        return (U >= 1.0 - 0.0331 * (X * X)) & (torch.log(U) >= X * 0.5 + d * ((1.0 - V) + torch.log(V)))

    k, sub_key = split(k).unbind(-2)
    X, V, U = torch.zeros_like(alpha), torch.ones_like(alpha), torch.full_like(alpha, 2.0)
    active = rejected(X, V, U)
    while _any(active):
        k_next, kx, k_u = split(k, 3).unbind(-2)
        x, v = torch.zeros_like(alpha), torch.full_like(alpha, -1.0)
        inner = active.clone()
        while _any(inner):
            kx_next, k_x = split(kx).unbind(-2)
            x_new = math.sqrt(2.0) * erfinv(_each_uniform(k_x, _NORMAL_LOW))
            v_new = 1.0 + x_new * c
            kx = torch.where(inner[:, None], kx_next, kx)
            x, v = torch.where(inner, x_new, x), torch.where(inner, v_new, v)
            inner = inner & (v <= 0.0)
        U_new = _each_uniform(k_u)
        k = torch.where(active[:, None], k_next, k)
        X, V, U = (torch.where(active, new, old) for new, old in ((x * x, X), (v * v * v, V), (U_new, U)))
        active = active & rejected(X, V, U)
    inv_alpha = 1.0 / alpha_orig
    if log_space:
        log_samples = torch.log1p(-_each_uniform(sub_key))
        log_boost = torch.where(boost_mask | (log_samples == 0.0), 0.0, log_samples * inv_alpha)
        return torch.log(d) + torch.log(V) + log_boost
    samples = 1.0 - _each_uniform(sub_key)
    boost = torch.where(boost_mask, 1.0, _flush(torch.pow(samples, inv_alpha)))
    return _flush(d * V * boost)


def _float32(x, k: torch.Tensor) -> torch.Tensor:
    return _on(x, torch.float32, k.device)


def gamma(k: torch.Tensor, a, shape=None, log_space: bool = False) -> torch.Tensor:
    """Gamma(``a``, 1) draws, as ``jax.random.gamma(k, a, shape)`` (or, with
    ``log_space``, ``jax.random.loggamma``): ``a`` broadcast to ``shape``
    (``a``'s own by default), element ``i`` drawn under ``split(k,
    size)[i]`` by ``_gamma_one``. float32."""
    _check(k, "gamma")
    a = _float32(a, k)
    shape = tuple(a.shape) if shape is None else _shape(shape)
    a = torch.broadcast_to(a, shape)
    size = math.prod(shape)
    flat = _gamma_one(split(k, size).reshape(size, -1), a.reshape(size), log_space)
    return flat.reshape(shape)


def loggamma(k: torch.Tensor, a, shape=None) -> torch.Tensor:
    """The logs of Gamma(``a``, 1) draws, as ``jax.random.loggamma``: exact
    where ``gamma`` underflows (small ``a``)."""
    return gamma(k, a, shape, log_space=True)


def beta(k: torch.Tensor, a, b, shape=None) -> torch.Tensor:
    """Beta(``a``, ``b``) draws, as ``jax.random.beta``: the log-gammas of
    ``split(k)``'s two keys, each less their maximum, exponentiated and
    normalised."""
    _check(k, "beta")
    a, b = _float32(a, k), _float32(b, k)
    shape = tuple(torch.broadcast_shapes(a.shape, b.shape)) if shape is None else _shape(shape)
    key_a, key_b = split(k).unbind(-2)
    log_a = loggamma(key_a, torch.broadcast_to(a, shape), shape)
    log_b = loggamma(key_b, torch.broadcast_to(b, shape), shape)
    log_max = torch.maximum(log_a, log_b)
    ga, gb = _flush(torch.exp(log_a - log_max)), _flush(torch.exp(log_b - log_max))
    return ga / (ga + gb)


def dirichlet(k: torch.Tensor, alpha, shape=None) -> torch.Tensor:
    """Dirichlet(``alpha``) draws over ``alpha``'s last axis, as
    ``jax.random.dirichlet``: the softmax of log-gammas of shape ``shape +
    alpha.shape[-1:]`` (``shape`` defaults to ``alpha.shape[:-1]``)."""
    _check(k, "dirichlet")
    alpha = _float32(alpha, k)
    if alpha.dim() < 1:
        raise ValueError(f"dirichlet requires alpha.ndim >= 1, got alpha.ndim == {alpha.dim()}")
    shape = tuple(alpha.shape[:-1]) if shape is None else _shape(shape)
    x = loggamma(k, alpha, shape + tuple(alpha.shape[-1:]))
    e = _flush(torch.exp(x - x.amax(dim=-1, keepdim=True)))
    return e / e.sum(dim=-1, keepdim=True)


def chisquare(k: torch.Tensor, df, shape=None) -> torch.Tensor:
    """Chi-square(``df``) draws, as ``jax.random.chisquare``: twice the
    exponential of a log-gamma of ``df / 2``."""
    _check(k, "chisquare")
    df = _float32(df, k)
    shape = tuple(df.shape) if shape is None else _shape(shape)
    return _flush(torch.exp(loggamma(k, df / 2.0, shape))) * 2.0


def t(k: torch.Tensor, df, shape=None) -> torch.Tensor:
    """Student's t(``df``) draws, as ``jax.random.t``: a normal under
    ``split(k)``'s first key times ``sqrt((df / 2) / g)``, ``g`` a
    Gamma(``df / 2``) draw under the second."""
    _check(k, "t")
    df = _float32(df, k)
    shape = tuple(df.shape) if shape is None else _shape(shape)
    key_n, key_g = split(k).unbind(-2)
    n = normal(key_n, shape)
    half_df = df / 2.0
    return n * torch.sqrt(half_df / gamma(key_g, half_df, shape))
