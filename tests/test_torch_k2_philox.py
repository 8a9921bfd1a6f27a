"""The plain version of K2's Philox stream in ``chip_smoke.py``, which the
card holds ``csrc/k2_stream.cu``'s Philox variant against (uniforms bit for
bit, normals within 1e-5).

``philox4x32_10`` is checked against the known-answer vectors of Random123
(Salmon et al. 2011, ``kat_vectors``: philox4x32 with 10 rounds), which
``curand_Philox4x32_10`` also meets; ``philox_k1_stream`` against the
counters K1 draws at (``(step, j, 0, 0)`` for four normals, word ``step %
4`` of ``(step // 4, 0, 2, 0)`` for the accept uniform, keyed by ``(seed,
chain)``); the counter layouts of K1 and K4 for repeats at the flagship's
draw counts; and the transform (``philox_u01``, ``box_muller_plain``, and a
float32 mirror of the kernels' radius) against float64 on a grid of words
that takes in both ends of the uniform's range.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import (
    box_muller_plain,
    philox4x32_10,
    philox_k1_counters,
    philox_k1_stream,
    philox_k4_counters,
    philox_u01,
)
from torch_threads import _one_thread  # noqa: F401

U32 = 0xFFFFFFFF


@pytest.mark.parametrize(
    "counter, key, expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((U32,) * 4, (U32, U32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_known_answers(counter, key, expected):
    words = philox4x32_10(
        [torch.tensor([c], dtype=torch.int64) for c in counter],
        [torch.tensor([k], dtype=torch.int64) for k in key],
    )
    assert tuple(int(w) for w in words) == expected


def _words(counter, key):
    return [int(w) for w in philox4x32_10(
        [torch.tensor([c], dtype=torch.int64) for c in counter],
        [torch.tensor([k], dtype=torch.int64) for k in key])]


def _uniform(word: int) -> float:
    return ((word & 0x7FFFFF) * 2 + 1) * 2.0**-24


def test_k1_stream_draws_at_k1s_counters():
    seed, n, steps, d = 7, 5, 6, 16
    normals, uniforms = philox_k1_stream(seed, n, steps, d, "cpu")
    assert normals.shape == (steps, d, n) and uniforms.shape == (steps, n)
    for step in range(steps):
        for chain in range(n):
            key = (seed, chain)
            word = _words((step // 4, 0, 2, 0), key)[step % 4]
            assert float(uniforms[step, chain]) == _uniform(word)
            b = _words((step, 1, 0, 0), key)
            r0 = math.sqrt(-2.0 * math.log(_uniform(b[0])))
            angle = 2 * math.pi * _uniform(b[1]) - math.pi
            assert float(normals[step, 4, chain]) == pytest.approx(r0 * math.cos(angle), abs=1e-6)
            assert float(normals[step, 5, chain]) == pytest.approx(r0 * math.sin(angle), abs=1e-6)


def _assert_no_repeats(normals, uniforms):
    """Calls that make normals use all four words, so their counters appear
    once and never among the uniforms' calls; each uniform takes its own
    word of its call."""
    normal_calls = [c for c, _ in normals]
    assert len(set(normal_calls)) == len(normal_calls)
    assert not set(normal_calls) & {c for c, _ in uniforms}
    assert len(set(uniforms)) == len(uniforms)
    assert all(w in range(4) for _, w in uniforms)


def test_k1_counters_never_repeat_over_a_flagship_sweep():
    normals, uniforms = philox_k1_counters(50, 16)
    assert len(normals) == 50 * 4 and len(uniforms) == 50
    _assert_no_repeats(normals, uniforms)
    # the accept uniforms take every word of their calls: 13 calls for 50 steps
    assert len({c for c, _ in uniforms}) == 13


def test_k4_counters_never_repeat_over_a_flagship_sweep():
    n_steps, depth = 10, 8
    normals, uniforms = philox_k4_counters(n_steps, depth, 16)
    per_transition = sum(2 + 2**j for j in range(depth))
    assert len(normals) == n_steps * 4 and len(uniforms) == n_steps * per_transition
    _assert_no_repeats(normals, uniforms)
    # four uniforms a call, less the words that r0's salts and the end of a
    # transition skip
    assert len({c for c, _ in uniforms}) <= n_steps * (per_transition // 4 + 2)


# low 23 bits: both ends of the uniform's range, the series' edge near 1
# (1 - u = 2^-6) and a spread between; the high bits vary and are unused
_M = [0, 1, 2, 3, 1000, 2**20, 2**22 - 1, 2**22, 2**23 - 2**17 - 1, 2**23 - 2**17, 2**23 - 2**16,
      2**23 - 1000, 2**23 - 3, 2**23 - 2, 2**23 - 1] + list(range(0, 2**23, 2**23 // 61))
_WORDS = [m | (int(h) << 23) for m, h in zip(_M, np.random.default_rng(5).integers(0, 2**9, len(_M)))]


def test_philox_uniform_is_exact_and_inside_the_unit_interval():
    u = philox_u01(torch.tensor(_WORDS, dtype=torch.int64))
    assert u.dtype == torch.float32
    assert [float(v) for v in u] == [_uniform(w) for w in _WORDS]
    assert float(u.min()) == 2.0**-24 and float(u.max()) == 1 - 2.0**-24


def test_plain_box_muller_against_float64():
    words = torch.tensor(_WORDS, dtype=torch.int64)
    shifted = torch.roll(words, 7)
    z = box_muller_plain((words, shifted, torch.flip(words, [0]), words))
    assert z.shape == (4, len(_WORDS))
    for i, (a, b, c) in enumerate(zip(_WORDS, shifted.tolist(), reversed(_WORDS))):
        r0, r1 = (math.sqrt(-2.0 * math.log(_uniform(w))) for w in (a, c))
        t0, t1 = (2 * math.pi * _uniform(w) - math.pi for w in (b, a))
        expected = (r0 * math.cos(t0), r0 * math.sin(t0), r1 * math.cos(t1), r1 * math.sin(t1))
        for k in range(4):  # float32 rounding of |z| < 6
            assert float(z[k, i]) == pytest.approx(expected[k], rel=2**-23, abs=1e-12)


def _radius_mirror(u: torch.Tensor) -> torch.Tensor:
    """``column_common.cuh::bm_radius`` in float32, the exact log2 standing
    for lg2.approx and the exact sqrt for sqrt.approx: the series where
    1 - u < 2^-6."""
    t = 1.0 - u
    series = t * (((t * 0.5 + 0.6666667) * t + 1.0) * t + 2.0)
    return torch.sqrt(torch.where(t < 2.0**-6, series, -1.3862943611198906 * torch.log2(u)))


def test_radius_against_float64_on_every_uniform_near_one():
    # every uniform above 1 - 2^-5: the series' range and a band below it
    u = philox_u01(torch.arange(2**23 - 2**18, 2**23, dtype=torch.int64))
    r = _radius_mirror(u).double()
    r64 = torch.sqrt(-2.0 * torch.log(u.double()))
    assert bool(torch.isfinite(r).all()) and bool((r > 0).all())
    assert float(((r - r64).abs() / r64).max()) < 4e-7
