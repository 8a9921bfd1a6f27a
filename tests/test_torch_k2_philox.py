"""The plain version of K2's Philox stream in ``chip_smoke.py``, which the
card holds ``csrc/k2_stream.cu``'s Philox variant against bit for bit.

``philox4x32_10`` is checked against the known-answer vectors of Random123
(Salmon et al. 2011, ``kat_vectors``: philox4x32 with 10 rounds), which
``curand_Philox4x32_10`` also meets; ``philox_k1_stream`` against the
counters K1 draws at (``(step, j, 0, 0)`` for four normals, ``(step, 4, 0,
0)`` for the uniform, keyed by ``(seed, chain)``).
"""

import math

import pytest
import torch

from chip_smoke import philox4x32_10, philox_k1_stream
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


def _uniform(bits: int) -> float:
    return float(torch.tensor((bits >> 8) * (1.0 / 16777216.0) + (0.5 / 16777216.0), dtype=torch.float32))


def test_k1_stream_draws_at_k1s_counters():
    seed, n, steps, d = 7, 5, 2, 16
    normals, uniforms = philox_k1_stream(seed, n, steps, d, "cpu")
    assert normals.shape == (steps, d, n) and uniforms.shape == (steps, n)
    for step in range(steps):
        for chain in range(n):
            key = [torch.tensor([seed], dtype=torch.int64), torch.tensor([chain], dtype=torch.int64)]
            word = philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in (step, d // 4, 0, 0)], key)[0]
            assert float(uniforms[step, chain]) == _uniform(int(word))
            b = [int(w) for w in philox4x32_10(
                [torch.tensor([c], dtype=torch.int64) for c in (step, 1, 0, 0)], key)]
            r0 = math.sqrt(-2.0 * math.log(_uniform(b[0])))
            angle = 2 * math.pi * _uniform(b[1])
            assert float(normals[step, 4, chain]) == pytest.approx(r0 * math.cos(angle), abs=1e-5)
            assert float(normals[step, 5, chain]) == pytest.approx(r0 * math.sin(angle), abs=1e-5)
