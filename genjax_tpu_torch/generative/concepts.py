"""GFI value concepts: the type names the GFI signatures use.

Counterpart of the value aliases of ``genjax_tpu/generative/concepts.py``
(``Weight``, ``Score``, ``Arguments``). The edit requests wait
for the trace-path slice.
"""

from __future__ import annotations

import torch

Weight = torch.Tensor
Score = torch.Tensor
Arguments = tuple

__all__ = ["Arguments", "Score", "Weight"]
