"""Experimental names, which may change without notice.

Counterpart of ``genjax_tpu/experimental.py``.
"""

from .kernels import column_hmc, pallas_hmc

__all__ = ["column_hmc", "pallas_hmc"]
