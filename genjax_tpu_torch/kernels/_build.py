"""Build the package's CUDA sources (``kernels/csrc``) into shared libraries.

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) at first use,
into ``build/genjax_tpu_torch/`` at the root of the checkout, under a name
keyed by a hash of the sources and flags, and loaded with ``ctypes``. Only
this repository's own sources are built. A failed build raises with nvcc's
output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "genjax_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _so_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said when ``csrc/<name>.cu`` was built (each
    kernel's registers, spills and static shared memory)."""
    return _so_path(name).with_suffix(".ptxas.txt").read_text()


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, and load it.
    Builds of different sources may run in parallel threads."""
    src = CSRC / f"{name}.cu"
    so = _so_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        so.with_suffix(".ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, so)
        print(
            f"built {so.relative_to(BUILD_DIR.parents[1])} from "
            f"{src.relative_to(BUILD_DIR.parents[1])} in "
            f"{time.perf_counter() - t0:.2f} s\n{proc.stderr.strip()}",
            flush=True,
        )
    return ctypes.CDLL(str(so))
