"""Build the package's CUDA sources (``kernels/csrc``) into shared libraries.

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) at first use,
into ``build/genjax_tpu_torch/`` at the root of the checkout, under a name
keyed by a hash of the sources and flags, and loaded with ``ctypes``. Only
this repository's own sources are built. A failed build raises with nvcc's
output.

A staged build (``load_staged``) compiles K1 and K4 (``hmc_sweep.cu`` and
``nuts_sweep.cu``) in one ``nvcc`` process with a staged body: a header
that ``kernels/staged.py`` printed from a column log-density, written under
``build/genjax_tpu_torch/staged/`` and included through
``-DGJT_STAGED_HEADER=<...>``. It is keyed by a hash of the sources, the
header and the flags. A staged build holds one stream mode's kernels: the
counter and Philox streams', or, with ``rbg=True`` (``-DGJT_STAGED_RBG``),
the rbg stream's, built only where a keyed driver launches them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "genjax_tpu_torch"
STAGED_DIR = BUILD_DIR / "staged"
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


def _digest(extra: str = "") -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(extra.encode())
    return h.hexdigest()[:16]


def _so_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said when ``csrc/<name>.cu`` was built (each
    kernel's registers, spills and static shared memory)."""
    return _so_path(name).with_suffix(".ptxas.txt").read_text()


def _compile(so: Path, sources: list, extra_flags: tuple = ()) -> None:
    """nvcc ``sources`` into ``so``, its ``-Xptxas -v`` report beside it."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {', '.join(map(str, sources))} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    so.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, so)
    root = BUILD_DIR.parents[1]
    print(
        f"built {so.relative_to(root)} from "
        f"{', '.join(str(Path(s).relative_to(root)) for s in sources)} in "
        f"{time.perf_counter() - t0:.2f} s\n{proc.stderr.strip()}",
        flush=True,
    )


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, and load it.
    Builds of different sources may run in parallel threads."""
    so = _so_path(name)
    if not so.exists():
        _compile(so, [CSRC / f"{name}.cu"])
    return ctypes.CDLL(str(so))


_RBG_FLAG = "-DGJT_STAGED_RBG"


def staged_so_path(header: str, rbg: bool = False) -> Path:
    if rbg:
        return STAGED_DIR / f"staged-rbg-{_digest(header + _RBG_FLAG)}.so"
    return STAGED_DIR / f"staged-{_digest(header)}.so"


def staged_ptxas_report(header: str, rbg: bool = False) -> str:
    """What ``-Xptxas -v`` said when K1 and K4 were built with ``header``
    (their rbg kernels with ``rbg=True``)."""
    return staged_so_path(header, rbg).with_suffix(".ptxas.txt").read_text()


@functools.cache
def load_staged(header: str, rbg: bool = False) -> ctypes.CDLL:
    """K1 and K4 built with the staged body ``header`` (one nvcc process for
    both sources), their rbg kernels with ``rbg=True``, the others' without;
    compiled if the build is missing, and loaded. Builds of different
    headers may run in parallel threads."""
    so = staged_so_path(header, rbg)
    if not so.exists():
        inc = staged_so_path(header).with_suffix(".cuh")
        inc.parent.mkdir(parents=True, exist_ok=True)
        tmp = inc.with_name(f"{inc.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        tmp.write_text(header)
        os.replace(tmp, inc)
        _compile(so, [CSRC / "hmc_sweep.cu", CSRC / "nuts_sweep.cu"],
                 (f"-I{STAGED_DIR}", f"-DGJT_STAGED_HEADER=<{inc.name}>", *((_RBG_FLAG,) if rbg else ())))
    return ctypes.CDLL(str(so))
