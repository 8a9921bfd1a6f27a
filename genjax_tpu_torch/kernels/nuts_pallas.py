"""The NUTS sweep as one CUDA kernel (K4), its routing and the NUTS warmup.

Counterpart of ``genjax_tpu/kernels/nuts_pallas.py``, whose Pallas kernel
``_nuts_kernel`` keeps a chain block's whole tree (endpoints, proposal and
checkpoint stacks) in on-chip memory for the whole sweep; it never compiled
on the TPU, and runs there only under the Pallas interpreter.

- ``nuts_sweep``: the CUDA kernel (``csrc/nuts_sweep.cu``), one chain per
  thread, a CUDA block per chain block, checkpoint stacks in shared memory,
  for densities that carry a device body (``kernels/bodies.py``).
- ``nuts.nuts_sweep_cols``: its plain torch version, any column density.
- ``pallas_nuts`` routes between them with ``hmc._route``.
- ``warmup_column_nuts``: the windowed warmup driven by NUTS's own accept
  statistic, every phase through ``pallas_nuts``'s routing. It lives here
  and not in ``nuts.py`` (as in the reference) because it must route
  through ``pallas_nuts``, and ``nuts.py`` sits below this module.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from . import _build
from .adaptation import windowed_warmup
from .bodies import Body
from .hmc import _RNG_IDS, _inv_mass_col, _int32, _route
from .nuts import nuts_sweep_cols
from .rows import chain_mesh

# launches of the CUDA NUTS kernel in this process
nuts_sweep_launches = 0

# chains a block on the Philox stream; the counter stream's block is its
# chain block ``block_n``
DEFAULT_BLOCK = 32
MAX_BLOCK = 256  # the kernel's __launch_bounds__


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("nuts_sweep")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nuts_sweep.argtypes = [
        P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, F, F, I, I, I, I, P,
    ]
    lib.nuts_sweep.restype = I
    lib.nuts_smem_limit.argtypes = [I]
    lib.nuts_smem_limit.restype = I
    lib.nuts_smem_bytes.argtypes = [I, I, I, I, I, I, I]
    lib.nuts_smem_bytes.restype = ctypes.c_long
    lib.nuts_kernel_info.argtypes = [I, I, I, I, I, I, I, P]
    lib.nuts_kernel_info.restype = I
    return lib


def smem_bytes(body: Body, d: int, max_depth: int, block: int) -> int:
    """Dynamic shared memory of one K4 block of ``block`` chains: the body's
    constants (``X`` and ``y``, to a float4) in the generic variant, then the
    two checkpoint stacks ``(max_depth, D, block)``."""
    return 4 * (body.shared_consts_floats(d) + 2 * max_depth * d * block)


def kernel_info(body: Body, d: int, max_depth: int, block: int) -> dict:
    """The CUDA runtime's view of the K4 instantiation ``body`` takes at
    ``D = d``, launched with ``block`` chains a block: registers a thread,
    local (spill) bytes a thread, resident blocks an SM."""
    out = (ctypes.c_int * 3)()
    err = _lib().nuts_kernel_info(
        d, body.kind, int(body.variant(d) == "specialised"), body.n_obs, body.d_w, max_depth,
        block, out,
    )
    if err != 0:
        raise RuntimeError(f"nuts_kernel_info failed with CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2]}


def nuts_sweep(
    body: Body,
    q0: torch.Tensor,
    seed: int,
    *,
    n_steps: int,
    eps: float,
    max_depth: int = 8,
    inv_mass=None,
    rng: str = "philox",
    block_n: int | None = None,
    divergence_threshold: float = 1000.0,
):
    """Launch the CUDA NUTS kernel on the current stream, without
    synchronising. ``q0`` is a contiguous float32 CUDA tensor ``(D, N)``
    with ``D`` 8 or 16. The launch block is ``block_n`` chains (default
    ``DEFAULT_BLOCK``, at most ``MAX_BLOCK``); ``rng="counter"`` needs
    ``block_n``, which is then also the stream's chain block, and ``N`` a
    multiple of it. The body's variant taken is recorded on
    ``nuts_sweep.last_variant``.

    Returns ``(q, accept_sums, leapfrog_sums)``: positions ``(D, N)`` and,
    per chain, the accept statistic and the leapfrog count summed over the
    ``n_steps`` transitions, each ``(N,)``.
    """
    global nuts_sweep_launches
    if not (isinstance(q0, torch.Tensor) and q0.is_cuda):
        raise ValueError("nuts_sweep takes a CUDA tensor")
    if q0.dtype != torch.float32 or q0.ndim != 2 or not q0.is_contiguous():
        raise ValueError(
            f"nuts_sweep takes a contiguous float32 (D, N) tensor, got "
            f"{q0.dtype} {tuple(q0.shape)} contiguous={q0.is_contiguous()}"
        )
    d, n = q0.shape
    if d not in (8, 16) or d < body.min_dim():
        raise ValueError(f"D={d}: the kernel takes D in (8, 16) and {body.name} needs D >= {body.min_dim()}")
    if rng not in _RNG_IDS:
        raise ValueError(f"rng must be 'philox' or 'counter', got {rng!r}")
    if rng == "counter" and block_n is None:
        raise ValueError("the counter stream needs its chain block: pass block_n")
    block = DEFAULT_BLOCK if block_n is None else block_n
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"block_n={block}: the kernel takes 1 to {MAX_BLOCK} chains a block")
    if rng == "counter" and n % block:
        raise ValueError(f"n_chains={n} is not a multiple of the chain block {block}")
    if n_steps < 0 or not 1 <= max_depth <= 30:
        raise ValueError("n_steps must be non-negative and max_depth in 1..30")
    variant = body.variant(d)
    consts = body.consts_on(q0.device)
    smem = smem_bytes(body, d, max_depth, block)
    device_index = q0.device.index if q0.device.index is not None else torch.cuda.current_device()
    limit = _lib().nuts_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(f"could not read the shared-memory limit of CUDA device {device_index}")
    if smem > limit:
        raise ValueError(
            f"K4 needs {smem} B of shared memory per block at D={d}, max_depth={max_depth}, "
            f"block_n={block}; this card allows {limit} B per block "
            f"(cudaDevAttrMaxSharedMemoryPerBlockOptin). Lower block_n or max_depth."
        )
    inv_mass = _inv_mass_col(inv_mass, d, q0.device).reshape(d).contiguous()
    q_out = torch.empty_like(q0)
    accepts = torch.empty(n, dtype=torch.float32, device=q0.device)
    leaps = torch.empty(n, dtype=torch.float32, device=q0.device)
    with torch.cuda.device(q0.device):
        err = _lib().nuts_sweep(
            q0.data_ptr(), q_out.data_ptr(), accepts.data_ptr(), leaps.data_ptr(),
            inv_mass.data_ptr(), consts.data_ptr(), body.consts.data_ptr(), consts.numel(),
            body.kind, int(variant == "specialised"), d, n, body.n_obs, body.d_w,
            body.obs_scale, n_steps, eps, divergence_threshold, max_depth, _int32(seed),
            _RNG_IDS[rng], block, torch.cuda.current_stream(q0.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nuts_sweep kernel launch failed with CUDA error {err}")
    nuts_sweep_launches += 1
    nuts_sweep.last_variant = variant
    return q_out, accepts, leaps


nuts_sweep.last_variant = None


def pallas_nuts(
    logdensity_cols: Callable,
    q0: torch.Tensor,
    seed: int,
    *,
    n_steps: int,
    eps: float,
    max_depth: int = 8,
    inv_mass=None,
    block_n: int | None = None,
    interpret: bool = False,
    backend: str = "auto",
    divergence_threshold: float = 1000.0,
):
    """Run ``n_steps`` NUTS transitions on ``N`` column-layout chains.

    Backends, as for ``hmc.pallas_hmc``: ``"cuda"`` is the CUDA kernel
    (needs a CUDA ``q0`` and a density with a device body), ``"torch"`` the
    plain twin ``nuts.nuts_sweep_cols``, and ``"auto"`` (default) takes
    ``"cuda"`` for a CUDA ``q0`` and ``"torch"`` for a CPU one; a CUDA
    ``q0`` whose density has no body raises. ``interpret=True`` selects the
    counter stream (the port of the reference's interpret-mode PRNG) for
    chain block ``block_n``, which it needs; otherwise the kernel draws from
    Philox and the twin from a ``torch.Generator`` seeded with ``seed``. The
    backend taken is recorded on ``pallas_nuts.last_backend``.

    Returns ``(q_final, accept_stat, mean_leapfrogs)``: the mean over chains
    and transitions of the accept statistic and of the leapfrog count.
    """
    body = getattr(logdensity_cols, "body", None)
    backend = _route(backend, q0.device, body is not None)
    if backend == "cuda":
        q, accepts, leaps = nuts_sweep(
            body, q0.to(torch.float32).contiguous(), seed, n_steps=n_steps, eps=eps,
            max_depth=max_depth, inv_mass=inv_mass, rng="counter" if interpret else "philox",
            block_n=block_n, divergence_threshold=divergence_threshold,
        )
        out = q, accepts.mean() / n_steps, leaps.mean() / n_steps
    else:
        out = nuts_sweep_cols(
            logdensity_cols, q0, seed, n_steps=n_steps, eps=eps, max_depth=max_depth,
            inv_mass=inv_mass, rng="counter" if interpret else "generator", block_n=block_n,
            divergence_threshold=divergence_threshold,
        )
    pallas_nuts.last_backend = backend
    return out


pallas_nuts.last_backend = None


def warmup_column_nuts(
    logdensity_cols: Callable,
    q0: torch.Tensor,
    seed: int,
    *,
    n_phases: int = 10,
    steps_per_phase: int = 10,
    eps0: float = 0.1,
    max_depth: int = 8,
    target_accept: float = 0.8,
    backend: str = "auto",
    block_n: int | None = None,
    mesh=None,
    axis: str = "batch",
):
    """Windowed warmup driven by NUTS's own accept statistic: per phase, a
    short NUTS sweep through ``pallas_nuts``'s routing (on the card one K4
    launch), a step-size nudge toward ``target_accept``, and the diagonal
    inverse mass from the cross-chain variance. Phase seeds
    ``(seed + 1) * 1_000_003 + phase`` are the reference's stream. With
    ``mesh`` (a ``parallel.Mesh``), ``q0`` is this rank's shard of chains
    over ``axis`` and the phases adapt to every rank's chains; a row-sharded
    density whose columns are split over a chain axis adapts over that axis
    where no ``mesh`` is given.

    Returns ``(q, eps, inv_mass)``.
    """
    mesh, axis = chain_mesh(logdensity_cols, mesh, axis)

    def sweep(q, idx, eps, inv_mass):
        q, acc, _leaps = pallas_nuts(
            logdensity_cols, q, (seed + 1) * 1_000_003 + idx, n_steps=steps_per_phase, eps=eps,
            max_depth=max_depth, inv_mass=inv_mass, backend=backend, block_n=block_n,
        )
        return q, acc

    q, eps, inv_mass, _accs = windowed_warmup(
        sweep, q0.to(torch.float32), n_windows=n_phases, eps0=eps0, target_accept=target_accept,
        mesh=mesh, axis=axis,
    )
    return q, float(eps), inv_mass
