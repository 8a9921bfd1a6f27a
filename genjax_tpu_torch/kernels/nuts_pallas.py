"""The NUTS sweep as one CUDA kernel (K4), its routing and the NUTS warmup.

Counterpart of ``genjax_tpu/kernels/nuts_pallas.py``, whose Pallas kernel
``_nuts_kernel`` keeps a chain block's whole tree (endpoints, proposal and
checkpoint stacks) in on-chip memory for the whole sweep; it never compiled
on the TPU, and runs there only under the Pallas interpreter.

- ``nuts_sweep``: the CUDA kernel (``csrc/nuts_sweep.cu``), one chain per
  thread, a CUDA block per chain block, checkpoint stacks in shared memory,
  with a device body: hand-written (``kernels/bodies.py``) or staged from
  any other column density (``kernels/staged.py``).
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
from .hmc import (_RNG_IDS, _check_dim, _inv_mass_col, _int32, _route, _words32, chain_operands, device_body,
                  phase_seed_base, rbg_rows_on, rbg_step_keys)
from .staged import STAGED, staging_scope
from .nuts import nuts_sweep_cols, rbg_keys_of, rbg_keys_stride
from .rows import chain_mesh

# launches of the CUDA NUTS kernel in this process
nuts_sweep_launches = 0

# chains a block on the Philox stream; the counter stream's block is its
# chain block ``block_n``
DEFAULT_BLOCK = 32
MAX_BLOCK = 256  # the kernel's __launch_bounds__


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(_build.load("nuts_sweep"))


def _lib_for(body, rng: str = "philox") -> ctypes.CDLL:
    """The build that holds ``body``'s kernel on stream ``rng``: the staged
    build of a staged body (its rbg build for ``"rbg"``), the package's own
    otherwise."""
    return _bind(body.lib(rng == "rbg")) if body.kind == STAGED else _lib()


@functools.cache
def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nuts_sweep.argtypes = [
        P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, F, F, I, I, I, I, P, I, P, I, P, P,
    ]
    lib.nuts_sweep.restype = I
    lib.nuts_smem_limit.argtypes = [I]
    lib.nuts_smem_limit.restype = I
    lib.nuts_smem_bytes.argtypes = [I, I, I, I, I, I, I]
    lib.nuts_smem_bytes.restype = ctypes.c_long
    lib.nuts_kernel_info.argtypes = [I, I, I, I, I, I, I, I, P]
    lib.nuts_kernel_info.restype = I
    return lib


def smem_bytes(body: Body, d: int, max_depth: int, block: int) -> int:
    """Dynamic shared memory of one K4 block of ``block`` chains: the body's
    constants (``X`` and ``y``, to a float4) in the generic variant, then the
    two checkpoint stacks ``(max_depth, D, block)``."""
    return 4 * (body.shared_consts_floats(d) + 2 * max_depth * d * block)


def kernel_info(body: Body, d: int, max_depth: int, block: int, rng: str = "philox") -> dict:
    """The CUDA runtime's view of the K4 instantiation ``body`` takes at
    ``D = d`` on stream ``rng`` (the rbg kernel for ``"rbg"``), launched with
    ``block`` chains a block: registers a thread, local (spill) bytes a
    thread, resident blocks an SM."""
    out = (ctypes.c_int * 3)()
    err = _lib_for(body, rng).nuts_kernel_info(
        d, body.kind, int(body.variant(d) == "specialised"), body.n_obs, body.d_w, max_depth,
        block, int(rng == "rbg"), out,
    )
    if err != 0:
        raise RuntimeError(f"nuts_kernel_info failed with CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2]}


@functools.lru_cache(maxsize=64)
def rbg_keys_table(seed: int, n_steps: int, max_depth: int, device) -> torch.Tensor:
    """K4's keys on the rbg stream, made on the host and kept on ``device``
    (a launch with the same seed copies nothing): ``nuts.rbg_keys_of`` of
    the sweep's step keys, ``(n_steps, rbg_keys_stride(max_depth), 4)``
    int32."""
    return _words32(rbg_keys_of(rbg_step_keys(seed, n_steps, "cpu"), max_depth)).contiguous().to(device)


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
    stream_rows=None,
):
    """Launch the CUDA NUTS kernel on the current stream, without
    synchronising. ``q0`` is a contiguous float32 CUDA tensor ``(D, N)``
    with ``D`` 8 or 16 for a hand-written body, the body's own ``d`` for a
    staged one (as far as the stacks fit), a staged body with chain operands
    bound to their block (``hmc.chain_operands``). The launch block is ``block_n`` chains (default
    ``DEFAULT_BLOCK``, at most ``MAX_BLOCK``); ``rng="counter"`` needs
    ``block_n``, which is then also the stream's chain block, and ``N`` a
    multiple of it. ``rng="rbg"`` launches the rbg kernel, which draws what
    ``nuts.nuts_sweep_cols(rng="rbg")`` draws from the int ``seed``, its
    keys from ``rbg_keys_table`` and the momentum's rows mapped by
    ``stream_rows`` (``hmc.rbg_rows_normal``). The body's variant taken is
    recorded on ``nuts_sweep.last_variant``.

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
    _check_dim(body, d)
    if rng not in _RNG_IDS:
        raise ValueError(f"rng must be 'philox', 'counter' or 'rbg', got {rng!r}")
    if rng == "counter" and block_n is None:
        raise ValueError("the counter stream needs its chain block: pass block_n")
    if stream_rows is not None and rng != "rbg":
        raise ValueError("stream_rows maps the rbg stream's rows: pass rng='rbg'")
    block = DEFAULT_BLOCK if block_n is None else block_n
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"block_n={block}: the kernel takes 1 to {MAX_BLOCK} chains a block")
    if rng == "counter" and n % block:
        raise ValueError(f"n_chains={n} is not a multiple of the chain block {block}")
    if n_steps < 0 or not 1 <= max_depth <= 30:
        raise ValueError("n_steps must be non-negative and max_depth in 1..30")
    variant = body.variant(d)
    chain, k = chain_operands(body, q0)
    consts = body.consts_on(q0.device)
    smem = smem_bytes(body, d, max_depth, block)
    lib = _lib_for(body, rng)
    device_index = q0.device.index if q0.device.index is not None else torch.cuda.current_device()
    limit = lib.nuts_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(f"could not read the shared-memory limit of CUDA device {device_index}")
    if smem > limit:
        raise ValueError(
            f"K4 needs {smem} B of shared memory per block at D={d}, max_depth={max_depth}, "
            f"block_n={block}; this card allows {limit} B per block "
            f"(cudaDevAttrMaxSharedMemoryPerBlockOptin). Lower block_n or max_depth."
        )
    inv_mass = _inv_mass_col(inv_mass, d, q0.device).reshape(d).contiguous()
    rbg_table = rbg_rows = None
    if rng == "rbg":
        rbg_table = rbg_keys_table(int(seed), n_steps, max_depth, q0.device)
        rbg_rows = rbg_rows_on(None if stream_rows is None else tuple(stream_rows), d, q0.device)
    q_out = torch.empty_like(q0)
    accepts = torch.empty(n, dtype=torch.float32, device=q0.device)
    leaps = torch.empty(n, dtype=torch.float32, device=q0.device)
    with torch.cuda.device(q0.device):
        err = lib.nuts_sweep(
            q0.data_ptr(), q_out.data_ptr(), accepts.data_ptr(), leaps.data_ptr(),
            inv_mass.data_ptr(), consts.data_ptr(), body.consts.data_ptr(), body.consts.numel(),
            body.kind, int(variant == "specialised"), d, n, body.n_obs, body.d_w,
            body.obs_scale, n_steps, eps, divergence_threshold, max_depth, _int32(seed),
            _RNG_IDS[rng], block, chain, k,
            rbg_table.data_ptr() if rbg_table is not None and rbg_table.numel() else None,
            rbg_keys_stride(max_depth), rbg_rows.data_ptr() if rbg_rows is not None else None,
            torch.cuda.current_stream(q0.device).cuda_stream,
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
    rng: str | None = None,
    stream_rows=None,
):
    """Run ``n_steps`` NUTS transitions on ``N`` column-layout chains.

    Backends, as for ``hmc.pallas_hmc``: ``"cuda"`` is the CUDA kernel
    (needs a CUDA ``q0``; the density's hand-written body, or the density
    staged into one, ``hmc.device_body``, which raises for a density that
    cannot be staged), ``"torch"`` the plain twin ``nuts.nuts_sweep_cols``,
    and ``"auto"`` (default) takes ``"cuda"`` for a CUDA ``q0`` and
    ``"torch"`` for a CPU one. ``interpret=True`` selects the
    counter stream (the port of the reference's interpret-mode PRNG) for
    chain block ``block_n``, which it needs; otherwise the kernel draws from
    Philox and the twin from a ``torch.Generator`` seeded with ``seed``. The
    backend taken is recorded on ``pallas_nuts.last_backend`` and the
    device body on ``pallas_nuts.last_body`` (None on the twin).
    ``rng="rbg"`` takes the rbg stream in the kernel and the twin alike, the
    draws of the reference's ``nuts_sweep_cols`` from the int ``seed``, the
    momentum's rows mapped by ``stream_rows``.

    Returns ``(q_final, accept_stat, mean_leapfrogs)``: the mean over chains
    and transitions of the accept statistic and of the leapfrog count.
    """
    backend = _route(backend, q0.device)
    if rng not in (None, "rbg"):
        raise ValueError(f"rng must be None (the stream interpret selects) or 'rbg', got {rng!r}")
    body = device_body(logdensity_cols, q0.shape[0], q0.device) if backend == "cuda" else None
    if backend == "cuda":
        q, accepts, leaps = nuts_sweep(
            body, q0.to(torch.float32).contiguous(), seed, n_steps=n_steps, eps=eps,
            max_depth=max_depth, inv_mass=inv_mass, rng=rng or ("counter" if interpret else "philox"),
            block_n=block_n, divergence_threshold=divergence_threshold, stream_rows=stream_rows,
        )
        out = q, accepts.mean() / n_steps, leaps.mean() / n_steps
    else:
        out = nuts_sweep_cols(
            logdensity_cols, q0, seed, n_steps=n_steps, eps=eps, max_depth=max_depth,
            inv_mass=inv_mass, rng=rng or ("counter" if interpret else "generator"), block_n=block_n,
            divergence_threshold=divergence_threshold, stream_rows=stream_rows,
        )
    pallas_nuts.last_backend = backend
    pallas_nuts.last_body = body.name if body is not None else None
    return out


pallas_nuts.last_backend = None
pallas_nuts.last_body = None


@staging_scope()
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
    rng: str | None = None,
):
    """Windowed warmup driven by NUTS's own accept statistic: per phase, a
    short NUTS sweep through ``pallas_nuts``'s routing (on the card one K4
    launch), a step-size nudge toward ``target_accept``, and the diagonal
    inverse mass from the cross-chain variance. Phase seeds
    ``(seed + 1) * 1_000_003 + phase`` are the reference's stream; ``rng``
    is ``pallas_nuts``'s, and with ``"rbg"`` each phase draws what the
    reference's ``warmup_column_nuts`` draws (K4's rbg kernel on the card),
    a ``seed`` outside the reference's int32 range raising as there
    (``hmc.phase_seed_base``). With
    ``mesh`` (a ``parallel.Mesh``), ``q0`` is this rank's shard of chains
    over ``axis`` and the phases adapt to every rank's chains; a row-sharded
    density whose columns are split over a chain axis adapts over that axis
    where no ``mesh`` is given.

    Returns ``(q, eps, inv_mass)``.
    """
    mesh, axis = chain_mesh(logdensity_cols, mesh, axis)
    base = phase_seed_base(seed, rng)

    def sweep(q, idx, eps, inv_mass):
        q, acc, _leaps = pallas_nuts(
            logdensity_cols, q, base + idx, n_steps=steps_per_phase, eps=eps,
            max_depth=max_depth, inv_mass=inv_mass, backend=backend, block_n=block_n, rng=rng,
        )
        return q, acc

    q, eps, inv_mass, _accs = windowed_warmup(
        sweep, q0.to(torch.float32), n_windows=n_phases, eps0=eps0, target_accept=target_accept,
        mesh=mesh, axis=axis,
    )
    return q, float(eps), inv_mass
