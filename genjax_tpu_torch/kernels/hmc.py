"""Fused MH-adjusted HMC sweep over column-layout chains.

Counterpart of ``genjax_tpu/kernels/hmc.py``. Positions are ``(D, N)``
float32 with chains on the last axis. Two paths:

- ``hmc_sweep``: the CUDA kernel (``csrc/hmc_sweep.cu``), one chain per
  thread with the whole sweep in registers, for densities that carry a
  hand-written device body (``kernels/bodies.py``), in the body's variant
  (``Body.variant``: the flagship's shape compiled with its constants as
  kernel parameters, or a runtime shape). It replaces the Pallas TPU kernel
  ``_hmc_kernel`` and its PRNG helpers.
- ``_reference_hmc``: the plain torch twin, any column density, gradients
  from autograd.

``pallas_hmc`` routes between them. The random stream is either the
production stream (Philox in the kernel, a ``torch.Generator`` in the twin,
held in law) or the counter stream, the bit-exact port of the reference's
interpret-mode software PRNG, which makes the kernel, the twin and the
reference's Pallas kernel under ``interpret=True`` agree draw for draw for a
given chain block ``block_n``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from . import _build
from .adaptation import windowed_warmup
from .bodies import Body
from .rows import Rows, chain_mesh

_TWO_PI = 6.283185307179586
_M32 = 0xFFFFFFFF
_BLOCK_MIX = 0x3504F333

# launches of the CUDA sweep kernel in this process
hmc_sweep_launches = 0


# ----------------------------------------------------------------------
# K2: the counter stream, in int64 with 32-bit masking (torch has no uint32
# shifts on the CPU). Values are uint32 held in int64 tensors.
# ----------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``0 <= x < 2**32``, without int64 overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & _M32


def _block_base(seed: int, block) -> int | torch.Tensor:
    """``seed + block * 0x3504F333`` in int32 wraparound, as uint32."""
    return (seed + block * _BLOCK_MIX) & _M32


def _sw_rand_bits_factory(base, col=None):
    """The reference's counter-based software PRNG: bits are a pure function
    of (base, salt, row, column) through two murmur3 finalizer rounds.
    ``base`` is an int or an int64 tensor over the columns; ``col`` defaults
    to the column index within the draw; ``salt`` is an int or an int64
    tensor over the columns (NUTS advances it per chain block)."""

    def rand_bits(shape, salt):
        device = base.device if isinstance(base, torch.Tensor) else None
        if len(shape) == 2:
            r = torch.arange(shape[0], dtype=torch.int64, device=device)[:, None]
        else:
            r = torch.zeros((), dtype=torch.int64, device=device)
        c = col if col is not None else torch.arange(shape[-1], dtype=torch.int64, device=device)
        salt = salt if isinstance(salt, torch.Tensor) else int(salt)
        x = base ^ ((salt * 0x9E3779B1) & _M32)
        x = (x + _mul32(r, 0x85EBCA77) + _mul32(c, 0xC2B2AE3D)) & _M32
        for _ in range(2):
            x = x ^ (x >> 16)
            x = _mul32(x, 0x85EBCA6B)
            x = x ^ (x >> 13)
            x = _mul32(x, 0xC2B2AE35)
            x = x ^ (x >> 16)
        return torch.broadcast_to(x, tuple(shape))

    return rand_bits


def _uniform_01(rand_bits, shape, salt) -> torch.Tensor:
    """Uniform in (0, 1) from the top 24 bits, with a half-step offset."""
    hi24 = (rand_bits(shape, salt) >> 8).to(torch.float32)
    return hi24 * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def _normal(rand_bits, shape, salt) -> torch.Tensor:
    """Standard normals via Box-Muller on salts ``salt`` and ``salt + 1``."""
    u1 = _uniform_01(rand_bits, shape, salt)
    u2 = _uniform_01(rand_bits, shape, salt + 1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def _counter_stream(seed: int, n: int, block_n: int, device):
    """``rand_bits`` over all ``n`` chains: chain ``i`` is column
    ``i % block_n`` of chain block ``i // block_n``."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return _sw_rand_bits_factory(_block_base(int(seed) & _M32, idx // block_n), idx % block_n)


# ----------------------------------------------------------------------
# the plain twin
# ----------------------------------------------------------------------


def _inv_mass_col(inv_mass, d: int, device) -> torch.Tensor:
    if inv_mass is None:
        return torch.ones((d, 1), dtype=torch.float32, device=device)
    return torch.as_tensor(inv_mass, dtype=torch.float32, device=device).reshape(d, 1)


def _lp_grad(logdensity_cols: Callable, q: torch.Tensor):
    """``(lp (N,), grad (D, N))`` by autograd. One backward of ``lp.sum()``
    gives every chain's gradient at once: chains are independent, so column
    ``j`` of the gradient is ``d lp[j] / d q[:, j]``."""
    with torch.enable_grad():
        q = q.detach().requires_grad_(True)
        lp = logdensity_cols(q)
        (g,) = torch.autograd.grad(lp.sum(), q)
    return lp.detach(), g


def _reference_hmc(
    logdensity_cols: Callable,
    q0: torch.Tensor,
    seed_or_generator,
    *,
    n_steps: int,
    eps: float,
    L: int,
    inv_mass=None,
    rng: str = "generator",
    block_n: int | None = None,
):
    """Plain torch twin of the kernel (same layout and move structure).

    ``inv_mass``: optional per-dimension inverse mass, shape (D,) or (D, 1).
    Momenta draw from N(0, M); the drift is ``eps * M^-1 p``.

    ``rng="generator"`` draws from a ``torch.Generator`` (the one given, or
    one on ``q0``'s device seeded with the int given). ``rng="counter"``
    reproduces the reference kernel's interpret-mode stream for chain block
    ``block_n``: momentum on salts ``4i``/``4i+1`` over ``(D, block)``, the
    accept uniform on salt ``4i+2`` over ``(1, block)``.

    A row-sharded density (``.row_shard``, ``kernels/rows.py``): ``q0`` is
    this rank's block, each kinetic energy is one sum over the model axis,
    the momenta are this rank's rows of the full-height draw every model
    rank makes alike, and the accept rate is the mean over every chain of
    the mesh.

    Returns ``(q, accept_rate)``.
    """
    d, n = q0.shape
    device = q0.device
    rows = Rows(logdensity_cols, d)
    seed_or_generator = rows.seed(seed_or_generator)
    inv_mass = _inv_mass_col(inv_mass, d, device)
    mom_std = torch.sqrt(1.0 / inv_mass)
    if rng == "counter":
        if block_n is None:
            raise ValueError("the counter stream needs its chain block: pass block_n")
        bits = _counter_stream(int(seed_or_generator), n, block_n, device)

        def draws(i):
            z = rows.normal(lambda dd: _normal(bits, (dd, n), 4 * i))
            return z, _uniform_01(bits, (n,), 4 * i + 2)

    elif rng == "generator":
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(gen))

        def draws(i):
            z = rows.normal(lambda dd: torch.randn((dd, n), generator=gen, device=device))
            return z, torch.rand((n,), generator=gen, device=device)

    else:
        raise ValueError(f"rng must be 'generator' or 'counter', got {rng!r}")

    def kinetic(p):
        return 0.5 * rows.sum(inv_mass * p * p)

    q = q0.to(torch.float32)
    lp, g = _lp_grad(logdensity_cols, q)
    accepted = torch.zeros(n, dtype=torch.float32, device=device)
    for i in range(n_steps):
        z, u = draws(i)
        p = mom_std * z
        ke0 = kinetic(p)
        q_new, g_new, lp_new = q, g, lp
        for _ in range(L):
            p = p + (eps / 2.0) * g_new
            q_new = q_new + eps * inv_mass * p
            lp_new, g_new = _lp_grad(logdensity_cols, q_new)
            p = p + (eps / 2.0) * g_new
        log_alpha = (lp_new - kinetic(p)) - (lp - ke0)
        accept = torch.log(u) < log_alpha  # NaN or -inf log_alpha rejects
        q = torch.where(accept, q_new, q)
        lp = torch.where(accept, lp_new, lp)
        g = torch.where(accept, g_new, g)
        accepted += accept.to(torch.float32)
    return q, rows.chain_mean(accepted.mean() / n_steps)


# ----------------------------------------------------------------------
# the CUDA kernel
# ----------------------------------------------------------------------

_RNG_IDS = {"counter": 0, "philox": 1}

# threads a block of the CUDA sweep (the kernel's kThreads)
THREADS = 128


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("hmc_sweep")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hmc_sweep.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, F, I, I, I, P]
    lib.hmc_sweep.restype = I
    lib.hmc_smem_limit.argtypes = [I]
    lib.hmc_smem_limit.restype = I
    lib.hmc_smem_bytes.argtypes = [I, I, I, I, I]
    lib.hmc_smem_bytes.restype = ctypes.c_long
    lib.hmc_kernel_info.argtypes = [I, I, I, I, I, P]
    lib.hmc_kernel_info.restype = I
    lib.counter_stream.argtypes = [P, P, P, I, I, I, I, I, P]
    lib.counter_stream.restype = I
    return lib


def smem_bytes(body: Body, d: int) -> int:
    """Dynamic shared memory of one sweep block: the body's constants (``X``
    and ``y``, to a float4) in the generic variant, then ``eps * M^-1``,
    ``M^-1`` and the momentum sd. Above 48 KiB the launch opts in to more,
    up to the card's limit."""
    return 4 * (body.shared_consts_floats(d) + 3 * d)


def kernel_info(body: Body, d: int) -> dict:
    """The CUDA runtime's view of the sweep kernel ``body`` takes at ``D =
    d``: registers a thread, local (spill) bytes a thread, and resident
    blocks an SM."""
    out = (ctypes.c_int * 3)()
    err = _lib().hmc_kernel_info(
        d, body.kind, int(body.variant(d) == "specialised"), body.n_obs, body.d_w, out
    )
    if err != 0:
        raise RuntimeError(f"hmc_kernel_info failed with CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2]}


def _int32(x: int) -> int:
    return ((int(x) + 2**31) & _M32) - 2**31


def hmc_sweep(
    body: Body,
    q0: torch.Tensor,
    seed: int,
    *,
    n_steps: int,
    eps: float,
    L: int,
    inv_mass=None,
    rng: str = "philox",
    block_n: int | None = None,
):
    """Launch the CUDA sweep kernel on the current stream, without
    synchronising. ``q0`` is a contiguous float32 CUDA tensor of shape
    ``(D, N)`` with ``D`` 8 or 16. ``rng="counter"`` needs ``block_n``, the
    stream's chain block, which is independent of the launch block
    (``THREADS``). The body's variant taken is recorded on
    ``hmc_sweep.last_variant``.

    Returns ``(q, accepts)``: positions ``(D, N)`` and per-chain accepted
    step counts ``(N,)``.
    """
    global hmc_sweep_launches
    if not (isinstance(q0, torch.Tensor) and q0.is_cuda):
        raise ValueError("hmc_sweep takes a CUDA tensor")
    if q0.dtype != torch.float32 or q0.ndim != 2 or not q0.is_contiguous():
        raise ValueError(
            f"hmc_sweep takes a contiguous float32 (D, N) tensor, got "
            f"{q0.dtype} {tuple(q0.shape)} contiguous={q0.is_contiguous()}"
        )
    d, n = q0.shape
    if d not in (8, 16) or d < body.min_dim():
        raise ValueError(f"D={d}: the kernel takes D in (8, 16) and {body.name} needs D >= {body.min_dim()}")
    if rng not in _RNG_IDS:
        raise ValueError(f"rng must be 'philox' or 'counter', got {rng!r}")
    if rng == "counter" and block_n is None:
        raise ValueError("the counter stream needs its chain block: pass block_n")
    if n_steps < 0 or L < 0:
        raise ValueError("n_steps and L must be non-negative")
    variant = body.variant(d)
    smem = smem_bytes(body, d)
    device_index = q0.device.index if q0.device.index is not None else torch.cuda.current_device()
    limit = _lib().hmc_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(f"could not read the shared-memory limit of CUDA device {device_index}")
    if smem > limit:
        raise ValueError(
            f"K1 needs {smem} B of shared memory per block for {body.name}'s {body.n_obs} x "
            f"{body.d_w} constants; this card allows {limit} B per block "
            f"(cudaDevAttrMaxSharedMemoryPerBlockOptin)"
        )
    inv_mass = _inv_mass_col(inv_mass, d, q0.device).reshape(d).contiguous()
    consts = body.consts_on(q0.device)
    q_out = torch.empty_like(q0)
    accepts = torch.empty(n, dtype=torch.float32, device=q0.device)
    with torch.cuda.device(q0.device):
        err = _lib().hmc_sweep(
            q0.data_ptr(), q_out.data_ptr(), accepts.data_ptr(), inv_mass.data_ptr(),
            consts.data_ptr(), body.consts.data_ptr(), consts.numel(), body.kind,
            int(variant == "specialised"), d, n, body.n_obs, body.d_w, body.obs_scale,
            n_steps, L, eps, _int32(seed), _RNG_IDS[rng], block_n or 1,
            torch.cuda.current_stream(q0.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hmc_sweep kernel launch failed with CUDA error {err}")
    hmc_sweep_launches += 1
    hmc_sweep.last_variant = variant
    return q_out, accepts


hmc_sweep.last_variant = None


def counter_stream_cuda(seed: int, block: int, salt: int, shape, device):
    """The kernel's counter stream for one chain block, from a debug launch:
    ``(bits as int64, uniforms, normals)`` over ``shape`` (1-D or 2-D)."""
    rows, cols = (shape[0], shape[1]) if len(shape) == 2 else (0, shape[0])
    total = max(rows, 1) * cols
    bits = torch.empty(total, dtype=torch.int32, device=device)
    uniforms = torch.empty(total, dtype=torch.float32, device=device)
    normals = torch.empty(total, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _lib().counter_stream(
            bits.data_ptr(), uniforms.data_ptr(), normals.data_ptr(), _int32(seed),
            int(block), int(salt), rows, cols, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"counter_stream kernel launch failed with CUDA error {err}")
    bits = bits.to(torch.int64) & _M32
    return bits.reshape(shape), uniforms.reshape(shape), normals.reshape(shape)


# ----------------------------------------------------------------------
# routing
# ----------------------------------------------------------------------


def _route(backend: str, device: torch.device, has_body: bool) -> str:
    """The backend ``pallas_hmc`` takes for chains on ``device``."""
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"backend must be 'auto', 'cuda' or 'torch', got {backend!r}")
    on_card = device.type == "cuda"
    if backend == "auto":
        if not on_card:
            return "torch"
        if not has_body:
            raise ValueError(
                "chains on the card need a density with a device body (.body, "
                "kernels/bodies.py) for the CUDA sweep kernel; this density has none. "
                "Pass backend='torch' to run the plain torch twin on the card."
            )
        return "cuda"
    if backend == "cuda" and not has_body:
        raise ValueError("backend='cuda' needs a density with a device body (.body)")
    return backend


def pallas_hmc(
    logdensity_cols: Callable,
    q0: torch.Tensor,
    seed: int,
    *,
    n_steps: int,
    eps: float,
    L: int,
    block_n: int | None = None,
    interpret: bool = False,
    backend: str = "auto",
    inv_mass=None,
):
    """Run ``n_steps`` of MH-adjusted HMC on ``N`` column-layout chains.

    Backends:

    - ``"cuda"``: the CUDA sweep kernel; needs a CUDA ``q0`` and a density
      with a device body (``logdensity_cols.body``).
    - ``"torch"``: the plain twin ``_reference_hmc``.
    - ``"auto"`` (default): ``"cuda"`` for a CUDA ``q0``, ``"torch"`` for a
      CPU ``q0``. A CUDA ``q0`` whose density has no body raises: the twin
      runs on the card only when asked for with ``backend="torch"``.

    ``interpret`` keeps the reference's signature but selects a random
    stream, not an interpret mode: ``interpret=True`` is the counter stream
    (``rng="counter"`` of ``hmc_sweep`` and ``_reference_hmc``), the port of
    the reference's interpret-mode PRNG, for chain block ``block_n``
    (required). Otherwise the kernel draws from Philox and the twin from a
    ``torch.Generator`` seeded with ``seed``. The backend taken is recorded
    on ``pallas_hmc.last_backend``.

    Returns ``(q_final, accept_rate)``: positions ``(D, N)`` and the mean
    acceptance rate over chains and steps.
    """
    body = getattr(logdensity_cols, "body", None)
    backend = _route(backend, q0.device, body is not None)
    if backend == "cuda":
        q, accepts = hmc_sweep(
            body, q0.to(torch.float32).contiguous(), seed, n_steps=n_steps, eps=eps,
            L=L, inv_mass=inv_mass, rng="counter" if interpret else "philox",
            block_n=block_n,
        )
        out = q, accepts.mean() / n_steps
    else:
        out = _reference_hmc(
            logdensity_cols, q0, seed, n_steps=n_steps, eps=eps, L=L,
            inv_mass=inv_mass, rng="counter" if interpret else "generator",
            block_n=block_n,
        )
    pallas_hmc.last_backend = backend
    return out


pallas_hmc.last_backend = None


def warmup_column(
    logdensity_cols: Callable,
    q0: torch.Tensor,
    seed: int,
    *,
    n_phases: int = 6,
    steps_per_phase: int = 25,
    eps0: float = 0.1,
    L: int = 5,
    target_accept: float = 0.8,
    backend: str = "auto",
    mesh=None,
    axis: str = "batch",
):
    """Windowed warmup for the column layout (``adaptation.windowed_warmup``):
    per phase, a short HMC sweep through ``pallas_hmc``'s routing (on the
    card one launch of the sweep kernel), a step-size nudge toward
    ``target_accept``, and the diagonal inverse mass from the cross-chain
    variance.

    Phase seeds ``(seed + 1) * 1_000_003 + phase`` are the reference's
    stream, disjoint from the main sweep's ``seed``.

    With ``mesh`` (a ``parallel.Mesh``), ``q0`` is this rank's shard of
    chains over ``axis`` and the windows adapt to every rank's chains.

    A row-sharded density whose columns are split over a chain axis adapts
    over that axis where no ``mesh`` is given.

    Returns ``(q, eps, inv_mass)`` ready for the main sweep.
    """
    mesh, axis = chain_mesh(logdensity_cols, mesh, axis)

    def sweep(q, idx, eps, inv_mass):
        return pallas_hmc(
            logdensity_cols, q, (seed + 1) * 1_000_003 + idx, n_steps=steps_per_phase,
            eps=eps, L=L, inv_mass=inv_mass, backend=backend,
        )

    q, eps, inv_mass, _accs = windowed_warmup(
        sweep, q0.to(torch.float32), n_windows=n_phases, eps0=eps0, target_accept=target_accept,
        mesh=mesh, axis=axis,
    )
    return q, float(eps), inv_mass
