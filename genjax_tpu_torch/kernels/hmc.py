"""Fused MH-adjusted HMC sweep over column-layout chains.

Counterpart of ``genjax_tpu/kernels/hmc.py``. Positions are ``(D, N)``
float32 with chains on the last axis. Two paths:

- ``hmc_sweep``: the CUDA kernel (``csrc/hmc_sweep.cu``), one chain per
  thread with the whole sweep in registers, with a device body: a
  hand-written one (``kernels/bodies.py``) in its variant
  (``Body.variant``: the flagship's shape compiled with its constants as
  kernel parameters, or a runtime shape), or any other column density
  staged into one (``kernels/staged.py``), as the reference's kernel replays
  any density's jaxpr, with each chain's own chain operands where the staged
  body takes any (``chain_operands``). It replaces the Pallas TPU kernel
  ``_hmc_kernel`` and its PRNG helpers.
- ``_reference_hmc``: the plain torch twin, any column density, gradients
  from autograd.

``pallas_hmc`` routes between them. The random stream is the production
stream (Philox in the kernel, a ``torch.Generator`` in the twin, held in law),
the counter stream, the bit-exact port of the reference's interpret-mode
software PRNG, which makes the kernel, the twin and the reference's Pallas
kernel under ``interpret=True`` agree draw for draw for a given chain block
``block_n``, or the rbg stream: the draws of the reference's XLA twin
``_reference_hmc`` from ``jax.random.key(seed, impl="rbg")`` as JAX's CPU
backend makes them (``core/keys.py``), in the kernel and the twin alike.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from ..core import keys
from . import _build
from .adaptation import windowed_warmup
from .bodies import Body
from .rows import Rows, chain_mesh
from .staged import STAGED, staged_body_for, staging_scope

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


def _mom_std(inv_mass: torch.Tensor, rng: str) -> torch.Tensor:
    """The momentum's sd: ``1 / sqrt(M^-1)`` as the reference's XLA twins
    compute it on the rbg stream, ``sqrt(1 / M^-1)`` as its kernels do on
    the others."""
    return 1.0 / torch.sqrt(inv_mass) if rng == "rbg" else torch.sqrt(1.0 / inv_mass)


def rbg_step_keys(seed: int, n_steps: int, device) -> torch.Tensor:
    """The sweep's step keys on the rbg stream, ``split(key(seed, "rbg"),
    n_steps)``: ``(n_steps, 4)``."""
    return keys.split(keys.key(int(seed), device=device, impl="rbg"), n_steps)


def rbg_rows_normal(k: torch.Tensor, d: int, n: int, stream_rows=None) -> torch.Tensor:
    """``normal(k, (d_ref, n))`` of the reference's rows in a ``(d, n)``
    block: row ``i`` holds the reference's row ``stream_rows[i]``, or 0
    where that is negative (a padding row, which draws nothing); None is
    every row in order."""
    if stream_rows is None:
        return keys.normal(k, (d, n))
    src = torch.as_tensor(stream_rows, dtype=torch.int64, device=k.device)
    real = src >= 0
    draw = keys.normal(k, (int(real.sum()), n))
    out = torch.zeros((d, n), dtype=torch.float32, device=k.device)
    out[real] = draw[src[real]]
    return out


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
    stream_rows=None,
):
    """Plain torch twin of the kernel (same layout and move structure).

    ``inv_mass``: optional per-dimension inverse mass, shape (D,) or (D, 1).
    Momenta draw from N(0, M); the drift is ``eps * M^-1 p``.

    ``rng="generator"`` draws from a ``torch.Generator`` (the one given, or
    one on ``q0``'s device seeded with the int given). ``rng="counter"``
    reproduces the reference kernel's interpret-mode stream for chain block
    ``block_n``: momentum on salts ``4i``/``4i+1`` over ``(D, block)``, the
    accept uniform on salt ``4i+2`` over ``(1, block)``. ``rng="rbg"`` draws
    what the reference's twin draws from the int seed: step ``i`` splits the
    ``i``-th of ``split(key(seed, "rbg"), n_steps)`` into ``kp, ku``, the
    momentum ``normal(kp, (D, N))`` and the accept ``uniform(ku, (N,))``;
    ``stream_rows`` (that stream only) maps each row of ``q0`` to the
    reference's row it draws, a negative entry drawing nothing (a packed
    block's padding, ``rbg_rows_normal``).

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
    mom_std = _mom_std(inv_mass, rng)
    if stream_rows is not None and rng != "rbg":
        raise ValueError("stream_rows maps the rbg stream's rows: pass rng='rbg'")
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

    elif rng == "rbg":
        step_keys = rbg_step_keys(seed_or_generator, n_steps, device)

        def draws(i):
            kp, ku = keys.split(step_keys[i]).unbind(-2)
            z = rows.normal(lambda dd: rbg_rows_normal(kp, dd, n, stream_rows))
            return z, keys.uniform(ku, (n,))

    else:
        raise ValueError(f"rng must be 'generator', 'counter' or 'rbg', got {rng!r}")

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

_RNG_IDS = {"counter": 0, "philox": 1, "rbg": 2}

# threads a block of the CUDA sweep (the kernel's kThreads)
THREADS = 128


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(_build.load("hmc_sweep"))


def _lib_for(body, rng: str = "philox") -> ctypes.CDLL:
    """The build that holds ``body``'s kernel on stream ``rng``: the staged
    build of a staged body (its rbg build for ``"rbg"``), the package's own
    otherwise."""
    return _bind(body.lib(rng == "rbg")) if body.kind == STAGED else _lib()


@functools.cache
def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hmc_sweep.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, F, I, I, I, P, I, P, P, P]
    lib.hmc_sweep.restype = I
    lib.hmc_smem_limit.argtypes = [I]
    lib.hmc_smem_limit.restype = I
    lib.hmc_smem_bytes.argtypes = [I, I, I, I, I]
    lib.hmc_smem_bytes.restype = ctypes.c_long
    lib.hmc_kernel_info.argtypes = [I, I, I, I, I, I, P]
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


def kernel_info(body: Body, d: int, rng: str = "philox") -> dict:
    """The CUDA runtime's view of the sweep kernel ``body`` takes at ``D =
    d`` on stream ``rng`` (the rbg kernel for ``"rbg"``, the other streams'
    otherwise): registers a thread, local (spill) bytes a thread, and
    resident blocks an SM."""
    out = (ctypes.c_int * 3)()
    err = _lib_for(body, rng).hmc_kernel_info(
        d, body.kind, int(body.variant(d) == "specialised"), body.n_obs, body.d_w, int(rng == "rbg"), out
    )
    if err != 0:
        raise RuntimeError(f"hmc_kernel_info failed with CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2]}


def _int32(x: int) -> int:
    return ((int(x) + 2**31) & _M32) - 2**31


def _words32(k: torch.Tensor) -> torch.Tensor:
    """Key words in ``[0, 2**32)`` (int64) as the int32 tensor of the same
    bits, for a kernel that reads them as ``uint4``."""
    return (((k + 2**31) & _M32) - 2**31).to(torch.int32)


@functools.lru_cache(maxsize=64)
def rbg_keys_table(seed: int, n_steps: int, device) -> torch.Tensor:
    """K1's keys on the rbg stream, made on the host and kept on ``device``
    (a launch with the same seed copies nothing): ``(n_steps, 2, 4)`` int32,
    step ``i``'s ``kp, ku = split(split(key(seed, "rbg"), n_steps)[i])``."""
    return _words32(keys.split(rbg_step_keys(seed, n_steps, "cpu"))).contiguous().to(device)


@functools.lru_cache(maxsize=64)
def rbg_rows_on(stream_rows: tuple | None, d: int, device) -> torch.Tensor:
    """The kernel's ``(d,)`` int32 map from a launch row to the reference's
    row it draws on the rbg stream (-1: none), kept on ``device``; None is
    every row in order."""
    rows = list(range(d)) if stream_rows is None else [int(r) for r in stream_rows]
    if len(rows) != d or max(rows) >= d or len(set(r for r in rows if r >= 0)) != sum(r >= 0 for r in rows):
        raise ValueError(f"stream_rows must map each of the {d} launch rows to a distinct row, or -1, got {rows}")
    return torch.tensor(rows, dtype=torch.int32, device=device)


def chain_operands(body, q0: torch.Tensor) -> tuple[int, int]:
    """``(pointer, k)`` of the chain operands a launch of ``body`` on ``q0
    (D, N)`` passes: ``(0, 0)`` for a body that takes none, else the block
    the staged body is bound to (``StagedBody.bind``), which must be a
    contiguous float32 ``(k, N)`` tensor on ``q0``'s device."""
    k = getattr(body, "k", 0)
    if not k:
        return 0, 0
    c = body.chain
    if c is None:
        raise ValueError(f"the staged body takes k={k} chain operands a chain: bind it to its (k, N) block "
                         "(StagedBody.bind) before a launch")
    if c.device != q0.device:
        raise ValueError(f"the chain operands live on {c.device} and the chains on {q0.device}")
    if c.dtype != torch.float32:
        raise ValueError(f"the chain operands must be float32, got {c.dtype}")
    if tuple(c.shape) != (k, q0.shape[1]):
        raise ValueError(f"the chain operands must be a (k={k}, N={q0.shape[1]}) block, got {tuple(c.shape)}")
    if not c.is_contiguous():
        raise ValueError("the chain operands must be a contiguous (k, N) block")
    return c.data_ptr(), k


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
    stream_rows=None,
):
    """Launch the CUDA sweep kernel on the current stream, without
    synchronising. ``q0`` is a contiguous float32 CUDA tensor of shape
    ``(D, N)`` with ``D`` 8 or 16 for a hand-written body, the body's own
    ``d`` (1 to 64) for a staged one; a staged body with chain operands is
    bound to their ``(k, N)`` block (``chain_operands``). ``rng="counter"`` needs ``block_n``, the
    stream's chain block, which is independent of the launch block
    (``THREADS``). ``rng="rbg"`` launches the rbg kernel, which draws what
    ``_reference_hmc(rng="rbg")`` draws from the int ``seed``, its keys
    from ``rbg_keys_table`` and its rows mapped by ``stream_rows``
    (``rbg_rows_normal``; a staged body's rbg kernels are a build of their
    own). The body's variant taken is recorded on
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
    _check_dim(body, d)
    if rng not in _RNG_IDS:
        raise ValueError(f"rng must be 'philox', 'counter' or 'rbg', got {rng!r}")
    if rng == "counter" and block_n is None:
        raise ValueError("the counter stream needs its chain block: pass block_n")
    if stream_rows is not None and rng != "rbg":
        raise ValueError("stream_rows maps the rbg stream's rows: pass rng='rbg'")
    if n_steps < 0 or L < 0:
        raise ValueError("n_steps and L must be non-negative")
    variant = body.variant(d)
    smem = smem_bytes(body, d)
    lib = _lib_for(body, rng)
    device_index = q0.device.index if q0.device.index is not None else torch.cuda.current_device()
    limit = lib.hmc_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(f"could not read the shared-memory limit of CUDA device {device_index}")
    if smem > limit:
        raise ValueError(
            f"K1 needs {smem} B of shared memory per block for {body.name}'s {body.n_obs} x "
            f"{body.d_w} constants; this card allows {limit} B per block "
            f"(cudaDevAttrMaxSharedMemoryPerBlockOptin)"
        )
    chain, k = chain_operands(body, q0)
    inv_mass = _inv_mass_col(inv_mass, d, q0.device).reshape(d).contiguous()
    consts = body.consts_on(q0.device)
    rbg_keys = rbg_rows = None
    if rng == "rbg":
        rbg_keys = rbg_keys_table(int(seed), n_steps, q0.device)
        rbg_rows = rbg_rows_on(None if stream_rows is None else tuple(stream_rows), d, q0.device)
    q_out = torch.empty_like(q0)
    accepts = torch.empty(n, dtype=torch.float32, device=q0.device)
    with torch.cuda.device(q0.device):
        err = lib.hmc_sweep(
            q0.data_ptr(), q_out.data_ptr(), accepts.data_ptr(), inv_mass.data_ptr(),
            consts.data_ptr(), body.consts.data_ptr(), body.consts.numel(), body.kind,
            int(variant == "specialised"), d, n, body.n_obs, body.d_w, body.obs_scale,
            n_steps, L, eps, _int32(seed), _RNG_IDS[rng], block_n or 1, chain, k,
            rbg_keys.data_ptr() if rbg_keys is not None and rbg_keys.numel() else None,
            rbg_rows.data_ptr() if rbg_rows is not None else None,
            torch.cuda.current_stream(q0.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hmc_sweep kernel launch failed with CUDA error {err}")
    hmc_sweep_launches += 1
    hmc_sweep.last_variant = variant
    return q_out, accepts


hmc_sweep.last_variant = None


def _check_dim(body, d: int) -> None:
    """The packed dimensions a kernel takes with ``body``: 8 or 16 for a
    hand-written body (at least the body's own), the staged body's own D."""
    if body.kind == STAGED:
        if d != body.d:
            raise ValueError(f"D={d}: the staged body was staged at D={body.d}")
    elif d not in (8, 16) or d < body.min_dim():
        raise ValueError(f"D={d}: the kernel takes D in (8, 16) and {body.name} needs D >= {body.min_dim()}")


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


def _route(backend: str, device: torch.device) -> str:
    """The backend a sampler takes for chains on ``device``: on the card
    ``"auto"`` is the kernel, since every caller has a device body there
    (``pallas_hmc`` and ``pallas_nuts`` through ``device_body``, the trace
    path's shared launch through ``inference/mcmc.py``), or raises making
    one; on the CPU it is the twin."""
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"backend must be 'auto', 'cuda' or 'torch', got {backend!r}")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return backend


def device_body(logdensity_cols: Callable, d: int, device) -> Body:
    """The device body the CUDA sweeps run for ``logdensity_cols`` at ``D =
    d``: its hand-written ``.body`` where it has one, else the density
    staged into one (``staged.staged_body_for``, traced on ``device``: once
    a call of ``column_hmc``/``warmup_column`` or their NUTS kin, which
    open a ``staged.staging_scope``, and at every call elsewhere), which
    raises for a density outside the staged op set. Nothing falls back to
    the twin."""
    body = getattr(logdensity_cols, "body", None)
    return body if body is not None else staged_body_for(logdensity_cols, d, device)


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
    rng: str | None = None,
    stream_rows=None,
):
    """Run ``n_steps`` of MH-adjusted HMC on ``N`` column-layout chains.

    Backends:

    - ``"cuda"``: the CUDA sweep kernel; needs a CUDA ``q0``. It runs the
      density's hand-written body (``logdensity_cols.body``) where there is
      one, else the density staged into a device body (``device_body``),
      and raises for a density that cannot be staged.
    - ``"torch"``: the plain twin ``_reference_hmc``.
    - ``"auto"`` (default): ``"cuda"`` for a CUDA ``q0``, ``"torch"`` for a
      CPU ``q0``: the twin runs on the card only when asked for with
      ``backend="torch"``.

    ``interpret`` keeps the reference's signature but selects a random
    stream, not an interpret mode: ``interpret=True`` is the counter stream
    (``rng="counter"`` of ``hmc_sweep`` and ``_reference_hmc``), the port of
    the reference's interpret-mode PRNG, for chain block ``block_n``
    (required). Otherwise the kernel draws from Philox and the twin from a
    ``torch.Generator`` seeded with ``seed``. The backend taken is recorded
    on ``pallas_hmc.last_backend``, and the device body the kernel ran on
    ``pallas_hmc.last_body`` (``"iid_normal"``, ``"hier_regression"`` or
    ``"staged"``; None on the twin). ``rng="rbg"`` takes the rbg stream in
    the kernel and the twin alike, the draws of the reference's XLA twin
    from the int ``seed``, the momentum's rows mapped by ``stream_rows``
    (``rbg_rows_normal``).

    Returns ``(q_final, accept_rate)``: positions ``(D, N)`` and the mean
    acceptance rate over chains and steps.
    """
    backend = _route(backend, q0.device)
    if rng not in (None, "rbg"):
        raise ValueError(f"rng must be None (the stream interpret selects) or 'rbg', got {rng!r}")
    body = device_body(logdensity_cols, q0.shape[0], q0.device) if backend == "cuda" else None
    if backend == "cuda":
        q, accepts = hmc_sweep(
            body, q0.to(torch.float32).contiguous(), seed, n_steps=n_steps, eps=eps,
            L=L, inv_mass=inv_mass, rng=rng or ("counter" if interpret else "philox"),
            block_n=block_n, stream_rows=stream_rows,
        )
        out = q, accepts.mean() / n_steps
    else:
        out = _reference_hmc(
            logdensity_cols, q0, seed, n_steps=n_steps, eps=eps, L=L,
            inv_mass=inv_mass, rng=rng or ("counter" if interpret else "generator"),
            block_n=block_n, stream_rows=stream_rows,
        )
    pallas_hmc.last_backend = backend
    pallas_hmc.last_body = body.name if body is not None else None
    return out


pallas_hmc.last_backend = None
pallas_hmc.last_body = None


def phase_seed_base(seed: int, rng: str | None) -> int:
    """``(seed + 1) * 1_000_003``, the warmups' phase seeds less the phase
    index. The reference adds the index inside ``jit``, which takes this
    Python int as an int32: on the rbg stream (the reference's draws) a base
    outside int32 (``seed`` past 2146, or below -2148) raises the
    ``OverflowError`` the reference raises; the other streams keep its low
    32 bits."""
    base = (int(seed) + 1) * 1_000_003
    if rng == "rbg" and not -(2**31) <= base < 2**31:
        raise OverflowError(
            f"the warmup's phase seeds (seed + 1) * 1_000_003 + phase are int32, as the reference's: "
            f"seed={seed} gives {base}, outside int32 (seeds -2148 to 2146 fit)"
        )
    return base


@staging_scope()
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
    rng: str | None = None,
):
    """Windowed warmup for the column layout (``adaptation.windowed_warmup``):
    per phase, a short HMC sweep through ``pallas_hmc``'s routing (on the
    card one launch of the sweep kernel), a step-size nudge toward
    ``target_accept``, and the diagonal inverse mass from the cross-chain
    variance.

    Phase seeds ``(seed + 1) * 1_000_003 + phase`` are the reference's
    stream, disjoint from the main sweep's ``seed``. ``rng`` is
    ``pallas_hmc``'s: with ``"rbg"`` each phase draws what the reference's
    ``warmup_column`` draws from ``key(phase_seed, "rbg")`` (K1's rbg kernel
    on the card, the twin elsewhere), and a ``seed`` whose ``(seed + 1) *
    1_000_003`` leaves int32 raises the ``OverflowError`` the reference's
    jitted phase index raises (``phase_seed_base``).

    With ``mesh`` (a ``parallel.Mesh``), ``q0`` is this rank's shard of
    chains over ``axis`` and the windows adapt to every rank's chains.

    A row-sharded density whose columns are split over a chain axis adapts
    over that axis where no ``mesh`` is given.

    Returns ``(q, eps, inv_mass)`` ready for the main sweep.
    """
    mesh, axis = chain_mesh(logdensity_cols, mesh, axis)
    base = phase_seed_base(seed, rng)

    def sweep(q, idx, eps, inv_mass):
        return pallas_hmc(
            logdensity_cols, q, base + idx, n_steps=steps_per_phase,
            eps=eps, L=L, inv_mass=inv_mass, backend=backend, rng=rng,
        )

    q, eps, inv_mass, _accs = windowed_warmup(
        sweep, q0.to(torch.float32), n_windows=n_phases, eps0=eps0, target_accept=target_accept,
        mesh=mesh, axis=axis,
    )
    return q, float(eps), inv_mass
