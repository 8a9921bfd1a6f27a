"""Column log-densities staged into a device body of the CUDA sweeps.

The reference's Pallas kernels take any column log-density written in
``jnp``: ``pallas_hmc`` and ``pallas_nuts`` stage it with
``jax.make_jaxpr``, hoist its constants into kernel inputs and replay the
jaxpr, with its VJP, inside the kernel body
(``genjax_tpu/kernels/hmc.py:314-347``, ``nuts_pallas.py:365-382``). CUDA
has no autodiff and no jaxpr interpreter, so the port compiles the density
instead. ``stage_body(logdensity_cols, d)``:

1. traces ``q -> (lp, grad)`` of the column density ``(d, N) -> (N,)``
   with ``make_fx`` on its VJP, at two chain extents that are primes
   (``CHAIN_EXTENTS``): a node's chain axis is the dimension whose extent
   follows the trace's, which neither vmap's moved batch axes nor a model
   dimension of the same size can hide;
2. folds every node that does not depend on ``q`` at stage time (its value
   from the trace, float32); what the chain-dependent nodes read of them
   becomes the hoisted constants (``StagedBody.consts``), the counterpart of
   ``closed.consts`` at ``hmc.py:321``, or a literal where the graph itself
   wrote the number;
3. lowers the chain-dependent nodes to a per-chain program over float32 and
   bool arrays (``Program``): a node of shape ``(k..., N)`` is ``k...``
   values a chain, layout ops are strided views, elementwise ops are maps,
   reductions and ``mm`` over model axes are loops;
4. prints the program as one ``__host__ __device__`` function (``header``),
   which ``kernels/_build.py::load_staged`` compiles with ``nvcc`` into K1
   and K4 (``csrc/column_common.cuh``, body id ``kStaged``).

The op set is the aten counterpart of the reference's ``_PALLAS_SAFE_PRIMS``
(``genjax_tpu/kernels/hmc.py:172-183``): elementwise arithmetic and
transcendental ops, comparisons, logical ops and ``where``; sum, max, min
and log-sum-exp reductions; static slices and selects, reshapes,
transposes, broadcasts and casts; plus ``mm`` and its kin (``dot_general``)
and the ops the gradient trace itself emits (``*_backward`` of static
slicing and of the activations, ``ones_like``, ``full``, ``expand``). The
stager raises a ``ValueError`` naming the aten op and ``backend='torch'``
for an op outside the set, a data-dependent read, a reduction over the
chain axis or a product that contracts it, a constant that carries the
chain axis, a row-sharded density (``.row_shard``) or one that issues a
collective (``.collective_axis``, or a ``c10d`` op in its trace), and a
dimension outside ``1..MAX_D``.

``StagedBody.lp_grad`` interprets the lowered program, the same op list the
emitter prints, with torch: the plain version of the staged device body,
used by the CPU tests. Like ``bodies.Body``, a ``StagedBody`` is itself a
column density whose ``.body`` is itself.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
import math
import operator
from typing import Any, Callable

import numpy as np
import torch

# two chain extents, primes, at which the density is traced
CHAIN_EXTENTS = (251, 241)
# K1 takes any D in 1..MAX_D in a staged build (K4: as far as its stacks fit)
MAX_D = 64
# hoisted constants up to this many bytes are copied into shared memory at
# block start; more are read from global memory through __ldg
SMEM_CAP_BYTES = 16384
# an instruction of at most this many iterations is unrolled
UNROLL_LIMIT = 512

STAGED = 2  # the body id (csrc/column_common.cuh: kStaged)


def _refuse(what: str) -> ValueError:
    return ValueError(
        f"stage_body: {what}; the CUDA sweep kernels cannot run this density. "
        "Pass backend='torch' to run the plain torch twin on the card."
    )


# ----------------------------------------------------------------------
# the lowered program
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Opd:
    """An operand: ``kind`` ``"q"`` (the position), ``"v"`` (per-chain array
    ``idx``), ``"c"`` (the constants buffer), ``"g"`` (the gradient output),
    ``"lp"`` (the log-density output) or ``"lit"`` (the literal ``value``);
    ``offset`` and ``strides`` address it over the instruction's loop
    indices. ``dtype`` is ``"f"`` or ``"b"``."""

    kind: str
    idx: int = 0
    offset: int = 0
    strides: tuple = ()
    dtype: str = "f"
    value: Any = None


# map ops: arity, torch function, C expression over {0}, {1}, {2}
_MAP = {
    "copy": (1, lambda a: a, "{0}"),
    "to_f": (1, lambda a: a.to(torch.float32), "({0} ? 1.0f : 0.0f)"),
    "to_b": (1, lambda a: a != 0, "({0} != 0.0f)"),
    "neg": (1, torch.neg, "(-{0})"),
    "recip": (1, torch.reciprocal, "(1.0f / {0})"),
    "exp": (1, torch.exp, "expf({0})"),
    "log": (1, torch.log, "logf({0})"),
    "log1p": (1, torch.log1p, "log1pf({0})"),
    "expm1": (1, torch.expm1, "expm1f({0})"),
    "sqrt": (1, torch.sqrt, "sqrtf({0})"),
    "rsqrt": (1, torch.rsqrt, "(1.0f / sqrtf({0}))"),
    "abs": (1, torch.abs, "fabsf({0})"),
    "sign": (1, torch.sign, "gjt_sign({0})"),
    "tanh": (1, torch.tanh, "tanhf({0})"),
    "sigmoid": (1, torch.sigmoid, "(1.0f / (1.0f + expf(-{0})))"),
    "sin": (1, torch.sin, "sinf({0})"),
    "cos": (1, torch.cos, "cosf({0})"),
    "tan": (1, torch.tan, "tanf({0})"),
    "erf": (1, torch.erf, "erff({0})"),
    "erfc": (1, torch.erfc, "erfcf({0})"),
    "relu": (1, torch.relu, "gjt_relu({0})"),
    "square": (1, lambda a: a * a, "({0} * {0})"),
    "cube": (1, lambda a: a * a * a, "({0} * {0} * {0})"),
    "isnan": (1, torch.isnan, "({0} != {0})"),
    "isinf": (1, torch.isinf, "(fabsf({0}) == INFINITY)"),
    "not": (1, torch.logical_not, "(!{0})"),
    "add": (2, torch.add, "({0} + {1})"),
    "sub": (2, torch.sub, "({0} - {1})"),
    "mul": (2, torch.mul, "({0} * {1})"),
    "div": (2, torch.div, "({0} / {1})"),
    "pow": (2, torch.pow, "powf({0}, {1})"),
    "max": (2, torch.maximum, "gjt_max({0}, {1})"),
    "min": (2, torch.minimum, "gjt_min({0}, {1})"),
    "gt": (2, torch.gt, "({0} > {1})"),
    "ge": (2, torch.ge, "({0} >= {1})"),
    "lt": (2, torch.lt, "({0} < {1})"),
    "le": (2, torch.le, "({0} <= {1})"),
    "eq": (2, torch.eq, "({0} == {1})"),
    "ne": (2, torch.ne, "({0} != {1})"),
    "and": (2, torch.logical_and, "({0} && {1})"),
    "or": (2, torch.logical_or, "({0} || {1})"),
    "xor": (2, torch.logical_xor, "({0} != {1})"),
    "sigmoid_bwd": (2, lambda g, y: g * (1.0 - y) * y, "({0} * ((1.0f - {1}) * {1}))"),
    "tanh_bwd": (2, lambda g, y: g * (1.0 - y * y), "({0} * (1.0f - {1} * {1}))"),
    "where": (3, torch.where, "({0} ? {1} : {2})"),
    "clamp": (3, lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi), "gjt_min(gjt_max({0}, {1}), {2})"),
    "threshold_bwd": (3, lambda g, x, t: torch.where(x <= t, torch.zeros_like(g), g), "(({1} <= {2}) ? 0.0f : {0})"),
    "softplus": (3, lambda x, b, t: torch.where(x * b > t, x, torch.log1p(torch.exp(x * b)) / b),
                 "(({0} * {1} > {2}) ? {0} : log1pf(expf({0} * {1})) / {1})"),
}
_MAP["logsigmoid"] = (1, torch.nn.functional.logsigmoid, "(fminf({0}, 0.0f) - log1pf(expf(-fabsf({0}))))")
_MAP["logsigmoid_bwd"] = (2, lambda g, x: g / (1.0 + torch.exp(x)), "({0} / (1.0f + expf({1})))")
# four operands: softplus_backward(g, x, beta, threshold)
_MAP["softplus_bwd"] = (
    4,
    lambda g, x, b, t: torch.where(x * b > t, g, g * (1.0 - 1.0 / (1.0 + torch.exp(x * b)))),
    "(({1} * {2} > {3}) ? {0} : {0} * (1.0f - 1.0f / (1.0f + expf({1} * {2}))))",
)
# map ops that count no operation in the bound (copies and casts)
_FREE = {"copy", "to_f", "to_b"}


@dataclasses.dataclass
class Program:
    """A per-chain program: ``arrays`` (size, dtype) per chain, ``instrs``
    over them, the constants buffer ``consts`` (float32), and ``d``."""

    d: int
    arrays: list
    instrs: list
    consts: torch.Tensor

    @property
    def flop(self) -> int:
        """Operations of one ``(lp, grad)``: an element of a map 1 (a
        transcendental too), of a reduction 1 (log-sum-exp 3), of a product
        2 (an FMA); copies, casts and fills none."""
        total = 0
        for ins in self.instrs:
            kind = ins[0]
            if kind == "map" and ins[1] not in _FREE:
                total += math.prod(ins[4])
            elif kind == "reduce":
                total += math.prod(ins[4]) * math.prod(ins[5]) * (3 if ins[1] == "lse" else 1)
            elif kind == "contract":
                total += 2 * math.prod(ins[4]) * math.prod(ins[5])
        return total


# ----------------------------------------------------------------------
# the plain version: the program interpreted with torch
# ----------------------------------------------------------------------


def _read(opd: Opd, sizes, env) -> torch.Tensor:
    if opd.kind == "lit":
        return torch.tensor(opd.value, dtype=torch.bool if opd.dtype == "b" else torch.float32,
                            device=env["device"])
    n = env["n"]
    if opd.kind == "c":
        base = env["consts"]
        t = torch.as_strided(base, tuple(sizes), opd.strides, base.storage_offset() + opd.offset)
        t = t.unsqueeze(-1)
        return t != 0 if opd.dtype == "b" else t
    base = env[opd.kind] if opd.kind != "v" else env["v"][opd.idx]
    return torch.as_strided(base, (*sizes, n), (*(s * n for s in opd.strides), 1),
                            base.storage_offset() + opd.offset * n)


def _write(opd: Opd, sizes, value: torch.Tensor, env) -> None:
    target = _read(opd, sizes, env)
    target.copy_(value.expand(target.shape))


def _lse(x: torch.Tensor, dims) -> torch.Tensor:
    m = torch.amax(x, dim=dims, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    return (torch.log(torch.sum(torch.exp(x - m), dim=dims, keepdim=True)) + m).squeeze(dims)


def run_program(program: Program, q: torch.Tensor, consts: torch.Tensor):
    """``(lp (N,), grad (d, N))`` of the program at ``q (d, N)``."""
    q = q.to(torch.float32).contiguous()
    n = q.shape[1]
    env = {
        "device": q.device, "n": n, "q": q, "consts": consts,
        "g": torch.zeros((program.d, n), dtype=torch.float32, device=q.device),
        "lp": torch.zeros((1, n), dtype=torch.float32, device=q.device),
        "v": [torch.empty((size, n), dtype=torch.bool if dt == "b" else torch.float32, device=q.device)
              for size, dt in program.arrays],
    }
    for ins in program.instrs:
        kind = ins[0]
        if kind == "fill":
            env["v"][ins[1]].fill_(ins[2])
        elif kind == "map":
            _, op, out, ins_, sizes = ins
            args = [_read(a, sizes, env) for a in ins_]
            _write(out, sizes, _MAP[op][1](*args), env)
        elif kind == "reduce":
            _, op, out, src, sizes, rsizes = ins
            x = _read(src, (*sizes, *rsizes), env)
            dims = tuple(range(len(sizes), len(sizes) + len(rsizes)))
            if not dims:
                r = x
            elif op == "sum":
                r = x.sum(dim=dims)
            elif op == "max":
                r = torch.amax(x, dim=dims)
            elif op == "min":
                r = torch.amin(x, dim=dims)
            elif op == "any":
                r = x.any(dim=dims[0]) if len(dims) == 1 else x.flatten(len(sizes), -2).any(dim=len(sizes))
            elif op == "all":
                r = x.all(dim=dims[0]) if len(dims) == 1 else x.flatten(len(sizes), -2).all(dim=len(sizes))
            else:
                r = _lse(x, dims)
            _write(out, sizes, r, env)
        else:  # contract
            _, out, a, b, sizes, rsizes = ins
            shape = (*sizes, *rsizes)
            prod = _read(a, shape, env) * _read(b, shape, env)
            dims = tuple(range(len(sizes), len(shape)))
            _write(out, sizes, prod.sum(dim=dims) if dims else prod, env)
    return env["lp"][0], env["g"]


# ----------------------------------------------------------------------
# the emitter: the program as one __host__ __device__ function
# ----------------------------------------------------------------------


def _literal(v, dtype: str) -> str:
    if dtype == "b":
        return "true" if v else "false"
    v = float(np.float32(v))
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    s = f"{v:.9g}"
    if not any(ch in s for ch in ".e"):
        s += ".0"
    return f"{s}f" if v >= 0 else f"({s}f)"


def _index(opd: Opd, ivars) -> str:
    terms = [str(opd.offset)] if opd.offset else []
    for var, s in zip(ivars, opd.strides):
        if s:
            terms.append(var if s == 1 else f"{var} * {s}")
    return " + ".join(terms) or "0"


def _expr(opd: Opd, ivars) -> str:
    if opd.kind == "lit":
        return _literal(opd.value, opd.dtype)
    idx = _index(opd, ivars)
    if opd.kind == "c":
        return f"(GJT_C({idx}) != 0.0f)" if opd.dtype == "b" else f"GJT_C({idx})"
    name = {"q": "q", "g": "g", "lp": "lp"}.get(opd.kind, f"v{opd.idx}")
    return f"{name}[{idx}]"


def _loops(sizes, names, body: list, depth: int) -> list:
    """``body`` (lines) inside nested loops over ``sizes``; a unit extent
    takes no loop (its index is 0)."""
    lines, pad = [], "  " * depth
    unroll = math.prod(sizes) <= UNROLL_LIMIT
    opened = 0
    for s, var in zip(sizes, names):
        if s == 1:
            lines.append(f"{pad}{'  ' * opened}{{ const int {var} = 0;")
        else:
            if unroll:
                lines.append(f"{pad}{'  ' * opened}#pragma unroll")
            lines.append(f"{pad}{'  ' * opened}for (int {var} = 0; {var} < {s}; ++{var}) {{")
        opened += 1
    lines += [f"{pad}{'  ' * opened}{b}" for b in body]
    for k in reversed(range(opened)):
        lines.append(f"{pad}{'  ' * k}}}")
    return lines


def emit(program: Program, shared: bool) -> str:
    """The program as ``gjt_staged::lp_grad``, a header for K1 and K4 (and
    for a host compiler: ``__host__``/``__device__`` are empty there)."""
    out = [
        "// Generated by genjax_tpu_torch/kernels/staged.py from a column log-density:",
        "// lp and its gradient as one per-chain function (csrc/column_common.cuh, kStaged).",
        "#pragma once",
        "#include <math.h>",
        "#ifndef __CUDACC__",
        "#define __host__",
        "#define __device__",
        "#endif",
        "",
        "namespace gjt_staged {",
        "",
        f"constexpr int kD = {program.d};",
        f"constexpr int kConsts = {program.consts.numel()};",
        f"constexpr bool kShared = {'true' if shared else 'false'};  // constants in shared memory",
        "",
    ]
    if shared:
        out.append("#define GJT_C(k) consts[k]")
    else:
        out += ["#if defined(__CUDA_ARCH__)", "#define GJT_C(k) __ldg(consts + (k))", "#else",
                "#define GJT_C(k) consts[k]", "#endif"]
    out += [
        "",
        "// torch's NaN-propagating maximum and minimum, relu and sign",
        "__host__ __device__ inline float gjt_max(float a, float b) {",
        "  return (a != a || b != b) ? a + b : (a > b ? a : b);",
        "}",
        "__host__ __device__ inline float gjt_min(float a, float b) {",
        "  return (a != a || b != b) ? a + b : (a < b ? a : b);",
        "}",
        "__host__ __device__ inline float gjt_relu(float a) { return (a != a || a > 0.0f) ? a : 0.0f; }",
        "__host__ __device__ inline float gjt_sign(float a) {",
        "  return static_cast<float>((a > 0.0f) - (a < 0.0f));",
        "}",
        "",
        "__host__ __device__ inline float lp_grad(const float (&q)[kD], float (&g)[kD],",
        "                                         const float* consts) {",
        "  (void)consts;",
        "  float lp[1];",
    ]
    for k, (size, dt) in enumerate(program.arrays):
        out.append(f"  {'bool' if dt == 'b' else 'float'} v{k}[{size}];")
    for ins in program.instrs:
        kind = ins[0]
        if kind == "fill":
            _, k, value = ins
            size, dt = program.arrays[k]
            out += ["  {"] + _loops((size,), ("i0",), [f"v{k}[i0] = {_literal(value, dt)};"], 2) + ["  }"]
            continue
        if kind == "map":
            _, op, dst, srcs, sizes = ins
            ivars = [f"i{j}" for j in range(len(sizes))]
            rhs = _MAP[op][2].format(*[_expr(s, ivars) for s in srcs])
            out += ["  {"] + _loops(sizes, ivars, [f"{_expr(dst, ivars)} = {rhs};"], 2) + ["  }"]
            continue
        if kind == "reduce":
            _, op, dst, src, sizes, rsizes = ins
        else:
            _, dst, a, b, sizes, rsizes = ins
            op = "sum"
        ivars = [f"i{j}" for j in range(len(sizes))]
        rvars = [f"r{j}" for j in range(len(rsizes))]
        acc_t = "bool" if op in ("any", "all") else "float"
        if kind == "contract":
            term = f"{_expr(a, ivars + rvars)} * {_expr(b, ivars + rvars)}"
        else:
            term = _expr(src, ivars + rvars)
        init = {"sum": "0.0f", "max": "(-INFINITY)", "min": "INFINITY", "any": "false",
                "all": "true"}.get(op, "(-INFINITY)")
        step = {"sum": f"acc += {term};", "max": f"acc = gjt_max(acc, {term});",
                "min": f"acc = gjt_min(acc, {term});", "any": f"acc = acc || {term};",
                "all": f"acc = acc && {term};", "lse": f"acc = gjt_max(acc, {term});"}[op]
        inner = [f"{acc_t} acc = {init};"] + _loops(rsizes, rvars, [step], 0)
        if op == "lse":
            # log-sum-exp: the maximum first (an infinite one shifts by 0), then the sum
            inner += ["const float m = fabsf(acc) == INFINITY ? 0.0f : acc;", "float s = 0.0f;"]
            inner += _loops(rsizes, rvars, [f"s += expf({term} - m);"], 0)
            inner += ["acc = logf(s) + m;"]
        inner.append(f"{_expr(dst, ivars)} = acc;")
        out += ["  {"] + _loops(sizes, ivars, inner, 2) + ["  }"]
    out += ["  return lp[0];", "}", "", "}  // namespace gjt_staged", ""]
    return "\n".join(out)


# ----------------------------------------------------------------------
# the staged body
# ----------------------------------------------------------------------


class _StagedLp(torch.autograd.Function):
    """The program's lp, whose gradient is the program's own: every twin
    that differentiates a density by autograd runs the body's arithmetic."""

    @staticmethod
    def forward(q, body):
        return body.lp_grad(q)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output[1])

    @staticmethod
    def backward(ctx, g_lp, _g_grad):
        (grad,) = ctx.saved_tensors
        return g_lp.unsqueeze(0) * grad, None


class StagedBody:
    """A column log-density staged into a device body of K1 and K4: the
    lowered ``program``, its ``header`` (the emitted function), the hoisted
    constants ``consts`` (float32) and ``d``. ``lp_grad`` is the plain
    version; ``lib()`` builds the kernels with this body. Like
    ``bodies.Body``, it is itself a column log-density ``(d, N) -> (N,)``
    whose ``body`` is itself."""

    kind = STAGED
    name = "staged"
    n_obs = 0
    d_w = 0
    obs_scale = 0.0

    def __init__(self, program: Program):
        self.program = program
        self.d = program.d
        self.consts = program.consts
        self.n_consts = int(program.consts.numel())
        self.shared = 0 < 4 * self.n_consts <= SMEM_CAP_BYTES
        self.header = emit(program, self.shared)
        self.digest = hashlib.sha256(self.header.encode()).hexdigest()[:16]
        self._on_device: dict = {}
        self._lib = None

    @property
    def body(self) -> "StagedBody":
        return self

    @property
    def flop(self) -> int:
        """Operations of one ``(lp, grad)`` (``Program.flop``)."""
        return self.program.flop

    def min_dim(self) -> int:
        return self.d

    def variant(self, d: int) -> str:
        return "staged"

    def shared_consts_floats(self, d: int) -> int:
        """Floats of the constants a block copies into shared memory (to a
        float4), none where they are read from global memory."""
        return (self.n_consts + 3) // 4 * 4 if self.shared else 0

    def consts_on(self, device: torch.device) -> torch.Tensor:
        """The constants on ``device``, copied there once (one float where
        there are none, so the kernel gets a valid pointer)."""
        key = str(device)
        if key not in self._on_device:
            c = self.consts if self.n_consts else torch.zeros(1)
            self._on_device[key] = c.to(device).contiguous()
        return self._on_device[key]

    def lp_grad(self, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The plain version: ``(lp (N,), grad (d, N))`` at ``q (d, N)``,
        the lowered program run with torch."""
        if q.shape[0] != self.d:
            raise ValueError(f"the staged body takes d={self.d} rows, got {tuple(q.shape)}")
        return run_program(self.program, q.detach(), self.consts_on(q.device))

    def lib(self):
        """K1 and K4 built with this body (``_build.load_staged``), loaded
        once: a launch reads no source and hashes nothing."""
        if self._lib is None:
            from . import _build

            self._lib = _build.load_staged(self.header)
        return self._lib

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        return _StagedLp.apply(q, self)[0]

    def __repr__(self) -> str:
        return (f"StagedBody(d={self.d}, {len(self.program.instrs)} instructions, "
                f"{self.n_consts} constants, {self.flop} operations a gradient)")


# ----------------------------------------------------------------------
# staging: trace, fold, lower
# ----------------------------------------------------------------------


@dataclasses.dataclass
class _Val:
    """A node's lowering: its full shape (with the chain extent of trace 1
    at ``chain``, or no chain axis), dtype, and either a folded constant
    (``const``, over the non-chain dims; ``literal`` when the graph alone
    wrote it) or a strided view of per-chain data (``opd``, strides over the
    non-chain dims)."""

    shape: tuple
    chain: int | None
    dtype: str
    const: Any = None
    literal: bool = False
    opd: Opd | None = None

    @property
    def sizes(self) -> tuple:
        return tuple(s for k, s in enumerate(self.shape) if k != self.chain)


_DATA_DEPENDENT = {"_local_scalar_dense", "is_nonzero", "item", "equal", "allclose", "nonzero"}
# ops whose value depends on the shape of their input and not on its data
_SHAPE_ONLY = {"ones_like", "zeros_like", "full_like", "empty_like", "new_zeros", "new_ones",
               "new_full", "new_empty", "scalar_tensor", "sym_size"}
_IDENTITY = {"alias", "detach", "clone", "lift_fresh_copy", "contiguous", "_unsafe_view_copy"}


def _op_name(target) -> str:
    """``aten.mul.Tensor`` -> ``"mul"``; in-place ``mul_`` -> ``"mul_"``."""
    if target is operator.getitem:
        return "getitem"
    name = getattr(target, "__name__", str(target))
    packet = getattr(target, "_overloadpacket", None)
    if packet is not None:
        name = packet.__name__
    return name


def _full_name(target) -> str:
    return f"aten.{target.__name__}" if hasattr(target, "_overloadpacket") else str(target)


def _is_collective(target) -> bool:
    """A ``c10d`` or ``_c10d_functional`` op: ``torch.distributed``'s."""
    return "c10d" in str(target)


class _Lowering:
    """The program under construction: per-chain arrays, instructions and
    the hoisted constants (deduplicated by content)."""

    def __init__(self):
        self.arrays: list = []
        self.instrs: list = []
        self.consts: list = []  # flat float32 chunks
        self.n_consts = 0
        self.const_index: dict = {}

    # ---- storage
    def new_array(self, size: int, dtype: str) -> int:
        self.arrays.append((size, dtype))
        return len(self.arrays) - 1

    def const_opd(self, val: _Val, out_shape, out_chain) -> Opd:
        """An operand reading the folded constant ``val`` broadcast to the
        output; a constant of one element the graph wrote is a literal."""
        t = val.const
        dtype = val.dtype
        if t.numel() == 1 and val.literal:
            v = t.reshape(()).item()
            return Opd("lit", dtype=dtype, value=bool(v) if dtype == "b" else float(v))
        # collapse the broadcast (stride-0) dims of an expanded constant, and
        # a constant whose elements are all one value to that value
        index = tuple(slice(0, 1) if (st == 0 and sz > 1) else slice(None) for sz, st in zip(t.shape, t.stride()))
        t = t[index]
        first = t.reshape(-1)[:1].to(torch.float32)
        flat = t.to(torch.float32)
        if t.numel() > 1 and bool(((flat == first) | (flat.isnan() & first.isnan())).all()):
            t = first.reshape((1,) * t.ndim)
            if val.literal:
                v = first.item()
                return Opd("lit", dtype=dtype, value=bool(v) if dtype == "b" else float(v))
        # a permuted view of a contiguous constant (a folded transpose) is
        # stored in the layout of its storage, so the two share one copy
        perm = sorted(range(t.ndim), key=lambda k: -t.stride(k))
        base = t.permute(perm).to(torch.float32).contiguous().cpu()
        key = (tuple(base.shape), base.numpy().tobytes())
        if key not in self.const_index:
            self.const_index[key] = self.n_consts
            self.consts.append(base.reshape(-1))
            self.n_consts += base.numel()
        offset = self.const_index[key]
        strides, acc = [0] * t.ndim, 1
        for j in reversed(range(base.ndim)):
            strides[perm[j]] = acc if base.shape[j] > 1 else 0
            acc *= base.shape[j]
        inner = Opd("c", 0, offset, tuple(strides), dtype)
        return self._align(inner, val.shape, val.chain, out_shape, out_chain)

    def _align(self, opd: Opd, shape, chain, out_shape, out_chain) -> Opd:
        """``opd`` (strides over ``shape``'s non-chain dims) broadcast to
        ``out_shape``: strides over the output's non-chain dims."""
        full = []  # a stride for each dim of shape, chain's None
        it = iter(opd.strides)
        for k in range(len(shape)):
            full.append(None if k == chain else next(it))
        lead = len(out_shape) - len(shape)
        if lead < 0:
            raise _refuse(f"a broadcast of {tuple(shape)} to {tuple(out_shape)}")
        strides = []
        for k, size in enumerate(out_shape):
            if k == out_chain:
                j = k - lead
                if chain is not None and j != chain:
                    raise _refuse("an operand whose chain axis does not line up with the result's")
                continue
            j = k - lead
            if j < 0:
                strides.append(0)
            elif j == chain:
                raise _refuse("an operand whose chain axis meets a model axis of the result")
            elif shape[j] == 1 and size != 1:
                strides.append(0)
            else:
                strides.append(full[j])
        return dataclasses.replace(opd, strides=tuple(strides))

    def operand(self, x, out_shape, out_chain) -> Opd:
        if not isinstance(x, _Val):  # a Python number in the graph
            if isinstance(x, bool):
                return Opd("lit", dtype="b", value=x)
            return Opd("lit", dtype="f", value=float(x))
        if x.opd is None:
            return self.const_opd(x, out_shape, out_chain)
        return self._align(x.opd, x.shape, x.chain, out_shape, out_chain)

    # ---- instructions
    def map(self, op: str, args, shape, chain, dtype: str) -> _Val:
        sizes = tuple(s for k, s in enumerate(shape) if k != chain)
        ops = [self.operand(a, shape, chain) for a in args]
        if op == "mul" and any(o.kind == "lit" and o.value == 1.0 and o.dtype == "f" for o in ops):
            # x * 1 is x exactly (a model's scale times ones): a copy, no operation
            op, ops = "copy", [o for o in ops if not (o.kind == "lit" and o.value == 1.0)][:1] or ops[:1]
        k = self.new_array(math.prod(sizes), dtype)
        out = Opd("v", k, 0, _row_major(sizes), dtype)
        self.instrs.append(("map", op, out, tuple(ops), sizes))
        return _Val(tuple(shape), chain, dtype, opd=out)

    def materialize(self, x: _Val) -> _Val:
        return self.map("copy", [x], x.shape, x.chain, x.dtype)


def _row_major(sizes) -> tuple:
    strides, acc = [], 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


def _dtype_of(t: torch.Tensor) -> str:
    return "b" if t.dtype == torch.bool else "f"


def _shape_chain(v1, v2, p1: int, p2: int, name: str):
    """A tensor node's shape in trace 1 and its chain axis, from its shapes
    at the two chain extents."""
    s1, s2 = tuple(v1.shape), tuple(v2.shape)
    if len(s1) != len(s2):
        raise _refuse(f"{name} changes rank with the chain count")
    chain = [k for k, (a, b) in enumerate(zip(s1, s2)) if a == p1 and b == p2]
    other = [k for k, (a, b) in enumerate(zip(s1, s2)) if a != b and k not in chain]
    if other or len(chain) > 1:
        raise _refuse(f"{name} has a shape {s1} that follows the chain count other than on one axis")
    return s1, (chain[0] if chain else None)


def _trace(logdensity_cols: Callable, d: int, p: int, device):
    from torch.fx.experimental.proxy_tensor import make_fx

    def lp_and_grad(q):
        lp, vjp = torch.func.vjp(logdensity_cols, q)
        (grad,) = vjp(torch.ones_like(lp))
        return lp, grad

    gen = torch.Generator(device="cpu").manual_seed(0)
    q = (0.5 + torch.rand((d, p), generator=gen)).to(device)
    try:
        gm = make_fx(lp_and_grad, tracing_mode="real")(q)
    except Exception as err:  # the density could not be traced at all
        text = f"{type(err).__name__}: {err}".splitlines()[0][:300]
        for op in sorted(_DATA_DEPENDENT):
            if op in text or (op == "item" and ".item()" in text):
                raise _refuse(f"the density reads a value to the host (aten.{op}: {text})") from err
        raise _refuse(f"the density could not be traced at {p} chains ({text})") from err
    return gm, q


def _record(gm, q) -> dict:
    vals = {}

    class Rec(torch.fx.Interpreter):
        def run_node(self, n):
            out = super().run_node(n)
            vals[n] = out
            return out

    with torch.no_grad():
        Rec(gm).run(q)
    return vals


def _depends(gm) -> set:
    dep = set()
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            dep.add(n)
        elif n.op == "call_function" and _op_name(n.target) not in _SHAPE_ONLY:
            if any(a in dep for a in n.all_input_nodes):
                dep.add(n)
    return dep


def stage_body(logdensity_cols: Callable, d: int, *, device=None) -> StagedBody:
    """Stage ``logdensity_cols`` (``(d, N) -> (N,)``) into a device body of
    the sweep kernels, tracing on ``device`` (the CPU by default): the
    lowered program, its emitted function and its hoisted constants. Raises
    a ``ValueError`` naming the aten op and ``backend='torch'`` for a density
    outside the op set (module docstring)."""
    if getattr(logdensity_cols, "row_shard", None) is not None:
        raise _refuse("the density is row-sharded (.row_shard): its rows are summed by a collective "
                      "over the model axis, which no device body issues")
    if getattr(logdensity_cols, "collective_axis", None) is not None:
        raise _refuse(f"the density sums over the mesh axis {logdensity_cols.collective_axis!r} with a "
                      "collective (an all_reduce), which no device body issues")
    if not (isinstance(d, int) and 1 <= d <= MAX_D):
        raise _refuse(f"D={d} is outside 1..{MAX_D}, the dimensions a staged K1 build takes")
    device = torch.device("cpu") if device is None else torch.device(device)
    p1, p2 = CHAIN_EXTENTS
    # one call first, so that what a density makes at its first call and
    # keeps (a constant it caches) is the same in both traces
    with torch.no_grad():
        try:
            logdensity_cols(0.5 + torch.zeros((d, p1), device=device))
        except Exception as err:
            text = f"{type(err).__name__}: {err}".splitlines()[0][:300]
            raise _refuse(f"the density fails on a ({d}, {p1}) block ({text})") from err
    gm1, q1 = _trace(logdensity_cols, d, p1, device)
    gm2, q2 = _trace(logdensity_cols, d, p2, device)
    for gm in (gm1, gm2):
        for n in gm.graph.nodes:
            if n.op == "call_function" and _is_collective(n.target):
                raise _refuse(f"the density issues a collective ({_full_name(n.target)})")
    # a read to the host of data that depends on q refuses before dead code goes
    dep = _depends(gm1)
    for n in gm1.graph.nodes:
        if n.op == "call_function" and n in dep and _op_name(n.target) in _DATA_DEPENDENT:
            raise _refuse(f"the density reads a value to the host ({_full_name(n.target)})")
    for gm in (gm1, gm2):
        gm.graph.eliminate_dead_code()
        gm.recompile()
    nodes1, nodes2 = list(gm1.graph.nodes), list(gm2.graph.nodes)
    if len(nodes1) != len(nodes2) or any(
        a.op != b.op or a.target != b.target for a, b in zip(nodes1, nodes2)
    ):
        raise _refuse("the density's graph changes with the chain count")
    vals1, vals2 = _record(gm1, q1), _record(gm2, q2)
    low = _Lowering()
    env: dict = {}
    dep = _depends(gm1)
    literal: dict = {}
    out_vals = None
    for n1, n2 in zip(nodes1, nodes2):
        if n1.op == "output":
            out_vals = n1.args[0]
            continue
        v1, v2 = vals1[n1], vals2[n2]
        if n1.op == "placeholder":
            env[n1] = _Val((d, p1), 1, "f", opd=Opd("q", 0, 0, (1,), "f"))
            continue
        if n1.op == "get_attr":
            literal[n1] = False
        elif n1.op == "call_function":
            literal[n1] = _op_name(n1.target) in _SHAPE_ONLY or all(
                literal.get(a, True) for a in n1.all_input_nodes)
        if n1 not in dep or n1.op == "get_attr":
            env[n1] = _fold(n1, v1, v2, p1, p2, literal.get(n1, False))
            continue
        name = _op_name(n1.target)
        if name == "getitem" and isinstance(env.get(n1.args[0]), tuple):
            part = env[n1.args[0]][n1.args[1]]
            if part is None:
                raise _refuse(f"the indices of {_full_name(n1.args[0].target)} are read")
            env[n1] = part
            continue
        if name == "log_sigmoid_forward":
            shape, chain = _shape_chain(v1[0], v2[0], p1, p2, _full_name(n1.target))
            # (output, buffer): log_sigmoid_backward reads the buffer and
            # ignores it, recomputing from its input
            env[n1] = (low.map("logsigmoid", [env[n1.args[0]]], shape, chain, "f"), "buffer")
            continue
        if name in ("max", "min") and getattr(n1.target, "_overloadname", "") == "dim":
            shape, chain = _shape_chain(v1[0], v2[0], p1, p2, _full_name(n1.target))
            env[n1] = (_reduce(low, "amax" if name == "max" else "amin", _full_name(n1.target),
                               env[n1.args[0]], [n1.args[1]], shape, chain, _dtype_of(v1[0])), None)
            continue
        if not isinstance(v1, torch.Tensor):
            raise _refuse(f"{_full_name(n1.target)} returns {type(v1).__name__}, not a tensor, from chain data")
        shape, chain = _shape_chain(v1, v2, p1, p2, _full_name(n1.target))
        if chain is None:
            raise _refuse(f"{_full_name(n1.target)} leaves no chain axis (a reduction or product over the "
                          "chain axis)")
        if v1.is_complex():
            raise _refuse(f"{_full_name(n1.target)} makes {v1.dtype} chain data")
        # integer chain data (a count of maxima in amax's gradient) is held as float32
        val = _lower(low, n1, name, env, shape, chain, _dtype_of(v1))
        if val.shape != shape or val.chain != chain:
            raise _refuse(f"{_full_name(n1.target)} lowered to shape {val.shape} (chain {val.chain}), "
                          f"traced {shape} (chain {chain})")
        env[n1] = val
        if name.endswith("_") and n1.args and isinstance(n1.args[0], torch.fx.Node):
            env[n1.args[0]] = val  # an in-place op: later reads of its input see the result
    lp_val, grad_val = (env[x] if isinstance(x, torch.fx.Node) else x for x in out_vals)
    if lp_val.shape != (p1,) or tuple(grad_val.shape) != (d, p1):
        raise _refuse(f"the density returns {lp_val.shape}, not one value a chain")
    low.instrs.append(("map", "copy", Opd("lp", 0, 0, (), "f"), (low.operand(lp_val, (p1,), 0),), ()))
    low.instrs.append(("map", "copy", Opd("g", 0, 0, (1,), "f"),
                       (low.operand(grad_val, (d, p1), 1),), (d,)))
    consts = torch.cat(low.consts) if low.consts else torch.zeros(0)
    return StagedBody(Program(d, low.arrays, _dead_code(low.instrs), consts))


def _dead_code(instrs: list) -> list:
    """The instructions whose results reach ``lp`` or ``g``."""
    live = set()
    kept = []
    for ins in reversed(instrs):
        kind = ins[0]
        if kind == "fill":
            if ins[1] in live:
                kept.append(ins)
            continue
        out = ins[2] if kind in ("map", "reduce") else ins[1]
        if out.kind == "v" and out.idx not in live:
            continue
        kept.append(ins)
        srcs = ins[3] if kind == "map" else ((ins[3],) if kind == "reduce" else (ins[2], ins[3]))
        live.update(s.idx for s in srcs if s.kind == "v")
    return list(reversed(kept))


def _fold(n1, v1, v2, p1, p2, literal) -> Any:
    """A node that does not depend on q: its value, a folded constant."""
    if not isinstance(v1, torch.Tensor):
        return v1
    shape, chain = _shape_chain(v1, v2, p1, p2, _full_name(n1.target) if n1.op == "call_function" else n1.name)
    t = v1.detach()
    if chain is not None:
        first = t.narrow(chain, 0, 1)
        same = (t == first) | (t.isnan() & first.isnan()) if t.is_floating_point() else (t == first)
        if not bool(same.all()):
            raise _refuse(f"a constant carries the chain axis ({_full_name(n1.target) if n1.op == 'call_function' else n1.name}"
                          f" of shape {shape} differs along it)")
        t = first.squeeze(chain)
    if t.dtype != torch.bool:
        t = t.to(torch.float32)
    return _Val(shape, chain, _dtype_of(t), const=t, literal=literal)


# ---- lowering of the chain-dependent aten ops


def _norm(dim: int, rank: int) -> int:
    return dim + rank if dim < 0 else dim


def _view(x: _Val, shape, chain, strides, offset_add=0) -> _Val:
    opd = dataclasses.replace(x.opd, offset=x.opd.offset + offset_add, strides=tuple(strides))
    return _Val(tuple(shape), chain, x.dtype, opd=opd)


def _full_strides(x: _Val) -> list:
    it = iter(x.opd.strides)
    return [None if k == x.chain else next(it) for k in range(len(x.shape))]


def _lower(low: _Lowering, n, name: str, env, shape, chain, dtype) -> _Val:
    base = name[:-1] if name.endswith("_") else name
    args = list(torch.fx.node.map_arg(n.args, lambda a: env[a]))
    kw = dict(torch.fx.node.map_arg(n.kwargs, lambda a: env[a]))
    overload = getattr(n.target, "_overloadname", "")
    full = _full_name(n.target)

    def chain_arg(x):
        if not isinstance(x, _Val) or x.opd is None:
            raise _refuse(f"{full} on a folded constant where chain data was expected")
        return x

    # ---- layout: views of the per-chain data
    if base in _IDENTITY:
        return env[n.args[0]]
    if base in ("permute", "t", "transpose"):
        x = chain_arg(args[0])
        rank = len(x.shape)
        if base == "permute":
            perm = [_norm(k, rank) for k in args[1]]
        else:
            a, b = (0, 1) if base == "t" else (_norm(args[1], rank), _norm(args[2], rank))
            perm = list(range(rank))
            if rank >= 2:
                perm[a], perm[b] = perm[b], perm[a]
        fs = _full_strides(x)
        return _view(x, [x.shape[k] for k in perm], perm.index(x.chain),
                     [fs[k] for k in perm if k != x.chain])
    if base == "unsqueeze":
        x = chain_arg(args[0])
        k = _norm(args[1], len(x.shape) + 1)
        fs = _full_strides(x)
        fs.insert(k, 0)
        new_shape = list(x.shape)
        new_shape.insert(k, 1)
        new_chain = x.chain + (1 if k <= x.chain else 0)
        return _view(x, new_shape, new_chain, [s for j, s in enumerate(fs) if j != new_chain])
    if base == "squeeze":
        x = chain_arg(args[0])
        rank = len(x.shape)
        if len(args) == 1:
            dims = [k for k, s in enumerate(x.shape) if s == 1]
        else:
            dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
            dims = [_norm(k, rank) for k in dims if x.shape[_norm(k, rank)] == 1]
        fs = _full_strides(x)
        keep = [k for k in range(rank) if k not in dims]
        new_chain = keep.index(x.chain)
        return _view(x, [x.shape[k] for k in keep], new_chain,
                     [fs[k] for k in keep if k != x.chain])
    if base == "expand":
        x = chain_arg(args[0])
        sizes = list(args[1])
        lead = len(sizes) - len(x.shape)
        fs = _full_strides(x)
        new_shape, new_strides = [], []
        for k, s in enumerate(sizes):
            j = k - lead
            if j < 0:
                new_shape.append(s)
                new_strides.append(0)
            else:
                size = x.shape[j] if s == -1 else s
                new_shape.append(size)
                new_strides.append(None if j == x.chain else (0 if x.shape[j] == 1 and size != 1 else fs[j]))
        new_chain = x.chain + lead
        return _view(x, new_shape, new_chain, [s for j, s in enumerate(new_strides) if j != new_chain])
    if base in ("view", "_unsafe_view", "reshape"):
        x = chain_arg(args[0])
        out_shape = list(shape)
        a_before, a_after = math.prod(x.shape[: x.chain]), math.prod(x.shape[x.chain + 1:])
        b_before, b_after = math.prod(out_shape[:chain]), math.prod(out_shape[chain + 1:])
        if (a_before, a_after) != (b_before, b_after):
            raise _refuse(f"{full} merges or splits the chain axis ({x.shape} -> {tuple(out_shape)})")
        sizes = x.sizes
        if tuple(s for s, z in zip(x.opd.strides, sizes) if z != 1) != tuple(
            s for s, z in zip(_row_major(sizes), sizes) if z != 1
        ):
            x = low.materialize(x)
        new_sizes = tuple(s for k, s in enumerate(out_shape) if k != chain)
        return _view(x, out_shape, chain, _row_major(new_sizes))
    if base == "slice":
        x = chain_arg(args[0])
        rank = len(x.shape)
        dim = _norm(args[1] if len(args) > 1 else 0, rank)
        size = x.shape[dim]
        start = args[2] if len(args) > 2 and args[2] is not None else 0
        end = args[3] if len(args) > 3 and args[3] is not None else size
        step = args[4] if len(args) > 4 else 1
        start, end, _ = slice(start, end, step).indices(size)
        length = len(range(start, end, step))
        if dim == x.chain:
            if (start, length, step) != (0, size, 1):
                raise _refuse(f"{full} slices the chain axis")
            return x
        fs = _full_strides(x)
        new_shape = list(x.shape)
        new_shape[dim] = length
        off = start * fs[dim]
        fs[dim] = fs[dim] * step
        return _view(x, new_shape, x.chain, [s for j, s in enumerate(fs) if j != x.chain], off)
    if base == "select":
        x = chain_arg(args[0])
        rank = len(x.shape)
        dim = _norm(args[1], rank)
        if dim == x.chain:
            raise _refuse(f"{full} selects along the chain axis")
        index = args[2] + x.shape[dim] if args[2] < 0 else args[2]
        fs = _full_strides(x)
        off = index * fs[dim]
        keep = [k for k in range(rank) if k != dim]
        new_chain = keep.index(x.chain)
        return _view(x, [x.shape[k] for k in keep], new_chain,
                     [fs[k] for k in keep if k != x.chain], off)
    if base == "_to_copy" or base == "to":
        x = chain_arg(args[0])
        if x.dtype == dtype:
            return x
        return low.map("to_f" if dtype == "f" else "to_b", [x], shape, chain, dtype)

    # ---- scatters of the gradient trace: a zero array and a copy into part of it
    if base in ("slice_backward", "select_backward"):
        grad = args[0]
        sizes_in = list(args[1])
        dim = _norm(args[2], len(sizes_in))
        if dim == chain:
            if base == "slice_backward" and (args[3], min(args[4], shape[chain]), args[5]) == (0, shape[chain], 1):
                return grad
            raise _refuse(f"{full} scatters along the chain axis")
        k = low.new_array(math.prod(s for j, s in enumerate(shape) if j != chain), dtype)
        low.instrs.append(("fill", k, False if dtype == "b" else 0.0))
        fs = list(_row_major(tuple(s for j, s in enumerate(shape) if j != chain)))
        fs.insert(chain, None)
        if base == "slice_backward":
            start, end, step = slice(args[3], args[4], args[5]).indices(shape[dim])
            sub_shape = list(shape)
            sub_shape[dim] = len(range(start, end, step))
            off = start * fs[dim]
            fs[dim] *= step
        else:
            index = args[3] + shape[dim] if args[3] < 0 else args[3]
            sub_shape = [s for j, s in enumerate(shape) if j != dim]
            off = index * fs[dim]
            fs = [s for j, s in enumerate(fs) if j != dim]
        sub_chain = chain if base == "slice_backward" else (chain - (1 if dim < chain else 0))
        sub_sizes = tuple(s for j, s in enumerate(sub_shape) if j != sub_chain)
        dst = Opd("v", k, off, tuple(s for s in fs if s is not None), dtype)
        low.instrs.append(("map", "copy", dst, (low.operand(grad, sub_shape, sub_chain),), sub_sizes))
        return _Val(tuple(shape), chain, dtype, opd=Opd("v", k, 0, _row_major(tuple(
            s for j, s in enumerate(shape) if j != chain)), dtype))
    if base == "stack":
        dim = _norm(args[1] if len(args) > 1 else 0, len(shape))
        return _concat(low, full, [_unsqueezed(t, dim) for t in args[0]], dim, shape, chain, dtype)
    if base == "cat":
        return _concat(low, full, args[0], _norm(args[1] if len(args) > 1 else 0, len(shape)), shape, chain,
                       dtype)

    # ---- products over model axes
    labels = {"mm": ("mk", "kn", "mn"), "bmm": ("bmk", "bkn", "bmn"), "mv": ("mk", "k", "m"),
              "dot": ("k", "k", ""), "addmm": ("mk", "kn", "mn")}
    if base in labels:
        a, b = (args[1], args[2]) if base == "addmm" else (args[0], args[1])
        la, lb, lo = labels[base]
        out = _contract(low, full, a, la, b, lb, lo, shape, chain, dtype)
        if base == "addmm":
            beta, alpha = kw.get("beta", 1), kw.get("alpha", 1)
            if alpha != 1:
                out = low.map("mul", [out, float(alpha)], shape, chain, dtype)
            bias = args[0] if beta == 1 else _scale(low, args[0], beta, shape, chain)
            out = low.map("add", [bias, out], shape, chain, dtype)
        return out

    # ---- reductions over model axes
    if base in ("sum", "mean", "amax", "amin", "logsumexp", "any", "all"):
        dims = args[1] if len(args) > 1 else kw.get("dim", None)
        return _reduce(low, base, full, args[0], dims, shape, chain, dtype)

    # ---- elementwise
    simple = {
        "neg": "neg", "reciprocal": "recip", "exp": "exp", "log": "log", "log1p": "log1p",
        "expm1": "expm1", "sqrt": "sqrt", "rsqrt": "rsqrt", "abs": "abs", "sign": "sign", "sgn": "sign",
        "tanh": "tanh", "sigmoid": "sigmoid", "sin": "sin", "cos": "cos", "tan": "tan", "erf": "erf",
        "erfc": "erfc", "relu": "relu", "isnan": "isnan", "isinf": "isinf", "logical_not": "not",
        "bitwise_not": "not", "mul": "mul", "div": "div", "maximum": "max", "minimum": "min",
        "gt": "gt", "ge": "ge", "lt": "lt", "le": "le", "eq": "eq", "ne": "ne",
        "logical_and": "and", "logical_or": "or", "logical_xor": "xor", "bitwise_and": "and",
        "bitwise_or": "or", "bitwise_xor": "xor", "sigmoid_backward": "sigmoid_bwd",
        "tanh_backward": "tanh_bwd", "threshold_backward": "threshold_bwd", "where": "where",
        "square": "square",
    }
    if base in ("bitwise_not", "bitwise_and", "bitwise_or", "bitwise_xor") and dtype != "b":
        raise _refuse(f"{full} on integer bits")
    if base == "div" and kw.get("rounding_mode") is not None:
        raise _refuse(f"{full} with rounding_mode={kw['rounding_mode']!r}")
    if base in ("add", "sub", "rsub"):
        a, b = args[0], args[1]
        alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
        if alpha != 1:
            b = low.map("mul", [b, float(alpha)], shape, chain, "f") if isinstance(b, _Val) else b * alpha
        if base == "rsub":
            a, b = b, a
        return low.map("add" if base == "add" else "sub", [a, b], shape, chain, dtype)
    if base == "pow":
        x, e = args[0], args[1]
        if isinstance(e, (int, float)) and not isinstance(e, bool):
            e = float(e)
            special = {1.0: "copy", 2.0: "square", 3.0: "cube", 0.5: "sqrt", -1.0: "recip", -0.5: "rsqrt"}
            if e in special:
                return low.map(special[e], [x], shape, chain, dtype)
            if e == 0.0:
                return low.map("copy", [1.0], shape, chain, dtype)
        return low.map("pow", [x, e], shape, chain, dtype)
    if base == "clamp" or base == "clamp_min" or base == "clamp_max":
        x = args[0]
        lo = args[1] if base != "clamp_max" and len(args) > 1 else kw.get("min", None)
        hi = (args[2] if len(args) > 2 else kw.get("max", None)) if base == "clamp" else (
            args[1] if base == "clamp_max" else None)
        lo = -math.inf if lo is None else lo
        hi = math.inf if hi is None else hi
        return low.map("clamp", [x, lo, hi], shape, chain, dtype)
    if base == "masked_fill":
        x, mask, value = args[0], args[1], args[2]
        return low.map("where", [mask, value, x], shape, chain, dtype)
    if base == "threshold_backward":
        return low.map("threshold_bwd", [args[0], args[1], float(args[2])], shape, chain, dtype)
    if base == "softplus":
        beta = args[1] if len(args) > 1 else kw.get("beta", 1.0)
        threshold = args[2] if len(args) > 2 else kw.get("threshold", 20.0)
        return low.map("softplus", [args[0], float(beta), float(threshold)], shape, chain, dtype)
    if base == "log_sigmoid_backward":
        return low.map("logsigmoid_bwd", [args[0], args[1]], shape, chain, dtype)
    if base == "softplus_backward":
        return low.map("softplus_bwd", [args[0], args[1], float(args[2]), float(args[3])], shape, chain, dtype)
    if base in simple and base not in ("add", "sub"):
        op = simple[base]
        arity = _MAP[op][0]
        operands = list(args[:arity])
        if len(operands) != arity:
            raise _refuse(f"{full} with {len(args)} arguments")
        return low.map(op, operands, shape, chain, dtype)
    raise _refuse(f"{full} is outside the staged body's op set")


def _unsqueezed(x: _Val, k: int) -> _Val:
    """``x`` with a unit dimension inserted at ``k`` of its full shape."""
    shape = list(x.shape)
    shape.insert(k, 1)
    chain = None if x.chain is None else x.chain + (1 if k <= x.chain else 0)
    if x.opd is None:
        inner = k - (1 if chain is not None and chain < k else 0)
        return dataclasses.replace(x, shape=tuple(shape), chain=chain, const=x.const.unsqueeze(inner))
    fs = _full_strides(x)
    fs.insert(k, 0)
    return _view(x, shape, chain, [s for j, s in enumerate(fs) if j != chain])


def _concat(low: _Lowering, full: str, tensors, dim: int, shape, chain, dtype) -> _Val:
    """``torch.cat`` along a model axis: a new array, each input copied
    into its slab."""
    if dim == chain:
        raise _refuse(f"{full} concatenates along the chain axis")
    sizes = tuple(s for j, s in enumerate(shape) if j != chain)
    k = low.new_array(math.prod(sizes), dtype)
    fs = list(_row_major(sizes))
    fs.insert(chain, None)
    start = 0
    for t in tensors:
        t_shape = list(t.shape) if isinstance(t, _Val) else list(np.shape(t))
        if len(t_shape) == 1 and t_shape[0] == 0:
            continue  # torch.cat skips a (0,) tensor
        sub_shape = list(shape)
        sub_shape[dim] = t_shape[dim]
        dst = Opd("v", k, start * fs[dim], tuple(s for s in fs if s is not None), dtype)
        sub_sizes = tuple(s for j, s in enumerate(sub_shape) if j != chain)
        low.instrs.append(("map", "copy", dst, (low.operand(t, sub_shape, chain),), sub_sizes))
        start += t_shape[dim]
    return _Val(tuple(shape), chain, dtype, opd=Opd("v", k, 0, _row_major(sizes), dtype))


def _reduce(low: _Lowering, base: str, full: str, x, dims, shape, chain, dtype) -> _Val:
    if not isinstance(x, _Val) or x.opd is None:
        raise _refuse(f"{full} on a folded constant where chain data was expected")
    rank = len(x.shape)
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0 and base in ("sum", "mean")):
        dims = list(range(rank))
    dims = [dims] if isinstance(dims, int) else list(dims)
    dims = sorted({_norm(k, rank) for k in dims})
    if x.chain in dims:
        raise _refuse(f"{full} reduces over the chain axis")
    op = {"sum": "sum", "mean": "sum", "amax": "max", "amin": "min", "logsumexp": "lse",
          "any": "any", "all": "all"}[base]
    fs = _full_strides(x)
    keep = [k for k in range(rank) if k not in dims]
    k_sizes = tuple(x.shape[k] for k in keep if k != x.chain)
    r_sizes = tuple(x.shape[k] for k in dims)
    src = dataclasses.replace(x.opd, strides=tuple([fs[k] for k in keep if k != x.chain] + [fs[k] for k in dims]))
    out_sizes = tuple(s for j, s in enumerate(shape) if j != chain)
    if math.prod(out_sizes) != math.prod(k_sizes):
        raise _refuse(f"{full} keeps {k_sizes}, traced {shape}")
    arr = low.new_array(math.prod(out_sizes), dtype)
    dst = Opd("v", arr, 0, _row_major(k_sizes), dtype)
    low.instrs.append(("reduce", op, dst, src, k_sizes, r_sizes))
    val = _Val(tuple(shape), chain, dtype, opd=Opd("v", arr, 0, _row_major(out_sizes), dtype))
    if base == "mean":
        val = low.map("mul", [val, 1.0 / math.prod(r_sizes)], shape, chain, dtype)
    return val


def _scale(low: _Lowering, x, s: float, shape, chain) -> Any:
    if isinstance(x, _Val):
        return low.map("mul", [x, float(s)], shape, chain, "f")
    return x * s


def _contract(low: _Lowering, full: str, a, la: str, b, lb: str, lo: str, shape, chain, dtype) -> _Val:
    """``out[lo] = sum over the other labels of a[la] * b[lb]``, one operand
    at most carrying the chain axis, on an output label."""
    ops = [(x, lab) for x, lab in ((a, la), (b, lb))]
    carriers = [(x, lab) for x, lab in ops if isinstance(x, _Val) and x.opd is not None]
    # both may carry the chain axis only as the same batch label (a product
    # within each chain, as vmap batches one): else it would mix chains
    if len(carriers) > 1 and len({lab[x.chain] for x, lab in carriers}) > 1:
        raise _refuse(f"{full} multiplies two operands that carry the chain axis (mm takes at most one)")
    red = [c for c in dict.fromkeys(la + lb) if c not in lo]
    out_sizes = tuple(s for j, s in enumerate(shape) if j != chain)
    extent = dict(zip(lo, shape))
    for x, lab in ops:
        xs = x.shape if isinstance(x, _Val) else tuple(np.shape(x))
        for c, s in zip(lab, xs):
            extent.setdefault(c, s)
    r_sizes = tuple(extent[c] for c in red)
    chain_label = lo[chain]
    loop_labels = [c for c in lo if c != chain_label] + red
    operands = []
    for x, lab in ops:
        if not isinstance(x, _Val):
            x = _Val(tuple(np.shape(x)), None, "f", const=torch.as_tensor(x, dtype=torch.float32))
        if x.opd is not None and lab[x.chain] != chain_label:
            raise _refuse(f"{full} contracts the chain axis")
        if x.opd is None:
            opd = low.const_opd(x, x.shape, x.chain)
            if opd.kind == "lit":
                operands.append(opd)
                continue
            fs = list(opd.strides)
            if x.chain is not None:
                fs.insert(x.chain, None)
        else:
            opd = x.opd
            fs = _full_strides(x)
        by_label = {c: (fs[k] if x.shape[k] != 1 else 0) for k, c in enumerate(lab) if k != x.chain}
        strides = tuple(by_label.get(c, 0) or 0 for c in loop_labels)
        operands.append(dataclasses.replace(opd, strides=strides))
    arr = low.new_array(math.prod(out_sizes), dtype)
    dst = Opd("v", arr, 0, _row_major(out_sizes), dtype)
    low.instrs.append(("contract", dst, operands[0], operands[1], out_sizes, r_sizes))
    return _Val(tuple(shape), chain, dtype, opd=dst)


_scope: contextvars.ContextVar = contextvars.ContextVar("gjt_staging_scope", default=None)


@contextlib.contextmanager
def staging_scope():
    """Within it, ``staged_body_for`` stages a density once per ``(d,
    device)`` and reuses the body, so that a warmup's phases and the sweep
    after them stage once. A scope opened inside another is the outer one.
    Used as a decorator by ``column_hmc``, ``column_nuts``,
    ``warmup_column`` and ``warmup_column_nuts``: the body lives as long as
    one call of theirs, so a later call stages the density again and reads
    what its captured tensors hold then."""
    if _scope.get() is not None:
        yield
        return
    token = _scope.set({})
    try:
        yield
    finally:
        _scope.reset(token)


def staged_body_for(logdensity_cols: Callable, d: int, device) -> StagedBody:
    """``stage_body`` of ``logdensity_cols`` at ``d``, traced on ``device``.
    Inside a ``staging_scope`` the body is kept for the scope's lifetime;
    outside one every call stages anew, as the reference's ``pallas_hmc``
    does, since the body's constants are a copy of what the density read
    when it was traced."""
    cache = _scope.get()
    if cache is None:
        return stage_body(logdensity_cols, d, device=device)
    key = (id(logdensity_cols), d, str(device))
    if key not in cache:
        # the density is held beside its body so that its id is not reused
        cache[key] = (logdensity_cols, stage_body(logdensity_cols, d, device=device))
    return cache[key][1]
