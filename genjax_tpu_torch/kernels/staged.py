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
   bool arrays (``Program``): a node of shape ``(m..., N)`` is ``m...``
   values a chain, layout ops are strided views, elementwise ops are maps,
   reductions and ``mm`` over model axes are reductions and contractions.
   The lowering follows broadcasts: an instruction runs once along an axis
   on which none of its operands varies, and its result carries stride 0
   there. The gradient's scatters into zeros (``slice_backward``,
   ``select_backward``) stay pieces of their array until something other
   than a sum of disjoint pieces reads them, so the gradient is written
   piece by piece into ``g``;
4. simplifies the program (``_Simplifier``): copies of views are forwarded
   to their readers, common subexpressions merged, identities on the
   graph's own literals dropped (``* 1``, ``+ 0``, ``- 0``, ``neg`` of
   ``neg``), chains of scalings folded into one, a division by a literal
   or by a hoisted constant made a multiply by its reciprocal (computed at
   stage time, where it is finite and normal), scalings and uniform terms
   taken out of sums and products, and divisions by one chain value made
   one reciprocal and multiplies (``divr``, which divides where the
   reciprocal is not normal);
5. prints the program as one ``__host__ __device__`` function (``header``):
   every instruction of at most ``UNROLL_LIMIT`` iterations as
   straight-line scalar code, each element a ``const`` scalar at
   compile-time indices, larger ones as loops over arrays. The hoisted
   constants travel by value in the kernel's parameter space up to
   ``PARAM_CAP_BYTES`` (each read at a compile-time index a constant-bank
   operand), else in shared memory up to ``SMEM_CAP_BYTES``, else through
   ``__ldg`` (``StagedBody.const_mode``). ``kernels/_build.py::load_staged``
   compiles it with ``nvcc`` into K1 and K4 (``csrc/column_common.cuh``,
   body id ``kStaged``).

A density may take a second input, its chain operands: ``stage_body(ld, d,
chain=c)`` stages ``(q, c) -> (lp, grad)`` of ``ld(q, c)``, ``c`` a ``(k, N)``
float32 block of ``k`` values a chain (the trace path's frozen choices and
arguments that differ from chain to chain, ``inference/mcmc.py``). They do
not depend on ``q`` but differ along the chain axis, so a node that depends
on ``c`` is chain data, computed in the program (operand kind ``"cc"``, read
at ``cc[row]``), never folded; the simplifier treats it as it treats ``q``.
The header declares ``kChain``, and with ``k > 0`` defines
``GJT_STAGED_CHAIN`` and takes the chain's operands as an argument of
``lp_grad``; K1 and K4 read a chain's ``k`` values once a sweep
(``csrc/column_common.cuh``). A captured constant that differs along the
chain axis is still refused: ``c`` is how such values come in. A
``StagedBody`` with chain operands is bound to its block (``bind``) before a
launch or a twin runs it.

Only the graph decides the program and the header: the constants' values
never steer a rewrite, except that where a hoisted constant, or a
reciprocal or product computed from constants at stage time, is not finite
(a reciprocal: not normal) the original operation stays. A model staged
again with other data of the same shape prints the same header and reuses
its build.

The op set is the aten counterpart of the reference's ``_PALLAS_SAFE_PRIMS``
(``genjax_tpu/kernels/hmc.py:172-183``): elementwise arithmetic and
transcendental ops (``xlogy`` and ``xlog1py`` too), comparisons, logical ops and ``where``; sum, max, min
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

``StagedBody.lp_grad`` interprets the simplified program, the same op list
the emitter prints, with torch: the plain version of the staged device
body, used by the CPU tests. Like ``bodies.Body``, a ``StagedBody`` is
itself a column density whose ``.body`` is itself.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import copy
import dataclasses
import hashlib
import itertools
import math
import operator
from typing import Any, Callable

import numpy as np
import torch

# two chain extents, primes, at which the density is traced
CHAIN_EXTENTS = (251, 241)
# K1 takes any D in 1..MAX_D in a staged build (K4: as far as its stacks fit)
MAX_D = 64
# hoisted constants up to this many bytes travel by value in the kernel's
# parameter space (with the launch's own parameters, under the 4,096 bytes
# every CUDA 12 release takes); up to SMEM_CAP_BYTES they are copied into
# shared memory at block start; more are read from global memory through __ldg
PARAM_CAP_BYTES = 3840
SMEM_CAP_BYTES = 16384
# an instruction of at most this many iterations is printed as straight-line code
UNROLL_LIMIT = 512
# K1 and K4 hold a chain's operands in registers up to this many (read once a
# sweep) and read them through __ldg at each gradient above it (the header's
# kChainInRegisters; csrc/column_common.cuh, ChainOperands). The staged
# flagship's K1 holds 168 registers of 255 without spilling, so 32 more still
# fit a thread; K4 already takes 255, where more would only turn into spills.
CHAIN_REGISTER_CAP = 32

STAGED = 2  # the body id (csrc/column_common.cuh: kStaged)

# where the constants live (the header's kConstMode)
CONST_MODES = ("param", "shared", "global")

_FLT_MIN = float(np.finfo(np.float32).tiny)


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
    """An operand: ``kind`` ``"q"`` (the position), ``"cc"`` (the chain
    operands), ``"v"`` (per-chain array ``idx``), ``"c"`` (the constants
    buffer), ``"g"`` (the gradient output), ``"lp"`` (the log-density output)
    or ``"lit"`` (the literal ``value``);
    ``offset`` and ``strides`` address it over the instruction's loop
    indices. ``dtype`` is ``"f"`` or ``"b"``."""

    kind: str
    idx: int = 0
    offset: int = 0
    strides: tuple = ()
    dtype: str = "f"
    value: Any = None


def _normal(r):
    return (r.abs() >= _FLT_MIN) & (r.abs() <= 3.4028234663852886e38)


def _divr(x, y, r):
    return torch.where(_normal(r), x * r, x / y)


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
    # x log(y) and x log1p(y): NaN where y is, else 0 where x is 0
    "xlogy": (2, torch.xlogy, "(({1} != {1}) ? {1} : (({0} == 0.0f) ? 0.0f : {0} * logf({1})))"),
    "xlog1py": (2, torch.special.xlog1py, "(({1} != {1}) ? {1} : (({0} == 0.0f) ? 0.0f : {0} * log1pf({1})))"),
    "clamp": (3, lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi), "gjt_min(gjt_max({0}, {1}), {2})"),
    "threshold_bwd": (3, lambda g, x, t: torch.where(x <= t, torch.zeros_like(g), g), "(({1} <= {2}) ? 0.0f : {0})"),
    "softplus": (3, lambda x, b, t: torch.where(x * b > t, x, torch.log1p(torch.exp(x * b)) / b),
                 "(({0} * {1} > {2}) ? {0} : log1pf(expf({0} * {1})) / {1})"),
    # x / y as x * r with r = 1 / y where r is normal, else the division
    "divr": (3, _divr, "gjt_divr({0}, {1}, {2})"),
    # the guards of the fast program
    "finite": (1, torch.isfinite, "(fabsf({0}) <= 3.40282347e+38f)"),
    "normal": (1, _normal, "gjt_normal({0})"),
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
# operand kinds that hold per-chain inputs: the position and the chain operands
_INPUTS = ("q", "cc")
# map ops whose two operands commute (common subexpressions of either order)
_COMMUTATIVE = {"add", "mul", "max", "min", "eq", "ne", "and", "or", "xor"}


@dataclasses.dataclass(frozen=True)
class Ins:
    """One instruction. ``kind`` ``"map"``: ``op`` of ``_MAP`` on ``srcs``
    over ``sizes``; ``"reduce"``: ``op`` (sum, max, min, any, all, lse) of
    ``srcs[0]`` over ``rsizes`` for each index of ``sizes``;
    ``"contract"``: the sum over ``rsizes`` of ``srcs[0] * srcs[1]``.
    ``srcs`` are addressed over ``sizes + rsizes``, ``out`` over ``sizes``."""

    kind: str
    op: str
    out: Opd
    srcs: tuple
    sizes: tuple = ()
    rsizes: tuple = ()

    @property
    def loop(self) -> tuple:
        return self.sizes + self.rsizes

    @property
    def iterations(self) -> int:
        return math.prod(self.loop)


@dataclasses.dataclass
class Program:
    """A per-chain program: ``arrays`` (size, dtype) per chain, ``instrs``
    over them, the constants buffer ``consts`` (float32), ``d`` and ``k``
    (chain operands a chain); a fast program also writes ``guards`` flags
    (``"ok"``) and carries the exact ``fallback`` that replaces its results
    where a flag is false."""

    d: int
    arrays: list
    instrs: list
    consts: torch.Tensor
    # the fast program's guards (its "ok" outputs) and, where it has any,
    # the exact program that runs for a chain where one of them is false
    guards: int = 0
    fallback: "Program | None" = None
    k: int = 0

    @property
    def flop(self) -> int:
        """Operations of one ``(lp, grad)``: an element of a map 1 (a
        transcendental too), of a reduction 1 (log-sum-exp 3), of a product
        2 (an FMA); copies and casts none. The fallback, which runs only for
        a chain whose guard fails, is not counted."""
        total = 0
        for ins in self.instrs:
            if ins.kind == "map" and ins.op not in _FREE:
                total += ins.iterations
            elif ins.kind == "reduce":
                total += ins.iterations * (3 if ins.op == "lse" else 1)
            elif ins.kind == "contract":
                total += 2 * ins.iterations
        return total

    def elements(self, *ops: str) -> int:
        """Elements a gradient of the map ops ``ops`` (``"log"``, ...)."""
        return sum(ins.iterations for ins in self.instrs if ins.kind == "map" and ins.op in ops)


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


def run_program(program: Program, q: torch.Tensor, consts: torch.Tensor, c: torch.Tensor | None = None):
    """``(lp (N,), grad (d, N))`` of the program at ``q (d, N)``, with the
    chain operands ``c (k, N)`` where the program takes any."""
    q = q.to(torch.float32).contiguous()
    n = q.shape[1]
    if program.k and (c is None or tuple(c.shape) != (program.k, n)):
        raise ValueError(f"the program takes a ({program.k}, {n}) block of chain operands, got "
                         f"{None if c is None else tuple(c.shape)}")
    env = {
        "device": q.device, "n": n, "q": q, "consts": consts,
        "cc": c.to(device=q.device, dtype=torch.float32).contiguous() if program.k else None,
        "g": torch.zeros((program.d, n), dtype=torch.float32, device=q.device),
        "lp": torch.zeros((1, n), dtype=torch.float32, device=q.device),
        "ok": torch.ones((max(program.guards, 1), n), dtype=torch.bool, device=q.device),
        "v": [torch.empty((size, n), dtype=torch.bool if dt == "b" else torch.float32, device=q.device)
              for size, dt in program.arrays],
    }
    for ins in program.instrs:
        if ins.kind == "map":
            args = [_read(a, ins.sizes, env) for a in ins.srcs]
            _write(ins.out, ins.sizes, _MAP[ins.op][1](*args), env)
            continue
        dims = tuple(range(len(ins.sizes), len(ins.loop)))
        if ins.kind == "contract":
            prod = _read(ins.srcs[0], ins.loop, env) * _read(ins.srcs[1], ins.loop, env)
            _write(ins.out, ins.sizes, prod.sum(dim=dims), env)
            continue
        x = _read(ins.srcs[0], ins.loop, env)
        if ins.op == "sum":
            r = x.sum(dim=dims)
        elif ins.op == "max":
            r = torch.amax(x, dim=dims)
        elif ins.op == "min":
            r = torch.amin(x, dim=dims)
        elif ins.op in ("any", "all"):
            flat = x.flatten(len(ins.sizes), -2)
            r = flat.any(dim=len(ins.sizes)) if ins.op == "any" else flat.all(dim=len(ins.sizes))
        else:
            r = _lse(x, dims)
        _write(ins.out, ins.sizes, r, env)
    lp, g = env["lp"][0], env["g"]
    if program.fallback is not None:
        ok = env["ok"].all(dim=0)
        if not bool(ok.all()):
            lp_x, g_x = run_program(program.fallback, q, consts, c)
            lp, g = torch.where(ok, lp, lp_x), torch.where(ok, g, g_x)
    return lp, g


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
    return f"{s}f" if v >= 0 and not s.startswith("-") else f"({s}f)"


def _index(opd: Opd, ivars) -> str:
    terms = [str(opd.offset)] if opd.offset else []
    for var, s in zip(ivars, opd.strides):
        if s:
            terms.append(var if s == 1 else f"{var} * {s}")
    return " + ".join(terms) or "0"


def _const_read(idx: str, dtype: str) -> str:
    return f"(GJT_C({idx}) != 0.0f)" if dtype == "b" else f"GJT_C({idx})"


def _expr(opd: Opd, ivars, prefix: str = "") -> str:
    """``opd`` read at runtime loop indices ``ivars`` (the loop form; the
    arrays named with ``prefix``)."""
    if opd.kind == "lit":
        return _literal(opd.value, opd.dtype)
    idx = _index(opd, ivars)
    if opd.kind == "c":
        return _const_read(idx, opd.dtype)
    name = {"q": "q", "cc": "cc", "g": "g", "lp": "lp", "ok": "ok"}.get(opd.kind, f"{prefix}v{opd.idx}")
    return f"{name}[{idx}]"


def _loops(sizes, names, body: list, depth: int) -> list:
    """``body`` (lines) inside nested loops over ``sizes``; a unit extent
    takes no loop (its index is 0)."""
    lines, pad = [], "  " * depth
    opened = 0
    for s, var in zip(sizes, names):
        if s == 1:
            lines.append(f"{pad}{'  ' * opened}{{ const int {var} = 0;")
        else:
            lines.append(f"{pad}{'  ' * opened}for (int {var} = 0; {var} < {s}; ++{var}) {{")
        opened += 1
    lines += [f"{pad}{'  ' * opened}{b}" for b in body]
    for k in reversed(range(opened)):
        lines.append(f"{pad}{'  ' * k}}}")
    return lines


_REDUCE_INIT = {"sum": "0.0f", "max": "(-INFINITY)", "min": "INFINITY", "any": "false", "all": "true",
                "lse": "(-INFINITY)"}


def _fold_terms(op: str, terms: list) -> str:
    """A reduction of ``terms`` (atoms) in order, as one C expression."""
    if op in ("sum", "contract"):
        return " + ".join(terms)
    if op in ("any", "all"):
        return "(" + (" || " if op == "any" else " && ").join(terms) + ")"
    fn = "gjt_min" if op == "min" else "gjt_max"
    acc = terms[0]
    for t in terms[1:]:
        acc = f"{fn}({acc}, {t})"
    return acc


class _Emitter:
    """The printer of one program: each instruction of at most
    ``UNROLL_LIMIT`` iterations as straight-line scalar code (an element a
    ``const`` scalar, a copy or a fill no code at all: a name for the same
    value), larger ones as loops over the arrays they touch, which are then
    declared as arrays."""

    def __init__(self, program: Program, prefix: str = "", indent: int = 1):
        self.program = program
        self.prefix, self.pad = prefix, "  " * indent
        self.loop_form = [ins.iterations > UNROLL_LIMIT for ins in program.instrs]
        self.arrays = set()
        for ins, looped in zip(program.instrs, self.loop_form):
            if looped:
                self.arrays.update(o.idx for o in (ins.out, *ins.srcs) if o.kind == "v")
        self.names: dict = {}
        self.lines: list = []
        self.n_temps = 0

    def temp(self, dtype: str, expr: str) -> str:
        name = f"{self.prefix}t{self.n_temps}"
        self.n_temps += 1
        self.lines.append(f"{self.pad}const {'bool' if dtype == 'b' else 'float'} {name} = {expr};")
        return name

    def atom(self, opd: Opd, index) -> str:
        """``opd`` at the compile-time loop index ``index``."""
        if opd.kind == "lit":
            return _literal(opd.value, opd.dtype)
        e = opd.offset + sum(s * i for s, i in zip(opd.strides, index))
        if opd.kind == "c":
            return _const_read(str(e), opd.dtype)
        if opd.kind in _INPUTS:
            return f"{opd.kind}[{e}]"
        if opd.kind == "v" and opd.idx in self.arrays:
            return f"{self.prefix}v{opd.idx}[{e}]"
        if opd.kind == "v":
            return self.names[(opd.idx, e)]
        raise ValueError(f"the program reads its output {opd.kind}")

    def store(self, out: Opd, index, expr: str, copy: bool) -> None:
        e = out.offset + sum(s * i for s, i in zip(out.strides, index))
        if out.kind in ("g", "lp", "ok"):
            self.lines.append(f"{self.pad}{out.kind}[{e}] = {expr};")
        elif out.idx in self.arrays:
            self.lines.append(f"{self.pad}{self.prefix}v{out.idx}[{e}] = {expr};")
        else:
            # a copy of an atom names the same value; a read of an array
            # element is taken now, before the array is written again
            atom = copy and not expr.startswith(f"{self.prefix}v")
            self.names[(out.idx, e)] = expr if atom else self.temp(out.dtype, expr)

    def scalar(self, ins: Ins) -> None:
        if ins.kind == "map":
            template = _MAP[ins.op][2]
            for index in itertools.product(*map(range, ins.sizes)):
                expr = template.format(*(self.atom(s, index) for s in ins.srcs))
                self.store(ins.out, index, expr, ins.op == "copy")
            return
        reds = list(itertools.product(*map(range, ins.rsizes)))
        for index in itertools.product(*map(range, ins.sizes)):
            if ins.kind == "contract":
                terms = [f"{self.atom(ins.srcs[0], index + r)} * {self.atom(ins.srcs[1], index + r)}"
                         for r in reds]
                self.store(ins.out, index, _fold_terms("sum", terms), False)
                continue
            terms = [self.atom(ins.srcs[0], index + r) for r in reds]
            if ins.op != "lse":
                self.store(ins.out, index, _fold_terms(ins.op, terms), False)
                continue
            # log-sum-exp: the maximum first (an infinite one shifts by 0), then the sum
            m = self.temp("f", _fold_terms("max", terms))
            m = self.temp("f", f"fabsf({m}) == INFINITY ? 0.0f : {m}")
            self.store(ins.out, index, f"logf({' + '.join(f'expf({t} - {m})' for t in terms)}) + {m}", False)

    def looped(self, ins: Ins) -> None:
        ivars = [f"i{j}" for j in range(len(ins.sizes))]
        ex = lambda o, v: _expr(o, v, self.prefix)  # noqa: E731
        depth = len(self.pad) // 2
        if ins.kind == "map":
            rhs = _MAP[ins.op][2].format(*[ex(s, ivars) for s in ins.srcs])
            self.lines += [self.pad + "{"] + _loops(ins.sizes, ivars, [f"{ex(ins.out, ivars)} = {rhs};"],
                                                     depth + 1) + [self.pad + "}"]
            return
        rvars = [f"r{j}" for j in range(len(ins.rsizes))]
        op = "sum" if ins.kind == "contract" else ins.op
        if ins.kind == "contract":
            term = f"{ex(ins.srcs[0], ivars + rvars)} * {ex(ins.srcs[1], ivars + rvars)}"
        else:
            term = ex(ins.srcs[0], ivars + rvars)
        step = {"sum": f"acc += {term};", "max": f"acc = gjt_max(acc, {term});",
                "min": f"acc = gjt_min(acc, {term});", "any": f"acc = acc || {term};",
                "all": f"acc = acc && {term};", "lse": f"acc = gjt_max(acc, {term});"}[op]
        inner = [f"{'bool' if op in ('any', 'all') else 'float'} acc = {_REDUCE_INIT[op]};"]
        inner += _loops(ins.rsizes, rvars, [step], 0)
        if op == "lse":
            inner += ["const float m = fabsf(acc) == INFINITY ? 0.0f : acc;", "float s = 0.0f;"]
            inner += _loops(ins.rsizes, rvars, [f"s += expf({term} - m);"], 0)
            inner += ["acc = logf(s) + m;"]
        inner.append(f"{ex(ins.out, ivars)} = acc;")
        self.lines += [self.pad + "{"] + _loops(ins.sizes, ivars, inner, depth + 1) + [self.pad + "}"]

    def body(self) -> list:
        program = self.program
        if program.guards:
            self.lines.append(f"{self.pad}bool ok[{program.guards}];")
        for k in sorted(self.arrays):
            size, dt = program.arrays[k]
            self.lines.append(f"{self.pad}{'bool' if dt == 'b' else 'float'} {self.prefix}v{k}[{size}];")
        for ins, looped in zip(program.instrs, self.loop_form):
            (self.looped if looped else self.scalar)(ins)
        if program.fallback is not None:
            # the exact program where a guard of the fast one failed
            flags = " && ".join(f"ok[{k}]" for k in range(program.guards))
            self.lines.append(f"{self.pad}if (!({flags})) {{")
            self.lines += _Emitter(program.fallback, self.prefix + "x", len(self.pad) // 2 + 1).body()
            self.lines.append(f"{self.pad}}}")
        return self.lines


def emit(program: Program, mode: str) -> str:
    """The program as ``gjt_staged::lp_grad``, a header for K1 and K4 (and
    for a host compiler: ``__host__``/``__device__`` are empty there), its
    constants in ``mode`` (``CONST_MODES``). A program with chain operands
    (``k > 0``) also defines ``GJT_STAGED_CHAIN`` and takes them as
    ``cc``; with none, the header differs from one printed before chain
    operands existed only by its ``kChain`` line."""
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
        f"constexpr int kChain = {program.k};  // chain operands a chain (cc)",
        "// where the constants live: by value in the kernel's parameter space,",
        "// copied to shared memory at block start, or read through __ldg",
        "constexpr int kParamConsts = 0, kSharedConsts = 1, kGlobalConsts = 2;",
        f"constexpr int kConstMode = {CONST_MODES.index(mode)};  // {mode}",
        "",
    ]
    if program.k:
        out += ["#define GJT_STAGED_CHAIN 1",
                f"// a chain's operands in registers (up to {CHAIN_REGISTER_CAP}), else read at each use",
                f"constexpr bool kChainInRegisters = {'true' if program.k <= CHAIN_REGISTER_CAP else 'false'};",
                ""]
    if mode == "global":
        out += ["#if defined(__CUDA_ARCH__)", "#define GJT_C(k) __ldg(consts + (k))", "#else",
                "#define GJT_C(k) consts[k]", "#endif"]
    else:
        out.append("#define GJT_C(k) consts[k]")
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
        "__host__ __device__ inline bool gjt_normal(float r) {",
        "  const float a = fabsf(r);",
        "  return a >= 1.17549435e-38f && a <= 3.40282347e+38f;",
        "}",
        "// x / y as x * r, r = 1 / y, where r is normal; else the division itself",
        "__host__ __device__ inline float gjt_divr(float x, float y, float r) {",
        "  return gjt_normal(r) ? x * r : x / y;",
        "}",
        "",
        "// consts: a pointer to the constants, or (in a kernel) the parameter that",
        "// holds them by value, read by consts[k]",
    ]
    if program.k:
        out += [
            "// cc: the chain's kChain chain operands, read by cc[r]",
            "template <class Chain, class Consts>",
            "__host__ __device__ inline float lp_grad(const float (&q)[kD], float (&g)[kD],",
            "                                         const Chain& cc, const Consts& consts) {",
        ]
    else:
        out += [
            "template <class Consts>",
            "__host__ __device__ inline float lp_grad(const float (&q)[kD], float (&g)[kD],",
            "                                         const Consts& consts) {",
        ]
    out += [
        "  (void)consts;",
        "  float lp[1];",
    ]
    out += _Emitter(program).body()
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
        return body.lp_grad(q)  # a bound body's chain operands too

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output[1])

    @staticmethod
    def backward(ctx, g_lp, _g_grad):
        (grad,) = ctx.saved_tensors
        return g_lp.unsqueeze(0) * grad, None


def const_mode(n_consts: int) -> str:
    """Where ``n_consts`` hoisted constants live in a staged build
    (``CONST_MODES``)."""
    if 4 * n_consts <= PARAM_CAP_BYTES:
        return "param"
    return "shared" if 4 * n_consts <= SMEM_CAP_BYTES else "global"


class StagedBody:
    """A column log-density staged into a device body of K1 and K4: the
    lowered ``program``, its ``header`` (the emitted function), the hoisted
    constants ``consts`` (float32), where they live in the kernel
    (``const_mode``), ``d`` and ``k`` (chain operands a chain). ``lp_grad``
    is the plain version; ``lib()`` builds the kernels with this body. Like
    ``bodies.Body``, it is itself a column log-density ``(d, N) -> (N,)``
    whose ``body`` is itself; a body with chain operands is one once bound
    to its ``(k, N)`` block (``bind``), which the kernels and the twins
    then read (``chain``)."""

    kind = STAGED
    name = "staged"
    n_obs = 0
    d_w = 0
    obs_scale = 0.0

    def __init__(self, program: Program):
        self.program = program
        self.d = program.d
        self.k = program.k
        self.chain = None
        self.consts = program.consts
        self.n_consts = int(program.consts.numel())
        self.const_mode = const_mode(self.n_consts)
        self.header = emit(program, self.const_mode)
        self.digest = hashlib.sha256(self.header.encode()).hexdigest()[:16]
        self._on_device: dict = {}
        self._libs: dict = {}  # stream mode (rbg or not) -> build, shared by bound copies

    @property
    def body(self) -> "StagedBody":
        return self

    @property
    def shared(self) -> bool:
        """Whether a block copies the constants into shared memory."""
        return self.const_mode == "shared"

    @property
    def flop(self) -> int:
        """Operations of one ``(lp, grad)`` (``Program.flop``)."""
        return self.program.flop

    @property
    def chain_read(self) -> str | None:
        """How K1 and K4 read a chain's operands: ``"registers"`` (once a
        sweep, up to ``CHAIN_REGISTER_CAP``), ``"ldg"`` (through ``__ldg`` at
        each gradient, above it), or None where the body takes none."""
        if not self.k:
            return None
        return "registers" if self.k <= CHAIN_REGISTER_CAP else "ldg"

    def min_dim(self) -> int:
        return self.d

    def variant(self, d: int) -> str:
        return "staged"

    def shared_consts_floats(self, d: int) -> int:
        """Floats of the constants a block copies into shared memory (to a
        float4), none where they travel as kernel parameters or are read
        from global memory."""
        return (self.n_consts + 3) // 4 * 4 if self.shared else 0

    def consts_on(self, device: torch.device) -> torch.Tensor:
        """The constants on ``device``, copied there once (one float where
        there are none, so the kernel gets a valid pointer)."""
        key = str(device)
        if key not in self._on_device:
            c = self.consts if self.n_consts else torch.zeros(1)
            self._on_device[key] = c.to(device).contiguous()
        return self._on_device[key]

    def bind(self, chain: torch.Tensor) -> "StagedBody":
        """This body bound to the chain operands ``chain (k, N)``: a copy
        that shares the program and the build, whose ``lp_grad``, call and
        launches read ``chain``."""
        if not self.k:
            raise ValueError("the staged body takes no chain operands")
        if not isinstance(chain, torch.Tensor) or chain.ndim != 2 or chain.shape[0] != self.k:
            raise ValueError(f"the staged body takes a (k={self.k}, N) block of chain operands, got "
                             f"{tuple(chain.shape) if isinstance(chain, torch.Tensor) else type(chain).__name__}")
        bound = copy.copy(self)
        bound.chain = chain
        return bound

    def lp_grad(self, q: torch.Tensor, c: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """The plain version: ``(lp (N,), grad (d, N))`` at ``q (d, N)``,
        the lowered program run with torch, on the chain operands ``c (k,
        N)`` (the bound block where none is given)."""
        if q.shape[0] != self.d:
            raise ValueError(f"the staged body takes d={self.d} rows, got {tuple(q.shape)}")
        c = self.chain if c is None else c
        return run_program(self.program, q.detach(), self.consts_on(q.device),
                           None if c is None else c.detach())

    def lib(self, rbg: bool = False):
        """K1 and K4 built with this body (``_build.load_staged``; their rbg
        kernels with ``rbg=True``), loaded once: a launch reads no source and
        hashes nothing."""
        if rbg not in self._libs:
            from . import _build

            self._libs[rbg] = _build.load_staged(self.header, rbg)
        return self._libs[rbg]

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        return _StagedLp.apply(q, self)[0]

    def __repr__(self) -> str:
        return (f"StagedBody(d={self.d}, k={self.k}, {len(self.program.instrs)} instructions, "
                f"{self.n_consts} constants ({self.const_mode}), {self.flop} operations a gradient)")


# ----------------------------------------------------------------------
# staging: trace, fold, lower
# ----------------------------------------------------------------------


@dataclasses.dataclass
class _Val:
    """A node's lowering: its full shape (with the chain extent of trace 1
    at ``chain``, or no chain axis), dtype, and either a folded constant
    (``const``, over the non-chain dims; ``literal`` when the graph alone
    wrote it), a strided view of per-chain data (``opd``, strides over the
    non-chain dims), or ``pieces``: zeros but for pieces ``(offset,
    strides, sizes, src)`` of its row-major non-chain layout, each a copy of
    ``src`` (the gradient's scatters, until something reads them)."""

    shape: tuple
    chain: int | None
    dtype: str
    const: Any = None
    literal: bool = False
    opd: Opd | None = None
    pieces: tuple | None = None

    @property
    def sizes(self) -> tuple:
        return tuple(s for k, s in enumerate(self.shape) if k != self.chain)


_DATA_DEPENDENT = {"_local_scalar_dense", "is_nonzero", "item", "equal", "allclose", "nonzero"}
# ops whose value depends on the shape of their input and not on its data
_SHAPE_ONLY = {"ones_like", "zeros_like", "full_like", "empty_like", "new_zeros", "new_ones",
               "new_full", "new_empty", "scalar_tensor", "sym_size"}
_IDENTITY = {"alias", "detach", "clone", "lift_fresh_copy", "contiguous", "_unsafe_view_copy"}
# ops that read the pieces of a scattered gradient as they are
_PIECEWISE = {"add", "slice_backward", "select_backward", "permute", "t", "transpose", "view", "_unsafe_view",
              "reshape", "unsqueeze", "squeeze"}


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


def _row_major(sizes) -> tuple:
    strides, acc = [], 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


def _canon(opd: Opd, loop) -> Opd:
    """``opd`` with stride 0 on every unit axis of ``loop`` (a literal
    with no addressing): equal reads compare equal."""
    if opd.kind == "lit":
        return Opd("lit", dtype=opd.dtype, value=opd.value)
    strides = tuple(0 if n == 1 else s for s, n in zip(opd.strides, loop))
    return opd if strides == opd.strides else dataclasses.replace(opd, strides=strides)


def _varying(ops, j: int) -> bool:
    return any(o.kind != "lit" and o.strides[j] != 0 for o in ops)


class _Lowering:
    """The program under construction: per-chain arrays, instructions and
    the hoisted constants (deduplicated by content)."""

    def __init__(self):
        self.arrays: list = []
        self.instrs: list = []
        self.consts: list = []  # flat float32 numpy chunks
        self.n_consts = 0
        self.const_index: dict = {}
        self._flat = None
        self._dense: dict = {}

    # ---- storage
    def new_array(self, size: int, dtype: str) -> int:
        self.arrays.append((size, dtype))
        return len(self.arrays) - 1

    def new_out(self, loop, dtype: str) -> Opd:
        """A new array written whole by an instruction over ``loop``."""
        return _canon(Opd("v", self.new_array(math.prod(loop), dtype), 0, _row_major(loop), dtype), loop)

    def add_const(self, flat: np.ndarray) -> int:
        """The offset of the float32 chunk ``flat`` in the buffer (one copy
        of each content)."""
        flat = np.ascontiguousarray(flat, dtype=np.float32).reshape(-1)
        key = (flat.size, flat.tobytes())
        if key not in self.const_index:
            self.const_index[key] = self.n_consts
            self.consts.append(flat)
            self.n_consts += flat.size
            self._flat = None
        return self.const_index[key]

    def const_values(self, opd: Opd, loop) -> np.ndarray:
        """The constants ``opd`` reads over ``loop``, float32."""
        if opd.kind == "lit":
            return np.full(loop, np.float32(opd.value), np.float32)
        if self._flat is None:
            self._flat = np.concatenate(self.consts) if self.consts else np.zeros(0, np.float32)
        return self._flat[_addr(opd, loop)]

    def const_like(self, values: np.ndarray, uniform) -> Opd:
        """Constants ``values`` (over a loop) stored once along the loop
        axes ``uniform`` (on which they do not vary): an operand."""
        index = tuple(slice(0, 1) if j in uniform else slice(None) for j in range(values.ndim))
        part = values[index]
        offset = self.add_const(part)
        strides = tuple(0 if j in uniform else s for j, s in enumerate(_row_major(part.shape)))
        return _canon(Opd("c", 0, offset, strides, "f"), values.shape)

    def const_opd(self, val: _Val, out_shape, out_chain) -> Opd:
        """An operand reading the folded constant ``val`` broadcast to the
        output; a constant of one element the graph wrote is a literal."""
        t = val.const
        dtype = val.dtype
        # collapse the broadcast (stride-0) dims of an expanded constant, and
        # a constant whose elements are all one value to that value
        index = tuple(slice(0, 1) if (st == 0 and sz > 1) else slice(None) for sz, st in zip(t.shape, t.stride()))
        t = t[index]
        if t.numel() == 1 and val.literal:
            v = t.reshape(()).item()
            return Opd("lit", dtype=dtype, value=bool(v) if dtype == "b" else float(v))
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
        offset = self.add_const(base.numpy())
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
        x = self.dense(x)
        if x.opd is None:
            return self.const_opd(x, out_shape, out_chain)
        return self._align(x.opd, x.shape, x.chain, out_shape, out_chain)

    def dense(self, x):
        """``x`` with its pieces (if any) written into an array of zeros."""
        if not isinstance(x, _Val) or x.pieces is None:
            return x
        if id(x) not in self._dense:
            sizes = x.sizes
            k = self.new_array(math.prod(sizes), x.dtype)
            zero = False if x.dtype == "b" else 0.0
            if _covered(x.pieces, sizes).sum() < math.prod(sizes):
                whole = (math.prod(sizes),)
                self.instrs.append(Ins("map", "copy", _canon(Opd("v", k, 0, (1,), x.dtype), whole),
                                       (Opd("lit", dtype=x.dtype, value=zero),), whole))
            for off, strides, psizes, src in x.pieces:
                self.instrs.append(Ins("map", "copy", _canon(Opd("v", k, off, strides, x.dtype), psizes),
                                       (src,), psizes))
            self._dense[id(x)] = (x, _Val(x.shape, x.chain, x.dtype,
                                          opd=_canon(Opd("v", k, 0, _row_major(sizes), x.dtype), sizes)))
        return self._dense[id(x)][1]

    # ---- instructions
    def map(self, op: str, args, shape, chain, dtype: str) -> _Val:
        sizes = tuple(s for k, s in enumerate(shape) if k != chain)
        ops = [self.operand(a, shape, chain) for a in args]
        return _Val(tuple(shape), chain, dtype, opd=self.map_opds(op, ops, sizes, dtype))

    def map_opds(self, op: str, ops, sizes, dtype: str) -> Opd:
        """``op`` on ``ops`` (strides over ``sizes``), run once along every
        axis on which no operand varies: the result's view over ``sizes``."""
        keep = [j for j, n in enumerate(sizes) if n > 1 and _varying(ops, j)]
        loop = tuple(sizes[j] for j in keep)
        ops = tuple(o if o.kind == "lit" else _canon(dataclasses.replace(o, strides=tuple(o.strides[j] for j in keep)),
                                                     loop) for o in ops)
        out = self.new_out(loop, dtype)
        self.instrs.append(Ins("map", op, out, ops, loop))
        return _spread(out, keep, len(sizes))

    def materialize(self, x: _Val) -> _Val:
        """``x`` copied into an array of its own, row-major."""
        sizes = x.sizes
        k = self.new_array(math.prod(sizes), x.dtype)
        out = _canon(Opd("v", k, 0, _row_major(sizes), x.dtype), sizes)
        self.instrs.append(Ins("map", "copy", out, (self.operand(x, x.shape, x.chain),), sizes))
        return _Val(x.shape, x.chain, x.dtype, opd=out)


def _spread(out: Opd, keep, rank: int) -> Opd:
    """``out``, written over the axes ``keep`` of a loop of ``rank`` axes,
    as a view over all of them (stride 0 on the others)."""
    it = iter(out.strides)
    strides = tuple(next(it) if j in keep else 0 for j in range(rank))
    return dataclasses.replace(out, strides=strides)


def _grid(loop) -> list:
    return list(np.indices(loop, dtype=np.int64)) if loop else []


def _addr(opd: Opd, loop) -> np.ndarray:
    """The element ``opd`` reads at each index of ``loop``."""
    return np.asarray(opd.offset + sum((s * g for s, g in zip(opd.strides, _grid(loop))),
                                       np.zeros(loop, np.int64)), np.int64)


_COMPOSE_LIMIT = 1 << 20


def _fit(idx: np.ndarray, like: Opd) -> Opd | None:
    """``like`` addressing the elements ``idx`` (over a loop), if an
    offset and strides do."""
    flat = idx.reshape(-1)
    base = int(flat[0]) if flat.size else 0
    strides = []
    for j, n in enumerate(idx.shape):
        unit = tuple(1 if t == j else 0 for t in range(idx.ndim))
        strides.append(int(idx[unit]) - base if n > 1 else 0)
    opd = dataclasses.replace(like, offset=base, strides=tuple(strides))
    return opd if np.array_equal(_addr(opd, idx.shape), idx) else None


def _compose(inner: Opd, inner_loop, view: Opd, loop) -> Opd | None:
    """What ``inner`` (addressed over ``inner_loop``) gives at each index of
    ``loop``, where ``view`` reads the row-major array that an instruction
    over ``inner_loop`` wrote from it; None if no strides express it."""
    if inner.kind == "lit":
        return inner
    if math.prod(loop) > _COMPOSE_LIMIT:
        return None
    e = _addr(view, loop)
    m = np.unravel_index(e, inner_loop) if inner_loop else ()
    idx = inner.offset + sum((s * mj for s, mj in zip(inner.strides, m)), np.zeros(loop, np.int64))
    return _fit(np.asarray(idx, np.int64), inner)


def _piece(off: int, strides, psizes, src: Opd) -> tuple:
    """A piece ``(offset, strides, sizes, src)`` without its unit axes, so
    that two pieces of the same elements compare equal."""
    keep = [j for j, n in enumerate(psizes) if n > 1]
    if src.kind != "lit":
        src = dataclasses.replace(src, strides=tuple(src.strides[j] for j in keep))
    return (off, tuple(strides[j] for j in keep), tuple(psizes[j] for j in keep), src)


def _covered(pieces, sizes) -> np.ndarray:
    """How many pieces cover each element of a row-major layout of
    ``sizes`` (flat)."""
    count = np.zeros(math.prod(sizes), np.int64)
    for off, strides, psizes, _ in pieces:
        np.add.at(count, _addr(Opd("v", 0, off, strides), psizes).reshape(-1), 1)
    return count


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


def _chain_at(chain: torch.Tensor | None, p: int, device):
    """The chain operands of a trace at ``p`` chains: the example block's
    columns in turn (so each keeps a value some chain holds), or None."""
    if chain is None:
        return None
    return chain.detach().to(device=device, dtype=torch.float32)[:, torch.arange(p) % chain.shape[1]].contiguous()


def _trace(logdensity_cols: Callable, d: int, p: int, device, chain):
    from torch.fx.experimental.proxy_tensor import make_fx

    def lp_and_grad(q, *c):
        lp, vjp = torch.func.vjp(lambda x: logdensity_cols(x, *c), q)
        (grad,) = vjp(torch.ones_like(lp))
        return lp, grad

    gen = torch.Generator(device="cpu").manual_seed(0)
    q = (0.5 + torch.rand((d, p), generator=gen)).to(device)
    inputs = (q,) if chain is None else (q, _chain_at(chain, p, device))
    try:
        gm = make_fx(lp_and_grad, tracing_mode="real")(*inputs)
    except Exception as err:  # the density could not be traced at all
        text = f"{type(err).__name__}: {err}".splitlines()[0][:300]
        for op in sorted(_DATA_DEPENDENT):
            if op in text or (op == "item" and ".item()" in text):
                raise _refuse(f"the density reads a value to the host (aten.{op}: {text})") from err
        raise _refuse(f"the density could not be traced at {p} chains ({text})") from err
    return gm, inputs


def _record(gm, inputs) -> dict:
    vals = {}

    class Rec(torch.fx.Interpreter):
        def run_node(self, n):
            out = super().run_node(n)
            vals[n] = out
            return out

    with torch.no_grad():
        Rec(gm).run(*inputs)
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


def stage_body(logdensity_cols: Callable, d: int, *, device=None, chain: torch.Tensor | None = None) -> StagedBody:
    """Stage ``logdensity_cols`` (``(d, N) -> (N,)``) into a device body of
    the sweep kernels, tracing on ``device`` (the CPU by default): the
    lowered and simplified program, its emitted function and its hoisted
    constants. With ``chain``, a ``(k, N)`` float32 block of chain operands
    (``k >= 1``; its columns are what the traces' chains hold), the density
    is ``logdensity_cols(q, c)`` and the body takes ``k`` chain operands
    (bind it to a block, ``StagedBody.bind``, before a launch). Raises a
    ``ValueError`` naming the aten op and ``backend='torch'`` for a density
    outside the op set (module docstring)."""
    if getattr(logdensity_cols, "row_shard", None) is not None:
        raise _refuse("the density is row-sharded (.row_shard): its rows are summed by a collective "
                      "over the model axis, which no device body issues")
    if getattr(logdensity_cols, "collective_axis", None) is not None:
        raise _refuse(f"the density sums over the mesh axis {logdensity_cols.collective_axis!r} with a "
                      "collective (an all_reduce), which no device body issues")
    if not (isinstance(d, int) and 1 <= d <= MAX_D):
        raise _refuse(f"D={d} is outside 1..{MAX_D}, the dimensions a staged K1 build takes")
    if chain is not None and (chain.ndim != 2 or chain.shape[0] < 1 or chain.shape[1] < 1):
        raise ValueError(f"stage_body: chain operands are a (k >= 1, N >= 1) block, got {tuple(chain.shape)}")
    k = 0 if chain is None else int(chain.shape[0])
    device = torch.device("cpu") if device is None else torch.device(device)
    p1, p2 = CHAIN_EXTENTS
    # one call first, so that what a density makes at its first call and
    # keeps (a constant it caches) is the same in both traces
    with torch.no_grad():
        try:
            first = () if chain is None else (_chain_at(chain, p1, device),)
            logdensity_cols(0.5 + torch.zeros((d, p1), device=device), *first)
        except Exception as err:
            text = f"{type(err).__name__}: {err}".splitlines()[0][:300]
            raise _refuse(f"the density fails on a ({d}, {p1}) block ({text})") from err
    gm1, in1 = _trace(logdensity_cols, d, p1, device, chain)
    gm2, in2 = _trace(logdensity_cols, d, p2, device, chain)
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
    vals1, vals2 = _record(gm1, in1), _record(gm2, in2)
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
            # the position, then the chain operands: chain data from the start
            kind, rows = ("q", d) if not env else ("cc", k)
            env[n1] = _Val((rows, p1), 1, "f", opd=Opd(kind, 0, 0, (1,), "f"))
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
                               low.dense(env[n1.args[0]]), [n1.args[1]], shape, chain, _dtype_of(v1[0])), None)
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
    low.instrs.append(Ins("map", "copy", Opd("lp", 0, 0, (), "f"), (low.operand(lp_val, (p1,), 0),), ()))
    if isinstance(grad_val, _Val) and grad_val.pieces is not None:
        # the scattered gradient written piece by piece into g, zeros where none lands
        if _covered(grad_val.pieces, (d,)).sum() < d:
            low.instrs.append(Ins("map", "copy", Opd("g", 0, 0, (1,), "f"), (Opd("lit", value=0.0),), (d,)))
        for off, strides, psizes, src in grad_val.pieces:
            low.instrs.append(Ins("map", "copy", _canon(Opd("g", 0, off, strides, "f"), psizes), (src,), psizes))
    else:
        low.instrs.append(Ins("map", "copy", Opd("g", 0, 0, (1,), "f"), (low.operand(grad_val, (d, p1), 1),), (d,)))
    exact = _Simplifier(low).run(low.instrs)
    fast = _Simplifier(low, guarded=True)
    fast_instrs = fast.run(low.instrs)
    guards = sorted({i.out.offset for i in fast_instrs if i.out.kind == "ok"})
    consts, (exact, fast_instrs) = _compact_consts(low, [exact, fast_instrs])
    program = Program(d, *_compact(low.arrays, exact), consts, k=k)
    if guards and Program(d, low.arrays, fast_instrs, consts).flop < program.flop:
        renumber = {j: i for i, j in enumerate(guards)}
        fast_instrs = [dataclasses.replace(i, out=dataclasses.replace(i.out, offset=renumber[i.out.offset]))
                       if i.out.kind == "ok" else i for i in fast_instrs]
        program = Program(d, *_compact(low.arrays, fast_instrs), consts, len(guards), program, k=k)
    return StagedBody(program)


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


def _scatter(low: _Lowering, grad, shape, chain, dtype, off: int, fs: list, sub_shape, sub_chain) -> _Val:
    """``grad`` (of ``sub_shape``) placed in zeros of ``shape`` at ``off``
    with strides ``fs`` (over ``sub_shape``'s dims, the chain's None): the
    pieces of the result."""
    sub_sizes = tuple(s for j, s in enumerate(sub_shape) if j != sub_chain)
    dst = Opd("v", 0, off, tuple(s for s in fs if s is not None))
    if isinstance(grad, _Val) and grad.pieces is not None:
        pieces = []
        for p_off, p_strides, psizes, src in grad.pieces:
            placed = _compose(dst, sub_sizes, Opd("v", 0, p_off, p_strides), psizes)
            if placed is None:
                return _scatter(low, low.dense(grad), shape, chain, dtype, off, fs, sub_shape, sub_chain)
            pieces.append(_piece(placed.offset, placed.strides, psizes, src))
        return _Val(tuple(shape), chain, dtype, pieces=tuple(pieces))
    src = low.operand(grad, sub_shape, sub_chain)
    return _Val(tuple(shape), chain, dtype, pieces=(_piece(dst.offset, dst.strides, sub_sizes, src),))


def _lower(low: _Lowering, n, name: str, env, shape, chain, dtype) -> _Val:
    base = name[:-1] if name.endswith("_") else name
    dense = (lambda a: a) if base in _PIECEWISE else low.dense
    args = list(torch.fx.node.map_arg(n.args, lambda a: dense(env[a])))
    kw = dict(torch.fx.node.map_arg(n.kwargs, lambda a: dense(env[a])))
    overload = getattr(n.target, "_overloadname", "")
    full = _full_name(n.target)

    def chain_arg(x):
        if not isinstance(x, _Val) or x.opd is None:
            raise _refuse(f"{full} on a folded constant where chain data was expected")
        return x

    # ---- layout: views of the per-chain data
    if base in _IDENTITY:
        return env[n.args[0]]
    if isinstance(args[0], _Val) and args[0].pieces is not None and base in _PIECEWISE - {"add"} - _SCATTERS:
        relaid = _relaid(args[0], base, args, shape, chain)
        if relaid is not None:
            return relaid
        args[0] = low.dense(args[0])
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

    # ---- scatters of the gradient trace: a piece of zeros
    if base in ("slice_backward", "select_backward"):
        grad = args[0]
        sizes_in = list(args[1])
        dim = _norm(args[2], len(sizes_in))
        if dim == chain:
            if base == "slice_backward" and (args[3], min(args[4], shape[chain]), args[5]) == (0, shape[chain], 1):
                return low.dense(grad)
            raise _refuse(f"{full} scatters along the chain axis")
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
        return _scatter(low, grad, shape, chain, dtype, off, fs, sub_shape, sub_chain)
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
        "square": "square", "xlogy": "xlogy", "special_xlog1py": "xlog1py",
    }
    if base in ("bitwise_not", "bitwise_and", "bitwise_or", "bitwise_xor") and dtype != "b":
        raise _refuse(f"{full} on integer bits")
    if base == "div" and kw.get("rounding_mode") is not None:
        raise _refuse(f"{full} with rounding_mode={kw['rounding_mode']!r}")
    if base in ("add", "sub", "rsub"):
        a, b = args[0], args[1]
        alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
        if base == "add" and alpha == 1 and (pieces := _sum_of_pieces(low, a, b, shape, chain, dtype)):
            return _Val(tuple(shape), chain, dtype, pieces=pieces)
        a, b = low.dense(a), low.dense(b)
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


_SCATTERS = {"slice_backward", "select_backward"}


def _relaid(x: _Val, base: str, args, shape, chain) -> _Val:
    """A layout op on a scattered gradient: its pieces placed in the
    result's row-major layout. A view or reshape that keeps the chain axis
    between the same model extents keeps the layout; a permutation moves
    every piece; None where no strides place one."""
    if base not in ("permute", "t", "transpose"):
        before, after = math.prod(x.shape[: x.chain]), math.prod(x.shape[x.chain + 1:])
        if (before, after) != (math.prod(shape[:chain]), math.prod(shape[chain + 1:])):
            raise _refuse(f"aten.{base} merges or splits the chain axis ({x.shape} -> {tuple(shape)})")
        return _Val(tuple(shape), chain, x.dtype, pieces=x.pieces)
    rank = len(x.shape)
    if base == "permute":
        perm = [_norm(k, rank) for k in args[1]]
    else:
        a, b = (0, 1) if base == "t" else (_norm(args[1], rank), _norm(args[2], rank))
        perm = list(range(rank))
        perm[a], perm[b] = perm[b], perm[a]
    new_chain = perm.index(x.chain)
    new_sizes = [x.shape[k] for k in perm if k != x.chain]
    rm = dict(zip([k for k in perm if k != x.chain], _row_major(new_sizes)))
    # each element's place in the new layout, over the old layout's axes
    to_new = Opd("v", 0, 0, tuple(rm[k] for k in range(rank) if k != x.chain))
    pieces = []
    for off, strides, psizes, src in x.pieces:
        placed = _compose(to_new, x.sizes, Opd("v", 0, off, strides), psizes)
        if placed is None:
            return None
        pieces.append(_piece(placed.offset, placed.strides, psizes, src))
    return _Val(tuple(x.shape[k] for k in perm), new_chain, x.dtype, pieces=tuple(pieces))


_EXPLODE_LIMIT = 64


def _elements(piece) -> list:
    """A piece as one piece for each of its elements."""
    off, strides, psizes, src = piece
    out = []
    for index in itertools.product(*map(range, psizes)):
        at = src if src.kind == "lit" else dataclasses.replace(
            src, offset=src.offset + sum(s * i for s, i in zip(src.strides, index)), strides=())
        out.append((off + sum(s * i for s, i in zip(strides, index)), (), (), at))
    return out


def _sum_of_pieces(low: _Lowering, a, b, shape, chain, dtype):
    """The pieces of ``a + b`` where both are scattered gradients of the
    result's shape: pieces that cover the same elements summed by one
    instruction, pieces that meet in part first split into their elements
    (up to ``_EXPLODE_LIMIT`` of them); else None."""
    if not all(isinstance(x, _Val) and x.pieces is not None and x.shape == tuple(shape) and x.chain == chain
               for x in (a, b)):
        return None
    sizes = tuple(s for j, s in enumerate(shape) if j != chain)
    size = math.prod(sizes)

    def where(piece) -> set:
        return set(_addr(Opd("v", 0, piece[0], piece[1]), piece[2]).reshape(-1).tolist())

    pieces = list(a.pieces)
    todo = list(b.pieces)
    while todo:
        pb = todo.pop(0)
        hit = [k for k, pa in enumerate(pieces) if where(pa) & where(pb)]
        if not hit:
            pieces.append(pb)
        elif len(hit) == 1 and pieces[hit[0]][:3] == pb[:3]:
            off, strides, psizes, src = pieces[hit[0]]
            pieces[hit[0]] = (off, strides, psizes, low.map_opds("add", (src, pb[3]), psizes, dtype))
        elif sum(math.prod(pieces[k][2]) for k in hit) + math.prod(pb[2]) <= _EXPLODE_LIMIT and (
                len(hit) > 1 or math.prod(pb[2]) > 1 or math.prod(pieces[hit[0]][2]) > 1):
            split = [e for k in hit for e in _elements(pieces[k])]
            pieces = [p for k, p in enumerate(pieces) if k not in hit] + split
            todo = _elements(pb) + todo
        else:
            return None
    return tuple(pieces) if bool((_covered(pieces, sizes) <= 1).all()) and size else None


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
        sub_sizes = tuple(s for j, s in enumerate(sub_shape) if j != chain)
        dst = _canon(Opd("v", k, start * fs[dim], tuple(s for s in fs if s is not None), dtype), sub_sizes)
        low.instrs.append(Ins("map", "copy", dst, (low.operand(t, sub_shape, chain),), sub_sizes))
        start += t_shape[dim]
    return _Val(tuple(shape), chain, dtype, opd=_canon(Opd("v", k, 0, _row_major(sizes), dtype), sizes))


def _restride(strides, sizes, out_sizes):
    """``strides`` over ``sizes`` as strides over ``out_sizes``, the same
    extents with unit ones added or dropped; None if they differ."""
    it = [(s, z) for s, z in zip(strides, sizes) if z != 1]
    out, j = [], 0
    for z in out_sizes:
        if z == 1:
            out.append(0)
        elif j < len(it) and it[j][1] == z:
            out.append(it[j][0])
            j += 1
        else:
            return None
    return tuple(out) if j == len(it) else None


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
    keep = [k for k in range(rank) if k not in dims and k != x.chain]
    k_sizes = tuple(x.shape[k] for k in keep)
    out_sizes = tuple(s for j, s in enumerate(shape) if j != chain)
    if math.prod(out_sizes) != math.prod(k_sizes):
        raise _refuse(f"{full} keeps {k_sizes}, traced {shape}")
    # the source varies along these axes; along the others it is one value
    red_var = [k for k in dims if fs[k] != 0 and x.shape[k] > 1]
    keep_var = [k for k in keep if fs[k] != 0 and x.shape[k] > 1]
    loop = tuple(x.shape[k] for k in keep_var)
    if red_var:
        out = low.new_out(loop, dtype)
        src = _canon(dataclasses.replace(x.opd, strides=tuple(fs[k] for k in keep_var + red_var)),
                     loop + tuple(x.shape[k] for k in red_var))
        low.instrs.append(Ins("reduce", op, out, (src,), loop, tuple(x.shape[k] for k in red_var)))
        res = _spread(out, [keep.index(k) for k in keep_var], len(keep))
    else:
        res = dataclasses.replace(x.opd, strides=tuple(fs[k] for k in keep))
    strides = _restride(res.strides, k_sizes, out_sizes)
    if strides is None:
        val = low.materialize(_Val(tuple(x.shape[k] for k in keep) + (shape[chain],), len(keep), dtype, opd=res))
        strides, res = _row_major(out_sizes), val.opd
    val = _Val(tuple(shape), chain, dtype, opd=_canon(dataclasses.replace(res, strides=strides), out_sizes))
    repeats = math.prod(x.shape[k] for k in dims if k not in red_var)
    if repeats > 1 and op == "sum":
        val = low.map("mul", [val, float(repeats)], shape, chain, dtype)
    elif repeats > 1 and op == "lse":
        val = low.map("add", [val, float(np.log(np.float32(repeats)))], shape, chain, dtype)
    if base == "mean":
        val = low.map("mul", [val, 1.0 / math.prod(x.shape[k] for k in dims)], shape, chain, dtype)
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
    chain_label = lo[chain]
    out_labels = [c for c in lo if c != chain_label]
    loop_labels = out_labels + red
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
    # run once along the axes on which neither operand varies
    n_out = len(out_labels)
    out_var = [j for j in range(n_out) if extent[out_labels[j]] > 1 and _varying(operands, j)]
    red_var = [j for j in range(n_out, len(loop_labels)) if extent[loop_labels[j]] > 1 and _varying(operands, j)]
    repeats = math.prod(extent[loop_labels[j]] for j in range(n_out, len(loop_labels)) if j not in red_var)
    loop = tuple(extent[out_labels[j]] for j in out_var)
    rloop = tuple(extent[loop_labels[j]] for j in red_var)
    operands = tuple(o if o.kind == "lit" else _canon(dataclasses.replace(o, strides=tuple(
        o.strides[j] for j in out_var + red_var)), loop + rloop) for o in operands)
    if red_var:
        out = low.new_out(loop, dtype)
        low.instrs.append(Ins("contract", "sum", out, operands, loop, rloop))
        res = _spread(out, out_var, n_out)
    else:
        res = _spread(low.map_opds("mul", operands, loop, dtype), out_var, n_out)
    val = _Val(tuple(shape), chain, dtype, opd=_canon(res, out_sizes))
    if repeats > 1:
        val = low.map("mul", [val, float(repeats)], shape, chain, dtype)
    return val


# ----------------------------------------------------------------------
# simplification of the lowered program
# ----------------------------------------------------------------------


def _lit(o: Opd, value=None) -> bool:
    """A float literal the graph wrote (of ``value``, if given)."""
    return o.kind == "lit" and o.dtype == "f" and (value is None or o.value == value)


def _multiplier(o: Opd) -> bool:
    """A multiplier known at stage time: a finite float literal or hoisted
    constants."""
    return (_lit(o) and math.isfinite(o.value)) or (o.kind == "c" and o.dtype == "f")


def _f32(v: float) -> float:
    return float(np.float32(v))


class _Simplifier:
    """Rewrites of the lowered program, run to a fixed point. Each round
    visits the instructions in order: operands read through copies (copy
    forwarding) and merged arrays, then one rewrite of the instruction, then
    common-subexpression elimination; dead code goes after each round.
    A rewrite reads the instruction that wrote an operand's array
    (``through``) and may replace the instruction by a short sequence that
    writes the same result. The division pass (``_reciprocals``) runs on
    the result, and the rounds again after it."""

    ROUNDS = 64

    def __init__(self, low: _Lowering, guarded: bool = False):
        self.low = low
        # the fast program's rewrites: a chain scalar taken out of a sum as a
        # multiplier (where it is finite) or a divisor (where its reciprocal
        # is normal), each with a guard (an "ok" output) for the fallback
        self.guarded = guarded
        self.guards = 0

    def guard(self, op: str, x: Opd) -> Ins:
        out = Opd("ok", 0, self.guards, (), "b")
        self.guards += 1
        return Ins("map", op, out, (_canon(dataclasses.replace(x, strides=()), ()),), ())

    def run(self, instrs: list) -> list:
        instrs = self.fixed_point(instrs)
        return self.fixed_point(self.reciprocals(instrs))

    def fixed_point(self, instrs: list) -> list:
        for _ in range(self.ROUNDS):
            instrs, changed = self.round(instrs)
            instrs = _dead_code(instrs)
            if not changed:
                break
        return instrs

    # ---- one round
    def round(self, instrs: list):
        writes = collections.Counter(i.out.idx for i in instrs if i.out.kind == "v")
        self.uses = collections.Counter(s.idx for i in instrs for s in i.srcs if s.kind == "v")
        self.current: dict = {}  # array -> the instruction that writes it whole, as rewritten
        self.alias: dict = {}  # array -> the array of the same value
        seen: dict = {}
        out, changed = [], False
        for ins in instrs:
            srcs = tuple(self.resolve(s, ins.loop) for s in ins.srcs)
            if srcs != ins.srcs:
                ins, changed = dataclasses.replace(ins, srcs=srcs), True
            new = self.rewrite(ins)
            if new is None:
                new = [ins]
            else:
                changed = True
            for j, step in enumerate(new):
                if j:  # a step may read what an earlier one wrote, or its merged array
                    step = dataclasses.replace(step, srcs=tuple(self.resolve(x, step.loop) for x in step.srcs))
                whole = step.out.kind == "v" and (j < len(new) - 1 or writes[step.out.idx] == 1) and (
                    step.out == _canon(Opd("v", step.out.idx, 0, _row_major(step.sizes), step.out.dtype), step.sizes)
                    and math.prod(step.sizes) == self.low.arrays[step.out.idx][0])
                if j < len(new) - 1 and step.out.kind == "v":
                    self.uses[step.out.idx] = 1
                if whole:
                    key = _cse_key(step)
                    if key in seen:
                        self.alias[step.out.idx] = seen[key]
                        changed = True
                        continue
                    seen[key] = step.out.idx
                    self.current[step.out.idx] = step
                out.append(step)
        return out, changed

    def resolve(self, opd: Opd, loop) -> Opd:
        """``opd`` read through merged arrays and copies."""
        for _ in range(64):
            if opd.kind != "v":
                break
            if opd.idx in self.alias:
                opd = dataclasses.replace(opd, idx=self.alias[opd.idx])
                continue
            writer = self.current.get(opd.idx)
            if writer is None or writer.kind != "map" or writer.op != "copy":
                break
            inner = _compose(writer.srcs[0], writer.sizes, opd, loop)
            if inner is None:
                break
            opd = inner
        return _canon(opd, loop)

    def through(self, opd: Opd, loop):
        """``(op, operands, single_use)`` of the map that wrote ``opd``'s
        array, its operands read over ``loop``; None where no map wrote it
        whole or no strides express them."""
        if opd.kind != "v":
            return None
        writer = self.current.get(opd.idx)
        if writer is None or writer.kind != "map":
            return None
        srcs = [_compose(s, writer.sizes, opd, loop) for s in writer.srcs]
        if any(s is None for s in srcs):
            return None
        return writer.op, [_canon(s, loop) for s in srcs], self.uses[opd.idx] == 1

    def tmp(self, loop, dtype: str = "f") -> Opd:
        return self.low.new_out(loop, dtype)

    # ---- stage-time arithmetic on literals and hoisted constants
    def product(self, a: Opd, b: Opd, loop):
        """``a * b`` of two stage-time multipliers over ``loop``, finite, or
        None."""
        with np.errstate(over="ignore", invalid="ignore"):
            if a.kind == "lit" and b.kind == "lit":
                v = np.float32(a.value) * np.float32(b.value)
                return Opd("lit", value=float(v)) if np.isfinite(v) else None
            vals = self.low.const_values(a, loop) * self.low.const_values(b, loop)
        if not np.isfinite(vals).all():
            return None
        uniform = {j for j in range(len(loop)) if all(o.kind == "lit" or o.strides[j] == 0 for o in (a, b))}
        return self.low.const_like(vals, uniform)

    def reciprocal(self, a: Opd, loop):
        """``1 / a`` of a stage-time divisor over ``loop`` where every
        element of it is finite and normal, else None."""
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            vals = np.float32(1.0) / self.low.const_values(a, loop)
        if not (np.isfinite(vals).all() and (np.abs(vals) >= _FLT_MIN).all()):
            return None
        if a.kind == "lit":
            return Opd("lit", value=float(vals.reshape(-1)[0]))
        return self.low.const_like(vals, {j for j in range(len(loop)) if a.strides[j] == 0})

    # ---- the rewrites
    def rewrite(self, ins: Ins):
        if ins.kind == "map":
            return self.rewrite_map(ins)
        if ins.kind == "reduce":
            return self.rewrite_reduce(ins)
        return self.rewrite_contract(ins)

    def rewrite_map(self, ins: Ins):
        op, s, loop = ins.op, ins.srcs, ins.sizes
        if ins.out.dtype != "f":
            return None

        def becomes(new_op, *srcs):
            return [dataclasses.replace(ins, op=new_op, srcs=tuple(srcs))]

        def copy_of(x):
            return becomes("copy", x) if x.dtype == "f" else None

        pairs = [(s[0], s[1]), (s[1], s[0])] if len(s) == 2 else []
        # identities on the graph's own literals
        if op == "mul":
            for a, b in pairs:
                if _lit(a, 1.0):
                    return copy_of(b)
                if _lit(a, -1.0):
                    return becomes("neg", b)
        if op == "add":
            for a, b in pairs:
                if _lit(a, 0.0):
                    return copy_of(b)
        if op == "sub" and _lit(s[1], 0.0):
            return copy_of(s[0])
        # a division by a stage-time divisor: a multiply by its reciprocal
        if op == "div" and (s[1].kind in ("lit", "c")) and s[1].dtype == "f":
            r = self.reciprocal(s[1], loop)
            if r is not None:
                return becomes("mul", s[0], r)
        if op == "neg":
            t = self.through(s[0], loop)
            if t and t[0] == "neg":
                return copy_of(t[1][0])
            if t and t[0] == "mul":
                for x, y in itertools.permutations(t[1]):
                    if _multiplier(y) and (p := self.product(y, Opd("lit", value=-1.0), loop)):
                        return becomes("mul", x, p)
        if op == "mul":
            for a, b in pairs:
                if not _multiplier(a):
                    continue
                t = self.through(b, loop)
                if t and t[0] == "neg" and (p := self.product(a, Opd("lit", value=-1.0), loop)):
                    return becomes("mul", t[1][0], p)
                if t and t[0] == "mul":
                    for x, y in itertools.permutations(t[1]):
                        if _multiplier(y) and (p := self.product(a, y, loop)):
                            return becomes("mul", x, p)
            # a literal scaling of an operand moved out of the product
            for a, b in pairs:
                if _multiplier(b):
                    continue
                t = self.through(a, loop)
                if t and t[0] == "mul" and t[2]:
                    for x, y in itertools.permutations(t[1]):
                        if _lit(y) and not _multiplier(x):
                            inner = self.tmp(loop)
                            return [Ins("map", "mul", inner, (x, b), loop),
                                    dataclasses.replace(ins, srcs=(inner, y))]
        if op in ("add", "sub"):
            t = self.through(s[1], loop)
            if t and t[0] == "neg":
                return becomes("sub" if op == "add" else "add", s[0], t[1][0])
            t = self.through(s[0], loop)
            if op == "add" and t and t[0] == "neg":
                return becomes("sub", s[1], t[1][0])
            if op == "add" and s[0] == s[1] and s[0].kind != "lit":
                return becomes("mul", s[0], Opd("lit", value=2.0))
        return None

    def rewrite_reduce(self, ins: Ins):
        (src,), n, rsizes = ins.srcs, len(ins.sizes), ins.rsizes
        # reduced axes along which the source does not vary
        still = [j for j in range(len(rsizes)) if rsizes[j] > 1 and (src.kind == "lit" or src.strides[n + j] == 0)]
        if still:
            rest = [j for j in range(len(rsizes)) if j not in still]
            repeats = math.prod(rsizes[j] for j in still)
            keep = src if src.kind == "lit" else dataclasses.replace(
                src, strides=src.strides[:n] + tuple(src.strides[n + j] for j in rest))
            steps = []
            if rest:
                core = ins.out if ins.op in ("max", "min", "any", "all") else self.tmp(ins.sizes, ins.out.dtype)
                steps.append(Ins("reduce", ins.op, core, (keep,), ins.sizes, tuple(rsizes[j] for j in rest)))
            else:
                core = keep if src.kind == "lit" else dataclasses.replace(keep, strides=keep.strides[:n])
                if ins.op in ("max", "min", "any", "all"):
                    return [Ins("map", "copy", ins.out, (core,), ins.sizes)]
            if ins.op == "sum":
                steps.append(Ins("map", "mul", ins.out, (core, Opd("lit", value=float(repeats))), ins.sizes))
            elif ins.op == "lse":
                steps.append(Ins("map", "add", ins.out, (core, Opd("lit", value=float(np.log(np.float32(repeats))))),
                                 ins.sizes))
            return steps
        if ins.op != "sum":
            return None
        t = self.through(src, ins.loop)
        if not (t and t[2]):
            return None
        op, (x, *more) = t[0], t[1]

        def over_kept(o):  # an operand uniform over the reduced axes, read over the kept ones
            return o if o.kind == "lit" else dataclasses.replace(o, strides=o.strides[:n])

        def uniform(o):
            return o.kind == "lit" or all(st == 0 for st in o.strides[n:])

        def scalar(o):  # one chain value
            return o.kind in ("v", *_INPUTS) and all(st == 0 for st in o.strides)

        def summed(o):
            out = self.tmp(ins.sizes)
            return out, Ins("reduce", "sum", out, (o,), ins.sizes, rsizes)

        if op == "neg":
            total, step = summed(x)
            return [step, Ins("map", "neg", ins.out, (total,), ins.sizes)]
        if op == "mul":
            for a, b in itertools.permutations((x, more[0])):
                if _multiplier(b) and uniform(b) and (b.kind == "lit" or np.isfinite(
                        self.low.const_values(b, ins.loop)).all()):
                    total, step = summed(a)
                    return [step, Ins("map", "mul", ins.out, (total, over_kept(b)), ins.sizes)]
                if self.guarded and scalar(b):
                    total, step = summed(a)
                    return [step, self.guard("finite", b), Ins("map", "mul", ins.out, (total, over_kept(b)), ins.sizes)]
        if op == "divr" and self.guarded and scalar(more[0]) and scalar(more[1]):
            total, step = summed(x)
            return [step, self.guard("normal", more[1]),
                    Ins("map", "divr", ins.out, (total, over_kept(more[0]), over_kept(more[1])), ins.sizes)]
        if op in ("add", "sub"):
            y = more[0]
            for a, b, first in ((x, y, True), (y, x, False)):
                if not uniform(b):
                    continue
                total, step = summed(a)
                steps = [step]
                repeats = float(math.prod(rsizes))
                if b.kind == "lit":
                    kb = Opd("lit", value=_f32(np.float32(repeats) * np.float32(b.value)))
                else:
                    kb = self.tmp(ins.sizes)
                    steps.append(Ins("map", "mul", kb, (over_kept(b), Opd("lit", value=repeats)), ins.sizes))
                pair = (total, kb) if first else (kb, total)
                return steps + [Ins("map", op, ins.out, pair, ins.sizes)]
        return None

    def rewrite_contract(self, ins: Ins):
        for k, o in enumerate(ins.srcs):
            t = self.through(o, ins.loop)
            if not (t and t[2]):
                continue
            other = ins.srcs[1 - k]
            if t[0] == "neg":
                inner = self.tmp(ins.sizes)
                srcs = (t[1][0], other) if k == 0 else (other, t[1][0])
                return [dataclasses.replace(ins, out=inner, srcs=srcs), Ins("map", "neg", ins.out, (inner,), ins.sizes)]
            if t[0] == "mul":
                for x, y in itertools.permutations(t[1]):
                    # a small product's constants scaled at stage time (a
                    # large one keeps one copy of its data)
                    if _lit(y) and other.kind == "c" and ins.iterations <= UNROLL_LIMIT and (
                            c := self.product(other, y, ins.loop)):
                        return [dataclasses.replace(ins, srcs=(x, c) if k == 0 else (c, x))]
                    if _lit(y) and math.isfinite(y.value):
                        inner = self.tmp(ins.sizes)
                        srcs = (x, other) if k == 0 else (other, x)
                        return [dataclasses.replace(ins, out=inner, srcs=srcs),
                                Ins("map", "mul", ins.out, (inner, y), ins.sizes)]
        return None

    # ---- divisions by one chain value: one reciprocal, then multiplies
    def reciprocals(self, instrs: list) -> list:
        """Each chain divisor that two or more elements of divisions read
        gets one ``recip`` (before its first division) and the divisions
        become ``divr``: a multiply by the reciprocal where it is normal,
        the division where it is not."""
        def divisor(ins: Ins):
            y = ins.srcs[1]
            if y.kind not in ("v", *_INPUTS):
                return None
            if all(st == 0 for st in y.strides):  # one value: any loop
                return (y.kind, y.idx, y.offset)
            return (y.kind, y.idx, y.offset, y.strides, ins.sizes)

        counts = collections.Counter()
        for ins in instrs:
            if ins.kind == "map" and ins.op == "div" and (key := divisor(ins)):
                counts[key] += ins.iterations
        made: dict = {}
        out = []
        for ins in instrs:
            key = divisor(ins) if ins.kind == "map" and ins.op == "div" else None
            if key is None or counts[key] < 2:
                out.append(ins)
                continue
            y = ins.srcs[1]
            if key not in made:
                if len(key) == 3:
                    r = self.tmp(())
                    out.append(Ins("map", "recip", r, (dataclasses.replace(y, strides=()),), ()))
                else:
                    r = self.tmp(ins.sizes)
                    out.append(Ins("map", "recip", r, (y,), ins.sizes))
                made[key] = r
            r = made[key]
            r_view = _canon(dataclasses.replace(r, strides=(0,) * len(ins.sizes)) if len(key) == 3 else r, ins.sizes)
            x = ins.srcs[0]
            if _lit(x) and x.value != 0.0 and math.isfinite(x.value):
                # a / y differs from a * (1 / y) only where one of them overflows
                out.append(dataclasses.replace(ins, op="mul", srcs=(r_view, x)))
            else:
                out.append(dataclasses.replace(ins, op="divr", srcs=(x, y, r_view)))
        return out


def _cse_key(ins: Ins):
    srcs = ins.srcs
    if ins.kind == "map" and ins.op in _COMMUTATIVE:
        srcs = tuple(sorted(srcs, key=repr))
    return (ins.kind, ins.op, srcs, ins.sizes, ins.rsizes, ins.out.dtype)


def _dead_code(instrs: list) -> list:
    """The instructions whose results reach ``lp``, ``g`` or a guard."""
    live = set()
    kept = []
    for ins in reversed(instrs):
        if ins.out.kind == "v" and ins.out.idx not in live:
            continue
        kept.append(ins)
        live.update(s.idx for s in ins.srcs if s.kind == "v")
    return list(reversed(kept))


def _compact_consts(low: _Lowering, programs: list):
    """The constants buffer of the chunks the programs (instruction lists)
    read, and the programs reading it."""
    starts = np.cumsum([0] + [c.size for c in low.consts])
    used = np.zeros(len(low.consts), bool)
    for ins in itertools.chain(*programs):
        for o in ins.srcs:
            if o.kind == "c":
                addr = _addr(o, ins.loop).reshape(-1)
                used[np.searchsorted(starts, addr, side="right") - 1] = True
    shift = np.cumsum([0] + [0 if u else c.size for u, c in zip(used, low.consts)])

    def moved(o: Opd) -> Opd:
        if o.kind != "c":
            return o
        chunk = int(np.searchsorted(starts, o.offset, side="right") - 1)
        return dataclasses.replace(o, offset=o.offset - int(shift[chunk]))

    programs = [[dataclasses.replace(i, srcs=tuple(map(moved, i.srcs))) for i in instrs] for instrs in programs]
    kept = [c for u, c in zip(used, low.consts) if u]
    return (torch.from_numpy(np.concatenate(kept)) if kept else torch.zeros(0)), programs


def _compact(arrays: list, instrs: list):
    """The arrays the instructions use, numbered in order of first write."""
    order: dict = {}
    for ins in instrs:
        for o in (ins.out, *ins.srcs):
            if o.kind == "v" and o.idx not in order:
                order[o.idx] = len(order)

    def renamed(o: Opd) -> Opd:
        return dataclasses.replace(o, idx=order[o.idx]) if o.kind == "v" else o

    instrs = [dataclasses.replace(i, out=renamed(i.out), srcs=tuple(map(renamed, i.srcs))) for i in instrs]
    return [arrays[k] for k in order], instrs


_scope: contextvars.ContextVar = contextvars.ContextVar("gjt_staging_scope", default=None)


@contextlib.contextmanager
def staging_scope():
    """Within it, ``staged_body_for`` stages a density once per ``(d,
    device)`` and reuses the body, so that a warmup's phases and the sweep
    after them stage once, and the trace path keeps its bodies in the
    scope's store (``scope_store``). A scope
    opened inside another is the outer one. Used as a decorator by
    ``column_hmc``, ``column_nuts``, ``warmup_column``,
    ``warmup_column_nuts`` and ``sample_posterior``: the body lives as long
    as one call of theirs, so a later call stages the density again and
    reads what its captured tensors hold then."""
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


def scope_store() -> dict | None:
    """The open ``staging_scope``'s store, or None outside one: a caller
    that keeps its own staged bodies there (the trace path,
    ``inference/mcmc.py``) keys them, and checks a hit, itself."""
    return _scope.get()
