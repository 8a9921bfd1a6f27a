"""Time-travel debugger: step through, rewind and re-mix a computation at
tagged record points.

Counterpart of ``genjax_tpu/debug/time_travel.py``: ``record_p``, ``rec``,
``tag``, ``FrameRecording``, ``TimeTravelingDebugger`` (``fwd``, ``bwd``,
``jump``, ``remix``, ``frame``, ``summary``) and ``time_machine``.

The reference snapshots a staged jaxpr at each record point and resumes from
it. The port has no jaxpr to snapshot: a record point is a call bound to the
named effect ``record_p`` (``core/primitive.py``), and frame ``k``'s
continuation runs the instrumented program again under a handler of
``record_p`` that numbers the record points as they fire and, at point
``k``, calls ``f(*new_args)`` in place of the recorded call. Points fire in
the reference's order: pre-order, a point before those nested in its call.

A program run again must draw what it drew. The reference's prefix is
deterministic by its key; here each run of the program starts from the
random state of the first: the default generators of the CPU and of the
program's CUDA devices are rewound under ``torch.random.fork_rng`` (and so
left as they were found), and so is each generator named in
``time_machine(source, streams=(...))``, which a run leaves where it ends.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core.environment import Environment
from ..core.handlers import EffectHandler, handle
from ..core.primitive import initial_style_bind, initial_style_primitive
from ..core.pytree import Pytree

record_p = initial_style_primitive("record")


@Pytree.dataclass
class FrameRecording(Pytree):
    """One captured moment: the recorded callable, its arguments, its local
    return value, and the continuation that runs the rest of the program
    from this point with new arguments."""

    f: Callable = Pytree.static()
    args: tuple = ()
    local_retval: Any = None
    cont: Callable = Pytree.static(default=None)
    debug_tag: str | None = Pytree.static(default=None)


def rec(fn: Callable, debug_tag: str | None = None) -> Callable:
    """Mark ``fn`` as a record point: under ``time_machine`` each call is a
    frame; elsewhere it is the plain call."""
    return initial_style_bind(record_p, debug_tag=debug_tag)(fn)


def _identity(x):
    return x


def tag(v: Any, name: str | None = None) -> Any:
    """Record the identity on ``v``: a pure breakpoint."""
    return rec(_identity, name)(v)


class _Recorder(EffectHandler):
    """Serves ``record_p`` during one run: numbers the points as they fire,
    calls the replacement arguments where a replacement is due, and keeps
    each point's frame in an ``Environment`` by its position."""

    def __init__(self, rerun: "_Rerun", replacements: dict):
        self.rerun = rerun
        self.replacements = replacements
        self.count = 0
        self.frames = Environment()

    def serves(self, prim) -> bool:
        return prim is record_p

    def handle_primitive(self, prim, fn, args, params):
        k = self.count
        self.count += 1
        args = self.replacements.get(k, args)
        ret = fn(*args)
        cont = _Continuation(self.rerun, self.replacements, k)
        self.frames[k] = FrameRecording(fn, tuple(args), ret, cont, params["debug_tag"])
        return ret


class _Rerun:
    """The instrumented program and the random state it starts from."""

    def __init__(self, program: Callable, args: tuple, streams: tuple):
        self.program = program
        self.args = args
        self.streams = tuple(streams)
        leaves = [x for x in pytree.tree_leaves(args) if isinstance(x, torch.Tensor)]
        self.devices = sorted(
            {t.device.index or 0 for t in leaves if t.is_cuda}
            | {s.device.index or 0 for s in self.streams if s.device.type == "cuda"}
        )
        self.cpu_state = torch.random.get_rng_state()
        self.cuda_states = [torch.cuda.get_rng_state(d) for d in self.devices]
        self.stream_states = [s.get_state() for s in self.streams]

    def __call__(self, replacements: dict) -> tuple[Any, list]:
        recorder = _Recorder(self, replacements)
        with torch.random.fork_rng(devices=self.devices):
            torch.random.set_rng_state(self.cpu_state)
            for d, state in zip(self.devices, self.cuda_states):
                torch.cuda.set_rng_state(state, d)
            for s, state in zip(self.streams, self.stream_states):
                s.set_state(state)
            with handle(recorder):
                final = self.program(*self.args)
        return final, [recorder.frames[k] for k in range(recorder.count)]


class _Continuation:
    """Frame ``k``'s continuation: ``cont(*new_args)`` runs the program
    again with ``new_args`` at point ``k`` and returns the final value."""

    def __init__(self, rerun: _Rerun, replacements: dict, k: int):
        self.rerun = rerun
        self.replacements = replacements
        self.k = k

    def frames(self, *new_args) -> tuple[Any, list]:
        return self.rerun({**self.replacements, self.k: tuple(new_args)})

    def __call__(self, *new_args) -> Any:
        return self.frames(*new_args)[0]


def _jump_points(sequence) -> dict:
    return {f.debug_tag: i for i, f in enumerate(sequence) if f.debug_tag is not None}


class TimeTravelingDebugger:
    """A navigable recording: ``fwd``/``bwd`` step between frames, ``jump``
    goes to a tag, ``remix`` runs the program again from the current frame
    with new arguments. A host-side object, not a pytree: its frames hold
    continuations."""

    def __init__(self, final_retval, sequence, jump_points, ptr: int = 0):
        self.final_retval = final_retval
        self.sequence = list(sequence)
        self.jump_points = dict(jump_points)
        self.ptr = ptr

    def frame(self) -> tuple[str | None, FrameRecording]:
        frame = self.sequence[self.ptr]
        return frame.debug_tag, frame

    def summary(self):
        return self.final_retval, self.frame()

    def _at(self, ptr: int) -> "TimeTravelingDebugger":
        return TimeTravelingDebugger(self.final_retval, self.sequence, self.jump_points, ptr)

    def fwd(self) -> "TimeTravelingDebugger":
        return self if self.ptr + 1 >= len(self.sequence) else self._at(self.ptr + 1)

    def bwd(self) -> "TimeTravelingDebugger":
        return self if self.ptr == 0 else self._at(self.ptr - 1)

    def jump(self, debug_tag: str) -> "TimeTravelingDebugger":
        return self._at(self.jump_points[debug_tag])

    def remix(self, *args) -> "TimeTravelingDebugger":
        """Run the program again with ``args`` at the current frame: the
        frames before it are kept, this one and those after it are
        recorded anew."""
        final, frames = self.sequence[self.ptr].cont.frames(*args)
        sequence = [*self.sequence[: self.ptr], *frames[self.ptr :]]
        return TimeTravelingDebugger(final, sequence, _jump_points(sequence), self.ptr)

    def __call__(self, *args) -> "TimeTravelingDebugger":
        return self.remix(*args)


def time_machine(source: Callable, streams: tuple = ()) -> Callable:
    """Instrument ``source`` and return ``f(*args) -> TimeTravelingDebugger``,
    with record points ``"_enter"`` around the call and ``"_exit"`` on its
    value. ``streams`` names the ``torch.Generator``s the program draws from
    besides the default ones, so that every run starts them where the
    first did.

    >>> def program(x):
    ...     y = rec(lambda a: a * 2.0, "double")(x)
    ...     return tag(y + 10.0, "add10")
    >>> dbg = time_machine(program)(3.0)
    >>> dbg.final_retval, [f.debug_tag for f in dbg.sequence]
    (16.0, ['_enter', 'double', 'add10', '_exit'])
    >>> dbg.jump("double").remix(5.0).final_retval
    20.0
    """

    def instrumented(*args):
        return tag(rec(source, "_enter")(*args), "_exit")

    def build(*args) -> TimeTravelingDebugger:
        final, frames = _Rerun(instrumented, args, streams)({})
        return TimeTravelingDebugger(final, frames, _jump_points(frames), 0)

    return build
