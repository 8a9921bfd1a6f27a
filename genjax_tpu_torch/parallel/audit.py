"""The audit of the collectives a run issued.

Counterpart of ``genjax_tpu/parallel/audit.py``. The reference reads the
collectives out of a compiled program's HLO text: kind, payload bytes,
whether it runs once a loop step, and how many devices its group spans. Torch
compiles no such program, so the port records the calls as they are issued
(``parallel/_comm.py``; ``collective_log`` collects them on this rank) and
``collective_counts`` summarises a log in the reference audit's shape. The
claims it proves are the reference's: the per-step weight statistics stay
on one mesh axis, and the payloads that cross another are bounded.
"""

from __future__ import annotations

from ._comm import Collective, collective_log

_KINDS = {"all_reduce_sum": "all-reduce", "all_reduce_max": "all-reduce", "all_gather": "all-gather"}


def _bytes(c: Collective) -> int:
    """The payload of one call: the result's bytes (a gather's result is
    the operand times the ranks on its axis)."""
    n = c.dtype.itemsize
    for d in c.shape:
        n *= d
    if c.op == "all_gather":
        n *= c.span
    return n


def collective_counts(log: list) -> dict:
    """Summarise a ``collective_log``: ``ops`` holds one entry a distinct
    collective, ``{"kind", "group", "bytes", "per_step", "group_span",
    "calls"}`` (``group`` the mesh axis, ``per_step`` whether a driver's
    step issued it, ``calls`` how many times it was issued), beside the
    totals ``count``/``bytes`` over the calls, ``by_kind`` and the
    ``per_step``/``once_per_run`` roll-ups.

    >>> import torch
    >>> from genjax_tpu_torch.parallel._comm import Collective
    >>> log = [Collective("all_reduce_max", "batch", (), torch.float32, 2, 0),
    ...        Collective("all_reduce_max", "batch", (), torch.float32, 2, 1)]
    >>> counts = collective_counts(log)
    >>> counts["ops"]
    [{'kind': 'all-reduce', 'group': 'batch', 'bytes': 4, 'per_step': True, 'group_span': 2, 'calls': 2}]
    >>> counts["per_step"]
    {'count': 2, 'bytes': 8}
    """
    ops: dict = {}
    for c in log:
        key = (_KINDS[c.op], c.axis, _bytes(c), c.step is not None, c.span)
        ops[key] = ops.get(key, 0) + 1
    entries = [
        {"kind": kind, "group": group, "bytes": nbytes, "per_step": per_step, "group_span": span, "calls": n}
        for (kind, group, nbytes, per_step, span), n in ops.items()
    ]
    step_calls = [c for c in log if c.step is not None]
    by_kind: dict = {}
    for c in log:
        by_kind[_KINDS[c.op]] = by_kind.get(_KINDS[c.op], 0) + 1
    return {
        "count": len(log),
        "bytes": sum(_bytes(c) for c in log),
        "by_kind": by_kind,
        "per_step": {"count": len(step_calls), "bytes": sum(_bytes(c) for c in step_calls)},
        "once_per_run": {
            "count": len(log) - len(step_calls),
            "bytes": sum(_bytes(c) for c in log) - sum(_bytes(c) for c in step_calls),
        },
        "ops": entries,
    }


def hlo_collectives(log: list) -> dict:
    """The reference's name for ``collective_counts``: it reads a compiled
    program's HLO text, which torch has none of, so here it takes a
    ``collective_log`` of the calls issued."""
    return collective_counts(log)


__all__ = ["collective_counts", "collective_log", "hlo_collectives"]
