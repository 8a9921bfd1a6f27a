"""Checkpointing of framework pytrees (traces, particle collections, chain
states, adaptation state).

Counterpart of ``genjax_tpu/io/checkpoint.py``: ``save_pytree``,
``save_segment_state``, ``load_segment_state``, ``check_meta_matches`` and
``restore_pytree``. Where the reference uses orbax, a state here is one
``torch.save`` of its flattened leaves (``torch.utils._pytree``), moved to
the CPU; the static structure (addresses, generative functions, static
fields) is not saved: a restore takes a template of the same structure and
fills its tensor leaves, loading with ``weights_only=True`` onto the
template's device.

A segmented run saves each segment's new rows (draws, accept flags) once, as
an increment beside the state (``save_segment_state(..., increment=)``),
where the reference rewrites every row so far at each save; the state holds
only what the next segment starts from. Ranks that save together (a
``group``: a ``parallel.Mesh``) each write under ``rank_<r>/``, and rank 0
flips the pointer once every rank has written (the reference's process-0
flip after ``sync_global_devices``); a world of one keeps the one-process
layout.

>>> import os, tempfile, torch
>>> from genjax_tpu_torch.io import restore_pytree, save_pytree
>>> state = {"w": torch.arange(3.0), "step": torch.tensor(7)}
>>> path = os.path.join(tempfile.mkdtemp(), "ckpt")
>>> save_pytree(path, state)
>>> back = restore_pytree(path, state)
>>> int(back["step"]), tuple(back["w"].shape)
(7, (3,))
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch
import torch.utils._pytree as pytree

_LEAVES = "leaves.pt"


def save_pytree(path: str, tree: Any) -> None:
    """Save ``tree``'s tensor leaves to the directory ``path``, each moved to
    the CPU (a leaf that is no tensor is saved as None: the template
    supplies it on restore)."""
    leaves = [v.detach().cpu() if isinstance(v, torch.Tensor) else None for v in pytree.tree_leaves(tree)]
    os.makedirs(path, exist_ok=True)
    torch.save(leaves, os.path.join(path, _LEAVES))


def _root(checkpoint_dir: str, group) -> str:
    """Where this rank's files go: ``rank_<r>/`` under the checkpoint in a
    world of more than one rank, the checkpoint itself otherwise."""
    if group is None or group.world_size == 1:
        return checkpoint_dir
    return os.path.join(checkpoint_dir, f"rank_{group.rank}")


def save_segment_state(checkpoint_dir: str, state: Any, meta: dict, *, increment: Any = None,
                       group=None) -> None:
    """The crash-safe save of a segmented run, shared by the resumable
    drivers (``sample_posterior``, ``run_chains_sharded``).

    ``increment``, where given, is the segment's new rows: it goes to
    ``increment_<next_segment - 1>`` and stays there (the run's rows are the
    increments of its segments, which ``load_increments`` concatenates).
    Then the state, what the next segment starts from, goes to a versioned
    directory ``state_<next_segment>``; then the small JSON ``meta.json``
    (the segment cursor, the run identity a resume checks, and
    ``state_dir``) is written to a temporary file and flipped into place
    with ``os.replace``; then older state directories are removed. A crash
    at any point leaves ``meta.json`` pointing at a whole state and whole
    increments: the previous ones before the flip, the new ones after it.

    ``group`` (a ``parallel.Mesh``: ``rank``, ``world_size``, ``barrier()``)
    makes the ranks save together: each writes its own files under
    ``rank_<r>/``, and rank 0 flips ``meta.json`` once every rank has
    written. ``meta`` must hold ``next_segment``; the rest is the caller's
    and comes back as it was."""
    seg = int(meta["next_segment"])
    root = _root(checkpoint_dir, group)
    state_name = f"state_{seg}"
    os.makedirs(root, exist_ok=True)
    if increment is not None:
        save_pytree(os.path.join(root, f"increment_{seg - 1}"), increment)
    save_pytree(os.path.join(root, state_name), state)
    if group is not None:
        group.barrier()
    if group is None or group.rank == 0:
        meta = {**meta, "state_dir": state_name}
        meta_path = os.path.join(checkpoint_dir, "meta.json")
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, meta_path)
    if group is not None:
        group.barrier()
    for name in os.listdir(root):
        if name.startswith("state_") and name != state_name:
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def load_segment_state(checkpoint_dir: str, make_template, *, group=None) -> Any:
    """The resume point of :func:`save_segment_state`: None where there is
    no checkpoint, else ``(state, meta)``. ``make_template(meta)`` builds
    the restore template, and runs first: it checks the run identity, so a
    foreign meta is refused before any of its fields is trusted. ``group``
    is the one the run saved with."""
    meta_path = os.path.join(checkpoint_dir, "meta.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    template = make_template(meta)
    state = restore_pytree(os.path.join(_root(checkpoint_dir, group), meta["state_dir"]), template)
    return state, meta


def load_increments(checkpoint_dir: str, n_segments: int, template_of, *, group=None) -> list:
    """The increments of segments ``0 .. n_segments - 1``, each restored
    into ``template_of(segment)``, in order."""
    root = _root(checkpoint_dir, group)
    return [restore_pytree(os.path.join(root, f"increment_{i}"), template_of(i)) for i in range(n_segments)]


def check_meta_matches(checkpoint_dir: str, meta: dict, expect: dict):
    """Refuse to resume a checkpoint whose recorded run identity differs
    from this call's: every key of ``expect`` must match the meta (a missing
    key counts as a mismatch)."""
    mismatched = {k: (meta.get(k), v) for k, v in expect.items() if meta.get(k) != v}
    if mismatched:
        raise ValueError(
            f"checkpoint at {checkpoint_dir!r} records a different run ({mismatched}: recorded vs "
            "requested) — refusing to resume (the same arguments and seed are required for bitwise "
            "resumption)"
        )


def restore_pytree(path: str, template: Any) -> Any:
    """A pytree saved by :func:`save_pytree`, in the structure of
    ``template``: its tensor leaves replaced by the stored ones, on the
    template's device, every one checked against the template's shape and
    dtype (a wrong template of the same arity fails here)."""
    leaves, spec = pytree.tree_flatten(template)
    tensors = [v for v in leaves if isinstance(v, torch.Tensor)]
    device = tensors[0].device if tensors else torch.device("cpu")
    stored = torch.load(os.path.join(path, _LEAVES), map_location=device, weights_only=True)
    if len(stored) != len(leaves):
        raise ValueError(f"checkpoint has {len(stored)} leaves, template has {len(leaves)}")
    out = []
    for i, (r, t) in enumerate(zip(stored, leaves)):
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        if r is None or r.shape != t.shape or r.dtype != t.dtype:
            got = None if r is None else (tuple(r.shape), r.dtype)
            raise ValueError(
                f"checkpoint leaf {i}: stored {got} does not match the template's "
                f"{(tuple(t.shape), t.dtype)} — wrong template?"
            )
        out.append(r.to(t.device))
    return pytree.tree_unflatten(out, spec)
