"""Checkpointing of framework pytrees (traces, particle collections, chain
states, adaptation state).

Counterpart of ``genjax_tpu/io/checkpoint.py``: ``save_pytree``,
``save_segment_state``, ``load_segment_state``, ``check_meta_matches`` and
``restore_pytree``. Where the reference uses orbax, a state here is one
``torch.save`` of its flattened leaves (``torch.utils._pytree``), moved to
the CPU; the static structure (addresses, generative functions, static
fields) is not saved: a restore takes a template of the same structure and
fills its tensor leaves, loading with ``weights_only=True`` onto the
template's device. The port runs in one process; the reference's
multi-host branches wait for the scale-out port (``ROADMAP.md`` item 15).

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


def save_segment_state(checkpoint_dir: str, state: Any, meta: dict) -> None:
    """The crash-safe save of a segmented run's state, shared by the
    resumable drivers (``sample_posterior``).

    The state goes to a versioned directory ``state_<segment>``; then the
    small JSON ``meta.json`` (the segment cursor, the run identity a resume
    checks, and ``state_dir``) is written to a temporary file and flipped
    into place with ``os.replace``; then older state directories are
    removed. A crash at any point leaves ``meta.json`` pointing at a whole
    state: the previous pair before the flip, the new one after it.

    ``meta`` must hold ``next_segment``; the rest is the caller's and comes
    back as it was."""
    seg = int(meta["next_segment"])
    state_name = f"state_{seg}"
    os.makedirs(checkpoint_dir, exist_ok=True)
    save_pytree(os.path.join(checkpoint_dir, state_name), state)
    meta = {**meta, "state_dir": state_name}
    meta_path = os.path.join(checkpoint_dir, "meta.json")
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)
    for name in os.listdir(checkpoint_dir):
        if name.startswith("state_") and name != state_name:
            shutil.rmtree(os.path.join(checkpoint_dir, name), ignore_errors=True)


def load_segment_state(checkpoint_dir: str, make_template) -> Any:
    """The resume point of :func:`save_segment_state`: None where there is
    no checkpoint, else ``(state, meta)``. ``make_template(meta)`` builds
    the restore template, and runs first: it checks the run identity, so a
    foreign meta is refused before any of its fields is trusted."""
    meta_path = os.path.join(checkpoint_dir, "meta.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    template = make_template(meta)
    state = restore_pytree(os.path.join(checkpoint_dir, meta["state_dir"]), template)
    return state, meta


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
