"""Checkpointing: the JAX package's flat-key .npz format + reference ``.pth``.

A checkpoint written by the JAX package's ``save_params`` loads here
unchanged (same keys, same ``__meta__/`` stamp, same None sentinel), and one
written here serves on the JAX package.  Parameter trees are nested
dicts/lists of numpy arrays (``KernelNN.to_jax_params``/``from_jax_params``
convert to and from a module).

The reference persists per-partition ``state_dict``s at
``logs/models/collection_{exp}/partition_{i}.pth`` (scheduler_gnn.py:181-185,
444-451) and loads them CPU-mapped (scheduler_gnn.py:45-51).  The framework
keeps that directory layout for drop-in compatibility, storing params natively
as flat-key ``.npz`` (atomic rename on save — the reference has no atomic
writes, SURVEY §5) and importing/exporting ``.pth`` via torch-CPU when asked.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

SEP = "/"
_NONE_SENTINEL = "__none__"
_META_PREFIX = "__meta__" + SEP


def flatten_params(params: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}{SEP}"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(flatten_params(v, f"{prefix}{i}{SEP}"))
    elif params is None:
        # None leaves (optional components, e.g. bias=None) round-trip via a
        # pickle-free string sentinel: a pickled object array would SAVE
        # fine but make the npz unloadable (np.load defaults to
        # allow_pickle=False) — a checkpoint that only fails at serve time
        out[prefix[:-1]] = np.array(_NONE_SENTINEL)
    else:
        arr = np.asarray(params)
        if arr.dtype == object:
            raise TypeError(
                f"non-numeric leaf at {prefix[:-1]!r} "
                f"({type(params).__name__}): .npz checkpoints store numeric "
                "arrays (and None) only")
        out[prefix[:-1]] = arr
    return out


def unflatten_params(flat: dict[str, np.ndarray]) -> Any:
    """Rebuilds the nested dict/list tree from flat keys."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def normalize(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if (keys and all(k.isdigit() for k in keys)
                and sorted(int(k) for k in keys) == list(range(len(keys)))):
            # only a dense 0..n-1 digit range round-trips to a list; sparse
            # digit keys (e.g. '0','2') stay a dict
            return [normalize(node[str(i)]) for i in range(len(keys))]
        return {k: normalize(v) for k, v in node.items()}

    return normalize(root)


def save_params(path: str, params: Any, meta: dict | None = None) -> None:
    """Atomically writes a params tree as .npz.

    ``meta`` entries (task-spec stamping, round-4 VERDICT #4) are stored as
    string scalars under ``__meta__/`` keys — invisible to load_params,
    readable via load_meta.  Serving guards compare them against the
    request's task spec to refuse resolution/config mismatches (the
    measured 0.25x mismatched-coarse trap, BASELINE.md zero-shot row).
    """
    flat = flatten_params(params)
    for k, v in (meta or {}).items():
        flat[_META_PREFIX + k] = np.array(str(v))
    _save_npz(path, flat)


def load_params(path: str) -> Any:
    with np.load(path) as z:
        flat = {}
        for k in z.files:
            if k.startswith(_META_PREFIX):
                continue
            a = z[k]
            if a.dtype.kind == "U" and a.shape == () and str(a) == _NONE_SENTINEL:
                flat[k] = None
            else:
                flat[k] = a
    return unflatten_params(flat)


def load_meta(path: str) -> dict[str, str]:
    """Reads the ``__meta__/`` stamp of a checkpoint ({} for legacy files)."""
    with np.load(path) as z:
        return {k[len(_META_PREFIX):]: str(z[k]) for k in z.files
                if k.startswith(_META_PREFIX)}


def _save_npz(path: str, payload: dict) -> None:
    """Writes ``payload`` as .npz through a temporary file renamed into
    place, so a crash never leaves a half-written file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_tree(path: str, tree: Any, extra: dict | None = None) -> None:
    """Saves a tree of arrays (the trainer's optimizer state) flat-keyed like
    ``save_params``, plus ``extra`` scalars (epoch, best_loss) under
    ``extra_`` keys, atomically.  The reference has no optimizer-state
    checkpointing or step-resume; this plus ``load_tree_like`` provides it.
    The file is the port's own: the JAX package stores optax's state."""
    payload = flatten_params(tree)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    _save_npz(path, payload)


def load_tree_like(path: str, template: Any) -> tuple[Any, dict]:
    """Restores a tree saved by ``save_tree`` with ``template``'s keys;
    returns (tree, extra)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in flatten_params(template)}
        extra = {k[len("extra_"):]: z[k] for k in z.files
                 if k.startswith("extra_")}
    return unflatten_params(flat), extra


def load_pth_state_dict(path: str) -> dict[str, np.ndarray]:
    """Loads a torch ``.pth`` state_dict into numpy arrays (CPU, no grad)."""

    sd = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def save_pth_state_dict(path: str, state_dict: dict[str, np.ndarray]) -> None:
    """Writes a numpy state_dict as a torch ``.pth`` (for reference interop)."""

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: torch.from_numpy(np.asarray(v).copy()) for k, v in state_dict.items()}, path)
