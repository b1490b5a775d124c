"""Checkpoints and artifacts in the format the JAX package writes.

Artifact layout:   <dir>/ARTIFACT.json   (meta)
                   <dir>/arrays.npz      (flattened leaves; '/'-joined tree
                                          paths as keys, list indices numeric)
Checkpoint layout: <dir>/step_000000042/
                     shard_00000.npz     (flattened leaf arrays, this host's)
                     META.json           (step, time, metrics, keys)
                   <dir>/LATEST          (atomic pointer file)

Keys are the JAX package's: dict keys and list indices joined by '/', and a
named tuple's fields (the Adam state) as ``.name``, so a checkpoint of
either package restores in the other. Writes go to a temp dir + os.rename
(atomic on POSIX), so a crash mid-save never publishes a partial artifact
or corrupts the latest checkpoint: the restart path (``launch/train.py``)
always resumes from a complete step.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from ..core.tree import is_namedtuple


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict/list/named tuple of tensors or arrays -> {'a/0/b': ndarray}."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif is_namedtuple(tree):
        items = ((f".{name}", v) for name, v in zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        leaf = tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)
        return {prefix: leaf}
    out: dict[str, np.ndarray] = {}
    for key, val in items:
        out.update(_flatten(val, f"{prefix}/{key}" if prefix else key))
    return out


def _unflatten(tree_like, arrays: dict[str, np.ndarray], prefix: str = ""):
    """The leaves of ``arrays`` in the structure of ``tree_like``, each cast
    to its template leaf's dtype and placed on its device."""
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, arrays, join(k)) for k, v in tree_like.items()}
    if is_namedtuple(tree_like):
        return type(tree_like)(*(_unflatten(v, arrays, join(f".{name}"))
                                 for name, v in zip(tree_like._fields, tree_like)))
    if isinstance(tree_like, (list, tuple)):
        return [_unflatten(v, arrays, join(i)) for i, v in enumerate(tree_like)]
    if prefix not in arrays:
        raise KeyError(f"checkpoint missing leaf {prefix}")
    arr = torch.from_numpy(np.array(arrays[prefix], copy=True))
    if torch.is_tensor(tree_like):
        return arr.to(dtype=tree_like.dtype, device=tree_like.device)
    return arr


def _nest(arrays: dict[str, np.ndarray]):
    """'/'-joined flat keys -> nested tree; integer-keyed levels (list
    indices) become lists. Needs no template tree: the deployed parameter
    structure is rebuilt from the keys alone."""
    root: dict = {}
    for key, arr in arrays.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            idx = sorted(int(k) for k in node)
            if idx == list(range(len(node))):
                return [listify(node[str(i)]) for i in idx]
        return {k: listify(v) for k, v in node.items()}
    return listify(root)


def save_artifact(path: str, tree: Any, meta: dict) -> str:
    """Write ``arrays.npz`` (flattened leaves) + ``ARTIFACT.json`` (meta)
    through a temp dir and an atomic rename. An existing artifact is moved
    aside before the new one is published, and restored if the publish
    rename fails."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    if os.path.exists(path) and not os.path.isdir(path):
        raise ValueError(f"{path} exists and is not an artifact directory")
    tmp = tempfile.mkdtemp(dir=parent, prefix=".tmp_artifact_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **_flatten(tree))
        with open(os.path.join(tmp, "ARTIFACT.json"), "w") as f:
            json.dump({**meta, "time": time.time()}, f, indent=2,
                      sort_keys=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    backup = None
    if os.path.isdir(path):
        backup = tempfile.mkdtemp(dir=parent, prefix=".old_artifact_")
        os.rename(path, os.path.join(backup, "prev"))
    try:
        os.rename(tmp, path)                            # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if backup is not None:                          # restore the old one
            os.rename(os.path.join(backup, "prev"), path)
        raise
    if backup is not None:
        shutil.rmtree(backup, ignore_errors=True)
    return path


def load_artifact(path: str) -> tuple[Any, dict]:
    """(tree, meta) from :func:`save_artifact`'s layout. Leaves come back as
    numpy arrays with their saved dtypes (packed int codes stay packed)."""
    with open(os.path.join(path, "ARTIFACT.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as z:
        arrays = dict(z)
    return _nest(arrays), meta


class CheckpointManager:
    """Atomic, keep-k, auto-resume checkpoints of a state tree."""

    def __init__(self, directory: str, keep: int = 3, host_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.host = host_index
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, metrics: Optional[dict] = None):
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            arrays = _flatten(state)
            np.savez(os.path.join(tmp, f"shard_{self.host:05d}.npz"), **arrays)
            meta = {"step": step, "time": time.time(),
                    "metrics": metrics or {}, "keys": sorted(arrays)}
            with open(os.path.join(tmp, "META.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                       # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._write_latest(step)
        self._gc()
        return final

    def _write_latest(self, step: int):
        tmp = os.path.join(self.dir, ".LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.rename(tmp, os.path.join(self.dir, "LATEST"))

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- load
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                step = int(f.read().strip())
            if os.path.exists(os.path.join(self.dir, f"step_{step:09d}")):
                return step
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None):
        """Returns (state, step) or (None, None) when no checkpoint exists.
        Leaves take ``state_like``'s dtypes and devices."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.dir, f"step_{step:09d}")
        with np.load(os.path.join(d, f"shard_{self.host:05d}.npz"),
                     allow_pickle=False) as z:
            data = dict(z)
        return _unflatten(state_like, data), step
