"""Artifact reader/writer: the format shared with the JAX package.

Layout:  <dir>/ARTIFACT.json   (meta)
         <dir>/arrays.npz      (flattened leaves; '/'-joined tree paths as
                                keys, list indices numeric)

Writes go to a temp dir + os.rename (atomic on POSIX), so a crash mid-save
never publishes a partial artifact. The training checkpoint manager arrives
with a later slice.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict/list of tensors or arrays -> {'a/0/b': ndarray}."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        leaf = tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)
        return {prefix: leaf}
    out: dict[str, np.ndarray] = {}
    for key, val in items:
        out.update(_flatten(val, f"{prefix}/{key}" if prefix else key))
    return out


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
