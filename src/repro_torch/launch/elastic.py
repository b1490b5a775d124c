"""Elastic restart: resume training on another device count, the
counterpart of the JAX package's ``launch/elastic.py``.

``elastic_resume`` restores the latest checkpoint (full logical arrays in
an npz, so a restore never depends on the layout it was saved under),
builds the (data, model) layout of the live devices (the model-parallel
degree kept where the device count allows, else halved) and places the
state on the live device. The port has no sharding rules for training
state, and the JAX package's train loop uses none either, so the state is
placed whole on one device. ``rebalance_batch`` re-splits a fixed global
batch over the new data axis, so the optimizer's hyperparameters stay
valid across a re-scale.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
on a host without CUDA; pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import torch

from ..core.tree import tree_map
from ..device import resolve_device
from .mesh import MeshLayout, make_mesh_for_devices

__all__ = ["elastic_resume", "rebalance_batch"]


def elastic_resume(state_like, ckpt_manager, model_parallel: int = 0,
                   device=None):
    """``(state, step, layout)`` from ``ckpt_manager``'s latest checkpoint
    on the live devices: the state in ``state_like``'s structure and
    dtypes, on ``device``; ``(None, None, layout)`` when there is none."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    # the restart contract: the model-parallel degree preserved when the
    # survivors allow it, else halved, so degrading is opted into here
    layout = make_mesh_for_devices(n, model_parallel, allow_degrade=True)
    state, step = ckpt_manager.restore(state_like)
    if state is None:
        return None, None, layout
    state = tree_map(lambda a: a.to(dev) if torch.is_tensor(a) else a, state)
    return state, step, layout


def rebalance_batch(global_batch: int, layout: MeshLayout) -> int:
    """Each data-parallel rank's batch after a re-scale; raises if the
    global batch does not split over the data axis."""
    dp = layout.data
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data parallelism {dp} after re-scale")
    return global_batch // dp
