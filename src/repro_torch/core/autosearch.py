"""Mixed-precision policies chosen by an auto-search (DESIGN.md §13).

The port reads what a search wrote: :func:`load_search_policy` turns a
search artifact into a deployable ``QuantPolicy``, as the JAX package's
``core/autosearch.load_search_policy`` does. The search itself (probe
scoring over QAT) arrives with the QAT slice of the port.
"""
from __future__ import annotations

import json

from .policy import QuantPolicy

__all__ = ["load_search_policy"]


def load_search_policy(path: str, num_layers: int) -> QuantPolicy:
    """Reconstruct a deployable ``QuantPolicy`` from a search artifact JSON:
    a quality-bench payload whose ``"search"`` key holds
    ``chosen_int4_layers``, or a bare ``dataclasses.asdict(QuantPolicy)``
    dump. ``num_layers`` pins the policy to the model being served; a
    chosen layer outside ``[0, num_layers)`` is a config mismatch."""
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: expected a JSON object, "
                         f"got {type(payload).__name__}")
    search = payload.get("search", payload)
    if "chosen_int4_layers" in search:
        chosen = tuple(sorted(int(l) for l in search["chosen_int4_layers"]))
        bad = [l for l in chosen if not 0 <= l < num_layers]
        if bad:
            raise ValueError(
                f"{path}: chosen_int4_layers {bad} outside the served "
                f"model's [0, {num_layers}) layer range")
        return QuantPolicy(num_layers=num_layers, mode="int",
                           int4_layers=chosen)
    pol = QuantPolicy.from_dict(dict(search))
    if pol.num_layers != num_layers:
        raise ValueError(
            f"{path}: policy num_layers={pol.num_layers} does not match "
            f"the served model's {num_layers}")
    return pol
