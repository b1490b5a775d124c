"""Sensitivity-ranked per-layer mixed-precision search.

Per-layer bit allocation recovers the last accuracy points low-bit BERT
loses: layers differ widely in quantization sensitivity, so one global knob
(all-int4 / all-int8) either overpays bits or overpays accuracy. This module
finds the CHEAPEST per-layer assignment meeting an accuracy floor:

1. probe each layer alone at int4 (rest int8) and rank layers by the
   accuracy drop they cause, the sensitivity ranking;
2. greedily move layers to int4 from least to most sensitive, keeping a
   move only while the scored accuracy stays at or above the floor.

The scorer is a callback (``score_fn(policy) -> accuracy``); the quality
bench deploys a real artifact per candidate (``benchmarks/table1_glue.py
--artifact``). With :func:`cached_probe_scorer` wrapped around the deploy
path, each score costs an eval, not a re-deploy: every candidate's packed
params are assembled bit-exactly by slicing two cached uniform-grid
deploys. :func:`load_search_policy` turns a search artifact into a
deployable ``QuantPolicy``. The same algorithm as the JAX package's
``core/autosearch``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Sequence

from .policy import QuantPolicy
from .tree import tree_map

__all__ = ["SearchResult", "cached_probe_scorer", "load_search_policy",
           "search_mixed_precision"]


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Outcome of one search run.

    policy         the cheapest policy found that meets the floor
    accuracy       its scored accuracy (the all-int8 base accuracy when no
                   int4 move survived)
    base_accuracy  the all-int8 starting accuracy
    sensitivity    ((layer, accuracy_drop), ...) ranked least-sensitive first
    trajectory     ((candidate_int4_layers, accuracy, accepted), ...), every
                   greedy step, for the bench report
    floor          the resolved accuracy floor used
    """

    policy: QuantPolicy
    accuracy: float
    base_accuracy: float
    sensitivity: tuple
    trajectory: tuple
    floor: float = float("-inf")

    def describe(self) -> str:
        i4 = sorted(self.policy.int4_layers or ())
        return (f"int4_layers={i4} acc={self.accuracy:.4f} "
                f"(base int8 {self.base_accuracy:.4f}, "
                f"floor {self.floor:.4f}, "
                f"{len(self.trajectory)} greedy steps)")


def search_mixed_precision(num_layers: int,
                           score_fn: Callable[[QuantPolicy], float], *,
                           accuracy_floor: float | None = None,
                           floor_delta: float | None = None,
                           fp_score: float | None = None,
                           mode: str = "int",
                           default_bits: int = 8,
                           grad_mode: str = "mse",
                           layers: Sequence[int] | None = None
                           ) -> SearchResult:
    """Greedy sensitivity-ordered descent from all-int8 toward all-int4.

    The floor is given EITHER absolutely (``accuracy_floor``) or relatively
    (``floor_delta``: allowed drop below a reference score, ``fp_score``
    when supplied, else the all-int8 base this search measures anyway);
    exactly one of the two must be set. ``layers`` restricts the candidate
    set (default: every layer). A layer whose greedy move drops accuracy
    below the floor is skipped, not terminal.
    """
    if (accuracy_floor is None) == (floor_delta is None):
        raise ValueError("pass exactly one of accuracy_floor / floor_delta")
    if accuracy_floor is not None and fp_score is not None:
        raise ValueError("fp_score only applies to a floor_delta floor")
    cand = list(range(num_layers)) if layers is None else list(layers)

    def mk(int4: Sequence[int]) -> QuantPolicy:
        return QuantPolicy(num_layers=num_layers, mode=mode,
                           int4_layers=tuple(sorted(int4)),
                           default_bits=default_bits, grad_mode=grad_mode)

    base = float(score_fn(mk(())))
    floor = (accuracy_floor if accuracy_floor is not None
             else (fp_score if fp_score is not None else base) - floor_delta)
    probes = [(l, base - float(score_fn(mk((l,))))) for l in cand]
    ranking = tuple(sorted(probes, key=lambda t: (t[1], t[0])))

    chosen: list[int] = []
    best = base
    trajectory = []
    for l, _drop in ranking:
        trial = chosen + [l]
        acc = float(score_fn(mk(trial)))
        ok = acc >= floor
        trajectory.append((tuple(sorted(trial)), acc, ok))
        if ok:
            chosen, best = trial, acc
    return SearchResult(policy=mk(chosen), accuracy=best,
                        base_accuracy=base, sensitivity=ranking,
                        trajectory=tuple(trajectory), floor=floor)


def cached_probe_scorer(deploy_fn: Callable[[QuantPolicy], object],
                        score_fn: Callable[[object], float]
                        ) -> Callable[[QuantPolicy], float]:
    """A drop-in ``score_fn`` for :func:`search_mixed_precision` that makes
    each probe cost a SCORE, not a deploy.

    A deployed candidate is assembled from ingredients that never depend on
    the MIX of layers: ``deploy()``'s calibration forward runs in fp (a
    learned scale depends only on its own layer's grid), and packed codes
    and scales are per layer. A mixed-policy deploy is therefore exactly
    the per-layer interleave of the all-int4 and all-int8 grid deploys, bit
    for bit (``benchmarks/table1_glue.run_artifact`` asserts it against the
    full probe). So ``deploy_fn`` runs once per uniform grid (lazily), and
    every candidate is assembled by slicing the stacked layer segments out
    of the cached grids under the candidate's own plan; only ``score_fn``
    runs per candidate, memoized on the per-layer bit vector. A bit width
    outside {4, default_bits} falls back to a full ``deploy_fn`` call.
    """
    grids: dict = {}    # w_bits -> uniform-grid DeployedModel
    memo: dict = {}     # per-layer bit vector -> score

    def grid_for(policy: QuantPolicy, bits: int):
        if bits not in grids:
            all_l = tuple(range(policy.num_layers))
            grids[bits] = deploy_fn(dataclasses.replace(
                policy, int4_layers=(all_l if bits == 4 else ()),
                last_k_int4=0))
        return grids[bits]

    def assemble(policy: QuantPolicy):
        from ..deploy import DeployedModel, ExecutionPlan

        base = grid_for(policy, policy.default_bits)
        plan = ExecutionPlan.build(base.plan.cfg, policy,
                                   **base.plan.build_kwargs())
        stacks = []
        for (s, e, spec) in plan.segments:
            if spec.w_bits not in (4, policy.default_bits):
                return deploy_fn(policy)
            g = grid_for(policy, spec.w_bits)
            for (gs, ge, _), stack in zip(g.plan.segments, g.params["layers"]):
                if gs <= s and e <= ge:
                    stacks.append(tree_map(
                        lambda a, lo=s - gs, hi=e - gs: a[lo:hi], stack))
                    break
            else:                            # grid segmented unexpectedly
                return deploy_fn(policy)
        params = dict(base.params)
        params["layers"] = stacks
        return DeployedModel(plan=plan, params=params)

    def score(policy: QuantPolicy) -> float:
        key = tuple(policy.weight_bits_vector().tolist())
        if key not in memo:
            memo[key] = float(score_fn(assemble(policy)))
        return memo[key]

    return score


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
