"""Pruner: select keep-indices per ChannelVar and apply functional surgery.

Counterpart of ``diff_pruning_tpu/pruning/pruner.py`` (numpy only, the same
selection): the same scores give the same keep-indices in both packages.
``cost_weights`` is plain numpy and stays; its source, ``pruning/cost.py``,
is not ported yet.

Functional MetaPruner (ddpm_exp/torch_pruning/pruner/algorithms/metapruner.py).
Local mode scores each var independently and drops its lowest-importance
channels at the target sparsity, respecting the var's group_div (GN groups /
attention heads, metapruner.py:237-246) and round_to (:232-233). Global mode
concatenates (sub-group-reduced) importances and thresholds at the global
top-k (:256-297), with a per-var max-sparsity guard (the reference's
_check_sparsity, metapruner.py:172-194: never prune a layer below
init*(1-max_sparsity) channels, and never to zero).

Selection is side-effect-free: ``round_to`` tightens rounding for this call
only (the graph's per-var round_to is never mutated), and where the global
round_to/caps truncate the drop set, the truncation is importance-aware —
the highest-score drop candidates are spared, not the highest-indexed ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

from .graph import ChannelGraph, ChannelVar
from .importance import ScoreFn
from .surgery import pruned_channel_sizes, slice_params


@dataclasses.dataclass
class PruneResult:
    keep: Dict[str, np.ndarray]  # var name -> sorted kept indices
    scores: Dict[str, np.ndarray]
    channel_sizes: Dict[str, int]


def _select_keep(
    imp: np.ndarray, var: ChannelVar, sparsity: float,
    round_to: Optional[int] = None,
) -> Optional[np.ndarray]:
    """Indices to keep for one var (ascending). None = keep all.
    ``round_to`` overrides var.round_to for this call (never mutates it)."""
    size = var.size
    if round_to is None:
        round_to = var.round_to
    n_pruned = size - int(size * (1.0 - sparsity))
    g = var.group_div
    if g > 1:
        # prune uniformly per contiguous sub-block (metapruner.py:237-246).
        # The realized drop is g * n_per, so round_to must be enforced on
        # n_per itself: truncate it to a multiple of rt/gcd(rt, g) — the same
        # algebra the global path uses (below, `step = rt // gcd`). Rounding
        # n_pruned BEFORE the division would let g * (n_pruned // g) violate
        # round_to whenever rt ∤ g (e.g. rt=3, g=2).
        n_per = n_pruned // g
        if round_to > 1:
            step = round_to // int(np.gcd(round_to, g))
            n_per -= n_per % step
        if n_per <= 0:
            return None
        gs = size // g
        drop = []
        for chg in range(g):
            sub = imp[chg * gs:(chg + 1) * gs]
            drop.append(np.argsort(sub, kind="stable")[:n_per] + chg * gs)
        drop = np.concatenate(drop)
    else:
        if round_to > 1:
            n_pruned -= n_pruned % round_to
        if n_pruned <= 0:
            return None
        drop = np.argsort(imp, kind="stable")[:n_pruned]
    mask = np.ones(size, dtype=bool)
    mask[drop] = False
    keep = np.nonzero(mask)[0]
    if keep.size == 0 or keep.size == size:
        return None
    return keep


def prune(
    graph: ChannelGraph,
    params: dict,
    importance: ScoreFn,
    *,
    sparsity: float,
    grads: Optional[dict] = None,
    ignored_vars: Sequence[str] = (),
    sparsity_per_var: Optional[Mapping[str, float]] = None,
    global_pruning: bool = False,
    round_to: Optional[int] = None,
    max_sparsity: float = 1.0,
    cost_weights: Optional[Mapping[str, float]] = None,
) -> PruneResult:
    """`round_to` tightens every var's rounding for this call
    (ldm_exp/prune_ldm.py:99 passes round_to=2 globally). ``max_sparsity``
    caps the per-var drop fraction in global mode (metapruner.py:172-194);
    ``sparsity_per_var`` sets per-var targets in local mode and acts as a
    per-var cap in global mode.

    ``cost_weights`` ({var: cost per channel}; the JAX package's
    ``pruning/cost.py`` computes them) turns
    global mode bandwidth-aware: candidates are ranked by importance per
    unit hardware cost, so the pool preferentially drops channels that cost
    machine time rather than just MACs — beyond the reference, which has no
    hardware model at all. NOTE: ``sparsity`` budgets pooled CHANNEL-GROUPS
    (reference semantics); a GN-constrained var (group_div=32) contributes
    one pooled entry per 32 channels, so when cost-division concentrates
    drops into wide convs the realized channel/param sparsity exceeds the
    nominal target — compare cost-aware runs at equal params, not equal
    nominal sparsity."""
    ignored = set(ignored_vars)
    vars_ = [v for v in graph.prunable_vars() if v.name not in ignored]
    eff_rt = {v.name: max(v.round_to, round_to or 1) for v in vars_}
    scores: Dict[str, np.ndarray] = {}
    for v in vars_:
        scores[v.name] = np.asarray(importance(graph, params, v, grads=grads), dtype=np.float64)

    keep: Dict[str, np.ndarray] = {}
    if global_pruning:
        # Reduce each var's score to per-"channel-group" scalars, pool, and
        # threshold globally (metapruner.py:256-297): with group_div>1 only
        # the first sub-block participates in the pool and the chosen drops
        # replicate across sub-blocks. Unless the importance fn already
        # normalized (make_importance(normalizer=...) marks itself), scores
        # are mean-normalized per var before pooling (the reference
        # importance's default normalizer) — without it, cross-layer scale
        # differences concentrate all drops in a few low-magnitude layers.
        if getattr(importance, "normalizer", None) is not None:
            norm_scores = scores
        else:
            norm_scores = {
                v.name: scores[v.name] / max(scores[v.name].mean(), 1e-30)
                for v in vars_}
        if cost_weights is not None:
            # importance per unit cost; costs normalized to mean 1 over the
            # participating vars so thresholds stay in importance units
            cw = np.asarray([max(cost_weights.get(v.name, 0.0), 0.0)
                             for v in vars_], dtype=np.float64)
            cw = np.where(cw <= 0.0, cw[cw > 0].mean() if (cw > 0).any() else 1.0, cw)
            cw = cw / cw.mean()
            # cost division only ranks correctly on a non-negative scale:
            # mean-centering normalizers (gaussian/standardization) emit
            # negative scores, and dividing a negative by a large cost moves
            # it TOWARD zero — high cost would then protect unimportant
            # channels. One global shift preserves every ranking and is a
            # no-op for the non-negative normalizers.
            gmin = min(float(s.min()) for s in norm_scores.values())
            shift = -gmin if gmin < 0.0 else 0.0
            norm_scores = {
                v.name: (norm_scores[v.name] + shift) / cw[i]
                for i, v in enumerate(vars_)}
        pooled = []
        for v in vars_:
            imp = norm_scores[v.name]
            sub = imp[: v.size // v.group_div] if v.group_div > 1 else imp
            pooled.append(sub)
        flat = np.concatenate(pooled)
        total = flat.size
        n_pruned = total - int(total * (1.0 - sparsity))
        if n_pruned <= 0:
            return PruneResult({}, scores, pruned_channel_sizes(graph, {}))
        thres = np.partition(flat, n_pruned - 1)[n_pruned - 1]
        for v in vars_:
            imp = norm_scores[v.name]
            gs = v.size // v.group_div
            sub = imp[:gs] if v.group_div > 1 else imp
            drop_local = np.nonzero(sub <= thres)[0]
            # order candidates most-droppable first so every truncation below
            # spares the highest-importance ones (index-order truncation
            # would be importance-blind)
            drop_local = drop_local[np.argsort(sub[drop_local], kind="stable")]
            # per-var cap: the reference's max_ch_sparsity guard
            # (metapruner.py:172-194) + never prune a var to zero
            cap_frac = min(max_sparsity,
                           sparsity_per_var.get(v.name, 1.0)
                           if sparsity_per_var else 1.0)
            max_drop_total = min(int(v.size * cap_frac), v.size - 1)
            max_drop_local = max_drop_total // v.group_div
            if len(drop_local) > max_drop_local:
                drop_local = drop_local[:max_drop_local]
            rt = eff_rt[v.name]
            if rt > 1:
                # total drops = group_div * n_loc must divide by rt while
                # staying symmetric across sub-groups: truncate n_loc to a
                # multiple of rt/gcd(rt, group_div); ascending-score order
                # means the spared candidates are the highest-importance ones
                step = rt // np.gcd(rt, v.group_div)
                n_loc = len(drop_local) - (len(drop_local) % step)
                drop_local = drop_local[:n_loc]
            if v.group_div > 1:
                drop = np.concatenate([drop_local + gs * i for i in range(v.group_div)])
            else:
                drop = drop_local
            if len(drop) == 0 or len(drop) >= v.size:
                continue
            mask = np.ones(v.size, dtype=bool)
            mask[drop] = False
            keep[v.name] = np.nonzero(mask)[0]
    else:
        for v in vars_:
            s = sparsity_per_var.get(v.name, sparsity) if sparsity_per_var else sparsity
            s = min(s, max_sparsity)
            k = _select_keep(scores[v.name], v, s, eff_rt[v.name])
            if k is not None:
                keep[v.name] = k

    return PruneResult(keep, scores, pruned_channel_sizes(graph, keep))


def apply_pruning(params: dict, graph: ChannelGraph, result: PruneResult) -> dict:
    return slice_params(params, graph, result.keep)
