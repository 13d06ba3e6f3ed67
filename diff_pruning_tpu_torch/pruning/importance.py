"""Channel-importance estimators as pure functions of (params, grads).

Counterpart of ``diff_pruning_tpu/pruning/importance.py``, numpy only: params
and grads are nested dicts of numpy arrays in the JAX layout (see
``surgery.py``), so both packages score the same arrays the same way.

Functional equivalents of torch_pruning's Importance classes
(ddpm_exp/torch_pruning/pruner/importance.py; pip torch-pruning ~v1.1 for the
Taylor ``multivariable`` switch used at ddpm_prune.py:60,66).

Each estimator maps a ChannelVar to a 1-D score vector of length
``var.size``: for every registered weight axis touching the var, the param
(and, for gradient-based criteria, its accumulated grad) is sliced to the
var's range, the channel axis moved to the front and the rest flattened, a
per-channel local score computed, then local scores are mean-reduced across
all axes in the group — mirroring the reference's group_reduction="mean".

Role conventions (graph.AxisRef.role): 'out', 'in', and 'norm' axes
participate; 'bias' axes are excluded, matching torch_pruning which scores
only ``.weight`` tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np

from .graph import ChannelGraph, ChannelVar
from .surgery import get_path

ScoreFn = Callable[..., np.ndarray]


def _channel_matrix(arr, axis: int, offset: int, size: int) -> np.ndarray:
    """Slice [offset:offset+size] along axis, channel-first, flatten rest."""
    a = np.asarray(arr)
    a = np.take(a, np.arange(offset, offset + size), axis=axis)
    a = np.moveaxis(a, axis, 0)
    return a.reshape(size, -1)


def _group_scores(
    graph: ChannelGraph,
    params,
    var: ChannelVar,
    local_fn: Callable[[np.ndarray, Optional[np.ndarray]], np.ndarray],
    grads=None,
) -> np.ndarray:
    locals_ = []
    for ref, off in graph.refs_of(var):
        if ref.role == "bias":
            continue
        w = _channel_matrix(get_path(params, ref.param), ref.axis, off, var.size)
        g = None
        if grads is not None:
            g = _channel_matrix(get_path(grads, ref.param), ref.axis, off, var.size)
        locals_.append(local_fn(w, g))
    if not locals_:
        raise ValueError(f"no weight axes registered for var {var.name}")
    return np.mean(np.stack(locals_, axis=0), axis=0)


def magnitude_importance(graph, params, var, *, p: int = 2, grads=None) -> np.ndarray:
    """MagnitudeImportance: Lp norm per channel (importance.py:18-126)."""
    del grads
    return _group_scores(
        graph, params, var,
        lambda w, g: np.linalg.norm(w.astype(np.float64), ord=p, axis=1))


def random_importance(graph, params, var, *, rng: np.random.Generator, grads=None) -> np.ndarray:
    """RandomImportance (importance.py:221-225)."""
    del graph, params, grads
    return rng.random(var.size)


def taylor_importance(graph, params, var, *, grads, multivariable: bool = False) -> np.ndarray:
    """First-order Taylor saliency over accumulated grads.

    pip torch-pruning ~v1.1 TaylorImportance:
      multivariable=True  -> |sum_j w_j * g_j| per channel ('taylor' pruner)
      multivariable=False -> sum_j |w_j * g_j| per channel ('diff-pruning')
    (switch at ddpm_prune.py:60,66).
    """

    def local(w, g):
        wg = w.astype(np.float64) * g.astype(np.float64)
        if multivariable:
            return np.abs(wg.sum(axis=1))
        return np.abs(wg).sum(axis=1)

    return _group_scores(graph, params, var, local, grads=grads)


def diff_pruning_importance(graph, params, var, *, grads) -> np.ndarray:
    """The paper's criterion = TaylorImportance(multivariable=False)."""
    return taylor_importance(graph, params, var, grads=grads, multivariable=False)


def lamp_importance(graph, params, var, *, grads=None) -> np.ndarray:
    """LAMP (importance.py:154-219): squared magnitude divided by the
    cumulative sum of larger-or-equal squared magnitudes (per group)."""
    del grads
    m = _group_scores(
        graph, params, var,
        lambda w, g: (w.astype(np.float64) ** 2).sum(axis=1))
    order = np.argsort(-m, kind="stable")
    sorted_m = m[order]
    denom = np.cumsum(sorted_m)
    scores_sorted = sorted_m / np.maximum(denom, 1e-12)
    out = np.empty_like(m)
    out[order] = scores_sorted
    return out


def group_norm_importance(graph, params, var, *, grads=None) -> np.ndarray:
    """GroupNormImportance (importance.py:227-330): full-group L2 norm."""
    del grads
    sq = _group_scores(
        graph, params, var,
        lambda w, g: (w.astype(np.float64) ** 2).sum(axis=1))
    # _group_scores means across refs; the group L2 is the sqrt of the sum —
    # a monotonic transform of the mean, identical ranking
    return np.sqrt(sq)


def fisher_importance(graph, params, var, *, grads) -> np.ndarray:
    """FisherImportance: sum_j g_j^2 (vendored importance.py:672-782)."""
    return _group_scores(
        graph, params, var,
        lambda w, g: (g.astype(np.float64) ** 2).sum(axis=1), grads=grads)


def full_taylor_importance(graph, params, var, *, grads, second_order: bool = True) -> np.ndarray:
    """FullTaylorImportance: |sum w*g (+ sum (w*g)^2)| (importance.py:438-548)."""

    def local(w, g):
        wg = w.astype(np.float64) * g.astype(np.float64)
        s = wg.sum(axis=1)
        if second_order:
            s = s + 0.5 * (wg**2).sum(axis=1)
        return np.abs(s)

    return _group_scores(graph, params, var, local, grads=grads)


def normalize_scores(imp: np.ndarray, normalizer) -> np.ndarray:
    """The reference's per-group score normalizer family
    (ddpm_exp/torch_pruning/importance.py:25-40, MagnitudeImportance
    ._normalize): None | callable | 'sum' | 'standarization' (min-max;
    'standardization' accepted too) | 'mean' | 'max' | 'gaussian'.

    Every variant is monotonic within a var, so LOCAL ranking is unchanged;
    they matter for GLOBAL pooling, where cross-layer scale decides which
    layers absorb the drops."""
    if normalizer is None:
        return imp
    if callable(normalizer):
        return np.asarray(normalizer(imp))
    imp = imp.astype(np.float64)
    # denominators guarded like the pruner's global-mode default
    # (max(mean, 1e-30)): an all-zero score vector (e.g. taylor on a dead
    # zero-init out-conv path) must normalize to zeros, not 0/0 NaNs that
    # poison the global np.partition pool.
    if normalizer == "sum":
        return imp / max(imp.sum(), 1e-30)
    if normalizer in ("standarization", "standardization"):
        return (imp - imp.min()) / (imp.max() - imp.min() + 1e-8)
    if normalizer == "mean":
        return imp / max(imp.mean(), 1e-30)
    if normalizer == "max":
        return imp / max(imp.max(), 1e-30)
    if normalizer == "gaussian":
        return (imp - imp.mean()) / (imp.std() + 1e-8)
    raise ValueError(f"unknown normalizer {normalizer!r}")


def make_importance(name: str, *, seed: int = 0,
                    multivariable: Optional[bool] = None,
                    normalizer=None) -> ScoreFn:
    """Factory keyed by the reference's --pruner choices (ddpm_prune.py:23).

    ``normalizer`` applies normalize_scores to every var's score vector (the
    reference normalizes at the end of each Importance.__call__). The
    returned fn carries it as ``.normalizer`` so the pruner's global mode
    knows normalization already happened."""
    fn = _make_raw_importance(name, seed=seed, multivariable=multivariable)
    if normalizer is not None:
        raw = fn
        fn = lambda graph, params, var, grads=None: normalize_scores(
            raw(graph, params, var, grads=grads), normalizer)
    fn.normalizer = normalizer
    return fn


def _make_raw_importance(name: str, *, seed: int = 0,
                         multivariable: Optional[bool] = None) -> ScoreFn:
    if name in ("random", "reinit"):
        rng = np.random.default_rng(seed)
        return lambda graph, params, var, grads=None: random_importance(
            graph, params, var, rng=rng)
    if name == "magnitude":
        return lambda graph, params, var, grads=None: magnitude_importance(
            graph, params, var)
    if name == "taylor":
        mv = True if multivariable is None else multivariable
        return lambda graph, params, var, grads=None: taylor_importance(
            graph, params, var, grads=grads, multivariable=mv)
    if name == "diff-pruning" or name == "ours":
        return lambda graph, params, var, grads=None: diff_pruning_importance(
            graph, params, var, grads=grads)
    if name == "fisher":
        return lambda graph, params, var, grads=None: fisher_importance(
            graph, params, var, grads=grads)
    if name == "lamp":
        return lambda graph, params, var, grads=None: lamp_importance(
            graph, params, var)
    if name == "group_norm":
        return lambda graph, params, var, grads=None: group_norm_importance(
            graph, params, var)
    if name in ("first_order_taylor", "full_taylor"):
        return lambda graph, params, var, grads=None: full_taylor_importance(
            graph, params, var, grads=grads, second_order=False)
    if name == "second_order_taylor":
        return lambda graph, params, var, grads=None: full_taylor_importance(
            graph, params, var, grads=grads, second_order=True)
    raise ValueError(f"unknown importance {name!r}")
