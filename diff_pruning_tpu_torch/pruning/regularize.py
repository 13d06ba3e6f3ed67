"""Sparse-training regularizers (counterpart of
``diff_pruning_tpu/pruning/regularize.py``): functional forms of the
vendored torch_pruning regularizing pruners, which the reference carries
for completeness and its shipped scripts do not use (SURVEY.md §2.2).

* :func:`l1_norm_scale_penalty`: BNScalePruner.regularize's L1 on norm
  gammas (batchnorm_scale_pruner.py:45-48), here on GroupNorm and LayerNorm
  scales.
* :func:`group_lasso_grads`: GroupNormPruner.regularize's exponential
  group-norm-scaled decay added to grads (group_norm_pruner.py:54-180:
  scale = 2^(alpha (max - gn) / (max - min))).
* :func:`taylor_scaled_grads`, :func:`scaling_factor_grads`: TaylorPruner's
  and ScalingFactorPruner's scaled decay.

Each is pure and driven by the ChannelGraph the pruner uses: ``params`` and
``grads`` are nested dicts in the checkpoint layout (HWIO conv kernels,
(din, dout) linear kernels, as ``pruning/surgery.py`` and the importance
functions read them) whose leaves are torch tensors (numpy arrays are taken
as CPU tensors); the results are torch tensors on the leaves' device. No
trainer or CLI calls them, in this package or in the JAX one: their only
caller is the parity test against the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch

from .graph import ChannelGraph
from .surgery import flatten_params, get_path, set_path, unflatten_params


def _leaf(tree, path: str) -> torch.Tensor:
    return torch.as_tensor(get_path(tree, path))


def _device_of(tree) -> torch.device:
    return torch.as_tensor(next(iter(flatten_params(tree).values()))).device


def _channels(arr: torch.Tensor, axis: int, off: int, size: int) -> torch.Tensor:
    """(size, -1) f32 view of the channels [off, off + size) along ``axis``."""
    return arr.movedim(axis, 0)[off:off + size].reshape(size, -1).to(torch.float32)


def l1_norm_scale_penalty(graph: ChannelGraph, params, *, coeff: float = 1e-5):
    """coeff * sum |gamma| over every registered norm-scale axis."""
    total = 0.0
    seen = set()
    for ref in graph.refs:
        if ref.role != "norm" or ref.param in seen:
            continue
        seen.add(ref.param)
        total = total + _leaf(params, ref.param).abs().sum()
    return coeff * total


def group_l2_norms(graph: ChannelGraph, params) -> Dict[str, torch.Tensor]:
    """Per-channel L2 norm of each prunable var's full group (the quantity
    GroupNormImportance scores; importance.py:227-330)."""
    dev = _device_of(params)
    out = {}
    for v in graph.prunable_vars():
        sq = torch.zeros((v.size,), device=dev)
        for ref, off in graph.refs_of(v):
            if ref.role == "bias":
                continue
            sq = sq + (_channels(_leaf(params, ref.param), ref.axis, off, v.size) ** 2).sum(1)
        out[v.name] = torch.sqrt(sq)
    return out


def _add_scaled_decay(new_grads, params, ref, off: int, size: int, scale: torch.Tensor,
                      reg: float) -> None:
    """grad += reg * scale * w on the channels [off, off + size) of ``ref``'s axis."""
    w = _leaf(params, ref.param)
    g = _leaf(new_grads, ref.param)
    full = torch.zeros((w.shape[ref.axis],), dtype=scale.dtype, device=scale.device)
    full[off:off + size] = scale
    sh = [1] * w.ndim
    sh[ref.axis] = w.shape[ref.axis]
    scale_b = full.reshape(sh)
    wslice = torch.where(scale_b > 0, w, torch.zeros((), dtype=w.dtype, device=w.device))
    set_path(new_grads, ref.param, g + (reg * scale_b * wslice).to(g.dtype))


def group_lasso_grads(graph: ChannelGraph, params, grads, *,
                      reg: float = 1e-4, alpha: float = 4.0):
    """Add exponential group-norm-scaled weight decay to grads.

    Per var: scale_c = 2^(alpha * (gn_max - gn_c) / (gn_max - gn_min)),
    grad += reg * scale_c * w: pushes already-weak channel groups toward
    zero faster (group_norm_pruner.py's schedule with base 2)."""
    norms = group_l2_norms(graph, params)
    new_grads = unflatten_params(flatten_params(grads))
    for v in graph.prunable_vars():
        gn = norms[v.name]
        span = torch.clamp(gn.max() - gn.min(), min=1e-12)
        scale = 2.0 ** (alpha * (gn.max() - gn) / span)
        for ref, off in graph.refs_of(v):
            if ref.role != "bias":
                _add_scaled_decay(new_grads, params, ref, off, v.size, scale, reg)
    return new_grads


def _per_channel_taylor(graph: ChannelGraph, params, grads) -> Dict[str, torch.Tensor]:
    """Per-channel sum of |w * dw| across every non-bias ref of each var:
    TaylorPruner.regularize's group importance (taylor_pruner.py:63-119)."""
    dev = _device_of(params)
    out = {}
    for v in graph.prunable_vars():
        acc = torch.zeros((v.size,), device=dev)
        for ref, off in graph.refs_of(v):
            if ref.role == "bias":
                continue
            w = _channels(_leaf(params, ref.param), ref.axis, off, v.size)
            g = _channels(_leaf(grads, ref.param), ref.axis, off, v.size)
            acc = acc + (w * g).abs().sum(1)
        out[v.name] = acc
    return out


def _scaled_decay_grads(graph: ChannelGraph, params, grads,
                        per_var_scores: Dict[str, torch.Tensor], *,
                        reg: float, base: float, roles) -> dict:
    """grad += reg * base^((max - s) / (max - min)) * w on every ref whose
    role is in ``roles``: the shared update of the reference's regularizing
    pruners (taylor_pruner.py:124-145, scaling_factor_pruner.py:76-89)."""
    new_grads = unflatten_params(flatten_params(grads))
    for v in graph.prunable_vars():
        s = per_var_scores[v.name]
        span = torch.clamp(s.max() - s.min(), min=1e-12)
        scale = base ** ((s.max() - s) / span)
        for ref, off in graph.refs_of(v):
            if ref.role in roles:
                _add_scaled_decay(new_grads, params, ref, off, v.size, scale, reg)
    return new_grads


def taylor_scaled_grads(graph: ChannelGraph, params, grads, *,
                        reg: float = 1e-4, base: float = 16.0) -> dict:
    """TaylorPruner.regularize (taylor_pruner.py:54-145): weight decay
    scaled by base^((imp_max - imp) / (imp_max - imp_min)), where imp is
    the group's per-channel sum of |w dw|: decays the channels Taylor deems
    weak."""
    scores = _per_channel_taylor(graph, params, grads)
    return _scaled_decay_grads(graph, params, grads, scores, reg=reg, base=base,
                               roles=("out", "in", "norm"))


def scaling_factor_grads(graph: ChannelGraph, params, grads, *,
                         reg: float = 1e-4, base: float = 16.0) -> dict:
    """ScalingFactorPruner.regularize (scaling_factor_pruner.py:51-89):
    group norm = sqrt(sum gamma^2) over the var's norm scales; only the norm
    scales receive the scaled decay."""
    dev = _device_of(params)
    out = {}
    for v in graph.prunable_vars():
        sq = torch.zeros((v.size,), device=dev)
        found = False
        for ref, off in graph.refs_of(v):
            if ref.role != "norm":
                continue
            found = True
            sq = sq + (_channels(_leaf(params, ref.param), ref.axis, off, v.size) ** 2).sum(1)
        out[v.name] = torch.sqrt(sq) if found else torch.ones((v.size,), device=dev)
    return _scaled_decay_grads(graph, params, grads, out, reg=reg, base=base,
                               roles=("norm",))
