"""Functional pruning surgery: slice flat params along graph-registered axes.

Counterpart of ``diff_pruning_tpu/pruning/surgery.py``. It works on numpy
arrays in the JAX layout (HWIO conv kernels, (din, dout) linear kernels),
which is the layout the graph registers: ``utils/checkpoint.py`` moves a
model's weights and accumulated grads into that layout and back. Given
keep-indices per ChannelVar, every registered axis is gathered
accordingly; concat offsets are handled through ``AxisRef.parts``; a new
config's ``channel_sizes`` records the result so the pruned model rebuilds
from (config, params) alone.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

from .graph import ChannelGraph


def get_path(tree, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def set_path(tree, path: str, value) -> None:
    parts = path.split("/")
    node = tree
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value


def flatten_params(tree, prefix: str = "") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_params(v, path))
        else:
            out[path] = v
    return out


def unflatten_params(flat: Mapping[str, object]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _deepcopy_tree(tree):
    if isinstance(tree, dict):
        return {k: _deepcopy_tree(v) for k, v in tree.items()}
    return tree


def slice_params(
    params: dict,
    graph: ChannelGraph,
    keep: Mapping[str, Sequence[int]],
) -> dict:
    """Return new params with every registered axis gathered by keep-indices.

    ``params`` is a nested dict of numpy arrays (``unflatten_params`` of a
    flat JAX-layout dict). ``keep[var.name]`` is a sorted array of channel
    indices (into the var's *current* size) to retain. Vars absent from
    ``keep`` are kept whole.
    """
    new_params = _deepcopy_tree(params)
    for ref in graph.refs:
        pieces = []
        changed = False
        for var, off in ref.parts:
            k = keep.get(var.name)
            if k is None:
                pieces.append(np.arange(var.size) + off)
            else:
                changed = True
                pieces.append(np.asarray(k, dtype=np.int64) + off)
        if not changed:
            continue
        idx = np.concatenate(pieces)
        arr = get_path(new_params, ref.param)
        set_path(new_params, ref.param, np.take(np.asarray(arr), idx, axis=ref.axis))
    return new_params


def pruned_channel_sizes(
    graph: ChannelGraph, keep: Mapping[str, Sequence[int]]
) -> Dict[str, int]:
    """channel_sizes dict for the pruned config: every prunable var's new size."""
    sizes = {}
    for v in graph.vars.values():
        if not v.prunable:
            continue
        k = keep.get(v.name)
        sizes[v.name] = len(k) if k is not None else v.size
    return sizes
