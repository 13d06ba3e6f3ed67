"""Graph and importance visualizers (counterpart of
``diff_pruning_tpu/pruning/visualize.py``): functional forms of
torch_pruning/utils/utils.py (draw_dependency_graph/draw_groups:27-127) and
the vendored metapruner's per-group importance bar plots
(metapruner.py:218-223). matplotlib is imported only when a plot is drawn.
No CLI calls them.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np

from .graph import ChannelGraph


def var_adjacency(graph: ChannelGraph):
    """(names, matrix): vars are adjacent when some layer's params couple
    them (an 'in' axis of a param whose 'out' axis is another var, or shared
    concat membership)."""
    names = [v.name for v in graph.vars.values()]
    idx = {n: i for i, n in enumerate(names)}
    m = np.zeros((len(names), len(names)), dtype=np.int32)
    by_param: Dict[str, list] = {}
    for ref in graph.refs:
        by_param.setdefault(ref.param.rsplit("/", 1)[0], []).append(ref)
    for refs in by_param.values():
        vs = sorted({v.name for r in refs for v, _ in r.parts})
        for i, a in enumerate(vs):
            for b in vs[i + 1:]:
                m[idx[a], idx[b]] = m[idx[b], idx[a]] = 1
    return names, m


def draw_dependency_graph(graph: ChannelGraph, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names, m = var_adjacency(graph)
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.25),) * 2)
    ax.imshow(m, cmap="Blues")
    ax.set_xticks(range(len(names)))
    ax.set_yticks(range(len(names)))
    ax.set_xticklabels(names, rotation=90, fontsize=4)
    ax.set_yticklabels(names, fontsize=4)
    ax.set_title("channel-var coupling (shared layers)")
    fig.tight_layout()
    fig.savefig(path, dpi=200)
    plt.close(fig)


def draw_importance_bars(scores: Mapping[str, np.ndarray], outdir: str,
                         keep: Optional[Mapping[str, np.ndarray]] = None) -> None:
    """One bar plot per var, the kept channels blue and the dropped red
    (metapruner.py:218-223)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    for i, (name, imp) in enumerate(scores.items()):
        fig, ax = plt.subplots(figsize=(8, 2.5))
        colors = None
        if keep is not None and name in keep:
            mask = np.zeros(len(imp), dtype=bool)
            mask[np.asarray(keep[name])] = True
            colors = ["tab:blue" if k else "tab:red" for k in mask]
        ax.bar(range(len(imp)), np.asarray(imp), color=colors)
        ax.set_title(name, fontsize=8)
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, f"imp_{i:03d}.png"), dpi=120)
        plt.close(fig)
