"""Inception Score, KID and improved precision/recall: counterpart of
``diff_pruning_tpu/eval/fidelity.py`` (torch_fidelity's metric family with
isc, fid, kid and prc all on).

All three reuse the pool3 features of the FID pass (eval/fid.py
``features_of_path``); the Inception Score also needs the classifier head,
which :class:`~diff_pruning_tpu_torch.eval.inception.FIDInceptionV3` holds
as ``fc`` when its weights carry one.

Semantics follow torch_fidelity's defaults: ISC splits=10; KID polynomial
kernel (x·y/d + 1)^3 with 100 subsets of size 1000, unbiased MMD²;
precision/recall per Kynkäänniemi et al. with k=3 NN manifolds. The
Inception Score is host numpy, as in the JAX package; KID and
precision/recall run their products in f32 on ``device`` and draw their
subsets from the same numpy generator as the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def inception_probs(model: torch.nn.Module, pool3: np.ndarray, *,
                    unbiased: bool = True) -> np.ndarray:
    """pool3 (N, 2048) -> class probabilities (N, 1008) via the fc head.

    ``unbiased=True`` (default) drops the fc bias like torch_fidelity's
    'logits_unbiased', the original OpenAI IS formulation."""
    fc = getattr(model, "fc", None)
    if fc is None:
        raise ValueError("the Inception weights lack the fc head: the Inception Score needs "
                         "weights that carry one (pt_inception's .pth has it)")
    logits = pool3 @ fc.weight.detach().cpu().numpy().T
    if not unbiased:
        logits = logits + fc.bias.detach().cpu().numpy()
    x = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=1, keepdims=True)


def inception_score(probs: np.ndarray, *, splits: int = 10,
                    shuffle: bool = True, seed: int = 0) -> Tuple[float, float]:
    """ISC over (N, C) class probabilities: exp(E_x KL(p(y|x) || p(y)))
    per split; returns (mean, std) over the splits.

    Samples are shuffled first like torch_fidelity (samples_shuffle=True),
    so class-ordered inputs do not concentrate each split's marginal p(y);
    splits is clamped to the sample count so tiny inputs never produce
    empty (NaN) splits."""
    n = len(probs)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    scores = []
    for part in np.array_split(order, min(splits, n)):
        p = probs[part]
        py = p.mean(axis=0, keepdims=True)
        kl = np.sum(p * (np.log(p + 1e-16) - np.log(py + 1e-16)), axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))


def _poly_kernel(x, y, *, degree=3, coef0=1.0):
    gamma = 1.0 / x.shape[-1]
    return (x @ y.transpose(-1, -2) * gamma + coef0) ** degree


def kid(feat1: np.ndarray, feat2: np.ndarray, *, subset_size: int = 1000,
        subsets: int = 100, seed: int = 0, device="cpu") -> Tuple[float, float]:
    """Kernel Inception Distance: unbiased MMD² with the cubic polynomial
    kernel, averaged over random subsets; returns (mean, std). Every subset
    goes through one batched product."""
    rng = np.random.default_rng(seed)
    m = min(subset_size, len(feat1), len(feat2))
    f1 = torch.as_tensor(np.asarray(feat1, np.float32), device=device)
    f2 = torch.as_tensor(np.asarray(feat2, np.float32), device=device)
    idx1 = np.stack([rng.choice(len(feat1), m, replace=False) for _ in range(subsets)])
    idx2 = np.stack([rng.choice(len(feat2), m, replace=False) for _ in range(subsets)])
    x = f1[torch.as_tensor(idx1, device=device)]
    y = f2[torch.as_tensor(idx2, device=device)]
    kxx, kyy, kxy = _poly_kernel(x, x), _poly_kernel(y, y), _poly_kernel(x, y)
    t1 = (kxx.sum((1, 2)) - kxx.diagonal(dim1=1, dim2=2).sum(1)) / (m * (m - 1))
    t2 = (kyy.sum((1, 2)) - kyy.diagonal(dim1=1, dim2=2).sum(1)) / (m * (m - 1))
    vals = (t1 + t2 - 2.0 * kxy.mean((1, 2))).cpu().numpy()
    return float(np.mean(vals)), float(np.std(vals))


def precision_recall(feat_real: np.ndarray, feat_gen: np.ndarray, *,
                     k: int = 3, row_chunk: int = 4096, device="cpu") -> Dict[str, float]:
    """Improved precision & recall (Kynkäänniemi et al. 2019): a sample is
    covered if it falls inside any reference ball of radius = that
    reference point's k-th-NN distance. precision = gen covered by the
    real manifold; recall = real covered by the gen manifold.

    Distances are computed in row chunks (like torch_fidelity): the whole
    N x N matrix at the 50k-vs-50k FID scale would take 10 GB."""
    r = torch.as_tensor(np.asarray(feat_real, np.float32), device=device)
    g = torch.as_tensor(np.asarray(feat_gen, np.float32), device=device)

    def chunk_d2(a, b):
        an = (a * a).sum(1, keepdim=True)
        bn = (b * b).sum(1)
        return torch.clamp_min(an - 2.0 * (a @ b.T) + bn[None, :], 0.0)

    def knn_radius2(a):
        radii = []
        for start in range(0, a.shape[0], row_chunk):
            d2 = chunk_d2(a[start:start + row_chunk], a)
            rows = torch.arange(d2.shape[0], device=device)
            d2[rows, start + rows] = float("inf")  # each row's own point
            radii.append(torch.topk(d2, k, dim=1, largest=False).values[:, -1])
        return torch.cat(radii)

    def coverage(ref, samples):
        rad2 = knn_radius2(ref)
        inside = torch.cat([(chunk_d2(samples[i:i + row_chunk], ref) <= rad2[None, :]).any(1)
                            for i in range(0, samples.shape[0], row_chunk)])
        return float(inside.float().mean())

    return {"precision": coverage(r, g), "recall": coverage(g, r)}
