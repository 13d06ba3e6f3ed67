"""FID: Inception pool3 features, their statistics and the Fréchet distance.

Counterpart of ``diff_pruning_tpu/eval/fid.py``: the pytorch-fid pipeline
(activations -> (mu, sigma) -> Fréchet distance). The feature pass runs on
the model's device; the statistics and the distance are host numpy in
float64, as in the JAX package, where ``Tr((S1 S2)^1/2)`` comes from an
eigendecomposition identity,

    Tr((S1 S2)^1/2) = sum_i sqrt(lambda_i(S1^1/2 S2 S1^1/2)),

exact for PSD covariances. Stats files keep the JAX layout (``mu``,
``sigma``, ``resize_mode``), so they cross between the packages both ways.

With a ``mesh`` (``parallel/mesh.py``), the counterpart of the JAX
package's batch sharded over the data axis: each rank runs its rows of
every batch (a ragged batch zero-padded to a multiple of the world size,
the pad rows dropped), and the features are gathered back in file order, so
every rank returns the same features and statistics. A folder's ranks
decode only their own rows.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import DataMesh, all_gather_rows, padded_rows
from .inception import FIDInceptionV3, inception_pool3
from .resize import resize_bicubic_pil


def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu, sigma) with ddof=1 (np.cov's default, as
    pytorch-fid computes them)."""
    feats = np.asarray(feats, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def _psd_sqrt(mat: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh(mat)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)[None, :]) @ v.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^1/2), in float64 on the host."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    s1 = np.asarray(sigma1, np.float64)
    s2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    s1h = _psd_sqrt(s1)
    inner = s1h @ s2 @ s1h
    w = np.clip(np.linalg.eigvalsh(inner), 0.0, None)
    tr_sqrt = np.sum(np.sqrt(w))
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_sqrt)


def compute_activations(model: FIDInceptionV3, images_iter: Iterable[np.ndarray], *,
                        resize_mode: str = "torch",
                        mesh: Optional[DataMesh] = None) -> np.ndarray:
    """Iterate uint8/float NHWC image batches -> stacked (N, 2048) features.

    resize_mode 'torch' is pytorch-fid's in-network bilinear resize; 'clean'
    is clean-fid's preprocessing: the antialiased PIL-bicubic resize on
    float data before the network, overshoot unclipped (eval/resize.py).
    uint8 batches go to the device as they are and become x / 255 there
    (the same f32 division as the JAX package's on the host). Batches are
    taken as the iterator gives them (the last may be short), and the
    features stay on the device until the last batch is queued. With
    ``mesh``, every rank iterates the same batches and runs its rows of
    each (see the module docstring)."""

    def chunks():
        for batch in images_iter:
            if mesh is None:
                yield batch, len(batch)
            else:
                lo, hi, _ = padded_rows(mesh, len(batch))
                yield batch[lo:hi], len(batch)

    return _features(model, chunks(), resize_mode, mesh)


@torch.inference_mode()
def _features(model: FIDInceptionV3, chunks: Iterator[Tuple[np.ndarray, int]],
              resize_mode: str, mesh: Optional[DataMesh]) -> np.ndarray:
    """The features of ``chunks``: (this rank's rows of a batch, the batch's
    rows). Under a mesh each rank pads its rows to the batch's share, and one
    gather at the end puts every batch's rows back in order."""
    device = next(model.parameters()).device
    out, sizes = [], []
    for rows, n in chunks:
        x = torch.from_numpy(np.ascontiguousarray(rows))
        if mesh is not None:
            per = padded_rows(mesh, n)[2]
            if len(x) < per:  # the ragged batch's pad rows (or a rank without rows)
                x = torch.cat([x, x.new_zeros((per - len(x),) + tuple(x.shape[1:]))])
            sizes.append((n, per))
        if device.type == "cuda":  # pinned, so the copy need not wait for the device
            x = x.pin_memory()
        x = x.to(device, non_blocking=True)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        if resize_mode == "clean":
            feats = inception_pool3(model, resize_bicubic_pil(x, 299, 299), resize=False)
        else:
            feats = inception_pool3(model, x)
        out.append(feats)
    local = torch.cat(out)
    if mesh is None:
        return local.cpu().numpy()
    # every rank's padded rows, rank after rank; batch b's rows of rank r
    # start at r * (the rows a rank holds) + the rows of the batches before
    every = all_gather_rows(mesh, local).cpu().numpy()
    held = sum(per for _, per in sizes)
    parts, start = [], 0
    for n, per in sizes:
        rows = np.concatenate([every[r * held + start:r * held + start + per]
                               for r in range(mesh.world)])
        parts.append(rows[:n])
        start += per
    return np.concatenate(parts)


def statistics_of_path(
    path: str,
    model: FIDInceptionV3,
    *,
    batch_size: int = 128,
    resolution: Optional[int] = None,
    max_images: Optional[int] = None,
    resize_mode: str = "torch",
    mesh: Optional[DataMesh] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dir of images, .npz stats cache, or dataset name -> (mu, sigma).

    An .npz with mu/sigma keys is the precomputed-stats fast path (a warning
    is printed when it was computed with another resize mode); anything else
    goes through the dataset loader.
    """
    if path.endswith(".npz"):
        with np.load(path) as z:
            if "mu" in z.files:
                if "resize_mode" in z.files and str(z["resize_mode"]) != resize_mode:
                    print(f"warning: stats cache {path} was computed with "
                          f"resize_mode={z['resize_mode']} but this run uses "
                          f"{resize_mode} — FID mixes preprocessing families")
                return z["mu"], z["sigma"]
    feats = features_of_path(path, model, batch_size=batch_size, resolution=resolution,
                             max_images=max_images, resize_mode=resize_mode, mesh=mesh)
    return activation_statistics(feats)


def features_of_path(
    path: str,
    model: FIDInceptionV3,
    *,
    batch_size: int = 128,
    resolution: Optional[int] = None,
    max_images: Optional[int] = None,
    resize_mode: str = "torch",
    mesh: Optional[DataMesh] = None,
) -> np.ndarray:
    """Dir of images / dataset name -> raw (N, 2048) pool3 features (shared
    by the FID statistics and the ISC/KID/PRC metrics in eval/fidelity.py).

    An image folder is decoded by 16 threads with one batch of lookahead,
    so the next batch decodes while the device runs this one; under a
    ``mesh`` each rank decodes only its rows of every batch."""
    from ..data.datasets import ArrayDataset, get_dataset

    ds = get_dataset(path, resolution=resolution)
    n = len(ds) if max_images is None else min(max_images, len(ds))

    def mine(i):  # this rank's rows [lo, hi) of the batch starting at i
        m = min(i + batch_size, n) - i
        lo, hi, _ = (0, m, m) if mesh is None else padded_rows(mesh, m)
        return i + lo, i + hi, m

    def chunks():
        if isinstance(ds, ArrayDataset):
            for i in range(0, n, batch_size):
                lo, hi, m = mine(i)
                yield ds.images[lo:hi], m
            return
        with ThreadPoolExecutor(max_workers=16) as pool:
            futs = {}

            def submit(i):
                lo, hi, _ = mine(i)
                for j in range(lo, hi):
                    futs[j] = pool.submit(ds.load, j)

            submit(0)
            for i in range(0, n, batch_size):
                if i + batch_size < n:
                    submit(i + batch_size)
                lo, hi, m = mine(i)
                rows = [futs.pop(j).result() for j in range(lo, hi)]
                yield (np.stack(rows) if rows else
                       np.zeros((0,) + ds.load(0).shape, np.uint8)), m

    return _features(model, chunks(), resize_mode, mesh)


def save_stats(path: str, mu: np.ndarray, sigma: np.ndarray,
               resize_mode: str = "torch") -> None:
    """mu/sigma npz (pytorch-fid's layout) + the preprocessing family it was
    computed with, so clean/torch stats can't be silently mixed."""
    np.savez(path, mu=mu, sigma=sigma, resize_mode=np.str_(resize_mode))


def fid_between_paths(path1: str, path2: str, model: FIDInceptionV3, *,
                      batch_size: int = 128, resolution: Optional[int] = None,
                      resize_mode: str = "torch", mesh: Optional[DataMesh] = None) -> float:
    m1, s1 = statistics_of_path(path1, model, batch_size=batch_size,
                                resolution=resolution, resize_mode=resize_mode, mesh=mesh)
    m2, s2 = statistics_of_path(path2, model, batch_size=batch_size,
                                resolution=resolution, resize_mode=resize_mode, mesh=mesh)
    return frechet_distance(m1, s1, m2, s2)
