"""Host-side data loading: the subset of ``diff_pruning_tpu/data/datasets.py``
that the prune and train CLIs read.

numpy only, as the JAX package's loaders are: a local ``.npz`` of uint8
NHWC images, or a local CIFAR-10 python-pickle batch directory
(``cifar-10-batches-py``); nothing is downloaded. ``iterate_batches`` is the
plain path of the JAX version (shuffle, random horizontal flip, [-1, 1]),
drawing from the same ``np.random.default_rng(seed)`` in the same order, so
its batches are bit-identical to the JAX package's for the same seed, and
so are the batches after a ``skip_batches`` fast-forward for resume.
Image folders, LSUN/FFHQ lmdb, CIFAR-100 and the ddpm_exp input transforms
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from glob import glob
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    """In-memory uint8 NHWC images."""

    images: np.ndarray  # (N,H,W,C) uint8

    def __len__(self) -> int:
        return len(self.images)


def load_cifar10(root: str) -> ArrayDataset:
    """Load CIFAR-10 from the standard python-pickle batch directory.

    The batches are pickles, so point this only at a CIFAR-10 download you
    trust."""
    d = root
    if os.path.isdir(os.path.join(root, "cifar-10-batches-py")):
        d = os.path.join(root, "cifar-10-batches-py")
    batches = sorted(glob(os.path.join(d, "data_batch_*")))
    if not batches:
        raise FileNotFoundError(f"no CIFAR-10 batches under {root}")
    imgs = []
    for b in batches:
        with open(b, "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        arr = np.asarray(entry["data"], np.uint8).reshape(-1, 3, 32, 32)
        imgs.append(arr.transpose(0, 2, 3, 1))
    return ArrayDataset(np.concatenate(imgs))


def load_npz(path: str) -> ArrayDataset:
    """The ``images`` array of a ``.npz`` (else its first array)."""
    with np.load(path) as z:
        arr = z["images"] if "images" in z.files else z[z.files[0]]
    return ArrayDataset(np.asarray(arr, np.uint8))


def get_dataset(name_or_path: str, resolution: Optional[int] = None) -> ArrayDataset:
    """'<file>.npz' | a CIFAR-10 batch directory | 'cifar10' (looked up under
    ./data/cifar10). Images are used at their stored size: ``resolution``
    is accepted for the JAX call's signature, which reads it only for image
    folders and lmdb sources (not ported yet)."""
    del resolution
    if name_or_path is None:
        raise ValueError("dataset required")
    if name_or_path.endswith(".npz"):
        return load_npz(name_or_path)
    if os.path.isdir(name_or_path):
        return load_cifar10(name_or_path)
    if "cifar" in name_or_path.lower() and "100" not in name_or_path:
        for root in (name_or_path, os.path.join("data", "cifar10")):
            try:
                return load_cifar10(root)
            except (FileNotFoundError, NotADirectoryError):
                continue
        raise FileNotFoundError(
            "CIFAR-10 batches not found; place cifar-10-batches-py locally "
            "(nothing is downloaded)")
    raise FileNotFoundError(f"{name_or_path}: the port reads a .npz of uint8 NHWC images "
                            "or a CIFAR-10 batch directory")


def normalize(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1] (Normalize(0.5,0.5))."""
    return batch_u8.astype(np.float32) / 127.5 - 1.0


def iterate_batches(dataset: ArrayDataset, batch_size: int, *, seed: int = 0,
                    skip_batches: int = 0) -> Iterator[np.ndarray]:
    """Endless shuffled epochs of normalized NHWC float32 batches with random
    horizontal flip, the last partial batch of each epoch dropped (the JAX
    version's plain path with its defaults: one permutation per epoch, then
    one flip draw per batch, from one ``default_rng(seed)``).

    ``skip_batches`` fast-forwards the stream for resume: the skipped
    batches' shuffle and flip draws are replayed without touching pixels, so
    a resumed run sees exactly the batches an uninterrupted run would."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - n % batch_size, batch_size):
            idx = order[i:i + batch_size]
            flips = rng.random(len(idx)) < 0.5
            if skip_batches > 0:
                skip_batches -= 1
                continue
            imgs = dataset.images[idx].copy()
            imgs[flips] = imgs[flips, :, ::-1]
            yield normalize(imgs)
