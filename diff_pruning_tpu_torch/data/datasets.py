"""Host-side data loading: the subset of ``diff_pruning_tpu/data/datasets.py``
that the prune, train, fid_score and fidelity CLIs read.

numpy and PIL only, as the JAX package's loaders are: a local ``.npz`` of
uint8 NHWC images, a local CIFAR-10 python-pickle batch directory
(``cifar-10-batches-py``), or a recursive image folder (plain, or with
the ``celeba:`` prefix's center crop); nothing is downloaded.
:func:`get_dataset` tests a directory in the JAX order (lmdb, CIFAR-10,
CIFAR-100, image files) and gives a folder the JAX defaults, 256 pixels
(64 with ``celeba:``) where ``resolution`` is None, so a folder reaches the
Inception at the size it does there. ``iterate_batches`` is the plain path
of the JAX version (shuffle, random horizontal flip, [-1, 1]), drawing from
the same ``np.random.default_rng(seed)`` in the same order, so its batches
are bit-identical to the JAX package's for the same seed, and so are the
batches after a ``skip_batches`` fast-forward for resume. LSUN/FFHQ lmdb,
CIFAR-100, the ImageNet and txt-list sources and the ddpm_exp input
transforms are not ported yet.
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


IMG_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp", ".JPEG", ".PNG", ".JPG")


def list_image_files(root: str) -> list:
    files = []
    for ext in IMG_EXTS:
        files.extend(glob(os.path.join(root, "**", f"*{ext}"), recursive=True))
    return sorted(set(files))


def _load_image(path: str, resolution: Optional[int], celeba_crop: bool) -> np.ndarray:
    from PIL import Image

    im = Image.open(path).convert("RGB")
    if celeba_crop:
        # the DDIM codebase's CelebA recipe: a 128x128 window around
        # (cx=89, cy=121), then the resize
        cx, cy = 89, 121
        x1, x2, y1, y2 = cy - 64, cy + 64, cx - 64, cx + 64
        im = im.crop((y1, x1, y2, x2))
    if resolution is not None and im.size != (resolution, resolution):
        # shorter side to ``resolution`` (PIL's default filter), then a center crop
        w, h = im.size
        s = resolution / min(w, h)
        im = im.resize((max(resolution, round(w * s)), max(resolution, round(h * s))))
        w, h = im.size
        left, top = (w - resolution) // 2, (h - resolution) // 2
        im = im.crop((left, top, left + resolution, top + resolution))
    return np.asarray(im, np.uint8)


@dataclasses.dataclass
class ImageFolderDataset:
    """Recursive unlabeled image folder, decoded one image at a time by
    :meth:`load` (uint8 HWC)."""

    files: list
    resolution: Optional[int] = None
    celeba_crop: bool = False

    def __len__(self) -> int:
        return len(self.files)

    def load(self, idx: int) -> np.ndarray:
        return _load_image(self.files[idx], self.resolution, self.celeba_crop)


def get_dataset(name_or_path: str, resolution: Optional[int] = None):
    """'<file>.npz' | a directory | 'celeba:<dir>' | 'cifar10' (looked up under
    ./data/cifar10). A directory holding ``data.mdb`` is an LSUN lmdb
    (raises: not ported yet); one with CIFAR-10 batches loads them; one with
    ``cifar-100-python`` raises (not ported yet); else its image files make
    an :class:`ImageFolderDataset` at ``resolution`` (default 256). An
    ``.npz`` or CIFAR-10 batches are used at their stored size."""
    if name_or_path is None:
        raise ValueError("dataset required")
    if name_or_path.startswith("celeba:"):
        files = list_image_files(name_or_path[len("celeba:"):])
        if not files:
            raise FileNotFoundError(name_or_path)
        return ImageFolderDataset(files, resolution=resolution or 64, celeba_crop=True)
    if name_or_path.endswith(".npz"):
        return load_npz(name_or_path)
    if os.path.isdir(name_or_path):
        if os.path.exists(os.path.join(name_or_path, "data.mdb")):
            raise NotImplementedError(f"{name_or_path}: LSUN lmdb directories are not ported "
                                      "yet (ROADMAP.md queue 1: the other data sources)")
        if glob(os.path.join(name_or_path, "*data_batch_*")) or os.path.isdir(
                os.path.join(name_or_path, "cifar-10-batches-py")):
            return load_cifar10(name_or_path)
        if os.path.isdir(os.path.join(name_or_path, "cifar-100-python")):
            raise NotImplementedError(f"{name_or_path}: CIFAR-100 is not ported yet "
                                      "(ROADMAP.md queue 1: the other data sources)")
        files = list_image_files(name_or_path)
        if files:
            return ImageFolderDataset(files, resolution=resolution or 256)
    if "cifar" in name_or_path.lower() and "100" not in name_or_path:
        for root in (name_or_path, os.path.join("data", "cifar10")):
            try:
                return load_cifar10(root)
            except (FileNotFoundError, NotADirectoryError):
                continue
        raise FileNotFoundError(
            "CIFAR-10 batches not found; place cifar-10-batches-py locally "
            "(nothing is downloaded)")
    raise FileNotFoundError(f"{name_or_path}: the port reads a .npz of uint8 NHWC images, "
                            "a CIFAR-10 batch directory or an image folder")


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
    a resumed run sees exactly the batches an uninterrupted run would.
    Only in-memory datasets are batched here: an image folder raises."""
    if not isinstance(dataset, ArrayDataset):
        raise NotImplementedError(f"{type(dataset).__name__}: training batches come from a .npz "
                                  "or CIFAR-10 batches (image folders are read only by the "
                                  "evaluation path)")
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
