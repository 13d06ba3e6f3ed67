"""Host-side data loading: the subset of ``diff_pruning_tpu/data/datasets.py``
that the prune, train, ldm_train, fid_score and fidelity CLIs read.

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
batches after a ``skip_batches`` fast-forward for resume; the same holds
for ``iterate_labeled_batches`` over a class-labeled folder (the LDM train
CLI's data). Image folders are decoded with PIL, as the JAX version decodes
them where its native decoder is not built (that decoder is not ported
yet: it equals PIL for images stored at the resolution, and resizes with
another filter). LSUN/FFHQ lmdb,
CIFAR-100, the ImageNet and txt-list sources and the ddpm_exp input
transforms are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from glob import glob
from typing import Iterator, Optional, Tuple

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


_OTHER_SOURCES = "is not ported yet (ROADMAP.md queue 1: the other data sources)"


def get_dataset(name_or_path: str, resolution: Optional[int] = None):
    """'<file>.npz' | a directory | 'celeba:<dir>' | 'cifar10' (looked up as
    given, then under ./data/cifar10 and ~/data/cifar10, the JAX lookup). A
    directory holding ``data.mdb`` is an LSUN lmdb; one with CIFAR-10
    batches loads them; one with ``cifar-100-python`` is CIFAR-100; else its
    image files make an :class:`ImageFolderDataset` at ``resolution``
    (default 256). An ``.npz`` or CIFAR-10 batches are used at their stored
    size. The JAX package's other sources (the prefixes ``lsun:``,
    ``ffhq:``, ``imagenet:``, ``txt:``, lmdb directories and CIFAR-100)
    raise ``NotImplementedError``."""
    if name_or_path is None:
        raise ValueError("dataset required")
    for prefix in ("lsun:", "ffhq:", "imagenet:", "txt:"):
        if name_or_path.startswith(prefix):
            raise NotImplementedError(f"{name_or_path}: the {prefix!r} source {_OTHER_SOURCES}")
    if name_or_path.startswith("celeba:"):
        files = list_image_files(name_or_path[len("celeba:"):])
        if not files:
            raise FileNotFoundError(name_or_path)
        return ImageFolderDataset(files, resolution=resolution or 64, celeba_crop=True)
    if name_or_path.endswith(".npz"):
        return load_npz(name_or_path)
    if os.path.isdir(name_or_path):
        if os.path.exists(os.path.join(name_or_path, "data.mdb")):
            raise NotImplementedError(f"{name_or_path}: an LSUN lmdb directory {_OTHER_SOURCES}")
        if glob(os.path.join(name_or_path, "*data_batch_*")) or os.path.isdir(
                os.path.join(name_or_path, "cifar-10-batches-py")):
            return load_cifar10(name_or_path)
        if os.path.isdir(os.path.join(name_or_path, "cifar-100-python")):
            raise NotImplementedError(f"{name_or_path}: CIFAR-100 {_OTHER_SOURCES}")
        files = list_image_files(name_or_path)
        if files:
            return ImageFolderDataset(files, resolution=resolution or 256)
    if "cifar100" in name_or_path.lower().replace("-", ""):
        raise NotImplementedError(f"{name_or_path}: CIFAR-100 {_OTHER_SOURCES}")
    if "cifar" in name_or_path.lower():
        for root in (name_or_path, os.path.join("data", "cifar10"),
                     os.path.expanduser(os.path.join("~", "data", "cifar10"))):
            try:
                return load_cifar10(root)
            except (FileNotFoundError, NotADirectoryError):
                continue
        raise FileNotFoundError(
            "CIFAR-10 batches not found; place cifar-10-batches-py locally "
            "(nothing is downloaded)")
    raise FileNotFoundError(f"{name_or_path}: the port reads a .npz of uint8 NHWC images, "
                            "a CIFAR-10 batch directory or an image folder")


@dataclasses.dataclass
class LabeledImageFolderDataset:
    """A class-labeled image folder (the ImageNet layout, root/<class>/*.jpg)
    for the LDM finetune path: the files, their class indices (the sorted
    class directories' order) and the class names."""

    files: list
    labels: np.ndarray
    class_names: list
    resolution: int = 256

    def __len__(self) -> int:
        return len(self.files)


def get_labeled_dataset(root: str, resolution: int = 256) -> LabeledImageFolderDataset:
    """Every image under each class directory of ``root`` (sorted, recursive),
    labeled by the directory's index among the sorted class directories."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root}")
    files, labels = [], []
    for ci, cname in enumerate(classes):
        for f in list_image_files(os.path.join(root, cname)):
            files.append(f)
            labels.append(ci)
    return LabeledImageFolderDataset(files, np.asarray(labels, np.int32), classes, resolution)


def iterate_labeled_batches(dataset: LabeledImageFolderDataset, batch_size: int, *,
                            seed: int = 0, flip: bool = True, skip_batches: int = 0,
                            local_slice: Optional[Tuple[int, int]] = None):
    """Endless shuffled epochs of ``(images, labels)``: NHWC float32 images in
    [-1, 1] at the dataset's resolution with a random horizontal flip, int32
    labels; the last partial batch of each epoch dropped. One
    ``default_rng(seed)`` draws a permutation per epoch and, per batch, the
    flips, as the JAX version draws them, so the batches are bit-identical
    to its own for the same seed. ``skip_batches`` fast-forwards for resume:
    the skipped batches' draws are replayed without decoding an image.

    Images are decoded one by one with PIL (``_load_image``: shorter side to
    the resolution, then a center crop), the JAX version's path when its
    native decoder is not built.

    ``local_slice=(lo, hi)`` yields rows [lo, hi) of each global batch (a
    data-parallel rank's, ``parallel.mesh.process_batch_slice``): the
    shuffle and flip draws stay at the global batch shape, so the rows are
    bit-exactly the single-process stream's, and only they are decoded."""
    rng = np.random.default_rng(seed)
    n = len(dataset)
    rows = slice(None) if local_slice is None else slice(*local_slice)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - n % batch_size, batch_size):
            idx = order[i:i + batch_size]
            if skip_batches > 0:
                skip_batches -= 1
                if flip:
                    rng.random(len(idx))  # keep the flip stream aligned
                continue
            idx = idx[rows]
            imgs = np.stack([_load_image(dataset.files[j], dataset.resolution, False)
                             for j in idx])
            if flip:
                flips = (rng.random(batch_size) < 0.5)[rows]
                imgs[flips] = imgs[flips, :, ::-1]
            yield normalize(imgs), dataset.labels[idx]


def normalize(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1] (Normalize(0.5,0.5))."""
    return batch_u8.astype(np.float32) / 127.5 - 1.0


def iterate_batches(dataset, batch_size: int, *, seed: int = 0, skip_batches: int = 0,
                    local_slice: Optional[Tuple[int, int]] = None) -> Iterator[np.ndarray]:
    """Endless shuffled epochs of normalized NHWC float32 batches with random
    horizontal flip, the last partial batch of each epoch dropped (the JAX
    version's plain path with its defaults: one permutation per epoch, then
    one flip draw per batch, from one ``default_rng(seed)``), from an
    :class:`ArrayDataset` or an :class:`ImageFolderDataset` (decoded image
    by image with :meth:`ImageFolderDataset.load`).

    ``skip_batches`` fast-forwards the stream for resume: the skipped
    batches' shuffle and flip draws are replayed without touching pixels, so
    a resumed run sees exactly the batches an uninterrupted run would.

    ``local_slice=(lo, hi)`` yields rows [lo, hi) of each global batch (the
    JAX version's multi-host path): every draw stays at the global batch
    shape, so the rows are bit-exactly the single-process stream's, and only
    they are gathered or decoded."""
    if not isinstance(dataset, (ArrayDataset, ImageFolderDataset)):
        raise TypeError(f"{type(dataset).__name__}: batches come from an ArrayDataset or an "
                        "ImageFolderDataset")
    rng = np.random.default_rng(seed)
    n = len(dataset)
    rows = slice(None) if local_slice is None else slice(*local_slice)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - n % batch_size, batch_size):
            idx = order[i:i + batch_size]
            flips = rng.random(len(idx)) < 0.5
            if skip_batches > 0:
                skip_batches -= 1
                continue
            idx, flips = idx[rows], flips[rows]
            if isinstance(dataset, ArrayDataset):
                imgs = dataset.images[idx].copy()
            else:
                imgs = np.stack([dataset.load(j) for j in idx])
            imgs[flips] = imgs[flips, :, ::-1]
            yield normalize(imgs)
