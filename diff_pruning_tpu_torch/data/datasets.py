"""Host-side data loading (counterpart of ``diff_pruning_tpu/data/datasets.py``).

numpy and PIL only, as the JAX package's loaders are; nothing is
downloaded. Sources (:func:`get_dataset`): a local ``.npz`` of uint8 NHWC
images; CIFAR-10 (``cifar-10-batches-py``) and CIFAR-100
(``cifar-100-python``'s ``train`` pickle); a recursive image folder (plain,
or with the ``celeba:`` prefix's center crop); an LSUN lmdb category
database (``lsun:<dir>``, or a directory holding ``data.mdb``; resize and
center crop as torchvision's) and an FFHQ lmdb (``ffhq:<dir>``), both read
by the pure-Python ``data/lmdb_io.py``; ``imagenet:<root>`` and
``txt:<filelist>:<data_root>`` (``data/ldm_datasets.py``). A directory is
tested in the JAX order (lmdb, CIFAR-10, CIFAR-100, image files), and a
folder or lmdb gets the JAX defaults, 256 pixels (64 with ``celeba:``),
where ``resolution`` is None.

``iterate_batches`` draws from one ``np.random.default_rng(seed)`` in the
JAX version's order (a permutation per epoch, then one flip draw per
batch), so its batches are bit-identical to the JAX package's for the same
seed, also after a ``skip_batches`` fast-forward for resume; so are
``iterate_labeled_batches``' over a class-labeled folder (the LDM train
CLI's data). ``transform`` selects the DDIM codebase's input transforms
(:func:`data_transform`: logit, uniform or Gaussian dequantization) in
place of the plain [-1, 1]. Images are decoded with PIL, as the JAX version
decodes them where its native decoder is not built (that decoder is not
ported: it equals PIL for images stored at the resolution, and resizes with
another filter).
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


def load_cifar100(root: str) -> ArrayDataset:
    """CIFAR-100's python-pickle ``train`` file (a pickle: point this only at
    a download you trust)."""
    d = root
    if os.path.isdir(os.path.join(root, "cifar-100-python")):
        d = os.path.join(root, "cifar-100-python")
    f = os.path.join(d, "train")
    if not os.path.exists(f):
        raise FileNotFoundError(f"no CIFAR-100 'train' pickle under {root}")
    with open(f, "rb") as fh:
        entry = pickle.load(fh, encoding="latin1")
    arr = np.asarray(entry["data"], np.uint8).reshape(-1, 3, 32, 32)
    return ArrayDataset(arr.transpose(0, 2, 3, 1))


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


def _resize_center_crop(im, resolution: int):
    """torchvision's ``Resize(s)`` (shorter side, BILINEAR, the long side
    ``int(s * long / short)``) then ``CenterCrop(s)`` (offsets
    ``int(round((dim - s) / 2))``): the LSUN pipeline of the DDIM codebase."""
    from PIL import Image

    w, h = im.size
    if (w, h) != (resolution, resolution):
        if w <= h:
            new_w, new_h = resolution, int(resolution * h / w)
        else:
            new_w, new_h = int(resolution * w / h), resolution
        im = im.resize((new_w, new_h), Image.BILINEAR)
        w, h = im.size
        left = int(round((w - resolution) / 2.0))
        top = int(round((h - resolution) / 2.0))
        im = im.crop((left, top, left + resolution, top + resolution))
    return im


class LSUNDataset:
    """An LSUN lmdb category database: encoded (webp) images under md5 keys,
    in key order, resized and center-cropped to ``resolution``."""

    def __init__(self, root: str, resolution: int = 256):
        from .lmdb_io import LMDBReader

        self.db = LMDBReader(root)
        self.keys = self.db.keys()
        self.resolution = resolution

    def __len__(self) -> int:
        return len(self.keys)

    def load(self, idx: int) -> np.ndarray:
        import io

        from PIL import Image

        im = Image.open(io.BytesIO(self.db.get(self.keys[idx]))).convert("RGB")
        return np.asarray(_resize_center_crop(im, self.resolution), np.uint8)


class FFHQDataset:
    """An FFHQ lmdb: its length under the key ``length``, image ``i`` under
    ``f'{resolution}-{i:05d}'``, stored at the resolution."""

    def __init__(self, root: str, resolution: int = 256):
        from .lmdb_io import LMDBReader

        self.db = LMDBReader(root)
        raw = self.db.get(b"length")
        if raw is None:
            raise FileNotFoundError(f"{root}: no 'length' key (not FFHQ-layout)")
        self.length = int(raw.decode())
        self.resolution = resolution

    def __len__(self) -> int:
        return self.length

    def load(self, idx: int) -> np.ndarray:
        import io

        from PIL import Image

        key = f"{self.resolution}-{str(idx).zfill(5)}".encode()
        raw = self.db.get(key)
        if raw is None:
            raise KeyError(f"FFHQ key {key!r} missing")
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"), np.uint8)


def get_dataset(name_or_path: str, resolution: Optional[int] = None):
    """'<file>.npz' | a directory | 'celeba:<dir>' | 'lsun:<lmdb dir>' |
    'ffhq:<lmdb dir>' | 'imagenet:<root>' | 'txt:<filelist>:<data_root>' |
    'cifar10' or 'cifar100' (looked up as given, then under ./data/cifar10
    (cifar100) and ~/data/cifar10 (cifar100), the JAX lookup). A directory
    holding ``data.mdb`` is an LSUN lmdb; one with CIFAR-10 batches loads
    them; one with ``cifar-100-python`` is CIFAR-100; else its image files
    make an :class:`ImageFolderDataset`. Folders, lmdbs, ImageNet and txt
    lists come at ``resolution`` (default 256; 64 with ``celeba:``); an
    ``.npz`` and CIFAR at their stored size. The txt list's flip is left to
    :func:`iterate_batches`."""
    if name_or_path is None:
        raise ValueError("dataset required")
    if name_or_path.startswith("celeba:"):
        files = list_image_files(name_or_path[len("celeba:"):])
        if not files:
            raise FileNotFoundError(name_or_path)
        return ImageFolderDataset(files, resolution=resolution or 64, celeba_crop=True)
    if name_or_path.startswith("lsun:"):
        return LSUNDataset(name_or_path[len("lsun:"):], resolution=resolution or 256)
    if name_or_path.startswith("ffhq:"):
        return FFHQDataset(name_or_path[len("ffhq:"):], resolution=resolution or 256)
    if name_or_path.startswith("imagenet:"):
        from .ldm_datasets import ImageNetDataset

        return ImageNetDataset(name_or_path[len("imagenet:"):], size=resolution or 256)
    if name_or_path.startswith("txt:"):
        from .ldm_datasets import TxtListDataset

        _, txt, root = name_or_path.split(":", 2)
        return TxtListDataset(txt, root, size=resolution or 256, flip_p=0.0)
    if name_or_path.endswith(".npz"):
        return load_npz(name_or_path)
    if os.path.isdir(name_or_path):
        if os.path.exists(os.path.join(name_or_path, "data.mdb")):
            return LSUNDataset(name_or_path, resolution=resolution or 256)
        if glob(os.path.join(name_or_path, "*data_batch_*")) or os.path.isdir(
                os.path.join(name_or_path, "cifar-10-batches-py")):
            return load_cifar10(name_or_path)
        if os.path.isdir(os.path.join(name_or_path, "cifar-100-python")):
            return load_cifar100(name_or_path)
        files = list_image_files(name_or_path)
        if files:
            return ImageFolderDataset(files, resolution=resolution or 256)
    if "cifar100" in name_or_path.lower().replace("-", ""):
        for root in (name_or_path, os.path.join("data", "cifar100"),
                     os.path.expanduser(os.path.join("~", "data", "cifar100"))):
            try:
                return load_cifar100(root)
            except (FileNotFoundError, NotADirectoryError):
                continue
        raise FileNotFoundError(
            "CIFAR-100 'train' pickle not found; place cifar-100-python locally "
            "(nothing is downloaded)")
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
    raise FileNotFoundError(name_or_path)


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


def logit_transform(x01: np.ndarray, lam: float = 1e-6) -> np.ndarray:
    """The DDIM codebase's logit transform, the input clamped to [0, 1] first
    (dequantization noise can leave the domain, where the log gives NaN; in
    the domain the values are those of the unclamped formula)."""
    x = lam + (1.0 - 2.0 * lam) * np.clip(x01, 0.0, 1.0)
    return np.log(x) - np.log1p(-x)


def data_transform(x01: np.ndarray, *, uniform_dequantization: bool = False,
                   gaussian_dequantization: bool = False, rescaled: bool = True,
                   logit: bool = False, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The DDIM codebase's input transforms, in its order, on [0, 1] float32
    images: uniform dequantization (x * 255/256 + U[0, 1/256)), Gaussian
    dequantization (+ 0.01 N(0, 1)), then logit, or 2x - 1 when ``rescaled``.
    The noise comes from ``rng`` (default ``default_rng(0)``)."""
    x = x01.astype(np.float32)
    if uniform_dequantization:
        rng = rng or np.random.default_rng(0)
        x = x / 256.0 * 255.0 + rng.random(x.shape, np.float32) / 256.0
    if gaussian_dequantization:
        rng = rng or np.random.default_rng(0)
        x = x + rng.standard_normal(x.shape, np.float32) * 0.01
    if logit:
        return logit_transform(x)
    if rescaled:
        return 2.0 * x - 1.0
    return x


def inverse_data_transform(x: np.ndarray, *, rescaled: bool = True,
                           logit: bool = False) -> np.ndarray:
    """Undoes :func:`data_transform` (sigmoid, or (x + 1) / 2), clamped to [0, 1]."""
    if logit:
        x = 1.0 / (1.0 + np.exp(-x))
    elif rescaled:
        x = (x + 1.0) / 2.0
    return np.clip(x, 0.0, 1.0)


def _parse_transform(name: Optional[str]) -> dict:
    """:func:`data_transform`'s flags from a name: 'rescaled' (the default) or
    'logit', with '+udq' / '+gdq' for uniform / Gaussian dequantization,
    e.g. 'logit+udq'."""
    kw = dict(uniform_dequantization=False, gaussian_dequantization=False, rescaled=True,
              logit=False)
    if not name:
        return kw
    for part in name.split("+"):
        if part == "logit":
            kw["logit"], kw["rescaled"] = True, False
        elif part in ("rescaled", ""):
            pass
        elif part == "udq":
            kw["uniform_dequantization"] = True
        elif part == "gdq":
            kw["gaussian_dequantization"] = True
        else:
            raise ValueError(f"unknown transform component {part!r} in {name!r}")
    return kw


def iterate_batches(dataset, batch_size: int, *, seed: int = 0, skip_batches: int = 0,
                    local_slice: Optional[Tuple[int, int]] = None,
                    transform: Optional[str] = None,
                    dequant_seed: Optional[int] = None) -> Iterator[np.ndarray]:
    """Endless shuffled epochs of NHWC float32 batches with random horizontal
    flip, the last partial batch of each epoch dropped (the JAX version with
    its defaults: one permutation per epoch, then one flip draw per batch,
    from one ``default_rng(seed)``), from an :class:`ArrayDataset` or any
    dataset that decodes image ``i`` with ``load(i)`` (uint8 HWC).

    Images map to [-1, 1], or with ``transform`` (:func:`_parse_transform`'s
    names) through :func:`data_transform`, its dequantization noise drawn
    from ``default_rng(dequant_seed)`` (default ``seed + 1``).

    ``skip_batches`` fast-forwards the stream for resume: the skipped
    batches' shuffle, flip and dequantization draws are replayed without
    decoding, so a resumed run sees exactly the batches an uninterrupted run
    would.

    ``local_slice=(lo, hi)`` yields rows [lo, hi) of each global batch (the
    JAX version's multi-host path): every draw stays at the global batch
    shape, so the rows are bit-exactly the single-process stream's; only
    they are gathered or decoded, except under a transform, whose noise
    needs the whole batch."""
    if not (isinstance(dataset, ArrayDataset) or hasattr(dataset, "load")):
        raise TypeError(f"{type(dataset).__name__}: batches come from an ArrayDataset or a "
                        "dataset with load(i)")
    rng = np.random.default_rng(seed)
    n = len(dataset)
    rows = slice(None) if local_slice is None else slice(*local_slice)
    tkw = _parse_transform(transform)
    plain = not (tkw["logit"] or tkw["uniform_dequantization"]
                 or tkw["gaussian_dequantization"])
    trng = np.random.default_rng(seed + 1 if dequant_seed is None else dequant_seed)
    img_shape = None
    if not plain and skip_batches > 0:
        img_shape = (dataset.images.shape[1:] if isinstance(dataset, ArrayDataset)
                     else np.asarray(dataset.load(0)).shape)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - n % batch_size, batch_size):
            idx = order[i:i + batch_size]
            flips = rng.random(len(idx)) < 0.5
            if skip_batches > 0:
                skip_batches -= 1
                shape = (len(idx),) + tuple(img_shape or ())
                if tkw["uniform_dequantization"]:
                    trng.random(shape, np.float32)
                if tkw["gaussian_dequantization"]:
                    trng.standard_normal(shape, np.float32)
                continue
            if plain:
                idx, flips = idx[rows], flips[rows]
            if isinstance(dataset, ArrayDataset):
                imgs = dataset.images[idx].copy()
            else:
                imgs = np.stack([dataset.load(j) for j in idx])
            imgs[flips] = imgs[flips, :, ::-1]
            if plain:
                yield normalize(imgs)
            else:
                yield data_transform(imgs.astype(np.float32) / 255.0, rng=trng, **tkw)[rows]
