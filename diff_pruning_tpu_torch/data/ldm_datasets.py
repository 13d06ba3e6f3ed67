"""The LDM codebase's dataset classes (counterpart of
``diff_pruning_tpu/data/ldm_datasets.py``): ImageNet's synset/index files and
the LSUN txt lists, and the config targets that name them
(``ldm.data.imagenet.ImageNetTrain``, ``ldm.data.lsun.LSUNChurchesTrain``, ...).

* ImageNet: a root with ``data/`` (synset folders of JPEGs) and
  ``filelist.txt`` (relative paths; written from ``data/`` when absent), an
  optional ``index_synset.yaml`` (class index -> synset; read with ``yaml``,
  imported only when a class subset or the original labels ask for it) and
  ``synset_human.txt`` (synset -> human label). ``sub_indices`` filters the
  classes as taming's ``str_to_indices``/``give_synsets_from_indices`` do.
* LSUN: a txt filelist and a data root; a square center crop, a PIL resize,
  a random horizontal flip with probability ``flip_p``.

Nothing is downloaded: a file the LDM codebase would fetch must exist
locally, else the constructor raises saying which.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

# the one corrupt file the LDM codebase always skips
IGNORE_FILES = {"n06596364_9591.JPEG"}


def str_to_indices(string: str) -> List[int]:
    """'32-123, 256, 280-321' -> sorted ints; ranges end-exclusive (taming's
    ``str_to_indices``)."""
    assert not string.endswith(","), f"provided string '{string}' ends with a comma"
    indices: List[int] = []
    for sub in string.split(","):
        parts = sub.strip().split("-")
        if len(parts) == 1:
            indices.append(int(parts[0]))
        else:
            indices.extend(range(int(parts[0]), int(parts[1])))
    return sorted(indices)


def load_index_synset(path_to_yaml: str) -> Dict[int, str]:
    """index_synset.yaml: {class index: synset id}."""
    import yaml

    with open(path_to_yaml) as f:
        return dict(yaml.safe_load(f))


def give_synsets_from_indices(indices: Sequence[int], path_to_yaml: str) -> List[str]:
    """Class indices -> synset ids via index_synset.yaml (taming's helper)."""
    di2s = load_index_synset(path_to_yaml)
    return [di2s[idx] for idx in indices]


def synset2idx(path_to_yaml: str) -> Dict[str, int]:
    """The inverse of the index -> synset map."""
    return {v: k for k, v in load_index_synset(path_to_yaml).items()}


def _smallest_side_resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """taming's ImagePaths preprocessing: the smallest side resized to
    ``size`` (bicubic), then a center crop."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = size / min(h, w)
    nh, nw = max(size, round(h * scale)), max(size, round(w * scale))
    im = Image.fromarray(img).resize((nw, nh), resample=Image.BICUBIC)
    arr = np.asarray(im, np.uint8)
    top, left = (nh - size) // 2, (nw - size) // 2
    return arr[top:top + size, left:left + size]


class ImageNetDataset:
    """The LDM codebase's ImageNetBase.

    ``root`` must contain ``data/<synset>/*.JPEG``; ``filelist.txt`` is
    written from it when absent. ``sub_indices`` filters to a class subset
    (needs ``index_synset.yaml`` in root). ``keep_orig_class_label`` uses the
    yaml's global indices instead of the dense re-enumeration."""

    def __init__(self, root: str, *, size: int = 256, random_crop: bool = False,
                 sub_indices: Optional[str] = None,
                 keep_orig_class_label: bool = False, seed: int = 0):
        self.root = root
        self.datadir = os.path.join(root, "data")
        self.size = size
        self.random_crop = random_crop
        self.seed = seed
        if not os.path.isdir(self.datadir):
            raise FileNotFoundError(
                f"{self.datadir} not found: place the extracted ImageNet "
                "synset folders there (nothing is downloaded)")
        filelist = os.path.join(root, "filelist.txt")
        if not os.path.exists(filelist):
            rels = sorted(
                os.path.relpath(p, self.datadir)
                for ext in ("*.JPEG", "*.jpeg", "*.jpg", "*.png")
                for p in glob(os.path.join(self.datadir, "**", ext),
                              recursive=True))
            with open(filelist, "w") as f:
                f.write("\n".join(rels) + "\n")
        with open(filelist) as f:
            relpaths = [l for l in f.read().splitlines() if l]
        relpaths = [p for p in relpaths
                    if os.path.basename(p) not in IGNORE_FILES]
        if sub_indices:
            idx_yaml = os.path.join(root, "index_synset.yaml")
            if not os.path.exists(idx_yaml):
                raise FileNotFoundError(
                    f"{idx_yaml} required for sub_indices (nothing is "
                    "downloaded; provide it locally)")
            synsets = set(give_synsets_from_indices(
                str_to_indices(sub_indices), idx_yaml))
            self.synset2idx = synset2idx(idx_yaml)
            relpaths = [p for p in relpaths if p.split("/")[0] in synsets]
        self.relpaths = relpaths
        self.synsets = [p.split("/")[0] for p in relpaths]
        self.abspaths = [os.path.join(self.datadir, p) for p in relpaths]
        unique = sorted(set(self.synsets))
        dense = {s: i for i, s in enumerate(unique)}
        if keep_orig_class_label:
            if sub_indices is None:
                idx_yaml = os.path.join(root, "index_synset.yaml")
                self.synset2idx = synset2idx(idx_yaml)
            self.class_labels = [self.synset2idx[s] for s in self.synsets]
        else:
            self.class_labels = [dense[s] for s in self.synsets]
        self.class_names = unique
        # human labels are optional (synset_human.txt may be absent locally)
        human_path = os.path.join(root, "synset_human.txt")
        self.human_labels = None
        if os.path.exists(human_path):
            with open(human_path) as f:
                hd = dict(line.split(maxsplit=1)
                          for line in f.read().splitlines() if line)
            self.human_labels = [hd.get(s, s) for s in self.synsets]

    def __len__(self) -> int:
        return len(self.relpaths)

    def load(self, i: int) -> np.ndarray:
        """uint8 (size, size, 3) — smallest-side resize + crop."""
        from PIL import Image

        img = np.asarray(Image.open(self.abspaths[i]).convert("RGB"), np.uint8)
        if self.random_crop:
            h, w = img.shape[:2]
            scale = self.size / min(h, w)
            nh, nw = max(self.size, round(h * scale)), max(self.size, round(w * scale))
            im = Image.fromarray(img).resize((nw, nh), resample=Image.BICUBIC)
            arr = np.asarray(im, np.uint8)
            # a generator per item: deterministic whatever the load order,
            # and safe under threaded decode pools
            rng = np.random.default_rng((self.seed, i))
            top = int(rng.integers(0, nh - self.size + 1))
            left = int(rng.integers(0, nw - self.size + 1))
            return arr[top:top + self.size, left:left + self.size]
        return _smallest_side_resize_center_crop(img, self.size)

    def __getitem__(self, i: int) -> Dict:
        ex = {
            "image": (self.load(i).astype(np.float32) / 127.5 - 1.0),
            "relpath": self.relpaths[i],
            "synsets": self.synsets[i],
            "class_label": self.class_labels[i],
        }
        if self.human_labels is not None:
            ex["human_label"] = self.human_labels[i]
        return ex


def imagenet_train(data_root: Optional[str] = None, **kw) -> ImageNetDataset:
    """ImageNetTrain: random_crop defaults True."""
    kw.setdefault("random_crop", True)
    return ImageNetDataset(_imagenet_root("ILSVRC2012_train", data_root), **kw)


def imagenet_validation(data_root: Optional[str] = None, **kw) -> ImageNetDataset:
    """ImageNetValidation: random_crop defaults False."""
    kw.setdefault("random_crop", False)
    return ImageNetDataset(_imagenet_root("ILSVRC2012_validation", data_root), **kw)


def _imagenet_root(name: str, data_root: Optional[str]) -> str:
    if data_root:
        return os.path.join(data_root, name)
    cachedir = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(cachedir, "autoencoders/data", name)


_PIL_INTERP = {"linear": "BILINEAR", "bilinear": "BILINEAR",
               "bicubic": "BICUBIC", "lanczos": "LANCZOS"}


class TxtListDataset:
    """The LDM codebase's LSUNBase: a txt filelist and a data root; a square
    center crop, a PIL resize, a random horizontal flip with probability
    ``flip_p``, drawn per item from ``default_rng((seed, i))``."""

    def __init__(self, txt_file: str, data_root: str, *,
                 size: Optional[int] = None, interpolation: str = "bicubic",
                 flip_p: float = 0.5, seed: int = 0):
        if not os.path.exists(txt_file):
            raise FileNotFoundError(
                f"{txt_file} not found (LSUN txt filelists come with the "
                "dataset; nothing is downloaded)")
        with open(txt_file) as f:
            self.image_paths = [l for l in f.read().splitlines() if l]
        self.data_root = data_root
        self.size = size
        if interpolation not in _PIL_INTERP:
            raise ValueError(f"unknown interpolation {interpolation!r}")
        self.interpolation = interpolation
        self.flip_p = flip_p
        self.seed = seed

    def __len__(self) -> int:
        return len(self.image_paths)

    def load(self, i: int, *, flip: Optional[bool] = None) -> np.ndarray:
        from PIL import Image

        img = np.asarray(
            Image.open(os.path.join(self.data_root, self.image_paths[i]))
            .convert("RGB"), np.uint8)
        h, w = img.shape[:2]
        crop = min(h, w)  # the square center crop
        img = img[(h - crop) // 2:(h + crop) // 2,
                  (w - crop) // 2:(w + crop) // 2]
        if self.size is not None:
            resample = getattr(Image, _PIL_INTERP[self.interpolation])
            img = np.asarray(Image.fromarray(img).resize(
                (self.size, self.size), resample=resample), np.uint8)
        if flip is None:
            # a generator per item (order-independent, thread-safe)
            flip = np.random.default_rng((self.seed, i)).random() < self.flip_p
        if flip:
            img = img[:, ::-1]
        return np.ascontiguousarray(img)

    def __getitem__(self, i: int) -> Dict:
        return {
            "image": self.load(i).astype(np.float32) / 127.5 - 1.0,
            "relative_file_path_": self.image_paths[i],
            "file_path_": os.path.join(self.data_root, self.image_paths[i]),
        }


def _lsun(txt, root, flip_p, **kw):
    kw.setdefault("flip_p", flip_p)
    return TxtListDataset(txt, root, **kw)


# the six named LSUN config targets with their canonical paths
def lsun_churches_train(**kw):
    return _lsun("data/lsun/church_outdoor_train.txt", "data/lsun/churches", 0.5, **kw)


def lsun_churches_validation(**kw):
    return _lsun("data/lsun/church_outdoor_val.txt", "data/lsun/churches", 0.0, **kw)


def lsun_bedrooms_train(**kw):
    return _lsun("data/lsun/bedrooms_train.txt", "data/lsun/bedrooms", 0.5, **kw)


def lsun_bedrooms_validation(**kw):
    return _lsun("data/lsun/bedrooms_val.txt", "data/lsun/bedrooms", 0.0, **kw)


def lsun_cats_train(**kw):
    return _lsun("data/lsun/cat_train.txt", "data/lsun/cats", 0.5, **kw)


def lsun_cats_validation(**kw):
    return _lsun("data/lsun/cat_val.txt", "data/lsun/cats", 0.0, **kw)


# config target name -> constructor, so the LDM yamls' data stanzas resolve
# through this table
CONFIG_TARGETS = {
    "ldm.data.imagenet.ImageNetTrain": imagenet_train,
    "ldm.data.imagenet.ImageNetValidation": imagenet_validation,
    "ldm.data.lsun.LSUNChurchesTrain": lsun_churches_train,
    "ldm.data.lsun.LSUNChurchesValidation": lsun_churches_validation,
    "ldm.data.lsun.LSUNBedroomsTrain": lsun_bedrooms_train,
    "ldm.data.lsun.LSUNBedroomsValidation": lsun_bedrooms_validation,
    "ldm.data.lsun.LSUNCatsTrain": lsun_cats_train,
    "ldm.data.lsun.LSUNCatsValidation": lsun_cats_validation,
}


def dataset_from_config_target(target: str, params: Optional[dict] = None):
    """The dataset of an LDM yaml's ``data.params.train.target`` stanza."""
    if target not in CONFIG_TARGETS:
        raise KeyError(f"unknown data target {target!r} "
                       f"(known: {sorted(CONFIG_TARGETS)})")
    return CONFIG_TARGETS[target](**(params or {}))
