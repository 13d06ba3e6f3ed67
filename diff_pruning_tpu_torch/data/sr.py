"""Super-resolution dataset: counterpart of ``diff_pruning_tpu/data/sr.py``,
the reference's ``ldm_exp/ldm/data/imagenet.py`` ImageNetSR (lines 272-394):
a random or center crop of a random fraction of the short side, an area
resize to ``size``, then a degradation to ``size / downscale_f`` with a PIL
or OpenCV interpolation or the BSRGAN pipeline (``data/degradation.py``).

Host code over any image folder, as the JAX version (the reference's pickled
ImageNet quality indices select a subset, not another pipeline). Item ``i``
draws from ``np.random.default_rng((seed, i))``, in the JAX version's order,
so its uint8 pixels, and the [-1, 1] floats made from them, equal the JAX
package's.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import cv2
import numpy as np
from PIL import Image

from .degradation import degradation_bsrgan_variant

_PIL_INTERP = {
    "pil_nearest": Image.NEAREST,
    "pil_bilinear": Image.BILINEAR,
    "pil_bicubic": Image.BICUBIC,
    "pil_box": Image.BOX,
    "pil_hamming": Image.HAMMING,
    "pil_lanczos": Image.LANCZOS,
}
_CV_INTERP = {
    "cv_nearest": cv2.INTER_NEAREST,
    "cv_bilinear": cv2.INTER_LINEAR,
    "cv_bicubic": cv2.INTER_CUBIC,
    "cv_area": cv2.INTER_AREA,
    "cv_lanczos": cv2.INTER_LANCZOS4,
}


def _smallest_max_size(img: np.ndarray, size: int, interpolation) -> np.ndarray:
    """albumentations.SmallestMaxSize: scale so min(h, w) == size."""
    h, w = img.shape[:2]
    s = size / min(h, w)
    return cv2.resize(img, (max(size, int(round(w * s))),
                            max(size, int(round(h * s)))),
                      interpolation=interpolation)


class SRDataset:
    """Items: {"image": (size, size, 3), "LR_image": (size/f, size/f, 3)},
    both float32 in [-1, 1] (imagenet.py:368-371)."""

    def __init__(self, image_files: Sequence[str], *, size: int,
                 degradation: str, downscale_f: int = 4,
                 min_crop_f: float = 0.5, max_crop_f: float = 1.0,
                 random_crop: bool = True, seed: int = 0):
        assert size % downscale_f == 0
        assert max_crop_f <= 1.0
        if degradation not in ("bsrgan", "bsrgan_light") and \
                degradation not in _PIL_INTERP and degradation not in _CV_INTERP:
            raise ValueError(f"unknown degradation {degradation!r}")
        self.files = list(image_files)
        self.size = size
        self.lr_size = size // downscale_f
        self.downscale_f = downscale_f
        self.min_crop_f, self.max_crop_f = min_crop_f, max_crop_f
        self.center_crop = not random_crop
        self.degradation = degradation
        self.seed = seed

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, i))
        image = Image.open(self.files[i])
        if image.mode != "RGB":
            image = image.convert("RGB")
        image = np.asarray(image, np.uint8)

        min_side = min(image.shape[:2])
        crop = int(min_side * rng.uniform(self.min_crop_f, self.max_crop_f))
        h, w = image.shape[:2]
        if self.center_crop:
            y0, x0 = (h - crop) // 2, (w - crop) // 2
        else:
            y0 = int(rng.integers(0, h - crop + 1))
            x0 = int(rng.integers(0, w - crop + 1))
        image = image[y0:y0 + crop, x0:x0 + crop]
        image = _smallest_max_size(image, self.size, cv2.INTER_AREA)
        image = image[: self.size, : self.size]

        if self.degradation in ("bsrgan", "bsrgan_light"):
            lr = degradation_bsrgan_variant(
                image, sf=self.downscale_f,
                light=self.degradation == "bsrgan_light", rng=rng)["image"]
        elif self.degradation in _PIL_INTERP:
            # torchvision TF.resize(size=LR) on a square crop -> LRxLR
            lr = np.asarray(Image.fromarray(image).resize(
                (self.lr_size, self.lr_size),
                _PIL_INTERP[self.degradation]), np.uint8)
        else:
            lr = _smallest_max_size(image, self.lr_size,
                                    _CV_INTERP[self.degradation])
            lr = lr[: self.lr_size, : self.lr_size]

        return {"image": (image / 127.5 - 1.0).astype(np.float32),
                "LR_image": (lr / 127.5 - 1.0).astype(np.float32)}


def sr_dataset_from_folder(root: str, **kw) -> SRDataset:
    exts = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
    files = sorted(os.path.join(root, f) for f in os.listdir(root)
                   if f.lower().endswith(exts))
    if not files:
        raise ValueError(f"no images under {root}")
    return SRDataset(files, **kw)
