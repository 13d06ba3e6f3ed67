"""Procedural image distributions: colored soft blobs on gradient backgrounds.

The port's own copy of ``diff_pruning_tpu/data/procedural.py`` (pure
numpy): at the same seed every function returns bit-identical arrays and
writes byte-identical PNGs. With no CIFAR-10 copy and no trained
checkpoint at hand, these distributions are the data for quality runs:
FID and the fidelity metrics of sampled images against a procedural
folder. The algorithmic claims such runs check (the Taylor sweep's early
exit, the pruning criterion's ordering, finetune recovery) do not depend on
the distribution.
"""

from __future__ import annotations

import numpy as np


def class_palette(n_classes: int) -> np.ndarray:
    """(n_classes, 3) float palette in [0,1] — evenly spaced saturated hues.

    Each class of the conditional procedural distribution paints its blobs
    in (a jittered neighborhood of) one palette color, so class identity is
    decodable from pixels alone (classify_by_palette) — that makes CFG
    class-conditioning verifiable end-to-end in pixel space, the zero-egress
    stand-in for "does class 25 look like an ostrich"
    (ldm_exp/sample_pruned.py's per-class grids)."""
    h = np.arange(n_classes, dtype=np.float32) / n_classes * 6.0
    x = 1.0 - np.abs(h % 2.0 - 1.0)
    z = np.zeros_like(h)
    o = np.ones_like(h)
    rgb = np.choose(np.minimum(h.astype(np.int64), 5),
                    [np.stack([o, x, z]), np.stack([x, o, z]),
                     np.stack([z, o, x]), np.stack([z, x, o]),
                     np.stack([x, z, o]), np.stack([o, z, x])])
    return rgb.T.copy()


def make_procedural_class_dataset(n_per_class: int = 512, hw: int = 64,
                                  n_classes: int = 8, seed: int = 0):
    """Class-conditional blobs: returns ((N, hw, hw, 3) uint8, (N,) int32).

    Class c's blobs are drawn in palette color c (small jitter); backgrounds
    are desaturated gradients so the blob hue carries the class signal."""
    rng = np.random.default_rng(seed)
    pal = class_palette(n_classes)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    n = n_per_class * n_classes
    imgs = np.zeros((n, hw, hw, 3), np.float32)
    labels = np.repeat(np.arange(n_classes, dtype=np.int32), n_per_class)
    for i in range(n):
        c = labels[i]
        g = rng.uniform(0.25, 0.75)
        bg = g + rng.uniform(-0.06, 0.06, 3)  # near-gray
        grad_dir = rng.uniform(-1, 1, 2)
        img = (bg[None, None]
               * (0.8 + 0.2 * (grad_dir[0] * xx + grad_dir[1] * yy))[..., None])
        for _ in range(rng.integers(1, 4)):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            r = rng.uniform(0.10, 0.28)
            color = np.clip(pal[c] + rng.uniform(-0.08, 0.08, 3), 0, 1)
            d2 = (xx - cx) ** 2 + (yy - cy) ** 2
            mask = np.exp(-d2 / (2 * r * r))[..., None]
            img = img * (1 - mask) + color[None, None] * mask
        imgs[i] = np.clip(img, 0, 1)
    return (imgs * 255).astype(np.uint8), labels


def classify_by_palette(imgs: np.ndarray, n_classes: int,
                        chroma_thr: float = 0.18) -> np.ndarray:
    """Decode the class of (N, H, W, 3) uint8/float images by nearest
    palette color over high-chroma (blob) pixels; -1 when no blob pixels.

    The pixel-space conditioning check: CFG samples of class c should
    classify as c (tools/pixelrun.py's class-consistency eval)."""
    x = imgs.astype(np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    pal = class_palette(n_classes)  # (C, 3)
    chroma = x.max(-1) - x.min(-1)  # (N, H, W)
    w = np.maximum(chroma - chroma_thr, 0.0)  # blob-pixel weights
    wsum = w.sum((1, 2))
    mean = np.einsum("nhwc,nhw->nc", x, w) / np.maximum(wsum, 1e-6)[:, None]
    d = ((mean[:, None, :] - pal[None]) ** 2).sum(-1)  # (N, C)
    out = d.argmin(1).astype(np.int32)
    out[wsum < 1.0] = -1
    return out


def write_labeled_folder(imgs: np.ndarray, labels: np.ndarray,
                         root: str) -> None:
    """Write (imgs, labels) as root/class_<c>/%06d.png — the ImageNet-style
    layout cli.ldm_train's get_labeled_dataset consumes."""
    import os

    from PIL import Image

    counts = {}
    for img, lab in zip(imgs, labels):
        d = os.path.join(root, f"class_{int(lab):03d}")
        os.makedirs(d, exist_ok=True)
        i = counts.get(int(lab), 0)
        counts[int(lab)] = i + 1
        Image.fromarray(img).save(os.path.join(d, f"{i:06d}.png"))


def make_procedural_dataset(n: int = 4096, hw: int = 32, seed: int = 0) -> np.ndarray:
    """(n, hw, hw, 3) uint8 — colored soft blobs on gradient backgrounds."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    imgs = np.zeros((n, hw, hw, 3), np.float32)
    for i in range(n):
        bg = rng.uniform(0.1, 0.9, 3)
        grad_dir = rng.uniform(-1, 1, 2)
        base = bg[None, None] * (0.7 + 0.3 * (grad_dir[0] * xx + grad_dir[1] * yy))[..., None]
        img = base.copy()
        for _ in range(rng.integers(1, 4)):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            r = rng.uniform(0.08, 0.25)
            color = rng.uniform(0, 1, 3)
            d2 = (xx - cx) ** 2 + (yy - cy) ** 2
            mask = np.exp(-d2 / (2 * r * r))[..., None]
            img = img * (1 - mask) + color[None, None] * mask
        imgs[i] = np.clip(img, 0, 1)
    return (imgs * 255).astype(np.uint8)
