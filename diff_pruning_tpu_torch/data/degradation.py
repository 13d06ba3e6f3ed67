"""BSRGAN image degradation for super-resolution data: counterpart of
``diff_pruning_tpu/data/degradation.py``, the reference's
``ldm_exp/ldm/modules/image_degradation/{bsrgan,bsrgan_light}.py``
``degradation_bsrgan_variant``, the data pipeline of the bsr_sr superres
LDM (``data/sr.py``).

Host code, numpy, scipy and OpenCV, as the JAX package's: the same calls in
the same order. Pipeline (degradation order randomized, downsample-to-target
kept after the random rescale, final JPEG always applied):
  blur (anisotropic/isotropic Gaussian) -> random rescale -> downsample to
  1/sf -> Gaussian noise (color/gray/correlated) -> JPEG -> final JPEG.
The full and light variants differ only in strengths: blur widths /4 and
kernel sizes [5,14]/[5,7] vs [7,25], noise levels (1,2) vs (2,25), JPEG
quality 80-95 vs 30-95, and the second blur stage dropped (bsrgan.py:326-341,
419 vs bsrgan_light.py:325-344, 423).

Every draw comes from the caller's ``np.random.Generator``, in the JAX
version's order (the permutation of the 7 stages, the swap that keeps the
downsample last, then each stage's own draws), so the uint8 output equals the
JAX package's for the same generator state.
"""

from __future__ import annotations

from typing import Dict, Optional

import cv2
import numpy as np
from scipy import ndimage
from scipy.linalg import orth


def gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    """fspecial('gaussian') — isotropic, odd or even size, sum 1."""
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    k = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * max(sigma, 1e-8) ** 2))
    return k / k.sum()


def anisotropic_gaussian_kernel(ksize: int, theta: float, l1: float,
                                l2: float) -> np.ndarray:
    """bsrgan anisotropic_Gaussian: rotated 2-D Gaussian with eigenvalues
    l1/l2 along/across the theta direction."""
    v = np.array([np.cos(theta), np.sin(theta)])
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    D = np.diag([max(l1, 1e-6), max(l2, 1e-6)])
    sigma = V @ D @ V.T
    inv = np.linalg.inv(sigma)
    ax = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    pts = np.stack([xx, yy], axis=-1)
    k = np.exp(-0.5 * np.einsum("...i,ij,...j->...", pts, inv, pts))
    return k / k.sum()


def shift_pixel(kernel: np.ndarray, sf: int) -> np.ndarray:
    """bsrgan utils shift_pixel: move the kernel by (sf-1)/2 towards the
    upper-left so strided nearest downsampling samples pixel centers."""
    shift = (sf - 1) * 0.5
    out = ndimage.shift(kernel, (-shift, -shift), order=1, mode="nearest")
    return out


_CV_INTERPS = (cv2.INTER_LINEAR, cv2.INTER_CUBIC, cv2.INTER_AREA)


def _rand_interp(rng) -> int:
    # reference: random.choice([1, 2, 3]), LINEAR / CUBIC / AREA
    return _CV_INTERPS[rng.integers(0, 3)]


def add_blur(img: np.ndarray, sf: int, rng, *, light: bool) -> np.ndarray:
    wd2 = 4.0 + sf
    wd = 2.0 + 0.2 * sf
    if light:  # bsrgan_light.py:326-330: widths /4, smaller kernels
        wd2, wd = wd2 / 4, wd / 4
    if rng.random() < 0.5:
        if light:  # bsrgan_light.py:335: ksize randint(2,11)+3 in [5,14]
            ksize = int(rng.integers(2, 12)) + 3
        else:  # bsrgan.py:331: ksize 2*randint(2,11)+3 in [7,25]
            ksize = 2 * int(rng.integers(2, 12)) + 3
        k = anisotropic_gaussian_kernel(ksize, rng.random() * np.pi,
                                        wd2 * rng.random(), wd2 * rng.random())
    else:
        if light:  # bsrgan_light.py:337: size randint(2,4)+3
            size = int(rng.integers(2, 5)) + 3
        else:  # bsrgan.py:333: size 2*randint(2,11)+3
            size = 2 * int(rng.integers(2, 12)) + 3
        k = gaussian_kernel(size, wd * rng.random())
    return ndimage.convolve(img, k[:, :, None], mode="mirror")


def add_gaussian_noise(img: np.ndarray, rng, level1: int, level2: int) -> np.ndarray:
    noise_level = int(rng.integers(level1, level2 + 1))
    rnum = rng.random()
    if rnum > 0.6:  # color noise
        img = img + rng.normal(0, noise_level / 255.0, img.shape).astype(np.float32)
    elif rnum < 0.4:  # grayscale noise
        img = img + rng.normal(0, noise_level / 255.0,
                               (*img.shape[:2], 1)).astype(np.float32)
    else:  # channel-correlated noise
        L = level2 / 255.0
        D = np.diag(rng.random(3))
        U = orth(rng.random((3, 3)))
        conv = U.T @ D @ U
        img = img + rng.multivariate_normal(
            [0, 0, 0], np.abs(L ** 2 * conv), img.shape[:2]).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img: np.ndarray, rng, *, light: bool = True) -> np.ndarray:
    # bsrgan_light.py:423 quality 80-95; bsrgan.py:419 down to 30
    quality = int(rng.integers(80, 96)) if light else int(rng.integers(30, 96))
    u8 = cv2.cvtColor((np.clip(img, 0, 1) * 255.0).round().astype(np.uint8),
                      cv2.COLOR_RGB2BGR)
    _, enc = cv2.imencode(".jpg", u8, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    dec = cv2.imdecode(enc, 1)
    return cv2.cvtColor(dec, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def degradation_bsrgan_variant(image_u8: np.ndarray, sf: int = 4, *,
                               light: bool = True,
                               rng: Optional[np.random.Generator] = None
                               ) -> Dict[str, np.ndarray]:
    """degradation_bsrgan_variant (bsrgan_light.py:533-625 / bsrgan.py):
    uint8 HWC RGB -> {"image": degraded uint8 at 1/sf}."""
    rng = rng or np.random.default_rng()
    img = image_u8.astype(np.float32) / 255.0
    jpeg_prob, scale2_prob = 0.9, 0.25
    h1, w1 = img.shape[:2]
    img = img[: w1 - w1 % sf, : h1 - h1 % sf, ...]  # mod crop (as reference)

    if sf == 4 and rng.random() < scale2_prob:  # pre-halve
        if rng.random() < 0.5:
            img = cv2.resize(img, (img.shape[1] // 2, img.shape[0] // 2),
                             interpolation=_rand_interp(rng))
        else:
            # reference: util.imresize_np(img, 1/2, True), MATLAB-style
            # antialiased bicubic; the PIL-exact antialiased-bicubic
            # matrices of eval/resize.py are the same a = -0.5 kernel with
            # the same max(1, in/out) support scaling (the 1-pixel border
            # is handled otherwise, as in the JAX package)
            from ..eval.resize import resize_weights

            h, w = img.shape[:2]
            wy = resize_weights(h, h // 2).astype(np.float32)
            wx = resize_weights(w, w // 2).astype(np.float32)
            img = np.einsum("oh,hwc->owc", wy,
                            np.einsum("ow,hwc->hoc", wx, img))
        img = np.clip(img, 0.0, 1.0)
        sf = 2

    order = list(rng.permutation(7))
    i1, i2 = order.index(2), order.index(3)
    if i1 > i2:  # keep the to-target downsample last of the two
        order[i1], order[i2] = order[i2], order[i1]

    a, b = img.shape[1], img.shape[0]
    for i in order:
        if i == 0:
            img = add_blur(img, sf, rng, light=light)
        elif i == 1:
            if not light:  # second blur stage only in the full variant
                img = add_blur(img, sf, rng, light=light)
        elif i == 2:
            a, b = img.shape[1], img.shape[0]
            if rng.random() < (0.8 if light else 0.75):
                sf1 = rng.uniform(1, 2 * sf)
                img = cv2.resize(img, (int(img.shape[1] / sf1),
                                       int(img.shape[0] / sf1)),
                                 interpolation=_rand_interp(rng))
            else:
                k = gaussian_kernel(25, rng.uniform(0.1, 0.6 * sf))
                k = shift_pixel(k, sf)
                k = k / k.sum()
                img = ndimage.convolve(img, k[:, :, None], mode="mirror")
                img = img[0::sf, 0::sf, ...]
            img = np.clip(img, 0.0, 1.0)
        elif i == 3:
            img = cv2.resize(img, (int(a / sf), int(b / sf)),
                             interpolation=_rand_interp(rng))
            img = np.clip(img, 0.0, 1.0)
        elif i == 4:
            l1, l2 = (1, 2) if light else (2, 25)
            img = add_gaussian_noise(img, rng, l1, l2)
        elif i == 5:
            if rng.random() < jpeg_prob:
                img = add_jpeg_noise(img, rng, light=light)
        # i == 6: camera ISP model — None in the reference call sites too

    img = add_jpeg_noise(img, rng, light=light)
    return {"image": (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)}
