"""SSIM, the paper's same-seed consistency metric.

Counterpart of ``diff_pruning_tpu/eval/ssim.py``: pytorch_msssim's
Gaussian-window SSIM as ddpm_exp/compute_ssim.py:39-52 uses it (window 11,
sigma 1.5, data_range 1, size_average). Inputs are NHWC in [0, 1]. The
filters run in f32 on the inputs' device, with TF32 off for the
convolutions (the JAX package forces ``Precision.HIGHEST``). The 11 x 11
window is the outer product of a 1-D Gaussian, applied as two 1-D passes
(over H, then W), as pytorch_msssim applies it: the same filter with fewer
roundings, which matters because the variances are differences of
nearly equal f32 filter outputs.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The 1-D window whose outer product with itself is the 2-D one."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2d(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise valid 2-D Gaussian filter over NCHW, one 1-D pass a dim."""
    c, k = x.shape[1], window.shape[0]
    x = F.conv2d(x, window.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, window.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, *, data_range: float = 1.0,
         size_average: bool = True) -> torch.Tensor:
    """SSIM over NHWC batches; ``size_average`` gives a scalar, else one per image."""
    x = torch.as_tensor(img1).to(torch.float32).permute(0, 3, 1, 2)
    y = torch.as_tensor(img2).to(device=x.device, dtype=torch.float32).permute(0, 3, 1, 2)
    win = torch.as_tensor(_gaussian_window(), dtype=torch.float32, device=x.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        mu1 = _filter2d(x, win)
        mu2 = _filter2d(y, win)
        mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = _filter2d(x * x, win) - mu1_sq
        s2 = _filter2d(y * y, win) - mu2_sq
        s12 = _filter2d(x * y, win) - mu12
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    m = ((2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)) * cs
    per_image = m.mean(dim=(1, 2, 3))
    return per_image.mean() if size_average else per_image


def pairwise_ssim_mse(dir1: str, dir2: str, *, batch_size: int = 256, device=None):
    """compute_ssim.py's numbers: the mean SSIM and the mean MSE between the
    same-named images of two folders, computed on ``device`` (default CPU)."""
    from PIL import Image

    from ..data.datasets import list_image_files

    files1 = {os.path.basename(f): f for f in list_image_files(dir1)}
    files2 = {os.path.basename(f): f for f in list_image_files(dir2)}
    common = sorted(set(files1) & set(files2))
    if not common:
        raise ValueError("no matching filenames between the two dirs")
    ssims, mses = [], []
    for i in range(0, len(common), batch_size):
        names = common[i:i + batch_size]
        a, b = (torch.from_numpy(np.stack([np.asarray(Image.open(files[n]).convert("RGB"))
                                           for n in names])).to(device) / 255.0
                for files in (files1, files2))
        ssims.append(ssim(a, b, size_average=False).cpu().numpy())
        mses.append(((a - b) ** 2).mean(dim=(1, 2, 3)).cpu().numpy())
    return float(np.concatenate(ssims).mean()), float(np.concatenate(mses).mean())
