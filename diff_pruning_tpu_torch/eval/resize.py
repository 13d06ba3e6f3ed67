"""PIL-exact antialiased bicubic resize as two matmuls (clean-FID resizing).

Counterpart of ``diff_pruning_tpu/eval/resize.py``. clean-fid's resize is
PIL's antialiased bicubic on float data, where pytorch-fid uses a
bilinear resize inside the network (Parmar et al., "On Aliased Resizing
and Surprising Subtleties in GAN Evaluation"). PIL's resampling is a
separable weighted sum with the cubic kernel (a = -0.5) whose support is
scaled by the downsampling ratio, so each spatial axis is a dense
(out, in) matrix and the whole resize is two matmuls. The matrices are
built in float64 with numpy, exactly as the JAX package builds them, then
cast to the images' dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    in1 = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    in2 = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
    return np.where(ax < 1.0, in1, np.where(ax < 2.0, in2, 0.0))


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic PIL-bicubic resampling matrix.

    Mirrors Pillow's precompute_coeffs: filter support scaled by
    max(1, in/out) (the antialiasing), window [center-support+0.5,
    center+support+0.5), weights normalized per output pixel.
    """
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    w = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        k = _bicubic((np.arange(xmin, xmax) - center + 0.5) / filterscale)
        w[xx, xmin:xmax] = k / k.sum()
    return w


def resize_bicubic_pil(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC float images -> (N, out_h, out_w, C), PIL-bicubic-antialiased,
    on x's device and in x's dtype.

    Like clean-fid, operates on float data and does NOT clip the cubic
    overshoot.
    """
    wh = torch.as_tensor(resize_weights(x.shape[1], out_h), dtype=x.dtype, device=x.device)
    ww = torch.as_tensor(resize_weights(x.shape[2], out_w), dtype=x.dtype, device=x.device)
    y = torch.einsum("oh,nhwc->nowc", wh, x)
    return torch.einsum("pw,nowc->nopc", ww, y)
