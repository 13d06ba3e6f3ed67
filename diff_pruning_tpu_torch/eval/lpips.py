"""LPIPS perceptual distance: PyTorch counterpart of
``diff_pruning_tpu/eval/lpips.py``, the first-stage trainer's perceptual
loss (taming ``modules/losses/lpips.py``).

A frozen torchvision VGG16 ``features`` trunk tapped at relu1_2, relu2_2,
relu3_3, relu4_3 and relu5_3 (64, 128, 256, 512, 512 channels); each tap
unit-normalised over its channels, the squared difference of the two
images' taps weighted by the learned 1x1 "lin" heads (a dot over the
channels), averaged over space and summed over the taps. Images are NHWC in
[-1, 1]; the ScalingLayer maps them to VGG's ImageNet normalisation.

Weights: the module's parameters are named ``features.{i}.kernel|bias`` (i
the torchvision ``features`` index) and ``lins.{k}.kernel``, so
:func:`load_lpips_params` reads the JAX package's ``.npz`` layout
(``features/{i}/kernel`` HWIO, ``lins/{k}/kernel``) through the port's
checkpoint bridge, and :func:`torch_lpips_state_dicts_to_params` converts
the torchvision VGG16 and taming ``vgg_lpips`` state dicts. Neither of those
is in the repository; :func:`init_lpips_params` draws a random init (a
relative perceptual distance, as the JAX package's ``--lpips random``).
The parameters never take a grad. The convolutions are cuDNN's (the JAX
package's are XLA's: no kernel of its own); f32 runs with TF32 off where
the caller pins it, as the JAX package runs them at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg16.features conv indices and their (cin, cout); pooling sits
# between the slice boundaries below
VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG16_CONV_CH = ((3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
                 (256, 512), (512, 512), (512, 512), (512, 512), (512, 512), (512, 512))
# features[i] index after whose relu a tap is taken (relu1_2 ... relu5_3)
TAP_AFTER_CONV = (2, 7, 14, 21, 28)
TAP_CHANNELS = (64, 128, 256, 512, 512)
# 2x2 max pools sit before these convs (features idx 4, 9, 16, 23)
POOL_BEFORE_CONV = (5, 10, 17, 24)
# ScalingLayer constants (taming lpips.py)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _Conv3x3(nn.Module):
    def __init__(self, cin: int, cout: int, *, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((cout, cin, 3, 3), device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty((cout,), device=device), requires_grad=False)


class _Lin(nn.Module):
    def __init__(self, c: int, *, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((c,), device=device), requires_grad=False)


def _normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x / (||x||_channels + eps) over dim 1 (taming's normalize_tensor)."""
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """``forward(x, y)``: the per-image distance, shape (N,), of NHWC images
    in [-1, 1]; computed in the images' dtype (the weights cast to it, as
    the JAX layers cast them)."""

    def __init__(self, *, device):
        super().__init__()
        self.features = nn.ModuleDict({str(i): _Conv3x3(cin, cout, device=device)
                                       for i, (cin, cout) in zip(VGG16_CONV_IDX, VGG16_CONV_CH)})
        self.lins = nn.ModuleDict({str(k): _Lin(c, device=device)
                                   for k, c in enumerate(TAP_CHANNELS)})

    def taps(self, x: torch.Tensor):
        """The five tapped relu activations of the VGG16 trunk (NCHW in)."""
        out = []
        for i in VGG16_CONV_IDX:
            if i in POOL_BEFORE_CONV:
                x = F.max_pool2d(x, 2)
            conv = self.features[str(i)]
            x = F.relu(F.conv2d(x, conv.kernel.to(x.dtype), conv.bias.to(x.dtype), padding=1))
            if i in TAP_AFTER_CONV:
                out.append(x)
        return out

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, dtype=torch.float32, device=x.device).to(x.dtype)
        scale = torch.tensor(_SCALE, dtype=torch.float32, device=x.device).to(x.dtype)
        t0 = self.taps(((x - shift) / scale).permute(0, 3, 1, 2))
        t1 = self.taps(((y - shift) / scale).permute(0, 3, 1, 2))
        val = 0.0
        for k in range(len(TAP_CHANNELS)):
            d = (_normalize(t0[k]) - _normalize(t1[k])) ** 2
            w = self.lins[str(k)].kernel.to(d.dtype)
            # NetLinLayer: a 1x1 conv to one channel without bias, a dot over C
            val = val + (d.permute(0, 2, 3, 1) @ w).mean(dim=(1, 2))
        return val


def init_lpips_params(generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A random init as a state dict (CPU): He-normal conv kernels, zero
    biases, lin heads |N(0, 0.1)| (non-negative, as the trained heads are,
    which keeps the distance a pseudo-metric)."""
    sd = {}
    for i, (cin, cout) in zip(VGG16_CONV_IDX, VGG16_CONV_CH):
        std = math.sqrt(2.0 / (3 * 3 * cin))
        sd[f"features.{i}.kernel"] = torch.randn((cout, cin, 3, 3), generator=generator) * std
        sd[f"features.{i}.bias"] = torch.zeros((cout,))
    for k, c in enumerate(TAP_CHANNELS):
        sd[f"lins.{k}.kernel"] = torch.randn((c,), generator=generator).abs() * 0.1
    return sd


def torch_lpips_state_dicts_to_params(vgg_sd: Mapping, lin_sd: Mapping) -> Dict[str, torch.Tensor]:
    """A state dict from torchvision's vgg16 state dict (``features.{i}.weight``
    OIHW and ``.bias``; a full one with ``classifier.*`` works too) and
    taming's vgg_lpips one (``lin{k}.model.1.weight``, (1, C, 1, 1))."""

    def arr(v):
        return torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                                          np.float32))

    sd = {}
    for i, (cin, cout) in zip(VGG16_CONV_IDX, VGG16_CONV_CH):
        w = arr(vgg_sd[f"features.{i}.weight"])
        if w.shape != (cout, cin, 3, 3):
            raise ValueError(f"features.{i}.weight: {tuple(w.shape)}, want {(cout, cin, 3, 3)}")
        sd[f"features.{i}.kernel"] = w
        sd[f"features.{i}.bias"] = arr(vgg_sd[f"features.{i}.bias"])
    for k, c in enumerate(TAP_CHANNELS):
        w = arr(lin_sd[f"lin{k}.model.1.weight"])
        if w.shape != (1, c, 1, 1):
            raise ValueError(f"lin{k}.model.1.weight: {tuple(w.shape)}, want {(1, c, 1, 1)}")
        sd[f"lins.{k}.kernel"] = w[0, :, 0, 0].contiguous()
    return sd


def load_lpips_params(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from a converted ``.npz`` (``cli/convert_checkpoints.py
    lpips`` of either package: ``features/{i}/kernel`` HWIO,
    ``features/{i}/bias``, ``lins/{k}/kernel``)."""
    from ..utils.checkpoint import load_params_npz

    return load_params_npz(path)
