"""InceptionV3 (the FID variant) in PyTorch: counterpart of
``diff_pruning_tpu/eval/inception.py``.

Architecture: torchvision ``inception_v3`` with pytorch-fid's changes. The
FID InceptionA/C blocks and Mixed_7b average-pool with
``count_include_pad=False``; Mixed_7c max-pools (stride 1, padding 1).
The output is the 2048-d pool3 feature. Submodules carry the names of the
pt_inception state dict (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_var``, ...), so a local
``pt_inception-2015-12-05-6726825d.pth`` loads with ``load_state_dict``.

BatchNorm is inference-mode and applied as the JAX package applies it:
``scale = weight * rsqrt(running_var + 1e-3)`` in f32, then
``conv(x) * scale + (bias - running_mean * scale)``, then ReLU. The JAX
package convolves at ``Precision.HIGHEST``; on the GPU the callers turn
TF32 off so that cuDNN convolves in f32 too.

Weights: a local ``.pth`` (pytorch-fid's release) or a JAX-converted
``.npz``; neither is downloaded. Without them, :func:`random_init_fid_inception_state_dict`
draws the JAX package's fixed-seed random init from the same numpy
generator in the same order, so both packages hold the same random
extractor (a relative two-sample distance, not comparable to published
FID).

Input: float images in [0, 1], NHWC; resized to 299 bilinear (antialiased
when shrinking, as ``jax.image.resize`` is) and scaled to [-1, 1].
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3
FID_WEIGHTS_FILE = "pt_inception-2015-12-05-6726825d.pth"


class BasicConv2d(nn.Module):
    """conv (no bias) + inference BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        scale = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
        shift = bn.bias - bn.running_mean * scale
        y = torch.addcmul(shift[:, None, None], self.conv(x), scale[:, None, None])
        return F.relu_(y)


def _avg_pool_nocountpad(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nocountpad(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(768, 192, 1)
        self.branch7x7_1 = BasicConv2d(768, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(768, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(768, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool_nocountpad(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """Mixed_7b (``max_pool=False``: the average pool without padded
    counts) and Mixed_7c (``max_pool=True``: a 3x3 stride-1 max pool)."""

    def __init__(self, cin: int, max_pool: bool):
        super().__init__()
        self.max_pool = max_pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        # max_pool2d pads with -inf, as the JAX reduce_window does
        pool = (F.max_pool2d(x, 3, stride=1, padding=1) if self.max_pool
                else _avg_pool_nocountpad(x))
        return torch.cat([b1, b3, bd, self.branch_pool(pool)], dim=1)


class FIDInceptionV3(nn.Module):
    """The FID InceptionV3 up to pool3, plus the 1008-way ``fc`` head (used
    only by the Inception Score) when ``with_fc``. ``forward`` takes NCHW
    images already at 299 and in [-1, 1]; :func:`inception_pool3` is the
    entry point for NHWC images in [0, 1]."""

    def __init__(self, with_fc: bool = False):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(128)
        self.Mixed_6c = InceptionC(160)
        self.Mixed_6d = InceptionC(160)
        self.Mixed_6e = InceptionC(192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, max_pool=False)
        self.Mixed_7c = InceptionE(2048, max_pool=True)
        self.fc = nn.Linear(2048, 1008) if with_fc else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))  # adaptive average pool to 1x1


def inception_pool3(model: FIDInceptionV3, images: torch.Tensor, *,
                    resize: bool = True, normalize: bool = True) -> torch.Tensor:
    """images: NHWC float in [0, 1] on the model's device -> (N, 2048) pool3.

    The resize is ``jax.image.resize(..., "bilinear")``'s: half-pixel
    centres, and a triangle filter widened by the ratio when an axis
    shrinks. ``F.interpolate`` gives it without ``antialias`` for upscales
    and with it when an axis shrinks (its antialiased filter then also
    holds for an axis that grows)."""
    x = images.permute(0, 3, 1, 2).contiguous()
    if resize:
        h, w = x.shape[2], x.shape[3]
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                          antialias=max(h, w) > 299)
    if normalize:
        x = 2.0 * x - 1.0
    return model(x)


def fid_inception(state_dict: Mapping[str, torch.Tensor], device="cpu") -> FIDInceptionV3:
    """An eval-mode :class:`FIDInceptionV3` holding ``state_dict`` (with the
    fc head when the state dict has one), on ``device``."""
    model = FIDInceptionV3(with_fc="fc.weight" in state_dict)
    model.load_state_dict(dict(state_dict))
    return model.to(device).eval()


# -- weights ------------------------------------------------------------------

def state_dict_from_jax_inception_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested JAX-layout Inception params (numpy or array leaves) -> the
    pt_inception state dict: conv kernels HWIO -> OIHW, the fc kernel
    (in, out) -> (out, in), ``bn_scale``/``bn_bias``/``bn_mean``/``bn_var``
    -> ``bn.weight``/``bn.bias``/``bn.running_mean``/``bn.running_var``."""
    bn_names = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
                "bn_var": "running_var"}
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        out[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))

    def conv(prefix, p):
        put(f"{prefix}.conv.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        for leaf, name in bn_names.items():
            put(f"{prefix}.bn.{name}", p[leaf])

    for block, tree in params.items():
        if block == "fc":
            put("fc.weight", np.asarray(tree["kernel"]).T)
            put("fc.bias", tree["bias"])
        elif block.startswith("Mixed"):
            for branch, p in tree.items():
                conv(f"{block}.{branch}", p)
        else:
            conv(block, tree)
    return out


def random_init_fid_inception_state_dict(seed=0) -> Dict[str, torch.Tensor]:
    """Seeded random-init weights with the exact pt_inception shapes, drawn
    from ``np.random.default_rng(seed)`` in the JAX package's order (``seed``
    may also be a ``np.random.Generator``), so they equal the JAX
    ``random_init_fid_inception_params(seed)`` bit for bit. No fc head.

    A fixed-seed random CNN is a deterministic feature extractor, so the
    Fréchet distance it induces is a valid relative two-sample distance
    (two sample sets against each other); it is NOT comparable to published
    FID numbers."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv(name, cin, cout, kh, kw):
        sd[f"{name}.conv.weight"] = (
            rng.standard_normal((cout, cin, kh, kw)).astype(np.float32) * 0.05)
        sd[f"{name}.bn.weight"] = np.abs(rng.standard_normal(cout)).astype(np.float32) + 0.5
        sd[f"{name}.bn.bias"] = rng.standard_normal(cout).astype(np.float32) * 0.1
        sd[f"{name}.bn.running_mean"] = rng.standard_normal(cout).astype(np.float32) * 0.1
        sd[f"{name}.bn.running_var"] = np.abs(rng.standard_normal(cout)).astype(np.float32) + 1.0

    conv("Conv2d_1a_3x3", 3, 32, 3, 3)
    conv("Conv2d_2a_3x3", 32, 32, 3, 3)
    conv("Conv2d_2b_3x3", 32, 64, 3, 3)
    conv("Conv2d_3b_1x1", 64, 80, 1, 1)
    conv("Conv2d_4a_3x3", 80, 192, 3, 3)

    def block_a(name, cin, pool):
        conv(f"{name}.branch1x1", cin, 64, 1, 1)
        conv(f"{name}.branch5x5_1", cin, 48, 1, 1)
        conv(f"{name}.branch5x5_2", 48, 64, 5, 5)
        conv(f"{name}.branch3x3dbl_1", cin, 64, 1, 1)
        conv(f"{name}.branch3x3dbl_2", 64, 96, 3, 3)
        conv(f"{name}.branch3x3dbl_3", 96, 96, 3, 3)
        conv(f"{name}.branch_pool", cin, pool, 1, 1)

    block_a("Mixed_5b", 192, 32)
    block_a("Mixed_5c", 256, 64)
    block_a("Mixed_5d", 288, 64)
    conv("Mixed_6a.branch3x3", 288, 384, 3, 3)
    conv("Mixed_6a.branch3x3dbl_1", 288, 64, 1, 1)
    conv("Mixed_6a.branch3x3dbl_2", 64, 96, 3, 3)
    conv("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3)

    def block_c(name, c7):
        conv(f"{name}.branch1x1", 768, 192, 1, 1)
        conv(f"{name}.branch7x7_1", 768, c7, 1, 1)
        conv(f"{name}.branch7x7_2", c7, c7, 1, 7)
        conv(f"{name}.branch7x7_3", c7, 192, 7, 1)
        conv(f"{name}.branch7x7dbl_1", 768, c7, 1, 1)
        conv(f"{name}.branch7x7dbl_2", c7, c7, 7, 1)
        conv(f"{name}.branch7x7dbl_3", c7, c7, 1, 7)
        conv(f"{name}.branch7x7dbl_4", c7, c7, 7, 1)
        conv(f"{name}.branch7x7dbl_5", c7, 192, 1, 7)
        conv(f"{name}.branch_pool", 768, 192, 1, 1)

    block_c("Mixed_6b", 128)
    block_c("Mixed_6c", 160)
    block_c("Mixed_6d", 160)
    block_c("Mixed_6e", 192)
    conv("Mixed_7a.branch3x3_1", 768, 192, 1, 1)
    conv("Mixed_7a.branch3x3_2", 192, 320, 3, 3)
    conv("Mixed_7a.branch7x7x3_1", 768, 192, 1, 1)
    conv("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7)
    conv("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1)
    conv("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3)

    def block_e(name, cin):
        conv(f"{name}.branch1x1", cin, 320, 1, 1)
        conv(f"{name}.branch3x3_1", cin, 384, 1, 1)
        conv(f"{name}.branch3x3_2a", 384, 384, 1, 3)
        conv(f"{name}.branch3x3_2b", 384, 384, 3, 1)
        conv(f"{name}.branch3x3dbl_1", cin, 448, 1, 1)
        conv(f"{name}.branch3x3dbl_2", 448, 384, 3, 3)
        conv(f"{name}.branch3x3dbl_3a", 384, 384, 1, 3)
        conv(f"{name}.branch3x3dbl_3b", 384, 384, 3, 1)
        conv(f"{name}.branch_pool", cin, 192, 1, 1)

    block_e("Mixed_7b", 1280)
    block_e("Mixed_7c", 2048)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _read_npz(path: str) -> Dict[str, torch.Tensor]:
    """A JAX-converted Inception ``.npz`` (flat ``Block/branch/leaf`` keys)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return state_dict_from_jax_inception_params(tree)


def load_fid_inception_state_dict(path: Optional[str] = None
                                  ) -> Optional[Dict[str, torch.Tensor]]:
    """FID Inception weights from a local file (``.pth`` or JAX-converted
    ``.npz``), as a state dict for :class:`FIDInceptionV3` (AuxLogits
    dropped, fc kept when present).

    Search order: explicit path, $FID_INCEPTION_WEIGHTS, the torch hub cache
    (``pt_inception-2015-12-05-6726825d.pth``). Returns None when none of
    them exists.
    """
    candidates = []
    if path:
        candidates.append(path)
    if os.environ.get("FID_INCEPTION_WEIGHTS"):
        candidates.append(os.environ["FID_INCEPTION_WEIGHTS"])
    candidates.append(os.path.join(os.path.expanduser("~/.cache/torch/hub/checkpoints"),
                                   FID_WEIGHTS_FILE))
    for c in candidates:
        if not os.path.exists(c):
            continue
        if c.endswith(".npz"):
            return _read_npz(c)
        sd = torch.load(c, map_location="cpu", weights_only=True)
        # the keys the model holds: no auxiliary classifier, no BN batch counters
        return {k: v for k, v in sd.items()
                if not k.startswith("AuxLogits.") and not k.endswith("num_batches_tracked")}
    return None
