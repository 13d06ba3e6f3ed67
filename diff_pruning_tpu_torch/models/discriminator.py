"""PatchGAN discriminator and ActNorm for first-stage autoencoder training:
PyTorch counterpart of ``diff_pruning_tpu/models/discriminator.py``.

taming's ``NLayerDiscriminator`` (the pix2pix PatchGAN) and ``ActNorm``,
which the reference's ``LPIPSWithDiscriminator`` and
``VQLPIPSWithDiscriminator`` instantiate. The module tree, its parameter
names (``main/{i}/conv/kernel``, ``main/{i}/norm/{scale,bias|loc}``,
``main/out/conv/*``) and its channel graph are the JAX package's, so weights,
Adam states and the graph cross between the packages.

The discriminator runs only in train mode inside the GAN step, where torch's
BatchNorm normalises with the batch's own statistics (biased variance, in
f32): that is what ``_batch_stats_norm`` computes, and no running statistics
are kept, as in the JAX package. With a ``mesh`` (``parallel/mesh.py``) of
more than one rank, where each rank holds its rows of the batch, the
statistics are those of the global batch, as the JAX SPMD step computes
them: the per-channel sums, then the sums of squared deviations from the
global mean, summed over the ranks (differentiably, so the backward reduces
too). ``forward`` takes and returns NHWC like the
JAX model; the convolutions see NCHW views of it (``channels_last``), so no
copy is made between layers.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum
from ..pruning.graph import ChannelGraph, ChannelVar
from .layers import Conv2D, Scope


def _batch_stats_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.BatchNorm2d in training mode on NHWC ``x``: per-channel batch
    mean and biased variance, in f32, then the affine; x's dtype out."""
    xf = x.to(torch.float32)
    var, mean = torch.var_mean(xf, dim=(0, 1, 2), correction=0)
    return _affine(scale, bias, xf, mean, var, eps).to(x.dtype)


def _batch_stats_norm_over_ranks(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                                 mesh, eps: float = 1e-5) -> torch.Tensor:
    """:func:`_batch_stats_norm` of the global batch, ``x`` this rank's rows:
    the mean, then the biased variance about it, each a sum over the ranks
    (two passes, differentiable)."""
    xf = x.to(torch.float32)
    n = xf.shape[0] * xf.shape[1] * xf.shape[2] * mesh.world
    mean = all_reduce_sum(mesh, xf.sum(dim=(0, 1, 2))) / n
    var = all_reduce_sum(mesh, ((xf - mean) ** 2).sum(dim=(0, 1, 2))) / n
    return _affine(scale, bias, xf, mean, var, eps).to(x.dtype)


def _affine(scale, bias, xf, mean, var, eps):
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y * scale.to(torch.float32) + bias.to(torch.float32)


def actnorm_apply(scale: torch.Tensor, loc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ActNorm's affine on NHWC ``x``: ``scale * (x + loc)`` per channel."""
    return scale.to(x.dtype) * (x + loc.to(x.dtype))


def actnorm_initialize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """ActNorm's data-dependent init from a first NHWC batch: ``loc =
    -mean``, ``scale = 1 / (std + 1e-6)`` per channel (biased std, f32)."""
    std, mean = torch.std_mean(x.to(torch.float32), dim=(0, 1, 2), correction=0)
    return {"loc": -mean, "scale": 1.0 / (std + 1e-6)}


class _Norm(nn.Module):
    """A block's norm: BatchNorm from batch statistics (``scale``, ``bias``)
    or ActNorm (``scale``, ``loc``)."""

    def __init__(self, scope: Scope, var: ChannelVar, actnorm: bool, *, device):
        super().__init__()
        self.actnorm = actnorm
        shift = "loc" if actnorm else "bias"
        scope.ref("scale", 0, var, "norm")
        scope.ref(shift, 0, var, "bias")
        self.scale = nn.Parameter(torch.ones((var.size,), device=device))
        self.register_parameter(shift, nn.Parameter(torch.zeros((var.size,), device=device)))

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        if self.actnorm:
            return actnorm_apply(self.scale, self.loc, x)
        if mesh is not None and mesh.world > 1:
            return _batch_stats_norm_over_ranks(self.scale, self.bias, x, mesh)
        return _batch_stats_norm(self.scale, self.bias, x)


class NLayerDiscriminator(nn.Module):
    """4x4-conv PatchGAN: C64(s2) - C128(s2) - C256(s2) - C512(s1) - C1(s1)
    for the default ``n_layers=3``, LeakyReLU(0.2), BatchNorm (or ActNorm)
    on every block but the first and the last. Widths ``ndf * min(2^n, 8)``."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False, *, device):
        super().__init__()
        self.input_nc, self.ndf, self.n_layers, self.use_actnorm = (input_nc, ndf, n_layers,
                                                                     use_actnorm)
        g = self.graph = ChannelGraph()
        root = Scope(g)
        self.widths: List[int] = [ndf] + [ndf * min(2 ** n, 8) for n in range(1, n_layers + 1)]
        self.v_in = g.var("in_img", input_nc, prunable=False)
        self.v_out = g.var("logits", 1, prunable=False)
        self.vars = [g.var(f"main/{i}/out", w) for i, w in enumerate(self.widths)]
        self.main = nn.ModuleDict()
        prev = self.v_in
        for i, v in enumerate(self.vars):
            stride = 2 if i < n_layers else 1
            # the first block and ActNorm blocks keep the conv bias (taming:
            # use_bias = norm is ActNorm); BatchNorm blocks drop it
            blk = nn.ModuleDict({"conv": Conv2D(root(f"main/{i}/conv"), prev, v, 4, stride, 1,
                                                use_bias=i == 0 or use_actnorm, device=device)})
            if i > 0:
                blk["norm"] = _Norm(root(f"main/{i}/norm"), v, use_actnorm, device=device)
            self.main[str(i)] = blk
            prev = v
        self.main["out"] = nn.ModuleDict({"conv": Conv2D(root("main/out/conv"), prev, self.v_out,
                                                         4, 1, 1, device=device)})

    def init(self, generator: torch.Generator) -> "NLayerDiscriminator":
        """taming's ``weights_init``: conv kernels N(0, 0.02), norm scales
        N(1, 0.02) (ActNorm's 1), biases and locs 0."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("kernel"):
                    p.normal_(0.0, 0.02, generator=generator)
                elif name.endswith("scale"):
                    if self.use_actnorm:
                        p.fill_(1.0)
                    else:
                        p.normal_(1.0, 0.02, generator=generator)
                else:
                    p.zero_()
        return self

    @property
    def min_input_size(self) -> int:
        """Smallest H/W with a non-empty logits map: n_layers stride-2 k4p1
        convs halve exactly, then two stride-1 k4p1 convs each shave one:
        H / 2^n - 2 >= 1."""
        return 3 * (2 ** self.n_layers)

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        """(N, H, W, input_nc) -> patch logits (N, h, w, 1); ``x`` is this
        rank's rows of the batch under a ``mesh`` (BatchNorm over all)."""
        if min(x.shape[1], x.shape[2]) < self.min_input_size:
            # an undersized input gives an empty logits map and the GAN
            # losses (means over it) silently become NaN
            raise ValueError(
                f"input {x.shape[1]}x{x.shape[2]} too small for a {self.n_layers}-layer "
                f"PatchGAN (needs >= {self.min_input_size}); reduce n_layers")
        h = x
        for i in range(len(self.vars)):
            blk = self.main[str(i)]
            h = blk["conv"](h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            if i > 0:
                h = blk["norm"](h, mesh)
            h = F.leaky_relu(h, 0.2)
        return self.main["out"]["conv"](h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
