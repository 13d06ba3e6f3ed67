"""Graph-registering layers: the main-path subset of ``diff_pruning_tpu/models/layers.py``.

Each layer is an ``nn.Module`` built with resolved channel sizes (pruned or
not). Construction registers the layer's parameter axes into a
:class:`~diff_pruning_tpu_torch.pruning.graph.ChannelGraph` under the JAX param
paths and axes, so ``channel_sizes`` and the graph mean the same in both
packages; the registered axes describe the checkpoint layout (HWIO conv
kernels, (din, dout) linear kernels), which ``utils/checkpoint.py`` maps to
the tensors held here (OIHW, (dout, din)).

Layout: activations are NCHW tensors in ``torch.channels_last`` memory, i.e.
physically NHWC like the JAX package's arrays, so cuDNN's convolutions and
the GroupNorm kernel read (B, H*W, C) contiguously. Parameters are named
``kernel``, ``bias`` and ``scale`` as in the JAX param tree.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..ops.attention import flash_attention, reference_attention
from ..ops.group_norm import group_norm, group_norm_reference
from ..pruning.graph import CatVar, ChannelGraph, ChannelVar, VarLike


class Scope:
    """Hierarchical path helper binding layers to graph param paths."""

    def __init__(self, graph: ChannelGraph, path: str = ""):
        self.graph = graph
        self.path = path

    def __call__(self, name: str) -> "Scope":
        return Scope(self.graph, f"{self.path}/{name}" if self.path else name)

    def ref(self, leaf: str, axis: int, var: VarLike, role: str) -> None:
        self.graph.ref(f"{self.path}/{leaf}" if self.path else leaf, axis, var, role)


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class Conv2D(nn.Module):
    """3x3/1x1 conv with symmetric padding; kernel (cout, cin, k, k)."""

    def __init__(self, scope: Scope, cin: VarLike, cout: ChannelVar, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, use_bias: bool = True, *, device):
        super().__init__()
        scope.ref("kernel", 2, cin, "in")
        scope.ref("kernel", 3, cout, "out")
        if use_bias:
            scope.ref("bias", 0, cout, "bias")
        self.stride, self.padding = stride, padding
        k = kernel_size
        self.kernel = nn.Parameter(torch.empty((cout.size, cin.size, k, k), device=device))
        self.bias = nn.Parameter(torch.empty((cout.size,), device=device)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch's default Conv2d init (kaiming_uniform a=sqrt(5)), as in JAX
        fan_in = self.kernel[0].numel()
        _uniform_(self.kernel, math.sqrt(3.0 / fan_in), generator)
        if self.bias is not None:
            _uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.kernel, self.bias, self.stride, self.padding)


class Linear(nn.Module):
    """Dense layer; kernel (dout, din)."""

    def __init__(self, scope: Scope, din: VarLike, dout: ChannelVar, use_bias: bool = True,
                 *, device):
        super().__init__()
        scope.ref("kernel", 0, din, "in")
        scope.ref("kernel", 1, dout, "out")
        if use_bias:
            scope.ref("bias", 0, dout, "bias")
        self.kernel = nn.Parameter(torch.empty((dout.size, din.size), device=device))
        self.bias = nn.Parameter(torch.empty((dout.size,), device=device)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.kernel.shape[1]
        _uniform_(self.kernel, math.sqrt(3.0 / fan_in), generator)
        if self.bias is not None:
            _uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.kernel, self.bias)


class GroupNorm(nn.Module):
    """GroupNorm over the channel axis (dim 1) of NCHW activations, optional SiLU.

    Registering tightens the var's group_div so pruning removes channels
    uniformly per group (on a concatenated input, each part's). The math,
    including the dtype gate on the variance formulation, is
    :func:`~diff_pruning_tpu_torch.ops.group_norm.group_norm_reference`; with
    the ``group_norm`` switch on, CUDA tensors go through the kernels, and
    under autograd the wrapper's ``torch.autograd.Function`` runs the
    backward kernel too (with it off, torch differentiates the plain math).
    """

    def __init__(self, scope: Scope, var: VarLike, num_groups: int, eps: float = 1e-6, *,
                 device):
        super().__init__()
        if isinstance(var, CatVar):
            for p in var.parts:
                p.require_group_div(num_groups)
        else:
            var.require_group_div(num_groups)
        scope.ref("scale", 0, var, "norm")
        scope.ref("bias", 0, var, "bias")
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones((var.size,), device=device))
        self.bias = nn.Parameter(torch.zeros((var.size,), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, with_silu: bool = False) -> torch.Tensor:
        fn = group_norm if ops.kernels_enabled("group_norm") else group_norm_reference
        y = fn(x.permute(0, 2, 3, 1), self.scale, self.bias, groups=self.num_groups,
               eps=self.eps, with_silu=with_silu)
        return y.permute(0, 3, 1, 2)


class SelfAttention2D(nn.Module):
    """Spatial self-attention (diffusers Attention with
    ``_from_deprecated_attn_block=True``): GN over channels, q/k/v/out
    Linear, f32 softmax, residual, ``rescale_output_factor``. ``inner`` is
    the shared q/k/v output ChannelVar; its group_div is the head count.
    With the ``attention`` switch on, the wrapper runs the forward kernel and,
    under autograd, the lse-writing forward and the backward kernels."""

    def __init__(self, scope: Scope, var: ChannelVar, inner: ChannelVar, heads: int = 1,
                 norm_num_groups: int = 32, eps: float = 1e-6,
                 rescale_output_factor: float = 1.0, *, device):
        super().__init__()
        inner.require_group_div(heads)
        self.inner, self.heads = inner, heads
        self.rescale_output_factor = rescale_output_factor
        self.group_norm = GroupNorm(scope("group_norm"), var, norm_num_groups, eps,
                                    device=device)
        self.to_q = Linear(scope("to_q"), var, inner, device=device)
        self.to_k = Linear(scope("to_k"), var, inner, device=device)
        self.to_v = Linear(scope("to_v"), var, inner, device=device)
        self.to_out = Linear(scope("to_out"), inner, var, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        tokens = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        inner = self.inner.size
        dim_head = inner // self.heads

        def split_heads(t):  # (B, N, inner) -> (B, heads, N, dim_head) view
            return t.view(b, h * w, self.heads, dim_head).transpose(1, 2)

        q = split_heads(self.to_q(tokens))
        k = split_heads(self.to_k(tokens))
        v = split_heads(self.to_v(tokens))
        fn = flash_attention if ops.kernels_enabled("attention") else reference_attention
        out = fn(q, k, v, dim_head ** -0.5)
        out = self.to_out(out.transpose(1, 2).reshape(b, h * w, inner))
        out = out.view(b, h, w, c).permute(0, 3, 1, 2) + x
        if self.rescale_output_factor != 1.0:
            out = out / self.rescale_output_factor
        return out


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = False,
                           downscale_freq_shift: float = 1.0, scale: float = 1.0,
                           max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal DDPM timestep embedding, f32 (embeddings.py:22-62)."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.to(torch.float32)[:, None] * torch.exp(exponent)[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NCHW (resnet.py:155)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def downsample_pad(x: torch.Tensor) -> torch.Tensor:
    """Asymmetric (0,1,0,1) spatial pad used by Downsample2D when
    downsample_padding == 0 (resnet.py:213-215): one row below, one column
    to the right."""
    return F.pad(x, (0, 1, 0, 1))
