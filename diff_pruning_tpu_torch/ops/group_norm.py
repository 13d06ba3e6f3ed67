"""GroupNorm(+SiLU) forward: plain PyTorch version and the Triton kernel's wrapper.

Replaces the TPU kernel ``_pallas_gn`` (``diff_pruning_tpu/ops/group_norm.py``:
``_fwd_kernel`` with ``_stats`` and ``_group_avg_matrix``), which normalises
one sample's (N, C) NHWC slab per grid step inside VMEM.

On the H100 the op is bound by device-memory bytes: it does a handful of
flops per element and never touches the tensor cores. The Triton kernels
(``_group_norm_triton.py``) therefore stream x in coalesced (rows, channels)
tiles with channels contiguous, keep every statistic in f32 registers, and
write nothing but two (B, C) coefficient rows between their two passes:

1. ``gn_stats_kernel``: one program per (sample, run of whole groups) sums
   each channel over H*W (shifted by the channel's first element for f32
   inputs, as the layer does), combines channels into groups in registers,
   and writes per-(b, c) coefficients ``a = scale * inv`` and
   ``b = bias - mean * a``;
2. ``gn_apply_kernel``: ``y = x * a + b``, SiLU if asked, cast back.

The pair works at any slab size, so there is no counterpart of the TPU
kernel's VMEM fallback: for a CUDA tensor the wrapper always launches the
kernels. It reads x through its strides, so a tensor whose (B, H*W, C) view
is not contiguous is read correctly (``reshape`` copies only where no view
exists).
"""

from __future__ import annotations

import torch

from . import LAUNCHES

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                         groups: int, eps: float = 1e-6,
                         with_silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over the last axis of (B, ..., C): the JAX layer's math
    (``diff_pruning_tpu/models/layers.py`` ``GroupNorm.__call__``).

    Statistics in f32 whatever the input dtype. f32/f64 inputs use the
    shifted variance anchored at each channel's first spatial element
    (E[x^2]-E[x]^2 cancels when mean^2 >> var); bf16/f16 inputs use the plain
    one-pass sum and sum of squares.
    """
    orig_dtype = x.dtype
    b, c = x.shape[0], x.shape[-1]
    g = groups
    xf = x.to(torch.float32).reshape(b, -1, c)
    n_spatial = xf.shape[1]
    n_per_group = (c // g) * n_spatial
    shifted = orig_dtype in (torch.float32, torch.float64)
    if shifted:
        m0 = xf[:, 0, :]
        d = xf - m0[:, None, :]
    else:
        d = xf
    s1g = d.sum(1).reshape(b, g, c // g)
    s2g = (d * d).sum(1).reshape(b, g, c // g)
    if shifted:
        m0g = m0.reshape(b, g, c // g)
        mean = (s1g.sum(-1) + n_spatial * m0g.sum(-1)) / n_per_group
        delta = m0g - mean[..., None]
        var = (s2g + 2.0 * delta * s1g + n_spatial * delta * delta).sum(-1) / n_per_group
    else:
        mean = s1g.sum(-1) / n_per_group
        var = s2g.sum(-1) / n_per_group - mean * mean
    inv = torch.rsqrt(var.clamp_min(0.0) + eps)                  # (B, g)
    a = scale.to(torch.float32) * inv.repeat_interleave(c // g, dim=-1)
    bb = bias.to(torch.float32) - mean.repeat_interleave(c // g, dim=-1) * a
    y = xf * a[:, None, :] + bb[:, None, :]
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.to(orig_dtype).reshape(x.shape)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               groups: int, eps: float = 1e-6, with_silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over the last axis of (B, ..., C).

    A CPU tensor takes the plain version; a CUDA tensor launches the Triton
    kernels (or raises on what they do not take). Returns a contiguous
    tensor of x's shape and dtype.
    """
    if x.device.type == "cpu":
        return group_norm_reference(x, scale, bias, groups=groups, eps=eps,
                                    with_silu=with_silu)
    return _launch(x, scale, bias, groups, float(eps), with_silu)


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _launch(x, scale, bias, groups, eps, with_silu):
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: no kernel for device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"group_norm kernel takes {KERNEL_DTYPES}, got {x.dtype}")
    b, c = x.shape[0], x.shape[-1]
    if x.dim() < 3 or c % groups:
        raise ValueError(f"group_norm: shape {tuple(x.shape)} with {groups} groups")
    for t in (scale, bias):
        if t.shape != (c,) or t.device != x.device or not t.is_contiguous():
            raise ValueError("group_norm: scale/bias must be contiguous (C,) on x's device")
    from ._build import group_norm_kernels

    k = group_norm_kernels()
    x3 = x.reshape(b, -1, c)
    n = x3.shape[1]
    cpg = c // groups
    # a stats program owns whole groups: about 64 channels, masked to a power of 2
    gpp = min(groups, max(1, 64 // cpg))
    block_c = _next_pow2(gpp * cpg)
    block_n = max(16, min(_next_pow2(n), 4096 // block_c))
    coef_a = torch.empty((b, c), dtype=torch.float32, device=x.device)
    coef_b = torch.empty((b, c), dtype=torch.float32, device=x.device)
    y = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
    apply_c = min(128, _next_pow2(c))
    apply_n = max(16, min(_next_pow2(n), 4096 // apply_c))
    with torch.cuda.device(x.device):
        k.gn_stats_kernel[(b, _cdiv(groups, gpp))](
            x3, scale, bias, coef_a, coef_b, n, c, cpg, gpp,
            x3.stride(0), x3.stride(1), x3.stride(2), eps,
            SHIFTED=x.dtype == torch.float32, BLOCK_N=block_n, BLOCK_C=block_c,
            GROUPS_PAD=_next_pow2(gpp), num_warps=4)
        k.gn_apply_kernel[(b, _cdiv(n, apply_n), _cdiv(c, apply_c))](
            x3, y, coef_a, coef_b, n, c,
            x3.stride(0), x3.stride(1), x3.stride(2),
            WITH_SILU=with_silu, BLOCK_N=apply_n, BLOCK_C=apply_c, num_warps=4)
    LAUNCHES["group_norm"] += 1
    return y.view(x.shape)


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b
