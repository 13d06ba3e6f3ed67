"""GroupNorm(+SiLU), forward and backward: plain PyTorch versions and the
kernels' wrappers.

Replaces the TPU kernels ``_pallas_gn`` (forward: ``_fwd_kernel`` with
``_stats`` and ``_group_avg_matrix``) and ``_pallas_gn_bwd`` (backward:
``_bwd_kernel``) of ``diff_pruning_tpu/ops/group_norm.py``, which normalise
one sample's (N, C) NHWC slab per grid step inside VMEM.

On the H100 both directions are bound by device-memory bytes: a handful of
flops per element and no tensor-core work; at the UNet's sizes a call's
fixed host and launch cost is of the same order as its bytes.

forward (CUDA C++, ``csrc/group_norm_fwd.cu``), one launch a call, like the
TPU kernel: one block per (sample, run of whole groups) copies its slab
from device memory once into shared memory, takes the statistics there in
f32 (the shifted variance for f32 inputs, as the layer does), then writes y
once, with SiLU if asked; under autograd it also writes the (B, G) mean and
rstd, which the backward reads instead of recomputing. A slab beyond the
block's shared memory is taken in chunks (one launch still; x is read a
second time, from L2). The wrapper's host path is one allocation for y
(plus one (2, B, G) buffer for the statistics) and one ``ctypes`` call.

backward (Triton, ``_group_norm_triton.py``; ``_pallas_gn_bwd``'s math,
``group_norm.py:74-102`` there)
1. ``gn_bwd_reduce_kernel``: per (sample, run of whole groups), with the SiLU
   derivative chained first on a recomputed ``z = xhat * gamma + beta``,
   the (B, C) partials ``dscale = sum dy * xhat`` and ``dbias = sum dy``, and
   per group ``gm1 = mean(dy * gamma)`` and ``gm2 = mean(dy * gamma * xhat)``;
2. ``gn_bwd_apply_kernel``: ``dx = rstd * (dy * gamma - gm1 - xhat * gm2)``.
   The batch sum of the partials is a torch sum, as in the JAX package.

The kernels work at any slab size and any channels-per-group count (3, 5,
7, 12: masked, not padded), so there is no counterpart of the TPU kernel's
VMEM fallback: for a CUDA tensor the wrapper always launches the kernels.
They read x and dy through their strides, so a tensor whose (B, H*W, C)
view is not contiguous is read correctly (``reshape`` copies only where no
view exists).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIB = []


def group_norm_stats_reference(x: torch.Tensor, groups: int, eps: float = 1e-6):
    """Per-(sample, group) mean and rstd, (B, G) f32, of (B, ..., C): the
    statistics of :func:`group_norm_reference`.

    f32/f64 inputs use the shifted variance anchored at each channel's first
    spatial element (E[x^2]-E[x]^2 cancels when mean^2 >> var); bf16/f16
    inputs use the plain one-pass sum and sum of squares.
    """
    b, c = x.shape[0], x.shape[-1]
    g = groups
    xf = x.to(torch.float32).reshape(b, -1, c)
    n_spatial = xf.shape[1]
    n_per_group = (c // g) * n_spatial
    shifted = x.dtype in (torch.float32, torch.float64)
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
    return mean, torch.rsqrt(var.clamp_min(0.0) + eps)


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                         groups: int, eps: float = 1e-6,
                         with_silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over the last axis of (B, ..., C): the JAX layer's math
    (``diff_pruning_tpu/models/layers.py`` ``GroupNorm.__call__``), with
    statistics in f32 whatever the input dtype
    (:func:`group_norm_stats_reference`)."""
    b, c = x.shape[0], x.shape[-1]
    cpg = c // groups
    mean, inv = group_norm_stats_reference(x, groups, eps)
    a = scale.to(torch.float32) * inv.repeat_interleave(cpg, dim=-1)
    bb = bias.to(torch.float32) - mean.repeat_interleave(cpg, dim=-1) * a
    y = x.to(torch.float32).reshape(b, -1, c) * a[:, None, :] + bb[:, None, :]
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)


def group_norm_backward_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                  dy: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, *,
                                  groups: int, with_silu: bool = False):
    """(dx, dscale, dbias) of :func:`group_norm_reference` given the forward's
    (B, G) ``mean`` and ``rstd``: the TPU backward's formula
    (``diff_pruning_tpu/ops/group_norm.py:74-102``) step by step, in f32.
    dx has x's shape and dtype; dscale and dbias have scale's and bias's."""
    b, c = x.shape[0], x.shape[-1]
    cpg = c // groups
    xf = x.to(torch.float32).reshape(b, -1, c)
    dyf = dy.to(torch.float32).reshape(b, -1, c)
    n = xf.shape[1]
    gamma = scale.to(torch.float32)
    mean_c = mean.repeat_interleave(cpg, dim=-1)[:, None, :]
    rstd_c = rstd.repeat_interleave(cpg, dim=-1)[:, None, :]
    xhat = (xf - mean_c) * rstd_c
    if with_silu:
        z = xhat * gamma + bias.to(torch.float32)
        sig = torch.sigmoid(z)
        dyf = dyf * (sig * (1.0 + z * (1.0 - sig)))
    dscale = (dyf * xhat).sum((0, 1))
    dbias = dyf.sum((0, 1))
    dyg = dyf * gamma

    def gmean(v):  # (B, N, C) -> per-channel-broadcast group mean (B, 1, C)
        s = v.sum(1).reshape(b, groups, cpg).sum(-1) / (n * cpg)
        return s.repeat_interleave(cpg, dim=-1)[:, None, :]

    dx = rstd_c * (dyg - gmean(dyg) - xhat * gmean(dyg * xhat))
    return dx.to(x.dtype).reshape(x.shape), dscale.to(scale.dtype), dbias.to(bias.dtype)


class _GroupNormFn(torch.autograd.Function):
    """GroupNorm(+SiLU) with the hand-written backward. A CPU tensor runs the
    plain versions of both directions; a CUDA tensor launches the kernels."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, with_silu):
        if x.device.type == "cpu":
            mean, rstd = group_norm_stats_reference(x, groups, eps)
            y = group_norm_reference(x, scale, bias, groups=groups, eps=eps,
                                     with_silu=with_silu)
        else:
            y, mean, rstd = _launch(x, scale, bias, groups, eps, with_silu, save_stats=True)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.groups, ctx.with_silu = groups, with_silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dscale, dbias = group_norm_backward_reference(
                x, scale, bias, dy, mean, rstd, groups=ctx.groups, with_silu=ctx.with_silu)
        else:
            dx, dscale, dbias = group_norm_backward(x, scale, bias, dy, mean, rstd,
                                                    groups=ctx.groups, with_silu=ctx.with_silu)
        return dx, dscale, dbias, None, None, None


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               groups: int, eps: float = 1e-6, with_silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over the last axis of (B, ..., C).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (or raises on what they do not take). When autograd records
    (grad enabled and an input requires grad) the op is a
    ``torch.autograd.Function`` whose forward also saves the group
    statistics and whose backward is the backward kernel (plain versions on
    the CPU). Returns a contiguous tensor of x's shape and dtype.
    """
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GroupNormFn.apply(x, scale, bias, groups, float(eps), with_silu)
    if x.device.type in ("cpu", "meta"):  # meta: shapes only (MAC counting)
        return group_norm_reference(x, scale, bias, groups=groups, eps=eps,
                                    with_silu=with_silu)
    return _launch(x, scale, bias, groups, float(eps), with_silu)


def group_norm_forward_with_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                  *, groups: int, eps: float = 1e-6, with_silu: bool = False):
    """``(y, mean, rstd)``: the forward kernel as autograd runs it (it also
    writes the (B, G) statistics). CUDA tensors only."""
    return _launch(x, scale, bias, groups, float(eps), with_silu, save_stats=True)


def group_norm_backward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        dy: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, *,
                        groups: int, with_silu: bool = False):
    """(dx, dscale, dbias) by the backward kernels: the counterpart of
    :func:`group_norm_backward_reference` for CUDA tensors (raises on others)."""
    _check(x, scale, bias, groups)
    b, c = x.shape[0], x.shape[-1]
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"group_norm backward: dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    for t in (mean, rstd):
        if t.shape != (b, groups) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("group_norm backward: mean/rstd must be contiguous (B, G) f32")
    from ._build import group_norm_kernels

    k = group_norm_kernels()
    x3 = x.reshape(b, -1, c)
    dy3 = dy.reshape(b, -1, c)
    n = x3.shape[1]
    cpg = c // groups
    gpp, block_n, block_c = _stats_tiles(n, cpg, groups)
    dscale_b = torch.empty((b, c), dtype=torch.float32, device=x.device)
    dbias_b = torch.empty((b, c), dtype=torch.float32, device=x.device)
    gm1 = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    gm2 = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    dx = torch.empty((b, n, c), dtype=x.dtype, device=x.device)
    apply_n, apply_c = _apply_tiles(n, c)
    with torch.cuda.device(x.device):
        k.gn_bwd_reduce_kernel[(b, _cdiv(groups, gpp))](
            x3, dy3, scale, bias, mean, rstd, dscale_b, dbias_b, gm1, gm2,
            n, c, groups, cpg, gpp, *x3.stride(), *dy3.stride(),
            WITH_SILU=with_silu, BLOCK_N=block_n, BLOCK_C=block_c,
            GROUPS_PAD=_next_pow2(gpp), num_warps=4)
        k.gn_bwd_apply_kernel[(b, _cdiv(n, apply_n), _cdiv(c, apply_c))](
            x3, dy3, dx, scale, bias, mean, rstd, gm1, gm2, n, c, groups, cpg,
            *x3.stride(), *dy3.stride(),
            WITH_SILU=with_silu, BLOCK_N=apply_n, BLOCK_C=apply_c, num_warps=4)
    LAUNCHES["group_norm_bwd"] += 1
    return (dx.view(x.shape), dscale_b.sum(0).to(scale.dtype),
            dbias_b.sum(0).to(bias.dtype))


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _stats_tiles(n: int, cpg: int, groups: int):
    """A reduce program owns whole groups: about 64 channels, masked to
    a power of 2; (groups per program, BLOCK_N, BLOCK_C)."""
    gpp = min(groups, max(1, 64 // cpg))
    block_c = _next_pow2(gpp * cpg)
    return gpp, max(16, min(_next_pow2(n), 4096 // block_c)), block_c


def _apply_tiles(n: int, c: int):
    apply_c = min(128, _next_pow2(c))
    return max(16, min(_next_pow2(n), 4096 // apply_c)), apply_c


def _check(x, scale, bias, groups):
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: no kernel for device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"group_norm kernel takes {KERNEL_DTYPES}, got {x.dtype}")
    c = x.shape[-1]
    if x.dim() < 3 or c % groups:
        raise ValueError(f"group_norm: shape {tuple(x.shape)} with {groups} groups")
    for t in (scale, bias):
        if t.shape != (c,) or t.device != x.device or not t.is_contiguous():
            raise ValueError("group_norm: scale/bias must be contiguous (C,) on x's device")


def _lib():
    if not _LIB:
        from ._build import load_library

        lib = load_library("group_norm_fwd")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.group_norm_fwd.argtypes = ([ptr] * 5 + [i32] * 5 + [i64] * 3
                                       + [ctypes.c_float, i32, ptr])
        lib.group_norm_fwd.restype = i32
        _LIB.append(lib.group_norm_fwd)
    return _LIB[0]


def _slab(x):
    """``(x3, n, strides)``: x as (B, N, C) through its strides. A view where
    the spatial dims merge (always, for the layer's input); a copy otherwise."""
    sh, st = x.shape, x.stride()
    n = 1
    for i in range(1, x.dim() - 1):
        n *= sh[i]
        if i > 1 and st[i - 1] != st[i] * sh[i]:
            x = x.reshape(sh[0], -1, sh[-1])
            return x, n * math.prod(sh[i + 1:-1]), x.stride()
    return x, n, (st[0], st[-2], st[-1])


def _launch(x, scale, bias, groups, eps, with_silu, save_stats=False):
    """One launch of the forward kernel. Kept lean: it runs 51 times a UNet
    forward, and its host time is of the order of the kernel's."""
    _check(x, scale, bias, groups)
    x3, n, strides = _slab(x)
    dev = x.device
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    stats = torch.empty((2, x.shape[0], groups), dtype=torch.float32,
                        device=dev) if save_stats else None
    if scale.dtype != torch.float32:
        scale, bias = scale.float(), bias.float()
    args = (x3.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            stats.data_ptr() if save_stats else None, _DTYPE_CODES[x.dtype], x.shape[0], n,
            x.shape[-1], groups, *strides, eps, with_silu)
    if dev.index == torch._C._cuda_getDevice():
        err = _lib()(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = _lib()(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"group_norm_fwd launch failed: CUDA error {err}")
    LAUNCHES["group_norm"] += 1
    if save_stats:
        return y, stats[0], stats[1]
    return y


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b
