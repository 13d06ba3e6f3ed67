"""Triton kernels of the GroupNorm(+SiLU) forward (see ``group_norm.py``).

This module imports ``triton`` at its top, so only ``_build.group_norm_kernels``
imports it, on the first launch for a CUDA tensor.

x is read as a (B, N, C) view through its strides; the output y is a
contiguous (B, N, C) tensor; the coefficients a and b are contiguous (B, C)
f32.
"""

import triton
import triton.language as tl


@triton.jit
def gn_stats_kernel(x_ptr, scale_ptr, bias_ptr, a_ptr, b_ptr,
                    N, C, cpg, gpp, stride_b, stride_n, stride_c, eps,
                    SHIFTED: tl.constexpr, BLOCK_N: tl.constexpr,
                    BLOCK_C: tl.constexpr, GROUPS_PAD: tl.constexpr):
    """One program per (sample, run of ``gpp`` whole groups of ``cpg`` channels)."""
    pid_b = tl.program_id(0)
    pid_g = tl.program_id(1)
    cc = tl.arange(0, BLOCK_C)
    ch = pid_g * gpp * cpg + cc
    cmask = (cc < gpp * cpg) & (ch < C)
    xb = x_ptr + pid_b.to(tl.int64) * stride_b
    if SHIFTED:
        # anchor each channel at its first spatial element (layers.py)
        m0 = tl.load(xb + ch * stride_c, mask=cmask, other=0.0).to(tl.float32)
    else:
        m0 = tl.zeros([BLOCK_C], dtype=tl.float32)
    acc1 = tl.zeros([BLOCK_N, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_N, BLOCK_C], dtype=tl.float32)
    rows = tl.arange(0, BLOCK_N)
    for n0 in range(0, N, BLOCK_N):
        r = n0 + rows
        m = (r < N)[:, None] & cmask[None, :]
        ptrs = xb + r[:, None].to(tl.int64) * stride_n + ch[None, :] * stride_c
        x = tl.load(ptrs, mask=m, other=0.0).to(tl.float32)
        d = tl.where(m, x - m0[None, :], 0.0)
        acc1 += d
        acc2 += d * d
    s1 = tl.sum(acc1, axis=0)
    s2 = tl.sum(acc2, axis=0)

    # channels -> groups in registers: member[g, c] says channel c is in group g
    gi = tl.arange(0, GROUPS_PAD)
    member = ((cc // cpg)[None, :] == gi[:, None]) & cmask[None, :]
    n_spatial = N * 1.0
    n_per_group = n_spatial * cpg
    s1g = tl.sum(tl.where(member, s1[None, :], 0.0), axis=1)
    if SHIFTED:
        m0g = tl.sum(tl.where(member, m0[None, :], 0.0), axis=1)
        mean = (s1g + n_spatial * m0g) / n_per_group
        delta = m0 - tl.sum(tl.where(member, mean[:, None], 0.0), axis=0)
        per_c = s2 + 2.0 * delta * s1 + n_spatial * delta * delta
        var = tl.sum(tl.where(member, per_c[None, :], 0.0), axis=1) / n_per_group
    else:
        mean = s1g / n_per_group
        s2g = tl.sum(tl.where(member, s2[None, :], 0.0), axis=1)
        var = s2g / n_per_group - mean * mean
    inv = 1.0 / tl.sqrt(tl.maximum(var, 0.0) + eps)
    inv_c = tl.sum(tl.where(member, inv[:, None], 0.0), axis=0)
    mean_c = tl.sum(tl.where(member, mean[:, None], 0.0), axis=0)
    scale = tl.load(scale_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
    bias = tl.load(bias_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
    a = scale * inv_c
    tl.store(a_ptr + pid_b * C + ch, a, mask=cmask)
    tl.store(b_ptr + pid_b * C + ch, bias - mean_c * a, mask=cmask)


@triton.jit
def gn_apply_kernel(x_ptr, y_ptr, a_ptr, b_ptr, N, C, stride_b, stride_n, stride_c,
                    WITH_SILU: tl.constexpr, BLOCK_N: tl.constexpr,
                    BLOCK_C: tl.constexpr):
    """y = x * a + b (then SiLU) over one (BLOCK_N, BLOCK_C) tile of one sample."""
    pid_b = tl.program_id(0)
    r = tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)
    ch = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = ch < C
    m = (r < N)[:, None] & cmask[None, :]
    xp = (x_ptr + pid_b.to(tl.int64) * stride_b
          + r[:, None].to(tl.int64) * stride_n + ch[None, :] * stride_c)
    x = tl.load(xp, mask=m, other=0.0).to(tl.float32)
    a = tl.load(a_ptr + pid_b * C + ch, mask=cmask, other=0.0)
    b = tl.load(b_ptr + pid_b * C + ch, mask=cmask, other=0.0)
    y = x * a[None, :] + b[None, :]
    if WITH_SILU:
        y = y / (1.0 + tl.exp(-y))
    yp = y_ptr + (pid_b.to(tl.int64) * N + r[:, None]) * C + ch[None, :]
    tl.store(yp, y.to(y_ptr.dtype.element_ty), mask=m)
