"""Triton kernels of the GroupNorm(+SiLU) backward (see ``group_norm.py``; the
forward is CUDA C++, ``csrc/group_norm_fwd.cu``).

This module imports ``triton`` at its top, so only ``_build.group_norm_kernels``
imports it, on the first launch for a CUDA tensor.

x and dy are read as (B, N, C) views through their strides; the output dx
is a contiguous (B, N, C) tensor; the per-(b, c) dscale and dbias partials
are contiguous (B, C) f32; per-(b, group) rows (the forward's mean and rstd,
and the two group means) are contiguous (B, G) f32.
"""

import triton
import triton.language as tl


@triton.jit
def _silu_grad(dy, xhat, gamma, beta):
    """dy * d silu(z)/dz at z = xhat * gamma + beta (z recomputed, as the TPU
    kernel does)."""
    z = xhat * gamma[None, :] + beta[None, :]
    sig = 1.0 / (1.0 + tl.exp(-z))
    return dy * (sig * (1.0 + z * (1.0 - sig)))


@triton.jit
def gn_bwd_reduce_kernel(x_ptr, dy_ptr, scale_ptr, bias_ptr, mean_ptr, rstd_ptr,
                         dscale_ptr, dbias_ptr, gm1_ptr, gm2_ptr,
                         N, C, G, cpg, gpp, sx_b, sx_n, sx_c, sd_b, sd_n, sd_c,
                         WITH_SILU: tl.constexpr, BLOCK_N: tl.constexpr,
                         BLOCK_C: tl.constexpr, GROUPS_PAD: tl.constexpr):
    """One program per (sample, run of ``gpp`` whole groups). Per channel it
    sums dy and dy * xhat over N (the (B, C) dbias and dscale partials); per
    group it forms the means of dy * gamma and dy * gamma * xhat that the
    apply pass subtracts."""
    pid_b = tl.program_id(0)
    pid_g = tl.program_id(1)
    cc = tl.arange(0, BLOCK_C)
    ch = pid_g * gpp * cpg + cc
    cmask = (cc < gpp * cpg) & (ch < C)
    grp_c = ch // cpg
    mean = tl.load(mean_ptr + pid_b * G + grp_c, mask=cmask, other=0.0)
    rstd = tl.load(rstd_ptr + pid_b * G + grp_c, mask=cmask, other=0.0)
    gamma = tl.load(scale_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
    beta = tl.load(bias_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
    xb = x_ptr + pid_b.to(tl.int64) * sx_b
    db = dy_ptr + pid_b.to(tl.int64) * sd_b
    acc_dy = tl.zeros([BLOCK_N, BLOCK_C], dtype=tl.float32)
    acc_dyx = tl.zeros([BLOCK_N, BLOCK_C], dtype=tl.float32)
    rows = tl.arange(0, BLOCK_N)
    for n0 in range(0, N, BLOCK_N):
        r = n0 + rows
        m = (r < N)[:, None] & cmask[None, :]
        r64 = r[:, None].to(tl.int64)
        x = tl.load(xb + r64 * sx_n + ch[None, :] * sx_c, mask=m, other=0.0).to(tl.float32)
        dy = tl.load(db + r64 * sd_n + ch[None, :] * sd_c, mask=m, other=0.0).to(tl.float32)
        xhat = (x - mean[None, :]) * rstd[None, :]
        if WITH_SILU:
            dy = _silu_grad(dy, xhat, gamma, beta)
        dy = tl.where(m, dy, 0.0)
        acc_dy += dy
        acc_dyx += dy * xhat
    s_dy = tl.sum(acc_dy, axis=0)
    s_dyx = tl.sum(acc_dyx, axis=0)
    tl.store(dbias_ptr + pid_b * C + ch, s_dy, mask=cmask)
    tl.store(dscale_ptr + pid_b * C + ch, s_dyx, mask=cmask)

    gi = tl.arange(0, GROUPS_PAD)
    member = ((cc // cpg)[None, :] == gi[:, None]) & cmask[None, :]
    n_per_group = N * 1.0 * cpg
    g1 = tl.sum(tl.where(member, (gamma * s_dy)[None, :], 0.0), axis=1) / n_per_group
    g2 = tl.sum(tl.where(member, (gamma * s_dyx)[None, :], 0.0), axis=1) / n_per_group
    grp = pid_g * gpp + gi
    gmask = (gi < gpp) & (grp < G)
    tl.store(gm1_ptr + pid_b * G + grp, g1, mask=gmask)
    tl.store(gm2_ptr + pid_b * G + grp, g2, mask=gmask)


@triton.jit
def gn_bwd_apply_kernel(x_ptr, dy_ptr, dx_ptr, scale_ptr, bias_ptr, mean_ptr, rstd_ptr,
                        gm1_ptr, gm2_ptr, N, C, G, cpg, sx_b, sx_n, sx_c, sd_b, sd_n, sd_c,
                        WITH_SILU: tl.constexpr, BLOCK_N: tl.constexpr,
                        BLOCK_C: tl.constexpr):
    """dx = rstd * (dy * gamma - gm1 - xhat * gm2) over one (BLOCK_N, BLOCK_C)
    tile of one sample (dy through the SiLU derivative first)."""
    pid_b = tl.program_id(0)
    r = tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)
    ch = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = ch < C
    m = (r < N)[:, None] & cmask[None, :]
    grp_c = ch // cpg
    mean = tl.load(mean_ptr + pid_b * G + grp_c, mask=cmask, other=0.0)
    rstd = tl.load(rstd_ptr + pid_b * G + grp_c, mask=cmask, other=0.0)
    g1 = tl.load(gm1_ptr + pid_b * G + grp_c, mask=cmask, other=0.0)
    g2 = tl.load(gm2_ptr + pid_b * G + grp_c, mask=cmask, other=0.0)
    gamma = tl.load(scale_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
    r64 = r[:, None].to(tl.int64)
    x = tl.load(x_ptr + pid_b.to(tl.int64) * sx_b + r64 * sx_n + ch[None, :] * sx_c,
                mask=m, other=0.0).to(tl.float32)
    dy = tl.load(dy_ptr + pid_b.to(tl.int64) * sd_b + r64 * sd_n + ch[None, :] * sd_c,
                 mask=m, other=0.0).to(tl.float32)
    xhat = (x - mean[None, :]) * rstd[None, :]
    if WITH_SILU:
        beta = tl.load(bias_ptr + ch, mask=cmask, other=0.0).to(tl.float32)
        dy = _silu_grad(dy, xhat, gamma, beta)
    dx = rstd[None, :] * (dy * gamma[None, :] - g1[None, :] - xhat * g2[None, :])
    dxp = dx_ptr + (pid_b.to(tl.int64) * N + r[:, None]) * C + ch[None, :]
    tl.store(dxp, dx.to(dx_ptr.dtype.element_ty), mask=m)
