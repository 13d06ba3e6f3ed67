"""The port's kernels, forward and backward, against their plain versions,
on an NVIDIA GPU.

Marked ``cuda``: without a card each test skips. On a machine with one:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` because tests/conftest.py imports jax, which a GPU machine
running only the port need not have.)

Tolerances, |kernel - plain| <= atol + rtol * |plain|:
- f32: 1e-4 + 1e-4 rel. Both sides compute in f32 and differ only in the
  order of their sums (TF32 is switched off for the plain matmuls).
- bf16: 1e-2 + 1.6e-2 rel, two bf16 ulps; f16: 1e-3 + 2e-3 rel, two f16
  ulps. Both round their f32 result to the output type once; both
  attention versions also round their probabilities to it before the PV
  product (the plain one after normalising, the kernel before).
- statistics (GroupNorm mean and rstd, attention lse), f32 whatever the
  input type: |kernel - plain| <= 1e-4 * max|plain|, as in the backward.
- backward: |kernel - plain| <= tol * max|plain| per output, tol 1e-4 (f32)
  and 2e-2 (bf16): both compute in f32 from the same inputs and statistics
  and differ in summation order, then round once to the output dtype.
"""

import pytest
import torch

from diff_pruning_tpu_torch import ops
from diff_pruning_tpu_torch.ops import attention as A
from diff_pruning_tpu_torch.ops import group_norm as G
from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1.6e-2),
       torch.float16: (1e-3, 2e-3)}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, want, dtype, what):
    atol, rtol = TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape, what
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    assert bool((err <= bound).all()), f"{what}: max abs err {err.max().item():.3e}"


@pytest.mark.cuda
def test_group_norm_kernel_matches_plain(cuda):
    """y, and the (B, G) statistics the forward writes under autograd."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    # (B, N, C, groups, silu): C/g = 4, 12, 16, 5 and 3, the pruned 2, 7 and
    # 10, N ragged to the tiles, and a slab beyond one block's shared memory
    cases = [(4, 1024, 128, 32, True), (4, 256, 384, 32, True), (4, 16, 512, 32, False),
             (3, 64, 160, 32, True), (2, 100, 96, 32, False), (2, 7, 24, 8, True),
             (2, 256, 64, 32, True), (2, 64, 224, 32, True), (2, 16, 320, 32, False),
             (2, 4096, 512, 32, True)]
    for b, n, c, g, silu in cases:
        for dtype in TOL:
            x = (torch.randn((b, n, c), generator=gen, device=cuda) * 2 + 0.5).to(dtype)
            scale = torch.rand((c,), generator=gen, device=cuda) + 0.5
            bias = torch.randn((c,), generator=gen, device=cuda) * 0.1
            what = f"gn {(b, n, c, g, silu)} {dtype}"
            before = ops.LAUNCHES["group_norm"]
            got = group_norm(x, scale, bias, groups=g, with_silu=silu)
            assert ops.LAUNCHES["group_norm"] == before + 1
            want = group_norm_reference(x, scale, bias, groups=g, with_silu=silu)
            _check(got, want, dtype, what)
            y, mean, rstd = G.group_norm_forward_with_stats(x, scale, bias, groups=g,
                                                            with_silu=silu)
            assert torch.equal(y, got), what + " y with stats"
            pmean, prstd = G.group_norm_stats_reference(x, g)
            _check_rel(mean, pmean, torch.float32, what + " mean")
            _check_rel(rstd, prstd, torch.float32, what + " rstd")
    # the layer's input: the channel-last view of an NCHW tensor, contiguous
    # (strides (C*H*W, 1, H*W) as (B, N, C)) or channels_last ((B, N, C) contiguous)
    scale, bias = torch.rand(64, device=cuda) + 0.5, torch.randn(64, device=cuda) * 0.1
    for dtype in TOL:
        for fmt in (torch.contiguous_format, torch.channels_last):
            x = torch.randn((2, 64, 8, 8), generator=gen, device=cuda).to(dtype)
            x = x.contiguous(memory_format=fmt).permute(0, 2, 3, 1)
            _check(group_norm(x, scale, bias, groups=32, with_silu=True), group_norm_reference(
                x, scale, bias, groups=32, with_silu=True), dtype, f"gn layer input {fmt} {dtype}")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_flash_attention_kernel_matches_plain(cuda):
    """o, and the lse the forward writes under autograd."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    # (B, H, Nq, Nkv, D): the UNet's (256, 256) and (16, 256), a pruned D, a
    # ragged N, several heads, cross-attention lengths, D = 8 and 40, and
    # Nq != Nkv past one kv tile
    cases = [(4, 1, 256, 256, 256), (4, 1, 16, 16, 256), (2, 1, 256, 256, 179),
             (2, 1, 100, 100, 64), (2, 4, 70, 70, 32), (2, 2, 33, 77, 56),
             (2, 2, 40, 40, 8), (2, 3, 64, 64, 40), (1, 1, 300, 130, 256)]
    for b, h, nq, nkv, d in cases:
        for dtype in TOL:
            q, k, v = (torch.randn((b, h, n, d), generator=gen, device=cuda).to(dtype)
                       for n in (nq, nkv, nkv))
            what = f"attention {(b, h, nq, nkv, d)} {dtype}"
            before = ops.LAUNCHES["attention"]
            got = flash_attention(q, k, v, d ** -0.5)
            assert ops.LAUNCHES["attention"] == before + 1
            want = reference_attention(q, k, v, d ** -0.5)
            _check(got, want, dtype, what)
            o, lse = A.flash_attention_forward_lse(q, k, v, d ** -0.5)
            assert torch.equal(o, got), what + " o with lse"
            _check_rel(lse, A.reference_attention_lse(q, k, v, d ** -0.5)[1], torch.float32,
                       what + " lse")
    # head-split views of (B, N, heads*dh) projections, as the layer passes
    # them (dh = 179: rows not 16-byte aligned), and a head dim cut from a
    # wider tensor (D = 37 of 64)
    for dtype in TOL:
        for heads, dh in ((4, 40), (1, 179)):
            t = torch.randn((2, 64, 3 * heads * dh), generator=gen, device=cuda).to(dtype)
            q, k, v = (z.view(2, 64, heads, dh).transpose(1, 2)
                       for z in t.split(heads * dh, dim=-1))
            _check(flash_attention(q, k, v, dh ** -0.5), reference_attention(q, k, v, dh ** -0.5),
                   dtype, f"attention strided {heads}x{dh} {dtype}")
        q, k, v = (torch.randn((2, 2, 50, 64), generator=gen, device=cuda).to(dtype)[..., :37]
                   for _ in range(3))
        _check(flash_attention(q, k, v, 37 ** -0.5), reference_attention(q, k, v, 37 ** -0.5),
               dtype, f"attention D=37 of 64 {dtype}")
    torch.cuda.synchronize()


def _check_rel(got, want, dtype, what):
    assert got.shape == want.shape, what
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert bool(torch.isfinite(got.float()).all()) and err <= BWD_TOL[dtype] * scale, \
        f"{what}: max abs err {err:.3e} against max |want| {scale:.3e}"


@pytest.mark.cuda
def test_group_norm_backward_kernel_matches_plain(cuda):
    """The forward's saved statistics and the backward kernels against the
    plain versions, then one autograd step through the layer op."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    cases = [(4, 1024, 128, 32, True), (4, 256, 384, 32, True), (4, 16, 512, 32, False),
             (3, 64, 160, 32, True), (2, 100, 96, 32, False), (2, 35, 40, 8, True)]
    for b, n, c, g, silu in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((b, n, c), generator=gen, device=cuda) * 2 + 0.5).to(dtype)
            dy = torch.randn((b, n, c), generator=gen, device=cuda).to(dtype)
            scale = torch.rand((c,), generator=gen, device=cuda) + 0.5
            bias = torch.randn((c,), generator=gen, device=cuda) * 0.1
            what = f"gn bwd {(b, n, c, g, silu)} {dtype}"
            y, mean, rstd = G.group_norm_forward_with_stats(x, scale, bias, groups=g,
                                                            with_silu=silu)
            pmean, prstd = G.group_norm_stats_reference(x, g)
            _check_rel(mean, pmean, torch.float32, what + " mean")
            _check_rel(rstd, prstd, torch.float32, what + " rstd")
            before = ops.LAUNCHES["group_norm_bwd"]
            got = G.group_norm_backward(x, scale, bias, dy, pmean, prstd, groups=g,
                                        with_silu=silu)
            assert ops.LAUNCHES["group_norm_bwd"] == before + 1
            want = G.group_norm_backward_reference(x, scale, bias, dy, pmean, prstd,
                                                   groups=g, with_silu=silu)
            for a, w, name in zip(got, want, ("dx", "dscale", "dbias")):
                assert a.dtype == w.dtype, what + name
                _check_rel(a, w, dtype, f"{what} {name}")
    x = torch.randn((2, 64, 8, 8), generator=gen, device=cuda, requires_grad=True)
    scale = torch.ones(64, device=cuda, requires_grad=True)
    bias = torch.zeros(64, device=cuda, requires_grad=True)
    xr = x.detach().clone().requires_grad_()
    before = dict(ops.LAUNCHES)
    group_norm(x.permute(0, 2, 3, 1), scale, bias, groups=32, with_silu=True).sum().backward()
    assert ops.LAUNCHES["group_norm"] == before["group_norm"] + 1
    assert ops.LAUNCHES["group_norm_bwd"] == before["group_norm_bwd"] + 1
    group_norm_reference(xr.permute(0, 2, 3, 1), scale.detach(), bias.detach(), groups=32,
                         with_silu=True).sum().backward()
    _check_rel(x.grad, xr.grad, torch.float32, "gn autograd dx")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_flash_attention_backward_kernels_match_plain(cuda):
    """The forward's lse and the dq and dk/dv kernels against the plain
    versions, then one autograd step through head-split views, then a
    repeat of the f32 kernels that must be bit-identical (no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    # the UNet's (256, 256) and (16, 256), a pruned D, ragged N, several
    # heads, Nq != Nkv, partial 32- and 64-row tiles at full width (200), and
    # kv longer than q and ragged (64, 300)
    cases = [(4, 1, 256, 256, 256), (4, 1, 16, 16, 256), (2, 1, 256, 256, 179),
             (2, 1, 100, 100, 64), (2, 4, 70, 70, 32), (2, 2, 33, 77, 56),
             (2, 1, 200, 200, 256), (2, 1, 64, 300, 128)]
    for b, h, nq, nkv, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, h, n, d), generator=gen, device=cuda).to(dtype)
                       for n in (nq, nkv, nkv))
            do = torch.randn((b, h, nq, d), generator=gen, device=cuda).to(dtype)
            scale, what = d ** -0.5, f"attention bwd {(b, h, nq, nkv, d)} {dtype}"
            _, lse = A.flash_attention_forward_lse(q, k, v, scale)
            o, plse = A.reference_attention_lse(q, k, v, scale)
            _check_rel(lse, plse, torch.float32, what + " lse")
            dq, dsum = A.flash_attention_backward_dq(q, k, v, o, do, plse, scale)
            pdq, pdsum = A.attention_backward_dq_reference(q, k, v, o, do, plse, scale)
            _check_rel(dsum, pdsum, torch.float32, what + " dsum")
            _check_rel(dq, pdq, dtype, what + " dq")
            dk, dv = A.flash_attention_backward_dkv(q, k, v, do, plse, pdsum, scale)
            pdk, pdv = A.attention_backward_dkv_reference(q, k, v, do, plse, pdsum, scale)
            _check_rel(dk, pdk, dtype, what + " dk")
            _check_rel(dv, pdv, dtype, what + " dv")
    t = torch.randn((2, 64, 3 * 4 * 40), generator=gen, device=cuda, requires_grad=True)
    tr = t.detach().clone().requires_grad_()
    w = torch.randn((2, 4, 64, 40), generator=gen, device=cuda)

    def heads(z):
        return [y.view(2, 64, 4, 40).transpose(1, 2) for y in z.split(160, dim=-1)]

    before = dict(ops.LAUNCHES)
    (flash_attention(*heads(t), 40 ** -0.5) * w).sum().backward()
    assert ops.LAUNCHES["attention_lse"] == before["attention_lse"] + 1
    assert ops.LAUNCHES["attention_bwd_dq"] == before["attention_bwd_dq"] + 1
    assert ops.LAUNCHES["attention_bwd_dkv"] == before["attention_bwd_dkv"] + 1
    (reference_attention(*heads(tr), 40 ** -0.5) * w).sum().backward()
    _check_rel(t.grad, tr.grad, torch.float32, "attention autograd")
    q, k, v, do = (torch.randn((4, 1, 256, 256), generator=gen, device=cuda) for _ in range(4))
    o, lse = A.reference_attention_lse(q, k, v, 256 ** -0.5)
    runs = [A.flash_attention_backward(q, k, v, o, do, lse, 256 ** -0.5) for _ in range(2)]
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), f"attention bwd f32 repeat: {name} differs"
    torch.cuda.synchronize()
