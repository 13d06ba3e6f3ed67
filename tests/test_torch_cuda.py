"""The port's kernels, forward and backward, against their plain versions,
on an NVIDIA GPU.

One test, marked ``cuda``: without a card it skips. On a machine with one:

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
- backward: |kernel - plain| <= tol * max|plain| per output, tol 1e-4 (f32),
  2e-2 (bf16) and 2e-3 (f16): both compute in f32 from the same inputs and
  statistics and differ in summation order, then round once to the output
  dtype (16-bit: under one ulp of the max, 2^-8 and 2^-11).
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
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-3}


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


def _check_group_norm_forward(cuda):
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
            assert ops.LAUNCHES["group_norm"] == before + 1, what + " launch count"
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


def _check_flash_attention_forward(cuda):
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
            assert ops.LAUNCHES["attention"] == before + 1, what + " launch count"
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


def _check_group_norm_backward(cuda):
    """The forward's saved statistics and the backward kernel against the
    plain versions, through strided x and dy, back-to-back launches with
    another batch size (the kernel's tickets), a repeat that must be
    bit-identical (no float summed atomically), a CUDA-graph capture
    replayed between eager calls, then one autograd step through the layer
    op."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    # (B, N, C, groups, silu): C/g = 4, 12, 16, 5 and 3, the pruned 2, 7 and
    # 10, N ragged, and a slab beyond one block's shared memory
    cases = [(4, 1024, 128, 32, True), (4, 256, 384, 32, True), (4, 16, 512, 32, False),
             (3, 64, 160, 32, True), (2, 100, 96, 32, False), (2, 35, 40, 8, True),
             (2, 256, 64, 32, True), (2, 64, 224, 32, True), (2, 16, 320, 32, False),
             (2, 4096, 512, 32, True)]

    def inputs(b, n, c, dtype):
        x = (torch.randn((b, n, c), generator=gen, device=cuda) * 2 + 0.5).to(dtype)
        dy = torch.randn((b, n, c), generator=gen, device=cuda).to(dtype)
        scale = torch.rand((c,), generator=gen, device=cuda) + 0.5
        bias = torch.randn((c,), generator=gen, device=cuda) * 0.1
        return x, dy, scale, bias

    def check(x, dy, scale, bias, g, silu, dtype, what):
        pmean, prstd = G.group_norm_stats_reference(x, g)
        before = ops.LAUNCHES["group_norm_bwd"]
        got = G.group_norm_backward(x, scale, bias, dy, pmean, prstd, groups=g,
                                    with_silu=silu)
        assert ops.LAUNCHES["group_norm_bwd"] == before + 1, what + " launch count"
        want = G.group_norm_backward_reference(x, scale, bias, dy, pmean, prstd,
                                               groups=g, with_silu=silu)
        for a, w, name in zip(got, want, ("dx", "dscale", "dbias")):
            assert a.dtype == w.dtype, what + name
            _check_rel(a, w, dtype, f"{what} {name}")
        return got

    for b, n, c, g, silu in cases:
        for dtype in TOL:
            x, dy, scale, bias = inputs(b, n, c, dtype)
            what = f"gn bwd {(b, n, c, g, silu)} {dtype}"
            y, mean, rstd = G.group_norm_forward_with_stats(x, scale, bias, groups=g,
                                                            with_silu=silu)
            pmean, prstd = G.group_norm_stats_reference(x, g)
            _check_rel(mean, pmean, torch.float32, what + " mean")
            _check_rel(rstd, prstd, torch.float32, what + " rstd")
            check(x, dy, scale, bias, g, silu, dtype, what)
    # x and dy through other strides: the (B, H, W, C) view of an NCHW
    # tensor (16-byte reads along positions), channels cut from a wider
    # tensor (along channels, another row stride), every other channel
    # (element by element)
    for dtype in TOL:
        x, dy, scale, bias = (t.view(2, 8, 8, 64) if t.dim() == 3 else t
                              for t in inputs(2, 64, 64, dtype))
        nchw = [t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) for t in (x, dy)]
        wide = torch.randn((2, 8, 8, 72), generator=gen, device=cuda).to(dtype)[..., :64]
        every_other = torch.randn((2, 8, 8, 128), generator=gen, device=cuda).to(dtype)[..., ::2]
        for name, xa, dya in (("x and dy NCHW", *nchw),
                              ("x NCHW, dy every other", nchw[0], every_other),
                              ("dy cut from 72 channels", x, wide),
                              ("x every other, dy NCHW", every_other, nchw[1])):
            check(xa, dya, scale, bias, 32, True, dtype, f"gn bwd {name} {dtype}")
    # back to back on one stream with other batch sizes (each launch leaves
    # its tickets zero for the next), then a repeat that must be identical
    for dtype in TOL:
        runs = [inputs(b, 256, 128, dtype) for b in (3, 5, 1, 3)]
        outs = [G.group_norm_backward(x, s, bb, dy, *G.group_norm_stats_reference(x, 32),
                                      groups=32, with_silu=True) for x, dy, s, bb in runs]
        for (x, dy, s, bb), got in zip(runs, outs):
            want = G.group_norm_backward_reference(
                x, s, bb, dy, *G.group_norm_stats_reference(x, 32), groups=32, with_silu=True)
            for a, w, name in zip(got, want, ("dx", "dscale", "dbias")):
                _check_rel(a, w, dtype, f"gn bwd back to back B={x.shape[0]} {dtype} {name}")
        x, dy, scale, bias = inputs(4, 1024, 128, dtype)
        mean, rstd = G.group_norm_stats_reference(x, 32)
        first, again = (G.group_norm_backward(x, scale, bias, dy, mean, rstd, groups=32,
                                              with_silu=True) for _ in range(2))
        for name, a, b in zip(("dx", "dscale", "dbias"), first, again):
            assert torch.equal(a, b), f"gn bwd {dtype} repeat: {name} differs"
    # captured into a CUDA graph, then replayed between eager calls on the
    # capture stream with a larger B * C than any before: the graph keeps
    # its own tickets and partials, and the eager calls free nothing it holds
    x, dy, scale, bias = inputs(3, 256, 128, torch.float32)
    mean, rstd = G.group_norm_stats_reference(x, 32)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up outside the capture
        G.group_norm_backward(x, scale, bias, dy, mean, rstd, groups=32, with_silu=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = G.group_norm_backward(x, scale, bias, dy, mean, rstd, groups=32,
                                         with_silu=True)
    for replay in range(2):
        with torch.cuda.stream(stream):
            check(*inputs(160 + replay, 16, 512, torch.float32), 32, True, torch.float32,
                  f"gn bwd eager beside a graph {replay}")
        nx, ndy, _, _ = inputs(3, 256, 128, torch.float32)
        x.copy_(nx)
        dy.copy_(ndy)
        for t, v in zip((mean, rstd), G.group_norm_stats_reference(nx, 32)):
            t.copy_(v)
        graph.replay()
        want = G.group_norm_backward_reference(nx, scale, bias, ndy, mean, rstd, groups=32,
                                               with_silu=True)
        for a, w, name in zip(captured, want, ("dx", "dscale", "dbias")):
            _check_rel(a, w, torch.float32, f"gn bwd graph replay {replay} {name}")
    x = torch.randn((2, 64, 8, 8), generator=gen, device=cuda, requires_grad=True)
    scale = torch.ones(64, device=cuda, requires_grad=True)
    bias = torch.zeros(64, device=cuda, requires_grad=True)
    xr = x.detach().clone().requires_grad_()
    before = dict(ops.LAUNCHES)
    group_norm(x.permute(0, 2, 3, 1), scale, bias, groups=32, with_silu=True).sum().backward()
    for op in ("group_norm", "group_norm_bwd"):
        assert ops.LAUNCHES[op] == before[op] + 1, f"gn autograd: {op} launch count"
    group_norm_reference(xr.permute(0, 2, 3, 1), scale.detach(), bias.detach(), groups=32,
                         with_silu=True).sum().backward()
    _check_rel(x.grad, xr.grad, torch.float32, "gn autograd dx")
    torch.cuda.synchronize()


def _check_flash_attention_backward(cuda):
    """The forward's lse and the dq and dk/dv kernels against the plain
    versions (f32 on the CUDA cores, bf16 and f16 on the tensor cores), also
    through head-split D = 179 views of fused projections (rows only 2-byte
    aligned), then one autograd step through head-split views, then a
    repeat of the kernels that must be bit-identical (no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    # the UNet's (256, 256) and (16, 256), a pruned D, ragged N, several
    # heads, Nq != Nkv, partial 32- and 64-row tiles at full width (200), and
    # kv longer than q and ragged (64, 300)
    cases = [(4, 1, 256, 256, 256), (4, 1, 16, 16, 256), (2, 1, 256, 256, 179),
             (2, 1, 100, 100, 64), (2, 4, 70, 70, 32), (2, 2, 33, 77, 56),
             (2, 1, 200, 200, 256), (2, 1, 64, 300, 128)]

    def fused(b, n, heads, dh, dtype):  # head-split views of a (B, N, 3 heads dh) projection
        t = torch.randn((b, n, 3 * heads * dh), generator=gen, device=cuda).to(dtype)
        return [z.view(b, n, heads, dh).transpose(1, 2) for z in t.split(heads * dh, dim=-1)]

    runs = [(b, h, nq, nkv, d, dtype, None) for b, h, nq, nkv, d in cases for dtype in TOL]
    runs += [(2, heads, 64, 64, 179, dtype, heads) for heads in (1, 2) for dtype in TOL]
    for b, h, nq, nkv, d, dtype, heads in runs:
        if heads is None:
            q, k, v = (torch.randn((b, h, n, d), generator=gen, device=cuda).to(dtype)
                       for n in (nq, nkv, nkv))
            do = torch.randn((b, h, nq, d), generator=gen, device=cuda).to(dtype)
        else:
            q, k, v = fused(b, nq, heads, d, dtype)
            do = fused(b, nq, heads, d, dtype)[0]
        scale, what = d ** -0.5, f"attention bwd {(b, h, nq, nkv, d)} {dtype}"
        if heads is not None:
            what += " fused views"
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
    for op in ("attention_lse", "attention_bwd_dq", "attention_bwd_dkv"):
        assert ops.LAUNCHES[op] == before[op] + 1, f"attention autograd: {op} launch count"
    (reference_attention(*heads(tr), 40 ** -0.5) * w).sum().backward()
    _check_rel(t.grad, tr.grad, torch.float32, "attention autograd")
    for dtype in TOL:
        q, k, v, do = (torch.randn((4, 1, 256, 256), generator=gen, device=cuda).to(dtype)
                       for _ in range(4))
        o, lse = A.reference_attention_lse(q, k, v, 256 ** -0.5)
        again = [A.flash_attention_backward(q, k, v, o, do, lse, 256 ** -0.5) for _ in range(2)]
        for name, a, b in zip(("dq", "dk", "dv"), *again):
            assert torch.equal(a, b), f"attention bwd {dtype} repeat: {name} differs"
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda):
    """The four checks in turn: the GroupNorm forward, the attention forward,
    the GroupNorm backward and the attention backward kernels against their
    plain versions. Every failure message names the kernel ("gn", "gn bwd",
    "attention", "attention bwd") and the case."""
    for check in (_check_group_norm_forward, _check_flash_attention_forward,
                  _check_group_norm_backward, _check_flash_attention_backward):
        check(cuda)
