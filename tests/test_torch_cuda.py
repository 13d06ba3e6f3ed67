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
  dtype (16-bit: under one ulp of the max, 2^-8 and 2^-11). With Nkv = 1
  (a cross-attention on one token) p = 1, so dq and dk are zero in exact
  arithmetic and both sides hold only f32 noise: there the sweep's rule
  adds 1e-6 of the call's largest gradient (in practice dv's). The wide
  16-bit backward's tile edges are held to the same rule against the plain
  versions computed in float64, whose own noise is far below that floor.
"""

import ctypes

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


_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _gn_route(kind, dtype, n, c, sc=1):
    """(0 one block a run / 1 a cluster, groups a run, blocks a cluster, ...)
    of the GroupNorm kernel ``kind`` ("fwd", "bwd") at (N, C), 32 groups."""
    from diff_pruning_tpu_torch.ops import _build

    fn = getattr(_build.load_library(f"group_norm_{kind}"), f"group_norm_{kind}_route")
    out = (ctypes.c_int * 6)()
    if kind == "fwd":
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
        assert fn(_CODES[dtype], n, c, 32, sc, out) == 0
    else:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        assert fn(_CODES[dtype], n, c, 32, out) == 0
    return tuple(out)


def _gn_edges():
    """(N, C, dtype, kind) one position either side of each kernel's
    single-block budget, at 4, 8, 16 and 60 channels a group: the last N on
    one block and the first on a cluster (the cluster route takes every
    slab beyond the budget)."""
    edges = []
    for c in (128, 256, 512, 1920):
        for dtype in TOL:
            for kind in ("fwd", "bwd"):
                lo, hi = 1, 1 << 22
                while hi - lo > 1:
                    mid = (lo + hi) // 2
                    lo, hi = (mid, hi) if _gn_route(kind, dtype, mid, c)[0] == 0 else (lo, mid)
                assert _gn_route(kind, dtype, lo, c)[0] == 0
                assert _gn_route(kind, dtype, lo + 1, c)[0] == 1
                edges += [(lo, c, dtype, kind), (lo + 1, c, dtype, kind)]
    return edges


def _check_group_norm_forward(cuda):
    """y, and the (B, G) statistics the forward writes under autograd."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    # (B, N, C, groups, silu): C/g = 4, 12, 16, 5 and 3, the pruned 2, 7 and
    # 10, N ragged to the tiles, and a slab beyond one block's shared memory
    cases = [(4, 1024, 128, 32, True), (4, 256, 384, 32, True), (4, 16, 512, 32, False),
             (3, 64, 160, 32, True), (2, 100, 96, 32, False), (2, 7, 24, 8, True),
             (2, 256, 64, 32, True), (2, 64, 224, 32, True), (2, 16, 320, 32, False),
             (2, 4096, 512, 32, True), (2, 64, 1920, 32, True), (2, 1024, 192, 32, False),
             (2, 16384, 256, 32, True), (2, 65536, 128, 32, True)]
    # the unconditional LDMs' odd channels a group: CelebA-HQ LDM-VQ-4's C =
    # 224, 672, 1120 and 1568 (7, 21, 35 and 49 a group), with SiLU and
    # without (LSUN-churches' scale-shift ResBlocks)
    cases += [(2, 4096, 224, 32, True), (2, 4096, 224, 32, False), (2, 1024, 672, 32, True),
              (2, 256, 1120, 32, True), (2, 64, 1568, 32, False), (2, 1024, 1568, 32, True)]
    runs = [(case, dtype, False) for case in cases for dtype in TOL]
    # the cluster route's edges, channels-last and as NCHW views, SiLU in
    # turn; N ragged to a 16-block cluster's shares; a slab beyond the largest
    # cluster (streamed)
    runs += [((2, n, c, 32, i % 2 == 0), dtype, nchw)
             for i, (n, c, dtype, _) in enumerate(_gn_edges()) for nchw in (False, True)]
    runs += [((b, n, 128, 32, silu), dtype, nchw) for b, n, silu in
             ((2, 65536 + 17, True), (1, 200_003, False)) for dtype in TOL for nchw in (False, True)]
    for (b, n, c, g, silu), dtype, nchw in runs:
        x = (torch.randn((b, n, c), generator=gen, device=cuda) * 2 + 0.5).to(dtype)
        if nchw:  # the (B, N, C) view of a (B, C, N)-contiguous tensor
            x = x.transpose(1, 2).contiguous().transpose(1, 2)
        scale = torch.rand((c,), generator=gen, device=cuda) + 0.5
        bias = torch.randn((c,), generator=gen, device=cuda) * 0.1
        what = f"gn {(b, n, c, g, silu)} {dtype}{' NCHW view' if nchw else ''}"
        before = ops.LAUNCHES["group_norm"]
        got = group_norm(x, scale, bias, groups=g, with_silu=silu)
        assert ops.LAUNCHES["group_norm"] == before + 1, what + " launch count"
        want = group_norm_reference(x, scale, bias, groups=g, with_silu=silu)
        _check(got, want, dtype, what)
        y, mean, rstd = G.group_norm_forward_with_stats(x, scale, bias, groups=g,
                                                        with_silu=silu)
        assert torch.equal(y, got), what + " y with stats"
        assert torch.equal(group_norm(x, scale, bias, groups=g, with_silu=silu), got), \
            what + " repeat"
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
    # Nq != Nkv past one kv tile; then the wide head dims (the LDM UNet's
    # self- and class-token cross-attention and those of the UNet pruned at
    # 0.3, its first stage's 4096 tokens, D = 320 and 1024, a pruned D =
    # 269, ragged tiles, several heads)
    cases = [(4, 1, 256, 256, 256), (4, 1, 16, 16, 256), (2, 1, 256, 256, 179),
             (2, 1, 100, 100, 64), (2, 4, 70, 70, 32), (2, 2, 33, 77, 56),
             (2, 2, 40, 40, 8), (2, 3, 64, 64, 40), (1, 1, 300, 130, 256)]
    wide = [(4, 1, 1024, 1024, 384), (4, 1, 1024, 1, 384), (4, 1, 256, 256, 576),
            (4, 1, 256, 1, 576), (4, 1, 64, 64, 960), (4, 1, 64, 1, 960),
            (2, 1, 4096, 4096, 512), (2, 1, 100, 37, 1024), (2, 1, 33, 50, 269),
            (2, 3, 40, 40, 300), (4, 1, 1024, 1024, 268), (4, 1, 1024, 1, 268),
            (4, 1, 256, 256, 404), (4, 1, 256, 1, 404), (4, 1, 64, 64, 672),
            (4, 1, 64, 1, 672), (2, 1, 64, 64, 320), (2, 1, 64, 1, 1024),
            (2, 1, 1024, 1024, 512)]  # the last: kl-f8's mid attention
    # the wide kernels' tile edges: Nq and Nkv around the 32- and 64-row query
    # tiles and the 16-, 32-, 64- and 128-row kv tiles, at the head dims where
    # the tiling changes (D_pad 384, 512, 640, 1024)
    edges = [(1, 1, nq, nkv, d) for d in (257, 384, 512, 513, 1024)
             for nq in (1, 31, 33, 63, 65, 127) for nkv in (1, 31, 33, 63, 65, 127)]
    runs = [(case, dtype) for case in cases + wide + edges for dtype in TOL]
    for (b, h, nq, nkv, d), dtype in runs:
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
    # them (dh = 179 and 269: rows not 16-byte aligned; in 16 bits 2-byte
    # aligned, dh = 268: 8-byte aligned and dh = 270: 4-byte aligned; one and
    # several heads), and a head dim cut from a wider tensor (D = 37 of 64)
    for dtype in TOL:
        for heads, dh in ((4, 40), (1, 179), (1, 269), (1, 268), (2, 960), (3, 268), (3, 269),
                          (2, 270)):
            t = torch.randn((2, 64, 3 * heads * dh), generator=gen, device=cuda).to(dtype)
            q, k, v = (z.view(2, 64, heads, dh).transpose(1, 2)
                       for z in t.split(heads * dh, dim=-1))
            _check(flash_attention(q, k, v, dh ** -0.5), reference_attention(q, k, v, dh ** -0.5),
                   dtype, f"attention strided {heads}x{dh} {dtype}")
        # the multi-head legacy AttentionBlocks of the unconditional LDMs, as
        # SelfAttention2D passes them: (B, N, heads * dh) projections viewed as
        # (B, heads, N, dh) (CelebA-HQ: 14-28 heads of 32; LSUN-churches: 8 heads
        # of 24, 48 and 96)
        for heads, dh, n in ((14, 32, 1024), (21, 32, 256), (28, 32, 64), (8, 24, 1024),
                             (8, 48, 256), (8, 48, 64), (8, 96, 16), (8, 96, 4)):
            q, k, v = (torch.randn((2, n, heads * dh), generator=gen, device=cuda).to(dtype)
                       .view(2, n, heads, dh).transpose(1, 2) for _ in range(3))
            _check(flash_attention(q, k, v, dh ** -0.5), reference_attention(q, k, v, dh ** -0.5),
                   dtype, f"attention {heads} heads x {dh}, N = {n} {dtype}")
        # the text- and retrieval-conditioned LDMs, as CrossAttention and
        # SelfAttention2D pass them (heads, D, Nq, Nkv): txt2img's 8 heads of
        # 40, 80 and 160, self-attention and cross-attention over the 77-token
        # context; its BERT's 77 tokens at 8 x 64; rdm768's 14-56 heads of 32
        # with a context of 1 or 11 (knn 10) CLIP embeddings; inpainting_big's
        # 8 heads of 64, 96 and 128
        for heads, dh, nq, nkv in ((8, 40, 1024, 1024), (8, 40, 1024, 77), (8, 80, 256, 256),
                                   (8, 80, 256, 77), (8, 160, 64, 64), (8, 160, 64, 77),
                                   (8, 160, 16, 16), (8, 160, 16, 77), (8, 64, 77, 77),
                                   (14, 32, 2304, 2304), (14, 32, 2304, 1), (14, 32, 2304, 11),
                                   (28, 32, 576, 11), (42, 32, 144, 11), (56, 32, 36, 36),
                                   (56, 32, 36, 1), (8, 64, 1024, 1024), (8, 96, 256, 256),
                                   (8, 128, 64, 64)):
            q, k, v = (torch.randn((2, n, heads * dh), generator=gen, device=cuda).to(dtype)
                       .view(2, n, heads, dh).transpose(1, 2) for n in (nq, nkv, nkv))
            _check(flash_attention(q, k, v, dh ** -0.5), reference_attention(q, k, v, dh ** -0.5),
                   dtype, f"attention {heads} heads x {dh}, Nq = {nq}, Nkv = {nkv} {dtype}")
        q, k, v = (torch.randn((2, 2, 50, 64), generator=gen, device=cuda).to(dtype)[..., :37]
                   for _ in range(3))
        _check(flash_attention(q, k, v, 37 ** -0.5), reference_attention(q, k, v, 37 ** -0.5),
               dtype, f"attention D=37 of 64 {dtype}")
    # what no kernel takes raises, and launches nothing: a forward and a
    # backward (also under autograd) above D = 1024, in every dtype; at D =
    # 320 each dtype launches the forward with lse, dq and dk/dv under autograd
    before = dict(ops.LAUNCHES)
    for dtype in TOL:
        q = torch.randn((1, 1, 16, 1040), generator=gen, device=cuda).to(dtype)
        with pytest.raises(ValueError, match="head dim 1040"):
            flash_attention(q, q, q, 0.1)
        with pytest.raises(ValueError, match="backward: head dim 1040"):
            A.flash_attention_backward(q, q, q, q, q, torch.zeros((1, 1, 16), device=cuda), 0.1)
        with pytest.raises(ValueError, match="backward: head dim 1040"):
            flash_attention(q.requires_grad_(), q, q, 0.1)
    assert ops.LAUNCHES == before, "a refused call launched"
    for dtype in TOL:
        q = torch.randn((1, 1, 16, 320), generator=gen, device=cuda).to(dtype).requires_grad_()
        flash_attention(q, q, q, 0.1).float().sum().backward()
    for op in ("attention", "attention_lse", "attention_bwd_dq", "attention_bwd_dkv"):
        assert ops.LAUNCHES[op] == before[op] + 3, f"D = 320 under autograd: {op}"
    torch.cuda.synchronize()


def _check_rel(got, want, dtype, what, floor=0.0):
    assert got.shape == want.shape, what
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert bool(torch.isfinite(got.float()).all()) and err <= BWD_TOL[dtype] * scale + floor, \
        f"{what}: max abs err {err:.3e} against max |want| {scale:.3e} (floor {floor:.3e})"


def _check_group_norm_backward(cuda):
    """The forward's saved statistics and the backward kernel against the
    plain versions, through strided x and dy, back-to-back launches with
    another batch size (the kernel's tickets), a repeat that must be
    bit-identical (no float summed atomically), a CUDA-graph capture
    replayed between eager calls, then one autograd step through the layer
    op."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    # (B, N, C, groups, silu): C/g = 4, 12, 16, 5 and 3, the pruned 2, 7 and
    # 10, N ragged, and a slab beyond one block's shared memory; then the
    # LDM sweep's shapes at its B = 6 (C 192-1920, up to 60 channels a
    # group; 4096 x 192 and 4096 x 384: chunked slabs) and its pruned
    # UNet's (C/g 5, 9, 13, 21, 42)
    cases = [(4, 1024, 128, 32, True), (4, 256, 384, 32, True), (4, 16, 512, 32, False),
             (3, 64, 160, 32, True), (2, 100, 96, 32, False), (2, 35, 40, 8, True),
             (2, 256, 64, 32, True), (2, 64, 224, 32, True), (2, 16, 320, 32, False),
             (2, 4096, 512, 32, True),
             (6, 4096, 192, 32, True), (6, 4096, 384, 32, True), (6, 4096, 576, 32, True),
             (6, 1024, 384, 32, False), (6, 1024, 960, 32, True), (6, 256, 576, 32, False),
             (6, 256, 1536, 32, True), (6, 64, 960, 32, False), (6, 64, 1920, 32, True),
             (6, 4096, 160, 32, True), (6, 1024, 288, 32, False), (6, 256, 416, 32, True),
             (6, 64, 672, 32, False), (6, 64, 1344, 32, True),
             # the vq-f4 codec's first and last levels at 256 x 256 (the
             # autoencoder trainer's): 1 and 2 MB slabs
             (2, 65536, 128, 32, True), (2, 65536, 256, 32, True)]

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
    # the cluster route's edges (as in the forward's check), channels-last
    # and as NCHW views, SiLU in turn; N ragged to a 16-block cluster's
    # shares; a slab beyond the largest cluster (streamed): each repeated
    # bit-identically, dscale and dbias included
    edges = [((2, n, c), dtype, i % 2 == 0) for i, (n, c, dtype, _) in enumerate(_gn_edges())]
    edges += [((b, n, 128), dtype, silu) for b, n, silu in
              ((2, 65536 + 17, False), (1, 200_003, True)) for dtype in TOL]
    for ((b, n, c), dtype, silu), nchw in ((edge, nchw) for edge in edges for nchw in (False, True)):
        x, dy, scale, bias = inputs(b, n, c, dtype)
        if nchw:  # the (B, N, C) views of (B, C, N)-contiguous tensors
            x, dy = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (x, dy))
        what = f"gn bwd {(b, n, c, silu)} {dtype}{' NCHW views' if nchw else ''}"
        got = check(x, dy, scale, bias, 32, silu, dtype, what)
        again = G.group_norm_backward(x, scale, bias, dy, *G.group_norm_stats_reference(x, 32),
                                      groups=32, with_silu=silu)
        for name, a, a2 in zip(("dx", "dscale", "dbias"), got, again):
            assert torch.equal(a, a2), f"{what} repeat: {name} differs"
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
    # its own tickets and partials, and the eager calls free nothing it holds;
    # on one block a run, then on the cluster route
    for shape in ((3, 256, 128), (3, 16384, 256)):
        assert _gn_route("bwd", torch.float32, *shape[1:])[0] == (shape[1] > 256)
        x, dy, scale, bias = inputs(*shape, torch.float32)
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
            nx, ndy, _, _ = inputs(*shape, torch.float32)
            x.copy_(nx)
            dy.copy_(ndy)
            for t, v in zip((mean, rstd), G.group_norm_stats_reference(nx, 32)):
                t.copy_(v)
            graph.replay()
            want = G.group_norm_backward_reference(nx, scale, bias, ndy, mean, rstd, groups=32,
                                                   with_silu=True)
            for a, w, name in zip(captured, want, ("dx", "dscale", "dbias")):
                _check_rel(a, w, torch.float32, f"gn bwd graph replay {shape} {replay} {name}")
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
    aligned); the wide head dims in every dtype (the LDM sweep's and train
    step's one-head self- and class-token cross-attention at B = 6, the
    widths of the UNet pruned at 0.3, D = 320 and 1024, several heads, the
    vq-f4 codec's 4096-token D = 512 mid attention (the autoencoder
    trainer's), fused
    D = 270 views: rows only 8-byte aligned in f32, 4-byte in 16 bits; fused
    D = 268 and 269 in 16 bits: 8- and 2-byte aligned); the wide kernels at
    their tile edges against the plain versions in float64 in every dtype
    (in f32 through both routes of dk/dv: unsplit, and its q loop split over
    2 and 4 blocks); then one autograd step through head-split views, then a
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

    wide = [(6, 1, 1024, 1024, 384), (6, 1, 1024, 1, 384), (6, 1, 256, 256, 576),
            (6, 1, 256, 1, 576), (6, 1, 64, 64, 960), (6, 1, 64, 1, 960),
            (6, 1, 1024, 1024, 268), (6, 1, 1024, 1, 268), (6, 1, 256, 256, 404),
            (6, 1, 256, 1, 404), (6, 1, 64, 64, 672), (6, 1, 64, 1, 672),
            (2, 1, 64, 64, 320), (2, 1, 64, 1, 320), (2, 1, 64, 64, 1024), (2, 1, 64, 1, 1024),
            (2, 1, 40, 33, 1024), (2, 3, 40, 40, 300), (1, 1, 300, 130, 257),
            (2, 1, 4096, 4096, 512)]  # the last: vq-f4's mid attentions, in training
    runs = [(b, h, nq, nkv, d, dtype, None) for b, h, nq, nkv, d in cases + wide
            for dtype in TOL]
    runs += [(2, heads, 64, 64, 179, dtype, heads) for heads in (1, 2) for dtype in TOL]
    runs += [(2, 1, 100, 100, d, dtype, 1) for d in (270, 268, 269) for dtype in TOL]
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
        dk, dv = A.flash_attention_backward_dkv(q, k, v, do, plse, pdsum, scale)
        pdk, pdv = A.attention_backward_dkv_reference(q, k, v, do, plse, pdsum, scale)
        floor = 1e-6 * max(float(g.float().abs().max()) for g in (pdq, pdk, pdv)) \
            if nkv == 1 else 0.0
        _check_rel(dq, pdq, dtype, what + " dq", floor)
        _check_rel(dk, pdk, dtype, what + " dk", floor)
        _check_rel(dv, pdv, dtype, what + " dv")
    # the wide dq and dk/dv at their tile edges (Nq, Nkv around the 32- and
    # 64-row tiles, at the head dims where the tilings change), chained as
    # the backward chains them, against the plain versions in float64: where
    # Nkv = 1, dq and dk are zero in exact arithmetic and the f32 plain
    # version's own cancellation noise reaches the floor the tolerance adds
    # for them. 16-bit: 16 rows of 16 heads so that the entry points take
    # the wgmma kernels, and fused 3 x 268, 3 x 269 and 2 x 270 views at 256
    # tokens. f32: the head dims where the cluster of 192-column blocks
    # grows, at 16 rows of 16 heads (dk/dv unsplit) and
    # at 1 row of 2 heads (dk/dv splitting its q loop over 2 blocks; over 4
    # at 257 q rows), and the fused views at 8 rows and at 1
    ns = (1, 31, 33, 63, 65, 127)
    fused3 = ((3, 268), (3, 269), (2, 270))
    edges = [(16, 16, nq, nkv, d, None) for d in (257, 384, 512, 513, 1024)
             for nq in ns for nkv in ns]
    edges += [(8, heads, 256, 256, d, heads) for heads, d in fused3]
    edges32 = [(b, h, nq, nkv, d, None) for b, h in ((16, 16), (1, 2))
               for d in (257, 384, 385, 576, 577, 1024) for nq in ns for nkv in ns]
    edges32 += [(1, 2, 257, nkv, d, None) for d in (257, 384) for nkv in (1, 33)]
    edges32 += [(b, heads, 256, 256, d, heads) for b in (8, 1) for heads, d in fused3]
    for dtype, cases in ((torch.bfloat16, edges), (torch.float16, edges),
                         (torch.float32, edges32)):
        for b, h, nq, nkv, d, heads in cases:
            if heads is None:
                q, do = (torch.randn((b, h, nq, d), generator=gen, device=cuda).to(dtype)
                         for _ in range(2))
                k, v = (torch.randn((b, h, nkv, d), generator=gen, device=cuda).to(dtype)
                        for _ in range(2))
            else:
                q, k, v = fused(b, nq, heads, d, dtype)
                do = fused(b, nq, heads, d, dtype)[0]
            scale, what = d ** -0.5, f"attention bwd edge {(b, h, nq, nkv, d)} {dtype}"
            o, lse = A.reference_attention_lse(q, k, v, scale)
            dq, dsum = A.flash_attention_backward_dq(q, k, v, o, do, lse, scale)
            dk, dv = A.flash_attention_backward_dkv(q, k, v, do, lse, dsum, scale)
            pdq, pdsum = A.attention_backward_dq_reference(q, k, v, o, do, lse, scale,
                                                           compute_dtype=torch.float64)
            pdk, pdv = A.attention_backward_dkv_reference(q, k, v, do, lse, pdsum, scale,
                                                          compute_dtype=torch.float64)
            floor = 1e-6 * max(float(g.double().abs().max()) for g in (pdq, pdk, pdv)) \
                if nkv == 1 else 0.0
            _check_rel(dsum, pdsum, torch.float32, what + " dsum")
            _check_rel(dq, pdq, dtype, what + " dq", floor)
            _check_rel(dk, pdk, dtype, what + " dk", floor)
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
    for dtype, (b, nq, nkv, d) in [(dtype, (4, 256, 256, 256)) for dtype in TOL] + [
            (dtype, shape) for shape in ((6, 256, 256, 576), (6, 1024, 1, 384)) for dtype in TOL]:
        q, do = (torch.randn((b, 1, nq, d), generator=gen, device=cuda).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn((b, 1, nkv, d), generator=gen, device=cuda).to(dtype)
                for _ in range(2))
        o, lse = A.reference_attention_lse(q, k, v, d ** -0.5)
        again = [A.flash_attention_backward(q, k, v, o, do, lse, d ** -0.5) for _ in range(2)]
        for name, a, b_ in zip(("dq", "dk", "dv"), *again):
            assert torch.equal(a, b_), f"attention bwd {dtype} D={d} repeat: {name} differs"
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
