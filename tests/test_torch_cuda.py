"""The port's kernels against their plain versions, on an NVIDIA GPU.

Marked ``cuda``: without a card each test skips. On a machine with one:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` because tests/conftest.py imports jax, which a GPU machine
running only the port need not have.)

Tolerances, |kernel - plain| <= atol + rtol * |plain|:
- f32: 1e-4 + 1e-4 rel. Both sides compute in f32 and differ only in the
  order of their sums (TF32 is switched off for the plain matmuls).
- bf16: 1e-2 + 1.6e-2 rel, two bf16 ulps. Both round their f32 result to
  bf16 once; the plain attention also rounds its probabilities to bf16
  before the PV product, the kernel does not.
"""

import pytest
import torch

from diff_pruning_tpu_torch import ops
from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1.6e-2)}


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
    gen = torch.Generator(device=cuda).manual_seed(0)
    # (B, N, C, groups, silu): C/g = 4, 12, 16, 5 and 3, N ragged to the tiles
    cases = [(4, 1024, 128, 32, True), (4, 256, 384, 32, True), (4, 16, 512, 32, False),
             (3, 64, 160, 32, True), (2, 100, 96, 32, False), (2, 7, 24, 8, True)]
    for b, n, c, g, silu in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((b, n, c), generator=gen, device=cuda) * 2 + 0.5).to(dtype)
            scale = torch.rand((c,), generator=gen, device=cuda) + 0.5
            bias = torch.randn((c,), generator=gen, device=cuda) * 0.1
            before = ops.LAUNCHES["group_norm"]
            got = group_norm(x, scale, bias, groups=g, with_silu=silu)
            assert ops.LAUNCHES["group_norm"] == before + 1
            want = group_norm_reference(x, scale, bias, groups=g, with_silu=silu)
            _check(got, want, dtype, f"gn {(b, n, c, g, silu)} {dtype}")
    # a strided input: the channel-last view of an NCHW (not channels_last) tensor
    x = torch.randn((2, 64, 8, 8), generator=gen, device=cuda).permute(0, 2, 3, 1)
    scale, bias = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    _check(group_norm(x, scale, bias, groups=32), group_norm_reference(
        x, scale, bias, groups=32), torch.float32, "gn strided")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_flash_attention_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    # (B, H, Nq, Nkv, D): the UNet's (256, 256) and (16, 256), a pruned D, a
    # ragged N, several heads, and cross-attention lengths
    cases = [(4, 1, 256, 256, 256), (4, 1, 16, 16, 256), (2, 1, 256, 256, 179),
             (2, 1, 100, 100, 64), (2, 4, 70, 70, 32), (2, 2, 33, 77, 56)]
    for b, h, nq, nkv, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, h, n, d), generator=gen, device=cuda).to(dtype)
                       for n in (nq, nkv, nkv))
            before = ops.LAUNCHES["attention"]
            got = flash_attention(q, k, v, d ** -0.5)
            assert ops.LAUNCHES["attention"] == before + 1
            want = reference_attention(q, k, v, d ** -0.5)
            _check(got, want, dtype, f"attention {(b, h, nq, nkv, d)} {dtype}")
    # head-split views of (B, N, heads*dh) projections, as the layer passes them
    t = torch.randn((2, 64, 3 * 4 * 40), generator=gen, device=cuda)
    q, k, v = (z.view(2, 64, 4, 40).transpose(1, 2) for z in t.split(160, dim=-1))
    _check(flash_attention(q, k, v, 40 ** -0.5), reference_attention(q, k, v, 40 ** -0.5),
           torch.float32, "attention strided")
    torch.cuda.synchronize()
