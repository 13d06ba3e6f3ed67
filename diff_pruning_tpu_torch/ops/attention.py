"""Attention forward: plain PyTorch version and the CUDA kernel's wrapper.

Replaces the TPU kernel ``_flash_fwd_call`` (``diff_pruning_tpu/ops/attention.py``,
``_fwd_kernel``), here without the logsumexp output, which only the backward
needs. The kernel (``csrc/flash_attention_fwd.cu``) is one block per
(batch*head, 64-row query tile) with an online softmax and an f32
accumulator; its source note says what bounds it on the H100 and what the
design does about that. It takes any head dim up to 256, masked to the
loaded width rather than padded, and reads head-split views through their
strides, so the layer passes ``(B, N, heads*dh)`` projections without a
transpose copy.

The plain version keeps the layer's math: f32 scores, probabilities cast to
``v.dtype`` before the PV product. The kernel keeps the probabilities in f32
(the TPU kernel's math), so in bf16 the two differ by about one bf16 ulp.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIB = None


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """(B, H, Nq, D) x (B, H, Nkv, D) -> (B, H, Nq, D); f32 softmax."""
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(B, H, Nq, D) x (B, H, Nkv, D) -> (B, H, Nq, D), non-causal.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises on what it does not take). The output is a (B, H, Nq, D)
    view of a contiguous (B, Nq, H, D) tensor, so merging the heads back is
    free.
    """
    if q.device.type == "cpu":
        return reference_attention(q, k, v, scale)
    return _launch(q, k, v, float(scale))


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load_library

        lib = load_library("flash_attention_fwd")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_fwd.argtypes = ([ptr] * 4 + [i32] * 6 + [i64] * 12
                                            + [ctypes.c_float, ptr])
        lib.flash_attention_fwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _launch(q, k, v, scale):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes one of {list(_DTYPE_CODES)}, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    if not 1 <= d <= MAX_HEAD_DIM or nq < 1 or nkv < 1:
        raise ValueError(f"flash_attention: head dim {d} (max {MAX_HEAD_DIM}), "
                         f"Nq {nq}, Nkv {nkv}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    o = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, nq, nkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    LAUNCHES["attention"] += 1
    return o
