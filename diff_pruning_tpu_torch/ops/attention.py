"""Attention, forward and backward: plain PyTorch versions and the CUDA
kernels' wrappers.

Replaces the TPU kernels of ``diff_pruning_tpu/ops/attention.py``:
``_flash_fwd_call`` (``_fwd_kernel``, with its optional logsumexp output)
and both halves of ``_flash_bwd_call`` (``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``).

- Forward (``csrc/flash_attention_fwd.cu``): one block per (batch*head,
  64-row query tile) with an online softmax and f32 accumulators, K/V tiles
  streamed through a cp.async ring. f32 inputs run exact f32 on the CUDA
  cores from register micro-tiles (no TF32); bf16/f16 inputs run on the
  tensor cores (``mma.sync`` m16n8k16, f32 accumulators). Under autograd it
  also writes the per-row logsumexp ``lse = m + log(l)`` (f32, (B, H, Nq));
  without autograd no lse is written and the launch is the inference one.
- Backward (``csrc/flash_attention_bwd.cu``), the standard flash backward
  split as the JAX package splits it, so no block writes what another block
  writes (no atomics: gradients are bit-reproducible run to run):
  ``dq`` one block per (batch*head, q tile) looping over kv tiles, which
  also forms ``D = rowsum(dO * O)`` for its rows and writes it; then
  ``dk, dv`` one block per (batch*head, kv tile) looping over q tiles, which
  reads that D. With ``p = exp(s - lse)`` and ``ds = p * (dO v^T - D) *
  scale``: ``dq = ds k``, ``dk = ds^T q``, ``dv = p^T dO``. f32 inputs run
  exact f32 on the CUDA cores from register micro-tiles, with the streamed
  tiles (K/V for dq, Q/dO for dk/dv) copied through cp.async; bf16/f16
  inputs run the first design (8 lanes a row, f32 math from shared memory).

The kernels take any head dim up to 256 (the forward and the f32 backward
zero-pad it in shared memory, the 16-bit backward masks it to the loaded
width), and read head-split
views through their strides, so the layer passes ``(B, N, heads*dh)``
projections without a transpose copy; outputs are (B, H, N, D) views of
contiguous (B, N, H, D) tensors, so merging the heads back is free. Their
source notes say what bounds them on the H100.

The plain forward keeps the layer's math: f32 scores, probabilities cast to
``v.dtype`` before the PV product. The bf16/f16 forward kernel rounds its
(unnormalised) probabilities to the input type too, as the tensor cores
take them; the backward kernels keep them in f32 (the TPU kernels' math).
In bf16 kernel and plain version differ by about one bf16 ulp.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIBS = {}


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """(B, H, Nq, D) x (B, H, Nkv, D) -> (B, H, Nq, D); f32 softmax."""
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def reference_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float):
    """``(o, lse)``: the forward of :func:`reference_attention` with the
    per-row logsumexp of the scaled scores, (B, H, Nq) f32 (the TPU kernel's
    ``m + log(l)``)."""
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    return torch.matmul(p, v), lse


def attention_backward_dq_reference(q, k, v, o, do, lse, scale: float):
    """``(dq, dsum)``: the plain version of the dq kernel, the TPU dq kernel's
    math (``diff_pruning_tpu/ops/attention.py:143-167``) in f32, with
    ``dsum = rowsum(dO * O)``, (B, H, Nq) f32, which the dk/dv part reads."""
    f32 = torch.float32
    qf, kf, dof = q.to(f32), k.to(f32), do.to(f32)
    dsum = (dof * o.to(f32)).sum(-1)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    ds = p * (torch.matmul(dof, v.to(f32).transpose(-1, -2)) - dsum[..., None]) * scale
    return torch.matmul(ds, kf).to(q.dtype), dsum


def attention_backward_dkv_reference(q, k, v, do, lse, dsum, scale: float):
    """``(dk, dv)``: the plain version of the dk/dv kernel, the TPU dkv
    kernel's math (``diff_pruning_tpu/ops/attention.py:170-202``) in f32."""
    f32 = torch.float32
    qf, dof = q.to(f32), do.to(f32)
    p = torch.exp(torch.matmul(qf, k.to(f32).transpose(-1, -2)) * scale - lse[..., None])
    ds = p * (torch.matmul(dof, v.to(f32).transpose(-1, -2)) - dsum[..., None]) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_backward_reference(q, k, v, o, do, lse, scale: float):
    """(dq, dk, dv) from the forward's o and lse: the TPU backward's math in
    f32, each gradient cast to its input's dtype (the two parts above)."""
    dq, dsum = attention_backward_dq_reference(q, k, v, o, do, lse, scale)
    return (dq, *attention_backward_dkv_reference(q, k, v, do, lse, dsum, scale))


class _FlashAttentionFn(torch.autograd.Function):
    """Attention with the hand-written backward. A CPU tensor runs the plain
    versions of both directions; a CUDA tensor launches the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            o, lse = reference_attention_lse(q, k, v, scale)
        else:
            o, lse = _launch(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = attention_backward_reference(q, k, v, o, do, lse, ctx.scale)
        else:
            dq, dk, dv = flash_attention_backward(q, k, v, o, do, lse, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(B, H, Nq, D) x (B, H, Nkv, D) -> (B, H, Nq, D), non-causal.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises on what it does not take). When autograd records, the op is a
    ``torch.autograd.Function``: the forward also writes the lse and the
    backward launches the dq and dk/dv kernels (plain versions on the CPU).
    On the card the output is a (B, H, Nq, D) view of a contiguous
    (B, Nq, H, D) tensor, so merging the heads back is free.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttentionFn.apply(q, k, v, float(scale))
    if q.device.type in ("cpu", "meta"):  # meta: shapes only (MAC counting)
        return reference_attention(q, k, v, scale)
    return _launch(q, k, v, float(scale))


def flash_attention_forward_lse(q, k, v, scale: float):
    """``(o, lse)`` by the forward kernel as autograd runs it. CUDA tensors only."""
    return _launch(q, k, v, float(scale), with_lse=True)


def _lib(name: str):
    lib = _LIBS.get(name)
    if lib is None:
        from ._build import load_library

        lib = load_library(name)
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        if name == "flash_attention_fwd":
            lib.flash_attention_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [i64] * 12 + [f32, ptr]
            lib.flash_attention_fwd.restype = i32
        else:
            lib.flash_attention_bwd_dq.argtypes = ([ptr] * 8 + [i32] * 6 + [i64] * 18
                                                   + [f32, ptr])
            lib.flash_attention_bwd_dq.restype = i32
            lib.flash_attention_bwd_dkv.argtypes = ([ptr] * 8 + [i32] * 6 + [i64] * 18
                                                    + [f32, ptr])
            lib.flash_attention_bwd_dkv.restype = i32
        _LIBS[name] = lib
    return lib


def _check(q, k, v):
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
    if not 1 <= d <= MAX_HEAD_DIM or nq < 1 or k.shape[2] < 1:
        raise ValueError(f"flash_attention: head dim {d} (max {MAX_HEAD_DIM}), "
                         f"Nq {nq}, Nkv {k.shape[2]}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")


def _heads_out(like: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, H, N, D) view of a contiguous (B, N, H, D) tensor."""
    b, h, n, d = like.shape
    return torch.empty((b, n, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def _on_device(dev, fn, *args):
    """``fn(*args, stream)`` on ``dev``'s current raw stream; enters a device
    context only when ``dev`` is not the current device."""
    if dev.index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def _launch(q, k, v, scale, with_lse=False):
    _check(q, k, v)
    b, h, nq, d = q.shape
    dev = q.device
    o = _heads_out(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=dev) if with_lse else None
    err = _on_device(
        dev, _lib("flash_attention_fwd").flash_attention_fwd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None, _DTYPE_CODES[q.dtype], b, h, nq, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], scale)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    LAUNCHES["attention"] += 1
    if with_lse:
        LAUNCHES["attention_lse"] += 1
        return o, lse
    return o


def flash_attention_backward(q, k, v, o, do, lse, scale: float):
    """(dq, dk, dv) by the backward kernels: the counterpart of
    :func:`attention_backward_reference` for CUDA tensors (raises on others).
    The dq kernel also writes D = rowsum(dO * O), which the dk/dv kernel,
    launched after it on the same stream, reads."""
    dq, dsum = flash_attention_backward_dq(q, k, v, o, do, lse, scale)
    return (dq, *flash_attention_backward_dkv(q, k, v, do, lse, dsum, scale))


def _check_bwd(q, k, v, do, *rows):
    """Checks the backward's inputs; returns dO in q's dtype, d contiguous."""
    _check(q, k, v)
    b, h, nq, _ = q.shape
    if do.shape != q.shape or do.device != q.device:
        raise ValueError(f"flash_attention backward: dO {tuple(do.shape)} for q "
                         f"{tuple(q.shape)}")
    for t in rows:
        if t.shape != (b, h, nq) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError("flash_attention backward: lse and dsum must be contiguous "
                             "(B, H, Nq) f32 on q's device")
    do = do.to(q.dtype)
    return do if do.stride(3) == 1 else do.contiguous()


def flash_attention_backward_dq(q, k, v, o, do, lse, scale: float):
    """``(dq, dsum)`` by the dq kernel (CUDA tensors only): the counterpart of
    :func:`attention_backward_dq_reference`."""
    do = _check_bwd(q, k, v, do, lse)
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device:
        raise ValueError(f"flash_attention backward: o {tuple(o.shape)} {o.dtype} for q "
                         f"{tuple(q.shape)} {q.dtype}")
    if o.stride(3) != 1:
        o = o.contiguous()
    b, h, nq, d = q.shape
    dsum = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    dq = _heads_out(q)
    err = _on_device(
        q.device, _lib("flash_attention_bwd").flash_attention_bwd_dq,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), _DTYPE_CODES[q.dtype],
        b, h, nq, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], *dq.stride()[:3], float(scale))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: CUDA error {err}")
    LAUNCHES["attention_bwd_dq"] += 1
    return dq, dsum


def flash_attention_backward_dkv(q, k, v, do, lse, dsum, scale: float):
    """``(dk, dv)`` by the dk/dv kernel (CUDA tensors only), given the dq
    kernel's ``dsum``: the counterpart of :func:`attention_backward_dkv_reference`."""
    do = _check_bwd(q, k, v, do, lse, dsum)
    b, h, nq, d = q.shape
    dk, dv = _heads_out(k), _heads_out(v)
    err = _on_device(
        q.device, _lib("flash_attention_bwd").flash_attention_bwd_dkv,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODES[q.dtype],
        b, h, nq, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dk.stride()[:3], *dv.stride()[:3], float(scale))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: CUDA error {err}")
    LAUNCHES["attention_bwd_dkv"] += 1
    return dk, dv
