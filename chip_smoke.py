#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diff_pruning_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--compare-bwd LABEL=SRC ...]

Drives the port's four paths, through its own kernels on the full-width
CIFAR-10 UNet (35.75M params) from a seeded random checkpoint, and checks
them: the serving path (DDIM-100 sampling), the pruning path (the
Diff-Pruning sweep, scoring, slicing and the prune CLI), the finetune
path (the train CLI on the pruned checkpoint, f32 and bf16, and its
resume) and the evaluation path (the fid_score and fidelity CLIs through
the full-width FID InceptionV3, which runs no kernel of the port). Every
phase raises on failure; none is caught, so any failure exits non-zero
before the result lines.

1. Device: CUDA must be available; prints nvidia-smi's name and power limit.
2. Build: compiles every kernel of the port, CUDA C++ from this
   checkout's sources (one nvcc per source, sm_90a, all at once); prints
   the build seconds and ptxas's registers and spills (per kernel for the
   attention backward, f32 and bf16/f16, and the GroupNorm backward), and
   counts the tensor-core (HMMA) and FFMA instructions in the SASS
   (cuobjdump) of the attention kernels and the GroupNorm backward: the
   bf16/f16 attention kernels (forward, dq, dk/dv) must use the tensor
   cores, the f32 attention kernels and the GroupNorm backward must not.
   With ``--compare-bwd LABEL=SRC`` (repeatable) it also builds SRC,
   another version of flash_attention_bwd.cu with the same C interface
   (e.g. the parent commit's, unpacked by ``git archive``), for phase 13.
3. Forward kernels against their plain versions on the card, B = 128, f32
   and bf16, at every GroupNorm and attention shape the dense, the pruned
   and the prune CLI's UNet give them (collected by forward hooks), plus a
   ragged token count.
4. Full-width forward, B = 128, kernels on and off on the same weights;
   the strides of every GroupNorm input the layers pass (also under
   autograd, in phase 9).
5. Serving path, dense: the sampling CLI, 256 images in batches of 128,
   DDIM-100; launch counters reset just before and read just after.
6. Serving path, pruned: the same CLI on a checkpoint keeping
   floor(0.7 * size / group_div) * group_div channels of every prunable var.
7. Timings (CUDA events, in turns): per-op forward kernel against plain and
   the library call at the main-path shapes (attention also in TFLOP/s),
   the GroupNorm wrapper's host time per call, dense and pruned sampling
   imgs/s with the kernels on and off, f32 and bf16, and a torch.profiler
   breakdown of 5 dense DDIM steps by kernel class.
8. Backward kernels against their plain versions, at the same shapes, B =
   128, f32 and bf16: the forward's saved GroupNorm statistics and the
   attention lse, then dx/dscale/dbias and dq/dk/dv.
9. The sweep at full width, B = 128, f32, 3 timesteps, kernels on against
   off on the same x0 and noise (cuDNN deterministic): losses, every
   parameter's grad, Diff-Pruning scores, launch counts per step, and the
   strides of x and dy at the GroupNorm backward; then the kernel-on sweep
   again, whose grads must be bit-identical.
10. Pruning path: the prune CLI, diff-pruning at ratio 0.3, thr 0.05, at
   most 20 sweep steps, B = 128, on a seeded .npz of 128 images; launch
   counters reset just before and read just after. The checkpoint it
   writes reloads at the pinned param count, and the sampling CLI draws 128
   finite images from it.
11. Finetune path, f32 (the main path of the latest slice): the train CLI
   on that checkpoint and .npz, B = 128, 20 steps, a checkpoint and a
   DDIM-100 vis grid every 10 (cuDNN deterministic); launch counters reset
   just before and read just after, equal to calls x steps plus the vis
   forwards. Then a resume from the step-10 checkpoint into another
   directory, whose step-20 params, EMA and Adam state must be
   bit-identical to the uninterrupted run's; the EMA weights reload at the
   pinned param count and the sampling CLI draws finite images from them.
12. Finetune path, bf16 (``--mixed_precision bf16``), 10 steps: finite
   losses, and the launch counts, every GroupNorm and attention backward
   taken in bf16 (the 16-bit dq and dk/dv kernels, the bf16 GroupNorm
   backward).
13. Timings: per-op backward kernels against plain and the library call
   (attention dq and dk/dv also in TFLOP/s, at the dense UNet's shapes and,
   in bf16, at the prune CLI's UNet's (D = 179) too; with ``--compare-bwd``
   also the other versions' dq and dk/dv, in turns with these), the
   GroupNorm backward wrapper's host time per call, the sweep step (forward
   + backward, f32) with the kernels on and off, and a torch.profiler
   breakdown of the sweep step by kernel class.
14. The train step: kernels on against off (dense, 3 steps from the same
   state on the same noise and t, no dropout), in f32 and in bf16 (the
   16-bit dq and dk/dv inside the model): losses and the first step's
   grads; then train step ms and imgs/s, dense and pruned, f32 and bf16,
   kernels on and off (CUDA events, in turns), peak memory, the optimizer +
   EMA ms per step, and torch.profiler breakdowns of one train step of each
   (with the dq and dk/dv kernels' device ms).
15. Evaluation path, f32, TF32 off, the FID Inception's random init at
   seed 0 (no pt_inception weights are in the repository): pool3 features
   of 8 images on the card against the port's plain CPU forward (both
   resize modes, 32x32 and 512x512 inputs); the fid_score CLI saves the
   statistics of 2048 procedural 32x32 PNGs, scores phases 5 and 6's
   sample folders and the procedural folder itself against them, then the
   same with ``--clean`` (and the resize-mode warning when clean statistics
   are read in torch mode); the fidelity CLI on the dense samples against
   the procedural folder with a .pth of the random init plus a seeded fc
   head. Then Inception imgs/s at B = 128 in both modes (CUDA events, in
   turns), the CLI's wall time, the host's decode and resize of the folder
   alone (16 threads and one), and a torch.profiler breakdown of one
   512-image ``features_of_path``. No kernel of the port runs here: the
   JAX evaluation path reaches no ``pl.pallas_call``.
16. The evaluation JSON line, the kernels' JSON line, nvidia-smi's line,
   then the result line.

TF32 is off for matmuls and convolutions throughout (printed), so f32
comparisons are f32 against f32.
"""

import collections
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B = 128
# forward: |kernel - plain| <= atol + rtol * |plain|. f32: both compute in f32
# and differ only in summation order. bf16: two bf16 ulps; both round an f32
# result once, and the plain attention also rounds its probabilities.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
# backward: |kernel - plain| <= tol * max |plain| per output. Both compute in
# f32 from the same inputs and statistics and differ in summation order,
# then round once to the output dtype (bf16: well under one ulp of the max).
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# kernels on vs off through the whole f32 UNet (outputs of order 1)
FORWARD_TOL_F32 = 1e-3
# the sweep, kernels on vs off, f32, 3 fwd+bwd steps through the full UNet:
# losses to 1e-4 relative; each grad within 1e-3 of its parameter's max
# |grad| (plus 1e-6 of the largest grad overall, for the grads that are zero
# in exact arithmetic, such as to_k's bias); Diff-Pruning scores within 1e-3
# of each var's max score. Sum orders differ through ~60 layers each way.
SWEEP_STEPS = 3
SWEEP_LOSS_RTOL, SWEEP_GRAD_TOL, SWEEP_SCORE_RTOL = 1e-4, 1e-3, 1e-3
# params of the CIFAR UNet pruned locally at ratio 0.3 (pinned from the JAX
# package's pruner in tests/test_torch_pruning.py)
PRUNED_PARAMS_AT_0_3 = 19_951_049
# the finetune path: f32 steps, bf16 steps, the save (and vis) interval,
# vis images; the train step kernels on vs off: 3 steps, losses to 1e-4
# relative, the first step's grads to the sweep's rule (SWEEP_GRAD_TOL)
FT_STEPS, FT_BF16_STEPS, FT_SAVE, FT_VIS = 20, 10, 10, 16
TRAIN_STEPS, TRAIN_LOSS_RTOL = 3, 1e-4
# the bf16 train step kernels on vs off: losses to 2e-2 relative, the first
# step's grads within 5e-2 in norm relative to their norm: the port's bf16
# train-step tolerances against the JAX step (tests/test_torch_training.py),
# since bf16 rounds activations and grads at other places on the two sides
TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GRAD_RTOL = 2e-2, 5e-2
# the evaluation path: the card's pool3 features against the port's plain CPU
# forward, relative error in norm (both f32 with TF32 off; summation order
# only); |FID| of a folder against its own statistics, relative to the trace
# of its covariance: 0 in exact arithmetic, but each of the up to 2048
# eigenvalues that are 0 in exact arithmetic (the features' spread is
# low-rank) adds up to ~sqrt(float64 eps) x the largest through the square
# roots, ~3e-5 of the trace in all; the procedural folder's size
EVAL_FEATURE_RTOL, EVAL_SELF_FID_RTOL, EVAL_IMAGES = 1e-4, 1e-4, 2048
# H100 SXM, NVIDIA's data sheet: HBM rate, and peak rates by input type
# (f32 on the CUDA cores, bf16 dense tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
NBYTES = {"float32": 4, "bfloat16": 2}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, iters: int):
    """Mean ms of each of ``fns``, timed in order and then in reverse order
    (two functions: a, b, b, a)."""
    first = [cuda_ms(f, iters) for f in fns]
    second = [cuda_ms(f, iters) for f in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def bound(nbytes: float, flops: float, dname: str):
    """(ms, 'bytes' | 'operations'): the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# bytes each function must move (inputs read once, outputs written once) and
# the operations it does, per call; GroupNorm per element: stats 3, apply 2,
# SiLU 4; backward: reduce 5, apply 7, SiLU derivative 8 in each pass
def gn_fwd_work(n, c, silu, dname):
    el = B * n * c
    return 2 * el * NBYTES[dname] + 2 * c * 4, el * (9 if silu else 5)


def gn_bwd_work(n, c, silu, dname):
    el = B * n * c
    return 3 * el * NBYTES[dname] + B * 32 * 8 + 4 * c * 4, el * (28 if silu else 12)


def attn_fwd_work(n, h, d, dname):
    return 4 * B * h * n * d * NBYTES[dname], 4 * B * h * n * n * d


def attn_dq_work(n, h, d, dname):
    rows = B * h * n
    return 6 * rows * d * NBYTES[dname] + 2 * rows * 4, 6 * rows * n * d + 2 * rows * d


def attn_dkv_work(n, h, d, dname):
    rows = B * h * n
    return 6 * rows * d * NBYTES[dname] + 2 * rows * 4, 8 * rows * n * d


def add_bound(tot, prefix, ms, by):
    """Adds a call's bound to ``tot[prefix + 'bound']`` and to the share that
    ``by`` sets, so that ``bound_by(tot, prefix)`` can name the larger."""
    tot[prefix + "bound"] += ms
    tot[f"{prefix}bound_{by}"] += ms


def bound_by(tot, prefix=""):
    return ("bytes" if tot.get(prefix + "bound_bytes", 0.0)
            >= tot.get(prefix + "bound_operations", 0.0) else "operations")


def kernel_class(name: str) -> str:
    n = name.lower()
    if "gn_fwd_kernel" in n:  # the CUDA kernels, mangled
        return "GroupNorm forward"
    if "gn_bwd_kernel" in n:
        return "GroupNorm backward"
    if "flash_fwd_kernel" in n or "flash_bwd_" in n:  # the CUDA kernels, mangled
        return "attention kernels"
    if any(w in n for w in ("conv", "fft", "winograd", "implicit", "grad", "cudnn", "xmma",
                            "flip")):
        return "convolutions"
    if any(w in n for w in ("gemm", "cutlass", "cublas")):
        return "GEMMs"
    if "multi_tensor_apply" in n or "foreach" in n:
        return "optimizer and EMA (foreach)"
    if "reduce" in n:
        return "reductions"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def sass_counts(lib_path):
    """{kernel: (HMMA count, FFMA count)} from cuobjdump's SASS of a built
    library, or None where the toolkit has no cuobjdump."""
    from diff_pruning_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(os.path.realpath(_build.nvcc_path())), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], check=True, capture_output=True,
                         text=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += " HMMA" in line
            counts[name][1] += " FFMA" in line
    return counts


def ptxas_by_kernel(log: str, pattern: str, name_of):
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    ``nvcc -Xptxas -v``'s log, for the kernels whose mangled name matches
    ``pattern``, named by ``name_of(match)``."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(pattern, line)
        if "Compiling entry function" in line:
            name = name_of(m) if m else None
        elif name is not None and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name] = [None, int(nums[0]), int(nums[1])]
        elif name is not None and "registers" in line and name in out:
            out[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return {k: tuple(v) for k, v in out.items()}


# the kernels whose registers and spills phase 2 prints one by one: the
# attention backward (``flash_bwd_dq_kernel_f32<NC>``,
# ``flash_bwd_dkv_kernel_mma<T, NC>``) and the GroupNorm backward
# (``gn_bwd_kernel<T, silu>``)
PTXAS_KERNELS = {
    "flash_attention_bwd": (r"Compiling entry function '.*?(flash_bwd_\w+?_(?:f32|mma))"
                            r"I(13__nv_bfloat16|6__half)?Li(\d)E",
                            lambda m: f"{m.group(1)}<" + (
                                m.group(2).lstrip("0123456789") + ", " if m.group(2) else "")
                            + f"{m.group(3)}>"),
    "group_norm_bwd": (r"Compiling entry function '.*?gn_bwd_kernelI(f|13__nv_bfloat16|6__half)"
                       r"Lb(\d)E",
                       lambda m: f"gn_bwd_kernel<{m.group(1).lstrip('0123456789')}, "
                                 f"silu={m.group(2)}>"),
}


def load_other_bwd(label: str, src: str):
    """The library of another version of flash_attention_bwd.cu with the
    port's C interface, built as the port builds its own (nvcc, the same
    flags, the port's csrc/ on the include path) and bound as
    ops/attention.py binds it."""
    import ctypes

    from diff_pruning_tpu_torch.ops import _build
    from diff_pruning_tpu_torch.ops import attention as A

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"libflash_attention_bwd-{label}.so")
    t0 = time.perf_counter()
    # (-I: the port's shared headers, for a version that includes them)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build._CSRC, "-o", out,
                          os.path.abspath(src)], capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n{res.stderr}")
    print(f"build: {label}: {src} (nvcc sm_90a) {time.perf_counter() - t0:.2f}s")
    lib, ours = ctypes.CDLL(out), A._lib("flash_attention_bwd")
    for fn in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
        getattr(lib, fn).restype = getattr(ours, fn).restype
    return lib


def with_bwd_lib(lib, fn):
    """``fn`` as a function that runs it with ops/attention.py's backward
    library set to ``lib``."""
    from diff_pruning_tpu_torch.ops import attention as A

    def run():
        saved = A._LIBS["flash_attention_bwd"]
        A._LIBS["flash_attention_bwd"] = lib
        try:
            return fn()
        finally:
            A._LIBS["flash_attention_bwd"] = saved

    return run


def layout_name(x3) -> str:
    """What a GroupNorm kernel reads: x3 is the (B, ..., C) tensor a layer
    passes."""
    if x3.is_contiguous():
        return "channels-last ((B, N, C) contiguous)"
    if x3.permute(0, x3.dim() - 1, *range(1, x3.dim() - 1)).is_contiguous():
        return "NCHW-contiguous ((B, N, C) strides (C*N, 1, N))"
    return f"other, strides {tuple(x3.stride())}"


def record_gn_layouts(model):
    """Hooks counting the layouts of the GroupNorm inputs; returns (counter,
    remove)."""
    from diff_pruning_tpu_torch.models.layers import GroupNorm

    seen = collections.Counter()

    def hook(mod, args):
        seen[layout_name(args[0].permute(0, 2, 3, 1))] += 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, GroupNorm)]
    return seen, lambda: [h.remove() for h in hooks]


def record_gn_bwd_layouts():
    """Counts the layouts of x and dy as the GroupNorm backward wrapper gets
    them (under autograd); returns (counter, restore)."""
    from diff_pruning_tpu_torch.ops import group_norm as G

    seen, inner = collections.Counter(), G.group_norm_backward

    def wrapped(x, scale, bias, dy, *args, **kwargs):
        seen[f"x {layout_name(x)}, dy {layout_name(dy)}"] += 1
        return inner(x, scale, bias, dy, *args, **kwargs)

    G.group_norm_backward = wrapped
    return seen, lambda: setattr(G, "group_norm_backward", inner)


def record_bwd_dtypes():
    """Counts the (op, dtype) of every GroupNorm and attention backward that
    autograd runs through the kernels' wrappers; returns (counter, restore)."""
    from diff_pruning_tpu_torch.ops import attention as A
    from diff_pruning_tpu_torch.ops import group_norm as G

    seen = collections.Counter()
    gn, attn = G.group_norm_backward, A.flash_attention_backward

    def gn_wrapped(x, *args, **kwargs):
        seen[("group_norm_bwd", str(x.dtype))] += 1
        return gn(x, *args, **kwargs)

    def attn_wrapped(q, *args, **kwargs):
        seen[("attention_bwd", str(q.dtype))] += 1
        return attn(q, *args, **kwargs)

    G.group_norm_backward, A.flash_attention_backward = gn_wrapped, attn_wrapped

    def restore():
        G.group_norm_backward, A.flash_attention_backward = gn, attn

    return seen, restore


def npz_equal(a: str, b: str) -> bool:
    """Whether two .npz files hold the same arrays, bit for bit."""
    import numpy as np

    with np.load(a) as za, np.load(b) as zb:
        return sorted(za.files) == sorted(zb.files) and all(
            za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]) for k in za.files)


def host_us_per_call(fn, calls: int = 200) -> float:
    """The host's enqueue time of ``fn`` per call: perf_counter over
    ``calls`` calls without a sync, after a warm-up."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def profile_classes(fn):
    """Device time by kernel class (ms), the host span (ms), the kernel count
    and the kernel count by class of one run of ``fn``, from torch.profiler's
    CUPTI trace."""
    return profile_kernels(fn)[:4]


def eval_kernel_class(name: str) -> str:
    """The evaluation path's classes: cuDNN convolutions, pools, the rest."""
    if kernel_class(name) == "convolutions":
        return "convolutions"
    return "pools" if "pool" in name.lower() else "the rest"


def profile_kernels(fn, classify=kernel_class):
    """:func:`profile_classes`'s four results, then device ms by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    busy, counts = collections.defaultdict(float), collections.Counter()
    by_name = collections.defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        busy[classify(evt.key)] += us / 1e3
        counts[classify(evt.key)] += evt.count
        by_name[evt.key] += us / 1e3
    return dict(busy), span, sum(counts.values()), dict(counts), dict(by_name)


def print_profile(what, busy, span, launches, counts, per, tag):
    print(f"profile {what} (torch.profiler, device ms per {per[0]} by kernel class): "
          + ", ".join(f"{k} {v / per[1]:.2f}" for k, v in sorted(busy.items()))
          + f"; device busy {sum(busy.values()) / per[1]:.2f} of {span / per[1]:.2f} ms span "
          + "per " + per[0] + ", idle share "
          + (f"{1 - sum(busy.values()) / span:.3f}" if busy else "not measured")
          + f", {launches / per[1]:.0f} kernel launches per {per[0]} ("
          + ", ".join(f"{k} {v / per[1]:.1f}" for k, v in sorted(counts.items())) + f") {tag}")


def cli_pruned_config(cfg, model):
    """The config that the prune CLI writes at ratio 0.3: in local mode the
    kept sizes depend only on the ratio and each var's constraints, so
    magnitude scores of any weights give them."""
    from diff_pruning_tpu_torch.pruning.importance import make_importance
    from diff_pruning_tpu_torch.pruning.pruner import prune
    from diff_pruning_tpu_torch.pruning.surgery import unflatten_params
    from diff_pruning_tpu_torch.utils.checkpoint import flat_from_state_dict

    params = unflatten_params(flat_from_state_dict(model.state_dict()))
    res = prune(model.graph, params, make_importance("magnitude"), sparsity=0.3)
    return cfg.with_channel_sizes(res.channel_sizes)


def pruned_config(cfg):
    from diff_pruning_tpu_torch.models.unet2d import UNet2D

    graph = UNet2D(cfg, device="meta").graph
    return cfg.with_channel_sizes({
        v.name: max(v.group_div, int(0.7 * v.size / v.group_div) * v.group_div)
        for v in graph.prunable_vars()})


def op_shapes(model):
    """Counters of (N, C, silu) per GroupNorm call and (N, heads, D) per
    attention call in one forward (B = 1 on the CPU)."""
    import torch

    from diff_pruning_tpu_torch.models.layers import GroupNorm, SelfAttention2D

    gn, attn = collections.Counter(), collections.Counter()

    def on_gn(mod, args, kwargs, out):
        x = args[0]
        gn[(x.shape[2] * x.shape[3], x.shape[1], bool(kwargs.get("with_silu", False)))] += 1

    def on_attn(mod, args, kwargs, out):
        x = args[0]
        attn[(x.shape[2] * x.shape[3], mod.heads, mod.inner.size // mod.heads)] += 1

    hooks = [m.register_forward_hook(on_gn if isinstance(m, GroupNorm) else on_attn,
                                     with_kwargs=True)
             for m in model.modules() if isinstance(m, (GroupNorm, SelfAttention2D))]
    hw = model.cfg.sample_size
    with torch.inference_mode():
        model(torch.zeros((1, hw, hw, model.cfg.in_channels)), torch.tensor([1]))
    for h in hooks:
        h.remove()
    return gn, attn


def compare(got, want, dtype):
    import torch

    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (err <= atol + rtol * want.float().abs()).all())
    return float(err.max()), ok


def compare_rel(got, want, tol):
    """(max abs err, ok) for |got - want| <= tol * max |want|."""
    import torch

    err = float((got.float() - want.float()).abs().max())
    ok = (got.shape == want.shape and bool(torch.isfinite(got.float()).all())
          and err <= tol * float(want.float().abs().max()))
    return err, ok


def run_cli(main_fn, argv):
    """Runs a CLI's ``main`` with its output captured, then prints it:
    (return value, output, wall seconds up to a device sync)."""
    import contextlib
    import io

    import torch

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main_fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    return out, buf.getvalue(), seconds


def evaluation_path(tmp, sample_dirs, gpu, tag):
    """Phase 15 (see the module docstring); returns its figures."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image

    from diff_pruning_tpu_torch.cli import fid_score, fidelity
    from diff_pruning_tpu_torch.data.datasets import get_dataset
    from diff_pruning_tpu_torch.data.procedural import make_procedural_dataset
    from diff_pruning_tpu_torch.eval.fid import features_of_path
    from diff_pruning_tpu_torch.eval.inception import (fid_inception, inception_pool3,
                                                       random_init_fid_inception_state_dict)
    from diff_pruning_tpu_torch.eval.resize import resize_bicubic_pil

    dev = torch.device("cuda", 0)
    sd = random_init_fid_inception_state_dict(0)
    plain, card = fid_inception(sd, "cpu"), fid_inception(sd, dev)

    def pool3(model, x, mode):
        with torch.inference_mode():
            if mode == "clean":
                return inception_pool3(model, resize_bicubic_pil(x, 299, 299), resize=False)
            return inception_pool3(model, x)

    out = {"card": gpu, "inception": "random init, seed 0", "feature_rel_err": {}}
    for hw in (32, 512):
        x = torch.from_numpy(make_procedural_dataset(n=8, hw=hw, seed=1)).float() / 255.0
        for mode in ("torch", "clean"):
            want = pool3(plain, x, mode)
            got = pool3(card, x.to(dev), mode).cpu()
            err = float((got - want).norm() / want.norm())
            out["feature_rel_err"][f"{mode}/{hw}"] = err
            print(f"check inception pool3 {mode} {hw}x{hw} -> 299, 8 images, f32: card against "
                  f"the plain CPU forward, relative error in norm {err:.3e} "
                  f"(tol {EVAL_FEATURE_RTOL}), |feature| max {float(want.abs().max()):.2f}")
            assert got.shape == (8, 2048) and bool(torch.isfinite(got).all())
            assert err <= EVAL_FEATURE_RTOL, (mode, hw, err)

    # the fid_score CLI: stats of a procedural folder, then sample folders against them
    proc = os.path.join(tmp, "procedural")
    os.makedirs(proc)
    for i, im in enumerate(make_procedural_dataset(n=EVAL_IMAGES, hw=32, seed=0)):
        Image.fromarray(im).save(os.path.join(proc, f"{i:05d}.png"))
    stats, clean_stats = (os.path.join(tmp, f"procedural_{m}.npz") for m in ("torch", "clean"))
    seed = ["--random-init-seed", "0", "--device", "cuda"]
    _, _, t_save = run_cli(fid_score.main, [proc, stats, "--save-stats"] + seed)
    fids = {}
    for name, d in sample_dirs.items():
        fids[name], _, _ = run_cli(fid_score.main, [d, stats] + seed)
    fids["procedural_self"], _, t_self = run_cli(fid_score.main, [proc, stats] + seed)
    with np.load(stats) as z:
        trace = float(np.trace(z["sigma"]))
        assert z["mu"].shape == (2048,) and z["sigma"].shape == (2048, 2048)
    print(f"fid_score CLI, random-init Inception seed 0, 2048 procedural 32x32 PNGs: "
          f"--save-stats {t_save:.2f} s ({EVAL_IMAGES / t_save:.1f} imgs/s), the folder against "
          f"its stats {t_self:.2f} s ({EVAL_IMAGES / t_self:.1f} imgs/s) (wall, B={B}, f32) {tag}; "
          f"FID dense {fids['dense']:.4f}, pruned {fids['pruned']:.4f}, self "
          f"{fids['procedural_self']:.3e} (tol {EVAL_SELF_FID_RTOL} x trace {trace:.4f})")
    assert all(math.isfinite(v) for v in fids.values()), fids
    assert abs(fids["procedural_self"]) <= EVAL_SELF_FID_RTOL * trace, fids
    _, _, t_clean = run_cli(fid_score.main, [proc, clean_stats, "--save-stats", "--clean"] + seed)
    fids["dense_clean"], _, _ = run_cli(fid_score.main,
                                        [sample_dirs["dense"], clean_stats, "--clean"] + seed)
    _, text, _ = run_cli(fid_score.main, [sample_dirs["dense"], clean_stats] + seed)
    assert "resize_mode=clean but this run uses torch" in text, text
    print(f"fid_score CLI --clean: --save-stats {t_clean:.2f} s "
          f"({EVAL_IMAGES / t_clean:.1f} imgs/s) {tag}; FID dense {fids['dense_clean']:.4f}; "
          "clean stats read in torch mode warn")
    assert math.isfinite(fids["dense_clean"])

    # the fidelity CLI, with the random init plus a seeded fc head as a .pth
    rng = np.random.default_rng(7)
    weights = os.path.join(tmp, "fid_inception_random_fc.pth")
    torch.save({**sd, "fc.weight": torch.from_numpy(
        rng.standard_normal((1008, 2048)).astype(np.float32) * 0.02),
        "fc.bias": torch.from_numpy(rng.standard_normal(1008).astype(np.float32) * 0.1)},
        weights)
    metrics, _, t_fidelity = run_cli(fidelity.main, [
        "--input1", sample_dirs["dense"], "--input2", proc, "--weights", weights,
        "--device", "cuda"])
    print(f"fidelity CLI, dense samples against the procedural folder: {t_fidelity:.2f} s "
          f"(wall) {tag}")
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    # the Inception Score is exp of a mean KL >= 0: [1, 1008] up to float rounding
    assert 1.0 - 1e-9 <= metrics["inception_score_mean"] <= 1008.0, metrics
    assert 0.0 <= metrics["precision"] <= 1.0 and 0.0 <= metrics["recall"] <= 1.0, metrics

    # timings: the Inception at B = 128 on a batch of the folder's decoded size
    macs = 0

    def count(mod, inp, res):
        nonlocal macs
        macs += res.numel() * mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]

    hooks = [m.register_forward_hook(count) for m in card.modules()
             if isinstance(m, torch.nn.Conv2d)]
    pool3(card, torch.zeros((1, 299, 299, 3), device=dev), "torch")
    for h in hooks:
        h.remove()
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.rand((B, 256, 256, 3), generator=gen, device=dev)
    ms_torch, ms_clean = in_turns([lambda: pool3(card, x, "torch"),
                                   lambda: pool3(card, x, "clean")], iters=5)
    tflops = 2 * macs * B / (ms_torch / 1e3) / 1e12
    print(f"time inception B={B} 256x256 -> 299, f32: torch mode {ms_torch:.2f} ms "
          f"({B * 1e3 / ms_torch:.1f} imgs/s, {tflops:.1f} TFLOP/s of convolutions at "
          f"{macs / 1e9:.3f} GMACs an image), clean mode {ms_clean:.2f} ms "
          f"({B * 1e3 / ms_clean:.1f} imgs/s) (CUDA events, in turns, 5 calls each) {tag}")
    # the host's share: the folder's decode and 256x256 resize alone, as
    # features_of_path runs it (16 threads), and on one thread
    ds = get_dataset(proc)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=16) as pool:
        assert len(list(pool.map(ds.load, range(EVAL_IMAGES)))) == EVAL_IMAGES
    t_decode = time.perf_counter() - t0
    n1 = min(256, EVAL_IMAGES)
    t0 = time.perf_counter()
    for i in range(n1):
        ds.load(i)
    t_decode1 = (time.perf_counter() - t0) * EVAL_IMAGES / n1
    print(f"host decode + 256x256 resize of the {EVAL_IMAGES} PNGs (PIL): "
          f"{EVAL_IMAGES / t_decode:.1f} imgs/s on 16 threads, {EVAL_IMAGES / t_decode1:.1f} on "
          f"one ({n1} images), "
          f"{os.cpu_count()} CPUs {tag}")
    busy, span, launches, counts, _ = profile_kernels(
        lambda: features_of_path(proc, card, batch_size=B, max_images=512), eval_kernel_class)
    print_profile("features_of_path, 512 procedural PNGs", busy, span, launches, counts,
                  ("512 images", 1), tag)
    out.update(
        fid=fids, fid_trace=trace, inception_gmacs_per_image=macs / 1e9,
        inception_imgs_per_s={"torch": B * 1e3 / ms_torch, "clean": B * 1e3 / ms_clean},
        inception_ms_b128={"torch": ms_torch, "clean": ms_clean}, inception_tflops=tflops,
        fid_cli_seconds={"save_stats": t_save, "self": t_self, "save_stats_clean": t_clean},
        fid_cli_imgs_per_s={"save_stats": EVAL_IMAGES / t_save, "self": EVAL_IMAGES / t_self,
                            "save_stats_clean": EVAL_IMAGES / t_clean},
        fidelity=metrics, fidelity_cli_seconds=t_fidelity,
        host_decode_imgs_per_s={"16_threads": EVAL_IMAGES / t_decode,
                                "1_thread": EVAL_IMAGES / t_decode1},
        profile_512={"busy_ms": busy, "span_ms": span, "launches": launches,
                     "idle_share": 1 - sum(busy.values()) / span})
    return out


def main() -> None:
    import argparse

    import numpy as np
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    ap.add_argument("--compare-bwd", metavar="LABEL=SRC", action="append", default=[],
                    help="another flash_attention_bwd.cu (same C interface) whose dq and dk/dv "
                         "phase 13 times in turns with this checkout's; repeatable")
    args = ap.parse_args()
    other_srcs = [arg.partition("=")[::2] for arg in args.compare_bwd]  # (label, source)
    if not all(label and src for label, src in other_srcs):
        ap.error(f"--compare-bwd takes LABEL=SRC, got {args.compare_bwd}")

    # -- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: this smoke run "
                         "needs an NVIDIA GPU")
    gpu = gpu_line()
    print(gpu, flush=True)
    tag = f"[{gpu}]"
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    sys.path.insert(0, REPO)
    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.cli import ddpm_prune, ddpm_sample, ddpm_train
    from diff_pruning_tpu_torch.diffpruning.sweep import (accumulate_taylor_grads,
                                                          make_loss_fn)
    from diff_pruning_tpu_torch.models.unet2d import UNet2D, ddpm_cifar10_config
    from diff_pruning_tpu_torch.ops import _build
    from diff_pruning_tpu_torch.ops import attention as A
    from diff_pruning_tpu_torch.ops import group_norm as G
    from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
    from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference
    from diff_pruning_tpu_torch.pruning.importance import make_importance
    from diff_pruning_tpu_torch.pruning.surgery import unflatten_params
    from diff_pruning_tpu_torch.sampling.ddim_sampler import SamplerConfig, make_sampler
    from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
    from diff_pruning_tpu_torch.training.ema import ema_update
    from diff_pruning_tpu_torch.training.finetune import (TrainConfig, antithetic_timesteps,
                                                          init_train_state, make_optimizer,
                                                          make_train_step)
    from diff_pruning_tpu_torch.utils.checkpoint import (flat_from_state_dict, load_model,
                                                         save_model)

    # -- 2. build: one nvcc per CUDA source, all at once
    t_build = time.perf_counter()
    _build.build_libraries()
    for name in _build.CUDA_LIBRARIES:
        info = _build.BUILD_INFO[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build: {name}.cu (nvcc sm_90a) {info['seconds']:.2f}s; " + " | ".join(ptxas))
    print(f"build: all builds {time.perf_counter() - t_build:.2f}s")
    regs = {lib: ptxas_by_kernel(_build.BUILD_INFO[lib]["log"], *PTXAS_KERNELS[lib])
            for lib in PTXAS_KERNELS}
    for lib, kernels in regs.items():
        for kname, (nregs, st, ld) in sorted(kernels.items()):
            print(f"ptxas: {lib} {kname}: {nregs} registers, spill stores {st} bytes, "
                  f"spill loads {ld} bytes")
    if _build.BUILD_INFO["flash_attention_bwd"]["log"]:  # empty when already built
        assert {k.split("<")[0] for k in regs["flash_attention_bwd"]} == {
            "flash_bwd_dq_kernel_f32", "flash_bwd_dkv_kernel_f32", "flash_bwd_dq_kernel_mma",
            "flash_bwd_dkv_kernel_mma"}, regs
        # f32: dq at 4 head-dim paddings, dk/dv at 2; 16-bit: 2 types x 4 x 2 kernels
        assert len(regs["flash_attention_bwd"]) == 22, regs
    if _build.BUILD_INFO["group_norm_bwd"]["log"]:
        assert len(regs["group_norm_bwd"]) == 6, regs  # 3 dtypes x SiLU or not
    for lib in ("flash_attention_fwd", "flash_attention_bwd", "group_norm_bwd"):
        sass = sass_counts(_build.load_library(lib)._name)
        if sass is None:
            print("sass: no cuobjdump in the toolkit; tensor-core use not checked")
            break
        for kname, (hmma, ffma) in sorted(sass.items()):
            print(f"sass: {lib} {kname}: {hmma} HMMA, {ffma} FFMA")
            if "_kernel_mma" in kname:  # forward, dq and dk/dv in bf16/f16
                assert hmma > 0, f"{kname} has no tensor-core instruction"
            if "_kernel_f32" in kname or "gn_bwd_kernel" in kname:
                assert hmma == 0 and ffma > 0, f"{kname} is not f32 on the CUDA cores"
        wants = {"flash_attention_fwd": ("flash_fwd_kernel_mma",),
                 "flash_attention_bwd": ("flash_bwd_dq_kernel_f32", "flash_bwd_dkv_kernel_f32",
                                         "flash_bwd_dq_kernel_mma", "flash_bwd_dkv_kernel_mma"),
                 "group_norm_bwd": ("gn_bwd_kernel",)}[lib]
        for want in wants:
            assert sum(want in kname for kname in sass) >= 2, (want, sorted(sass))
    ours = A._lib("flash_attention_bwd")
    # label -> library of another version of the attention backward
    others = {label: load_other_bwd(label, src) for label, src in other_srcs}

    # -- 3. forward kernels against plain versions at the UNet's shapes, B = 128
    cfg = ddpm_cifar10_config()
    pcfg = pruned_config(cfg)
    dense = UNet2D(cfg, device="cpu").init(torch.Generator().manual_seed(0)).eval()
    pruned = UNet2D(pcfg, device="cpu").init(torch.Generator().manual_seed(1)).eval()
    # the prune CLI's UNet (phase 10), which the finetune path trains
    ftcfg = cli_pruned_config(cfg, dense)
    ftnet = UNet2D(ftcfg, device="cpu").init(torch.Generator().manual_seed(5)).eval()
    gn_dense, attn_dense = op_shapes(dense)
    gn_pruned, attn_pruned = op_shapes(pruned)
    gn_ft, attn_ft = op_shapes(ftnet)
    print(f"dense UNet: {sum(gn_dense.values())} GroupNorm and {sum(attn_dense.values())} "
          f"attention calls per forward; pruned: {sum(gn_pruned.values())} and "
          f"{sum(attn_pruned.values())}; prune CLI's (finetune path, "
          f"{sum(p.numel() for p in ftnet.parameters())} params): {sum(gn_ft.values())} and "
          f"{sum(attn_ft.values())}")
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = collections.defaultdict(float)
    gn_cases = sorted(set(gn_dense) | set(gn_pruned) | set(gn_ft))
    for n, c, silu in gn_cases:
        for dname in TOL:
            dtype = getattr(torch, dname)
            x = (torch.randn((B, n, c), generator=gen, device=dev) * 2 + 0.5).to(dtype)
            scale = torch.rand((c,), generator=gen, device=dev) + 0.5
            bias = torch.randn((c,), generator=gen, device=dev) * 0.1
            got = group_norm(x, scale, bias, groups=32, with_silu=silu)
            want = group_norm_reference(x, scale, bias, groups=32, with_silu=silu)
            err, ok = compare(got, want, dname)
            worst[("group_norm", dname)] = max(worst[("group_norm", dname)], err)
            print(f"check group_norm B={B} N={n} C={c} C/g={c // 32} silu={silu} {dname}: "
                  f"max_abs_err={err:.3e} tol={TOL[dname]} {'ok' if ok else 'FAIL'}")
            assert ok, f"group_norm kernel disagrees at N={n} C={c} silu={silu} {dname}"
    attn_cases = sorted(set(attn_dense) | set(attn_pruned) | set(attn_ft) | {(100, 1, 256)})
    for n, h, d in attn_cases:
        for dname in TOL:
            dtype = getattr(torch, dname)
            q, k, v = (torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            got = flash_attention(q, k, v, d ** -0.5)
            want = reference_attention(q, k, v, d ** -0.5)
            err, ok = compare(got, want, dname)
            worst[("attention", dname)] = max(worst[("attention", dname)], err)
            print(f"check attention B={B} heads={h} N={n} D={d} {dname}: "
                  f"max_abs_err={err:.3e} tol={TOL[dname]} {'ok' if ok else 'FAIL'}")
            assert ok, f"attention kernel disagrees at N={n} D={d} {dname}"
    torch.cuda.synchronize()

    # -- 4. full-width forward, kernels on and off on the same weights
    model = UNet2D(cfg, device=dev)
    model.load_state_dict(dense.state_dict())
    model.eval()
    x = torch.randn((B, 32, 32, 3), generator=gen, device=dev)
    t = torch.randint(0, 1000, (B,), generator=gen, device=dev)
    with torch.inference_mode():
        gn_seen, unhook = record_gn_layouts(model)
        ops.reset_launch_counts()
        y_on = model(x, t)
        fwd_counts = dict(ops.LAUNCHES)
        unhook()
        ops.set_kernels_enabled(False)
        y_off = model(x, t)
        ops.set_kernels_enabled(True)
    diff = float((y_on - y_off).abs().max())
    print(f"forward cifar10 35.75M B={B} f32: kernels on vs off max_abs_diff={diff:.3e} "
          f"(tol {FORWARD_TOL_F32}), launches {fwd_counts}, |y| max {float(y_off.abs().max()):.3f}")
    assert fwd_counts["group_norm"] == sum(gn_dense.values()), fwd_counts
    assert fwd_counts["attention"] == sum(attn_dense.values()), fwd_counts
    assert bool(torch.isfinite(y_on).all()) and diff <= FORWARD_TOL_F32
    print(f"GroupNorm inputs, full-width forward (inference): {dict(gn_seen)}")

    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmpdir.name
    # -- 5./6. serving path through the sampling CLI: dense, then pruned
    results = {}
    for name, m, c, gn_n, attn_n in (("dense", dense, cfg, gn_dense, attn_dense),
                                     ("pruned", pruned, pcfg, gn_pruned, attn_pruned)):
        ckpt = os.path.join(tmp, name)
        save_model(ckpt, c, m)
        base = ["--model_path", ckpt, "--batch_size", str(B), "--device", "cuda"]
        # warm-up
        ddpm_sample.main(base + ["--output_dir", os.path.join(tmp, name + "_warm"),
                                 "--total_samples", str(B), "--ddim_steps", "2"])
        out = os.path.join(tmp, name + "_samples")
        ops.reset_launch_counts()
        stats = ddpm_sample.main(base + ["--output_dir", out, "--total_samples", "256",
                                         "--ddim_steps", "100"])
        counts = dict(ops.LAUNCHES)
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        print(f"serving path {name}: {stats['params'] / 1e6:.4f}M params, "
              f"{stats['macs'] / 1e9:.4f}G MACs, {len(pngs)} PNGs, "
              f"{stats['imgs_per_s']:.2f} imgs/s (DDIM-100, B={B}, f32, CUDA events, "
              f"after warm-up) {tag}; launches {counts}")
        assert len(pngs) == 256 and stats["images"] == 256 and stats["nonfinite"] == 0
        forwards = 100 * 2
        assert counts["group_norm"] == forwards * sum(gn_n.values()) > 0, counts
        assert counts["attention"] == forwards * sum(attn_n.values()) > 0, counts
        assert counts["group_norm_bwd"] == counts["attention_lse"] == 0, counts
        results[name] = {"stats": stats, "launches": counts}

    # -- 7. timings: forward per op at the dense shapes (f32 and bf16), then sampling
    per_forward = {}
    for op, cases in (("group_norm", gn_dense), ("attention", attn_dense)):
        for dname in TOL:
            dtype = getattr(torch, dname)
            tot = collections.defaultdict(float)
            for shape, calls in sorted(cases.items()):
                lib = None
                if op == "group_norm":
                    n, c, silu = shape
                    x = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
                    s, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
                    kw = dict(groups=32, with_silu=silu)
                    fns = [lambda: group_norm_reference(x, s, b, **kw),
                           lambda: group_norm(x, s, b, **kw)]
                    if not silu:  # F.group_norm on its own (B, C, N) layout
                        xl, sl, bl = x.transpose(1, 2).contiguous(), s.to(dtype), b.to(dtype)
                        fns.append(lambda: F.group_norm(xl, 32, sl, bl, eps=1e-6))
                    nbytes, flops = gn_fwd_work(n, c, silu, dname)
                else:
                    n, h, d = shape
                    q, k, v = (torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
                               for _ in range(3))
                    fns = [lambda: reference_attention(q, k, v, d ** -0.5),
                           lambda: flash_attention(q, k, v, d ** -0.5),
                           lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)]
                    nbytes, flops = attn_fwd_work(n, h, d, dname)
                ms = in_turns(fns, iters=20)
                pm, km = ms[0], ms[1]
                bms, by = bound(nbytes, flops, dname)
                tot["kernel"] += km * calls
                tot["plain"] += pm * calls
                tot["flops"] += flops * calls
                add_bound(tot, "", bms * calls, by)
                if len(ms) == 3:
                    lib = ms[2]
                    tot["library"] += lib * calls
                    tot["kernel_where_library"] += km * calls
                rate = (f", {flops / km / 1e9:.1f} TFLOP/s (library "
                        f"{flops / lib / 1e9:.1f})" if op == "attention" else "")
                print(f"time {op} fwd {shape} x{calls}/forward B={B} {dname}: kernel {km:.4f} ms, "
                      f"plain {pm:.4f} ms, library "
                      f"{'-' if lib is None else f'{lib:.4f} ms'}, bound {bms:.4f} ms ({by})"
                      f"{rate} {tag}")
            tot["tflops"] = tot["flops"] / tot["kernel"] / 1e9
            per_forward[(op, dname)] = dict(tot)
            print(f"time {op} fwd per UNet forward B={B} {dname}: kernel {tot['kernel']:.4f} ms, "
                  f"plain {tot['plain']:.4f} ms, bound {tot['bound']:.4f} ms; library "
                  f"{tot['library']:.4f} ms against kernel {tot['kernel_where_library']:.4f} ms "
                  f"on the calls it covers; {tot['tflops']:.2f} TFLOP/s {tag}")

    # GroupNorm host time per call: the wrapper's enqueue, no sync inside
    host_us = {}
    for dname in TOL:
        dtype = getattr(torch, dname)
        total = 0.0
        for (n, c, silu), calls in sorted(gn_dense.items()):
            x = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            s, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            total += host_us_per_call(
                lambda: group_norm(x, s, b, groups=32, with_silu=silu)) * calls
        host_us[dname] = total / sum(gn_dense.values())
        print(f"time group_norm fwd host per call B={B} {dname}: {host_us[dname]:.2f} us "
              f"(perf_counter over 200 calls without a sync, averaged over one forward's "
              f"calls) {tag}")

    sched = DiffusionSchedule.create(device=dev)
    pmodel = UNet2D(pcfg, device=dev)
    pmodel.load_state_dict(pruned.state_dict())
    pmodel.eval()
    sampling = collections.defaultdict(dict)
    for (name, net), dname in itertools.product((("dense", model), ("pruned", pmodel)), TOL):
        sample = make_sampler(net, sched, SamplerConfig(num_inference_steps=100, dtype=dname))
        warm = make_sampler(net, sched, SamplerConfig(num_inference_steps=2, dtype=dname))

        def run(on, sample=sample):
            ops.set_kernels_enabled(on)
            try:
                return cuda_ms(lambda: sample(gen, B, 32, 3), iters=1, warmup=0)
            finally:
                ops.set_kernels_enabled(True)

        for on in (False, True):
            ops.set_kernels_enabled(on)
            warm(gen, B, 32, 3)
        ops.set_kernels_enabled(True)
        off1, on1, on2, off2 = run(False), run(True), run(True), run(False)
        if name == "dense":  # profile of 5 DDIM steps
            prof = make_sampler(net, sched, SamplerConfig(num_inference_steps=5, dtype=dname))
            for on in (True, False):
                ops.set_kernels_enabled(on)
                print_profile(f"sampling dense DDIM step kernels {'on' if on else 'off'} "
                              f"B={B} {dname}", *profile_classes(lambda: prof(gen, B, 32, 3)),
                              ("step", 5), tag)
            ops.set_kernels_enabled(True)
        on, off = B * 2000 / (on1 + on2), B * 2000 / (off1 + off2)
        sampling[name][dname] = {"kernels_on": on, "kernels_off": off}
        print(f"time sampling {name} DDIM-100 B={B} {dname}: kernels on "
              f"{on:.2f} imgs/s ({on1:.1f}, {on2:.1f} ms), kernels off "
              f"{off:.2f} imgs/s ({off1:.1f}, {off2:.1f} ms) {tag}")
    torch.cuda.synchronize()
    del model, pmodel

    # -- 8. backward kernels against plain versions at the UNet's shapes, B = 128
    for n, c, silu in gn_cases:
        for dname in BWD_TOL:
            dtype, tol = getattr(torch, dname), BWD_TOL[dname]
            x = (torch.randn((B, n, c), generator=gen, device=dev) * 2 + 0.5).to(dtype)
            dy = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            scale = torch.rand((c,), generator=gen, device=dev) + 0.5
            bias = torch.randn((c,), generator=gen, device=dev) * 0.1
            _, mean, rstd = G.group_norm_forward_with_stats(x, scale, bias, groups=32,
                                                            with_silu=silu)
            pmean, prstd = G.group_norm_stats_reference(x, 32)
            got = G.group_norm_backward(x, scale, bias, dy, pmean, prstd, groups=32,
                                        with_silu=silu)
            want = G.group_norm_backward_reference(x, scale, bias, dy, pmean, prstd,
                                                   groups=32, with_silu=silu)
            errs = {}
            for what, a, w, wt in (("mean", mean, pmean, "float32"),
                                   ("rstd", rstd, prstd, "float32"),
                                   ("dx", got[0], want[0], dname),
                                   ("dscale", got[1], want[1], dname),
                                   ("dbias", got[2], want[2], dname)):
                err, ok = compare_rel(a, w, BWD_TOL[wt])
                assert ok, f"group_norm backward {what} disagrees at N={n} C={c} silu={silu} " \
                           f"{dname}: {err:.3e}"
                errs[what] = err
            key = ("group_norm_bwd", dname)
            worst[key] = max(worst[key], errs["dx"], errs["dscale"], errs["dbias"])
            worst[("group_norm_stats", dname)] = max(worst[("group_norm_stats", dname)],
                                                     errs["mean"], errs["rstd"])
            print(f"check group_norm bwd B={B} N={n} C={c} silu={silu} {dname}: "
                  + " ".join(f"{k}={e:.3e}" for k, e in errs.items())
                  + f" tol={tol} x max|want| ok")
    for n, h, d in attn_cases:
        for dname in BWD_TOL:
            dtype, tol = getattr(torch, dname), BWD_TOL[dname]
            q, k, v, do = (torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            scale = d ** -0.5
            _, lse = A.flash_attention_forward_lse(q, k, v, scale)
            o, plse = A.reference_attention_lse(q, k, v, scale)
            dq, dsum = A.flash_attention_backward_dq(q, k, v, o, do, plse, scale)
            pdq, pdsum = A.attention_backward_dq_reference(q, k, v, o, do, plse, scale)
            dk, dv = A.flash_attention_backward_dkv(q, k, v, do, plse, pdsum, scale)
            pdk, pdv = A.attention_backward_dkv_reference(q, k, v, do, plse, pdsum, scale)
            errs = {}
            for what, a, w, wt in (("lse", lse, plse, "float32"),
                                   ("dsum", dsum, pdsum, "float32"),
                                   ("dq", dq, pdq, dname), ("dk", dk, pdk, dname),
                                   ("dv", dv, pdv, dname)):
                err, ok = compare_rel(a, w, BWD_TOL[wt])
                assert ok, f"attention backward {what} disagrees at N={n} D={d} {dname}: " \
                           f"{err:.3e}"
                errs[what] = err
            worst[("attention_lse", dname)] = max(worst[("attention_lse", dname)], errs["lse"])
            worst[("attention_bwd_dq", dname)] = max(worst[("attention_bwd_dq", dname)],
                                                     errs["dq"], errs["dsum"])
            worst[("attention_bwd_dkv", dname)] = max(worst[("attention_bwd_dkv", dname)],
                                                      errs["dk"], errs["dv"])
            print(f"check attention bwd B={B} heads={h} N={n} D={d} {dname}: "
                  + " ".join(f"{k}={e:.3e}" for k, e in errs.items())
                  + f" tol={tol} x max|want| ok")
    torch.cuda.synchronize()

    # -- 9. the sweep at full width, kernels on against off, then on again
    torch.backends.cudnn.deterministic = True
    smodel = UNet2D(cfg, device=dev)
    smodel.load_state_dict(dense.state_dict())
    sgen = torch.Generator(device=dev).manual_seed(3)
    x0 = torch.rand((B, 32, 32, 3), generator=sgen, device=dev) * 2 - 1
    noise = torch.randn((B, 32, 32, 3), generator=sgen, device=dev)
    per_step = {"group_norm": sum(gn_dense.values()), "group_norm_bwd": sum(gn_dense.values()),
                "attention": sum(attn_dense.values()), "attention_lse": sum(attn_dense.values()),
                "attention_bwd_dq": sum(attn_dense.values()),
                "attention_bwd_dkv": sum(attn_dense.values())}

    def sweep(on):
        ops.set_kernels_enabled(on)
        try:
            ops.reset_launch_counts()
            res = accumulate_taylor_grads(smodel, sched, x0, noise, thr=None,
                                          max_steps=SWEEP_STEPS)
            torch.cuda.synchronize()
            return res, dict(ops.LAUNCHES), {n: g.clone() for n, g in res.grads.items()}
        finally:
            ops.set_kernels_enabled(True)

    gn_seen, unhook = record_gn_layouts(smodel)
    bwd_seen, unwrap = record_gn_bwd_layouts()
    res_on, counts_on, grads_on = sweep(True)
    unhook()
    unwrap()
    print(f"GroupNorm inputs, sweep under autograd ({SWEEP_STEPS} steps): {dict(gn_seen)}; "
          f"at the backward kernel: {dict(bwd_seen)}")
    res_off, counts_off, grads_off = sweep(False)
    res_again, _, grads_again = sweep(True)
    print(f"sweep cifar10 35.75M B={B} f32 {SWEEP_STEPS} steps: losses on {res_on.losses}, "
          f"off {res_off.losses}; launches on {counts_on}, off {counts_off}")
    assert counts_on == {k: SWEEP_STEPS * v for k, v in per_step.items()}, counts_on
    assert not any(counts_off.values()), counts_off
    assert res_on.steps_run == res_off.steps_run == SWEEP_STEPS
    np.testing.assert_allclose(res_on.losses, res_off.losses, rtol=SWEEP_LOSS_RTOL)
    floor = 1e-6 * max(float(g.abs().max()) for g in grads_off.values())
    worst_grad, worst_name = 0.0, ""
    for name, g in grads_off.items():
        err = float((grads_on[name] - g).abs().max())
        gmax = float(g.abs().max())
        assert bool(torch.isfinite(grads_on[name]).all()) and \
            err <= SWEEP_GRAD_TOL * gmax + floor, f"sweep grad {name}: {err:.3e} (max {gmax:.3e})"
        if err / max(gmax, floor) > worst_grad:
            worst_grad, worst_name = err / max(gmax, floor), f"{name} (max |grad| {gmax:.3e})"

    identical = all(torch.equal(grads_again[n], g) for n, g in grads_on.items())
    assert identical and np.array_equal(res_again.losses, res_on.losses), \
        "kernel-on sweep is not bit-reproducible"
    params = unflatten_params(flat_from_state_dict(smodel.state_dict()))
    imp = make_importance("diff-pruning")
    graph = smodel.graph
    g_on = unflatten_params(flat_from_state_dict(grads_on))
    g_off = unflatten_params(flat_from_state_dict(grads_off))
    worst_score = 0.0
    for var in graph.prunable_vars():
        s_on = imp(graph, params, var, grads=g_on)
        s_off = imp(graph, params, var, grads=g_off)
        err = float(np.abs(s_on - s_off).max()) / max(float(np.abs(s_off).max()), 1e-30)
        assert err <= SWEEP_SCORE_RTOL, f"diff-pruning scores of {var.name}: {err:.3e}"
        worst_score = max(worst_score, err)
    print(f"sweep on vs off: loss max rel diff "
          f"{float(np.max(np.abs(res_on.losses / res_off.losses - 1))):.3e} "
          f"(tol {SWEEP_LOSS_RTOL}); worst grad err / param max {worst_grad:.3e} at "
          f"{worst_name} (tol {SWEEP_GRAD_TOL}); worst diff-pruning score err / var max {worst_score:.3e} "
          f"(tol {SWEEP_SCORE_RTOL}); repeat kernel-on grads bit-identical: {identical}")
    del grads_on, grads_off, grads_again, g_on, g_off, res_on, res_off, res_again
    smodel.zero_grad(set_to_none=True)

    # -- 10. pruning path (main path): the prune CLI on the seeded dense checkpoint
    torch.backends.cudnn.deterministic = False
    data = os.path.join(tmp, "data.npz")
    np.savez(data, images=np.random.default_rng(4).integers(0, 256, (128, 32, 32, 3),
                                                             dtype=np.uint8))
    out = os.path.join(tmp, "pruned_cli")
    argv = ["--model_path", os.path.join(tmp, "dense"), "--save_path", out,
            "--pruner", "diff-pruning", "--pruning_ratio", "0.3", "--thr", "0.05",
            "--max_steps", "20", "--batch_size", str(B), "--dataset", data, "--device", "cuda"]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cli = ddpm_prune.main(argv)
    torch.cuda.synchronize()
    cli_seconds = time.perf_counter() - t0
    cli_counts = dict(ops.LAUNCHES)
    steps = cli["steps_run"]
    print(f"main path prune CLI: {cli['params_before'] / 1e6:.4f}M -> {cli['params'] / 1e6:.4f}M "
          f"params, {cli['macs_before'] / 1e9:.4f}G -> {cli['macs'] / 1e9:.4f}G MACs, sweep "
          f"{steps} steps in {cli['sweep_seconds']:.2f}s, whole CLI {cli_seconds:.2f}s "
          f"(host clock, B={B}, f32) {tag}; launches {cli_counts}")
    # the sweep's steps, then DDIM-100 for vis/after_pruning.png on the pruned
    # model, which has the dense one's GroupNorm and attention calls
    vis_forwards = 100
    want_counts = {
        "group_norm": (steps + vis_forwards) * per_step["group_norm"],
        "group_norm_bwd": steps * per_step["group_norm_bwd"],
        "attention": (steps + vis_forwards) * per_step["attention"],
        "attention_lse": steps * per_step["attention_lse"],
        "attention_bwd_dq": steps * per_step["attention_bwd_dq"],
        "attention_bwd_dkv": steps * per_step["attention_bwd_dkv"]}
    assert 1 <= steps <= 20 and cli_counts == want_counts, (cli_counts, want_counts)
    assert all(v > 0 for v in cli_counts.values()), cli_counts
    pcfg_cli, state = load_model(out)
    reloaded = UNet2D(pcfg_cli, device=dev)
    reloaded.load_state_dict(state)
    n_reloaded = sum(p.numel() for p in reloaded.parameters())
    assert n_reloaded == cli["params"] == PRUNED_PARAMS_AT_0_3, n_reloaded
    del reloaded
    samples = ddpm_sample.main(["--model_path", out, "--output_dir", os.path.join(tmp, "cli_s"),
                                "--total_samples", str(B), "--batch_size", str(B),
                                "--device", "cuda"])
    print(f"main path check: checkpoint reloads at {n_reloaded} params (pinned "
          f"{PRUNED_PARAMS_AT_0_3}); sampling CLI drew {samples['images']} images, "
          f"{samples['nonfinite']} non-finite values, {samples['imgs_per_s']:.2f} imgs/s")
    assert samples["images"] == B and samples["nonfinite"] == 0

    # -- 11. finetune path, f32: the train CLI on the prune CLI's checkpoint, then a resume
    assert pcfg_cli.channel_sizes == ftcfg.channel_sizes
    torch.backends.cudnn.deterministic = True
    ft_base = ["--dataset", data, "--model_path", out, "--train_batch_size", str(B),
               "--save_model_steps", str(FT_SAVE), "--log_steps", str(FT_SAVE),
               "--vis_samples", str(FT_VIS), "--device", "cuda"]
    ft_out, ft2_out = os.path.join(tmp, "finetuned"), os.path.join(tmp, "finetuned_resumed")

    def ft_counts_want(steps):
        # per step one forward and one backward; DDIM-100 for each vis grid
        g, a, vis = sum(gn_ft.values()), sum(attn_ft.values()), steps // FT_SAVE * 100
        return {"group_norm": (steps + vis) * g, "group_norm_bwd": steps * g,
                "attention": (steps + vis) * a, "attention_lse": steps * a,
                "attention_bwd_dq": steps * a, "attention_bwd_dkv": steps * a}

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ft = ddpm_train.main(ft_base + ["--output_dir", ft_out, "--num_iters", str(FT_STEPS)])
    torch.cuda.synchronize()
    ft_seconds = time.perf_counter() - t0
    ft_counts = dict(ops.LAUNCHES)
    with open(os.path.join(ft_out, "metrics.jsonl")) as f:
        ft_log = [json.loads(line) for line in f]
    print(f"main path finetune CLI f32: {FT_STEPS} steps of the {PRUNED_PARAMS_AT_0_3}-param "
          f"UNet, B={B}, losses {ft['losses']}; whole CLI {ft_seconds:.2f}s (host clock, "
          f"two saves and vis grids included); metrics.jsonl {ft_log} {tag}; "
          f"launches {ft_counts}")
    assert ft["steps"] == FT_STEPS and all(math.isfinite(v) for v in ft["losses"]), ft
    assert ft_counts == ft_counts_want(FT_STEPS), (ft_counts, ft_counts_want(FT_STEPS))
    assert [r["step"] for r in ft_log] == [FT_SAVE, 2 * FT_SAVE]
    ft2 = ddpm_train.main(ft_base + ["--output_dir", ft2_out, "--num_iters", str(FT_STEPS),
                                     "--resume_from_checkpoint",
                                     os.path.join(ft_out, "ckpt", f"step-{FT_SAVE}")])
    resume_same = {f: npz_equal(os.path.join(ft_out, "ckpt", f"step-{FT_STEPS}", f),
                                os.path.join(ft2_out, "ckpt", f"step-{FT_STEPS}", f))
                   for f in ("params.npz", "ema_params.npz", "opt_state.npz")}
    print(f"finetune resume from step {ft2['start_step']}: losses {ft2['losses']}; step-"
          f"{FT_STEPS} files bit-identical to the uninterrupted run's: {resume_same}")
    assert ft2["start_step"] == FT_SAVE and ft2["losses"] == ft["losses"][FT_SAVE:], ft2
    assert all(resume_same.values()), resume_same
    ecfg, estate = load_model(ft_out, subfolder="unet_ema")
    ema_net = UNet2D(ecfg, device=dev)
    ema_net.load_state_dict(estate)
    n_ema = sum(p.numel() for p in ema_net.parameters())
    del ema_net
    ema_samples = ddpm_sample.main(["--model_path", ft_out, "--use_ema", "--output_dir",
                                    os.path.join(tmp, "ema_s"), "--total_samples", str(B),
                                    "--batch_size", str(B), "--device", "cuda"])
    print(f"finetune check: unet_ema reloads at {n_ema} params; sampling CLI drew "
          f"{ema_samples['images']} images from it, {ema_samples['nonfinite']} non-finite")
    assert n_ema == PRUNED_PARAMS_AT_0_3
    assert ema_samples["images"] == B and ema_samples["nonfinite"] == 0

    # -- 12. finetune path, bf16
    ft16_out = os.path.join(tmp, "finetuned_bf16")
    bwd_dtypes, unwrap = record_bwd_dtypes()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        ft16 = ddpm_train.main(ft_base + ["--output_dir", ft16_out, "--num_iters",
                                          str(FT_BF16_STEPS), "--mixed_precision", "bf16"])
        torch.cuda.synchronize()
    finally:
        unwrap()
    ft16_seconds = time.perf_counter() - t0
    ft16_counts = dict(ops.LAUNCHES)
    print(f"finetune CLI bf16: {FT_BF16_STEPS} steps, losses {ft16['losses']}; whole CLI "
          f"{ft16_seconds:.2f}s {tag}; launches {ft16_counts}; backward calls by dtype "
          f"{dict(bwd_dtypes)}; first-step loss bf16 {ft16['losses'][0]:.4f} against f32 "
          f"{ft['losses'][0]:.4f}")
    assert ft16["steps"] == FT_BF16_STEPS and all(math.isfinite(v) for v in ft16["losses"])
    assert ft16_counts == ft_counts_want(FT_BF16_STEPS), ft16_counts
    assert dict(bwd_dtypes) == {
        ("group_norm_bwd", "torch.bfloat16"): FT_BF16_STEPS * sum(gn_ft.values()),
        ("attention_bwd", "torch.bfloat16"): FT_BF16_STEPS * sum(attn_ft.values())}, bwd_dtypes
    torch.backends.cudnn.deterministic = False

    # -- 13. timings: backward per op at the dense shapes, then the sweep step
    per_step_bwd, bwd_host_us = {}, {}
    for dname in TOL:
        dtype = getattr(torch, dname)
        tot = collections.defaultdict(float)
        for (n, c, silu), calls in sorted(gn_dense.items()):
            x = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            dy = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            s, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            mean, rstd = G.group_norm_stats_reference(x, 32)
            kw = dict(groups=32, with_silu=silu)
            fns = [lambda: G.group_norm_backward_reference(x, s, b, dy, mean, rstd, **kw),
                   lambda: G.group_norm_backward(x, s, b, dy, mean, rstd, **kw)]
            if not silu:  # autograd of F.group_norm: native_group_norm_backward alone
                xl = x.transpose(1, 2).contiguous().requires_grad_()
                sl, bl = (z.to(dtype, copy=True).requires_grad_() for z in (s, b))
                yl = F.group_norm(xl, 32, sl, bl, eps=1e-6)
                dyl = dy.transpose(1, 2).contiguous()
                fns.append(lambda: torch.autograd.grad(yl, (xl, sl, bl), dyl, retain_graph=True))
            ms = in_turns(fns, iters=20)
            bms, by = bound(*gn_bwd_work(n, c, silu, dname), dname)
            tot["gn_kernel"] += ms[1] * calls
            tot["gn_plain"] += ms[0] * calls
            add_bound(tot, "gn_", bms * calls, by)
            if len(ms) == 3:
                tot["gn_library"] += ms[2] * calls
                tot["gn_kernel_where_library"] += ms[1] * calls
            print(f"time group_norm bwd {(n, c, silu)} x{calls}/step B={B} {dname}: kernel "
                  f"{ms[1]:.4f} ms, plain {ms[0]:.4f} ms, library "
                  f"{f'{ms[2]:.4f} ms' if len(ms) == 3 else '-'}, bound {bms:.4f} ms ({by}) {tag}")
        # the dense UNet's shapes, and in bf16 the prune CLI's UNet's (D = 179;
        # keys "ft_..."), which the bf16 finetune path trains
        for pre, cases in [("", attn_dense)] + ([("ft_", attn_ft)] if dname == "bfloat16" else []):
            for (n, h, d), calls in sorted(cases.items()):
                q, k, v, do = (torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
                               for _ in range(4))
                scale = d ** -0.5
                o, lse = A.reference_attention_lse(q, k, v, scale)
                _, dsum = A.attention_backward_dq_reference(q, k, v, o, do, lse, scale)
                ql, kl, vl = (z.detach().clone().requires_grad_() for z in (q, k, v))
                ol = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
                fns = [
                    lambda: A.attention_backward_dq_reference(q, k, v, o, do, lse, scale),
                    with_bwd_lib(ours, lambda: A.flash_attention_backward_dq(
                        q, k, v, o, do, lse, scale)),
                    lambda: A.attention_backward_dkv_reference(q, k, v, do, lse, dsum, scale),
                    with_bwd_lib(ours, lambda: A.flash_attention_backward_dkv(
                        q, k, v, do, lse, dsum, scale)),
                    lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)]
                for lib in others.values():  # the other versions, timed in the same turns
                    fns += [with_bwd_lib(lib, lambda: A.flash_attention_backward_dq(
                                q, k, v, o, do, lse, scale)),
                            with_bwd_lib(lib, lambda: A.flash_attention_backward_dkv(
                                q, k, v, do, lse, dsum, scale))]
                ms = in_turns(fns, iters=20)
                fq, fkv = attn_dq_work(n, h, d, dname)[1], attn_dkv_work(n, h, d, dname)[1]
                bq, byq = bound(*attn_dq_work(n, h, d, dname), dname)
                bkv, bykv = bound(*attn_dkv_work(n, h, d, dname), dname)
                other_ms = {label: ms[5 + 2 * i: 7 + 2 * i] for i, label in enumerate(others)}
                for key, val in (("dq_plain", ms[0]), ("dq_kernel", ms[1]),
                                 ("dkv_plain", ms[2]), ("dkv_kernel", ms[3]),
                                 ("attn_library", ms[4]), ("dq_flops", fq), ("dkv_flops", fkv),
                                 *((f"{part}_{label}", t) for label, pair in other_ms.items()
                                   for part, t in zip(("dq", "dkv"), pair))):
                    tot[pre + key] += val * calls
                add_bound(tot, pre + "dq_", bq * calls, byq)
                add_bound(tot, pre + "dkv_", bkv * calls, bykv)
                versus = "".join(f"; {label} dq {a:.4f} ms, dk/dv {b:.4f} ms"
                                 for label, (a, b) in other_ms.items())
                print(f"time attention bwd {'prune CLI UNet ' if pre else ''}{(n, h, d)} "
                      f"x{calls}/step B={B} {dname}: dq kernel {ms[1]:.4f} ms, "
                      f"{fq / ms[1] / 1e9:.1f} TFLOP/s (plain {ms[0]:.4f}, bound {bq:.4f} "
                      f"{byq}), dk/dv kernel {ms[3]:.4f} ms, {fkv / ms[3] / 1e9:.1f} TFLOP/s "
                      f"(plain {ms[2]:.4f}, bound {bkv:.4f} {bykv}), library (SDPA backward, "
                      f"dq+dk+dv) {ms[4]:.4f} ms{versus} {tag}")
        for pre in ("", "ft_") if dname == "bfloat16" else ("",):
            tot[pre + "dq_tflops"] = tot[pre + "dq_flops"] / tot[pre + "dq_kernel"] / 1e9
            tot[pre + "dkv_tflops"] = tot[pre + "dkv_flops"] / tot[pre + "dkv_kernel"] / 1e9
        total = 0.0
        for (n, c, silu), calls in sorted(gn_dense.items()):
            x = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            dy = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            s, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            mean, rstd = G.group_norm_stats_reference(x, 32)
            total += host_us_per_call(lambda: G.group_norm_backward(
                x, s, b, dy, mean, rstd, groups=32, with_silu=silu)) * calls
        bwd_host_us[dname] = total / sum(gn_dense.values())
        print(f"time group_norm bwd host per call B={B} {dname}: "
              f"{bwd_host_us[dname]:.2f} us (perf_counter over 200 calls without a "
              f"sync, averaged over one step's calls) {tag}")
        per_step_bwd[dname] = dict(tot)
        print(f"time backward per sweep step B={B} {dname}: " + ", ".join(
            f"{k} {val:.4f} ms" for k, val in sorted(tot.items())) + f" {tag}")

    torch.backends.cudnn.deterministic = True
    loss_fn = make_loss_fn(smodel, sched)
    tsteps = [torch.full((B,), k, dtype=torch.int64, device=dev) for k in range(SWEEP_STEPS)]

    def sweep_steps(on):
        ops.set_kernels_enabled(on)
        try:
            for ts in tsteps:
                loss_fn(x0, noise, ts).backward()
        finally:
            ops.set_kernels_enabled(True)

    off_ms, on_ms = in_turns([lambda: sweep_steps(False), lambda: sweep_steps(True)], iters=2)
    step_on, step_off = on_ms / SWEEP_STEPS, off_ms / SWEEP_STEPS
    print(f"time sweep step (forward + backward) cifar10 35.75M B={B} f32: kernels on "
          f"{step_on:.2f} ms, kernels off {step_off:.2f} ms (CUDA events, in turns "
          f"off-on-on-off, cuDNN deterministic) {tag}")
    for on in (False, True):
        print_profile(f"sweep step kernels {'on' if on else 'off'} B={B} f32",
                      *profile_classes(lambda: sweep_steps(on)), ("step", SWEEP_STEPS), tag)
    torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()

    # -- 14. the train step: kernels on against off, then timings and profiles
    torch.backends.cudnn.deterministic = True
    tgen = torch.Generator(device=dev).manual_seed(6)
    tx = [torch.rand((B, 32, 32, 3), generator=tgen, device=dev) * 2 - 1
          for _ in range(TRAIN_STEPS)]
    tnoise = [torch.randn((B, 32, 32, 3), generator=tgen, device=dev) for _ in range(TRAIN_STEPS)]
    tts = [antithetic_timesteps(tgen, B, 1000) for _ in range(TRAIN_STEPS)]

    def train_steps(on, prec="no"):
        ops.set_kernels_enabled(on)
        try:
            net = UNet2D(cfg, device=dev)
            net.load_state_dict(dense.state_dict())
            st = init_train_state(net, TrainConfig(mixed_precision=prec))
            step = make_train_step(net, sched, TrainConfig(mixed_precision=prec))
            ops.reset_launch_counts()
            losses, mu1 = [], None
            for i in range(TRAIN_STEPS):
                st, met = step(st, tx[i], noise=tnoise[i], t=tts[i])
                losses.append(float(met["loss"]))
                if i == 0:  # Adam's first moment: 0.1 x the first step's clipped grads
                    mu1 = {n: m.clone() for n, m in st.opt_state.mu.items()}
            return np.asarray(losses), mu1, dict(ops.LAUNCHES)
        finally:
            ops.set_kernels_enabled(True)

    tl_on, mu_on, tcounts_on = train_steps(True)
    tl_off, mu_off, tcounts_off = train_steps(False)
    assert tcounts_on == {k: TRAIN_STEPS * v for k, v in per_step.items()}, tcounts_on
    assert not any(tcounts_off.values()), tcounts_off
    np.testing.assert_allclose(tl_on, tl_off, rtol=TRAIN_LOSS_RTOL)
    floor = 1e-6 * max(float(m.abs().max()) for m in mu_off.values())
    worst_mu, worst_mu_name = 0.0, ""
    for name, m in mu_off.items():
        err, mmax = float((mu_on[name] - m).abs().max()), float(m.abs().max())
        assert bool(torch.isfinite(mu_on[name]).all()) and \
            err <= SWEEP_GRAD_TOL * mmax + floor, f"train step grad {name}: {err:.3e}"
        if err / max(mmax, floor) > worst_mu:
            worst_mu, worst_mu_name = err / max(mmax, floor), name
    print(f"train step cifar10 35.75M B={B} f32 {TRAIN_STEPS} steps, kernels on vs off: "
          f"losses on {tl_on}, off {tl_off}, max rel diff "
          f"{float(np.max(np.abs(tl_on / tl_off - 1))):.3e} (tol {TRAIN_LOSS_RTOL}); first "
          f"step's grads (Adam's mu) worst err / param max {worst_mu:.3e} at {worst_mu_name} "
          f"(tol {SWEEP_GRAD_TOL}); launches on {tcounts_on}")
    # bf16: every GroupNorm and attention backward in bf16, the 16-bit dq and
    # dk/dv kernels inside the model
    bwd_dtypes, unwrap = record_bwd_dtypes()
    try:
        tl16_on, mu16_on, tc16_on = train_steps(True, "bf16")
    finally:
        unwrap()
    tl16_off, mu16_off, tc16_off = train_steps(False, "bf16")
    assert tc16_on == {k: TRAIN_STEPS * v for k, v in per_step.items()}, tc16_on
    assert not any(tc16_off.values()), tc16_off
    assert dict(bwd_dtypes) == {
        ("group_norm_bwd", "torch.bfloat16"): TRAIN_STEPS * per_step["group_norm_bwd"],
        ("attention_bwd", "torch.bfloat16"): TRAIN_STEPS * per_step["attention_bwd_dq"]}, \
        bwd_dtypes
    loss16 = float(np.max(np.abs(tl16_on / tl16_off - 1)))
    diff16 = math.sqrt(sum(float(((mu16_on[n] - m) ** 2).sum()) for n, m in mu16_off.items()))
    norm16 = math.sqrt(sum(float((m ** 2).sum()) for m in mu16_off.values()))
    print(f"train step cifar10 35.75M B={B} bf16 {TRAIN_STEPS} steps, kernels on vs off: "
          f"losses on {tl16_on}, off {tl16_off}, max rel diff {loss16:.3e} (tol "
          f"{TRAIN_BF16_LOSS_RTOL}); first step's grads (Adam's mu) |on - off| / |off| "
          f"{diff16 / norm16:.3e} (tol {TRAIN_BF16_GRAD_RTOL}); backward calls by dtype "
          f"{dict(bwd_dtypes)}")
    assert np.isfinite(tl16_on).all() and loss16 <= TRAIN_BF16_LOSS_RTOL, (tl16_on, tl16_off)
    assert all(bool(torch.isfinite(m).all()) for m in mu16_on.values())
    assert diff16 <= TRAIN_BF16_GRAD_RTOL * norm16, (diff16, norm16)
    del mu_on, mu_off, mu16_on, mu16_off
    torch.backends.cudnn.deterministic = False

    # timings as the train CLI runs the step: draws from (seed, step), dropout 0.1
    train_ms, peak_gb, train_prof = {}, {}, {}
    sd_ft = {n: p.to(dev) for n, p in ftnet.state_dict().items()}
    for (name, c, sd), prec in itertools.product(
            (("dense", cfg, dense.state_dict()), ("pruned", ftcfg, sd_ft)), ("no", "bf16")):
        tcfg = TrainConfig(mixed_precision=prec)
        net = UNet2D(dataclasses.replace(c, dropout=0.1), device=dev)
        net.load_state_dict(sd)
        st = init_train_state(net, tcfg)
        step = make_train_step(net, sched, tcfg, seed=7)

        def run(on, st=st, step=step):
            ops.set_kernels_enabled(on)
            try:
                step(st, tx[0])
            finally:
                ops.set_kernels_enabled(True)

        off, on = in_turns([lambda: run(False), lambda: run(True)], iters=3)
        dname = "bfloat16" if prec == "bf16" else "float32"
        train_ms[(name, dname)] = {"kernels_on_ms": on, "kernels_off_ms": off,
                                   "kernels_on_imgs_per_s": B * 1e3 / on,
                                   "kernels_off_imgs_per_s": B * 1e3 / off}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        run(True)
        torch.cuda.synchronize()
        peak_gb[(name, dname)] = torch.cuda.max_memory_allocated(dev) / 1e9
        train_ms[(name, dname)]["host_ms"] = host_us_per_call(lambda: run(True), calls=3) / 1e3
        print(f"time train step {name} B={B} {dname}: kernels on {on:.2f} ms "
              f"({B * 1e3 / on:.1f} imgs/s), kernels off {off:.2f} ms ({B * 1e3 / off:.1f} "
              f"imgs/s) (CUDA events, in turns off-on-on-off, 3 steps each, dropout 0.1); host "
              f"{train_ms[(name, dname)]['host_ms']:.2f} ms a step kernels on (perf_counter over "
              f"3 steps without a sync); peak memory {peak_gb[(name, dname)]:.2f} GB {tag}")
        busy, span, launches, counts, by_name = profile_kernels(lambda: run(True))
        print_profile(f"train step {name} kernels on B={B} {dname}", busy, span, launches,
                      counts, ("step", 1), tag)
        prof = train_prof[f"{name}/{dname}"] = {
            "busy_ms": sum(busy.values()), "span_ms": span, "launches": launches,
            "idle_share": 1 - sum(busy.values()) / span,
            "dq_ms": sum(v for k, v in by_name.items() if "flash_bwd_dq" in k),
            "dkv_ms": sum(v for k, v in by_name.items() if "flash_bwd_dkv" in k)}
        print(f"profile train step {name} B={B} {dname}: dq kernel {prof['dq_ms']:.3f} ms, "
              f"dk/dv kernel {prof['dkv_ms']:.3f} ms device time per step {tag}")
        if (name, prec) == ("dense", "no"):
            opt = make_optimizer(tcfg)
            plist = list(st.params.values())
            grads = [torch.randn(p.shape, generator=tgen, device=dev) for p in plist]

            def opt_ema():
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
                opt.update(grads, norm, st.opt_state, plist)
                ema_update(st.ema_params.values(), plist, tcfg.ema_decay)

            opt_ms = cuda_ms(opt_ema, iters=10)
            opt_host_ms = host_us_per_call(opt_ema, calls=10) / 1e3
            print(f"time optimizer + EMA per step (grad norm, clip, Adam, EMA; "
                  f"{sum(p.numel() for p in plist)} params in {len(plist)} tensors, f32): "
                  f"{opt_ms:.3f} ms (CUDA events), host {opt_host_ms:.3f} ms {tag}")
        del net, st, step
    torch.cuda.synchronize()

    # -- 15. evaluation path: the FID Inception and the fid_score and fidelity CLIs
    ops.reset_launch_counts()
    evaluation = evaluation_path(tmp, {name: os.path.join(tmp, name + "_samples")
                                       for name in ("dense", "pruned")}, gpu, tag)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES  # no kernel of the port on this path
    tmpdir.cleanup()

    # -- 16. result lines
    f32_fwd = {op: per_forward[(op, "float32")] for op in ("group_norm", "attention")}
    f32_bwd, bf16_bwd = per_step_bwd["float32"], per_step_bwd["bfloat16"]

    def entry(name, route, source, replaces, launches, err_key, ms, plain_ms, bound_ms,
              bound_by, library_ms, **extra):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": worst[(err_key, "float32")],
                "max_abs_err_bf16": worst[(err_key, "bfloat16")], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, **extra}

    def bf16_bwd_of(part):
        """The 16-bit dq or dk/dv kernel's bf16 figures per sweep step: at the
        dense UNet's shapes and (``_prune_cli_unet``) the prune CLI's UNet's."""
        out = {}
        for pre, suffix in (("", ""), ("ft_", "_prune_cli_unet")):
            out.update({f"ms_bf16{suffix}": bf16_bwd[f"{pre}{part}_kernel"],
                        f"plain_ms_bf16{suffix}": bf16_bwd[f"{pre}{part}_plain"],
                        f"bound_ms_bf16{suffix}": bf16_bwd[f"{pre}{part}_bound"],
                        f"library_ms_dq_dk_dv_bf16{suffix}": bf16_bwd[f"{pre}attn_library"],
                        f"tflops_bf16{suffix}": bf16_bwd[f"{pre}{part}_tflops"]})
            for label in others:
                out[f"{label}_ms_bf16{suffix}"] = bf16_bwd[f"{pre}{part}_{label}"]
        return out

    def paths(key):
        return dict(launches_prune_cli=cli_counts[key], launches_finetune_bf16=ft16_counts[key])

    per_fwd = "f32, summed over one B=128 UNet forward's calls (inference launch)"
    per_bwd = "f32, summed over one B=128 sweep step's calls"
    gn_fwd_src = "diff_pruning_tpu_torch/ops/csrc/group_norm_fwd.cu"
    gn_bwd_src = "diff_pruning_tpu_torch/ops/csrc/group_norm_bwd.cu"
    bf16_fwd = {op: per_forward[(op, "bfloat16")] for op in ("group_norm", "attention")}
    attn_bwd_src = "diff_pruning_tpu_torch/ops/csrc/flash_attention_bwd.cu"
    kernels = [
        entry("group_norm_silu_fwd", "cuda", gn_fwd_src, "diff_pruning_tpu/ops/group_norm.py:110",
              ft_counts["group_norm"], "group_norm", f32_fwd["group_norm"]["kernel"],
              f32_fwd["group_norm"]["plain"], f32_fwd["group_norm"]["bound"],
              bound_by(f32_fwd["group_norm"]),
              f32_fwd["group_norm"]["library"], ms_is=per_fwd,
              library_ms_is="F.group_norm over the no-SiLU calls only",
              ms_where_library=f32_fwd["group_norm"]["kernel_where_library"],
              ms_bf16=bf16_fwd["group_norm"]["kernel"],
              library_ms_bf16=bf16_fwd["group_norm"]["library"],
              host_us_per_call=host_us["float32"], host_us_per_call_bf16=host_us["bfloat16"],
              launches_serving_dense=results["dense"]["launches"]["group_norm"],
              **paths("group_norm")),
        entry("group_norm_silu_bwd", "cuda", gn_bwd_src, "diff_pruning_tpu/ops/group_norm.py:131",
              ft_counts["group_norm_bwd"], "group_norm_bwd", f32_bwd["gn_kernel"],
              f32_bwd["gn_plain"], f32_bwd["gn_bound"], bound_by(f32_bwd, "gn_"),
              f32_bwd["gn_library"],
              ms_is=per_bwd,
              library_ms_is="autograd of F.group_norm over the no-SiLU calls only",
              ms_where_library=f32_bwd["gn_kernel_where_library"],
              ms_bf16=bf16_bwd["gn_kernel"], bound_ms_bf16=bf16_bwd["gn_bound"],
              library_ms_bf16=bf16_bwd["gn_library"],
              ms_where_library_bf16=bf16_bwd["gn_kernel_where_library"],
              host_us_per_call=bwd_host_us["float32"],
              host_us_per_call_bf16=bwd_host_us["bfloat16"], **paths("group_norm_bwd")),
        entry("flash_attention_fwd", "cuda",
              "diff_pruning_tpu_torch/ops/csrc/flash_attention_fwd.cu",
              "diff_pruning_tpu/ops/attention.py:97", ft_counts["attention"], "attention",
              f32_fwd["attention"]["kernel"], f32_fwd["attention"]["plain"],
              f32_fwd["attention"]["bound"], bound_by(f32_fwd["attention"]),
              f32_fwd["attention"]["library"],
              ms_is=per_fwd, library_ms_is="F.scaled_dot_product_attention",
              ms_bf16=bf16_fwd["attention"]["kernel"],
              library_ms_bf16=bf16_fwd["attention"]["library"],
              tflops=f32_fwd["attention"]["tflops"], tflops_bf16=bf16_fwd["attention"]["tflops"],
              max_abs_err_lse=worst[("attention_lse", "float32")],
              launches_with_lse=ft_counts["attention_lse"],
              launches_serving_dense=results["dense"]["launches"]["attention"],
              **paths("attention")),
        entry("flash_attention_bwd_dq", "cuda", attn_bwd_src,
              "diff_pruning_tpu/ops/attention.py:205", ft_counts["attention_bwd_dq"],
              "attention_bwd_dq", f32_bwd["dq_kernel"], f32_bwd["dq_plain"],
              f32_bwd["dq_bound"], bound_by(f32_bwd, "dq_"), None, ms_is=per_bwd,
              library_ms_dq_dk_dv=f32_bwd["attn_library"], tflops=f32_bwd["dq_tflops"],
              ms_bf16_in_train_step=train_prof["dense/bfloat16"]["dq_ms"], **bf16_bwd_of("dq"),
              **paths("attention_bwd_dq")),
        entry("flash_attention_bwd_dkv", "cuda", attn_bwd_src,
              "diff_pruning_tpu/ops/attention.py:205", ft_counts["attention_bwd_dkv"],
              "attention_bwd_dkv", f32_bwd["dkv_kernel"], f32_bwd["dkv_plain"],
              f32_bwd["dkv_bound"], bound_by(f32_bwd, "dkv_"), None, ms_is=per_bwd,
              library_ms_dq_dk_dv=f32_bwd["attn_library"], tflops=f32_bwd["dkv_tflops"],
              ms_bf16_in_train_step=train_prof["dense/bfloat16"]["dkv_ms"], **bf16_bwd_of("dkv"),
              **paths("attention_bwd_dkv")),
    ]
    print(json.dumps({"sweep_step_ms": {"kernels_on": step_on, "kernels_off": step_off},
                      "prune_cli_seconds": cli_seconds, "sampling_imgs_per_s": sampling,
                      "finetune_cli_seconds": {"float32": ft_seconds, "bfloat16": ft16_seconds},
                      "finetune_imgs_per_sec": {f"{n}/{d}": v for (n, d), v in train_ms.items()},
                      "train_step_peak_gb": {f"{n}/{d}": v for (n, d), v in peak_gb.items()},
                      "optimizer_ema_ms": opt_ms, "train_step_profile": train_prof}))
    print(json.dumps({"evaluation": evaluation}))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
