#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diff_pruning_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths through its own kernels, on the full-width
CIFAR-10 UNet (35.75M params) from a seeded random checkpoint, and checks
them: the serving path (DDIM-100 sampling) and the pruning path (the
Diff-Pruning sweep, scoring, slicing and the prune CLI). Every phase raises
on failure; none is caught, so any failure exits non-zero before the
result lines.

1. Device: CUDA must be available; prints nvidia-smi's name and power limit.
2. Build: compiles the CUDA kernels (one nvcc per source, sm_90a, all at
   once) and the Triton kernels from this checkout's sources; prints the
   build seconds and ptxas's registers and spills (per kernel for the f32
   attention backward), and counts the attention kernels' tensor-core
   (HMMA) and FFMA instructions in their SASS (cuobjdump): the bf16/f16
   forward kernels must use the tensor cores, the f32 forward and backward
   kernels must not (exact f32, no TF32).
3. Forward kernels against their plain versions on the card, B = 128, f32
   and bf16, at every GroupNorm and attention shape the dense and the
   pruned UNet give them (collected by forward hooks), plus a ragged token
   count.
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
   parameter's grad, Diff-Pruning scores, launch counts per step; then the
   kernel-on sweep again, whose grads must be bit-identical.
10. Pruning path (this slice's main path): the prune CLI, diff-pruning at
   ratio 0.3, thr 0.05, at most 20 sweep steps, B = 128, on a seeded .npz
   of 128 images; launch counters reset just before and read just after.
   The checkpoint it writes reloads at the pinned param count, and the
   sampling CLI draws 128 finite images from it.
11. Timings: per-op backward kernels against plain and the library call
   (attention dq and dk/dv also in TFLOP/s),
   the sweep step (forward + backward, f32) with the kernels on and off,
   and a torch.profiler breakdown of the sweep step by kernel class.
12. The kernels' JSON line, nvidia-smi's line, then the result line.

TF32 is off for matmuls and convolutions throughout (printed), so f32
comparisons are f32 against f32.
"""

import collections
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
    if n.startswith("gn_") or "gn_fwd_kernel" in n:  # Triton's names; the CUDA one, mangled
        return "GroupNorm kernels"
    if "flash_fwd_kernel" in n or "flash_bwd_" in n:  # the CUDA kernels, mangled
        return "attention kernels"
    if any(w in n for w in ("conv", "fft", "winograd", "implicit", "grad", "cudnn", "xmma",
                            "flip")):
        return "convolutions"
    if any(w in n for w in ("gemm", "cutlass", "cublas")):
        return "GEMMs"
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


def ptxas_by_kernel(log: str):
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    ``nvcc -Xptxas -v``'s log, for the f32 attention backward kernels, named
    as ``flash_bwd_dq_kernel_f32<NC>``."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(flash_bwd_\w+?_f32)ILi(\d)E", line)
        if "Compiling entry function" in line:
            name = f"{m.group(1)}<{m.group(2)}>" if m else None
        elif name is not None and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name] = [None, int(nums[0]), int(nums[1])]
        elif name is not None and "registers" in line and name in out:
            out[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return {k: tuple(v) for k, v in out.items()}


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


def profile_classes(fn):
    """Device time by kernel class (ms), the host span (ms), the kernel count
    and the kernel count by class of one run of ``fn``, from torch.profiler's
    CUPTI trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    busy, counts = collections.defaultdict(float), collections.Counter()
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        busy[kernel_class(evt.key)] += us / 1e3
        counts[kernel_class(evt.key)] += evt.count
    return dict(busy), span, sum(counts.values()), dict(counts)


def print_profile(what, busy, span, launches, counts, per, tag):
    print(f"profile {what} (torch.profiler, device ms per {per[0]} by kernel class): "
          + ", ".join(f"{k} {v / per[1]:.2f}" for k, v in sorted(busy.items()))
          + f"; device busy {sum(busy.values()) / per[1]:.2f} of {span / per[1]:.2f} ms span "
          + "per " + per[0] + ", idle share "
          + (f"{1 - sum(busy.values()) / span:.3f}" if busy else "not measured")
          + f", {launches / per[1]:.0f} kernel launches per {per[0]} ("
          + ", ".join(f"{k} {v / per[1]:.1f}" for k, v in sorted(counts.items())) + f") {tag}")


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


def main() -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

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
    from diff_pruning_tpu_torch.cli import ddpm_prune, ddpm_sample
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
    from diff_pruning_tpu_torch.utils.checkpoint import (flat_from_state_dict, load_model,
                                                         save_model)

    # -- 2. build: one nvcc per CUDA source in the background, Triton meanwhile
    t_build = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=1)
    cuda_build = pool.submit(_build.build_libraries)
    triton_mod = _build.group_norm_kernels()
    small = torch.randn((2, 16, 64), device=dev)
    ones, zeros = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        for silu in (False, True):
            x = small.to(dtype)
            group_norm(x, ones, zeros, groups=32, with_silu=silu)
            _, mean, rstd = G.group_norm_forward_with_stats(x, ones, zeros, groups=32,
                                                            with_silu=silu)
            G.group_norm_backward(x, ones, zeros, x, mean, rstd, groups=32, with_silu=silu)
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t_build
    cuda_build.result()  # raises the build's error, if any
    pool.shutdown()
    import triton

    for name in _build.CUDA_LIBRARIES:
        info = _build.BUILD_INFO[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build: {name}.cu (nvcc sm_90a) {info['seconds']:.2f}s; " + " | ".join(ptxas))
    print(f"build: {os.path.relpath(triton_mod.__file__, REPO)} (triton {triton.__version__}) "
          f"first 4 variants {t_triton:.2f}s; all builds {time.perf_counter() - t_build:.2f}s")
    bwd_regs = ptxas_by_kernel(_build.BUILD_INFO["flash_attention_bwd"]["log"])
    for kname, (regs, st, ld) in sorted(bwd_regs.items()):
        print(f"ptxas: flash_attention_bwd {kname}: {regs} registers, spill stores {st} "
              f"bytes, spill loads {ld} bytes")
    if _build.BUILD_INFO["flash_attention_bwd"]["log"]:  # empty when already built
        assert {k.split("<")[0] for k in bwd_regs} == {"flash_bwd_dq_kernel_f32",
                                                      "flash_bwd_dkv_kernel_f32"}, bwd_regs
    for lib in ("flash_attention_fwd", "flash_attention_bwd"):
        sass = sass_counts(_build.load_library(lib)._name)
        if sass is None:
            print("sass: no cuobjdump in the toolkit; tensor-core use not checked")
            break
        for kname, (hmma, ffma) in sorted(sass.items()):
            print(f"sass: {lib} {kname}: {hmma} HMMA, {ffma} FFMA")
            if "flash_fwd_kernel_mma" in kname:
                assert hmma > 0, f"{kname} has no tensor-core instruction"
            if "_kernel_f32" in kname:
                assert hmma == 0 and ffma > 0, f"{kname} is not f32 on the CUDA cores"
        want = "flash_fwd_kernel_mma" if lib == "flash_attention_fwd" else "_kernel_f32"
        assert sum(want in kname for kname in sass) >= 2, sorted(sass)

    # -- 3. forward kernels against plain versions at the UNet's shapes, B = 128
    cfg = ddpm_cifar10_config()
    pcfg = pruned_config(cfg)
    dense = UNet2D(cfg, device="cpu").init(torch.Generator().manual_seed(0)).eval()
    pruned = UNet2D(pcfg, device="cpu").init(torch.Generator().manual_seed(1)).eval()
    gn_dense, attn_dense = op_shapes(dense)
    gn_pruned, attn_pruned = op_shapes(pruned)
    print(f"dense UNet: {sum(gn_dense.values())} GroupNorm and {sum(attn_dense.values())} "
          f"attention calls per forward; pruned: {sum(gn_pruned.values())} and "
          f"{sum(attn_pruned.values())}")
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = collections.defaultdict(float)
    gn_cases = sorted(set(gn_dense) | set(gn_pruned))
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
    attn_cases = sorted(set(attn_dense) | set(attn_pruned) | {(100, 1, 256)})
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
        # warm-up: compiles the Triton variants of this model's shapes
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
            for _ in range(5):
                group_norm(x, s, b, groups=32, with_silu=silu)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                group_norm(x, s, b, groups=32, with_silu=silu)
            us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            total += us * calls
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
    res_on, counts_on, grads_on = sweep(True)
    unhook()
    print(f"GroupNorm inputs, sweep under autograd ({SWEEP_STEPS} steps): {dict(gn_seen)}")
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
    tmpdir.cleanup()

    # -- 11. timings: backward per op at the dense shapes, then the sweep step
    per_step_bwd = {}
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
        for (n, h, d), calls in sorted(attn_dense.items()):
            q, k, v, do = (torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            scale = d ** -0.5
            o, lse = A.reference_attention_lse(q, k, v, scale)
            _, dsum = A.attention_backward_dq_reference(q, k, v, o, do, lse, scale)
            ql, kl, vl = (z.detach().clone().requires_grad_() for z in (q, k, v))
            ol = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
            ms = in_turns([
                lambda: A.attention_backward_dq_reference(q, k, v, o, do, lse, scale),
                lambda: A.flash_attention_backward_dq(q, k, v, o, do, lse, scale),
                lambda: A.attention_backward_dkv_reference(q, k, v, do, lse, dsum, scale),
                lambda: A.flash_attention_backward_dkv(q, k, v, do, lse, dsum, scale),
                lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)],
                iters=20)
            fq, fkv = attn_dq_work(n, h, d, dname)[1], attn_dkv_work(n, h, d, dname)[1]
            bq, byq = bound(*attn_dq_work(n, h, d, dname), dname)
            bkv, bykv = bound(*attn_dkv_work(n, h, d, dname), dname)
            for key, val in (("dq_plain", ms[0]), ("dq_kernel", ms[1]), ("dkv_plain", ms[2]),
                             ("dkv_kernel", ms[3]), ("attn_library", ms[4]),
                             ("dq_flops", fq), ("dkv_flops", fkv)):
                tot[key] += val * calls
            add_bound(tot, "dq_", bq * calls, byq)
            add_bound(tot, "dkv_", bkv * calls, bykv)
            print(f"time attention bwd {(n, h, d)} x{calls}/step B={B} {dname}: dq kernel "
                  f"{ms[1]:.4f} ms, {fq / ms[1] / 1e9:.1f} TFLOP/s (plain {ms[0]:.4f}, bound "
                  f"{bq:.4f} {byq}), dk/dv kernel {ms[3]:.4f} ms, {fkv / ms[3] / 1e9:.1f} "
                  f"TFLOP/s (plain {ms[2]:.4f}, bound {bkv:.4f} {bykv}), library "
                  f"(SDPA backward, dq+dk+dv) {ms[4]:.4f} ms {tag}")
        tot["dq_tflops"] = tot["dq_flops"] / tot["dq_kernel"] / 1e9
        tot["dkv_tflops"] = tot["dkv_flops"] / tot["dkv_kernel"] / 1e9
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

    # -- 12. result lines
    f32_fwd = {op: per_forward[(op, "float32")] for op in ("group_norm", "attention")}
    f32_bwd = per_step_bwd["float32"]

    def entry(name, route, source, replaces, launches, err_key, ms, plain_ms, bound_ms,
              bound_by, library_ms, **extra):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": worst[(err_key, "float32")],
                "max_abs_err_bf16": worst[(err_key, "bfloat16")], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, **extra}

    per_fwd = "f32, summed over one B=128 UNet forward's calls (inference launch)"
    per_bwd = "f32, summed over one B=128 sweep step's calls"
    gn_fwd_src = "diff_pruning_tpu_torch/ops/csrc/group_norm_fwd.cu"
    gn_bwd_src = "diff_pruning_tpu_torch/ops/_group_norm_triton.py"
    bf16_fwd = {op: per_forward[(op, "bfloat16")] for op in ("group_norm", "attention")}
    attn_bwd_src = "diff_pruning_tpu_torch/ops/csrc/flash_attention_bwd.cu"
    kernels = [
        entry("group_norm_silu_fwd", "cuda", gn_fwd_src, "diff_pruning_tpu/ops/group_norm.py:110",
              cli_counts["group_norm"], "group_norm", f32_fwd["group_norm"]["kernel"],
              f32_fwd["group_norm"]["plain"], f32_fwd["group_norm"]["bound"],
              bound_by(f32_fwd["group_norm"]),
              f32_fwd["group_norm"]["library"], ms_is=per_fwd,
              library_ms_is="F.group_norm over the no-SiLU calls only",
              ms_where_library=f32_fwd["group_norm"]["kernel_where_library"],
              ms_bf16=bf16_fwd["group_norm"]["kernel"],
              library_ms_bf16=bf16_fwd["group_norm"]["library"],
              host_us_per_call=host_us["float32"], host_us_per_call_bf16=host_us["bfloat16"],
              launches_serving_dense=results["dense"]["launches"]["group_norm"]),
        entry("group_norm_silu_bwd", "triton", gn_bwd_src, "diff_pruning_tpu/ops/group_norm.py:131",
              cli_counts["group_norm_bwd"], "group_norm_bwd", f32_bwd["gn_kernel"],
              f32_bwd["gn_plain"], f32_bwd["gn_bound"], bound_by(f32_bwd, "gn_"),
              f32_bwd["gn_library"],
              ms_is=per_bwd,
              library_ms_is="autograd of F.group_norm over the no-SiLU calls only",
              ms_where_library=f32_bwd["gn_kernel_where_library"]),
        entry("flash_attention_fwd", "cuda",
              "diff_pruning_tpu_torch/ops/csrc/flash_attention_fwd.cu",
              "diff_pruning_tpu/ops/attention.py:97", cli_counts["attention"], "attention",
              f32_fwd["attention"]["kernel"], f32_fwd["attention"]["plain"],
              f32_fwd["attention"]["bound"], bound_by(f32_fwd["attention"]),
              f32_fwd["attention"]["library"],
              ms_is=per_fwd, library_ms_is="F.scaled_dot_product_attention",
              ms_bf16=bf16_fwd["attention"]["kernel"],
              library_ms_bf16=bf16_fwd["attention"]["library"],
              tflops=f32_fwd["attention"]["tflops"], tflops_bf16=bf16_fwd["attention"]["tflops"],
              max_abs_err_lse=worst[("attention_lse", "float32")],
              launches_with_lse=cli_counts["attention_lse"],
              launches_serving_dense=results["dense"]["launches"]["attention"]),
        entry("flash_attention_bwd_dq", "cuda", attn_bwd_src,
              "diff_pruning_tpu/ops/attention.py:205", cli_counts["attention_bwd_dq"],
              "attention_bwd_dq", f32_bwd["dq_kernel"], f32_bwd["dq_plain"],
              f32_bwd["dq_bound"], bound_by(f32_bwd, "dq_"), None, ms_is=per_bwd,
              library_ms_dq_dk_dv=f32_bwd["attn_library"], tflops=f32_bwd["dq_tflops"],
              ms_bf16=per_step_bwd["bfloat16"]["dq_kernel"]),
        entry("flash_attention_bwd_dkv", "cuda", attn_bwd_src,
              "diff_pruning_tpu/ops/attention.py:205", cli_counts["attention_bwd_dkv"],
              "attention_bwd_dkv", f32_bwd["dkv_kernel"], f32_bwd["dkv_plain"],
              f32_bwd["dkv_bound"], bound_by(f32_bwd, "dkv_"), None, ms_is=per_bwd,
              library_ms_dq_dk_dv=f32_bwd["attn_library"], tflops=f32_bwd["dkv_tflops"],
              ms_bf16=per_step_bwd["bfloat16"]["dkv_kernel"]),
    ]
    print(json.dumps({"sweep_step_ms": {"kernels_on": step_on, "kernels_off": step_off},
                      "prune_cli_seconds": cli_seconds, "sampling_imgs_per_s": sampling}))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
