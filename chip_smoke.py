#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diff_pruning_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the serving path, DDIM-100 sampling of the full-width CIFAR-10 UNet
(35.75M params) from a seeded random checkpoint, through the port's own
kernels, and checks it. Every phase raises on failure; none is caught, so
any failure exits non-zero before the result lines.

1. Device: CUDA must be available; prints nvidia-smi's name and power limit.
2. Build: compiles the CUDA kernel (nvcc, sm_90a) and the Triton kernels
   from this checkout's sources; prints the build seconds.
3. Kernels against their plain versions on the card, B = 128, f32 and bf16,
   at every GroupNorm and attention shape the dense and the pruned UNet
   give them (collected by forward hooks), plus a ragged token count.
4. Full-width forward, B = 128, kernels on and off on the same weights.
5. Main path, dense: the sampling CLI, 256 images in batches of 128,
   DDIM-100; launch counters reset just before and read just after.
6. Main path, pruned: the same CLI on a checkpoint keeping
   floor(0.7 * size / group_div) * group_div channels of every prunable var.
7. Timings (CUDA events, turns plain-kernel-kernel-plain): per-op kernel
   against plain at the main-path shapes, and sampling imgs/s with the
   kernels on and off.
8. The kernels' JSON line, then the result line.

TF32 is off for matmuls and convolutions throughout (printed), so f32
comparisons are f32 against f32.
"""

import collections
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B = 128
# |kernel - plain| <= atol + rtol * |plain|. f32: both compute in f32 and
# differ only in summation order. bf16: two bf16 ulps; both round an f32
# result once, and the plain attention also rounds its probabilities.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
# kernels on vs off through the whole f32 UNet (outputs of order 1)
FORWARD_TOL_F32 = 1e-3


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


def in_turns(plain, kernel, iters: int):
    """Mean ms of each, timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return (p1 + p2) / 2, (k1 + k2) / 2


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


def main() -> None:
    import torch

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
    from diff_pruning_tpu_torch.cli import ddpm_sample
    from diff_pruning_tpu_torch.models.unet2d import UNet2D, ddpm_cifar10_config
    from diff_pruning_tpu_torch.ops import _build
    from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
    from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference
    from diff_pruning_tpu_torch.sampling.ddim_sampler import SamplerConfig, make_sampler
    from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
    from diff_pruning_tpu_torch.utils.checkpoint import save_model

    # -- 2. build
    _build.load_library("flash_attention_fwd")
    info = _build.BUILD_INFO["flash_attention_fwd"]
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    print(f"build: flash_attention_fwd.cu (nvcc sm_90a) {info['seconds']:.2f}s; "
          + " | ".join(ptxas))
    t0 = time.perf_counter()
    triton_mod = _build.group_norm_kernels()
    small = torch.randn((2, 16, 64), device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        for silu in (False, True):
            group_norm(small.to(dtype), torch.ones(64, device=dev), torch.zeros(64, device=dev),
                       groups=32, with_silu=silu)
    torch.cuda.synchronize()
    import triton

    print(f"build: {os.path.relpath(triton_mod.__file__, REPO)} (triton {triton.__version__}) "
          f"first 4 variants {time.perf_counter() - t0:.2f}s")

    # -- 3. kernels against plain versions at the UNet's shapes, B = 128
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
    worst = {("group_norm", d): 0.0 for d in TOL} | {("attention", d): 0.0 for d in TOL}
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
        ops.reset_launch_counts()
        y_on = model(x, t)
        fwd_counts = dict(ops.LAUNCHES)
        ops.set_kernels_enabled(False)
        y_off = model(x, t)
        ops.set_kernels_enabled(True)
    diff = float((y_on - y_off).abs().max())
    print(f"forward cifar10 35.75M B={B} f32: kernels on vs off max_abs_diff={diff:.3e} "
          f"(tol {FORWARD_TOL_F32}), launches {fwd_counts}, |y| max {float(y_off.abs().max()):.3f}")
    assert fwd_counts["group_norm"] == sum(gn_dense.values()), fwd_counts
    assert fwd_counts["attention"] == sum(attn_dense.values()), fwd_counts
    assert bool(torch.isfinite(y_on).all()) and diff <= FORWARD_TOL_F32

    # -- 5./6. main path through the CLI: dense, then pruned
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
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
            print(f"main path {name}: {stats['params'] / 1e6:.4f}M params, {len(pngs)} PNGs, "
                  f"{stats['imgs_per_s']:.2f} imgs/s (DDIM-100, B={B}, f32, CUDA events, "
                  f"after warm-up) {tag}; launches {counts}")
            assert len(pngs) == 256 and stats["images"] == 256 and stats["nonfinite"] == 0
            forwards = 100 * 2
            assert counts["group_norm"] == forwards * sum(gn_n.values()) > 0, counts
            assert counts["attention"] == forwards * sum(attn_n.values()) > 0, counts
            results[name] = {"stats": stats, "launches": counts}

    # -- 7. timings: per op at the dense main-path shapes, then sampling imgs/s
    per_forward = {}
    for op, cases in (("group_norm", gn_dense), ("attention", attn_dense)):
        for dname in TOL:
            dtype = getattr(torch, dname)
            total_p = total_k = 0.0
            for shape, calls in sorted(cases.items()):
                if op == "group_norm":
                    n, c, silu = shape
                    x = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
                    s, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
                    kw = dict(groups=32, with_silu=silu)
                    pm, km = in_turns(lambda: group_norm_reference(x, s, b, **kw),
                                      lambda: group_norm(x, s, b, **kw), iters=20)
                else:
                    n, h, d = shape
                    q, k, v = (torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
                               for _ in range(3))
                    pm, km = in_turns(lambda: reference_attention(q, k, v, d ** -0.5),
                                      lambda: flash_attention(q, k, v, d ** -0.5), iters=20)
                total_p += pm * calls
                total_k += km * calls
                print(f"time {op} {shape} x{calls}/forward B={B} {dname}: kernel {km:.4f} ms, "
                      f"plain {pm:.4f} ms {tag}")
            per_forward[(op, dname)] = (total_k, total_p)
            print(f"time {op} per UNet forward B={B} {dname}: kernel {total_k:.4f} ms, "
                  f"plain {total_p:.4f} ms {tag}")

    sched = DiffusionSchedule.create(device=dev)
    sampling = {}
    for dname in TOL:
        sample = make_sampler(model, sched, SamplerConfig(num_inference_steps=100, dtype=dname))
        warm = make_sampler(model, sched, SamplerConfig(num_inference_steps=2, dtype=dname))

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
        sampling[dname] = (B * 2000 / (on1 + on2), B * 2000 / (off1 + off2))
        print(f"time sampling dense DDIM-100 B={B} {dname}: kernels on "
              f"{sampling[dname][0]:.2f} imgs/s ({on1:.1f}, {on2:.1f} ms), kernels off "
              f"{sampling[dname][1]:.2f} imgs/s ({off1:.1f}, {off2:.1f} ms) {tag}")
    torch.cuda.synchronize()

    # -- 8. result lines
    dense_launches = results["dense"]["launches"]
    kernels = [
        {"name": "group_norm_silu_fwd", "route": "triton",
         "source": "diff_pruning_tpu_torch/ops/_group_norm_triton.py",
         "replaces": "diff_pruning_tpu/ops/group_norm.py:110",
         "launches": dense_launches["group_norm"],
         "max_abs_err": worst[("group_norm", "float32")],
         "max_abs_err_bf16": worst[("group_norm", "bfloat16")],
         "ms": per_forward[("group_norm", "float32")][0],
         "plain_ms": per_forward[("group_norm", "float32")][1],
         "ms_is": "f32, summed over one B=128 UNet forward's calls"},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "diff_pruning_tpu_torch/ops/csrc/flash_attention_fwd.cu",
         "replaces": "diff_pruning_tpu/ops/attention.py:97",
         "launches": dense_launches["attention"],
         "max_abs_err": worst[("attention", "float32")],
         "max_abs_err_bf16": worst[("attention", "bfloat16")],
         "ms": per_forward[("attention", "float32")][0],
         "plain_ms": per_forward[("attention", "float32")][1],
         "ms_is": "f32, summed over one B=128 UNet forward's calls"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
