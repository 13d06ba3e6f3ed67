"""CLI: large-batch DDIM sampling for FID (counterpart of
``diff_pruning_tpu/cli/ddpm_sample.py``, mode ``fid``).

    python -m diff_pruning_tpu_torch.cli.ddpm_sample --model_path DIR \\
        --output_dir OUT --total_samples 50000 --batch_size 128 --device cuda

Loads a ``(config.json, params.npz)`` checkpoint in the JAX package's
layout, samples DDIM (or DDPM) trajectories batch by batch and writes PNGs,
each batch encoded while the next one runs. ``--device cuda`` without a GPU
raises: the CLI never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--total_samples", type=int, default=50000)
    p.add_argument("--ddim_steps", type=int, default=100)
    p.add_argument("--skip_type", type=str, default="uniform", choices=["uniform", "quad"])
    p.add_argument("--style", type=str, default="ddim_exp", choices=["diffusers", "ddim_exp"])
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--sampler", type=str, default="ddim",
                   choices=["ddim", "ddpm", "plms", "dpm"],
                   help="trajectory kind (plms and dpm are not ported yet)")
    p.add_argument("--no_clip", action="store_true")
    p.add_argument("--use_ema", action="store_true",
                   help="load unet_ema subfolder if present")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", type=str, default="fid",
                   choices=["fid", "sequence", "interpolation"],
                   help="fid: bulk PNGs (sequence and interpolation are not ported yet)")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def resolve_device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def main(argv=None) -> dict:
    """Returns ``{"params", "macs", "images", "nonfinite", "seconds", "imgs_per_s"}``."""
    args = parse_args(argv)
    if args.mode != "fid":
        raise NotImplementedError(f"--mode {args.mode} comes with the port of "
                                  "sampling/trajectories.py")
    device = resolve_device(args.device)
    import torch

    from ..models.unet2d import UNet2D
    from ..pruning.flops import count_ops_and_params
    from ..sampling.ddim_sampler import SamplerConfig, make_sampler
    from ..sampling.distributed import sample_many
    from ..schedulers.ddpm import DiffusionSchedule
    from ..utils.checkpoint import load_model
    from .ddpm_prune import load_unet

    if args.use_ema and os.path.exists(os.path.join(args.model_path, "unet_ema", "params.npz")):
        cfg, state = load_model(args.model_path, subfolder="unet_ema")
    else:
        cfg, state = load_unet(args.model_path)
    model = UNet2D(cfg, device=device)
    model.load_state_dict(state)
    model.eval()
    hw = cfg.sample_size or 32
    macs, n_params = count_ops_and_params(model, (1, hw, hw, cfg.in_channels))
    print("#Params: {:.4f} M".format(n_params / 1e6))
    print("#MACS: {:.4f} G".format(macs / 1e9))

    schedule = DiffusionSchedule.create(device=device)
    sampler = make_sampler(model, schedule, SamplerConfig(
        num_inference_steps=args.ddim_steps,
        skip_type=args.skip_type,
        style=args.style,
        eta=args.eta,
        clip_sample=not args.no_clip,
        kind=args.sampler,
        dtype=args.dtype,
    ))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        # device-clock interval around the run; ends once the last PNG is written
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    stats = sample_many(sampler, generator=generator, total_images=args.total_samples,
                        batch_size=args.batch_size, hw=hw, channels=cfg.in_channels,
                        outdir=args.output_dir, progress=True)
    if device.type == "cuda":
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
        where = torch.cuda.get_device_name(device)
    else:
        dt = time.perf_counter() - t0
        where = "cpu"
    print(f"{stats['images']} images in {dt:.2f}s ({stats['images'] / dt:.2f} imgs/s "
          f"at {args.ddim_steps} DDIM steps, {args.dtype}, {where})")
    if stats["nonfinite"]:
        print(f"WARNING: {stats['nonfinite']} non-finite sample values")
    return {"params": n_params, "macs": macs, **stats, "seconds": dt,
            "imgs_per_s": stats["images"] / dt}


if __name__ == "__main__":
    main()
