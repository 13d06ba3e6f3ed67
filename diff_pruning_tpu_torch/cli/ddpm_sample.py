"""CLI: large-batch sampling for FID, trajectory and interpolation grids
(counterpart of ``diff_pruning_tpu/cli/ddpm_sample.py``).

    python -m diff_pruning_tpu_torch.cli.ddpm_sample --model_path DIR \\
        --output_dir OUT --total_samples 50000 --batch_size 128 --device cuda

Loads a ``(config.json, params.npz)`` checkpoint in the JAX package's
layout, or a diffusers directory (``cli/ddpm_prune.py``'s ``load_unet``). ``--mode fid`` samples DDIM, DDPM, PLMS or DPM-Solver++
trajectories batch by batch and writes PNGs, each batch encoded while the
next one runs. ``--mode sequence`` writes ``sequence.png``: 4 samples, every
``len // 10``-th state of their DDIM trajectories as columns
(diffusion.py:429). ``--mode interpolation`` writes ``interpolation.png``:
11 slerp interpolants of two noises, denoised (diffusion.py:452). ``--device cuda`` without a GPU
raises: the CLI never carries on on the CPU. TF32 is off for matmuls and
convolutions (printed at the start).

With ``--multihost`` (one process per GPU, e.g. ``torchrun --nproc_per_node
N -m diff_pruning_tpu_torch.cli.ddpm_sample --multihost ...``) ``--mode
fid`` splits every batch of ``--batch_size`` by rows over the processes
(``parallel/mesh.py``; the world size must divide it) and each writes its
rows to ``process_{rank}/``, numbered locally, in whole batches; their
union is the one-process run's images. The grid modes run on rank 0 only.
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
                   help="trajectory kind (plms: ldm_exp plms.py; plms and dpm need eta 0)")
    p.add_argument("--no_clip", action="store_true")
    p.add_argument("--use_ema", action="store_true",
                   help="load unet_ema subfolder if present")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", type=str, default="fid",
                   choices=["fid", "sequence", "interpolation"],
                   help="fid: bulk PNGs; sequence: trajectory grid (diffusion.py:429); "
                        "interpolation: slerp grid (:452)")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    from ._multihost import add_multihost_args

    add_multihost_args(p)
    return p.parse_args(argv)


def resolve_device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def pin_f32_precision() -> None:
    """Full f32 matmuls and convolutions: torch's default runs cuDNN's f32
    convolutions in TF32, which neither the port's timings nor its parity
    tests against the JAX package use. Prints both flags."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")


def main(argv=None) -> dict:
    """Returns ``{"params", "macs", "images", "nonfinite", "seconds",
    "imgs_per_s"}`` (``images``: this process's); in the grid modes
    ``{"params", "macs", "path", "shape"}`` (the grid's images before tiling;
    on a rank other than 0 only the first two)."""
    args = parse_args(argv)
    pin_f32_precision()
    from ._multihost import maybe_init_distributed

    mesh = maybe_init_distributed(args)  # before the first use of the card
    device = mesh.device if mesh is not None else resolve_device(args.device)
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
    if args.mode != "fid":
        if mesh is not None and not mesh.is_main:
            return {"params": n_params, "macs": macs}
        return {"params": n_params, "macs": macs,
                **write_grid(args, model, schedule, hw, cfg.in_channels, device)}
    if mesh is not None and args.batch_size % mesh.world:
        raise SystemExit(f"--multihost: batch_size {args.batch_size} must be divisible by "
                         f"the world size {mesh.world}")
    sampler = make_sampler(model, schedule, SamplerConfig(
        num_inference_steps=args.ddim_steps,
        skip_type=args.skip_type,
        style=args.style,
        eta=args.eta,
        clip_sample=not args.no_clip,
        kind=args.sampler,
        dtype=args.dtype,
    ), mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        # device-clock interval around the run; ends once the last PNG is written
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    stats = sample_many(sampler, generator=generator, total_images=args.total_samples,
                        batch_size=args.batch_size, hw=hw, channels=cfg.in_channels,
                        outdir=args.output_dir, progress=True, mesh=mesh)
    if device.type == "cuda":
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
        where = torch.cuda.get_device_name(device)
    else:
        dt = time.perf_counter() - t0
        where = "cpu"
    rank = "" if mesh is None else f" on rank {mesh.rank} of {mesh.world}"
    print(f"{stats['images']} images{rank} in {dt:.2f}s ({stats['images'] / dt:.2f} imgs/s "
          f"at {args.ddim_steps} DDIM steps, {args.dtype}, {where})")
    if stats["nonfinite"]:
        print(f"WARNING: {stats['nonfinite']} non-finite sample values")
    return {"params": n_params, "macs": macs, **stats, "seconds": dt,
            "imgs_per_s": stats["images"] / dt}


def write_grid(args, model, schedule, hw: int, channels: int, device) -> dict:
    """``--mode sequence`` or ``interpolation``: one PNG grid in
    ``--output_dir``, as the JAX CLI writes it."""
    import torch

    from ..sampling.ddim_sampler import save_image_grid
    from ..sampling.trajectories import sample_interpolation, sample_trajectory

    os.makedirs(args.output_dir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    steps = dict(num_inference_steps=args.ddim_steps, skip_type=args.skip_type,
                 style=args.style, generator=generator)
    if args.mode == "sequence":
        traj = sample_trajectory(model, schedule, batch_size=4, hw=hw, channels=channels,
                                 **steps)
        # rows = samples, cols = every 10th state
        sel = traj[:: max(1, traj.shape[0] // 10)]
        imgs = sel.transpose(0, 1).reshape(-1, hw, hw, channels)
        path = os.path.join(args.output_dir, "sequence.png")
        save_image_grid(imgs, path, nrow=sel.shape[0])
        print(f"wrote sequence.png ({sel.shape[0]} states x 4 samples)")
    else:
        imgs = sample_interpolation(model, schedule, hw=hw, channels=channels, n_alphas=11,
                                    **steps)
        path = os.path.join(args.output_dir, "interpolation.png")
        save_image_grid(imgs, path, nrow=11)
        print("wrote interpolation.png")
    return {"path": path, "shape": tuple(imgs.shape)}


if __name__ == "__main__":
    main()
