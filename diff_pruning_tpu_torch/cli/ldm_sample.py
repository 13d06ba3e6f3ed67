"""CLI: class-conditional LDM sampling for FID (counterpart of
``diff_pruning_tpu/cli/ldm_sample.py``; ldm_exp/sample_for_FID.py).

    python -m diff_pruning_tpu_torch.cli.ldm_sample --model_path DIR \\
        --output_dir OUT --ipc 50 --num_classes 1000 --batch_size 50 \\
        --ddim_steps 250 --scale 3.0 --method ddim --device cuda

Loads an LDM model dir in the JAX package's layout (``unet/``,
``cond_stage/``, optional ``first_stage/``, ``ldm.json``), samples ``--ipc``
images of each class with classifier-free guidance (DDIM, PLMS or
DPM-Solver++), decodes them through the first stage (or maps the latents
from [-1, 1] when there is none) and writes ``%06d.png`` numbered across
classes; the last batch of a class may be partial. The PNGs of batch b are
encoded while batch b + 1's trajectory runs. ``--device cuda`` without a
GPU raises: the CLI never carries on on the CPU. TF32 is off for matmuls
and convolutions (printed at the start).

With ``--multihost`` (one process per GPU, e.g. ``torchrun --nproc_per_node
N -m diff_pruning_tpu_torch.cli.ldm_sample --multihost ...``) every batch is
split by rows over the processes (``parallel/mesh.py``; the world size must
divide ``--batch_size``, and ``--batch_size`` must divide ``--ipc``, as the
JAX CLI asserts) and, with more than one, each writes its rows to
``process_{rank}/``, numbered locally; their union is the one-process run's
images.
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
    p.add_argument("--ipc", type=int, default=50, help="images per class")
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--ddim_steps", type=int, default=250)
    p.add_argument("--scale", type=float, default=3.0)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--method", type=str, default="ddim", choices=["ddim", "plms", "dpm"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    from ._multihost import add_multihost_args

    add_multihost_args(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{"images", "nonfinite", "seconds", "imgs_per_s"}``
    (``images``: this process's)."""
    args = parse_args(argv)
    from ._multihost import maybe_init_distributed
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    mesh = maybe_init_distributed(args)  # before the first use of the card
    device = mesh.device if mesh is not None else resolve_device(args.device)
    multiproc = mesh is not None and mesh.world > 1
    if mesh is not None and args.batch_size % mesh.world:
        raise SystemExit(f"--multihost: batch_size {args.batch_size} must be divisible by "
                         f"the world size {mesh.world}")
    if multiproc and args.ipc % args.batch_size:
        raise SystemExit("--multihost needs --ipc % --batch_size == 0 (whole batches)")
    import numpy as np
    import torch

    from ..models.latent_diffusion import load_ldm
    from ..sampling.ddim_sampler import save_images
    from ..sampling.distributed import _stage

    ldm = load_ldm(args.model_path, None, args.seed, device=device)
    hw, ch = ldm.unet.cfg.image_size, ldm.unet.cfg.in_channels
    sampler = ldm.make_cfg_sampler(ddim_steps=args.ddim_steps, guidance_scale=args.scale,
                                   eta=args.eta, latent_hw=hw, latent_ch=ch, method=args.method,
                                   mesh=mesh)
    # more than one process: each writes its rows to process_{rank}/, numbered
    # locally (the reference's per-process layout, ddpm_sample.py:55-74)
    outdir = (os.path.join(args.output_dir, f"process_{mesh.rank}") if multiproc
              else args.output_dir)
    if ldm.first_stage is not None:
        decode = ldm.decode_first_stage
    else:
        def decode(lat):
            return (lat * 0.5 + 0.5).clamp(0.0, 1.0)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    stats = {"images": 0, "nonfinite": 0}

    def flush(staged, n, start):
        host, done = staged
        if done is not None:
            done.synchronize()
        imgs = host.numpy()[:n]
        stats["images"] += len(imgs)
        stats["nonfinite"] += int(imgs.size - np.count_nonzero(np.isfinite(imgs)))
        save_images(imgs, outdir, start_index=start)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    idx, local_idx, pending = 0, 0, None
    for cls in range(args.num_classes):
        remaining = args.ipc
        while remaining > 0:
            n = min(args.batch_size, remaining)
            labels = torch.full((args.batch_size,), cls, dtype=torch.int64, device=device)
            staged = _stage(decode(sampler(generator, labels, args.batch_size)))
            if pending is not None:
                flush(*pending)
            if multiproc:  # this rank's rows of a whole batch, numbered locally
                pending = (staged, args.batch_size // mesh.world, local_idx)
                local_idx += args.batch_size // mesh.world
            else:
                pending = (staged, n, idx)
            idx += n
            remaining -= n
        if (cls + 1) % 25 == 0:
            print(f"class {cls + 1}/{args.num_classes}: {idx} images")
    if pending is not None:
        flush(*pending)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"wrote {stats['images']} images to {outdir} in {dt:.2f}s "
          f"({stats['images'] / dt:.2f} imgs/s, "
          f"{args.method} {args.ddim_steps} steps, scale {args.scale}, B={args.batch_size}, "
          f"f32, {where}, wall clock)")
    if stats["nonfinite"]:
        print(f"WARNING: {stats['nonfinite']} non-finite sample values")
    return {**stats, "seconds": dt, "imgs_per_s": stats["images"] / dt}


if __name__ == "__main__":
    main()
