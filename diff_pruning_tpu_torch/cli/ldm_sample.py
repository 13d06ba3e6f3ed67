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
and convolutions (printed at the start). The multi-host flags wait for the
multi-GPU slice and raise.
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--multihost", action="store_true",
                   help="multi-host sampling (not ported yet: raises)")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{"images", "nonfinite", "seconds", "imgs_per_s"}``."""
    args = parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    if args.multihost or args.coordinator_address or args.num_processes or args.process_id:
        raise NotImplementedError("multi-host sampling (--multihost and its address flags) "
                                  "comes with the multi-GPU slice")
    device = resolve_device(args.device)
    import numpy as np
    import torch

    from ..models.latent_diffusion import load_ldm
    from ..sampling.ddim_sampler import save_images
    from ..sampling.distributed import _stage

    ldm = load_ldm(args.model_path, None, args.seed, device=device)
    hw, ch = ldm.unet.cfg.image_size, ldm.unet.cfg.in_channels
    sampler = ldm.make_cfg_sampler(ddim_steps=args.ddim_steps, guidance_scale=args.scale,
                                   eta=args.eta, latent_hw=hw, latent_ch=ch, method=args.method)
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
        stats["images"] += n
        stats["nonfinite"] += int(imgs.size - np.count_nonzero(np.isfinite(imgs)))
        save_images(imgs, args.output_dir, start_index=start)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    idx, pending = 0, None
    for cls in range(args.num_classes):
        remaining = args.ipc
        while remaining > 0:
            n = min(args.batch_size, remaining)
            labels = torch.full((args.batch_size,), cls, dtype=torch.int64, device=device)
            staged = _stage(decode(sampler(generator, labels, args.batch_size)))
            if pending is not None:
                flush(*pending)
            pending = (staged, n, idx)
            idx += n
            remaining -= n
        if (cls + 1) % 25 == 0:
            print(f"class {cls + 1}/{args.num_classes}: {idx} images")
    if pending is not None:
        flush(*pending)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"wrote {idx} images to {args.output_dir} in {dt:.2f}s ({idx / dt:.2f} imgs/s, "
          f"{args.method} {args.ddim_steps} steps, scale {args.scale}, B={args.batch_size}, "
          f"f32, {where}, wall clock)")
    if stats["nonfinite"]:
        print(f"WARNING: {stats['nonfinite']} non-finite sample values")
    return {**stats, "seconds": dt, "imgs_per_s": idx / dt}


if __name__ == "__main__":
    main()
