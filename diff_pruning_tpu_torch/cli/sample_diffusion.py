"""CLI: unconditional LDM sampling (counterpart of
``diff_pruning_tpu/cli/sample_diffusion.py``; ldm_exp/scripts/sample_diffusion.py:
the celeba256 / ffhq256 / lsun_{beds,churches}256 model dirs).

    python -m diff_pruning_tpu_torch.cli.sample_diffusion --model_path DIR \\
        --logdir OUT --n_samples 200 --batch_size 50 --custom_steps 250 --eta 1.0 \\
        --device cuda

Model dir: ``unet/`` (a UNetCond config with ``context_dim=None``) and
``first_stage/`` (VQ or KL), in the JAX package's layout. The latents come
from DDIM with ``--eta`` through ``make_concat_sampler`` with an empty
(B, h, w, 0) conditioning (the concat path's unconditional case, which
never clips latents), or with ``--vanilla_sample`` from the full 1000-step
DDPM chain; they are divided by ``--scale_factor`` and decoded (a VQ first
stage quantizes first), and written as ``img/%06d.png`` under ``--logdir``.
The PNGs of batch b are encoded while batch b + 1 runs. ``--device cuda``
without a GPU raises: the CLI never carries on on the CPU. TF32 is off for
matmuls and convolutions (printed at the start).
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--logdir", type=str, required=True)
    p.add_argument("--n_samples", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--custom_steps", "-c", type=int, default=250)
    p.add_argument("--eta", "-e", type=float, default=1.0)
    p.add_argument("--vanilla_sample", action="store_true",
                   help="full-chain DDPM instead of DDIM")
    p.add_argument("--scale_factor", type=float, default=1.0,
                   help="latent scaling (1.0 for the unconditional zoo)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{"images", "nonfinite", "seconds", "imgs_per_s",
    "unet_params", "first_stage_params"}``."""
    args = parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    device = resolve_device(args.device)
    import numpy as np
    import torch

    from ..models.latent_diffusion import ldm_schedule, make_concat_sampler
    from ..models.unet_cond import UNetCond, UNetCondConfig
    from ..models.vae import AutoencoderConfig, make_first_stage
    from ..sampling.distributed import sample_many
    from ..schedulers.ddim import ddim_prev_timesteps, ddpm_step
    from ..utils.checkpoint import load_model

    ucfg, ustate = load_model(args.model_path, "unet", config_cls=UNetCondConfig)
    fcfg, fstate = load_model(args.model_path, "first_stage", config_cls=AutoencoderConfig)
    unet = UNetCond(ucfg, device=device)
    unet.load_state_dict(ustate)
    fs = make_first_stage(fcfg, device=device)
    fs.load_state_dict(fstate)
    unet.eval()
    fs.eval()
    del ustate, fstate
    counts = {"unet_params": sum(p.numel() for p in unet.parameters()),
              "first_stage_params": sum(p.numel() for p in fs.parameters())}
    print(f"UNetCond {counts['unet_params']:,} params, "
          f"{'VQ' if fcfg.num_vq_embeddings else 'KL'} first stage "
          f"{counts['first_stage_params']:,}")
    hw, ch, b = ucfg.image_size, ucfg.in_channels, args.batch_size
    schedule = ldm_schedule(device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    if args.vanilla_sample:
        # DDPM over every timestep (sample_diffusion.py convsample)
        ts = np.arange(schedule.num_train_timesteps)[::-1].copy()
        chain = [(int(t), int(tp)) for t, tp in zip(ts, ddim_prev_timesteps(ts))]

        def sample_latents(g):
            x = torch.randn((b, hw, hw, ch), generator=g, device=device)
            for t, tp in chain:
                eps = unet(x, torch.full((b,), t, dtype=torch.int64, device=device))
                z = torch.randn(x.shape, generator=g, device=device)
                x = ddpm_step(schedule, x, eps, t, tp, z)
            return x
    else:
        concat = make_concat_sampler(unet, schedule, ddim_steps=args.custom_steps,
                                     eta=args.eta, latent_ch=ch)
        empty = torch.zeros((b, hw, hw, 0), device=device)

        def sample_latents(g):
            return concat(g, empty)

    def sampler(g, *_):
        """A batch's images in [0, 1], floored to k / 255: CompVis
        custom_to_pil writes (255 x).astype(uint8), and to_uint8's rounding
        maps k / 255 back to k."""
        with torch.inference_mode():
            z = sample_latents(g) / args.scale_factor
            img = (fs.decode(z, force_not_quantize=False) if fcfg.num_vq_embeddings
                   else fs.decode(z))
            return torch.floor(((img + 1.0) / 2.0).clamp(0.0, 1.0) * 255.0) / 255.0

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    # the PNGs of batch b are encoded while batch b + 1 runs
    stats = sample_many(sampler, generator=generator, total_images=args.n_samples,
                        batch_size=b, hw=hw, outdir=os.path.join(args.logdir, "img"),
                        progress=True)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    what = ("DDPM-1000 (vanilla)" if args.vanilla_sample
            else f"DDIM-{args.custom_steps} eta {args.eta}")
    n = stats["images"]
    print(f"wrote {n} images to {args.logdir}/img in {dt:.2f}s ({n / dt:.2f} imgs/s, {what}, "
          f"B={b}, f32, {where}, wall clock)")
    if stats["nonfinite"]:
        print(f"WARNING: {stats['nonfinite']} non-finite sample values")
    return {**stats, **counts, "seconds": dt, "imgs_per_s": n / dt}


if __name__ == "__main__":
    main()
