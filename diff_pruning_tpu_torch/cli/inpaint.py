"""CLI: latent-diffusion inpainting (counterpart of
``diff_pruning_tpu/cli/inpaint.py``; ldm_exp/scripts/inpaint.py, the
inpainting_big model: concat-mode conditioning, a VQ-f4-noattn first stage).

    python -m diff_pruning_tpu_torch.cli.inpaint --indir IN --outdir OUT \\
        --model_path DIR --steps 50 --batch_size 1 --device cuda

For every ``x.png`` + ``x_mask.png`` pair in ``--indir``: the masked image
is encoded by the first stage, the mask (scaled to [-1, 1], as inpaint.py:29
feeds it) is taken at the latents' size by nearest striding and concatenated
to it, the concat sampler runs the DDIM (or PLMS, DPM-Solver++) trajectory
(the schedule's linear_end 0.0205), the latents are decoded (a VQ first
stage quantizes them first, as ``decode_first_stage`` does) and
``(1 - mask) * image + mask * prediction`` is composited in [0, 1]
(inpaint.py:88-96) and written as ``OUT/x.png``.

Model dir: ``unet/`` (a UNetCond config) and ``first_stage/``, in the JAX
package's layout. ``--device cuda`` without a GPU raises: the CLI never
carries on on the CPU. TF32 is off for matmuls and convolutions (printed at
the start).
"""

from __future__ import annotations

import argparse
import glob
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--indir", type=str, required=True,
                   help="dir with image-mask pairs (x.png + x_mask.png)")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--model_path", type=str, required=True,
                   help="checkpoint dir (unet/ + first_stage/)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--method", type=str, default="ddim", choices=["ddim", "plms", "dpm"])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def load_pair(image_path, mask_path):
    """inpaint.py make_batch: image, mask and masked image, each in [-1, 1]
    (the binarised mask too, as the reference feeds it)."""
    import numpy as np
    from PIL import Image

    image = np.asarray(Image.open(image_path).convert("RGB"), np.float32) / 255.0
    mask = np.asarray(Image.open(mask_path).convert("L"), np.float32) / 255.0
    mask = (mask >= 0.5).astype(np.float32)[..., None]
    masked = (1.0 - mask) * image
    return image * 2 - 1, mask * 2 - 1, masked * 2 - 1


def main(argv=None) -> dict:
    """Returns ``{"images", "nonfinite", "seconds", "imgs_per_s",
    "unet_params", "first_stage_params"}`` (seconds: the sampling, decoding
    and compositing, loading excluded)."""
    args = parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    device = resolve_device(args.device)
    import numpy as np
    import torch
    from PIL import Image

    from ..models.latent_diffusion import ldm_schedule, make_concat_sampler
    from ..models.unet_cond import UNetCond, UNetCondConfig
    from ..models.vae import AutoencoderConfig, make_first_stage
    from ..utils.checkpoint import load_model

    ucfg, ustate = load_model(args.model_path, "unet", config_cls=UNetCondConfig, device=device)
    fcfg, fstate = load_model(args.model_path, "first_stage", config_cls=AutoencoderConfig,
                              device=device)
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
    # inpainting_big/config.yaml: linear_end 0.0205 (0.0195 elsewhere)
    sampler = make_concat_sampler(unet, ldm_schedule(linear_end=0.0205, device=device),
                                  ddim_steps=args.steps, latent_ch=ucfg.out_channels,
                                  method=args.method)

    masks = sorted(glob.glob(os.path.join(args.indir, "*_mask.png")))
    images = [m.replace("_mask.png", ".png") for m in masks]
    print(f"Found {len(masks)} inputs.")
    os.makedirs(args.outdir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    levels = len(fcfg.block_out_channels) - 1
    nonfinite = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for start in range(0, len(images), args.batch_size):
        srcs = images[start:start + args.batch_size]
        image, mask, masked = (torch.from_numpy(np.stack(a)).to(device) for a in zip(
            *[load_pair(i, m) for i, m in zip(srcs, masks[start:start + args.batch_size])]))
        # F.interpolate's default mode='nearest' (inpaint.py:77-78)
        stride = mask.shape[1] // (image.shape[1] // 2 ** levels)
        with torch.inference_mode():
            # the cond stage is the first stage (config.yaml: __is_first_stage__);
            # VQModelInterface.encode returns the pre-quantization latents
            cond = torch.cat([fs.encode(masked), mask[:, ::stride, ::stride]], dim=-1)
            lat = sampler(generator, cond)
            # decode_first_stage quantizes the sampled latents first (ddpm.py:755-756)
            pred = (fs.decode(lat, force_not_quantize=False) if fcfg.num_vq_embeddings
                    else fs.decode(lat))
            img01 = ((image + 1) / 2).clamp(0, 1)
            m01 = ((mask + 1) / 2).clamp(0, 1)
            pred01 = ((pred + 1) / 2).clamp(0, 1)
            out = ((1 - m01) * img01 + m01 * pred01).cpu().numpy()
        nonfinite += int(out.size - np.count_nonzero(np.isfinite(out)))
        for b, src in enumerate(srcs):
            path = os.path.join(args.outdir, os.path.basename(src))
            Image.fromarray((out[b] * 255).astype(np.uint8)).save(path)
            print(f"wrote {path}")
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"inpainted {len(images)} images in {dt:.2f}s ({len(images) / dt:.2f} imgs/s, "
          f"{args.method} {args.steps} steps, B={args.batch_size}, f32, {where}, wall clock)")
    if nonfinite:
        print(f"WARNING: {nonfinite} non-finite output values")
    return {"images": len(images), "nonfinite": nonfinite, "seconds": dt,
            "imgs_per_s": len(images) / dt, **counts}


if __name__ == "__main__":
    main()
