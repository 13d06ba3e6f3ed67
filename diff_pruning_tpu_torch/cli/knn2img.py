"""CLI: retrieval-augmented text-to-image sampling (counterpart of
``diff_pruning_tpu/cli/knn2img.py``; ldm_exp/scripts/knn2img.py over the RDM,
rdm768x768).

    python -m diff_pruning_tpu_torch.cli.knn2img --model_path DIR --bpe MERGES \\
        --prompt "a happy bear reading a newspaper" --database SEARCHER \\
        --use_neighbors --knn 10 --outdir OUT --device cuda

Prompt -> CLIP text embedding (normalised, (B, 1, 768)) -> with
``--use_neighbors`` the ``--knn`` nearest CLIP image embeddings of the
retrieval database appended -> CFG DDIM, PLMS or DPM-Solver++ over H/f x W/f
latents of the KL-f16 first stage (uncond: zero context of the same length,
knn2img.py:361-363) -> decode -> ``samples/%05d.png`` numbered after what the
folder holds, and ``grid-%04d.png``.

Model dir: ``unet/`` (rdm768 UNetCond) + ``first_stage/`` (kl-f16), and
``clip/`` (``config.json`` + ``params.npz``) unless ``--clip_path`` names
another or ``random``; ``--bpe`` is a local CLIP merges file
(bpe_simple_vocab_16e6, .gz or plain); ``--database`` a
``cli.train_searcher`` output. The schedule's linear_end 0.015 and
scale_factor 0.22765929 are 768x768.yaml's. ``--device cuda`` without a
GPU raises. TF32 is off (printed).
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--prompt", type=str, default="a painting of a virus monster playing guitar")
    p.add_argument("--from-file", dest="from_file", type=str, default=None)
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--clip_path", type=str, default=None,
                   help="defaults to <model_path>/clip; 'random' for smoke")
    p.add_argument("--bpe", type=str, required=True,
                   help="local CLIP merges file (bpe_simple_vocab_16e6)")
    p.add_argument("--database", type=str, default=None,
                   help="searcher dir (cli.train_searcher output)")
    p.add_argument("--use_neighbors", action="store_true")
    p.add_argument("--knn", type=int, default=10)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--dpm", action="store_true", help="DPM-Solver++(2M) (beyond reference)")
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--n_samples", type=int, default=2)
    p.add_argument("--n_iter", type=int, default=1)
    p.add_argument("--H", type=int, default=768)
    p.add_argument("--W", type=int, default=768)
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--skip_grid", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{"images", "nonfinite", "seconds", "imgs_per_s",
    "unet_params", "first_stage_params", "clip_params"}`` (seconds: the
    embedding, search, sampling and decoding, loading excluded)."""
    args = parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    device = resolve_device(args.device)
    import numpy as np
    import torch
    from PIL import Image

    from ..data.clip_tokenizer import CLIPTokenizer
    from ..models.clip import clip_text_embed
    from ..models.latent_diffusion import IdentityCondStage, LatentDiffusion
    from ..models.unet_cond import UNetCondConfig
    from ..models.vae import AutoencoderConfig, make_first_stage
    from ..utils.checkpoint import load_model
    from .train_searcher import load_clip

    ucfg, ustate = load_model(args.model_path, "unet", config_cls=UNetCondConfig, device=device)
    fcfg, fstate = load_model(args.model_path, "first_stage", config_cls=AutoencoderConfig,
                              device=device)
    clip_path = args.clip_path or os.path.join(args.model_path, "clip")
    if args.clip_path is None and not os.path.isdir(clip_path):
        print(f"WARNING: no CLIP weights at {clip_path}: falling back to a RANDOM-INIT CLIP; "
              "the samples are smoke-test output, not real samples (pass --clip_path)")
        clip_path = "random"
    clip_model = load_clip(clip_path, device=device)
    tok = CLIPTokenizer(args.bpe)
    if tok.vocab_size > clip_model.cfg.vocab_size:
        raise SystemExit(f"tokenizer vocab ({tok.vocab_size}) exceeds the CLIP text tower's "
                         f"({clip_model.cfg.vocab_size}): mismatched bpe file")

    # 768x768.yaml: scale_factor 0.22765929, linear_end 0.015, f16 latents
    ldm = LatentDiffusion(ucfg, cond_stage=IdentityCondStage(),
                          first_stage=make_first_stage(fcfg, device=device),
                          scale_factor=0.22765929, linear_end=0.015, device=device)
    ldm.unet.load_state_dict(ustate)
    ldm.first_stage.load_state_dict(fstate)
    ldm.eval()
    del ustate, fstate
    counts = {f"{name}_params": sum(p.numel() for p in m.parameters())
              for name, m in (("unet", ldm.unet), ("first_stage", ldm.first_stage),
                              ("clip", clip_model))}
    print("knn2img: " + ", ".join(f"{k[:-7]} {n:,} params" for k, n in counts.items()))
    f = 2 ** (len(fcfg.block_out_channels) - 1)

    searcher = None
    if args.use_neighbors:
        if not args.database:
            raise SystemExit("--use_neighbors needs --database (cli.train_searcher output)")
        from ..retrieval import load_searcher

        searcher = load_searcher(args.database)
    if args.from_file:
        with open(args.from_file) as fh:
            prompts = [line for line in fh.read().splitlines() if line]
    else:
        prompts = [args.prompt]

    knn = args.knn if args.use_neighbors else 0
    sampler = ldm.make_cfg_sampler(
        ddim_steps=args.ddim_steps, guidance_scale=args.scale, eta=args.ddim_eta,
        latent_hw=(args.H // f, args.W // f), latent_ch=ucfg.out_channels,
        method="dpm" if args.dpm else ("plms" if args.plms else "ddim"),
        uncond_input=np.zeros((1, 1 + knn, ucfg.context_dim), np.float32))

    sample_path = os.path.join(args.outdir, "samples")
    os.makedirs(sample_path, exist_ok=True)
    base = len(os.listdir(sample_path))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    all_rows, nonfinite = [], 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.n_iter):
        for prompt in prompts:
            tokens = torch.as_tensor(tok.tokenize([prompt] * args.n_samples,
                                                  context_length=clip_model.cfg.context_length),
                                     device=device)
            with torch.inference_mode():
                c = clip_text_embed(clip_model, tokens)  # (B, 1, D)
            if searcher is not None:
                nn = searcher(c.cpu().numpy(), args.knn)
                c = torch.cat([c, torch.as_tensor(nn["nn_embeddings"], dtype=c.dtype,
                                                  device=device)], dim=1)
            imgs = ldm.decode_first_stage(sampler(generator, c, args.n_samples)).cpu().numpy()
            nonfinite += int(imgs.size - np.count_nonzero(np.isfinite(imgs)))
            for b in range(imgs.shape[0]):
                Image.fromarray((imgs[b] * 255).astype(np.uint8)).save(
                    os.path.join(sample_path, f"{base:05}.png"))
                base += 1
            all_rows.append(imgs)
            print(f"sampled {imgs.shape[0]} for {prompt!r}")
    dt = time.perf_counter() - t0
    if not args.skip_grid and all_rows:
        grid = np.concatenate([np.concatenate(list(r), axis=1) for r in all_rows], axis=0)
        n_grids = len([name for name in os.listdir(args.outdir) if name.startswith("grid-")])
        Image.fromarray((grid * 255).astype(np.uint8)).save(
            os.path.join(args.outdir, f"grid-{n_grids:04}.png"))
    n = sum(r.shape[0] for r in all_rows)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"wrote {n} samples to {sample_path} in {dt:.2f}s ({n / dt:.2f} imgs/s, "
          f"{args.ddim_steps} steps, scale {args.scale}, knn {knn}, f32, {where}, wall clock)")
    if nonfinite:
        print(f"WARNING: {nonfinite} non-finite sample values")
    return {"images": n, "nonfinite": nonfinite, "seconds": dt, "imgs_per_s": n / dt,
            **counts}


if __name__ == "__main__":
    main()
