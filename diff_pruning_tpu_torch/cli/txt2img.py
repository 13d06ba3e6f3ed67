"""CLI: text-to-image sampling (counterpart of ``diff_pruning_tpu/cli/txt2img.py``;
ldm_exp/scripts/txt2img.py).

    python -m diff_pruning_tpu_torch.cli.txt2img --model_path DIR --vocab VOCAB.txt \\
        --prompt "a painting of a virus monster playing guitar" --ddim_steps 200 \\
        --n_samples 4 --scale 5.0 --outdir OUT --device cuda

Prompt -> WordPiece tokens -> BERTEmbedder context -> CFG DDIM, PLMS or
DPM-Solver++ over H/8 x W/8 latents -> the KL first stage's decode -> PNGs
(``samples/%06d.png``) and ``grid.png``. The uncond rows are the empty
prompt's conditioning, as in the reference (txt2img.py:133).

Model dir: ``unet/`` and ``cond_stage/`` (``config.json`` + ``params.npz``)
and an optional ``first_stage/`` (KL), in the JAX package's layout; without
``--model_path`` every part is a random init from ``--seed`` (no first
stage: the latents are mapped from [-1, 1] and written as images).
``--vocab`` is the bert-base-uncased vocab.txt (30,522 lines). ``--device
cuda`` without a GPU raises: the CLI never carries on on the CPU. TF32 is
off for matmuls and convolutions (printed at the start).
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--prompt", type=str, default="a painting of a virus monster playing guitar")
    p.add_argument("--outdir", type=str, default="outputs/txt2img-samples")
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint dir; random init when omitted (smoke)")
    p.add_argument("--vocab", type=str, required=True,
                   help="path to bert-base-uncased vocab.txt")
    p.add_argument("--ddim_steps", type=int, default=200)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--dpm", action="store_true", help="DPM-Solver++(2M) (beyond reference)")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--n_iter", type=int, default=1)
    p.add_argument("--H", type=int, default=256)
    p.add_argument("--W", type=int, default=256)
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def load_txt2img(model_path, seed=0, *, device):
    """LatentDiffusion with a BERTEmbedder cond stage (and an optional KL
    first stage) from the (config.json, params.npz) layout, or a random init
    from ``seed`` without ``model_path``; the txt2img-1p4B-eval.yaml schedule
    and scale factor. Weights load strictly."""
    import torch

    from ..models.latent_diffusion import LatentDiffusion
    from ..models.text_encoder import BERTEmbedder, BERTEmbedderConfig, bert_txt2img_config
    from ..models.unet_cond import UNetCondConfig, txt2img_1p4B_config
    from ..models.vae import AutoencoderConfig, AutoencoderKL
    from ..utils.checkpoint import load_params_npz

    def path(*parts):
        return os.path.join(model_path, *parts)

    if model_path and os.path.exists(path("unet", "config.json")):
        with open(path("unet", "config.json")) as f:
            ucfg = UNetCondConfig.from_json(f.read())
        with open(path("cond_stage", "config.json")) as f:
            bcfg = BERTEmbedderConfig.from_json(f.read())
    else:
        ucfg, bcfg = txt2img_1p4B_config(), bert_txt2img_config()
    state = first_stage = None
    if model_path:
        state = {"unet": load_params_npz(path("unet", "params.npz"), device),
                 "cond_stage": load_params_npz(path("cond_stage", "params.npz"), device)}
        if os.path.exists(path("first_stage", "params.npz")):
            with open(path("first_stage", "config.json")) as f:
                first_stage = AutoencoderKL(AutoencoderConfig.from_json(f.read()), device=device)
            state["first_stage"] = load_params_npz(path("first_stage", "params.npz"), device)
    ldm = LatentDiffusion(ucfg, cond_stage=BERTEmbedder(bcfg, device=device),
                          first_stage=first_stage, linear_start=0.00085, linear_end=0.012,
                          scale_factor=0.18215, device=device)
    if state is None:
        ldm.init(torch.Generator(device=device).manual_seed(seed))
    else:
        for name in list(state):
            getattr(ldm, name).load_state_dict(state.pop(name))
    return ldm.eval()


def main(argv=None) -> dict:
    """Returns ``{"images", "nonfinite", "seconds", "imgs_per_s", "params"}``
    (seconds: the sampling and decoding, loading excluded; params: each
    part's count)."""
    args = parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    device = resolve_device(args.device)
    import numpy as np
    import torch

    from ..data.tokenizer import BERTTokenizer
    from ..sampling.ddim_sampler import save_image_grid, save_images

    ldm = load_txt2img(args.model_path, args.seed, device=device)
    params = {name: sum(p.numel() for p in part.parameters())
              for name, part in ldm.named_children()}
    print("txt2img: " + ", ".join(f"{name} {n:,} params" for name, n in params.items()))
    enc = ldm.cond_stage
    tok = BERTTokenizer(args.vocab, max_length=enc.cfg.max_seq_len)
    if tok.vocab_size > enc.cfg.vocab_size:
        # an id past the embedding table would raise mid-run (on the card, a
        # device-side assert): refuse the mismatched vocab up front
        raise SystemExit(f"vocab file has {tok.vocab_size} tokens but the text encoder embeds "
                         f"{enc.cfg.vocab_size}")
    sampler = ldm.make_cfg_sampler(
        ddim_steps=args.ddim_steps, guidance_scale=args.scale, eta=args.ddim_eta,
        latent_hw=(args.H // 8, args.W // 8), latent_ch=ldm.unet.cfg.in_channels,
        method="dpm" if args.dpm else ("plms" if args.plms else "ddim"),
        uncond_input=tok([""]))
    if ldm.first_stage is not None:
        decode = ldm.decode_first_stage
    else:
        def decode(lat):
            return (lat * 0.5 + 0.5).clamp(0.0, 1.0)

    os.makedirs(args.outdir, exist_ok=True)
    tokens = torch.as_tensor(np.repeat(tok([args.prompt]), args.n_samples, axis=0),
                             device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    all_imgs = []
    for it in range(args.n_iter):
        imgs = decode(sampler(generator, tokens, args.n_samples)).cpu().numpy()
        save_images(imgs, os.path.join(args.outdir, "samples"), start_index=it * args.n_samples)
        all_imgs.append(imgs)
    dt = time.perf_counter() - t0
    grid = np.concatenate(all_imgs, axis=0)
    save_image_grid(grid, os.path.join(args.outdir, "grid.png"), nrow=args.n_samples)
    nonfinite = int(grid.size - np.count_nonzero(np.isfinite(grid)))
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"wrote {len(grid)} samples for {args.prompt!r} to {args.outdir} in {dt:.2f}s "
          f"({len(grid) / dt:.2f} imgs/s, {args.ddim_steps} steps, scale {args.scale}, f32, "
          f"{where}, wall clock)")
    if nonfinite:
        print(f"WARNING: {nonfinite} non-finite sample values")
    return {"images": len(grid), "nonfinite": nonfinite, "seconds": dt,
            "imgs_per_s": len(grid) / dt, "params": params}


if __name__ == "__main__":
    main()
