"""CLI: convert checkpoints into the ``(config.json, params.npz)`` layout that both
packages load (counterpart of the JAX package's ``tools/convert_checkpoints.py``).

    python -m diff_pruning_tpu_torch.cli.convert_checkpoints KIND SRC DST [options]

    diffusers         <hf_model_dir> <out_dir>   # a diffusers UNet2DModel dir -> out_dir/unet
    export-diffusers  <model_dir> <out_dir>      # our layout -> a diffusers save_pretrained dir
    ddim              <ckpt.pth> <out_dir> --config cifar10|celeba|lsun   # ermongroup DDIM
    compvis           <model.ckpt> <out_dir> [--config cin256-v2|txt2img-1p4B|inpainting_big]
    first-stage       <model.ckpt> <out_dir>     # a CompVis kl-f*/vq-f* autoencoder
    inception         <pt_inception.pth> <out.npz>
    lpips             <vgg16.pth> <out.npz> --lin <vgg_lpips.ckpt>
    clip              <ViT-L-14.pt> <out_dir>    # OpenAI CLIP (TorchScript or a state dict)

Every kind writes what the JAX tool writes, array for array
(``utils/convert.py``); each model is checked against the port's module of
its config (keys, shapes and the channel graph) before it is saved.
``export-diffusers`` keeps ``channel_sizes`` in ``unet/config.json``, so a
pruned model round-trips through ``diffusers``. The ``.ckpt`` of ``compvis``
and ``first-stage`` are Lightning pickles, loaded with ``weights_only=False``:
convert only files you trust.
"""

from __future__ import annotations

import argparse
import os


def _validate(model, state_dict) -> None:
    """Raises ValueError unless ``state_dict`` has exactly ``model``'s keys and
    shapes and its channel graph holds on them."""
    from ..pruning.surgery import unflatten_params
    from ..utils.checkpoint import flat_from_state_dict

    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    if want != got:
        missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        shapes = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"state dict does not fit {type(model).__name__}: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}, shapes differ at {shapes[:5]}")
    model.graph.validate(unflatten_params(flat_from_state_dict(state_dict)))


def _write_first_stage(sd, dst: str, resolution: int) -> None:
    """A CompVis first-stage state dict (a kl-f*/vq-f* ``model.ckpt``, or the
    ``first_stage_model.*`` slice of an LDM) -> ``dst/first_stage``."""
    from ..models.vae import make_first_stage
    from ..utils.checkpoint import save_model
    from ..utils.convert import compvis_vae_state_dict_to_params, infer_compvis_vae_config

    cfg = infer_compvis_vae_config(sd, resolution=resolution)
    state = compvis_vae_state_dict_to_params(sd, num_levels=len(cfg.block_out_channels))
    _validate(make_first_stage(cfg, device="meta"), state)
    save_model(dst, cfg, state, subfolder="first_stage")


def _inception_flat(sd) -> dict:
    """A pt_inception state dict -> the JAX-layout flat arrays the JAX tool
    writes (``Block[/branch]/kernel`` HWIO, ``bn_scale``/``bn_bias``/
    ``bn_mean``/``bn_var``; ``fc/kernel`` (in, out) and ``fc/bias``; AuxLogits
    and the BN batch counters dropped)."""
    import numpy as np

    bn = {"weight": "bn_scale", "bias": "bn_bias", "running_mean": "bn_mean",
          "running_var": "bn_var"}
    flat = {}
    for name, t in sd.items():
        arr = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)
        parts = name.split(".")
        if parts[0] == "AuxLogits" or parts[-1] == "num_batches_tracked":
            continue
        if parts[0] == "fc":
            flat["fc/kernel" if parts[1] == "weight" else "fc/bias"] = (
                arr.T if parts[1] == "weight" else arr)
            continue
        *path, kind, leaf = parts
        if kind == "conv" and leaf == "weight":
            flat["/".join(path + ["kernel"])] = arr.transpose(2, 3, 1, 0)
        elif kind == "bn" and leaf in bn:
            flat["/".join(path + [bn[leaf]])] = arr
    return flat


def main(argv=None) -> str:
    """Returns the path written."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("kind", choices=["diffusers", "export-diffusers", "ddim", "compvis",
                                    "first-stage", "inception", "lpips", "clip"])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--config", default="cifar10",
                   choices=["cifar10", "celeba", "lsun",            # ddim kind
                            "cin256-v2", "txt2img-1p4B",            # compvis kind
                            "inpainting_big"])
    p.add_argument("--lin", default=None,
                   help="lpips kind: taming's vgg_lpips lin-head checkpoint")
    p.add_argument("--pipeline", default="DDPMPipeline", choices=["DDPMPipeline", "DDIMPipeline"],
                   help="export-diffusers kind: model_index.json's class")
    p.add_argument("--scheduler", default="DDPMScheduler",
                   choices=["DDPMScheduler", "DDIMScheduler"],
                   help="export-diffusers kind: the scheduler config's class")
    p.add_argument("--resolution", type=int, default=256,
                   help="first-stage and compvis kinds: the training resolution (256 for every "
                        "zoo model), which fixes attn_resolutions")
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if args.kind == "diffusers":
        from ..models.unet2d import UNet2D, UNet2DConfig
        from ..utils.checkpoint import save_model
        from ..utils.convert import load_diffusers_unet_checkpoint

        d = os.path.join(args.src, "unet") if os.path.isdir(os.path.join(args.src, "unet")) \
            else args.src
        with open(os.path.join(d, "config.json")) as f:
            cfg = UNet2DConfig.from_json(f.read())
        state = load_diffusers_unet_checkpoint(d)
        _validate(UNet2D(cfg, device="meta"), state)
        save_model(args.dst, cfg, state)
        out = os.path.join(args.dst, "unet")

    elif args.kind == "export-diffusers":
        from .ddpm_prune import load_unet
        from ..utils.convert import export_diffusers_pipeline

        cfg, state = load_unet(args.src)
        export_diffusers_pipeline(args.dst, cfg, state, pipeline_class=args.pipeline,
                                  scheduler_class=args.scheduler)
        out = args.dst

    elif args.kind == "ddim":
        from ..models.unet2d import (UNet2D, ddpm_celeba64_config, ddpm_cifar10_config,
                                     ddpm_lsun256_config)
        from ..utils.checkpoint import save_model
        from ..utils.convert import ddim_original_state_dict_to_params

        cfg = {"cifar10": ddpm_cifar10_config, "celeba": ddpm_celeba64_config,
               "lsun": ddpm_lsun256_config}[args.config]()
        sd = torch.load(args.src, map_location="cpu", weights_only=True)
        if isinstance(sd, (list, tuple)):  # [model, optimizer, epoch, step, ema]
            sd = sd[-1] if isinstance(sd[-1], dict) else sd[0]
        sd = {k.replace("module.", ""): v for k, v in sd.items()}
        state = ddim_original_state_dict_to_params(sd, num_levels=len(cfg.block_out_channels))
        _validate(UNet2D(cfg, device="meta"), state)
        save_model(args.dst, cfg, state)
        out = os.path.join(args.dst, "unet")

    elif args.kind == "compvis":
        from ..models.unet_cond import (UNetCond, cin256_v2_config, inpainting_big_config,
                                        txt2img_1p4B_config)
        from ..utils.checkpoint import save_model, save_params_npz
        from ..utils.convert import ldm_unet_state_dict_to_params

        pl_sd = torch.load(args.src, map_location="cpu", weights_only=False)
        sd = pl_sd.get("state_dict", pl_sd)
        prefix = "model.diffusion_model."
        unet_sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        cfg = {"txt2img-1p4B": txt2img_1p4B_config,
               "inpainting_big": inpainting_big_config}.get(args.config, cin256_v2_config)()
        model = UNetCond(cfg, device="meta")
        # attn_heads splits the fused, head-interleaved qkv of AttentionBlocks
        state = ldm_unet_state_dict_to_params(unet_sd, attn_heads=model.attn_heads)
        _validate(model, state)
        save_model(args.dst, cfg, state)
        cond = {k: v for k, v in sd.items() if k.startswith("cond_stage_model.")}
        tprefix = "cond_stage_model.transformer."
        if any(k.startswith(tprefix) for k in cond):  # the BERTEmbedder of txt2img-1p4B
            from ..models.text_encoder import BERTEmbedder, bert_txt2img_config
            from ..utils.convert import bert_embedder_state_dict_to_params

            bcfg = bert_txt2img_config()
            bstate = bert_embedder_state_dict_to_params(
                {k[len(tprefix):]: v for k, v in cond.items() if k.startswith(tprefix)})
            _validate(BERTEmbedder(bcfg, device="meta"), bstate)
            save_model(args.dst, bcfg, bstate, subfolder="cond_stage")
        elif "cond_stage_model.embedding.weight" in cond:  # the ClassEmbedder of cin256-v2
            os.makedirs(os.path.join(args.dst, "cond_stage"), exist_ok=True)
            w = cond["cond_stage_model.embedding.weight"]
            save_params_npz(os.path.join(args.dst, "cond_stage", "params.npz"),
                            {"embedding.weight": torch.as_tensor(np.asarray(w))})
        fprefix = "first_stage_model."
        fs = {k[len(fprefix):]: v for k, v in sd.items() if k.startswith(fprefix)}
        if fs:
            _write_first_stage(fs, args.dst, args.resolution)
        out = args.dst

    elif args.kind == "first-stage":
        pl_sd = torch.load(args.src, map_location="cpu", weights_only=False)
        _write_first_stage(pl_sd.get("state_dict", pl_sd), args.dst, args.resolution)
        out = os.path.join(args.dst, "first_stage")

    elif args.kind == "inception":
        sd = torch.load(args.src, map_location="cpu", weights_only=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.dst)), exist_ok=True)
        np.savez(args.dst, **_inception_flat(sd))
        out = args.dst

    elif args.kind == "lpips":
        from ..eval.lpips import torch_lpips_state_dicts_to_params
        from ..utils.checkpoint import save_params_npz

        if not args.lin:
            p.error("the lpips kind needs --lin <vgg_lpips.ckpt> (taming's lin-head checkpoint)")
        vgg_sd = torch.load(args.src, map_location="cpu", weights_only=True)
        lin_sd = torch.load(args.lin, map_location="cpu", weights_only=True)
        save_params_npz(args.dst, torch_lpips_state_dicts_to_params(
            vgg_sd, lin_sd.get("state_dict", lin_sd)))
        out = args.dst

    else:  # clip
        from ..models.clip import CLIP, clip_vit_l14_config, openai_clip_state_dict_to_params
        from ..utils.checkpoint import save_model

        # OpenAI's clip.load reads a TorchScript archive; a plain state dict works too
        try:
            sd = torch.jit.load(args.src, map_location="cpu").state_dict()
        except RuntimeError:
            sd = torch.load(args.src, map_location="cpu", weights_only=True)
            sd = sd.get("state_dict", sd)
        cfg = clip_vit_l14_config()
        state = openai_clip_state_dict_to_params(sd)
        _validate(CLIP(cfg, device="meta"), state)
        save_model(args.dst, cfg, state, subfolder="")
        out = args.dst
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
