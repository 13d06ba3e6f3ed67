"""The LDM workflow end to end in pixel space, with a scratch-trained first
stage: the counterpart of the repository's ``tools/pixelrun.py``, on the
port's CLIs (the CompVis recipe of ldm_exp/run.sh:1-2 +
sample_for_FID.py:76-105 without downloads):

  data       class-conditional procedural dataset (8 classes whose identity
             is pixel-decodable: data/procedural.py's palette classifier)
  ae         scratch-train the vq-f4 first stage (55.3M) at 64 px
             (cli.autoencoder_train: ldm autoencoder.py's objective)
  ae_check   reconstruction PSNR + grid through the trained codec
  ldm_init   the LDM checkpoint: a class-conditional UNetCond over 16x16x3
             latents + ClassEmbedder from seed 0, and the trained codec;
             scale_factor = 1/std(z) over a data batch (the LDM std-rescaling,
             ddpm.py on_train_batch_start)
  ldm_train  train the LDM in latent space with CFG label dropout
             (cli.ldm_train)
  basesample same-seed grid + FID set, sampled with CFG DDIM and decoded to
             pixels (cli.ldm_sample)
  prune      diff-pruning at 0.3 from self-sampled CFG latents
             (cli.ldm_prune, prune_ldm.py semantics)
  finetune   latent-space finetune of the pruned UNet (cli.ldm_train)
  prunedsample  pruned grid + FID set in pixels
  eval       FID (random-init Inception; pruned and base against the data),
             same-seed SSIM base against pruned, and class consistency: the
             palette classifier must decode the requested class from the
             decoded pixels

State lives in <out>/pixelrun_state.json (the JAX driver's keys, so
``tools/pixelrun_assets.py --out <out>`` renders it); each CLI's output goes
to <out>/logs/<phase>.log. ``ae_check``, ``ldm_init`` and the class
consistency run in this process.

    python -m diff_pruning_tpu_torch.tools.pixelrun --out run/pixelrun            # the real thing
    python -m diff_pruning_tpu_torch.tools.pixelrun --out run/pixel_smoke --smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

from . import _runner

TAG = "pixelrun"
CLI = "diff_pruning_tpu_torch.cli."

# the scratch LDM's UNetCond: cross-attention class conditioning over the
# vq-f4 16x16x3 latent space (the cin256-v2 family, sized for a 64 px
# 8-class distribution instead of 256 px ImageNet)
LDM_UNET = dict(image_size=16, in_channels=3, out_channels=3,
                model_channels=128, num_res_blocks=2,
                attention_resolutions=(4, 2), channel_mult=(1, 2, 2),
                num_heads=-1, num_head_channels=32, transformer_depth=1,
                context_dim=192)
N_CLASSES = 8


@dataclasses.dataclass
class Sizes:
    n_per_class: int
    hw: int
    ae_steps: int
    ldm_steps: int
    ft_steps: int
    ipc_fid: int
    ipc_grid: int
    ddim_steps: int
    bs_ae: int
    bs_ldm: int
    bs_sample: int
    save_every: int
    log_every: int
    prune_steps: int
    prune_bs: int
    prune_ddim: int
    unet: dict


SMOKE = Sizes(24, 32, 8, 8, 8, 4, 2, 5, 8, 8, 8, 8, 4, 3, 2, 4,  # vq-f4 -> 8x8 latents
              dict(LDM_UNET, image_size=8, model_channels=32, num_head_channels=16,
                   context_dim=32, norm_num_groups=16))
FULL = Sizes(2500, 64, 8000, 20000, 10000, 256, 32, 100, 64, 64, 256, 1000, 100, 1000, 6, 20,
             LDM_UNET)  # 20k images


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="run/pixelrun")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny step counts, same phases/CLIs (with --device cpu: on the host)")
    ap.add_argument("--scale", type=float, default=3.0, help="CFG scale")
    ap.add_argument("--sparsity", type=float, default=0.3)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of every CLI; 'cuda' raises when no GPU is present")
    return ap.parse_args(argv)


def _first_stage(ae_dir: str, device):
    from ..models.vae import AutoencoderConfig, make_first_stage
    from ..utils.checkpoint import load_model

    cfg, state = load_model(ae_dir, subfolder="first_stage", config_cls=AutoencoderConfig)
    fs = make_first_stage(cfg, device=device)
    fs.load_state_dict(state)
    return fs.eval()


def _data(data_npz: str, n: int, device):
    import numpy as np
    import torch

    x = np.load(data_npz)["images"][:n].astype(np.float32) / 127.5 - 1.0
    return torch.from_numpy(x).to(device)


def ae_check(ae_dir: str, data_npz: str, out: str, device) -> dict:
    """Reconstruction MSE and PSNR ([-1, 1] range) of 64 data images through
    the trained codec; writes ``<out>/ae_recon.png`` (8 inputs over their
    reconstructions)."""
    import torch

    from ..sampling.ddim_sampler import save_image_grid

    fs = _first_stage(ae_dir, device)
    x = _data(data_npz, 64, device)
    with torch.inference_mode():
        rec = fs.decode(fs.encode(x)).float()
    mse = float(((rec - x) ** 2).mean())
    grid = torch.cat([x[:8], rec[:8]]) * 0.5 + 0.5
    save_image_grid(grid.clamp(0, 1), os.path.join(out, "ae_recon.png"), nrow=8)
    return {"recon_mse": mse, "recon_psnr": round(10 * math.log10(4.0 / mse), 2)}


def ldm_init(ae_dir: str, data_npz: str, model_dir: str, unet: dict, device) -> dict:
    """Writes the initial LDM dir: UNetCond(``unet``) and a
    ClassEmbedder(N_CLASSES + 1) from generator seed 0 (on the CPU), the
    trained codec, and scale_factor = 1 / std of the codec's latents of 256
    data images."""
    import torch

    from ..models.latent_diffusion import LatentDiffusion
    from ..models.unet_cond import UNetCondConfig
    from ..pruning.flops import count_params
    from ..utils.checkpoint import save_ldm

    fs = _first_stage(ae_dir, device)
    with torch.inference_mode():
        z = fs.encode(_data(data_npz, 256, device)).float()
    std = float(z.std())
    sf = 1.0 / std
    ldm = LatentDiffusion(UNetCondConfig(**unet), n_classes=N_CLASSES + 1,
                          first_stage=fs.cpu(), scale_factor=sf, device="cpu")
    gen = torch.Generator().manual_seed(0)
    ldm.unet.init(gen)
    ldm.cond_stage.reset_parameters(gen)
    save_ldm(model_dir, ldm)
    info = {"unet_params": count_params(ldm.unet), "scale_factor": sf, "latent_std": std}
    print(f"[{TAG}] ldm_init: {json.dumps(info)}", flush=True)
    return info


def class_consistency(sample_dir: str, ipc: int) -> dict:
    """The palette classifier on a class-major sample folder (label = index
    // ipc): {"class_acc", "n"}."""
    import glob

    import numpy as np
    from PIL import Image

    from ..data.procedural import classify_by_palette

    files = sorted(glob.glob(os.path.join(sample_dir, "*.png")))
    imgs = np.stack([np.asarray(Image.open(f)) for f in files])
    want = np.arange(len(files)) // ipc
    got = classify_by_palette(imgs, N_CLASSES)
    return {"class_acc": float((got == want).mean()), "n": len(files)}


def run(out: str, sz: Sizes, *, scale: float = 3.0, sparsity: float = 0.3,
        device="cuda") -> dict:
    """Every phase not yet in ``<out>/pixelrun_state.json``; returns the state."""
    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    logs = os.path.join(out, "logs")
    st = _runner.State(out, "pixelrun_state.json")
    data_dir = os.path.join(out, "data")
    data_npz = os.path.join(out, "data.npz")

    def sh(phase, argv):
        rc, dt, res = _runner.run(logs, phase, argv, device=device, tag=TAG)
        _runner.require(rc == 0, f"{phase} failed:\n{_runner.tail_log(logs, phase)}")
        return dt, res

    # ---- data --------------------------------------------------------------
    if not st.done("data"):
        import numpy as np

        from ..data.procedural import make_procedural_class_dataset, write_labeled_folder

        t0 = time.time()
        imgs, labels = make_procedural_class_dataset(
            n_per_class=sz.n_per_class, hw=sz.hw, n_classes=N_CLASSES, seed=0)
        write_labeled_folder(imgs, labels, data_dir)
        np.savez_compressed(data_npz, images=imgs)
        st.mark("data", n=len(imgs), hw=sz.hw, secs=round(time.time() - t0, 1))

    # ---- first-stage training (vq-f4 at this resolution) -------------------
    ae_dir = os.path.join(out, "ae")
    if not st.done("ae"):
        dt, _ = sh("ae", [
            CLI + "autoencoder_train",
            "--preset", "vq-f4", "--dataset", data_npz,
            "--resolution", str(sz.hw), "--output_dir", ae_dir,
            "--train_batch_size", str(sz.bs_ae), "--num_iters", str(sz.ae_steps),
            "--disc_start", str(sz.ae_steps + 1),  # recon-only: L1+LPIPS+VQ
            "--steps_per_dispatch", "8",
            "--save_model_steps", str(max(sz.save_every, sz.ae_steps // 4)),
            "--log_steps", str(sz.log_every)])
        st.mark("ae", steps=sz.ae_steps, secs=round(dt, 1))

    # ---- codec sanity: reconstruction PSNR + grid ---------------------------
    if not st.done("ae_check"):
        t0 = time.perf_counter()
        info = ae_check(ae_dir, data_npz, out, device)
        print(f"[{TAG}] ae_check: {json.dumps(info)}", flush=True)
        st.mark("ae_check", **info, secs=round(_runner.seconds_since(t0, device), 1))

    # ---- the initial LDM checkpoint ----------------------------------------
    ldm_init_dir = os.path.join(out, "ldm_init")
    if not st.done("ldm_init"):
        t0 = time.perf_counter()
        info = ldm_init(ae_dir, data_npz, ldm_init_dir, sz.unet, device)
        st.mark("ldm_init", **info, secs=round(_runner.seconds_since(t0, device), 1))

    # ---- LDM training (base) ------------------------------------------------
    base_dir = os.path.join(out, "ldm_base")
    if not st.done("ldm_train"):
        dt, _ = sh("ldm_train", [
            CLI + "ldm_train",
            "--model_path", ldm_init_dir, "--dataset", data_dir,
            "--output_dir", base_dir,
            "--train_batch_size", str(sz.bs_ldm), "--num_iters", str(sz.ldm_steps),
            "--learning_rate", str(2e-6 * sz.bs_ldm),
            "--uncond_prob", "0.1", "--mixed_precision", "bf16",
            "--save_model_steps", str(sz.save_every),
            "--log_steps", str(sz.log_every)])
        st.mark("ldm_train", steps=sz.ldm_steps, secs=round(dt, 1))

    def sample(phase, model_dir, outdir, ipc, seed):
        dt, _ = sh(phase, [
            CLI + "ldm_sample",
            "--model_path", model_dir, "--output_dir", outdir,
            "--ipc", str(ipc), "--num_classes", str(N_CLASSES),
            "--batch_size", str(min(sz.bs_sample, ipc)),
            "--ddim_steps", str(sz.ddim_steps), "--scale", str(scale),
            "--seed", str(seed)])
        return dt

    # ---- base samples: grid (seed 42) + FID set (seed 0), decoded to pixels --
    base_grid = os.path.join(out, "samples_base_grid")
    base_fid = os.path.join(out, "samples_base_fid")
    if not st.done("basesample"):
        dt = sample("basesample_grid", base_dir, base_grid, sz.ipc_grid, 42)
        dt += sample("basesample_fid", base_dir, base_fid, sz.ipc_fid, 0)
        st.mark("basesample", n=sz.ipc_fid * N_CLASSES, secs=round(dt, 1))

    # ---- prune (self-sampled CFG latents, prune_ldm.py semantics) -----------
    pruned_dir = os.path.join(out, "pruned")
    if not st.done("prune"):
        dt, res = sh("prune", [
            CLI + "ldm_prune",
            "--model_path", base_dir, "--save_path", pruned_dir,
            "--sparsity", str(sparsity), "--pruner", "diff-pruning",
            "--thr", "0.1", "--batch_size", str(sz.prune_bs),
            "--ddim_steps", str(sz.prune_ddim),
            "--max_steps", str(sz.prune_steps),
            "--classes", "0", "3", "5", "7"])
        st.mark("prune", secs=round(dt, 1), params_before=res["params_before"],
                params=res["params"], steps_run=res["steps_run"])

    # ---- finetune the pruned UNet -------------------------------------------
    ft_dir = os.path.join(out, "finetuned")
    if not st.done("finetune"):
        dt, _ = sh("finetune", [
            CLI + "ldm_train",
            "--model_path", pruned_dir, "--dataset", data_dir,
            "--output_dir", ft_dir,
            "--train_batch_size", str(sz.bs_ldm), "--num_iters", str(sz.ft_steps),
            "--learning_rate", str(2e-6 * sz.bs_ldm),
            "--uncond_prob", "0.1", "--mixed_precision", "bf16",
            "--save_model_steps", str(sz.save_every),
            "--log_steps", str(sz.log_every)])
        st.mark("finetune", steps=sz.ft_steps, secs=round(dt, 1))

    # ---- pruned samples ------------------------------------------------------
    pr_grid = os.path.join(out, "samples_pruned_grid")
    pr_fid = os.path.join(out, "samples_pruned_fid")
    if not st.done("prunedsample"):
        dt = sample("prunedsample_grid", ft_dir, pr_grid, sz.ipc_grid, 42)
        dt += sample("prunedsample_fid", ft_dir, pr_fid, sz.ipc_fid, 0)
        st.mark("prunedsample", n=sz.ipc_fid * N_CLASSES, secs=round(dt, 1))

    # ---- eval ----------------------------------------------------------------
    if not st.done("eval"):
        evals = {}
        for tag, d in (("fid_base_vs_data", base_fid), ("fid_pruned_vs_data", pr_fid)):
            _, fid = sh(tag, [CLI + "fid_score", d, data_npz,
                              "--random-init-seed", "0", "--batch-size", "256"])
            evals[tag] = float(fid)
        _, res = sh("ssim", [CLI + "compute_ssim", base_grid, pr_grid])
        evals.update(sameseed_ssim=res["ssim"], sameseed_mse=res["mse"])
        for tag, d in (("base", base_fid), ("pruned", pr_fid)):
            cc = class_consistency(d, sz.ipc_fid)
            print(f"[{TAG}] class consistency {tag}: {json.dumps(cc)}", flush=True)
            evals[f"class_acc_{tag}"] = cc["class_acc"]
        st.mark("eval", **evals)

    print("[pixelrun] COMPLETE")
    print(json.dumps(st.d, indent=1))
    return st.d


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(args.out, SMOKE if args.smoke else FULL, scale=args.scale,
               sparsity=args.sparsity, device=args.device)


if __name__ == "__main__":
    main()
