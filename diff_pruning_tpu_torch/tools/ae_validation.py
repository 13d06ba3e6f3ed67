"""Behavioural validation of first-stage GAN training
(``training/autoencoder.py`` + ``cli/autoencoder_train.py``) on procedural
data: the counterpart of the repository's ``tools/ae_validation.py``. No
external weights are in the repository, so it shows the training dynamics
the reference's autoencoder recipe exhibits (reconstruction loss falling,
codebook use, the discriminator engaging after disc_start, faithful
reconstructions).

Drives the autoencoder_train CLI end to end (checkpoints, metrics.jsonl)
on a small VQ codec from a seeded init, then renders input-against-
reconstruction grids from the initial and the trained weights, and prints
one JSON line of the run's figures.

    python -m diff_pruning_tpu_torch.tools.ae_validation --steps 1500 --out run/ae_val
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

from . import _runner

CLI = "diff_pruning_tpu_torch.cli."


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--out", type=str, default="run/ae_val")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--disc_start", type=int, default=500)
    ap.add_argument("--dispatch", type=int, default=25)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the CLI and the grids; 'cuda' raises when no GPU "
                         "is present")
    return ap.parse_args(argv)


def codec_config():
    """A mid-sized VQ codec (not the 55M vq-f4: the dynamics, not the scale,
    are under test)."""
    from ..models.vae import AutoencoderConfig

    return AutoencoderConfig(block_out_channels=(32, 64), layers_per_block=1,
                             latent_channels=4, norm_num_groups=16,
                             num_vq_embeddings=256, mid_block_attention=False,
                             sample_size=32)


def write_seed(seed_dir: str) -> None:
    """The codec from generator seed 0 (on the CPU) as ``<seed_dir>/first_stage``."""
    import torch

    from ..models.vae import VQModel
    from ..utils.checkpoint import save_model

    cfg = codec_config()
    save_model(seed_dir, cfg, VQModel(cfg, device="cpu").init(torch.Generator().manual_seed(0)),
               subfolder="first_stage")


def recon_grid(model, x, path: str) -> float:
    """Top row ``x``, bottom row its reconstruction through the codebook;
    writes the PNG and returns the mean |reconstruction - x|."""
    import numpy as np
    import torch
    from PIL import Image

    with torch.inference_mode():
        zq, _, _ = model.quantize_train(model.encode(x))
        r = model.decode(zq)
    xs, rs = ((x + 1) / 2).cpu().numpy(), r.clamp(-1, 1).add(1).div(2).cpu().numpy()
    grid = np.concatenate([np.concatenate(list(xs), axis=1), np.concatenate(list(rs), axis=1)])
    Image.fromarray((grid * 255).astype(np.uint8), "RGB").save(path)
    return float((r - x).abs().mean())


def run(*, steps: int = 1500, out: str = "run/ae_val", batch_size: int = 64,
        disc_start: int = 500, dispatch: int = 25, device="cuda") -> dict:
    import numpy as np
    import torch
    from PIL import Image

    from ..data.procedural import make_procedural_dataset
    from ..models.vae import VQModel
    from ..utils.checkpoint import load_params_npz

    imgs_dir = os.path.join(out, "imgs")
    os.makedirs(imgs_dir, exist_ok=True)
    data = make_procedural_dataset(2048, 32)
    for i, im in enumerate(data):
        Image.fromarray(im, "RGB").save(os.path.join(imgs_dir, f"{i:05}.png"))
    seed_root = os.path.join(out, "seed")
    write_seed(seed_root)

    run_dir = os.path.join(out, "run")
    rc, _, _ = _runner.run(os.path.join(out, "logs"), "train", [
        CLI + "autoencoder_train",
        "--model_path", seed_root,
        "--dataset", imgs_dir, "--resolution", "32",
        "--output_dir", run_dir,
        "--train_batch_size", str(batch_size),
        "--num_iters", str(steps),
        "--steps_per_dispatch", str(dispatch),
        "--disc_start", str(disc_start),
        "--log_steps", str(dispatch * 2),
        "--save_model_steps", str(steps),
        "--lpips", "random", "--base_learning_rate", "1e-5"], device=device, tag="ae_validation")
    _runner.require(rc == 0, "autoencoder_train failed:\n"
                    + _runner.tail_log(os.path.join(out, "logs"), "train"))

    device = torch.device(device)
    x = torch.from_numpy(data[:8].astype(np.float32) / 127.5 - 1.0).to(device)
    cfg = codec_config()
    grids = os.path.join(out, "grids")
    os.makedirs(grids, exist_ok=True)
    l1 = {}
    for name, params in (("init", load_params_npz(os.path.join(seed_root, "first_stage",
                                                                "params.npz"))),
                         ("trained", load_params_npz(os.path.join(run_dir, "first_stage",
                                                                   "params.npz")))):
        model = VQModel(cfg, device=device)
        model.load_state_dict(params)
        l1[name] = recon_grid(model.eval(), x, os.path.join(grids, f"recon_{name}.png"))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    report = {
        "steps": steps,
        "rec_loss_first": metrics[0]["rec_loss"],
        "rec_loss_last": metrics[-1]["rec_loss"],
        "perplexity_last": metrics[-1].get("perplexity"),
        "disc_loss_last": metrics[-1].get("disc_loss"),
        "l1_recon_init": round(l1["init"], 4),
        "l1_recon_trained": round(l1["trained"], 4),
    }
    print(json.dumps(report))
    return report


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(steps=args.steps, out=args.out, batch_size=args.batch_size,
               disc_start=args.disc_start, dispatch=args.dispatch, device=args.device)


if __name__ == "__main__":
    main()
