"""CLI: build and save a retrieval searcher (counterpart of
``diff_pruning_tpu/cli/train_searcher.py``; ldm_exp/scripts/train_searcher.py).

    python -m diff_pruning_tpu_torch.cli.train_searcher --images DIR \\
        --clip_path CLIP_DIR|random --target_path OUT --device cuda

Two modes:
  --database <dir>   load a reference-schema npz datapool (single or
                     multi-file) and persist it for the exact searcher.
  --images <dir>     embed a local image folder with the CLIP vision tower
                     into a new database first.

The reference trains a scaNN index here; the port's searcher is exact
(``retrieval.py``), so "training" is persisting the database as
``OUT/database.npz``. ``--clip_path`` is a CLIP dir (``config.json`` +
``params.npz``, either package's layout) or ``random`` (ViT-L/14 from seed
0). ``--device cuda`` without a GPU raises. TF32 is off (printed).
"""

from __future__ import annotations

import argparse
import glob
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--database", "-d", type=str, default=None,
                   help="folder with the npz clip-feature datapool")
    p.add_argument("--images", type=str, default=None,
                   help="image folder to embed into a new database")
    p.add_argument("--clip_path", type=str, default=None,
                   help="CLIP dir (config.json + params.npz); 'random' for a weightless "
                        "smoke run")
    p.add_argument("--target_path", "-t", type=str, required=True)
    p.add_argument("--knn", "-k", type=int, default=20,
                   help="accepted for flag parity; the exact searcher needs no per-k tuning")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def load_clip(clip_path, *, device):
    """CLIP from a ``config.json`` + ``params.npz`` dir, or ViT-L/14 from
    seed 0 for ``None`` / ``'random'``; in eval mode on ``device``."""
    import torch

    from ..models.clip import CLIP, CLIPConfig, clip_vit_l14_config
    from ..utils.checkpoint import load_model

    if clip_path in (None, "random"):
        model = CLIP(clip_vit_l14_config(), device=device)
        return model.init(torch.Generator(device=device).manual_seed(0)).eval()
    cfg, state = load_model(clip_path, "", config_cls=CLIPConfig, device=device)
    model = CLIP(cfg, device=device)
    model.load_state_dict(state)
    return model.eval()


def main(argv=None) -> dict:
    """Returns ``{"entries", "seconds"}``."""
    import time

    args = parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    device = resolve_device(args.device)
    from ..retrieval import build_database, load_datapool, save_searcher

    t0 = time.perf_counter()
    if args.database:
        pool = load_datapool(args.database)
    elif args.images:
        files = sorted(f for ext in ("png", "jpg", "jpeg", "webp")
                       for f in glob.glob(os.path.join(args.images, f"*.{ext}")))
        if not files:
            raise SystemExit(f"no images under {args.images}")
        model = load_clip(args.clip_path, device=device)
        print(f"embedding {len(files)} images with CLIP "
              f"({'random init' if args.clip_path in (None, 'random') else args.clip_path})")
        pool = build_database(model, files, batch_size=args.batch_size)
    else:
        raise SystemExit("need --database or --images")
    save_searcher(pool, args.target_path)
    n = pool["embedding"].shape[0]
    print(f"saved searcher database ({n} entries) under {args.target_path}")
    return {"entries": n, "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
