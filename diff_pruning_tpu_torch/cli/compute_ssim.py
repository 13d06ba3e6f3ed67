"""CLI: pairwise SSIM and MSE between two sample folders (counterpart of
``diff_pruning_tpu/cli/compute_ssim.py``, the paper's same-seed consistency
metric, ddpm_exp/compute_ssim.py).

    python -m diff_pruning_tpu_torch.cli.compute_ssim DIR1 DIR2 [--batch-size 256] \\
        [--device cuda]

Compares the same-named images of the two folders. ``--device cuda`` (the
default) without a GPU raises: the CLI never carries on on the CPU. TF32 is
off (printed at the start).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dir1")
    p.add_argument("dir2")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{"ssim", "mse"}``."""
    args = parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    device = resolve_device(args.device)
    from ..eval.ssim import pairwise_ssim_mse

    s, m = pairwise_ssim_mse(args.dir1, args.dir2, batch_size=args.batch_size, device=device)
    print(f"SSIM: {s:.6f}")
    print(f"MSE: {m:.6f}")
    return {"ssim": s, "mse": m}


if __name__ == "__main__":
    main()
