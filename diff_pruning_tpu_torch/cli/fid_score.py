"""CLI: FID between two paths (counterpart of ``diff_pruning_tpu/cli/fid_score.py``).

    python -m diff_pruning_tpu_torch.cli.fid_score path1 path2 [--save-stats] \\
        [--clean] [--random-init-seed S] [--device cuda]

Paths may be image dirs, dataset names (cifar10), or .npz stats files.
Needs local FID Inception weights (eval/inception.py: a pt_inception
``.pth`` or a JAX-converted ``.npz``; nothing is downloaded), or
``--random-init-seed``. ``--device cuda`` without a GPU raises: the CLI
never carries on on the CPU. TF32 is off for matmuls and convolutions
(printed at the start).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("path", nargs=2)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--res", type=int, default=None, help="resize/crop images first")
    p.add_argument("--inception-weights", type=str, default=None)
    p.add_argument("--save-stats", action="store_true",
                   help="treat path2 as the output .npz for path1's statistics")
    p.add_argument("--clean", action="store_true",
                   help="clean-fid preprocessing (antialiased PIL-bicubic "
                        "resize) — the reference calc_fid.py variant")
    p.add_argument("--random-init-seed", type=int, default=None,
                   help="use a fixed-seed RANDOM-init inception instead of "
                        "the pt_inception weights (when no weights are at "
                        "hand): a deterministic relative two-sample distance, "
                        "NOT comparable to published FID numbers")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def main(argv=None):
    """Prints ``FID:  <value>`` and returns the value; with ``--save-stats``
    writes path2 and returns None."""
    args = parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    device = resolve_device(args.device)
    from ..eval.fid import fid_between_paths, save_stats, statistics_of_path
    from ..eval.inception import (fid_inception, load_fid_inception_state_dict,
                                  random_init_fid_inception_state_dict)

    # an explicit --random-init-seed wins over weights found on disk, so the
    # score stays comparable with scores computed where no weights exist
    if args.random_init_seed is not None:
        print(f"NOTE: random-init inception (seed={args.random_init_seed}) — "
              "relative distance only, not comparable to published FID")
        state = random_init_fid_inception_state_dict(args.random_init_seed)
    else:
        state = load_fid_inception_state_dict(args.inception_weights)
    if state is None:
        raise SystemExit(
            "FID inception weights not found locally. Provide --inception-weights "
            "(pt_inception-2015-12-05-6726825d.pth or converted .npz); nothing is "
            "downloaded.")
    model = fid_inception(state, device)
    mode = "clean" if args.clean else "torch"
    if args.save_stats:
        mu, sigma = statistics_of_path(args.path[0], model, batch_size=args.batch_size,
                                       resolution=args.res, resize_mode=mode)
        save_stats(args.path[1], mu, sigma, resize_mode=mode)
        print(f"saved stats to {args.path[1]}")
        return None

    fid = fid_between_paths(args.path[0], args.path[1], model, batch_size=args.batch_size,
                            resolution=args.res, resize_mode=mode)
    print("FID: ", fid)
    return fid


if __name__ == "__main__":
    main()
