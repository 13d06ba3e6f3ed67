"""CLI: one-shot prune, then finetune: the ``simple_cifar_our.sh`` pipeline
(counterpart of ``diff_pruning_tpu/cli/prune_finetune.py``;
ddpm_exp/finetune_simple.py: prune with the Diff-Pruning sweep, then train).

    python -m diff_pruning_tpu_torch.cli.prune_finetune \\
        --model_path run/cifar10_base --dataset data.npz \\
        --output_dir run/cifar10_T005 --thr 0.05 --pruning_ratio 0.3

Runs ``cli/ddpm_prune.py`` into ``<output_dir>/pruned``, then
``cli/ddpm_train.py`` on that checkpoint into ``<output_dir>``. The
canonical CIFAR hyperparameters are the defaults
(scripts/finetune_ddpm_cifar10.sh: B = 128, 100k iterations, lr 2e-4, EMA
0.9999, dropout 0.1, bf16). ``--device`` goes to both; ``cuda`` (the
default) without a GPU raises.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--pruning_ratio", type=float, default=0.3)
    p.add_argument("--pruner", type=str, default="diff-pruning")
    p.add_argument("--thr", type=float, default=0.05)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_iters", type=int, default=100_000)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--mixed_precision", type=str, default="bf16")
    p.add_argument("--kd", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prune_args", type=str, default="",
                   help="extra args forwarded to ddpm_prune")
    p.add_argument("--train_args", type=str, default="",
                   help="extra args forwarded to ddpm_train")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of both steps; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{"prune": <ddpm_prune's result>, "train": <ddpm_train's>}``."""
    args = parse_args(argv)
    from . import ddpm_prune, ddpm_train

    pruned_dir = os.path.join(args.output_dir, "pruned")
    prune_argv = [
        "--model_path", args.model_path,
        "--save_path", pruned_dir,
        "--pruning_ratio", str(args.pruning_ratio),
        "--pruner", args.pruner,
        "--thr", str(args.thr),
        "--dataset", args.dataset,
        "--batch_size", str(args.batch_size),
        "--seed", str(args.seed),
        "--device", args.device,
    ] + args.prune_args.split()
    print(f"[prune_finetune] pruning -> {pruned_dir}")
    pruned = ddpm_prune.main(prune_argv)

    train_argv = [
        "--model_path", pruned_dir,
        "--dataset", args.dataset,
        "--output_dir", args.output_dir,
        "--train_batch_size", str(args.batch_size),
        "--num_iters", str(args.num_iters),
        "--learning_rate", str(args.learning_rate),
        "--dropout", str(args.dropout),
        "--mixed_precision", args.mixed_precision,
        "--seed", str(args.seed),
        "--device", args.device,
    ] + (["--kd", "--teacher_path", args.model_path] if args.kd else []) \
      + args.train_args.split()
    print(f"[prune_finetune] finetuning -> {args.output_dir}")
    trained = ddpm_train.main(train_argv)
    return {"prune": pruned, "train": trained}


if __name__ == "__main__":
    main()
