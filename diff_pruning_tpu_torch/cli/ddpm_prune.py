"""CLI: prune a DDPM UNet (counterpart of ``diff_pruning_tpu/cli/ddpm_prune.py``).

    python -m diff_pruning_tpu_torch.cli.ddpm_prune \\
        --model_path <dir-with-unet-checkpoint> --save_path run/pruned \\
        --pruning_ratio 0.3 --pruner diff-pruning --thr 0.05 --dataset data.npz

Loads a ``(config.json, params.npz)`` checkpoint, accumulates Taylor grads
over a prefix of timesteps (``diffpruning/sweep.py``: forward and backward
through the port's GroupNorm and attention kernels on the card), scores and
selects channels (``pruning/``), slices the weights, and writes the pruned
``(config.json, params.npz)`` checkpoint, which both packages load, plus
``vis/after_pruning.png``. Prints the JAX CLI's ``#Params`` and ``#MACS``
lines.

Differences from the JAX CLI:
* the sweep is one host loop (the JAX package's on-device ``lax.while_loop``
  exists to avoid TPU round-trips); ``--host_loop`` is accepted and changes
  nothing;
* ``--cost_aware``/``--match_params`` raise (the cost model, the JAX
  package's ``pruning/cost.py``, is not ported yet); there are no multihost
  flags and no diffusers-directory loading yet;
* the data is a local ``.npz`` or CIFAR-10 batch directory
  (``data/datasets.py``), or the model's own samples
  (``--use_generated_samples``); the sweep noise comes from a
  ``torch.Generator`` seeded by ``--seed``.
``--device cuda`` (the default) without a GPU raises: the CLI never carries
on on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

GRAD_PRUNERS = ("taylor", "diff-pruning", "fisher", "first_order_taylor",
                "second_order_taylor")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", type=str, default=None,
                   help="a .npz of uint8 NHWC images | a CIFAR-10 batch directory | cifar10")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--pruning_ratio", type=float, default=0.3)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--pruner", type=str, default="taylor",
                   choices=["taylor", "random", "magnitude", "reinit", "diff-pruning",
                            "fisher", "first_order_taylor", "second_order_taylor"])
    p.add_argument("--thr", type=float, default=0.05, help="threshold for diff-pruning")
    p.add_argument("--max_steps", type=int, default=None,
                   help="cap the Taylor sweep (default: num_train_timesteps)")
    p.add_argument("--host_loop", action="store_true",
                   help="accepted for the JAX CLI's flags; the sweep here is always "
                        "one host loop")
    p.add_argument("--global_pruning", action="store_true")
    p.add_argument("--normalizer", type=str, default=None,
                   choices=["sum", "mean", "max", "standarization", "gaussian"],
                   help="per-group score normalizer "
                        "(torch_pruning importance.py:25-40); affects only "
                        "--global_pruning rankings (default: mean)")
    p.add_argument("--cost_aware", type=str, default=None,
                   choices=["macs", "bytes", "hybrid"],
                   help="not ported yet (needs the cost model): raises")
    p.add_argument("--match_params", action="store_true",
                   help="with --cost_aware; not ported yet: raises")
    p.add_argument("--max_sparsity", type=float, default=1.0,
                   help="cap any single var's drop fraction in global mode "
                        "(metapruner.py:172-194)")
    p.add_argument("--use_generated_samples", action="store_true",
                   help="accumulate Taylor grads on the model's OWN samples "
                        "instead of dataset images "
                        "(ddpm_exp/prune_test.py:230-237); no --dataset needed")
    p.add_argument("--gen_ddim_steps", type=int, default=100,
                   help="DDIM steps used to draw the generated samples")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip_vis", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def load_unet(model_path: str):
    """Load ``(config, state_dict)`` from our layout: ``<path>/unet/params.npz``
    or ``<path>/params.npz``, each beside a ``config.json``.

    A diffusers directory (``diffusion_pytorch_model.bin``) is not read yet:
    that waits for the port of ``utils/convert.py``.
    """
    from ..utils.checkpoint import load_model

    for sub in ("unet", ""):
        if os.path.exists(os.path.join(model_path, sub, "params.npz")):
            return load_model(model_path, subfolder=sub)
    for sub in ("unet", ""):
        if os.path.exists(os.path.join(model_path, sub, "config.json")):
            raise NotImplementedError(
                f"{model_path}: diffusers-format checkpoints load once utils/convert.py "
                "is ported; convert with the JAX package's tools/convert_checkpoints.py")
    raise FileNotFoundError(f"no UNet checkpoint under {model_path}")


def main(argv=None) -> dict:
    """Returns ``{"params_before", "params", "macs_before", "macs", "steps_run",
    "sweep_seconds", "channel_sizes"}`` (``steps_run`` 0 when no sweep ran)."""
    args = parse_args(argv)
    if args.cost_aware or args.match_params:
        raise NotImplementedError(
            "--cost_aware/--match_params need the cost model (pruning/cost.py), which "
            "the port has not ported yet (ROADMAP queue 1, item 7)")
    from .ddpm_sample import resolve_device

    device = resolve_device(args.device)
    import torch

    from ..diffpruning.sweep import accumulate_taylor_grads
    from ..models.unet2d import UNet2D
    from ..pruning.flops import count_ops_and_params
    from ..pruning.importance import make_importance
    from ..pruning.pruner import apply_pruning, prune
    from ..pruning.surgery import flatten_params, unflatten_params
    from ..sampling.ddim_sampler import SamplerConfig, make_sampler, save_image_grid
    from ..schedulers.ddpm import DiffusionSchedule
    from ..utils.checkpoint import (flat_from_state_dict, flat_grads, save_model,
                                    state_dict_from_flat)

    cfg, state = load_unet(args.model_path)
    model = UNet2D(cfg, device=device)
    model.load_state_dict(state)
    params = unflatten_params(flat_from_state_dict(model.state_dict()))
    model.graph.validate(params)
    schedule = DiffusionSchedule.create(device=device)
    hw = cfg.sample_size or 32
    sample_shape = (1, hw, hw, cfg.in_channels)
    base_macs, base_params = count_ops_and_params(model, sample_shape)
    stats = {"params_before": base_params, "macs_before": base_macs, "steps_run": 0,
             "sweep_seconds": 0.0}

    if args.pruning_ratio > 0:
        grads = None
        if args.pruner in GRAD_PRUNERS:
            if args.use_generated_samples:
                # Taylor grads on the model's own samples
                # (ddpm_exp/prune_test.py:230-237), kept in the model's [-1, 1]
                # domain as the JAX CLI does
                gen = make_sampler(model, schedule, SamplerConfig(
                    num_inference_steps=args.gen_ddim_steps, skip_type="quad",
                    style="ddim_exp"))
                x01 = gen(torch.Generator(device=device).manual_seed(args.seed),
                          args.batch_size, hw, cfg.in_channels)
                os.makedirs(args.save_path, exist_ok=True)
                save_image_grid(x01[:64], os.path.join(args.save_path,
                                                       "generated_for_pruning.png"))
                x0 = x01.clone() * 2.0 - 1.0  # a normal tensor, usable under autograd
                print(f"Generated {args.batch_size} samples for the sweep")
            else:
                from ..data.datasets import get_dataset, iterate_batches

                ds = get_dataset(args.dataset)
                print(f"Dataset size: {len(ds)}")
                batch = next(iterate_batches(ds, args.batch_size, seed=args.seed))
                x0 = torch.from_numpy(batch).to(device)
            noise = torch.randn(x0.shape, generator=torch.Generator(device=device).manual_seed(
                args.seed), device=device)
            thr = args.thr if args.pruner == "diff-pruning" else None
            print("Accumulating gradients for pruning...")
            t0 = time.perf_counter()
            res = accumulate_taylor_grads(model, schedule, x0, noise, thr=thr,
                                          max_steps=args.max_steps, loss_type="mse")
            grads = unflatten_params(flat_grads(model))
            model.zero_grad(set_to_none=True)
            stats["sweep_seconds"] = time.perf_counter() - t0
            stats["steps_run"] = res.steps_run
            print(f"  sweep: {res.steps_run} timesteps in {stats['sweep_seconds']:.1f}s")

        imp = make_importance(args.pruner, seed=args.seed, normalizer=args.normalizer)
        result = prune(model.graph, params, imp, sparsity=args.pruning_ratio, grads=grads,
                       global_pruning=args.global_pruning, max_sparsity=args.max_sparsity)
        new_params = apply_pruning(params, model.graph, result)
        new_cfg = cfg.with_channel_sizes(result.channel_sizes)
        if args.pruner == "reinit":  # ddpm_prune.py:125-131
            new_model = UNet2D(new_cfg, device="cpu").init(
                torch.Generator().manual_seed(args.seed)).to(device)
        else:
            new_model = UNet2D(new_cfg, device=device)
            new_model.load_state_dict(state_dict_from_flat(flatten_params(new_params)))
        new_model.graph.validate(new_params)
        macs, n_params = count_ops_and_params(new_model, sample_shape)
        print("#Params: {:.4f} M => {:.4f} M".format(base_params / 1e6, n_params / 1e6))
        print("#MACS: {:.4f} G => {:.4f} G".format(base_macs / 1e9, macs / 1e9))
    else:
        new_cfg, new_model = cfg, model
        macs, n_params = base_macs, base_params
    stats.update(params=n_params, macs=macs, channel_sizes=dict(new_cfg.channel_sizes))

    save_model(args.save_path, new_cfg, new_model)
    print(f"Saved pruned model to {args.save_path}")

    if not args.skip_vis:
        sampler = make_sampler(new_model, schedule, SamplerConfig(num_inference_steps=100))
        imgs = sampler(torch.Generator(device=device).manual_seed(0),
                       min(args.batch_size, 64), hw, cfg.in_channels)
        os.makedirs(os.path.join(args.save_path, "vis"), exist_ok=True)
        save_image_grid(imgs, os.path.join(args.save_path, "vis", "after_pruning.png"))
        print("Wrote vis/after_pruning.png")
    return stats


if __name__ == "__main__":
    main()
