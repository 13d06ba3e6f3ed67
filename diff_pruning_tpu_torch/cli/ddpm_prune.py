"""CLI: prune a DDPM UNet (counterpart of ``diff_pruning_tpu/cli/ddpm_prune.py``).

    python -m diff_pruning_tpu_torch.cli.ddpm_prune \\
        --model_path <dir-with-unet-checkpoint> --save_path run/pruned \\
        --pruning_ratio 0.3 --pruner diff-pruning --thr 0.05 --dataset data.npz

Loads a ``(config.json, params.npz)`` checkpoint or a diffusers directory
(``unet/config.json`` + ``diffusion_pytorch_model.safetensors`` or ``.bin``,
as ``cli/convert_checkpoints.py export-diffusers`` writes it), accumulates Taylor grads
over a prefix of timesteps (``diffpruning/sweep.py``: forward and backward
through the port's GroupNorm and attention kernels on the card), scores and
selects channels (``pruning/``), slices the weights, and writes the pruned
``(config.json, params.npz)`` checkpoint, which both packages load, plus
``vis/after_pruning.png``. Prints the JAX CLI's ``#Params`` and ``#MACS``
lines.

With ``--multihost`` (one process per GPU, e.g. ``torchrun --nproc_per_node
N -m diff_pruning_tpu_torch.cli.ddpm_prune --multihost ...``) every process
draws the same sweep batch and noise, the sweep splits it by rows
(``parallel/mesh.py``; the world size must divide ``--batch_size``) and
averages each step's loss and, at the end, the grads over the processes;
scores, selection and slicing then run alike on every rank, and only rank 0
writes the pruned model and the grids. ``--host_loop`` keeps the JAX
meaning there: an unsplit sweep on every rank.

Differences from the JAX CLI:
* the sweep is one host loop (the JAX package's on-device ``lax.while_loop``
  exists to avoid TPU round-trips); without ``--multihost``, ``--host_loop``
  changes nothing;
* the data is any source of ``data/datasets.py`` (a local ``.npz``, CIFAR,
  an image folder, ``lsun:<lmdb>``, ...), or the model's own samples
  (``--use_generated_samples``); the sweep noise comes from a
  ``torch.Generator`` seeded by ``--seed``.
``--device cuda`` (the default) without a GPU raises: the CLI never carries
on on the CPU. TF32 is off for matmuls and convolutions (printed at the
start), as in the JAX package's parity tests.
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
                   help="a .npz of uint8 NHWC images | cifar10 | cifar100 | an image folder | "
                        "lsun:<lmdb dir> | ffhq:<lmdb dir> | imagenet:<root> | "
                        "txt:<filelist>:<data root> (data/datasets.py)")
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
                   help="the sweep is always one host loop; under --multihost this runs it "
                        "unsplit on every process, as the JAX CLI's host loop")
    p.add_argument("--global_pruning", action="store_true")
    p.add_argument("--normalizer", type=str, default=None,
                   choices=["sum", "mean", "max", "standarization", "gaussian"],
                   help="per-group score normalizer "
                        "(torch_pruning importance.py:25-40); affects only "
                        "--global_pruning rankings (default: mean)")
    p.add_argument("--cost_aware", type=str, default=None,
                   choices=["macs", "bytes", "hybrid"],
                   help="rank global-pruning candidates by importance per "
                        "unit HARDWARE cost (pruning/cost.py) instead of "
                        "importance alone; beyond the reference, which "
                        "implicitly optimizes MACs. Requires "
                        "--global_pruning. 'bytes' targets memory traffic, "
                        "'macs' the reference's objective, 'hybrid' a "
                        "roofline blend of the two")
    p.add_argument("--match_params", action="store_true",
                   help="with --cost_aware: binary-search the channel "
                        "sparsity so the final PARAM count matches what "
                        "importance-only pruning yields at --pruning_ratio "
                        "(naive cost division is aggressive: cross-layer "
                        "cost ratios are ~100x; this keeps the comparison "
                        "and the deployment budget in params, the unit the "
                        "paper reports)")
    p.add_argument("--max_sparsity", type=float, default=1.0,
                   help="cap any single var's drop fraction in global mode "
                        "(metapruner.py:172-194); 0.75 recommended with "
                        "--cost_aware so cost division cannot floor whole "
                        "layers")
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
    from ._multihost import add_multihost_args

    add_multihost_args(p)
    return p.parse_args(argv)


def load_unet(model_path: str):
    """Load ``(config, state_dict)`` (CPU tensors) from our layout,
    ``<path>/unet/params.npz`` or ``<path>/params.npz`` beside a
    ``config.json``, else from a diffusers directory: ``config.json`` (its
    ``channel_sizes`` rebuild a pruned model) beside
    ``diffusion_pytorch_model.safetensors`` or ``.bin``, under ``unet/`` or
    at the top."""
    from ..models.unet2d import UNet2DConfig
    from ..utils.checkpoint import load_model
    from ..utils.convert import load_diffusers_unet_checkpoint

    for sub in ("unet", ""):
        if os.path.exists(os.path.join(model_path, sub, "params.npz")):
            return load_model(model_path, subfolder=sub)
    for sub in ("unet", ""):
        d = os.path.join(model_path, sub)
        if os.path.exists(os.path.join(d, "config.json")):
            with open(os.path.join(d, "config.json")) as f:
                cfg = UNet2DConfig.from_json(f.read())
            return cfg, load_diffusers_unet_checkpoint(d)
    raise FileNotFoundError(f"no UNet checkpoint under {model_path}")


def main(argv=None) -> dict:
    """Returns ``{"params_before", "params", "macs_before", "macs", "steps_run",
    "sweep_seconds", "channel_sizes"}`` (``steps_run`` 0 when no sweep ran),
    and with ``--match_params`` ``"match_params": {"sparsity", "params",
    "target", "probes"}``."""
    args = parse_args(argv)
    from ._multihost import maybe_init_distributed
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    mesh = maybe_init_distributed(args)  # before the first use of the card
    device = mesh.device if mesh is not None else resolve_device(args.device)
    is_main = mesh is None or mesh.is_main
    import numpy as np
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
                if is_main:
                    os.makedirs(args.save_path, exist_ok=True)
                    save_image_grid(x01[:64], os.path.join(args.save_path,
                                                           "generated_for_pruning.png"))
                x0 = x01.clone() * 2.0 - 1.0  # a normal tensor, usable under autograd
                print(f"Generated {args.batch_size} samples for the sweep")
            else:
                from ..data.datasets import get_dataset, iterate_batches

                ds = get_dataset(args.dataset, resolution=hw)
                print(f"Dataset size: {len(ds)}")
                batch = next(iterate_batches(ds, args.batch_size, seed=args.seed))
                x0 = torch.from_numpy(batch).to(device)
            noise = torch.randn(x0.shape, generator=torch.Generator(device=device).manual_seed(
                args.seed), device=device)
            thr = args.thr if args.pruner == "diff-pruning" else None
            sweep_mesh = None if args.host_loop else mesh
            if sweep_mesh is not None and args.batch_size % sweep_mesh.world:
                raise SystemExit(f"--multihost: batch_size {args.batch_size} must be "
                                 f"divisible by the world size {sweep_mesh.world}")
            print("Accumulating gradients for pruning...")
            t0 = time.perf_counter()
            res = accumulate_taylor_grads(model, schedule, x0, noise, thr=thr,
                                          max_steps=args.max_steps, loss_type="mse",
                                          mesh=sweep_mesh)
            grads = unflatten_params(flat_grads(model))
            model.zero_grad(set_to_none=True)
            stats["sweep_seconds"] = time.perf_counter() - t0
            stats["steps_run"] = res.steps_run
            print(f"  sweep: {res.steps_run} timesteps in {stats['sweep_seconds']:.1f}s")

        imp = make_importance(args.pruner, seed=args.seed, normalizer=args.normalizer)
        cost_w = None
        if args.cost_aware:
            if not args.global_pruning:
                raise SystemExit("--cost_aware requires --global_pruning "
                                 "(cost division ranks the global pool)")
            from ..pruning.cost import var_cost_weights

            # traced at the serving batch: at B = 1 weight traffic dominates
            # the byte model and the ranking degenerates
            cost_w = var_cost_weights(model, (args.batch_size, hw, hw, cfg.in_channels),
                                      mode=args.cost_aware)

        def _prune_at(s, cw):
            return prune(model.graph, params, imp, sparsity=s, grads=grads,
                         global_pruning=args.global_pruning, cost_weights=cw,
                         max_sparsity=args.max_sparsity)

        result = _prune_at(args.pruning_ratio, cost_w)
        if cost_w is not None and args.match_params:
            # equal-params calibration: hit the param budget importance-only
            # pruning yields at the requested ratio, within 1 %
            def n_params_of(r):
                return sum(int(np.size(a)) for a in flatten_params(
                    apply_pruning(params, model.graph, r)).values())

            target = n_params_of(_prune_at(args.pruning_ratio, None))
            lo, hi = 0.0, 0.95
            best = None  # (abs err, sparsity, result, n): channel drops are
            # discrete, so 1 % may be unreachable on small models; keep the
            # closest allocation seen rather than whatever the last probe was
            for probes in range(1, 25):
                mid = (lo + hi) / 2
                r = _prune_at(mid, cost_w)
                n = n_params_of(r)
                err = abs(n - target)
                if best is None or err < best[0]:
                    best = (err, mid, r, n)
                if err / target < 0.01:
                    break
                if n > target:
                    lo = mid
                else:
                    hi = mid
            _, mid, result, n = best
            stats.update(match_params={"sparsity": mid, "params": n, "target": target,
                                       "probes": probes})
            print(f"match_params: channel sparsity {mid:.4f} -> "
                  f"{n/1e6:.3f}M (target {target/1e6:.3f}M)")
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

    # the sweep's grads are the same on every rank, and so are the scores and
    # the selection: only rank 0 writes, and the vis runs there without a mesh
    if is_main:
        save_model(args.save_path, new_cfg, new_model)
        print(f"Saved pruned model to {args.save_path}")
    if is_main and not args.skip_vis:
        sampler = make_sampler(new_model, schedule, SamplerConfig(num_inference_steps=100))
        imgs = sampler(torch.Generator(device=device).manual_seed(0),
                       min(args.batch_size, 64), hw, cfg.in_channels)
        os.makedirs(os.path.join(args.save_path, "vis"), exist_ok=True)
        save_image_grid(imgs, os.path.join(args.save_path, "vis", "after_pruning.png"))
        print("Wrote vis/after_pruning.png")
    if mesh is not None:
        from ..parallel.mesh import barrier

        barrier(mesh)  # the model is on disk before any rank returns
    return stats


if __name__ == "__main__":
    main()
