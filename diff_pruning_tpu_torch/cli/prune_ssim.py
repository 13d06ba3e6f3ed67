"""CLI: the timestep-stage pruning ablation (counterpart of
``diff_pruning_tpu/cli/prune_ssim.py``, ddpm_exp/prune_ssim.py).

    python -m diff_pruning_tpu_torch.cli.prune_ssim --model_path <dir> \\
        --save_path run/ssim --dataset data.npz [--stages 1 10 50 100 250 500 1000]

Samples ``--n_vis`` images from the unpruned UNet into ``stage_base``. Then,
for each ``--stages`` N: accumulates Taylor grads over exactly the first N
timesteps (no early stop, prune_ssim.py:257-269), scores with Diff-Pruning,
prunes at ``--pruning_ratio`` and writes the pruned checkpoint and its
samples into ``stage_N``. Every sample set starts from one fixed draw (a
generator seeded 123 for each call), so the SSIM of ``stage_N`` against
``stage_base`` (``cli/compute_ssim.py``) is the paper's same-seed
consistency curve over the sweep's length.

Differences from the JAX CLI: the sweep noise and the samples' initial noise
come from ``torch.Generator``s (seeded ``--seed`` and 123), not from
``jax.random``, so the images differ from the JAX CLI's. ``--device cuda``
(the default) without a GPU raises: the CLI never carries on on the CPU.
TF32 is off for matmuls and convolutions (printed at the start).
"""

from __future__ import annotations

import argparse
import os
import time

SAMPLE_SEED = 123


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--dataset", type=str, required=True,
                   help="a .npz of uint8 NHWC images | a CIFAR-10 batch directory | cifar10")
    p.add_argument("--pruning_ratio", type=float, default=0.3)
    p.add_argument("--stages", type=int, nargs="+",
                   default=[1, 10, 50, 100, 250, 500, 1000])
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--n_vis", type=int, default=64)
    p.add_argument("--ddim_steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{"channel_sizes": {stage: sizes}, "params": {stage: n},
    "steps_run": {stage: n}, "seconds": {stage: s}}``: ``seconds`` is the
    host clock over a stage's sweep, selection, save and sampling."""
    args = parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    device = resolve_device(args.device)
    import torch

    from ..data.datasets import get_dataset, iterate_batches
    from ..diffpruning.sweep import accumulate_taylor_grads
    from ..models.unet2d import UNet2D
    from ..pruning.importance import make_importance
    from ..pruning.pruner import apply_pruning, prune
    from ..pruning.surgery import flatten_params, unflatten_params
    from ..sampling.ddim_sampler import SamplerConfig, make_sampler, save_images
    from ..schedulers.ddpm import DiffusionSchedule
    from ..utils.checkpoint import (flat_from_state_dict, flat_grads, save_model,
                                    state_dict_from_flat)
    from .ddpm_prune import load_unet

    cfg, state = load_unet(args.model_path)
    model = UNet2D(cfg, device=device)
    model.load_state_dict(state)
    params = unflatten_params(flat_from_state_dict(model.state_dict()))
    schedule = DiffusionSchedule.create(device=device)
    hw = cfg.sample_size or 32

    ds = get_dataset(args.dataset, resolution=hw)
    batch = torch.from_numpy(next(iterate_batches(ds, args.batch_size, seed=args.seed)))
    batch = batch.to(device)
    noise = torch.randn(batch.shape, generator=torch.Generator(device=device).manual_seed(
        args.seed), device=device)

    def draw(net):
        """DDIM samples of ``net`` from the one fixed initial noise."""
        sampler = make_sampler(net, schedule, SamplerConfig(num_inference_steps=args.ddim_steps))
        return sampler(torch.Generator(device=device).manual_seed(SAMPLE_SEED), args.n_vis, hw,
                       cfg.in_channels)

    save_images(draw(model), os.path.join(args.save_path, "stage_base"))

    imp = make_importance("diff-pruning")
    out = {"channel_sizes": {}, "params": {}, "steps_run": {}, "seconds": {}}
    for stage in sorted(args.stages):
        t0 = time.perf_counter()
        res = accumulate_taylor_grads(model, schedule, batch, noise, thr=None, max_steps=stage)
        grads = unflatten_params(flat_grads(model))
        model.zero_grad(set_to_none=True)
        result = prune(model.graph, params, imp, sparsity=args.pruning_ratio, grads=grads)
        pruned = apply_pruning(params, model.graph, result)
        pcfg = cfg.with_channel_sizes(result.channel_sizes)
        pm = UNet2D(pcfg, device=device)
        pm.load_state_dict(state_dict_from_flat(flatten_params(pruned)))
        pm.graph.validate(pruned)
        out_dir = os.path.join(args.save_path, f"stage_{stage}")
        save_model(out_dir, pcfg, pm)
        save_images(draw(pm), out_dir)
        out["channel_sizes"][stage] = dict(pcfg.channel_sizes)
        out["params"][stage] = sum(p.numel() for p in pm.parameters())
        out["steps_run"][stage] = res.steps_run
        out["seconds"][stage] = time.perf_counter() - t0
        print(f"stage {stage}: saved model + {args.n_vis} samples to {out_dir}")
        del pm
    return out


if __name__ == "__main__":
    main()
