"""CLI: prune a class-conditional latent-diffusion UNet (counterpart of
``diff_pruning_tpu/cli/ldm_prune.py``; ldm_exp/prune_ldm.py, the cin256-v2
workflow).

    python -m diff_pruning_tpu_torch.cli.ldm_prune --model_path DIR \\
        --save_path OUT --pruner diff-pruning --sparsity 0.3 --thr 0.1 \\
        --batch_size 6 --device cuda

Loads an LDM model dir in the JAX package's layout (``unet/``,
``cond_stage/``, optional ``first_stage/``, ``ldm.json``), or without
``--model_path`` a random init from ``--seed`` (cin256-v2, or ``--config``).
For the gradient pruners it runs the self-sampled sweep
(``diffpruning/sweep.py`` ``accumulate_ldm_grads``): at step t it draws
``--batch_size`` labels in [0, n_classes - 1) and CFG latents from the
current model (``--method``, ``--ddim_steps``, ``--scale``), then the loss
at timestep t; the forward and backward go through the port's GroupNorm and
attention kernels on the card. ``diff-pruning`` stops at the first step
whose loss is below ``--thr`` times the running maximum, before that step's
backward. Then it scores and selects channels over ``UNetCond.graph``
(attention heads grouped, ``--round_to``), slices the weights, and writes the
pruned ``unet/``, the ``cond_stage/``, the unpruned ``first_stage/`` and
``ldm.json`` (both packages load the dir), then a DDIM vis grid of
``--classes`` (``samples.png``).

Differences from the JAX CLI: the sweep's labels, latents and noise come
from a ``torch.Generator`` seeded by ``--seed`` (jax.random streams cannot be
reproduced in torch); ``--device cuda`` (the default) without a GPU raises:
the CLI never carries on on the CPU. TF32 is off for matmuls and
convolutions (printed at the start).
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, default=None,
                   help="LatentDiffusion model dir; random init if absent")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--sparsity", type=float, default=0.3)
    p.add_argument("--pruner", type=str, default="diff-pruning",
                   choices=["magnitude", "random", "taylor", "diff-pruning", "reinit", "diff0"])
    p.add_argument("--thr", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=6,
                   help="n_samples_per_class (prune_ldm.py:47)")
    p.add_argument("--ddim_steps", type=int, default=20)
    p.add_argument("--method", type=str, default="ddim", choices=["ddim", "plms", "dpm"],
                   help="the solver of the self-sampled latents")
    p.add_argument("--scale", type=float, default=3.0, help="CFG guidance scale")
    p.add_argument("--round_to", type=int, default=2)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--classes", type=int, nargs="*", default=[25, 187, 448, 992])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip_vis", action="store_true")
    p.add_argument("--config", type=str, default=None,
                   help="UNetCond config JSON (default: cin256-v2)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{"params_before", "params", "steps_run", "losses",
    "sweep_seconds", "launches", "channel_sizes"}`` (``steps_run`` 0 and
    ``launches`` empty when no sweep ran; ``launches`` are the sweep's kernel
    launches)."""
    args = parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    device = resolve_device(args.device)
    import torch

    from .. import ops
    from ..diffpruning.sweep import accumulate_ldm_grads
    from ..models.latent_diffusion import LatentDiffusion, load_ldm
    from ..models.unet_cond import UNetCond
    from ..pruning.importance import make_importance
    from ..pruning.pruner import apply_pruning, prune
    from ..pruning.surgery import flatten_params, unflatten_params
    from ..sampling.ddim_sampler import save_image_grid
    from ..utils.checkpoint import (flat_from_state_dict, flat_grads, save_ldm,
                                    state_dict_from_flat)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ldm = load_ldm(args.model_path, args.config, args.seed, device=device)
    ucfg, graph = ldm.unet.cfg, ldm.unet.graph
    params = unflatten_params(flat_from_state_dict(ldm.unet.state_dict()))
    graph.validate(params)
    hw, ch = ucfg.image_size, ucfg.in_channels
    base_params = sum(p.numel() for p in ldm.unet.parameters())
    stats = {"params_before": base_params, "steps_run": 0, "losses": [], "sweep_seconds": 0.0,
             "launches": {}}

    grads = None
    if args.pruner in ("taylor", "diff-pruning", "diff0"):
        sampler = ldm.make_cfg_sampler(ddim_steps=args.ddim_steps, guidance_scale=args.scale,
                                       method=args.method, latent_hw=hw, latent_ch=ch)
        gen = torch.Generator(device=device).manual_seed(args.seed)

        def draw(t):
            labels = torch.randint(0, ldm.n_classes - 1, (args.batch_size,), generator=gen,
                                   device=device)
            latents = sampler(gen, labels, args.batch_size)
            noise = torch.randn(latents.shape, generator=gen, device=device)
            return latents, labels, noise

        thr = {"diff-pruning": args.thr, "diff0": 0.0}.get(args.pruner)
        print("Accumulating gradients from self-sampled latents...")
        before = dict(ops.LAUNCHES)
        sync()
        t0 = time.perf_counter()
        res = accumulate_ldm_grads(ldm, draw, max_steps=args.max_steps, thr=thr, log_every=20)
        sync()
        stats["sweep_seconds"] = time.perf_counter() - t0
        stats.update(steps_run=res.steps_run, losses=res.losses.tolist(),
                     launches={k: ops.LAUNCHES[k] - before[k] for k in before})
        grads = unflatten_params(flat_grads(ldm.unet))
        ldm.unet.zero_grad(set_to_none=True)
        print(f"  sweep: {res.steps_run} steps in {stats['sweep_seconds']:.1f}s; kernel "
              f"launches {stats['launches']}")

    imp = make_importance(args.pruner if args.pruner != "diff0" else "diff-pruning",
                          seed=args.seed)
    result = prune(graph, params, imp, sparsity=args.sparsity, grads=grads,
                   round_to=args.round_to)
    new_unet = apply_pruning(params, graph, result)
    del params, grads
    new_ucfg = ucfg.with_channel_sizes(result.channel_sizes)
    ldm2 = LatentDiffusion(new_ucfg, n_classes=ldm.n_classes, first_stage=ldm.first_stage,
                           scale_factor=ldm.scale_factor,
                           num_train_timesteps=ldm.schedule.num_train_timesteps,
                           linear_start=ldm.linear_start, linear_end=ldm.linear_end,
                           device=device)
    ldm2.unet.graph.validate(new_unet)
    if args.pruner == "reinit":
        fresh = UNetCond(new_ucfg, device="cpu").init(torch.Generator().manual_seed(args.seed))
        ldm2.unet.load_state_dict(fresh.state_dict())
    else:
        ldm2.unet.load_state_dict(state_dict_from_flat(flatten_params(new_unet)))
    ldm2.cond_stage.load_state_dict(ldm.cond_stage.state_dict())
    ldm2.eval()
    del new_unet

    n_params = sum(p.numel() for p in ldm2.unet.parameters())
    print(f"Params: {n_params / base_params * 100:.2f}%, "
          f"{base_params / 1e6:.2f}M => {n_params / 1e6:.2f}M")
    stats.update(params=n_params, channel_sizes=dict(new_ucfg.channel_sizes))
    save_ldm(args.save_path, ldm2)
    print(f"Saved pruned LDM to {args.save_path}")

    if not args.skip_vis:  # always DDIM, as the JAX CLI's grid
        sampler2 = ldm2.make_cfg_sampler(ddim_steps=args.ddim_steps, guidance_scale=args.scale,
                                         latent_hw=hw, latent_ch=ch)
        rows = []
        for cls in args.classes:
            labels = torch.full((args.batch_size,), cls, dtype=torch.int64, device=device)
            lat = sampler2(torch.Generator(device=device).manual_seed(cls), labels,
                           args.batch_size)
            rows.append(ldm2.decode_first_stage(lat) if ldm2.first_stage is not None
                        else (lat * 0.5 + 0.5).clamp(0.0, 1.0))
        save_image_grid(torch.cat(rows).cpu().numpy(),
                        os.path.join(args.save_path, "samples.png"), nrow=args.batch_size)
        print("Wrote samples.png")
    return stats


if __name__ == "__main__":
    main()
