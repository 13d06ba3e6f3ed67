"""End-to-end algorithm validation on procedural data (no external weights):
the counterpart of the repository's ``tools/e2e_validation.py``.

The reference's quality story is behavioural (SURVEY.md §4): prune a trained
model, check same-seed sample consistency (SSIM) and post-finetune recovery.
No pretrained checkpoint is in the repository, so this trains a DDPM from
scratch on a procedural image distribution, then runs the Diff-Pruning
pipeline and reports the paper's metrics:

  1. train a DDPM UNet from scratch (bf16 with f32 masters, one step a batch);
  2. sample a fixed-seed grid (DDIM-50, quad, ddim_exp);
  3. one Taylor sweep with thr 0.05, then prune 30 % with each criterion
     (diff-pruning / taylor / magnitude / random);
  4. same-seed SSIM of pruned against unpruned samples per criterion: the
     paper's claim is diff-pruning > random here (exp.png's SSIM column);
  5. finetune the diff-pruned UNet briefly and report the SSIM after it.

    python -m diff_pruning_tpu_torch.tools.e2e_validation [--steps 3000] [--out run/e2e]
        [--full] [--device cuda]

``--full`` runs the 35.75M ``ddpm_cifar10`` UNet (dropout 0.1); the default
is the 6.47M dev UNet. The sweep and the finetune run through the port's
GroupNorm and attention kernels on the card. Differences from the JAX
driver: one train step a batch (``training/finetune.make_train_step``; the
JAX driver's chunked step has no counterpart) and the sweep's host loop
(``diffpruning/sweep.accumulate_taylor_grads``) with the same ``thr``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

CRITERIA = ("diff-pruning", "taylor", "magnitude", "random")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--finetune_steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--out", type=str, default="run/e2e")
    ap.add_argument("--ratio", type=float, default=0.3)
    ap.add_argument("--full", action="store_true",
                    help="run at the real CIFAR scale (the 35.75M-param "
                         "ddpm_cifar10 UNet) instead of the 6.47M dev model")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' raises when no GPU is present")
    return ap.parse_args(argv)


def model_config(full: bool):
    """The UNet trained from scratch: ddpm_cifar10 with dropout 0.1, or the
    dev UNet (64-128-128 channels, attention at 16 x 16)."""
    from ..models.unet2d import UNet2DConfig, ddpm_cifar10_config

    if full:
        return dataclasses.replace(ddpm_cifar10_config(), dropout=0.1)
    return UNet2DConfig(
        sample_size=32,
        block_out_channels=(64, 128, 128),
        down_block_types=("DownBlock2D", "AttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "AttnUpBlock2D", "UpBlock2D"),
        layers_per_block=2, downsample_padding=0, attention_head_dim=None,
        norm_num_groups=32, norm_eps=1e-6, freq_shift=1,
        flip_sin_to_cos=False, dropout=0.1)


def unet_with(cfg, state_dict, device):
    """A UNet of ``cfg`` on ``device`` holding ``state_dict``."""
    from ..models.unet2d import UNet2D

    model = UNet2D(cfg, device=device)
    model.load_state_dict(state_dict)
    return model


def train(model, schedule, batches, steps: int, *, device, seed: int, batch: int,
          log_every=None):
    """``steps`` bf16 Adam steps at lr 2e-4 (f32 masters, EMA), one a batch,
    the noise, timesteps and dropout drawn from (``seed``, step), the loss
    and imgs/s logged every ``log_every`` steps. Returns (the EMA weights,
    seconds)."""
    import torch

    from ..training.finetune import TrainConfig, init_train_state, make_train_step
    from ._runner import seconds_since

    tcfg = TrainConfig(learning_rate=2e-4, mixed_precision="bf16", num_train_steps=steps)
    state = init_train_state(model, tcfg)
    step = make_train_step(model, schedule, tcfg, seed=seed)
    t0 = time.perf_counter()
    for s in range(steps):
        state, m = step(state, torch.from_numpy(next(batches)).to(device))
        if log_every and (s + 1) % log_every == 0:
            dt = seconds_since(t0, device)
            print(f"  step {s + 1}: loss {float(m['loss']):.1f} "
                f"({(s + 1) * batch / dt:.0f} imgs/s)")
    return state.ema_params, seconds_since(t0, device)


def draw(model, schedule, *, device, n: int = 64, seed: int = 42, ddim_steps: int = 50):
    """``n`` same-seed images in [0, 1] (DDIM, quad, ddim_exp), NHWC."""
    import torch

    from ..sampling.ddim_sampler import SamplerConfig, make_sampler

    hw = model.cfg.sample_size
    sampler = make_sampler(model, schedule, SamplerConfig(
        num_inference_steps=ddim_steps, skip_type="quad", style="ddim_exp"))
    return sampler(torch.Generator(device=device).manual_seed(seed), n, hw,
                   model.cfg.in_channels)


def prune_with(criterion: str, model, grads, *, ratio: float = 0.3, device):
    """Prunes ``model`` (local, ``ratio`` of every prunable var) by
    ``criterion`` with the sweep's ``grads`` (a nested dict in the JAX
    layout); returns (the ``PruneResult``, the pruned UNet on ``device``,
    MACs, params) with the MACs counted at one 32 x 32 image."""
    from ..pruning.flops import count_ops_and_params
    from ..pruning.importance import make_importance
    from ..pruning.pruner import apply_pruning, prune
    from ..pruning.surgery import flatten_params, unflatten_params
    from ..utils.checkpoint import flat_from_state_dict, state_dict_from_flat

    params = unflatten_params(flat_from_state_dict(model.state_dict()))
    pr = prune(model.graph, params, make_importance(criterion, seed=0), sparsity=ratio,
               grads=grads)
    pcfg = model.cfg.with_channel_sizes(pr.channel_sizes)
    pmodel = unet_with(pcfg, state_dict_from_flat(flatten_params(
        apply_pruning(params, model.graph, pr))), device)
    macs, n = count_ops_and_params(pmodel, (1, 32, 32, 3))
    return pr, pmodel, macs, n


def run(*, steps: int = 3000, finetune_steps: int = 600, batch: int = 128,
        out: str = "run/e2e", ratio: float = 0.3, full: bool = False, device="cuda",
        n_samples: int = 64, ddim_steps: int = 50, sweep_max_steps=None) -> dict:
    """The whole validation; returns its figures: ``params`` (before),
    ``sweep_steps``, ``criteria`` ({name: {"ssim", "params", "macs"}}),
    ``ssim_finetuned``, ``diff_pruning_ge_random`` and ``seconds`` per
    stage. The keyword defaults are the JAX driver's; ``n_samples``,
    ``ddim_steps`` and ``sweep_max_steps`` (no cap) size a short run."""
    import torch

    from ..cli.ddpm_sample import pin_f32_precision, resolve_device
    from ..data.datasets import ArrayDataset, iterate_batches
    from ..data.procedural import make_procedural_dataset
    from ..diffpruning.sweep import accumulate_taylor_grads
    from ..eval.ssim import ssim
    from ..models.unet2d import UNet2D
    from ..pruning.flops import count_params
    from ..pruning.surgery import unflatten_params
    from ..sampling.ddim_sampler import save_image_grid
    from ..schedulers.ddpm import DiffusionSchedule
    from ..utils.checkpoint import flat_grads
    from ._runner import seconds_since

    pin_f32_precision()
    device = resolve_device(str(device))
    os.makedirs(out, exist_ok=True)
    seconds = {}
    cfg = model_config(full)
    model = UNet2D(cfg, device="cpu").init(torch.Generator().manual_seed(0)).to(device)
    schedule = DiffusionSchedule.create(device=device)
    n_params = count_params(model)
    print(f"model: {n_params / 1e6:.2f}M params")

    batches = iterate_batches(ArrayDataset(make_procedural_dataset()), batch, seed=0)

    # 1. scratch training
    trained, seconds["train"] = train(model, schedule, batches, steps, device=device, seed=1,
                                      batch=batch, log_every=500)
    print(f"trained {steps} steps in {seconds['train']:.0f}s")

    eval_cfg = dataclasses.replace(cfg, dropout=0.0)
    eval_model = unet_with(eval_cfg, trained, device)
    t0 = time.perf_counter()
    base = draw(eval_model, schedule, device=device, n=n_samples, ddim_steps=ddim_steps)
    save_image_grid(base, os.path.join(out, "base_samples.png"))
    seconds["base_sample"] = seconds_since(t0, device)

    # 2. sweep grads on the trained model
    t0 = time.perf_counter()
    x0 = torch.from_numpy(next(batches)).to(device)
    noise = torch.randn(x0.shape, generator=torch.Generator(device=device).manual_seed(2),
                        device=device)
    res = accumulate_taylor_grads(eval_model, schedule, x0, noise, thr=0.05,
                                  max_steps=sweep_max_steps)
    grads = unflatten_params(flat_grads(eval_model))
    eval_model.zero_grad(set_to_none=True)
    seconds["sweep"] = seconds_since(t0, device)
    print(f"diff-pruning sweep: stopped after {res.steps_run} timesteps")

    # 3-4. prune with each criterion, same-seed SSIM against the base
    results, criteria, pruned = {}, {}, {}
    t0 = time.perf_counter()
    for crit in CRITERIA:
        _, pmodel, macs, n = prune_with(crit, eval_model, grads, ratio=ratio, device=device)
        imgs = draw(pmodel, schedule, device=device, n=n_samples, ddim_steps=ddim_steps)
        s = float(ssim(imgs, base))
        results[crit] = s
        criteria[crit] = {"ssim": s, "params": n, "macs": macs}
        pruned[crit] = pmodel
        save_image_grid(imgs, os.path.join(out, f"pruned_{crit}.png"))
        print(f"  {crit:13s}: SSIM {s:.4f}  ({n / 1e6:.2f}M params, {macs / 1e9:.3f}G MACs)")
    seconds["prune_and_sample"] = seconds_since(t0, device)

    # 5. brief finetune of the diff-pruned model
    pmodel = pruned["diff-pruning"]
    pcfg = pmodel.cfg
    ft_model = unet_with(dataclasses.replace(pcfg, dropout=0.1), pmodel.state_dict(), device)
    ft_ema, seconds["finetune"] = train(ft_model, schedule, batches, finetune_steps,
                                        device=device, seed=3, batch=batch)
    t0 = time.perf_counter()
    imgs = draw(unet_with(pcfg, ft_ema, device), schedule, device=device, n=n_samples,
                ddim_steps=ddim_steps)
    s_ft = float(ssim(imgs, base))
    save_image_grid(imgs, os.path.join(out, "pruned_finetuned.png"))
    seconds["finetuned_sample"] = seconds_since(t0, device)
    print(f"  after {finetune_steps}-step finetune: SSIM {s_ft:.4f} "
        f"(was {results['diff-pruning']:.4f})")

    ok = results["diff-pruning"] >= results["random"]
    report = {"device": str(device), "params": n_params, "steps": steps,
              "finetune_steps": finetune_steps, "sweep_steps": res.steps_run,
              "criteria": criteria, "ssim_finetuned": s_ft, "diff_pruning_ge_random": ok,
              "seconds": seconds}
    with open(os.path.join(out, "e2e_result.json"), "w") as f:
        json.dump(report, f, indent=1)
    print("seconds: " + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    print("\nRESULT " + str({**results, "diff-pruning+finetune": round(s_ft, 4)}))
    print(f"diff-pruning >= random consistency: {ok}")
    return report


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(steps=args.steps, finetune_steps=args.finetune_steps, batch=args.batch,
               out=args.out, ratio=args.ratio, full=args.full, device=args.device)


if __name__ == "__main__":
    main()
