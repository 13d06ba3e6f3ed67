"""Cost-aware pruning quality: the counterpart of the repository's
``tools/cost_quality.py``, on the port's CLIs. Measures both columns, FID/SSIM
and sampling throughput, at one param budget through the CLIs, on a
``fullrun`` output directory's scratch-trained 35.75M base (``--base``):

  pruneA    importance-only global diff-pruning at ratio 0.3
            (reference semantics, ddpm_prune.py:94-131)
  pruneB    --cost_aware hybrid --match_params (equal param budget,
            --max_sparsity 0.75)
  finetune  the same recipe for both arms (cli.ddpm_train)
  sample    same-seed grids (seed 42, against the base's samples_base) + FID
            sets (seed 0) for both arms
  eval      FID (random-init Inception) against the data at equal n, a base
            subset included; pairwise SSIM against the base
            (ddpm_exp/compute_ssim.py:39-52); and timed DDIM-100 bs128
            sampling per arm (CUDA events, the arms in turns: A, B, B, A)

State lives in <out>/cost_quality_state.json; each CLI's output goes to
<out>/logs/<phase>.log. Run it alone on the card.

    python -m diff_pruning_tpu_torch.tools.cost_quality --base run/fullrun --out run/cost_quality
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Optional

from . import _runner

TAG = "cost_quality"
CLI = "diff_pruning_tpu_torch.cli."
ARMS = {
    "A_importance_only": [
        "--pruning_ratio", "0.3", "--pruner", "diff-pruning",
        "--thr", "0.05", "--global_pruning"],
    "B_cost_aware": [
        "--pruning_ratio", "0.3", "--pruner", "diff-pruning",
        "--thr", "0.05", "--global_pruning",
        "--cost_aware", "hybrid", "--match_params",
        "--max_sparsity", "0.75"],
}


@dataclasses.dataclass
class Sizes:
    """``ddim_steps`` (the samples' and the timed sampling's),
    ``prune_max_steps`` (appended to the prune CLI's argv as
    ``--max_steps``; none by default) and the timed calls a turn size a
    short run."""
    ft_steps: int
    fid_n: int
    ssim_n: int
    ddim_steps: int = 100
    prune_max_steps: Optional[int] = None
    time_iters: int = 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--base", default="run/fullrun",
                    help="a fullrun output directory (data.npz, base/, samples_base/, "
                         "samples_base_fid/)")
    ap.add_argument("--out", default="run/cost_quality")
    ap.add_argument("--ft_steps", type=int, default=20000)
    ap.add_argument("--fid_n", type=int, default=10000)
    ap.add_argument("--ssim_n", type=int, default=1024)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of every CLI; 'cuda' raises when no GPU is present")
    return ap.parse_args(argv)


def sampling_imgs_per_sec(model_dirs: dict, *, device, batch: int = 128, ddim_steps: int = 100,
                          iters: int = 3) -> dict:
    """DDIM (quad, ddim_exp, bf16) imgs/s of each model dir's UNet at
    ``batch``, timed in turns after 2 warm-up batches."""
    import torch

    from ..cli.ddpm_prune import load_unet
    from ..models.unet2d import UNet2D
    from ..sampling.ddim_sampler import SamplerConfig, make_sampler
    from ..schedulers.ddpm import DiffusionSchedule

    device = torch.device(device)
    schedule = DiffusionSchedule.create(device=device)
    fns = []
    for d in model_dirs.values():
        cfg, state = load_unet(d)
        model = UNet2D(cfg, device=device)
        model.load_state_dict(state)
        sample = make_sampler(model, schedule, SamplerConfig(
            num_inference_steps=ddim_steps, skip_type="quad", style="ddim_exp",
            dtype="bfloat16"))
        gen = torch.Generator(device=device).manual_seed(2)
        fns.append(lambda s=sample, g=gen: s(g, batch, cfg.sample_size, cfg.in_channels))
    ms = _runner.in_turns(fns, iters, 2, device)
    return {arm: round(batch / (t / 1e3), 1) for arm, t in zip(model_dirs, ms)}


def run(base: str, out: str, sz: Sizes, *, device="cuda") -> dict:
    """Every phase not yet in ``<out>/cost_quality_state.json``; returns the
    state."""
    base = os.path.abspath(base)
    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    logs = os.path.join(out, "logs")
    st = _runner.State(out, "cost_quality_state.json")
    data_npz = os.path.join(base, "data.npz")
    base_dir = os.path.join(base, "base")
    base_grid = os.path.join(base, "samples_base")  # seed 42
    base_fid_full = os.path.join(base, "samples_base_fid")  # seed 0

    def sh(phase, argv):
        rc, dt, res = _runner.run(logs, phase, argv, device=device, tag=TAG)
        _runner.require(rc == 0, f"{phase} failed:\n{_runner.tail_log(logs, phase)}")
        return dt, res

    def sample_argv(model_dir, out_dir, n, seed):
        return [CLI + "ddpm_sample", "--model_path", model_dir, "--output_dir", out_dir,
                "--batch_size", "128", "--total_samples", str(n),
                "--ddim_steps", str(sz.ddim_steps), "--skip_type", "quad",
                "--style", "ddim_exp", "--use_ema", "--dtype", "bfloat16", "--seed", str(seed)]

    for arm, flags in ARMS.items():
        pruned = os.path.join(out, f"pruned_{arm}")
        if not st.done(f"prune_{arm}"):
            cap = [] if sz.prune_max_steps is None else ["--max_steps", str(sz.prune_max_steps)]
            dt, res = sh(f"prune_{arm}", [
                CLI + "ddpm_prune",
                "--dataset", data_npz, "--model_path", base_dir,
                "--save_path", pruned, "--batch_size", "128",
                "--skip_vis"] + flags + cap)
            st.mark(f"prune_{arm}", secs=round(dt, 1), params_m=round(res["params"] / 1e6, 4),
                    macs_g=round(res["macs"] / 1e9, 4), steps_run=res["steps_run"])

        ft = os.path.join(out, f"ft_{arm}")
        if not st.done(f"finetune_{arm}"):
            dt, _ = sh(f"finetune_{arm}", [
                CLI + "ddpm_train",
                "--dataset", data_npz, "--model_path", pruned,
                "--output_dir", ft,
                "--train_batch_size", "128",
                "--num_iters", str(sz.ft_steps),
                "--learning_rate", "2e-4", "--dropout", "0.1",
                "--mixed_precision", "bf16",
                "--save_model_steps", str(max(1000, sz.ft_steps // 4)),
                "--log_steps", "100"])
            st.mark(f"finetune_{arm}", steps=sz.ft_steps, secs=round(dt, 1))

        if not st.done(f"sample_{arm}"):
            dt, _ = sh(f"grid_{arm}", sample_argv(ft, os.path.join(out, f"grid_{arm}"),
                                                  sz.ssim_n, 42))
            dt2, _ = sh(f"fid_samples_{arm}", sample_argv(ft, os.path.join(out, f"fid_{arm}"),
                                                          sz.fid_n, 0))
            st.mark(f"sample_{arm}", secs=round(dt + dt2, 1))

    # equal-n base subset for the FID column (symlinks, no copy)
    base_fid_sub = os.path.join(out, "base_fid_subset")
    if not st.done("base_subset"):
        os.makedirs(base_fid_sub, exist_ok=True)
        files = sorted(glob.glob(os.path.join(base_fid_full, "*.png")))
        _runner.require(len(files) >= sz.fid_n,
                        f"base FID set has {len(files)} < {sz.fid_n}")
        for f in files[:sz.fid_n]:
            dst = os.path.join(base_fid_sub, os.path.basename(f))
            if not os.path.exists(dst):
                os.symlink(f, dst)
        st.mark("base_subset", n=sz.fid_n)

    # the data's Inception statistics, computed once for all three FIDs
    data_stats = os.path.join(out, "data_stats.npz")
    if not st.done("data_stats"):
        dt, _ = sh("data_stats", [CLI + "fid_score", data_npz, data_stats, "--save-stats",
                                  "--random-init-seed", "0", "--batch-size", "256"])
        st.mark("data_stats", secs=round(dt, 1))

    if not st.done("eval"):
        evals = {}
        for tag, d in [("fid_base", base_fid_sub)] + [
                (f"fid_{arm}", os.path.join(out, f"fid_{arm}")) for arm in ARMS]:
            _, fid = sh(f"eval_{tag}", [CLI + "fid_score", d, data_stats,
                                        "--random-init-seed", "0", "--batch-size", "256"])
            evals[tag] = float(fid)
        for arm in ARMS:
            _, res = sh(f"eval_ssim_{arm}", [CLI + "compute_ssim", base_grid,
                                             os.path.join(out, f"grid_{arm}")])
            evals[f"ssim_{arm}"] = res["ssim"]
        st.mark("eval", **evals)

    # timed DDIM-100 bs128 sampling of each arm, in turns
    if not st.done("throughput"):
        rows = sampling_imgs_per_sec({arm: os.path.join(out, f"ft_{arm}") for arm in ARMS},
                                     device=device, ddim_steps=sz.ddim_steps,
                                     iters=sz.time_iters)
        for arm, ips in rows.items():
            print(f"[cost_quality] throughput {arm}: {ips} imgs/s", flush=True)
        st.mark("throughput", **rows)

    print("[cost_quality] COMPLETE")
    print(json.dumps(st.d, indent=1))
    return st.d


def main(argv=None) -> dict:
    args = parse_args(argv)
    sz = Sizes(args.ft_steps, args.fid_n, args.ssim_n)
    if args.smoke:
        sz = Sizes(128, 256, 128)
    return run(args.base, args.out, sz, device=args.device)


if __name__ == "__main__":
    main()
