"""The flagship full-scale recipe runner: the counterpart of the repository's
``tools/fullrun.py``, on the port's CLIs.

Runs the reference's headline CIFAR pipeline end to end at reference
hyperparameters, through the CLIs, with a SIGKILL of the finetune's process
group part-way and a resume from its crash-atomic checkpoint:

  data      procedural 50k-image 32x32 dataset (a stand-in for CIFAR-10,
            data/procedural.py)
  base      scratch-train the 35.75M ddpm_cifar10 UNet (cli.ddpm_train) from
            a seeded init written here
  basesample  same-seed grid + bulk base samples for SSIM/FID reference
  prune     diff-pruning thr=0.05 ratio=0.3 (cli.ddpm_prune; reference
            scripts/prune_ddpm_cifar10.sh)
  finetune  100k-step bs128 finetune (cli.ddpm_train; reference
            scripts/finetune_ddpm_cifar10.sh) in a child process, SIGKILLed
            once its metrics.jsonl reports --kill_at, then resumed from ckpt/
  sample    50k images to disk (cli.ddpm_sample)
  eval      FID against the dataset (random-init Inception, seed 0: a
            deterministic relative distance), same-seed SSIM against the
            base (cli.compute_ssim), for both base and pruned+finetuned

Each phase is recorded in <out>/fullrun_state.json, so a rerun continues
where it stopped. Each CLI's output goes to <out>/logs/<phase>.log. The
killed finetune is a child ``python -m``; every other CLI runs in this
process through its ``main(argv)``.

    python -m diff_pruning_tpu_torch.tools.fullrun --out run/fullrun           # the real thing
    python -m diff_pruning_tpu_torch.tools.fullrun --out run/fullrun_smoke --smoke
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

from . import _runner

TAG = "fullrun"
CLI = "diff_pruning_tpu_torch.cli."


@dataclasses.dataclass
class Sizes:
    """A run's step and sample counts. ``ddim_steps`` and
    ``prune_max_steps`` (a cap on the sweep, appended to the prune CLI's
    argv as ``--max_steps``; none by default) size a short run."""
    base_steps: int
    ft_steps: int
    kill_at: int
    total_samples: int
    save_every: int
    log_every: int
    bs: int
    ssim_n: int
    data_n: int
    ddim_steps: int = 100
    prune_max_steps: Optional[int] = None


SMOKE = Sizes(384, 512, 200, 512, 128, 64, 128, 128, 4096)
FULL = Sizes(30_000, 100_000, 37_000, 50_000, 1000, 100, 128, 1024, 50_000)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="run/fullrun")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny step counts, same phases/CLIs (orchestration "
                         "shakeout; minutes instead of hours)")
    ap.add_argument("--base_steps", type=int, default=None)
    ap.add_argument("--finetune_steps", type=int, default=None)
    ap.add_argument("--kill_at", type=int, default=None,
                    help="SIGKILL the finetune once metrics report this step")
    ap.add_argument("--total_samples", type=int, default=None)
    ap.add_argument("--data_n", type=int, default=50_000)
    ap.add_argument("--stop_after", "--stop-after", default=None,
                    choices=["basesample_fid", "basesample_fid_noeval"],
                    help="exit cleanly after this phase ('basesample_fid' runs "
                         "data/base/basesample/basesample_fid and the base FID "
                         "eval only; the _noeval variant skips the FID eval too, "
                         "for callers like tools/cost_quality.py that score the "
                         "base themselves against cached data stats)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of every CLI; 'cuda' raises when no GPU is present")
    return ap.parse_args(argv)


def sizes_of(args) -> Sizes:
    base = SMOKE if args.smoke else dataclasses.replace(FULL, data_n=args.data_n)
    return dataclasses.replace(
        base, base_steps=args.base_steps or base.base_steps,
        ft_steps=args.finetune_steps or base.ft_steps, kill_at=args.kill_at or base.kill_at,
        total_samples=args.total_samples or base.total_samples)


def init_base(model_dir: str) -> None:
    """The seeded initial ddpm_cifar10 UNet (generator seed 0, on the CPU),
    written as ``<model_dir>/unet``."""
    import torch

    from ..models.unet2d import UNet2D, ddpm_cifar10_config
    from ..utils.checkpoint import save_model

    cfg = ddpm_cifar10_config()
    save_model(model_dir, cfg, UNet2D(cfg, device="cpu").init(torch.Generator().manual_seed(0)),
               subfolder="unet")


def _sample_argv(model_dir, out_dir, sz: Sizes, n: int, seed: int):
    return [CLI + "ddpm_sample", "--model_path", model_dir, "--output_dir", out_dir,
            "--batch_size", str(sz.bs), "--total_samples", str(n),
            "--ddim_steps", str(sz.ddim_steps), "--skip_type", "quad", "--style", "ddim_exp",
            "--use_ema", "--dtype", "bfloat16", "--seed", str(seed)]


def run(out: str, sz: Sizes, *, device="cuda", stop_after: Optional[str] = None) -> dict:
    """Every phase not yet in ``<out>/fullrun_state.json``; returns the state."""
    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    logs = os.path.join(out, "logs")
    st = _runner.State(out, "fullrun_state.json")

    def sh(phase, argv, kill_at_step=None):
        return _runner.run(logs, phase, argv, device=device, tag=TAG,
                           kill_at_step=kill_at_step)

    def failed(phase):
        return _runner.tail_log(logs, phase)

    # ---- data ------------------------------------------------------------
    data_npz = os.path.join(out, "data.npz")
    if not st.done("data"):
        import numpy as np

        from ..data.procedural import make_procedural_dataset

        t0 = time.time()
        imgs = make_procedural_dataset(n=sz.data_n, hw=32, seed=0)
        np.savez_compressed(data_npz, images=imgs)
        st.mark("data", n=sz.data_n, secs=round(time.time() - t0, 1))

    # ---- base scratch train ---------------------------------------------
    base_init = os.path.join(out, "base_init")
    base_dir = os.path.join(out, "base")
    if not st.done("base"):
        if not os.path.exists(os.path.join(base_init, "unet", "params.npz")):
            init_base(base_init)
        rc, dt, _ = sh("base", [
            CLI + "ddpm_train",
            "--dataset", data_npz, "--model_path", base_init,
            "--output_dir", base_dir,
            "--train_batch_size", str(sz.bs), "--num_iters", str(sz.base_steps),
            "--learning_rate", "2e-4", "--dropout", "0.1",
            "--mixed_precision", "bf16",
            "--save_model_steps", str(sz.save_every), "--log_steps", str(sz.log_every),
        ])
        _runner.require(rc == 0, f"base train failed:\n{failed('base')}")
        st.mark("base", steps=sz.base_steps, secs=round(dt, 1))

    # ---- base samples (SSIM/FID reference) -------------------------------
    base_samples = os.path.join(out, "samples_base")
    if not st.done("basesample"):
        rc, dt, _ = sh("basesample", _sample_argv(base_dir, base_samples, sz, sz.ssim_n, 42))
        _runner.require(rc == 0, f"base sampling failed:\n{failed('basesample')}")
        st.mark("basesample", n=sz.ssim_n, secs=round(dt, 1))

    # ---- base samples at the FID count (equal footing with the pruned set:
    # seed 0, as many images) ----------------------------------------------
    base_fid_samples = os.path.join(out, "samples_base_fid")
    if not st.done("basesample_fid"):
        rc, dt, _ = sh("basesample_fid",
                       _sample_argv(base_dir, base_fid_samples, sz, sz.total_samples, 0))
        _runner.require(rc == 0, f"base FID sampling failed:\n{failed('basesample_fid')}")
        st.mark("basesample_fid", n=sz.total_samples, secs=round(dt, 1))

    if stop_after in ("basesample_fid", "basesample_fid_noeval"):
        if not st.done("eval_base_fid") and stop_after == "basesample_fid":
            rc, dt, fid = sh("fid_base_vs_data", [
                CLI + "fid_score", base_fid_samples, data_npz,
                "--random-init-seed", "0", "--batch-size", "256"])
            _runner.require(rc == 0, f"base FID failed:\n{failed('fid_base_vs_data')}")
            st.mark("eval_base_fid", fid_base_vs_data=float(fid))
        print("[fullrun] STOPPED after basesample_fid (equal-footing mode)")
        print(json.dumps(st.d, indent=1))
        return st.d

    # ---- prune -----------------------------------------------------------
    pruned_dir = os.path.join(out, "pruned")
    if not st.done("prune"):
        cap = [] if sz.prune_max_steps is None else ["--max_steps", str(sz.prune_max_steps)]
        rc, dt, res = sh("prune", [
            CLI + "ddpm_prune",
            "--dataset", data_npz,
            "--model_path", base_dir,
            "--save_path", pruned_dir,
            "--pruning_ratio", "0.3", "--pruner", "diff-pruning",
            "--thr", "0.05", "--batch_size", str(sz.bs),
        ] + cap)
        _runner.require(rc == 0, f"prune failed:\n{failed('prune')}")
        st.mark("prune", secs=round(dt, 1), steps_run=res["steps_run"],
                params=res["params"], macs=res["macs"])

    # ---- finetune with a SIGKILL part-way, then the resume -----------------
    ft_dir = os.path.join(out, "finetuned")
    ft_args = [
        CLI + "ddpm_train",
        "--dataset", data_npz, "--model_path", pruned_dir,
        "--output_dir", ft_dir,
        "--train_batch_size", str(sz.bs), "--num_iters", str(sz.ft_steps),
        "--learning_rate", "2e-4", "--dropout", "0.1",
        "--mixed_precision", "bf16",
        "--save_model_steps", str(sz.save_every), "--log_steps", str(sz.log_every),
    ]
    if not st.done("finetune_kill"):
        rc, dt, _ = sh("finetune", ft_args, kill_at_step=sz.kill_at)
        killed = rc != 0
        st.mark("finetune_kill", killed=killed, rc=rc, secs=round(dt, 1),
                last_step=_runner.last_step(os.path.join(ft_dir, "metrics.jsonl")))
        _runner.require(killed, "finetune finished before the scheduled kill")
    if not st.done("finetune"):
        rc, dt, res = sh("finetune", ft_args + [
            "--resume_from_checkpoint", os.path.join(ft_dir, "ckpt")])
        _runner.require(rc == 0, f"finetune resume failed:\n{failed('finetune')}")
        st.mark("finetune", steps=sz.ft_steps, secs=round(dt, 1),
                resumed_from=res["start_step"],
                last_step=_runner.last_step(os.path.join(ft_dir, "metrics.jsonl")))

    # ---- the FID sampling run ----------------------------------------------
    samples_dir = os.path.join(out, "samples_pruned")
    if not st.done("sample"):
        rc, dt, _ = sh("sample", _sample_argv(ft_dir, samples_dir, sz, sz.total_samples, 0))
        _runner.require(rc == 0, f"sampling failed:\n{failed('sample')}")
        st.mark("sample", n=sz.total_samples, secs=round(dt, 1))

    # same-seed grid for SSIM (seed 42, matching basesample)
    ssim_dir = os.path.join(out, "samples_pruned_seed42")
    if not st.done("ssimsample"):
        rc, dt, _ = sh("ssimsample", _sample_argv(ft_dir, ssim_dir, sz, sz.ssim_n, 42))
        _runner.require(rc == 0, f"ssim sampling failed:\n{failed('ssimsample')}")
        st.mark("ssimsample", secs=round(dt, 1))

    # ---- eval ------------------------------------------------------------
    if not st.done("eval"):
        evals = {}
        for tag, d in (("fid_pruned_vs_data", samples_dir),
                       ("fid_base_vs_data", base_fid_samples)):
            rc, dt, fid = sh(tag, [
                CLI + "fid_score", d, data_npz,
                "--random-init-seed", "0", "--batch-size", "256"])
            _runner.require(rc == 0, f"{tag} failed:\n{failed(tag)}")
            evals[tag] = float(fid)
        rc, dt, res = sh("ssim", [CLI + "compute_ssim", base_samples, ssim_dir])
        _runner.require(rc == 0, f"ssim failed:\n{failed('ssim')}")
        evals.update(sameseed_ssim=res["ssim"], sameseed_mse=res["mse"])
        st.mark("eval", **evals)

    print("[fullrun] COMPLETE")
    print(json.dumps(st.d, indent=1))
    return st.d


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(args.out, sizes_of(args), device=args.device, stop_after=args.stop_after)


if __name__ == "__main__":
    main()
