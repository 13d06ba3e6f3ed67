#!/usr/bin/env python3
"""Phase 21's f32 kernels-on/off gate of the first-stage train step, on other
codebooks, with the CPU as a second witness.

    python3 ae_gate_probe.py [--seeds 7] [--nudges 5] [--cpu-seeds 0] [--cpu-budget 400]
    python3 ae_gate_probe.py --rescore LOG   # the rules again, from a run's output

``chip_smoke.py`` phase 21 takes one vq-f4 train step (B = 12, 256 x 256,
f32, every loss term live) with the kernels on and off from the same state,
VQ lookups pinned, and holds total_loss, d_weight and disc_loss to
max(TRAIN_LOSS_RTOL, NOISE_FACTOR x the median of what AE_NUDGES one-ulp
nudges of the images move; once one nudge's). Its codebook is drawn
from the script's shared generator. This
script draws the codebook from each of ``--seeds`` seeds instead (the
model, discriminator, LPIPS and images as phase 21 makes them), and per
codebook runs the step kernels off, off on ``--nudges`` independent
one-ulp nudges, off again with the lookups replayed (what pinning alone
moves), and on, then on the CPU (the plain versions in another
summation order) for the ``--cpu-seeds`` codebooks whose gate ratio is
worst. It reports each quantity's relative distance between the runs, so
that a failing gate reads either as the kernels' fault (on far from both
f32 witnesses while they agree) or as the rule's (on, off and the CPU
equally far apart, beyond what a single nudge shows), and it scores each
rule max(TRAIN_LOSS_RTOL, factor x stat(the first k nudges' changes))
(median, max or mean, k 3 or all, factor 3, 5 or 10), and phase 21's
rule (10 x the median of 3, at most AE_GATE_CAP), against the one-nudge
rule: its allowance over the old one's (above 1: looser) on every codebook
and quantity, and the quantities it fails. Exits non-zero without a card;
prints nvidia-smi's name and power limit. ``--rescore`` reads the rows of
an earlier run's output (its last JSON line) and scores the rules on the
CPU, with no card.
"""

import argparse
import copy
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KEYS = ("total_loss", "d_weight", "disc_loss")


def rel(a, b):
    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in KEYS}


def mu_rel(a, b):
    """|a - b| / |b| over the generator's Adam first moments, in norm."""
    num = sum(float(((a[n].cpu() - t.cpu()) ** 2).sum()) for n, t in b.items())
    return math.sqrt(num / sum(float((t.cpu() ** 2).sum()) for t in b.values()))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, default=7)
    p.add_argument("--nudges", type=int, default=5)
    p.add_argument("--cpu-seeds", type=int, default=0)
    p.add_argument("--cpu-budget", type=float, default=400.0,
                   help="seconds of CPU witness after which no further one starts")
    p.add_argument("--rescore", metavar="LOG",
                   help="score the rules on the rows of an earlier run's output")
    args = p.parse_args()
    if args.rescore:
        sys.path.insert(0, REPO)
        import chip_smoke as cs

        with open(args.rescore) as f:
            rows = [json.loads(line) for line in f if line.startswith('{"card"')][-1]["rows"]
        rule_table(rows, cs)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ae_gate_probe: torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from diff_pruning_tpu_torch.eval.lpips import LPIPS, init_lpips_params
    from diff_pruning_tpu_torch.models.discriminator import NLayerDiscriminator
    from diff_pruning_tpu_torch.models.vae import first_stage_config, make_first_stage
    from diff_pruning_tpu_torch.ops import _build
    from diff_pruning_tpu_torch.training import autoencoder as AE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    gpu = cs.gpu_line()
    print(f"card: {gpu}", flush=True)
    t0 = time.perf_counter()
    _build.build_libraries()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    cfg = first_stage_config("vq-f4")
    model = make_first_stage(cfg, device="cpu").init(torch.Generator().manual_seed(0)).to(dev)
    tgen = torch.Generator(device=dev).manual_seed(21)
    images = torch.rand((cs.AE_B, cs.AE_RES, cs.AE_RES, 3), generator=tgen, device=dev) * 2 - 1
    disc = NLayerDiscriminator(input_nc=cfg.in_channels, device="cpu").init(
        torch.Generator().manual_seed(1)).to(dev)
    lpips = LPIPS(device="cpu")
    lpips.load_state_dict(init_lpips_params(torch.Generator().manual_seed(7)))
    lpips.to(dev)
    loss_cfg = AE.GANLossConfig(disc_start=0, disc_weight=0.5)
    with torch.no_grad():
        scale = model.encode(images[:2]).std()
    nudged = []
    for k in range(args.nudges):
        g = torch.Generator(device=dev).manual_seed(1000 + k)
        nudged.append(torch.where(torch.rand(images.shape, generator=g, device=dev) < 0.5,
                                  torch.nextafter(images, torch.full_like(images, 2.0)),
                                  torch.nextafter(images, torch.full_like(images, -2.0))))
    rows = []
    for seed in range(args.seeds):
        with torch.no_grad():
            cb = model.quantize.embedding.weight
            cb.copy_(torch.randn(cb.shape, generator=torch.Generator(device=dev).manual_seed(
                seed), device=dev) * scale)
        masters = [{n: p.detach().clone() for n, p in net.named_parameters()}
                   for net in (model, disc)]
        chosen = []
        t = time.perf_counter()
        m_off, mu_off, _, _ = cs.ae_step(model, disc, lpips, loss_cfg, masters, images, "no",
                                         chosen, replay=False, on=False)
        nud = [cs.ae_step(model, disc, lpips, loss_cfg, masters, x, "no", list(chosen),
                          replay=True, on=False) for x in nudged]
        m_rep, mu_rep, _, _ = cs.ae_step(model, disc, lpips, loss_cfg, masters, images, "no",
                                         list(chosen), replay=True, on=False)
        m_on, mu_on, _, launches = cs.ae_step(model, disc, lpips, loss_cfg, masters, images,
                                              "no", list(chosen), replay=True, on=True)
        gpu_s = time.perf_counter() - t
        r_on = rel(m_on, m_off)
        r_nud = [rel(m, m_off) for m, *_ in nud]
        # the gate of phase 21: the first nudge is the one it draws
        ratio = max(r_on[k] / max(cs.TRAIN_LOSS_RTOL, cs.NOISE_FACTOR * r_nud[0][k])
                    for k in KEYS)
        row = {"seed": seed, "metrics_off": m_off, "metrics_on": m_on, "rel_on_off": r_on,
               "rel_replayed_off": rel(m_rep, m_off),
               "mu_rel_replayed_off": mu_rel(mu_rep, mu_off),
               "rel_nudged_off": r_nud, "gate_ratio": ratio, "passes": ratio <= 1.0,
               "mu_rel_on_off": mu_rel(mu_on, mu_off),
               "mu_rel_nudged_off": [mu_rel(mu, mu_off) for _, mu, *_ in nud],
               "launches_on": launches, "gpu_s": gpu_s, "chosen": [c.cpu() for c in chosen]}
        rows.append(row)
        print(f"seed {seed}: on vs off {fmt(r_on)}; nudged vs off "
              + " | ".join(fmt(r) for r in r_nud)
              + f"; off replayed vs off {fmt(row['rel_replayed_off'])}"
              + f"; gate ratio {ratio:.3f} ({'passes' if ratio <= 1 else 'FAILS'}); Adam mu "
              f"on vs off {row['mu_rel_on_off']:.3e}, nudged "
              + ", ".join(f"{x:.3e}" for x in row["mu_rel_nudged_off"])
              + f"; {gpu_s:.1f} s", flush=True)
        row["masters"] = [{n: v.cpu() for n, v in m.items()} for m in masters]
        row["mu_off"], row["mu_on"] = ({n: v.cpu() for n, v in mu.items()}
                                       for mu in (mu_off, mu_on))
        row["metrics_nudged"] = [m for m, *_ in nud]
    print(json.dumps({"rules": rule_table(rows, cs)}), flush=True)
    # the CPU witness, worst gates first
    model_c, disc_c, lpips_c = (copy.deepcopy(m).cpu() for m in (model, disc, lpips))
    images_c = images.cpu()
    del model, disc, lpips
    torch.cuda.empty_cache()
    t_cpu = time.perf_counter()
    for row in sorted(rows, key=lambda r: -r["gate_ratio"])[:args.cpu_seeds]:
        if time.perf_counter() - t_cpu > args.cpu_budget:
            break
        t = time.perf_counter()
        m_cpu, mu_cpu, _, _ = cs.ae_step(model_c, disc_c, lpips_c, loss_cfg, row["masters"],
                                         images_c, "no", list(row["chosen"]), replay=True)
        row["cpu_s"] = time.perf_counter() - t
        row["metrics_cpu"] = m_cpu
        row["rel_cpu_off"] = rel(m_cpu, row["metrics_off"])
        row["rel_cpu_on"] = rel(m_cpu, row["metrics_on"])
        row["mu_rel_cpu_off"] = mu_rel(mu_cpu, row["mu_off"])
        row["mu_rel_cpu_on"] = mu_rel(mu_cpu, row["mu_on"])
        print(f"seed {row['seed']} CPU witness (plain, f32): cpu vs off {fmt(row['rel_cpu_off'])}"
              f"; cpu vs on {fmt(row['rel_cpu_on'])}; on vs off {fmt(row['rel_on_off'])}; Adam "
              f"mu cpu vs off {row['mu_rel_cpu_off']:.3e}, cpu vs on {row['mu_rel_cpu_on']:.3e},"
              f" on vs off {row['mu_rel_on_off']:.3e}; {row['cpu_s']:.1f} s", flush=True)
    keep = ("seed", "metrics_off", "metrics_on", "metrics_nudged", "metrics_cpu", "rel_on_off",
            "rel_replayed_off", "mu_rel_replayed_off", "rel_nudged_off", "rel_cpu_off",
            "rel_cpu_on", "gate_ratio", "passes", "mu_rel_on_off", "mu_rel_nudged_off", "mu_rel_cpu_off", "mu_rel_cpu_on",
            "launches_on", "gpu_s", "cpu_s")
    print(json.dumps({"card": gpu, "b": cs.AE_B, "rows": [
        {k: r[k] for k in keep if k in r} for r in rows]}))
    print(gpu)


def rule_table(rows, cs):
    """Each candidate floor rule against the one phase 21 had (NOISE_FACTOR x
    the first nudge's change): per codebook and quantity the allowance max(
    TRAIN_LOSS_RTOL, factor x stat(the first k nudges' changes)), its ratio to
    the old allowance (above 1: looser), and whether on against off passes."""
    import statistics

    stats = {"median": statistics.median, "max": max, "mean": statistics.fmean}
    k_all = len(rows[0]["rel_nudged_off"])
    rules = [(f"{factor}x{name}{k}", f"{factor} x {name} of {k} nudges", factor, stat, k,
              math.inf)
             for name, stat in stats.items() for k in sorted({3, k_all}) if k <= k_all
             for factor in (3, 5, 10)]
    rules.append(("phase21", f"{cs.NOISE_FACTOR} x median of {cs.AE_NUDGES} nudges, at most "
                  f"{cs.AE_GATE_CAP} (phase 21's)", cs.NOISE_FACTOR, statistics.median,
                  cs.AE_NUDGES, cs.AE_GATE_CAP))
    out = {}
    for tag, label, factor, stat, k, cap in rules:
        per = []
        for r in rows:
            for key in KEYS:
                old = max(cs.TRAIN_LOSS_RTOL, cs.NOISE_FACTOR * r["rel_nudged_off"][0][key])
                new = max(cs.TRAIN_LOSS_RTOL, min(factor * stat(
                    [n[key] for n in r["rel_nudged_off"][:k]]), cap))
                per.append({"seed": r["seed"], "key": key, "old": old, "new": new,
                            "looser": new / old, "on_off": r["rel_on_off"][key],
                            "passes_old": r["rel_on_off"][key] <= old,
                            "passes_new": r["rel_on_off"][key] <= new})
        seed0 = [x["looser"] for x in per if x["seed"] == 0]
        out[tag] = {"max_looser": max(x["looser"] for x in per), "seed0_looser": seed0,
                    "fails": [(x["seed"], x["key"]) for x in per if not x["passes_new"]],
                    "per": per}
        print(f"rule {label}: allowance / old allowance max {out[tag]['max_looser']:.3f}, at "
              "seed 0 " + ", ".join(f"{v:.3f}" for v in seed0) + f"; fails {out[tag]['fails']}",
              flush=True)
        if tag == "phase21":
            for x in per:
                print(f"  seed {x['seed']} {x['key']}: on vs off {x['on_off']:.3e}, allowed "
                      f"{x['new']:.3e} (old rule {x['old']:.3e})", flush=True)
    return out


def fmt(r):
    return ", ".join(f"{k} {v:.3e}" for k, v in r.items())


if __name__ == "__main__":
    main()
