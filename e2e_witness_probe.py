#!/usr/bin/env python3
"""Second witnesses for the full-width e2e validation (PERF.md §7): does the
recipe's training step diverge, and on which side.

    python3 e2e_witness_probe.py --where card [--steps 300] [--batch 128]
    JAX_PLATFORMS=cpu python3 e2e_witness_probe.py --where cpu [--steps 300] [--batch 16]

Two sides train one UNet from one init on the same batches (the e2e
driver's procedural data in its batch order) with the same noise and
antithetic timesteps at every step, as ``tools/e2e_validation`` trains: bf16
with f32 masters, Adam at 2e-4, global-norm clip 1, the EMA at 0.9999. Dropout
is off: its masks are the one draw the two sides cannot share.

* ``--where card``: the port on the card, its kernels on against off (the
  plain PyTorch versions), the 35.75M ddpm_cifar10 UNet.
* ``--where cpu``: the port against the JAX package on the CPU (plain
  versions on both sides), the e2e driver's 6.47M dev UNet, JAX's init
  carried to the port and JAX's own step drawing the noise and timesteps
  that the port's step is then given.

Every ``--every`` steps it prints, for each side, the mean train loss over
the window and the loss of its params and of its EMA on one held-out batch
(fixed noise and timesteps, f32); between the sides, the relative distance
of the params and of the EMAs, beside how far the params moved from the
init. The last line is a JSON object of it all.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def rel(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every array of two name -> array dicts."""
    num = sum(float(((np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)) ** 2).sum())
              for k in b)
    den = sum(float((np.asarray(b[k], np.float64) ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def port_side(cfg, state_dict, device, steps: int):
    """The port's model, train state and step (dropout off) from ``state_dict``."""
    import torch

    from diff_pruning_tpu_torch.models.unet2d import UNet2D
    from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
    from diff_pruning_tpu_torch.training.finetune import (TrainConfig, init_train_state,
                                                          make_train_step)

    model = UNet2D(cfg, device=device)
    model.load_state_dict(state_dict)
    sched = DiffusionSchedule.create(device=device)
    tcfg = TrainConfig(learning_rate=2e-4, mixed_precision="bf16", num_train_steps=steps)
    state = init_train_state(model, tcfg)
    return model, sched, state, make_train_step(model, sched, tcfg)


def port_eval(model, sched, weights, x0, noise, t) -> float:
    """The f32 DDPM loss of ``model`` holding ``weights`` (then restored)."""
    import torch

    from diff_pruning_tpu_torch.training.finetune import ddpm_loss

    keep = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.load_state_dict(weights)
    with torch.no_grad():
        loss = float(ddpm_loss(model, sched, x0, noise, t))
    model.load_state_dict(keep)
    return loss


def flat(sd) -> dict:
    from diff_pruning_tpu_torch.utils.checkpoint import flat_from_state_dict

    return flat_from_state_dict({k: v.detach() for k, v in sd.items()})


def card(args):
    import torch

    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.cli.ddpm_sample import pin_f32_precision
    from diff_pruning_tpu_torch.data.datasets import ArrayDataset, iterate_batches
    from diff_pruning_tpu_torch.data.procedural import make_procedural_dataset
    from diff_pruning_tpu_torch.models.unet2d import UNet2D, ddpm_cifar10_config
    from diff_pruning_tpu_torch.training.finetune import antithetic_timesteps

    pin_f32_precision()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(ddpm_cifar10_config(), dropout=0.0)
    init = UNet2D(cfg, device="cpu").init(torch.Generator().manual_seed(0)).state_dict()
    sides = {name: port_side(cfg, init, dev, args.steps) for name in ("on", "off")}
    init_flat = flat(init)
    data = ArrayDataset(make_procedural_dataset())
    batches = iterate_batches(data, args.batch, seed=0)
    x_ev = torch.from_numpy(next(iterate_batches(data, args.batch, seed=1))).to(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    n_ev = torch.randn(x_ev.shape, generator=g, device=dev)
    t_ev = antithetic_timesteps(g, args.batch, 1000)
    rows, losses = [], {name: [] for name in sides}
    secs = {name: 0.0 for name in sides}
    for i in range(args.steps):
        x = torch.from_numpy(next(batches)).to(dev)
        noise = torch.randn(x.shape, generator=g, device=dev)
        t = antithetic_timesteps(g, args.batch, 1000)
        for name, (model, sched, state, step) in sides.items():
            ops.set_kernels_enabled(name == "on")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(state, x, noise=noise, t=t)
            losses[name].append(float(m["loss"]))
            secs[name] += time.perf_counter() - t0
        ops.set_kernels_enabled(True)
        if (i + 1) % args.every == 0 or i + 1 == args.steps:
            rows.append(report(i + 1, args.every, sides, losses, init_flat, (x_ev, n_ev, t_ev)))
    return {"where": "card", "device": torch.cuda.get_device_name(0), "unet_params": sum(
        p.numel() for p in sides["on"][0].parameters()), "rows": rows,
        "step_seconds": secs}


def report(step, every, sides, losses, init_flat, ev):
    """One printed row: each port side's window loss and held-out losses,
    and the distances between the first two sides."""
    row = {"step": step}
    fl = {}
    for name, (model, sched, state, _) in sides.items():
        params = {k: v for k, v in model.state_dict().items()}
        row[f"{name}_train_loss"] = float(np.mean(losses[name][-every:]))
        row[f"{name}_eval_params"] = port_eval(model, sched, params, *ev)
        row[f"{name}_eval_ema"] = port_eval(model, sched, state.ema_params, *ev)
        fl[name] = (flat(params), flat(state.ema_params))
    a, b = list(fl)
    row["params_rel_dist"] = rel(fl[a][0], fl[b][0])
    row["ema_rel_dist"] = rel(fl[a][1], fl[b][1])
    row["params_moved_rel"] = rel(fl[b][0], init_flat)
    print(json.dumps(row), flush=True)
    return row


def cpu(args):
    import jax
    import jax.numpy as jnp
    import torch

    from diff_pruning_tpu.data.procedural import make_procedural_dataset
    from diff_pruning_tpu.data.datasets import ArrayDataset, iterate_batches
    from diff_pruning_tpu.models.unet2d import UNet2D as JUNet
    from diff_pruning_tpu.pruning.surgery import flatten_params
    from diff_pruning_tpu.schedulers.ddpm import DiffusionSchedule as JSched
    from diff_pruning_tpu.training import finetune as jft
    from diff_pruning_tpu_torch.tools.e2e_validation import model_config
    from diff_pruning_tpu_torch.utils.checkpoint import state_dict_from_flat

    cfg = dataclasses.replace(model_config(False), dropout=0.0)
    jmodel = JUNet(cfg)
    jparams = jmodel.init(jax.random.key(0))
    init_flat = {k: np.asarray(v) for k, v in flatten_params(jparams).items()}
    jsched = JSched.create()
    tcfg = jft.TrainConfig(learning_rate=2e-4, mixed_precision="bf16", num_train_steps=args.steps)
    jstate = jft.init_train_state(jparams, tcfg)
    jstep = jft.make_train_step(jmodel, jsched, tcfg)
    dev = torch.device("cpu")
    side = port_side(cfg, state_dict_from_flat(init_flat), dev, args.steps)
    model, sched, state, step = side
    data = ArrayDataset(make_procedural_dataset())
    batches = iterate_batches(data, args.batch, seed=0)
    x_ev = next(iterate_batches(data, args.batch, seed=1))
    k_ev = jax.random.split(jax.random.key(7))
    n_ev = np.asarray(jax.random.normal(k_ev[0], x_ev.shape, jnp.float32))
    t_ev = np.asarray(jft.antithetic_timesteps(k_ev[1], args.batch, 1000))
    ev_t = tuple(torch.from_numpy(np.asarray(a)) for a in (x_ev, n_ev, t_ev))
    jloss = jax.jit(lambda p: jft.ddpm_loss(jmodel, p, jsched, jnp.asarray(x_ev),
                                            jnp.asarray(n_ev), jnp.asarray(t_ev)))
    key = jax.random.key(1)
    rows, losses, secs = [], {"port": [], "jax": []}, {"port": 0.0, "jax": 0.0}
    for i in range(args.steps):
        x = next(batches)
        ki = jax.random.fold_in(key, i)
        t0 = time.perf_counter()
        jstate, jm = jstep(jstate, jnp.asarray(x), ki)
        losses["jax"].append(float(jm["loss"]))
        secs["jax"] += time.perf_counter() - t0
        # the draws JAX's step made (training/finetune.py's step_fn)
        nkey, tkey, _ = jax.random.split(ki, 3)
        noise = torch.from_numpy(np.asarray(jax.random.normal(nkey, x.shape, jnp.float32)))
        t = torch.from_numpy(np.asarray(jft.antithetic_timesteps(tkey, x.shape[0], 1000)))
        t0 = time.perf_counter()
        _, m = step(state, torch.from_numpy(x), noise=noise, t=t.long())
        losses["port"].append(float(m["loss"]))
        secs["port"] += time.perf_counter() - t0
        if (i + 1) % args.every == 0 or i + 1 == args.steps:
            jp = {k: np.asarray(v) for k, v in flatten_params(jstate.params).items()}
            je = {k: np.asarray(v) for k, v in flatten_params(jstate.ema_params).items()}
            row = {"step": i + 1}
            row["port_train_loss"] = float(np.mean(losses["port"][-args.every:]))
            row["jax_train_loss"] = float(np.mean(losses["jax"][-args.every:]))
            row["port_eval_params"] = port_eval(model, sched, model.state_dict(), *ev_t)
            row["port_eval_ema"] = port_eval(model, sched, state.ema_params, *ev_t)
            row["jax_eval_params"] = float(jloss(jstate.params))
            row["jax_eval_ema"] = float(jloss(jstate.ema_params))
            row["params_rel_dist"] = rel(flat(model.state_dict()), jp)
            row["ema_rel_dist"] = rel(flat(state.ema_params), je)
            row["params_moved_rel"] = rel(jp, init_flat)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return {"where": "cpu", "unet_params": sum(p.numel() for p in model.parameters()),
            "rows": rows, "step_seconds": secs}


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--where", choices=("card", "cpu"), required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=None, help="128 on the card, 16 on the CPU")
    ap.add_argument("--every", type=int, default=50)
    args = ap.parse_args()
    if args.batch is None:
        args.batch = 128 if args.where == "card" else 16
    out = card(args) if args.where == "card" else cpu(args)
    out.update(steps=args.steps, batch=args.batch)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
