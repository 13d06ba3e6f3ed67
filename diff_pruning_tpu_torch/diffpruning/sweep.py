"""The Diff-Pruning sweep: timestep-prefix Taylor gradient accumulation with
relative-loss early stopping.

Counterpart of ``diff_pruning_tpu/diffpruning/sweep.py`` (``make_loss_fn``,
``SweepResult``, ``accumulate_taylor_grads``). Reference semantics
(ddpm_prune.py:94-106, the paper's core loop):

    for step_k in 0..999:
        t = step_k (whole batch)
        noisy = add_noise(x0, eps, t)
        loss = mse(model(noisy, t), eps); loss.backward()   # grads ACCUMULATE
        loss_max = max(loss_max, loss)
        if loss < loss_max * thr: break                      # AFTER accumulating

Here it is one host loop, as the reference's: ``loss.backward()``
accumulates into the parameters' ``.grad``, and the early exit reads the
loss on the host each step (one device-to-host scalar per step). The JAX
package's single-program ``lax.while_loop`` variant exists only to avoid
host round-trips to the TPU and has no counterpart. On the card the
forward and backward go through the port's GroupNorm and attention kernels
(``ops``).

``thr=None`` runs a fixed number of steps (plain 'taylor' pruning).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..schedulers.ddpm import DiffusionSchedule


def make_loss_fn(model, schedule: DiffusionSchedule, loss_type: str = "mse") -> Callable:
    """(x0, noise, t) -> scalar DDPM noise-prediction loss of ``model``.

    ``loss_type``: 'mse' is the mean MSE of ddpm_prune.py:101 (torch
    F.mse_loss); 'sum' is ddpm_exp's sum-per-image, mean-over-batch
    (functions/losses.py:14-15). The error and its reduction are f32."""
    if loss_type not in ("mse", "sum"):
        raise ValueError(loss_type)

    def loss_fn(x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        out = model(schedule.add_noise(x0, noise, t), t)
        err = (out.to(torch.float32) - noise.to(torch.float32)) ** 2
        if loss_type == "mse":
            return err.mean()
        return err.sum(dim=(1, 2, 3)).mean()

    return loss_fn


@dataclasses.dataclass
class SweepResult:
    grads: Dict[str, torch.Tensor]  # parameter name -> accumulated grad (the .grad tensors)
    losses: np.ndarray  # per-step losses, f64 on the host
    steps_run: int


def accumulate_taylor_grads(
    model: torch.nn.Module,
    schedule: DiffusionSchedule,
    x0: torch.Tensor,
    noise: torch.Tensor,
    *,
    thr: Optional[float] = 0.05,
    max_steps: Optional[int] = None,
    loss_type: str = "mse",
    accumulate_abs: bool = False,
) -> SweepResult:
    """Accumulate d(loss)/d(param) over timesteps 0, 1, ... into the model's
    ``.grad`` (zeroed first), stopping after ``max_steps`` (default: every
    training timestep) or, with ``thr``, after the first step whose loss is
    below ``thr`` times the running maximum.

    ``accumulate_abs`` accumulates |grad| per timestep instead of the signed
    sum (the vendored AbsTaylorImportance's mode,
    ddpm_exp/torch_pruning/pruner/importance.py:553-670): each step's grads
    come from ``torch.autograd.grad`` and their absolute values are added.
    """
    T = schedule.num_train_timesteps if max_steps is None else max_steps
    loss_fn = make_loss_fn(model, schedule, loss_type)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    for p in params:
        p.grad = torch.zeros_like(p)
    losses = []
    loss_max = 0.0
    k = 0
    with torch.enable_grad():
        for k in range(T):
            t = torch.full((x0.shape[0],), k, dtype=torch.int64, device=x0.device)
            loss = loss_fn(x0, noise, t)
            if accumulate_abs:
                for p, g in zip(params, torch.autograd.grad(loss, params)):
                    p.grad.add_(g.abs())
            else:
                loss.backward()
            loss = float(loss.detach())
            losses.append(loss)
            if thr is not None:
                loss_max = max(loss_max, loss)
                if loss < loss_max * thr:
                    break
    return SweepResult({n: p.grad for n, p in named}, np.asarray(losses), k + 1)
