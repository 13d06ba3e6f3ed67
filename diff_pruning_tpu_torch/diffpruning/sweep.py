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

``thr=None`` runs a fixed number of steps (plain 'taylor' pruning). With a
``mesh`` the sweep is data-parallel over ``torch.distributed``.

The LDM prune sweep (:func:`accumulate_ldm_grads`, the JAX package's
``cli/ldm_prune.py:153-187``, prune_ldm.py:104-131) differs in two ways:
each step takes its own latents, labels and noise (the CLI draws CFG
latents from the current model), and the ``thr`` test comes BEFORE the
backward, so the breaking step's grads are not accumulated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.unet2d import call_in_dtype
from ..parallel.mesh import DataMesh, all_reduce_mean, local_rows
from ..schedulers.ddpm import DiffusionSchedule


def make_loss_fn(model, schedule: DiffusionSchedule, loss_type: str = "mse",
                 compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """(x0, noise, t) -> scalar DDPM noise-prediction loss of ``model``.

    ``loss_type``: 'mse' is the mean MSE of ddpm_prune.py:101 (torch
    F.mse_loss); 'sum' is ddpm_exp's sum-per-image, mean-over-batch
    (functions/losses.py:14-15). The error and its reduction are f32.
    ``compute_dtype=torch.bfloat16`` runs the forward and backward with the
    params, x0 and noise cast to bf16 (``call_in_dtype``, the finetune
    step's mixed precision); the grads accumulate in the f32 params'
    ``.grad``."""
    if loss_type not in ("mse", "sum"):
        raise ValueError(loss_type)

    def loss_fn(x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if compute_dtype is None:
            out = model(schedule.add_noise(x0, noise, t), t)
        else:
            noisy = schedule.add_noise(x0.to(compute_dtype), noise.to(compute_dtype), t)
            out = call_in_dtype(model, compute_dtype, noisy, t)
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
    mesh: Optional[DataMesh] = None,
) -> SweepResult:
    """Accumulate d(loss)/d(param) over timesteps 0, 1, ... into the model's
    ``.grad`` (zeroed first), stopping after ``max_steps`` (default: every
    training timestep) or, with ``thr``, after the first step whose loss is
    below ``thr`` times the running maximum.

    ``accumulate_abs`` accumulates |grad| per timestep instead of the signed
    sum (the vendored AbsTaylorImportance's mode,
    ddpm_exp/torch_pruning/pruner/importance.py:553-670): each step's grads
    come from ``torch.autograd.grad`` and their absolute values are added.

    ``mesh`` (``parallel/mesh.py``) runs the sweep data-parallel, as the JAX
    ``accumulate_taylor_grads_scan(mesh=)``: ``x0`` and ``noise`` are the
    global batch and each rank takes its rows; every step's loss is averaged
    over the ranks before the ``thr`` test, so all stop at the same step,
    identical to one process; the signed sum is linear, so one all_reduce
    of the grads at the end gives the global batch's. With
    ``accumulate_abs`` it raises: the JAX package has |grad| only in its
    unsharded host loop.
    """
    if mesh is not None:
        if accumulate_abs:
            raise ValueError("accumulate_abs has no data-parallel sweep (the JAX package "
                             "accumulates |grad| only unsharded); run it without a mesh")
        x0, noise = local_rows(mesh, x0), local_rows(mesh, noise)
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
            loss = loss.detach()
            if mesh is not None:
                loss = loss.clone()
                all_reduce_mean(mesh, [loss])
            loss = float(loss)
            losses.append(loss)
            if thr is not None:
                loss_max = max(loss_max, loss)
                if loss < loss_max * thr:
                    break
    if mesh is not None:
        all_reduce_mean(mesh, [p.grad for p in params])
    return SweepResult({n: p.grad for n, p in named}, np.asarray(losses), k + 1)


def accumulate_ldm_grads(
    ldm,
    draw: Callable[[int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    *,
    max_steps: int,
    thr: Optional[float] = None,
    log_every: int = 0,
) -> SweepResult:
    """Accumulate d(loss)/d(unet param) of ``ldm.get_loss_at_t`` over
    timesteps 0, 1, ... into the UNet's ``.grad`` (zeroed first).

    ``draw(t)`` gives step t's ``(latents, labels, noise)``; latents drawn
    under ``torch.inference_mode()`` are cloned into normal tensors so that
    autograd can save them. With ``thr``, the running maximum takes the step's
    loss first, then a step whose loss is below ``thr`` times it stops the
    sweep before its backward: its grads are not added (the JAX CLI's order;
    ``thr=0`` never stops). ``losses`` holds every step's loss, the breaking
    step's included; ``log_every`` prints the JAX CLI's progress line every
    that many steps."""
    named = [(n, p) for n, p in ldm.unet.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    for p in params:
        p.grad = torch.zeros_like(p)
    losses = []
    max_loss = -1.0
    k = 0
    with torch.enable_grad():
        for k in range(max_steps):
            latents, labels, noise = draw(k)
            if latents.is_inference():
                latents = latents.clone()
            tb = torch.full((latents.shape[0],), k, dtype=torch.int64, device=latents.device)
            loss_t = ldm.get_loss_at_t(latents, labels, tb, noise)
            loss = float(loss_t.detach())
            losses.append(loss)
            max_loss = max(max_loss, loss)
            if thr is not None and loss / max_loss < thr:
                break
            loss_t.backward(inputs=params)
            if log_every and k % log_every == 0:
                print(f"  t={k} loss={loss:.5f} ratio={loss / max_loss:.3f}")
    return SweepResult({n: p.grad for n, p in named}, np.asarray(losses), k + 1)
