"""Trajectory and interpolation sampling: counterpart of
``diff_pruning_tpu/sampling/trajectories.py`` (ddpm_exp's
Diffusion.sample_sequence, runners/diffusion.py:429-450: every x_t along
the DDIM trajectory; sample_interpolation, :452-490: slerp between two
noises, then each interpolant denoised).

Both run DDIM at eta = 0 with ``ddim_step``'s default (no clipping), as a
host loop over the UNet under ``torch.inference_mode()``. The noise is the
caller's (``x_T``; ``z1``, ``z2``) or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..schedulers.ddim import ddim_prev_timesteps, ddim_step, ddim_timesteps
from ..schedulers.ddpm import DiffusionSchedule


def slerp(z1: torch.Tensor, z2: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation (diffusion.py:454-459): (len(alpha),) + z1.shape."""
    flat1, flat2 = z1.reshape(-1), z2.reshape(-1)
    theta = torch.arccos(torch.clamp(
        torch.dot(flat1, flat2) / (torch.linalg.norm(flat1) * torch.linalg.norm(flat2)),
        -1.0, 1.0))
    s = torch.sin(theta)
    a = alpha.reshape((-1,) + (1,) * z1.ndim)
    return torch.sin((1 - a) * theta) / s * z1[None] + torch.sin(a * theta) / s * z2[None]


def _ddim_steps(schedule: DiffusionSchedule, num_inference_steps: int, skip_type: str,
                style: str):
    ts = ddim_timesteps(num_inference_steps, schedule.num_train_timesteps, skip_type,
                        style=style)
    return [(int(t), int(tp)) for t, tp in zip(ts, ddim_prev_timesteps(ts))]


def _denoise(model, schedule: DiffusionSchedule, x: torch.Tensor, steps, states=None):
    for t, tp in steps:
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        x = ddim_step(schedule, x, model(x, tb), t, tp)
        if states is not None:
            states.append(x)
    return x


def sample_trajectory(model, schedule: DiffusionSchedule, *, batch_size: int, hw: int,
                      channels: int = 3, num_inference_steps: int = 100,
                      skip_type: str = "uniform", style: str = "ddim_exp",
                      generator: Optional[torch.Generator] = None,
                      x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every state of one DDIM trajectory, the initial noise first: (S + 1,
    B, H, W, C), mapped from [-1, 1] to [0, 1]. ``x_T`` is the initial noise;
    without it the noise is drawn from ``generator``."""
    device = schedule.alphas_cumprod.device
    with torch.inference_mode():
        if x_T is None:
            x = torch.randn((batch_size, hw, hw, channels), generator=generator, device=device)
        else:
            x = x_T.to(device=device, dtype=torch.float32)
        states = [x]
        _denoise(model, schedule, x, _ddim_steps(schedule, num_inference_steps, skip_type,
                                                 style), states)
        return (torch.stack(states) / 2.0 + 0.5).clamp(0.0, 1.0)


def sample_interpolation(model, schedule: DiffusionSchedule, *, hw: int, channels: int = 3,
                         n_alphas: int = 11, num_inference_steps: int = 100,
                         skip_type: str = "uniform", style: str = "ddim_exp",
                         generator: Optional[torch.Generator] = None,
                         z1: Optional[torch.Tensor] = None,
                         z2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Slerp from ``z1`` to ``z2`` (each (H, W, C); drawn from ``generator``
    where not given) at ``n_alphas`` alphas in [0, 1], then each interpolant
    denoised (diffusion.py:461-489): (n_alphas, H, W, C) in [0, 1]."""
    device = schedule.alphas_cumprod.device
    with torch.inference_mode():
        z1, z2 = (torch.randn((hw, hw, channels), generator=generator, device=device)
                  if z is None else z.to(device=device, dtype=torch.float32)
                  for z in (z1, z2))
        alphas = torch.from_numpy(np.arange(n_alphas, dtype=np.float32) / (n_alphas - 1))
        x = slerp(z1, z2, alphas.to(device))
        x = _denoise(model, schedule, x, _ddim_steps(schedule, num_inference_steps, skip_type,
                                                     style))
        return (x / 2.0 + 0.5).clamp(0.0, 1.0)
