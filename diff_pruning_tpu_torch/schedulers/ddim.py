"""DDIM timestep schedules and the DDIM/DDPM update rules.

Counterpart of ``diff_pruning_tpu/schedulers/ddim.py``. The timestep
sequences are numpy and identical: diffusers-style (scheduling_ddim.py:257-268)
and ddpm_exp-style (runners/diffusion.py:502-509). Both update rules upcast
to f32 and return the sample's dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ddpm import DiffusionSchedule


def ddim_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000,
                   skip_type: str = "uniform", style: str = "diffusers") -> np.ndarray:
    """Descending timestep sequence t_S-1 > ... > t_0."""
    S, T = num_inference_steps, num_train_timesteps
    if style == "diffusers":
        if skip_type == "uniform":
            seq = np.round(np.arange(S) * ((T - 1) / (S - 1)))
        elif skip_type == "quad":
            seq = np.round(np.arange(S) ** 2 * ((T - 1) / (S - 1) ** 2))
        else:
            raise NotImplementedError(skip_type)
    elif style == "ddim_exp":
        if skip_type == "uniform":
            seq = np.arange(0, T, T // S)
        elif skip_type == "quad":
            seq = (np.linspace(0, np.sqrt(T * 0.8), S) ** 2).astype(np.int64)
        else:
            raise NotImplementedError(skip_type)
    else:
        raise ValueError(style)
    return seq[::-1].astype(np.int64).copy()


def ddim_prev_timesteps(timesteps: np.ndarray, num_train_timesteps: int = 1000,
                        diffusers_stride: bool = False) -> np.ndarray:
    """Previous-step indices aligned with ``timesteps`` (both descending):
    the true predecessor with a -1 terminator, or with ``diffusers_stride``
    scheduling_ddim.py:312's fixed ``t - T//S``."""
    if diffusers_stride:
        return timesteps - num_train_timesteps // len(timesteps)
    prev = np.empty_like(timesteps)
    prev[:-1] = timesteps[1:]
    prev[-1] = -1
    return prev


def _per_sample(a: torch.Tensor, ndim: int) -> torch.Tensor:
    return a.reshape((-1,) + (1,) * (ndim - 1)) if a.ndim else a


def ddim_step(schedule: DiffusionSchedule, sample: torch.Tensor, eps: torch.Tensor, t, t_prev,
              *, eta: float = 0.0, clip_sample: bool = False,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One DDIM update x_t -> x_{t_prev} (eq. 12/16; scheduling_ddim.py:312-390).

    t / t_prev are ints or (B,) integer tensors; t_prev == -1 means
    alpha_bar = 1 (final step).
    """
    at = _per_sample(schedule.alpha_bar(t).to(torch.float32), sample.ndim)
    at_prev = _per_sample(schedule.alpha_bar(t_prev).to(torch.float32), sample.ndim)
    x = sample.to(torch.float32)
    e = eps.to(torch.float32)
    x0 = (x - torch.sqrt(1.0 - at) * e) / torch.sqrt(at)
    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
        e = (x - torch.sqrt(at) * x0) / torch.sqrt(1.0 - at)
    if eta > 0.0:
        sigma = eta * torch.sqrt((1.0 - at_prev) / (1.0 - at)) * torch.sqrt(1.0 - at / at_prev)
    else:
        sigma = 0.0
    prev = torch.sqrt(at_prev) * x0 + torch.sqrt(1.0 - at_prev - sigma**2) * e
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires noise")
        prev = prev + sigma * noise.to(torch.float32)
    return prev.to(sample.dtype)


def ddpm_step(schedule: DiffusionSchedule, sample: torch.Tensor, eps: torch.Tensor, t, t_prev,
              noise: torch.Tensor) -> torch.Tensor:
    """Ancestral DDPM step (ddpm_exp/functions/denoising.py:35-67)."""
    at = _per_sample(schedule.alpha_bar(t).to(torch.float32), sample.ndim)
    atm1 = _per_sample(schedule.alpha_bar(t_prev).to(torch.float32), sample.ndim)
    beta_t = 1.0 - at / atm1
    x = sample.to(torch.float32)
    e = eps.to(torch.float32)
    x0 = (torch.sqrt(1.0 / at) * x - torch.sqrt(1.0 / at - 1.0) * e).clamp(-1.0, 1.0)
    mean = (torch.sqrt(atm1) * beta_t * x0
            + torch.sqrt(1.0 - beta_t) * (1.0 - atm1) * x) / (1.0 - at)
    if torch.is_tensor(t):
        mask = _per_sample((t > 0).to(torch.float32), sample.ndim)
    else:
        mask = float(int(t) > 0)
    logvar = torch.log(beta_t.clamp_min(1e-20))
    out = mean + mask * torch.exp(0.5 * logvar) * noise.to(torch.float32)
    return out.to(sample.dtype)
