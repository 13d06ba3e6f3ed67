"""DDPM forward process: beta schedules and ``add_noise``.

Counterpart of ``diff_pruning_tpu/schedulers/ddpm.py``. The beta schedules
are numpy and identical; ``DiffusionSchedule`` holds its constants as f32
tensors on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def betas_for_alpha_bar(num_steps: int, max_beta: float = 0.999) -> np.ndarray:
    """squaredcos_cap_v2 (Glide cosine) schedule (scheduling_ddpm.py)."""

    def alpha_bar(t):
        return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

    betas = []
    for i in range(num_steps):
        t1, t2 = i / num_steps, (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def get_beta_schedule(schedule: str = "linear", *, num_train_timesteps: int = 1000,
                      beta_start: float = 0.0001, beta_end: float = 0.02) -> np.ndarray:
    """'linear'/'scaled_linear'/'squaredcos_cap_v2' match diffusers;
    'quad'/'const'/'jsd'/'sigmoid' match ddpm_exp/runners/diffusion.py:28-58."""
    n = num_train_timesteps
    if schedule == "linear":
        betas = np.linspace(beta_start, beta_end, n, dtype=np.float64)
    elif schedule in ("scaled_linear", "quad"):
        betas = np.linspace(beta_start**0.5, beta_end**0.5, n, dtype=np.float64) ** 2
    elif schedule == "squaredcos_cap_v2":
        betas = betas_for_alpha_bar(n)
    elif schedule == "const":
        betas = beta_end * np.ones(n, dtype=np.float64)
    elif schedule == "jsd":  # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(n, 1, n, dtype=np.float64)
    elif schedule == "sigmoid":
        x = np.linspace(-6, 6, n)
        betas = 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(schedule)
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed diffusion constants (f32 tensors on one device)."""

    betas: torch.Tensor  # (T,)
    alphas_cumprod: torch.Tensor  # (T,)
    num_train_timesteps: int

    @classmethod
    def create(cls, *, num_train_timesteps: int = 1000, beta_schedule: str = "linear",
               beta_start: float = 0.0001, beta_end: float = 0.02,
               trained_betas: Optional[np.ndarray] = None,
               device="cpu") -> "DiffusionSchedule":
        if trained_betas is not None:
            betas = np.asarray(trained_betas, dtype=np.float64)
        else:
            betas = get_beta_schedule(beta_schedule, num_train_timesteps=num_train_timesteps,
                                      beta_start=beta_start, beta_end=beta_end)
        acp = np.cumprod(1.0 - betas)
        return cls(betas=torch.tensor(betas, dtype=torch.float32, device=device),
                   alphas_cumprod=torch.tensor(acp, dtype=torch.float32, device=device),
                   num_train_timesteps=num_train_timesteps)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """sqrt(a_t) x0 + sqrt(1-a_t) eps (scheduling_ddpm.py:408)."""
        a = self.alphas_cumprod[t].to(x0.dtype)
        a = a.reshape(a.shape + (1,) * (x0.ndim - a.ndim))
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    def alpha_bar(self, t) -> torch.Tensor:
        """alphas_cumprod[t], with t == -1 -> 1.0 (compute_alpha's zero-pad,
        ddpm_exp/functions/denoising.py:4-7). t: int or integer tensor on
        the schedule's device; an int indexes without a host-to-device copy."""
        acp = self.alphas_cumprod
        padded = torch.cat([torch.ones((1,), dtype=acp.dtype, device=acp.device), acp])
        return padded[t + 1]
