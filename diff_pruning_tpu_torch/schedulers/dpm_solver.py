"""DPM-Solver++(2M): counterpart of ``diff_pruning_tpu/schedulers/dpm_solver.py``
(Lu et al. 2022, arXiv:2211.01095, the multistep data-prediction solver).

The first-order update is DDIM (eta = 0) exactly; the second-order one uses
the previous step's x0 prediction. The first and the last step take the
first-order update (lower_order_final). ``e^{-h}`` is the ratio
``(alpha_s sigma_t) / (sigma_s alpha_t)``, finite at the terminal step where
sigma -> 0. A host loop over ``eps_fn`` calls (one per step), in f32, where
the JAX package runs one ``lax.scan``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .ddpm import DiffusionSchedule


def _alpha_sigma(schedule: DiffusionSchedule, t: int):
    at = schedule.alpha_bar(t).to(torch.float32)
    return torch.sqrt(at), torch.sqrt(1.0 - at)


def dpm_solver_sample(eps_fn: Callable, schedule: DiffusionSchedule, x: torch.Tensor,
                      ts: Sequence[int], prev: Sequence[int], *,
                      clip_sample: bool = False) -> torch.Tensor:
    """The whole DPM-Solver++(2M) trajectory. ``eps_fn(x, t) -> eps`` wraps
    the model (with any CFG batching); ``ts``/``prev`` as for DDIM.
    ``clip_sample`` clips each x0 prediction to [-1, 1] and re-derives eps
    from it, as the DDIM step does."""
    ts, prev = [int(t) for t in ts], [int(t) for t in prev]
    n = len(ts)
    prev_x0 = prev_lam = None
    for i, (t, tp) in enumerate(zip(ts, prev)):
        a_c, s_c = _alpha_sigma(schedule, t)
        a_n, s_n = _alpha_sigma(schedule, tp)
        e = eps_fn(x, t).to(torch.float32)
        xf = x.to(torch.float32)
        x0 = (xf - s_c * e) / a_c
        if clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
            e = (xf - a_c * x0) / s_c
        lam_c = torch.log(a_c / s_c)
        if i == 0 or i == n - 1:
            nxt = a_n * x0 + s_n * e  # DDIM(eta=0)
        else:
            # 2M: D = x0 + (1 / (2 r)) (x0 - prev_x0), r = h_prev / h
            exp_neg_h = (a_c * s_n) / (s_c * a_n)
            lam_n = torch.log(a_n / torch.clamp(s_n, min=1e-20))
            r = (lam_c - prev_lam) / (lam_n - lam_c)
            d = x0 + (0.5 / r) * (x0 - prev_x0)
            nxt = (s_n / s_c) * xf - a_n * (exp_neg_h - 1.0) * d
        x = nxt.to(x.dtype)
        prev_x0, prev_lam = x0, lam_c
    return x
