"""PLMS (pseudo linear multistep) sampling: counterpart of
``diff_pruning_tpu/schedulers/plms.py`` (ldm_exp/ldm/models/diffusion/plms.py).

Update rule (p_sample_plms, plms.py:224-235):
- step 0 (no history): pseudo improved Euler: a trial DDIM step with e_t,
  eps again at (x_trial, t_next), the two averaged;
- with 1, 2, 3+ steps of history: the 2nd/3rd/4th-order Adams-Bashforth
  combination of the raw eps history;
- x_prev always comes from the deterministic DDIM update (eta = 0) with the
  combined eps.

The JAX package runs the trajectory as one ``lax.scan``; here it is a host
loop over ``eps_fn`` calls, as the port's DDIM sampler loops. A trajectory
of S steps calls ``eps_fn`` S + 1 times.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .ddim import ddim_step
from .ddpm import DiffusionSchedule


def plms_combine(e_t: torch.Tensor, old: Sequence[torch.Tensor], count: int) -> torch.Tensor:
    """Adams-Bashforth eps combination (plms.py:227-235), f32. ``old`` is the
    eps history, newest first; ``count`` (>= 1) entries of it are used, at
    most 3."""
    e_t = e_t.to(torch.float32)
    o = [t.to(torch.float32) for t in old]
    n = min(count, 3)
    if n == 1:
        return (3.0 * e_t - o[0]) / 2.0
    if n == 2:
        return (23.0 * e_t - 16.0 * o[0] + 5.0 * o[1]) / 12.0
    return (55.0 * e_t - 59.0 * o[0] + 37.0 * o[1] - 9.0 * o[2]) / 24.0


def plms_sample(eps_fn: Callable, schedule: DiffusionSchedule, x: torch.Tensor,
                ts: Sequence[int], prev: Sequence[int], *,
                clip_sample: bool = False) -> torch.Tensor:
    """The whole PLMS trajectory. ``eps_fn(x, t) -> eps`` wraps the model
    (with any CFG batching); ``ts``/``prev`` are the descending timesteps and
    their predecessors (prev[i] == ts[i + 1], -1 last), as for DDIM.
    ``clip_sample`` clips x0 to [-1, 1] in every DDIM update."""
    ts, prev = [int(t) for t in ts], [int(t) for t in prev]
    t0, tp0 = ts[0], prev[0]
    # t_next is the next timestep of the descending sequence (for S == 1: t0)
    t_next = ts[1] if len(ts) > 1 else ts[0]
    e_t = eps_fn(x, t0)
    x_trial = ddim_step(schedule, x, e_t, t0, tp0, eta=0.0, clip_sample=clip_sample)
    e_next = eps_fn(x_trial, t_next)
    e_prime = (e_t.to(torch.float32) + e_next.to(torch.float32)) / 2.0
    x = ddim_step(schedule, x, e_prime, t0, tp0, eta=0.0, clip_sample=clip_sample)
    old = [e_t.to(torch.float32)]
    for t, tp in zip(ts[1:], prev[1:]):
        e_t = eps_fn(x, t)
        e_prime = plms_combine(e_t, old, len(old))
        x = ddim_step(schedule, x, e_prime, t, tp, eta=0.0, clip_sample=clip_sample)
        old = [e_t.to(torch.float32)] + old[:2]
    return x
