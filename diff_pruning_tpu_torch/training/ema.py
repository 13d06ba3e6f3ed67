"""EMA of the parameters, updated after each optimizer step.

Counterpart of ``diff_pruning_tpu/training/ema.py``: the reference's
constant-decay EMA, ``s = d * s + (1 - d) * p`` (diffusers EMAModel with
warmup off, training_utils.py:201,216; ddpm_exp's EMAHelper,
models/ema.py:41-47, mu = 0.9999). The JAX version maps the pytree to new
arrays; here the shadow tensors are updated in place by two ``_foreach``
calls, a few launches for all parameters on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch


def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float) -> None:
    """``ema[i] = decay * ema[i] + (1 - decay) * params[i]``, in place."""
    ema, params = list(ema), [p.detach() for p in params]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)
