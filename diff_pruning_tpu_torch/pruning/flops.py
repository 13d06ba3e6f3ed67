"""MACs / params accounting.

Counterpart of ``count_params`` and ``count_ops_and_params`` in
``diff_pruning_tpu/pruning/flops.py``, with the reference's hook-based
counter semantics (ddpm_exp/torch_pruning/utils/op_counter.py): conv and
linear MACs only, attention bmms NOT counted. This is the number the paper
tables report (6.1G -> 3.4G on CIFAR). The JAX package's ``xla_flops``
(compiled-program FLOPs from XLA) has no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def count_ops_and_params(model: torch.nn.Module, sample_shape=(1, 32, 32, 3)) -> Tuple[int, int]:
    """(MACs per sample, params) of ``model`` with reference-counter semantics.

    Forward hooks on the port's ``Conv2D`` and ``Linear`` layers count, per
    call, kernel volume times output positions (conv: B * kh * kw * cin *
    cout * oh * ow; linear: positions * din * dout), as the JAX package's
    interceptors on ``lax.conv_general_dilated`` and ``Linear.__call__`` do,
    during one forward of ``sample_shape`` (NHWC) through a twin of ``model``
    on the ``meta`` device: shapes only, like the JAX package's
    ``jax.eval_shape``, so nothing runs and no kernel launches.
    """
    from ..models.layers import Conv2D, Linear

    macs = [0]

    def on_conv(mod, args, out):
        cout, cin, kh, kw = mod.kernel.shape
        macs[0] += int(out.shape[0]) * kh * kw * cin * cout * int(out.shape[2]) * int(out.shape[3])

    def on_linear(mod, args, out):
        x = args[0]
        dout, din = mod.kernel.shape
        macs[0] += int(np.prod(x.shape[:-1])) * din * dout

    twin = type(model)(model.cfg, device="meta")
    for m in twin.modules():
        if isinstance(m, (Conv2D, Linear)):
            m.register_forward_hook(on_conv if isinstance(m, Conv2D) else on_linear)
    with torch.no_grad():
        twin(torch.zeros(sample_shape, device="meta"),
             torch.zeros((sample_shape[0],), dtype=torch.int64, device="meta"))
    return macs[0] // sample_shape[0], count_params(model)
