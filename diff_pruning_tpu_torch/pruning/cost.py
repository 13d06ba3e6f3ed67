"""Per-channel hardware cost of every ChannelVar, for cost-aware global pruning.

Counterpart of ``diff_pruning_tpu/pruning/cost.py``, with the same per-call
formulas. The reference ranks the global pool by importance alone, which
implicitly optimizes MACs; the cost model attributes to each var the
marginal cost of one of its channels, traced from one forward pass through
the model's own ``Conv2D`` and ``Linear`` layers:

  mode='macs'   d(MACs)/d(channel): kernel volume x output positions.
  mode='bytes'  d(memory bytes)/d(channel): activation read or write plus
                weight traffic per channel; ``dtype_bytes=2`` models the
                bf16 compute path.
  mode='hybrid' bytes + 2 x MACs / ``H100_FLOP_PER_BYTE``, a roofline blend:
                MACs count where they exceed what the card computes in the
                time it moves one byte.

Every cost is analytic, from shapes: forward hooks on the layers of a twin
of the model on the ``meta`` device (as ``pruning/flops.py`` counts MACs),
so nothing runs and no kernel launches. The pruner consumes the result as
``prune(..., cost_weights=...)``: global-mode candidates are ranked by
importance per unit cost.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .graph import ChannelVar, _parts_of

# NVIDIA H100 SXM data sheet: 989e12 dense bf16 FLOP/s over 3.35e12 B/s of
# HBM3, ~295 FLOP a byte. A data-sheet ratio, not a measurement of the card.
H100_FLOP_PER_BYTE = 989e12 / 3.35e12


def var_cost_weights(model: torch.nn.Module, sample_shape=(1, 32, 32, 3), *,
                     mode: str = "bytes", dtype_bytes: int = 2) -> Dict[str, float]:
    """{var name: cost per channel} of one forward of ``sample_shape`` (NHWC).

    Each ``Conv2D`` and ``Linear`` call charges its output var and its input
    var (each part of a concatenated input) the marginal cost of one of
    their channels; a var's cost is the sum over the calls it feeds or
    leaves. Only prunable vars are charged."""
    if mode not in ("macs", "bytes", "hybrid"):
        raise ValueError(f"unknown cost mode {mode!r}")
    from ..models.layers import Conv2D, Linear

    cost: Dict[str, float] = {}

    def add(v, amount) -> None:
        for part, _ in _parts_of(v):
            if isinstance(part, ChannelVar) and part.prunable:
                cost[part.name] = cost.get(part.name, 0.0) + amount

    def charge(out_var, in_var, macs_out, macs_in, by_out, by_in) -> None:
        if mode == "macs":
            add(out_var, macs_out)
            add(in_var, macs_in)
            return
        if mode == "hybrid":
            by_out += 2 * macs_out / H100_FLOP_PER_BYTE
            by_in += 2 * macs_in / H100_FLOP_PER_BYTE
        add(out_var, by_out)
        add(in_var, by_in)

    def on_conv(mod, args, out):  # NCHW in and out
        x = args[0]
        b, ih, iw = int(x.shape[0]), int(x.shape[2]), int(x.shape[3])
        oh, ow = int(out.shape[2]), int(out.shape[3])
        k2 = int(mod.kernel.shape[2]) * int(mod.kernel.shape[3])
        cin, cout = mod.cin.size, mod.cout.size
        charge(mod.cout, mod.cin, k2 * cin * oh * ow * b, k2 * cout * oh * ow * b,
               (oh * ow * b) * dtype_bytes + k2 * cin * dtype_bytes,
               (ih * iw * b) * dtype_bytes + k2 * cout * dtype_bytes)

    def on_linear(mod, args, out):
        n_pos = int(np.prod(args[0].shape[:-1]))
        din, dout = mod.din.size, mod.dout.size
        charge(mod.dout, mod.din, din * n_pos, dout * n_pos,
               n_pos * dtype_bytes + din * dtype_bytes,
               n_pos * dtype_bytes + dout * dtype_bytes)

    twin = type(model)(model.cfg, device="meta")
    for m in twin.modules():
        if isinstance(m, Conv2D):
            m.register_forward_hook(on_conv)
        elif isinstance(m, Linear):
            m.register_forward_hook(on_linear)
    with torch.no_grad():
        twin(torch.zeros(sample_shape, device="meta"),
             torch.zeros((sample_shape[0],), dtype=torch.int64, device="meta"))
    return cost
