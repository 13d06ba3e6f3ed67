"""Model checkpoints in the JAX package's layout, and the weight bridge.

A checkpoint is ``<dir>/unet/{config.json, params.npz}`` with flat
``a/b/kernel`` keys, exactly as ``diff_pruning_tpu/utils/checkpoint.py``
writes it, so checkpoints cross-load between the two packages.

The bridge maps a flat dict of numpy arrays to a ``state_dict`` and back.
The module tree is named after the JAX param tree, so keys map ``/`` <->
``.``; the only per-leaf transforms are for kernels: 4-D HWIO <-> OIHW and
2-D (din, dout) <-> (dout, din).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch


def state_dict_from_flat(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX-layout flat params -> ``state_dict`` (CPU tensors)."""
    out = {}
    for path, arr in flat.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if path.endswith("kernel"):
            if t.ndim == 4:
                t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
            elif t.ndim == 2:
                t = t.t()                  # (din, dout) -> (dout, din)
        out[path.replace("/", ".")] = t.contiguous()
    return out


def flat_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``state_dict`` -> JAX-layout flat params (numpy; bf16/f16 widened to f32)."""
    out = {}
    for key, t in state_dict.items():
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.to(torch.float32)
        if key.endswith("kernel"):
            if t.ndim == 4:
                t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
            elif t.ndim == 2:
                t = t.t()
        out[key.replace(".", "/")] = np.ascontiguousarray(t.numpy())
    return out


def save_params_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    np.savez(path, **flat_from_state_dict(state_dict))


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return state_dict_from_flat(flat)


def save_model(model_dir: str, config, model, subfolder: str = "unet") -> None:
    """diffusers-like layout: <dir>/<subfolder>/{config.json, params.npz}."""
    d = os.path.join(model_dir, subfolder) if subfolder else model_dir
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        f.write(config.to_json())
    save_params_npz(os.path.join(d, "params.npz"), model.state_dict())


def load_model(model_dir: str, subfolder: str = "unet", config_cls=None):
    """Returns ``(config, state_dict)``; load the state dict into
    ``UNet2D(config, device=...)``."""
    from ..models.unet2d import UNet2DConfig

    if config_cls is None:
        config_cls = UNet2DConfig
    d = os.path.join(model_dir, subfolder) if subfolder else model_dir
    if not os.path.exists(os.path.join(d, "config.json")) and subfolder:
        d = model_dir  # allow flat layout
    with open(os.path.join(d, "config.json")) as f:
        cfg = config_cls.from_json(f.read())
    return cfg, load_params_npz(os.path.join(d, "params.npz"))
