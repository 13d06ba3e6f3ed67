"""Counterpart of ``diff_pruning_tpu/cli/ddpm_prune.py``: for now only its
checkpoint loader, which the sampling CLI shares. The prune CLI itself comes
with the pruning slice."""

from __future__ import annotations

import os


def load_unet(model_path: str):
    """Load ``(config, state_dict)`` from our layout: ``<path>/unet/params.npz``
    or ``<path>/params.npz``, each beside a ``config.json``.

    A diffusers directory (``diffusion_pytorch_model.bin``) is not read yet:
    that waits for the port of ``utils/convert.py``.
    """
    from ..utils.checkpoint import load_model

    for sub in ("unet", ""):
        if os.path.exists(os.path.join(model_path, sub, "params.npz")):
            return load_model(model_path, subfolder=sub)
    for sub in ("unet", ""):
        if os.path.exists(os.path.join(model_path, sub, "config.json")):
            raise NotImplementedError(
                f"{model_path}: diffusers-format checkpoints load once utils/convert.py "
                "is ported; convert with the JAX package's tools/convert_checkpoints.py")
    raise FileNotFoundError(f"no UNet checkpoint under {model_path}")
