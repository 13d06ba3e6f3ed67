"""Notebook and demo helpers: counterpart of ``diff_pruning_tpu/utils/notebook.py``,
the reference's ``ldm_exp/notebook_helpers.py`` (:19-268) and the
``latent_imagenet_diffusion.ipynb`` workflow.

  get_model(path_or_preset)        checkpoint dir or preset name -> LatentDiffusion
  sample_classes(ldm, ...)         CFG DDIM/PLMS/DPM grid over chosen classes, decoded
  run_superres(...) / run_inpaint(...)  concat-conditioned sampling tasks
  to_pil(images)                   [0,1] float NHWC -> PIL grid for display

The module holds its weights, so the helpers take the model where the JAX
ones take ``(model, params)``. Everything runs on the model's device, the
card unless the caller builds the model on the CPU (``device="cpu"``).
``jax.random`` streams cannot be drawn in torch: without the explicit
``x_T`` (initial noise) and ``noise`` (DDIM's per-step noise, eta > 0) the
helpers draw both from a ``torch.Generator`` seeded as the JAX helpers key
their samplers (``seed + i`` for class ``i``, ``seed`` for a concat task).
Nothing is downloaded: ``get_model`` takes a local checkpoint dir (the
layout of ``utils/checkpoint.py``) or builds a preset from a seeded init.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch


def _device_of(module) -> torch.device:
    return next(module.parameters()).device


def get_model(path_or_preset: str = "cin256-v2", seed: int = 0, device="cuda"):
    """A ``LatentDiffusion`` from a checkpoint dir (``load_ldm``), else the
    named ``UNetCond`` preset (e.g. ``cin256-v2``, ``tiny_cond``) with a class
    cond stage and no first stage, initialised from ``seed``
    (notebook_helpers.py get_model(:52-57); the download cannot run here)."""
    from ..models import unet_cond as uc
    from ..models.latent_diffusion import LatentDiffusion, load_ldm

    if os.path.isdir(path_or_preset):
        return load_ldm(path_or_preset, None, seed, device=device)
    preset_fns = {name[: -len("_config")]: getattr(uc, name)
                  for name in dir(uc) if name.endswith("_config")}
    key = path_or_preset.replace("-", "_")
    if key not in preset_fns:
        raise ValueError(f"{path_or_preset!r} is neither a checkpoint dir nor a preset; "
                         f"presets: {sorted(preset_fns)}")
    ldm = LatentDiffusion(preset_fns[key](), device=device)
    return ldm.init(torch.Generator(device=device).manual_seed(seed)).eval()


def sample_classes(ldm, classes: Sequence[int] = (25, 187, 448, 992), n_per_class: int = 4,
                   ddim_steps: int = 20, scale: float = 3.0, eta: float = 0.0,
                   method: str = "ddim", seed: int = 42, *,
                   x_T: Optional[torch.Tensor] = None,
                   noise: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
    """The latent_imagenet_diffusion.ipynb body: CFG-sample ``n_per_class``
    images of each class and decode them. Returns [0,1] float NHWC images,
    ``len(classes) * n_per_class`` rows, class-major.

    ``x_T`` (all rows, class-major) and ``noise`` (one tensor of all rows per
    DDIM step) replace the draws."""
    cfg = ldm.unet.cfg
    sample = ldm.make_cfg_sampler(ddim_steps=ddim_steps, guidance_scale=scale, eta=eta,
                                  method=method, latent_hw=cfg.image_size,
                                  latent_ch=cfg.in_channels)
    device = ldm.schedule.alphas_cumprod.device
    rows = []
    for i, cls in enumerate(classes):
        part = slice(i * n_per_class, (i + 1) * n_per_class)
        labels = torch.full((n_per_class,), int(cls), dtype=torch.int64, device=device)
        lat = sample(torch.Generator(device=device).manual_seed(seed + i), labels, n_per_class,
                     x_T=None if x_T is None else x_T[part],
                     noise=None if noise is None else [z[part] for z in noise])
        if ldm.first_stage is not None:
            rows.append(ldm.decode_first_stage(lat))
        else:
            rows.append((lat * 0.5 + 0.5).clamp(0.0, 1.0))
    return torch.cat(rows).cpu().numpy()


def _concat_task(unet, cond: np.ndarray, *, ddim_steps: int, eta: float, seed: int,
                 x_T: Optional[torch.Tensor], noise: Optional[Sequence[torch.Tensor]]):
    from ..models.latent_diffusion import ldm_schedule, make_concat_sampler

    device = _device_of(unet)
    latent_ch = unet.cfg.in_channels - cond.shape[-1]
    sample = make_concat_sampler(unet, ldm_schedule(device=device), ddim_steps=ddim_steps,
                                 eta=eta, latent_ch=latent_ch)
    out = sample(torch.Generator(device=device).manual_seed(seed),
                 torch.as_tensor(cond, device=device), x_T=x_T, noise=noise)
    return out.cpu().numpy()


def _unet(model):
    """A ``LatentDiffusion``'s UNet, or a bare ``UNetCond``: the concat-task
    models (inpainting_big, bsr_sr) have no cond stage, so users typically
    hold the bare UNet."""
    return getattr(model, "unet", model)


def run_superres(model, lowres: np.ndarray, *, ddim_steps: int = 100, eta: float = 1.0,
                 seed: int = 0, x_T: Optional[torch.Tensor] = None,
                 noise: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
    """Super-resolution task (notebook_helpers.py run(:131) with task='bsr'):
    the low-res image, in [-1, 1], concatenated onto the latent channels.
    ``lowres`` is [0,1] float NHWC at the model's sample size (upsample first:
    ``data/sr.py``'s interpolations). Returns the sampled latents."""
    cond = np.asarray(lowres, np.float32) * 2.0 - 1.0
    return _concat_task(_unet(model), cond, ddim_steps=ddim_steps, eta=eta, seed=seed,
                        x_T=x_T, noise=noise)


def run_inpaint(model, image: np.ndarray, mask: np.ndarray, *, ddim_steps: int = 100,
                eta: float = 1.0, seed: int = 0, x_T: Optional[torch.Tensor] = None,
                noise: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
    """Inpainting task: the masked image and the mask as concat conditioning
    (the inpainting_big contract; ``cli/inpaint.py`` is the full CLI)."""
    img = np.asarray(image, np.float32) * 2.0 - 1.0
    m = np.asarray(mask, np.float32)
    if m.ndim == 3:
        m = m[..., None]
    cond = np.concatenate([img * (1.0 - m), m], axis=-1)
    return _concat_task(_unet(model), cond, ddim_steps=ddim_steps, eta=eta, seed=seed,
                        x_T=x_T, noise=noise)


def to_pil(images, nrow: int = 4):
    """[0,1] float NHWC batch -> one PIL grid image (display(...) it): the
    port's ``to_uint8`` rounding, the sampling CLI's grid."""
    from PIL import Image

    from ..sampling.ddim_sampler import image_grid

    return Image.fromarray(image_grid(images, nrow))
