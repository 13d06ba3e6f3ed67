"""DDIM/DDPM/PLMS/DPM-Solver++ sampling: counterpart of
``diff_pruning_tpu/sampling/ddim_sampler.py``.

The JAX sampler compiles the trajectory as one ``lax.scan``; here it is a
Python loop over the timesteps under ``torch.inference_mode()``, each step
one UNet forward and one f32 update. Kernel launches are asynchronous, so
the host enqueues steps while the card runs earlier ones.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.mesh import DataMesh, process_batch_slice
from ..parallel.tp import shard_for_sampler
from ..schedulers.ddim import ddim_prev_timesteps, ddim_step, ddim_timesteps, ddpm_step
from ..schedulers.ddpm import DiffusionSchedule
from ..schedulers.dpm_solver import dpm_solver_sample
from ..schedulers.plms import plms_sample


@dataclasses.dataclass
class SamplerConfig:
    num_inference_steps: int = 100
    skip_type: str = "uniform"  # 'uniform' | 'quad'
    style: str = "diffusers"  # timestep-sequence family; 'ddim_exp' for paper runs
    eta: float = 0.0
    clip_sample: bool = True  # DDIMScheduler default for DDPM checkpoints
    kind: str = "ddim"  # 'ddim' | 'ddpm' | 'plms' (ldm_exp plms.py) |
    # 'dpm' (DPM-Solver++ 2M, schedulers/dpm_solver.py); the last two need eta == 0
    diffusers_stride: bool = False  # root-pipeline prev-step quirk (scheduling_ddim.py:312)
    # UNet compute dtype; the DDIM/DDPM update always runs in f32
    dtype: str = "float32"


def make_sampler(model, schedule: DiffusionSchedule, cfg: SamplerConfig,
                 mesh: Optional[DataMesh] = None, tensor_parallel: bool = False,
                 model_axis: str = "model") -> Callable:
    """Returns ``sample(generator, batch_size, hw, channels, labels=None, *, x_T=None)``
    -> images in [0, 1], NHWC f32 on the model's device.

    ``x_T`` is the initial noise (B, hw, hw, C); without it the noise is
    drawn from ``generator``, as is the per-step noise of eta > 0 and of
    ``kind="ddpm"``. For a compute dtype other than f32 the sampler holds a
    copy of the model whose conv/linear weights are cast once. ``plms``
    calls the model S + 1 times, ``dpm`` S times.

    With ``mesh`` (``parallel/mesh.py``) the trajectory is split by rows, as
    the JAX sampler's over its data axis: ``batch_size``, ``labels`` and
    ``x_T`` are global, every noise is drawn at the global shape from the
    generator that each rank seeds alike, and the sampler returns this
    rank's rows of the images one process would draw.

    ``tensor_parallel`` (a 2-D mesh, ``make_mesh(model=m)``; ``model_axis``
    names its model axis as in JAX, and the port's has the one name,
    'model') shards ``model`` in place over the model axis by its
    ChannelGraph (``parallel/tp.py``): each rank holds its slice of every
    conv/linear out-axis that the axis size divides and computes that slice
    of the output; the ranks of a model axis share their rows. The sharded
    model is for inference only, and a later sampler without
    ``tensor_parallel`` refuses it.
    """
    if cfg.kind not in ("ddim", "ddpm", "plms", "dpm"):
        raise ValueError(f"unknown sampler kind {cfg.kind!r}")
    if cfg.kind in ("plms", "dpm") and cfg.eta != 0.0:
        # deterministic solvers: running them at eta = 0 would misreport the
        # sampler asked for (plms.py:49)
        raise ValueError(f"{cfg.kind} requires eta == 0")
    ts = ddim_timesteps(cfg.num_inference_steps, schedule.num_train_timesteps,
                        cfg.skip_type, style=cfg.style)
    prev = ddim_prev_timesteps(ts, schedule.num_train_timesteps,
                               diffusers_stride=cfg.diffusers_stride)
    steps = [(int(t), int(tp)) for t, tp in zip(ts, prev)]
    needs_noise = cfg.eta > 0.0 or cfg.kind == "ddpm"
    compute_dtype = getattr(torch, cfg.dtype)
    shard_for_sampler(model, mesh, tensor_parallel, model_axis)
    net = model
    if compute_dtype != torch.float32:
        net = copy.deepcopy(model).cast_compute_weights(compute_dtype)
    device = schedule.alphas_cumprod.device

    def sample(generator: Optional[torch.Generator], batch_size: int, hw: int,
               channels: int, labels: Optional[torch.Tensor] = None, *,
               x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.inference_mode():
            shape = (batch_size, hw, hw, channels)
            rows = slice(None) if mesh is None else slice(*process_batch_slice(mesh, batch_size))
            if x_T is None:
                x = torch.randn(shape, generator=generator, device=device)[rows]
            else:
                x = x_T.to(device=device, dtype=torch.float32)[rows]
            if labels is not None and mesh is not None:
                labels = labels[rows]
            rows_b = x.shape[0]
            if cfg.kind in ("plms", "dpm"):
                def eps_fn(x, t):
                    tb = torch.full((rows_b,), t, dtype=torch.int64, device=device)
                    return net(x.to(compute_dtype), tb, labels)

                if cfg.kind == "plms":
                    x = plms_sample(eps_fn, schedule, x, ts, prev,
                                    clip_sample=cfg.clip_sample)
                else:
                    x = dpm_solver_sample(eps_fn, schedule, x, ts, prev,
                                          clip_sample=cfg.clip_sample)
                return (x / 2.0 + 0.5).clamp(0.0, 1.0)
            for t, tp in steps:
                tb = torch.full((rows_b,), t, dtype=torch.int64, device=device)
                eps = net(x.to(compute_dtype), tb, labels)
                z = (torch.randn(shape, generator=generator, device=device)[rows]
                     if needs_noise else None)
                if cfg.kind == "ddim":
                    x = ddim_step(schedule, x, eps, t, tp, eta=cfg.eta,
                                  clip_sample=cfg.clip_sample, noise=z)
                else:
                    x = ddpm_step(schedule, x, eps, t, tp, z)
            # [-1,1] -> [0,1] like pipeline_ddim.py (image/2+0.5).clamp(0,1)
            return (x / 2.0 + 0.5).clamp(0.0, 1.0)

    return sample


def to_uint8(images) -> np.ndarray:
    """[0,1] float NHWC -> uint8 numpy (round half to even, as the JAX package)."""
    if torch.is_tensor(images):
        images = images.detach().cpu().numpy()
    arr = np.asarray(images, dtype=np.float32)
    return np.round(np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


def image_grid(images, nrow: int = 8) -> np.ndarray:
    """[0,1] float NHWC -> one uint8 grid, ``nrow`` images a row, 2-pixel white
    gaps (torchvision.utils.make_grid's layout)."""
    arr = to_uint8(images)
    n, h, w, c = arr.shape
    nr = (n + nrow - 1) // nrow
    pad = 2
    grid = np.full(((h + pad) * nr + pad, (w + pad) * nrow + pad, c), 255, np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        y0, x0 = pad + r * (h + pad), pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = arr[i]
    return grid.squeeze()


def save_image_grid(images, path: str, nrow: int = 8) -> None:
    """torchvision.utils.save_image equivalent (PIL)."""
    from PIL import Image

    Image.fromarray(image_grid(images, nrow)).save(path)


def save_images(images, outdir: str, start_index: int = 0) -> None:
    """PNG-encode a batch on a thread pool (zlib releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    os.makedirs(outdir, exist_ok=True)
    arr = to_uint8(images)

    def write(i):
        Image.fromarray(arr[i].squeeze()).save(
            os.path.join(outdir, f"{start_index + i:06d}.png"))

    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as ex:
        list(ex.map(write, range(len(arr))))
