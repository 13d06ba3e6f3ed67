"""Model checkpoints in the JAX package's layout, and the weight bridge.

A checkpoint is ``<dir>/unet/{config.json, params.npz}`` with flat
``a/b/kernel`` keys, exactly as ``diff_pruning_tpu/utils/checkpoint.py``
writes it, so checkpoints cross-load between the two packages.

The bridge maps a flat dict of numpy arrays to a ``state_dict`` and back,
and a model's accumulated grads to the same flat layout (``flat_grads``).
The module tree is named after the JAX param tree, so keys map ``/`` <->
``.``; the only per-leaf transforms are for kernels: 4-D HWIO <-> OIHW and
2-D (din, dout) <-> (dout, din).

An LDM model dir (``save_ldm``; read by ``models.latent_diffusion.load_ldm``)
is laid out as the JAX package writes it: ``unet/{config.json,
params.npz}``, ``cond_stage/params.npz`` (the class table,
``embedding/weight``; a BERTEmbedder's with its ``config.json``, as the JAX
``cli/txt2img.py`` reads it), ``first_stage/{config.json, params.npz}`` when
there is one, and ``ldm.json`` (n_classes, scale_factor and the schedule). A
CLIP dir (``clip/``, read by ``cli/train_searcher.py``'s ``load_clip``) is
``{config.json, params.npz}`` written by :func:`save_model`. Their leaves
need no transform beyond the kernels': LayerNorm ``scale``/``bias``,
embedding tables, CLIP's projections and class embedding and the VQ codebook
are the same arrays in both packages, the GEGLU ``proj/kernel``, 1x1 convs
and CLIP's patch conv are kernels.

Train state (``save_train_state``/``load_train_state``/``restore_opt_state``)
has the JAX package's on-disk layout too: ``<path>/step-N/`` holding
``params.npz``, ``ema_params.npz`` (flat JAX paths), ``opt_state.npz``
(optax's keypath strings, ``[1][0].mu['conv_in']['kernel']``) and
``meta.json``, written last and fsynced, with a ``LATEST`` pointer replaced
atomically. A JAX train checkpoint resumes in the port and the port's
restores in the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def state_dict_from_flat(flat: Mapping[str, np.ndarray],
                         device=None) -> Dict[str, torch.Tensor]:
    """JAX-layout flat params -> ``state_dict``: CPU tensors, or with
    ``device`` tensors there (each array copied over first, so that the
    kernels' transposes run on the device)."""
    out = {}
    for path, arr in flat.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device is not None:
            t = t.to(device)
        if path.endswith("kernel"):
            if t.ndim == 4:
                t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
            elif t.ndim == 2:
                t = t.t()                  # (din, dout) -> (dout, din)
        out[path.replace("/", ".")] = t.contiguous()
    return out


def flat_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``state_dict`` -> JAX-layout flat params (numpy; bf16/f16 widened to
    f32). The widening and the kernels' transposes run where the tensors
    are, before the copy to the host."""
    out = {}
    for key, t in state_dict.items():
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.to(torch.float32)
        if key.endswith("kernel"):
            if t.ndim == 4:
                t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
            elif t.ndim == 2:
                t = t.t()
        out[key.replace(".", "/")] = t.contiguous().cpu().numpy()
    return out


def flat_grads(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The grads bridge: the model's accumulated ``.grad`` tensors as flat
    JAX-layout numpy arrays (HWIO conv kernels, (din, dout) linear kernels),
    keyed like the params, by the transforms of :func:`flat_from_state_dict`.
    A parameter without a grad maps to zeros. Importance and surgery then run
    on the layout that the channel graph registers."""
    return flat_from_state_dict({
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()})


def save_params_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    np.savez(path, **flat_from_state_dict(state_dict))


def load_params_npz(path: str, device=None) -> Dict[str, torch.Tensor]:
    """A ``params.npz`` as a state dict, on ``device`` when given (CPU)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return state_dict_from_flat(flat, device)


def save_model(model_dir: str, config, model, subfolder: str = "unet") -> None:
    """diffusers-like layout: <dir>/<subfolder>/{config.json, params.npz}.
    ``model`` is a module or a state dict."""
    d = os.path.join(model_dir, subfolder) if subfolder else model_dir
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        f.write(config.to_json())
    state = model if isinstance(model, Mapping) else model.state_dict()
    save_params_npz(os.path.join(d, "params.npz"), state)


def load_model(model_dir: str, subfolder: str = "unet", config_cls=None, device=None):
    """Returns ``(config, state_dict)``, the state dict on ``device`` when
    given (CPU); load it into ``UNet2D(config, device=...)``."""
    from ..models.unet2d import UNet2DConfig

    if config_cls is None:
        config_cls = UNet2DConfig
    d = os.path.join(model_dir, subfolder) if subfolder else model_dir
    if not os.path.exists(os.path.join(d, "config.json")) and subfolder:
        d = model_dir  # allow flat layout
    with open(os.path.join(d, "config.json")) as f:
        cfg = config_cls.from_json(f.read())
    return cfg, load_params_npz(os.path.join(d, "params.npz"), device)


def save_ldm(model_dir: str, ldm, *, with_unet: bool = True) -> None:
    """Writes ``ldm`` (a ``models.latent_diffusion.LatentDiffusion``) as a
    model dir in the JAX package's layout (its ``cli/ldm_prune.py`` save and
    ``write_ldm_meta``); without ``with_unet``, every part but ``unet/``
    (the LDM train CLI writes those once and the UNet at every save)."""
    if with_unet:
        save_model(model_dir, ldm.unet.cfg, ldm.unet, subfolder="unet")
    if hasattr(ldm.cond_stage, "cfg"):  # a text encoder: its config too
        save_model(model_dir, ldm.cond_stage.cfg, ldm.cond_stage, subfolder="cond_stage")
    else:
        os.makedirs(os.path.join(model_dir, "cond_stage"), exist_ok=True)
        save_params_npz(os.path.join(model_dir, "cond_stage", "params.npz"),
                        ldm.cond_stage.state_dict())
    if ldm.first_stage is not None:
        save_model(model_dir, ldm.first_stage.cfg, ldm.first_stage, subfolder="first_stage")
    with open(os.path.join(model_dir, "ldm.json"), "w") as f:
        json.dump({"n_classes": ldm.n_classes, "scale_factor": ldm.scale_factor,
                   "num_train_timesteps": ldm.schedule.num_train_timesteps,
                   "linear_start": ldm.linear_start, "linear_end": ldm.linear_end}, f, indent=2)


def save_train_state(path: str, *, step: int, params: Mapping[str, torch.Tensor],
                     ema_params: Optional[Mapping[str, torch.Tensor]] = None,
                     opt_state=None, extra_meta: Optional[dict] = None,
                     keep: int = 2) -> None:
    """Writes ``<path>/step-<step>/`` and points ``LATEST`` at it; keeps the
    newest ``keep`` committed versions. ``params``/``ema_params`` are state
    dicts; ``opt_state`` is an object with ``by_keypath()``
    (``training.finetune.OptState``); ``extra_meta`` records what resume
    needs beyond tensors (seed, batches consumed).

    Crash-atomic as the JAX version: ``meta.json`` is written and fsynced
    last, so a step dir without it is a torn save; ``LATEST`` is replaced
    only after every file is on disk."""
    d = os.path.join(path, f"step-{int(step)}")
    os.makedirs(d, exist_ok=True)
    save_params_npz(os.path.join(d, "params.npz"), params)
    if ema_params is not None:
        save_params_npz(os.path.join(d, "ema_params.npz"), ema_params)
    if opt_state is not None:
        np.savez(os.path.join(d, "opt_state.npz"), **opt_state.by_keypath())
    meta = {"step": int(step), **(extra_meta or {})}
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    tmp = os.path.join(path, ".LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(f"step-{int(step)}")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, "LATEST"))
    # delete torn dirs (no meta.json), then all but the newest `keep`
    # committed versions; never the one LATEST points to
    committed = []
    for e in os.listdir(path):
        if not e.startswith("step-") or e == f"step-{int(step)}":
            continue
        if os.path.exists(os.path.join(path, e, "meta.json")):
            committed.append(e)
        else:
            shutil.rmtree(os.path.join(path, e), ignore_errors=True)
    committed.sort(key=lambda e: int(e.split("-")[1]))
    for e in committed[:-(keep - 1)] if keep > 1 else committed:
        shutil.rmtree(os.path.join(path, e), ignore_errors=True)


def _resolve_ckpt_dir(path: str, step: Optional[int] = None) -> str:
    """The version ``LATEST`` points to, or with ``step`` that version (the
    autoencoder trainer loads its discriminator at the generator's step); a
    single version (a ``step-N/`` directory, or meta.json directly inside)
    resolves to itself."""
    if step is not None:
        d = os.path.join(path, f"step-{int(step)}")
        if os.path.isdir(d):
            return d
        if os.path.exists(os.path.join(path, "LATEST")):
            avail = sorted(e for e in os.listdir(path) if e.startswith("step-"))
            raise FileNotFoundError(f"{path}: no step-{int(step)} version (available: {avail})")
        return path
    latest = os.path.join(path, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            return os.path.join(path, f.read().strip())
    return path


def restore_opt_state(path: str, opt_state_template, step: Optional[int] = None):
    """Fills ``opt_state_template`` (a fresh ``OptState``) in place from the
    saved ``opt_state.npz`` (of version ``step``, default ``LATEST``'s),
    matched by keypath; raises on a missing path.
    Returns ``(state, True)``, or ``(template, False)`` when the checkpoint
    holds no optimizer state. The JAX package's legacy positional archives
    ('0', '1', ...) are not read."""
    opt_path = os.path.join(_resolve_ckpt_dir(path, step), "opt_state.npz")
    if not os.path.exists(opt_path):
        return opt_state_template, False
    with np.load(opt_path) as z:
        if z.files and all(k.isdigit() for k in z.files):
            raise ValueError(f"{opt_path}: a positional (legacy) optimizer archive; the port "
                             "restores keypath archives only")
        opt_state_template.load_by_keypath({k: z[k] for k in z.files}, where=opt_path)
    return opt_state_template, True


def load_train_state(path: str, step: Optional[int] = None):
    """Returns ``(meta, params, ema_params | None)`` of version ``step``
    (default ``LATEST``'s), the tensors as state dicts (CPU). The optimizer
    state comes from :func:`restore_opt_state`."""
    path = _resolve_ckpt_dir(path, step)
    params = load_params_npz(os.path.join(path, "params.npz"))
    ema_path = os.path.join(path, "ema_params.npz")
    ema = load_params_npz(ema_path) if os.path.exists(ema_path) else None
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return meta, params, ema
