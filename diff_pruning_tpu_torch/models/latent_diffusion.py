"""LatentDiffusion, the CompVis LDM wrapper: counterpart of
``diff_pruning_tpu/models/latent_diffusion.py`` (the class-conditional
``cin256-v2`` ImageNet model, ldm_exp/ldm/models/diffusion/ddpm.py).

Sqrt-spaced linear betas (linear_start 0.0015, linear_end 0.0195),
ClassEmbedder conditioning (uncond class = n_classes - 1), and
classifier-free-guidance sampling (ddim.py:164-203: eps = e_uc + scale
(e_c - e_uc), cond and uncond rows through one UNet call) by DDIM, PLMS or
DPM-Solver++(2M), as host loops over the UNet under
``torch.inference_mode()``.

``get_loss_at_t`` is the loss of the LDM prune sweep (``cli/ldm_prune.py``,
``diffpruning/sweep.py``): p_losses at the caller's t, the mean MSE in f32,
differentiable through the port's kernels on the card. ``train_loss`` is
the LDM train step's (``cli/ldm_train.py``): images encoded by the frozen
first stage, labels dropped to the uncond class by a mask, in f32 or bf16.

The unconditional models (``cli/sample_diffusion.py``) and the inpainting
model (``cli/inpaint.py``) sample through ``make_concat_sampler``:
conditioning planes ride along the channel axis (none for the unconditional
case). ``SpatialRescaler``, ``IdentityCondStage`` (the RDM's: precomputed
CLIP embeddings, ``cli/knn2img.py``) and the BERTEmbedder
(``models/text_encoder.py``, ``cli/txt2img.py``) are the other cond stages
of the CompVis configs; a text or retrieval model's CFG uncond rows are the
cond stage applied to ``uncond_input`` (the empty prompt's tokens, or zero
embeddings).

The CFG sampler's ``mesh`` splits a batch by rows over data-parallel ranks
(``parallel/mesh.py``), and its ``tensor_parallel`` splits the UNet's
channels over a model axis (``parallel/tp.py``).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import process_batch_slice
from ..parallel.tp import shard_for_sampler
from ..schedulers.ddim import ddim_prev_timesteps, ddim_step
from ..schedulers.ddpm import DiffusionSchedule
from ..schedulers.dpm_solver import dpm_solver_sample
from ..schedulers.plms import plms_sample
from .unet_cond import UNetCond, UNetCondConfig, cin256_v2_config


def ldm_schedule(num_train_timesteps: int = 1000, linear_start: float = 0.0015,
                 linear_end: float = 0.0195, device="cpu") -> DiffusionSchedule:
    """CompVis make_beta_schedule('linear'): sqrt-spaced (util.py)."""
    return DiffusionSchedule.create(num_train_timesteps=num_train_timesteps,
                                    beta_schedule="scaled_linear", beta_start=linear_start,
                                    beta_end=linear_end, device=device)


def compvis_ddim_timesteps(num_steps: int, num_train_timesteps: int = 1000) -> np.ndarray:
    """make_ddim_timesteps('uniform'): arange(0, T, T // S) + 1, descending."""
    c = num_train_timesteps // num_steps
    seq = np.arange(0, num_train_timesteps, c) + 1
    return seq[::-1].astype(np.int64).copy()


def _compvis_solver(schedule: DiffusionSchedule, ddim_steps: int, eta: float,
                    method: str) -> Callable:
    """The trajectory both LDM samplers run over ``compvis_ddim_timesteps``:
    returns ``solve(eps_fn, shape, generator, x_T, noise, rows) -> latents`` f32.
    ``x_T`` is the initial noise and ``noise[i]`` DDIM's at step i (eta > 0);
    what is not given is drawn from ``generator``. ``shape``, ``x_T`` and
    ``noise`` are the global batch's; the trajectory runs on its ``rows``
    (a data-parallel rank's, every draw still at the global shape). 'ddim', 'plms' (S + 1
    ``eps_fn`` calls) or 'dpm' (DPM-Solver++(2M)); the last two need eta == 0.
    Never clips."""
    if method not in ("ddim", "plms", "dpm"):
        raise ValueError(f"unknown method {method!r}")
    if method in ("plms", "dpm") and eta != 0.0:
        raise ValueError(f"{method} requires eta == 0")
    ts = compvis_ddim_timesteps(ddim_steps, schedule.num_train_timesteps)
    prev = ddim_prev_timesteps(ts)
    device = schedule.alphas_cumprod.device

    def solve(eps_fn: Callable, shape, generator: Optional[torch.Generator],
              x_T: Optional[torch.Tensor] = None,
              noise: Optional[Sequence[torch.Tensor]] = None,
              rows: slice = slice(None)) -> torch.Tensor:
        x = (torch.randn(shape, generator=generator, device=device) if x_T is None
             else x_T.to(device=device, dtype=torch.float32))[rows]
        if method == "plms":
            return plms_sample(eps_fn, schedule, x, ts, prev)
        if method == "dpm":
            return dpm_solver_sample(eps_fn, schedule, x, ts, prev)
        for i, (t, tp) in enumerate(zip(ts.tolist(), prev.tolist())):
            z = None
            if eta > 0:
                z = (torch.randn(shape, generator=generator, device=device) if noise is None
                     else noise[i].to(device=device, dtype=torch.float32))[rows]
            x = ddim_step(schedule, x, eps_fn(x, t), t, tp, eta=eta, noise=z)
        return x

    return solve


class ClassEmbedder(nn.Module):
    """ldm/modules/encoders/modules.py ClassEmbedder: an embedding table ->
    (B, 1, embed_dim) context; class n_classes - 1 is the CFG uncond. Param
    ``embedding/weight`` (n_classes, embed_dim)."""

    def __init__(self, n_classes: int, embed_dim: int, *, device):
        super().__init__()
        self.n_classes, self.embed_dim = n_classes, embed_dim
        self.embedding = nn.Module()
        self.embedding.weight = nn.Parameter(torch.empty((n_classes, embed_dim),
                                                         device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return self.embedding.weight[labels][:, None, :]


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel at a = -0.5 (jax.image's 'cubic'; torch's bicubic
    uses a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _resize_weights(n_in: int, n_out: int, kernel: Callable, device) -> torch.Tensor:
    """(n_in, n_out) f32 weights of one axis of ``jax.image.resize`` (its
    ``compute_weight_mat``, antialiased): half-pixel centres, the kernel
    widened by the downsampling factor, each output's weights normalised over
    the input, zero where the output's centre lies outside it."""
    inv_scale = 1.0 / (n_out / n_in)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
         ).abs() / max(inv_scale, 1.0)
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


class SpatialRescaler(nn.Module):
    """ldm/modules/encoders/modules.py:106-135: ``n_stages`` resizes of the
    NHWC input by ``multiplier``, then an optional 1x1 ``channel_mapper``
    (params ``channel_mapper/kernel`` and, with ``bias``,
    ``channel_mapper/bias``, as in the JAX package). The resizes compute what
    ``jax.image.resize`` does: 'nearest' takes the floor index (torch's
    F.interpolate nearest), the others its antialiased triangle ('linear',
    'bilinear', 'trilinear', 'area') or Keys cubic ('bicubic') filter. The
    kernel is held OIHW, as the port's convolutions, and crosses to the JAX
    package's HWIO through ``utils/checkpoint.py``."""

    _KERNELS = {"nearest": None, "linear": _triangle, "bilinear": _triangle,
                "trilinear": _triangle, "bicubic": _keys_cubic, "area": _triangle}

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels: Optional[int] = None, bias: bool = False,
                 *, device):
        super().__init__()
        if n_stages < 0:
            raise ValueError(f"n_stages must be >= 0, got {n_stages}")
        if method not in self._KERNELS:
            raise ValueError(f"unknown method {method!r}")
        self.n_stages, self.method, self.multiplier = n_stages, method, multiplier
        self.channel_mapper = None
        if out_channels is not None:
            self.channel_mapper = nn.Module()
            self.channel_mapper.kernel = nn.Parameter(
                torch.empty((out_channels, in_channels, 1, 1), device=device))
            if bias:
                self.channel_mapper.bias = nn.Parameter(torch.zeros((out_channels,),
                                                                    device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.channel_mapper is not None:
            with torch.no_grad():
                self.channel_mapper.kernel.normal_(0.0, 0.02, generator=generator)
                if hasattr(self.channel_mapper, "bias"):
                    self.channel_mapper.bias.zero_()

    def _resize(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        oh, ow = int(h * self.multiplier), int(w * self.multiplier)
        if self.method == "nearest":
            iy = torch.arange(oh, device=x.device) * h // oh
            ix = torch.arange(ow, device=x.device) * w // ow
            return x[:, iy][:, :, ix]
        kernel = self._KERNELS[self.method]
        if not x.is_floating_point():
            x = x.to(torch.float32)
        if oh != h:  # jax.image.resize skips the axes whose size stays
            x = torch.einsum("bhwc,hH->bHwc", x, _resize_weights(h, oh, kernel, x.device)
                             .to(x.dtype))
        if ow != w:
            x = torch.einsum("bhwc,wW->bhWc", x, _resize_weights(w, ow, kernel, x.device)
                             .to(x.dtype))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_stages):
            x = self._resize(x)
        if self.channel_mapper is not None:
            x = x @ self.channel_mapper.kernel[:, :, 0, 0].t().to(x.dtype)
            if hasattr(self.channel_mapper, "bias"):
                x = x + self.channel_mapper.bias.to(x.dtype)
        return x


class IdentityCondStage(nn.Module):
    """``cond_stage_config: torch.nn.Identity`` (the RDM yaml,
    configs/retrieval-augmented-diffusion/768x768.yaml): the conditioning is
    handed to the UNet as given; no parameters."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        return cond


class LatentDiffusion(nn.Module):
    """(UNetCond ``unet``, cond stage ``cond_stage``, optional first stage
    ``first_stage``) and the schedule; the pruning target is the unet. The
    state dict's top-level keys are the JAX param tree's (``unet``,
    ``cond_stage``, ``first_stage``). ``cond_stage`` is any module with
    ``reset_parameters(generator)`` whose forward maps the sampler's
    ``labels`` to the (B, N, context_dim) context: a :class:`SpatialRescaler`,
    an :class:`IdentityCondStage`, a
    :class:`~diff_pruning_tpu_torch.models.text_encoder.BERTEmbedder` (then
    ``labels`` are (B, 77) token ids); without one, the ClassEmbedder
    (cin256-v2)."""

    def __init__(self, unet_cfg: UNetCondConfig, *, n_classes: int = 1001, first_stage=None,
                 scale_factor: float = 1.0, num_train_timesteps: int = 1000,
                 linear_start: float = 0.0015, linear_end: float = 0.0195,
                 cond_stage=None, device):
        super().__init__()
        self.unet = UNetCond(unet_cfg, device=device)
        if cond_stage is None:
            cond_stage = ClassEmbedder(n_classes, unet_cfg.context_dim, device=device)
        self.cond_stage = cond_stage
        self.first_stage = first_stage  # VQModel / AutoencoderKL or None
        self.n_classes = n_classes
        self.uncond_class = n_classes - 1
        self.scale_factor = scale_factor
        self.linear_start, self.linear_end = linear_start, linear_end
        self.schedule = ldm_schedule(num_train_timesteps, linear_start, linear_end,
                                     device=device)

    def init(self, generator: torch.Generator) -> "LatentDiffusion":
        """Random initialisation of every part (the UNet's zero-initialised
        leaves included)."""
        self.unet.init(generator)
        self.cond_stage.reset_parameters(generator)
        if self.first_stage is not None:
            self.first_stage.init(generator)
        return self

    def get_learned_conditioning(self, labels: torch.Tensor) -> torch.Tensor:
        return self.cond_stage(labels)

    def apply_unet(self, x: torch.Tensor, t, context: torch.Tensor) -> torch.Tensor:
        return self.unet(x, t, context=context)

    def get_loss_at_t(self, x0_latents: torch.Tensor, labels: torch.Tensor, t: torch.Tensor,
                      noise: torch.Tensor, *,
                      compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """p_losses at fixed t (ddpm.py:881-889): the latents noised at ``t``
        (B,) with ``noise`` (in the latents' dtype), the UNet's eps with the
        class context against the noise, the mean MSE over everything in f32.
        With ``compute_dtype`` (bf16) the context and every UNet parameter are
        cast to it for the forward and backward (``call_in_dtype``: grads reach
        the f32 masters), as the JAX train step casts them."""
        from .unet2d import call_in_dtype

        ctx = self.get_learned_conditioning(labels)
        noise = noise.to(x0_latents.dtype)
        noisy = self.schedule.add_noise(x0_latents, noise, t)
        if compute_dtype is None:
            eps = self.apply_unet(noisy, t, ctx)
        else:
            eps = call_in_dtype(self.unet, compute_dtype, noisy, t, context=ctx.to(compute_dtype))
        return ((eps - noise).to(torch.float32) ** 2).mean()

    def train_loss(self, images: torch.Tensor, labels: torch.Tensor, t: torch.Tensor,
                   noise: torch.Tensor, *, drop: Optional[torch.Tensor] = None,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The loss of the LDM train step (the JAX ``cli/ldm_train.py``
        ``loss_fn``): NHWC ``images`` in [-1, 1] encoded by the frozen first
        stage (no grad, in ``compute_dtype``: its conv and linear weights must
        have been cast already, ``cast_compute_weights``) and scaled by
        ``scale_factor``; the labels where ``drop`` is set replaced by the
        uncond class; then :meth:`get_loss_at_t`. The random draws are the
        caller's: jax.random's cannot be reproduced here."""
        with torch.no_grad():
            z = self.first_stage.encode(images.to(compute_dtype or torch.float32))
        if drop is not None:
            labels = torch.where(drop, torch.full_like(labels, self.uncond_class), labels)
        return self.get_loss_at_t(z * self.scale_factor, labels, t, noise,
                                  compute_dtype=compute_dtype)

    def make_cfg_sampler(self, *, ddim_steps: int = 20, guidance_scale: float = 3.0,
                         eta: float = 0.0, latent_hw=64, latent_ch: int = 3,
                         method: str = "ddim", mesh=None, tensor_parallel: bool = False,
                         model_axis: str = "model", uncond_input=None) -> Callable:
        """Conditional CFG sampler over latents: returns
        ``sample(generator, labels, batch_size, *, x_T=None, noise=None) ->
        latents`` (B, h, w, latent_ch) f32 NHWC on the model's device.

        Each step batches the uncond and cond rows through one UNet call
        (x_in = cat([x] * 2), ldm/models/diffusion/ddim.py:188-192). The cond
        rows are the cond stage applied to ``labels``; the uncond rows the
        uncond class's, or with ``uncond_input`` (e.g. the tokenized empty
        prompt, or zero CLIP embeddings) the cond stage applied to it, a
        single row broadcast to the batch. ``x_T``, ``noise`` and ``method``
        as for :func:`_compvis_solver`.

        With ``mesh`` (``parallel/mesh.py``) the batch is split by rows over
        the data-parallel ranks, the JAX sampler's data axis: ``labels``,
        ``batch_size``, ``x_T`` and ``noise`` are global, every draw is made
        at the global shape, and the sampler returns this rank's rows.
        ``tensor_parallel`` (a 2-D mesh, ``make_mesh(model=m)``, whose model
        axis ``model_axis`` names as in JAX: 'model') shards the UNet in
        place over the model axis (``parallel/tp.py``), for inference only;
        the cond stage and the first stage stay replicated, as in JAX. A
        later sampler without ``tensor_parallel`` refuses the sharded UNet."""
        solve = _compvis_solver(self.schedule, ddim_steps, eta, method)
        shard_for_sampler(self.unet, mesh, tensor_parallel, model_axis)
        lat_h, lat_w = ((latent_hw, latent_hw) if isinstance(latent_hw, int)
                        else tuple(latent_hw))
        device = self.schedule.alphas_cumprod.device

        def sample(generator: Optional[torch.Generator], labels: torch.Tensor,
                   batch_size: int, *, x_T: Optional[torch.Tensor] = None,
                   noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
            with torch.inference_mode():
                rows = (slice(None) if mesh is None
                        else slice(*process_batch_slice(mesh, batch_size)))
                labels = torch.as_tensor(labels, device=device)[rows]
                n = labels.shape[0]
                ctx_c = self.get_learned_conditioning(labels)
                if uncond_input is None:
                    ctx_u = self.get_learned_conditioning(
                        torch.full((n,), self.uncond_class, dtype=torch.int64, device=device))
                else:
                    u = torch.as_tensor(uncond_input, device=device)
                    ctx_u = self.get_learned_conditioning(u if u.shape[0] == 1 else u[rows])
                    if ctx_u.shape[0] == 1:
                        ctx_u = ctx_u.expand(n, *ctx_u.shape[1:])
                ctx = torch.cat([ctx_u, ctx_c], dim=0)

                def eps_fn(x, t):
                    tb = torch.full((2 * n,), t, dtype=torch.int64, device=device)
                    e_u, e_c = self.apply_unet(torch.cat([x, x], dim=0), tb, ctx).chunk(2)
                    return e_u + guidance_scale * (e_c - e_u)

                return solve(eps_fn, (batch_size, lat_h, lat_w, latent_ch), generator,
                             x_T, noise, rows)

        return sample

    def decode_first_stage(self, latents: torch.Tensor) -> torch.Tensor:
        """NHWC latents -> NHWC images in [0, 1]."""
        if self.first_stage is None:
            raise ValueError("no first stage attached")
        with torch.inference_mode():
            img = self.first_stage.decode(latents / self.scale_factor)
            return ((img + 1.0) / 2.0).clamp(0.0, 1.0)


def make_concat_sampler(unet, schedule: DiffusionSchedule, *, ddim_steps: int = 50,
                        eta: float = 0.0, latent_ch: int = 3,
                        method: str = "ddim") -> Callable:
    """Concat-mode sampler (``concat_mode: true`` LatentDiffusion, and the
    unconditional models with no planes): at every step the fixed
    conditioning planes ride along the channel axis, eps = unet(cat([x,
    cond], C), t) (ddpm.py apply_model's c_concat path;
    scripts/inpaint.py:76-86).

    Returns ``sample(generator, cond, *, x_T=None, noise=None) -> latents``
    (B, h, w, latent_ch) f32 NHWC; ``cond`` is (B, h, w, Cc) with
    ``unet.cfg.in_channels == latent_ch + Cc`` (Cc = 0: unconditional).
    ``x_T``, ``noise`` and ``method`` as for :func:`_compvis_solver`."""
    solve = _compvis_solver(schedule, ddim_steps, eta, method)
    device = schedule.alphas_cumprod.device

    def sample(generator: Optional[torch.Generator], cond: torch.Tensor, *,
               x_T: Optional[torch.Tensor] = None,
               noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        with torch.inference_mode():
            cond = torch.as_tensor(cond, device=device, dtype=torch.float32)
            b, h, w = cond.shape[:3]

            def eps_fn(x, t):
                tb = torch.full((b,), t, dtype=torch.int64, device=device)
                return unet(torch.cat([x, cond], dim=-1), tb)

            return solve(eps_fn, (b, h, w, latent_ch), generator, x_T, noise)

    return sample


def load_ldm(model_path: Optional[str], config_path: Optional[str] = None, seed: int = 0, *,
             device) -> LatentDiffusion:
    """An LDM from a model dir in the JAX package's layout
    (``utils/checkpoint.py``: ``unet/``, ``cond_stage/``, optional
    ``first_stage/``, ``ldm.json``), or, without ``model_path``, a random
    init from ``seed``; the UNet config from ``config_path``, the dir's
    ``unet/config.json`` or cin256-v2. The counterpart of
    ``diff_pruning_tpu/cli/ldm_prune.py:load_ldm``; the port's LDM CLIs
    import it from here. Weights load strictly."""
    from ..utils.checkpoint import load_params_npz
    from .vae import AutoencoderConfig, make_first_stage

    def path(*parts):
        return os.path.join(model_path, *parts) if model_path else None

    if config_path:
        with open(config_path) as f:
            ucfg = UNetCondConfig.from_json(f.read())
    elif model_path and os.path.exists(path("unet", "config.json")):
        with open(path("unet", "config.json")) as f:
            ucfg = UNetCondConfig.from_json(f.read())
    else:
        ucfg = cin256_v2_config()
    meta = {}
    if model_path and os.path.exists(path("ldm.json")):
        with open(path("ldm.json")) as f:
            meta = json.load(f)

    state = first_stage = None
    if model_path:
        state = {"unet": load_params_npz(path("unet", "params.npz")),
                 "cond_stage": load_params_npz(path("cond_stage", "params.npz"))}
        if os.path.exists(path("first_stage", "params.npz")):
            with open(path("first_stage", "config.json")) as f:
                vcfg = AutoencoderConfig.from_json(f.read())
            first_stage = make_first_stage(vcfg, device=device)
            state["first_stage"] = load_params_npz(path("first_stage", "params.npz"))
        # without ldm.json the embedding table's row count is n_classes
        if "n_classes" not in meta and "embedding.weight" in state["cond_stage"]:
            meta["n_classes"] = int(state["cond_stage"]["embedding.weight"].shape[0])

    ldm = LatentDiffusion(
        ucfg, n_classes=int(meta.get("n_classes", 1001)), first_stage=first_stage,
        scale_factor=float(meta.get("scale_factor", 1.0)),
        num_train_timesteps=int(meta.get("num_train_timesteps", 1000)),
        linear_start=float(meta.get("linear_start", 0.0015)),
        linear_end=float(meta.get("linear_end", 0.0195)), device=device)
    if state is None:
        ldm.init(torch.Generator(device=device).manual_seed(seed))
    else:
        for name, sd in state.items():
            getattr(ldm, name).load_state_dict(sd)
    return ldm.eval()
