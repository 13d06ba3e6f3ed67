"""First-stage autoencoder (VQ / KL) GAN training: PyTorch counterpart of
``diff_pruning_tpu/training/autoencoder.py`` (the reference's
``LPIPSWithDiscriminator`` / ``VQLPIPSWithDiscriminator`` losses and the
two-optimizer Lightning loop of ldm's ``autoencoder.py``).

One step is the JAX ``step_fn``'s two passes:

* the generator pass: reconstruct (encode; VQ: the straight-through lookup
  and its codebook loss; KL: a posterior draw and the KL summed per image
  over the batch), ``conv_out``, the NLL (VQ: the mean of the pixel loss
  plus the perceptual one; KL: their sum over the batch with the frozen
  logvar), the generator's GAN loss ``-mean(D(recon))``, the adaptive
  weight and Adam on the generator;
* the discriminator pass: reconstruct again without grad with the updated
  generator (KL: a second posterior draw), the hinge or vanilla loss on
  D(x) and D(recon), times ``adopt_weight``, and Adam on the discriminator.

The adaptive weight is ``clip(|grad nll| / (|grad g_loss| + 1e-4), 0, 1e4)
x disc_weight``, the grads taken with respect to ``decoder.conv_out``'s
kernel alone (the reference's ``torch.autograd.grad(loss, last_layer)``),
whenever ``disc_factor > 0``, before ``disc_start`` too. They are taken on
the step's own graph: a grad with respect to the kernel alone reads only
``conv_out``'s input, so it equals the JAX package's nested grad through
``conv_out`` on the detached trunk output, without a second forward of the
LPIPS trunk and the discriminator.

Both optimizers are ``optax.adam(lr, b1=0.5, b2=0.9)`` (lr = base lr x
batch, the generator's times ``lr_g_factor``) on the port's
``training/finetune.py`` ``Optimizer``, their states at bare ``optax.adam``'s
keypath ``[0]``, so a JAX ``ckpt/gen`` and ``ckpt/disc`` restore into the
port and the port's into the JAX package. The loss's ``logvar`` is a frozen
constant, as in the reference, which adds it to neither optimizer.

``mixed_precision="bf16"`` casts the whole f32 parameter tree (GroupNorm's
scale and bias and the codebook included), the discriminator's and the
images to bf16 for the forward and backward, as the JAX step casts them;
the casts are differentiable, so grads reach the f32 masters. The losses
and their reductions are f32. The LPIPS weights are cast once.

The state is updated in place: ``AETrainState`` holds the two models' own
parameters and Adam states. The KL draws come from a generator seeded by
(seed, step), so a resumed run replays them; tests pass explicit noise.

With a ``mesh`` (``parallel/mesh.py``) the step is the DDP counterpart of
the JAX ``make_autoencoder_train_step(mesh=)``: each rank takes its rows of
the global batch, and the grads of both optimizers are averaged over the
ranks before each update. What the JAX step computes over the global batch
is reduced over the ranks: the PatchGAN's BatchNorm statistics
(``models/discriminator.py``, forward and backward), the two grads of the
adaptive weight on ``conv_out``'s kernel (before their norms), the VQ
code histogram behind the perplexity and the cluster use, and the logged
losses; the KL posterior noise is drawn at the global shape and each rank
keeps its rows.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import DataMesh, all_reduce_mean, local_rows
from .finetune import OptState, Optimizer, TrainConfig, step_generator

# ---------------------------------------------------------------------------
# losses (vqperceptual.py:11-40 and taming's hinge / vanilla)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def hinge_d_loss_with_exemplar_weights(logits_real: torch.Tensor, logits_fake: torch.Tensor,
                                       weights: torch.Tensor) -> torch.Tensor:
    """vqperceptual.py:11-18: the hinge loss weighted per example."""
    loss_real = F.relu(1.0 - logits_real).mean(dim=(1, 2, 3))
    loss_fake = F.relu(1.0 + logits_fake).mean(dim=(1, 2, 3))
    wsum = weights.sum()
    return 0.5 * ((weights * loss_real).sum() / wsum + (weights * loss_fake).sum() / wsum)


def adopt_weight(weight: float, global_step: int, threshold: int = 0, value: float = 0.0):
    """vqperceptual.py:20-23: ``value`` before ``threshold``, else ``weight``."""
    return value if global_step < threshold else weight


def measure_perplexity(predicted_indices: torch.Tensor, n_embed: int,
                       mesh: Optional[DataMesh] = None):
    """vqperceptual.py:26-33: the codebook's usage perplexity and the number
    of codes used, from the code counts (``bincount``, not a one-hot of
    rows x codes: 1.6 GB for vq-f4 at B = 12); with a ``mesh``, of the
    counts summed over the ranks."""
    idx = predicted_indices.reshape(-1)
    counts = torch.bincount(idx, minlength=n_embed)
    total = idx.numel()
    if mesh is not None:
        torch.distributed.all_reduce(counts, group=mesh.group)
        total *= mesh.world
    avg = counts.to(torch.float32) / total
    perplexity = torch.exp(-(avg * torch.log(avg + 1e-10)).sum())
    return perplexity, (avg > 0).sum()


@dataclasses.dataclass
class GANLossConfig:
    """The knobs of LPIPSWithDiscriminator and VQLPIPSWithDiscriminator."""

    disc_start: int = 0            # global step from which disc_factor applies
    kl_weight: float = 1.0         # KL variant
    codebook_weight: float = 1.0   # VQ variant
    pixelloss_weight: float = 1.0  # carried, never applied (as in the reference)
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_loss: str = "hinge"       # hinge | vanilla
    pixel_loss: str = "l1"         # VQ variant: l1 | l2 (KL is always l1)
    logvar_init: float = 0.0       # KL variant (frozen)
    vq_beta: float = 0.25          # commitment weight


@dataclasses.dataclass
class AETrainState:
    gen_params: Dict[str, torch.Tensor]   # the first stage's own parameters
    disc_params: Dict[str, torch.Tensor]  # the discriminator's
    gen_opt: OptState
    disc_opt: OptState
    step: int


def make_ae_optimizers(lr: float, lr_g_factor: float = 1.0) -> Tuple[Optimizer, Optimizer]:
    """autoencoder.py:197-209: Adam(betas=(0.5, 0.9)) for both, as bare
    ``optax.adam``."""

    def adam(rate):
        return Optimizer(TrainConfig(learning_rate=rate, adam_beta1=0.5, adam_beta2=0.9,
                                     grad_clip=0.0, use_ema=False), adam_path="[0]")

    return adam(lr * lr_g_factor), adam(lr)


def init_ae_train_state(model: nn.Module, disc: nn.Module, gen_opt: Optimizer,
                        disc_opt: Optimizer) -> AETrainState:
    gen_params = dict(model.named_parameters())
    disc_params = dict(disc.named_parameters())
    return AETrainState(gen_params, disc_params, gen_opt.init(gen_params),
                        disc_opt.init(disc_params), 0)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class _Codec(nn.Module):
    """The step's view of the first stage: ``forward(x, noise) -> (h, aux)``,
    ``h`` the decoder's trunk output (NCHW) before ``conv_out``. Under a
    ``mesh`` a KL draw from a generator is made at the global shape and
    this rank keeps its rows."""

    def __init__(self, model: nn.Module, beta: float, mesh: Optional[DataMesh] = None):
        super().__init__()
        self.model, self.beta, self.mesh = model, beta, mesh

    def forward(self, x: torch.Tensor, noise):
        m = self.model
        if m.cfg.num_vq_embeddings:
            zq, qloss, idx = m.quantize_train(m.encode(x), beta=self.beta)
            aux, lat = {"qloss": qloss, "idx": idx}, zq
        else:
            mean, lv = m.encode_moments(x).chunk(2, dim=-1)
            lv = lv.clamp(-30.0, 20.0)
            if isinstance(noise, torch.Generator):
                world = 1 if self.mesh is None else self.mesh.world
                noise = torch.randn((mean.shape[0] * world,) + tuple(mean.shape[1:]),
                                    generator=noise, device=mean.device)
                if self.mesh is not None:
                    noise = local_rows(self.mesh, noise)
            lat = mean + torch.exp(0.5 * lv) * noise.to(mean.dtype)
            # DiagonalGaussianDistribution.kl() against N(0, 1), summed per
            # image, in f32
            m32, lv32 = mean.to(torch.float32), lv.to(torch.float32)
            kl = 0.5 * (m32 ** 2 + torch.exp(lv32) - 1.0 - lv32).sum(dim=(1, 2, 3))
            aux = {"kl": kl.sum() / x.shape[0]}
        return m.decoder.features(m.post_quant_conv(_nchw(lat))), aux


def make_autoencoder_train_step(model: nn.Module, cfg: GANLossConfig, lpips: Optional[nn.Module],
                                disc: nn.Module, gen_opt: Optimizer, disc_opt: Optimizer, *,
                                mixed_precision: str = "no", seed: int = 0,
                                mesh: Optional[DataMesh] = None):
    """Returns ``step(state, images, *, noise=None, marks=None) -> metrics``
    for a ``VQModel`` or ``AutoencoderKL`` (``models/vae.py``) and a
    ``NLayerDiscriminator``: both optimizer passes on ``images`` (NHWC in
    [-1, 1], on the models' device), ``state`` updated in place. The
    metrics are the JAX step's, as 0-dim tensors (reading them syncs) or
    floats.

    KL: ``noise`` is the pair of posterior draws (generator pass,
    discriminator pass), NHWC like the latent; without it both come from
    :func:`~diff_pruning_tpu_torch.training.finetune.step_generator`
    (``seed``, ``state.step``). ``marks``, if given, is called with
    ``"d_weight"``, ``"gen_backward"``, ``"disc"`` and ``"end"`` where those
    parts of the step begin and where it ends (a timer's hooks).

    With ``mesh``, ``images`` (and an explicit ``noise``) are this rank's
    rows of the global batch, and every rank takes the same step: see the
    module docstring. The metrics are the global batch's."""
    if mixed_precision not in ("no", "bf16"):
        raise ValueError(f"mixed_precision {mixed_precision!r}: 'no' | 'bf16'")
    is_vq = bool(model.cfg.num_vq_embeddings)
    d_loss_fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    use_lpips = lpips is not None and cfg.perceptual_weight > 0
    compute = torch.bfloat16 if mixed_precision == "bf16" else torch.float32
    if use_lpips and compute != torch.float32:
        lpips = copy.deepcopy(lpips).to(compute)  # the JAX layers cast per call: same values
    codec = _Codec(model, cfg.vq_beta, mesh)
    conv_out = model.decoder.conv_out
    k_out, b_out = "decoder.conv_out.kernel", "decoder.conv_out.bias"
    logvar = cfg.logvar_init

    def cast(params, prefix=""):
        return {prefix + n: p.to(compute) for n, p in params.items()}

    def out_conv(h, params):
        return F.conv2d(h, params["model." + k_out], params["model." + b_out], conv_out.stride,
                        conv_out.padding).permute(0, 2, 3, 1)

    def nll_of(x, recon):
        """The scalar NLL and the elementwise rec loss, NHWC, f32; the LPIPS
        trunk runs in the compute dtype."""
        x32, r32 = x.to(torch.float32), recon.to(torch.float32)
        # the KL variant's pixel loss is always l1
        rec = (x32 - r32) ** 2 if is_vq and cfg.pixel_loss == "l2" else (x32 - r32).abs()
        if use_lpips:
            rec = rec + cfg.perceptual_weight * lpips(x, recon).to(torch.float32)[:, None, None,
                                                                                   None]
        if is_vq:
            return rec.mean(), rec
        return (rec / math.exp(logvar) + logvar).sum() / x.shape[0], rec

    def disc_logits(params, x):
        return torch.func.functional_call(disc, params, (x,), {"mesh": mesh}).to(torch.float32)

    def mean_over_ranks(tensors):
        if mesh is not None:
            all_reduce_mean(mesh, tensors)

    def step(state: AETrainState, images: torch.Tensor, *, noise=None,
             marks: Optional[Callable[[str], None]] = None):
        mark = marks or (lambda _: None)
        x = images.to(compute)
        if noise is None and not is_vq:
            gen = step_generator(seed, state.step, images.device)
            noise = (gen, gen)
        n_gen, n_disc = noise if noise is not None else (None, None)
        disc_factor = adopt_weight(cfg.disc_factor, state.step, threshold=cfg.disc_start)
        gen_plist = list(state.gen_params.values())

        # the generator pass
        with torch.enable_grad():
            gp = cast(state.gen_params, "model.")
            h, aux = torch.func.functional_call(codec, gp, (x, n_gen))
            recon = out_conv(h, gp)
            nll, rec = nll_of(x, recon)
            dp = {n: p.detach().to(compute) for n, p in state.disc_params.items()}
            g_loss = -disc_logits(dp, recon).mean()
            mark("d_weight")
            if cfg.disc_factor > 0:
                w_last = state.gen_params[k_out]
                nll_g, = torch.autograd.grad(nll, w_last, retain_graph=True)
                g_g, = torch.autograd.grad(g_loss, w_last, retain_graph=True)
                mean_over_ranks([nll_g, g_g])  # the global loss's grads, then their norms
                d_weight = (torch.linalg.vector_norm(nll_g)
                            / (torch.linalg.vector_norm(g_g) + 1e-4)).clamp(0.0, 1e4)
                d_weight = d_weight * cfg.disc_weight
            else:
                d_weight = torch.zeros((), device=images.device)
            mark("gen_backward")
            if is_vq:
                loss = nll + d_weight * disc_factor * g_loss + cfg.codebook_weight * aux["qloss"]
            else:
                loss = nll + cfg.kl_weight * aux["kl"] + d_weight * disc_factor * g_loss
            grads = torch.autograd.grad(loss, gen_plist, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, gen_plist)]
        mean_over_ranks(grads)
        gen_opt.update(grads, None, state.gen_opt, gen_plist)
        # the logged losses, as new tensors (averaged over the ranks in place)
        losses = {"total_loss": loss, "nll_loss": nll, "rec_loss": rec.mean(), "g_loss": g_loss,
                  **({"quant_loss": aux["qloss"]} if is_vq else {"kl_loss": aux["kl"]})}
        losses = {k: v.detach().clone() for k, v in losses.items()}
        mean_over_ranks(list(losses.values()))
        metrics = {**losses, "d_weight": d_weight, "disc_factor": disc_factor}
        if is_vq:
            perp, used = measure_perplexity(aux["idx"], model.cfg.num_vq_embeddings, mesh)
            metrics.update(perplexity=perp, cluster_usage=used)
        else:
            metrics.update(logvar=logvar)
        del gp, h, aux, recon, nll, rec, g_loss, loss, grads

        # the discriminator pass, on reconstructions by the updated generator
        mark("disc")
        with torch.no_grad():
            gp = cast(state.gen_params, "model.")
            h, _ = torch.func.functional_call(codec, gp, (x, n_disc))
            recon = out_conv(h, gp)
            del gp, h
        disc_plist = list(state.disc_params.values())
        with torch.enable_grad():
            dp = cast(state.disc_params)
            logits_real = disc_logits(dp, x)
            logits_fake = disc_logits(dp, recon)
            d_loss = disc_factor * d_loss_fn(logits_real, logits_fake)
            dgrads = list(torch.autograd.grad(d_loss, disc_plist))
        mean_over_ranks(dgrads)
        disc_opt.update(dgrads, None, state.disc_opt, disc_plist)
        dm = {"disc_loss": d_loss.detach().clone(), "logits_real": logits_real.detach().mean(),
              "logits_fake": logits_fake.detach().mean()}
        mean_over_ranks(list(dm.values()))
        metrics.update(dm)
        state.step += 1
        mark("end")
        return metrics

    return step

