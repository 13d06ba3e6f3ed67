"""First-stage codecs: PyTorch counterpart of ``diff_pruning_tpu/models/vae.py``.

``VQModel`` and ``AutoencoderKL`` (diffusers vae.py Encoder:38 / Decoder:151
/ VectorQuantizer:270 / DiagonalGaussianDistribution:384), the latent codecs
of the LDM paths, with the JAX package's config schema, channel graph and
param-tree names, so first-stage checkpoints cross between the packages.
The resnet blocks are the temb-free ResnetBlock2D; the mid blocks (and the
``attn_resolutions`` levels) carry one-head spatial self-attention, which
goes through the attention kernel like the UNets' (the vq-f4 decoder's is
4096 tokens of D = 512).

``encode`` and ``decode`` take and return NHWC like the JAX models; inside,
activations are NCHW in ``torch.channels_last`` memory. The LDM train step
encodes in bf16 (``cast_compute_weights``). The first-stage trainer
(``training/autoencoder.py``) differentiates through both codecs: it takes
the decoder's trunk (``Decoder.features``) apart from ``conv_out`` and the
VQ lookup with its straight-through estimator and codebook loss
(``VQModel.quantize_train``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..pruning.graph import ChannelGraph, ChannelVar
from .layers import (Conv2D, GroupNorm, Linear, Scope, SelfAttention2D, downsample_pad,
                     upsample_nearest_2x)

# elements of one (rows x codes) distance tensor of the VQ lookup: 2^25 f32,
# 128 MB (4096 rows of vq-f4's 8192 codes)
QUANTIZE_CHUNK_ELEMS = 1 << 25


@dataclasses.dataclass
class AutoencoderConfig:
    """diffusers VQModel / AutoencoderKL config subset."""

    in_channels: int = 3
    out_channels: int = 3
    down_block_types: Tuple[str, ...] = ("DownEncoderBlock2D",)
    up_block_types: Tuple[str, ...] = ("UpDecoderBlock2D",)
    block_out_channels: Tuple[int, ...] = (64,)
    layers_per_block: int = 1
    act_fn: str = "silu"
    latent_channels: int = 3
    norm_num_groups: int = 32
    sample_size: int = 32
    # VQ-specific
    num_vq_embeddings: Optional[int] = None  # set => VQModel
    vq_embed_dim: Optional[int] = None
    scaling_factor: float = 0.18215  # KL latent scaling (SD convention)
    mid_block_attention: bool = True
    # CompVis ddconfig attn_resolutions: self-attention after every resnet
    # at these resolutions (halving from sample_size); empty: mid block only
    attn_resolutions: Tuple[int, ...] = ()
    channel_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["_class_name"] = "VQModel" if self.num_vq_embeddings else "AutoencoderKL"
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "AutoencoderConfig":
        d = json.loads(text)
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for key in ("down_block_types", "up_block_types", "block_out_channels",
                    "attn_resolutions"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return cls(**kw)

    def with_channel_sizes(self, sizes: Dict[str, int]) -> "AutoencoderConfig":
        return dataclasses.replace(self, channel_sizes=dict(sizes))


class _VaeResnet(nn.Module):
    """ResnetBlock2D with temb_channels=None (GN eps 1e-6)."""

    def __init__(self, scope: Scope, g: ChannelGraph, cfg, cin: ChannelVar,
                 default_out: int, default_in: int, *, device):
        super().__init__()
        dev = dict(device=device)
        self.has_shortcut = default_in != default_out
        if self.has_shortcut:
            self.out = g.var(scope.path + "/out",
                             cfg.channel_sizes.get(scope.path + "/out", default_out))
        else:
            self.out = cin
        self.norm1 = GroupNorm(scope("norm1"), cin, cfg.norm_num_groups, 1e-6, **dev)
        self.conv1 = Conv2D(scope("conv1"), cin, self.out, 3, 1, 1, **dev)
        self.norm2 = GroupNorm(scope("norm2"), self.out, cfg.norm_num_groups, 1e-6, **dev)
        self.conv2 = Conv2D(scope("conv2"), self.out, self.out, 3, 1, 1, **dev)
        if self.has_shortcut:
            self.conv_shortcut = Conv2D(scope("conv_shortcut"), cin, self.out, 1, 1, 0, **dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, with_silu=True))
        h = self.conv2(self.norm2(h, with_silu=True))
        return h + (self.conv_shortcut(x) if self.has_shortcut else x)


def _attention(scope: Scope, var: ChannelVar, inner: ChannelVar, cfg, device):
    return SelfAttention2D(scope, var, inner, heads=1, norm_num_groups=cfg.norm_num_groups,
                           eps=1e-6, device=device)


def _mid_block(scope: Scope, g: ChannelGraph, cfg, cur: ChannelVar, cur_d: int, mkvar,
               device) -> nn.ModuleDict:
    res0 = _VaeResnet(scope("resnets/0"), g, cfg, cur, cur_d, cur_d, device=device)
    mid = nn.ModuleDict()
    if cfg.mid_block_attention:
        inner = mkvar(scope.path + "/attentions/0/inner", cur_d)
        mid["attentions"] = nn.ModuleDict({"0": _attention(scope("attentions/0"), res0.out,
                                                           inner, cfg, device)})
    res1 = _VaeResnet(scope("resnets/1"), g, cfg, res0.out, cur_d, cur_d, device=device)
    mid["resnets"] = nn.ModuleDict({"0": res0, "1": res1})
    return mid


def _run_mid(mid: nn.ModuleDict, h: torch.Tensor) -> torch.Tensor:
    h = mid["resnets"]["0"](h)
    if "attentions" in mid:
        h = mid["attentions"]["0"](h)
    return mid["resnets"]["1"](h)


class Encoder(nn.Module):
    """vae.py Encoder:38-149 (DownEncoderBlock2D chain + attn mid block)."""

    def __init__(self, cfg: AutoencoderConfig, g: ChannelGraph, scope: Scope, double_z: bool,
                 *, device):
        super().__init__()
        dev = dict(device=device)
        cs = cfg.channel_sizes
        v_in = g.var(scope.path + "/in" if scope.path else "enc_in", cfg.in_channels,
                     prunable=False)
        z_ch = 2 * cfg.latent_channels if double_z else cfg.latent_channels
        self.v_z = g.var(scope.path + "/z", z_ch, prunable=False)

        def mkvar(name, default):
            return g.var(name, cs.get(name, default))

        v0 = mkvar(scope.path + "/conv_in/out", cfg.block_out_channels[0])
        self.conv_in = Conv2D(scope("conv_in"), v_in, v0, 3, 1, 1, **dev)
        cur, cur_d = v0, cfg.block_out_channels[0]
        self.down_blocks = nn.ModuleDict()
        curr_res = cfg.sample_size
        for i, out_d in enumerate(cfg.block_out_channels):
            bscope = scope(f"down_blocks/{i}")
            resnets, attns = nn.ModuleDict(), nn.ModuleDict()
            for j in range(cfg.layers_per_block):
                r = _VaeResnet(bscope(f"resnets/{j}"), g, cfg, cur, out_d, cur_d, **dev)
                resnets[str(j)] = r
                cur, cur_d = r.out, out_d
                if curr_res in cfg.attn_resolutions:
                    inner = mkvar(f"{bscope.path}/attentions/{j}/inner", out_d)
                    attns[str(j)] = _attention(bscope(f"attentions/{j}"), cur, inner, cfg,
                                               device)
            blk = nn.ModuleDict({"resnets": resnets, **({"attentions": attns} if attns else {})})
            if i < len(cfg.block_out_channels) - 1:
                dsv = mkvar(f"{scope.path}/down_blocks/{i}/downsamplers/0/out", out_d)
                blk["downsamplers"] = nn.ModuleDict({"0": nn.ModuleDict({"conv": Conv2D(
                    bscope("downsamplers/0/conv"), cur, dsv, 3, 2, 0, **dev)})})
                cur, cur_d = dsv, out_d
                curr_res //= 2
            self.down_blocks[str(i)] = blk
        self.mid_block = _mid_block(scope("mid_block"), g, cfg, cur, cur_d, mkvar, device)
        cur = self.mid_block["resnets"]["1"].out
        self.conv_norm_out = GroupNorm(scope("conv_norm_out"), cur, cfg.norm_num_groups, 1e-6,
                                       **dev)
        self.conv_out = Conv2D(scope("conv_out"), cur, self.v_z, 3, 1, 1, **dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in and out."""
        h = self.conv_in(x)
        for blk in self.down_blocks.values():
            for j, r in blk["resnets"].items():
                h = r(h)
                if "attentions" in blk:
                    h = blk["attentions"][j](h)
            if "downsamplers" in blk:
                # downsample_padding=0 (vae.py:80): pad (0,1,0,1), VALID stride-2 conv
                h = blk["downsamplers"]["0"]["conv"](downsample_pad(h))
        h = _run_mid(self.mid_block, h)
        return self.conv_out(self.conv_norm_out(h, with_silu=True))


class Decoder(nn.Module):
    """vae.py Decoder:151-268 (mid block + UpDecoderBlock2D chain)."""

    def __init__(self, cfg: AutoencoderConfig, g: ChannelGraph, scope: Scope, *, device):
        super().__init__()
        dev = dict(device=device)
        cs = cfg.channel_sizes
        self.v_z = g.var(scope.path + "/z", cfg.latent_channels, prunable=False)
        self.v_out = g.var(scope.path + "/out_img", cfg.out_channels, prunable=False)

        def mkvar(name, default):
            return g.var(name, cs.get(name, default))

        rev = list(reversed(cfg.block_out_channels))
        v0 = mkvar(scope.path + "/conv_in/out", rev[0])
        self.conv_in = Conv2D(scope("conv_in"), self.v_z, v0, 3, 1, 1, **dev)
        self.mid_block = _mid_block(scope("mid_block"), g, cfg, v0, rev[0], mkvar, device)
        cur, cur_d = self.mid_block["resnets"]["1"].out, rev[0]
        self.up_blocks = nn.ModuleDict()
        curr_res = cfg.sample_size // (2 ** (len(rev) - 1))
        for i, out_d in enumerate(rev):
            bscope = scope(f"up_blocks/{i}")
            resnets, attns = nn.ModuleDict(), nn.ModuleDict()
            for j in range(cfg.layers_per_block + 1):
                r = _VaeResnet(bscope(f"resnets/{j}"), g, cfg, cur, out_d, cur_d, **dev)
                resnets[str(j)] = r
                cur, cur_d = r.out, out_d
                if curr_res in cfg.attn_resolutions:
                    inner = mkvar(f"{bscope.path}/attentions/{j}/inner", out_d)
                    attns[str(j)] = _attention(bscope(f"attentions/{j}"), cur, inner, cfg,
                                               device)
            blk = nn.ModuleDict({"resnets": resnets, **({"attentions": attns} if attns else {})})
            if i < len(rev) - 1:
                usv = mkvar(f"{scope.path}/up_blocks/{i}/upsamplers/0/out", out_d)
                blk["upsamplers"] = nn.ModuleDict({"0": nn.ModuleDict({"conv": Conv2D(
                    bscope("upsamplers/0/conv"), cur, usv, 3, 1, 1, **dev)})})
                cur, cur_d = usv, out_d
                curr_res *= 2
            self.up_blocks[str(i)] = blk
        self.conv_norm_out = GroupNorm(scope("conv_norm_out"), cur, cfg.norm_num_groups, 1e-6,
                                       **dev)
        self.conv_out = Conv2D(scope("conv_out"), cur, self.v_out, 3, 1, 1, **dev)

    def features(self, z: torch.Tensor) -> torch.Tensor:
        """Everything before ``conv_out`` (NCHW in and out): the GAN
        trainer's adaptive weight differentiates through ``conv_out`` alone
        (the reference's last layer, ``decoder.conv_out.weight``)."""
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks.values():
            for j, r in blk["resnets"].items():
                h = r(h)
                if "attentions" in blk:
                    h = blk["attentions"][j](h)
            if "upsamplers" in blk:
                h = blk["upsamplers"]["0"]["conv"](upsample_nearest_2x(h))
        return self.conv_norm_out(h, with_silu=True)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """NCHW in and out."""
        return self.conv_out(self.features(z))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class _FirstStage(nn.Module):
    """What VQModel and AutoencoderKL share: init and NHWC decode."""

    def init(self, generator: torch.Generator) -> "_FirstStage":
        """Random initialisation (torch's default layer init, as in JAX)."""
        for m in self.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self

    def cast_compute_weights(self, dtype: torch.dtype) -> "_FirstStage":
        """Cast conv and linear weights to the compute dtype, in place: the
        JAX layers cast them to the activation dtype on every call, so a
        frozen first stage run in bf16 (the LDM train step's encode) gives
        the same values. GroupNorm's scale and bias stay f32, as the JAX
        layer reads them; the codebook is left as it is."""
        for m in self.modules():
            if isinstance(m, (Conv2D, Linear)):
                m.to(dtype)
        return self

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(_nchw(z))).permute(0, 2, 3, 1)


class VQModel(_FirstStage):
    """vq_model.py: encoder -> quant_conv -> VectorQuantizer -> post_quant
    -> decoder; ``decode`` skips the codebook by default, as the LDM pipeline
    decodes (force_not_quantize=True)."""

    def __init__(self, cfg: AutoencoderConfig, *, device):
        super().__init__()
        assert cfg.num_vq_embeddings, "VQModel needs num_vq_embeddings"
        self.cfg = cfg
        g = self.graph = ChannelGraph()
        root = Scope(g)
        self.encoder = Encoder(cfg, g, root("encoder"), double_z=False, device=device)
        self.decoder = Decoder(cfg, g, root("decoder"), device=device)
        self.vq_dim = cfg.vq_embed_dim or cfg.latent_channels
        v_q = g.var("quant", self.vq_dim, prunable=False)
        self.quant_conv = Conv2D(root("quant_conv"), self.encoder.v_z, v_q, 1, 1, 0,
                                 device=device)
        self.post_quant_conv = Conv2D(root("post_quant_conv"), v_q, self.decoder.v_z, 1, 1, 0,
                                      device=device)
        root("quantize/embedding").ref("weight", 1, v_q, "out")
        self.quantize = nn.Module()
        self.quantize.embedding = nn.Module()
        self.quantize.embedding.weight = nn.Parameter(
            torch.empty((cfg.num_vq_embeddings, self.vq_dim), device=device))

    def init(self, generator: torch.Generator) -> "VQModel":
        super().init(generator)
        n = self.cfg.num_vq_embeddings
        with torch.no_grad():
            self.quantize.embedding.weight.uniform_(-1.0 / n, 1.0 / n, generator=generator)
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> NHWC pre-quantization latent."""
        return self.quant_conv(self.encoder(_nchw(x))).permute(0, 2, 3, 1)

    def quantize_latents(self, z: torch.Tensor):
        """Nearest-codebook lookup (vae.py VectorQuantizer:332), the JAX
        model's ``quantize``: ``(zq, indices)``. The distances are formed for
        QUANTIZE_CHUNK_ELEMS // codes rows at a time (each row's own, so the
        chunking changes no result): at B = 50 of vq-f4 all at once they
        would take three 6.7 GB tensors."""
        emb = self.quantize.embedding.weight.to(z.dtype)
        flat = z.reshape(-1, z.shape[-1])
        e2 = emb.pow(2).sum(1)[None, :]
        rows = max(1, QUANTIZE_CHUNK_ELEMS // emb.shape[0])
        idx = torch.cat([
            torch.argmin(part.pow(2).sum(1, keepdim=True) - 2.0 * part @ emb.t() + e2, dim=1)
            for part in flat.split(rows)])
        return emb[idx].reshape(z.shape), idx.reshape(z.shape[:-1])

    def quantize_train(self, z: torch.Tensor, beta: float = 0.25):
        """Training-mode quantize (taming VectorQuantizer2, legacy weighting,
        beta 0.25 as ldm's autoencoder.py instantiates it): ``(zq, loss,
        indices)`` with the straight-through ``zq = z + (zq - z).detach()``
        and ``loss = mean((zq.detach() - z)^2) + beta * mean((zq -
        z.detach())^2)`` in f32 whatever the compute dtype. The lookup
        (:meth:`quantize_latents`, chunked) runs without grad; the codebook
        gets its grad through the gathered rows (``F.embedding``: on the card
        its backward is deterministic, so a resumed run is bit-identical)."""
        with torch.no_grad():
            _, idx = self.quantize_latents(z)
        zq = F.embedding(idx, self.quantize.embedding.weight.to(z.dtype))
        zf, qf = z.to(torch.float32), zq.to(torch.float32)
        loss = ((qf.detach() - zf) ** 2).mean() + beta * ((qf - zf.detach()) ** 2).mean()
        return z + (zq - z).detach(), loss, idx

    def decode(self, z: torch.Tensor, force_not_quantize: bool = True) -> torch.Tensor:
        """NHWC latent -> NHWC image."""
        if not force_not_quantize:
            z, _ = self.quantize_latents(z)
        return self._decode(z)


class AutoencoderKL(_FirstStage):
    """autoencoder_kl.py: encode -> DiagonalGaussian; decode."""

    def __init__(self, cfg: AutoencoderConfig, *, device):
        super().__init__()
        self.cfg = cfg
        g = self.graph = ChannelGraph()
        root = Scope(g)
        self.encoder = Encoder(cfg, g, root("encoder"), double_z=True, device=device)
        self.decoder = Decoder(cfg, g, root("decoder"), device=device)
        v_moments = g.var("moments", 2 * cfg.latent_channels, prunable=False)
        v_lat = g.var("latent", cfg.latent_channels, prunable=False)
        self.quant_conv = Conv2D(root("quant_conv"), self.encoder.v_z, v_moments, 1, 1, 0,
                                 device=device)
        self.post_quant_conv = Conv2D(root("post_quant_conv"), v_lat, self.decoder.v_z, 1, 1,
                                      0, device=device)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> NHWC (mean, logvar) moments."""
        return self.quant_conv(self.encoder(_nchw(x))).permute(0, 2, 3, 1)

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A draw from the diagonal gaussian posterior (its mean without a generator)."""
        mean, logvar = self.encode_moments(x).chunk(2, dim=-1)
        if generator is None:
            return mean
        logvar = logvar.clamp(-30.0, 20.0)
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
        return mean + torch.exp(0.5 * logvar) * noise

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC latent -> NHWC image."""
        return self._decode(z)


def _first_stage(ch_mult, z, *, double_z, n_embed=None, embed_dim=None, attn=(),
                 mid_attn=True):
    assert double_z == (n_embed is None), "KL <=> double_z in the zoo"
    return AutoencoderConfig(
        block_out_channels=tuple(128 * m for m in ch_mult),
        layers_per_block=2, latent_channels=z, sample_size=256,
        num_vq_embeddings=n_embed, vq_embed_dim=embed_dim,
        attn_resolutions=tuple(attn), mid_block_attention=mid_attn)


# ldm_exp/models/first_stage_models/*/config.yaml ddconfigs (ch=128,
# num_res_blocks=2, resolution 256); names match the reference directories
FIRST_STAGE_PRESETS = {
    "kl-f4": lambda: _first_stage((1, 2, 4), 3, double_z=True),
    "kl-f8": lambda: _first_stage((1, 2, 4, 4), 4, double_z=True),
    "kl-f16": lambda: _first_stage((1, 1, 2, 2, 4), 16, double_z=True, attn=(16,)),
    "kl-f32": lambda: _first_stage((1, 1, 2, 2, 4, 4), 64, double_z=True, attn=(16, 8)),
    "vq-f4": lambda: _first_stage((1, 2, 4), 3, double_z=False, n_embed=8192, embed_dim=3),
    "vq-f4-noattn": lambda: _first_stage((1, 2, 4), 3, double_z=False, n_embed=8192,
                                         embed_dim=3, mid_attn=False),
    "vq-f8": lambda: _first_stage((1, 2, 2, 4), 4, double_z=False, n_embed=16384,
                                  embed_dim=4, attn=(32,)),
    "vq-f8-n256": lambda: _first_stage((1, 2, 2, 4), 4, double_z=False, n_embed=256,
                                       embed_dim=4, attn=(32,)),
    "vq-f16": lambda: _first_stage((1, 1, 2, 2, 4), 8, double_z=False, n_embed=16384,
                                   embed_dim=8, attn=(16,)),
}


def first_stage_config(name: str) -> AutoencoderConfig:
    return FIRST_STAGE_PRESETS[name]()


def make_first_stage(cfg: AutoencoderConfig, *, device):
    return (VQModel(cfg, device=device) if cfg.num_vq_embeddings
            else AutoencoderKL(cfg, device=device))
