"""UNet2D: PyTorch counterpart of ``diff_pruning_tpu/models/unet2d.py``.

Same config schema (``UNet2DConfig``, diffusers ``config.json`` plus
``channel_sizes``), same ChannelGraph built in the same order, and a module
tree named after the JAX param tree (``ModuleDict`` keys ``"0"``, ``"1"``,
...), so ``state_dict`` keys are the JAX flat paths with ``.`` for ``/``.

``forward`` takes and returns NHWC like the JAX model. Inside, activations
are NCHW in ``torch.channels_last`` memory (see ``layers.py``). The forward
is differentiable through the port's kernels (the Diff-Pruning sweep's
and the finetune step's path). Dropout (``cfg.dropout``, after each
ResnetBlock's second GroupNorm+SiLU) applies only when the caller passes a
``dropout_generator``, as the JAX model applies it only when given a
``dropout_rng``; ``module.training`` does not switch it, so the sweep and
the samplers stay deterministic.

``forward(..., remat=True)`` under autograd wraps each ResnetBlock and each
attention block in a non-reentrant ``torch.utils.checkpoint`` (the
reference's ``gradient_checkpointing`` granularity; the JAX step's
``jax.checkpoint``): only the blocks' inputs are kept, and the backward runs
each block's forward again, kernels included, before its own backward. The
recompute sees the tensors the forward saw (``call_in_dtype``'s casts too)
and replays the dropout generator from the state it had at the block's
entry, so the grads are the ones without remat.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..pruning.graph import CatVar, ChannelGraph, ChannelVar
from .layers import (
    Conv2D,
    GroupNorm,
    Linear,
    Scope,
    SelfAttention2D,
    downsample_pad,
    get_timestep_embedding,
    upsample_nearest_2x,
)


@dataclasses.dataclass
class UNet2DConfig:
    """diffusers UNet2DModel config (unet_2d.py:82-106) + channel_sizes."""

    sample_size: Optional[int] = None
    in_channels: int = 3
    out_channels: int = 3
    center_input_sample: bool = False
    time_embedding_type: str = "positional"
    freq_shift: float = 0
    flip_sin_to_cos: bool = True
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "AttnUpBlock2D", "AttnUpBlock2D", "AttnUpBlock2D", "UpBlock2D")
    block_out_channels: Tuple[int, ...] = (224, 448, 672, 896)
    layers_per_block: int = 2
    mid_block_scale_factor: float = 1.0
    downsample_padding: int = 1
    act_fn: str = "silu"
    attention_head_dim: Optional[int] = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    resnet_time_scale_shift: str = "default"
    add_attention: bool = True
    class_embed_type: Optional[str] = None
    num_class_embeds: Optional[int] = None
    dropout: float = 0.0
    # Pruning overrides: ChannelVar name -> actual size. Empty = unpruned.
    channel_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["_class_name"] = "UNet2DModel"
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "UNet2DConfig":
        d = json.loads(text)
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for key in ("down_block_types", "up_block_types", "block_out_channels"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return cls(**kw)

    def with_channel_sizes(self, sizes: Dict[str, int]) -> "UNet2DConfig":
        return dataclasses.replace(self, channel_sizes=dict(sizes))


class ResnetBlock(nn.Module):
    """ResnetBlock2D (resnet.py:456-644), time_embedding_norm='default'.

    If the default (unpruned) in/out sizes differ, a 1x1 conv shortcut
    exists and ``out`` is a fresh ChannelVar; otherwise the residual add ties
    the output to the input var.
    """

    def __init__(self, scope: Scope, g: ChannelGraph, cfg: UNet2DConfig,
                 cin: ChannelVar, default_out: int, temb_var: ChannelVar,
                 default_in: int, *, device):
        super().__init__()
        self.has_shortcut = default_in != default_out
        if self.has_shortcut:
            self.out = g.var(scope.path + "/out",
                             cfg.channel_sizes.get(scope.path + "/out", default_out))
        else:
            self.out = cin
        self._build(scope, cfg, cin, temb_var, device)

    def _build(self, scope, cfg, cin, temb_var, device):
        ng, eps = cfg.norm_num_groups, cfg.norm_eps
        self.dropout = cfg.dropout
        self.norm1 = GroupNorm(scope("norm1"), cin, ng, eps, device=device)
        self.conv1 = Conv2D(scope("conv1"), cin, self.out, 3, 1, 1, device=device)
        self.time_emb_proj = Linear(scope("time_emb_proj"), temb_var, self.out, device=device)
        self.norm2 = GroupNorm(scope("norm2"), self.out, ng, eps, device=device)
        self.conv2 = Conv2D(scope("conv2"), self.out, self.out, 3, 1, 1, device=device)
        if self.has_shortcut:
            self.conv_shortcut = Conv2D(scope("conv_shortcut"), cin, self.out, 1, 1, 0,
                                        device=device)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x, with_silu=True))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.norm2(h, with_silu=True)
        if generator is not None and self.dropout > 0.0:
            # keep each element with probability 1 - p, scaled by 1 / keep;
            # empty_like keeps h's channels-last layout for conv2
            keep = 1.0 - self.dropout
            u = torch.empty_like(h, dtype=torch.float32).uniform_(generator=generator)
            h = torch.where(u < keep, h / keep, 0.0).to(h.dtype)
        h = self.conv2(h)
        return h + (self.conv_shortcut(x) if self.has_shortcut else x)


class ConcatResnetBlock(ResnetBlock):
    """Up-block resnet consuming cat([hidden, skip]) (unet_2d_blocks.py:1822).

    The concatenated input is a CatVar, so conv1/conv_shortcut in-axes carry
    (var, offset) parts. The 1x1 shortcut always exists in these UNets.
    """

    def __init__(self, scope: Scope, g: ChannelGraph, cfg: UNet2DConfig,
                 hidden: ChannelVar, skip: ChannelVar, default_out: int,
                 temb_var: ChannelVar, default_in: int, *, device):
        nn.Module.__init__(self)
        cat = CatVar((hidden, skip))
        if default_in == default_out:
            raise ValueError("concat resnet without shortcut is unsupported")
        self.has_shortcut = True
        self.out = g.var(scope.path + "/out",
                         cfg.channel_sizes.get(scope.path + "/out", default_out))
        self._build(scope, cfg, cat, temb_var, device)


class _ClassEmbedding(nn.Module):
    """Class-label embedding table, param ``weight`` (num_classes, temb)."""

    def __init__(self, scope: Scope, n: int, temb_var: ChannelVar, *, device):
        super().__init__()
        scope.ref("weight", 1, temb_var, "out")
        self.weight = nn.Parameter(torch.empty((n, temb_var.size), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=generator)


def _block(resnets, attns, sampler_name: str, sampler) -> nn.ModuleDict:
    blk = nn.ModuleDict({"resnets": nn.ModuleDict({str(j): r for j, r in enumerate(resnets)})})
    if attns:
        blk["attentions"] = nn.ModuleDict({str(j): a for j, a in enumerate(attns)})
    if sampler is not None:
        blk[sampler_name] = nn.ModuleDict({"0": nn.ModuleDict({"conv": sampler})})
    return blk


def _checkpointed(block: nn.Module, *args):
    """``block(*args)`` under a non-reentrant checkpoint. The backward's
    recompute runs ``block`` over the tensors that this call's ``block``
    held (under ``torch.func.functional_call`` they are not its own
    parameters by then), with a ``torch.Generator`` among ``args`` set back
    to its state here and restored after, so that the recompute draws this
    call's dropout mask and later draws are left as they were. The global
    RNG is not saved: the UNet draws only from explicit generators."""
    params = dict(block.named_parameters())
    gens = [a for a in args if isinstance(a, torch.Generator)]
    entry = [g.get_state() for g in gens]
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return block(*a)
        after = [g.get_state() for g in gens]
        for g, st in zip(gens, entry):
            g.set_state(st)
        try:
            return torch.func.functional_call(block, params, a)
        finally:
            for g, st in zip(gens, after):
                g.set_state(st)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class UNet2D(nn.Module):
    """Built once from a config on ``device``; parameters are allocated, not
    initialised: call :meth:`init` with a generator, or load a state dict."""

    def __init__(self, cfg: UNet2DConfig, *, device):
        super().__init__()
        if cfg.time_embedding_type != "positional":
            raise NotImplementedError("only positional time embedding is supported")
        if cfg.resnet_time_scale_shift != "default":
            raise NotImplementedError("only default time_embedding_norm is supported")
        self.cfg = cfg
        g = self.graph = ChannelGraph()
        root = Scope(g)
        cs = cfg.channel_sizes
        dev = dict(device=device)

        def mkvar(name: str, default: int) -> ChannelVar:
            return g.var(name, cs.get(name, default))

        # fixed (non-prunable) boundary vars
        self.v_in = g.var("sample_in", cfg.in_channels, prunable=False)
        self.v_out = g.var("sample_out", cfg.out_channels, prunable=False)
        self.v_tproj = g.var("time_proj", cfg.block_out_channels[0], prunable=False)

        time_embed_default = cfg.block_out_channels[0] * 4
        self.v_temb_hidden = mkvar("time_embedding/hidden", time_embed_default)
        self.v_temb = mkvar("time_embedding/out", time_embed_default)
        te = root("time_embedding")
        self.time_embedding = nn.ModuleDict({
            "linear_1": Linear(te("linear_1"), self.v_tproj, self.v_temb_hidden, **dev),
            "linear_2": Linear(te("linear_2"), self.v_temb_hidden, self.v_temb, **dev),
        })

        self.class_embedding = None
        if cfg.class_embed_type is None and cfg.num_class_embeds is not None:
            self.class_embedding = _ClassEmbedding(root("class_embedding"),
                                                   cfg.num_class_embeds, self.v_temb, **dev)

        v0 = mkvar("conv_in/out", cfg.block_out_channels[0])
        self.conv_in = Conv2D(root("conv_in"), self.v_in, v0, 3, 1, 1, **dev)

        def heads_for(default_c: int) -> int:
            # unet_2d.py:433: heads = C // head_dim if head_dim else 1
            if cfg.attention_head_dim is None:
                return 1
            return max(default_c // cfg.attention_head_dim, 1)

        def attention(scope, var, inner, default_c):
            return SelfAttention2D(scope, var, inner, heads=heads_for(default_c),
                                   norm_num_groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                                   **dev)

        # --- down path; collect skip vars like down_block_res_samples
        skips, skip_defaults = [v0], [cfg.block_out_channels[0]]
        self.down_blocks = nn.ModuleDict()
        cur, cur_default = v0, cfg.block_out_channels[0]
        for i, btype in enumerate(cfg.down_block_types):
            bscope = root(f"down_blocks/{i}")
            out_default = cfg.block_out_channels[i]
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                r = ResnetBlock(bscope(f"resnets/{j}"), g, cfg, cur, out_default,
                                self.v_temb, cur_default, **dev)
                resnets.append(r)
                cur, cur_default = r.out, out_default
                if btype == "AttnDownBlock2D":
                    inner = mkvar(f"down_blocks/{i}/attentions/{j}/inner", out_default)
                    attns.append(attention(bscope(f"attentions/{j}"), cur, inner, out_default))
                skips.append(cur)
                skip_defaults.append(out_default)
            downsampler = None
            if i != len(cfg.block_out_channels) - 1:
                dsv = mkvar(f"down_blocks/{i}/downsamplers/0/out", out_default)
                downsampler = Conv2D(bscope("downsamplers/0/conv"), cur, dsv, 3, 2,
                                     padding=cfg.downsample_padding, **dev)
                cur, cur_default = dsv, out_default
                skips.append(cur)
                skip_defaults.append(out_default)
            self.down_blocks[str(i)] = _block(resnets, attns, "downsamplers", downsampler)

        # --- mid block
        mscope = root("mid_block")
        mid_default = cfg.block_out_channels[-1]
        mid_resnets = [ResnetBlock(mscope("resnets/0"), g, cfg, cur, mid_default,
                                   self.v_temb, cur_default, **dev)]
        cur = mid_resnets[0].out
        mid_attns = []
        if cfg.add_attention:
            inner = mkvar("mid_block/attentions/0/inner", mid_default)
            mid_attns.append(attention(mscope("attentions/0"), cur, inner, mid_default))
        mid_resnets.append(ResnetBlock(mscope("resnets/1"), g, cfg, cur, mid_default,
                                       self.v_temb, mid_default, **dev))
        cur, cur_default = mid_resnets[1].out, mid_default
        self.mid_block = _block(mid_resnets, mid_attns, "", None)

        # --- up path
        rev = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleDict()
        for i, btype in enumerate(cfg.up_block_types):
            bscope = root(f"up_blocks/{i}")
            out_default = rev[i]
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                skip_v, skip_d = skips.pop(), skip_defaults.pop()
                r = ConcatResnetBlock(bscope(f"resnets/{j}"), g, cfg, cur, skip_v,
                                      out_default, self.v_temb, cur_default + skip_d, **dev)
                resnets.append(r)
                cur, cur_default = r.out, out_default
                if btype == "AttnUpBlock2D":
                    inner = mkvar(f"up_blocks/{i}/attentions/{j}/inner", out_default)
                    attns.append(attention(bscope(f"attentions/{j}"), cur, inner, out_default))
            upsampler = None
            if i != len(cfg.block_out_channels) - 1:
                usv = mkvar(f"up_blocks/{i}/upsamplers/0/out", out_default)
                upsampler = Conv2D(bscope("upsamplers/0/conv"), cur, usv, 3, 1, 1, **dev)
                cur, cur_default = usv, out_default
            self.up_blocks[str(i)] = _block(resnets, attns, "upsamplers", upsampler)
        assert not skips, "skip bookkeeping mismatch"

        # --- out head; conv_out's out var is the fixed image var
        self.conv_norm_out = GroupNorm(root("conv_norm_out"), cur, cfg.norm_num_groups,
                                       cfg.norm_eps, **dev)
        self.conv_out = Conv2D(root("conv_out"), cur, self.v_out, 3, 1, 1, **dev)

    # -- params -------------------------------------------------------------

    def init(self, generator: torch.Generator) -> "UNet2D":
        """Random initialisation (torch's default layer init, as in JAX)."""
        for m in self.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self

    def cast_compute_weights(self, dtype: torch.dtype) -> "UNet2D":
        """Cast conv/linear/embedding weights to the compute dtype, in place.

        The JAX layers cast these to the activation dtype on every call;
        casting once here gives the same values. GroupNorm's scale and bias
        stay f32, as the JAX layer reads them.
        """
        for m in self.modules():
            if isinstance(m, (Conv2D, Linear, _ClassEmbedding)):
                m.to(dtype)
        return self

    # -- forward --------------------------------------------------------------

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                class_labels: Optional[torch.Tensor] = None, *,
                dropout_generator: Optional[torch.Generator] = None,
                remat: bool = False) -> torch.Tensor:
        """sample (B, H, W, C) NHWC; timesteps (B,) or scalar -> eps, NHWC.
        With ``dropout_generator``, every ResnetBlock drops at ``cfg.dropout``
        from it, in forward order. ``remat``: checkpoint each block (see the
        module docstring); without grad it changes nothing."""
        cfg = self.cfg
        block = _checkpointed if remat and torch.is_grad_enabled() else (
            lambda m, *args: m(*args))
        if cfg.center_input_sample:
            sample = 2.0 * sample - 1.0
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps[None].expand(sample.shape[0])

        t_emb = get_timestep_embedding(timesteps, self.v_tproj.size,
                                       flip_sin_to_cos=cfg.flip_sin_to_cos,
                                       downscale_freq_shift=cfg.freq_shift).to(sample.dtype)
        te = self.time_embedding
        temb = te["linear_2"](F.silu(te["linear_1"](t_emb)))
        if self.class_embedding is not None:
            if class_labels is None:
                raise ValueError("class_labels required for class-conditional model")
            temb = temb + self.class_embedding.weight[class_labels].to(temb.dtype)

        x = sample.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = self.conv_in(x)
        hs = [h]
        for blk in self.down_blocks.values():
            attns = blk["attentions"] if "attentions" in blk else None
            for j, r in blk["resnets"].items():
                h = block(r, h, temb, dropout_generator)
                if attns is not None:
                    h = block(attns[j], h)
                hs.append(h)
            if "downsamplers" in blk:
                if cfg.downsample_padding == 0:
                    # Downsample2D pads (0,1,0,1), then a VALID stride-2 conv
                    h = downsample_pad(h)
                h = blk["downsamplers"]["0"]["conv"](h)
                hs.append(h)

        mid = self.mid_block
        h = block(mid["resnets"]["0"], h, temb, dropout_generator)
        if "attentions" in mid:
            h = block(mid["attentions"]["0"], h)
        h = block(mid["resnets"]["1"], h, temb, dropout_generator)

        for blk in self.up_blocks.values():
            attns = blk["attentions"] if "attentions" in blk else None
            for j, r in blk["resnets"].items():
                h = block(r, torch.cat([h, hs.pop()], dim=1), temb, dropout_generator)
                if attns is not None:
                    h = block(attns[j], h)
            if "upsamplers" in blk:
                h = blk["upsamplers"]["0"]["conv"](upsample_nearest_2x(h))

        h = self.conv_out(self.conv_norm_out(h, with_silu=True))
        return h.permute(0, 2, 3, 1)


def call_in_dtype(model: nn.Module, dtype: torch.dtype, *args,
                  params: Optional[Dict[str, torch.Tensor]] = None, **kwargs):
    """``model(*args, **kwargs)`` with every parameter (``params``, default
    the model's own) cast to ``dtype``: the JAX package's mixed precision,
    which casts the whole f32 param tree to the compute dtype for the
    forward and backward. The casts are differentiable, so grads reach the
    f32 masters in f32."""
    if params is None:
        params = dict(model.named_parameters())
    cast = {n: p.to(dtype) for n, p in params.items()}
    return torch.func.functional_call(model, cast, args, kwargs)


def ddpm_cifar10_config() -> UNet2DConfig:
    """google/ddpm-cifar10-32 architecture (35.75M params)."""
    return UNet2DConfig(
        sample_size=32,
        in_channels=3,
        out_channels=3,
        center_input_sample=False,
        time_embedding_type="positional",
        freq_shift=1,
        flip_sin_to_cos=False,
        down_block_types=("DownBlock2D", "AttnDownBlock2D", "DownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "UpBlock2D", "AttnUpBlock2D", "UpBlock2D"),
        block_out_channels=(128, 256, 256, 256),
        layers_per_block=2,
        downsample_padding=0,
        attention_head_dim=None,
        norm_num_groups=32,
        norm_eps=1e-6,
    )


def tiny_unet_config(attn: bool = True) -> UNet2DConfig:
    """Small CPU-testable UNet with the same structural features."""
    return UNet2DConfig(
        sample_size=16,
        block_out_channels=(32, 64),
        down_block_types=("DownBlock2D", "AttnDownBlock2D") if attn else ("DownBlock2D", "DownBlock2D"),
        up_block_types=("AttnUpBlock2D", "UpBlock2D") if attn else ("UpBlock2D", "UpBlock2D"),
        layers_per_block=2,
        downsample_padding=0,
        attention_head_dim=None,
        norm_num_groups=8,
        norm_eps=1e-6,
        freq_shift=1,
        flip_sin_to_cos=False,
    )


def ddpm_celeba64_config() -> UNet2DConfig:
    """CelebA-HQ 64x64 DDPM (ddpm_exp/configs/celeba.yml: ch=128,
    ch_mult [1,2,2,2,4], attn@16)."""
    return UNet2DConfig(
        sample_size=64,
        block_out_channels=(128, 256, 256, 256, 512),
        down_block_types=("DownBlock2D", "DownBlock2D", "AttnDownBlock2D",
                          "DownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "UpBlock2D", "AttnUpBlock2D",
                        "UpBlock2D", "UpBlock2D"),
        layers_per_block=2,
        downsample_padding=0,
        attention_head_dim=None,
        norm_num_groups=32,
        norm_eps=1e-6,
        freq_shift=1,
        flip_sin_to_cos=False,
        dropout=0.1,
    )


def ddpm_lsun256_config() -> UNet2DConfig:
    """LSUN church/bedroom 256x256 DDPM (ddpm_exp/configs/church.yml:
    ch=128, ch_mult [1,1,2,2,4,4], attn@16)."""
    return UNet2DConfig(
        sample_size=256,
        block_out_channels=(128, 128, 256, 256, 512, 512),
        down_block_types=("DownBlock2D", "DownBlock2D", "DownBlock2D",
                          "DownBlock2D", "AttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "AttnUpBlock2D", "UpBlock2D",
                        "UpBlock2D", "UpBlock2D", "UpBlock2D"),
        layers_per_block=2,
        downsample_padding=0,
        attention_head_dim=None,
        norm_num_groups=32,
        norm_eps=1e-6,
        freq_shift=1,
        flip_sin_to_cos=False,
    )


def ldm_celebahq256_config() -> UNet2DConfig:
    """CompVis/ldm-celebahq-256 UNet (diffusers LDMPipeline layout,
    ldm_prune.py:50-52): operates on 64x64 VQ latents."""
    return UNet2DConfig(
        sample_size=64,
        in_channels=3,
        out_channels=3,
        block_out_channels=(224, 448, 672, 896),
        down_block_types=("DownBlock2D", "AttnDownBlock2D",
                          "AttnDownBlock2D", "AttnDownBlock2D"),
        up_block_types=("AttnUpBlock2D", "AttnUpBlock2D",
                        "AttnUpBlock2D", "UpBlock2D"),
        layers_per_block=2,
        attention_head_dim=32,
        norm_num_groups=32,
        norm_eps=1e-6,
        freq_shift=0,
        flip_sin_to_cos=True,
    )
