"""UNetCond: PyTorch counterpart of ``diff_pruning_tpu/models/unet_cond.py``,
the LDM conditional UNet (CompVis openaimodel.UNetModel; the class-conditional
ImageNet-256 ``cin256-v2`` model and the other presets).

Same config schema (``UNetCondConfig``, JSON with ``_class_name``), the same
ChannelGraph built in the same order (attention-head grouping on every
q/k/v inner var, the context var fixed), and a module tree named after the
JAX param tree (``input_blocks/1/0/in_conv/kernel`` is
``input_blocks.1.0.in_conv.kernel``), so checkpoints cross between the
packages through ``utils/checkpoint.py``.

``forward`` takes and returns NHWC like the JAX model; inside, activations
are NCHW in ``torch.channels_last`` memory (see ``layers.py``). The JAX
model's ResBlock dropout is not ported: no JAX caller passes it a dropout
key (the LDM train step, ``cli/ldm_train.py``, runs without one). Mixed
precision is the caller's: ``call_in_dtype`` (``models/unet2d.py``) runs
the forward and backward with every parameter cast to bf16.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..pruning.graph import AxisRef, CatVar, ChannelGraph, ChannelVar
from .layers import (
    Conv2D,
    GroupNorm,
    Linear,
    Scope,
    SelfAttention2D,
    SpatialTransformer,
    _uniform_,
    get_timestep_embedding,
    upsample_nearest_2x,
)


@dataclasses.dataclass
class UNetCondConfig:
    """openaimodel.UNetModel config subset (cin256-v2.yaml unet_config)."""

    image_size: int = 64
    in_channels: int = 3
    out_channels: int = 3
    model_channels: int = 192
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (8, 4, 2)
    channel_mult: Tuple[int, ...] = (1, 2, 3, 5)
    num_heads: int = 1
    num_head_channels: int = -1
    transformer_depth: int = 1
    context_dim: Optional[int] = 512
    num_classes: Optional[int] = None  # additive label_emb variant
    dropout: float = 0.0
    norm_num_groups: int = 32
    # AttentionBlock instead of SpatialTransformer (openaimodel.py:278-341)
    use_spatial_transformer: bool = True
    # FiLM-style conditioning of the out-norm (openaimodel.py:237-246)
    use_scale_shift_norm: bool = False
    # resampling inside ResBlocks (openaimodel.py:207-216)
    resblock_updown: bool = False
    channel_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["_class_name"] = "UNetCond"
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "UNetCondConfig":
        d = json.loads(text)
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for key in ("attention_resolutions", "channel_mult"):
            if key in kw:
                kw[key] = tuple(kw[key])
        return cls(**kw)

    def with_channel_sizes(self, sizes: Dict[str, int]) -> "UNetCondConfig":
        return dataclasses.replace(self, channel_sizes=dict(sizes))


class _ScaleShiftProj(nn.Module):
    """The scale-shift ResBlock's emb_proj: kernel (2 out, temb) here,
    (temb, 2 out) in the checkpoint, [0:out] scale and [out:] shift, both
    halves indexed by the block's out var (the GEGLU two-part pattern)."""

    def __init__(self, g: ChannelGraph, path: str, temb_var: ChannelVar, out: ChannelVar, *,
                 device):
        super().__init__()
        o = out.size
        g.ref(f"{path}/kernel", 0, temb_var, "in")
        g.refs.append(AxisRef(f"{path}/kernel", 1, ((out, 0), (out, o)), "out"))
        g.refs.append(AxisRef(f"{path}/bias", 0, ((out, 0), (out, o)), "bias"))
        g._by_var = None
        self.kernel = nn.Parameter(torch.empty((2 * o, temb_var.size), device=device))
        self.bias = nn.Parameter(torch.empty((2 * o,), device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = math.sqrt(1.0 / self.kernel.shape[1])
        _uniform_(self.kernel, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, temb: torch.Tensor) -> torch.Tensor:
        return F.linear(temb, self.kernel, self.bias)


class _ResBlock(nn.Module):
    """openaimodel ResBlock:163-264: in_norm/SiLU/in_conv; SiLU/emb_proj;
    out_norm/SiLU/out_conv (zero-initialised); 1x1 skip when the channels
    differ. With ``use_scale_shift_norm`` the embedding FiLMs the out-norm;
    with up/down the block resamples h and the residual between in_norm and
    in_conv."""

    def __init__(self, scope: Scope, g: ChannelGraph, cfg: UNetCondConfig, cin,
                 default_out: int, temb_var: ChannelVar, default_in: int,
                 up: bool = False, down: bool = False, *, device):
        super().__init__()
        dev = dict(device=device)
        self.up, self.down = up, down
        self.scale_shift = cfg.use_scale_shift_norm
        self.has_shortcut = default_in != default_out
        if self.has_shortcut:
            self.out = g.var(scope.path + "/out",
                             cfg.channel_sizes.get(scope.path + "/out", default_out))
        else:
            assert isinstance(cin, ChannelVar)
            self.out = cin
        self.in_norm = GroupNorm(scope("in_norm"), cin, cfg.norm_num_groups, 1e-5, **dev)
        self.in_conv = Conv2D(scope("in_conv"), cin, self.out, 3, 1, 1, **dev)
        if self.scale_shift:
            self.emb_proj = _ScaleShiftProj(g, scope.path + "/emb_proj", temb_var, self.out,
                                            **dev)
        else:
            self.emb_proj = Linear(scope("emb_proj"), temb_var, self.out, **dev)
        self.out_norm = GroupNorm(scope("out_norm"), self.out, cfg.norm_num_groups, 1e-5, **dev)
        self.out_conv = Conv2D(scope("out_conv"), self.out, self.out, 3, 1, 1, **dev)
        if self.has_shortcut:
            self.skip_connection = Conv2D(scope("skip_connection"), cin, self.out, 1, 1, 0,
                                          **dev)

    def zero_init_(self) -> None:
        """out_conv starts at zero (openaimodel.py:230 zero_module)."""
        with torch.no_grad():
            self.out_conv.kernel.zero_()
            self.out_conv.bias.zero_()

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.in_norm(x, with_silu=True)
        if self.up:
            h, x = upsample_nearest_2x(h), upsample_nearest_2x(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.in_conv(h)
        e = self.emb_proj(F.silu(temb))[:, :, None, None]
        if self.scale_shift:
            scale, shift = e.chunk(2, dim=1)
            h = F.silu(self.out_norm(h) * (1.0 + scale) + shift)
        else:
            h = self.out_norm(h + e, with_silu=True)
        h = self.out_conv(h)
        return h + (self.skip_connection(x) if self.has_shortcut else x)


class _NoContext(SelfAttention2D):
    """openaimodel AttentionBlock (no context): SelfAttention2D with the
    SpatialTransformer call signature; its params sit at the block's path."""

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        return super().forward(x)


class UNetCond(nn.Module):
    """Built once from a config on ``device``; parameters are allocated, not
    initialised: call :meth:`init` with a generator, or load a state dict.
    ``forward(x, timesteps, context=None, y=None)``, x (B, H, W, C)."""

    def __init__(self, cfg: UNetCondConfig, *, device):
        super().__init__()
        self.cfg = cfg
        g = self.graph = ChannelGraph()
        root = Scope(g)
        cs = cfg.channel_sizes
        dev = dict(device=device)

        def mkvar(name, default, **kw):
            return g.var(name, cs.get(name, default), **kw)

        self.attn_heads: Dict[str, int] = {}  # block path -> heads
        self.v_in = g.var("x_in", cfg.in_channels, prunable=False)
        self.v_out = g.var("x_out", cfg.out_channels, prunable=False)
        self.v_tproj = g.var("t_proj", cfg.model_channels, prunable=False)
        self.v_ctx = None
        if cfg.context_dim is not None:
            self.v_ctx = g.var("context", cfg.context_dim, prunable=False)

        ted = cfg.model_channels * 4
        self.v_temb_hidden = mkvar("time_embed/hidden", ted)
        self.v_temb = mkvar("time_embed/out", ted)
        te = root("time_embed")
        self.time_embed = nn.ModuleDict({
            "0": Linear(te("0"), self.v_tproj, self.v_temb_hidden, **dev),
            "2": Linear(te("2"), self.v_temb_hidden, self.v_temb, **dev)})
        self.label_emb = None
        if cfg.num_classes is not None:
            root("label_emb").ref("weight", 1, self.v_temb, "out")
            self.label_emb = nn.Module()
            self.label_emb.weight = nn.Parameter(
                torch.empty((cfg.num_classes, self.v_temb.size), device=device))

        def heads_dimhead(ch_default: int) -> Tuple[int, int]:
            # openaimodel.py:545-553 (legacy, spatial transformer)
            if cfg.num_head_channels != -1:
                return ch_default // cfg.num_head_channels, cfg.num_head_channels
            return cfg.num_heads, ch_default // cfg.num_heads

        def make_st(name: str, var: ChannelVar, ch_default: int) -> nn.Module:
            heads, dim_head = heads_dimhead(ch_default)
            inner_default = heads * dim_head
            self.attn_heads[name] = heads
            inner = mkvar(f"{name}/inner", inner_default)
            if not cfg.use_spatial_transformer:
                return _NoContext(Scope(g, name), var, inner, heads,
                                  norm_num_groups=cfg.norm_num_groups, eps=1e-5, **dev)
            attn_vars = []
            for d in range(cfg.transformer_depth):
                a1 = mkvar(f"{name}/transformer_blocks/{d}/attn1/inner", inner_default)
                a2 = mkvar(f"{name}/transformer_blocks/{d}/attn2/inner", inner_default)
                ffv = mkvar(f"{name}/transformer_blocks/{d}/ff/inner", inner_default * 4)
                attn_vars.append((a1, a2, ffv))
            return SpatialTransformer(Scope(g, name), var, inner, heads, self.v_ctx,
                                      depth=cfg.transformer_depth,
                                      norm_num_groups=cfg.norm_num_groups,
                                      attn_inner_vars=attn_vars, **dev)

        def resblock(path, cin, default_out, default_in, **kw):
            return _ResBlock(Scope(g, path), g, cfg, cin, default_out, self.v_temb, default_in,
                             **kw, **dev)

        mc = cfg.model_channels
        v0 = mkvar("input_blocks/0/conv/out", mc)
        self.input_blocks = nn.ModuleDict({"0": nn.ModuleDict(
            {"conv": Conv2D(root("input_blocks/0/conv"), self.v_in, v0, 3, 1, 1, **dev)})})

        # input blocks: ("res" | "downres" | "down", block index)
        self._input_kinds: List[Tuple[str, str]] = []
        skips: List[ChannelVar] = [v0]
        skip_defaults = [mc]
        cur, cur_d = v0, mc
        ds, idx = 1, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                name = f"input_blocks/{idx}"
                rb = resblock(f"{name}/0", cur, mult * mc, cur_d)
                blk = nn.ModuleDict({"0": rb})
                cur, cur_d = rb.out, mult * mc
                if ds in cfg.attention_resolutions:
                    blk["1"] = make_st(f"{name}/1", cur, cur_d)
                self.input_blocks[str(idx)] = blk
                self._input_kinds.append(("res", str(idx)))
                skips.append(cur)
                skip_defaults.append(cur_d)
                idx += 1
            if level != len(cfg.channel_mult) - 1:
                name = f"input_blocks/{idx}/0"
                if cfg.resblock_updown:
                    rb = resblock(name, cur, cur_d, cur_d, down=True)
                    self.input_blocks[str(idx)] = nn.ModuleDict({"0": rb})
                    self._input_kinds.append(("downres", str(idx)))
                    cur = rb.out
                else:
                    dsv = mkvar(f"{name}/out", cur_d)
                    conv = Conv2D(Scope(g, f"{name}/op"), cur, dsv, 3, 2, 1, **dev)
                    self.input_blocks[str(idx)] = nn.ModuleDict(
                        {"0": nn.ModuleDict({"op": conv})})
                    self._input_kinds.append(("down", str(idx)))
                    cur = dsv
                skips.append(cur)
                skip_defaults.append(cur_d)
                ds *= 2
                idx += 1

        # middle
        mid_res1 = resblock("middle_block/0", cur, cur_d, cur_d)
        mid_st = make_st("middle_block/1", mid_res1.out, cur_d)
        mid_res2 = resblock("middle_block/2", mid_res1.out, cur_d, cur_d)
        self.middle_block = nn.ModuleDict({"0": mid_res1, "1": mid_st, "2": mid_res2})
        cur = mid_res2.out

        # output blocks: (has transformer, upsampler key or None)
        self.output_blocks = nn.ModuleDict()
        self._output_kinds: List[Tuple[bool, Optional[str]]] = []
        oidx = 0
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                skip_v, skip_d = skips.pop(), skip_defaults.pop()
                name = f"output_blocks/{oidx}"
                rb = resblock(f"{name}/0", CatVar((cur, skip_v)), mult * mc, cur_d + skip_d)
                blk = nn.ModuleDict({"0": rb})
                cur, cur_d = rb.out, mult * mc
                has_st = ds in cfg.attention_resolutions
                if has_st:
                    blk["1"] = make_st(f"{name}/1", cur, cur_d)
                li = None
                if level and i == cfg.num_res_blocks:
                    li = "2" if has_st else "1"
                    if cfg.resblock_updown:
                        up = resblock(f"{name}/{li}", cur, cur_d, cur_d, up=True)
                        blk[li] = up
                        cur = up.out
                    else:
                        upv = mkvar(f"{name}/{li}/out", cur_d)
                        blk[li] = nn.ModuleDict({"conv": Conv2D(
                            Scope(g, f"{name}/{li}/conv"), cur, upv, 3, 1, 1, **dev)})
                        cur = upv
                    ds //= 2
                self.output_blocks[str(oidx)] = blk
                self._output_kinds.append((has_st, li))
                oidx += 1
        assert not skips

        self.out = nn.ModuleDict({
            "0": GroupNorm(root("out/0"), cur, cfg.norm_num_groups, 1e-5, **dev),
            "2": Conv2D(root("out/2"), cur, self.v_out, 3, 1, 1, **dev)})

    # -- params -------------------------------------------------------------

    def init(self, generator: torch.Generator) -> "UNetCond":
        """Random initialisation (torch's default layer init, as in JAX), with
        the zero-initialised leaves of the reference: every ResBlock's
        out_conv, every SpatialTransformer's proj_out and the final conv."""
        for m in self.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        if self.label_emb is not None:
            with torch.no_grad():
                self.label_emb.weight.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if hasattr(m, "zero_init_"):
                m.zero_init_()
        with torch.no_grad():
            self.out["2"].kernel.zero_()
            self.out["2"].bias.zero_()
        return self

    # -- forward --------------------------------------------------------------

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, H, W, C) latent; timesteps (B,) or scalar; context (B, N,
        context_dim); y (B,) labels for ``num_classes`` models. NHWC out."""
        cfg = self.cfg
        timesteps = torch.as_tensor(timesteps, device=x.device)
        if timesteps.ndim == 0:
            timesteps = timesteps[None].expand(x.shape[0])
        # util.timestep_embedding: cos-then-sin, divisor half (no shift)
        t_emb = get_timestep_embedding(timesteps, cfg.model_channels, flip_sin_to_cos=True,
                                       downscale_freq_shift=0.0).to(x.dtype)
        emb = self.time_embed["2"](F.silu(self.time_embed["0"](t_emb)))
        if self.label_emb is not None:
            if y is None:
                raise ValueError("y (class labels) required when num_classes set")
            emb = emb + self.label_emb.weight[y].to(emb.dtype)

        h = self.input_blocks["0"]["conv"](
            x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        hs = [h]
        for kind, idx in self._input_kinds:
            blk = self.input_blocks[idx]
            if kind == "down":
                h = blk["0"]["op"](h)
            else:
                h = blk["0"](h, emb)
                if "1" in blk:
                    h = blk["1"](h, context)
            hs.append(h)

        mid = self.middle_block
        h = mid["2"](mid["1"](mid["0"](h, emb), context), emb)

        for (has_st, li), blk in zip(self._output_kinds, self.output_blocks.values()):
            h = blk["0"](torch.cat([h, hs.pop()], dim=1), emb)
            if has_st:
                h = blk["1"](h, context)
            if li is not None:
                if cfg.resblock_updown:
                    h = blk[li](h, emb)
                else:
                    h = blk[li]["conv"](upsample_nearest_2x(h))

        h = self.out["2"](self.out["0"](h, with_silu=True))
        return h.permute(0, 2, 3, 1)


def cin256_v2_config() -> UNetCondConfig:
    """configs/latent-diffusion/cin256-v2.yaml unet_config."""
    return UNetCondConfig(
        image_size=64, in_channels=3, out_channels=3, model_channels=192,
        num_res_blocks=2, attention_resolutions=(8, 4, 2),
        channel_mult=(1, 2, 3, 5), num_heads=1, transformer_depth=1,
        context_dim=512)


def celebahq_ldm_vq4_config() -> UNetCondConfig:
    """configs/latent-diffusion/celebahq-ldm-vq-4.yaml unet_config."""
    return UNetCondConfig(
        image_size=64, in_channels=3, out_channels=3, model_channels=224,
        num_res_blocks=2, attention_resolutions=(8, 4, 2),
        channel_mult=(1, 2, 3, 4), num_head_channels=32,
        context_dim=None, use_spatial_transformer=False)


def ffhq_ldm_vq4_config() -> UNetCondConfig:
    """configs/latent-diffusion/ffhq-ldm-vq-4.yaml (same UNet as celebahq)."""
    return celebahq_ldm_vq4_config()


def lsun_bedrooms_ldm_vq4_config() -> UNetCondConfig:
    """configs/latent-diffusion/lsun_bedrooms-ldm-vq-4.yaml (same UNet)."""
    return celebahq_ldm_vq4_config()


def lsun_churches_ldm_kl8_config() -> UNetCondConfig:
    """configs/latent-diffusion/lsun_churches-ldm-kl-8.yaml unet_config."""
    return UNetCondConfig(
        image_size=32, in_channels=4, out_channels=4, model_channels=192,
        num_res_blocks=2, attention_resolutions=(1, 2, 4, 8),
        channel_mult=(1, 2, 2, 4, 4), num_heads=8, context_dim=None,
        use_spatial_transformer=False, use_scale_shift_norm=True,
        resblock_updown=True)


def cin_ldm_vq_f8_config() -> UNetCondConfig:
    """configs/latent-diffusion/cin-ldm-vq-f8.yaml unet_config."""
    return UNetCondConfig(
        image_size=32, in_channels=4, out_channels=4, model_channels=256,
        num_res_blocks=2, attention_resolutions=(4, 2, 1),
        channel_mult=(1, 2, 4), num_head_channels=32,
        transformer_depth=1, context_dim=512)


def txt2img_1p4B_config() -> UNetCondConfig:
    """configs/latent-diffusion/txt2img-1p4B-eval.yaml unet_config."""
    return UNetCondConfig(
        image_size=32, in_channels=4, out_channels=4, model_channels=320,
        num_res_blocks=2, attention_resolutions=(4, 2, 1),
        channel_mult=(1, 2, 4, 4), num_heads=8, transformer_depth=1,
        context_dim=1280)


def bsr_sr_config() -> UNetCondConfig:
    """models/ldm/bsr_sr/config.yaml (concat-mode conditioning)."""
    return UNetCondConfig(
        image_size=64, in_channels=6, out_channels=3, model_channels=160,
        num_res_blocks=2, attention_resolutions=(16, 8),
        channel_mult=(1, 2, 2, 4), num_head_channels=32, context_dim=None,
        use_spatial_transformer=False)


def layout2img_openimages256_config() -> UNetCondConfig:
    """models/ldm/layout2img-openimages256/config.yaml."""
    return UNetCondConfig(
        image_size=64, in_channels=3, out_channels=3, model_channels=128,
        num_res_blocks=2, attention_resolutions=(8, 4, 2),
        channel_mult=(1, 2, 3, 4), num_head_channels=32,
        transformer_depth=3, context_dim=512)


def semantic_synthesis256_config() -> UNetCondConfig:
    """models/ldm/semantic_synthesis256/config.yaml (its attention
    resolutions never match the 3-level ds values: mid-block attention only)."""
    return UNetCondConfig(
        image_size=64, in_channels=6, out_channels=3, model_channels=128,
        num_res_blocks=2, attention_resolutions=(32, 16, 8),
        channel_mult=(1, 4, 8), num_heads=8, context_dim=None,
        use_spatial_transformer=False)


def semantic_synthesis512_config() -> UNetCondConfig:
    """models/ldm/semantic_synthesis512/config.yaml (the 256 UNet at 128-res latents)."""
    return dataclasses.replace(semantic_synthesis256_config(), image_size=128)


def text2img256_config() -> UNetCondConfig:
    """models/ldm/text2img256/config.yaml."""
    return UNetCondConfig(
        image_size=64, in_channels=3, out_channels=3, model_channels=192,
        num_res_blocks=2, attention_resolutions=(8, 4, 2),
        channel_mult=(1, 2, 3, 5), num_head_channels=32,
        transformer_depth=1, context_dim=640)


def rdm768_config() -> UNetCondConfig:
    """configs/retrieval-augmented-diffusion/768x768.yaml unet_config."""
    return UNetCondConfig(
        image_size=48, in_channels=16, out_channels=16, model_channels=448,
        num_res_blocks=2, attention_resolutions=(4, 2, 1),
        channel_mult=(1, 2, 3, 4), num_head_channels=32,
        transformer_depth=1, context_dim=768)


def inpainting_big_config() -> UNetCondConfig:
    """models/ldm/inpainting_big/config.yaml unet_config (concat-mode)."""
    return UNetCondConfig(
        image_size=64, in_channels=7, out_channels=3, model_channels=256,
        num_res_blocks=2, attention_resolutions=(8, 4, 2),
        channel_mult=(1, 2, 3, 4), num_heads=8, context_dim=None,
        use_spatial_transformer=False, resblock_updown=True)


def tiny_cond_config() -> UNetCondConfig:
    return UNetCondConfig(
        image_size=8, in_channels=3, out_channels=3, model_channels=32,
        num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
        num_heads=2, transformer_depth=1, context_dim=16, norm_num_groups=8)
