"""CLIP text and vision towers: counterpart of ``diff_pruning_tpu/models/clip.py``
(the reference's retrieval and conditioning encoders,
ldm_exp/ldm/modules/encoders/modules.py:138-201 FrozenCLIPTextEmbedder /
FrozenClipImageEmbedder over OpenAI ``clip.load``, driven by
scripts/knn2img.py and scripts/train_searcher.py).

OpenAI CLIP (ViT-L/14 by default): pre-LN residual blocks with QuickGELU
MLPs and biased q/k/v; the text tower is causal and pools the features at
the end-of-text token (the largest id of each row) through a learned
projection; the vision tower is a patch-conv ViT with a class token,
ln_pre/ln_post and a projection. Images are NHWC. Every width is a
ChannelVar of the module's ChannelGraph, registered under the JAX param
paths (``text/resblocks/{i}/attn/q/kernel``, ``vision/conv1/kernel``, ...),
so a CLIP dir (``config.json`` + ``params.npz``) crosses between the
packages through ``utils/checkpoint.py``.

The attention stays plain tensor ops (a matmul, a causal mask, a softmax),
as in the JAX package's ``_ClipBlock``: no kernel of either package serves
it.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..pruning.graph import ChannelGraph
from .latent_diffusion import _keys_cubic, _resize_weights
from .layers import LayerNorm, Linear, Scope


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Both towers (clip.model.CLIP's constructor arguments for ViT-L/14)."""

    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    image_size: int = 224
    patch_size: int = 14
    vision_width: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    embed_dim: int = 768
    channel_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def with_channel_sizes(self, sizes: Dict[str, int]) -> "CLIPConfig":
        return dataclasses.replace(self, channel_sizes=dict(sizes))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "CLIPConfig":
        return cls(**json.loads(s))


def clip_vit_l14_config() -> CLIPConfig:
    """The reference's retriever_version='ViT-L/14' (knn2img.py:143)."""
    return CLIPConfig()


def tiny_clip_config() -> CLIPConfig:
    return CLIPConfig(vocab_size=50, context_length=10, text_width=16, text_layers=2,
                      text_heads=2, image_size=16, patch_size=8, vision_width=16,
                      vision_layers=2, vision_heads=2, embed_dim=12)


class _ClipBlock(nn.Module):
    """Pre-LN residual block: x += attn(ln_1(x)); x += mlp(ln_2(x))."""

    def __init__(self, scope: Scope, dim, inner, ffin, heads: int, causal: bool, *, device):
        super().__init__()
        dev = dict(device=device)
        self.heads, self.causal, self.inner = heads, causal, inner
        inner.require_group_div(heads)
        self.ln_1 = LayerNorm(scope("ln_1"), dim, **dev)
        self.attn = nn.ModuleDict({"q": Linear(scope("attn/q"), dim, inner, **dev),
                                   "k": Linear(scope("attn/k"), dim, inner, **dev),
                                   "v": Linear(scope("attn/v"), dim, inner, **dev),
                                   "out": Linear(scope("attn/out"), inner, dim, **dev)})
        self.ln_2 = LayerNorm(scope("ln_2"), dim, **dev)
        self.mlp = nn.ModuleDict({"c_fc": Linear(scope("mlp/c_fc"), dim, ffin, **dev),
                                  "c_proj": Linear(scope("mlp/c_proj"), ffin, dim, **dev)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h = self.ln_1(x)
        nh = self.heads
        dh = self.inner.size // nh

        def split(t):  # (B, N, inner) -> (B, heads, N, dh)
            return t.view(b, n, nh, dh).transpose(1, 2)

        q, k, v = (split(self.attn[name](h)) for name in ("q", "k", "v"))
        sim = (q.float() @ k.float().transpose(-1, -2)) * (dh ** -0.5)
        if self.causal:
            mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
            sim = sim.masked_fill(~mask, float("-inf"))
        o = torch.softmax(sim, dim=-1).to(v.dtype) @ v
        x = x + self.attn["out"](o.transpose(1, 2).reshape(b, n, self.inner.size))
        return x + self.mlp["c_proj"](quick_gelu(self.mlp["c_fc"](self.ln_2(x))))


class CLIP(nn.Module):
    """Both towers; ``encode_text`` / ``encode_image`` as clip.model.CLIP."""

    def __init__(self, cfg: CLIPConfig, *, device):
        super().__init__()
        self.cfg = cfg
        g = self.graph = ChannelGraph()
        cs = cfg.channel_sizes
        dev = dict(device=device)

        def mk(name, default, **kw):
            return g.var(name, cs.get(name, default), **kw)

        s = Scope(g)
        td = mk("text/dim", cfg.text_width)
        embed = mk("embed", cfg.embed_dim, prunable=False)
        g.ref("text/token_embedding", 1, td, "out")
        g.ref("text/positional_embedding", 1, td, "out")
        self.text = nn.Module()
        self.text.token_embedding = nn.Parameter(torch.empty((cfg.vocab_size, td.size), **dev))
        self.text.positional_embedding = nn.Parameter(
            torch.empty((cfg.context_length, td.size), **dev))
        self.text.resblocks = nn.ModuleDict()
        for i in range(cfg.text_layers):
            inner = mk(f"text/attn{i}.inner", cfg.text_width)
            ffin = mk(f"text/ff{i}.inner", 4 * cfg.text_width)
            self.text.resblocks[str(i)] = _ClipBlock(s(f"text/resblocks/{i}"), td, inner, ffin,
                                                     cfg.text_heads, True, **dev)
        self.text.ln_final = LayerNorm(s("text/ln_final"), td, **dev)
        g.ref("text/projection", 0, td, "in")
        g.ref("text/projection", 1, embed, "out")
        self.text.projection = nn.Parameter(torch.empty((td.size, cfg.embed_dim), **dev))

        vd = mk("vision/dim", cfg.vision_width)
        g.ref("vision/conv1/kernel", 3, vd, "out")
        g.ref("vision/class_embedding", 0, vd, "out")
        g.ref("vision/positional_embedding", 1, vd, "out")
        ps, n_patches = cfg.patch_size, (cfg.image_size // cfg.patch_size) ** 2
        self.vision = nn.Module()
        self.vision.conv1 = nn.Module()  # OIHW here, HWIO in the checkpoint
        self.vision.conv1.kernel = nn.Parameter(torch.empty((vd.size, 3, ps, ps), **dev))
        self.vision.class_embedding = nn.Parameter(torch.empty((vd.size,), **dev))
        self.vision.positional_embedding = nn.Parameter(
            torch.empty((n_patches + 1, vd.size), **dev))
        self.vision.ln_pre = LayerNorm(s("vision/ln_pre"), vd, **dev)
        self.vision.resblocks = nn.ModuleDict()
        for i in range(cfg.vision_layers):
            inner = mk(f"vision/attn{i}.inner", cfg.vision_width)
            ffin = mk(f"vision/ff{i}.inner", 4 * cfg.vision_width)
            self.vision.resblocks[str(i)] = _ClipBlock(s(f"vision/resblocks/{i}"), vd, inner,
                                                       ffin, cfg.vision_heads, False, **dev)
        self.vision.ln_post = LayerNorm(s("vision/ln_post"), vd, **dev)
        g.ref("vision/projection", 0, vd, "in")
        g.ref("vision/projection", 1, embed, "out")
        self.vision.projection = nn.Parameter(torch.empty((vd.size, cfg.embed_dim), **dev))
        self.logit_scale = nn.Parameter(torch.empty((), **dev))

    def init(self, generator: torch.Generator) -> "CLIP":
        """The JAX package's init scales: embeddings normal(0.02 / 0.01), the
        projections, patch conv and vision embeddings normal(width^-0.5), the
        linears torch's default, logit_scale log(1 / 0.07)."""
        t, v = self.text, self.vision
        with torch.no_grad():
            t.token_embedding.normal_(0.0, 0.02, generator=generator)
            t.positional_embedding.normal_(0.0, 0.01, generator=generator)
            t.projection.normal_(0.0, t.projection.shape[0] ** -0.5, generator=generator)
            vd = v.class_embedding.shape[0]
            for p in (v.conv1.kernel, v.class_embedding, v.positional_embedding, v.projection):
                p.normal_(0.0, vd ** -0.5, generator=generator)
            self.logit_scale.fill_(math.log(1 / 0.07))
        for m in self.modules():
            if isinstance(m, (Linear, LayerNorm)):
                m.reset_parameters(generator)
        return self

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, N) int ids -> (B, embed_dim), pooled at the argmax id (the
        end-of-text token, the largest id of every tokenized row)."""
        t = self.text
        tokens = tokens.long()
        n = tokens.shape[1]
        x = t.token_embedding[tokens] + t.positional_embedding[None, :n]
        for blk in t.resblocks.values():
            x = blk(x)
        x = t.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return pooled @ t.projection.to(pooled.dtype)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) preprocessed images -> (B, embed_dim)."""
        v = self.vision
        ps = self.cfg.patch_size
        x = F.conv2d(images.permute(0, 3, 1, 2), v.conv1.kernel.to(images.dtype), stride=ps)
        b, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # (B, patches, C), patches row-major
        cls = v.class_embedding.to(x.dtype).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1) + v.positional_embedding[None].to(x.dtype)
        x = v.ln_pre(x)
        for blk in v.resblocks.values():
            x = blk(x)
        pooled = v.ln_post(x[:, 0])
        return pooled @ v.projection.to(pooled.dtype)


# FrozenCLIPTextEmbedder / FrozenClipImageEmbedder equivalents

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_text_embed(model: CLIP, tokens: torch.Tensor, *, normalize: bool = True,
                    n_repeat: int = 1) -> torch.Tensor:
    """FrozenCLIPTextEmbedder.encode (modules.py:155-167): encode_text,
    L2-normalised, (B, D) -> (B, n_repeat, D) for cross-attention."""
    z = model.encode_text(tokens)
    if normalize:
        z = z / torch.linalg.norm(z, dim=1, keepdim=True)
    return z[:, None, :].repeat(1, n_repeat, 1)


def clip_preprocess_images(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """FrozenClipImageEmbedder.preprocess (modules.py:189-197): [-1, 1] NHWC
    -> resized to ``image_size``, [0, 1], CLIP-normalised. The resize is
    ``jax.image.resize(method="cubic")``'s: Keys' cubic at a = -0.5,
    antialiased when it shrinks, each axis whose size changes."""
    b, h, w, c = images.shape
    if h != image_size:
        images = torch.einsum("bhwc,hH->bHwc", images, _resize_weights(
            h, image_size, _keys_cubic, images.device).to(images.dtype))
    if w != image_size:
        images = torch.einsum("bhwc,wW->bhWc", images, _resize_weights(
            w, image_size, _keys_cubic, images.device).to(images.dtype))
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(CLIP_IMAGE_STD, dtype=images.dtype, device=images.device)
    return ((images + 1.0) / 2.0 - mean) / std


def clip_image_embed(model: CLIP, images: torch.Tensor) -> torch.Tensor:
    """FrozenClipImageEmbedder.forward: images in [-1, 1] NHWC."""
    return model.encode_image(clip_preprocess_images(images, model.cfg.image_size))


def openai_clip_state_dict_to_params(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """An OpenAI CLIP state_dict (what ``clip.load`` saves) -> a state dict
    of :class:`CLIP` (both towers, or the text tower alone when the dict has
    no ``visual.*``). The fused (3W, W) ``in_proj`` splits into q, k and v in
    torch MultiheadAttention's order; the projections keep their (width,
    embed) layout."""
    from ..utils.checkpoint import state_dict_from_flat

    def arr(k):
        v = sd[k]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)

    flat = {}

    def block(prefix, path):
        inw, inb = arr(f"{prefix}.attn.in_proj_weight"), arr(f"{prefix}.attn.in_proj_bias")
        w = inw.shape[0] // 3
        for j, name in enumerate("qkv"):
            flat[f"{path}/attn/{name}/kernel"] = inw[j * w:(j + 1) * w].T
            flat[f"{path}/attn/{name}/bias"] = inb[j * w:(j + 1) * w]
        for ours, theirs in (("attn/out", "attn.out_proj"), ("mlp/c_fc", "mlp.c_fc"),
                             ("mlp/c_proj", "mlp.c_proj")):
            flat[f"{path}/{ours}/kernel"] = arr(f"{prefix}.{theirs}.weight").T
            flat[f"{path}/{ours}/bias"] = arr(f"{prefix}.{theirs}.bias")
        for ln in ("ln_1", "ln_2"):
            flat[f"{path}/{ln}/scale"] = arr(f"{prefix}.{ln}.weight")
            flat[f"{path}/{ln}/bias"] = arr(f"{prefix}.{ln}.bias")

    def blocks(prefix, path):
        i = 0
        while f"{prefix}.{i}.ln_1.weight" in sd:
            block(f"{prefix}.{i}", f"{path}/{i}")
            i += 1

    flat["text/token_embedding"] = arr("token_embedding.weight")
    flat["text/positional_embedding"] = arr("positional_embedding")
    blocks("transformer.resblocks", "text/resblocks")
    flat["text/ln_final/scale"], flat["text/ln_final/bias"] = (arr("ln_final.weight"),
                                                               arr("ln_final.bias"))
    flat["text/projection"] = arr("text_projection")
    if "visual.conv1.weight" in sd:
        flat["vision/conv1/kernel"] = arr("visual.conv1.weight").transpose(2, 3, 1, 0)
        flat["vision/class_embedding"] = arr("visual.class_embedding")
        flat["vision/positional_embedding"] = arr("visual.positional_embedding")
        for ln in ("ln_pre", "ln_post"):
            flat[f"vision/{ln}/scale"] = arr(f"visual.{ln}.weight")
            flat[f"vision/{ln}/bias"] = arr(f"visual.{ln}.bias")
        blocks("visual.transformer.resblocks", "vision/resblocks")
        flat["vision/projection"] = arr("visual.proj")
    if "logit_scale" in sd:
        flat["logit_scale"] = arr("logit_scale")
    return state_dict_from_flat(flat)
