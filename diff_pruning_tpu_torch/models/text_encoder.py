"""BERTEmbedder, the text encoder of the txt2img-1p4B LDM: counterpart of
``diff_pruning_tpu/models/text_encoder.py``.

The reference's conditioning stack for
configs/latent-diffusion/txt2img-1p4B-eval.yaml: BERTEmbedder
(ldm_exp/ldm/modules/encoders/modules.py:80-104) over x-transformers'
``TransformerWrapper(num_tokens, max_seq_len, Encoder(dim, depth))``
(ldm/modules/x_transformer.py): token and learned position embeddings,
pre-norm blocks (LayerNorm, 8-head self-attention with dim_head 64, so the
attention's inner width is 512 whatever the 1280-wide residual stream;
LayerNorm, Linear(d, 4d), exact GELU, Linear(4d, d)), plain residuals, a
final LayerNorm, and a ``to_logits`` Linear that is kept (it counts
parameters) though the embedder always returns the embeddings.

Every width is a ChannelVar of the module's ChannelGraph, registered under
the JAX param paths (``token_emb/embedding``, ``layers/{i}/attn/to_q/kernel``,
...), so checkpoints cross between the packages. The self-attention is the
port's :class:`~diff_pruning_tpu_torch.models.layers.CrossAttention`: on the
card its 77-token attention launches the attention forward kernel.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..pruning.graph import ChannelGraph
from .layers import CrossAttention, LayerNorm, Linear, Scope


@dataclasses.dataclass(frozen=True)
class BERTEmbedderConfig:
    """BERTEmbedder(n_embed=1280, n_layer=32) in the txt2img yaml."""

    n_embed: int = 1280
    n_layer: int = 32
    vocab_size: int = 30522
    max_seq_len: int = 77
    heads: int = 8
    dim_head: int = 64  # x_transformer.py:12 DEFAULT_DIM_HEAD
    ff_mult: int = 4
    channel_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def with_channel_sizes(self, sizes: Dict[str, int]) -> "BERTEmbedderConfig":
        return dataclasses.replace(self, channel_sizes=dict(sizes))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "BERTEmbedderConfig":
        return cls(**json.loads(s))


def bert_txt2img_config() -> BERTEmbedderConfig:
    """cond_stage_config of txt2img-1p4B-eval.yaml (n_embed 1280, 32 layers)."""
    return BERTEmbedderConfig()


def tiny_bert_config() -> BERTEmbedderConfig:
    return BERTEmbedderConfig(n_embed=16, n_layer=2, vocab_size=40, max_seq_len=11, heads=2,
                              dim_head=4)


class BERTEmbedder(nn.Module):
    """Token ids (B, N) -> embeddings (B, N, n_embed)."""

    def __init__(self, cfg: BERTEmbedderConfig, *, device):
        super().__init__()
        self.cfg = cfg
        g = self.graph = ChannelGraph()
        cs = cfg.channel_sizes
        dev = dict(device=device)

        def mk(name: str, default: int, **kw):
            return g.var(name, cs.get(name, default), **kw)

        dim = mk("dim", cfg.n_embed)
        s = Scope(g)
        g.ref("token_emb/embedding", 1, dim, "out")
        g.ref("pos_emb/embedding", 1, dim, "out")
        self.token_emb = nn.Module()
        self.token_emb.embedding = nn.Parameter(torch.empty((cfg.vocab_size, dim.size), **dev))
        self.pos_emb = nn.Module()
        self.pos_emb.embedding = nn.Parameter(torch.empty((cfg.max_seq_len, dim.size), **dev))
        self.layers = nn.ModuleDict()
        for i in range(cfg.n_layer):
            bs = s(f"layers/{i}")
            inner = mk(f"attn{i}.inner", cfg.heads * cfg.dim_head)
            ffin = mk(f"ff{i}.inner", cfg.n_embed * cfg.ff_mult)
            blk = nn.ModuleDict()
            blk["attn_norm"] = LayerNorm(bs("attn_norm"), dim, **dev)
            blk["attn"] = CrossAttention(bs("attn"), dim, inner, cfg.heads, **dev)
            blk["ff_norm"] = LayerNorm(bs("ff_norm"), dim, **dev)
            blk["ff"] = nn.ModuleDict({"fc1": Linear(bs("ff/fc1"), dim, ffin, **dev),
                                       "fc2": Linear(bs("ff/fc2"), ffin, dim, **dev)})
            self.layers[str(i)] = blk
        self.norm = LayerNorm(s("norm"), dim, **dev)
        vocab = mk("vocab", cfg.vocab_size, prunable=False)
        self.to_logits = Linear(s("to_logits"), dim, vocab, **dev)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Embeddings normal(std 0.02) (x_transformer.py), the linears
        torch's default init, the norms ones and zeros."""
        with torch.no_grad():
            self.token_emb.embedding.normal_(0.0, 0.02, generator=generator)
            self.pos_emb.embedding.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, (Linear, LayerNorm)):
                m.reset_parameters(generator)

    def init(self, generator: torch.Generator) -> "BERTEmbedder":
        self.reset_parameters(generator)
        return self

    def forward(self, tokens: torch.Tensor, *, return_embeddings: bool = True) -> torch.Tensor:
        """tokens (B, N) int ids -> (B, N, dim) embeddings (or vocab logits).
        An id outside the table raises (the CLI checks its vocab first)."""
        n = tokens.shape[1]
        x = self.token_emb.embedding[tokens.long()]
        x = x + self.pos_emb.embedding[None, :n].to(x.dtype)
        for blk in self.layers.values():
            x = blk["attn"](blk["attn_norm"](x)) + x
            h = blk["ff"]["fc1"](blk["ff_norm"](x))
            x = blk["ff"]["fc2"](F.gelu(h)) + x
        x = self.norm(x)
        return x if return_embeddings else self.to_logits(x)
