"""Checkpoint conversion: diffusers, CompVis, ermongroup-DDIM, x-transformers and
taming state dicts <-> the port's state dicts (counterpart of
``diff_pruning_tpu/utils/convert.py``).

The port's modules are named after the JAX package's param trees, so a
converter here maps a source state dict onto the keys that
``utils.checkpoint.state_dict_from_flat`` gives: the JAX path with ``.`` for
``/``, conv kernels OIHW and linear kernels (dout, din), which is the torch
layout the sources already use. Most leaves are therefore renames
(``weight`` -> ``kernel`` for convs and linears, ``scale`` for norms); the
reshapes are the 1x1 attention convs of the DDIM and CompVis codebases
(squeezed to linears) and the fused, head-interleaved qkv of CompVis
AttentionBlocks. Every converter gives exactly the arrays the JAX one
gives, in the port's layout.

Values may be torch tensors or numpy arrays; the results are contiguous CPU
tensors. A diffusers ``.safetensors`` file is read and written by a private
helper of this module (the format: an 8-byte little-endian header length, a
JSON header of dtype, shape and byte offsets, then the raw little-endian
tensors), so no ``safetensors`` package is needed; ``.bin`` files go through
``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, Mapping

import numpy as np
import torch

# -- safetensors ---------------------------------------------------------------

# the format's dtype names; ``_ST_ORDER`` is the order in which the reference
# writer lays tensors out (larger dtypes first, then by name)
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}
_ST_ORDER = ("BOOL", "U8", "I8", "I16", "F16", "BF16", "I32", "F32", "F64", "I64")


def _read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors (its ``__metadata__`` ignored)."""
    buf = bytearray(os.path.getsize(path))  # writable: torch.frombuffer wants it
    with open(path, "rb") as f:
        f.readinto(buf)
    if len(buf) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (n,) = struct.unpack_from("<Q", buf, 0)
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header length {n} beyond the file's {len(buf)} bytes")
    header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name}: dtype {info['dtype']} is not read here")
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or base + end > len(buf):
            raise ValueError(f"{path}: {name}: offsets {begin}-{end} do not hold {shape}")
        t = torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin) if count else \
            torch.empty((0,), dtype=dtype)
        out[name] = t.reshape(shape).clone()
    return out


def _write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                       metadata: Mapping[str, str] = None) -> None:
    """Writes ``tensors`` (torch tensors or numpy arrays) as a ``.safetensors``
    file laid out as the reference writer lays it out: larger dtypes first,
    then by name, the header padded with spaces to 8 bytes."""
    items = []
    for name, v in tensors.items():
        t = torch.as_tensor(v).detach().cpu().contiguous()
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} is not written here")
        items.append((name, t))
    items.sort(key=lambda kv: (-_ST_ORDER.index(_ST_NAMES[kv[1].dtype]), kv[0]))
    header = {} if metadata is None else {"__metadata__": dict(metadata)}
    offset, blobs = 0, []
    for name, t in items:
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
        blobs.append(data)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


# -- helpers -------------------------------------------------------------------

def _t(v) -> torch.Tensor:
    """A source value (tensor or array) as a CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


def _leaf(stem, leaf: str, t: torch.Tensor, tables=()):
    """The port's leaf name for a torch ``weight``: ``kernel`` for a conv (4-D)
    or a linear (2-D, unless its module is one of ``tables``, an embedding
    table that keeps ``weight``), ``scale`` for a norm's 1-D gamma."""
    if leaf != "weight":
        return leaf
    if t.ndim == 4 or (t.ndim == 2 and not (stem and stem[-1] in tables)):
        return "kernel"
    if t.ndim == 2:
        return "weight"
    return "scale"


def _done(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.contiguous() for k, v in sd.items()}


# -- diffusers UNet2DModel -----------------------------------------------------

def torch_state_dict_to_params(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A diffusers ``UNet2DModel`` state dict -> the port's UNet2D state dict:
    ``to_out.0.`` -> ``to_out.``, ``weight`` -> ``kernel``/``scale``
    (``class_embedding``/``embedding`` tables keep ``weight``)."""
    out = {}
    for name, v in sd.items():
        t = _t(v)
        parts = name.split(".")
        # to_out.0 is the Linear of a ModuleList whose index 1 is a Dropout
        if len(parts) >= 3 and parts[-2] == "0" and parts[-3] == "to_out":
            parts = parts[:-2] + [parts[-1]]
        stem = parts[:-1]
        out[".".join(stem + [_leaf(stem, parts[-1], t, ("class_embedding", "embedding"))])] = t
    return _done(out)


def params_to_torch_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse: a port UNet2D state dict -> diffusers names (numpy values;
    the caller wraps them in tensors)."""
    out = {}
    for key, v in state_dict.items():
        parts = key.split(".")
        leaf, stem = parts[-1], parts[:-1]
        if leaf in ("kernel", "scale"):
            leaf = "weight"
        if stem and stem[-1] == "to_out":
            stem = stem + ["0"]
        t = _t(v)
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        out[".".join(stem + [leaf])] = t.numpy()
    return out


def load_diffusers_unet_checkpoint(model_dir: str) -> Dict[str, torch.Tensor]:
    """A diffusers ``save_pretrained`` UNet dir (``diffusion_pytorch_model``
    ``.safetensors``, else ``.bin``) -> the port's state dict."""
    st_path = os.path.join(model_dir, "diffusion_pytorch_model.safetensors")
    bin_path = os.path.join(model_dir, "diffusion_pytorch_model.bin")
    if os.path.exists(st_path):
        return torch_state_dict_to_params(_read_safetensors(st_path))
    if os.path.exists(bin_path):
        return torch_state_dict_to_params(torch.load(bin_path, map_location="cpu",
                                                     weights_only=True))
    raise FileNotFoundError(f"no UNet weights in {model_dir}")


_EXPORT_DIFFUSERS_VERSION = "0.11.1"

# the DDPMScheduler / DDIMScheduler config keys beyond the shared beta family
# (diffusers' defaults at the version above)
_SCHEDULER_EXTRAS = {
    "DDPMScheduler": {"clip_sample": True, "variance_type": "fixed_small",
                      "prediction_type": "epsilon", "trained_betas": None},
    "DDIMScheduler": {"clip_sample": True, "set_alpha_to_one": True,
                      "steps_offset": 0, "prediction_type": "epsilon",
                      "trained_betas": None},
}


def export_diffusers_pipeline(dst: str, cfg, state_dict: Mapping[str, torch.Tensor], *,
                              pipeline_class: str = "DDPMPipeline",
                              scheduler_class: str = "DDPMScheduler",
                              num_train_timesteps: int = 1000,
                              beta_schedule: str = "linear",
                              beta_start: float = 0.0001,
                              beta_end: float = 0.02) -> None:
    """Writes a diffusers ``save_pretrained`` pipeline directory:

      dst/model_index.json
      dst/unet/{config.json, diffusion_pytorch_model.safetensors}
      dst/scheduler/scheduler_config.json

    ``unet/config.json`` keeps ``channel_sizes`` when the model is pruned
    (diffusers ignores keys it does not know), so :func:`load_diffusers_unet_checkpoint`
    and the JAX importer rebuild a pruned model; stock diffusers instantiates
    only unpruned shapes. bf16/f16 and f64 weights are written as f32."""
    unet_dir = os.path.join(dst, "unet")
    sched_dir = os.path.join(dst, "scheduler")
    os.makedirs(unet_dir, exist_ok=True)
    os.makedirs(sched_dir, exist_ok=True)
    with open(os.path.join(dst, "model_index.json"), "w") as f:
        json.dump({"_class_name": pipeline_class,
                   "_diffusers_version": _EXPORT_DIFFUSERS_VERSION,
                   "scheduler": ["diffusers", scheduler_class],
                   "unet": ["diffusers", "UNet2DModel"]}, f, indent=2)
    d = dataclasses.asdict(cfg)
    if not d.get("channel_sizes"):
        d.pop("channel_sizes", None)
    d["_class_name"] = "UNet2DModel"
    d["_diffusers_version"] = _EXPORT_DIFFUSERS_VERSION
    with open(os.path.join(unet_dir, "config.json"), "w") as f:
        json.dump(d, f, indent=2, sort_keys=True)
    sd = {k: (a.astype(np.float32) if a.dtype == np.float64 else a)
          for k, a in params_to_torch_state_dict(state_dict).items()}
    _write_safetensors(os.path.join(unet_dir, "diffusion_pytorch_model.safetensors"), sd)
    sched = {"_class_name": scheduler_class,
             "_diffusers_version": _EXPORT_DIFFUSERS_VERSION,
             "num_train_timesteps": num_train_timesteps,
             "beta_schedule": beta_schedule,
             "beta_start": beta_start, "beta_end": beta_end}
    sched.update(_SCHEDULER_EXTRAS.get(scheduler_class, {}))
    with open(os.path.join(sched_dir, "scheduler_config.json"), "w") as f:
        json.dump(sched, f, indent=2, sort_keys=True)


# -- CompVis LDM UNetModel (openaimodel) ----------------------------------------

_LDM_RENAMES = [
    ("in_layers.0.", "in_norm."),
    ("in_layers.2.", "in_conv."),
    ("emb_layers.1.", "emb_proj."),
    ("out_layers.0.", "out_norm."),
    ("out_layers.3.", "out_conv."),
    ("ff.net.0.proj.", "ff.proj."),
    ("ff.net.2.", "ff.out."),
    ("to_out.0.", "to_out."),
]


def ldm_unet_state_dict_to_params(sd: Mapping[str, object],
                                  attn_heads: Mapping[str, int] = None
                                  ) -> Dict[str, torch.Tensor]:
    """A CompVis ``openaimodel.UNetModel`` state dict -> the port's UNetCond
    state dict: ``input_blocks.0.0`` is ``input_blocks.0.conv``, the ResBlocks'
    sequential indices become named leaves (``_LDM_RENAMES``), the
    SpatialTransformer names pass through.

    A non-spatial-transformer AttentionBlock stores a fused qkv conv1d whose
    channels are head-interleaved ((B, 3C, T) viewed as (H, 3, ch, T)), so
    ``attn_heads`` (``UNetCond.attn_heads``: block path -> heads) is needed to
    split it into to_q/to_k/to_v; its norm and proj_out take the
    SelfAttention2D names."""
    out = {}
    qkv_blocks = {name.split(".qkv.")[0] for name in sd if ".qkv." in name}
    for name, v in sd.items():
        t = _t(v)
        n = name
        blk = n.rsplit(".", 2)[0] if n.count(".") >= 2 else ""
        if ".qkv." in n:
            block = n.split(".qkv.")[0]
            bpath = block.replace(".", "/")
            if attn_heads is None or bpath not in attn_heads:
                raise ValueError(f"fused qkv at {block}: pass attn_heads (UNetCond.attn_heads)")
            h = attn_heads[bpath]
            if n.endswith("weight"):  # conv1d (3C, C, 1)
                w = t[..., 0] if t.ndim == 3 else t
                c3, cin = w.shape
                w = w.reshape(h, 3, c3 // 3 // h, cin)
                for i, nm in enumerate(("to_q", "to_k", "to_v")):
                    out[f"{block}.{nm}.kernel"] = w[:, i].reshape(-1, cin)
            else:  # bias (3C,)
                b = t.reshape(h, 3, -1)
                for i, nm in enumerate(("to_q", "to_k", "to_v")):
                    out[f"{block}.{nm}.bias"] = b[:, i].reshape(-1)
            continue
        if blk in qkv_blocks:
            n = n.replace(".norm.", ".group_norm.").replace(".proj_out.", ".to_out.")
            if n.endswith("weight") and t.ndim == 3:
                t = t[..., 0]  # the conv1d proj_out as a linear
        if n.startswith("input_blocks.0.0."):
            n = n.replace("input_blocks.0.0.", "input_blocks.0.conv.")
        for old, new in _LDM_RENAMES:
            n = n.replace(old, new)
        parts = n.split(".")
        stem = parts[:-1]
        out[".".join(stem + [_leaf(stem, parts[-1], t, ("label_emb", "embedding"))])] = t
    return _done(out)


# -- ermongroup DDIM and CompVis first-stage (pytorch_diffusion naming) --------

def _pytorch_diffusion_rename(n: str, num_levels: int) -> str:
    """The pytorch_diffusion names the DDIM UNet and the CompVis encoder and
    decoder share -> the port's: mid.block_1/attn_1/block_2 ->
    mid_block.resnets/attentions, down.{i}/up.{i} -> down_blocks/up_blocks
    (up levels reversed: that codebase indexes them by resolution, the port by
    application order), block -> resnets, attn -> attentions, the samplers,
    nin_shortcut -> conv_shortcut, norm_out -> conv_norm_out."""
    n = n.replace("norm_out.", "conv_norm_out.")
    n = n.replace("mid.block_1.", "mid_block.resnets.0.")
    n = n.replace("mid.block_2.", "mid_block.resnets.1.")
    n = n.replace("mid.attn_1.", "mid_block.attentions.0.")
    if n.startswith("down."):
        n = "down_blocks." + n[len("down."):]
    if n.startswith("up."):
        segs = n.split(".")
        segs[0] = "up_blocks"
        segs[1] = str(num_levels - 1 - int(segs[1]))
        n = ".".join(segs)
    n = n.replace(".block.", ".resnets.")
    n = n.replace(".attn.", ".attentions.")
    n = n.replace(".downsample.conv.", ".downsamplers.0.conv.")
    n = n.replace(".upsample.conv.", ".upsamplers.0.conv.")
    return n.replace(".nin_shortcut.", ".conv_shortcut.")


def _attn_rename(n: str) -> str:
    """A pytorch_diffusion AttnBlock's names -> SelfAttention2D's."""
    for old, new in ((".norm.", ".group_norm."), (".q.", ".to_q."), (".k.", ".to_k."),
                     (".v.", ".to_v."), (".proj_out.", ".to_out.")):
        n = n.replace(old, new)
    return n


def _pytorch_diffusion_leaf(n: str, t: torch.Tensor, is_attn: bool):
    """(key, tensor) of one renamed leaf; an attention 1x1 conv (O, I, 1, 1)
    becomes a linear kernel (O, I)."""
    parts = n.split(".")
    stem = parts[:-1]
    if is_attn and t.ndim == 4:
        return ".".join(stem + ["kernel"]), t[:, :, 0, 0]
    return ".".join(stem + [_leaf(stem, parts[-1], t)]), t


def ddim_original_state_dict_to_params(sd: Mapping[str, object],
                                       num_levels: int) -> Dict[str, torch.Tensor]:
    """An ermongroup DDIM ``Model`` state dict (its ema checkpoints) -> the
    port's UNet2D state dict: temb.dense.{0,1} -> time_embedding.linear_{1,2},
    temb_proj -> time_emb_proj, the attention q/k/v/proj_out 1x1 convs as
    linears, and :func:`_pytorch_diffusion_rename`."""
    out = {}
    for name, v in sd.items():
        t = _t(v)
        parts = name.split(".")
        is_attn = (len(parts) > 2 and parts[2] == "attn") or (parts[0] == "mid"
                                                               and parts[1] == "attn_1")
        n = name.replace("temb.dense.0.", "time_embedding.linear_1.")
        n = n.replace("temb.dense.1.", "time_embedding.linear_2.")
        n = _pytorch_diffusion_rename(n, num_levels).replace(".temb_proj.", ".time_emb_proj.")
        if is_attn:
            n = _attn_rename(n)
        key, t = _pytorch_diffusion_leaf(n, t, is_attn)
        out[key] = t
    return _done(out)


def bert_embedder_state_dict_to_params(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """The vendored x-transformers ``TransformerWrapper`` state dict (the
    BERTEmbedder of txt2img-1p4B) -> the port's BERTEmbedder state dict.
    Layer list: ``attn_layers.layers.{2i}`` = (LayerNorm, Attention, Residual),
    ``.{2i+1}`` = (LayerNorm, FeedForward, Residual), the FeedForward's
    Sequential net.0.0 (Linear) / net.0.1 (GELU) / net.2 (Linear)."""
    out = {"token_emb.embedding": _t(sd["token_emb.weight"]),
           "pos_emb.embedding": _t(sd["pos_emb.emb.weight"]),
           "norm.scale": _t(sd["norm.weight"]), "norm.bias": _t(sd["norm.bias"]),
           "to_logits.kernel": _t(sd["to_logits.weight"]),
           "to_logits.bias": _t(sd["to_logits.bias"])}
    n_layer = (1 + max(int(k.split(".")[2]) for k in sd
                       if k.startswith("attn_layers.layers."))) // 2
    for i in range(n_layer):
        a, f, pre = f"attn_layers.layers.{2 * i}", f"attn_layers.layers.{2 * i + 1}", f"layers.{i}"
        for ours, theirs in (("attn_norm.scale", f"{a}.0.weight"), ("attn_norm.bias", f"{a}.0.bias"),
                             ("attn.to_q.kernel", f"{a}.1.to_q.weight"),
                             ("attn.to_k.kernel", f"{a}.1.to_k.weight"),
                             ("attn.to_v.kernel", f"{a}.1.to_v.weight"),
                             ("attn.to_out.kernel", f"{a}.1.to_out.weight"),
                             ("attn.to_out.bias", f"{a}.1.to_out.bias"),
                             ("ff_norm.scale", f"{f}.0.weight"), ("ff_norm.bias", f"{f}.0.bias"),
                             ("ff.fc1.kernel", f"{f}.1.net.0.0.weight"),
                             ("ff.fc1.bias", f"{f}.1.net.0.0.bias"),
                             ("ff.fc2.kernel", f"{f}.1.net.2.weight"),
                             ("ff.fc2.bias", f"{f}.1.net.2.bias")):
            out[f"{pre}.{ours}"] = _t(sd[theirs])
    return _done(out)


def infer_compvis_vae_config(sd: Mapping[str, object], resolution: int = 256):
    """The port's ``AutoencoderConfig`` of a CompVis first-stage state dict
    (VQModel / AutoencoderKL over ldm's Encoder/Decoder). Every ddconfig field
    follows from the shapes and keys except the training resolution (256 for
    every zoo model), which fixes ``attn_resolutions``."""
    from ..models.vae import AutoencoderConfig

    def shape(k):
        return tuple(sd[k].shape)

    blocks = []
    while f"encoder.down.{len(blocks)}.block.0.conv1.weight" in sd:
        blocks.append(shape(f"encoder.down.{len(blocks)}.block.0.conv1.weight")[0])
    num_levels = len(blocks)
    j = 0
    while f"encoder.down.0.block.{j}.conv1.weight" in sd:
        j += 1
    z_channels = shape("decoder.conv_in.weight")[1]
    attn_res = tuple(sorted({resolution // (2 ** k) for k in range(num_levels)
                             if f"encoder.down.{k}.attn.0.norm.weight" in sd}, reverse=True))
    vq = "quantize.embedding.weight" in sd
    if vq:
        n_embed, embed_dim = shape("quantize.embedding.weight")
    else:
        embed_dim, n_embed = shape("post_quant_conv.weight")[1], None
    if embed_dim != z_channels:
        raise ValueError(f"embed_dim {embed_dim} != z_channels {z_channels}: every zoo model "
                         "has them equal, and the port's first stage assumes it")
    return AutoencoderConfig(
        in_channels=shape("encoder.conv_in.weight")[1],
        out_channels=shape("decoder.conv_out.weight")[0],
        block_out_channels=tuple(blocks), layers_per_block=j,
        latent_channels=z_channels, sample_size=resolution,
        num_vq_embeddings=n_embed, vq_embed_dim=embed_dim if vq else None,
        attn_resolutions=attn_res,
        mid_block_attention="encoder.mid.attn_1.norm.weight" in sd)


def compvis_vae_state_dict_to_params(sd: Mapping[str, object],
                                     num_levels: int) -> Dict[str, torch.Tensor]:
    """A CompVis first-stage state dict (Encoder/Decoder + quantize and the
    quant convs) -> the port's VQModel/AutoencoderKL state dict, with the DDIM
    plan (:func:`_pytorch_diffusion_rename`) under the ``encoder.``/``decoder.``
    prefixes. ``loss.*`` (LPIPS and the discriminator, converted on their
    own) and any other key are dropped."""
    out = {}
    for name, v in sd.items():
        prefix = name.split(".")[0]
        t = _t(v)
        if prefix in ("encoder", "decoder"):
            rest = name.split(".")[1:]
            is_attn = (len(rest) > 2 and rest[2] == "attn") or (rest[0] == "mid"
                                                                 and rest[1] == "attn_1")
            n = _pytorch_diffusion_rename(".".join(rest), num_levels)
            if is_attn:
                n = _attn_rename(n)
            key, t = _pytorch_diffusion_leaf(n, t, is_attn)
            out[f"{prefix}.{key}"] = t
        elif name.startswith("quantize.embedding."):
            out[name] = t  # the (n_embed, dim) codebook keeps its layout
        elif prefix in ("quant_conv", "post_quant_conv", "quantize"):
            parts = name.split(".")
            out[".".join(parts[:-1] + [_leaf(parts[:-1], parts[-1], t)])] = t
    return _done(out)


def torch_discriminator_state_dict_to_params(sd: Mapping[str, object],
                                             n_layers: int = 3) -> Dict[str, torch.Tensor]:
    """A taming ``NLayerDiscriminator`` state dict (``loss.discriminator.*`` of
    a first-stage checkpoint, the prefix stripped) -> the port's
    NLayerDiscriminator state dict. The torch Sequential is conv (0), leaky
    (1), then per block [conv, norm, leaky], then the last conv; the norm is
    BatchNorm (weight/bias) or ActNorm (loc/scale shaped (1, C, 1, 1))."""
    conv_idx, norm_idx, pos = {0: 0}, {}, 2
    for b in range(1, n_layers + 1):
        conv_idx[b], norm_idx[b] = pos, pos + 1
        pos += 3
    conv_idx["out"] = pos
    out = {}
    for b, ci in conv_idx.items():
        out[f"main.{b}.conv.kernel"] = _t(sd[f"main.{ci}.weight"])
        if f"main.{ci}.bias" in sd:
            out[f"main.{b}.conv.bias"] = _t(sd[f"main.{ci}.bias"])
    for b, ni in norm_idx.items():
        if f"main.{ni}.weight" in sd:  # BatchNorm
            out[f"main.{b}.norm.scale"] = _t(sd[f"main.{ni}.weight"])
            out[f"main.{b}.norm.bias"] = _t(sd[f"main.{ni}.bias"])
        else:  # ActNorm
            out[f"main.{b}.norm.scale"] = _t(sd[f"main.{ni}.scale"]).reshape(-1)
            out[f"main.{b}.norm.loc"] = _t(sd[f"main.{ni}.loc"]).reshape(-1)
    return _done(out)
