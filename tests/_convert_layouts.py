"""Source-layout state dicts for the converter tests: a seeded JAX-layout flat
dict (HWIO conv kernels, (din, dout) linear kernels, ``scale`` norms) renamed
and reshaped into the layout of the codebase a converter reads (the DDIM
codebase, CompVis's openaimodel and first stage, x-transformers, taming), so
that both packages' converters can be held to give back exactly that flat
dict. numpy only."""

import re

import numpy as np


def _torch_leaf(path, arr):
    """(stem, torch leaf name, array in the torch layout) of one flat entry."""
    *stem, leaf = path.split("/")
    if leaf == "kernel":
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return stem, leaf, np.ascontiguousarray(arr)


def _pytorch_diffusion_name(n, num_levels):
    """The port's names -> the pytorch_diffusion ones (DDIM UNet, CompVis codec)."""
    n = n.replace("conv_norm_out.", "norm_out.")
    n = n.replace("mid_block.resnets.0.", "mid.block_1.")
    n = n.replace("mid_block.resnets.1.", "mid.block_2.")
    n = n.replace("mid_block.attentions.0.", "mid.attn_1.")
    if n.startswith("down_blocks."):
        n = "down." + n[len("down_blocks."):]
    if n.startswith("up_blocks."):
        segs = n.split(".")
        segs[0], segs[1] = "up", str(num_levels - 1 - int(segs[1]))
        n = ".".join(segs)
    n = n.replace(".resnets.", ".block.").replace(".attentions.", ".attn.")
    n = n.replace(".downsamplers.0.conv.", ".downsample.conv.")
    n = n.replace(".upsamplers.0.conv.", ".upsample.conv.")
    n = n.replace(".conv_shortcut.", ".nin_shortcut.")
    if ".attn." in n or ".attn_1." in n:
        n = n.replace(".group_norm.", ".norm.").replace(".to_q.", ".q.")
        n = n.replace(".to_k.", ".k.").replace(".to_v.", ".v.").replace(".to_out.", ".proj_out.")
    return n


def ddim_state_dict(flat, num_levels):
    """An ermongroup DDIM ``Model`` state dict (attention q/k/v/proj_out as 1x1 convs)."""
    sd = {}
    for path, arr in flat.items():
        stem, leaf, a = _torch_leaf(path, arr)
        n = ".".join(stem + [leaf])
        n = n.replace("time_embedding.linear_1.", "temb.dense.0.")
        n = n.replace("time_embedding.linear_2.", "temb.dense.1.")
        n = _pytorch_diffusion_name(n, num_levels).replace(".time_emb_proj.", ".temb_proj.")
        if (".attn." in n or ".attn_1." in n) and leaf == "weight" and a.ndim == 2:
            a = a[:, :, None, None]
        sd[n] = a
    return sd


def compvis_vae_state_dict(flat, num_levels):
    """A CompVis first-stage state dict (plus a ``loss.*`` key the converters drop)."""
    sd = {"loss.logvar": np.zeros((), np.float32)}
    for path, arr in flat.items():
        stem, leaf, a = _torch_leaf(path, arr)
        if path == "quantize/embedding/weight":
            sd["quantize.embedding.weight"] = a
            continue
        prefix, rest = stem[0], ".".join(stem[1:] + [leaf])
        if prefix in ("encoder", "decoder"):
            n = _pytorch_diffusion_name(rest, num_levels)
            if (".attn." in n or n.startswith("mid.attn_1.")) and leaf == "weight" and a.ndim == 2:
                a = a[:, :, None, None]
            sd[f"{prefix}.{n}"] = a
        else:
            sd[".".join(stem + [leaf])] = a
    return sd


_LDM_NAMES = [("in_norm.", "in_layers.0."), ("in_conv.", "in_layers.2."),
              ("emb_proj.", "emb_layers.1."), ("out_norm.", "out_layers.0."),
              ("out_conv.", "out_layers.3."), ("ff.proj.", "ff.net.0.proj."),
              ("ff.out.", "ff.net.2."), ("to_out.", "to_out.0.")]


def ldm_unet_state_dict(flat, attn_heads):
    """A CompVis ``openaimodel.UNetModel`` state dict; the AttentionBlocks
    (blocks of ``attn_heads`` without a transformer) get the fused,
    head-interleaved qkv conv1d and conv1d proj_out."""
    legacy = {b.replace("/", ".") for b in attn_heads
              if f"{b}/to_q/kernel" in flat}
    sd = {}
    for block in legacy:
        h = attn_heads[block.replace(".", "/")]
        q, k, v = (flat[f"{block.replace('.', '/')}/{nm}/kernel"].T for nm in ("to_q", "to_k", "to_v"))
        cin = q.shape[1]
        w = np.stack([x.reshape(h, -1, cin) for x in (q, k, v)], axis=1)  # (h, 3, ch, cin)
        sd[f"{block}.qkv.weight"] = np.ascontiguousarray(w.reshape(-1, cin)[..., None])
        b = np.stack([flat[f"{block.replace('.', '/')}/{nm}/bias"].reshape(h, -1)
                      for nm in ("to_q", "to_k", "to_v")], axis=1)
        sd[f"{block}.qkv.bias"] = np.ascontiguousarray(b.reshape(-1))
    for path, arr in flat.items():
        stem, leaf, a = _torch_leaf(path, arr)
        block = ".".join(stem[:-1])
        if block in legacy and stem[-1] in ("to_q", "to_k", "to_v"):
            continue
        n = ".".join(stem + [leaf])
        if block in legacy:
            n = n.replace(".group_norm.", ".norm.").replace(".to_out.", ".proj_out.")
            if leaf == "weight" and a.ndim == 2:
                a = a[..., None]
            sd[n] = a
            continue
        n = n.replace("input_blocks.0.conv.", "input_blocks.0.0.")
        for ours, theirs in _LDM_NAMES:
            n = n.replace(ours, theirs)
        sd[n] = a
    return sd


def bert_state_dict(flat):
    """The x-transformers ``TransformerWrapper`` state dict of a BERTEmbedder."""
    sd = {"token_emb.weight": flat["token_emb/embedding"],
          "pos_emb.emb.weight": flat["pos_emb/embedding"],
          "norm.weight": flat["norm/scale"], "norm.bias": flat["norm/bias"],
          "to_logits.weight": flat["to_logits/kernel"].T, "to_logits.bias": flat["to_logits/bias"]}
    layers = sorted({int(m.group(1)) for k in flat for m in [re.match(r"layers/(\d+)/", k)] if m})
    for i in layers:
        a, f, p = f"attn_layers.layers.{2 * i}", f"attn_layers.layers.{2 * i + 1}", f"layers/{i}"
        sd.update({f"{a}.0.weight": flat[f"{p}/attn_norm/scale"],
                   f"{a}.0.bias": flat[f"{p}/attn_norm/bias"],
                   f"{a}.1.to_out.bias": flat[f"{p}/attn/to_out/bias"],
                   f"{f}.0.weight": flat[f"{p}/ff_norm/scale"],
                   f"{f}.0.bias": flat[f"{p}/ff_norm/bias"],
                   f"{f}.1.net.0.0.weight": flat[f"{p}/ff/fc1/kernel"].T,
                   f"{f}.1.net.0.0.bias": flat[f"{p}/ff/fc1/bias"],
                   f"{f}.1.net.2.weight": flat[f"{p}/ff/fc2/kernel"].T,
                   f"{f}.1.net.2.bias": flat[f"{p}/ff/fc2/bias"]})
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            sd[f"{a}.1.{proj}.weight"] = flat[f"{p}/attn/{proj}/kernel"].T
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def discriminator_state_dict(flat, n_layers):
    """A taming ``NLayerDiscriminator`` state dict (BatchNorm or ActNorm)."""
    idx, pos = {"0": 0}, 2
    for b in range(1, n_layers + 1):
        idx[str(b)], pos = pos, pos + 3
    idx["out"] = pos
    sd = {}
    for path, arr in flat.items():
        _, b, part, leaf = path.split("/")
        if part == "conv":
            sd[f"main.{idx[b]}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                arr.transpose(3, 2, 0, 1) if leaf == "kernel" else arr)
        elif leaf == "loc" or f"main/{b}/norm/loc" in flat:  # ActNorm
            sd[f"main.{idx[b] + 1}.{leaf}"] = arr.reshape(1, -1, 1, 1)
        else:
            sd[f"main.{idx[b] + 1}.{'weight' if leaf == 'scale' else 'bias'}"] = arr
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def assert_flat_equal(got, want, what):
    """Exact equality of two flat dicts of arrays (keys, dtypes, values)."""
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want))[:6])
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype, g.shape,
                                                           w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")
