"""The port's class-conditional LDM serving slice against the JAX package, on
the CPU: UNetCond (with its transformer layers), the VQ and KL first
stages, the LatentDiffusion wrapper, the CFG samplers (DDIM, PLMS,
DPM-Solver++), the LDM model dir and the ``ldm_sample`` CLI.

Parameters and inputs are made with numpy from a seed and handed to both
packages through the flat ``a/b/kernel`` layout (every leaf random, so the
zero-initialised ones of a fresh model carry signal); JAX runs with f32
matmuls, the port with TF32 off. Tolerances:

- single forwards (UNetCond, encode, decode), f32: atol = rtol = 5e-5, the
  port's UNet tolerance (tests/test_torch_unet.py): the two packages sum in
  other orders through tens of layers;
- CFG trajectories (4 steps, scale 3, then the decode): the relative error
  in norm <= 1e-5 (0.5-1.3e-6 measured on the CPU). Guidance multiplies the
  cond-uncond difference by 3 at every step and the steps feed each other,
  so the order-of-summation differences of one forward can grow;
- everything structural (graphs, parameter counts, timesteps, checkpoint
  arrays, VQ indices, file names): exactly equal.
"""

import dataclasses
import itertools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diff_pruning_tpu.models import latent_diffusion as jl
from diff_pruning_tpu.models import unet_cond as ju
from diff_pruning_tpu.models import vae as jv
from diff_pruning_tpu.pruning.surgery import flatten_params, unflatten_params
from diff_pruning_tpu.utils import checkpoint as jckpt
from diff_pruning_tpu_torch import ops
from diff_pruning_tpu_torch.models import latent_diffusion as tl
from diff_pruning_tpu_torch.models import unet_cond as tu
from diff_pruning_tpu_torch.models import vae as tv
from diff_pruning_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)
ATOL = RTOL = 5e-5
TRAJ_RTOL = 1e-5
PRESETS = ["cin256_v2_config", "celebahq_ldm_vq4_config", "ffhq_ldm_vq4_config",
           "lsun_bedrooms_ldm_vq4_config", "lsun_churches_ldm_kl8_config",
           "cin_ldm_vq_f8_config", "txt2img_1p4B_config", "bsr_sr_config",
           "layout2img_openimages256_config", "semantic_synthesis256_config",
           "semantic_synthesis512_config", "text2img256_config", "rdm768_config",
           "inpainting_big_config", "tiny_cond_config"]


@pytest.fixture(autouse=True)
def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def numpy_params(jinit, seed):
    """Flat JAX-layout params with torch-like init scales and non-trivial norms."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, s in flatten_params(jax.eval_shape(jinit, jax.random.key(0))).items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            bound = np.sqrt(3.0 / np.prod(s.shape[:-1]))
            a = rng.uniform(-bound, bound, s.shape)
        elif leaf == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        flat[path] = a.astype(np.float32)
    return flat


def _jax_tree(flat):
    return unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def _graph_signature(g):
    vars_ = [(v.name, v.size, v.prunable, v.group_div, v.round_to) for v in g.vars.values()]
    refs = [(r.param, r.axis, tuple((v.name, off) for v, off in r.parts), r.role)
            for r in g.refs]
    return vars_, refs


def _tiny_vae_config(kind):
    """Two levels (f2), attention at the 8x8 level and in the mid block."""
    return jv.AutoencoderConfig(
        block_out_channels=(32, 64), layers_per_block=1, latent_channels=3,
        norm_num_groups=8, sample_size=16, attn_resolutions=(8,),
        num_vq_embeddings=16 if kind == "vq" else None, vq_embed_dim=3 if kind == "vq" else None)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=what)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _unet_forward_both(jcfg, flat, x, t, ctx):
    jm = ju.UNetCond(jcfg)
    with jax.default_matmul_precision("float32"):
        want = jm(_jax_tree(flat), jnp.asarray(x), jnp.asarray(t),
                  context=None if ctx is None else jnp.asarray(ctx))
    tm = tu.UNetCond(tu.UNetCondConfig.from_json(jcfg.to_json()), device="cpu")
    tm.load_state_dict(tckpt.state_dict_from_flat(flat))
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(t),
                        context=None if ctx is None else torch.from_numpy(ctx))
    return tm, np.asarray(want), got.numpy()


# strings for both tokenizers: accents, CJK, control and separator
# characters, punctuation runs, numbers outside \d ('²', '½'), a special token
# inside text, contractions (also with 'ſ', which IGNORECASE folds to 's'),
# U+0345 (in no class of the CLIP pattern), HTML entities, and a text past
# the context length
TOKENIZER_TEXTS = [
    "a painting of a virus monster playing guitar", "", "Héllo, Wörld!!  naïve café",
    "東京 タワー 和 北京", "x²+y½ = z³ ⅷ", "don't it's WE'LL they've i'm I'd 'ſ 'S",
    "punct...!!?? (a) [b] {c} -- __ ##", "tab\tnew\nline\x1c\x1d sep\u2003em\u3000cjk",
    "<|startoftext|> the <|endoftext|> hell <|ſtartoftext|>", "\u0345a\u0345 b\u0345",
    "&amp;lt;b&amp;gt; and &quot;quoted&quot;", "the hell and " * 40, "ﬁ ǅ Ⅻ ⓐ 𝔘𝔫𝔦",
    "\x00ctrl\ufeffzero\u200bwidth", "ελληνικά и кириллица", "   padded   ",
]


def _write_tokenizer_files(d):
    """A WordPiece vocab (word pieces, '##' continuations, non-ASCII and CJK
    entries) and a BPE merges file (plain and .gz; merges over UTF-8 byte
    symbols too) for both packages' tokenizers."""
    import gzip

    from diff_pruning_tpu_torch.data.clip_tokenizer import bytes_to_unicode

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "painting", "of", "virus",
             "monster", "play", "##ing", "guitar", "hello", "world", "na", "##ive", "cafe",
             "東", "京", "北", "!", ",", ".", "x", "##²", "the", "hell", "and", "don", "'",
             "t", "it", "s", "δ", "ε", "##λ", "и", "(", ")", "-", "#", "<", ">", "|", "z",
             "##s", "##o", "##r", "lt", "gt", "quot", "&", ";", "tab", "new", "line", "em"]
    vf = os.path.join(d, "vocab.txt")
    with open(vf, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    byte = bytes_to_unicode()
    e_acute = "".join(byte[b] for b in "é".encode("utf-8"))
    merges = [("h", "e</w>"), ("l", "l"), ("t", "h"), ("th", "e</w>"), ("a", "n"),
              ("an", "d</w>"), ("h", "e"), ("he", "ll</w>"), ("p", "a"), ("i", "n"),
              ("in", "g</w>"), (e_acute[0], e_acute[1]), ("c", "a"), ("ca", "f"),
              ("'", "s</w>"), ("1", "2")]
    mf = os.path.join(d, "merges.txt")
    text = "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n"
    with open(mf, "w", encoding="utf-8") as f:
        f.write(text)
    with gzip.open(mf + ".gz", "wt", encoding="utf-8") as f:
        f.write(text)
    return vf, mf


def _check_text_and_clip_models(tmp_path, tiny, rng):
    """Both tokenizers (exact ids), the BERTEmbedder and CLIP (graphs, full
    parameter counts on the meta device, tiny forwards within ATOL/RTOL:
    tens of layers summed in other orders), the OpenAI CLIP converter
    (exact), and a tiny LatentDiffusion with a BERT cond stage."""
    from diff_pruning_tpu.data import clip_tokenizer as jct
    from diff_pruning_tpu.data import tokenizer as jtok
    from diff_pruning_tpu.models import clip as jclip
    from diff_pruning_tpu.models import text_encoder as jte
    from diff_pruning_tpu_torch.data import clip_tokenizer as tct
    from diff_pruning_tpu_torch.data import tokenizer as ttok
    from diff_pruning_tpu_torch.models import clip as tclip
    from diff_pruning_tpu_torch.models import text_encoder as tte

    vf, mf = _write_tokenizer_files(str(tmp_path))
    jb, tb = jtok.BERTTokenizer(vf, max_length=20), ttok.BERTTokenizer(vf, max_length=20)
    np.testing.assert_array_equal(tb(TOKENIZER_TEXTS), jb(TOKENIZER_TEXTS))
    for s in TOKENIZER_TEXTS:
        assert tb.tokenize_ids(s) == jb.tokenize_ids(s), s
    jc = jct.CLIPTokenizer(mf)
    for path in (mf, mf + ".gz"):
        tc = tct.CLIPTokenizer(path)
        assert tc.vocab_size == jc.vocab_size == 512 + 16 + 2
        np.testing.assert_array_equal(tc.tokenize(TOKENIZER_TEXTS, context_length=24),
                                      jc.tokenize(TOKENIZER_TEXTS, context_length=24))
    for s in TOKENIZER_TEXTS:  # the pattern alone, and through the whole encode
        assert tct.pre_tokenize(s) == jct.re.findall(jct.CLIPTokenizer.PAT, s), s
        assert tc.encode(s) == jc.encode(s), s
        assert tc.decode(tc.encode(s)) == jc.decode(jc.encode(s)), s
    with pytest.raises(RuntimeError, match="too long"):
        tc.tokenize(TOKENIZER_TEXTS[-5], context_length=8, truncate=False)

    # BERTEmbedder and CLIP: configs, graphs and parameter counts (the
    # full-width ones on the meta device against jax.eval_shape), state keys
    for jmod, tmod, cfgs, full in (
            (jte, tte, ("bert_txt2img_config", "tiny_bert_config"), 581_994_042),
            (jclip, tclip, ("clip_vit_l14_config", "tiny_clip_config"), 427_616_513)):
        for i, name in enumerate(cfgs):
            jcfg, tcfg = getattr(jmod, name)(), getattr(tmod, name)()
            assert tcfg.to_json() == jcfg.to_json() and type(tcfg).from_json(
                tcfg.to_json()) == tcfg, name
            jm = (jte.BERTEmbedder if jmod is jte else jclip.CLIP)(jcfg)
            tm = (tte.BERTEmbedder if jmod is jte else tclip.CLIP)(tcfg, device="meta")
            assert _graph_signature(tm.graph) == _graph_signature(jm.graph), name
            shapes = jax.eval_shape(jm.init, jax.random.key(0))
            n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
            assert sum(p.numel() for p in tm.parameters()) == n == (full if i == 0 else n)
            assert {k.replace(".", "/") for k in tm.state_dict()} == set(flatten_params(shapes))

    # tiny forwards on the same weights
    jm, tm = jte.BERTEmbedder(jte.tiny_bert_config()), tte.BERTEmbedder(
        tte.tiny_bert_config(), device="cpu")
    bflat = numpy_params(jm.init, 21)
    tm.load_state_dict(tckpt.state_dict_from_flat(bflat))
    ids = rng.integers(0, 40, (3, 11))
    with jax.default_matmul_precision("float32"), torch.no_grad():
        for emb in (True, False):
            _close(tm(torch.from_numpy(ids), return_embeddings=emb).numpy(),
                   jm(_jax_tree(bflat), jnp.asarray(ids), return_embeddings=emb), "bert")
    assert tm.init(torch.Generator().manual_seed(0)) is tm
    assert float(tm.token_emb.embedding.detach().std()) == pytest.approx(0.02, rel=0.2)
    jm, tm = jclip.CLIP(jclip.tiny_clip_config()), tclip.CLIP(tclip.tiny_clip_config(),
                                                              device="cpu")
    cflat = numpy_params(jm.init, 22)
    tm.load_state_dict(tckpt.state_dict_from_flat(cflat))
    ids = rng.integers(0, 49, (3, 10))
    ids[np.arange(3), [9, 4, 6]] = 49  # the end-of-text token, the largest id
    img16 = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    img_big = rng.uniform(-1, 1, (2, 37, 29, 3)).astype(np.float32)  # resized (shrinks)
    img_small = rng.uniform(-1, 1, (1, 9, 16, 3)).astype(np.float32)  # grows one axis
    jp = _jax_tree(cflat)
    with jax.default_matmul_precision("float32"), torch.no_grad():
        _close(tclip.clip_text_embed(tm, torch.from_numpy(ids), n_repeat=2).numpy(),
               jclip.clip_text_embed(jm, jp, jnp.asarray(ids), n_repeat=2), "clip text")
        _close(tm.encode_text(torch.from_numpy(ids)).numpy(),
               jm.encode_text(jp, jnp.asarray(ids)), "clip encode_text")
        _close(tm.encode_image(torch.from_numpy(img16)).numpy(),
               jm.encode_image(jp, jnp.asarray(img16)), "clip encode_image")
        for im in (img16, img_big, img_small):
            _close(tclip.clip_preprocess_images(torch.from_numpy(im), 16).numpy(),
                   jclip.clip_preprocess_images(jnp.asarray(im), 16), f"preprocess {im.shape}")
            _close(tclip.clip_image_embed(tm, torch.from_numpy(im)).numpy(),
                   jclip.clip_image_embed(jm, jp, jnp.asarray(im)), f"image embed {im.shape}")
    tm.init(torch.Generator().manual_seed(0))
    assert float(tm.logit_scale.detach()) == pytest.approx(np.log(1 / 0.07))
    # the OpenAI state-dict converter: both towers, and the text tower alone
    tc_ = tclip.tiny_clip_config()
    w, vw = tc_.text_width, tc_.vision_width
    sd = {"token_embedding.weight": (tc_.vocab_size, w), "positional_embedding": (10, w),
          "ln_final.weight": (w,), "ln_final.bias": (w,), "text_projection": (w, 12),
          "logit_scale": (), "visual.conv1.weight": (vw, 3, 8, 8),
          "visual.class_embedding": (vw,), "visual.positional_embedding": (5, vw),
          "visual.ln_pre.weight": (vw,), "visual.ln_pre.bias": (vw,),
          "visual.ln_post.weight": (vw,), "visual.ln_post.bias": (vw,), "visual.proj": (vw, 12)}
    for pre, width in (("transformer.resblocks", w), ("visual.transformer.resblocks", vw)):
        for i in range(2):
            p = f"{pre}.{i}"
            sd.update({f"{p}.attn.in_proj_weight": (3 * width, width),
                       f"{p}.attn.in_proj_bias": (3 * width,),
                       f"{p}.attn.out_proj.weight": (width, width),
                       f"{p}.attn.out_proj.bias": (width,),
                       f"{p}.mlp.c_fc.weight": (4 * width, width),
                       f"{p}.mlp.c_fc.bias": (4 * width,),
                       f"{p}.mlp.c_proj.weight": (width, 4 * width),
                       f"{p}.mlp.c_proj.bias": (width,)})
            sd.update({f"{p}.{ln}.{k}": (width,) for ln in ("ln_1", "ln_2")
                       for k in ("weight", "bias")})
    sd = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in sd.items()}
    for part in (sd, {k: v for k, v in sd.items() if not k.startswith("visual.")}):
        got = tckpt.flat_from_state_dict(tclip.openai_clip_state_dict_to_params(part))
        want = flatten_params(jclip.openai_clip_state_dict_to_params(part))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    tm.load_state_dict(tclip.openai_clip_state_dict_to_params(sd))

    # a tiny LatentDiffusion with the BERT cond stage: the cond stage and the
    # learned conditioning, then the full-width text and retrieval models'
    # pinned parameter counts (UNet, BERT, first stages; meta device)
    ucfg = dataclasses.replace(tiny, context_dim=16)
    jldm = jl.LatentDiffusion(ucfg, cond_stage=jte.BERTEmbedder(jte.tiny_bert_config()))
    tldm = tl.LatentDiffusion(tu.UNetCondConfig.from_json(ucfg.to_json()), device="cpu",
                              cond_stage=tte.BERTEmbedder(tte.tiny_bert_config(), device="cpu"))
    flat = numpy_params(jldm.init, 23)
    assert set(tckpt.flat_from_state_dict(tldm.state_dict())) == set(flat)
    tldm.init(torch.Generator().manual_seed(0))
    tldm.load_state_dict(tckpt.state_dict_from_flat(flat))
    ids = rng.integers(0, 40, (2, 11))
    with jax.default_matmul_precision("float32"), torch.no_grad():
        _close(tldm.get_learned_conditioning(torch.from_numpy(ids)).numpy(),
               jldm.get_learned_conditioning(_jax_tree(flat), jnp.asarray(ids)), "ldm bert")
    meta = torch.device("meta")
    for ucfg_, fs_name, want in ((tu.txt2img_1p4B_config(), "kl-f8", (872_300_484, 83_653_863)),
                                 (tu.rdm768_config(), "kl-f16", (1_335_480_400, 69_610_963)),
                                 (tu.inpainting_big_config(), "vq-f4-noattn",
                                  (387_245_827, 53_219_486))):
        got = (sum(p.numel() for p in tu.UNetCond(ucfg_, device=meta).parameters()),
               sum(p.numel() for p in tv.make_first_stage(tv.first_stage_config(fs_name),
                                                          device=meta).parameters()))
        assert got == want, (fs_name, got)
    t2i = tl.LatentDiffusion(tu.txt2img_1p4B_config(), device=meta,
                             first_stage=tv.make_first_stage(tv.first_stage_config("kl-f8"),
                                                             device=meta),
                             cond_stage=tte.BERTEmbedder(tte.bert_txt2img_config(), device=meta))
    assert sum(p.numel() for p in t2i.parameters()) == 1_537_948_389


def test_ldm_models_match_jax(tmp_path):
    """Graphs and parameter counts (every preset; cin256-v2 and vq-f4 at
    full width on the meta device against jax.eval_shape), tiny UNetCond
    forwards (spatial transformer with class-token cross-attention; the
    AttentionBlock, scale-shift and resblock up/down variants), VQ and KL
    encode/quantize/decode, and checkpoints across the packages both ways,
    including one pruned by the JAX package. The converters of the CompVis
    UNet (spatial transformer and fused-qkv AttentionBlocks), first stage
    (and its config), x-transformers BERT and taming discriminator
    (BatchNorm, ActNorm) give exactly the JAX ones' arrays, and so do the
    convert_checkpoints CLI's first-stage, lpips and inception kinds."""
    rng = np.random.default_rng(0)
    for name in PRESETS:
        jcfg = getattr(ju, name)()
        tcfg = getattr(tu, name)()
        assert tcfg.to_json() == jcfg.to_json(), name
        assert tu.UNetCondConfig.from_json(tcfg.to_json()) == tcfg, name
        tm = tu.UNetCond(tcfg, device="meta")
        jm = ju.UNetCond(jcfg)
        assert _graph_signature(tm.graph) == _graph_signature(jm.graph), name
        assert tm.attn_heads == jm.attn_heads, name
    # full width: cin256-v2 + vq-f4 + ClassEmbedder(1001), counted without
    # materialising 456M parameters
    for jmodel, tmodel, want in (
            (ju.UNetCond(ju.cin256_v2_config()), tu.UNetCond(tu.cin256_v2_config(),
                                                            device="meta"), 400_920_579),
            (jv.make_first_stage(jv.first_stage_config("vq-f4")),
             tv.make_first_stage(tv.first_stage_config("vq-f4"), device="meta"), 55_322_782),
            (jl.ClassEmbedder(1001, 512), tl.ClassEmbedder(1001, 512, device="meta"), 512_512)):
        shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
        n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        assert sum(p.numel() for p in tmodel.parameters()) == n_jax == want
        assert {k.replace(".", "/") for k in tmodel.state_dict()} == set(flatten_params(shapes))
    for name, fs_cfg in tv.FIRST_STAGE_PRESETS.items():
        assert fs_cfg().to_json() == jv.first_stage_config(name).to_json(), name

    # UNetCond forwards: the tiny spatial-transformer model (2 heads, context
    # (B, 1, 16): cross-attention on one token) and the other block kinds
    tiny = ju.tiny_cond_config()
    variants = [tiny, dataclasses.replace(tiny, use_spatial_transformer=False, context_dim=None,
                                          use_scale_shift_norm=True, resblock_updown=True)]
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    ctx = rng.standard_normal((2, 1, 16)).astype(np.float32)
    for i, jcfg in enumerate(variants):
        flat = numpy_params(ju.UNetCond(jcfg).init, 1 + i)
        c = ctx if jcfg.context_dim else None
        tm, want, got = _unet_forward_both(jcfg, flat, x, t, c)
        assert got.shape == want.shape == (2, 8, 8, 3)
        _close(got, want, f"UNetCond variant {i}")
        # the kernel switches off route the layers to the same plain math on the CPU
        try:
            ops.set_kernels_enabled(False)
            with torch.inference_mode():
                off = tm(torch.from_numpy(x), torch.from_numpy(t),
                         context=None if c is None else torch.from_numpy(c)).numpy()
        finally:
            ops.set_kernels_enabled(True)
        np.testing.assert_array_equal(off, got)

    # first stages: encode, quantize (VQ) / moments and posterior mean (KL), decode
    img = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    for kind in ("vq", "kl"):
        vcfg = _tiny_vae_config(kind)
        jm = jv.make_first_stage(vcfg)
        tm = tv.make_first_stage(tv.AutoencoderConfig.from_json(vcfg.to_json()), device="cpu")
        assert _graph_signature(tm.graph) == _graph_signature(jm.graph), kind
        flat = numpy_params(jm.init, 5)
        tm.load_state_dict(tckpt.state_dict_from_flat(flat))
        jp = _jax_tree(flat)
        with jax.default_matmul_precision("float32"), torch.inference_mode():
            _close(tm.decode(torch.from_numpy(z)).numpy(), jm.decode(jp, jnp.asarray(z)),
                   f"{kind} decode")
            if kind == "vq":
                enc = tm.encode(torch.from_numpy(img))
                _close(enc.numpy(), jm.encode(jp, jnp.asarray(img)), "vq encode")
                zq, idx = tm.quantize_latents(enc)
                jzq, jidx = jm.quantize(jp, jnp.asarray(enc.numpy()))
                np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
                np.testing.assert_array_equal(zq.numpy(), np.asarray(jzq))
                _close(tm.decode(torch.from_numpy(z), force_not_quantize=False).numpy(),
                       jm.decode(jp, jnp.asarray(z), force_not_quantize=False), "vq decode q")
            else:
                _close(tm.encode_moments(torch.from_numpy(img)).numpy(),
                       jm.encode_moments(jp, jnp.asarray(img)), "kl moments")
                _close(tm.encode(torch.from_numpy(img)).numpy(),
                       jm.encode(jp, jnp.asarray(img)), "kl mean")
                draw = tm.encode(torch.from_numpy(img), generator=torch.Generator().manual_seed(0))
                assert draw.shape == (2, 8, 8, 3) and bool(torch.isfinite(draw).all())

    # the first-stage trainer's parts: Decoder.features (conv_out applied to
    # it is the decode), quantize_train (values, straight-through grad, loss)
    vcfg = _tiny_vae_config("vq")
    jm = jv.make_first_stage(vcfg)
    tm = tv.make_first_stage(tv.AutoencoderConfig.from_json(vcfg.to_json()), device="cpu")
    flat = numpy_params(jm.init, 5)
    tm.load_state_dict(tckpt.state_dict_from_flat(flat))
    jp = _jax_tree(flat)
    zz = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        jh = jm.decoder.features(jp["decoder"], jm.post_quant_conv(jp["post_quant_conv"],
                                                                    jnp.asarray(zz)))
        jzq, jloss, jidx = jm.quantize_train(jp, jnp.asarray(zz), beta=0.25)
        jgrad = jax.grad(lambda z: jnp.sum(jm.quantize_train(jp, z)[0] ** 2)
                         + jm.quantize_train(jp, z)[1])(jnp.asarray(zz))
    with torch.no_grad():
        th = tm.decoder.features(tm.post_quant_conv(torch.from_numpy(zz).permute(0, 3, 1, 2)))
        _close(th.permute(0, 2, 3, 1).numpy(), jh, "decoder features")
        np.testing.assert_array_equal(tm.decoder.conv_out(th).numpy(),
                                      tm.decoder(tm.post_quant_conv(
                                          torch.from_numpy(zz).permute(0, 3, 1, 2))).numpy())
    tz = torch.from_numpy(zz).requires_grad_()
    tzq, tloss, tidx = tm.quantize_train(tz, beta=0.25)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tzq.detach().numpy(), np.asarray(jzq), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6)
    tgrad, = torch.autograd.grad((tzq ** 2).sum() + tloss, tz)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)
    cb = tm.quantize.embedding.weight
    cgrad, = torch.autograd.grad(tm.quantize_train(tz.detach(), beta=0.25)[1], cb)
    with jax.default_matmul_precision("float32"):
        jcb = jax.grad(lambda w: jm.quantize_train(
            {**jp, "quantize": {"embedding": {"weight": w}}}, jnp.asarray(zz))[1])(
            jp["quantize"]["embedding"]["weight"])
    np.testing.assert_allclose(cgrad.numpy(), np.asarray(jcb), rtol=1e-5, atol=1e-8)

    # the PatchGAN discriminator: graph, init layout, forward (BatchNorm from
    # batch statistics; ActNorm), the undersized-input raise; ActNorm's init
    from diff_pruning_tpu.models import discriminator as jdisc
    from diff_pruning_tpu_torch.models import discriminator as tdisc

    img = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    for n_layers, actnorm in ((2, False), (2, True), (3, False), (3, True)):
        jd = jdisc.NLayerDiscriminator(ndf=8, n_layers=n_layers, use_actnorm=actnorm)
        td = tdisc.NLayerDiscriminator(ndf=8, n_layers=n_layers, use_actnorm=actnorm,
                                       device="cpu")
        assert _graph_signature(td.graph) == _graph_signature(jd.graph)
        assert td.widths == jd.widths and td.min_input_size == jd.min_input_size
        flat = numpy_params(jd.init, 13 + n_layers)
        assert set(tckpt.flat_from_state_dict(td.state_dict())) == set(flat)
        td.init(torch.Generator().manual_seed(0))
        assert float(td.main["1"]["conv"].kernel.detach().std()) == pytest.approx(0.02, rel=0.1)
        td.load_state_dict(tckpt.state_dict_from_flat(flat))
        jd.graph.validate(_jax_tree(flat))
        size = max(24, jd.min_input_size)
        with jax.default_matmul_precision("float32"), torch.no_grad():
            want = jd(_jax_tree(flat), jnp.asarray(img[:, :size, :size]))
            got = td(torch.from_numpy(img[:, :size, :size].copy()))
            assert got.shape == want.shape
            _close(got.numpy(), want, f"discriminator {n_layers} {actnorm}")
        with pytest.raises(ValueError, match="too small"):
            td(torch.zeros((1, td.min_input_size - 1, 40, 3)))
    xa = rng.standard_normal((4, 5, 5, 3)).astype(np.float32) * 3 + 1
    ja = jdisc.actnorm_initialize({}, jnp.asarray(xa))
    ta = tdisc.actnorm_initialize(torch.from_numpy(xa))
    for k in ("loc", "scale"):
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]), rtol=1e-5)
    np.testing.assert_allclose(tdisc.actnorm_apply(ta["scale"], ta["loc"], torch.from_numpy(xa))
                               .numpy(), np.asarray(jdisc.actnorm_apply(ja, jnp.asarray(xa))),
                               rtol=1e-5, atol=1e-6)

    # LPIPS: JAX's random init written as its .npz layout, read by the port;
    # the state-dict converter; the trainer's losses
    from diff_pruning_tpu.eval import lpips as jlpips
    from diff_pruning_tpu.training import autoencoder as jae
    from diff_pruning_tpu_torch.eval import lpips as tlpips
    from diff_pruning_tpu_torch.training import autoencoder as tae

    jlp = jlpips.init_lpips_params(jax.random.key(3))
    jckpt.save_params_npz(str(tmp_path / "lpips.npz"), jlp)
    tlp = tlpips.LPIPS(device="cpu")
    tlp.load_state_dict(tlpips.load_lpips_params(str(tmp_path / "lpips.npz")))
    assert not any(p.requires_grad for p in tlp.parameters())
    ia, ib = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    with jax.default_matmul_precision("float32"), torch.no_grad():
        want = jlpips.lpips(jlp, jnp.asarray(ia), jnp.asarray(ib))
        got = tlp(torch.from_numpy(ia), torch.from_numpy(ib))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        assert float(tlp(torch.from_numpy(ia), torch.from_numpy(ia)).abs().max()) == 0.0
    vgg = {f"features.{i}.weight": rng.standard_normal((co, ci, 3, 3)).astype(np.float32)
           for i, (ci, co) in zip(jlpips.VGG16_CONV_IDX, jlpips.VGG16_CONV_CH)}
    vgg.update({f"features.{i}.bias": rng.standard_normal(co).astype(np.float32)
                for i, (ci, co) in zip(jlpips.VGG16_CONV_IDX, jlpips.VGG16_CONV_CH)})
    lins = {f"lin{k}.model.1.weight": rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32)
            for k, c in enumerate(jlpips.TAP_CHANNELS)}
    conv = tckpt.flat_from_state_dict(tlpips.torch_lpips_state_dicts_to_params(vgg, lins))
    jconv = flatten_params(jlpips.torch_lpips_state_dicts_to_params(vgg, lins))
    assert sorted(conv) == sorted(jconv)
    for k, v in jconv.items():
        np.testing.assert_array_equal(conv[k], np.asarray(v), err_msg=k)
    tinit = tlpips.init_lpips_params(torch.Generator().manual_seed(0))
    assert set(tckpt.flat_from_state_dict(tinit)) == set(jconv)
    assert all(float(tinit[f"lins.{k}.kernel"].min()) >= 0 for k in range(5))
    lr_, lf_ = (rng.standard_normal((3, 4, 4, 1)).astype(np.float32) for _ in range(2))
    wts = rng.uniform(0.5, 2, 3).astype(np.float32)
    for name, args in (("hinge_d_loss", (lr_, lf_)), ("vanilla_d_loss", (lr_, lf_)),
                       ("hinge_d_loss_with_exemplar_weights", (lr_, lf_, wts))):
        np.testing.assert_allclose(float(getattr(tae, name)(*map(torch.from_numpy, args))),
                                   float(getattr(jae, name)(*map(jnp.asarray, args))),
                                   rtol=1e-6, err_msg=name)
    codes = rng.integers(0, 37, (2, 9, 9))
    for got, want in zip(tae.measure_perplexity(torch.from_numpy(codes), 40),
                         jae.measure_perplexity(jnp.asarray(codes), 40)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert [tae.adopt_weight(2.0, s, threshold=3) for s in (2, 3)] == [0.0, 2.0]

    # the VQ lookup in row chunks is bit-identical to the whole one
    vq = tv.make_first_stage(tv.AutoencoderConfig.from_json(_tiny_vae_config("vq").to_json()),
                             device="cpu")
    vq.load_state_dict(tckpt.state_dict_from_flat(numpy_params(jv.make_first_stage(
        _tiny_vae_config("vq")).init, 5)))
    zz = torch.from_numpy(rng.standard_normal((3, 7, 5, 3)).astype(np.float32))
    whole = vq.quantize_latents(zz)
    try:
        tv.QUANTIZE_CHUNK_ELEMS, saved = 16 * 4, tv.QUANTIZE_CHUNK_ELEMS  # 4 rows a chunk
        chunked = vq.quantize_latents(zz)
    finally:
        tv.QUANTIZE_CHUNK_ELEMS = saved
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])

    # the other cond stages: SpatialRescaler (every method, 0-2 stages, with
    # and without the channel mapper and its bias; down- and upsampling, on a
    # non-square input) and the identity
    img = rng.standard_normal((2, 16, 12, 3)).astype(np.float32)
    cases = [(m, n, 0.5, i % 3) for i, (m, n) in enumerate(itertools.product(
        sorted(jl.SpatialRescaler._METHODS), (0, 1, 2)))]
    cases += [(m, 1, 1.5, 1) for m in sorted(jl.SpatialRescaler._METHODS)]
    for method, n_stages, mult, mapper in cases:
        kw = dict(n_stages=n_stages, method=method, multiplier=mult, in_channels=3,
                  out_channels=None if mapper == 0 else 5, bias=mapper == 2)
        jr = jl.SpatialRescaler(**kw)
        flat = numpy_params(jr.init, 11)
        tr = tl.SpatialRescaler(**kw, device="cpu")
        assert set(tckpt.flat_from_state_dict(tr.state_dict())) == set(flat), kw
        tr.load_state_dict(tckpt.state_dict_from_flat(flat))
        with jax.default_matmul_precision("float32"):
            want = jr(_jax_tree(flat) if flat else {}, jnp.asarray(img))
        with torch.inference_mode():
            got = tr(torch.from_numpy(img))
        assert got.shape == want.shape, kw
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0,
                                   err_msg=str(kw))
    ident = tl.IdentityCondStage()
    assert not list(ident.parameters()) and jl.IdentityCondStage().init(None) == {}
    assert torch.equal(ident(torch.from_numpy(img)), torch.from_numpy(img))
    uncond = dataclasses.replace(tiny, use_spatial_transformer=False, context_dim=None)
    for jstage, tstage in ((jl.SpatialRescaler(n_stages=1, out_channels=4, bias=True),
                            tl.SpatialRescaler(n_stages=1, out_channels=4, bias=True,
                                               device="cpu")),
                           (jl.IdentityCondStage(), tl.IdentityCondStage())):
        jm = jl.LatentDiffusion(uncond, cond_stage=jstage)
        tm = tl.LatentDiffusion(tu.UNetCondConfig.from_json(uncond.to_json()),
                                cond_stage=tstage, device="cpu")
        assert tm.cond_stage is tstage
        flat = {k: v for k, v in numpy_params(jm.init, 12).items()
                if k.startswith("cond_stage/")}
        assert set(flat) == {f"cond_stage/{k}" for k in
                             tckpt.flat_from_state_dict(tstage.state_dict())}
        stage_flat = {k.split("/", 1)[1]: v for k, v in flat.items()}
        tm.init(torch.Generator().manual_seed(0))
        tstage.load_state_dict(tckpt.state_dict_from_flat(stage_flat))
        with jax.default_matmul_precision("float32"):
            want = jm.get_learned_conditioning(
                {"cond_stage": _jax_tree(stage_flat) if stage_flat else {}}, jnp.asarray(img))
        with torch.inference_mode():
            got = tm.get_learned_conditioning(torch.from_numpy(img))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    _check_text_and_clip_models(tmp_path, tiny, rng)

    # checkpoints: a JAX LDM dir (UNet pruned by the JAX package, VQ first
    # stage, 5 classes) loads in the port and writes back the same arrays;
    # an LDM dir written by the port loads in the JAX package
    from diff_pruning_tpu.cli.ldm_prune import load_ldm as jax_load_ldm
    from diff_pruning_tpu.cli.ldm_prune import write_ldm_meta
    from diff_pruning_tpu.pruning.importance import make_importance
    from diff_pruning_tpu.pruning.pruner import apply_pruning, prune

    jldm = jl.LatentDiffusion(tiny, n_classes=5, first_stage=jv.make_first_stage(
        _tiny_vae_config("vq")), scale_factor=0.7)
    params = _jax_tree(numpy_params(jldm.init, 6))
    res = prune(jldm.unet.graph, params["unet"], make_importance("magnitude"), sparsity=0.3)
    pcfg = tiny.with_channel_sizes(res.channel_sizes)
    params["unet"] = apply_pruning(params["unet"], jldm.unet.graph, res)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_model(jdir, pcfg, params["unet"], subfolder="unet")
    os.makedirs(os.path.join(jdir, "cond_stage"))
    jckpt.save_params_npz(os.path.join(jdir, "cond_stage", "params.npz"), params["cond_stage"])
    jckpt.save_model(jdir, jldm.first_stage.cfg, params["first_stage"], subfolder="first_stage")
    write_ldm_meta(jdir, jldm)
    tldm = tl.load_ldm(jdir, device="cpu")
    assert tldm.unet.cfg.channel_sizes == res.channel_sizes
    assert (tldm.n_classes, tldm.scale_factor) == (5, 0.7)
    tckpt.save_ldm(pdir, tldm)
    for sub in ("unet", "cond_stage", "first_stage"):
        with np.load(os.path.join(jdir, sub, "params.npz")) as a, \
                np.load(os.path.join(pdir, sub, "params.npz")) as b:
            assert sorted(a.files) == sorted(b.files), sub
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{sub}/{k}")
    for name in ("ldm.json", "unet/config.json", "first_stage/config.json"):
        with open(os.path.join(jdir, name)) as a, open(os.path.join(pdir, name)) as b:
            assert (name == "ldm.json" or a.read() == b.read()), name
    fresh = tl.LatentDiffusion(tu.tiny_cond_config(), n_classes=5, device="cpu",
                               first_stage=tv.make_first_stage(tv.AutoencoderConfig.from_json(
                                   _tiny_vae_config("kl").to_json()), device="cpu"))
    fresh.init(torch.Generator().manual_seed(7))
    fdir = str(tmp_path / "fresh")
    tckpt.save_ldm(fdir, fresh)
    jback, jparams = jax_load_ldm(fdir, None)
    jback.unet.graph.validate(jparams["unet"])
    assert jback.n_classes == 5 and jback.first_stage.cfg == jv.AutoencoderConfig.from_json(
        fresh.first_stage.cfg.to_json())
    sd = {**{f"unet.{k}": v for k, v in fresh.unet.state_dict().items()},
          **{f"cond_stage.{k}": v for k, v in fresh.cond_stage.state_dict().items()},
          **{f"first_stage.{k}": v for k, v in fresh.first_stage.state_dict().items()}}
    want = tckpt.flat_from_state_dict(sd)
    got = {k: np.asarray(v) for k, v in flatten_params(jparams).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the fresh model's zero-initialised leaves are the JAX init's
    jinit = flatten_params(ju.UNetCond(tiny).init(jax.random.key(0)))
    tinit = tckpt.flat_from_state_dict(fresh.unet.state_dict())
    for k, v in jinit.items():
        assert (not np.any(np.asarray(v))) == (not np.any(tinit[k])), k
    _check_ldm_converters(tmp_path, tiny)


def _check_ldm_converters(tmp_path, tiny):
    """See test_ldm_models_match_jax."""
    from _convert_layouts import (assert_flat_equal, bert_state_dict, compvis_vae_state_dict,
                                  discriminator_state_dict, ldm_unet_state_dict)
    from diff_pruning_tpu.eval import inception as jinc
    from diff_pruning_tpu.eval import lpips as jlp
    from diff_pruning_tpu.models import discriminator as jdisc
    from diff_pruning_tpu.models import text_encoder as jte
    from diff_pruning_tpu.utils import convert as jconv
    from diff_pruning_tpu_torch.cli import convert_checkpoints
    from diff_pruning_tpu_torch.eval.inception import random_init_fid_inception_state_dict
    from diff_pruning_tpu_torch.utils import convert as tconv

    def both(what, tfn, jfn, src, want):
        assert_flat_equal({k: np.asarray(v) for k, v in flatten_params(jfn(src)).items()},
                          want, what + " (JAX)")
        assert_flat_equal(tckpt.flat_from_state_dict(tfn(src)), want, what)

    legacy = dataclasses.replace(tiny, use_spatial_transformer=False, context_dim=None,
                                 num_classes=4)
    for i, ucfg in enumerate((tiny, legacy)):
        jm = ju.UNetCond(ucfg)
        flat = numpy_params(jm.init, 20 + i)
        heads = tu.UNetCond(tu.UNetCondConfig.from_json(ucfg.to_json()), device="meta").attn_heads
        assert heads == jm.attn_heads
        both(f"CompVis UNet {i}", lambda s: tconv.ldm_unet_state_dict_to_params(s, heads),
             lambda s: jconv.ldm_unet_state_dict_to_params(s, jm.attn_heads),
             ldm_unet_state_dict(flat, jm.attn_heads), flat)
    with pytest.raises(ValueError, match="attn_heads"):
        tconv.ldm_unet_state_dict_to_params(ldm_unet_state_dict(flat, jm.attn_heads))
    for kind in ("vq", "kl"):
        vcfg = _tiny_vae_config(kind)
        flat = numpy_params(jv.make_first_stage(vcfg).init, 22)
        vsd = compvis_vae_state_dict(flat, 2)
        assert tconv.infer_compvis_vae_config(vsd, 16).to_json() == \
            jconv.infer_compvis_vae_config(vsd, 16).to_json()
        both(f"CompVis {kind}", lambda s: tconv.compvis_vae_state_dict_to_params(s, 2),
             lambda s: jconv.compvis_vae_state_dict_to_params(s, 2), vsd, flat)
        # the first-stage CLI kind on a Lightning-style checkpoint
        torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in vsd.items()}},
                   tmp_path / f"{kind}.ckpt")
        convert_checkpoints.main(["first-stage", str(tmp_path / f"{kind}.ckpt"),
                                  str(tmp_path / f"fs_{kind}"), "--resolution", "16"])
        jcfg, jparams = jckpt.load_model(str(tmp_path / f"fs_{kind}"), subfolder="first_stage",
                                         config_cls=jv.AutoencoderConfig)
        assert jcfg.to_json() == jconv.infer_compvis_vae_config(vsd, 16).to_json()
        assert_flat_equal({k: np.asarray(v) for k, v in flatten_params(jparams).items()}, flat,
                          f"CLI first-stage {kind}")
    flat = numpy_params(jte.BERTEmbedder(jte.tiny_bert_config()).init, 23)
    both("BERT", tconv.bert_embedder_state_dict_to_params, jconv.bert_embedder_state_dict_to_params,
         bert_state_dict(flat), flat)
    for actnorm in (False, True):
        flat = numpy_params(jdisc.NLayerDiscriminator(ndf=8, n_layers=2,
                                                      use_actnorm=actnorm).init, 24)
        both(f"discriminator actnorm={actnorm}",
             lambda s: tconv.torch_discriminator_state_dict_to_params(s, 2),
             lambda s: jconv.torch_discriminator_state_dict_to_params(s, 2),
             discriminator_state_dict(flat, 2), flat)
    # lpips and inception CLI kinds against the JAX converters
    g = torch.Generator().manual_seed(25)
    vgg = {}
    for i, (cin, cout) in zip(jlp.VGG16_CONV_IDX, jlp.VGG16_CONV_CH):
        vgg[f"features.{i}.weight"] = torch.randn((cout, cin, 3, 3), generator=g) * 0.05
        vgg[f"features.{i}.bias"] = torch.randn((cout,), generator=g) * 0.1
    lin = {f"lin{k}.model.1.weight": torch.rand((1, c, 1, 1), generator=g)
           for k, c in enumerate(jlp.TAP_CHANNELS)}
    torch.save(vgg, tmp_path / "vgg.pth")
    torch.save({"state_dict": lin}, tmp_path / "lin.ckpt")
    convert_checkpoints.main(["lpips", str(tmp_path / "vgg.pth"), str(tmp_path / "lpips.npz"),
                              "--lin", str(tmp_path / "lin.ckpt")])
    inc = random_init_fid_inception_state_dict(26)
    inc["fc.weight"], inc["fc.bias"] = torch.randn((1008, 2048), generator=g), torch.zeros(1008)
    inc["AuxLogits.fc.weight"] = torch.zeros((1000, 768))
    torch.save(inc, tmp_path / "pt_inception.pth")
    convert_checkpoints.main(["inception", str(tmp_path / "pt_inception.pth"),
                              str(tmp_path / "inception.npz")])
    for path, want in (("lpips.npz", jlp.torch_lpips_state_dicts_to_params(vgg, lin)),
                       ("inception.npz", jinc.torch_inception_state_dict_to_params(inc))):
        with np.load(tmp_path / path) as z:
            assert_flat_equal({k: z[k] for k in z.files},
                              {k: np.asarray(v) for k, v in flatten_params(want).items()}, path)


def test_ldm_sampling_and_cli_match_jax(tmp_path, monkeypatch, capsys):
    """The LDM schedule and timesteps; CFG trajectories (DDIM, PLMS,
    DPM-Solver++; 4 steps, scale 3; DDIM also at 3, whose grid ends at t =
    1000) from JAX's own x_T, then the decode;
    the sampler's refusals; the ldm_sample CLI on --device cpu (files,
    numbering across classes with a partial batch, image shapes), on 2 gloo
    ranks against one process, and its refusal without a GPU, with and
    without --multihost."""
    js, ts_ = jl.ldm_schedule(), tl.ldm_schedule()
    np.testing.assert_allclose(ts_.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod),
                               rtol=1e-6)
    for s in (3, 4, 20, 250):
        np.testing.assert_array_equal(tl.compvis_ddim_timesteps(s), jl.compvis_ddim_timesteps(s))
    assert tl.compvis_ddim_timesteps(3)[0] == 1000  # past the schedule: alpha_bar clamps

    tiny = ju.tiny_cond_config()
    jldm = jl.LatentDiffusion(tiny, n_classes=5, first_stage=jv.make_first_stage(
        _tiny_vae_config("vq")), scale_factor=0.8)
    flat = numpy_params(jldm.init, 8)
    jparams = _jax_tree(flat)
    model_dir = str(tmp_path / "ldm")
    jckpt.save_model(model_dir, tiny, jparams["unet"], subfolder="unet")
    os.makedirs(os.path.join(model_dir, "cond_stage"))
    jckpt.save_params_npz(os.path.join(model_dir, "cond_stage", "params.npz"),
                          jparams["cond_stage"])
    jckpt.save_model(model_dir, jldm.first_stage.cfg, jparams["first_stage"],
                     subfolder="first_stage")
    from diff_pruning_tpu.cli.ldm_prune import write_ldm_meta

    write_ldm_meta(model_dir, jldm)
    tldm = tl.load_ldm(model_dir, device="cpu")
    labels = np.array([0, 3, 1], np.int32)
    key = jax.random.key(9)
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[1], (3, 8, 8, 3)))
    for method, steps in (("ddim", 4), ("ddim", 3), ("plms", 4), ("dpm", 4)):
        with jax.default_matmul_precision("float32"):
            sampler = jldm.make_cfg_sampler(jparams, ddim_steps=steps, guidance_scale=3.0,
                                            latent_hw=8, latent_ch=3, method=method)
            want = sampler(key, jnp.asarray(labels), 3)
            want_img = np.asarray(jldm.decode_first_stage(jparams, want))
        sample = tldm.make_cfg_sampler(ddim_steps=steps, guidance_scale=3.0, latent_hw=8,
                                       latent_ch=3, method=method)
        got = sample(None, torch.from_numpy(labels), 3, x_T=torch.from_numpy(x_T.copy()))
        got_img = tldm.decode_first_stage(got)
        assert got.shape == (3, 8, 8, 3) and got_img.shape == (3, 16, 16, 3)
        assert _rel(got.numpy(), want) <= TRAJ_RTOL, (method, _rel(got.numpy(), want))
        assert _rel(got_img.numpy(), want_img) <= TRAJ_RTOL, method
    for method in ("plms", "dpm"):
        with pytest.raises(ValueError, match="eta == 0"):
            tldm.make_cfg_sampler(method=method, eta=0.5)
    # DDIM with eta > 0 draws its noise from the generator: same seed, same samples
    sample = tldm.make_cfg_sampler(ddim_steps=4, eta=1.0, latent_hw=8, latent_ch=3)
    a, b = (sample(torch.Generator().manual_seed(1), torch.from_numpy(labels), 3)
            for _ in range(2))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())

    # the concat sampler on a no-context UNetCond, unconditional (Cc = 0) and
    # with 2 conditioning planes, from JAX's x_T and per-step noise
    uncond = dataclasses.replace(tiny, use_spatial_transformer=False, context_dim=None)
    ckey = jax.random.key(4)
    k, ik = jax.random.split(ckey)
    cx_T = jax.random.normal(ik, (2, 8, 8, 3))
    cnoise = []
    for _ in tl.compvis_ddim_timesteps(4):
        k, nk = jax.random.split(k)
        cnoise.append(torch.from_numpy(np.array(jax.random.normal(nk, (2, 8, 8, 3)))))
    for cc in (0, 2):
        ucfg = dataclasses.replace(uncond, in_channels=3 + cc)
        jm = ju.UNetCond(ucfg)
        uflat = numpy_params(jm.init, 13 + cc)
        tm = tu.UNetCond(tu.UNetCondConfig.from_json(ucfg.to_json()), device="cpu")
        tm.load_state_dict(tckpt.state_dict_from_flat(uflat))
        tm.eval()
        cond = np.random.default_rng(cc).standard_normal((2, 8, 8, cc)).astype(np.float32)
        for method, eta in (("ddim", 0.0), ("ddim", 1.0), ("plms", 0.0), ("dpm", 0.0)):
            kw = dict(ddim_steps=4, eta=eta, latent_ch=3, method=method)
            with jax.default_matmul_precision("float32"):
                want = jl.make_concat_sampler(jm, _jax_tree(uflat), js, **kw)(
                    ckey, jnp.asarray(cond))
            got = tl.make_concat_sampler(tm, ts_, **kw)(
                None, torch.from_numpy(cond), x_T=torch.from_numpy(np.array(cx_T)),
                noise=cnoise)
            assert got.shape == (2, 8, 8, 3)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0,
                                       err_msg=f"concat {method} eta {eta} Cc {cc}")
    concat = tl.make_concat_sampler(tm, ts_, ddim_steps=4, eta=1.0)
    a, b = (concat(torch.Generator().manual_seed(2), torch.from_numpy(cond)) for _ in range(2))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    for method in ("plms", "dpm"):
        with pytest.raises(ValueError, match="eta == 0"):
            tl.make_concat_sampler(tm, ts_, method=method, eta=1.0)

    # sample_diffusion on model dirs that the JAX package wrote (VQ and KL
    # first stages, as tests/test_sample_diffusion_cli.py writes them)
    from diff_pruning_tpu_torch.cli import sample_diffusion
    from PIL import Image

    ucfg = ju.UNetCondConfig(
        image_size=8, in_channels=3, out_channels=3, model_channels=32, num_res_blocks=1,
        attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2, context_dim=None,
        use_spatial_transformer=False, norm_num_groups=8)
    for kind in ("vq", "kl"):
        vcfg = jv.AutoencoderConfig(block_out_channels=(8, 8), layers_per_block=1,
                                    latent_channels=3, norm_num_groups=4,
                                    num_vq_embeddings=16 if kind == "vq" else None,
                                    mid_block_attention=False, sample_size=16)
        udir = str(tmp_path / f"uncond_{kind}")
        jckpt.save_model(udir, ucfg, ju.UNetCond(ucfg).init(jax.random.key(0)),
                         subfolder="unet")
        jckpt.save_model(udir, vcfg, jv.make_first_stage(vcfg).init(jax.random.key(1)),
                         subfolder="first_stage")
        for extra, n in (([], 3), (["--vanilla_sample"], 1)):
            logdir = tmp_path / f"sd_{kind}_{len(extra)}"
            stats = sample_diffusion.main(["--model_path", udir, "--logdir", str(logdir),
                                           "--n_samples", str(n), "--batch_size", "2",
                                           "--custom_steps", "2", "--device", "cpu"] + extra)
            files = sorted(os.listdir(logdir / "img"))
            assert files == [f"{i:06d}.png" for i in range(n)], (kind, extra)
            assert stats["images"] == n and stats["nonfinite"] == 0
            assert np.asarray(Image.open(logdir / "img" / files[0])).shape == (16, 16, 3)
        assert "allow_tf32=False" in capsys.readouterr().out

    from diff_pruning_tpu_torch.cli import ldm_sample

    out = tmp_path / "samples"
    stats = ldm_sample.main(["--model_path", model_dir, "--output_dir", str(out),
                             "--num_classes", "2", "--ipc", "3", "--batch_size", "2",
                             "--ddim_steps", "2", "--method", "plms", "--device", "cpu"])
    assert "allow_tf32=False" in capsys.readouterr().out
    pngs = sorted(os.listdir(out))
    assert pngs == [f"{i:06d}.png" for i in range(6)] and stats["images"] == 6
    assert stats["nonfinite"] == 0
    from PIL import Image

    assert np.asarray(Image.open(out / pngs[-1])).shape == (16, 16, 3)
    # --multihost on 2 gloo ranks, DDIM eta 1 (every draw at the global
    # shape): each rank writes its row of every batch of 2 to
    # process_{rank}/, numbered locally; the union in global order is the
    # one-process run's images within one uint8 level (f32 sum order only);
    # --ipc not a multiple of --batch_size is refused, as the JAX CLI does
    import _torch_dp

    dp = ["--model_path", model_dir, "--num_classes", "2", "--ipc", "2", "--batch_size", "2",
          "--ddim_steps", "2", "--eta", "1.0"]
    ldm_sample.main(dp + ["--output_dir", str(tmp_path / "dp1"), "--device", "cpu"])
    _torch_dp.cli_ranks("ldm_sample", dp + ["--output_dir", str(tmp_path / "dp2")])
    dirs = [tmp_path / "dp2" / f"process_{r}" for r in (0, 1)]
    assert [sorted(os.listdir(d)) for d in dirs] == [["000000.png", "000001.png"]] * 2
    assert sorted(os.listdir(tmp_path / "dp1")) == [f"{i:06d}.png" for i in range(4)]
    for i in range(4):
        got = np.asarray(Image.open(dirs[i % 2] / f"{i // 2:06d}.png"), np.int16)
        want = np.asarray(Image.open(tmp_path / "dp1" / f"{i:06d}.png"), np.int16)
        assert np.abs(got - want).max() <= 1, i
    with pytest.raises(AssertionError, match="--ipc % --batch_size == 0"):
        _torch_dp.cli_ranks("ldm_sample", dp[:5] + ["3"] + dp[6:] + [
            "--output_dir", str(tmp_path / "dp3")])
    # without a first stage the latents are mapped from [-1, 1]
    os.rename(os.path.join(model_dir, "first_stage"), str(tmp_path / "first_stage"))
    ldm_sample.main(["--model_path", model_dir, "--output_dir", str(tmp_path / "latent"),
                     "--num_classes", "1", "--ipc", "1", "--batch_size", "1",
                     "--ddim_steps", "2", "--method", "dpm", "--device", "cpu"])
    assert np.asarray(Image.open(tmp_path / "latent" / "000000.png")).shape == (8, 8, 3)
    text_dirs = _check_text_and_retrieval_serving(tmp_path, capsys)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from diff_pruning_tpu_torch.cli import inpaint, knn2img, train_searcher, txt2img

    for cli, argv in ((txt2img, ["--vocab", text_dirs["vocab"]]),
                      (inpaint, ["--indir", "i", "--outdir", "o", "--model_path", udir]),
                      (train_searcher, ["--images", "i", "--target_path", "t"]),
                      (knn2img, ["--model_path", text_dirs["knn"], "--outdir", "o",
                                 "--bpe", "b"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ldm_sample.main(["--model_path", model_dir, "--output_dir", str(out)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_diffusion.main(["--model_path", udir, "--logdir", str(out)])
    with pytest.raises(RuntimeError, match="no CUDA device"):  # NCCL needs the card
        ldm_sample.main(["--model_path", model_dir, "--output_dir", str(out), "--multihost",
                         "--coordinator_address", "127.0.0.1:1", "--num_processes", "1",
                         "--process_id", "0"])


def _check_text_and_retrieval_serving(tmp_path, capsys):
    """The text- and retrieval-conditioned serving paths: the CFG sampler
    with ``uncond_input`` (the empty prompt through the BERT cond stage) and
    the concat inpaint sampler (a VQ encode plus the mask plane), each from
    JAX's x_T (relative error in norm <= TRAJ_RTOL; concat atol 5e-5, as
    above); the exact searcher's top-k (the same indices) and its database
    files crossing both ways; then the txt2img, inpaint, train_searcher and
    knn2img CLIs on --device cpu against the JAX CLIs on the same model dirs,
    which the JAX package writes: the same files and image sizes, inpaint's
    composite outside the mask within one level of the input and of the JAX
    CLI's, and train_searcher's embeddings within ATOL/RTOL. Returns the
    dirs that the refusal checks reuse."""
    from PIL import Image

    from diff_pruning_tpu import retrieval as jret
    from diff_pruning_tpu.cli import inpaint as jinpaint
    from diff_pruning_tpu.cli import knn2img as jknn
    from diff_pruning_tpu.cli import train_searcher as jsearch
    from diff_pruning_tpu.cli import txt2img as jtxt
    from diff_pruning_tpu.data.tokenizer import BERTTokenizer
    from diff_pruning_tpu.models import clip as jclip
    from diff_pruning_tpu.models import text_encoder as jte
    from diff_pruning_tpu_torch import retrieval as tret
    from diff_pruning_tpu_torch.cli import inpaint, knn2img, train_searcher, txt2img

    def png(path):
        return np.asarray(Image.open(path))

    def listing(d):
        return sorted(os.listdir(d))

    # a tiny txt2img dir (BERT cond stage, KL f2 first stage) written by JAX
    bcfg = jte.tiny_bert_config()
    ucfg = dataclasses.replace(ju.tiny_cond_config(), in_channels=4, out_channels=4)
    fcfg = jv.AutoencoderConfig(block_out_channels=(8, 8), layers_per_block=1,
                                latent_channels=4, norm_num_groups=4,
                                mid_block_attention=False, sample_size=16)
    jldm = jl.LatentDiffusion(ucfg, cond_stage=jte.BERTEmbedder(bcfg),
                              first_stage=jv.AutoencoderKL(fcfg), linear_start=0.00085,
                              linear_end=0.012, scale_factor=0.18215)
    jparams = _jax_tree(numpy_params(jldm.init, 30))
    tdir = str(tmp_path / "txt2img")
    for sub, cfg in (("unet", ucfg), ("cond_stage", bcfg), ("first_stage", fcfg)):
        jckpt.save_model(tdir, cfg, jparams[sub], subfolder=sub)
    vocab = str(tmp_path / "bert_vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "virus", "monster",
                           "guitar", "painting", "of", "playing"]) + "\n")
    tok = BERTTokenizer(vocab, max_length=bcfg.max_seq_len)
    tldm = txt2img.load_txt2img(tdir, device="cpu")
    tokens = np.repeat(tok(["a virus monster playing"]), 3, axis=0)
    key = jax.random.key(5)
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[1], (3, 4, 4, 4)))
    for method in ("ddim", "plms"):
        kw = dict(ddim_steps=4, guidance_scale=5.0, latent_hw=(4, 4), latent_ch=4,
                  method=method, uncond_input=tok([""]))
        with jax.default_matmul_precision("float32"):
            want = jldm.make_cfg_sampler(jparams, **kw)(key, jnp.asarray(tokens), 3)
            want_img = np.asarray(jldm.decode_first_stage(jparams, want))
        got = tldm.make_cfg_sampler(**kw)(None, torch.from_numpy(tokens), 3,
                                          x_T=torch.from_numpy(x_T.copy()))
        assert _rel(got.numpy(), want) <= TRAJ_RTOL, (method, _rel(got.numpy(), want))
        assert _rel(tldm.decode_first_stage(got).numpy(), want_img) <= TRAJ_RTOL, method
    # a dir written by the port (save_ldm: cond_stage/ with its config) loads
    # in the JAX CLI's loader with the same arrays
    pdir = str(tmp_path / "txt2img_port")
    tckpt.save_ldm(pdir, tldm)
    _, jenc, jback = jtxt.load_txt2img(pdir)
    assert jenc.cfg == bcfg
    want = tckpt.flat_from_state_dict(tldm.state_dict())
    got = flatten_params(jback)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)

    # the concat inpaint sampler: the VQ encode of a masked image and the
    # nearest-strided mask plane, the inpainting schedule (linear_end 0.0205)
    icfg = ju.UNetCondConfig(image_size=8, in_channels=7, out_channels=3, model_channels=32,
                             num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                             num_heads=2, context_dim=None, use_spatial_transformer=False,
                             resblock_updown=True, norm_num_groups=8)
    vcfg = jv.AutoencoderConfig(block_out_channels=(8, 8), layers_per_block=1,
                                latent_channels=3, norm_num_groups=4, num_vq_embeddings=16,
                                mid_block_attention=False, sample_size=16)
    iflat, vflat = numpy_params(ju.UNetCond(icfg).init, 31), numpy_params(
        jv.VQModel(vcfg).init, 32)
    idir = str(tmp_path / "inpaint_model")
    jckpt.save_model(idir, icfg, _jax_tree(iflat), subfolder="unet")
    jckpt.save_model(idir, vcfg, _jax_tree(vflat), subfolder="first_stage")
    rng = np.random.default_rng(33)
    masked = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    plane = np.sign(rng.standard_normal((2, 8, 8, 1))).astype(np.float32)
    tvq = tv.make_first_stage(tv.AutoencoderConfig.from_json(vcfg.to_json()), device="cpu")
    tvq.load_state_dict(tckpt.state_dict_from_flat(vflat))
    tun = tu.UNetCond(tu.UNetCondConfig.from_json(icfg.to_json()), device="cpu")
    tun.load_state_dict(tckpt.state_dict_from_flat(iflat))
    tun.eval()
    ckey = jax.random.key(6)
    cx_T = np.array(jax.random.normal(jax.random.split(ckey)[1], (2, 8, 8, 3)))
    with jax.default_matmul_precision("float32"):
        jcond = jnp.concatenate([jv.VQModel(vcfg).encode(_jax_tree(vflat), jnp.asarray(masked)),
                                 jnp.asarray(plane)], axis=-1)
        want = jl.make_concat_sampler(ju.UNetCond(icfg), _jax_tree(iflat),
                                      jl.ldm_schedule(linear_end=0.0205), ddim_steps=4,
                                      latent_ch=3)(ckey, jcond)
    with torch.inference_mode():
        tcond = torch.cat([tvq.encode(torch.from_numpy(masked)), torch.from_numpy(plane)], -1)
    _close(tcond.numpy(), jcond, "inpaint cond")
    got = tl.make_concat_sampler(tun, tl.ldm_schedule(linear_end=0.0205), ddim_steps=4,
                                 latent_ch=3)(None, tcond, x_T=torch.from_numpy(cx_T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0,
                               err_msg="concat inpaint")

    # the exact searcher and its database files
    emb = rng.standard_normal((50, 8)).astype(np.float32)
    db = {"embedding": emb, "img_id": np.arange(50, dtype=np.int64),
          "patch_coords": rng.integers(0, 9, (50, 4)).astype(np.int64)}
    q = rng.standard_normal((3, 8)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        for x in (q, q[:, None, :]):
            want, got = jret.ExactSearcher(db)(x, 5), tret.ExactSearcher(db)(x, 5)
            for k_ in ("nns", "img_ids", "patch_coords"):
                np.testing.assert_array_equal(got[k_], want[k_], err_msg=k_)
            np.testing.assert_allclose(got["nn_embeddings"], want["nn_embeddings"], rtol=1e-6)
    for save, load in ((tret.save_searcher, jret.load_searcher),
                       (jret.save_searcher, tret.load_searcher)):
        d = str(tmp_path / f"db_{save.__module__.split('.')[0]}")
        save(db, d)
        back = load(d).database
        assert sorted(back) == sorted(db)
        for k_ in db:
            np.testing.assert_array_equal(np.asarray(back[k_]), db[k_], err_msg=k_)
    multi = tmp_path / "db_multi"
    multi.mkdir()
    for i in range(3):
        np.savez(multi / f"part{i}.npz", embedding=emb[None, 4 * i:4 * i + 4],
                 img_id=np.arange(4)[None], patch_coords=np.zeros((1, 4, 4)))
    for k_, v in jret.load_datapool(str(multi)).items():
        np.testing.assert_array_equal(tret.load_datapool(str(multi))[k_], v, err_msg=k_)

    # the CLIs, each package's on the same dirs
    outs = {}
    for name, main in (("jax", jtxt.main), ("port", txt2img.main)):
        argv = ["--model_path", tdir, "--vocab", vocab, "--outdir", str(tmp_path / f"t2i_{name}"),
                "--prompt", "a virus monster", "--ddim_steps", "4", "--n_samples", "2",
                "--n_iter", "2", "--H", "32", "--W", "32"]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        outs[name] = tmp_path / f"t2i_{name}"
    assert listing(outs["port"]) == listing(outs["jax"]) == ["grid.png", "samples"]
    assert listing(outs["port"] / "samples") == listing(outs["jax"] / "samples") == [
        f"{i:06d}.png" for i in range(4)]
    for f in ("grid.png", "samples/000003.png"):
        assert png(outs["port"] / f).shape == png(outs["jax"] / f).shape, f
    assert png(outs["port"] / "samples/000000.png").shape == (8, 8, 3)
    stats = txt2img.main(["--model_path", tdir, "--vocab", vocab, "--plms", "--ddim_steps", "2",
                          "--n_samples", "2", "--H", "32", "--W", "32", "--device", "cpu",
                          "--outdir", str(tmp_path / "t2i_plms")])
    assert stats["images"] == 2 and stats["nonfinite"] == 0
    big_vocab = str(tmp_path / "big_vocab.txt")
    with open(big_vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + [f"w{i}" for i in range(40)]))
    with pytest.raises(SystemExit, match="44 tokens but the text encoder embeds 40"):
        txt2img.main(["--model_path", tdir, "--vocab", big_vocab, "--device", "cpu",
                      "--outdir", str(tmp_path / "t2i_bad")])

    indir = tmp_path / "inpaint_in"
    indir.mkdir()
    keep = np.ones((2, 16, 16), bool)
    for i, (y0, x0) in enumerate(((4, 4), (2, 7))):
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8), "RGB").save(
            indir / f"im{i}.png")
        mask = np.zeros((16, 16), np.uint8)
        mask[y0:y0 + 8, x0:x0 + 8] = 255
        keep[i, y0:y0 + 8, x0:x0 + 8] = False
        Image.fromarray(mask, "L").save(indir / f"im{i}_mask.png")
    for name, main in (("jax", jinpaint.main), ("port", inpaint.main)):
        argv = ["--indir", str(indir), "--outdir", str(tmp_path / f"inpaint_{name}"),
                "--model_path", idir, "--steps", "2", "--batch_size", "2"]
        main(argv + (["--device", "cpu"] if name == "port" else []))
    assert listing(tmp_path / "inpaint_port") == listing(tmp_path / "inpaint_jax") == [
        "im0.png", "im1.png"]
    for i in range(2):
        src = png(indir / f"im{i}.png").astype(int)
        got, want = (png(tmp_path / f"inpaint_{n}" / f"im{i}.png").astype(int)
                     for n in ("port", "jax"))
        assert got.shape == want.shape == (16, 16, 3)
        assert np.abs(got[keep[i]] - src[keep[i]]).max() <= 1
        assert np.abs(got[keep[i]] - want[keep[i]]).max() <= 1

    # train_searcher: a CLIP dir written by JAX, a folder of PNGs
    ccfg = dataclasses.replace(jclip.tiny_clip_config(), vocab_size=520)
    kdir = tmp_path / "knn_model"
    kucfg = ju.UNetCondConfig(image_size=8, in_channels=4, out_channels=4, model_channels=32,
                              num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                              num_heads=2, transformer_depth=1, context_dim=ccfg.embed_dim,
                              norm_num_groups=8)
    kfcfg = jv.AutoencoderConfig(block_out_channels=(8, 8), layers_per_block=1,
                                 latent_channels=4, norm_num_groups=4,
                                 mid_block_attention=False, sample_size=16)
    jckpt.save_model(str(kdir), kucfg, _jax_tree(numpy_params(ju.UNetCond(kucfg).init, 34)),
                     subfolder="unet")
    jckpt.save_model(str(kdir), kfcfg, _jax_tree(numpy_params(jv.AutoencoderKL(kfcfg).init,
                                                              35)), subfolder="first_stage")
    jckpt.save_model(str(kdir), ccfg, _jax_tree(numpy_params(jclip.CLIP(ccfg).init, 36)),
                     subfolder="clip")
    imdir = tmp_path / "knn_images"
    imdir.mkdir()
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8), "RGB").save(
            imdir / f"{i}.png")
    for name, main in (("jax", jsearch.main), ("port", train_searcher.main)):
        argv = ["--images", str(imdir), "--clip_path", str(kdir / "clip"), "--target_path",
                str(tmp_path / f"searcher_{name}"), "--batch_size", "4"]
        with jax.default_matmul_precision("float32"):
            main(argv + (["--device", "cpu"] if name == "port" else []))
    got, want = (tret.load_datapool(str(tmp_path / f"searcher_{n}")) for n in ("port", "jax"))
    assert sorted(got) == sorted(want) and got["embedding"].shape == (6, ccfg.embed_dim)
    _close(got["embedding"], want["embedding"], "train_searcher embeddings")
    for k_ in ("img_id", "patch_coords"):
        np.testing.assert_array_equal(got[k_], want[k_], err_msg=k_)

    bpe = tmp_path / "knn_merges.txt"
    bpe.write_text("#version: 0.2\n" + "\n".join(
        ["h e</w>", "l l", "t h", "th e</w>", "a n", "an d</w>"]) + "\n")
    for name, main in (("jax", jknn.main), ("port", knn2img.main)):
        argv = ["--prompt", "the hell and the", "--outdir", str(tmp_path / f"knn_{name}"),
                "--model_path", str(kdir), "--bpe", str(bpe), "--database",
                str(tmp_path / "searcher_jax"), "--use_neighbors", "--knn", "3",
                "--ddim_steps", "2", "--n_samples", "2", "--H", "16", "--W", "16",
                "--scale", "2.0"]
        main(argv + (["--device", "cpu"] if name == "port" else []))
    for f in ("grid-0000.png", "samples/00000.png", "samples/00001.png"):
        assert png(tmp_path / "knn_port" / f).shape == png(tmp_path / "knn_jax" / f).shape, f
    assert listing(tmp_path / "knn_port") == listing(tmp_path / "knn_jax")
    assert png(tmp_path / "knn_port" / "samples/00000.png").shape == (16, 16, 3)
    # --from-file into the same outdir: numbering goes on, a second grid
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("the hell\n\nand the\n")
    stats = knn2img.main(["--from-file", str(prompts), "--outdir", str(tmp_path / "knn_port"),
                          "--model_path", str(kdir), "--bpe", str(bpe), "--ddim_steps", "2",
                          "--n_samples", "1", "--H", "16", "--W", "16", "--device", "cpu"])
    assert stats["images"] == 2 and stats["nonfinite"] == 0
    assert listing(tmp_path / "knn_port" / "samples") == [f"{i:05d}.png" for i in range(4)]
    assert png(tmp_path / "knn_port" / "grid-0001.png").shape == (32, 16, 3)
    with pytest.raises(SystemExit, match="needs --database"):
        knn2img.main(["--outdir", str(tmp_path / "knn_bad"), "--model_path", str(kdir), "--bpe",
                      str(bpe), "--use_neighbors", "--device", "cpu"])
    assert "allow_tf32=False" in capsys.readouterr().out
    return {"vocab": vocab, "knn": str(kdir)}
