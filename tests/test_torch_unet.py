"""The port's UNet, channel graph and weight bridge against the JAX package.

Parameters are made with numpy from a seed and handed to both packages
through the flat ``a/b/kernel`` layout; JAX runs with f32 matmuls.

Tolerance for UNet outputs (f32, both on the CPU): atol = rtol = 5e-5. The
two packages sum in different orders through ~60 layers of convolutions,
norms and attention, which moves outputs of order 1 by a few 1e-6 (5e-6 at
full CIFAR width).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diff_pruning_tpu.models import unet2d as junet
from diff_pruning_tpu.pruning.surgery import flatten_params, unflatten_params
from diff_pruning_tpu.utils import checkpoint as jckpt
from diff_pruning_tpu_torch import ops
from diff_pruning_tpu_torch.models import unet2d as tunet
from diff_pruning_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)
ATOL = RTOL = 5e-5


def numpy_params(jmodel, seed):
    """Flat JAX-layout params with torch-like init scales and non-trivial norms."""
    rng = np.random.default_rng(seed)
    shapes = flatten_params(jax.eval_shape(jmodel.init, jax.random.key(0)))
    flat = {}
    for path, s in shapes.items():
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


def port_model(cfg, flat):
    m = tunet.UNet2D(tunet.UNet2DConfig.from_json(cfg.to_json()), device="cpu")
    m.load_state_dict(tckpt.state_dict_from_flat(flat))
    return m.eval()


def forward_both(jmodel, tmodel, flat, x, t):
    with jax.default_matmul_precision("float32"):
        want = jmodel(unflatten_params({k: jnp.asarray(v) for k, v in flat.items()}),
                      jnp.asarray(x), jnp.asarray(t))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t))
    return np.asarray(want), got.numpy()


def _graph_signature(g):
    vars_ = [(v.name, v.size, v.prunable, v.group_div, v.round_to) for v in g.vars.values()]
    refs = [(r.param, r.axis, tuple((v.name, off) for v, off in r.parts), r.role)
            for r in g.refs]
    return vars_, refs


def test_graph_matches_jax(tmp_path):
    """The two graphs field by field and var_adjacency equal; on the tiny
    UNet the regularizers (pruning/regularize.py) against the JAX package's,
    both f32: the L1 penalty, the group norms and the new grads within 1e-6
    relative (of the largest value of each output). With grads 1e-3 as
    large the added decay dominates the new grads, and they agree within
    1e-5: the per-channel scores' f32 sum orders (~1e-7 relative) enter an
    exponent, base^((max - s) / (max - min)), which scales them by ln(base)
    x max / (max - min). The visualizers draw their PNGs."""
    from diff_pruning_tpu.pruning import regularize as jreg
    from diff_pruning_tpu.pruning.visualize import var_adjacency as jadjacency
    from diff_pruning_tpu_torch.pruning import regularize as treg
    from diff_pruning_tpu_torch.pruning import visualize as tvis

    for config in ("tiny_unet_config", "ddpm_cifar10_config"):
        jg = junet.UNet2D(getattr(junet, config)()).graph
        tg = tunet.UNet2D(getattr(tunet, config)(), device="meta").graph
        assert _graph_signature(tg) == _graph_signature(jg), config
        names, adj = tvis.var_adjacency(tg)
        jnames, jadj = jadjacency(jg)
        assert names == jnames and np.array_equal(adj, jadj) and adj.sum() > 0, config

    jmodel = junet.UNet2D(junet.tiny_unet_config())
    tg = tunet.UNet2D(tunet.tiny_unet_config(), device="meta").graph
    flat = numpy_params(jmodel, seed=21)
    rng = np.random.default_rng(22)
    unit = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()}
    jp = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    tp = unflatten_params({k: torch.from_numpy(v) for k, v in flat.items()})

    def close(got, want, tol, what):
        got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape, what
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), what

    close(treg.l1_norm_scale_penalty(tg, tp, coeff=1e-3),
          jreg.l1_norm_scale_penalty(jmodel.graph, jp, coeff=1e-3), 1e-6, "l1")
    norms, jnorms = treg.group_l2_norms(tg, tp), jreg.group_l2_norms(jmodel.graph, jp)
    assert sorted(norms) == sorted(jnorms) == sorted(v.name for v in tg.prunable_vars())
    for k, v in jnorms.items():
        close(norms[k], v, 1e-6, k)
    for grad_scale, tol in ((1.0, 1e-6), (1e-3, 1e-5)):
        gflat = {k: (grad_scale * v).astype(np.float32) for k, v in unit.items()}
        jgr = unflatten_params({k: jnp.asarray(v) for k, v in gflat.items()})
        tgr = unflatten_params({k: torch.from_numpy(v) for k, v in gflat.items()})
        for name in ("group_lasso_grads", "taylor_scaled_grads", "scaling_factor_grads"):
            got = flatten_params(getattr(treg, name)(tg, tp, tgr, reg=1e-2))
            want = flatten_params(getattr(jreg, name)(jmodel.graph, jp, jgr, reg=1e-2))
            assert sorted(got) == sorted(want), name
            decayed = 0
            for k, w in want.items():
                assert isinstance(got[k], torch.Tensor) and got[k].dtype == torch.float32
                close(got[k], w, tol, f"{name} {k} x{grad_scale}")
                decayed += not np.array_equal(np.asarray(w), gflat[k])
            assert decayed > 0, name
            assert all(torch.equal(torch.from_numpy(gflat[k]), g)  # the inputs stay as given
                       for k, g in flatten_params(tgr).items())
    tvis.draw_dependency_graph(tg, str(tmp_path / "graph.png"))
    res_scores = {k: v.numpy() for k, v in list(norms.items())[:2]}
    tvis.draw_importance_bars(res_scores, str(tmp_path / "bars"),
                              keep={k: np.arange(0, len(v), 2) for k, v in res_scores.items()})
    assert (tmp_path / "graph.png").is_file()
    assert sorted(f.name for f in (tmp_path / "bars").iterdir()) == ["imp_000.png",
                                                                     "imp_001.png"]


@pytest.mark.parametrize("attn", [True, False])
def test_tiny_forward_matches_jax(attn):
    cfg = junet.tiny_unet_config(attn=attn)
    assert tunet.tiny_unet_config(attn=attn).to_json() == cfg.to_json()
    jmodel = junet.UNet2D(cfg)
    flat = numpy_params(jmodel, seed=1)
    tmodel = port_model(cfg, flat)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([7, 901], np.int32)
    want, got = forward_both(jmodel, tmodel, flat, x, t)
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the kernel switches off route the layers to the same plain math on the CPU
    try:
        ops.set_kernels_enabled(False)
        with torch.inference_mode():
            off = tmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    finally:
        ops.set_kernels_enabled(True)
    np.testing.assert_array_equal(off, got)


def test_cifar10_full_width_params_and_forward():
    cfg = junet.ddpm_cifar10_config()
    assert tunet.ddpm_cifar10_config().to_json() == cfg.to_json()
    jmodel = junet.UNet2D(cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    flat = numpy_params(jmodel, seed=3)
    tmodel = port_model(cfg, flat)
    assert sum(p.numel() for p in tmodel.parameters()) == n_jax == 35_746_307
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    want, got = forward_both(jmodel, tmodel, flat, x, np.array([500], np.int32))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_checkpoints_cross_both_ways(tmp_path):
    """A checkpoint written by the JAX package loads here and is written back
    byte-for-byte the same arrays; one written here loads in the JAX package,
    validates against its graph and gives the same forward. Then the
    converters (utils/convert.py): the diffusers and DDIM-codebase ones give
    exactly the JAX ones' arrays; a diffusers directory written by either
    package's exporter, dense and pruned, loads in the other to identical
    arrays (.safetensors, and .bin); the port's .safetensors files read in
    safetensors.numpy and that package's in the port; ckpt_util and the
    convert_checkpoints CLI's diffusers, export-diffusers and ddim kinds."""
    cfg = junet.tiny_unet_config()
    jmodel = junet.UNet2D(cfg)
    flat = numpy_params(jmodel, seed=5)
    jckpt.save_model(str(tmp_path / "jax"), cfg, unflatten_params(flat))
    tcfg, state = tckpt.load_model(str(tmp_path / "jax"))
    assert tcfg.to_json() == cfg.to_json()
    m = tunet.UNet2D(tcfg, device="cpu")
    m.load_state_dict(state)
    tckpt.save_model(str(tmp_path / "port"), tcfg, m)
    with np.load(tmp_path / "jax" / "unet" / "params.npz") as a, \
            np.load(tmp_path / "port" / "unet" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    cfg = tunet.tiny_unet_config()
    m = tunet.UNet2D(cfg, device="cpu").init(torch.Generator().manual_seed(6))
    tckpt.save_model(str(tmp_path / "fresh"), cfg, m)
    jcfg, jparams = jckpt.load_model(str(tmp_path / "fresh"))
    jmodel = junet.UNet2D(jcfg)
    jmodel.graph.validate(jparams)
    flat = {k: np.asarray(v) for k, v in flatten_params(jparams).items()}
    x = np.random.default_rng(7).standard_normal((2, 16, 16, 3)).astype(np.float32)
    want, got = forward_both(jmodel, m, flat, x, np.array([3, 400], np.int32))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    _check_converters(tmp_path)


def _check_converters(tmp_path):
    """See test_checkpoints_cross_both_ways."""
    import hashlib

    from safetensors.numpy import load_file, save_file

    from _convert_layouts import assert_flat_equal, ddim_state_dict
    from diff_pruning_tpu.cli import ddpm_prune as jprune_cli
    from diff_pruning_tpu.pruning.importance import make_importance
    from diff_pruning_tpu.pruning.pruner import apply_pruning, prune
    from diff_pruning_tpu.utils import ckpt_util as jck
    from diff_pruning_tpu.utils import convert as jconv
    from diff_pruning_tpu_torch.cli import convert_checkpoints
    from diff_pruning_tpu_torch.cli.ddpm_prune import load_unet
    from diff_pruning_tpu_torch.utils import ckpt_util as tck
    from diff_pruning_tpu_torch.utils import convert as tconv

    def jflat(tree):
        return {k: np.asarray(v) for k, v in flatten_params(tree).items()}

    cfg = junet.tiny_unet_config()
    jmodel = junet.UNet2D(cfg)
    flat = numpy_params(jmodel, seed=11)
    tree = unflatten_params(flat)
    # diffusers <-> the port's state dict, and the DDIM codebase's layout
    sd = jconv.params_to_torch_state_dict(tree)
    assert_flat_equal(tconv.params_to_torch_state_dict(tckpt.state_dict_from_flat(flat)), sd,
                      "params_to_torch_state_dict")
    for what, tfn, jfn, src in (
            ("diffusers", tconv.torch_state_dict_to_params, jconv.torch_state_dict_to_params, sd),
            ("ddim", lambda s: tconv.ddim_original_state_dict_to_params(s, 4),
             lambda s: jconv.ddim_original_state_dict_to_params(s, 4), ddim_state_dict(flat, 4))):
        assert_flat_equal(jflat(jfn(src)), flat, what + " (JAX)")
        assert_flat_equal(tckpt.flat_from_state_dict(tfn(src)), flat, what)
        tsrc = {k: torch.from_numpy(v) for k, v in src.items()}  # tensors in, too
        assert_flat_equal(tckpt.flat_from_state_dict(tfn(tsrc)), flat, what + " (tensors)")

    # diffusers directories across the packages, dense and pruned
    res = prune(jmodel.graph, tree, make_importance("magnitude"), sparsity=0.3)
    pruned = jflat(apply_pruning(tree, jmodel.graph, res))
    for name, pcfg, pflat in (("dense", cfg, flat),
                              ("pruned", cfg.with_channel_sizes(res.channel_sizes), pruned)):
        jdir, tdir = str(tmp_path / f"jexp_{name}"), str(tmp_path / f"texp_{name}")
        jconv.export_diffusers_pipeline(jdir, pcfg, unflatten_params(pflat))
        tconv.export_diffusers_pipeline(tdir, tunet.UNet2DConfig.from_json(pcfg.to_json()),
                                        tckpt.state_dict_from_flat(pflat))
        for f in ("model_index.json", "unet/config.json", "scheduler/scheduler_config.json"):
            with open(os.path.join(jdir, f)) as a, open(os.path.join(tdir, f)) as b:
                assert a.read() == b.read(), (name, f)
        st = "unet/diffusion_pytorch_model.safetensors"
        assert_flat_equal(load_file(os.path.join(tdir, st)), load_file(os.path.join(jdir, st)),
                          f"{name} safetensors")
        for d in (jdir, tdir):
            tcfg, state = load_unet(d)
            assert tcfg.channel_sizes == pcfg.channel_sizes, (name, d)
            m = tunet.UNet2D(tcfg, device="cpu")
            m.load_state_dict(state)
            assert_flat_equal(tckpt.flat_from_state_dict(state), pflat, f"{name} port load {d}")
            jcfg, jparams = jprune_cli.load_unet(d)
            assert jcfg.channel_sizes == pcfg.channel_sizes
            assert_flat_equal(jflat(jparams), pflat, f"{name} JAX load {d}")
    # .bin, and safetensors written by safetensors.numpy (several dtypes) in the port
    bdir = tmp_path / "bin_unet"
    bdir.mkdir()
    (bdir / "config.json").write_text(cfg.to_json())
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               bdir / "diffusion_pytorch_model.bin")
    assert_flat_equal(tckpt.flat_from_state_dict(load_unet(str(bdir))[1]), flat, ".bin")
    assert_flat_equal(jflat(jprune_cli.load_unet(str(bdir))[1]), flat, ".bin (JAX)")
    rng = np.random.default_rng(12)
    mixed = {"w": rng.standard_normal((3, 5)).astype(np.float32),
             "h": rng.standard_normal(7).astype(np.float16),
             "d": rng.standard_normal((2, 2)), "i": np.arange(6, dtype=np.int64).reshape(2, 3),
             "u": rng.integers(0, 255, 9, dtype=np.uint8), "s": np.array(2.5, np.float32),
             "e": np.zeros((0, 3), np.float32)}
    save_file(mixed, str(tmp_path / "theirs.safetensors"), metadata={"format": "pt"})
    theirs = tconv._read_safetensors(str(tmp_path / "theirs.safetensors"))
    assert_flat_equal({k: v.numpy() for k, v in theirs.items()}, mixed, "safetensors.numpy file")
    tconv._write_safetensors(str(tmp_path / "ours.safetensors"), mixed, {"format": "pt"})
    assert_flat_equal(load_file(str(tmp_path / "ours.safetensors")), mixed, "port file")
    assert (tmp_path / "ours.safetensors").read_bytes() == \
        (tmp_path / "theirs.safetensors").read_bytes()
    bf = torch.randn(4, 3).to(torch.bfloat16)
    tconv._write_safetensors(str(tmp_path / "bf16.safetensors"), {"b": bf})
    assert torch.equal(tconv._read_safetensors(str(tmp_path / "bf16.safetensors"))["b"], bf)

    # ckpt_util: the same names, layout and MD5 checks as the JAX one's
    assert tck.CKPT_MAP == jck.CKPT_MAP and tck.MD5_MAP == jck.MD5_MAP
    root = tmp_path / "cache"
    rel = tck.CKPT_MAP["ema_lsun_church"]
    with pytest.raises(FileNotFoundError, match="diff_pruning_tpu_torch.cli.convert_checkpoints"):
        tck.get_ckpt_path("ema_lsun_church_outdoor", root=str(root))
    with pytest.raises(KeyError):
        tck.get_ckpt_path("imagenet", root=str(root))
    (root / rel).parent.mkdir(parents=True)
    (root / rel).write_bytes(b"not the checkpoint")
    assert tck.md5_hash(str(root / rel)) == jck.md5_hash(str(root / rel)) == \
        hashlib.md5(b"not the checkpoint").hexdigest()
    assert tck.get_ckpt_path("ema_lsun_church", root=str(root)) == \
        jck.get_ckpt_path("ema_lsun_church", root=str(root)) == str(root / rel)
    with pytest.raises(ValueError, match="MD5"):
        tck.get_ckpt_path("ema_lsun_church_outdoor", root=str(root), check=True)

    # the CLI's kinds: a diffusers dir -> our layout -> a diffusers dir, and a
    # DDIM-codebase checkpoint of the full-width CIFAR-10 UNet
    out = convert_checkpoints.main(["diffusers", str(tmp_path / "jexp_pruned"),
                                    str(tmp_path / "conv")])
    tcfg, state = tckpt.load_model(str(tmp_path / "conv"))
    assert out.endswith("unet") and tcfg.channel_sizes == res.channel_sizes
    assert_flat_equal(tckpt.flat_from_state_dict(state), pruned, "CLI diffusers")
    convert_checkpoints.main(["export-diffusers", str(tmp_path / "conv"),
                              str(tmp_path / "reexp"), "--scheduler", "DDIMScheduler"])
    assert_flat_equal(jflat(jprune_cli.load_unet(str(tmp_path / "reexp"))[1]), pruned,
                      "CLI export-diffusers")
    full = junet.ddpm_cifar10_config()
    fflat = {k: np.random.default_rng(13).standard_normal(s.shape).astype(np.float32)
             for k, s in flatten_params(jax.eval_shape(junet.UNet2D(full).init,
                                                       jax.random.key(0))).items()}
    torch.save({"module." + k: torch.from_numpy(v) for k, v in ddim_state_dict(fflat, 4).items()},
               tmp_path / "ddim.pth")
    convert_checkpoints.main(["ddim", str(tmp_path / "ddim.pth"), str(tmp_path / "ddim_out"),
                              "--config", "cifar10"])
    jcfg, jparams = jckpt.load_model(str(tmp_path / "ddim_out"))
    assert jcfg.to_json() == full.to_json()
    assert_flat_equal(jflat(jparams), fflat, "CLI ddim")
    with pytest.raises(ValueError, match="does not fit"):
        convert_checkpoints.main(["ddim", str(tmp_path / "ddim.pth"), str(tmp_path / "bad"),
                                  "--config", "celeba"])


def test_jax_pruned_checkpoint_forward(tmp_path):
    """A checkpoint pruned by the JAX package (odd channels per group, odd
    attention width) loads here and gives the JAX forward."""
    from diff_pruning_tpu.pruning.importance import make_importance
    from diff_pruning_tpu.pruning.pruner import apply_pruning, prune

    cfg = junet.tiny_unet_config()
    jmodel = junet.UNet2D(cfg)
    params = unflatten_params({k: jnp.asarray(v)
                               for k, v in numpy_params(jmodel, seed=8).items()})
    res = prune(jmodel.graph, params, make_importance("magnitude"), sparsity=0.3)
    pcfg = cfg.with_channel_sizes(res.channel_sizes)
    pruned = apply_pruning(params, jmodel.graph, res)
    jckpt.save_model(str(tmp_path), pcfg, pruned)
    tcfg, state = tckpt.load_model(str(tmp_path))
    assert tcfg.channel_sizes == res.channel_sizes
    tmodel = tunet.UNet2D(tcfg, device="cpu")
    tmodel.load_state_dict(state)
    jp = junet.UNet2D(pcfg)
    flat = {k: np.asarray(v) for k, v in flatten_params(pruned).items()}
    x = np.random.default_rng(9).standard_normal((2, 16, 16, 3)).astype(np.float32)
    want, got = forward_both(jp, tmodel.eval(), flat, x, np.array([11, 650], np.int32))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
