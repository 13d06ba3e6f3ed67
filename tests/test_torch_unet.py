"""The port's UNet, channel graph and weight bridge against the JAX package.

Parameters are made with numpy from a seed and handed to both packages
through the flat ``a/b/kernel`` layout; JAX runs with f32 matmuls.

Tolerance for UNet outputs (f32, both on the CPU): atol = rtol = 5e-5. The
two packages sum in different orders through ~60 layers of convolutions,
norms and attention, which moves outputs of order 1 by a few 1e-6 (5e-6 at
full CIFAR width).
"""

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


def test_graph_matches_jax():
    for config in ("tiny_unet_config", "ddpm_cifar10_config"):
        jg = junet.UNet2D(getattr(junet, config)()).graph
        tg = tunet.UNet2D(getattr(tunet, config)(), device="meta").graph
        assert _graph_signature(tg) == _graph_signature(jg), config


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
    validates against its graph and gives the same forward."""
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
