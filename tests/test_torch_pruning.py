"""The port's pruning slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the JAX
side runs with f32 matmuls. Each tolerance is stated where it is used:

- sweep losses: rtol 1e-5, the two packages' f32 forwards differ in summation
  order only (a few 1e-6 relative, tests/test_torch_unet.py);
- sweep grads: |port - jax| <= 1e-4 * max|jax| per parameter, plus a floor
  of 1e-6 of the largest grad of all for parameters whose true grad is zero
  (to_k's bias: the softmax is invariant to it), which carry only f32
  noise; Diff-Pruning scores from the port's own grads within rtol 1e-3 of
  the JAX scores. Both are the same f32 sum-order differences carried
  through the backward;
- everything that is integer or selection (steps run, keep-indices, channel
  sizes, MACs, params, data batches): exactly equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diff_pruning_tpu.models import unet2d as junet
from diff_pruning_tpu.pruning import importance as jimp
from diff_pruning_tpu.pruning import pruner as jpruner
from diff_pruning_tpu.pruning.surgery import flatten_params as jflatten
from diff_pruning_tpu.pruning.surgery import unflatten_params as junflatten
from diff_pruning_tpu_torch.models import unet2d as tunet
from diff_pruning_tpu_torch.pruning import importance as timp
from diff_pruning_tpu_torch.pruning import pruner as tpruner
from diff_pruning_tpu_torch.pruning.surgery import flatten_params, unflatten_params
from diff_pruning_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRUNERS = ["taylor", "diff-pruning", "random", "magnitude", "reinit", "fisher",
           "first_order_taylor", "second_order_taylor"]
# CIFAR UNet params after local pruning at ratio 0.3 (any scores: in local
# mode the kept sizes depend only on the ratio and each var's constraints)
CIFAR_PRUNED_PARAMS_AT_0_3 = 19_951_049


def numpy_params(jmodel, seed):
    """Flat JAX-layout params with torch-like init scales and non-trivial norms."""
    rng = np.random.default_rng(seed)
    shapes = jflatten(jax.eval_shape(jmodel.init, jax.random.key(0)))
    flat = {}
    for path, s in shapes.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            a = rng.uniform(-1.0, 1.0, s.shape) * np.sqrt(3.0 / np.prod(s.shape[:-1]))
        elif leaf == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        flat[path] = a.astype(np.float32)
    return flat


def test_port_imports_nothing_of_jax():
    """Every module of the port imports with ``jax`` and the JAX package
    blocked (a blocked import raises), and none pulls either in."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('jax', 'diff_pruning_tpu', 'triton'):\n"
        "    sys.modules[m] = None\n"
        "import diff_pruning_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       (m.split('.')[0] in ('jax', 'diff_pruning_tpu'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("CUDA")}
    env.update(CUDA_HOME="/nonexistent", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 43


def _tiny_sweep_inputs():
    cfg = junet.tiny_unet_config()
    jmodel = junet.UNet2D(cfg)
    flat = numpy_params(jmodel, seed=11)
    rng = np.random.default_rng(12)
    x0 = rng.uniform(-1.0, 1.0, (2, 16, 16, 3)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    tmodel = tunet.UNet2D(tunet.UNet2DConfig.from_json(cfg.to_json()), device="cpu")
    tmodel.load_state_dict(tckpt.state_dict_from_flat(flat))
    return jmodel, tmodel, flat, x0, noise


@pytest.mark.parametrize("stop", ["max_steps", "thr", "abs"])
def test_sweep_matches_jax(stop):
    """accumulate_taylor_grads against the JAX host-loop variant on the same
    x0 and noise: the same steps run (at max_steps, at a thr where JAX exits
    early, and accumulating |grad|), losses and flat grads within tolerance,
    and Diff-Pruning scores from each package's own grads within tolerance."""
    from diff_pruning_tpu.diffpruning.sweep import accumulate_taylor_grads as jsweep
    from diff_pruning_tpu.schedulers.ddpm import DiffusionSchedule as JaxSchedule
    from diff_pruning_tpu_torch.diffpruning.sweep import accumulate_taylor_grads
    from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule

    jmodel, tmodel, flat, x0, noise = _tiny_sweep_inputs()
    thr, max_steps = (0.999, 8) if stop == "thr" else (None, 3)
    kw = dict(thr=thr, max_steps=max_steps, accumulate_abs=stop == "abs")
    jparams = junflatten({k: jnp.asarray(v) for k, v in flat.items()})
    with jax.default_matmul_precision("float32"):
        want = jsweep(jmodel, jparams, JaxSchedule.create(), jnp.asarray(x0),
                      jnp.asarray(noise), **kw)
    got = accumulate_taylor_grads(tmodel, DiffusionSchedule.create(), torch.from_numpy(x0),
                                  torch.from_numpy(noise), **kw)
    if stop == "thr":
        assert want.steps_run < max_steps  # JAX exits early here
    assert got.steps_run == want.steps_run
    np.testing.assert_allclose(got.losses, np.asarray(want.losses), rtol=1e-5)
    jgrads = {k: np.asarray(v) for k, v in jflatten(want.grads).items()}
    tgrads = tckpt.flat_grads(tmodel)
    assert sorted(tgrads) == sorted(jgrads)
    floor = 1e-6 * max(np.abs(g).max() for g in jgrads.values())
    for k, g in jgrads.items():
        err = np.abs(tgrads[k] - g).max()
        assert err <= 1e-4 * np.abs(g).max() + floor, (k, err)
    graph = tmodel.graph
    params = unflatten_params(flat)
    imp = timp.make_importance("diff-pruning")
    for v in graph.prunable_vars():
        mine = imp(graph, params, v, grads=unflatten_params(tgrads))
        theirs = imp(graph, params, v, grads=unflatten_params(jgrads))
        np.testing.assert_allclose(mine, theirs, rtol=1e-3, atol=1e-12, err_msg=v.name)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_keep_indices_match_jax(mode):
    """The same flat params and grads give identical scores, keep-indices,
    channel sizes and sliced params in both packages, for every pruner."""
    cfg = junet.tiny_unet_config()
    jmodel = junet.UNet2D(cfg)
    tgraph = tunet.UNet2D(tunet.tiny_unet_config(), device="meta").graph
    flat = numpy_params(jmodel, seed=13)
    rng = np.random.default_rng(14)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()}
    params, tgrads = unflatten_params(flat), unflatten_params(grads)
    jparams = junflatten({k: jnp.asarray(v) for k, v in flat.items()})
    jgrads = junflatten({k: jnp.asarray(v) for k, v in grads.items()})
    kw = dict(sparsity=0.3, global_pruning=mode == "global")
    for name in PRUNERS:
        want = jpruner.prune(jmodel.graph, jparams, jimp.make_importance(name, seed=3),
                             grads=jgrads, **kw)
        got = tpruner.prune(tgraph, params, timp.make_importance(name, seed=3),
                            grads=tgrads, **kw)
        assert got.channel_sizes == want.channel_sizes, name
        assert sorted(got.keep) == sorted(want.keep), name
        for var, idx in want.keep.items():
            np.testing.assert_array_equal(got.keep[var], idx, err_msg=f"{name} {var}")
        for var, s in want.scores.items():
            np.testing.assert_array_equal(got.scores[var], s, err_msg=f"{name} {var}")
    sliced = flatten_params(tpruner.apply_pruning(params, tgraph, got))
    jsliced = jflatten(jpruner.apply_pruning(jparams, jmodel.graph, want))
    for k, v in jsliced.items():
        np.testing.assert_array_equal(sliced[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("config", ["tiny_unet_config", "ddpm_cifar10_config"])
def test_macs_and_params_match_jax(config):
    from diff_pruning_tpu.pruning.flops import count_ops_and_params as jcount
    from diff_pruning_tpu_torch.pruning.flops import count_ops_and_params

    jmodel = junet.UNet2D(getattr(junet, config)())
    tmodel = tunet.UNet2D(getattr(tunet, config)(), device="cpu")
    hw = tmodel.cfg.sample_size
    jparams = jax.eval_shape(jmodel.init, jax.random.key(0))
    assert count_ops_and_params(tmodel, (1, hw, hw, 3)) == jcount(
        jmodel, jparams, (1, hw, hw, 3))
    if config == "ddpm_cifar10_config":
        assert count_ops_and_params(tmodel) == (6_053_953_536, 35_746_307)
        # the pruned size at ratio 0.3, from the JAX package's own pruner
        flat = {k: np.zeros(s.shape, np.float32) for k, s in jflatten(jparams).items()}
        res = jpruner.prune(jmodel.graph, junflatten(flat), jimp.make_importance("magnitude"),
                            sparsity=0.3)
        pcfg = tmodel.cfg.with_channel_sizes(res.channel_sizes)
        pruned = tunet.UNet2D(pcfg, device="meta")
        assert sum(p.numel() for p in pruned.parameters()) == CIFAR_PRUNED_PARAMS_AT_0_3


def test_data_batches_match_jax(tmp_path):
    """load_npz, the CIFAR-10 pickle-batch loader and the first batches of
    iterate_batches are bit-identical to the JAX package's."""
    import pickle

    from diff_pruning_tpu.data import datasets as jdata
    from diff_pruning_tpu_torch.data import datasets as tdata

    rng = np.random.default_rng(15)
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    for i in (1, 2):
        data = rng.integers(0, 256, (10, 3 * 32 * 32), dtype=np.uint8)
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump({"data": data, "labels": [0] * 10}, f)
    np.savez(tmp_path / "x.npz", images=rng.integers(0, 256, (9, 8, 8, 3), dtype=np.uint8))
    for src in (str(tmp_path), str(tmp_path / "x.npz")):
        tds, jds = tdata.get_dataset(src), jdata.get_dataset(src)
        np.testing.assert_array_equal(tds.images, jds.images)
        for seed in (0, 5):
            tb = tdata.iterate_batches(tds, 4, seed=seed)
            jb = jdata.iterate_batches(jds, 4, seed=seed)
            for _ in range(3):  # crosses an epoch boundary on the npz
                a, b = next(tb), next(jb)
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)


def test_prune_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """The prune CLI end to end on the tiny config: TF32 pinned off, a
    checkpoint that both packages load, the JAX CLI's report lines, the vis
    grid; the options it does not port raise, and --device cuda without a
    GPU raises."""
    from diff_pruning_tpu.utils import checkpoint as jckpt
    from diff_pruning_tpu_torch.cli import ddpm_prune

    cfg = tunet.tiny_unet_config()
    model = tunet.UNet2D(cfg, device="cpu").init(torch.Generator().manual_seed(16))
    tckpt.save_model(str(tmp_path / "dense"), cfg, model)
    data = np.random.default_rng(17).integers(0, 256, (8, 16, 16, 3), dtype=np.uint8)
    np.savez(tmp_path / "data.npz", images=data)
    out = tmp_path / "pruned"
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    base = ["--model_path", str(tmp_path / "dense"), "--save_path", str(out),
            "--dataset", str(tmp_path / "data.npz"), "--batch_size", "4"]
    stats = ddpm_prune.main(base + ["--pruner", "diff-pruning", "--pruning_ratio", "0.3",
                                    "--thr", "0.05", "--max_steps", "3", "--host_loop",
                                    "--device", "cpu"])
    text = capsys.readouterr().out
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert "torch.backends.cudnn.allow_tf32=False" in text
    assert "#Params: 1.0029 M =>" in text and "#MACS:" in text
    assert stats["steps_run"] == 3 and stats["params"] < stats["params_before"]
    assert (out / "vis" / "after_pruning.png").is_file()
    jcfg, jparams = jckpt.load_model(str(out))
    junet.UNet2D(jcfg).graph.validate(jparams)
    tcfg, state = tckpt.load_model(str(out))
    assert tcfg.channel_sizes == stats["channel_sizes"] == jcfg.channel_sizes
    pruned = tunet.UNet2D(tcfg, device="cpu")
    pruned.load_state_dict(state)
    assert sum(p.numel() for p in pruned.parameters()) == stats["params"]
    with pytest.raises(NotImplementedError, match="item 6"):
        ddpm_prune.main(base + ["--global_pruning", "--cost_aware", "bytes", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ddpm_prune.main(base + ["--pruner", "magnitude"])
