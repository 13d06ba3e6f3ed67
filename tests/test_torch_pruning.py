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
  sizes, MACs, params, per-channel cost weights, data batches): exactly
  equal.
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
    """Every module of the port imports with ``jax``, the JAX package,
    ``triton``, ``matplotlib``, ``regex`` (which the JAX CLIP tokenizer
    needs and the card's machine lacks), ``safetensors``, ``lmdb`` and
    ``yaml`` (which the checkpoint and data modules must not need there)
    blocked (a blocked import raises) and
    no ``nvcc`` (CUDA_HOME points nowhere), none pulls jax or the JAX package
    in, and the CLIs parse their arguments so, the five data-parallel ones
    with the multihost flags (``parallel/mesh.py``, ``cli/_multihost.py``
    and the checkpoint-conversion and data modules among them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('jax', 'diff_pruning_tpu', 'triton', 'matplotlib', 'regex', 'safetensors',\n"
        "          'lmdb', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import diff_pruning_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'diff_pruning_tpu_torch.parallel.mesh',\n"
        "        'diff_pruning_tpu_torch.cli._multihost',\n"
        "        'diff_pruning_tpu_torch.utils.convert', 'diff_pruning_tpu_torch.utils.ckpt_util',\n"
        "        'diff_pruning_tpu_torch.data.lmdb_io', 'diff_pruning_tpu_torch.data.ldm_datasets',\n"
        "        'diff_pruning_tpu_torch.cli.convert_checkpoints',\n"
        "        'diff_pruning_tpu_torch.cli.make_lsun_lmdb'} <= set(names)\n"
        "from diff_pruning_tpu_torch.cli import (autoencoder_train, compute_ssim, ddpm_sample,\n"
        "                                        ldm_prune, ldm_sample, ldm_train,\n"
        "                                        prune_finetune, prune_ssim)\n"
        "autoencoder_train.parse_args(['--dataset', 'd', '--output_dir', 'o'])\n"
        "for cli in (ddpm_sample, ldm_sample):\n"
        "    cli.parse_args(['--model_path', 'm', '--output_dir', 'o'])\n"
        "ldm_prune.parse_args(['--save_path', 'o'])\n"
        "for cli in (ldm_train, prune_finetune):\n"
        "    cli.parse_args(['--model_path', 'm', '--dataset', 'd', '--output_dir', 'o'])\n"
        "prune_ssim.parse_args(['--model_path', 'm', '--save_path', 'o', '--dataset', 'd'])\n"
        "from diff_pruning_tpu_torch.cli import ddpm_prune, ddpm_train\n"
        "mh = ['--multihost', '--coordinator_address', 'h:1', '--num_processes', '2',\n"
        "      '--process_id', '1']\n"
        "for cli, argv in ((ddpm_train, ['--dataset', 'd', '--model_path', 'm',\n"
        "                                '--output_dir', 'o']),\n"
        "                  (ddpm_prune, ['--model_path', 'm', '--save_path', 'o']),\n"
        "                  (ddpm_sample, ['--model_path', 'm', '--output_dir', 'o']),\n"
        "                  (ldm_sample, ['--model_path', 'm', '--output_dir', 'o']),\n"
        "                  (ldm_train, ['--model_path', 'm', '--dataset', 'd',\n"
        "                               '--output_dir', 'o'])):\n"
        "    a = cli.parse_args(argv + mh)\n"
        "    assert a.multihost and a.num_processes == 2 and a.process_id == 1, cli\n"
        "compute_ssim.parse_args(['a', 'b'])\n"
        "from diff_pruning_tpu_torch.data import datasets\n"
        "datasets.get_dataset('txt:' + datasets.__file__ + ':.', 8)  # a txt list: no yaml\n"
        "from diff_pruning_tpu_torch.cli import inpaint, knn2img, train_searcher, txt2img\n"
        "txt2img.parse_args(['--vocab', 'v'])\n"
        "inpaint.parse_args(['--indir', 'i', '--outdir', 'o', '--model_path', 'm'])\n"
        "train_searcher.parse_args(['--images', 'i', '--target_path', 't'])\n"
        "knn2img.parse_args(['--outdir', 'o', '--model_path', 'm', '--bpe', 'b',\n"
        "                    '--use_neighbors', '--database', 'd'])\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       (m.split('.')[0] in ('jax', 'diff_pruning_tpu'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("CUDA")}
    env.update(CUDA_HOME="/nonexistent", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 82


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


def _check_data_parallel_sweep(tmp_path, flat, x0, noise, one, jmodel, kw):
    """The sweep over 2 gloo ranks (``mesh``; the batch of 2 split by rows)
    against the one-process sweep ``one`` (the port's grads as flat numpy)
    and the JAX ``accumulate_taylor_grads_scan(mesh=)`` on 2 of the suite's
    virtual devices: the same steps run, losses rtol 1e-5 and grads within
    the sweep's rule (1e-4 of each max, the f32 floor) against JAX; against
    one process, losses rtol 1e-6 and grads within 1e-5 of each max (a mean
    of two row means against one mean)."""
    import json

    import _torch_dp
    from diff_pruning_tpu.diffpruning.sweep import accumulate_taylor_grads_scan
    from diff_pruning_tpu.parallel.mesh import make_mesh
    from diff_pruning_tpu.schedulers.ddpm import DiffusionSchedule as JaxSchedule

    in_dir, out_dir = tmp_path / "dp_in", tmp_path / "dp_out"
    out_dir.mkdir()
    cfg = tunet.UNet2DConfig.from_json(junet.tiny_unet_config().to_json())
    model = tunet.UNet2D(cfg, device="cpu")
    model.load_state_dict(tckpt.state_dict_from_flat(flat))
    tckpt.save_model(str(in_dir), cfg, model)
    np.savez(in_dir / "inputs.npz", x0=x0, noise=noise)
    (in_dir / "kwargs.json").write_text(json.dumps(kw))
    ranks = _torch_dp.lib_ranks("sweep", in_dir, out_dir)
    for k, v in ranks[0].items():  # every rank ends with the same grads
        np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)
    grads = {k.split(":", 1)[1]: v for k, v in ranks[0].items() if k.startswith("grad:")}
    with jax.default_matmul_precision("float32"):
        mesh = make_mesh((("data", 2),), devices=jax.devices()[:2])
        want = accumulate_taylor_grads_scan(
            jmodel, junflatten({k: jnp.asarray(v) for k, v in flat.items()}),
            JaxSchedule.create(), jnp.asarray(x0), jnp.asarray(noise), mesh=mesh, **kw)
    assert int(ranks[0]["steps_run"]) == one["steps_run"] == want.steps_run
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["losses"], np.asarray(want.losses)[:want.steps_run],
                               rtol=1e-5)
    for ref, rtol in ((one["grads"], 1e-5),
                      ({k: np.asarray(v) for k, v in jflatten(want.grads).items()}, 1e-4)):
        assert sorted(grads) == sorted(ref)
        floor = 1e-6 * max(np.abs(g).max() for g in ref.values())
        for k, g in ref.items():
            err = np.abs(grads[k] - g).max()
            assert err <= rtol * np.abs(g).max() + floor, (k, err)


@pytest.mark.parametrize("stop", ["max_steps", "thr", "abs"])
def test_sweep_matches_jax(stop, tmp_path):
    """accumulate_taylor_grads against the JAX host-loop variant on the same
    x0 and noise: the same steps run (at max_steps, at a thr where JAX exits
    early, and accumulating |grad|), losses and flat grads within tolerance,
    and Diff-Pruning scores from each package's own grads within tolerance.
    ``thr``: also data-parallel over 2 gloo ranks, against one process and
    the JAX 2-device mesh; ``abs``: a mesh with ``accumulate_abs`` raises."""
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
    if stop == "thr":
        _check_data_parallel_sweep(tmp_path, flat, x0, noise, {
            "steps_run": got.steps_run, "losses": got.losses, "grads": tgrads}, jmodel,
            {"thr": thr, "max_steps": max_steps})
    elif stop == "abs":
        from diff_pruning_tpu_torch.parallel.mesh import DataMesh

        with pytest.raises(ValueError, match="accumulate_abs"):
            accumulate_taylor_grads(tmodel, DiffusionSchedule.create(), torch.from_numpy(x0),
                                    torch.from_numpy(noise), mesh=DataMesh(2, 0, "cpu"), **kw)


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
    if mode == "global":
        # cost-aware: each package's own cost weights (equal, as
        # test_macs_and_params_match_jax holds them), under the 0.75 cap
        from diff_pruning_tpu.pruning.cost import var_cost_weights as jcost
        from diff_pruning_tpu_torch.pruning.cost import var_cost_weights

        shape = (8, 16, 16, 3)
        tcw = var_cost_weights(tunet.UNet2D(tunet.tiny_unet_config(), device="meta"), shape)
        jcw = jcost(jmodel, jparams, shape)
        assert tcw == jcw
        kw.update(max_sparsity=0.75)
        for name in PRUNERS:
            want = jpruner.prune(jmodel.graph, jparams, jimp.make_importance(name, seed=3),
                                 grads=jgrads, cost_weights=jcw, **kw)
            got = tpruner.prune(tgraph, params, timp.make_importance(name, seed=3),
                                grads=tgrads, cost_weights=tcw, **kw)
            assert got.channel_sizes == want.channel_sizes, name
            assert sorted(got.keep) == sorted(want.keep), name
            for var, idx in want.keep.items():
                np.testing.assert_array_equal(got.keep[var], idx, err_msg=f"{name} {var} cost")


@pytest.mark.parametrize("config", ["tiny_unet_config", "ddpm_cifar10_config"])
def test_macs_and_params_match_jax(config, monkeypatch):
    """MACs and params, and the per-channel cost weights of every mode
    (pruning/cost.py), equal the JAX package's; the hybrid mode's
    FLOP-per-byte ratio is the H100's in the port and the TPU's in the JAX
    package, so it is compared with the port's set to the JAX one."""
    from diff_pruning_tpu.pruning.cost import var_cost_weights as jcost
    from diff_pruning_tpu.pruning.flops import count_ops_and_params as jcount
    from diff_pruning_tpu_torch.pruning import cost as tcost
    from diff_pruning_tpu_torch.pruning.flops import count_ops_and_params

    jmodel = junet.UNet2D(getattr(junet, config)())
    tmodel = tunet.UNet2D(getattr(tunet, config)(), device="cpu")
    hw = tmodel.cfg.sample_size
    jparams = jax.eval_shape(jmodel.init, jax.random.key(0))
    assert count_ops_and_params(tmodel, (1, hw, hw, 3)) == jcount(
        jmodel, jparams, (1, hw, hw, 3))
    assert tcost.H100_FLOP_PER_BYTE == 989e12 / 3.35e12
    for shape in ((1, hw, hw, 3), (128, hw, hw, 3)):
        for mode, dtype_bytes in (("macs", 2), ("bytes", 2), ("bytes", 4)):
            got = tcost.var_cost_weights(tmodel, shape, mode=mode, dtype_bytes=dtype_bytes)
            assert got == jcost(jmodel, jparams, shape, mode=mode, dtype_bytes=dtype_bytes)
            assert len(got) == len(tmodel.graph.prunable_vars()), (shape, mode)
        with monkeypatch.context() as m:
            m.setattr(tcost, "H100_FLOP_PER_BYTE", 240.0)
            assert tcost.var_cost_weights(tmodel, shape, mode="hybrid") == jcost(
                jmodel, jparams, shape, mode="hybrid")
    with pytest.raises(ValueError, match="unknown cost mode"):
        tcost.var_cost_weights(tmodel, mode="flops")
    if config == "ddpm_cifar10_config":
        assert count_ops_and_params(tmodel) == (6_053_953_536, 35_746_307)
        # the pruned size at ratio 0.3, from the JAX package's own pruner
        flat = {k: np.zeros(s.shape, np.float32) for k, s in jflatten(jparams).items()}
        res = jpruner.prune(jmodel.graph, junflatten(flat), jimp.make_importance("magnitude"),
                            sparsity=0.3)
        pcfg = tmodel.cfg.with_channel_sizes(res.channel_sizes)
        pruned = tunet.UNet2D(pcfg, device="meta")
        assert sum(p.numel() for p in pruned.parameters()) == CIFAR_PRUNED_PARAMS_AT_0_3


def test_data_batches_match_jax(tmp_path, monkeypatch):
    """load_npz, the CIFAR-10 pickle-batch loader and the first batches of
    iterate_batches are bit-identical to the JAX package's, over arrays and
    over image folders (resized ones against its PIL decode), and so are a
    data-parallel rank's rows (``local_slice``); 'cifar10' and 'cifar100'
    are looked up where the JAX package looks (here ~/data/cifar10 and
    ~/data/cifar100). The lmdb reader and writer match the JAX ones byte
    for byte both ways (branch levels and overflow pages included), and
    the lsun:, ffhq:, lmdb-directory, CIFAR-100, imagenet: and txt: sources
    give the JAX package's uint8 images and batches exactly; the input
    transforms (logit, dequantization, their inverse, and through
    iterate_batches with a skip and a rank's rows) agree within 1e-6."""
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
            # a data-parallel rank's rows (the JAX multi-host path's)
            tl = tdata.iterate_batches(tds, 4, seed=seed, local_slice=(2, 4))
            jl = jdata.iterate_batches(jds, 4, seed=seed, local_slice=(2, 4))
            for _ in range(3):  # crosses an epoch boundary on the npz
                a, b = next(tb), next(jb)
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
                la = next(tl)
                np.testing.assert_array_equal(la, next(jl))
                np.testing.assert_array_equal(la, b[2:4])
    home = tmp_path / "home"
    (home / "data").mkdir(parents=True)
    os.rename(d, home / "data" / "cifar10")
    (tmp_path / "cwd").mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.chdir(tmp_path / "cwd")
    np.testing.assert_array_equal(tdata.get_dataset("cifar10").images,
                                  jdata.get_dataset("cifar10").images)
    _check_other_sources(tmp_path, home, rng)

    # image-folder batches (the autoencoder trainer's): bit-identical to the
    # JAX package's at the stored size, also after a skip for resume;
    # resized, to its PIL ``load`` under the same draws (its native decoder
    # resizes with another filter)
    from PIL import Image

    folder = tmp_path / "folder"
    (folder / "sub").mkdir(parents=True)
    for i in range(7):
        Image.fromarray(rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)).save(
            folder / ("sub" if i % 2 else "") / f"{i}.png")
    tds, jds = tdata.get_dataset(str(folder), 12), jdata.get_dataset(str(folder), 12)
    assert tds.files == jds.files and len(tds) == 7
    for skip in (0, 3):
        tb = tdata.iterate_batches(tds, 3, seed=4, skip_batches=skip)
        jb = jdata.iterate_batches(jds, 3, seed=4, skip_batches=skip)
        tl = tdata.iterate_batches(tds, 3, seed=4, skip_batches=skip, local_slice=(1, 2))
        for _ in range(4):  # two epochs of two batches
            want = next(jb)
            np.testing.assert_array_equal(next(tb), want)
            np.testing.assert_array_equal(next(tl), want[1:2])
    rds, jrds = tdata.get_dataset(str(folder), 8), jdata.get_dataset(str(folder), 8)
    drng = np.random.default_rng(4)
    batches = tdata.iterate_batches(rds, 3, seed=4, skip_batches=1)
    for i in range(3):
        order = drng.permutation(7) if i % 2 == 0 else order
        idx = order[3 * (i % 2):3 * (i % 2) + 3]
        flips = drng.random(3) < 0.5
        want = np.stack([jrds.load(j) for j in idx])
        want[flips] = want[flips, :, ::-1]
        if i:
            np.testing.assert_array_equal(next(batches), jdata.normalize(want))


def _check_other_sources(tmp_path, home, rng):
    """The lmdb files, the lsun:, ffhq:, lmdb-directory, CIFAR-100, imagenet:
    and txt: sources and the input transforms against the JAX package (see
    test_data_batches_match_jax)."""
    import io
    import pickle

    from PIL import Image

    from diff_pruning_tpu.data import datasets as jdata
    from diff_pruning_tpu.data import lmdb_io as jlmdb
    from diff_pruning_tpu_torch.data import datasets as tdata
    from diff_pruning_tpu_torch.data import lmdb_io as tlmdb

    # lmdb files both ways: 300 small values (two branch levels over the
    # leaves) and big ones on overflow pages
    items = [(f"{i:05d}".encode(), rng.bytes(int(rng.integers(1, 60)))) for i in range(300)]
    items += [(b"big-%d" % i, rng.bytes(5000 + 3000 * i)) for i in range(3)]
    for writer, reader, name in ((jlmdb.write_lmdb, tlmdb.LMDBReader, "jax_written"),
                                 (tlmdb.write_lmdb, jlmdb.LMDBReader, "port_written")):
        writer(str(tmp_path / name), items)
        with reader(str(tmp_path / name)) as db:
            assert len(db) == len(items) and db.depth >= 2
            assert list(db.items()) == sorted(items)
            assert db.keys() == sorted(k for k, _ in items)
            assert all(db.get(k) == v for k, v in items) and db.get(b"absent") is None
    with tlmdb.LMDBReader(str(tmp_path / "jax_written")) as db:  # the key scan reads no value
        db._leaf_value = None
        assert db.keys() == sorted(k for k, _ in items)
    assert (tmp_path / "jax_written" / "data.mdb").read_bytes() == \
        (tmp_path / "port_written" / "data.mdb").read_bytes()

    def encoded(arr, fmt):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt, **({"lossless": True} if fmt == "WEBP" else {}))
        return buf.getvalue()

    # LSUN: webp images of several aspect ratios under md5 keys, read through
    # the lsun: prefix and as a bare lmdb directory, resized and cropped
    shapes = [(20, 31), (33, 18), (24, 24), (17, 40), (40, 26), (21, 21), (30, 19)]
    lsun = [(f"{i:032x}".encode(), encoded(rng.integers(0, 256, s + (3,), dtype=np.uint8), "WEBP"))
            for i, s in enumerate(shapes)]
    jlmdb.write_lmdb(str(tmp_path / "lsun_db"), lsun)
    ffhq = [(b"length", b"6")] + [(f"16-{i:05d}".encode(), encoded(
        rng.integers(0, 256, (16, 16, 3), dtype=np.uint8), "PNG")) for i in range(6)]
    tlmdb.write_lmdb(str(tmp_path / "ffhq_db"), ffhq)
    c100 = home / "data" / "cifar100" / "cifar-100-python"
    c100.mkdir(parents=True)
    with open(c100 / "train", "wb") as f:
        pickle.dump({"data": rng.integers(0, 256, (9, 3 * 32 * 32), dtype=np.uint8),
                     "fine_labels": [0] * 9}, f)
    inet = tmp_path / "imagenet"
    for i, syn in enumerate(("n01", "n01", "n02", "n03", "n03", "n03")):
        (inet / "data" / syn).mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (18 + 3 * i, 25, 3), dtype=np.uint8)).save(
            inet / "data" / syn / f"{syn}_{i}.JPEG")
    (tmp_path / "txtroot").mkdir()
    names = []
    for i in range(5):
        names.append(f"im{i}.png")
        Image.fromarray(rng.integers(0, 256, (22, 14 + 4 * i, 3), dtype=np.uint8)).save(
            tmp_path / "txtroot" / names[-1])
    (tmp_path / "list.txt").write_text("\n".join(names) + "\n")
    sources = [("lsun:" + str(tmp_path / "lsun_db"), 16), (str(tmp_path / "lsun_db"), 12),
               ("ffhq:" + str(tmp_path / "ffhq_db"), 16), ("cifar100", None),
               (str(home / "data" / "cifar100"), None), ("imagenet:" + str(inet), 16),
               ("txt:" + str(tmp_path / "list.txt") + ":" + str(tmp_path / "txtroot"), 12)]
    for src, res in sources:
        tds = tdata.get_dataset(src, res)
        jds = jdata.get_dataset(src, res)
        assert type(tds).__name__ == type(jds).__name__ and len(tds) == len(jds), src
        if hasattr(jds, "images"):
            np.testing.assert_array_equal(tds.images, jds.images, err_msg=src)
        else:
            for i in range(len(jds)):
                a, b = tds.load(i), jds.load(i)
                assert a.dtype == b.dtype == np.uint8, src
                np.testing.assert_array_equal(a, b, err_msg=f"{src} {i}")
        if src.startswith("imagenet:"):
            assert tds.class_labels == jds.class_labels == [0, 0, 1, 2, 2, 2]
        tb, jb = tdata.iterate_batches(tds, 3, seed=2), jdata.iterate_batches(jds, 3, seed=2)
        for _ in range(3):
            np.testing.assert_array_equal(next(tb), next(jb), err_msg=src)

    # the input transforms, alone and through iterate_batches
    x01 = rng.random((4, 8, 8, 3)).astype(np.float32)
    x01[0, 0, 0] = (0.0, 1.0, 0.5)
    for name in ("", "rescaled", "logit", "logit+udq", "rescaled+gdq", "udq+gdq", "logit+udq+gdq"):
        kw = tdata._parse_transform(name)
        assert kw == jdata._parse_transform(name), name
        got = tdata.data_transform(x01, rng=np.random.default_rng(3), **kw)
        want = jdata.data_transform(x01, rng=np.random.default_rng(3), **kw)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)
        inv = {k: kw[k] for k in ("rescaled", "logit")}
        np.testing.assert_allclose(tdata.inverse_data_transform(got, **inv),
                                   jdata.inverse_data_transform(want, **inv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tdata.logit_transform(x01 * 1.2 - 0.1),
                               jdata.logit_transform(x01 * 1.2 - 0.1), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="unknown transform"):
        tdata._parse_transform("logit+bad")
    arr = tdata.ArrayDataset(rng.integers(0, 256, (10, 8, 8, 3), dtype=np.uint8))
    for transform, skip, rows in (("logit+udq", 0, None), ("udq+gdq", 2, None),
                                  ("rescaled+gdq", 1, (1, 3))):
        kw = dict(seed=6, skip_batches=skip, transform=transform, dequant_seed=9,
                  local_slice=rows)
        tb = tdata.iterate_batches(arr, 4, **kw)
        jb = jdata.iterate_batches(jdata.ArrayDataset(arr.images), 4, **kw)
        for _ in range(3):
            np.testing.assert_allclose(next(tb), next(jb), atol=1e-6, rtol=0, err_msg=transform)


def test_prune_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """The prune CLI end to end on the tiny config: TF32 pinned off, a
    checkpoint that both packages load, the JAX CLI's report lines, the vis
    grid; --cost_aware --match_params writes the JAX CLI's allocation
    (magnitude scores: the same channel sizes, params and report line) and
    refuses local pruning. The stage ablation (prune_ssim): every stage's
    dir loads in both packages and validates, every sample set starts from
    one initial noise, and stage 2's selection is the JAX pruner's on the
    port's own stage-2 grads. prune_finetune's output loads in the JAX
    package. A diffusers directory over an lsun: lmdb prunes to the JAX
    CLI's channels and weights. --device cuda without a GPU raises in each
    CLI."""
    from diff_pruning_tpu.cli import ddpm_prune as jddpm_prune
    from diff_pruning_tpu.utils import checkpoint as jckpt
    from diff_pruning_tpu.utils import compile_cache
    from diff_pruning_tpu_torch.cli import ddpm_prune, prune_finetune, prune_ssim

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

    # the JAX CLI would point this process's JAX at an on-disk compile cache
    monkeypatch.setattr(compile_cache, "enable_persistent_compilation_cache",
                        lambda *a, **k: None)
    cost = ["--model_path", str(tmp_path / "dense"), "--batch_size", "4", "--pruner",
            "magnitude", "--pruning_ratio", "0.3", "--cost_aware", "bytes", "--skip_vis"]
    with pytest.raises(SystemExit, match="requires --global_pruning"):
        ddpm_prune.main(cost + ["--save_path", str(tmp_path / "bad"), "--device", "cpu"])
    cost += ["--global_pruning", "--match_params", "--max_sparsity", "0.75"]
    reports = {}
    for pkg, main, extra in (("jax", jddpm_prune.main, []),
                             ("torch", ddpm_prune.main, ["--device", "cpu"])):
        capsys.readouterr()
        with jax.default_matmul_precision("float32"):
            main(cost + ["--save_path", str(tmp_path / f"cost_{pkg}")] + extra)
        reports[pkg] = [ln for ln in capsys.readouterr().out.splitlines()
                        if ln.startswith(("match_params:", "#Params:", "#MACS:"))]
    assert reports["torch"] == reports["jax"] and len(reports["jax"]) == 3, reports
    jcfg, jparams = jckpt.load_model(str(tmp_path / "cost_jax"))
    tcfg, state = tckpt.load_model(str(tmp_path / "cost_torch"))
    assert tcfg.channel_sizes == jcfg.channel_sizes != cfg.channel_sizes
    tflat, jflat = tckpt.flat_from_state_dict(state), jflatten(jparams)
    assert sorted(tflat) == sorted(jflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k], np.asarray(v), err_msg=k)

    # the stage ablation: the samplers' initial noise recorded from the
    # generator each call receives
    from diff_pruning_tpu.pruning.surgery import unflatten_params as junflatten_
    from diff_pruning_tpu_torch.data.datasets import get_dataset, iterate_batches
    from diff_pruning_tpu_torch.diffpruning.sweep import accumulate_taylor_grads
    from diff_pruning_tpu_torch.sampling import ddim_sampler
    from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule

    x_T, real_make_sampler = [], ddim_sampler.make_sampler

    def recording_make_sampler(model, schedule, scfg):
        sample = real_make_sampler(model, schedule, scfg)

        def recorded(generator, batch_size, hw, channels, *args, **kwargs):
            twin = torch.Generator().set_state(generator.get_state())
            x_T.append(torch.randn((batch_size, hw, hw, channels), generator=twin))
            assert scfg.num_inference_steps == 2
            return sample(generator, batch_size, hw, channels, *args, **kwargs)

        return recorded

    monkeypatch.setattr(ddim_sampler, "make_sampler", recording_make_sampler)
    ssim_dir = tmp_path / "ssim"
    ablation = prune_ssim.main(["--model_path", str(tmp_path / "dense"), "--save_path",
                                str(ssim_dir), "--dataset", str(tmp_path / "data.npz"),
                                "--stages", "2", "1", "--ddim_steps", "2", "--n_vis", "4",
                                "--batch_size", "4", "--device", "cpu"])
    monkeypatch.setattr(ddim_sampler, "make_sampler", real_make_sampler)
    text = capsys.readouterr().out
    assert text.index("stage 1: saved model + 4 samples") < text.index("stage 2: saved")
    assert len(x_T) == 3 and all(torch.equal(x, x_T[0]) for x in x_T)
    assert ablation["steps_run"] == {1: 1, 2: 2}
    for stage in ("base", 1, 2):
        pngs = sorted(f.name for f in (ssim_dir / f"stage_{stage}").glob("*.png"))
        assert pngs == [f"{i:06d}.png" for i in range(4)], (stage, pngs)
    for stage in (1, 2):
        d = str(ssim_dir / f"stage_{stage}")
        jcfg, jparams = jckpt.load_model(d)
        junet.UNet2D(jcfg).graph.validate(jparams)
        tcfg, state = tckpt.load_model(d)
        net = tunet.UNet2D(tcfg, device="cpu")
        net.load_state_dict(state)
        assert tcfg.channel_sizes == jcfg.channel_sizes == ablation["channel_sizes"][stage]
        assert sum(p.numel() for p in net.parameters()) == ablation["params"][stage]
    # stage 2 against the JAX pruner on the port's own 2-step grads
    dense_cfg, dense_state = tckpt.load_model(str(tmp_path / "dense"))
    dense = tunet.UNet2D(dense_cfg, device="cpu")
    dense.load_state_dict(dense_state)
    x0 = torch.from_numpy(next(iterate_batches(get_dataset(str(tmp_path / "data.npz")), 4,
                                               seed=0)))
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(0))
    accumulate_taylor_grads(dense, DiffusionSchedule.create(), x0, noise, thr=None,
                            max_steps=2)
    jdense = {k: jnp.asarray(v) for k, v in tckpt.flat_from_state_dict(dense_state).items()}
    jdense = junflatten_(jdense)
    jgrads = junflatten_({k: jnp.asarray(v) for k, v in tckpt.flat_grads(dense).items()})
    jmodel = junet.UNet2D(junet.UNet2DConfig.from_json(dense_cfg.to_json()))
    want = jpruner.prune(jmodel.graph, jdense, jimp.make_importance("diff-pruning"),
                         sparsity=0.3, grads=jgrads)
    assert want.channel_sizes == ablation["channel_sizes"][2]
    _, stage2 = jckpt.load_model(str(ssim_dir / "stage_2"))
    stage2 = jflatten(stage2)
    for k, v in jflatten(jpruner.apply_pruning(jdense, jmodel.graph, want)).items():
        np.testing.assert_array_equal(np.asarray(stage2[k]), np.asarray(v), err_msg=k)

    # prune, then finetune, in one command; the output loads in the JAX package
    pf = tmp_path / "pf"
    chained = prune_finetune.main([
        "--model_path", str(tmp_path / "dense"), "--dataset", str(tmp_path / "data.npz"),
        "--output_dir", str(pf), "--batch_size", "4", "--num_iters", "2", "--device", "cpu",
        "--prune_args=--max_steps 2 --skip_vis",
        "--train_args=--save_model_steps 2 --log_steps 2 --vis_samples 4"])
    assert chained["prune"]["steps_run"] == 2 and chained["train"]["steps"] == 2
    assert all(np.isfinite(chained["train"]["losses"]))
    for sub in ("unet", "unet_ema"):
        jcfg, jparams = jckpt.load_model(str(pf), subfolder=sub)
        junet.UNet2D(jcfg).graph.validate(jparams)
        assert jcfg.channel_sizes == chained["prune"]["channel_sizes"]

    # a diffusers directory over an LSUN lmdb (the port's exporter and
    # make_lsun_lmdb): both packages' prune CLIs keep the same channels
    # (taylor, 2 sweep steps; the port fed the noise the JAX CLI draws)
    from PIL import Image

    from diff_pruning_tpu_torch.cli import make_lsun_lmdb
    from diff_pruning_tpu_torch.utils.convert import export_diffusers_pipeline

    folder = tmp_path / "lsun_src"
    folder.mkdir()
    for i, img in enumerate(np.random.default_rng(18).integers(0, 256, (6, 20, 27, 3),
                                                               dtype=np.uint8)):
        Image.fromarray(img).save(folder / f"{i}.png")
    made = make_lsun_lmdb.main(["--src", str(folder), "--out", str(tmp_path / "lsun_db")])
    assert made["entries"] == 6
    export_diffusers_pipeline(str(tmp_path / "hf"), cfg, model.state_dict())
    lsun = ["--model_path", str(tmp_path / "hf"), "--dataset", "lsun:" + str(tmp_path / "lsun_db"),
            "--batch_size", "4", "--pruner", "taylor", "--pruning_ratio", "0.3", "--max_steps",
            "2", "--host_loop", "--skip_vis"]
    with jax.default_matmul_precision("float32"):
        jddpm_prune.main(lsun + ["--save_path", str(tmp_path / "lsun_jax")])
    jnoise = torch.from_numpy(np.asarray(jax.random.normal(jax.random.key(0), (4, 16, 16, 3))))
    real_randn = torch.randn

    def jax_noise(*shape, **kw):
        dims = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else shape
        return jnoise.clone() if dims == (4, 16, 16, 3) else real_randn(*shape, **kw)

    monkeypatch.setattr(torch, "randn", jax_noise)
    ddpm_prune.main(lsun + ["--save_path", str(tmp_path / "lsun_port"), "--device", "cpu"])
    monkeypatch.setattr(torch, "randn", real_randn)
    jcfg, jparams = jckpt.load_model(str(tmp_path / "lsun_jax"))
    tcfg, state = tckpt.load_model(str(tmp_path / "lsun_port"))
    assert tcfg.channel_sizes == jcfg.channel_sizes and tcfg.channel_sizes
    got, want = tckpt.flat_from_state_dict(state), jflatten(jparams)
    assert sorted(got) == sorted(want)
    for k, v in want.items():  # the same keep-indices slice the same dense weights
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in (
            (ddpm_prune.main, base + ["--pruner", "magnitude"]),
            (prune_ssim.main, ["--model_path", str(tmp_path / "dense"), "--save_path",
                               str(tmp_path / "x"), "--dataset", str(tmp_path / "data.npz")]),
            (prune_finetune.main, ["--model_path", str(tmp_path / "dense"), "--dataset",
                                   str(tmp_path / "data.npz"), "--output_dir",
                                   str(tmp_path / "y")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
