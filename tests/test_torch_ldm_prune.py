"""The port's LDM prune slice against the JAX package, on the CPU:
``LatentDiffusion.get_loss_at_t``, the self-sampled sweep
(``diffpruning/sweep.py`` ``accumulate_ldm_grads``) against the JAX
``cli/ldm_prune.py`` loop itself, channel selection over ``UNetCond.graph``
and the ``ldm_prune`` CLI.

The tiny ``UNetCond`` (two heads, class-token cross-attention) with a VQ
first stage and 5 classes; every parameter random (numpy, from a seed) and
handed to both packages through an LDM model dir. The JAX CLI runs on that
dir with its sampler replaced by one that returns given latents, so both
sweeps see the same latents; the labels and noise are the JAX CLI's own
draws (its key splits, replayed here) and are fed to the port. JAX runs
with f32 matmuls, the port with TF32 off. Tolerances:

- losses: 1e-5 relative (f32 forwards summed in other orders, as in
  tests/test_torch_ldm.py);
- accumulated grads: the sweep's rule (tests/test_torch_pruning.py):
  |port - jax| <= 1e-4 * max|jax| per parameter plus 1e-6 of the largest
  grad of all, for the grads that are zero in exact arithmetic (the
  cross-attention's to_q and to_k: its softmax over one token is 1);
  Diff-Pruning scores from each package's own grads within 1e-3 of each
  var's largest score;
- steps run, keep-indices, channel sizes and the CLI's written arrays and
  configs: exactly equal.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diff_pruning_tpu.cli.ldm_prune import load_ldm as jax_load_ldm
from diff_pruning_tpu.models import latent_diffusion as jl
from diff_pruning_tpu.models import unet_cond as ju
from diff_pruning_tpu.models import vae as jv
from diff_pruning_tpu.pruning import importance as jimp
from diff_pruning_tpu.pruning import pruner as jpruner
from diff_pruning_tpu.pruning.surgery import flatten_params as jflatten
from diff_pruning_tpu.pruning.surgery import unflatten_params as junflatten
from diff_pruning_tpu.utils import compile_cache
from diff_pruning_tpu_torch.diffpruning.sweep import accumulate_ldm_grads
from diff_pruning_tpu_torch.models import latent_diffusion as tl
from diff_pruning_tpu_torch.models import unet_cond as tu
from diff_pruning_tpu_torch.models import vae as tv
from diff_pruning_tpu_torch.pruning import importance as timp
from diff_pruning_tpu_torch.pruning import pruner as tpruner
from diff_pruning_tpu_torch.pruning.surgery import flatten_params, unflatten_params
from diff_pruning_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)
B, N_CLASSES, STEPS = 2, 5, 3
LOSS_RTOL, GRAD_TOL, SCORE_RTOL = 1e-5, 1e-4, 1e-3
# cin256-v2's UNet pruned locally at 0.3 with round_to 2 (the CLI's
# defaults): in local mode the kept sizes depend only on the sizes
LDM_PRUNED_PARAMS_AT_0_3 = 203_294_971


@pytest.fixture(autouse=True)
def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    # the JAX CLIs would point this process's JAX at an on-disk compile cache
    monkeypatch.setattr(compile_cache, "enable_persistent_compilation_cache",
                        lambda *a, **k: None)


def _vae_config():
    return jv.AutoencoderConfig(block_out_channels=(32, 64), layers_per_block=1,
                                latent_channels=3, norm_num_groups=8, sample_size=16,
                                num_vq_embeddings=16, vq_embed_dim=3)


def _model_dir(path, seed):
    """A tiny LDM dir (UNetCond, ClassEmbedder(5), VQ first stage), every
    parameter random with torch-like scales; returns the port's model."""
    jldm = jl.LatentDiffusion(ju.tiny_cond_config(), n_classes=N_CLASSES,
                              first_stage=jv.make_first_stage(_vae_config()))
    rng = np.random.default_rng(seed)
    flat = {}
    for key, s in jflatten(jax.eval_shape(jldm.init, jax.random.key(0))).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            a = rng.uniform(-1.0, 1.0, s.shape) * np.sqrt(3.0 / np.prod(s.shape[:-1]))
        elif leaf == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        flat[key] = a.astype(np.float32)
    ldm = tl.LatentDiffusion(tu.tiny_cond_config(), n_classes=N_CLASSES, device="cpu",
                             first_stage=tv.make_first_stage(
                                 tv.AutoencoderConfig.from_json(_vae_config().to_json()),
                                 device="cpu"))
    ldm.load_state_dict(tckpt.state_dict_from_flat(flat))
    tckpt.save_ldm(path, ldm)
    return ldm


def _jax_cli(argv, latents, capsys):
    """Runs the JAX ldm_prune CLI with its CFG sampler returning ``latents``
    step by step; returns (steps run, the grads it pruned with, stdout)."""
    from diff_pruning_tpu.cli import ldm_prune as jcli

    seen = {}
    real_prune = jpruner.prune

    def spy_prune(graph, params, imp, **kw):
        seen["grads"] = kw.get("grads")
        return real_prune(graph, params, imp, **kw)

    def fake_sampler(self, params, **kw):
        step = iter(latents)
        return lambda key, labels, n: jnp.asarray(next(step))

    mp = pytest.MonkeyPatch()
    mp.setattr(jpruner, "prune", spy_prune)
    mp.setattr(jl.LatentDiffusion, "make_cfg_sampler", fake_sampler)
    try:
        capsys.readouterr()
        with jax.default_matmul_precision("float32"):
            jcli.main(argv)
        out = capsys.readouterr().out
    finally:
        mp.undo()
    steps = [int(line.split()[1]) for line in out.splitlines() if "sweep:" in line]
    grads = seen["grads"]
    return (steps[0] if steps else 0), (None if grads is None else {
        k: np.asarray(v) for k, v in jflatten(grads).items()}), out


def _jax_draws(latents, seed=0):
    """The labels and noise the JAX CLI draws at each step (ldm_prune.py:170-174)."""
    key = jax.random.key(seed)
    labels, noise = [], []
    for lat in latents:
        key, k1, _, k3 = jax.random.split(key, 4)
        labels.append(np.asarray(jax.random.randint(k1, (B,), 0, N_CLASSES - 1)))
        noise.append(np.asarray(jax.random.normal(k3, lat.shape)))
    return labels, noise


def _assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    floor = 1e-6 * max(np.abs(g).max() for g in want.values())
    for k, g in want.items():
        err = np.abs(got[k] - g).max()
        assert err <= GRAD_TOL * np.abs(g).max() + floor, (k, err)


def test_ldm_sweep_and_pruning_match_jax(tmp_path, capsys):
    """get_loss_at_t's losses at every step against JAX's; the sweep against
    the JAX CLI's loop on the same latents, labels and noise: with
    diff-pruning's thr the CLI stops at step 1 before that step's backward
    (the grads are step 0's alone), with diff0 (thr 0) it runs every step;
    steps run, losses and accumulated grads agree. Then, from the same
    params and grads, identical scores, keep-indices, channel sizes
    (round_to 2, attention heads grouped) and sliced params for
    diff-pruning, taylor and magnitude, and Diff-Pruning scores from each
    package's own grads within tolerance."""
    d = str(tmp_path / "ldm")
    ldm = _model_dir(d, seed=1)
    rng = np.random.default_rng(2)
    latents = [rng.standard_normal((B, 8, 8, 3)).astype(np.float32) for _ in range(STEPS)]
    labels, noise = _jax_draws(latents)
    jldm, jparams = jax_load_ldm(d, None)
    loss_fn = jax.jit(lambda p, lat, lab, t, n: jldm.get_loss_at_t(p, lat, lab, t, n))
    with jax.default_matmul_precision("float32"):
        want_losses = [float(loss_fn(jparams, jnp.asarray(lat), jnp.asarray(lab),
                                     jnp.full((B,), t, jnp.int32), jnp.asarray(n)))
                       for t, (lat, lab, n) in enumerate(zip(latents, labels, noise))]

    def draw(t):
        return (torch.tensor(latents[t]), torch.tensor(labels[t]).long(),
                torch.tensor(noise[t]))

    # a thr between step 1's loss ratio and 1: the sweep stops at step 1
    assert want_losses[1] < want_losses[0]
    thr = (want_losses[1] / want_losses[0] + 1.0) / 2
    base = ["--model_path", d, "--max_steps", str(STEPS), "--batch_size", str(B),
            "--skip_vis", "--sparsity", "0.3"]
    for pruner, thr, want_steps in (("diff-pruning", thr, 2), ("diff0", 0.0, STEPS)):
        steps, jgrads, _ = _jax_cli(base + ["--pruner", pruner, "--thr", str(thr), "--save_path",
                                            str(tmp_path / pruner)], latents, capsys)
        res = accumulate_ldm_grads(ldm, draw, max_steps=STEPS, thr=thr)
        assert steps == res.steps_run == want_steps, (pruner, steps, res.steps_run)
        np.testing.assert_allclose(res.losses, want_losses[:want_steps], rtol=LOSS_RTOL)
        tgrads = tckpt.flat_grads(ldm.unet)
        _assert_grads_close(tgrads, jgrads)
    ldm.unet.zero_grad(set_to_none=True)

    # selection from the same params and grads (the diff0 sweep's)
    jgraph = jldm.unet.graph
    tgraph = ldm.unet.graph
    flat = tckpt.flat_from_state_dict(ldm.unet.state_dict())
    params, grads = unflatten_params(flat), unflatten_params(jgrads)
    jp = junflatten({k: jnp.asarray(v) for k, v in flat.items()})
    jg = junflatten({k: jnp.asarray(v) for k, v in jgrads.items()})
    kw = dict(sparsity=0.3, round_to=2)
    for name in ("diff-pruning", "taylor", "magnitude"):
        want = jpruner.prune(jgraph, jp, jimp.make_importance(name, seed=3), grads=jg, **kw)
        got = tpruner.prune(tgraph, params, timp.make_importance(name, seed=3), grads=grads,
                            **kw)
        assert got.channel_sizes == want.channel_sizes, name
        assert sorted(got.keep) == sorted(want.keep), name
        for var, idx in want.keep.items():
            np.testing.assert_array_equal(got.keep[var], idx, err_msg=f"{name} {var}")
        sliced = flatten_params(tpruner.apply_pruning(params, tgraph, got))
        for k, v in jflatten(jpruner.apply_pruning(jp, jgraph, want)).items():
            np.testing.assert_array_equal(sliced[k], np.asarray(v), err_msg=f"{name} {k}")
    assert any(want.channel_sizes[v.name] < v.size for v in tgraph.prunable_vars())
    # Diff-Pruning scores from each package's own grads
    imp = timp.make_importance("diff-pruning")
    for v in tgraph.prunable_vars():
        mine = imp(tgraph, params, v, grads=unflatten_params(tgrads))
        theirs = imp(tgraph, params, v, grads=grads)
        err = np.abs(mine - theirs).max() / np.abs(theirs).max()
        assert err <= SCORE_RTOL, (v.name, err)


def test_ldm_prune_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """The ldm_prune CLI on --device cpu: with the magnitude pruner it writes
    the JAX CLI's files (unet/params.npz and config.json, cond_stage/,
    first_stage/, ldm.json) and its params line; with diff-pruning it
    samples its sweep latents by CFG (here PLMS), pins TF32 off, reports the
    sweep and the vis grid, and writes a dir the JAX package loads; reinit
    keeps the pruned sizes; --device cuda raises without a GPU. At full
    width (cin256-v2, shapes only) both pruners keep the same channel sizes
    at the CLI's defaults, which pins the pruned UNet's parameter count."""
    from diff_pruning_tpu_torch.cli import ldm_prune

    jfull = ju.UNetCond(ju.cin256_v2_config())
    want = jpruner.prune(jfull.graph, jax.eval_shape(jfull.init, jax.random.key(0)),
                         jimp.make_importance("random"), sparsity=0.3, round_to=2)
    tfull = tu.UNetCond(tu.cin256_v2_config(), device="meta")
    got = tpruner.prune(tfull.graph, {}, timp.make_importance("random"), sparsity=0.3,
                        round_to=2)
    assert got.channel_sizes == want.channel_sizes
    pruned = tu.UNetCond(tu.cin256_v2_config().with_channel_sizes(got.channel_sizes),
                         device="meta")
    assert sum(p.numel() for p in pruned.parameters()) == LDM_PRUNED_PARAMS_AT_0_3

    d = str(tmp_path / "ldm")
    _model_dir(d, seed=4)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    argv = ["--model_path", d, "--pruner", "magnitude", "--sparsity", "0.3", "--skip_vis"]
    _, _, jtext = _jax_cli(argv + ["--save_path", str(jout)], [], capsys)
    stats = ldm_prune.main(argv + ["--save_path", str(tout), "--device", "cpu"])
    text = capsys.readouterr().out
    params_line = [ln for ln in jtext.splitlines() if ln.startswith("Params:")]
    assert params_line and params_line[0] in text.splitlines()
    for sub in ("unet", "cond_stage", "first_stage"):
        with np.load(jout / sub / "params.npz") as a, np.load(tout / sub / "params.npz") as b:
            assert sorted(a.files) == sorted(b.files), sub
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (sub, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{sub}/{k}")
    for name in ("unet/config.json", "first_stage/config.json"):
        assert (jout / name).read_text() == (tout / name).read_text(), name
    assert json.loads((jout / "ldm.json").read_text()) == json.loads(
        (tout / "ldm.json").read_text())
    assert stats["steps_run"] == 0 and stats["params"] < stats["params_before"]

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    out = tmp_path / "diff"
    stats = ldm_prune.main(["--model_path", d, "--save_path", str(out), "--pruner",
                            "diff-pruning", "--max_steps", "2", "--batch_size", "2",
                            "--ddim_steps", "2", "--method", "plms", "--classes", "0", "3",
                            "--device", "cpu"])
    text = capsys.readouterr().out
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert "torch.backends.cudnn.allow_tf32=False" in text and "sweep: 2 steps" in text
    assert stats["steps_run"] == 2 and len(stats["losses"]) == 2
    assert (out / "samples.png").is_file()
    jback, jparams = jax_load_ldm(str(out), None)
    jback.unet.graph.validate(jparams["unet"])
    assert jback.unet.cfg.channel_sizes == stats["channel_sizes"]
    assert sum(int(np.prod(v.shape)) for v in jax.tree.leaves(jparams["unet"])) == stats["params"]
    stats_r = ldm_prune.main(["--model_path", d, "--save_path", str(tmp_path / "reinit"),
                              "--pruner", "reinit", "--skip_vis", "--device", "cpu"])
    assert stats_r["channel_sizes"] == stats["channel_sizes"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ldm_prune.main(["--model_path", d, "--save_path", str(out)])
