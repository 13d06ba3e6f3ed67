"""The port's LDM train slice against the JAX package, on the CPU: the
class-labeled batches, the train step of ``cli/ldm_train.py`` (f32 and
bf16), its AdamW + clip update, and the ``ldm_train`` CLI with its resume
and checkpoints.

The tiny ``UNetCond`` (two heads, class-token cross-attention) with a VQ
first stage whose mid block carries its one-head self-attention, and 5
classes; every parameter random (numpy, from a seed) and handed to both
packages through an LDM model dir. The JAX step is built from the JAX CLI's
own parts (``cli/ldm_train.py`` ``loss_fn``: encode, label drop, the
schedule's ``add_noise``, the UNet on the cast params, the f32 MSE), with
the noise, t and drop mask given, since jax.random's draws cannot be
reproduced in torch; JAX runs with f32 matmuls, the port with TF32 off.
Tolerances:

- batches: bit-identical (the same rng draws; PNGs at their own resolution,
  so the decode is lossless on both sides);
- f32 step: loss 1e-4 relative; each grad within 1e-3 of its parameter's
  largest |grad| plus 1e-6 of the largest grad of all (the grads that are
  zero in exact arithmetic: the cross-attention's to_q and to_k, whose
  softmax over one token is 1). Both sides compute in f32 and differ in
  summation order through the encode, the UNet and its backward;
- bf16 step: loss 2e-2 relative, the grads within 5e-2 in norm relative
  to their norm (bf16 rounds activations and grads at other places in the
  two frameworks; the port's bf16 train-step tolerances,
  tests/test_torch_training.py);
- the optimizer on the same grads: params and moments after two updates
  within 1e-6 + 1e-6 relative (the same f32 formulas);
- the CLI's resume, its checkpoints and model dir: exact;
- the CLI on 2 gloo ranks against one process (f32): DP_LOSS_RTOL, and
  Adam's bound for the UNet.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from diff_pruning_tpu.cli.ldm_prune import load_ldm as jax_load_ldm
from diff_pruning_tpu.data import datasets as jdata
from diff_pruning_tpu.models import latent_diffusion as jl
from diff_pruning_tpu.models import unet_cond as ju
from diff_pruning_tpu.models import vae as jv
from diff_pruning_tpu.pruning.surgery import flatten_params as jflatten
from diff_pruning_tpu.pruning.surgery import unflatten_params as junflatten
from diff_pruning_tpu.utils import checkpoint as jckpt
from diff_pruning_tpu_torch.cli import ldm_train
from diff_pruning_tpu_torch.data import datasets as tdata
from diff_pruning_tpu_torch.data.procedural import make_procedural_dataset, write_labeled_folder
from diff_pruning_tpu_torch.models import latent_diffusion as tl
from diff_pruning_tpu_torch.models import unet_cond as tu
from diff_pruning_tpu_torch.models import vae as tv
from diff_pruning_tpu_torch.training.finetune import Optimizer, TrainConfig
from diff_pruning_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)
B, N_CLASSES, LR = 4, 5, 3.2e-5
F32_LOSS_RTOL, F32_GRAD_TOL = 1e-4, 1e-3
# the CLI on 2 gloo ranks against one process (f32): a mean of two row
# means against one mean, a few ulps; Adam's bound a step (twice the most
# its first bias-corrected updates move a param, tests/test_torch_training.py)
DP_LOSS_RTOL, ADAM_MOVE = 1e-5, 2.02
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 2e-2, 5e-2


@pytest.fixture(autouse=True)
def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _vae_config():
    return jv.AutoencoderConfig(block_out_channels=(32, 64), layers_per_block=1,
                                latent_channels=3, norm_num_groups=8, sample_size=16,
                                num_vq_embeddings=16, vq_embed_dim=3, mid_block_attention=True)


def _model_dir(path, seed):
    """A tiny LDM dir, every parameter random with torch-like scales (the
    zero-initialised out convs too, so that every grad is non-trivial)."""
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


def _jax_step_grads(jldm, params, images, labels, noise, t, drop, dtype):
    """(loss, unet grads) of the JAX CLI's loss_fn with the draws given."""
    frozen = {k: v for k, v in params.items() if k != "unet"}

    def loss_fn(unet_params):
        z = jldm.first_stage.encode(frozen["first_stage"], images.astype(dtype))
        z = z * jldm.scale_factor
        labs = jnp.where(drop, jldm.uncond_class, labels)
        ctx = jldm.cond_stage(frozen["cond_stage"], labs).astype(dtype)
        eps_target = noise.astype(z.dtype)
        noisy = jldm.schedule.add_noise(z, eps_target, t)
        up = jax.tree.map(lambda a: a.astype(dtype), unet_params)
        eps = jldm.unet(up, noisy, t, context=ctx)
        return jnp.mean((eps - eps_target).astype(jnp.float32) ** 2)

    with jax.default_matmul_precision("float32"):
        return jax.value_and_grad(loss_fn)(params["unet"])


def _check_batches(root, res):
    jds = jdata.get_labeled_dataset(root, resolution=res)
    tds = tdata.get_labeled_dataset(root, resolution=res)
    assert tds.files == jds.files and tds.class_names == jds.class_names
    np.testing.assert_array_equal(tds.labels, jds.labels)
    for skip in (0, 3):
        jit = jdata.iterate_labeled_batches(jds, B, seed=9, skip_batches=skip)
        tit = tdata.iterate_labeled_batches(tds, B, seed=9, skip_batches=skip)
        # a data-parallel rank's rows: every draw at the global shape
        lit = tdata.iterate_labeled_batches(tds, B, seed=9, skip_batches=skip,
                                            local_slice=(1, 3))
        for _ in range(5):  # past an epoch of 3 batches
            (ji, jlab), (ti, tlab), (li, llab) = next(jit), next(tit), next(lit)
            assert ti.dtype == np.float32 and ti.shape == (B, res, res, 3)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tlab, jlab)
            np.testing.assert_array_equal(li, ji[1:3])
            np.testing.assert_array_equal(llab, jlab[1:3])


def _check_step(model_dir, root, res):
    """One train step, port against the JAX CLI's loss_fn, f32 and bf16."""
    jldm, jparams = jax_load_ldm(model_dir, None)
    images, labels = next(tdata.iterate_labeled_batches(
        tdata.get_labeled_dataset(root, resolution=res), B, seed=1))
    hw = jldm.unet.cfg.image_size
    rng = np.random.default_rng(2)
    noise = rng.standard_normal((B, hw, hw, 3)).astype(np.float32)
    t = np.array([0, 999, 321, 640], np.int32)
    drop = np.array([False, True, False, True])
    for prec, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        ldm = tl.load_ldm(model_dir, device="cpu")
        compute = torch.bfloat16 if prec == "bf16" else None
        if compute is not None:
            ldm.first_stage.cast_compute_weights(compute)
        params = dict(ldm.unet.named_parameters())
        loss = ldm.train_loss(torch.from_numpy(images), torch.from_numpy(labels).long(),
                              torch.from_numpy(t).long(), torch.from_numpy(noise),
                              drop=torch.from_numpy(drop), compute_dtype=compute)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        loss = float(loss.detach())
        jloss, jgrads = _jax_step_grads(jldm, jparams, jnp.asarray(images),
                                        jnp.asarray(labels), jnp.asarray(noise),
                                        jnp.asarray(t), jnp.asarray(drop), dtype)
        got = tckpt.flat_from_state_dict(grads)
        want = {k: np.asarray(v, np.float32) for k, v in jflatten(jgrads).items()}
        assert sorted(got) == sorted(want)
        if prec == "f32":
            np.testing.assert_allclose(loss, float(jloss), rtol=F32_LOSS_RTOL)
            floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
            for k, w in want.items():
                err = float(np.abs(got[k] - w).max())
                assert err <= F32_GRAD_TOL * float(np.abs(w).max()) + floor, (k, err)
        else:
            np.testing.assert_allclose(loss, float(jloss), rtol=BF16_LOSS_RTOL)
            diff = np.sqrt(sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items()))
            norm = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
            assert diff <= BF16_GRAD_RTOL * norm, (diff, norm)


def _check_optimizer():
    """The port's Optimizer as the CLI builds it against optax's
    chain(clip_by_global_norm(1.0), adamw(lr, weight_decay=0)) on the same
    grads (global norm above 1: the clip acts), two updates."""
    rng = np.random.default_rng(4)
    shapes = {"a/w": (3, 5), "a/bias": (5,), "b/scale": (7,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    gs = [{k: 2.0 * rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
          for _ in range(2)]
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR, weight_decay=0.0))
    jp = junflatten({k: jnp.asarray(v) for k, v in p0.items()})
    jstate = opt.init(jp)
    params = {k.replace("/", "."): torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = Optimizer(TrainConfig(learning_rate=LR, weight_decay=0.0, grad_clip=1.0,
                                 use_ema=False))
    tstate = topt.init(params)
    for g in gs:
        upd, jstate = opt.update(junflatten({k: jnp.asarray(v) for k, v in g.items()}), jstate,
                                 jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(g[k.replace(".", "/")].copy()) for k in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tg)))
        assert float(norm) > 1.0
        topt.update(tg, norm, tstate, list(params.values()))
    for k, v in jflatten(jp).items():
        np.testing.assert_allclose(params[k.replace("/", ".")].numpy(), np.asarray(v),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    mine = tstate.by_keypath()
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(mine[k], v, atol=1e-6, rtol=1e-6, err_msg=k)


def _check_cli(tmp_path, model_dir, root):
    """8 steps on the CPU, a resume from step 4 that must end bit-identical,
    and the outputs loaded by the JAX package."""
    base = ["--model_path", model_dir, "--dataset", root, "--train_batch_size", str(B),
            "--num_iters", "8", "--save_model_steps", "4", "--log_steps", "2",
            "--uncond_prob", "0.5", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full = ldm_train.main(base + ["--output_dir", a])
    resumed = ldm_train.main(base + ["--output_dir", b, "--resume_from_checkpoint",
                                     os.path.join(a, "ckpt", "step-4")])
    assert full["steps"] == 8 and resumed["start_step"] == 4 and resumed["steps"] == 4
    assert np.all(np.isfinite(full["losses"])) and resumed["losses"] == full["losses"][4:]
    for name in ("params.npz", "opt_state.npz"):
        with np.load(os.path.join(a, "ckpt", "step-8", name)) as x, \
                np.load(os.path.join(b, "ckpt", "step-8", name)) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{name} {k}")
    with open(os.path.join(a, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [2, 4, 6, 8]
    assert sorted(os.listdir(a)) == ["ckpt", "cond_stage", "first_stage", "ldm.json", "logs",
                                     "metrics.jsonl", "run.sh", "unet"]
    # the train state in the JAX layout: the JAX CLI's resume reads it
    meta, jp, ema = jckpt.load_train_state(os.path.join(a, "ckpt"))
    assert meta == {"step": 8, "seed": 0, "batches_consumed": 8} and ema is None
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR, weight_decay=0.0))
    jstate, ok = jckpt.restore_opt_state(os.path.join(a, "ckpt"), opt.init(jp))
    assert ok and int(jstate[1][0].count) == 8
    with np.load(os.path.join(a, "ckpt", "step-8", "opt_state.npz")) as z:
        for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]:
            np.testing.assert_array_equal(np.asarray(v), z[jax.tree_util.keystr(p)])
    # the output dir is a complete LDM dir for the JAX package: the trained
    # UNet, the first and cond stages as given
    jldm, jparams = jax_load_ldm(a, None)
    _, src = jax_load_ldm(model_dir, None)
    for part in ("first_stage", "cond_stage"):
        for k, v in jflatten(src[part]).items():
            np.testing.assert_array_equal(np.asarray(jflatten(jparams[part])[k]),
                                          np.asarray(v), err_msg=f"{part} {k}")
    for k, v in jflatten(jp).items():
        np.testing.assert_array_equal(np.asarray(jflatten(jparams["unet"])[k]), np.asarray(v),
                                      err_msg=k)
    assert jldm.n_classes == N_CLASSES
    # --multihost on 2 gloo ranks against one process, f32: rank 0's weights
    # broadcast, each rank its rows of the batches and of the step's global
    # draws, the grads averaged; losses within DP_LOSS_RTOL, the UNet within
    # Adam's bound over the steps; rank 0 alone writes the dir
    import _torch_dp

    dp = base[:6] + ["--num_iters", "4", "--save_model_steps", "4", "--log_steps", "1",
                     "--uncond_prob", "0.5", "--mixed_precision", "no"]
    one = ldm_train.main(dp + ["--output_dir", str(tmp_path / "dp1"), "--device", "cpu"])
    _torch_dp.cli_ranks("ldm_train", dp + ["--output_dir", str(tmp_path / "dp2")])
    with open(tmp_path / "dp2" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    np.testing.assert_allclose([r["loss"] for r in recs], one["losses"], rtol=DP_LOSS_RTOL)
    assert sorted(os.listdir(tmp_path / "dp2")) == sorted(os.listdir(a))
    _, p1, _ = tckpt.load_train_state(str(tmp_path / "dp1" / "ckpt"))
    _, p2, _ = tckpt.load_train_state(str(tmp_path / "dp2" / "ckpt"))
    for k, v in tckpt.flat_from_state_dict(p1).items():
        err = np.abs(tckpt.flat_from_state_dict(p2)[k] - v).max()
        assert err <= ADAM_MOVE * 4 * LR, (k, err)


def test_ldm_train_matches_jax(tmp_path):
    """The labeled batches, one train step (f32 and bf16) and the AdamW +
    clip update against the JAX package; then the ldm_train CLI on the CPU,
    its resume and its outputs in the JAX package, and the CLI on 2 gloo
    ranks against one process."""
    model_dir, root = str(tmp_path / "ldm"), str(tmp_path / "data")
    _model_dir(model_dir, seed=3)
    res = ju.tiny_cond_config().image_size * 2  # the VQ's f2
    imgs = make_procedural_dataset(13, res, seed=5)
    write_labeled_folder(imgs, np.arange(13) % 3, root)
    _check_batches(root, res)
    _check_step(model_dir, root, res)
    _check_optimizer()
    _check_cli(tmp_path, model_dir, root)
