"""The port's finetune and first-stage (autoencoder) training against the
JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the JAX
side runs with f32 matmuls and the port with TF32 off. The JAX step draws
its noise and timesteps from ``split(key, 3)``; the test re-draws them from
the same keys and feeds them to the port's step. Tolerances:

- f32: loss and grad_norm rtol 1e-5 (the forwards differ in summation order
  only, a few 1e-6 relative, tests/test_torch_unet.py); the first step's
  grads, read from Adam's first moment (0.1 x the clipped grads), within
  1e-4 of each parameter's max plus 1e-6 of the largest overall (the
  sweep's rule, tests/test_torch_pruning.py); params and EMA after three
  steps within 1e-6 + 1e-2 x the LR summed over the steps.
- bf16: loss rtol 2e-2 and grad_norm rtol 5e-2 (bf16 rounds activations
  and grads at other places in the two frameworks); the first step's grads
  within 5e-2 in norm, relative to their norm.
- Where a grad is zero in exact arithmetic (to_k's bias: the softmax is
  invariant to it) or, in bf16, near the bf16 noise, Adam turns the noise's
  sign into +-lr: those params (named below; in bf16 all of them) are held
  to ADAM_MOVE x the summed LR, twice the most the first steps' bias-corrected
  update can move a param (1.003 lr, Cauchy-Schwarz on the moments' weights).
- Checkpoints and resume: exact.
- The autoencoder step and CLIs: see ``_ae_step_matches_jax`` and the
  AE_* constants (Adam's bound for b1 0.5, b2 0.9; the bf16 rules).
- Data parallelism (``parallel/mesh.py``; 2 gloo processes on the CPU,
  global batch 8, dropout 0): the 2-rank step against the one-process
  step: loss and grad_norm rtol DP_RTOL (a mean of two row means against
  one mean, a few f32 ulps), the grads (Adam's first moment) within DP_RTOL
  of each parameter's max plus 1e-6 of the largest overall; against the
  JAX step on a 2-device mesh, the f32 rules above; params and EMA within
  Adam's bound (the grads near eps carry the noise into them); the two
  ranks' params bit-identical; the same with gradient accumulation over 2
  micro-batches. The train CLI on 2 ranks against 1 process:
  its losses DP_RTOL, its params and EMA within Adam's bound over the
  steps.
"""

import copy
import dataclasses
import functools
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from diff_pruning_tpu.models import unet2d as junet
from diff_pruning_tpu.pruning.surgery import flatten_params as jflatten
from diff_pruning_tpu.pruning.surgery import unflatten_params as junflatten
from diff_pruning_tpu.schedulers.ddpm import DiffusionSchedule as JaxSchedule
from diff_pruning_tpu.training import finetune as jft
from diff_pruning_tpu.utils import checkpoint as jckpt
from diff_pruning_tpu_torch.models import unet2d as tunet
from diff_pruning_tpu_torch.models import vae as tvae
from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
from diff_pruning_tpu_torch.training import finetune as tft
from diff_pruning_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)
DP_RTOL = 1e-5
ADAM_MOVE = 2.02
# the most Adam(b1 0.5, b2 0.9) moves a param in one of its steps 2-4, over
# the LR: sqrt(sum_i w_i^2 / u_i) for the bias-corrected moments' weights
# (Cauchy-Schwarz; 1.16 at step 4), twice for two runs that differ
AE_ADAM_MOVE = 2 * 1.17
# the adaptive GAN weight in bf16: a ratio of grad norms through the
# PatchGAN's BatchNorm, whose bf16 backward is 15.6 % off the f32 one in
# either package (the grad of -mean(D(x)) in x at these shapes, in norm);
# the VQ case's bf16 weight sits 3.9 % (JAX) and 6.0 % (port) off its f32
# value, 2.1 % apart, the two packages' errors differing in direction
AE_BF16_DWEIGHT_RTOL = 0.1
# the bf16 autoencoder grads: 7-20 % off the f32 ones in norm in either
# package at the test's shapes (the straight-through lookup and the
# PatchGAN's BatchNorm in bf16), in other directions; the port's bf16 grads
# must be within 5e-2 of the exact ones, or within this factor of JAX's own
# bf16 distance from them. The generator's are held against the port's f32
# step; the discriminator's on the inputs the port's bf16 pass gave it,
# against their float64 witness, beside JAX's bf16 discriminator on the same
# inputs (its grads follow those inputs chaotically: a hinge over 8 logits,
# batch statistics of 2 images, so one bf16 ulp of the images moves even the
# f32 step's by up to 40 %)
AE_BF16_GRAD_SLACK = 1.5


@pytest.fixture(autouse=True)
def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


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


def port_model(cfg, flat):
    m = tunet.UNet2D(tunet.UNet2DConfig.from_json(cfg.to_json()), device="cpu")
    m.load_state_dict(tckpt.state_dict_from_flat(flat))
    return m


def jax_opt_arrays(opt_state):
    return {jax.tree_util.keystr(k): np.array(v)
            for k, v in jax.tree_util.tree_flatten_with_path(opt_state)[0]}


def _close_grads(got, want, rtol, what):
    """Each of ``got``'s flat grads within ``rtol`` of the parameter's
    largest |grad| in ``want``, plus 1e-6 of the largest grad overall."""
    assert sorted(got) == sorted(want), what
    floor = 1e-6 * max(np.abs(g).max() for g in want.values())
    for k, g in want.items():
        err = np.abs(got[k] - g).max()
        assert err <= rtol * np.abs(g).max() + floor, (what, k, err)


def _close_params(got, want, lr_sum, what):
    """Adam's bound: ADAM_MOVE x the summed LR. Adam's first steps move a
    param by ~lr g / (|g| + eps), so a grad near eps (1e-8) turns its f32
    reduce-order noise into a fraction of lr."""
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        err = np.abs(got[k] - v).max()
        assert err <= ADAM_MOVE * lr_sum, (what, k, err)


def _check_data_parallel_step(tmp_path):
    """One train step (clip active, EMA on, dropout 0) on a global batch of
    8 split over 2 gloo ranks, against the port's one-process step and the
    JAX ``make_train_step(mesh=)`` on 2 of the suite's virtual devices, with
    the same weights, noise and t; without and with gradient accumulation
    over 2 micro-batches (each rank splits its 4 rows, JAX the global 8: the
    same mean over the 8 rows). A local batch that the accumulation count
    does not divide raises."""
    import _torch_dp
    from diff_pruning_tpu.parallel.mesh import make_mesh, replicate, shard_batch

    cfg = junet.tiny_unet_config()
    jmodel = junet.UNet2D(cfg)
    flat = numpy_params(jmodel, 24)
    bsz = 8
    x = np.random.default_rng(25).uniform(-1, 1, (bsz, 16, 16, 3)).astype(np.float32)
    key = jax.random.key(200)
    nkey, tkey, _ = jax.random.split(key, 3)
    noise = np.array(jax.random.normal(nkey, x.shape, jnp.float32))
    t = np.array(jft.antithetic_timesteps(tkey, bsz, 1000))
    tx, tnoise, tt = torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(t).long()
    with pytest.raises(ValueError, match="not divisible by gradient_accumulation_steps 3"):
        tmodel = port_model(cfg, flat)
        tcfg = tft.TrainConfig(gradient_accumulation_steps=3)
        tft.make_train_step(tmodel, DiffusionSchedule.create(), tcfg)(
            tft.init_train_state(tmodel, tcfg), tx, noise=tnoise, t=tt)
    for accum in (1, 2):
        kw = dict(ema_decay=0.9, gradient_accumulation_steps=accum)
        with jax.default_matmul_precision("float32"):
            mesh = make_mesh((("data", 2),), devices=jax.devices()[:2])
            jcfg = jft.TrainConfig(**kw)
            jstate = replicate(mesh, jft.init_train_state(
                junflatten({k: jnp.asarray(v) for k, v in flat.items()}), jcfg))
            jstate, jm = jft.make_train_step(jmodel, JaxSchedule.create(), jcfg, mesh=mesh)(
                jstate, shard_batch(mesh, jnp.asarray(x)), key)
        jax_flat = {"mu": jflatten(jstate.opt_state[1][0].mu),
                    "params": jflatten(jstate.params), "ema": jflatten(jstate.ema_params)}
        tmodel = port_model(cfg, flat)
        one = tft.init_train_state(tmodel, tft.TrainConfig(**kw))
        one, om = tft.make_train_step(tmodel, DiffusionSchedule.create(),
                                      tft.TrainConfig(**kw))(one, tx, noise=tnoise, t=tt)
        one_flat = {"mu": tckpt.flat_from_state_dict(one.opt_state.mu),
                    "params": tckpt.flat_from_state_dict(one.params),
                    "ema": tckpt.flat_from_state_dict(one.ema_params)}

        in_dir, out_dir = tmp_path / f"dp_in{accum}", tmp_path / f"dp_out{accum}"
        out_dir.mkdir()
        tckpt.save_model(str(in_dir), tunet.UNet2DConfig.from_json(cfg.to_json()),
                         port_model(cfg, flat))
        np.savez(in_dir / "inputs.npz", x=x, noise=noise, t=t)
        (in_dir / "kwargs.json").write_text(json.dumps(kw))
        ranks = _torch_dp.lib_ranks("train", in_dir, out_dir)
        assert sorted(ranks[0]) == sorted(ranks[1])
        for k, v in ranks[0].items():  # every rank takes the same step
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=(accum, k))
        two = {part: {k.split(":", 1)[1]: v for k, v in ranks[0].items()
                      if k.startswith(part + ":")} for part in ("mu", "params", "ema")}
        for m, rtol in ((om, DP_RTOL), (jm, 1e-5)):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(ranks[0][k]), float(m[k]), rtol=rtol,
                                           err_msg=(accum, k))
        assert float(om["grad_norm"]) > 1.0  # the clip is active
        _close_grads(two["mu"], one_flat["mu"], DP_RTOL, (accum, "2 ranks against 1 process"))
        _close_grads(two["mu"], {k: np.asarray(v) for k, v in jax_flat["mu"].items()}, 1e-4,
                     (accum, "2 ranks against the JAX 2-device mesh"))
        lr = tft.TrainConfig().learning_rate
        for part in ("params", "ema"):
            _close_params(two[part], one_flat[part], lr,
                          (accum, f"{part}: 2 ranks against 1 process"))
            _close_params(two[part], {k: np.asarray(v) for k, v in jax_flat[part].items()},
                          lr, (accum, f"{part}: 2 ranks against the JAX mesh"))


def _step_against_jax(cfg, flat, batches, precision, remat):
    """Three steps of the JAX step against the port's (the rules of
    test_train_step_matches_jax); returns the JAX step's noise and t draws."""
    jmodel = junet.UNet2D(cfg)
    bsz = batches[0].shape[0]
    kw = dict(lr_warmup_steps=2, ema_decay=0.9, remat=remat,
              mixed_precision="bf16" if precision == "bf16" else "no")
    jcfg = jft.TrainConfig(**kw)
    with jax.default_matmul_precision("float32"):
        jstate = jft.init_train_state(junflatten({k: jnp.asarray(v) for k, v in flat.items()}),
                                      jcfg)
        jstep = jft.make_train_step(jmodel, JaxSchedule.create(), jcfg)
        want, draws = [], []
        for i, b in enumerate(batches):
            key = jax.random.key(100 + i)
            nkey, tkey, _ = jax.random.split(key, 3)
            draws.append((np.array(jax.random.normal(nkey, b.shape, jnp.float32)),
                          np.array(jft.antithetic_timesteps(tkey, bsz, 1000))))
            jstate, m = jstep(jstate, jnp.asarray(b), key)
            want.append({k: float(v) for k, v in m.items()})
            if i == 0:
                jopt1 = jax_opt_arrays(jstate.opt_state)
    tmodel = port_model(cfg, flat)
    tstate = tft.init_train_state(tmodel, tft.TrainConfig(**kw))
    tstep = tft.make_train_step(tmodel, DiffusionSchedule.create(), tft.TrainConfig(**kw))
    got = []
    for i, (b, (noise, t)) in enumerate(zip(batches, draws)):
        tstate, m = tstep(tstate, torch.from_numpy(b), noise=torch.from_numpy(noise),
                          t=torch.from_numpy(t).long())
        got.append({k: float(v) for k, v in m.items()})
        if i == 0:
            topt1 = {k: np.array(v) for k, v in tstate.opt_state.by_keypath().items()}
    loss_rtol, norm_rtol = (1e-5, 1e-5) if precision == "f32" else (2e-2, 5e-2)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=loss_rtol)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=norm_rtol)
        assert w["grad_norm"] > jcfg.grad_clip  # the clip is active
    assert sorted(topt1) == sorted(jopt1)
    assert {k: int(v) for k, v in topt1.items() if k.endswith("count")} == {
        "[1][0].count": 1, "[1][1].count": 1}
    mus = [k for k in jopt1 if ".mu" in k]
    if precision == "f32":
        floor = 1e-6 * max(np.abs(jopt1[k]).max() for k in mus)
        for k in mus:
            err = np.abs(topt1[k] - jopt1[k]).max()
            assert err <= 1e-4 * np.abs(jopt1[k]).max() + floor, (k, err)
    else:
        diff = np.sqrt(sum(((topt1[k] - jopt1[k]) ** 2).sum() for k in mus))
        assert diff <= 5e-2 * np.sqrt(sum((jopt1[k] ** 2).sum() for k in mus))

    lr_sum = 0.0 + 1e-4 + 2e-4  # warmup 2: lr 0, lr/2, lr
    tol = 1e-6 + 1e-2 * lr_sum
    for jtree, ttree in ((jstate.params, tstate.params), (jstate.ema_params, tstate.ema_params)):
        jflat, tflat = jflatten(jtree), tckpt.flat_from_state_dict(ttree)
        for k, v in jflat.items():
            err = np.abs(tflat[k] - np.asarray(v)).max()
            lim = ADAM_MOVE * lr_sum if (precision == "bf16" or k.endswith("to_k/bias")) \
                else tol
            assert err <= lim, (k, err, lim)
    return draws


def _remat_bit_identical(cfg, flat, batches, precision):
    """Two port steps with remat against two without, dropout 0.1 drawn from
    the step's generator, with and without 2 micro-batches: the losses,
    Adam's moments and the params bit for bit."""
    cfg_d = dataclasses.replace(cfg, dropout=0.1)
    mp = "bf16" if precision == "bf16" else "no"
    for accum in (1, 2):
        runs = []
        for remat in (False, True):
            m = port_model(cfg_d, flat)
            tcfg = tft.TrainConfig(remat=remat, mixed_precision=mp,
                                   gradient_accumulation_steps=accum)
            st = tft.init_train_state(m, tcfg)
            step = tft.make_train_step(m, DiffusionSchedule.create(), tcfg, seed=5)
            losses = [float(step(st, torch.from_numpy(b))[1]["loss"]) for b in batches[:2]]
            runs.append((losses, {f"{part}:{k}": v for part, tree in (
                ("mu", st.opt_state.mu), ("params", st.params))
                for k, v in tckpt.flat_from_state_dict(tree).items()}))
        (l0, arrays0), (l1, arrays1) = runs
        assert l0 == l1, (accum, l0, l1)
        for k, v in arrays0.items():
            np.testing.assert_array_equal(arrays1[k], v, err_msg=(accum, k))


def _optimizers_match_optax():
    """rmsprop, sgd and Adam with the cosine schedule (and rmsprop with a
    warmup, and sgd after the cosine's end), with the global-norm clip,
    against ``make_optimizer`` of the JAX package for 3 updates of random
    grads: the params within 1e-6 relative to the LR summed over the steps,
    the state's keypaths equal and its arrays and the params within f32
    rounding. The
    cosine schedule's LR against optax's at warmup 0, the last warmup step,
    the step where the decay ends and after it (0)."""
    rng = np.random.default_rng(71)
    shapes = {"a/kernel": (3, 4), "a/bias": (4,), "b/scale": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 3 for k, s in shapes.items()}
             for _ in range(3)]
    cases = [dict(optimizer="rmsprop"), dict(optimizer="rmsprop", lr_warmup_steps=2),
             dict(optimizer="sgd"), dict(optimizer="sgd", lr_schedule="cosine",
                                         num_train_steps=2, grad_clip=0.0),
             dict(lr_schedule="cosine", lr_warmup_steps=1, num_train_steps=3),
             dict(lr_schedule="cosine", num_train_steps=2, weight_decay=0.1)]
    for kw in cases:
        jcfg, tcfg = jft.TrainConfig(learning_rate=1e-2, **kw), tft.TrainConfig(
            learning_rate=1e-2, **kw)
        jtx = jft.make_optimizer(jcfg)
        jp = junflatten({k: jnp.asarray(v) for k, v in p0.items()})
        jst = jtx.init(jp)
        # the port's layout (kernels transposed), on copies: updated in place
        tp = tckpt.state_dict_from_flat({k: v.copy() for k, v in p0.items()})
        opt = tft.Optimizer(tcfg)
        tst = opt.init(tp)
        for g in grads:
            jg = junflatten({k: jnp.asarray(v) for k, v in g.items()})
            upd, jst = jtx.update(jg, jst, jp)
            jp = optax.apply_updates(jp, upd)
            tg = list(tckpt.state_dict_from_flat({k: v.copy() for k, v in g.items()}).values())
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tg]))
            opt.update(tg, norm, tst, list(tp.values()))
        want = jax_opt_arrays(jst)
        mine = tst.by_keypath()
        assert sorted(mine) == sorted(want), (kw, sorted(mine), sorted(want))
        for k, v in want.items():
            np.testing.assert_allclose(mine[k], v, rtol=2e-6, atol=1e-12, err_msg=(kw, k))
        tflat = tckpt.flat_from_state_dict(tp)
        for k, v in jflatten(jp).items():
            np.testing.assert_allclose(tflat[k], np.asarray(v), rtol=2e-6, atol=1e-7,
                                       err_msg=(kw, k))
    for w, total in ((0, 4), (2, 5), (3, 4)):
        sched = optax.schedules.warmup_cosine_decay_schedule(0.0, 2e-4, w, total)
        opt = tft.Optimizer(tft.TrainConfig(lr_schedule="cosine", lr_warmup_steps=w,
                                            num_train_steps=total))
        for count in sorted({0, max(w - 1, 0), w, total - 1, total, total + 3}):
            want = float(sched(count))
            assert abs(opt.learning_rate(count) - want) <= 1e-7 * 2e-4, (w, total, count)
        assert opt.learning_rate(total) == opt.learning_rate(total + 3) == 0.0
    with pytest.raises(ValueError, match="must exceed lr_warmup_steps"):
        tft.Optimizer(tft.TrainConfig(lr_schedule="cosine", lr_warmup_steps=4,
                                      num_train_steps=4))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_train_step_matches_jax(precision, tmp_path):
    """Three steps of JAX make_train_step (warmup 2, clip active, EMA on)
    against the port's step on the same params, batches, noise and t:
    losses, grad norms, the first step's grads and the optimizer's layout,
    then params and EMA; in f32 also with ``remat`` against the JAX remat
    step. The port's remat step equals its step without remat bit for bit
    (dropout 0.1, with and without accumulation over 2 micro-batches).
    f32: dropout changes the output only with a generator, ddpm_loss,
    avg_pool_2x, a KD step against JAX, the rmsprop, sgd and cosine
    optimizers against optax, and the data-parallel step on 2 gloo ranks
    against one process and the JAX 2-device mesh; bf16: the sweep's bf16
    loss against JAX."""
    cfg = junet.tiny_unet_config()
    jmodel = junet.UNet2D(cfg)
    flat = numpy_params(jmodel, 21)
    rng = np.random.default_rng(22)
    bsz = 4
    batches = [rng.uniform(-1, 1, (bsz, 16, 16, 3)).astype(np.float32) for _ in range(3)]
    for remat in (False, True) if precision == "f32" else (False,):
        draws = _step_against_jax(cfg, flat, batches, precision, remat)
    _remat_bit_identical(cfg, flat, batches, precision)

    # dropout: off without a generator, reproducible with one
    if precision == "f32":
        from diff_pruning_tpu.training.finetune import ddpm_loss as jloss

        x0, (noise, t) = batches[0], draws[0]
        with jax.default_matmul_precision("float32"):
            jl = float(jloss(jmodel, junflatten({k: jnp.asarray(v) for k, v in flat.items()}),
                             JaxSchedule.create(), jnp.asarray(x0), jnp.asarray(noise),
                             jnp.asarray(t)))
        tmodel = port_model(cfg, flat)
        with torch.no_grad():
            tl = float(tft.ddpm_loss(tmodel, DiffusionSchedule.create(), torch.from_numpy(x0),
                                     torch.from_numpy(noise), torch.from_numpy(t).long()))
            np.testing.assert_allclose(tl, jl, rtol=1e-5)
            dmodel = port_model(dataclasses.replace(cfg, dropout=0.1), flat)
            x, tt = torch.from_numpy(x0), torch.from_numpy(t).long()
            plain = tmodel(x, tt)
            assert torch.equal(dmodel(x, tt), plain)
            a = dmodel(x, tt, dropout_generator=torch.Generator().manual_seed(5))
            b = dmodel(x, tt, dropout_generator=torch.Generator().manual_seed(5))
            assert torch.equal(a, b) and not torch.allclose(a, plain, atol=1e-3)
        from diff_pruning_tpu.models.layers import avg_pool_2x as javg
        from diff_pruning_tpu_torch.models.layers import avg_pool_2x

        np.testing.assert_allclose(avg_pool_2x(x).numpy(), np.asarray(javg(jnp.asarray(x0))),
                                   rtol=1e-6, atol=1e-7)

        # KD: one step against the JAX step with the same teacher
        tflat = numpy_params(jmodel, 23)
        jtp = junflatten({k: jnp.asarray(v) for k, v in tflat.items()})
        jcfg0 = jft.TrainConfig()
        with jax.default_matmul_precision("float32"):
            js = jft.init_train_state(junflatten({k: jnp.asarray(v) for k, v in flat.items()}),
                                      jcfg0)
            _, jm = jft.make_train_step(jmodel, JaxSchedule.create(), jcfg0,
                                        teacher=(jmodel, jtp))(js, jnp.asarray(x0),
                                                               jax.random.key(100))
        student = port_model(cfg, flat)
        kstep = tft.make_train_step(student, DiffusionSchedule.create(), tft.TrainConfig(),
                                    teacher=port_model(cfg, tflat).requires_grad_(False))
        _, km = kstep(tft.init_train_state(student, tft.TrainConfig()), torch.from_numpy(x0),
                      noise=torch.from_numpy(noise), t=torch.from_numpy(t).long())
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(km[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        _optimizers_match_optax()
        _check_data_parallel_step(tmp_path)
    else:
        # the bf16 sweep loss (make_loss_fn's compute_dtype) against the JAX one
        from diff_pruning_tpu.diffpruning.sweep import make_loss_fn as jmake
        from diff_pruning_tpu_torch.diffpruning.sweep import make_loss_fn

        x0, (noise, _) = batches[0], draws[0]
        ts = np.full((bsz,), 7)
        with jax.default_matmul_precision("float32"):
            jl = float(jmake(jmodel, JaxSchedule.create(), compute_dtype=jnp.bfloat16)(
                junflatten({k: jnp.asarray(v) for k, v in flat.items()}), jnp.asarray(x0),
                jnp.asarray(noise), jnp.asarray(ts)))
        with torch.no_grad():
            tl = float(make_loss_fn(port_model(cfg, flat), DiffusionSchedule.create(),
                                    compute_dtype=torch.bfloat16)(
                torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(ts)))
        np.testing.assert_allclose(tl, jl, rtol=2e-2)  # the bf16 loss rule above

    # the first-stage autoencoder's step against the JAX step
    _ae_step_matches_jax(precision)


def _ae_step_matches_jax(precision):
    """One step of the JAX autoencoder ``step_fn`` against the port's from
    the same params and images: VQ (two levels, mid attention, LPIPS, hinge,
    BatchNorm PatchGAN) and KL (JAX's two posterior draws passed in, no
    LPIPS, vanilla loss, ActNorm PatchGAN, ``disc_start`` 1 so the GAN terms
    are off while the adaptive weight is still taken). f32: the metrics
    within 1e-4 relative, both networks' grads (Adam's first moment, 0.5 x
    the grads) within 1e-4 of each parameter's max plus 1e-6 of the largest,
    the updated params within 1e-6 + 1e-2 lr (to_k's bias, whose grad is
    zero in exact arithmetic: Adam's bound). bf16: the metrics within 2e-2
    of max(|value|, 1) (the adaptive weight: AE_BF16_DWEIGHT_RTOL), the
    grads by AE_BF16_GRAD_SLACK against the port's f32 grads (generator) and
    against the float64 discriminator pass on the port's own inputs
    (discriminator; JAX's bf16 discriminator on the same inputs, and those
    inputs against x in bf16 and JAX's bf16 reconstruction), the params
    within Adam's bound, and the VQ indices of a bf16 encode agreeing at >=
    90 % of the positions (argmin near-ties; the perplexity and the codes
    used follow them, so they are not compared in bf16)."""
    from diff_pruning_tpu.models import vae as jvae
    from diff_pruning_tpu.models.discriminator import NLayerDiscriminator as JDisc
    from diff_pruning_tpu.training import autoencoder as jae
    from diff_pruning_tpu_torch.eval.lpips import LPIPS
    from diff_pruning_tpu_torch.models.discriminator import NLayerDiscriminator
    from diff_pruning_tpu_torch.training import autoencoder as tae

    bf16 = precision == "bf16"
    mp = "bf16" if bf16 else "no"
    lr = 1e-5  # small beside bf16 steps, as the CLI's (4.5e-6 x batch): the discriminator
    # pass then sees the same updated generator on both sides
    rng = np.random.default_rng(51)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jlp = _jax_lpips()
    lp_flat = {k: np.asarray(v) for k, v in jflatten(jlp).items()}
    for kind in ("vq", "kl"):
        vq = kind == "vq"
        cfg = jvae.AutoencoderConfig(
            block_out_channels=(8, 16) if vq else (8,), layers_per_block=1, latent_channels=3,
            norm_num_groups=4, sample_size=16, num_vq_embeddings=16 if vq else None,
            vq_embed_dim=3 if vq else None, mid_block_attention=vq)
        lcfg = dict(disc_start=0 if vq else 1, kl_weight=1e-2, disc_weight=0.5,
                    perceptual_weight=1.0 if vq else 0.0, disc_loss="hinge" if vq else "vanilla")
        jm, jd = jvae.make_first_stage(cfg), JDisc(ndf=8, n_layers=2, use_actnorm=not vq)
        gflat, dflat = numpy_params(jm, 52), numpy_params(jd, 53)
        if vq:  # codes at the latents' unit scale: bf16 rounding decides few lookups
            gflat["quantize/embedding/weight"] *= 10.0
        key = jax.random.key(54)
        with jax.default_matmul_precision("float32"):
            gtx, dtx = jae.make_ae_optimizers(lr)
            jstate = jae.init_ae_train_state(
                junflatten({k: jnp.asarray(v) for k, v in gflat.items()}),
                junflatten({k: jnp.asarray(v) for k, v in dflat.items()}), gtx, dtx)
            jstep = jae.make_autoencoder_train_step(jm, jae.GANLossConfig(**lcfg),
                                                    jlp if vq else None, jd, gtx, dtx,
                                                    mixed_precision=mp)
            jstate, jm_ = jstep(jstate, jnp.asarray(x), key)
            want = {k: float(v) for k, v in jm_.items()}
        dt = jnp.bfloat16 if bf16 else jnp.float32
        noise = None if vq else tuple(
            torch.from_numpy(np.asarray(jax.random.normal(k, (2, 16, 16, 3), dt), np.float32))
            for k in (key, jax.random.fold_in(key, 1)))
        tm = tvae.make_first_stage(tvae.AutoencoderConfig.from_json(cfg.to_json()), device="cpu")
        tm.load_state_dict(tckpt.state_dict_from_flat(gflat))
        td = NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=not vq, device="cpu")
        td.load_state_dict(tckpt.state_dict_from_flat(dflat))
        tlp = None
        if vq:
            tlp = LPIPS(device="cpu")
            tlp.load_state_dict(tckpt.state_dict_from_flat(lp_flat))
        ref = None
        if bf16:  # the port's f32 step, the f32 grads (JAX's within 2e-6 in norm)
            ref = {}
            tm32, td32 = copy.deepcopy(tm), copy.deepcopy(td)
            go, do = tae.make_ae_optimizers(lr)
            st32 = tae.init_ae_train_state(tm32, td32, go, do)
            tae.make_autoencoder_train_step(tm32, tae.GANLossConfig(**lcfg), tlp, td32, go, do)(
                st32, torch.from_numpy(x), noise=noise)
            ref = {"gen": st32.gen_opt.by_keypath(), "disc": st32.disc_opt.by_keypath()}
        go, do = tae.make_ae_optimizers(lr)
        tstate = tae.init_ae_train_state(tm, td, go, do)
        seen = []  # the discriminator's inputs: the generator pass's, then x and the recon
        hook = td.register_forward_pre_hook(lambda mod, args: seen.append(args[0].detach()))
        try:
            got = tae.make_autoencoder_train_step(tm, tae.GANLossConfig(**lcfg), tlp, td, go, do,
                                                  mixed_precision=mp)(
                tstate, torch.from_numpy(x), noise=noise)
        finally:
            hook.remove()
        got = {k: float(v) for k, v in got.items()}
        assert sorted(got) == sorted(want), kind
        assert want["disc_factor"] == (1.0 if vq else 0.0) and want["d_weight"] > 0
        for k, w in want.items():
            if bf16 and k in ("perplexity", "cluster_usage"):
                continue  # of the bf16 indices: held below as a share
            if bf16 and k == "d_weight":
                assert abs(got[k] - w) <= AE_BF16_DWEIGHT_RTOL * abs(w), (kind, k, got[k], w)
            elif bf16:
                assert abs(got[k] - w) <= 2e-2 * max(abs(w), 1.0), (kind, k, got[k], w)
            else:
                np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-7, err_msg=f"{kind} {k}")
        for net, jopt, topt, jp, tp in (
                ("gen", jstate.gen_opt, tstate.gen_opt, jstate.gen_params, tstate.gen_params),
                ("disc", jstate.disc_opt, tstate.disc_opt, jstate.disc_params,
                 tstate.disc_params)):
            jarr, tarr = jax_opt_arrays(jopt), topt.by_keypath()
            assert sorted(jarr) == sorted(tarr) and int(tarr["[0].count"]) == 1, (kind, net)
            mus = [k for k in jarr if ".mu" in k]
            if not any(np.any(jarr[k]) for k in mus):  # disc_factor 0: no grad at all
                assert not any(np.any(tarr[k]) for k in mus), (kind, net)
            elif bf16 and net == "disc":
                b1 = do.cfg.adam_beta1  # Adam's first moment after one step: (1 - b1) g
                exact = _disc_grads_f64(dflat, seen[-2:], n_layers=2, actnorm=not vq)
                mine = _rel_norm({k: np.asarray(tarr[k]) / (1 - b1) for k in mus}, exact)
                theirs = _rel_norm(_jax_disc_grads_bf16(jd, dflat, seen[-2:]), exact)
                assert mine <= max(5e-2, AE_BF16_GRAD_SLACK * theirs), (kind, net, mine, theirs)
                # those inputs: x in bf16, and the reconstruction JAX's bf16 step
                # gives its discriminator (its updated generator, straight through),
                # within the bf16 floor (JAX's own bf16 reconstruction lies 2.5e-2
                # in norm from its f32 one here)
                real, fake = (t.to(torch.float32).numpy() for t in seen[-2:])
                assert seen[-2].dtype == seen[-1].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    real, np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)))
                jrecon = _jax_vq_recon_bf16(jm, jstate.gen_params, x)
                rec_off = float(np.linalg.norm(fake - jrecon) / np.linalg.norm(jrecon))
                assert rec_off <= 5e-2, (kind, net, rec_off)
            elif bf16:
                def off_f32(arr):
                    return np.sqrt(sum(((arr[k] - ref[net][k]) ** 2).sum() for k in mus)
                                   / sum((ref[net][k] ** 2).sum() for k in mus))

                mine, theirs = off_f32(tarr), off_f32(jarr)
                assert mine <= max(5e-2, AE_BF16_GRAD_SLACK * theirs), (kind, net, mine, theirs)
            else:
                floor = 1e-6 * max(np.abs(jarr[k]).max() for k in mus)
                for k in mus:
                    err = np.abs(tarr[k] - jarr[k]).max()
                    assert err <= 1e-4 * np.abs(jarr[k]).max() + floor, (kind, net, k, err)
            jflat, tflat = jflatten(jp), tckpt.flat_from_state_dict(tp)
            for k, v in jflat.items():
                err = np.abs(tflat[k] - np.asarray(v)).max()
                lim = ADAM_MOVE * lr if (bf16 or k.endswith("to_k/bias")) else 1e-6 + 1e-2 * lr
                assert err <= lim, (kind, net, k, err, lim)
        if vq and bf16:
            # the bf16 lookup: argmin near-ties may pick other codes
            jp0 = junflatten({k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in gflat.items()})
            with jax.default_matmul_precision("float32"):
                jidx = np.asarray(jm.quantize(jp0, jm.encode(jp0, jnp.asarray(x, jnp.bfloat16)))[1])
            tm.load_state_dict(tckpt.state_dict_from_flat(gflat))
            with torch.no_grad():  # the whole tree in bf16, as the step casts it
                tm16 = tm.to(torch.bfloat16)
                enc = tm16.quantize_latents(tm16.encode(torch.from_numpy(x).to(torch.bfloat16)))[1]
            share = float((enc.numpy() == jidx).mean())
            assert share >= 0.9, share


def test_train_state_crosses_packages(tmp_path):
    """A JAX train checkpoint resumes in the port (params, EMA, Adam count
    and moments, the schedule's count); the port's restores in the JAX
    package; so do rmsprop's, sgd's and the cosine schedule's states; a
    port run resumed at step 2 of 4 ends bit-identical to the uninterrupted
    run, dropout on."""
    from diff_pruning_tpu_torch.data.datasets import ArrayDataset, iterate_batches

    cfg = junet.tiny_unet_config()
    flat = numpy_params(junet.UNet2D(cfg), 31)
    jparams = junflatten({k: jnp.asarray(v) for k, v in flat.items()})
    jcfg = jft.TrainConfig(lr_warmup_steps=3)
    jstate = jft.init_train_state(jparams, jcfg)
    rng = np.random.default_rng(32)
    jgrads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
                          jparams)
    opt = jft.make_optimizer(jcfg)
    _, jopt = opt.update(jgrads, jstate.opt_state, jparams)
    _, jopt = opt.update(jgrads, jopt, jparams)
    jema = jax.tree.map(lambda a: a * 0.5, jparams)
    jckpt.save_train_state(str(tmp_path / "jax"), step=2, params=jparams, ema_params=jema,
                           opt_state=jopt, extra_meta={"seed": 7})
    meta, params, ema = tckpt.load_train_state(str(tmp_path / "jax"))
    assert meta == {"step": 2, "seed": 7}
    model = tunet.UNet2D(tunet.UNet2DConfig.from_json(cfg.to_json()), device="cpu")
    model.load_state_dict(params)
    tcfg = tft.TrainConfig(lr_warmup_steps=3)
    state = tft.init_train_state(model, tcfg)
    restored, ok = tckpt.restore_opt_state(str(tmp_path / "jax"), state.opt_state)
    assert ok and restored.count == restored.schedule_count == 2
    want = jax_opt_arrays(jopt)
    mine = restored.by_keypath()
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    for k, v in tckpt.flat_from_state_dict(ema).items():
        np.testing.assert_array_equal(v, np.asarray(jflatten(jema)[k]), err_msg=k)

    # the port's checkpoint restores in the JAX package
    tckpt.save_train_state(str(tmp_path / "port"), step=2, params=state.params,
                           ema_params=ema, opt_state=restored, extra_meta={"seed": 7})
    jrestored, ok = jckpt.restore_opt_state(str(tmp_path / "port"),
                                            jft.init_train_state(jparams, jcfg).opt_state)
    assert ok
    for k, v in jax_opt_arrays(jrestored).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    jmeta, jp, je = jckpt.load_train_state(str(tmp_path / "port"))
    assert jmeta["step"] == 2
    for k, v in jflatten(jp).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)
    with pytest.raises(KeyError, match="refusing a partial restore"):
        tft.init_train_state(model, tft.TrainConfig()).opt_state.load_by_keypath(
            {"[1][0].count": np.int32(0)})

    # the other optimizers' states after two JAX updates, both ways: rmsprop
    # with a warmup (nu, the schedule's count), sgd and Adam on the cosine
    for i, kw in enumerate((dict(optimizer="rmsprop", lr_warmup_steps=3),
                            dict(optimizer="sgd", lr_schedule="cosine"),
                            dict(lr_schedule="cosine", lr_warmup_steps=1))):
        tx = jft.make_optimizer(jft.TrainConfig(**kw))
        jo = tx.init(jparams)
        for _ in range(2):
            _, jo = tx.update(jgrads, jo, jparams)
        want = jax_opt_arrays(jo)
        jckpt.save_train_state(str(tmp_path / f"jax{i}"), step=2, params=jparams, opt_state=jo)
        st = tft.init_train_state(model, tft.TrainConfig(**kw))
        restored, ok = tckpt.restore_opt_state(str(tmp_path / f"jax{i}"), st.opt_state)
        mine = restored.by_keypath()
        assert ok and sorted(mine) == sorted(want) and restored.schedule_count == 2, kw
        for k, v in want.items():
            np.testing.assert_array_equal(mine[k], v, err_msg=(kw, k))
        tckpt.save_train_state(str(tmp_path / f"port{i}"), step=2, params=st.params,
                               opt_state=restored)
        back, ok = jckpt.restore_opt_state(str(tmp_path / f"port{i}"), tx.init(jparams))
        assert ok
        for k, v in jax_opt_arrays(back).items():
            np.testing.assert_array_equal(v, want[k], err_msg=(kw, k))

    # resume at step 2 of 4: the same batches, draws and state as uninterrupted
    cfg_d = tunet.UNet2DConfig.from_json(cfg.to_json())
    cfg_d.dropout = 0.1
    data = ArrayDataset(np.random.default_rng(33).integers(0, 256, (6, 16, 16, 3), np.uint8))
    sched = DiffusionSchedule.create()

    def run(steps, start=0, ckpt=None):
        m = tunet.UNet2D(cfg_d, device="cpu")
        m.load_state_dict(tckpt.state_dict_from_flat(flat))
        st = tft.init_train_state(m, tcfg)
        if start:
            _, p, e = tckpt.load_train_state(ckpt)
            m.load_state_dict(p)
            tckpt.restore_opt_state(ckpt, st.opt_state)
            for n, t in e.items():
                st.ema_params[n].copy_(t)
            st.step = start
        step = tft.make_train_step(m, sched, tcfg, seed=3)
        batches = iterate_batches(data, 4, seed=3, skip_batches=start)
        for i in range(start, steps):
            st, _ = step(st, torch.from_numpy(next(batches)))
            if i + 1 == 2 and not start:
                tckpt.save_train_state(ckpt, step=2, params=st.params, ema_params=st.ema_params,
                                       opt_state=st.opt_state)
        return st

    ck = str(tmp_path / "resume")
    full, resumed = run(4, ckpt=ck), run(4, start=2, ckpt=ck)
    for a, b in ((full.params, resumed.params), (full.ema_params, resumed.ema_params),
                 (full.opt_state.mu, resumed.opt_state.mu),
                 (full.opt_state.nu, resumed.opt_state.nu)):
        for n in a:
            assert torch.equal(a[n], b[n]), n
    assert (full.step, full.opt_state.count) == (resumed.step, resumed.opt_state.count) == (4, 4)

    # the autoencoder CLIs: the JAX CLI's step-2 checkpoint (of a 4-step run
    # that saved at 2 and 4) resumes in the port's CLI to step 4, which must
    # land within Adam's bound of the JAX CLI's step 4; the port's Adam
    # states restore in the JAX package by keypath
    import shutil

    from diff_pruning_tpu.cli.autoencoder_train import main as jax_ae_cli
    from diff_pruning_tpu.training.autoencoder import make_ae_optimizers as jax_ae_opts
    from diff_pruning_tpu_torch.cli import autoencoder_train

    seed_dir, imdir, lp = _ae_inputs(tmp_path)
    argv = _ae_argv(seed_dir, imdir, lp) + ["--num_iters", "4"]
    jout, pout = tmp_path / "ae_jax", tmp_path / "ae_port"
    with jax.default_matmul_precision("float32"):
        jax_ae_cli(argv + ["--output_dir", str(jout)])
    jck = tmp_path / "ae_jax_step2"
    for sub in ("gen", "disc"):
        shutil.copytree(jout / "ckpt" / sub / "step-2", jck / sub / "step-2")
        (jck / sub / "LATEST").write_text("step-2")
    stats = autoencoder_train.main(argv + ["--output_dir", str(pout), "--device", "cpu",
                                           "--resume_from_checkpoint", str(jck)])
    assert (stats["start_step"], stats["steps"]) == (2, 2)
    lr = 4.5e-6 * 2
    for sub in ("gen", "disc"):
        _, want, _ = jckpt.load_train_state(str(jout / "ckpt" / sub))
        _, got, _ = tckpt.load_train_state(str(pout / "ckpt" / sub))
        got = tckpt.flat_from_state_dict(got)
        want = {k: np.asarray(v) for k, v in jflatten(want).items()}
        assert sorted(got) == sorted(want), sub
        for k, v in want.items():
            err = np.abs(got[k] - v).max()
            assert err <= 2 * AE_ADAM_MOVE * lr, (sub, k, err)
        # the port's Adam state restores in the JAX package
        jtemplate = jax_ae_opts(lr)[0].init(jckpt.load_train_state(str(pout / "ckpt" / sub))[1])
        jrest, ok = jckpt.restore_opt_state(str(pout / "ckpt" / sub), jtemplate)
        assert ok
        with np.load(pout / "ckpt" / sub / "step-4" / "opt_state.npz") as z:
            mine = {k: z[k] for k in z.files}
        theirs = jax_opt_arrays(jrest)
        assert sorted(theirs) == sorted(mine) and theirs["[0].count"] == 4, sub
        for k, v in theirs.items():
            np.testing.assert_array_equal(v, mine[k], err_msg=k)
    jrec = json.loads((jout / "metrics.jsonl").read_text().splitlines()[-1])
    prec = json.loads((pout / "metrics.jsonl").read_text().splitlines()[-1])
    assert jrec["step"] == prec["step"] == 4
    for k in ("total_loss", "rec_loss", "quant_loss", "disc_loss"):
        np.testing.assert_allclose(prec[k], jrec[k], rtol=1e-3, atol=2e-5, err_msg=k)


def _mu_path(keypath):
    """An Adam-state keypath (``[0].mu['main']['0']['conv']['kernel']``) -> its
    flat param path (``main/0/conv/kernel``)."""
    import re

    return "/".join(re.findall(r"\['([^']+)'\]", keypath))


def _rel_norm(got, want):
    """|got - want| / |want| over flat dicts (``got`` keyed by Adam keypaths or
    by flat paths), in norm."""
    got = {_mu_path(k) if "[" in k else k: v for k, v in got.items()}
    assert sorted(got) == sorted(want)
    return float(np.sqrt(sum(((got[k] - want[k]) ** 2).sum() for k in want)
                         / sum((want[k] ** 2).sum() for k in want)))


def _disc_grads_f64(dflat, inputs, *, n_layers, actnorm):
    """The hinge loss's grads of the port's discriminator (params ``dflat``) on
    ``inputs`` (its real and fake batches), in float64 throughout, batch
    statistics too; flat JAX-layout paths."""
    from diff_pruning_tpu_torch.models import discriminator as tdisc
    from diff_pruning_tpu_torch.training.autoencoder import hinge_d_loss

    def bn64(scale, bias, x, eps=1e-5):
        var, mean = torch.var_mean(x, dim=(0, 1, 2), correction=0)
        return (x - mean) * torch.rsqrt(var + eps) * scale + bias

    d = tdisc.NLayerDiscriminator(ndf=8, n_layers=n_layers, use_actnorm=actnorm, device="cpu")
    d.load_state_dict(tckpt.state_dict_from_flat(dflat))
    d = d.double()
    real, fake = (t.to(torch.float64) for t in inputs)
    orig, tdisc._batch_stats_norm = tdisc._batch_stats_norm, bn64
    try:
        loss = hinge_d_loss(d(real), d(fake))
    finally:
        tdisc._batch_stats_norm = orig
    names = [n for n, _ in d.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in d.named_parameters()])
    return tckpt.flat_from_state_dict(dict(zip(names, grads)))


def _jax_vq_recon_bf16(jm, gen_params, x):
    """The reconstruction of ``x`` that JAX's bf16 VQ step hands its
    discriminator: the updated generator ``gen_params`` cast to bf16, the
    straight-through lookup, the decoder; f32 numpy."""
    with jax.default_matmul_precision("float32"):
        gp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), gen_params)
        z = jm.encode(gp, jnp.asarray(x, jnp.bfloat16))
        recon = jm.decode(gp, jm.quantize_train(gp, z)[0])
    return np.asarray(recon.astype(jnp.float32))


def _jax_disc_grads_bf16(jd, dflat, inputs):
    """The JAX discriminator's hinge grads in bf16 (its params cast, as its
    train step casts them) on the same ``inputs``; float64 flat arrays."""
    from diff_pruning_tpu.training.autoencoder import hinge_d_loss as jhinge

    real, fake = (jnp.asarray(t.to(torch.float32).numpy(), jnp.bfloat16) for t in inputs)

    def loss(p):
        pc = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
        return jhinge(jd(pc, real).astype(jnp.float32), jd(pc, fake).astype(jnp.float32))

    with jax.default_matmul_precision("float32"):
        g = jax.grad(loss)(junflatten({k: jnp.asarray(v) for k, v in dflat.items()}))
    return {k: np.asarray(v, np.float64) for k, v in jflatten(g).items()}


@functools.lru_cache(maxsize=1)
def _jax_lpips():
    """JAX's random LPIPS init (seed 5), made once: its eager draws take
    seconds."""
    from diff_pruning_tpu.eval.lpips import init_lpips_params

    return init_lpips_params(jax.random.key(5))


def _ae_inputs(tmp_path):
    """The autoencoder CLIs' tiny inputs: a VQ first stage (one level of 8
    channels, 4 groups, 16 codes) saved by the port, 8 PNGs of 16 x 16 and
    JAX-made random LPIPS weights as an ``.npz``."""
    from PIL import Image

    cfg = tvae.AutoencoderConfig(block_out_channels=(8,), latent_channels=4, norm_num_groups=4,
                                 num_vq_embeddings=16, mid_block_attention=False, sample_size=16)
    seed_dir = tmp_path / "ae_seed"
    tckpt.save_model(str(seed_dir), cfg, tvae.make_first_stage(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)), subfolder="first_stage")
    imdir = tmp_path / "ae_imgs"
    imdir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8), "RGB").save(
            imdir / f"{i}.png")
    lp = str(tmp_path / "lpips.npz")
    jckpt.save_params_npz(lp, _jax_lpips())
    return str(seed_dir), str(imdir), lp


def _ae_argv(seed_dir, imdir, lpips):
    return ["--model_path", seed_dir, "--dataset", imdir, "--resolution", "16",
            "--train_batch_size", "2", "--log_steps", "2", "--save_model_steps", "2",
            "--lpips", lpips, "--seed", "3", "--steps_per_dispatch", "2",
            "--disc_start", "0", "--disc_num_layers", "2"]


def _check_driver_argv(tmp_path, monkeypatch):
    """``tools/fullrun`` (``--smoke``) and ``tools/ae_validation`` (its
    defaults) make the JAX drivers' (CLI, argv) sequences, the module
    prefix swapped (``tests/_torch_drivers.py``): every CLI in the same
    order with the same flags, and fullrun's one SIGKILLed finetune at
    step 200, then its resume. Two deliberate differences: the port's
    runner adds ``--device``, and ae_validation and e2e_validation default
    ``--out`` to ``run/<name>`` inside the checkout, as the other drivers
    do, where the JAX twins write to fixed ``/tmp`` dirs that two checkouts
    would share."""
    import _torch_drivers as D
    from diff_pruning_tpu_torch.tools import ae_validation, e2e_validation

    runs = {}
    for port in (False, True):
        out = tmp_path / ("fullrun_port" if port else "fullrun_jax")
        runs[port] = D.fullrun_calls(monkeypatch, out, port)
    want, got = (D.normalised(runs[p], tmp_path / "fullrun_jax", tmp_path / "fullrun_port")
                 for p in (False, True))
    assert got == want and len(want) == 11, (got, want)
    assert [(i, c[0], c[2]) for i, c in enumerate(want) if c[2] is not None] == [
        (4, "ddpm_train", 200)]
    assert want[5][1] == want[4][1] + ["--resume_from_checkpoint", "<out>/finetuned/ckpt"]
    for port in (False, True):
        out = tmp_path / ("ae_port" if port else "ae_jax")
        runs[port] = D.ae_validation_calls(monkeypatch, out, port)
    want, got = (D.normalised(runs[p], tmp_path / "ae_jax", tmp_path / "ae_port")
                 for p in (False, True))
    assert got == want and [c[0] for c in want] == ["autoencoder_train"], (got, want)
    for mod, name, port_out in ((ae_validation, "ae_validation", "run/ae_val"),
                                (e2e_validation, "e2e_validation", "run/e2e")):
        assert mod.parse_args([]).out == port_out
        with open(os.path.join(D.REPO, "tools", f"{name}.py")) as f:  # the twin's default
            assert '"--out", type=str, default="/tmp/' in f.read(), name


def test_train_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """The train CLI end to end on the tiny config: TF32 pinned off,
    metrics.jsonl, ckpt/ (two versions kept), unet/ and unet_ema/ that the
    JAX package loads, vis grids, run.sh; a resume with another seed warns;
    --remat takes the same steps bit for bit; --device cuda without a GPU
    raises. The fullrun and ae_validation drivers make the JAX drivers'
    CLI calls (``_check_driver_argv``)."""
    from diff_pruning_tpu_torch.cli import ddpm_train

    cfg = tunet.tiny_unet_config()
    model = tunet.UNet2D(cfg, device="cpu").init(torch.Generator().manual_seed(41))
    tckpt.save_model(str(tmp_path / "in"), cfg, model)
    data = np.random.default_rng(42).integers(0, 256, (8, 16, 16, 3), dtype=np.uint8)
    np.savez(tmp_path / "data.npz", images=data)
    out = tmp_path / "out"
    base = ["--model_path", str(tmp_path / "in"), "--output_dir", str(out),
            "--dataset", str(tmp_path / "data.npz"), "--train_batch_size", "4",
            "--num_iters", "4", "--save_model_steps", "2", "--log_steps", "2",
            "--vis_samples", "4", "--steps_per_dispatch", "8"]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    stats = ddpm_train.main(base + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert "torch.backends.cudnn.allow_tf32=False" in text
    assert stats["steps"] == 4 and all(np.isfinite(stats["losses"]))
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [2, 4]
    assert recs[-1]["loss"] == pytest.approx(stats["losses"][-1])
    assert sorted(os.listdir(out / "ckpt")) == ["LATEST", "step-2", "step-4"]
    assert sorted(os.listdir(out / "vis")) == ["iter-2.png", "iter-4.png"]
    assert (out / "run.sh").read_text().startswith(
        "python -m diff_pruning_tpu_torch.cli.ddpm_train --model_path")
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(out / "logs"))
    _, params, ema = tckpt.load_train_state(str(out / "ckpt"))
    for sub, want in (("unet", params), ("unet_ema", ema)):
        jcfg, jparams = jckpt.load_model(str(out), subfolder=sub)
        junet.UNet2D(jcfg).graph.validate(jparams)
        for k, v in tckpt.flat_from_state_dict(want).items():
            np.testing.assert_array_equal(np.asarray(jflatten(jparams)[k]), v, err_msg=k)
    resumed = ddpm_train.main(base + ["--device", "cpu", "--seed", "1",
                                      "--resume_from_checkpoint", str(out / "ckpt")])
    text = capsys.readouterr().out
    assert (resumed["start_step"], resumed["steps"]) == (4, 0)
    assert "warning: resuming with seed 1" in text and "optimizer state restored" in text
    # --remat: the same 2 steps (dropout 0.1), bit for bit
    remat = ddpm_train.main(base + ["--device", "cpu", "--remat", "--num_iters", "2",
                                    "--output_dir", str(tmp_path / "remat")])
    assert remat["losses"] == stats["losses"][:2]
    for f in ("params.npz", "ema_params.npz", "opt_state.npz"):
        with np.load(out / "ckpt" / "step-2" / f) as a, \
                np.load(tmp_path / "remat" / "ckpt" / "step-2" / f) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{f}/{k}")

    # --multihost on 2 gloo ranks against one process, dropout 0: the same
    # losses and weights; rank 0 alone writes metrics.jsonl (once per log)
    import _torch_dp

    dp = ["--model_path", str(tmp_path / "in"), "--dataset", str(tmp_path / "data.npz"),
          "--train_batch_size", "4", "--num_iters", "2", "--save_model_steps", "2",
          "--log_steps", "1", "--vis_samples", "4", "--dropout", "0"]
    one = ddpm_train.main(dp + ["--output_dir", str(tmp_path / "dp1"), "--device", "cpu"])
    outs = _torch_dp.cli_ranks("ddpm_train", dp + ["--output_dir", str(tmp_path / "dp2")])
    assert all("data mesh: 2 processes" in o for o in outs)
    recs = [json.loads(line) for line in (tmp_path / "dp2" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    np.testing.assert_allclose([r["loss"] for r in recs], one["losses"], rtol=DP_RTOL)
    assert sorted(os.listdir(tmp_path / "dp2" / "ckpt")) == ["LATEST", "step-2"]
    _, p1, e1 = tckpt.load_train_state(str(tmp_path / "dp1" / "ckpt"))
    _, p2, e2 = tckpt.load_train_state(str(tmp_path / "dp2" / "ckpt"))
    lr = tft.TrainConfig().learning_rate
    for name, a, b in (("params", p2, p1), ("ema", e2, e1)):
        _close_params(tckpt.flat_from_state_dict(a), tckpt.flat_from_state_dict(b), 2 * lr,
                      f"train CLI {name}: 2 ranks against 1 process")
    with pytest.raises(AssertionError, match="divisible by the world size 2"):
        _torch_dp.cli_ranks("ddpm_train", dp[:5] + ["3"] + dp[6:] + [
            "--output_dir", str(tmp_path / "dp3")])
    with pytest.raises(SystemExit, match="4 rows a process, not divisible by "
                       "--gradient_accumulation_steps 3"):
        ddpm_train.main(dp + ["--output_dir", str(tmp_path / "dp4"), "--device", "cpu",
                              "--gradient_accumulation_steps", "3"])

    # the autoencoder CLI: 4 steps straight against 2 and a resume to 4,
    # bit-identical; then a tiny KL codec in bf16 with the vanilla loss
    from diff_pruning_tpu_torch.cli import autoencoder_train

    seed_dir, imdir, lp = _ae_inputs(tmp_path)
    ae = _ae_argv(seed_dir, imdir, lp) + ["--device", "cpu"]
    runs = {}
    for name, iters, extra in (("straight", 4, []), ("a", 2, []),
                               ("b", 4, ["--resume_from_checkpoint", str(tmp_path / "a" / "ckpt")])):
        runs[name] = autoencoder_train.main(ae + ["--output_dir", str(tmp_path / name),
                                                  "--num_iters", str(iters)] + extra)
    text = capsys.readouterr().out
    assert "resumed from step 2 (optimizers restored)" in text
    assert runs["b"]["start_step"] == 2 and runs["b"]["losses"] == runs["straight"]["losses"][2:]
    assert all(np.isfinite(runs["straight"]["losses"]))
    for sub in ("ckpt/gen/step-4", "ckpt/disc/step-4", "first_stage"):
        for f in os.listdir(tmp_path / "straight" / sub):
            if f.endswith(".npz"):
                with np.load(tmp_path / "straight" / sub / f) as a, \
                        np.load(tmp_path / "b" / sub / f) as b:
                    assert sorted(a.files) == sorted(b.files)
                    for k in a.files:
                        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{sub}/{f}/{k}")
    recs = [json.loads(line) for line in (tmp_path / "straight" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in recs] == [2, 4]
    assert set(recs[0]) == {"step", "total_loss", "nll_loss", "rec_loss", "d_weight",
                            "disc_factor", "g_loss", "quant_loss", "perplexity",
                            "cluster_usage", "disc_loss", "logits_real", "logits_fake",
                            "imgs_per_sec"}
    assert sorted(os.listdir(tmp_path / "straight" / "ckpt" / "gen")) == [
        "LATEST", "step-2", "step-4"]
    assert (tmp_path / "straight" / "run.sh").read_text().startswith(
        "python -m diff_pruning_tpu_torch.cli.autoencoder_train --model_path")
    kl_cfg = tvae.AutoencoderConfig(block_out_channels=(8,), latent_channels=2, norm_num_groups=4,
                                    sample_size=16, mid_block_attention=False)
    tckpt.save_model(str(tmp_path / "kl"), kl_cfg, tvae.make_first_stage(kl_cfg, device="cpu")
                     .init(torch.Generator().manual_seed(4)), subfolder="first_stage")
    kl = autoencoder_train.main(_ae_argv(str(tmp_path / "kl"), imdir, "random") + [
        "--output_dir", str(tmp_path / "kl_out"), "--num_iters", "2", "--disc_loss", "vanilla",
        "--mixed_precision", "bf16", "--device", "cpu"])
    assert kl["steps"] == 2 and all(np.isfinite(kl["losses"])) and kl["last"]["kl_loss"] > 0
    with pytest.raises(SystemExit, match="disc_num_layers"):
        autoencoder_train.main(_ae_argv(seed_dir, imdir, "off")[:-2] + [
            "--output_dir", str(tmp_path / "x"), "--device", "cpu"])

    # the recipe drivers make the JAX drivers' CLI calls
    _check_driver_argv(tmp_path, monkeypatch)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ddpm_train.main(base)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # NCCL needs the card
        ddpm_train.main(base + ["--multihost", "--coordinator_address", "127.0.0.1:1",
                                "--num_processes", "1", "--process_id", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autoencoder_train.main(ae[:-2] + ["--output_dir", str(tmp_path / "y")])
