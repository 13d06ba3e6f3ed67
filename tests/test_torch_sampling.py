"""The port's schedulers, DDIM sampler and sampling CLI against the JAX package.

Noise and initial samples are made once and handed to both packages (the
two random-number streams differ by design).

Tolerances:
- one DDIM/DDPM step, f32: atol = rtol = 1e-6; the same f32 formulas
  evaluated in the same order.
- a 5-step trajectory on the tiny UNet, images in [0, 1]: atol 5e-5; each
  step carries the UNet's sum-order differences (a few 1e-6, see
  tests/test_torch_unet.py) through the DDIM update.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diff_pruning_tpu.models import unet2d as junet
from diff_pruning_tpu.pruning.surgery import unflatten_params
from diff_pruning_tpu.sampling import ddim_sampler as jsampler
from diff_pruning_tpu.schedulers import ddim as jddim
from diff_pruning_tpu.schedulers.ddpm import DiffusionSchedule as JaxSchedule
from diff_pruning_tpu_torch.cli import ddpm_sample
from diff_pruning_tpu_torch.sampling import ddim_sampler as tsampler
from diff_pruning_tpu_torch.sampling.distributed import sample_many
from diff_pruning_tpu_torch.schedulers import ddim as tddim
from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule as TorchSchedule
from diff_pruning_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)


def _check_timestep_grids():
    for style in ("diffusers", "ddim_exp"):
        for skip in ("uniform", "quad"):
            ts = tddim.ddim_timesteps(100, 1000, skip, style=style)
            np.testing.assert_array_equal(ts, jddim.ddim_timesteps(100, 1000, skip, style=style))
            for stride in (False, True):
                np.testing.assert_array_equal(
                    tddim.ddim_prev_timesteps(ts, 1000, diffusers_stride=stride),
                    jddim.ddim_prev_timesteps(ts, 1000, diffusers_stride=stride))
    js, ts_ = JaxSchedule.create(), TorchSchedule.create()
    np.testing.assert_array_equal(ts_.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    idx = np.array([-1, 0, 999])
    np.testing.assert_array_equal(ts_.alpha_bar(torch.from_numpy(idx)).numpy(),
                                  np.asarray(js.alpha_bar(jnp.asarray(idx))))


def test_step_matches_jax():
    """The DDIM/DDPM timestep grids and the schedule's tables, then one DDIM
    (clipped, eta > 0) and one DDPM step, against the JAX package."""
    _check_timestep_grids()
    for kind in ("ddim-clip", "ddim-eta", "ddpm"):
        _check_step(kind)


def _check_step(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    z = rng.standard_normal(x.shape).astype(np.float32)
    js, ts_ = JaxSchedule.create(), TorchSchedule.create()
    # per-sample (B,) timesteps, including the final step's t_prev = -1
    t = np.array([980, 500, 10], np.int32)
    tp = np.array([970, 490, -1], np.int32)
    jx, jeps, jz = jnp.asarray(x), jnp.asarray(eps), jnp.asarray(z)
    tx, teps, tz = torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(z)
    tt, ttp = torch.from_numpy(t).long(), torch.from_numpy(tp).long()
    if kind == "ddpm":
        want = jddim.ddpm_step(js, jx, jeps, jnp.asarray(t), jnp.asarray(tp), jz)
        got = tddim.ddpm_step(ts_, tx, teps, tt, ttp, tz)
        want_s = jddim.ddpm_step(js, jx, jeps, jnp.int32(0), jnp.int32(-1), jz)
        got_s = tddim.ddpm_step(ts_, tx, teps, 0, -1, tz)
    else:
        kw = dict(eta=0.5) if kind == "ddim-eta" else dict(clip_sample=True)
        want = jddim.ddim_step(js, jx, jeps, jnp.asarray(t), jnp.asarray(tp), noise=jz, **kw)
        got = tddim.ddim_step(ts_, tx, teps, tt, ttp, noise=tz, **kw)
        want_s = jddim.ddim_step(js, jx, jeps, jnp.int32(500), jnp.int32(490), noise=jz, **kw)
        got_s = tddim.ddim_step(ts_, tx, teps, 500, 490, noise=tz, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6,
                               err_msg=kind)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6, rtol=1e-6,
                               err_msg=kind)


def _tiny_checkpoint(seed):
    from diff_pruning_tpu_torch.models.unet2d import UNet2D, tiny_unet_config

    cfg = tiny_unet_config()
    return cfg, UNet2D(cfg, device="cpu").init(torch.Generator().manual_seed(seed))


def test_ddim_trajectory_matches_jax():
    cfg, model = _tiny_checkpoint(0)
    flat = tckpt.flat_from_state_dict(model.state_dict())
    jmodel = junet.UNet2D(junet.UNet2DConfig.from_json(cfg.to_json()))
    jparams = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    scfg = dict(num_inference_steps=5)
    key = jax.random.key(3)
    with jax.default_matmul_precision("float32"):
        want = jsampler.make_sampler(jmodel, jparams, JaxSchedule.create(),
                                     jsampler.SamplerConfig(**scfg))(key, 2, 16, 3)
    # the JAX sampler's own initial noise (ddim_sampler.py: split, then normal)
    x_T = jax.random.normal(jax.random.split(key)[1], (2, 16, 16, 3))
    sample = tsampler.make_sampler(model.eval(), TorchSchedule.create(),
                                   tsampler.SamplerConfig(**scfg))
    got = sample(None, 2, 16, 3, x_T=torch.from_numpy(np.array(x_T)))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    # the kinds whose wiring is not ported yet raise, naming the ROADMAP item
    for kind in ("plms", "dpm"):
        with pytest.raises(NotImplementedError, match="item 4b"):
            tsampler.make_sampler(model, TorchSchedule.create(),
                                  tsampler.SamplerConfig(kind=kind))


def test_cli_writes_pngs_on_cpu_and_refuses_missing_gpu(tmp_path, monkeypatch):
    cfg, model = _tiny_checkpoint(1)
    tckpt.save_model(str(tmp_path / "ckpt"), cfg, model)
    out = tmp_path / "samples"
    args = ["--model_path", str(tmp_path / "ckpt"), "--output_dir", str(out),
            "--total_samples", "5", "--batch_size", "2", "--ddim_steps", "3"]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    stats = ddpm_sample.main(args + ["--device", "cpu"])
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert sorted(os.listdir(out)) == [f"{i:06d}.png" for i in range(5)]
    assert stats["images"] == 5 and stats["nonfinite"] == 0
    assert stats["params"] == sum(p.numel() for p in model.parameters())
    # without an outdir, sample_many returns exactly total_images rows
    batches = iter([torch.zeros(2, 4, 4, 3), torch.ones(2, 4, 4, 3), torch.full((2, 4, 4, 3), 0.5)])
    arr = sample_many(lambda *a: next(batches), generator=None, total_images=5,
                      batch_size=2, hw=4)
    np.testing.assert_array_equal(arr[:, 0, 0, 0], [0, 0, 1, 1, 0.5])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ddpm_sample.main(args + ["--device", "cuda"])
