"""Float64 witnesses for two CPU checks of the port against the JAX
package, printed (a probe, not a test).

    JAX_PLATFORMS=cpu python cpu_witness_probe.py

1. The clipped DDIM, PLMS and DPM-Solver++ trajectories of
   ``tests/test_torch_sampling.py::test_ddim_trajectory_matches_jax``: the
   port's (its own UNet) and JAX's max distance from a float64 witness
   (``_sample_f64``: the port's sampler, UNet and schedule in float64) and
   from each other, then the port's loops on the JAX UNet's eps (the check
   the test makes) against JAX.
2. The bf16 autoencoder step of ``tests/test_torch_training.py``'s vq case:
   the discriminator's Adam moments of each package against the port's f32
   step, then against the float64 discriminator pass on the inputs the
   port's bf16 pass saw (the check the test makes), those inputs' fake half
   against JAX's bf16 reconstruction, and the spread of the first figures
   over one-bf16-ulp nudges of the images.
"""

import os
import sys

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_ROOT, "tests"))
sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_sampling as S  # noqa: E402
import test_torch_training as T  # noqa: E402


class _Float64Torch:
    """``torch`` with ``float32`` meaning ``float64``: put in place of the
    solvers' module-level ``torch``, their f32 casts keep float64."""

    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


def _sample_f64(model, scfg, x_T, monkeypatch):
    """The port's own sampler (``make_sampler`` with ``scfg``) on ``model`` in
    float64 throughout: the UNet's GroupNorm, attention and timestep
    embedding too (their f32 versions monkeypatched), the solvers' f32 casts
    kept in float64, the schedule's f32 constants widened. Images in [0, 1]:
    the f32 runs' witness."""
    import copy
    import math

    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.sampling import ddim_sampler as tsampler
    from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule as TorchSchedule
    from diff_pruning_tpu_torch.models import layers as tlayers
    from diff_pruning_tpu_torch.models import unet2d as tunet2d
    from diff_pruning_tpu_torch.schedulers import ddim as tddim_mod
    from diff_pruning_tpu_torch.schedulers import dpm_solver as tdpm_mod
    from diff_pruning_tpu_torch.schedulers import plms as tplms_mod

    def group_norm64(x, scale, bias, *, groups, eps=1e-6, with_silu=False):
        b, c = x.shape[0], x.shape[-1]
        xd = x.reshape(b, -1, groups, c // groups)
        mean = xd.mean(dim=(1, 3), keepdim=True)
        var = ((xd - mean) ** 2).mean(dim=(1, 3), keepdim=True)
        y = ((xd - mean) / torch.sqrt(var + eps)).reshape(b, -1, c) * scale + bias
        return (y * torch.sigmoid(y) if with_silu else y).reshape(x.shape)

    def attention64(q, k, v, scale):
        return torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1) @ v

    def timestep_embedding64(t, dim, flip_sin_to_cos=False, downscale_freq_shift=1.0,
                             scale=1.0, max_period=10000):
        half = dim // 2
        freq = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float64)
                         / (half - downscale_freq_shift))
        emb = scale * t.to(torch.float64)[:, None] * freq[None, :]
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
        return torch.cat([emb[:, half:], emb[:, :half]], dim=-1) if flip_sin_to_cos else emb

    m64 = copy.deepcopy(model).double()
    with monkeypatch.context() as mp:
        mp.setattr(tlayers, "group_norm_reference", group_norm64)
        mp.setattr(tlayers, "reference_attention", attention64)
        mp.setattr(tunet2d, "get_timestep_embedding", timestep_embedding64)
        for mod in (tsampler, tddim_mod, tdpm_mod, tplms_mod):
            mp.setattr(mod, "torch", _Float64Torch())
        ops.set_kernels_enabled(False)
        try:
            out = tsampler.make_sampler(m64, TorchSchedule.create(), tsampler.SamplerConfig(
                **scfg))(None, x_T.shape[0], x_T.shape[1], x_T.shape[3], x_T=x_T)
        finally:
            ops.set_kernels_enabled(True)
    assert out.dtype == torch.float64
    return out


def trajectories():
    cfg, model = S._tiny_checkpoint(0)
    model.eval()
    flat = S.tckpt.flat_from_state_dict(model.state_dict())
    jmodel = S.junet.UNet2D(S.junet.UNet2DConfig.from_json(cfg.to_json()))
    jparams = S.unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    key = jax.random.key(3)
    x_T = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[1], (2, 16, 16, 3))))
    mp = pytest.MonkeyPatch()
    for kind in ("ddim", "plms", "dpm"):
        scfg = dict(num_inference_steps=5, kind=kind, clip_sample=True)
        with jax.default_matmul_precision("float32"):
            want = np.asarray(S.jsampler.make_sampler(jmodel, jparams, S.JaxSchedule.create(),
                                                      S.jsampler.SamplerConfig(**scfg))(
                key, 2, 16, 3))
        got = S.tsampler.make_sampler(model, S.TorchSchedule.create(), S.tsampler.SamplerConfig(
            **scfg))(None, 2, 16, 3, x_T=x_T).numpy()
        ref = _sample_f64(model, scfg, x_T, mp).numpy()
        print(f"clipped {kind}: port - f64 {np.abs(got - ref).max():.3g}, JAX - f64 "
              f"{np.abs(want - ref).max():.3g}, port - JAX {np.abs(got - want).max():.3g} "
              "(atol 5e-5)")
        jeps = S._jax_eps(jmodel, jparams)
        got = S.tsampler.make_sampler(jeps, S.TorchSchedule.create(), S.tsampler.SamplerConfig(
            **scfg))(None, 2, 16, 3, x_T=x_T).numpy()
        print(f"clipped {kind} on the JAX UNet's eps: port - JAX {np.abs(got - want).max():.3g}")


def discriminator():
    from diff_pruning_tpu.models import vae as jvae
    from diff_pruning_tpu.models.discriminator import NLayerDiscriminator as JDisc
    from diff_pruning_tpu.training import autoencoder as jae
    from diff_pruning_tpu_torch.eval.lpips import LPIPS
    from diff_pruning_tpu_torch.models import vae as tvae
    from diff_pruning_tpu_torch.models.discriminator import NLayerDiscriminator
    from diff_pruning_tpu_torch.training import autoencoder as tae

    lr = 1e-5
    x = np.random.default_rng(51).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    lp_flat = {k: np.asarray(v) for k, v in T.jflatten(T._jax_lpips()).items()}
    cfg = jvae.AutoencoderConfig(block_out_channels=(8, 16), layers_per_block=1,
                                 latent_channels=3, norm_num_groups=4, sample_size=16,
                                 num_vq_embeddings=16, vq_embed_dim=3, mid_block_attention=True)
    lcfg = dict(disc_start=0, kl_weight=1e-2, disc_weight=0.5, perceptual_weight=1.0,
                disc_loss="hinge")
    jm, jd = jvae.make_first_stage(cfg), JDisc(ndf=8, n_layers=2, use_actnorm=False)
    gflat, dflat = T.numpy_params(jm, 52), T.numpy_params(jd, 53)
    gflat["quantize/embedding/weight"] *= 10.0

    def jax_mu(xx):
        with jax.default_matmul_precision("float32"):
            gtx, dtx = jae.make_ae_optimizers(lr)
            st = jae.init_ae_train_state(T.junflatten({k: jnp.asarray(v) for k, v in gflat.items()}),
                                         T.junflatten({k: jnp.asarray(v) for k, v in dflat.items()}),
                                         gtx, dtx)
            st, _ = jae.make_autoencoder_train_step(jm, jae.GANLossConfig(**lcfg), T._jax_lpips(),
                                                    jd, gtx, dtx, mixed_precision="bf16")(
                st, jnp.asarray(xx), jax.random.key(54))
        return T.jax_opt_arrays(st.disc_opt)

    def port_mu(xx, mp):
        tm = tvae.make_first_stage(tvae.AutoencoderConfig.from_json(cfg.to_json()), device="cpu")
        tm.load_state_dict(T.tckpt.state_dict_from_flat(gflat))
        td = NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=False, device="cpu")
        td.load_state_dict(T.tckpt.state_dict_from_flat(dflat))
        tlp = LPIPS(device="cpu")
        tlp.load_state_dict(T.tckpt.state_dict_from_flat(lp_flat))
        go, do = tae.make_ae_optimizers(lr)
        st = tae.init_ae_train_state(tm, td, go, do)
        seen = []
        hook = td.register_forward_pre_hook(lambda mod, args: seen.append(args[0].detach()))
        tae.make_autoencoder_train_step(tm, tae.GANLossConfig(**lcfg), tlp, td, go, do,
                                        mixed_precision=mp)(st, torch.from_numpy(xx))
        hook.remove()
        return st.disc_opt.by_keypath(), seen[-2:], do.cfg.adam_beta1

    def off(a, ref):
        mus = [k for k in ref if ".mu" in k]
        return float(np.sqrt(sum(((a[k] - ref[k]) ** 2).sum() for k in mus)
                             / sum((ref[k] ** 2).sum() for k in mus)))

    ref, _, _ = port_mu(x, "no")
    got, seen, b1 = port_mu(x, "bf16")
    print(f"bf16 discriminator moments against the port's f32 step (the old check): port "
          f"{off(got, ref):.4f}, JAX {off(jax_mu(x), ref):.4f}")
    exact = T._disc_grads_f64(dflat, seen, n_layers=2, actnorm=False)
    mine = T._rel_norm({k: np.asarray(v) / (1 - b1) for k, v in got.items() if ".mu" in k}, exact)
    theirs = T._rel_norm(T._jax_disc_grads_bf16(jd, dflat, seen), exact)
    print(f"on the port's discriminator inputs against float64 (the check now): port "
          f"{mine:.4f}, JAX's bf16 discriminator {theirs:.4f}")
    with jax.default_matmul_precision("float32"):
        gp = T.junflatten({k: jnp.asarray(v) for k, v in gflat.items()})
        r32 = np.asarray(jm.decode(gp, jm.quantize_train(gp, jm.encode(gp, jnp.asarray(x)))[0]))
    r16 = T._jax_vq_recon_bf16(jm, gp, x)
    fake = seen[-1].to(torch.float32).numpy()
    print("the discriminator's fake input, in norm: port bf16 - JAX bf16 reconstruction "
          f"(initial generator) {np.linalg.norm(fake - r16) / np.linalg.norm(r16):.4f}; "
          f"JAX bf16 - f32 {np.linalg.norm(r16 - r32) / np.linalg.norm(r32):.4f}")
    xb = jnp.asarray(x, jnp.bfloat16)
    up = np.asarray(jnp.nextafter(xb, jnp.asarray(2.0, jnp.bfloat16)).astype(jnp.float32))
    down = np.asarray(jnp.nextafter(xb, jnp.asarray(-2.0, jnp.bfloat16)).astype(jnp.float32))
    for i in range(1, 6):
        xx = np.where(np.random.default_rng(100 + i).random(x.shape) < 0.5, up, down)
        xx = xx.astype(np.float32)
        print(f"nudge {i} (one bf16 ulp): the f32 step moves {off(port_mu(xx, 'no')[0], ref):.4f}; "
              f"against the unnudged f32 step, port bf16 {off(port_mu(xx, 'bf16')[0], ref):.4f}, "
              f"JAX bf16 {off(jax_mu(xx), ref):.4f}", flush=True)


if __name__ == "__main__":
    trajectories()
    discriminator()
