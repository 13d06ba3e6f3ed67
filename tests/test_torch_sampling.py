"""The port's schedulers, DDIM sampler and sampling CLI against the JAX package.

Noise and initial samples are made once and handed to both packages (the
two random-number streams differ by design).

Tolerances:
- one DDIM/DDPM step, f32: atol = rtol = 1e-6; the same f32 formulas
  evaluated in the same order.
- a 5-step trajectory on the tiny UNet, images in [0, 1]: atol 5e-5; each
  step carries the UNet's sum-order differences (a few 1e-6, see
  tests/test_torch_unet.py) through the DDIM update. So the port's loops
  get the JAX UNet's eps (``_jax_eps``) and are held to JAX's at atol 5e-5,
  clipped or not: on some CPUs the UNets' sum-order differences alone put
  single clipped pixels 7e-5 to 9e-5 apart.
- unclipped trajectories: at t near 999 the x0 prediction divides eps's
  differences by sqrt(alpha_bar) ~ 0.0064, and a random UNet's unclipped
  samples carry that to the output (DDIM's own: 3e-4 with the port's UNet).
  The port's own UNet through the loops is held to a relative error in norm
  of 1e-5 (tests/test_torch_ldm.py's trajectory tolerance).
"""

import copy
import json
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


def _jax_eps(jmodel, jparams):
    """The JAX UNet as a model of the port's samplers: the port's loops then
    get the same eps as the JAX ones (see the module docstring)."""
    with jax.default_matmul_precision("float32"):
        fn = jax.jit(lambda x, t: jmodel(jparams, x, t))

    def model(x, t, labels=None):
        with jax.default_matmul_precision("float32"):
            return torch.from_numpy(np.array(fn(jnp.asarray(x.numpy()),
                                                jnp.asarray(t.numpy(), jnp.int32))))

    return model


def test_ddim_trajectory_matches_jax():
    """DDIM, PLMS and DPM-Solver++ trajectories through make_sampler (clip_sample
    on and off), DPM-Solver++'s raw latents through the scheduler, and
    sample_trajectory and sample_interpolation, against the JAX package from
    the noise the JAX functions draw."""
    cfg, model = _tiny_checkpoint(0)
    model.eval()
    flat = tckpt.flat_from_state_dict(model.state_dict())
    jmodel = junet.UNet2D(junet.UNet2DConfig.from_json(cfg.to_json()))
    jparams = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    jeps = _jax_eps(jmodel, jparams)
    js, ts_ = JaxSchedule.create(), TorchSchedule.create()
    key = jax.random.key(3)
    # the JAX sampler's own initial noise (ddim_sampler.py: split, then normal)
    x_T = jax.random.normal(jax.random.split(key)[1], (2, 16, 16, 3))
    tx_T = torch.from_numpy(np.array(x_T))
    for kind, clip in (("ddim", True), ("plms", True), ("dpm", True), ("plms", False),
                       ("dpm", False)):
        scfg = dict(num_inference_steps=5, kind=kind, clip_sample=clip)
        with jax.default_matmul_precision("float32"):
            want = jsampler.make_sampler(jmodel, jparams, js,
                                         jsampler.SamplerConfig(**scfg))(key, 2, 16, 3)
        for m in ((jeps, model) if clip else (jeps,)):
            got = tsampler.make_sampler(m, ts_, tsampler.SamplerConfig(**scfg))(
                None, 2, 16, 3, x_T=tx_T)
            assert got.shape == (2, 16, 16, 3)
            if m is jeps:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0,
                                           err_msg=f"{kind} clip_sample={clip}")
            else:
                w = np.asarray(want)
                assert np.linalg.norm(got.numpy() - w) <= 1e-5 * np.linalg.norm(w), (kind, clip)
    # DPM-Solver++(2M)'s raw latents, straight through the schedulers
    from diff_pruning_tpu.schedulers import dpm_solver as jdpm
    from diff_pruning_tpu_torch.schedulers import dpm_solver as tdpm

    steps = jddim.ddim_timesteps(5, 1000, "uniform")
    prev = jddim.ddim_prev_timesteps(steps)
    for clip in (False, True):
        with jax.default_matmul_precision("float32"):
            want = jdpm.dpm_solver_sample(
                lambda x, t: jmodel(jparams, x, jnp.full((2,), t, jnp.int32)), js, x_T,
                jnp.asarray(steps, jnp.int32), jnp.asarray(prev, jnp.int32), clip_sample=clip)
        got = tdpm.dpm_solver_sample(
            lambda x, t: jeps(x, torch.full((2,), t, dtype=torch.int64)), ts_, tx_T,
            steps, prev, clip_sample=clip)
        # the raw latents (unclipped ones reach |x| ~ 50 here): relative error in
        # norm, as tests/test_torch_ldm.py holds trajectories; then as images
        want = np.asarray(want, np.float64)
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-5, (clip, rel)
        np.testing.assert_allclose((got / 2 + 0.5).clamp(0, 1).numpy(),
                                   np.clip(want / 2 + 0.5, 0, 1), atol=5e-5, rtol=0,
                                   err_msg=f"dpm clip_sample={clip}")
    # every state of a trajectory, and the slerp interpolants, from the JAX
    # draws; both never clip: the JAX UNet's eps to 5e-5, the port's own UNet
    # by relative error in norm
    from diff_pruning_tpu.sampling import trajectories as jtraj
    from diff_pruning_tpu_torch.sampling import trajectories as ttraj

    with jax.default_matmul_precision("float32"):
        want = jtraj.sample_trajectory(jmodel, jparams, js, key=key, batch_size=2, hw=16,
                                       num_inference_steps=4)
        want_i = jtraj.sample_interpolation(jmodel, jparams, js, key=key, hw=16, n_alphas=5,
                                            num_inference_steps=4)
    k1, k2, _ = jax.random.split(key, 3)
    z1, z2 = (torch.from_numpy(np.array(jax.random.normal(k, (16, 16, 3)))) for k in (k1, k2))
    x0 = torch.from_numpy(np.array(jax.random.normal(key, (2, 16, 16, 3))))
    for m in (jeps, model):
        got = ttraj.sample_trajectory(m, ts_, batch_size=2, hw=16, num_inference_steps=4,
                                      x_T=x0)
        got_i = ttraj.sample_interpolation(m, ts_, hw=16, n_alphas=5, num_inference_steps=4,
                                           z1=z1, z2=z2)
        assert got.shape == (5, 2, 16, 16, 3) and got_i.shape == (5, 16, 16, 3)
        for g, w in ((got, want), (got_i, want_i)):
            w = np.asarray(w)
            if m is jeps:
                np.testing.assert_allclose(g.numpy(), w, atol=5e-5, rtol=0)
            else:
                assert np.linalg.norm(g.numpy() - w) <= 1e-5 * np.linalg.norm(w)
    alphas = np.linspace(0, 1, 4).astype(np.float32)
    np.testing.assert_allclose(
        ttraj.slerp(z1, z2, torch.from_numpy(alphas)).numpy(),
        np.asarray(jtraj.slerp(jnp.asarray(z1.numpy()), jnp.asarray(z2.numpy()),
                               jnp.asarray(alphas))), atol=1e-6, rtol=1e-6)
    # the deterministic solvers refuse eta > 0, as the JAX sampler does
    for kind in ("plms", "dpm"):
        with pytest.raises(ValueError, match="eta == 0"):
            tsampler.make_sampler(model, ts_, tsampler.SamplerConfig(kind=kind, eta=0.5))


def jax_tp_axes(jgraph, flat, model_size):
    """The JAX ``tp_param_shardings`` of JAX-layout ``flat`` params over a
    (8 // model_size) x model_size mesh of the test's 8 CPU devices, as
    the sharded axis of each param or None."""
    from jax.sharding import PartitionSpec as P

    from diff_pruning_tpu.parallel.mesh import make_mesh
    from diff_pruning_tpu.parallel.tp import tp_param_shardings
    from diff_pruning_tpu.pruning.surgery import flatten_params

    mesh = make_mesh((("data", 8 // model_size), ("model", model_size)))
    specs = flatten_params(tp_param_shardings(jgraph, unflatten_params(flat), mesh))
    return {k: None if s.spec == P() else list(s.spec).index("model") for k, s in specs.items()}


def _check_tensor_parallel(tmp_path, cfg, model):
    """parallel/tp.py: the plan equals the JAX tp_param_shardings, path by
    path, on tests/test_tp_sharding.py's tiny UNet2D (model axis 4) and on
    its magnitude-pruned variant, whose sizes stop dividing 8 (axis 8: the
    graceful degradation to replicated); then over 2 gloo ranks on one model
    axis, the tiny UNet's forward and make_sampler (DDIM eta 1, PLMS) with
    tensor_parallel against the replicated port at JAX's 2e-5
    (tests/test_tp_sharding.py), each rank holding fewer param bytes; last,
    on a model axis of one rank, that a sharded model refuses a forward
    under autograd, its state_dict, a sampler without tensor_parallel, a
    model axis of another name and another mesh, and samples exactly as the
    replicated one under the same noise."""
    import _torch_dp
    from diff_pruning_tpu.pruning.importance import make_importance
    from diff_pruning_tpu.pruning.pruner import apply_pruning, prune
    from diff_pruning_tpu.pruning.surgery import flatten_params
    from diff_pruning_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
    from diff_pruning_tpu_torch.parallel import tp

    kw = dict(sample_size=16, block_out_channels=(16, 24), layers_per_block=1,
              down_block_types=("DownBlock2D", "DownBlock2D"),
              up_block_types=("UpBlock2D", "UpBlock2D"), norm_num_groups=4,
              attention_head_dim=None, add_attention=False)
    jm = junet.UNet2D(junet.UNet2DConfig(**kw))
    jparams = jm.init(jax.random.key(0))
    res = prune(jm.graph, jparams, make_importance("magnitude"), sparsity=0.25)
    pruned = apply_pruning(jparams, jm.graph, res)
    assert any(v % 8 for v in res.channel_sizes.values())
    for sizes, params, size in ((None, jparams, 4), (res.channel_sizes, pruned, 8)):
        tcfg = UNet2DConfig(**kw) if sizes is None else UNet2DConfig(**kw).with_channel_sizes(
            sizes)
        jgraph = jm.graph if sizes is None else junet.UNet2D(
            junet.UNet2DConfig(**kw).with_channel_sizes(sizes)).graph
        flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
        plan = tp.tp_plan(UNet2D(tcfg, device="meta").graph, flat, size)
        assert plan == jax_tp_axes(jgraph, flat, size), size
        assert any(a is not None for a in plan.values())
        if size == 8:
            assert any(a is None and flat[k].ndim == 4 for k, a in plan.items())
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([10, 900], np.int64)
    samplers = [dict(num_inference_steps=3, eta=1.0), dict(num_inference_steps=3, kind="plms")]
    tdir = tmp_path / "tp"
    tckpt.save_model(str(tdir), cfg, model)
    np.savez(tdir / "inputs.npz", x=x, t=t)
    with open(tdir / "kwargs.json", "w") as f:
        json.dump({"kind": "unet2d", "samplers": samplers}, f)
    ranks = _torch_dp.lib_ranks("tp", tdir, tmp_path, world=2)
    want = _torch_dp.tp_run(str(tdir), {"x": torch.from_numpy(x), "t": torch.from_numpy(t)},
                            {"kind": "unet2d", "samplers": samplers})
    for r in ranks:
        assert r["bytes"] < r["bytes_before"] == want["bytes"]
        for key in ("forward", "sample0", "sample1"):
            np.testing.assert_allclose(r[key], want[key], atol=2e-5, rtol=2e-5, err_msg=key)
    from diff_pruning_tpu_torch.parallel.mesh import DataMesh, ModelAxis
    from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule

    mesh = DataMesh(1, 0, torch.device("cpu"), model=ModelAxis(1, 0))
    sched, sc = DiffusionSchedule.create(device="cpu"), tsampler.SamplerConfig(
        num_inference_steps=3, eta=1.0)
    model = copy.deepcopy(model).eval()
    plain = tsampler.make_sampler(model, sched, sc)(torch.Generator().manual_seed(3), 2, 16, 3)
    sharded = tsampler.make_sampler(model, sched, sc, mesh=mesh, tensor_parallel=True)
    assert torch.equal(sharded(torch.Generator().manual_seed(3), 2, 16, 3), plain)
    with pytest.raises(RuntimeError, match="for inference"):
        model(torch.from_numpy(x), torch.from_numpy(t))
    with pytest.raises(RuntimeError, match="slices"):
        tckpt.save_model(str(tmp_path / "tp_save"), cfg, model)
    with pytest.raises(ValueError, match="build its sampler with tensor_parallel"):
        tsampler.make_sampler(model, sched, sc)
    with pytest.raises(ValueError, match="no model axis 'data'"):
        tsampler.make_sampler(model, sched, sc, mesh=mesh, tensor_parallel=True,
                              model_axis="data")
    with pytest.raises(ValueError, match="another model axis"):
        tp.shard_model_tp(model, DataMesh(1, 0, torch.device("cpu"), model=ModelAxis(2, 0)))


def test_cli_writes_pngs_on_cpu_and_refuses_missing_gpu(tmp_path, monkeypatch):
    """The sampling CLI on the CPU: PNGs, the sampler kinds and grid modes,
    the data-parallel run over 2 gloo ranks against one process; it refuses
    --device cuda without a GPU, with and without --multihost."""
    cfg, model = _tiny_checkpoint(1)
    tckpt.save_model(str(tmp_path / "ckpt"), cfg, model)
    _check_tensor_parallel(tmp_path, cfg, model)
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
    # the other sampler kinds, and the trajectory and interpolation grids
    for kind in ("plms", "dpm"):
        stats = ddpm_sample.main(args[:3] + [str(tmp_path / kind)] + args[4:]
                                 + ["--sampler", kind, "--device", "cpu"])
        assert stats["images"] == 5 and stats["nonfinite"] == 0, kind
        assert len(os.listdir(tmp_path / kind)) == 5
    from PIL import Image

    hw = cfg.sample_size
    # ddim_exp at 3 steps: t = 999, 666, 333, 0, so 5 states, each a column
    states = len(tddim.ddim_timesteps(3, 1000, "uniform", style="ddim_exp")) + 1
    for mode, nrow, nimg in (("sequence", states, 4 * states), ("interpolation", 11, 11)):
        out = ddpm_sample.main(args[:3] + [str(tmp_path / mode)] + args[4:]
                               + ["--mode", mode, "--device", "cpu"])
        assert out["shape"] == (nimg, hw, hw, 3), (mode, out)
        # save_image_grid: 2-pixel padding around every image
        rows = nimg // nrow
        assert np.asarray(Image.open(out["path"])).shape == (
            (hw + 2) * rows + 2, (hw + 2) * nrow + 2, 3), mode
        assert os.path.basename(out["path"]) == f"{mode}.png"
    # --multihost on 2 gloo ranks, DDIM eta 1 (per-step noise drawn at the
    # global shape): each rank writes its row of every batch of 2 to
    # process_{rank}/, numbered locally, the ragged 5 rounded up to 6; the
    # union in global order is the one-process run's images within one
    # uint8 level (the rows' f32 sums differ in order only)
    import _torch_dp

    eta = args[:3] + [str(tmp_path / "one")] + args[4:] + ["--eta", "1.0"]
    ddpm_sample.main(eta + ["--device", "cpu"])
    eta[3] = str(tmp_path / "two")
    outs = _torch_dp.cli_ranks("ddpm_sample", eta)
    assert all("rounds 5 up to 6 images" in o for o in outs)
    dirs = [tmp_path / "two" / f"process_{r}" for r in (0, 1)]
    assert [sorted(os.listdir(d)) for d in dirs] == [[f"{i:06d}.png" for i in range(3)]] * 2
    union = [np.asarray(Image.open(dirs[i % 2] / f"{i // 2:06d}.png"), np.int16)
             for i in range(6)]
    one = [np.asarray(Image.open(tmp_path / "one" / f"{i:06d}.png"), np.int16)
           for i in range(5)]
    assert sorted(os.listdir(tmp_path / "one")) == [f"{i:06d}.png" for i in range(5)]
    for i in range(5):
        assert np.abs(union[i] - one[i]).max() <= 1, i
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ddpm_sample.main(args + ["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ddpm_sample.main(args + ["--mode", "sequence", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):  # NCCL needs the card
        ddpm_sample.main(args + ["--multihost", "--coordinator_address", "127.0.0.1:1",
                                 "--num_processes", "1", "--process_id", "0"])
