"""Runs the port's data-parallel path in several OS processes over gloo on
the CPU, for the tests of the port (``tests/test_torch_*.py``).

``run_ranks`` starts one process per rank, each under a time limit, and
returns their outputs; a rank that fails or outlives the limit fails the
caller (the others are killed, so no rank waits in a collective). Run as a
script, this file is one rank of a library-level run:

    python tests/_torch_dp.py train|sweep|ae|tp RANK WORLD PORT IN_DIR OUT_DIR

For ``train`` and ``sweep``, ``IN_DIR`` holds ``inputs.npz``,
``kwargs.json`` and a UNet checkpoint (``utils/checkpoint.save_model``); for
``ae``, subdirectories that each hold ``inputs.npz``, ``kwargs.json``, a
first stage (``first_stage/``), the discriminator's (``disc.npz``) and,
optionally, LPIPS's (``lpips.npz``) params: one step each (:func:`ae_step`).
For ``tp`` (tensor parallelism, ``parallel/tp.py``: every rank on one
model axis), ``IN_DIR`` holds ``kwargs.json``, ``inputs.npz`` and a UNet
checkpoint (``unet/``, a UNet2D) or an LDM dir (``ldm/``): :func:`tp_run`.
The rank writes ``OUT_DIR/rank{RANK}.npz`` (for ``ae`` each key prefixed
by its subdirectory's name and ``/``). It imports torch and the port only.
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each rank's limit: a tiny config takes a few seconds
RANK_TIMEOUT_S = 120


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def multihost_flags(rank: int, world: int, port: int):
    return ["--multihost", "--coordinator_address", f"127.0.0.1:{port}",
            "--num_processes", str(world), "--process_id", str(rank), "--device", "cpu"]


def run_ranks(argv_of_rank, world: int = 2, timeout: float = RANK_TIMEOUT_S):
    """Starts ``python argv_of_rank(rank, port)`` for every rank, one thread
    of torch each, and returns their outputs; raises AssertionError with the
    output of any rank that failed."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable] + argv_of_rank(r, port), cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return outs


def cli_ranks(module: str, argv, world: int = 2):
    """``python -m diff_pruning_tpu_torch.cli.<module> argv --multihost ...
    --device cpu`` in ``world`` processes."""
    return run_ranks(lambda r, port: ["-m", f"diff_pruning_tpu_torch.cli.{module}"] + list(argv)
                     + multihost_flags(r, world, port), world)


def lib_ranks(mode: str, in_dir, out_dir, world: int = 2):
    """This file's ``mode`` in ``world`` processes; returns each rank's npz
    contents."""
    import numpy as np

    run_ranks(lambda r, port: [os.path.abspath(__file__), mode, str(r), str(world), str(port),
                               str(in_dir), str(out_dir)], world)
    res = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            res.append({k: f[k] for k in f.files})
    return res


def _main(mode, rank, world, port, in_dir, out_dir):
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from diff_pruning_tpu_torch.parallel.mesh import init_distributed, local_rows
    from diff_pruning_tpu_torch.utils.checkpoint import flat_from_state_dict

    torch.set_num_threads(1)
    mesh = init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")

    def inputs_of(d):
        with np.load(os.path.join(d, "inputs.npz")) as f:
            inputs = {k: torch.from_numpy(f[k]) for k in f.files}
        with open(os.path.join(d, "kwargs.json")) as f:
            return inputs, json.load(f)

    out = {}
    if mode == "ae":
        for kind in sorted(os.listdir(in_dir)):
            inputs, kwargs = inputs_of(os.path.join(in_dir, kind))
            res = ae_step(os.path.join(in_dir, kind), local_rows(mesh, inputs["x"]), kwargs,
                          mesh=mesh)
            out.update({f"{kind}/{k}": v for k, v in res.items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        return
    inputs, kwargs = inputs_of(in_dir)
    if mode == "tp":
        from diff_pruning_tpu_torch.parallel.mesh import make_mesh

        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **tp_run(in_dir, inputs, kwargs, make_mesh(model=world)))
        return
    from diff_pruning_tpu_torch.models.unet2d import UNet2D
    from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
    from diff_pruning_tpu_torch.utils.checkpoint import load_model

    cfg, state = load_model(in_dir)
    model = UNet2D(cfg, device="cpu")
    model.load_state_dict(state)
    schedule = DiffusionSchedule.create(device="cpu")
    if mode == "train":
        from diff_pruning_tpu_torch.training.finetune import (TrainConfig, init_train_state,
                                                              make_train_step)

        tcfg = TrainConfig(**kwargs)
        st = init_train_state(model, tcfg)
        step = make_train_step(model, schedule, tcfg, mesh=mesh)
        x, noise, t = (local_rows(mesh, inputs[k]) for k in ("x", "noise", "t"))
        st, m = step(st, x, noise=noise, t=t.long())
        out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
        for name, tree in (("mu", st.opt_state.mu), ("params", st.params),
                           ("ema", st.ema_params)):
            out.update({f"{name}:{k}": v for k, v in flat_from_state_dict(tree).items()})
    elif mode == "sweep":
        from diff_pruning_tpu_torch.diffpruning.sweep import accumulate_taylor_grads
        from diff_pruning_tpu_torch.utils.checkpoint import flat_grads

        res = accumulate_taylor_grads(model, schedule, inputs["x0"], inputs["noise"],
                                      mesh=mesh, **kwargs)
        out.update(steps_run=res.steps_run, losses=res.losses)
        out.update({f"grad:{k}": v for k, v in flat_grads(model).items()})
    else:
        raise ValueError(mode)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def tp_run(in_dir, inputs, kwargs, mesh=None):
    """``kwargs["kind"]`` 'unet2d': the UNet's forward on ``inputs`` x and t,
    then ``make_sampler`` for each of ``kwargs["samplers"]`` (SamplerConfig
    fields; noise from ``default`` seeded generators), both with
    ``tensor_parallel`` over ``mesh``'s model axis; 'ldm': ``make_cfg_sampler``
    for each of ``kwargs["samplers"]`` on ``inputs`` labels. Without ``mesh``
    the same, replicated. Returns the outputs and the param bytes held."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from diff_pruning_tpu_torch.parallel.tp import param_bytes, shard_model_tp

    tp = mesh is not None
    out = {}
    with torch.no_grad():
        if kwargs["kind"] == "unet2d":
            from diff_pruning_tpu_torch.models.unet2d import UNet2D
            from diff_pruning_tpu_torch.sampling.ddim_sampler import SamplerConfig, make_sampler
            from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
            from diff_pruning_tpu_torch.utils.checkpoint import load_model

            cfg, state = load_model(in_dir)
            model = UNet2D(cfg, device="cpu")
            model.load_state_dict(state)
            model.eval()
            out["bytes_before"] = np.asarray(param_bytes(model))
            if tp:
                shard_model_tp(model, mesh)
            out["bytes"] = np.asarray(param_bytes(model))
            out["forward"] = model(inputs["x"], inputs["t"].long()).numpy()
            hw = cfg.sample_size
            for i, sc in enumerate(kwargs["samplers"]):
                sample = make_sampler(model, DiffusionSchedule.create(device="cpu"),
                                      SamplerConfig(**sc), mesh=mesh, tensor_parallel=tp)
                out[f"sample{i}"] = sample(torch.Generator().manual_seed(5 + i), 2, hw,
                                           cfg.out_channels).numpy()
        else:
            from diff_pruning_tpu_torch.models.latent_diffusion import load_ldm

            ldm = load_ldm(os.path.join(in_dir, "ldm"), device="cpu")
            out["bytes_before"] = np.asarray(param_bytes(ldm.unet))
            labels = inputs["labels"].long()
            for i, sc in enumerate(kwargs["samplers"]):
                sample = ldm.make_cfg_sampler(**sc, mesh=mesh, tensor_parallel=tp)
                out[f"sample{i}"] = sample(torch.Generator().manual_seed(5 + i), labels,
                                           len(labels)).numpy()
            out["bytes"] = np.asarray(param_bytes(ldm.unet))
    return out


def ae_step(in_dir, x, kwargs, mesh=None):
    """One first-stage train step (``training/autoencoder.py``) from
    ``in_dir``'s models on the images ``x`` (this rank's rows under
    ``mesh``); ``kwargs``: ``loss`` (GANLossConfig's fields), ``disc``
    (NLayerDiscriminator's), ``lr``, ``seed``. Returns the metrics
    (``m:<name>``) and both Adam states (``gen:<keypath>``,
    ``disc:<keypath>``) and params (``gen_params:<path>``, ...) as arrays."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from diff_pruning_tpu_torch.eval.lpips import LPIPS
    from diff_pruning_tpu_torch.models.discriminator import NLayerDiscriminator
    from diff_pruning_tpu_torch.models.vae import AutoencoderConfig, make_first_stage
    from diff_pruning_tpu_torch.training import autoencoder as tae
    from diff_pruning_tpu_torch.utils.checkpoint import (flat_from_state_dict, load_model,
                                                         load_params_npz)

    cfg, state = load_model(in_dir, subfolder="first_stage", config_cls=AutoencoderConfig)
    model = make_first_stage(cfg, device="cpu")
    model.load_state_dict(state)
    disc = NLayerDiscriminator(**kwargs["disc"], device="cpu")
    disc.load_state_dict(load_params_npz(os.path.join(in_dir, "disc.npz")))
    lpips = None
    if os.path.exists(os.path.join(in_dir, "lpips.npz")):
        lpips = LPIPS(device="cpu")
        lpips.load_state_dict(load_params_npz(os.path.join(in_dir, "lpips.npz")))
    go, do = tae.make_ae_optimizers(kwargs["lr"])
    st = tae.init_ae_train_state(model, disc, go, do)
    m = tae.make_autoencoder_train_step(model, tae.GANLossConfig(**kwargs["loss"]), lpips, disc,
                                        go, do, seed=kwargs["seed"], mesh=mesh)(st, x)
    out = {f"m:{k}": np.asarray(float(v)) for k, v in m.items()}
    for name, opt in (("gen", st.gen_opt), ("disc", st.disc_opt)):
        out.update({f"{name}:{k}": v for k, v in opt.by_keypath().items()})
    for name, params in (("gen_params", st.gen_params), ("disc_params", st.disc_params)):
        out.update({f"{name}:{k}": v for k, v in flat_from_state_dict(params).items()})
    return out


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
          sys.argv[6])
