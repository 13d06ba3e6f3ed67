"""The port's recipe drivers (``diff_pruning_tpu_torch/tools/``) against the
JAX package's (``tools/``), for the tests of the port.

``*_calls`` run a driver with every CLI call stubbed and return the
(CLI, argv) sequence it made, the module prefix dropped: for the JAX
driver its ``sh`` (and ``pysub``, its in-process init subprocesses and, in
``ae_validation``, the imported CLI ``main``) are stubbed; for the port
``tools._runner.run`` and its in-process helpers. The port's runner appends
``--device <device>`` to every argv it is given; the sequences compared are
the argv the drivers hand their runners.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PREFIX, PORT_PREFIX = "diff_pruning_tpu.cli.", "diff_pruning_tpu_torch.cli."


def jax_driver(name: str):
    """The repository's ``tools/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(f"_jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _strip(argv, prefix):
    assert argv[0].startswith(prefix), argv
    return (argv[0][len(prefix):], list(argv[1:]))


def _fake_result(cli: str):
    """What a port CLI's ``main`` returns, as far as the drivers read it."""
    if cli == "fid_score":
        return 1.0
    if cli == "compute_ssim":
        return {"ssim": 1.0, "mse": 0.0}
    return {"steps_run": 1, "params": 1, "params_before": 2, "macs": 1, "start_step": 0}


def stub_port_runner(monkeypatch, calls, on_call=None):
    """Replaces ``tools._runner.run``: records (CLI, argv, kill_at_step), and
    returns -9 for a killed run, else 0 and :func:`_fake_result`."""
    from diff_pruning_tpu_torch.tools import _runner

    def fake(log_dir, phase, argv, *, device, tag, kill_at_step=None):
        cli, args = _strip(argv, PORT_PREFIX)
        calls.append((cli, args, kill_at_step))
        if on_call is not None:
            on_call(cli, args)
        return (-9 if kill_at_step is not None else 0), 0.0, _fake_result(cli)

    monkeypatch.setattr(_runner, "run", fake)


def mark_done(out, state_name, *phases):
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, state_name), "w") as f:
        json.dump({p: {"t": 0.0} for p in phases}, f)


def fullrun_calls(monkeypatch, out, port: bool):
    """fullrun --smoke, its data phase marked done (it calls no CLI)."""
    mark_done(out, "fullrun_state.json", "data")
    calls = []
    if port:
        from diff_pruning_tpu_torch.tools import fullrun

        stub_port_runner(monkeypatch, calls)
        monkeypatch.setattr(fullrun, "init_base", lambda d: None)
        fullrun.main(["--out", str(out), "--smoke"])
        return calls
    mod = jax_driver("fullrun")

    def sh(out_dir, phase, argv, kill_at_step=None):
        calls.append(_strip(argv, JAX_PREFIX) + (kill_at_step,))
        return (-9 if kill_at_step is not None else 0), 0.0

    monkeypatch.setattr(mod, "sh", sh)
    # the base init's JAX CPU subprocess
    monkeypatch.setattr(mod.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(a, 0))
    monkeypatch.setattr(sys, "argv", ["fullrun", "--out", str(out), "--smoke"])
    mod.main()
    return calls


def fake_fullrun_base(base, n_fid):
    """The files of a fullrun output that cost_quality lists itself."""
    d = os.path.join(base, "samples_base_fid")
    os.makedirs(d, exist_ok=True)
    for i in range(n_fid):
        open(os.path.join(d, f"{i:06d}.png"), "wb").close()


def cost_quality_calls(monkeypatch, base, out, log_dir, port: bool):
    calls = []
    argv = ["--base", str(base), "--out", str(out), "--smoke"]
    if port:
        from diff_pruning_tpu_torch.tools import cost_quality

        stub_port_runner(monkeypatch, calls)
        monkeypatch.setattr(cost_quality, "sampling_imgs_per_sec",
                            lambda dirs, **kw: {arm: 1.0 for arm in dirs})
        cost_quality.main(argv)
        return calls
    mod = jax_driver("cost_quality")
    monkeypatch.setattr(mod, "LOGDIR", str(log_dir))  # not the repository's docs/logs

    def sh(phase, argv):
        calls.append(_strip(argv, JAX_PREFIX) + (None,))
        return 0.0

    monkeypatch.setattr(mod, "sh", sh)
    # the timed sampling's JAX subprocesses
    monkeypatch.setattr(mod.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(a, 0))
    monkeypatch.setattr(sys, "argv", ["cost_quality"] + argv)
    mod.main()
    return calls


def ae_validation_calls(monkeypatch, out, port: bool):
    """ae_validation at its defaults, 8 random 8 x 8 images in place of its
    2048 procedural ones and the codec's seeded init stubbed, up to its one
    CLI call (the stub stops the driver there: what follows renders grids
    and reads no argv)."""
    calls = []
    argv = ["--out", str(out)]

    class Stop(Exception):
        pass

    def stop(*_):
        raise Stop

    def small(n, hw, seed=0):
        return np.random.default_rng(seed).integers(0, 256, (8, 8, 8, 3), dtype=np.uint8)

    if port:
        from diff_pruning_tpu_torch.data import procedural
        from diff_pruning_tpu_torch.tools import ae_validation

        stub_port_runner(monkeypatch, calls, on_call=stop)
        monkeypatch.setattr(procedural, "make_procedural_dataset", small)
        monkeypatch.setattr(ae_validation, "write_seed", lambda seed_dir: None)
        run = lambda: ae_validation.main(argv + ["--device", "cpu"])  # noqa: E731
    else:
        from diff_pruning_tpu.cli import autoencoder_train
        from diff_pruning_tpu.models import vae

        mod = jax_driver("ae_validation")
        monkeypatch.setattr(mod, "make_procedural_dataset", small)
        monkeypatch.setattr(vae.VQModel, "init", lambda self, key: {"w": np.zeros(1)})

        def train_main(args):
            calls.append(("autoencoder_train", list(args), None))
            stop()

        monkeypatch.setattr(autoencoder_train, "main", train_main)
        monkeypatch.setattr(sys, "argv", ["ae_validation"] + argv)
        run = mod.main
    try:
        run()
    except Stop:
        return calls
    raise AssertionError("ae_validation made no CLI call")


def pixelrun_calls(monkeypatch, out, port: bool):
    """pixelrun --smoke (its data phase runs: 192 images of 32 x 32)."""
    calls = []
    argv = ["--out", str(out), "--smoke"]
    if port:
        from diff_pruning_tpu_torch.tools import pixelrun

        stub_port_runner(monkeypatch, calls)
        monkeypatch.setattr(pixelrun, "ae_check", lambda *a: {"recon_mse": 1.0})
        monkeypatch.setattr(pixelrun, "ldm_init", lambda *a: {})
        monkeypatch.setattr(pixelrun, "class_consistency", lambda d, ipc: {"class_acc": 1.0})
        pixelrun.main(argv + ["--device", "cpu"])
        return calls
    mod = jax_driver("pixelrun")

    def sh(phase, argv, env=None):
        calls.append(_strip(argv, JAX_PREFIX) + (None,))
        return 0, 0.0

    monkeypatch.setattr(mod, "sh", sh)
    # ae_check, ldm_init and the class consistency: JAX subprocesses
    monkeypatch.setattr(mod, "pysub", lambda phase, code, cpu=False: (0, 0.0))
    monkeypatch.setattr(sys, "argv", ["pixelrun"] + argv)
    mod.main()
    return calls


def normalised(calls, jax_out, port_out):
    """The calls with each driver's output dir written as ``<out>``."""
    def fix(a):
        for root in (str(jax_out), str(port_out)):
            a = a.replace(root, "<out>")
        return a

    return [(cli, [fix(a) for a in args], kill) for cli, args, kill in calls]
