"""What the recipe drivers share: the resumable phase state file, a CLI run
(in this process, or as a child process whose group can be SIGKILLed once
its ``metrics.jsonl`` reports a step), each run's output kept in
``<log_dir>/<phase>.log``, and wall seconds that wait for the device."""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import signal
import subprocess
import sys
import time
import traceback
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# seconds between two reads of a killable child's metrics.jsonl
POLL_S = 0.5


class State:
    """``<out_dir>/<name>``: phase -> {"t": wall clock, **info}, rewritten at
    every mark, so a rerun of the driver skips the phases already done."""

    def __init__(self, out_dir: str, name: str):
        self.path = os.path.join(out_dir, name)
        self.d = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                self.d = json.load(f)

    def done(self, phase: str) -> bool:
        return phase in self.d

    def mark(self, phase: str, **info) -> None:
        self.d[phase] = {"t": time.time(), **info}
        with open(self.path, "w") as f:
            json.dump(self.d, f, indent=1)


def last_step(metrics_path: str) -> Optional[int]:
    """The ``step`` of the last parseable line of a ``metrics.jsonl``."""
    try:
        with open(metrics_path, "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        try:
            return json.loads(line)["step"]
        except (ValueError, KeyError, TypeError):
            continue
    return None


def tail_log(log_dir: str, phase: str, n: int = 8) -> str:
    try:
        with open(os.path.join(log_dir, f"{phase}.log")) as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return ""


def require(ok: bool, message: str) -> None:
    """Raises ``RuntimeError(message)`` unless ``ok``: a phase that failed."""
    if not ok:
        raise RuntimeError(message)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def seconds_since(t0: float, device) -> float:
    """Host seconds since ``t0`` (``time.perf_counter``) once the device's
    queued work is done."""
    sync(device)
    return time.perf_counter() - t0


def run(log_dir: str, phase: str, argv, *, device, tag: str, kill_at_step: Optional[int] = None):
    """Runs the CLI ``argv[0]`` (a module with ``main(argv)``) on ``argv[1:]
    + ["--device", device]``, its output appended to ``<log_dir>/<phase>.log``;
    returns ``(returncode, seconds, main's return value or None)``.

    In this process unless ``kill_at_step`` is given; an exception in the
    CLI is written to the log and gives returncode 1 (``SystemExit``: its
    code). With ``kill_at_step``, a child ``python -m`` in a new session:
    once ``metrics.jsonl`` under its ``--output_dir`` reports a step >=
    ``kill_at_step``, its process group gets SIGKILL; the returncode is then
    ``-SIGKILL``."""
    os.makedirs(log_dir, exist_ok=True)
    logpath = os.path.join(log_dir, f"{phase}.log")
    full = list(argv[1:]) + ["--device", str(device)]
    print(f"[{tag}] {phase}: {' '.join(argv)}", flush=True)
    t0 = time.perf_counter()
    result = None
    with open(logpath, "a") as log:
        log.write(f"\n==== {time.strftime('%F %T')} {argv[0]} {' '.join(full)}\n")
        log.flush()
        if kill_at_step is None:
            rc = 0
            with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
                try:
                    result = importlib.import_module(argv[0]).main(full)
                except SystemExit as e:  # a CLI's refusal, printed as python -m would
                    if e.code is None or isinstance(e.code, int):
                        rc = e.code or 0
                    else:
                        print(e.code)
                        rc = 1
                except Exception:  # the run failed: its traceback goes to the log
                    traceback.print_exc()
                    rc = 1
            dt = seconds_since(t0, device) if rc == 0 else time.perf_counter() - t0
        else:
            mpath = os.path.join(full[full.index("--output_dir") + 1], "metrics.jsonl")
            proc = subprocess.Popen([sys.executable, "-m", argv[0]] + full, cwd=REPO,
                                    stdout=log, stderr=subprocess.STDOUT,
                                    start_new_session=True)
            try:
                rc = None
                while rc is None:
                    time.sleep(POLL_S)
                    rc = proc.poll()
                    step = last_step(mpath)
                    if rc is None and step is not None and step >= kill_at_step:
                        print(f"[{tag}] SIGKILL at reported step {step} (>= {kill_at_step})",
                              flush=True)
                        os.killpg(proc.pid, signal.SIGKILL)
                        rc = proc.wait()
            finally:
                if proc.poll() is None:  # this process was interrupted: stop the child
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
            dt = time.perf_counter() - t0
    print(f"[{tag}] {phase} done rc={rc} in {dt:.1f}s", flush=True)
    return rc, dt, result


def ms_per_call(fn, iters: int, warmup: int = 2, device="cuda") -> float:
    """Mean ms of ``fn`` over ``iters`` calls after ``warmup``: CUDA events
    on the card, the host clock elsewhere."""
    import torch

    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, iters: int, warmup: int = 2, device="cuda"):
    """Mean ms of each of ``fns``, timed in order and then in reverse order
    (two functions: a, b, b, a), each timing after ``warmup`` calls."""
    first = [ms_per_call(f, iters, warmup, device) for f in fns]
    second = [ms_per_call(f, iters, warmup, device) for f in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]
