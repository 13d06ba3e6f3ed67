"""Experiment trackers — the reference's --logger {tensorboard,wandb} choice
(ddpm_train.py:180-188, accelerate log_with) without the accelerate layer.

The port's own copy of ``diff_pruning_tpu/utils/tracking.py``.
``tensorboard`` writes native TFRecord event files (utils/tensorboard.py, no
TF dependency). ``wandb`` uses the real wandb package when importable;
where it is absent, selecting it raises with a clear message instead of
silently not logging (the reference would crash on its ``import wandb`` at
ddpm_train.py:55-58 the same way).
"""

from __future__ import annotations

import os
from typing import Optional


class TensorBoardTracker:
    def __init__(self, logdir: str, config: Optional[dict] = None):
        from .tensorboard import SummaryWriter

        self._w = SummaryWriter(logdir)
        del config  # TB has no run-config notion; metrics only

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._w.add_scalar(tag, value, step)

    def flush(self) -> None:
        self._w.flush()

    def close(self) -> None:
        self._w.close()


class WandbTracker:
    """wandb.init + wandb.log, honoring WANDB_MODE (offline works without
    network: wandb writes a local run dir to sync later)."""

    def __init__(self, logdir: str, config: Optional[dict] = None,
                 project: str = "diff-pruning-tpu"):
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "--logger wandb needs the wandb package, which is not "
                "installed. Use --logger tensorboard (native TFRecord "
                "writer) or install wandb and set WANDB_MODE=offline.") from e
        os.makedirs(logdir, exist_ok=True)
        self._wandb = wandb
        self._run = wandb.init(
            project=project, dir=logdir, config=config or {},
            mode=os.environ.get("WANDB_MODE", "offline"))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._run.log({tag: value}, step=step)

    def flush(self) -> None:
        pass  # wandb streams its own writes

    def close(self) -> None:
        self._run.finish()


class NullTracker:
    """No-op backend for non-main processes on multi-host runs (the
    reference creates its trackers under accelerator.is_main_process,
    ddpm_train.py:357-359)."""

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def make_tracker(kind: str, logdir: str, config: Optional[dict] = None):
    if kind == "tensorboard":
        return TensorBoardTracker(logdir, config)
    if kind == "wandb":
        return WandbTracker(logdir, config)
    if kind == "none":
        return NullTracker()
    raise ValueError(f"unknown logger {kind!r} (tensorboard | wandb | none)")
