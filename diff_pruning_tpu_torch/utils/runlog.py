"""Train-CLI plumbing: archiving the launch command.

The port's own copy of ``archive_command`` from
``diff_pruning_tpu/utils/runlog.py`` (standard library only). The JAX
file's ``chunk_for_intervals`` sizes multi-step dispatch chunks, which the
port does not have.
"""

from __future__ import annotations

import os
import shlex
import sys
from typing import Optional, Sequence


def archive_command(output_dir: str, module: str,
                    argv: Optional[Sequence[str]]) -> None:
    """Append the exact (shell-quoted, replayable) launch command to
    output_dir/run.sh, as the reference archives its command
    (ddpm_train.py:376-378)."""
    args = list(argv if argv is not None else sys.argv[1:])
    with open(os.path.join(output_dir, "run.sh"), "a") as f:
        f.write(f"python -m {module} "
                + " ".join(shlex.quote(a) for a in args) + "\n")
