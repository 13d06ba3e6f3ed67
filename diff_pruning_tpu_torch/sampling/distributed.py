"""Large-batch sampling (the 50k-image FID runs), in one process or split
by rows over a data-parallel group.

Counterpart of ``sample_many`` in ``diff_pruning_tpu/sampling/distributed.py``.
The reference shards the work across processes by index with per-process
seeds and subdirectories (ddpm_sample.py:55-77); here, as in the JAX
package, every process runs the same trajectory program over its rows of
each global batch (``make_sampler(mesh=)``) and writes them to
``process_{rank}/``. Class labels wait for a class-conditional caller.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.mesh import DataMesh
from .ddim_sampler import save_images


def _stage(imgs: torch.Tensor):
    """Queue the batch's copy to pinned host memory behind its trajectory;
    the returned event completes when that copy has."""
    if not imgs.is_cuda:
        return imgs, None
    host = torch.empty(imgs.shape, dtype=imgs.dtype, pin_memory=True)
    host.copy_(imgs, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def sample_many(sampler: Callable, *, generator: Optional[torch.Generator],
                total_images: int, batch_size: int, hw: int, channels: int = 3,
                outdir: Optional[str] = None, progress: bool = False,
                mesh: Optional[DataMesh] = None):
    """Run ``sampler`` ceil(total/batch) times; save PNGs to ``outdir`` or
    return the images.

    Pipelined like the JAX version: batch b+1 is enqueued on the card
    before the host waits for batch b's copy and PNG-encodes it, so encoding
    overlaps the next trajectory. Returns the (total, hw, hw, C) f32 array
    when ``outdir`` is None, else ``{"images": n, "nonfinite": k}`` with k
    the count of non-finite values seen before quantising.

    ``batch_size`` is the global batch. With a ``mesh`` of more than one
    rank (and ``sampler`` built with it), each rank keeps only its rows:
    PNGs go to ``outdir/process_{rank}/``, numbered locally, and the array
    returned holds this rank's rows; every batch is whole, so a ragged
    total is rounded up, as the reference's ceil (ddpm_sample.py:67). The
    world size must divide ``batch_size``.
    """
    num_batches = (total_images + batch_size - 1) // batch_size
    multiproc = mesh is not None and mesh.world > 1
    if mesh is not None and batch_size % mesh.world:
        raise ValueError(f"batch_size {batch_size} must divide by the world size "
                         f"({mesh.world})")
    if multiproc:
        if total_images % batch_size:
            print(f"multi-process run rounds {total_images} up to "
                  f"{num_batches * batch_size} images (whole batches)")
        if outdir is not None:
            outdir = os.path.join(outdir, f"process_{mesh.rank}")
    local_total = num_batches * batch_size // mesh.world if multiproc else total_images
    results = []
    stats = {"images": 0, "nonfinite": 0}

    def flush(staged, start):
        host, done = staged
        if done is not None:
            done.synchronize()
        if multiproc:  # this rank's whole rows, numbered locally
            imgs, start = host.numpy(), stats["images"]
        else:
            imgs = host.numpy()[: min(batch_size, total_images - start)]
        stats["images"] += len(imgs)
        stats["nonfinite"] += int(imgs.size - np.count_nonzero(np.isfinite(imgs)))
        if outdir is not None:
            save_images(imgs, outdir, start_index=start)
        else:
            results.append(imgs.copy())
        if progress:
            print(f"  sampled {stats['images']}/{local_total}" + (" (local)" if multiproc else ""))

    pending = None
    for b in range(num_batches):
        staged = _stage(sampler(generator, batch_size, hw, channels))
        if pending is not None:
            flush(*pending)
        pending = (staged, b * batch_size)
    if pending is not None:
        flush(*pending)
    if outdir is None:
        return np.concatenate(results, axis=0)
    return stats
