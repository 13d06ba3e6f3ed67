"""Large-batch sampling (the 50k-image FID runs), single process.

Counterpart of ``sample_many`` in ``diff_pruning_tpu/sampling/distributed.py``;
its multi-host sharding and class labels wait for the multi-GPU slice and a
class-conditional caller.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

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
                outdir: Optional[str] = None, progress: bool = False):
    """Run ``sampler`` ceil(total/batch) times; save PNGs to ``outdir`` or
    return the images.

    Pipelined like the JAX version: batch b+1 is enqueued on the card
    before the host waits for batch b's copy and PNG-encodes it, so encoding
    overlaps the next trajectory. Returns the (total, hw, hw, C) f32 array
    when ``outdir`` is None, else ``{"images": n, "nonfinite": k}`` with k
    the count of non-finite values seen before quantising.
    """
    num_batches = (total_images + batch_size - 1) // batch_size
    results = []
    stats = {"images": 0, "nonfinite": 0}

    def flush(staged, start):
        host, done = staged
        if done is not None:
            done.synchronize()
        imgs = host.numpy()[: min(batch_size, total_images - start)]
        stats["images"] += len(imgs)
        stats["nonfinite"] += int(imgs.size - np.count_nonzero(np.isfinite(imgs)))
        if outdir is not None:
            save_images(imgs, outdir, start_index=start)
        else:
            results.append(imgs.copy())
        if progress:
            print(f"  sampled {stats['images']}/{total_images}")

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
