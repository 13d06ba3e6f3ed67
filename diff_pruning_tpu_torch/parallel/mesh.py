"""Data parallelism over ``torch.distributed``: one process per GPU, the
weights replicated, every batch split by rows.

Counterpart of ``diff_pruning_tpu/parallel/mesh.py``, the SPMD replacement
of the reference's accelerate/DDP layer (SURVEY.md §2.6). There one jitted
program spans a 1-D 'data' mesh and XLA inserts the grad psum; here each
process runs its rows of the global batch through the model and the callers
(the train step, the sweep, the samplers) make the collectives explicit, so
that W processes over a global batch B compute what one process computes
over B: every random draw is made at the global shape from a generator that
every rank seeds alike, and each rank keeps its rows of it.

The backend is NCCL on the card and gloo on the CPU; a group that is already
initialised (e.g. gloo over CUDA tensors, all_reduce and broadcast being all
this layer needs) is used whatever its backend. Nothing falls back: a
missing GPU, a missing rendezvous or a failed init raises. The JAX
``data_sharding``, ``replicated``, ``shard_batch`` and ``shard_batch_local``
have no torch meaning; their counterparts are :func:`local_rows` and
:func:`padded_rows` (a batch split by rows) and :func:`all_gather_rows` (the
rows put back together). :func:`all_reduce_sum` is a sum over the ranks
that autograd differentiates (a statistic of the global batch inside a
model: the PatchGAN's BatchNorm). ``make_mesh(model=m)`` makes the mesh 2-D
(data x model): the model axis's ranks share each row and split the UNet's
channels (``parallel/tp.py``, the samplers' ``tensor_parallel``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it raises: a rank
# that fails leaves the others in their next collective until then
TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """A 2-D mesh's model axis, the JAX mesh's 'model' (``parallel/tp.py``):
    ``size`` ranks, this one ``rank`` among them, collectives over
    ``group``."""

    size: int
    rank: int
    group: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The 'data' axis: ``world`` processes, this one ``rank``, its tensors
    on ``device``, collectives over ``group`` (None: the default group).
    ``model``: the model axis of a 2-D (data x model) mesh, or None; there
    ``world`` and ``rank`` are the data axis's."""

    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    model: Optional[ModelAxis] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device: str = "cuda") -> DataMesh:
    """Joins the process group and returns :func:`make_mesh`'s mesh: the
    torchrun/accelerate-launch equivalent
    (scripts/sample_ddpm_cifar10_pretrained_distributed.sh:1).

    Give all of ``coordinator_address`` ('host:port' of rank 0),
    ``num_processes`` and ``process_id``, or none: then torchrun's
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` are read,
    as a TPU pod auto-detects its slice. ``device`` 'cuda' takes NCCL on GPU
    ``LOCAL_RANK`` (else the rank modulo the visible GPUs), set before the
    init; 'cpu' takes gloo. Call before the first use of the card."""
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit) and None in explicit:
        raise ValueError(
            "explicit multi-process init needs ALL of coordinator_address, num_processes "
            f"and process_id (got {explicit}); under torchrun omit all three")
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
                   if k not in os.environ]
        if missing:
            raise ValueError(f"multi-process init: {', '.join(missing)} not set; launch with "
                             "torchrun or give --coordinator_address, --num_processes and "
                             "--process_id")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    if dist.is_initialized():
        raise RuntimeError("init_distributed: a process group is already initialised")
    dev = torch.device(device)
    gpu = None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device is available")
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        gpu = torch.device("cuda", local)  # binds NCCL's communicator to it at the init
    elif dev.type != "cpu":
        raise ValueError(f"multi-process runs on 'cuda' (NCCL) or 'cpu' (gloo), not {device!r}")
    dist.init_process_group("nccl" if gpu is not None else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), device_id=gpu)
    return make_mesh()


def make_mesh(device=None, *, model: Optional[int] = None) -> DataMesh:
    """The data axis over the initialised process group: its world size and
    this process's rank; ``device`` defaults to the current GPU under NCCL
    and the CPU otherwise. Raises when no group is initialised.

    With ``model`` the mesh is 2-D, (world // model) x model, as the JAX
    ``make_mesh((("data", d), ("model", m)))``: rank r sits at data index
    r // model and model index r % model, and each axis gets its process
    groups (every rank makes every group, in one order). ``model=1`` gives a
    model axis of one rank, over which ``tensor_parallel`` needs no
    collective."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_distributed first")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    world, rank = dist.get_world_size(), dist.get_rank()
    if model is None:
        return DataMesh(world, rank, torch.device(device))
    if model < 1 or world % model:
        raise ValueError(f"model axis {model} does not divide the world size {world}")
    data = world // model
    data_group = model_group = None
    if model > 1 or data > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = g
    return DataMesh(data, rank // model, torch.device(device), data_group,
                    ModelAxis(model, rank % model, model_group))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_batch_slice(mesh: DataMesh, global_batch: int) -> Tuple[int, int]:
    """This rank's contiguous rows [lo, hi) of a global batch, so that a
    loader decodes only them. Raises unless the world size divides it: a
    rank without rows would leave the others waiting in a collective."""
    if global_batch % mesh.world:
        raise ValueError(f"batch {global_batch} is not divisible by the world size "
                         f"{mesh.world}")
    n = global_batch // mesh.world
    return mesh.rank * n, (mesh.rank + 1) * n


def local_rows(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """Rows :func:`process_batch_slice` of the global tensor ``x`` (a view)."""
    lo, hi = process_batch_slice(mesh, x.shape[0])
    return x[lo:hi]


def padded_rows(mesh: DataMesh, n: int) -> Tuple[int, int, int]:
    """This rank's rows [lo, hi) of a batch of ``n`` rows that need not
    divide by the world size, and ``per``, the rows each rank holds once the
    batch is zero-padded to ``per x world``: rank r takes rows [r per, (r +
    1) per), the pad rows at the end (the JAX ``compute_activations(mesh=)``
    padding). ``hi - lo`` may be below ``per``, or 0."""
    per = -(-n // mesh.world)
    lo = min(mesh.rank * per, n)
    return lo, min(lo + per, n), per


def all_gather_rows(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` (the same shape on each) concatenated along the rows
    in rank order; every rank gets the whole."""
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its backward sums the output's grads over the ranks
    too: with each rank's loss averaged into one by the grads' all_reduce
    (:func:`all_reduce_mean`), every rank's input feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone()
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def all_reduce_sum(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably (a new tensor)."""
    return _AllReduceSum.apply(x, mesh.group)


def _flat_collective(tensors: Iterable[torch.Tensor], op) -> None:
    """Runs ``op`` on one flat buffer per (dtype, device) of ``tensors`` and
    copies the result back in place: one collective, not one per tensor."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for group in groups.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            op(flat)
            parts = flat.split([t.numel() for t in group])
            torch._foreach_copy_(group, [p.view_as(t) for t, p in zip(group, parts)])


def replicate(mesh: DataMesh, tensors: Iterable[torch.Tensor]) -> None:
    """Overwrites ``tensors`` in place with rank 0's values."""
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, 0, group=mesh.group))


def all_reduce_mean(mesh: DataMesh, tensors: Iterable[torch.Tensor]) -> None:
    """Replaces ``tensors`` in place by their mean over the ranks (sum, then
    a division by the world size: exact at one rank)."""

    def mean(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)

    _flat_collective(tensors, mean)


def barrier(mesh: DataMesh) -> None:
    dist.barrier(group=mesh.group)
