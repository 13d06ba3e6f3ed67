"""Tensor parallelism over a model axis of ranks: counterpart of
``diff_pruning_tpu/parallel/tp.py``.

The JAX version shards every conv/linear out-axis, and the norm and bias
vectors indexed by the same channel var, over the mesh's 'model' axis
wherever the channel count divides the axis size, and GSPMD inserts the
activation collectives. The rule is derived from the ChannelGraph, so a
pruned model whose sizes stop dividing the axis keeps those params
replicated. Here the same rule (:func:`tp_plan`) picks the params, and the
activation layout is explicit:

- each rank keeps its contiguous slice of every sharded param, so the
  params a rank holds shrink by the axis size where the rule shards them;
- a Conv2D, a Linear or a scale-shift projection whose kernel is sharded
  computes this rank's slice of its output channels (column-parallel), and
  the slices are gathered along the channel axis before any consumer sees
  the output, so the GroupNorm and attention kernels run on whole
  activations, unchanged;
- any other sharded param (a GroupNorm's or LayerNorm's scale and bias, the
  GEGLU projection, an embedding table) is gathered whole just before the
  module that reads it runs, and dropped after: replicated compute;
- a replicated param is computed whole on every rank.

The gathers are NCCL's all_gather on the card, and on any other backend
(gloo over CPU or CUDA tensors, where gloo has no all_gather) an
all_reduce of a zero buffer that holds this rank's slice: adding zeros is
exact. At one rank the collectives vanish and the model computes exactly
what the unsharded one does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

# the modules whose forward maps a sharded kernel's out-axis to the output's
# channel axis (dim 1 of a conv's NCHW output, the last of a linear's)
_COLUMN_PARALLEL = {"Conv2D": 1, "Linear": -1, "_ScaleShiftProj": -1}


def tp_plan(graph, params: Mapping[str, object], size: int) -> Dict[str, Optional[int]]:
    """For every param path of ``params`` (JAX-layout arrays or their shapes,
    :func:`jax_layout_shapes`), the axis sharded over a model axis of ``size``
    ranks, or None: the JAX ``tp_param_shardings`` rule (``in`` refs
    skipped, the first other ref of a param wins, an axis only where
    ``size`` divides it)."""
    plan: Dict[str, int] = {}
    for ref in graph.refs:
        if ref.role == "in":
            continue
        shape = params[ref.param]
        if tuple(getattr(shape, "shape", shape))[ref.axis] % size == 0:
            plan.setdefault(ref.param, ref.axis)
    return {path: plan.get(path) for path in params}


def jax_layout_shapes(model: nn.Module) -> Dict[str, tuple]:
    """Each param's JAX path and JAX-layout shape (HWIO conv kernels, (din,
    dout) linear kernels), the layout that the ChannelGraph registers."""
    out = {}
    for key, p in model.named_parameters():
        shape = tuple(p.shape)
        if key.endswith("kernel") and len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])
        elif key.endswith("kernel") and len(shape) == 2:
            shape = shape[::-1]
        out[key.replace(".", "/")] = shape
    return out


def _torch_dim(key: str, ndim: int, axis: int) -> int:
    """The dim of the port's tensor that is the JAX-layout ``axis``."""
    if key.endswith("kernel") and ndim == 4:
        return (2, 3, 1, 0)[axis]  # HWIO -> OIHW
    if key.endswith("kernel") and ndim == 2:
        return 1 - axis
    return axis


def gather(local: torch.Tensor, dim: int, size: int, rank: int, group,
           memory_format=None) -> torch.Tensor:
    """The ``size`` ranks' equal slices of a tensor, concatenated along ``dim``
    in rank order; every rank gets the whole (``local`` itself at one rank)."""
    if size == 1:
        return local
    dim = dim % local.dim()
    n = local.shape[dim]
    full_shape = list(local.shape)
    full_shape[dim] = n * size
    if dist.get_backend(group) == "nccl":
        buf = torch.empty((size, *local.shape), dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(buf, local.contiguous(), group=group)
        out = torch.cat(buf.unbind(0), dim=dim)
    else:
        out = torch.zeros(full_shape, dtype=local.dtype, device=local.device)
        out.narrow(dim, rank * n, n).copy_(local)
        dist.all_reduce(out, group=group)
    if memory_format is not None:
        out = out.contiguous(memory_format=memory_format)
    return out


def _reader_path(model: nn.Module, key: str) -> str:
    """The module whose forward reads the param ``key`` (a dotted state-dict
    key): its owner, or the nearest ancestor with a forward of its own (the
    GEGLU ``proj`` holder has none)."""
    parts = key.split(".")[:-1]
    while parts:
        if type(model.get_submodule(".".join(parts))).forward is not nn.Module.forward:
            break
        parts.pop()
    return ".".join(parts)


def shard_model_tp(model: nn.Module, mesh) -> Dict[str, Optional[int]]:
    """Shards ``model`` in place over ``mesh``'s model axis
    (``parallel.mesh.make_mesh(model=m)``) by :func:`tp_plan` and returns
    the plan; a second call on the same axis changes nothing.

    The sharded model is for inference only, and refuses what would
    silently go wrong on its slices: a forward where autograd records (its
    sharded params hold no grad), and ``state_dict`` (it would write the
    slices; ``save_ldm`` and ``save_model`` go through it)."""
    if mesh is None or mesh.model is None:
        raise ValueError("tensor_parallel needs a 2-D mesh: parallel.mesh.make_mesh(model=m)")
    axis = mesh.model
    done = getattr(model, "_tp_axis", None)
    if done is not None:
        if done != axis:
            raise ValueError(f"model already sharded over another model axis ({done})")
        return model._tp_plan
    size, rank, group = axis.size, axis.rank, axis.group
    plan = tp_plan(model.graph, jax_layout_shapes(model), size)
    column, gathered = {}, {}
    for key, p in list(model.named_parameters()):
        axis_of_p = plan.get(key.replace(".", "/"))
        if axis_of_p is None:
            continue
        dim = _torch_dim(key, p.dim(), axis_of_p)
        n = p.shape[dim] // size
        owner_path, _, leaf = key.rpartition(".")
        owner = model.get_submodule(owner_path)
        with torch.no_grad():
            local = p.detach().narrow(dim, rank * n, n).contiguous()
        owner._parameters[leaf] = nn.Parameter(local, requires_grad=False)
        if type(owner).__name__ in _COLUMN_PARALLEL and dim == 0:
            column[owner_path] = owner
        else:
            reader_path = _reader_path(model, key)
            rel = owner_path[len(reader_path):].lstrip(".")
            gathered.setdefault(reader_path, []).append((rel, leaf, dim))
    for owner in column.values():
        owner.register_forward_hook(_column_hook(_COLUMN_PARALLEL[type(owner).__name__],
                                                 size, rank, group))
    for reader_path, params in gathered.items():
        reader = model.get_submodule(reader_path)
        pre, post = _param_hooks(params, size, rank, group)
        reader.register_forward_pre_hook(pre)
        reader.register_forward_hook(post)
    model.register_forward_pre_hook(_refuse_grad)
    model.register_state_dict_pre_hook(_refuse_state_dict)
    model._tp_axis, model._tp_plan = axis, plan
    return plan


def shard_for_sampler(model: nn.Module, mesh, tensor_parallel: bool, model_axis: str) -> None:
    """The samplers' ``tensor_parallel``: :func:`shard_model_tp` over
    ``mesh``'s model axis, which ``model_axis`` names as in JAX (the port's
    mesh has the one, 'model'). Without ``tensor_parallel`` it refuses a
    model that an earlier sampler sharded: its hooks still gather over that
    axis."""
    if tensor_parallel:
        if model_axis != "model":
            raise ValueError(f"the mesh has no model axis {model_axis!r} (it has 'model')")
        shard_model_tp(model, mesh)
    elif getattr(model, "_tp_axis", None) is not None:
        raise ValueError("model is sharded over a model axis (tensor_parallel=True "
                         "earlier): build its sampler with tensor_parallel=True")


def _refuse_grad(module, args):
    if torch.is_grad_enabled():
        raise RuntimeError("a tensor-parallel model is for inference (its sharded params "
                           "hold no grad): run it under torch.no_grad() or inference_mode()")


def _refuse_state_dict(module, prefix, keep_vars):
    raise RuntimeError("a tensor-parallel model holds slices of its params: its state_dict "
                       "would write them; save the model before sharding it")


def _column_hook(dim: int, size: int, rank: int, group):
    def hook(module, args, out):
        fmt = torch.channels_last if out.dim() == 4 and dim == 1 else None
        return gather(out, dim, size, rank, group, memory_format=fmt)

    return hook


def _param_hooks(params, size: int, rank: int, group):
    """A pre-forward hook that swaps each param ``(owner path relative to the
    reader, leaf, dim)`` for its gathered whole, and a forward hook that
    swaps the slices back. The hooks find the params through the module they
    are called on, so a deep copy of the model (the samplers' cast to a
    compute dtype) gathers its own."""

    def pre(module, args):
        held = module.__dict__.setdefault("_tp_held", [])
        for rel, leaf, dim in params:
            owner = module.get_submodule(rel)
            local = owner._parameters[leaf]
            held.append(local)
            owner._parameters[leaf] = gather(local.detach(), dim, size, rank, group)

    def post(module, args, out):
        held = module.__dict__.pop("_tp_held")
        for (rel, leaf, _), local in zip(params, held):
            module.get_submodule(rel)._parameters[leaf] = local

    return pre, post


def param_bytes(model: nn.Module) -> int:
    """The bytes of the params this rank holds."""
    return sum(p.numel() * p.element_size() for p in model.parameters())
