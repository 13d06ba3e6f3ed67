"""Hand-written Hopper kernels, per-op switches and launch counters.

Counterpart of ``diff_pruning_tpu/ops/__init__.py``. Both switches default
to ON: the JAX package's gates (GroupNorm off, attention only under
differentiation for >= 512 tokens) were measured on a TPU v5e and say
nothing about the H100. With a switch on, a layer calls the op's wrapper,
which runs the plain PyTorch version for a CPU tensor and launches the
kernel for a CUDA tensor; under autograd the wrapper is a
``torch.autograd.Function`` whose backward is a kernel too. With it off,
the layer runs the plain version on any device, forward and backward.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one where
it launches its kernel, and nowhere else, so a run can show that the main
path went through the kernels. ``attention_lse`` counts the attention
forwards that also wrote the per-row logsumexp (a subset of ``attention``).
"""

_FLAGS = {"group_norm": True, "attention": True}

LAUNCHES = {"group_norm": 0, "group_norm_bwd": 0, "attention": 0, "attention_lse": 0,
            "attention_bwd_dq": 0, "attention_bwd_dkv": 0}


def set_kernels_enabled(on: bool = True, *, group_norm=None, attention=None) -> None:
    """Positional ``on`` sets every op; keywords set individual ops. A switch
    governs the op's forward and backward kernels together."""
    if group_norm is None and attention is None:
        for op in _FLAGS:
            _FLAGS[op] = bool(on)
        return
    if group_norm is not None:
        _FLAGS["group_norm"] = bool(group_norm)
    if attention is not None:
        _FLAGS["attention"] = bool(attention)


def kernels_enabled(op: str) -> bool:
    return _FLAGS[op]


def reset_launch_counts() -> None:
    for op in LAUNCHES:
        LAUNCHES[op] = 0
