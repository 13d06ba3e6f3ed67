"""PyTorch/CUDA port of ``diff_pruning_tpu`` for one NVIDIA H100 (sm_90a).

The JAX package beside this one is the reference. Each module here mirrors
its JAX counterpart's path and names; inside it is written in PyTorch idiom
(``nn.Module``s, an explicit ``device`` everywhere, an explicit
``torch.Generator`` for every random draw).

The only JAX-package module imported is ``diff_pruning_tpu.pruning.graph``
(pure Python, no jax import), so both packages share one ChannelGraph.
The hand-written kernels live in :mod:`diff_pruning_tpu_torch.ops`.
"""
