"""PyTorch/CUDA port of ``diff_pruning_tpu`` for one NVIDIA H100 (sm_90a).

The JAX package beside this one is the reference. Each module here mirrors
its JAX counterpart's path and names; inside it is written in PyTorch idiom
(``nn.Module``s, an explicit ``device`` everywhere, an explicit
``torch.Generator`` for every random draw).

The port imports nothing of the JAX package and never ``jax``: where it
needs a pure-Python module of the JAX package (the channel graph), it keeps
its own copy. The hand-written kernels live in :mod:`diff_pruning_tpu_torch.ops`.
"""
