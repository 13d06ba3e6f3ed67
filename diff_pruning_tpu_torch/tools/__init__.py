"""The recipe and validation drivers, run as ``python -m
diff_pruning_tpu_torch.tools.<name>``: counterparts of the repository's
``tools/`` drivers of the JAX package (same file names, phases, flags,
defaults, state files and result lines), calling the port's CLIs
(``diff_pruning_tpu_torch.cli``) where those call the JAX ones.

- ``e2e_validation``: train a DDPM from scratch, sweep, prune by four
  criteria, same-seed SSIM, finetune (the paper's behavioural claim);
- ``fullrun``: the flagship CIFAR recipe through the CLIs, with a real
  SIGKILL of the finetune and its resume;
- ``ssim_curve``: SSIM of each ``prune_ssim`` stage against the base;
- ``cost_quality``: importance-only against cost-aware pruning at one
  param budget, each finetuned, scored and timed;
- ``ae_validation``: the first-stage training CLI on a small VQ codec;
- ``pixelrun``: the CompVis LDM recipe in pixel space on vq-f4.

Every driver runs on the card unless given ``--device cpu``, and passes its
device to each CLI it calls.
"""
