#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diff_pruning_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--compare-fwd LABEL=SRC ...] [--compare-bwd LABEL=SRC ...]

Drives the port's fifteen paths, through its own kernels, from seeded random
checkpoints, and checks them: on the full-width CIFAR-10 UNet (35.75M
params) the serving path (DDIM sampling), the pruning path (the
Diff-Pruning sweep, scoring, slicing and the prune CLI), the finetune
path (the train CLI on the pruned checkpoint, f32 and bf16, and its
resume) and the evaluation path (the fid_score and fidelity CLIs through
the full-width FID InceptionV3, which runs no kernel of the port); and the
class-conditional LDM's serving path (the ldm_sample CLI on cin256-v2 +
vq-f4, 456.76M params), pruning path (the ldm_prune CLI's self-sampled
sweep, through the wide f32 attention backward) and finetune path (the
ldm_train CLI in bf16, through the wide 16-bit attention forward and
backward); and the unconditional LDMs' sampling path (the sample_diffusion
CLI on CelebA-HQ LDM-VQ-4 and LSUN-churches LDM-KL-8) with the DDPM
samplers beyond DDIM; and the paper's timestep-stage ablation (the
prune_ssim and compute_ssim CLIs on the CIFAR UNet) with cost-aware global
pruning (ddpm_prune --cost_aware --match_params) and prune_finetune; and
first-stage training (the autoencoder_train CLI on vq-f4, through the
GroupNorm and attention backward at the codec's shapes); and the text- and
retrieval-conditioned serving paths (the txt2img CLI on txt2img-1p4B with
its BERTEmbedder, 1.54B params; the inpaint CLI on inpainting_big +
vq-f4-noattn; train_searcher and the knn2img CLI on rdm768 + kl-f16 with
CLIP ViT-L/14); and the data-parallel path (the train, prune and ldm_sample
CLIs with --multihost over NCCL at world size 1, and two ranks over gloo on
the one card); and the paper's LSUN-256 pipeline (scripts/prune_ddpm_lsun.sh:
a diffusers directory and an lmdb through the prune, bf16 train and sampling
CLIs on the full-width 113.7M-param DDPM). Every phase raises on failure;
none is caught, so any failure exits non-zero before the result lines.

1. Device: CUDA must be available; prints nvidia-smi's name and power limit.
2. Build: compiles every kernel of the port, CUDA C++ from this
   checkout's sources (one nvcc per source, sm_90a, all at once); prints
   the build seconds and ptxas's registers and spills (per kernel for the
   attention forward and backward, f32 and bf16/f16, and the GroupNorm
   backward; the wide forward kernels, the wide f32 backward kernels and
   the wgmma backward kernels must not spill), and counts the tensor-core
   (HMMA: mma.sync; HGMMA: wgmma) and FFMA instructions in the SASS
   (cuobjdump) of the attention kernels and
   the GroupNorm backward: the bf16/f16 attention kernels (forward, dq,
   dk/dv, the wide ones above D = 256 too; the wide forward and the wgmma
   dq and dk/dv with wgmma) must use the tensor cores, the f32 attention
   kernels and the GroupNorm backward must not.
   With ``--compare-fwd LABEL=SRC`` or ``--compare-bwd LABEL=SRC``
   (repeatable) it also builds SRC, another version of
   flash_attention_fwd.cu or flash_attention_bwd.cu with the same C
   interface (e.g. the parent commit's, unpacked by ``git archive``), beside
   the port's own builds, for phases 16 and 18 (forward) or 13, 17 and 18
   (backward).
3. Forward kernels against their plain versions on the card, B = 128, f32
   and bf16, at every GroupNorm and attention shape the dense, the pruned
   and the prune CLI's UNet give them (collected by forward hooks), plus a
   ragged token count.
4. Full-width forward, B = 128, kernels on and off on the same weights;
   the strides of every GroupNorm input the layers pass (also under
   autograd, in phase 9).
5. Serving path, dense: the sampling CLI, 256 images in batches of 128,
   DDIM-20 (cut from its 100); launch counters reset just before and read
   just after.
6. Serving path, pruned: the same CLI on a checkpoint keeping
   floor(0.7 * size / group_div) * group_div channels of every prunable var.
7. Timings (CUDA events, in turns): per-op forward kernel against plain and
   the library call at the main-path shapes (attention also in TFLOP/s),
   the GroupNorm wrapper's host time per call, dense and pruned sampling
   imgs/s with the kernels off then on (one batch each), f32 and bf16, and a torch.profiler
   breakdown of 5 dense DDIM steps by kernel class. Sampling is timed at
   DDIM-20, the serving path's steps (imgs/s at DDIM-100 are a fifth of
   these).
8. Backward kernels against their plain versions, at the same shapes, B =
   128, f32 and bf16: the forward's saved GroupNorm statistics and the
   attention lse, then dx/dscale/dbias and dq/dk/dv.
9. The sweep at full width, B = 128, f32, 3 timesteps, kernels on against
   off on the same x0 and noise (cuDNN deterministic): losses, every
   parameter's grad, Diff-Pruning scores, launch counts per step, and the
   strides of x and dy at the GroupNorm backward; then the kernel-on sweep
   again, whose grads must be bit-identical.
10. Pruning path: the prune CLI, diff-pruning at ratio 0.3, thr 0.05, at
   most 20 sweep steps, B = 128, on a seeded .npz of 128 images; launch
   counters reset just before and read just after. The checkpoint it
   writes reloads at the pinned param count, and the sampling CLI draws 128
   finite images from it.
11. Finetune path, f32 (the main path of the latest slice): the train CLI
   on that checkpoint and .npz, B = 128, 20 steps, a checkpoint and a
   DDIM-100 vis grid every 10 (cuDNN deterministic); launch counters reset
   just before and read just after, equal to calls x steps plus the vis
   forwards. Then a resume from the step-10 checkpoint into another
   directory, whose step-20 params, EMA and Adam state must be
   bit-identical to the uninterrupted run's; the EMA weights reload at the
   pinned param count and the sampling CLI draws finite images from them.
12. Finetune path, bf16 (``--mixed_precision bf16``), 10 steps: finite
   losses, and the launch counts, every GroupNorm and attention backward
   taken in bf16 (the 16-bit dq and dk/dv kernels, the bf16 GroupNorm
   backward).
13. Timings: per-op backward kernels against plain and the library call
   (attention dq and dk/dv also in TFLOP/s, at the dense UNet's shapes and,
   in bf16, at the prune CLI's UNet's (D = 179) too; with ``--compare-bwd``
   also the other versions' dq and dk/dv, in turns with these), the
   GroupNorm backward wrapper's host time per call, the sweep step (forward
   + backward, f32) with the kernels off then on (one turn each), and a
   torch.profiler breakdown of the sweep step by kernel class, kernels on.
14. The train step: kernels on against off (dense, 3 steps from the same
   state on the same noise and t, no dropout), in f32 and in bf16 (the
   16-bit dq and dk/dv inside the model): losses and the first step's
   grads; then train step ms and imgs/s, dense and pruned, f32 and bf16,
   kernels off then on (CUDA events, one step each), peak memory, the optimizer +
   EMA ms per step, and torch.profiler breakdowns of one train step of each
   (with the dq and dk/dv kernels' device ms).
15. Evaluation path, f32, TF32 off, the FID Inception's random init at
   seed 0 (no pt_inception weights are in the repository): pool3 features
   of 8 images on the card against the port's plain CPU forward (both
   resize modes, 32x32 and 512x512 inputs); the fid_score CLI saves the
   statistics of 2048 procedural 32x32 PNGs, scores phases 5 and 6's
   sample folders and the procedural folder itself against them, then the
   same with ``--clean`` (and the resize-mode warning when clean statistics
   are read in torch mode); the fidelity CLI on the dense samples against
   the procedural folder with a .pth of the random init plus a seeded fc
   head. Then Inception imgs/s at B = 128 in both modes (CUDA events, in
   turns), the CLI's wall time, the host's decode and resize of the folder
   alone (16 threads and one), and a torch.profiler breakdown of one
   512-image ``features_of_path``. No kernel of the port runs here: the
   JAX evaluation path reaches no ``pl.pallas_call``.
16. LDM serving path, f32, TF32 off: cin256-v2 UNetCond + vq-f4 first
   stage + ClassEmbedder(1001) from a seeded init on the card, the
   zero-initialised convs (every ResBlock's out_conv, every transformer's
   proj_out, the final conv) drawn like the others, saved with
   ``save_ldm`` and loaded back with ``load_ldm`` (parameter counts and
   bit-equal weights). The GroupNorm and attention forward kernels against
   their plain versions at every shape of one UNet call (2B rows; 61
   GroupNorm and 32 attention calls: self-attention (1024, 384), (256,
   576), (64, 960) and the class-token cross-attention, Nkv = 1), of the
   decode (B rows; its 4096-token D = 512 attention and its GroupNorm
   slabs up to 2 MB a group) and of the UNet pruned at 0.3 (magnitude,
   local), with the lse; the wide forward at its tile edges (Nq, Nkv in 1,
   31, 33, 63, 65, 127 at D = 257, 384, 512, 513, 1024; 3-head fused views
   at D = 268, 269), inference and with lse. The CFG sampler (scale 3)
   kernels on against off from one x_T, DDIM-10, PLMS-5 and DPM-5,
   through the decode, launch counts equal to calls x steps. Then imgs/s
   of CFG DDIM-10 + decode at B = 16, one batch kernels off, then one on; one
   UNet call and one decode, timed and profiled by kernel class; per-op ms
   at every shape
   (kernel, plain, SDPA / F.group_norm, bound, TFLOP/s; with
   ``--compare-fwd`` the other forwards, in the same turns). Last, the main
   path: the ldm_sample CLI on the saved model (1 class x 16 images, B =
   16, so its UNet calls and decodes take the rows checked above) with
   --method ddim (10 steps), plms and dpm (5), then plms again with
   --multihost under torchrun's environment at world size 1 (the CLI's own
   NCCL init; phase 23's (c)), its PNGs byte-identical to the plain plms
   run's, launch counters reset just before each and read just after.
17. LDM prune path, f32, TF32 off, on phase 16's model, B = 6 (the CLI's
   default): (a) the wide f32 dq and dk/dv kernels (256 < D <= 1024)
   against their plain versions at every attention backward shape of one
   sweep step (forward hooks; (1024, 384), (256, 576), (64, 960), each with
   Nkv = Nq and the class token's Nkv = 1, where dq and dk are zero in
   exact arithmetic and 1e-6 of the call's largest gradient is added to
   their tolerance), and at the widths of the UNet the CLI writes (268, 404,
   672); then at their tile edges (Nq, Nkv in 1-127 at D = 257-1024 where
   the cluster of 192-column blocks grows, at 16 rows x 16 heads and at 1 x
   2, so that dk/dv runs unsplit and split over 2 q parts, 4 at Nq = 257;
   fused 3 x 268, 3 x 269 and 2 x 270 views at 256 tokens) against the
   plain versions in float64; (b) the GroupNorm backward at the step's
   shapes (C 192-1920, slabs chunked past 104 KB) and the pruned UNet's; an f32 forward and backward
   at D = 384 under autograd launch the kernels; (c) one sweep step (t = 0)
   kernels on against off from the same latents, labels and noise (cuDNN
   deterministic): loss, every grad and the Diff-Pruning scores, launches
   61 GroupNorm and 32 attention forwards (with lse), 61 GroupNorm
   backwards, 32 dq and 32 dk/dv; a repeat with the kernels on must be
   bit-identical; (d) the main path: the ldm_prune CLI (diff-pruning, 3
   sweep steps for 1000, 2 vis classes for 4, CFG DDIM-2 latents for 20)
   with launch counters reset just before and read just after, equal to
   steps x (2 CFG calls + the grad step) + the vis grid; its model dir
   reloads at the pinned 203,294,971 UNet params and ldm_sample draws
   finite images from it; (e) timings: the sweep step at the CLI's default
   DDIM-20 split into CFG sampling (20 CFG UNet calls of 12 rows, one
   timed) and forward + backward, kernels off then on, one each; a profile
   of one 12-row CFG call and cuDNN's 3x3 192 ->
   192 convolution at 64 x 64 timed at 12, 16 and 32 rows; per-op backward
   ms at the step's shapes against plain, the library call (the SDPA f32
   backward, autograd of F.group_norm) and the bound (with ``--compare-bwd``
   the other backwards' dq and dk/dv in the same turns), and the L2 bytes a
   row of the wide dq and dk/dv from their tiling.
18. LDM train path, bf16, on phase 16's model and phase 17's pruned one, B
   = 16 (the CLI's default): (a) the wide 16-bit attention kernels (the
   forward, inference launch and with lse; dq; dk/dv) against their plain
   versions in bf16 and f16 at every attention shape of one train step
   ((1024, 384), (256, 576), (64, 960), each with Nkv = Nq and 1; the
   pruned UNet's 268, 404, 672; a ragged D = 320; the encode's 4096-token
   D = 512 forward), through head-split views, dq and dk/dv repeated
   bit-identically; the wide forward at phase 16's tile edges in bf16 and
   f16; the wide dq and dk/dv at their tile edges (Nq, Nkv in 1-127 at D =
   257-1024, 16 rows of 16 heads, and fused views of 3 x 268, 3 x 269 and 2
   x 270 at 256 tokens: shapes that the wgmma kernels take) against the
   plain versions in float64, bf16 and f16; the GroupNorm forward (the
   UNet's and the encode's) and backward in bf16 at the step's shapes; D =
   1040 raises in every dtype and launches nothing; (b) one dense bf16
   train step kernels on against off from the same state, images, labels,
   noise, t and drop mask (cuDNN deterministic): loss, the step's grads
   (Adam's first moment), launches a step (32 attention forwards with lse
   and the encode's one without, 32 dq, 32 dk/dv, 61 GroupNorm backwards,
   the UNet's and the encode's GroupNorm forwards), every one in bf16; (c)
   the main path: the ldm_train CLI on the pruned model dir and a
   2-class folder of procedural 256 x 256 PNGs, 6 steps (cut from 20,000),
   saving every 3, launch counters reset just before and read just after,
   equal to steps x the per-step counts; a resume from step 3 into another
   directory whose step-6 params and AdamW state must be bit-identical; its
   model dir reloads at 203,294,971 UNet params and ldm_sample draws finite
   images from it; (d) timings: the train step, dense and pruned, kernels
   off then on (CUDA events, one step each), split into the encode, the
   UNet's forward + backward and the optimizer; peak memory; a profile by kernel
   class; per-op ms of the 16-bit forward with lse, dq and dk/dv at the
   step's shapes, and of the encode's forward, against plain, SDPA and the
   bound (with ``--compare-fwd`` and ``--compare-bwd`` the other forwards
   and backwards in the same turns); the bf16 GroupNorm forward and
   backward per dense step against plain, F.group_norm and the bound; the
   seconds of a save.
19. Unconditional LDM path, f32, TF32 off: (a) two model dirs in the JAX
   package's layout from a seeded init on the card, full width and depth,
   the zero-initialised convs redrawn: CelebA-HQ LDM-VQ-4 (274,056,163
   UNet params, 14-28 heads of 32 in its legacy AttentionBlocks, GroupNorm
   at 7, 21, 35 and 49 channels a group) + vq-f4, and LSUN-churches
   LDM-KL-8 (294,966,916; 8 heads of 24, 48 and 96; scale-shift ResBlocks,
   GroupNorm without SiLU) + kl-f8; (c) every GroupNorm and attention shape
   of a UNet call and a decode of each against the plain versions, the
   attention through head-split views of (B, N, heads x D) projections as
   the layer passes them; (d) one CelebA-HQ DDIM-10 eta-1 trajectory
   (make_concat_sampler, B = 4) kernels on against off from the same x_T
   and per-step noise, latents and the vq-f4 decode of them within 1e-3 of
   their max; (g) a UNet call and a decode at 16 rows, kernels off and on
   in turns, a profile of the 16-row call by kernel class, one UNet call
   at the CLI's 50 rows (kernels on), the decode's peak memory at 50,
   DDIM-10 + decode imgs/s at B = 16 (one batch off, one on), per-op
   ms of a UNet call (kernel, plain, F.group_norm / SDPA, bound; the
   decode's are phase 16's); (b) the main path: the sample_diffusion CLI
   on the CelebA-HQ dir (16 images, B = 16, DDIM-10 for 250, eta 1), 16
   finite 256 x 256 PNGs, launch counters reset just before and read just
   after, equal to 20 UNet calls + one decode; (e) the CLI on the churches
   dir at B = 4, DDIM-5 (the KL decode), and with --vanilla_sample at B = 1
   (the 1000-step DDPM chain), launches exact; (f) make_sampler's plms and
   dpm kinds on the dense CIFAR UNet, DDIM-20, B = 128, kernels on against
   off from one x_T, and ddpm_sample --mode sequence and interpolation
   (PNG sizes checked). Prints the phase's seconds.
20. Ablation and cost-aware path, full CIFAR-10 width, TF32 off, on phase
   5's dense checkpoint and phase 10's seeded .npz: (a) the prune CLI
   twice (diff-pruning, ratio 0.3, --global_pruning, --max_sparsity 0.75,
   5 sweep steps, B = 128, cuDNN deterministic so both sweeps give the same
   grads), importance-only, then --cost_aware hybrid --match_params; launch
   counters reset just before and read just after each, equal to steps x a
   step's calls; the cost-aware param count within 1 % of the importance-
   only run's (else the bisection's closest probe after its 24 probes);
   both dirs reloaded at their printed counts; (b) every GroupNorm and
   attention shape of both pruned UNets (forward hooks), and one-head D =
   113, 115 and 121 at 256 tokens (other scores' allocation), against the
   plain versions, forward and backward, f32 and bf16, B = 128 (phases 3
   and 8's checks and tolerances), the channels a group and head dims
   printed; (c)
   prune_finetune on the cost-aware flags, 6 bf16 steps, saves and DDIM-100
   vis every 3: finite losses, launches exact, every backward of the
   finetune in bf16 (the sweep's in f32), the same channel sizes as (a),
   unet_ema reloaded and sampled by the sampling CLI (DDIM-20); (d) the main
   path: prune_ssim --stages 1 10 --ddim_steps 20 --n_vis 64 --batch_size 64
   (cut from 1911 sweep steps and DDIM-100), launches = 11 sweep steps + 3
   x 20 sampler forwards, each stage dir reloaded, then compute_ssim of
   stage_base against itself (1 within 1e-6, MSE 0) and against each
   stage (printed; seeded weights, so no order is asserted); (e) DDIM-20
   sampling imgs/s of the two pruned UNets (the same param budget) at B =
   128, f32 and bf16, one batch kernels off, then one on (CUDA events). Prints the
   phase's seconds.
21. First-stage training path, vq-f4 at full width (55,322,782 params),
   B = 12 at 256 x 256 (the autoencoder_train CLI's defaults), on phase
   16's model dir: (a) every GroupNorm (N 4096-65,536, C 128-512; 1 and 2
   MB f32 slabs) and attention ((4096, 4096, 512)) shape of one train step
   (forward hooks) against the plain versions, the forward, its statistics
   and lse, the backward (dx, dscale, dbias; dq, dk, dv), f32 and bf16;
   (b) one train step kernels on against off, f32 and bf16, from the same
   state and batch (cuDNN deterministic; the codebook drawn at the
   latents' scale), every term live (disc_start 0): total_loss, d_weight
   and disc_loss (f32 1e-4, bf16 2e-2 relative), the first Adam moments
   of both networks (f32: each param within 1e-3 of its max; bf16: 5e-2
   in norm), each or 10x the median of what 3 one-ulp nudges of the
   images move the off run (the f32 losses' at most 5e-3), the share of VQ indices that differ, launches a step (84
   GroupNorm forwards, 42 backwards, 4 attention forwards of which 2 with
   lse, 2 dq, 2 dk/dv) and their dtypes; (c) the main path: the
   autoencoder_train CLI, --lpips random, --disc_start 0, 4 steps (cut
   from 100,000) saving every 2, on phase 18's PNGs, launch counters reset
   just before and read just after, equal to 4 steps' calls; a resume
   from step 2 into another directory whose step-4 generator,
   discriminator and both Adam states must be bit-identical; first_stage/
   reloaded at 55,322,782 params and decoded; 4 bf16 steps; 2 f32 steps
   on phase 19's kl-f8 dir (the KL branch), launches exact; (d) the step's
   ms and imgs/s, kernels off, then on (one step each), split into the
   generator's forward, the adaptive weight, the generator's backward and
   Adam, and the discriminator pass; peak memory; a profile by kernel
   class; per-op ms of the GroupNorm forward and backward at (65,536, 128)
   and of the attention forward with lse, dq and dk/dv at (4096, 4096,
   512), against plain, F.group_norm (and its autograd), SDPA (and its
   backward) and the bound, f32 and bf16. Prints the phase's seconds.
22. Text- and retrieval-conditioned LDM serving, f32, TF32 off, three model
   dirs from a seeded init on the card (zero-initialised convs redrawn):
   txt2img-1p4B (UNet 872,300,484 + BERTEmbedder 581,994,042 + kl-f8
   83,653,863 params, written by save_ldm with cond_stage/config.json) and
   a 30,522-entry vocab; inpainting_big + vq-f4-noattn (387,245,827 +
   53,219,486) and 4 image/mask pairs of 256 x 256; rdm768 + kl-f16
   (1,335,480,400 + 69,610,963). (a) Every GroupNorm and attention shape
   (forward hooks, meta device) of a UNet call of each model at its CLI's
   rows, of a BERT encode, of the kl-f8, vq-f4-noattn and kl-f16 decodes and
   the vq-f4-noattn encode, against the plain versions (head-split views;
   txt2img's 8 heads of 40, 80 and 160 over itself and the 77-token
   context, the BERT's 77 tokens at 8 x 64, rdm768's 14-56 heads of 32 over
   itself and a context of 1 or 11, inpainting_big's 8 heads of 64-128;
   head dims and Nkv printed); (b) one txt2img CFG DDIM-10 trajectory
   kernels on against off from one x_T and the same tokens, the latents and
   their kl-f8 decode within LDM_REL_TOL of the largest value, launches
   exact; (d) timings, CUDA events: a UNet call of each model at its CLI's
   rows and a BERT encode, kernels off, on, on, off; txt2img DDIM-10,
   inpaint DDIM-10 and knn2img DDIM-10 batches with their decodes, one
   batch off, one on (imgs/s); a profile of the txt2img UNet call; per-op
   ms at each UNet call's and the BERT's shapes (kernel, plain, SDPA /
   F.group_norm, bound); (c) the main paths, launch counters reset just
   before each and read just after, equal to steps x a UNet call's launches
   + the cond stage's + the codec's: the txt2img CLI at its defaults (256 x
   256, n_samples 4, scale 5) with DDIM-10 (cut from 200) and --plms at 5;
   the inpaint CLI over the pairs, --batch_size 2, --steps 10 (cut from
   50); train_searcher --clip_path random over phase 18's class_000 PNGs
   (no kernel of the port: CLIP's attention is plain in both packages); the
   knn2img CLI at 768 x 768, n_samples 2, --use_neighbors --knn 10,
   DDIM-10 (cut from 50), --clip_path random; the PNGs' count and size and
   each model's parameter count as the CLI loaded it. Prints the phase's
   seconds.
23. Multi-GPU (data-parallel) path, full CIFAR-10 width, B = 128, from
   phase 5's dense checkpoint and phase 10's .npz: (a) a child process of
   this script (``--dp-worker``): the train CLI, 2 steps saving (and a DDIM-100 vis grid of 8) at
   step 2, and the prune CLI (diff-pruning, 3 sweep steps with thr 0,
   --skip_vis), each without and then with --multihost under torchrun's
   environment at world size 1 (each call its own NCCL init; cuDNN
   deterministic): the step-2 params, EMA and Adam state, the sweep's
   losses and grads, the pruner's Diff-Pruning scores and the pruned
   params.npz bit-identical, launch counters reset just before and read
   just after each run, equal to steps x a step's calls (+ the vis grid's
   100 forwards); (b) meanwhile here, in a world-1 NCCL group, the library
   train step (explicit noise and t) and sweep (3 steps) on the whole
   batch, launches exact, then two child processes joined over gloo on the
   one card (NCCL takes one rank a GPU): the same step and sweep on 64 rows
   each, every kernel launched on each rank the exact count, the two
   ranks' params bit-identical, each against the world-1 run at the CPU
   tests' tolerances (DP_RTOL, Adam's bound); then the world-1 step timed
   against the plain one as the train CLI runs it (CUDA events, in turns);
   (c) is phase 16's ldm_sample --multihost run (its PNGs byte-identical
   to the plain run's). Prints the phase's seconds
   and the world-1 step's imgs/s against the plain step's.
24. LSUN-256 path, full width (ddpm_lsun256, 113,673,219 params), B = 16
   (scripts/prune_ddpm_lsun.sh's): (a) a seeded UNet saved in our layout
   and exported by ``convert_checkpoints export-diffusers``; the UNet loaded
   back from the diffusers dir bit-identical; (b) ``make_lsun_lmdb`` over 64
   procedural 256 x 256 PNGs (lossless WEBP under md5 keys), every image
   decoded by the ``lsun:`` source equal to its PNG; (c) the main path: the
   prune CLI on the diffusers dir over ``lsun:`` (diff-pruning, ratio 0.3,
   thr 0.01, 3 sweep steps for 1000, f32), launch
   counters reset just before and read just after, equal to steps x a
   step's calls; (d) every GroupNorm (N 64-65,536, C 128-1024) and attention
   ((256, 256) and (64, 64) at D = 512, and the pruned UNet's head dims)
   shape of the dense and the pruned UNet against the plain versions,
   forward (statistics, lse) and backward, f32 and bf16, at 16 rows; (e) the
   train CLI on the pruned dir over ``lsun:``, --mixed_precision bf16, 4
   steps (cut from 500,000), a save with its DDIM-100 vis grid of 1,
   launches exact, every backward in bf16; (f) the sampling CLI from the
   finetuned dir (8 images, DDIM-4), and its export-diffusers, which loads
   back with its channel sizes bit-identical; (g) per-op ms of the
   GroupNorm forward and backward at (65,536, 128) and the attention forward
   with lse, dq and dk/dv at (256, 256, 512), f32 and bf16, against plain,
   the library call and the bound. Prints the phase's seconds, each CLI's
   seconds and peak memory.
25. The evaluation, LDM, LDM prune, LDM train, unconditional LDM, ablation,
   first-stage training, text LDM, multi-GPU and LSUN JSON lines, the
   kernels' JSON line, nvidia-smi's line, then the result line.

TF32 is off for matmuls and convolutions throughout (printed), so f32
comparisons are f32 against f32.
"""

import collections
import contextlib
import dataclasses
import filecmp
import hashlib
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B = 128
# the DDIM steps of the serving path (phases 5 and 6; cut from the sampling
# CLI's 100) and of phase 7's sampling imgs/s: a step's time does not depend
# on their number
SAMPLE_TIME_STEPS = 20
# forward: |kernel - plain| <= atol + rtol * |plain|. f32: both compute in f32
# and differ only in summation order. bf16: two bf16 ulps; both round an f32
# result once, and the plain attention also rounds its probabilities.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
# backward: |kernel - plain| <= tol * max |plain| per output. Both compute in
# f32 from the same inputs and statistics and differ in summation order,
# then round once to the output dtype (bf16: well under one ulp of the max).
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# kernels on vs off through the whole f32 UNet (outputs of order 1)
FORWARD_TOL_F32 = 1e-3
# the sweep, kernels on vs off, f32, 3 fwd+bwd steps through the full UNet:
# losses to 1e-4 relative; each grad within 1e-3 of its parameter's max
# |grad| (plus 1e-6 of the largest grad overall, for the grads that are zero
# in exact arithmetic, such as to_k's bias); Diff-Pruning scores within 1e-3
# of each var's max score. Sum orders differ through ~60 layers each way.
SWEEP_STEPS = 3
SWEEP_LOSS_RTOL, SWEEP_GRAD_TOL, SWEEP_SCORE_RTOL = 1e-4, 1e-3, 1e-3
# params of the CIFAR UNet pruned locally at ratio 0.3 (pinned from the JAX
# package's pruner in tests/test_torch_pruning.py)
PRUNED_PARAMS_AT_0_3 = 19_951_049
# the finetune path: f32 steps, bf16 steps, the save (and vis) interval,
# vis images; the train step kernels on vs off: 3 steps, losses to 1e-4
# relative, the first step's grads to the sweep's rule (SWEEP_GRAD_TOL)
FT_STEPS, FT_BF16_STEPS, FT_SAVE, FT_VIS = 20, 10, 10, 16
TRAIN_STEPS, TRAIN_LOSS_RTOL = 3, 1e-4
# the bf16 train step kernels on vs off: losses to 2e-2 relative, the first
# step's grads within 5e-2 in norm relative to their norm: the port's bf16
# train-step tolerances against the JAX step (tests/test_torch_training.py),
# since bf16 rounds activations and grads at other places on the two sides
TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GRAD_RTOL = 2e-2, 5e-2
# the evaluation path: the card's pool3 features against the port's plain CPU
# forward, relative error in norm (both f32 with TF32 off; summation order
# only); |FID| of a folder against its own statistics, relative to the trace
# of its covariance: 0 in exact arithmetic, but each of the up to 2048
# eigenvalues that are 0 in exact arithmetic (the features' spread is
# low-rank) adds up to ~sqrt(float64 eps) x the largest through the square
# roots, ~3e-5 of the trace in all; the procedural folder's size
EVAL_FEATURE_RTOL, EVAL_SELF_FID_RTOL, EVAL_IMAGES = 1e-4, 1e-4, 2048
# the LDM serving path (phase 16): cin256-v2 + vq-f4 + ClassEmbedder(1001)
# parameter counts (the JAX package's, tests/test_torch_ldm.py); the batch
# at which imgs/s and the ops are timed and the ldm_sample CLI draws (2 LDM_B
# UNet rows a CFG call): 16 (the CLI's default, 50, is not timed: a CFG
# DDIM-20 batch of 50 and its decode take ~30 s on an H100);
# the batch of the kernels-on-against-off trajectories; DDIM steps, and the
# PLMS and DPM-Solver steps; the guidance scale. Kernels on against off, the
# relative error in norm of the final latents and images: each forward
# differs by f32 summation order (~1e-6 relative), and LDM_STEPS CFG steps at
# scale 3 feed each step's difference, amplified (1 + 2 x 3)-fold in the guided
# eps, into the next
LDM_PARAMS = {"unet": 400_920_579, "first_stage": 55_322_782, "cond_stage": 512_512}
LDM_B, LDM_CMP_B, LDM_STEPS, LDM_MULTI_STEPS, LDM_SCALE = 16, 4, 10, 5, 3.0
LDM_REL_TOL = 1e-3
# the LDM prune path (phase 17): the CLI's batch (labels a sweep step, 2
# LDM_PRUNE_B UNet rows a CFG call, LDM_PRUNE_B rows in the grad step), its
# sweep steps (cut from 1000), vis classes (cut from 4) and CFG DDIM steps
# (cut from the CLI's 20: at 12 rows a CFG call takes ~1 s); the UNet pruned
# locally at 0.3 with round_to 2 (pinned from the JAX package's pruner in
# tests/test_torch_ldm_prune.py). Kernels on against off: the sweep's
# tolerances (SWEEP_*), the backward kernels' (BWD_TOL) with, at Nkv = 1,
# 1e-6 of the call's largest gradient added for dq and dk, which are zero in
# exact arithmetic there (p = 1: both sides hold only f32 noise)
LDM_PRUNE_B, LDM_PRUNE_STEPS, LDM_PRUNE_CLASSES, LDM_PRUNE_DDIM = 6, 3, ("25", "187"), 2
LDM_PRUNED_PARAMS_AT_0_3 = 203_294_971
# the LDM train path (phase 18): the CLI's batch and LR (cin256-v2.yaml: bs
# 16, base_lr 2e-6 x 16), its steps (cut from 20,000), the save interval,
# the procedural images of its 2-class folder. f16 (which the kernels take,
# though the JAX CLI trains in bf16 only) against plain: two f16 ulps forward
# and under one ulp of the max backward, as tests/test_torch_cuda.py holds it
LDM_TRAIN_B, LDM_TRAIN_LR, LDM_TRAIN_STEPS, LDM_TRAIN_SAVE, LDM_TRAIN_IMAGES = \
    16, 2e-6 * 16, 6, 3, 48
F16_TOL, F16_BWD_TOL = (1e-3, 2e-3), 2e-3
# the unconditional LDM path (phase 19): parameter counts (UNet, first stage)
# of CelebA-HQ LDM-VQ-4 and LSUN-churches LDM-KL-8 (the JAX package's presets,
# tests/test_torch_ldm.py); sample_diffusion's batch, DDIM steps and eta on
# CelebA-HQ (cut from its defaults' 50 rows, 250 steps), the churches runs'
# batch and DDIM steps; the on-against-off trajectory's batch; the CIFAR
# PLMS and DPM-Solver++ steps. On against off: the largest difference within
# LDM_REL_TOL of the largest value (latents, images)
UNCOND_PARAMS = {"celebahq": (274_056_163, 55_322_782), "churches": (294_966_916, 83_653_863)}
UNCOND_B, UNCOND_STEPS, UNCOND_ETA, CHURCH_B, CHURCH_STEPS = 16, 10, 1.0, 4, 5
UNCOND_CMP_B, CIFAR_MULTI_STEPS, UNCOND_CLI_B = 4, 20, 50
# the ablation and cost-aware path (phase 20): the prune CLI's sweep steps (cut
# from up to 1000); the finetune's bf16 steps (cut from 100k) and save (and
# vis) interval; prune_ssim's stages (cut from 1, 10, 50, 100, 250, 500 and
# 1000), DDIM steps (cut from 100), images a set and sweep batch. SSIM of a
# folder against itself is 1 exactly in f32: equal inputs give equal filter
# outputs, so each ratio's numerator and denominator are the same number
ABL_PRUNE_STEPS, ABL_FT_STEPS, ABL_FT_SAVE = 5, 6, 3
ABL_STAGES, ABL_DDIM, ABL_N_VIS, ABL_B = (1, 10), 20, 64, 64
ABL_SELF_SSIM_TOL = 1e-6
# one-head attention (N, heads, D) that other scores give the cost-aware
# allocation (the JAX package's, from the seed-0 init with magnitude scores:
# head dims 113, 115 and 121 at 256 tokens), checked beside the card's own
ABL_EXTRA_ATTN = ((256, 1, 113), (256, 1, 115), (256, 1, 121))
# the first-stage training path (phase 21): the autoencoder_train CLI's batch
# (the autoencoder_kl yamls' 12) and resolution, its steps (cut from 100,000)
# and save interval, the steps of its KL run, its LR (4.5e-6 x 12)
AE_B, AE_RES, AE_STEPS, AE_SAVE, AE_KL_STEPS, AE_LR = 12, 256, 4, 2, 2, 4.5e-6 * 12
# the text- and retrieval-conditioned serving paths (phase 22): parameter
# counts of the JAX package's presets (tests/test_torch_ldm.py): txt2img-1p4B
# (UNet, BERTEmbedder, kl-f8), inpainting_big + vq-f4-noattn, rdm768 + kl-f16,
# CLIP ViT-L/14; the prompt, the vocab's size (bert-base-uncased's), the
# txt2img CLI's rows (n_samples 4) and scale, the DDIM steps of txt2img (cut
# from 200) and inpaint (cut from 50), the PLMS run's steps, inpaint's
# image/mask pairs and batch, knn2img's rows (n_samples 2), neighbours and
# DDIM steps (cut from 50; txt2img and inpaint at 10, for 20 before phase 24
# took the time). On against off: LDM_REL_TOL of the largest value
TEXT_PARAMS = {"txt2img": {"unet": 872_300_484, "cond_stage": 581_994_042,
                           "first_stage": 83_653_863},
               "inpaint": (387_245_827, 53_219_486), "knn": (1_335_480_400, 69_610_963),
               "clip": 427_616_513}
TEXT_PROMPT = "a painting of a virus monster playing guitar"
TEXT_VOCAB, TEXT_B, TEXT_SCALE, TEXT_STEPS, TEXT_PLMS_STEPS = 30522, 4, 5.0, 10, 5
TEXT_INPAINT_PAIRS, TEXT_INPAINT_B, TEXT_KNN_B, TEXT_KNN, TEXT_KNN_STEPS = 4, 2, 2, 10, 10
# the LSUN-256 path (phase 24): ddpm_lsun256's parameter count, the rows of
# scripts/prune_ddpm_lsun.sh's prune and train CLIs, the images of its lmdb,
# the sweep's steps (cut from 1000) and thr, the train CLI's steps (cut from
# 500,000), its vis grid, the sampling CLI's images and DDIM steps
LSUN_PARAMS, LSUN_B, LSUN_IMAGES, LSUN_PRUNE_STEPS, LSUN_THR = 113_673_219, 16, 64, 3, 0.01
LSUN_TRAIN_STEPS, LSUN_VIS, LSUN_SAMPLES, LSUN_DDIM = 4, 1, 8, 4
# the step kernels on against off: the phase-18 tolerances, or NOISE_FACTOR x
# what the off run moves when its images move by one ulp, whichever is
# larger: the random codec amplifies f32 rounding through its 44 normalised
# calls (each call's own difference is ~1e-7), and the kernels round
# differently at every call, not only at the input. Phase 21 takes the median
# of AE_NUDGES independent nudges: one nudge's change spans up to 73x between
# draws (ae_gate_probe.py), so a single one made the gate depend on the seed.
# In f32 that allowance is capped at AE_GATE_CAP relative: where the nudges
# move the step by percents (a codebook near many argmin ties) 10x their
# median would pass a kernel fault of that size; 5e-3 is 4x the widest f32
# on/off gap of the 7 codebooks ae_gate_probe.py measured (1.2e-3)
NOISE_FACTOR, AE_NUDGES, AE_GATE_CAP = 10, 3, 5e-3
# the multi-GPU path (phase 23): the global batch (the train CLI's 128, 64
# rows a gloo rank), the train CLI's steps, the sweep's steps (thr off), the
# timed steps a turn, each worker's time limit. The gloo ranks against the
# NCCL world-1 run: the CPU tests' tolerances (tests/test_torch_training.py):
# DP_RTOL relative (a mean of two row means against one mean, and cuDNN's
# algorithms at 64 rows against 128, a few f32 ulps), the params within
# Adam's bound, ADAM_MOVE x lr (twice the most its first bias-corrected
# update moves a param: a grad near eps turns f32 noise into a part of lr)
DP_B, DP_TRAIN_STEPS, DP_SWEEP_STEPS, DP_TIME_ITERS, DP_WORKER_TIMEOUT_S = B, 2, 3, 3, 300
DP_RTOL, ADAM_MOVE = 1e-5, 2.02
# H100 SXM, NVIDIA's data sheet: HBM rate, and peak rates by input type
# (f32 on the CUDA cores, bf16 dense tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
NBYTES = {"float32": 4, "bfloat16": 2}


T_START = time.perf_counter()


def mark(phase: int) -> None:
    """Prints the seconds since the start as ``phase`` begins."""
    print(f"-- phase {phase} at {time.perf_counter() - T_START:.1f} s", flush=True)


def free_port() -> int:
    """A free TCP port on this host for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_env():
    """torchrun's environment for one process at world size 1 (a fresh
    rendezvous port) while the block runs: a --multihost CLI called in it
    makes its own init, as under ``torchrun --nproc_per_node 1``."""
    keys = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def one_turn(fns):
    """Ms of one call of each of ``fns``, in order, after their warm-ups:
    the end-to-end steps timed without a second, reversed turn (phase 23's
    cost paid by fewer turns)."""
    return [cuda_ms(f, iters=1, warmup=0) for f in fns]


def in_turns(fns, iters: int, warmup: int = 2):
    """Mean ms of each of ``fns``, timed in order and then in reverse order
    (two functions: a, b, b, a), each timing after ``warmup`` calls."""
    first = [cuda_ms(f, iters, warmup) for f in fns]
    second = [cuda_ms(f, iters, warmup) for f in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def bound(nbytes: float, flops: float, dname: str):
    """(ms, 'bytes' | 'operations'): the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# bytes each function must move (inputs read once, outputs written once) and
# the operations it does, per call; GroupNorm per element: stats 3, apply 2,
# SiLU 4; backward: reduce 5, apply 7, SiLU derivative 8 in each pass
def gn_fwd_work(n, c, silu, dname):
    el = B * n * c
    return 2 * el * NBYTES[dname] + 2 * c * 4, el * (9 if silu else 5)


def gn_bwd_work(n, c, silu, dname, rows=B):
    el = rows * n * c
    return 3 * el * NBYTES[dname] + rows * 32 * 8 + 4 * c * 4, el * (28 if silu else 12)


def attn_fwd_work(n, h, d, dname):
    return 4 * B * h * n * d * NBYTES[dname], 4 * B * h * n * n * d


def attn_dq_work(n, h, d, dname):
    rows = B * h * n
    return 6 * rows * d * NBYTES[dname] + 2 * rows * 4, 6 * rows * n * d + 2 * rows * d


def attn_dkv_work(n, h, d, dname):
    rows = B * h * n
    return 6 * rows * d * NBYTES[dname] + 2 * rows * 4, 8 * rows * n * d


def ldm_bwd_work(rows, nq, nkv, d, es=4):
    """((bytes, flops) of the dq kernel, (bytes, flops) of the dk/dv kernel)
    for one attention backward of ``rows`` one-head rows of ``es``-byte
    elements: dq reads q, k, v, o, dO and lse and writes dq and dsum; dk/dv
    reads q, k, v, dO, lse and dsum and writes dk and dv."""
    rows_q, rows_kv = rows * nq * d * es, rows * nkv * d * es
    return ((4 * rows_q + 2 * rows_kv + 2 * rows * nq * 4,
             rows * (6 * nq * nkv * d + 2 * nq * d)),
            (2 * rows_q + 4 * rows_kv + 2 * rows * nq * 4, rows * 8 * nq * nkv * d))


def add_bound(tot, prefix, ms, by):
    """Adds a call's bound to ``tot[prefix + 'bound']`` and to the share that
    ``by`` sets, so that ``bound_by(tot, prefix)`` can name the larger."""
    tot[prefix + "bound"] += ms
    tot[f"{prefix}bound_{by}"] += ms


def bound_by(tot, prefix=""):
    return ("bytes" if tot.get(prefix + "bound_bytes", 0.0)
            >= tot.get(prefix + "bound_operations", 0.0) else "operations")


def kernel_class(name: str) -> str:
    n = name.lower()
    if "gn_fwd_kernel" in n:  # the CUDA kernels, mangled
        return "GroupNorm forward"
    if "gn_bwd_kernel" in n:
        return "GroupNorm backward"
    if "flash_fwd_kernel" in n or "flash_bwd_" in n:  # the CUDA kernels, mangled
        return "attention kernels"
    if any(w in n for w in ("conv", "fft", "winograd", "implicit", "grad", "cudnn", "xmma",
                            "flip")):
        return "convolutions"
    if any(w in n for w in ("gemm", "cutlass", "cublas")):
        return "GEMMs"
    if "multi_tensor_apply" in n or "foreach" in n:
        return "optimizer and EMA (foreach)"
    if "reduce" in n:
        return "reductions"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def sass_counts(lib_path):
    """{kernel: (HMMA count, HGMMA count, FFMA count)} from cuobjdump's SASS
    of a built library (HMMA: mma.sync; HGMMA: Hopper's warpgroup wgmma), or
    None where the toolkit has no cuobjdump."""
    from diff_pruning_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(os.path.realpath(_build.nvcc_path())), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], check=True, capture_output=True,
                         text=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0, 0]
        elif name is not None:
            counts[name][0] += " HMMA" in line
            counts[name][1] += " HGMMA" in line
            counts[name][2] += " FFMA" in line
    return counts


def ptxas_by_kernel(log: str, pattern: str, name_of):
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    ``nvcc -Xptxas -v``'s log, for the kernels whose mangled name matches
    ``pattern``, named by ``name_of(match)``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(pattern, line)
        if "Compiling entry function" in line:
            name = name_of(m) if m else None
        elif name is not None and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name] = [None, int(nums[0]), int(nums[1])]
        elif name is not None and "registers" in line and name in out:
            out[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return {k: tuple(v) for k, v in out.items()}


# the kernels whose registers and spills phase 2 prints one by one: the
# attention forward and backward (``flash_fwd_kernel_wgmma_wide<T, NW, Z>``,
# ``flash_fwd_kernel_f32_wide<BQ, NCV>``, ``flash_bwd_dq_kernel_f32<NC>``,
# ``flash_bwd_dkv_kernel_f32_wide<NC2>``, ``flash_bwd_dkv_kernel_mma<T, NC>``,
# ...) and the GroupNorm backward (``gn_bwd_kernel<T, silu>``)
PTXAS_KERNELS = {
    "flash_attention_fwd": (r"Compiling entry function '.*?(flash_fwd_\w+?_(?:f32_wide|f32|"
                            r"wgmma_wide|mma))I(13__nv_bfloat16|6__half)?((?:Li\d+E)+)E",
                            lambda m: f"{m.group(1)}<" + (
                                m.group(2).lstrip("0123456789") + ", " if m.group(2) else "")
                            + ", ".join(re.findall(r"Li(\d+)E", m.group(3))) + ">"),
    "flash_attention_bwd": (r"Compiling entry function '.*?(flash_bwd_\w+?_(?:f32_wide|f32|"
                            r"wgmma_wide|mma_wide|mma))I(13__nv_bfloat16|6__half)?((?:Li\d+E)+)E",
                            lambda m: f"{m.group(1)}<" + (
                                m.group(2).lstrip("0123456789") + ", " if m.group(2) else "")
                            + ", ".join(re.findall(r"Li(\d+)E", m.group(3))) + ">"),
    "group_norm_bwd": (r"Compiling entry function '.*?gn_bwd_kernelI(f|13__nv_bfloat16|6__half)"
                       r"Lb(\d)E",
                       lambda m: f"gn_bwd_kernel<{m.group(1).lstrip('0123456789')}, "
                                 f"silu={m.group(2)}>"),
}


# the attention libraries another version can stand in for: --compare-fwd
# and --compare-bwd, and the C functions each binds
OTHER_LIBS = {"fwd": ("flash_attention_fwd", ("flash_attention_fwd",)),
              "bwd": ("flash_attention_bwd", ("flash_attention_bwd_dq",
                                              "flash_attention_bwd_dkv"))}


def load_other(kind: str, label: str, src: str):
    """The library of another version of flash_attention_{kind}.cu with the
    port's C interface, built as the port builds its own (nvcc, the same
    flags, the port's csrc/ on the include path) and bound as
    ops/attention.py binds it."""
    import ctypes

    from diff_pruning_tpu_torch.ops import _build
    from diff_pruning_tpu_torch.ops import attention as A

    name, fns = OTHER_LIBS[kind]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"lib{name}-{label}.so")
    t0 = time.perf_counter()
    # (-I: the port's shared headers, for a version that includes them)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build._CSRC, "-o", out,
                          os.path.abspath(src)], capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n{res.stderr}")
    print(f"build: {label}: {src} (nvcc sm_90a) {time.perf_counter() - t0:.2f}s")
    lib, ours = ctypes.CDLL(out), A._lib(name)
    for fn in fns:
        getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
        getattr(lib, fn).restype = getattr(ours, fn).restype
    return lib


def with_lib(kind: str, lib, fn):
    """``fn`` as a function that runs it with ops/attention.py's
    flash_attention_{kind} library set to ``lib``."""
    from diff_pruning_tpu_torch.ops import attention as A

    name = OTHER_LIBS[kind][0]

    def run():
        saved = A._LIBS[name]
        A._LIBS[name] = lib
        try:
            return fn()
        finally:
            A._LIBS[name] = saved

    return run


def layout_name(x3) -> str:
    """What a GroupNorm kernel reads: x3 is the (B, ..., C) tensor a layer
    passes."""
    if x3.is_contiguous():
        return "channels-last ((B, N, C) contiguous)"
    if x3.permute(0, x3.dim() - 1, *range(1, x3.dim() - 1)).is_contiguous():
        return "NCHW-contiguous ((B, N, C) strides (C*N, 1, N))"
    return f"other, strides {tuple(x3.stride())}"


def record_gn_layouts(model):
    """Hooks counting the layouts of the GroupNorm inputs; returns (counter,
    remove)."""
    from diff_pruning_tpu_torch.models.layers import GroupNorm

    seen = collections.Counter()

    def hook(mod, args):
        seen[layout_name(args[0].permute(0, 2, 3, 1))] += 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, GroupNorm)]
    return seen, lambda: [h.remove() for h in hooks]


def record_gn_bwd_layouts():
    """Counts the layouts of x and dy as the GroupNorm backward wrapper gets
    them (under autograd); returns (counter, restore)."""
    from diff_pruning_tpu_torch.ops import group_norm as G

    seen, inner = collections.Counter(), G.group_norm_backward

    def wrapped(x, scale, bias, dy, *args, **kwargs):
        seen[f"x {layout_name(x)}, dy {layout_name(dy)}"] += 1
        return inner(x, scale, bias, dy, *args, **kwargs)

    G.group_norm_backward = wrapped
    return seen, lambda: setattr(G, "group_norm_backward", inner)


def record_bwd_dtypes():
    """Counts the (op, dtype) of every GroupNorm and attention backward that
    autograd runs through the kernels' wrappers; returns (counter, restore)."""
    from diff_pruning_tpu_torch.ops import attention as A
    from diff_pruning_tpu_torch.ops import group_norm as G

    seen = collections.Counter()
    gn, attn = G.group_norm_backward, A.flash_attention_backward

    def gn_wrapped(x, *args, **kwargs):
        seen[("group_norm_bwd", str(x.dtype))] += 1
        return gn(x, *args, **kwargs)

    def attn_wrapped(q, *args, **kwargs):
        seen[("attention_bwd", str(q.dtype))] += 1
        return attn(q, *args, **kwargs)

    G.group_norm_backward, A.flash_attention_backward = gn_wrapped, attn_wrapped

    def restore():
        G.group_norm_backward, A.flash_attention_backward = gn, attn

    return seen, restore


def unet_launches(per_call, steps, forwards=0):
    """The kernel launches of ``steps`` forward + backward steps and
    ``forwards`` inference forwards of a UNet with ``per_call`` (GroupNorm,
    attention) calls a forward."""
    g, a = per_call
    return {"group_norm": (steps + forwards) * g, "group_norm_bwd": steps * g,
            "attention": (steps + forwards) * a, "attention_lse": steps * a,
            "attention_bwd_dq": steps * a, "attention_bwd_dkv": steps * a}


def npz_equal(a: str, b: str) -> bool:
    """Whether two .npz files hold the same arrays, bit for bit."""
    import numpy as np

    with np.load(a) as za, np.load(b) as zb:
        return sorted(za.files) == sorted(zb.files) and all(
            za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]) for k in za.files)


def host_us_per_call(fn, calls: int = 200) -> float:
    """The host's enqueue time of ``fn`` per call: perf_counter over
    ``calls`` calls without a sync, after a warm-up."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def profile_classes(fn):
    """Device time by kernel class (ms), the host span (ms), the kernel count
    and the kernel count by class of one run of ``fn``, from torch.profiler's
    CUPTI trace."""
    return profile_kernels(fn)[:4]


def eval_kernel_class(name: str) -> str:
    """The evaluation path's classes: cuDNN convolutions, pools, the rest."""
    if kernel_class(name) == "convolutions":
        return "convolutions"
    return "pools" if "pool" in name.lower() else "the rest"


def profile_kernels(fn, classify=kernel_class):
    """:func:`profile_classes`'s four results, then device ms by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    busy, counts = collections.defaultdict(float), collections.Counter()
    by_name = collections.defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        busy[classify(evt.key)] += us / 1e3
        counts[classify(evt.key)] += evt.count
        by_name[evt.key] += us / 1e3
    return dict(busy), span, sum(counts.values()), dict(counts), dict(by_name)


def print_profile(what, busy, span, launches, counts, per, tag):
    print(f"profile {what} (torch.profiler, device ms per {per[0]} by kernel class): "
          + ", ".join(f"{k} {v / per[1]:.2f}" for k, v in sorted(busy.items()))
          + f"; device busy {sum(busy.values()) / per[1]:.2f} of {span / per[1]:.2f} ms span "
          + "per " + per[0] + ", idle share "
          + (f"{1 - sum(busy.values()) / span:.3f}" if busy else "not measured")
          + f", {launches / per[1]:.0f} kernel launches per {per[0]} ("
          + ", ".join(f"{k} {v / per[1]:.1f}" for k, v in sorted(counts.items())) + f") {tag}")


def cli_pruned_config(cfg, model):
    """The config that the prune CLI writes at ratio 0.3: in local mode the
    kept sizes depend only on the ratio and each var's constraints, so
    magnitude scores of any weights give them."""
    from diff_pruning_tpu_torch.pruning.importance import make_importance
    from diff_pruning_tpu_torch.pruning.pruner import prune
    from diff_pruning_tpu_torch.pruning.surgery import unflatten_params
    from diff_pruning_tpu_torch.utils.checkpoint import flat_from_state_dict

    params = unflatten_params(flat_from_state_dict(model.state_dict()))
    res = prune(model.graph, params, make_importance("magnitude"), sparsity=0.3)
    return cfg.with_channel_sizes(res.channel_sizes)


def pruned_config(cfg):
    from diff_pruning_tpu_torch.models.unet2d import UNet2D

    graph = UNet2D(cfg, device="meta").graph
    return cfg.with_channel_sizes({
        v.name: max(v.group_div, int(0.7 * v.size / v.group_div) * v.group_div)
        for v in graph.prunable_vars()})


def op_shapes(model):
    """Counters of (N, C, silu) per GroupNorm call and (N, heads, D) per
    attention call in one forward (B = 1 on the CPU)."""
    import torch

    from diff_pruning_tpu_torch.models.layers import GroupNorm, SelfAttention2D

    gn, attn = collections.Counter(), collections.Counter()

    def on_gn(mod, args, kwargs, out):
        x = args[0]
        gn[(x.shape[2] * x.shape[3], x.shape[1], bool(kwargs.get("with_silu", False)))] += 1

    def on_attn(mod, args, kwargs, out):
        x = args[0]
        attn[(x.shape[2] * x.shape[3], mod.heads, mod.inner.size // mod.heads)] += 1

    hooks = [m.register_forward_hook(on_gn if isinstance(m, GroupNorm) else on_attn,
                                     with_kwargs=True)
             for m in model.modules() if isinstance(m, (GroupNorm, SelfAttention2D))]
    hw = model.cfg.sample_size
    with torch.inference_mode():
        model(torch.zeros((1, hw, hw, model.cfg.in_channels)), torch.tensor([1]))
    for h in hooks:
        h.remove()
    return gn, attn


def check_forward_kernels(gn_cases, attn_cases, gen, dev, worst, suffixes=("",)):
    """The GroupNorm and attention forward kernels against their plain
    versions at B rows, f32 and bf16, at each (N, C, silu) of ``gn_cases``
    and (N, heads, D) of ``attn_cases`` (phases 3 and 20); raises on a
    disagreement. Each op's largest error goes to ``worst`` under the op's
    name plus each of ``suffixes``."""
    import torch

    from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
    from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference

    for n, c, silu in gn_cases:
        for dname in TOL:
            dtype = getattr(torch, dname)
            x = (torch.randn((B, n, c), generator=gen, device=dev) * 2 + 0.5).to(dtype)
            scale = torch.rand((c,), generator=gen, device=dev) + 0.5
            bias = torch.randn((c,), generator=gen, device=dev) * 0.1
            got = group_norm(x, scale, bias, groups=32, with_silu=silu)
            want = group_norm_reference(x, scale, bias, groups=32, with_silu=silu)
            err, ok = compare(got, want, dname)
            for sfx in suffixes:
                worst[("group_norm" + sfx, dname)] = max(worst[("group_norm" + sfx, dname)],
                                                         err)
            print(f"check group_norm B={B} N={n} C={c} C/g={c // 32} silu={silu} {dname}: "
                  f"max_abs_err={err:.3e} tol={TOL[dname]} {'ok' if ok else 'FAIL'}")
            assert ok, f"group_norm kernel disagrees at N={n} C={c} silu={silu} {dname}"
    for n, h, d in attn_cases:
        for dname in TOL:
            dtype = getattr(torch, dname)
            q, k, v = (torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            got = flash_attention(q, k, v, d ** -0.5)
            want = reference_attention(q, k, v, d ** -0.5)
            err, ok = compare(got, want, dname)
            for sfx in suffixes:
                worst[("attention" + sfx, dname)] = max(worst[("attention" + sfx, dname)], err)
            print(f"check attention B={B} heads={h} N={n} D={d} {dname}: "
                  f"max_abs_err={err:.3e} tol={TOL[dname]} {'ok' if ok else 'FAIL'}")
            assert ok, f"attention kernel disagrees at N={n} D={d} {dname}"


def check_backward_kernels(gn_cases, attn_cases, gen, dev, worst, suffixes=("",)):
    """The GroupNorm backward (with the forward's statistics) and the
    attention forward's lse, dq and dk/dv kernels against their plain
    versions at B rows, f32 and bf16 (phases 8 and 20); as
    :func:`check_forward_kernels`."""
    import torch

    from diff_pruning_tpu_torch.ops import attention as A
    from diff_pruning_tpu_torch.ops import group_norm as G

    for n, c, silu in gn_cases:
        for dname in BWD_TOL:
            dtype, tol = getattr(torch, dname), BWD_TOL[dname]
            x = (torch.randn((B, n, c), generator=gen, device=dev) * 2 + 0.5).to(dtype)
            dy = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            scale = torch.rand((c,), generator=gen, device=dev) + 0.5
            bias = torch.randn((c,), generator=gen, device=dev) * 0.1
            _, mean, rstd = G.group_norm_forward_with_stats(x, scale, bias, groups=32,
                                                            with_silu=silu)
            pmean, prstd = G.group_norm_stats_reference(x, 32)
            got = G.group_norm_backward(x, scale, bias, dy, pmean, prstd, groups=32,
                                        with_silu=silu)
            want = G.group_norm_backward_reference(x, scale, bias, dy, pmean, prstd,
                                                   groups=32, with_silu=silu)
            errs = {}
            for what, a, w, wt in (("mean", mean, pmean, "float32"),
                                   ("rstd", rstd, prstd, "float32"),
                                   ("dx", got[0], want[0], dname),
                                   ("dscale", got[1], want[1], dname),
                                   ("dbias", got[2], want[2], dname)):
                err, ok = compare_rel(a, w, BWD_TOL[wt])
                assert ok, f"group_norm backward {what} disagrees at N={n} C={c} silu={silu} " \
                           f"{dname}: {err:.3e}"
                errs[what] = err
            for sfx in suffixes:
                key, skey = ("group_norm_bwd" + sfx, dname), ("group_norm_stats" + sfx, dname)
                worst[key] = max(worst[key], errs["dx"], errs["dscale"], errs["dbias"])
                worst[skey] = max(worst[skey], errs["mean"], errs["rstd"])
            print(f"check group_norm bwd B={B} N={n} C={c} silu={silu} {dname}: "
                  + " ".join(f"{k}={e:.3e}" for k, e in errs.items())
                  + f" tol={tol} x max|want| ok")
    for n, h, d in attn_cases:
        for dname in BWD_TOL:
            dtype, tol = getattr(torch, dname), BWD_TOL[dname]
            q, k, v, do = (torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            scale = d ** -0.5
            _, lse = A.flash_attention_forward_lse(q, k, v, scale)
            o, plse = A.reference_attention_lse(q, k, v, scale)
            dq, dsum = A.flash_attention_backward_dq(q, k, v, o, do, plse, scale)
            pdq, pdsum = A.attention_backward_dq_reference(q, k, v, o, do, plse, scale)
            dk, dv = A.flash_attention_backward_dkv(q, k, v, do, plse, pdsum, scale)
            pdk, pdv = A.attention_backward_dkv_reference(q, k, v, do, plse, pdsum, scale)
            errs = {}
            for what, a, w, wt in (("lse", lse, plse, "float32"),
                                   ("dsum", dsum, pdsum, "float32"),
                                   ("dq", dq, pdq, dname), ("dk", dk, pdk, dname),
                                   ("dv", dv, pdv, dname)):
                err, ok = compare_rel(a, w, BWD_TOL[wt])
                assert ok, f"attention backward {what} disagrees at N={n} D={d} {dname}: " \
                           f"{err:.3e}"
                errs[what] = err
            for sfx in suffixes:
                for key, parts in (("attention_lse", ("lse",)),
                                   ("attention_bwd_dq", ("dq", "dsum")),
                                   ("attention_bwd_dkv", ("dk", "dv"))):
                    worst[(key + sfx, dname)] = max(worst[(key + sfx, dname)],
                                                    *(errs[p] for p in parts))
            print(f"check attention bwd B={B} heads={h} N={n} D={d} {dname}: "
                  + " ".join(f"{k}={e:.3e}" for k, e in errs.items())
                  + f" tol={tol} x max|want| ok")


def compare(got, want, dtype):
    import torch

    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (err <= atol + rtol * want.float().abs()).all())
    return float(err.max()), ok


def compare_rel(got, want, tol):
    """(max abs err, ok) for |got - want| <= tol * max |want|."""
    import torch

    err = float((got.float() - want.float()).abs().max())
    ok = (got.shape == want.shape and bool(torch.isfinite(got.float()).all())
          and err <= tol * float(want.float().abs().max()))
    return err, ok


def run_cli(main_fn, argv):
    """Runs a CLI's ``main`` with its output captured, then prints it:
    (return value, output, wall seconds up to a device sync)."""
    import io

    import torch

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main_fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    return out, buf.getvalue(), seconds


def evaluation_path(tmp, sample_dirs, gpu, tag):
    """Phase 15 (see the module docstring); returns its figures."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image

    from diff_pruning_tpu_torch.cli import fid_score, fidelity
    from diff_pruning_tpu_torch.data.datasets import get_dataset
    from diff_pruning_tpu_torch.data.procedural import make_procedural_dataset
    from diff_pruning_tpu_torch.eval.fid import features_of_path
    from diff_pruning_tpu_torch.eval.inception import (fid_inception, inception_pool3,
                                                       random_init_fid_inception_state_dict)
    from diff_pruning_tpu_torch.eval.resize import resize_bicubic_pil

    dev = torch.device("cuda", 0)
    sd = random_init_fid_inception_state_dict(0)
    plain, card = fid_inception(sd, "cpu"), fid_inception(sd, dev)

    def pool3(model, x, mode):
        with torch.inference_mode():
            if mode == "clean":
                return inception_pool3(model, resize_bicubic_pil(x, 299, 299), resize=False)
            return inception_pool3(model, x)

    out = {"card": gpu, "inception": "random init, seed 0", "feature_rel_err": {}}
    for hw in (32, 512):
        x = torch.from_numpy(make_procedural_dataset(n=8, hw=hw, seed=1)).float() / 255.0
        for mode in ("torch", "clean"):
            want = pool3(plain, x, mode)
            got = pool3(card, x.to(dev), mode).cpu()
            err = float((got - want).norm() / want.norm())
            out["feature_rel_err"][f"{mode}/{hw}"] = err
            print(f"check inception pool3 {mode} {hw}x{hw} -> 299, 8 images, f32: card against "
                  f"the plain CPU forward, relative error in norm {err:.3e} "
                  f"(tol {EVAL_FEATURE_RTOL}), |feature| max {float(want.abs().max()):.2f}")
            assert got.shape == (8, 2048) and bool(torch.isfinite(got).all())
            assert err <= EVAL_FEATURE_RTOL, (mode, hw, err)

    # the fid_score CLI: stats of a procedural folder, then sample folders against them
    proc = os.path.join(tmp, "procedural")
    os.makedirs(proc)
    for i, im in enumerate(make_procedural_dataset(n=EVAL_IMAGES, hw=32, seed=0)):
        Image.fromarray(im).save(os.path.join(proc, f"{i:05d}.png"))
    stats, clean_stats = (os.path.join(tmp, f"procedural_{m}.npz") for m in ("torch", "clean"))
    seed = ["--random-init-seed", "0", "--device", "cuda"]
    _, _, t_save = run_cli(fid_score.main, [proc, stats, "--save-stats"] + seed)
    fids = {}
    for name, d in sample_dirs.items():
        fids[name], _, _ = run_cli(fid_score.main, [d, stats] + seed)
    fids["procedural_self"], _, t_self = run_cli(fid_score.main, [proc, stats] + seed)
    with np.load(stats) as z:
        trace = float(np.trace(z["sigma"]))
        assert z["mu"].shape == (2048,) and z["sigma"].shape == (2048, 2048)
    print(f"fid_score CLI, random-init Inception seed 0, 2048 procedural 32x32 PNGs: "
          f"--save-stats {t_save:.2f} s ({EVAL_IMAGES / t_save:.1f} imgs/s), the folder against "
          f"its stats {t_self:.2f} s ({EVAL_IMAGES / t_self:.1f} imgs/s) (wall, B={B}, f32) {tag}; "
          f"FID dense {fids['dense']:.4f}, pruned {fids['pruned']:.4f}, self "
          f"{fids['procedural_self']:.3e} (tol {EVAL_SELF_FID_RTOL} x trace {trace:.4f})")
    assert all(math.isfinite(v) for v in fids.values()), fids
    assert abs(fids["procedural_self"]) <= EVAL_SELF_FID_RTOL * trace, fids
    _, _, t_clean = run_cli(fid_score.main, [proc, clean_stats, "--save-stats", "--clean"] + seed)
    fids["dense_clean"], _, _ = run_cli(fid_score.main,
                                        [sample_dirs["dense"], clean_stats, "--clean"] + seed)
    _, text, _ = run_cli(fid_score.main, [sample_dirs["dense"], clean_stats] + seed)
    assert "resize_mode=clean but this run uses torch" in text, text
    print(f"fid_score CLI --clean: --save-stats {t_clean:.2f} s "
          f"({EVAL_IMAGES / t_clean:.1f} imgs/s) {tag}; FID dense {fids['dense_clean']:.4f}; "
          "clean stats read in torch mode warn")
    assert math.isfinite(fids["dense_clean"])

    # the fidelity CLI, with the random init plus a seeded fc head as a .pth
    rng = np.random.default_rng(7)
    weights = os.path.join(tmp, "fid_inception_random_fc.pth")
    torch.save({**sd, "fc.weight": torch.from_numpy(
        rng.standard_normal((1008, 2048)).astype(np.float32) * 0.02),
        "fc.bias": torch.from_numpy(rng.standard_normal(1008).astype(np.float32) * 0.1)},
        weights)
    metrics, _, t_fidelity = run_cli(fidelity.main, [
        "--input1", sample_dirs["dense"], "--input2", proc, "--weights", weights,
        "--device", "cuda"])
    print(f"fidelity CLI, dense samples against the procedural folder: {t_fidelity:.2f} s "
          f"(wall) {tag}")
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    # the Inception Score is exp of a mean KL >= 0: [1, 1008] up to float rounding
    assert 1.0 - 1e-9 <= metrics["inception_score_mean"] <= 1008.0, metrics
    assert 0.0 <= metrics["precision"] <= 1.0 and 0.0 <= metrics["recall"] <= 1.0, metrics

    # timings: the Inception at B = 128 on a batch of the folder's decoded size
    macs = 0

    def count(mod, inp, res):
        nonlocal macs
        macs += res.numel() * mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]

    hooks = [m.register_forward_hook(count) for m in card.modules()
             if isinstance(m, torch.nn.Conv2d)]
    pool3(card, torch.zeros((1, 299, 299, 3), device=dev), "torch")
    for h in hooks:
        h.remove()
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.rand((B, 256, 256, 3), generator=gen, device=dev)
    ms_torch, ms_clean = in_turns([lambda: pool3(card, x, "torch"),
                                   lambda: pool3(card, x, "clean")], iters=2)
    tflops = 2 * macs * B / (ms_torch / 1e3) / 1e12
    print(f"time inception B={B} 256x256 -> 299, f32: torch mode {ms_torch:.2f} ms "
          f"({B * 1e3 / ms_torch:.1f} imgs/s, {tflops:.1f} TFLOP/s of convolutions at "
          f"{macs / 1e9:.3f} GMACs an image), clean mode {ms_clean:.2f} ms "
          f"({B * 1e3 / ms_clean:.1f} imgs/s) (CUDA events, in turns, 2 calls each) {tag}")
    # the host's share: the folder's decode and 256x256 resize alone, as
    # features_of_path runs it (16 threads), and on one thread
    ds = get_dataset(proc)
    n16, n1 = min(512, EVAL_IMAGES), min(128, EVAL_IMAGES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=16) as pool:
        assert len(list(pool.map(ds.load, range(n16)))) == n16
    t_decode = (time.perf_counter() - t0) * EVAL_IMAGES / n16
    t0 = time.perf_counter()
    for i in range(n1):
        ds.load(i)
    t_decode1 = (time.perf_counter() - t0) * EVAL_IMAGES / n1
    print(f"host decode + 256x256 resize of the PNGs (PIL): "
          f"{EVAL_IMAGES / t_decode:.1f} imgs/s on 16 threads ({n16} images), "
          f"{EVAL_IMAGES / t_decode1:.1f} on one ({n1} images), "
          f"{os.cpu_count()} CPUs {tag}")
    busy, span, launches, counts, _ = profile_kernels(
        lambda: features_of_path(proc, card, batch_size=B, max_images=512), eval_kernel_class)
    print_profile("features_of_path, 512 procedural PNGs", busy, span, launches, counts,
                  ("512 images", 1), tag)
    out.update(
        fid=fids, fid_trace=trace, inception_gmacs_per_image=macs / 1e9,
        inception_imgs_per_s={"torch": B * 1e3 / ms_torch, "clean": B * 1e3 / ms_clean},
        inception_ms_b128={"torch": ms_torch, "clean": ms_clean}, inception_tflops=tflops,
        fid_cli_seconds={"save_stats": t_save, "self": t_self, "save_stats_clean": t_clean},
        fid_cli_imgs_per_s={"save_stats": EVAL_IMAGES / t_save, "self": EVAL_IMAGES / t_self,
                            "save_stats_clean": EVAL_IMAGES / t_clean},
        fidelity=metrics, fidelity_cli_seconds=t_fidelity,
        host_decode_imgs_per_s={"16_threads": EVAL_IMAGES / t_decode,
                                "1_thread": EVAL_IMAGES / t_decode1},
        profile_512={"busy_ms": busy, "span_ms": span, "launches": launches,
                     "idle_share": 1 - sum(busy.values()) / span})
    return out


def op_calls(model, fwd):
    """Counters of (N, C, eps, silu) per GroupNorm call and (Nq, Nkv, heads,
    D) per attention call of ``fwd(model)`` (forward hooks, no grad)."""
    import torch

    from diff_pruning_tpu_torch.models.layers import CrossAttention, GroupNorm, SelfAttention2D

    gn, attn = collections.Counter(), collections.Counter()

    def on_gn(mod, args, kwargs, out):
        x = args[0]
        gn[(x.shape[2] * x.shape[3], x.shape[1], mod.eps,
            bool(kwargs.get("with_silu", False)))] += 1

    def on_attn(mod, args, kwargs, out):
        x = args[0]
        d = mod.inner.size // mod.heads
        if isinstance(mod, SelfAttention2D):
            n = x.shape[2] * x.shape[3]
            attn[(n, n, mod.heads, d)] += 1
        else:
            ctx = args[1] if len(args) > 1 and args[1] is not None else x
            attn[(x.shape[1], ctx.shape[1], mod.heads, d)] += 1

    hooks = [m.register_forward_hook(on_gn if isinstance(m, GroupNorm) else on_attn,
                                     with_kwargs=True)
             for m in model.modules()
             if isinstance(m, (GroupNorm, SelfAttention2D, CrossAttention))]
    with torch.no_grad():
        fwd(model)
    for h in hooks:
        h.remove()
    return gn, attn


def ldm_op_shapes(unet_cfg, fs_cfg, encode=False, nkv=1):
    """:func:`op_calls` of one UNet call (with a context of ``nkv`` tokens
    where the UNet takes one) and one first-stage decode (with ``encode``,
    also of one encode of an image at the decode's resolution), on the meta
    device (shapes only)."""
    import torch

    from diff_pruning_tpu_torch.models.unet_cond import UNetCond
    from diff_pruning_tpu_torch.models.vae import make_first_stage

    meta = torch.device("meta")
    hw, ch = unet_cfg.image_size, unet_cfg.in_channels
    ctx = (None if unet_cfg.context_dim is None
           else torch.zeros((1, nkv, unet_cfg.context_dim), device=meta))
    unet = op_calls(UNetCond(unet_cfg, device=meta), lambda m: m(
        torch.zeros((1, hw, hw, ch), device=meta), torch.zeros((1,), dtype=torch.int64,
                                                               device=meta), context=ctx))
    fs = make_first_stage(fs_cfg, device=meta)
    decode = op_calls(fs, lambda m: m.decode(torch.zeros((1, hw, hw, unet_cfg.out_channels),
                                                         device=meta)))
    if not encode:
        return unet, decode
    res = hw * 2 ** (len(fs_cfg.block_out_channels) - 1)
    return unet, decode, op_calls(fs, lambda m: m.encode(torch.zeros((1, res, res, 3),
                                                                     device=meta)))


def sdpa_backend(fn) -> str:
    """Which backend F.scaled_dot_product_attention (or its backward) took,
    from the ATen ops it dispatched to (torch.profiler's CPU events, which a
    short profile keeps where its device events can be lost)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = " ".join(e.key for e in prof.key_averages()).lower()
    for key, name in (("flash_attention", "flash"), ("efficient_attention",
                                                      "efficient (CUTLASS fmha)"),
                      ("cudnn_attention", "cuDNN")):
        if key in names:
            return name
    return "math (matmul + softmax)" if "softmax" in names else "unknown"


# the wide forward kernels' tile edges (phases 16 and 18): Nq and Nkv around
# the 32- and 64-row query tiles and the 16- to 128-row kv tiles, at the head
# dims where the tiling changes (D_pad 384, 512, 640, 1024), one head; then
# head-split views of fused (B, N, 3 heads D) projections with 3 heads at D =
# 268 and 269 (in 16 bits rows 8- and 2-byte aligned)
EDGE_NS = (1, 31, 33, 63, 65, 127)
EDGE_DS = (257, 384, 512, 513, 1024)


def check_wide_edges(dnames, gen, dev, worst, key):
    """Each forward kernel at the tile edges, inference and with lse, against
    the plain versions, in each of ``dnames``; the largest error goes to
    ``worst[(key, dname)]``."""
    import torch

    from diff_pruning_tpu_torch.ops import attention as A

    cases = [(1, 1, nq, nkv, d, False) for d in EDGE_DS for nq in EDGE_NS for nkv in EDGE_NS]
    cases += [(2, 3, 64, 64, d, True) for d in (268, 269)]
    for dname in dnames:
        dtype = getattr(torch, dname)
        atol, rtol = TOL.get(dname, F16_TOL)
        errs = []
        for b, h, nq, nkv, d, fused in cases:
            if fused:
                t = torch.randn((b, nq, 3 * h * d), generator=gen, device=dev).to(dtype)
                q, k, v = (z.view(b, nq, h, d).transpose(1, 2) for z in t.split(h * d, dim=-1))
            else:
                q = torch.randn((b, h, nq, d), generator=gen, device=dev).to(dtype)
                k, v = (torch.randn((b, h, nkv, d), generator=gen, device=dev).to(dtype)
                        for _ in range(2))
            got = A.flash_attention(q, k, v, d ** -0.5)
            want = A.reference_attention(q, k, v, d ** -0.5)
            err = (got.float() - want.float()).abs()
            ok = bool(torch.isfinite(got.float()).all()) and bool(
                (err <= atol + rtol * want.float().abs()).all())
            o, lse = A.flash_attention_forward_lse(q, k, v, d ** -0.5)
            lse_err, lse_ok = compare_rel(lse, A.reference_attention_lse(q, k, v, d ** -0.5)[1],
                                          BWD_TOL["float32"])
            assert ok and lse_ok and torch.equal(o, got), (dname, b, h, nq, nkv, d, fused,
                                                           float(err.max()), lse_err)
            errs.append((float(err.max()), lse_err))
        worst[(key, dname)] = max(worst[(key, dname)], max(e for e, _ in errs))
        print(f"check wide attention tile edges {dname}: Nq, Nkv in {EDGE_NS} at D in {EDGE_DS} "
              f"and 3-head fused views at D = 268, 269 ({len(cases)} shapes), inference and with "
              f"lse: max_abs_err={max(e for e, _ in errs):.3e} tol={(atol, rtol)}, lse "
              f"{max(e for _, e in errs):.3e} (tol {BWD_TOL['float32']} x max|want|) ok")


# the wide 16-bit backward's tile edges (phase 18): Nq and Nkv in EDGE_NS at
# EDGE_DS, at 16 rows of 16 heads, so that the C entry points take the wgmma
# kernels (launch_dq16, launch_dkv16 in flash_attention_bwd.cu: the 16-row
# kernels take the short calls); then head-split views of fused (B, N, 3
# heads D) projections, 3 x 268, 3 x 269 and 2 x 270 (rows 8-, 2- and 4-byte
# aligned), at 256 tokens
EDGE_BWD_ROWS, EDGE_BWD_HEADS = 16, 16
EDGE_BWD_FUSED = ((3, 268), (3, 269), (2, 270))


def wgmma_bwd_taken(b, h, nq, nkv):
    """Whether flash_attention_bwd.cu's entry points take the wgmma dq and
    dk/dv kernels at (B, H, Nq, Nkv) (launch_dq16, launch_dkv16)."""
    return (nkv >= 256 or b * h * -(-nq // 64) >= 256, b * h * -(-nkv // 64) >= 64)


def f32_wide_bwd_split(b, h, nq, nkv, d):
    """The q parts (1, 2 or 4) over which flash_attention_bwd.cu's wide f32
    dk/dv splits its loop at (B, H, Nq, Nkv, D) (launch_dkv_f32_wide): more
    blocks of its cluster of ceil(D / 192) where the grid is short, each
    part 2 q tiles of 32 rows or more."""
    zd = -(-d // 192)
    zq = 1
    if b * h * -(-nkv // 32) * zd < 132:
        while 2 * zq * zd <= 8 and 4 * zq <= -(-nq // 32):
            zq *= 2
    return zq


def bwd_l2_bytes(nq, nkv, d, q_rows, kv_rows, es=2):
    """Bytes a wide dq kernel fetches from L2 per q row and a dk/dv kernel
    per kv row, from its tiling (valid rows and columns, ``es`` bytes an
    element): its own rows once (dq: Q, dO, O; dk/dv: K, V), and each
    streamed row (dq: K and V; dk/dv: Q, dO, lse and D) once per tile of
    ``q_rows`` (dq) or ``kv_rows`` (dk/dv) rows."""
    return (3 * es * d + 2 * es * d * nkv / min(q_rows, nq),
            2 * es * d + (2 * es * d + 8) * nq / min(kv_rows, nkv))


def bwd_edge_errors(b, h, nq, nkv, d, fused, dtype, btol, gen, dev):
    """dq and dk/dv at one shape (fused: head-split views of (B, N, 3 H D)
    projections), chained as the backward chains them (dk/dv reads dq's
    dsum), against the plain versions computed in float64 at the backward's
    tolerances: where Nkv = 1, dq and dk are zero in exact arithmetic, and
    at a few q rows the f32 plain version's own cancellation noise (dO v^T -
    D) reaches the 1e-6 floor that the tolerance adds for them; returns the
    largest error of each output."""
    import torch

    from diff_pruning_tpu_torch.ops import attention as A

    if fused:
        t = torch.randn((b, nq, 3 * h * d), generator=gen, device=dev).to(dtype)
        q, k, v = (z.view(b, nq, h, d).transpose(1, 2) for z in t.split(h * d, dim=-1))
        do = torch.randn((b, nq, 3 * h * d), generator=gen, device=dev).to(dtype)[
            ..., :h * d].view(b, nq, h, d).transpose(1, 2)
    else:
        q, do = (torch.randn((b, h, nq, d), generator=gen, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn((b, h, nkv, d), generator=gen, device=dev).to(dtype)
                for _ in range(2))
    scale = d ** -0.5
    o, lse = A.reference_attention_lse(q, k, v, scale)
    dq, dsum = A.flash_attention_backward_dq(q, k, v, o, do, lse, scale)
    dk, dv = A.flash_attention_backward_dkv(q, k, v, do, lse, dsum, scale)
    f64 = torch.float64
    pdq, pdsum = A.attention_backward_dq_reference(q, k, v, o, do, lse, scale, compute_dtype=f64)
    pdk, pdv = A.attention_backward_dkv_reference(q, k, v, do, lse, pdsum, scale,
                                                  compute_dtype=f64)
    floor = (1e-6 * max(float(g.double().abs().max()) for g in (pdq, pdk, pdv))
             if nkv == 1 else 0.0)
    errs = {}
    for what, a, w, tol, fl in (("dsum", dsum, pdsum, BWD_TOL["float32"], 0.0),
                                ("dq", dq, pdq, btol, floor), ("dk", dk, pdk, btol, floor),
                                ("dv", dv, pdv, btol, 0.0)):
        e = float((a.double() - w.double()).abs().max())
        assert bool(torch.isfinite(a.float()).all()) and \
            e <= tol * float(w.double().abs().max()) + fl, \
            (str(dtype), b, h, nq, nkv, d, fused, what, e)
        errs[what] = e
    return errs


def check_wide_bwd_edges(gen, dev, worst):
    """The wide 16-bit dq and dk/dv kernels at their tile edges, bf16 and
    f16, against the plain versions in float64 (bwd_edge_errors); the
    largest errors go to ``worst``."""
    import torch

    cases = [(EDGE_BWD_ROWS, EDGE_BWD_HEADS, nq, nkv, d, False)
             for d in EDGE_DS for nq in EDGE_NS for nkv in EDGE_NS]
    cases += [(8, h, 256, 256, d, True) for h, d in EDGE_BWD_FUSED]
    for dname, btol in (("bfloat16", BWD_TOL["bfloat16"]), ("float16", F16_BWD_TOL)):
        errs = collections.defaultdict(float)
        for b, h, nq, nkv, d, fused in cases:
            assert all(wgmma_bwd_taken(b, h, nq, nkv)), (b, h, nq, nkv)
            for what, e in bwd_edge_errors(b, h, nq, nkv, d, fused, getattr(torch, dname), btol,
                                           gen, dev).items():
                errs[what] = max(errs[what], e)
        worst[("attention_bwd_dq_ldm_train", dname)] = max(
            worst[("attention_bwd_dq_ldm_train", dname)], errs["dq"], errs["dsum"])
        worst[("attention_bwd_dkv_ldm_train", dname)] = max(
            worst[("attention_bwd_dkv_ldm_train", dname)], errs["dk"], errs["dv"])
        print(f"check wide attention bwd tile edges {dname}: Nq, Nkv in {EDGE_NS} at D in "
              f"{EDGE_DS} ({EDGE_BWD_ROWS} rows x {EDGE_BWD_HEADS} heads) and fused views "
              f"{EDGE_BWD_FUSED} (heads x D, 256 tokens), {len(cases)} shapes, the wgmma dq and "
              f"dk/dv against the plain versions in float64: "
              + " ".join(f"{k_}={e:.3e}" for k_, e in errs.items())
              + f" (tol {btol} x max|want|, + 1e-6 of the call's largest gradient for dq and dk "
              f"at Nkv = 1; dsum {BWD_TOL['float32']}) ok")


# the wide f32 backward's tile edges (phase 17): Nq and Nkv in EDGE_NS
# around its 32-row tiles at the head dims where its cluster grows
# (192-column slices: 2 blocks up to 384, 3 up to 576, 6 at 1024), at 16
# rows of 16 heads (dk/dv unsplit) and at 1 row of 2 heads (dk/dv splitting
# its q loop over 2 blocks; over 4 at 257 q rows), plus EDGE_BWD_FUSED's
# views at 256 tokens at 8 and 1 rows
EDGE_F32_DS = (257, 384, 385, 576, 577, 1024)
EDGE_F32_SIZES = ((EDGE_BWD_ROWS, EDGE_BWD_HEADS), (1, 2))


def check_wide_bwd_edges_f32(gen, dev, worst):
    """The wide f32 dq and dk/dv kernels at their tile edges against the
    plain versions in float64 (bwd_edge_errors), through each route of the
    entry points; the largest errors go to ``worst``."""
    import torch

    cases = [(b, h, nq, nkv, d, False) for b, h in EDGE_F32_SIZES for d in EDGE_F32_DS
             for nq in EDGE_NS for nkv in EDGE_NS]
    cases += [(1, 2, 257, nkv, d, False) for d in EDGE_F32_DS[:2] for nkv in (1, 33)]
    cases += [(b, h, 256, 256, d, True) for b in (8, 1) for h, d in EDGE_BWD_FUSED]
    routes = {f32_wide_bwd_split(b, h, nq, nkv, d) for b, h, nq, nkv, d, _ in cases}
    assert routes == {1, 2, 4}, routes
    errs = collections.defaultdict(float)
    for b, h, nq, nkv, d, fused in cases:
        for what, e in bwd_edge_errors(b, h, nq, nkv, d, fused, torch.float32,
                                       BWD_TOL["float32"], gen, dev).items():
            errs[what] = max(errs[what], e)
    worst[("attention_bwd_dq_ldm", "float32")] = max(
        worst[("attention_bwd_dq_ldm", "float32")], errs["dq"], errs["dsum"])
    worst[("attention_bwd_dkv_ldm", "float32")] = max(
        worst[("attention_bwd_dkv_ldm", "float32")], errs["dk"], errs["dv"])
    print(f"check wide attention bwd tile edges float32: Nq, Nkv in {EDGE_NS} at D in "
          f"{EDGE_F32_DS} at (rows, heads) {EDGE_F32_SIZES}, Nq = 257 at 1 x 2, and fused views "
          f"{EDGE_BWD_FUSED} (heads x D, 256 tokens) at 8 and 1 rows, {len(cases)} shapes, dk/dv in q parts "
          f"{sorted(routes)}, against the plain versions in float64: "
          + " ".join(f"{k_}={e:.3e}" for k_, e in errs.items())
          + f" (tol {BWD_TOL['float32']} x max|want|, + 1e-6 of the call's largest gradient for "
          f"dq and dk at Nkv = 1) ok")


def time_ldm_ops(gn_cases, attn_cases, rows, gen, dev, tag, what, others_fwd):
    """Phase 16's per-op timings at ``rows`` batch rows: the GroupNorm and
    attention forwards (kernel, plain, library call, bound, and the other
    attention forwards of ``others_fwd``, label -> library, in the same
    turns), summed over the calls of one ``what``; returns {op: totals}."""
    import torch
    import torch.nn.functional as F

    from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
    from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference

    out = {}
    for op, cases in (("group_norm", gn_cases), ("attention", attn_cases)):
        if not cases:
            continue
        tot = collections.defaultdict(float)
        for shape, calls in sorted(cases.items()):
            if op == "group_norm":
                n, c, eps, silu = shape
                x = torch.randn((rows, n, c), generator=gen, device=dev)
                s, b = torch.rand(c, generator=gen, device=dev) + 0.5, torch.zeros(c, device=dev)
                kw = dict(groups=32, eps=eps, with_silu=silu)
                fns = [lambda: group_norm_reference(x, s, b, **kw), lambda: group_norm(x, s, b, **kw)]
                if not silu:  # F.group_norm on its own (B, C, N) layout
                    xl = x.transpose(1, 2).contiguous()
                    fns.append(lambda: F.group_norm(xl, 32, s, b, eps=eps))
                el = rows * n * c
                nbytes, flops = 2 * el * 4 + 2 * c * 4, el * (9 if silu else 5)
                iters = 2 if el > 2e8 else 5
            else:
                nq, nkv, h, d = shape
                q = torch.randn((rows, h, nq, d), generator=gen, device=dev)
                k, v = (torch.randn((rows, h, nkv, d), generator=gen, device=dev)
                        for _ in range(2))
                fns = [lambda: reference_attention(q, k, v, d ** -0.5),
                       lambda: flash_attention(q, k, v, d ** -0.5),
                       lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)]
                fns += [with_lib("fwd", lib, lambda: flash_attention(q, k, v, d ** -0.5))
                        for lib in others_fwd.values()]
                nbytes = 4 * rows * h * (2 * nq + 2 * nkv) * d
                flops = 4 * rows * h * nq * nkv * d
                iters = 2 if nq * nkv > 4e6 else 5
            pm, km, *lib = in_turns(fns, iters=iters)
            other_ms = {}
            if op == "attention":
                lib, other_ms = lib[:1], dict(zip(others_fwd, lib[1:]))
            for label, oms in other_ms.items():
                tot[f"kernel_{label}"] += oms * calls
            bms, by = bound(nbytes, flops, "float32")
            tot["kernel"] += km * calls
            tot["plain"] += pm * calls
            tot["flops"] += flops * calls
            add_bound(tot, "", bms * calls, by)
            extra = ""
            if lib:
                tot["library"] += lib[0] * calls
                tot["kernel_where_library"] += km * calls
            if op == "attention":
                backend = sdpa_backend(fns[2])
                tot.setdefault("backends", set()).add(backend)
                extra = (f", {flops / km / 1e9:.2f} TFLOP/s (plain {flops / pm / 1e9:.2f}, "
                         f"SDPA {flops / lib[0] / 1e9:.2f} via {backend})")
            extra += "".join(f", {label} kernel {oms:.4f} ms" for label, oms in other_ms.items())
            print(f"time ldm {op} fwd {shape} x{calls}/{what} rows={rows} float32: kernel "
                  f"{km:.4f} ms, plain {pm:.4f} ms, library "
                  f"{f'{lib[0]:.4f} ms' if lib else '-'}, bound {bms:.4f} ms ({by}){extra} {tag}")
            del fns
        if "backends" in tot:
            tot["backends"] = sorted(tot["backends"])
        tot["tflops"] = tot["flops"] / tot["kernel"] / 1e9
        tot["bound_by"] = bound_by(tot)
        out[op] = dict(tot)
        print(f"time ldm {op} fwd per {what} rows={rows} float32: kernel {tot['kernel']:.4f} ms, "
              f"plain {tot['plain']:.4f} ms, bound {tot['bound']:.4f} ms ({tot['bound_by']}), "
              f"library {tot.get('library', 0.0):.4f} ms against kernel "
              f"{tot.get('kernel_where_library', 0.0):.4f} ms on the calls it covers, "
              f"{tot['tflops']:.2f} TFLOP/s"
              + "".join(f", {label} kernel {tot[f'kernel_{label}']:.4f} ms"
                        for label in (others_fwd if op == "attention" else ()))
              + f" {tag}")
    return out


def ldm_path(tmp, gen, gpu, tag, worst, others_fwd):
    """Phase 16 (see the module docstring); returns the loaded model, its
    model dir and the phase's figures."""
    import numpy as np
    import torch

    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.cli import ldm_sample
    from diff_pruning_tpu_torch.models.latent_diffusion import LatentDiffusion, load_ldm
    from diff_pruning_tpu_torch.models.unet_cond import cin256_v2_config
    from diff_pruning_tpu_torch.models.vae import first_stage_config, make_first_stage
    from diff_pruning_tpu_torch.ops import attention as A
    from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
    from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference
    from diff_pruning_tpu_torch.pruning.importance import make_importance
    from diff_pruning_tpu_torch.pruning.pruner import prune
    from diff_pruning_tpu_torch.pruning.surgery import unflatten_params
    from diff_pruning_tpu_torch.utils.checkpoint import flat_from_state_dict, save_ldm

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    # the model: a seeded init on the card, the zero-initialised leaves drawn
    # like every other conv, saved and loaded back through load_ldm
    ucfg, fcfg = cin256_v2_config(), first_stage_config("vq-f4")
    built = LatentDiffusion(ucfg, n_classes=1001, device=dev,
                            first_stage=make_first_stage(fcfg, device=dev))
    g0 = torch.Generator(device=dev).manual_seed(10)
    built.init(g0)
    nudged = 0
    for name, mod in built.unet.named_modules():
        if name.endswith(("out_conv", "proj_out")) or name == "out.2":
            mod.reset_parameters(g0)
            nudged += 1
    model_dir = os.path.join(tmp, "ldm")
    t0 = time.perf_counter()
    save_ldm(model_dir, built)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    ldm = load_ldm(model_dir, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    counts = {part: sum(p.numel() for p in getattr(ldm, part).parameters())
              for part in ("unet", "first_stage", "cond_stage")}
    print(f"ldm: cin256-v2 UNetCond {counts['unet']:,} params, vq-f4 first stage "
          f"{counts['first_stage']:,}, ClassEmbedder {counts['cond_stage']:,}; seeded init with "
          f"{nudged} zero-initialised convs redrawn; save_ldm {t_save:.1f} s, load_ldm "
          f"{t_load:.1f} s")
    assert counts == LDM_PARAMS, counts
    for name, p in built.state_dict().items():
        part, _, rest = name.partition(".")
        assert torch.equal(getattr(ldm, part).state_dict()[rest], p), name
    del built

    (gn_unet, attn_unet), (gn_dec, attn_dec) = ldm_op_shapes(ucfg, fcfg)
    per_call = {"group_norm": sum(gn_unet.values()), "attention": sum(attn_unet.values())}
    per_decode = {"group_norm": sum(gn_dec.values()), "attention": sum(attn_dec.values())}
    print(f"ldm: {per_call['group_norm']} GroupNorm and {per_call['attention']} attention calls "
          f"per UNet call ({dict(attn_unet)}); the decode: {per_decode['group_norm']} and "
          f"{per_decode['attention']} ({dict(attn_dec)})")
    assert per_call == {"group_norm": 61, "attention": 32}, per_call
    # the attention widths of the UNetCond pruned at 0.3 (magnitude, local)
    params = unflatten_params(flat_from_state_dict(ldm.unet.state_dict()))
    res = prune(ldm.unet.graph, params, make_importance("magnitude"), sparsity=0.3)
    del params
    (_, attn_pruned), _ = ldm_op_shapes(ucfg.with_channel_sizes(res.channel_sizes), fcfg)
    print(f"ldm: pruned at 0.3 (magnitude, local): attention shapes {dict(attn_pruned)}")

    # each kernel against its plain version at every LDM shape, f32
    rows_unet, rows_dec = 2 * LDM_B, LDM_B
    attn_checks = ([(s, rows_unet, "unet") for s in sorted(attn_unet)]
                   + [(s, rows_dec, "decode") for s in sorted(attn_dec)]
                   + [(s, rows_unet, "pruned unet") for s in sorted(attn_pruned)])
    for (nq, nkv, h, d), rows, where in attn_checks:
        q = torch.randn((rows, h, nq, d), generator=gen, device=dev)
        k, v = (torch.randn((rows, h, nkv, d), generator=gen, device=dev) for _ in range(2))
        got = flash_attention(q, k, v, d ** -0.5)
        err, ok = compare(got, reference_attention(q, k, v, d ** -0.5), "float32")
        o, lse = A.flash_attention_forward_lse(q, k, v, d ** -0.5)
        lse_err, lse_ok = compare_rel(lse, A.reference_attention_lse(q, k, v, d ** -0.5)[1],
                                      BWD_TOL["float32"])
        worst[("attention_ldm", "float32")] = max(worst[("attention_ldm", "float32")], err)
        worst[("attention_lse_ldm", "float32")] = max(worst[("attention_lse_ldm", "float32")],
                                                      lse_err)
        print(f"check ldm attention ({where}) rows={rows} heads={h} Nq={nq} Nkv={nkv} D={d} "
              f"float32: max_abs_err={err:.3e} tol={TOL['float32']}, lse {lse_err:.3e} (tol "
              f"{BWD_TOL['float32']} x max|want|) {'ok' if ok and lse_ok else 'FAIL'}")
        assert ok and lse_ok and torch.equal(o, got), (nq, nkv, d)
        del q, k, v, got, o, lse
    check_wide_edges(("float32",), gen, dev, worst, "attention_ldm")
    for (n, c, eps, silu), rows, where in ([(s, rows_unet, "unet") for s in sorted(gn_unet)]
                                           + [(s, rows_dec, "decode") for s in sorted(gn_dec)]):
        x = torch.randn((rows, n, c), generator=gen, device=dev) * 2 + 0.5
        scale = torch.rand((c,), generator=gen, device=dev) + 0.5
        bias = torch.randn((c,), generator=gen, device=dev) * 0.1
        kw = dict(groups=32, eps=eps, with_silu=silu)
        err, ok = compare(group_norm(x, scale, bias, **kw),
                          group_norm_reference(x, scale, bias, **kw), "float32")
        worst[("group_norm_ldm", "float32")] = max(worst[("group_norm_ldm", "float32")], err)
        print(f"check ldm group_norm ({where}) rows={rows} N={n} C={c} C/g={c // 32} "
              f"slab {n * c // 32 * 4 / 1024:.0f} KB eps={eps} silu={silu} float32: "
              f"max_abs_err={err:.3e} tol={TOL['float32']} {'ok' if ok else 'FAIL'}")
        assert ok, (n, c, eps, silu)
        del x
    torch.cuda.synchronize()

    # the whole CFG sampler, kernels on against off, from one x_T
    hw = ucfg.image_size
    x_T = torch.randn((LDM_CMP_B, hw, hw, 3), generator=gen, device=dev)
    labels = torch.tensor([1, 207, 360, 999][:LDM_CMP_B], device=dev)
    compare_out = {}
    for method, steps in (("ddim", LDM_STEPS), ("plms", LDM_MULTI_STEPS),
                          ("dpm", LDM_MULTI_STEPS)):
        calls = steps + (method == "plms")
        sample = ldm.make_cfg_sampler(ddim_steps=steps, guidance_scale=LDM_SCALE,
                                      latent_hw=hw, latent_ch=3, method=method)
        runs = {}
        for on in (True, False):
            ops.set_kernels_enabled(on)
            try:
                ops.reset_launch_counts()
                lat = sample(None, labels, LDM_CMP_B, x_T=x_T)
                img = ldm.decode_first_stage(lat)
                torch.cuda.synchronize()
                runs[on] = (lat, img, dict(ops.LAUNCHES))
            finally:
                ops.set_kernels_enabled(True)
        (lat_on, img_on, c_on), (lat_off, img_off, c_off) = runs[True], runs[False]
        want = {"group_norm": calls * 61 + per_decode["group_norm"],
                "attention": calls * 32 + per_decode["attention"]}
        rel_lat = float((lat_on - lat_off).norm() / lat_off.norm())
        rel_img = float((img_on - img_off).norm() / img_off.norm())
        compare_out[method] = {"steps": steps, "unet_calls": calls, "rel_latent": rel_lat,
                               "rel_image": rel_img, "launches": c_on}
        print(f"ldm sampler {method}-{steps} CFG scale {LDM_SCALE} B={LDM_CMP_B} + decode, "
              f"kernels on vs off from one x_T: latents rel err in norm {rel_lat:.3e}, images "
              f"{rel_img:.3e} (tol {LDM_REL_TOL}), |latent| max {float(lat_off.abs().max()):.2f}, "
              f"image mean {float(img_off.mean()):.3f}; launches on {c_on}, off {c_off}")
        assert bool(torch.isfinite(lat_on).all()) and bool(torch.isfinite(img_on).all())
        assert rel_lat <= LDM_REL_TOL and rel_img <= LDM_REL_TOL, (method, rel_lat, rel_img)
        assert {k: c_on[k] for k in want} == want and not any(c_off.values()), (c_on, c_off)
        assert c_on["attention_lse"] == c_on["group_norm_bwd"] == 0, c_on
        del runs, lat_on, lat_off, img_on, img_off

    # imgs/s of CFG DDIM-LDM_STEPS + the decode at the CLI's batch, kernels on and off
    sample = ldm.make_cfg_sampler(ddim_steps=LDM_STEPS, guidance_scale=LDM_SCALE,
                                  latent_hw=hw, latent_ch=3)
    warm = ldm.make_cfg_sampler(ddim_steps=2, guidance_scale=LDM_SCALE, latent_hw=hw,
                                latent_ch=3)
    tlabels = torch.arange(LDM_B, device=dev) % 1000

    def batch(on, fn=sample):
        ops.set_kernels_enabled(on)
        try:
            return cuda_ms(lambda: ldm.decode_first_stage(fn(gen, tlabels, LDM_B)), iters=1,
                           warmup=0)
        finally:
            ops.set_kernels_enabled(True)

    for on in (False, True):
        batch(on, warm)
    off1, on1 = batch(False), batch(True)
    ips = {"kernels_on": LDM_B * 1e3 / on1, "kernels_off": LDM_B * 1e3 / off1}
    batch_ms = {"on": [on1], "off": [off1]}
    print(f"time ldm CFG DDIM-{LDM_STEPS} + decode B={LDM_B} ({2 * LDM_B} UNet rows) float32: "
          f"kernels on {ips['kernels_on']:.3f} imgs/s ({on1:.0f} ms), "
          f"kernels off {ips['kernels_off']:.3f} imgs/s ({off1:.0f} ms) "
          f"(CUDA events, one batch each, off then on) {tag}")
    dec_lat = torch.randn((LDM_B, hw, hw, 3), generator=gen, device=dev)
    with torch.inference_mode():
        ctx = ldm.get_learned_conditioning(torch.cat([tlabels, torch.full_like(tlabels, 1000)]))
    x2 = torch.randn((2 * LDM_B, hw, hw, 3), generator=gen, device=dev)
    tb = torch.full((2 * LDM_B,), 500, device=dev)

    def unet_call():
        with torch.inference_mode():
            return ldm.apply_unet(x2, tb, ctx)

    def decode_call():
        return ldm.decode_first_stage(dec_lat)

    unet_ms, decode_ms = in_turns([unet_call, decode_call], iters=1, warmup=0)
    print(f"time ldm one CFG UNet call rows={2 * LDM_B} {unet_ms:.1f} ms, one decode B={LDM_B} "
          f"{decode_ms:.1f} ms (kernels on, CUDA events) {tag}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        unet_call()
        torch.cuda.synchronize()
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda e: -e.count)
    print("ldm one UNet call, kernels by launches: " + "; ".join(
        f"{e.key[:90]} x{e.count} {getattr(e, 'self_device_time_total', 0.0) / 1e3:.2f} ms"
        for e in top[:8]))
    profiles = {}
    for what, fn in (("UNet call", unet_call), ("decode", decode_call)):
        busy, span, launches, kcounts, _ = profile_kernels(fn)
        print_profile(f"ldm one {what} kernels on rows={2 * LDM_B if what == 'UNet call' else LDM_B}"
                      " float32", busy, span, launches, kcounts, (what, 1), tag)
        profiles[what] = {"busy_ms": busy, "span_ms": span, "launches": launches,
                          "idle_share": 1 - sum(busy.values()) / span}
    ops_unet = time_ldm_ops(gn_unet, attn_unet, rows_unet, gen, dev, tag, "UNet call",
                            others_fwd)
    ops_dec = time_ldm_ops(gn_dec, attn_dec, rows_dec, gen, dev, tag, "decode", others_fwd)

    # the main path: the ldm_sample CLI on the saved model; then the PLMS run
    # again with --multihost under torchrun's environment at world size 1,
    # its own NCCL init (phase 23's (c)), whose PNGs must equal the plain run's
    cli = {}
    for key, method, steps, multihost in (
            ("ddim", "ddim", LDM_STEPS, False), ("plms", "plms", LDM_MULTI_STEPS, False),
            ("dpm", "dpm", LDM_MULTI_STEPS, False),
            ("plms_multihost", "plms", LDM_MULTI_STEPS, True)):
        out = os.path.join(tmp, f"ldm_{key}")
        argv = ["--model_path", model_dir, "--output_dir", out, "--num_classes", "1", "--ipc",
                str(LDM_B), "--batch_size", str(LDM_B), "--ddim_steps", str(steps), "--method",
                method, "--device", "cuda"]
        ops.reset_launch_counts()
        if multihost:
            with torchrun_env():
                try:
                    stats, text, seconds = run_cli(ldm_sample.main, argv + ["--multihost"])
                    assert torch.distributed.get_backend() == "nccl", text
                finally:
                    if torch.distributed.is_initialized():
                        torch.distributed.destroy_process_group()
        else:
            stats, text, seconds = run_cli(ldm_sample.main, argv)
        launches = dict(ops.LAUNCHES)
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        calls = steps + (method == "plms")
        want = {"group_norm": calls * 61 + per_decode["group_norm"],
                "attention": calls * 32 + per_decode["attention"]}
        cli[key] = {"seconds": seconds, "pngs": len(pngs), "launches": launches,
                    "imgs_per_s": stats["imgs_per_s"], "multihost": multihost}
        if multihost:  # one process, all its rows: the one-process layout, the same PNGs
            assert "process_" not in " ".join(os.listdir(out)), os.listdir(out)
            plain = os.path.join(tmp, "ldm_plms")
            same = pngs == sorted(f for f in os.listdir(plain) if f.endswith(".png")) and all(
                filecmp.cmp(os.path.join(out, f), os.path.join(plain, f), shallow=False)
                for f in pngs)
            cli[key]["pngs_equal_plain"] = same
        print(f"ldm_sample CLI --method {method} --ddim_steps {steps}"
              f"{' --multihost (NCCL, world 1, torchrun env)' if multihost else ''}, 1 class x "
              f"{LDM_B}, B={LDM_B}: "
              f"{len(pngs)} PNGs, {seconds:.1f} s wall (load included), sampling "
              f"{stats['imgs_per_s']:.2f} imgs/s {tag}; launches {launches}"
              + (f"; PNGs byte-identical to the plain plms run's {same}" if multihost else ""))
        assert len(pngs) == LDM_B and stats["nonfinite"] == 0, stats
        assert {k: launches[k] for k in want} == want, (launches, want)
        if multihost:
            assert same and launches == cli["plms"]["launches"], (same, launches)
    print(f"ldm phase {time.perf_counter() - t_phase:.1f} s")
    return ldm, model_dir, {"card": gpu, "params": counts, "b": LDM_B,
            "imgs_per_s": ips, "batch_ms": batch_ms,
            "unet_call_ms": unet_ms, "decode_ms": decode_ms, "profiles": profiles,
            "compare": compare_out, "cli": cli, "ops_unet_call": ops_unet,
            "ops_decode": ops_dec, "per_call": per_call, "per_decode": per_decode,
            "attn_pruned": {str(k): v for k, v in attn_pruned.items()},
            "save_s": t_save, "load_s": t_load}


def ldm_prune_path(tmp, ldm, model_dir, gen, gpu, tag, worst, others_bwd):
    """Phase 17 (see the module docstring); ``others_bwd`` (label -> library
    of another attention backward) are timed in the same turns as the
    port's dq and dk/dv; returns the pruned model dir the CLI wrote and the
    phase's figures."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.cli import ldm_prune, ldm_sample
    from diff_pruning_tpu_torch.diffpruning.sweep import accumulate_ldm_grads
    from diff_pruning_tpu_torch.models.latent_diffusion import load_ldm
    from diff_pruning_tpu_torch.models.vae import first_stage_config
    from diff_pruning_tpu_torch.ops import attention as A
    from diff_pruning_tpu_torch.ops import group_norm as G
    from diff_pruning_tpu_torch.ops.attention import flash_attention
    from diff_pruning_tpu_torch.pruning.importance import make_importance
    from diff_pruning_tpu_torch.pruning.pruner import prune
    from diff_pruning_tpu_torch.pruning.surgery import unflatten_params
    from diff_pruning_tpu_torch.utils.checkpoint import flat_from_state_dict

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    rows = LDM_PRUNE_B
    ucfg = ldm.unet.cfg
    hw = ucfg.image_size
    # every backward shape of one sweep step (forward hooks, shapes only), of
    # the dense UNet and of the one the CLI writes (0.3, round_to 2)
    (gn_dense, attn_dense), _ = ldm_op_shapes(ucfg, first_stage_config("vq-f4"))
    res = prune(ldm.unet.graph, {}, make_importance("random"), sparsity=0.3, round_to=2)
    pcfg = ucfg.with_channel_sizes(res.channel_sizes)
    (gn_pruned, attn_pruned), _ = ldm_op_shapes(pcfg, first_stage_config("vq-f4"))
    per_step = {"group_norm": sum(gn_dense.values()), "attention": sum(attn_dense.values())}
    print(f"ldm prune: per sweep step {per_step['group_norm']} GroupNorm and "
          f"{per_step['attention']} attention calls forward and backward at {rows} rows; "
          f"attention shapes {dict(attn_dense)}, pruned {dict(attn_pruned)}")

    # (a) the wide f32 dq and dk/dv against their plain versions, through
    # head-split views of (B, N, D) projections as the layers pass them
    def views(n, d):
        return torch.randn((rows, n, d), generator=gen, device=dev).view(rows, n, 1, d) \
            .transpose(1, 2)

    for (nq, nkv, h, d), where in ([(s, "unet") for s in sorted(attn_dense)]
                                   + [(s, "pruned unet") for s in sorted(attn_pruned)]):
        q, do = views(nq, d), views(nq, d)
        k, v = views(nkv, d), views(nkv, d)
        scale = d ** -0.5
        _, lse = A.flash_attention_forward_lse(q, k, v, scale)
        o, plse = A.reference_attention_lse(q, k, v, scale)
        dq, dsum = A.flash_attention_backward_dq(q, k, v, o, do, plse, scale)
        pdq, pdsum = A.attention_backward_dq_reference(q, k, v, o, do, plse, scale)
        dk, dv = A.flash_attention_backward_dkv(q, k, v, do, plse, pdsum, scale)
        pdk, pdv = A.attention_backward_dkv_reference(q, k, v, do, plse, pdsum, scale)
        tol = BWD_TOL["float32"]
        floor = 1e-6 * max(float(g.abs().max()) for g in (pdq, pdk, pdv)) if nkv == 1 else 0.0
        errs = {}
        for what, a, w, fl in (("lse", lse, plse, 0.0), ("dsum", dsum, pdsum, 0.0),
                               ("dq", dq, pdq, floor), ("dk", dk, pdk, floor),
                               ("dv", dv, pdv, 0.0)):
            err = float((a - w).abs().max())
            ok = bool(torch.isfinite(a).all()) and err <= tol * float(w.abs().max()) + fl
            assert ok, f"ldm attention backward {what} at {(nq, nkv, d)}: {err:.3e}"
            errs[what] = err
        for key, names in (("attention_bwd_dq_ldm", ("dq", "dsum")),
                           ("attention_bwd_dkv_ldm", ("dk", "dv"))):
            worst[(key, "float32")] = max(worst[(key, "float32")], *(errs[n] for n in names))
        print(f"check ldm attention bwd ({where}) rows={rows} Nq={nq} Nkv={nkv} D={d} float32: "
              + " ".join(f"{k_}={e:.3e}" for k_, e in errs.items())
              + f" tol={tol} x max|want|" + (f" + {floor:.3e} (Nkv = 1)" if floor else "")
              + (f"; the kernels' max |dq| {float(dq.abs().max()):.3e}, max |dk| "
                 f"{float(dk.abs().max()):.3e} (0 in exact arithmetic)" if nkv == 1 else "")
              + " ok")
        del q, k, v, do, o, dq, dk, dv, pdq, pdk, pdv
    check_wide_bwd_edges_f32(gen, dev, worst)
    # (b) the GroupNorm backward at the sweep's shapes (slabs chunked past
    # 104 KB: 4096 x 192 and wider)
    for (n, c, eps, silu), where in ([(s, "unet") for s in sorted(gn_dense)]
                                     + [(s, "pruned unet") for s in sorted(gn_pruned)]):
        x = torch.randn((rows, n, c), generator=gen, device=dev) * 2 + 0.5
        dy = torch.randn((rows, n, c), generator=gen, device=dev)
        scale = torch.rand((c,), generator=gen, device=dev) + 0.5
        bias = torch.randn((c,), generator=gen, device=dev) * 0.1
        mean, rstd = G.group_norm_stats_reference(x, 32, eps=eps)
        kw = dict(groups=32, with_silu=silu)
        got = G.group_norm_backward(x, scale, bias, dy, mean, rstd, **kw)
        want = G.group_norm_backward_reference(x, scale, bias, dy, mean, rstd, **kw)
        errs = {}
        for what, a, w in zip(("dx", "dscale", "dbias"), got, want):
            errs[what], ok = compare_rel(a, w, BWD_TOL["float32"])
            assert ok, f"ldm group_norm backward {what} at {(n, c, silu)}: {errs[what]:.3e}"
        worst[("group_norm_bwd_ldm", "float32")] = max(worst[("group_norm_bwd_ldm", "float32")],
                                                       *errs.values())
        slab = 2 * n * c // 32 * 4 / 1024
        print(f"check ldm group_norm bwd ({where}) rows={rows} N={n} C={c} C/g={c // 32} "
              f"x+dy slab {slab:.0f} KB{' (chunked)' if slab > 104 else ''} silu={silu} "
              f"float32: " + " ".join(f"{k_}={e:.3e}" for k_, e in errs.items())
              + f" tol={BWD_TOL['float32']} x max|want| ok")
        del x, dy
    # an f32 backward at D = 384 launches the wide kernels, through autograd too
    q = torch.randn((2, 1, 64, 384), generator=gen, device=dev, requires_grad=True)
    before = dict(ops.LAUNCHES)
    flash_attention(q, q, q, 0.05).sum().backward()
    for op in ("attention", "attention_lse", "attention_bwd_dq", "attention_bwd_dkv"):
        assert ops.LAUNCHES[op] == before[op] + 1, (op, before, ops.LAUNCHES)
    print("check ldm attention D=384 f32 under autograd: forward with lse, dq and dk/dv "
          "launched once each ok")
    torch.cuda.synchronize()

    # (c) one full-width sweep step, kernels on against off on the same
    # latents, labels, noise and t, then on again (bit-identical)
    torch.backends.cudnn.deterministic = True
    sgen = torch.Generator(device=dev).manual_seed(11)
    lat = torch.randn((rows, hw, hw, 3), generator=sgen, device=dev)
    labels = torch.randint(0, ldm.n_classes - 1, (rows,), generator=sgen, device=dev)
    noise = torch.randn((rows, hw, hw, 3), generator=sgen, device=dev)

    def step(on):
        ops.set_kernels_enabled(on)
        try:
            ops.reset_launch_counts()
            res = accumulate_ldm_grads(ldm, lambda t: (lat, labels, noise), max_steps=1)
            torch.cuda.synchronize()
            return (res.losses, dict(ops.LAUNCHES),
                    {n: g.clone() for n, g in res.grads.items()})
        finally:
            ops.set_kernels_enabled(True)
            ldm.unet.zero_grad(set_to_none=True)

    loss_on, c_on, g_on = step(True)
    loss_off, c_off, g_off = step(False)
    loss_again, _, g_again = step(True)
    want_counts = {"group_norm": per_step["group_norm"], "group_norm_bwd": per_step["group_norm"],
                   "attention": per_step["attention"], "attention_lse": per_step["attention"],
                   "attention_bwd_dq": per_step["attention"],
                   "attention_bwd_dkv": per_step["attention"]}
    assert c_on == want_counts and not any(c_off.values()), (c_on, c_off)
    np.testing.assert_allclose(loss_on, loss_off, rtol=SWEEP_LOSS_RTOL)
    floor = 1e-6 * max(float(g.abs().max()) for g in g_off.values())
    worst_grad, worst_name = 0.0, ""
    for name, g in g_off.items():
        err, gmax = float((g_on[name] - g).abs().max()), float(g.abs().max())
        assert bool(torch.isfinite(g_on[name]).all()) and \
            err <= SWEEP_GRAD_TOL * gmax + floor, f"ldm sweep grad {name}: {err:.3e} ({gmax:.3e})"
        if err / max(gmax, floor) > worst_grad:
            worst_grad, worst_name = err / max(gmax, floor), f"{name} (max |grad| {gmax:.3e})"
    identical = all(torch.equal(g_again[n], g) for n, g in g_on.items())
    assert identical and np.array_equal(loss_again, loss_on), "ldm sweep step not reproducible"
    params = unflatten_params(flat_from_state_dict(ldm.unet.state_dict()))
    s_on = unflatten_params(flat_from_state_dict(g_on))
    s_off = unflatten_params(flat_from_state_dict(g_off))
    del g_on, g_off, g_again
    imp, graph, worst_score = make_importance("diff-pruning"), ldm.unet.graph, 0.0
    for var in graph.prunable_vars():
        a, b = imp(graph, params, var, grads=s_on), imp(graph, params, var, grads=s_off)
        err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
        assert err <= SWEEP_SCORE_RTOL, f"ldm diff-pruning scores of {var.name}: {err:.3e}"
        worst_score = max(worst_score, err)
    del params, s_on, s_off
    print(f"ldm sweep step cin256-v2 B={rows} t=0 f32, kernels on vs off: loss {loss_on[0]:.6f} "
          f"against {loss_off[0]:.6f} (tol {SWEEP_LOSS_RTOL} rel); worst grad err / param max "
          f"{worst_grad:.3e} at {worst_name} (tol {SWEEP_GRAD_TOL}); worst diff-pruning score "
          f"err / var max {worst_score:.3e} (tol {SWEEP_SCORE_RTOL}); repeat bit-identical: "
          f"{identical}; launches on {c_on}")
    torch.backends.cudnn.deterministic = False

    # (d) the main path: the ldm_prune CLI on the saved model
    out = os.path.join(tmp, "ldm_pruned")
    ops.reset_launch_counts()
    stats, _, cli_seconds = run_cli(ldm_prune.main, [
        "--model_path", model_dir, "--save_path", out, "--pruner", "diff-pruning",
        "--max_steps", str(LDM_PRUNE_STEPS), "--batch_size", str(rows), "--ddim_steps",
        str(LDM_PRUNE_DDIM), "--classes", *LDM_PRUNE_CLASSES, "--device", "cuda"])
    cli_counts = dict(ops.LAUNCHES)
    steps, losses = stats["steps_run"], stats["losses"]
    broke = losses[-1] / max(losses) < 0.1  # the CLI's default thr
    grad_steps = steps - broke
    calls = (steps + len(LDM_PRUNE_CLASSES)) * LDM_PRUNE_DDIM
    want_cli = {"group_norm": (calls + steps) * 61 + len(LDM_PRUNE_CLASSES) * 24,
                "group_norm_bwd": grad_steps * 61,
                "attention": (calls + steps) * 32 + len(LDM_PRUNE_CLASSES),
                "attention_lse": steps * 32, "attention_bwd_dq": grad_steps * 32,
                "attention_bwd_dkv": grad_steps * 32}
    print(f"main path ldm_prune CLI: diff-pruning, {steps} sweep steps (losses {losses}) in "
          f"{stats['sweep_seconds']:.2f} s, {stats['params_before']:,} -> {stats['params']:,} "
          f"params, whole CLI {cli_seconds:.2f} s (host clock, B={rows}, CFG "
          f"DDIM-{LDM_PRUNE_DDIM}, f32) {tag}; launches {cli_counts}")
    assert steps == LDM_PRUNE_STEPS and cli_counts == want_cli, (steps, cli_counts, want_cli)
    assert stats["params"] == LDM_PRUNED_PARAMS_AT_0_3, stats["params"]
    pruned = load_ldm(out, device=dev)
    n_reloaded = sum(p.numel() for p in pruned.unet.parameters())
    assert n_reloaded == LDM_PRUNED_PARAMS_AT_0_3 and pruned.first_stage is not None
    assert os.path.isfile(os.path.join(out, "samples.png"))
    del pruned
    samples, _, sample_seconds = run_cli(ldm_sample.main, [
        "--model_path", out, "--output_dir", os.path.join(tmp, "ldm_pruned_s"),
        "--num_classes", "1", "--ipc", str(rows), "--batch_size", str(rows), "--ddim_steps",
        str(LDM_MULTI_STEPS), "--device", "cuda"])
    print(f"main path check: the pruned LDM reloads at {n_reloaded:,} UNet params (pinned "
          f"{LDM_PRUNED_PARAMS_AT_0_3:,}); ldm_sample drew {samples['images']} images, "
          f"{samples['nonfinite']} non-finite values, in {sample_seconds:.1f} s")
    assert samples["images"] == rows and samples["nonfinite"] == 0

    cli_ddim = ldm_prune.parse_args(["--save_path", tmp]).ddim_steps  # the CLI's default
    # (e) timings: the sweep step at the CLI's default DDIM-20 split into its
    # CFG sampling (cli_ddim CFG UNet calls of 2 x rows rows; the DDIM
    # updates are a few elementwise ops) and its forward + backward, kernels
    # on and off; each op against plain and the library call at the step's
    # shapes
    uparams = [p for p in ldm.unet.parameters()]
    tb = torch.zeros((rows,), dtype=torch.int64, device=dev)
    x2, tb2 = torch.cat([lat, lat]), torch.full((2 * rows,), 500, device=dev)
    with torch.inference_mode():
        ctx2 = ldm.get_learned_conditioning(torch.cat([torch.full_like(labels, 1000), labels]))

    def timed(on, fn):
        ops.set_kernels_enabled(on)
        try:
            return cuda_ms(fn, iters=1, warmup=0)
        finally:
            ops.set_kernels_enabled(True)

    def cfg_call():
        with torch.inference_mode():
            ldm.apply_unet(x2, tb2, ctx2)

    def fwd_bwd():
        ldm.get_loss_at_t(lat, labels, tb, noise).backward(inputs=uparams)

    # one timed call each way (the CLI above ran the step's shapes)
    call = [timed(on, cfg_call) for on in (False, True)]
    grad = [timed(on, fwd_bwd) for on in (False, True)]
    ldm.unet.zero_grad(set_to_none=True)
    busy, span, launches, kcounts, _ = profile_kernels(cfg_call)
    print_profile(f"ldm prune one CFG UNet call kernels on rows={2 * rows} float32", busy, span,
                  launches, kcounts, ("call", 1), tag)
    # the convolution that takes most of such a call: cuDNN's 3x3, 192 -> 192
    # channels at 64 x 64 (NHWC f32), by batch rows
    w = torch.randn((192, 192, 3, 3), generator=gen, device=dev)
    conv_ms = {}
    for n in (2 * rows, 16, 32):
        xc = torch.randn((n, 192, 64, 64), generator=gen, device=dev).contiguous(
            memory_format=torch.channels_last)
        with torch.inference_mode():
            conv_ms[n] = cuda_ms(lambda: F.conv2d(xc, w, None, 1, 1), iters=3, warmup=1)
        del xc
    print("time ldm conv 3x3 192->192 at 64x64 NHWC float32: " + ", ".join(
        f"{n} rows {ms:.2f} ms ({ms / n:.3f} a row)" for n, ms in conv_ms.items()) + f" {tag}")
    step_ms = {"cfg_call_on": call[1], "cfg_call_off": call[0],
               "fwd_bwd_on": grad[1], "fwd_bwd_off": grad[0]}
    for on in ("on", "off"):
        step_ms[f"sampling_{on}"] = cli_ddim * step_ms[f"cfg_call_{on}"]
        step_ms[on] = step_ms[f"sampling_{on}"] + step_ms[f"fwd_bwd_{on}"]
    print(f"time ldm sweep step cin256-v2 B={rows} f32: kernels on {step_ms['on']:.1f} ms "
          f"(CFG DDIM-{cli_ddim} sampling {step_ms['sampling_on']:.1f} = {cli_ddim} x "
          f"{step_ms['cfg_call_on']:.1f} ms CFG UNet calls at {2 * rows} rows, forward + "
          f"backward {step_ms['fwd_bwd_on']:.1f}), kernels off {step_ms['off']:.1f} ms "
          f"(sampling {step_ms['sampling_off']:.1f}, forward + backward "
          f"{step_ms['fwd_bwd_off']:.1f}) (CUDA events, one each, off then on); the CLI's "
          f"sweep at DDIM-{LDM_PRUNE_DDIM} took {stats['sweep_seconds'] / steps * 1e3:.1f} ms a "
          f"step (host clock, kernels on) {tag}")
    tot = collections.defaultdict(float)
    for (nq, nkv, h, d), ncalls in sorted(attn_dense.items()):
        q, do = views(nq, d), views(nq, d)
        k, v = views(nkv, d), views(nkv, d)
        scale = d ** -0.5
        o, lse = A.reference_attention_lse(q, k, v, scale)
        _, dsum = A.attention_backward_dq_reference(q, k, v, o, do, lse, scale)
        ql, kl, vl = (z.detach().clone().requires_grad_() for z in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        backend = sdpa_backend(
            lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True))
        fns = [lambda: A.attention_backward_dq_reference(q, k, v, o, do, lse, scale),
               lambda: A.flash_attention_backward_dq(q, k, v, o, do, lse, scale),
               lambda: A.attention_backward_dkv_reference(q, k, v, do, lse, dsum, scale),
               lambda: A.flash_attention_backward_dkv(q, k, v, do, lse, dsum, scale),
               lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)]
        for lib in others_bwd.values():  # the other backwards, in the same turns
            fns += [with_lib("bwd", lib, lambda: A.flash_attention_backward_dq(
                        q, k, v, o, do, lse, scale)),
                    with_lib("bwd", lib, lambda: A.flash_attention_backward_dkv(
                        q, k, v, do, lse, dsum, scale))]
        ms = in_turns(fns, iters=2)
        other_ms = {label: ms[5 + 2 * i: 7 + 2 * i] for i, label in enumerate(others_bwd)}
        (bq_bytes, fq), (bkv_bytes, fkv) = ldm_bwd_work(rows, nq, nkv, d)
        bq, byq = bound(bq_bytes, fq, "float32")
        bkv, bykv = bound(bkv_bytes, fkv, "float32")
        l2 = bwd_l2_bytes(nq, nkv, d, 32, 32, es=4)
        l2_old = bwd_l2_bytes(nq, nkv, d, 16, 8, es=4)
        for key, val in (("dq_plain", ms[0]), ("dq_kernel", ms[1]), ("dkv_plain", ms[2]),
                         ("dkv_kernel", ms[3]), ("attn_library", ms[4]), ("dq_flops", fq),
                         ("dkv_flops", fkv),
                         *((f"{part}_kernel_{label}", t) for label, pair in other_ms.items()
                           for part, t in zip(("dq", "dkv"), pair))):
            tot[key] += val * ncalls
        add_bound(tot, "dq_", bq * ncalls, byq)
        add_bound(tot, "dkv_", bkv * ncalls, bykv)
        print(f"time ldm attention bwd {(nq, nkv, d)} x{ncalls}/step rows={rows} float32: dq "
              f"kernel {ms[1]:.4f} ms, {fq / ms[1] / 1e9:.2f} TFLOP/s (plain {ms[0]:.4f}, bound "
              f"{bq:.4f} {byq}), dk/dv kernel {ms[3]:.4f} ms, {fkv / ms[3] / 1e9:.2f} TFLOP/s "
              f"(plain {ms[2]:.4f}, bound {bkv:.4f} {bykv}), library (SDPA f32 backward, "
              f"dq+dk+dv, {backend}) {ms[4]:.4f} ms"
              + "".join(f"; {label} dq {a:.4f} ms, dk/dv {b:.4f} ms"
                        for label, (a, b) in other_ms.items())
              + f"; L2 bytes a row: dq {l2[0]:,.0f} a q row, dk/dv {l2[1]:,.0f} a kv row "
              f"(16-q-row and 8-kv-row tiles {l2_old[0]:,.0f}, {l2_old[1]:,.0f}); dk/dv in "
              f"{f32_wide_bwd_split(rows, 1, nq, nkv, d)} q parts {tag}")
        del fns, q, k, v, do, o, ql, kl, vl, ol
    for (n, c, eps, silu), ncalls in sorted(gn_dense.items()):
        x = torch.randn((rows, n, c), generator=gen, device=dev)
        dy = torch.randn((rows, n, c), generator=gen, device=dev)
        s_, b_ = torch.rand(c, generator=gen, device=dev) + 0.5, torch.zeros(c, device=dev)
        mean, rstd = G.group_norm_stats_reference(x, 32, eps=eps)
        kw = dict(groups=32, with_silu=silu)
        fns = [lambda: G.group_norm_backward_reference(x, s_, b_, dy, mean, rstd, **kw),
               lambda: G.group_norm_backward(x, s_, b_, dy, mean, rstd, **kw)]
        if not silu:  # autograd of F.group_norm: native_group_norm_backward alone
            xl = x.transpose(1, 2).contiguous().requires_grad_()
            sl, bl = (z.clone().requires_grad_() for z in (s_, b_))
            yl = F.group_norm(xl, 32, sl, bl, eps=eps)
            dyl = dy.transpose(1, 2).contiguous()
            fns.append(lambda: torch.autograd.grad(yl, (xl, sl, bl), dyl, retain_graph=True))
        ms = in_turns(fns, iters=2)
        bms, by = bound(*gn_bwd_work(n, c, silu, "float32", rows=rows), "float32")
        tot["gn_kernel"] += ms[1] * ncalls
        tot["gn_plain"] += ms[0] * ncalls
        add_bound(tot, "gn_", bms * ncalls, by)
        if len(ms) == 3:
            tot["gn_library"] += ms[2] * ncalls
            tot["gn_kernel_where_library"] += ms[1] * ncalls
        print(f"time ldm group_norm bwd {(n, c, silu)} x{ncalls}/step rows={rows} float32: "
              f"kernel {ms[1]:.4f} ms, plain {ms[0]:.4f} ms, library "
              f"{f'{ms[2]:.4f} ms' if len(ms) == 3 else '-'}, bound {bms:.4f} ms ({by}) {tag}")
        del fns, x, dy
    tot["dq_tflops"] = tot["dq_flops"] / tot["dq_kernel"] / 1e9
    tot["dkv_tflops"] = tot["dkv_flops"] / tot["dkv_kernel"] / 1e9
    for prefix in ("dq_", "dkv_", "gn_"):
        tot[prefix + "bound_by"] = bound_by(tot, prefix)
    ops_ms = dict(tot)
    print(f"time ldm backward per sweep step rows={rows} float32: " + ", ".join(
        f"{k_} {v_:.4f}" if isinstance(v_, float) else f"{k_} {v_}"
        for k_, v_ in sorted(ops_ms.items())) + f" {tag}")
    print(f"ldm prune phase {time.perf_counter() - t_phase:.1f} s")
    return out, {"card": gpu, "b": rows, "sweep_steps": steps, "losses": losses,
            "cli_seconds": cli_seconds, "sweep_seconds": stats["sweep_seconds"],
            "cli_launches": cli_counts, "params": [stats["params_before"], stats["params"]],
            "sweep_step_ms": step_ms, "compare": {"worst_grad": worst_grad,
                                                  "worst_score": worst_score,
                                                  "loss_on": loss_on[0], "loss_off": loss_off[0]},
            "ops_per_step": ops_ms, "sample_seconds": sample_seconds,
            "cfg_call_profile": {"busy_ms": busy, "span_ms": span, "launches": launches},
            "conv_192_ms": {str(n): ms for n, ms in conv_ms.items()},
            "attn_pruned": {str(k_): v_ for k_, v_ in attn_pruned.items()}}


def record_fwd_dtypes():
    """Counts the (op, dtype) of every GroupNorm and attention forward launch
    (the kernels' launchers, under autograd too); returns (counter, restore)."""
    from diff_pruning_tpu_torch.ops import attention as A
    from diff_pruning_tpu_torch.ops import group_norm as G

    seen = collections.Counter()
    attn, gn = A._launch, G._launch

    def attn_wrapped(q, *args, **kwargs):
        seen[("attention", str(q.dtype))] += 1
        return attn(q, *args, **kwargs)

    def gn_wrapped(x, *args, **kwargs):
        seen[("group_norm", str(x.dtype))] += 1
        return gn(x, *args, **kwargs)

    A._launch, G._launch = attn_wrapped, gn_wrapped

    def restore():
        A._launch, G._launch = attn, gn

    return seen, restore


def redraw_zero_init(model, g) -> int:
    """Redraws, from ``g``, every module of ``model`` whose own parameters are
    all zero (the convolutions that the reference zero-initialises: a fresh
    UNet's eps is exactly 0); returns how many."""
    nudged = 0
    for mod in model.modules():
        own = list(mod.parameters(recurse=False))
        if hasattr(mod, "reset_parameters") and own and not any(bool(p.any()) for p in own):
            mod.reset_parameters(g)
            nudged += 1
    return nudged


def switched(on, fn):
    """``fn()`` with every kernel switch set to ``on``, then back on."""
    from diff_pruning_tpu_torch import ops

    ops.set_kernels_enabled(on)
    try:
        return fn()
    finally:
        ops.set_kernels_enabled(True)


def turns(fn):
    """``fn(on)`` timed kernels off, on, on, off, one call each after a
    warm-up of each: (off ms, on ms), each the mean of its two calls. Meant
    for calls of 0.01 s of device time and more, far above the events'
    resolution and the host's share."""
    for on in (False, True):
        fn(on)
    off1, on1, on2, off2 = (cuda_ms(lambda: fn(on), iters=1, warmup=0)
                            for on in (False, True, True, False))
    return (off1 + off2) / 2, (on1 + on2) / 2


def seeded_uncond_dir(path, ucfg, fcfg, seed, dev):
    """A model dir in the JAX package's layout (``unet/``, ``first_stage/``)
    of a seeded init on the card, every convolution that the reference
    zero-initialises (ResBlocks' out_conv, the final conv) drawn like the
    others: a fresh UNet's eps is exactly 0. Returns (UNet params, first-stage
    params, the convs redrawn, save seconds)."""
    import torch

    from diff_pruning_tpu_torch.models.unet_cond import UNetCond
    from diff_pruning_tpu_torch.models.vae import make_first_stage
    from diff_pruning_tpu_torch.utils.checkpoint import save_model

    g = torch.Generator(device=dev).manual_seed(seed)
    unet = UNetCond(ucfg, device=dev).init(g)
    fs = make_first_stage(fcfg, device=dev).init(g)
    nudged = redraw_zero_init(unet, g)
    t0 = time.perf_counter()
    save_model(path, ucfg, unet, subfolder="unet")
    save_model(path, fcfg, fs, subfolder="first_stage")
    counts = (sum(p.numel() for p in unet.parameters()), sum(p.numel() for p in fs.parameters()))
    return counts[0], counts[1], nudged, time.perf_counter() - t0


def uncond_ldm_path(tmp, gen, gpu, tag, worst, others_fwd, cifar):
    """Phase 19 (see the module docstring); returns the phase's figures.
    ``cifar``: the dense CIFAR UNet's checkpoint dir (``ckpt``, phase 5's),
    its schedule on the card (``sched``) and its GroupNorm and attention calls
    a forward (``per_call``)."""
    import numpy as np
    import torch
    from PIL import Image

    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.cli import ddpm_sample, sample_diffusion
    from diff_pruning_tpu_torch.models.latent_diffusion import ldm_schedule, make_concat_sampler
    from diff_pruning_tpu_torch.models.unet2d import UNet2D
    from diff_pruning_tpu_torch.models.unet_cond import (UNetCond, celebahq_ldm_vq4_config,
                                                         lsun_churches_ldm_kl8_config)
    from diff_pruning_tpu_torch.models.vae import first_stage_config, make_first_stage
    from diff_pruning_tpu_torch.sampling.ddim_sampler import SamplerConfig, make_sampler
    from diff_pruning_tpu_torch.utils.checkpoint import load_model

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    out = {"card": gpu, "laps_s": {}}

    def lap(what):
        """Seconds since the phase began, at the end of ``what``."""
        out["laps_s"][what] = time.perf_counter() - t_phase
    # (a) the two model dirs, full width and depth, f32
    models = {"celebahq": (celebahq_ldm_vq4_config(), first_stage_config("vq-f4"), 20),
              "churches": (lsun_churches_ldm_kl8_config(), first_stage_config("kl-f8"), 21)}
    dirs, shapes = {}, {}
    for name, (ucfg, fcfg, seed) in models.items():
        dirs[name] = os.path.join(tmp, f"uncond_{name}")
        n_unet, n_fs, nudged, t_save = seeded_uncond_dir(dirs[name], ucfg, fcfg, seed, dev)
        torch.cuda.empty_cache()
        shapes[name] = ldm_op_shapes(ucfg, fcfg)
        (gn_u, attn_u), (gn_d, attn_d) = shapes[name]
        print(f"uncond ldm {name}: UNetCond {n_unet:,} params, first stage {n_fs:,}; "
              f"{nudged} zero-initialised convs redrawn; saved in {t_save:.1f} s; a UNet "
              f"call {sum(gn_u.values())} GroupNorm and {sum(attn_u.values())} attention calls "
              f"{dict(attn_u)}, a decode {sum(gn_d.values())} and {sum(attn_d.values())} "
              f"{dict(attn_d)}")
        assert (n_unet, n_fs) == UNCOND_PARAMS[name], (name, n_unet, n_fs)
        assert nudged > 0
        out[name] = {"params": {"unet": n_unet, "first_stage": n_fs}, "save_s": t_save,
                     "per_call": {"group_norm": sum(gn_u.values()),
                                  "attention": sum(attn_u.values())},
                     "per_decode": {"group_norm": sum(gn_d.values()),
                                    "attention": sum(attn_d.values())},
                     "attention_shapes": {str(k): v for k, v in attn_u.items()},
                     "group_norm_odd_c_per_group": sorted(
                         {c // 32 for (_, c, _, _) in gn_u if (c // 32) % 2})}

    # (c) every GroupNorm and attention shape of both models against plain,
    # f32, at the CLI runs' rows; attention through (B, N, heads * D) views
    # viewed as (B, heads, N, D), as SelfAttention2D passes them
    for name, rows in (("celebahq", UNCOND_B), ("churches", CHURCH_B)):
        for where, (gn, attn) in zip(("unet", "decode"), shapes[name]):
            check_fwd_shapes(gn, attn, rows, gen, dev, worst, "_uncond",
                             f"uncond {name} ({where})")
    lap("model dirs and kernel checks")

    # the CelebA-HQ model, loaded as the CLI loads it
    ucfg, fcfg, _ = models["celebahq"]
    (gn_u, attn_u), (gn_d, attn_d) = shapes["celebahq"]
    per_call = (sum(gn_u.values()), sum(attn_u.values()))
    per_decode = (sum(gn_d.values()), sum(attn_d.values()))
    _, ustate = load_model(dirs["celebahq"], "unet", config_cls=type(ucfg))
    unet = UNetCond(ucfg, device=dev)
    unet.load_state_dict(ustate)
    unet.eval()
    _, fstate = load_model(dirs["celebahq"], "first_stage", config_cls=type(fcfg))
    fs = make_first_stage(fcfg, device=dev)
    fs.load_state_dict(fstate)
    fs.eval()
    del ustate, fstate
    sched = ldm_schedule(device=dev)
    hw = ucfg.image_size

    def decode(lat):
        with torch.inference_mode():
            return ((fs.decode(lat, force_not_quantize=False) + 1.0) / 2.0).clamp(0.0, 1.0)

    # (d) one DDIM-10 eta-1 trajectory, kernels on against off, from the same
    # x_T and per-step noise; then the decode of those latents
    sampler = make_concat_sampler(unet, sched, ddim_steps=UNCOND_STEPS, eta=UNCOND_ETA)
    empty = torch.zeros((UNCOND_CMP_B, hw, hw, 0), device=dev)
    x_T = torch.randn((UNCOND_CMP_B, hw, hw, 3), generator=gen, device=dev)
    noise = [torch.randn_like(x_T) for _ in range(UNCOND_STEPS)]
    runs = {}
    for on in (True, False):
        ops.reset_launch_counts()
        lat = switched(on, lambda: sampler(None, empty, x_T=x_T, noise=noise))
        torch.cuda.synchronize()
        runs[on] = (lat, dict(ops.LAUNCHES))
    (lat_on, c_on), (lat_off, c_off) = runs[True], runs[False]
    lat_err, lat_ok = compare_rel(lat_on, lat_off, LDM_REL_TOL)
    img_on, img_off = (switched(on, lambda: decode(lat_off)) for on in (True, False))
    img_err, img_ok = compare_rel(img_on, img_off, LDM_REL_TOL)
    e2e = float((decode(lat_on) - img_off).abs().max())
    print(f"uncond celebahq DDIM-{UNCOND_STEPS} eta {UNCOND_ETA} B={UNCOND_CMP_B}, kernels on "
          f"vs off from one x_T and per-step noise: latents max abs err {lat_err:.3e} "
          f"(tol {LDM_REL_TOL} x max {float(lat_off.abs().max()):.3f}), the vq-f4 decode of "
          f"the same latents {img_err:.3e} (tol {LDM_REL_TOL} x max); each side's own "
          f"latents decoded on and off: {e2e:.3e}; launches on {c_on}, off {c_off}")
    assert lat_ok and img_ok, (lat_err, img_err)
    assert c_on["group_norm"] == UNCOND_STEPS * per_call[0], c_on
    assert c_on["attention"] == UNCOND_STEPS * per_call[1] and not any(c_off.values()), c_on
    out["on_off"] = {"latent_max_abs_err": lat_err, "image_max_abs_err": img_err,
                     "image_end_to_end_max_abs_err": e2e, "launches": c_on}
    del runs, lat_on, lat_off, img_on, img_off

    # (g) timings: a UNet call at 16 rows and the decode at 16, kernels off
    # and on in turns; a UNet call at the CLI's 50 rows, kernels on, once;
    # peak memory of a decode at 50; per-op ms
    def unet_call(rows):
        xr = torch.randn((rows, hw, hw, 3), generator=gen, device=dev)
        tb = torch.full((rows,), 501, device=dev)

        def call(on):
            with torch.inference_mode():
                return switched(on, lambda: unet(xr, tb))

        return call

    timing = {}
    call16 = unet_call(UNCOND_B)
    off, on = turns(call16)
    timing[f"unet_call_ms_{UNCOND_B}"] = {"kernels_on": on, "kernels_off": off}
    print(f"time uncond celebahq one UNet call rows={UNCOND_B} float32: kernels on {on:.2f} "
          f"ms, off {off:.2f} ms (CUDA events, in turns off-on-on-off) {tag}")
    busy, span, launches, kcounts, _ = profile_kernels(lambda: call16(True))
    print_profile(f"uncond celebahq one UNet call kernels on rows={UNCOND_B} float32", busy,
                  span, launches, kcounts, ("UNet call", 1), tag)
    out["profile_unet_call"] = {"busy_ms": busy, "span_ms": span, "launches": launches,
                                "idle_share": 1 - sum(busy.values()) / span}
    # at the CLI's default rows, where cuDNN's choice may change (ROADMAP
    # queue 2, F): one call after a warm-up, kernels on
    call50 = unet_call(UNCOND_CLI_B)
    on = cuda_ms(lambda: call50(True), iters=1, warmup=1)
    timing[f"unet_call_ms_{UNCOND_CLI_B}"] = {"kernels_on": on}
    print(f"time uncond celebahq one UNet call rows={UNCOND_CLI_B} float32: kernels on "
          f"{on:.2f} ms ({on / UNCOND_CLI_B:.3f} ms a row; CUDA events, one call after a "
          f"warm-up) {tag}")
    dec_lat = torch.randn((UNCOND_B, hw, hw, 3), generator=gen, device=dev)
    off, on = turns(lambda on: switched(on, lambda: decode(dec_lat)))
    timing["decode_ms_16"] = {"kernels_on": on, "kernels_off": off}
    print(f"time uncond vq-f4 decode (quantized) B={UNCOND_B} float32: kernels on {on:.2f} ms, "
          f"off {off:.2f} ms (CUDA events, in turns off-on-on-off) {tag}")
    big = torch.randn((UNCOND_CLI_B, hw, hw, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    decode(big)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    timing["decode_peak_gb_50"] = peak
    print(f"uncond vq-f4 decode B={UNCOND_CLI_B}: peak memory {peak:.2f} GB above the "
          f"{base / 1e9:.2f} GB held before it (the VQ lookup chunked) {tag}")
    del big
    # the UNet call and the decode at these rows are warm from the turns
    # above: one batch each, kernels off then on
    sample20 = make_concat_sampler(unet, sched, ddim_steps=UNCOND_STEPS, eta=UNCOND_ETA)
    empty16 = torch.zeros((UNCOND_B, hw, hw, 0), device=dev)
    off, on = (cuda_ms(lambda: switched(on_, lambda: decode(sample20(gen, empty16))),
                       iters=1, warmup=0) for on_ in (False, True))
    timing["imgs_per_s"] = {"kernels_on": UNCOND_B * 1e3 / on,
                            "kernels_off": UNCOND_B * 1e3 / off}
    timing["batch_ms"] = {"on": on, "off": off}
    print(f"time uncond celebahq DDIM-{UNCOND_STEPS} + decode B={UNCOND_B} float32: kernels on "
          f"{timing['imgs_per_s']['kernels_on']:.3f} imgs/s ({on:.0f} ms), off "
          f"{timing['imgs_per_s']['kernels_off']:.3f} ({off:.0f} ms) (CUDA events, one batch "
          f"each, off then on) {tag}")
    out["timing"] = timing
    # per op at a UNet call's shapes (the vq-f4 decode's are phase 16's, at the
    # same 16 rows)
    out["ops_unet_call"] = time_ldm_ops(gn_u, attn_u, UNCOND_B, gen, dev, tag,
                                        "uncond UNet call", others_fwd)
    lap("checks, on against off, timings")
    del unet, fs, sampler, sample20
    torch.cuda.empty_cache()

    # (b) the main path: sample_diffusion on the CelebA-HQ dir
    logdir = os.path.join(tmp, "uncond_celebahq_samples")
    ops.reset_launch_counts()
    stats, _, seconds = run_cli(sample_diffusion.main, [
        "--model_path", dirs["celebahq"], "--logdir", logdir, "--n_samples", str(UNCOND_B),
        "--batch_size", str(UNCOND_B), "--custom_steps", str(UNCOND_STEPS), "--eta",
        str(UNCOND_ETA), "--device", "cuda"])
    launches = dict(ops.LAUNCHES)
    pngs = sorted(os.listdir(os.path.join(logdir, "img")))
    want = {"group_norm": UNCOND_STEPS * per_call[0] + per_decode[0],
            "attention": UNCOND_STEPS * per_call[1] + per_decode[1]}
    size = Image.open(os.path.join(logdir, "img", pngs[-1])).size
    print(f"sample_diffusion CLI celebahq DDIM-{UNCOND_STEPS} eta {UNCOND_ETA}, {UNCOND_B} "
          f"images, B={UNCOND_B}: {len(pngs)} PNGs of {size}, {seconds:.1f} s wall (load "
          f"included), sampling {stats['imgs_per_s']:.3f} imgs/s {tag}; launches {launches}")
    res = hw * 2 ** (len(fcfg.block_out_channels) - 1)  # 256 for vq-f4's 64 x 64 latents
    assert pngs == [f"{i:06d}.png" for i in range(UNCOND_B)] and size == (res, res), pngs
    assert stats["nonfinite"] == 0 and stats["images"] == UNCOND_B, stats
    assert all(ops.kernels_enabled(op) for op in ("group_norm", "attention"))
    assert {k: launches[k] for k in want} == want, (launches, want)
    assert launches["attention_lse"] == launches["group_norm_bwd"] == 0, launches
    out["cli"] = {"seconds": seconds, "imgs_per_s": stats["imgs_per_s"], "pngs": len(pngs),
                  "launches": launches}
    lap("sample_diffusion celebahq")

    # (e) the churches dir: the KL decode, then the full 1000-step DDPM chain
    (gn_cu, attn_cu), (gn_cd, attn_cd) = shapes["churches"]
    for extra, b, steps in (([], CHURCH_B, CHURCH_STEPS), (["--vanilla_sample"], 1, 1000)):
        logdir = os.path.join(tmp, f"uncond_churches_{len(extra)}")
        ops.reset_launch_counts()
        stats, _, seconds = run_cli(sample_diffusion.main, [
            "--model_path", dirs["churches"], "--logdir", logdir, "--n_samples", str(b),
            "--batch_size", str(b), "--custom_steps", str(steps), "--device", "cuda"] + extra)
        launches = dict(ops.LAUNCHES)
        pngs = sorted(os.listdir(os.path.join(logdir, "img")))
        size = Image.open(os.path.join(logdir, "img", pngs[0])).size
        what = "vanilla DDPM-1000" if extra else f"DDIM-{steps}"
        print(f"sample_diffusion CLI churches {what}, B={b}: {len(pngs)} PNGs of {size}, "
              f"{seconds:.1f} s wall (load included) {tag}; launches {launches}")
        cucfg, cfcfg, _ = models["churches"]
        res = cucfg.image_size * 2 ** (len(cfcfg.block_out_channels) - 1)  # 256 (kl-f8)
        assert len(pngs) == b and size == (res, res) and stats["nonfinite"] == 0, stats
        assert launches["group_norm"] == steps * sum(gn_cu.values()) + sum(gn_cd.values())
        assert launches["attention"] == steps * sum(attn_cu.values()) + sum(attn_cd.values())
        out[f"churches_cli_{'vanilla' if extra else 'ddim'}"] = {
            "seconds": seconds, "launches": launches, "imgs_per_s": stats["imgs_per_s"]}
    lap("sample_diffusion churches")

    # (f) the DDPM samplers on the dense CIFAR UNet: PLMS and DPM-Solver++,
    # kernels on against off; then the sequence and interpolation grids
    ccfg, cstate = load_model(cifar["ckpt"])
    cmodel = UNet2D(ccfg, device=dev)
    cmodel.load_state_dict(cstate)
    cmodel.eval()
    x_T = torch.randn((B, 32, 32, 3), generator=gen, device=dev)
    gn_c, attn_c = cifar["per_call"]
    for kind in ("plms", "dpm"):
        sample = make_sampler(cmodel, cifar["sched"],
                              SamplerConfig(num_inference_steps=CIFAR_MULTI_STEPS, kind=kind))
        runs = {}
        for on in (True, False):
            ops.reset_launch_counts()
            runs[on] = (switched(on, lambda: sample(None, B, 32, 3, x_T=x_T)),
                        dict(ops.LAUNCHES))
        (img_on, c_on), (img_off, c_off) = runs[True], runs[False]
        err, ok = compare_rel(img_on, img_off, LDM_REL_TOL)
        calls = CIFAR_MULTI_STEPS + (kind == "plms")
        print(f"sampler cifar10 {kind}-{CIFAR_MULTI_STEPS} B={B} f32 (clip_sample), kernels on "
              f"vs off from one x_T: max abs err {err:.3e} (tol {LDM_REL_TOL} x max); "
              f"launches on {c_on}")
        assert ok, (kind, err)
        assert (c_on["group_norm"], c_on["attention"]) == (calls * gn_c, calls * attn_c), c_on
        assert not any(c_off.values()), c_off
        out[f"cifar_{kind}"] = {"max_abs_err": err, "launches": c_on}
        del runs, img_on, img_off
    for mode, cols, rows_ in (("sequence", 11, 4), ("interpolation", 11, 1)):
        res, _, seconds = run_cli(ddpm_sample.main, [
            "--model_path", cifar["ckpt"], "--output_dir", os.path.join(tmp, f"grid_{mode}"),
            "--mode", mode, "--ddim_steps", str(CIFAR_MULTI_STEPS), "--device", "cuda"])
        arr = np.asarray(Image.open(res["path"]))
        print(f"ddpm_sample CLI --mode {mode} --ddim_steps {CIFAR_MULTI_STEPS}: {res['path']} "
              f"{arr.shape}, {seconds:.1f} s wall")
        assert arr.shape == (34 * rows_ + 2, 34 * cols + 2, 3), (mode, arr.shape)
    del cmodel
    lap("cifar samplers and grids")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"uncond ldm phase {out['seconds']:.1f} s ("
          + ", ".join(f"{k} at {v:.1f} s" for k, v in out["laps_s"].items()) + ")")
    return out


def ldm_train_path(tmp, model_dir, pruned_dir, gen, gpu, tag, worst, others_fwd, others_bwd):
    """Phase 18 (see the module docstring); returns its figures."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.cli import ldm_sample, ldm_train
    from diff_pruning_tpu_torch.data.procedural import (make_procedural_dataset,
                                                        write_labeled_folder)
    from diff_pruning_tpu_torch.models.latent_diffusion import load_ldm
    from diff_pruning_tpu_torch.ops import attention as A
    from diff_pruning_tpu_torch.ops import group_norm as G
    from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
    from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference
    from diff_pruning_tpu_torch.training.finetune import Optimizer, TrainConfig

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    rows, bf16 = LDM_TRAIN_B, torch.bfloat16
    models = {"dense": load_ldm(model_dir, device=dev), "pruned": load_ldm(pruned_dir, device=dev)}
    for m in models.values():
        m.first_stage.cast_compute_weights(bf16)
    ucfg, fcfg = models["dense"].unet.cfg, models["dense"].first_stage.cfg
    hw = ucfg.image_size
    res = hw * 2 ** (len(fcfg.block_out_channels) - 1)
    shapes, per_step = {}, {}
    for name, m in models.items():
        (gn_u, attn_u), _, (gn_e, attn_e) = ldm_op_shapes(m.unet.cfg, fcfg, encode=True)
        shapes[name] = (gn_u, attn_u, gn_e, attn_e)
        n_gn, n_attn = sum(gn_u.values()), sum(attn_u.values())
        per_step[name] = {"group_norm": n_gn + sum(gn_e.values()), "group_norm_bwd": n_gn,
                          "attention": n_attn + sum(attn_e.values()), "attention_lse": n_attn,
                          "attention_bwd_dq": n_attn, "attention_bwd_dkv": n_attn}
    gn_unet, attn_unet, gn_enc, attn_enc = shapes["dense"]
    attn_pruned = shapes["pruned"][1]
    print(f"ldm train: per bf16 train step at B={rows}: launches {per_step['dense']} (the "
          f"encode: {dict(gn_enc)} GroupNorm, {dict(attn_enc)} attention, no grad); attention "
          f"shapes {dict(attn_unet)}, pruned {dict(attn_pruned)}")
    assert per_step["dense"] == per_step["pruned"], per_step

    # (a) the 16-bit attention kernels (the forward, its inference launch and
    # with lse; dq; dk/dv) against their plain versions at every shape of one
    # train step, through head-split views of (B, N, D) projections (pruned
    # widths: rows 8-byte aligned in 16 bits), bf16 and f16
    def views(n, d, dtype):
        return torch.randn((rows, n, d), generator=gen, device=dev).to(dtype) \
            .view(rows, n, 1, d).transpose(1, 2)

    cases = ([(s, "unet") for s in sorted(attn_unet)]
             + [(s, "pruned unet") for s in sorted(attn_pruned)]
             + [((64, 64, 1, 320), "ragged"), ((64, 1, 1, 320), "ragged")]
             + [(s, "encode") for s in sorted(attn_enc)])
    for dname, (atol, rtol), btol in (("bfloat16", TOL["bfloat16"], BWD_TOL["bfloat16"]),
                                      ("float16", F16_TOL, F16_BWD_TOL)):
        dtype = getattr(torch, dname)
        for (nq, nkv, h, d), where in cases:
            q, do = views(nq, d, dtype), views(nq, d, dtype)
            k, v = views(nkv, d, dtype), views(nkv, d, dtype)
            scale = d ** -0.5
            errs = {}
            got = flash_attention(q, k, v, scale)
            want = reference_attention(q, k, v, scale)
            err = (got.float() - want.float()).abs()
            assert bool(torch.isfinite(got).all()) and bool(
                (err <= atol + rtol * want.float().abs()).all()), (dname, where, nq, nkv, d)
            errs["o"] = float(err.max())
            o, lse = A.flash_attention_forward_lse(q, k, v, scale)
            po, plse = A.reference_attention_lse(q, k, v, scale)
            assert torch.equal(o, got), (dname, where, nq, nkv, d)
            errs["lse"], ok = compare_rel(lse, plse, BWD_TOL["float32"])
            assert ok, (dname, where, nq, nkv, d, errs)
            if where != "encode":  # no grad through the frozen first stage
                dq, dsum = A.flash_attention_backward_dq(q, k, v, po, do, plse, scale)
                pdq, pdsum = A.attention_backward_dq_reference(q, k, v, po, do, plse, scale)
                dk, dv = A.flash_attention_backward_dkv(q, k, v, do, plse, pdsum, scale)
                pdk, pdv = A.attention_backward_dkv_reference(q, k, v, do, plse, pdsum, scale)
                floor = (1e-6 * max(float(g.float().abs().max()) for g in (pdq, pdk, pdv))
                         if nkv == 1 else 0.0)
                for what, a, w, tol, fl in (("dsum", dsum, pdsum, BWD_TOL["float32"], 0.0),
                                            ("dq", dq, pdq, btol, floor),
                                            ("dk", dk, pdk, btol, floor), ("dv", dv, pdv, btol, 0.0)):
                    e = float((a.float() - w.float()).abs().max())
                    assert bool(torch.isfinite(a.float()).all()) and \
                        e <= tol * float(w.float().abs().max()) + fl, (dname, where, what, e)
                    errs[what] = e
                worst[("attention_bwd_dq_ldm_train", dname)] = max(
                    worst[("attention_bwd_dq_ldm_train", dname)], errs["dq"], errs["dsum"])
                worst[("attention_bwd_dkv_ldm_train", dname)] = max(
                    worst[("attention_bwd_dkv_ldm_train", dname)], errs["dk"], errs["dv"])
                # a repeat is bit-identical (no atomics; the clusters add their
                # partials in rank order)
                dq2, dsum2 = A.flash_attention_backward_dq(q, k, v, po, do, plse, scale)
                dk2, dv2 = A.flash_attention_backward_dkv(q, k, v, do, plse, pdsum, scale)
                assert all(torch.equal(a, b) for a, b in ((dq, dq2), (dsum, dsum2), (dk, dk2),
                                                           (dv, dv2))), (dname, where, nq, nkv, d)
                del dq, dk, dv, pdq, pdk, pdv, dq2, dk2, dv2
            worst[("attention_ldm_train", dname)] = max(worst[("attention_ldm_train", dname)],
                                                        errs["o"])
            taken = "" if where == "encode" else "; dq by the {} kernel, dk/dv by the {}, a " \
                "repeat bit-identical".format(*("wgmma" if w else "16-row"
                                                for w in wgmma_bwd_taken(rows, h, nq, nkv)))
            print(f"check ldm train attention ({where}) rows={rows} Nq={nq} Nkv={nkv} D={d} "
                  f"{dname}: " + " ".join(f"{k_}={e:.3e}" for k_, e in errs.items())
                  + f" (tol o {(atol, rtol)}, grads {btol} x max|want|"
                  + (f" + {floor:.3e} at Nkv = 1" if where != "encode" and nkv == 1 else "")
                  + ", lse and dsum 1e-4 x max|want|)" + taken + " ok")
            del q, k, v, do, got, want, o, po
    check_wide_edges(("bfloat16", "float16"), gen, dev, worst, "attention_ldm_train")
    check_wide_bwd_edges(gen, dev, worst)
    # the GroupNorm forward (the UNet's and the encode's) and backward (the
    # UNet's) in bf16 at the step's shapes
    for (n, c, eps, silu), where in ([(s, "unet") for s in sorted(gn_unet)]
                                     + [(s, "encode") for s in sorted(gn_enc)]):
        x = (torch.randn((rows, n, c), generator=gen, device=dev) * 2 + 0.5).to(bf16)
        scale = torch.rand((c,), generator=gen, device=dev) + 0.5
        bias = torch.randn((c,), generator=gen, device=dev) * 0.1
        kw = dict(groups=32, eps=eps, with_silu=silu)
        err, ok = compare(group_norm(x, scale, bias, **kw), group_norm_reference(x, scale, bias,
                                                                                 **kw), "bfloat16")
        assert ok, (where, n, c, silu, err)
        worst[("group_norm_ldm_train", "bfloat16")] = max(
            worst[("group_norm_ldm_train", "bfloat16")], err)
        line = f"fwd {err:.3e}"
        if where == "unet":
            dy = torch.randn((rows, n, c), generator=gen, device=dev).to(bf16)
            mean, rstd = G.group_norm_stats_reference(x, 32, eps=eps)
            got = G.group_norm_backward(x, scale, bias, dy, mean, rstd, groups=32, with_silu=silu)
            want = G.group_norm_backward_reference(x, scale, bias, dy, mean, rstd, groups=32,
                                                   with_silu=silu)
            for what, a, w in zip(("dx", "dscale", "dbias"), got, want):
                e, ok = compare_rel(a, w, BWD_TOL["bfloat16"])
                assert ok, (where, n, c, silu, what, e)
                worst[("group_norm_bwd_ldm_train", "bfloat16")] = max(
                    worst[("group_norm_bwd_ldm_train", "bfloat16")], e)
                line += f" {what} {e:.3e}"
        print(f"check ldm train group_norm ({where}) rows={rows} N={n} C={c} silu={silu} "
              f"bfloat16: {line} (tol {TOL['bfloat16']}, bwd {BWD_TOL['bfloat16']} x max|want|) ok")
        del x
    # what no kernel takes raises in every dtype and launches nothing: D = 1040
    q = torch.randn((2, 1, 16, 1040), generator=gen, device=dev)
    lse = torch.zeros((2, 1, 16), device=dev)
    before = dict(ops.LAUNCHES)
    for dtype in (torch.float32, bf16, torch.float16):
        qd = q.to(dtype)
        for what, fn in (("forward", lambda: flash_attention(qd, qd, qd, 0.05)),
                         ("backward", lambda: A.flash_attention_backward(*[qd] * 5, lse, 0.05)),
                         ("forward under autograd", lambda: flash_attention(
                             qd.clone().requires_grad_(), qd, qd, 0.05))):
            try:
                fn()
            except ValueError:
                pass
            else:
                raise AssertionError(f"attention {what} at D = 1040 {dtype} did not raise")
    assert ops.LAUNCHES == before, "a refused attention call launched"
    print("check ldm train attention D=1040 f32/bf16/f16 forward, backward and forward under "
          "autograd: ValueError, nothing launched ok")
    torch.cuda.synchronize()

    # (b) one dense bf16 train step, kernels on against off, from the same
    # state on the same images, labels, noise, t and drop mask
    torch.backends.cudnn.deterministic = True
    tgen = torch.Generator(device=dev).manual_seed(12)
    images = torch.rand((rows, res, res, 3), generator=tgen, device=dev) * 2 - 1
    labels = torch.randint(0, 1000, (rows,), generator=tgen, device=dev)
    noise = torch.randn((rows, hw, hw, ucfg.out_channels), generator=tgen, device=dev)
    tt = torch.randint(0, 1000, (rows,), generator=tgen, device=dev)
    drop = torch.rand((rows,), generator=tgen, device=dev) < 0.1
    opt = Optimizer(TrainConfig(learning_rate=LDM_TRAIN_LR, weight_decay=0.0, grad_clip=1.0,
                                use_ema=False))
    dense = models["dense"]
    master = {n: p.detach().clone() for n, p in dense.unet.named_parameters()}

    def train_step(on):
        ops.set_kernels_enabled(on)
        try:
            with torch.no_grad():
                for n, p in dense.unet.named_parameters():
                    p.copy_(master[n])
            params = dict(dense.unet.named_parameters())
            st = opt.init(params)
            step = ldm_train.make_ldm_train_step(dense, opt, params, compute_dtype=bf16)
            ops.reset_launch_counts()
            loss, gnorm = step(st, images, labels, noise, tt, drop)
            torch.cuda.synchronize()
            # Adam's first moment: 0.1 x the step's clipped grads
            return float(loss), float(gnorm), st.mu, dict(ops.LAUNCHES)
        finally:
            ops.set_kernels_enabled(True)

    fwd_dtypes, unwrap_fwd = record_fwd_dtypes()
    bwd_dtypes, unwrap_bwd = record_bwd_dtypes()
    try:
        loss_on, gn_on, mu_on, c_on = train_step(True)
    finally:
        unwrap_fwd()
        unwrap_bwd()
    loss_off, gn_off, mu_off, c_off = train_step(False)
    with torch.no_grad():
        for n, p in dense.unet.named_parameters():
            p.copy_(master[n])
    del master
    assert c_on == per_step["dense"] and not any(c_off.values()), (c_on, c_off)
    want_dtypes = {("attention", "torch.bfloat16"): per_step["dense"]["attention"],
                   ("group_norm", "torch.bfloat16"): per_step["dense"]["group_norm"]}
    assert dict(fwd_dtypes) == want_dtypes, fwd_dtypes
    assert dict(bwd_dtypes) == {
        ("group_norm_bwd", "torch.bfloat16"): per_step["dense"]["group_norm_bwd"],
        ("attention_bwd", "torch.bfloat16"): per_step["dense"]["attention_bwd_dq"]}, bwd_dtypes
    loss_rel = abs(loss_on / loss_off - 1)
    diff = math.sqrt(sum(float(((mu_on[n] - m) ** 2).sum()) for n, m in mu_off.items()))
    norm = math.sqrt(sum(float((m ** 2).sum()) for m in mu_off.values()))
    print(f"ldm train step cin256-v2 B={rows} bf16, kernels on vs off: loss {loss_on:.6f} against "
          f"{loss_off:.6f}, rel diff {loss_rel:.3e} (tol {TRAIN_BF16_LOSS_RTOL}); grad norm "
          f"{gn_on:.4f} against {gn_off:.4f}; the step's grads (Adam's mu) |on - off| / |off| "
          f"{diff / norm:.3e} (tol {TRAIN_BF16_GRAD_RTOL}); launches on {c_on}; forward launches "
          f"by dtype {dict(fwd_dtypes)}, backward calls by dtype {dict(bwd_dtypes)}")
    assert math.isfinite(loss_on) and loss_rel <= TRAIN_BF16_LOSS_RTOL, (loss_on, loss_off)
    assert all(bool(torch.isfinite(m).all()) for m in mu_on.values())
    assert diff <= TRAIN_BF16_GRAD_RTOL * norm, (diff, norm)
    del mu_on, mu_off

    # (c) the main path: the ldm_train CLI on phase 17's pruned model dir,
    # its defaults (B = 16, bf16), then a resume from the first save
    data = os.path.join(tmp, "ldm_train_data")
    write_labeled_folder(make_procedural_dataset(LDM_TRAIN_IMAGES, res, seed=13),
                         np.arange(LDM_TRAIN_IMAGES) % 2, data)
    base = ["--model_path", pruned_dir, "--dataset", data, "--num_iters", str(LDM_TRAIN_STEPS),
            "--save_model_steps", str(LDM_TRAIN_SAVE), "--log_steps", "1", "--device", "cuda"]
    out, out2 = os.path.join(tmp, "ldm_trained"), os.path.join(tmp, "ldm_trained_resumed")
    ops.reset_launch_counts()
    stats, _, cli_seconds = run_cli(ldm_train.main, base + ["--output_dir", out])
    cli_counts = dict(ops.LAUNCHES)
    want_cli = {k: LDM_TRAIN_STEPS * v for k, v in per_step["pruned"].items()}
    print(f"main path ldm_train CLI: {stats['steps']} steps of B={rows} bf16 on the pruned "
          f"model (losses {stats['losses']}), {stats['imgs_per_sec']:.2f} imgs/s, whole CLI "
          f"{cli_seconds:.2f} s (host clock, load included), saves "
          f"{[round(x, 2) for x in stats['save_seconds']]} s {tag}; launches {cli_counts}")
    assert stats["steps"] == LDM_TRAIN_STEPS and np.isfinite(stats["losses"]).all()
    assert cli_counts == want_cli, (cli_counts, want_cli)
    resumed, _, resume_seconds = run_cli(ldm_train.main, base + [
        "--output_dir", out2, "--resume_from_checkpoint",
        os.path.join(out, "ckpt", f"step-{LDM_TRAIN_SAVE}")])
    last = f"step-{LDM_TRAIN_STEPS}"
    identical = {name: npz_equal(os.path.join(out, "ckpt", last, name),
                                 os.path.join(out2, "ckpt", last, name))
                 for name in ("params.npz", "opt_state.npz")}
    print(f"main path ldm_train resume from step {LDM_TRAIN_SAVE}: losses {resumed['losses']}, "
          f"{resume_seconds:.2f} s; step-{LDM_TRAIN_STEPS} bit-identical to the uninterrupted "
          f"run: {identical}")
    assert all(identical.values()) and resumed["losses"] == stats["losses"][LDM_TRAIN_SAVE:]
    torch.backends.cudnn.deterministic = False
    trained = load_ldm(out, device=dev)
    n_trained = sum(p.numel() for p in trained.unet.parameters())
    assert n_trained == LDM_PRUNED_PARAMS_AT_0_3 and trained.first_stage is not None
    del trained
    samples, _, sample_seconds = run_cli(ldm_sample.main, [
        "--model_path", out, "--output_dir", os.path.join(tmp, "ldm_trained_s"),
        "--num_classes", "1", "--ipc", "4", "--batch_size", "4", "--ddim_steps",
        str(LDM_MULTI_STEPS), "--device", "cuda"])
    print(f"main path check: the trained LDM reloads at {n_trained:,} UNet params; ldm_sample "
          f"drew {samples['images']} images, {samples['nonfinite']} non-finite values, in "
          f"{sample_seconds:.1f} s")
    assert samples["images"] == 4 and samples["nonfinite"] == 0

    # (d) timings: the bf16 train step, kernels on and off, dense and pruned,
    # split into the encode, the UNet's forward + backward and the optimizer;
    # peak memory; a profile by kernel class
    step_ms, profiles = {}, {}
    for name, m in models.items():
        params = dict(m.unet.named_parameters())
        plist = list(params.values())
        st = opt.init(params)
        step = ldm_train.make_ldm_train_step(m, opt, params, compute_dtype=bf16)

        def run(on, step=step, st=st):
            ops.set_kernels_enabled(on)
            try:
                step(st, images, labels, noise, tt, drop)
            finally:
                ops.set_kernels_enabled(True)

        def encode(m=m):
            with torch.no_grad():
                m.first_stage.encode(images.to(bf16))

        def fwd_bwd(m=m, plist=plist):
            torch.autograd.grad(m.train_loss(images, labels, tt, noise, drop=drop,
                                             compute_dtype=bf16), plist)

        grads = list(torch.autograd.grad(m.train_loss(images, labels, tt, noise, drop=drop,
                                                      compute_dtype=bf16), plist))
        norm_ = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        for fn in (lambda: run(False), lambda: run(True), encode):  # one warm-up each
            fn()
        off, on = one_turn([lambda: run(False), lambda: run(True)])
        enc_ms, fb_ms = one_turn([encode, fwd_bwd])
        opt_ms = cuda_ms(lambda: opt.update(grads, norm_, st, plist), iters=3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        run(True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        if name == "dense":  # a profile of the dense step
            busy, span, launches, counts, _ = profile_kernels(lambda: run(True))
            print_profile(f"ldm train step {name} kernels on B={rows} bf16", busy, span,
                          launches, counts, ("step", 1), tag)
            profiles[name] = {"busy_ms": busy, "span_ms": span, "launches": launches,
                              "idle_share": 1 - sum(busy.values()) / span}
        step_ms[name] = {"kernels_on_ms": on, "kernels_off_ms": off,
                         "kernels_on_imgs_per_s": rows * 1e3 / on,
                         "kernels_off_imgs_per_s": rows * 1e3 / off, "encode_ms": enc_ms,
                         "unet_fwd_bwd_ms": fb_ms - enc_ms, "optimizer_ms": opt_ms,
                         "peak_gb": peak}
        print(f"time ldm train step {name} B={rows} bf16: kernels on {on:.1f} ms "
              f"({rows * 1e3 / on:.2f} imgs/s), kernels off {off:.1f} ms ({rows * 1e3 / off:.2f} "
              f"imgs/s) (CUDA events, one step off then one on); kernels on: encode "
              f"{enc_ms:.1f} ms, "
              f"UNet forward + backward {fb_ms - enc_ms:.1f} ms, optimizer (clip + AdamW) "
              f"{opt_ms:.1f} ms; peak memory {peak:.2f} GB {tag}")
        del grads, st, step
    # L2 bytes a row of the wide 16-bit backward at the step's shapes: the
    # wgmma kernels' 64-row tiles against the 16-row kernels' (16 q rows in
    # dq, 8 kv rows in dk/dv), and which of them the call takes
    for nq, nkv, h, d in sorted(set(attn_unet) | set(attn_pruned), reverse=True):
        new, old = bwd_l2_bytes(nq, nkv, d, 64, 64), bwd_l2_bytes(nq, nkv, d, 16, 8)
        print(f"ldm train bwd L2 bytes a row {(nq, nkv, d)}: dq {new[0]:,.0f} (16-row kernel "
              f"{old[0]:,.0f}) a q row, dk/dv {new[1]:,.0f} ({old[1]:,.0f}) a kv row; at B={rows} "
              "the call takes dq by the {}, dk/dv by the {} kernel".format(
                  *("wgmma" if w else "16-row" for w in wgmma_bwd_taken(rows, h, nq, nkv))))
    # per-op: the 16-bit attention forward with lse (the training launch), dq
    # and dk/dv at the step's shapes, against plain, SDPA and the bound
    ops_ms = {}
    for name, attn_cases in (("dense", attn_unet), ("pruned", attn_pruned)):
        tot = collections.defaultdict(float)
        backends = set()
        for (nq, nkv, h, d), ncalls in sorted(attn_cases.items()):
            q, do = views(nq, d, bf16), views(nq, d, bf16)
            k, v = views(nkv, d, bf16), views(nkv, d, bf16)
            scale = d ** -0.5
            o, lse = A.reference_attention_lse(q, k, v, scale)
            _, dsum = A.attention_backward_dq_reference(q, k, v, o, do, lse, scale)
            ql, kl, vl = (z.detach().clone().requires_grad_() for z in (q, k, v))
            ol = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
            fns = [lambda: A.reference_attention_lse(q, k, v, scale),
                   lambda: A.flash_attention_forward_lse(q, k, v, scale),
                   lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                   lambda: A.attention_backward_dq_reference(q, k, v, o, do, lse, scale),
                   lambda: A.flash_attention_backward_dq(q, k, v, o, do, lse, scale),
                   lambda: A.attention_backward_dkv_reference(q, k, v, do, lse, dsum, scale),
                   lambda: A.flash_attention_backward_dkv(q, k, v, do, lse, dsum, scale),
                   lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)]
            fns += [with_lib("fwd", lib, lambda: A.flash_attention_forward_lse(q, k, v, scale))
                    for lib in others_fwd.values()]
            for lib in others_bwd.values():  # the other backwards, in the same turns
                fns += [with_lib("bwd", lib, lambda: A.flash_attention_backward_dq(
                            q, k, v, o, do, lse, scale)),
                        with_lib("bwd", lib, lambda: A.flash_attention_backward_dkv(
                            q, k, v, do, lse, dsum, scale))]
            ms = in_turns(fns, iters=2)
            nf = 8 + len(others_fwd)
            other_ms = dict(zip(others_fwd, ms[8:nf]))
            other_bwd_ms = {label: ms[nf + 2 * i: nf + 2 * i + 2]
                            for i, label in enumerate(others_bwd)}
            backend = (sdpa_backend(fns[2]), sdpa_backend(fns[7]))
            backends.add(backend)
            fwd_bytes = 2 * rows * (2 * nq + 2 * nkv) * d + 4 * rows * nq
            fwd_flops = 4 * rows * nq * nkv * d
            (bq_bytes, fq), (bkv_bytes, fkv) = ldm_bwd_work(rows, nq, nkv, d, es=2)
            bounds = {"fwd": bound(fwd_bytes, fwd_flops, "bfloat16"),
                      "dq": bound(bq_bytes, fq, "bfloat16"), "dkv": bound(bkv_bytes, fkv, "bfloat16")}
            for key, val in (("fwd_plain", ms[0]), ("fwd_kernel", ms[1]), ("fwd_library", ms[2]),
                             ("dq_plain", ms[3]), ("dq_kernel", ms[4]), ("dkv_plain", ms[5]),
                             ("dkv_kernel", ms[6]), ("bwd_library", ms[7]),
                             ("fwd_flops", fwd_flops), ("dq_flops", fq), ("dkv_flops", fkv),
                             *((f"fwd_kernel_{label}", oms) for label, oms in other_ms.items()),
                             *((f"{part}_kernel_{label}", t) for label, pair in other_bwd_ms.items()
                               for part, t in zip(("dq", "dkv"), pair))):
                tot[key] += val * ncalls
            for part, (bms, by) in bounds.items():
                add_bound(tot, part + "_", bms * ncalls, by)
            print(f"time ldm train attention {(nq, nkv, d)} x{ncalls}/step rows={rows} bfloat16: "
                  f"forward with lse kernel {ms[1]:.4f} ms, {fwd_flops / ms[1] / 1e9:.2f} TFLOP/s "
                  f"(plain {ms[0]:.4f}, SDPA {ms[2]:.4f} via {backend[0]}, bound "
                  f"{bounds['fwd'][0]:.4f} {bounds['fwd'][1]}"
                  + "".join(f", {label} kernel {oms:.4f}" for label, oms in other_ms.items())
                  + f"); dq kernel {ms[4]:.4f} ms, "
                  f"{fq / ms[4] / 1e9:.2f} TFLOP/s (plain {ms[3]:.4f}, bound {bounds['dq'][0]:.4f} "
                  f"{bounds['dq'][1]}); dk/dv kernel {ms[6]:.4f} ms, {fkv / ms[6] / 1e9:.2f} "
                  f"TFLOP/s (plain {ms[5]:.4f}, bound {bounds['dkv'][0]:.4f} {bounds['dkv'][1]}); "
                  f"SDPA backward (dq+dk+dv, {backend[1]}) {ms[7]:.4f} ms"
                  + "".join(f"; {label} dq {a:.4f} ms, dk/dv {b:.4f} ms"
                            for label, (a, b) in other_bwd_ms.items()) + f" {tag}")
            del fns, q, k, v, do, o, ql, kl, vl, ol
        for part in ("fwd", "dq", "dkv"):
            tot[part + "_tflops"] = tot[part + "_flops"] / tot[part + "_kernel"] / 1e9
            tot[part + "_bound_by"] = bound_by(tot, part + "_")
        tot["sdpa_backends"] = sorted(backends)
        ops_ms[name] = dict(tot)
        print(f"time ldm train attention per train step ({name}) rows={rows} bfloat16: " + ", ".join(
            f"{k_} {v_:.4f}" if isinstance(v_, float) else f"{k_} {v_}"
            for k_, v_ in sorted(ops_ms[name].items())) + f" {tag}")
    # the encode's attention (no grad: the inference launch), as above
    tot = collections.defaultdict(float)
    for (nq, nkv, h, d), ncalls in sorted(attn_enc.items()):
        q, k, v = views(nq, d, bf16), views(nkv, d, bf16), views(nkv, d, bf16)
        scale = d ** -0.5
        fns = [lambda: reference_attention(q, k, v, scale), lambda: flash_attention(q, k, v, scale),
               lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)]
        fns += [with_lib("fwd", lib, lambda: flash_attention(q, k, v, scale))
                for lib in others_fwd.values()]
        ms = in_turns(fns, iters=3)
        other_ms = dict(zip(others_fwd, ms[3:]))
        flops = 4 * rows * nq * nkv * d
        bms, by = bound(2 * rows * (2 * nq + 2 * nkv) * d, flops, "bfloat16")
        for key, val in (("fwd_plain", ms[0]), ("fwd_kernel", ms[1]), ("fwd_library", ms[2]),
                         ("fwd_flops", flops),
                         *((f"fwd_kernel_{label}", oms) for label, oms in other_ms.items())):
            tot[key] += val * ncalls
        add_bound(tot, "fwd_", bms * ncalls, by)
        print(f"time ldm train encode attention {(nq, nkv, d)} x{ncalls}/step rows={rows} "
              f"bfloat16: kernel {ms[1]:.4f} ms, {flops / ms[1] / 1e9:.2f} TFLOP/s (plain "
              f"{ms[0]:.4f}, SDPA {ms[2]:.4f} via {sdpa_backend(fns[2])}, bound {bms:.4f} {by}"
              + "".join(f", {label} kernel {oms:.4f}" for label, oms in other_ms.items())
              + f") {tag}")
        del fns, q, k, v
    tot["fwd_tflops"] = tot["fwd_flops"] / tot["fwd_kernel"] / 1e9
    tot["fwd_bound_by"] = bound_by(tot, "fwd_")
    ops_ms["encode"] = dict(tot)
    # the bf16 GroupNorm forward (the UNet's and the encode's) and backward
    # (the UNet's) at the dense step's shapes, against plain, F.group_norm
    # (its autograd for the backward; the no-SiLU calls) and the bound
    tot = collections.defaultdict(float)
    gn_fwd_calls = collections.Counter(gn_unet) + collections.Counter(gn_enc)
    for (n, c, eps, silu), ncalls in sorted(gn_fwd_calls.items()):
        x = (torch.randn((rows, n, c), generator=gen, device=dev) * 2 + 0.5).to(bf16)
        dy = torch.randn((rows, n, c), generator=gen, device=dev).to(bf16)
        sc = torch.rand((c,), generator=gen, device=dev) + 0.5
        bi = torch.randn((c,), generator=gen, device=dev) * 0.1
        kw = dict(groups=32, eps=eps, with_silu=silu)
        mean, rstd = G.group_norm_stats_reference(x, 32, eps=eps)
        bwd_calls = gn_unet.get((n, c, eps, silu), 0)
        fns = [lambda: group_norm_reference(x, sc, bi, **kw), lambda: group_norm(x, sc, bi, **kw)]
        if bwd_calls:
            fns += [lambda: G.group_norm_backward_reference(x, sc, bi, dy, mean, rstd, groups=32,
                                                            with_silu=silu),
                    lambda: G.group_norm_backward(x, sc, bi, dy, mean, rstd, groups=32,
                                                  with_silu=silu)]
        if not silu:  # F.group_norm on its own (B, C, N) layout, and its autograd
            xl = x.transpose(1, 2).contiguous().requires_grad_()
            sl, bl = (z.to(bf16, copy=True).requires_grad_() for z in (sc, bi))
            fns.append(lambda: F.group_norm(xl, 32, sl, bl, eps=eps))
            if bwd_calls:
                yl = F.group_norm(xl, 32, sl, bl, eps=eps)
                dyl = dy.transpose(1, 2).contiguous()
                fns.append(lambda: torch.autograd.grad(yl, (xl, sl, bl), dyl, retain_graph=True))
        el = rows * n * c
        ms = in_turns(fns, iters=2 if el > 2e8 else 5)
        fb = bound(2 * el * 2 + 2 * c * 4, el * (9 if silu else 5), "bfloat16")
        for key, val in (("fwd_plain", ms[0]), ("fwd_kernel", ms[1])):
            tot[key] += val * ncalls
        add_bound(tot, "fwd_", fb[0] * ncalls, fb[1])
        line = f"forward kernel {ms[1]:.4f} ms (plain {ms[0]:.4f}, bound {fb[0]:.4f} {fb[1]}"
        lib = ms[4:] if bwd_calls else ms[2:]
        if lib:
            tot["fwd_library"] += lib[0] * ncalls
            tot["fwd_kernel_where_library"] += ms[1] * ncalls
            line += f", F.group_norm {lib[0]:.4f}"
        line += ")"
        if bwd_calls:
            bb = bound(*gn_bwd_work(n, c, silu, "bfloat16", rows=rows), "bfloat16")
            tot["bwd_plain"] += ms[2] * bwd_calls
            tot["bwd_kernel"] += ms[3] * bwd_calls
            add_bound(tot, "bwd_", bb[0] * bwd_calls, bb[1])
            line += f"; backward kernel {ms[3]:.4f} ms (plain {ms[2]:.4f}, bound {bb[0]:.4f} {bb[1]}"
            if len(lib) == 2:
                tot["bwd_library"] += lib[1] * bwd_calls
                tot["bwd_kernel_where_library"] += ms[3] * bwd_calls
                line += f", autograd of F.group_norm {lib[1]:.4f}"
            line += ")"
        print(f"time ldm train group_norm {(n, c, silu)} x{ncalls} fwd, x{bwd_calls} bwd/step "
              f"rows={rows} bfloat16: {line} {tag}")
        del fns, x, dy
    for part in ("fwd", "bwd"):
        tot[part + "_bound_by"] = bound_by(tot, part + "_")
    ops_ms["group_norm"] = dict(tot)
    print(f"time ldm train group_norm per train step (dense) rows={rows} bfloat16: " + ", ".join(
        f"{k_} {v_:.4f}" if isinstance(v_, float) else f"{k_} {v_}"
        for k_, v_ in sorted(ops_ms["group_norm"].items())) + f" {tag}")
    del models, dense
    print(f"ldm train phase {time.perf_counter() - t_phase:.1f} s")
    return {"card": gpu, "b": rows, "per_step": per_step["dense"], "cli_launches": cli_counts,
            "cli_seconds": cli_seconds, "cli_losses": stats["losses"],
            "cli_imgs_per_s": stats["imgs_per_sec"], "save_seconds": stats["save_seconds"],
            "resume_seconds": resume_seconds, "resume_identical": identical,
            "compare": {"loss_on": loss_on, "loss_off": loss_off, "grad_rel": diff / norm},
            "train_step": step_ms, "profiles": profiles, "ops_per_step": ops_ms,
            "sample_seconds": sample_seconds,
            "attn_pruned": {str(k_): v_ for k_, v_ in attn_pruned.items()}}


def ablation_path(tmp, gen, gpu, tag, worst, ctx):
    """Phase 20 (see the module docstring); returns the phase's figures.
    ``ctx``: ``ckpt`` (the dense CIFAR UNet's checkpoint dir, phase 5's),
    ``data`` (phase 10's seeded .npz), ``sched`` and ``per_call`` (the
    GroupNorm and attention calls of one UNet forward)."""
    import numpy as np
    import torch

    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.cli import (compute_ssim, ddpm_prune, ddpm_sample,
                                            prune_finetune, prune_ssim)
    from diff_pruning_tpu_torch.models.unet2d import UNet2D
    from diff_pruning_tpu_torch.sampling.ddim_sampler import SamplerConfig, make_sampler
    from diff_pruning_tpu_torch.utils.checkpoint import load_model

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    out = {"laps_s": {}}

    def lap(what):
        """Seconds since the phase began, at the end of ``what``."""
        out["laps_s"][what] = time.perf_counter() - t_phase

    g, a = ctx["per_call"]

    def reload(path, subfolder="unet"):
        pcfg, state = load_model(path, subfolder=subfolder)
        net = UNet2D(pcfg, device=dev)
        net.load_state_dict(state)
        return pcfg, net.eval(), sum(p.numel() for p in net.parameters())

    # (a) the prune CLI twice on one seeded batch (cuDNN deterministic, so both
    # sweeps give the same grads): importance-only, then cost-aware at its
    # param budget
    prune_flags = ["--pruner", "diff-pruning", "--pruning_ratio", "0.3", "--global_pruning",
                   "--max_sparsity", "0.75", "--max_steps", str(ABL_PRUNE_STEPS),
                   "--batch_size", str(B), "--skip_vis"]
    cost_flags = ["--cost_aware", "hybrid", "--match_params"]
    torch.backends.cudnn.deterministic = True
    runs = {}
    for name, extra in (("importance", []), ("cost_aware", cost_flags)):
        d = os.path.join(tmp, f"ablation_{name}")
        ops.reset_launch_counts()
        stats, _, secs = run_cli(ddpm_prune.main, ["--model_path", ctx["ckpt"], "--save_path", d,
                                                   "--dataset", ctx["data"], "--device", "cuda"]
                                 + prune_flags + extra)
        counts = dict(ops.LAUNCHES)
        steps = stats["steps_run"]
        pcfg, net, n = reload(d)
        print(f"ablation prune CLI {name}: {stats['params_before']} -> {n} params, "
              f"{stats['macs_before'] / 1e9:.4f}G -> {stats['macs'] / 1e9:.4f}G MACs, sweep "
              f"{steps} steps, whole CLI {secs:.2f}s (host clock, B={B}, f32) {tag}; launches "
              f"{counts}; channel sizes {json.dumps(stats['channel_sizes'], sort_keys=True)}")
        assert 1 <= steps <= ABL_PRUNE_STEPS and counts == unet_launches((g, a), steps), \
            (name, counts)
        assert n == stats["params"] and pcfg.channel_sizes == stats["channel_sizes"], name
        runs[name] = {"cfg": pcfg, "net": net, "stats": stats}
        out.setdefault("prune_cli", {})[name] = {
            "params": n, "macs": stats["macs"], "steps": steps, "seconds": secs,
            "launches": counts, "channel_sizes": stats["channel_sizes"]}
    torch.backends.cudnn.deterministic = False
    mp = runs["cost_aware"]["stats"]["match_params"]
    n_imp, n_cost = runs["importance"]["stats"]["params"], runs["cost_aware"]["stats"]["params"]
    off_by = abs(n_cost - n_imp) / n_imp
    print(f"ablation match_params: channel sparsity {mp['sparsity']:.4f}, {n_cost} params "
          f"against the importance-only run's {n_imp}: {off_by:.4%} off after {mp['probes']} "
          f"probes" + ("" if off_by <= 0.01 else " (the bisection's closest probe)"))
    assert mp["target"] == n_imp and mp["params"] == n_cost, (mp, n_imp, n_cost)
    assert off_by <= 0.01 or mp["probes"] == 24, (mp, off_by)
    out["match_params"] = dict(mp, off_by=off_by)
    lap("prune_cli")

    # (b) every kernel at both pruned UNets' GroupNorm and attention shapes
    shapes = {name: op_shapes(UNet2D(r["cfg"], device="cpu").eval()) for name, r in runs.items()}
    gn_cases = sorted(set().union(*(gn for gn, _ in shapes.values())))
    attn_cases = sorted(set(ABL_EXTRA_ATTN).union(*(at for _, at in shapes.values())))
    check_forward_kernels(gn_cases, attn_cases, gen, dev, worst, ("", "_cost"))
    check_backward_kernels(gn_cases, attn_cases, gen, dev, worst, ("", "_cost"))
    torch.cuda.synchronize()
    per_group = sorted({c // 32 for _, c, _ in gn_cases})
    head_dims = sorted({d for _, _, d in attn_cases})
    out["kernels"] = {"group_norm_shapes": [list(c) for c in gn_cases],
                      "attention_shapes": [list(c) for c in attn_cases],
                      "channels_a_group": per_group, "head_dims": head_dims,
                      "max_abs_err": {f"{op}/{dname}": worst[(op + "_cost", dname)]
                                      for op in ("group_norm", "group_norm_bwd", "attention",
                                                 "attention_lse", "attention_bwd_dq",
                                                 "attention_bwd_dkv")
                                      for dname in TOL}}
    print(f"ablation kernels: forward and backward, f32 and bf16, B={B}, held against plain "
          f"at {len(gn_cases)} GroupNorm and {len(attn_cases)} attention shapes (the two "
          f"pruned UNets' and {len(ABL_EXTRA_ATTN)} more): channels a group {per_group}, head "
          f"dims {head_dims}; max abs errors "
          f"{json.dumps(out['kernels']['max_abs_err'])} {tag}")
    lap("kernels")

    # (c) prune_finetune: the cost-aware prune, then bf16 steps, saves and vis
    pf = os.path.join(tmp, "ablation_finetune")
    bwd_dtypes, unwrap = record_bwd_dtypes()
    torch.backends.cudnn.deterministic = True
    ops.reset_launch_counts()
    try:
        chained, _, pf_secs = run_cli(prune_finetune.main, [
            "--model_path", ctx["ckpt"], "--dataset", ctx["data"], "--output_dir", pf,
            "--batch_size", str(B), "--num_iters", str(ABL_FT_STEPS), "--mixed_precision", "bf16",
            "--device", "cuda", "--prune_args=" + " ".join(prune_flags[4:] + cost_flags),
            f"--train_args=--save_model_steps {ABL_FT_SAVE} --log_steps {ABL_FT_SAVE} "
            f"--vis_samples {FT_VIS}"])
    finally:
        unwrap()
        torch.backends.cudnn.deterministic = False
    counts = dict(ops.LAUNCHES)
    sweep = chained["prune"]["steps_run"]
    losses = chained["train"]["losses"]
    print(f"ablation prune_finetune: sweep {sweep} steps, {ABL_FT_STEPS} bf16 steps, losses "
          f"{losses}; whole CLI {pf_secs:.2f}s {tag}; launches {counts}; backward calls by "
          f"dtype {dict(bwd_dtypes)}")
    # DDIM-100 vis grids at each save
    assert counts == unet_launches((g, a), sweep + ABL_FT_STEPS,
                                    ABL_FT_STEPS // ABL_FT_SAVE * 100), counts
    assert dict(bwd_dtypes) == {
        ("group_norm_bwd", "torch.float32"): sweep * g, ("attention_bwd", "torch.float32"): sweep * a,
        ("group_norm_bwd", "torch.bfloat16"): ABL_FT_STEPS * g,
        ("attention_bwd", "torch.bfloat16"): ABL_FT_STEPS * a}, bwd_dtypes
    assert len(losses) == ABL_FT_STEPS and all(math.isfinite(v) for v in losses), losses
    assert chained["prune"]["channel_sizes"] == runs["cost_aware"]["stats"]["channel_sizes"]
    _, ema, n_ema = reload(pf, subfolder="unet_ema")
    del ema
    drawn = ddpm_sample.main(["--model_path", pf, "--use_ema", "--output_dir",
                              os.path.join(tmp, "ablation_finetune_s"), "--total_samples", str(B),
                              "--batch_size", str(B), "--ddim_steps", str(SAMPLE_TIME_STEPS),
                              "--device", "cuda"])
    print(f"ablation prune_finetune check: unet_ema reloads at {n_ema} params; the sampling CLI "
          f"drew {drawn['images']} images from it, {drawn['nonfinite']} non-finite")
    assert n_ema == n_cost and drawn["images"] == B and drawn["nonfinite"] == 0
    out["prune_finetune"] = {"seconds": pf_secs, "losses": losses, "launches": counts,
                             "sweep_steps": sweep}
    lap("prune_finetune")

    # (d) the main path: the stage ablation, then compute_ssim over its folders
    sd = os.path.join(tmp, "ablation_ssim")
    ops.reset_launch_counts()
    ab, _, ab_secs = run_cli(prune_ssim.main, [
        "--model_path", ctx["ckpt"], "--save_path", sd, "--dataset", ctx["data"], "--stages",
        *map(str, ABL_STAGES), "--ddim_steps", str(ABL_DDIM), "--n_vis", str(ABL_N_VIS),
        "--batch_size", str(ABL_B), "--device", "cuda"])
    counts = dict(ops.LAUNCHES)
    print(f"main path prune_ssim: stages {list(ABL_STAGES)}, sweeps of B={ABL_B}, "
          f"DDIM-{ABL_DDIM} x {ABL_N_VIS} images a set; whole CLI {ab_secs:.2f}s, stages "
          f"{ab['seconds']} s (host clock, f32) {tag}; params {ab['params']}; launches {counts}")
    # the sweeps, then the base set and one set a stage
    assert counts == unet_launches((g, a), sum(ABL_STAGES),
                                    (1 + len(ABL_STAGES)) * ABL_DDIM), counts
    assert ab["steps_run"] == {s: s for s in ABL_STAGES}, ab["steps_run"]
    ssim = {}
    for stage in ("base",) + ABL_STAGES:
        folder = os.path.join(sd, f"stage_{stage}")
        assert len([f for f in os.listdir(folder) if f.endswith(".png")]) == ABL_N_VIS, folder
        if stage != "base":
            assert reload(folder)[2] == ab["params"][stage], stage
        ssim[stage], _, _ = run_cli(compute_ssim.main, [os.path.join(sd, "stage_base"), folder,
                                                        "--device", "cuda"])
    print(f"main path compute_ssim against stage_base (seeded weights: no order expected): "
          + ", ".join(f"stage_{k} SSIM {v['ssim']:.6f} MSE {v['mse']:.6f}"
                      for k, v in ssim.items()))
    assert abs(ssim["base"]["ssim"] - 1.0) <= ABL_SELF_SSIM_TOL and ssim["base"]["mse"] == 0.0
    assert all(np.isfinite([v["ssim"], v["mse"]]).all() for v in ssim.values())
    out["prune_ssim"] = {"seconds": ab_secs, "stage_seconds": ab["seconds"],
                         "params": ab["params"], "launches": counts,
                         "ssim": {str(k): v for k, v in ssim.items()}}
    lap("prune_ssim")

    # (e) DDIM sampling imgs/s of the two pruned UNets (the same param budget)
    out["sampling_imgs_per_s"] = {}
    for (name, r), dname in itertools.product(runs.items(), TOL):
        sample = make_sampler(r["net"], ctx["sched"], SamplerConfig(
            num_inference_steps=SAMPLE_TIME_STEPS, dtype=dname))
        warm = make_sampler(r["net"], ctx["sched"], SamplerConfig(num_inference_steps=2,
                                                                  dtype=dname))

        def run(on, sample=sample):
            ops.set_kernels_enabled(on)
            try:
                return cuda_ms(lambda: sample(gen, B, 32, 3), iters=1, warmup=0)
            finally:
                ops.set_kernels_enabled(True)

        for on in (False, True):
            ops.set_kernels_enabled(on)
            warm(gen, B, 32, 3)
        ops.set_kernels_enabled(True)
        off1, on1 = run(False), run(True)
        rate_on, rate_off = B * 1000 / on1, B * 1000 / off1
        out["sampling_imgs_per_s"][f"{name}/{dname}"] = {
            "kernels_on": rate_on, "kernels_off": rate_off, "ms": [off1, on1]}
        print(f"time sampling {name} ({r['stats']['params']} params) DDIM-{SAMPLE_TIME_STEPS} "
              f"B={B} {dname}: kernels on {rate_on:.2f} imgs/s ({on1:.1f} ms), "
              f"kernels off {rate_off:.2f} imgs/s ({off1:.1f} ms) {tag}")
    del runs
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"ablation phase {out['seconds']:.1f} s (" + ", ".join(
        f"{k} at {v:.1f} s" for k, v in out["laps_s"].items()) + ")")
    return out


def ae_op_shapes(fs_cfg, res):
    """:func:`op_calls` of one encode and one decode of a ``res`` x ``res``
    image by the first stage ``fs_cfg`` (the generator pass's calls, and the
    discriminator pass's again without grad), on the meta device."""
    import torch

    from diff_pruning_tpu_torch.models.vae import make_first_stage

    meta = torch.device("meta")
    return op_calls(make_first_stage(fs_cfg, device=meta), lambda m: m.decode(m.encode(
        torch.zeros((1, res, res, fs_cfg.in_channels), device=meta))))


def ae_fresh(model, disc, lpips, loss_cfg, masters, mp):
    """Phase 21's models set back to ``masters`` (each of ``model``'s and
    ``disc``'s params), a fresh train state and the step function of
    ``mixed_precision`` ``mp``."""
    import torch

    from diff_pruning_tpu_torch.training import autoencoder as AE

    with torch.no_grad():
        for net, master in zip((model, disc), masters):
            for n, p in net.named_parameters():
                p.copy_(master[n])
    gopt, dopt = AE.make_ae_optimizers(AE_LR)
    st = AE.init_ae_train_state(model, disc, gopt, dopt)
    return st, AE.make_autoencoder_train_step(model, loss_cfg, lpips, disc, gopt, dopt,
                                              mixed_precision=mp)


def ae_step(model, disc, lpips, loss_cfg, masters, x, mp, chosen, replay, on=None):
    """One first-stage train step of phase 21 on ``x`` from :func:`ae_fresh`:
    (metrics, the generator's and the discriminator's Adam first moments
    (0.5 x the step's grads), launches). The VQ lookups are pinned: without
    ``replay`` each call's indices are appended to ``chosen``, with it they
    are taken from there in order, so that runs quantize alike: a near-tie
    flips with f32 summation order, and the decoder's global attention
    spreads one flipped code over the whole image. ``on``: the kernels on
    or off, on again after (None: left on; on the CPU the plain versions
    run)."""
    import torch

    from diff_pruning_tpu_torch import ops

    lookup = model.quantize_latents

    def pinned(z):
        if replay:
            idx = chosen.pop(0).to(z.device)
            return model.quantize.embedding.weight.to(z.dtype)[idx], idx
        zq, idx = lookup(z)
        chosen.append(idx)
        return zq, idx

    if on is not None:
        ops.set_kernels_enabled(on)
    model.quantize_latents = pinned
    try:
        st, step = ae_fresh(model, disc, lpips, loss_cfg, masters, mp)
        ops.reset_launch_counts()
        m = {k: float(v) for k, v in step(st, x).items()}
        if x.is_cuda:
            torch.cuda.synchronize()
        return m, st.gen_opt.mu, st.disc_opt.mu, dict(ops.LAUNCHES)
    finally:
        ops.set_kernels_enabled(True)
        del model.quantize_latents


def check_step_shapes(gn_cases, attn_cases, rows, gen, dev, worst, sfx):
    """Every GroupNorm (N, C, eps, silu) and attention (Nq, Nkv, heads, D) shape
    of ``gn_cases`` and ``attn_cases`` at ``rows`` batch rows against the plain
    versions, f32 and bf16: the forward, its statistics and lse, the backward
    (dx, dscale, dbias; dq, dk, dv) (phases 21 and 24). Raises on a
    disagreement; each op's largest error goes to ``worst`` under
    ``<op>_<sfx>``."""
    import torch

    from diff_pruning_tpu_torch.ops import attention as A
    from diff_pruning_tpu_torch.ops import group_norm as G
    from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
    from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference

    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for (n, c, eps, silu) in sorted(gn_cases):
            x = (torch.randn((rows, n, c), generator=gen, device=dev) * 2 + 0.5).to(dtype)
            dy = torch.randn((rows, n, c), generator=gen, device=dev).to(dtype)
            scale = torch.rand((c,), generator=gen, device=dev) + 0.5
            bias = torch.randn((c,), generator=gen, device=dev) * 0.1
            kw = dict(groups=32, eps=eps, with_silu=silu)
            err, ok = compare(group_norm(x, scale, bias, **kw),
                              group_norm_reference(x, scale, bias, **kw), dname)
            assert ok, (f"{sfx} gn fwd", n, c, silu, dname, err)
            worst[(f"group_norm_{sfx}", dname)] = max(worst[(f"group_norm_{sfx}", dname)], err)
            _, mean, rstd = G.group_norm_forward_with_stats(x, scale, bias, **kw)
            pmean, prstd = G.group_norm_stats_reference(x, 32, eps=eps)
            serr = max(compare_rel(mean, pmean, BWD_TOL["float32"])[0],
                       compare_rel(rstd, prstd, BWD_TOL["float32"])[0])
            assert all(compare_rel(a, w, BWD_TOL["float32"])[1]
                       for a, w in ((mean, pmean), (rstd, prstd))), (f"{sfx} gn stats", n, c)
            got = G.group_norm_backward(x, scale, bias, dy, pmean, prstd, groups=32,
                                        with_silu=silu)
            want = G.group_norm_backward_reference(x, scale, bias, dy, pmean, prstd, groups=32,
                                                   with_silu=silu)
            line = f"fwd {err:.3e}, stats {serr:.3e}"
            for what, a, w in zip(("dx", "dscale", "dbias"), got, want):
                e, ok = compare_rel(a, w, BWD_TOL[dname])
                assert ok, (f"{sfx} gn bwd", n, c, silu, dname, what, e)
                key = (f"group_norm_bwd_{sfx}", dname)
                worst[key] = max(worst[key], e)
                line += f", {what} {e:.3e}"
            print(f"check {sfx} group_norm rows={rows} N={n} C={c} C/g={c // 32} slab "
                  f"{n * c // 32 * NBYTES[dname] // 1024} KB silu={silu} {dname}: {line} (tol "
                  f"{TOL[dname]}, stats and bwd {BWD_TOL['float32']}/{BWD_TOL[dname]} x "
                  "max|want|) ok")
            del x, dy, got, want
        for (nq, nkv, h, d) in sorted(attn_cases):
            def views(n):  # head-split views of (B, N, heads x D), as the layer passes them
                return torch.randn((rows, n, h * d), generator=gen, device=dev).to(dtype) \
                    .view(rows, n, h, d).transpose(1, 2)

            q, k, v, do = views(nq), views(nkv), views(nkv), views(nq)
            scale = d ** -0.5
            errs = {}
            errs["o"], ok = compare(flash_attention(q, k, v, scale),
                                    reference_attention(q, k, v, scale), dname)
            assert ok, (f"{sfx} attention", dname, errs)
            o, lse = A.flash_attention_forward_lse(q, k, v, scale)
            po, plse = A.reference_attention_lse(q, k, v, scale)
            errs["o_lse"], ok = compare(o, po, dname)
            assert ok, (f"{sfx} attention with lse", dname, errs)
            errs["lse"], ok = compare_rel(lse, plse, BWD_TOL["float32"])
            assert ok, (f"{sfx} lse", dname, errs)
            dq, dsum = A.flash_attention_backward_dq(q, k, v, po, do, plse, scale)
            pdq, pdsum = A.attention_backward_dq_reference(q, k, v, po, do, plse, scale)
            dk, dv = A.flash_attention_backward_dkv(q, k, v, do, plse, pdsum, scale)
            pdk, pdv = A.attention_backward_dkv_reference(q, k, v, do, plse, pdsum, scale)
            for what, a, w, tol in (("dsum", dsum, pdsum, BWD_TOL["float32"]),
                                    ("dq", dq, pdq, BWD_TOL[dname]),
                                    ("dk", dk, pdk, BWD_TOL[dname]),
                                    ("dv", dv, pdv, BWD_TOL[dname])):
                errs[what], ok = compare_rel(a, w, tol)
                assert ok, (f"{sfx} attention bwd", dname, what, errs)
            for key, parts in (("attention", ("o", "o_lse")), ("attention_bwd_dq", ("dq", "dsum")),
                               ("attention_bwd_dkv", ("dk", "dv"))):
                worst[(f"{key}_{sfx}", dname)] = max(worst[(f"{key}_{sfx}", dname)],
                                                     *(errs[p_] for p_ in parts))
            print(f"check {sfx} attention rows={rows} Nq={nq} Nkv={nkv} heads={h} D={d} "
                  f"{dname}: "
                  + " ".join(f"{k_}={e:.3e}" for k_, e in errs.items())
                  + f" (tol o {TOL[dname]}, grads {BWD_TOL[dname]} x max|want|, lse and dsum "
                  f"{BWD_TOL['float32']} x max|want|) ok")
            del q, k, v, do, o, po, dq, dk, dv, pdq, pdk, pdv
    torch.cuda.synchronize()


def time_step_ops(gn_shape, attn_shape, rows, gen, dev, tag, label):
    """Per-op ms at a step's headline shapes, f32 and bf16 (phases 21 and 24):
    the GroupNorm forward and backward at ``gn_shape`` (N, C) with SiLU, the
    one-head attention forward with lse, dq and dk/dv at ``attn_shape`` (Nq,
    Nkv, D), each against plain, the library call (F.group_norm and its
    autograd, SDPA and its backward) and the bound, in turns; returns
    ``{dtype: {op: {kernel, plain, library, bound, bound_by, ...}}}``."""
    import torch
    import torch.nn.functional as F

    from diff_pruning_tpu_torch.ops import attention as A
    from diff_pruning_tpu_torch.ops import group_norm as G
    from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference

    (n, c), (nq, nkv, d) = gn_shape, attn_shape
    ops_ms = {}
    for dname in ("float32", "bfloat16"):
        dtype, es = getattr(torch, dname), NBYTES[dname]
        x = (torch.randn((rows, n, c), generator=gen, device=dev) * 2 + 0.5).to(dtype)
        dy = torch.randn((rows, n, c), generator=gen, device=dev).to(dtype)
        sc = torch.rand((c,), generator=gen, device=dev) + 0.5
        bi = torch.randn((c,), generator=gen, device=dev) * 0.1
        kw = dict(groups=32, eps=1e-6, with_silu=True)
        mean, rstd = G.group_norm_stats_reference(x, 32, eps=1e-6)
        # F.group_norm on its own (B, C, N) layout and its autograd (no SiLU:
        # the nearest library call)
        xl = x.transpose(1, 2).contiguous().requires_grad_()
        sl, bl = (z_.to(dtype, copy=True).requires_grad_() for z_ in (sc, bi))
        yl = F.group_norm(xl, 32, sl, bl, eps=1e-6)
        dyl = dy.transpose(1, 2).contiguous()
        fns = [lambda: group_norm_reference(x, sc, bi, **kw), lambda: group_norm(x, sc, bi, **kw),
               lambda: F.group_norm(xl, 32, sl, bl, eps=1e-6),
               lambda: G.group_norm_backward_reference(x, sc, bi, dy, mean, rstd, groups=32,
                                                       with_silu=True),
               lambda: G.group_norm_backward(x, sc, bi, dy, mean, rstd, groups=32,
                                             with_silu=True),
               lambda: torch.autograd.grad(yl, (xl, sl, bl), dyl, retain_graph=True)]
        g_ms = in_turns(fns, iters=3)
        el = rows * n * c
        gfb = bound(2 * el * es + 2 * c * 4, el * 9, dname)
        gbb = bound(*gn_bwd_work(n, c, True, dname, rows=rows), dname)
        del x, dy, xl, yl, dyl, fns

        def views(n_):
            return torch.randn((rows, n_, d), generator=gen, device=dev).to(dtype) \
                .view(rows, n_, 1, d).transpose(1, 2)

        q, k, v, do = views(nq), views(nkv), views(nkv), views(nq)
        scale = d ** -0.5
        o, lse = A.reference_attention_lse(q, k, v, scale)
        _, dsum = A.attention_backward_dq_reference(q, k, v, o, do, lse, scale)
        ql, kl, vl = (z_.detach().clone().requires_grad_() for z_ in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        fns = [lambda: A.reference_attention_lse(q, k, v, scale),
               lambda: A.flash_attention_forward_lse(q, k, v, scale),
               lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
               lambda: A.attention_backward_dq_reference(q, k, v, o, do, lse, scale),
               lambda: A.flash_attention_backward_dq(q, k, v, o, do, lse, scale),
               lambda: A.attention_backward_dkv_reference(q, k, v, do, lse, dsum, scale),
               lambda: A.flash_attention_backward_dkv(q, k, v, do, lse, dsum, scale),
               lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)]
        a_ms = in_turns(fns, iters=3)
        fwd_flops = 4 * rows * nq * nkv * d
        afb = bound(es * rows * (2 * nq + 2 * nkv) * d + 4 * rows * nq, fwd_flops, dname)
        (bq_bytes, fq), (bkv_bytes, fkv) = ldm_bwd_work(rows, nq, nkv, d, es=es)
        dqb, dkvb = bound(bq_bytes, fq, dname), bound(bkv_bytes, fkv, dname)
        backends = (sdpa_backend(fns[2]), sdpa_backend(fns[7]))
        ops_ms[dname] = {
            "gn_shape": [n, c], "attn_shape": [nq, nkv, d],
            "gn_fwd": {"kernel": g_ms[1], "plain": g_ms[0], "library": g_ms[2],
                       "bound": gfb[0], "bound_by": gfb[1]},
            "gn_bwd": {"kernel": g_ms[4], "plain": g_ms[3], "library": g_ms[5],
                       "bound": gbb[0], "bound_by": gbb[1]},
            "attn_fwd": {"kernel": a_ms[1], "plain": a_ms[0], "library": a_ms[2],
                         "bound": afb[0], "bound_by": afb[1],
                         "tflops": fwd_flops / a_ms[1] / 1e9},
            "dq": {"kernel": a_ms[4], "plain": a_ms[3], "bound": dqb[0], "bound_by": dqb[1],
                   "tflops": fq / a_ms[4] / 1e9},
            "dkv": {"kernel": a_ms[6], "plain": a_ms[5], "bound": dkvb[0], "bound_by": dkvb[1],
                    "tflops": fkv / a_ms[6] / 1e9},
            "sdpa_bwd": a_ms[7], "sdpa_backends": list(backends)}
        for what, t in ops_ms[dname].items():
            if isinstance(t, dict):
                print(f"time {label} {what} rows={rows} {dname} at "
                      f"{(n, c) if what.startswith('gn') else (nq, nkv, d)}: kernel "
                      f"{t['kernel']:.4f} ms, plain {t['plain']:.4f}, "
                      + (f"library {t['library']:.4f}, " if "library" in t else "")
                      + f"bound {t['bound']:.4f} ({t['bound_by']})"
                      + (f", {t['tflops']:.2f} TFLOP/s" if "tflops" in t else "") + f" {tag}")
        print(f"time {label} SDPA backward (dq+dk+dv, {backends[1]}) rows={rows} {dname} at "
              f"{(nq, nkv, d)}: {a_ms[7]:.4f} ms {tag}")
        del q, k, v, do, o, ql, kl, vl, ol, fns
    return ops_ms


def ae_train_path(tmp, gen, gpu, tag, worst, ctx):
    """Phase 21 (see the module docstring); returns its figures. ``ctx``:
    ``vq_dir`` (phase 16's model dir: its ``first_stage/`` is vq-f4),
    ``kl_dir`` (phase 19's LSUN-churches dir: kl-f8) and ``data`` (phase
    18's folder of 256 x 256 PNGs)."""
    import shutil

    import torch

    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.cli import autoencoder_train
    from diff_pruning_tpu_torch.eval.lpips import LPIPS, init_lpips_params
    from diff_pruning_tpu_torch.models.discriminator import NLayerDiscriminator
    from diff_pruning_tpu_torch.models.vae import AutoencoderConfig, make_first_stage
    from diff_pruning_tpu_torch.training import autoencoder as AE
    from diff_pruning_tpu_torch.utils.checkpoint import load_params_npz

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    out = {"card": gpu, "b": AE_B, "laps_s": {}}

    def lap(what):
        out["laps_s"][what] = time.perf_counter() - t_phase

    def load_first_stage(model_dir):
        with open(os.path.join(model_dir, "first_stage", "config.json")) as f:
            cfg = AutoencoderConfig.from_json(f.read())
        m = make_first_stage(cfg, device="cpu")
        m.load_state_dict(load_params_npz(os.path.join(model_dir, "first_stage", "params.npz")))
        return cfg, m.to(dev)

    cfg, model = load_first_stage(ctx["vq_dir"])
    rows = AE_B
    per_step = {}
    for name, fcfg in (("vq", cfg), ("kl", load_first_stage(ctx["kl_dir"])[0])):
        gn_c, attn_c = ae_op_shapes(fcfg, AE_RES)
        n_gn, n_attn = sum(gn_c.values()), sum(attn_c.values())
        # the generator pass with grad (GroupNorm and attention forwards that
        # save their statistics, then their backwards), the discriminator
        # pass's reconstruction without
        per_step[name] = {"group_norm": 2 * n_gn, "group_norm_bwd": n_gn,
                          "attention": 2 * n_attn, "attention_lse": n_attn,
                          "attention_bwd_dq": n_attn, "attention_bwd_dkv": n_attn}
        if name == "vq":
            gn_cases, attn_cases = gn_c, attn_c
    print(f"ae train: vq-f4 at {AE_RES} x {AE_RES}, B={rows}: launches a step {per_step['vq']} "
          f"(kl-f8: {per_step['kl']}); GroupNorm shapes {dict(gn_cases)}, attention "
          f"{dict(attn_cases)}")
    assert per_step["vq"] == {"group_norm": 84, "group_norm_bwd": 42, "attention": 4,
                              "attention_lse": 2, "attention_bwd_dq": 2,
                              "attention_bwd_dkv": 2}, per_step

    # (a) every GroupNorm and attention shape of one train step, forward and
    # backward, f32 and bf16, against the plain versions
    check_step_shapes(gn_cases, attn_cases, rows, gen, dev, worst, "ae")
    torch.cuda.synchronize()
    lap("kernels")

    # (b) one train step, kernels on against off, f32 and bf16, from the same
    # state and batch (cuDNN deterministic), every term live (disc_start 0)
    torch.backends.cudnn.deterministic = True
    tgen = torch.Generator(device=dev).manual_seed(21)
    images = torch.rand((rows, AE_RES, AE_RES, 3), generator=tgen, device=dev) * 2 - 1
    disc = NLayerDiscriminator(input_nc=cfg.in_channels, device="cpu").init(
        torch.Generator().manual_seed(1)).to(dev)
    lpips = LPIPS(device="cpu")
    lpips.load_state_dict(init_lpips_params(torch.Generator().manual_seed(7)))
    lpips.to(dev)
    loss_cfg = AE.GANLossConfig(disc_start=0, disc_weight=0.5)
    # a codebook at the latents' scale, where training takes it: at init its
    # codes lie within 1/8192 of 0, ~1e-4 of |z|, and the straight-through
    # value z + (zq - z).detach() then carries zq to only ~1e-3 of itself in
    # f32, so the decoder's input would follow the encoder's last bits
    with torch.no_grad():
        cb = model.quantize.embedding.weight
        cb.copy_(torch.randn(cb.shape, generator=gen, device=dev)
                 * model.encode(images[:2]).std())
    masters = [{n: p.detach().clone() for n, p in net.named_parameters()}
               for net in (model, disc)]

    def fresh(mp):
        return ae_fresh(model, disc, lpips, loss_cfg, masters, mp)

    def one_step(on, mp, chosen, replay, x=images):
        return ae_step(model, disc, lpips, loss_cfg, masters, x, mp, chosen, replay, on=on)

    def codes(on, mp):
        """The step's VQ indices of the batch, kernels on or off."""
        ops.set_kernels_enabled(on)
        try:
            with torch.no_grad():
                cast = {n: p.to(torch.bfloat16 if mp == "bf16" else torch.float32)
                        for n, p in model.named_parameters()}
                return torch.func.functional_call(AE._Codec(model, 0.25), {
                    "model." + n: p for n, p in cast.items()}, (images.to(
                        next(iter(cast.values())).dtype), None))[1]["idx"]
        finally:
            ops.set_kernels_enabled(True)

    # the off run again on images one ulp away (random directions, AE_NUDGES
    # draws): what f32 rounding at the input alone moves, the step's own
    # noise floor, taken as the median of the draws
    up = torch.nextafter(images, torch.full_like(images, 2.0))
    down = torch.nextafter(images, torch.full_like(images, -2.0))
    nudges = [torch.where(torch.rand(images.shape, generator=gen, device=dev) < 0.5, up, down)
              for _ in range(AE_NUDGES)]
    del up, down
    compare_fig = {}
    for mp, dname in (("no", "float32"), ("bf16", "bfloat16")):
        chosen = []
        m_off, gmu_off, dmu_off, c_off = one_step(False, mp, chosen, replay=False)
        nudged = [one_step(False, mp, list(chosen), replay=True, x=x_)[:3] for x_ in nudges]
        fwd_dtypes, unwrap_fwd = record_fwd_dtypes()
        bwd_dtypes, unwrap_bwd = record_bwd_dtypes()
        try:
            m_on, gmu_on, dmu_on, c_on = one_step(True, mp, chosen, replay=True)
        finally:
            unwrap_fwd()
            unwrap_bwd()
        assert not chosen, len(chosen)  # the generator's and the discriminator's lookups
        assert c_on == per_step["vq"] and not any(c_off.values()), (c_on, c_off)
        assert dict(fwd_dtypes) == {
            ("group_norm", f"torch.{dname}"): per_step["vq"]["group_norm"],
            ("attention", f"torch.{dname}"): per_step["vq"]["attention"]}, fwd_dtypes
        assert dict(bwd_dtypes) == {
            ("group_norm_bwd", f"torch.{dname}"): per_step["vq"]["group_norm_bwd"],
            ("attention_bwd", f"torch.{dname}"): per_step["vq"]["attention_bwd_dq"]}, bwd_dtypes
        rtol = TRAIN_LOSS_RTOL if mp == "no" else TRAIN_BF16_LOSS_RTOL
        keys = ("total_loss", "d_weight", "disc_loss")
        rel = {k: abs(m_on[k] - m_off[k]) / max(abs(m_off[k]), 1e-12) for k in keys}
        rel_floor = {k: statistics.median(abs(m[k] - m_off[k]) / max(abs(m_off[k]), 1e-12)
                                          for m, _, _ in nudged) for k in keys}
        cap = AE_GATE_CAP if mp == "no" else math.inf
        allowed = {k: max(rtol, min(NOISE_FACTOR * rel_floor[k], cap)) for k in keys}
        flips = float((codes(True, mp) != codes(False, mp)).float().mean())
        grads, grads_floor, worst_param = {}, {}, {}
        for net, on_, nuds, off_ in (("gen", gmu_on, [g_ for _, g_, _ in nudged], gmu_off),
                                     ("disc", dmu_on, [d_ for _, _, d_ in nudged], dmu_off)):
            assert all(bool(torch.isfinite(t).all()) for t in on_.values()), net
            norm = math.sqrt(sum(float((t ** 2).sum()) for t in off_.values()))

            def dist(a, off_=off_, norm=norm):
                return math.sqrt(sum(float(((a[n] - t) ** 2).sum()) for n, t in off_.items())) \
                    / norm

            grads[net] = dist(on_)
            grads_floor[net] = statistics.median(dist(a) for a in nuds)
            # each param's grads against its max, or against NOISE_FACTOR x the
            # nudged runs' own (median) difference (plus 1e-6 of the largest grad)
            floor = 1e-6 * max(float(t.abs().max()) for t in off_.values())
            worst_param[net] = max((float((on_[n] - t).abs().max()) / (max(
                SWEEP_GRAD_TOL * float(t.abs().max()),
                NOISE_FACTOR * statistics.median(float((a[n] - t).abs().max()) for a in nuds))
                + floor), n) for n, t in off_.items())
        print(f"ae train step vq-f4 B={rows} {dname}, kernels on vs off: "
              + ", ".join(f"{k} {m_on[k]:.7f} against {m_off[k]:.7f} (rel {rel[k]:.3e}; the "
                          f"nudged off runs' median {rel_floor[k]:.3e})" for k in keys)
              + f" (tol max({rtol}, {NOISE_FACTOR} x the median of {AE_NUDGES} nudges"
              + (f", at most {AE_GATE_CAP}" if mp == "no" else "") + "): allowed "
              + ", ".join(f"{k} {allowed[k]:.3e}" for k in keys) + "); the "
              "step's grads (Adam's mu) "
              f"|on - off| / |off|: generator {grads['gen']:.3e} (nudged "
              f"{grads_floor['gen']:.3e}), discriminator {grads['disc']:.3e} (nudged "
              f"{grads_floor['disc']:.3e}); worst param |on - off| over its tolerance: "
              f"generator {worst_param['gen'][0]:.3f} ({worst_param['gen'][1]}), "
              f"discriminator {worst_param['disc'][0]:.3f} ({worst_param['disc'][1]}) (tol "
              + (f"each param within max({SWEEP_GRAD_TOL} of its max, {NOISE_FACTOR} x nudged)"
                 if mp == "no" else f"max({TRAIN_BF16_GRAD_RTOL}, {NOISE_FACTOR} x nudged) in "
                 "norm") + "); the VQ lookups pinned to the off run's (an unpinned encode's "
              f"indices differ on vs off at {flips:.2e} of the rows); launches on {c_on}; "
              f"forward launches by dtype {dict(fwd_dtypes)}, backward calls by dtype "
              f"{dict(bwd_dtypes)}")
        assert all(math.isfinite(m_on[k]) for k in m_on)
        assert all(rel[k] <= allowed[k] for k in keys), (rel, allowed)
        if mp == "no":
            assert max(w for w, _ in worst_param.values()) <= 1.0, worst_param
        else:
            assert all(grads[k] <= max(TRAIN_BF16_GRAD_RTOL, NOISE_FACTOR * grads_floor[k])
                       for k in grads), grads
        compare_fig[dname] = {"metrics_on": m_on, "metrics_off": m_off, "rel": rel,
                              "rel_nudged": rel_floor, "allowed": allowed, "grad_rel": grads,
                              "grad_rel_nudged": grads_floor, "index_flips": flips,
                              "worst_param": {k: list(v) for k, v in worst_param.items()}}
        del gmu_on, gmu_off, dmu_on, dmu_off, nudged
    out["compare"] = compare_fig
    lap("on against off")

    # (c) the main path: the autoencoder_train CLI on phase 16's vq-f4 at
    # full width, B = 12, 256 x 256, every term live; a resume from step 2
    base = ["--model_path", ctx["vq_dir"], "--dataset", ctx["data"], "--resolution",
            str(AE_RES), "--train_batch_size", str(rows), "--lpips", "random", "--disc_start",
            "0", "--log_steps", "1", "--device", "cuda"]
    first, second = os.path.join(tmp, "ae_trained"), os.path.join(tmp, "ae_resumed")
    ops.reset_launch_counts()
    stats, _, cli_seconds = run_cli(autoencoder_train.main, base + [
        "--output_dir", first, "--num_iters", str(AE_STEPS), "--save_model_steps",
        str(AE_SAVE)])
    cli_counts = dict(ops.LAUNCHES)
    want_cli = {k: AE_STEPS * v for k, v in per_step["vq"].items()}
    print(f"main path autoencoder_train CLI: {stats['steps']} steps of B={rows} f32 on vq-f4 "
          f"(losses {stats['losses']}), {stats['imgs_per_sec']:.2f} imgs/s, whole CLI "
          f"{cli_seconds:.2f} s (host clock, load included), saves "
          f"{[round(x, 2) for x in stats['save_seconds']]} s {tag}; launches {cli_counts}")
    assert stats["steps"] == AE_STEPS and all(math.isfinite(x) for x in stats["losses"])
    assert cli_counts == want_cli, (cli_counts, want_cli)
    pair = os.path.join(tmp, "ae_step2")
    for sub in ("gen", "disc"):  # the pair as it stood at step 2
        shutil.copytree(os.path.join(first, "ckpt", sub, f"step-{AE_SAVE}"),
                        os.path.join(pair, sub, f"step-{AE_SAVE}"))
        with open(os.path.join(pair, sub, "LATEST"), "w") as f:
            f.write(f"step-{AE_SAVE}")
    resumed, _, resume_seconds = run_cli(autoencoder_train.main, base + [
        "--output_dir", second, "--num_iters", str(AE_STEPS), "--save_model_steps",
        str(AE_SAVE), "--resume_from_checkpoint", pair])
    last = f"step-{AE_STEPS}"
    identical = {f"{sub}/{name}": npz_equal(os.path.join(first, "ckpt", sub, last, name),
                                            os.path.join(second, "ckpt", sub, last, name))
                 for sub in ("gen", "disc") for name in ("params.npz", "opt_state.npz")}
    print(f"main path autoencoder_train resume from step {AE_SAVE}: losses "
          f"{resumed['losses']}, {resume_seconds:.2f} s; step-{AE_STEPS} bit-identical to the "
          f"uninterrupted run: {identical}")
    assert all(identical.values()) and resumed["losses"] == stats["losses"][AE_SAVE:]
    torch.backends.cudnn.deterministic = False
    tcfg, trained = load_first_stage(first)
    n_trained = sum(p.numel() for p in trained.parameters())
    with torch.no_grad():
        z = trained.encode(images[:2])
        dec = trained.decode(z, force_not_quantize=False)
    print(f"main path check: first_stage/ reloads at {n_trained:,} params; encode {tuple(z.shape)}"
          f", decode {tuple(dec.shape)}, finite {bool(torch.isfinite(dec).all())}")
    assert n_trained == LDM_PARAMS["first_stage"] and tcfg == cfg and bool(torch.isfinite(dec).all())
    del trained, z, dec
    ops.reset_launch_counts()
    bf16_stats, _, bf16_seconds = run_cli(autoencoder_train.main, base + [
        "--output_dir", os.path.join(tmp, "ae_bf16"), "--num_iters", str(AE_STEPS),
        "--save_model_steps", str(AE_STEPS), "--mixed_precision", "bf16"])
    bf16_counts = dict(ops.LAUNCHES)
    print(f"main path autoencoder_train --mixed_precision bf16: losses {bf16_stats['losses']}, "
          f"{bf16_stats['imgs_per_sec']:.2f} imgs/s, {bf16_seconds:.2f} s {tag}; launches "
          f"{bf16_counts}")
    assert all(math.isfinite(x) for x in bf16_stats["losses"]) and bf16_counts == want_cli
    ops.reset_launch_counts()
    kl_stats, _, kl_seconds = run_cli(autoencoder_train.main, [
        "--model_path", ctx["kl_dir"], "--dataset", ctx["data"], "--resolution", str(AE_RES),
        "--train_batch_size", str(rows), "--lpips", "random", "--disc_start", "0",
        "--log_steps", "1", "--num_iters", str(AE_KL_STEPS), "--save_model_steps",
        str(AE_KL_STEPS), "--output_dir", os.path.join(tmp, "ae_kl"), "--device", "cuda"])
    kl_counts = dict(ops.LAUNCHES)
    print(f"main path autoencoder_train on kl-f8: losses {kl_stats['losses']}, kl_loss "
          f"{kl_stats['last']['kl_loss']:.4f}, {kl_stats['imgs_per_sec']:.2f} imgs/s, "
          f"{kl_seconds:.2f} s {tag}; launches {kl_counts}")
    assert all(math.isfinite(x) for x in kl_stats["losses"]) and kl_stats["last"]["kl_loss"] > 0
    assert kl_counts == {k: AE_KL_STEPS * v for k, v in per_step["kl"].items()}, kl_counts
    out.update(per_step=per_step["vq"], per_step_kl=per_step["kl"], cli_launches=cli_counts,
               cli_seconds=cli_seconds, cli_losses=stats["losses"],
               cli_imgs_per_s=stats["imgs_per_sec"], save_seconds=stats["save_seconds"],
               resume_seconds=resume_seconds, resume_identical=identical,
               bf16_cli_losses=bf16_stats["losses"], bf16_cli_imgs_per_s=bf16_stats["imgs_per_sec"],
               kl_cli_losses=kl_stats["losses"], kl_cli_imgs_per_s=kl_stats["imgs_per_sec"])
    lap("CLI")

    # (d) timings: the step, kernels off, on, on, off (one step each, CUDA
    # events), split into its parts; peak memory; a profile by kernel class
    step_ms, profiles = {}, {}
    for mp, dname in (("no", "float32"), ("bf16", "bfloat16")):
        st, step = fresh(mp)

        events = {}

        def mark(what):
            events[what] = torch.cuda.Event(enable_timing=True)
            events[what].record()

        def run(on, step=step, st=st, marks=None):
            ops.set_kernels_enabled(on)
            try:
                if marks:
                    marks("start")
                step(st, images, marks=marks)
            finally:
                ops.set_kernels_enabled(True)

        # (b) ran both precisions both ways: no warm-up; the first "on" turn
        # is also split by the step's marks and read for peak memory
        ms = []
        for i, on in enumerate((False, True)):
            if i == 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
            ms.append(cuda_ms(lambda on=on, i=i: run(on, marks=mark if i == 1 else None),
                              iters=1, warmup=0))
            if i == 1:
                peak = torch.cuda.max_memory_allocated(dev) / 1e9
        off, on = ms
        parts = {"generator_forward_ms": events["start"].elapsed_time(events["d_weight"]),
                 "d_weight_ms": events["d_weight"].elapsed_time(events["gen_backward"]),
                 "generator_backward_adam_ms": events["gen_backward"].elapsed_time(
                     events["disc"]),
                 "discriminator_pass_ms": events["disc"].elapsed_time(events["end"])}
        busy, span, launches, counts, _ = profile_kernels(lambda: run(True))
        print_profile(f"ae train step kernels on B={rows} {dname}", busy, span, launches,
                      counts, ("step", 1), tag)
        profiles[dname] = {"busy_ms": busy, "span_ms": span, "launches": launches,
                           "idle_share": 1 - sum(busy.values()) / span}
        step_ms[dname] = {"kernels_on_ms": on, "kernels_off_ms": off, "turns_ms": ms,
                          "kernels_on_imgs_per_s": rows * 1e3 / on,
                          "kernels_off_imgs_per_s": rows * 1e3 / off, "peak_gb": peak, **parts}
        print(f"time ae train step vq-f4 B={rows} {dname}: kernels on {on:.1f} ms "
              f"({rows * 1e3 / on:.2f} imgs/s), kernels off {off:.1f} ms "
              f"({rows * 1e3 / off:.2f} imgs/s) (CUDA events, one step each, off then on: "
              f"{', '.join(f'{t:.1f}' for t in ms)}); "
              "kernels on: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
              + f"; peak memory {peak:.2f} GB {tag}")
        del st, step
    out.update(train_step=step_ms, profiles=profiles)
    lap("step timings")

    # per op at the step's headline shapes: the GroupNorm forward and backward
    # at (65,536, 128) with SiLU, the attention forward with lse, dq and dk/dv
    # at (4096, 4096, 512), against plain, the library call and the bound
    n, c = 65536, 128
    assert (n, c, 1e-6, True) in gn_cases, sorted(gn_cases)
    nq, nkv, _, d = max(attn_cases)
    ops_ms = time_step_ops((n, c), (nq, nkv, d), rows, gen, dev, tag, "ae")
    out["ops"] = ops_ms
    del model, disc, lpips, images, masters
    lap("op timings")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"ae train phase {out['seconds']:.1f} s (" + ", ".join(
        f"{k} at {v:.1f} s" for k, v in out["laps_s"].items()) + ")")
    return out


def check_fwd_shapes(gn_cases, attn_cases, rows, gen, dev, worst, key, where):
    """The GroupNorm and attention forward kernels against their plain
    versions, f32, at ``rows`` batch rows, at each (N, C, eps, silu) of
    ``gn_cases`` and (Nq, Nkv, heads, D) of ``attn_cases``; the attention
    through head-split views of (rows, N, heads x D) projections, as the
    layers pass them. The largest errors go to ``worst[(op + key, 'float32')]``."""
    import torch

    from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
    from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference

    for nq, nkv, h, d in sorted(attn_cases):
        q, k, v = (torch.randn((rows, n, h * d), generator=gen, device=dev)
                   .view(rows, n, h, d).transpose(1, 2) for n in (nq, nkv, nkv))
        err, ok = compare(flash_attention(q, k, v, d ** -0.5),
                          reference_attention(q, k, v, d ** -0.5), "float32")
        worst[("attention" + key, "float32")] = max(worst[("attention" + key, "float32")], err)
        print(f"check {where} attention rows={rows} heads={h} D={d} Nq={nq} Nkv={nkv} "
              f"(head-split views) float32: max_abs_err={err:.3e} tol={TOL['float32']} "
              f"{'ok' if ok else 'FAIL'}")
        assert ok, (where, nq, nkv, h, d)
        del q, k, v
    for n, c, eps, silu in sorted(gn_cases):
        x = torch.randn((rows, n, c), generator=gen, device=dev) * 2 + 0.5
        scale = torch.rand((c,), generator=gen, device=dev) + 0.5
        bias = torch.randn((c,), generator=gen, device=dev) * 0.1
        kw = dict(groups=32, eps=eps, with_silu=silu)
        err, ok = compare(group_norm(x, scale, bias, **kw),
                          group_norm_reference(x, scale, bias, **kw), "float32")
        worst[("group_norm" + key, "float32")] = max(worst[("group_norm" + key, "float32")], err)
        print(f"check {where} group_norm rows={rows} N={n} C={c} C/g={c // 32} slab "
              f"{n * c // 32 * 4 / 1024:.0f} KB eps={eps} silu={silu} float32: "
              f"max_abs_err={err:.3e} tol={TOL['float32']} {'ok' if ok else 'FAIL'}")
        assert ok, (where, n, c, eps, silu)
        del x
    torch.cuda.synchronize()


def calls_of(counter_pair):
    """{'group_norm': calls, 'attention': calls} of a (GroupNorm, attention)
    pair of :func:`op_calls` counters."""
    gn, attn = counter_pair
    return {"group_norm": sum(gn.values()), "attention": sum(attn.values())}


def text_op_shapes():
    """:func:`op_calls` (meta device, B = 1) of one UNet call, encode and
    decode of each model of phase 22, at the CLIs' latent sizes: txt2img's
    UNet with the 77-token context, its BERT encode, the kl-f8 decode;
    inpainting_big's UNet, the vq-f4-noattn encode of a 256 x 256 image and
    decode; rdm768's UNet with a context of 1 and of 1 + TEXT_KNN embeddings,
    the kl-f16 decode."""
    import torch

    from diff_pruning_tpu_torch.models.text_encoder import BERTEmbedder, bert_txt2img_config
    from diff_pruning_tpu_torch.models.unet_cond import (inpainting_big_config, rdm768_config,
                                                         txt2img_1p4B_config)
    from diff_pruning_tpu_torch.models.vae import first_stage_config

    bcfg = bert_txt2img_config()
    out = {"bert": op_calls(BERTEmbedder(bcfg, device="meta"), lambda m: m(
        torch.zeros((1, bcfg.max_seq_len), dtype=torch.int64, device="meta")))}
    out["txt2img_unet"], out["kl_f8_decode"] = ldm_op_shapes(
        txt2img_1p4B_config(), first_stage_config("kl-f8"), nkv=bcfg.max_seq_len)
    out["inpaint_unet"], out["vq_f4_noattn_decode"], out["vq_f4_noattn_encode"] = ldm_op_shapes(
        inpainting_big_config(), first_stage_config("vq-f4-noattn"), encode=True)
    out["rdm768_unet_nkv1"], _ = ldm_op_shapes(rdm768_config(), first_stage_config("kl-f16"))
    out["rdm768_unet"], out["kl_f16_decode"] = ldm_op_shapes(
        rdm768_config(), first_stage_config("kl-f16"), nkv=1 + TEXT_KNN)
    return out


def text_ldm_path(tmp, gen, gpu, tag, worst, others_fwd):
    """Phase 22 (see the module docstring); returns the phase's figures."""
    import numpy as np
    import torch
    from PIL import Image

    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.cli import inpaint, knn2img, train_searcher, txt2img
    from diff_pruning_tpu_torch.data.procedural import make_procedural_dataset
    from diff_pruning_tpu_torch.data.tokenizer import BERTTokenizer
    from diff_pruning_tpu_torch.models.latent_diffusion import (
        IdentityCondStage, LatentDiffusion, ldm_schedule, make_concat_sampler)
    from diff_pruning_tpu_torch.models.text_encoder import BERTEmbedder, bert_txt2img_config
    from diff_pruning_tpu_torch.models.unet_cond import (UNetCond, inpainting_big_config,
                                                         rdm768_config, txt2img_1p4B_config)
    from diff_pruning_tpu_torch.models.vae import (AutoencoderKL, first_stage_config,
                                                   make_first_stage)
    from diff_pruning_tpu_torch.utils.checkpoint import save_ldm, save_model

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    out = {"card": gpu, "laps_s": {}, "cli": {}, "ops": {}, "timing": {}}

    def lap(what):
        out["laps_s"][what] = time.perf_counter() - t_phase

    shapes = text_op_shapes()
    per = {name: calls_of(pair) for name, pair in shapes.items()}
    out["per_call"] = per
    out["attention_shapes"] = {name: sorted(str(s_) for s_ in pair[1])
                               for name, pair in shapes.items() if pair[1]}
    print("text ldm calls a forward: " + "; ".join(
        f"{name} {c['group_norm']} GroupNorm, {c['attention']} attention "
        f"{dict(shapes[name][1]) if shapes[name][1] else ''}" for name, c in per.items()))
    assert per["txt2img_unet"]["attention"] == 32 and per["bert"] == {
        "group_norm": 0, "attention": 32}, per

    # -- txt2img-1p4B: a seeded model dir (unet/, cond_stage/, first_stage/ kl-f8)
    g = torch.Generator(device=dev).manual_seed(30)
    ldm = LatentDiffusion(txt2img_1p4B_config(), device=dev,
                          cond_stage=BERTEmbedder(bert_txt2img_config(), device=dev),
                          first_stage=AutoencoderKL(first_stage_config("kl-f8"), device=dev),
                          linear_start=0.00085, linear_end=0.012, scale_factor=0.18215)
    ldm.init(g)
    nudged = redraw_zero_init(ldm.unet, g)
    counts = {part: sum(p.numel() for p in getattr(ldm, part).parameters())
              for part in ("unet", "cond_stage", "first_stage")}
    t2i_dir = os.path.join(tmp, "txt2img")
    t0 = time.perf_counter()
    save_ldm(t2i_dir, ldm)
    t_save = time.perf_counter() - t0
    vocab = os.path.join(tmp, "bert_vocab.txt")
    words = TEXT_PROMPT.split()
    with open(vocab, "w") as f:  # bert-base-uncased's size, the prompt's words in it
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + [
            f"tok{i}" for i in range(TEXT_VOCAB - 5 - len(words))]) + "\n")
    tok = BERTTokenizer(vocab)
    print(f"text ldm txt2img-1p4B: UNetCond {counts['unet']:,}, BERTEmbedder "
          f"{counts['cond_stage']:,}, kl-f8 {counts['first_stage']:,} params "
          f"({sum(counts.values()):,}); {nudged} zero-initialised convs redrawn; save_ldm "
          f"{t_save:.1f} s; vocab {tok.vocab_size} entries")
    assert counts == TEXT_PARAMS["txt2img"] and tok.vocab_size == TEXT_VOCAB, counts
    out["txt2img"] = {"params": counts, "save_s": t_save}
    lap("txt2img model dir")

    # (a) every kernel shape of a UNet call (8 rows), the BERT encode (4) and
    # the kl-f8 decode (4) against the plain versions
    rows_t = 2 * TEXT_B
    for name, rows in (("txt2img_unet", rows_t), ("bert", TEXT_B), ("kl_f8_decode", TEXT_B)):
        check_fwd_shapes(*shapes[name], rows, gen, dev, worst, "_text", name)

    # (b) one DDIM-20 CFG trajectory kernels on against off, from one x_T
    tokens = torch.as_tensor(np.repeat(tok([TEXT_PROMPT]), TEXT_B, axis=0), device=dev)
    sampler = ldm.make_cfg_sampler(ddim_steps=TEXT_STEPS, guidance_scale=TEXT_SCALE,
                                   latent_hw=32, latent_ch=4, uncond_input=tok([""]))
    x_T = torch.randn((TEXT_B, 32, 32, 4), generator=gen, device=dev)
    runs = {}
    for on in (True, False):
        ops.reset_launch_counts()
        lat = switched(on, lambda: sampler(None, tokens, TEXT_B, x_T=x_T))
        torch.cuda.synchronize()
        runs[on] = (lat, dict(ops.LAUNCHES))
    (lat_on, c_on), (lat_off, c_off) = runs[True], runs[False]
    lat_err, lat_ok = compare_rel(lat_on, lat_off, LDM_REL_TOL)
    img_on, img_off = (switched(on, lambda: ldm.decode_first_stage(lat_off))
                       for on in (True, False))
    img_err, img_ok = compare_rel(img_on, img_off, LDM_REL_TOL)
    print(f"text ldm txt2img CFG DDIM-{TEXT_STEPS} scale {TEXT_SCALE} B={TEXT_B}, kernels on vs "
          f"off from one x_T and the same tokens: latents max abs err {lat_err:.3e} (tol "
          f"{LDM_REL_TOL} x max {float(lat_off.abs().max()):.3f}), the kl-f8 decode of the same "
          f"latents {img_err:.3e} (tol {LDM_REL_TOL} x max); launches on {c_on}, off {c_off}")
    assert lat_ok and img_ok, (lat_err, img_err)
    want = {op: TEXT_STEPS * per["txt2img_unet"][op] + 2 * per["bert"][op]
            for op in ("group_norm", "attention")}
    assert {k: c_on[k] for k in want} == want and not any(c_off.values()), (c_on, want)
    out["txt2img"]["on_off"] = {"latent_max_abs_err": lat_err, "image_max_abs_err": img_err,
                                "launches": c_on}
    del runs, lat_on, lat_off, img_on, img_off
    lap("txt2img checks")

    # (d) timings: a UNet call at the CLI's 8 rows and a BERT encode at 4,
    # kernels off and on in turns; DDIM-20 + decode at B = 4, one batch off,
    # one on; per-op ms; a profile of the UNet call
    xr = torch.randn((rows_t, 32, 32, 4), generator=gen, device=dev)
    tb = torch.full((rows_t,), 501, device=dev)
    with torch.inference_mode():
        ctx = ldm.get_learned_conditioning(torch.cat([tokens, tokens]))

    def t2i_unet(on):
        with torch.inference_mode():
            return switched(on, lambda: ldm.apply_unet(xr, tb, ctx))

    def bert(on):
        with torch.inference_mode():
            return switched(on, lambda: ldm.get_learned_conditioning(tokens))

    timing = out["timing"]
    for what, fn in (("txt2img_unet_call_ms", t2i_unet), ("bert_encode_ms", bert)):
        off, on = turns(fn)
        timing[what] = {"kernels_on": on, "kernels_off": off}
    warm = ldm.make_cfg_sampler(ddim_steps=2, guidance_scale=TEXT_SCALE, latent_hw=32,
                                latent_ch=4, uncond_input=tok([""]))
    for on in (False, True):
        switched(on, lambda: ldm.decode_first_stage(warm(gen, tokens, TEXT_B)))
    off, on = (cuda_ms(lambda: switched(on_, lambda: ldm.decode_first_stage(
        sampler(gen, tokens, TEXT_B))), iters=1, warmup=0) for on_ in (False, True))
    timing["txt2img_imgs_per_s"] = {"kernels_on": TEXT_B * 1e3 / on,
                                    "kernels_off": TEXT_B * 1e3 / off}
    timing["txt2img_batch_ms"] = {"on": on, "off": off}
    print(f"time text ldm txt2img UNet call rows={rows_t} float32: kernels on "
          f"{timing['txt2img_unet_call_ms']['kernels_on']:.2f} ms, off "
          f"{timing['txt2img_unet_call_ms']['kernels_off']:.2f} ms; BERT encode rows={TEXT_B}: "
          f"on {timing['bert_encode_ms']['kernels_on']:.2f} ms, off "
          f"{timing['bert_encode_ms']['kernels_off']:.2f} ms (CUDA events, in turns "
          f"off-on-on-off); CFG DDIM-{TEXT_STEPS} + decode B={TEXT_B}: kernels on "
          f"{TEXT_B * 1e3 / on:.3f} imgs/s ({on:.0f} ms), off {TEXT_B * 1e3 / off:.3f} "
          f"({off:.0f} ms) (one batch each, off then on) {tag}")
    busy, span, launches, kcounts, _ = profile_kernels(lambda: t2i_unet(True))
    print_profile(f"text ldm txt2img one UNet call kernels on rows={rows_t} float32", busy, span,
                  launches, kcounts, ("UNet call", 1), tag)
    out["txt2img"]["profile_unet_call"] = {"busy_ms": busy, "span_ms": span,
                                           "launches": launches,
                                           "idle_share": 1 - sum(busy.values()) / span}
    out["ops"]["txt2img_unet_call"] = time_ldm_ops(*shapes["txt2img_unet"], rows_t, gen, dev, tag,
                                                   "txt2img UNet call", others_fwd)
    out["ops"]["bert_encode"] = time_ldm_ops({}, shapes["bert"][1], TEXT_B, gen, dev, tag,
                                             "BERT encode", others_fwd)
    del ldm, sampler, warm, xr, ctx
    torch.cuda.empty_cache()
    lap("txt2img timings")

    # (c) the main path: the txt2img CLI on the dir, DDIM-10, then PLMS-5
    for method, steps in (("ddim", TEXT_STEPS), ("plms", TEXT_PLMS_STEPS)):
        odir = os.path.join(tmp, f"txt2img_{method}")
        argv = ["--model_path", t2i_dir, "--vocab", vocab, "--outdir", odir, "--ddim_steps",
                str(steps), "--device", "cuda"] + (["--plms"] if method == "plms" else [])
        ops.reset_launch_counts()
        stats, _, seconds = run_cli(txt2img.main, argv)
        launches = dict(ops.LAUNCHES)
        calls = steps + (method == "plms")
        want = {op: calls * per["txt2img_unet"][op] + 2 * per["bert"][op]
                + per["kl_f8_decode"][op] for op in ("group_norm", "attention")}
        pngs = sorted(os.listdir(os.path.join(odir, "samples")))
        size = Image.open(os.path.join(odir, "samples", pngs[0])).size
        print(f"txt2img CLI --{method} {steps} steps, n_samples {TEXT_B}, 256 x 256, scale "
              f"{TEXT_SCALE}: {len(pngs)} PNGs of {size} + grid.png, {seconds:.1f} s wall (load "
              f"included), sampling {stats['imgs_per_s']:.3f} imgs/s {tag}; launches {launches}")
        assert pngs == [f"{i:06d}.png" for i in range(TEXT_B)] and size == (256, 256), pngs
        assert os.path.exists(os.path.join(odir, "grid.png")) and stats["nonfinite"] == 0
        assert stats["params"] == TEXT_PARAMS["txt2img"], stats["params"]
        assert {k: launches[k] for k in want} == want, (launches, want)
        assert launches["attention_lse"] == launches["group_norm_bwd"] == 0, launches
        out["cli"][f"txt2img_{method}"] = {"seconds": seconds, "imgs_per_s": stats["imgs_per_s"],
                                           "launches": launches, "steps": steps}
    lap("txt2img CLI")

    # -- inpainting_big + vq-f4-noattn: a seeded model dir and 4 image/mask pairs
    g = torch.Generator(device=dev).manual_seed(31)
    icfg, ifcfg = inpainting_big_config(), first_stage_config("vq-f4-noattn")
    unet = UNetCond(icfg, device=dev).init(g)
    fs = make_first_stage(ifcfg, device=dev).init(g)
    nudged = redraw_zero_init(unet, g)
    i_dir = os.path.join(tmp, "inpaint")
    t0 = time.perf_counter()
    save_model(i_dir, icfg, unet, subfolder="unet")
    save_model(i_dir, ifcfg, fs, subfolder="first_stage")
    t_save = time.perf_counter() - t0
    counts = (sum(p.numel() for p in unet.parameters()), sum(p.numel() for p in fs.parameters()))
    print(f"text ldm inpainting_big: UNetCond {counts[0]:,}, vq-f4-noattn {counts[1]:,} params "
          f"({sum(counts):,}); {nudged} zero-initialised convs redrawn; saved in {t_save:.1f} s")
    assert counts == TEXT_PARAMS["inpaint"], counts
    out["inpaint"] = {"params": counts, "save_s": t_save}
    indir = os.path.join(tmp, "inpaint_in")
    os.makedirs(indir)
    for i, img in enumerate(make_procedural_dataset(TEXT_INPAINT_PAIRS, 256, seed=31)):
        Image.fromarray(img).save(os.path.join(indir, f"{i:03d}.png"))
        mask = np.zeros((256, 256), np.uint8)
        mask[32 + 16 * i:160 + 16 * i, 64:192] = 255
        Image.fromarray(mask, "L").save(os.path.join(indir, f"{i:03d}_mask.png"))
    for name, rows in (("inpaint_unet", TEXT_INPAINT_B), ("vq_f4_noattn_encode", TEXT_INPAINT_B),
                       ("vq_f4_noattn_decode", TEXT_INPAINT_B)):
        check_fwd_shapes(*shapes[name], rows, gen, dev, worst, "_text", name)
    xr = torch.randn((TEXT_INPAINT_B, 64, 64, 7), generator=gen, device=dev)
    tb = torch.full((TEXT_INPAINT_B,), 501, device=dev)

    def inpaint_unet(on):
        with torch.inference_mode():
            return switched(on, lambda: unet(xr, tb))

    sample = make_concat_sampler(unet, ldm_schedule(linear_end=0.0205, device=dev),
                                 ddim_steps=TEXT_STEPS, latent_ch=3)
    cond = torch.randn((TEXT_INPAINT_B, 64, 64, 4), generator=gen, device=dev)

    def inpaint_batch():
        with torch.inference_mode():
            return fs.decode(sample(gen, cond), force_not_quantize=False)

    off, on = turns(inpaint_unet)
    timing["inpaint_unet_call_ms"] = {"kernels_on": on, "kernels_off": off}
    off_b, on_b = (cuda_ms(lambda: switched(on_, inpaint_batch), iters=1, warmup=0)
                   for on_ in (False, True))
    timing["inpaint_imgs_per_s"] = {"kernels_on": TEXT_INPAINT_B * 1e3 / on_b,
                                    "kernels_off": TEXT_INPAINT_B * 1e3 / off_b}
    print(f"time text ldm inpainting_big UNet call rows={TEXT_INPAINT_B} float32: kernels on "
          f"{on:.2f} ms, off {off:.2f} ms (in turns off-on-on-off); DDIM-{TEXT_STEPS} + the VQ "
          f"decode B={TEXT_INPAINT_B}: kernels on {TEXT_INPAINT_B * 1e3 / on_b:.3f} imgs/s "
          f"({on_b:.0f} ms), off {TEXT_INPAINT_B * 1e3 / off_b:.3f} ({off_b:.0f} ms) (one "
          f"batch each, off then on) {tag}")
    out["ops"]["inpaint_unet_call"] = time_ldm_ops(*shapes["inpaint_unet"], TEXT_INPAINT_B, gen,
                                                   dev, tag, "inpainting_big UNet call",
                                                   others_fwd)
    del unet, fs, sample, xr, cond
    torch.cuda.empty_cache()
    lap("inpaint model dir, checks, timings")
    odir = os.path.join(tmp, "inpaint_out")
    ops.reset_launch_counts()
    stats, _, seconds = run_cli(inpaint.main, [
        "--indir", indir, "--outdir", odir, "--model_path", i_dir, "--steps", str(TEXT_STEPS),
        "--batch_size", str(TEXT_INPAINT_B), "--device", "cuda"])
    launches = dict(ops.LAUNCHES)
    batches = TEXT_INPAINT_PAIRS // TEXT_INPAINT_B
    want = {op: batches * (per["vq_f4_noattn_encode"][op] + TEXT_STEPS * per["inpaint_unet"][op]
                           + per["vq_f4_noattn_decode"][op]) for op in ("group_norm", "attention")}
    pngs = sorted(os.listdir(odir))
    size = Image.open(os.path.join(odir, pngs[0])).size
    print(f"inpaint CLI --steps {TEXT_STEPS} --batch_size {TEXT_INPAINT_B}, {TEXT_INPAINT_PAIRS} "
          f"pairs of 256 x 256: {len(pngs)} PNGs of {size}, {seconds:.1f} s wall (load "
          f"included), {stats['imgs_per_s']:.3f} imgs/s {tag}; launches {launches}")
    assert pngs == [f"{i:03d}.png" for i in range(TEXT_INPAINT_PAIRS)] and size == (256, 256)
    assert stats["nonfinite"] == 0 and (stats["unet_params"], stats["first_stage_params"]) == \
        TEXT_PARAMS["inpaint"], stats
    assert {k: launches[k] for k in want} == want, (launches, want)
    out["cli"]["inpaint"] = {"seconds": seconds, "imgs_per_s": stats["imgs_per_s"],
                             "launches": launches}
    lap("inpaint CLI")


    # -- rdm768 + kl-f16: a seeded model dir; CLIP ViT-L/14 is the CLIs' random init
    g = torch.Generator(device=dev).manual_seed(32)
    kcfg, kfcfg = rdm768_config(), first_stage_config("kl-f16")
    kldm = LatentDiffusion(kcfg, cond_stage=IdentityCondStage(), device=dev,
                           first_stage=make_first_stage(kfcfg, device=dev),
                           scale_factor=0.22765929, linear_end=0.015)
    kldm.init(g)
    nudged = redraw_zero_init(kldm.unet, g)
    k_dir = os.path.join(tmp, "rdm768")
    t0 = time.perf_counter()
    save_model(k_dir, kcfg, kldm.unet, subfolder="unet")
    save_model(k_dir, kfcfg, kldm.first_stage, subfolder="first_stage")
    t_save = time.perf_counter() - t0
    counts = tuple(sum(p.numel() for p in m.parameters()) for m in (kldm.unet, kldm.first_stage))
    print(f"text ldm rdm768: UNetCond {counts[0]:,}, kl-f16 {counts[1]:,} params; {nudged} "
          f"zero-initialised convs redrawn; saved in {t_save:.1f} s")
    assert counts == TEXT_PARAMS["knn"], counts
    out["knn"] = {"params": counts, "save_s": t_save}
    rows_k = 2 * TEXT_KNN_B
    for name, rows in (("rdm768_unet_nkv1", rows_k), ("rdm768_unet", rows_k),
                       ("kl_f16_decode", TEXT_KNN_B)):
        check_fwd_shapes(*shapes[name], rows, gen, dev, worst, "_text", name)
    hw = kcfg.image_size
    xr = torch.randn((rows_k, hw, hw, 16), generator=gen, device=dev)
    tb = torch.full((rows_k,), 501, device=dev)
    ctx = torch.nn.functional.normalize(
        torch.randn((rows_k, 1 + TEXT_KNN, kcfg.context_dim), generator=gen, device=dev), dim=-1)

    def rdm_unet(on):
        with torch.inference_mode():
            return switched(on, lambda: kldm.apply_unet(xr, tb, ctx))

    ksample = kldm.make_cfg_sampler(
        ddim_steps=TEXT_KNN_STEPS, guidance_scale=TEXT_SCALE, latent_hw=hw, latent_ch=16,
        uncond_input=np.zeros((1, 1 + TEXT_KNN, kcfg.context_dim), np.float32))

    def knn_batch():
        return kldm.decode_first_stage(ksample(gen, ctx[:TEXT_KNN_B], TEXT_KNN_B))

    off, on = turns(rdm_unet)
    timing["rdm768_unet_call_ms"] = {"kernels_on": on, "kernels_off": off}
    off_b, on_b = (cuda_ms(lambda: switched(on_, knn_batch), iters=1, warmup=0)
                   for on_ in (False, True))
    timing["knn2img_imgs_per_s"] = {"kernels_on": TEXT_KNN_B * 1e3 / on_b,
                                    "kernels_off": TEXT_KNN_B * 1e3 / off_b}
    print(f"time text ldm rdm768 UNet call rows={rows_k} Nkv={1 + TEXT_KNN} float32: kernels on "
          f"{on:.2f} ms, off {off:.2f} ms (in turns off-on-on-off); CFG DDIM-{TEXT_KNN_STEPS} + "
          f"the kl-f16 decode B={TEXT_KNN_B} at 768 x 768: kernels on "
          f"{TEXT_KNN_B * 1e3 / on_b:.3f} imgs/s ({on_b:.0f} ms), off "
          f"{TEXT_KNN_B * 1e3 / off_b:.3f} ({off_b:.0f} ms) (one batch each, off then on) {tag}")
    out["ops"]["rdm768_unet_call"] = time_ldm_ops(*shapes["rdm768_unet"], rows_k, gen, dev, tag,
                                                  "rdm768 UNet call", others_fwd)
    del kldm, ksample, xr, ctx
    torch.cuda.empty_cache()
    lap("rdm768 model dir, checks, timings")

    # the main path: train_searcher over phase 18's PNGs (CLIP only: no kernel
    # of the port), then knn2img with the 10 nearest neighbours
    sdir, images = os.path.join(tmp, "searcher"), os.path.join(tmp, "ldm_train_data", "class_000")
    ops.reset_launch_counts()
    stats, _, seconds = run_cli(train_searcher.main, [
        "--images", images, "--clip_path", "random", "--target_path", sdir, "--device", "cuda"])
    launches = dict(ops.LAUNCHES)
    with np.load(os.path.join(sdir, "database.npz")) as z:
        emb = z["embedding"]
    n_images = len([f for f in os.listdir(images) if f.endswith(".png")])
    print(f"train_searcher CLI --clip_path random (ViT-L/14), {n_images} PNGs: database "
          f"{emb.shape}, {seconds:.1f} s wall (CLIP init included) {tag}; launches {launches}")
    assert emb.shape == (n_images, 768) and bool(np.isfinite(emb).all()), emb.shape
    assert stats["entries"] == n_images and not any(launches.values()), launches
    out["cli"]["train_searcher"] = {"seconds": seconds, "entries": n_images}
    bpe = os.path.join(tmp, "clip_merges.txt")
    with open(bpe, "w") as f:
        f.write("#version: 0.2\n" + "\n".join(
            ["h e</w>", "l l", "t h", "th e</w>", "a n", "an d</w>", "i n", "in g</w>"]) + "\n")
    odir = os.path.join(tmp, "knn2img_out")
    ops.reset_launch_counts()
    stats, _, seconds = run_cli(knn2img.main, [
        "--prompt", TEXT_PROMPT, "--outdir", odir, "--model_path", k_dir, "--bpe", bpe,
        "--clip_path", "random", "--database", sdir, "--use_neighbors", "--knn", str(TEXT_KNN),
        "--ddim_steps", str(TEXT_KNN_STEPS), "--n_samples", str(TEXT_KNN_B), "--device", "cuda"])
    launches = dict(ops.LAUNCHES)
    want = {op: TEXT_KNN_STEPS * per["rdm768_unet"][op] + per["kl_f16_decode"][op]
            for op in ("group_norm", "attention")}
    pngs = sorted(os.listdir(os.path.join(odir, "samples")))
    size = Image.open(os.path.join(odir, "samples", pngs[0])).size
    grid = Image.open(os.path.join(odir, "grid-0000.png")).size
    print(f"knn2img CLI --use_neighbors --knn {TEXT_KNN} --ddim_steps {TEXT_KNN_STEPS}, "
          f"n_samples {TEXT_KNN_B}, 768 x 768: {len(pngs)} PNGs of {size}, grid {grid}, "
          f"{seconds:.1f} s wall (load and CLIP init included), "
          f"{stats['imgs_per_s']:.3f} imgs/s {tag}; launches {launches}")
    assert pngs == [f"{i:05d}.png" for i in range(TEXT_KNN_B)] and size == (768, 768), pngs
    assert grid == (768 * TEXT_KNN_B, 768) and stats["nonfinite"] == 0, grid
    assert (stats["unet_params"], stats["first_stage_params"]) == TEXT_PARAMS["knn"], stats
    assert stats["clip_params"] == TEXT_PARAMS["clip"], stats
    assert {k: launches[k] for k in want} == want, (launches, want)
    out["cli"]["knn2img"] = {"seconds": seconds, "imgs_per_s": stats["imgs_per_s"],
                             "launches": launches}
    lap("train_searcher and knn2img CLIs")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"text ldm phase {out['seconds']:.1f} s ("
          + ", ".join(f"{k} at {v:.1f} s" for k, v in out["laps_s"].items()) + ")")
    return out


def lsun_path(tmp, gen, gpu, tag, worst):
    """Phase 24 (see the module docstring); returns the phase's figures."""
    import numpy as np
    import torch
    from PIL import Image

    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.cli import (convert_checkpoints, ddpm_prune, ddpm_sample,
                                            ddpm_train, make_lsun_lmdb)
    from diff_pruning_tpu_torch.cli.ddpm_prune import load_unet
    from diff_pruning_tpu_torch.data.datasets import get_dataset
    from diff_pruning_tpu_torch.data.procedural import make_procedural_dataset
    from diff_pruning_tpu_torch.models.unet2d import UNet2D, ddpm_lsun256_config
    from diff_pruning_tpu_torch.utils.checkpoint import load_model, save_model

    t_phase = time.perf_counter()
    dev, meta = torch.device("cuda", 0), torch.device("meta")
    torch.cuda.synchronize(dev)  # the context exists before the peak-memory reads
    out = {"card": gpu, "b": LSUN_B, "laps_s": {}}

    def lap(what):
        out["laps_s"][what] = time.perf_counter() - t_phase

    def shapes(c):
        return op_calls(UNet2D(c, device=meta), lambda m: m(
            torch.zeros((1, 256, 256, 3), device=meta), torch.zeros((1,), dtype=torch.int64,
                                                                     device=meta)))

    def same_state(a, b):
        return sorted(a) == sorted(b) and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)

    # (a) the seeded full-width UNet, exported as a diffusers directory by the
    # CLI; the dense UNet loaded from it is bit-identical
    cfg = ddpm_lsun256_config()
    dense = UNet2D(cfg, device="cpu").init(torch.Generator().manual_seed(24))
    n_dense = sum(p.numel() for p in dense.parameters())
    src_dir, hf_dir = os.path.join(tmp, "lsun_dense"), os.path.join(tmp, "lsun_hf")
    save_model(src_dir, cfg, dense)
    convert_checkpoints.main(["export-diffusers", src_dir, hf_dir])
    hf_cfg, back = load_unet(hf_dir)
    identical = same_state(back, dense.state_dict()) and hf_cfg == cfg
    st_mb = os.path.getsize(os.path.join(hf_dir, "unet", "diffusion_pytorch_model.safetensors"))
    print(f"lsun: ddpm_lsun256 UNet {n_dense:,} params (seed 24), exported by convert_checkpoints "
          f"export-diffusers ({st_mb / 2**20:.1f} MiB of safetensors); loaded back bit-identical: "
          f"{identical}")
    assert n_dense == LSUN_PARAMS and identical
    del dense, back
    lap("export")

    # (b) an LSUN-layout lmdb written by make_lsun_lmdb (lossless WEBP under
    # the md5 of each path) from procedural 256 x 256 images
    folder, lmdb = os.path.join(tmp, "lsun_images"), os.path.join(tmp, "lsun_lmdb")
    os.makedirs(folder)
    images = make_procedural_dataset(LSUN_IMAGES, 256, seed=24)
    for i, img in enumerate(images):
        Image.fromarray(img).save(os.path.join(folder, f"{i:03d}.png"))
    made = make_lsun_lmdb.main(["--src", folder, "--out", lmdb])
    ds = get_dataset("lsun:" + lmdb, 256)
    by_key = {hashlib.md5(os.path.join(folder, f"{i:03d}.png").encode()).hexdigest().encode(): i
              for i in range(LSUN_IMAGES)}
    lossless = all(np.array_equal(ds.load(j), images[by_key[key]]) for j, key in enumerate(ds.keys))
    print(f"lsun: make_lsun_lmdb wrote {made['entries']} entries "
          f"({os.path.getsize(made['path']) / 2**20:.1f} MiB); lsun: source of {len(ds)} images, "
          f"each decoded equal to its PNG: {lossless}")
    assert made["entries"] == len(ds) == LSUN_IMAGES and lossless
    lap("lmdb")

    # (c) the main path: the prune CLI on the diffusers dir over lsun: (the
    # f32 sweep: GroupNorm at 256 x 256 slabs, attention at (256, 256, 512))
    gn_d, at_d = shapes(cfg)
    per_call = (sum(gn_d.values()), sum(at_d.values()))
    pruned_dir, train_dir = os.path.join(tmp, "lsun_pruned"), os.path.join(tmp, "lsun_finetuned")
    common = ["--dataset", "lsun:" + lmdb, "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    stats, _, prune_s = run_cli(ddpm_prune.main, common + [
        "--model_path", hf_dir, "--save_path", pruned_dir, "--pruning_ratio", "0.3",
        "--batch_size", str(LSUN_B), "--pruner", "diff-pruning", "--thr", str(LSUN_THR),
        "--max_steps", str(LSUN_PRUNE_STEPS), "--skip_vis"])
    prune_counts = dict(ops.LAUNCHES)
    prune_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    steps = stats["steps_run"]
    pcfg, pstate = load_model(pruned_dir)
    n_pruned = sum(int(v.numel()) for v in pstate.values())
    print(f"main path lsun prune CLI: {stats['params_before']:,} -> {n_pruned:,} params, "
          f"{stats['macs_before'] / 1e9:.2f}G -> {stats['macs'] / 1e9:.2f}G MACs, sweep {steps} "
          f"steps of B={LSUN_B} f32 in {stats['sweep_seconds']:.2f} s (host clock, "
          f"{stats['sweep_seconds'] / max(steps, 1) * 1e3:.0f} ms a step with the first's "
          f"set-up), whole CLI {prune_s:.2f} s, peak memory {prune_peak:.2f} GB {tag}; launches "
          f"{prune_counts}")
    assert 1 <= steps <= LSUN_PRUNE_STEPS and prune_counts == unet_launches(per_call, steps), \
        (prune_counts, per_call, steps)
    assert n_pruned == stats["params"] < n_dense and pcfg.channel_sizes == stats["channel_sizes"]
    out["prune_cli"] = {"params": n_pruned, "macs": stats["macs"], "steps": steps,
                        "sweep_s": stats["sweep_seconds"], "seconds": prune_s,
                        "peak_gb": prune_peak, "launches": prune_counts}
    lap("prune CLI")

    # (d) every GroupNorm and attention shape of the dense and the pruned UNet,
    # forward and backward, f32 and bf16, at the CLIs' rows
    gn_p, at_p = shapes(pcfg)
    gn_cases, attn_cases = sorted(set(gn_d) | set(gn_p)), sorted(set(at_d) | set(at_p))
    check_step_shapes(gn_cases, attn_cases, LSUN_B, gen, dev, worst, "lsun")
    heads_dims = sorted({(h, d) for _, _, h, d in attn_cases})
    print(f"lsun kernels: forward and backward, f32 and bf16, rows={LSUN_B}, held against plain "
          f"at {len(gn_cases)} GroupNorm shapes (N {sorted({n for n, *_ in gn_cases})}, C "
          f"{sorted({c for _, c, *_ in gn_cases})}) and {len(attn_cases)} attention shapes "
          f"(heads, D) {heads_dims}")
    out["kernels"] = {"group_norm_shapes": [list(c_) for c_ in gn_cases],
                      "attention_shapes": [list(c_) for c_ in attn_cases]}
    lap("kernels")

    # (e) the main path: the train CLI on the pruned model over lsun:, bf16
    bwd_dtypes, unwrap = record_bwd_dtypes()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    try:
        ft, _, ft_s = run_cli(ddpm_train.main, common + [
            "--model_path", pruned_dir, "--output_dir", train_dir, "--train_batch_size",
            str(LSUN_B), "--num_iters", str(LSUN_TRAIN_STEPS), "--save_model_steps",
            str(LSUN_TRAIN_STEPS), "--log_steps", "1", "--learning_rate", "2e-5", "--dropout",
            "0.0", "--mixed_precision", "bf16", "--vis_samples", str(LSUN_VIS)])
    finally:
        unwrap()
    ft_counts = dict(ops.LAUNCHES)
    ft_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        rates = [json.loads(ln)["imgs_per_sec"] for ln in f]
    step_ms = [LSUN_B * 1e3 / r for r in rates]
    g, a = per_call
    print(f"main path lsun train CLI bf16: {ft['steps']} steps of B={LSUN_B}, losses "
          f"{ft['losses']}; step ms (host clock, metrics.jsonl) {[round(x, 1) for x in step_ms]}; "
          f"whole CLI {ft_s:.2f} s (the save and its DDIM-100 vis grid of {LSUN_VIS} included), "
          f"peak memory {ft_peak:.2f} GB {tag}; launches {ft_counts}; backward calls by dtype "
          f"{dict(bwd_dtypes)}")
    assert ft["steps"] == LSUN_TRAIN_STEPS and all(math.isfinite(v) for v in ft["losses"])
    assert ft_counts == unet_launches(per_call, LSUN_TRAIN_STEPS, 100), ft_counts
    assert dict(bwd_dtypes) == {("group_norm_bwd", "torch.bfloat16"): LSUN_TRAIN_STEPS * g,
                                ("attention_bwd", "torch.bfloat16"): LSUN_TRAIN_STEPS * a}, \
        bwd_dtypes
    out["train_cli"] = {"losses": ft["losses"], "step_ms": step_ms, "seconds": ft_s,
                        "peak_gb": ft_peak, "launches": ft_counts}
    lap("train CLI")

    # (f) the main path: DDIM samples from the finetuned pruned checkpoint, and
    # its export-diffusers, which loads back with its channel sizes
    ops.reset_launch_counts()
    drawn, _, sample_s = run_cli(ddpm_sample.main, [
        "--model_path", train_dir, "--output_dir", os.path.join(tmp, "lsun_samples"),
        "--total_samples", str(LSUN_SAMPLES), "--batch_size", str(LSUN_SAMPLES), "--ddim_steps",
        str(LSUN_DDIM), "--device", "cuda"])
    s_counts = dict(ops.LAUNCHES)
    pngs = [f for f in os.listdir(os.path.join(tmp, "lsun_samples")) if f.endswith(".png")]
    with Image.open(os.path.join(tmp, "lsun_samples", sorted(pngs)[0])) as im:
        size = im.size
    convert_checkpoints.main(["export-diffusers", train_dir, os.path.join(tmp, "lsun_hf_pruned")])
    ecfg, estate = load_unet(os.path.join(tmp, "lsun_hf_pruned"))
    tcfg, tstate = load_model(train_dir)
    round_trip = ecfg.channel_sizes == tcfg.channel_sizes == pcfg.channel_sizes and same_state(
        estate, tstate)
    print(f"main path lsun sample CLI: {drawn['images']} images {size} at DDIM-{LSUN_DDIM}, "
          f"{drawn['nonfinite']} non-finite, {sample_s:.2f} s {tag}; launches {s_counts}; the "
          f"finetuned UNet's export-diffusers loads back with its channel sizes, bit-identical: "
          f"{round_trip}")
    assert drawn["images"] == len(pngs) == LSUN_SAMPLES and drawn["nonfinite"] == 0
    assert size == (256, 256) and round_trip
    assert s_counts == unet_launches(per_call, 0, LSUN_DDIM), s_counts
    out["sample_cli"] = {"seconds": sample_s, "launches": s_counts}
    lap("sample CLI")

    # (g) per-op ms at the headline shapes: GroupNorm at (65,536, 128) with
    # SiLU, the attention at (256, 256, 512), f32 and bf16, at the CLIs' rows
    assert (65536, 128, 1e-6, True) in gn_d and (256, 256, 1, 512) in at_d, (gn_d, at_d)
    out["ops"] = time_step_ops((65536, 128), (256, 256, 512), LSUN_B, gen, dev, tag, "lsun")
    lap("op timings")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"lsun phase {out['seconds']:.1f} s (" + ", ".join(
        f"{k} at {v:.1f} s" for k, v in out["laps_s"].items()) + ")")
    return out


def dp_step_and_sweep(ctx, mesh, dev):
    """Phase 23's library run on ``mesh``'s rows of the global batch DP_B:
    one data-parallel train step (explicit noise and t, no dropout) and a
    DP_SWEEP_STEPS data-parallel sweep, each from the dense checkpoint.
    Returns host arrays (loss, grad norm, Adam's first moment, the params,
    the sweep's losses and grads) and each run's launches."""
    import numpy as np
    import torch

    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.diffpruning.sweep import accumulate_taylor_grads
    from diff_pruning_tpu_torch.models.unet2d import UNet2D
    from diff_pruning_tpu_torch.parallel.mesh import local_rows
    from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
    from diff_pruning_tpu_torch.training.finetune import (TrainConfig, init_train_state,
                                                          make_train_step)
    from diff_pruning_tpu_torch.utils.checkpoint import flat_from_state_dict, load_model

    cfg, state = load_model(ctx["ckpt"])
    sched = DiffusionSchedule.create(device=dev)
    with np.load(ctx["inputs"]) as f:
        x, noise, t = (torch.from_numpy(f[k]).to(dev) for k in ("x", "noise", "t"))
    res = {}
    model = UNet2D(cfg, device=dev)
    model.load_state_dict(state)
    st = init_train_state(model, TrainConfig())
    step = make_train_step(model, sched, TrainConfig(), mesh=mesh)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    st, m = step(st, local_rows(mesh, x), noise=local_rows(mesh, noise), t=local_rows(mesh, t))
    torch.cuda.synchronize()
    res["step_launches"] = dict(ops.LAUNCHES)
    res.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    res["mu"] = flat_from_state_dict(st.opt_state.mu)
    res["params"] = flat_from_state_dict(st.params)
    del st, step, model
    model = UNet2D(cfg, device=dev)
    model.load_state_dict(state)
    ops.reset_launch_counts()
    sw = accumulate_taylor_grads(model, sched, x, noise, thr=None, max_steps=DP_SWEEP_STEPS,
                                 mesh=mesh)
    torch.cuda.synchronize()
    res["sweep_launches"] = dict(ops.LAUNCHES)
    res.update(steps_run=sw.steps_run, losses=np.asarray(sw.losses))
    res["grads"] = flat_from_state_dict(sw.grads)
    return res


def dp_compare(got, ref, lr):
    """The gloo ranks' run against the NCCL world-1 run, at the CPU tests'
    tolerances (tests/test_torch_training.py, tests/test_torch_pruning.py):
    loss, grad norm and sweep losses DP_RTOL relative; Adam's first moment
    and the sweep grads within DP_RTOL of each parameter's largest |value|
    plus 1e-6 of the largest overall; the params within Adam's bound
    (ADAM_MOVE x lr). Returns the worst of each; raises past a tolerance."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    worst = {}
    for k in ("loss", "grad_norm"):
        worst[k] = abs(got[k] / ref[k] - 1)
        assert worst[k] <= DP_RTOL, (k, got[k], ref[k])
    assert got["steps_run"] == ref["steps_run"] == DP_SWEEP_STEPS, (got["steps_run"],
                                                                     ref["steps_run"])
    worst["sweep_losses"] = float(np.max(np.abs(got["losses"] / ref["losses"] - 1)))
    assert worst["sweep_losses"] <= DP_RTOL, (got["losses"], ref["losses"])
    def errs(part):  # (|got - ref| max, |ref| max) per parameter, on the card
        out = {}
        for k, v in ref[part].items():
            r, g = torch.from_numpy(v).to(dev), torch.from_numpy(got[part][k]).to(dev)
            out[k] = (float((g - r).abs().max()), float(r.abs().max()))
        return out

    for part in ("mu", "grads"):
        e = errs(part)
        floor = 1e-6 * max(vmax for _, vmax in e.values())
        worst[part] = 0.0
        for k, (err, vmax) in e.items():
            assert err <= DP_RTOL * vmax + floor, (part, k, err, vmax)
            worst[part] = max(worst[part], err / max(vmax, floor))
    worst["params_over_lr"] = max(err for err, _ in errs("params").values()) / lr
    assert worst["params_over_lr"] <= ADAM_MOVE, worst
    return worst


def dp_save(path, res):
    import numpy as np

    arrays = {"loss": res["loss"], "grad_norm": res["grad_norm"], "steps_run": res["steps_run"],
              "losses": res["losses"]}
    for part in ("mu", "params", "grads"):
        arrays.update({f"{part}:{k}": v for k, v in res[part].items()})
    np.savez(path, **arrays)


def dp_load(path):
    import numpy as np

    res = {"mu": {}, "params": {}, "grads": {}}
    with np.load(path) as f:
        for k in f.files:
            part, _, name = k.partition(":")
            if name:
                res[part][name] = f[k]
            else:
                res[k] = f[k].item() if f[k].ndim == 0 else f[k]
    return res


def dp_worker(argv) -> None:
    """One process of phase 23: ``chip_smoke.py --dp-worker nccl1|gloo:RANK CTX.json``.

    ``nccl1`` runs the train and prune CLIs without and then with
    --multihost under torchrun's environment at world size 1 (each call its
    own NCCL init), which must agree bit for bit.
    ``gloo:RANK`` is one of two ranks on the one card over gloo (the card
    holds one NCCL rank): the library step and sweep on its 64 rows, held
    against the parent's world-1 reference. Writes its figures to
    ``CTX["out"]_<mode>.json``."""
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    mode, ctx_path = argv
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke --dp-worker: torch.cuda.is_available() is false")
    with open(ctx_path) as f:
        ctx = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    sys.path.insert(0, REPO)
    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.ops import _build
    from diff_pruning_tpu_torch.parallel.mesh import make_mesh

    _build.build_libraries()  # the parent built them: this loads them
    dev = torch.device("cuda", 0)
    per_call = tuple(ctx["per_call"])
    out = {"mode": mode, "laps_s": {}}
    t0 = time.perf_counter()

    def lap(what):
        out["laps_s"][what] = time.perf_counter() - t0

    if mode.startswith("gloo:"):
        import datetime

        rank = int(mode.split(":")[1])
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{ctx['gloo_port']}",
                                world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=DP_WORKER_TIMEOUT_S))
        mesh = make_mesh(dev)
        res = dp_step_and_sweep(ctx, mesh, dev)
        lap("step and sweep")
        for what, steps in (("step_launches", 1), ("sweep_launches", DP_SWEEP_STEPS)):
            assert res[what] == unet_launches(per_call, steps), (rank, what, res[what])
        # every rank ends the step with the same params
        flat = torch.cat([torch.from_numpy(v).reshape(-1) for v in res["params"].values()])
        theirs = flat.clone().to(dev)
        dist.broadcast(theirs, 0)
        assert torch.equal(theirs.cpu(), flat), f"rank {rank}'s params differ from rank 0's"
        worst = dp_compare(res, dp_load(ctx["ref"]), ctx["lr"])
        lap("compared")
        out.update(rank=rank, worst=worst, step_launches=res["step_launches"],
                   sweep_launches=res["sweep_launches"], rows=DP_B // 2)
        dist.barrier()
        dist.destroy_process_group()
    else:
        from diff_pruning_tpu_torch.cli import ddpm_prune, ddpm_train
        from diff_pruning_tpu_torch.diffpruning import sweep as sweep_mod
        from diff_pruning_tpu_torch.pruning import pruner as pruner_mod
        from diff_pruning_tpu_torch.utils.checkpoint import flat_from_state_dict

        def cli(main_fn, argv, multihost):
            """``main_fn(argv)``; with ``multihost`` under torchrun's
            environment at world size 1, the CLI's own NCCL init, the group
            destroyed after it."""
            buf = io.StringIO()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            with contextlib.redirect_stdout(buf):
                if multihost:
                    with torchrun_env():
                        try:
                            stats = main_fn(argv + ["--multihost"])
                            assert (dist.get_backend(), dist.get_world_size()) == ("nccl", 1)
                        finally:
                            if dist.is_initialized():
                                dist.destroy_process_group()
                else:
                    stats = main_fn(argv)
            torch.cuda.synchronize()
            return stats, dict(ops.LAUNCHES), buf.getvalue()

        tmp = ctx["tmp"]
        # (a) the train CLI, 2 steps, saving (and a vis grid) at step 2
        train = ["--model_path", ctx["ckpt"], "--dataset", ctx["data"], "--train_batch_size",
                 str(DP_B), "--num_iters", str(DP_TRAIN_STEPS), "--save_model_steps",
                 str(DP_TRAIN_STEPS), "--log_steps", "1", "--vis_samples", "8",
                 "--device", "cuda"]
        runs = {}
        for name in ("plain", "multihost"):
            d = os.path.join(tmp, f"dp_train_{name}")
            runs[name] = cli(ddpm_train.main, train + ["--output_dir", d], name == "multihost")
            lap(f"train CLI {name}")
        text = runs["multihost"][2]
        assert "data mesh: 1 processes, rank 0 on cuda:0" in text, text
        ckpt = f"ckpt/step-{DP_TRAIN_STEPS}"
        same = {f: npz_equal(os.path.join(tmp, "dp_train_plain", ckpt, f),
                             os.path.join(tmp, "dp_train_multihost", ckpt, f))
                for f in ("params.npz", "ema_params.npz", "opt_state.npz")}
        want = unet_launches(per_call, DP_TRAIN_STEPS, 100)  # + the DDIM-100 vis grid
        out["train_cli"] = {"bit_identical": same, "losses": runs["multihost"][0]["losses"],
                            "launches": runs["multihost"][1]}
        print(f"multi-GPU (a) ddpm_train CLI --multihost (NCCL, world 1) against the plain "
              f"CLI, {DP_TRAIN_STEPS} steps B={DP_B}: losses {runs['multihost'][0]['losses']} "
              f"against {runs['plain'][0]['losses']}; step-{DP_TRAIN_STEPS} files bit-identical "
              f"{same}; launches {runs['multihost'][1]}")
        assert all(same.values()), same
        assert runs["multihost"][0]["losses"] == runs["plain"][0]["losses"]
        assert runs["plain"][1] == runs["multihost"][1] == want, (runs["plain"][1], want)

        # (a) the prune CLI, 3 sweep steps with thr off; the sweep's grads
        # and the pruner's Diff-Pruning scores caught on their way out
        caught = {"sweep": [], "prune": []}
        sweep_fn, prune_fn = sweep_mod.accumulate_taylor_grads, pruner_mod.prune

        def catch_sweep(*a, **k):
            res = sweep_fn(*a, **k)
            caught["sweep"].append((res.losses.copy(), flat_from_state_dict(res.grads)))
            return res

        def catch_prune(*a, **k):
            res = prune_fn(*a, **k)
            caught["prune"].append(res)
            return res

        sweep_mod.accumulate_taylor_grads, pruner_mod.prune = catch_sweep, catch_prune
        prune = ["--model_path", ctx["ckpt"], "--pruner", "diff-pruning", "--pruning_ratio",
                 "0.3", "--thr", "0", "--max_steps", str(DP_SWEEP_STEPS), "--batch_size",
                 str(DP_B), "--dataset", ctx["data"], "--skip_vis", "--device", "cuda"]
        try:
            for name in ("plain", "multihost"):
                d = os.path.join(tmp, f"dp_prune_{name}")
                runs[name] = cli(ddpm_prune.main, prune + ["--save_path", d],
                                 name == "multihost")
                lap(f"prune CLI {name}")
        finally:
            sweep_mod.accumulate_taylor_grads, pruner_mod.prune = sweep_fn, prune_fn
        (l_plain, g_plain), (l_mh, g_mh) = caught["sweep"]
        r_plain, r_mh = caught["prune"]
        grads_same = all(np.array_equal(g_mh[k], v) for k, v in g_plain.items())
        scores_same = sorted(r_plain.scores) == sorted(r_mh.scores) and all(
            np.array_equal(r_mh.scores[k], v) for k, v in r_plain.scores.items())
        model_same = npz_equal(os.path.join(tmp, "dp_prune_plain", "unet", "params.npz"),
                               os.path.join(tmp, "dp_prune_multihost", "unet", "params.npz"))
        want = unet_launches(per_call, DP_SWEEP_STEPS)
        out["prune_cli"] = {"grads_bit_identical": grads_same,
                            "scores_bit_identical": scores_same,
                            "pruned_params_bit_identical": model_same,
                            "losses": l_mh.tolist(), "launches": runs["multihost"][1]}
        print(f"multi-GPU (a) ddpm_prune CLI --multihost (NCCL, world 1) against the plain "
              f"CLI, {DP_SWEEP_STEPS} sweep steps B={DP_B}, thr off: losses {l_mh.tolist()} "
              f"against {l_plain.tolist()}; grads bit-identical {grads_same}, diff-pruning "
              f"scores ({len(r_mh.scores)} vars) bit-identical {scores_same}, pruned "
              f"params.npz bit-identical {model_same}; launches {runs['multihost'][1]}")
        assert np.array_equal(l_plain, l_mh) and grads_same and scores_same and model_same
        assert runs["multihost"][0]["channel_sizes"] == runs["plain"][0]["channel_sizes"]
        assert runs["plain"][1] == runs["multihost"][1] == want, (runs["plain"][1], want)
    out["seconds"] = time.perf_counter() - t0
    with open(ctx["out"] + f"_{mode.replace(':', '')}.json", "w") as f:
        json.dump(out, f)


def multi_gpu_path(tmp, gpu, tag, ctx):
    """Phase 23 (see the module docstring); returns the phase's figures.
    ``ctx``: ``ckpt`` (the dense CIFAR UNet's checkpoint dir), ``data``
    (phase 10's .npz), ``per_call`` and ``ldm_sample`` (phase 16's
    ldm_sample --multihost run: (c))."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from diff_pruning_tpu_torch.models.unet2d import UNet2D
    from diff_pruning_tpu_torch.parallel.mesh import init_distributed
    from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
    from diff_pruning_tpu_torch.training.finetune import (TrainConfig, init_train_state,
                                                          make_train_step)
    from diff_pruning_tpu_torch.utils.checkpoint import load_model

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(23)
    half = rng.integers(0, 1000, DP_B // 2 + 1)
    inputs = os.path.join(tmp, "dp_inputs.npz")
    np.savez(inputs, x=rng.uniform(-1, 1, (DP_B, 32, 32, 3)).astype(np.float32),
             noise=rng.standard_normal((DP_B, 32, 32, 3)).astype(np.float32),
             t=np.concatenate([half, 999 - half])[:DP_B].astype(np.int64))
    wctx = dict(ctx, tmp=tmp, inputs=inputs, ref=os.path.join(tmp, "dp_ref.npz"),
                out=os.path.join(tmp, "dp_out"), gloo_port=free_port(),
                lr=TrainConfig().learning_rate)
    ctx_path = os.path.join(tmp, "dp_ctx.json")
    with open(ctx_path, "w") as f:
        json.dump(wctx, f)

    def start(mode, env):
        return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", mode,
                                 ctx_path], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    # (a) in one process, --multihost under torchrun's environment; here
    # meanwhile (b)'s reference in a world-1 NCCL group (the library step
    # and sweep on the whole batch), then (b)'s two gloo ranks; the world-1
    # step timed against the plain one once the card is free again
    procs = [start("nccl1", dict(os.environ))]
    outs = []
    try:
        mesh = init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
        try:
            assert (mesh.world, mesh.rank, dist.get_backend()) == (1, 0, "nccl"), mesh
            ref = dp_step_and_sweep(wctx, mesh, dev)
            assert ref["step_launches"] == unet_launches(ctx["per_call"], 1), ref
            assert ref["sweep_launches"] == unet_launches(ctx["per_call"], DP_SWEEP_STEPS)
            dp_save(wctx["ref"], ref)
            del ref
            t_ref = time.perf_counter() - t_phase
            procs += [start(f"gloo:{r}", dict(os.environ)) for r in (0, 1)]
            for p in procs:
                outs.append(p.communicate(timeout=DP_WORKER_TIMEOUT_S)[0])
            t_procs = time.perf_counter() - t_phase
            # as the train CLI runs the step: draws from (seed, step), dropout
            cfg, state = load_model(ctx["ckpt"])
            model = UNet2D(cfg, device=dev)
            model.load_state_dict(state)
            sched = DiffusionSchedule.create(device=dev)
            st = init_train_state(model, TrainConfig())
            x = torch.from_numpy(np.load(inputs)["x"]).to(dev)
            fns = [lambda s=make_train_step(model, sched, TrainConfig(), mesh=m): s(st, x)
                   for m in (None, mesh)]
            plain_ms, mesh_ms = in_turns(fns, iters=DP_TIME_ITERS, warmup=1)
            del st, fns, model
        finally:
            dist.destroy_process_group()
    finally:
        for p in procs:  # a rank that failed leaves none waiting
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, text in zip(procs, outs):
        print(text, end="")
        assert p.returncode == 0, f"phase 23 worker exited {p.returncode}"
    step_ms = {"plain": plain_ms, "world1_nccl": mesh_ms,
               "plain_imgs_per_s": DP_B * 1e3 / plain_ms,
               "world1_nccl_imgs_per_s": DP_B * 1e3 / mesh_ms}
    print(f"time multi-GPU train step cifar10 35.75M B={DP_B} f32: world-1 NCCL "
          f"{mesh_ms:.2f} ms ({DP_B * 1e3 / mesh_ms:.1f} imgs/s), plain {plain_ms:.2f} ms "
          f"({DP_B * 1e3 / plain_ms:.1f} imgs/s) (CUDA events, in turns plain-nccl-nccl-"
          f"plain, {DP_TIME_ITERS} steps each after a warm-up) {tag}")
    res = {}
    for mode in ("nccl1", "gloo0", "gloo1"):
        with open(os.path.join(tmp, f"dp_out_{mode}.json")) as f:
            res[mode] = json.load(f)
    for r in (0, 1):
        g = res[f"gloo{r}"]
        print(f"multi-GPU (b) gloo rank {r} of 2 on the one card, {g['rows']} rows: against the "
              f"NCCL world-1 run on {DP_B}, worst (err / max(param max, 1e-6 of the largest)) "
              f"{g['worst']} (tol {DP_RTOL} x param max + 1e-6 of the largest; params "
              f"{ADAM_MOVE} x lr); launches step {g['step_launches']}, sweep "
              f"{g['sweep_launches']}")
    c = ctx["ldm_sample"]
    print(f"multi-GPU (c) ldm_sample --multihost (NCCL, world 1) in phase 16: {c['pngs']} PNGs, "
          f"launches {c['launches']}, {c['imgs_per_s']:.2f} imgs/s")
    seconds = time.perf_counter() - t_phase
    print(f"multi-GPU phase {seconds:.1f} s (the reference at {t_ref:.1f} s, the processes done "
          f"at {t_procs:.1f} s; laps {res['nccl1']['laps_s']}, gloo {res['gloo0']['laps_s']}); "
          f"world-1 train step {step_ms['world1_nccl_imgs_per_s']:.1f} imgs/s against the "
          f"plain step's {step_ms['plain_imgs_per_s']:.1f} {tag}")
    return {"card": gpu, "seconds": seconds, "reference_seconds": t_ref,
            "train_cli": res["nccl1"]["train_cli"], "prune_cli": res["nccl1"]["prune_cli"],
            "ldm_sample": c, "step_ms": step_ms, "nccl1_laps_s": res["nccl1"]["laps_s"],
            "gloo_ranks": [res["gloo0"], res["gloo1"]]}


def main() -> None:
    import argparse

    import numpy as np
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    ap.add_argument("--compare-fwd", metavar="LABEL=SRC", action="append", default=[],
                    help="another flash_attention_fwd.cu (same C interface) whose forward "
                         "phases 16 and 18 time in turns with this checkout's; repeatable")
    ap.add_argument("--compare-bwd", metavar="LABEL=SRC", action="append", default=[],
                    help="another flash_attention_bwd.cu (same C interface) whose dq and dk/dv "
                         "phases 13, 17 and 18 time in turns with this checkout's; repeatable")
    args = ap.parse_args()
    other_srcs = {}  # kind -> [(label, source)]
    for kind in OTHER_LIBS:
        given = getattr(args, f"compare_{kind}")
        other_srcs[kind] = [arg.partition("=")[::2] for arg in given]
        if not all(label and src for label, src in other_srcs[kind]):
            ap.error(f"--compare-{kind} takes LABEL=SRC, got {given}")

    # -- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: this smoke run "
                         "needs an NVIDIA GPU")
    gpu = gpu_line()
    print(gpu, flush=True)
    tag = f"[{gpu}]"
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    sys.path.insert(0, REPO)
    from diff_pruning_tpu_torch import ops
    from diff_pruning_tpu_torch.cli import ddpm_prune, ddpm_sample, ddpm_train
    from diff_pruning_tpu_torch.diffpruning.sweep import (accumulate_taylor_grads,
                                                          make_loss_fn)
    from diff_pruning_tpu_torch.models.unet2d import UNet2D, ddpm_cifar10_config
    from diff_pruning_tpu_torch.ops import _build
    from diff_pruning_tpu_torch.ops import attention as A
    from diff_pruning_tpu_torch.ops import group_norm as G
    from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
    from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference
    from diff_pruning_tpu_torch.pruning.importance import make_importance
    from diff_pruning_tpu_torch.pruning.surgery import unflatten_params
    from diff_pruning_tpu_torch.sampling.ddim_sampler import SamplerConfig, make_sampler
    from diff_pruning_tpu_torch.schedulers.ddpm import DiffusionSchedule
    from diff_pruning_tpu_torch.training.ema import ema_update
    from diff_pruning_tpu_torch.training.finetune import (TrainConfig, antithetic_timesteps,
                                                          init_train_state, make_optimizer,
                                                          make_train_step)
    from diff_pruning_tpu_torch.utils.checkpoint import (flat_from_state_dict, load_model,
                                                         save_model)

    mark(2)
    # -- 2. build: one nvcc per CUDA source, all at once, and the other
    # versions of the attention given to compare with, beside them
    t_build = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=max(1, sum(map(len, other_srcs.values()))))
    other_futs = {kind: {label: pool.submit(load_other, kind, label, src) for label, src in srcs}
                  for kind, srcs in other_srcs.items()}
    _build.build_libraries()
    for name in _build.CUDA_LIBRARIES:
        info = _build.BUILD_INFO[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build: {name}.cu (nvcc sm_90a) {info['seconds']:.2f}s; " + " | ".join(ptxas))
    print(f"build: all builds {time.perf_counter() - t_build:.2f}s")
    regs = {lib: ptxas_by_kernel(_build.BUILD_INFO[lib]["log"], *PTXAS_KERNELS[lib])
            for lib in PTXAS_KERNELS}
    for lib, kernels in regs.items():
        for kname, (nregs, st, ld) in sorted(kernels.items()):
            print(f"ptxas: {lib} {kname}: {nregs} registers, spill stores {st} bytes, "
                  f"spill loads {ld} bytes")
    if _build.BUILD_INFO["flash_attention_fwd"]["log"]:  # empty when already built
        assert {k.split("<")[0] for k in regs["flash_attention_fwd"]} == {
            "flash_fwd_kernel_f32", "flash_fwd_kernel_f32_wide", "flash_fwd_kernel_mma",
            "flash_fwd_kernel_wgmma_wide"}, regs
        # f32 at 4 head-dim paddings and 6 wide (D 257-1024); 16-bit: 2 types
        # x (4 + 4 wide)
        assert len(regs["flash_attention_fwd"]) == 26, regs
        for kname, (_, st, ld) in regs["flash_attention_fwd"].items():
            assert "_wide" not in kname or st == ld == 0, f"{kname} spills"
    if _build.BUILD_INFO["flash_attention_bwd"]["log"]:
        assert {k.split("<")[0] for k in regs["flash_attention_bwd"]} == {
            "flash_bwd_dq_kernel_f32", "flash_bwd_dkv_kernel_f32", "flash_bwd_dq_kernel_mma",
            "flash_bwd_dkv_kernel_mma", "flash_bwd_dq_kernel_f32_wide",
            "flash_bwd_dkv_kernel_f32_wide", "flash_bwd_dq_kernel_mma_wide",
            "flash_bwd_dkv_kernel_mma_wide", "flash_bwd_dq_kernel_wgmma_wide",
            "flash_bwd_dkv_kernel_wgmma_wide"}, regs
        # f32: dq at 4 head-dim paddings, dk/dv at 2, the wide pair at 1 each
        # (D 257-1024: clusters of 192-column blocks); 16-bit: 2 types x ((4 +
        # 6) x 2 kernels + the wgmma pair's 5 tilings each)
        assert len(regs["flash_attention_bwd"]) == 68, regs
        for kname, (_, st, ld) in regs["flash_attention_bwd"].items():
            assert not ("_wgmma" in kname or "_f32_wide" in kname) or st == ld == 0, \
                f"{kname} spills"
    if _build.BUILD_INFO["group_norm_bwd"]["log"]:
        assert len(regs["group_norm_bwd"]) == 6, regs  # 3 dtypes x SiLU or not
    sass_libs = ("flash_attention_fwd", "flash_attention_bwd", "group_norm_bwd")
    with ThreadPoolExecutor(max_workers=len(sass_libs)) as sass_pool:  # a cuobjdump each
        sass_of = dict(zip(sass_libs, sass_pool.map(
            lambda lib: sass_counts(_build.load_library(lib)._name), sass_libs)))
    for lib in sass_libs:
        sass = sass_of[lib]
        if sass is None:
            print("sass: no cuobjdump in the toolkit; tensor-core use not checked")
            break
        for kname, (hmma, hgmma, ffma) in sorted(sass.items()):
            print(f"sass: {lib} {kname}: {hmma} HMMA, {hgmma} HGMMA, {ffma} FFMA")
            if "_kernel_mma" in kname:  # forward, dq and dk/dv in bf16/f16
                assert hmma > 0, f"{kname} has no tensor-core instruction"
            if "_kernel_wgmma" in kname:  # the wide 16-bit forward, dq and dk/dv
                assert hgmma > 0, f"{kname} has no warpgroup tensor-core instruction"
            if "_kernel_f32" in kname or "gn_bwd_kernel" in kname:
                assert hmma == hgmma == 0 and ffma > 0, f"{kname} is not f32 on the CUDA cores"
        wants = {"flash_attention_fwd": ("flash_fwd_kernel_mma", "flash_fwd_kernel_wgmma_wide",
                                         "flash_fwd_kernel_f32_wide"),
                 "flash_attention_bwd": ("flash_bwd_dq_kernel_f32", "flash_bwd_dkv_kernel_f32",
                                         "flash_bwd_dq_kernel_f32_wide",
                                         "flash_bwd_dkv_kernel_f32_wide",
                                         "flash_bwd_dq_kernel_mma", "flash_bwd_dkv_kernel_mma",
                                         "flash_bwd_dq_kernel_mma_wide",
                                         "flash_bwd_dkv_kernel_mma_wide",
                                         "flash_bwd_dq_kernel_wgmma_wide",
                                         "flash_bwd_dkv_kernel_wgmma_wide"),
                 "group_norm_bwd": ("gn_bwd_kernel",)}[lib]
        for want in wants:  # (one instance of each wide f32 kernel, two or more of the others)
            least = 1 if want.endswith("_f32_wide") else 2
            assert sum(want in kname for kname in sass) >= least, (want, sorted(sass))
    ours = A._lib("flash_attention_bwd")
    # label -> library of another version of the attention forward / backward
    others_fwd = {label: fut.result() for label, fut in other_futs["fwd"].items()}
    others = {label: fut.result() for label, fut in other_futs["bwd"].items()}
    pool.shutdown()

    mark(3)
    # -- 3. forward kernels against plain versions at the UNet's shapes, B = 128
    cfg = ddpm_cifar10_config()
    pcfg = pruned_config(cfg)
    dense = UNet2D(cfg, device="cpu").init(torch.Generator().manual_seed(0)).eval()
    pruned = UNet2D(pcfg, device="cpu").init(torch.Generator().manual_seed(1)).eval()
    # the prune CLI's UNet (phase 10), which the finetune path trains
    ftcfg = cli_pruned_config(cfg, dense)
    ftnet = UNet2D(ftcfg, device="cpu").init(torch.Generator().manual_seed(5)).eval()
    gn_dense, attn_dense = op_shapes(dense)
    gn_pruned, attn_pruned = op_shapes(pruned)
    gn_ft, attn_ft = op_shapes(ftnet)
    print(f"dense UNet: {sum(gn_dense.values())} GroupNorm and {sum(attn_dense.values())} "
          f"attention calls per forward; pruned: {sum(gn_pruned.values())} and "
          f"{sum(attn_pruned.values())}; prune CLI's (finetune path, "
          f"{sum(p.numel() for p in ftnet.parameters())} params): {sum(gn_ft.values())} and "
          f"{sum(attn_ft.values())}")
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = collections.defaultdict(float)
    gn_cases = sorted(set(gn_dense) | set(gn_pruned) | set(gn_ft))
    attn_cases = sorted(set(attn_dense) | set(attn_pruned) | set(attn_ft) | {(100, 1, 256)})
    check_forward_kernels(gn_cases, attn_cases, gen, dev, worst)
    torch.cuda.synchronize()

    mark(4)
    # -- 4. full-width forward, kernels on and off on the same weights
    model = UNet2D(cfg, device=dev)
    model.load_state_dict(dense.state_dict())
    model.eval()
    x = torch.randn((B, 32, 32, 3), generator=gen, device=dev)
    t = torch.randint(0, 1000, (B,), generator=gen, device=dev)
    with torch.inference_mode():
        gn_seen, unhook = record_gn_layouts(model)
        ops.reset_launch_counts()
        y_on = model(x, t)
        fwd_counts = dict(ops.LAUNCHES)
        unhook()
        ops.set_kernels_enabled(False)
        y_off = model(x, t)
        ops.set_kernels_enabled(True)
    diff = float((y_on - y_off).abs().max())
    print(f"forward cifar10 35.75M B={B} f32: kernels on vs off max_abs_diff={diff:.3e} "
          f"(tol {FORWARD_TOL_F32}), launches {fwd_counts}, |y| max {float(y_off.abs().max()):.3f}")
    assert fwd_counts["group_norm"] == sum(gn_dense.values()), fwd_counts
    assert fwd_counts["attention"] == sum(attn_dense.values()), fwd_counts
    assert bool(torch.isfinite(y_on).all()) and diff <= FORWARD_TOL_F32
    print(f"GroupNorm inputs, full-width forward (inference): {dict(gn_seen)}")

    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmpdir.name
    mark(5)
    # -- 5./6. serving path through the sampling CLI: dense, then pruned
    results = {}
    for name, m, c, gn_n, attn_n in (("dense", dense, cfg, gn_dense, attn_dense),
                                     ("pruned", pruned, pcfg, gn_pruned, attn_pruned)):
        ckpt = os.path.join(tmp, name)
        save_model(ckpt, c, m)
        base = ["--model_path", ckpt, "--batch_size", str(B), "--device", "cuda"]
        # warm-up
        ddpm_sample.main(base + ["--output_dir", os.path.join(tmp, name + "_warm"),
                                 "--total_samples", str(B), "--ddim_steps", "2"])
        out = os.path.join(tmp, name + "_samples")
        ops.reset_launch_counts()
        stats = ddpm_sample.main(base + ["--output_dir", out, "--total_samples", "256",
                                         "--ddim_steps", str(SAMPLE_TIME_STEPS)])
        counts = dict(ops.LAUNCHES)
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        print(f"serving path {name}: {stats['params'] / 1e6:.4f}M params, "
              f"{stats['macs'] / 1e9:.4f}G MACs, {len(pngs)} PNGs, "
              f"{stats['imgs_per_s']:.2f} imgs/s (DDIM-{SAMPLE_TIME_STEPS}, B={B}, f32, "
              f"CUDA events, after warm-up) {tag}; launches {counts}")
        assert len(pngs) == 256 and stats["images"] == 256 and stats["nonfinite"] == 0
        forwards = SAMPLE_TIME_STEPS * 2
        assert counts["group_norm"] == forwards * sum(gn_n.values()) > 0, counts
        assert counts["attention"] == forwards * sum(attn_n.values()) > 0, counts
        assert counts["group_norm_bwd"] == counts["attention_lse"] == 0, counts
        results[name] = {"stats": stats, "launches": counts}

    mark(7)
    # -- 7. timings: forward per op at the dense shapes (f32 and bf16), then sampling
    per_forward = {}
    for op, cases in (("group_norm", gn_dense), ("attention", attn_dense)):
        for dname in TOL:
            dtype = getattr(torch, dname)
            tot = collections.defaultdict(float)
            for shape, calls in sorted(cases.items()):
                lib = None
                if op == "group_norm":
                    n, c, silu = shape
                    x = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
                    s, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
                    kw = dict(groups=32, with_silu=silu)
                    fns = [lambda: group_norm_reference(x, s, b, **kw),
                           lambda: group_norm(x, s, b, **kw)]
                    if not silu:  # F.group_norm on its own (B, C, N) layout
                        xl, sl, bl = x.transpose(1, 2).contiguous(), s.to(dtype), b.to(dtype)
                        fns.append(lambda: F.group_norm(xl, 32, sl, bl, eps=1e-6))
                    nbytes, flops = gn_fwd_work(n, c, silu, dname)
                else:
                    n, h, d = shape
                    q, k, v = (torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
                               for _ in range(3))
                    fns = [lambda: reference_attention(q, k, v, d ** -0.5),
                           lambda: flash_attention(q, k, v, d ** -0.5),
                           lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)]
                    nbytes, flops = attn_fwd_work(n, h, d, dname)
                ms = in_turns(fns, iters=5)
                pm, km = ms[0], ms[1]
                bms, by = bound(nbytes, flops, dname)
                tot["kernel"] += km * calls
                tot["plain"] += pm * calls
                tot["flops"] += flops * calls
                add_bound(tot, "", bms * calls, by)
                if len(ms) == 3:
                    lib = ms[2]
                    tot["library"] += lib * calls
                    tot["kernel_where_library"] += km * calls
                rate = (f", {flops / km / 1e9:.1f} TFLOP/s (library "
                        f"{flops / lib / 1e9:.1f})" if op == "attention" else "")
                print(f"time {op} fwd {shape} x{calls}/forward B={B} {dname}: kernel {km:.4f} ms, "
                      f"plain {pm:.4f} ms, library "
                      f"{'-' if lib is None else f'{lib:.4f} ms'}, bound {bms:.4f} ms ({by})"
                      f"{rate} {tag}")
            tot["tflops"] = tot["flops"] / tot["kernel"] / 1e9
            per_forward[(op, dname)] = dict(tot)
            print(f"time {op} fwd per UNet forward B={B} {dname}: kernel {tot['kernel']:.4f} ms, "
                  f"plain {tot['plain']:.4f} ms, bound {tot['bound']:.4f} ms; library "
                  f"{tot['library']:.4f} ms against kernel {tot['kernel_where_library']:.4f} ms "
                  f"on the calls it covers; {tot['tflops']:.2f} TFLOP/s {tag}")

    # GroupNorm host time per call: the wrapper's enqueue, no sync inside
    host_us = {}
    for dname in TOL:
        dtype = getattr(torch, dname)
        total = 0.0
        for (n, c, silu), calls in sorted(gn_dense.items()):
            x = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            s, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            total += host_us_per_call(
                lambda: group_norm(x, s, b, groups=32, with_silu=silu)) * calls
        host_us[dname] = total / sum(gn_dense.values())
        print(f"time group_norm fwd host per call B={B} {dname}: {host_us[dname]:.2f} us "
              f"(perf_counter over 200 calls without a sync, averaged over one forward's "
              f"calls) {tag}")

    sched = DiffusionSchedule.create(device=dev)
    pmodel = UNet2D(pcfg, device=dev)
    pmodel.load_state_dict(pruned.state_dict())
    pmodel.eval()
    sampling = collections.defaultdict(dict)
    for (name, net), dname in itertools.product((("dense", model), ("pruned", pmodel)), TOL):
        sample = make_sampler(net, sched, SamplerConfig(num_inference_steps=SAMPLE_TIME_STEPS,
                                                        dtype=dname))
        warm = make_sampler(net, sched, SamplerConfig(num_inference_steps=2, dtype=dname))

        def run(on, sample=sample):
            ops.set_kernels_enabled(on)
            try:
                return cuda_ms(lambda: sample(gen, B, 32, 3), iters=1, warmup=0)
            finally:
                ops.set_kernels_enabled(True)

        for on in (False, True):
            ops.set_kernels_enabled(on)
            warm(gen, B, 32, 3)
        ops.set_kernels_enabled(True)
        off1, on1 = run(False), run(True)
        if name == "dense":  # profile of 5 DDIM steps, kernels on
            prof = make_sampler(net, sched, SamplerConfig(num_inference_steps=5, dtype=dname))
            print_profile(f"sampling dense DDIM step kernels on B={B} {dname}",
                          *profile_classes(lambda: prof(gen, B, 32, 3)), ("step", 5), tag)
        on, off = B * 1000 / on1, B * 1000 / off1
        sampling[name][dname] = {"kernels_on": on, "kernels_off": off}
        print(f"time sampling {name} DDIM-{SAMPLE_TIME_STEPS} B={B} {dname}: kernels on "
              f"{on:.2f} imgs/s ({on1:.1f} ms), kernels off "
              f"{off:.2f} imgs/s ({off1:.1f} ms) {tag}")
    torch.cuda.synchronize()
    del model, pmodel

    mark(8)
    # -- 8. backward kernels against plain versions at the UNet's shapes, B = 128
    check_backward_kernels(gn_cases, attn_cases, gen, dev, worst)
    torch.cuda.synchronize()

    mark(9)
    # -- 9. the sweep at full width, kernels on against off, then on again
    torch.backends.cudnn.deterministic = True
    smodel = UNet2D(cfg, device=dev)
    smodel.load_state_dict(dense.state_dict())
    sgen = torch.Generator(device=dev).manual_seed(3)
    x0 = torch.rand((B, 32, 32, 3), generator=sgen, device=dev) * 2 - 1
    noise = torch.randn((B, 32, 32, 3), generator=sgen, device=dev)
    per_step = {"group_norm": sum(gn_dense.values()), "group_norm_bwd": sum(gn_dense.values()),
                "attention": sum(attn_dense.values()), "attention_lse": sum(attn_dense.values()),
                "attention_bwd_dq": sum(attn_dense.values()),
                "attention_bwd_dkv": sum(attn_dense.values())}

    def sweep(on):
        ops.set_kernels_enabled(on)
        try:
            ops.reset_launch_counts()
            res = accumulate_taylor_grads(smodel, sched, x0, noise, thr=None,
                                          max_steps=SWEEP_STEPS)
            torch.cuda.synchronize()
            return res, dict(ops.LAUNCHES), {n: g.clone() for n, g in res.grads.items()}
        finally:
            ops.set_kernels_enabled(True)

    gn_seen, unhook = record_gn_layouts(smodel)
    bwd_seen, unwrap = record_gn_bwd_layouts()
    res_on, counts_on, grads_on = sweep(True)
    unhook()
    unwrap()
    print(f"GroupNorm inputs, sweep under autograd ({SWEEP_STEPS} steps): {dict(gn_seen)}; "
          f"at the backward kernel: {dict(bwd_seen)}")
    res_off, counts_off, grads_off = sweep(False)
    res_again, _, grads_again = sweep(True)
    print(f"sweep cifar10 35.75M B={B} f32 {SWEEP_STEPS} steps: losses on {res_on.losses}, "
          f"off {res_off.losses}; launches on {counts_on}, off {counts_off}")
    assert counts_on == {k: SWEEP_STEPS * v for k, v in per_step.items()}, counts_on
    assert not any(counts_off.values()), counts_off
    assert res_on.steps_run == res_off.steps_run == SWEEP_STEPS
    np.testing.assert_allclose(res_on.losses, res_off.losses, rtol=SWEEP_LOSS_RTOL)
    floor = 1e-6 * max(float(g.abs().max()) for g in grads_off.values())
    worst_grad, worst_name = 0.0, ""
    for name, g in grads_off.items():
        err = float((grads_on[name] - g).abs().max())
        gmax = float(g.abs().max())
        assert bool(torch.isfinite(grads_on[name]).all()) and \
            err <= SWEEP_GRAD_TOL * gmax + floor, f"sweep grad {name}: {err:.3e} (max {gmax:.3e})"
        if err / max(gmax, floor) > worst_grad:
            worst_grad, worst_name = err / max(gmax, floor), f"{name} (max |grad| {gmax:.3e})"

    identical = all(torch.equal(grads_again[n], g) for n, g in grads_on.items())
    assert identical and np.array_equal(res_again.losses, res_on.losses), \
        "kernel-on sweep is not bit-reproducible"
    params = unflatten_params(flat_from_state_dict(smodel.state_dict()))
    imp = make_importance("diff-pruning")
    graph = smodel.graph
    g_on = unflatten_params(flat_from_state_dict(grads_on))
    g_off = unflatten_params(flat_from_state_dict(grads_off))
    worst_score = 0.0
    for var in graph.prunable_vars():
        s_on = imp(graph, params, var, grads=g_on)
        s_off = imp(graph, params, var, grads=g_off)
        err = float(np.abs(s_on - s_off).max()) / max(float(np.abs(s_off).max()), 1e-30)
        assert err <= SWEEP_SCORE_RTOL, f"diff-pruning scores of {var.name}: {err:.3e}"
        worst_score = max(worst_score, err)
    print(f"sweep on vs off: loss max rel diff "
          f"{float(np.max(np.abs(res_on.losses / res_off.losses - 1))):.3e} "
          f"(tol {SWEEP_LOSS_RTOL}); worst grad err / param max {worst_grad:.3e} at "
          f"{worst_name} (tol {SWEEP_GRAD_TOL}); worst diff-pruning score err / var max {worst_score:.3e} "
          f"(tol {SWEEP_SCORE_RTOL}); repeat kernel-on grads bit-identical: {identical}")
    del grads_on, grads_off, grads_again, g_on, g_off, res_on, res_off, res_again
    smodel.zero_grad(set_to_none=True)

    mark(10)
    # -- 10. pruning path (main path): the prune CLI on the seeded dense checkpoint
    torch.backends.cudnn.deterministic = False
    data = os.path.join(tmp, "data.npz")
    np.savez(data, images=np.random.default_rng(4).integers(0, 256, (128, 32, 32, 3),
                                                             dtype=np.uint8))
    out = os.path.join(tmp, "pruned_cli")
    argv = ["--model_path", os.path.join(tmp, "dense"), "--save_path", out,
            "--pruner", "diff-pruning", "--pruning_ratio", "0.3", "--thr", "0.05",
            "--max_steps", "20", "--batch_size", str(B), "--dataset", data, "--device", "cuda"]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cli = ddpm_prune.main(argv)
    torch.cuda.synchronize()
    cli_seconds = time.perf_counter() - t0
    cli_counts = dict(ops.LAUNCHES)
    steps = cli["steps_run"]
    print(f"main path prune CLI: {cli['params_before'] / 1e6:.4f}M -> {cli['params'] / 1e6:.4f}M "
          f"params, {cli['macs_before'] / 1e9:.4f}G -> {cli['macs'] / 1e9:.4f}G MACs, sweep "
          f"{steps} steps in {cli['sweep_seconds']:.2f}s, whole CLI {cli_seconds:.2f}s "
          f"(host clock, B={B}, f32) {tag}; launches {cli_counts}")
    # the sweep's steps, then DDIM-100 for vis/after_pruning.png on the pruned
    # model, which has the dense one's GroupNorm and attention calls
    vis_forwards = 100
    want_counts = {
        "group_norm": (steps + vis_forwards) * per_step["group_norm"],
        "group_norm_bwd": steps * per_step["group_norm_bwd"],
        "attention": (steps + vis_forwards) * per_step["attention"],
        "attention_lse": steps * per_step["attention_lse"],
        "attention_bwd_dq": steps * per_step["attention_bwd_dq"],
        "attention_bwd_dkv": steps * per_step["attention_bwd_dkv"]}
    assert 1 <= steps <= 20 and cli_counts == want_counts, (cli_counts, want_counts)
    assert all(v > 0 for v in cli_counts.values()), cli_counts
    pcfg_cli, state = load_model(out)
    reloaded = UNet2D(pcfg_cli, device=dev)
    reloaded.load_state_dict(state)
    n_reloaded = sum(p.numel() for p in reloaded.parameters())
    assert n_reloaded == cli["params"] == PRUNED_PARAMS_AT_0_3, n_reloaded
    del reloaded
    samples = ddpm_sample.main(["--model_path", out, "--output_dir", os.path.join(tmp, "cli_s"),
                                "--total_samples", str(B), "--batch_size", str(B),
                                "--device", "cuda"])
    print(f"main path check: checkpoint reloads at {n_reloaded} params (pinned "
          f"{PRUNED_PARAMS_AT_0_3}); sampling CLI drew {samples['images']} images, "
          f"{samples['nonfinite']} non-finite values, {samples['imgs_per_s']:.2f} imgs/s")
    assert samples["images"] == B and samples["nonfinite"] == 0

    mark(11)
    # -- 11. finetune path, f32: the train CLI on the prune CLI's checkpoint, then a resume
    assert pcfg_cli.channel_sizes == ftcfg.channel_sizes
    torch.backends.cudnn.deterministic = True
    ft_base = ["--dataset", data, "--model_path", out, "--train_batch_size", str(B),
               "--save_model_steps", str(FT_SAVE), "--log_steps", str(FT_SAVE),
               "--vis_samples", str(FT_VIS), "--device", "cuda"]
    ft_out, ft2_out = os.path.join(tmp, "finetuned"), os.path.join(tmp, "finetuned_resumed")

    def ft_counts_want(steps):
        # per step one forward and one backward; DDIM-100 for each vis grid
        return unet_launches((sum(gn_ft.values()), sum(attn_ft.values())), steps,
                             steps // FT_SAVE * 100)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ft = ddpm_train.main(ft_base + ["--output_dir", ft_out, "--num_iters", str(FT_STEPS)])
    torch.cuda.synchronize()
    ft_seconds = time.perf_counter() - t0
    ft_counts = dict(ops.LAUNCHES)
    with open(os.path.join(ft_out, "metrics.jsonl")) as f:
        ft_log = [json.loads(line) for line in f]
    print(f"main path finetune CLI f32: {FT_STEPS} steps of the {PRUNED_PARAMS_AT_0_3}-param "
          f"UNet, B={B}, losses {ft['losses']}; whole CLI {ft_seconds:.2f}s (host clock, "
          f"two saves and vis grids included); metrics.jsonl {ft_log} {tag}; "
          f"launches {ft_counts}")
    assert ft["steps"] == FT_STEPS and all(math.isfinite(v) for v in ft["losses"]), ft
    assert ft_counts == ft_counts_want(FT_STEPS), (ft_counts, ft_counts_want(FT_STEPS))
    assert [r["step"] for r in ft_log] == [FT_SAVE, 2 * FT_SAVE]
    ft2 = ddpm_train.main(ft_base + ["--output_dir", ft2_out, "--num_iters", str(FT_STEPS),
                                     "--resume_from_checkpoint",
                                     os.path.join(ft_out, "ckpt", f"step-{FT_SAVE}")])
    resume_same = {f: npz_equal(os.path.join(ft_out, "ckpt", f"step-{FT_STEPS}", f),
                                os.path.join(ft2_out, "ckpt", f"step-{FT_STEPS}", f))
                   for f in ("params.npz", "ema_params.npz", "opt_state.npz")}
    print(f"finetune resume from step {ft2['start_step']}: losses {ft2['losses']}; step-"
          f"{FT_STEPS} files bit-identical to the uninterrupted run's: {resume_same}")
    assert ft2["start_step"] == FT_SAVE and ft2["losses"] == ft["losses"][FT_SAVE:], ft2
    assert all(resume_same.values()), resume_same
    ecfg, estate = load_model(ft_out, subfolder="unet_ema")
    ema_net = UNet2D(ecfg, device=dev)
    ema_net.load_state_dict(estate)
    n_ema = sum(p.numel() for p in ema_net.parameters())
    del ema_net
    ema_samples = ddpm_sample.main(["--model_path", ft_out, "--use_ema", "--output_dir",
                                    os.path.join(tmp, "ema_s"), "--total_samples", str(B),
                                    "--batch_size", str(B), "--device", "cuda"])
    print(f"finetune check: unet_ema reloads at {n_ema} params; sampling CLI drew "
          f"{ema_samples['images']} images from it, {ema_samples['nonfinite']} non-finite")
    assert n_ema == PRUNED_PARAMS_AT_0_3
    assert ema_samples["images"] == B and ema_samples["nonfinite"] == 0

    mark(12)
    # -- 12. finetune path, bf16
    ft16_out = os.path.join(tmp, "finetuned_bf16")
    bwd_dtypes, unwrap = record_bwd_dtypes()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        ft16 = ddpm_train.main(ft_base + ["--output_dir", ft16_out, "--num_iters",
                                          str(FT_BF16_STEPS), "--mixed_precision", "bf16"])
        torch.cuda.synchronize()
    finally:
        unwrap()
    ft16_seconds = time.perf_counter() - t0
    ft16_counts = dict(ops.LAUNCHES)
    print(f"finetune CLI bf16: {FT_BF16_STEPS} steps, losses {ft16['losses']}; whole CLI "
          f"{ft16_seconds:.2f}s {tag}; launches {ft16_counts}; backward calls by dtype "
          f"{dict(bwd_dtypes)}; first-step loss bf16 {ft16['losses'][0]:.4f} against f32 "
          f"{ft['losses'][0]:.4f}")
    assert ft16["steps"] == FT_BF16_STEPS and all(math.isfinite(v) for v in ft16["losses"])
    assert ft16_counts == ft_counts_want(FT_BF16_STEPS), ft16_counts
    assert dict(bwd_dtypes) == {
        ("group_norm_bwd", "torch.bfloat16"): FT_BF16_STEPS * sum(gn_ft.values()),
        ("attention_bwd", "torch.bfloat16"): FT_BF16_STEPS * sum(attn_ft.values())}, bwd_dtypes
    torch.backends.cudnn.deterministic = False

    mark(13)
    # -- 13. timings: backward per op at the dense shapes, then the sweep step
    per_step_bwd, bwd_host_us = {}, {}
    for dname in TOL:
        dtype = getattr(torch, dname)
        tot = collections.defaultdict(float)
        for (n, c, silu), calls in sorted(gn_dense.items()):
            x = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            dy = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            s, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            mean, rstd = G.group_norm_stats_reference(x, 32)
            kw = dict(groups=32, with_silu=silu)
            fns = [lambda: G.group_norm_backward_reference(x, s, b, dy, mean, rstd, **kw),
                   lambda: G.group_norm_backward(x, s, b, dy, mean, rstd, **kw)]
            if not silu:  # autograd of F.group_norm: native_group_norm_backward alone
                xl = x.transpose(1, 2).contiguous().requires_grad_()
                sl, bl = (z.to(dtype, copy=True).requires_grad_() for z in (s, b))
                yl = F.group_norm(xl, 32, sl, bl, eps=1e-6)
                dyl = dy.transpose(1, 2).contiguous()
                fns.append(lambda: torch.autograd.grad(yl, (xl, sl, bl), dyl, retain_graph=True))
            ms = in_turns(fns, iters=5)
            bms, by = bound(*gn_bwd_work(n, c, silu, dname), dname)
            tot["gn_kernel"] += ms[1] * calls
            tot["gn_plain"] += ms[0] * calls
            add_bound(tot, "gn_", bms * calls, by)
            if len(ms) == 3:
                tot["gn_library"] += ms[2] * calls
                tot["gn_kernel_where_library"] += ms[1] * calls
            print(f"time group_norm bwd {(n, c, silu)} x{calls}/step B={B} {dname}: kernel "
                  f"{ms[1]:.4f} ms, plain {ms[0]:.4f} ms, library "
                  f"{f'{ms[2]:.4f} ms' if len(ms) == 3 else '-'}, bound {bms:.4f} ms ({by}) {tag}")
        # the dense UNet's shapes, and in bf16 the prune CLI's UNet's (D = 179;
        # keys "ft_..."), which the bf16 finetune path trains
        for pre, cases in [("", attn_dense)] + ([("ft_", attn_ft)] if dname == "bfloat16" else []):
            for (n, h, d), calls in sorted(cases.items()):
                q, k, v, do = (torch.randn((B, h, n, d), generator=gen, device=dev).to(dtype)
                               for _ in range(4))
                scale = d ** -0.5
                o, lse = A.reference_attention_lse(q, k, v, scale)
                _, dsum = A.attention_backward_dq_reference(q, k, v, o, do, lse, scale)
                ql, kl, vl = (z.detach().clone().requires_grad_() for z in (q, k, v))
                ol = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
                fns = [
                    lambda: A.attention_backward_dq_reference(q, k, v, o, do, lse, scale),
                    with_lib("bwd", ours, lambda: A.flash_attention_backward_dq(
                        q, k, v, o, do, lse, scale)),
                    lambda: A.attention_backward_dkv_reference(q, k, v, do, lse, dsum, scale),
                    with_lib("bwd", ours, lambda: A.flash_attention_backward_dkv(
                        q, k, v, do, lse, dsum, scale)),
                    lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)]
                for lib in others.values():  # the other versions, timed in the same turns
                    fns += [with_lib("bwd", lib, lambda: A.flash_attention_backward_dq(
                                q, k, v, o, do, lse, scale)),
                            with_lib("bwd", lib, lambda: A.flash_attention_backward_dkv(
                                q, k, v, do, lse, dsum, scale))]
                ms = in_turns(fns, iters=5)
                fq, fkv = attn_dq_work(n, h, d, dname)[1], attn_dkv_work(n, h, d, dname)[1]
                bq, byq = bound(*attn_dq_work(n, h, d, dname), dname)
                bkv, bykv = bound(*attn_dkv_work(n, h, d, dname), dname)
                other_ms = {label: ms[5 + 2 * i: 7 + 2 * i] for i, label in enumerate(others)}
                for key, val in (("dq_plain", ms[0]), ("dq_kernel", ms[1]),
                                 ("dkv_plain", ms[2]), ("dkv_kernel", ms[3]),
                                 ("attn_library", ms[4]), ("dq_flops", fq), ("dkv_flops", fkv),
                                 *((f"{part}_{label}", t) for label, pair in other_ms.items()
                                   for part, t in zip(("dq", "dkv"), pair))):
                    tot[pre + key] += val * calls
                add_bound(tot, pre + "dq_", bq * calls, byq)
                add_bound(tot, pre + "dkv_", bkv * calls, bykv)
                versus = "".join(f"; {label} dq {a:.4f} ms, dk/dv {b:.4f} ms"
                                 for label, (a, b) in other_ms.items())
                print(f"time attention bwd {'prune CLI UNet ' if pre else ''}{(n, h, d)} "
                      f"x{calls}/step B={B} {dname}: dq kernel {ms[1]:.4f} ms, "
                      f"{fq / ms[1] / 1e9:.1f} TFLOP/s (plain {ms[0]:.4f}, bound {bq:.4f} "
                      f"{byq}), dk/dv kernel {ms[3]:.4f} ms, {fkv / ms[3] / 1e9:.1f} TFLOP/s "
                      f"(plain {ms[2]:.4f}, bound {bkv:.4f} {bykv}), library (SDPA backward, "
                      f"dq+dk+dv) {ms[4]:.4f} ms{versus} {tag}")
        for pre in ("", "ft_") if dname == "bfloat16" else ("",):
            tot[pre + "dq_tflops"] = tot[pre + "dq_flops"] / tot[pre + "dq_kernel"] / 1e9
            tot[pre + "dkv_tflops"] = tot[pre + "dkv_flops"] / tot[pre + "dkv_kernel"] / 1e9
        total = 0.0
        for (n, c, silu), calls in sorted(gn_dense.items()):
            x = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            dy = torch.randn((B, n, c), generator=gen, device=dev).to(dtype)
            s, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            mean, rstd = G.group_norm_stats_reference(x, 32)
            total += host_us_per_call(lambda: G.group_norm_backward(
                x, s, b, dy, mean, rstd, groups=32, with_silu=silu)) * calls
        bwd_host_us[dname] = total / sum(gn_dense.values())
        print(f"time group_norm bwd host per call B={B} {dname}: "
              f"{bwd_host_us[dname]:.2f} us (perf_counter over 200 calls without a "
              f"sync, averaged over one step's calls) {tag}")
        per_step_bwd[dname] = dict(tot)
        print(f"time backward per sweep step B={B} {dname}: " + ", ".join(
            f"{k} {val:.4f} ms" for k, val in sorted(tot.items())) + f" {tag}")

    torch.backends.cudnn.deterministic = True
    loss_fn = make_loss_fn(smodel, sched)
    tsteps = [torch.full((B,), k, dtype=torch.int64, device=dev) for k in range(SWEEP_STEPS)]

    def sweep_steps(on):
        ops.set_kernels_enabled(on)
        try:
            for ts in tsteps:
                loss_fn(x0, noise, ts).backward()
        finally:
            ops.set_kernels_enabled(True)

    sweep_steps(False)  # one warm-up each
    sweep_steps(True)
    off_ms, on_ms = one_turn([lambda: sweep_steps(False), lambda: sweep_steps(True)])
    step_on, step_off = on_ms / SWEEP_STEPS, off_ms / SWEEP_STEPS
    print(f"time sweep step (forward + backward) cifar10 35.75M B={B} f32: kernels on "
          f"{step_on:.2f} ms, kernels off {step_off:.2f} ms (CUDA events, {SWEEP_STEPS} steps "
          f"off then on after a warm-up each, cuDNN deterministic) {tag}")
    print_profile(f"sweep step kernels on B={B} f32",
                  *profile_classes(lambda: sweep_steps(True)), ("step", SWEEP_STEPS), tag)
    torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()

    mark(14)
    # -- 14. the train step: kernels on against off, then timings and profiles
    torch.backends.cudnn.deterministic = True
    tgen = torch.Generator(device=dev).manual_seed(6)
    tx = [torch.rand((B, 32, 32, 3), generator=tgen, device=dev) * 2 - 1
          for _ in range(TRAIN_STEPS)]
    tnoise = [torch.randn((B, 32, 32, 3), generator=tgen, device=dev) for _ in range(TRAIN_STEPS)]
    tts = [antithetic_timesteps(tgen, B, 1000) for _ in range(TRAIN_STEPS)]

    def train_steps(on, prec="no"):
        ops.set_kernels_enabled(on)
        try:
            net = UNet2D(cfg, device=dev)
            net.load_state_dict(dense.state_dict())
            st = init_train_state(net, TrainConfig(mixed_precision=prec))
            step = make_train_step(net, sched, TrainConfig(mixed_precision=prec))
            ops.reset_launch_counts()
            losses, mu1 = [], None
            for i in range(TRAIN_STEPS):
                st, met = step(st, tx[i], noise=tnoise[i], t=tts[i])
                losses.append(float(met["loss"]))
                if i == 0:  # Adam's first moment: 0.1 x the first step's clipped grads
                    mu1 = {n: m.clone() for n, m in st.opt_state.mu.items()}
            return np.asarray(losses), mu1, dict(ops.LAUNCHES)
        finally:
            ops.set_kernels_enabled(True)

    tl_on, mu_on, tcounts_on = train_steps(True)
    tl_off, mu_off, tcounts_off = train_steps(False)
    assert tcounts_on == {k: TRAIN_STEPS * v for k, v in per_step.items()}, tcounts_on
    assert not any(tcounts_off.values()), tcounts_off
    np.testing.assert_allclose(tl_on, tl_off, rtol=TRAIN_LOSS_RTOL)
    floor = 1e-6 * max(float(m.abs().max()) for m in mu_off.values())
    worst_mu, worst_mu_name = 0.0, ""
    for name, m in mu_off.items():
        err, mmax = float((mu_on[name] - m).abs().max()), float(m.abs().max())
        assert bool(torch.isfinite(mu_on[name]).all()) and \
            err <= SWEEP_GRAD_TOL * mmax + floor, f"train step grad {name}: {err:.3e}"
        if err / max(mmax, floor) > worst_mu:
            worst_mu, worst_mu_name = err / max(mmax, floor), name
    print(f"train step cifar10 35.75M B={B} f32 {TRAIN_STEPS} steps, kernels on vs off: "
          f"losses on {tl_on}, off {tl_off}, max rel diff "
          f"{float(np.max(np.abs(tl_on / tl_off - 1))):.3e} (tol {TRAIN_LOSS_RTOL}); first "
          f"step's grads (Adam's mu) worst err / param max {worst_mu:.3e} at {worst_mu_name} "
          f"(tol {SWEEP_GRAD_TOL}); launches on {tcounts_on}")
    # bf16: every GroupNorm and attention backward in bf16, the 16-bit dq and
    # dk/dv kernels inside the model
    bwd_dtypes, unwrap = record_bwd_dtypes()
    try:
        tl16_on, mu16_on, tc16_on = train_steps(True, "bf16")
    finally:
        unwrap()
    tl16_off, mu16_off, tc16_off = train_steps(False, "bf16")
    assert tc16_on == {k: TRAIN_STEPS * v for k, v in per_step.items()}, tc16_on
    assert not any(tc16_off.values()), tc16_off
    assert dict(bwd_dtypes) == {
        ("group_norm_bwd", "torch.bfloat16"): TRAIN_STEPS * per_step["group_norm_bwd"],
        ("attention_bwd", "torch.bfloat16"): TRAIN_STEPS * per_step["attention_bwd_dq"]}, \
        bwd_dtypes
    loss16 = float(np.max(np.abs(tl16_on / tl16_off - 1)))
    diff16 = math.sqrt(sum(float(((mu16_on[n] - m) ** 2).sum()) for n, m in mu16_off.items()))
    norm16 = math.sqrt(sum(float((m ** 2).sum()) for m in mu16_off.values()))
    print(f"train step cifar10 35.75M B={B} bf16 {TRAIN_STEPS} steps, kernels on vs off: "
          f"losses on {tl16_on}, off {tl16_off}, max rel diff {loss16:.3e} (tol "
          f"{TRAIN_BF16_LOSS_RTOL}); first step's grads (Adam's mu) |on - off| / |off| "
          f"{diff16 / norm16:.3e} (tol {TRAIN_BF16_GRAD_RTOL}); backward calls by dtype "
          f"{dict(bwd_dtypes)}")
    assert np.isfinite(tl16_on).all() and loss16 <= TRAIN_BF16_LOSS_RTOL, (tl16_on, tl16_off)
    assert all(bool(torch.isfinite(m).all()) for m in mu16_on.values())
    assert diff16 <= TRAIN_BF16_GRAD_RTOL * norm16, (diff16, norm16)
    del mu_on, mu_off, mu16_on, mu16_off
    torch.backends.cudnn.deterministic = False

    # timings as the train CLI runs the step: draws from (seed, step), dropout 0.1
    train_ms, peak_gb, train_prof = {}, {}, {}
    sd_ft = {n: p.to(dev) for n, p in ftnet.state_dict().items()}
    for (name, c, sd), prec in itertools.product(
            (("dense", cfg, dense.state_dict()), ("pruned", ftcfg, sd_ft)), ("no", "bf16")):
        tcfg = TrainConfig(mixed_precision=prec)
        net = UNet2D(dataclasses.replace(c, dropout=0.1), device=dev)
        net.load_state_dict(sd)
        st = init_train_state(net, tcfg)
        step = make_train_step(net, sched, tcfg, seed=7)

        def run(on, st=st, step=step):
            ops.set_kernels_enabled(on)
            try:
                step(st, tx[0])
            finally:
                ops.set_kernels_enabled(True)

        run(False)  # one warm-up each
        run(True)
        off, on = one_turn([lambda: run(False), lambda: run(True)])
        dname = "bfloat16" if prec == "bf16" else "float32"
        train_ms[(name, dname)] = {"kernels_on_ms": on, "kernels_off_ms": off,
                                   "kernels_on_imgs_per_s": B * 1e3 / on,
                                   "kernels_off_imgs_per_s": B * 1e3 / off}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        run(True)
        torch.cuda.synchronize()
        peak_gb[(name, dname)] = torch.cuda.max_memory_allocated(dev) / 1e9
        train_ms[(name, dname)]["host_ms"] = host_us_per_call(lambda: run(True), calls=1) / 1e3
        print(f"time train step {name} B={B} {dname}: kernels on {on:.2f} ms "
              f"({B * 1e3 / on:.1f} imgs/s), kernels off {off:.2f} ms ({B * 1e3 / off:.1f} "
              f"imgs/s) (CUDA events, 1 step off then 1 on, dropout 0.1); host "
              f"{train_ms[(name, dname)]['host_ms']:.2f} ms a step kernels on (perf_counter over "
              f"1 step without a sync); peak memory {peak_gb[(name, dname)]:.2f} GB {tag}")
        if name == "dense":  # a profile of the dense step
            busy, span, launches, counts, by_name = profile_kernels(lambda: run(True))
            print_profile(f"train step {name} kernels on B={B} {dname}", busy, span, launches,
                          counts, ("step", 1), tag)
            prof = train_prof[f"{name}/{dname}"] = {
                "busy_ms": sum(busy.values()), "span_ms": span, "launches": launches,
                "idle_share": 1 - sum(busy.values()) / span,
                "dq_ms": sum(v for k, v in by_name.items() if "flash_bwd_dq" in k),
                "dkv_ms": sum(v for k, v in by_name.items() if "flash_bwd_dkv" in k)}
            print(f"profile train step {name} B={B} {dname}: dq kernel {prof['dq_ms']:.3f} "
                  f"ms, dk/dv kernel {prof['dkv_ms']:.3f} ms device time per step {tag}")
        if (name, prec) == ("dense", "no"):
            opt = make_optimizer(tcfg)
            plist = list(st.params.values())
            grads = [torch.randn(p.shape, generator=tgen, device=dev) for p in plist]

            def opt_ema():
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
                opt.update(grads, norm, st.opt_state, plist)
                ema_update(st.ema_params.values(), plist, tcfg.ema_decay)

            opt_ms = cuda_ms(opt_ema, iters=10)
            opt_host_ms = host_us_per_call(opt_ema, calls=10) / 1e3
            print(f"time optimizer + EMA per step (grad norm, clip, Adam, EMA; "
                  f"{sum(p.numel() for p in plist)} params in {len(plist)} tensors, f32): "
                  f"{opt_ms:.3f} ms (CUDA events), host {opt_host_ms:.3f} ms {tag}")
        del net, st, step
    torch.cuda.synchronize()

    mark(15)
    # -- 15. evaluation path: the FID Inception and the fid_score and fidelity CLIs
    ops.reset_launch_counts()
    evaluation = evaluation_path(tmp, {name: os.path.join(tmp, name + "_samples")
                                       for name in ("dense", "pruned")}, gpu, tag)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES  # no kernel of the port on this path

    mark(16)
    # -- 16. the class-conditional LDM serving path (cin256-v2 + vq-f4)
    ldm_model, ldm_dir, ldm = ldm_path(tmp, gen, gpu, tag, worst, others_fwd)

    mark(17)
    # -- 17. the LDM prune path: the wide f32 backward, the sweep, the CLI
    ldm_pruned_dir, ldm_prune_fig = ldm_prune_path(tmp, ldm_model, ldm_dir, gen, gpu, tag, worst,
                                                   others)
    del ldm_model

    mark(18)
    # -- 18. the LDM train path: the wide 16-bit attention, the bf16 step, the CLI
    ldm_train_fig = ldm_train_path(tmp, ldm_dir, ldm_pruned_dir, gen, gpu, tag, worst,
                                   others_fwd, others)

    mark(19)
    # -- 19. the unconditional LDM path (CelebA-HQ LDM-VQ-4, LSUN-churches
    # LDM-KL-8) and the DDPM samplers beyond DDIM
    uncond = uncond_ldm_path(tmp, gen, gpu, tag, worst, others_fwd, {
        "sched": sched, "ckpt": os.path.join(tmp, "dense"),
        "per_call": (sum(gn_dense.values()), sum(attn_dense.values()))})

    mark(20)
    # -- 20. the ablation and cost-aware path: the cost-aware prune, every kernel
    # at its UNet's shapes, prune_finetune, prune_ssim and compute_ssim
    ablation = ablation_path(tmp, gen, gpu, tag, worst, {
        "sched": sched, "ckpt": os.path.join(tmp, "dense"), "data": data,
        "per_call": (sum(gn_dense.values()), sum(attn_dense.values()))})

    mark(21)
    # -- 21. the first-stage training path: the five kernels' backward at the
    # vq-f4 codec's shapes, the step kernels on against off, the CLI
    ae = ae_train_path(tmp, gen, gpu, tag, worst, {
        "vq_dir": ldm_dir, "kl_dir": os.path.join(tmp, "uncond_churches"),
        "data": os.path.join(tmp, "ldm_train_data")})

    mark(22)
    # -- 22. the text- and retrieval-conditioned serving paths: txt2img with the
    # BERTEmbedder, inpaint, train_searcher and knn2img with CLIP
    text = text_ldm_path(tmp, gen, gpu, tag, worst, others_fwd)

    mark(23)
    # -- 23. the multi-GPU path: NCCL at world size 1 (the train, prune and
    # ldm_sample CLIs with --multihost), two gloo ranks on the one card
    multi_gpu = multi_gpu_path(tmp, gpu, tag, {
        "ckpt": os.path.join(tmp, "dense"), "data": data,
        "per_call": (sum(gn_dense.values()), sum(attn_dense.values())),
        "ldm_sample": ldm["cli"]["plms_multihost"]})

    mark(24)
    # -- 24. the LSUN-256 path: a diffusers dir and an lmdb through the prune,
    # train (bf16) and sampling CLIs at full width; every kernel at its shapes
    lsun = lsun_path(tmp, gen, gpu, tag, worst)
    tmpdir.cleanup()

    mark(25)
    # -- 25. result lines
    f32_fwd = {op: per_forward[(op, "float32")] for op in ("group_norm", "attention")}
    f32_bwd, bf16_bwd = per_step_bwd["float32"], per_step_bwd["bfloat16"]

    def entry(name, route, source, replaces, launches, err_key, ms, plain_ms, bound_ms,
              bound_by, library_ms, **extra):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": worst[(err_key, "float32")],
                "max_abs_err_bf16": worst[(err_key, "bfloat16")], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, **extra}

    def bf16_bwd_of(part):
        """The 16-bit dq or dk/dv kernel's bf16 figures per sweep step: at the
        dense UNet's shapes and (``_prune_cli_unet``) the prune CLI's UNet's."""
        out = {}
        for pre, suffix in (("", ""), ("ft_", "_prune_cli_unet")):
            out.update({f"ms_bf16{suffix}": bf16_bwd[f"{pre}{part}_kernel"],
                        f"plain_ms_bf16{suffix}": bf16_bwd[f"{pre}{part}_plain"],
                        f"bound_ms_bf16{suffix}": bf16_bwd[f"{pre}{part}_bound"],
                        f"library_ms_dq_dk_dv_bf16{suffix}": bf16_bwd[f"{pre}attn_library"],
                        f"tflops_bf16{suffix}": bf16_bwd[f"{pre}{part}_tflops"]})
            for label in others:
                out[f"{label}_ms_bf16{suffix}"] = bf16_bwd[f"{pre}{part}_{label}"]
        return out

    def paths(key):
        return dict(launches_prune_cli=cli_counts[key], launches_finetune_bf16=ft16_counts[key],
                    launches_ldm_prune_cli=ldm_prune_fig["cli_launches"][key],
                    launches_ldm_train_cli=ldm_train_fig["cli_launches"][key],
                    launches_prune_ssim_cli=ablation["prune_ssim"]["launches"][key],
                    launches_multi_gpu_train_cli=multi_gpu["train_cli"]["launches"][key],
                    max_abs_err_cost_aware_unets=worst[(key + "_cost", "float32")],
                    **ae_of(key), **lsun_of(key))

    def ae_of(key):
        """The first-stage training path's figures (phase 21): launches of the
        autoencoder_train CLI's f32 run, the max abs error over a vq-f4 train
        step's shapes (f32 and bf16), and ms, plain, bound and library of one
        call at the step's headline shape (B = 12)."""
        err_key = {"group_norm": "group_norm_ae", "group_norm_bwd": "group_norm_bwd_ae",
                   "attention": "attention_ae", "attention_bwd_dq": "attention_bwd_dq_ae",
                   "attention_bwd_dkv": "attention_bwd_dkv_ae"}[key]
        op = {"group_norm": "gn_fwd", "group_norm_bwd": "gn_bwd", "attention": "attn_fwd",
              "attention_bwd_dq": "dq", "attention_bwd_dkv": "dkv"}[key]
        res = {"launches_ae_cli": ae["cli_launches"][key],
               "max_abs_err_ae": worst[(err_key, "float32")],
               "max_abs_err_ae_bf16": worst[(err_key, "bfloat16")],
               "ae_shape": (ae["ops"]["float32"]["gn_shape"] if key.startswith("group_norm")
                            else ae["ops"]["float32"]["attn_shape"])}
        for dname, sfx in (("float32", ""), ("bfloat16", "_bf16")):
            t = ae["ops"][dname][op]
            res.update({f"ms_ae{sfx}": t["kernel"], f"plain_ms_ae{sfx}": t["plain"],
                        f"bound_ms_ae{sfx}": t["bound"], f"bound_by_ae{sfx}": t["bound_by"],
                        f"library_ms_ae{sfx}": t.get("library")})
            if key.startswith("attention_bwd"):
                res[f"library_ms_dq_dk_dv_ae{sfx}"] = ae["ops"][dname]["sdpa_bwd"]
        return res

    def lsun_of(key):
        """The LSUN-256 path's figures (phase 24): launches of the prune and
        train CLIs, the max abs error over the dense and pruned UNets'
        shapes (f32 and bf16), and ms, plain, bound and library of one call
        at the headline shape (B = 16)."""
        op = {"group_norm": "gn_fwd", "group_norm_bwd": "gn_bwd", "attention": "attn_fwd",
              "attention_bwd_dq": "dq", "attention_bwd_dkv": "dkv"}[key]
        res = {"launches_lsun_prune_cli": lsun["prune_cli"]["launches"][key],
               "launches_lsun_train_cli": lsun["train_cli"]["launches"][key],
               "max_abs_err_lsun": worst[(key + "_lsun", "float32")],
               "max_abs_err_lsun_bf16": worst[(key + "_lsun", "bfloat16")],
               "lsun_shape": (lsun["ops"]["float32"]["gn_shape"] if key.startswith("group_norm")
                              else lsun["ops"]["float32"]["attn_shape"])}
        for dname, sfx in (("float32", ""), ("bfloat16", "_bf16")):
            t = lsun["ops"][dname][op]
            res.update({f"ms_lsun{sfx}": t["kernel"], f"plain_ms_lsun{sfx}": t["plain"],
                        f"bound_ms_lsun{sfx}": t["bound"], f"bound_by_lsun{sfx}": t["bound_by"],
                        f"library_ms_lsun{sfx}": t.get("library")})
            if key.startswith("attention_bwd"):
                res[f"library_ms_dq_dk_dv_lsun{sfx}"] = lsun["ops"][dname]["sdpa_bwd"]
        return res

    lp_ops = ldm_prune_fig["ops_per_step"]
    per_ldm_step = f"f32, summed over one B={LDM_PRUNE_B} LDM sweep step's calls"

    def ldm_wide_bwd(part):
        """The wide f32 dq or dk/dv kernel: the LDM prune CLI's launches, its
        max abs error over the LDM shapes and its figures per sweep step."""
        out = entry(f"flash_attention_bwd_{part}_wide", "cuda", attn_bwd_src,
                     "diff_pruning_tpu/ops/attention.py:" + ("143" if part == "dq" else "170"),
                     ldm_prune_fig["cli_launches"][f"attention_bwd_{part}"],
                     f"attention_bwd_{part}_ldm", lp_ops[f"{part}_kernel"],
                     lp_ops[f"{part}_plain"], lp_ops[f"{part}_bound"],
                     lp_ops[f"{part}_bound_by"], None, ms_is=per_ldm_step,
                     library_ms_dq_dk_dv=lp_ops["attn_library"],
                     tflops=lp_ops[f"{part}_tflops"],
                     launch_path="the ldm_prune CLI (phase 17)",
                     **{f"{label}_ms": lp_ops[f"{part}_kernel_{label}"] for label in others})
        out.pop("max_abs_err_bf16")  # f32 only: phase 18 holds the 16-bit ones
        return out

    lt_ops = ldm_train_fig["ops_per_step"]
    per_train_step = (f"bf16, summed over one B={LDM_TRAIN_B} LDM train step's calls (the dense "
                      f"cin256-v2 UNet; _pruned: the UNet pruned at 0.3)")

    def ldm_wide16(part):
        """The wide 16-bit attention kernel ``part`` (fwd, dq, dkv): the
        ldm_train CLI's launches, its max abs error over the train step's
        shapes (bf16; f16 beside it) and its figures per train step."""
        source = "diff_pruning_tpu_torch/ops/csrc/flash_attention_" + (
            "fwd.cu" if part == "fwd" else "bwd.cu")
        line = {"fwd": "97", "dq": "143", "dkv": "170"}[part]
        err_key = {"fwd": "attention_ldm_train", "dq": "attention_bwd_dq_ldm_train",
                   "dkv": "attention_bwd_dkv_ldm_train"}[part]
        launch_key = {"fwd": "attention_lse", "dq": "attention_bwd_dq",
                      "dkv": "attention_bwd_dkv"}[part]
        dense_, pruned_ = lt_ops["dense"], lt_ops["pruned"]
        lib = "fwd_library" if part == "fwd" else None
        out = {"name": ("flash_attention_fwd_wide16" if part == "fwd"
                        else f"flash_attention_bwd_{part}_wide16"),
               "route": "cuda", "source": source,
               "replaces": f"diff_pruning_tpu/ops/attention.py:{line}",
               "launches": ldm_train_fig["cli_launches"][launch_key],
               "max_abs_err": worst[(err_key, "bfloat16")],
               "max_abs_err_f16": worst[(err_key, "float16")],
               "ms": dense_[f"{part}_kernel"], "plain_ms": dense_[f"{part}_plain"],
               "bound_ms": dense_[f"{part}_bound"], "bound_by": dense_[f"{part}_bound_by"],
               "library_ms": dense_[lib] if lib else None, "ms_is": per_train_step,
               "tflops": dense_[f"{part}_tflops"], "sdpa_backends": dense_["sdpa_backends"],
               "ms_pruned": pruned_[f"{part}_kernel"], "plain_ms_pruned": pruned_[f"{part}_plain"],
               "bound_ms_pruned": pruned_[f"{part}_bound"],
               "tflops_pruned": pruned_[f"{part}_tflops"],
               "launch_path": "the ldm_train CLI (phase 18)"}
        if part == "fwd":
            enc = lt_ops["encode"]
            out.update({f"{label}_ms": dense_[f"fwd_kernel_{label}"] for label in others_fwd})
            out.update({f"{label}_ms_pruned": pruned_[f"fwd_kernel_{label}"]
                        for label in others_fwd})
            out.update({f"{label}_ms_encode": enc[f"fwd_kernel_{label}"] for label in others_fwd})
            out.update(ms_encode=enc["fwd_kernel"], plain_ms_encode=enc["fwd_plain"],
                       library_ms_encode=enc["fwd_library"], bound_ms_encode=enc["fwd_bound"],
                       tflops_encode=enc["fwd_tflops"],
                       library_ms_is="F.scaled_dot_product_attention, bf16",
                       library_ms_pruned=pruned_["fwd_library"],
                       launches_without_lse=(ldm_train_fig["cli_launches"]["attention"]
                                             - ldm_train_fig["cli_launches"]["attention_lse"]))
        else:
            out.update(library_ms_dq_dk_dv=dense_["bwd_library"],
                       library_ms_dq_dk_dv_pruned=pruned_["bwd_library"])
            out.update({f"{label}_ms": dense_[f"{part}_kernel_{label}"] for label in others})
            out.update({f"{label}_ms_pruned": pruned_[f"{part}_kernel_{label}"]
                        for label in others})
        return out

    def ldm_train_gn(part):
        """The bf16 GroupNorm forward or backward summed over one dense
        LDM train step's calls (phase 18)."""
        t = lt_ops["group_norm"]
        return {f"{k_}_ldm_train_step_bf16": t.get(f"{part}_{k_}")
                for k_ in ("kernel", "plain", "bound", "bound_by", "library",
                           "kernel_where_library")}

    def ldm_of(op):
        """The LDM serving path's figures (phase 16): launches of the
        ldm_sample CLI's DDIM run, f32 max abs error over the LDM shapes,
        and ms, plain, bound and library summed over one CFG UNet call's
        calls (2 LDM_B rows) and over one decode's (LDM_B rows)."""
        out = {"launches_ldm_cli": ldm["cli"]["ddim"]["launches"][op],
               "max_abs_err_ldm": worst[(f"{op}_ldm", "float32")]}
        for part, tot in (("unet_call", ldm["ops_unet_call"][op]),
                          ("decode", ldm["ops_decode"][op])):
            out.update({f"ms_ldm_{part}": tot["kernel"], f"plain_ms_ldm_{part}": tot["plain"],
                        f"bound_ms_ldm_{part}": tot["bound"],
                        f"bound_by_ldm_{part}": tot["bound_by"],
                        f"library_ms_ldm_{part}": tot.get("library"),
                        f"ms_where_library_ldm_{part}": tot.get("kernel_where_library"),
                        f"tflops_ldm_{part}": tot["tflops"]})
            if "backends" in tot:
                out[f"library_backend_ldm_{part}"] = tot["backends"]
            for label in others_fwd if op == "attention" else ():
                out[f"{label}_ms_ldm_{part}"] = tot[f"kernel_{label}"]
        return out

    def uncond_of(op):
        """The unconditional LDM path's figures (phase 19): launches of the
        sample_diffusion CLI's CelebA-HQ run, f32 max abs error over both
        models' shapes, and ms, plain, bound and library summed over one
        CelebA-HQ UNet call's calls (UNCOND_B rows; its vq-f4 decode's are
        phase 16's ``*_ldm_decode``)."""
        res = {"launches_uncond_ldm_cli": uncond["cli"]["launches"][op],
               "max_abs_err_uncond_ldm": worst[(f"{op}_uncond", "float32")]}
        for part, tot in (("unet_call", uncond["ops_unet_call"][op]),):
            res.update({f"ms_uncond_{part}": tot["kernel"],
                        f"plain_ms_uncond_{part}": tot["plain"],
                        f"bound_ms_uncond_{part}": tot["bound"],
                        f"bound_by_uncond_{part}": tot["bound_by"],
                        f"library_ms_uncond_{part}": tot.get("library"),
                        f"ms_where_library_uncond_{part}": tot.get("kernel_where_library")})
            if "backends" in tot:
                res[f"library_backend_uncond_{part}"] = tot["backends"]
        return res

    def text_of(op):
        """The text- and retrieval-conditioned paths' figures (phase 22):
        launches of the txt2img (DDIM-10), inpaint and knn2img CLI runs, f32
        max abs error over every shape of the three models, and ms, plain,
        bound and library summed over one UNet call of each (the CLIs' rows)
        and, for the attention, one BERT encode."""
        res = {f"launches_{cli}_cli": text["cli"][key]["launches"][op]
               for cli, key in (("txt2img", "txt2img_ddim"), ("inpaint", "inpaint"),
                                ("knn2img", "knn2img"))}
        res["max_abs_err_text_ldm"] = worst[(f"{op}_text", "float32")]
        for part, ops_ in text["ops"].items():
            if op not in ops_:
                continue
            tot = ops_[op]
            res.update({f"ms_{part}": tot["kernel"], f"plain_ms_{part}": tot["plain"],
                        f"bound_ms_{part}": tot["bound"], f"bound_by_{part}": tot["bound_by"],
                        f"library_ms_{part}": tot.get("library"),
                        f"ms_where_library_{part}": tot.get("kernel_where_library")})
        return res

    per_fwd = "f32, summed over one B=128 UNet forward's calls (inference launch)"
    per_bwd = "f32, summed over one B=128 sweep step's calls"
    gn_fwd_src = "diff_pruning_tpu_torch/ops/csrc/group_norm_fwd.cu"
    gn_bwd_src = "diff_pruning_tpu_torch/ops/csrc/group_norm_bwd.cu"
    bf16_fwd = {op: per_forward[(op, "bfloat16")] for op in ("group_norm", "attention")}
    attn_bwd_src = "diff_pruning_tpu_torch/ops/csrc/flash_attention_bwd.cu"
    kernels = [
        entry("group_norm_silu_fwd", "cuda", gn_fwd_src, "diff_pruning_tpu/ops/group_norm.py:110",
              ft_counts["group_norm"], "group_norm", f32_fwd["group_norm"]["kernel"],
              f32_fwd["group_norm"]["plain"], f32_fwd["group_norm"]["bound"],
              bound_by(f32_fwd["group_norm"]),
              f32_fwd["group_norm"]["library"], ms_is=per_fwd,
              library_ms_is="F.group_norm over the no-SiLU calls only",
              ms_where_library=f32_fwd["group_norm"]["kernel_where_library"],
              ms_bf16=bf16_fwd["group_norm"]["kernel"],
              library_ms_bf16=bf16_fwd["group_norm"]["library"],
              host_us_per_call=host_us["float32"], host_us_per_call_bf16=host_us["bfloat16"],
              launches_serving_dense=results["dense"]["launches"]["group_norm"],
              **paths("group_norm"), **ldm_of("group_norm"), **ldm_train_gn("fwd"),
              **uncond_of("group_norm"), **text_of("group_norm")),
        entry("group_norm_silu_bwd", "cuda", gn_bwd_src, "diff_pruning_tpu/ops/group_norm.py:131",
              ft_counts["group_norm_bwd"], "group_norm_bwd", f32_bwd["gn_kernel"],
              f32_bwd["gn_plain"], f32_bwd["gn_bound"], bound_by(f32_bwd, "gn_"),
              f32_bwd["gn_library"],
              ms_is=per_bwd,
              library_ms_is="autograd of F.group_norm over the no-SiLU calls only",
              ms_where_library=f32_bwd["gn_kernel_where_library"],
              ms_bf16=bf16_bwd["gn_kernel"], bound_ms_bf16=bf16_bwd["gn_bound"],
              library_ms_bf16=bf16_bwd["gn_library"],
              ms_where_library_bf16=bf16_bwd["gn_kernel_where_library"],
              host_us_per_call=bwd_host_us["float32"],
              host_us_per_call_bf16=bwd_host_us["bfloat16"], **paths("group_norm_bwd"),
              max_abs_err_ldm=worst[("group_norm_bwd_ldm", "float32")],
              ms_ldm_sweep_step=lp_ops["gn_kernel"], plain_ms_ldm_sweep_step=lp_ops["gn_plain"],
              bound_ms_ldm_sweep_step=lp_ops["gn_bound"],
              bound_by_ldm_sweep_step=lp_ops["gn_bound_by"],
              library_ms_ldm_sweep_step=lp_ops["gn_library"],
              ms_where_library_ldm_sweep_step=lp_ops["gn_kernel_where_library"],
              **ldm_train_gn("bwd")),
        entry("flash_attention_fwd", "cuda",
              "diff_pruning_tpu_torch/ops/csrc/flash_attention_fwd.cu",
              "diff_pruning_tpu/ops/attention.py:97", ft_counts["attention"], "attention",
              f32_fwd["attention"]["kernel"], f32_fwd["attention"]["plain"],
              f32_fwd["attention"]["bound"], bound_by(f32_fwd["attention"]),
              f32_fwd["attention"]["library"],
              ms_is=per_fwd, library_ms_is="F.scaled_dot_product_attention",
              ms_bf16=bf16_fwd["attention"]["kernel"],
              library_ms_bf16=bf16_fwd["attention"]["library"],
              tflops=f32_fwd["attention"]["tflops"], tflops_bf16=bf16_fwd["attention"]["tflops"],
              max_abs_err_lse=worst[("attention_lse", "float32")],
              launches_with_lse=ft_counts["attention_lse"],
              launches_serving_dense=results["dense"]["launches"]["attention"],
              max_abs_err_lse_ldm=worst[("attention_lse_ldm", "float32")],
              **paths("attention"), **ldm_of("attention"), **uncond_of("attention"),
              **text_of("attention")),
        entry("flash_attention_bwd_dq", "cuda", attn_bwd_src,
              "diff_pruning_tpu/ops/attention.py:205", ft_counts["attention_bwd_dq"],
              "attention_bwd_dq", f32_bwd["dq_kernel"], f32_bwd["dq_plain"],
              f32_bwd["dq_bound"], bound_by(f32_bwd, "dq_"), None, ms_is=per_bwd,
              library_ms_dq_dk_dv=f32_bwd["attn_library"], tflops=f32_bwd["dq_tflops"],
              ms_bf16_in_train_step=train_prof["dense/bfloat16"]["dq_ms"], **bf16_bwd_of("dq"),
              **paths("attention_bwd_dq")),
        entry("flash_attention_bwd_dkv", "cuda", attn_bwd_src,
              "diff_pruning_tpu/ops/attention.py:205", ft_counts["attention_bwd_dkv"],
              "attention_bwd_dkv", f32_bwd["dkv_kernel"], f32_bwd["dkv_plain"],
              f32_bwd["dkv_bound"], bound_by(f32_bwd, "dkv_"), None, ms_is=per_bwd,
              library_ms_dq_dk_dv=f32_bwd["attn_library"], tflops=f32_bwd["dkv_tflops"],
              ms_bf16_in_train_step=train_prof["dense/bfloat16"]["dkv_ms"], **bf16_bwd_of("dkv"),
              **paths("attention_bwd_dkv")),
        ldm_wide_bwd("dq"),
        ldm_wide_bwd("dkv"),
        ldm_wide16("fwd"),
        ldm_wide16("dq"),
        ldm_wide16("dkv"),
    ]
    print(json.dumps({"sweep_step_ms": {"kernels_on": step_on, "kernels_off": step_off},
                      "prune_cli_seconds": cli_seconds, "sampling_imgs_per_s": sampling,
                      "sampling_ddim_steps": SAMPLE_TIME_STEPS,
                      "finetune_cli_seconds": {"float32": ft_seconds, "bfloat16": ft16_seconds},
                      "finetune_imgs_per_sec": {f"{n}/{d}": v for (n, d), v in train_ms.items()},
                      "train_step_peak_gb": {f"{n}/{d}": v for (n, d), v in peak_gb.items()},
                      "optimizer_ema_ms": opt_ms, "train_step_profile": train_prof}))
    print(json.dumps({"evaluation": evaluation}))
    print(json.dumps({"ldm": ldm}))
    print(json.dumps({"ldm_prune": ldm_prune_fig}))
    print(json.dumps({"ldm_train": ldm_train_fig}))
    print(json.dumps({"uncond_ldm": uncond}))
    print(json.dumps({"ablation": ablation}))
    print(json.dumps({"ae_train": ae}))
    print(json.dumps({"text_ldm": text}))
    print(json.dumps({"multi_gpu": multi_gpu}))
    print(json.dumps({"lsun": lsun}))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(sys.argv[2:])
    else:
        main()
