"""CLI: params, MACs, FLOPs, peak memory and a trace of a UNet (counterpart of
``diff_pruning_tpu/cli/profile_model.py``; the reference's compute_flops.py
and profile_ldm.py: ``tp.utils.count_ops_and_params`` and
``torch.cuda.max_memory_allocated``).

    python -m diff_pruning_tpu_torch.cli.profile_model --model_path DIR \\
        [--batch_size 1] [--train_step] [--trace LOGDIR] [--device cuda]

Prints four things about one call of the UNet on zeros at ``--batch_size``
(its forward, or with ``--train_step`` the forward and the backward of the
JAX CLI's loss ``sum((eps - x)^2)``):

1. the params and the MACs per sample of ``pruning/flops.py``
   ``count_ops_and_params`` (conv and linear only: the reference counter's
   figures, worded as the JAX CLI words them);
2. the FLOPs of that call counted by ``torch.utils.flop_counter``'s
   ``FlopCounterMode`` over the plain layers on the ``meta`` device (the
   hand-written kernels are no aten ops and would not be counted). This is
   not XLA's cost analysis, which the JAX CLI prints;
3. the peak device memory of the call on the card
   (``torch.cuda.max_memory_allocated`` over it, the weights included), in
   place of XLA's ``memory_analysis()``; not measured with ``--device cpu``;
4. with ``--trace LOGDIR``, a ``torch.profiler`` trace of one call with the
   kernels on, taken after a warm-up call, written to
   ``LOGDIR/profile_model.json`` (Chrome trace format: chrome://tracing or
   Perfetto).

``--model_path`` is any checkpoint that ``load_unet`` reads: our layout or a
diffusers dir. ``--device cuda`` (the default) without a GPU raises.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--train_step", action="store_true",
                   help="profile fwd+bwd of the training loss instead of fwd")
    p.add_argument("--trace", type=str, default=None, metavar="LOGDIR",
                   help="write a torch.profiler trace of the profiled call into LOGDIR")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{"params", "macs", "flops", "peak_bytes", "trace"}``
    (``peak_bytes`` None on the CPU, ``trace`` the trace file or None)."""
    args = parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    device = resolve_device(args.device)
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .. import ops
    from ..models.unet2d import UNet2D
    from ..pruning.flops import count_ops_and_params
    from .ddpm_prune import load_unet

    cfg, state = load_unet(args.model_path)
    model = UNet2D(cfg, device=device)
    model.load_state_dict(state)
    hw = cfg.sample_size or 32
    shape = (args.batch_size, hw, hw, cfg.in_channels)

    macs, n = count_ops_and_params(model, shape)
    print(f"#Params: {n/1e6:.4f} M")
    print(f"#MACs (conv/linear, reference-counter semantics): {macs/1e9:.4f} G")

    def profiled(m, dev):
        """The profiled call of ``m`` on ``dev``, as a function of no args."""
        x = torch.zeros(shape, device=dev)
        t = torch.zeros((args.batch_size,), dtype=torch.int64, device=dev)
        plist = list(m.parameters())

        def call():
            if args.train_step:
                return torch.autograd.grad(((m(x, t) - x) ** 2).sum(), plist)
            with torch.no_grad():
                return m(x, t)

        return call

    label = "train fwd+bwd" if args.train_step else "forward"
    meta = UNet2D(cfg, device="meta")
    enabled = {op: ops.kernels_enabled(op) for op in ("group_norm", "attention")}
    ops.set_kernels_enabled(False)  # the plain layers: aten ops the counter sees
    try:
        with FlopCounterMode(display=False) as counter:
            profiled(meta, "meta")()
    finally:
        ops.set_kernels_enabled(**enabled)
    flops = counter.get_total_flops()
    print(f"torch FlopCounterMode FLOPs ({label}, batch {args.batch_size}; aten convolution, "
          f"matmul and attention ops on the meta device, not XLA's count): {flops/1e9:.4f} G")

    run = profiled(model, device)
    peak = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        run()
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        print(f"peak device memory ({label}, batch {args.batch_size}, the weights included): "
              f"{peak / 1e6:.1f} MB (torch.cuda.max_memory_allocated)")
    else:
        print("peak device memory: not measured on the CPU")

    trace = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        run()  # the warm-up: the kernels' first launch loads them outside the trace
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        with profile(activities=acts) as prof:
            run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        os.makedirs(args.trace, exist_ok=True)
        trace = os.path.join(args.trace, "profile_model.json")
        prof.export_chrome_trace(trace)
        print(f"wrote profiler trace to {trace} (chrome://tracing or Perfetto)")
    return {"params": n, "macs": macs, "flops": flops, "peak_bytes": peak, "trace": trace}


if __name__ == "__main__":
    main()
