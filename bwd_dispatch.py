#!/usr/bin/env python3
"""Which wide 16-bit attention-backward kernel each call of a bf16 LDM train
step should take, on one NVIDIA GPU: the device time of the wgmma dq and
dk/dv kernels against the 16-row ones at every attention shape of a step.

    python3 bwd_dispatch.py

``flash_attention_bwd.cu`` chooses between its two tilings for 256 < D <=
1024 by shape (launch_dq16, launch_dkv16). This builds two copies of it, all
at once, as ``chip_smoke.py`` builds a ``--compare-bwd`` source (nvcc, the
port's flags): ``wgmma``, where every such call takes the wgmma kernels, and
``16-row``, where every one takes the 16-row kernels. At each dense and
pruned train-step shape (B = 16 rows, one head, Nkv = Nq and 1) it times the
checkout's dq and dk/dv and both copies' as device time: a CUDA graph of 20
calls, replayed (no host time per call), the least of 3 replays, the copies
in turns with the checkout (checkout, copies, checkout). Prints each shape's
ms, the kernel the checkout takes there and the sums over a step's calls.
Exits non-zero without a card; prints nvidia-smi's name and power limit.
"""

import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
ROWS = 16  # the ldm_train CLI's batch
# the conditions of launch_dq16 and launch_dkv16 that send a call to the
# wgmma kernels, and what each copy puts in their place
CONDITIONS = ("if (Nkv >= 256 || B * H * ((Nq + 63) / 64) >= 256) {",
              "if (B * H * ((Nkv + 63) / 64) >= 64) {")
VARIANTS = {"wgmma": "if (true) {", "16-row": "if (false) {"}
# (Nq, Nkv, D): calls a step, dense then pruned (chip_smoke.py phase 18)
SHAPES = [((1024, 1024, 384), 5), ((1024, 1, 384), 5), ((256, 256, 576), 5), ((256, 1, 576), 5),
          ((64, 64, 960), 6), ((64, 1, 960), 6), ((1024, 1024, 268), 5), ((1024, 1, 268), 5),
          ((256, 256, 404), 5), ((256, 1, 404), 5), ((64, 64, 672), 6), ((64, 1, 672), 6)]


def graph_ms(fn, calls=20, reps=3):
    """Device ms a call: a CUDA graph of ``calls`` calls, the least of
    ``reps`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (and set the kernels' attributes) off the graph
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bwd_dispatch: torch.cuda.is_available() is false: this needs an "
                         "NVIDIA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from diff_pruning_tpu_torch.ops import _build
    from diff_pruning_tpu_torch.ops import attention as A

    gpu = cs.gpu_line()
    print(gpu, flush=True)
    src = open(os.path.join(_build._CSRC, "flash_attention_bwd.cu")).read()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, cond in VARIANTS.items():
            text = src
            for old in CONDITIONS:
                assert text.count(old) == 1, (name, old)
                text = text.replace(old, cond)
            paths[name] = os.path.join(tmp, f"flash_attention_bwd_{name.replace('-', '')}.cu")
            with open(paths[name], "w") as f:
                f.write(text)
        with ThreadPoolExecutor(max_workers=len(paths) + 1) as pool:  # one nvcc each
            futs = {name: pool.submit(cs.load_other, "bwd", name.replace("-", ""), path)
                    for name, path in paths.items()}
            A._lib("flash_attention_bwd")
            libs = {name: fut.result() for name, fut in futs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    totals = {}
    for (nq, nkv, d), calls in SHAPES:
        q, do = (torch.randn((ROWS, nq, d), generator=gen, device="cuda").to(bf16)
                 .view(ROWS, nq, 1, d).transpose(1, 2) for _ in range(2))
        k, v = (torch.randn((ROWS, nkv, d), generator=gen, device="cuda").to(bf16)
                .view(ROWS, nkv, 1, d).transpose(1, 2) for _ in range(2))
        scale = d ** -0.5
        o, lse = A.reference_attention_lse(q, k, v, scale)
        _, dsum = A.attention_backward_dq_reference(q, k, v, o, do, lse, scale)
        parts = {"dq": lambda: A.flash_attention_backward_dq(q, k, v, o, do, lse, scale),
                 "dk/dv": lambda: A.flash_attention_backward_dkv(q, k, v, do, lse, dsum, scale)}
        line = []
        for part, fn in parts.items():
            first = graph_ms(fn)
            ms = {name: graph_ms(cs.with_lib("bwd", lib, fn)) for name, lib in libs.items()}
            ms = {"checkout": (first + graph_ms(fn)) / 2, **ms}
            for name, t in ms.items():
                totals[(part, name)] = totals.get((part, name), 0.0) + t * calls
            line.append(f"{part} " + ", ".join(f"{name} {t:.4f}" for name, t in ms.items()))
        taken = cs.wgmma_bwd_taken(ROWS, 1, nq, nkv)
        print(f"bwd dispatch {(nq, nkv, d)} x{calls}/step rows={ROWS} bfloat16, device ms a call: "
              + "; ".join(line) + "; the checkout takes dq by the {}, dk/dv by the {} "
              "kernel".format(*("wgmma" if w else "16-row" for w in taken)) + f" [{gpu}]",
              flush=True)
        del q, k, v, o, do
    print("bwd dispatch per dense + pruned step (device ms): " + ", ".join(
        f"{part} {name} {t:.4f}" for (part, name), t in totals.items()) + f" [{gpu}]")
    print(gpu)


if __name__ == "__main__":
    main()
