#!/usr/bin/env python3
"""Which wide attention-backward route each call should take, on one NVIDIA
GPU: the device time of dq and dk/dv under each of the routes that
``flash_attention_bwd.cu`` chooses between by shape, at every attention
shape of a step.

    python3 bwd_dispatch.py [--dtype bfloat16|float32] [--other LABEL=SRC ...]

``flash_attention_bwd.cu`` chooses its route for 256 < D <= 1024 by shape:
in bf16 (a B = 16 LDM train step) the wgmma kernels or the 16-row ones
(launch_dq16, launch_dkv16); in f32 (a B = 6 LDM sweep step) whether dk/dv
splits its q loop over more blocks of its cluster (launch_dkv_f32_wide).
This builds two copies of the source, all at once, as ``chip_smoke.py`` builds a ``--compare-bwd``
source (nvcc, the port's flags), in which every such call takes one route
and then the other: ``wgmma`` and ``16-row`` in bf16, ``split`` and
``nosplit`` in f32. ``--other LABEL=SRC`` (repeatable) adds another
version of the source (e.g. a parent commit's) timed the same way. At each
dense and pruned shape (one head, Nkv = Nq and 1) it times the checkout's dq
and dk/dv and every copy's as device time: a CUDA graph of 20 calls,
replayed (no host time per call), the least of 3 replays, the copies in
turns with the checkout (checkout, copies, checkout). Prints each shape's
ms, the route the checkout takes there and the sums over a step's calls.
Exits non-zero without a card; prints nvidia-smi's name and power limit.
"""

import argparse
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
# per input type: the rows of a step (the ldm_train CLI's batch in bf16, the
# ldm_prune CLI's in f32), the conditions in flash_attention_bwd.cu that
# choose the route, and what each copy puts in their place
ROUTES = {
    "bfloat16": (16, ("if (Nkv >= 256 || B * H * ((Nq + 63) / 64) >= 256) {",
                      "if (B * H * ((Nkv + 63) / 64) >= 64) {"),
                 {"wgmma": "if (true) {", "16-row": "if (false) {"}),
    "float32": (6, ("if (B * H * kv_tiles * zd < 132) {",),
                {"split": "if (true) {", "nosplit": "if (false) {"}),
}
# (Nq, Nkv, D): calls a step, dense then pruned (chip_smoke.py phases 17, 18)
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


def taken(dname, rows, nq, nkv, d):
    """The route the checkout's entry points take at (rows, 1 head, nq, nkv, d)."""
    import chip_smoke as cs

    if dname == "bfloat16":
        return tuple("wgmma" if w else "16-row" for w in cs.wgmma_bwd_taken(rows, 1, nq, nkv))
    zq = cs.f32_wide_bwd_split(rows, 1, nq, nkv, d)
    return ("32-row blocks", f"split over {zq} q parts" if zq > 1 else "no split")


def cs_label(name: str) -> str:
    """A file-name-safe form of a route's or version's label."""
    return "".join(ch for ch in name if ch.isalnum())


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=sorted(ROUTES), default="bfloat16")
    ap.add_argument("--other", metavar="LABEL=SRC", action="append", default=[],
                    help="another flash_attention_bwd.cu (same C interface), timed in turns")
    args = ap.parse_args()
    others = [a.partition("=")[::2] for a in args.other]
    if not all(label and src for label, src in others):
        ap.error(f"--other takes LABEL=SRC, got {args.other}")
    if not torch.cuda.is_available():
        raise SystemExit("bwd_dispatch: torch.cuda.is_available() is false: this needs an "
                         "NVIDIA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from diff_pruning_tpu_torch.ops import _build
    from diff_pruning_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    rows, conditions, variants = ROUTES[args.dtype]
    src = open(os.path.join(_build._CSRC, "flash_attention_bwd.cu")).read()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, conds in variants.items():
            text = src
            for old in conditions:
                assert text.count(old) == 1, (name, old)
                text = text.replace(old, conds)
            paths[name] = os.path.join(tmp, f"flash_attention_bwd_{cs_label(name)}.cu")
            with open(paths[name], "w") as f:
                f.write(text)
        paths.update({label: os.path.abspath(path) for label, path in others})
        with ThreadPoolExecutor(max_workers=len(paths) + 1) as pool:  # one nvcc each
            futs = {name: pool.submit(cs.load_other, "bwd", cs_label(name), path)
                    for name, path in paths.items()}
            A._lib("flash_attention_bwd")
            libs = {name: fut.result() for name, fut in futs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = getattr(torch, args.dtype)
    totals = {}
    for (nq, nkv, d), calls in SHAPES:
        q, do = (torch.randn((rows, nq, d), generator=gen, device="cuda").to(dtype)
                 .view(rows, nq, 1, d).transpose(1, 2) for _ in range(2))
        k, v = (torch.randn((rows, nkv, d), generator=gen, device="cuda").to(dtype)
                .view(rows, nkv, 1, d).transpose(1, 2) for _ in range(2))
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
        print(f"bwd dispatch {(nq, nkv, d)} x{calls}/step rows={rows} {args.dtype}, device ms a "
              f"call: " + "; ".join(line) + "; the checkout takes dq: {}, dk/dv: {}".format(
                  *taken(args.dtype, rows, nq, nkv, d)) + f" [{gpu}]", flush=True)
        del q, k, v, o, do
    print("bwd dispatch per dense + pruned step (device ms): " + ", ".join(
        f"{part} {name} {t:.4f}" for (part, name), t in totals.items()) + f" [{gpu}]")
    print(gpu)


if __name__ == "__main__":
    main()
