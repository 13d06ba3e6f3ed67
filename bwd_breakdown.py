#!/usr/bin/env python3
"""What bounds the wide f32 attention-backward kernels (256 < D <= 1024) on
one NVIDIA GPU: dq and dk/dv timed in turns against copies of their own
source with one part taken out.

    python3 bwd_breakdown.py

Builds ``flash_attention_bwd.cu`` four times more, all at once, as
``chip_smoke.py`` builds a ``--compare-bwd`` source (nvcc, the port's
flags), each with one part removed from both wide f32 kernels
(``flash_bwd_{dq,dkv}_kernel_f32_wide``):
- ``no_scores``: the FMA loops of the partial S and dP products;
- ``no_grads``: the FMA loops of dq += dS K_t, dK += dS^T Q_t and dV +=
  P^T dO_t;
- ``no_exchange``: the cluster's exchange of partial scores a tile (each
  block takes its own partials; no cluster barrier in the loop);
- ``no_copies``: the copies of the streamed tiles (K_t and V_t; Q_t, dO_t
  and their rows), leaving every product on whatever the ring holds.
It times the checkout's dq and dk/dv and the four variants' as device time
(a CUDA graph of 20 calls, the least of 3 replays, as bwd_dispatch.py
takes it) at the LDM sweep step's largest shapes at its 6 rows: (1024,
1024, 384), its class-token call (1024, 1, 384) and (256, 256, 576). The
variants' outputs are wrong by design; only their times are read. Exits
non-zero without a card; prints nvidia-smi's name and power limit.
"""

import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# each variant: (text of the source, its replacement, how many times it occurs)
PARTS = {
    "no_scores": [("  for (int d = 4 * (lane >> 3); d < dk; d += 16) {\n    float4 bf[4];",
                   "  for (int d = 4 * (lane >> 3); d < 0; d += 16) {\n    float4 bf[4];", 1)],
    "no_grads": [("  for (int j = 0; j < n; ++j) {\n    float a[R];",
                  "  for (int j = 0; j < 0; ++j) {\n    float a[R];", 1)],
    "no_exchange": [("  for (int r = 0; r < z; ++r) {\n    float4 a, b;",
                     "  for (int r = int(rank) - rank0; r <= int(rank) - rank0; ++r) {\n"
                     "    float4 a, b;", 1),
                    ("    cluster_arrive();  // this block's partials are written", "", 2),
                    ("    cluster_wait();   // every block's partials of tile t are visible", "", 2)],
    "no_copies": [("    if (t < Nkv) {\n      float* st = ring + (next % NS) * 2 * TILE;",
                   "    if (false) {\n      float* st = ring + (next % NS) * 2 * TILE;", 1),
                  ("    if (t < Nq) {\n      float* st = ring + (next % NS) * kWideDkvStage;",
                   "    if (false) {\n      float* st = ring + (next % NS) * kWideDkvStage;", 1)],
}
ROWS = 6  # the ldm_prune CLI's batch
SHAPES = [(1024, 1024, 384), (1024, 1, 384), (256, 256, 576)]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bwd_breakdown: torch.cuda.is_available() is false: this needs an "
                         "NVIDIA GPU")
    sys.path.insert(0, REPO)
    import bwd_dispatch
    import chip_smoke as cs
    from diff_pruning_tpu_torch.ops import _build
    from diff_pruning_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    src = open(os.path.join(_build._CSRC, "flash_attention_bwd.cu")).read()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, edits in PARTS.items():
            text = src
            for old, new, count in edits:
                assert text.count(old) == count, (name, old)
                text = text.replace(old, new)
            paths[name] = os.path.join(tmp, f"flash_attention_bwd_{name}.cu")
            with open(paths[name], "w") as f:
                f.write(text)
        with ThreadPoolExecutor(max_workers=len(paths) + 1) as pool:  # one nvcc each
            futs = {name: pool.submit(cs.load_other, "bwd", name.replace("_", ""), path)
                    for name, path in paths.items()}
            A._lib("flash_attention_bwd")
            libs = {name: fut.result() for name, fut in futs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for nq, nkv, d in SHAPES:
        q, do = (torch.randn((ROWS, nq, d), generator=gen, device="cuda")
                 .view(ROWS, nq, 1, d).transpose(1, 2) for _ in range(2))
        k, v = (torch.randn((ROWS, nkv, d), generator=gen, device="cuda")
                .view(ROWS, nkv, 1, d).transpose(1, 2) for _ in range(2))
        scale = d ** -0.5
        o, lse = A.reference_attention_lse(q, k, v, scale)
        _, dsum = A.attention_backward_dq_reference(q, k, v, o, do, lse, scale)
        parts = {"dq": lambda: A.flash_attention_backward_dq(q, k, v, o, do, lse, scale),
                 "dk/dv": lambda: A.flash_attention_backward_dkv(q, k, v, do, lse, dsum, scale)}
        for part, fn in parts.items():
            first = bwd_dispatch.graph_ms(fn)
            ms = {name: bwd_dispatch.graph_ms(cs.with_lib("bwd", lib, fn))
                  for name, lib in libs.items()}
            kernel = (first + bwd_dispatch.graph_ms(fn)) / 2
            print(f"bwd breakdown {part} {(nq, nkv, d)} rows={ROWS} float32, device ms a call: "
                  f"kernel {kernel:.4f}, " + ", ".join(f"{name} {t:.4f}" for name, t in ms.items())
                  + f" [{gpu}]", flush=True)
        del q, k, v, o, do
    print(gpu)


if __name__ == "__main__":
    main()
