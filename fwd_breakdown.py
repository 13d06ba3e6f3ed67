#!/usr/bin/env python3
"""What bounds the wide attention-forward kernels (256 < D <= 1024) on one
NVIDIA GPU: each kernel timed in turns against copies of its own source
with one part taken out.

    python3 fwd_breakdown.py

Builds ``flash_attention_fwd.cu`` four times more, all at once, as
``chip_smoke.py`` builds a ``--compare-fwd`` source (nvcc, the port's
flags), each with one part removed from both wide kernels:
- ``no_s``: the S = Q K^T products (the f32 FMA loop, the 16-bit wgmma);
- ``no_pv``: the O += P V products;
- ``no_s_pv``: both, leaving the K/V copies, the barriers, the softmax and
  the epilogue;
- ``no_kv``: the K and V copies, leaving every product on whatever the
  ring holds.
It times the kernel, the four variants and SDPA (CUDA events, in turns:
forward, then reverse order) at the LDM's largest attention shapes:
(1024, 1024, 384) and (4096, 4096, 512), f32 at the serving path's rows
(32 a CFG UNet call, 16 a decode) and bf16 with lse at the train step's 16.
The variants' outputs are wrong by design; only their times are read.
Exits non-zero without a card; prints nvidia-smi's name and power limit.
"""

import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# each variant: (text of the source, its replacement), every pair present
PARTS = {
    "no_s": [("          for (int j = 0; j < 4; ++j) {\n            s[i][j] = fmaf(qf[i].x",
              "          for (int j = 0; j < 0; ++j) {\n            s[i][j] = fmaf(qf[i].x"),
             ("      Gmma<T>::ss64(sacc, qdesc + step, kdesc + step);", "")],
    "no_pv": [("        for (int j = 0; j < jl; ++j) {", "        for (int j = 0; j < 0; ++j) {"),
              ("        Gmma<T>::rs64(oacc[n], pa[kt],", "        if (0) Gmma<T>::rs64(oacc[n], pa[kt],")],
    "no_kv": [("    if (pt < Nkv) {\n      float* dst = ring", "    if (false) {\n      float* dst = ring"),
              ("    if (t < Nkv)\n      copy_sw128<BK, DO>(ring", "    if (false)\n      copy_sw128<BK, DO>(ring")],
}
PARTS["no_s_pv"] = PARTS["no_s"] + PARTS["no_pv"]
SHAPES = [(32, 1024, 1024, 384, "float32"), (16, 4096, 4096, 512, "float32"),
          (16, 1024, 1024, 384, "bfloat16"), (16, 4096, 4096, 512, "bfloat16")]


def main() -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("fwd_breakdown: torch.cuda.is_available() is false: this needs an "
                         "NVIDIA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from diff_pruning_tpu_torch.ops import _build
    from diff_pruning_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    src = open(os.path.join(_build._CSRC, "flash_attention_fwd.cu")).read()
    A._lib("flash_attention_fwd")
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, edits in PARTS.items():
            text = src
            for old, new in edits:
                assert text.count(old) == 1, (name, old)
                text = text.replace(old, new)
            paths[name] = os.path.join(tmp, f"flash_attention_fwd_{name}.cu")
            with open(paths[name], "w") as f:
                f.write(text)
        with ThreadPoolExecutor(max_workers=len(paths)) as pool:  # one nvcc each, all at once
            futs = {name: pool.submit(cs.load_other, "fwd", name, path)
                    for name, path in paths.items()}
            libs = {name: fut.result() for name, fut in futs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, nq, nkv, d, dname in SHAPES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn((rows, 1, n, d), generator=gen, device="cuda").to(dtype)
                   for n in (nq, nkv, nkv))
        scale = d ** -0.5
        if dtype == torch.float32:  # the serving path's launch, as the CFG sampler makes it
            def run():
                return A.flash_attention(q, k, v, scale)
        else:  # the train step's launch
            def run():
                return A.flash_attention_forward_lse(q, k, v, scale)
        fns = [run] + [cs.with_lib("fwd", lib, run) for lib in libs.values()]
        fns.append(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        ms = cs.in_turns(fns, iters=3 if nq * nkv > 4e6 else 10)
        names = ["kernel", *libs, "SDPA"]
        print(f"fwd breakdown {(nq, nkv, d)} rows={rows} {dname}: "
              + ", ".join(f"{n} {m:.4f} ms" for n, m in zip(names, ms)) + f" [{gpu}]")
        del q, k, v, fns
    print(gpu)


if __name__ == "__main__":
    main()
