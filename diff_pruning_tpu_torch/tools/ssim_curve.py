"""SSIM against the number of timesteps in the Taylor accumulation, from
``prune_ssim``'s output (the counterpart of the repository's
``tools/ssim_curve.py``: compute_pruned_ssim_curve.py +
draw_ssim_pruned_curve.py, the paper's consistency-against-stage figure).

    python -m diff_pruning_tpu_torch.tools.ssim_curve <prune_ssim_save_path> [--out curve.png]
        [--device cuda]

Expects <save_path>/stage_base and <save_path>/stage_<N> dirs of same-seed
samples (written by cli/prune_ssim.py). Prints the table, writes it as JSON
beside the figure (``<out>`` with ``.json``) and draws the figure with PIL
(log-scaled stages): matplotlib is not a dependency of the port.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("save_path")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' raises when no GPU is present")
    return ap.parse_args(argv)


def stage_dirs(save_path: str):
    """[(N, <save_path>/stage_<N>)] sorted by N."""
    return sorted((int(m.group(1)), os.path.join(save_path, d))
                  for d in os.listdir(save_path) if (m := re.fullmatch(r"stage_(\d+)", d)))


def draw_curve(xs, ys, path: str, size=(750, 480)) -> None:
    """A marked polyline of ``ys`` over log10 ``xs`` with a light grid and
    labelled axes, as a PNG."""
    from PIL import Image, ImageDraw

    w, h = size
    left, right, top, bottom = 70, 20, 20, 55
    img = Image.new("RGB", size, "white")
    d = ImageDraw.Draw(img)
    lx = [math.log10(x) for x in xs]
    x0, x1 = min(lx), max(lx)
    y0, y1 = min(ys), max(ys)
    if x1 == x0:
        x0, x1 = x0 - 0.5, x1 + 0.5
    if y1 == y0:
        y0, y1 = y0 - 0.05, y1 + 0.05
    pad = 0.05 * (y1 - y0)
    y0, y1 = y0 - pad, y1 + pad

    def px(x, y):
        return (left + (x - x0) / (x1 - x0) * (w - left - right),
                top + (y1 - y) / (y1 - y0) * (h - top - bottom))

    for k in range(math.floor(x0), math.ceil(x1) + 1):  # decades
        if x0 <= k <= x1:
            gx, _ = px(k, y0)
            d.line([(gx, top), (gx, h - bottom)], fill=(225, 225, 225))
            d.text((gx - 10, h - bottom + 6), f"{10 ** k:g}", fill="black")
    for i in range(5):
        yv = y0 + (y1 - y0) * i / 4
        _, gy = px(x0, yv)
        d.line([(left, gy), (w - right, gy)], fill=(225, 225, 225))
        d.text((6, gy - 6), f"{yv:.3f}", fill="black")
    d.rectangle([left, top, w - right, h - bottom], outline="black")
    pts = [px(x, y) for x, y in zip(lx, ys)]
    if len(pts) > 1:
        d.line(pts, fill=(31, 119, 180), width=2)
    for x, y in pts:
        d.ellipse([x - 4, y - 4, x + 4, y + 4], fill=(31, 119, 180))
    d.text((left + 120, h - 22), "timesteps in Taylor accumulation", fill="black")
    d.text((left + 4, 4), "same-seed SSIM vs unpruned", fill="black")
    img.save(path)


def main(argv=None) -> dict:
    """Returns ``{"stages": [N...], "ssim": [...], "mse": [...]}``."""
    args = parse_args(argv)
    from ..cli.ddpm_sample import pin_f32_precision, resolve_device
    from ..eval.ssim import pairwise_ssim_mse

    pin_f32_precision()
    device = resolve_device(args.device)
    base = os.path.join(args.save_path, "stage_base")
    stages = stage_dirs(args.save_path)
    if not stages:
        raise SystemExit(f"no stage_<N> dirs under {args.save_path}")

    table = {"stages": [], "ssim": [], "mse": []}
    for n, d in stages:
        s, m = pairwise_ssim_mse(base, d, device=device)
        table["stages"].append(n)
        table["ssim"].append(s)
        table["mse"].append(m)
        print(f"stage {n:5d}: SSIM {s:.4f}")

    out = args.out or os.path.join(args.save_path, "ssim_curve.png")
    with open(os.path.splitext(out)[0] + ".json", "w") as f:
        json.dump(table, f, indent=1)
    draw_curve(table["stages"], table["ssim"], out)
    print(f"wrote {out}")
    return table


if __name__ == "__main__":
    main()
