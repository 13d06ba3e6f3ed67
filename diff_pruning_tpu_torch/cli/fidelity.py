"""CLI: the fidelity metric suite between two image dirs (counterpart of
``diff_pruning_tpu/cli/fidelity.py``; torch_fidelity with isc, fid, kid
and prc all on).

    python -m diff_pruning_tpu_torch.cli.fidelity --input1 GEN --input2 REF \\
        [--weights W] [--device cuda]

All four metrics come from ONE Inception feature pass per input; ISC also
applies the classifier head, so it needs weights that carry one (or
``--no-isc``). ``--device cuda`` without a GPU raises; TF32 is off for
matmuls and convolutions (printed at the start). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input1", type=str, required=True,
                   help="generated images (dir or dataset name)")
    p.add_argument("--input2", type=str, required=True,
                   help="reference images")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--weights", type=str, default=None,
                   help="FID inception .pth or converted .npz (defaults to the "
                        "standard search paths)")
    p.add_argument("--no-isc", dest="isc", action="store_false")
    p.add_argument("--no-kid", dest="kid", action="store_false")
    p.add_argument("--no-prc", dest="prc", action="store_false")
    p.add_argument("--kid_subset_size", type=int, default=1000)
    p.add_argument("--kid_subsets", type=int, default=100)
    p.add_argument("--clean", action="store_true",
                   help="clean-fid preprocessing family")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    args = p.parse_args(argv)
    from .ddpm_sample import pin_f32_precision, resolve_device

    pin_f32_precision()
    device = resolve_device(args.device)
    from ..eval.fid import activation_statistics, features_of_path, frechet_distance
    from ..eval.fidelity import inception_probs, inception_score, kid, precision_recall
    from ..eval.inception import fid_inception, load_fid_inception_state_dict

    state = load_fid_inception_state_dict(args.weights)
    if state is None:
        raise SystemExit("no inception weights found: give --weights (pt_inception .pth "
                         "or a converted .npz)")
    model = fid_inception(state, device)
    mode = "clean" if args.clean else "torch"
    f1 = features_of_path(args.input1, model, batch_size=args.batch_size, resize_mode=mode)
    f2 = features_of_path(args.input2, model, batch_size=args.batch_size, resize_mode=mode)

    out = {}
    mu1, s1 = activation_statistics(f1)
    mu2, s2 = activation_statistics(f2)
    out["frechet_inception_distance"] = frechet_distance(mu1, s1, mu2, s2)
    if args.isc:
        m, s = inception_score(inception_probs(model, f1))
        out["inception_score_mean"], out["inception_score_std"] = m, s
    if args.kid:
        m, s = kid(f1, f2, subset_size=args.kid_subset_size, subsets=args.kid_subsets,
                   device=device)
        out["kernel_inception_distance_mean"] = m
        out["kernel_inception_distance_std"] = s
    if args.prc:
        out.update(precision_recall(f2, f1, device=device))
    print(json.dumps({k: round(float(v), 5) for k, v in out.items()}))
    return out


if __name__ == "__main__":
    main()
