"""CLI: an image folder -> an LSUN-layout lmdb database (counterpart of the JAX
package's ``tools/make_lsun_lmdb.py``), written by the pure-Python
``data/lmdb_io.py``, so that the LSUN-256 pipeline trains from any local
image collection.

    python -m diff_pruning_tpu_torch.cli.make_lsun_lmdb --src <image dir> \\
        --out data/lsun/church_outdoor_train_lmdb [--format WEBP|PNG|JPEG] [--limit N]

Each image is re-encoded (lossless WEBP by default, as LSUN stores its
images) under the md5 hex digest of its path, the way LSUN keys its
entries. ``get_dataset('lsun:<out>')`` then reads the database.
"""

from __future__ import annotations

import argparse
import hashlib
import io


def main(argv=None) -> dict:
    """Returns ``{"entries", "path"}``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--src", required=True, help="image folder (recursive)")
    p.add_argument("--out", required=True, help="output lmdb directory")
    p.add_argument("--format", default="WEBP", choices=["WEBP", "PNG", "JPEG"],
                   help="re-encode format (LSUN uses webp)")
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    from PIL import Image

    from ..data.datasets import list_image_files
    from ..data.lmdb_io import write_lmdb

    files = list_image_files(args.src)
    if args.limit:
        files = files[:args.limit]
    if not files:
        raise SystemExit(f"no images under {args.src}")
    items = []
    for i, f in enumerate(files):
        with Image.open(f) as im:
            buf = io.BytesIO()
            kw = {"lossless": True} if args.format == "WEBP" else {}
            im.convert("RGB").save(buf, format=args.format, **kw)
        items.append((hashlib.md5(f.encode()).hexdigest().encode(), buf.getvalue()))
        if (i + 1) % 500 == 0:
            print(f"  encoded {i + 1}/{len(files)}")
    out = write_lmdb(args.out, items)
    print(f"wrote {len(items)} entries to {out}")
    return {"entries": len(items), "path": out}


if __name__ == "__main__":
    main()
